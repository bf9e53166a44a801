"""The check of ``correct`` on the CPU, at small sizes: sound runs pass;
the control (the program's bfloat16 tower against the float32 reference)
and each fault a selfplay cell can have, planted in the program under the
timed path, fail it."""
import pytest
import torch

import alphatpu_torch.selfplay as program_selfplay
from alphatpu_torch.games.gobang import Gobang
from alphatpu_torch.games.reversi import Reversi
from perfbench import generator

from . import helpers

torch.set_num_threads(1)


@pytest.mark.parametrize("make", [helpers.small_cell, helpers.line4_cell,
                                  lambda: helpers.small_cell(
                                      "gobang13.selfplay")],
                         ids=["reversi8x8", "gobang4", "gobang13"])
def test_a_sound_run_is_correct(make):
    out = helpers.run(make())
    assert out["correct"], out["compared"]
    assert out["failed"] == 0


def test_the_check_sees_episodes_end_and_carried_rows():
    out = helpers.run(helpers.line4_cell())
    assert out["checked"]["episodes_ended"] > 0
    assert out["checked"]["rows_carried_in"] > 0


@pytest.mark.parametrize("make", [helpers.small_cell, helpers.line4_cell],
                         ids=["reversi8x8", "gobang4"])
def test_the_control_fails(make):
    out = helpers.run(make(), tower_dtype="bfloat16")
    assert not out["correct"]
    assert (out["compared"]["policy_gap_p90"]["value"]
            > out["compared"]["policy_gap_p90"]["limit"])


def _unchanged(self, pos, action):
    return pos


def _half_left_out(net, x, compute_dtype=torch.float32):
    logits, value = net(x, compute_dtype)
    half = x.shape[0] // 2
    return (torch.cat([logits[:half], torch.zeros_like(logits[half:])]),
            torch.cat([value[:half], torch.full_like(value[half:], 0.5)]))


def _altered(cdf_sample):
    def sample(pi, prob):
        return (cdf_sample(pi, prob) + 1) % pi.shape[0]
    return sample


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "move_altered", "policy_altered"])
@pytest.mark.parametrize("make", [helpers.small_cell, helpers.line4_cell],
                         ids=["reversi8x8", "gobang4"])
def test_a_fault_fails(fault, make, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(Reversi, "play", _unchanged)
        monkeypatch.setattr(Gobang, "play", _unchanged)
    elif fault == "half_batch_left_out":
        monkeypatch.setattr(generator, "apply_inference", _half_left_out)
    elif fault == "move_altered":
        monkeypatch.setattr(program_selfplay, "cdf_sample",
                            _altered(program_selfplay.cdf_sample))
    else:
        run_mcts = program_selfplay.run_mcts

        def altered(*args, **kwargs):
            tree, pol = run_mcts(*args, **kwargs)
            return tree, torch.roll(pol, 1, 0)
        monkeypatch.setattr(program_selfplay, "run_mcts", altered)
    out = helpers.run(make())
    assert not out["correct"], out["compared"]
