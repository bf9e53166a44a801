"""The multi-rank dry run: one production generation over n ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``
(__graft_entry__.py:48-78), with its tiny tictactoe configuration and its
four checks: ``run_generation`` exactly as the CLI runs it with
``--devices n`` - sharded continuous selfplay (each rank its lanes and its
buffer shard), the data-parallel learner (gradients averaged over the
ranks), the sharded gating duel, Elo and promotion.

    python -c "from alphatpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, device='cpu')"
"""
from __future__ import annotations

import math

from .mesh import World, run_ranks


def _generation(world: World) -> dict:
    from ..duel import DuelConfig
    from ..games import make_game
    from ..pipeline import PipelineConfig, init_pipeline, run_generation
    from ..selfplay import SelfplayConfig
    from ..train import TrainConfig

    n = world.size
    game = make_game("tictactoe")
    cfg = PipelineConfig(
        # continuous (lane-recycling) selfplay is the production mode;
        # tictactoe episodes last 5-9 plies, so 12 rounds finish >= 1/lane
        selfplay=SelfplayConfig(num_games=2 * n, rollouts=8,
                                continuous=True, rounds=12),
        train=TrainConfig(batch_size=8 * n),
        duel=DuelConfig(num_games=2 * n, rollouts=8),
        buffer_capacity=128 * n,
        generations=1,
        width=32,
        depth=2,
        devices=n,
        device=str(world.device),
        log=lambda s: None,
    )
    state = init_pipeline(game, cfg)
    _, stats = run_generation(game, state, cfg)
    return stats


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float | None = None) -> dict:
    """One generation over ``n_devices`` ranks: one NCCL rank per card
    (``device="cuda"``, where that many are visible), or gloo processes on
    the CPU (``device="cpu"``).  Raises if a check fails or the ranks
    outlast ``timeout`` seconds; returns the generation's stats."""
    stats = run_ranks(_generation, n_devices, device=device,
                      timeout=timeout)[0]
    if stats["illegal_moves"] != 0:
        raise AssertionError(f"illegal moves: {stats['illegal_moves']}")
    if stats["games_finished"] < 2 * n_devices:
        raise AssertionError(f"{stats['games_finished']} games finished, "
                             f"expected >= {2 * n_devices}")
    if not math.isfinite(stats["loss"]):
        raise AssertionError(f"loss {stats['loss']}")
    w, d, l = stats["duel"]
    if w + d + l + stats["duel_unfinished"] != 2 * n_devices:
        raise AssertionError(f"duel tally {stats['duel']} + "
                             f"{stats['duel_unfinished']} unfinished != "
                             f"{2 * n_devices} games")
    return stats
