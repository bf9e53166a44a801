"""Rounds that never wait for the device, and the fixed-shape writes that
make them so (``alphatpu_torch.graphs`` captures such rounds on the card).

A ``TorchDispatchMode`` records every op that makes the host wait for the
device or gives a result whose shape depends on the data (``nonzero``,
``_local_scalar_dense`` - ``item``, ``bool`` and ``int`` of a tensor -
``masked_select``, ``equal``, ``unique``, and indexing with a boolean
mask).  None may run in a search at levels 0, 1 and 2 on f32 planes and on
bf16 planes, in a round or the tail of either selfplay mode, in a duel
round, in a ply of ``eval_vs_random`` or ``eval_vs_probe``, in a move of
the interactive engine or in a rollout of each ablation variant.  The
plain versions of the CUDA kernels are left out of the record: they stand
in for the kernels on the CPU, and the graph holds the kernels.

The fixed-shape writes (``tree.write_where`` and its callers) equal the
masked writes they replaced bit for bit, at the edges too: a full tree
(``leaf == V``, ``next_idx >= V``), an episode index past the table
(``eid >= E``) and lanes that allocate nothing.  Captured rounds against
eager ones are the ``cuda`` tests of ``test_torch_port.py``.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from alphatpu_torch import graphs
from alphatpu_torch.benchmarks import ablate_rollout
from alphatpu_torch.buffer import create_buffer
from alphatpu_torch.duel import DuelConfig, DuelRounds, duel_half
from alphatpu_torch.eval import EvalConfig, EvalRounds
from alphatpu_torch.games import make_game
from alphatpu_torch.interactive import MoveRounds
from alphatpu_torch.mcts import kernels as K
from alphatpu_torch.mcts import search as S
from alphatpu_torch.mcts.search import run_mcts
from alphatpu_torch.mcts.tree import (
    init_tree, scatter_states, write_where,
)
from alphatpu_torch.nets import MLP, apply_inference, config_for_game
from alphatpu_torch.probe import ProbeRounds
from alphatpu_torch.selfplay import (
    ContinuousRounds, GenerationRounds, SelfplayConfig, make_carry,
    selfplay_continuous, selfplay_generation,
)

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

aten = torch.ops.aten
WAITING_OPS = {
    aten.nonzero.default, aten._local_scalar_dense.default,
    aten.masked_select.default, aten.equal.default, aten.is_nonzero.default,
    aten._unique2.default, aten.unique_consecutive.default,
    aten.repeat_interleave.Tensor,
}
INDEX_OPS = {aten.index.Tensor, aten.index_put.default,
             aten.index_put_.default, aten._index_put_impl_.default}
PLAIN_KERNELS = ("select_apply_packed_plain", "select_apply_packed1_plain",
                 "select_apply_plain", "select_plain", "backup_plain")


class Waits(TorchDispatchMode):
    """Records the ops that wait for the device or have a data-dependent
    shape; ``paused`` > 0 stops the record (inside a kernel's plain
    version)."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            if func in WAITING_OPS:
                self.seen.append(str(func))
            elif func in INDEX_OPS:
                indices = args[1] if len(args) > 1 else kwargs["indices"]
                if any(i is not None and i.dtype == torch.bool
                       for i in indices):
                    self.seen.append(f"{func} with a boolean index")
        return func(*args, **kwargs)


@pytest.fixture
def waits(monkeypatch):
    """A recording mode, with the kernels' plain versions left out."""
    mode = Waits()

    def exempt(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            mode.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        return run

    for name in PLAIN_KERNELS:
        monkeypatch.setattr(K, name, exempt(getattr(K, name)))
    return mode


def _net(game, seed=0):
    return MLP.from_seed(config_for_game(game, width=32, depth=2), seed)


def test_the_record_sees_a_wait(waits):
    x = torch.arange(6.0)
    with waits:
        x[x > 2] = 0.0
        bool(x.sum())
    assert any("boolean index" in s for s in waits.seen)
    assert "aten._local_scalar_dense.default" in waits.seen


@pytest.mark.parametrize("level,dtype,fresh_root", [
    (1, torch.float32, False), (2, torch.float32, False),
    (0, torch.float32, True), (0, torch.bfloat16, False)])
def test_search_waits_for_nothing(level, dtype, fresh_root, waits):
    game = make_game("connect4")
    tree = init_tree(game, game.initial(8), 16, stat_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    with waits:
        run_mcts(game, _net(game), tree, rollouts=16, cpuct=1.5,
                 training=True, generator=gen, packed_stats=level,
                 final_root_policy=fresh_root)
    assert waits.seen == []
    assert int(tree.next_idx.min()) > 1  # the search grew the trees


@pytest.mark.parametrize("mode,name", [
    ("generation", "tictactoe"), ("continuous", "tictactoe"),
    ("continuous", "connect4"), ("continuous", "hex7"),
    ("continuous", "reversi6x6"), ("continuous", "gobang9")])
def test_selfplay_round_waits_for_nothing(mode, name, waits):
    game = make_game(name)
    cfg = SelfplayConfig(num_games=8, rollouts=16, temp_moves=2)
    # tictactoe's continuous rounds see games end and lanes recycle
    T = 12 if (mode, name) == ("continuous", "tictactoe") else 3
    if mode == "generation":
        st = GenerationRounds(game, cfg, T, "cpu")
        st.start()
    else:
        st = ContinuousRounds(game, cfg, T, "cpu")
        st.start(make_carry(game, 8, None))
    net = _net(game)
    with waits:
        graphs.play(st, T, lambda t: net, torch.Generator().manual_seed(1))
    assert waits.seen == []
    assert int(st.t) == st.T


def test_duel_round_waits_for_nothing(waits):
    game = make_game("tictactoe")
    st = DuelRounds(game, DuelConfig(num_games=8, rollouts=8, temp_moves=2),
                    "cpu")
    st.start()
    nets = (_net(game, 0), _net(game, 1))
    with waits:
        graphs.play(st, 9, lambda t: nets[t % 2],
                    torch.Generator().manual_seed(2))
    assert waits.seen == []
    assert bool(st.done.any())


@pytest.mark.parametrize("mode", ["generation", "continuous"])
def test_selfplay_tail_waits_for_nothing(mode, waits):
    """A call's tail - the back-fill, the buffer write, the next carry and
    the stats - after rounds in which games end (and, continuous, a
    carried-in episode completes): a step of the program like a round."""
    game = make_game("tictactoe")
    cfg = SelfplayConfig(num_games=8, rollouts=8, temp_moves=2)
    net = _net(game)
    if mode == "generation":
        st = GenerationRounds(game, cfg, 9, "cpu")
        st.start()
    else:
        st = ContinuousRounds(game, cfg, 12, "cpu")
        carry = make_carry(game, 8, None)
        carry.count.fill_(2)  # two moves of each lane's episode carried in
        st.start(carry)
    graphs.play(st, st.T, lambda t: net, torch.Generator().manual_seed(1))
    buf = create_buffer(game, 64)
    with waits:
        out = st.tail(buf)
    assert waits.seen == []
    stats = out if mode == "generation" else out[-1]
    assert int(stats["samples_written"]) > 0
    assert int(buf.total[0]) == int(stats["samples_written"])


@pytest.mark.parametrize("net_first", [True, False])
def test_eval_ply_waits_for_nothing(net_first, waits):
    game = make_game("tictactoe")
    st = EvalRounds(game, EvalConfig(num_games=8, rollouts=8), "cpu")
    st.start(game.initial(8), net_first)
    net = _net(game)
    with waits:
        graphs.play(st, 9, lambda t: net, torch.Generator().manual_seed(3))
    assert waits.seen == []
    assert bool(st.done.any())


def test_probe_ply_waits_for_nothing(waits):
    """The net's move (search and picks) and the host's actions applied:
    the two steps between which the probe moves on the host."""
    game = make_game("connect4")
    st = ProbeRounds(game, EvalConfig(num_games=6, rollouts=8), "cpu")
    graphs.assign(st.positions, st.initial)
    net = _net(game)
    st.alive.copy_(torch.tensor([True, True, False, True, True, True]))
    st.actions.copy_(torch.arange(6, dtype=torch.int32))
    with waits, graphs.drawing(st, torch.Generator().manual_seed(4), False):
        st.round(net)
        st.apply()
    assert waits.seen == []
    assert bool((st.picks >= 0).all()) and bool((st.picks < 7).all())
    # a live game played its action, a finished one kept its position
    assert torch.equal(st.host[:, :84].sum(1) > 0,
                       torch.tensor([True, True, False, True, True, True]))


def test_interactive_move_waits_for_nothing(waits):
    """The G=1 engine's move up to its root policy and argmax (the host
    reads the action after the step)."""
    game = make_game("connect4")
    pos = game.play(game.initial(1), torch.tensor([3], dtype=torch.int32))
    st = MoveRounds(game, init_tree(game, pos, 16), 16, 1.5)
    graphs.assign(st.positions, pos)
    st.generator = torch.Generator().manual_seed(5)
    with waits:
        action, pi = st.round(_net(game))
    assert waits.seen == []
    assert pi.shape == (7,) and 0 <= int(action) < 7


@pytest.mark.parametrize("name", list(ablate_rollout.VARIANTS))
def test_ablation_rollout_waits_for_nothing(name, waits):
    game = make_game("connect4")
    tree = init_tree(game, game.initial(8), 8)
    st = ablate_rollout.AblationRounds(game, tree, 8,
                                       ablate_rollout.VARIANTS[name])
    st.generator = torch.Generator().manual_seed(6)
    with waits:
        st.round(_net(game))
    assert waits.seen == []
    assert int(tree.next_idx.min()) > 1 or not ablate_rollout.VARIANTS[
        name].expand


# ---------------------------------------------------------------------------
# the fixed-shape writes against the masked writes they replaced
# ---------------------------------------------------------------------------


def _masked_write(plane, row, mask, value):
    """The masked write: ``plane[row[g], g] = value[g]`` where ``mask``."""
    g = torch.arange(row.shape[0])
    plane[row.long()[mask], g[mask]] = value[mask].to(plane.dtype)


@pytest.mark.parametrize("dtype,tail", [
    (torch.int32, ()), (torch.bool, ()), (torch.float32, (7,)),
    (torch.bfloat16, (5,)), (torch.int8, (3, 2))])
def test_write_where_equals_the_masked_write(dtype, tail):
    rng = np.random.default_rng(3)
    N, G = 6, 40
    base = torch.from_numpy(rng.normal(size=(N, G) + tail)).to(dtype)
    value = torch.from_numpy(rng.normal(size=(G,) + tail) * 7).to(dtype)
    # rows past the table (N, N + 3) are masked out by the caller, as the
    # search masks a full tree and selfplay an episode index past E
    row = torch.from_numpy(rng.integers(0, N + 4, size=G)).to(torch.int32)
    mask = torch.from_numpy(rng.random(G) < 0.6) & (row < N)
    mask[:3] = False  # lanes that write nothing
    want = base.clone()
    _masked_write(want, row, mask, value)
    got = base.clone()
    write_where(got, row, mask, value)
    assert torch.equal(got.view(torch.uint8) if dtype != torch.bool else got,
                       want.view(torch.uint8) if dtype != torch.bool
                       else want)


def test_write_where_through_a_view_of_a_stat_plane():
    """The prior-row writes: a [A, V, G] plane viewed as [V, G, A], with
    ``leaf == V`` on a full tree."""
    rng = np.random.default_rng(4)
    A, V, G = 7, 5, 30
    prior = torch.from_numpy(rng.random((A, V, G))).float()
    leaf = torch.from_numpy(rng.integers(0, V + 1, size=G)).to(torch.int32)
    leaf[:4] = V  # full trees: nothing to write
    write = torch.from_numpy(rng.random(G) < 0.8)
    newp = torch.from_numpy(rng.random((A, G))).float()
    w = write & (leaf < V)
    g = torch.arange(G)
    want = prior.clone()
    want[:, leaf.long()[w], g[w]] = newp[:, w]
    got = prior.clone()
    write_where(got.permute(1, 2, 0), leaf, w, newp.T)
    assert torch.equal(got, want)


def _parent_expand_writes(tree, node, leaf_action, needs_alloc, leaf_states,
                          done):
    """The masked writes of ``expand`` before they were fixed-shape."""
    V, G = tree.num_nodes, tree.num_games
    g = torch.arange(G)
    new = tree.next_idx.clone()
    alloc = needs_alloc & (new < V)
    tree.parent[new.long()[alloc], g[alloc]] = node[alloc]
    tree.action_from[new.long()[alloc], g[alloc]] = leaf_action[alloc]
    sel = needs_alloc & (new < V)
    for leaf_plane, val in zip(tree.states, leaf_states):
        torch.movedim(leaf_plane, -1, 1)[new.long()[sel], g[sel]] = val[sel]
    tree.next_idx += needs_alloc.to(torch.int32)
    leaf = torch.where(needs_alloc, new, node)
    inside = leaf < V
    tree.expanded[leaf.long()[inside], g[inside]] = ~done[inside]
    return leaf, inside


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_equals_the_masked_writes(seed):
    """A grown tree, some of whose games are full (``next_idx == V``),
    and lanes that allocate nothing: ``expand`` writes what the masked
    version wrote, bit for bit, and the same prior rows."""
    game = make_game("connect4")
    G, V = 24, 6
    tree = init_tree(game, game.initial(G), V)
    run_mcts(game, _net(game), tree, rollouts=V - 1, cpuct=1.5,
             training=True, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    tree.next_idx[:G // 3] = V  # full trees
    node = torch.from_numpy(rng.integers(0, V, size=G)).to(torch.int32)
    leaf_action = torch.from_numpy(rng.integers(0, 7, size=G)).to(
        torch.int32)
    needs_alloc = torch.from_numpy(rng.random(G) < 0.7)
    leaf_states = game.play(S.gather_states(tree.states, node), leaf_action)
    prior = torch.softmax(torch.from_numpy(rng.normal(size=(7, G))).float(),
                          0)
    fields = ("parent", "action_from", "expanded", "prior", "next_idx")

    def copy(t):
        c = init_tree(game, game.initial(G), V)
        for f in fields:
            getattr(c, f).copy_(getattr(t, f))
        for a, b in zip(c.states, t.states):
            a.copy_(b)
        return c

    want, got = copy(tree), copy(tree)
    leaf, done, _, newp = S.expand(game, got, node, leaf_action, needs_alloc,
                                   leaf_states, prior, True)
    leaf_w, inside = _parent_expand_writes(want, node, leaf_action,
                                           needs_alloc, leaf_states, done)
    g = torch.arange(G)
    want.prior[:, leaf.long()[inside], g[inside]] = newp[:, inside]
    assert torch.equal(leaf, leaf_w)
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got.states, want.states):
        assert torch.equal(a, b)


def test_scatter_states_equals_the_masked_write():
    game = make_game("reversi6x6")
    G, V = 16, 5
    tree = init_tree(game, game.initial(G), V)
    rng = np.random.default_rng(5)
    node = torch.from_numpy(rng.integers(0, V + 2, size=G)).to(torch.int32)
    mask = torch.from_numpy(rng.random(G) < 0.6)
    new = game.play(game.initial(G), torch.full((G,), 8, dtype=torch.int32))
    want = [x.clone() for x in tree.states]
    sel = mask & (node < V)
    g = torch.arange(G)
    for plane, val in zip(want, new):
        torch.movedim(plane, -1, 1)[node.long()[sel], g[sel]] = val[sel]
    scatter_states(tree.states, node, new, mask)
    for a, b in zip(tree.states, want):
        assert torch.equal(a, b)


def test_episode_records_past_the_table_write_nothing():
    """``selfplay_continuous``'s episode tables: a lane whose episode
    index reached ``E`` records nothing, as the masked write did."""
    E, G, F = 3, 10, 4
    rng = np.random.default_rng(6)
    eid = torch.from_numpy(rng.integers(0, E + 2, size=G)).to(torch.int32)
    f = torch.from_numpy(rng.random(G) < 0.7)
    r = torch.from_numpy(rng.integers(-1, 2, size=G)).to(torch.int8)
    feat = torch.from_numpy(rng.integers(-1, 2, size=(G, F))).to(torch.int8)
    res, ftab = torch.zeros((E, G), dtype=torch.int8), torch.ones(
        (E, G, F), dtype=torch.int8)
    want_res, want_ftab = res.clone(), ftab.clone()
    fe = f & (eid < E)
    _masked_write(want_res, eid, fe, r)
    _masked_write(want_ftab, eid, fe, feat)
    write_where(res, eid, fe, r)
    write_where(ftab, eid, fe, feat)
    assert torch.equal(res, want_res) and torch.equal(ftab, want_ftab)
    assert bool((eid >= E).any())


# ---------------------------------------------------------------------------
# the static state and the capture module
# ---------------------------------------------------------------------------


def test_static_rounds_restart_as_fresh_ones():
    """A program's state serves call after call (the cached graphs replay
    on it): after ``start`` from the second call's carry it gives what a
    fresh state gives, bit for bit."""
    game = make_game("tictactoe")
    cfg = SelfplayConfig(num_games=6, rollouts=8, temp_moves=3,
                         continuous=True, rounds=7)
    net = _net(game)
    carry = make_carry(game, 6, torch.Generator().manual_seed(3))
    _, _, carry = selfplay_continuous(game, net, create_buffer(game, 64),
                                      None, cfg, carry)
    reused = ContinuousRounds(game, cfg, 7, "cpu")
    reused.start(make_carry(game, 6, None))
    graphs.play(reused, 7, lambda t: net, torch.Generator().manual_seed(9))
    fresh = ContinuousRounds(game, cfg, 7, "cpu")
    outs = []
    for st in (reused, fresh):
        st.start(carry)
        gen = torch.Generator().manual_seed(4)
        graphs.play(st, 7, lambda t: net, gen)
        outs.append([st.t, st.eid, st.ep_start, st.res_table, st.ftable,
                     st.tally, st.enc_s, st.pol_s, st.player_s, st.eid_s,
                     *st.positions, *(getattr(st.tree, f) for f in (
                         "parent", "prior", "wsum", "visits"))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_capture_on_the_cpu_raises():
    game = make_game("tictactoe")
    net = _net(game)
    buf = create_buffer(game, 64)
    cfg = SelfplayConfig(num_games=4, rollouts=8, rounds=2)
    with pytest.raises(ValueError, match="CUDA"):
        selfplay_continuous(game, net, buf, None, cfg, captured=True)
    with pytest.raises(ValueError, match="CUDA"):
        selfplay_generation(game, net, buf, None, cfg, captured=True)
    with pytest.raises(ValueError, match="CUDA"):
        duel_half(game, net, net, None, DuelConfig(num_games=4, rollouts=8),
                  "cpu", captured=True)
    assert graphs.use_graphs(None, "cpu") is False
    assert graphs.use_graphs(False, "cpu") is False


def test_net_identity_follows_the_module():
    game = make_game("tictactoe")
    a, b = _net(game, 0), _net(game, 1)
    same = graphs.net_identity(functools.partial(apply_inference, a))
    assert same == graphs.net_identity(functools.partial(apply_inference, a))
    assert same != graphs.net_identity(functools.partial(apply_inference, b))
    bf16 = functools.partial(apply_inference, compute_dtype=torch.bfloat16)
    assert graphs.net_identity(functools.partial(bf16, a)) != same
    assert graphs.net_identity(a) != same


def test_the_cache_keeps_the_last_programs(monkeypatch):
    monkeypatch.setattr(graphs, "_cache", type(graphs._cache)())
    made = []

    def make():
        made.append(graphs.Rounds("cpu"))
        return made[-1]

    nets = (object(), object())
    first = graphs.rounds_for(("k", 0), nets, make)
    assert graphs.rounds_for(("k", 0), nets[::-1], make) is first
    for i in range(1, graphs.CACHE_SIZE + 1):
        graphs.rounds_for(("k", i), nets, make)
    assert len(graphs._cache) == graphs.CACHE_SIZE
    assert first not in graphs._cache.values()  # the least recently used
    assert graphs.rounds_for(("k", 0), nets, make) is not first
    assert first.nets == nets


def test_launch_counts_move_as_a_replay_owes():
    K.reset_launch_counts()
    before = K.launch_counts()
    K.select_apply.launches += 3
    K.select_apply.launches_bf16 += 3
    K.backup.launches += 1
    after = K.launch_counts()
    K.set_launch_counts(before)
    assert K.launch_counts() == before
    delta = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
             for k in after}
    K.add_launches(delta)
    K.add_launches(delta)
    assert (K.select_apply.launches, K.select_apply.launches_bf16,
            K.backup.launches) == (6, 6, 2)
    K.reset_launch_counts()
