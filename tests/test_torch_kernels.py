"""The port's MCTS kernels against the reference's Pallas kernels.

``alphatpu.mcts.pallas_kernels`` runs its kernels (``select_apply_packed``,
``select_apply_packed1``, ``select_apply_pallas``, ``select_pallas``,
``backup_pallas``) in the Pallas interpreter on the CPU; the port's
wrappers run their plain torch versions (the tensors lie on the CPU).
Both get the same trees, pending updates and uniforms, made from numpy
seeds, at connect4 (A = 7) and hex5 (A = 25, the wide-board path of the
Pallas kernels).

The three-plane kernels (``select_apply_pallas``, ``select_pallas``,
``backup_pallas``) also run on bf16 planes (``ALPHATPU_BF16_STATS``): the
same grown tree rounded to bf16 goes to both packages.

Tolerances: the stat planes after the apply phase are exactly equal
(integer adds, copies, and one f32 add per edge - rounded once to bf16 on
bf16 planes, in both packages).  Paths, leaves and
needs_alloc are exactly equal except on a lane whose CDF sample lands on a
prefix-sum tie: the Pallas kernel sums prefixes in Hillis-Steele order and
the port in action order, so such a lane may pick another action
(pallas_kernels.py:38-42); at most 1 lane in 128 may do so, and the test
prints it.  The root policy matches to rtol 1e-5 (the two sum the Newton
terms in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.games import make_game as jax_make_game
from alphatpu.mcts import pallas_kernels as PK
from alphatpu.mcts.newton import cdf_sample as jax_cdf_sample
from alphatpu.mcts.newton import regularized_policy as jax_regularized_policy
from alphatpu.mcts.search import backup as jax_backup
from alphatpu.mcts.search import descend, run_mcts
from alphatpu.mcts.tree import init_tree
from alphatpu.nets import apply_inference, config_for_game, init_params
from alphatpu.selfplay import broadcast_initial
from alphatpu_torch.mcts import kernels as K
from alphatpu_torch.mcts.newton import cdf_sample, regularized_policy
from alphatpu_torch.mcts.search import Path as PortPath
from alphatpu_torch.mcts.search import backup as port_backup
from alphatpu_torch.mcts.search import descend as port_descend
from alphatpu_torch.mcts.search import select as port_select
from alphatpu_torch.mcts.tree import Tree

# the tests run tiny tensors, where torch's CPU thread pool costs more
# than it saves
torch.set_num_threads(1)

CPUCT = 1.5


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _grown_tree(game_name, G, V, monkeypatch, seed=0):
    """A mid-search tree grown by the reference's packed twin (wsum on the
    1/value_scale grid), with free slots left so needs_alloc still fires."""
    game = jax_make_game(game_name)
    params = init_params(jax.random.key(seed),
                         config_for_game(game, width=32, depth=2))
    tree = init_tree(game, broadcast_initial(game, G), V)
    monkeypatch.setenv("ALPHATPU_NO_KERNELS", "1")
    tree, _ = run_mcts(game, apply_inference, params, tree,
                       jax.random.key(seed + 1), rollouts=V - 2, cpuct=CPUCT,
                       training=True, packed_stats=True)
    monkeypatch.delenv("ALPHATPU_NO_KERNELS")
    return game, jax.device_get(tree)


def _diverged_lanes(a, b):
    """Lanes where any path output of two selections differs."""
    bad = np.zeros(a[0].shape[-1], bool)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        bad |= (x != y).reshape(-1, x.shape[-1]).any(0)
    return np.flatnonzero(bad)


def _real_pending(rng, tree, walk, A, V, G, scale=None):
    """A pending update made of a walk's outputs (numpy: nodes, actions,
    leaf, needs_alloc), with a random leaf value (on the 1/scale grid when
    ``scale`` is given) and a random prior row; some lanes do not write,
    and some claim leaf == V (a full tree), which must write nothing."""
    nodes, actions, node, alloc = walk
    leaf = np.where(alloc, tree.next_idx, node).astype(np.int32)
    leaf[:4] = V
    write = rng.random(G) < 0.9
    newp = rng.random((A, G), dtype=np.float32)
    newp /= newp.sum(0, keepdims=True)
    value = rng.random(G, dtype=np.float32)
    if scale is not None:
        value = np.asarray(PK.quantize_value(jnp.asarray(value), scale))
    return (nodes, actions, (nodes >= 0).sum(0).astype(np.int32), value,
            leaf, newp, write)


def _empty_pending(D, A, G):
    return tuple(np.asarray(x) for x in K.empty_pending(D, A, G))


def _assert_walks_match(game_name, G, jwalk, sel):
    """The reference's walk outputs (nodes, actions, leaf, leaf_action,
    needs_alloc, root_pi) against the port's Selection, outside the
    CDF-tie lanes."""
    ref = tuple(np.asarray(x) for x in jwalk[:5])
    got = tuple(x.numpy() for x in (sel.nodes, sel.actions, sel.leaf,
                                     sel.leaf_action, sel.needs_alloc))
    bad = _diverged_lanes(ref, got)
    if len(bad):
        print(f"{game_name}: CDF-tie lanes diverged: {bad.tolist()}")
    assert len(bad) <= G // 128, bad
    ok = np.setdiff1d(np.arange(G), bad)
    for x, y in zip(ref, got):
        np.testing.assert_array_equal(x[..., ok], y[..., ok])
    np.testing.assert_allclose(sel.root_pi.numpy(), np.asarray(jwalk[5]),
                               rtol=1e-5, atol=1e-6)


def _run_both(tree, probs, pend, scale):
    """One select_apply_packed call in each engine on copies of the same
    inputs; returns (jax outputs, port Selection, port prior, port packed)."""
    packed = np.asarray(PK.pack_stats(jnp.asarray(tree.wsum),
                                      jnp.asarray(tree.visits), scale))
    j = PK.select_apply_packed(
        jnp.asarray(tree.prior), jnp.asarray(packed), jnp.asarray(tree.parent),
        jnp.asarray(tree.action_from), jnp.asarray(tree.expanded),
        jnp.asarray(probs), *(jnp.asarray(x) for x in pend), CPUCT,
        scale=scale, interpret=True)
    prior_t = _t(tree.prior)
    packed_t = _t(packed)
    sel = K.select_apply_packed(
        prior_t, packed_t, _t(tree.parent), _t(tree.action_from),
        _t(tree.expanded), _t(probs), K.PendingUpdate(*(_t(x) for x in pend)),
        CPUCT, scale)
    return jax.device_get(j), sel, prior_t, packed_t


@pytest.mark.parametrize("game_name,G,V", [
    ("connect4", 128, 16),
    ("hex5", 128, 16),  # A = 25: the wide-board path of the Pallas kernel
])
def test_select_apply_packed_matches_pallas(game_name, G, V, monkeypatch):
    game, tree = _grown_tree(game_name, G, V, monkeypatch)
    A = game.max_actions
    D = min(game.max_game_length, V)
    scale = PK.value_scale(V)
    rng = np.random.default_rng(11)
    before = K.select_apply_packed.launches

    # call 1: the empty pending update of a first rollout
    probs = rng.random((D, G), dtype=np.float32)
    j, sel, _, _ = _run_both(tree, probs, _empty_pending(D, A, G), scale)

    # call 2: a real pending update made of call 1's walk
    pend = _real_pending(rng, tree, (j[2], j[3], j[4], j[6]), A, V, G, scale)
    probs2 = rng.random((D, G), dtype=np.float32)
    j2, sel2, prior_t, packed_t = _run_both(tree, probs2, pend, scale)

    # the plain versions ran: no kernel was launched on the CPU
    assert K.select_apply_packed.launches == before
    # the apply phase is lane-independent of the walk: planes exactly equal
    np.testing.assert_array_equal(prior_t.numpy(), np.asarray(j2[0]))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(j2[1]))
    for jj, ss in ((j, sel), (j2, sel2)):
        _assert_walks_match(game_name, G, jj[2:], ss)
    # the walk reached past the root on most lanes
    assert (sel2.nodes.numpy()[1] >= 0).mean() > 0.5


@pytest.mark.parametrize("game_name,G,V", [
    ("connect4", 128, 16),
    ("hex5", 128, 16),
])
def test_select_apply_packed1_matches_pallas(game_name, G, V, monkeypatch):
    """The 1-plane word: the pending row overwrites whole words with the
    quantized prior, the backup adds land at the layout's wsum offset."""
    game, tree = _grown_tree(game_name, G, V, monkeypatch, seed=1)
    A = game.max_actions
    D = min(game.max_game_length, V)
    layout = PK.packed1_layout(V)
    # the grown tree's prior and wsum rounded onto the 1-plane grids
    packed = np.asarray(PK.pack1_stats(
        jnp.asarray(tree.prior), jnp.asarray(tree.wsum),
        jnp.asarray(tree.visits), layout))
    rng = np.random.default_rng(12)
    before = K.select_apply_packed1.launches

    def run_both(probs, pend):
        j = jax.device_get(PK.select_apply_packed1(
            jnp.asarray(packed), jnp.asarray(tree.parent),
            jnp.asarray(tree.action_from), jnp.asarray(tree.expanded),
            jnp.asarray(probs), *(jnp.asarray(x) for x in pend), CPUCT,
            layout=layout, interpret=True))
        packed_t = _t(packed)
        sel = K.select_apply_packed1(
            packed_t, _t(tree.parent), _t(tree.action_from),
            _t(tree.expanded), _t(probs),
            K.PendingUpdate(*(_t(x) for x in pend)), CPUCT,
            K.packed1_layout(V))
        return j, sel, packed_t

    j, sel, _ = run_both(rng.random((D, G), dtype=np.float32),
                         _empty_pending(D, A, G))
    pend = _real_pending(rng, tree, (j[1], j[2], j[3], j[5]), A, V, G,
                         layout[2])
    # a few rows put all mass on one action: the u11 field clamps 1.0 to
    # 2047/2048 and sets bit 31 of the word
    newp = pend[5].copy()
    newp[:, 4:12] = np.eye(A, dtype=np.float32)[:, :1]
    pend = pend[:5] + (newp,) + pend[6:]
    j2, sel2, packed_t = run_both(rng.random((D, G), dtype=np.float32), pend)

    assert K.select_apply_packed1.launches == before
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(j2[0]))
    assert (packed_t.numpy() < 0).any()  # bit 31 was exercised
    for jj, ss in ((j, sel), (j2, sel2)):
        _assert_walks_match(game_name, G, jj[1:], ss)
    assert (sel2.nodes.numpy()[1] >= 0).mean() > 0.5


# (game, G, V, stat dtype): the f32 cases keep their ids, bf16 adds one
_STAT_CASES = [
    pytest.param(game, 128, 16, dtype,
                 id=f"{game}-128-16" + ("-bf16" if dtype == "bfloat16"
                                        else ""))
    for dtype in ("float32", "bfloat16") for game in ("connect4", "hex5")]


def _stat_t(x, dtype):
    """A (numpy, JAX or bf16) stat plane as a new torch tensor of
    ``dtype``: bf16 round-trips exactly through f32."""
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _stat_j(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _f32(x):
    """A stat plane of either package and dtype as f32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _f32_planes(tree, dtype="float32"):
    return tuple(_stat_t(x, dtype) for x in (tree.prior, tree.wsum,
                                             tree.visits))


@pytest.mark.parametrize("game_name,G,V,dtype", _STAT_CASES)
def test_select_apply_matches_pallas(game_name, G, V, dtype, monkeypatch):
    """Three f32 planes, unquantized values: one f32 add per edge, so the
    planes are exactly equal, and with an empty pending update the read-only
    select returns the same walk bit for bit.  On bf16 planes every add and
    every prior-row entry is rounded once to bf16, in both packages: the
    planes are still equal bit for bit."""
    game, tree = _grown_tree(game_name, G, V, monkeypatch, seed=2)
    A = game.max_actions
    D = min(game.max_game_length, V)
    rng = np.random.default_rng(13)
    before = K.select_apply.launches

    def run_both(probs, pend):
        j = jax.device_get(PK.select_apply_pallas(
            _stat_j(tree.prior, dtype), _stat_j(tree.wsum, dtype),
            _stat_j(tree.visits, dtype), jnp.asarray(tree.parent),
            jnp.asarray(tree.action_from), jnp.asarray(tree.expanded),
            jnp.asarray(probs), *(jnp.asarray(x) for x in pend), CPUCT,
            interpret=True))
        planes = _f32_planes(tree, dtype)
        sel = K.select_apply(
            *planes, _t(tree.parent), _t(tree.action_from),
            _t(tree.expanded), _t(probs),
            K.PendingUpdate(*(_t(x) for x in pend)), CPUCT)
        return j, sel, planes

    probs = rng.random((D, G), dtype=np.float32)
    j, sel, _ = run_both(probs, _empty_pending(D, A, G))
    pend = _real_pending(rng, tree, (j[3], j[4], j[5], j[7]), A, V, G)
    j2, sel2, planes = run_both(rng.random((D, G), dtype=np.float32), pend)

    assert K.select_apply.launches == before
    for got, ref in zip(planes, j2[:3]):
        assert got.dtype == getattr(torch, dtype)
        assert np.asarray(ref).dtype == jnp.dtype(dtype)
        np.testing.assert_array_equal(_f32(got), _f32(ref))
    if dtype == "float32":
        # the unquantized values left wsum off every coarse grid
        assert ((planes[1].numpy() * 512) % 1.0 != 0).any()
    else:
        # rounding happened: the f32 planes after the same apply differ
        f32_planes = _f32_planes(tree)
        K.select_apply(*f32_planes, _t(tree.parent), _t(tree.action_from),
                       _t(tree.expanded), _t(probs),
                       K.PendingUpdate(*(_t(x) for x in pend)), CPUCT)
        for got, ref in zip(planes[:2], f32_planes[:2]):
            assert not torch.equal(got.float(), ref)
    for jj, ss in ((j, sel), (j2, sel2)):
        _assert_walks_match(game_name, G, jj[3:], ss)
    walk = K.select(*_f32_planes(tree, dtype), _t(tree.parent),
                    _t(tree.action_from), _t(tree.expanded), _t(probs), CPUCT)
    for x, y in zip(walk, sel):
        assert torch.equal(x, y)


@pytest.mark.parametrize("game_name,G,V,dtype", _STAT_CASES)
def test_select_matches_pallas(game_name, G, V, dtype, monkeypatch):
    """The read-only walk, on a grown tree and on the same tree after one
    backup of a walk's path, through the per-phase API (search.select) and
    the kernel wrapper; on f32 planes and on the tree rounded to bf16."""
    game, tree = _grown_tree(game_name, G, V, monkeypatch, seed=4)
    D = min(game.max_game_length, V)
    rng = np.random.default_rng(14)
    before = K.select.launches
    prior, wsum, visits = _f32_planes(tree, dtype)
    ptree = Tree(parent=_t(tree.parent), action_from=_t(tree.action_from),
                 expanded=_t(tree.expanded), states=None,
                 prior=prior, wsum=wsum, visits=visits,
                 next_idx=_t(tree.next_idx))
    for _ in range(2):
        probs = rng.random((D, G), dtype=np.float32)
        j = jax.device_get(PK.select_pallas(
            _stat_j(tree.prior, dtype), _stat_j(tree.wsum, dtype),
            _stat_j(tree.visits, dtype), jnp.asarray(tree.parent),
            jnp.asarray(tree.action_from), jnp.asarray(tree.expanded),
            jnp.asarray(probs), CPUCT, interpret=True))
        path, node, laction, alloc, root_pi = port_select(
            None, ptree, _t(probs), CPUCT)
        assert torch.equal(path.length, (path.nodes >= 0).sum(0,
                                                            dtype=torch.int32))
        _assert_walks_match(game_name, G, j, K.Selection(
            path.nodes, path.actions, node, laction, alloc, root_pi))
        # descend is the plain version: the same walk on the CPU
        for x, y in zip(port_descend(None, ptree, _t(probs), CPUCT),
                        (path, node, laction, alloc, root_pi)):
            for xx, yy in zip(x if isinstance(x, tuple) else (x,),
                              y if isinstance(y, tuple) else (y,)):
                assert torch.equal(xx, yy)
        # next: the tree after backing up this walk's path
        value = rng.random(G, dtype=np.float32)
        w, v = jax.device_get(PK.backup_pallas(
            _stat_j(tree.wsum, dtype), _stat_j(tree.visits, dtype), j[0],
            j[1], (j[0] >= 0).sum(0).astype(np.int32), jnp.asarray(value),
            interpret=True))
        tree = tree._replace(wsum=_f32(w), visits=_f32(v))
        ptree.wsum, ptree.visits = (_stat_t(tree.wsum, dtype),
                                    _stat_t(tree.visits, dtype))
    assert K.select.launches == before


@pytest.mark.parametrize("game_name,G,V,dtype", _STAT_CASES)
def test_backup_matches_pallas(game_name, G, V, dtype, monkeypatch):
    """One backup of a walk's path; on bf16 planes each add is rounded
    once to bf16 in both packages, and the planes are equal bit for bit."""
    game, tree = _grown_tree(game_name, G, V, monkeypatch, seed=3)
    D = min(game.max_game_length, V)
    rng = np.random.default_rng(5)
    probs = rng.random((D, G), dtype=np.float32)
    path, *_ = jax.device_get(descend(game, tree, jnp.asarray(probs), CPUCT))
    value = rng.random(G, dtype=np.float32)

    jw, jv = jax.device_get(PK.backup_pallas(
        _stat_j(tree.wsum, dtype), _stat_j(tree.visits, dtype), path.nodes,
        path.actions, path.length, jnp.asarray(value), interpret=True))
    wsum, visits = _stat_t(tree.wsum, dtype), _stat_t(tree.visits, dtype)
    before = K.backup.launches
    K.backup(wsum, visits, _t(path.nodes), _t(path.actions),
             _t(path.length), _t(value))
    assert K.backup.launches == before
    assert wsum.dtype == visits.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_f32(visits), _f32(jv))
    if dtype == "float32":
        np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
    else:
        np.testing.assert_array_equal(_f32(wsum), _f32(jw))
    assert (_f32(visits) != _f32(_stat_t(tree.visits, dtype))).sum() > G


@pytest.mark.parametrize("value_scale", [None, 128])
def test_search_backup_matches_reference(value_scale, monkeypatch):
    """search.backup (leaf value from the net or the terminal result,
    optionally on the 1/value_scale grid, then the backup kernel's plain
    version) against the reference's search.backup."""
    game, tree = _grown_tree("connect4", 128, 16, monkeypatch, seed=6)
    G = 128
    D = min(game.max_game_length, 16)
    rng = np.random.default_rng(9)
    path, *_ = jax.device_get(descend(game, tree, jnp.asarray(
        rng.random((D, G), dtype=np.float32)), CPUCT))
    player = rng.choice(np.array([-1, 1], np.int8), G)
    value = rng.random(G, dtype=np.float32)
    done = rng.random(G) < 0.3
    result = rng.choice(np.array([-1, 0, 1], np.int8), G)
    jt = jax.device_get(jax_backup(
        tree._replace(wsum=jnp.asarray(tree.wsum),
                      visits=jnp.asarray(tree.visits)),
        type(path)(*(jnp.asarray(x) for x in path)), jnp.asarray(player),
        jnp.asarray(value),
        jnp.asarray(done), jnp.asarray(result), value_scale=value_scale))
    ptree = Tree(parent=None, action_from=None, expanded=None, states=None,
                 prior=None, wsum=_t(tree.wsum), visits=_t(tree.visits),
                 next_idx=None)
    out = port_backup(ptree, PortPath(*(_t(x) for x in path)), _t(player),
                      _t(value), _t(done), _t(result), value_scale)
    assert out is ptree
    np.testing.assert_array_equal(ptree.visits.numpy(), np.asarray(jt.visits))
    np.testing.assert_array_equal(ptree.wsum.numpy(), np.asarray(jt.wsum))
    added = ptree.wsum.numpy().astype(np.float64) - tree.wsum
    assert (added != 0).sum() > G
    if value_scale:  # every add lies on the grid
        np.testing.assert_array_equal((added * value_scale) % 1.0, 0.0)


def test_pack_helpers_match_reference():
    """pack/unpack/quantize against the reference, exactly - including
    wsum halves with bit 31 set (a root edge that took every rollout)."""
    rng = np.random.default_rng(0)
    for R in (1, 16, 64, 100, 1000):
        assert K.value_scale(R) == PK.value_scale(R)
    R = 64
    S = K.value_scale(R)
    visits = rng.integers(0, R + 1, size=(7, 64, 256)).astype(np.float32)
    wfix = (rng.random(visits.shape) * (visits * S + 1)).astype(np.int64)
    wfix = np.minimum(wfix, (visits * S).astype(np.int64))
    wfix[0, 0, :8] = R * S  # the top value: bit 31 of the word
    visits[0, 0, :8] = R
    wsum = (wfix / S).astype(np.float32)
    ref = np.asarray(PK.pack_stats(jnp.asarray(wsum), jnp.asarray(visits), S))
    got = K.pack_stats(_t(wsum), _t(visits), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref < 0).any()  # bit 31 was exercised
    np.testing.assert_array_equal(K.unpack_wsum(got, S).numpy(), wsum)
    np.testing.assert_array_equal(K.unpack_visits(got).numpy(), visits)
    np.testing.assert_array_equal(
        K.unpack_wsum(got, S).numpy(), np.asarray(PK.unpack_wsum(ref, S)))
    # quantize: random values plus exact half-grid ties (half to even)
    v = np.concatenate([rng.random(4096, dtype=np.float32),
                        ((np.arange(64) + 0.5) / S).astype(np.float32)])
    np.testing.assert_array_equal(
        K.quantize_value(_t(v), S).numpy(),
        np.asarray(PK.quantize_value(jnp.asarray(v), S)))


@pytest.mark.parametrize("R", [16, 64, 4096])
def test_packed1_helpers_match_reference(R):
    """The 1-plane layout, pack, unpack and prior quantization against the
    reference, exactly - including words with bit 31 set (a prior of at
    least 1024/2048, and 1.0, which clamps to 2047/2048)."""
    rng = np.random.default_rng(R)
    layout = K.packed1_layout(R)
    assert tuple(layout) == PK.packed1_layout(R)
    bits_v, bits_w, s = layout
    shape = (7, 32, 64)
    visits = rng.integers(0, min(R, (1 << bits_v) - 1) + 1,
                          shape).astype(np.float32)
    wfix = rng.integers(0, 1 << bits_w, shape)
    wsum = (wfix / s).astype(np.float32)
    prior = rng.random(shape, dtype=np.float32)
    prior[0, 0, :8] = 1.0
    prior[1, 0, :8] = (np.arange(8) + 1023.5) / 2048  # half-grid ties
    ref = np.asarray(PK.pack1_stats(jnp.asarray(prior), jnp.asarray(wsum),
                                    jnp.asarray(visits), PK.packed1_layout(R)))
    got = K.pack1_stats(_t(prior), _t(wsum), _t(visits), layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref < 0).any()  # bit 31 was exercised
    for mine, theirs in ((K.unpack1_prior, PK.unpack1_prior),
                         (K.unpack1_wsum, PK.unpack1_wsum),
                         (K.unpack1_visits, PK.unpack1_visits)):
        np.testing.assert_array_equal(
            mine(got, layout).numpy(),
            np.asarray(theirs(jnp.asarray(ref), PK.packed1_layout(R))))
    np.testing.assert_array_equal(K.unpack1_wsum(got, layout).numpy(), wsum)
    np.testing.assert_array_equal(K.unpack1_visits(got, layout).numpy(),
                                  visits)
    np.testing.assert_array_equal(
        K.quantize_prior(_t(prior)).numpy(),
        np.asarray(PK.quantize_prior(jnp.asarray(prior))))
    np.testing.assert_array_equal(K.unpack1_prior(got, layout).numpy(),
                                  K.quantize_prior(_t(prior)).numpy())


def _policy_rows(rng, A, G):
    """Realistic node rows: normalized priors over random legal masks,
    integer visits and values on the 1/512 grid."""
    legal = rng.random((A, G)) < 0.8
    legal[0] = True
    prior = np.where(legal, rng.random((A, G)), 0.0)
    prior = (prior / prior.sum(0)).astype(np.float32)
    visits = np.where(legal, rng.integers(0, 9, (A, G)), 0).astype(np.float32)
    wsum = np.floor(rng.random((A, G)) * visits * 512) / 512
    q = np.where(visits > 0, wsum / np.maximum(visits, 1), 0.0)
    return prior, q.astype(np.float32), visits


@pytest.mark.parametrize("A", [7, 25, 169])
def test_newton_and_cdf_match_reference(A):
    rng = np.random.default_rng(A)
    G = 512
    prior, q, visits = _policy_rows(rng, A, G)
    ref = np.asarray(jax_regularized_policy(
        jnp.asarray(prior), jnp.asarray(q), jnp.asarray(visits), CPUCT))
    got = regularized_policy(_t(prior), _t(q), _t(visits), CPUCT).numpy()
    # the engines sum the Newton terms in different orders, so a lane whose
    # error lands next to the stopping test may take one step more in one
    # of them: at most 1 lane in 128, and both stopped inside the tolerance
    off = np.flatnonzero(
        (np.abs(got - ref) > 1e-7 + 1e-5 * np.abs(ref)).any(0))
    assert len(off) <= G // 128, off
    assert (np.abs(got[:, off].sum(0) - 1.0) < 1e-3).all()
    assert (np.abs(ref[:, off].sum(0) - 1.0) < 1e-3).all()
    ok = np.setdiff1d(np.arange(G), off)
    np.testing.assert_allclose(got[:, ok], ref[:, ok], rtol=1e-5, atol=1e-7)

    prob = rng.random(G, dtype=np.float32) * ref.sum(0)
    a_ref = np.asarray(jax_cdf_sample(jnp.asarray(ref), jnp.asarray(prob)))
    a_got = cdf_sample(_t(ref), _t(prob)).numpy()
    ties = np.flatnonzero(a_ref != a_got)
    # only a prefix-sum tie may pick another action, and it picks a
    # neighbour of the reference's
    assert len(ties) <= 1, ties
    assert (np.abs(a_ref[ties] - a_got[ties]) <= 1).all()
    # the fallback: no prefix reaches the uniform -> last positive action
    over = cdf_sample(_t(ref), _t(np.full(G, 2.0, np.float32))).numpy()
    np.testing.assert_array_equal(
        over, np.asarray(jax_cdf_sample(jnp.asarray(ref),
                                        jnp.full((G,), 2.0))))
    zero = cdf_sample(torch.zeros((A, 4)), torch.full((4,), 0.5)).numpy()
    np.testing.assert_array_equal(zero, 0)


def test_plain_kernel_policy_matches_newton():
    """The walk's per-node policy (the kernels' arithmetic) equals the
    search-level regularized policy on visited rows and returns the raw
    prior on fresh ones."""
    rng = np.random.default_rng(2)
    prior, q, visits = _policy_rows(rng, 7, 256)
    visits[:, :32] = 0.0
    q[:, :32] = 0.0
    got = K.node_policy_rows(_t(prior), _t(q), _t(visits), CPUCT).numpy()
    ref = regularized_policy(_t(prior), _t(q), _t(visits), CPUCT).numpy()
    np.testing.assert_array_equal(got[:, 32:], ref[:, 32:])
    np.testing.assert_array_equal(got[:, :32], prior[:, :32])


@pytest.mark.parametrize("G", [1, 64, 200, 2048, 8192])
def test_launch_geometry_covers_every_shape(G):
    """For every A the kernels take, at the path's tree sizes: the
    cooperative walk's lanes hold the whole row in one of the instantiated
    (lanes, slots) pairs with no empty slot, its blocks cover the G games
    and give every SM a block unless they are down to one warp, and the
    games' columns fit the block's shared memory; backup's blocks cover
    G."""
    instantiated = {(k, 1) for k in (1, 2, 4, 8, 16, 32)} | {
        (32, s) for s in range(2, 7)}
    for V in (8, 16, 64):
        for A in range(1, K.MAX_ACTIONS + 1):
            lanes, slots, threads, blocks, smem, placement = K.walk_geometry(
                A, G, V)
            assert placement == K.SHARED_COLUMNS
            assert (lanes, slots) in instantiated, (A, lanes, slots)
            assert lanes * (slots - 1) < A <= lanes * slots
            assert lanes >= min(A, 32)
            assert threads in (32, 64, 128) and threads <= 1024
            games = threads // lanes
            assert (blocks - 1) * games < G <= blocks * games
            assert blocks >= K.NUM_SMS or threads == 32
            assert smem == games * K.column_words(V, lanes) * 4 <= 48 * 1024
            assert K.column_words(V, lanes) >= 2 * V
    # a big tree: the blocks shrink to keep the columns in shared memory
    lanes, _, threads, _, smem, _ = K.walk_geometry(7, G, 1600)
    assert threads == 32 and smem == 4 * K.column_words(1600, 8) * 4
    threads, blocks = K.backup_geometry(G)
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert (blocks - 1) * threads < G <= blocks * threads
    with pytest.raises(ValueError, match="A=170"):
        K.walk_geometry(K.MAX_ACTIONS + 1, G, 64)
    with pytest.raises(ValueError, match="A=0"):
        K.walk_geometry(0, G, 64)
    # past a block's shared memory the columns stay in device memory
    geo = K.walk_geometry(1, G, 4096)
    assert geo.placement == K.DEVICE_COLUMNS and geo.smem == 0


@pytest.mark.parametrize("V", [8, 64, 1600, 4096, 8000, 20000])
@pytest.mark.parametrize("G", [1, 200, 2048, 8192])
def test_walk_geometry_places_the_columns_of_any_tree(G, V):
    """The geometry of every walk kernel never raises for 1 <= A <= 169:
    the columns go to shared memory exactly when one warp's games fit a
    block's, with smem their bytes; otherwise the lookup reads device
    memory and the block asks for no shared memory.  Lanes, slots and
    blocks follow the same rules either way."""
    instantiated = {(k, 1) for k in (1, 2, 4, 8, 16, 32)} | {
        (32, s) for s in range(2, 7)}
    for A in range(1, K.MAX_ACTIONS + 1):
        geo = K.walk_geometry(A, G, V)
        assert (geo.lanes, geo.slots) in instantiated, (A, geo)
        assert geo.lanes * (geo.slots - 1) < A <= geo.lanes * geo.slots
        assert geo.threads in (32, 64, 128)
        games = geo.threads // geo.lanes
        assert (geo.blocks - 1) * games < G <= geo.blocks * games
        assert geo.blocks >= K.NUM_SMS or geo.threads == 32
        words = K.column_words(V, geo.lanes)
        fits = 32 // geo.lanes * words * 4 <= 232448
        assert geo.placement == (K.SHARED_COLUMNS if fits
                                 else K.DEVICE_COLUMNS), (A, geo)
        assert geo.smem == (games * words * 4 if fits else 0)
        if fits:  # above 48 KB only in a one-warp block
            assert geo.smem <= 48 * 1024 or geo.threads == 32
        else:  # the games' columns: more than a block can hold
            assert 32 // geo.lanes * words * 4 > 232448


# (A, V, placement): connect4's last shared tree and first device trees,
# hex13's / gobang13's on either side of its threshold
_PLACEMENTS = ((7, 7248, K.SHARED_COLUMNS), (7, 7249, K.DEVICE_COLUMNS),
               (7, 8191, K.DEVICE_COLUMNS), (169, 29040, K.SHARED_COLUMNS),
               (169, 29041, K.DEVICE_COLUMNS))


@pytest.mark.parametrize("kernel", ["select_apply_packed",
                                    "select_apply_packed1", "select_apply",
                                    "select"])
def test_wrappers_launch_with_the_placement_the_tree_needs(kernel,
                                                           monkeypatch):
    """The geometry each walk wrapper passes to its kernel (captured in
    place of the launch, on meta tensors): the device placement for
    connect4 from V = 7,249 and A=169 from V = 29,041, and below that the
    shared placement - at connect4's V = 7,248 the one-warp launch with
    232,064 B of shared memory, as before the device placement existed."""
    meta = torch.device("meta")
    G, D = 8192, 42
    t = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=meta)
    i32 = torch.int32
    launched = []
    monkeypatch.setattr(K, "_on_cuda", lambda name, x: True)
    monkeypatch.setattr(K, "_launch",
                        lambda entry, dev, *a: launched.append(a[-6:]))
    monkeypatch.setattr(getattr(K, kernel), "launches", 0)
    for A, V, placement in _PLACEMENTS:
        walk = (t(V, G, dt=i32), t(V, G, dt=i32), t(V, G, dt=torch.bool),
                t(D, G))
        pend = K.PendingUpdate(t(D, G, dt=i32), t(D, G, dt=i32), t(G, dt=i32),
                               t(G), t(G, dt=i32), t(A, G),
                               t(G, dt=torch.bool))
        f32 = (t(A, V, G), t(A, V, G), t(A, V, G))
        calls = {
            "select_apply_packed": lambda: K.select_apply_packed(
                t(A, V, G), t(A, V, G, dt=i32), *walk, pend, CPUCT, 8),
            "select_apply_packed1": lambda: K.select_apply_packed1(
                t(A, V, G, dt=i32), *walk, pend, CPUCT,
                K.packed1_layout(64)),
            "select_apply": lambda: K.select_apply(*f32, *walk, pend, CPUCT),
            "select": lambda: K.select(*f32, *walk, CPUCT),
        }
        calls[kernel]()
        geo = K.WalkGeometry(*launched[-1])
        assert geo == K.walk_geometry(A, G, V)
        assert geo.placement == placement, (A, V, geo)
        if placement == K.DEVICE_COLUMNS:
            assert geo.smem == 0
    assert K.WalkGeometry(*launched[0]) == (8, 1, 32, 2048, 232064,
                                            K.SHARED_COLUMNS)
    assert getattr(K, kernel).launches == len(_PLACEMENTS)


def _hand_tree():
    """Two games, A=3, V=4, D=3.  Game 0: the root (node 0) has one legal
    action, 1, whose child is node 1; node 1 has one legal action, 0,
    without a child: the walk records (0, 1), (1, 0) and asks for a new
    node.  Game 1: the root is not expanded: nothing is recorded."""
    A, V, G = 3, 4, 2
    prior = torch.zeros((A, V, G))
    prior[1, 0, 0] = 1.0
    prior[0, 1, 0] = 1.0
    prior[:, 0, 1] = 1.0 / 3
    parent = torch.full((V, G), -1, dtype=torch.int32)
    action_from = torch.zeros((V, G), dtype=torch.int32)
    parent[1, 0], action_from[1, 0] = 0, 1
    expanded = torch.zeros((V, G), dtype=torch.bool)
    expanded[:2, 0] = True
    # the previous rollout's path: the same two edges of game 0, with a
    # prior row written at game 0's node 2; game 1 claims leaf V (full)
    pend = K.PendingUpdate(
        nodes=torch.tensor([[0, -1], [1, -1], [-1, -1]], dtype=torch.int32),
        actions=torch.tensor([[1, 0], [0, 0], [0, 0]], dtype=torch.int32),
        length=torch.tensor([2, 0], dtype=torch.int32),
        value=torch.tensor([0.5, 0.0]),
        leaf=torch.tensor([2, V], dtype=torch.int32),
        newp=torch.full((A, G), 1.0 / 3),
        write=torch.tensor([True, True]))
    return prior, parent, action_from, expanded, pend


# kernel -> (walk bytes without the apply phase, apply-phase bytes)
# walk, per the bounds module's rules:
#   parent + action_from of the one game that looks up a child: 4 x 8 = 32
#   expanded flags: game 0 reads 2, game 1 reads 1 (its root) = 3
#   rows: game 0 two, game 1 its root: 3 rows x A=3 x the row's bytes
#   uniforms of the 2 recorded depths: 8
#   out: path D x G x 8 = 48, leaf/leaf action/alloc G x 9 = 18, root
#   policy A x G x 4 = 24
# apply: flags and leaves G x 5 = 10; one writing lane (game 1's leaf is V):
#   A x (4 read + 4 written) = 24; the pending path D x G x 4 = 24; length
#   and value of the one game with edges = 8; 2 edges x (4 for the action
#   + the stat words read and written)
_HAND_BYTES = {
    "select_apply_packed": (32 + 3 + 3 * 3 * 8 + 8 + 48 + 18 + 24,
                            10 + 24 + 24 + 8 + 2 * (4 + 8)),
    "select_apply_packed1": (32 + 3 + 3 * 3 * 4 + 8 + 48 + 18 + 24,
                             10 + 24 + 24 + 8 + 2 * (4 + 8)),
    "select_apply": (32 + 3 + 3 * 3 * 12 + 8 + 48 + 18 + 24,
                     10 + 24 + 24 + 8 + 2 * (4 + 16)),
    "select": (32 + 3 + 3 * 3 * 12 + 8 + 48 + 18 + 24, None),
    # the whole path D x G x 4 = 24, one game's length and value = 8,
    # 2 edges x (4 for the action + 16 for two f32 read-modify-writes)
    "backup": (24 + 8 + 2 * (4 + 16), None),
    # bf16 planes: 2 B an element - rows of 3 x 2 B, the prior row's
    # elements written 2 B each, two 2 B read-modify-writes per edge
    "select_apply_bf16": (32 + 3 + 3 * 3 * 6 + 8 + 48 + 18 + 24,
                          10 + 3 * (4 + 2) + 24 + 8 + 2 * (4 + 8)),
    "select_bf16": (32 + 3 + 3 * 3 * 6 + 8 + 48 + 18 + 24, None),
    "backup_bf16": (24 + 8 + 2 * (4 + 8), None),
}


@pytest.mark.parametrize("kernel", sorted(_HAND_BYTES))
def test_bound_counts_the_bytes_of_a_hand_built_tree(kernel):
    """The bound of each kernel on a tree whose walk is known, against the
    byte count written out above; the operations' lower bound (9 per
    action of each row, 3 per edge) leaves every kernel bound by bytes.
    ``<name>_bf16``: the kernel on bf16 planes, counted at 2 B an
    element."""
    from alphatpu_torch.mcts import bounds as B

    prior, parent, action_from, expanded, pend = _hand_tree()
    itemsize = 4
    if kernel.endswith("_bf16"):
        kernel, itemsize = kernel.removesuffix("_bf16"), 2
        prior = prior.to(torch.bfloat16)
    A, V, G = prior.shape
    D = pend.nodes.shape[0]
    zeros = torch.zeros_like(prior)
    walk = (parent, action_from, expanded, torch.full((D, G), 0.5))
    layout = K.packed1_layout(V)
    calls = {
        "select_apply_packed": lambda: K.select_apply_packed(
            prior.clone(), K.pack_stats(zeros, zeros, 64), *walk, pend,
            CPUCT, 64),
        "select_apply_packed1": lambda: K.select_apply_packed1(
            K.pack1_stats(prior, zeros, zeros, layout), *walk, pend, CPUCT,
            layout),
        "select_apply": lambda: K.select_apply(
            prior.clone(), zeros.clone(), zeros.clone(), *walk, pend, CPUCT),
        "select": lambda: K.select(prior, zeros, zeros, *walk, CPUCT),
    }
    walk_bytes, apply_bytes = _HAND_BYTES[kernel + (
        "_bf16" if itemsize == 2 else "")]
    if kernel == "backup":
        cost = B.backup_cost(pend.nodes, itemsize)
        assert cost == (walk_bytes, 2 * 3)
    else:
        sel = calls[kernel]()
        assert sel.nodes.tolist() == [[0, -1], [1, -1], [-1, -1]]
        assert sel.needs_alloc.tolist() == [True, False]
        assert B.walk_cost(kernel, V, sel, itemsize=itemsize) == (
            walk_bytes, 3 * A * 9)
        if apply_bytes is not None:
            assert B.walk_cost(kernel, V, sel, pend, itemsize) == (
                walk_bytes + apply_bytes, 3 * A * 9 + 2 * 3)
        else:
            with pytest.raises(ValueError, match="no apply phase"):
                B.walk_cost(kernel, V, sel, pend, itemsize)
        cost = B.walk_cost(kernel, V, sel, itemsize=itemsize)
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(cost.nbytes / 3.35e12 * 1e3)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel or raises."""
    meta = torch.device("meta")
    A, V, G, D = 7, 8, 4, 8
    t = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=meta)
    pend = K.PendingUpdate(t(D, G, dt=torch.int32), t(D, G, dt=torch.int32),
                           t(G, dt=torch.int32), t(G), t(G, dt=torch.int32),
                           t(A, G), t(G, dt=torch.bool))
    with pytest.raises(ValueError, match="no kernel"):
        K.select_apply_packed(t(A, V, G), t(A, V, G, dt=torch.int32),
                              t(V, G, dt=torch.int32), t(V, G, dt=torch.int32),
                              t(V, G, dt=torch.bool), t(D, G), pend, CPUCT, 512)
    with pytest.raises(ValueError, match="no kernel"):
        K.backup(t(A, V, G), t(A, V, G), t(D, G, dt=torch.int32),
                 t(D, G, dt=torch.int32), t(G, dt=torch.int32), t(G))
