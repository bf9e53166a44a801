"""The port's fixed-shape ``write_samples`` against ``alphatpu.buffer``.

Every one of the N rows is written - a dropped row to a sink slot, with
what that slot holds after the write - so the write is fixed-shape and
never waits for the device (``tests/test_torch_graphs.py`` runs it inside
the selfplay tail under the recording mode).  Seeded numpy rows go
through both packages:

* masks that keep at most ``capacity`` rows a write, over writes that
  wrap the ring: planes, cursor and total equal to the reference's
  exactly;
* more kept rows than the capacity in one write, where the reference's
  scatter has duplicate slots and the port keeps the last ``capacity``
  rows: equal to a plain loop of that rule, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphatpu.buffer import create_buffer as jax_create_buffer
from alphatpu.buffer import write_samples as jax_write_samples
from alphatpu.games import make_game as jax_make_game
from alphatpu_torch.buffer import buffer_size, create_buffer, write_samples
from alphatpu_torch.games import make_game

torch.set_num_threads(1)

FIELDS = ("state", "policy", "player", "value", "fstate")


def _rows(rng, game, N, keep):
    """Seeded rows of ``game``'s widths; ``keep`` is the mask's density."""
    return (rng.integers(0, 2, (N, 2 * game.vectorized_state)),
            rng.random((N, game.max_actions), np.float32),
            rng.choice([-1, 1], N), rng.random(N, np.float32),
            rng.choice([-1, 1], (N, game.feature_size)),
            rng.random(N) < keep)


@pytest.mark.parametrize("name,cap,seed", [
    ("connect4", 64, 0), ("connect4", 37, 1), ("tictactoe", 16, 2),
    ("hex7", 50, 3)])
def test_write_samples_matches_reference_within_capacity(name, cap, seed):
    jgame, game = jax_make_game(name), make_game(name)
    rng = np.random.default_rng(seed)
    jbuf, buf = jax_create_buffer(jgame, cap), create_buffer(game, cap)
    for _ in range(6):
        N = int(rng.integers(1, 2 * cap))
        rows = _rows(rng, game, N, rng.random())
        mask = rows[-1]
        while mask.sum() > cap:  # the reference's domain: no duplicate slot
            mask[np.flatnonzero(mask)[0]] = False
        jbuf = jax_write_samples(jbuf, *(jnp.asarray(x) for x in rows))
        buf = write_samples(buf, *(torch.from_numpy(np.asarray(x))
                                   for x in rows))
    for f in FIELDS + ("cursor", "total"):
        np.testing.assert_array_equal(getattr(buf, f).numpy(),
                                      np.asarray(getattr(jbuf, f)),
                                      err_msg=f)


def _plain_write(planes, cursor, total, rows, mask, cap):
    """The rule in a loop: the kept rows in order, of which the last
    ``cap`` land at ``(cursor + k) % cap``."""
    kept = np.flatnonzero(mask)
    n = len(kept)
    for k, i in enumerate(kept):
        if k >= n - cap:
            for plane, src in zip(planes, rows):
                plane[(cursor + k) % cap] = src[i]
    return (cursor + n) % cap, total + n


@pytest.mark.parametrize("cap,N,cursor,keep", [
    (8, 20, 0, 1.0), (8, 40, 5, 0.6), (5, 30, 4, 0.9), (1, 6, 0, 0.5),
    (16, 17, 15, 1.0), (12, 60, 7, 0.3)])
def test_write_samples_keeps_the_last_capacity_rows(cap, N, cursor, keep):
    game = make_game("connect4")
    rng = np.random.default_rng(cap * 1000 + N)
    buf = create_buffer(game, cap)
    old = _rows(rng, game, cap, 1.0)[:-1]
    for f, x in zip(FIELDS, old):
        getattr(buf, f).copy_(torch.from_numpy(np.asarray(x)))
    buf.cursor[0], buf.total[0] = cursor, 3 * cap
    rows = _rows(rng, game, N, keep)
    planes = [getattr(buf, f).numpy().copy() for f in FIELDS]
    want_cursor, want_total = _plain_write(
        planes, cursor, 3 * cap, [np.asarray(x) for x in rows[:-1]],
        rows[-1], cap)
    write_samples(buf, *(torch.from_numpy(np.asarray(x)) for x in rows))
    for f, want in zip(FIELDS, planes):
        np.testing.assert_array_equal(getattr(buf, f).numpy(), want,
                                      err_msg=f)
    assert (int(buf.cursor[0]), int(buf.total[0])) == (want_cursor,
                                                       want_total)
    assert int(buffer_size(buf)) == cap


def test_write_samples_of_nothing_kept_changes_nothing():
    game = make_game("tictactoe")
    rng = np.random.default_rng(9)
    buf = create_buffer(game, 6)
    write_samples(buf, *(torch.from_numpy(np.asarray(x))
                         for x in _rows(rng, game, 4, 1.0)))
    before = [getattr(buf, f).clone() for f in FIELDS + ("cursor", "total")]
    rows = _rows(rng, game, 9, 0.0)
    write_samples(buf, *(torch.from_numpy(np.asarray(x)) for x in rows))
    for f, b in zip(FIELDS + ("cursor", "total"), before):
        assert torch.equal(getattr(buf, f), b), f
