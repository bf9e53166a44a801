"""How ``correct`` is decided: the program's last call of the window
against the plain reference (:mod:`perfbench.reference`).

The check reads what the call produced - the buffer rows it wrote, the
carry it returned - for a sample of lanes drawn from the seed (the lanes
of the longest episode carried in and carried out among them), and takes
each lane's record of every round of the call: the position searched
(its encoding and player), and the root policy found.  A round's record
lies in the buffer where its episode ended within the call, in the
returned carry where it still runs; the check finds it from the counts of
moves carried in and out, as ``write_samples`` lays rows down.

The reference follows the program step by step, from the program's own
state at each stage: it searches each recorded position itself, with the
uniforms the program drew (regenerated from the stream's state before the
call) and with the weights the benchmark made; it chooses each move from
the program's recorded policy and the round's uniform; it plays the
program's move by the plain rules.  It compares

* ``policy_gap_p90`` - the 90th percentile over the searches of the
  largest gap between the program's root policy and the reference's,
* ``moves_apart`` - rounds whose move is not the one the recorded policy
  and the round's uniform give (sampled below ``temp_moves`` at the
  uniform times the policy's mass, the first of the largest after): the
  next record is not that move played, or an episode that ended has rows
  whose value and final feature are not that move's end of it,
* ``rules_apart`` - rounds where the program's own move, read from the
  next record, was illegal, or played into another position than the
  plain rules give, or continued a game the rules end,
* ``rows_apart`` - carried rows not written as they were carried, rows
  written that the counts do not account for, illegal moves and rows
  dropped that the call reports.

The first swings by rounding: the net's float32 products sum in another
order here, and a value that lands on the other side of the packed
stats' 1/512 grid moves a later walk, so a few searches in a hundred may
part.  The other three are exact: the move's sums run in action order in
float32 on both sides.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .reference import games as ref_games
from .reference import search as ref_search

NUMBERS = ("policy_gap_p90", "moves_apart", "rules_apart", "rows_apart")


class Records(NamedTuple):
    """The sampled lanes' records of the call, on the host."""

    lanes: np.ndarray  # [S] lane indices
    count_in: np.ndarray  # [S] moves carried in
    count_out: np.ndarray  # [S] moves carried out
    enc: np.ndarray  # int8[S, T, 2C] the position searched each round
    pol: np.ndarray  # float32[S, T, A] the root policy
    player: np.ndarray  # int8[S, T]
    value: np.ndarray  # float32[S, T] (rows in the buffer)
    fstate: np.ndarray  # int8[S, T, C]
    out_enc: np.ndarray  # [S, 2C] the position carried out
    out_player: np.ndarray  # [S]
    carried_value: np.ndarray  # float32[S, L] rows carried in, as written
    carried_fstate: np.ndarray  # int8[S, L, C]
    carried_player: np.ndarray  # int8[S, L]
    rows_apart: int


def pick_lanes(count_in, count_out, n: int, rng) -> np.ndarray:
    """``n`` distinct lanes: those of the longest episode carried in and
    carried out, the rest drawn from ``rng``."""
    G = count_in.shape[0]
    first = list(dict.fromkeys([int(count_in.argmax()),
                                int(count_out.argmax())]))
    rest = np.setdiff1d(np.arange(G), first)
    drawn = rng.choice(rest, size=min(n, G) - len(first), replace=False)
    return np.array(first + sorted(drawn.tolist()), np.int64)


def gather(run, call, n_lanes: int, rng) -> Records:
    """The records of ``call`` (a :class:`perfbench.generator.Call` of
    ``run``) for ``n_lanes`` lanes, copied to the host."""
    buf = run.buffer
    T, G = run.T, run.G
    L = call.carry_in.enc.shape[1]
    cin = call.carry_in.count.cpu().numpy().astype(np.int64)
    cout = call.carry_out.count.cpu().numpy().astype(np.int64)
    # the rows the call wrote, in write order: the carried episodes that
    # ended, lane by lane, then the rounds' rows of ended episodes
    ended = cout < T
    carried = (np.arange(L)[None, :] < cin[:, None]) & ended[:, None]
    completed = np.arange(T)[:, None] < (T - cout)[None, :]
    mask = np.concatenate([carried.reshape(-1), completed.reshape(-1)])
    slot = (int(call.cursor[0]) + np.cumsum(mask) - 1) % buf.capacity
    stats = {k: int(v) for k, v in call.stats.items()
             if k in ("samples_written", "illegal_moves", "unfinished")}
    apart = (abs(int(mask.sum()) - stats["samples_written"])
             + stats["illegal_moves"] + stats["unfinished"])

    lanes = pick_lanes(cin, cout, n_lanes, rng)
    S = lanes.size
    t = np.arange(T)[None, :]
    in_buf = completed[:, lanes].T  # [S, T]
    rows = np.where(in_buf, slot[G * L + t * G + lanes[:, None]], 0)
    l_out = np.where(in_buf, 0, t - T + cout[lanes][:, None])

    def take(plane, idx):
        return plane[torch.as_tensor(idx.reshape(-1), device=plane.device)
                     ].cpu().numpy().reshape(idx.shape + plane.shape[1:])

    def carried_rows(carry, idx):  # [S, L, ...] of the sampled lanes
        g = torch.as_tensor(idx, device=carry.enc.device)
        return (carry.enc[g].cpu().numpy(), carry.pol[g].cpu().numpy(),
                carry.player[g].cpu().numpy())

    b_enc, b_pol, b_player = (take(buf.state, rows), take(buf.policy, rows),
                              take(buf.player, rows))
    o_enc, o_pol, o_player = carried_rows(call.carry_out, lanes)
    s = np.arange(S)[:, None]
    pick = in_buf[..., None]
    enc = np.where(pick, b_enc, o_enc[s, l_out])
    pol = np.where(pick, b_pol, o_pol[s, l_out])
    player = np.where(in_buf, b_player, o_player[s, l_out])

    # rows carried in: written as they were carried where their episode
    # ended, else carried out again in front of this call's
    i_enc, i_pol, i_player = carried_rows(call.carry_in, lanes)
    crow = np.where(carried[lanes], slot[lanes[:, None] * L
                                         + np.arange(L)[None, :]], 0)
    c_enc = np.where(ended[lanes][:, None, None], take(buf.state, crow),
                     o_enc)
    c_pol = np.where(ended[lanes][:, None, None], take(buf.policy, crow),
                     o_pol)
    c_player = np.where(ended[lanes][:, None], take(buf.player, crow),
                        o_player)
    valid = np.arange(L)[None, :] < cin[lanes][:, None]
    differ = ((c_enc != i_enc).any(-1) | (c_pol != i_pol).any(-1)
              | (c_player != i_player))
    apart += int((differ & valid).sum())

    out_enc = run.game.encode(call.carry_out.positions)
    g = torch.as_tensor(lanes, device=out_enc.device)
    return Records(
        lanes=lanes, count_in=cin[lanes], count_out=cout[lanes],
        enc=enc, pol=pol, player=player,
        value=take(buf.value, rows), fstate=take(buf.fstate, rows),
        out_enc=out_enc[g].cpu().numpy(),
        out_player=call.carry_out.positions.player[g].cpu().numpy(),
        carried_value=take(buf.value, crow),
        carried_fstate=take(buf.fstate, crow),
        carried_player=c_player, rows_apart=apart)


def uniforms(rng_state: torch.Tensor, device, T: int, R: int, D: int,
             G: int, lanes: np.ndarray) -> tuple:
    """The call's draws for ``lanes``, drawn again as the program drew
    them from its stream: each round ``R`` times ``[D, G]`` for the walks,
    then ``[G]`` for the move.  Returns ``(probs [T, R, D, S], u [T,
    S])``."""
    gen = torch.Generator(device=device)
    gen.set_state(rng_state)
    idx = torch.as_tensor(lanes, device=device)
    probs = torch.empty((T, R, D, lanes.size), device=device)
    u = torch.empty((T, lanes.size), device=device)
    for t in range(T):
        for r in range(R):
            probs[t, r] = torch.rand((D, G), generator=gen,
                                     device=device)[:, idx]
        u[t] = torch.rand((G,), generator=gen, device=device)[idx]
    return probs.cpu().numpy(), u.cpu().numpy()


def _same_position(game, enc_a, player_a, me, opp, player) -> np.ndarray:
    a_me, a_opp = game.decode(enc_a)
    return ((a_me == me).all((-1, -2)) & (a_opp == opp).all((-1, -2))
            & (player_a == player))


def judge(game, weights: dict, rec: Records, probs, u, cpuct: float,
          temp_moves: int) -> dict:
    """The numbers (module doc) of the records ``rec`` against the
    reference, with the draws ``probs`` [T, R, D, S] and ``u`` [T, S]."""
    S, T = rec.player.shape
    C = game.cells
    init = game.initial(1)
    init_enc = game.encode(init[0], init[1])[0]

    def is_init(enc, player):
        return (enc.astype(np.float32) == init_enc).all(-1) & (player == 1)

    nxt_enc = np.concatenate([rec.enc[:, 1:], rec.out_enc[:, None]], 1)
    nxt_player = np.concatenate([rec.player[:, 1:], rec.out_player[:, None]],
                                1)
    restart = is_init(nxt_enc, nxt_player)  # [S, T] the game ended
    # each round's episode start (negative: carried in) and move index
    start = np.zeros((S, T), np.int64)
    first = -rec.count_in
    here = is_init(rec.enc, rec.player)
    for t in range(T):
        first = np.where(here[:, t], t, first)
        start[:, t] = first
    ep_move = np.arange(T)[None, :] - start

    me, opp = game.decode(rec.enc.reshape(S * T, -1))
    player = rec.player.reshape(-1)
    R, D = probs.shape[1:3]
    pol = ref_search.search(
        game, weights, me, opp, player,
        probs.transpose(1, 2, 3, 0).reshape(R, D, S * T).copy(), cpuct,
        training=True)
    gaps = np.abs(rec.pol.reshape(S * T, -1) - pol.T).max(-1)
    a_want = ref_search.choose(
        np.ascontiguousarray(rec.pol.reshape(S * T, -1).T),
        u.T.reshape(-1), ep_move.reshape(-1) < temp_moves)
    after = game.play(me, opp, player, a_want)
    term, result = game.is_over(*after)

    # the program's own move, read from the next record
    n_me, n_opp = game.decode(nxt_enc.reshape(S * T, -1))
    n_player = nxt_player.reshape(-1)
    placed = ref_games.cells(n_me | n_opp) & ~ref_games.cells(me | opp)
    n_placed = placed.sum(-1)
    a_prog = np.where(n_placed == 1, placed.argmax(-1), -1)
    if game.actions > C:  # a pass places nothing
        a_prog = np.where(n_placed == 0, C, a_prog)
    a_ok = np.clip(a_prog, 0, game.actions - 1)
    legal = game.legal(me, opp)[np.arange(S * T), a_ok]
    p_me, p_opp, p_player = game.play(me, opp, player, a_ok)
    p_term, _ = game.is_over(p_me, p_opp, p_player)
    follows = ((a_prog >= 0) & legal & ~p_term
               & (p_me == n_me).all((-1, -2)) & (p_opp == n_opp).all((-1, -2))
               & (p_player == n_player))

    cont = ~restart.reshape(-1)
    rules_apart = int((cont & ~follows).sum())
    moves_apart = int((cont & (a_prog != a_want)).sum())
    ff = game.final_feature(after[0], after[2])  # [S*T, C]
    for s, t in zip(*np.nonzero(restart)):
        p = s * T + t
        if not term[p]:
            moves_apart += 1
            continue
        res, f = int(result[p]), ff[p]
        t0 = start[s, t]
        pl = rec.player[s, max(t0, 0):t + 1].astype(np.float32)
        bad = ((rec.value[s, max(t0, 0):t + 1] != (1 + res * pl) / 2).any()
               | (rec.fstate[s, max(t0, 0):t + 1]
                  != f[None, :] * rec.player[s, max(t0, 0):t + 1, None]
                  ).any())
        if t0 < 0:  # the episode carried in: its rows too
            n = rec.count_in[s]
            cp = rec.carried_player[s, :n]
            bad |= ((rec.carried_value[s, :n]
                     != (1 + res * cp.astype(np.float32)) / 2).any()
                    | (rec.carried_fstate[s, :n]
                       != f[None, :] * cp[:, None]).any())
        moves_apart += int(bad)
    return {
        "policy_gap_p90": float(np.quantile(gaps, 0.9, method="higher")),
        "moves_apart": moves_apart,
        "rules_apart": rules_apart,
        "rows_apart": rec.rows_apart,
        "searches": S * T,
        "policy_gap_max": float(gaps.max()),
        "episodes_ended": int(restart.sum()),
        "rows_carried_in": int(rec.count_in.sum()),
    }


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit."""
    rows = [(k, numbers[k], limits[k]) for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
