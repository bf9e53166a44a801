"""Selfplay: every game decides a move per round with a full MCTS search.

Counterpart of :mod:`alphatpu.selfplay`, with its two modes:

* :func:`selfplay_generation` plays one game per lane for at most
  ``max_moves`` rounds (default the game's ``max_game_length``), masking
  the lanes whose game has ended; only the moves of finished games are
  written, and a game still running at the bound is counted ``unfinished``,
* :func:`selfplay_continuous` restarts a finished game's lane at once and
  hands each lane's running episode to the next call through an
  :class:`EpisodeCarry`.

The reference runs a call - the rounds' ``scan`` and the buffer write
after it - as one jitted program.  Here a call's rounds and its tail (the
back-fill, the buffer write, the next carry and the stats) run on static
state (:class:`GenerationRounds`, :class:`ContinuousRounds`): each step is
fixed-shape and never waits for the device, and on the card each is
captured once as a CUDA graph and replayed, the round once per round and
the tail once per call, so a call makes no host sync
(:mod:`alphatpu_torch.graphs`); on the CPU the same steps run eagerly.
The per-round semantics are the reference's:

* move selection samples from the root policy while the lane's in-episode
  move index is below ``temp_moves`` and takes the argmax after,
* the recorded sample is (root encoding, root policy, player to move);
  value and final feature are back-filled per episode once it ends,
* an episode still running after the last round is handed to the next call
  through the carry, so no searched move is dropped.

Random numbers come from a ``torch.Generator`` on the device (the carry
keeps it, so chained calls continue one stream), or - for tests that hold
the port to the reference - from pre-drawn :class:`SelfplayUniforms`.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import torch

from . import graphs
from .buffer import ReplayBuffer, write_samples
from .games.base import where_games
from .mcts.newton import cdf_sample, row_sum
from .mcts.search import engine_level, run_mcts
from .mcts.tree import init_tree, reset_tree, stat_dtype_for, write_where


class SelfplayConfig(NamedTuple):
    num_games: int = 32768
    rollouts: int = 64
    cpuct: float = 1.5
    temp_moves: int = 25  # sample below this in-episode move index
    max_moves: int | None = None  # generation mode; game.max_game_length
    # continuous mode (the pipeline's switch): num_games lanes recycle
    # finished games for ``rounds`` rounds (default 2 * max_game_length)
    continuous: bool = False
    rounds: int | None = None
    # recompute the root policy after the final backup (see run_mcts)
    fresh_root_policy: bool = False


class SelfplayUniforms(NamedTuple):
    """Pre-drawn uniforms for ``T`` rounds: the injection point that lets a
    test feed this port and the reference the same random numbers."""

    probs: torch.Tensor  # f32[T, R, D, G] - per round, rollout and depth
    move: torch.Tensor  # f32[T, G] - per round, the move-sampling uniform


def broadcast_initial(game, num_games: int, device=None):
    return game.initial(num_games, device)


@dataclasses.dataclass
class EpisodeCarry:
    """Each lane's in-flight episode, handed from one call to the next."""

    positions: object  # game state, leaves leading with G
    count: torch.Tensor  # i32[G] - moves already recorded this episode
    enc: torch.Tensor  # i8[G, L, 2*VS] - root encodings, rows [0, count)
    pol: torch.Tensor  # f32[G, L, A] - root policies
    player: torch.Tensor  # i8[G, L] - player to move
    rng: torch.Generator | None  # continues the selfplay stream


def make_carry(game, num_games: int, generator: torch.Generator | None,
               device=None) -> EpisodeCarry:
    """Fresh carry: all lanes start new episodes."""
    L = game.max_game_length
    return EpisodeCarry(
        positions=broadcast_initial(game, num_games, device),
        count=torch.zeros((num_games,), dtype=torch.int32, device=device),
        enc=torch.zeros((num_games, L, 2 * game.vectorized_state),
                        dtype=torch.int8, device=device),
        pol=torch.zeros((num_games, L, game.max_actions), dtype=torch.float32,
                        device=device),
        player=torch.zeros((num_games, L), dtype=torch.int8, device=device),
        rng=generator,
    )


def _decide_moves(game, net, positions, tree, ep_move, cfg: SelfplayConfig,
                  generator=None, probs=None, u=None):
    """One move round: search every lane's position (the tree is reset in
    place), pick a move and play it.

    Returns ``(root_enc, player, pol, ok, newpos, finished, result)``;
    ``ok`` is the legality of each chosen move; ``player`` is
    ``positions.player`` itself."""
    G = positions.player.shape[0]
    reset_tree(tree, positions)
    _, pol = run_mcts(
        game, net, tree, rollouts=cfg.rollouts, cpuct=cfg.cpuct,
        training=True, generator=generator, probs=probs,
        final_root_policy=cfg.fresh_root_policy,
    )
    root_enc = game.encode(positions).to(torch.int8)

    # pol is [A, G]: sample as uniform * total mass with the CDF walk
    if u is None:
        u = torch.rand((G,), generator=generator, device=pol.device)
    sampled = cdf_sample(pol, u * row_sum(pol))
    greedy = torch.argmax(pol, dim=0).to(torch.int32)
    action = torch.where(ep_move < cfg.temp_moves, sampled, greedy)

    legal = game.legal_mask(positions)
    ok = legal.gather(1, action.long()[:, None])[:, 0]
    newpos = game.play(positions, action)
    finished, result = game.is_over(newpos)
    return root_enc, positions.player, pol, ok, newpos, finished, result


def _record(plane: torch.Tensor, t: torch.Tensor, row: torch.Tensor):
    """``plane[t] = row`` at the round index ``t`` (a device scalar)."""
    plane.index_copy_(0, t.long().reshape(1), row[None])


class SearchRounds(graphs.Rounds):
    """Rounds that search every lane of ``cfg.num_games`` once a round:
    the starting positions, the positions and their tree, the round
    index ``t`` (a device scalar),
    and the static buffers of injected draws - ``probs`` (f32[R, D, G])
    and ``move`` (f32[G]), filled before each round by the function that
    :meth:`feeder` returns, or None where the draws come from the
    generator."""

    def __init__(self, game, cfg, device, injected: bool):
        super().__init__(device)
        G, R, dev = cfg.num_games, cfg.rollouts, self.device
        D = min(game.max_game_length, R)
        self.game, self.cfg = game, cfg
        self.initial = broadcast_initial(game, G, dev)
        self.positions = broadcast_initial(game, G, dev)
        self.tree = init_tree(game, self.positions, R,
                              stat_dtype=stat_dtype_for(R))
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.probs = self.move = None
        if injected:
            self.probs = torch.empty((R, D, G), dtype=torch.float32,
                                     device=self.device)
            self.move = torch.empty((G,), dtype=torch.float32,
                                    device=self.device)

    @staticmethod
    def key(kind: str, game, cfg, uniforms, device) -> tuple:
        """What fixes a program of such rounds (``graphs.rounds_for``):
        the game, the caller's config (the shapes and the search's
        constants), the stat dtype and engine level (read from the
        switches at each call), whether the draws are injected and the
        device."""
        stat_dtype = stat_dtype_for(cfg.rollouts)
        return (kind, game.name, cfg, stat_dtype,
                engine_level(None, True, stat_dtype), uniforms is not None,
                device)

    def feeder(self, uniforms: SelfplayUniforms | None):
        if uniforms is None:
            return None

        def feed(t):
            self.probs.copy_(uniforms.probs[t])
            self.move.copy_(uniforms.move[t])
        return feed


class GenerationRounds(SearchRounds):
    """The static state of :func:`selfplay_generation`'s ``T`` rounds on
    ``cfg.num_games`` lanes; :meth:`start` sets it for a call, each
    :meth:`round` plays one round in place."""

    def __init__(self, game, cfg: SelfplayConfig, T: int, device,
                 injected: bool = False):
        super().__init__(game, cfg, device, injected)
        G, A, dev = cfg.num_games, game.max_actions, self.device
        self.T = T
        self.done = torch.zeros((G,), dtype=torch.bool, device=dev)
        self.result = torch.zeros((G,), dtype=torch.int8, device=dev)
        self.fin_t = torch.zeros((G,), dtype=torch.int32, device=dev)
        self.illegal = torch.zeros((), dtype=torch.int64, device=dev)
        self.enc_s = torch.empty((T, G, 2 * game.vectorized_state),
                                 dtype=torch.int8, device=dev)
        self.pol_s = torch.empty((T, G, A), dtype=torch.float32, device=dev)
        self.player_s = torch.empty((T, G), dtype=torch.int8, device=dev)
        self.alive_s = torch.empty((T, G), dtype=torch.bool, device=dev)

    def start(self) -> None:
        graphs.assign(self.positions, self.initial)
        for x in (self.t, self.done, self.result, self.fin_t, self.illegal):
            x.zero_()

    def round(self, net) -> None:
        t = self.t
        alive = ~self.done
        root_enc, player_t, pol, ok, newpos, f, r = _decide_moves(
            self.game, net, self.positions, self.tree,
            t.expand(self.cfg.num_games), self.cfg,
            generator=self.generator, probs=self.probs, u=self.move)
        self.illegal += (alive & ~ok).sum()
        _record(self.enc_s, t, root_enc)
        _record(self.pol_s, t, pol.T)
        _record(self.player_s, t, player_t)
        _record(self.alive_s, t, alive)
        graphs.assign(self.positions,
                      where_games(alive, newpos, self.positions))
        newly = alive & f
        self.result.copy_(torch.where(newly, r, self.result))
        self.fin_t.copy_(torch.where(newly, t, self.fin_t))
        self.done |= f
        self.t += 1

    def tail(self, buffer: ReplayBuffer) -> dict:
        """The call's tail, one more step of the program: the value and
        final-feature back-fill of every finished game's moves, their
        write to ``buffer`` and the stats."""
        game, T, G = self.game, self.T, self.cfg.num_games
        A = game.max_actions
        result, done, player_s = self.result, self.done, self.player_s
        final_feat = game.final_feature(self.positions)  # [G, fsize]
        value_s = (1.0 + result.to(torch.float32)[None, :]
                   * player_s.to(torch.float32)) / 2.0
        fstate_s = final_feat[None, :, :] * player_s[:, :, None]
        mask = self.alive_s & done[None, :]  # only the moves of finished games
        write_samples(buffer, self.enc_s.reshape(T * G, -1),
                      self.pol_s.reshape(T * G, A), player_s.reshape(T * G),
                      value_s.reshape(T * G), fstate_s.reshape(T * G, -1),
                      mask.reshape(T * G))
        n_done = done.sum()
        return {
            "wins": ((result == 1) & done).sum(),
            "draws": ((result == 0) & done).sum(),
            "losses": ((result == -1) & done).sum(),
            "mean_length": torch.where(
                n_done > 0, self.fin_t.sum().to(torch.float32)
                / torch.clamp_min(n_done, 1).to(torch.float32), 0.0),
            "illegal_moves": self.illegal.clone(),
            "unfinished": (~done).sum(),
            "samples_written": mask.sum(),
        }


def selfplay_generation(game, net, buffer: ReplayBuffer,
                        generator: torch.Generator | None,
                        cfg: SelfplayConfig,
                        uniforms: SelfplayUniforms | None = None,
                        captured: bool | None = None):
    """Play ``cfg.num_games`` games from the start for ``T = cfg.max_moves
    or game.max_game_length`` rounds and write every move of each finished
    game to ``buffer`` (in place).  A lane whose game has ended keeps its
    final position; its searches and moves are masked out.

    ``captured`` (default: on a CUDA device) replays the rounds and the
    call's tail (the back-fill, the buffer write and the stats) from CUDA
    graphs (:mod:`alphatpu_torch.graphs`), so a call makes no host sync;
    ``captured=False`` runs them eagerly.

    Returns ``(buffer, stats)``: ``stats`` is a dict of 0-d tensors (wins /
    draws / losses from the first mover's view, mean_length (0-based ply of
    the last move), illegal_moves, unfinished, samples_written)."""
    T = cfg.max_moves or game.max_game_length
    dev = buffer.state.device
    captured = graphs.use_graphs(captured, dev)

    def make():
        return GenerationRounds(game, cfg, T, dev, uniforms is not None)

    key = GenerationRounds.key("generation", game, cfg, uniforms, dev)
    st = graphs.rounds_for(key, (net,), make) if captured else make()
    st.start()
    graphs.play(st, T, lambda t: net, generator, st.feeder(uniforms),
                captured)

    return buffer, _tail(st, buffer, captured)


class ContinuousRounds(SearchRounds):
    """The static state of :func:`selfplay_continuous`'s ``T`` rounds on
    ``cfg.num_games`` lanes; :meth:`start` sets it from a call's carry,
    each :meth:`round` plays one round in place."""

    def __init__(self, game, cfg: SelfplayConfig, T: int, device,
                 injected: bool = False):
        super().__init__(game, cfg, device, injected)
        G, A, dev = cfg.num_games, game.max_actions, self.device
        self.T = T
        self.E = T // game.min_game_length + 2  # episode table rows per lane
        self.eid = torch.zeros((G,), dtype=torch.int32, device=dev)
        self.ep_start = torch.zeros((G,), dtype=torch.int32, device=dev)
        self.res_table = torch.zeros((self.E, G), dtype=torch.int8,
                                     device=dev)
        self.ftable = torch.zeros((self.E, G, game.feature_size),
                                  dtype=torch.int8, device=dev)
        # wins, draws, losses, length_sum, illegal
        self.tally = torch.zeros((5,), dtype=torch.int64, device=dev)
        self.enc_s = torch.empty((T, G, 2 * game.vectorized_state),
                                 dtype=torch.int8, device=dev)
        self.pol_s = torch.empty((T, G, A), dtype=torch.float32, device=dev)
        self.player_s = torch.empty((T, G), dtype=torch.int8, device=dev)
        self.eid_s = torch.empty((T, G), dtype=torch.int32, device=dev)
        # the call's carry, copied in: the tail reads its rows
        self.carried = make_carry(game, G, None, dev)

    def start(self, carry: EpisodeCarry) -> None:
        graphs.assign(self.positions, carry.positions)
        for name in ("count", "enc", "pol", "player"):
            getattr(self.carried, name).copy_(getattr(carry, name))
        # continuing episodes began count moves ago
        torch.neg(carry.count, out=self.ep_start)
        for x in (self.t, self.eid, self.res_table, self.ftable, self.tally):
            x.zero_()

    def round(self, net) -> None:
        t, eid = self.t, self.eid
        ep_move = t - self.ep_start
        root_enc, player_t, pol, ok, newpos, f, r = _decide_moves(
            self.game, net, self.positions, self.tree, ep_move, self.cfg,
            generator=self.generator, probs=self.probs, u=self.move)

        # terminated lanes: record the episode, then recycle
        fe = f & (eid < self.E)
        write_where(self.res_table, eid, fe, r)
        write_where(self.ftable, eid, fe, self.game.final_feature(newpos))
        self.tally += torch.stack([
            (f & (r == 1)).sum(), (f & (r == 0)).sum(),
            (f & (r == -1)).sum(), torch.where(f, ep_move, 0).sum(),
            (~ok).sum()])
        _record(self.enc_s, t, root_enc)
        _record(self.pol_s, t, pol.T)
        _record(self.player_s, t, player_t)
        _record(self.eid_s, t, eid)
        graphs.assign(self.positions, where_games(f, self.initial, newpos))
        eid += f.to(torch.int32)
        self.ep_start.copy_(torch.where(f, t + 1, self.ep_start))
        self.t += 1

    def tail(self, buffer: ReplayBuffer):
        """The call's tail, one more step of the program: the back-fill of
        every completed episode's rows (the carried-in ones first), their
        write to ``buffer``, the next carry's positions and rows, and the
        stats.  Returns ``(positions, count, enc, pol, player, stats)``."""
        game, T, G, E = self.game, self.T, self.cfg.num_games, self.E
        L, A = game.max_game_length, game.max_actions
        carry, dev = self.carried, self.device
        eid, res_table, ftable, player_s = (self.eid, self.res_table,
                                            self.ftable, self.player_s)
        g = torch.arange(G, device=dev)
        wins, draws, losses, length_sum, illegal = self.tally.clone()

        # per-sample episode lookups and the back-fill
        eid_l = self.eid_s.long().clamp_max(E - 1)
        res_s = torch.gather(res_table, 0, eid_l)  # [T, G]
        fstate_ep = ftable[eid_l, g[None, :]]  # [T, G, fsize]
        value_s = (1.0 + res_s.to(torch.float32)
                   * player_s.to(torch.float32)) / 2.0
        fstate_s = fstate_ep * player_s[:, :, None]
        completed = self.eid_s < eid[None, :]  # episode finished before T

        # carried-in rows belong to episode 0: back-fill from table row 0
        lio = torch.arange(L, device=dev)[None, :]  # [1, L]
        pend_value = (1.0 + res_table[0].to(torch.float32)[:, None]
                      * carry.player.to(torch.float32)) / 2.0
        pend_fstate = ftable[0][:, None, :] * carry.player[:, :, None]
        pend_mask = (lio < carry.count[:, None]) & (eid > 0)[:, None]

        # carried rows are older than this call's: write them first
        write_samples(
            buffer,
            torch.cat([carry.enc.reshape(G * L, -1),
                       self.enc_s.reshape(T * G, -1)]),
            torch.cat([carry.pol.reshape(G * L, A),
                       self.pol_s.reshape(T * G, A)]),
            torch.cat([carry.player.reshape(G * L), player_s.reshape(T * G)]),
            torch.cat([pend_value.reshape(G * L), value_s.reshape(T * G)]),
            torch.cat([pend_fstate.reshape(G * L, -1),
                       fstate_s.reshape(T * G, -1)]),
            torch.cat([pend_mask.reshape(G * L), completed.reshape(T * G)]),
        )

        # next carry: the rows of each lane's still-running episode, which
        # started at round s (negative: the carried-in episode, still
        # running)
        s = self.ep_start
        new_count = T - s
        overflow = new_count > L  # outlived maxLengthGame: reset the lane
        src = torch.clamp(lio + s[:, None], 0, T - 1).long()  # [G, L]
        from_old = lio < -s[:, None]

        def merge(old_gl, new_tg):  # [G, L, ...] <- [T, G, ...]
            new_g = torch.movedim(new_tg, 0, 1)  # [G, T, ...]
            rest = tuple(new_g.shape[2:])
            idx = src.reshape(src.shape + (1,) * len(rest)).expand(
                (G, L) + rest)
            gathered = torch.gather(new_g, 1, idx)
            keep = from_old.reshape(from_old.shape + (1,) * len(rest))
            return torch.where(keep, old_gl, gathered)

        count = torch.where(overflow, 0, new_count).to(torch.int32)
        finished = eid.sum()
        stats = {
            "wins": wins,
            "draws": draws,
            "losses": losses,
            "mean_length": length_sum.to(torch.float32)
            / torch.clamp_min(finished, 1).to(torch.float32),
            "illegal_moves": illegal,
            # rows dropped because an episode outlived maxLengthGame
            "unfinished": torch.where(overflow, T - s, 0).sum(),
            "carried": count.sum(),
            "games_finished": finished,
            "samples_written": pend_mask.sum() + completed.sum(),
        }
        return (where_games(overflow, self.initial, self.positions), count,
                merge(carry.enc, self.enc_s), merge(carry.pol, self.pol_s),
                merge(carry.player, player_s), stats)


def selfplay_continuous(game, net, buffer: ReplayBuffer,
                        generator: torch.Generator | None,
                        cfg: SelfplayConfig,
                        carry: EpisodeCarry | None = None,
                        uniforms: SelfplayUniforms | None = None,
                        captured: bool | None = None):
    """Play ``cfg.rounds`` move rounds on ``cfg.num_games`` lanes, recycling
    every finished lane into a fresh game, and write every completed
    episode's samples to ``buffer`` (in place).

    ``carry`` (None = fresh start) continues in-flight episodes: when one
    ends, its moves recorded in earlier calls are written with this call's.
    Given a carry, its ``rng`` continues the stream and ``generator`` is
    ignored.  ``uniforms`` replaces every random draw.  ``captured``
    (default: on a CUDA device) replays the rounds and the call's tail
    (the back-fill, the buffer write, the next carry and the stats) from
    CUDA graphs (:mod:`alphatpu_torch.graphs`), so a call makes no host
    sync; ``captured=False`` runs them eagerly.  The carry is copied into
    the program's state before the rounds, and the next carry and the
    stats out of it after the tail: the returned tensors are the
    caller's, and no later call overwrites them.

    Returns ``(buffer, stats, carry')``: ``stats`` is a dict of 0-d tensors
    (wins / draws / losses from the first mover's view, mean_length,
    illegal_moves, unfinished, carried, games_finished, samples_written).
    """
    T = cfg.rounds or 2 * game.max_game_length
    dev = buffer.state.device
    captured = graphs.use_graphs(captured, dev)
    if carry is None:
        carry = make_carry(game, cfg.num_games, generator, dev)
    gen = carry.rng

    def make():
        return ContinuousRounds(game, cfg, T, dev, uniforms is not None)

    key = ContinuousRounds.key("continuous", game, cfg, uniforms, dev)
    st = graphs.rounds_for(key, (net,), make) if captured else make()
    st.start(carry)
    graphs.play(st, T, lambda t: net, gen, st.feeder(uniforms), captured)
    positions, count, enc, pol, player, stats = _tail(st, buffer, captured)
    return buffer, stats, EpisodeCarry(positions, count, enc, pol, player,
                                       rng=gen)


def _tail(st: SearchRounds, buffer: ReplayBuffer, captured: bool):
    """The call's tail, ``st.tail(buffer)``, as a step of the program: its
    graph writes the buffer by address, so a program keeps one for the
    buffer of its last call and captures a new one for another buffer.
    A replay's outputs are copied out: the caller owns what it gets."""
    key = ("tail", graphs.addresses(*vars(buffer).values()))
    for old in [k for k in st.graphs if k[0] == "tail" and k != key]:
        del st.graphs[old]
    out = graphs.step(st, key, partial(st.tail, buffer), captured)
    return graphs.copied(out) if captured else out
