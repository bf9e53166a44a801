"""Generation orchestrator: selfplay -> SGD -> gating duel -> Elo ->
checkpoint.

Counterpart of :mod:`alphatpu.pipeline`, with its protocol:

* the *best* net plays selfplay (either mode),
* the *train* net keeps training from itself across generations, and
  replaces the best one only when the duel raises the Elo (from -1000):
  its parameters are copied into the best net in place, so the graphs
  captured of the best net's rounds (:mod:`alphatpu_torch.graphs`) serve
  every generation,
* the duel plays the train net against the best one, half the games with
  each starter,
* a checkpoint per generation, the same log lines and the same stats dict.

Every random draw of a run comes from one ``torch.Generator`` on the
run's device, seeded from ``seed`` (the continuous-selfplay carry gets a
generator of its own, seeded from that stream), so a run with a given
seed is deterministic on a given device.

Data-parallel (``devices`` D > 1, alphatpu/pipeline.py:145-210): the
process is one rank of a world of D (:mod:`alphatpu_torch.parallel`,
started by the CLI's ``--devices`` or ``--multihost``), and every rank runs
the same generation on its own device through the sharded executors - 1/D
of the selfplay lanes and duel games and its own buffer shard, with its
own streams drawn from the shared one; the learner averages the gradients,
so the nets stay replicated.  Rank 0 alone logs and writes the checkpoint
(the reference's sharded layout, gathered from every rank).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch

from . import checkpoint as ckpt
from .buffer import ReplayBuffer, create_buffer, global_buffer_size
from .duel import DuelConfig, duel_network, elo_update
from .nets.mlp import MLP, apply_inference, config_for_game
from .parallel.mesh import (
    World, barrier, rank_generator, world_devices, world_rank, world_size,
)
from .parallel.sharded import (
    sharded_duel_network, sharded_selfplay_fn, sharded_train_fn,
)
from .selfplay import (
    EpisodeCarry, SelfplayConfig, make_carry, selfplay_continuous,
    selfplay_generation,
)
from .train import TrainConfig, adam_init, train_epoch


@dataclass
class PipelineConfig:
    selfplay: SelfplayConfig = field(default_factory=SelfplayConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    duel: DuelConfig = field(default_factory=DuelConfig)
    buffer_capacity: int = 2_000_000
    generations: int = 100
    seed: int = 0
    width: int = 512
    depth: Optional[int] = None  # per-game default (nets.config_for_game)
    ckpt_dir: Optional[str] = None
    save_buffer: bool = False
    # (net, x) -> (logits, value): the in-search evaluation
    net_apply: Callable = apply_inference
    # ranks of the data-parallel world: 0 = every visible card (one on the
    # CPU); 1 = the single-device path
    devices: int = 1
    device: str = "cuda"  # the device every tensor of this rank lives on
    log: Callable[[str], None] = print

    def num_devices(self) -> int:
        return world_devices(self.devices, self.device)

    def world(self) -> World:
        """This process's rank in the world of ``num_devices()`` ranks,
        which it must have joined."""
        D = self.num_devices()
        if world_size() != D:
            raise ValueError(
                f"devices={D}: this process is in a world of {world_size()} "
                "rank(s); start one process per device (the CLI's --devices "
                "or --multihost, or alphatpu_torch.parallel.run_ranks)")
        return World(world_rank(), D, torch.device(self.device))


@dataclass
class PipelineState:
    best_net: MLP
    train_net: MLP  # trainable
    opt_state: Dict
    buffer: ReplayBuffer
    rng: torch.Generator
    elo: float = -1000.0
    generation: int = 0
    best_generation: int = 0
    # continuous mode: each lane's in-flight episode, None = start fresh;
    # checkpointed with the buffer (save_buffer), so a resume continues it
    sp_carry: Optional[EpisodeCarry] = None


def init_pipeline(game, cfg: PipelineConfig) -> PipelineState:
    """Fresh nets (Glorot weights from numpy seed ``cfg.seed``), optimizer
    state, buffer (this rank's shard) and generator on ``cfg.device``."""
    D = cfg.world().size
    if cfg.buffer_capacity % D:
        raise ValueError(f"--buffer-capacity ({cfg.buffer_capacity}) must "
                         f"divide the device count {D}")
    dev = torch.device(cfg.device)
    net_cfg = config_for_game(game, width=cfg.width, depth=cfg.depth)
    best = MLP.from_seed(net_cfg, cfg.seed, device=dev)
    train = best.copy(trainable=True)
    return PipelineState(
        best_net=best,
        train_net=train,
        opt_state=adam_init(train),
        buffer=create_buffer(game, cfg.buffer_capacity // D, device=dev),
        rng=torch.Generator(device=dev).manual_seed(cfg.seed),
    )


def _sharded_exec(game, cfg: PipelineConfig, world: World):
    """The (selfplay, train, duel) executors of a world of several ranks,
    after the reference's divisibility checks."""
    D = world.size
    if cfg.selfplay.num_games % D:
        raise ValueError(f"--samples ({cfg.selfplay.num_games}) must divide "
                         f"the device count {D}")
    if cfg.train.batch_size % D:
        raise ValueError(f"--batchsize ({cfg.train.batch_size}) must divide "
                         f"the device count {D}")
    if cfg.duel.num_games % (2 * D):
        raise ValueError(f"--duel-games ({cfg.duel.num_games}) must divide "
                         f"2x the device count {D}")
    return (sharded_selfplay_fn(game, cfg.net_apply, cfg.selfplay, world),
            sharded_train_fn(game, cfg.train, world),
            sharded_duel_network(game, cfg.net_apply, cfg.duel, world))


def child_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device, seeded from one draw of it."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


def _silent(line: str) -> None:
    pass


def run_generation(game, state: PipelineState, cfg: PipelineConfig):
    """One generation.  Mutates and returns ``state`` plus a stats dict.
    In a world of several ranks every rank calls it; the stats are the
    world's."""
    world = cfg.world()
    D = world.size
    log = cfg.log if world.rank == 0 else _silent
    gen = state.generation + 1
    dev = state.buffer.state.device
    best_apply = partial(cfg.net_apply, state.best_net)
    if D > 1:
        sp_fn, tr_fn, duel_fn = _sharded_exec(game, cfg, world)
        # this rank's selfplay and train streams, and the duel's shared one
        sp_gen = rank_generator(state.rng, world)
        tr_gen = rank_generator(state.rng, world)
        duel_gen = child_generator(state.rng)

    t0 = time.time()
    if D > 1:
        if cfg.selfplay.continuous:
            if state.sp_carry is None:
                state.sp_carry = make_carry(game, cfg.selfplay.num_games // D,
                                            None, dev)
            state.buffer, sp_stats, state.sp_carry = sp_fn(
                state.best_net, state.buffer, sp_gen, state.sp_carry)
        else:
            state.buffer, sp_stats = sp_fn(state.best_net, state.buffer,
                                           sp_gen)
    elif cfg.selfplay.continuous:
        if state.sp_carry is None:
            state.sp_carry = make_carry(game, cfg.selfplay.num_games,
                                        child_generator(state.rng), dev)
        state.buffer, sp_stats, state.sp_carry = selfplay_continuous(
            game, best_apply, state.buffer, None, cfg.selfplay,
            state.sp_carry)
    else:
        state.buffer, sp_stats = selfplay_generation(
            game, best_apply, state.buffer, state.rng, cfg.selfplay)
    sp_stats = {k: v.item() for k, v in sp_stats.items()}
    t_sp = time.time() - t0
    # a collective: every rank takes it here, never inside a log argument
    buffer_total = global_buffer_size(state.buffer)
    log(f"[gen {gen}] selfplay: {t_sp:.1f}s  "
        f"w/d/l={int(sp_stats['wins'])}/{int(sp_stats['draws'])}/"
        f"{int(sp_stats['losses'])}  "
        f"mean_len={float(sp_stats['mean_length']):.1f}  "
        f"buffer={buffer_total}")
    if int(sp_stats["illegal_moves"]):
        log(f"[gen {gen}] WARNING illegal moves: "
            f"{int(sp_stats['illegal_moves'])}")
    if not cfg.selfplay.continuous and int(sp_stats["unfinished"]):
        log(f"[gen {gen}] note: {int(sp_stats['unfinished'])} unfinished "
            "games")

    t0 = time.time()
    loss = None
    for _ in range(cfg.train.epochs):
        if D > 1:
            state.opt_state, loss = tr_fn(state.train_net, state.opt_state,
                                          state.buffer, tr_gen)
        else:
            state.opt_state, loss = train_epoch(
                state.train_net, state.opt_state, state.buffer, state.rng,
                cfg.train)
    loss = float(loss)
    t_tr = time.time() - t0
    log(f"[gen {gen}] train: {t_tr:.1f}s  loss={loss:.4f}")

    t0 = time.time()
    if D > 1:
        w, d, l, du_unfinished = duel_fn(state.train_net, state.best_net,
                                         duel_gen)
    else:
        w, d, l, du_unfinished = duel_network(
            game, partial(cfg.net_apply, state.train_net), best_apply,
            state.rng, cfg.duel, dev)
    t_du = time.time() - t0
    new_elo = elo_update(w, d, l, state.elo)
    passed = new_elo > state.elo
    log(f"[gen {gen}] duel: {t_du:.1f}s  candidate w/d/l={w}/{d}/{l}  "
        f"elo {state.elo:.1f} -> {new_elo:.1f}  "
        f"{'PROMOTED' if passed else 'kept'}")
    if du_unfinished:
        log(f"[gen {gen}] note: {du_unfinished} duel games unfinished at the "
            f"move bound (excluded from the tally)")
    if passed:
        state.elo = new_elo
        # in place: the captured selfplay and duel rounds read the best
        # net's parameters by address, so they replay with the new ones
        with torch.no_grad():
            for name, p in state.best_net.named_parameters():
                p.copy_(getattr(state.train_net, name))
        state.best_generation = gen

    state.generation = gen
    if cfg.ckpt_dir:
        # every rank gathers (collectives), rank 0 writes
        buffer = ckpt.gather_buffer(state.buffer) if cfg.save_buffer else None
        carry = (ckpt.gather_carry(state.sp_carry)
                 if cfg.save_buffer and state.sp_carry is not None else None)
        if world.rank == 0:
            ckpt.save_checkpoint(
                cfg.ckpt_dir, gen,
                best_net=state.best_net,
                train_net=state.train_net,
                opt_state=state.opt_state,
                elo=state.elo,
                best_generation=state.best_generation,
                rng=state.rng,
                buffer=buffer,
                sp_carry=carry,
            )
        if D > 1:
            barrier()  # the checkpoint is on disk when any rank returns
    stats = {
        "generation": gen,
        "selfplay_s": t_sp,
        "train_s": t_tr,
        "duel_s": t_du,
        "loss": loss,
        "duel": (w, d, l),
        "duel_unfinished": du_unfinished,
        "elo": state.elo,
        "promoted": passed,
        **sp_stats,
    }
    return state, stats


def run_training(game, cfg: PipelineConfig,
                 state: PipelineState | None = None):
    if state is None:
        state = init_pipeline(game, cfg)
    history = []
    for _ in range(cfg.generations - state.generation):
        state, stats = run_generation(game, state, cfg)
        history.append(stats)
        cfg.log(f"[gen {stats['generation']}] best so far: generation "
                f"{state.best_generation}, elo {state.elo:.1f}")
    return state, history


def resume(game, state: PipelineState, cfg: PipelineConfig) -> Dict[str, Any]:
    """Load the latest checkpoint of ``cfg.ckpt_dir`` into ``state`` (in
    place; with ``cfg.save_buffer`` the buffer and, in continuous mode, the
    carry too - this rank's shard of each, from a checkpoint of as many
    ranks).  Returns the manifest.  A checkpoint of the reference package
    has a JAX key where this package keeps a generator state; the run then
    keeps the stream ``state`` was seeded with."""
    world = cfg.world()
    carry_tmpl = None
    if cfg.selfplay.continuous and cfg.save_buffer:
        carry_tmpl = make_carry(game, cfg.selfplay.num_games // world.size,
                                None, state.buffer.state.device)
    manifest, loaded = ckpt.load_checkpoint(
        cfg.ckpt_dir, best_net=state.best_net, train_net=state.train_net,
        opt_state=state.opt_state,
        buffer=state.buffer if cfg.save_buffer else None,
        sp_carry=carry_tmpl, world=world)
    state.best_net = loaded["best"]
    state.train_net = loaded["train"]
    state.opt_state = loaded["opt"]
    if loaded["rng"] is not None:
        state.rng = loaded["rng"]
    if "buffer" in loaded:
        state.buffer = loaded["buffer"]
    if "sp_carry" in loaded:
        state.sp_carry = loaded["sp_carry"]
        if state.sp_carry.rng is None:
            state.sp_carry.rng = child_generator(state.rng)
    state.elo = manifest["elo"]
    state.generation = manifest["generation"]
    state.best_generation = manifest["best_generation"]
    return manifest
