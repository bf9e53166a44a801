"""Paired probe games: one checkpoint's net against the game's probe on two
devices from the same random numbers, compared ply by ply.

    # the games on one device; the uniforms drawn with numpy from --seed
    python -m alphatpu_torch.benchmarks.probe_pair play --game gobang13 \\
        --ckpt net56.npz --games 256 --device cuda --workers 8 --out card.json
    # (--eager: the card's steps run eagerly, not replayed from graphs)
    python -m alphatpu_torch.benchmarks.probe_pair compare card.json cpu.json
    # on the card: each ply where the two first part, searched again
    python -m alphatpu_torch.benchmarks.probe_pair rerun --ckpt net56.npz \\
        --card card.json --cpu cpu.json --out rerun
    # on the CPU: that rerun's verdicts
    python -m alphatpu_torch.benchmarks.probe_pair classify \\
        --ckpt net56.npz --rerun rerun --cpu cpu.json --out classes.json
    # one continuous-selfplay generation, round by round
    python -m alphatpu_torch.benchmarks.probe_pair selfplay --game gobang13 \\
        --ckpt net56.npz --games 128 --rounds 169 --device cuda --out sp.json

``play`` runs :func:`~alphatpu_torch.probe.eval_vs_probe` with ``trace=True``
and ``uniforms`` drawn ply by ply (:class:`PlyDraws`: ply t from
``np.random.default_rng([seed, t])``), so two devices search the same games
on the same uniforms; the probe's moves and tie-breaks are the probe's own
(``np.random.default_rng(seed * 100003 + game)``).  The trace holds, per
game, the applied actions, the net's greedy and sampled picks at every ply
and the result.

``compare`` reports each trace's W/D/L, the games equal ply for ply, and
for every other game the first ply where a pick differs and the first
where the applied actions differ, with the paired score difference and its
spread (the square root of the games whose outcomes differ).  On two
``selfplay`` traces: each one's mean finished-game length and the first
round where a lane's position differs.

``rerun`` (on the card) rebuilds the positions at each such ply from the
card's trace and searches them again: with the kernels, as the trace did,
and with the kernels' plain versions on the same card tensors.  It keeps
the card net's leaf inputs and outputs of the lanes that part (``.npz``).
``classify`` (on the CPU) searches those lanes on the CPU path twice: fed
the card net's recorded outputs, and with its own net (which must give
the CPU trace's picks); and measures the CPU net against the card net on
the card's leaf inputs.  A lane parts by **net rounding** when the same
net outputs give the same picks on both devices; by **search** when the
kernel parts from its plain version, or the CPU path from the card's on
the same net outputs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import platform
import time
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..buffer import create_buffer
from ..games import make_game
from ..games import kernels as rules
from ..games.base import where_games
from ..mcts import kernels as K
from ..mcts.newton import cdf_sample
from ..mcts.search import run_mcts
from ..mcts.tree import init_tree, stat_dtype_for
from ..nets import config_for_game, params_from_jax
from ..probe import eval_vs_probe, probe_for_game
from ..selfplay import (SelfplayConfig, SelfplayUniforms, make_carry,
                        selfplay_continuous)
from .train_record import card_line

OUTCOMES = ("win", "draw", "loss")  # the net's view
# the probe protocol's search constant and sampled plies (the probe CLI's
# defaults, those of every probe record)
CPUCT = 1.5
TEMP_MOVES = 8


class PlyDraws:
    """The uniforms of ply (or round) t, drawn on demand: ``probs``
    f32[R, D, G], then ``move`` f32[G], from ``np.random.default_rng([seed,
    offset + t])``.  :meth:`uniforms` gives them as the
    :class:`~alphatpu_torch.selfplay.SelfplayUniforms` the rounds' feeder
    indexes (``probs[t]``, ``move[t]``): the whole block of a 256-game
    gobang13 probe would take 720 MB."""

    def __init__(self, seed: int, R: int, D: int, G: int, offset: int = 0):
        self.seed, self.shape, self.G, self.offset = seed, (R, D, G), G, offset
        self._last = None

    def draw(self, t: int):
        if self._last is None or self._last[0] != t:
            rng = np.random.default_rng([self.seed, self.offset + t])
            probs = rng.random(self.shape, dtype=np.float32)
            move = rng.random(self.G, dtype=np.float32)
            self._last = (t, torch.from_numpy(probs), torch.from_numpy(move))
        return self._last[1:]

    def uniforms(self) -> SelfplayUniforms:
        return SelfplayUniforms(_Field(self, 0), _Field(self, 1))


class _Field:
    def __init__(self, draws: PlyDraws, k: int):
        self.draws, self.k = draws, k

    def __getitem__(self, t):
        return self.draws.draw(int(t))[self.k]


def load_net(game, ckpt: str, dev):
    with np.load(ckpt) as z:
        return params_from_jax(dict(z), config_for_game(game), device=dev,
                               prefix="best/")


def run_header(dev, seed: int) -> dict:
    h = {"python": platform.python_version(), "torch": torch.__version__,
         "device": str(dev), "seed": seed,
         "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if dev.type == "cuda":
        h["card"] = card_line()
        h["device_name"] = torch.cuda.get_device_name(dev)
        h["cuda"] = torch.version.cuda
    return h


def trace_games(trace: dict, G: int) -> list:
    """Per game: the plies it was alive, as lists, and its outcome."""
    games = [{"net_first": bool(trace["net_first"][i]), "actions": [],
              "greedy": [], "sampled": []} for i in range(G)]
    for rec in trace["records"]:
        for i in np.flatnonzero(rec["alive"]):
            g = games[i]
            g["actions"].append(int(rec["action"][i]))
            g["greedy"].append(int(rec["greedy"][i]))
            g["sampled"].append(int(rec["sampled"][i]))
    for i, g in enumerate(games):
        r = int(trace["result"][i]) * int(trace["net_sign"][i])
        g["outcome"] = OUTCOMES[1 - r]
    return games


def play(args) -> dict:
    dev = resolve_device(args.device)
    game = make_game(args.game)
    net = load_net(game, args.ckpt, dev)
    R, G = args.rollout, args.games
    draws = PlyDraws(args.seed, R, min(game.max_game_length, R), G)
    probe = probe_for_game(game, args.depth)
    pool = (multiprocessing.get_context("spawn").Pool(args.workers)
            if args.workers > 1 else None)
    t0 = time.perf_counter()
    try:
        w, d, l, trace = eval_vs_probe(
            game, net, None, probe, num_games=G, rollouts=R,
            cpuct=CPUCT, temp_moves=TEMP_MOVES, seed=args.seed,
            trace=True, device=dev, uniforms=draws.uniforms(),
            captured=False if args.eager else None, pool=pool)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    out = {"kind": "probe", "game": game.name, "ckpt": args.ckpt,
           "games": G, "rollouts": R, "cpuct": CPUCT,
           "temp_moves": TEMP_MOVES, "probe_depth": probe.depth,
           "captured": dev.type == "cuda" and not args.eager,
           "net_wins": w, "draws": d, "net_losses": l,
           "seconds": round(time.perf_counter() - t0, 3),
           **run_header(dev, args.seed), "trace": trace_games(trace, G)}
    return out


def first_difference(a: dict, b: dict, keys) -> int | None:
    """The first ply where the two games' lists under ``keys`` differ (a
    game that ends earlier differs at its length), else None."""
    n = max(len(a["actions"]), len(b["actions"]))
    for t in range(n):
        for k in keys:
            if t >= len(a[k]) or t >= len(b[k]) or a[k][t] != b[k][t]:
                return t
    return None


def wdl(run: dict) -> list:
    return [run["net_wins"], run["draws"], run["net_losses"]]


def compare_probe(a: dict, b: dict) -> dict:
    if (a["games"], a["seed"], a["rollouts"]) != (b["games"], b["seed"],
                                                  b["rollouts"]):
        raise ValueError("the traces played different games")
    parting, hist = [], {}
    same_actions = 0
    for i, (ga, gb) in enumerate(zip(a["trace"], b["trace"])):
        pick = first_difference(ga, gb, ("actions", "greedy", "sampled"))
        act = first_difference(ga, gb, ("actions",))
        same_actions += act is None
        if pick is None:
            continue
        net_turn = (pick % 2 == 0) == ga["net_first"]
        parting.append({"game": i, "ply": pick, "actions_ply": act,
                        "net_turn": net_turn,
                        "sampling": pick < a["temp_moves"],
                        "outcomes": [ga["outcome"], gb["outcome"]]})
        hist[pick] = hist.get(pick, 0) + 1
    score = {"win": 1.0, "draw": 0.5, "loss": 0.0}
    diff = sum(score[p["outcomes"][0]] - score[p["outcomes"][1]]
               for p in parting)
    changed = sum(p["outcomes"][0] != p["outcomes"][1] for p in parting)
    return {"kind": "probe", "wdl": [wdl(a), wdl(b)],
            "devices": [a["device"], b["device"]],
            "games": a["games"], "identical": a["games"] - len(parting),
            "same_actions": same_actions, "parting": len(parting),
            "outcome_changed": changed,
            "score_difference": diff,
            "spread": round(float(np.sqrt(changed)), 3),
            "first_ply_histogram": dict(sorted(hist.items())),
            "games_parting": parting}


def compare_selfplay(a: dict, b: dict) -> dict:
    ha, hb = (np.asarray(x["lanes"], dtype=np.int64) for x in (a, b))
    rounds = min(len(ha), len(hb))
    differ = (ha[:rounds] != hb[:rounds]).sum(1)
    first = int(np.flatnonzero(differ)[0]) if differ.any() else None
    return {"kind": "selfplay", "devices": [a["device"], b["device"]],
            "mean_length": [a["mean_length"], b["mean_length"]],
            "games_finished": [a["games_finished"], b["games_finished"]],
            "first_round_parting": first,
            "lanes_parted_by_round": differ.tolist()}


def compare(a: dict, b: dict) -> dict:
    if a["kind"] != b["kind"]:
        raise ValueError(f"a {a['kind']} trace against a {b['kind']} trace")
    return (compare_probe if a["kind"] == "probe" else compare_selfplay)(a, b)


def positions_at(game, run: dict, t: int, lanes, dev):
    """The positions of games ``lanes`` before ply ``t``, replayed from the
    trace's applied actions as ``ProbeRounds.apply`` played them."""
    G = len(lanes)
    pos = game.initial(G, dev)
    acts = [run["trace"][i]["actions"] for i in lanes]
    for k in range(t):
        alive = torch.tensor([k < len(x) for x in acts], device=dev)
        a = torch.tensor([x[k] if k < len(x) else 0 for x in acts],
                         dtype=torch.int32, device=dev)
        pos = where_games(alive, game.play(pos, a), pos)
    return pos


class Recorder:
    """A net that keeps every call's input and outputs."""

    def __init__(self, net):
        self.net, self.calls = net, []

    def __call__(self, x):
        logits, value = self.net(x)
        self.calls.append((x.clone(), logits.clone(), value.clone()))
        return logits, value

    def stacked(self, lanes):
        return [torch.stack([c[k][lanes] for c in self.calls]).cpu().numpy()
                for k in range(3)]


class Replay:
    """``net`` with the card net's recorded outputs on ``lanes``, call by
    call.  Per call it marks the lanes whose leaf input is not the one the
    card saw (``parted``) and keeps, where it is, the largest difference
    between ``net``'s own outputs and the card's (``diff``)."""

    def __init__(self, net, lanes, x, logits, value):
        self.net, self.lanes = net, torch.as_tensor(lanes)
        self.x, self.logits, self.value = (torch.from_numpy(v) for v in
                                           (x, logits, value))
        self.k, self.parted = 0, []
        self.diff = torch.zeros((2, len(self.lanes)))

    def __call__(self, x):
        k = self.k
        self.k += 1
        logits, value = self.net(x)
        mine = x[self.lanes]
        same = (mine == self.x[k]).reshape(len(mine), -1).all(1)
        self.parted.append(~same)
        diff = torch.stack([
            (logits[self.lanes] - self.logits[k]).abs().amax(1),
            (value[self.lanes] - self.value[k]).abs()])
        self.diff = torch.maximum(self.diff, torch.where(same, diff, 0.0))
        logits, value = logits.clone(), value.clone()
        logits[self.lanes], value[self.lanes] = self.logits[k], self.value[k]
        return logits, value


@contextlib.contextmanager
def plain_kernels():
    """The level-1 walk, the flush and the rules' end test run their plain
    versions, on whatever device their tensors are."""
    swaps = ((K, "select_apply_packed", K.select_apply_packed_plain),
             (K, "backup", K.backup_plain),
             (rules, "line_is_over", rules.line_is_over_plain))
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


TREE_FIELDS = ("parent", "action_from", "expanded", "next_idx", "prior",
               "wsum", "visits")


def search_ply(game, net, positions, probs, move, rollouts, cpuct):
    """``ProbeRounds.round`` on fresh planes: the search of every game and
    the net's (greedy, sampled) picks, with the root policy and tree."""
    tree = init_tree(game, positions, rollouts,
                     stat_dtype=stat_dtype_for(rollouts))
    _, pol = run_mcts(game, net, tree, rollouts=rollouts, cpuct=cpuct,
                      training=False, probs=probs)
    picks = torch.stack([torch.argmax(pol, dim=0).to(torch.int32),
                         cdf_sample(pol, move)])
    return picks, pol, tree


def lanes_differ(a, b) -> torch.Tensor:
    """bool[G]: lanes where the two searches' trees or policies differ."""
    bad = (a[1] != b[1]).any(0)
    for f in TREE_FIELDS:
        x, y = getattr(a[2], f), getattr(b[2], f)
        bad |= (x != y).reshape(-1, x.shape[-1]).any(0)
    return bad | (a[0] != b[0]).any(0)


def divergent_plies(cmp: dict) -> dict:
    """ply -> the games whose first pick, or first applied action, parts
    there."""
    plies = {}
    for p in cmp["games_parting"]:
        for t in {p["ply"], p["actions_ply"]} - {None}:
            plies.setdefault(t, []).append(p["game"])
    return dict(sorted(plies.items()))


def rerun(args) -> dict:
    dev = resolve_device(args.device)
    card, cpu = (json.load(open(p)) for p in (args.card, args.cpu))
    game = make_game(card["game"])
    net = load_net(game, args.ckpt, dev)
    R, G = card["rollouts"], card["games"]
    draws = PlyDraws(card["seed"], R, min(game.max_game_length, R), G)
    cmp = compare(card, cpu)
    plies, arrays = [], {}
    t0 = time.perf_counter()
    for t, games in divergent_plies(cmp).items():
        probs, move = (x.to(dev) for x in draws.draw(t))
        pos = positions_at(game, card, t, range(G), dev)
        rec = Recorder(net)
        kern = search_ply(game, rec, pos, probs, move, R, card["cpuct"])
        with plain_kernels():
            plain = search_ply(game, net, pos, probs, move, R, card["cpuct"])
        differ = lanes_differ(kern, plain).cpu().numpy()
        picks = kern[0].cpu().numpy()
        lanes = np.array(games)
        want = np.array([[card["trace"][i][k][t] if t < len(
            card["trace"][i][k]) else -1 for i in lanes]
            for k in ("greedy", "sampled")])
        plies.append({"ply": t, "games": games,
                      "reproduced": (picks[:, lanes] == want).all(0).tolist(),
                      "kernel_vs_plain_lanes": int(differ.sum()),
                      "kernel_vs_plain": differ[lanes].tolist(),
                      "card_picks": picks[:, lanes].tolist()})
        x, logits, value = rec.stacked(torch.from_numpy(lanes).to(dev))
        arrays.update({f"x{t}": x, f"logits{t}": logits, f"value{t}": value})
    np.savez_compressed(args.out + ".npz", **arrays)
    out = {"kind": "rerun", "ckpt": args.ckpt, "card_trace": args.card,
           "cpu_trace": args.cpu, "seconds": round(time.perf_counter() - t0,
                                                    3),
           **run_header(dev, card["seed"]), "plies": plies}
    return out


def classify(args) -> dict:
    """Each rerun lane searched on the CPU path at the trace's full batch,
    from the CPU trace's positions (equal to the card's at the lane's
    first divergence): fed the card net's recorded outputs on the rerun
    lanes, and with the CPU net alone, whose picks must be the CPU
    trace's (CPU matmuls round by batch size, so a lane is never searched
    alone)."""
    dev = torch.device("cpu")
    with open(args.rerun + ".json") as f:
        rr = json.load(f)
    card, cpu = (json.load(open(p)) for p in (rr["card_trace"], args.cpu))
    game = make_game(card["game"])
    net = load_net(game, args.ckpt, dev)
    R, G = card["rollouts"], card["games"]
    draws = PlyDraws(card["seed"], R, min(game.max_game_length, R), G)
    arrays = np.load(args.rerun + ".npz")
    lanes_out, classes = [], {}
    for ply in rr["plies"]:
        t, games = ply["ply"], ply["games"]
        probs, move = draws.draw(t)
        pos = positions_at(game, cpu, t, range(G), dev)
        replay = Replay(net, games, *(arrays[f"{k}{t}"] for k in (
            "x", "logits", "value")))
        fed = search_ply(game, replay, pos, probs, move, R, card["cpuct"])
        own = search_ply(game, net, pos, probs, move, R, card["cpuct"])
        parted = torch.stack(replay.parted).any(0)
        for j, g in enumerate(games):
            card_picks = [p[j] for p in ply["card_picks"]]
            want = [cpu["trace"][g][k][t] for k in ("greedy", "sampled")]
            same_fed = (fed[0][:, g].tolist() == card_picks
                        and not bool(parted[j]))
            own_ok = own[0][:, g].tolist() == want
            if ply["kernel_vs_plain"][j]:
                cls = "search: kernel against plain"
            elif not same_fed:
                cls = "search: the CPU path on the card net's outputs"
            elif not ply["reproduced"][j] or not own_ok:
                cls = "not reproduced"
            else:
                cls = "net rounding"
            classes[cls] = classes.get(cls, 0) + 1
            lanes_out.append({"game": g, "ply": t, "class": cls,
                              "card_picks": card_picks,
                              "cpu_picks": own[0][:, g].tolist(),
                              "cpu_trace_picks": want,
                              "logit_max_abs_diff": float(replay.diff[0, j]),
                              "value_max_abs_diff": float(replay.diff[1, j])})
    return {"kind": "classes", "rerun": args.rerun, "classes": classes,
            "logit_max_abs_diff": max((x["logit_max_abs_diff"]
                                       for x in lanes_out), default=0.0),
            "value_max_abs_diff": max((x["value_max_abs_diff"]
                                       for x in lanes_out), default=0.0),
            "lanes": lanes_out}


def lane_hashes(pos) -> list:
    """One crc32 per lane over its boards and player."""
    cols = [x.reshape(x.shape[0], -1).cpu().numpy() for x in
            (pos.bplayer, pos.bopponent, pos.player)]
    return [zlib.crc32(b"".join(c[i].tobytes() for c in cols))
            for i in range(cols[0].shape[0])]


def selfplay(args) -> dict:
    """``--rounds`` continuous-selfplay rounds on ``--games`` lanes, one
    call a round, round r's uniforms from ``default_rng([seed, r])``; the
    positions' hashes after every round and the finished games' mean
    length."""
    dev = resolve_device(args.device)
    game = make_game(args.game)
    net = load_net(game, args.ckpt, dev)
    G, R = args.games, args.rollout
    D = min(game.max_game_length, R)
    cfg = SelfplayConfig(num_games=G, rollouts=R, continuous=True,
                         rounds=1)
    buffer = create_buffer(game, G * args.rounds, dev)
    carry = make_carry(game, G, None, dev)
    lanes, finished, length, illegal = [], 0, 0.0, 0
    t0 = time.perf_counter()
    for r in range(args.rounds):
        uniforms = PlyDraws(args.seed, R, D, G, offset=r).uniforms()
        buffer, stats, carry = selfplay_continuous(
            game, net, buffer, None, cfg, carry, uniforms)
        n = int(stats["games_finished"])
        finished += n
        length += float(stats["mean_length"]) * n
        illegal += int(stats["illegal_moves"])
        lanes.append(lane_hashes(carry.positions))
    return {"kind": "selfplay", "game": game.name, "ckpt": args.ckpt,
            "games": G, "rollouts": R, "rounds": args.rounds,
            "cpuct": cfg.cpuct, "temp_moves": cfg.temp_moves,
            "captured": dev.type == "cuda", "games_finished": finished,
            "mean_length": length / finished if finished else None,
            "illegal_moves": illegal,
            "seconds": round(time.perf_counter() - t0, 3),
            **run_header(dev, args.seed), "lanes": lanes}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="alphatpu_torch.benchmarks.probe_pair",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("play", "selfplay"):
        p = sub.add_parser(mode)
        p.add_argument("--game", required=True)
        p.add_argument("--ckpt", required=True, help="net<N>.npz (best net)")
        p.add_argument("--games", type=int, default=256)
        p.add_argument("--rollout", type=int, default=64)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda")
        p.add_argument("--out", required=True)
    play_p, sp_p = sub.choices["play"], sub.choices["selfplay"]
    play_p.add_argument("--eager", action="store_true",
                        help="run the card's steps eagerly")
    play_p.add_argument("--depth", type=int, default=None)
    play_p.add_argument("--workers", type=int, default=1,
                        help="processes that move for the probe")
    sp_p.add_argument("--rounds", type=int, default=169)
    p = sub.add_parser("compare")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--out", default=None)
    p = sub.add_parser("rerun")
    for k in ("--ckpt", "--card", "--cpu", "--out"):
        p.add_argument(k, required=True)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("classify")
    for k in ("--ckpt", "--rerun", "--cpu", "--out"):
        p.add_argument(k, required=True)
    args = ap.parse_args(argv)

    if args.mode == "compare":
        a, b = (json.load(open(p)) for p in (args.a, args.b))
        out = compare(a, b)
    else:
        out = {"play": play, "selfplay": selfplay, "rerun": rerun,
               "classify": classify}[args.mode](args)
    if args.out:
        path = args.out + ".json" if args.mode == "rerun" else args.out
        with open(path, "w") as f:
            json.dump(out, f)
    summary = {k: v for k, v in out.items()
               if k not in ("trace", "lanes", "games_parting", "plies",
                            "lanes_parted_by_round")}
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    main()
