"""Interactive console play: human vs a trained network.

Counterpart of :mod:`alphatpu.interactive`.  Reference equivalent:
`testvsordi` in testHex.jl:20-69 / testgobang.jl / testrev6.jl /
testrev8.jl, which runs the CPU MCTS twin against a human.  By default the
batched engine runs with G=1 (``run_mcts`` at level 1, the same kernels as
selfplay; on the card each move replays one CUDA graph) on ``--device``
(default cuda; without a card it raises unless given ``--device cpu``);
``--cpu`` switches to the pure numpy single-game engine
(:mod:`alphatpu_torch.cpu_mcts`, the reference's fast_mcts.jl) on the
host.

Run:
    python -m alphatpu_torch.interactive --game connect4 \
        --ckpt Dataconnect4/net3.npz --readout 128 [--second]

Moves are entered as `a1`-style coordinates (column letter + 1-based row,
like the reference's move dictionaries, testrev6.jl:1-12) or as a raw
action index; `pass` plays the Reversi pass action.
"""
from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np
import torch

from . import graphs


def move_name(game, action: int) -> str:
    if game.name.startswith("reversi") and action == game.max_actions - 1:
        return "pass"
    if game.name.startswith("hex"):
        n = game.n
        x, y = action // n, action % n
        return f"{chr(ord('a') + x)}{y + 1}"
    rows = game.spec.rows
    r, c = action % rows, action // rows
    return f"{chr(ord('a') + c)}{r + 1}"


def parse_move(game, text: str) -> int | None:
    text = text.strip().lower()
    if not text:
        return None
    if text == "pass" and game.name.startswith("reversi"):
        return game.max_actions - 1
    if text.isdigit():
        return int(text)
    if len(text) >= 2 and text[0].isalpha():
        try:
            c = ord(text[0]) - ord("a")
            r = int(text[1:]) - 1
        except ValueError:
            return None
        if game.name.startswith("hex"):
            n = game.n
            if 0 <= c < n and 0 <= r < n:
                return c * n + r
            return None
        rows = game.spec.rows
        if 0 <= c < game.spec.cols and 0 <= r < rows:
            return c * rows + r
    return None


class MoveRounds(graphs.Rounds):
    """The interactive engine's program: one game's position and the
    session's node pool ``tree``; :meth:`round` searches the position
    and returns ``(argmax, pi [A])`` of the root policy."""

    def __init__(self, game, tree, rollouts: int, cpuct: float):
        super().__init__(tree.device)
        self.game, self.tree = game, tree
        self.rollouts, self.cpuct = rollouts, cpuct
        self.positions = game.initial(1, self.device)

    def round(self, net):
        from .mcts.search import run_mcts
        from .mcts.tree import reset_tree

        reset_tree(self.tree, self.positions)
        _, pol = run_mcts(self.game, net, self.tree, rollouts=self.rollouts,
                          cpuct=self.cpuct, training=False,
                          generator=self.generator)
        pi = pol[:, 0]  # root policy is [A, G] games-minor; G = 1 here
        return torch.argmax(pi), pi


def make_engine(game, net, rollouts: int, cpuct: float,
                captured: bool | None = None):
    """One-game move chooser (argmax of the root policy):
    ``choose(pos, generator) -> (action, pi [A])`` for a one-game position
    ``pos``, searched on its device.

    The node pool is allocated once per session (first call) and only
    ``reset_tree``-zeroed for each later move.  ``captured`` (default: on
    a CUDA device) replays each move's search from a CUDA graph
    (:class:`MoveRounds`, :mod:`alphatpu_torch.graphs`), as the reference
    jits ``choose_impl``; ``captured=False`` runs it eagerly.  A move
    waits for the device once, for the action."""
    from .mcts.search import engine_level
    from .mcts.tree import init_tree, stat_dtype_for

    pool = []

    def choose(pos, generator=None):
        dev = pos.player.device
        use = graphs.use_graphs(captured, dev)
        if not pool:
            stat_dtype = stat_dtype_for(rollouts)

            def make():
                return MoveRounds(game, init_tree(game, pos, rollouts,
                                                  stat_dtype=stat_dtype),
                                  rollouts, cpuct)

            key = ("move", game.name, rollouts, cpuct, stat_dtype,
                   engine_level(None, True, stat_dtype), dev)
            pool.append(graphs.rounds_for(key, (net,), make) if use
                        else make())
        st = pool[0]
        graphs.assign(st.positions, pos)
        with graphs.drawing(st, generator, use):
            action, pi = graphs.step(st, graphs.net_identity(net),
                                     partial(st.round, net), use)
        return int(action), pi.clone()

    return choose


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alphatpu_torch.interactive")
    p.add_argument("--game", default="connect4")
    p.add_argument("--ckpt", default=None, help="net<N>.npz checkpoint file")
    p.add_argument("--readout", type=int, default=128,
                   help="MCTS rollouts per engine move (testHex.jl readout)")
    p.add_argument("--cpuct", type=float, default=1.5)
    p.add_argument("--second", action="store_true",
                   help="let the engine move first")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--svg", default=None,
                   help="write the current board to this SVG file each ply "
                        "(the reference's Luxor renderer, testHex.jl:71-112)")
    p.add_argument("--cpu", action="store_true",
                   help="use the pure numpy single-game engine "
                        "(cpu_mcts.MctsContext, the reference's fast_mcts) "
                        "on the host instead of the batched engine at G=1")
    p.add_argument("--device", default="cuda",
                   help="the torch device the batched engine searches on: "
                        "cuda (default), cuda:<n> or cpu")
    args = p.parse_args(argv)

    from . import resolve_device
    from .games import make_game
    from .nets import MLP, config_for_game, params_from_jax, params_to_numpy

    dev = torch.device("cpu") if args.cpu else resolve_device(args.device)
    game = make_game(args.game)
    net_cfg = config_for_game(game, width=args.width, depth=args.depth)
    if args.ckpt:
        with np.load(args.ckpt) as z:
            net = params_from_jax(dict(z), net_cfg, device=dev,
                                  prefix="best/")
        print(f"loaded {args.ckpt}")
    else:
        net = MLP.from_seed(net_cfg, 0, device=dev)
        print("WARNING: no checkpoint given - playing with random weights")

    if args.cpu:
        from .cpu_mcts import MctsContext

        ctx = MctsContext(args.cpuct, game, params_to_numpy(net))
        V = game.vectorized_state
        rows = game.spec.rows

        def cpu_engine(pos):
            enc = game.encode(pos)[0].numpy()
            st = {
                "mover": enc[:V].reshape(-1, rows).T > 0,
                "other": enc[V:].reshape(-1, rows).T > 0,
                "player": int(pos.player[0]),
            }
            pi, v = ctx(st, args.readout)
            return int(np.argmax(pi)), pi
    else:
        engine = make_engine(game, net, args.readout, args.cpuct)
    generator = torch.Generator(device=dev).manual_seed(1)
    pos = game.initial(1, dev)
    human_turn = not args.second
    while True:
        print(f"\n{game.render(pos)}")
        if args.svg:
            from .render import save_board_svg

            save_board_svg(game, pos, args.svg)
        done, result = game.is_over(pos)
        if bool(done[0]):
            r = int(result[0])
            who = "draw" if r == 0 else ("you" if (r == 1) == (not args.second)
                                         else "engine")
            print(f"game over: {'draw' if r == 0 else who + ' wins'}")
            return 0
        legal = game.legal_mask(pos)[0].cpu().numpy()
        if human_turn:
            names = [move_name(game, a) for a in np.flatnonzero(legal)]
            move = None
            while move is None or not legal[move]:
                raw = input(f"your move ({' '.join(names[:20])}"
                            f"{' ...' if len(names) > 20 else ''}): ")
                if raw.strip() in ("q", "quit", "exit"):
                    return 0
                move = parse_move(game, raw)
                if move is not None and (move >= game.max_actions
                                         or not legal[move]):
                    print("illegal move")
                    move = None
        else:
            if args.cpu:
                move, pol = cpu_engine(pos)
            else:
                move, pol = engine(pos, generator)
            print(f"engine plays {move_name(game, move)} "
                  f"(pi={float(pol[move]):.2f})")
        pos = game.play(pos, torch.tensor([move], device=dev))
        human_turn = not human_turn


if __name__ == "__main__":
    sys.exit(main())
