"""SVG board renderers - the graphical counterpart of the reference's
Luxor hexagon-grid drawing (`dr`, testHex.jl:71-112), dependency-free.

Counterpart of :mod:`alphatpu.render`, copied unchanged but for
``_planes``, which reads a one-game position of the port (leaves leading
with G = 1) through ``game.encode`` and copies it to the host.

``board_svg(game, pos)`` returns an SVG string for any game family:
* Hex: pointy-top hexagon grid, rows sheared right (the classic rhombus),
  first-player stones connect top-bottom,
* Gobang/TicTacToe: go-style grid with stones on intersections,
* Connect-4 / Reversi: cell grid with discs.

The interactive CLI can dump a board per ply via ``--svg``.
"""
from __future__ import annotations

import math

# stone colors: player to move's stones vs opponent's are resolved to
# absolute first/second player colors before drawing
_P1 = "#222222"
_P2 = "#f5f5f5"
_BOARD = "#deb887"
_LINE = "#555555"


def _planes(game, pos):
    """(first_player_plane, second_player_plane) as flat 0/1 arrays over the
    stored board cells (column-major like the reference's decoder) of a
    one-game position (leaves leading with G = 1), copied to the host."""
    enc = game.encode(pos)[0].cpu().numpy()
    vs = game.vectorized_state
    mover, other = enc[:vs], enc[vs:]
    player = int(pos.player[0])
    return (mover, other) if player == 1 else (other, mover)


def _svg(width, height, body):
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
        f'height="{height:.0f}" viewBox="0 0 {width:.0f} {height:.0f}">'
        f'<rect width="100%" height="100%" fill="{_BOARD}"/>' + body
        + "</svg>"
    )


def _hex_svg(game, pos):
    n = game.n
    m = n + 1  # stored board embeds a filled border (Hex.jl:22-33)
    first, second = _planes(game, pos)
    r = 16.0
    dx, dy = r * math.sqrt(3.0), r * 1.5
    pts = []
    for k in range(6):
        a = math.pi / 6 + k * math.pi / 3
        pts.append((r * math.cos(a), r * math.sin(a)))
    body = []
    for x in range(n):  # inner board coordinates
        for y in range(n):
            cell = (x + 1) * m + (y + 1)  # skip the border row/col
            cx = 30 + dx * y + dx / 2 * x
            cy = 30 + dy * x
            hexpts = " ".join(
                f"{cx + px:.1f},{cy + py:.1f}" for px, py in pts
            )
            body.append(
                f'<polygon points="{hexpts}" fill="#e8d3a9" '
                f'stroke="{_LINE}" stroke-width="1"/>'
            )
            if first[cell]:
                body.append(f'<circle cx="{cx:.1f}" cy="{cy:.1f}" '
                            f'r="{r * 0.62:.1f}" fill="{_P1}"/>')
            elif second[cell]:
                body.append(
                    f'<circle cx="{cx:.1f}" cy="{cy:.1f}" '
                    f'r="{r * 0.62:.1f}" fill="{_P2}" stroke="{_LINE}"/>'
                )
    w = 60 + dx * n + dx / 2 * (n - 1)
    h = 60 + dy * (n - 1)
    return _svg(w, h, "".join(body))


def _grid_svg(game, pos, stones_on_intersections: bool):
    rows, cols = game.spec.rows, game.spec.cols
    first, second = _planes(game, pos)
    s = 34.0
    pad = 30.0
    body = []
    if stones_on_intersections:  # go-style (Gobang/TicTacToe)
        for r in range(rows):
            y = pad + r * s
            body.append(f'<line x1="{pad}" y1="{y}" '
                        f'x2="{pad + (cols - 1) * s}" y2="{y}" '
                        f'stroke="{_LINE}"/>')
        for c in range(cols):
            x = pad + c * s
            body.append(f'<line x1="{x}" y1="{pad}" x2="{x}" '
                        f'y2="{pad + (rows - 1) * s}" stroke="{_LINE}"/>')
        w, h = 2 * pad + (cols - 1) * s, 2 * pad + (rows - 1) * s
        org = pad
    else:  # cell grid (Connect-4 / Reversi)
        for r in range(rows + 1):
            y = pad + r * s
            body.append(f'<line x1="{pad}" y1="{y}" x2="{pad + cols * s}" '
                        f'y2="{y}" stroke="{_LINE}"/>')
        for c in range(cols + 1):
            x = pad + c * s
            body.append(f'<line x1="{x}" y1="{pad}" x2="{x}" '
                        f'y2="{pad + rows * s}" stroke="{_LINE}"/>')
        w, h = 2 * pad + cols * s, 2 * pad + rows * s
        org = pad + s / 2
    # cells are stored column-major, row 0 at the bottom for Connect-4
    flip = game.name == "connect4"
    for c in range(cols):
        for r in range(rows):
            cell = c * rows + r
            rr = (rows - 1 - r) if flip else r
            cx, cy = org + c * s, org + rr * s
            if first[cell]:
                body.append(f'<circle cx="{cx}" cy="{cy}" r="{s * 0.4:.1f}" '
                            f'fill="{_P1}"/>')
            elif second[cell]:
                body.append(f'<circle cx="{cx}" cy="{cy}" r="{s * 0.4:.1f}" '
                            f'fill="{_P2}" stroke="{_LINE}"/>')
    return _svg(w, h, "".join(body))


def board_svg(game, pos) -> str:
    """SVG string for the position, dispatched by game family."""
    if game.name.startswith("hex"):
        return _hex_svg(game, pos)
    go_style = game.name == "tictactoe" or game.name.startswith("gobang")
    return _grid_svg(game, pos, stones_on_intersections=go_style)


def save_board_svg(game, pos, path: str) -> None:
    with open(path, "w") as f:
        f.write(board_svg(game, pos))
