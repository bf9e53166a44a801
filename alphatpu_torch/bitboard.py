"""Packed-word bitboards as batched torch functions.

Counterpart of :mod:`alphatpu.bitboard`.  A board is a little-endian vector
of 32-bit words over the trailing axis, cell ``(r, c)`` (0-based) at bit
``r + rows * c`` - the same words and the same numbering as the reference,
so ``encode`` and ``final_feature`` match it bit for bit.

Torch on the CPU cannot shift ``uint32`` tensors and has no popcount op, so
each word lives in an ``int64`` element holding a value in ``[0, 2**32)``:
every left shift is masked back to 32 bits and :func:`popcount` is a SWAR
bit count.  Constant masks are built once per (spec, device).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1
WORD_DTYPE = torch.int64


@dataclasses.dataclass(frozen=True)
class BoardSpec:
    """Static geometry of a packed bitboard (rows x cols, column-major)."""

    rows: int
    cols: int

    @property
    def nbits(self) -> int:
        return self.rows * self.cols

    @property
    def nwords(self) -> int:
        return -(-self.nbits // WORD_BITS)

    def mask_from_bits(self, bit_predicate) -> np.ndarray:
        m = np.zeros(self.nwords, dtype=np.int64)
        for i in range(self.nbits):
            if bit_predicate(i):
                m[i // WORD_BITS] |= 1 << (i % WORD_BITS)
        return m

    @property
    def valid_mask(self) -> np.ndarray:
        return self.mask_from_bits(lambda i: True)

    @property
    def not_first_row_mask(self) -> np.ndarray:
        return self.mask_from_bits(lambda i: i % self.rows != 0)

    @property
    def not_last_row_mask(self) -> np.ndarray:
        return self.mask_from_bits(lambda i: i % self.rows != self.rows - 1)


@functools.lru_cache(maxsize=None)
def _const(spec: BoardSpec, name: str, device: torch.device) -> torch.Tensor:
    """Constant tensors of a spec, built once per device."""
    if name == "word_index":
        arr = np.arange(spec.nbits) // WORD_BITS
    elif name == "bit_index":
        arr = np.arange(spec.nbits) % WORD_BITS
    else:
        arr = getattr(spec, name)
    return torch.as_tensor(arr, dtype=torch.int64, device=device)


def empty(spec: BoardSpec, batch=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch) + (spec.nwords,), dtype=WORD_DTYPE,
                       device=device)


def _shift(spec: BoardSpec, b: torch.Tensor, n: int, up: bool) -> torch.Tensor:
    """Move every bit index by ``n`` (up: toward higher bits)."""
    ws, bs = divmod(n, WORD_BITS)
    words = []
    for w in range(spec.nwords):
        parts = []
        if up:
            if 0 <= w - ws < spec.nwords:
                parts.append((b[..., w - ws] << bs) & WORD_MASK)
            if bs > 0 and 0 <= w - ws - 1 < spec.nwords:
                parts.append(b[..., w - ws - 1] >> (WORD_BITS - bs))
        else:
            if 0 <= w + ws < spec.nwords:
                parts.append(b[..., w + ws] >> bs)
            if bs > 0 and 0 <= w + ws + 1 < spec.nwords:
                parts.append((b[..., w + ws + 1] << (WORD_BITS - bs))
                             & WORD_MASK)
        acc = torch.zeros_like(b[..., 0])
        for p in parts:
            acc = acc | p
        words.append(acc)
    return torch.stack(words, dim=-1) & _const(spec, "valid_mask", b.device)


def shift_up_bits(spec: BoardSpec, b: torch.Tensor, n: int) -> torch.Tensor:
    """Shift every bit index up by static ``n``."""
    return _shift(spec, b, n, up=True)


def shift_down_bits(spec: BoardSpec, b: torch.Tensor, n: int) -> torch.Tensor:
    """Shift every bit index down by static ``n``."""
    return _shift(spec, b, n, up=False)


def right(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Move every stone one column right."""
    return shift_up_bits(spec, b, spec.rows)


def left(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Move every stone one column left."""
    return shift_down_bits(spec, b, spec.rows)


def down(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Move one row down (toward higher row index), clearing wrapped row 0."""
    return (shift_up_bits(spec, b, 1)
            & _const(spec, "not_first_row_mask", b.device))


def up(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Move one row up, clearing the wrapped last row."""
    return (shift_down_bits(spec, b, 1)
            & _const(spec, "not_last_row_mask", b.device))


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word bit count of 32-bit values held in int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD_MASK) >> 24


def popcount(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Number of set cells, int32 over the leading axes."""
    return popcount_words(b).sum(-1).to(torch.int32)


def invert(spec: BoardSpec, b: torch.Tensor) -> torch.Tensor:
    """Complement within the valid cell region."""
    return (~b) & _const(spec, "valid_mask", b.device)


def get_bit(spec: BoardSpec, b: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Read cell ``i`` (an index per leading batch element); bool."""
    i = torch.as_tensor(i, dtype=torch.int64, device=b.device)
    word = torch.gather(b, -1, (i // WORD_BITS).unsqueeze(-1)).squeeze(-1)
    return ((word >> (i % WORD_BITS)) & 1) != 0


def set_bit(spec: BoardSpec, b: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """A copy of ``b`` with cell ``i`` set.  An index outside the board's
    words (e.g. -1) sets nothing, as in the reference."""
    i = torch.as_tensor(i, dtype=torch.int64, device=b.device)
    w = torch.div(i, WORD_BITS, rounding_mode="floor")
    bit = torch.remainder(i, WORD_BITS)
    words = torch.arange(spec.nwords, device=b.device)
    onehot = torch.where(words == w.unsqueeze(-1),
                         torch.bitwise_left_shift(1, bit).unsqueeze(-1), 0)
    return b | onehot


def cell_onehot(spec: BoardSpec, i: torch.Tensor) -> torch.Tensor:
    """Boards with only cell ``i`` set, one per element of ``i``."""
    i = torch.as_tensor(i, dtype=torch.int64)
    return set_bit(spec, empty(spec, i.shape, i.device), i)


def to_planes(spec: BoardSpec, b: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """Unpack to a dense 0/1 vector over cells (the net's one-hot input)."""
    gathered = b[..., _const(spec, "word_index", b.device)]
    return ((gathered >> _const(spec, "bit_index", b.device)) & 1).to(dtype)


def from_planes(spec: BoardSpec, planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_planes` (test/debug helper)."""
    bits = ((planes != 0).to(torch.int64)
            << _const(spec, "bit_index", planes.device))
    widx = _const(spec, "word_index", planes.device)
    return torch.stack(
        [torch.where(widx == w, bits, 0).sum(-1) for w in range(spec.nwords)],
        dim=-1)


def from_coords(spec: BoardSpec, coords) -> np.ndarray:
    """Host-side helper: board words from (row, col) 0-based pairs."""
    m = np.zeros(spec.nwords, dtype=np.int64)
    for r, c in coords:
        i = r + spec.rows * c
        m[i // WORD_BITS] |= 1 << (i % WORD_BITS)
    return m
