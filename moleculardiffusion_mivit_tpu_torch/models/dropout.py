"""Dropout keyed by counters, as the JAX package keys flax's ``Dropout``.

flax's ``Dropout`` keeps an element with probability ``keep = 1 - rate`` and
returns ``select(mask, x / keep, 0)`` in ``x``'s dtype (``keep`` rounded to
that dtype first, as a weak-typed Python float is). ``KeyedDropout`` computes
the same formula. Its mask is a function of four integers and nothing else:

- the step's key: the cycle's dropout key (``utils.rng.dropout_key``, one
  per model and cycle, from a stream no other draw of the cycle uses)
  folded with the minibatch's first index ``idx[0]``, as the JAX package
  folds ``idx[0]`` into ``k_drop`` (``step_key``);
- the site: which dropout of the model (``models.layers`` numbers them);
- the element's *global* row in the minibatch (``lo`` of the rank's
  ``parallel.collectives.current_rows`` plus its local row);
- the element's position within its row.

A counter-based mask needs no generator state, so

- a captured CUDA graph draws a new mask at each replay: the cycle's key
  sits in a static device buffer and ``idx[0]`` comes from the permutation
  buffer;
- each member of a ``torch.vmap``-ped grid hashes its own key (a batched
  value), whatever the grid's member count or the member's position in it;
- a rank that holds rows ``lo:hi`` of a minibatch draws those rows of the
  unsharded mask;
- the CPU and the card draw the same bits (integer arithmetic only).

The hash is ``lowbias32`` (C. Wellons' integer hash prospector) on 32-bit
words held in ``int64`` tensors: a product of a 32-bit word and a 32-bit
constant would leave the signed range, so each multiplication takes the
constant in 16-bit halves (``_mul32``) and every product stays below 2^49.
A step's key is two 32-bit words (``absorb``: for a fixed word, a bijection
of the state). Each site then hashes one word per row (the site above the
global row: ``site · 2^ROW_BITS + row``) with the key's second word, and
each element its position with its row's hash; the key's first word is
XORed onto the result. That is two hashes per element and row in plain
PyTorch operators, each a kernel of its own on the card (about 45 a site).
At ``rate == 0`` or in eval mode the module returns its input and launches
nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch.parallel.collectives import current_rows

M32 = 0xFFFF_FFFF
_C1, _C2 = 0x7FEB_352D, 0x846C_A68B  # lowbias32's multipliers
# a row's word: the site in the bits above ROW_BITS, the global row below
ROW_BITS = 20
MAX_SITES = 1 << (31 - ROW_BITS)

KeyState = Tuple[torch.Tensor, torch.Tensor]


def _mul32(x, c: int):
    """``(x · c) mod 2^32`` for words ``x`` in ``[0, 2^32)``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    """``lowbias32`` of the words ``x`` (a tensor of int64 or a Python int)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def absorb(state: KeyState, word) -> KeyState:
    """The two-word state ``(a, b)`` after taking in the 32-bit ``word``."""
    a = mix32(state[0] ^ word)
    return a, mix32(state[1] ^ a)


def step_key(key: torch.Tensor, first: torch.Tensor) -> KeyState:
    """A step's key: the cycle's ``key`` (int64, 63-bit values, any shape:
    one per grid member) folded with the minibatch's first index ``first``
    (the same shape)."""
    return absorb((key & M32, (key >> 32) & M32), first & M32)


def dropout_mask(state: KeyState, site: int, lo: int, shape: Sequence[int], keep: float) -> torch.Tensor:
    """The boolean keep-mask of ``shape`` (rows first) at ``site`` (below
    ``MAX_SITES``) for a step's key ``state``, this rank's rows starting at
    global row ``lo`` (below 2^ROW_BITS): element ``(r, j)`` (``j`` its
    position in the row) is kept where its hash, uniform on ``[0, 2^32)``,
    lies below ``keep · 2^32``."""
    if not 0 <= site < MAX_SITES or lo + shape[0] > 1 << ROW_BITS:
        raise ValueError(f"dropout site {site} or rows up to {lo + shape[0]} out of range")
    a, b = state
    rest = tuple(shape[1:])
    words = torch.arange(shape[0], device=a.device) + (site << ROW_BITS | lo)
    rows = mix32(b ^ words.reshape((shape[0],) + (1,) * len(rest)))
    count = 1
    for n in rest:
        count *= n
    pos = torch.arange(count, device=a.device).reshape((1,) + rest)
    return mix32(pos ^ rows) ^ a < int(keep * 2**32)


_KEY: contextvars.ContextVar[Optional[KeyState]] = contextvars.ContextVar("mivit_dropout_key", default=None)


@contextlib.contextmanager
def keyed_dropout(state: Optional[KeyState]) -> Iterator[None]:
    """Within the block the training forward of every ``KeyedDropout``
    draws from the step's key ``state`` (``step_key``); ``None``: no key."""
    token = _KEY.set(state)
    try:
        yield
    finally:
        _KEY.reset(token)


@functools.lru_cache(maxsize=None)
def scale_in(dtype: torch.dtype, keep: float) -> float:
    """``keep`` rounded to ``dtype``, as ``x / keep`` rounds a weak-typed
    Python float in JAX."""
    return float(torch.tensor(keep, dtype=dtype))


def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """flax's ``select(mask, x / keep, 0)`` in ``x``'s dtype."""
    return torch.where(mask, x / scale_in(x.dtype, keep), 0.0)


class KeyedDropout(nn.Module):
    """Dropout of rate ``p`` at ``site``, its mask from the step's key
    (``keyed_dropout``). Training with ``p > 0`` and no key raises, as flax
    raises without a ``dropout`` rng."""

    def __init__(self, p: float = 0.0, site: int = 0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {p}")
        if not 0 <= site < MAX_SITES:
            raise ValueError(f"dropout site {site} out of [0, {MAX_SITES})")
        self.p, self.site = float(p), int(site)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        state = _KEY.get()
        if state is None:
            raise RuntimeError("dropout > 0 in training draws from the step's key: run the model inside "
                               "train.loop's or train.grid's train_step, or models.dropout.keyed_dropout")
        rows = current_rows()
        keep = 1.0 - self.p
        return apply_keep_mask(x, dropout_mask(state, self.site, 0 if rows is None else rows.lo, x.shape, keep), keep)

    def extra_repr(self) -> str:
        return f"p={self.p}, site={self.site}"


def uses_dropout(model: nn.Module) -> bool:
    """Whether ``model`` holds a ``KeyedDropout`` of rate above 0."""
    return any(isinstance(m, KeyedDropout) and m.p > 0 for m in model.modules())


def key_tensor(keys, device) -> torch.Tensor:
    """Dropout keys (``utils.rng.dropout_key``: an int or a sequence of
    them) as an int64 tensor on ``device``."""
    return torch.tensor(keys, dtype=torch.int64, device=device)
