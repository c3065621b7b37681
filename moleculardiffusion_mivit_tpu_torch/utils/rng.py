"""Seeded ``torch.Generator``s: the port's counterpart of JAX's key
``fold_in``. Each (seed, key, ...) tuple names one independent stream."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``keys`` mixed by
    numpy's ``SeedSequence`` (nearby keys give unrelated streams).
    ``SeedSequence`` pads keys shorter than its pool of four 32-bit words
    with zeros, so trailing zero keys within those words name the same
    stream: ``fold_in(g, k)`` is ``fold_in(g, k, 0)`` (a seed takes two
    words). A function that draws from ``(k)`` takes no ``(k, 0)``."""
    seed = int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)


def fold_in(generator: torch.Generator, *keys: int, device=None) -> torch.Generator:
    """The generator of the stream named by ``generator``'s seed and
    ``keys``, on ``device`` (default: the generator's): the counterpart of
    ``jax.random.fold_in``. It reads the seed and not the state, so a
    generator names a key here, and drawing from it does not change what
    this returns."""
    return seeded_generator(device or generator.device, generator.initial_seed(), *keys)


# The key that names a generator's dropout stream beside its draws (ASCII
# "DROP"): no other ``fold_in`` of a cycle uses it.
DROPOUT_STREAM = 0x4452_4F50


def dropout_key(generator: torch.Generator) -> int:
    """The dropout key (a 63-bit integer) that goes with ``generator``'s
    draws, the counterpart of the ``k_drop`` that the JAX package splits
    beside ``k_perm``: the seed of the stream ``(generator's seed,
    DROPOUT_STREAM)``. ``models.dropout`` folds in each step's ``idx[0]``."""
    return seeded_generator("cpu", generator.initial_seed(), DROPOUT_STREAM).initial_seed()
