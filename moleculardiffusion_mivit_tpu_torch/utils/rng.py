"""Seeded ``torch.Generator``s: the port's counterpart of JAX's key
``fold_in``. Each (seed, key, ...) tuple names one independent stream."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``keys`` mixed by
    numpy's ``SeedSequence`` (nearby keys give unrelated streams)."""
    seed = int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & 0x7FFF_FFFF_FFFF_FFFF)
