"""flax → torch weight conversion.

The port's modules carry the flax tree's names (``embedding.res_block1.conv1``,
``transformer.layer_0.self_attn.q_proj``…), so the conversion is a walk of
the tree with one rule per leaf kind. It imports neither flax nor JAX: the
trees come in as nested dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _walk(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _walk(value, name + ".")
        else:
            yield name, np.asarray(value, dtype=np.float32)


def torch_state_from_flax(params: Mapping, batch_stats: Mapping | None = None) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from a flax ``params`` tree and
    its ``batch_stats``: Dense kernels ``(in, out)`` → Linear weights
    ``(out, in)``; conv kernels HWIO → OIHW; ``scale`` → ``weight``; BN
    ``mean``/``var`` → ``running_mean``/``running_var``; ``bias``,
    ``reg_token`` and ``pos_embedding`` as they are."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in _walk(params):
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[f"{module}.{leaf}" if module else leaf] = torch.tensor(v)
    for name, v in _walk(batch_stats or {}):
        module, _, leaf = name.rpartition(".")
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[f"{module}.{leaf}"] = torch.tensor(v)
    return out
