"""Transformer building blocks.

Port of ``moleculardiffusion_mivit_tpu/models/layers.py``. Module and
parameter names follow the flax tree (``q_proj``, ``layer_0``, ``norm1``…),
so ``utils.convert.torch_state_from_flax`` maps a flax checkpoint onto these
modules by name. Post-norm encoder layers, LayerNorm eps 1e-5, attention
written out (no fused attention operator): sequences are at most 61 tokens.

Dropout is ``models.dropout.KeyedDropout``, flax's formula with a mask keyed
by the training step. Each application has its own site: encoder layer
``i`` the four ``SITES_PER_LAYER · i + k`` (attention weights, the attention
residual, the FF hidden layer, the FF residual), the head ``HEAD_SITE``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from moleculardiffusion_mivit_tpu_torch.models.dropout import KeyedDropout

MAX_TOKENS = 128
LN_EPS = 1e-5
SITES_PER_LAYER = 4
HEAD_SITE = 2047  # the last site below models.dropout.MAX_SITES


def activation_by_name(name) -> Callable[[torch.Tensor], torch.Tensor]:
    table = {
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
        "tanh": torch.tanh,
    }
    if callable(name):
        return name
    if name not in table:
        raise ValueError(f"Unknown activation {name!r}; expected one of {list(table)}")
    return table[name]


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, site: int = 0):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = KeyedDropout(dropout, site)

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        h, hd = self.num_heads, self.embed_dim // self.num_heads

        def heads(v):
            return v.reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask == 0, torch.full_like(scores, -1e9), scores)
        scores = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        attn = self.dropout(scores / scores.sum(dim=-1, keepdim=True))
        ctx = (attn @ v).transpose(1, 2).reshape(b, t, self.embed_dim)
        return self.out_proj(ctx)


class FeedForward(nn.Module):
    def __init__(self, embed_dim: int, hidden_dim: int, activation: str = "relu", dropout: float = 0.0,
                 site: int = 0):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, embed_dim)
        self.act = activation_by_name(activation)
        self.dropout = KeyedDropout(dropout, site)

    def forward(self, x, act_slope=None):
        """``act_slope``, a float or a 0-d tensor, replaces the activation by
        a leaky ReLU of that slope (relu is slope 0, the reference's
        leaky_relu 0.01), as the JAX package's stacked training passes it;
        a tensor lets a captured CUDA graph carry it. The forward equals
        relu/leaky_relu (at bf16 too: the product is taken in f32 and
        rounded once, as ``leaky_relu`` does); the gradient differs only at
        inputs of exactly 0."""
        h = self.fc1(x)
        h = self.act(h) if act_slope is None else torch.where(h >= 0, h, (act_slope * h.float()).to(h.dtype))
        return self.fc2(self.dropout(h))


class TransformerEncoderLayerWithSkip(nn.Module):
    """Post-norm: ``x + drop(MHA) → LN → x + drop(FF) → LN``."""

    def __init__(self, embed_dim, num_heads, hidden_dim, activation="relu", dropout=0.0, index=0):
        super().__init__()
        site = SITES_PER_LAYER * index
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout, site)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.feed_forward = FeedForward(embed_dim, hidden_dim, activation, dropout, site + 2)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.dropout = KeyedDropout(dropout, site + 1)
        self.dropout_ff = KeyedDropout(dropout, site + 3)

    def forward(self, x, mask=None, act_slope=None):
        x = self.norm1(x + self.dropout(self.self_attn(x, mask)))
        return self.norm2(x + self.dropout_ff(self.feed_forward(x, act_slope)))


class Transformer(nn.Module):
    """Post-norm encoder stack with optional learned positional embedding."""

    def __init__(
        self, embed_dim, num_heads, hidden_dim, num_layers, dropout=0.0,
        use_pos_encoding=False, activation="relu", max_tokens=MAX_TOKENS,
    ):
        super().__init__()
        self.num_layers = num_layers
        if use_pos_encoding:
            self.pos_embedding = nn.Parameter(torch.zeros(1, max_tokens, embed_dim))
        else:
            self.pos_embedding = None
        for i in range(num_layers):
            self.add_module(
                f"layer_{i}",
                TransformerEncoderLayerWithSkip(embed_dim, num_heads, hidden_dim, activation, dropout, i),
            )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x, act_slope=None):
        if self.pos_embedding is not None:
            x = x + self.pos_embedding[:, : x.shape[1], :]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, act_slope=act_slope)
        return self.norm(x)


class MLPHead(nn.Module):
    """Two-layer regression head. ``in_dim`` is explicit (flax infers it)."""

    def __init__(self, in_dim: int, hidden_dim: int = 128, output_dim: int = 1, dropout: float = 0.0, activation: str = "relu"):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)
        self.act = activation_by_name(activation)
        self.dropout = KeyedDropout(dropout, HEAD_SITE)

    def forward(self, x):
        return self.fc2(self.dropout(self.act(self.fc1(x))))
