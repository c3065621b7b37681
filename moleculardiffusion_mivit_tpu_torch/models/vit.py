"""The MiViT GeneralTransformer regressor.

Port of ``GeneralTransformer`` from ``moleculardiffusion_mivit_tpu/models/vit.py``:
frame embedding → LayerNorm → [regression token] → post-norm Transformer →
token 0 / mean pooling / per-token → MLPHead. Global-feature fusion is
ROADMAP queue 1 item 10 and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.models.embeddings import EMBEDDING_REGISTRY
from moleculardiffusion_mivit_tpu_torch.models.layers import LN_EPS, MLPHead, Transformer


class GeneralTransformer(nn.Module):
    def __init__(
        self,
        config: ModelConfig,
        embedding: str = "deep_resnet",
        use_global_features: bool = False,
        fusion_type: str = "early",
        global_feature_dim: Optional[int] = None,
        head_hidden_dim: int = 128,
    ):
        super().__init__()
        if use_global_features:
            raise NotImplementedError(
                "GeneralTransformer: global-feature fusion is not ported yet "
                "(ROADMAP.md, queue 1, items 8 and 10)"
            )
        if embedding not in EMBEDDING_REGISTRY:
            raise ValueError(
                f"GeneralTransformer: unknown embedding {embedding!r}; expected one of "
                f"{sorted(EMBEDDING_REGISTRY)}"
            )
        self.config = config
        cfg = config
        self.embedding = EMBEDDING_REGISTRY[embedding](cfg.patch_size, cfg.embed_dim)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        if cfg.use_regression_token:
            self.reg_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.transformer = Transformer(
            cfg.embed_dim, cfg.num_heads, cfg.hidden_dim, cfg.num_layers, cfg.dropout,
            cfg.use_pos_encoding, cfg.activation, cfg.max_tokens,
        )
        self.mlp_head = MLPHead(cfg.embed_dim, head_hidden_dim)

    def forward(self, x, features=None, act_slope=None):
        """``act_slope`` (float or 0-d tensor) overrides the encoder's FF
        activation with a leaky ReLU of that slope (``models.layers.FeedForward``)."""
        if features is not None:
            raise NotImplementedError("GeneralTransformer: features are not ported yet")
        cfg = self.config
        x = self.norm(self.embedding(x))
        if cfg.use_regression_token:
            x = torch.cat([self.reg_token.expand(x.shape[0], 1, cfg.embed_dim), x], dim=1)
        x = self.transformer(x, act_slope=act_slope)
        if cfg.use_regression_token:
            out = x[:, 0, :]
        elif cfg.single_prediction:
            out = x.mean(dim=1)
        else:
            out = x
        return self.mlp_head(out)
