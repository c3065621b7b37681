"""The MiViT GeneralTransformer regressor.

Port of ``GeneralTransformer`` from ``moleculardiffusion_mivit_tpu/models/vit.py``:
frame embedding → LayerNorm → [regression token (+ early fusion of the
global features through ``FeatureProjector``)] → post-norm Transformer →
token 0 / mean pooling / per-token → [late fusion: the projected features
concatenated] → MLPHead. Module names follow the flax tree
(``feature_projector.fc1``…) so ``utils.convert`` maps its weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.models.embeddings import EMBEDDING_REGISTRY
from moleculardiffusion_mivit_tpu_torch.models.layers import LN_EPS, MLPHead, Transformer


class FeatureProjector(nn.Module):
    """2-layer global-feature projector: Dense → ReLU → Dense."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, f):
        return self.fc2(torch.relu(self.fc1(f)))


class GeneralTransformer(nn.Module):
    """``use_global_features`` fuses a ``(B, global_feature_dim)`` feature
    vector: ``fusion_type="early"`` adds its projection to the regression
    token (without a regression token the features go unused, as in the
    JAX model), ``"late"`` concatenates it to the pooled output, so the
    head takes ``2·embed_dim``. ``flax`` infers the features' width; here
    ``global_feature_dim`` gives it."""

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
        if embedding not in EMBEDDING_REGISTRY:
            raise ValueError(
                f"GeneralTransformer: unknown embedding {embedding!r}; expected one of "
                f"{sorted(EMBEDDING_REGISTRY)}"
            )
        if use_global_features and fusion_type not in ("early", "late"):
            raise ValueError(f"GeneralTransformer: unknown fusion_type {fusion_type!r}; expected 'early' or 'late'")
        if use_global_features and global_feature_dim is None:
            raise ValueError("GeneralTransformer: use_global_features needs global_feature_dim")
        self.config = config
        self.use_global_features = use_global_features
        self.fusion_type = fusion_type
        self.global_feature_dim = global_feature_dim
        cfg = config
        self.early = use_global_features and fusion_type == "early" and cfg.use_regression_token
        self.late = use_global_features and fusion_type == "late"
        self.embedding = EMBEDDING_REGISTRY[embedding](cfg.patch_size, cfg.embed_dim)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        if cfg.use_regression_token:
            self.reg_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.transformer = Transformer(
            cfg.embed_dim, cfg.num_heads, cfg.hidden_dim, cfg.num_layers, cfg.dropout,
            cfg.use_pos_encoding, cfg.activation, cfg.max_tokens,
        )
        if self.early or self.late:
            self.feature_projector = FeatureProjector(global_feature_dim, cfg.embed_dim)
        self.mlp_head = MLPHead(2 * cfg.embed_dim if self.late else cfg.embed_dim, head_hidden_dim)

    def forward(self, x, features=None, act_slope=None):
        """``features (B, global_feature_dim)``: required with
        ``use_global_features``, ignored without. ``act_slope`` (float or 0-d
        tensor) overrides the encoder's FF activation with a leaky ReLU of
        that slope (``models.layers.FeedForward``)."""
        cfg = self.config
        if self.use_global_features and features is None:
            raise ValueError("Global features required when use_global_features=True")
        x = self.norm(self.embedding(x))
        if cfg.use_regression_token:
            reg = self.reg_token.expand(x.shape[0], 1, cfg.embed_dim)
            if self.early:
                reg = reg + self.feature_projector(features)[:, None, :]
            x = torch.cat([reg, x], dim=1)
        x = self.transformer(x, act_slope=act_slope)
        if cfg.use_regression_token:
            out = x[:, 0, :]
        elif cfg.single_prediction:
            out = x.mean(dim=1)
        else:
            out = x
        if self.late:
            out = torch.cat([out, self.feature_projector(features)], dim=-1)
        return self.mlp_head(out)
