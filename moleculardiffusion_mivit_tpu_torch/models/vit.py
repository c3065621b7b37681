"""The MiViT regressors: GeneralTransformer, ModularTransformer and
HybridFusionTransformer.

Port of ``moleculardiffusion_mivit_tpu/models/vit.py``. ``GeneralTransformer``:
frame embedding → LayerNorm → [regression token (+ early fusion of the
global features through ``FeatureProjector``)] → post-norm Transformer →
token 0 / mean pooling / per-token → [late fusion: the projected features
concatenated] → MLPHead. ``ModularTransformer`` embeds images, per-frame
feature tokens or both (fused by add, concat + projection, or the raw
features concatenated to a narrower image embedding);
``HybridFusionTransformer`` fuses per-frame tokens into the frame tokens
and the global features into the regression token. Module names follow the
flax tree (``feature_projector.fc1``, ``feature_fc1``, ``pf_ln``…) so
``utils.convert`` maps its weights. flax infers a Dense layer's input
width; here the features' widths are arguments.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.models.embeddings import EMBEDDING_REGISTRY
from moleculardiffusion_mivit_tpu_torch.models.layers import LN_EPS, MLPHead, Transformer, activation_by_name


class FeatureProjector(nn.Module):
    """2-layer global-feature projector: Dense → ReLU → Dense."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, f):
        return self.fc2(torch.relu(self.fc1(f)))


def _transformer(cfg: ModelConfig) -> Transformer:
    return Transformer(
        cfg.embed_dim, cfg.num_heads, cfg.hidden_dim, cfg.num_layers, cfg.dropout,
        cfg.use_pos_encoding, cfg.activation, cfg.max_tokens,
    )


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
        self.transformer = _transformer(cfg)
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


def _add_token_mlp(parent: nn.Module, prefix: str, in_dim: int, embed_dim: int) -> None:
    """Give ``parent`` the layers of a token MLP under the flax names
    ``<prefix>_fc1`` (Dense 2E), ``<prefix>_ln`` and ``<prefix>_fc2``
    (Dense E)."""
    setattr(parent, f"{prefix}_fc1", nn.Linear(in_dim, 2 * embed_dim))
    setattr(parent, f"{prefix}_ln", nn.LayerNorm(2 * embed_dim, eps=LN_EPS))
    setattr(parent, f"{prefix}_fc2", nn.Linear(2 * embed_dim, embed_dim))


def _token_mlp(parent: nn.Module, prefix: str, f: torch.Tensor) -> torch.Tensor:
    """Dense → LayerNorm → gelu (tanh approximation, flax's ``nn.gelu``) →
    Dense over the last axis, with ``parent``'s layers of ``prefix``."""
    y = getattr(parent, f"{prefix}_ln")(getattr(parent, f"{prefix}_fc1")(f))
    return getattr(parent, f"{prefix}_fc2")(activation_by_name("gelu")(y))


class ModularTransformer(nn.Module):
    """Images, per-frame features or both (``mode``: ``images_only``,
    ``features_only``, ``both``), each frame's feature vector embedded by
    one Dense (``feature_embedding_type="linear"``) or a 2-layer MLP
    (``"mlp"``), and in ``both`` fused with the image token by ``add``,
    ``concat_proj`` (concatenated, then a Dense back to ``embed_dim``) or
    ``concat_features`` (the image embedded into ``embed_dim −
    features_dim`` and the raw features concatenated). ``features_dim`` is
    required whenever the mode reads features. Called as ``model(images,
    features)``; ``features_only`` ignores the images."""

    def __init__(
        self,
        config: ModelConfig,
        mode: str = "images_only",
        image_embedding: str = "deep_resnet",
        features_dim: Optional[int] = None,
        feature_embedding_type: str = "linear",
        fusion_method: str = "add",
        head_hidden_dim: int = 128,
    ):
        super().__init__()
        if mode not in ("images_only", "features_only", "both"):
            raise ValueError("mode must be images_only, features_only or both")
        if image_embedding not in EMBEDDING_REGISTRY:
            raise ValueError(f"ModularTransformer: unknown embedding {image_embedding!r}; expected one of "
                             f"{sorted(EMBEDDING_REGISTRY)}")
        if feature_embedding_type not in ("linear", "mlp"):
            raise ValueError(f"Unknown feature_embedding_type {feature_embedding_type!r}")
        if mode == "both" and fusion_method not in ("add", "concat_proj", "concat_features"):
            raise ValueError(f"ModularTransformer: unknown fusion_method {fusion_method!r}; expected 'add', "
                             "'concat_proj' or 'concat_features'")
        if mode != "images_only" and features_dim is None:
            raise ValueError(f"ModularTransformer: mode {mode!r} needs features_dim")
        self.config, self.mode, self.fusion_method = config, mode, fusion_method
        self.feature_embedding_type = feature_embedding_type
        e = config.embed_dim
        image_embed_dim = e
        if mode == "both" and fusion_method == "concat_features":
            image_embed_dim = e - int(features_dim)
            if image_embed_dim <= 0:
                raise ValueError("embed_dim must exceed features_dim for concat_features")
        if mode != "features_only":
            self.image_embedding = EMBEDDING_REGISTRY[image_embedding](config.patch_size, image_embed_dim)
        if mode == "features_only" or (mode == "both" and fusion_method != "concat_features"):
            if feature_embedding_type == "linear":
                self.feature_embedding = nn.Linear(features_dim, e)
            else:
                _add_token_mlp(self, "feature", features_dim, e)
        if mode == "both" and fusion_method == "concat_proj":
            self.fusion_layer = nn.Linear(2 * e, e)
        self.norm = nn.LayerNorm(e, eps=LN_EPS)
        if config.use_regression_token:
            self.reg_token = nn.Parameter(torch.zeros(1, 1, e))
        self.transformer = _transformer(config)
        self.mlp_head = MLPHead(e, head_hidden_dim)

    def _feature_embed(self, f):
        if self.feature_embedding_type == "linear":
            return self.feature_embedding(f)
        return _token_mlp(self, "feature", f)

    def forward(self, images=None, features=None):
        cfg = self.config
        if self.mode != "features_only" and images is None:
            raise ValueError("images required")
        if self.mode != "images_only" and features is None:
            raise ValueError("features required")
        if features is not None:
            features = torch.nan_to_num(features, nan=0.0)
        if self.mode == "images_only":
            x = self.image_embedding(images)
        elif self.mode == "features_only":
            x = self._feature_embed(features)
        else:
            img = self.image_embedding(images)
            if self.fusion_method == "add":
                x = img + self._feature_embed(features)
            elif self.fusion_method == "concat_proj":
                x = self.fusion_layer(torch.cat([img, self._feature_embed(features)], dim=-1))
            else:
                x = torch.cat([img, features], dim=-1)
        x = self.norm(x)
        if cfg.use_regression_token:
            x = torch.cat([self.reg_token.expand(x.shape[0], 1, cfg.embed_dim), x], dim=1)
        x = self.transformer(x)
        if cfg.use_regression_token:
            out = x[:, 0, :]
        elif cfg.single_prediction:
            out = x.mean(dim=1)
        else:
            out = x
        return self.mlp_head(out)


class HybridFusionTransformer(nn.Module):
    """Per-frame feature tokens fused into the frame tokens (``add`` or
    ``concat_proj``, as ``ModularTransformer``'s mlp embedding) and the
    global features projected into the regression token (as
    ``GeneralTransformer``'s early fusion), in one model. The features come
    packed, ``(B, F·per_frame_dim + global_dim)``: the per-frame features
    flattened, the global ones after them, with ``F`` the images' frame
    count. ``single_prediction=False`` predicts from the frame tokens only."""

    def __init__(
        self,
        config: ModelConfig,
        image_embedding: str = "deep_resnet",
        per_frame_dim: int = 6,
        global_dim: int = 25,
        fusion_method: str = "concat_proj",
        head_hidden_dim: int = 128,
    ):
        super().__init__()
        if fusion_method not in ("add", "concat_proj"):
            raise ValueError(f"unknown fusion_method {fusion_method!r}")
        if image_embedding not in EMBEDDING_REGISTRY:
            raise ValueError(f"HybridFusionTransformer: unknown embedding {image_embedding!r}")
        self.config, self.fusion_method = config, fusion_method
        self.per_frame_dim, self.global_dim = per_frame_dim, global_dim
        e = config.embed_dim
        self.image_embedding = EMBEDDING_REGISTRY[image_embedding](config.patch_size, e)
        _add_token_mlp(self, "pf", per_frame_dim, e)
        if fusion_method == "concat_proj":
            self.fusion_layer = nn.Linear(2 * e, e)
        self.norm = nn.LayerNorm(e, eps=LN_EPS)
        self.reg_token = nn.Parameter(torch.zeros(1, 1, e))
        self.feature_projector = FeatureProjector(global_dim, e)
        self.transformer = _transformer(config)
        self.mlp_head = MLPHead(e, head_hidden_dim)

    def forward(self, images, features=None):
        cfg = self.config
        if features is None:
            raise ValueError("HybridFusionTransformer requires packed features")
        b, f = images.shape[0], images.shape[1]
        n_pf = f * self.per_frame_dim
        if features.shape[-1] != n_pf + self.global_dim:
            raise ValueError(f"packed features must be (B, {n_pf} + {self.global_dim}); got {tuple(features.shape)}")
        pf = torch.nan_to_num(features[:, :n_pf].reshape(b, f, self.per_frame_dim), nan=0.0)
        gf = torch.nan_to_num(features[:, n_pf:], nan=0.0)
        img = self.image_embedding(images)
        tokens = _token_mlp(self, "pf", pf)
        if self.fusion_method == "add":
            x = img + tokens
        else:
            x = self.fusion_layer(torch.cat([img, tokens], dim=-1))
        x = self.norm(x)
        reg = self.reg_token.expand(b, 1, cfg.embed_dim) + self.feature_projector(gf)[:, None, :]
        x = self.transformer(torch.cat([reg, x], dim=1))
        out = x[:, 0, :] if cfg.single_prediction else x[:, 1:, :]
        return self.mlp_head(out)
