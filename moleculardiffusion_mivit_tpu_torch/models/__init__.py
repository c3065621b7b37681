"""The MiViT model zoo on PyTorch (the deep-ResNet GeneralTransformer)."""

import math

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch.models.layers import (  # noqa: F401
    MAX_TOKENS,
    FeedForward,
    MLPHead,
    MultiHeadAttention,
    Transformer,
    TransformerEncoderLayerWithSkip,
    activation_by_name,
)
from moleculardiffusion_mivit_tpu_torch.models.embeddings import (  # noqa: F401
    EMBEDDING_REGISTRY,
    BatchNorm,
    DeepResNetEmbedding,
    ResidualBlock,
)
from moleculardiffusion_mivit_tpu_torch.models.vit import GeneralTransformer  # noqa: F401


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _draw(param: torch.Tensor, fill, generator: torch.Generator) -> None:
    """Fill ``param`` from ``generator`` (a CPU generator), wherever the
    parameter lives, so a seed gives the same weights on every device."""
    t = torch.empty(param.shape, dtype=param.dtype)
    fill(t, generator)
    param.copy_(t)


def _lecun_normal(fan_in: int):
    # flax lecun_normal: truncated normal at ±2σ, rescaled to variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return lambda t, g: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` in place with the flax initialisers the JAX
    package uses (lecun-normal kernels, Xavier-uniform attention projections,
    zero biases, unit-normal positional embedding and regression token,
    identity norms), drawing from the CPU ``generator``. Returns the model."""
    attention = set()
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            attention.update(id(lin) for lin in (m.q_proj, m.k_proj, m.v_proj, m.out_proj))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                fill = (lambda t, g: nn.init.xavier_uniform_(t, generator=g)) if id(m) in attention \
                    else _lecun_normal(m.in_features)
                _draw(m.weight, fill, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                _draw(m.weight, _lecun_normal(m.weight[0].numel()), generator)
            elif isinstance(m, (nn.LayerNorm, BatchNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        for name, p in model.named_parameters():
            if name.split(".")[-1] in ("pos_embedding", "reg_token"):
                _draw(p, lambda t, g: nn.init.normal_(t, generator=g), generator)
    return model
