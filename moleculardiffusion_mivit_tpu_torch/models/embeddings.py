"""Frame embeddings: linear projection, single convolution, deep ResNet.

Port of ``moleculardiffusion_mivit_tpu/models/embeddings.py``.
``LinearProjectionEmbedding`` flattens each S×S frame into a Dense layer;
``CNNEmbedding`` is one S×S VALID convolution (with bias) per frame.
``DeepResNetEmbedding`` and ``ResidualBlock``: Conv3x3(1→32)+BN+ReLU
→ ResidualBlock(32→64) → ResidualBlock(64→128) → global average pool →
Dense(128→E), frames folded into the batch so BatchNorm statistics span
batch·frames. In train mode the whole embedding runs through
``ops.fused_embedding.fused_deep_resnet_embed`` (kernels K2/K3 on CUDA, the
plain version on CPU), and the running statistics are updated by hand the
way flax does: momentum 0.9 on the old value, with the *biased* batch
variance (torch's own BatchNorm would use the unbiased one). Eval mode uses
the running statistics through plain convolutions, as the JAX package does;
on a CUDA device they run in full f32 whatever the caller has set in
``torch.backends.cudnn.allow_tf32`` (``ops.fused_embedding.f32_convolutions``),
so validation scores do not depend on that global.

``BatchNorm`` also normalises with batch statistics in train mode, for the
modules that do not run through K2/K3 (``models/resnet.py``).

On a mesh, a training step whose minibatch is split over ranks
(``parallel.collectives.sharded_rows``) makes the statistics global:
``BatchNorm`` sums (Σx, Σx², count) over the ranks before it normalises,
and ``DeepResNetEmbedding`` runs K2/K3 on the gathered rows of the
minibatch and keeps its own rows' embedding (``parallel.collectives``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import (
    BN_EPS,
    BN_LAYOUT,
    f32_convolutions,
    fused_deep_resnet_embed,
)
from moleculardiffusion_mivit_tpu_torch.parallel.collectives import all_reduce_sum, current_rows, gather_rows

BN_MOMENTUM = 0.9  # flax convention: weight of the old running value


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis 1 with flax's semantics. Eval mode
    applies the running statistics. Train mode normalises with the batch's
    mean and *biased* variance over every other axis (flax's fast variance,
    ``mean(x²) - mean(x)²`` clipped at 0) and moves the running statistics
    towards them with ``update_running``. ``DeepResNetEmbedding``'s fused
    training path does not come through ``forward``: K2 returns the batch
    statistics and the embedding calls ``update_running`` itself."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        """A bf16 ``x`` (with bf16 weight and bias, ``compute_dtype``) is
        normalised in f32, as flax does: statistics, running buffers and the
        affine map in f32, the result rounded to bf16."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            rows = current_rows()
            if rows is None:
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            else:  # the minibatch is split over ranks: sums over all of them
                count = xf.new_full((xf.shape[1],), float(xf.numel() // xf.shape[1]))
                sums = all_reduce_sum(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes), count]), rows.group)
                mean = sums[0] / sums[2]
                var = torch.clamp(sums[1] / sums[2] - mean * mean, min=0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight.float()
        return ((xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)).to(x.dtype)

    @torch.no_grad()
    def update_running(self, batch_mean, batch_var):
        self.running_mean.mul_(BN_MOMENTUM).add_(batch_mean, alpha=1 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(batch_var, alpha=1 - BN_MOMENTUM)


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


class ResidualBlock(nn.Module):
    """conv3x3+BN+ReLU → conv3x3+BN, plus a 1x1 conv+BN skip when the width
    changes, ReLU after the sum (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.has_skip = in_channels != out_channels
        if self.has_skip:
            self.skip_conv = _conv(in_channels, out_channels, 1)
            self.skip_bn = BatchNorm(out_channels)
        self.conv1 = _conv(in_channels, out_channels, 3)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = _conv(out_channels, out_channels, 3)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x):
        identity = self.skip_bn(self.skip_conv(x)) if self.has_skip else x
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class LinearProjectionEmbedding(nn.Module):
    """Each S×S frame flattened row-major → Dense(S², E)."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(patch_size * patch_size, embed_dim)

    def forward(self, x):
        if x.ndim == 3:  # unbatched (T, S, S)
            x = x[None]
        b, t, h, w = x.shape
        return self.proj(x.reshape(b, t, h * w))


class CNNEmbedding(nn.Module):
    """One Conv(1→E, kernel S×S, no padding, with bias) per frame; frames
    folded into the batch. On a CUDA device the convolution runs in full f32
    (``f32_convolutions``)."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(1, embed_dim, patch_size, bias=True)

    def forward(self, x):
        b, t, h, w = x.shape
        with f32_convolutions():
            y = self.conv(x.reshape(b * t, 1, h, w))
        return y.reshape(b, t, self.conv.out_channels)


class DeepResNetEmbedding(nn.Module):
    def __init__(self, patch_size: int = 7, embed_dim: int = 128):
        super().__init__()
        self.patch_size = patch_size  # unused; kept for signature parity
        self.initial_conv = _conv(1, 32, 3)
        self.bn1 = BatchNorm(32)
        self.res_block1 = ResidualBlock(32, 64)
        self.res_block2 = ResidualBlock(64, 128)
        self.fc = nn.Linear(128, embed_dim)

    def _bns(self):
        r1, r2 = self.res_block1, self.res_block2
        mods = (self.bn1, r1.bn1, r1.bn2, r1.skip_bn, r2.bn1, r2.bn2, r2.skip_bn)
        return {name: m for (name, _), m in zip(BN_LAYOUT, mods)}

    def forward(self, x):
        b, t, h, w = x.shape
        if not self.training:
            with f32_convolutions():
                y = F.relu(self.bn1(self.initial_conv(x.reshape(b * t, 1, h, w))))
                y = self.res_block2(self.res_block1(y))
            return self.fc(y.mean(dim=(2, 3)).reshape(b, t, 128))
        r1, r2 = self.res_block1, self.res_block2
        kernels = {
            "initial": _hwio(self.initial_conv),
            "rb1_conv1": _hwio(r1.conv1), "rb1_conv2": _hwio(r1.conv2), "rb1_skip": _hwio(r1.skip_conv),
            "rb2_conv1": _hwio(r2.conv1), "rb2_conv2": _hwio(r2.conv2), "rb2_skip": _hwio(r2.skip_conv),
        }
        bns = self._bns()
        rows = current_rows()
        if rows is not None:  # the minibatch is split over ranks: K2/K3 see all its rows
            x = gather_rows(x, rows)
        emb, stats = fused_deep_resnet_embed(
            x,
            kernels,
            {k: m.weight for k, m in bns.items()},
            {k: m.bias for k, m in bns.items()},
            self.fc.weight.t(),
            self.fc.bias,
        )
        for name, m in bns.items():
            m.update_running(*stats[name])
        return emb if rows is None else emb[rows.lo:rows.hi]


EMBEDDING_REGISTRY = {
    "linear": LinearProjectionEmbedding,
    "cnn": CNNEmbedding,
    "deep_resnet": DeepResNetEmbedding,
}
