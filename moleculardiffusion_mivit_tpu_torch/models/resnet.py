"""Light ResNet comparison arms.

Port of ``BasicBlock``, ``_ResNetTrunk``, ``LightResNet``,
``MultiImageResNet`` and ``MultiImageFeatureResNet`` from
``moleculardiffusion_mivit_tpu/models/resnet.py``, with the flax tree's child
names (``resnet.trunk.layer2_block0.shortcut_conv``…) so
``utils.convert.torch_state_from_flax`` maps a flax checkpoint by name:

- ``BasicBlock``: two 3×3 convs + BN, a 1×1 conv + BN shortcut when the
  stride or the width changes, activation after the residual add.
- ``_ResNetTrunk``: conv5×5 stride 2 pad 2 (1→32) + BN + act, max-pool 3×3
  stride 2 pad 1, stages 32, 64 (stride 2), 128 (stride 2) of one block
  each, global average pool, fc1 128→``feature_size`` + act. A 9×9 frame
  goes 5×5 → 3×3 → 3×3 → 2×2 → 1×1.
- ``LightResNet``: trunk → fc2.
- ``MultiImageResNet``: frames folded into the batch (so BatchNorm
  statistics span batch·frames), one prediction per frame, mean over frames
  when ``single_prediction``.
- ``MultiImageFeatureResNet``: the trunk's per-frame vectors averaged over
  time, concatenated with a global feature vector, then ``mlp_fc1`` →
  activation → ``mlp_fc2``.

Tensors are NCHW. BatchNorm is ``models.embeddings.BatchNorm`` (flax
semantics, batch statistics in train mode). On a CUDA device the
convolutions run in full f32 whatever ``torch.backends.cudnn.allow_tf32``
says (``ops.fused_embedding.f32_convolutions``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from moleculardiffusion_mivit_tpu_torch.models.embeddings import BatchNorm
from moleculardiffusion_mivit_tpu_torch.models.layers import activation_by_name
from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import f32_convolutions


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, activation: str = "relu"):
        super().__init__()
        self.act = activation_by_name(activation)
        self.has_shortcut = stride != 1 or in_channels != out_channels
        if self.has_shortcut:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
            self.shortcut_bn = BatchNorm(out_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x):
        identity = self.shortcut_bn(self.shortcut_conv(x)) if self.has_shortcut else x
        y = self.act(self.bn1(self.conv1(x)))
        return self.act(self.bn2(self.conv2(y)) + identity)


class _ResNetTrunk(nn.Module):
    """Stem + stages + global average pool + fc1: a ``feature_size``-d vector
    per image."""

    def __init__(self, feature_size: int = 64, activation: str = "relu", num_blocks=(1, 1, 1)):
        super().__init__()
        self.act = activation_by_name(activation)
        self.conv1 = nn.Conv2d(1, 32, 5, stride=2, padding=2, bias=False)
        self.bn1 = BatchNorm(32)
        self.block_names = []
        in_channels = 32
        for stage, (channels, stride) in enumerate([(32, 1), (64, 2), (128, 2)]):
            for block in range(num_blocks[stage]):
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(in_channels, channels, stride if block == 0 else 1, activation))
                self.block_names.append(name)
                in_channels = channels
        self.fc1 = nn.Linear(128, feature_size)

    def forward(self, x):
        y = self.act(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)  # pads with -inf, as flax's max_pool
        for name in self.block_names:
            y = getattr(self, name)(y)
        return self.act(self.fc1(y.mean(dim=(2, 3))))


class LightResNet(nn.Module):
    def __init__(self, num_classes: int = 1, feature_size: int = 64, activation: str = "relu"):
        super().__init__()
        self.trunk = _ResNetTrunk(feature_size, activation)
        self.fc2 = nn.Linear(feature_size, num_classes)

    def forward(self, x):
        return self.fc2(self.trunk(x))


class MultiImageResNet(nn.Module):
    """``(B, T, S, S)`` videos → ``(B, 1)`` (``single_prediction``) or
    ``(B, T, 1)`` predictions."""

    def __init__(self, single_prediction: bool = True, activation: str = "relu"):
        super().__init__()
        self.single_prediction = single_prediction
        self.resnet = LightResNet(1, 64, activation)

    def forward(self, x):
        b, t, h, w = x.shape
        with f32_convolutions():
            y = self.resnet(x.reshape(b * t, 1, h, w))
        y = y.reshape(b, t, 1)
        return y.mean(dim=1) if self.single_prediction else y


class MultiImageFeatureResNet(nn.Module):
    """``(B, T, S, S)`` videos and ``(B, external_dim)`` features →
    ``(B, 1)``."""

    def __init__(self, external_dim: int, feature_size: int = 64, hidden_size: int = 128, activation: str = "relu"):
        super().__init__()
        self.act = activation_by_name(activation)
        self.resnet = _ResNetTrunk(feature_size, activation)
        self.mlp_fc1 = nn.Linear(feature_size + external_dim, hidden_size)
        self.mlp_fc2 = nn.Linear(hidden_size, 1)

    def forward(self, x, external_features):
        b, t, h, w = x.shape
        with f32_convolutions():
            feats = self.resnet(x.reshape(b * t, 1, h, w))
        combined = torch.cat([feats.reshape(b, t, -1).mean(dim=1), external_features], dim=1)
        return self.mlp_fc2(self.act(self.mlp_fc1(combined)))
