"""Change-point analysis for sequence-mode (per-frame) predictions.

Port of ``moleculardiffusion_mivit_tpu/evaluation/changepoint.py``: for each
sequence, the frame where the mean prediction before and after differs most
(a two-window scan), with a detectability score relative to the prediction
noise. Every candidate split is evaluated at once, on the input's device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def detect_change_points(per_frame_predictions, min_margin: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """per_frame_predictions ``(N, T)`` → ``(split_idx (N,), score (N,))``.

    For each candidate split s the statistic is ``|mean(pred[:s]) −
    mean(pred[s:])| / pooled_std`` (unbiased variances of the two windows,
    ``sqrt((vl + vr)/2 + 1e-12)``); the returned split maximizes it over
    ``s ∈ [min_margin, T − min_margin]`` (the first on a tie). A score ≲ 1
    means no detectable transition (constant-D sequence).
    """
    preds = torch.as_tensor(per_frame_predictions, dtype=torch.float32)
    t = preds.shape[1]
    dev = preds.device
    idx = torch.arange(t, dtype=torch.float32, device=dev)
    splits = torch.arange(min_margin, t - min_margin + 1, device=dev)
    left = (idx[None, :] < splits[:, None].to(torch.float32)).to(torch.float32)[:, None, :]  # (S, 1, T)
    right = 1.0 - left
    nl = left.sum(-1)  # (S, 1)
    nr = t - nl
    ml = (preds * left).sum(-1) / nl  # (S, N)
    mr = (preds * right).sum(-1) / nr
    vl = (((preds - ml[..., None]) * left) ** 2).sum(-1) / torch.clamp(nl - 1, min=1)
    vr = (((preds - mr[..., None]) * right) ** 2).sum(-1) / torch.clamp(nr - 1, min=1)
    stats = (ml - mr).abs() / torch.sqrt((vl + vr) / 2.0 + 1e-12)  # (S, N)
    score, best = stats.max(dim=0)
    return splits[best], score
