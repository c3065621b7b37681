"""Change-point analysis for sequence-mode (per-frame) predictions.

Port of ``moleculardiffusion_mivit_tpu/evaluation/changepoint.py``: for each
sequence, the frame where the mean prediction before and after differs most
(a two-window scan), with a detectability score relative to the prediction
noise. Every candidate split is evaluated at once, on the input's device.

The scoring of the change-point studies (``examples/sequence_changepoint_
demo.py`` and ``sequence_changepoint_modular.py``) lives here too:
``score_planted`` turns the per-frame predictions of a planted-transition
set, its unmixed controls and a calibration split into the examples' report
fields, with ``wilson_ci`` on every detection rate; ``mix_tails_multi``
(``train.loop``) plants the transitions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def wilson_ci(k: int, n: int, z: float = 1.96):
    """The 95 % Wilson score interval of ``k`` successes in ``n``, each end
    rounded to 1e-3; ``None`` when ``n`` is 0."""
    if n == 0:
        return None
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5) / denom
    return [round(center - half, 3), round(center + half, 3)]


# The report fields of each example, in its order; ``by_contrast`` maps to
# the fields of each |ΔD| cell.
DEMO_FIELDS = {"n_mixed": None, "n_controls": None, "roc_auc": None, "score_threshold": None,
               "detection_rate": None, "false_positive_rate": None, "median_split_error_frames": None,
               "mean_split_error_frames": None, "mean_score_mixed": None, "mean_score_const": None,
               "by_contrast": ("n", "detection_rate", "mean_score")}
MODULAR_FIELDS = {"roc_auc": None, "detection_rate": None, "detection_ci95": None, "false_positive_rate": None,
                  "false_positive_ci95": None, "median_split_error_frames": None,
                  "by_contrast": ("n", "detected", "detection_rate", "ci95")}


def score_planted(pred_planted, pred_control, pred_calibration, planted_labels,
                  threshold: Optional[float] = None) -> dict:
    """The change-point studies' scores of one model, as both examples
    compute them.

    ``pred_*`` are per-frame predictions ``(N, F)`` (any device; the scan
    runs there) of the planted-transition set, its unmixed controls and an
    independent constant-D calibration split; ``planted_labels`` the planted
    set's per-frame labels in D units ``(N, F)``. A sequence has a
    transition where its label changes, the true split being the first
    frame that differs from frame 0. The score threshold is the calibration
    scores' 95th percentile unless ``threshold`` is given.

    Returns every field of either example's report, rounded as they round
    them: ``n_mixed``, ``n_controls``, ``roc_auc`` (planted against control
    scores over all pairs, ties 0.5), ``score_threshold``,
    ``detection_rate`` and ``false_positive_rate`` with their
    ``*_ci95`` (``wilson_ci``), the median and mean split error in frames of
    the detected transitions, the mean scores, and ``by_contrast``: per
    rounded |ΔD| the count, detections, rate, CI and mean score.
    ``select_fields`` picks one example's."""
    split_m, score_m = (x.cpu().numpy() for x in detect_change_points(pred_planted))
    score_c = detect_change_points(pred_control)[1].cpu().numpy()
    score_cal = detect_change_points(pred_calibration)[1].cpu().numpy()
    ml = torch.as_tensor(planted_labels).cpu().numpy()
    changed = ml != ml[:, :1]
    has_transition = changed.any(axis=1)
    true_split = np.where(has_transition, changed.argmax(axis=1), -1)
    contrast = np.abs(ml[:, -1] - ml[:, 0])

    sm = score_m[has_transition]
    auc = float((sm[:, None] > score_c[None, :]).mean() + 0.5 * (sm[:, None] == score_c[None, :]).mean())
    thr = float(np.percentile(score_cal, 95.0)) if threshold is None else threshold
    hit = has_transition & (score_m > thr)
    loc = np.abs(split_m[hit] - true_split[hit])
    by_contrast = {}
    for dd in sorted(set(np.round(contrast[has_transition]).astype(int))):
        sel = has_transition & (np.round(contrast).astype(int) == dd)
        k_det, n_det = int((score_m[sel] > thr).sum()), int(sel.sum())
        by_contrast[f"dD={dd}"] = {"n": n_det, "detected": k_det,
                                   "detection_rate": round(k_det / n_det, 3) if n_det else None,
                                   "ci95": wilson_ci(k_det, n_det), "mean_score": round(float(score_m[sel].mean()), 2)}
    n_t, k_t = int(has_transition.sum()), int((sm > thr).sum())
    n_c, k_fp = len(score_c), int((score_c > thr).sum())
    return {
        "n_mixed": n_t,
        "n_controls": n_c,
        "roc_auc": round(auc, 3),
        "score_threshold": round(thr, 2),
        "detection_rate": round(k_t / n_t, 3),
        "detection_ci95": wilson_ci(k_t, n_t),
        "false_positive_rate": round(k_fp / n_c, 3),
        "false_positive_ci95": wilson_ci(k_fp, n_c),
        "median_split_error_frames": float(np.median(loc)) if len(loc) else None,
        "mean_split_error_frames": round(float(loc.mean()), 2) if len(loc) else None,
        "mean_score_mixed": round(float(sm.mean()), 2),
        "mean_score_const": round(float(score_c.mean()), 2),
        "by_contrast": by_contrast,
    }


def select_fields(scored: dict, fields: dict) -> dict:
    """The fields ``fields`` (``DEMO_FIELDS`` or ``MODULAR_FIELDS``) of a
    ``score_planted`` result, in that order."""
    return {name: scored[name] if cell is None else {dd: {k: c[k] for k in cell} for dd, c in scored[name].items()}
            for name, cell in fields.items()}
