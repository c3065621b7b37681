"""Hardware-utilization accounting: FLOPs of a training cycle, achieved
FLOP/s and MFU on the card.

Port of ``moleculardiffusion_mivit_tpu/utils/flops.py``, under its names.
The counts are *model* FLOPs: every matrix product and convolution of a
step's forward and backward and of the validation forward, counted by
``torch.utils.flop_counter.FlopCounterMode`` over one eager step of each
model run on the ``meta`` device (shapes only: nothing is computed, on any
device). Elementwise work, the optimizer and generation (the K1 renderer,
noise, the features) are not counted: they do no matrix products.

The deep-ResNet embedding's training route runs K2/K3 on the card, ctypes
kernels inside a ``torch.autograd.Function`` that the counter does not see.
On the meta device that route is a pair of shape-only ops that carry the
kernels' analytic count as registered flop formulas
(``ops.fused_embedding.embedding_flops``: the count ``chip_smoke.py``'s
bound uses for K2/K3, forward once and backward twice), so a deep-ResNet arm
is counted the same whether it would run on the card or on the CPU.

Not ported: ``compiled_flops`` (XLA's cost model of a compiled program);
PyTorch runs eagerly and has no compiled program to ask. A count here is the
same at f32 and bf16: the compute dtype changes the time, not the work.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

# Dense bf16 tensor-core peak of one card, by a piece of its name
# (``torch.cuda.get_device_name``), from NVIDIA's data sheets, without
# sparsity. Override with MIVIT_PEAK_TFLOPS for a card not listed.
_PEAK_TFLOPS_BF16 = {
    "h100 nvl": 835.0,
    "h100 pcie": 756.0,
    "h100": 989.4,  # SXM
    "h200": 989.4,
    "a100": 312.0,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card ``device`` (default: the current
    CUDA device), or None for the CPU or a card not in the table."""
    env = os.environ.get("MIVIT_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, tflops in _PEAK_TFLOPS_BF16.items():
        if key in name:
            return tflops * 1e12
    return None


def utilization(flops_per_call: Optional[float], seconds_per_call: float, peak: Optional[float] = None) -> dict:
    """``{"flops", "achieved_tflops", "mfu_pct"}`` of a call of
    ``flops_per_call`` FLOPs taking ``seconds_per_call`` (None-safe);
    ``mfu_pct`` against ``peak`` FLOP/s (``device_peak_flops()`` when not
    given; None on the CPU)."""
    out = {"flops": flops_per_call, "achieved_tflops": None, "mfu_pct": None}
    if not flops_per_call or seconds_per_call <= 0:
        return out
    achieved = flops_per_call / seconds_per_call
    out["achieved_tflops"] = round(achieved / 1e12, 4)
    peak = peak if peak is not None else device_peak_flops()
    if peak:
        out["mfu_pct"] = round(100.0 * achieved / peak, 3)
    return out


def _on_meta(model: torch.nn.Module) -> torch.nn.Module:
    return copy.deepcopy(model).to("meta").train()


def _count(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def step_flops(model: torch.nn.Module, train_cfg, batch_size: int, frame_shape: Tuple[int, int],
               with_features: bool = False, n_features: int = 25) -> int:
    """FLOPs of one training step of ``model`` (forward, loss and backward,
    in ``train_cfg.compute_dtype``) on a minibatch of ``batch_size``
    sequences of ``train_cfg.n_frames`` frames of ``frame_shape``."""
    from moleculardiffusion_mivit_tpu_torch.train.loop import TrainState, make_train_impls

    m = _on_meta(model)
    train_step = make_train_impls(m, train_cfg, "meta", with_features).train_step
    n, f = batch_size, train_cfg.n_frames
    videos = torch.empty((n, f, *frame_shape), device="meta")
    labels = torch.empty((n, f) if train_cfg.sequence_mode else (n, 1), device="meta")
    feats = torch.empty((n, n_features), device="meta") if with_features else None
    idx = torch.arange(n, device="meta")

    class _NoStep:  # the optimizer does no matrix product: leave it out
        def zero_grad(self, set_to_none=True):
            pass

        def step(self):
            pass

    return _count(lambda: train_step(TrainState(m, _NoStep()), videos, labels, idx, features=feats))


def eval_flops(model: torch.nn.Module, val_videos_shape: Tuple[int, ...], with_features: bool = False,
               n_features: int = 25) -> int:
    """FLOPs of the eval-mode forward of ``model`` on ``val_videos_shape``
    videos (f32: evaluation does not cast)."""
    m = _on_meta(model).eval()
    videos = torch.empty(tuple(val_videos_shape), device="meta")
    args = (videos, torch.empty((val_videos_shape[0], n_features), device="meta")) if with_features else (videos,)
    with torch.no_grad():
        return _count(lambda: m(*args))


def multi_cycle_flops(models: Dict[str, torch.nn.Module], train_cfg, batch_size: int,
                      val_videos_shape: Tuple[int, ...]) -> int:
    """FLOPs of one fused training cycle of the video-only ``models`` (the
    baseline cycle): each model's step × the epoch's ``n_seq //
    batch_size`` steps, plus each model's validation forward on
    ``val_videos_shape`` ``(N, F, S, S)``. Generation is not counted (module
    docstring)."""
    n_seq = train_cfg.sequences_per_d * len(train_cfg.training_ds)
    steps = n_seq // batch_size
    frame = tuple(val_videos_shape[-2:])
    return sum(steps * step_flops(m, train_cfg, batch_size, frame) + eval_flops(m, val_videos_shape)
               for m in models.values())


def grid_cycle_flops(model: torch.nn.Module, train_cfg, n_models: int, n_seq_per_model: int, batch_size: int,
                     frame_shape: Tuple[int, int], with_features: bool = False, n_features: int = 25,
                     val_shape: Optional[Tuple[int, ...]] = None) -> int:
    """FLOPs of one cycle of a grid of ``n_models`` models of ``model``'s
    architecture (``train.grid``): a grid step does each member's step, so
    ``n_models`` × one member's step × ``n_seq_per_model // batch_size``
    steps, plus with ``val_shape`` ``(M, N, F, S, S)`` every member's
    validation forward. Generation is not counted."""
    steps = n_seq_per_model // batch_size
    total = n_models * steps * step_flops(model, train_cfg, batch_size, frame_shape, with_features, n_features)
    if val_shape is not None:
        total += val_shape[0] * eval_flops(model, val_shape[1:], with_features, n_features)
    return total
