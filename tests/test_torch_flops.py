"""The port's FLOP accounting (``utils/flops.py``) on the CPU: exact counts
of a Dense layer and a convolution, the deep-ResNet embedding's analytic
K2/K3 count in a step, the JAX tests' properties (a cycle's count does not
depend on how its epoch is cut into steps; a grid's count scales with its
models), the MFU arithmetic, the card table, and the port's count of a small
cycle beside JAX's ``multi_cycle_flops``. Counts are integers of exact
arithmetic, so they are held exactly."""

import pytest
import torch

from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as JOptics
from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.utils import multi_cycle_flops as j_multi_cycle_flops
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, embeddings
from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe
from moleculardiffusion_mivit_tpu_torch.utils import flops

CYCLE = dict(sequences_per_d=16, training_ds=((1, 1), (5, 1)), n_frames=10, n_pos_per_frame=5, seed=0)
WIDTHS = dict(patch_size=9, embed_dim=32, num_heads=4, hidden_dim=64, num_layers=2)


def test_dense_layer_and_convolution_counts_are_exact():
    """2·M·N·K for a Dense layer; 2 · out elements · C_in · k² for a conv."""
    assert flops.eval_flops(torch.nn.Linear(81, 24), (37, 81)) == 2 * 37 * 24 * 81
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    assert flops.eval_flops(conv, (5, 3, 9, 9)) == 2 * (5 * 8 * 9 * 9) * 3 * 9


def test_a_deep_resnet_step_carries_the_kernels_analytic_count():
    """A deep-ResNet transformer's step is counted with K2's analytic count
    and K3's (twice K2's) in place of its embedding: the flop formulas of
    the embedding's shape-only ops on the meta device. Counted instead through
    the plain version (autograd on the meta device), the step is smaller by
    exactly the initial conv's input gradient, which K3 computes and
    autograd skips (the videos need no gradient); everything else agrees."""
    cfg = TrainConfig(**CYCLE)
    model = GeneralTransformer(ModelConfig(**WIDTHS), embedding="deep_resnet")
    analytic = flops.step_flops(model, cfg, 4, (9, 9))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(embeddings, "fused_deep_resnet_embed", fe.deep_resnet_embed_reference)
        plain = flops.step_flops(model, cfg, 4, (9, 9))
    rows = 4 * cfg.n_frames * 81
    assert analytic - plain == 2 * rows * 9 * fe.C0
    assert analytic > 3 * fe.embedding_flops(rows, 4 * cfg.n_frames, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_cycle_count_does_not_depend_on_the_step_size(dtype):
    """The JAX test's scan-immunity: the cycle is counted as one step × the
    epoch's steps, so batch 1 (32 steps) and batch 16 (2 steps) give the
    same model work. Here the count is exact and has no optimizer part, so
    the two are equal; and the compute dtype does not change it."""
    cfg = TrainConfig(**CYCLE, compute_dtype=dtype)
    models = {"vit": GeneralTransformer(ModelConfig(**WIDTHS), embedding="linear"),
              "deep": GeneralTransformer(ModelConfig(**WIDTHS), embedding="deep_resnet")}
    f1 = flops.multi_cycle_flops(models, cfg, 1, (8, 10, 9, 9))
    f16 = flops.multi_cycle_flops(models, cfg, 16, (8, 10, 9, 9))
    assert f1 == f16 > 0
    assert f16 == flops.multi_cycle_flops(models, cfg.replace(compute_dtype="float32"), 16, (8, 10, 9, 9))


def test_grid_count_scales_with_its_models():
    """A grid of 8 counts twice a grid of 4; one step of 32 sequences counts
    what four steps of 8 do."""
    cfg = TrainConfig(**CYCLE)
    model = GeneralTransformer(ModelConfig(**WIDTHS), embedding="deep_resnet")
    f4 = flops.grid_cycle_flops(model, cfg, 4, 32, 8, (9, 9), val_shape=(4, 8, 10, 9, 9))
    f8 = flops.grid_cycle_flops(model, cfg, 8, 32, 8, (9, 9), val_shape=(8, 8, 10, 9, 9))
    assert f8 == 2 * f4 > 0
    assert flops.grid_cycle_flops(model, cfg, 4, 32, 32, (9, 9), val_shape=(4, 8, 10, 9, 9)) == f4


def test_utilization_math_and_none_safety():
    out = flops.utilization(2e12, 2.0, peak=4e12)
    assert out == {"flops": 2e12, "achieved_tflops": 1.0, "mfu_pct": 25.0}
    assert flops.utilization(None, 1.0)["achieved_tflops"] is None
    assert flops.utilization(1e12, 0.0)["achieved_tflops"] is None
    assert flops.utilization(1e12, 1.0, peak=None)["mfu_pct"] is None  # no card here: no peak


def test_device_peak_flops_from_the_cards_name(monkeypatch):
    """The dense bf16 peak by the card's name, None on the CPU, and the
    environment's override."""
    monkeypatch.delenv("MIVIT_PEAK_TFLOPS", raising=False)
    assert flops.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 PCIe")
    assert flops.device_peak_flops() == 756e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    assert flops.device_peak_flops() is None
    monkeypatch.setenv("MIVIT_PEAK_TFLOPS", "100")
    assert flops.device_peak_flops() == 100e12


@pytest.mark.parametrize("embedding", ["linear", "deep_resnet"])
def test_small_cycle_beside_jax_multi_cycle_flops(embedding):
    """The port's count of a small cycle beside JAX's ``multi_cycle_flops``
    (XLA's cost model of the same cycle). The two count different things:
    XLA counts elementwise work, generation and the optimizer too, and its
    convolution costs are its own; so the ratio is recorded, not held
    (port / JAX: 0.768 linear, 1.150 deep-ResNet, against XLA's
    CPU-backend cost model). Both are positive."""
    j = j_multi_cycle_flops({"m": JGeneral(JModelConfig(**WIDTHS), embedding=embedding)}, JTrainConfig(**CYCLE),
                            JOptics, 16, (8, 10, 9, 9))
    t = flops.multi_cycle_flops({"m": GeneralTransformer(ModelConfig(**WIDTHS), embedding=embedding)},
                                TrainConfig(**CYCLE), 16, (8, 10, 9, 9))
    assert j and t > 0
    print(f"{embedding}: port {t} / JAX {j:.0f} = {t / j:.4f}")
