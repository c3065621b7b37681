"""The port's CUDA kernels on the card: K1 (render) and K2/K3 (the
deep-ResNet embedding forward and backward) against their plain versions,
TF32 off, with their launch counters. Every test here is marked ``cuda`` and
skips without a card. This file imports no JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as tfe
from moleculardiffusion_mivit_tpu_torch.ops import render as trender_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _render_inputs(b, p, seed, device):
    rng = np.random.default_rng(seed)
    x = 4.0 * rng.normal(size=(b, p))
    y = 4.0 * rng.normal(size=(b, p))
    w = 500.0 + rng.normal(size=(b, p))
    return (torch.tensor(v, dtype=torch.float32, device=device) for v in (x, y, w))


def test_render_kernel_matches_plain_on_card(cuda_device):
    """K1 equals its plain version at the main-path shape and at 13×13,
    counts each launch once, and raises on what it does not take."""
    x, y, w = _render_inputs(7680, 10, 3, cuda_device)
    for s in (9, 13):
        before = trender_ops.render_frames.launches
        got = trender_ops.render_frames(x, y, w, 5.96, s, 5)
        want = trender_ops.render_frames_reference(x, y, w, 5.96, s, 5)
        assert trender_ops.render_frames.launches == before + 1
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError, match="scalar sigma"):
        trender_ops.render_frames(x, y, w, torch.full((2,), 5.0), 9, 5)
    with pytest.raises(ValueError, match="float32"):
        trender_ops.render_frames(x.double(), y, w, 5.96, 9, 5)
    with pytest.raises(ValueError, match="S\\*u"):
        trender_ops.render_frames(x, y, w, 5.96, 14, 5)


def _embedding_args(b, t, s, device, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(shape, scale, offset=0.0):
        v = offset + scale * rng.normal(size=shape)
        return torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)

    shapes = {
        "initial": (3, 3, 1, 32), "rb1_conv1": (3, 3, 32, 64), "rb1_conv2": (3, 3, 64, 64),
        "rb1_skip": (1, 1, 32, 64), "rb2_conv1": (3, 3, 64, 128), "rb2_conv2": (3, 3, 128, 128),
        "rb2_skip": (1, 1, 64, 128),
    }
    kernels = {k: leaf(v, 1.0 / np.sqrt(np.prod(v[:3]))) for k, v in shapes.items()}
    scales = {k: leaf((c,), 0.1, 1.0) for k, c in tfe.BN_LAYOUT}
    biases = {k: leaf((c,), 0.1) for k, c in tfe.BN_LAYOUT}
    x = leaf((b, t, s, s), 0.3, 0.1)
    return x, kernels, scales, biases, leaf((128, 64), 128 ** -0.5), leaf((64,), 0.1)


def test_embedding_kernels_match_plain_on_card(cuda_device):
    """K2's output and statistics equal the plain version; K3's gradients
    equal autograd through it; each launch is counted once."""
    args = _embedding_args(1, 30, 9, cuda_device)
    f0, b0 = tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches
    out_k, st_k = tfe.fused_deep_resnet_embed(*args)
    out_r, st_r = tfe.deep_resnet_embed_reference(*args)
    torch.testing.assert_close(out_k, out_r, rtol=1e-4, atol=1e-4)
    for name, _ in tfe.BN_LAYOUT:
        torch.testing.assert_close(st_k[name], st_r[name], rtol=1e-4, atol=1e-4)
    x, kernels, scales, biases, wfc, bfc = args
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    g = torch.randn(out_r.shape, generator=torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    gk = torch.autograd.grad(out_k, leaves, g)
    gr = torch.autograd.grad(out_r, leaves, g)
    for a, b in zip(gk, gr):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert (tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches) == (f0 + 1, b0 + 1)


def test_embedding_kernels_reject_what_they_do_not_take(cuda_device):
    x, kernels, scales, biases, wfc, bfc = _embedding_args(1, 2, 9, cuda_device)
    with pytest.raises(ValueError, match="square"):
        tfe.fused_deep_resnet_embed(x[..., :8], kernels, scales, biases, wfc, bfc)
    with pytest.raises(ValueError, match="float32"):
        tfe.deep_resnet_embed_fwd(x.detach().double().reshape(2, 9, 9), *_packed(kernels, scales, biases, wfc, bfc))


def _packed(kernels, scales, biases, wfc, bfc):
    k = {n: v.detach() for n, v in kernels.items()}
    weights = (
        k["initial"].reshape(9, 32), tfe._pack_w3(k["rb1_conv1"]), k["rb1_skip"].reshape(32, 64),
        tfe._pack_w3(k["rb1_conv2"]), tfe._pack_w3(k["rb2_conv1"]), k["rb2_skip"].reshape(64, 128),
        tfe._pack_w3(k["rb2_conv2"]),
    )
    sc = tfe._pack_rows([v.detach() for v in scales.values()])
    bi = tfe._pack_rows([v.detach() for v in biases.values()])
    return tuple(w.contiguous() for w in weights), sc, bi, wfc.detach(), bfc.detach()
