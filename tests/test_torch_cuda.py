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


@pytest.mark.parametrize(
    "b,p,s,u",
    [(1, 10, 9, 5), (15, 10, 9, 5), (1920, 10, 9, 5), (7680, 10, 9, 5),
     (1, 10, 13, 5), (15, 10, 13, 5), (1920, 10, 13, 5), (7680, 10, 13, 5),
     (100, 4, 10, 5), (33, 7, 9, 5), (9, 3, 65, 1), (50, 45, 7, 3)],
)
def test_render_kernel_shapes_on_card(cuda_device, b, p, s, u):
    """K1 against its plain version where a block is partly filled (1 and 15
    frames), at a main-path call (1920) and a whole cycle (7680), at both
    compiled-in patch sizes, and through the generic instantiation: an even
    grid, P other than 10, cells on more lanes than a warp has (S = 65) and
    more segments than a block's warps hold in one pass (P = 45). Two calls
    on the same inputs agree bitwise (no atomics, fixed summation order)."""
    x, y, w = _render_inputs(b, p, b + s, cuda_device)
    got = trender_ops.render_frames(x, y, w, 5.96, s, u)
    want = trender_ops.render_frames_reference(x, y, w, 5.96, s, u)
    assert got.shape == (b, s, s) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, trender_ops.render_frames(x, y, w, 5.96, s, u))


def test_render_kernel_takes_no_frames_and_no_subpositions(cuda_device):
    x = torch.zeros((0, 10), device=cuda_device)
    assert trender_ops.render_frames(x, x, x, 5.96, 9, 5).shape == (0, 9, 9)
    x = torch.zeros((4, 0), device=cuda_device)
    assert torch.equal(trender_ops.render_frames(x, x, x, 5.96, 9, 5), torch.zeros((4, 9, 9), device=cuda_device))


def _embedding_args(b, t, s, device, seed=0, e=64):
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
    return x, kernels, scales, biases, leaf((128, e), 128 ** -0.5), leaf((e,), 0.1)


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


@pytest.mark.parametrize(
    "b,t,s,e",
    [(1, 7, 9, 64), (2, 5, 13, 64), (1, 30, 9, 32), (3, 30, 9, 64), (1, 2, 9, 64), (1, 3, 7, 100),
     (4, 30, 9, 64)],
)
def test_embedding_kernels_match_plain_at_ragged_shapes(cuda_device, b, t, s, e):
    """Row counts that fill no tile (567, 1,690 and 7,290 rows; 162 and 147
    rows, less than a tile and a half), S = 13 and 7, embed dims other than
    64, and 9,720 rows, where the 128-channel convs take a larger tile (the
    tile is picked from the rows and channels, ``csrc/conv_rows.cuh``): K2
    and K3 still equal the plain version."""
    args = _embedding_args(b, t, s, cuda_device, seed=b + t + s + e, e=e)
    out_k, st_k = tfe.fused_deep_resnet_embed(*args)
    out_r, st_r = tfe.deep_resnet_embed_reference(*args)
    torch.testing.assert_close(out_k, out_r, rtol=1e-4, atol=1e-4)
    for name, _ in tfe.BN_LAYOUT:
        torch.testing.assert_close(st_k[name], st_r[name], rtol=1e-4, atol=1e-4)
    x, kernels, scales, biases, wfc, bfc = args
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    g = torch.randn(out_r.shape, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
    for a, r in zip(torch.autograd.grad(out_k, leaves, g), torch.autograd.grad(out_r, leaves, g)):
        assert float((a - r).abs().max()) <= 1e-3 * float(r.abs().max())


@pytest.mark.parametrize("b,t,s", [(4, 30, 9), (8, 30, 9), (16, 30, 9)])
def test_embedding_gradients_match_float64_autograd_at_every_larger_tile(cuda_device, b, t, s):
    """9,720, 19,440 and 38,880 rows: between them the convs and data
    gradients run every tile above the smallest (64 and 128 rows, each 64
    and 32 columns wide). At these row counts two f32 implementations put a
    few of the millions of ReLU inputs on opposite sides of 0, and each such
    element moves the input gradient at its pixels by percents, so K3 is held
    against float64 autograd through the plain version given K2's ReLU
    pattern (read from K2's saved activations), at the same 1e-3·max|g|."""
    args = _embedding_args(b, t, s, cuda_device, seed=b + t + s)
    x, kernels, scales, biases, wfc, bfc = args
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    out_k, st_k = tfe.fused_deep_resnet_embed(*args)
    out_r, st_r = tfe.deep_resnet_embed_reference(*args)
    torch.testing.assert_close(out_k, out_r, rtol=1e-4, atol=1e-4)
    for name, _ in tfe.BN_LAYOUT:
        torch.testing.assert_close(st_k[name], st_r[name], rtol=1e-4, atol=1e-4)

    n = b * t
    _, _, saved = tfe.deep_resnet_embed_fwd(
        x.detach().reshape(n, s, s).contiguous(), *_packed(kernels, scales, biases, wfc, bfc)
    )
    masks = iter([(saved[k] > 0).reshape(n, s, s, -1).permute(0, 3, 1, 2).double()
                  for k in ("a", "z1", "y1", "z1b", "y2")])
    leaves64 = [v.detach().double().requires_grad_() for v in leaves]
    it = iter(leaves64[1:])
    args64 = ({k: next(it) for k in kernels}, {k: next(it) for k in scales},
              {k: next(it) for k in biases}, next(it), next(it))
    out_d, _ = tfe.deep_resnet_embed_reference(leaves64[0], *args64, relu=lambda z: z * next(masks))
    g = torch.randn(out_r.shape, generator=torch.Generator(device=cuda_device).manual_seed(3), device=cuda_device)
    grads_k = torch.autograd.grad(out_k, leaves, g)
    grads_d = torch.autograd.grad(out_d, leaves64, g.double())
    for i, (gk, gd) in enumerate(zip(grads_k, grads_d)):
        err = float((gk.double() - gd).abs().max())
        assert err <= 1e-3 * float(gd.abs().max()), f"gradient {i}"


@pytest.mark.parametrize("b,t,s", [(1, 30, 9), (8, 30, 9)])
def test_embedding_kernels_are_bitwise_repeatable(cuda_device, b, t, s):
    """K2 and K3 called twice on the same inputs give bitwise equal outputs:
    no atomics, every reduction in a fixed order."""
    x, kernels, scales, biases, wfc, bfc = _embedding_args(b, t, s, cuda_device, seed=5)
    packed = _packed(kernels, scales, biases, wfc, bfc)
    xs = x.detach().reshape(b * t, s, s).contiguous()
    g = torch.randn((b * t, 64), generator=torch.Generator(device=cuda_device).manual_seed(2), device=cuda_device)
    runs = []
    for _ in range(2):
        emb, stats, saved = tfe.deep_resnet_embed_fwd(xs, *packed)
        gx, gw, gsc, gbi, gwfc, gbfc = tfe.deep_resnet_embed_bwd(xs, *packed, saved, g)
        # the tail of each BN's 128-wide row is undefined beyond its channels
        rows = [t[i, ..., :c] for t in (stats, gsc, gbi) for i, (_, c) in enumerate(tfe.BN_LAYOUT)]
        runs.append([emb, gx, *gw, *rows, gwfc, gbfc])
    for i, (first, second) in enumerate(zip(*runs)):
        assert torch.equal(first, second), f"output {i} differs between two calls"
    assert tfe.last_stage_launches()["wgrad_tensor_core"] == 6


def test_eval_embedding_ignores_the_callers_tf32_setting(cuda_device):
    """The eval-mode embedding (validation) runs its convolutions in full
    f32 whether or not the caller allows cuDNN TF32."""
    from moleculardiffusion_mivit_tpu_torch.models import DeepResNetEmbedding, init_model

    mod = init_model(DeepResNetEmbedding(9, 64), torch.Generator().manual_seed(0)).to(cuda_device).eval()
    x = torch.randn((4, 30, 9, 9), generator=torch.Generator(device=cuda_device).manual_seed(3), device=cuda_device)
    outs = []
    for allow in (False, True):
        torch.backends.cudnn.allow_tf32 = allow
        with torch.no_grad():
            outs.append(mod(x))
        assert torch.backends.cudnn.allow_tf32 == allow
    torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(*outs)


def test_train_step_ignores_the_callers_tf32_setting(cuda_device):
    """One training step of MultiImageResNet (cuDNN convolutions forward and
    backward) leaves the same gradients, to 1e-5 of each tensor's largest
    entry, whether or not the caller allows cuDNN TF32; TF32 would move them
    by about 1e-3."""
    from moleculardiffusion_mivit_tpu_torch.config import TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import MultiImageResNet
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    videos = 0.3 * torch.randn((16, 30, 9, 9), generator=gen, device=cuda_device) + 0.1
    labels = torch.rand((16, 1), generator=gen, device=cuda_device)
    idx = torch.arange(16, device=cuda_device)
    moments = []
    for allow in (False, True):
        torch.backends.cudnn.allow_tf32 = allow
        model = MultiImageResNet(single_prediction=True)
        impls = tloop.make_train_impls(model, TrainConfig(), device=cuda_device)
        state = impls.init_state(torch.Generator().manual_seed(0))
        impls.train_step(state, videos, labels, idx)
        assert torch.backends.cudnn.allow_tf32 == allow
        moments.append([state.optimizer.state[p]["exp_avg"] for p in model.parameters()])
    torch.backends.cudnn.allow_tf32 = False
    for a, b in zip(*moments):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()) + 1e-12


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
