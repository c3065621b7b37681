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
    with pytest.raises(ValueError, match="do not divide"):
        trender_ops.render_frames(x, y, w, (5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.25), 9, 5)
    with pytest.raises(ValueError, match="PSF settings outside"):
        trender_ops.render_frames(x, y, w, (5.0,) * 10, 9, 5)
    with pytest.raises(ValueError, match="float32"):
        trender_ops.render_frames(x.double(), y, w, 5.96, 9, 5)
    with pytest.raises(ValueError, match="S\\*u"):
        trender_ops.render_frames(x, y, w, 5.96, 97, 5)
    with pytest.raises(ValueError, match="shared memory"):
        trender_ops.render_frames(*(v[:2].repeat(1, 31) for v in (x, y, w)), 5.96, 96, 5)  # P = 310


@pytest.mark.parametrize(
    "b,p,s,u",
    [(1, 10, 9, 5), (15, 10, 9, 5), (1920, 10, 9, 5), (7680, 10, 9, 5),
     (1, 10, 13, 5), (15, 10, 13, 5), (1920, 10, 13, 5), (7680, 10, 13, 5),
     (100, 4, 10, 5), (33, 7, 9, 5), (9, 3, 65, 1), (50, 45, 7, 3),
     (3840, 5, 13, 5), (1280, 15, 13, 5), (960, 20, 13, 5), (640, 30, 13, 5), (384, 50, 13, 5),
     (25, 60, 63, 5), (3, 100, 63, 5), (1600, 100, 63, 5), (5, 300, 96, 5), (4, 20, 96, 5)],
)
def test_render_kernel_shapes_on_card(cuda_device, b, p, s, u):
    """K1 against its plain version where a block is partly filled (1 and 15
    frames), at a main-path call (1920) and a whole cycle (7680), at both
    compiled-in patch sizes, and through the generic instantiation: an even
    grid, P other than 10, cells on more lanes than a warp has (S = 65) and
    more segments than a block's warps hold in one pass (P = 45), and the
    framerate experiment's calls (one class of 64 × 300 steps at P = 5 … 50
    on 13×13), the wide-field movies (S = 63 at P = 60 and 100: 50,400
    bytes of shared memory, above 48 KB) and the kernel's largest S with
    230,400 bytes (P = 300). Two calls on the same inputs agree bitwise (no atomics, fixed
    summation order)."""
    x, y, w = _render_inputs(b, p, b + s, cuda_device)
    got = trender_ops.render_frames(x, y, w, 5.96, s, u)
    want = trender_ops.render_frames_reference(x, y, w, 5.96, s, u)
    assert got.shape == (b, s, s) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, trender_ops.render_frames(x, y, w, 5.96, s, u))


@pytest.mark.parametrize("per,k,s", [(1920, 5, 9), (7, 5, 9), (4, 3, 13), (30000, 5, 9)])
def test_render_kernel_with_a_sigma_per_setting_on_card(cuda_device, per, k, s):
    """One launch renders K PSF settings (the PSF x noise grid: 5 settings
    of one class, 9,600 frames, and of the in-order suite, 150,000; 7
    frames a setting, so blocks of 3 frames straddle settings; 13×13):
    bitwise the K one-sigma launches on the runs, and within 1e-5·max of
    the plain version with the sigmas broadcast."""
    sigmas = tuple(4.6 / v for v in (2.0, 1.75, 1.5, 1.25, 1.0)[:k])
    x, y, w = _render_inputs(per * k, 10, per + k, cuda_device)
    before = trender_ops.render_frames.launches
    got = trender_ops.render_frames(x, y, w, sigmas, s, 5)
    assert trender_ops.render_frames.launches == before + 1
    runs = torch.cat([trender_ops.render_frames(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per],
                                                w[i * per:(i + 1) * per], sig, s, 5) for i, sig in enumerate(sigmas)])
    assert torch.equal(got, runs)
    want = trender_ops.render_frames_reference(
        *(v.reshape(k, per, 10) for v in (x, y, w)), torch.tensor(sigmas, device=cuda_device).view(k, 1, 1), s, 5
    ).reshape(-1, s, s)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


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
     (4, 30, 9, 64), (1, 6, 13, 64)],
)
def test_embedding_kernels_match_plain_at_ragged_shapes(cuda_device, b, t, s, e):
    """Row counts that fill no tile (567, 1,690 and 7,290 rows; 162 and 147
    rows, less than a tile and a half), S = 13 and 7, embed dims other than
    64, 9,720 rows, where the 128-channel convs take a larger tile (the tile
    is picked from the rows and channels, ``csrc/conv_rows.cuh``), and the
    framerate experiment's shortest batch-1 step (1,014 rows of 13×13): K2
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
    _gradients_match_float64(b, t, s, 64, cuda_device)


@pytest.mark.parametrize("b,t,s,e", [(1, 30, 9, 32), (1, 30, 9, 128), (16, 30, 9, 128), (1, 60, 13, 64),
                                     (16, 60, 13, 64), (16, 6, 13, 64)])
def test_embedding_gradients_match_float64_autograd_at_new_widths_and_frames(cuda_device, b, t, s, e):
    """The embeddings experiment's E = 32 and 128 and the framerate
    experiment's 13×13 steps (10,140 to 162,240 rows), held as
    ``test_embedding_gradients_match_float64_autograd_at_every_larger_tile``
    holds the larger tiles: against plain f32 with its own ReLU pattern
    one flipped ReLU input already moves a gradient past 1e-3·max|g| (seen
    at 2,430 rows with E = 128 and at 10,140 of 13×13)."""
    _gradients_match_float64(b, t, s, e, cuda_device)


def _gradients_match_float64(b, t, s, e, cuda_device):
    args = _embedding_args(b, t, s, cuda_device, seed=b + t + s, e=e)
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


def _stack_members(packed_list):
    """Single-member packed arguments stacked along a new member axis."""
    weights = tuple(torch.stack([p[0][i] for p in packed_list]) for i in range(7))
    return (weights, *(torch.stack([p[j] for p in packed_list]) for j in range(1, 5)))


@pytest.mark.parametrize("m,b,t,s,e", [(3, 1, 30, 9, 64), (2, 8, 30, 9, 64), (2, 1, 6, 13, 32)])
def test_embedding_members_equal_single_member_launches_on_card(cuda_device, m, b, t, s, e):
    """K2 and K3 over M members in one launch each: every output of member
    i (embedding, BN statistics, saved activations, every gradient) bitwise
    equal to a launch for member i alone, at a batch-1 step (2,430 rows a
    member, the 32-row tiles), at 19,440 rows (the 128-row tiles) and on
    13×13 frames at E = 32; each member's statistics over its own rows."""
    singles, xs, gs = [], [], []
    for i in range(m):
        x, kernels, scales, biases, wfc, bfc = _embedding_args(b, t, s, cuda_device, seed=10 + i, e=e)
        singles.append(_packed(kernels, scales, biases, wfc, bfc))
        xs.append(x.detach().reshape(b * t, s, s).contiguous())
        gs.append(torch.randn((b * t, e), generator=torch.Generator(device=cuda_device).manual_seed(i),
                              device=cuda_device))
    stacked = _stack_members(singles)
    f0, b0 = tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches
    emb, stats, saved = tfe.deep_resnet_embed_fwd(torch.stack(xs), *stacked)
    grads = tfe.deep_resnet_embed_bwd(torch.stack(xs), *stacked, saved, torch.stack(gs))
    assert (tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches) == (f0 + 1, b0 + 1)
    for i in range(m):
        emb1, stats1, saved1 = tfe.deep_resnet_embed_fwd(xs[i], *singles[i])
        gx1, gw1, gsc1, gbi1, gwfc1, gbfc1 = tfe.deep_resnet_embed_bwd(xs[i], *singles[i], saved1, gs[i])
        assert torch.equal(emb[i], emb1), f"member {i} embedding"
        for j, (_, c) in enumerate(tfe.BN_LAYOUT):
            assert torch.equal(stats[i, j, :, :c], stats1[j, :, :c]), f"member {i} statistics {j}"
            assert torch.equal(grads[2][i, j, :c], gsc1[j, :c]) and torch.equal(grads[3][i, j, :c], gbi1[j, :c])
        for name, _ in tfe.SAVED:
            assert torch.equal(saved[name][i], saved1[name]), f"member {i} {name}"
        assert torch.equal(grads[0][i], gx1)
        for g_all, g1 in zip(grads[1], gw1):
            assert torch.equal(g_all[i], g1)
        assert torch.equal(grads[4][i], gwfc1) and torch.equal(grads[5][i], gbfc1)


def test_embedding_members_under_vmap_launch_once_and_match_plain(cuda_device):
    """The embedding under ``torch.vmap`` (a model grid's step): one K2 and
    one K3 launch for all members, and each member's embedding, statistics
    and gradients equal the plain version on its own inputs."""
    m, b, t, s = 3, 1, 30, 9
    args = [_embedding_args(b, t, s, cuda_device, seed=20 + i) for i in range(m)]
    x = torch.stack([a[0].detach() for a in args]).requires_grad_()
    kernels = {k: torch.stack([a[1][k].detach() for a in args]).requires_grad_() for k in args[0][1]}
    scales = {k: torch.stack([a[2][k].detach() for a in args]).requires_grad_() for k in args[0][2]}
    biases = {k: torch.stack([a[3][k].detach() for a in args]).requires_grad_() for k in args[0][3]}
    wfc = torch.stack([a[4].detach() for a in args]).requires_grad_()
    bfc = torch.stack([a[5].detach() for a in args]).requires_grad_()
    f0, b0 = tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches
    out, stats = torch.vmap(tfe.fused_deep_resnet_embed)(x, kernels, scales, biases, wfc, bfc)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(4), device=cuda_device)
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    grads = torch.autograd.grad(out, leaves, g)
    assert (tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches) == (f0 + 1, b0 + 1)
    for i in range(m):
        out_r, st_r = tfe.deep_resnet_embed_reference(*args[i])
        torch.testing.assert_close(out[i], out_r, rtol=1e-4, atol=1e-4)
        for name, _ in tfe.BN_LAYOUT:
            torch.testing.assert_close(stats[name][0][i], st_r[name][0], rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(stats[name][1][i], st_r[name][1], rtol=1e-4, atol=1e-4)
        leaves_i = [args[i][0], *args[i][1].values(), *args[i][2].values(), *args[i][3].values(), args[i][4], args[i][5]]
        for a, r in zip(grads, torch.autograd.grad(out_r, leaves_i, g[i])):
            assert float((a[i] - r).abs().max()) <= 1e-3 * float(r.abs().max())


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


# -- the fused cycle as captured CUDA graphs (train/capture.py) -------------

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _small_arms(**cfg_kw):
    from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet

    cfg = ModelConfig(**dict(SMALL, **cfg_kw))
    return {
        "lin_s": GeneralTransformer(cfg, embedding="linear"),
        "deep_s": GeneralTransformer(cfg, embedding="deep_resnet"),
        "lin_leaky": GeneralTransformer(cfg.replace(activation="leaky_relu"), embedding="linear"),
        "resnet": MultiImageResNet(),
    }


def _captured_against_eager(device, schedule, **cfg_kw):
    """Cycles of ``schedule`` ((batch, lr) each) through ``make_multi_cycle``
    on the card (captured, the linear pair stacked) and, on copies of the
    same models, through each model's eager ``train_cycle`` with the same
    capturable optimizer and generators. Returns the engine, the models and
    their eager copies, and per cycle each model's (captured, eager) loss."""
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import init_model
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
    from moleculardiffusion_mivit_tpu_torch.train import multi as tmulti
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    cfg = TrainConfig(sequences_per_d=4, n_frames=6)
    models, ref_models = _small_arms(**cfg_kw), _small_arms(**cfg_kw)
    init_states, cycle = tmulti.make_multi_cycle(models, cfg, BASELINE_OPTICS, stack_pairs=True, device=device)
    g = torch.Generator().manual_seed(5)
    states = init_states(g)
    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        m.to(device).train()
        impls[name] = tloop.make_train_impls(m, cfg, device=device)
        ref_states[name] = tloop.TrainState(m, tloop.make_optimizer(m, cfg, capturable=True))
    losses = []
    for c, (batch, lr) in enumerate(schedule):
        gc = seeded_generator(device, 9, c)
        states, got, _ = cycle(states, gc, lr, batch)
        videos, labels = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS)
        want = {name: impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), lr, batch)
                for i, name in enumerate(ref_models)}
        losses.append({name: (float(got[name]), float(want[name])) for name in models})
    return cycle.engine, models, ref_models, losses


def _assert_models_equal(models, ref_models):
    """Every parameter and buffer (BN running statistics) of the captured
    run within 1e-5 of the largest entry of the eager run's tensor (the two
    run the same kernels; a difference would be an ordering change)."""
    for name, m in models.items():
        ref = ref_models[name].state_dict()
        for key, v in m.state_dict().items():
            err = float((v - ref[key]).abs().max())
            assert err <= 1e-5 * float(ref[key].abs().max()) + 1e-7, f"{name} {key}: {err}"


def test_captured_cycle_equals_eager_cycle_on_card(cuda_device):
    """One cycle of 8 steps (2 eager warm-up steps, a capture, 6 replays per
    unit) leaves the parameters, losses and BatchNorm running statistics of
    the eager cycle; the statistics moved."""
    engine, models, ref_models, losses = _captured_against_eager(cuda_device, [(2, 1e-3)])
    assert engine.captures == 3 and engine.replays == 3 * (8 - 2)  # lin stack, deep_s, resnet
    for got, want in losses[0].values():
        assert abs(got - want) <= 1e-5 * abs(want)
    _assert_models_equal(models, ref_models)
    bn = models["resnet"].resnet.trunk.bn1
    assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    assert not torch.equal(models["deep_s"].embedding.bn1.running_var, torch.ones(32, device=cuda_device))


def test_learning_rate_changes_between_cycles_without_recapture(cuda_device):
    """A new learning rate reaches the captured AdamW step through its
    device tensor: no new capture, and the update equals the eager one at
    that rate."""
    engine, models, ref_models, losses = _captured_against_eager(cuda_device, [(2, 1e-3), (2, 2e-4)])
    assert engine.captures == 3 and engine.replays == 3 * (8 - 2 + 8)
    for cyc in losses:
        for got, want in cyc.values():
            assert abs(got - want) <= 1e-5 * abs(want)
    _assert_models_equal(models, ref_models)


def test_a_new_batch_size_captures_anew(cuda_device):
    """Batch 2, then batch 4: the first size's graphs are dropped and each
    unit is captured again for the second (2 warm-up steps, 2 replays)."""
    engine, models, ref_models, losses = _captured_against_eager(cuda_device, [(2, 1e-3), (4, 1e-3)])
    assert engine.captures == 6 and engine.replays == 3 * (6 + 2)
    _assert_models_equal(models, ref_models)


def test_resnet_training_is_bitwise_repeatable_on_card(cuda_device):
    """Two training cycles of MultiImageResNet from one seed give the same
    bits: its cuDNN convolutions run with deterministic algorithms inside
    ``f32_convolutions`` (cuDNN's default weight-gradient choice adds with
    atomics, and two such runs drifted apart by 1e-2 of a weight's range in
    8 AdamW steps)."""
    from moleculardiffusion_mivit_tpu_torch.config import TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import MultiImageResNet
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    videos = 0.3 * torch.randn((16, 30, 9, 9), generator=gen, device=cuda_device) + 0.1
    labels = torch.rand((16, 1), generator=gen, device=cuda_device)
    runs = []
    for _ in range(2):
        model = MultiImageResNet(single_prediction=True)
        impls = tloop.make_train_impls(model, TrainConfig(lr=1e-3), device=cuda_device)
        state = impls.init_state(torch.Generator().manual_seed(0))
        impls.train_cycle(state, videos, labels, torch.Generator(device=cuda_device).manual_seed(1), 1e-3, 2)
        runs.append(model.state_dict())
    for key, v in runs[0].items():
        assert torch.equal(v, runs[1][key]), key


def test_capturable_adamw_update_equals_the_plain_one(cuda_device):
    """Three AdamW steps with a capturable optimizer (learning rate a device
    tensor, bias corrections computed on the card in f32) equal those of the
    plain one (bias corrections on the host) on the same gradients: within
    1e-5 of the summed step sizes plus two float32 roundings of the
    parameter."""
    from moleculardiffusion_mivit_tpu_torch.config import TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import init_model
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop

    cfg = TrainConfig(lr=1e-3)
    pair = []
    for capturable in (False, True):
        m = init_model(_small_arms()["lin_s"], torch.Generator().manual_seed(1)).to(cuda_device)
        pair.append((m, tloop.make_optimizer(m, cfg, capturable=capturable)))
    assert isinstance(pair[1][1].param_groups[0]["lr"], torch.Tensor)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for step in range(3):
        grads = [torch.randn(p.shape, generator=gen, device=cuda_device) for p in pair[0][0].parameters()]
        for m, opt in pair:
            tloop._set_lr(opt, 1e-3 * (step + 1))
            for p, gr in zip(m.parameters(), grads):
                p.grad = gr.clone()
            opt.step()
    for a, b in zip(pair[0][0].parameters(), pair[1][0].parameters()):
        tol = 1e-5 * 6e-3 + 2 * torch.finfo(torch.float32).eps * float(a.detach().abs().max())
        assert float((a - b).detach().abs().max()) <= tol


def test_embedding_kernels_in_a_captured_graph_equal_the_eager_call(cuda_device):
    """K2 and K3 (``fused_deep_resnet_embed`` forward and backward) captured
    in a CUDA graph: a replay gives bitwise the eager call's output and
    gradients on new input, and the wrappers count the calls made while
    capturing, not the replays."""
    x, kernels, scales, biases, wfc, bfc = _embedding_args(2, 30, 9, cuda_device, seed=11)
    leaves = [*kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    static_x = x.detach().clone()
    g_out = torch.randn((2, 30, 64), generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)

    def step():
        emb, _ = tfe.fused_deep_resnet_embed(static_x, kernels, scales, biases, wfc, bfc)
        return (emb, *torch.autograd.grad(emb, leaves, g_out))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    f0, b0 = tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches
    with torch.cuda.graph(graph):
        captured = step()
    static_x.copy_(0.3 * torch.randn(x.shape, generator=torch.Generator(device=cuda_device).manual_seed(2),
                                     device=cuda_device))
    graph.replay()
    graph.replay()
    assert (tfe.deep_resnet_embed_fwd.launches, tfe.deep_resnet_embed_bwd.launches) == (f0 + 1, b0 + 1)
    eager = step()
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), f"output {i}"


def test_dropout_and_a_failed_capture_raise(cuda_device):
    """On the card nothing goes on eagerly in a capture's place. A model with
    dropout 0.1 is captured like any other: each replay folds its step's
    ``idx[0]`` into the key buffer and draws new masks, so two captured
    cycles leave the losses, parameters and BN statistics of two eager ones
    (``test_captured_cycle_equals_eager_cycle_on_card``'s bounds). A step that
    synchronises with the host fails its capture and raises."""
    engine, models, ref_models, losses = _captured_against_eager(cuda_device, [(2, 1e-3), (2, 1e-3)], dropout=0.1)
    assert engine.captures == 3 and engine.replays == 3 * (8 - 2 + 8)
    for cyc in losses:
        for got, want in cyc.values():
            assert abs(got - want) <= 1e-5 * abs(want)
    _assert_models_equal(models, ref_models)

    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.train import multi as tmulti

    class Syncs(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, x):
            if float(x.sum()) > 1e30:  # a host read: illegal while capturing
                x = x * 0
            return (self.w * x.mean(dim=(1, 2, 3)))[:, None]

    init_states, cycle = tmulti.make_multi_cycle({"m": Syncs()}, TrainConfig(sequences_per_d=4, n_frames=6),
                                                 BASELINE_OPTICS, device=cuda_device)
    states = init_states(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        cycle(states, torch.Generator(device=cuda_device).manual_seed(0), 1e-3, 2)
    assert cycle.engine.captures == 0
    torch.cuda.synchronize()


def test_dropout_masks_on_card_equal_the_cpus(cuda_device):
    """The keyed dropout masks (``models.dropout``: integer hashing only)
    at a transformer's shapes, on the card, bitwise the CPU's for the same
    key, ``idx[0]``, site and rows."""
    from moleculardiffusion_mivit_tpu_torch.models import dropout as tdrop
    from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, seeded_generator

    key = dropout_key(seeded_generator("cpu", 3))
    for site, lo, shape in ((0, 0, (16, 4, 61, 61)), (2, 5, (3, 61, 256)), (tdrop.MAX_SITES - 1, 0, (16, 128))):
        masks = [tdrop.dropout_mask(tdrop.step_key(torch.tensor(key, device=d), torch.tensor(7, device=d)),
                                    site, lo, shape, 0.9) for d in ("cpu", cuda_device)]
        assert torch.equal(masks[0], masks[1].cpu()), (site, lo, shape)


def test_features_on_card_match_the_cpu(cuda_device):
    """The 25 features (and the hull area) of 320 Brownian trajectories of
    30 frames, made with numpy, computed on the card equal the CPU's at the
    CPU tests' ``PARITY_TOLERANCE``; two calls on the card agree bitwise."""
    from moleculardiffusion_mivit_tpu_torch.features import FEATURE_NAMES, compute_features_for_multiple_trajectories
    from moleculardiffusion_mivit_tpu_torch.features.features import PARITY_TOLERANCE

    rng = np.random.default_rng(11)
    sigma = np.sqrt(2 * rng.uniform(0.01, 1.0, size=(320, 1, 1)))
    trajs = torch.from_numpy(np.cumsum(rng.normal(size=(320, 30, 2)) * sigma, axis=1).astype(np.float32))
    on_card = compute_features_for_multiple_trajectories(trajs.to(cuda_device))
    assert torch.equal(on_card, compute_features_for_multiple_trajectories(trajs.to(cuda_device)))
    on_cpu = compute_features_for_multiple_trajectories(trajs)
    for i, name in enumerate(FEATURE_NAMES):
        rtol, atol = PARITY_TOLERANCE[name]
        torch.testing.assert_close(on_card[:, i].cpu(), on_cpu[:, i], rtol=rtol, atol=atol, msg=name)


def test_captured_cycle_with_features_equals_eager_on_card(cuda_device):
    """``make_multi_cycle(with_features=True)`` on the card (early- and
    late-fusion transformers with the deep-ResNet embedding, so K2/K3 run in
    the graphs, and MultiImageFeatureResNet): one cycle of 4 steps (2 eager
    warm-up steps, a capture, 2 replays per unit) leaves the losses and every
    parameter and buffer of eager per-model ``train_cycle`` calls with the
    same features."""
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageFeatureResNet, init_model
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
    from moleculardiffusion_mivit_tpu_torch.train.multi import make_multi_cycle
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    small = ModelConfig(use_pos_encoding=False, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
    fusion = dict(embedding="deep_resnet", use_global_features=True, global_feature_dim=25)

    def zoo():
        return {"early": GeneralTransformer(small, fusion_type="early", **fusion),
                "late": GeneralTransformer(small, fusion_type="late", **fusion),
                "resnet": MultiImageFeatureResNet(25, feature_size=16, hidden_size=32)}

    cfg = TrainConfig(sequences_per_d=2, n_frames=4)
    models, ref_models = zoo(), zoo()
    init_states, cycle = make_multi_cycle(models, cfg, BASELINE_OPTICS, with_features=True, device=cuda_device)
    g = torch.Generator().manual_seed(3)
    states = init_states(g)
    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        m.to(cuda_device).train()
        impls[name] = tloop.make_train_impls(m, cfg, device=cuda_device, with_features=True)
        ref_states[name] = tloop.TrainState(m, tloop.make_optimizer(m, cfg, capturable=True))
    gc = seeded_generator(cuda_device, 9, 0)
    _, got, _ = cycle(states, gc, 1e-3, 2)
    videos, labels, feats = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS, with_features=True)
    assert feats.is_cuda and feats.shape == (8, 25)
    for i, name in enumerate(ref_models):
        want = impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), 1e-3, 2,
                                       features=feats)
        assert abs(float(got[name]) - float(want)) <= 1e-5 * abs(float(want)), name
    assert cycle.engine.captures == 3 and cycle.engine.replays == 3 * 2
    _assert_models_equal(models, ref_models)


@pytest.mark.parametrize("kind", ["deep_resnet", "resnet"])
def test_grid_captured_epochs_equal_eager_epochs_on_card(cuda_device, kind):
    """A model grid (``train.grid``: three members stepped as one program)
    through the capture engine against the same grid's eager epochs, at two
    batch sizes: per-member losses, parameters and BN running statistics
    agree within 1e-5 of the eager tensor's largest entry, and the
    deep-ResNet grid launches K2/K3 once a step for all members."""
    from moleculardiffusion_mivit_tpu_torch.config import ModelConfig, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
    from moleculardiffusion_mivit_tpu_torch.train.capture import EpochEngine, Member, kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.train.grid import make_grid_impls, make_perms
    from moleculardiffusion_mivit_tpu_torch.train.loop import _set_lr
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet") if kind == "deep_resnet" \
        else MultiImageResNet()
    cfg = TrainConfig(sequences_per_d=2, n_frames=6)
    impls = make_grid_impls(model, cfg, cuda_device)
    states = [impls.init_grid([torch.Generator().manual_seed(i) for i in range(3)], capturable=True)
              for _ in range(2)]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    videos = torch.rand((3, 8, 6, 9, 9), generator=g, device=cuda_device)
    labels = torch.rand((3, 8, 1), generator=g, device=cuda_device)
    engine = EpochEngine(cuda_device)
    before = launch_counts()
    for c, (batch, lr) in enumerate(((1, 1e-3), (2, 5e-4), (2, 5e-4))):
        gen = seeded_generator(cuda_device, 3, c)
        _set_lr(states[0].optimizer, lr)
        perm = make_perms(gen, 3, 8, batch, cuda_device).transpose(0, 1).contiguous()
        got = engine.run([[Member("grid", states[0], impls.train_step, videos, labels, perm)]], batch)["grid"]
        want = impls.train_cycle(states[1], videos, labels, gen, lr, batch)
        assert got.shape == want.shape == (3,)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ref = states[1].model.state_dict()
    for key, v in states[0].model.state_dict().items():
        assert float((v - ref[key]).abs().max()) <= 1e-5 * float(ref[key].abs().max()) + 1e-7, key
    assert engine.captures == 2
    if kind == "deep_resnet":
        launched = kernel_launches(before, [engine])
        assert launched["deep_resnet_embed_fwd"] - launched["deep_resnet_embed_bwd"] == 0
        # 8 + 4 + 4 captured steps, and the eager run's as many again
        assert launched["deep_resnet_embed_fwd"] == 2 * (8 + 4 + 4)


def _bf16_leaves(args):
    return tuple({k: v.detach().bfloat16().requires_grad_() for k, v in a.items()} if isinstance(a, dict)
                 else a.detach().bfloat16().requires_grad_() for a in args)


# Shapes (B, T, S, E) that between them launch every tile of the bf16 conv
# kernel (64 or 128 rows by 32, 64 or 128 columns, 32 or 64 channels a
# stage; csrc/conv_rows_bf16.cuh) and both weight-gradient kernels: 2,430,
# 10,140, 32,400, 38,880 and 162,240 rows, S = 9 and 13, E = 58 and 64.
BF16_TILE_SHAPES = [(1, 30, 9, 64), (1, 60, 13, 64), (16, 25, 9, 58), (16, 30, 9, 64), (16, 60, 13, 64)]


@pytest.mark.parametrize("b,t,s,e", [(1, 30, 9, 64), (1, 6, 13, 32), (3, 30, 9, 58), *BF16_TILE_SHAPES[1:]])
def test_bf16_embedding_kernels_match_plain_bf16_on_card(cuda_device, b, t, s, e):
    """K2-bf16/K3-bf16 against the plain bf16 version (bf16 products, f32
    accumulation, as the JAX kernel off its exact mode), at shapes that
    launch every tile of their wgmma kernels: the embedding bf16
    and within 1e-2 relative L2 of the plain version's, the statistics f32
    within 1e-3 of each vector's largest value, every gradient bf16 and
    within 5e-2 relative L2 (``BF16_GRAD_L2_TOL`` in ``chip_smoke.py``);
    one launch each, none of the f32 kernels. The two round at the same
    places; a value the f32 sums leave on the other side of a bf16 rounding
    boundary is what they differ by, and the BN parameters' gradients
    (sums that cancel) carry that furthest. The limit sits between two
    readings of ``bf16_kernel_spread.py`` at these shapes, six seeds each
    (``results/bf16_kernel_spread``): two sound bf16 implementations (JAX's
    kernel at exact=False against the plain version, on the CPU; the
    kernels against the plain version, on the card) differ by at most
    2.8 % at their worst gradient, and the plain version in f32 lies at
    least 8.2 % from it in bf16. The f32 control is asserted here too."""
    args = _bf16_leaves(_embedding_args(b, t, s, cuda_device, e=e))
    before = {f: f.launches for f in (*tfe.kernels_for(torch.float32), *tfe.kernels_for(torch.bfloat16))}
    out_k, st_k = tfe.fused_deep_resnet_embed(*args)
    out_r, st_r = tfe.deep_resnet_embed_reference(*args)
    assert out_k.dtype == out_r.dtype == torch.bfloat16
    rel = lambda a, r: float((a.float() - r.float()).norm() / r.float().norm())  # noqa: E731
    assert rel(out_k.detach(), out_r.detach()) <= 1e-2
    for name, _ in tfe.BN_LAYOUT:
        for k, r in zip(st_k[name], st_r[name]):
            assert k.dtype == torch.float32
            assert float((k - r).abs().max()) <= 1e-3 * float(r.abs().max())
    x, kernels, scales, biases, wfc, bfc = args
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    g = torch.randn(out_r.shape, generator=torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device).bfloat16()
    leaves32 = [v.detach().float().requires_grad_() for v in leaves]
    it = iter(leaves32[1:])
    out_f, _ = tfe.deep_resnet_embed_reference(leaves32[0], {k: next(it) for k in kernels}, {k: next(it) for k in scales},
                                               {k: next(it) for k in biases}, next(it), next(it))
    grads_r = torch.autograd.grad(out_r, leaves, g)
    grads_f = torch.autograd.grad(out_f, leaves32, g.float())
    worst_f32 = 0.0
    for a, r, f in zip(torch.autograd.grad(out_k, leaves, g), grads_r, grads_f):
        assert a.dtype == torch.bfloat16 and rel(a, r) <= 5e-2
        worst_f32 = max(worst_f32, rel(f, r))
    assert worst_f32 > 5e-2
    launched = {f: f.launches - n for f, n in before.items()}
    assert [launched[f] for f in tfe.kernels_for(torch.bfloat16)] == [1, 1]
    assert [launched[f] for f in tfe.kernels_for(torch.float32)] == [0, 0]


def test_bf16_embedding_kernels_are_bitwise_repeatable_and_reject_mixed_dtypes(cuda_device):
    """Two calls of each bf16 wrapper on the same inputs give the same bits;
    an f32 argument among bf16 ones is refused, never cast."""
    x, kernels, scales, biases, wfc, bfc = _bf16_leaves(_embedding_args(2, 30, 9, cuda_device))
    n = x.shape[0] * x.shape[1]
    args = (x.detach().reshape(n, 9, 9).contiguous(), *_packed(kernels, scales, biases, wfc, bfc))
    one, two = tfe.deep_resnet_embed_fwd_bf16(*args), tfe.deep_resnet_embed_fwd_bf16(*args)
    assert torch.equal(one[0], two[0]) and torch.equal(one[2]["y2"], two[2]["y2"])
    assert one[2]["y2"].dtype == torch.bfloat16 and one[2]["z2bp"].dtype == torch.float32
    g = torch.ones((n, 64), device=cuda_device, dtype=torch.bfloat16)
    ga, gb = (tfe.deep_resnet_embed_bwd_bf16(*args, one[2], g) for _ in range(2))
    assert torch.equal(ga[0], gb[0]) and all(torch.equal(u, v) for u, v in zip(ga[1], gb[1]))
    with pytest.raises(ValueError, match="bfloat16"):
        tfe.deep_resnet_embed_fwd_bf16(*args[:4], args[4].float(), args[5])
    with pytest.raises(ValueError, match="float32"):
        tfe.deep_resnet_embed_fwd(*args)


@pytest.mark.parametrize("m,b,t,s,e", [(7, 1, 30, 9, 64), *((2, *shape) for shape in BF16_TILE_SHAPES[1:])])
def test_bf16_embedding_kernels_repeat_and_members_equal_single_launches_at_every_tile(cuda_device, m, b, t, s, e):
    """K2-bf16/K3-bf16 over M members in one launch each, at the shapes of
    every tile: every output of member i bitwise equal to a launch for
    member i alone and to a second member launch."""
    singles, xs, gs = [], [], []
    for i in range(m):
        x, kernels, scales, biases, wfc, bfc = _bf16_leaves(_embedding_args(b, t, s, cuda_device, seed=20 + i, e=e))
        singles.append(_packed(kernels, scales, biases, wfc, bfc))
        xs.append(x.detach().reshape(b * t, s, s).contiguous())
        gs.append(torch.randn((b * t, e), generator=torch.Generator(device=cuda_device).manual_seed(i),
                              device=cuda_device).bfloat16())
    stacked = _stack_members(singles)
    x_all, g_all = torch.stack(xs), torch.stack(gs)
    emb, stats, saved = tfe.deep_resnet_embed_fwd_bf16(x_all, *stacked)
    grads = tfe.deep_resnet_embed_bwd_bf16(x_all, *stacked, saved, g_all)
    emb2, stats2, saved2 = tfe.deep_resnet_embed_fwd_bf16(x_all, *stacked)
    grads2 = tfe.deep_resnet_embed_bwd_bf16(x_all, *stacked, saved, g_all)
    assert torch.equal(emb, emb2) and all(torch.equal(saved[k], saved2[k]) for k, _ in tfe.SAVED)
    assert torch.equal(grads[0], grads2[0]) and all(torch.equal(u, v) for u, v in zip(grads[1], grads2[1]))
    for i in range(m):
        emb1, stats1, saved1 = tfe.deep_resnet_embed_fwd_bf16(xs[i], *singles[i])
        gx1, gw1, gsc1, gbi1, gwfc1, gbfc1 = tfe.deep_resnet_embed_bwd_bf16(xs[i], *singles[i], saved1, gs[i])
        assert torch.equal(emb[i], emb1), f"member {i} embedding"
        for j, (_, c) in enumerate(tfe.BN_LAYOUT):
            assert torch.equal(stats[i, j, :, :c], stats1[j, :, :c]), f"member {i} statistics {j}"
            assert torch.equal(grads[2][i, j, :c], gsc1[j, :c]) and torch.equal(grads[3][i, j, :c], gbi1[j, :c])
        for name, _ in tfe.SAVED:
            assert torch.equal(saved[name][i], saved1[name]), f"member {i} {name}"
        assert torch.equal(grads[0][i], gx1)
        for g_m, g1 in zip(grads[1], gw1):
            assert torch.equal(g_m[i], g1)
        assert torch.equal(grads[4][i], gwfc1) and torch.equal(grads[5][i], gbfc1)


def test_serving_captured_forwards_equal_eager_on_card(cuda_device):
    """The served flagship (``evaluation.serving``), f32 and bf16-cast,
    plain and with the 4-rotation TTA, captured in a CUDA graph equals its
    eager call bitwise at batch 64, and the f32 one is finite."""
    from moleculardiffusion_mivit_tpu_torch.evaluation import serving

    with torch.inference_mode():
        model = serving.initialised(serving.flagship(), 0, cuda_device)
        videos = serving.make_videos(0, 64, cuda_device)
        for fwd in (model, serving.tta(model), serving.bf16_forward(model), serving.tta(serving.bf16_forward(model))):
            s = serving.Served(fwd, (videos,))
            assert s.graph is not None
            assert torch.equal(s(), fwd(videos))
        assert bool(torch.isfinite(model(videos)).all())


def test_serving_path_launches_no_kernel_of_the_port(cuda_device, tmp_path):
    """Eval-mode forwards run cuDNN convolutions, not K2/K3 (nor K1): the
    serving entry point's sweep, TTA, bf16 cast and per-arm modes leave
    every launch counter as it was."""
    from moleculardiffusion_mivit_tpu_torch.evaluation import serving
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts

    before = launch_counts()
    serving.main(["--batches", "16", "--iters", "2", "--tta", "--bf16"])
    serving.main(["--batches", "16", "--iters", "2", "--per-arm", str(tmp_path / "t.json")])
    assert launch_counts() == before
