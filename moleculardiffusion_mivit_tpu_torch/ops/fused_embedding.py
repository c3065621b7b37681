"""K2 and K3, the DeepResNetEmbedding training forward and backward.

Port of ``moleculardiffusion_mivit_tpu/ops/fused_embedding.py``.
``fused_deep_resnet_embed`` keeps the JAX entry's signature and layouts
(conv kernels HWIO, fc kernel ``(128, E)``). On CUDA tensors it runs the
``torch.autograd.Function`` whose forward is K2 (``deep_resnet_embed_fwd``)
and whose backward is K3 (``deep_resnet_embed_bwd``), both in
``csrc/fused_embedding.cu``; on CPU tensors it runs the plain version
``deep_resnet_embed_reference``. The JAX kernel's row limit
(``FUSED_MAX_ROWS``, a TPU VMEM bound) does not apply: the CUDA kernels keep
activations in device memory and take any row count up to 2^31 / 128.

Precision is the port's own, whatever the caller's global settings. K2/K3
run their matrix products on the TF32 tensor cores as three products of
operands split into a big and a small TF32 part (f32-grade accuracy); the
plain version and the eval path run their convolutions in full f32
(``f32_convolutions`` turns cuDNN's TF32 off around them).

The image border is a table the kernels are given: ``tap_validity`` builds
it here, where the CPU tests reach it (``tests/test_torch_embedding.py``
computes a conv from it the way the kernels do, by row offsets into the
(R, C) layout, and emulates their split products).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

C0, C1, C2 = 32, 64, 128
BN_LAYOUT = (
    ("bn1", C0),
    ("rb1_bn1", C1),
    ("rb1_bn2", C1),
    ("rb1_skip", C1),
    ("rb2_bn1", C2),
    ("rb2_bn2", C2),
    ("rb2_skip", C2),
)
BN_EPS = 1e-5

# Packed weights in the kernels' argument order, with their shapes.
WEIGHT_SHAPES = (
    ("initial", (9, C0)),
    ("rb1_conv1", (9 * C0, C1)),
    ("rb1_skip", (C0, C1)),
    ("rb1_conv2", (9 * C1, C1)),
    ("rb2_conv1", (9 * C1, C2)),
    ("rb2_skip", (C1, C2)),
    ("rb2_conv2", (9 * C2, C2)),
)
# Activations the forward saves for the backward, with their widths.
SAVED = (
    ("z0", C0), ("a", C0), ("z1p", C1), ("z1", C1), ("z2p", C1), ("ip1", C1),
    ("y1", C1), ("z1bp", C2), ("z1b", C2), ("z2bp", C2), ("ip2", C2), ("y2", C2),
)
# The pointer order of csrc/fused_embedding.cu's `enum Ptr`.
PTR_ORDER = (
    "x", "initial", "rb1_conv1", "rb1_skip", "rb1_conv2", "rb2_conv1", "rb2_skip",
    "rb2_conv2", "sc", "bi", "wfc", "bfc",
    *(name for name, _ in SAVED), "pooled", "stats",
    "emb", "scratch", "valid",
    "g_emb", "gx", *("g_" + name for name, _ in WEIGHT_SHAPES), "gsc", "gbi", "gwfc", "gbfc",
    "buf_g", "buf_d1", "buf_d2",
)


# Kinds of kernel launch inside K2/K3, in the order of `enum Kind`.
STAGE_KINDS = (
    "pack_weights", "conv_tensor_core", "conv_initial", "bn_stats", "bn_act", "pool_fc",
    "wgrad_tensor_core", "wgrad_simt", "sum_chunks", "bn_backward",
)


@contextlib.contextmanager
def f32_convolutions():
    """Run the convolutions inside in full f32 on a CUDA device: cuDNN's TF32
    (on by default in PyTorch, three decimal digits) is off within the block
    and the caller's setting is restored after it. Covers the convolutions
    called inside the block; a later autograd pass through them follows the
    caller's setting."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def tap_validity(s: int) -> torch.Tensor:
    """(S*S,) int32: bit ``t = 3*(dy+1) + (dx+1)`` of entry ``h*S + w`` is set
    where pixel ``(h+dy, w+dx)`` lies inside the S x S image. In the (R, C)
    row layout tap ``t`` of row ``r`` reads row ``r + dy*S + dx``; where the
    bit is clear that row belongs to another image, or to the other end of
    an image row, and counts as zero padding."""
    h = torch.arange(s).repeat_interleave(s)
    w = torch.arange(s).repeat(s)
    bits = torch.zeros(s * s, dtype=torch.int32)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        ok = (h + dy >= 0) & (h + dy < s) & (w + dx >= 0) & (w + dx < s)
        bits |= ok.to(torch.int32) << t
    return bits


_validity_on_device = {}


def _tap_validity_on(s: int, device) -> torch.Tensor:
    key = (s, device)
    if key not in _validity_on_device:
        _validity_on_device[key] = tap_validity(s).to(device)
    return _validity_on_device[key]


def _pack_w3(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, cin, cout) → (9·cin, cout), tap-major rows."""
    return k.reshape(9 * k.shape[2], k.shape[3])


def _pack_rows(vecs) -> torch.Tensor:
    """Per-BN channel vectors → a (7, 128) array in BN_LAYOUT order."""
    return torch.stack([F.pad(v, (0, C2 - v.shape[0])) for v in vecs])


def deep_resnet_embed_reference(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias, relu=F.relu):
    """Plain PyTorch version of K2: the train-mode forward with ``F.conv2d``
    (in full f32 on a CUDA device too, see ``f32_convolutions``) and
    batch-statistics BN. Arguments as ``fused_deep_resnet_embed``;
    ``relu`` is called on the 5 pre-activations in forward order (a check
    may pass one that applies a given ReLU pattern).
    Returns ``(emb (B, T, E), {name: (batch_mean, biased batch_var)})``."""
    b, t, h, w = x.shape
    stats = {}

    def conv(y, k, pad):
        with f32_convolutions():
            return F.conv2d(y, k.permute(3, 2, 0, 1), padding=pad)

    def bn(z, name):
        mean = z.mean(dim=(0, 2, 3))
        var = z.var(dim=(0, 2, 3), correction=0)
        stats[name] = (mean.detach(), var.detach())
        xh = (z - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
        return xh * bn_scales[name][None, :, None, None] + bn_biases[name][None, :, None, None]

    def block(y, p):
        z = relu(bn(conv(y, kernels[p + "_conv1"], 1), p + "_bn1"))
        z = bn(conv(z, kernels[p + "_conv2"], 1), p + "_bn2")
        idn = bn(conv(y, kernels[p + "_skip"], 0), p + "_skip")
        return relu(z + idn)

    y = x.reshape(b * t, 1, h, w)
    y = relu(bn(conv(y, kernels["initial"], 1), "bn1"))
    y = block(block(y, "rb1"), "rb2")
    pooled = y.mean(dim=(2, 3)).reshape(b, t, C2)
    return pooled @ fc_kernel + fc_bias, {name: stats[name] for name, _ in BN_LAYOUT}


def _lib():
    from moleculardiffusion_mivit_tpu_torch.ops._build import load_library

    lib = load_library("fused_embedding")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.deep_resnet_embed_fwd, lib.deep_resnet_embed_bwd):
            fn.argtypes = [p, i, i, i, p]
            fn.restype = i
        lib.deep_resnet_num_ptrs.restype = i
        lib.deep_resnet_scratch_floats.argtypes = [i]
        lib.deep_resnet_scratch_floats.restype = ctypes.c_longlong
        lib.deep_resnet_last_launches.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.deep_resnet_last_launches.restype = i
        if lib.deep_resnet_num_ptrs() != len(PTR_ORDER):
            raise RuntimeError("csrc/fused_embedding.cu and PTR_ORDER disagree")
        lib._typed = True
    return lib


def _check(name, t, device, shape):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x, weights, sc, bi, wfc, bfc):
    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (N, S, S) images, got {tuple(x.shape)}")
    n, s = x.shape[0], x.shape[1]
    e = wfc.shape[-1]
    dev = x.device
    _check("x", x, dev, (n, s, s))
    for (name, shape), w in zip(WEIGHT_SHAPES, weights, strict=True):
        _check(name, w, dev, shape)
    _check("bn scales", sc, dev, (7, C2))
    _check("bn biases", bi, dev, (7, C2))
    _check("fc kernel", wfc, dev, (C2, e))
    _check("fc bias", bfc, dev, (e,))
    if not 1 <= e <= 256:
        raise ValueError(f"embed dim {e} outside the kernels' 1..256")
    if n < 1 or n * s * s * C2 >= 2**31:
        raise ValueError(f"{n * s * s} activation rows outside the kernels' range")
    return n, s, e


def _launch(fn, tensors, n, s, e, device):
    ptrs = [tensors[name].data_ptr() if name in tensors else 0 for name in PTR_ORDER]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), n, s, e, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed (cudaError {err})")


def last_stage_launches() -> dict:
    """Kernel launches inside the last K2 or K3 call, by ``STAGE_KINDS``."""
    counts = (ctypes.c_int * len(STAGE_KINDS))()
    if _lib().deep_resnet_last_launches(counts) != len(STAGE_KINDS):
        raise RuntimeError("csrc/fused_embedding.cu and STAGE_KINDS disagree")
    return dict(zip(STAGE_KINDS, counts))


def deep_resnet_embed_fwd(x, weights, sc, bi, wfc, bfc):
    """K2 on CUDA tensors: ``x (N, S, S)``, the 7 packed conv weights
    (``WEIGHT_SHAPES``), packed BN scales and biases ``(7, 128)``, fc kernel
    ``(128, E)`` and bias ``(E,)``. Returns ``(emb (N, E), stats (7, 3, 128),
    saved)``: stats hold per BN the batch mean, biased variance and rstd;
    ``saved`` the activations K3 reads. Adds one to
    ``deep_resnet_embed_fwd.launches``."""
    n, s, e = _check_inputs(x, weights, sc, bi, wfc, bfc)
    lib = _lib()
    r, dev = n * s * s, x.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    saved = {name: empty(r, c) for name, c in SAVED}
    saved["pooled"] = empty(n, C2)
    saved["stats"] = empty(7, 3, C2)
    emb = empty(n, e)
    tensors = dict(
        x=x, sc=sc, bi=bi, wfc=wfc, bfc=bfc, emb=emb,
        scratch=empty(lib.deep_resnet_scratch_floats(r)), valid=_tap_validity_on(s, dev),
        **{name: w for (name, _), w in zip(WEIGHT_SHAPES, weights)}, **saved,
    )
    _launch(lib.deep_resnet_embed_fwd, tensors, n, s, e, dev)
    deep_resnet_embed_fwd.launches += 1
    return emb, saved["stats"], saved


def deep_resnet_embed_bwd(x, weights, sc, bi, wfc, bfc, saved, g_emb):
    """K3 on CUDA tensors: the gradient of K2's ``emb`` for ``x`` and every
    parameter, given K2's inputs, its ``saved`` activations and ``g_emb
    (N, E)``. Returns ``(gx, g_weights (7), gsc, gbi, gwfc, gbfc)`` in the
    packed layouts (the unused tail of each ``(7, 128)`` BN row is
    undefined). Adds one to ``deep_resnet_embed_bwd.launches``."""
    n, s, e = _check_inputs(x, weights, sc, bi, wfc, bfc)
    _check("g_emb", g_emb, x.device, (n, e))
    r = n * s * s
    for name, c in SAVED:
        _check(name, saved[name], x.device, (r, c))
    _check("pooled", saved["pooled"], x.device, (n, C2))
    _check("stats", saved["stats"], x.device, (7, 3, C2))
    lib = _lib()
    dev = x.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    grads = {"g_" + name: empty(*shape) for name, shape in WEIGHT_SHAPES}
    out = dict(gx=empty(n, s, s), gsc=empty(7, C2), gbi=empty(7, C2), gwfc=empty(C2, e), gbfc=empty(e))
    tensors = dict(
        x=x, sc=sc, bi=bi, wfc=wfc, bfc=bfc, g_emb=g_emb,
        scratch=empty(lib.deep_resnet_scratch_floats(r)), valid=_tap_validity_on(s, dev),
        buf_g=empty(r, C2), buf_d1=empty(r, C2), buf_d2=empty(r, C2),
        **{name: w for (name, _), w in zip(WEIGHT_SHAPES, weights)}, **saved, **grads, **out,
    )
    _launch(lib.deep_resnet_embed_bwd, tensors, n, s, e, dev)
    deep_resnet_embed_bwd.launches += 1
    g_weights = tuple(grads["g_" + name] for name, _ in WEIGHT_SHAPES)
    return out["gx"], g_weights, out["gsc"], out["gbi"], out["gwfc"], out["gbfc"]


deep_resnet_embed_fwd.launches = 0
deep_resnet_embed_bwd.launches = 0


class _DeepResNetCore(torch.autograd.Function):
    """K2 forward, K3 backward. The BN statistics are a non-differentiable
    output, as in the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, w0, w1, w2, w3, w4, w5, w6, sc, bi, wfc, bfc):
        args = [t.contiguous() for t in (x, w0, w1, w2, w3, w4, w5, w6, sc, bi, wfc, bfc)]
        emb, stats, saved = deep_resnet_embed_fwd(args[0], tuple(args[1:8]), *args[8:])
        ctx.save_for_backward(*args, *(saved[name] for name, _ in SAVED), saved["pooled"], stats)
        ctx.mark_non_differentiable(stats)
        return emb, stats

    @staticmethod
    def backward(ctx, g_emb, _g_stats):
        t = ctx.saved_tensors
        args, rest = t[:12], t[12:]
        saved = {name: v for (name, _), v in zip(SAVED, rest)}
        saved["pooled"], saved["stats"] = rest[-2], rest[-1]
        gx, gw, gsc, gbi, gwfc, gbfc = deep_resnet_embed_bwd(
            args[0], tuple(args[1:8]), *args[8:], saved, g_emb.contiguous()
        )
        return (gx, *gw, gsc, gbi, gwfc, gbfc)


def fused_deep_resnet_embed(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias):
    """Training-mode DeepResNetEmbedding forward.

    ``x``: (B, T, S, S). ``kernels``: HWIO conv kernels keyed ``initial``
    (3,3,1,32), ``rb1_conv1`` (3,3,32,64), ``rb1_conv2``, ``rb1_skip``
    (1,1,32,64), ``rb2_conv1``, ``rb2_conv2``, ``rb2_skip``.
    ``bn_scales``/``bn_biases``: (C,) vectors keyed by BN_LAYOUT names.
    Returns ``(emb (B, T, E), {name: (batch_mean, batch_var)})``; the caller
    applies the running-stat EMA. Differentiable in every argument but the
    statistics. CUDA tensors run K2/K3, CPU tensors the plain version.
    """
    if not x.is_cuda:
        return deep_resnet_embed_reference(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias)
    b, t, h, w = x.shape
    if h != w:
        raise ValueError("square patches only")
    e = fc_kernel.shape[1]
    weights = [
        kernels["initial"].reshape(9, C0),
        _pack_w3(kernels["rb1_conv1"]),
        kernels["rb1_skip"].reshape(C0, C1),
        _pack_w3(kernels["rb1_conv2"]),
        _pack_w3(kernels["rb2_conv1"]),
        kernels["rb2_skip"].reshape(C1, C2),
        _pack_w3(kernels["rb2_conv2"]),
    ]
    emb, stats = _DeepResNetCore.apply(
        x.reshape(b * t, h, w),
        *weights,
        _pack_rows([bn_scales[k] for k, _ in BN_LAYOUT]),
        _pack_rows([bn_biases[k] for k, _ in BN_LAYOUT]),
        fc_kernel,
        fc_bias,
    )
    bn_stats = {name: (stats[i, 0, :c], stats[i, 1, :c]) for i, (name, c) in enumerate(BN_LAYOUT)}
    return emb.reshape(b, t, e), bn_stats
