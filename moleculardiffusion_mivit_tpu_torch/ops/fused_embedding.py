"""K2 and K3, the DeepResNetEmbedding training forward and backward.

Port of ``moleculardiffusion_mivit_tpu/ops/fused_embedding.py``.
``fused_deep_resnet_embed`` keeps the JAX entry's signature and layouts
(conv kernels HWIO, fc kernel ``(128, E)``). On CUDA tensors it runs the
``torch.autograd.Function`` whose forward is K2 (``deep_resnet_embed_fwd``)
and whose backward is K3 (``deep_resnet_embed_bwd``), both in
``csrc/fused_embedding.cu``; on CPU tensors it runs the plain version
``deep_resnet_embed_reference``. The JAX kernel's row limit
(``FUSED_MAX_ROWS``, a TPU VMEM bound) does not apply: the CUDA kernels keep
activations in device memory and take any row count up to 2^31 / 128 a
member.

Members. K2 and K3 also take a stack of M independent members (a leading
axis on every argument: each member its own rows, weights, BN statistics
and gradients) in one launch sequence, each member's result bitwise the
result of a call for that member alone. Under ``torch.vmap`` (a model grid,
``train/grid.py``) the embedding's ``torch.autograd.Function`` has a vmap
rule that moves the vmapped axis of every argument to the front and applies
the same function once with it as the member axis: one K2 and one K3 launch
a grid step, never one per member. JAX gets the same from ``pallas_call``'s
batching rule, which adds a grid axis over the members.

Precision is the port's own, whatever the caller's global settings. K2/K3
run their matrix products on the TF32 tensor cores as three products of
operands split into a big and a small TF32 part (f32-grade accuracy); the
plain version and the eval path run their convolutions in full f32 with
deterministic algorithms (``f32_convolutions`` sets cuDNN so around them).

bf16. With bf16 arguments (``TrainConfig.compute_dtype="bfloat16"``) the
function computes what the JAX kernel computes on the TPU (``exact=False``):
every conv, skip-conv, pool and fc product takes bf16 operands and
accumulates in f32; the initial conv (one input channel, not a product),
the conv outputs, BatchNorm and its statistics stay f32; the embedding
comes out in bf16 and every gradient in its input's dtype. The backward
rounds the gradient that enters a product to bf16, as the JAX kernel's
backward does. On CUDA tensors that is K2-bf16/K3-bf16
(``deep_resnet_embed_fwd_bf16``/``_bwd_bf16``, one bf16 ``mma.sync`` per
product); on CPU tensors the plain version with the same rounding. Any
other dtype raises.

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
from torch.utils.flop_counter import register_flop_formula

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
# The saved post-ReLU activations: only products read them, so the bf16
# kernels keep them in bf16 (the rounding the next product makes anyway).
# The pre-BN conv outputs stay f32.
SAVED_OPERANDS = ("a", "z1", "y1", "z1b", "y2")
# Multiply-adds per activation row of the six convs at 32..128 channels.
CONV_MACS_PER_ROW = 9 * C0 * C1 + C0 * C1 + 9 * C1 * C1 + 9 * C1 * C2 + C1 * C2 + 9 * C2 * C2


def embedding_flops(rows: int, images: int, embed_dim: int) -> int:
    """Operations of one K2 call (the embedding's training forward) on
    ``rows`` activation rows of ``images`` frames: the initial conv (1 → 32,
    3×3), the six convs on the tensor cores and the fc, two per
    multiply-add. K3 runs a data-gradient and a weight-gradient product per
    conv and fc: twice this."""
    return 2 * rows * 9 * C0 + 2 * rows * CONV_MACS_PER_ROW + 2 * images * C2 * embed_dim


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
    """Run the convolutions inside in full f32 and with deterministic
    algorithms on a CUDA device: cuDNN's TF32 (on by default in PyTorch,
    three decimal digits) is off within the block, cuDNN picks only
    algorithms that give the same bits on every run (its default choice for
    some weight gradients adds with atomics, so two training runs from one
    seed drift apart), and the caller's settings are restored after it.
    Covers the convolutions called inside the block; a later autograd pass
    through them follows the caller's settings."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = old


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


class _RoundGradient(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to bf16.
    On a product's output it puts the rounding where the JAX kernel's
    backward puts it: on the gradient before the product's transposes."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v):
        return v.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().float()


def _round_bf16(v):
    """``v`` rounded to bf16 (kept in f32), with the gradient passed through
    unrounded: ``v + (bf16(v) - v)`` is exactly ``bf16(v)`` in f32."""
    return v + (v.bfloat16().float() - v).detach()


def deep_resnet_embed_reference(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias, relu=F.relu):
    """Plain PyTorch version of K2: the train-mode forward with ``F.conv2d``
    (in full f32 on a CUDA device too, see ``f32_convolutions``) and
    batch-statistics BN. Arguments as ``fused_deep_resnet_embed``;
    ``relu`` is called on the 5 pre-activations in forward order (a check
    may pass one that applies a given ReLU pattern). With bf16 arguments
    every product rounds its operands to bf16 and accumulates in f32, and
    its backward rounds the gradient that enters it (the module docstring).
    Returns ``(emb (B, T, E), {name: (batch_mean, biased batch_var)})``,
    the embedding in ``x``'s dtype and the statistics in f32."""
    b, t, h, w = x.shape
    dtype = x.dtype
    if dtype == torch.bfloat16:
        operand, product, work = _round_bf16, _RoundGradient.apply, torch.float32
    elif dtype in (torch.float32, torch.float64):  # float64: a check's exact arithmetic
        operand = product = lambda v: v  # noqa: E731
        work = dtype
    else:
        raise ValueError(f"fused_deep_resnet_embed takes float32 or bfloat16, got {dtype}")
    stats = {}

    def conv(y, k, pad):
        with f32_convolutions():
            return F.conv2d(y, k.to(work).permute(3, 2, 0, 1), padding=pad)

    def dot_conv(y, k, pad):
        return product(conv(operand(y), operand(k.to(work)), pad))

    def bn(z, name):
        mean = z.mean(dim=(0, 2, 3))
        var = z.var(dim=(0, 2, 3), correction=0)
        stats[name] = (mean.detach(), var.detach())
        xh = (z - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
        return xh * bn_scales[name].to(work)[None, :, None, None] + bn_biases[name].to(work)[None, :, None, None]

    def block(y, p):
        z = relu(bn(dot_conv(y, kernels[p + "_conv1"], 1), p + "_bn1"))
        z = bn(dot_conv(z, kernels[p + "_conv2"], 1), p + "_bn2")
        idn = bn(dot_conv(y, kernels[p + "_skip"], 0), p + "_skip")
        return relu(z + idn)

    y = x.to(work).reshape(b * t, 1, h, w)
    y = relu(bn(conv(y, kernels["initial"], 1), "bn1"))
    y = block(block(y, "rb1"), "rb2")
    if dtype == torch.bfloat16:  # the JAX kernel's pool is a product with bf16(1 / S²)
        scale = float(torch.tensor(1.0 / (h * w)).bfloat16())
        pooled = product(operand(y).sum(dim=(2, 3)) * scale)
    else:
        pooled = y.mean(dim=(2, 3))
    pooled = pooled.reshape(b, t, C2)
    emb = product(operand(pooled) @ operand(fc_kernel.to(work))) + fc_bias.to(work)
    return emb.to(dtype), {name: stats[name] for name, _ in BN_LAYOUT}


def _lib():
    from moleculardiffusion_mivit_tpu_torch.ops._build import load_library

    lib = load_library("fused_embedding")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.deep_resnet_embed_fwd, lib.deep_resnet_embed_bwd,
                   lib.deep_resnet_embed_fwd_bf16, lib.deep_resnet_embed_bwd_bf16):
            fn.argtypes = [p, p, i, i, i, i, p]
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


def _check(name, t, device, shape, dtype=torch.float32):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x, weights, sc, bi, wfc, bfc, dtype):
    """``(lead, m, n, s, e)``: ``lead`` is ``()`` for one member (``x (N, S,
    S)``) and ``(M,)`` for a stack (``x (M, N, S, S)``, every other argument
    with the same leading axis). Every argument is of ``dtype``."""
    if x.ndim not in (3, 4) or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"x must be (N, S, S) images or (M, N, S, S) members, got {tuple(x.shape)}")
    lead = tuple(x.shape[:-3])
    m = lead[0] if lead else 1
    n, s = x.shape[-3], x.shape[-1]
    e = wfc.shape[-1]
    dev = x.device
    _check("x", x, dev, lead + (n, s, s), dtype)
    for (name, shape), w in zip(WEIGHT_SHAPES, weights, strict=True):
        _check(name, w, dev, lead + shape, dtype)
    _check("bn scales", sc, dev, lead + (7, C2), dtype)
    _check("bn biases", bi, dev, lead + (7, C2), dtype)
    _check("fc kernel", wfc, dev, lead + (C2, e), dtype)
    _check("fc bias", bfc, dev, lead + (e,), dtype)
    if not 1 <= e <= 256:
        raise ValueError(f"embed dim {e} outside the kernels' 1..256")
    if n < 1 or n * s * s * C2 >= 2**31:
        raise ValueError(f"{n * s * s} activation rows outside the kernels' range")
    if not 1 <= m <= 65535:
        raise ValueError(f"{m} members outside the kernels' 1..65535")
    return lead, m, n, s, e


def _launch(fn, tensors, m, n, s, e, device):
    """Call an entry with the pointer of every array in ``PTR_ORDER`` and,
    beside it, its member stride (elements a member holds; the tap-validity
    table is shared)."""
    ptrs = [tensors[name].data_ptr() if name in tensors else 0 for name in PTR_ORDER]
    strides = [tensors[name].numel() // m if name in tensors and name != "valid" else 0 for name in PTR_ORDER]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    ms = (ctypes.c_longlong * len(strides))(*strides)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), ctypes.cast(ms, ctypes.c_void_p), m, n, s, e, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed (cudaError {err})")


def last_stage_launches() -> dict:
    """Kernel launches inside the last K2 or K3 call, by ``STAGE_KINDS``."""
    counts = (ctypes.c_int * len(STAGE_KINDS))()
    if _lib().deep_resnet_last_launches(counts) != len(STAGE_KINDS):
        raise RuntimeError("csrc/fused_embedding.cu and STAGE_KINDS disagree")
    return dict(zip(STAGE_KINDS, counts))


def _saved_dtype(name, dtype):
    return dtype if name in SAVED_OPERANDS else torch.float32


def _fwd(entry, dtype, x, weights, sc, bi, wfc, bfc):
    lead, m, n, s, e = _check_inputs(x, weights, sc, bi, wfc, bfc, dtype)
    lib = _lib()
    r, dev = n * s * s, x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(lead + shape, dtype=dtype, device=dev)

    saved = {name: empty(r, c, dtype=_saved_dtype(name, dtype)) for name, c in SAVED}
    saved["pooled"] = empty(n, C2)
    saved["stats"] = empty(7, 3, C2)
    emb = empty(n, e, dtype=dtype)
    tensors = dict(
        x=x, sc=sc, bi=bi, wfc=wfc, bfc=bfc, emb=emb,
        scratch=empty(lib.deep_resnet_scratch_floats(r)), valid=_tap_validity_on(s, dev),
        **{name: w for (name, _), w in zip(WEIGHT_SHAPES, weights)}, **saved,
    )
    _launch(getattr(lib, entry), tensors, m, n, s, e, dev)
    return emb, saved["stats"], saved


def _bwd(entry, dtype, x, weights, sc, bi, wfc, bfc, saved, g_emb):
    lead, m, n, s, e = _check_inputs(x, weights, sc, bi, wfc, bfc, dtype)
    _check("g_emb", g_emb, x.device, lead + (n, e), dtype)
    r = n * s * s
    for name, c in SAVED:
        _check(name, saved[name], x.device, lead + (r, c), _saved_dtype(name, dtype))
    _check("pooled", saved["pooled"], x.device, lead + (n, C2))
    _check("stats", saved["stats"], x.device, lead + (7, 3, C2))
    lib = _lib()
    dev = x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(lead + shape, dtype=dtype, device=dev)

    grads = {"g_" + name: empty(*shape, dtype=dtype) for name, shape in WEIGHT_SHAPES}
    out = dict(gx=empty(n, s, s, dtype=dtype), gsc=empty(7, C2, dtype=dtype), gbi=empty(7, C2, dtype=dtype),
               gwfc=empty(C2, e, dtype=dtype), gbfc=empty(e, dtype=dtype))
    tensors = dict(
        x=x, sc=sc, bi=bi, wfc=wfc, bfc=bfc, g_emb=g_emb,
        scratch=empty(lib.deep_resnet_scratch_floats(r)), valid=_tap_validity_on(s, dev),
        buf_g=empty(r, C2), buf_d1=empty(r, C2, dtype=dtype), buf_d2=empty(r, C2, dtype=dtype),
        **{name: w for (name, _), w in zip(WEIGHT_SHAPES, weights)}, **saved, **grads, **out,
    )
    _launch(getattr(lib, entry), tensors, m, n, s, e, dev)
    g_weights = tuple(grads["g_" + name] for name, _ in WEIGHT_SHAPES)
    return out["gx"], g_weights, out["gsc"], out["gbi"], out["gwfc"], out["gbfc"]


def deep_resnet_embed_fwd(x, weights, sc, bi, wfc, bfc):
    """K2 on CUDA tensors: ``x (N, S, S)``, the 7 packed conv weights
    (``WEIGHT_SHAPES``), packed BN scales and biases ``(7, 128)``, fc kernel
    ``(128, E)`` and bias ``(E,)``, all f32. Returns ``(emb (N, E), stats
    (7, 3, 128), saved)``: stats hold per BN the batch mean, biased variance
    and rstd; ``saved`` the activations K3 reads. With a leading member axis
    ``M`` on every argument, every result has it too, and each member's
    statistics are over its own rows. Adds one to
    ``deep_resnet_embed_fwd.launches``."""
    out = _fwd("deep_resnet_embed_fwd", torch.float32, x, weights, sc, bi, wfc, bfc)
    deep_resnet_embed_fwd.launches += 1
    return out


def deep_resnet_embed_fwd_bf16(x, weights, sc, bi, wfc, bfc):
    """K2-bf16: ``deep_resnet_embed_fwd`` with every argument in bf16 and the
    JAX kernel's ``exact=False`` arithmetic (module docstring). The
    embedding comes out in bf16, the statistics in f32, the saved post-ReLU
    activations (``SAVED_OPERANDS``) in bf16. Adds one to
    ``deep_resnet_embed_fwd_bf16.launches``."""
    out = _fwd("deep_resnet_embed_fwd_bf16", torch.bfloat16, x, weights, sc, bi, wfc, bfc)
    deep_resnet_embed_fwd_bf16.launches += 1
    return out


def deep_resnet_embed_bwd(x, weights, sc, bi, wfc, bfc, saved, g_emb):
    """K3 on CUDA tensors: the gradient of K2's ``emb`` for ``x`` and every
    parameter, given K2's inputs, its ``saved`` activations and ``g_emb
    (N, E)``. Returns ``(gx, g_weights (7), gsc, gbi, gwfc, gbfc)`` in the
    packed layouts (the unused tail of each ``(7, 128)`` BN row is
    undefined); with a member axis on the arguments, on every result too.
    Adds one to ``deep_resnet_embed_bwd.launches``."""
    out = _bwd("deep_resnet_embed_bwd", torch.float32, x, weights, sc, bi, wfc, bfc, saved, g_emb)
    deep_resnet_embed_bwd.launches += 1
    return out


def deep_resnet_embed_bwd_bf16(x, weights, sc, bi, wfc, bfc, saved, g_emb):
    """K3-bf16: ``deep_resnet_embed_bwd`` on K2-bf16's arguments and saved
    activations, ``g_emb`` in bf16; every gradient comes out in bf16. Adds
    one to ``deep_resnet_embed_bwd_bf16.launches``."""
    out = _bwd("deep_resnet_embed_bwd_bf16", torch.bfloat16, x, weights, sc, bi, wfc, bfc, saved, g_emb)
    deep_resnet_embed_bwd_bf16.launches += 1
    return out


for _fn in (deep_resnet_embed_fwd, deep_resnet_embed_bwd, deep_resnet_embed_fwd_bf16, deep_resnet_embed_bwd_bf16):
    _fn.launches = 0


def kernels_for(dtype):
    """The K2 and K3 wrappers that take ``dtype`` (the module's names, read
    when called)."""
    if dtype == torch.float32:
        return deep_resnet_embed_fwd, deep_resnet_embed_bwd
    if dtype == torch.bfloat16:
        return deep_resnet_embed_fwd_bf16, deep_resnet_embed_bwd_bf16
    raise ValueError(f"fused_deep_resnet_embed takes float32 or bfloat16, got {dtype}")


class _DeepResNetCore(torch.autograd.Function):
    """K2 forward, K3 backward (K2-bf16/K3-bf16 for bf16 arguments), on one
    member (``x (N, S, S)``) or a stack (``x (M, N, S, S)``, a member axis
    on every argument). Outputs: the
    embedding, the BN statistics and K2's saved activations; all but the
    embedding are non-differentiable (the statistics as in the JAX
    ``custom_vjp``). Under ``torch.vmap`` the rule ``vmap`` applies this
    function once with the vmapped axis as the member axis."""

    @staticmethod
    def forward(x, w0, w1, w2, w3, w4, w5, w6, sc, bi, wfc, bfc):
        args = [t.contiguous() for t in (x, w0, w1, w2, w3, w4, w5, w6, sc, bi, wfc, bfc)]
        fwd, _ = kernels_for(x.dtype)
        emb, stats, saved = fwd(args[0], tuple(args[1:8]), *args[8:])
        return (emb, stats, *(saved[name] for name, _ in SAVED), saved["pooled"])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output[1:])
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g_emb, *_):
        t = ctx.saved_tensors
        args, stats, rest = [a.contiguous() for a in t[:12]], t[12], t[13:]
        saved = {name: v for (name, _), v in zip(SAVED, rest)}
        saved["pooled"], saved["stats"] = rest[-1], stats
        if g_emb is None:  # the embedding does not reach the loss
            return (None,) * len(args)
        _, bwd = kernels_for(args[0].dtype)
        gx, gw, gsc, gbi, gwfc, gbfc = bwd(args[0], tuple(args[1:8]), *args[8:], saved, g_emb.contiguous())
        return (gx, *gw, gsc, gbi, gwfc, gbfc)

    @staticmethod
    def vmap(info, in_dims, *args):
        members = [
            a.movedim(d, 0) if d is not None else a.expand(info.batch_size, *a.shape)
            for a, d in zip(args, in_dims)
        ]
        out = _DeepResNetCore.apply(*members)
        return out, (0,) * len(out)


def fused_deep_resnet_embed(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias):
    """Training-mode DeepResNetEmbedding forward.

    ``x``: (B, T, S, S). ``kernels``: HWIO conv kernels keyed ``initial``
    (3,3,1,32), ``rb1_conv1`` (3,3,32,64), ``rb1_conv2``, ``rb1_skip``
    (1,1,32,64), ``rb2_conv1``, ``rb2_conv2``, ``rb2_skip``.
    ``bn_scales``/``bn_biases``: (C,) vectors keyed by BN_LAYOUT names.
    Returns ``(emb (B, T, E), {name: (batch_mean, batch_var)})``; the caller
    applies the running-stat EMA. Differentiable in every argument but the
    statistics. Every argument is f32 or every one bf16 (module docstring);
    the embedding comes out in that dtype, the statistics in f32. CUDA
    tensors run K2/K3 (K2-bf16/K3-bf16), CPU tensors the plain version, meta
    tensors the shape-only ops below.
    """
    if x.device.type == "meta":
        return _shapes_embed(x, fc_kernel)
    if not x.is_cuda:
        return deep_resnet_embed_reference(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias)
    return _kernel_embed(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias)


# Meta tensors (shapes only; ``utils.flops`` counts a step on them) take two
# ops that make the outputs' shapes and carry K2's operation count forward
# and K3's (twice K2's) backward as flop formulas, which
# ``torch.utils.flop_counter.FlopCounterMode`` reads: the counter cannot see
# the ctypes kernels, and the plain version's products are not theirs.
@torch.library.custom_op("mivit_torch::embed_shapes", mutates_args=())
def _embed_shapes(x: torch.Tensor, fc_kernel: torch.Tensor) -> torch.Tensor:
    raise ValueError("embed_shapes takes meta tensors only")


@torch.library.custom_op("mivit_torch::embed_shapes_bwd", mutates_args=())
def _embed_shapes_bwd(x: torch.Tensor, fc_kernel: torch.Tensor, g_emb: torch.Tensor) -> torch.Tensor:
    raise ValueError("embed_shapes_bwd takes meta tensors only")


@_embed_shapes.register_fake
def _(x, fc_kernel):
    return x.new_empty((*x.shape[:2], fc_kernel.shape[1]))


@_embed_shapes_bwd.register_fake
def _(x, fc_kernel, g_emb):
    return fc_kernel.new_empty(fc_kernel.shape)


_embed_shapes.register_autograd(lambda ctx, g: (None, _embed_shapes_bwd(*ctx.saved_tensors, g)),
                                setup_context=lambda ctx, inputs, output: ctx.save_for_backward(*inputs))


def _shapes_flops(x_shape, fc_shape) -> int:
    b, t, s, _ = x_shape
    return embedding_flops(b * t * s * s, b * t, fc_shape[1])


@register_flop_formula(torch.ops.mivit_torch.embed_shapes)
def _embed_shapes_flops(x_shape, fc_shape, out_shape=None, **kwargs) -> int:
    return _shapes_flops(x_shape, fc_shape)


@register_flop_formula(torch.ops.mivit_torch.embed_shapes_bwd)
def _embed_shapes_bwd_flops(x_shape, fc_shape, g_shape, out_shape=None, **kwargs) -> int:
    return 2 * _shapes_flops(x_shape, fc_shape)


def _shapes_embed(x, fc_kernel):
    """``fused_deep_resnet_embed`` on meta tensors: the embedding's shape
    (differentiable in the fc kernel, so the backward reaches K3's count)
    and zero statistics."""
    stats = {name: (x.new_zeros(c, dtype=torch.float32),) * 2 for name, c in BN_LAYOUT}
    return _embed_shapes(x, fc_kernel), stats


def _kernel_embed(x, kernels, bn_scales, bn_biases, fc_kernel, fc_bias):
    """``fused_deep_resnet_embed`` through ``_DeepResNetCore`` (K2/K3): the
    weights packed as the kernels take them, the output unpacked."""
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
    emb, stats, *_ = _DeepResNetCore.apply(
        x.reshape(b * t, h, w),
        *weights,
        _pack_rows([bn_scales[k] for k, _ in BN_LAYOUT]),
        _pack_rows([bn_biases[k] for k, _ in BN_LAYOUT]),
        fc_kernel,
        fc_bias,
    )
    bn_stats = {name: (stats[i, 0, :c], stats[i, 1, :c]) for i, (name, c) in enumerate(BN_LAYOUT)}
    return emb.reshape(b, t, e), bn_stats
