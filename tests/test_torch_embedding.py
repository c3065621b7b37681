"""Kernels K2/K3 (the deep-ResNet embedding's training forward and backward)
and their plain version against the JAX package: the flax module in train
and eval mode, and once, at a tiny shape, the Pallas kernel in interpret
mode with its custom-VJP gradients. K2/K3 themselves are held against the
plain version on the card in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.models.embeddings import DeepResNetEmbedding as JEmbedding
from moleculardiffusion_mivit_tpu.ops.fused_embedding import fused_deep_resnet_embed as j_fused
from moleculardiffusion_mivit_tpu_torch.models.embeddings import DeepResNetEmbedding as TEmbedding
from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as tfe
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

_BN_PATHS = {
    "bn1": ("bn1",),
    "rb1_bn1": ("res_block1", "bn1"), "rb1_bn2": ("res_block1", "bn2"), "rb1_skip": ("res_block1", "skip_bn"),
    "rb2_bn1": ("res_block2", "bn1"), "rb2_bn2": ("res_block2", "bn2"), "rb2_skip": ("res_block2", "skip_bn"),
}
_CONV_PATHS = {
    "initial": ("initial_conv",),
    "rb1_conv1": ("res_block1", "conv1"), "rb1_conv2": ("res_block1", "conv2"),
    "rb1_skip": ("res_block1", "skip_conv"),
    "rb2_conv1": ("res_block2", "conv1"), "rb2_conv2": ("res_block2", "conv2"),
    "rb2_skip": ("res_block2", "skip_conv"),
}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(b, t, s, e=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.normal(size=(b, t, s, s)) + 0.1).astype(np.float32)
    jmod = JEmbedding(patch_size=s, embed_dim=e)
    variables = jax.jit(lambda k, xx: jmod.init(k, xx, train=True))(jax.random.key(seed), jnp.asarray(x))
    # non-trivial BN affine parameters and running statistics
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jax.random.normal(jax.random.key(len(str(p))), v.shape)
        if p[-1].key in ("scale", "bias") else v,
        variables["params"],
    )
    return x, jmod, {"params": params, "batch_stats": variables["batch_stats"]}


def _apply_train(jmod, variables, x):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, xx: jmod.apply(v, xx, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x)
        )


def _port(variables, s, e=64):
    mod = TEmbedding(s, e)
    mod.load_state_dict(torch_state_from_flax(_np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    return mod


@pytest.mark.parametrize("b,t,s", [(2, 5, 9), (1, 4, 13)])
def test_train_forward_and_running_stats_match_flax(b, t, s):
    """Train mode: the output and the 7 running-statistics EMA updates equal
    flax's (biased batch variance, momentum 0.9 on the old value)."""
    x, jmod, variables = _setup(b, t, s)
    ref, mut = _apply_train(jmod, variables, x)
    mod = _port(variables, s).train()
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    new = mod.state_dict()
    for name, path in _BN_PATHS.items():
        stats = _at(mut["batch_stats"], path)
        prefix = ".".join(path)
        for flax_key, torch_key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                new[f"{prefix}.{torch_key}"].numpy(), np.asarray(stats[flax_key]),
                rtol=2e-4, atol=2e-4, err_msg=f"{name} {flax_key}",
            )


def test_eval_forward_matches_flax():
    x, jmod, variables = _setup(2, 5, 9)
    # move the running statistics away from their (0, 1) init
    _, mut = _apply_train(jmod, variables, x)
    variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, xx: jmod.apply(v, xx, train=False))(variables, jnp.asarray(x))
    mod = _port(variables, 9).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _kernel_args(params):
    kernels = {k: _at(params, p)["kernel"] for k, p in _CONV_PATHS.items()}
    scales = {k: _at(params, p)["scale"] for k, p in _BN_PATHS.items()}
    biases = {k: _at(params, p)["bias"] for k, p in _BN_PATHS.items()}
    return kernels, scales, biases, params["fc"]["kernel"], params["fc"]["bias"]


def test_plain_version_matches_pallas_kernel_and_its_gradients():
    """At a tiny shape: the plain version against the JAX Pallas kernel in
    interpret mode, on the output, the 7 (mean, var) pairs and the gradient
    of every argument (custom VJP vs torch autograd)."""
    x, _, variables = _setup(1, 2, 9, seed=3)
    jargs = _kernel_args(variables["params"])

    def jloss(args, xx):
        out, _ = j_fused(xx, *args, interpret=True)
        return jnp.sum(out * jnp.cos(out * 0.1))

    with jax.default_matmul_precision("highest"):
        jout, jstats = jax.jit(lambda a, xx: j_fused(xx, *a, interpret=True))(jargs, jnp.asarray(x))
        jgrads, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jargs, jnp.asarray(x))

    targs = jax.tree.map(lambda v: torch.tensor(np.asarray(v), requires_grad=True), jargs)
    tx = torch.tensor(x, requires_grad=True)
    tout, tstats = tfe.fused_deep_resnet_embed(tx, *targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=2e-4, atol=2e-4)
    for name, _ in tfe.BN_LAYOUT:
        for got, want in zip(tstats[name], jstats[name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4, err_msg=name)

    torch.sum(tout * torch.cos(tout * 0.1)).backward()
    tleaves = jax.tree.leaves(targs) + [tx]
    jleaves = jax.tree.leaves(jgrads) + [jgx]
    for t_leaf, j_leaf in zip(tleaves, jleaves):
        want = np.asarray(j_leaf)
        np.testing.assert_allclose(
            t_leaf.grad.numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max()
        )


# The kernels' arithmetic written in plain torch, so that the tests below
# reach it without a card: the TF32 operand split and the three-term product
# (csrc/tf32_mma.cuh), the packed weight layout (pack_weights_kernel in
# csrc/fused_embedding.cu) and the conv by row offsets and validity bits
# (csrc/conv_rows.cuh). Change these together with the kernels.


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest value with 10 mantissa bits, ties away from zero
    (what ``cvt.rna.tf32.f32`` gives), still stored as f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """f32 → the 10 leading mantissa bits, the rest dropped: what the tensor
    core reads of an operand that was not rounded first."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor, round_small: bool = True):
    """``(big, small)`` with ``big = tf32(v)`` and ``small = v - big`` as the
    tensor core sees it: rounded to TF32 (the packed weights) or, with
    ``round_small`` false, truncated (activations, split as the fragments
    are read). ``big + small`` equals ``v`` to 2^-21 relative either way."""
    big = tf32_round(v)
    small = v - big
    return big, tf32_round(small) if round_small else tf32_truncate(small)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` the way the conv kernel multiplies activations ``a`` by
    packed weights ``b``: both operands split, the three products
    ``small·big + big·small + big·big`` summed in f32, small terms first.
    (Each product of two TF32 values is exact in f32.)"""
    a_big, a_small = split_tf32(a, round_small=False)
    b_big, b_small = split_tf32(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def pack_conv_weight(w: torch.Tensor, taps: int, flip: bool = False) -> torch.Tensor:
    """The GEMM operand the conv kernel reads, ``(2, taps, K, N)``: plane 0
    the big TF32 part, plane 1 the small part, of a conv weight stored
    ``(taps·cin, cout)``. Forward: ``K = cin, N = cout``. With ``flip`` (the
    data gradient): ``K = cout, N = cin``, taps reversed, each transposed.
    ``pack_weights_kernel`` in ``csrc/fused_embedding.cu`` computes the same
    values and stores them in ``to_kernel_order``."""
    cout = w.shape[1]
    w = w.reshape(taps, -1, cout)
    if flip:
        w = w.flip(0).transpose(1, 2)
    return torch.stack(split_tf32(w.contiguous()))


def to_kernel_order(packed: torch.Tensor) -> torch.Tensor:
    """``pack_conv_weight``'s ``(2, taps, K, N)`` in the order the conv
    kernel keeps it, ``(taps, K/8, 2, N/8, 2, 8, 4)``: per tap and block of 8
    rows the big part then the small part, each as ``N/8`` pairs of 8 x 4
    "core matrices" (what the tensor core reads from shared memory): entry
    ``[tap, kb, part, nb, h, r, q]`` is ``B[8·kb + 2·q + h][8·nb + r]``. The
    kernel's k index within a block of 8 runs over ``(h, q)``, so k < 4 reads
    the even rows and k >= 4 the odd ones."""
    _, taps, k, n = packed.shape
    v = packed.reshape(2, taps, k // 8, 4, 2, n // 8, 8)  # part, tap, kb, q, h, nb, r
    return v.permute(1, 2, 0, 5, 4, 6, 3).contiguous()


def from_kernel_order(ordered: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_kernel_order``."""
    taps, kb, _, nb = ordered.shape[:4]
    return ordered.permute(2, 0, 1, 6, 4, 3, 5).reshape(2, taps, kb * 8, nb * 8)


def conv_rows_reference(x_rows, packed, s: int):
    """3x3 SAME (or 1x1) convolution in the kernels' row layout, the way they
    compute it. ``x_rows``: ``(R, K)`` with ``R = images·S·S``. ``packed``:
    ``pack_conv_weight``'s ``(2, taps, K, N)``. Tap ``t`` reads ``x_rows``
    shifted by ``dy·S + dx`` rows (zeros outside ``[0, R)``), masked by bit
    ``t`` of ``tfe.tap_validity(s)[r mod S·S]``, times the tap's weight.
    Returns ``(R, N)``."""
    taps = packed.shape[1]
    weight = packed[0] + packed[1]
    r = x_rows.shape[0]
    if taps == 1:
        return x_rows @ weight[0]
    bits = tfe.tap_validity(s)[torch.arange(r) % (s * s)]
    halo = s + 1
    slab = torch.nn.functional.pad(x_rows, (0, 0, halo, halo))
    out = torch.zeros(r, weight.shape[2], dtype=x_rows.dtype)
    for t in range(taps):
        off = (t // 3 - 1) * s + (t % 3 - 1)
        keep = ((bits >> t) & 1).to(x_rows.dtype)[:, None]
        out = out + (slab[halo + off : halo + off + r] * keep) @ weight[t]
    return out


def _conv_case(n, s, cin, cout, taps, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n, cin, s, s)), dtype=torch.float32)
    k = 3 if taps == 9 else 1
    w = torch.tensor(rng.normal(size=(k, k, cin, cout)) / np.sqrt(taps * cin), dtype=torch.float32)
    return x, w


def _rows(x):
    """(N, C, S, S) → the kernels' (N·S·S, C) row layout."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


@pytest.mark.parametrize("s", [9, 13])
@pytest.mark.parametrize("taps", [9, 1])
def test_rows_layout_conv_equals_conv2d_forward_and_data_gradient(s, taps):
    """The conv as the kernels compute it (slab row offsets plus the
    validity table, on (R, C) rows across several images) equals F.conv2d
    with SAME padding; with the flipped, transposed packing it equals the
    gradient of F.conv2d with respect to its input. 1e-6 of the largest
    value: both sides sum the same f32 products in another order."""
    n, cin, cout = 3, 8, 16
    x, w = _conv_case(n, s, cin, cout, taps, seed=s + taps)
    want = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), padding=taps // 9)
    packed = pack_conv_weight(w.reshape(taps * cin, cout), taps)
    assert packed.shape == (2, taps, cin, cout)
    got = conv_rows_reference(_rows(x), packed, s)
    assert float((got - _rows(want)).abs().max()) <= 1e-6 * float(want.abs().max())

    g = torch.tensor(np.random.default_rng(1).normal(size=want.shape), dtype=torch.float32)
    xg = x.clone().requires_grad_()
    torch.nn.functional.conv2d(xg, w.permute(3, 2, 0, 1), padding=taps // 9).backward(g)
    flipped = pack_conv_weight(w.reshape(taps * cin, cout), taps, flip=True)
    assert flipped.shape == (2, taps, cout, cin)
    got = conv_rows_reference(_rows(g), flipped, s)
    assert float((got - _rows(xg.grad)).abs().max()) <= 1e-6 * float(xg.grad.abs().max())


@pytest.mark.parametrize("s", [9, 13])
def test_validity_table_keeps_other_images_out(s):
    """Every slab row that lies in another image, or at the other end of an
    image row, is an out-of-image tap: poisoning the neighbouring images
    with NaN-free huge values leaves the middle image's output unchanged,
    and the table marks exactly the in-image taps."""
    bits = tfe.tap_validity(s)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        for h in (0, 1, s - 1):
            for w in (0, s // 2, s - 1):
                inside = 0 <= h + dy < s and 0 <= w + dx < s
                assert bool((int(bits[h * s + w]) >> t) & 1) == inside
    x, w = _conv_case(3, s, 4, 8, 9, seed=s)
    packed = pack_conv_weight(w.reshape(36, 8), 9)
    clean = conv_rows_reference(_rows(x), packed, s)
    x[0] = 1e30
    x[2] = -1e30
    dirty = conv_rows_reference(_rows(x), packed, s)
    assert torch.equal(clean[s * s : 2 * s * s], dirty[s * s : 2 * s * s])


def test_three_tf32_products_reach_f32_accuracy_and_one_does_not():
    """At the deepest reduction of the embedding (K = 9·128 = 1152) the
    emulated 3xTF32 product is within 2e-6 (relative to the largest output)
    of the float64 product of the same f32 inputs, as a plain f32 product
    is; a single TF32 product is two orders of magnitude off. This is why
    the kernels split their operands."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(256, 1152)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(1152, 128)) / np.sqrt(1152), dtype=torch.float32)
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err3 = float((matmul_3xtf32(a, b).double() - exact).abs().max()) / scale
    err1 = float(((tf32_round(a) @ tf32_round(b)).double() - exact).abs().max()) / scale
    assert err3 <= 2e-6
    assert err1 >= 1e-4
    # rounding is to 10 mantissa bits, to nearest, ties away from zero
    v = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_round(v), want)


@pytest.mark.parametrize("taps,cin,cout", [(9, 32, 64), (1, 64, 128), (9, 128, 128)])
def test_packed_weight_layout_round_trips(taps, cin, cout):
    """big + small gives the weight back to 2^-21, both planes are TF32
    values, and the flipped packing is the forward one with taps reversed
    and each tap transposed."""
    rng = np.random.default_rng(taps + cin)
    w = torch.tensor(rng.normal(size=(taps * cin, cout)), dtype=torch.float32)
    fwd = pack_conv_weight(w, taps)
    back = (fwd[0] + fwd[1]).reshape(taps * cin, cout)
    assert float(((back - w).abs() / w.abs()).max()) <= 2.0**-21
    assert torch.equal(tf32_round(fwd), fwd)
    flipped = pack_conv_weight(w, taps, flip=True)
    assert flipped.shape == (2, taps, cout, cin)
    assert torch.equal(flipped.flip(1).transpose(2, 3), fwd)
    # the order the kernel keeps: per (tap, block of 8 rows) the big part then
    # the small part, as 8 x 4 core matrices of column 8·nb + r, rows 8·kb + 2·q + h
    ordered = to_kernel_order(fwd)
    assert ordered.shape == (taps, cin // 8, 2, cout // 8, 2, 8, 4)
    tap, kb, nb, h, r, q = taps - 1, 1, 2, 1, 5, 3
    for part in (0, 1):
        assert ordered[tap, kb, part, nb, h, r, q] == fwd[part, tap, 8 * kb + 2 * q + h, 8 * nb + r]
    assert torch.equal(from_kernel_order(ordered), fwd)
