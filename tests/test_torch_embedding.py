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
