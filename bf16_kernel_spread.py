"""Per-gradient spread of the bf16 deep-ResNet embedding between two
implementations that round at the same places, beside the distance from
bf16 to f32 arithmetic: the readings behind the bf16 kernels' gradient
tolerance (``BF16_GRAD_L2_TOL`` in ``chip_smoke.py``, the same number in
``tests/test_torch_cuda.py::test_bf16_embedding_kernels_match_plain_bf16_on_card``).

    python3 bf16_kernel_spread.py --card [--seeds 4]   # on a CUDA card
    python3 bf16_kernel_spread.py --cpu [--seeds 4]    # on the CPU, with JAX

``--card``: K2-bf16/K3-bf16 (``fused_deep_resnet_embed`` on the card)
against the plain bf16 version on the same card. ``--cpu``: the JAX
package's fused kernel at ``interpret=True, exact=False`` (bf16 products,
f32 accumulation, as on the TPU) against the port's plain bf16 version, a
witness independent of the CUDA kernels. Both take the card test's inputs
(numpy seeds, its ``_embedding_args``) at its three shapes and at the
smoke's 38,880 rows, and report for every shape and seed each gradient's
relative L2 distance (``sound``), the embedding's, and each gradient's
distance between the plain version in f32 and in bf16 on the same
bf16-valued inputs (``f32``, the control a tolerance must refuse).
Writes ``results/bf16_kernel_spread/{card,cpu}.json`` (``--out`` to
change the directory). The ``--card`` mode imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

# (B, T, S, E): the card test's shapes, then the smoke's 38,880 rows
SHAPES = ((1, 30, 9, 64), (1, 6, 13, 32), (3, 30, 9, 58), (16, 30, 9, 64))
KERNEL_SHAPES = {
    "initial": (3, 3, 1, 32), "rb1_conv1": (3, 3, 32, 64), "rb1_conv2": (3, 3, 64, 64),
    "rb1_skip": (1, 1, 32, 64), "rb2_conv1": (3, 3, 64, 128), "rb2_conv2": (3, 3, 128, 128),
    "rb2_skip": (1, 1, 64, 128),
}


def embedding_args(b, t, s, e, seed):
    """The card test's ``_embedding_args`` as numpy f32, rounded to bf16
    values (x, kernels, scales, biases, fc kernel, fc bias), and the
    upstream gradient."""
    from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import BN_LAYOUT

    rng = np.random.default_rng(seed)
    leaf = lambda shape, scale, offset=0.0: offset + scale * rng.normal(size=shape)  # noqa: E731
    kernels = {k: leaf(v, 1.0 / np.sqrt(np.prod(v[:3]))) for k, v in KERNEL_SHAPES.items()}
    scales = {k: leaf((c,), 0.1, 1.0) for k, c in BN_LAYOUT}
    biases = {k: leaf((c,), 0.1) for k, c in BN_LAYOUT}
    x = leaf((b, t, s, s), 0.3, 0.1)
    args = (x, kernels, scales, biases, leaf((128, e), 128 ** -0.5), leaf((e,), 0.1))
    g = np.random.default_rng(1000 + seed).normal(size=(b, t, e))
    bf = lambda v: torch.tensor(v, dtype=torch.float32).bfloat16().float().numpy()  # noqa: E731
    return tree_map(bf, args), bf(g)


def tree_map(fn, args):
    return tuple({k: fn(v) for k, v in a.items()} if isinstance(a, dict) else fn(a) for a in args)


def leaf_names(args):
    """Gradient names in ``leaves`` order: x, then each dict by sorted key
    (JAX's order), then the fc kernel and bias."""
    names = ["x"]
    for prefix, d in zip(("w", "scale", "bias"), args[1:4]):
        names += [f"{prefix}:{k}" for k in sorted(d)]
    return names + ["fc_kernel", "fc_bias"]


def leaves(args):
    return [args[0], *(d[k] for d in args[1:4] for k in sorted(d)), args[4], args[5]]


def plain(args, g, dtype, device):
    """The port's plain version at ``dtype`` on ``device``: embedding and
    gradients as f32 numpy."""
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    t = tree_map(lambda v: torch.tensor(v, device=device).to(dtype).requires_grad_(), args)
    emb, _ = fe.deep_resnet_embed_reference(*t)
    grads = torch.autograd.grad(emb, leaves(t), torch.tensor(g, device=device).to(dtype))
    return emb.detach().float().cpu().numpy(), [v.float().cpu().numpy() for v in grads]


def kernel(args, g):
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    t = tree_map(lambda v: torch.tensor(v, device="cuda").bfloat16().requires_grad_(), args)
    before = fe.deep_resnet_embed_fwd_bf16.launches, fe.deep_resnet_embed_bwd_bf16.launches
    emb, _ = fe.fused_deep_resnet_embed(*t)
    grads = torch.autograd.grad(emb, leaves(t), torch.tensor(g, device="cuda").bfloat16())
    after = fe.deep_resnet_embed_fwd_bf16.launches, fe.deep_resnet_embed_bwd_bf16.launches
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise RuntimeError("K2-bf16/K3-bf16 did not launch once each")
    return emb.detach().float().cpu().numpy(), [v.float().cpu().numpy() for v in grads]


def jax_kernel(args, g):
    import functools

    import jax
    import jax.numpy as jnp

    from moleculardiffusion_mivit_tpu.ops import fused_embedding as jfe

    cast = functools.partial(jax.tree.map, lambda v: jnp.asarray(v, jnp.bfloat16))
    embed = functools.partial(jfe.fused_deep_resnet_embed, interpret=True, exact=False)
    (emb, stats), vjp = jax.vjp(embed, *cast(args))
    grads = jax.tree.leaves(vjp((cast(g), jax.tree.map(jnp.zeros_like, stats))))
    return np.asarray(emb, np.float32), [np.asarray(v, np.float32) for v in grads]


def rel(a, r):
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true")
    mode.add_argument("--cpu", action="store_true")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("results", "bf16_kernel_spread"))
    a = ap.parse_args(argv)
    if a.card and not torch.cuda.is_available():
        print("--card needs a CUDA card", file=sys.stderr)
        return 1
    device = "cuda" if a.card else "cpu"
    if a.cpu:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    readings = []
    for b, t, s, e in SHAPES:
        for seed in range(a.seeds):
            args, g = embedding_args(b, t, s, e, seed)
            ref_emb, ref = plain(args, g, torch.bfloat16, device)
            emb, got = kernel(args, g) if a.card else jax_kernel(args, g)
            _, f32 = plain(args, g, torch.float32, device)
            names = leaf_names(args)
            row = {"B": b, "T": t, "S": s, "E": e, "rows": b * t * s * s, "seed": seed,
                   "embedding": rel(emb, ref_emb),
                   "sound": dict(zip(names, (rel(u, r) for u, r in zip(got, ref)))),
                   "f32": dict(zip(names, (rel(u, r) for u, r in zip(f32, ref))))}
            row["sound_worst"], row["f32_worst"] = max(row["sound"].values()), max(row["f32"].values())
            row["sound_worst_of"] = max(row["sound"], key=row["sound"].get)
            print(json.dumps({k: row[k] for k in ("B", "T", "S", "E", "seed", "embedding", "sound_worst",
                                                  "sound_worst_of", "f32_worst")}), flush=True)
            readings.append(row)
    summary = {"sound_worst": max(r["sound_worst"] for r in readings),
               "f32_worst_least": min(r["f32_worst"] for r in readings),
               "embedding_worst": max(r["embedding"] for r in readings)}
    if a.card:
        summary["card"] = torch.cuda.get_device_name(0)
    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, "card.json" if a.card else "cpu.json")
    with open(path, "w") as f:
        json.dump({"mode": "card" if a.card else "cpu", "seeds": a.seeds, "summary": summary,
                   "readings": readings}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
