"""The change-point demo's trainer witness in float32 beside float64.

Runs the witness of ``tests/test_torch_changepoint_study.py`` (one cycle of
the demo's arm, the port's ``Experiment`` against JAX's ``train_step``
step by step) on each curriculum in float32, held by F7's bounds (each loss
at 1e-5 relative, each tensor at 1e-4 of its largest entry, each widened by
3 × JAX's own distance from itself under a one-ulp move of its videos), and
in float64 as the test holds it; and measures each float32 side's distance
from the float64 cycle (both start from the same float32 weights, so the
float64 cycle is the same arithmetic done nearly exactly). Prints one line a
curriculum and writes ``results/changepoint_outcome/witness_float32.json``
(``witness_float32_seqs{N}.json`` with ``--seqs-per-d N``, N other than the
test's 4).

Run from the repository's root: ``python -m tests.changepoint_witness_f32
[--seqs-per-d N]`` (~5 min on the CPU at 4 a class).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests import test_torch_changepoint_study as witness  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "results" / "changepoint_outcome"


def _rel_loss(a, b, ref):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.asarray(ref)


def _tensor_gap(got: dict, want: dict, skip=()) -> float:
    """The largest |got − want| of any tensor over its largest entry in
    ``want``, over every kind (state, moments) and name not in ``skip``."""
    return max(float((got[k][n].double() - w.double()).abs().max() / w.double().abs().max())
               for k, ref in want.items() for n, w in ref.items() if not any(s in n for s in skip))


def measure(curriculum: str, seqs_per_d: int, compiled: dict) -> dict:
    refs, ports = {}, {}
    for dtype in (np.float32, np.float64):
        refs[dtype] = witness.jax_demo_cycle_data(curriculum, dtype, seqs_per_d, compiled)
        with pytest.MonkeyPatch.context() as mp:
            ports[dtype] = witness.port_demo_cycle(refs[dtype], mp)
    out = {"curriculum": curriculum, "steps": len(refs[np.float32]["losses"])}
    for dtype, name in ((np.float32, "float32"), (np.float64, "float64")):
        ref, (losses, got) = refs[dtype], ports[dtype]
        loss_misses, off = witness.demo_cycle_misses(ref, losses, got)
        out[name] = {"loss_steps_missed": loss_misses, "tensors_missed": len(off),
                     "port_jax_loss_rel_max": float(_rel_loss(losses, ref["losses"], ref["losses"]).max()),
                     "jax_ulp_loss_rel_max": float((ref["spread_losses"] / ref["losses"]).max()),
                     "port_jax_tensor_rel_max": _tensor_gap(got, ref["want"]),
                     "port_jax_tensor_rel_max_but_key_biases": _tensor_gap(got, ref["want"], ("k_proj.bias",))}
    truth = refs[np.float64]
    port32_losses, port32 = ports[np.float32]
    out["distance_from_float64"] = {
        "jax_f32_loss_rel_max": float(_rel_loss(refs[np.float32]["losses"], truth["losses"], truth["losses"]).max()),
        "port_f32_loss_rel_max": float(_rel_loss(port32_losses, truth["losses"], truth["losses"]).max()),
        "jax_f32_tensor_rel_max_but_key_biases": _tensor_gap(refs[np.float32]["want"], truth["want"], ("k_proj.bias",)),
        "port_f32_tensor_rel_max_but_key_biases": _tensor_gap(port32, truth["want"], ("k_proj.bias",))}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs-per-d", type=int, default=witness.WITNESS_SEQS_PER_D)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    default = args.seqs_per_d == witness.WITNESS_SEQS_PER_D
    compiled = {}
    rows = [measure(c, args.seqs_per_d, compiled) for c in witness.CURRICULA]
    for r in rows:
        print(json.dumps(r))
    command = "python -m tests.changepoint_witness_f32" + ("" if default else f" --seqs-per-d {args.seqs_per_d}")
    OUT.mkdir(parents=True, exist_ok=True)
    name = "witness_float32.json" if default else f"witness_float32_seqs{args.seqs_per_d}.json"
    (OUT / name).write_text(json.dumps({"seqs_per_d": args.seqs_per_d, "rows": rows, "command": command},
                                       indent=1) + "\n")


if __name__ == "__main__":
    main()
