#!/usr/bin/env python3
"""Score bf16 runs of the images-features experiment against JAX's f32
four seeds (the rule of ROADMAP.md section 3, fixed before the runs).

Usage: ``python3 images_features_bf16_outcome.py DIR [DIR ...]``, each DIR
the ``--out`` of one ``python -m moleculardiffusion_mivit_tpu_torch.run_experiment
images_features --compute-dtype bfloat16 --seed S --cycles 150 --seqs-per-d
256 --in-order --in-order-renders 5`` run (it reads the ``error_tables``
event of ``metrics.jsonl``; ``results/torch_images_features_bf16_seed0`` …
``seed3`` are four such runs).

The statistic of an arm in a run is its protocol in-order MSE (the error
table's ``mse``, the first render of the published suite). One JSON line
per arm: the runs' values, their mean and standard deviation, JAX's four f32
seeds' (``results/images_features_seed0-3``) mean and standard deviation,
the difference, the pooled standard error sqrt(sd_port²/n_port +
sd_jax²/n_jax), the limit max(0.03, 2 pooled SE) and whether the arm holds;
beside them, not held, the port's five-render mean and JAX's bf16 seed-4
record (``results/images_features_bf16``). The MSD rows that do not depend
on the render (MSD_Perfect, MSD_Frame) must equal JAX's to 1e-5 relative;
MSD_Localized scores each run's own render and is reported beside JAX's
four. Then one line with the verdict. Exits 1 when the rule misses.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
JAX_F32 = [ROOT / "results" / f"images_features_seed{s}" for s in range(4)]
JAX_BF16 = ROOT / "results" / "images_features_bf16"
LEARNED = ("im_tr", "im_ft_early_tr", "im_ft_late_tr", "im_resnet", "im_ft_resnet", "ft_mlp")
MSD = ("MSD_Perfect", "MSD_Frame")  # independent of the render: held exactly


def tables(run_dir: Path) -> dict:
    """The run's in-order error tables (the last ``error_tables`` event)."""
    events = [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [e for e in events if e["event"] == "error_tables"][-1]["tables"]


def main(dirs) -> int:
    port = [tables(Path(d)) for d in dirs]
    jax = [tables(d) for d in JAX_F32]
    jax_bf16 = tables(JAX_BF16)
    held = {}
    for arm in LEARNED:
        p = [t[arm]["mse"] for t in port]
        j = [t[arm]["mse"] for t in jax]
        se = (statistics.variance(p) / len(p) + statistics.variance(j) / len(j)) ** 0.5
        diff = statistics.fmean(p) - statistics.fmean(j)
        limit = max(0.03, 2 * se)
        held[arm] = abs(diff) <= limit
        print(json.dumps({"arm": arm, "port": p, "port_mean": statistics.fmean(p), "port_sd": statistics.stdev(p),
                          "jax_f32_mean": statistics.fmean(j), "jax_f32_sd": statistics.stdev(j), "diff": diff,
                          "pooled_se": se, "limit": limit, "held": held[arm],
                          "port_five_render_mean": statistics.fmean(t[arm].get("mse_render_mean", t[arm]["mse"])
                                                                    for t in port),
                          "jax_bf16_seed4": jax_bf16[arm]["mse"]}))
    for arm in MSD:
        ref = jax[0][arm]["mse"]
        got = [t[arm]["mse"] for t in port]
        held[arm] = all(abs(g - ref) <= 1e-5 * abs(ref) for g in got)
        print(json.dumps({"arm": arm, "port": got, "jax": ref, "held": held[arm]}))
    print(json.dumps({"arm": "MSD_Localized", "port": [t["MSD_Localized"]["mse"] for t in port],
                      "jax_f32": [t["MSD_Localized"]["mse"] for t in jax], "held": "reported"}))
    print(json.dumps({"runs": len(port), "held": held, "rule_holds": all(held.values())}))
    return 0 if all(held.values()) else 1


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
