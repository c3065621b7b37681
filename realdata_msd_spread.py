#!/usr/bin/env python3
"""The JAX real-data pipeline's MSD-error spread over render keys of the
demo's movie, and the port's seeds judged against it (fault F6 in
ROADMAP.md).

The demo's movie is six particles at D = 0.3 px²/frame, with fixed
trajectories (``realdata.demo.movie_trajectories``). Each render key draws
other intensities and camera noise. For each key this script renders the
movie with the JAX package's ``render_widefield`` on the CPU, tracks and
refines it with the JAX pipeline (``analyze_microscopy_sequence``,
``refine_localizations``), and takes each track's MSD(τ=1) D with
``estimate_d_for_tracks`` (calibration 0.375, as the demo). The model column
is not used, so no training runs. Per key it records the MSD mean absolute
error against D = 0.3 and the tracks that follow more than one true
particle (``realdata.demo.track_identities``: tracker identity swaps).

The rule, written before the runs. Let J be the JAX keys' MSD errors and
P the port's four seeds' (``results/torch_realdata_demo_seed0-3``, card
runs of ``realdata.demo --train-cycles 100``). The port's miss is the
pipeline's own spread, and F6 closes, when both hold:

1. every port seed's error lies within [min J, max J];
2. |mean P − mean J| ≤ 2 · sd(J) · sqrt(1/4 + 1/N), N the number of keys.

The second rule, on the two pipelines' spreads, written before its runs.
Run JAX's pipeline over keys 64-127 and the port's on the CPU over render
seeds 64-127 (``--first-key 64 --keys 64 --port 64``; neither range
overlaps the 0-63 judged above). Let s_J and s_P be the shares of keys and
seeds with a swapped track, p̄ = (s_J + s_P) / 2 their pooled rate, and
mean/sd the MSD mean absolute errors over each side's 64. F6 closes as the
pipeline's own spread when both hold:

1. |s_P − s_J| ≤ 2 · sqrt(p̄ (1 − p̄) · 2 / 64);
2. |mean_P − mean_J| ≤ 2 · sqrt(sd_P² / 64 + sd_J² / 64).

Otherwise F6 stays open with the numbers.

Usage: ``python3 realdata_msd_spread.py [--keys N] [--first-key K] [--out results/realdata_msd_spread]``
(JAX on the CPU, ~1 s a key after the first). It writes ``msd_spread.json``
under ``--out`` and prints the verdict; ``--judge`` only re-reads that file
and the port's reports and exits 1 when the rule misses. ``--port N`` also
runs the port's own pipeline on the CPU over N render seeds of the same
movie (its ``realdata.demo.make_movie`` and TIFF round trip, CPU streams)
and writes ``port_spread.json``: the port's swap rate beside JAX's, which
the first rule does not read. ``--first-key K`` starts both ranges at K,
writes ``msd_spread_fromK.json`` and ``port_spread_fromK.json``, and judges
them by the second rule (with ``--judge``, the written files only).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "realdata_msd_spread"
PORT_SEEDS = [ROOT / "results" / f"torch_realdata_demo_seed{s}" / "realdata_report.json" for s in range(4)]


def jax_key(key: int) -> dict:
    """The JAX pipeline's MSD error and identity swaps at one render key."""
    import jax
    import jax.numpy as jnp

    from moleculardiffusion_mivit_tpu.config import OpticsConfig
    from moleculardiffusion_mivit_tpu.realdata import (
        analyze_microscopy_sequence, estimate_d_for_tracks, extract_particle_patches, refine_localizations)
    from moleculardiffusion_mivit_tpu.sim import render_widefield
    from moleculardiffusion_mivit_tpu_torch.realdata import demo

    optics = OpticsConfig(**{f: getattr(demo.OPTICS, f) for f in (
        "particle_intensity", "psf_division_factor", "output_size", "background_intensity", "poisson_noise",
        "trajectory_unit")})
    trajs = jnp.asarray(demo.movie_trajectories(), jnp.float32)
    movie = np.asarray(render_widefield(jax.random.key(key), trajs, demo.N_POS, demo.FIELD, optics))
    tracks = analyze_microscopy_sequence(movie, **demo.TRACKING)[0]
    refined = refine_localizations(tracks, extract_particle_patches(movie, tracks, demo.PATCH), demo.PATCH)
    d = estimate_d_for_tracks(tracks, movie, lambda v: jnp.zeros((v.shape[0], 1)), patch_size=demo.PATCH,
                              msd_calibration=0.375, refined_positions=refined)
    d_msd = np.asarray([d[t]["d_msd"] for t in tracks])
    identities = demo.track_identities(tracks, refined)
    return {"key": key, "n_tracks": len(tracks), "d_msd": d_msd.tolist(),
            "msd_mean_abs_err": float(np.abs(d_msd - demo.D_TRUE).mean()),
            "swapped_tracks": sum(len(p) > 1 for p in identities.values())}


def port_key(seed: int) -> dict:
    """The port's pipeline on its render of the movie at one CPU seed (the
    demo's stream layout), as ``jax_key`` reports JAX's."""
    import tempfile

    import torch

    from moleculardiffusion_mivit_tpu_torch.realdata import (
        analyze_microscopy_sequence, demo, estimate_d_for_tracks, extract_particle_patches, read_tiff_stack,
        refine_localizations)
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "movie.tif")
        demo.make_movie(path, seeded_generator("cpu", seed, 3))
        movie = read_tiff_stack(path)
    tracks = analyze_microscopy_sequence(movie, device="cpu", **demo.TRACKING)[0]
    refined = refine_localizations(tracks, extract_particle_patches(movie, tracks, patch_size=demo.PATCH),
                                   patch_size=demo.PATCH, device="cpu")
    d = estimate_d_for_tracks(tracks, movie, lambda v: torch.zeros((v.shape[0], 1)), patch_size=demo.PATCH,
                              msd_calibration=0.375, refined_positions=refined, device="cpu")
    d_msd = np.asarray([d[t]["d_msd"] for t in tracks])
    identities = demo.track_identities(tracks, refined)
    return {"seed": seed, "n_tracks": len(tracks), "d_msd": d_msd.tolist(),
            "msd_mean_abs_err": float(np.abs(d_msd - demo.D_TRUE).mean()),
            "swapped_tracks": sum(len(p) > 1 for p in identities.values())}


def judge(spread: dict, port: list[dict]) -> dict:
    """The rule of the module docstring, on the JAX keys and the port's seeds."""
    j = np.asarray([k["msd_mean_abs_err"] for k in spread["keys"]])
    p = np.asarray([s["msd_mean_abs_err"] for s in port])
    limit = 2 * j.std(ddof=1) * np.sqrt(1 / len(p) + 1 / len(j))
    rules = {"every_port_seed_within_jax_range": bool(((p >= j.min()) & (p <= j.max())).all()),
             "port_mean_within_2_se_of_jax_mean": bool(abs(p.mean() - j.mean()) <= limit)}
    return {"jax_keys": len(j), "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)),
            "jax_min": float(j.min()), "jax_max": float(j.max()),
            "jax_keys_with_a_swap": int(sum(k["swapped_tracks"] > 0 for k in spread["keys"])),
            "port_errors": p.tolist(), "port_mean": float(p.mean()), "mean_limit": float(limit),
            "rules": rules, "closed": all(rules.values())}


def judge_spreads(jax_keys: list[dict], port: list[dict]) -> dict:
    """The second rule of the module docstring: the two pipelines' swap rates
    and MSD errors over as many keys as seeds."""
    n = len(jax_keys)
    if len(port) != n:
        raise ValueError(f"the rule compares as many seeds as keys, got {len(port)} and {n}")
    s_j = sum(k["swapped_tracks"] > 0 for k in jax_keys) / n
    s_p = sum(k["swapped_tracks"] > 0 for k in port) / n
    pooled = (s_j + s_p) / 2
    j = np.asarray([k["msd_mean_abs_err"] for k in jax_keys])
    p = np.asarray([k["msd_mean_abs_err"] for k in port])
    rate_limit = 2 * np.sqrt(pooled * (1 - pooled) * 2 / n)
    mean_limit = 2 * np.sqrt(p.var(ddof=1) / n + j.var(ddof=1) / n)
    rules = {"swap_rates_within_2_binomial_se": bool(abs(s_p - s_j) <= rate_limit),
             "msd_means_within_2_pooled_se": bool(abs(p.mean() - j.mean()) <= mean_limit)}
    return {"n": n, "jax_swap_rate": s_j, "port_swap_rate": s_p, "swap_rate_limit": float(rate_limit),
            "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)), "port_mean": float(p.mean()),
            "port_sd": float(p.std(ddof=1)), "mean_limit": float(mean_limit), "rules": rules,
            "closed": all(rules.values())}


def port_seeds() -> list[dict]:
    out = []
    for path in PORT_SEEDS:
        rep = json.loads(path.read_text())
        d_msd = np.asarray(rep["d_msd"])
        out.append({"seed": rep["seed"], "msd_mean_abs_err": float(np.abs(d_msd - rep["summary"]["d_true"]).mean()),
                    "swapped_tracks": sum(len(p) > 1 for p in rep["track_particles"])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--first-key", type=int, default=0, help="first JAX key and port seed (second rule when > 0)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--judge", action="store_true", help="judge the written spread only")
    ap.add_argument("--port", type=int, default=0, help="also the port's pipeline over this many CPU seeds")
    args = ap.parse_args(argv)
    first, suffix = args.first_key, f"_from{args.first_key}" if args.first_key else ""
    path = Path(args.out) / f"msd_spread{suffix}.json"
    port_path = Path(args.out) / f"port_spread{suffix}.json"
    flag = f" --first-key {first}" if first else ""
    if not args.judge:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        t0 = time.perf_counter()
        keys = []
        for k in range(first, first + args.keys):
            keys.append(jax_key(k))
            print(json.dumps(keys[-1]), flush=True)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"keys": keys, "seconds": time.perf_counter() - t0,
                                    "command": f"python3 realdata_msd_spread.py --keys {args.keys}{flag}"},
                                   indent=1) + "\n")
    if args.port:
        t0 = time.perf_counter()
        seeds = [port_key(s) for s in range(first, first + args.port)]
        errors = np.asarray([k["msd_mean_abs_err"] for k in seeds])
        summary = {"seeds": len(seeds), "with_a_swap": sum(k["swapped_tracks"] > 0 for k in seeds),
                   "mean": float(errors.mean()), "sd": float(errors.std(ddof=1)),
                   "above_0.10": int((errors > 0.10).sum())}
        port_path.write_text(json.dumps(
            {"seeds": seeds, "summary": summary, "seconds": time.perf_counter() - t0,
             "command": f"python3 realdata_msd_spread.py --judge --port {args.port}{flag}"}, indent=1) + "\n")
        print(json.dumps({"port_spread": summary}))
    if first:
        verdict = judge_spreads(json.loads(path.read_text())["keys"], json.loads(port_path.read_text())["seeds"])
    else:
        verdict = judge(json.loads(path.read_text()), port_seeds())
    print(json.dumps(verdict))
    return 0 if verdict["closed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
