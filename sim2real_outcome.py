#!/usr/bin/env python3
"""The sim-to-real study's outcome: the port's card seeds against JAX's own
spread, by the rule in the docstring of
``moleculardiffusion_mivit_tpu_torch/realdata/sim2real.py`` (written before
the runs).

- ``--jax-msd N``: JAX's pipeline on the CPU over render keys 0 … N−1 of
  each test row's three movies (``examples/sim2real_robustness.py``'s
  trajectories, ``default_rng(100 + 17·m)``; key 0 renders movie m with the
  example's own ``jax.random.key(100 + 17·m)``, key j > 0 with its
  ``fold_in(·, j)``), scored by the example's ``score_movie`` with a
  constant predictor: the MSD column, no training. Writes ``jax_msd.json``.
- ``--jax-seeds K``: the example's whole study (both arms, 60 cycles each,
  its ``train_patch_model`` at ``seed = 42 + k``, then its ``score_movie``
  on the key-0 movies), JAX on the CPU, each seed stopped after the rule's
  30 min (``JAX_SEED_LIMIT_S``; the stop takes effect when the running
  compiled cycle returns). Writes ``jax_seeds.json`` with
  each seed's seconds, whether it finished, and the progress lines the
  example printed (one every 20 cycles) with their times.
- Without either it judges the written files against the port's seeds
  (``results/torch_sim2real_seed{0..7}/sim2real_report.json``, card runs of
  ``python -m moleculardiffusion_mivit_tpu_torch.realdata.sim2real
  --train-cycles 60 --seed S``), writes ``verdict.json`` and exits 1 when a
  held rule misses.

The cut protocol (F7's second witness): ``--cycles C`` trains the fixed
arm alone for C cycles, with no time limit.
``--jax-seeds K [--first-jax-seed k0]`` then runs seeds ``42 + k0`` …
``42 + k0 + K − 1`` and writes each to ``jax_cut{C}_seed{S}.json`` (so
seeds can run side by side as separate processes), every row scored on
the key-0 movies as above and each movie's per-track D̂ kept. Without a
``--jax-*`` flag, ``--cycles C`` judges the port's
``results/torch_sim2real_cut{C}_seed{0..7}`` (``--train-cycles C --arms
fixed --seed S``) against those files by the cut rule, writes
``cut{C}_verdict.json`` and exits 1 on a miss. The cut rules, set before
the runs: on every test row, the fixed arm's ``fixed_mae`` is held when
|mean P − mean J| ≤ max(0.03, 3·sqrt(sd_P²/n_P + sd_J²/n_J)) (8 port seeds,
first 3 and then 7 JAX seeds; three standard errors because 7 rows are
tested at once), and its spread when sd_P²/sd_J² lies inside the two-sided
F test's band at level 0.05/7 with n_P − 1 and n_J − 1 degrees of freedom
(``spread_band``; set before JAX seeds 45-48 ran). Each seed's mean D̂ on
every row, dim and bright among them, is reported on both sides.

Usage: ``python3 sim2real_outcome.py [--jax-msd 32] [--jax-seeds 1]
[--cycles 10 [--first-jax-seed 0]] [--out
results/sim2real_outcome] [PORT_DIR ...]``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "sim2real_outcome"
PORT_DIRS = [ROOT / "results" / f"torch_sim2real_seed{s}" for s in range(8)]
RECORD = ROOT / "results" / "sim2real" / "sim2real.json"  # JAX on a TPU, one training seed
ROWS = ("nominal", "psf_sharp_1.0", "psf_wide_1.6", "psf_wider_1.8", "dim_2000", "bright_5500", "noisy_bg200_p50")
ARMS = ("fixed", "randomized")
MOVIES = 3
FIRST_MODEL_KEY = 42
JAX_SEED_LIMIT_S = 30 * 60
MIN_MODEL_LIMIT = 0.03
PROTOCOL_CYCLES = 60
CUT_PORT_SEEDS = 8
CUT_ARMS = ("fixed",)
SPREAD_LEVEL = 0.05 / len(ROWS)  # the spread rule's two-sided level, Bonferroni over the rows


def _example():
    spec = importlib.util.spec_from_file_location("sim2real_example", ROOT / "examples" / "sim2real_robustness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_movie(ex, path: str, optics, movie: int, key: int) -> None:
    """The example's ``make_movie`` of movie ``movie`` at render key
    ``key`` (0: the example's own key)."""
    import jax
    import jax.numpy as jnp

    seed = 100 + 17 * movie
    rng = np.random.default_rng(seed)
    starts = rng.uniform(14, 63 - 14, size=(10, 1, 2))
    steps = rng.normal(0, np.sqrt(2 * ex.D_TRUE / ex.N_POS), size=(10, 25 * ex.N_POS, 2))
    steps[:, 0] = 0
    trajs = starts + np.cumsum(steps, axis=1)
    k = jax.random.key(seed)
    if key:
        k = jax.random.fold_in(k, key)
    ex.write_tiff_stack(path, np.asarray(ex.render_widefield(k, jnp.asarray(trajs, jnp.float32), ex.N_POS, 63,
                                                             optics)))


def jax_msd_key(ex, key: int) -> dict:
    """Each test row's MSD column at one render key: the example's
    ``score_movie`` on its three movies (its per-movie values, rounded to
    1e-4 as it rounds them)."""
    import jax.numpy as jnp

    zero = {"zero": lambda v: jnp.zeros((v.shape[0], 1))}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ROWS:
            movies = []
            for m in range(MOVIES):
                path = os.path.join(tmp, f"{name}_{m}.tif")
                _jax_movie(ex, path, ex.TEST_OPTICS[name], m, key)
                row = ex.score_movie(path, zero)
                movies.append(None if row is None else {"n_tracks": row["n_tracks"], "msd": row["msd"]})
            found = [r for r in movies if r]
            rows[name] = {"n_tracks": sum(r["n_tracks"] for r in found),
                          "msd_mae": float(np.mean([r["msd"] for r in found])) if found else None,
                          "movies": movies}
    return {"key": key, "rows": rows}


class _Stopped(Exception):
    pass


def jax_seed(ex, k: int, limit_s, cycles: int = PROTOCOL_CYCLES, arms=ARMS) -> dict:
    """The example's study at training seed ``42 + k``, stopped after
    ``limit_s`` seconds (``None``: no limit): each arm of ``arms`` trained
    by its ``train_patch_model`` for ``cycles`` cycles, then its
    ``score_movie`` on the three key-0 movies of each row. Each row also
    keeps every arm's per-track D̂ (``d_<arm>``: the predictor's outputs,
    which ``estimate_d_for_tracks`` takes as D̂ one track each)."""
    seed = FIRST_MODEL_KEY + k
    marks = []

    class _Marks:  # the example prints a line every 20 cycles: keep its time
        def write(self, s):
            if s.strip():
                marks.append((time.perf_counter() - t0, s.strip()))
            return sys.__stdout__.write(s)

        def flush(self):
            sys.__stdout__.flush()

    def stop(*_):
        raise _Stopped

    panels = {"fixed": [ex.NOMINAL], "randomized": ex.RAND_PANEL}
    old = signal.signal(signal.SIGALRM, stop)
    if limit_s is not None:
        signal.alarm(int(limit_s))
    t0 = time.perf_counter()
    out = {"seed": seed, "limit_s": limit_s, "cycles": cycles, "arms": list(arms)}
    stdout, sys.stdout = sys.stdout, _Marks()
    try:
        trained, seen = {}, {a: [] for a in arms}
        for arm in arms:
            predict = ex.train_patch_model(25, cycles, panels[arm], seed=seed)
            out[f"{arm}_trained_s"] = time.perf_counter() - t0

            def recording(videos, predict=predict, arm=arm):
                pred = predict(videos)
                seen[arm].extend(np.asarray(pred, dtype=np.float64).reshape(-1).tolist())
                return pred

            trained[arm] = recording
        rows = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name in ROWS:
                movies = []
                for a in arms:
                    seen[a].clear()
                for m in range(MOVIES):
                    path = os.path.join(tmp, f"{name}_{m}.tif")
                    _jax_movie(ex, path, ex.TEST_OPTICS[name], m, 0)
                    movies.append(ex.score_movie(path, trained))
                found = [r for r in movies if r]
                rows[name] = {f"{a}_mae": float(np.mean([r[a] for r in found])) if found else None
                              for a in (*arms, "msd")}
                rows[name]["n_tracks"] = sum(r["n_tracks"] for r in found)
                rows[name].update({f"d_{a}": list(seen[a]) for a in arms})
        out.update(rows=rows, seconds=time.perf_counter() - t0, finished=True)
    except _Stopped:
        out.update(seconds=time.perf_counter() - t0, finished=False)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        sys.stdout = stdout
    out["progress"] = marks
    return out


def judge(msd_keys: list, jax_seeds: list, port: list, record: dict) -> dict:
    """The rule of ``sim2real.py``'s docstring on JAX's keys and seeds and
    the port's seeds."""
    n_p = len(port)
    out = {"port_seeds": [p["seed"] for p in port], "jax_msd_keys": len(msd_keys), "held": {}, "reported": {},
           "rows": {}}
    fast = [s for s in jax_seeds if s.get("finished") and s["seconds"] <= JAX_SEED_LIMIT_S]
    model_branch = "jax_seeds" if len(fast) >= 2 and len(fast) == len(jax_seeds) else "record"
    out["model_branch"] = model_branch
    if jax_seeds:
        out["jax_seed_seconds"] = [{"seed": s["seed"], "seconds": s["seconds"], "finished": s.get("finished", False)}
                                   for s in jax_seeds]
    for name in ROWS:
        rows = [p["rows"][name] for p in port]
        if any(r is None for r in rows):
            out["held"][f"{name}_port_rows_present"] = False
            out["rows"][name] = None
            continue
        col = {}
        p = np.asarray([r["msd_mae"] for r in rows], dtype=np.float64)
        j = np.asarray([k["rows"][name]["msd_mae"] for k in msd_keys], dtype=np.float64)
        limit = 3 * np.sqrt(p.var(ddof=1) / n_p + j.var(ddof=1) / len(j))
        col["msd"] = {"port": p.tolist(), "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
                      "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)), "jax_min": float(j.min()),
                      "jax_max": float(j.max()), "limit": float(limit), "delta": float(abs(p.mean() - j.mean()))}
        out["held"][f"{name}_msd_mean_within_3_pooled_se"] = bool(abs(p.mean() - j.mean()) <= limit)
        out["reported"][f"{name}_msd_every_seed_within_jax_range"] = bool(((p >= j.min()) & (p <= j.max())).all())
        for arm in ARMS:
            p = np.asarray([r[f"{arm}_mae"] for r in rows], dtype=np.float64)
            c = {"port": p.tolist(), "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
                 "record": record["rows"][name][f"{arm}_mae"]}
            if all("movies" in r for r in port):  # the estimates' bias: each seed's mean D̂ over the row's tracks
                c["port_mean_d_hat"] = [float(np.mean([d for m in r["movies"] if m["row"] == name
                                                       for d in m.get(f"d_{arm}", [])])) for r in port]
            if model_branch == "jax_seeds":
                j = np.asarray([s["rows"][name][f"{arm}_mae"] for s in fast], dtype=np.float64)
                limit = max(MIN_MODEL_LIMIT, 3 * np.sqrt(p.var(ddof=1) / n_p + j.var(ddof=1) / len(j)))
                ref = float(j.mean())
                c.update(jax=j.tolist(), jax_mean=ref, jax_sd=float(j.std(ddof=1)))
            else:
                limit = max(MIN_MODEL_LIMIT, 3 * p.std(ddof=1) * np.sqrt(1 + 1 / n_p))
                ref = c["record"]
            c.update(limit=float(limit), delta=float(abs(p.mean() - ref)))
            col[arm] = c
            out["held"][f"{name}_{arm}_within_limit"] = bool(abs(p.mean() - ref) <= limit)
        col["n_tracks"] = {"port": [r["n_tracks"] for r in rows], "record": record["rows"][name]["n_tracks"]}
        out["rows"][name] = col
    out["reported"]["randomized_below_fixed_rows_per_seed"] = [
        [n for n, r in p["rows"].items() if r and r["randomized_mae"] < r["fixed_mae"]] for p in port]
    out["reported"]["record_randomized_below_fixed_rows"] = [
        n for n in ROWS if record["rows"][n]["randomized_mae"] < record["rows"][n]["fixed_mae"]]
    out["ok"] = all(out["held"].values())
    return out


def _mean_d_hat(values) -> float:
    return float(np.mean(values)) if len(values) else float("nan")


def spread_band(n_p: int, n_j: int) -> tuple:
    """The spread rule's acceptance band for sd_P²/sd_J²: the two-sided F
    test at level ``SPREAD_LEVEL`` with n_p − 1 and n_j − 1 degrees of
    freedom."""
    from scipy.stats import f

    return (float(f.ppf(SPREAD_LEVEL / 2, n_p - 1, n_j - 1)), float(f.ppf(1 - SPREAD_LEVEL / 2, n_p - 1, n_j - 1)))


def judge_cut(jax_seeds: list, port: list, cycles: int) -> dict:
    """The cut rules of this module's docstring: on every row the fixed
    arm's ``fixed_mae``, the port's seeds against JAX's at the same cut, by
    its mean and by its spread (the variance ratio inside ``spread_band``);
    each seed's mean D̂ a row reported on both sides."""
    n_p, n_j = len(port), len(jax_seeds)
    band = spread_band(n_p, n_j)
    out = {"cycles": cycles, "port_seeds": [p["seed"] for p in port], "jax_seeds": [s["seed"] for s in jax_seeds],
           "jax_seed_seconds": [s["seconds"] for s in jax_seeds],
           "port_seed_seconds": [p["seconds"] for p in port], "spread_level": SPREAD_LEVEL,
           "spread_band": list(band), "held": {}, "rows": {}}
    for name in ROWS:
        rows = [p["rows"][name] for p in port]
        jrows = [s["rows"][name] for s in jax_seeds]
        if any(r is None or r.get("fixed_mae") is None for r in rows + jrows):
            out["held"][f"{name}_rows_present"] = False
            out["rows"][name] = None
            continue
        p = np.asarray([r["fixed_mae"] for r in rows], dtype=np.float64)
        j = np.asarray([r["fixed_mae"] for r in jrows], dtype=np.float64)
        limit = max(MIN_MODEL_LIMIT, 3 * np.sqrt(p.var(ddof=1) / n_p + j.var(ddof=1) / n_j))
        delta = abs(p.mean() - j.mean())
        ratio = p.var(ddof=1) / j.var(ddof=1)
        out["rows"][name] = {
            "port": p.tolist(), "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
            "jax": j.tolist(), "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)),
            "limit": float(limit), "delta": float(delta), "variance_ratio": float(ratio),
            "port_mean_d_hat": [_mean_d_hat([d for m in r["movies"] if m["row"] == name for d in m.get("d_fixed", [])])
                                for r in port],
            "jax_mean_d_hat": [_mean_d_hat(r["d_fixed"]) for r in jrows],
            "n_tracks": {"port": [r["n_tracks"] for r in rows], "jax": [r["n_tracks"] for r in jrows]},
        }
        out["held"][f"{name}_fixed_within_limit"] = bool(delta <= limit)
        out["held"][f"{name}_fixed_spread_within_band"] = bool(band[0] <= ratio <= band[1])
    out["ok"] = bool(out["held"]) and all(out["held"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-msd", type=int, default=0, help="JAX's MSD column over this many render keys")
    ap.add_argument("--jax-seeds", type=int, default=0, help="the example's whole study at this many seeds")
    ap.add_argument("--first-jax-seed", type=int, default=0, help="the first seed's offset from 42")
    ap.add_argument("--cycles", type=int, default=PROTOCOL_CYCLES, help="training cycles (other than 60: the cut)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("port_dirs", nargs="*")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cut = args.cycles != PROTOCOL_CYCLES
    if args.jax_msd or args.jax_seeds:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        ex = _example()
    if args.jax_msd:
        t0 = time.perf_counter()
        keys = []
        for k in range(args.jax_msd):
            keys.append(jax_msd_key(ex, k))
            print(json.dumps({"key": k, "msd_mae": {n: r["msd_mae"] for n, r in keys[-1]["rows"].items()},
                              "t": time.perf_counter() - t0}), flush=True)
        (out / "jax_msd.json").write_text(json.dumps(
            {"keys": keys, "seconds": time.perf_counter() - t0,
             "command": f"python3 sim2real_outcome.py --jax-msd {args.jax_msd}"}, indent=1) + "\n")
    if args.jax_seeds and cut:
        for k in range(args.first_jax_seed, args.first_jax_seed + args.jax_seeds):
            seed = jax_seed(ex, k, None, args.cycles, CUT_ARMS)
            command = f"python3 sim2real_outcome.py --jax-seeds 1 --first-jax-seed {k} --cycles {args.cycles}"
            (out / f"jax_cut{args.cycles}_seed{seed['seed']}.json").write_text(
                json.dumps({**seed, "command": command}, indent=1) + "\n")
    elif args.jax_seeds:
        seeds = [jax_seed(ex, k, JAX_SEED_LIMIT_S) for k in range(args.jax_seeds)]
        (out / "jax_seeds.json").write_text(json.dumps(
            {"seeds": seeds, "command": f"python3 sim2real_outcome.py --jax-seeds {args.jax_seeds}"},
            indent=1) + "\n")
    if args.jax_msd or args.jax_seeds:
        return 0
    if cut:
        dirs = args.port_dirs or [ROOT / "results" / f"torch_sim2real_cut{args.cycles}_seed{s}"
                                  for s in range(CUT_PORT_SEEDS)]
        port = [json.loads((Path(d) / "sim2real_report.json").read_text()) for d in dirs]
        jax_seeds = [json.loads(f.read_text()) for f in sorted(out.glob(f"jax_cut{args.cycles}_seed*.json"))]
        verdict = judge_cut(jax_seeds, port, args.cycles)
        (out / f"cut{args.cycles}_verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    else:
        msd = json.loads((out / "jax_msd.json").read_text())["keys"]
        seeds_path = out / "jax_seeds.json"
        seeds = json.loads(seeds_path.read_text())["seeds"] if seeds_path.exists() else []
        port = [json.loads((Path(d) / "sim2real_report.json").read_text()) for d in args.port_dirs or PORT_DIRS]
        verdict = judge(msd, seeds, port, json.loads(RECORD.read_text()))
        (out / "verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    print(json.dumps(verdict, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
