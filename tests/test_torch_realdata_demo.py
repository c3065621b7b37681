"""The port's real-data demo (``realdata.demo``) end to end on the CPU at a
tiny size: the JAX example's movie and tracking, a one-layer patch model at
embed 8, the JAX example's metrics file and the outcome scorer
(``realdata_outcome.py``) on the demo's report. Its movie is held against
JAX's in what the pipeline finds."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import OpticsConfig as JOptics
from moleculardiffusion_mivit_tpu.realdata import analyze_microscopy_sequence as j_analyze
from moleculardiffusion_mivit_tpu.realdata import estimate_d_for_tracks as j_estimate
from moleculardiffusion_mivit_tpu.realdata import extract_particle_patches as j_patches
from moleculardiffusion_mivit_tpu.realdata import refine_localizations as j_refine
from moleculardiffusion_mivit_tpu.sim import render_widefield as j_render_widefield
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.ops import render as trender_ops
from moleculardiffusion_mivit_tpu_torch.realdata import demo

TINY = ModelConfig(patch_size=demo.PATCH, use_pos_encoding=True, embed_dim=8, num_heads=2, hidden_dim=16,
                   num_layers=1)
JAX_KEYS = ["d_true", "n_tracks", "train_cycles", "model_mean", "model_mean_abs_err", "msd_mean",
            "msd_mean_abs_err"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_runs_on_the_cpu_and_writes_the_jax_metrics(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(demo, "MODEL_CONFIG", TINY)
    monkeypatch.setattr(demo, "SEQS_PER_CYCLE", 16)
    report = demo.main(["--train-cycles", "2", "--device", "cpu", "--out", str(tmp_path / "out"),
                        "--tif", str(tmp_path / "movie.tif")])
    written = json.loads((tmp_path / "out" / "realdata_metrics.json").read_text())
    assert list(written) == JAX_KEYS and written == report["summary"]
    assert written["n_tracks"] == 6 and written["train_cycles"] == 2 and written["d_true"] == 0.3
    assert all(np.isfinite(v) for v in written.values())
    assert len(report["train_loss"]) == len(report["s_per_cycle"]) == 2
    assert set(report["stage_s"]) == {"render", "detect", "track", "patches", "localize", "predict"}
    assert (tmp_path / "movie.tif").is_file()
    assert trender_ops.render_frames.launches == 0  # the CPU runs the plain version
    saved = json.loads((tmp_path / "out" / "realdata_report.json").read_text())
    assert saved["summary"] == written and saved["seed"] == 0 and len(saved["d_msd"]) == 6
    assert len(saved["track_particles"]) == 6 and {p for t in saved["track_particles"] for p in t} <= set(range(6))

    # the outcome scorer reads the report and scores the rules
    outcome = _load_script("realdata_outcome")
    rc = outcome.main([str(tmp_path / "out")])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[-3:]]
    assert lines[0]["seed"] == 0 and lines[0]["n_tracks"] == 6
    np.testing.assert_allclose(lines[0]["msd_mean_abs_err"], written["msd_mean_abs_err"], atol=5e-4)
    assert "record" in lines[1] and rc == (0 if all(lines[2]["rules"].values()) else 1)


def test_patch_sequences_follow_the_patch_centre():
    """One cycle's training data: normalised 9×9 videos and D in [0.02, 1]."""
    videos, labels = demo.patch_sequences(torch.Generator().manual_seed(0), 8, 5)
    assert videos.shape == (8, 5, demo.PATCH, demo.PATCH) and labels.shape == (8, 1)
    assert bool(((labels >= 0.02) & (labels <= 1.0)).all())
    # the spot sits within a pixel of the centre in every frame
    peak = videos.reshape(40, -1).argmax(-1)
    assert bool((((peak // demo.PATCH) - 4).abs() <= 1).all() and (((peak % demo.PATCH) - 4).abs() <= 1).all())


def test_demo_movie_tracks_as_the_jax_movie():
    """The port's movie of the JAX example's trajectories and JAX's own
    render of them (other noise draws) give the same number of tracks, each
    within a pixel of one of JAX's over the frames they share."""
    trajs = demo.movie_trajectories()
    assert trajs.shape == (6, 250, 2)
    movie = demo.render_widefield(torch.Generator().manual_seed(0), torch.tensor(trajs, dtype=torch.float32),
                                  demo.N_POS, demo.FIELD, demo.OPTICS).numpy()
    j_optics = JOptics(**{f: getattr(demo.OPTICS, f) for f in (
        "particle_intensity", "psf_division_factor", "output_size", "background_intensity", "poisson_noise",
        "trajectory_unit")})
    j_movie = np.asarray(j_render_widefield(jax.random.key(0), jnp.asarray(trajs, jnp.float32), demo.N_POS,
                                            demo.FIELD, j_optics))
    tracks = demo.analyze_microscopy_sequence(movie, device="cpu", **demo.TRACKING)[0]
    j_tracks = j_analyze(j_movie, **demo.TRACKING)[0]
    assert len(tracks) == len(j_tracks) == 6

    def distance(a, b):  # mean distance over the frames both tracks hold
        pa, pb = ({f: np.array(yx) for f, *yx in t} for t in (a, b))
        common = pa.keys() & pb.keys()
        return np.mean([np.hypot(*(pa[f] - pb[f])) for f in common]) if common else np.inf

    for t in tracks.values():
        assert min(distance(t, jt) for jt in j_tracks.values()) <= 1.0


def test_the_jax_pipeline_swaps_identities_on_the_demo_movie_too():
    """The demo's MSD baseline is sensitive to the tracker's identity swaps:
    particles 0 and 3 of the demo's trajectories pass within ~6 px of each
    other, under the 8 px linking gate. JAX's own pipeline, on its render of
    the movie at key 1, gives a track that follows both, and that track's
    MSD D is several times the truth; the port's ``track_identities`` sees
    the swap in JAX's tracks."""
    trajs = demo.movie_trajectories()
    j_optics = JOptics(**{f: getattr(demo.OPTICS, f) for f in (
        "particle_intensity", "psf_division_factor", "output_size", "background_intensity", "poisson_noise",
        "trajectory_unit")})
    movie = np.asarray(j_render_widefield(jax.random.key(1), jnp.asarray(trajs, jnp.float32), demo.N_POS,
                                          demo.FIELD, j_optics))
    tracks = j_analyze(movie, **demo.TRACKING)[0]
    refined = j_refine(tracks, j_patches(movie, tracks, demo.PATCH), demo.PATCH)
    d = j_estimate(tracks, movie, lambda v: jnp.zeros((v.shape[0], 1)), patch_size=demo.PATCH,
                   msd_calibration=0.375, refined_positions=refined)
    identities = demo.track_identities(tracks, refined)
    swapped = [t for t, parts in identities.items() if len(parts) > 1]
    assert len(tracks) == 6 and [identities[t] for t in swapped] == [[0, 3]]
    assert all(d[t]["d_msd"] > 2 * demo.D_TRUE for t in swapped)


def test_demo_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--train-cycles", "1", "--out", str(tmp_path)])


def test_f6_the_ports_seeds_judged_against_the_jax_key_spread():
    """Fault F6 (ROADMAP.md section 3) by the rule fixed before the runs
    (``realdata_msd_spread.py``): the JAX pipeline's MSD(τ=1) error over 64
    render keys of the demo's movie (``results/realdata_msd_spread``, JAX on
    the CPU, no training) against the port's four seeds
    (``results/torch_realdata_demo_seed0-3``). Key 0 is the JAX record's
    render and reproduces its error. Every port seed lies inside JAX's
    range (rule 1 holds), but the port's mean lies below JAX's by more
    than two standard errors (rule 2 misses): JAX's movies swap an identity
    in 48 of 64 keys, the port's in 1 of 4 seeds. So F6 stays open, with
    these numbers. The port's own pipeline on the CPU over 64 render seeds
    (``port_spread.json``, which the rule does not read) swaps in 47."""
    spread = _load_script("realdata_msd_spread")
    keys = json.loads((spread.OUT / "msd_spread.json").read_text())
    verdict = spread.judge(keys, spread.port_seeds())
    record = json.loads((spread.ROOT / "results" / "realdata_demo" / "realdata_metrics.json").read_text())
    assert abs(keys["keys"][0]["msd_mean_abs_err"] - record["msd_mean_abs_err"]) < 5e-4
    assert verdict["jax_keys"] == 64 and verdict["jax_keys_with_a_swap"] == 48
    assert verdict["rules"] == {"every_port_seed_within_jax_range": True, "port_mean_within_2_se_of_jax_mean": False}
    assert not verdict["closed"] and verdict["port_mean"] < verdict["jax_mean"]
    port = json.loads((spread.OUT / "port_spread.json").read_text())["summary"]
    assert port["seeds"] == 64 and port["with_a_swap"] == 47


def test_f6_closed_by_the_spread_rule_on_fresh_keys():
    """Fault F6 by the second rule of ``realdata_msd_spread.py``, fixed
    before its runs: JAX's pipeline over render keys 64-127 and the port's
    on the CPU over seeds 64-127 (``*_from64.json``). Their swap rates lie
    within two binomial standard errors (45 and 46 of 64) and their MSD
    mean errors within two pooled standard errors, so F6 closes as the
    pipeline's own spread."""
    spread = _load_script("realdata_msd_spread")
    keys = json.loads((spread.OUT / "msd_spread_from64.json").read_text())["keys"]
    port = json.loads((spread.OUT / "port_spread_from64.json").read_text())["seeds"]
    assert [k["key"] for k in keys] == list(range(64, 128)) and [s["seed"] for s in port] == list(range(64, 128))
    verdict = spread.judge_spreads(keys, port)
    assert verdict["n"] == 64 and round(verdict["jax_swap_rate"] * 64) == 45 and round(verdict["port_swap_rate"] * 64) == 46
    assert verdict["rules"] == {"swap_rates_within_2_binomial_se": True, "msd_means_within_2_pooled_se": True}
    assert verdict["closed"]
    with pytest.raises(ValueError, match="as many seeds as keys"):
        spread.judge_spreads(keys, port[:10])
