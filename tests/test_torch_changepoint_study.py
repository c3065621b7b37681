"""The port's change-point studies (``evaluation.changepoint_study``) on the
CPU at tiny sizes, against the JAX examples
``examples/sequence_changepoint_modular.py`` and
``examples/sequence_changepoint_demo.py`` (imported by path): the tail swap
over four arrays, the Wilson interval, the scoring with JAX's
``detect_change_points``, the study's data given JAX's trajectories, one
AdamW step of each sequence-mode arm, both subcommands end to end, and the
outcome rule of ``changepoint_outcome.py`` on synthetic and on the shipped
card reports."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import OpticsConfig as JOptics
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.evaluation import detect_change_points as j_detect
from moleculardiffusion_mivit_tpu.features import compute_features_for_multiple_trajectories as j_features
from moleculardiffusion_mivit_tpu.features import compute_per_frame_features as j_per_frame
from moleculardiffusion_mivit_tpu.models import HybridFusionTransformer as JHybrid
from moleculardiffusion_mivit_tpu.models import ModularTransformer as JModular
from moleculardiffusion_mivit_tpu.sim import normalize_images as j_normalize
from moleculardiffusion_mivit_tpu.sim import single_state as j_single_state
from moleculardiffusion_mivit_tpu.sim import trajectories_to_video as j_to_video
from moleculardiffusion_mivit_tpu.sim.trajectory import average_trajectories_frames as j_average
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS
from moleculardiffusion_mivit_tpu_torch.evaluation import changepoint as tcp
from moleculardiffusion_mivit_tpu_torch.evaluation import changepoint_study as study
from moleculardiffusion_mivit_tpu_torch.features.features import FEATURE_NAMES, PARITY_TOLERANCE
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from tests.test_torch_train import _step_matches_jax

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=8, num_heads=2, hidden_dim=16, num_layers=1)
SMALL = dict(embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
OPTICS_FIELDS = ("particle_intensity", "na", "wavelength", "psf_division_factor", "resolution", "output_size",
                 "upsampling_factor", "background_intensity", "poisson_noise", "trajectory_unit")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def modular_example():
    return _load(ROOT / "examples" / "sequence_changepoint_modular.py", "changepoint_modular_example")


@pytest.fixture(scope="module")
def outcome():
    return _load(ROOT / "changepoint_outcome.py", "changepoint_outcome")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_splits(key, n_frames, quarter):
    """The splits the example's ``mix_tails_multi`` draws, pair by pair."""
    return [torch.from_numpy(np.array(jax.random.randint(jax.random.fold_in(key, i), (quarter,), n_frames // 2 - 5,
                                                         n_frames // 2 + 5))) for i in range(4)]


def test_mix_tails_multi_matches_the_example_given_its_splits(modular_example, monkeypatch):
    """Handed the splits the example draws (``fold_in(key, pair)``), the
    port's ``mix_tails_multi`` gives the example's videos, per-frame labels,
    tokens and averaged trajectories bitwise; unswapped rows stay, and with
    fewer than four classes or a quarter of 0 nothing moves."""
    rng = np.random.default_rng(0)
    n_classes, n_per, f = 4, 8, 14
    n = n_classes * n_per
    arrays = (rng.normal(size=(n, f, 3, 3)).astype(np.float32), rng.uniform(0.5, 7, size=(n, f)).astype(np.float32),
              rng.normal(size=(n, f, 6)).astype(np.float32), rng.normal(size=(n, f, 2)).astype(np.float32))
    key = jax.random.key(3)
    want = modular_example.mix_tails_multi(key, tuple(jnp.asarray(a) for a in arrays), n_classes, f)
    splits = iter(_jax_splits(key, f, n_per // 4))
    monkeypatch.setattr(tloop, "_tail_splits", lambda g, count, frames: next(splits))
    got = tloop.mix_tails_multi(torch.Generator(), tuple(torch.from_numpy(a) for a in arrays), n_classes, f)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[0].numpy(), arrays[0])
    three = tloop.mix_tails_multi(torch.Generator(), tuple(torch.from_numpy(a[:24]) for a in arrays), 3, f)
    assert all(np.array_equal(g.numpy(), a[:24]) for g, a in zip(three, arrays))


def test_wilson_ci_matches_the_example(modular_example):
    for n in (0, 1, 2, 7, 20, 64, 128, 768, 1536):
        for k in sorted({0, 1, n // 3, n // 2, n - 1, n} - {-1}):
            assert tcp.wilson_ci(k, n) == modular_example.wilson_ci(k, n), (k, n)


def _example_scoring(pm, pc, pcal, ml, wilson_ci, thr=None):
    """The two examples' scoring lines (modular :347-379, demo :127-175) on
    per-frame predictions, with JAX's ``detect_change_points`` and the
    modular example's ``wilson_ci``."""
    changed = ml != ml[:, :1]
    has_transition = changed.any(axis=1)
    true_split = np.where(has_transition, changed.argmax(axis=1), -1)
    contrast = np.abs(ml[:, -1] - ml[:, 0])
    split_m, score_m = map(np.asarray, j_detect(jnp.asarray(pm)))
    _, score_c = j_detect(jnp.asarray(pc))
    _, score_cal = j_detect(jnp.asarray(pcal))
    score_c, score_cal = np.asarray(score_c), np.asarray(score_cal)
    sm = score_m[has_transition]
    auc = float((sm[:, None] > score_c[None, :]).mean() + 0.5 * (sm[:, None] == score_c[None, :]).mean())
    thr = float(np.percentile(score_cal, 95.0)) if thr is None else thr
    hit = has_transition & (score_m > thr)
    loc = np.abs(split_m[hit] - true_split[hit])
    by_contrast = {}
    for dd in sorted(set(np.round(contrast[has_transition]).astype(int))):
        sel = has_transition & (np.round(contrast).astype(int) == dd)
        k_det, n_det = int((score_m[sel] > thr).sum()), int(sel.sum())
        by_contrast[f"dD={dd}"] = {"n": n_det, "detected": k_det,
                                   "detection_rate": round(k_det / n_det, 3) if n_det else None,
                                   "ci95": wilson_ci(k_det, n_det),
                                   "mean_score": round(float(score_m[sel].mean()), 2)}
    n_t, k_t = int(has_transition.sum()), int((sm > thr).sum())
    n_c, k_fp = len(score_c), int((score_c > thr).sum())
    return {
        "n_mixed": n_t, "n_controls": n_c, "roc_auc": round(auc, 3), "score_threshold": round(thr, 2),
        "detection_rate": round(float((sm > thr).mean()), 3), "detection_ci95": wilson_ci(k_t, n_t),
        "false_positive_rate": round(float((score_c > thr).mean()), 3), "false_positive_ci95": wilson_ci(k_fp, n_c),
        "median_split_error_frames": float(np.median(loc)) if len(loc) else None,
        "mean_split_error_frames": round(float(loc.mean()), 2) if len(loc) else None,
        "mean_score_mixed": round(float(score_m[has_transition].mean()), 2),
        "mean_score_const": round(float(score_c.mean()), 2), "by_contrast": by_contrast,
    }


@pytest.mark.parametrize("threshold", [None, 3.5])
def test_score_planted_matches_the_examples_scoring(modular_example, threshold):
    """Given the same per-frame predictions of a planted set (four classes,
    the first half of each swapped at a known frame), its controls and a
    calibration split, ``score_planted`` gives every field of both
    examples' reports as their lines compute them with JAX's
    ``detect_change_points``; ``select_fields`` picks each example's in its
    order."""
    rng = np.random.default_rng(4)
    n_per, f = 48, 30
    d = np.repeat(np.array([1.0, 3.0, 5.0, 7.0]), n_per) + rng.normal(0, 1, size=4 * n_per)
    d = np.clip(d, 0.05, None)
    labels = np.broadcast_to(d[:, None], (4 * n_per, f)).astype(np.float32)
    (planted_labels,) = tloop.mix_tails_multi(torch.Generator().manual_seed(2), (torch.from_numpy(labels.copy()),),
                                              4, f)
    planted_labels = planted_labels.numpy()
    noise = lambda: rng.normal(0, 0.6, size=labels.shape).astype(np.float32)  # noqa: E731
    pm, pc, pcal = planted_labels + noise(), labels + noise(), labels + noise()
    want = _example_scoring(pm, pc, pcal, planted_labels, modular_example.wilson_ci, threshold)
    got = tcp.score_planted(torch.from_numpy(pm), torch.from_numpy(pc), torch.from_numpy(pcal),
                            torch.from_numpy(planted_labels), threshold=threshold)
    assert got == want
    assert 0.6 < got["roc_auc"] < 1.0 and got["n_mixed"] == 2 * n_per and got["n_controls"] == 4 * n_per
    demo = tcp.select_fields(got, tcp.DEMO_FIELDS)
    assert list(demo) == ["n_mixed", "n_controls", "roc_auc", "score_threshold", "detection_rate",
                          "false_positive_rate", "median_split_error_frames", "mean_split_error_frames",
                          "mean_score_mixed", "mean_score_const", "by_contrast"]
    assert all(list(c) == ["n", "detection_rate", "mean_score"] for c in demo["by_contrast"].values())
    modular = tcp.select_fields(got, tcp.MODULAR_FIELDS)
    record = json.loads((ROOT / "results" / "changepoint_modular_r5" / "changepoint_modular.json").read_text())
    assert list(modular) == list(record["mod_images"])
    assert all(list(c) == list(next(iter(record["mod_images"]["by_contrast"].values())))
               for c in modular["by_contrast"].values())


def _quiet(optics):
    """The optics with every noise term off but a particle intensity spread
    of 1e-3 (the renderer draws no particle below 1e-4)."""
    return optics.replace(particle_intensity=(optics.particle_intensity[0], 1e-3),
                          background_intensity=(optics.background_intensity[0], 0.0), poisson_noise=-1)


def test_study_data_matches_the_example_given_jax_trajectories(monkeypatch):
    """The study's ``generate`` handed JAX's ``single_state`` draws (the
    example's per-class trajectories and labels) with quiet optics: videos
    at 1e-5 of their largest value, per-frame labels and averaged
    trajectories at 1e-6, tokens at 1e-5, against the example's lines in
    JAX; after the same tail swaps (the example's splits), the hybrid's
    packed tensor: the tokens as they are and the 25 global features of the
    spliced trajectories at ``PARITY_TOLERANCE``."""
    cfg = study.study_train_config(4)
    p, f, n = cfg.n_pos_per_frame, cfg.n_frames, 4
    optics = _quiet(BASELINE_OPTICS)
    joptics = JOptics(**{k: getattr(optics, k) for k in OPTICS_FIELDS})
    jcfg = JTrainConfig(sequences_per_d=n, training_ds=cfg.training_ds, sequence_mode=True, mix_trajectories=True)
    draws = [j_single_state(jax.random.key(10 + i), n, f * p, Ds=tuple(ds)) for i, ds in enumerate(cfg.training_ds)]
    calls = iter(draws)
    monkeypatch.setattr(study, "single_state",
                        lambda g, n_, t_, Ds: tuple(torch.from_numpy(np.asarray(a)) for a in next(calls)))
    got = study.generate(torch.Generator(), cfg, optics, n, mix=False)

    bg_mean, bg_sigma = joptics.background_intensity
    videos, labels, avgs = [], [], []
    for i, (trajs, labs) in enumerate(draws):
        trajs = trajs / jcfg.traj_div_factor
        v = j_to_video(jax.random.key(i), trajs, p, jcfg.center, joptics)
        videos.append(j_normalize(v, bg_mean, bg_sigma, joptics.particle_intensity[0] + bg_mean)[0])
        avgs.append(j_average(trajs, p))
        labels.append(labs[:, :, 1].reshape(n, f, p).mean(axis=2) / jcfg.d_max_normalization)
    videos, labels, avg = (np.asarray(jnp.concatenate(x)) for x in (videos, labels, avgs))
    pf = np.asarray(j_per_frame(jnp.asarray(avg)))
    np.testing.assert_allclose(got["videos"].numpy(), videos, rtol=0, atol=1e-5 * np.abs(videos).max())
    np.testing.assert_allclose(got["labels"].numpy(), labels, rtol=1e-6)
    np.testing.assert_allclose(got["avg"].numpy(), avg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["pf_features"].numpy(), pf, rtol=1e-5, atol=1e-5)

    key = jax.random.key(8)
    ex = _load(ROOT / "examples" / "sequence_changepoint_modular.py", "changepoint_modular_example_data")
    jmixed = ex.mix_tails_multi(key, (jnp.asarray(pf), jnp.asarray(avg)), 4, f)
    splits = iter(_jax_splits(key, f, n // 4))
    monkeypatch.setattr(tloop, "_tail_splits", lambda g, count, frames: next(splits))
    tmixed = tloop.mix_tails_multi(torch.Generator(), (got["pf_features"], got["avg"]), 4, f)
    packed = study.pack_hybrid({"pf_features": tmixed[0], "avg": tmixed[1]}).numpy()
    jpf, javg = (np.asarray(a) for a in jmixed)
    np.testing.assert_allclose(packed[:, : f * 6], jpf.reshape(4 * n, -1), rtol=1e-5, atol=1e-5)
    want_global = np.asarray(j_features(jnp.asarray(javg), dt=1.0))
    for c, name in enumerate(FEATURE_NAMES):
        rtol, atol = PARITY_TOLERANCE[name]
        np.testing.assert_allclose(packed[:, f * 6 + c], want_global[:, c], rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("study_name", ["demo", "modular"])
def test_continuous_data_matches_jax_given_its_draws(monkeypatch, study_name):
    """The continuous curriculum (``--continuous 0.1,8``) handed JAX's draws
    with quiet optics: the demo's ``baseline.build(sequences=True,
    continuous_d=…)`` ``generate_fn`` against the JAX package's, and the
    modular study's ``generate_continuous`` against the example's lines.
    Each side's D ~ U(0.1, 8), Brownian trajectories and i↔n−1−i tail splits
    (``mix_tails_uniform``: half the sequences) are JAX's; the D the port
    hands the simulator and the per-frame labels at 1e-6, the mixed videos
    at 1e-5 of their largest value, tokens at 1e-5 and averaged
    trajectories at 1e-6."""
    from moleculardiffusion_mivit_tpu.experiments import baseline as jbaseline
    from moleculardiffusion_mivit_tpu.sim.trajectory import brownian_motion as j_brownian
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline as tbaseline

    lo, hi, n = 0.1, 8.0, 4
    optics = _quiet(BASELINE_OPTICS)
    joptics = JOptics(**{k: getattr(optics, k) for k in OPTICS_FIELDS})
    cfg = study.study_train_config(n)
    p, f, n_total = cfg.n_pos_per_frame, cfg.n_frames, 4 * n
    key = jax.random.key(11)
    kd, kt, kr, k_mix = jax.random.split(key, 4)
    jd = jax.random.uniform(kd, (n_total,), minval=lo, maxval=hi)
    jtrajs = j_brownian(kt, n_total, f, p, jd, float(p))
    half = (n_total // 2) // 2
    jsplits = jax.random.randint(k_mix, (half,), f // 2 - 5, f // 2 + 5)

    real_rand, seen_d = torch.rand, []
    unit = torch.from_numpy((np.asarray(jd, np.float64) - lo) / (hi - lo)).float()
    monkeypatch.setattr(torch, "rand", lambda *a, **k: unit.clone() if a == (n_total,) else real_rand(*a, **k))
    monkeypatch.setattr(tloop, "_tail_splits", lambda g, count, frames: torch.from_numpy(np.array(jsplits)))

    def brownian(g, count, frames, pos, d, dt):
        seen_d.append(d.clone())
        return torch.from_numpy(np.array(jtrajs))

    if study_name == "demo":
        monkeypatch.setattr(tbaseline, "BASELINE_OPTICS", optics)
        monkeypatch.setattr(jbaseline, "BASELINE_OPTICS", joptics)
        monkeypatch.setattr(tbaseline, "brownian_motion", brownian)
        kw = dict(sequences=True, continuous_d=(lo, hi), sequences_per_d=n, val_length=f, val_d_values=(1.0,),
                  try_leaky_relu=False)
        want = jbaseline.build(**kw).generate_fn(key)
        got = tbaseline.build(device="cpu", **kw).generate_fn(torch.Generator())
        want = {k: np.asarray(v) for k, v in want.items()}
    else:
        monkeypatch.setattr(study, "brownian_motion", brownian)
        got = study.generate_continuous(torch.Generator(), cfg, optics, n, (lo, hi))
        trajs = jtrajs / cfg.traj_div_factor
        bg_mean, bg_sigma = joptics.background_intensity
        v = j_to_video(kr, trajs, p, cfg.center, joptics)
        v = j_normalize(v, bg_mean, bg_sigma, joptics.particle_intensity[0] + bg_mean)[0]
        avg = j_average(trajs, p)
        labels = jnp.broadcast_to((jd / cfg.d_max_normalization)[:, None], (n_total, f)).astype(jnp.float32)
        ia = jnp.arange(half)
        base = jnp.arange(f)[None, :] >= jsplits[:, None]
        want = {}
        for name, arr in zip(("videos", "labels", "pf_features", "avg"), (v, labels, j_per_frame(avg), avg)):
            mask = base.reshape(base.shape + (1,) * (arr.ndim - 2))
            a, b = arr[ia], arr[(n_total - 1) - ia]
            arr = arr.at[ia].set(jnp.where(mask, b, a))
            want[name] = np.asarray(arr.at[(n_total - 1) - ia].set(jnp.where(mask, a, b)))
        np.testing.assert_allclose(got["pf_features"].numpy(), want["pf_features"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["avg"].numpy(), want["avg"], rtol=1e-6, atol=1e-6)

    (d,) = seen_d
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    assert lo <= float(d.min()) and float(d.max()) < hi
    np.testing.assert_allclose(got["labels"].numpy(), want["labels"], rtol=1e-6)
    videos = want["videos"]
    np.testing.assert_allclose(got["videos"].numpy(), videos, rtol=0, atol=1e-5 * np.abs(videos).max())
    swapped = (got["labels"][:, 0] != got["labels"][:, -1]).sum().item()
    assert swapped == 2 * half  # both partners of each of the first n/4 pairs carry a transition


def test_study_sampler_matches_jax_in_distribution():
    """The study's own draw (``generate`` over 96 sequences a class) against
    JAX's ``single_state`` per class: the per-sequence D labels' mean and
    sd, and the per-frame token of squared steps' mean over the class,
    within 4 standard errors; every class's tail swaps keep the labels'
    values (a swapped row's two halves come from two rows of the classes
    paired)."""
    cfg = study.study_train_config(96)
    n, p, f = 96, cfg.n_pos_per_frame, cfg.n_frames
    got = study.generate(torch.Generator().manual_seed(5), cfg, BASELINE_OPTICS, n, mix=False)
    for i, ds in enumerate(cfg.training_ds):
        trajs, labs = j_single_state(jax.random.key(30 + i), n, f * p, Ds=tuple(ds))
        jd = np.asarray(labs[:, 0, 1])
        td = got["labels"][i * n:(i + 1) * n, 0].numpy() * cfg.d_max_normalization
        se = np.sqrt(jd.var() / n + td.var() / n)
        assert abs(jd.mean() - td.mean()) <= 4 * se, (ds, jd.mean(), td.mean())
        assert abs(jd.std() - td.std()) <= 4 * np.sqrt((jd.var() + td.var()) / (2 * n)), (ds, jd.std(), td.std())
        jstep = np.asarray(j_per_frame(j_average(trajs / cfg.traj_div_factor, p)))[:, 1:, 2].mean(axis=1)
        tstep = got["pf_features"][i * n:(i + 1) * n, 1:, 2].mean(dim=1).numpy()
        se = np.sqrt(jstep.var() / n + tstep.var() / n)
        assert abs(jstep.mean() - tstep.mean()) <= 4 * se, (ds, jstep.mean(), tstep.mean())
    mixed = study.generate(torch.Generator().manual_seed(5), cfg, BASELINE_OPTICS, n, mix=True)
    assert not torch.equal(mixed["labels"], got["labels"])
    assert torch.equal(torch.sort(mixed["labels"].flatten())[0], torch.sort(got["labels"].flatten())[0])


ARMS = {
    "mod_images": (JModular, dict(mode="images_only", image_embedding="deep_resnet", features_dim=6,
                                  feature_embedding_type="mlp", fusion_method="concat_proj"), (6, 6)),
    "mod_both_concat": (JModular, dict(mode="both", image_embedding="deep_resnet", features_dim=6,
                                       feature_embedding_type="mlp", fusion_method="concat_proj"), (6, 6)),
    "mod_hybrid": (JHybrid, dict(image_embedding="deep_resnet", per_frame_dim=6, global_dim=25,
                                 fusion_method="concat_proj"), (6 * 6 + 25,)),
}


@pytest.mark.parametrize("name", list(ARMS))
def test_one_adamw_step_of_each_sequence_mode_arm_matches_jax(name):
    """Each arm of the study as the example builds it (``MODEL_CONFIG``:
    positional encoding, no regression token, a prediction per frame) at a
    small width, one AdamW step from flax's weights on per-frame labels and
    the features the example hands it, at the tolerances of
    ``test_torch_train.test_one_train_step_matches_jax``."""
    jcls, kw, shape = ARMS[name]
    cfg = study.MODEL_CONFIG.replace(**SMALL)
    tmodel = study.modular_arms(True, cfg)[name].model
    jmodel = jcls(JModelConfig(**{k: getattr(cfg, k) for k in (*SMALL, "use_pos_encoding", "use_regression_token",
                                                                "single_prediction")}), **kw)
    _step_matches_jax(jmodel, tmodel, "mse", with_features=True, feature_shape=shape, per_frame_labels=True)


def test_modular_subcommand_runs_tiny_on_the_cpu(monkeypatch, tmp_path, modular_example):
    """``main(["modular", "--with-hybrid", ...])`` on the CPU at a tiny width:
    three arms trained two cycles, each arm's losses finite, the report
    with the example's keys and per-arm fields, the planted set of 16
    sequences scored against 32 controls."""
    monkeypatch.setattr(study, "MODEL_CONFIG", study.MODEL_CONFIG.replace(**TINY))
    out = study.main(["modular", "--with-hybrid", "--cycles", "2", "--seqs-per-d", "4", "--eval-per-class", "8",
                      "--device", "cpu", "--out", str(tmp_path)])
    report = json.loads((tmp_path / "changepoint_modular.json").read_text())
    record = json.loads((ROOT / "results" / "changepoint_modular_r5" / "changepoint_modular.json").read_text())
    assert list(report) == list(record)
    assert report == out["report"] and report["n_mixed"] == 16 and report["n_controls"] == 32
    assert all(list(report[a]) == list(record["mod_images"]) for a in ARMS)
    assert all(len(v) == 2 and np.isfinite(v).all() for v in out["train_loss"].values())
    full = json.loads((tmp_path / "changepoint_modular_report.json").read_text())
    assert full["seed"] == 0 and full["card"] == "cpu" and full["seconds"] > 0


def test_demo_subcommand_runs_tiny_on_the_cpu(monkeypatch, tmp_path):
    """``main(["demo", ...])`` on the CPU: the baseline experiment's four
    relu arms (leaky ones off to keep it short) in sequence mode, one
    cycle, validated, then the planted transitions (8 a class here, 64 in
    the study) scored: the report has the example's keys in its order."""
    import functools

    from moleculardiffusion_mivit_tpu_torch import evaluation as tval
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline

    monkeypatch.setattr(baseline, "load_validation_trajectories", lambda length, device: tval.generate_frozen_validation(
        d_values=(1, 3, 5, 7), n_particles=2, t_steps=10 * length, in_order_particles=1, device=device))
    monkeypatch.setattr(baseline, "build", functools.partial(baseline.build, try_leaky_relu=False))
    monkeypatch.setattr(study, "DEMO_EVAL_PER_CLASS", 8)
    out = study.main(["demo", "--cycles", "1", "--seqs-per-d", "2", "--device", "cpu", "--out", str(tmp_path)])
    report = json.loads((tmp_path / "changepoint_metrics.json").read_text())
    record = json.loads((ROOT / "results" / "changepoint_scaled" / "changepoint_metrics.json").read_text())
    assert list(report) == list(record) and report == out["report"]
    assert report["n_controls"] == 4 * study.DEMO_EVAL_PER_CLASS and report["model"] == "deepcnn_2layer_s"
    assert set(out["val_avg"]) == {"linear_2layer_s", "cnn_2layer_s", "deepcnn_2layer_s", "resnet"}


def test_study_needs_a_card_or_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("demo", "modular"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            study.main([cmd, "--cycles", "1", "--out", str(tmp_path)])


def _modular_report(seed, auc, det):
    return {"seed": seed, **{a: {"roc_auc": auc[a], "detection_rate": det[a], "false_positive_rate": 0.05,
                                 "median_split_error_frames": 0.0, "by_contrast": {}} for a in auc}}


def test_outcome_rule_holds_and_misses_on_synthetic_reports(outcome):
    """The rule of ``changepoint_study.py``'s docstring: every statistic
    inside its limit holds; a port arm 0.05 below JAX's AUC with a tight
    spread, a demo AUC 0.1 off the record, and a seed where images-only
    beats a feature arm each miss their own rule and nothing else."""
    jax_auc = [{"mod_images": 0.85 + 0.004 * s, "mod_both_concat": 0.94 + 0.005 * s, "mod_hybrid": 0.96 + 0.003 * s}
               for s in range(3)]
    jax_det = [{"mod_images": 0.47 + 0.02 * s, "mod_both_concat": 0.80 + 0.03 * s, "mod_hybrid": 0.87 + 0.02 * s}
               for s in range(3)]
    jax = [_modular_report(s, jax_auc[s], jax_det[s]) for s in range(3)]
    port = [_modular_report(s, {a: v + 0.003 * (s - 1.5) for a, v in jax_auc[1].items()},
                            {a: v + 0.01 * (s - 1.5) for a, v in jax_det[1].items()}) for s in range(4)]
    demo = [{"seed": s, "roc_auc": 0.86 + 0.01 * (s - 1.5), "detection_rate": 0.42, "false_positive_rate": 0.05}
            for s in range(4)]
    record = {"roc_auc": 0.865, "detection_rate": 0.414, "false_positive_rate": 0.023}
    verdict = outcome.judge(port, jax, demo, record)
    assert verdict["ok"] and len(verdict["held"]) == 3 * 2 + 2

    low = json.loads(json.dumps(port))
    for r in low:
        r["mod_both_concat"]["roc_auc"] -= 0.05
    far = [dict(r, roc_auc=r["roc_auc"] - 0.1) for r in demo]
    verdict = outcome.judge(low, jax, far, record)
    assert [k for k, v in verdict["held"].items() if not v] == ["modular_mod_both_concat_roc_auc", "demo_roc_auc"]
    flipped = json.loads(json.dumps(port))
    flipped[2]["mod_images"]["roc_auc"] = 0.99
    verdict = outcome.judge(flipped, jax, demo, record)
    missed = [k for k, v in verdict["held"].items() if not v]
    assert "modular_images_auc_below_both_feature_arms_every_seed" in missed


def test_studies_on_the_card_judged_by_the_rule(outcome):
    """The committed verdict reads as the rule says: the port's four card
    seeds of each study (``results/torch_changepoint_{modular,demo}_seed0-3``,
    the protocol of the rule, run on an H100) against JAX's records, judged
    again here, give the committed ``results/changepoint_outcome/verdict.json``."""
    modular = [json.loads((d / outcome.MODULAR_FILE).read_text()) for d in outcome.PORT_MODULAR]
    demo = [json.loads((d / outcome.DEMO_FILE).read_text()) | {"seed": s}
            for s, d in zip(outcome.PORT_SEEDS, outcome.PORT_DEMO)]
    assert [r["seed"] for r in modular] == [0, 1, 2, 3]
    assert all((r["cycles"], r["seqs_per_d"], r["eval_per_class"], r["n_mixed"]) == (150, 256, 384, 768)
               and "mod_hybrid" in r for r in modular)
    assert all((r["cycles"], r["seqs_per_d"], r["n_mixed"], r["n_controls"]) == (150, 256, 128, 256) for r in demo)
    for d in outcome.PORT_MODULAR + outcome.PORT_DEMO:
        name = "changepoint_modular_report.json" if "modular" in d.name else "changepoint_metrics_report.json"
        assert json.loads((d / name).read_text())["card"].startswith("NVIDIA H100")
    jax_runs = [json.loads((d / outcome.MODULAR_FILE).read_text()) for d in outcome.JAX_MODULAR]
    verdict = outcome.judge(modular, jax_runs, demo, json.loads((outcome.DEMO_RECORD / outcome.DEMO_FILE).read_text()),
                            json.loads((outcome.DEMO_REPORTED / outcome.DEMO_FILE).read_text()), outcome._continuous())
    assert json.loads(json.dumps(verdict)) == json.loads((outcome.OUT / "verdict.json").read_text())
