"""The port's change-point studies (``evaluation.changepoint_study``) on the
CPU at tiny sizes, against the JAX examples
``examples/sequence_changepoint_modular.py`` and
``examples/sequence_changepoint_demo.py`` (imported by path): the tail swap
over four arrays, the Wilson interval, the scoring with JAX's
``detect_change_points``, the study's data given JAX's trajectories, one
AdamW step of each sequence-mode arm, one whole cycle of the demo's arm
through the port's ``Experiment`` step by step against JAX's (the trainer
witness, on both curricula), both subcommands end to end, the JAX side of
the continuous-curriculum demo's seeds, and the outcome rules of
``changepoint_outcome.py`` on synthetic and on the shipped reports."""

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


def test_shared_eval_scores_a_given_set_as_the_demo_scores_its_own(monkeypatch):
    """``changepoint_shared_eval.shared_seed`` on the CPU, cut as the test
    above: one C1-style demo run, then the given set scored through
    ``score_on``. Handed the demo's own planted set (8 a class from the
    stream 777, built as ``run_demo`` builds it), it reads the demo's own
    report and ``const_frame_sd`` exactly, so the scores it gives on JAX's
    set differ from the port's own only by the set."""
    import functools

    from moleculardiffusion_mivit_tpu_torch import evaluation as tval
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline
    from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data, mix_trajectory_tails
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    monkeypatch.setattr(baseline, "load_validation_trajectories", lambda length, device: tval.generate_frozen_validation(
        d_values=(1, 3, 5, 7), n_particles=2, t_steps=10 * length, in_order_particles=1, device=device))
    monkeypatch.setattr(baseline, "build", functools.partial(baseline.build, try_leaky_relu=False))
    monkeypatch.setattr(study, "DEMO_EVAL_PER_CLASS", 8)
    exp = baseline.build(sequences=True, sequences_per_d=2, device="cpu")
    cfg = exp.train_cfg.replace(sequences_per_d=8)
    g = seeded_generator(exp.device, study.EVAL_STREAM)
    videos, labels = generate_cycle_data(fold_in(g, 0), cfg, exp.optics)
    mixed, mixed_labels = mix_trajectory_tails(fold_in(g, 1), videos, labels, len(cfg.training_ds), cfg.n_frames)
    cal_videos, cal_labels = generate_cycle_data(fold_in(g, 2), cfg, exp.optics)
    own_set = {f"{name}_{k}": t.numpy() for name, pair in (("mixed", (mixed, mixed_labels)), ("const", (videos, labels)),
                                                            ("cal", (cal_videos, cal_labels)))
               for k, t in zip(("videos", "labels"), pair)}
    shared = _load(ROOT / "changepoint_shared_eval.py", "changepoint_shared_eval")
    r = shared.shared_seed("discrete", 0, own_set, "cpu", cycles=1, seqs_per_d=2)
    assert r["jax_set"] == {k: r["own_set"][k] for k in tcp.DEMO_FIELDS} and r["own_set"]["n_controls"] == 32
    assert r["jax_set_const_frame_sd"] == r["own_set_const_frame_sd"]
    assert r["command"] == "python3 changepoint_shared_eval.py --seeds 0 --device cpu"


def test_study_needs_a_card_or_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("demo", "modular"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            study.main([cmd, "--cycles", "1", "--out", str(tmp_path)])


def _modular_report(seed, auc, det):
    return {"seed": seed, **{a: {"roc_auc": auc[a], "detection_rate": det[a], "false_positive_rate": 0.05,
                                 "median_split_error_frames": 0.0, "by_contrast": {}} for a in auc}}


def test_outcome_rule_holds_and_misses_on_synthetic_reports(outcome):
    """The rules of ``changepoint_study.py``'s docstring: every statistic
    inside its limit holds; a port arm 0.05 below JAX's AUC with a tight
    spread, a demo AUC 0.1 off the record, and a seed where images-only
    beats a feature arm each miss their own rule and nothing else. The
    continuous-curriculum demo's C1/C2 rules on synthetic seeds: C1's
    AUC within the larger of 0.03 and three pooled standard errors, the
    sign of (discrete − continuous) the same on both sides, and C2's record
    within the port's prediction interval hold; a port whose continuous AUC
    sits 0.16 above JAX's (C1) and 0.11 above the record (C2), with the
    discrete curriculum unchanged, misses those three and nothing else, and
    the merged verdict counts them."""
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

    # the continuous-curriculum demo's rule (C1 at the cut, C2 at the records' protocol)
    def seeds(n, auc, step, first=0):
        return [{"seed": first + s, "roc_auc": auc + step * (s - (n - 1) / 2), "detection_rate": 0.4,
                 "mean_score_mixed": 3.0, "mean_score_const": 1.5, "const_frame_sd": 0.2} for s in range(n)]

    c1_port = {"continuous": seeds(8, 0.70, 0.005), "discrete": seeds(8, 0.74, 0.005)}
    c1_jax = {"continuous": seeds(4, 0.71, 0.005, 1), "discrete": seeds(4, 0.75, 0.005, 1)}
    c2_port = {"continuous": seeds(4, 0.78, 0.01), "discrete": seeds(4, 0.84, 0.01)}
    records = {"continuous": {"roc_auc": 0.767}, "discrete": {"roc_auc": 0.845}}
    held = outcome.judge_continuous_demo(c1_port, c1_jax, c2_port, records)
    assert held["ok"] and set(held["held"]) == {"c1_continuous_roc_auc", "c1_discrete_roc_auc", "c1_direction",
                                                 "c2_continuous_roc_auc", "c2_discrete_roc_auc"}
    assert held["c1"]["continuous"]["roc_auc"]["limit"] == 0.03  # the floor: 3 pooled se is below it here
    merged = outcome.with_continuous_demo(verdict, held)
    assert set(merged["held"]) == set(verdict["held"]) | {f"demo_{k}" for k in held["held"]} and not merged["ok"]
    missed = outcome.judge_continuous_demo({"continuous": seeds(8, 0.87, 0.01), "discrete": c1_port["discrete"]},
                                           c1_jax, {"continuous": seeds(4, 0.873, 0.005), "discrete": c2_port["discrete"]},
                                           records)
    assert [k for k, v in missed["held"].items() if not v] == ["c1_continuous_roc_auc", "c1_direction",
                                                               "c2_continuous_roc_auc"]
    assert missed["c1"]["discrete_minus_continuous"]["port"] < 0 < missed["c1"]["discrete_minus_continuous"]["jax"]

    # reported, not held: the port's C1 seeds re-run and scored on JAX's evaluation set
    def shared(own, on_jax, digest="d"):
        return [{"seed": r["seed"], "card": "H100", "own_set": r, "own_set_const_frame_sd": 0.2,
                 "jax_set": dict(r, roc_auc=a), "jax_set_const_frame_sd": 0.25, "jax_set_sha256": digest}
                for r, a in zip(own, on_jax)]

    c1_jax_set = {c: [dict(r, eval_set_sha256="d") for r in runs] for c, runs in c1_jax.items()}
    rerun = {c: shared(c1_port[c], [r["roc_auc"] + 0.01 for r in c1_jax[c] * 2]) for c in outcome.CURRICULA}
    report = outcome.judge_shared_eval(rerun, c1_jax_set, c1_port)
    assert report["one_set"] and report["same_sign_on_jax_set"] and report["continuous"]["roc_auc"]["within"]
    assert report["continuous"]["own_set_repeats_c1"] == 8 and report["cards"] == ["H100"]
    flipped = {"continuous": shared(c1_port["continuous"], [0.80] * 8, "e"), "discrete": rerun["discrete"]}
    report = outcome.judge_shared_eval(flipped, c1_jax_set, c1_port)
    assert not (report["one_set"] or report["same_sign_on_jax_set"] or report["continuous"]["roc_auc"]["within"])
    assert report["discrete"]["roc_auc"]["within"]


def test_jax_single_arm_seed_runs_one_tiny_cycle(monkeypatch):
    """``changepoint_jax_seeds.jax_demo_seed``, the JAX side of the C1 seeds,
    on the CPU at a tiny width (the JAX package's baseline ``ModelConfig``
    and its validation trajectories cut here, as the port's tests cut
    theirs): one cycle of 2 sequences a class with ``deepcnn_2layer_s`` the
    experiment's only arm, built at seed 3, on the continuous curriculum,
    then the example's own evaluation (64 a class from key 777: 128 planted
    transitions against 256 controls). The report has the example's keys
    in its order, and the seed file the seed, the seconds,
    ``const_frame_sd`` of the controls' predictions (the second of the
    example's three, recorded only after ``run`` returns, whose last cycle
    predicts the validation set through the same method) and the
    evaluation set's digest, the same as the committed seeds'."""
    from moleculardiffusion_mivit_tpu.evaluation import validation as jvalidation
    from moleculardiffusion_mivit_tpu.experiments import baseline as jbaseline

    monkeypatch.setattr(jbaseline, "ModelConfig", lambda **kw: JModelConfig(**kw).replace(**TINY))
    monkeypatch.setattr(jbaseline, "load_validation_trajectories", _tiny_validation(jvalidation))
    seeds = _load(ROOT / "changepoint_jax_seeds.py", "changepoint_jax_seeds")
    seed = seeds.jax_demo_seed(3, 1, "0.1,8", seqs_per_d=2)
    report = seed["report"]
    record = json.loads((ROOT / "results" / "changepoint_scaled" / "changepoint_metrics.json").read_text())
    assert list(report) == list(record)
    assert (report["cycles"], report["seqs_per_d"], report["n_mixed"], report["n_controls"]) == (1, 2, 128, 256)
    assert report["model"] == "deepcnn_2layer_s" and report["curriculum"] == "continuous U(0.1, 8.0)"
    assert seed["seed"] == 3 and 0 < seed["train_s"] < seed["seconds"] and np.isfinite(seed["const_frame_sd"])
    assert [v["cycle"] for v in seed["validations"]] == [0]
    assert seed["command"] == "python3 changepoint_jax_seeds.py --jax-seeds 1 --first-jax-seed 3 --cycles 1 --continuous 0.1,8"
    # only the example's three predictions, not the validation run() makes at its last cycle
    preds, eval_set = seed["arrays"]["preds"], seed["arrays"]["eval_set"]
    assert list(preds) == ["mixed", "const", "cal"] and all(p.shape == (256, 30) for p in preds.values())
    assert seed["const_frame_sd"] == seeds.const_frame_sd(preds["const"])
    assert seed["const_frame_sd"] != seeds.const_frame_sd(preds["mixed"])
    assert eval_set["mixed_videos"].shape == eval_set["const_videos"].shape == (256, 30, 9, 9)
    committed = json.loads((ROOT / "results" / "changepoint_outcome" / "jax_cut10_discrete_seed1.json").read_text())
    assert seed["eval_set_sha256"] == committed["eval_set_sha256"]  # the set does not depend on the training


def test_studies_on_the_card_judged_by_the_rule(outcome):
    """The committed verdict reads as the rules say: the port's four card
    seeds of each study (``results/torch_changepoint_{modular,demo}_seed0-3``,
    the protocol of the rule, run on an H100) against JAX's records, and the
    continuous-curriculum demo's C1 (eight card seeds a curriculum at 10
    cycles × 64 against four JAX seeds a curriculum, keys 1-4, made on the
    CPU) and C2 (four card seeds a curriculum at 100 cycles × 64 against
    the two JAX records), each run at its rule's protocol, and the C1 seeds
    re-run on the card and scored on JAX's evaluation set too (one set,
    by its digest), judged again here, give the committed
    ``results/changepoint_outcome/verdict.json``. Each JAX seed file names
    the wrapper's command and its ``const_frame_sd`` is that of the
    controls' predictions saved beside it."""
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

    c1_port, c1_jax, c2_port, records = outcome.load_continuous_demo()
    for curr in outcome.CURRICULA:
        label = "continuous U(0.1, 8.0)" if curr == "continuous" else "discrete 4-class"
        for runs, cycles, seeds in ((c1_port, 10, range(8)), (c1_jax, 10, range(1, 5)), (c2_port, 100, range(4))):
            assert [r["seed"] for r in runs[curr]] == list(seeds)
            assert all((r["cycles"], r["seqs_per_d"], r["n_mixed"], r["n_controls"], r["curriculum"])
                       == (cycles, 64, 128, 256, label) and r["seconds"] > 0 for r in runs[curr])
        assert all(r["card"].startswith("NVIDIA H100") for r in c1_port[curr] + c2_port[curr])
    seeds = _load(ROOT / "changepoint_jax_seeds.py", "changepoint_jax_seeds")
    for curr in outcome.CURRICULA:
        for r in c1_jax[curr]:
            path = outcome.c1_jax_file(curr, r["seed"])
            command = json.loads(path.read_text())["command"]
            assert command.startswith(f"python3 changepoint_jax_seeds.py --jax-seeds 1 --first-jax-seed {r['seed']} ")
            with np.load(str(path).replace(".json", "_preds.npz")) as preds:
                assert sorted(preds) == sorted(seeds.PRED_SETS) and all(preds[k].shape == (256, 30) for k in preds)
                assert r["const_frame_sd"] == seeds.const_frame_sd(preds["const"])
    continuous_demo = outcome.judge_continuous_demo(c1_port, c1_jax, c2_port, records)
    shared = outcome.load_shared_eval()
    assert shared is not None
    for curr in outcome.CURRICULA:
        assert [r["seed"] for r in shared[curr]] == list(outcome.C1_PORT_SEEDS)
        assert all(r["own_set"]["cycles"] == 10 and r["jax_set"]["n_controls"] == 256 for r in shared[curr])
    continuous_demo["shared_eval"] = outcome.judge_shared_eval(shared, c1_jax, c1_port)
    assert continuous_demo["shared_eval"]["one_set"]
    assert all(card.startswith("NVIDIA H100") for card in continuous_demo["shared_eval"]["cards"])
    verdict = outcome.with_continuous_demo(verdict, continuous_demo)
    assert json.loads(json.dumps(verdict)) == json.loads((outcome.OUT / "verdict.json").read_text())


# The demo's trainer witness: one cycle of the demo's arm (the relu member
# of the deep-ResNet pair) through the port's Experiment, step by step
# against JAX's train_step. Width and depth shrink alike on both sides
# (SMALL); everything else is the demo's configuration.
WITNESS_SEQS_PER_D = 4  # 16 sequences a cycle: 16 steps at the first cycles' batch of 1
WITNESS_ARM, WITNESS_PAIR = "deepcnn_2layer_s", ("deepcnn_2layer_s", "deepcnn_2layer_leaky")
KEY_BIASES = {f"transformer.layer_{i}.self_attn.k_proj.bias" for i in range(SMALL["num_layers"])}
CURRICULA = {"continuous": (0.1, 8.0), "discrete": None}
# (loss, tensor) bounds: F7's in float32; in float64 both sides agree to
# ~1e-13 of a tensor's largest entry, so the witness holds them to 1e-10
WITNESS_BOUNDS = {np.float32: (1e-5, 1e-4), np.float64: (1e-10, 1e-10)}
# A parameter whose AdamW first moment after the cycle stays below this
# share of the model's largest first moment has a gradient of zero to
# rounding: its value and moments are float noise, left out of the tensor
# bound on both sides alike (the attention key biases; see the witness)
ZERO_GRADIENT = 1e-12


def _flax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _torch_state(params, batch_stats=None):
    """``utils.convert.torch_state_from_flax`` of the trees in their own
    dtype. The converter works in float32; a float64 tree takes the
    converter's rules here (a Dense kernel transposed, a conv kernel HWIO →
    OIHW, ``scale`` → ``weight``, ``mean``/``var`` → ``running_*``) and must
    round to the converter's own output."""
    from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

    params, batch_stats = _flax_tree(params), _flax_tree(batch_stats or {})
    state = torch_state_from_flax(params, batch_stats)
    if all(v.dtype == np.float32 for v in jax.tree.leaves((params, batch_stats))):
        return state
    exact = {}
    for name, v in _leaves(params):
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            v, leaf = (v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)), "weight"
        exact[f"{module}.{'weight' if leaf == 'scale' else leaf}"] = torch.tensor(v)
    for name, v in _leaves(batch_stats):
        module, _, leaf = name.rpartition(".")
        exact[f"{module}.running_{leaf}"] = torch.tensor(v)
    assert exact.keys() == state.keys() and all(torch.equal(exact[n].float(), state[n]) for n in state)
    return exact


def _tiny_validation(module, **device):
    """``module.load_validation_trajectories`` cut to two trajectories a D
    and one an in-order D (the witness does not read them)."""
    return lambda length, **_: module.generate_frozen_validation(d_values=(1, 3, 5, 7), n_particles=2,
                                                                  t_steps=10 * length, in_order_particles=1, **device)


def jax_demo_cycle_data(curriculum: str, dtype=np.float32, seqs_per_d: int = WITNESS_SEQS_PER_D,
                        compiled=None) -> dict:
    """JAX's side of the demo's witness, in ``dtype``: the JAX package's
    ``baseline.build(sequences=True, continuous_d=…)`` at the small width,
    one cycle of its ``generate_fn`` (the curriculum's videos and tail-swapped
    per-frame labels, real optics), the minibatches its ``train_cycle`` draws
    (``permutation(split(key)[0], n)`` at the first cycle's batch of 1), the
    arm's flax weights (initialised in float32; in float64 cast, AdamW's
    state made in float64, under ``jax.enable_x64``), its per-step losses and
    state after the cycle, and how far JAX moves from itself when its videos
    move by one ulp of ``dtype``. ``compiled``, a dict, keeps JAX's
    initial state and jitted step for the next call of the same dtype (both
    curricula train the same arm)."""
    from moleculardiffusion_mivit_tpu.evaluation import validation as jvalidation
    from moleculardiffusion_mivit_tpu.experiments import baseline as jbaseline
    from moleculardiffusion_mivit_tpu.train import loop as jloop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbaseline, "ModelConfig", lambda **kw: JModelConfig(**kw).replace(**SMALL))
        mp.setattr(jbaseline, "load_validation_trajectories", _tiny_validation(jvalidation))
        jexp = jbaseline.build(sequences=True, continuous_d=CURRICULA[curriculum], sequences_per_d=seqs_per_d)
    jcfg = jexp.train_cfg
    data = jexp.generate_fn(jax.random.key(11))
    videos, labels = np.asarray(data["videos"]).astype(dtype), np.asarray(data["labels"]).astype(dtype)
    n, batch = videos.shape[0], jcfg.batch_size_for_cycle(0)
    steps = n // batch
    jmodel = jexp.arms[WITNESS_ARM].model
    compiled = {} if compiled is None else compiled
    if dtype not in compiled:
        impls = jloop.make_train_impls(jmodel, jcfg)
        compiled[dtype] = (jmodel.config, jcfg, impls.init_state(jax.random.key(3), jnp.asarray(videos[:1],
                                                                                                 jnp.float32)),
                           jax.jit(impls.train_step))
    config, cfg, state0, step = compiled[dtype]
    assert (config, cfg) == (jmodel.config, jcfg)
    k_perm, k_drop = jax.random.split(jax.random.key(5))  # train_cycle's split of the arm's key
    perm = np.asarray(jax.random.permutation(k_perm, n)[: steps * batch].reshape(steps, batch))

    with jax.enable_x64(dtype == np.float64):
        params = jax.tree.map(lambda v: jnp.asarray(v, dtype), state0.params)
        state0 = state0.replace(params=params, batch_stats=jax.tree.map(lambda v: jnp.asarray(v, dtype),
                                                                        state0.batch_stats),
                                opt_state=jloop.make_optimizer(jcfg).init(params))

        def jax_cycle(v):
            state = state0.replace(opt_state=jloop._set_lr(state0.opt_state, jnp.asarray(jcfg.lr_for_cycle(0),
                                                                                         dtype)))
            losses = []
            for idx in perm:
                state, loss = step(state, jnp.asarray(v), jnp.asarray(labels), None, jnp.asarray(idx), k_drop)
                losses.append(float(loss))
            adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                        if hasattr(s, "mu"))
            return np.array(losses), {"state": _torch_state(state.params, state.batch_stats),
                                      "exp_avg": _torch_state(adam.mu), "exp_avg_sq": _torch_state(adam.nu)}

        jax_losses, want = jax_cycle(videos)
        spread_losses, spread = np.zeros(steps), {k: {name: 0.0 for name in v} for k, v in want.items()}
        for direction in (np.inf, -np.inf):
            ulp_losses, moved = jax_cycle(np.nextafter(videos, dtype(direction)))
            spread_losses = np.maximum(spread_losses, np.maximum.accumulate(np.abs(ulp_losses - jax_losses)))
            for kind, ref in want.items():
                for name, w in ref.items():
                    spread[kind][name] = max(spread[kind][name], float((moved[kind][name] - w).abs().max()))
        start = _torch_state(state0.params, state0.batch_stats)
    return dict(curriculum=curriculum, dtype=dtype, seqs_per_d=seqs_per_d, videos=videos, labels=labels, perm=perm,
                jcfg=jcfg, start=start, losses=jax_losses, want=want, spread_losses=spread_losses, spread=spread)


@pytest.fixture(scope="module")
def jax_demo_cycles():
    """JAX's float64 witness cycle of each curriculum, made once."""
    cycles, compiled = {}, {}

    def get(curriculum):
        if curriculum not in cycles:
            cycles[curriculum] = jax_demo_cycle_data(curriculum, np.float64, compiled=compiled)
        return cycles[curriculum]

    return get


def port_demo_cycle(ref, monkeypatch, betas=(0.9, 0.999)):
    """The port's side of the demo's witness: ``experiments.baseline.build``
    as ``changepoint_study demo`` builds it (sequence mode, the curriculum,
    ``fused_cycles`` and ``stack_pairs`` on) at the small width, kept to the
    deep-ResNet relu/leaky pair, run one cycle eagerly on the CPU (K2/K3's
    plain versions) through ``Experiment.run``: its ``generate_fn`` hands it
    JAX's cycle data, ``epoch_permutation`` JAX's minibatches, and the relu
    member starts from JAX's weights, AdamW with ``betas``. In float64 the
    pair's models are cast after ``build``, validation is left out (its
    videos are float32), and each step's float64 loss is kept beside the
    engine's float32 buffer. Returns the relu member's per-step losses and
    its state after the cycle."""
    from moleculardiffusion_mivit_tpu_torch import evaluation as tval
    from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
    from moleculardiffusion_mivit_tpu_torch.experiments import base as tbase
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline as tbaseline

    jcfg, f64 = ref["jcfg"], ref["dtype"] == np.float64
    monkeypatch.setattr(tbaseline, "ModelConfig", lambda **kw: ModelConfig(**kw).replace(**SMALL))
    monkeypatch.setattr(tbaseline, "load_validation_trajectories", _tiny_validation(tval, device="cpu"))
    exp = tbaseline.build(sequences=True, continuous_d=CURRICULA[ref["curriculum"]], sequences_per_d=ref["seqs_per_d"],
                          device="cpu")
    cfg = exp.train_cfg
    assert (cfg.lr, cfg.weight_decay, cfg.loss, cfg.d_max_normalization, cfg.sequence_mode, cfg.mix_trajectories,
            cfg.batch_size_for_cycle(0)) == (jcfg.lr, jcfg.weight_decay, jcfg.loss, jcfg.d_max_normalization,
                                             jcfg.sequence_mode, jcfg.mix_trajectories, jcfg.batch_size_for_cycle(0))
    exp.arms = {name: exp.arms[name] for name in WITNESS_PAIR}
    tv, tl = torch.from_numpy(ref["videos"].copy()), torch.from_numpy(ref["labels"].copy())
    exp.generate_fn = lambda generator, part=None: {"videos": tv.clone(), "labels": tl.clone()}
    perm = torch.from_numpy(ref["perm"].copy())
    monkeypatch.setattr(tbase, "epoch_permutation", lambda generator, n, batch_size, device: perm.clone())
    exp.build()
    assert exp.fused_cycles and [g for g, _ in exp._stack_groups] == [list(WITNESS_PAIR)]
    model = exp.arms[WITNESS_ARM].model
    losses = []
    if f64:
        exp.val_data = {}
        for name in WITNESS_PAIR:
            exp.arms[name].model.double()

            def recording(*a, _step=exp._impls[name].train_step, _name=name, **kw):
                loss = _step(*a, **kw)
                if _name == WITNESS_ARM:
                    losses.append(float(loss))
                return loss.float()

            exp._impls[name] = exp._impls[name]._replace(train_step=recording)
    model.load_state_dict(ref["start"])
    optimizer = exp.states[WITNESS_ARM].optimizer
    for group in optimizer.param_groups:
        group["betas"] = betas
    exp.run(num_cycles=1)
    (unit,) = exp.engine.units.values()
    assert unit.names == WITNESS_PAIR  # the pair stepped as one unit
    losses = np.array(losses) if f64 else unit.losses[0].numpy().astype(np.float64)
    return losses, {"state": model.state_dict(),
                    **{k: {name: optimizer.state[p][k] for name, p in model.named_parameters()}
                       for k in ("exp_avg", "exp_avg_sq")}}


def zero_gradient_leaves(exp_avg: dict) -> set:
    """The parameters whose first moment's largest entry is at most
    ``ZERO_GRADIENT`` of the largest over all of them."""
    top = max(float(m.abs().max()) for m in exp_avg.values())
    return {name for name, m in exp_avg.items() if float(m.abs().max()) <= ZERO_GRADIENT * top}


def demo_cycle_misses(ref, losses, got):
    """The steps whose loss misses and the tensors that miss: each loss at
    ``WITNESS_BOUNDS[dtype][0]`` relative, each tensor at
    ``WITNESS_BOUNDS[dtype][1]`` of its largest entry, each widened by 3 ×
    JAX's own distance from itself under a one-ulp move of the videos. The
    parameters of zero gradient (``zero_gradient_leaves`` of JAX's first
    moments) and their moments are left out; the port must find the same
    ones zero (a miss under ``"zero_gradient_leaves"`` if not)."""
    loss_rtol, rtol = WITNESS_BOUNDS[ref["dtype"]]
    jax_losses = ref["losses"]
    loss_misses = np.flatnonzero(np.abs(losses - jax_losses) > loss_rtol * jax_losses + 3 * ref["spread_losses"])
    off = {}
    zero = zero_gradient_leaves(ref["want"]["exp_avg"])
    if zero_gradient_leaves(got["exp_avg"]) != zero:
        off["zero_gradient_leaves"] = (sorted(zero), sorted(zero_gradient_leaves(got["exp_avg"])))
    for kind, want in ref["want"].items():
        for name, w in want.items():
            if name in zero:
                continue
            diff = float((got[kind][name] - w).abs().max())
            if diff > rtol * float(w.abs().max()) + 3 * ref["spread"][kind][name]:
                off[f"{kind}:{name}"] = (diff, ref["spread"][kind][name])
    return loss_misses.tolist(), off


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_demo_cycle_matches_jax_step_by_step(jax_demo_cycles, monkeypatch, curriculum):
    """One whole cycle of the change-point demo's arm (``deepcnn_2layer_s``:
    GeneralTransformer, deep-ResNet embedding through K2/K3's plain versions,
    relu, sequence mode, per-frame MSE) trained by the port's ``Experiment``
    as ``changepoint_study demo`` trains it (the relu member of the stacked
    deep-ResNet pair, the fused cycle, eager on the CPU), against the JAX
    package's ``train_step`` called once per step through the same
    minibatches in the same order, from the same flax weights (converted by
    ``utils.convert``), on the same cycle of the curriculum's data (JAX's
    ``generate_fn``: videos with the curriculum's tail swaps and their
    per-frame labels; ``test_continuous_data_matches_jax_given_its_draws``
    holds the port's ``generate_fn`` against it). 16 steps at the first
    cycles' batch of 1 and learning rate 1e-4. Parametrised over the
    continuous curriculum (``--continuous 0.1,8``) and the discrete control.

    Both sides run in float64 (as F8's twin), held by F7's method: every
    loss and every parameter, AdamW moment and BatchNorm statistic at 1e-10
    (of the loss, of the tensor's largest entry), each widened by 3 × JAX's
    own distance from itself when its videos move by one ulp up or down
    (the larger of the two; the running maximum over steps for the losses).
    Measured: losses 4e-16 / 5e-16 of a loss apart (continuous /
    discrete), tensors 3.2e-13 / 7.1e-13 of their largest entry.

    Left out by a rule (``ZERO_GRADIENT``): the parameters whose gradient is
    zero to rounding, read from the AdamW first moment after the cycle. They
    are the two attention key biases: a bias b added to every key adds q·b
    to every logit of a query, which the softmax takes away, so dL/db = 0 in
    exact arithmetic. Their first moments are 3.6e-18-8.0e-18 (JAX) and
    2.0e-18-2.7e-18 (port) of the largest first moment here, 1.6e-18-8.0e-18
    and 7.6e-19-3.7e-18 at 8 a class; the next smallest parameter's is
    6.2e-3 (1.1e-3 at 8 a class). AdamW divides that noise by its own root
    mean square, so these biases move by ~lr a step in a direction set by
    rounding: 1.2-1.7 of their largest entry apart, inside JAX's own
    one-ulp distance at 4 a class, not always at 8. The port must find the
    same parameters of zero gradient, and the test asserts they are the key
    biases. ``test_torch_changepoint_witness.py`` holds the same witness at
    8 sequences a class (32 steps).

    In float32 at F7's bounds (1e-5, 1e-4) the verdict turns on the draw:
    on this cycle the continuous case holds and the discrete one misses
    (steps 10-11, 8 tensors); at 8 a class the continuous one misses and the
    discrete one holds. Either side's float32 cycle can lie further from the
    float64 one: JAX's 9.5e-5 / 4.0e-5 of a loss here and the port's 4.3e-6
    / 2.9e-5; at 8 a class JAX's 1.6e-4 / 9.7e-4 and the port's 3.6e-5 /
    1.1e-2, and the port's discrete tensors 11.4 of their largest entry
    from float64 against JAX's 1.37 (key biases aside): the cycle amplifies
    float32 rounding, so one float32 cycle says nothing of the card's
    float32 path either way. So the float64 twin is the witness.
    ``tests/changepoint_witness_f32.py`` measures these."""
    ref = jax_demo_cycles(curriculum)
    loss_misses, off = demo_cycle_misses(ref, *port_demo_cycle(ref, monkeypatch))
    assert not loss_misses, loss_misses
    assert not off, off
    assert zero_gradient_leaves(ref["want"]["exp_avg"]) == KEY_BIASES


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_demo_config_and_cycle_schedules_match_jax(monkeypatch, curriculum):
    """What the demo's trainer carries from cycle to cycle, beyond the one
    cycle the witness steps through: ``baseline.build(sequences=True, …)``
    at 64 a class has JAX's ``TrainConfig`` field for field, the same arms
    and, over the record's 100 cycles, JAX's batch size and learning rate
    each cycle."""
    from moleculardiffusion_mivit_tpu.evaluation import validation as jvalidation
    from moleculardiffusion_mivit_tpu.experiments import baseline as jbaseline
    from moleculardiffusion_mivit_tpu_torch import evaluation as tval
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline as tbaseline

    monkeypatch.setattr(jbaseline, "load_validation_trajectories", _tiny_validation(jvalidation))
    monkeypatch.setattr(tbaseline, "load_validation_trajectories", _tiny_validation(tval, device="cpu"))
    kw = dict(sequences=True, continuous_d=CURRICULA[curriculum], sequences_per_d=64)
    jexp, texp = jbaseline.build(**kw), tbaseline.build(device="cpu", **kw)
    jcfg, tcfg = jexp.train_cfg, texp.train_cfg
    assert set(jcfg.__dataclass_fields__) == set(tcfg.__dataclass_fields__)
    assert {k: str(getattr(tcfg, k)) for k in tcfg.__dataclass_fields__} == {
        k: str(getattr(jcfg, k)) for k in jcfg.__dataclass_fields__}
    assert sorted(jexp.arms) == sorted(texp.arms)
    schedule = [(jcfg.batch_size_for_cycle(c), float(jcfg.lr_for_cycle(c))) for c in range(100)]
    assert [(tcfg.batch_size_for_cycle(c), float(tcfg.lr_for_cycle(c))) for c in range(100)] == schedule
    assert len(set(schedule)) > 1  # the schedule moves within the record's cycles


@pytest.mark.parametrize("mutation", ["bn_momentum_0.91", "adamw_beta2_0.998"])
def test_demo_witness_fails_on_a_mutated_trainer(jax_demo_cycles, monkeypatch, mutation):
    """The demo's witness has the power to see a trainer that differs: on
    the continuous curriculum, with the running statistics' momentum at 0.91
    in place of flax's 0.9 (the running statistics miss), or AdamW's
    second-moment decay at 0.998 in place of optax's 0.999 (the second
    moments and the losses miss), the port's cycle misses JAX's by the
    witness's own bounds."""
    from moleculardiffusion_mivit_tpu_torch.models import embeddings

    ref = jax_demo_cycles("continuous")
    betas = (0.9, 0.999)
    if mutation.startswith("bn_momentum"):
        monkeypatch.setattr(embeddings, "BN_MOMENTUM", 0.91)
    else:
        betas = (0.9, 0.998)
    loss_misses, off = demo_cycle_misses(ref, *port_demo_cycle(ref, monkeypatch, betas))
    if mutation.startswith("bn_momentum"):
        assert any(k.startswith("state:") and "running_" in k for k in off), off
    else:
        assert any(k.startswith("exp_avg_sq:") for k in off) and loss_misses, (loss_misses, off)
