"""The port's sim-to-real study (``realdata.sim2real``) on the CPU at tiny
sizes, against the JAX example ``examples/sim2real_robustness.py``: the
optics panel's render (noise-free against JAX's ``render_frames_core`` per
member, noise in distribution against the example's generator), the demo's
data unchanged with a one-member panel, the panel and test optics, the
scoring of one movie, the entry point, and the outcome rule of
``sim2real_outcome.py``."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import OpticsConfig as JOptics
from moleculardiffusion_mivit_tpu.sim.render import render_frames_core as j_render_frames_core
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.ops import render as trender_ops
from moleculardiffusion_mivit_tpu_torch.realdata import demo, sim2real
from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion, normalize_images
from moleculardiffusion_mivit_tpu_torch.sim.render import (
    render_frames_core,
    render_widefield,
    render_widefield_panel,
    widefield_subpositions,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(patch_size=demo.PATCH, use_pos_encoding=True, embed_dim=8, num_heads=2, hidden_dim=16,
                   num_layers=1)
OPTICS_FIELDS = ("particle_intensity", "psf_division_factor", "output_size", "background_intensity",
                 "poisson_noise", "trajectory_unit", "upsampling_factor")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _load(ROOT / "examples" / "sim2real_robustness.py", "sim2real_example")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_optics(optics) -> JOptics:
    return JOptics(**{f: getattr(optics, f) for f in OPTICS_FIELDS})


def _patch_positions(n: int, n_frames: int, seed: int) -> torch.Tensor:
    """Patch-following sub-positions ``(n, 1, n_frames·N_POS, 2)`` as the
    demo draws them."""
    g = torch.Generator().manual_seed(seed)
    d = 0.02 + 0.98 * torch.rand((n,), generator=g)
    seg = brownian_motion(g, n, n_frames, demo.N_POS, d, dt=1.0).reshape(n, n_frames, demo.N_POS, 2)
    pos = (demo.PATCH - 1) / 2.0 + seg - seg.mean(dim=2, keepdim=True) + torch.rand((n, n_frames, 1, 2),
                                                                                     generator=g) - 0.5
    return pos.reshape(n, 1, n_frames * demo.N_POS, 2)


def _widefield_before_the_panel(generator, trajs, p, field, optics):
    """``render_widefield`` as it was before the panel: the same draws in the
    same order and the same arithmetic."""
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_std = optics.background_intensity
    x_hr, y_hr = widefield_subpositions(trajs, p, field, optics.upsampling_factor)
    intensities = part_mean / p + (part_std / p) * torch.randn(x_hr.shape, generator=generator)
    frames = render_frames_core(x_hr, y_hr, intensities, optics.gaussian_sigma_hr, field, optics.upsampling_factor)
    noise = torch.randn(frames.shape, generator=generator) * torch.tensor(bg_std, dtype=torch.float32)
    hi = torch.tensor(bg_mean + 3.0 * bg_std, dtype=torch.float32)
    frames = frames + torch.clamp(torch.tensor(bg_mean, dtype=torch.float32) + noise, 0.0, float(hi))
    kk = float(optics.poisson_noise)
    return frames * torch.poisson(torch.full(frames.shape, kk), generator=generator) / kk


def test_one_member_panel_gives_the_demos_patch_sequences_bitwise():
    """(a) With the default one-member panel the demo's training data are
    bitwise what they were before the panel: the same draws in the same
    order; ``render_widefield`` is a one-member panel."""
    n, t = 6, 5
    got, labels = demo.patch_sequences(torch.Generator().manual_seed(3), n, t)
    same, _ = demo.patch_sequences(torch.Generator().manual_seed(3), n, t, (demo.OPTICS,))
    g = torch.Generator().manual_seed(3)
    d = 0.02 + 0.98 * torch.rand((n,), generator=g)
    seg = brownian_motion(g, n, t, demo.N_POS, d, dt=1.0).reshape(n, t, demo.N_POS, 2)
    seg = seg - seg.mean(dim=2, keepdim=True)
    pos = (demo.PATCH - 1) / 2.0 + seg + (torch.rand((n, t, 1, 2), generator=g) - 0.5)
    frames = _widefield_before_the_panel(g, pos.reshape(n, 1, t * demo.N_POS, 2), demo.N_POS, demo.PATCH,
                                         demo.OPTICS)
    want = normalize_images(frames, demo.BG_MEAN, demo.BG_SIGMA, demo.THEO_MAX)[0]
    assert torch.equal(got, want) and torch.equal(same, want) and torch.equal(labels, d[:, None])
    trajs = torch.tensor(sim2real.movie_trajectories(0), dtype=torch.float32)
    movie = render_widefield(torch.Generator().manual_seed(4), trajs, demo.N_POS, demo.FIELD, demo.OPTICS)
    before = _widefield_before_the_panel(torch.Generator().manual_seed(4), trajs, demo.N_POS, demo.FIELD, demo.OPTICS)
    assert torch.equal(movie, before)


def test_panel_noise_free_frames_match_jax_per_member():
    """(b) The same sub-positions and intensities give the same noise-free
    frames through the panel's one call (a sigma per member, K1's plain
    version on the CPU) as JAX's ``render_frames_core`` once per member
    with that member's sigma: 1e-5 of the largest pixel."""
    k, per, t = len(sim2real.RAND_PANEL), 2, 3
    u = demo.OPTICS.upsampling_factor
    x, y = widefield_subpositions(_patch_positions(k * per, t, seed=1), demo.N_POS, demo.PATCH, u)
    w = 400.0 + 20.0 * torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    sigmas = tuple(o.gaussian_sigma_hr for o in sim2real.RAND_PANEL)
    assert len(set(sigmas)) > 1
    got = render_frames_core(x, y, w, sigmas, demo.PATCH, u).numpy()
    assert got.shape == (k * per, t, demo.PATCH, demo.PATCH)
    for m, sigma in enumerate(sigmas):
        run = slice(m * per, (m + 1) * per)
        want = np.asarray(j_render_frames_core(jnp.asarray(x[run].numpy()), jnp.asarray(y[run].numpy()),
                                               jnp.asarray(w[run].numpy()), sigma, demo.PATCH, u))
        assert np.abs(got[run] - want).max() <= 1e-5 * np.abs(want).max(), m


def test_quiet_panel_equals_jax_render_widefield_per_member(example):
    """(b) Without noise (intensity σ, background and shot noise off) the
    whole panel render is deterministic: the first, a middle and the last
    member's run each equal JAX's ``render_widefield`` of its sequence at
    that member's optics (its PSF and its intensity), 1e-5 of the largest
    pixel."""
    panel = tuple(o.replace(particle_intensity=(o.particle_intensity[0], 0.0), background_intensity=(0.0, 0.0),
                            poisson_noise=-1) for o in sim2real.RAND_PANEL)
    pos = _patch_positions(len(panel), 3, seed=5)
    got = render_widefield_panel(torch.Generator().manual_seed(0), pos, demo.N_POS, demo.PATCH, panel).numpy()
    for m in (0, 3, 7):
        want = np.asarray(example.render_widefield(jax.random.key(m), jnp.asarray(pos[m].numpy()), demo.N_POS,
                                                   demo.PATCH, _jax_optics(panel[m])))
        assert np.abs(got[m] - want).max() <= 1e-5 * np.abs(want).max(), m


def test_panel_noise_matches_the_examples_generator_in_distribution(example):
    """(c) Each member's noisy frames against the example's generator (a
    ``jax.vmap`` of ``render_widefield`` over one key a sequence, its
    ``generate``'s panel loop) on the same sub-positions: over 300 frames a
    member the mean of the frames' pixel means and the mean of their pixel
    variances agree within 5 standard errors of the difference."""
    panel = sim2real.RAND_PANEL
    per, t = 12, 25
    pos = _patch_positions(len(panel) * per, t, seed=7)
    got = render_widefield_panel(torch.Generator().manual_seed(7), pos, demo.N_POS, demo.PATCH, panel).numpy()
    kr = jax.random.key(7)
    for m, optics in enumerate(panel):
        sl = jnp.asarray(pos[m * per:(m + 1) * per, 0].numpy())
        keys = jax.random.split(jax.random.fold_in(kr, m), per)
        want = np.asarray(jax.jit(jax.vmap(lambda k, p, o=_jax_optics(optics): example.render_widefield(
            k, p[None], demo.N_POS, demo.PATCH, o)))(keys, sl))
        a = got[m * per:(m + 1) * per].reshape(-1, demo.PATCH ** 2).astype(np.float64)
        b = want.reshape(-1, demo.PATCH ** 2).astype(np.float64)
        for stat in (lambda v: v.mean(1), lambda v: v.var(1)):
            sa, sb = stat(a), stat(b)
            z = (sa.mean() - sb.mean()) / np.sqrt(sa.var() / sa.size + sb.var() / sb.size)
            assert abs(z) <= 5, (m, z)


def test_panel_and_test_optics_equal_the_examples(example):
    """(d) ``NOMINAL``, ``RAND_PANEL`` and ``TEST_OPTICS`` equal the
    example's, field by field, and so do the study's constants."""
    for f in OPTICS_FIELDS:
        assert getattr(sim2real.NOMINAL, f) == getattr(example.NOMINAL, f), f
    assert len(sim2real.RAND_PANEL) == len(example.RAND_PANEL) == 8
    for ours, theirs in zip(sim2real.RAND_PANEL, example.RAND_PANEL):
        assert all(getattr(ours, f) == getattr(theirs, f) for f in OPTICS_FIELDS)
    assert list(sim2real.TEST_OPTICS) == list(example.TEST_OPTICS)
    for name, theirs in example.TEST_OPTICS.items():
        assert all(getattr(sim2real.TEST_OPTICS[name], f) == getattr(theirs, f) for f in OPTICS_FIELDS), name
    assert (sim2real.D_TRUE, sim2real.N_POS, sim2real.PATCH) == (example.D_TRUE, example.N_POS, example.PATCH)
    assert (sim2real.BG_MEAN, sim2real.BG_SIGMA, sim2real.THEO_MAX) == (example.BG_MEAN, example.BG_SIGMA,
                                                                        example.THEO_MAX)


def test_score_movie_gives_the_examples_row(example, tmp_path):
    """(e) One JAX-rendered 63-px movie (the example's ``make_movie`` at its
    nominal optics) scored by the example's ``score_movie`` and by the
    port's with the same deterministic stand-in predictors written in both
    frameworks: the same track count, every MAE within 1e-3 (the example
    rounds to 1e-4). The movie's trajectories are the port's
    ``movie_trajectories(0)``."""
    path = str(tmp_path / "movie.tif")
    example.make_movie(path, example.NOMINAL, seed=100)
    rng = np.random.default_rng(100)
    starts = rng.uniform(14, 63 - 14, size=(10, 1, 2))
    assert np.array_equal(sim2real.movie_trajectories(0)[:, :1], starts)
    j_pred = {"fixed": lambda v: 0.5 * jnp.mean(v, axis=(1, 2, 3))[:, None],
              "randomized": lambda v: 2.0 * jnp.std(v, axis=(1, 2, 3))[:, None]}
    t_pred = {"fixed": lambda v: 0.5 * v.mean(dim=(1, 2, 3))[:, None],
              "randomized": lambda v: 2.0 * v.std(dim=(1, 2, 3), correction=0)[:, None]}
    want = example.score_movie(path, j_pred)
    got = sim2real.score_movie(path, t_pred, "cpu")
    assert got["n_tracks"] == want["n_tracks"] >= 5
    for col in ("fixed", "randomized", "msd"):
        assert abs(got[col] - want[col]) <= 1e-3, (col, got[col], want[col])


def test_main_runs_on_the_cpu_and_writes_the_examples_keys(tmp_path, monkeypatch, capsys):
    """(f) The entry point on the CPU: one cycle of 16 sequences (the
    randomized arm's 8 members 2 each) with a one-layer model at embed 8,
    one movie a row; ``sim2real.json`` has the example's keys, the report
    the unrounded rows, each movie, both arms' losses and the stages."""
    monkeypatch.setattr(demo, "MODEL_CONFIG", TINY)
    monkeypatch.setattr(demo, "SEQS_PER_CYCLE", 16)
    study = sim2real.main(["--train-cycles", "1", "--movies-per-optics", "1", "--device", "cpu", "--out",
                           str(tmp_path)])
    written = json.loads((tmp_path / "sim2real.json").read_text())
    assert list(written) == ["d_true", "train_cycles", "movies_per_optics", "rows"]
    assert (written["d_true"], written["train_cycles"], written["movies_per_optics"]) == (0.3, 1, 1)
    assert list(written["rows"]) == list(sim2real.TEST_OPTICS)
    report = json.loads((tmp_path / "sim2real_report.json").read_text())
    assert report == json.loads(json.dumps(study.report))
    for name, row in written["rows"].items():
        assert list(row) == ["n_tracks", "fixed_mae", "randomized_mae", "msd_mae"], name
        exact = report["rows"][name]
        assert row["n_tracks"] == exact["n_tracks"] >= 1
        assert all(abs(row[c] - exact[c]) <= 1e-4 for c in ("fixed_mae", "randomized_mae", "msd_mae"))
    assert report["seed"] == 0 and len(report["movies"]) == 7 and report["card"] == "cpu"
    assert {a: report["arms"][a]["panel_members"] for a in ("fixed", "randomized")} == {"fixed": 1, "randomized": 8}
    assert all(len(report["arms"][a]["train_loss"]) == 1 for a in ("fixed", "randomized"))
    assert set(report["stage_s"]) == {"train_fixed", "train_randomized", "render", "detect", "track", "patches",
                                      "localize", "predict"}
    assert set(study.arms) == {"fixed", "randomized"} and trender_ops.render_frames.launches == 0


def test_main_needs_a_card_or_the_cpu(tmp_path):
    """(g) Without ``--device`` the study runs on the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim2real.main(["--train-cycles", "1", "--out", str(tmp_path)])


def test_k1_refuses_more_than_eight_settings_on_both_devices():
    """K1 takes at most ``MAX_SETTINGS`` sigmas a launch; the wrapper's
    plain version refuses a ninth as the kernel does, and so does a panel
    of nine."""
    x = torch.zeros((9, 10))
    with pytest.raises(ValueError, match="9 PSF settings outside the kernel's 1..8"):
        trender_ops.render_frames(x, x, x + 1.0, (5.0,) * 9, 9, 5)
    assert trender_ops.render_frames(x[:8], x[:8], x[:8] + 1.0, (5.0,) * 8, 9, 5).shape == (8, 9, 9)
    with pytest.raises(ValueError, match="PSF settings outside"):
        render_widefield_panel(torch.Generator(), _patch_positions(9, 1, seed=0), demo.N_POS, demo.PATCH,
                               (demo.OPTICS.replace(psf_division_factor=1.0),) + (demo.OPTICS,) * 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        render_widefield_panel(torch.Generator(), _patch_positions(6, 1, seed=0), demo.N_POS, demo.PATCH,
                               sim2real.RAND_PANEL)


def test_panel_refuses_members_with_and_without_shot_noise():
    """A panel's members all draw shot noise, or none does; a panel that
    mixes them raises, and a panel without shot noise keeps its clipped
    background only (no frame value below zero)."""
    pos = _patch_positions(2, 1, seed=0)
    with pytest.raises(ValueError, match="mixes members with and without shot noise"):
        render_widefield_panel(torch.Generator(), pos, demo.N_POS, demo.PATCH,
                               (demo.OPTICS, demo.OPTICS.replace(poisson_noise=-1)))
    quiet = (demo.OPTICS.replace(poisson_noise=-1), demo.OPTICS.replace(poisson_noise=-1, psf_division_factor=1.0))
    frames = render_widefield_panel(torch.Generator().manual_seed(0), pos, demo.N_POS, demo.PATCH, quiet)
    assert frames.shape == (2, pos.shape[2] // demo.N_POS, demo.PATCH, demo.PATCH) and bool((frames >= 0).all())


# --- the outcome rule (sim2real_outcome.py) ---


def _synthetic(n_seeds, msd, fixed, randomized, n_tracks=21):
    rows = {n: {"n_tracks": n_tracks, "fixed_mae": fixed, "randomized_mae": randomized, "msd_mae": msd}
            for n in sim2real.TEST_OPTICS}
    return [{"seed": s, "rows": {n: {c: (v + 0.01 * (s - n_seeds / 2) if c != "n_tracks" else v)
                                     for c, v in r.items()} for n, r in rows.items()}} for s in range(n_seeds)]


def test_outcome_rules_pass_and_fail_on_synthetic_numbers():
    """(h) The rule of ``sim2real.py``'s docstring on made-up numbers: the
    MSD column at 3 pooled standard errors of JAX's keys; the model columns
    against the record inside the port's spread when a JAX seed is slow
    (or missing), against four JAX seeds when one took ≤ 30 min."""
    outcome = _load(ROOT / "sim2real_outcome.py", "sim2real_outcome")
    record = json.loads(outcome.RECORD.read_text())
    keys = [{"key": k, "rows": {n: {"msd_mae": 0.3 + 0.02 * ((k % 5) - 2)} for n in outcome.ROWS}}
            for k in range(32)]
    port = _synthetic(8, 0.3, 0.2, 0.2)
    for name in outcome.ROWS:  # the record's own values: the model rule holds at any spread
        for p in port:
            p["rows"][name]["fixed_mae"] += record["rows"][name]["fixed_mae"] - 0.2
            p["rows"][name]["randomized_mae"] += record["rows"][name]["randomized_mae"] - 0.2
    verdict = outcome.judge(keys, [], port, record)
    assert verdict["ok"] and verdict["model_branch"] == "record" and len(verdict["held"]) == 3 * 7
    slow = [{"seed": 42, "seconds": 5000.0, "finished": False}]
    assert outcome.judge(keys, slow, port, record)["model_branch"] == "record"
    off = json.loads(json.dumps(port))
    for p in off:
        p["rows"]["dim_2000"]["msd_mae"] += 0.1
        p["rows"]["nominal"]["fixed_mae"] += 0.2
    verdict = outcome.judge(keys, [], off, record)
    assert not verdict["ok"]
    assert [k for k, v in verdict["held"].items() if not v] == ["nominal_fixed_within_limit",
                                                                "dim_2000_msd_mean_within_3_pooled_se"]
    fast = [{"seed": 42 + k, "seconds": 600.0, "finished": True,
             "rows": {n: {"fixed_mae": 0.5, "randomized_mae": 0.5} for n in outcome.ROWS}} for k in range(4)]
    verdict = outcome.judge(keys, fast, port, record)
    assert verdict["model_branch"] == "jax_seeds" and not verdict["held"]["nominal_fixed_within_limit"]
    assert verdict["held"]["nominal_msd_mean_within_3_pooled_se"]


def test_study_on_the_card_judged_by_the_rule():
    """(h) The committed verdict reads as the rule says: the port's eight
    card seeds (``results/torch_sim2real_seed0-7``, ``--train-cycles 60``)
    against JAX's MSD column over 32 render keys and the JAX seed's timing
    (``results/sim2real_outcome``), judged again here, give the committed
    ``verdict.json``. JAX's key 0 is the example's own render: its tracks
    are the record's, its MSD column within 2e-3 of the record's (the
    record ran on a TPU, key 0 here on the CPU)."""
    outcome = _load(ROOT / "sim2real_outcome.py", "sim2real_outcome")
    msd = json.loads((outcome.OUT / "jax_msd.json").read_text())["keys"]
    seeds = json.loads((outcome.OUT / "jax_seeds.json").read_text())["seeds"]
    port = [json.loads((d / "sim2real_report.json").read_text()) for d in outcome.PORT_DIRS]
    record = json.loads(outcome.RECORD.read_text())
    assert [k["key"] for k in msd] == list(range(32))
    for name in outcome.ROWS:
        assert msd[0]["rows"][name]["n_tracks"] == record["rows"][name]["n_tracks"]
        assert abs(msd[0]["rows"][name]["msd_mae"] - record["rows"][name]["msd_mae"]) <= 2e-3, name
    assert [p["seed"] for p in port] == list(range(8))
    assert all(p["train_cycles"] == 60 and p["movies_per_optics"] == 3 for p in port)
    assert all(p["card"].startswith("NVIDIA H100") for p in port)
    verdict = outcome.judge(msd, seeds, port, record)
    assert json.loads(json.dumps(verdict)) == json.loads((outcome.OUT / "verdict.json").read_text())


# F7's first witness: the patch trainer of the study, step by step against
# JAX's. Depth and width shrink alike on both sides; everything else is the
# example's configuration.
SHRUNK = dict(embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _flax_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_patch_cycle(example):
    """JAX's side of F7's first witness: the videos and labels of one cycle,
    JAX's minibatches, the flax weights it starts from, its per-step losses
    and state after the cycle, and how far JAX moves from itself when its
    videos move by one ulp (see the test below)."""
    from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
    from moleculardiffusion_mivit_tpu.train import loop as jloop
    from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

    n_frames, batch = sim2real.N_FRAMES, demo.BATCH
    videos, labels = demo.patch_sequences(torch.Generator().manual_seed(11), demo.SEQS_PER_CYCLE, n_frames)
    videos, labels = videos.numpy(), labels.numpy()
    n = videos.shape[0]
    steps = n // batch

    jcfg = example.TrainConfig(d_max_normalization=1.0, n_frames=n_frames, n_pos_per_frame=example.N_POS, lr=1e-4)
    jmodel = JGeneral(example.ModelConfig(patch_size=example.PATCH, use_pos_encoding=True).replace(**SHRUNK),
                      embedding="deep_resnet")
    impls = jloop.make_train_impls(jmodel, jcfg)
    state0 = impls.init_state(jax.random.key(3), jnp.asarray(videos[:1]))
    k_perm, k_drop = jax.random.split(jax.random.key(5))  # train_cycle's split of its key
    perm = np.asarray(jax.random.permutation(k_perm, n)[: steps * batch].reshape(steps, batch))
    step = jax.jit(impls.train_step)

    def jax_cycle(v):
        """JAX's cycle on videos ``v``: per-step losses and the state after
        it as a port ``state_dict`` and AdamW moments."""
        state = state0.replace(opt_state=jloop._set_lr(state0.opt_state, jnp.float32(jcfg.lr)))
        losses = []
        for idx in perm:
            state, loss = step(state, jnp.asarray(v), jnp.asarray(labels), None, jnp.asarray(idx), k_drop)
            losses.append(float(loss))
        adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                    if hasattr(s, "mu"))
        return np.array(losses), {"state": torch_state_from_flax(_flax_tree(state.params),
                                                                 _flax_tree(state.batch_stats)),
                                  "exp_avg": torch_state_from_flax(_flax_tree(adam.mu)),
                                  "exp_avg_sq": torch_state_from_flax(_flax_tree(adam.nu))}

    jax_losses, want = jax_cycle(videos)
    spread_losses, spread = np.zeros(steps), {k: {name: 0.0 for name in v} for k, v in want.items()}
    for direction in (np.inf, -np.inf):
        ulp_losses, moved = jax_cycle(np.nextafter(videos, np.float32(direction)))
        spread_losses = np.maximum(spread_losses, np.maximum.accumulate(np.abs(ulp_losses - jax_losses)))
        for kind, ref in want.items():
            for name, w in ref.items():
                spread[kind][name] = max(spread[kind][name], float((moved[kind][name] - w).abs().max()))
    start = torch_state_from_flax(_flax_tree(state0.params), _flax_tree(state0.batch_stats))
    return dict(videos=videos, labels=labels, perm=perm, jcfg=jcfg, start=start, losses=jax_losses, want=want,
                spread_losses=spread_losses, spread=spread)


def _port_cycle_misses(ref, betas=(0.9, 0.999)):
    """The port's side of F7's first witness: its trainer through JAX's
    minibatches from JAX's starting weights, AdamW with ``betas``. Returns
    the steps whose loss misses and the tensors that miss, by the bounds of
    ``test_patch_trainer_cycle_matches_jax_step_by_step``."""
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
    from moleculardiffusion_mivit_tpu_torch.train import loop as tloop

    cfg, jcfg = demo.patch_train_config(sim2real.N_FRAMES), ref["jcfg"]
    assert (cfg.lr, cfg.d_max_normalization, cfg.n_frames, cfg.n_pos_per_frame, cfg.weight_decay, cfg.loss) == (
        jcfg.lr, jcfg.d_max_normalization, jcfg.n_frames, jcfg.n_pos_per_frame, jcfg.weight_decay, jcfg.loss)
    model = GeneralTransformer(demo.MODEL_CONFIG.replace(**SHRUNK), embedding="deep_resnet")
    timpls = tloop.make_train_impls(model, cfg, "cpu")
    model.load_state_dict(ref["start"])
    tstate = tloop.TrainState(model.train(), tloop.make_optimizer(model, cfg))
    for group in tstate.optimizer.param_groups:
        group["betas"] = betas
    tloop._set_lr(tstate.optimizer, cfg.lr)
    tv, tl = torch.from_numpy(ref["videos"]), torch.from_numpy(ref["labels"])
    port_losses = np.array([float(timpls.train_step(tstate, tv, tl, torch.from_numpy(idx.copy())))
                            for idx in ref["perm"]])
    jax_losses = ref["losses"]
    loss_misses = np.flatnonzero(np.abs(port_losses - jax_losses) > 1e-5 * jax_losses + 3 * ref["spread_losses"])

    got = {"state": model.state_dict(),
           **{k: {name: tstate.optimizer.state[p][k] for name, p in model.named_parameters()}
              for k in ("exp_avg", "exp_avg_sq")}}
    off = {}
    for kind, want in ref["want"].items():
        for name, w in want.items():
            diff = float((got[kind][name] - w).abs().max())
            if diff > 1e-4 * float(w.abs().max()) + 3 * ref["spread"][kind][name]:
                off[f"{kind}:{name}"] = (diff, ref["spread"][kind][name])
    return loss_misses.tolist(), off


def test_patch_trainer_cycle_matches_jax_step_by_step(jax_patch_cycle):
    """One full cycle of the study's trainer (``demo.train_patch_model``'s
    configuration and ``make_train_impls``, batch 16, 256 sequences: 16
    steps) against the example's ``make_train_impls``, from the same flax
    weights (converted by ``utils.convert``) on the same numpy videos and
    labels. JAX's ``train_cycle`` is its ``train_step`` scanned over
    ``permutation(split(key)[0], n)`` after setting the rate; the test runs
    those steps in that order, one jitted call each (XLA's CPU scan of this
    step takes ~18 s a step), and the port steps through the same
    minibatches with its ``train_step``. The learning rate, AdamW's
    settings, the BN momentum and when the statistics move, the loss and
    the learned positional encoding at 25 frames are all inside this.

    Held: each step's loss at 1e-5 relative, and after the cycle every
    parameter, AdamW moment and BatchNorm statistic at 1e-4 of its
    tensor's largest entry, each widened by 3 × JAX's own distance from
    itself when its videos move by one ulp up or down (the larger of the
    two; the running maximum over steps for the losses). Measured in f32:
    the port and JAX part by 0.2-2.7e-5 in the losses after step 7 and
    2.5-4.9e-3 in BN biases after 16 steps, JAX from itself by 0.04-3.2e-5
    and 2-3.4e-3; the attention key biases, whose gradient is 0 in exact
    arithmetic, end ~2 apart on both counts, AdamW making float noise into
    steps of the rate's size. A trainer that differs in any of the above
    moves these by orders of magnitude more."""
    loss_misses, off = _port_cycle_misses(jax_patch_cycle)
    assert not loss_misses, loss_misses
    assert not off, off


@pytest.mark.parametrize("mutation", ["bn_momentum_0.91", "adamw_beta2_0.998"])
def test_patch_trainer_witness_fails_on_a_mutated_trainer(jax_patch_cycle, monkeypatch, mutation):
    """F7's first witness has the power to see a trainer that differs: with
    the running statistics' momentum at 0.91 in place of flax's 0.9, or
    AdamW's second-moment decay at 0.998 in place of optax's 0.999, the
    port's cycle misses JAX's by the same bounds."""
    from moleculardiffusion_mivit_tpu_torch.models import embeddings

    betas = (0.9, 0.999)
    if mutation.startswith("bn_momentum"):
        monkeypatch.setattr(embeddings, "BN_MOMENTUM", 0.91)
    else:
        betas = (0.9, 0.998)
    loss_misses, off = _port_cycle_misses(jax_patch_cycle, betas)
    assert off, mutation
    if mutation.startswith("bn_momentum"):
        assert any(k.startswith("state:") and "running_" in k for k in off), off
    else:
        assert any(k.startswith("exp_avg_sq:") for k in off), off


def test_patch_model_init_matches_flax_in_distribution(example):
    """The study's patch model at full width initialised by the port's
    ``models.init_model`` (four CPU generators) against flax's init of the
    example's model (four keys), leaf by leaf: leaves flax makes constant
    (zero biases, unit norms, the BN statistics) equal exactly, and every
    other leaf's mean within 5 standard errors and its sd within 5 of its
    own standard errors (sd/sqrt(2N) over the N values of four draws)."""
    from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
    from moleculardiffusion_mivit_tpu.models import init_model as j_init
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, init_model
    from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    jmodel = JGeneral(example.ModelConfig(patch_size=example.PATCH, use_pos_encoding=True), embedding="deep_resnet")
    x = jnp.zeros((1, sim2real.N_FRAMES, demo.PATCH, demo.PATCH), jnp.float32)
    init = jax.jit(lambda k: j_init(jmodel, k, x))
    flax = [torch_state_from_flax(*(_flax_tree(t) for t in init(jax.random.key(k)))) for k in range(4)]
    port = []
    for k in range(4):
        model = init_model(GeneralTransformer(demo.MODEL_CONFIG, embedding="deep_resnet"),
                           seeded_generator("cpu", k, 0))
        port.append({name: v.detach() for name, v in model.state_dict().items()})
    assert set(port[0]) == set(flax[0])
    for name in flax[0]:
        j = torch.stack([f[name] for f in flax]).double().flatten()
        p = torch.stack([s[name] for s in port]).double().flatten()
        if torch.all(j == j[0]):
            assert torch.all(p == j[0]), name
            continue
        n, sd = j.numel(), float(j.std())
        assert abs(float(p.mean() - j.mean())) <= 5 * sd / np.sqrt(n), (name, float(p.mean()), float(j.mean()))
        assert abs(float(p.std()) - sd) <= 5 * sd / np.sqrt(2 * n), (name, float(p.std()), sd)


def _cut_rows(base, step, k, with_movies):
    rows = {n: {"n_tracks": 20, "fixed_mae": base + step * k, "msd_mae": 0.1} for n in sim2real.TEST_OPTICS}
    out = {"rows": rows, "seconds": 30.0}
    if with_movies:
        out["movies"] = [{"row": n, "movie": 0, "d_fixed": [0.3 + 0.01 * k, 0.4]} for n in sim2real.TEST_OPTICS]
    else:
        for r in rows.values():
            r["d_fixed"] = [0.3 + 0.01 * k, 0.5]
    return out


def test_cut_rule_holds_and_misses_on_synthetic_numbers():
    """F7's cut rules (``sim2real.py``'s docstring, ``judge_cut``) on 8
    port and 7 JAX seeds: every row's ``fixed_mae`` within max(0.03, 3
    pooled standard errors) of JAX's and its variance ratio inside the F
    band at level 0.05/7 (0.0975-12.24 for 7 and 6 degrees of freedom)
    holds; one row 0.1 off misses the mean rule alone; one row's port seeds
    spread 20× wider about the same mean miss the spread rule alone; each
    seed's mean D̂ a row is reported on both sides."""
    outcome = _load(ROOT / "sim2real_outcome.py", "sim2real_outcome")
    port = [{"seed": s, **_cut_rows(0.4, 0.01, s - 3.5, True)} for s in range(8)]
    jax_seeds = [{"seed": 42 + k, **_cut_rows(0.41, 0.02, k - 3, False)} for k in range(7)]
    verdict = outcome.judge_cut(jax_seeds, port, 10)
    assert verdict["ok"] and len(verdict["held"]) == 14
    assert verdict["spread_band"] == pytest.approx([0.0975, 12.24], rel=1e-3)
    row = verdict["rows"]["dim_2000"]
    assert row["port_mean_d_hat"][0] == pytest.approx(np.mean([0.3 - 0.035, 0.4]))
    assert row["jax_mean_d_hat"] == pytest.approx([0.385, 0.39, 0.395, 0.4, 0.405, 0.41, 0.415])
    assert row["variance_ratio"] == pytest.approx((0.01 ** 2 * 6) / (0.02 ** 2 * 28 / 6))
    for p in port:
        p["rows"]["dim_2000"]["fixed_mae"] += 0.1
    verdict = outcome.judge_cut(jax_seeds, port, 10)
    assert [k for k, v in verdict["held"].items() if not v] == ["dim_2000_fixed_within_limit"]
    for s, p in enumerate(port):
        p["rows"]["dim_2000"]["fixed_mae"] -= 0.1
        p["rows"]["bright_5500"]["fixed_mae"] = 0.4 + 0.2 * (s - 3.5)
    verdict = outcome.judge_cut(jax_seeds, port, 10)
    assert [k for k, v in verdict["held"].items() if not v] == ["bright_5500_fixed_spread_within_band"]


def test_cut_protocol_judged_by_the_rule():
    """F7's second witness as committed: the port's eight card seeds at the
    cut (``results/torch_sim2real_cut10_seed0-7``: ``--train-cycles 10
    --arms fixed``, the fixed arm only) against JAX's seven CPU seeds of the
    example's fixed arm at 10 cycles (``results/sim2real_outcome/
    jax_cut10_seed42-48.json``), judged again here by the mean and the
    spread rules, give the committed ``cut10_verdict.json``, which holds
    both on every row."""
    outcome = _load(ROOT / "sim2real_outcome.py", "sim2real_outcome")
    port = [json.loads((ROOT / "results" / f"torch_sim2real_cut10_seed{s}" / "sim2real_report.json").read_text())
            for s in range(8)]
    jax_seeds = [json.loads((outcome.OUT / f"jax_cut10_seed{42 + k}.json").read_text()) for k in range(7)]
    assert [p["seed"] for p in port] == list(range(8))
    assert all(p["train_cycles"] == 10 and list(p["arms"]) == ["fixed"] and p["card"].startswith("NVIDIA H100")
               for p in port)
    assert all(s["cycles"] == 10 and s["arms"] == ["fixed"] and s["finished"] for s in jax_seeds)
    verdict = outcome.judge_cut(jax_seeds, port, 10)
    assert json.loads(json.dumps(verdict)) == json.loads((outcome.OUT / "cut10_verdict.json").read_text())
    assert len(verdict["held"]) == 14 and verdict["ok"]
