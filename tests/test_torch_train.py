"""The port's training loop against the JAX package: one AdamW step from
identical weights, batch and learning rate (mse and l1 losses); the
tail-swap augmentations given the JAX package's split draws; a tiny
``run_training`` cycle on the CPU; the entry points' device rule; and the
import boundary (the port imports neither JAX nor the JAX package)."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageFeatureResNet as JFeatureResNet
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.train import loop as jloop
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageFeatureResNet, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(kind):
    """The flax model and the port's at the small width: ``kind`` is an
    embedding of GeneralTransformer, or ``"resnet"`` for MultiImageResNet."""
    if kind == "resnet":
        return JResNet(single_prediction=True), MultiImageResNet(single_prediction=True)
    return (JGeneral(JModelConfig(**SMALL), embedding=kind),
            GeneralTransformer(ModelConfig(**SMALL), embedding=kind))


@pytest.mark.parametrize("kind", ["deep_resnet", "linear", "cnn", "resnet"])
def test_one_train_step_matches_jax(kind):
    """From the same weights, batch and LR, one step leaves the parameters,
    the AdamW moments and the BN running statistics equal to the JAX update,
    for each kind of baseline arm (BatchNorm through the fused embedding,
    none, none, BatchNorm through torch operators).

    - Parameters and running statistics: 1e-5 relative.
    - Moments (0.1·g and 0.001·g² after one step): 1e-5 relative plus 1e-4
      of the tensor's largest entry, since gradients through BN and two
      encoder layers differ by float reassociation up to ~3e-5 of it
      (measured on the reg_token); plus 1e-6 of the largest moment of any
      tensor, since the k_proj bias's gradient is analytically 0 (softmax is
      shift-invariant) and float noise on both sides.
    - The first Adam step is lr·g/(|g| + eps): where |g| is within a factor
      1000 of eps (1e-8) it turns a gradient's float error into a visible
      share of lr, so parameters there are held only to the step bound 2·lr.
    """
    _one_step_matches_jax(kind, "mse")


@pytest.mark.parametrize("kind", ["deep_resnet", "linear"])
def test_one_train_step_matches_jax_with_l1_loss(kind):
    """As ``test_one_train_step_matches_jax``, with ``loss="l1"``: the
    gradient of mean|pred - y| is sign(pred - y)/N, and the update holds to
    the same tolerances."""
    _one_step_matches_jax(kind, "l1")


def _one_step_matches_jax(kind, loss):
    _step_matches_jax(*_models(kind), loss)


# The images-features experiment's models that take features beside videos
FEATURE_MODELS = ("early_fusion", "late_fusion", "feature_resnet")


@pytest.mark.parametrize("kind", FEATURE_MODELS)
def test_one_train_step_with_features_matches_jax(kind):
    """As ``test_one_train_step_matches_jax`` (same tolerances) for the
    models that take the 25 features: GeneralTransformer with early and
    late fusion (deep_resnet embedding) and MultiImageFeatureResNet, the
    features gathered with the same minibatch indices as the videos."""
    if kind == "feature_resnet":
        models = JFeatureResNet(external_dim=25, feature_size=16, hidden_size=32), MultiImageFeatureResNet(
            25, feature_size=16, hidden_size=32)
    else:
        fusion = dict(embedding="deep_resnet", use_global_features=True, global_feature_dim=25,
                      fusion_type=kind.split("_")[0])
        models = JGeneral(JModelConfig(**SMALL), **fusion), GeneralTransformer(ModelConfig(**SMALL), **fusion)
    _step_matches_jax(*models, "mse", with_features=True)


def _step_matches_jax(jmodel, tmodel, loss, with_features=False, feature_shape=(25,), frame_size=9,
                      per_frame_labels=False):
    """One step of each side from the same weights on 6 sequences of 6
    frames of ``frame_size``², ``feature_shape`` features per sequence with
    ``with_features``, a label per sequence (a label per frame with
    ``per_frame_labels``, sequence mode), held as
    ``test_one_train_step_matches_jax`` says."""
    rng = np.random.default_rng(0)
    n, lr = 6, 1e-3
    videos = (0.3 * rng.normal(size=(n, 6, frame_size, frame_size)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(n, 6 if per_frame_labels else 1)).astype(np.float32)
    feats = rng.normal(size=(n, *feature_shape)).astype(np.float32) if with_features else None
    idx = np.array([4, 1, 2])

    jcfg = JTrainConfig(lr=lr, loss=loss)
    example = (jnp.asarray(videos[:1]),) + ((jnp.asarray(feats[:1]),) if with_features else ())
    params, bstats = jax.jit(lambda k, *x: j_init(jmodel, k, *x))(jax.random.key(0), *example)
    impls = jloop.make_train_impls(jmodel, jcfg, with_features)
    tx = jloop.make_optimizer(jcfg)
    state = jloop.TrainState(params, bstats, tx.init(params))
    state = state.replace(opt_state=jloop._set_lr(state.opt_state, jnp.float32(lr)))
    with jax.default_matmul_precision("highest"):
        new, jl = jax.jit(impls.train_step)(
            state, jnp.asarray(videos), jnp.asarray(labels), None if feats is None else jnp.asarray(feats),
            jnp.asarray(idx), jax.random.key(1)
        )
    adam = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda v: hasattr(v, "mu")) if hasattr(s, "mu"))

    tmodel.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    tcfg = TrainConfig(lr=lr, loss=loss)
    tstate = tloop.TrainState(tmodel.train(), tloop.make_optimizer(tmodel, tcfg))
    tl = tloop.make_train_impls(tmodel, tcfg, device="cpu", with_features=with_features).train_step(
        tstate, torch.from_numpy(videos), torch.from_numpy(labels), torch.from_numpy(idx),
        features=None if feats is None else torch.from_numpy(feats),
    )
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)

    mu = torch_state_from_flax(_np(adam.mu))
    moments = {"exp_avg": mu, "exp_avg_sq": torch_state_from_flax(_np(adam.nu))}
    for key, ref in moments.items():
        floor = 1e-6 * max(float(v.abs().max()) for v in ref.values())
        for name, p in tmodel.named_parameters():
            w = ref[name].numpy()
            np.testing.assert_allclose(
                tstate.optimizer.state[p][key].numpy(), w,
                rtol=1e-5, atol=1e-4 * np.abs(w).max() + floor, err_msg=f"{name} {key}",
            )

    want = torch_state_from_flax(_np(new.params), _np(new.batch_stats))
    got = tmodel.state_dict()
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w.numpy())
        off = diff > 1e-5 * np.abs(w.numpy()) + 1e-7
        if off.any():
            grad = np.abs(mu[name].numpy()) / 0.1  # mu = (1 - b1)·g after one step
            assert (grad[off] < 1e3 * 1e-8).all() and (diff[off] <= 2 * lr).all(), name


def test_generate_cycle_data_shapes_and_labels():
    cfg = TrainConfig(sequences_per_d=3, n_frames=4)
    g = torch.Generator().manual_seed(0)
    videos, labels = tloop.generate_cycle_data(g, cfg, BASELINE_OPTICS)
    assert videos.shape == (12, 4, 9, 9) and labels.shape == (12, 1)
    assert torch.isfinite(videos).all() and (labels >= 0).all()
    # each class is D ~ N(mean, 1) truncated at 0, divided by d_max = 10
    means = labels.reshape(4, 3).mean(dim=1) * 10
    assert (means.diff() > 0).all()
    seq_v, seq_l = tloop.generate_cycle_data(
        torch.Generator().manual_seed(0), cfg.replace(sequence_mode=True), BASELINE_OPTICS
    )
    assert seq_l.shape == (12, 4)
    torch.testing.assert_close(seq_l[:, :1], labels)


def test_run_training_one_tiny_cycle_on_cpu():
    """History keys are the JAX ``run_training``'s (``val_<D>`` per D,
    ``val_avg``, ``train_loss``), one finite entry per cycle."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4, initial_batch_size=2)
    trajs = tval.generate_frozen_validation(d_values=(1, 3), n_particles=2, t_steps=40, device="cpu")
    assert trajs["valTrajsInOrder"].shape == (70, 10, 40, 2)
    trajs.pop("valTrajsInOrder")
    vids = tval.render_validation_videos(trajs, cfg, BASELINE_OPTICS, device="cpu")
    val = {1.0: vids["val1"], 3.0: vids["val3"]}
    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    calls = []
    state, hist = tloop.run_training(
        model, cfg, BASELINE_OPTICS, val, num_cycles=1, device="cpu", callback=lambda c, m: calls.append(c)
    )
    expected = {f"val_{d:g}" for d in val} | {"val_avg", "train_loss"}
    assert set(hist) == expected and calls == [0]
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in hist.values())
    assert state.model is model and next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("kind", ["resnet", "linear", "cnn"])
def test_run_training_one_tiny_cycle_on_cpu_other_arms(kind):
    """``run_training`` takes the arms whose BatchNorm runs through torch
    operators, or that have none, unchanged: finite history, and the
    ResNet's running statistics moved by the training forwards and left
    alone by the evaluation."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4, initial_batch_size=2)
    trajs = tval.generate_frozen_validation(d_values=(1, 3), n_particles=2, t_steps=40, device="cpu")
    trajs.pop("valTrajsInOrder")
    vids = tval.render_validation_videos(trajs, cfg, BASELINE_OPTICS, device="cpu")
    val = {1.0: vids["val1"], 3.0: vids["val3"]}
    model = _models(kind)[1]
    state, hist = tloop.run_training(model, cfg, BASELINE_OPTICS, val, num_cycles=1, device="cpu")
    assert set(hist) == {"val_1", "val_3", "val_avg", "train_loss"}
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in hist.values())
    assert state.model is model and model.training
    if kind == "resnet":
        bn = model.resnet.trunk.bn1
        assert not torch.equal(bn.running_mean, torch.zeros(32))
        kept = bn.running_mean.clone()
        tloop.make_train_impls(model, cfg, device="cpu").evaluate(state, val[1.0])
        assert torch.equal(bn.running_mean, kept) and model.training


def test_train_cycle_schedule_and_remainder():
    """LR from the caller lands in the optimizer; the epoch takes n // batch
    steps and drops the remainder."""
    cfg = TrainConfig(lr=1e-3)
    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    impls = tloop.make_train_impls(model, cfg, device="cpu")
    state = impls.init_state(torch.Generator().manual_seed(0))
    videos = torch.randn(7, 3, 9, 9) * 0.3
    labels = torch.rand(7, 1)
    loss = impls.train_cycle(state, videos, labels, torch.Generator().manual_seed(1), cfg.lr_for_cycle(5), 3)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9)
    assert torch.isfinite(loss)
    first = next(iter(state.optimizer.state.values()))
    assert int(first["step"]) == 7 // 3
    assert cfg.batch_size_for_cycle(40) == 4 and cfg.replace(adaptive_batch_size=-1).batch_size_for_cycle(3) == 16


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device, an entry point given no device raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.run_training(model, TrainConfig(), BASELINE_OPTICS, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tval.generate_frozen_validation()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tval.render_validation_videos({}, TrainConfig(), BASELINE_OPTICS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.make_train_impls(model, TrainConfig())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "moleculardiffusion_mivit_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_cycle.py", ROOT / "feature_outliers.py",
        ROOT / "denoising_outcome.py", ROOT / "realdata_outcome.py", ROOT / "images_features_bf16_outcome.py",
        ROOT / "changepoint_outcome.py", ROOT / "changepoint_shared_eval.py", ROOT / "ensemble_outcome.py",
        ROOT / "rescore_outcome.py"]
    scanned = {path.relative_to(ROOT).as_posix() for path in files}
    assert {f"moleculardiffusion_mivit_tpu_torch/{m}.py" for m in (
        "ops/hull", "ops/curve_fit", "features/features", "features/msd", "experiments/images_features",
        "features/per_frame", "experiments/modular", "ops/filters", "denoise/rl_tv",
        "experiments/denoising", "realdata/__init__", "realdata/tiff", "realdata/detect", "realdata/link",
        "realdata/track", "realdata/patches", "realdata/localize", "realdata/stats", "realdata/pipeline",
        "realdata/demo", "realdata/viz", "sim/constrained", "sim/mitochondria_demo", "evaluation/changepoint",
        "evaluation/analysis", "evaluation/plots", "evaluation/changepoint_study", "realdata/sim2real",
        "experiments/ensemble", "experiments/continuous_d", "experiments/tta_rescore",
        "experiments/seed_ensemble", "experiments/render_noise", "evaluation/msd_protocol",
        "sim/simulator_validation", "evaluation/poster_gallery", "evaluation/serving")} <= scanned
    banned = ("jax", "flax", "optax", "moleculardiffusion_mivit_tpu", "PIL")
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {mod}"
        # pandas and matplotlib only inside a function (the DataFrame wrappers,
        # the plots), never at import: the card machine has neither
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for top in ("pandas", "matplotlib"):
                assert all(n.split(".")[0] != top for n in names), f"{path.relative_to(ROOT)} imports {top}"


def _decodable(n, f):
    """Videos whose every pixel of sequence i, frame t is 100·i + t, and
    labels equal to the same code per frame."""
    code = (100 * np.arange(n)[:, None] + np.arange(f)[None, :]).astype(np.float32)
    return np.broadcast_to(code[:, :, None, None], (n, f, 3, 3)).copy(), code


def test_mix_trajectory_tails_matches_jax_given_its_splits():
    """The port's tail swap, handed the splits the JAX function draws
    (``fold_in(key, pair)``, one draw per pair), gives the JAX result
    exactly; the port's own draw from a fixed seed swaps the first half of
    each of the four classes, once, within the split window."""
    n_classes, n_per, f = 4, 8, 14
    n, quarter = n_classes * n_per, n_per // 4
    videos, labels = _decodable(n, f)
    key = jax.random.key(7)
    jv, jl = jloop.mix_trajectory_tails(key, jnp.asarray(videos), jnp.asarray(labels), n_classes, f)
    tv, tl = torch.from_numpy(videos), torch.from_numpy(labels)
    for pair_i, (ca, cb, start) in enumerate(tloop._TAIL_PAIRS):
        splits = jax.random.randint(jax.random.fold_in(key, pair_i), (quarter,), f // 2 - 5, f // 2 + 5)
        first = start * quarter + torch.arange(quarter)
        tv, tl = tloop.swap_tails((tv, tl), ca * n_per + first, cb * n_per + first,
                                   torch.from_numpy(np.array(splits)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    mv, ml = tloop.mix_trajectory_tails(torch.Generator().manual_seed(0), torch.from_numpy(videos),
                                        torch.from_numpy(labels), n_classes, f)
    origin = (ml.numpy() // 100).astype(int)
    np.testing.assert_array_equal(mv[:, :, 0, 0].numpy(), ml.numpy())
    partner = {}
    for ca, cb, start in tloop._TAIL_PAIRS:
        for k in range(quarter):
            a, b = ca * n_per + start * quarter + k, cb * n_per + start * quarter + k
            partner[a], partner[b] = b, a
    assert len(partner) == n // 2  # half of every class is in one swap
    splits = []
    for i in range(n):
        if i not in partner:
            assert (origin[i] == i).all()
            continue
        switch = int(np.argmax(origin[i] != i))
        assert f // 2 - 5 <= switch < f // 2 + 5
        assert (origin[i, :switch] == i).all() and (origin[i, switch:] == partner[i]).all()
        splits.append(switch)
    assert len(set(splits)) > 3  # the splits are drawn, not fixed


def test_mix_tails_uniform_matches_jax_given_its_splits():
    """``mix_tails_uniform`` pairs sequence i with n-1-i for the first
    ``int(n·fraction)//2``; given the JAX split draw it equals the JAX
    result exactly, and its own draw swaps just those pairs."""
    n, f = 20, 14
    videos, labels = _decodable(n, f)
    key = jax.random.key(3)
    jv, jl = jloop.mix_tails_uniform(key, jnp.asarray(videos), jnp.asarray(labels), f)
    half = n // 4
    splits = jax.random.randint(key, (half,), f // 2 - 5, f // 2 + 5)
    ia = torch.arange(half)
    tv, tl = tloop.swap_tails((torch.from_numpy(videos), torch.from_numpy(labels)), ia, (n - 1) - ia,
                               torch.from_numpy(np.array(splits)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    _, ml = tloop.mix_tails_uniform(torch.Generator().manual_seed(1),
                                    (torch.from_numpy(videos), torch.from_numpy(labels)), f)
    origin = (ml.numpy() // 100).astype(int)
    for i in range(n):
        j = n - 1 - i
        if min(i, j) >= half:
            assert (origin[i] == i).all()
        else:
            switch = int(np.argmax(origin[i] != i))
            assert f // 2 - 5 <= switch < f // 2 + 5 and (origin[i, switch:] == j).all()


def test_run_training_mixes_trajectory_tails_in_sequence_mode():
    """With ``sequence_mode`` and ``mix_trajectories`` set, ``run_training``
    trains on mixed data (per-frame labels) and keeps a finite history."""
    cfg = TrainConfig(sequences_per_d=4, n_frames=12, initial_batch_size=4, sequence_mode=True,
                      mix_trajectories=True)
    trajs = tval.generate_frozen_validation(d_values=(1, 3), n_particles=2, t_steps=120, device="cpu")
    trajs.pop("valTrajsInOrder")
    vids = tval.render_validation_videos(trajs, cfg, BASELINE_OPTICS, device="cpu")
    model = GeneralTransformer(
        ModelConfig(**dict(SMALL, use_regression_token=False, single_prediction=False)), embedding="linear"
    )
    _, hist = tloop.run_training(model, cfg, BASELINE_OPTICS, {1.0: vids["val1"], 3.0: vids["val3"]},
                                 num_cycles=1, device="cpu")
    assert all(np.isfinite(v[0]) for v in hist.values())

