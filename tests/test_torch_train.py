"""The port's training loop against the JAX package: one AdamW step from
identical weights, batch and learning rate; a tiny ``run_training`` cycle
on the CPU; the entry points' device rule; and the import boundary (the port
imports neither JAX nor the JAX package)."""

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
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.train import loop as jloop
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_one_train_step_matches_jax():
    """From the same weights, batch and LR, one step leaves the parameters,
    the AdamW moments and the BN running statistics equal to the JAX update.

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
    rng = np.random.default_rng(0)
    n, lr = 6, 1e-3
    videos = (0.3 * rng.normal(size=(n, 6, 9, 9)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(n, 1)).astype(np.float32)
    idx = np.array([4, 1, 2])

    jcfg = JTrainConfig(lr=lr)
    jmodel = JGeneral(JModelConfig(**SMALL), embedding="deep_resnet")
    params, bstats = jax.jit(lambda k, x: j_init(jmodel, k, x))(jax.random.key(0), jnp.asarray(videos[:1]))
    impls = jloop.make_train_impls(jmodel, jcfg)
    tx = jloop.make_optimizer(jcfg)
    state = jloop.TrainState(params, bstats, tx.init(params))
    state = state.replace(opt_state=jloop._set_lr(state.opt_state, jnp.float32(lr)))
    with jax.default_matmul_precision("highest"):
        new, jl = jax.jit(impls.train_step)(
            state, jnp.asarray(videos), jnp.asarray(labels), None, jnp.asarray(idx), jax.random.key(1)
        )
    adam = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda v: hasattr(v, "mu")) if hasattr(s, "mu"))

    tmodel = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    tmodel.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    tstate = tloop.TrainState(tmodel.train(), tloop.make_optimizer(tmodel, TrainConfig(lr=lr)))
    tl = tloop.make_train_impls(tmodel, TrainConfig(lr=lr), device="cpu").train_step(
        tstate, torch.from_numpy(videos), torch.from_numpy(labels), torch.from_numpy(idx)
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


@pytest.mark.parametrize(
    "kw", [dict(compute_dtype="bfloat16"), dict(loss="l1"), dict(mix_trajectories=True)]
)
def test_unported_train_options_raise(kw):
    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.make_train_impls(model, TrainConfig(**kw), device="cpu")


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
    files = sorted((ROOT / "moleculardiffusion_mivit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "flax", "optax", "moleculardiffusion_mivit_tpu")
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {mod}"
