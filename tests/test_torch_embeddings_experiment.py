"""The port's embeddings experiment against the JAX package on the CPU: the
ten arms and their parameter counts at full width, ``GeneralTransformer``
with each embedding at the small (embed 32, 2 heads, FFN 64, 3 layers) and
big (128/8/256/12) sizes against flax through converted weights, one AdamW
step at embed 32 and 128, and the experiment through its entry points at
tiny sizes (6 frames, 2 to 4 sequences per D class, a 3-particle validation
suite): the fused cycle equals per-arm cycles, and ``run_experiment
embeddings`` writes the JAX runner's files and events. Inputs are made from
a seed with numpy; tolerances are stated per test."""

import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.experiments import embeddings as jemb
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.models import param_count as j_count
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig as TModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, embeddings
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer as TGeneral
from moleculardiffusion_mivit_tpu_torch.models import param_count as t_count
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from tests.test_torch_train import _step_matches_jax

ROOT = Path(__file__).resolve().parents[1]
ARMS = [k + s for s in ("_n", "_s", "_b") for k in ("linear_2layer", "cnn_2layer", "deepcnn_2layer")] + ["resnet"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_validation(monkeypatch):
    """Validation of 3 particles per D."""
    def load(length, device):
        return tval.generate_frozen_validation(d_values=(1, 5), n_particles=3, t_steps=10 * length,
                                               in_order_particles=1, device=device)

    monkeypatch.setattr(embeddings, "load_validation_trajectories", load)


def _cfg(suffix):
    """The JAX experiment's ModelConfig keywords of a size variant."""
    base = JModelConfig(use_pos_encoding=True)
    scale = jemb.SIZE_VARIANTS[suffix]
    return dict(use_pos_encoding=True, embed_dim=int(base.embed_dim * scale),
                num_heads=max(int(base.num_heads * scale), 1), hidden_dim=int(base.hidden_dim * scale),
                num_layers=max(int(base.num_layers * scale), 1))


def test_arms_sizes_and_param_counts_equal_jax(small_validation):
    """The ten arms in the JAX package's order; each size's ModelConfig is
    the JAX experiment's (embed/heads/FFN/layers 64/4/128/6, 32/2/64/3,
    128/8/256/12, positional encoding on); ``param_counts`` of every arm
    equals the JAX package's ``param_count`` of the same flax model exactly,
    as integers (flax's tree from tracing its init on one 30-frame 9×9
    sequence, ``jax.eval_shape``). No two arms stack."""
    assert list(embeddings.SIZE_VARIANTS) == list(jemb.SIZE_VARIANTS)
    assert embeddings.EMBEDDINGS == jemb.EMBEDDINGS
    exp = embeddings.build(sequences_per_d=2, val_length=6, val_d_values=(1.0, 5.0), device="cpu")
    assert list(exp.arms) == ARMS
    sizes = {s: (c["embed_dim"], c["num_heads"], c["hidden_dim"], c["num_layers"])
             for s in ("_n", "_s", "_b") for c in [_cfg(s)]}
    assert sizes == {"_n": (64, 4, 128, 6), "_s": (32, 2, 64, 3), "_b": (128, 8, 256, 12)}
    for name in ARMS[:-1]:
        cfg = exp.arms[name].model.config
        assert (cfg.embed_dim, cfg.num_heads, cfg.hidden_dim, cfg.num_layers) == sizes[name[-2:]], name
        assert cfg.use_pos_encoding
    counts = embeddings.param_counts(exp)
    assert list(counts) == ARMS and all(isinstance(v, int) for v in counts.values())
    x = np.zeros((1, 30, 9, 9), np.float32)
    for name in ARMS:
        jm = JResNet() if name == "resnet" else JGeneral(JModelConfig(**_cfg(name[-2:])),
                                                         embedding=jemb.EMBEDDINGS[name[:-2]])
        shapes = jax.eval_shape(lambda k, a: j_init(jm, k, a), jax.random.key(0), x)
        params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes[0])
        assert counts[name] == j_count(params), name
    assert exp._stack_groups == []


@pytest.mark.parametrize("suffix", ["_s", "_b"])
@pytest.mark.parametrize("embedding", ["linear", "cnn", "deep_resnet"])
def test_sized_transformers_match_flax(suffix, embedding):
    """``GeneralTransformer`` at the small and big sizes (embed 32 and 128,
    3 and 12 post-norm layers, 2 and 8 heads of 16) with each embedding, on
    flax's weights through ``torch_state_from_flax`` (2 sequences of 4 9×9
    frames): train- and eval-mode outputs at rtol/atol 1e-5, the deep-ResNet
    embedding's BatchNorm running statistics after the train-mode forward
    equal to flax's ``batch_stats`` at rtol 1e-5 / atol 1e-6, equal
    parameter counts, and the converter fills every parameter and buffer."""
    cfg = _cfg(suffix)
    rng = np.random.default_rng(3)
    x = (0.3 * rng.normal(size=(2, 4, 9, 9)) + 0.1).astype(np.float32)
    jm, tm = JGeneral(JModelConfig(**cfg), embedding=embedding), TGeneral(TModelConfig(**cfg), embedding=embedding)
    params, bstats = j_init(jm, jax.random.key(1), jnp.asarray(x))
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    variables = {"params": params, **({"batch_stats": bstats} if bstats else {})}
    mutable = ["batch_stats"] if bstats else []
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=mutable)
        new_stats = mut.get("batch_stats", bstats)
        jeval = jm.apply({"params": params, **({"batch_stats": new_stats} if bstats else {})}, jnp.asarray(x),
                         train=False)
    ttrain = tm.train()(torch.from_numpy(x))
    with torch.no_grad():
        teval = tm.eval()(torch.from_numpy(x))
    assert ttrain.shape == jtrain.shape == (2, 1)
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-5, atol=1e-5)
    assert bool(bstats) == (embedding == "deep_resnet")
    got = tm.state_dict()
    for key, want in torch_state_from_flax({}, _np(new_stats)).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    assert t_count(tm) == j_count(params)


@pytest.mark.parametrize("arm", ["deepcnn_2layer_s", "deepcnn_2layer_b"])
def test_one_train_step_at_embed_32_and_128_matches_jax(arm):
    """One AdamW step from flax's weights on the same batch leaves
    parameters, moments and BatchNorm statistics at the JAX update's, at
    the tolerances of ``test_torch_train.test_one_train_step_matches_jax``
    (1e-5): the deep-ResNet arm at embed 32 and 128, the widths its fc
    stage (K2/K3 on the card) takes first in this experiment."""
    cfg = _cfg(arm[-2:])
    emb = jemb.EMBEDDINGS[arm[:-2]]
    _step_matches_jax(JGeneral(JModelConfig(**cfg), embedding=emb), TGeneral(TModelConfig(**cfg), embedding=emb),
                      "mse")


def _build(**kw):
    exp = embeddings.build(sequences_per_d=2, val_length=6, val_d_values=(1.0, 5.0), device="cpu", **kw)
    exp.train_cfg = exp.train_cfg.replace(initial_batch_size=2, adaptive_batch_size=1)  # batch 2, then 4
    return exp


def test_embeddings_fused_cycle_equals_per_arm_cycles(small_validation):
    """The cycle's data (8 videos of 6 9×9 frames, labels ``(8, 1)``); two
    cycles through the fused cycle equal each arm's eager epoch in history,
    losses and parameters at 1e-6 relative; no arm stacks (every arm differs
    from every other beyond the FF slope)."""
    fused, per_arm = _build(), _build()
    per_arm.fused_cycles = False
    data = fused.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (8, 6, 9, 9) and data["labels"].shape == (8, 1)
    assert sorted(fused.val_data) == [1.0, 5.0] and fused.val_data[1.0]["videos"].shape == (3, 6, 9, 9)
    fused.run(2)
    per_arm.run(2)
    assert fused._stack_groups == []
    assert list(fused.history) == ARMS
    for name in ARMS:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
        np.testing.assert_allclose([float(v) for v in fused.train_loss[name]],
                                   [float(v) for v in per_arm.train_loss[name]], rtol=1e-6)
        assert len(fused.history[name]["val_1"]) == 2 and all(np.isfinite(fused.history[name]["val_avg"]))
        got, want = fused.states[name].model.state_dict(), per_arm.states[name].model.state_dict()
        for key in got:
            torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


def test_run_experiment_embeddings(small_validation, monkeypatch, tmp_path):
    """``run_experiment embeddings`` on the CPU writes the ten arms'
    histories, the final states and metrics.jsonl with the JAX runner's
    events (less ``figures``, not ported, ``resumed``, and
    ``error_tables``: the experiment has no in-order sweep, in JAX neither);
    ``--in-order`` leaves it without one, as in the JAX runner."""
    monkeypatch.setitem(REGISTRY, "embeddings",
                        functools.partial(embeddings.build, val_length=6, val_d_values=(1.0, 5.0)))
    out = tmp_path / "run"
    exp = run_experiment.main(["embeddings", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out),
                               "--device", "cpu", "--checkpoint-last", "0", "--in-order"])
    assert exp.in_order_data is None
    for name in ("metrics.jsonl", "history.json", "final/history.json", "final/meta.json",
                 "final/states/deepcnn_2layer_b.pt", "final/states/resnet.pt"):
        assert (out / name).is_file(), name
    assert not (out / "embeddings_errors.csv").exists()
    history = json.loads((out / "history.json").read_text())
    assert list(history) == ARMS
    assert all(len(h["val_avg"]) == 1 and np.isfinite(h["val_avg"][0]) for h in history.values())
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert events[0]["event"] == "start" and events[0]["models"] == ARMS
    assert events[0]["training_ds"] == [[1, 1], [3, 1], [5, 1], [7, 1]]
    jax_runner = (ROOT / "moleculardiffusion_mivit_tpu" / "run_experiment.py").read_text()
    jax_events = set(re.findall(r'logger\.log\(\s*"(\w+)"', jax_runner)) | {"cycle"}
    assert {e["event"] for e in events} == jax_events - {"figures", "resumed", "error_tables"}
