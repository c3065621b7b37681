"""The port's serving path (``evaluation.serving``) on the CPU at small width
(2 encoder layers, embed 16), against the JAX package's models as
``examples/serving_benchmark.py`` drives them: the served forward plain and
with the 4-rotation TTA, the bf16-cast forward, the five per-arm forwards,
each on flax weights converted by ``utils.convert``; then the entry point's
modes and the figure its per-arm file feeds."""

import json
import math
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.experiments.base import rotate_videos as j_rotate_videos
from moleculardiffusion_mivit_tpu.experiments.images_features import FeatureMLP as JFeatureMLP
from moleculardiffusion_mivit_tpu.features import d_from_msd_tau1 as j_d_from_msd_tau1
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import init_model as j_init_model
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import plots, serving
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
BATCH = 4
RTOL = ATOL = 1e-5
# bf16 against bf16: the two frameworks round at other places (flax's
# BatchNorm applies bf16 statistics in bf16, the port's in f32 before one
# rounding; the convolutions and products accumulate in other orders), so
# the two bf16 forwards are held to 4 bf16 ulps of max|pred| (measured 1)
BF16_ULPS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_state(model, seed, *inputs):
    """Flax weights of ``model`` from ``jax.random.key(seed)``, its
    BatchNorm running statistics moved off their identity init (means
    N(0, 0.5), variances U(0.5, 2), from numpy) so that the served forward
    applies them."""
    params, batch_stats = j_init_model(model, jax.random.key(seed), *inputs)
    rng = np.random.default_rng(seed)

    def move(path, v):
        if path[-1].key == "mean":
            return (0.5 * rng.normal(size=v.shape)).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)

    return _numpy(params), jax.tree_util.tree_map_with_path(move, _numpy(batch_stats))


def _port(model, params, batch_stats):
    model.load_state_dict(torch_state_from_flax(params, batch_stats))
    return model.eval()


def _jax_apply(model, params, batch_stats, *inputs):
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return model.apply(variables, *inputs, train=False)


@pytest.fixture(scope="module")
def flagship_pair():
    """The flagship at small width on both sides, from one set of flax
    weights, and a batch of videos."""
    jmodel = JGeneral(JModelConfig().replace(**SMALL), embedding="deep_resnet")
    rng = np.random.default_rng(3)
    videos = rng.normal(size=(BATCH, serving.FRAMES, 9, 9)).astype(np.float32)
    params, batch_stats = _flax_state(jmodel, 1, jnp.asarray(videos[:1]))
    old = serving.MODEL_CONFIG
    serving.MODEL_CONFIG = ModelConfig().replace(**SMALL)
    try:
        model = _port(serving.flagship(), params, batch_stats)
    finally:
        serving.MODEL_CONFIG = old
    return dict(jmodel=jmodel, params=params, batch_stats=batch_stats, videos=videos, model=model)


def test_served_forward_and_tta_match_jax(flagship_pair):
    """The served eval-mode forward and its 4-rotation mean
    (``serving.tta``) against JAX's ``model.apply(train=False)`` and the
    mean over ``rotate_videos(·, k)``, k = 0…3, on converted flax weights
    with BatchNorm statistics off their init, at rtol/atol 1e-5."""
    p = flagship_pair
    videos = jnp.asarray(p["videos"])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jax_apply(p["jmodel"], p["params"], p["batch_stats"], videos))
        want_tta = np.asarray(jnp.mean(jnp.stack([
            _jax_apply(p["jmodel"], p["params"], p["batch_stats"], j_rotate_videos(videos, k)) for k in range(4)]),
            axis=0))
    with torch.inference_mode():
        x = torch.from_numpy(p["videos"])
        got, got_tta = p["model"](x).numpy(), serving.tta(p["model"])(x).numpy()
    assert got.shape == want.shape == (BATCH, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_tta, want_tta, rtol=RTOL, atol=ATOL)
    assert not np.allclose(want_tta, want, rtol=1e-3)  # the rotations change the predictions


def test_bf16_cast_forward_matches_jax_bf16_cast(flagship_pair):
    """``serving.bf16_forward`` (parameters, BatchNorm running statistics
    and videos cast to bf16, predictions returned in f32) against the
    example's cast of JAX's forward (params and ``batch_stats`` cast to
    bf16, videos cast, output ``astype(float32)``), within ``BF16_ULPS``
    bf16 ulps of max|pred|; and the port's f32 weights untouched by it."""
    p = flagship_pair
    cast = lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x  # noqa: E731
    bparams, bstats = jax.tree.map(cast, p["params"]), jax.tree.map(cast, p["batch_stats"])
    want = np.asarray(_jax_apply(p["jmodel"], bparams, bstats, cast(jnp.asarray(p["videos"]))).astype(jnp.float32))
    before = {k: v.clone() for k, v in p["model"].state_dict().items()}
    with torch.inference_mode():
        got = serving.bf16_forward(p["model"])(torch.from_numpy(p["videos"]))
        f32 = p["model"](torch.from_numpy(p["videos"]))
    assert got.dtype == torch.float32
    assert all(torch.equal(v, before[k]) and v.dtype == before[k].dtype
               for k, v in p["model"].state_dict().items())
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    assert float(np.abs(got.numpy() - want).max()) <= BF16_ULPS * ulp
    assert float((got - f32).abs().max()) > 0  # the cast does round


@pytest.fixture(scope="module")
def arm_pairs():
    """The five poster arms on both sides at small width, from flax
    weights, and their inputs."""
    jcfg = JModelConfig().replace(**SMALL)
    rng = np.random.default_rng(5)
    inputs = {"videos": rng.normal(size=(BATCH, serving.FRAMES, 9, 9)).astype(np.float32),
              "features": rng.normal(size=(BATCH, 25)).astype(np.float32),
              "trajs": np.cumsum(rng.normal(size=(BATCH, serving.FRAMES, 2)), axis=1).astype(np.float32)}
    jmodels = {"ft_mlp": JFeatureMLP(), "im_resnet": JResNet(), "im_tr": JGeneral(jcfg, embedding="deep_resnet"),
               "im_ft_early_tr": JGeneral(jcfg, embedding="deep_resnet", use_global_features=True,
                                          fusion_type="early")}
    old = serving.MODEL_CONFIG
    serving.MODEL_CONFIG = ModelConfig().replace(**SMALL)
    try:
        models = serving.arm_models()
    finally:
        serving.MODEL_CONFIG = old
    keys = {name: keys for name, (_, keys) in serving.per_arm_forwards(models).items()}
    want = {"MSD_Frame": np.asarray(j_d_from_msd_tau1(jnp.asarray(inputs["trajs"])) * 37.5)}
    with jax.default_matmul_precision("highest"):
        for i, (name, jm) in enumerate(jmodels.items()):
            xs = [jnp.asarray(inputs[k]) for k in keys[name]]
            params, batch_stats = _flax_state(jm, 10 + i, *(x[:1] for x in xs))
            _port(models[name], params, batch_stats)
            want[name] = np.asarray(_jax_apply(jm, params, batch_stats, *xs))
    return dict(inputs=inputs, models=models, want=want)


@pytest.mark.parametrize("arm", serving.ARMS)
def test_per_arm_forward_matches_jax(arm_pairs, arm):
    """Each poster arm's forward as ``--per-arm`` times it, on its own
    kind of input, against the example's JAX counterpart (``d_from_msd_tau1
    × 37.5``, ``FeatureMLP``, ``MultiImageResNet``, the image transformer,
    the early-fusion transformer) at rtol/atol 1e-5."""
    fn, keys = serving.per_arm_forwards(arm_pairs["models"])[arm]
    with torch.inference_mode():
        got = fn(*(torch.from_numpy(arm_pairs["inputs"][k]) for k in keys)).numpy()
    want = arm_pairs["want"][arm]
    assert got.shape == want.shape and got.shape[0] == BATCH
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture
def small_serving(monkeypatch):
    monkeypatch.setattr(serving, "MODEL_CONFIG", ModelConfig().replace(**SMALL))
    monkeypatch.setattr(serving, "REPEATS", 2)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_main_prints_the_example_keys_on_the_cpu(small_serving, capsys):
    """``main(["--device", "cpu", ...])``: the sweep's rows with the
    example's keys (``--tta`` and ``--bf16`` add theirs), the peak line, the
    card on stderr; ``--cold-start`` the example's keys with no AOT cache."""
    report = serving.main(["--device", "cpu", "--batches", "2", "3", "--iters", "1", "--tta", "--bf16"])
    out, err = capsys.readouterr()
    rows = _json_lines(out)
    assert [list(r) for r in rows[:2]] == [["batch", "latency_ms", "seqs_per_sec", "max_pred_delta_d_units",
                                            "tta_latency_ms", "tta_cost_factor"]] * 2
    assert [r["batch"] for r in rows[:2]] == [2, 3]
    assert list(rows[2]) == ["peak_seqs_per_sec", "at_batch"] and rows[2]["at_batch"] in (2, 3)
    assert all(math.isfinite(v) and v > 0 for r in rows[:2] for v in r.values())
    assert json.loads(err.strip().splitlines()[0]) == {"card": "cpu"}
    assert report["rows"] == rows[:2] and report["peak"] == rows[2] and report["card"] == "cpu"
    assert report["captured_equals_eager"] == []  # no graph on the CPU

    serving.main(["--device", "cpu", "--batches", "2", "--iters", "1"])
    rows = _json_lines(capsys.readouterr().out)
    assert list(rows[0]) == ["batch", "latency_ms", "seqs_per_sec"] and len(rows) == 2

    cold = serving.main(["--device", "cpu", "--batches", "2", "--cold-start"])["cold_start"]
    assert _json_lines(capsys.readouterr().out) == [cold]
    assert set(cold) == {"batch", "source", "model_init_s", "lower_s", "compile_s", "deserialize_s",
                         "first_prediction_s"}
    assert cold["source"] == "none" and cold["batch"] == 2
    assert cold["lower_s"] is cold["compile_s"] is cold["deserialize_s"] is None
    assert 0 <= cold["model_init_s"] <= cold["first_prediction_s"]


def test_per_arm_file_feeds_the_accuracy_vs_cost_figure(small_serving, tmp_path, capsys):
    """``--per-arm OUT.json`` writes ``{arm: [mean_ms, std_ms]}`` for the
    five arms, each ≥ 0, and the port's ``render_all`` on a result
    directory holding it beside an ``*_errors.csv`` draws
    ``accuracy_vs_cost.png``."""
    pytest.importorskip("matplotlib")
    run = tmp_path / "run"
    run.mkdir()
    shutil.copy(ROOT / "results" / "torch_images_features_seed0" / "images_features_errors.csv", run)
    out = run / "inference_times.json"
    times = serving.main(["--device", "cpu", "--batches", "2", "--iters", "1", "--per-arm", str(out)])["per_arm"]
    written = json.loads(out.read_text())
    assert written == times and list(written) == list(serving.ARMS)
    assert all(len(v) == 2 and v[0] >= 0 and v[1] >= 0 and all(map(math.isfinite, v)) for v in written.values())
    assert [list(r)[0] for r in _json_lines(capsys.readouterr().out)] == list(serving.ARMS)
    made = plots.render_all(str(run))
    assert Path(made["accuracy_vs_cost"]) == run / "figures" / "accuracy_vs_cost.png"
    assert (run / "figures" / "accuracy_vs_cost.png").stat().st_size > 0


def test_served_timer_takes_the_slope_between_block_lengths():
    """``arm_seconds`` with the slope: the per-forward time between calls
    of ``n`` and ``4n`` forwards, so a fixed cost a call drops out."""
    calls = []

    def fn(x):
        calls.append(1)
        return x

    runs = serving.arm_seconds(fn, (torch.zeros(1),), 3, slope=True)
    assert len(runs) == serving.REPEATS and all(math.isfinite(r) for r in runs)
    # one eager reference call for each block length, then each repeat: one
    # untimed and 3 timed calls of 3 and of 12 forwards
    assert len(calls) == 2 + serving.REPEATS * 4 * (3 + 12)


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    """Without ``--device`` the entry point asks for the card and raises
    where there is none, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--cold-start"], ["--per-arm", str(tmp_path / "t.json")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.main(argv)
    assert not (tmp_path / "t.json").exists()
    assert "jax" not in sys.modules["moleculardiffusion_mivit_tpu_torch.evaluation.serving"].__dict__
