"""The modular slice of the port against the JAX package on the CPU: the
per-frame feature tokens, ``ModularTransformer`` in every configuration the
modular experiment trains (and the linear feature embedding, and both
outputs without a regression token), ``HybridFusionTransformer`` with both
fusions and both outputs, and the published in-order suite the port ships.
Inputs are made from a seed with numpy; tolerances are stated per test."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.features import compute_per_frame_features as j_per_frame
from moleculardiffusion_mivit_tpu.models import HybridFusionTransformer as JHybrid
from moleculardiffusion_mivit_tpu.models import ModularTransformer as JModular
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.models import param_count as j_count
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig as TModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments.images_features import MSD_MULT_FACTOR, MSD_MULT_FACTOR_AVG
from moleculardiffusion_mivit_tpu_torch.features import (
    N_PER_FRAME_FEATURES,
    PER_FRAME_FEATURE_NAMES,
    compute_per_frame_features,
    d_from_msd_tau1,
)
from moleculardiffusion_mivit_tpu_torch.models import HybridFusionTransformer as THybrid
from moleculardiffusion_mivit_tpu_torch.models import ModularTransformer as TModular
from moleculardiffusion_mivit_tpu_torch.models import param_count as t_count
from moleculardiffusion_mivit_tpu_torch.sim import average_trajectories_frames
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from tests.test_torch_train import _step_matches_jax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(use_pos_encoding=False, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
FRAMES = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- features

def _walks(seed, n, t):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=(n, t, 2)), axis=1) + rng.normal(size=(n, 1, 2))).astype(np.float32)


@pytest.mark.parametrize("t", [1, 2, 30])
def test_per_frame_features_match_jax(t):
    """``(N, T, 2)`` → ``(N, T, 6)`` tokens equal to the JAX function's at
    1e-6 relative (atol 1e-6 where a token is near 0), at 30 frames and at
    the edge cases of one frame (every token but the distance is 0, the time
    fraction divides by max(T − 1, 1)) and two."""
    x = _walks(t, 5, t)
    got = compute_per_frame_features(torch.from_numpy(x))
    want = np.asarray(j_per_frame(jnp.asarray(x)))
    assert got.shape == want.shape == (5, t, N_PER_FRAME_FEATURES) and len(PER_FRAME_FEATURE_NAMES) == 6
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got[:, 0, :4] == 0).all() and (got[:, 0, 5] == 0).all()


def test_per_frame_features_are_causal():
    """Moving frame k ≥ 1 changes no token before frame k, and changes frame
    k's (frame 0's tokens are relative to itself: moving the whole
    trajectory changes none)."""
    x = torch.from_numpy(_walks(3, 4, 12))
    base = compute_per_frame_features(x)
    torch.testing.assert_close(compute_per_frame_features(x + 3.0), base, rtol=0, atol=2e-5)
    for k in (1, 5, 11):
        moved = x.clone()
        moved[:, k] += 0.7
        out = compute_per_frame_features(moved)
        assert torch.equal(out[:, :k], base[:, :k]), k
        assert not torch.equal(out[:, k], base[:, k]), k


# ---------------------------------------------------------------- models

# ModularTransformer configurations: (model keywords, ModelConfig changes).
# The five arms of the modular experiment, then the linear feature
# embedding and the two outputs without a regression token.
MODULAR = {
    "mod_images": (dict(mode="images_only", fusion_method="add"), {}),
    "mod_features": (dict(mode="features_only", fusion_method="add"), {}),
    "mod_both_add": (dict(mode="both", fusion_method="add"), {}),
    "mod_both_concat": (dict(mode="both", fusion_method="concat_proj"), {}),
    "mod_both_concat_feat": (dict(mode="both", fusion_method="concat_features"), {}),
    "linear_both_concat": (dict(mode="both", fusion_method="concat_proj", feature_embedding_type="linear"), {}),
    "no_token_mean": (dict(mode="both", fusion_method="add"), dict(use_regression_token=False)),
    "no_token_per_token": (dict(mode="both", fusion_method="add"),
                           dict(use_regression_token=False, single_prediction=False)),
}
HYBRID = {
    f"hybrid_{fusion}_{'single' if single else 'sequence'}": (dict(fusion_method=fusion), dict(single_prediction=single))
    for fusion in ("concat_proj", "add") for single in (True, False)
}
MODELS = sorted(MODULAR) + sorted(HYBRID)


def _features(kind, rng, n, frames):
    """Per-frame features ``(N, F, 6)`` for a modular model, packed ``(N,
    F·6 + 25)`` for a hybrid one."""
    width = (frames * N_PER_FRAME_FEATURES + 25,) if kind == "hybrid" else (frames, N_PER_FRAME_FEATURES)
    return rng.normal(size=(n, *width)).astype(np.float32)


def _spec(name, cfg_base=SMALL):
    """``(kind, model keywords, ModelConfig keywords)`` of a named model."""
    if name in MODULAR:
        kw, cfg = MODULAR[name]
        return "modular", {"image_embedding": "deep_resnet", "features_dim": N_PER_FRAME_FEATURES,
                           "feature_embedding_type": "mlp", **kw}, dict(cfg_base, **cfg)
    kw, cfg = HYBRID[name]
    return "hybrid", dict(image_embedding="deep_resnet", per_frame_dim=N_PER_FRAME_FEATURES, global_dim=25,
                          **kw), dict(cfg_base, **cfg)


def _models(name, cfg_base=SMALL):
    kind, kw, cfg = _spec(name, cfg_base)
    jcls, tcls = (JModular, TModular) if kind == "modular" else (JHybrid, THybrid)
    return kind, jcls(JModelConfig(**cfg), **kw), tcls(TModelConfig(**cfg), **kw)


def _pair(name, x, f, seed=0, cfg_base=SMALL):
    kind, jm, tm = _models(name, cfg_base)
    params, bstats = jax.jit(lambda k, a, b: j_init(jm, k, a, b))(jax.random.key(seed), jnp.asarray(x),
                                                                   jnp.asarray(f))
    tm.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    return kind, jm, tm, params, bstats


@pytest.mark.parametrize("name", MODELS)
def test_modular_and_hybrid_models_match_flax(name):
    """On flax's weights through ``torch_state_from_flax`` (2 layers, embed
    16, 6 frames of 9×9, features with a NaN that both sides zero): train-
    and eval-mode outputs at rtol/atol 1e-5, the BatchNorm running
    statistics after the train-mode forward equal flax's ``batch_stats``,
    equal parameter counts, and the converter fills every parameter and
    buffer with no rule of its own for these trees."""
    rng = np.random.default_rng(11)
    x = (0.3 * rng.normal(size=(3, FRAMES, 9, 9)) + 0.1).astype(np.float32)
    kind = "hybrid" if name in HYBRID else "modular"
    f = _features(kind, rng, 3, FRAMES)
    if kind == "modular":
        f[1, 2, 0] = np.nan
    else:  # one per-frame and one global feature
        f[1, 2] = f[2, -1] = np.nan
    kind, jm, tm, params, bstats = _pair(name, x, f)
    variables = {"params": params, **({"batch_stats": bstats} if bstats else {})}
    mutable = ["batch_stats"] if bstats else []
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=True, mutable=mutable))(
            variables, jnp.asarray(x), jnp.asarray(f))
        new_stats = mut.get("batch_stats", bstats)
        jeval = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
            {"params": params, **({"batch_stats": new_stats} if bstats else {})}, jnp.asarray(x), jnp.asarray(f))
    tx, tf = torch.from_numpy(x), torch.from_numpy(f)
    ttrain = tm.train()(tx, tf)
    with torch.no_grad():
        teval = tm.eval()(tx, tf)
    assert ttrain.shape == jtrain.shape and torch.isfinite(ttrain).all()
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-5, atol=1e-5)
    got = tm.state_dict()
    assert bool(bstats) == (name != "mod_features")
    for key, want in torch_state_from_flax({}, _np(new_stats)).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    assert t_count(tm) == j_count(params)
    assert set(torch_state_from_flax(_np(params), _np(bstats))) == set(got)


def test_model_outputs_and_checks():
    """Output shapes of each mode, the concat_features image embedding's
    width, and what raises as in flax (a missing input, too narrow an
    embedding, a packed width that does not fit the frames) or because
    torch needs the width flax infers (``features_dim``)."""
    cfg = TModelConfig(**SMALL)
    x, f = torch.zeros(2, FRAMES, 9, 9), torch.zeros(2, FRAMES, N_PER_FRAME_FEATURES)
    feat = TModular(cfg, mode="both", features_dim=6, fusion_method="concat_features", feature_embedding_type="mlp")
    assert feat.image_embedding.fc.out_features == 10 and not hasattr(feat, "feature_fc1")
    assert feat(x, f).shape == (2, 1)
    assert not hasattr(TModular(cfg, mode="features_only", features_dim=6), "image_embedding")
    seq = TModular(TModelConfig(**SMALL, use_regression_token=False, single_prediction=False), mode="both",
                   features_dim=6)
    assert seq(x, f).shape == (2, FRAMES, 1)
    hyb = THybrid(TModelConfig(**SMALL, single_prediction=False))
    assert hyb(x, torch.zeros(2, FRAMES * 6 + 25)).shape == (2, FRAMES, 1)
    with pytest.raises(ValueError, match="features required"):
        feat(x)
    with pytest.raises(ValueError, match="images required"):
        feat(None, f)
    with pytest.raises(ValueError, match="features_dim"):
        TModular(cfg, mode="both")
    with pytest.raises(ValueError, match="must exceed features_dim"):
        TModular(TModelConfig(**dict(SMALL, embed_dim=6, num_heads=1)), mode="both", features_dim=6,
                 fusion_method="concat_features")
    with pytest.raises(ValueError, match="packed features"):
        hyb(x, torch.zeros(2, 25))
    with pytest.raises(ValueError, match="requires packed features"):
        hyb(x)


@pytest.mark.parametrize("name", ["mod_both_concat_feat", "mod_features", "hybrid_concat_proj_single",
                                  "hybrid_add_single", "glob_early"])
def test_full_width_param_count_and_state_keys_match_flax(name):
    """At the modular experiment's full width (embed 64, 4 heads, FFN 128, 6
    layers, no positional encoding, 30 frames; the concat_features image
    embedding at 58): equal parameter counts, and the converted state dict
    fills every parameter and buffer with the right shapes. ``glob_early``
    is the ``--with-hybrid`` early-fusion parent (a GeneralTransformer).
    flax's tree comes from tracing its init (``jax.eval_shape``), which
    gives every leaf's shape without computing it."""
    full = dict(use_pos_encoding=False)
    x = np.zeros((1, 30, 9, 9), np.float32)
    if name == "glob_early":
        from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
        from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer as TGeneral

        kw = dict(embedding="deep_resnet", use_global_features=True, fusion_type="early", global_feature_dim=25)
        jm, tm = JGeneral(JModelConfig(**full), **kw), TGeneral(TModelConfig(**full), **kw)
        f = np.zeros((1, 25), np.float32)
    else:
        f = _features("hybrid" if name in HYBRID else "modular", np.random.default_rng(0), 1, 30)
        _, jm, tm = _models(name, cfg_base=full)
    shapes = jax.eval_shape(lambda k, a, b: j_init(jm, k, a, b), jax.random.key(0), x, f)
    params, bstats = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert t_count(tm) == j_count(params)
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tm.state_dict())
    for key, v in tm.state_dict().items():
        assert state[key].shape == v.shape, key
    if name == "mod_both_concat_feat":
        assert tm.image_embedding.fc.out_features == 58


@pytest.mark.parametrize("name", ["mod_images", "mod_features", "mod_both_add", "mod_both_concat",
                                  "mod_both_concat_feat", "linear_both_concat", "no_token_per_token",
                                  "hybrid_concat_proj_single", "hybrid_add_sequence"])
def test_one_train_step_matches_jax(name):
    """One AdamW step from flax's weights on the same batch (per-frame or
    packed features gathered with the videos' indices) leaves parameters,
    moments and BatchNorm statistics at the JAX update's, at the tolerances
    of ``test_torch_train.test_one_train_step_matches_jax`` (1e-5)."""
    kind, jm, tm = _models(name)
    shape = (FRAMES * 6 + 25,) if kind == "hybrid" else (FRAMES, N_PER_FRAME_FEATURES)
    _step_matches_jax(jm, tm, "mse", with_features=name != "mod_images", feature_shape=shape)


# ---------------------------------------------------------------- the in-order suite

def test_shipped_in_order_suite_is_the_jax_array_and_gives_the_published_msd_rows():
    """The port's ``generate_in_order_imft()`` is the JAX package's
    ``generate_in_order_imft()`` exactly: (100, 10, 300, 2) float64 values,
    each an f32 cast. Made once from the root of a checkout, outside both
    packages, by

        python -c "import jax; jax.config.update('jax_platforms', 'cpu'); import numpy as np;
        from moleculardiffusion_mivit_tpu.evaluation import generate_in_order_imft;
        np.save('moleculardiffusion_mivit_tpu_torch/data/in_order_imft_seed2026.npy',
                generate_in_order_imft().astype(np.float32))"

    Scored by the port (``d_from_msd_tau1`` × the images-features factors,
    ``error_table``) it gives the MSD_Perfect and MSD_Frame rows of JAX's
    own scoring of the same array on the CPU at 1e-6 relative. The JAX
    record ``results/images_features_reconciled`` (the full-precision values
    of its ``error_tables`` event; the CSV rounds to 6 digits) was scored on
    a TPU, whose f32 arithmetic puts its MSD_Perfect 1.39e-6 relative from
    JAX's own CPU value and 1.41e-6 from the exact (float64) one: the port
    is held to that record at 1e-6 in MSD_Frame and at 2e-6 in MSD_Perfect.
    Any other suite raises: only the published one and its 200-step variant
    (``tests/test_torch_rescore.py``) are shipped."""
    from moleculardiffusion_mivit_tpu.evaluation import generate_in_order_imft as j_imft
    from moleculardiffusion_mivit_tpu.features import d_from_msd_tau1 as j_msd
    from moleculardiffusion_mivit_tpu.sim.trajectory import average_trajectories_frames as j_avg

    arr = tval.generate_in_order_imft()
    want = j_imft()
    assert arr.dtype == np.float64 and arr.shape == want.shape == (100, 10, 300, 2)
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(arr.astype(np.float32).astype(np.float64), arr)

    events = [json.loads(line) for line in
              (ROOT / "results" / "images_features_reconciled" / "metrics.jsonl").read_text().splitlines()]
    record = next(e["tables"] for e in events if e["event"] == "error_tables")
    assert record["MSD_Perfect"]["mse"] == 0.10239888891559892 and record["MSD_Frame"]["mse"] == 1.284755779813329
    raw = torch.as_tensor(arr, dtype=torch.float32).reshape(1000, 300, 2) / 100.0
    j_raw = jnp.asarray(raw.numpy())
    rows = {  # name: (the port's predictions, JAX's on the CPU, rtol to the record)
        "MSD_Perfect": (d_from_msd_tau1(raw) * MSD_MULT_FACTOR * 10.0, j_msd(j_raw) * MSD_MULT_FACTOR * 10.0, 2e-6),
        "MSD_Frame": (d_from_msd_tau1(average_trajectories_frames(raw, 10)) * MSD_MULT_FACTOR_AVG * 10.0,
                      j_msd(j_avg(j_raw, 10)) * MSD_MULT_FACTOR_AVG * 10.0, 1e-6),
    }
    score = lambda p: tval.error_table(np.asarray(p).reshape(100, 10), tval.IN_ORDER_IMFT_D_VALUES)["mse"]  # noqa: E731
    for name, (port, jax_cpu, rtol) in rows.items():
        np.testing.assert_allclose(score(port.numpy()), score(jax_cpu), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(score(port.numpy()), record[name]["mse"], rtol=rtol, err_msg=name)
        if rtol > 1e-6:  # the looser limit is JAX's own CPU scoring's distance to the record
            assert 1e-6 < abs(score(jax_cpu) / record[name]["mse"] - 1.0) < rtol, name
    for kw in (dict(seed=2027), dict(t_steps=250), dict(n_particles=1)):
        with pytest.raises(ValueError, match="only the published in-order suite"):
            tval.generate_in_order_imft(**kw)
