"""The port's models against the flax models: GeneralTransformer with the
deep_resnet, linear and cnn embeddings and MultiImageResNet (the seven arms
of the baseline experiment), and the feature models of the images-features
experiment (GeneralTransformer with early and late fusion,
MultiImageFeatureResNet, FeatureMLP). The same weights through
``torch_state_from_flax`` give the same forward in train and eval mode and
the same BatchNorm running statistics, the parameter counts are equal, and
``init_model`` draws from the flax initialisers' distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.experiments.images_features import FeatureMLP as JFeatureMLP
from moleculardiffusion_mivit_tpu.models import MultiImageFeatureResNet as JFeatureResNet
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import activation_by_name as j_act
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.models import param_count as j_count
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig as TModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments.images_features import FeatureMLP as TFeatureMLP
from moleculardiffusion_mivit_tpu_torch.models import MultiImageFeatureResNet as TFeatureResNet
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer as TGeneral
from moleculardiffusion_mivit_tpu_torch.models import MultiImageResNet as TResNet
from moleculardiffusion_mivit_tpu_torch.models import activation_by_name as t_act
from moleculardiffusion_mivit_tpu_torch.models import init_model as t_init
from moleculardiffusion_mivit_tpu_torch.models import param_count as t_count
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# The baseline experiment's arms beside deepcnn: (embedding or "resnet", model keywords)
NEW_ARMS = {
    "linear_relu": ("linear", dict(activation="relu")),
    "linear_leaky": ("linear", dict(activation="leaky_relu")),
    "cnn_relu": ("cnn", dict(activation="relu")),
    "cnn_leaky": ("cnn", dict(activation="leaky_relu")),
    "resnet_single": ("resnet", dict(single_prediction=True)),
    "resnet_per_frame": ("resnet", dict(single_prediction=False)),
}


def _models(kind, cfg_kw):
    """The flax model and the port's, unconverted: ``kind`` is an embedding
    of GeneralTransformer (``cfg_kw`` its ModelConfig) or ``"resnet"``
    (``cfg_kw`` MultiImageResNet's keywords)."""
    if kind == "resnet":
        return JResNet(**cfg_kw), TResNet(**cfg_kw)
    return JGeneral(JModelConfig(**cfg_kw), embedding=kind), TGeneral(TModelConfig(**cfg_kw), embedding=kind)


def _pair(cfg_kw, x, seed=0, kind="deep_resnet"):
    jmodel, tmodel = _models(kind, cfg_kw)
    params, bstats = jax.jit(lambda k, xx: j_init(jmodel, k, xx))(jax.random.key(seed), jnp.asarray(x))
    tmodel.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    return jmodel, params, bstats, tmodel


def _flax_train_then_eval(jmodel, params, bstats, x):
    """Train-mode output, the batch_stats it leaves, and the eval-mode output
    with those statistics, in full f32."""
    variables = {"params": params, **({"batch_stats": bstats} if bstats else {})}
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jax.jit(
            lambda v, xx: jmodel.apply(v, xx, train=True, mutable=["batch_stats"] if bstats else [])
        )(variables, jnp.asarray(x))
        new_stats = mut.get("batch_stats", bstats)
        variables = {"params": params, **({"batch_stats": new_stats} if bstats else {})}
        jeval = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(variables, jnp.asarray(x))
    return jtrain, new_stats, jeval


@pytest.mark.parametrize("cfg_kw", [SMALL, dict(SMALL, use_regression_token=False, single_prediction=False)])
def test_forward_matches_flax_train_and_eval(cfg_kw):
    rng = np.random.default_rng(0)
    x = (0.3 * rng.normal(size=(2, 6, 9, 9)) + 0.1).astype(np.float32)
    jmodel, params, bstats, tmodel = _pair(cfg_kw, x)
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": bstats}, jnp.asarray(x)
        )
        jeval = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(
            {"params": params, "batch_stats": mut["batch_stats"]}, jnp.asarray(x)
        )
    ttrain = tmodel.train()(torch.from_numpy(x))
    with torch.no_grad():
        teval = tmodel.eval()(torch.from_numpy(x))
    assert ttrain.shape == jtrain.shape
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arm", sorted(NEW_ARMS))
def test_baseline_arms_forward_and_bn_statistics_match_flax(arm):
    """Linear and cnn embeddings (relu and leaky_relu) and MultiImageResNet
    (both ``single_prediction`` settings), 2 layers, embed 16, 4 frames of
    9×9: train- and eval-mode outputs at rtol/atol 1e-5, and the BatchNorm
    running statistics after the train-mode forward equal flax's
    ``batch_stats`` (momentum 0.9 on the old value, biased batch variance)."""
    kind, kw = NEW_ARMS[arm]
    cfg_kw = kw if kind == "resnet" else dict(SMALL, **kw)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.normal(size=(2, 4, 9, 9)) + 0.1).astype(np.float32)
    jmodel, params, bstats, tmodel = _pair(cfg_kw, x, kind=kind)
    assert bool(bstats) == (kind == "resnet")
    jtrain, new_stats, jeval = _flax_train_then_eval(jmodel, params, bstats, x)
    ttrain = tmodel.train()(torch.from_numpy(x))
    with torch.no_grad():
        teval = tmodel.eval()(torch.from_numpy(x))
    assert ttrain.shape == jtrain.shape == ((2, 4, 1) if arm == "resnet_per_frame" else (2, 1))
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-5, atol=1e-5)
    got = tmodel.state_dict()
    for name, want in torch_state_from_flax({}, _np(new_stats)).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        start = torch.zeros_like(want) if name.endswith("running_mean") else torch.ones_like(want)
        assert not torch.equal(want, start), f"{name} was not moved by the train-mode forward"


@pytest.mark.parametrize("kind", ["linear", "cnn", "resnet"])
def test_full_width_new_arms_param_count_and_state_keys_match_flax(kind):
    """At the baseline experiment's full width: equal parameter counts, and
    the converted state dict fills every parameter and buffer (the 2-D Dense
    kernel under ``proj``, the conv bias, the ResNet's nested names)."""
    cfg_kw = dict(single_prediction=True) if kind == "resnet" else dict(use_pos_encoding=True)
    _, params, bstats, tmodel = _pair(cfg_kw, np.zeros((1, 30, 9, 9), np.float32), kind=kind)
    assert t_count(tmodel) == j_count(params)
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tmodel.state_dict())
    for name, v in tmodel.state_dict().items():
        assert state[name].shape == v.shape, name


@pytest.fixture(scope="module")
def full_width():
    """The flagship configuration: embed 64, 4 heads, FFN 128, 6 layers,
    positional encoding."""
    return _pair(dict(use_pos_encoding=True), np.zeros((1, 30, 9, 9), np.float32))


def test_full_width_param_count_and_state_keys_match_flax(full_width):
    """Equal parameter counts, and the converted state dict fills every
    parameter and buffer of the port's model."""
    _, params, bstats, tmodel = full_width
    assert t_count(tmodel) == j_count(params)
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tmodel.state_dict())


def test_converter_layouts():
    """Dense (in, out) → Linear (out, in); conv HWIO → OIHW; scale → weight;
    BN mean/var → running statistics; tokens as they are."""
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(3, 5)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    tok = rng.normal(size=(1, 1, 5)).astype(np.float32)
    out = torch_state_from_flax(
        {"a": {"kernel": dense, "bias": np.ones(5, np.float32)}, "c": {"kernel": conv},
         "n": {"scale": np.ones(4, np.float32)}, "reg_token": tok},
        {"n": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}},
    )
    np.testing.assert_array_equal(out["a.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(out["c.weight"].numpy()[3, 1, 2, 0], conv[2, 0, 1, 3])
    assert set(out) == {"a.weight", "a.bias", "c.weight", "n.weight", "reg_token",
                        "n.running_mean", "n.running_var"}


def test_init_model_matches_flax_initialiser_distributions(full_width):
    """Per parameter: the port's init draws from the flax initialiser's
    distribution (same std within 10%, same mean within 0.1 std); BN and
    LayerNorm start as identities."""
    _, params, bstats, _ = full_width
    ref = torch_state_from_flax(_np(params), _np(bstats))
    tmodel = t_init(TGeneral(TModelConfig(use_pos_encoding=True)), torch.Generator().manual_seed(0))
    for name, v in tmodel.state_dict().items():
        want = ref[name]
        if (want == want.flatten()[0]).all():
            assert torch.equal(v, want), name
        elif v.numel() >= 1000:
            np.testing.assert_allclose(float(v.std()), float(want.std()), rtol=0.1, err_msg=name)
            assert abs(float(v.mean()) - float(want.mean())) < 0.1 * float(want.std()), name
    again = t_init(TGeneral(TModelConfig(use_pos_encoding=True)), torch.Generator().manual_seed(0))
    for (name, a), b in zip(tmodel.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "gelu", "tanh"])
def test_activations_match_flax(name):
    v = np.linspace(-3, 3, 101).astype(np.float32)
    np.testing.assert_allclose(
        t_act(name)(torch.from_numpy(v)).numpy(), np.asarray(j_act(name)(jnp.asarray(v))), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_init_model_new_arms_match_flax_initialisers(kind):
    """Constant leaves (biases, the conv bias among them, BN scales and
    running statistics) start at flax's values; drawn kernels of 1000 entries
    or more have the flax initialiser's spread."""
    cfg_kw = dict(single_prediction=True) if kind == "resnet" else dict(use_pos_encoding=True)
    _, params, bstats, _ = _pair(cfg_kw, np.zeros((1, 30, 9, 9), np.float32), kind=kind)
    ref = torch_state_from_flax(_np(params), _np(bstats))
    tmodel = t_init(_models(kind, cfg_kw)[1], torch.Generator().manual_seed(0))
    constant = 0
    for name, v in tmodel.state_dict().items():
        want = ref[name]
        if (want == want.flatten()[0]).all():
            assert torch.equal(v, want), name
            constant += 1
        elif v.numel() >= 1000:
            np.testing.assert_allclose(float(v.std()), float(want.std()), rtol=0.1, err_msg=name)
    assert constant > 10
    if kind == "cnn":
        assert torch.equal(tmodel.embedding.conv.bias, torch.zeros(64))


def test_batchnorm_train_mode_uses_biased_batch_statistics():
    """Train mode: normalise with the batch mean and the biased variance over
    (N, H, W), move the running statistics by 0.1 of the way; eval mode:
    apply the running statistics and leave them alone."""
    from moleculardiffusion_mivit_tpu_torch.models import BatchNorm

    rng = np.random.default_rng(2)
    x = torch.from_numpy((2.0 * rng.normal(size=(3, 4, 5, 5)) + 1.0).astype(np.float32))
    bn = BatchNorm(4).train()
    y = bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    want = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    kept = bn.running_mean.clone()
    bn.eval()(x)
    assert torch.equal(bn.running_mean, kept)
    assert not bn.running_mean.requires_grad and y.requires_grad


def test_unported_options_raise():
    """Global-feature fusion is ported: what raises now is a fusion model
    called without its features (``ValueError``, as in flax), one built
    without the features' width or with an unknown fusion, and an unknown
    embedding; a model without fusion ignores features it is given, as
    flax's does."""
    model = TGeneral(TModelConfig(**SMALL), use_global_features=True, global_feature_dim=25)
    with pytest.raises(ValueError, match="Global features required"):
        model(torch.zeros(1, 2, 9, 9))
    with pytest.raises(ValueError, match="global_feature_dim"):
        TGeneral(TModelConfig(), use_global_features=True)
    with pytest.raises(ValueError, match="fusion_type"):
        TGeneral(TModelConfig(), use_global_features=True, fusion_type="middle", global_feature_dim=25)
    with pytest.raises(ValueError, match="unknown embedding"):
        TGeneral(TModelConfig(), embedding="fourier")
    plain = TGeneral(TModelConfig(**SMALL)).eval()
    x = torch.zeros(1, 2, 9, 9)
    with torch.no_grad():
        assert torch.equal(plain(x), plain(x, features=torch.ones(1, 25)))


@pytest.mark.parametrize("slope", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("kind", ["linear", "deep_resnet"])
def test_act_slope_matches_flax(kind, slope):
    """``GeneralTransformer(x, act_slope=s)`` on weights converted from flax
    equals flax's ``apply(..., act_slope=s)`` in train mode at 1e-5, given
    the slope as a float or as a 0-d tensor. At s = 0 the relu model without
    a slope gives the same output (a relu is a leaky ReLU of slope 0)."""
    rng = np.random.default_rng(4)
    x = (0.3 * rng.normal(size=(2, 4, 9, 9)) + 0.1).astype(np.float32)
    jmodel, params, bstats, tmodel = _pair(SMALL, x, kind=kind)
    variables = {"params": params, **({"batch_stats": bstats} if bstats else {})}
    mutable = ["batch_stats"] if bstats else []
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda v, xx, s: jmodel.apply(v, xx, train=True, act_slope=s, mutable=mutable))(
            variables, jnp.asarray(x), jnp.float32(slope)
        )
    tmodel.train()
    outs = [tmodel(torch.from_numpy(x), act_slope=slope),
            tmodel(torch.from_numpy(x), act_slope=torch.tensor(slope))]
    if slope == 0.0:
        outs.append(tmodel(torch.from_numpy(x)))
    for out in outs:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# The images-features experiment's feature models: (kind, keywords)
FEATURE_MODELS = {
    "early_fusion": ("general", dict(fusion_type="early")),
    "late_fusion": ("general", dict(fusion_type="late")),
    "feature_resnet": ("feature_resnet", {}),
    "feature_mlp": ("feature_mlp", {}),
}


def _feature_pair(kind, kw, cfg_kw, x, f, seed=0):
    """The flax feature model initialised from ``seed`` and the port's with
    the converted weights."""
    if kind == "general":
        common = dict(embedding="deep_resnet", use_global_features=True, global_feature_dim=f.shape[1], **kw)
        jm, tm = JGeneral(JModelConfig(**cfg_kw), **common), TGeneral(TModelConfig(**cfg_kw), **common)
        args = (x, f)
    elif kind == "feature_resnet":
        width = dict(feature_size=cfg_kw["embed_dim"], hidden_size=cfg_kw["hidden_dim"])
        jm, tm = JFeatureResNet(external_dim=f.shape[1], **width), TFeatureResNet(f.shape[1], **width)
        args = (x, f)
    else:
        jm, tm = JFeatureMLP(), TFeatureMLP(f.shape[1])
        args = (f,)
    params, bstats = jax.jit(lambda k, *a: j_init(jm, k, *a))(jax.random.key(seed), *map(jnp.asarray, args))
    tm.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    return jm, tm, params, bstats, args


@pytest.mark.parametrize("name", sorted(FEATURE_MODELS))
def test_feature_models_forward_match_flax(name):
    """GeneralTransformer with early and late fusion of 25 features
    (deep_resnet embedding, 2 layers, embed 16), MultiImageFeatureResNet and
    FeatureMLP, on flax's weights through ``torch_state_from_flax``: train-
    and eval-mode outputs at rtol/atol 1e-5, the BatchNorm running
    statistics after the train-mode forward equal flax's, equal parameter
    counts and every parameter filled by the converter."""
    kind, kw = FEATURE_MODELS[name]
    rng = np.random.default_rng(5)
    x = (0.3 * rng.normal(size=(3, 4, 9, 9)) + 0.1).astype(np.float32)
    f = rng.normal(size=(3, 25)).astype(np.float32)
    jm, tm, params, bstats, args = _feature_pair(kind, kw, SMALL, x, f)
    variables = {"params": params, **({"batch_stats": bstats} if bstats else {})}
    mutable = ["batch_stats"] if bstats else []
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=mutable))(
            variables, *map(jnp.asarray, args))
        new_stats = mut.get("batch_stats", bstats)
        jeval = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
            {"params": params, **({"batch_stats": new_stats} if bstats else {})}, *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    ttrain = tm.train()(*targs)
    with torch.no_grad():
        teval = tm.eval()(*targs)
    assert ttrain.shape == jtrain.shape == (3, 1)
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-5, atol=1e-5)
    got = tm.state_dict()
    for key, want in torch_state_from_flax({}, _np(new_stats)).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    assert t_count(tm) == j_count(params)
    assert set(torch_state_from_flax(_np(params), _np(bstats))) == set(got)
    if kind == "general":
        assert tm.mlp_head.fc1.in_features == (32 if kw["fusion_type"] == "late" else 16)


@pytest.mark.parametrize("name", sorted(FEATURE_MODELS))
def test_full_width_feature_models_param_count_and_state_keys_match_flax(name):
    """At the images-features experiment's full width (embed 64, 4 heads,
    FFN 128, 6 layers, no positional encoding; the ResNet's trunk width 64
    and hidden 128): equal parameter counts, and the converted state dict
    fills every parameter and buffer (``feature_projector.fc1/fc2``,
    ``mlp_fc1/mlp_fc2``, ``head.fc1/fc2``) with the right shapes."""
    kind, kw = FEATURE_MODELS[name]
    cfg_kw = dict(use_pos_encoding=False, embed_dim=64, hidden_dim=128)
    x, f = np.zeros((1, 30, 9, 9), np.float32), np.zeros((1, 25), np.float32)
    if kind == "general":
        cfg_kw = dict(use_pos_encoding=False)
    _, tm, params, bstats, _ = _feature_pair(kind, kw, cfg_kw, x, f)
    assert t_count(tm) == j_count(params)
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tm.state_dict())
    for key, v in tm.state_dict().items():
        assert state[key].shape == v.shape, key
