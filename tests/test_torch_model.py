"""The port's GeneralTransformer(deep_resnet) against the flax model: the
same weights through ``torch_state_from_flax`` give the same forward in
train and eval mode, the parameter counts are equal, and ``init_model``
draws from the flax initialisers' distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import activation_by_name as j_act
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.models import param_count as j_count
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig as TModelConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer as TGeneral
from moleculardiffusion_mivit_tpu_torch.models import activation_by_name as t_act
from moleculardiffusion_mivit_tpu_torch.models import init_model as t_init
from moleculardiffusion_mivit_tpu_torch.models import param_count as t_count
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(cfg_kw, x, seed=0):
    jmodel = JGeneral(JModelConfig(**cfg_kw), embedding="deep_resnet")
    params, bstats = jax.jit(lambda k, xx: j_init(jmodel, k, xx))(jax.random.key(seed), jnp.asarray(x))
    tmodel = TGeneral(TModelConfig(**cfg_kw), embedding="deep_resnet")
    tmodel.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)))
    return jmodel, params, bstats, tmodel


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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGeneral(TModelConfig(), embedding="linear")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGeneral(TModelConfig(), use_global_features=True)
