"""The port's fused multi-model cycle (``train/multi.py``) on the CPU: the
baseline's activation pairs group as the JAX package groups them, and one
cycle of several models equals a loop of per-model ``train_cycle`` calls
with the same generators, whatever the execution layout (separate units,
activation stacks, one merged unit). On the card the same cycle runs as
captured CUDA graphs (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.train import detect_activation_stacks as j_detect
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import (
    GeneralTransformer,
    MultiImageFeatureResNet,
    MultiImageResNet,
    init_model,
)
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.train import multi as tmulti
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These CPU runs are of tiny shapes, where torch's intra-op threads cost
    more than they give (the two fused-cycle files took 109 s with the
    default pool and 24 s with one thread), and several test workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _zoo(general, resnet, config):
    cfg = config(**SMALL)
    return {
        "lin": general(cfg.replace(activation="relu"), embedding="linear"),
        "lin_leaky": general(cfg.replace(activation="leaky_relu"), embedding="linear"),
        "cnn": general(cfg.replace(activation="relu"), embedding="cnn"),
        "gelu": general(cfg.replace(activation="gelu"), embedding="cnn"),
        "resnet": resnet(),
    }


def test_detect_activation_stacks():
    """The same groups as the JAX package's ``detect_activation_stacks`` on
    the same zoo (relu/leaky pairs only: a different embedding, another
    activation and a non-transformer stay out), with the same slopes; and
    on the baseline's seven arms its three pairs."""
    tmodels = _zoo(GeneralTransformer, MultiImageResNet, ModelConfig)
    jmodels = _zoo(JGeneral, JResNet, JModelConfig)
    got = [(names, slopes, base is tmodels[names[0]]) for names, base, slopes in tmulti.detect_activation_stacks(tmodels)]
    want = [(names, slopes, True) for names, _, slopes in j_detect(jmodels)]
    assert got == want == [(["lin", "lin_leaky"], (0.0, 0.01), True)]

    cfg = ModelConfig(use_pos_encoding=True)
    baseline = {}
    for act, suffix in (("relu", "_s"), ("leaky_relu", "_leaky")):
        for key, emb in (("linear_2layer", "linear"), ("cnn_2layer", "cnn"), ("deepcnn_2layer", "deep_resnet")):
            baseline[key + suffix] = GeneralTransformer(cfg.replace(activation=act), embedding=emb)
    baseline["resnet"] = MultiImageResNet()
    groups = [(names, slopes) for names, _, slopes in tmulti.detect_activation_stacks(baseline)]
    assert groups == [([k + "_s", k + "_leaky"], (0.0, 0.01)) for k in ("linear_2layer", "cnn_2layer", "deepcnn_2layer")]


def _fusion_zoo(general, config, with_leaky):
    """``im_tr`` with its early- and late-fusion twins (same embedding,
    activation, config and head) and, optionally, a leaky_relu twin."""
    cfg = config(**SMALL)
    fusion = dict(use_global_features=True, global_feature_dim=25)
    zoo = {
        "im_tr": general(cfg, embedding="deep_resnet"),
        "im_ft_early_tr": general(cfg, embedding="deep_resnet", fusion_type="early", **fusion),
        "im_ft_late_tr": general(cfg, embedding="deep_resnet", fusion_type="late", **fusion),
    }
    if with_leaky:
        zoo["im_tr_leaky"] = general(cfg.replace(activation="leaky_relu"), embedding="deep_resnet")
    return zoo


@pytest.mark.parametrize("with_leaky", [False, True])
def test_detect_activation_stacks_leaves_out_feature_models(with_leaky):
    """A transformer with global features never stacks with its image-only
    twin (the JAX package's rule, ``train/multi.py:68-80`` there): alone
    with its early and late twins ``im_tr`` forms no group, and beside a
    leaky_relu twin it pairs with that one only; the same groups as the JAX
    function."""
    got = [(names, slopes) for names, _, slopes in
           tmulti.detect_activation_stacks(_fusion_zoo(GeneralTransformer, ModelConfig, with_leaky))]
    want = [(names, slopes) for names, _, slopes in j_detect(_fusion_zoo(JGeneral, JModelConfig, with_leaky))]
    assert got == want == ([(["im_tr", "im_tr_leaky"], (0.0, 0.01))] if with_leaky else [])


def test_multi_cycle_with_features_matches_per_model_train_cycles():
    """``make_multi_cycle(with_features=True)``: every model takes the
    cycle's features (a transformer without fusion ignores them); two cycles
    (batch 2, then 4) equal per-model ``train_cycle`` calls with the features
    of ``generate_cycle_data(with_features=True)`` on the same generators,
    and the validation MSEs with ``val_features``, at 1e-6. ``stack_pairs``
    is ignored with features, as in JAX."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4)

    def zoo():
        z = _fusion_zoo(GeneralTransformer, ModelConfig, with_leaky=True)
        z["im_ft_resnet"] = MultiImageFeatureResNet(25, feature_size=16, hidden_size=32)
        return z

    models, ref_models = zoo(), zoo()
    init_states, cycle = tmulti.make_multi_cycle(models, cfg, BASELINE_OPTICS, with_features=True,
                                                 stack_pairs=True, device="cpu")
    g = torch.Generator().manual_seed(6)
    states = init_states(g)
    assert set(states) == set(models)
    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        impls[name] = tloop.make_train_impls(m, cfg, device="cpu", with_features=True)
        ref_states[name] = tloop.TrainState(m.train(), tloop.make_optimizer(m, cfg))
    rng = np.random.default_rng(1)
    val = torch.from_numpy((0.3 * rng.normal(size=(3, 4, 9, 9)) + 0.1).astype(np.float32))
    val_feats = torch.from_numpy(rng.normal(size=(3, 25)).astype(np.float32))
    target = torch.tensor(3.0)
    for c, batch in enumerate((2, 4)):
        gc = seeded_generator("cpu", 11, c)
        lr = cfg.lr_for_cycle(5 * c)
        states, losses, val_mse = cycle(states, gc, lr, batch, val, target, val_feats)
        videos, labels, feats = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS, with_features=True)
        for i, name in enumerate(ref_models):
            loss = impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), lr, batch,
                                           features=feats)
            mse = torch.mean((impls[name].evaluate(ref_states[name], val, val_feats) - target) ** 2)
            torch.testing.assert_close(losses[name], loss, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(val_mse[name], mse, rtol=1e-6, atol=1e-6)
    for name, m in models.items():
        ref = ref_models[name].state_dict()
        for key, value in m.state_dict().items():
            torch.testing.assert_close(value, ref[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


def _arms(**kw):
    cfg = ModelConfig(**SMALL, **kw)
    return {
        "lin_s": GeneralTransformer(cfg, embedding="linear"),
        "deep_s": GeneralTransformer(cfg, embedding="deep_resnet"),
        "lin_leaky": GeneralTransformer(cfg.replace(activation="leaky_relu"), embedding="linear"),
        "deep_leaky": GeneralTransformer(cfg.replace(activation="leaky_relu"), embedding="deep_resnet"),
        "resnet": MultiImageResNet(),
    }


@pytest.mark.parametrize("merge_scans,stack_pairs", [(False, False), (True, False), (False, True)])
def test_multi_cycle_matches_per_model_train_cycles(merge_scans, stack_pairs):
    """Two cycles (batch 2, then 4: two batch sizes) of five models through
    ``make_multi_cycle`` give the losses, validation MSEs and final
    parameters and BN statistics of per-model ``train_cycle`` calls on the
    same data with the same generators (model ``i`` from ``fold_in(g, i)``,
    its permutation from ``fold_in(fold_in(g_cycle, 1), i)``), at 1e-6.
    Stacked members step with their slope as a tensor, which equals their
    activation but for the gradient at exactly 0."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4)
    models, ref_models = _arms(), _arms()
    init_states, cycle = tmulti.make_multi_cycle(
        models, cfg, BASELINE_OPTICS, merge_scans=merge_scans, stack_pairs=stack_pairs, device="cpu"
    )
    g = torch.Generator().manual_seed(5)
    states = init_states(g)
    expected_keys = {"lin_s", "deep_s", "lin_leaky", "deep_leaky", "resnet"}
    if stack_pairs:
        expected_keys = {"resnet", "stack:lin_s+lin_leaky", "stack:deep_s+deep_leaky"}
        assert [s.model for s in states["stack:lin_s+lin_leaky"]] == [models["lin_s"], models["lin_leaky"]]
    assert set(states) == expected_keys

    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        impls[name] = tloop.make_train_impls(m, cfg, device="cpu")
        ref_states[name] = tloop.TrainState(m.train(), tloop.make_optimizer(m, cfg))
    rng = np.random.default_rng(0)
    val = torch.from_numpy((0.3 * rng.normal(size=(3, 4, 9, 9)) + 0.1).astype(np.float32))
    target = torch.tensor(3.0)

    for c, batch in enumerate((2, 4)):
        gc = seeded_generator("cpu", 9, c)
        lr = cfg.lr_for_cycle(5 * c)
        states, losses, val_mse = cycle(states, gc, lr, batch, val, target)
        videos, labels = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS)
        for i, name in enumerate(ref_models):
            loss = impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), lr, batch)
            mse = torch.mean((impls[name].evaluate(ref_states[name], val) - target) ** 2)
            torch.testing.assert_close(losses[name], loss, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(val_mse[name], mse, rtol=1e-6, atol=1e-6)
    for name, m in models.items():
        ref = ref_models[name].state_dict()
        for key, value in m.state_dict().items():
            torch.testing.assert_close(value, ref[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")
        assert cycle.engine.captures == 0  # CPU tensors run eagerly


def test_scanned_multi_cycle_stacks_each_cycles_results():
    """``make_scanned_multi_cycle`` runs K cycles per call and returns each
    model's losses and validation MSEs with a leading (K,) axis, equal to K
    calls of ``make_multi_cycle``'s cycle."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4)
    gens = [seeded_generator("cpu", 3, k) for k in range(2)]
    val = torch.zeros((2, 4, 9, 9))
    init_a, cycles = tmulti.make_scanned_multi_cycle(
        {"lin": GeneralTransformer(ModelConfig(**SMALL), embedding="linear")}, cfg, BASELINE_OPTICS, device="cpu"
    )
    states, losses, vals = cycles(init_a(torch.Generator().manual_seed(0)), gens, [1e-3, 5e-4], 4,
                                  val, torch.tensor(1.0))
    init_b, cycle = tmulti.make_multi_cycle(
        {"lin": GeneralTransformer(ModelConfig(**SMALL), embedding="linear")}, cfg, BASELINE_OPTICS, device="cpu"
    )
    states_b = init_b(torch.Generator().manual_seed(0))
    assert losses["lin"].shape == vals["lin"].shape == (2,)
    for k, (gk, lr) in enumerate(zip(gens, [1e-3, 5e-4])):
        states_b, loss, val_mse = cycle(states_b, gk, lr, 4, val, torch.tensor(1.0))
        torch.testing.assert_close(losses["lin"][k], loss["lin"], rtol=0, atol=0)
        torch.testing.assert_close(vals["lin"][k], val_mse["lin"], rtol=0, atol=0)


@pytest.mark.parametrize("merge_scans,stack_pairs", [(False, False), (True, False), (False, True)])
def test_multi_cycle_with_dropout_equals_per_model_train_cycles_bitwise(merge_scans, stack_pairs):
    """At dropout 0.1 the cycle of five models, in separate units, merged
    into one or with the activation pairs stacked, equals per-model
    ``train_cycle`` calls on the same generators bitwise over two cycles
    (losses, parameters, BN statistics): model ``i`` draws its permutation
    and its dropout key from ``fold_in(fold_in(g_cycle, 1), i)`` whatever the
    layout, as the JAX package's merged and stacked scans keep each model's
    streams (``tests/test_train.py``'s merged-scan and ``stack_pairs``
    cases). A stacked member steps with its slope as a tensor, whose
    forward is its activation's."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4)
    models, ref_models = _arms(dropout=0.1), _arms(dropout=0.1)
    init_states, cycle = tmulti.make_multi_cycle(
        models, cfg, BASELINE_OPTICS, merge_scans=merge_scans, stack_pairs=stack_pairs, device="cpu"
    )
    g = torch.Generator().manual_seed(5)
    states = init_states(g)
    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        impls[name] = tloop.make_train_impls(m, cfg, device="cpu")
        ref_states[name] = tloop.TrainState(m.train(), tloop.make_optimizer(m, cfg))
    for c, batch in enumerate((2, 4)):
        gc = seeded_generator("cpu", 9, c)
        lr = cfg.lr_for_cycle(5 * c)
        states, losses, _ = cycle(states, gc, lr, batch)
        videos, labels = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS)
        for i, name in enumerate(ref_models):
            loss = impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), lr, batch)
            assert torch.equal(losses[name], loss), (name, c)
    for name, m in models.items():
        ref = ref_models[name].state_dict()
        for key, value in m.state_dict().items():
            assert torch.equal(value, ref[key]), f"{name} {key}"
