"""The port's bf16 compute dtype (``TrainConfig.compute_dtype="bfloat16"``)
on the CPU against the JAX package: the plain bf16 deep-ResNet embedding
against the JAX kernel off its exact mode (``interpret=True,
exact=False``: bf16 products, f32 accumulation, as on the TPU), one bf16
training step of each of the baseline's seven models against JAX's, the
activation-slope stacks and a grid member against their single models at
bf16, and the refusals. Inputs come from numpy seeds; each test states its
tolerance. On the card the embedding runs K2-bf16/K3-bf16
(``chip_smoke.py`` phase bf16, ``tests/test_torch_cuda.py``)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import embeddings as jembeddings
from moleculardiffusion_mivit_tpu.models import layers as jlayers
from moleculardiffusion_mivit_tpu.models import resnet as jresnet
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.ops import fused_embedding as jfe
from moleculardiffusion_mivit_tpu.train import loop as jloop
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.experiments import baseline
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet, init_model
from moleculardiffusion_mivit_tpu_torch.models import embeddings as tembeddings
from moleculardiffusion_mivit_tpu_torch.models import layers as tlayers
from moleculardiffusion_mivit_tpu_torch.models import resnet as tresnet
from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as tfe
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.train import multi as tmulti
from moleculardiffusion_mivit_tpu_torch.train.grid import make_grid_impls
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
BF16_ULP = 2.0**-8  # bf16's relative spacing: 8 significand bits


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_values(a):
    """``a`` rounded to bf16, as f32 numpy (both sides get these values)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _embedding_case(seed, b=1, t=2, s=5, e=16):
    rng = np.random.default_rng(seed)
    shapes = {"initial": (3, 3, 1, 32), "rb1_conv1": (3, 3, 32, 64), "rb1_conv2": (3, 3, 64, 64),
              "rb1_skip": (1, 1, 32, 64), "rb2_conv1": (3, 3, 64, 128), "rb2_conv2": (3, 3, 128, 128),
              "rb2_skip": (1, 1, 64, 128)}
    args = (_bf16_values(0.3 * rng.normal(size=(b, t, s, s)) + 0.1),
            {k: _bf16_values(rng.normal(size=sh) / np.sqrt(np.prod(sh[:3]))) for k, sh in shapes.items()},
            {k: _bf16_values(1 + 0.1 * rng.normal(size=c)) for k, c in tfe.BN_LAYOUT},
            {k: _bf16_values(0.1 * rng.normal(size=c)) for k, c in tfe.BN_LAYOUT},
            _bf16_values(rng.normal(size=(128, e)) / np.sqrt(128)), _bf16_values(0.1 * rng.normal(size=e)))
    return args, _bf16_values(rng.normal(size=(b, t, e)))


def _jax_embedding(args, g, dtype, exact):
    cast = functools.partial(jax.tree.map, lambda v: jnp.asarray(v, dtype))
    embed = functools.partial(jfe.fused_deep_resnet_embed, interpret=True, exact=exact)
    (emb, stats), vjp = jax.vjp(embed, *cast(args))
    grads = vjp((cast(g), jax.tree.map(jnp.zeros_like, stats)))
    return emb, stats, jax.tree.leaves(grads)


def test_plain_bf16_embedding_matches_the_jax_kernel_off_exact_mode():
    """The plain bf16 version against JAX ``fused_deep_resnet_embed(...,
    interpret=True, exact=False)`` on the same bf16 inputs (50 activation
    rows): the embedding in bf16 to one bf16 ulp of each value; the
    seven BN (mean, var) pairs in f32 to 1e-5 of each vector's largest
    value; every gradient in bf16 to two ulps of its largest value. The two
    round at the same places, so only the f32 order of their sums differs;
    at this size no value crosses a bf16 rounding boundary because of it.
    (At a few hundred rows one does, and the products and BatchNorms after
    it carry the difference to several percent of a gradient.) The same
    comparison against the JAX kernel in f32 misses the gradient tolerance:
    the test tells bf16 arithmetic from f32."""
    args, g = _embedding_case(0)
    j_emb, j_stats, j_grads = _jax_embedding(args, g, jnp.bfloat16, exact=False)
    leaves = jax.tree.map(lambda v: torch.from_numpy(v).bfloat16().requires_grad_(), args)
    emb, stats = tfe.fused_deep_resnet_embed(*leaves)
    assert emb.dtype == torch.bfloat16 and j_emb.dtype == jnp.bfloat16
    want = np.asarray(j_emb, np.float32)
    assert (np.abs(emb.detach().float().numpy() - want) <= BF16_ULP * np.abs(want)).all()
    for name, _ in tfe.BN_LAYOUT:
        for i in (0, 1):
            ref = np.asarray(j_stats[name][i])
            assert stats[name][i].dtype == torch.float32
            assert np.abs(stats[name][i].numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name
    grads = torch.autograd.grad(emb, jax.tree.leaves(leaves), torch.from_numpy(g).bfloat16())
    _, _, f32_grads = _jax_embedding(args, g, jnp.float32, exact=True)
    f32_off = 0.0
    for got, ref, ref32 in zip(grads, j_grads, f32_grads):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref, ref32 = np.asarray(ref, np.float32), np.asarray(ref32, np.float32)
        scale = np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= 2 * BF16_ULP * scale
        f32_off = max(f32_off, np.abs(ref32 - ref).max() / scale)
    assert f32_off > 2 * BF16_ULP


def test_plain_bf16_embedding_under_vmap_equals_each_member():
    """The grid's route: the plain bf16 version vmapped over 3 members
    equals each member's own call, bitwise (the rounding functions carry a
    vmap rule)."""
    cases = [_embedding_case(s) for s in range(3)]
    stack = lambda get: jax.tree.map(lambda *v: torch.from_numpy(np.stack(v)).bfloat16(), *[get(c) for c in cases])  # noqa: E731
    emb, stats = torch.vmap(tfe.fused_deep_resnet_embed)(*stack(lambda c: c[0]))
    for m, (args, _) in enumerate(cases):
        one, one_stats = tfe.fused_deep_resnet_embed(*jax.tree.map(lambda v: torch.from_numpy(v).bfloat16(), args))
        assert torch.equal(emb[m], one)
        assert all(torch.equal(stats[k][i][m], one_stats[k][i]) for k in one_stats for i in (0, 1))


BASELINE_MODELS = ("linear_relu", "linear_leaky_relu", "cnn_relu", "cnn_leaky_relu", "deep_resnet_relu",
                   "deep_resnet_leaky_relu", "resnet")


def _baseline_models(kind):
    if kind == "resnet":
        return JResNet(single_prediction=True), MultiImageResNet(single_prediction=True)
    embedding, activation = kind.split("_", 1) if not kind.startswith("deep") else ("deep_resnet", kind[12:])
    cfg = dict(SMALL, activation=activation)
    return (JGeneral(JModelConfig(**cfg), embedding=embedding),
            GeneralTransformer(ModelConfig(**cfg), embedding=embedding))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _first_moments(mu_tree, tstate, tmodel):
    """Both sides' AdamW first moments (0.1·g after one step), as one vector
    each in the port's parameter order."""
    mu = torch_state_from_flax(_np(mu_tree))
    want = np.concatenate([mu[n].numpy().ravel() for n, _ in tmodel.named_parameters()])
    got = np.concatenate([tstate.optimizer.state[p]["exp_avg"].numpy().ravel() for _, p in tmodel.named_parameters()])
    return got, want


@pytest.mark.parametrize("kind", BASELINE_MODELS)
def test_one_bf16_train_step_matches_jax(kind, monkeypatch):
    """One bf16 step of each of the baseline's seven models, the port against
    JAX's ``make_train_impls(...).train_step`` at ``compute_dtype=
    "bfloat16"`` from the same converted weights, batch and LR. JAX's
    deep-ResNet arms take its fused kernel at ``exact=False`` (its default
    XLA route rounds every conv output to bf16; the kernel, as the port's
    K2/K3, keeps them f32).

    What is held exactly:
    - every master parameter, AdamW moment and BN running statistic is f32
      on both sides;
    - the step is a bf16 step: its AdamW first moment lies more than 1e-3
      relative L2 from the port's f32 step's on the same weights and batch
      (two f32 steps differ by ~1e-6);
    - the masters are the f32 AdamW update of the port's own f32 moments:
      ``p·(1 - lr·wd) - lr·m̂/(√v̂ + eps)`` in f64, to 2^-20 of each
      value (a bf16 master or update would be 2^-9 off).

    What is held to bf16's spread at this size (3 sequences): the loss's
    square root to 2^-6 of the largest label; the gradients, through AdamW's
    first moment (0.1·g), to 0.25 relative L2 over the model; the BN running
    statistics to 1e-2 of each vector's largest value. These limits catch a
    missing term, a wrong sign or a wrong BatchNorm, but they do not tell
    bf16 rounding from f32: over seven BatchNorms or two attention layers
    and a few rows, one bf16 rounding that lands differently moves a
    gradient as far as bf16 against f32 does, and JAX's CPU backend also
    sums bf16 values in bf16 (the TPU and the port accumulate in f32). That
    the port rounds where JAX rounds is held layer by layer, where it can be
    told apart from f32 (``test_bf16_layer_forward_rounds_as_jax``), and
    for the deep-ResNet embedding by
    ``test_plain_bf16_embedding_matches_the_jax_kernel_off_exact_mode``."""
    jmodel, tmodel = _baseline_models(kind)
    if kind.startswith("deep"):
        monkeypatch.setattr(jembeddings, "_EMBEDDING_BACKEND", "fused")
        monkeypatch.setattr(jfe, "fused_deep_resnet_embed",
                            functools.partial(jfe.fused_deep_resnet_embed, interpret=True, exact=False))
    rng = np.random.default_rng(0)
    n, lr = 6, 1e-3
    videos = (0.3 * rng.normal(size=(n, 6, 9, 9)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(n, 1)).astype(np.float32)
    idx = np.array([4, 1, 2])
    jcfg = JTrainConfig(lr=lr, compute_dtype="bfloat16")
    params, bstats = jax.jit(lambda k, x: j_init(jmodel, k, x))(jax.random.key(0), jnp.asarray(videos[:1]))
    impls = jloop.make_train_impls(jmodel, jcfg)
    tx = jloop.make_optimizer(jcfg)
    state = jloop.TrainState(params, bstats, tx.init(params))
    state = state.replace(opt_state=jloop._set_lr(state.opt_state, jnp.float32(lr)))
    new, jl = jax.jit(impls.train_step)(state, jnp.asarray(videos), jnp.asarray(labels), None, jnp.asarray(idx),
                                        jax.random.key(1))
    adam = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda v: hasattr(v, "mu")) if hasattr(s, "mu"))
    for leaf in jax.tree.leaves((new.params, new.batch_stats, adam.mu, adam.nu)):
        assert leaf.dtype == jnp.float32

    start = torch_state_from_flax(_np(params), _np(bstats))

    def port_step(dtype):
        model = copy.deepcopy(tmodel)
        model.load_state_dict(start)
        cfg = TrainConfig(lr=lr, compute_dtype=dtype)
        st = tloop.TrainState(model.train(), tloop.make_optimizer(model, cfg))
        loss = tloop.make_train_impls(model, cfg, device="cpu").train_step(
            st, torch.from_numpy(videos), torch.from_numpy(labels), torch.from_numpy(idx))
        return model, st, loss

    tmodel, tstate, tl = port_step("bfloat16")
    f32_model, f32_state, _ = port_step("float32")
    assert tl.dtype == torch.float32
    for p in tmodel.parameters():
        st = tstate.optimizer.state[p]
        assert p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert all(b.dtype in (torch.float32, torch.int64) for b in tmodel.buffers())

    m_bf16 = np.concatenate([tstate.optimizer.state[p]["exp_avg"].numpy().ravel() for p in tmodel.parameters()])
    m_f32 = np.concatenate([f32_state.optimizer.state[p]["exp_avg"].numpy().ravel() for p in f32_model.parameters()])
    assert np.linalg.norm(m_bf16 - m_f32) / np.linalg.norm(m_f32) > 1e-3

    wd = TrainConfig().weight_decay
    for name, p in tmodel.named_parameters():
        st = tstate.optimizer.state[p]
        m, v = st["exp_avg"].double() / 0.1, st["exp_avg_sq"].double() / 1e-3  # bias-corrected, step 1
        want = start[name].double() * (1 - lr * wd) - lr * m / (v.sqrt() + 1e-8)
        assert float((p.detach().double() - want).abs().max()) <= 2.0**-20 * float(want.abs().max()), name

    assert abs(float(tl) ** 0.5 - float(jl) ** 0.5) <= 2.0**-6 * labels.max()
    got, want = _first_moments(adam.mu, tstate, tmodel)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 0.25
    want_state = torch_state_from_flax(_np(new.params), _np(new.batch_stats))
    for name, value in tmodel.state_dict().items():
        if "running" in name:
            w = want_state[name].numpy()
            assert np.abs(value.numpy() - w).max() <= 1e-2 * np.abs(w).max() + 1e-6, name


def _layer_cases():
    """(name, flax module, port module, input shape, kwargs, train, NCHW,
    limit): the port's layers and their flax counterparts."""
    e, h, hid = 16, 2, 32
    seq, img, chw = (3, 7, e), (2, 5, 9, 9), (4, 9, 9, 8)
    return {
        "attention": (jlayers.MultiHeadAttention(e, h), tlayers.MultiHeadAttention(e, h), seq, {}, False, False, 2.5e-3),
        "feed_forward_relu": (jlayers.FeedForward(e, hid, "relu"), tlayers.FeedForward(e, hid, "relu"), seq, {},
                              False, False, 1e-3),
        "feed_forward_leaky": (jlayers.FeedForward(e, hid, "leaky_relu"), tlayers.FeedForward(e, hid, "leaky_relu"),
                               seq, {}, False, False, 1.5e-3),
        "feed_forward_slope": (jlayers.FeedForward(e, hid), tlayers.FeedForward(e, hid), seq,
                               {"act_slope": 0.01}, False, False, 1.5e-3),
        "encoder_layer": (jlayers.TransformerEncoderLayerWithSkip(e, h, hid),
                          tlayers.TransformerEncoderLayerWithSkip(e, h, hid), seq, {}, False, False, 3e-3),
        "transformer_pos_leaky": (jlayers.Transformer(e, h, hid, 2, use_pos_encoding=True, activation="leaky_relu"),
                                  tlayers.Transformer(e, h, hid, 2, use_pos_encoding=True, activation="leaky_relu"),
                                  seq, {}, False, False, 5e-3),
        "mlp_head": (jlayers.MLPHead(32, 1), tlayers.MLPHead(e, 32, 1), seq, {}, False, False, 1e-3),
        "linear_embedding": (jembeddings.LinearProjectionEmbedding(9, e), tembeddings.LinearProjectionEmbedding(9, e),
                             img, {}, False, False, 1e-3),
        "cnn_embedding": (jembeddings.CNNEmbedding(9, e), tembeddings.CNNEmbedding(9, e), img, {"train": True}, True,
                          False, 1e-3),
        "resnet_block_bn": (jresnet.BasicBlock(16, 2), tresnet.BasicBlock(8, 16, 2), chw, {"train": True}, True, True,
                            1e-3),
    }


@pytest.mark.parametrize("case", list(_layer_cases()))
def test_bf16_layer_forward_rounds_as_jax(case):
    """Each layer of the baseline's models at bf16 (parameters and input
    cast to bf16 as the train step casts them; BatchNorm in training mode),
    the port against its flax counterpart on the same converted weights and
    input: the output within the layer's limit of JAX's bf16 output in
    relative L2, where JAX's f32 output lies beyond it. So the port rounds
    at JAX's places (LayerNorm, softmax, the FF slope, the positional
    embedding, BatchNorm's f32 statistics), not merely in bf16 somewhere.
    The limits sit between the two readings, port against JAX bf16 / JAX
    f32 against JAX bf16, at this test's inputs: attention 8.6e-4 /
    6.5e-3; feed-forward 0 (relu), 2.2e-4 (leaky, slope) / ≥ 3.5e-3;
    encoder layer 8.6e-4 / 4.2e-3; two layers with positional embedding
    3.3e-3 / 7.7e-3; head, embeddings and the BatchNorm ResNet block 0 /
    ≥ 2.0e-3. (JAX's CPU backend sums bf16 values in bf16, where the port
    sums them in f32: that is what the attention and the layers after
    it differ by.)"""
    jmod, tmod, shape, kwargs, train, nchw, limit = _layer_cases()[case]
    x = _bf16_values(np.random.default_rng(100).normal(size=shape).astype(np.float32))
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), **kwargs)
    params, bstats = variables["params"], variables.get("batch_stats", {})

    def jax_out(dtype):
        cast = lambda v: v.astype(dtype) if v.dtype == jnp.float32 else v  # noqa: E731
        vs = {"params": jax.tree.map(cast, params), **({"batch_stats": bstats} if bstats else {})}
        out = jmod.apply(vs, cast(jnp.asarray(x)), **kwargs, **({"mutable": ["batch_stats"]} if bstats else {}))
        return np.asarray(out[0] if bstats else out, np.float32)

    want, f32 = jax_out(jnp.bfloat16), jax_out(jnp.float32)
    tmod.load_state_dict(torch_state_from_flax(_np(params), _np(bstats)), strict=False)
    tmod.train(train)
    xt = torch.from_numpy(x).bfloat16()
    p = {n: v.detach().bfloat16() for n, v in tmod.named_parameters()}
    with torch.no_grad():
        out = torch.func.functional_call(tmod, p, (xt.permute(0, 3, 1, 2) if nchw else xt,),
                                         {k: v for k, v in kwargs.items() if k != "train"})
    assert out.dtype == torch.bfloat16
    got = (out.permute(0, 2, 3, 1) if nchw else out).float().numpy()
    rel = lambda a: float(np.linalg.norm(a - want) / np.linalg.norm(want))  # noqa: E731
    assert rel(got) <= limit
    assert rel(f32) > limit


def _arms():
    cfg = ModelConfig(**SMALL)
    return {"lin_s": GeneralTransformer(cfg.replace(activation="relu"), embedding="linear"),
            "deep_s": GeneralTransformer(cfg.replace(activation="relu"), embedding="deep_resnet"),
            "lin_leaky": GeneralTransformer(cfg.replace(activation="leaky_relu"), embedding="linear"),
            "deep_leaky": GeneralTransformer(cfg.replace(activation="leaky_relu"), embedding="deep_resnet"),
            "resnet": MultiImageResNet(single_prediction=True)}


def test_bf16_stacked_pairs_match_per_model_steps():
    """One bf16 cycle (batch 2) of the baseline's arms through
    ``make_multi_cycle(stack_pairs=True)``, where the relu/leaky pairs step
    as stacks with their FF slope as a tensor, against per-model
    ``train_cycle`` calls on the same data and generators: losses,
    validation MSEs and every parameter and buffer at 1e-6. A stacked
    member's leaky ReLU is ``where(h >= 0, h, slope · h)`` in bf16, which
    rounds as ``leaky_relu`` does, and the cast happens in each member's
    own step, so the stack changes no rounding."""
    cfg = TrainConfig(sequences_per_d=2, n_frames=4, compute_dtype="bfloat16")
    models, ref_models = _arms(), _arms()
    init_states, cycle = tmulti.make_multi_cycle(models, cfg, BASELINE_OPTICS, stack_pairs=True, device="cpu")
    g = torch.Generator().manual_seed(5)
    states = init_states(g)
    assert {"stack:lin_s+lin_leaky", "stack:deep_s+deep_leaky"} <= set(states)
    impls, ref_states = {}, {}
    for i, (name, m) in enumerate(ref_models.items()):
        init_model(m, fold_in(g, i, device="cpu"))
        impls[name] = tloop.make_train_impls(m, cfg, device="cpu")
        ref_states[name] = tloop.TrainState(m.train(), tloop.make_optimizer(m, cfg))
    val = torch.from_numpy((0.3 * np.random.default_rng(0).normal(size=(3, 4, 9, 9)) + 0.1).astype(np.float32))
    target = torch.tensor(3.0)
    gc = seeded_generator("cpu", 9, 0)
    states, losses, val_mse = cycle(states, gc, 1e-3, 2, val, target)
    videos, labels = tloop.generate_cycle_data(fold_in(gc, 0), cfg, BASELINE_OPTICS)
    for i, name in enumerate(ref_models):
        loss = impls[name].train_cycle(ref_states[name], videos, labels, fold_in(fold_in(gc, 1), i), 1e-3, 2)
        mse = torch.mean((impls[name].evaluate(ref_states[name], val) - target) ** 2)
        torch.testing.assert_close(losses[name], loss, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(val_mse[name], mse, rtol=1e-6, atol=1e-6)
    for name, m in models.items():
        ref = ref_models[name].state_dict()
        for key, value in m.state_dict().items():
            assert value.dtype == ref[key].dtype and value.dtype in (torch.float32, torch.int64)
            torch.testing.assert_close(value, ref[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


@pytest.mark.parametrize("kind", ["deep_resnet", "resnet"])
def test_bf16_grid_member_matches_its_single_model(kind):
    """One bf16 grid step of 3 members (the deep-ResNet transformer, whose
    embedding runs vmapped, and ``MultiImageResNet``, whose convolutions
    become grouped ones) against each member stepped alone from the same
    weights on the same minibatch: losses to 1e-2 relative and the updated
    f32 masters, AdamW moments and BN statistics to 2e-2 of each tensor's
    largest value (a grouped convolution and a batched matrix product sum in
    another order than a single one, and bf16 rounds those sums where they
    land on a boundary; the f32 grid is held to float64 in
    ``tests/test_torch_grid.py``)."""
    model = (GeneralTransformer(ModelConfig(**dict(SMALL, num_layers=1)), embedding="deep_resnet")
             if kind == "deep_resnet" else MultiImageResNet(single_prediction=True))
    cfg = TrainConfig(lr=1e-3, compute_dtype="bfloat16")
    impls = make_grid_impls(model, cfg, device="cpu")
    state = impls.init_grid([torch.Generator().manual_seed(10 + m) for m in range(3)])
    params, buffers = state.model.stacked()
    alone = []
    for m in range(3):
        mod = copy.deepcopy(state.model.template)
        mod.load_state_dict({k: v[m].detach().clone() for k, v in {**params, **buffers}.items()})
        alone.append(tloop.TrainState(mod.train(), tloop.make_optimizer(mod, cfg)))
    rng = np.random.default_rng(3)
    videos = torch.from_numpy((0.3 * rng.normal(size=(3, 6, 4, 9, 9)) + 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.uniform(0.1, 0.7, size=(3, 6, 1)).astype(np.float32))
    idx = torch.tensor([[0, 2], [5, 1], [3, 4]])
    losses = impls.train_step(state, videos, labels, idx)
    step = tloop.make_train_impls(model, cfg, device="cpu").train_step
    params, buffers = state.model.stacked()
    for m in range(3):
        loss = step(alone[m], videos[m], labels[m], idx[m])
        np.testing.assert_allclose(float(losses[m]), float(loss), rtol=1e-2)
        mine = dict(alone[m].model.named_parameters())
        for name, p in params.items():
            assert p.dtype == torch.float32
            ref = mine[name].detach()
            assert (p[m].detach() - ref).abs().max() <= 2e-2 * ref.abs().max() + 1e-12, name
            moments = state.optimizer.state[p]["exp_avg"][m], alone[m].optimizer.state[mine[name]]["exp_avg"]
            assert (moments[0] - moments[1]).abs().max() <= 2e-2 * moments[1].abs().max() + 1e-12, name
        for name, bv in buffers.items():
            ref = dict(alone[m].model.named_buffers())[name]
            assert bv.dtype == ref.dtype
            if bv.is_floating_point():
                assert (bv[m] - ref).abs().max() <= 2e-2 * ref.abs().max() + 1e-6, name


def test_experiment_carries_the_compute_dtype_to_every_learned_arm():
    """``Experiment.set_compute_dtype`` reaches the experiment's config and
    every arm's own; the built arms' steps run at bf16 (the deep-ResNet arm
    through the plain bf16 embedding here) with f32 masters."""
    exp = baseline.build(seed=0, sequences_per_d=2, device="cpu").set_compute_dtype("bfloat16")
    assert exp.train_cfg.compute_dtype == "bfloat16"
    assert all(arm.train_cfg is None or arm.train_cfg.compute_dtype == "bfloat16" for arm in exp.arms.values())
    exp.train_cfg = exp.train_cfg.replace(n_frames=4)
    exp.build()
    exp.run(1)
    for name, losses in exp.train_loss.items():
        assert np.isfinite(float(losses[0])), name
        assert all(p.dtype == torch.float32 for p in exp.states[name].model.parameters())


@pytest.mark.parametrize("entry", ["make_train_impls", "make_grid_impls"])
def test_unknown_compute_dtype_raises(entry):
    """A compute dtype other than float32 and bfloat16 raises ``ValueError``,
    as the JAX package's ``_cast_for_compute`` does; so does an embedding
    input in another dtype."""
    model = GeneralTransformer(ModelConfig(**SMALL), embedding="deep_resnet")
    make = tloop.make_train_impls if entry == "make_train_impls" else make_grid_impls
    with pytest.raises(ValueError, match="compute_dtype"):
        make(model, TrainConfig(compute_dtype="float16"), device="cpu")
    args, _ = _embedding_case(0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfe.fused_deep_resnet_embed(*jax.tree.map(lambda v: torch.from_numpy(v).half(), args))


def test_bf16_outcome_scorer_reads_runs_and_holds_them_to_the_rule(tmp_path, capsys):
    """``images_features_bf16_outcome.py`` on runs whose error tables are
    JAX's own four f32 seeds (difference 0): every arm holds and it exits
    0; with one learned arm's scores moved by 0.1 in every run, that arm
    misses (0.1 is above both 0.03 and two pooled standard errors here) and
    it exits 1."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "images_features_bf16_outcome.py"
    spec = importlib.util.spec_from_file_location("images_features_bf16_outcome", path)
    outcome = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(outcome)
    runs = []
    for s, src in enumerate(outcome.JAX_F32):
        run = tmp_path / f"seed{s}"
        run.mkdir()
        run.joinpath("metrics.jsonl").write_text((src / "metrics.jsonl").read_text())
        runs.append(run)
    assert outcome.main([str(r) for r in runs]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["rule_holds"] and verdict["runs"] == 4 and set(verdict["held"]) == {*outcome.LEARNED, *outcome.MSD}
    for run in runs:
        events = [json.loads(line) for line in run.joinpath("metrics.jsonl").read_text().splitlines()]
        for e in events:
            if e["event"] == "error_tables":
                e["tables"]["im_tr"]["mse"] += 0.1
        run.joinpath("metrics.jsonl").write_text("\n".join(json.dumps(e) for e in events) + "\n")
    assert outcome.main([str(r) for r in runs]) == 1
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["held"]["im_tr"] is False and sum(verdict["held"].values()) == len(verdict["held"]) - 1


def _root_module(name):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bf16_gradient_limit_lies_between_the_recorded_readings():
    """The bf16 kernels' gradient limit (``chip_smoke.BF16_GRAD_L2_TOL``,
    5e-2 relative L2, the card test's too) against the committed readings of
    ``bf16_kernel_spread.py``: every shape and seed of both two sound bf16
    implementations (the kernels against the plain version on the card;
    JAX's kernel at exact=False against it on the CPU) lies below it, every
    reading of the plain version in f32 against it in bf16 above it, and
    each by at least a factor 1.5."""
    import json
    from pathlib import Path

    limit = _root_module("chip_smoke").BF16_GRAD_L2_TOL
    assert limit == 5e-2
    spread = Path(__file__).resolve().parents[1] / "results" / "bf16_kernel_spread"
    for mode in ("card", "cpu"):
        readings = json.loads((spread / f"{mode}.json").read_text())["readings"]
        assert {(r["B"], r["T"], r["S"], r["E"]) for r in readings} == set(_root_module("bf16_kernel_spread").SHAPES)
        assert max(r["sound_worst"] for r in readings) * 1.5 <= limit
        assert min(r["f32_worst"] for r in readings) >= 1.5 * limit


def test_bf16_kernel_spread_cpu_witness_runs_at_a_small_shape(monkeypatch, tmp_path):
    """``bf16_kernel_spread.py --cpu`` end to end at one small shape and seed:
    JAX's kernel at exact=False and the plain bf16 version agree within the
    limit, and the plain version in f32 lies beyond it."""
    import json

    spread = _root_module("bf16_kernel_spread")
    monkeypatch.setattr(spread, "SHAPES", ((1, 2, 9, 16),))
    assert spread.main(["--cpu", "--seeds", "1", "--out", str(tmp_path)]) == 0
    (row,) = json.loads((tmp_path / "cpu.json").read_text())["readings"]
    assert row["sound_worst"] <= 5e-2 < row["f32_worst"]
    assert row["embedding"] <= 1e-2
