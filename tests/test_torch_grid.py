"""The port's model grids (``train/grid.py``) against the JAX package on the
CPU: one grid ``train_step`` against JAX ``make_grid_impls(...).train_step``
from the same stacked weights and the same ``(M, B)`` index, for the
deep-ResNet transformer and ``MultiImageResNet``; grid training over several
steps against each member trained alone; the grid's evaluation, chunked and
whole, against JAX's; the member-axis embedding against ``jax.vmap`` of the
JAX ``fused_deep_resnet_embed``; and the embedding's vmap rule, which hands
the member axis to K2/K3 once (stand-in kernels built from the plain version,
since the CPU has none). Inputs are made from a seed with numpy; tolerances
are stated per test."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.ops import fused_embedding as jfe
from moleculardiffusion_mivit_tpu.train.grid import make_grid_impls as j_make_grid_impls
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.features import N_FEATURES
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.models import embeddings as tembeddings
from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as tfe
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.train.grid import GridModule, make_drop_keys, make_grid_impls, make_perms
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in

SMALL = dict(use_pos_encoding=False, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=1)
M = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(kind, **cfg):
    """``kind``: ``resnet``, ``deep_resnet`` (the transformer) or ``early``
    (the early-fusion MiViT of the ensemble: the transformer with 25
    features added to its regression token)."""
    if kind == "resnet":
        return JResNet(single_prediction=True), MultiImageResNet(single_prediction=True)
    small = {**SMALL, **cfg}
    fusion = {}
    if kind == "early":
        fusion = dict(use_global_features=True, fusion_type="early", global_feature_dim=N_FEATURES)
    return (JGeneral(JModelConfig(**small), embedding="deep_resnet", **fusion),
            GeneralTransformer(ModelConfig(**small), **fusion))


def _data(seed, n=6, frames=4):
    rng = np.random.default_rng(seed)
    videos = (0.3 * rng.normal(size=(M, n, frames, 9, 9)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(M, n, 1)).astype(np.float32)
    return videos, labels


def _features(seed, n=6):
    """Member-major ``(M, n, 25)`` features, as the ensemble feeds them."""
    return np.random.default_rng(seed).normal(size=(M, n, N_FEATURES)).astype(np.float32)


def _jax_grid(jmodel, jcfg, videos, features=None):
    impls = j_make_grid_impls(jmodel, jcfg, with_features=features is not None)
    example = (jnp.asarray(videos[0, :1]),) + (() if features is None else (jnp.asarray(features[0, :1]),))
    grid = jax.jit(impls.init_grid, static_argnums=(1,))(jax.random.key(0), M, *example)
    return impls, grid


def _member_state(tree_params, tree_stats, m):
    return torch_state_from_flax(_np(jax.tree.map(lambda v: v[m], tree_params)),
                                 _np(jax.tree.map(lambda v: v[m], tree_stats)))


def _member(grid, m):
    """A copy of the grid's template holding member ``m``'s parameters and
    buffers."""
    mod = copy.deepcopy(grid.template)
    params, buffers = grid.stacked()
    mod.load_state_dict({n: v[m].detach().clone() for n, v in {**params, **buffers}.items()})
    return mod.train(grid.training)


def _torch_grid(tmodel, jgrid, cfg):
    """The port's grid holding JAX's stacked weights, carried across member
    by member (``utils.convert``) and stacked again."""
    members = []
    for m in range(M):
        mod = copy.deepcopy(tmodel)
        mod.load_state_dict(_member_state(jgrid.params, jgrid.batch_stats, m))
        members.append(mod)
    grid = GridModule(tmodel, members).train()
    return tloop.TrainState(grid, tloop.make_optimizer(grid, cfg))


@pytest.mark.parametrize("kind,loss,pos", [
    pytest.param("deep_resnet", "mse", False, id="deep_resnet"),
    pytest.param("resnet", "mse", False, id="resnet"),
    pytest.param("deep_resnet", "l1", True, id="deep_resnet-l1-pos_embedding"),
    pytest.param("resnet", "l1", False, id="resnet-l1"),
    pytest.param("early", "mse", False, id="deep_resnet-early_fusion-features"),
])
def test_grid_train_step_matches_jax(kind, loss, pos):
    """From the same stacked weights, minibatch index ``(M, B)`` and LR, one
    grid step with ``loss`` (MSE, or the denoising experiment's L1; the
    transformer with ``pos``, its learned positional embedding; the
    ensemble's early-fusion MiViT with member-major features ``(M, N, 25)``,
    JAX's ``make_grid_impls(..., with_features=True)``) gives every
    member the JAX grid step's loss (1e-5 relative),
    parameters and BN running statistics (1e-5 relative plus 1e-7; where
    Adam's first step lr·g/(|g| + eps) meets a gradient within 1000·eps of
    zero, float noise in g moves the step by up to 2·lr, so parameters there
    are held to that bound, as ``tests/test_torch_train.py`` holds one
    model's step)."""
    jmodel, tmodel = _models(kind, use_pos_encoding=pos)
    lr = 1e-3
    videos, labels = _data(1)
    feats = _features(1) if kind == "early" else None
    idx = np.array([[4, 1], [0, 5], [2, 2]])
    jcfg = JTrainConfig(lr=lr, loss=loss)
    impls, jgrid = _jax_grid(jmodel, jcfg, videos, feats)
    state = _torch_grid(tmodel, jgrid, TrainConfig(lr=lr, loss=loss))
    with jax.default_matmul_precision("highest"):
        new, jl = jax.jit(impls.train_step)(
            jgrid, jnp.asarray(videos), jnp.asarray(labels), None if feats is None else jnp.asarray(feats),
            jnp.asarray(idx), jax.random.split(jax.random.key(1), M), jnp.float32(lr),
        )
    step = make_grid_impls(tmodel, TrainConfig(lr=lr, loss=loss), device="cpu", with_features=feats is not None)
    tl = step.train_step(
        state, torch.from_numpy(videos), torch.from_numpy(labels), torch.from_numpy(idx),
        features=None if feats is None else torch.from_numpy(feats),
    )
    assert tl.shape == (M,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    mu = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda v: hasattr(v, "mu")) if hasattr(s, "mu")).mu
    for m in range(M):
        want = _member_state(new.params, new.batch_stats, m)
        grad = torch_state_from_flax(_np(jax.tree.map(lambda v: v[m], mu)))
        got = _member(state.model, m).state_dict()
        for name, w in want.items():
            diff = np.abs(got[name].numpy() - w.numpy())
            off = diff > 1e-5 * np.abs(w.numpy()) + 1e-7
            if off.any():
                g = np.abs(grad[name].numpy()) / 0.1  # mu = (1 - b1)·g after one step
                assert (g[off] < 1e3 * 1e-8).all() and (diff[off] <= 2 * lr).all(), f"member {m} {name}"


@pytest.mark.parametrize("kind", ["deep_resnet", "resnet"])
def test_grid_training_equals_members_trained_alone(kind):
    """Two epochs of the grid (``train_cycle``: 3 steps at batch 2, each
    member on its own slice and permutation, at the experiments' LR of
    1e-4) against each member trained alone with ``train.loop``'s step from
    the same weights, on the same slice in the same order: losses at 1e-5
    relative; parameters and BN running statistics at 1e-5 relative plus
    1e-6, the JAX package's tolerance for its merged against its per-model
    grid steps. The models run in float64: the grid runs the members'
    convolutions and matrix products batched, so its sums associate
    differently, and in float32 that noise already flipped a max-pool choice
    or a ReLU in one element of 36,864 after six steps (a gradient change of
    percents there); the comparison is of the update sequence, not of
    rounding."""
    _, tmodel = _models(kind)
    tmodel = tmodel.double()
    cfg = TrainConfig(lr=1e-4)
    impls = make_grid_impls(tmodel, cfg, device="cpu")
    state = impls.init_grid([torch.Generator().manual_seed(10 + m) for m in range(M)])
    alone = [_member(state.model, m) for m in range(M)]
    opts = [tloop.make_optimizer(mod, cfg) for mod in alone]
    step = tloop.make_train_impls(tmodel, cfg, device="cpu").train_step
    videos, labels = (torch.from_numpy(v).double() for v in _data(2))
    for c in range(2):
        g = torch.Generator().manual_seed(c)
        got = impls.train_cycle(state, videos, labels, g, 1e-4, 2)
        perms = make_perms(g, M, videos.shape[1], 2, "cpu")
        for m in range(M):
            losses = [step(tloop.TrainState(alone[m], opts[m]), videos[m], labels[m], perms[m, s])
                      for s in range(perms.shape[1])]
            np.testing.assert_allclose(float(got[m]), float(torch.stack(losses).mean()), rtol=1e-5)
    for m in range(M):
        want = alone[m].state_dict()
        for key, v in _member(state.model, m).state_dict().items():
            assert v.dtype == torch.float64
            np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"member {m} {key}")


def test_make_perms_gives_each_member_its_own_stream():
    """Member ``i``'s permutation is ``train.loop.epoch_permutation`` drawn
    from ``fold_in(generator, i)``: reproducible, different across members,
    remainder dropped."""
    g = torch.Generator().manual_seed(3)
    perms = make_perms(g, 4, 11, 2, "cpu")
    assert perms.shape == (4, 5, 2)
    assert torch.equal(perms, make_perms(g, 4, 11, 2, "cpu"))
    assert len({tuple(p.flatten().tolist()) for p in perms}) == 4
    assert all(len(set(p.flatten().tolist())) == 10 for p in perms)


@pytest.mark.parametrize("kind", ["deep_resnet", "resnet"])
def test_grid_evaluate_matches_jax_chunked_and_whole(kind):
    """Eval-mode predictions of every member (running statistics moved by
    one JAX step first, so they are not the initial ones) equal JAX's grid
    ``evaluate`` at 1e-5 relative plus 1e-6, whole and in chunks of 2
    sequences (the experiment evaluates grids ``eval_chunk`` sequences at a
    time)."""
    jmodel, tmodel = _models(kind)
    videos, labels = _data(3, n=5)
    jcfg = JTrainConfig()
    impls, jgrid = _jax_grid(jmodel, jcfg, videos)
    with jax.default_matmul_precision("highest"):
        jgrid, _ = jax.jit(impls.train_step)(
            jgrid, jnp.asarray(videos), jnp.asarray(labels), None, jnp.asarray(np.array([[0, 1]] * M)),
            jax.random.split(jax.random.key(1), M), jnp.float32(1e-3),
        )
        want = np.asarray(jax.jit(impls.evaluate)(jgrid, jnp.asarray(videos)))
    state = _torch_grid(tmodel, jgrid, TrainConfig())
    evaluate = make_grid_impls(tmodel, TrainConfig(), device="cpu").evaluate
    whole = evaluate(state, torch.from_numpy(videos)).numpy()
    chunked = torch.cat([evaluate(state, torch.from_numpy(videos[:, s:s + 2])) for s in range(0, 5, 2)], dim=1)
    assert whole.shape == want.shape == (M, 5, 1)
    for got in (whole, chunked.numpy()):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert state.model.training


def _embedding_inputs(rng, m, n, s):
    def leaf(shape, scale, offset=0.0):
        return (offset + scale * rng.normal(size=(m,) + shape)).astype(np.float32)

    shapes = {"initial": (3, 3, 1, 32), "rb1_conv1": (3, 3, 32, 64), "rb1_conv2": (3, 3, 64, 64),
              "rb1_skip": (1, 1, 32, 64), "rb2_conv1": (3, 3, 64, 128), "rb2_conv2": (3, 3, 128, 128),
              "rb2_skip": (1, 1, 64, 128)}
    kernels = {k: leaf(v, 1.0 / np.sqrt(np.prod(v[:3]))) for k, v in shapes.items()}
    scales = {k: leaf((c,), 0.1, 1.0) for k, c in tfe.BN_LAYOUT}
    biases = {k: leaf((c,), 0.1) for k, c in tfe.BN_LAYOUT}
    return leaf((n, 3, s, s), 0.3, 0.1), kernels, scales, biases, leaf((128, 16), 128 ** -0.5), leaf((16,), 0.1)


def test_member_axis_embedding_matches_jax_vmap():
    """The plain member-axis embedding (``torch.vmap`` of the port's
    ``fused_deep_resnet_embed``, the plain version on the CPU) equals
    ``jax.vmap`` of the JAX ``fused_deep_resnet_embed`` on 3 members of 2
    sequences × 3 frames: embeddings at 1e-4 relative plus 1e-5, and each
    member's BN statistics over its own rows at 1e-4 plus 1e-6 (the
    statistics of member 1 differ from member 0's, so none is pooled)."""
    args = _embedding_inputs(np.random.default_rng(4), M, 2, 9)
    with jax.default_matmul_precision("highest"):
        want_emb, want_stats = jax.vmap(jfe.fused_deep_resnet_embed)(*jax.tree.map(jnp.asarray, args))
    got_emb, got_stats = torch.vmap(tfe.fused_deep_resnet_embed)(*jax.tree.map(torch.from_numpy, args))
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), rtol=1e-4, atol=1e-5)
    for name, _ in tfe.BN_LAYOUT:
        for q in (0, 1):
            got, want = got_stats[name][q].numpy(), np.asarray(want_stats[name][q])
            assert got.shape == want.shape and got.shape[0] == M
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
        assert not np.allclose(got_stats[name][0][0].numpy(), got_stats[name][0][1].numpy())


def _stand_in_kernels(calls):
    """K2/K3 stand-ins with the CUDA entries' signatures and layouts (one
    member or a leading member axis), computed by the plain version; each
    call is recorded with its input's shape."""
    c0, c1, c2 = tfe.C0, tfe.C1, tfe.C2

    def one(x, weights, sc, bi, wfc, bfc):
        shapes = ((3, 3, 1, c0), (3, 3, c0, c1), (1, 1, c0, c1), (3, 3, c1, c1), (3, 3, c1, c2),
                  (1, 1, c1, c2), (3, 3, c2, c2))
        names = ("initial", "rb1_conv1", "rb1_skip", "rb1_conv2", "rb2_conv1", "rb2_skip", "rb2_conv2")
        kernels = {k: w.reshape(shp) for k, w, shp in zip(names, weights, shapes)}
        emb, st = tfe.deep_resnet_embed_reference(
            x[:, None], kernels, {k: sc[i, :c] for i, (k, c) in enumerate(tfe.BN_LAYOUT)},
            {k: bi[i, :c] for i, (k, c) in enumerate(tfe.BN_LAYOUT)}, wfc, bfc)
        stats = torch.zeros(7, 3, c2)
        for i, (k, c) in enumerate(tfe.BN_LAYOUT):
            stats[i, 0, :c], stats[i, 1, :c] = st[k]
        return emb[:, 0], stats

    def stacked(x, weights, *rest):
        if x.ndim == 3:
            return one(x, weights, *rest)
        outs = [one(x[i], [w[i] for w in weights], *(r[i] for r in rest)) for i in range(x.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def fwd(x, weights, sc, bi, wfc, bfc):
        calls.append(("fwd", tuple(x.shape)))
        emb, stats = stacked(x, weights, sc, bi, wfc, bfc)
        lead, n, r = x.shape[:-3], x.shape[-3], x.shape[-3] * x.shape[-1] ** 2
        saved = {name: torch.zeros(lead + (r, c)) for name, c in tfe.SAVED}
        saved.update(pooled=torch.zeros(lead + (n, c2)), stats=stats)
        return emb, stats, saved

    def bwd(x, weights, sc, bi, wfc, bfc, saved, g):
        calls.append(("bwd", tuple(x.shape)))
        ins = [t.detach().clone().requires_grad_() for t in (x, *weights, sc, bi, wfc, bfc)]
        with torch.enable_grad():
            emb, _ = stacked(ins[0], ins[1:8], *ins[8:])
            grads = torch.autograd.grad(emb, ins, g)
        return grads[0], tuple(grads[1:8]), *grads[8:]

    return fwd, bwd


def test_vmap_rule_hands_the_member_axis_to_the_kernels_once(monkeypatch):
    """Under ``torch.vmap`` (a grid step of deep-ResNet transformers) the
    embedding's ``autograd.Function`` calls K2 once and K3 once with the
    members stacked ``(M, N, S, S)``, never once per member; each member's
    output, gradients and BN running statistics then equal the member run
    alone through the same stand-in kernels (1e-5 relative plus 1e-6)."""
    calls = []
    fwd, bwd = _stand_in_kernels(calls)
    monkeypatch.setattr(tfe, "deep_resnet_embed_fwd", fwd)
    monkeypatch.setattr(tfe, "deep_resnet_embed_bwd", bwd)
    monkeypatch.setattr(tembeddings, "fused_deep_resnet_embed", tfe._kernel_embed)  # the kernels' route on the CPU
    cfg = ModelConfig(**dict(SMALL, embed_dim=8))
    members = [tloop.make_train_impls(GeneralTransformer(cfg), TrainConfig(), "cpu").init_state(
        torch.Generator().manual_seed(m)).model for m in range(M)]
    alone = copy.deepcopy(members)
    grid = GridModule(GeneralTransformer(cfg), members).train()
    x = torch.from_numpy(_data(5, n=2, frames=3)[0])
    out = grid.vmapped(lambda run, v: run(v), x)
    out.pow(2).sum().backward()
    assert calls == [("fwd", (M, 6, 9, 9)), ("bwd", (M, 6, 9, 9))]
    params, buffers = grid.stacked()
    for m, mod in enumerate(alone):
        o = mod.train()(x[m])
        o.pow(2).sum().backward()
        np.testing.assert_allclose(out[m].detach().numpy(), o.detach().numpy(), rtol=1e-5, atol=1e-6)
        for name, p in mod.named_parameters():
            np.testing.assert_allclose(params[name].grad[m].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        for name, b in mod.named_buffers():
            np.testing.assert_allclose(buffers[name][m].numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_with_dropout_equals_members_trained_alone_given_their_keys(dtype):
    """At dropout 0.1, two epochs of a grid of linear-embedding transformers
    (6 steps) against each member trained alone by ``train.loop``'s
    ``train_cycle`` given ``fold_in(g, m)``, the generator of its
    permutation and of its dropout key (``make_drop_keys``). Losses at 1e-5
    relative plus 1e-7, the JAX package's tolerance for a grid's cycle
    against its merged steps (``tests/test_experiments.py``, also at dropout
    0.1). Parameters: in float64 at the same tolerance; in f32 at 6·lr (one
    Adam step moves a parameter by at most ~lr), since the grid's batched
    sums round differently and Adam turns the rounding noise of a gradient
    that is analytically 0 (the attention key bias's: softmax is
    shift-invariant) into steps of ±lr."""
    dt = getattr(torch, dtype)
    lr = 1e-4
    cfg = TrainConfig(lr=lr)
    tmodel = GeneralTransformer(ModelConfig(**{**SMALL, "num_layers": 2}, dropout=0.1), embedding="linear").to(dt)
    impls = make_grid_impls(tmodel, cfg, device="cpu")
    state = impls.init_grid([torch.Generator().manual_seed(20 + m) for m in range(M)])
    state.model.to(dt)
    state = tloop.TrainState(state.model, tloop.make_optimizer(state.model, cfg))
    alone = [_member(state.model, m) for m in range(M)]
    singles = [tloop.make_train_impls(mod, cfg, device="cpu") for mod in alone]
    states = [tloop.TrainState(mod, tloop.make_optimizer(mod, cfg)) for mod in alone]
    videos, labels = (torch.from_numpy(v).to(dt) for v in _data(3))
    assert len(set(make_drop_keys(torch.Generator().manual_seed(0), M, "cpu").tolist())) == M
    for c in range(2):
        g = torch.Generator().manual_seed(c)
        got = impls.train_cycle(state, videos, labels, g, lr, 2)
        for m in range(M):
            want = singles[m].train_cycle(states[m], videos[m], labels[m], fold_in(g, m), lr, 2)
            np.testing.assert_allclose(float(got[m]), float(want), rtol=1e-5, atol=1e-7)
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == "float64" else dict(rtol=0, atol=6 * lr)
    for m in range(M):
        want = alone[m].state_dict()
        for key, v in _member(state.model, m).state_dict().items():
            assert v.dtype == dt
            np.testing.assert_allclose(v.numpy(), want[key].numpy(), **tol, err_msg=f"member {m} {key}")
