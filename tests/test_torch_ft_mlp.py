"""F8's witness: one full training cycle of the ``images_features``
experiment's ``ft_mlp`` arm (``FeatureMLP`` on the 25 features, the arm's
``TrainConfig`` from ``images_features.build``), the port's trainer step by
step against the JAX package's ``make_train_impls(FeatureMLP(), ...)``, from
the same flax weights on the same numpy features and labels, in JAX's
minibatch order; then the same witness with a mutated trainer, which must
miss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.experiments import images_features as j_images_features
from moleculardiffusion_mivit_tpu.train import loop as jloop
from moleculardiffusion_mivit_tpu_torch.experiments import images_features
from moleculardiffusion_mivit_tpu_torch.features import compute_features_for_multiple_trajectories
from moleculardiffusion_mivit_tpu_torch.sim import average_trajectories_frames, single_state
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

SEQUENCES, BATCH = 256, 16
CONFIG_FIELDS = ("lr", "weight_decay", "d_max_normalization", "loss", "compute_dtype", "n_frames", "training_ds",
                 "traj_div_factor", "n_pos_per_frame")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_state(tree):
    """A flax ``FeatureMLP`` tree as the port's ``state_dict``, through
    ``utils.convert.torch_state_from_flax`` (which works in float32); a
    float64 tree keeps its float64 values under the same names and
    layout."""
    tree = jax.tree.map(np.asarray, tree)
    state = torch_state_from_flax(tree)
    if tree["head"]["fc1"]["kernel"].dtype == np.float64:
        exact = {f"head.{layer}.{leaf}": torch.tensor(v.T if leaf == "weight" else v)
                 for layer in ("fc1", "fc2")
                 for leaf, v in (("weight", tree["head"][layer]["kernel"]), ("bias", tree["head"][layer]["bias"]))}
        assert set(exact) == set(state) and all(torch.equal(exact[n].float(), state[n]) for n in state)
        state = exact
    return state


def _features_and_labels(cfg):
    """The arm's inputs as ``ft_slice`` gives them: the 25 features of the
    frame-averaged trajectories of the five training classes (the port's
    simulator, seeded), and the labels ``D / d_max``; the first 256 rows."""
    g = seeded_generator("cpu", 7)
    t = cfg.n_frames * cfg.n_pos_per_frame
    feats, labels = [], []
    for i, ds in enumerate(cfg.training_ds):
        trajs, lab = single_state(fold_in(g, i, 0), SEQUENCES // len(cfg.training_ds) + 1, t, Ds=tuple(ds))
        avg = average_trajectories_frames(trajs / cfg.traj_div_factor, cfg.n_pos_per_frame)
        feats.append(compute_features_for_multiple_trajectories(avg, dt=1.0))
        labels.append(lab[:, :1, 1] / cfg.d_max_normalization)
    feats, labels = torch.cat(feats)[:SEQUENCES], torch.cat(labels)[:SEQUENCES]
    return feats.numpy().astype(np.float32), labels.numpy().astype(np.float32)


def _jax_mlp_cycle(dtype):
    """JAX's side of F8's witness in ``dtype`` (float32, or float64 with
    the flax weights cast after init and AdamW's state made in float64):
    the arm's config, the features and labels, JAX's minibatches, the flax
    weights it starts from, its per-step losses and its state after the
    cycle, and how far JAX moves from itself when the features move by one
    ulp of ``dtype`` up or down."""
    jcfg = j_images_features.build(seed=0, sequences_per_d=2, val_d_values=()).train_cfg
    cfg = images_features.build(seed=0, sequences_per_d=2, val_d_values=(), device="cpu").train_cfg
    assert all(getattr(cfg, f) == getattr(jcfg, f) for f in CONFIG_FIELDS)
    feats, labels = _features_and_labels(cfg)
    assert np.isfinite(feats).all() and feats.shape == (SEQUENCES, 25)
    feats, labels = feats.astype(dtype), labels.astype(dtype)
    steps = SEQUENCES // BATCH

    with jax.enable_x64(dtype == np.float64):
        impls = jloop.make_train_impls(j_images_features.FeatureMLP(), jcfg)
        state0 = impls.init_state(jax.random.key(3), jnp.asarray(feats[:1]))
        params = jax.tree.map(lambda v: jnp.asarray(v, dtype), state0.params)
        state0 = state0.replace(params=params, opt_state=jloop.make_optimizer(jcfg).init(params))
        k_perm, k_drop = jax.random.split(jax.random.key(5))  # train_cycle's split of its key
        perm = np.asarray(jax.random.permutation(k_perm, SEQUENCES)[: steps * BATCH].reshape(steps, BATCH))
        step = jax.jit(impls.train_step)

        def jax_cycle(x):
            """JAX's cycle on features ``x``: per-step losses and the state
            after it as a port ``state_dict`` and AdamW moments."""
            state = state0.replace(opt_state=jloop._set_lr(state0.opt_state, jnp.asarray(jcfg.lr, dtype)))
            losses = []
            for idx in perm:
                state, loss = step(state, jnp.asarray(x), jnp.asarray(labels), None, jnp.asarray(idx), k_drop)
                losses.append(float(loss))
            adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                        if hasattr(s, "mu"))
            return np.array(losses), {"state": _port_state(state.params), "exp_avg": _port_state(adam.mu),
                                      "exp_avg_sq": _port_state(adam.nu)}

        jax_losses, want = jax_cycle(feats)
        spread_losses, spread = np.zeros(steps), {k: {name: 0.0 for name in v} for k, v in want.items()}
        for direction in (np.inf, -np.inf):
            ulp_losses, moved = jax_cycle(np.nextafter(feats, dtype(direction)))
            spread_losses = np.maximum(spread_losses, np.maximum.accumulate(np.abs(ulp_losses - jax_losses)))
            for kind, ref in want.items():
                for name, w in ref.items():
                    spread[kind][name] = max(spread[kind][name], float((moved[kind][name] - w).abs().max()))
        start = _port_state(state0.params)
    return dict(cfg=cfg, feats=feats, labels=labels, perm=perm, start=start, losses=jax_losses, want=want,
                spread_losses=spread_losses, spread=spread)


@pytest.fixture(scope="module")
def jax_mlp_cycle():
    return _jax_mlp_cycle(np.float32)


@pytest.fixture(scope="module")
def jax_mlp_cycle_f64():
    return _jax_mlp_cycle(np.float64)


def _port_cycle(ref, betas=(0.9, 0.999), weight_decay=None):
    """The port's side of F8's witness: the arm's trainer
    (``make_train_impls``, as ``Experiment.build`` makes it) through JAX's
    minibatches from JAX's starting weights, AdamW with ``betas`` and
    ``weight_decay`` (the config's by default). Returns the per-step losses
    and the state after the cycle."""
    cfg = ref["cfg"]
    model = images_features.FeatureMLP().to(torch.from_numpy(ref["feats"]).dtype)
    timpls = tloop.make_train_impls(model, cfg, "cpu")
    model.load_state_dict(ref["start"])
    tstate = tloop.TrainState(model.train(), tloop.make_optimizer(model, cfg))
    for group in tstate.optimizer.param_groups:
        group["betas"] = betas
        group["weight_decay"] = cfg.weight_decay if weight_decay is None else weight_decay
    tloop._set_lr(tstate.optimizer, cfg.lr)
    x, y = torch.from_numpy(ref["feats"]), torch.from_numpy(ref["labels"])
    losses = np.array([float(timpls.train_step(tstate, x, y, torch.from_numpy(idx.copy()))) for idx in ref["perm"]])
    got = {"state": model.state_dict(),
           **{k: {name: tstate.optimizer.state[p][k] for name, p in model.named_parameters()}
              for k in ("exp_avg", "exp_avg_sq")}}
    return losses, got


# (loss, tensor) bounds of the witness: F7's in float32; in float64 both
# sides agree to ~1e-15 relative, so its twin holds them to 1e-10
BOUNDS = {np.float32: (1e-5, 1e-4), np.float64: (1e-10, 1e-10)}


def _misses(ref, losses, got):
    """The steps whose loss misses and the tensors that miss: each loss at
    ``BOUNDS[dtype][0]`` relative, each tensor at ``BOUNDS[dtype][1]`` of
    its largest entry, each widened by 3 × JAX's own distance from itself
    under a one-ulp move of the features."""
    loss_rtol, rtol = BOUNDS[ref["feats"].dtype.type]
    jax_losses = ref["losses"]
    loss_misses = np.flatnonzero(np.abs(losses - jax_losses) > loss_rtol * jax_losses + 3 * ref["spread_losses"])
    off = {}
    for kind, want in ref["want"].items():
        for name, w in want.items():
            diff = float((got[kind][name] - w).abs().max())
            if diff > rtol * float(w.abs().max()) + 3 * ref["spread"][kind][name]:
                off[f"{kind}:{name}"] = (diff, ref["spread"][kind][name])
    return loss_misses.tolist(), off


def test_ft_mlp_trainer_cycle_matches_jax_step_by_step(jax_mlp_cycle):
    """One full cycle of the ``ft_mlp`` arm's trainer (batch 16 over 256
    sequences of features: 16 steps) against JAX's ``make_train_impls``
    from the same flax weights (converted by ``utils.convert``) on the same
    numpy features and labels, JAX's ``train_step`` one jitted call a step
    in ``train_cycle``'s order (``permutation(split(key)[0], n)``).

    Held, as F7's witness: each step's loss at 1e-5 relative, and after the
    cycle every parameter and AdamW moment at 1e-4 of its tensor's largest
    entry, each widened by 3 × JAX's own distance from itself when the
    features move by one ulp up or down (the larger of the two; the running
    maximum over steps for the losses). Measured: losses 1e-6 apart,
    parameters 1.2e-6 of their largest entry, first moments 4e-7, second
    moments 1.3e-5 (optax rounds 1 − β2 to float32, 0.00099998713, where
    torch takes 0.001; the float64 twin below shows no such gap)."""
    loss_misses, off = _misses(jax_mlp_cycle, *_port_cycle(jax_mlp_cycle))
    assert not loss_misses, loss_misses
    assert not off, off


def test_ft_mlp_trainer_cycle_matches_jax_in_float64(jax_mlp_cycle_f64):
    """The same cycle with both sides in float64 (JAX under
    ``jax.enable_x64``, its flax weights cast after init; the port's model
    and inputs in float64): every loss and tensor at 1e-10, widened as
    above. Measured: 1.6e-15 at most. A trainer whose weight decay is 10 %
    off moves the parameters by 1.6e-6 of their largest entry in this
    cycle (16 steps × lr 1e-4 × 0.1 × wd 0.01), which lies under the
    float32 witness's own port–JAX distance (1.2e-6); this twin is what
    sees it."""
    loss_misses, off = _misses(jax_mlp_cycle_f64, *_port_cycle(jax_mlp_cycle_f64))
    assert not loss_misses, loss_misses
    assert not off, off


@pytest.mark.parametrize("mutation,witness", [("adamw_beta2_0.998", "jax_mlp_cycle"),
                                              ("adamw_beta2_0.998", "jax_mlp_cycle_f64"),
                                              ("weight_decay_x1.1", "jax_mlp_cycle_f64")])
def test_ft_mlp_witness_fails_on_a_mutated_trainer(request, mutation, witness):
    """The witness has the power to see a trainer that differs: with
    AdamW's second-moment decay at 0.998 in place of optax's 0.999 (float32
    and float64), or its weight decay 10 % above the config's (float64: see
    the twin's docstring), the port's cycle misses JAX's by the same
    bounds."""
    ref = request.getfixturevalue(witness)
    if mutation.startswith("adamw_beta2"):
        loss_misses, off = _misses(ref, *_port_cycle(ref, betas=(0.9, 0.998)))
        assert any(k.startswith("exp_avg_sq:") for k in off), off
    else:
        loss_misses, off = _misses(ref, *_port_cycle(ref, weight_decay=ref["cfg"].weight_decay * 1.1))
        assert {k for k in off if k.startswith("state:")} == {f"state:{n}" for n in ref["start"]}, off
    assert loss_misses, mutation
