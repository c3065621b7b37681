"""The port's keyed dropout (``models/dropout.py``) against flax's and
against a numpy reference of its hash.

- Formula: given the mask that ``jax.random.bernoulli`` draws for a key, the
  port's ``select(mask, x / keep, 0)`` is ``flax.linen.Dropout``'s bitwise,
  in f32 and in bf16 (``keep`` rounded to the input's dtype, as JAX rounds a
  weak-typed Python float).
- Hash: ``mix32``, ``absorb``, ``step_key`` and ``dropout_mask`` equal a
  numpy version in ``uint64`` (products exact below 2^64, no 16-bit halves).
- Statistics: over 2^18 elements the keep share lies within 4σ of
  ``1 − p``; two masks that should be independent (consecutive steps, two
  grid members, two rows) correlate by less than 4/√n, the bound for the
  sample correlation of n independent pairs at 4σ.
- Layout: a rank's rows of a split minibatch are bitwise the rows of the
  unsharded mask; a grid member's mask under ``torch.vmap`` does not depend
  on the member count or on its position.
- One training forward from the same converted weights, averaged over 64
  dropout keys on each side: the port's mean loss within 3 pooled standard
  errors of flax's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
from moleculardiffusion_mivit_tpu_torch.models import dropout as tdrop
from moleculardiffusion_mivit_tpu_torch.parallel.collectives import RowShard, sharded_rows
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, fold_in, seeded_generator

import flax.linen as fnn  # noqa: E402  (after the JAX package, which sets JAX up)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker as worker  # noqa: E402

SMALL = dict(use_pos_encoding=True, embed_dim=16, num_heads=2, hidden_dim=32, num_layers=2)
M = np.uint64(0xFFFF_FFFF)


def np_mix32(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB_352D)) & M
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846C_A68B)) & M
    return x ^ (x >> np.uint64(16))


def np_absorb(a, b, word):
    a = np_mix32(a ^ np.uint64(word) if np.isscalar(word) else a ^ word)
    return a, np_mix32(b ^ a)


def np_mask(key: int, first: int, site: int, lo: int, shape, keep: float):
    a, b = np_absorb(np.uint64(key) & M, np.uint64(key) >> np.uint64(32), np.uint64(first))
    words = np.uint64(site * 2**20 + lo) + np.arange(shape[0], dtype=np.uint64)
    rows = np_mix32(b ^ words).reshape((shape[0],) + (1,) * (len(shape) - 1))
    pos = np.arange(int(np.prod(shape[1:])), dtype=np.uint64).reshape((1,) + tuple(shape[1:]))
    return (np_mix32(pos ^ rows) ^ a) < np.uint64(int(keep * 2**32))


def _mask(key: int, first: int, site: int = 0, lo: int = 0, shape=(4, 8), keep: float = 0.9) -> torch.Tensor:
    state = tdrop.step_key(torch.tensor(key), torch.tensor(first))
    return tdrop.dropout_mask(state, site, lo, shape, keep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_formula_matches_flax_given_its_mask(dtype):
    """flax's ``Dropout(0.1)`` on a key and the port's formula on the mask
    ``jax.random.bernoulli`` draws for that key agree bitwise."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 33)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    key = jax.random.key(3)
    want = fnn.Dropout(rate=0.1).apply({}, xj, deterministic=False, rng=key)
    mask = np.array(jax.random.bernoulli(key, p=0.9, shape=x.shape))
    assert 0 < mask.mean() < 1
    got = tdrop.apply_keep_mask(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask), 0.9)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy().view(np.uint32), np.asarray(want.astype(jnp.float32)).view(np.uint32))


def test_hash_matches_numpy_uint64():
    """``mix32`` on words across ``[0, 2^32)`` (the top ones too, where a
    plain int64 product would overflow), and whole masks at several keys,
    sites, row offsets and shapes, equal the numpy ``uint64`` version."""
    rng = np.random.default_rng(1)
    words = np.concatenate([rng.integers(0, 2**32, size=4096, dtype=np.uint64),
                            np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], dtype=np.uint64)])
    got = tdrop.mix32(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint64), np_mix32(words))
    assert tdrop.mix32(12345) == int(np_mix32(np.uint64(12345)))
    for key, first, site, lo, shape in [(0, 0, 0, 0, (3, 5)), (2**63 - 1, 7, 3, 2, (4, 2, 6, 6)),
                                        (dropout_key(seeded_generator("cpu", 1)), 2**32 - 1, 2047, 9, (2, 61, 64))]:
        want = np_mask(key, first, site, lo, shape, 0.9)
        assert np.array_equal(_mask(key, first, site, lo, shape).numpy(), want), (key, first, site, lo, shape)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_share_within_four_sigma(p):
    """Over 2^18 elements the share kept lies within 4σ of ``1 − p``."""
    n = 2**18
    mask = _mask(dropout_key(seeded_generator("cpu", 5)), 3, shape=(64, n // 64), keep=1 - p)
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(float(mask.float().mean()) - (1 - p)) < 4 * sigma


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.flatten().float().numpy(), b.flatten().float().numpy())[0, 1])


def test_masks_independent_where_they_should_be_and_equal_across_ranks():
    """Consecutive steps (two ``idx[0]``), two grid members (their keys from
    ``fold_in(g, 0)`` and ``fold_in(g, 1)``) and two rows of one mask
    correlate by less than 4/√n; a rank holding rows 3:7 of a minibatch of
    8 draws rows 3:7 of the unsharded mask bitwise."""
    g = seeded_generator("cpu", 2, 1)
    k0, k1 = (dropout_key(fold_in(g, m)) for m in range(2))
    shape = (8, 2, 61, 61)
    n = int(np.prod(shape))
    base = _mask(k0, 5, shape=shape)
    for other in (_mask(k0, 6, shape=shape), _mask(k1, 5, shape=shape)):
        assert not torch.equal(base, other)
        assert abs(_corr(base, other)) < 4 / np.sqrt(n)
    assert abs(_corr(base[0], base[1])) < 4 / np.sqrt(n // 8)
    assert torch.equal(_mask(k0, 5, lo=3, shape=(4,) + shape[1:]), base[3:7])

    layer = tdrop.KeyedDropout(0.1, site=0).train()
    x = torch.ones(shape)
    state = tdrop.step_key(torch.tensor(k0), torch.tensor(5))
    with tdrop.keyed_dropout(state):
        whole = layer(x)
        with sharded_rows(RowShard(None, 3, 7, 8)):
            part = layer(x[3:7])
    assert torch.equal(part, whole[3:7]) and torch.equal(whole != 0, base)


def test_grid_member_masks_do_not_depend_on_the_grid():
    """Under ``torch.vmap`` each member hashes its own key: members 2 and 3
    of a grid of 4 draw what a grid of those two draws, and what each draws
    alone."""
    keys = torch.tensor([dropout_key(fold_in(seeded_generator("cpu", 4), m)) for m in range(4)])
    first = torch.tensor([3, 0, 5, 1])
    layer = tdrop.KeyedDropout(0.1, site=2).train()
    x = torch.ones(4, 3, 7, 16)

    def run(k, f, v):
        def one(state, xm):
            with tdrop.keyed_dropout(state):
                return layer(xm)
        return torch.vmap(one)(tdrop.step_key(k, f), v)

    four, two = run(keys, first, x), run(keys[2:], first[2:], x[2:])
    assert torch.equal(four[2:], two)
    for m in range(4):
        with tdrop.keyed_dropout(tdrop.step_key(keys[m], first[m])):
            assert torch.equal(four[m], layer(x[m])), m
    assert not torch.equal(four[0], four[1])


def test_eval_mode_and_rate_zero_return_the_input_and_a_missing_key_raises():
    """Eval mode and ``p = 0`` return the input itself (no op at all);
    training with ``p > 0`` and no key raises, as flax does without a
    ``dropout`` rng."""
    x = torch.randn(3, 4)
    assert tdrop.KeyedDropout(0.1).eval()(x) is x
    assert tdrop.KeyedDropout(0.0).train()(x) is x
    model = GeneralTransformer(ModelConfig(dropout=0.1, **SMALL), embedding="linear").eval()
    videos = torch.randn(2, 6, 9, 9)
    assert torch.equal(model(videos), model(videos))
    with pytest.raises(RuntimeError, match="key"):
        model.train()(videos)
    assert not tdrop.uses_dropout(GeneralTransformer(ModelConfig(**SMALL), embedding="linear"))
    assert tdrop.uses_dropout(model)


def test_mean_loss_over_dropout_keys_matches_flax():
    """From the same converted weights and minibatch, the training forward's
    mse loss at dropout 0.1 averaged over 64 keys on each side (flax's
    ``rngs={"dropout": k}``, the port's ``step_key`` of 64 cycle keys): the
    means agree within 3 pooled standard errors, and dropout moves the loss
    (its spread over keys is not 0)."""
    rng = np.random.default_rng(2)
    videos = (0.3 * rng.normal(size=(8, 6, 9, 9)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(8, 1)).astype(np.float32)
    jmodel = JGeneral(JModelConfig(dropout=0.1, **SMALL), embedding="linear")
    params, bstats = jax.jit(lambda k, v: j_init(jmodel, k, v))(jax.random.key(0), jnp.asarray(videos[:1]))

    def jloss(k):
        out = jmodel.apply({"params": params}, jnp.asarray(videos), train=True, rngs={"dropout": k})
        return jnp.mean((out - jnp.asarray(labels)) ** 2)

    with jax.default_matmul_precision("highest"):
        jl = np.asarray(jax.jit(jax.vmap(jloss))(jax.random.split(jax.random.key(9), 64)))

    tmodel = GeneralTransformer(ModelConfig(dropout=0.1, **SMALL), embedding="linear")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bstats)))
    tmodel.train()
    keys = [dropout_key(seeded_generator("cpu", 9, i)) for i in range(64)]
    tl = []
    with torch.no_grad():
        for k in keys:
            with tdrop.keyed_dropout(tdrop.step_key(torch.tensor(k), torch.tensor(0))):
                tl.append(float(torch.mean((tmodel(torch.from_numpy(videos)) - torch.from_numpy(labels)) ** 2)))
    tl = np.array(tl)
    se = np.sqrt(jl.var(ddof=1) / jl.size + tl.var(ddof=1) / tl.size)
    assert jl.std() > 0 and tl.std() > 0
    assert abs(jl.mean() - tl.mean()) < 3 * se, (jl.mean(), tl.mean(), se)


def test_an_experiment_with_dropout_is_a_function_of_its_seed():
    """One cycle of the experiment above: the fused cycle (the pair
    stacked), the merged one and each arm's own eager epoch give bitwise the
    same parameters and losses; a second run from the same seed repeats it
    bitwise, another seed does not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for layout in ("stacked", "merged", "eager", "again", "other_seed"):
            exp = worker.dropout_experiment(seed=1 if layout == "other_seed" else 0)
            exp.merge_scans = layout == "merged"
            exp.fused_cycles = layout != "eager"
            exp.run(num_cycles=1)
            if layout == "stacked":
                assert len(exp._stack_groups) == 1
            runs[layout] = ({a: {k: v.clone() for k, v in st.model.state_dict().items()} for a, st in exp.states.items()},
                            {a: losses[0] for a, losses in exp.train_loss.items()})
    finally:
        torch.set_num_threads(threads)
    states, losses = runs["stacked"]
    for layout in ("merged", "eager", "again"):
        for arm, sd in states.items():
            assert torch.equal(losses[arm], runs[layout][1][arm]), (layout, arm)
            for k, v in sd.items():
                assert torch.equal(v, runs[layout][0][arm][k]), (layout, arm, k)
    assert not torch.equal(losses["relu"], runs["other_seed"][1]["relu"])
