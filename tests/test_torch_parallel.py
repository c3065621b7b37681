"""The port's mesh (``parallel/``, ``Experiment.use_mesh``, ``run_experiment
--mesh``) on the CPU over gloo, against the JAX package and against the
port unsharded.

One spawn of 4 ranks (data 2 × model 2, ``tests/torch_parallel_worker.py``)
runs every case at the JAX mesh tests' width (embed 32, 4 heads, FFN 64, 2
layers, 6 frames × 5 sub-positions) and writes what each rank holds; each
case below reads it. The JAX references and the unsharded runs are made in
this process while the ranks run. Two more spawns: two processes joined by
``initialize_distributed`` with explicit arguments, and the runner under
``torchrun``. Every spawn is killed, with all its processes, after
``TIMEOUT_S``.

Tolerances, as the JAX package holds its own mesh: one grid step's losses
at 1e-5 relative and its summed gradients at 1e-4 relative plus 1e-4 of
the member's largest gradient (entries that are zero but for rounding, such
as an attention key bias's, and BatchNorm's cancelling sums: the unsharded
port's deep-ResNet step lies up to 6e-5 of that scale from JAX's); parameters after
one step at 2.5·lr (Adam's first update is ±lr·sign(g), so parameters alone
cannot see a fault, and the gradients are compared); after a batch-1 cycle
(its grid at dropout 0.1), parameters at 20·lr and ``val_avg`` at 5 %
relative or 1e-3. At bf16 compute, JAX's bounds for its sharded bf16 cycle
against the unsharded one: losses at 1e-2 relative plus 1e-3, parameters at
4·lr, predictions at 1e-3 relative plus 5e-3; a deep-ResNet step at bf16 at
``chip_smoke.py``'s phase-bf16 bounds for K2-bf16/K3-bf16: losses at 1e-2
relative, each member's summed gradients at 5e-2 in relative L2 and 5e-2 of
its largest gradient in any entry.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.train.grid import make_grid_impls as j_make_grid_impls
from moleculardiffusion_mivit_tpu_torch.config import MeshConfig
from moleculardiffusion_mivit_tpu_torch.train.grid import make_grid_impls
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
TIMEOUT_S = 120
WORLD = 4
LR = 1e-3  # the one-step cases: large enough that 2.5·lr sits above the gradients' float noise
N_ROWS = {"linear": 8, "deep_resnet": 4, "resnet": 4}  # full-batch minibatch of the one-step cases


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def _wait(procs, what):
    """Wait for every process; past ``TIMEOUT_S`` kill them all and fail."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{what} ran past {TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what} failed (exit {p.returncode}):\n{out[-4000:]}"
    return outs


def _spawn(args, env):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _jax_grid(kind, seed):
    """JAX's unsharded grid of ``worker.N_GRID`` members and one full-batch
    step of it on numpy data; the members' weights converted for the port."""
    m, n = worker.N_GRID, N_ROWS[kind]
    rng = np.random.default_rng(seed)
    videos = (0.3 * rng.normal(size=(m, n, 6, 9, 9)) + 0.1).astype(np.float32)
    labels = rng.uniform(0.1, 0.7, size=(m, n, 1)).astype(np.float32)
    jmodel = (JResNet(single_prediction=True) if kind == "resnet"
              else JGeneral(JModelConfig(**worker.SMALL_CFG), embedding=kind))
    impls = j_make_grid_impls(jmodel, JTrainConfig(lr=LR))
    grid = jax.jit(impls.init_grid, static_argnums=(1,))(jax.random.key(seed), m, jnp.asarray(videos[0, :1]))
    members = [torch_state_from_flax(jax.tree.map(lambda v: np.asarray(v[i]), grid.params),
                                     jax.tree.map(lambda v: np.asarray(v[i]), grid.batch_stats)) for i in range(m)]
    return grid, impls, videos, labels, members


def _jax_step(grid, impls, videos, labels):
    m, n = labels.shape[:2]
    idx = jnp.tile(jnp.arange(n)[None], (m, 1))
    with jax.default_matmul_precision("highest"):
        new, losses = jax.jit(impls.train_step)(grid, jnp.asarray(videos), jnp.asarray(labels), None, idx,
                                                jax.random.split(jax.random.key(1), m), jnp.float32(LR))
    mu = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda v: hasattr(v, "mu")) if hasattr(s, "mu")).mu
    grads = [torch_state_from_flax(jax.tree.map(lambda v: np.asarray(v[i]) / 0.1, mu)) for i in range(m)]
    params = [torch_state_from_flax(jax.tree.map(lambda v: np.asarray(v[i]), new.params)) for i in range(m)]
    return np.asarray(losses), grads, params


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every rank's results, and the references: JAX's grid steps, the
    unsharded mixed and pair experiments."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("mesh")
    jax_side = {kind: _jax_grid(kind, seed) for seed, kind in enumerate(N_ROWS)}
    inputs = {"lr": LR}
    for kind, (_, _, videos, labels, members) in jax_side.items():
        inputs[kind] = {"videos": torch.from_numpy(videos), "labels": torch.from_numpy(labels), "members": members}
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    procs = [_spawn([str(WORKER), "cases", str(out)],
                    _env(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(WORLD), RANK=str(r),
                         LOCAL_RANK=str(r)))
             for r in range(WORLD)]
    try:
        ref = {kind: _jax_step(grid, impls, videos, labels) for kind, (grid, impls, videos, labels, _) in
               jax_side.items()}
        fresh = worker.mixed_experiment()
        fresh.build()
        eval7 = {name: fresh.predict(name, worker.eval_set()) for name in fresh.model_names}
        mixed = worker.mixed_experiment()
        mixed.run(num_cycles=1)
        deep64 = worker.grid_state(inputs["deep_resnet"]["members"], "deep_resnet", torch.float64)
        model = worker.grid_model("deep_resnet")
        losses64 = make_grid_impls(model, worker.small_train_cfg().replace(lr=LR), "cpu").train_cycle(
            deep64, inputs["deep_resnet"]["videos"].double(), inputs["deep_resnet"]["labels"].double(),
            torch.Generator().manual_seed(0), LR, N_ROWS["deep_resnet"])
        pairs = {}
        for stack in (False, True):
            pairs[stack] = worker.pair_experiment(stack)
            pairs[stack].run(num_cycles=1)
        bf16 = _unsharded_bf16()
        deep_bf16 = worker.grid_state(inputs["deep_resnet"]["members"], "deep_resnet")
        drop = worker.grid_state(inputs["linear"]["members"], "linear", dropout=0.1)
        losses_drop = make_grid_impls(worker.grid_model("linear", 0.1), worker.small_train_cfg().replace(lr=LR),
                                      "cpu").train_cycle(drop, inputs["linear"]["videos"], inputs["linear"]["labels"],
                                                         torch.Generator().manual_seed(0), LR, N_ROWS["linear"])
        losses_bf16 = make_grid_impls(
            worker.grid_model("deep_resnet"), worker.small_train_cfg().replace(lr=LR, compute_dtype="bfloat16"), "cpu"
        ).train_cycle(deep_bf16, inputs["deep_resnet"]["videos"], inputs["deep_resnet"]["labels"],
                      torch.Generator().manual_seed(0), LR, N_ROWS["deep_resnet"])
    finally:
        _wait(procs, "the 4-rank mesh")
        torch.set_num_threads(threads)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    unsharded = worker.mixed_experiment()
    restore_experiment(unsharded, str(out / "ckpt"))
    return dict(restored_unsharded=unsharded, ranks=ranks, jax=ref, eval7=eval7, mixed=mixed, pairs=pairs,
                deep64=(losses64, deep64), bf16=bf16, deep_bf16=(losses_bf16, deep_bf16),
                linear_dropout=(losses_drop, drop))


def _unsharded_bf16():
    """``worker.bf16_grid``'s cycle unsharded at bf16: losses, parameters,
    predictions."""
    model, train_cfg, videos, labels, feats = worker.bf16_grid()
    impls = make_grid_impls(model, train_cfg, "cpu", with_features=True)
    inits, g = worker.bf16_generators()
    state = impls.init_grid(inits)
    losses = impls.train_cycle(state, videos, labels, g, worker.LR, worker.BF16_BATCH, feats)
    params, _ = state.model.stacked()
    return {"losses": losses, "params": {n: p.detach().clone() for n, p in params.items()},
            "preds": impls.evaluate(state, videos, feats)}


def _grads_close(got, want, where, atol):
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=atol * scale,
                                   err_msg=f"{where} gradient {name}")


# the summed gradients' bound beside rtol 1e-4, in the member's largest
# gradient: the unsharded port's step lies up to 6e-5 (deep-ResNet) and
# 5.4e-4 (MultiImageResNet, whose max-pool choice can flip on f32 noise)
# of it from JAX's
GRAD_ATOL = {"linear": 1e-4, "deep_resnet": 1e-4, "resnet": 1e-2}


def _grid_step_against_jax(run, kind, key):
    """Every rank's members: losses, summed gradients and parameters
    against JAX's unsharded step; the two data ranks of a column hold the
    same members bitwise."""
    losses, grads, params = run["jax"][kind]
    for res in run["ranks"]:
        got = res[key]
        np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=1e-5)
        lo = res["model_index"] * 2
        for j in range(2):
            _grads_close({n: g[j] for n, g in got["grads"].items()}, grads[lo + j],
                         f"rank {res['rank']} member {lo + j}", GRAD_ATOL[kind])
            for name, w in params[lo + j].items():
                np.testing.assert_allclose(got["params"][name][j].numpy(), w.numpy(), rtol=0, atol=2.5 * LR,
                                           err_msg=f"member {lo + j} {name}")
    for a, b in ((0, 2), (1, 3)):  # the data ranks of one column
        for name, g in run["ranks"][a][key]["grads"].items():
            assert torch.equal(g, run["ranks"][b][key]["grads"][name]), name


def case_grid_step_linear(run):
    """(i) The linear-embedding grid, members over ``model``, the batch of 8
    over ``data``."""
    _grid_step_against_jax(run, "linear", "grid_linear")


def case_grid_step_deep_resnet(run):
    """(ii) The deep-ResNet grid at batch 4 over ``data`` = 2: BatchNorm
    inside K2/K3's plain version takes the statistics of all 4 rows."""
    _grid_step_against_jax(run, "deep_resnet", "grid_deep")


def case_grid_step_resnet(run):
    """(ii) The ``MultiImageResNet`` grid at batch 4 over ``data`` = 2:
    ``BatchNorm`` under ``torch.vmap`` sums its statistics over the
    column's ranks, one all-reduce for both members."""
    _grid_step_against_jax(run, "resnet", "grid_resnet")


def case_grid_step_deep_resnet_float64(run):
    """(ii) in float64, against the port unsharded from the same weights and
    permutation: what remains is the order of the sums, so the losses agree
    to 1e-12 and the summed gradients to 1e-10 of the member's largest
    (K2/K3's plain version takes BatchNorm's statistics over the gathered
    rows, K3's partial gradients of each rank's rows sum to the whole's)."""
    losses, state = run["deep64"]
    params, _ = state.model.stacked()
    for res in run["ranks"]:
        got = res["grid_deep_float64"]
        assert got["losses"].dtype == torch.float64
        np.testing.assert_allclose(got["losses"].numpy(), losses.numpy(), rtol=1e-12)
        sl = slice(res["model_index"] * 2, res["model_index"] * 2 + 2)
        scale = max(float(p.grad[sl].abs().max()) for p in params.values())
        for name, p in params.items():
            np.testing.assert_allclose(got["grads"][name].numpy(), p.grad[sl].numpy(), rtol=0, atol=1e-10 * scale,
                                       err_msg=name)


def case_grid_step_linear_dropout(run):
    """(i) at dropout 0.1 against the port unsharded from the same weights
    and key: each ``data`` rank draws its rows of the minibatch's masks
    (``models.dropout``: global rows), so the one-step bounds of (i) hold
    (losses at 1e-5, summed gradients as ``_grads_close``, parameters at
    2.5·lr); a rank drawing its local rows' masks instead misses them."""
    losses, state = run["linear_dropout"]
    params, _ = state.model.stacked()
    for res in run["ranks"]:
        got = res["grid_linear_dropout"]
        lo = res["model_index"] * 2
        np.testing.assert_allclose(got["losses"].numpy(), losses.numpy(), rtol=1e-5)
        for j in range(2):
            _grads_close({n: g[j] for n, g in got["grads"].items()}, {n: p.grad[lo + j] for n, p in params.items()},
                         f"rank {res['rank']} member {lo + j}", GRAD_ATOL["linear"])
            for name, p in params.items():
                np.testing.assert_allclose(got["params"][name][j].numpy(), p[lo + j].detach().numpy(), rtol=0,
                                           atol=2.5 * LR, err_msg=f"member {lo + j} {name}")


def case_sharded_bf16(run):
    """The counterpart of the JAX package's ``test_sharded_bf16_matches_
    unsharded``: a 4-member early-fusion grid with features at dropout 0.1
    on ``data=2, model=2`` at bf16 trains like the port unsharded at bf16
    (JAX's bounds); on every rank the parameters and the AdamW moments stay
    f32 and an FF layer's input is bf16 in every training forward. The
    attention key biases are held to Adam's step bound instead, 2·lr a step
    over the cycle's 4: their gradient is analytically 0 (softmax is
    shift-invariant), so Adam turns each side's rounding noise into steps
    of ±lr whose signs the two layouts draw apart."""
    want = run["bf16"]
    steps = worker.N_GRID * 4 // worker.BF16_BATCH
    for res in run["ranks"]:
        got = res["sharded_bf16"]
        assert got["param_dtypes"] == got["moment_dtypes"] == {torch.float32}
        assert got["forward_dtypes"] and set(got["forward_dtypes"]) == {torch.bfloat16}
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(), rtol=1e-2, atol=1e-3)
        sl = slice(res["model_index"] * 2, res["model_index"] * 2 + 2)
        for name, p in want["params"].items():
            bound = 2 * steps if name.endswith("k_proj.bias") else 4
            np.testing.assert_allclose(got["params"][name].numpy(), p[sl].numpy(), rtol=0, atol=bound * worker.LR,
                                       err_msg=f"rank {res['rank']} {name}")
        np.testing.assert_allclose(got["preds"].numpy(), want["preds"].numpy(), rtol=1e-3, atol=5e-3)


def case_grid_step_deep_resnet_bf16(run):
    """(ii) at bf16 compute: K2-bf16/K3-bf16's plain versions on the rows
    gathered over ``data`` = 2 against the port unsharded at bf16 from the
    same weights, at phase bf16's bounds (module docstring)."""
    losses, state = run["deep_bf16"]
    params, _ = state.model.stacked()
    for res in run["ranks"]:
        got = res["grid_deep_bf16"]
        np.testing.assert_allclose(got["losses"].numpy(), losses.numpy(), rtol=1e-2)
        lo = res["model_index"] * 2
        for j in range(2):
            scale = max(float(p.grad[lo + j].abs().max()) for p in params.values())
            for name, p in params.items():
                g, w = got["grads"][name][j], p.grad[lo + j]
                assert g.dtype == torch.float32, name
                assert float((g - w).abs().max()) <= 5e-2 * scale, (res["rank"], j, name)
                assert float((g - w).norm()) <= 5e-2 * float(w.norm()) + 1e-6 * scale, (res["rank"], j, name)


def _per_rank_bn_misses(run, kind, key):
    """The mutated step's gradients lie more than 10 times the bound from
    JAX's (the unmutated ones lie within it)."""
    _, grads, _ = run["jax"][kind]
    worst = 0.0
    for res in run["ranks"]:
        lo = res["model_index"] * 2
        for j in range(2):
            scale = max(float(np.abs(w.numpy()).max()) for w in grads[lo + j].values())
            for name, w in grads[lo + j].items():
                d = np.abs(res[key + "_per_rank_bn"]["grads"][name][j].numpy() - w.numpy())
                worst = max(worst, float((d / (1e-4 * np.abs(w.numpy()) + GRAD_ATOL[kind] * scale)).max()))
    assert worst > 10, worst


def case_per_rank_bn_statistics_miss_deep_resnet(run):
    """(ii)'s mutation: the embedding blind to the split (per-rank BN
    statistics inside K2/K3's plain version) gives gradients far outside
    the bound, so the case sees T1."""
    _per_rank_bn_misses(run, "deep_resnet", "grid_deep")


def case_per_rank_bn_statistics_miss_resnet(run):
    """The same mutation of ``BatchNorm`` misses the ResNet grid's bound."""
    _per_rank_bn_misses(run, "resnet", "grid_resnet")


def case_batch1_cycle(run):
    """(iii) One batch-1 cycle of the mixed experiment (at batch 1 three of
    four ranks hold no row of a single-model arm's minibatch): every arm's
    parameters and BN statistics at 20·lr of the unsharded run, every
    model's ``val_avg`` at 5 % or 1e-3, the same history on every rank."""
    mixed = run["mixed"]
    for res in run["ranks"]:
        cyc = res["cycle"]
        assert cyc["history"] == run["ranks"][0]["cycle"]["history"]
        for name, h in mixed.history.items():
            np.testing.assert_allclose(cyc["history"][name]["val_avg"], h["val_avg"], rtol=0.05, atol=1e-3)
        for arm, st in mixed.states.items():
            want = st.model.state_dict()
            sl = slice(*cyc["members"][arm]) if arm in cyc["members"] else slice(None)
            for k, v in cyc["states"][arm].items():
                np.testing.assert_allclose(v.numpy(), want[k][sl].numpy() if v.ndim else want[k].numpy(),
                                           rtol=0, atol=20 * worker.LR, err_msg=f"{arm} {k}")
        assert cyc["train_loss"]["grid"][0].shape == (worker.N_GRID,)


def case_replicated_bitwise_and_members_on_their_rank(run):
    """(iii) Replicated arms bitwise equal on every rank; each rank holds
    only its ``model`` block of the grid's members, the same on both
    ``data`` ranks of its column."""
    ranks = run["ranks"]
    for res in ranks:
        cyc = res["cycle"]
        lo = res["model_index"] * 2
        assert cyc["members"]["grid"] == (lo, lo + 2)
        assert all(v.shape[0] == 2 for v in cyc["states"]["grid"].values() if v.ndim)
        for arm in ("deep", "resnet"):
            for k, v in cyc["states"][arm].items():
                assert torch.equal(v, ranks[0]["cycle"]["states"][arm][k]), f"rank {res['rank']} {arm} {k}"
    for a, b in ((0, 2), (1, 3)):
        for k, v in ranks[a]["cycle"]["states"]["grid"].items():
            assert torch.equal(v, ranks[b]["cycle"]["states"]["grid"][k]), k


def case_checkpoint(run):
    """A checkpoint written on the mesh (rank 0, the grid's members gathered
    from the ``model`` ranks) holds the whole run: restored unsharded, the
    grid is every rank's members in order; restored on the mesh, each rank
    gets back its own members' parameters, buffers and AdamW moments
    bitwise."""
    whole = run["restored_unsharded"].states
    for res in run["ranks"]:
        cyc = res["cycle"]
        for arm, state in cyc["states"].items():
            sl = slice(*cyc["members"][arm]) if arm in cyc["members"] else slice(None)
            for k, v in state.items():
                assert torch.equal(res["restored"][arm][k], v), f"rank {res['rank']} {arm} {k}"
                assert torch.equal(whole[arm].model.state_dict()[k][sl] if v.ndim else whole[arm].model.state_dict()[k],
                                   v), f"unsharded {arm} {k}"
            for i, st in res["saved_opt"][arm].items():
                for k, v in st.items():
                    assert torch.equal(res["restored_opt"][arm][i][k], v), f"rank {res['rank']} {arm} moment {k}"


def case_padded_evaluation(run):
    """(iv) A 7-sequence set on 4 ranks: every model's predictions on every
    rank equal the unsharded ones."""
    for res in run["ranks"]:
        for name, want in run["eval7"].items():
            got = res["eval7"][name]
            assert got.shape == want.shape == (7, 1), name
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def case_stacked_pairs(run):
    """(v) The relu/leaky pair stacked on the mesh equals it unstacked on
    the mesh and the unsharded run (parameters at 20·lr, ``val_avg`` at
    5 %)."""
    res = run["ranks"][0]
    stacked, unstacked = res["pairs_stacked=True"], res["pairs_stacked=False"]
    assert stacked["groups"] == 1 and unstacked["groups"] == 0
    for other in (unstacked, {"states": {a: st.model.state_dict() for a, st in run["pairs"][True].states.items()},
                              "history": run["pairs"][True].history}):
        for arm, state in stacked["states"].items():
            for k, v in state.items():
                np.testing.assert_allclose(v.numpy(), other["states"][arm][k].numpy(), rtol=0,
                                           atol=20 * worker.LR, err_msg=f"{arm} {k}")
            np.testing.assert_allclose(stacked["history"][arm]["val_avg"], other["history"][arm]["val_avg"],
                                       rtol=0.05)


def case_mesh_placement_and_refusals(run):
    """``make_mesh`` with more ranks than the world raises as the JAX
    package's does; a grid the ``model`` axis does not divide raises, as
    ``jax.device_put`` with ``P('model')`` does; ``shard_grid`` keeps the
    rank's block of members and an optimizer over them alone."""
    for res in run["ranks"]:
        assert res["too_few_ranks"] == "need 8 ranks, have 4"
        assert "does not split over 2 model ranks" in res["uneven_grid"]
        sl = slice(res["model_index"] * 2, res["model_index"] * 2 + 2)
        whole, mine = res["shard_grid"]["whole"], res["shard_grid"]["mine"]
        assert whole.keys() == mine.keys() and res["shard_grid"]["optimizes_its_own"]
        for k, v in mine.items():
            assert torch.equal(v, whole[k][sl]), k


CASES = {f.__name__[5:]: f for f in (
    case_grid_step_linear, case_grid_step_deep_resnet, case_grid_step_resnet, case_grid_step_deep_resnet_float64,
    case_per_rank_bn_statistics_miss_deep_resnet, case_per_rank_bn_statistics_miss_resnet, case_batch1_cycle,
    case_replicated_bitwise_and_members_on_their_rank, case_checkpoint, case_padded_evaluation, case_stacked_pairs,
    case_mesh_placement_and_refusals, case_sharded_bf16, case_grid_step_deep_resnet_bf16,
    case_grid_step_linear_dropout)}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh(mesh_run, case):
    CASES[case](mesh_run)


def test_two_coordinated_processes(tmp_path):
    """(vi) Two processes joined by ``initialize_distributed`` with explicit
    address, world size and rank run one sharded grid cycle (generation
    inside) and report bitwise the same losses."""
    port = _free_port()
    _wait([_spawn([str(WORKER), "pair", str(tmp_path), str(port), str(r)], _env()) for r in range(2)],
          "the two processes")
    losses = [json.loads((tmp_path / f"pair{r}.json").read_text())["losses"] for r in range(2)]
    assert losses[0] == losses[1] and len(losses[0]) == 2 and all(np.isfinite(losses[0]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_run_experiment_mesh_under_torchrun(tmp_path, compute_dtype):
    """(vii) ``run_experiment baseline --device cpu --mesh data=2,model=1
    --compute-dtype …`` under ``torchrun`` with 2 ranks: rank 0 alone writes
    ``metrics.jsonl``, its rows finite."""
    out = tmp_path / "run"
    _wait([_spawn(["-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-port", str(_free_port()),
                   str(WORKER), "cli", "baseline", "--device", "cpu", "--mesh", "data=2,model=1", "--cycles", "1",
                   "--seqs-per-d", "2", "--checkpoint-last", "0", "--compute-dtype", compute_dtype,
                   "--out", str(out)], _env())],
          "torchrun")
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in rows].count("start") == 1 and rows[0]["mesh"] == {"data": 2, "model": 1}
    assert rows[0]["compute_dtype"] == compute_dtype
    cycle = [r for r in rows if r["event"] == "cycle"]
    assert len(cycle) == 1 and all(np.isfinite(v) for v in cycle[0]["val_avg"].values())
    assert (out / "final" / "states" / "resnet.pt").is_file()


def test_mesh_config_parses_the_command_line_layout():
    """``run_experiment --mesh`` reads its layout through
    ``MeshConfig.parse``: an axis left out is 1; another axis or a
    malformed layout raises."""
    assert MeshConfig.parse("data=2,model=4").shape == {"data": 2, "model": 4}
    assert MeshConfig.parse("model=2") == MeshConfig(data_parallel=1, model_parallel=2)
    for bad in ("data=2,pipe=2", "data=two", "data"):
        with pytest.raises(ValueError):
            MeshConfig.parse(bad)
