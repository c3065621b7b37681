"""One rank of the CPU mesh runs of ``tests/test_torch_parallel.py`` (gloo).

``python tests/torch_parallel_worker.py cases DIR`` runs as one rank of a
data 2 × model 2 mesh whose address, world size and rank come from the
environment (as ``torchrun`` gives them): it reads ``DIR/inputs.pt``, runs
every case and writes ``DIR/rank<r>.pt``. ``python
tests/torch_parallel_worker.py pair DIR PORT RANK`` is one of two processes
joined by ``parallel.initialize_distributed`` with explicit arguments; it
writes its losses to ``DIR/pair<r>.json``. ``python
tests/torch_parallel_worker.py cli ARGS...`` (under ``torchrun``) runs
``run_experiment.main(ARGS)`` with the baseline experiment cut to a small
validation suite and no leaky arms.

The experiments of the cases (``mixed_experiment``, ``pair_experiment``)
are built here so the test builds the same ones unsharded. This file
imports no JAX.
"""

from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from moleculardiffusion_mivit_tpu_torch import parallel  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, GridArm, ModelEntry  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.train.grid import GridModule, make_grid_impls  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.train.loop import (  # noqa: E402
    TrainState,
    generate_cycle_data,
    make_optimizer,
)
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment, save_experiment  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator  # noqa: E402

SMALL_CFG = dict(embed_dim=32, num_heads=4, hidden_dim=64, num_layers=2)
N_GRID = 4
LR = 1e-4


def small_train_cfg(n_per_d: int = 8) -> TrainConfig:
    """6 frames of 5 sub-positions, two D classes (the JAX mesh tests')."""
    return TrainConfig(sequences_per_d=n_per_d, training_ds=((1, 1), (5, 1)), n_frames=6, n_pos_per_frame=5,
                       lr=LR)


def _val_data(train_cfg, seed):
    val = {}
    for d in (1.0, 5.0):
        v, _ = generate_cycle_data(seeded_generator("cpu", seed, int(d) + 100),
                                   train_cfg.replace(training_ds=((d, 1),), sequences_per_d=4), BASELINE_OPTICS)
        val[d] = {"videos": v, "labels": None}
    return val


def mixed_experiment(seed: int = 0) -> Experiment:
    """A grid arm of ``N_GRID`` linear-embedding transformers at dropout 0.1
    (as the JAX package's ``_mixed_experiment``), a deep-ResNet
    transformer (K2/K3's plain version, global BN by gathered rows) and a
    ``MultiImageResNet`` (``BatchNorm``'s summed statistics) on one
    generated dataset of 16 sequences a cycle, batch 1 (the schedule's
    first regime)."""
    train_cfg = small_train_cfg(8).replace(seed=seed)

    def generate_fn(g, part=None):
        out = generate_cycle_data(g, train_cfg, BASELINE_OPTICS, part=part)
        return None if out is None else {"videos": out[0], "labels": out[1]}

    def grid_slice(data):
        v, lab = data["videos"], data["labels"]
        return (v[None].expand((N_GRID,) + v.shape), None,
                None if lab is None else lab[None].expand((N_GRID,) + lab.shape))

    def single_slice(data):
        return data["videos"], None, data["labels"]

    arms = {
        "grid": GridArm(model=GeneralTransformer(ModelConfig(dropout=0.1, **SMALL_CFG), embedding="linear"),
                        names=[f"g{i}" for i in range(N_GRID)], slice_fn=grid_slice),
        "deep": ModelEntry(model=GeneralTransformer(ModelConfig(**SMALL_CFG), embedding="deep_resnet"),
                           slice_fn=single_slice),
        "resnet": ModelEntry(model=MultiImageResNet(single_prediction=True), slice_fn=single_slice),
    }
    return Experiment("mixed", train_cfg, BASELINE_OPTICS, arms, generate_fn, _val_data(train_cfg, seed),
                      device="cpu")


def pair_experiment(stack_pairs: bool) -> Experiment:
    """Two linear-embedding transformers identical up to the FF activation
    (relu, leaky_relu): one activation-pair stack below batch 32."""
    train_cfg = small_train_cfg(4).replace(seed=3, initial_batch_size=2)

    def generate_fn(g, part=None):
        out = generate_cycle_data(g, train_cfg, BASELINE_OPTICS, part=part)
        return None if out is None else {"videos": out[0], "labels": out[1]}

    def single_slice(data):
        return data["videos"], None, data["labels"]

    arms = {act: ModelEntry(model=GeneralTransformer(ModelConfig(activation=act, **SMALL_CFG), embedding="linear"),
                            slice_fn=single_slice) for act in ("relu", "leaky_relu")}
    exp = Experiment("pairs", train_cfg, BASELINE_OPTICS, arms, generate_fn, _val_data(train_cfg, 3), device="cpu")
    exp.stack_pairs = stack_pairs
    return exp


def dropout_experiment(seed: int) -> Experiment:
    """A grid arm of two linear-embedding transformers, and a relu/leaky
    pair of them (an activation stack below batch 32), all at dropout 0.1,
    on 16 sequences a cycle at batch 2."""
    cfg = small_train_cfg(8).replace(seed=seed, adaptive_batch_size=-1, fixed_batch_size=2)

    def generate_fn(g, part=None):
        out = generate_cycle_data(g, cfg, BASELINE_OPTICS, part=part)
        return None if out is None else {"videos": out[0], "labels": out[1]}

    def grid_slice(data):
        return data["videos"][None].expand(2, *data["videos"].shape), None, data["labels"][None].expand(2, -1, -1)

    def single(data):
        return data["videos"], None, data["labels"]

    def model(act="relu"):
        return GeneralTransformer(ModelConfig(dropout=0.1, activation=act, **SMALL_CFG), embedding="linear")

    arms = {"grid": GridArm(model=model(), names=["g0", "g1"], slice_fn=grid_slice),
            "relu": ModelEntry(model=model(), slice_fn=single),
            "leaky": ModelEntry(model=model("leaky_relu"), slice_fn=single)}
    return Experiment("dropout", cfg, BASELINE_OPTICS, arms, generate_fn, {}, device="cpu")


def eval_set(seed: int = 11, n: int = 7):
    """A ``n``-sequence evaluation set (not a multiple of the ranks)."""
    v, _ = generate_cycle_data(seeded_generator("cpu", seed), small_train_cfg(n).replace(training_ds=((3, 1),)),
                               BASELINE_OPTICS)
    return {"videos": v, "labels": None}


def _state(st) -> dict:
    return {k: v.detach().clone() for k, v in st.model.state_dict().items()}


def grid_model(kind: str, dropout: float = 0.0):
    """The model of a one-step case: the small transformer with the
    ``linear`` or ``deep_resnet`` embedding (at ``dropout``), or
    ``MultiImageResNet``."""
    if kind == "resnet":
        return MultiImageResNet(single_prediction=True)
    return GeneralTransformer(ModelConfig(dropout=dropout, **SMALL_CFG), embedding=kind)


def grid_state(members, kind, dtype=torch.float32, dropout: float = 0.0):
    """A ``TrainState`` of a grid of ``kind`` holding the state dicts
    ``members``, in ``dtype``."""
    mods = []
    for sd in members:
        mod = grid_model(kind, dropout)
        mod.load_state_dict(sd)
        mods.append(mod)
    grid = GridModule(grid_model(kind, dropout), mods).to(dtype).train()
    return TrainState(grid, make_optimizer(grid, small_train_cfg()))


def _grid_step(mesh, inputs, kind, dtype=torch.float32, compute_dtype="float32", dropout=0.0):
    """One full-batch step of the sharded grid of case (i) or (ii) from the
    converted JAX weights, in ``dtype`` (at ``compute_dtype``, the
    transformers at ``dropout``); returns this rank's members' losses,
    summed gradients and new parameters."""
    model = grid_model(kind, dropout)
    train_cfg = small_train_cfg().replace(lr=inputs["lr"], compute_dtype=compute_dtype)
    state = grid_state(inputs[kind]["members"][parallel.grid_sharding(mesh, N_GRID)], kind, dtype, dropout)
    step = parallel.make_sharded_grid_step(model, train_cfg, mesh, device="cpu")
    videos, labels = inputs[kind]["videos"].to(dtype), inputs[kind]["labels"].to(dtype)
    state, losses = step(state, videos, labels, inputs["lr"])
    params, _ = state.model.stacked()
    return {"losses": losses, "grads": {n: p.grad.clone() for n, p in params.items()},
            "params": {n: p.detach().clone() for n, p in params.items()}}


BF16_BATCH = 4


def bf16_grid():
    """``test_sharded_bf16_matches_unsharded``'s grid in the JAX package: a
    linear-embedding transformer with early fusion of the 25 features at
    dropout 0.1, trained at bf16; ``(model, train_cfg, videos, labels,
    features)``, the data one generated cycle given to all ``N_GRID``
    members."""
    train_cfg = small_train_cfg(8).replace(compute_dtype="bfloat16")
    videos, labels, feats = generate_cycle_data(seeded_generator("cpu", 0), train_cfg, BASELINE_OPTICS,
                                                with_features=True)
    model = GeneralTransformer(ModelConfig(dropout=0.1, **SMALL_CFG), embedding="linear", use_global_features=True,
                               fusion_type="early", global_feature_dim=feats.shape[1])
    tile = lambda t: t[None].expand((N_GRID,) + t.shape).contiguous()  # noqa: E731
    return model, train_cfg, tile(videos), tile(labels), tile(feats)


def bf16_generators():
    """The grid's members' initial streams, and its cycle's."""
    return [seeded_generator("cpu", 1, m) for m in range(N_GRID)], seeded_generator("cpu", 7)


def _sharded_bf16(mesh) -> dict:
    """One cycle (4 steps of 4) of ``bf16_grid`` on the mesh: this rank's
    members' parameters, every member's losses and predictions, the dtypes
    of the parameters, of the AdamW moments and of an FF layer's input in
    each training forward."""
    model, train_cfg, videos, labels, feats = bf16_grid()
    seen = []
    hook = model.transformer.layer_0.feed_forward.fc1.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].dtype) if mod.training else None)
    init_grid, train_cycle, evaluate = parallel.make_sharded_grid_fns(model, train_cfg, mesh, with_features=True,
                                                                      device="cpu")
    inits, g = bf16_generators()
    grid = init_grid(inits)
    grid, losses = train_cycle(grid, videos, labels, feats, g, LR, BF16_BATCH)
    hook.remove()
    params, _ = grid.model.stacked()
    return {"losses": losses, "params": {n: p.detach().clone() for n, p in params.items()},
            "preds": evaluate(grid, videos, feats), "forward_dtypes": seen,
            "param_dtypes": {p.dtype for p in grid.model.parameters()},
            "moment_dtypes": {v.dtype for st in grid.optimizer.state.values() for k, v in st.items()
                              if k.startswith("exp_avg")}}


def run_cases(out_dir: Path) -> None:
    torch.set_num_threads(1)
    parallel.initialize_distributed("gloo", timeout_s=100)
    mesh = parallel.make_mesh(data=2, model=2)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    res = {"rank": mesh.rank, "data_index": mesh.data_index, "model_index": mesh.model_index}
    try:
        parallel.make_mesh(data=4, model=2)
    except ValueError as e:
        res["too_few_ranks"] = str(e)
    try:
        parallel.grid_sharding(mesh, 3)
    except ValueError as e:
        res["uneven_grid"] = str(e)
    template = GeneralTransformer(ModelConfig(**SMALL_CFG), embedding="linear")
    whole = make_grid_impls(template, small_train_cfg(), "cpu").init_grid(
        [seeded_generator("cpu", 7, m) for m in range(N_GRID)])
    mine = parallel.shard_grid(whole, mesh)
    res["shard_grid"] = {"whole": _state(whole), "mine": _state(mine),
                         "optimizes_its_own": [id(p) for p in mine.optimizer.param_groups[0]["params"]]
                         == [id(p) for p in mine.model.parameters()]}

    # (i), (ii): one grid step against JAX's; (ii) also with per-rank BN
    # statistics (the embedding blind to the split), which must miss
    res["grid_linear"] = _grid_step(mesh, inputs, "linear")
    res["grid_deep"] = _grid_step(mesh, inputs, "deep_resnet")
    res["grid_resnet"] = _grid_step(mesh, inputs, "resnet")
    res["grid_deep_float64"] = _grid_step(mesh, inputs, "deep_resnet", torch.float64)
    res["grid_deep_bf16"] = _grid_step(mesh, inputs, "deep_resnet", compute_dtype="bfloat16")
    res["grid_linear_dropout"] = _grid_step(mesh, inputs, "linear", dropout=0.1)
    res["sharded_bf16"] = _sharded_bf16(mesh)
    from moleculardiffusion_mivit_tpu_torch.models import embeddings

    real = embeddings.current_rows
    embeddings.current_rows = lambda: None
    try:
        res["grid_deep_per_rank_bn"] = _grid_step(mesh, inputs, "deep_resnet")
        res["grid_resnet_per_rank_bn"] = _grid_step(mesh, inputs, "resnet")
    finally:
        embeddings.current_rows = real

    # (iv) padded evaluation before training, (iii) one batch-1 cycle
    exp = mixed_experiment().use_mesh(mesh)
    exp.build()
    data7 = eval_set()
    res["eval7"] = {name: exp.predict(name, data7) for name in exp.model_names}
    exp.run(num_cycles=1)
    res["cycle"] = {"history": exp.history, "states": {a: _state(st) for a, st in exp.states.items()},
                    "train_loss": {a: [t.clone() for t in v] for a, v in exp.train_loss.items()},
                    "members": {a: (sl.start, sl.stop) for a, sl in exp._members.items()}}

    # a checkpoint of the meshed run (rank 0 writes, the grid gathered to
    # it), restored into a fresh meshed experiment: each rank its members
    save_experiment(exp, str(out_dir / "ckpt"))
    again = mixed_experiment().use_mesh(mesh)
    restore_experiment(again, str(out_dir / "ckpt"))
    res["restored"] = {a: _state(st) for a, st in again.states.items()}
    res["restored_opt"] = {a: st.optimizer.state_dict()["state"] for a, st in again.states.items()}
    res["saved_opt"] = {a: st.optimizer.state_dict()["state"] for a, st in exp.states.items()}

    # (v) stacked pairs on the mesh against unstacked
    for stack in (False, True):
        pe = pair_experiment(stack).use_mesh(mesh)
        pe.run(num_cycles=1)
        res[f"pairs_stacked={stack}"] = {"history": pe.history, "groups": len(pe._stack_groups),
                                         "states": {a: _state(st) for a, st in pe.states.items()}}
    torch.save(res, out_dir / f"rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


def run_pair(out_dir: Path, port: int, rank: int) -> None:
    """(vi): two processes joined with explicit arguments run one sharded
    grid cycle (generation inside) on a data 2 × model 1 mesh."""
    torch.set_num_threads(1)
    parallel.initialize_distributed("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank,
                                    timeout_s=100)
    mesh = parallel.make_mesh(data=2, model=1)
    train_cfg = small_train_cfg(4)
    model = GeneralTransformer(ModelConfig(**SMALL_CFG), embedding="linear")

    def data_fn(g, part):  # the part's classes, for its members (one here: model = 1 holds both)
        videos, labels = generate_cycle_data(g, train_cfg, BASELINE_OPTICS, part=part)
        m = part.members.stop - part.members.start
        return videos[None].expand((m,) + videos.shape), labels[None].expand((m,) + labels.shape), None

    init_grid, _, _ = parallel.make_sharded_grid_fns(model, train_cfg, mesh, device="cpu")
    grid = init_grid([seeded_generator("cpu", 5, m) for m in range(2)])
    cycle = parallel.make_sharded_cycle_program(model, train_cfg, mesh, data_fn, device="cpu")
    _, losses = cycle(grid, seeded_generator("cpu", 9), 1e-4, 4)
    (out_dir / f"pair{rank}.json").write_text(json.dumps({"losses": losses.tolist()}))
    torch.distributed.destroy_process_group()


def run_cli(argv) -> None:
    """``run_experiment.main(argv)`` with the baseline cut to a 3-particle
    validation suite of 4 frames, without the leaky arms."""
    torch.set_num_threads(1)
    from moleculardiffusion_mivit_tpu_torch import evaluation, run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, baseline

    def load(length, device):
        return evaluation.generate_frozen_validation(d_values=(1, 3, 5, 7), n_particles=3, t_steps=10 * length,
                                                     in_order_particles=1, device=device)

    baseline.load_validation_trajectories = load
    REGISTRY["baseline"] = functools.partial(baseline.build, val_length=4, try_leaky_relu=False)
    run_experiment.main(argv)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "cases":
        run_cases(Path(sys.argv[2]))
    elif what == "pair":
        run_pair(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    elif what == "cli":
        run_cli(sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {what!r}")
