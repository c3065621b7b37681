"""Generation born sharded on the port's mesh (``Experiment.generate``,
``parallel.mesh.GenerationPart``, ``parallel.collectives.gather_part``) on
the CPU over gloo, against the port unsharded, and the per-class streams of
``train.loop.generate_cycle_data`` against the JAX package's in
distribution.

Two spawns of ranks run at once (``tests/torch_parallel_generation_worker.py``,
torchrun's environment set by hand), a world of 2 (meshes ``data=2`` and
``model=2``) and a world of 4 (``data=2, model=2`` and ``data=4``): each
rank makes cycle 0's data of every experiment whose ``generate_fn`` takes a
part, at 2 sequences a class, and the world of 4 trains one full-batch step
of the baseline at ``data=4`` and of psfnoise at ``data=2, model=2``. The
unsharded references are made in this process while the ranks run.

Tolerances: the gathered data bitwise (its bytes) equal to the unsharded
``generate_fn``'s (a grid's part: its members' slices); the frames reaching
the renderer, the rows reaching the 25 features and the frames reaching
RL-TV summed over the ranks equal to the unsharded call's (no rank makes
another's part); a trained step as ``tests/test_torch_parallel.py`` holds
one: losses at 1e-5 relative, parameters at 2.5·lr, ``val_avg`` at 5 % or
1e-3. In distribution: per class, the means of the D labels, of each
sequence's mean pixel and of its pixel sd within 4 standard errors of
JAX's (400 sequences a class, 4 frames). No two key tuples of a cycle's
streams give one seed, and the block renderer is the renderer a block at a
time, bitwise."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.train.loop import generate_cycle_data as j_generate_cycle_data
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
from moleculardiffusion_mivit_tpu_torch.experiments.base import GridArm
from moleculardiffusion_mivit_tpu_torch.parallel import GenerationPart, part_units
from moleculardiffusion_mivit_tpu_torch.sim.render import trajectories_to_video, trajectories_to_video_blocks
from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data
from moleculardiffusion_mivit_tpu_torch.utils import rng
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_generation_worker as worker  # noqa: E402
from test_torch_parallel import _env, _free_port, _spawn, _wait  # noqa: E402

WORKER = Path(__file__).resolve().parent / "torch_parallel_generation_worker.py"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of both worlds, and the unsharded references:
    each case's data and counts, each cycle case trained unsharded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("generation")
    procs = []
    for world in (2, 4):
        port = _free_port()
        procs += [_spawn([str(WORKER), "gen", str(out)],
                         _env(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                              LOCAL_RANK=str(r)))
                  for r in range(world)]
    mp = pytest.MonkeyPatch()
    try:
        worker.patch(mp.setattr)
        counts = worker.Counts(mp.setattr)
        whole = {}
        for name, (build, _) in worker.GEN_CASES.items():
            exp = build()
            counts.take()  # the build's validation renders
            whole[name] = (exp, exp.generate_fn(worker.cycle_generator()), counts.take())
        cycles = {}
        for name in worker.CYCLE_CASES:
            exp = worker.build_cycle_case(name)
            exp.run(1)
            cycles[name] = (exp, worker.record(exp))
    finally:
        mp.undo()
        _wait(procs, "the generation ranks")
        torch.set_num_threads(threads)
    ranks = {world: [torch.load(out / f"gen{world}_rank{r}.pt", weights_only=False) for r in range(world)]
             for world in (2, 4)}
    return {"ranks": ranks, "whole": whole, "cycles": cycles}


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().flatten().view(torch.uint8), b.contiguous().flatten().view(torch.uint8)))


def _held(run, name, shape):
    """Every rank of mesh ``shape``: its gathered data bitwise the unsharded
    cycle's (a grid part's: each grid arm's slices, its members alone)."""
    exp, whole, _ = run["whole"][name]
    world = shape[0] * shape[1]
    for r, res in enumerate(run["ranks"][world]):
        got = res["gen"][name, shape]
        data = got["data"]
        if got["members"] is None:
            assert data.keys() == whole.keys(), (name, r)
            for k, v in whole.items():
                assert _bitwise(data[k], v) if torch.is_tensor(v) else data[k] == v, (name, shape, r, k)
            continue
        members = slice(*got["members"])
        for arm_name, arm in exp.arms.items():
            assert isinstance(arm, GridArm)
            for i, (g, w) in enumerate(zip(arm.slice_fn(data), arm.slice_fn(whole))):
                assert (g is None and w is None) or _bitwise(g, w[members]), (name, shape, r, arm_name, i)


def _counts_add_up(run, name, shape):
    """The renderer's frames, the features' rows and RL-TV's frames of the
    ranks add up to the unsharded call's: no rank made another's part; a
    rank with a part made some."""
    _, _, want = run["whole"][name]
    ranks = [res["gen"][name, shape] for res in run["ranks"][shape[0] * shape[1]]]
    for key, total in want.items():
        if key in worker.AFTER_GATHER.get(name, ()):  # the cross-class steps' work: every rank's is the whole
            assert all(r["counts"][key] == total for r in ranks), (name, shape, key)
            continue
        assert sum(r["counts"][key] for r in ranks) == total, (name, shape, key, [r["counts"] for r in ranks])
        assert all(r["counts"][key] < total for r in ranks) or total == 0, (name, shape, key)
    assert all(r["counts"]["k1_frames"] > 0 for r in ranks), (name, shape)


GEN_PARAMS = [(name, shape) for world in (2, 4) for shape in worker.MESHES[world] for name in worker.GEN_CASES
              if worker.takes(name, shape)]


@pytest.mark.parametrize("name,shape", GEN_PARAMS, ids=[f"{n}-data{s[0]}-model{s[1]}" for n, s in GEN_PARAMS])
def test_sharded_generation_is_the_unsharded_cycle(runs, name, shape):
    """Each rank's gathered cycle equals the unsharded ``generate_fn``'s
    bitwise, and each rank rendered, featurised and deconvolved its part
    alone."""
    _held(runs, name, shape)
    _counts_add_up(runs, name, shape)


def test_parts_split_the_units_and_the_members(runs):
    """The parts: a single-model experiment's over every rank; a grid's
    over the ``data`` ranks of a column, with the column's ``model`` block
    of members; denoising's 7 members refuse ``model=2``."""
    for world, shape, name, members in ((2, (2, 1), "baseline", None), (2, (1, 2), "psfnoise", ((0, 2), (2, 4))),
                                        (4, (2, 2), "ensemble", ((0, 2), (2, 4), (0, 2), (2, 4))),
                                        (4, (2, 2), "images_features", None), (4, (4, 1), "denoising", None)):
        got = [res["gen"][name, shape] for res in runs["ranks"][world]]
        if members is None and not worker.GEN_CASES[name][1]:
            assert [(g["index"], g["size"], g["members"]) for g in got] == [(r, world, None) for r in range(world)]
        elif members is None:
            assert [g["members"] for g in got] == [(0, 7)] * world
        else:
            assert [g["members"] for g in got] == list(members)
            assert [(g["index"], g["size"]) for g in got] == [(r // shape[1], shape[0]) for r in range(world)]
    assert "does not split over 2 model ranks" in runs["ranks"][2][0]["denoising_model_2"]


def test_blocks_are_balanced_and_partition_the_units():
    """``GenerationPart.units``: contiguous blocks covering ``range(n)``
    once, the first ``n % size`` one longer, empty past ``n``; no part is
    every unit."""
    for n in range(0, 9):
        for size in (1, 2, 3, 4):
            blocks = [GenerationPart(i, size, None).units(n) for i in range(size)]
            assert [u for b in blocks for u in b] == list(range(n))
            assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    assert part_units(None, 5) == range(5)


@pytest.mark.parametrize("name", list(worker.GEN_CASES))
def test_no_two_streams_of_a_cycle_alias(name, monkeypatch):
    """Every stream an unsharded cycle draws from (``utils.rng``: each
    ``fold_in``) is named by one key tuple alone: no two different tuples
    give one seed, as ``(k)`` and ``(k, 0)`` would (``SeedSequence`` pads
    with zeros), so no part's render reuses another draw's numbers."""
    worker.patch(monkeypatch.setattr)
    exp = worker.GEN_CASES[name][0]()
    names, make = {}, rng.seeded_generator

    def named(device, *keys):
        g = make(device, *keys)
        names.setdefault(g.initial_seed(), set()).add(tuple(int(k) for k in keys))
        return g

    monkeypatch.setattr(rng, "seeded_generator", named)
    exp.generate_fn(worker.cycle_generator())
    assert len(names) > 2
    assert not {seed: keys for seed, keys in names.items() if len(keys) > 1}, name


def test_no_two_streams_of_a_training_cycle_alias(monkeypatch):
    """``test_no_two_streams_of_a_cycle_alias`` over a whole cycle of
    training with dropout (``torch_parallel_worker.dropout_experiment``: a
    grid arm and an activation-pair stack at dropout 0.1): the generation's
    streams, each arm's permutation stream, each grid member's
    (``fold_in``) and each model's dropout key (``utils.rng.dropout_key``:
    the stream ``(seed of the permutation's generator, DROPOUT_STREAM)``),
    four of them, one a model; no two key tuples give one seed."""
    import torch_parallel_worker as mesh_worker

    from moleculardiffusion_mivit_tpu_torch.experiments import base

    exp = mesh_worker.dropout_experiment(0)
    exp.build()
    names, make = {}, rng.seeded_generator

    def named(device, *keys):
        g = make(device, *keys)
        names.setdefault(g.initial_seed(), set()).add(tuple(int(k) for k in keys))
        return g

    monkeypatch.setattr(rng, "seeded_generator", named)
    monkeypatch.setattr(base, "seeded_generator", named)
    exp.run(num_cycles=1)
    keys = [k for ks in names.values() for k in ks]
    assert sum(k[-1] == rng.DROPOUT_STREAM for k in keys) == 4
    assert not {seed: ks for seed, ks in names.items() if len(ks) > 1}


def test_block_render_is_each_block_rendered_alone():
    """``sim.trajectories_to_video_blocks`` (the ensemble's members in one
    K1 launch, each from its own generator) equals ``trajectories_to_video``
    of each block with its generator bitwise, so each block's noise is the
    renderer's, which ``tests/test_torch_sim.py`` holds to JAX's in
    distribution."""
    rng = np.random.default_rng(4)
    trajs = torch.from_numpy((rng.normal(size=(6, 40, 2)).cumsum(axis=1) * 0.05).astype(np.float32))
    gens = [seeded_generator("cpu", 9, b) for b in range(3)]
    got = trajectories_to_video_blocks(gens, trajs, 10, True, BASELINE_OPTICS)
    for b in range(len(gens)):
        want = trajectories_to_video(seeded_generator("cpu", 9, b), trajs[2 * b:2 * b + 2], 10, True, BASELINE_OPTICS)
        assert _bitwise(got[2 * b:2 * b + 2], want), b


@pytest.mark.parametrize("name", list(worker.CYCLE_CASES))
def test_one_cycle_on_four_ranks_matches_unsharded(runs, name):
    """One cycle (one full-batch step) of the baseline at ``data=4`` and of
    psfnoise at ``data=2, model=2`` on generation born sharded: every
    model's training loss at 1e-5 relative, every parameter at 2.5·lr (a
    grid's members: the rank's block), ``val_avg`` at 5 % or 1e-3, the same
    history on every rank; BatchNorm's running statistics, which carry the
    data's scale (psfnoise's unnormalised frames: variances ~1e6), at 1e-3
    of the tensor's largest, ``chip_smoke.py``'s bound for them."""
    exp, want = runs["cycles"][name]
    lr = exp.train_cfg.lr_for_cycle(0)
    ranks = [res["cycle"][name] for res in runs["ranks"][4]]
    for got in ranks:
        assert got["history"] == ranks[0]["history"]
        for model, h in want["history"].items():
            np.testing.assert_allclose(got["history"][model]["val_avg"], h["val_avg"], rtol=0.05, atol=1e-3)
        for arm, losses in want["train_loss"].items():
            np.testing.assert_allclose(got["train_loss"][arm][0].numpy(), losses[0].numpy(), rtol=1e-5,
                                       err_msg=f"{name} {arm}")
        for arm, state in got["states"].items():
            sl = slice(*got["members"][arm]) if arm in got["members"] else slice(None)
            for k, v in state.items():
                w = want["states"][arm][k]
                w = w[sl] if v.ndim and arm in got["members"] else w
                if k.endswith("num_batches_tracked"):
                    assert torch.equal(v, w), (name, arm, k)
                    continue
                running = k.endswith(("running_mean", "running_var"))
                atol = 1e-3 * float(w.abs().max()) if running else 2.5 * lr
                np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=f"{name} {arm} {k}")


@pytest.mark.parametrize("sequence_mode", [False, True])
def test_per_class_generate_cycle_data_matches_jax_in_distribution(sequence_mode):
    """The per-class streams of ``generate_cycle_data`` draw what JAX's
    does, class by class: 400 sequences of 4 frames a class, per class the
    mean of the D labels, of each sequence's mean pixel and of its pixel sd
    within 4 standard errors of JAX's (the two sides draw from different
    generators); a part of the classes is the whole call's rows bitwise."""
    n, f = 400, 4
    cfg = TrainConfig(sequences_per_d=n, n_frames=f, sequence_mode=sequence_mode)
    jcfg = JTrainConfig(sequences_per_d=n, n_frames=f, sequence_mode=sequence_mode)
    gen = torch.Generator().manual_seed(11)
    videos, labels = generate_cycle_data(gen, cfg, BASELINE_OPTICS)
    jv, jl = (np.asarray(a) for a in j_generate_cycle_data(jax.random.key(11), jcfg, J_OPTICS)[:2])
    assert videos.shape == jv.shape and labels.shape == jl.shape
    tv, tl = videos.numpy(), labels.numpy()
    for c in range(len(cfg.training_ds)):
        rows = slice(c * n, (c + 1) * n)
        for what, t, j in (("D", tl[rows].mean(axis=1), jl[rows].mean(axis=1)),
                           ("pixel mean", tv[rows].mean(axis=(1, 2, 3)), jv[rows].mean(axis=(1, 2, 3))),
                           ("pixel sd", tv[rows].std(axis=(1, 2, 3)), jv[rows].std(axis=(1, 2, 3)))):
            se = np.sqrt(t.var() / n + j.var() / n)
            assert abs(t.mean() - j.mean()) <= 4 * se, (c, what, t.mean(), j.mean(), se)
    for index in range(3):
        part = GenerationPart(index, 3, None)
        got = generate_cycle_data(gen, cfg, BASELINE_OPTICS, part=part)
        rows = slice(part.units(4).start * n, part.units(4).stop * n)
        assert _bitwise(got[0], videos[rows]) and _bitwise(got[1], labels[rows])
