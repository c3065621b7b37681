"""One rank of the CPU meshes of ``tests/test_torch_parallel_generation.py``
(gloo), started with torchrun's environment set by hand.

``python tests/torch_parallel_generation_worker.py gen DIR`` runs as one rank
of a world of 2 or 4: for every mesh of ``MESHES[world]`` and every case of
``GEN_CASES`` that takes it, it builds the case's experiment on the mesh,
makes cycle 0's data through ``Experiment.generate`` (this rank's part,
gathered) with the frames that reach the renderer, the rows that reach the
25 features and the frames that reach RL-TV counted, and writes what it
holds to ``DIR/gen<world>_rank<r>.pt``. On the world of 4 it then runs
``CYCLE_CASES``: one training cycle, one full-batch step, of the baseline at
``data=4`` and of the shrunk psfnoise at ``data=2, model=2``.

The experiments are built here (``GEN_CASES``, ``CYCLE_CASES``,
``small_validation``) so the test builds the same ones unsharded. This file
imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from moleculardiffusion_mivit_tpu_torch import evaluation, parallel  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.denoise import rl_tv  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.evaluation import changepoint_study  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.experiments import (  # noqa: E402
    baseline,
    denoising,
    embeddings,
    ensemble,
    framerate,
    images_features,
    modular,
    psfnoise,
)
from moleculardiffusion_mivit_tpu_torch.sim import render  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.train import loop  # noqa: E402
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator  # noqa: E402

TINY = ModelConfig(use_pos_encoding=False, embed_dim=8, num_heads=2, hidden_dim=16, num_layers=1)
PSF, NOISE = (2.0, 1.0), (0.0, 0.2)


def small_validation(length, device):
    """A validation suite of 2 particles at D = 1 and 5 and one particle a
    D value in order, ``length`` frames of 10 sub-positions."""
    return evaluation.generate_frozen_validation(d_values=(1, 5), n_particles=2, t_steps=10 * length,
                                                 in_order_particles=1, device=device)


def patch(setattr_=setattr) -> None:
    """Cut the validation suites the experiments' build functions load,
    and psfnoise's transformers to ``TINY`` (``setattr_``: the test's
    monkeypatch)."""
    for mod in (baseline, psfnoise):
        setattr_(mod, "load_validation_trajectories", small_validation)
    setattr_(psfnoise, "ModelConfig", lambda **kw: TINY.replace(**kw))


# name -> (build, grid): every experiment whose generate_fn takes a part,
# at 2 sequences a class (the ensemble: 3 a member)
GEN_CASES = {
    "baseline": (lambda: baseline.build(seed=1, sequences_per_d=2, val_length=4, val_d_values=(),
                                        try_leaky_relu=False, device="cpu"), False),
    "baseline_sequences": (lambda: baseline.build(seed=1, sequences=True, sequences_per_d=2, val_length=4,
                                                  val_d_values=(), try_leaky_relu=False, device="cpu"), False),
    "baseline_continuous": (lambda: baseline.build(seed=1, sequences=True, continuous_d=(0.5, 7.5), sequences_per_d=2,
                                                   val_length=4, val_d_values=(), try_leaky_relu=False,
                                                   device="cpu"), False),
    "embeddings": (lambda: embeddings.build(seed=1, sequences_per_d=2, val_length=4, val_d_values=(), device="cpu"),
                   False),
    "images_features": (lambda: images_features.build(seed=1, sequences_per_d=2, val_length=4, val_d_values=(),
                                                      device="cpu"), False),
    "modular": (lambda: modular.build(seed=1, sequences_per_d=2, val_length=4, val_d_values=(), with_hybrid=True,
                                      device="cpu"), False),
    "framerate": (lambda: framerate.build(seed=1, rates=(5, 10), sequences_per_d=2, val_length=6, val_d_values=(),
                                          device="cpu"), False),
    "framerate_continuous": (lambda: framerate.build(seed=1, rates=(5, 10), sequences_per_d=2, val_length=6,
                                                     val_d_values=(), continuous_d=(0.5, 9.5), device="cpu"), False),
    "changepoint_modular": (lambda: changepoint_study.build_modular(1, 2, True, device="cpu"), False),
    "psfnoise": (lambda: psfnoise.build(seed=1, sequences_per_d=2, psf_settings=PSF, noise_settings=NOISE,
                                        val_length=6, val_d_values=(), device="cpu"), True),
    "denoising": (lambda: denoising.build(seed=1, sequences_per_d=2, val_length=6, val_d_values=(), device="cpu"),
                  True),
    "ensemble": (lambda: ensemble.build(1, 4, 3, model_cfg=TINY, device="cpu"), True),
}
# name -> the counts of work that follows the gather on every rank: the
# change-point study's hybrid features are those of the tail-swapped
# trajectories, so they come after its cross-class swap
AFTER_GATHER = {"changepoint_modular": ("feature_rows",)}
# world -> its meshes; denoising's 7 members do not split over model = 2
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1))}


def takes(name: str, mesh) -> bool:
    """Whether case ``name`` runs on ``mesh`` (data, model): single-model
    experiments split their units over every rank, so ``model`` alone
    changes nothing for them; denoising's grid of 7 takes no ``model`` of 2."""
    grid = GEN_CASES[name][1]
    if name == "denoising":
        return mesh[1] == 1
    return grid or mesh != (1, 2)


class Counts:
    """The frames that reach the renderer's frame core and PSF stack (K1 on
    the card), the rows that reach the 25 features and the frames that
    reach RL-TV, through the package's public functions."""

    def __init__(self, setattr_=setattr):
        self.k1_frames = self.feature_rows = self.rl_tv_frames = 0
        core, stack, features, rl = (render.render_frames_core, render.render_psf_stack,
                                     loop.compute_features_for_multiple_trajectories, rl_tv.apply_rl_tv_iter_list_batch)

        def counted_core(x_hr, *a, **k):
            self.k1_frames += x_hr.numel() // x_hr.shape[-1]
            return core(x_hr, *a, **k)

        def counted_stack(x_hr, y_hr, intensities, sigmas, *a, **k):
            self.k1_frames += len(sigmas) * (x_hr.numel() // x_hr.shape[-1])
            return stack(x_hr, y_hr, intensities, sigmas, *a, **k)

        def counted_features(trajs, *a, **k):
            self.feature_rows += trajs.shape[0]
            return features(trajs, *a, **k)

        def counted_rl(videos, *a, **k):
            self.rl_tv_frames += videos.shape[0] * videos.shape[1]
            return rl(videos, *a, **k)

        setattr_(render, "render_frames_core", counted_core)
        setattr_(render, "render_psf_stack", counted_stack)
        for mod in (loop, images_features, modular, changepoint_study):
            setattr_(mod, "compute_features_for_multiple_trajectories", counted_features)
        setattr_(rl_tv, "apply_rl_tv_iter_list_batch", counted_rl)

    def take(self) -> dict:
        out = {"k1_frames": self.k1_frames, "feature_rows": self.feature_rows, "rl_tv_frames": self.rl_tv_frames}
        self.k1_frames = self.feature_rows = self.rl_tv_frames = 0
        return out


def cycle_generator():
    """Cycle 0's generator of a seed-1 experiment (``Experiment.run``'s)."""
    return seeded_generator("cpu", 2, 0, 0)


# name -> (build, mesh, batch): one cycle, one full-batch AdamW step
CYCLE_CASES = {
    "baseline": (lambda: baseline.build(seed=0, sequences_per_d=2, val_length=4, val_d_values=(1.0, 5.0),
                                        try_leaky_relu=False, device="cpu"), (4, 1), 8),
    "psfnoise": (lambda: psfnoise.build(seed=0, sequences_per_d=2, psf_settings=PSF, noise_settings=NOISE,
                                        val_length=6, val_d_values=(1.0, 5.0), device="cpu"), (2, 2), 11),
}


def build_cycle_case(name: str):
    """Case ``name`` of ``CYCLE_CASES``, its whole cycle one minibatch."""
    build, _, batch = CYCLE_CASES[name]
    exp = build()
    exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
    return exp


def record(exp) -> dict:
    """What the test compares of a trained experiment."""
    return {"history": exp.history, "train_loss": {a: [t.clone() for t in v] for a, v in exp.train_loss.items()},
            "states": {a: {k: v.detach().clone() for k, v in st.model.state_dict().items()}
                       for a, st in exp.states.items()},
            "members": {a: (sl.start, sl.stop) for a, sl in exp._members.items()}}


def run_gen(out_dir: Path) -> None:
    torch.set_num_threads(1)
    parallel.initialize_distributed("gloo", timeout_s=100)
    world = torch.distributed.get_world_size()
    patch()
    counts = Counts()
    res = {"gen": {}, "cycle": {}}
    for shape in MESHES[world]:
        mesh = parallel.make_mesh(*shape)
        for name in GEN_CASES:
            if not takes(name, shape):
                continue
            exp = GEN_CASES[name][0]().use_mesh(mesh)
            part = exp.generation_part()
            counts.take()  # the build's validation renders
            data = exp.generate(cycle_generator())
            res["gen"][name, shape] = {"data": data, "counts": counts.take(), "index": part.index,
                                       "size": part.size,
                                       "members": None if part.members is None else (part.members.start,
                                                                                     part.members.stop)}
        if shape == (1, 2):
            try:
                GEN_CASES["denoising"][0]().use_mesh(mesh).generation_part()
            except ValueError as e:
                res["denoising_model_2"] = str(e)
    if world == 4:
        for name, (_, shape, _) in CYCLE_CASES.items():
            exp = build_cycle_case(name).use_mesh(parallel.make_mesh(*shape))
            exp.run(1)
            res["cycle"][name] = record(exp)
    torch.save(res, out_dir / f"gen{world}_rank{torch.distributed.get_rank()}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] != "gen":
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
    run_gen(Path(sys.argv[2]))
