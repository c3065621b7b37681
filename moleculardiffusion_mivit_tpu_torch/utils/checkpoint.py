"""Checkpointing with restore-and-continue.

Port of ``moleculardiffusion_mivit_tpu/utils/checkpoint.py`` with its
directory layout: ``<path>/states/`` (here one ``<arm>.pt`` per learned arm,
``torch.save`` of the model's and the optimizer's ``state_dict``: parameters,
BatchNorm running statistics, AdamW moments, step counts and learning rate;
a grid arm's model is its ``train.grid.GridModule``, every member stacked),
``<path>/history.json`` and ``<path>/meta.json``. A restored experiment
continues exactly where the saved one stopped.

On a mesh (``Experiment.use_mesh``) every rank calls both: rank 0 writes the
whole state, a grid arm's members gathered to it from the ``model`` ranks
(every member-stacked tensor, the AdamW moments among them), and restore
gives each rank its own members of the saved grid. A checkpoint is the same
whatever mesh wrote it.
"""

from __future__ import annotations

import json
import os

import torch


def _map_members(state: dict, fn) -> dict:
    """``fn`` applied to every member-stacked tensor of a grid's model or
    optimizer ``state_dict`` (every tensor with an axis: the AdamW step
    counts are 0-d)."""
    if "state" in state and "param_groups" in state:  # an optimizer's
        return {**state, "state": {k: _map_members(v, fn) for k, v in state["state"].items()}}
    return {k: fn(v) if torch.is_tensor(v) and v.ndim else v for k, v in state.items()}


def save_experiment(exp, path: str) -> None:
    """Persist every arm's model and optimizer state, and the history (on a
    mesh: every rank calls it, rank 0 writes, and it returns on every rank
    once the files are written)."""
    path = os.path.abspath(path)
    states = os.path.join(path, "states")
    mesh = getattr(exp, "_mesh", None)
    writes = mesh is None or mesh.rank == 0
    if writes:
        os.makedirs(states, exist_ok=True)
    for arm_name, st in exp.states.items():
        saved = {"model": st.model.state_dict(), "optimizer": st.optimizer.state_dict()}
        if arm_name in getattr(exp, "_members", {}):
            from moleculardiffusion_mivit_tpu_torch.parallel.steps import gather_members

            saved = {k: _map_members(v, lambda t: gather_members(t, mesh)) for k, v in saved.items()}
        if writes:
            torch.save(saved, os.path.join(states, f"{arm_name}.pt"))
    if writes:
        with open(os.path.join(path, "history.json"), "w") as f:
            json.dump(exp.history, f)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"name": exp.name, "model_names": exp.model_names}, f)
    if mesh is not None:  # no rank returns before the checkpoint is whole
        from moleculardiffusion_mivit_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(torch.zeros(1, device=exp.device), mesh.world_group)


def restore_experiment(exp, path: str) -> None:
    """Restore a saved experiment into ``exp`` (built first if it is not:
    the same arms and configurations as the saved one), onto its device.
    A checkpoint whose models, arms or tensors do not match ``exp``'s raises
    before anything is loaded. Its captured graphs are dropped: the
    optimizers' restored state is in new tensors."""
    path = os.path.abspath(path)
    if not exp._built:
        exp.build()
    with open(os.path.join(path, "meta.json")) as f:
        saved_names = json.load(f)["model_names"]
    files = sorted(n[:-3] for n in os.listdir(os.path.join(path, "states")) if n.endswith(".pt"))
    if saved_names != exp.model_names or files != sorted(exp.states):
        raise ValueError(f"checkpoint {path} holds models {saved_names} (arms {files}); the experiment has "
                         f"{exp.model_names} (arms {sorted(exp.states)})")
    saved = {arm: torch.load(os.path.join(path, "states", f"{arm}.pt"), map_location=exp.device)
             for arm in exp.states}
    for arm, members in getattr(exp, "_members", {}).items():  # this rank's members of a saved grid
        saved[arm] = {k: _map_members(v, lambda t: t[members]) for k, v in saved[arm].items()}
    for arm, st in exp.states.items():
        want = {k: tuple(v.shape) for k, v in st.model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in saved[arm]["model"].items()}
        if got != want:
            raise ValueError(f"checkpoint {path}: arm {arm!r} does not match the experiment's model "
                             f"({sorted(set(got.items()) ^ set(want.items()))[:4]} ...)")
    for arm, st in exp.states.items():
        st.model.load_state_dict(saved[arm]["model"])
        st.optimizer.load_state_dict(saved[arm]["optimizer"])
    with open(os.path.join(path, "history.json")) as f:
        exp.history = json.load(f)
    exp.release_graphs()
