"""Checkpointing with restore-and-continue.

Port of ``moleculardiffusion_mivit_tpu/utils/checkpoint.py`` with its
directory layout: ``<path>/states/`` (here one ``<arm>.pt`` per learned arm,
``torch.save`` of the model's and the optimizer's ``state_dict``: parameters,
BatchNorm running statistics, AdamW moments, step counts and learning rate;
a grid arm's model is its ``train.grid.GridModule``, every member stacked),
``<path>/history.json`` and ``<path>/meta.json``. A restored experiment
continues exactly where the saved one stopped.
"""

from __future__ import annotations

import json
import os

import torch


def save_experiment(exp, path: str) -> None:
    """Persist every arm's model and optimizer state, and the history."""
    path = os.path.abspath(path)
    states = os.path.join(path, "states")
    os.makedirs(states, exist_ok=True)
    for arm_name, st in exp.states.items():
        torch.save(
            {"model": st.model.state_dict(), "optimizer": st.optimizer.state_dict()},
            os.path.join(states, f"{arm_name}.pt"),
        )
    with open(os.path.join(path, "history.json"), "w") as f:
        json.dump(exp.history, f)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"name": exp.name, "model_names": exp.model_names}, f)


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
