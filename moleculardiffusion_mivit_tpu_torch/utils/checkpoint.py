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
    Its captured graphs are dropped: the optimizers' restored state is in
    new tensors."""
    path = os.path.abspath(path)
    if not exp._built:
        exp.build()
    for arm_name, st in exp.states.items():
        saved = torch.load(os.path.join(path, "states", f"{arm_name}.pt"), map_location=exp.device)
        st.model.load_state_dict(saved["model"])
        st.optimizer.load_state_dict(saved["optimizer"])
    with open(os.path.join(path, "history.json")) as f:
        exp.history = json.load(f)
    exp.release_graphs()
