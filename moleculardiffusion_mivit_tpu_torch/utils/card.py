"""The card a run used, as ``nvidia-smi`` names it: written beside every
number a study or the smoke records."""

from __future__ import annotations

import subprocess

import torch


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them (the
    device's name where it cannot be asked; ``cpu`` on the CPU)."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)
