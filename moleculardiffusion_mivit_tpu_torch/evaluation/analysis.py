"""Result analysis of a saved experiment directory.

Port of ``moleculardiffusion_mivit_tpu/evaluation/analysis.py`` (it imports
no JAX there either; the port keeps its own copy): the validation tables of
a run's ``history.json``, and a side-by-side comparison with the reference's
published poster CSVs where that directory is given (``None`` / ``{}``
where it is not, as in the JAX package). The directory is the reference
repository's ``outPoster/``, passed as ``poster_dir``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


def load_history(result_dir: str) -> Dict[str, Dict[str, list]]:
    with open(os.path.join(result_dir, "history.json")) as f:
        return json.load(f)


def final_val_table(history: Dict[str, Dict[str, list]]) -> Dict[str, float]:
    """Final-cycle val_avg per model — the quantity the reference tracks
    across cycles in ``validation_losses``."""
    return {
        name: h["val_avg"][-1] for name, h in history.items() if h.get("val_avg")
    }


def best_val_table(history: Dict[str, Dict[str, list]]) -> Dict[str, float]:
    return {
        name: min(h["val_avg"]) for name, h in history.items() if h.get("val_avg")
    }


def load_reference_poster_csv(
    name: str = "poster-model_errors-final.csv", poster_dir: Optional[str] = None
) -> Optional[Dict[str, Dict[str, float]]]:
    """Parse a reference poster CSV (model,mse,std rows) if the poster
    directory is given and holds it; ``None`` otherwise."""
    path = os.path.join(poster_dir, name) if poster_dir else None
    if path is None or not os.path.exists(path):
        return None
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 3 or not parts[0]:
                continue
            try:
                out[parts[0]] = {"mse": float(parts[1]), "std": float(parts[2])}
            except ValueError:
                continue
    return out


# Reference poster/analysis name → our images_features arm name. Covers both
# the short poster names (poster-model_errors-final.csv) and the long
# name_map strings (trainSettingsImagesFeatures.py:104-117 / model_errors.csv).
POSTER_NAME_MAP = {
    "MSD": "MSD_Frame",
    "MLP": "ft_mlp",
    "CNN": "im_resnet",
    "ViT": "im_tr",
    "MiViT": "im_ft_early_tr",
    "MSD Frame": "MSD_Frame",
    "MSD Perfect": "MSD_Perfect",
    "MSD Localized": "MSD_Localized",
    "Feat only": "ft_mlp",
    "CNN only": "im_resnet",
    "Transf(CNN)": "im_tr",
    "Transf(CNN + Feat)": "im_ft_early_tr",
    "Transfo(CNN) + Feat": "im_ft_late_tr",
    "CNN + Feat": "im_ft_resnet",
}


def compare_with_poster(
    our_tables: Dict[str, Dict[str, float]],
    poster_csv: str = "poster-model_errors-final.csv",
    poster_dir: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Side-by-side {poster row: {ref_mse, our_mse, ratio}} for matching arms."""
    ref = load_reference_poster_csv(poster_csv, poster_dir)
    if ref is None:
        return {}
    out = {}
    for ref_name, stats in ref.items():
        ours_name = POSTER_NAME_MAP.get(ref_name)
        if ours_name and ours_name in our_tables:
            our_mse = our_tables[ours_name]["mse"]
            out[ref_name] = {
                "ref_mse": stats["mse"],
                "our_mse": our_mse,
                "ratio": our_mse / stats["mse"] if stats["mse"] else float("inf"),
            }
    return out
