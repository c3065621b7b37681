"""Experiment registry.

Port of ``moleculardiffusion_mivit_tpu/experiments``. Ported: ``baseline``
(the reference's tests/train_tests: three embeddings × {relu, leaky_relu}
transformers + MultiImageResNet), ``images_features`` (MiViT with the 25
trajectory features against image-only, features-only and MSD arms) and
``modular`` (ModularTransformer with per-frame feature tokens; with
``with_hybrid`` also HybridFusionTransformer and its early-fusion parent),
``embeddings`` (three embeddings at three sizes and MultiImageResNet),
``framerate`` (a transformer and a ResNet per exposure setting, on 13×13
frames) and ``psfnoise`` (the 5 PSF × 6 noise grid: two 30-model
``GridArm``s). ``denoising`` is listed under its name and raises
``NotImplementedError`` (ROADMAP.md, queue 1, item 12).
"""

from moleculardiffusion_mivit_tpu_torch.experiments import (
    baseline,
    embeddings,
    framerate,
    images_features,
    modular,
    psfnoise,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import (  # noqa: F401
    Experiment,
    GridArm,
    ModelEntry,
    rotate_videos,
)


def _not_ported(name: str):
    def build(**kwargs) -> Experiment:
        raise NotImplementedError(f"experiment {name!r} is not ported yet (ROADMAP.md, queue 1, item 12)")

    return build


REGISTRY = {
    "baseline": baseline.build,
    "images_features": images_features.build,
    "modular": modular.build,
    "embeddings": embeddings.build,
    "framerate": framerate.build,
    "psfnoise": psfnoise.build,
    "denoising": _not_ported("denoising"),
}


def get_experiment(name: str, **kwargs) -> Experiment:
    if name not in REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
