"""Experiment registry.

Port of ``moleculardiffusion_mivit_tpu/experiments``. Ported: ``baseline``
(the reference's tests/train_tests: three embeddings × {relu, leaky_relu}
transformers + MultiImageResNet), ``images_features`` (MiViT with the 25
trajectory features against image-only, features-only and MSD arms) and
``modular`` (ModularTransformer with per-frame feature tokens; with
``with_hybrid`` also HybridFusionTransformer and its early-fusion parent),
``embeddings`` (three embeddings at three sizes and MultiImageResNet),
``framerate`` (a transformer and a ResNet per exposure setting, on 13×13
frames), ``psfnoise`` (the 5 PSF × 6 noise grid: two 30-model
``GridArm``s) and ``denoising`` (seven input settings, raw to RL-TV
deconvolved: two 7-model ``GridArm``s trained with L1 loss).
"""

from moleculardiffusion_mivit_tpu_torch.experiments import (
    baseline,
    denoising,
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


REGISTRY = {
    "baseline": baseline.build,
    "images_features": images_features.build,
    "modular": modular.build,
    "embeddings": embeddings.build,
    "framerate": framerate.build,
    "psfnoise": psfnoise.build,
    "denoising": denoising.build,
}


def get_experiment(name: str, **kwargs) -> Experiment:
    if name not in REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
