"""MolecularDiffusion-MiViT on PyTorch and CUDA (NVIDIA Hopper).

A port of ``moleculardiffusion_mivit_tpu`` that keeps its module paths and
public names. Plain tensor code is PyTorch; the two kernels the JAX package
wrote in Pallas (the frame renderer and the deep-ResNet embedding's training
forward and backward) are CUDA C++ under ``csrc/``, compiled for ``sm_90a``
at first use by ``ops._build``.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without a card they raise rather than fall back. On CPU
tensors every kernel wrapper runs its plain PyTorch version, which the tests
hold against the JAX package.

Subpackages
-----------
- ``config``      copies of the JAX package's typed configuration
- ``sim``         trajectories (Brownian, fBm, drift, boxes), constrained
                  geometries, frame rendering, noise, the constrained demo
- ``ops``         the hand-written kernels, their wrappers and plain versions; plain
                  batched filters, hull and curve fits
- ``models``      GeneralTransformer (linear, cnn, deep-ResNet embeddings), ModularTransformer,
                  HybridFusionTransformer, MultiImageResNet, MultiImageFeatureResNet
- ``features``    the 25 trajectory features, the per-frame tokens, MSD estimators
- ``train``       the cycle-based training loop, the fused cycle as CUDA graphs
- ``denoise``     Richardson-Lucy deconvolution with TV regularisation
- ``experiments`` the seven experiments of ``run_experiment``
- ``evaluation``  frozen validation sets, the published in-order suite (``data/``),
                  change points, result analysis, figures
- ``utils``       flax → torch weight conversion, metrics, checkpoints, streams
"""

__version__ = "0.1.0"

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and no card is
    present, so a run never silently continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev
