"""Typed configuration for simulation, models and training.

A copy of the dataclasses of ``moleculardiffusion_mivit_tpu/config.py``
(``OpticsConfig``, ``ModelConfig``, ``TrainConfig``, ``BASELINE_OPTICS``),
kept here so the port imports nothing of the JAX package. Field names,
defaults and derived properties are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OpticsConfig:
    """Optical / camera model for fluorescence video rendering.

    Reproduces two quirks of the reference's ``image_props`` contract as
    implemented: ``fwhm_psf = wavelength / 2 * NA / psf_division_factor``
    (Python precedence), and the high-resolution grid
    ``linspace(-limit, limit, S*u)`` with ``limit=(S*u-1)//2``, which has unit
    spacing only when ``S*u`` is odd.
    """

    particle_intensity: Tuple[float, float] = (500.0, 20.0)  # mean, std
    na: float = 1.46
    wavelength: float = 500e-9
    psf_division_factor: float = 1.0
    resolution: float = 100e-9  # effective pixel size in meters
    output_size: int = 32
    upsampling_factor: int = 5
    background_intensity: Tuple[float, float] = (100.0, 10.0)  # mean, std
    poisson_noise: float = 100.0  # -1 disables; multiplicative Pois(k)/k
    trajectory_unit: float = 100.0  # nm per trajectory unit; -1 = pixels

    @property
    def fwhm_psf(self) -> float:
        return self.wavelength / 2 * self.na / self.psf_division_factor

    @property
    def gaussian_sigma_hr(self) -> float:
        """PSF sigma in high-resolution grid pixels."""
        return self.upsampling_factor / self.resolution * self.fwhm_psf / 2.355

    @property
    def pixels_per_unit(self) -> float:
        """Trajectory-unit → pixel conversion factor."""
        if self.trajectory_unit == -1:
            return 1.0
        return self.trajectory_unit / (self.resolution * 1e9)

    def replace(self, **kw) -> "OpticsConfig":
        return dataclasses.replace(self, **kw)


# The optics of the baseline experiment: real-data-derived intensities.
BASELINE_OPTICS = OpticsConfig(
    particle_intensity=(6000.0 - 1420.0, 500.0),
    psf_division_factor=1.3,
    output_size=9,
    background_intensity=(1420.0, 290.0),
    poisson_noise=100.0,
    trajectory_unit=1200.0,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters shared by the MiViT transformer family."""

    patch_size: int = 9
    embed_dim: int = 64
    num_heads: int = 4
    hidden_dim: int = 128
    num_layers: int = 6
    dropout: float = 0.0
    activation: str = "relu"  # relu | leaky_relu | gelu
    use_pos_encoding: bool = False
    use_regression_token: bool = True
    single_prediction: bool = True
    max_tokens: int = 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Cycle-based training schedule.

    ``adaptive_batch_size``: the batch size starts at ``initial_batch_size``
    and doubles every ``adaptive_batch_size`` cycles; -1 disables doubling
    and uses ``fixed_batch_size``. Fields the JAX package reads only in its
    compiled scan (``scan_unroll``) are kept so configurations compare equal.
    """

    num_cycles: int = 100
    sequences_per_d: int = 64
    training_ds: Tuple[Tuple[float, float], ...] = ((1, 1), (3, 1), (5, 1), (7, 1))
    lr: float = 1e-4
    weight_decay: float = 0.01
    lr_step_cycles: int = 5
    lr_gamma: float = 0.9
    adaptive_batch_size: int = 20
    initial_batch_size: int = 1
    fixed_batch_size: int = 16
    max_batch_size: int = 64  # ceiling of the doubling schedule; 0 = uncapped
    d_max_normalization: float = 10.0
    n_frames: int = 30
    n_pos_per_frame: int = 10
    traj_div_factor: float = 100.0
    center: bool = True
    loss: str = "mse"  # mse | l1
    sequence_mode: bool = False
    mix_trajectories: bool = False
    scan_unroll: int = 1
    compute_dtype: str = "float32"
    seed: int = 0

    @property
    def total_steps_hint(self) -> int:
        n_seq = self.sequences_per_d * len(self.training_ds)
        return self.num_cycles * n_seq

    def batch_size_for_cycle(self, cycle: int) -> int:
        if self.adaptive_batch_size == -1:
            return self.fixed_batch_size
        bs = self.initial_batch_size * (2 ** (cycle // self.adaptive_batch_size))
        return min(bs, self.max_batch_size) if self.max_batch_size else bs

    def lr_for_cycle(self, cycle: int) -> float:
        return self.lr * (self.lr_gamma ** (cycle // self.lr_step_cycles))

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
