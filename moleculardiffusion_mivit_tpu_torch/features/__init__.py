"""Trajectory features: the 25 global features, the per-frame feature
tokens of the modular experiment, and the MSD estimators."""

from moleculardiffusion_mivit_tpu_torch.features.features import (  # noqa: F401
    FEATURE_NAMES,
    N_FEATURES,
    compute_diffusion_features,
    compute_features_for_multiple_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.features.per_frame import (  # noqa: F401
    N_PER_FRAME_FEATURES,
    PER_FRAME_FEATURE_NAMES,
    compute_per_frame_features,
)
from moleculardiffusion_mivit_tpu_torch.features.msd import (  # noqa: F401
    d_from_msd_tau1,
    estimate_d_from_msd,
    estimate_d_from_msds,
    estimate_d_from_msds_polyfit,
    estimate_d_from_msds_weighted,
    mean_square_displacement,
    mean_square_displacements,
)
