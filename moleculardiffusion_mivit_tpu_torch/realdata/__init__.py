"""The real-data pipeline: TIFF stacks → detect → track → patches →
localise → per-track D (port of ``moleculardiffusion_mivit_tpu/realdata``;
``realdata.viz`` holds its plots, matplotlib imported inside them). ``python -m
moleculardiffusion_mivit_tpu_torch.realdata.demo`` drives it end to end."""

from moleculardiffusion_mivit_tpu_torch.realdata.detect import detect_particles, detect_particles_stack  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.realdata.link import link_particles  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.realdata.track import track_particles  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.realdata.patches import extract_particle_patches  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.realdata.localize import refine_localizations  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.realdata.stats import (  # noqa: F401
    compute_displacement,
    tracks_to_dataframe,
)
from moleculardiffusion_mivit_tpu_torch.realdata.pipeline import (  # noqa: F401
    analyze_microscopy_sequence,
    estimate_d_for_tracks,
)
from moleculardiffusion_mivit_tpu_torch.realdata.tiff import read_tiff_stack, write_tiff_stack  # noqa: F401
