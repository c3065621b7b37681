"""Simulation and rendering, as the JAX package's ``sim``: trajectories
(Brownian, fBm, drift, confinement), constrained geometries, the renderers.

JAX's ``set_render_backend`` has no counterpart: here the tensor's device
picks the route (K1 for CUDA tensors, its plain version for CPU tensors).
"""

from moleculardiffusion_mivit_tpu_torch.sim.trajectory import (  # noqa: F401
    average_trajectories_frames,
    brownian_motion,
    fbm_trajectories,
    fractional_gaussian_noise,
    reflect_into_box,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.sim.render import (  # noqa: F401
    generate_images_legacy,
    generate_traj_and_videos_brownian,
    normalize_images,
    render_frames_core,
    render_videos,
    render_videos_blocks,
    render_videos_many,
    render_widefield,
    render_widefield_panel,
    trajectories_to_video,
    trajectories_to_videos,
    trajectories_to_video_multiple_settings,
    trajectories_to_video_psf_noise_grid,
)
from moleculardiffusion_mivit_tpu_torch.sim.constrained import (  # noqa: F401
    Edge,
    PiecewiseLinearGeometry,
    disp_fbm,
    reflected_rectangle_trajectories,
)
