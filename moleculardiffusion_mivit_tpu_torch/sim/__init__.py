from moleculardiffusion_mivit_tpu_torch.sim.trajectory import (  # noqa: F401
    average_trajectories_frames,
    brownian_motion,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.sim.render import (  # noqa: F401
    normalize_images,
    render_frames_core,
    trajectories_to_video,
)
