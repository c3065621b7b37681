"""Weight conversion, random-number helpers, metrics logging, checkpoints,
FLOP accounting and profiling hooks."""

from moleculardiffusion_mivit_tpu_torch.utils.checkpoint import (  # noqa: F401
    restore_experiment,
    save_experiment,
)
from moleculardiffusion_mivit_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.utils.flops import (  # noqa: F401
    device_peak_flops,
    grid_cycle_flops,
    multi_cycle_flops,
    utilization,
)
from moleculardiffusion_mivit_tpu_torch.utils.profiling import profile_trace, time_block  # noqa: F401
