"""Weight conversion, random-number helpers, metrics logging and
checkpoints."""

from moleculardiffusion_mivit_tpu_torch.utils.checkpoint import (  # noqa: F401
    restore_experiment,
    save_experiment,
)
from moleculardiffusion_mivit_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
