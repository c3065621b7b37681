"""Training over a data × model mesh of ranks on ``torch.distributed``
(``mesh``: the ranks and the grid's placement; ``steps``: sharded grid
training and evaluation; ``collectives``: the sums over ranks and the split
of a minibatch)."""

from moleculardiffusion_mivit_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    grid_sharding,
    initialize_distributed,
    make_mesh,
    shard_grid,
)
from moleculardiffusion_mivit_tpu_torch.parallel.steps import (  # noqa: F401
    dp_batch_constraint,
    grid_batch_constraint,
    make_sharded_cycle_program,
    make_sharded_grid_fns,
    make_sharded_grid_step,
)
