"""Training over a data × model mesh of ranks on ``torch.distributed``
(``mesh``: the ranks, the grid's placement and each rank's part of a
cycle's generation; ``steps``: sharded grid training and evaluation;
``collectives``: the sums and gathers over ranks and the split of a
minibatch)."""

from moleculardiffusion_mivit_tpu_torch.parallel.collectives import gather_part  # noqa: F401
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import (  # noqa: F401
    GenerationPart,
    Mesh,
    generation_part,
    grid_sharding,
    initialize_distributed,
    make_mesh,
    part_units,
    shard_grid,
)
from moleculardiffusion_mivit_tpu_torch.parallel.steps import (  # noqa: F401
    dp_batch_constraint,
    grid_batch_constraint,
    make_sharded_cycle_program,
    make_sharded_grid_fns,
    make_sharded_grid_step,
)
