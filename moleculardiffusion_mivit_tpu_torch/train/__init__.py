from moleculardiffusion_mivit_tpu_torch.train.loop import (  # noqa: F401
    TrainImpls,
    TrainState,
    generate_cycle_data,
    make_optimizer,
    make_train_impls,
    run_training,
)
