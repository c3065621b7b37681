from moleculardiffusion_mivit_tpu_torch.evaluation.validation import (  # noqa: F401
    IN_ORDER_D_VALUES,
    error_table,
    generate_frozen_validation,
    load_reference_validation,
    load_validation_trajectories,
    render_validation_videos,
    save_error_table_csv,
)
