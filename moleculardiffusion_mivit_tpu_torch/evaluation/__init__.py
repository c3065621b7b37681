from moleculardiffusion_mivit_tpu_torch.evaluation.validation import (  # noqa: F401
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    build_in_order_data,
    error_table,
    generate_frozen_validation,
    generate_in_order_imft,
    load_reference_validation,
    load_validation_trajectories,
    render_validation_videos,
    save_error_table_csv,
)
from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint import (  # noqa: F401
    detect_change_points,
    score_planted,
    wilson_ci,
)
