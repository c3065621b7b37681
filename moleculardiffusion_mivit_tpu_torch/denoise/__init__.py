from moleculardiffusion_mivit_tpu_torch.denoise.rl_tv import (  # noqa: F401
    apply_rl_tv_batch,
    apply_rl_tv_iter_list_batch,
    create_gaussian_psf,
    fft_convolve_same,
    richardson_lucy_tv,
    richardson_lucy_tv_iter_list,
    trajs_to_vid_norm_rl,
    tv_gradient,
)
