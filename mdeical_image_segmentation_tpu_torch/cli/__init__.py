"""Command-line entry points of the port."""


def pin_fp32_precision(logger) -> None:
    """float32 convolutions and matmuls in full float32 (TF32 off), as the
    JAX package computes them, logged.  torch's default lets cuDNN run
    float32 convolutions in TF32, which moves the first step's gradient
    norm of ``configs/unet3d_train.yml``'s UNet3D by 5e-4 to 1e-3 relative
    on an H100, ten times the port's limit (PERF.md §7, F7)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    logger.info("precision: float32 convolutions and matmuls in full float32 "
                "(cuDNN and cuBLAS TF32 off)")
