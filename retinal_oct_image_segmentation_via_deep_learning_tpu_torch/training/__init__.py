"""Training: losses, optimizers, data, checkpoints, the trainer, and the
U-Net's training forward on the CUDA kernels (``packed_unet.py``)."""
