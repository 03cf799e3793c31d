"""Hand-written CUDA kernels (sources in ``learned_hologram_gan_tpu_torch/csrc``)."""
