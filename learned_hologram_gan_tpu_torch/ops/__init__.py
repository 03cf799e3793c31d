"""Propagation operators: ASM on torch.fft, masks, and the CUDA kernels."""
