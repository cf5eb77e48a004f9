"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module's wrapper takes CPU tensors to the plain version and
CUDA tensors to the kernel, and counts its launches in ``launches``.
"""
