"""Hand-written CUDA kernels: nvcc build and ctypes loader (_build), and
the kernel wrappers with their plain PyTorch versions."""
