"""Tensor ops of the port: activations, norms, convolutions, resize, the
kernel plan, and the hand-written CUDA kernels (ops/cuda)."""
