"""The port's microbenchmark tools, one per probe kernel of ops/cuda (M1
int8_dot, M2 block_parts, M3 dw_moments): each times its kernel with CUDA
events beside its plain version, as the JAX package's tools of the same
names time their Pallas kernels. Run from the repository root, e.g.

    python3 -m genconvit_tpu_torch.tools.microbench_dwshift [--device cpu]

They run on cuda:0 unless --device names another device; on the CPU the
wrappers run their plain versions and the times are host-clock times of
PyTorch's CPU kernels, never device times."""
