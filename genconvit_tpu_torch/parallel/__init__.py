"""Data-parallel multi-device on torch.distributed (port of
genconvit_tpu/parallel/): one process per device, the ranks laid out on a
('data', 'model') DeviceMesh. Tensor parallelism is not ported yet."""
