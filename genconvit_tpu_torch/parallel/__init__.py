"""Multi-device on torch.distributed (port of genconvit_tpu/parallel/): one
process per device, the ranks laid out on a ('data', 'model') DeviceMesh;
data parallelism over 'data', tensor parallelism (Megatron splits) over
'model'."""
