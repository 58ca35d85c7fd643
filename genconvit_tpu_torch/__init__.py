"""genconvit_tpu_torch — the PyTorch/CUDA port of genconvit_tpu.

The JAX package `genconvit_tpu` stays the reference; this package imports
`torch` and never `jax` or `genconvit_tpu`. Models are `nn.Module`s whose
state_dict keys are the reference checkpoints' own (timm ConvNeXt names,
`encoder.features.*`, ...). Activations are logically NCHW, held in
`torch.channels_last` memory, so a `[N,C,H,W]` tensor's NHWC view is
contiguous and the hand-written CUDA kernels (csrc/) read it as `[R, C]`
rows with no copy. Public functions take the JAX package's NHWC layout.

Nothing builds or loads at import: the CUDA kernels are compiled with
nvcc at first launch (ops/cuda/_build.py).
"""

__version__ = "0.1.0"

from genconvit_tpu_torch.config import Config, ModelConfig  # noqa: F401
