"""What a driver gets (`Context`) and gives back (`Outcome`), and the port's
objects built from a configuration file."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Optional

from perfbench.core.compare import Checks
from perfbench.core.trace import TraceSummary


@dataclasses.dataclass
class Context:
    cell: Dict[str, Any]          # registry.cell(): name, workload, config, traffic
    seed: int
    seconds: float
    trace: bool
    device: Any                   # torch.device
    t0: float                     # perf_counter at process start
    fp8_control: bool = False     # judge the fp8 reference in the program's place

    @property
    def cfg(self) -> Dict[str, Any]:
        return self.cell["config"]

    @property
    def mix(self) -> Dict[str, Any]:
        return self.cell["traffic"]

    @property
    def wl(self) -> Dict[str, Any]:
        return self.cell["workload"]

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f}s] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Readings:
    """What per-layer readers read: the untraced window's counts, the traced
    slice, and how much model work the slice held."""
    cell: Dict[str, Any]
    window: Dict[str, float]                       # seconds, videos, images, launches, ...
    trace: Optional[TraceSummary] = None
    slice_units: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Checks
    readings: Readings
    group: Callable[[str], str]                    # kernel name -> layer group
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)   # every one compared


def kernel_plan(ctx: Context):
    from genconvit_tpu_torch.ops.kernel_plan import KernelPlan

    return KernelPlan(**ctx.cfg["kernel_plan"])


def port_config(cfg: Dict[str, Any]):
    """The port's Config of a configuration file."""
    from genconvit_tpu_torch.config import Config, ModelConfig

    return Config(img_size=cfg["img_size"], model=ModelConfig(
        backbone=cfg["backbone"], latent_dims=cfg["latent_dims"], vae_variant="original"))


def dtype(cfg: Dict[str, Any]):
    import torch

    return getattr(torch, cfg["dtype"])


def predictor(ctx: Context, sds, eps_seed: int, deterministic: bool):
    """The port's Predictor on the benchmark's weights: no face detector
    (every cell hands it faces), the configuration's kernel plan and dtype,
    the VAE's draws from `eps_seed` (or none)."""
    from genconvit_tpu_torch.infer.engine import Predictor

    return Predictor(port_config(ctx.cfg), net="genconvit", device=ctx.device, params=sds,
                     seed=eps_seed, deterministic_vae=deterministic,
                     kernel_plan=kernel_plan(ctx), dtype=dtype(ctx.cfg),
                     face_backend="fullframe", backbone_classes=ctx.cfg["backbone_classes"])


def free_device(torch) -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(torch, device) -> int:
    if getattr(device, "type", str(device)) != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
