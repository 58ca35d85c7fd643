"""Multi-process entry (port of genconvit_tpu/parallel/multihost.py:22-46).

Each rank is one process with one device, PyTorch's idiom: it stands in for
one JAX chip on the mesh's 'data' axis. A launcher such as
`torchrun --nproc-per-node N` sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT; `initialize_multihost()` reads them and starts the process
group. Unlike the JAX function, which logs a failed initialize and carries
on in one process, this one raises: a multi-host job whose init failed
would otherwise score every file on every host.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("genconvit_tpu_torch")

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rank_device() -> torch.device:
    """This rank's device: cuda:LOCAL_RANK on a machine with CUDA, else the
    CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Start the default process group when running multi-process.

    Returns False, and changes nothing, when no argument is given and the
    launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is
    absent, so every CLI works unchanged in one process; True once the group
    is up (also when it already was). coordinator_address: an init method
    ('tcp://host:port', 'file:///path') or 'host:port'; num_processes and
    process_id: the world size and this rank (the environment's otherwise).
    backend: NCCL when the rank's device is CUDA, gloo on the CPU, unless
    given (gloo also takes CUDA tensors for broadcast and all_reduce). On
    CUDA the rank's device (`rank_device`) becomes the current device."""
    explicit = coordinator_address is not None or num_processes is not None \
        or process_id is not None
    if not explicit and not any(k in os.environ for k in LAUNCHER_ENV):
        return False
    if dist.is_initialized():
        return True
    device = rank_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", -1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", -1))
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init, world_size=world, rank=rank)
    log.info("multihost: rank %d/%d on %s (%s)", dist.get_rank(), dist.get_world_size(),
             device, dist.get_backend())
    return True
