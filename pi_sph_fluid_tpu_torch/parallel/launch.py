"""Launch plumbing for slab decomposition over several processes (port of
`pi_sph_fluid_tpu/parallel/launch.py:35-77`).

Every process runs the same program.  ``init_distributed`` joins them into
one ``torch.distributed`` group; a ``WindowDomain`` over
``DistComm(slabs)`` (parallel/comm.py) then holds ``slabs / processes``
consecutive slabs in each process, and the slab edges between processes
exchange over the group.

    # process 0 (its address is the coordinator):
    python -m pi_sph_fluid_tpu_torch.cli run --backend window-dd --slabs 8 \\
        --num-processes 2 --process-id 0 --coordinator 10.0.0.1:29500 --device cuda:0
    # process 1: the same command with --process-id 1 (and its own card)

Transport: NCCL for CUDA tensors, one process per card (the default for a
CUDA device); gloo for CPU tensors (the default for the CPU).  Several
processes on one card pass gloo explicitly, and ``DistComm`` stages each
exchanged buffer through host memory.  NCCL refuses two ranks on one card.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multiprocess", "process_index", "to_host"]


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None, timeout: int = 300,
                     device="cpu") -> str:
    """Join (or, for process 0, start) the process group; returns the
    backend.  ``coordinator`` is process 0's ``HOST:PORT`` (a ``tcp://``
    rendezvous) or a ``file://`` URL of a file every process can reach
    (which needs no free port); every process passes the same value.
    ``backend`` None picks gloo for a CPU ``device`` and NCCL for a CUDA
    one; under NCCL a ``device`` with an index (``cuda:N``) becomes the
    process's current card."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.index is not None:
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout))
    return backend


def is_multiprocess() -> bool:
    """Whether a process group of more than one process is up."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank in the group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def to_host(t: torch.Tensor) -> np.ndarray:
    """Every process's ``t`` concatenated along dim 0 in rank order, as host
    numpy on every process (an ``all_gather``; each process's ``t`` has the
    same shape).  Without a process group, ``t`` itself."""
    t = t.detach()
    if not is_multiprocess():
        return t.cpu().numpy()
    if dist.get_backend() == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts).cpu().numpy()
