"""Slab domain decomposition (port of `pi_sph_fluid_tpu/parallel/`): the
communication layer (comm.py: ``LocalComm`` for all slabs in one process,
``DistComm`` for a process's share over ``torch.distributed``), the launch
plumbing (launch.py), the oracle decomposition over the jnp-oracle passes
(domain.py) and the window-kernel decomposition (domain_window.py)."""

from .comm import Comm, DistComm, LocalComm
from .domain import DomainDecomposition, DomainState
from .domain_window import WindowDomain

__all__ = ["Comm", "DistComm", "LocalComm", "DomainState", "DomainDecomposition",
           "WindowDomain"]
