"""Slab domain decomposition (port of `pi_sph_fluid_tpu/parallel/`): the
communication layer (comm.py), the oracle decomposition over the jnp-oracle
passes (domain.py) and the window-kernel decomposition (domain_window.py).
All slabs run in one process through ``LocalComm``."""

from .comm import Comm, LocalComm
from .domain import DomainDecomposition, DomainState
from .domain_window import WindowDomain

__all__ = ["Comm", "LocalComm", "DomainState", "DomainDecomposition", "WindowDomain"]
