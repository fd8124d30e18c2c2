"""The exchanges of slab domain decomposition (the port's counterpart of
the collectives the JAX package calls inside ``shard_map``:
`pi_sph_fluid_tpu/parallel/domain.py:109-127` and its ``psum`` / ``pmax``).

A decomposed step is written as phases over a list of per-slab tensors,
slab i at index i; every exchange between two phases goes through one
``Comm``:

* ``shift(per_slab, direction)`` is the ``ppermute`` of `_perm_lists`:
  with +1 slab i's buffer lands on slab i+1 and slab 0 receives zeros, with
  -1 slab i's lands on slab i-1 and the last slab receives zeros.  A slab
  buffer of zeros is inert in every pair sum, because its rows have m = 0;
* ``all_sum(per_slab)`` and ``all_max(per_slab)`` reduce across slabs into
  one tensor of the slabs' shape and dtype, on their device (no host read).
  An integer sum wraps as the dtype does: sum counts that can be large in
  int64 (parallel/domain.py::saturating_sum);
* ``all_gather(per_slab)`` is the slabs' buffers concatenated in slab
  order, on every slab (the per-slab render's composed field).

``LocalComm(d)`` holds all d slabs in one process, on one device, and does
all four by list rotation, ``torch.stack`` and ``torch.cat``.  A
communicator across processes implements the same four methods.
"""

from __future__ import annotations

import torch

__all__ = ["Comm", "LocalComm"]


class Comm:
    """The interface a decomposed step exchanges through; ``d`` slabs."""

    d: int

    def shift(self, per_slab: list, direction: int) -> list:
        raise NotImplementedError

    def all_sum(self, per_slab: list) -> torch.Tensor:
        raise NotImplementedError

    def all_max(self, per_slab: list) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, per_slab: list) -> torch.Tensor:
        raise NotImplementedError


class LocalComm(Comm):
    """All ``d`` slabs in this process: exchanges are list operations."""

    def __init__(self, d: int):
        if d < 1:
            raise ValueError(f"need at least one slab, got {d}")
        self.d = int(d)

    def _check(self, per_slab: list) -> None:
        if len(per_slab) != self.d:
            raise ValueError(f"{len(per_slab)} buffers for {self.d} slabs")

    def shift(self, per_slab: list, direction: int) -> list:
        self._check(per_slab)
        zero = torch.zeros_like(per_slab[0])
        if direction > 0:
            return [zero] + list(per_slab[:-1])
        if direction < 0:
            return list(per_slab[1:]) + [zero]
        raise ValueError("direction must be +1 or -1")

    def all_sum(self, per_slab: list) -> torch.Tensor:
        self._check(per_slab)
        return torch.stack(per_slab).sum(0, dtype=per_slab[0].dtype)

    def all_max(self, per_slab: list) -> torch.Tensor:
        self._check(per_slab)
        return torch.stack(per_slab).amax(0)

    def all_gather(self, per_slab: list) -> torch.Tensor:
        self._check(per_slab)
        return torch.cat(per_slab)
