"""The exchanges of slab domain decomposition (the port's counterpart of
the collectives the JAX package calls inside ``shard_map``:
`pi_sph_fluid_tpu/parallel/domain.py:109-127` and its ``psum`` / ``pmax``).

A decomposed step is written as phases over a list of per-slab tensors,
one entry for each slab this process holds (``comm.slabs``, global slab
indices in order); every exchange between two phases goes through one
``Comm``:

* ``shift(per_slab, direction)`` is the ``ppermute`` of `_perm_lists`:
  with +1 slab i's buffer lands on slab i+1 and slab 0 receives zeros, with
  -1 slab i's lands on slab i-1 and the last slab receives zeros.  A slab
  buffer of zeros is inert in every pair sum, because its rows have m = 0;
* ``all_sum(per_slab)`` and ``all_max(per_slab)`` reduce across all d
  slabs into one tensor of the slabs' shape and dtype, on their device (no
  host read).  An integer sum wraps as the dtype does: sum counts that can
  be large in int64 (parallel/domain.py::saturating_sum);
* ``all_gather(per_slab)`` is all d slabs' buffers concatenated in slab
  order, on every slab (the per-slab render's composed field, the
  whole state of ``gather`` / ``export``).  Every slab's buffer has the
  same shape.

``LocalComm(d)`` holds all d slabs in one process, on one device, and does
all four by list rotation, ``torch.stack`` and ``torch.cat``.
``DistComm(d)`` holds ``d / world_size`` consecutive slabs in each process
of a ``torch.distributed`` group (parallel/launch.py starts one), rotates
inside the process and sends the two edge buffers to the neighbouring
ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Comm", "LocalComm", "DistComm"]


class Comm:
    """The interface a decomposed step exchanges through: ``d`` slabs in
    all, of which this process holds ``slabs`` (a range of global slab
    indices); every ``per_slab`` list has ``len(slabs)`` entries."""

    d: int
    slabs: range

    def _check(self, per_slab: list) -> None:
        if len(per_slab) != len(self.slabs):
            raise ValueError(f"{len(per_slab)} buffers for {len(self.slabs)} slabs")

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
        self.slabs = range(self.d)

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


class DistComm(LocalComm):
    """The ``d // world_size`` consecutive slabs of this rank of a
    ``torch.distributed`` group (the default group when ``group`` is None);
    raises when ``d`` is not a multiple of the group's size.

    Inside the rank the exchanges are ``LocalComm``'s; across ranks a shift
    sends the edge slab's buffer to rank +-1 and receives the neighbour's
    with ``batch_isend_irecv`` (the end ranks' end slabs receive zeros), a
    reduction reduces the local slabs and then ``all_reduce``s, and a gather
    concatenates the local slabs and ``all_gather``s in rank order.  The
    callers size every exchanged buffer by a capacity, never by content, so
    the shapes agree across ranks and no size is exchanged.

    Transport is the group's backend, never guessed: NCCL moves CUDA
    tensors, one process per card.  Gloo moves CPU tensors; given CUDA
    tensors (several processes on one card, where NCCL refuses a second
    rank on the same device), this class stages each buffer through host
    memory, ``.cpu()`` before the call and ``.to(device)`` after it, and
    adds the bytes copied each way to ``staged_bytes``.  Under NCCL nothing
    is staged; a CPU tensor or a card shared by two ranks fails with NCCL's
    own error."""

    def __init__(self, d: int, group=None):
        self.group = group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if d < 1 or d % world:
            raise ValueError(f"{d} slabs do not split evenly over {world} processes")
        self.d, self.world, self.rank = int(d), world, rank
        per = self.d // world
        self.slabs = range(rank * per, (rank + 1) * per)
        self._stage = dist.get_backend(group) == "gloo"
        self.staged_bytes = 0

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it (contiguous; on the host for gloo)."""
        t = t.contiguous()
        if self._stage and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if t.device != like.device:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    def _global_rank(self, r: int) -> int:
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def shift(self, per_slab: list, direction: int) -> list:
        local = super().shift(per_slab, direction)
        if direction > 0:
            edge, peer_to, peer_from, at = per_slab[-1], self.rank + 1, self.rank - 1, 0
        else:
            edge, peer_to, peer_from, at = per_slab[0], self.rank - 1, self.rank + 1, -1
        ops, recv = [], None
        if 0 <= peer_to < self.world:
            ops.append(dist.P2POp(dist.isend, self._out(edge),
                                 self._global_rank(peer_to), self.group))
        if 0 <= peer_from < self.world:
            recv = torch.empty(edge.shape, dtype=edge.dtype,
                               device="cpu" if self._stage else edge.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._global_rank(peer_from),
                                 self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if recv is not None:
            local[at] = self._back(recv, edge)
        return local

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        buf = self._out(t)
        dist.all_reduce(buf, op=op, group=self.group)
        return self._back(buf, t)

    def all_sum(self, per_slab: list) -> torch.Tensor:
        return self._all_reduce(super().all_sum(per_slab), dist.ReduceOp.SUM)

    def all_max(self, per_slab: list) -> torch.Tensor:
        return self._all_reduce(super().all_max(per_slab), dist.ReduceOp.MAX)

    def all_gather(self, per_slab: list) -> torch.Tensor:
        mine = super().all_gather(per_slab)
        buf = self._out(mine)
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf, group=self.group)
        return self._back(torch.cat(parts), mine)
