"""Carry state across from the JAX package, as numpy arrays.

``to_torch`` turns the fields of a JAX ``FluidState``, ``BoundaryState``,
``GridContext`` or ``PackedSim(packed, ids, au, av)`` (or any mapping of
field name to array) into the port's NamedTuple of tensors on ``device``,
and ``domain_state`` a JAX ``DomainState`` (the flat (d * slab_cap,) slab
arrays, the same layout in both packages); ``to_numpy`` gives the fields
back as numpy arrays (a nested NamedTuple as a nested dict), which the JAX
package's constructors accept; ``frame`` rebuilds the port's relayout
``Frame`` for a layout-fresh JAX state and checks it against the JAX
frame's ``T``, so that both renderers can draw from the same relayout.
Nothing here imports JAX: ``np.asarray`` reads a JAX array through the
buffer protocol.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.engine_v3 import PackedSim
from .ops.grid import GridContext, cell_ids, csr_starts
from .ops.window.triple import Frame, build_frame, start_grid
from .parallel.domain import DomainState
from .state import BoundaryState, FluidState

__all__ = ["to_torch", "to_numpy", "fluid_state", "boundary_state",
           "grid_context", "packed_sim", "domain_state", "frame"]


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def to_torch(cls, src, device):
    """``cls`` (a port NamedTuple) built field by field from ``src``, each
    array keeping its dtype, on ``device``."""
    return cls(*(torch.as_tensor(np.array(_field(src, f)), device=device)
                 for f in cls._fields))


def to_numpy(tree) -> dict:
    """{field: numpy array} of a port NamedTuple of tensors; a field that is
    itself a NamedTuple (``DomainState.fluid``) becomes a nested dict."""
    return {f: to_numpy(t) if hasattr(t, "_fields") else t.detach().cpu().numpy()
            for f, t in zip(tree._fields, tree)}


def fluid_state(src, device) -> FluidState:
    return to_torch(FluidState, src, device)


def boundary_state(src, device) -> BoundaryState:
    return to_torch(BoundaryState, src, device)


def grid_context(src, device) -> GridContext:
    return to_torch(GridContext, src, device)


def packed_sim(src, device) -> PackedSim:
    return to_torch(PackedSim, src, device)


def domain_state(src, device) -> DomainState:
    """The port's ``DomainState`` of a JAX one (fields as ``to_torch``)."""
    return DomainState(fluid=fluid_state(_field(src, "fluid"), device),
                       **{f: torch.as_tensor(np.array(_field(src, f)), device=device)
                          for f in ("ids", "au", "av")})


def frame(engine, sim: PackedSim, src) -> Frame:
    """The port's ``Frame`` for ``sim``, a state the JAX engine left
    layout-fresh (``make_multi_step(return_frame=True)`` at resort_every=1),
    given the port's ``engine`` on the same scene and the JAX frame ``src =
    (trip_src, T)``.  The JAX frame names gathered candidate slots, the
    port's the rows of the state itself, so it is derived anew from the
    state: the live rows' cell ids give the CSR, the CSR the layout's row
    shifts and T as in a relayout.  The T so derived must equal JAX's
    bitwise, or ``sim`` is not the state that frame was built for."""
    cfg, pk = engine.cfg, sim.packed
    cells = torch.where(pk[:, 4] > 0, cell_ids(pk[:, 0], pk[:, 1], cfg),
                        torch.full_like(pk[:, 4], cfg.n_cells, dtype=torch.int32))
    cell_starts = csr_starts(cells, cfg.n_cells + 2)
    _, T, row_shift = build_frame(engine.spec, cfg, cell_starts,
                                  engine.b_cell_starts)
    want = torch.as_tensor(np.array(src[1], np.int32), device=pk.device)
    if not torch.equal(T, want):
        raise ValueError("the state's own T differs from the frame's: the "
                         "frame was not built for this layout-fresh state")
    return Frame(start_grid(cfg, cell_starts, row_shift), T)
