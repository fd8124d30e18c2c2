"""Carry state across from the JAX package, as numpy arrays.

``to_torch`` turns the fields of a JAX ``FluidState``, ``BoundaryState``,
``GridContext`` or ``PackedSim(packed, ids, au, av)`` (or any mapping of
field name to array) into the port's NamedTuple of tensors on ``device``;
``to_numpy`` gives the fields back as numpy arrays, which the JAX package's
constructors accept; ``frame`` carries an engine's relayout frame
``(trip_src, T)`` across, so that both renderers can draw from the same one.  Nothing here imports JAX: ``np.asarray`` reads a JAX
array through the buffer protocol.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.engine_v3 import PackedSim
from .ops.grid import GridContext
from .state import BoundaryState, FluidState

__all__ = ["to_torch", "to_numpy", "fluid_state", "boundary_state",
           "grid_context", "packed_sim", "frame"]


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def to_torch(cls, src, device):
    """``cls`` (a port NamedTuple) built field by field from ``src``, each
    array keeping its dtype, on ``device``."""
    return cls(*(torch.as_tensor(np.array(_field(src, f)), device=device)
                 for f in cls._fields))


def to_numpy(tree) -> dict:
    """{field: numpy array} of a port NamedTuple of tensors."""
    return {f: t.detach().cpu().numpy() for f, t in zip(tree._fields, tree)}


def fluid_state(src, device) -> FluidState:
    return to_torch(FluidState, src, device)


def boundary_state(src, device) -> BoundaryState:
    return to_torch(BoundaryState, src, device)


def grid_context(src, device) -> GridContext:
    return to_torch(GridContext, src, device)


def packed_sim(src, device) -> PackedSim:
    return to_torch(PackedSim, src, device)


def frame(src, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A JAX ``(trip_src, T)`` relayout frame as the port's int32 tensors."""
    trip_src, T = src
    return (torch.as_tensor(np.array(trip_src, np.int32), device=device),
            torch.as_tensor(np.array(T, np.int32), device=device))
