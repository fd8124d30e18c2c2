"""pi_sph_fluid_tpu_torch: the 2-D WCSPH framework in PyTorch, with
hand-written CUDA kernels for Hopper.

A port of ``pi_sph_fluid_tpu`` (the JAX reference, which stays beside it),
slice by slice.  The first slice is the production single-chip stepper,
models.engine_v3.WindowEngine, with its density and forces window kernels
(ops/window, csrc/window_kernels.cu).  This package imports torch and
numpy and never JAX.
"""

from .config import DEFAULT_CONFIG, SPHConfig
from .models.boundary import prepare_boundary
from .models.engine_v3 import PackedSim, WindowEngine
from .models.scene import build_dam_break_scene, build_drop_scene, build_pool_scene
from .models.simulation import StepStats
from .state import BoundaryState, FluidState, load_state, save_state

__all__ = [
    "SPHConfig",
    "DEFAULT_CONFIG",
    "FluidState",
    "BoundaryState",
    "save_state",
    "load_state",
    "build_drop_scene",
    "build_dam_break_scene",
    "build_pool_scene",
    "prepare_boundary",
    "StepStats",
    "WindowEngine",
    "PackedSim",
]
