"""pi_sph_fluid_tpu_torch: the 2-D WCSPH framework in PyTorch, with
hand-written CUDA kernels for Hopper.

A port of ``pi_sph_fluid_tpu`` (the JAX reference, which stays beside it),
slice by slice.  Ported so far: the production single-chip stepper,
models.engine_v3.WindowEngine, with its density and forces window kernels
(ops/window, csrc/window_kernels.cu); the metaball window renderer with its
field kernel (render/); and the live-simulation path around them, the
SimRunner host loop, its gravity sources and display sinks (io/) and the
``run``/``bench`` CLI (cli.py); the jnp-oracle stepper (models/simulation.py,
``backend="reference"``); the headline bench (bench.py); slab domain
decomposition (parallel/); and the tools of ``tools/`` (tools/): the two
TPU probes redone for the card and the five that ask a question of the
physics or of the card.  This package imports torch and numpy and never
JAX.
"""

from .config import DEFAULT_CONFIG, SPHConfig
from .models.boundary import prepare_boundary
from .models.engine_v3 import PackedSim, WindowEngine
from .io.host_loop import RunResult, SimRunner
from .models.scene import (build_dam_break_scene, build_drop_scene,
                           build_pool_scene, pixel_centers)
from .models.simulation import SimState, StepStats, make_multi_step, make_step, prime
from .render.metaballs import make_renderer, pack_framebuffer, unpack_framebuffer
from .render.metaballs_window import WindowRenderer
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
    "SimState",
    "prime",
    "make_step",
    "make_multi_step",
    "WindowEngine",
    "PackedSim",
    "pixel_centers",
    "make_renderer",
    "pack_framebuffer",
    "unpack_framebuffer",
    "WindowRenderer",
    "SimRunner",
    "RunResult",
]
