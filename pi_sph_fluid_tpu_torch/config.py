"""Static simulation configuration (port of `pi_sph_fluid_tpu/config.py:28-120`).

A frozen dataclass of the reference constants (`pi_sph_fluid.c:10-21`).
Every derived constant is rounded through float32 exactly as the JAX
package rounds it (`config.py:62-114`), so both packages see the same bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["SPHConfig", "DEFAULT_CONFIG"]


def _f32(x: float) -> float:
    """Round a python float through float32, so derived constants match C."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    """All static parameters of a 2-D WCSPH simulation.

    Defaults replicate the reference constants (`pi_sph_fluid.c:10-21`):
    R=0.075 m spacing, H=1.3R, 4x2 m domain, rho0=1000, c=400 m/s, g=9.81.
    """

    r: float = 0.075
    h_factor: float = 1.3
    width: float = 4.0
    height: float = 2.0
    rho_0: float = 1000.0
    c: float = 400.0
    g: float = 9.81
    dt_factor: float = 1.0
    v_factor: float = 0.57

    alpha_visc: float = 0.01
    eps_visc: float = 0.01
    k_artificial_pressure: float = 0.1
    q_artificial_pressure: float = 0.2
    artificial_pressure_power: int = 4

    row_span_cap: int = 32
    cell_cap: int = 16

    @property
    def h(self) -> float:
        """Smoothing length, H = 1.3*R (`pi_sph_fluid.c:12`)."""
        return _f32(np.float32(self.r) * np.float32(self.h_factor))

    @property
    def dt(self) -> float:
        """Time step, DT = dt_factor*H/C (`pi_sph_fluid.c:19`)."""
        return _f32(np.float32(self.dt_factor) * np.float32(self.h) / np.float32(self.c))

    @property
    def particle_volume(self) -> float:
        """V = 0.57*H*H (`pi_sph_fluid.c:20`)."""
        return _f32(np.float32(self.v_factor) * np.float32(self.h) * np.float32(self.h))

    @property
    def particle_mass(self) -> float:
        """Fluid particle mass m = RHO_0*V (`pi_sph_fluid.c:502`)."""
        return _f32(np.float32(self.rho_0) * np.float32(self.particle_volume))

    @property
    def support_radius(self) -> float:
        """Kernel support = 2H (`pi_sph_fluid.c:144`)."""
        return _f32(2.0 * np.float32(self.h))

    @property
    def kernel_norm(self) -> float:
        """Wendland C2 2-D normalisation 7/(4*pi*H^2) (`pi_sph_fluid.c:46`)."""
        return _f32(7.0 / (4.0 * math.pi * float(self.h) * float(self.h)))

    @property
    def tait_b(self) -> float:
        """Tait EOS stiffness B = C^2*RHO_0/7 (`pi_sph_fluid.c:297`)."""
        return _f32(np.float32(self.c) * np.float32(self.c) * np.float32(self.rho_0) / np.float32(7.0))

    @property
    def cell_length(self) -> float:
        """Hash-grid cell edge = 2H (`pi_sph_fluid.c:596`)."""
        return self.support_radius

    @property
    def n_cell_rows(self) -> int:
        """Number of grid rows (`pi_sph_fluid.c:93`)."""
        return int((np.float32(self.height) - np.float32(0.0)) / np.float32(self.cell_length)) + 1

    @property
    def n_cell_cols(self) -> int:
        """Number of grid cols (`pi_sph_fluid.c:94`)."""
        return int((np.float32(self.width) - np.float32(0.0)) / np.float32(self.cell_length)) + 1

    @property
    def n_cells(self) -> int:
        return self.n_cell_rows * self.n_cell_cols

    def replace(self, **kwargs) -> "SPHConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = SPHConfig()
