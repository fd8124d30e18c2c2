"""The one generator of traffic: it reads a traffic mix's parameters (a JSON
file under traffic/) and makes the gravity the cell feeds the port.

A mix's ``gravity`` is ``{"kind": "constant", "g": [gx, gy]}``, the
desktop build's setting without an accelerometer (pi_sph_fluid.c:441-444),
handed to the port as its own ``io.gravity.ConstantGravity``.
"""

from __future__ import annotations

__all__ = ["make_gravity"]


def make_gravity(traffic: dict, seed: int, port_gravity, port_cfg):
    """The port's gravity source for this mix; ``port_gravity`` is the
    port's io.gravity module and ``port_cfg`` its SPHConfig."""
    grav = traffic["gravity"]
    if grav["kind"] == "constant":
        gx, gy = grav["g"]
        return port_gravity.ConstantGravity(port_cfg, gx, gy)
    raise ValueError(f"unknown gravity kind {grav['kind']!r}")
