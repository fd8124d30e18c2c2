"""The plain reference that decides `correct`: WCSPH in plain PyTorch after
the upstream C source (pi_sph_fluid.c), with its own neighbour lists, its
own boundary pseudo-masses and its own renderer.  It imports neither JAX
nor any package of this repository."""

from .sph import Physics, Reference, pack_pages, pair_list

__all__ = ["Physics", "Reference", "pack_pages", "pair_list"]
