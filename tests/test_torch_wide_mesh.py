"""16 and 32 slabs in one process on the CPU (the port's counterpart of
tests/test_wide_mesh.py): the whole dry run, the oracle decomposition,
WindowDomain exact and sticky, the export into grown capacities and the
per-slab render, on the wide shallow pool that gives every slab the 6
owned columns two 3-cell halo strips need."""

import pytest
import torch

from pi_sph_fluid_tpu_torch import dryrun

torch.set_num_threads(1)


@pytest.mark.parametrize("n_slabs", [16, 32])
def test_wide_slab_dryrun(n_slabs):
    cfg, fluid, _ = dryrun._dryrun_scene(n_slabs, "cpu")
    assert cfg.n_cell_cols >= 6 * n_slabs and fluid.n > 0
    dryrun.dryrun_multislab(n_slabs, "cpu")
