"""The port's entry points on the CPU (pi_sph_fluid_tpu_torch/dryrun.py, the
counterpart of __graft_entry__.py), with the profiling and native-library
helpers they sit beside: ``trace``, ``device_memory``, ``native_available``."""

import json

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import dryrun
from pi_sph_fluid_tpu_torch.io import native
from pi_sph_fluid_tpu_torch.utils.profiling import device_memory, trace
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

torch.set_num_threads(1)


def test_entry_steps_the_drop_through_the_plain_versions():
    """One tick of the drop through WindowEngine on the CPU: the kernels'
    plain versions, no launch, every particle moved by gravity alone."""
    keys = ("kernel.density.launches", "kernel.forces.launches")
    before = [tracer.counters.get(k, 0) for k in keys]
    fn, (sim, g) = dryrun.entry("cpu")
    sim2, st = fn(sim, g)
    assert [tracer.counters.get(k, 0) for k in keys] == before
    assert int(st.neighbor_overflow) == 0 and float(st.max_speed) > 0
    assert sim2.packed.shape == sim.packed.shape
    assert bool(torch.isfinite(sim2.packed).all())
    live = sim2.packed[:, 4] > 0
    assert int(live.sum()) == 269
    assert bool((sim2.packed[live, 1] < sim.packed[live, 1]).all())


def test_dryrun_multislab_four_slabs():
    dryrun.dryrun_multislab(4, "cpu")


def test_dryrun_multiprocess_two_by_two():
    dryrun.dryrun_multiprocess(2, 2, "cpu", timeout=240)


def test_dryrun_multiprocess_raises_when_a_worker_fails():
    """A worker that exits non-zero (here: NCCL asked for on the CPU, which
    cannot start) fails the dry run with its output; nothing is caught."""
    with pytest.raises(RuntimeError, match="worker"):
        dryrun.dryrun_multiprocess(2, 2, "cpu", backend="nccl", timeout=240)


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with trace(str(path)) as p:
        fn, args = dryrun.entry("cpu")
        fn(*args)
    assert p == str(path)
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_device_memory_is_empty_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert device_memory() == {}


def test_native_available_is_whether_the_library_loads():
    assert native.native_available() == (native.load() is not None)
    fb = np.zeros(1024, np.uint8)
    assert isinstance(native.blit_halfblocks(fb, 64, 128), str)
    assert T.unpack_framebuffer(fb).shape == (64, 128)
