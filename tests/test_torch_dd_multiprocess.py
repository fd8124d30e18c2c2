"""Slab decomposition over several processes on the CPU (gloo, a file
store in the test's temporary directory): ``DistComm`` against
``LocalComm``, the worker pair of pi_sph_fluid_tpu_torch/tools/
multihost_worker.py against the same sequence in one process (bitwise, as
tests/test_multihost.py:73-108 holds JAX's), and the CLI's launch flags
(`cli.py:103-124,268-276`)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pi_sph_fluid_tpu_torch import cli
from pi_sph_fluid_tpu_torch.parallel import LocalComm
from pi_sph_fluid_tpu_torch.tools import multihost_worker

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
# what the runner says when it recovers or changes its sticky period
RECOVERY = ("OVERFLOW", "WINDOW OVERFLOW", "STALE DRIFT:", "RESORT LADDER")

# Each script ends by destroying its process group, as cli.py and the
# worker do: a gloo group left to interpreter exit is torn down after
# Python's last frame, and under load that teardown now and then aborts the
# process ("terminate called without an active exception", exit -6) after
# its results are written.
COMM_SCRIPT = """
import sys
import numpy as np, torch
from pi_sph_fluid_tpu_torch.parallel import DistComm
from pi_sph_fluid_tpu_torch.parallel.launch import (init_distributed, is_multiprocess,
                                                    process_index, to_host)
rank, url, out, data, device, backend = int(sys.argv[1]), *sys.argv[2:7]
assert not is_multiprocess() and process_index() == 0
assert init_distributed(url, 2, rank, backend=backend, device=device, timeout=60) == backend
assert is_multiprocess() and process_index() == rank
comm = DistComm(4)
res = {"slabs": np.asarray(comm.slabs)}
for name, t in np.load(data).items():
    per = [torch.from_numpy(t[s]).to(device) for s in comm.slabs]
    for direction in (1, -1):
        got = comm.shift(per, direction)
        assert all(g.device == per[0].device for g in got)
        res[f"{name}_shift{direction}"] = torch.stack(got).cpu().numpy()
    res[f"{name}_sum"] = comm.all_sum(per).cpu().numpy()
    res[f"{name}_max"] = comm.all_max(per).cpu().numpy()
    res[f"{name}_gather"] = comm.all_gather(per).cpu().numpy()
res["to_host"] = to_host(torch.arange(3, device=device) + 10 * rank)
try:
    DistComm(3)
except ValueError:
    res["odd_refused"] = np.ones(1)
res["staged"] = np.asarray(comm.staged_bytes)
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""

ORACLE_SCRIPT = """
import sys
import numpy as np
import torch
import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.parallel import DistComm, DomainDecomposition
from pi_sph_fluid_tpu_torch.parallel.launch import init_distributed
rank, url, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(url, 2, rank, device="cpu", timeout=60)
cfg = T.SPHConfig()
fluid, braw = T.build_dam_break_scene(cfg, "cpu")
b, bg = T.prepare_boundary(braw, cfg)
dd = DomainDecomposition(cfg, b, bg, fluid.n, DistComm(4), "cpu")
step = dd.make_step()
state = dd.init(fluid)
for _ in range(3):
    state, st = step(state, (0.0, -9.81))
fl = dd.gather(state)
np.savez(out, n_valid=int(st["n_valid"]), overflow=int(st["overflow"]),
         **{f: getattr(fl, f).numpy() for f in type(fl)._fields})
torch.distributed.destroy_process_group()
"""


def _spawn(argv_of, n: int = 2, ok: bool = True) -> list:
    """Start ``python argv_of(i)`` for i < n from the repository root, wait
    for all (killing all at TIMEOUT, which raises); their (stdout, stderr).
    With ``ok`` every one must exit 0, else every one must exit non-zero."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv_of(i)], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert (p.returncode == 0) == ok, \
            f"process {i} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}"
    return outs


def comm_script(tmp_path, device: str, backend: str = "gloo", ok: bool = True) -> list:
    """COMM_SCRIPT as 2 processes x 2 slabs on ``device`` over ``backend``,
    on seeded buffers (written to ``tmp_path``); the processes' (stdout,
    stderr) (``ok``: as _spawn)."""
    rng = np.random.default_rng(11)
    data = {"f32": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "i64": rng.integers(-2**40, 2**40, size=(4, 6))}
    np.savez(tmp_path / "in.npz", **data)
    url = (tmp_path / "store").as_uri()
    return _spawn(lambda i: ["-c", COMM_SCRIPT, str(i), url, str(tmp_path / f"out{i}.npz"),
                             str(tmp_path / "in.npz"), device, backend], ok=ok)


def check_dist_comm(tmp_path, device: str) -> list:
    """Run COMM_SCRIPT as 2 gloo processes x 2 slabs on ``device`` and hold
    each process's results against LocalComm(4) on the same seeded buffers:
    shifts both ways (the end slabs receive zeros), the max and the int64
    sum bitwise, the float32 sum within one rounding (the processes add
    (s0 + s1) + (s2 + s3), LocalComm ((s0 + s1) + s2) + s3), the gather in
    slab order; to_host in rank order; 3 slabs over 2 processes refused.
    Returns each process's results."""
    comm_script(tmp_path, device)
    data = np.load(tmp_path / "in.npz")
    got = [np.load(tmp_path / f"out{i}.npz") for i in range(2)]
    local = LocalComm(4)
    for name, t in data.items():
        per = [torch.from_numpy(x) for x in t]
        for direction in (1, -1):
            want = torch.stack(local.shift(per, direction)).numpy()
            for r in range(2):
                np.testing.assert_array_equal(got[r][f"{name}_shift{direction}"],
                                              want[2 * r:2 * r + 2])
        assert not got[0][f"{name}_shift1"][0].any() and not got[1][f"{name}_shift-1"][1].any()
        for r in range(2):
            np.testing.assert_array_equal(got[r][f"{name}_max"], local.all_max(per).numpy())
            np.testing.assert_array_equal(got[r][f"{name}_gather"],
                                          local.all_gather(per).numpy())
            if name == "i64":
                np.testing.assert_array_equal(got[r]["i64_sum"], local.all_sum(per).numpy())
            else:
                np.testing.assert_allclose(got[r]["f32_sum"], local.all_sum(per).numpy(),
                                           rtol=2e-7, atol=1e-6)
    for r in range(2):
        assert got[r]["slabs"].tolist() == [2 * r, 2 * r + 1]
        assert got[r]["to_host"].tolist() == [0, 1, 2, 10, 11, 12]
        assert "odd_refused" in got[r]
    return got


def test_dist_comm_matches_local_comm(tmp_path):
    """DistComm over gloo on CPU tensors against LocalComm(4)
    (check_dist_comm); nothing is staged."""
    for res in check_dist_comm(tmp_path, "cpu"):
        assert int(res["staged"]) == 0


def test_oracle_decomposition_over_two_processes(tmp_path):
    """The oracle DomainDecomposition as 2 gloo processes x 2 slabs: after 3
    steps on the dam every process gathers the same bits as LocalComm(4) in
    this process, with n_valid whole and no overflow."""
    url = (tmp_path / "store").as_uri()
    _spawn(lambda i: ["-c", ORACLE_SCRIPT, str(i), url, str(tmp_path / f"out{i}.npz")])
    from pi_sph_fluid_tpu_torch import SPHConfig, build_dam_break_scene, prepare_boundary
    from pi_sph_fluid_tpu_torch.parallel import DomainDecomposition

    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg, "cpu")
    b, bg = prepare_boundary(braw, cfg)
    dd = DomainDecomposition(cfg, b, bg, fluid.n, LocalComm(4), "cpu")
    state, step = dd.init(fluid), dd.make_step()
    for _ in range(3):
        state, _ = step(state, (0.0, -9.81))
    want = dd.gather(state)
    for i in range(2):
        got = np.load(tmp_path / f"out{i}.npz")
        assert int(got["n_valid"]) == fluid.n and int(got["overflow"]) == 0
        for f in type(want)._fields:
            np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=f)


def test_two_processes_match_one_process(tmp_path):
    """The worker as 2 gloo processes x 4 slabs on the dam exports the same
    bits (every field, au, av) and the same frame as the same sequence over
    LocalComm(8) in this process: one exact step, 8 sticky ticks at r2, one
    64x128 frame."""
    out = tmp_path / "export.npz"
    url = (tmp_path / "store").as_uri()
    outs = _spawn(lambda i: ["-m", "pi_sph_fluid_tpu_torch.tools.multihost_worker",
                             "--coordinator", url, "--num-processes", "2",
                             "--process-id", str(i), "--slabs-per-process", "4",
                             "--device", "cpu", "--out", str(out)])
    for i, (stdout, _) in enumerate(outs):
        assert f"[proc {i}] multihost OK: 2 procs x 4 slabs" in stdout
    got = np.load(out)
    res = multihost_worker.run(*multihost_worker.build(LocalComm(8), "cpu"))
    fl, au, av = res.export
    for f in type(fl)._fields:
        np.testing.assert_array_equal(got[f], getattr(fl, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(got["au"], au.numpy())
    np.testing.assert_array_equal(got["av"], av.numpy())
    np.testing.assert_array_equal(got["fb"], res.fb)


def test_cli_refuses_processes_without_a_coordinator():
    """tests/test_multihost.py:111-118: --num-processes > 1 without
    --coordinator exits before any process group starts."""
    with pytest.raises(SystemExit, match="coordinator"):
        cli.main(["bench", "--num-processes", "2", "--n", "100", "--steps", "2",
                  "--backend", "reference", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("argv,match", [
    (["--slabs", "3", "--num-processes", "2", "--process-id", "0"], "multiple"),
    (["--slabs", "4", "--num-processes", "2"], "process-id"),
    (["--slabs", "4", "--num-processes", "2", "--process-id", "2"], "process-id"),
    (["--backend", "window", "--num-processes", "2", "--process-id", "0"], "window-dd"),
    (["--slabs", "4", "--num-processes", "2", "--process-id", "0", "--gravity", "web"],
     "gravity"),
], ids=["slabs_not_a_multiple", "no_process_id", "process_id_out_of_range",
        "single_device_backend", "live_gravity"])
def test_cli_refuses_bad_launch_flags(argv, match, tmp_path):
    """--slabs not a multiple of --num-processes, a missing or out-of-range
    --process-id, a backend other than window-dd, and a gravity source each
    process would read apart all exit before the process group starts."""
    base = ["run", "--backend", "window-dd", "--device", "cpu", "--scene", "dam",
            "--display", "none", "--coordinator", (tmp_path / "store").as_uri()]
    with pytest.raises(SystemExit, match=match):
        cli.main(base + argv)
    assert not torch.distributed.is_initialized()


def test_cli_run_over_two_processes(tmp_path, capsys):
    """``cli run --backend window-dd --slabs 4 --num-processes 2`` on the dam
    with a cap that overflows (one window recovery, a revert to the start
    and a replay): process 0 writes the frames and the saved state, equal
    to the in-process run's, and says the same recovery lines; process 1
    writes no frame, no state and prints nothing but its display note."""
    opts = ["run", "--backend", "window-dd", "--slabs", "4", "--device", "cpu",
            "--scene", "dam", "--seconds", "0.008", "--steps-per-dispatch", "8",
            "--resort-every", "2", "--cap", "128"]
    url = (tmp_path / "store").as_uri()
    outs = _spawn(lambda i: ["-m", "pi_sph_fluid_tpu_torch.cli", *opts,
                             "--num-processes", "2", "--coordinator", url,
                             "--process-id", str(i),
                             "--display", f"file:{tmp_path / f'frames{i}.bin'}",
                             "--save-state", str(tmp_path / f"state{i}.npz")])
    res = cli.main(opts + ["--display", f"file:{tmp_path / 'frames.bin'}",
                           "--save-state", str(tmp_path / "state.npz")])
    err = capsys.readouterr().err

    def recovery(text):
        return [ln for ln in text.splitlines() if ln.startswith(RECOVERY)]

    assert res.recoveries == 1 and recovery(err)
    assert recovery(outs[0][1]) == recovery(err)
    want = (tmp_path / "frames.bin").read_bytes()
    assert len(want) == 1024 * (res.dispatches - res.recoveries)
    assert (tmp_path / "frames0.bin").read_bytes() == want
    assert not (tmp_path / "frames1.bin").exists()
    mine, ref = np.load(tmp_path / "state0.npz"), np.load(tmp_path / "state.npz")
    assert sorted(mine.files) == sorted(ref.files)
    for key in ref.files:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    assert not (tmp_path / "state1.npz").exists()
    assert "n_fluid" in outs[0][0] and outs[1][0] == ""
    assert outs[1][1].strip() == "process 1: display -> none (process 0 owns the display)"
