"""The control: the reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place on the same dispatches,
comes out as not correct under the cells' limits.  Here at a size a CPU
test holds (the drop, a short window); on the card at the cells' own size
by benchmark/control.py."""

import pytest

from benchmark import check
from benchmark.spec import Spec
from conftest import ROOT, run_cpu


@pytest.mark.parametrize("seed", [2147483721, 3000000001])
def test_bfloat16_control_fails_the_limits(seed):
    res = run_cpu("drop_269.still", seed=seed, control=True)
    assert res["correct"] is True, res["numbers"]
    assert not check.verdict(res["control"], res["limits"]), res["control"]


def test_bfloat16_control_fails_the_tank_limits():
    """The tank's limits against a 348-particle tank's control."""
    from benchmark import harness

    spec = Spec(ROOT)
    cfg = dict(spec.config("tank_1m"), r=0.125, n_fluid=348, n_walls=96)
    import time

    from conftest import quick

    traffic = quick(spec.traffic("tank_1m.sticky"))
    traffic.update(steps_per_dispatch=64, render_shape=[64, 128])
    res = harness.run_cell(cfg, traffic, [], {}, 2147483711,
                           0.5, False, "cpu", time.perf_counter(), control=True,
                           log=lambda *a, **k: None)
    assert not check.verdict(res["control"], res["limits"]), res["control"]
