"""A headless mix (``render_shape`` null, traffic/drop_269.headless.json) on
the CPU: the runner draws no frame, takes its own headless K (one 0.1 s
report interval of ticks, rounded up to the resort period), and the check
compares the state alone."""

from benchmark.spec import Spec
from conftest import ROOT, run_mix
from pi_sph_fluid_tpu_torch.io.host_loop import SimRunner


def test_the_headless_mix_is_correct_without_a_frame(monkeypatch):
    ticks = []
    orig = SimRunner._dispatch

    def dispatch(self, sim, g):
        ticks.append(len(g))
        return orig(self, sim, g)

    monkeypatch.setattr(SimRunner, "_dispatch", dispatch)
    e2e = {m["name"]: m for m in Spec(ROOT).bench["end_to_end"]}
    res = run_mix("drop_269", "drop_269.headless",
                  [e2e["particle_steps_per_s"], e2e["frame_gap_p95_ms"], e2e["setup_s"]])
    assert res["correct"] is True and res["failed"] == 0, (res["numbers"], res["limits"])
    assert res["checked"] >= 1
    assert "frame" not in res["numbers"] and "frame" not in res["limits"]
    assert sorted(res["metrics"]) == ["particle_steps_per_s", "setup_s"]
    assert res["metrics"]["particle_steps_per_s"]["value"] > 0
    # round(0.1 / DT) = 410 ticks, up to 416 under r8; whole chunks of two
    assert set(ticks) == {416} and len(ticks) % 2 == 0, ticks
