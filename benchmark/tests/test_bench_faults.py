"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have, and a sound run comes out correct.  The
run skips the look for a card and drives the rest of a run on the CPU (the
plain versions of the port's kernels), at the drop cell's size and limits
with a short window, and once on the drop's headless mix, which has no
frame.  The cells run on one chip, so there is no exchange between chips
to leave out."""

import pytest
import torch

from pi_sph_fluid_tpu_torch.io.host_loop import SimRunner
from pi_sph_fluid_tpu_torch.models.engine_v3 import WindowEngine
from conftest import run_cpu, run_mix

R = 0.075


def _unchanged(monkeypatch):
    """A dispatch that returns its state unchanged."""
    orig = SimRunner._dispatch

    def dispatch(self, sim, g):
        _, st, fb = orig(self, sim, g)
        return sim, st, fb

    monkeypatch.setattr(SimRunner, "_dispatch", dispatch)


def _half_rows(monkeypatch):
    """Half of the state's rows left out of the kick-drift."""
    orig = WindowEngine._kick_drift

    def kick_drift(self, sim):
        pk = orig(self, sim)
        n = pk.shape[0] // 2
        pk[n:] = sim.packed[n:]
        return pk

    monkeypatch.setattr(WindowEngine, "_kick_drift", kick_drift)


def _moved_particle(monkeypatch):
    """One particle's position altered where the dispatch produces it."""
    orig = SimRunner._dispatch

    def dispatch(self, sim, g):
        out, st, fb = orig(self, sim, g)
        pk = out.packed.clone()
        row = int(torch.nonzero(pk[:, 4] > 0)[0])
        pk[row, 0] += 0.5 * R
        return out._replace(packed=pk), st, fb

    monkeypatch.setattr(SimRunner, "_dispatch", dispatch)


def _frame_altered(monkeypatch):
    """The frame altered where the renderer produces it: its top page
    (8 rows of pixels) inverted."""
    orig = SimRunner._dispatch

    def dispatch(self, sim, g):
        out, st, fb = orig(self, sim, g)
        fb = fb.clone()
        fb[:128] = 255 - fb[:128]
        return out, st, fb

    monkeypatch.setattr(SimRunner, "_dispatch", dispatch)


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _moved_particle, _frame_altered],
                         ids=["unchanged", "half_rows", "moved_particle", "frame_altered"])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_cpu("drop_269.still")
    assert res["checked"] >= 1
    assert res["correct"] is False, res["numbers"]


def test_a_sound_run_is_correct():
    res = run_cpu("drop_269.still")
    assert res["checked"] >= 1 and res["failed"] == 0
    assert res["correct"] is True, (res["numbers"], res["limits"])


def test_a_broken_headless_path_is_not_correct(monkeypatch):
    _unchanged(monkeypatch)
    res = run_mix("drop_269", "drop_269.headless")
    assert res["checked"] >= 1 and "frame" not in res["numbers"]
    assert res["correct"] is False, res["numbers"]
