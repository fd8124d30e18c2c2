"""The roofline arithmetic on a case counted by hand."""

import torch

from benchmark import roofline


def test_pairs_and_least_time_by_hand():
    # support 2.0: fluid 0 and 1 are 1.5 apart (one pair, counted both
    # ways), fluid 2 is 3.5 from fluid 1 (none); wall 0 is 0.5 from fluid 0,
    # wall 1 is far from every fluid particle
    x = torch.tensor([1.0, 2.5, 6.0])
    y = torch.tensor([1.0, 1.0, 1.0])
    wx = torch.tensor([0.5, 9.0])
    wy = torch.tensor([1.0, 1.0])
    pc = roofline.pair_counts(x, y, wx, wy, 2.0, (10.0, 2.0))
    assert pc == dict(n_fluid=3, ff=2, fb=1, walls=1)
    assert roofline.pass_work("density", pc) == (16 * 3, 72 * 3 + 16 * 1)
    assert roofline.pass_work("forces", pc) == (39 * 3, 112 * 3 + 32 * 1)
    flops, nbytes = roofline.tick_work(pc)
    assert (flops, nbytes) == (48 + 117, 232 + 368 + 72 * 3)
    assert roofline.least_s(flops, nbytes) == nbytes / 3.35e12
    assert roofline.least_s(67e12, 1.0) == 1.0


def test_pair_on_the_support_is_out():
    x = torch.tensor([0.0, 2.0])
    y = torch.tensor([0.0, 0.0])
    pc = roofline.pair_counts(x + 1, y + 1, torch.zeros(0), torch.zeros(0), 2.0, (4.0, 2.0))
    assert pc["ff"] == 0
