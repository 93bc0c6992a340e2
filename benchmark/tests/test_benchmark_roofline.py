"""The yardstick's arithmetic: the FLOP counter against a hand count, and
K1's and K2's bounds against chip_smoke.py's at one shape."""

from __future__ import annotations

import importlib.util
import math

import torch
from torch import nn

from benchmark import roofline
from benchmark.run import ROOT


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def two_convs():
    torch.manual_seed(0)
    return nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(8, 4, 5, stride=2, padding=2))


# multiply-adds of the two layers on a (2, 3, 16, 16) input:
# conv1 (2, 8, 16, 16) outputs x 3*3*3 taps, conv2 (2, 4, 8, 8) x 8*5*5
MACS = 2 * 8 * 16 * 16 * 27 + 2 * 4 * 8 * 8 * 200


def test_flops_of_a_forward():
    net = two_convs()
    counter = roofline.FlopCounter([net])
    with torch.no_grad(), counter.counting():
        net(torch.randn(2, 3, 16, 16))
    assert counter.flops == 2 * MACS


def test_flops_with_the_gradients_of_the_phase():
    net = two_convs()
    x = torch.randn(2, 3, 16, 16)
    counter = roofline.FlopCounter([net])
    with counter.counting():         # weights train, the input needs none
        net(x).sum().backward()
    conv1, conv2 = 2 * 8 * 16 * 16 * 27, 2 * 4 * 8 * 8 * 200
    # conv1: forward + weight gradient; conv2: forward + input + weight
    assert counter.flops == 2 * (2 * conv1 + 3 * conv2)
    net.requires_grad_(False)        # a frozen net inside another's loss
    counter = roofline.FlopCounter([net])
    with counter.counting():
        net(x.requires_grad_()).sum().backward()
    assert counter.flops == 2 * 2 * MACS


def test_conv_transpose_and_linear():
    up = nn.ConvTranspose2d(4, 2, 3, stride=2, padding=1, output_padding=1)
    fc = nn.Linear(10, 7)
    counter = roofline.FlopCounter([up, fc])
    with torch.no_grad(), counter.counting():
        up(torch.randn(1, 4, 5, 5))
        fc(torch.randn(3, 10))
    assert counter.flops == 2 * (4 * 5 * 5 * 2 * 9 + 3 * 7 * 10)


def test_k1_bound_matches_chip_smoke():
    from mmhand_torch.ops.heatmap import skipped_elements

    cs = chip_smoke()
    gen = torch.Generator().manual_seed(3)
    uv = torch.rand(16, 21, 2, generator=gen) * 216 + 20
    skipped = float(skipped_elements(uv, 256, 256, 6.0).float().mean())
    out_bytes = 16 * 256 * 256 * 21 * 4
    want = cs.bound(out_bytes + uv.numel() * 4,
                    9 * (1 - skipped) * out_bytes / 4)[0] / 1e3
    got = roofline.k1_bound_s(uv, 256, 256, 6.0)
    assert math.isclose(got, want, rel_tol=1e-9)


def test_k2_bounds_match_chip_smoke():
    cs = chip_smoke()
    n, e, c = 16 * 64 * 256 * 256, 2, 64
    assert math.isclose(roofline.k2_bound_s(n, e, c),
                        cs.bound(n * e + 2 * c * 4, 3 * n)[0] / 1e3)
    assert math.isclose(roofline.k2b_bound_s(n, e, c),
                        cs.bound(2 * n * e + 2 * c * 4, 2 * n)[0] / 1e3)
