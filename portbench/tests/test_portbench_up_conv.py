"""The up path's two per-layer metrics on the CPU: the roofline's count at
the UNet's four up levels, and the route share read from the program's
counter, or nothing where the program has none.

    python -m pytest -q portbench/tests/test_portbench_up_conv.py
"""

from __future__ import annotations

import sys

import pytest
import torch

from portbench import run as harness
from portbench.trace import _describe
from portbench.tests.tiny import REPO

METRICS = REPO / "portbench" / "metrics"


def _sig(b, h, c, cout):
    x = torch.empty(b, h, h, c, device="meta")
    kernel = torch.empty(3, 3, c, cout, device="meta")
    return (("x", _describe(x)), ("kernel", _describe(kernel)),
            ("bias", _describe(torch.empty(cout, device="meta"))))


def test_roofline_counts_the_four_up_levels():
    reader = harness.load_file_module(METRICS / "up_conv_roofline.cube.py")
    levels = [(32, 512), (64, 512), (128, 256), (256, 128)]
    work = [reader.work(_sig(9, h, c, c)) for h, c in levels]
    # 2 B (2H)(2W) 4 C Cout: 77.3 GFLOP at 32^2, 309.2 at each of the others
    assert sum(f for f, _ in work) == pytest.approx(1.005022347264e12)
    assert work[0][0] == pytest.approx(77.309411328e9)
    # x and the output in f32, the 3x3 weights and the bias in f32
    b, h, c = 9, 256, 128
    assert work[3][1] == 4.0 * (b * h * h * c + b * 4 * h * h * c + 9 * c * c + c)


@pytest.mark.parametrize("routes,share", [({"kernel": 0, "transpose": 0}, None),
                                          ({"kernel": 20, "transpose": 0}, 100.0),
                                          ({"kernel": 15, "transpose": 5}, 75.0)])
def test_kernel_share_reads_the_counter(monkeypatch, routes, share):
    from hsi_dmgasr_tpu_torch.kernels import up2_conv

    monkeypatch.setattr(up2_conv, "LAUNCHES_BY_ROUTE", dict(routes))
    reader = harness.load_file_module(METRICS / "up_conv_kernel_share.cube.py")
    assert reader.read(None) == share


def test_kernel_share_is_silent_without_the_module(monkeypatch):
    """A program that lacks the kernel's module (the parent of the change
    that brought it) reads nothing, and raises nothing."""
    import hsi_dmgasr_tpu_torch.kernels as kernels

    monkeypatch.setitem(sys.modules, "hsi_dmgasr_tpu_torch.kernels.up2_conv", None)
    monkeypatch.delattr(kernels, "up2_conv", raising=False)
    reader = harness.load_file_module(METRICS / "up_conv_kernel_share.cube.py")
    assert reader.read(None) is None
