"""GDRRN baseline (reference GAE/models_GDRRN.py:168-201): a port of
``hsi_dmgasr_tpu/models/baselines/gdrrn.py``.

Grouped deep recursive residual network: 9 recursions of one SHARED pair
of bias-free grouped 3x3 convs, with a persistent skip to the input
features. The output keeps its input's size: the model refines a
bicubic-upsampled cube. NHWC in and out.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.blocks import Conv2d


def grouped_conv(in_ch, out_ch, groups=1):
    """A bias-free grouped 3x3 conv with the reference's He-normal init,
    std sqrt(2 / (9 out)) (GAE/models_GDRRN.py:181-184)."""
    conv = Conv2d(in_ch, out_ch, 3, bias=False, groups=groups)
    with torch.no_grad():
        conv.weight.normal_(0.0, math.sqrt(2.0 / (9 * out_ch)))
    return conv


class GDRNN(nn.Module):
    def __init__(self, input_chnl_hsi, group=1, num_chnl=128, recursions=9):
        super().__init__()
        self.recursions = recursions
        self.input = grouped_conv(input_chnl_hsi, num_chnl)
        self.conv1 = grouped_conv(num_chnl, num_chnl, group)
        self.conv2 = grouped_conv(num_chnl, num_chnl, group)
        self.output = grouped_conv(num_chnl, input_chnl_hsi)

    def forward(self, x):
        # the reference's nn.ReLU(inplace=True) aliases earlier tensors
        # (GAE/models_GDRRN.py:186-201): `residual = x` becomes relu(x) at
        # the first relu, and `inputs` aliases `out` in recursion 0, so the
        # skip source is relu(inputs) from then on. The JAX package
        # replicates that, and so does this forward.
        xr = torch.relu(x)
        inputs = self.input(xr)
        out = inputs
        for i in range(self.recursions):
            r = torch.relu(out)
            if i == 0:
                inputs = r
            out = self.conv2(torch.relu(self.conv1(r))) + inputs
        return self.output(torch.relu(out)) + xr
