"""VGG19 in torchvision's module layout, for the stage-1 perceptual term.

Port of ``hsi_dmgasr_tpu/models/vgg.py``. The reference's optional
"VGGSAM" stage-1 recipe feeds 3 random bands of the reconstruction and
of the target through a pretrained torchvision ``vgg19``, the whole
network up to the classifier's logits, and takes an L1 between the
outputs, weighted 1e-3 (AE.py:551-604, 610-615). The weights come from a
user-supplied ``vgg19*.pth`` (``io.convert_torch.load_torch_vgg19``):
the modules are torchvision's (``features`` cfg "E", ``avgpool``,
``classifier`` 0/3/6), so its state_dict loads with ``load_state_dict``
as it is.

The module takes NHWC input, as the rest of the port does, and runs NCHW
inside, so the flatten before the classifier is torchvision's own order.
``extract="features"`` returns the conv stack's output (NHWC) and builds
no classifier. The JAX module has no dropout: it is this module in eval
mode (``train.stage1_gae.make_vgg_perceptual_fn`` sets it).
"""

from __future__ import annotations

import torch
from torch import nn

# torchvision cfg "E": conv widths, "M" = 2x2/2 max-pool
_CFG_E = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG19(nn.Module):
    def __init__(self, num_classes=1000, extract="logits"):
        super().__init__()
        if extract not in ("logits", "features"):
            raise ValueError(f"extract must be 'logits' or 'features', got {extract!r}")
        self.extract = extract
        layers, cin = [], 3
        for v in _CFG_E:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)
        if extract == "logits":
            self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(inplace=True), nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        """x: (B, H, W, 3) -> logits (B, num_classes), or the features
        (B, H/32, W/32, 512) with ``extract="features"``."""
        y = self.features(x.permute(0, 3, 1, 2))
        if self.extract == "features":
            return y.permute(0, 2, 3, 1)
        return self.classifier(torch.flatten(self.avgpool(y), 1))
