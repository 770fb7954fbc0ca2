"""The probe kind's planted fault (written into a copy as
``portbench/tests/faults/probe_forward.py``): the UNet's output altered
where it is produced."""

from __future__ import annotations


def _altered_output(monkeypatch):
    from hsi_dmgasr_tpu_torch.models.unet import UNet

    real = UNet.forward

    def altered(self, *a, **kw):
        out = real(self, *a, **kw).clone()
        out[0, 0, 0, 0] += 1.0
        return out
    monkeypatch.setattr(UNet, "forward", altered)


FAULTS = [_altered_output]
