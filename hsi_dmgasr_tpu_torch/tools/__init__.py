"""Measurement tools of the port, run as ``python -m hsi_dmgasr_tpu_torch.tools.<name>``."""
