"""The attention core's share of its roofline, %: the least time of the
calls of ``spatial_attention`` in the window (``work`` from each call's
shapes, against the card's bf16 peak and bandwidth) over the device time
inside the benchmark's span around each call as the UNet calls it,
whatever route the call takes inside (flash, the split kernel, or the
einsums and the softmax)."""

from portbench import roofline

SPANS = {"attention_core": "function:hsi_dmgasr_tpu_torch.models.unet:spatial_attention"}


def work(sig):
    """(operations, least bytes) of one ``spatial_attention`` call:
    softmax(q k^T) v is 4 B H S^2 D operations counted once, and q, k, v
    and the output are read or written once in the call's dtype
    (``roofline.flash_work``'s count)."""
    return roofline.flash_work(sig)


def read(run):
    if run.device.type != "cuda":
        return None
    return roofline.kernel_share(run.spans.get("attention_core"), work, run.device_name)
