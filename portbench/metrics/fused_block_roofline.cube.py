"""The fused Block kernel's share of its roofline, %: the least time of
its calls in the window (``roofline.fused_block_work`` from each call's
shapes, against the card's bf16 peak and bandwidth) over the device time
inside the benchmark's span around each call of ``gn_swish_conv3x3`` as
the UNet calls it (its host-side moments folding and the kernel)."""

from portbench import roofline

SPANS = {"fused_block": "function:hsi_dmgasr_tpu_torch.models.unet:gn_swish_conv3x3"}


def read(run):
    if run.device.type != "cuda":
        return None
    return roofline.kernel_share(run.spans.get("fused_block"), roofline.fused_block_work, run.device_name)
