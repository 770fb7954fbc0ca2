"""The up path's share of its roofline, %: the least time of the calls of
``up2_conv3x3`` in the window (``work`` from each call's shapes, against
the card's bf16 peak and bandwidth) over the device time inside the
benchmark's span around each call as the UNet calls it, whatever route
the call takes inside (a kernel, or a library convolution with its
layout copies)."""

from portbench import roofline

SPANS = {"up_conv": "function:hsi_dmgasr_tpu_torch.models.unet:up2_conv3x3"}


def work(sig):
    """(operations, least bytes) of one ``up2_conv3x3`` call from its
    signature: nearest x2 then a 3x3 conv is, per output pixel, a 2x2
    window of the input, so 2 * B * (2H) * (2W) * 4 * C * Cout operations,
    counted once; x and the output once in the call's dtype, the 3x3 weights
    and the bias once in theirs."""
    (b, h, w, c), es = roofline._tensor(sig, "x")
    kshape, ek = roofline._tensor(sig, "kernel")
    cout = kshape[-1]
    flops = 2.0 * b * (2 * h) * (2 * w) * 4 * c * cout
    nbytes = es * b * h * w * c + es * b * (2 * h) * (2 * w) * cout + ek * 9 * c * cout
    bshape, eb = roofline._tensor(sig, "bias")
    if bshape is not None:
        nbytes += eb * cout
    return flops, nbytes


def read(run):
    if run.device.type != "cuda":
        return None
    return roofline.kernel_share(run.spans.get("up_conv"), work, run.device_name)
