"""The flash attention kernel's share of its roofline, %: the least time
of its calls in the window (``roofline.flash_work``) over the device time
inside the benchmark's span around each call of ``flash_attention`` as
the attention dispatch calls it (the bf16 prepass and the kernel)."""

from portbench import roofline

SPANS = {"flash": "function:hsi_dmgasr_tpu_torch.kernels.attention:flash_attention"}


def read(run):
    if run.device.type != "cuda":
        return None
    return roofline.kernel_share(run.spans.get("flash"), roofline.flash_work, run.device_name)
