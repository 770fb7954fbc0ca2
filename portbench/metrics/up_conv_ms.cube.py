"""Device milliseconds per cube call in the up path's convolutions: the
program's ``unet.up_conv`` spans (``models/unet.py:Upsample.forward``, the
nearest 2x upsample and 3x3 conv, fused as one transposed conv on the
fused path), by their CUDA events."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.per_call(run, ["unet.up_conv"])
