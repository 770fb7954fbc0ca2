"""Device milliseconds per cube call in self-attention: the program's
``unet.attention`` spans (``models/unet.py:SelfAttention.forward``: the
norm, the qkv projection, ``spatial_attention`` on flash or two GEMMs, and
the output projection), by their CUDA events."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.per_call(run, ["unet.attention"])
