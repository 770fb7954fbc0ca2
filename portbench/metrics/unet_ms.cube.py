"""Device milliseconds per cube call inside the UNet's forwards (the
sampler's model, ``models/unet.py``), by CUDA events around each forward."""

SPANS = {"unet.forward": "forward:pipe.ddpm.eval_unet"}


def read(run):
    span = run.spans.get("unet.forward")
    return span["ms"] / run.n_calls if span else None
