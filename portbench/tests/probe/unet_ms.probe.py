"""Milliseconds per call inside the UNet's forward, by the span around it
(the probe's per-layer metric, written into a copy's
``portbench/metrics/``)."""

SPANS = {"unet.forward": "forward:unet"}


def read(run):
    span = run.spans.get("unet.forward")
    return span["ms"] / run.n_calls if span else None
