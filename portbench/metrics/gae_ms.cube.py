"""Device milliseconds per cube call in the GAE: ``DMGASRPipeline.encode``
and ``decode`` (``models/gae.py`` under ``pipeline.py``), by CUDA events
around each call."""

SPANS = {"gae.encode": "method:pipe.encode", "gae.decode": "method:pipe.decode"}


def read(run):
    parts = [run.spans[n] for n in SPANS if n in run.spans]
    if not parts:
        return None
    return sum(p["ms"] for p in parts) / run.n_calls
