"""Seconds per forward call: the window over its calls (the probe's
end-to-end metric, written into a copy's ``portbench/metrics/``)."""


def read(run):
    return run.window_s / run.n_calls
