"""Milliseconds per training step: the window's length, which ends when
the device has finished every step, over the steps it ran."""


def read(run):
    return run.window_s / run.n_calls * 1e3
