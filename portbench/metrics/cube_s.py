"""Seconds per cube call: the window's length over the calls it finished
(the host clock; each call waits for its cube)."""


def read(run):
    return run.window_s / run.n_calls
