"""The 95th percentile (nearest rank) of the window's per-call latencies:
the host clock from a call's start to its cube on the host's side."""

import math


def read(run):
    lat = sorted(b - a for a, b in run.calls)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
