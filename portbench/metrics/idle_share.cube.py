"""The device's idle share of the traced window, %: 1 - busy / window, with
busy the union of the device operations' intervals in torch.profiler's
trace."""


def read(run):
    t = run.device_trace
    if not t or not t["events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run.traced_s)
