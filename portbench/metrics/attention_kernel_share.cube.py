"""The share of attention calls that took a hand-written kernel, %:
``kernels/attention.py``'s ``LAUNCHES_BY_ROUTE`` since the process
started (the warm-up's calls too), the "flash" and "split" calls over all.
Nothing where the program has no such counter, or made no call."""


def read(run):
    from hsi_dmgasr_tpu_torch.kernels import attention

    routes = getattr(attention, "LAUNCHES_BY_ROUTE", None)
    total = sum(routes.values()) if routes else 0
    if not total:
        return None
    return 100.0 * (routes.get("flash", 0) + routes.get("split", 0)) / total
