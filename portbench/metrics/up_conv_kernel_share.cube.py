"""The share of ``up2_conv3x3`` calls that took the up path's kernel, %:
``kernels/up2_conv.py``'s ``LAUNCHES_BY_ROUTE`` since the process started
(the warm-up's calls too), the "kernel" calls over all. Nothing where the
program has no such module or counter, or made no call."""


def read(run):
    try:
        from hsi_dmgasr_tpu_torch.kernels import up2_conv
    except ImportError:
        return None
    routes = getattr(up2_conv, "LAUNCHES_BY_ROUTE", None)
    total = sum(routes.values()) if routes else 0
    return 100.0 * routes.get("kernel", 0) / total if total else None
