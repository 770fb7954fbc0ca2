"""The share of the fused Block kernel's launches that took its wgmma
route, %: ``kernels/fused_conv.py``'s ``LAUNCHES_BY_ROUTE`` since the
process started (the warm-up's launches too), the "wgmma" launches over
all. Nothing where the program has no such counter or launched nothing."""


def read(run):
    from hsi_dmgasr_tpu_torch.kernels import fused_conv

    routes = getattr(fused_conv, "LAUNCHES_BY_ROUTE", None)
    total = sum(routes.values()) if routes else 0
    return 100.0 * routes.get("wgmma", 0) / total if total else None
