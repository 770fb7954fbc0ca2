"""int8 feasibility probe: do int8 dots reach 2x bf16 on the card?

Port of ``tools/microbench_int8.py``. The H100's int8 tensor-core peak is
twice its bf16 peak (1979 TOP/s against 989 TFLOP/s). The probe asks
whether that holds at the flagship's hot matmul geometry (the dx-packed
rb_up block1, K = 3*192 = 576, N padded to 256; the C=64 level, K = 192;
and a square case), for

  * ``chain_dot``: the library's dot, standing in for XLA's
    ``dot_general``: ``torch._int_mm`` for int8, a bf16 ``torch.matmul``
    for bf16;
  * ``pallas_dot``: the port's hand-written kernel,
    ``kernels/blocked_dot.py`` (``csrc/blocked_dot.cu``).

Each times a chain of CHAIN dependent dots, each followed by the
requantize step, as the JAX tool does. ``lax.scan`` under ``jit`` is one
device program there; here the chain is captured once in a CUDA graph
and replayed, timed with CUDA events, so the host's launch cost is not
what is measured. The bf16 chain overflows to inf and then NaN within a
few dozen steps (it grows about sqrt(K) a step), as the JAX tool's does:
the chain is timed, and its values are not read.

    python -m hsi_dmgasr_tpu_torch.tools.microbench_int8 [--cpu]

Without ``--cpu`` it runs on the GPU and raises if there is none. With
it, both paths run the kernel's plain version on the CPU, timed with the
host clock (set INT8_CHAIN small there). A kernel that fails to build or
launch raises, and the tool exits non-zero. Each line is one JSON object
with the JAX tool's keys (``path`` is ``library`` or ``cuda``) and
``bound_us``, the least time the card could take for one dot: the larger
of its bytes (x and w read once, the 4-byte output written once) over
3.35 TB/s and its operations over the peak for its type.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import blocked_dot as bd

# The length of each timed chain of dependent dots.
CHAIN = int(os.environ.get("INT8_CHAIN", "4000"))

# (name, M, K, N, pallas block m, n), the JAX tool's cases
CASES = [
    ("square_4096x512x512", 4096, 512, 512, 512, 512),
    ("rbup_block1_dxpack", 4096, 576, 256, 512, 256),  # N padded 192->256
    ("rb512_dxpack", 4096, 192, 256, 512, 256),        # C=64 level
]
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}

# H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s, tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
# inputs per case and dtype, as in the JAX tool: the first warms, the rest are timed
N_X = 4


def dot_bound(m, k, n, dt):
    """(seconds, "bytes" or "operations"): the least time of one dot."""
    size = 1 if dt == "int8" else 2
    t_bytes = (size * (m * k + k * n) + 4 * m * n) / PEAK_BYTES
    t_ops = 2 * m * k * n / PEAK_OPS[dt]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def requantize(y, a):
    """Fold a dot's output y back to a's dtype and K columns, so the chain
    is shape- and dtype-stable: (y >> 7) wrapped to int8 (the requantize
    step) or a cast to bf16, then sliced or zero-padded to K columns."""
    a2 = (y >> 7).to(torch.int8) if a.dtype == torch.int8 else y.to(a.dtype)
    k, n = a.shape[1], a2.shape[1]
    if n > k:
        return a2[:, :k].contiguous()
    if n < k:
        return F.pad(a2, (0, k - n))
    return a2


def run_chain(dot, x, steps):
    """``steps`` dependent links a -> requantize(dot(a), a), from x."""
    a = x
    for _ in range(steps):
        a = requantize(dot(a), a)
    return a


def _check_preferred(w, preferred):
    want = bd.DTYPES[w.dtype][0]
    if preferred != want:
        raise ValueError(f"preferred {preferred}: {w.dtype} operands sum in {want}")


def library_dot(w):
    """One library call per dot: ``torch._int_mm`` (int8 -> int32) or a
    bf16 ``torch.matmul`` (bf16 out, f32 sums) on the card; the plain
    version on the CPU."""
    if w.device.type == "cpu":
        return lambda a: bd.blocked_dot_plain(a, w)
    if w.dtype == torch.int8:
        return lambda a: torch._int_mm(a, w)
    return lambda a: torch.matmul(a, w)


def kernel_dot(w, bm, bn):
    """One ``blocked_dot`` per dot, with w packed once, outside the chain."""
    wp = bd.pack_dot_weight(w)
    return lambda a: bd.blocked_dot(a, wp, bm, bn)


def chain_dot(w, preferred, x):
    """CHAIN dependent library dots: x @ w -> requantize -> repeat.
    Returns the sum of the last link as f32."""
    _check_preferred(w, preferred)
    return run_chain(library_dot(w), x, CHAIN).float().sum()


def pallas_dot(w, preferred, bm, bn, x):
    """The same chain through the hand-written blocked kernel."""
    _check_preferred(w, preferred)
    return run_chain(kernel_dot(w, bm, bn), x, CHAIN).float().sum()


def warm_up(dot, x):
    """One eager link on a side stream, before a capture: it builds the
    kernel and makes the library's handles."""
    side = torch.cuda.Stream(device=x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        requantize(dot(x), x)
    torch.cuda.current_stream(x.device).wait_stream(side)


def capture_chain(dot, x, steps):
    """The chain of ``steps`` links from a static copy of x, captured in a
    CUDA graph (warm ``dot`` up first). Returns (graph, static input,
    static output)."""
    static_x = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run_chain(dot, static_x, steps)
    return graph, static_x, out


def timed_chain(dot, xs, steps):
    """Median seconds of one chain over xs[1:] (xs[0] warms), the
    blocked-kernel launches made (the eager warm-up link's, plus the
    captured links' times the replays) and the last chain's output.

    On the card the chain is a CUDA graph replayed once per x and timed
    with CUDA events; on the CPU it runs eagerly on the host clock."""
    if xs[0].device.type == "cpu":
        float(run_chain(dot, xs[0], steps).float().sum())
        ts = []
        for x in xs[1:]:
            t0 = time.perf_counter()
            out = run_chain(dot, x, steps)
            float(out.float().sum())
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), 0, out
    n0 = bd.LAUNCHES
    warm_up(dot, xs[0])
    n_warm = bd.LAUNCHES - n0
    graph, static_x, out = capture_chain(dot, xs[0], steps)
    captured = bd.LAUNCHES - n0 - n_warm
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for x in xs[1:]:
        static_x.copy_(x)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3)
    return statistics.median(ts), n_warm + captured * len(xs), out


def rand_int8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device=gen.device, dtype=torch.int8)


def probe(device, seed=0):
    """Time both paths at every case and dtype. Returns one row a path:
    case, path, dtype, M, K, N, seconds, us_per_dot, achieved_TOPs,
    bound_us, bound_by, the kernel launches it made and the float64 sum
    of its last chain's output (exact for int8; inf or NaN for bf16)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for name, m, k, n, bm, bn in CASES:
        ops = 2 * m * k * n * CHAIN
        for dt, dtype in DTYPES.items():
            if dt == "bf16":
                w = torch.randn((k, n), generator=gen, device=device).to(dtype)
                xs = [torch.randn((m, k), generator=gen, device=device).to(dtype)
                      for _ in range(N_X)]
            else:
                w = rand_int8(gen, (k, n))
                xs = [rand_int8(gen, (m, k)) for _ in range(N_X)]
            bound_s, bound_by = dot_bound(m, k, n, dt)
            for path, dot in (("library", library_dot(w)), ("cuda", kernel_dot(w, bm, bn))):
                s, launches, out = timed_chain(dot, xs, CHAIN)
                rows.append({"case": name, "path": path, "dtype": dt, "M": m, "K": k, "N": n,
                             "seconds": s, "us_per_dot": s / CHAIN * 1e6,
                             "achieved_TOPs": ops / s / 1e12, "bound_us": bound_s * 1e6,
                             "bound_by": bound_by, "launches": launches,
                             "checksum": out.double().sum().item()})
            del w, xs
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print("device:", name, flush=True)
    for r in probe(device):
        print(json.dumps({
            "case": r["case"], "path": r["path"], "dtype": r["dtype"],
            "us_per_dot": round(r["us_per_dot"], 2),
            "achieved_TOPs": round(r["achieved_TOPs"], 1),
            "bound_us": round(r["bound_us"], 2),
        }), flush=True)


if __name__ == "__main__":
    main()
