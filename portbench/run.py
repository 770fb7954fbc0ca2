"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything
about it is found by name:

  * its configuration, ``configs[*].file`` (``portbench/configs/<name>.json``);
  * its traffic mix, ``portbench/traffic/<traffic>.json``, whose ``kind``
    names the generator, ``portbench/kinds/<kind>.py``;
  * its correctness check, ``portbench/workloads/<cell>.json``;
  * each metric it reports, ``portbench/metrics/<metric>.py``.

A run builds the program and its inputs from the seed, warms up every
shape the traffic uses (``setup_s``), drives the traffic for ``--seconds``
(a call in flight when they are up is finished and counted), reads the
cell's end-to-end metrics (``--trace 0``) or, with spans and the profiler
on, its per-layer metrics (``--trace 1``), then frees the program and
checks what the timed calls produced against the plain reference. The
last line of standard output is one JSON object; the numbers compared,
each beside its limit, are also the last lines of standard error.

It exits with another code than 0, printing no result, when there is no
CUDA card (``--device cpu`` runs a tiny configuration in the tests), when
the cell is not found, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hsi_dmgasr_tpu")
# the traced run profiles the device over the window's first calls, until
# this many seconds have passed (its trace is read after the window)
PROFILE_SECONDS = 20.0
MISSING = 1e300


def load_file_module(path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path):
    with open(path) as f:
        return json.load(f)


class Run:
    """Everything one run knows: the cell and its files, the timings of its
    window, its spans and trace. Kinds and metric readers read it."""

    def __init__(self, args, root):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.bench = read_json(root / "BENCHMARK.json")
        cells = {c["name"]: c for c in self.bench["workloads"]}
        if args.workload not in cells:
            raise SystemExit(f"no cell {args.workload!r} in BENCHMARK.json: {sorted(cells)}")
        self.cell = cells[args.workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.cfg = read_json(root / configs[self.cell["config"]]["file"])
        self.mix = read_json(root / "portbench" / "traffic" / f"{self.cell['traffic']}.json")
        self.check_spec = read_json(root / "portbench" / "workloads" / f"{args.workload}.json")
        self.calls = []          # (host start, host end) of each timed call
        self.window_s = None
        self.peak_bytes = None
        self.spans = {}
        self.device_trace = None
        self.setup_s = None
        self.phases = []         # (set-up phase, seconds since the process started)

    def mark(self, phase):
        """Note the end of a set-up phase (printed on standard error)."""
        self.phases.append((phase, round(time.perf_counter() - PROCESS_START, 3)))

    def metrics_of(self, group):
        """The cell's metric entries of ``end_to_end`` or ``per_layer``."""
        name = self.cell["name"]
        return [m for m in self.bench[group] if name in m.get("workloads", [name])]

    @property
    def n_calls(self):
        return len(self.calls)


def _window(run, work, torch):
    """Drive the traffic for ``run.seconds``; traced, profile the first
    PROFILE_SECONDS of it (``run.traced_s``, ``run.traced_calls``)."""
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    prof = None
    if run.trace:
        from . import trace

        prof = trace.profiler(run.device)
        prof.start()
    sync()
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        work.call(run.n_calls)
        t1 = time.perf_counter()
        run.calls.append((t0, t1))
        if prof is not None and (t1 - start >= min(PROFILE_SECONDS, run.seconds)):
            sync()
            run.traced_s, run.traced_calls = time.perf_counter() - start, run.n_calls
            prof.stop()
            run.profile, prof = prof, None
        if t1 - start >= run.seconds:
            break
    sync()
    run.window_s = time.perf_counter() - start


def run_cell(args, root="."):
    """Set up, time and check one cell, its files read under ``root``;
    returns the result line's object."""
    import torch

    from . import program

    run = Run(args, Path(root))
    run.device = torch.device(args.device)
    run.mark("imports")
    mix_kind = run.mix["kind"]
    kind = load_file_module(PACKAGE / "kinds" / f"{mix_kind}.py")
    group = "per_layer" if run.trace else "end_to_end"
    readers = {m["name"]: load_file_module(PACKAGE / "metrics" / f"{m['name']}.py")
               for m in run.metrics_of(group)}

    cuda = run.device.type == "cuda"
    run.device_name = torch.cuda.get_device_name(run.device) if cuda else "cpu"
    work = kind.Workload(run)
    run.work_flops = work.flops_per_call
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - PROCESS_START

    spans = None
    if run.trace:
        from . import trace

        spans = trace.Spans(run.device)
        for reader in readers.values():
            for name, target in getattr(reader, "SPANS", {}).items():
                spans.install(name, target, work)
    launched = program.launches()
    _window(run, work, torch)
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    if spans is not None:
        spans.remove()
        run.spans = spans.summary()
        t0 = time.perf_counter()
        run.device_trace = trace.device_trace(run.profile)
        run.trace_read_s = time.perf_counter() - t0
    launched = {k: v - launched[k] for k, v in program.launches().items() if v > launched[k]}
    print(f"portbench: {run.cell['name']} seed {run.seed}: setup {run.setup_s:.3f} s, "
          f"window {run.window_s:.3f} s, {run.n_calls} calls, launches {launched}, "
          f"set-up phases {run.phases}"
          + (f", {run.device_trace['events']} device events traced over {run.traced_s:.3f} s "
             f"({run.traced_calls} calls), read in {run.trace_read_s:.1f} s" if run.trace else ""),
          file=sys.stderr)

    metrics = {}
    for m in run.metrics_of(group):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": run.device_name,
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": max(run.peak_bytes, setup_peak) if cuda else 0}
    breakdown = None
    if run.trace:
        device.update(busy_s=run.device_trace["busy_s"], window_s=run.traced_s)
        breakdown = {k: run.device_trace[k] for k in ("device_ops", "idle_gaps")}

    # a missing or non-finite answer reads as the largest gap JSON can carry
    checks = {k: {"value": c["value"] if math.isfinite(c["value"]) else MISSING,
                  "limit": c["limit"]} for k, c in work.check().items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": run.n_calls, "failed": 0,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def forbidden_modules():
    """The top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark), or cpu for a tiny configuration in the tests")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda":
        bench = read_json(Path("BENCHMARK.json"))
        chips = {c["name"]: c["chips"] for c in bench["workloads"]}.get(args.workload, 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: needs {chips} CUDA card(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    result = run_cell(args)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
