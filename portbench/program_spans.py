"""The program's own spans (``hsi_dmgasr_tpu_torch/utils/profiling.py``),
for the metrics that read them.

Each such reader calls ``start()`` when it is loaded, which ``run.py``
does only for ``--trace 1``, before set-up: a ``--trace 0`` run never
turns the program's tracer on. A program without the tracer records
nothing, and the readers return None.

A call's spans are those of the root spans (a root opened in no other
span) whose host start lies in the window, from the first timed call's
start to the last one's end; set-up's warm-up and first steps fall
before it. A span's milliseconds are its device time (its CUDA events),
or on the CPU its host time, which stands in for it.
"""

from __future__ import annotations

from collections import defaultdict


def _tracer():
    """The program's tracer module, or None where it has none."""
    from hsi_dmgasr_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "start") else None


def start():
    """Turn the program's tracer on (nothing where it has none)."""
    tracer = _tracer()
    if tracer is not None:
        tracer.start()


def recorded():
    """Every span the program recorded, or [] where it has no tracer."""
    tracer = _tracer()
    return tracer.spans() if tracer is not None else []


def window(spans, t0, t1):
    """The spans whose root opened between host seconds ``t0`` and ``t1``
    (``time.perf_counter``, the clock of ``run.calls``)."""
    lo, hi = t0 * 1e9, t1 * 1e9
    roots = {s["id"] for s in spans if s["parent"] is None and lo <= s["start_ns"] <= hi}
    return [s for s in spans if s["root"] in roots and s["end_ns"] is not None]


def in_window(run):
    """The spans of the run's timed calls."""
    if not run.calls:
        return []
    return window(recorded(), run.calls[0][0], run.calls[-1][1])


def ms(s):
    """A span's device milliseconds, or on the CPU its host milliseconds."""
    return s["device_ms"] if s["device_ms"] is not None else (s["end_ns"] - s["start_ns"]) / 1e6


def total_ms(spans, names):
    """The milliseconds of the spans of ``names``, or None if there is none."""
    found = [ms(s) for s in spans if s["name"] in names]
    return sum(found) if found else None


def self_ms(spans, name, child):
    """The milliseconds of the spans of ``name`` less those of their direct
    children of name ``child``, or None if there is no ``name`` span."""
    own = {s["id"]: ms(s) for s in spans if s["name"] == name}
    if not own:
        return None
    inner = sum(ms(s) for s in spans if s["name"] == child and s["parent"] in own)
    return sum(own.values()) - inner


def per_call(run, names):
    """Milliseconds a timed call in the spans of ``names``, or None."""
    total = total_ms(in_window(run), set(names))
    return None if total is None else total / run.n_calls


# ------------------------------------------------------------ idle gaps


def profile_intervals(events, names):
    """From torch.profiler's raw events: the device operations' (start,
    end), and the host ranges (start, end, name) of the program's spans
    (CPU events of those names), all on the profiler's clock in ns. The
    profiler's device-side user annotations are not device work, and are
    left out."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if not (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif kind == DeviceType.CPU and e.name() in names:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return device, ranges


def idle_by_span(device, ranges, prefix):
    """The device's idle gaps (between the union of ``device`` intervals),
    each put under the innermost host range containing its start, with no
    look-back limit: ({range name, or "outside spans": idle ns}, the idle
    ns of the gaps that start while the host is inside a range whose name
    starts with ``prefix``). Ranges of one thread nest, so a stack of the
    open ones holds the chain of ranges around any instant."""
    from portbench.trace import _union

    _, merged = _union(device)
    by_name, under = defaultdict(int), 0
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for (_, at), (nxt, _) in zip(merged, merged[1:]):
        while i < len(ranges) and ranges[i][0] <= at:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        by_name[stack[-1][2] if stack else "outside spans"] += nxt - at
        if any(r[2].startswith(prefix) for r in stack):
            under += nxt - at
    return dict(by_name), under
