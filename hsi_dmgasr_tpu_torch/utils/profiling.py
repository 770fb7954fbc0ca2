"""The port's tracer: named spans at its layer boundaries, and a
torch.profiler export for operators.

``with span(name):`` opens a span around a block, ``@traced(name)`` around
every call of a function. Tracing is off by default: a span then reads one
module global and hands back a shared no-op context, creating nothing.

``start()`` turns tracing on. Each span then records its name, an id, the
id of the span it opened in (its parent) and of the outermost one (its
root: the spans of one call share it), its host start and end
(``time.perf_counter_ns``), and, once CUDA is in use, a CUDA event pair on
the current stream. It also opens a profiler range of its name, so that
under torch.profiler the span is a CPU range in the raw events, on the
clock of the device's kernels. ``stop()`` turns tracing off; ``spans()``
hands out the spans recorded since the last ``start()``, their device
milliseconds read after a synchronise (never inside a span).

``device_trace(log_dir)`` traces a block: torch.profiler's Chrome trace
``trace.json`` and the block's spans ``spans.json`` (open the first in
Perfetto or chrome://tracing; a span's ``start_ns + epoch_offset_ns`` is on
the trace's clock).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch

_OFF = contextlib.nullcontext()
_tracer = None   # the tracer while tracing is on, else None
_last = None     # the tracer of the last start(), read by spans()


class _Tracer:
    """The spans of one ``start()``, and those open."""

    def __init__(self):
        self.spans = []
        self.open = []
        self.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()


class _Span:
    """One span while tracing is on. Its profiler range is a plain CPU op,
    not a user annotation: torch.profiler draws a user annotation again on
    the device's timeline, where it would read as busy time."""

    __slots__ = ("tracer", "name", "id", "parent", "root", "start_ns", "end_ns",
                 "events", "device_ms", "range")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.events = self.device_ms = self.end_ns = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.id = len(t.spans)
        self.parent = t.open[-1].id if t.open else None
        self.root = t.open[0].id if t.open else self.id
        t.spans.append(self)
        t.open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.tracer.open.pop()
        self.range.__exit__(*exc)
        return False


def span(name):
    """A span of ``name`` around a ``with`` block (a no-op while tracing is
    off)."""
    t = _tracer
    if t is None:
        return _OFF
    return _Span(t, name)


def traced(name):
    """Decorator: every call of the function inside a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = _tracer
            if t is None:
                return fn(*args, **kwargs)
            with _Span(t, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def start():
    """Turn tracing on, with an empty record (nothing if it is on)."""
    global _tracer, _last
    if _tracer is None:
        _tracer = _last = _Tracer()


def stop():
    """Turn tracing off; ``spans()`` still hands out what it recorded."""
    global _tracer
    _tracer = None


def tracing():
    """Whether spans are recorded."""
    return _tracer is not None


def epoch_offset_ns():
    """What to add to a span's host times to put them on torch.profiler's
    clock (the Unix epoch's), sampled at the last ``start()``."""
    return _last.epoch_offset_ns if _last is not None else None


def spans():
    """The spans recorded since the last ``start()``, in the order they
    opened: dicts of ``name``, ``id``, ``parent`` and ``root`` (ids; a root's
    parent is None), ``start_ns`` and ``end_ns`` (host, perf_counter; None
    while open) and ``device_ms`` (None without CUDA events or while open).
    Waits for the device first."""
    t = _last
    if t is None:
        return []
    done = [s for s in t.spans if s.events is not None and s.end_ns is not None]
    if done:
        torch.cuda.synchronize()
        for s in done:
            s.device_ms, s.events = s.events[0].elapsed_time(s.events[1]), None
    return [{"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
             "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": s.device_ms}
            for s in t.spans]


@contextlib.contextmanager
def device_trace(log_dir):
    """A torch.profiler trace of the block (the CPU, and CUDA where there is
    a card) with the tracer on, written to ``log_dir/trace.json`` in
    Chrome's format, and the block's spans to ``log_dir/spans.json``
    (``{"epoch_offset_ns": ..., "spans": [...]}``, as ``spans()`` gives
    them). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    started = not tracing()
    start()
    first = len(_last.spans)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if started:
            stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"epoch_offset_ns": epoch_offset_ns(), "spans": spans()[first:]}, f)
