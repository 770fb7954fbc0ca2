"""Spans and the device trace of a ``--trace 1`` run.

Spans are the benchmark's own: it wraps the calls it makes into each layer
of the program, without changing the program. A metric module names the
spans it reads in ``SPANS``, a dict of span name to a target:

  * ``"method:<path>.<name>"``: a method of an object of the run's program
    (``path`` is a dotted attribute path from the program's root object,
    e.g. ``method:pipe.encode``), replaced on that instance;
  * ``"forward:<path>"``: an ``nn.Module`` of the program, by forward
    pre- and post-hooks;
  * ``"function:<module>:<name>"``: a function in a module's namespace, as
    the layer above calls it (``function:hsi_dmgasr_tpu_torch.models.unet:
    gn_swish_conv3x3``), with each call's arguments kept as a signature of
    shapes, dtypes and flags.

Each call of a span records a CUDA event before and after it on the current
stream: the device time between them is the device time of everything the
call enqueued, prepasses and copies included (the device runs behind the
host, so nothing else runs between the two). On the CPU the host clock
stands in, and the numbers are not device numbers.

``device_trace`` reads torch.profiler's trace of the device: the union of
its operations' intervals (busy time), the operations that took most time,
and the idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import importlib
import inspect
import time
from collections import defaultdict

import torch


class _Clock:
    """A CUDA event pair per call, or the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _describe(v):
    if isinstance(v, torch.Tensor):
        return ("tensor", tuple(v.shape), str(v.dtype).replace("torch.", ""))
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_describe(x) for x in v)
    return type(v).__name__


def _resolve(root, path):
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


class Spans:
    """Calls and device milliseconds of each named span."""

    def __init__(self, device):
        self.clock = _Clock(device)
        self.calls = defaultdict(list)   # name -> [(start, end, signature)]
        self._undo = []

    def _record(self, name, fn, sig_of=None):
        def wrapped(*args, **kwargs):
            a = self.clock.mark()
            out = fn(*args, **kwargs)
            self.calls[name].append((a, self.clock.mark(),
                                     sig_of(args, kwargs) if sig_of else None))
            return out
        return wrapped

    def install(self, name, target, root):
        kind, _, where = target.partition(":")
        if kind == "method":
            path, _, attr = where.rpartition(".")
            obj = _resolve(root, path) if path else root
            setattr(obj, attr, self._record(name, getattr(obj, attr)))
            self._undo.append(lambda: delattr(obj, attr))
        elif kind == "forward":
            module = _resolve(root, where)
            starts = []
            h1 = module.register_forward_pre_hook(lambda m, a: starts.append(self.clock.mark()))
            h2 = module.register_forward_hook(
                lambda m, a, o: self.calls[name].append((starts.pop(), self.clock.mark(), None)))
            self._undo += [h1.remove, h2.remove]
        elif kind == "function":
            mod_name, _, attr = where.partition(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            sig = inspect.signature(fn)

            def sig_of(args, kwargs):
                bound = sig.bind(*args, **kwargs)
                return tuple((k, _describe(v)) for k, v in bound.arguments.items())
            setattr(mod, attr, self._record(name, fn, sig_of))
            self._undo.append(lambda: setattr(mod, attr, fn))
        else:
            raise ValueError(f"span {name}: unknown target {target!r}")

    def remove(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def summary(self):
        """{name: {"calls": n, "ms": total, "by_signature": {sig: [n, ms]}}},
        read once the device has finished (synchronise first)."""
        out = {}
        for name, calls in self.calls.items():
            by_sig = defaultdict(lambda: [0, 0.0])
            total = 0.0
            for a, b, s in calls:
                ms = self.clock.ms(a, b)
                total += ms
                by_sig[s][0] += 1
                by_sig[s][1] += ms
            out[name] = {"calls": len(calls), "ms": total, "by_signature": dict(by_sig)}
        return out


def profiler(device):
    """A torch.profiler over the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(intervals):
    """(busy time, merged intervals) of (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def device_trace(prof, top=10):
    """busy_s, the device operations by total seconds, the idle gaps by the
    host operation running at their start, and the number of device
    events, from a stopped profiler (its raw events: building torch's
    event tree would take minutes for a window's worth)."""
    from torch.autograd import DeviceType

    device_ops, host, spans = defaultdict(float), [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device_ops[e.name()[:160]] += (b - a) / 1e9
            spans.append((a, b))
        elif e.device_type() == DeviceType.CPU:
            host.append((a, b, e.name()))
    busy_ns, merged = _union(spans)
    host.sort()
    starts = [a for a, _, _ in host]
    named = defaultdict(float)
    for (_, at), (nxt, _) in zip(merged, merged[1:]):
        doing = "host (no op)"
        i = bisect.bisect_right(starts, at) - 1
        for a, b, name in reversed(host[max(0, i - 256):i + 1]):  # the innermost op running
            if b >= at:
                doing = name
                break
        named[doing] += (nxt - at) / 1e9
    return {"busy_s": busy_ns / 1e9, "events": len(spans),
            "device_ops": sorted(([k, v] for k, v in device_ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in named.items()),
                                key=lambda kv: -kv[1])[:top]}
