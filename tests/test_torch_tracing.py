"""The port's tracer (``utils/profiling.py``) and the spans the program
opens at its layer boundaries.

Off, a span creates nothing; on, spans nest with their parent's and
root's ids, read their device time from CUDA events only after a
synchronise, and are CPU ranges of torch.profiler on its clock. A tiny
``super_resolve`` and a tiny ``train_step_from_hr`` on the CPU give the
trees of spans the benchmark's per-layer metrics read.
"""

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hsi_dmgasr_tpu_torch.data.device_cache import DeviceSceneCache
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.utils import profiling

GAE_CFG = {"n_subs": 4, "n_ovls": 1, "n_colors": 8, "n_feats": 8, "G": 3}
STEPS = 3  # t_start: UNet forwards a chain


@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    """Each test starts with tracing off and nothing recorded, and leaves
    the module as it found it."""
    monkeypatch.setattr(profiling, "_tracer", None)
    monkeypatch.setattr(profiling, "_last", None)


class _Counter:
    """A constructor replaced by one that counts its calls."""

    def __init__(self, monkeypatch, owner, attr, make=None):
        self.calls = 0
        real = getattr(owner, attr)

        def counted(*args, **kwargs):
            self.calls += 1
            return (make or real)(*args, **kwargs)
        monkeypatch.setattr(owner, attr, counted)


class _NoEvent:
    def record(self):
        pass


def _opt():
    return {
        "model": {
            "which_model_G": "sr3",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2], "attn_res": [8],
                     "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 6,
                                  "linear_start": 1e-6, "linear_end": 1e-2}
                              for p in ("train", "val")},
            "diffusion": {"image_size": 16, "channels": 3, "conditional": True,
                          "t_start": STEPS},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
        "path": {},
    }


@pytest.fixture(scope="module")
def pipe():
    return DMGASRPipeline(_opt(), None, GAE_CFG, seed=0, device="cpu")


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent]


def test_span_off_creates_nothing(monkeypatch):
    ranges = _Counter(monkeypatch, torch._C._profiler, "_RecordFunctionFast")
    user_ranges = _Counter(monkeypatch, torch.profiler, "record_function")
    events = _Counter(monkeypatch, torch.cuda, "Event", make=lambda **kw: _NoEvent())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    calls = []

    @profiling.traced("f")
    def f(x):
        calls.append(x)
        return x + 1

    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profiling.span("a"):
        assert f(1) == 2
    assert calls == [1] and not profiling.tracing() and profiling.spans() == []
    assert ranges.calls == user_ranges.calls == events.calls == 0
    profiling.start()
    with profiling.span("a"):
        pass
    assert ranges.calls == 1 and events.calls == 2  # the range and an event pair, once on


def test_spans_nest_with_parent_and_root_ids():
    @profiling.traced("leaf")
    def leaf():
        pass

    profiling.start()
    profiling.start()  # idempotent: the record goes on
    with profiling.span("call"):
        with profiling.span("inner"):
            leaf()
        leaf()
    with profiling.span("call"):
        leaf()
    profiling.stop()
    leaf()  # off: not recorded
    got = [(s["name"], s["id"], s["parent"], s["root"]) for s in profiling.spans()]
    assert got == [("call", 0, None, 0), ("inner", 1, 0, 0), ("leaf", 2, 1, 0),
                   ("leaf", 3, 0, 0), ("call", 4, None, 4), ("leaf", 5, 4, 4)]
    for s in profiling.spans():
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None  # no CUDA here
    inner, outer = profiling.spans()[1], profiling.spans()[0]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    profiling.start()  # a new record
    assert profiling.spans() == []


def test_device_ms_read_from_events_after_a_synchronise(monkeypatch):
    """Each span records an event pair; ``spans()`` synchronises, then reads
    the pair's elapsed time, and never while the span is open."""
    log = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self):
            self.t = time.perf_counter()
            log.append("record")

        def elapsed_time(self, end):
            log.append("elapsed")
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append("sync"))
    profiling.start()
    with profiling.span("outer"):
        with profiling.span("inner"):
            time.sleep(0.01)
    assert log == ["record"] * 4
    spans = profiling.spans()
    assert log[4:] == ["sync", "elapsed", "elapsed"]
    assert spans[0]["device_ms"] >= spans[1]["device_ms"] >= 10.0
    assert profiling.spans() == spans and log.count("elapsed") == 2  # read once


def test_spans_are_profiler_ranges_on_its_clock():
    """Under torch.profiler each span is a CPU range of its name enclosing
    its ops; its host start and end, moved onto the profiler's clock by
    ``epoch_offset_ns``, lie within 100 us of the range's."""
    x = torch.randn(64, 64)
    profiling.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            y = x @ x
            with profiling.span("inner"):
                (y @ x).sum()
    profiling.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    off = profiling.epoch_offset_ns()
    for s in profiling.spans():
        (rng,) = [e for e in events if e.name() == s["name"]]
        a, b = rng.start_ns(), rng.start_ns() + rng.duration_ns()
        assert abs(s["start_ns"] + off - a) < 100_000 and abs(s["end_ns"] + off - b) < 100_000
        ops = [e for e in events if e.name() in ("aten::mm", "aten::sum")
               and a <= e.start_ns() <= b]
        assert ops and all(e.start_ns() + e.duration_ns() <= b for e in ops)


def test_super_resolve_span_tree(pipe):
    rng = np.random.RandomState(0)
    cube = torch.as_tensor(rng.rand(1, 16, 16, 8).astype(np.float32))
    n_attn = sum(type(m).__name__ == "SelfAttention" for m in pipe.ddpm.unet.modules())
    profiling.start()
    pipe.super_resolve(cube, generator=torch.Generator().manual_seed(1))
    profiling.stop()
    spans = profiling.spans()
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "sr.cube" and all(s["root"] == root["id"] for s in spans)
    assert _children(spans, root["id"]) == ["gae.encode", "sampler.chain", "gae.decode"]
    (chain,) = [s for s in spans if s["name"] == "sampler.chain"]
    forwards = [s for s in spans if s["parent"] == chain["id"]]
    assert [s["name"] for s in forwards] == ["unet.forward"] * STEPS
    for f in forwards:
        inner = _children(spans, f["id"])
        assert inner.count("unet.up_conv") == 1 and inner.count("unet.attention") == n_attn
        assert set(inner) == {"unet.up_conv", "unet.attention"}


def test_train_step_span_tree(pipe):
    rng = np.random.RandomState(1)
    cache = DeviceSceneCache([rng.rand(32, 32, 8).astype(np.float32)], 16, device="cpu")
    profiling.start()
    hr = cache.sample(torch.Generator().manual_seed(2), 2)
    pipe.train_step_from_hr(hr, scale=4, generator=torch.Generator().manual_seed(3))
    profiling.stop()
    spans = profiling.spans()
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["train.crops", "train.step"]
    assert _children(spans, roots[0]["id"]) == []
    step = roots[1]["id"]
    assert _children(spans, step) == ["train.degrade", "train.encode", "train.grads",
                                      "train.update"]
    (grads,) = [s for s in spans if s["name"] == "train.grads"]
    assert _children(spans, grads["id"]) == ["unet.forward"]
    assert "gae.encode" not in {s["name"] for s in spans}  # the private path
