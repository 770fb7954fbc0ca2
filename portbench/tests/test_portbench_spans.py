"""The readers of the program's spans (``portbench/program_spans.py`` and
the ``program_span`` metrics) on synthetic spans and profiler events, and
a ``--trace 0`` run, which leaves the program's tracer off.

    python -m pytest -q portbench/tests/test_portbench_spans.py
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import program_spans
from portbench import run as harness
from portbench.tests.tiny import make_root

from hsi_dmgasr_tpu_torch.utils import profiling

PACKAGE = harness.PACKAGE


@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    monkeypatch.setattr(profiling, "_tracer", None)
    monkeypatch.setattr(profiling, "_last", None)


def _span(sid, name, parent, root, start, end, device_ms=None):
    return {"name": name, "id": sid, "parent": parent, "root": root,
            "start_ns": start, "end_ns": end, "device_ms": device_ms}


def _cube_spans(t0_ns, chain_ms, forward_ms, sid=0):
    """One call's spans: sr.cube -> gae.encode, sampler.chain -> unet.forward
    (-> unet.up_conv), gae.decode."""
    spans = [_span(sid, "sr.cube", None, sid, t0_ns, t0_ns + 100, 99.0),
             _span(sid + 1, "gae.encode", sid, sid, t0_ns + 1, t0_ns + 2, 5.0),
             _span(sid + 2, "sampler.chain", sid, sid, t0_ns + 3, t0_ns + 90, chain_ms)]
    for k, f in enumerate(forward_ms):
        fid = sid + 3 + 2 * k
        spans += [_span(fid, "unet.forward", sid + 2, sid, t0_ns + 4 + k, t0_ns + 5 + k, f),
                  _span(fid + 1, "unet.up_conv", fid, sid, t0_ns + 4 + k, t0_ns + 5 + k, 1.0)]
    return spans


def test_sampler_self_time_is_the_chain_less_its_forwards():
    spans = _cube_spans(0, 50.0, [10.0, 12.0, 13.0])
    assert program_spans.self_ms(spans, "sampler.chain", "unet.forward") == pytest.approx(15.0)
    assert program_spans.total_ms(spans, {"unet.up_conv"}) == pytest.approx(3.0)
    assert program_spans.self_ms(spans, "train.step", "train.grads") is None


def test_host_time_stands_in_without_device_time():
    assert program_spans.ms(_span(0, "a", None, 0, 1_000_000, 3_500_000)) == 2.5
    assert program_spans.ms(_span(0, "a", None, 0, 1_000_000, 3_500_000, 7.0)) == 7.0


def test_spans_outside_the_window_are_dropped(monkeypatch):
    """Calls whose root opened before the window (set-up's warm-up) or after
    it are left out with all their children."""
    s = 1_000_000_000
    spans = (_cube_spans(1 * s, 50.0, [10.0], sid=0) + _cube_spans(3 * s, 40.0, [10.0], sid=10)
             + _cube_spans(5 * s, 30.0, [10.0], sid=20))
    kept = program_spans.window(spans, 2.0, 4.0)
    assert {x["root"] for x in kept} == {10} and len(kept) == 5
    assert program_spans.self_ms(kept, "sampler.chain", "unet.forward") == pytest.approx(30.0)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    run = SimpleNamespace(calls=[(2.5, 3.0), (3.0, 3.5)], n_calls=2)
    assert program_spans.per_call(run, ["unet.up_conv"]) == pytest.approx(0.5)
    assert program_spans.per_call(run, ["train.grads"]) is None


def test_idle_gap_goes_under_the_innermost_range():
    """Gaps between device intervals, each under the innermost host range
    holding its start; gaps outside every train.* range count in the table
    but not in the total."""
    device = [(0, 10), (12, 20), (20, 25), (30, 40), (41, 50), (60, 70)]
    ranges = [(5, 45, "train.step"), (8, 35, "train.grads"), (9, 22, "unet.forward"),
              (46, 55, "other")]
    by_name, under = program_spans.idle_by_span(device, ranges, "train.")
    # gaps: 10-12 in unet.forward, 25-30 in train.grads (its forward ended),
    # 40-41 in train.step, 50-60 in "other"
    assert by_name == {"unet.forward": 2, "train.grads": 5, "train.step": 1, "other": 10}
    assert under == 8
    by_name, under = program_spans.idle_by_span(device, [], "train.")
    assert by_name == {"outside spans": 18} and under == 0


class _Event:
    def __init__(self, name, kind, start, dur, annotation=False):
        self._v = name, kind, start, dur, annotation

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_profile_intervals_keep_device_work_and_program_ranges():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Event("kernel", cuda, 0, 10), _Event("train.grads", cuda, 0, 100, True),
              _Event("train.grads", cpu, 5, 30), _Event("aten::mm", cpu, 6, 2),
              _Event("kernel", cuda, 20, 5)]
    device, ranges = program_spans.profile_intervals(events, {"train.grads"})
    assert device == [(0, 10), (20, 25)] and ranges == [(5, 35, "train.grads")]


def _reader(name):
    return harness.load_file_module(PACKAGE / "metrics" / f"{name}.py")


def test_program_idle_reader_divides_by_the_traced_steps(monkeypatch, capsys):
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Event("k", cuda, 0, 1_000_000), _Event("k", cuda, 3_000_000, 1_000_000),
              _Event("k", cuda, 9_000_000, 1_000_000),
              _Event("train.step", cpu, 500_000, 3_000_000)]
    profile = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    reader = _reader("program_idle_ms.train")
    monkeypatch.setattr(profiling, "spans", lambda: [_span(0, "train.step", None, 0, 0, 1)])
    run = SimpleNamespace(profile=profile, traced_calls=2)
    assert reader.read(run) == pytest.approx(1.0)  # the 2 ms gap in train.step, over 2 steps
    assert "{'outside spans': 2.5, 'train.step': 1.0}" in capsys.readouterr().err


def test_readers_read_nothing_from_a_program_without_the_tracer(monkeypatch):
    """The parent's program has no ``start``/``spans``: loading a reader
    raises nothing and each reads None."""
    monkeypatch.delattr(profiling, "spans")
    run = SimpleNamespace(calls=[(0.0, 1.0)], n_calls=1, profile=None, traced_calls=1)
    for name in ("up_conv_ms.cube", "attention_ms.cube", "sampler_ms.cube", "latents_ms.train",
                 "grads_ms.train", "update_ms.train", "program_idle_ms.train"):
        assert _reader(name).read(run) is None
    assert not profiling.tracing()


def test_loading_a_reader_starts_the_program_tracer():
    _reader("grads_ms.train")
    assert profiling.tracing()


def test_untraced_run_starts_no_tracer(tmp_path):
    root = make_root(tmp_path, limits=1e-3)
    args = argparse.Namespace(workload="tiny_pavia_x4_r3.cube", seed=3000000017, seconds=0.2,
                              trace=0, device="cpu")
    result = harness.run_cell(args, root=root)
    assert result["correct"] is True
    assert not profiling.tracing() and profiling.spans() == []
