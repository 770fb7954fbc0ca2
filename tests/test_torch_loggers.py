"""The port's loggers, its trace export and on-device colour correction:
``utils/loggers.py``, ``utils/profiling.py`` and
``evalhsi/torch_metrics.py:color_correction_torch`` against
``evalhsi/jax_metrics.py:color_correction_jax`` (atol 1e-5, the JAX
package's own tolerance against its numpy version,
tests/test_metrics.py:38-43)."""

import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.evalhsi.jax_metrics import color_correction_jax
from hsi_dmgasr_tpu_torch.evalhsi.metrics import color_correction
from hsi_dmgasr_tpu_torch.evalhsi.torch_metrics import color_correction_torch
from hsi_dmgasr_tpu_torch.utils import loggers, profiling


def test_tb_logger_writes_a_scalar_tensorboard_reads(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tb = loggers.TBLogger(str(tmp_path))
    tb.add_scalar("l_pix", np.float32(0.25), 3)
    tb.add_scalar("l_pix", 0.125, 7)
    tb.add_image("img", np.zeros((4, 5, 3), np.uint8), 7)
    tb.flush()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("l_pix")] == [(3, 0.25), (7, 0.125)]
    assert acc.Tags()["images"] == ["img"]


def test_tb_logger_is_a_no_op_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    tb = loggers.TBLogger(str(tmp_path / "tb"))
    tb.add_scalar("l_pix", 1.0, 1)
    tb.add_image("img", np.zeros((2, 2, 3), np.uint8), 1)
    tb.flush()
    assert not os.path.exists(tmp_path / "tb")


def test_wandb_logger_is_a_no_op_without_wandb(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level(logging.WARNING, logger="base"):
        w = loggers.WandbLogger({"wandb": {"project": "p"}, "path": {}})
    assert "no-op" in caplog.text
    w.log_metrics({"l_pix": 1.0})
    w.log_image("k", np.zeros((2, 2, 3)))
    w.log_images("k", [np.zeros((2, 2, 3))])
    w.log_checkpoint(1, 2)


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    """The block's spans are in ``trace.json`` as ranges of their names and
    in ``spans.json``; the tracer it started is off again after it."""
    monkeypatch.setattr(profiling, "_tracer", None)
    monkeypatch.setattr(profiling, "_last", None)
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.span("my_region"):
            (x @ x).sum()
    assert not profiling.tracing()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
    with open(tmp_path / "trace" / "spans.json") as f:
        written = json.load(f)
    assert isinstance(written["epoch_offset_ns"], int)
    assert [(s["name"], s["parent"], s["root"]) for s in written["spans"]] == [
        ("my_region", None, 0)]


def _cubes(seed=0, hw=24, c=7):
    rng = np.random.RandomState(seed)
    lr = rng.rand(hw, hw, c).astype(np.float32)
    hr = (0.6 * lr + 0.3 * rng.rand(hw, hw, c) + 0.05).astype(np.float32)
    return lr, hr


@pytest.mark.parametrize("seed", [0, 1])
def test_color_correction_torch_matches_jax(seed):
    lr, hr = _cubes(seed)
    got = color_correction_torch(torch.from_numpy(lr), torch.from_numpy(hr)).numpy()
    want = np.asarray(color_correction_jax(jnp.asarray(lr), jnp.asarray(hr)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0
    # and the host version on every band, which clips the same way
    np.testing.assert_allclose(got, color_correction(lr, hr, num_channels=lr.shape[-1]),
                               atol=1e-5)
