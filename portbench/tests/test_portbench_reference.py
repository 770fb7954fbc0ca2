"""The benchmark's plain reference and yardstick on the CPU: the reference
agrees with the port's CPU path at tiny widths for a cube and for a train
step, its resize with the port's, the analytic counts give the totals the
benchmark was designed on, and the correctness check fails a run whose
timed path is broken underneath.

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import control, roofline
from portbench import run as harness
from portbench.reference import imresize
from portbench.tests.tiny import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"), limits=1e-3)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(tiny, cell):
    """f32 on both sides; the port's fused Blocks on their plain versions
    (bf16 weights, as the reference rounds them). Limits from the readings
    at this size: cubes within 2e-4 (5.4e-5 read), steps within 1e-5."""
    out = control.readings(f"tiny_{cell}", 4100000001, control=False, device="cpu", root=tiny)
    for name, value in out["program"].items():
        assert value <= (2e-4 if name.startswith("cube") else 1e-4), (name, value)


def test_resize_agrees_with_the_port():
    from hsi_dmgasr_tpu_torch.data.imresize import make_imresize_torch

    x = torch.rand((2, 32, 32, 5), generator=torch.Generator().manual_seed(0))
    for out_hw in ((8, 8), (32, 32), (128, 128)):
        port = make_imresize_torch((32, 32), output_shape=out_hw, device="cpu")(x)
        assert (imresize.resize(x, out_hw) - port).abs().max() < 1e-5


def test_cube_totals():
    """56.5 TFLOP an r3 cube (4 UNet forwards at B=9, 512^2: 13.51 each,
    and the GAE's 2.47), 489 TFLOP an x4 cube (20 x 24.33 + 2.47)."""
    cfg = {c["name"]: json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]}
    r3 = roofline.cube_flops(cfg["pavia_x4_r3"], 1, 512, 4) / 1e12
    x4 = roofline.cube_flops(cfg["pavia_x4"], 1, 512, 20) / 1e12
    assert abs(r3 - 56.5) < 0.1 and abs(x4 - 489.1) < 0.1
    assert abs(roofline.unet_flops(9, 512, 128) / 1e12 - 13.51) < 0.01
    assert abs(roofline.gae_flops(1, 512) / 1e12 - 2.47) < 0.01
    assert abs(roofline.train_step_flops(cfg["pavia_x4_r3"], 4, 128) / 1e12 - 9.64) < 0.01


def test_kernel_work_counts_each_byte_once():
    t = lambda *s, dt="float32": ("tensor", s, dt)  # noqa: E731
    sig = (("x", t(9, 64, 64, 256)), ("kernel", t(3, 3, 256, 512)), ("res_kernel", None),
           ("x2", None), ("residual", t(9, 64, 64, 512)), ("emit_stats", False))
    flops, nbytes = roofline.fused_block_work(sig)
    px = 9 * 64 * 64
    assert flops == 2.0 * px * 512 * 256 * 9
    assert nbytes == 4 * px * 256 + 4 * px * 512 * 2 + 2 * 9 * 256 * 512
    flops, nbytes = roofline.flash_work((("q", t(9, 16384, 1, 256)),))
    assert flops == 4.0 * 9 * 16384 ** 2 * 256 and nbytes == 4 * 4 * 9 * 16384 * 256
    assert roofline.least_seconds(989e12, 0, "NVIDIA H100 80GB HBM3") == 1.0
    with pytest.raises(ValueError):
        roofline.peaks("some other card")


# ----------------------------------------------------------------- faults


def _altered_cube(monkeypatch):
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    real = DMGASRPipeline.super_resolve

    def altered(self, *a, **kw):
        out = real(self, *a, **kw).clone()
        out[0, 0, 0, 0] = 1.0 - out[0, 0, 0, 0]
        return out
    monkeypatch.setattr(DMGASRPipeline, "super_resolve", altered)


def _half_batch_unet(monkeypatch):
    from hsi_dmgasr_tpu_torch.models.unet import UNet

    real = UNet.forward

    def half(self, x, time, spatial=None):
        n = x.shape[0] // 2 or 1
        out = real(self, x[:n], time[:n], spatial)
        return out[torch.arange(x.shape[0]) % n]  # the other half copied, not computed
    monkeypatch.setattr(UNet, "forward", half)


def _chain_step_unchanged(monkeypatch):
    from hsi_dmgasr_tpu_torch.diffusion.gaussian import GaussianDiffusion

    monkeypatch.setattr(GaussianDiffusion, "_step", lambda self, fn, x, *a, **kw: x)


def _train_step_unchanged(monkeypatch):
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    def frozen(self):
        self._start_ema()
        self.step += 1
    monkeypatch.setattr(DDPMModel, "apply_gradients", frozen)


def _half_batch_loss(monkeypatch):
    from hsi_dmgasr_tpu_torch.diffusion.gaussian import GaussianDiffusion

    real = GaussianDiffusion._loss

    def half(self, noise, eps_pred, weight):
        n = noise.shape[0] // 2
        return real(self, noise[:n], eps_pred[:n], weight[:n])
    monkeypatch.setattr(GaussianDiffusion, "_loss", half)


def _altered_loss(monkeypatch):
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    real = DMGASRPipeline.train_step_from_hr
    monkeypatch.setattr(DMGASRPipeline, "train_step_from_hr",
                        lambda self, *a, **kw: real(self, *a, **kw) * 1.01)


FAULTS = {"cube": [_altered_cube, _half_batch_unet, _chain_step_unchanged],
          "train": [_train_step_unchanged, _half_batch_loss, _altered_loss]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, monkeypatch):
    """The whole run but the look for a card, with each fault the cell can
    have planted in the program underneath: ``correct`` comes out false."""
    kind = json.loads((REPO / "portbench" / "traffic"
                       / f"{next(w['traffic'] for w in BENCH['workloads'] if w['name'] == cell)}"
                       ".json").read_text())["kind"]
    for plant in FAULTS[kind]:
        with monkeypatch.context() as m:
            plant(m)
            args = SimpleNamespace(workload=f"tiny_{cell}", seed=4200000009, seconds=0.3,
                                   trace=0, device="cpu")
            result = harness.run_cell(args, Path(tiny))
        assert result["correct"] is False, (plant.__name__, result["checks"])


# --------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, tmp_path):
    """On the card, at a small size the kernels take (channels in 32s): the
    control, the reference in TF32 in the program's place, reads at least
    three times what the program reads on one of the cell's numbers, on
    three seeds. At the cell's own size: ``python3 -m portbench.control``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = make_root(tmp_path, size=64, inner=32, groups=8, feats=16, limits=1.0)
    for seed in (5100000001, 5100000002, 5100000003):
        out = control.readings(f"tiny_{cell}", seed, control=True, device="cuda", root=root)
        assert any(out["control"][k] >= 3 * out["program"][k] for k in out["program"]), out
