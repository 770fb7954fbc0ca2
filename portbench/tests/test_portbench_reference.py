"""The benchmark's plain reference and yardstick on the CPU: the reference
agrees with the port's CPU path at tiny widths for a cube and for a train
step, its resize with the port's, the analytic counts give the totals the
benchmark was designed on, and the correctness check fails a run whose
timed path is broken underneath.

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import control, inputs, roofline
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


def _digest(state):
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


# the seeded states of the tiny Pavia configurations (seed 4300000001), as
# the weights were drawn before a configuration could leave out a network
TINY_STATES = {"gae": "114762640fe9b436c42f70556bba85a0dc59922982958238b7700de92ff4e8c8",
               "unet": "13f8ab2586b6e4f1ede850d04d407324f54cdbe21092235316491a47fcaaf57e"}


@pytest.mark.parametrize("config", ["tiny_pavia_x4_r3", "tiny_pavia_x4"])
def test_seeded_states_of_each_network(tiny, config):
    """The same bits for a configuration with both networks; None for a
    network a configuration leaves out, and the same bits for the other;
    the analytic widths likewise."""
    cfg = json.loads((tiny / "portbench" / "configs" / f"{config}.json").read_text())
    gae, unet = inputs.model_states(cfg, 4300000001, "cpu")
    assert {"gae": _digest(gae), "unet": _digest(unet)} == TINY_STATES
    no_gae = {k: v for k, v in cfg.items() if k != "gae_widths"}
    none, unet_only = inputs.model_states(no_gae, 4300000001, "cpu")
    assert none is None and _digest(unet_only) == TINY_STATES["unet"]
    no_unet = dict(cfg, model={k: v for k, v in cfg["model"].items() if k != "unet"})
    gae_only, none = inputs.model_states(no_unet, 4300000001, "cpu")
    assert none is None and _digest(gae_only) == TINY_STATES["gae"]
    unet_w, gae_w = roofline.model_widths(cfg)
    assert roofline.model_widths(no_gae) == (unet_w, None)
    assert roofline.model_widths(no_unet) == (None, gae_w)


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


def faults_of(package, kind):
    """The faults planted under a cell of ``kind``: the ``FAULTS`` list of
    ``<package>/tests/faults/<kind>.py``. A kind without that file has not
    shown that its check fails a broken timed path, and fails here."""
    path = Path(package) / "tests" / "faults" / f"{kind}.py"
    assert path.is_file(), f"kind {kind!r} has no planted faults: {path} is missing"
    faults = harness.load_file_module(path).FAULTS
    assert faults, f"{path} plants no fault"
    return faults


@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, monkeypatch):
    """The whole run but the look for a card, with each fault the cell's
    kind can have planted in the program underneath: ``correct`` comes out
    false."""
    traffic = next(w["traffic"] for w in BENCH["workloads"] if w["name"] == cell)
    kind = json.loads((harness.PACKAGE / "traffic" / f"{traffic}.json").read_text())["kind"]
    for plant in faults_of(harness.PACKAGE, kind):
        with monkeypatch.context() as m:
            plant(m)
            args = SimpleNamespace(workload=f"tiny_{cell}", seed=4200000009, seconds=0.3,
                                   trace=0, device="cpu")
            result = harness.run_cell(args, Path(tiny))
        assert result["correct"] is False, (plant.__name__, result["checks"])


def test_a_kind_without_faults_is_refused(tmp_path):
    with pytest.raises(AssertionError, match="no planted faults"):
        faults_of(tmp_path, "cube")


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
