"""``chip_smoke.py`` and the kernels' launch seam, on the CPU.

``chip_smoke.py`` is loaded by path, as the script of the repository's
root that it is. Every launch count it holds a path to on the card comes
from ``expected_launches``: the UNet the path builds (on the meta device),
walked for its Blocks, Upsamples and SelfAttention levels, times the
path's UNet forwards. Each path's counts are pinned here to the numbers
its counted run launched on the H100. The launch seam
(``kernels/build.py:check``, ``dispatch``, ``entry``, ``launch``) runs
with the device and stream lookups stubbed: the CPU has neither.
"""

import contextlib
import ctypes
import importlib.util
import pathlib
import types
import weakref

import pytest
import torch

from hsi_dmgasr_tpu_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _routes(wgmma, thin, flash=0, split=0, einsum=0, kernel=0, transpose=0):
    return {"fused": {"wgmma": wgmma, "thin": thin},
            "attention": {"flash": flash, "split": split, "einsum": einsum},
            "up2_conv3x3": {"kernel": kernel, "transpose": transpose}}


# path -> its route counts in one counted run (a rank's for the two-rank
# paths, an image's for the faces), as launched on the card: 55 Blocks a
# forward, the final conv on the thin route; the r3 level's attention and
# the mid block on the split kernel, x4's 128^2 level on flash; four
# Upsamples a forward on the up path's kernel in f32
LAUNCHED = {
    "pavia_x4_r3": _routes(216, 4, split=24, kernel=16),
    "pavia_x4_r3_ddim": _routes(216, 4, split=24, kernel=16),
    "pavia_x4": _routes(1080, 20, flash=100, split=20, kernel=80),
    "bench_x4_bf16": _routes(216, 4, einsum=4, transpose=16),
    "bench_x4_bf16:full_chain": _routes(1080, 20, einsum=20, transpose=80),
    "train_r3": _routes(1944, 36, split=216, kernel=144),
    "infer_sr3_16_128": _routes(10800, 200, split=1200, kernel=800),
    "pavia_x4_spatial": _routes(1080, 20, flash=100, split=20),
    "pavia_x4_r3_chunked": _routes(648, 12, split=72, kernel=48),
    "pavia_x4_r3_chunked:unchunked": _routes(216, 4, split=24, kernel=16),
    "pavia_x4_tiled": _routes(1296, 24, split=144, kernel=96),
    "pavia_x4_r3_dp": _routes(216, 4, split=24, kernel=16),
    "train_r3_dp": _routes(216, 4, split=24, kernel=16),
}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", sorted(LAUNCHED))
def test_derived_launches_are_the_launched(cs, path):
    got = cs.expected_launches(path)
    assert got == LAUNCHED[path]
    fused = sum(LAUNCHED[path]["fused"].values())
    assert cs.kernels_of(got)[cs.FUSED] == fused


def test_every_fused_path_is_pinned(cs):
    assert set(cs.FORWARDS) == set(LAUNCHED)


def test_a_batchnorm_unet_fuses_only_its_up_path(cs):
    """The BatchNorm DDPM UNet (configs/sample_ddpm_16.json) with fused
    Blocks asked for keeps its Blocks unfused (the fused kernel normalises
    by groups) and runs its four Upsamples on the up path's kernel; its
    attention at 16^2 and in the mid block takes the split kernel at
    inference."""
    unet = cs.path_unet("sample_ddpm_16.json")
    assert unet.eval().fused_routes() == (False, True)
    assert cs.launches_per_forward(unet, 2, 128) == _routes(0, 0, split=6, kernel=4)
    unet.fuse_blocks = False
    assert cs.launches_per_forward(unet, 2, 128) == _routes(0, 0, split=6)


@pytest.fixture
def no_device(monkeypatch):
    """torch.cuda's device and stream lookups stubbed: the CPU has neither."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=1234))


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_passes_the_stream_and_raises_on_an_error_code(no_device, rc):
    seen = []
    t = torch.zeros(4)

    def entry(*args):
        seen.append(args)
        return rc

    if rc:
        with pytest.raises(RuntimeError, match="gn_swish_conv3x3 kernel launch failed: "
                                               "cudaError 700"):
            build.launch("gn_swish_conv3x3", entry, torch.device("cpu"), t, 7, None)
    else:
        build.launch("gn_swish_conv3x3", entry, torch.device("cpu"), t, 7, None)
    assert seen == [(t.data_ptr(), 7, None, 1234)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dispatch_runs_the_plain_version_on_the_cpu_and_refuses_other_devices(device):
    def kernel():
        raise AssertionError("the kernel runs only on CUDA")

    if device == "cpu":
        assert build.dispatch("blocked_dot", torch.device(device), lambda: "plain", kernel) == "plain"
    else:
        with pytest.raises(ValueError, match="^blocked_dot: unsupported device meta$"):
            build.dispatch("blocked_dot", torch.device(device), lambda: "plain", kernel)


def test_check_raises_with_the_kernels_name():
    build.check("split_attention", True, "unused")
    with pytest.raises(ValueError, match="^up2_conv3x3 kernel: bias on cpu$"):
        build.check("up2_conv3x3 kernel", False, "bias on cpu")


def test_entry_declares_its_types_once(monkeypatch):
    fn = types.SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(hsi_kernel=fn))
    assert build.entry("kernel", "hsi_kernel", [ctypes.c_void_p, ctypes.c_int]) is fn
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int] and fn.restype is ctypes.c_int
    build.entry("kernel", "hsi_kernel", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int]


def test_relaunch_repeats_the_wrappers_one_launch(cs, no_device):
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    def wrapper():
        build.launch("blocked_dot", entry, torch.device("cpu"), 1, 2)
        return "out"

    out, again = cs.relaunch(wrapper)
    again()
    assert out == "out" and seen == [(1, 2, 1234)] * 2
    held = torch.zeros(4)
    ptr, ref = held.data_ptr(), weakref.ref(held)
    _, again = cs.relaunch(lambda: build.launch("blocked_dot", entry, torch.device("cpu"), held))
    del held
    assert ref() is not None  # the function keeps the tensor it launched on
    again()
    assert seen[-1] == (ptr, 1234)
    with pytest.raises(AssertionError, match="2 kernel launches"):
        cs.relaunch(lambda: (wrapper(), wrapper()))
