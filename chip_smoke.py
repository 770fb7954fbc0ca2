#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of DMGASR on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports only torch and hsi_dmgasr_tpu_torch,
and fails (exit code != 0, no result line) without a GPU or outside a
checkout. It drives six main paths. Three are x4 DMGASR on a
512x512x102 Pavia-geometry cube at full width (UNet inner 64, mults
1,2,4,8,8, res_blocks 2, GroupNorm 32, cosine T=20; GAE n_subs 16,
n_ovls 4, n_feats 64, G=9; seeded random weights):

  * configs/pavia_x4_r3.json: image_size 128, the chain entered at
    t_start=4, latent affine; attention at 64^2 and 32^2 stays below the
    flash gate. f32 activations. 220 fused-Block launches per cube.
  * configs/pavia_x4.json: image_size 64, the full T=20 chain, no affine;
    attention at the 128^2 level (16384 tokens, D=256) goes to the flash
    kernel, 5 layers per UNet forward. f32 activations. 100 flash and 1100
    fused-Block launches per cube.
  * bench_x4_bf16: the port's flagship bench (hsi_dmgasr_tpu_torch/bench.py)
    at its defaults: image_size 512, bf16 weights and activations, fused
    Blocks; attention only in the mid block (32^2, below the gate). Its
    two rows, the t_start=4 cube and the full T=20 chain, launch 220 and
    1100 fused Blocks and no flash; it prints the bench's JSON line (both
    cube times, the UNet step's roofline share).

The fourth and fifth are the two training stages at the same full
width, chained as a user chains them:

  * train_gae: stage-1 GAE training through the port's CLI (cli.ae, at
    its defaults: n_subs 16, n_ovls 4, n_colors 102, n_feats 64, scale 4,
    batch 8), HLoss, Adam 1e-4, device-resident scenes: 8 HR crops of
    128^2 x 102 a step, 72 group images through the shared encoder and
    decoder (cuDNN, TF32 off). Cut: 12 steps over 2 epochs, ending on the
    CLI's save; then cli.gae_test on the saved directory over the 3 val
    scenes at 128^2. No kernel of the port runs.
  * train_r3: configs/pavia_x4_r3.json through the port's driver
    (stage2_driver.train, as the CLI runs it): dropout 0.2, Adam with the
    cosine lr, EMA 0.999 sampled at eval, device-resident scenes with the
    degradation on the card; 4 HR crops of 128^2 x 102 a step, so 36
    latents through the unfused autograd UNet (TF32 off). Cut: 12 steps,
    then one periodic save, one validation (3 val scenes of 128^2 x 3
    chains at t_start=4, fused Blocks) and one best save; its GAE is the
    directory train_gae saved. The steps launch no kernel; the validation
    launches 55 x 4 fused Blocks per (scene, chain), 1980.

Both train on the same 8 training scenes of 256^2 and validate on the
same 3 val scenes of 128^2, written from a seed under build/scenes.

The sixth is the int8 probe (hsi_dmgasr_tpu_torch.tools.microbench_int8):

  * int8_probe: chains of 4000 dependent dots x @ w with a requantize
    step, at M = 4096 and (K, N) = (512, 512), (576, 256), (192, 256),
    int8 -> int32 and bf16 -> f32, through the library's dot and through
    the blocked-dot kernel; each chain captured in a CUDA graph and
    replayed once per input (4 inputs). 6 x (1 + 4 x 4000) = 96006
    blocked-dot launches.

In order:

 1. prints the card (nvidia-smi name and power limit) and versions;
 2. builds every CUDA kernel of the port from csrc/ (one nvcc each, all
    at once) and prints the build seconds and register use;
 3. for each Pavia path and each bench row: sets the launch counts to 0,
    drives one cube while recording every launch signature of both
    kernels, checks the cube (shape, finite, in [0, 1]) and the exact
    launch counts, times it (median of 3) and reads the peak memory; holds
    one full-width UNet forward with the kernels against the same forward
    with their plain versions (in bf16 for the bench; the f32 paths also
    report both against the unfused f32 forward). Then train_gae: counts
    to 0, cli.ae's steps, no launch counted; every step's loss finite, the
    saved directory loaded back into a fresh GAE bit for bit, one batch-1
    step on the card against the same step on the CPU (HLoss in f32, and
    HLoss plus the perceptual term on a seeded VGG19 with given bands in
    f64), every
    gae_test cube's metrics finite; ms per step (median after 2 warm-up
    steps), crops per second, peak memory, the step's share of its f32
    roofline, the perceptual step's ms, seconds per gae_test cube. Then
    train_r3 on that checkpoint:
    counts to 0, stage2_driver's steps and validation, with the counts read at
    both ends of the validation; every step's loss finite, the EMA after
    every step against 0.999 EMA_prev + 0.001 params on a few leaves, the
    periodic checkpoint loaded back into a fresh DDPMModel bit for bit,
    every live and EMA weight's _version moved by one more step (the fused
    Block's pack key) and the fused EMA UNet then against its plain-kernel
    and unfused forwards, one
    batch-1 step on the card against the same step on the CPU; ms per step
    (median after 2 warm-up steps), latents per second, peak memory, the
    step's share of its f32 roofline, seconds per validation cube. Then the probe:
    counts to 0, the probe run once, the exact launch counts, and the int8
    chains of the kernel and the library held equal bit for bit after 4000
    links;
 4. for each recorded signature (f32 or bf16), on the card at that shape
    (B=9): kernel vs its plain PyTorch version (asserted within tolerance), the
    kernel's, the plain version's and one library call's times, and the
    bound; for the fused Block also its launch alone, replayed in a CUDA
    graph, and each signature's and level's share of its bound and ratio
    to cuDNN; the flash kernel also at D=128 and at D=512 (S >= 8192) and
    at pavia_x4_r3's 64^2 attention, and at each of its shapes with bf16
    q, k and v as well, each flash shape with the prepass's
    device time (torch.profiler) and the einsum route's time beside it; the
    blocked dot at each probe case and dtype, with its share of the bound,
    TOP/s and ratio to the library call, and a 3-link captured chain
    against the same chain run eagerly;
 5. the unfused UNet against the reference torch golden
    (tests/golden/unet_diffusion_golden.npz);
 6. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}.

Details go to chiprun_out/chip_smoke.json. ``--profile`` adds one traced
cube per path (the bench's t_start=4 row for bench_x4_bf16, one train
step each for train_gae and train_r3): device time by kernel name
(torch.profiler), the device's idle share and the seconds of each stage
(GAE encode, reverse chain, GAE decode; for a stage-1 step: forward +
loss, backward, Adam; for a stage-2 step: degradation, GAE encode, UNet
forward + backward, Adam + EMA), into chip_smoke_profile.json beside it.
train_gae writes its checkpoint under build/train_gae, train_r3 its
experiment directory under build/train_r3.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "unet_diffusion_golden.npz")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

GAE_CFG = {"n_subs": 16, "n_ovls": 4, "n_colors": 102, "n_feats": 64, "G": 9}
CUBE = (1, 512, 512, 102)
FUSED, FLASH, DOT = "gn_swish_conv3x3", "flash_attention", "blocked_dot"
PROBE = "int8_probe"
# path -> (config, launches per cube of each kernel)
PATHS = {
    # 55 fused Blocks per UNet forward x t_start=4; attention below the gate
    "pavia_x4_r3": ("pavia_x4_r3.json", {FUSED: 220, FLASH: 0}),
    # 55 fused Blocks and 5 flash attentions per forward x T=20
    "pavia_x4": ("pavia_x4.json", {FUSED: 1100, FLASH: 100}),
}
# the bf16 flagship path, the port's bench at its defaults (512x512x102,
# image_size 512, batch 1, bf16, fused): its two rows, each with its launches
# per cube (55 fused Blocks per UNet forward; attention only in the mid
# block, at 32^2, below the flash gate)
BENCH, BENCH_FULL = "bench_x4_bf16", "bench_x4_bf16:full_chain"
BENCH_PATHS = {BENCH: {FUSED: 220, FLASH: 0}, BENCH_FULL: {FUSED: 1100, FLASH: 0}}
# stage-2 training under configs/pavia_x4_r3.json through the port's driver:
# TRAIN_STEPS steps (no kernel launch: training runs the unfused autograd
# UNet), then one validation of 3 scenes x 3 chains, each 55 fused Blocks
# per UNet forward x t_start=4 at 128^2 ... 8^2 (attention at 16^2, on the
# einsum route)
TRAIN, TRAIN_STEPS = "train_r3", 12
TRAIN_VAL = {FUSED: 55 * 4 * 3 * 3, FLASH: 0}
TRAIN_SCENES, TRAIN_SCENE_HW, VAL_HW = 8, 256, 128
UNET_PATHS = (*PATHS, *BENCH_PATHS, TRAIN)
# stage-1 GAE training through the port's CLI (cli.ae) at the Pavia GAE's
# width, device-resident scenes: 8 HR crops of 128^2 x 102 a step, so 72
# group images through the shared encoder and decoder. 64 augmented items
# / 8 = 8 steps an epoch: 2 epochs cut at TRAIN_GAE_STEPS end on the
# second epoch's save. The GAE is cuDNN convolutions: no kernel of the port.
TRAIN_GAE, TRAIN_GAE_STEPS, TRAIN_GAE_BATCH, TRAIN_GAE_EPOCHS = "train_gae", 12, 8, 2
# the perceptual term's weight in the card-vs-CPU check (the shipped 1e-3
# would hide the term under the loss's rtol), and the bands it replays
TRAIN_GAE_P_WEIGHT, TRAIN_GAE_BANDS = 1.0, (5, 50, 97)
# flash checks beside the path's own shape: D=128 (two heads) and D=512
# with a ragged S, both past the 8192-token gate, and pavia_x4_r3's 64^2
# attention (4096 tokens, D=512), which the gate keeps on the einsum path:
# its row times both routes, for the gate's crossover. Each shape, and
# pavia_x4's own, also with bf16 q, k and v, which no path launches.
FLASH_EXTRA = ((9, 16384, 2, 128), (4, 8200, 1, 512), (9, 4096, 1, 512))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# kernel vs plain version on the card: the same bf16 weights and (bf16
# input) activations, f32 sums in another order (and a rare one-ulp flip of
# a bf16 activation or p)
TOL_OUT = 1e-2      # atol = rtol on out and the res projection
TOL_STATS = 1e-3    # max |diff| / max |plain| on the per-row moments
# on the attention output, whose elements are weighted means of
# unit-variance values, typically 0.01-0.02 at these shapes
TOL_FLASH_ABS, TOL_FLASH_REL = 1e-3, 1e-2
# full UNet forward, the JAX package's fused-UNet tolerance: atol = rtol
TOL_UNET = 3e-2
# training: the EMA against its recomputation from per-step snapshots (max
# |diff| / max |want| per leaf), and one step on the card against the same
# step on the CPU (loss relative; gradients atol 1e-3 of the largest |g|)
TOL_EMA, TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-6, 1e-4, 1e-3
# blocked dot, bf16: f32 sums in another order than the plain version's
# float64, on outputs of about sqrt(K) = 14-24 (int8 is held bit for bit)
TOL_DOT_ABS, TOL_DOT_REL = 1e-3, 1e-4


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=20, reps=5):
    """Mean device milliseconds of one fn(): `calls` back-to-back calls
    captured in one CUDA graph, replayed `reps` times, CUDA events. The
    host's launch cost, as long as a kernel of a few microseconds, stays
    out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


# ------------------------------------------------------------ signatures


@contextmanager
def recording(fused_calls, flash_calls):
    """Record the signature of every fused-Block and flash call the UNet
    makes. The real wrappers still run, and count their own launches."""
    from hsi_dmgasr_tpu_torch.kernels import attention as attn_mod
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod

    real_fused, real_flash = unet_mod.gn_swish_conv3x3, attn_mod.flash_attention

    def rec_fused(x, gn_scale, gn_bias, kernel, bias, **kw):
        x2 = kw.get("x2")
        sig = (tuple(x.shape), 0 if x2 is None else x2.shape[-1], kernel.shape[-1],
               kw.get("time_bias") is not None, kw.get("residual") is not None,
               kw.get("stats_in") is not None, kw.get("stats_in2") is not None,
               bool(kw.get("emit_stats")), kw.get("res_kernel") is not None,
               dtype_name(x.dtype))
        fused_calls[sig] = fused_calls.get(sig, 0) + 1
        return real_fused(x, gn_scale, gn_bias, kernel, bias, **kw)

    def rec_flash(q, k, v, scale):
        sig = (tuple(q.shape), dtype_name(q.dtype))
        flash_calls[sig] = flash_calls.get(sig, 0) + 1
        return real_flash(q, k, v, scale)

    with mock.patch.object(unet_mod, "gn_swish_conv3x3", rec_fused), \
            mock.patch.object(attn_mod, "flash_attention", rec_flash):
        yield


@contextmanager
def plain_kernels():
    """Route the UNet through both kernels' plain versions."""
    from hsi_dmgasr_tpu_torch.kernels import attention as attn_mod
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod

    def plain(*args, packed=None, **kw):
        return fc.gn_swish_conv3x3_plain(*args, **kw)

    with mock.patch.object(unet_mod, "gn_swish_conv3x3", plain), \
            mock.patch.object(attn_mod, "flash_attention", fa.flash_attention_plain):
        yield


@contextmanager
def unfused(unet):
    """Run ``unet`` on the plain autograd path (no fused Block at all)."""
    from hsi_dmgasr_tpu_torch.models.unet import ResnetBlock

    blocks = [m for m in unet.modules() if isinstance(m, ResnetBlock)]
    unet.fuse_blocks = False
    for b in blocks:
        b.fuse = False
    try:
        yield
    finally:
        unet.fuse_blocks = True
        for b in blocks:
            b.fuse = True


def divergence(y, ref):
    """max |y - ref|, and it and the RMS of y - ref over those of ref."""
    d = (y.float() - ref.float()).abs()
    ref = ref.float()
    return {"max_abs": d.max().item(), "max_rel": d.max().item() / ref.abs().max().item(),
            "rms_rel": (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()}


def within(y, ref, tol):
    """|y - ref| <= tol + tol * |ref| everywhere."""
    return bool(((y.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


def check_unet(name, unet, x, t, against_unfused=False):
    """The f32 UNet forward with the kernels against the same forward on
    their plain versions, elementwise within TOL_UNET, and both against the
    unfused forward: reported, and with ``against_unfused`` held to
    TOL_UNET too."""
    y_kernel = unet(x, t)
    with plain_kernels():
        y_plain = unet(x, t)
    with unfused(unet):
        y_f32 = unet(x, t)
    err = divergence(y_kernel, y_plain)
    err["kernel_vs_unfused"] = divergence(y_kernel, y_f32)
    err["plain_vs_unfused"] = divergence(y_plain, y_f32)
    if not within(y_kernel, y_plain, TOL_UNET):
        raise AssertionError(f"[{name}] full-width UNet kernels vs plain: {err}")
    if against_unfused and not within(y_kernel, y_f32, TOL_UNET):
        raise AssertionError(f"[{name}] full-width UNet kernels vs unfused: {err}")
    return err


def dtype_name(dtype):
    import torch

    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def describe(sig):
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig
    extras = [n for n, on in (("tb", tb), ("res", res), ("stats_in", sin),
                              ("stats_in2", sin2), ("stats", emit), ("proj", proj)) if on]
    src = f"{c}+{c2}" if c2 else f"{c}"
    return f"{dt} B={b} {h}x{w} {src}->{cout} {'+'.join(extras) or 'none'}"


def make_inputs(sig, device, seed):
    """Inputs of one launch signature. A bf16 signature gets every tensor in
    bf16, as the bf16 UNet hands them over (its weights, the noise Linear's
    time bias, the residual and the skip); the moments stay f32."""
    import torch

    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig
    ct = c + c2
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def moments(t):
        return torch.stack([t.sum(2), (t * t).sum(2)], 2)

    args = (randn(b, h, w, c), 1.0 + randn(ct, scale=0.1), randn(ct, scale=0.1),
            randn(3, 3, ct, cout, scale=(9 * ct) ** -0.5), randn(cout, scale=0.1))
    kw = {"emit_stats": emit, "num_groups": 32}
    if c2:
        kw["x2"] = randn(b, h, w, c2)
    if tb:
        kw["time_bias"] = randn(b, cout)
    if res:
        kw["residual"] = randn(b, h, w, cout)
    if sin:
        kw["stats_in"] = moments(args[0])
    if sin2:
        kw["stats_in2"] = moments(kw["x2"])
    if proj:
        kw["res_kernel"] = randn(1, 1, ct, cout, scale=ct ** -0.5)
        kw["res_bias"] = randn(cout, scale=0.1)
    if dt == "bf16":
        args = tuple(a.to(torch.bfloat16) for a in args)
        for name in ("x2", "time_bias", "residual", "res_kernel", "res_bias"):
            if name in kw:
                kw[name] = kw[name].to(torch.bfloat16)
        for name, src in (("stats_in", args[0]), ("stats_in2", kw.get("x2"))):
            if name in kw:
                kw[name] = moments(src.float())
    return args, kw


def pick_bound(nbytes, flops):
    """(bound_ms, bound_by) against the H100's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(sig):
    """Fused Block: each input read once, each output written once,
    activations in the signature's dtype (4 or 2 bytes), bf16 weights. An
    f32 input's conv is two bf16 products (its activation's hi and lo
    parts), the time of one at the TF32 rate."""
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig
    ct, pix = c + c2, b * h * w
    nbytes = (2 if dt == "bf16" else 4) * pix * (ct + cout * (1 + res + proj))
    nbytes += 2 * (9 + proj) * ct * cout + 4 * (b * h * 2 * (c * sin + c2 * sin2 + cout * emit))
    return pick_bound(nbytes, (2 if dt == "bf16" else 4) * pix * cout * ct * (9 + proj))


def bare_launch(fc, args, kw, packed):
    """A function that relaunches the fused kernel alone on the current
    stream, with the arguments the wrapper gave it for this call (its
    outputs are overwritten): the kernel's device time without the
    wrapper's host work and GroupNorm fold, which the wrapper's own time
    includes and which sets it at the small levels."""
    import torch

    real, rec = fc._entry, {}

    def recording_entry():
        fn = real()

        def call(*a):
            rec["fn"], rec["args"] = fn, a
            return fn(*a)
        return call

    fc._entry = recording_entry
    try:
        keep = fc.gn_swish_conv3x3(*args, packed=packed, **kw)
    finally:
        fc._entry = real
    fn, cargs = rec["fn"], rec["args"]

    def launch():
        rc = fn(*cargs[:-1], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused kernel launch failed: cudaError {rc}")
    launch.keep = (keep, args, kw, packed)  # the buffers the launch writes and reads
    return launch


def check_signature(sig, seed):
    """Fused kernel vs plain version on the card, and the five times."""
    import torch
    import torch.nn.functional as F

    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    args, kw = make_inputs(sig, "cuda", seed)
    res_k = kw.get("res_kernel")
    packed = fc.pack_conv3x3(args[3], res_k)
    got = fc.gn_swish_conv3x3(*args, packed=packed, **kw)
    want = fc.gn_swish_conv3x3_plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    names = ["out"] + (["stats"] if kw["emit_stats"] else []) + (["res"] if res_k is not None else [])
    errs = {}
    for name, g, p in zip(names, got, want):
        d = (g.float() - p.float()).abs()
        scale = p.float().abs().max().item()
        errs[name] = {"max_abs": d.max().item(), "max_rel": d.max().item() / max(scale, 1e-30)}
        if name == "stats":
            ok = errs[name]["max_rel"] <= TOL_STATS
        else:
            ok = bool((d <= TOL_OUT + TOL_OUT * p.float().abs()).all())
        if not ok:
            raise AssertionError(f"{describe(sig)}: kernel vs plain {name} {errs[name]}")
    del got, want

    ms = cuda_ms(lambda: fc.gn_swish_conv3x3(*args, packed=packed, **kw), reps=5)
    kernel_ms = graph_ms(bare_launch(fc, args, kw, packed))
    plain_ms = cuda_ms(lambda: fc.gn_swish_conv3x3_plain(*args, **kw), reps=2)
    # yardstick only: one cuDNN bf16 conv on the pre-activated input
    scale, shift = fc.gn_scale_shift(args[0], args[1], args[2], kw.get("x2"),
                                     kw.get("stats_in"), kw.get("stats_in2"), 32)
    x_all = args[0] if "x2" not in kw else torch.cat([args[0], kw["x2"]], -1)
    a = x_all.to(torch.bfloat16).float() * scale[:, None, None, :] + shift[:, None, None, :]
    a = (a * torch.sigmoid(a)).to(torch.bfloat16).permute(0, 3, 1, 2)
    w = args[3].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = cuda_ms(lambda: F.conv2d(a, w, padding=1), reps=5)
    del a, x_all, scale, shift
    b_ms, b_by = bound(sig)
    return {"signature": describe(sig), "level": f"{sig[0][1]}x{sig[0][2]}",
            "errors": errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "kernel_ms": kernel_ms, "bound_frac": b_ms / ms, "vs_library": ms / library_ms,
            "kernel_bound_frac": b_ms / kernel_ms}


def flash_kernel_ms(fn, reps=5):
    """Mean device milliseconds of one launch of the flash wrapper's bf16
    prepass (kernels named to_bf16*; 0 where there is none) and of its
    attention kernel (flash_*), from torch.profiler over `reps` calls,
    with the launches of each it saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {"to_bf16": [], "flash_": []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key, times in seen.items():
                if key in e.name:
                    times.append(e.time_range.elapsed_us() / 1e3)
    return {key: (sum(t) / len(t) if t else 0.0, len(t)) for key, t in seen.items()}


def check_flash(sig, seed):
    """Flash kernel vs plain version on the card, on strided q, k, v views
    of one qkv tensor (f32 or bf16) as the UNet makes them, and the four
    times, the prepass's share and the einsum route's time (attention.py's
    matmul path, in the same dtype). The library yardstick is one
    scaled_dot_product_attention on bf16 copies."""
    import torch
    import torch.nn.functional as F

    from hsi_dmgasr_tpu_torch.kernels import attention as attn
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa

    (b, s, h, d), dt = sig
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, h, 3 * d), generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.split(d, dim=-1)
    scale = 1.0 / math.sqrt(h * d)
    got = fa.flash_attention(q, k, v, scale)
    want = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    if got.dtype != dtype or want.dtype != dtype:
        raise AssertionError(f"flash {sig}: output dtypes {got.dtype}, {want.dtype}")
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = {"max_abs": diff.max().item(), "max_rel": diff.max().item() / want.abs().max().item()}
    if not bool((diff <= TOL_FLASH_ABS + TOL_FLASH_REL * want.abs()).all()):
        raise AssertionError(f"flash {sig}: kernel vs plain {err}")
    del got, want, diff

    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale), reps=5)
    split = flash_kernel_ms(lambda: fa.flash_attention(q, k, v, scale))
    (pre_ms, n_pre), (attn_ms, n_attn) = split["to_bf16"], split["flash_"]
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale), reps=2)
    einsum_ms = cuda_ms(lambda: attn._einsum_attention(q, k, v, scale), reps=3)
    qb, kb, vb = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, scale=scale), reps=5)
    del qb, kb, vb
    flops = 4 * b * h * s * s * d
    b_ms, b_by = pick_bound(4 * qkv.element_size() * b * s * h * d, flops)
    return {"signature": f"{dt} B={b} S={s} H={h} D={d}", "errors": {"out": err}, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "prepass_ms": pre_ms, "prepass_share": pre_ms / ms, "attention_kernel_ms": attn_ms,
            "profiled_launches": {"prepass": n_pre, "attention": n_attn},
            "einsum_ms": einsum_ms, "tflops": flops / ms / 1e9}


def check_dot(case, dt, seed):
    """Blocked dot vs its plain version on the card at one probe case
    (int8 bit for bit), a 3-link chain captured in a CUDA graph vs the
    same links run eagerly (bit for bit), the four times per dot, and the
    kernel's share of its bound, TOP/s and ratio to the library call. The
    library yardstick is torch._int_mm (int8) or torch.mm with an f32
    output (bf16). graph_ms replays 20 calls on the same operands, which
    then sit in the L2: the HBM byte bound is a yardstick there, not a
    ceiling."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.tools import microbench_int8 as mb

    name, m, k, n, bm, bn = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dt == "int8":
        x, w = mb.rand_int8(gen, (m, k)), mb.rand_int8(gen, (k, n))
    else:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    wp = bd.pack_dot_weight(w)
    got = bd.blocked_dot(x, wp, bm, bn)
    want = bd.blocked_dot_plain(x, w)
    torch.cuda.synchronize()
    diff = (got.double() - want.double()).abs()
    err = {"max_abs": diff.max().item(),
           "max_rel": diff.max().item() / want.double().abs().max().item()}
    if dt == "int8":
        ok = torch.equal(got, want)
    else:
        ok = bool((diff <= TOL_DOT_ABS + TOL_DOT_REL * want.double().abs()).all())
    if not ok:
        raise AssertionError(f"blocked dot {name} {dt}: kernel vs plain {err}")
    del got, want, diff

    dot = mb.kernel_dot(w, bm, bn)
    eager = mb.run_chain(dot, x, 3)
    mb.warm_up(dot, x)
    graph, _, out = mb.capture_chain(dot, x, 3)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise AssertionError(f"blocked dot {name} {dt}: captured 3-link chain != eager chain")
    del graph, out, eager

    ms = graph_ms(lambda: bd.blocked_dot(x, wp, bm, bn))
    plain_ms = graph_ms(lambda: bd.blocked_dot_plain(x, w))
    if dt == "int8":
        library_ms = graph_ms(lambda: torch._int_mm(x, w))
    else:
        library_ms = graph_ms(lambda: torch.mm(x, w, out_dtype=torch.float32))
    b_s, b_by = mb.dot_bound(m, k, n, dt)
    return {"signature": f"{name} {dt} {m}x{k}x{n}", "case": name, "dtype": dt,
            "errors": {"out": err}, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_s * 1e3, "bound_by": b_by, "bound_frac": b_s * 1e3 / ms,
            "tops": 2 * m * k * n / ms / 1e9, "vs_library": ms / library_ms}


# ------------------------------------------------------------- the slice


def build_pipeline(config):
    from hsi_dmgasr_tpu_torch.config import load
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    opt = load(os.path.join(ROOT, "configs", config))
    opt["model"]["unet"]["fuse"] = True
    return DMGASRPipeline(opt, None, GAE_CFG, seed=0)


def golden_check():
    """Unfused f32 UNet on the reference torch golden state_dict, on the
    card. Tolerance atol 1e-4, rtol 1e-3: the golden's 2e-5 CPU tolerance
    widened for cuDNN's f32 convolution algorithms (TF32 is off)."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict
    from hsi_dmgasr_tpu_torch.models.unet import UNet

    g = np.load(GOLDEN)
    sd = {k.split("::", 1)[1]: g[k] for k in g.files if k.startswith("sr3_sd::")}
    net = load_state_dict(UNet(in_channel=6, out_channel=3, inner_channel=16, norm_groups=8,
                               channel_mults=(1, 2), attn_res=(8,), res_blocks=1,
                               image_size=16), sd).cuda().eval()
    with torch.inference_mode():
        y = net(torch.tensor(np.moveaxis(g["sr3_x"], 1, -1), device="cuda"),
                torch.tensor(g["sr3_gamma"], device="cuda"))
    y = np.moveaxis(y.cpu().numpy(), -1, 1)
    err = float(np.abs(y - g["sr3_y"]).max())
    np.testing.assert_allclose(y, g["sr3_y"], atol=1e-4, rtol=1e-3)
    return err


def union_ms(spans):
    """Milliseconds covered by the union of (start, end) intervals in
    microseconds: the time the device ran anything, each moment once."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_cube(run_cube, stages):
    """One traced cube (``run_cube()``): device time by kernel name, the
    device's busy time (the union of its kernel, copy and memset intervals)
    and idle share; then the host-clock seconds of each stage, each a
    function of the previous stage's result that ends in a synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cube()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            spans.append((e.time_range.start, e.time_range.end))
    busy_ms = union_ms(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    seconds, state = {}, None
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = fn(state)
        torch.cuda.synchronize()
        seconds[name + "_s"] = time.perf_counter() - t0
    del state
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "stages": seconds,
            "kernels": [{"name": k[:120], "ms": ms, "calls": n} for k, (ms, n) in top]}


def run_path(name, config, expected, cube, profile):
    """Record, count, check and time one main path. Returns its report
    and the launch signatures it recorded."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    pipe = build_pipeline(config)
    fused_calls, flash_calls = {}, {}
    # the counted main-path run, which also records the launch signatures
    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with recording(fused_calls, flash_calls):
        out = pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
    recorded = {FUSED: sum(fused_calls.values()), FLASH: sum(flash_calls.values())}
    log(f"[{name}] recorded {len(fused_calls)} fused and {len(flash_calls)} flash launch "
        f"signatures, {recorded} calls per cube")
    if recorded != expected:
        raise AssertionError(f"[{name}] {recorded} kernel calls per cube, expected {expected}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{name}] main path: {launches} kernel launches, peak memory {peak_gib:.2f} GiB")
    if launches != expected or bd.LAUNCHES:
        raise AssertionError(f"[{name}] {launches}, {bd.LAUNCHES} blocked-dot launches in the "
                             f"main-path run, expected {expected} and none")
    check_cube(name, out, CUBE)
    del out
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(3 + r))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    report = {"config": config, "cube_seconds": statistics.median(times), "cube_times": times,
              "peak_memory_gib": peak_gib, "launches": launches}
    log(f"[{name}] cube seconds (median of 3): {report['cube_seconds']:.4f} {times}")

    # full-width UNet forward, kernels vs plain versions, on the module the
    # cubes sampled
    unet = pipe.ddpm.eval_unet
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        cond = pipe._fold(pipe.encode(cube))
        x = torch.cat([cond, torch.randn(cond.shape, generator=gen, device="cuda")], -1)
        t = torch.full((x.shape[0], 1), 0.5, device="cuda")
        unet_err = check_unet(name, unet, x, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unet(x, t)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    del x, cond
    log(f"[{name}] full-width UNet forward (B=9, 512^2): kernels vs plain {unet_err}, "
        f"forward {fwd_s:.4f} s")
    report.update(unet_forward_err=unet_err, unet_forward_s=fwd_s)

    if profile:
        gen = torch.Generator(device="cuda").manual_seed(9)
        b = cube.shape[0]
        report["profile"] = profile_cube(
            lambda: pipe.super_resolve(cube, generator=gen),
            (("encode", lambda _: pipe._fold(pipe.encode(cube))),
             ("chain", lambda z: pipe.ddpm.super_resolution(z, generator=gen)),
             ("decode", lambda z: pipe.decode(pipe._unfold(z, b)))))
        log_profile(name, report["profile"])
    del pipe
    torch.cuda.empty_cache()
    return report, fused_calls, flash_calls


def log_profile(name, prof):
    log(f"[{name}] profile: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}, "
        f"stages {prof['stages']}")
    for k in prof["kernels"][:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['calls']:<5} {k['name'][:90]}")


def check_cube(name, out, shape):
    import torch

    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{name}] cube {tuple(out.shape)} or non-finite values")
    lo, hi = out.min().item(), out.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"[{name}] cube outside [0, 1]: [{lo}, {hi}]")


def run_bench(profile):
    """The bf16 flagship path: the port's bench (hsi_dmgasr_tpu_torch/bench.py)
    built at its defaults. For each of its two rows, the t_start=4 cube and
    the full T=20 chain: the counts set to 0, one cube driven while its
    launch signatures are recorded, the exact counts read, the cube checked
    and the peak memory read. Then the bench's own timing and JSON line, and
    one full-width bf16 UNet forward with the kernels held against the same
    forward on their plain versions. Returns the two rows' reports (each
    with its launch signatures) and the bench's JSON object."""
    import torch

    from hsi_dmgasr_tpu_torch import bench
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    args = bench.parse_args([])
    model = bench.Bench(args, torch.device("cuda"))
    cube = bench.make_cube(args, model)
    reports = {}
    for name, t_start in ((BENCH, args.t_start), (BENCH_FULL, None)):
        expected = BENCH_PATHS[name]
        fused_calls, flash_calls = {}, {}
        fc.LAUNCHES = 0
        fa.LAUNCHES = 0
        bd.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with recording(fused_calls, flash_calls):
            out = model.super_resolve(cube, 2, t_start)
        torch.cuda.synchronize()
        launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[{name}] main path: {launches} kernel launches ({len(fused_calls)} fused "
            f"signatures), peak memory {peak_gib:.2f} GiB")
        recorded = {FUSED: sum(fused_calls.values()), FLASH: sum(flash_calls.values())}
        if launches != expected or recorded != expected or bd.LAUNCHES:
            raise AssertionError(f"[{name}] {launches} launches ({recorded} recorded), "
                                 f"{bd.LAUNCHES} blocked-dot launches, expected {expected}")
        check_cube(name, out, (args.batch, model.size, model.size, model.channels))
        del out
        reports[name] = ({"t_start": t_start, "peak_memory_gib": peak_gib,
                          "launches": launches}, fused_calls, flash_calls)

    # the GAE's overlap average on the card: index_add_ of bf16 adds with
    # atomics, rounding after each add in no fixed order, where the CPU's
    # sums in f32 and rounds once (and JAX's rounds after each add in index
    # order). Bands in three groups can differ: each sum is within one bf16
    # ulp of the exact sum, so two are at most two grid steps apart (2^-6
    # each below 4), over the count 3, plus the quotient's own rounding.
    gen = torch.Generator(device="cuda").manual_seed(5)
    dec = torch.rand((model.n_groups, model.size, model.size, model.gae.n_subs),
                     generator=gen, device="cuda").to(torch.bfloat16)
    got = model.gae._merge_groups(dec, 1, model.size, model.size).float().cpu()
    want = copy.deepcopy(model.gae).cpu()._merge_groups(dec.cpu(), 1, model.size, model.size)
    d = (got - want.float()).abs()
    merge = {"max_abs": d.max().item(), "share_differing": (d > 0).float().mean().item()}
    log(f"[{BENCH}] bf16 overlap average, card vs CPU: {merge}")
    if merge["max_abs"] > 2 * 2 ** -6 / 3 + 2 ** -8:
        raise AssertionError(f"[{BENCH}] bf16 overlap average, card vs CPU: {merge}")
    reports[BENCH][0]["overlap_average_vs_cpu"] = merge
    del dec, got, want, d

    result = bench.run(args, model)
    log(f"[{BENCH}] bench: {json.dumps(result)}")
    reports[BENCH][0]["cube_seconds"] = result["value"]
    reports[BENCH_FULL][0]["cube_seconds"] = result["full_chain"]["value"]
    reports[BENCH][0]["bench"] = result

    # full-width bf16 UNet forward, kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        z = model.gae.encode(cube.to(model.dtype))
        cond = z.reshape(-1, *z.shape[2:])
        noise = torch.randn(cond.shape, generator=gen, device="cuda").to(model.dtype)
        x = torch.cat([cond, noise], -1)
        t = torch.full((x.shape[0], 1), 0.5, device="cuda").to(model.dtype)
        y_kernel = model.unet(x, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.unet(x, t)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        with plain_kernels():
            y_plain = model.unet(x, t)
        if y_kernel.dtype != torch.bfloat16 or y_plain.dtype != torch.bfloat16:
            raise AssertionError(f"[{BENCH}] UNet output dtypes {y_kernel.dtype}, {y_plain.dtype}")
        y_kernel, y_plain = y_kernel.float(), y_plain.float()
        d = (y_kernel - y_plain).abs()
        unet_err = {"max_abs": d.max().item(), "max_rel": d.max().item() / y_plain.abs().max().item()}
        if not bool((d <= TOL_UNET + TOL_UNET * y_plain.abs()).all()):
            raise AssertionError(f"[{BENCH}] full-width bf16 UNet kernels vs plain: {unet_err}")
    del y_kernel, y_plain, d, x, cond, z, noise
    log(f"[{BENCH}] full-width bf16 UNet forward (B=9, 512^2): kernels vs plain {unet_err}, "
        f"forward {fwd_s:.4f} s")
    reports[BENCH][0].update(unet_forward_err=unet_err, unet_forward_s=fwd_s)

    if profile:
        gen = torch.Generator(device="cuda").manual_seed(9)
        b, ts = cube.shape[0], args.t_start

        def chain(cond):
            with torch.inference_mode():
                return model.diffusion.sample_loop(model._denoise, cond=cond, t_start=ts,
                                                   generator=gen)

        def encode(_):
            with torch.inference_mode():
                z = model.gae.encode(cube.to(model.dtype))
                return z.reshape(-1, *z.shape[2:])

        def decode(z):
            with torch.inference_mode():
                return model.gae.decode(z.reshape(b, -1, *z.shape[1:]).to(model.dtype))

        reports[BENCH][0]["profile"] = profile_cube(
            lambda: model.super_resolve(cube, 9, ts),
            (("encode", encode), ("chain", chain), ("decode", decode)))
        log_profile(BENCH, reports[BENCH][0]["profile"])
    del model
    torch.cuda.empty_cache()
    return reports


# ------------------------------------------------------------ training


def make_train_data(root):
    """The training paths' scenes, from a seed: TRAIN_SCENES .mat scenes
    (key 'block') of TRAIN_SCENE_HW^2 x 102 and 3 .npy val scenes of
    VAL_HW^2 x 102 (blocky low-rank fields with smooth spectra, plus
    noise). Returns their directories."""
    import numpy as np
    import scipy.io as sio

    rng = np.random.RandomState(0)
    c = GAE_CFG["n_colors"]

    def scene(hw):
        fields = rng.rand(hw // 16, hw // 16, 6).repeat(16, 0).repeat(16, 1)
        spectra = rng.rand(6, c)
        for _ in range(3):
            spectra = 0.5 * spectra + 0.25 * (np.roll(spectra, 1, 1) + np.roll(spectra, -1, 1))
        return (fields @ spectra + 0.05 * rng.rand(hw, hw, c)).astype(np.float32)

    dirs = {k: os.path.join(root, k) for k in ("mat", "npy")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(TRAIN_SCENES):
        sio.savemat(os.path.join(dirs["mat"], f"scene_{i}.mat"), {"block": scene(TRAIN_SCENE_HW)})
    for i in range(3):
        np.save(os.path.join(dirs["npy"], f"scene_{i}.npy"), scene(VAL_HW))
    return dirs


def train_config(root, dirs, gae_ckpt):
    """configs/pavia_x4_r3.json through the port's config.parse, with the
    cuts of this path: fused Blocks at validation, the scenes of
    make_train_data, the GAE that train_gae trained and saved, save and
    validation at the last step."""
    from hsi_dmgasr_tpu_torch import config

    opt = config.parse(os.path.join(ROOT, "configs", "pavia_x4_r3.json"), phase="train",
                       experiments_root=os.path.join(root, "exp"))
    opt["model"]["unet"]["fuse"] = True
    opt["datasets"]["train"]["dataroot"] = dirs["mat"]
    opt["datasets"]["val"]["dataroot"] = dirs["npy"]
    opt["gae"]["checkpoint"] = gae_ckpt
    for k in ("n_subs", "n_ovls", "n_colors", "n_feats"):
        opt["gae"][k] = GAE_CFG[k]
    for k in ("val_freq", "save_checkpoint_freq"):
        opt["train"][k] = TRAIN_STEPS
    opt["train"]["print_freq"] = 1
    return opt


def ema_leaves(model):
    """A few parameters across the depth: first conv, a 128^2 block, the
    mid attention's qkv, a norm scale, the last conv's bias."""
    names = [n for n, _ in model.unet.named_parameters()]
    picks = ("downs.0.weight", "downs.1.res_block.block1.block.3.weight",
             "mid.0.attn.qkv.weight", "ups.0.res_block.block2.block.0.weight",
             "final_conv.block.3.bias")
    missing = [n for n in picks if n not in names]
    if missing:
        raise AssertionError(f"[{TRAIN}] no parameters {missing}")
    return picks


def step_against_cpu(opt, state_dict):
    """One train step at batch 1 on a 64^2 latent pair (full width, dropout
    0, injected gamma and noise) on the card and on the CPU from the same
    weights: the loss and every gradient."""
    import torch

    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    opt = copy.deepcopy(opt)
    opt["model"]["unet"]["dropout"] = 0.0
    opt["path"]["resume_state"] = None
    gen = torch.Generator().manual_seed(6)
    batch = {k: torch.randn((1, 64, 64, 3), generator=gen) for k in ("HR", "SR")}
    gamma = torch.tensor([0.6])
    noise = torch.randn((1, 64, 64, 3), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        model = DDPMModel(opt, device=dev)
        model.unet.load_state_dict(state_dict)
        t0 = time.perf_counter()
        loss = model.compute_grads(batch, gamma=gamma, noise=noise)
        out[dev] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                  model.unet.named_parameters()})
        log(f"[{TRAIN}] one batch-1 64^2 step on {dev}: {time.perf_counter() - t0:.2f} s")
        del model
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out["cpu"], out["cuda"]
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    gerr = max((g_gpu[n] - g).abs().max().item() for n, g in g_cpu.items())
    res = {"loss_cpu": loss_cpu, "loss_card": loss_gpu,
           "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
           "grad_max_abs_err": gerr, "grad_max_abs": gmax}
    log(f"[{TRAIN}] card vs CPU step: {res}")
    if res["loss_rel_err"] > TOL_STEP_LOSS or gerr > TOL_STEP_GRAD * gmax:
        raise AssertionError(f"[{TRAIN}] card step vs CPU step: {res}")
    return res


def run_train(profile, dirs, gae_ckpt):
    """The training path: configs/pavia_x4_r3.json through the port's
    driver (``stage2_driver.train``) on the scenes ``dirs`` and the stage-1
    checkpoint directory ``gae_ckpt``, TRAIN_STEPS steps then one periodic
    save, one validation and one best save. Counts: 0 before the first
    step, read when the validation starts (the steps launch no kernel) and
    when it ends (TRAIN_VAL). Checks every step's loss is finite, the EMA
    after every step on a few leaves, the save -> fresh DDPMModel ->
    load_resume round trip bit for bit, every weight's _version moved by
    one more step (else the fused Block's packed weights go stale) and the
    fused EMA UNet then against its plain and unfused forwards (both within
    TOL_UNET), and one step on the card against the CPU's. Times every step
    (median after 2 warm-up steps) and reads the peak memory of the steps."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
    from hsi_dmgasr_tpu_torch.utils.roofline import device_f32_peak, unet_step_ops

    root = os.path.join(ROOT, "build", TRAIN)
    shutil.rmtree(root, ignore_errors=True)
    opt = train_config(root, dirs, gae_ckpt)
    log(f"[{TRAIN}] the GAE: {gae_ckpt}, trained by {TRAIN_GAE}")
    steps, ema_errs, val, fused_calls, flash_calls = [], [], {}, {}, {}
    real_step, real_apply = DMGASRPipeline.train_step_from_hr, DDPMModel.apply_gradients
    real_validate = drv.validate

    def timed_step(self, hr, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = real_step(self, hr, **kw)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t, "loss": float(loss),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        return loss

    def checked_apply(self):
        names = ema_leaves(self)
        params = dict(self.unet.named_parameters())
        ema = dict(self.ema.module.named_parameters())
        prev = {n: ema[n].detach().clone() for n in names}
        real_apply(self)
        worst = 0.0
        for n in names:
            want = prev[n] * self.ema.decay + params[n].detach() * (1.0 - self.ema.decay)
            worst = max(worst, ((ema[n] - want).abs().max() / want.abs().max()).item())
        ema_errs.append(worst)

    def counted_validate(*args, **kw):
        torch.cuda.synchronize()
        val["train_launches"] = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
        fc.LAUNCHES = fa.LAUNCHES = 0
        with recording(fused_calls, flash_calls):
            res = real_validate(*args, **kw)
        torch.cuda.synchronize()
        val["launches"] = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
        return res

    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(DMGASRPipeline, "train_step_from_hr", timed_step), \
            mock.patch.object(DDPMModel, "apply_gradients", checked_apply), \
            mock.patch.object(drv, "validate", counted_validate):
        pipe, results = drv.train(opt, seed=0, max_steps=TRAIN_STEPS)
    ddpm = pipe.ddpm
    losses = [st["loss"] for st in steps]
    log(f"[{TRAIN}] {len(steps)} steps, losses {losses}")
    if len(steps) != TRAIN_STEPS or ddpm.step != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{TRAIN}] {len(steps)} steps ({ddpm.step} updates), losses {losses}")
    if val.get("train_launches") != {FUSED: 0, FLASH: 0, DOT: 0}:
        raise AssertionError(f"[{TRAIN}] the train steps launched {val.get('train_launches')}, "
                             "expected no kernel")
    recorded = {FUSED: sum(fused_calls.values()), FLASH: sum(flash_calls.values())}
    log(f"[{TRAIN}] validation: {val['launches']} kernel launches ({len(fused_calls)} fused "
        f"signatures, {recorded} recorded), {results['ave_time']:.4f} s per cube "
        f"({results['n']} scenes x {results['n_chains']} chains), MPSNR "
        f"{results['indices']['MPSNR']:.3f}, MPSNR_cc {results['indices_cc']['MPSNR']:.3f}")
    if val["launches"] != TRAIN_VAL or recorded != TRAIN_VAL:
        raise AssertionError(f"[{TRAIN}] validation launched {val['launches']} ({recorded} "
                             f"recorded), expected {TRAIN_VAL}")
    if not all(math.isfinite(v) for v in (*results["indices"].values(),
                                          *results["indices_cc"].values())):
        raise AssertionError(f"[{TRAIN}] validation metrics {results}")
    if max(ema_errs) > TOL_EMA:
        raise AssertionError(f"[{TRAIN}] EMA vs its recomputation: {ema_errs}")
    log(f"[{TRAIN}] EMA vs 0.999 EMA_prev + 0.001 params on {len(ema_leaves(ddpm))} leaves, "
        f"worst per step: {max(ema_errs):.2e}")

    # timing: the steps after 2 warm-up steps
    step_s = statistics.median(st["s"] for st in steps[2:])
    peak_gib = max(st["peak_gib"] for st in steps)
    n_latents = opt["datasets"]["train"]["batch_size"] * GAE_CFG["G"]
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]  # the HR crop
    flops = 3 * sum(op.flops for op in unet_step_ops(n_latents, size))
    peak_tflops = device_f32_peak(torch.cuda.get_device_name(0))
    report = {"config": "pavia_x4_r3.json", "steps": TRAIN_STEPS, "step_seconds": step_s,
              "step_times": [st["s"] for st in steps], "losses": losses,
              "latents_per_second": n_latents / step_s, "peak_memory_gib": peak_gib,
              "step_tflop": flops / 1e12, "f32_peak_tflops": peak_tflops,
              "roofline_share_f32": flops / step_s / (peak_tflops * 1e12),
              "val_cube_seconds": results["ave_time"],
              "val_results": json.loads(json.dumps(results, default=float)),
              "ema_worst_rel_err": max(ema_errs), "launches": val["launches"]}
    log(f"[{TRAIN}] ms per train step (median of {len(steps) - 2} after 2 warm-up): "
        f"{step_s * 1e3:.2f} ({n_latents} latents of {size}^2 from "
        f"{opt['datasets']['train']['batch_size']} HR crops)")
    log(f"[{TRAIN}] latents per second {report['latents_per_second']:.2f}, peak memory "
        f"{peak_gib:.2f} GiB")
    log(f"[{TRAIN}] roofline share: 3 x {flops / 3e12:.3f} TFLOP forward over the step against "
        f"the f32 peak {peak_tflops} TFLOP/s: {report['roofline_share_f32']:.4f}")
    log(f"[{TRAIN}] seconds per validation cube ({VAL_HW}^2 x 102): {results['ave_time']:.4f}")

    # save -> fresh DDPMModel -> load_resume, bit for bit
    ckpt = os.path.join(opt["path"]["checkpoint"], f"I{TRAIN_STEPS}_E1")
    opt_back = copy.deepcopy(opt)
    opt_back["path"]["resume_state"] = ckpt
    back = DDPMModel(opt_back, seed=1)
    same = ((back.begin_step, back.begin_epoch, back.step) == (TRAIN_STEPS, 1, TRAIN_STEPS)
            and all(torch.equal(back.unet.state_dict()[k], v)
                    for k, v in ddpm.unet.state_dict().items())
            and all(torch.equal(back.ema.state_dict()[k], v)
                    for k, v in ddpm.ema.state_dict().items())
            and back.scheduler.state_dict() == ddpm.scheduler.state_dict())
    sa, sb = ddpm.optimizer.state_dict(), back.optimizer.state_dict()
    same = same and sa["param_groups"] == sb["param_groups"] and all(
        sb["state"][i][k].device == v.device and torch.equal(sb["state"][i][k], v)
        for i, st in sa["state"].items() for k, v in st.items())
    if not same:
        raise AssertionError(f"[{TRAIN}] {ckpt} did not load back bit for bit")
    log(f"[{TRAIN}] save -> load_resume: params, Adam, schedule and EMA equal bit for bit, "
        f"begin_step {back.begin_step}, begin_epoch {back.begin_epoch}")
    del back, sa, sb

    # one more step after the validation packed the EMA weights: Adam and
    # the EMA update every weight in place, so each weight's _version (a
    # part of the fused Block's pack key) must move, or the next fused
    # forward would run on stale packed weights; then the fused EMA UNet
    # against its plain-kernel and unfused forwards
    unet = ddpm.eval_unet
    if unet is not ddpm.ema.module:
        raise AssertionError(f"[{TRAIN}] eval does not sample the EMA weights")
    weights = list(ddpm.unet.parameters()) + list(unet.parameters())
    versions = [w._version for w in weights]
    gen = torch.Generator(device="cuda").manual_seed(7)
    hr = torch.rand((4, size, size, GAE_CFG["n_colors"]), generator=gen, device="cuda")
    pipe.train_step_from_hr(hr, scale=opt["scale"])
    stale = sum(w._version == v for w, v in zip(weights, versions))
    if stale:
        raise AssertionError(f"[{TRAIN}] {stale} of {len(weights)} weights kept their _version "
                             "through a step: packed weights would go stale")
    with torch.inference_mode():
        x = torch.randn((GAE_CFG["G"], VAL_HW, VAL_HW, 6), generator=gen, device="cuda")
        t = torch.full((x.shape[0], 1), 0.5, device="cuda")
        ema_fwd = check_unet(TRAIN, unet, x, t, against_unfused=True)
    log(f"[{TRAIN}] after one more step every weight's _version moved ({len(weights)} live and "
        f"EMA); the fused EMA UNet (B=9, {VAL_HW}^2) vs plain: {ema_fwd}")
    report["ema_fused_vs_plain"] = ema_fwd
    del x

    report["card_vs_cpu_step"] = step_against_cpu(opt, ddpm.unet.state_dict())

    if profile:
        batch = opt["datasets"]["train"]["batch_size"]
        hr = torch.rand((batch, size, size, GAE_CFG["n_colors"]), generator=gen, device="cuda")
        degrade = pipe._degrade_fn((size, size), opt["scale"])

        def encode(sr):
            with torch.no_grad():
                return {"HR": pipe._fold(pipe._encode(hr)), "SR": pipe._fold(pipe._encode(sr))}

        report["profile"] = profile_cube(
            lambda: pipe.train_step_from_hr(hr, scale=opt["scale"]),
            (("degrade", lambda _: degrade(hr)), ("encode", encode),
             ("unet_fwd_bwd", lambda z: ddpm.compute_grads(z)),
             ("adam_ema", lambda _: ddpm.apply_gradients())))
        log_profile(TRAIN, report["profile"])
    del pipe, ddpm, unet
    torch.cuda.empty_cache()
    return report, fused_calls, flash_calls


def gae_step_against_cpu(state_dict, crop, vgg=None, bands=None):
    """One stage-1 step at batch 1 on the card and on the CPU from the same
    weights and the same crop: the loss within TOL_STEP_LOSS and each
    gradient leaf within TOL_STEP_GRAD of that leaf's largest |g|. HLoss
    alone is held in f32, the trainer's dtype. With the perceptual term on
    ``vgg`` (its ``bands`` given) the same check is made with the GAE, the
    VGG19 and the crop widened to f64 on both sides: that gradient flows
    back through 16 ReLU convs and 5 max-pools whose masks and choices f32
    rounding flips, so the CPU's own f32 step already lies 1.1e-3 to
    3.0e-3 of a leaf's largest |g| from itself in f64, past the bound. The
    f32 steps are run too, and their distance from each other and from
    the CPU's f64 step is reported beside the check."""
    import torch

    from hsi_dmgasr_tpu_torch.train.stage1_gae import GAETrainer, make_vgg_perceptual_fn

    kw = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
    dtypes = (torch.float32,) if vgg is None else (torch.float32, torch.float64)
    out = {}
    for dt in dtypes:
        for dev in ("cpu", "cuda"):
            pfn = None if vgg is None else make_vgg_perceptual_fn(copy.deepcopy(vgg).to(dev, dt))
            tr = GAETrainer(**kw, state_dict=state_dict, perceptual_fn=pfn,
                            perceptual_weight=TRAIN_GAE_P_WEIGHT, device=dev)
            if dt == torch.float64:  # the trainer's cast to f32, widened to f64
                tr.gae.double()
                tr._to_f32 = lambda x, d=dev: torch.as_tensor(x, device=d).double()
            t0 = time.perf_counter()
            loss = tr.compute_grads(crop[None], bands=bands).item()
            out[dev, dt] = (loss, {n: p.grad.detach().double().cpu()
                                   for n, p in tr.gae.named_parameters()})
            log(f"[{TRAIN_GAE}] one batch-1 {crop.shape[0]}^2 step on {dev} in {str(dt)[6:]}"
                f"{'' if vgg is None else ' with the perceptual term'}: "
                f"{time.perf_counter() - t0:.2f} s")
            del tr, pfn

    def worst_leaf(a, b):
        return max(((a[n] - g).abs().max() / g.abs().max()).item() for n, g in b.items())

    def compare(dt):
        (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out["cpu", dt], out["cuda", dt]
        return {"loss_cpu": loss_cpu, "loss_card": loss_gpu,
                "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                "grad_max_abs_err": max((g_gpu[n] - g).abs().max().item()
                                        for n, g in g_cpu.items()),
                "grad_max_abs": max(g.abs().max().item() for g in g_cpu.values()),
                "grad_worst_leaf_rel_err": worst_leaf(g_gpu, g_cpu), "leaves": len(g_cpu)}

    res = {"dtype": str(dtypes[-1])[6:], **compare(dtypes[-1])}
    if vgg is not None:
        g_ref = out["cpu", torch.float64][1]
        res["f32"] = {**compare(torch.float32),
                      "cpu_vs_cpu_f64_worst_leaf_rel_err": worst_leaf(
                          out["cpu", torch.float32][1], g_ref),
                      "card_vs_cpu_f64_worst_leaf_rel_err": worst_leaf(
                          out["cuda", torch.float32][1], g_ref)}
    if res["loss_rel_err"] > TOL_STEP_LOSS or res["grad_worst_leaf_rel_err"] > TOL_STEP_GRAD:
        raise AssertionError(f"[{TRAIN_GAE}] card step vs CPU step: {res}")
    return res


def run_train_gae(profile, dirs):
    """Stage-1 GAE training as a user runs it: ``cli.ae.main`` on the scenes
    ``dirs`` at the Pavia GAE's width (the CLI's defaults: n_subs 16,
    n_ovls 4, n_colors 102, n_feats 64, scale 4, batch 8), device-resident,
    TRAIN_GAE_STEPS steps ending on a save; then ``cli.gae_test.main`` on
    the saved directory over the 3 val scenes at 128^2. Counts: 0 before
    the CLI, none after (the path runs no kernel of the port). Checks every
    step's loss is finite, the checkpoint back into a fresh GAE bit for
    bit, one batch-1 step on the card against the CPU's with HLoss (f32)
    and with the perceptual term (f64; a seeded torchvision-layout VGG19),
    and every
    cube's gae_test metrics finite. Times every step (median after 2
    warm-up steps), a perceptual step, and gae_test per cube. Returns the
    report and the checkpoint directory."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.cli import ae, gae_test
    from hsi_dmgasr_tpu_torch.data.device_cache import DeviceSceneCache
    from hsi_dmgasr_tpu_torch.data.hs_datasets import HSTrainingData
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.models.gae import GAE
    from hsi_dmgasr_tpu_torch.models.networks import init_weights
    from hsi_dmgasr_tpu_torch.models.vgg import VGG19
    from hsi_dmgasr_tpu_torch.train.stage1_gae import GAETrainer, make_vgg_perceptual_fn
    from hsi_dmgasr_tpu_torch.utils.roofline import device_f32_peak, gae_forward_ops

    root = os.path.join(ROOT, "build", TRAIN_GAE)
    shutil.rmtree(root, ignore_errors=True)
    out = os.path.join(root, "gae")
    kw = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
    size = 32 * 4  # the CLI's crop: 32 * scale
    steps = []
    real_step = GAETrainer.train_step

    def timed_step(self, hr, **step_kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = real_step(self, hr, **step_kw)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t, "loss": float(loss),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        return loss

    argv = ["--data", dirs["mat"], "--datatype", "hsi_mat", "--device_resident",
            "--n_subs", str(kw["n_subs"]), "--n_ovls", str(kw["n_ovls"]),
            "--n_colors", str(kw["n_colors"]), "--n_feats", str(kw["n_feats"]), "--scale", "4",
            "--batch_size", str(TRAIN_GAE_BATCH), "--epochs", str(TRAIN_GAE_EPOCHS),
            "--max_steps", str(TRAIN_GAE_STEPS), "--out", out]
    log(f"[{TRAIN_GAE}] python -m hsi_dmgasr_tpu_torch.cli.ae {' '.join(argv)}")
    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(GAETrainer, "train_step", timed_step):
        trainer = ae.main(argv)
    torch.cuda.synchronize()
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
    losses = [st["loss"] for st in steps]
    log(f"[{TRAIN_GAE}] {len(steps)} steps, losses {losses}, kernel launches {launches}")
    if len(steps) != TRAIN_GAE_STEPS or trainer.step != TRAIN_GAE_STEPS \
            or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{TRAIN_GAE}] {len(steps)} steps ({trainer.step} updates), "
                             f"losses {losses}")
    if launches != {FUSED: 0, FLASH: 0, DOT: 0}:
        raise AssertionError(f"[{TRAIN_GAE}] launched {launches}, expected no kernel")

    step_s = statistics.median(st["s"] for st in steps[2:])
    peak_gib = max(st["peak_gib"] for st in steps)
    flops = 3 * sum(op.flops for op in gae_forward_ops(TRAIN_GAE_BATCH, size, **kw))
    peak_tflops = device_f32_peak(torch.cuda.get_device_name(0))
    report = {"cli": "cli.ae " + " ".join(argv[2:]), "steps": TRAIN_GAE_STEPS,
              "step_seconds": step_s, "step_times": [st["s"] for st in steps],
              "losses": losses, "crops_per_second": TRAIN_GAE_BATCH / step_s,
              "peak_memory_gib": peak_gib, "step_tflop": flops / 1e12,
              "f32_peak_tflops": peak_tflops,
              "f32_bound_ms": flops / (peak_tflops * 1e12) * 1e3,
              "roofline_share_f32": flops / step_s / (peak_tflops * 1e12), "launches": launches}
    log(f"[{TRAIN_GAE}] ms per train step (median of {len(steps) - 2} after 2 warm-up): "
        f"{step_s * 1e3:.2f} ({TRAIN_GAE_BATCH} HR crops of {size}^2 x {kw['n_colors']}, "
        f"{TRAIN_GAE_BATCH * GAE_CFG['G']} group images)")
    log(f"[{TRAIN_GAE}] crops per second {report['crops_per_second']:.2f}, peak memory "
        f"{peak_gib:.2f} GiB")
    log(f"[{TRAIN_GAE}] roofline share: 3 x {flops / 3e12:.3f} TFLOP forward over the step "
        f"against the f32 peak {peak_tflops} TFLOP/s ({report['f32_bound_ms']:.1f} ms): "
        f"{report['roofline_share_f32']:.4f}")

    # the checkpoint the CLI saved -> a fresh GAE, bit for bit
    sd, cfg = GAETrainer.load_gae_variables(out)
    fresh = GAE(**{k: cfg[k] for k in kw})
    fresh.load_state_dict(sd)
    live = trainer.gae.state_dict()
    if cfg != GAE_CFG or fresh.state_dict().keys() != live.keys() or not all(
            torch.equal(fresh.state_dict()[k], v.cpu()) for k, v in live.items()):
        raise AssertionError(f"[{TRAIN_GAE}] {out} did not load back bit for bit ({cfg})")
    log(f"[{TRAIN_GAE}] save -> load_gae_variables -> a fresh GAE: {len(live)} tensors equal "
        f"bit for bit, config {cfg}")
    del fresh, live

    # one batch-1 step on the card against the CPU's, on an f16-rounded crop
    ds = HSTrainingData(dirs["mat"], n_scale=4, augment=True, hr_only=True,
                        rng=np.random.RandomState(0))
    crop = torch.from_numpy(ds[3]["HR"].astype(np.float16))
    report["card_vs_cpu_step"] = gae_step_against_cpu(sd, crop)
    log(f"[{TRAIN_GAE}] card vs CPU step, HLoss: {report['card_vs_cpu_step']}")
    vgg = init_weights(VGG19(), torch.Generator().manual_seed(0), init_type="kaiming")
    report["card_vs_cpu_perceptual_step"] = gae_step_against_cpu(sd, crop, vgg,
                                                                 TRAIN_GAE_BANDS)
    log(f"[{TRAIN_GAE}] card vs CPU step, HLoss + {TRAIN_GAE_P_WEIGHT} x the perceptual term "
        f"(VGG19 with seeded He-normal weights, not pretrained; bands {TRAIN_GAE_BANDS}): "
        f"{report['card_vs_cpu_perceptual_step']}")

    # a perceptual step at the path's batch: HLoss + 1e-3 x the VGG19 term
    cache = DeviceSceneCache.from_dataset(ds, gt_size=size, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    hr = cache.sample(gen, TRAIN_GAE_BATCH)
    ptr = GAETrainer(**kw, state_dict=sd, device="cuda",
                     perceptual_fn=make_vgg_perceptual_fn(vgg.cuda()))
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ptr.train_step(hr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    report["perceptual_step_seconds"] = statistics.median(times[2:])
    log(f"[{TRAIN_GAE}] ms per step with the perceptual term (median of 3 after 2 warm-up, "
        f"seeded VGG19): {report['perceptual_step_seconds'] * 1e3:.2f}")
    del ptr, vgg, cache

    # gae_test on the saved directory: every cube's metrics finite
    cubes = []
    real_qa = gae_test.quality_assessment

    def recorded_qa(*a, **k):
        cubes.append(real_qa(*a, **k))
        return cubes[-1]

    t0 = time.perf_counter()
    with mock.patch.object(gae_test, "quality_assessment", recorded_qa):
        avg = gae_test.main(["--ckpt", out, "--data", dirs["npy"], "--gt_size", str(VAL_HW),
                             "--scale", "4"])
    secs = (time.perf_counter() - t0) / max(len(cubes), 1)
    if len(cubes) != 3 or not all(math.isfinite(v) for qa in cubes for v in qa.values()):
        raise AssertionError(f"[{TRAIN_GAE}] gae_test metrics {cubes}")
    report["gae_test"] = json.loads(json.dumps(
        {"cube_seconds": secs, "averaged": avg, "cubes": cubes}, default=float))
    log(f"[{TRAIN_GAE}] gae_test: {len(cubes)} cubes of {VAL_HW}^2 x {kw['n_colors']}, "
        f"{secs:.3f} s a cube, averaged {avg}")

    if profile:
        hr = torch.rand((TRAIN_GAE_BATCH, size, size, kw["n_colors"]),
                        generator=torch.Generator(device="cuda").manual_seed(12), device="cuda")

        def forward_loss(_):
            trainer.optimizer.zero_grad(set_to_none=True)
            return trainer.loss(hr)

        report["profile"] = profile_cube(
            lambda: trainer.train_step(hr),
            (("forward_loss", forward_loss), ("backward", lambda loss: loss.backward()),
             ("adam", lambda _: trainer.apply_gradients())))
        log_profile(TRAIN_GAE, report["profile"])
    del trainer
    torch.cuda.empty_cache()
    return report, out


def run_probe():
    """The int8 probe's main path: the launch counts set to 0, the probe
    run once, the exact counts read. Each case and dtype makes one eager
    warm-up link and captures CHAIN links, which the Python counts see;
    the card runs the warm-up link and the captured links once per input.
    Both paths' int8 chains sum exactly, so their last links' sums must
    agree exactly after CHAIN links."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.tools import microbench_int8 as mb

    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = mb.probe(torch.device("cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counted = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
    expected = {FUSED: 0, FLASH: 0, DOT: len(mb.CASES) * len(mb.DTYPES) * (1 + mb.CHAIN)}
    if counted != expected:
        raise AssertionError(f"[{PROBE}] {counted} counted launches, expected {expected}")
    per_chain = 1 + mb.N_X * mb.CHAIN
    for r in rows:
        if r["launches"] != (per_chain if r["path"] == "cuda" else 0):
            raise AssertionError(f"[{PROBE}] {r['case']} {r['path']} {r['dtype']}: "
                                 f"{r['launches']} blocked-dot launches, expected {per_chain}")
        log(f"[{PROBE}] {r['case']:<20} {r['path']:<7} {r['dtype']:<4} us/dot "
            f"{r['us_per_dot']:8.3f} bound {r['bound_us']:.3f} TOP/s {r['achieved_TOPs']:7.2f} "
            f"launches {r['launches']} sum {r['checksum']}")
    for name, *_ in mb.CASES:
        sums = {r["path"]: r["checksum"] for r in rows if r["case"] == name and r["dtype"] == "int8"}
        if sums["cuda"] != sums["library"]:
            raise AssertionError(f"[{PROBE}] {name} int8: kernel chain sum {sums['cuda']} != "
                                 f"library chain sum {sums['library']}")
    launches = {FUSED: 0, FLASH: 0, DOT: sum(r["launches"] for r in rows)}
    log(f"[{PROBE}] main path: {launches} kernel launches ({counted} counted in Python: "
        f"warm-up and captured links), {secs:.1f} s")
    return {"chain": mb.CHAIN, "seconds": secs, "launches": launches,
            "counted_in_python": counted, "rows": rows}


def kernel_entry(name, source, replaces, rows, launches):
    """The kernels-line entry: times summed over the counted main-path
    runs (launches of each signature x time per launch), per path too.
    ``launches`` maps each path that runs the kernel to its count."""
    paths = {}
    for path in launches:
        n = {k: sum(r["counts"][path] * r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        paths[path] = dict(launches=launches[path], **n)
    total = {k: sum(p[k] for p in paths.values())
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by_bytes = sum(r["bound_ms"] * sum(r["counts"].values())
                   for r in rows if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()),
            "max_abs_err": max(r["errors"]["out"]["max_abs"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
            "library_ms": total["library_ms"], "paths": paths}


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one cube per path and break its time down")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.kernels import build
    from hsi_dmgasr_tpu_torch.tools import microbench_int8 as mb

    t_script = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    use_f32_policy()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s for {sorted(libs)}")
    for name, (secs, out) in build.BUILD_LOG.items():
        log(f"nvcc {name}: {secs:.1f} s")
        log("\n".join(line for line in out.splitlines() if "registers" in line or "spill" in line))

    # ---- 3. the main paths
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    report["paths"] = {}
    runs = {path: run_path(path, config, expected, cube, args.profile)
            for path, (config, expected) in PATHS.items()}
    del cube
    torch.cuda.empty_cache()
    runs.update(run_bench(args.profile))
    dirs = make_train_data(os.path.join(ROOT, "build", "scenes"))
    report["paths"][TRAIN_GAE], gae_ckpt = run_train_gae(args.profile, dirs)
    runs[TRAIN] = run_train(args.profile, dirs, gae_ckpt)
    fused_sigs, flash_sigs = {}, {}
    for path, (path_report, fused_calls, flash_calls) in runs.items():
        report["paths"][path] = path_report
        for sigs, calls in ((fused_sigs, fused_calls), (flash_sigs, flash_calls)):
            for sig, n in calls.items():
                sigs.setdefault(sig, dict.fromkeys(UNET_PATHS, 0))[path] = n
    report["paths"][PROBE] = probe = run_probe()

    # ---- 4. each kernel vs its plain version, and timings, per signature
    fused_rows = []
    for i, (sig, counts) in enumerate(sorted(fused_sigs.items(), key=lambda kv: -kv[0][0][1])):
        row = check_signature(sig, seed=100 + i)
        row["counts"] = counts
        fused_rows.append(row)
        e = row["errors"]
        log(f"{row['signature']:<48} {counts} " + " ".join(
            f"{k} abs {v['max_abs']:.2e} rel {v['max_rel']:.2e}" for k, v in e.items())
            + f" | ms {row['ms']:.3f} kernel alone {row['kernel_ms']:.3f} plain "
            f"{row['plain_ms']:.3f} cudnn {row['library_ms']:.3f} bound {row['bound_ms']:.3f} "
            f"({row['bound_by']}) of bound {row['bound_frac']:.3f} (kernel alone "
            f"{row['kernel_bound_frac']:.3f}) x cudnn {row['vs_library']:.2f}")
        torch.cuda.empty_cache()
    flash_rows = []
    extra = [((shape, dt), dict.fromkeys(UNET_PATHS, 0)) for dt in ("f32", "bf16")
             for shape in FLASH_EXTRA + tuple(shape for shape, _ in flash_sigs)]
    extra = [e for e in extra if e[0] not in flash_sigs]
    for i, (sig, counts) in enumerate(list(flash_sigs.items()) + extra):
        row = check_flash(sig, seed=200 + i)
        row["counts"] = counts
        flash_rows.append(row)
        err = row["errors"]["out"]
        log(f"flash {row['signature']:<30} {counts} abs {err['max_abs']:.2e} rel "
            f"{err['max_rel']:.2e} | ms {row['ms']:.3f} ({row['tflops']:.1f} TFLOP/s; prepass "
            f"{row['prepass_ms']:.3f} ms, {row['prepass_share']:.3f} of it; attention kernel "
            f"{row['attention_kernel_ms']:.3f}; profiled {row['profiled_launches']}) plain "
            f"{row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
            f"einsum {row['einsum_ms']:.3f} bound {row['bound_ms']:.3f} ({row['bound_by']})")
        torch.cuda.empty_cache()
    dot_rows = []
    for i, (case, dt) in enumerate((c, dt) for c in mb.CASES for dt in ("int8", "bf16")):
        row = check_dot(case, dt, seed=300 + i)
        chains = {r["path"]: r for r in probe["rows"] if r["case"] == case[0] and r["dtype"] == dt}
        row["counts"] = {PROBE: chains["cuda"]["launches"]}
        row["chain_us_per_dot"] = {p: r["us_per_dot"] for p, r in chains.items()}
        dot_rows.append(row)
        err = row["errors"]["out"]
        log(f"dot {row['signature']:<40} abs {err['max_abs']:.2e} rel {err['max_rel']:.2e} | us "
            f"{row['ms'] * 1e3:.3f} plain {row['plain_ms'] * 1e3:.3f} library "
            f"{row['library_ms'] * 1e3:.3f} bound {row['bound_ms'] * 1e3:.3f} ({row['bound_by']}) "
            f"of bound {row['bound_frac']:.3f} TOP/s {row['tops']:.1f} x library "
            f"{row['vs_library']:.2f} | chain us/dot {row['chain_us_per_dot']}")
    report["fused_signatures"], report["flash_signatures"] = fused_rows, flash_rows
    report["dot_signatures"] = dot_rows
    for path in UNET_PATHS:
        levels = {}
        for r in fused_rows:
            n = r["counts"][path]
            if not n:
                continue
            lv = levels.setdefault(r["level"], dict.fromkeys(
                ("launches", "ms", "kernel_ms", "bound_ms", "plain_ms", "library_ms"), 0))
            lv["launches"] += n
            for key in ("ms", "kernel_ms", "bound_ms", "plain_ms", "library_ms"):
                lv[key] += r[key] * n
        report["paths"][path]["fused_levels"] = levels
        for name, lv in levels.items():
            lv["bound_frac"] = lv["bound_ms"] / lv["ms"]
            lv["vs_library"] = lv["ms"] / lv["library_ms"]
            log(f"[{path}] fused per counted run at {name}: {lv['launches']} launches, kernel "
                f"{lv['ms']:.3f} ms (alone {lv['kernel_ms']:.3f}), bound {lv['bound_ms']:.3f}, "
                f"plain {lv['plain_ms']:.3f}, cudnn {lv['library_ms']:.3f}, of bound "
                f"{lv['bound_frac']:.3f}, x cudnn {lv['vs_library']:.2f}")

    # ---- 5. golden
    report["golden_max_abs"] = golden_check()
    log(f"golden sr3 UNet on the card: max abs err {report['golden_max_abs']:.2e}")

    # ---- 6. results
    def launches(kernel):
        return {p: report["paths"][p]["launches"][kernel] for p in UNET_PATHS}

    entries = [
        kernel_entry(FUSED, "hsi_dmgasr_tpu_torch/csrc/fused_conv.cu",
                     "hsi_dmgasr_tpu/kernels/fused_conv.py:824", fused_rows, launches(FUSED)),
        kernel_entry(FLASH, "hsi_dmgasr_tpu_torch/csrc/flash_attention.cu",
                     "hsi_dmgasr_tpu/kernels/flash_attention.py:119", flash_rows,
                     launches(FLASH)),
        kernel_entry(DOT, "hsi_dmgasr_tpu_torch/csrc/blocked_dot.cu",
                     "tools/microbench_int8.py:88", dot_rows,
                     {PROBE: probe["launches"][DOT]}),
    ]
    for e in entries:
        for path, p in e["paths"].items():
            log(f"[{path}] {e['name']} per counted run: {p['launches']} launches, kernel "
                f"{p['ms']:.3f} ms, bound {p['bound_ms']:.3f}, plain {p['plain_ms']:.3f}, "
                f"library {p['library_ms']:.3f}")
    report["kernels"] = entries
    if args.profile:
        with open(os.path.join(OUT_DIR, "chip_smoke_profile.json"), "w") as f:
            json.dump({p: report["paths"][p].pop("profile")
                       for p in (*PATHS, BENCH, TRAIN_GAE, TRAIN)}, f,
                      indent=1)
    report["script_s"] = time.perf_counter() - t_script
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log("kernel times are summed over the counted run of each path: launches of each "
        "signature x time per launch")
    log(f"script seconds: {report['script_s']:.1f}")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
