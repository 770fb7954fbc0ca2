#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of DMGASR on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports only torch and hsi_dmgasr_tpu_torch,
and fails (exit code != 0, no result line) without a GPU or outside a
checkout. It drives three main paths. Two are x4 DMGASR on a
512x512x102 Pavia-geometry cube at full width (UNet inner 64, mults
1,2,4,8,8, res_blocks 2, GroupNorm 32, cosine T=20; GAE n_subs 16,
n_ovls 4, n_feats 64, G=9; seeded random weights):

  * configs/pavia_x4_r3.json: image_size 128, the chain entered at
    t_start=4, latent affine; attention at 64^2 and 32^2 stays below the
    flash gate. 220 fused-Block launches per cube.
  * configs/pavia_x4.json: image_size 64, the full T=20 chain, no affine;
    attention at the 128^2 level (16384 tokens, D=256) goes to the flash
    kernel, 5 layers per UNet forward. 100 flash and 1100 fused-Block
    launches per cube.

The third is the int8 probe (hsi_dmgasr_tpu_torch.tools.microbench_int8):

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
 3. for each Pavia path: sets the launch counts to 0, drives it once
    while recording every launch signature of both kernels, checks the
    cube (shape, finite, in [0, 1]) and the exact launch counts, times it
    (median of 3) and reads the peak memory; holds one full-width UNet
    forward with the kernels against the same forward with their plain
    versions. Then the probe: counts to 0, the probe run once, the exact
    launch counts, and the int8 chains of the kernel and the library
    held equal bit for bit after 4000 links;
 4. for each recorded signature, on the card at that shape (B=9): kernel
    vs its plain PyTorch version (asserted within tolerance), the
    kernel's, the plain version's and one library call's times, and the
    bound; for the fused Block also its launch alone, replayed in a CUDA
    graph, and each signature's and level's share of its bound and ratio
    to cuDNN; the flash kernel also at D=128 and at D=512 (S >= 8192) and
    at pavia_x4_r3's 64^2 attention, each flash shape with the prepass's
    device time (torch.profiler) and the einsum route's time beside it; the
    blocked dot at each probe case and dtype, and a 3-link captured
    chain against the same chain run eagerly;
 5. the unfused UNet against the reference torch golden
    (tests/golden/unet_diffusion_golden.npz);
 6. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}.

Details go to chiprun_out/chip_smoke.json. ``--profile`` adds one traced
cube per path: device time by kernel name (torch.profiler), the device's
idle share and the seconds of each stage (GAE encode, reverse chain, GAE
decode), into chiprun_out/chip_smoke_profile.json.
"""

from __future__ import annotations

import json
import math
import os
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
# flash checks beside the path's own shape: D=128 (two heads) and D=512
# with a ragged S, both past the 8192-token gate, and pavia_x4_r3's 64^2
# attention (4096 tokens, D=512), which the gate keeps on the einsum path:
# its row times both routes, for the gate's crossover
FLASH_EXTRA = ((9, 16384, 2, 128), (4, 8200, 1, 512), (9, 4096, 1, 512))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# kernel vs plain version on the card: same bf16 operands, f32 sums in
# another order (and a rare one-ulp flip of a bf16 activation or p)
TOL_OUT = 1e-2      # atol = rtol on out and the res projection
TOL_STATS = 1e-3    # max |diff| / max |plain| on the per-row moments
# on the attention output, whose elements are weighted means of
# unit-variance values, typically 0.01-0.02 at these shapes
TOL_FLASH_ABS, TOL_FLASH_REL = 1e-3, 1e-2
TOL_UNET = 3e-2     # full UNet forward, the JAX package's fused-UNet tolerance
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
               bool(kw.get("emit_stats")), kw.get("res_kernel") is not None)
        fused_calls[sig] = fused_calls.get(sig, 0) + 1
        return real_fused(x, gn_scale, gn_bias, kernel, bias, **kw)

    def rec_flash(q, k, v, scale):
        sig = tuple(q.shape)
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


def describe(sig):
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj = sig
    extras = [n for n, on in (("tb", tb), ("res", res), ("stats_in", sin),
                              ("stats_in2", sin2), ("stats", emit), ("proj", proj)) if on]
    src = f"{c}+{c2}" if c2 else f"{c}"
    return f"B={b} {h}x{w} {src}->{cout} {'+'.join(extras) or 'none'}"


def make_inputs(sig, device, seed):
    import torch

    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj = sig
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
    return args, kw


def pick_bound(nbytes, flops):
    """(bound_ms, bound_by) against the H100's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(sig):
    """Fused Block: each input read once, each output written once, f32
    activations and bf16 weights."""
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj = sig
    ct, pix = c + c2, b * h * w
    nbytes = 4 * pix * (ct + cout * (1 + res + proj))
    nbytes += 2 * (9 + proj) * ct * cout + 4 * (b * h * 2 * (c * sin + c2 * sin2 + cout * emit))
    return pick_bound(nbytes, 2 * pix * cout * ct * (9 + proj))


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


def check_flash(shape, seed):
    """Flash kernel vs plain version on the card, on strided q, k, v views
    of one qkv tensor as the UNet makes them, and the four times, the
    prepass's share and the einsum route's time (attention.py's matmul
    path, f32). The library yardstick is one scaled_dot_product_attention
    on bf16 copies."""
    import torch
    import torch.nn.functional as F

    from hsi_dmgasr_tpu_torch.kernels import attention as attn
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa

    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = torch.randn((b, s, h, 3 * d), generator=gen, device="cuda").split(d, dim=-1)
    scale = 1.0 / math.sqrt(h * d)
    got = fa.flash_attention(q, k, v, scale)
    want = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = {"max_abs": diff.max().item(), "max_rel": diff.max().item() / want.abs().max().item()}
    if not bool((diff <= TOL_FLASH_ABS + TOL_FLASH_REL * want.abs()).all()):
        raise AssertionError(f"flash {shape}: kernel vs plain {err}")
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
    b_ms, b_by = pick_bound(4 * 4 * b * s * h * d, flops)
    return {"signature": f"B={b} S={s} H={h} D={d}", "errors": {"out": err}, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "prepass_ms": pre_ms, "prepass_share": pre_ms / ms, "attention_kernel_ms": attn_ms,
            "profiled_launches": {"prepass": n_pre, "attention": n_attn},
            "einsum_ms": einsum_ms, "tflops": flops / ms / 1e9}


def check_dot(case, dt, seed):
    """Blocked dot vs its plain version on the card at one probe case
    (int8 bit for bit), a 3-link chain captured in a CUDA graph vs the
    same links run eagerly (bit for bit), and the four times per dot. The
    library yardstick is torch._int_mm (int8) or torch.mm with an f32
    output (bf16)."""
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
            "bound_ms": b_s * 1e3, "bound_by": b_by}


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


def profile_cube(pipe, cube):
    """One traced cube: device time by kernel name, the device's busy time
    (the union of its kernel, copy and memset intervals) and idle share,
    and the host-clock seconds of each stage (each ends in a synchronize)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.super_resolve(cube, generator=gen)
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

    stages = {}
    b = cube.shape[0]
    for name, fn in (("encode", lambda: pipe._fold(pipe.encode(cube))),
                     ("chain", lambda: pipe.ddpm.super_resolution(stages["z"], generator=gen)),
                     ("decode", lambda: pipe.decode(pipe._unfold(stages["z"], b)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages["z"] = fn()
        torch.cuda.synchronize()
        stages[name + "_s"] = time.perf_counter() - t0
    del stages["z"]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "stages": stages,
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
    if tuple(out.shape) != CUBE or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{name}] cube {tuple(out.shape)} or non-finite values")
    lo, hi = out.min().item(), out.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"[{name}] cube outside [0, 1]: [{lo}, {hi}]")
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

    # full-width UNet forward, kernels vs plain versions
    unet = pipe.ddpm.unet
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        cond = pipe._fold(pipe.encode(cube))
        x = torch.cat([cond, torch.randn(cond.shape, generator=gen, device="cuda")], -1)
        t = torch.full((x.shape[0], 1), 0.5, device="cuda")
        y_kernel = unet(x, t)
        t0 = time.perf_counter()
        unet(x, t)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        with plain_kernels():
            y_plain = unet(x, t)
        d = (y_kernel - y_plain).abs()
        unet_err = {"max_abs": d.max().item(), "max_rel": d.max().item() / y_plain.abs().max().item()}
        if not bool((d <= TOL_UNET + TOL_UNET * y_plain.abs()).all()):
            raise AssertionError(f"[{name}] full-width UNet kernels vs plain: {unet_err}")
    del y_kernel, y_plain, d, x, cond
    log(f"[{name}] full-width UNet forward (B=9, 512^2): kernels vs plain {unet_err}, "
        f"forward {fwd_s:.4f} s")
    report.update(unet_forward_err=unet_err, unet_forward_s=fwd_s)

    if profile:
        prof = profile_cube(pipe, cube)
        report["profile"] = prof
        log(f"[{name}] profile: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}, "
            f"stages {prof['stages']}")
        for k in prof["kernels"][:12]:
            log(f"  {k['ms']:9.3f} ms  x{k['calls']:<5} {k['name'][:90]}")
    del pipe
    torch.cuda.empty_cache()
    return report, fused_calls, flash_calls


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
    from hsi_dmgasr_tpu_torch.kernels import build
    from hsi_dmgasr_tpu_torch.tools import microbench_int8 as mb

    t_script = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    fused_sigs, flash_sigs = {}, {}
    for path, (config, expected) in PATHS.items():
        report["paths"][path], fused_calls, flash_calls = run_path(
            path, config, expected, cube, args.profile)
        for sigs, calls in ((fused_sigs, fused_calls), (flash_sigs, flash_calls)):
            for sig, n in calls.items():
                sigs.setdefault(sig, dict.fromkeys(PATHS, 0))[path] = n
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
    extra = {shape: dict.fromkeys(PATHS, 0) for shape in FLASH_EXTRA}
    for i, (shape, counts) in enumerate(list(flash_sigs.items()) + list(extra.items())):
        row = check_flash(shape, seed=200 + i)
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
            f"| chain us/dot {row['chain_us_per_dot']}")
    report["fused_signatures"], report["flash_signatures"] = fused_rows, flash_rows
    report["dot_signatures"] = dot_rows
    for path in PATHS:
        levels = {}
        for r in fused_rows:
            lv = levels.setdefault(r["level"], dict.fromkeys(
                ("launches", "ms", "kernel_ms", "bound_ms", "plain_ms", "library_ms"), 0))
            n = r["counts"][path]
            lv["launches"] += n
            for key in ("ms", "kernel_ms", "bound_ms", "plain_ms", "library_ms"):
                lv[key] += r[key] * n
        report["paths"][path]["fused_levels"] = levels
        for name, lv in levels.items():
            lv["bound_frac"] = lv["bound_ms"] / lv["ms"]
            lv["vs_library"] = lv["ms"] / lv["library_ms"]
            log(f"[{path}] fused per cube at {name}: {lv['launches']} launches, kernel "
                f"{lv['ms']:.3f} ms (alone {lv['kernel_ms']:.3f}), bound {lv['bound_ms']:.3f}, "
                f"plain {lv['plain_ms']:.3f}, cudnn {lv['library_ms']:.3f}, of bound "
                f"{lv['bound_frac']:.3f}, x cudnn {lv['vs_library']:.2f}")

    # ---- 5. golden
    report["golden_max_abs"] = golden_check()
    log(f"golden sr3 UNet on the card: max abs err {report['golden_max_abs']:.2e}")

    # ---- 6. results
    def launches(kernel):
        return {p: report["paths"][p]["launches"][kernel] for p in PATHS}

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
            json.dump({p: report["paths"][p].pop("profile") for p in PATHS}, f, indent=1)
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
