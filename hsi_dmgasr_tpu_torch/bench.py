"""Flagship benchmark of the port: x4 DMGASR inference on one cube, on the card.

    python -m hsi_dmgasr_tpu_torch.bench [--small] [--cpu] [--dtype bf16|f32] ...

Port of the root ``bench.py`` (its ``build``, ``measure`` and ``main``):
the same model (GAE n_subs 16, n_ovls 4, n_feats 64 over a 512x512x102
cube; SR3 UNet inner 64, mults 1,2,4,8,8, res_blocks 2, GroupNorm 32,
attn_res [16], image_size = the cube's size; cosine T=20), seeded random
weights, the same casts (bf16 params, every activation that enters the
GAE or the UNet cast to the run's dtype, the chain state in f32), fused
Blocks only under bf16, and the same timing: the median of ``--repeats``
synchronised calls. It prints the same stderr info line and one stdout
JSON line:

  {"metric": "dmgasr_x4_512x512x102_cube_seconds", "value": <s>,
   "unit": "s", "t_start": 4, "full_chain": {"timesteps": 20, "value": <s>},
   "profile": {...}}

The headline row enters the chain at ``t_start=4`` (configs/pavia_x4_r3.json,
the production quality setting); ``full_chain`` times the full T-step
ancestral chain. ``profile`` (``--profile``, on by default, not with
``--cpu``) holds the GAE encode + decode time and the measured UNet step
against the analytic roofline of ``utils/roofline.py`` at the card's peaks.

Left out of the root bench, on purpose:
  * ``vs_baseline`` and ``BASELINE_SECONDS``: a 30 s budget set for a TPU
    v5e-8, which says nothing of this card;
  * ``--yield_tpu`` and the training-contention guard: they stop the JAX
    trainer's supervised child, and the trainer is not ported;
  * ``GAE_PRETRAINED``: the whole-module pickle loader of the JAX package
    (``io/convert_torch.py:load_torch_gae``) is not ported, so a
    ``GAE_PRETRAINED`` that names a file raises instead of the run
    quietly using seeded weights.

Without ``--cpu`` the run is on CUDA and raises if there is none.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .models.gae import GAE, group_indices
from .models.networks import diffusion_for_phase, init_weights
from .models.unet import UNet
from .utils.roofline import step_roofline


def geometry(small):
    """(size, channels, inner, mults, attn_res, n_subs, n_ovls, n_feats)."""
    if small:
        return 64, 31, 16, [1, 2], [16], 8, 2, 16
    return 512, 102, 64, [1, 2, 4, 8, 8], [16], 16, 4, 64


class Bench:
    """The root bench's ``build``: GAE and UNet in the run's dtype, seeded,
    on ``device``, and the VAL chain."""

    def __init__(self, args, device):
        size, channels, inner, mults, attn, n_sub, n_ovl, feats = geometry(args.small)
        ckpt = os.environ.get("GAE_PRETRAINED")
        if not args.small and ckpt and os.path.exists(ckpt):
            raise NotImplementedError(
                f"GAE_PRETRAINED={ckpt}: the whole-module GAE loader (the JAX package's "
                "load_torch_gae) is not ported; unset it to bench on seeded weights")
        opt = {"model": {
            "beta_schedule": {"val": {"schedule": "cosine", "n_timestep": args.timesteps,
                                      "linear_start": 1e-6, "linear_end": 1e-2}},
            "diffusion": {"image_size": size, "channels": 3, "conditional": True}}}
        self.device = device
        self.dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        self.size, self.channels, self.chunk = size, channels, args.chunk
        self.inner, self.mults = inner, tuple(mults)
        self.gae = GAE(n_subs=n_sub, n_ovls=n_ovl, n_colors=channels, n_feats=feats)
        self.unet = UNet(
            in_channel=6, out_channel=3, inner_channel=inner,
            norm_groups=16 if args.small else 32, channel_mults=tuple(mults),
            attn_res=tuple(attn), res_blocks=2, dropout=0.0, image_size=size,
            # the fused kernels round their operands to bf16, so an f32 run
            # stays unfused to keep its label honest (the root bench's rule)
            fuse_blocks=not args.no_fuse and args.dtype == "bf16",
            fuse_skip=False if args.no_fuse_skip else "auto",
            fuse_stats=not args.no_fuse_stats)
        init_weights(self.gae, torch.Generator().manual_seed(0))
        init_weights(self.unet, torch.Generator().manual_seed(0))
        self.gae.to(device=device, dtype=self.dtype).eval()
        self.unet.to(device=device, dtype=self.dtype).eval()
        self.diffusion = diffusion_for_phase(opt, "val")
        self.n_groups = group_indices(channels, n_sub, n_ovl).shape[0]

    def _denoise(self, x, t):
        return self.unet(x.to(self.dtype), t.to(self.dtype))

    @torch.inference_mode()
    def super_resolve(self, cube, seed, t_start=None, x_init=None, noise_seq=None):
        """GAE encode -> reverse chain over the B*G latents (``t_start``
        steps from ``init_from_cond``, or the full chain) -> GAE decode ->
        clip, as an f32 cube. With ``--chunk`` the latents go through the
        chain in sequential chunks, each with its own generator.
        ``x_init`` (B*G, h, w, 3) and ``noise_seq`` (T, B*G, h, w, 3)
        replace the drawn Gaussians."""
        z = self.gae.encode(cube.to(self.dtype))
        b, g, h, w, c = z.shape
        cond = z.reshape(b * g, h, w, c)
        n = cond.shape[0]
        step = self.chunk if self.chunk and n > self.chunk and n % self.chunk == 0 else n
        outs = []
        for k, i in enumerate(range(0, n, step)):
            gen = torch.Generator(device=cube.device).manual_seed(seed * (n // step) + k)
            outs.append(self.diffusion.sample_loop(
                self._denoise, cond=cond[i:i + step], t_start=t_start, generator=gen,
                x_init=None if x_init is None else x_init[i:i + step],
                noise_seq=None if noise_seq is None else noise_seq[:, i:i + step]))
        z_out = torch.cat(outs) if len(outs) > 1 else outs[0]
        y = self.gae.decode(z_out.reshape(b, g, h, w, c).to(self.dtype))
        return y.float().clamp(0.0, 1.0)

    @torch.inference_mode()
    def encode_decode(self, cube):
        """The fixed cost of a cube outside the chain: GAE encode + decode."""
        y = self.gae.decode(self.gae.encode(cube.to(self.dtype)))
        return y.float().clamp(0.0, 1.0)


def make_cube(args, model):
    rng = np.random.RandomState(0)
    cube = rng.rand(args.batch, model.size, model.size, model.channels)
    return torch.tensor(cube, dtype=torch.float32, device=model.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_seconds(fn, repeats, device):
    times = []
    for i in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn(i)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def measure(args, model):
    """Warm up and time one configuration; returns (out, info)."""
    device = model.device
    cube = make_cube(args, model)
    ts = args.t_start or None

    # the first call: the kernels' builds (nvcc) and a warm-up run
    t0 = time.perf_counter()
    model.super_resolve(cube, 0, ts)
    _sync(device)
    compile_s = time.perf_counter() - t0
    secs, times = _median_seconds(lambda i: model.super_resolve(cube, i + 1, ts),
                                  args.repeats, device)

    eff_steps = args.t_start or args.timesteps   # UNet forwards actually run
    info = {
        "device": device_name(device),
        "compile_s": round(compile_s, 2),
        "times": [round(t, 3) for t in times],
        "dtype": args.dtype,
        "timesteps": args.timesteps,
        "gae_ckpt": False,
        "size": model.size,
        "channels": model.channels,
        "batch": args.batch,
        "t_start": ts,
        "denoise_steps_per_sec_per_chip": round(
            eff_steps * model.n_groups * args.batch / secs, 2),
        "cubes_per_min": round(60.0 * args.batch / secs, 2),
    }
    print(json.dumps(info), file=sys.stderr)
    out = {
        "metric": f"dmgasr_x4_{model.size}x{model.size}x{model.channels}_cube_seconds",
        "value": round(secs / args.batch, 3),
        "unit": "s",
        "t_start": ts,
    }
    if args.profile and not args.cpu:
        # the analytic roofline of one UNet step (utils/roofline.py); the
        # GAE encode + decode is timed alone and taken off the call, so
        # step_measured_ms is the sampler's step at any t_start
        model.encode_decode(cube)
        ed_secs, _ = _median_seconds(lambda i: model.encode_decode(cube), args.repeats, device)
        sampler_secs = max(secs - ed_secs, 1e-9)
        dk = device_name(device)
        n_lat = model.n_groups * args.batch
        eff_b = min(n_lat, args.chunk) if args.chunk else n_lat
        rl = step_roofline(eff_b, model.size, device_kind=dk, inner=model.inner,
                           mults=model.mults)
        n_seq = max(1, n_lat // eff_b)   # sequential chunks per call
        step_s = sampler_secs / eff_steps
        att = rl["attainable_s"] * n_seq
        out["profile"] = {
            "device_kind": dk,
            "encode_decode_ms": round(ed_secs * 1e3, 2),
            "peak_bf16_tflops": rl["peak_tflops"],
            "peak_hbm_gbps": rl["peak_gbps"],
            "step_gflop": round(rl["total_gflop"] * n_seq, 1),
            "step_min_hbm_gb": round(rl["total_gb"] * n_seq, 3),
            "step_measured_ms": round(step_s * 1e3, 2),
            "step_attainable_ms": round(att * 1e3, 2),
            "achieved_tflops": round(rl["total_gflop"] * n_seq / step_s / 1e3, 1),
            "achieved_min_gbps": round(rl["total_gb"] * n_seq / step_s, 1),
            "pct_of_attainable": round(100.0 * att / step_s, 1),
        }
    return out, info


def run(args, model=None):
    """The headline row and, with ``--full_row``, the full-chain subrow;
    returns the JSON line's object."""
    device = resolve_device("cpu" if args.cpu else None)
    if model is None:
        model = Bench(args, device)
    out, _ = measure(args, model)
    if args.t_start and args.full_row:
        args2 = copy.copy(args)
        args2.t_start = 0
        args2.profile = False
        out2, _ = measure(args2, model)
        out["full_chain"] = {"timesteps": args.timesteps, "value": out2["value"]}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="a CPU-sized miniature")
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1,
                    help="cubes per inference call (throughput mode)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the fused GroupNorm-swish-conv Blocks")
    ap.add_argument("--no-fuse-skip", action="store_true",
                    help="materialise the up-path skip concats instead of "
                         "riding them through the fused kernel")
    ap.add_argument("--no-fuse-stats", action="store_true",
                    help="disable GroupNorm moment chaining")
    ap.add_argument("--profile", action=argparse.BooleanOptionalAction, default=True,
                    help="add the encode/decode time and the UNet step's "
                         "roofline share to the JSON line (not with --cpu)")
    ap.add_argument("--t_start", type=int, default=4,
                    help="run only the last N reverse steps from init_from_cond "
                         "(the headline; 0 = the full T chain only)")
    ap.add_argument("--full_row", action=argparse.BooleanOptionalAction, default=True,
                    help="when t_start > 0, also time the full-T chain as the "
                         "'full_chain' subrow")
    ap.add_argument("--chunk", type=int, default=0,
                    help="latent images per sampler chunk (0 = the whole B*G "
                         "batch at once)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # an f32 run is f32: no TF32 in cuDNN's convolutions or in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
