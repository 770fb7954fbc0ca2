#!/usr/bin/env python3
"""The card's gate for the PyTorch + CUDA port of DMGASR, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports only torch and hsi_dmgasr_tpu_torch,
and fails (exit code != 0, no result line) without a GPU, outside a
checkout, or at the first gate a path misses. It times no path: the
benchmark (``python3 -m portbench.run`` under BENCHMARK.json) measures
the cells. The one time it takes is each kernel's device time alone at
each launch signature the paths recorded (``kernel_ms``).

The paths, at full width with seeded weights and data, TF32 off. Those
marked * run the fused UNet, their launches held to ``FORWARDS``:

  * pavia_x4_r3, pavia_x4_r3_ddim, pavia_x4: configs/pavia_x4_r3.json
    (t_start 4; with DDIM, 4 steps, its chain with the kernels held to
    the same chain on their plain versions) and configs/pavia_x4.json
    (T = 20, flash at 128^2) on a 512^2 x 102 cube: the cube in [0, 1],
    one UNet forward with the kernels against their plain versions;
  * bench_x4_bf16 and its full chain: the port's bench at its defaults
    (bf16), the GAE's bf16 overlap average against the CPU's, one bf16
    UNet forward against the plain kernels;
  * pavia_x4_spatial: pavia_x4 through super_resolve_spatial on a
    ('data', 'space') = (1, 2) mesh, two ranks sharing the card over
    gloo: the ranks' latents bit for bit, the sharded chain within
    TOL_UNET of one device's;
  * pavia_x4_r3_dp: the r3 cube with a 'data' mesh over two such ranks
    (9 latents padded to 10, B=5 a rank), within TOL_UNET of one process;
  * pavia_x4_r3_chunked: latent_chunk 12 on 4 cubes against the same
    batch unchunked from the same draws; pavia_x4_tiled: a 1096 x 715
    scene through super_resolve_tiled(512, 32), its last tile against
    super_resolve of its patch;
    train_gae: stage 1 through cli.ae (12 steps, the save loaded back bit
    for bit, a batch-1 step card against CPU with HLoss in f32 and with
    the perceptual term in f64), then cli.gae_test;
  * train_r3: stage 2 through stage2_driver.train on that GAE (12 steps,
    the EMA per step, the checkpoint loaded back bit for bit, one
    validation on the fused UNet, every weight's _version moved by a step,
    the fused EMA UNet against its plain and unfused forwards, a batch-1
    step card against CPU);
  * train_r3_dp: train_r3's step for 3 steps over two ranks against one
    rank (states bit for bit alike, gradients and Adam within TRAIN_DP),
    one validation cube a rank; train_r3_remat: remat's step against the
    plain step;
    sample_ddpm_16: the BatchNorm DDPM's step card against CPU, then a
    DDIM sample of 2;
  * infer_sr3_16_128: cli.infer on configs/sr_sr3_16_128.json (200 steps,
    2 images), every PNG decoded, one forward and the chain's first 4
    steps against the plain kernels, cli.eval;
    sample_cli_ddpm_16: cli.sample train then val from its checkpoint;
    int8_probe: the int8 probe's chains, the kernel's int8 sums equal to
    the library's after 4000 links;
    baselines_x4, gan3d_x4, daq_refiners: the baseline zoo, the 3-D GAN,
    the DAQ blocks and refiners, each golden on the card and a step (a
    forward) card against CPU in f64; color_correction_torch against numpy.

Every kernel is then held to its plain version on the card at each
signature the paths recorded (f32 and bf16; the blocked dot in int8 bit
for bit), flash also at D = 128, D = 512 and the r3 level's 64^2, the up
path also against cuDNN's f32 transposed conv; the unfused UNet against
the reference golden. It prints the card line, the kernels JSON line
and, last, {"ok": true, "device": {...}}; details go to
chiprun_out/chip_smoke.json, the paths' files under build/.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
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
UP2, SPLIT, ATTENTION = "up2_conv3x3", "split_attention", "attention"
PROBE = "int8_probe"
R3, R3_DDIM, X4 = "pavia_x4_r3", "pavia_x4_r3_ddim", "pavia_x4"
# the main paths' model.diffusion changes (a None value removes the key):
# DDIM takes no t_start in the JAX package
DIFFUSION = {R3: {}, R3_DDIM: {"sampler": "ddim", "ddim_steps": 4, "t_start": None}, X4: {}}
# the port's bench at its defaults (512^2 x 102, bf16, fused): its two rows
BENCH, BENCH_FULL = "bench_x4_bf16", "bench_x4_bf16:full_chain"
# stage-2 training under configs/pavia_x4_r3.json: TRAIN_STEPS steps, then
# one validation of 3 scenes x 3 chains on the fused UNet
TRAIN, TRAIN_STEPS = "train_r3", 12
TRAIN_SCENES, TRAIN_SCENE_HW, VAL_HW = 8, 256, 128
# SR3 16 -> 128 through cli.infer: INFER_IMAGES faces, the val schedule cut
# to INFER_T steps; INFER_REPLAY steps replayed kernels against plain
INFER, INFER_IMAGES, INFER_T, INFER_REPLAY = "infer_sr3_16_128", 2, 200, 4
# H-sharded inference under configs/pavia_x4.json on a (1, 2) mesh, each
# rank replaying the pavia_x4 cube's draws (seed 2). The JAX package holds
# its sharded chain to 1e-4 of one device's (printed here, not gated: the
# kernel's per-row stats take atomicAdds in no fixed order, so two
# single-device chains differ too); the gate is TOL_UNET.
SPATIAL, SPATIAL_MESH, SPATIAL_SEED = "pavia_x4_spatial", (1, 2), 2
SPATIAL_JAX_TOL = 1e-4
# the ranks gather the same latent bit for bit and each decodes it: their
# cubes (in [0, 1]) may differ in the last bits of cuDNN's convolutions
SPATIAL_RANK_TOL = 1e-6
# latent_chunk CHUNK on CHUNK_CUBES cubes (36 latents in 3 chains of 12),
# against the same batch unchunked from the same draws (the stats atomics
# alone move a chain by about 3e-3)
CHUNKED, CHUNKED_WHOLE, CHUNK, CHUNK_CUBES = ("pavia_x4_r3_chunked",
                                              "pavia_x4_r3_chunked:unchunked", 12, 4)
# one seeded SR cube the size of the Pavia Centre scene through
# super_resolve_tiled(TILE, OVERLAP) under the r3 config: six 512^2 tiles
TILED, SCENE, TILE, OVERLAP = "pavia_x4_tiled", (1096, 715, 102), 512, 32
TILE_ORIGINS = [(y, x) for y in (0, 480, 584) for x in (0, 203)]
# the r3 cube through super_resolve with a 'data' mesh over two ranks on
# the one card (gloo: NCCL refuses two ranks on one device): each rank
# draws the whole batch as one process does, wrap-pads 9 latents to 10 and
# runs its 5; the gathered latent against one process's (TOL_UNET)
R3_DP, R3_DP_SEED = "pavia_x4_r3_dp", 2
# data-parallel training: train_r3's step (TRAIN_DP_CROPS HR crops, 36
# latents) for TRAIN_DP_STEPS steps over two ranks on the one card (18
# latents each) from the weights and draws of a one-rank run; then one
# validation cube of 128^2 a rank. Rank 0's first all-reduced gradients are
# held to the one-rank run's (TOL_STEP_GRAD of the largest |g|) and its Adam
# moments to the one rank's (TOL_TRAIN_DP_ADAM of each leaf's largest
# |value|): these catch a gradient summed where it should be averaged and
# draws cut wrong. The share of weights further than 0.05 lr from the one
# rank's is held to TRAIN_DP_SHARE_OFF: Adam moves a weight by about lr
# times its gradient's sign, so where a gradient near 0 takes the other
# sign between cuDNN's batch-36 and batch-18 convolutions the weight lands
# about 2 lr away. Measured on the H100 (PERF.md): latents of the trained
# GAE put 7.9e-4 of the weights past 0.05 lr, Adam's moments 5.9e-4 off; a
# seeded GAE's 1.1e-6 (tools/train_dp_divergence.py runs both).
TRAIN_DP, TRAIN_DP_STEPS, TRAIN_DP_CROPS, TRAIN_DP_SEED = "train_r3_dp", 3, 4, 61
TOL_TRAIN_DP_ADAM, TRAIN_DP_SHARE_OFF = 1e-2, 1e-2
# train_r3's step with model.unet.remat on against the same step without it
# from the same weights, batch and dropout generator: tests/test_remat.py's
# atol and rtol on the loss and every gradient
REMAT = "train_r3_remat"
TOL_REMAT_ABS, TOL_REMAT_REL = 1e-4, 1e-3
# configs/sample_ddpm_16.json at its full width (the discrete-t BatchNorm
# UNet, unfused): one train step of SAMPLE_BATCH HR images of 128^2 x 3 on
# the card against the CPU's, then DDPMModel.sample of SAMPLE_N images by
# DDIM over SAMPLE_DDIM_STEPS (2000 ancestral steps take about 40 s)
SAMPLE, SAMPLE_BATCH, SAMPLE_N, SAMPLE_DDIM_STEPS = "sample_ddpm_16", 4, 2, 100
# the BatchNorm running statistics after that step, card against CPU: max
# |diff| over max |CPU| per buffer (means over 65536 values a channel)
TOL_STEP_STATS = 1e-4
# the same config through cli.sample: -p train for SAMPLE_CLI_STEPS steps
# of the faces, then -p val on that checkpoint; both schedules cut to
# SAMPLE_CLI_T steps
SAMPLE_CLI, SAMPLE_CLI_STEPS, SAMPLE_CLI_T = "sample_cli_ddpm_16", 4, 100
FACES = 4  # seeded 128^2 HR images (and their 16 -> 128 SR images) for both CLIs
# color_correction_torch on the card against the numpy color_correction
TOL_COLOR = 1e-5
# stage-1 GAE training through cli.ae at the Pavia GAE's width,
# device-resident scenes: 8 HR crops of 128^2 x 102 a step, 2 epochs cut
# at TRAIN_GAE_STEPS, ending on the second epoch's save
TRAIN_GAE, TRAIN_GAE_STEPS, TRAIN_GAE_BATCH, TRAIN_GAE_EPOCHS = "train_gae", 12, 8, 2
# the perceptual term's weight in the card-vs-CPU check (the shipped 1e-3
# would hide the term under the loss's rtol), and the bands it replays
TRAIN_GAE_P_WEIGHT, TRAIN_GAE_BANDS = 1.0, (5, 50, 97)
# the baseline zoo through cli.baselines at its defaults on 102 bands, each
# model BASELINE_STEPS steps, then cli.baselines test over 1 scene; edsr at
# scale 2 (the reference pins it). CEGATSR, which no CLI trains, as one
# forward on a batch of BASELINE_BATCH
BASELINES, BASELINE_STEPS, BASELINE_BATCH = "baselines_x4", 3, 16
BASELINE_MODELS = (("sspsr", 4), ("gelin", 4), ("mcnet", 4), ("gdrrn", 4), ("edsr", 2))
# golden file -> (its width, the model's inputs, atol); rtol GOLDEN_RTOL
GOLDEN_WIDTHS = {
    "sspsr": (dict(n_subs=8, n_ovls=2, n_colors=31, n_blocks=3, n_feats=16, n_scale=4), "x,x", 2e-5),
    "gelin": (dict(n_feats=16, n_colors=31, n_subs=8, n_ovls=2, blocks=2, scale=4), "x,lms", 2e-5),
    "mcnet": (dict(scale=4, n_colors=31, n_feats=8), "x", 2e-5),
    "edsr": (dict(n_resblocks=2, n_feats=16, n_colors=31), "x", 2e-5),
    "gdrrn": (dict(input_chnl_hsi=31, group=4), "x", 5e-5),
    "cegatsr": (dict(n_subs=8, n_ovls=2, in_feats=31, n_blocks=1, out_feats=16, n_scale=4),
                "x,lms", 2e-5),
}
GOLDEN_RTOL = 1e-4
# an f64 gradient leaf whose largest |g| is below GRAD_NOISE x the largest of
# all leaves is 0 but for rounding; it is held to that floor (grads_against_cpu)
GRAD_NOISE = 1e-9
# the 3-D GAN through cli.gan_train at its defaults on a seeded stacked-scene
# .npy of GAN3D_SCENES scenes of 31 x GAN3D_HW^2, GAN3D_STEPS steps
GAN3D, GAN3D_STEPS, GAN3D_SCENES, GAN3D_HW = "gan3d_x4", 3, 2, 512
# DAQ quantization and the refiners at the reference's widths: ResBlockDAQ,
# SSBDAQ and ResAttentionBlockDAQ at n_feats DAQ_FEATS and a_bit = w_bit in
# DAQ_BITS on DAQ_CROPS crops of DAQ_HW^2; AttentionNet(102, 64) on one
# 512^2 x 102 cube; post_unet(102, 102) on 4 x 128^2 x 102 in train mode;
# Codebook(4096, 512) on 1024 vectors. No kernel of the port runs but the
# split attention kernel, in post_unet's f32 forward on the card.
DAQ, DAQ_CROPS, DAQ_HW, DAQ_FEATS, DAQ_BITS, DAQ_HELD = "daq_refiners", 16, 128, 64, (4, 8), 4
ZOO_PATHS = (BASELINES, GAN3D, DAQ)
# flash checks beside pavia_x4's own shape: D=128 (two heads) and D=512 with
# a ragged S, both past the 8192-token gate, and pavia_x4_r3's 64^2
# attention (4096 tokens, D=512); each, and pavia_x4's, also with bf16 q, k, v
FLASH_EXTRA = ((9, 16384, 2, 128), (4, 8200, 1, 512), (9, 4096, 1, 512))

# The UNet forwards of each fused path's counted run (a rank's for the
# two-rank paths, an image's for INFER) with the UNet it builds (a config
# under configs/, or "bench", the port's bench at its defaults), the batch
# and the latent's side. Every launch count the paths are held to comes
# from this table and ``launches_per_forward``.
FORWARDS = {
    R3: ("pavia_x4_r3.json", 4, 9, 512),          # t_start 4
    R3_DDIM: ("pavia_x4_r3.json", 4, 9, 512),     # DDIM, 4 steps
    X4: ("pavia_x4.json", 20, 9, 512),            # T = 20
    BENCH: ("bench", 4, 9, 512),                  # t_start 4
    BENCH_FULL: ("bench", 20, 9, 512),
    TRAIN: ("pavia_x4_r3.json", 3 * 3 * 4, 9, VAL_HW),  # 3 val scenes x 3 chains
    INFER: ("sr_sr3_16_128.json", INFER_T, 1, 128),
    SPATIAL: ("pavia_x4.json", 20, 9, 512),       # an H-shard's
    CHUNKED: ("pavia_x4_r3.json", 3 * 4, CHUNK, 512),
    CHUNKED_WHOLE: ("pavia_x4_r3.json", 4, CHUNK_CUBES * 9, 512),
    TILED: ("pavia_x4_r3.json", len(TILE_ORIGINS) * 4, 9, TILE),
    R3_DP: ("pavia_x4_r3.json", 4, 5, 512),       # 9 latents padded to 10
    TRAIN_DP: ("pavia_x4_r3.json", 4, 5, VAL_HW),  # a validation cube
}

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
# the split attention kernel vs its plain version, elementwise: 2^-16 of
# (1 + 2 A_i) W_id, A_i the row's largest sum |q||k| * scale, W_id =
# sum_j p_ij |v_jd| (kernels/split_attention.py:split_bound derives it)
TOL_SPLIT = 2.0 ** -16
# training: the EMA against its recomputation from per-step snapshots (max
# |diff| / max |want| per leaf), and one step on the card against the same
# step on the CPU (loss relative; gradients atol 1e-3 of the largest |g|)
TOL_EMA, TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-6, 1e-4, 1e-3
# blocked dot, bf16: f32 sums in another order than the plain version's
# float64, on outputs of about sqrt(K) = 14-24 (int8 is held bit for bit)
TOL_DOT_ABS, TOL_DOT_REL = 1e-3, 1e-4
# up path kernel, elementwise, as a share of sum |x| |w| over the output's
# taps: its bf16 hi + lo products leave out terms below 3 x 2^-18 (1.1e-5) of
# it, and f32 sums over K = 4 C taps in another order add about 1e-6
TOL_UP2 = 2e-5


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def kernel_ms(launch):
    """Device milliseconds of one ``launch()``: 10 launches captured back
    to back in one CUDA graph, the graph replayed once untimed and then 3
    times between two CUDA events. The host's launch work stays out of
    the time."""
    import torch

    calls, reps = 10, 3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            launch()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def relaunch(call):
    """``call()``, a wrapper call that launches one kernel, and a function
    that launches that kernel again alone: its C entry on the same
    arguments through ``build.launch``, overwriting the same outputs,
    without the wrapper's host work. The function holds every tensor the
    launch was given, so none of its buffers is freed while it is used.
    Returns (the call's result, the function)."""
    from hsi_dmgasr_tpu_torch.kernels import build

    real, seen = build.launch, []

    def rec(*args):
        seen.append(args)
        return real(*args)

    with mock.patch.object(build, "launch", rec):
        out = call()
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} kernel launches in one wrapper call")
    return out, lambda: real(*seen[0])


# ------------------------------------------------------- launches and calls


def path_unet(source):
    """The UNet a path builds, on the meta device (no memory, no weights):
    from ``source``, a config under configs/ with its fused Blocks on (as
    every fused path sets them), or "bench", the port's bench at its
    defaults."""
    import torch

    from hsi_dmgasr_tpu_torch import bench
    from hsi_dmgasr_tpu_torch.config import load
    from hsi_dmgasr_tpu_torch.models.networks import define_G

    with torch.device("meta"):
        if source == "bench":
            return bench.Bench(bench.parse_args([]), torch.device("meta")).unet
        opt = load(os.path.join(ROOT, "configs", source))
        opt["model"]["unet"]["fuse"] = True
        return define_G(opt)[0]


def launches_per_forward(unet, batch, side, sharded=False):
    """The route counts of one forward of ``unet`` on the card at (batch,
    side, side), in eval mode and its weights' dtype, as the counters keep
    them: with ``UNet.fused_routes``, each fused Block on the fused
    kernel's route for its Cout and each fused Upsample on the up path's
    kernel where it ``fits`` and on the transposed conv otherwise (on
    neither router on an H-shard, ``sharded``: its own transposed conv);
    each SelfAttention on ``attention.route`` of its level's (S, D)."""
    from hsi_dmgasr_tpu_torch.kernels import attention, fused_conv, up2_conv
    from hsi_dmgasr_tpu_torch.models.unet import Block, Downsample, Upsample

    dtype = next(unet.parameters()).dtype
    blocks, fused = unet.eval().fused_routes()
    n = {"fused": dict.fromkeys(fused_conv.LAUNCHES_BY_ROUTE, 0),
         ATTENTION: dict.fromkeys(attention.LAUNCHES_BY_ROUTE, 0),
         UP2: dict.fromkeys(up2_conv.LAUNCHES_BY_ROUTE, 0)}
    if blocks:
        for m in unet.modules():
            if isinstance(m, Block):
                n["fused"][fused_conv.route(m.block[3].out_channels)] += 1
    level = side
    for layer in (*unet.downs[1:], *unet.mid, *unet.ups):
        if isinstance(layer, Downsample):
            level //= 2
        elif isinstance(layer, Upsample):
            level *= 2
            c = layer.conv.out_channels
            if fused and not sharded:
                n[UP2]["kernel" if up2_conv.fits(dtype, c, c) else "transpose"] += 1
        elif layer.with_attn:
            a = layer.attn
            d = a.qkv.in_channels // a.n_head
            n[ATTENTION][attention.route(dtype, True, level * level, d, False,
                                         batch * a.n_head)] += 1
    return n


def expected_launches(path, scale=1):
    """The route counts after ``path``'s counted run (a rank's, an image's;
    times ``scale``): ``launches_per_forward`` of the UNet it builds times
    its forwards in FORWARDS."""
    source, forwards, batch, side = FORWARDS[path]
    per = launches_per_forward(path_unet(source), batch, side, sharded=path == SPATIAL)
    return {k: {r: c * forwards * scale for r, c in routes.items()} for k, routes in per.items()}


def kernels_of(routes):
    """Each kernel's launches in route counts: the Blocks on either of
    the fused kernel's routes, flash and split, and the up path's kernel."""
    return {FUSED: sum(routes["fused"].values()), FLASH: routes[ATTENTION]["flash"],
            SPLIT: routes[ATTENTION]["split"], UP2: routes[UP2]["kernel"], DOT: 0}


def zero_counts():
    """Every launch counter and route count of the port to 0."""
    from hsi_dmgasr_tpu_torch.kernels import attention, up2_conv
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    fc.LAUNCHES = fa.LAUNCHES = sa.LAUNCHES = bd.LAUNCHES = 0
    for routes in (fc.LAUNCHES_BY_ROUTE, attention.LAUNCHES_BY_ROUTE, up2_conv.LAUNCHES_BY_ROUTE):
        routes.update(dict.fromkeys(routes, 0))


def counted():
    """The route counts since ``zero_counts``, and each kernel's own
    launch counter."""
    from hsi_dmgasr_tpu_torch.kernels import attention, up2_conv
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    routes = {"fused": dict(fc.LAUNCHES_BY_ROUTE), ATTENTION: dict(attention.LAUNCHES_BY_ROUTE),
              UP2: dict(up2_conv.LAUNCHES_BY_ROUTE)}
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, SPLIT: sa.LAUNCHES,
                UP2: up2_conv.LAUNCHES_BY_ROUTE["kernel"], DOT: bd.LAUNCHES}
    return routes, launches


def no_launches(name, split=0):
    """No kernel launched since ``zero_counts`` but ``split`` launches of
    the split attention kernel (None: any number, the unfused UNet's
    attention). Returns the launches."""
    launches = counted()[1]
    if split is None:
        split = launches[SPLIT]
    if launches != {FUSED: 0, FLASH: 0, SPLIT: split, UP2: 0, DOT: 0}:
        raise AssertionError(f"[{name}] launched {launches}, expected no kernel but {split} "
                             "split attention launches")
    return launches


def call_route(call):
    """The route ``attention.route`` gives a recorded attention call."""
    from hsi_dmgasr_tpu_torch.kernels import attention

    shape, dtype, grad, cuda = call
    return attention.route(dtype, cuda, shape[1], shape[3], grad, shape[0] * shape[2])


def check_routes(name, calls):
    """The attention router's counts since ``zero_counts`` against the
    routes of the calls ``recording`` recorded, and the split kernel's
    launches against its route's: every CUDA f32 call below the flash
    gate that records no graph, at a shape the kernel takes, launched it.
    Returns the routes."""
    routes, launches = counted()
    want = dict.fromkeys(routes[ATTENTION], 0)
    for call, n in calls[ATTENTION].items():
        want[call_route(call)] += n
    if routes[ATTENTION] != want or launches[SPLIT] != want["split"]:
        raise AssertionError(f"[{name}] attention routes {routes[ATTENTION]} ({launches[SPLIT]} "
                             f"split launches), the recorded calls' routes {want}")
    return want


def check_launches(name, want, calls):
    """The counts since ``zero_counts`` against ``want``
    (``expected_launches``): every route count, every kernel's own
    counter, no blocked dot, and the calls ``recording`` recorded (each
    counted once, attention on its route). Returns the launches."""
    routes, launches = counted()
    check_routes(name, calls)
    recorded = {FUSED: sum(calls[FUSED].values()), FLASH: sum(calls[FLASH].values()),
                UP2: sum(calls[UP2].values())}
    log(f"[{name}] launches {launches}, routes {routes}; {len(calls[FUSED])} fused signatures")
    if (routes != want or launches != kernels_of(want)
            or recorded != {FUSED: launches[FUSED], FLASH: launches[FLASH],
                            UP2: sum(want[UP2].values())}):
        raise AssertionError(f"[{name}] routes {routes}, launches {launches}, recorded calls "
                             f"{recorded}; expected routes {want}")
    return launches


@contextmanager
def recording():
    """Record the signature of every fused-Block, flash, up-path and
    attention call the UNet makes: yields {kind: {signature: calls}}. The
    real functions still run, and count their own launches."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import attention as attn_mod
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod

    calls = {FUSED: {}, FLASH: {}, UP2: {}, ATTENTION: {}}
    real_fused, real_flash = unet_mod.gn_swish_conv3x3, attn_mod.flash_attention
    real_up2, real_attn = unet_mod.up2_conv3x3, unet_mod.spatial_attention

    def count(kind, sig):
        calls[kind][sig] = calls[kind].get(sig, 0) + 1

    def rec_fused(x, gn_scale, gn_bias, kernel, bias, **kw):
        x2 = kw.get("x2")
        sig = (tuple(x.shape), 0 if x2 is None else x2.shape[-1], kernel.shape[-1],
               kw.get("time_bias") is not None, kw.get("residual") is not None,
               kw.get("stats_in") is not None, kw.get("stats_in2") is not None,
               bool(kw.get("emit_stats")), kw.get("res_kernel") is not None,
               dtype_name(x.dtype))
        if kw.get("halo") is not None:  # an H-shard's launch: which shard
            sig += (shard_position(kw["mesh"]),)
        count(FUSED, sig)
        return real_fused(x, gn_scale, gn_bias, kernel, bias, **kw)

    def rec_flash(q, k, v, scale):
        count(FLASH, (tuple(q.shape), dtype_name(q.dtype)))
        return real_flash(q, k, v, scale)

    def rec_up2(x, kernel, bias=None, **kw):
        count(UP2, (tuple(x.shape), kernel.shape[-1], bias is not None, dtype_name(x.dtype)))
        return real_up2(x, kernel, bias, **kw)

    def rec_attn(q, k, v, scale, **kw):
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        count(ATTENTION, (tuple(q.shape), q.dtype, grad, q.is_cuda))
        return real_attn(q, k, v, scale, **kw)

    with mock.patch.object(unet_mod, "gn_swish_conv3x3", rec_fused), \
            mock.patch.object(attn_mod, "flash_attention", rec_flash), \
            mock.patch.object(unet_mod, "up2_conv3x3", rec_up2), \
            mock.patch.object(unet_mod, "spatial_attention", rec_attn):
        yield calls


def merged(runs):
    """The recorded calls of several runs (ranks), summed."""
    out = {kind: {} for kind in runs[0]}
    for calls in runs:
        for kind, sigs in calls.items():
            for sig, n in sigs.items():
                out[kind][sig] = out[kind].get(sig, 0) + n
    return out


def counted_run(name, run, path=None):
    """``run()`` with every count at 0 before it and its calls recorded,
    then the counts held to ``expected_launches`` of ``path`` (or
    ``name``). Returns its output, calls and launches."""
    import torch

    zero_counts()
    with recording() as calls:
        out = run()
    torch.cuda.synchronize()
    return out, calls, check_launches(name, expected_launches(path or name), calls)


# ------------------------------------------------------------ signatures


@contextmanager
def plain_kernels():
    """Route the UNet through the kernels' plain versions."""
    from hsi_dmgasr_tpu_torch.kernels import attention as attn_mod
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa
    from hsi_dmgasr_tpu_torch.kernels import up2_conv
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod
    from hsi_dmgasr_tpu_torch.ops import fused_up

    def plain(*args, packed=None, **kw):
        return fc.gn_swish_conv3x3_plain(*args, **kw)

    def plain_up(x, kernel, bias=None, packed=None):
        if up2_conv.takes(x, kernel):
            return fused_up.up2_conv3x3_parity(x, kernel, bias)
        return fused_up.up2_conv3x3_transpose(x, kernel, bias)

    with mock.patch.object(unet_mod, "gn_swish_conv3x3", plain), \
            mock.patch.object(unet_mod, "up2_conv3x3", plain_up), \
            mock.patch.object(attn_mod, "flash_attention", fa.flash_attention_plain), \
            mock.patch.object(attn_mod, "split_attention", sa.split_attention_plain):
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


def shard_position(mesh):
    """'first', 'middle' or 'last' H-shard of the mesh's 'space' axis."""
    if mesh.space_idx == 0:
        return "first"
    return "last" if mesh.space_idx == mesh.n_space - 1 else "middle"


# a shard position -> (n_space, space_idx) of a one-process mesh with its edge flags
SHARD_AT = {"first": (2, 0), "middle": (3, 1), "last": (2, 1)}


def describe(sig):
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig[:10]
    extras = [n for n, on in (("tb", tb), ("res", res), ("stats_in", sin),
                              ("stats_in2", sin2), ("stats", emit), ("proj", proj)) if on]
    src = f"{c}+{c2}" if c2 else f"{c}"
    halo = f" halo@{sig[10]}" if len(sig) > 10 else ""
    return f"{dt} B={b} {h}x{w} {src}->{cout} {'+'.join(extras) or 'none'}{halo}"


def make_inputs(sig, device, seed):
    """Inputs of one launch signature. A bf16 signature gets every tensor in
    bf16, as the bf16 UNet hands them over (its weights, the noise Linear's
    time bias, the residual and the skip); the moments stay f32. An H-shard
    signature also gets raw halo rows and a one-process mesh whose edge
    flags are the shard's (its moments are the shard's own: the kernel and
    the plain version see the same)."""
    import torch

    from hsi_dmgasr_tpu_torch.parallel.mesh import Mesh

    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig[:10]
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
    if len(sig) > 10:
        n_space, idx = SHARD_AT[sig[10]]
        kw["mesh"] = Mesh(1, n_space, 0, idx, torch.device(device))
        for name, src in (("halo", args[0]), ("halo2", kw.get("x2"))):
            if src is not None:
                kw[name] = tuple(randn(b, 1, w, src.shape[-1]).to(src.dtype) for _ in range(2))
    return args, kw


def check_signature(sig, seed):
    """The fused kernel against its plain version on the card at one
    launch signature, and its time alone."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    args, kw = make_inputs(sig, "cuda", seed)
    res_k = kw.get("res_kernel")
    packed = fc.pack_conv3x3(args[3], res_k)
    got, launch = relaunch(lambda: fc.gn_swish_conv3x3(*args, packed=packed, **kw))
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
    del want
    return {"signature": describe(sig), "errors": errs, "kernel_ms": kernel_ms(launch)}


def check_up2(sig, seed):
    """The up path's kernel at one recorded f32 signature, through
    ``up2_conv3x3`` on weights packed once (as ``Upsample`` keeps them):
    against its plain version and cuDNN's f32 transposed conv, each within
    TOL_UP2 of sum |x| |w|; its time alone."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import up2_conv
    from hsi_dmgasr_tpu_torch.ops import fused_up

    (b, h, w, c), cout, with_bias, _ = sig
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    kernel = torch.randn((3, 3, c, cout), generator=gen, device="cuda") / math.sqrt(9 * c)
    bias = torch.randn((cout,), generator=gen, device="cuda") if with_bias else None
    packed = up2_conv.pack_up2(fused_up.parity_taps(kernel))
    launched = up2_conv.LAUNCHES_BY_ROUTE["kernel"]
    got, launch = relaunch(lambda: fused_up.up2_conv3x3(x, kernel, bias, packed=packed))
    if up2_conv.LAUNCHES_BY_ROUTE["kernel"] != launched + 1:
        raise AssertionError(f"{UP2} {sig}: the f32 call did not take the kernel")
    scale = fused_up.up2_conv3x3_transpose(x.abs(), kernel.abs())
    errs = {}
    for name, want in (("plain", fused_up.up2_conv3x3_parity(x, kernel, bias)),
                       ("cudnn_f32", fused_up.up2_conv3x3_transpose(x, kernel, bias))):
        rel = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
        errs[name] = {"max_abs": (got - want).abs().max().item(), "max_rel_sum": rel}
        if rel > TOL_UP2:
            raise AssertionError(f"{UP2} {sig}: kernel vs {name} {errs[name]}")
    del want, scale
    return {"signature": f"f32 B={b} {h}x{w} {c}->{cout}" + ("" if with_bias else " no bias"),
            "errors": {"out": errs["cudnn_f32"], **errs}, "kernel_ms": kernel_ms(launch)}


def attention_inputs(sig, seed):
    """Strided q, k, v views of one seeded qkv tensor (f32 or bf16), as the
    UNet makes them, and the scale."""
    import torch

    (b, s, h, d), dt = sig
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, h, 3 * d), generator=gen, device="cuda").to(dtype)
    return (*qkv.split(d, dim=-1), 1.0 / math.sqrt(h * d))


def check_flash(sig, seed):
    """The flash kernel against its plain version on the card, on strided
    q, k, v views as the UNet makes them; the time alone of its C entry and
    of each phase (the bf16 prepass where its head dim has one, the
    attention body on the scratch the prepass filled), whose output must be
    the wrapper's bit for bit."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa

    (b, s, h, d), dt = sig
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, scale = attention_inputs(sig, seed)
    got = fa.flash_attention(q, k, v, scale)
    want = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    if got.dtype != dtype or want.dtype != dtype:
        raise AssertionError(f"flash {sig}: output dtypes {got.dtype}, {want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = {"max_abs": diff.max().item(), "max_rel": diff.max().item() / want.float().abs().max().item()}
    if not bool((diff <= TOL_FLASH_ABS + TOL_FLASH_REL * want.float().abs()).all()):
        raise AssertionError(f"flash {sig}: kernel vs plain {err}")
    del want, diff
    out, scratch = fa.buffers(q)
    phases = {"kernel_ms": 3, "body_ms": 2} if scratch is None else {
        "kernel_ms": 3, "prepass_ms": 1, "body_ms": 2}
    times = {name: kernel_ms(lambda p=p: fa.run_phases(q, k, v, scale, out, scratch, p))
             for name, p in phases.items()}
    if not torch.equal(out, got):
        raise AssertionError(f"flash {sig}: the attention body alone != the wrapper's output")
    return {"signature": f"{dt} B={b} S={s} H={h} D={d}", "errors": {"out": err}, **times}


def check_split(sig, seed):
    """The split attention kernel against its plain version on the card
    (TOL_SPLIT of ``split_bound``), on strided q, k, v views of one f32 qkv
    tensor as the UNet makes them; the time alone of its C entry and of
    each phase (the split, the logits, p . v, each on what the others
    wrote)."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    (b, s, h, d), dt = sig
    q, k, v, scale = attention_inputs(sig, seed)
    got = sa.split_attention(q, k, v, scale)
    want = sa.split_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    diff = (got - want).abs().double()
    bound = sa.split_bound(q, k, v, scale)
    err = {"max_abs": diff.max().item(), "max_rel": diff.max().item() / want.abs().max().item(),
           "of_bound": (diff / bound).max().item()}
    if not bool((diff <= TOL_SPLIT * bound).all()):
        raise AssertionError(f"split {sig}: kernel vs plain {err}")
    del got, want, diff, bound
    torch.cuda.empty_cache()
    bufs = sa.buffers(q)
    times = {name: kernel_ms(lambda p=p: sa.run_phases(q, k, v, scale, *bufs, p))
             for name, p in (("kernel_ms", 7), ("split_ms", 1), ("logits_ms", 2), ("pv_ms", 4))}
    return {"signature": f"{dt} B={b} S={s} H={h} D={d}", "errors": {"out": err}, **times}


def check_dot(case, dt, seed):
    """The blocked dot against its plain version on the card at one probe
    case (int8 bit for bit), a 3-link chain captured in a CUDA graph
    against the same links run eagerly (bit for bit), and its time alone
    (the operands stay in the L2 between the graph's launches)."""
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
    got, launch = relaunch(lambda: bd.blocked_dot(x, wp, bm, bn))
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
    del want, diff

    dot = mb.kernel_dot(w, bm, bn)
    eager = mb.run_chain(dot, x, 3)
    mb.warm_up(dot, x)
    graph, _, out = mb.capture_chain(dot, x, 3)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise AssertionError(f"blocked dot {name} {dt}: captured 3-link chain != eager chain")
    del graph, out, eager
    return {"signature": f"{name} {dt} {m}x{k}x{n}", "errors": {"out": err},
            "kernel_ms": kernel_ms(launch)}


# ------------------------------------------------------------- the slice


def build_pipeline(config, diffusion, n_devices=None):
    """The config's pipeline with fused Blocks, its model.diffusion updated
    by ``diffusion`` (a None value removes the key); ``n_devices`` sets the
    options' device count (the model's 'data' mesh, capped at the ranks)."""
    from hsi_dmgasr_tpu_torch.config import load
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    opt = load(os.path.join(ROOT, "configs", config))
    opt["model"]["unet"]["fuse"] = True
    if n_devices is not None:
        opt["n_devices"] = n_devices
    for k, v in diffusion.items():
        if v is None:
            opt["model"]["diffusion"].pop(k, None)
        else:
            opt["model"]["diffusion"][k] = v
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


def check_cube(name, out, shape):
    import torch

    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{name}] cube {tuple(out.shape)} or non-finite values")
    lo, hi = out.min().item(), out.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"[{name}] cube outside [0, 1]: [{lo}, {hi}]")


def run_path(name, cube):
    """One main path: its counted cube, checked; a DDIM path's chain from a
    seeded x_init with the kernels against the same chain on their plain
    versions; one full-width UNet forward with the kernels against their
    plain versions. Returns its report and recorded calls."""
    import torch

    pipe = build_pipeline(FORWARDS[name][0], DIFFUSION[name])
    out, calls, launches = counted_run(
        name, lambda: pipe.super_resolve(cube, generator=torch.Generator(
            device="cuda").manual_seed(2)))
    check_cube(name, out, CUBE)
    del out
    report = {"config": FORWARDS[name][0], "diffusion": DIFFUSION[name], "launches": launches}
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        cond = pipe._fold(pipe.encode(cube))
        if DIFFUSION[name].get("sampler") == "ddim":
            x_init = torch.randn(cond.shape, generator=torch.Generator(
                device="cuda").manual_seed(8), device="cuda")
            got = pipe.ddpm.super_resolution(cond, x_init=x_init)
            with plain_kernels():
                want = pipe.ddpm.super_resolution(cond, x_init=x_init)
            report["chain_err"] = divergence(got, want)
            log(f"[{name}] one chain (B=9, 512^2) from the same x_init, kernels vs plain: "
                f"{report['chain_err']}")
            if not within(got, want, TOL_UNET):
                raise AssertionError(f"[{name}] chain with the kernels vs plain: "
                                     f"{report['chain_err']}")
            del got, want
        x = torch.cat([cond, torch.randn(cond.shape, generator=gen, device="cuda")], -1)
        t = torch.full((x.shape[0], 1), 0.5, device="cuda")
        report["unet_forward_err"] = check_unet(name, pipe.ddpm.eval_unet, x, t)
    log(f"[{name}] full-width UNet forward (B=9, 512^2): kernels vs plain "
        f"{report['unet_forward_err']}")
    del pipe, x, cond
    torch.cuda.empty_cache()
    return report, calls


def spatial_rank(rank, device, weights):
    """One rank of pavia_x4_spatial: the pavia_x4 pipeline on the weights
    the parent saved, one counted cube through super_resolve_spatial
    replaying the pavia_x4 cube's draws (the gathered latent caught at the
    decode). Returns its launches, calls, bytes gathered, latent and cube."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.parallel import dmgasr_mesh

    use_f32_policy()
    mesh = dmgasr_mesh(*SPATIAL_MESH)
    torch.cuda.set_device(mesh.device)
    pipe = build_pipeline(FORWARDS[SPATIAL][0], {})
    state = torch.load(weights, map_location=mesh.device)
    pipe.gae.load_state_dict(state["gae"])
    pipe.ddpm.eval_unet.load_state_dict(state["unet"])
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    mesh.gathered.clear()
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out, calls, launches = counted_run(
            f"{SPATIAL}:rank{rank}", lambda: pipe.super_resolve_spatial(
                cube, mesh, generator=torch.Generator(device="cuda").manual_seed(SPATIAL_SEED),
                replay_noise=True), SPATIAL)
    check_cube(SPATIAL, out, CUBE)
    return {"launches": launches, "calls": calls, "gathered_bytes": dict(mesh.gathered),
            "latent": decode.call_args[0][0].cpu(), "cube": out.cpu()}


def run_spatial():
    """pavia_x4_spatial, in the parent: the pavia_x4 pipeline's
    single-device cube twice from the same draws (the latent caught at the
    decode: the reference, and the spread two single-device chains show),
    its weights saved for the ranks; then the two ranks (multihost.launch,
    a file:// store), each checked for its counts and cube; the ranks'
    latents equal and their cubes within SPATIAL_RANK_TOL; the sharded
    latent against the single-device one within TOL_UNET."""
    import tempfile

    import torch

    from hsi_dmgasr_tpu_torch.parallel import multihost

    pipe = build_pipeline(FORWARDS[SPATIAL][0], {})
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    single = []
    for _ in range(2):
        with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
            pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(
                SPATIAL_SEED))
        single.append(decode.call_args[0][0].cpu())
    spread = divergence(single[1], single[0])
    with torch.inference_mode():
        z = single[0].cuda()
        decode_repeat = (pipe.decode(z) - pipe.decode(z)).abs().max().item()
        del z
    work = os.path.join(ROOT, "build", "spatial")
    os.makedirs(work, exist_ok=True)
    weights = os.path.join(work, "weights.pt")
    torch.save({"gae": pipe.gae.state_dict(), "unet": pipe.ddpm.eval_unet.state_dict()},
               weights)
    del pipe, cube
    torch.cuda.empty_cache()

    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(spatial_rank, SPATIAL_MESH[0] * SPATIAL_MESH[1],
                             f"file://{store}/rendezvous", args=(weights,))
    shutil.rmtree(store, ignore_errors=True)
    latents_equal = all(torch.equal(r["latent"], ranks[0]["latent"]) for r in ranks)
    cube_diff = max((r["cube"] - ranks[0]["cube"]).abs().max().item() for r in ranks)
    log(f"[{SPATIAL}] the ranks' gathered latents equal: {latents_equal}; their decoded cubes "
        f"differ by {cube_diff:.3e} at most; one process decoding the same latent twice: "
        f"{decode_repeat:.3e}")
    if not latents_equal or cube_diff > SPATIAL_RANK_TOL:
        raise AssertionError(f"[{SPATIAL}] the ranks' outputs differ: latents equal "
                             f"{latents_equal}, cubes {cube_diff:.3e} apart")
    err = divergence(ranks[0]["latent"], single[0])
    meets_jax = within(ranks[0]["latent"], single[0], SPATIAL_JAX_TOL)
    log(f"[{SPATIAL}] mesh {SPATIAL_MESH}: sharded latent chain vs single-device {err}; within "
        f"the JAX package's {SPATIAL_JAX_TOL} (not gated): {meets_jax}; two single-device "
        f"chains from the same draws differ by {spread}")
    if not within(ranks[0]["latent"], single[0], TOL_UNET):
        raise AssertionError(f"[{SPATIAL}] sharded chain vs single-device: {err}")
    report = {"mesh": SPATIAL_MESH,
              "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]},
              "launches_per_rank": [r["launches"] for r in ranks],
              "gathered_bytes_per_cube": [r["gathered_bytes"] for r in ranks],
              "sharded_vs_single": err, "within_jax_tol": meets_jax,
              "single_device_spread": spread, "ranks_cube_max_diff": cube_diff,
              "decode_repeat_max_diff": decode_repeat}
    log(f"[{SPATIAL}] bytes gathered per cube by rank {report['gathered_bytes_per_cube']}")
    return report, merged([r["calls"] for r in ranks])


@contextmanager
def latent_chunk(pipe, chunk):
    """``pipe``'s model.diffusion.latent_chunk set to ``chunk`` (None: unset)
    inside the block; the model reads it at every chain."""
    diff = pipe.ddpm.opt["model"]["diffusion"]
    saved = diff.get("latent_chunk")
    diff["latent_chunk"] = chunk
    try:
        yield
    finally:
        diff["latent_chunk"] = saved


def run_chunked():
    """pavia_x4_r3_chunked: the r3 pipeline with latent_chunk 12 on 4 seeded
    cubes, from draws made once (x_init by init_from_cond, the noise of each
    step), then the same batch unchunked from the same draws. Each a counted
    run, its cubes checked; the two latents and cubes within TOL_UNET.
    Returns both rows' reports and calls."""
    import torch

    pipe = build_pipeline(FORWARDS[R3][0], {**DIFFUSION[R3], "latent_chunk": CHUNK})
    cubes = torch.rand((CHUNK_CUBES, *CUBE[1:]),
                       generator=torch.Generator(device="cuda").manual_seed(10), device="cuda")
    with torch.inference_mode():
        cond = pipe._fold(pipe.encode(cubes))
        x_init, noise = pipe.ddpm.chain_draws(torch.Generator(device="cuda").manual_seed(11),
                                              cond)
    del cond
    if pipe.ddpm._latent_chunk(x_init.shape[0]) != CHUNK:
        raise AssertionError(f"[{CHUNKED}] {x_init.shape[0]} latents do not chunk by {CHUNK}")
    runs, outs = {}, {}
    for name, chunk in ((CHUNKED, CHUNK), (CHUNKED_WHOLE, None)):
        with latent_chunk(pipe, chunk), \
                mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
            out, calls, launches = counted_run(
                name, lambda: pipe.super_resolve(cubes, x_init=x_init, noise_seq=noise))
        check_cube(name, out, cubes.shape)
        outs[name] = (decode.call_args[0][0], out)
        runs[name] = ({"latent_chunk": chunk, "cubes": CHUNK_CUBES, "launches": launches}, calls)
    err = {what: divergence(outs[CHUNKED][i], outs[CHUNKED_WHOLE][i])
           for i, what in enumerate(("latent", "cube"))}
    log(f"[{CHUNKED}] chunked ({CHUNK_CUBES * GAE_CFG['G']} latents in chains of {CHUNK}) vs "
        f"unchunked, from the same draws: {err}")
    if not all(within(outs[CHUNKED][i], outs[CHUNKED_WHOLE][i], TOL_UNET) for i in (0, 1)):
        raise AssertionError(f"[{CHUNKED}] chunked vs unchunked: {err}")
    runs[CHUNKED][0]["chunked_vs_unchunked"] = err
    del pipe, cubes, x_init, noise, outs
    torch.cuda.empty_cache()
    return runs


def run_tiled():
    """pavia_x4_tiled: one seeded SR cube of SCENE through the r3 pipeline's
    super_resolve_tiled(TILE, OVERLAP), a counted run, every tile's output
    kept; the scene's shape, finite, in [0, 1]; the last tile against
    super_resolve of the same patch drawing from the same generator (the
    tile's own of split_generator), within TOL_UNET."""
    import torch

    from hsi_dmgasr_tpu_torch.diffusion import split_generator

    pipe = build_pipeline(FORWARDS[TILED][0], DIFFUSION[R3])
    scene = torch.rand(SCENE, generator=torch.Generator(device="cuda").manual_seed(12),
                       device="cuda")
    tiles, real = [], pipe.super_resolve

    def keep(*args, **kw):
        tiles.append(real(*args, **kw))
        return tiles[-1]

    with mock.patch.object(pipe, "super_resolve", keep):
        out, calls, launches = counted_run(TILED, lambda: pipe.super_resolve_tiled(
            scene, tile=TILE, overlap=OVERLAP,
            generator=torch.Generator(device="cuda").manual_seed(13)))
    check_cube(TILED, out[None], (1, *SCENE))
    if len(tiles) != len(TILE_ORIGINS):
        raise AssertionError(f"[{TILED}] {len(tiles)} tiles, expected {len(TILE_ORIGINS)}")
    k = len(TILE_ORIGINS) - 1
    y0, x0 = TILE_ORIGINS[k]
    gen = split_generator(torch.Generator(device="cuda").manual_seed(13), len(TILE_ORIGINS))[k]
    want = pipe.super_resolve(scene[None, y0:y0 + TILE, x0:x0 + TILE], generator=gen)
    err = divergence(tiles[k], want)
    log(f"[{TILED}] {len(tiles)} tiles of {TILE}^2 (overlap {OVERLAP}) over {SCENE}: tile {k} "
        f"at ({y0}, {x0}) vs super_resolve of its patch from the same generator: {err}")
    if not within(tiles[k], want, TOL_UNET):
        raise AssertionError(f"[{TILED}] tile {k} vs super_resolve: {err}")
    report = {"scene": SCENE, "tile": TILE, "overlap": OVERLAP, "tiles": len(tiles),
              "launches": launches, "tile_vs_super_resolve": err}
    del pipe, scene, out, tiles, want
    torch.cuda.empty_cache()
    return report, calls


def run_bench():
    """The bf16 flagship path: the port's bench built at its defaults. Each
    of its two rows, the t_start=4 cube and the full T=20 chain, a counted
    run with its cube checked; the GAE's bf16 overlap average on the card
    against the CPU's; one full-width bf16 UNet forward with the kernels
    against the same forward on their plain versions. Returns both rows'
    reports and calls."""
    import torch

    from hsi_dmgasr_tpu_torch import bench

    args = bench.parse_args([])
    model = bench.Bench(args, torch.device("cuda"))
    cube = bench.make_cube(args, model)
    runs = {}
    for name, t_start in ((BENCH, args.t_start), (BENCH_FULL, None)):
        out, calls, launches = counted_run(name, lambda: model.super_resolve(cube, 2, t_start))
        check_cube(name, out, (args.batch, model.size, model.size, model.channels))
        del out
        runs[name] = ({"t_start": t_start, "launches": launches}, calls)

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
    runs[BENCH][0]["overlap_average_vs_cpu"] = merge
    del dec, got, want, d

    # full-width bf16 UNet forward, kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        z = model.gae.encode(cube.to(model.dtype))
        cond = z.reshape(-1, *z.shape[2:])
        noise = torch.randn(cond.shape, generator=gen, device="cuda").to(model.dtype)
        x = torch.cat([cond, noise], -1)
        t = torch.full((x.shape[0], 1), 0.5, device="cuda").to(model.dtype)
        y_kernel = model.unet(x, t)
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
    log(f"[{BENCH}] full-width bf16 UNet forward (B=9, 512^2): kernels vs plain {unet_err}")
    runs[BENCH][0]["unet_forward_err"] = unet_err
    del model
    torch.cuda.empty_cache()
    return runs


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
        loss = model.compute_grads(batch, gamma=gamma, noise=noise)
        out[dev] = (float(loss), {n: p.grad.detach().cpu() for n, p in
                                  model.unet.named_parameters()})
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


def run_train(dirs, gae_ckpt):
    """The training path: configs/pavia_x4_r3.json through the port's
    driver (``stage2_driver.train``) on the scenes ``dirs`` and the stage-1
    checkpoint directory ``gae_ckpt``, TRAIN_STEPS steps then one periodic
    save, one validation and one best save. The steps launch no kernel;
    the validation is a counted run. Checks every step's loss is finite,
    the EMA after every step on a few leaves, the validation's PNGs and
    metrics, the save -> fresh DDPMModel -> load_resume round trip bit for
    bit, every weight's _version moved by one more step (else the fused
    Block's packed weights go stale) and the fused EMA UNet then against
    its plain and unfused forwards (both within TOL_UNET), and one step on
    the card against the CPU's. Returns its report and the validation's
    calls."""
    import torch

    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    root = os.path.join(ROOT, "build", TRAIN)
    shutil.rmtree(root, ignore_errors=True)
    opt = train_config(root, dirs, gae_ckpt)
    log(f"[{TRAIN}] the GAE: {gae_ckpt}, trained by {TRAIN_GAE}")
    losses, ema_errs, val = [], [], {}
    real_step, real_apply = DMGASRPipeline.train_step_from_hr, DDPMModel.apply_gradients
    real_validate = drv.validate

    def recorded_step(self, hr, **kw):
        loss = real_step(self, hr, **kw)
        losses.append(float(loss))
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
        no_launches(f"{TRAIN} steps")
        res, val["calls"], val["launches"] = counted_run(
            f"{TRAIN} validation", lambda: real_validate(*args, **kw), TRAIN)
        return res

    zero_counts()
    with mock.patch.object(DMGASRPipeline, "train_step_from_hr", recorded_step), \
            mock.patch.object(DDPMModel, "apply_gradients", checked_apply), \
            mock.patch.object(drv, "validate", counted_validate):
        pipe, results = drv.train(opt, seed=0, max_steps=TRAIN_STEPS)
    ddpm = pipe.ddpm
    log(f"[{TRAIN}] {len(losses)} steps, losses {losses}")
    if len(losses) != TRAIN_STEPS or ddpm.step != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{TRAIN}] {len(losses)} steps ({ddpm.step} updates), losses {losses}")
    if "launches" not in val:
        raise AssertionError(f"[{TRAIN}] no validation ran")
    log(f"[{TRAIN}] validation: {results['n']} scenes x {results['n_chains']} chains, MPSNR "
        f"{results['indices']['MPSNR']:.3f}, MPSNR_cc {results['indices_cc']['MPSNR']:.3f}")
    if not all(math.isfinite(v) for v in (*results["indices"].values(),
                                          *results["indices_cc"].values())):
        raise AssertionError(f"[{TRAIN}] validation metrics {results}")
    val_pngs = decoded_pngs(os.path.join(opt["path"]["results"], "1"), {
        f"{TRAIN_STEPS}_{i}_{k}.png": (VAL_HW, VAL_HW, 3)
        for i in range(1, 4) for k in ("sr", "hr", "inf", "err")})
    log(f"[{TRAIN}] the validation's {len(val_pngs)} PNGs (3 bands of sr, hr and input, the "
        f"Jet error map) decode to {VAL_HW}^2 x 3")
    if max(ema_errs) > TOL_EMA:
        raise AssertionError(f"[{TRAIN}] EMA vs its recomputation: {ema_errs}")
    log(f"[{TRAIN}] EMA vs 0.999 EMA_prev + 0.001 params on {len(ema_leaves(ddpm))} leaves, "
        f"worst per step: {max(ema_errs):.2e}")
    report = {"config": "pavia_x4_r3.json", "steps": TRAIN_STEPS, "losses": losses,
              "val_results": json.loads(json.dumps(results, default=float)),
              "ema_worst_rel_err": max(ema_errs), "launches": val["launches"]}

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
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]  # the HR crop
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
    del pipe, ddpm, unet
    torch.cuda.empty_cache()
    return report, val["calls"]


def run_train_remat(dirs, gae_ckpt):
    """train_r3_remat: train_r3's configuration with model.unet.remat off and
    on, each a fresh stage-2 pipeline from seed 0 on the GAE train_gae saved:
    one step's loss and gradients from the same HR crops and the same
    dropout generator; the remat step's within atol 1e-4, rtol 1e-3 of the
    plain step's; no kernel launched."""
    import torch

    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv

    opt = train_config(os.path.join(ROOT, "build", REMAT), dirs, gae_ckpt)
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]
    hr = torch.rand((opt["datasets"]["train"]["batch_size"], size, size, GAE_CFG["n_colors"]),
                    generator=torch.Generator(device="cuda").manual_seed(14), device="cuda")
    steps = {}
    zero_counts()
    for remat in (False, True):
        opt["model"]["unet"]["remat"] = remat
        pipe = drv.build_pipeline(opt, seed=0)
        with torch.no_grad():
            sr = pipe._degrade_fn((size, size), opt["scale"])(hr)
            batch = {"HR": pipe._fold(pipe._encode(hr)), "SR": pipe._fold(pipe._encode(sr))}
        dropout = torch.Generator(device="cuda").manual_seed(15)
        loss = pipe.ddpm.compute_grads(batch, generator=dropout)
        steps[remat] = {"loss": float(loss), "grads": {
            n: p.grad.detach().clone() for n, p in pipe.ddpm.unet.named_parameters()}}
        del pipe, batch, sr
        torch.cuda.empty_cache()
    launches = no_launches(REMAT)
    plain, remat = steps[False], steps[True]
    worst, leaves = 0.0, 0
    for n, g in plain["grads"].items():
        d = (remat["grads"][n] - g).abs()
        worst = max(worst, d.max().item())
        leaves += not bool((d <= TOL_REMAT_ABS + TOL_REMAT_REL * g.abs()).all())
    loss_err = abs(remat["loss"] - plain["loss"])
    report = {"remat_vs_plain": {"loss_plain": plain["loss"], "loss_remat": remat["loss"],
                                 "loss_abs_err": loss_err, "grad_max_abs_err": worst,
                                 "grad_leaves_outside": leaves,
                                 "grad_max_abs": max(g.abs().max().item()
                                                     for g in plain["grads"].values())},
              "launches": launches}
    log(f"[{REMAT}] remat vs plain step (same weights, crops, dropout generator): "
        f"{report['remat_vs_plain']}")
    if leaves or loss_err > TOL_REMAT_ABS + TOL_REMAT_REL * abs(plain["loss"]):
        raise AssertionError(f"[{REMAT}] remat step vs plain step: {report['remat_vs_plain']}")
    return report


def sample_opt():
    """configs/sample_ddpm_16.json at its full width, dropout 0 (so the card
    and the CPU take the same step)."""
    from hsi_dmgasr_tpu_torch.config import load

    opt = load(os.path.join(ROOT, "configs", "sample_ddpm_16.json"))
    opt["model"]["unet"]["dropout"] = 0.0
    return opt


def sample_step_against_cpu(opt, state_dict):
    """One train step of the ddpm variant on SAMPLE_BATCH seeded HR images of
    image_size^2 x 3 ({"HR": x, "SR": None}), with injected t and noise, on
    the card and on the CPU from the same weights and running statistics:
    the loss (TOL_STEP_LOSS), every gradient (TOL_STEP_GRAD of the largest
    |g|), and the BatchNorm running statistics after the step (moved, and
    within TOL_STEP_STATS of the CPU's)."""
    import torch

    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    size = opt["model"]["diffusion"]["image_size"]
    gen = torch.Generator().manual_seed(13)
    batch = {"HR": torch.randn((SAMPLE_BATCH, size, size, 3), generator=gen), "SR": None}
    t = torch.randint(0, opt["model"]["beta_schedule"]["train"]["n_timestep"],
                      (SAMPLE_BATCH,), generator=gen)
    noise = torch.randn(batch["HR"].shape, generator=gen)
    before = {n: b.clone() for n, b in state_dict.items() if "running_" in n}
    out = {}
    for dev in ("cpu", "cuda"):
        model = DDPMModel(opt, device=dev)
        model.unet.load_state_dict(state_dict)
        loss = float(model.compute_grads(batch, t=t, noise=noise))
        grads = {n: p.grad.detach().cpu() for n, p in model.unet.named_parameters()}
        model.apply_gradients()
        stats = {n: b.detach().cpu() for n, b in model.unet.named_buffers() if n in before}
        out[dev] = (loss, grads, stats)
        del model
    (loss_cpu, g_cpu, s_cpu), (loss_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    res = {"loss_cpu": loss_cpu, "loss_card": loss_gpu,
           "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
           "grad_max_abs_err": max((g_gpu[n] - g).abs().max().item() for n, g in g_cpu.items()),
           "grad_max_abs": gmax, "stats_buffers": len(s_cpu),
           "stats_worst_rel_err": max(((s_gpu[n] - v).abs().max() / v.abs().max()).item()
                                      for n, v in s_cpu.items()),
           "stats_unmoved": sum(torch.equal(s_cpu[n], v) for n, v in before.items())}
    log(f"[{SAMPLE}] card vs CPU step: {res}")
    if (res["loss_rel_err"] > TOL_STEP_LOSS or res["grad_max_abs_err"] > TOL_STEP_GRAD * gmax
            or res["stats_worst_rel_err"] > TOL_STEP_STATS or res["stats_unmoved"]
            or not before):
        raise AssertionError(f"[{SAMPLE}] card step vs CPU step: {res}")
    return res


def run_sample():
    """Unconditional generation under configs/sample_ddpm_16.json at its full
    width on seeded orthogonal weights: one train step against the CPU's
    (sample_step_against_cpu), then DDPMModel.sample of SAMPLE_N images by
    DDIM over SAMPLE_DDIM_STEPS. Checks the samples finite and no kernel
    launch but the split attention kernel's (the unfused UNet's
    attention)."""
    import torch

    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    opt = sample_opt()
    zero_counts()
    ddpm = DDPMModel(opt, seed=0)
    report = {"config": "sample_ddpm_16.json", "card_vs_cpu_step": sample_step_against_cpu(
        opt, {k: v.cpu() for k, v in ddpm.unet.state_dict().items()})}
    opt["model"]["diffusion"].update(sampler="ddim", ddim_steps=SAMPLE_DDIM_STEPS)
    size = opt["model"]["diffusion"]["image_size"]
    out = ddpm.sample(SAMPLE_N, generator=torch.Generator(device="cuda").manual_seed(14))
    log(f"[{SAMPLE}] DDIM sample ({SAMPLE_DDIM_STEPS} steps) of {tuple(out.shape)}, range "
        f"[{out.min().item():.3f}, {out.max().item():.3f}]")
    if tuple(out.shape) != (SAMPLE_N, size, size, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{SAMPLE}] samples {tuple(out.shape)} or non-finite values")
    report["launches"] = no_launches(SAMPLE, split=None)
    del ddpm, out
    torch.cuda.empty_cache()
    return report


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
            loss = tr.compute_grads(crop[None], bands=bands).item()
            out[dev, dt] = (loss, {n: p.grad.detach().double().cpu()
                                   for n, p in tr.gae.named_parameters()})
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


def run_train_gae(dirs):
    """Stage-1 GAE training as a user runs it: ``cli.ae.main`` on the scenes
    ``dirs`` at the Pavia GAE's width (the CLI's defaults: n_subs 16,
    n_ovls 4, n_colors 102, n_feats 64, scale 4, batch 8), device-resident,
    TRAIN_GAE_STEPS steps ending on a save; then ``cli.gae_test.main`` on
    the saved directory over the 3 val scenes at 128^2. Checks no kernel
    launch, every step's loss finite, the checkpoint back into a fresh GAE
    bit for bit, one batch-1 step on the card against the CPU's with HLoss
    (f32) and with the perceptual term (f64; a seeded torchvision-layout
    VGG19), and every cube's gae_test metrics finite. Returns the report
    and the checkpoint directory."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.cli import ae, gae_test
    from hsi_dmgasr_tpu_torch.data.hs_datasets import HSTrainingData
    from hsi_dmgasr_tpu_torch.models.gae import GAE
    from hsi_dmgasr_tpu_torch.models.networks import init_weights
    from hsi_dmgasr_tpu_torch.models.vgg import VGG19
    from hsi_dmgasr_tpu_torch.train.stage1_gae import GAETrainer

    root = os.path.join(ROOT, "build", TRAIN_GAE)
    shutil.rmtree(root, ignore_errors=True)
    out = os.path.join(root, "gae")
    kw = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
    losses = []
    real_step = GAETrainer.train_step

    def recorded_step(self, hr, **step_kw):
        loss = real_step(self, hr, **step_kw)
        losses.append(float(loss))
        return loss

    argv = ["--data", dirs["mat"], "--datatype", "hsi_mat", "--device_resident",
            "--n_subs", str(kw["n_subs"]), "--n_ovls", str(kw["n_ovls"]),
            "--n_colors", str(kw["n_colors"]), "--n_feats", str(kw["n_feats"]), "--scale", "4",
            "--batch_size", str(TRAIN_GAE_BATCH), "--epochs", str(TRAIN_GAE_EPOCHS),
            "--max_steps", str(TRAIN_GAE_STEPS), "--out", out]
    log(f"[{TRAIN_GAE}] python -m hsi_dmgasr_tpu_torch.cli.ae {' '.join(argv)}")
    zero_counts()
    with mock.patch.object(GAETrainer, "train_step", recorded_step):
        trainer = ae.main(argv)
    launches = no_launches(TRAIN_GAE)
    log(f"[{TRAIN_GAE}] {len(losses)} steps, losses {losses}")
    if len(losses) != TRAIN_GAE_STEPS or trainer.step != TRAIN_GAE_STEPS \
            or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{TRAIN_GAE}] {len(losses)} steps ({trainer.step} updates), "
                             f"losses {losses}")
    report = {"cli": "cli.ae " + " ".join(argv[2:]), "steps": TRAIN_GAE_STEPS,
              "losses": losses, "launches": launches}

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
    del fresh, live, trainer

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
    del vgg

    # gae_test on the saved directory: every cube's metrics finite
    cubes = []
    real_qa = gae_test.quality_assessment

    def recorded_qa(*a, **k):
        cubes.append(real_qa(*a, **k))
        return cubes[-1]

    with mock.patch.object(gae_test, "quality_assessment", recorded_qa):
        avg = gae_test.main(["--ckpt", out, "--data", dirs["npy"], "--gt_size", str(VAL_HW),
                             "--scale", "4"])
    if len(cubes) != 3 or not all(math.isfinite(v) for qa in cubes for v in qa.values()):
        raise AssertionError(f"[{TRAIN_GAE}] gae_test metrics {cubes}")
    report["gae_test"] = json.loads(json.dumps({"averaged": avg, "cubes": cubes}, default=float))
    log(f"[{TRAIN_GAE}] gae_test: {len(cubes)} cubes of {VAL_HW}^2 x {kw['n_colors']}, "
        f"averaged {avg}")
    torch.cuda.empty_cache()
    return report, out


# ------------------------------------------------------------ the CLIs


def make_faces(root):
    """FACES seeded face-like images in the LRHR 'img' layout under root:
    hr_128/ (smooth colour fields plus noise) and sr_16_128/ (each HR image
    area-averaged to 16^2 and bicubic-upsampled back), written as PNGs by
    the port's own writer. Returns root."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hsi_dmgasr_tpu_torch.evalhsi.png import write_png

    rng = np.random.RandomState(1)
    for d in ("hr_128", "sr_16_128"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(FACES):
        field = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32))
        hr = F.interpolate(field, size=(128, 128), mode="bicubic", align_corners=False)
        noise = torch.from_numpy(rng.randn(1, 3, 128, 128).astype(np.float32))
        hr = (hr + 0.05 * noise).clamp(0, 1)
        sr = F.interpolate(F.adaptive_avg_pool2d(hr, 16), size=(128, 128), mode="bicubic",
                           align_corners=False).clamp(0, 1)
        for d, img in (("hr_128", hr), ("sr_16_128", sr)):
            arr = (img[0].permute(1, 2, 0).numpy() * 255).round().astype(np.uint8)
            write_png(os.path.join(root, d, f"{i:05d}.png"), arr)
    return root


def cli_config(root, name, source, faces, edit):
    """configs/<source> as JSON under root (``edit`` changes the dict), its
    datasets on ``faces``; returns the path."""
    from hsi_dmgasr_tpu_torch.config import load_json_with_comments

    cfg = load_json_with_comments(os.path.join(ROOT, "configs", source))
    for split in ("train", "val"):
        cfg["datasets"][split]["dataroot"] = faces
    edit(cfg)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def decoded_pngs(results, shapes):
    """Each PNG under ``results`` decoded by the port's reader; the names
    must be ``shapes``'s and each decode to its (H, W, C)."""
    from hsi_dmgasr_tpu_torch.evalhsi.png import decode_png

    found = {}
    for name in sorted(n for n in os.listdir(results) if n.endswith(".png")):
        with open(os.path.join(results, name), "rb") as f:
            found[name] = decode_png(f.read()).shape
    if found != shapes:
        raise AssertionError(f"{results}: PNGs {found}, expected {shapes}")
    return found


def process_frames(steps):
    """The frames a chain of ``steps`` steps keeps, and the (H, W, 3) of
    their process grid of 128^2 images."""
    frames = 1 + len([t for t in range(steps) if t % (1 | (steps // 10)) == 0])
    return frames, (int(math.sqrt(frames)) * 128,
                    math.ceil(frames / int(math.sqrt(frames))) * 128, 3)


def run_infer(faces):
    """SR3 inference as a user runs it: ``cli.infer.main`` on
    configs/sr_sr3_16_128.json at full width with ``model.unet.fuse`` on and
    ``--process_mode grid``, on the card, over the first INFER_IMAGES
    images of ``faces``; the val schedule cut to INFER_T steps. A counted
    run, each image's chain with its own fused launches. Checks every
    written PNG decodes to its shape, each chain's output finite, one
    full-width B=1 forward and the first INFER_REPLAY steps of the chain
    (replayed from one seeded x_init and noise) with the kernels against
    their plain versions (TOL_UNET), and cli.eval's PSNR/SSIM over the
    written pairs finite."""
    import contextlib
    import io

    import torch

    from hsi_dmgasr_tpu_torch.cli import eval as eval_cli
    from hsi_dmgasr_tpu_torch.cli import infer
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    root = os.path.join(ROOT, "build", INFER)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def edit(cfg):
        cfg["model"]["unet"]["fuse"] = True
        cfg["model"]["beta_schedule"]["val"]["n_timestep"] = INFER_T
        cfg["datasets"]["val"]["data_len"] = INFER_IMAGES

    cfg = cli_config(root, INFER, "sr_sr3_16_128.json", faces, edit)
    argv = ["-c", cfg, "-p", "val", "--process_mode", "grid", "--experiments_root",
            os.path.join(root, "exp")]
    log(f"[{INFER}] python -m hsi_dmgasr_tpu_torch.cli.infer {' '.join(argv)}")
    images, models = [], []
    real_sr = DDPMModel.super_resolution

    def per_image(self, cond, *a, **kw):
        n0 = fc.LAUNCHES
        out = real_sr(self, cond, *a, **kw)
        images.append({"launches": fc.LAUNCHES - n0, "shape": tuple(out.shape),
                       "finite": bool(torch.isfinite(out).all())})
        models.append(self)
        return out

    zero_counts()
    with recording() as calls, mock.patch.object(DDPMModel, "super_resolution", per_image):
        infer.main(argv)
    torch.cuda.synchronize()
    launches = check_launches(INFER, expected_launches(INFER, INFER_IMAGES), calls)
    per = sum(expected_launches(INFER)["fused"].values())
    frames, grid = process_frames(INFER_T)
    if len(images) != INFER_IMAGES or any(im["launches"] != per for im in images):
        raise AssertionError(f"[{INFER}] fused launches per image "
                             f"{[im['launches'] for im in images]}, expected {per} each")
    if any(not im["finite"] or im["shape"] != (frames, 128, 128, 3) for im in images):
        raise AssertionError(f"[{INFER}] chain outputs {images}")
    results = os.path.join(root, "exp", "results")
    decoded_pngs(results, {f"{i}_{n}.png": (grid if n == "sr_process" else (128, 128, 3))
                           for i in range(INFER_IMAGES)
                           for n in ("sr", "hr", "inf", "sr_process")})
    log(f"[{INFER}] {INFER_IMAGES} images of {INFER_T} B=1 UNet forwards, {per} fused launches "
        f"each; the PNGs and process grids decode")

    model = models[0]
    unet, d = model.eval_unet, model.val_diffusion
    gen = torch.Generator(device="cuda").manual_seed(15)
    with torch.inference_mode():
        cond = torch.rand((1, 128, 128, 3), generator=gen, device="cuda") * 2 - 1
        x = torch.cat([cond, torch.randn(cond.shape, generator=gen, device="cuda")], -1)
        t = torch.full((1, 1), 0.5, device="cuda")
        unet_err = check_unet(INFER, unet, x, t)
        x_init = torch.randn(cond.shape, generator=gen, device="cuda")
        noise = torch.randn((INFER_REPLAY,) + tuple(cond.shape), generator=gen, device="cuda")

        def replay():
            y = x_init
            for i, step in enumerate(range(INFER_T - 1, INFER_T - 1 - INFER_REPLAY, -1)):
                y = d._step(model._denoise, y, step, cond, noise=noise[i])
            return y

        got = replay()
        with plain_kernels():
            plain = replay()
    chain_err = divergence(got, plain)
    log(f"[{INFER}] full-width UNet forward (B=1, 128^2): kernels vs plain {unet_err}; the "
        f"chain's first {INFER_REPLAY} steps from one x_init and noise: {chain_err}")
    if not within(got, plain, TOL_UNET):
        raise AssertionError(f"[{INFER}] replayed steps with the kernels vs plain: {chain_err}")
    del got, plain, noise

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_cli.main(["-p", results])
    metrics = {k: float(v) for k, v in re.findall(r"# Validation # (PSNR|SSIM): (\S+)",
                                                  out.getvalue())}
    log(f"[{INFER}] cli.eval over the written pairs: {metrics}")
    if sorted(metrics) != ["PSNR", "SSIM"] or not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"[{INFER}] cli.eval printed {out.getvalue()!r}")
    report = {"config": "sr_sr3_16_128.json", "n_timestep": INFER_T, "images": INFER_IMAGES,
              "launches": launches, "unet_forward_err": unet_err,
              "replayed_steps_err": chain_err, "eval": metrics}
    del models, model, unet
    torch.cuda.empty_cache()
    return report, calls


def run_sample_cli(faces):
    """Unconditional generation as a user runs it: ``cli.sample.main`` on
    configs/sample_ddpm_16.json at full width, both schedules cut to
    SAMPLE_CLI_T steps: ``-p train`` for SAMPLE_CLI_STEPS steps of the
    FACES images (print every 2, a checkpoint and a sample at the last),
    then ``-p val`` resuming that checkpoint through --resume
    (path.resume_state), one process grid and one final. Checks the files,
    that the val phase resumed the trained step, and no kernel launch but
    the split attention kernel's."""
    import torch

    from hsi_dmgasr_tpu_torch.cli import sample
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    root = os.path.join(ROOT, "build", SAMPLE_CLI)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def edit(cfg):
        for phase in ("train", "val"):
            cfg["model"]["beta_schedule"][phase]["n_timestep"] = SAMPLE_CLI_T
        cfg["train"].update(n_iter=SAMPLE_CLI_STEPS, print_freq=2,
                            save_checkpoint_freq=SAMPLE_CLI_STEPS, val_freq=SAMPLE_CLI_STEPS)
        cfg["datasets"]["val"]["data_len"] = 1

    cfg = cli_config(root, SAMPLE_CLI, "sample_ddpm_16.json", faces, edit)
    models = []
    real = DDPMModel.sample

    def recorded(self, *a, **kw):
        models.append(self)
        return real(self, *a, **kw)

    zero_counts()
    ckpt = os.path.join(root, "train", "checkpoint", f"I{SAMPLE_CLI_STEPS}_E0")
    with mock.patch.object(DDPMModel, "sample", recorded):
        for phase, extra in (("train", []), ("val", ["--resume", ckpt])):
            argv = ["-c", cfg, "-p", phase, "--experiments_root", os.path.join(root, phase)]
            log(f"[{SAMPLE_CLI}] python -m hsi_dmgasr_tpu_torch.cli.sample "
                f"{' '.join(argv + extra)}")
            sample.main(argv + extra)
    torch.cuda.synchronize()
    launches = no_launches(SAMPLE_CLI, split=None)
    if not os.path.exists(os.path.join(ckpt, "state.pt")):
        raise AssertionError(f"[{SAMPLE_CLI}] no checkpoint {ckpt}")
    resumed = models[-1]
    if (resumed.begin_step, resumed.step) != (SAMPLE_CLI_STEPS, SAMPLE_CLI_STEPS):
        raise AssertionError(f"[{SAMPLE_CLI}] the val phase resumed at "
                             f"{(resumed.begin_step, resumed.step)}")
    decoded_pngs(os.path.join(root, "train", "results"),
                 {f"{SAMPLE_CLI_STEPS}_sample.png": (128, 128, 3)})
    decoded_pngs(os.path.join(root, "val", "results"),
                 {"0_sample_process.png": process_frames(SAMPLE_CLI_T)[1],
                  "sample_0.png": (128, 128, 3)})
    log(f"[{SAMPLE_CLI}] kernel launches {launches}; the val phase resumed step "
        f"{resumed.step}; the PNGs decode")
    del models, resumed
    torch.cuda.empty_cache()
    return {"config": "sample_ddpm_16.json", "n_timestep": SAMPLE_CLI_T,
            "steps": SAMPLE_CLI_STEPS, "launches": launches}


def check_color_correction():
    """color_correction_torch on the card against the numpy
    color_correction on one seeded 128^2 x 102 cube pair, atol TOL_COLOR.
    The numpy reference runs on the cubes widened to f64: its own f32
    means and stds, summed in order over 16384 pixels, are 5e-6 from
    exact on these cubes (on the CPU), half the tolerance. The f32 numpy
    result's distance is reported beside it."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.evalhsi.metrics import color_correction
    from hsi_dmgasr_tpu_torch.evalhsi.torch_metrics import color_correction_torch

    rng = np.random.RandomState(16)
    gt = rng.rand(VAL_HW, VAL_HW, GAE_CFG["n_colors"]).astype(np.float32)
    y = (0.7 * gt + 0.2 * rng.rand(*gt.shape) + 0.05).astype(np.float32)
    got = color_correction_torch(torch.from_numpy(gt).cuda(), torch.from_numpy(y).cuda())
    got = got.cpu().numpy()
    err = float(np.abs(got - color_correction(gt.astype(np.float64), y.astype(np.float64),
                                              gt.shape[-1])).max())
    err_f32 = float(np.abs(got - color_correction(gt, y, gt.shape[-1])).max())
    log(f"color_correction_torch on the card vs numpy ({VAL_HW}^2 x {GAE_CFG['n_colors']}): "
        f"max abs {err:.2e} (numpy in f64), {err_f32:.2e} (numpy in f32)")
    if err > TOL_COLOR:
        raise AssertionError(f"color_correction_torch vs numpy: {err}")
    return {"max_abs": err, "max_abs_vs_numpy_f32": err_f32}


def run_probe():
    """The int8 probe's main path: the counts set to 0, the probe run once,
    the exact counts read. Each case and dtype makes one eager warm-up
    link and captures CHAIN links, which the Python counts see; the card
    runs the warm-up link and the captured links once per input. Both
    paths' int8 chains sum exactly, so their last links' sums must agree
    exactly after CHAIN links."""
    import torch

    from hsi_dmgasr_tpu_torch.tools import microbench_int8 as mb

    zero_counts()
    rows = mb.probe(torch.device("cuda"))
    torch.cuda.synchronize()
    got = counted()[1]
    want = {FUSED: 0, FLASH: 0, SPLIT: 0, UP2: 0,
            DOT: len(mb.CASES) * len(mb.DTYPES) * (1 + mb.CHAIN)}
    if got != want:
        raise AssertionError(f"[{PROBE}] {got} counted launches, expected {want}")
    per_chain = 1 + mb.N_X * mb.CHAIN
    for r in rows:
        if r["launches"] != (per_chain if r["path"] == "cuda" else 0):
            raise AssertionError(f"[{PROBE}] {r['case']} {r['path']} {r['dtype']}: "
                                 f"{r['launches']} blocked-dot launches, expected {per_chain}")
    for name, *_ in mb.CASES:
        sums = {r["path"]: r["checksum"] for r in rows if r["case"] == name and r["dtype"] == "int8"}
        if sums["cuda"] != sums["library"]:
            raise AssertionError(f"[{PROBE}] {name} int8: kernel chain sum {sums['cuda']} != "
                                 f"library chain sum {sums['library']}")
    launches = {**got, DOT: sum(r["launches"] for r in rows)}
    log(f"[{PROBE}] {launches} kernel launches ({got} counted in Python: warm-up and captured "
        "links); the int8 chains' sums equal the library's")
    return {"chain": mb.CHAIN, "launches": launches, "counted_in_python": got, "rows": rows}


# ------------------------------------------------------------ the baseline zoo


def golden_on_card(name, model_cls, prefix="sd::", kind=None, kw=None, atol=2e-5, **select):
    """A reference golden's state_dict loaded strictly into the port's
    model on the card, its forward (eval mode) against the golden output;
    returns the max abs error. ``select`` picks the golden's input and
    output keys (x, lms, y)."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict

    file = name.split(":")[0]
    g = np.load(os.path.join(ROOT, "tests", "golden", f"{file}_forward_golden.npz"))
    sd = {k.split("::", 1)[1]: g[k] for k in g.files if k.startswith(prefix)}
    model = load_state_dict(model_cls(**(kw or {})), sd).cuda().eval()

    def nhwc(key):
        a = g[key][:, 0] if g[key].ndim == 5 else g[key]
        return torch.from_numpy(np.moveaxis(a, 1, -1).copy()).cuda()

    x = nhwc(select.get("x", "x"))
    args = (x, nhwc("lms")) if kind == "x,lms" else (x, x) if kind == "x,x" else (x,)
    with torch.no_grad():
        y = model(*args).cpu().numpy()
    want = g[select.get("y", "y")]
    want = np.moveaxis(want[:, 0] if want.ndim == 5 else want, 1, -1) if want.ndim > 2 else want
    err = float(np.abs(y - want).max())
    if not np.all(np.abs(y - want) <= atol + GOLDEN_RTOL * np.abs(want)):
        raise AssertionError(f"[{name}] golden on the card: max abs err {err:.3e} "
                             f"(atol {atol}, rtol {GOLDEN_RTOL})")
    return err


def grads_against_cpu(name, run, leaves):
    """``run(device)`` -> (loss, module) on that device in f64; the loss
    within TOL_STEP_LOSS and each gradient leaf (``leaves(module)``: name ->
    tensor) within TOL_STEP_GRAD of that leaf's largest |g|, or of
    GRAD_NOISE x the largest |g| of all leaves where the leaf's is below
    that: such a gradient is 0 but for rounding (a conv's bias before a
    train-mode BatchNorm, which subtracts the batch mean), and its noise
    differs between the devices."""
    out = {}
    for dev in ("cpu", "cuda"):
        loss, module = run(dev)
        out[dev] = (loss, {n: g.detach().double().cpu() for n, g in leaves(module).items()})
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out["cpu"], out["cuda"]
    floor = GRAD_NOISE * max(g.abs().max() for g in g_cpu.values())
    worst = max(((g_gpu[n] - g).abs().max() / g.abs().max().clamp_min(floor)).item()
                for n, g in g_cpu.items())
    res = {"dtype": "float64", "loss_cpu": loss_cpu, "loss_card": loss_gpu,
           "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
           "grad_worst_leaf_rel_err": worst, "leaves": len(g_cpu),
           "leaves_at_rounding": sorted(n for n, g in g_cpu.items() if g.abs().max() < floor)}
    if res["loss_rel_err"] > TOL_STEP_LOSS or worst > TOL_STEP_GRAD:
        raise AssertionError(f"[{name}] card step vs CPU step: {res}")
    return res


def checked_metrics(name, scenes):
    """Each test scene's metrics finite where they are defined: the
    cross-correlation of a band is 0/0 where the clipped prediction is
    constant in that band, as an untrained model's often is (its output
    below 0 everywhere there). ``scenes``: (x_true, x_pred, metrics) of
    each scene. Returns the constant bands of each scene."""
    import numpy as np

    constant = []
    for x_true, x_pred, qa in scenes:
        flat = np.asarray(x_pred).reshape(-1, x_pred.shape[-1])
        bands = int((flat.max(0) == flat.min(0)).sum())
        constant.append(bands)
        undefined = {k for k, v in qa.items() if not math.isfinite(v)}
        if undefined - {"CrossCorrelation"} or (undefined and not bands):
            raise AssertionError(f"[{name}] test metrics {qa}, {bands} constant bands")
    return constant


def run_baselines(dirs):
    """The baseline zoo as a user runs it (see BASELINES above). Per model:
    every step's loss finite, the test metrics finite, the golden on the
    card, one f64 step on the card against the CPU's; CEGATSR's forward
    and its golden; no kernel launch. Returns the report."""
    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.cli import baselines as cli
    from hsi_dmgasr_tpu_torch.data.hs_datasets import HSTestData
    from hsi_dmgasr_tpu_torch.models import baselines as pb
    from hsi_dmgasr_tpu_torch.train.baseline_trainer import BaselineTrainer

    root = os.path.join(ROOT, "build", BASELINES)
    shutil.rmtree(root, ignore_errors=True)
    test_dir = os.path.join(root, "test_scene")  # 1 of make_train_data's val scenes
    os.makedirs(test_dir)
    shutil.copy(os.path.join(dirs["npy"], sorted(os.listdir(dirs["npy"]))[0]), test_dir)
    real_qa = cli.quality_assessment
    c = GAE_CFG["n_colors"]
    real_step = BaselineTrainer.train_step
    report = {"models": {}}
    zero_counts()
    for name, scale in BASELINE_MODELS:
        losses = []

        def recorded_step(self, *a, **kw):
            loss = real_step(self, *a, **kw)
            losses.append(float(loss))
            return loss

        out = os.path.join(root, name)
        common = ["--model", name, "--n_colors", str(c), "--scale", str(scale)]
        argv = ["train", *common, "--data", dirs["mat"], "--max_steps", str(BASELINE_STEPS),
                "--out", out]
        log(f"[{BASELINES}] python -m hsi_dmgasr_tpu_torch.cli.baselines {' '.join(argv)}")
        with mock.patch.object(BaselineTrainer, "train_step", recorded_step):
            trainer = cli.main(argv)
        if len(losses) != BASELINE_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"[{BASELINES}] {name}: {len(losses)} steps, losses {losses}")
        scenes = []

        def recorded_qa(x_true, x_pred, *a, **k):
            scenes.append((x_true, x_pred, real_qa(x_true, x_pred, *a, **k)))
            return scenes[-1][2]

        with mock.patch.object(cli, "quality_assessment", recorded_qa):
            qa = cli.main(["test", *common, "--data", test_dir, "--ckpt", out])
        qa = {k: float(v) for k, v in qa.items()}  # numpy scalars, for the JSON report
        if len(scenes) != 1:
            raise AssertionError(f"[{BASELINES}] {name} tested {len(scenes)} scenes")
        constant = checked_metrics(f"{BASELINES}:{name}", scenes)
        rep = {"scale": scale, "losses": losses, "test": qa, "test_constant_bands": constant,
               "params": sum(p.numel() for p in trainer.model.parameters())}
        log(f"[{BASELINES}] {name} x{scale}: {rep['params']} params, losses {losses}; test {qa} "
            f"({constant[0]} constant bands)")

        # one f64 step on the card against the CPU's, from the trained weights
        item = HSTestData(dirs["npy"], n_scale=scale, gt_size=8 * scale)[0]
        x, lms = cli.inputs(name, {k: v[None] for k, v in item.items()})
        sd = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}

        def step(dev, cfg=trainer.config, x=x, lms=lms, hr=item["HR"][None], sd=sd):
            tr = BaselineTrainer(**cfg, device=dev)
            tr.model.load_state_dict(sd)
            tr.model.double()
            return tr.compute_grads(x, hr, lms).item(), tr.model

        rep["card_vs_cpu_step"] = grads_against_cpu(
            f"{BASELINES}:{name}", step,
            lambda m: {n: p.grad for n, p in m.named_parameters()})
        cls = {"sspsr": pb.SSPSR, "gelin": pb.GELIN, "mcnet": pb.MCNet, "edsr": pb.EDSR,
               "gdrrn": pb.GDRNN}[name]
        kw, kind, atol = GOLDEN_WIDTHS[name]
        rep["golden_max_abs_err"] = golden_on_card(name, cls, kind=kind, kw=kw, atol=atol)
        log(f"[{BASELINES}] {name}: golden on the card max abs err "
            f"{rep['golden_max_abs_err']:.3e}; card vs CPU f64 step {rep['card_vs_cpu_step']}")
        report["models"][name] = rep
        del trainer
        torch.cuda.empty_cache()

    # CEGATSR: one forward at its defaults on a batch of the training size
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = pb.CEGATSR(in_feats=c).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.rand((BASELINE_BATCH, 32, 32, c), generator=gen, device="cuda")
    lms = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=4,
                                          mode="bicubic").permute(0, 2, 3, 1)
    with torch.no_grad():
        y = model(x, lms)
    if tuple(y.shape) != (BASELINE_BATCH, 128, 128, c) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"[{BASELINES}] cegatsr forward {tuple(y.shape)} or non-finite")
    item = HSTestData(dirs["npy"], n_scale=4, gt_size=32)[0]
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def forward(dev):
        m = pb.CEGATSR(in_feats=c)
        m.load_state_dict(sd)
        m = m.to(dev).double().eval()
        to = lambda a: torch.from_numpy(a[None]).to(dev, torch.float64)  # noqa: E731
        return m(to(item["LR"]), to(item["SR"])), m

    outs = {}
    for dev in ("cpu", "cuda"):
        with torch.no_grad():
            outs[dev] = forward(dev)[0].cpu()
    cpu_vs_card = divergence(outs["cuda"], outs["cpu"])
    if cpu_vs_card["max_rel"] > TOL_STEP_GRAD:
        raise AssertionError(f"[{BASELINES}] cegatsr card vs CPU forward {cpu_vs_card}")
    kw, kind, atol = GOLDEN_WIDTHS["cegatsr"]
    report["models"]["cegatsr"] = {
        "card_vs_cpu_forward_f64": cpu_vs_card,
        "golden_max_abs_err": golden_on_card("cegatsr", pb.CEGATSR, kind=kind, kw=kw, atol=atol)}
    log(f"[{BASELINES}] cegatsr (defaults: n_subs 8, n_ovls 2, out_feats 64, 3 blocks, x4) on "
        f"{BASELINE_BATCH} x 32^2 x {c}: {report['models']['cegatsr']}")
    del model, x, lms, y
    report["launches"] = no_launches(BASELINES)
    torch.cuda.empty_cache()
    return report


def make_gan_scenes(path):
    """GAN3D_SCENES seeded stacked scenes (N, 31, H, W) in the uint16 range,
    smooth spectra over blocky fields, as the ICVL .npy holds them."""
    import numpy as np

    rng = np.random.RandomState(17)
    hw = GAN3D_HW
    fields = rng.rand(GAN3D_SCENES, 6, hw // 16, hw // 16).repeat(16, 2).repeat(16, 3)
    spectra = rng.rand(6, 31)
    cube = np.einsum("nkhw,kc->nchw", fields, spectra) / 6 + 0.05 * rng.rand(
        GAN3D_SCENES, 31, hw, hw)
    np.save(path, (cube * (2 ** 16 - 1)).astype(np.float32))
    return path


def run_gan3d():
    """The 3-D GAN as a user trains it (see GAN3D above). Checks no kernel
    launch, every step's losses finite, both goldens on the card, the
    checkpoint back bit for bit, and one D step then one G step on the card
    against the CPU's in f64 (both losses, every gradient of both nets
    within TOL_STEP_GRAD of its leaf's largest, D's running statistics
    within TOL_STEP_STATS). Returns the report."""
    import torch

    from hsi_dmgasr_tpu_torch.cli import gan_train
    from hsi_dmgasr_tpu_torch.data.scenes import ICVLTiles
    from hsi_dmgasr_tpu_torch.models import baselines as pb
    from hsi_dmgasr_tpu_torch.train.gan_trainer import GAN3DTrainer

    root = os.path.join(ROOT, "build", GAN3D)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data = make_gan_scenes(os.path.join(root, "scenes.npy"))
    out = os.path.join(root, "gan3d")
    losses = []
    real_step = GAN3DTrainer.train_step

    def recorded_step(self, *a, **kw):
        g_loss, d_loss = real_step(self, *a, **kw)
        losses.append((float(g_loss), float(d_loss)))
        return g_loss, d_loss

    argv = ["--data", data, "--max_steps", str(GAN3D_STEPS), "--out", out]
    log(f"[{GAN3D}] python -m hsi_dmgasr_tpu_torch.cli.gan_train {' '.join(argv)}")
    zero_counts()
    with mock.patch.object(GAN3DTrainer, "train_step", recorded_step):
        trainer = gan_train.main(argv)
    launches = no_launches(GAN3D)
    if len(losses) != GAN3D_STEPS or not all(math.isfinite(v) for st in losses for v in st):
        raise AssertionError(f"[{GAN3D}] steps (g, d) {losses}")
    fresh = GAN3DTrainer(seed=5, device="cuda")
    fresh.load(out)
    for a, b in ((trainer.G, fresh.G), (trainer.D, fresh.D)):
        if not all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items()):
            raise AssertionError(f"[{GAN3D}] {out} did not load back bit for bit")
    report = {"cli": "cli.gan_train " + " ".join(argv), "launches": launches, "losses": losses}
    log(f"[{GAN3D}] {GAN3D_STEPS} steps (g, d) {losses}; the checkpoint back bit for bit")

    report["golden_max_abs_err"] = {
        "G": golden_on_card("gan3d:G", pb.GAN3DGenerator, "gsd::", kw={"n_bands": 31},
                            x="g_x", y="g_y"),
        "D": golden_on_card("gan3d:D", pb.GAN3DDiscriminator, "dsd::", x="d_x", y="d_y")}

    # one D step then one G step, f64, card against CPU, from the trained nets
    lr_cube, hr = ICVLTiles(data, s=4, fis=36)[0]
    g_sd = {k: v.detach().cpu() for k, v in trainer.G.state_dict().items()}
    d_sd = {k: v.detach().cpu() for k, v in trainer.D.state_dict().items()}
    stats, g_losses = {}, {}

    def step(dev):
        """The D step's loss is returned (and held by grads_against_cpu); the
        G step's loss and D's running statistics are kept for below."""
        tr = GAN3DTrainer(device=dev)
        tr.G.load_state_dict(g_sd)
        tr.D.load_state_dict(d_sd)
        tr.G.double()
        tr.D.double()
        g_loss, d_loss = tr.train_step(lr_cube[None], hr[None])
        g_losses[dev] = g_loss.item()
        stats[dev] = {k: v.detach().double().cpu() for k, v in tr.D.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}
        return d_loss.item(), tr

    res = grads_against_cpu(
        GAN3D, step, lambda tr: {**{f"G.{n}": p.grad for n, p in tr.G.named_parameters()},
                                 **{f"D.{n}": p.grad for n, p in tr.D.named_parameters()}})
    res["g_loss_rel_err"] = abs(g_losses["cuda"] - g_losses["cpu"]) / abs(g_losses["cpu"])
    res["running_stats_worst_rel_err"] = max(
        ((stats["cuda"][k] - v).abs().max() / v.abs().max()).item()
        for k, v in stats["cpu"].items())
    report["card_vs_cpu_step"] = res
    if res["g_loss_rel_err"] > TOL_STEP_LOSS or res["running_stats_worst_rel_err"] > TOL_STEP_STATS:
        raise AssertionError(f"[{GAN3D}] the G step's loss or D's running statistics, card vs "
                             f"CPU: {res}")
    log(f"[{GAN3D}] goldens on the card {report['golden_max_abs_err']}; card vs CPU f64 "
        f"D + G step (36^2 HR tile) {report['card_vs_cpu_step']}")
    del trainer, fresh
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------- DAQ quantization, refiners


def run_daq_refiners():
    """daq_refiners (see DAQ above): for each module, its forward on the
    card (f32; the DAQ blocks on the first DAQ_HELD crops in f64, where no
    statistic lands on a rounding boundary by chance) against the CPU's,
    and one f64 step on the card against the CPU's (grads_against_cpu).
    After: no kernel launched but the split attention kernel, as often as
    the router sent the recorded attention calls there. Returns the report
    and the recorded calls."""
    import torch

    from hsi_dmgasr_tpu_torch.models import refiners
    from hsi_dmgasr_tpu_torch.ops import quantize

    report = {}
    gen = torch.Generator().manual_seed(51)

    def seeded(ctor):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(52)
            return ctor()

    def codebook_loss(out):
        z_q, _, loss = out
        return z_q.sum() + loss

    def held(name, ctor, inputs, f64_inputs, out_of, train=False):
        """The module's forward card vs CPU and its f64 step card vs CPU."""
        model = seeded(ctor)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        dtype = torch.float64 if f64_inputs is not None else torch.float32
        x_held = f64_inputs if f64_inputs is not None else inputs
        outs = {}
        for dev in ("cpu", "cuda"):
            m = seeded(ctor).to(dev, dtype).train(train)
            m.load_state_dict(sd)
            with torch.no_grad():
                outs[dev] = out_of(m(*(a.to(dev, dtype if a.is_floating_point() else a.dtype)
                                       for a in x_held))).cpu()
        d = (outs["cuda"] - outs["cpu"]).abs()  # in the forward's own dtype
        err = {"max_abs": d.max().item(), "max_rel": (d.max() / outs["cpu"].abs().max()).item()}
        tol = 1e-9 if dtype == torch.float64 else TOL_STEP_LOSS
        if err["max_rel"] > tol:
            raise AssertionError(f"[{DAQ}] {name} forward card vs CPU: {err}")

        def step(dev):
            m = seeded(ctor).to(dev, torch.float64).train(train)
            m.load_state_dict(sd)
            small = tuple((a[:2, :64, :64] if a.dim() == 4 else a[:2]).to(
                dev, torch.float64 if a.is_floating_point() else a.dtype) for a in inputs)
            loss = out_of(m(*small)).pow(2).mean() if not isinstance(m, refiners.Codebook) \
                else codebook_loss(m(*small))
            loss.backward()
            return loss.item(), m

        step_err = grads_against_cpu(f"{DAQ}:{name}", step,
                                     lambda m: {n: p.grad for n, p in m.named_parameters()})
        report[name] = {"forward_card_vs_cpu": err, "forward_dtype": str(dtype),
                        "card_vs_cpu_step": step_err, "input": [list(a.shape) for a in inputs]}
        log(f"[{DAQ}] {name} on {[tuple(a.shape) for a in inputs]}: forward card vs CPU "
            f"({dtype}) {err}; f64 step {step_err}")
        torch.cuda.empty_cache()

    zero_counts()
    with recording() as calls:
        crops = torch.randn((DAQ_CROPS, DAQ_HW, DAQ_HW, DAQ_FEATS), generator=gen)
        for bits in DAQ_BITS:
            for kind, ctor in (("ResBlockDAQ", quantize.ResBlockDAQ),
                               ("SSBDAQ", lambda n, **k: quantize.SSBDAQ(n, **k)),
                               ("ResAttentionBlockDAQ", quantize.ResAttentionBlockDAQ)):
                held(f"{kind}:a{bits}w{bits}",
                     lambda ctor=ctor, bits=bits: ctor(DAQ_FEATS, a_bit=bits, w_bit=bits),
                     (crops,), (crops[:DAQ_HELD],), lambda y: y)
        cube = torch.rand((1, 512, 512, 102), generator=gen)
        held("AttentionNet", lambda: refiners.AttentionNet(n_colors=102, n_feats=64), (cube,), None,
             lambda y: y)
        pu_x = torch.rand((4, 128, 128, 102), generator=gen)
        pu_t = torch.randint(0, 2000, (4,), generator=gen, dtype=torch.int32)
        held("post_unet", lambda: refiners.post_unet(102, 102), (pu_x, pu_t), None, lambda y: y,
             train=True)
        z = torch.randn((16, 8, 8, 512), generator=gen)
        # the codebook's indices card vs CPU in f64: an f32 distance may tie
        model = seeded(lambda: refiners.Codebook(4096, 512))
        idx = {dev: model.to(dev, torch.float64)(z.to(dev, torch.float64))[1].cpu()
               for dev in ("cpu", "cuda")}
        if not torch.equal(idx["cpu"], idx["cuda"]):
            raise AssertionError(f"[{DAQ}] Codebook indices differ card vs CPU")
        held("Codebook", lambda: refiners.Codebook(4096, 512), (z,), (z,), lambda y: y[0])
        report["Codebook"]["indices_equal_f64"] = True
    routes = check_routes(DAQ, calls)
    report["launches"] = no_launches(DAQ, routes["split"])
    log(f"[{DAQ}] attention routes {routes}, kernel launches {report['launches']}")
    return report, calls


# ---------------------------------------------------- data-parallel ranks


def r3_dp_rank(rank, device, weights, seed):
    """One rank of pavia_x4_r3_dp: the r3 pipeline on the parent's weights
    with a 'data' mesh over the two ranks, one counted cube (9 latents
    wrap-padded to 10, this rank's 5), the gathered latent caught at the
    decode. Returns its launches, calls, bytes gathered and latent."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy

    use_f32_policy()
    torch.cuda.set_device(device)
    pipe = build_pipeline(FORWARDS[R3_DP][0], DIFFUSION[R3], n_devices=2)
    mesh = pipe.ddpm.mesh
    state = torch.load(weights, map_location=device)
    pipe.gae.load_state_dict(state["gae"])
    pipe.ddpm.eval_unet.load_state_dict(state["unet"])
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out, calls, launches = counted_run(
            f"{R3_DP}:rank{rank}", lambda: pipe.super_resolve(cube, generator=torch.Generator(
                device="cuda").manual_seed(seed)), R3_DP)
    check_cube(R3_DP, out, CUBE)
    batches = sorted({sig[0][0] for sig in calls[FUSED]})
    if batches != [5]:
        raise AssertionError(f"[{R3_DP}] rank {rank} launched at batch sizes {batches}, "
                             "expected 5 (9 latents wrap-padded to 10 over 2 ranks)")
    return {"mesh": mesh.n_data, "launches": launches, "calls": calls,
            "gathered_bytes": dict(mesh.gathered), "latent": decode.call_args[0][0].cpu()}


def run_r3_dp():
    """pavia_x4_r3_dp: the r3 pipeline's single-process cube (its latent
    caught at the decode), its weights saved; then two ranks on the one card
    (multihost.launch over gloo, a file:// store), each checked for its
    counts; the ranks' gathered latents equal; the data-parallel latent
    against the single-process one within TOL_UNET. Returns its report and
    its ranks' calls, summed."""
    import tempfile

    import torch

    from hsi_dmgasr_tpu_torch.parallel import multihost

    pipe = build_pipeline(FORWARDS[R3_DP][0], DIFFUSION[R3])
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(R3_DP_SEED))
    single = decode.call_args[0][0].cpu()
    work = os.path.join(ROOT, "build", R3_DP)
    os.makedirs(work, exist_ok=True)
    weights = os.path.join(work, "weights.pt")
    torch.save({"gae": pipe.gae.state_dict(), "unet": pipe.ddpm.eval_unet.state_dict()}, weights)
    del pipe, cube
    torch.cuda.empty_cache()

    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(r3_dp_rank, 2, f"file://{store}/rendezvous",
                             args=(weights, R3_DP_SEED))
    shutil.rmtree(store, ignore_errors=True)
    if [r["mesh"] for r in ranks] != [2, 2]:
        raise AssertionError(f"[{R3_DP}] the ranks' meshes: {[r['mesh'] for r in ranks]}")
    latents_equal = torch.equal(ranks[0]["latent"], ranks[1]["latent"])
    err = divergence(ranks[0]["latent"], single)
    log(f"[{R3_DP}] the ranks' gathered latents equal: {latents_equal}; the data-parallel "
        f"latent vs the single process's from the same draws: {err} (TOL_UNET {TOL_UNET})")
    if not latents_equal or not within(ranks[0]["latent"], single, TOL_UNET):
        raise AssertionError(f"[{R3_DP}] latents equal {latents_equal}, vs single {err}")
    report = {"launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]},
              "launches_per_rank": [r["launches"] for r in ranks],
              "gathered_bytes_per_cube": [r["gathered_bytes"] for r in ranks],
              "dp_vs_single": err}
    log(f"[{R3_DP}] bytes gathered {report['gathered_bytes_per_cube']}")
    return report, merged([r["calls"] for r in ranks])


def _state_digest(tensors):
    """SHA-256 of every tensor's bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_state(ddpm):
    """{name: tensor} of a DDPMModel's weights, EMA and Adam state."""
    out = {f"unet.{k}": v for k, v in ddpm.unet.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in ddpm.ema.state_dict().items()})
    for i, st in ddpm.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def train_dp_steps(opt, state, hr_seed, device):
    """TRAIN_DP_STEPS steps of the train_r3 pipeline from ``state`` (weights
    and the GAE), each on TRAIN_DP_CROPS HR crops drawn from ``hr_seed``.
    Returns the pipeline, losses and the first step's gradients (on the
    CPU)."""
    import torch

    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv

    pipe = drv.build_pipeline(opt, seed=0, device=device)
    pipe.ddpm.unet.load_state_dict(state)
    gen = torch.Generator(device="cuda").manual_seed(hr_seed)
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]
    losses, grads = [], None
    for _ in range(TRAIN_DP_STEPS):
        hr = torch.rand((TRAIN_DP_CROPS, size, size, GAE_CFG["n_colors"]), generator=gen,
                        device="cuda")
        losses.append(float(pipe.train_step_from_hr(hr, scale=opt["scale"])))
        if grads is None:  # the step leaves its (all-reduced) gradients in place
            grads = {n: p.grad.detach().cpu() for n, p in pipe.ddpm.unet.named_parameters()}
    return pipe, losses, grads


def train_dp_rank(rank, device, opt, weights, one_rank):
    """One rank of train_r3_dp: TRAIN_DP_STEPS steps from the parent's
    weights with a 'data' mesh over the two ranks (18 of the 36 latents a
    step), then its state against the one-rank run's (rank 0) and its
    digest, and one counted validation cube under the fused Blocks (its 9
    latents padded to 10, B=5 a rank)."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.parallel.multihost import synchronize

    use_f32_policy()
    torch.cuda.set_device(device)
    zero_counts()
    pipe, losses, grads = train_dp_steps(opt, torch.load(weights, map_location=device),
                                         TRAIN_DP_SEED, device)
    ddpm = pipe.ddpm
    no_launches(f"{TRAIN_DP} steps")
    state = train_state(ddpm)
    worst = {}
    if rank == 0:
        want = torch.load(one_rank, map_location="cpu")
        for part in ("unet", "ema", "adam"):
            keys = [k for k in want if k.startswith(part + ".") and want[k].is_floating_point()]
            worst[part] = max(((state[k].detach().cpu().double() - want[k].double()).abs().max()
                               / want[k].double().abs().max().clamp_min(1e-30)).item()
                              for k in keys)
        # reported: Adam moves a weight by about lr a step, so where a
        # gradient near 0 takes the other sign it lands up to 2 lr a step away
        lr = opt["train"]["optimizer"]["lr"]
        d = [(state[k].detach().cpu().double() - want[k].double()).abs()
             for k in want if k.startswith("unet.") and want[k].is_floating_point()]
        worst["unet_max_abs_over_lr"] = max(x.max().item() for x in d) / lr
        worst["unet_share_off"] = sum(int((x > 0.05 * lr).sum()) for x in d) / sum(
            x.numel() for x in d)
        # the first step's all-reduced gradients against the one rank's, as
        # step_against_cpu holds a step: the worst |diff| over the largest |g|
        g_want = {k[5:]: v for k, v in want.items() if k.startswith("grad.")}
        worst["grad_max_abs_over_max_g"] = max(
            (grads[n] - g).abs().max().item() for n, g in g_want.items()) / max(
            g.abs().max().item() for g in g_want.values())
        # the share of the first gradients whose sign differs: each such
        # element moves its weight about 2 lr from the one rank's
        worst["grad_sign_flips"] = sum(int((torch.sign(grads[n]) != torch.sign(g)).sum())
                                       for n, g in g_want.items()) / sum(
            g.numel() for g in g_want.values())
        del want, d, g_want
    digest = _state_digest(state[k] for k in sorted(state))
    reduced = dict(ddpm.mesh.reduced)
    del state
    val = torch.rand((1, VAL_HW, VAL_HW, GAE_CFG["n_colors"]),
                     generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    synchronize()  # rank 0 compared its state first: start the cube together
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out, calls, launches = counted_run(
            f"{TRAIN_DP}:rank{rank}", lambda: pipe.super_resolve(val, generator=torch.Generator(
                device="cuda").manual_seed(6)), TRAIN_DP)
    check_cube(TRAIN_DP, out, tuple(val.shape))
    return {"mesh": ddpm.mesh.n_data, "losses": losses, "worst_leaf_rel_err": worst,
            "digest": digest, "reduced_bytes": reduced, "launches": launches, "calls": calls,
            "val_latent": decode.call_args[0][0].cpu()}


def run_train_r3_dp(dirs, gae_ckpt):
    """train_r3_dp (see TRAIN_DP above): the one-rank run of TRAIN_DP_STEPS
    steps from seeded weights (its final weights, EMA and Adam state saved),
    then the same steps over two ranks on the one card from the same
    weights and draws: rank 0's first gradients and state against the
    one-rank run's (the gates under TRAIN_DP above), the ranks' states
    bit for bit alike (digests), no kernel launch in the steps, and each
    rank's counted validation cube. Returns its report and the
    validation's calls, summed over the ranks."""
    import tempfile

    import torch

    from hsi_dmgasr_tpu_torch.parallel import multihost
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    work = os.path.join(ROOT, "build", TRAIN_DP)
    shutil.rmtree(work, ignore_errors=True)
    opt = train_config(work, dirs, gae_ckpt)
    opt["path"]["resume_state"] = None
    weights = os.path.join(work, "weights.pt")
    init = DDPMModel(opt, seed=3, device="cuda").unet.state_dict()
    torch.save(init, weights)
    pipe, losses, grads = train_dp_steps(opt, init, TRAIN_DP_SEED, "cuda")
    one_rank = os.path.join(work, "one_rank.pt")
    torch.save({**{k: v.detach().cpu() for k, v in train_state(pipe.ddpm).items()},
                **{f"grad.{n}": g for n, g in grads.items()}}, one_rank)
    log(f"[{TRAIN_DP}] one rank: losses {losses}")
    del pipe, init, grads
    torch.cuda.empty_cache()

    opt2 = copy.deepcopy(opt)
    opt2["n_devices"] = 2
    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(train_dp_rank, 2, f"file://{store}/rendezvous",
                             args=(opt2, weights, one_rank))
    shutil.rmtree(store, ignore_errors=True)
    for f in (weights, one_rank):
        os.remove(f)
    if [r["mesh"] for r in ranks] != [2, 2]:
        raise AssertionError(f"[{TRAIN_DP}] the ranks' meshes: {[r['mesh'] for r in ranks]}")
    alike = ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["losses"] == ranks[1]["losses"]
    worst = ranks[0]["worst_leaf_rel_err"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], losses))
    val_equal = torch.equal(ranks[0]["val_latent"], ranks[1]["val_latent"])
    log(f"[{TRAIN_DP}] the ranks' weights, EMA and Adam state bit for bit alike: {alike}; "
        f"rank 0 vs the one-rank run, worst leaf over its largest |value|: {worst}; losses "
        f"{ranks[0]['losses']} vs {losses} (worst rel {loss_err:.2e}); validation latents "
        f"alike: {val_equal}")
    off = (worst["grad_max_abs_over_max_g"] > TOL_STEP_GRAD
           or worst["unet_share_off"] > TRAIN_DP_SHARE_OFF or worst["adam"] > TOL_TRAIN_DP_ADAM)
    if not alike or not val_equal or off or loss_err > TOL_STEP_LOSS:
        raise AssertionError(f"[{TRAIN_DP}] alike {alike}, val {val_equal}, worst {worst}, "
                             f"loss {loss_err}")
    reduced = [r["reduced_bytes"].get("gradients", 0) / TRAIN_DP_STEPS for r in ranks]
    report = {"steps": TRAIN_DP_STEPS, "latents_per_step": TRAIN_DP_CROPS * 9,
              "allreduced_bytes_per_step": reduced, "worst_leaf_rel_err": worst,
              "loss_rel_err": loss_err,
              "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}}
    log(f"[{TRAIN_DP}] bytes all-reduced a step per rank {reduced}")
    return report, merged([r["calls"] for r in ranks])


# ------------------------------------------------------------ the kernels


def signatures(runs, kind):
    """{signature: {path: calls}} of one kind of recorded call over the
    paths' runs."""
    sigs = {}
    for path, (_, calls) in runs.items():
        for sig, n in calls[kind].items():
            sigs.setdefault(sig, {})[path] = n
    return sigs


def split_signatures(runs):
    """{(shape, dtype name): {path: calls}} of the recorded attention calls
    on the split kernel's route."""
    sigs = {}
    for path, (_, calls) in runs.items():
        for call, n in calls[ATTENTION].items():
            if call_route(call) == "split":
                paths = sigs.setdefault((call[0], dtype_name(call[1])), {})
                paths[path] = paths.get(path, 0) + n
    return sigs


def kernel_rows(name, check, sigs, seed):
    """``check(sig, seed)`` at each signature, logged; each row with its
    calls by path."""
    import torch

    rows = []
    for i, (sig, paths) in enumerate(sigs.items()):
        row = check(sig, seed + i)
        row["calls"] = paths
        rows.append(row)
        times = " ".join(f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms"))
        log(f"{name} {row['signature']:<44} {sum(paths.values())} calls, vs plain "
            f"{row['errors']['out']['max_abs']:.2e} | {times}")
        torch.cuda.empty_cache()
    return rows


def kernel_entry(name, source, replaces, rows, launches):
    """The kernels-line entry: the kernel's launches by path and its
    device time alone at each signature checked."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "paths": launches,
            "max_abs_err": max(r["errors"]["out"]["max_abs"] for r in rows),
            "signatures": {r["signature"]: {k: v for k, v in r.items() if k.endswith("_ms")}
                           for r in rows}}


def main():
    import torch

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
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "paths": {}}
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 1. build
    libs = build.build_all()
    log(f"built {sorted(libs)}")
    for name, (secs, out) in build.BUILD_LOG.items():
        log(f"nvcc {name}: {secs:.1f} s")
        log("\n".join(line for line in out.splitlines() if "registers" in line or "spill" in line))

    # ---- 2. the paths
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    runs = {path: run_path(path, cube) for path in DIFFUSION}
    del cube
    torch.cuda.empty_cache()
    runs[SPATIAL] = run_spatial()
    runs[R3_DP] = run_r3_dp()
    runs.update(run_bench())
    dirs = make_train_data(os.path.join(ROOT, "build", "scenes"))
    report["paths"][TRAIN_GAE], gae_ckpt = run_train_gae(dirs)
    runs[TRAIN] = run_train(dirs, gae_ckpt)
    torch.cuda.empty_cache()
    runs[TRAIN_DP] = run_train_r3_dp(dirs, gae_ckpt)
    report["paths"][SAMPLE] = run_sample()
    faces = make_faces(os.path.join(ROOT, "build", "faces"))
    runs[INFER] = run_infer(faces)
    report["paths"][SAMPLE_CLI] = run_sample_cli(faces)
    # the memory modes' large B=36 and tiled allocations after the others
    torch.cuda.empty_cache()
    runs.update(run_chunked())
    runs[TILED] = run_tiled()
    report["paths"][REMAT] = run_train_remat(dirs, gae_ckpt)
    torch.cuda.empty_cache()
    report["paths"][BASELINES] = run_baselines(dirs)
    report["paths"][GAN3D] = run_gan3d()
    torch.cuda.empty_cache()
    runs[DAQ] = run_daq_refiners()
    report["color_correction_max_abs"] = check_color_correction()
    report["paths"][PROBE] = probe = run_probe()
    for path, (path_report, _) in runs.items():
        report["paths"][path] = path_report

    # ---- 3. each kernel against its plain version, and its time alone
    report["fused_signatures"] = kernel_rows(FUSED, check_signature, dict(sorted(
        signatures(runs, FUSED).items(), key=lambda kv: -kv[0][0][1])), 100)
    flash_sigs = signatures(runs, FLASH)
    shapes = FLASH_EXTRA + tuple(shape for shape, _ in flash_sigs)
    for sig in ((shape, dt) for dt in ("f32", "bf16") for shape in shapes):
        flash_sigs.setdefault(sig, {})
    report["flash_signatures"] = kernel_rows(FLASH, check_flash, flash_sigs, 200)
    report["split_signatures"] = kernel_rows(SPLIT, check_split, dict(sorted(
        split_signatures(runs).items())), 400)
    report["up2_signatures"] = kernel_rows(UP2, check_up2, dict(sorted(
        ((sig, paths) for sig, paths in signatures(runs, UP2).items() if sig[-1] == "f32"),
        key=lambda kv: kv[0][0][:2])), 500)
    chains = {(r["case"], r["dtype"]): r["launches"] for r in probe["rows"] if r["path"] == "cuda"}
    report["dot_signatures"] = kernel_rows(DOT, lambda cd, seed: check_dot(*cd, seed), {
        (case, dt): {PROBE: chains[case[0], dt]} for case in mb.CASES for dt in ("int8", "bf16")},
        300)

    # ---- 4. golden
    report["golden_max_abs"] = golden_check()
    log(f"golden sr3 UNet on the card: max abs err {report['golden_max_abs']:.2e}")

    # ---- 5. results
    def launches(kernel, paths=(*FORWARDS, *ZOO_PATHS)):
        return {p: report["paths"][p]["launches"][kernel] for p in paths}

    entries = [
        kernel_entry(FUSED, "hsi_dmgasr_tpu_torch/csrc/fused_conv.cu",
                     "hsi_dmgasr_tpu/kernels/fused_conv.py:824", report["fused_signatures"],
                     launches(FUSED)),
        kernel_entry(FLASH, "hsi_dmgasr_tpu_torch/csrc/flash_attention.cu",
                     "hsi_dmgasr_tpu/kernels/flash_attention.py:119", report["flash_signatures"],
                     launches(FLASH)),
        kernel_entry(UP2, "hsi_dmgasr_tpu_torch/csrc/up2_conv.cu",
                     "none (hsi_dmgasr_tpu/ops/fused_up.py:up2_conv3x3 is XLA's)",
                     report["up2_signatures"], launches(UP2)),
        kernel_entry(SPLIT, "hsi_dmgasr_tpu_torch/csrc/split_attention.cu",
                     "none (hsi_dmgasr_tpu/kernels/attention.py:_xla_attention is XLA's)",
                     report["split_signatures"], launches(SPLIT)),
        kernel_entry(DOT, "hsi_dmgasr_tpu_torch/csrc/blocked_dot.cu",
                     "tools/microbench_int8.py:88", report["dot_signatures"],
                     launches(DOT, (PROBE, *ZOO_PATHS))),
    ]
    report["kernels"] = entries
    report["script_s"] = time.perf_counter() - t_script
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"script seconds: {report['script_s']:.1f}")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
