#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of DMGASR on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports only torch and hsi_dmgasr_tpu_torch,
and fails (exit code != 0, no result line) without a GPU or outside a
checkout. It drives nineteen main paths. Eight are x4 DMGASR on
Pavia-geometry cubes at full width (UNet inner 64, mults 1,2,4,8,8,
res_blocks 2, GroupNorm 32, cosine T=20; GAE n_subs 16, n_ovls 4, n_feats
64, G=9; seeded random weights), on a 512x512x102 cube unless said:

  * configs/pavia_x4_r3.json: image_size 128, the chain entered at
    t_start=4, latent affine; attention at 64^2 and 32^2 stays below the
    flash gate, on the split kernel (24 launches). f32 activations. 220
    fused-Block launches per cube.
  * pavia_x4_r3_ddim: the same config with the DDIM sampler (4 steps,
    eta 0, from noise: t_start removed, as the JAX package refuses it
    with DDIM). 220 fused-Block launches per cube; one chain from a
    seeded x_init is also run on the kernels' plain versions and held to
    the kernels' chain.
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
  * pavia_x4_r3_chunked: configs/pavia_x4_r3.json with
    model.diffusion.latent_chunk 12 on 4 cubes (the JAX README's
    throughput mode): 36 latents in 3 chains of 12, 660 fused-Block
    launches per call at B=12; then the same batch unchunked from the same
    replayed draws (its row pavia_x4_r3_chunked:unchunked, 220 launches at
    B=36), the two held to TOL_UNET, each with its seconds per cube and
    peak memory.
  * pavia_x4_tiled: one seeded 1096x715x102 SR cube (the Pavia Centre
    scene's size) through super_resolve_tiled(tile 512, overlap 32) under
    the r3 config: 6 tiles of 512^2 (origins y 0, 480, 584; x 0, 203), 1320
    fused-Block launches per scene; the last tile held to super_resolve of
    its patch from the same generator (TOL_UNET).
  * pavia_x4_spatial: configs/pavia_x4.json through super_resolve_spatial
    on a ('data', 'space') = (1, 2) mesh: two ranks spawned on the one
    card (gloo, a file:// store), each holding 256 of the 512 latent rows,
    replaying the pavia_x4 cube's draws. Each rank launches 1100 fused
    Blocks (with halo rows and the whole image's moments) and 100 flash
    attentions (on the gathered 128^2 level) per cube. Two ranks share one
    card: its times are not multi-card times.
  * pavia_x4_r3_dp: configs/pavia_x4_r3.json through super_resolve with
    a 'data' mesh over two ranks on the one card (gloo): each rank draws
    the whole batch's x_init and noise as one process does, wrap-pads the
    9 latents to 10 and runs its 5, 220 fused-Block launches per rank at
    B=5; the gathered latent against the single process's from the same
    generator (TOL_UNET). Not a multi-card time either.

The ninth to twelfth are the two training stages at the same full width,
chained as a user chains them, stage 2 with remat, and stage 2
data-parallel:

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
    launches 55 x 4 fused Blocks per (scene, chain), 1980, and writes
    each scene's PNGs (three bands of sr, hr and input, the Jet error map).
  * train_r3_remat: train_r3's configuration with model.unet.remat off and
    on, each from seed 0 on the same GAE: one step's loss and every
    gradient from the same crops and dropout generator, remat against
    plain within atol 1e-4, rtol 1e-3 (tests/test_remat.py's), then 5
    steps of each, their ms per step and peak memory. No kernel launch.
  * train_r3_dp: train_r3's step (36 latents from 4 HR crops) for 3 steps
    over two ranks on the one card (18 latents each, the gradients
    all-reduced through host memory and gloo) from the weights and draws
    of a one-rank run of the same steps: the ranks' weights, EMA and Adam
    state bit for bit alike, rank 0's held to the one-rank run's (see
    TRAIN_DP), then one validation cube of 128^2 per rank (220 fused
    launches at B=5); ms per step, peak memory and bytes all-reduced per
    rank. The steps launch no kernel.

Both train on the same 8 training scenes of 256^2 and validate on the
same 3 val scenes of 128^2, written from a seed under build/scenes.

The thirteenth is unconditional generation, the discrete-t BatchNorm DDPM
variant:

  * sample_ddpm_16: configs/sample_ddpm_16.json at its full width (inner
    64, mults 1,2,4,8,8, attn_res 16, image_size 128, linear T=2000),
    seeded orthogonal weights, dropout 0: one train step of 4 HR images
    of 128^2 x 3 on the card against the same step on the CPU (the loss,
    every gradient, the BatchNorm running statistics after it), then
    DDPMModel.sample of 2 images: the 2000-step ancestral chain when 2000
    UNet forwards take at most 30 s, else DDIM over 100 steps. Its
    Blocks are BatchNorm, so no kernel of the port runs.

The fourteenth and fifteenth are the SR3 face configs through the port's CLIs,
on 4 seeded 128^2 face-like PNGs (and their 16 -> 128 SR images) that
the port's own PNG writer puts under build/faces:

  * infer_sr3_16_128: cli.infer (--process_mode grid) on
    configs/sr_sr3_16_128.json at full width (inner 64, mults 1,2,4,8,8,
    res_blocks 2, GroupNorm 32, attn_res 16, 128^2 x 3) with
    model.unet.fuse on, over 2 images. Cut: the val schedule's 2000 steps
    to 200 (cosine), fixed. Every Block of every reverse step is the
    fused kernel: 55 x 200 = 11000 launches per image at B=1, 128^2 ...
    8^2; attention at 16^2 and in the mid block takes the split kernel.
    Then cli.eval over the written pairs.
  * sample_cli_ddpm_16: cli.sample on configs/sample_ddpm_16.json at full
    width, -p train for 4 steps of the 4 images (a checkpoint and a
    sample at step 4), then -p val resuming that checkpoint. Cut: both
    schedules' 2000 steps to 100 (linear). BatchNorm Blocks: no kernel of
    the port runs.

The sixteenth is the int8 probe (hsi_dmgasr_tpu_torch.tools.microbench_int8):

  * int8_probe: chains of 4000 dependent dots x @ w with a requantize
    step, at M = 4096 and (K, N) = (512, 512), (576, 256), (192, 256),
    int8 -> int32 and bf16 -> f32, through the library's dot and through
    the blocked-dot kernel; each chain captured in a CUDA graph and
    replayed once per input (4 inputs). 6 x (1 + 4 x 4000) = 96006
    blocked-dot launches.

The seventeenth to nineteenth are the baseline zoo and the 3-D GAN
through the port's CLIs, and DAQ quantization with the refiners, at full
width with seeded weights and scenes, TF32 off. No kernel of the port
runs on them (cuDNN convolutions): each reads 0 launches of all three
kernels.

  * baselines_x4: cli.baselines train at its defaults on Pavia's 102
    bands (the README's baseline command) for sspsr, gelin, mcnet and
    gdrrn at scale 4 and edsr at scale 2 (the reference pins it): batches
    of 16 HSTrainingData crops of 128^2 x 102 (64^2 for edsr) from the 8
    training scenes of make_train_data, with the host's MATLAB-bicubic
    degradation; SSPSR at n_feats 256 over 17 groups of 8 bands. Cut: 3
    steps each (--max_steps), then cli.baselines test on the saved
    checkpoint over 1 val scene (gt_size 64). CEGATSR, which no CLI
    trains, as one forward at its defaults on 16 x 32^2 x 102. Each
    model's reference golden state_dict loaded on the card reproduces the
    golden output (atol 2e-5, GDRRN 5e-5, rtol 1e-4); one step from the
    trained full-width weights on one item of LR 8^2 x 102 on the card
    against the CPU's, in f64 (CEGATSR: the forward); the test metrics
    finite where defined (a band's cross-correlation is 0/0 where the
    clipped prediction of a barely trained model is constant).
  * gan3d_x4: cli.gan_train at its defaults (n_bands 31, fis 144, scale
    4, batch 4) on a seeded stacked-scene .npy of 2 x 31 x 512^2 (18
    tiles). Cut: 3 steps. Both nets' goldens on the card; the checkpoint
    back bit for bit; one D step and one G step from the trained nets on
    one 36^2 tile, on the card against the CPU's in f64 (both losses,
    every gradient, D's running statistics after the step).
  * daq_refiners: ResBlockDAQ, SSBDAQ and ResAttentionBlockDAQ at n_feats
    64, a_bit = w_bit 4 and 8, on 16 crops of 128^2; AttentionNet(102, 64)
    on one 512^2 x 102 cube; post_unet(102, 102) at its defaults on 4 x
    128^2 x 102; Codebook(4096, 512) on 1024 vectors. Each forward on the
    card against the CPU's (the DAQ blocks and the codebook in f64), one
    f64 step card against CPU, ms per f32 step and peak memory. Every
    attention call is recorded and held to the router's counts: the split
    kernel runs in post_unet's f32 forward, and nowhere else in the zoo.

In order:

 1. prints the card (nvidia-smi name and power limit) and versions;
 2. builds every CUDA kernel of the port from csrc/ (one nvcc each, all
    at once) and prints the build seconds and register use;
 3. for each Pavia path and each bench row: sets the launch counts to 0,
    drives one cube while recording every launch signature of both
    kernels and every call of the up path (ops/fused_up.py:up2_conv3x3),
    checks the cube (shape, finite, in [0, 1]) and the exact launch counts
    (the up path: 4 calls a UNet forward, each f32 call a launch of its
    kernel and each bf16 one cuDNN's transposed conv, as its router counts
    them; every UNet path below is held to the same, and the spatial
    path's ranks to no call), times it (median of 3) and reads the peak
    memory; holds
    one full-width UNet forward with the kernels against the same forward
    with their plain versions (in bf16 for the bench; the f32 paths also
    report both against the unfused f32 forward). Then pavia_x4_r3_chunked
    and its unchunked reference, each with its counts to 0, recorded and
    counted, checked, timed and its peak memory read, the two held to each
    other; then pavia_x4_tiled the same way, one tile held to
    super_resolve. Then pavia_x4_spatial:
    the single-device pavia_x4 chain twice from its draws (the reference,
    and the spread of two such chains), then the two ranks, each with its
    counts to 0, one cube recorded and counted (1100 fused, 100 flash per
    rank), checked, and timed (median of 3); the ranks' cubes equal and the
    sharded latent chain within TOL_UNET of the single-device one (its
    distance against the JAX package's 1e-4 printed); peak memory per rank
    and bytes gathered per cube (halos, moments, attention, the output).
    Then pavia_x4_r3_dp: the single-process r3 cube, then the two ranks,
    each with its counts to 0, one cube recorded and counted (220 fused
    at B=5 per rank), the ranks' gathered latents equal and within
    TOL_UNET of the single process's. Then train_gae: counts
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
    step's share of its f32 roofline, seconds per validation cube. Then
    train_r3_dp: the one-rank steps, the two ranks' steps, their states
    held to each other and to the one-rank run, no launch in the steps, one
    validation cube per rank recorded and counted. Then
    train_r3_remat: counts to 0, the remat step against the plain step,
    ms per step and peak memory of each, no launch counted. Then the probe:
    counts to 0, the probe run once, the exact launch counts, and the int8
    chains of the kernel and the library held equal bit for bit after 4000
    links. Then sample_ddpm_16: counts to 0, its train step against the
    CPU's, one UNet forward timed, the sample drawn, no launch counted.
    Then infer_sr3_16_128: counts to 0, the CLI with its launch signatures
    recorded, exactly 11000 fused launches per image, every PNG decoded
    (the port's reader) to its shape, the chains finite, one B=1 UNet
    forward and the chain's first 4 steps (replayed from one x_init and
    noise) with the kernels against their plain versions (TOL_UNET),
    cli.eval's PSNR and SSIM finite; seconds per image, forwards/s, one
    forward's ms, peak memory. Then sample_cli_ddpm_16: counts to 0, both
    phases, no launch counted, the files decoded, the val phase on the
    trained step; seconds per sample, peak memory. Then, after the
    memory modes, baselines_x4 and gan3d_x4: counts to 0, the CLIs, no
    launch counted; per model ms per train step (synchronised, the host's
    data loading outside it) and the CLI's seconds, peak memory, seconds
    per test scene, the golden and card-vs-CPU checks above; then
    daq_refiners the same way. Then color_correction_torch on the card
    against the numpy version;
 4. for each recorded signature (f32 or bf16), on the card at that shape
    (B=9, B=5 for the data-parallel rows, and B=12 and B=36 for the
    chunked row, with fewer timing repeats): kernel vs its plain PyTorch version (asserted within tolerance), the
    kernel's, the plain version's and one library call's times, and the
    bound; for the fused Block also its launch alone, replayed in a CUDA
    graph, and each signature's and level's share of its bound and ratio
    to cuDNN; the flash kernel also at D=128 and at D=512 (S >= 8192) and
    at pavia_x4_r3's 64^2 attention, and at each of its shapes with bf16
    q, k and v as well, each flash shape with the prepass's and the
    attention kernel's device times (torch.profiler, which must see one
    launch of each per call) and the einsum route's time beside it; the
    split attention kernel at each f32 signature the paths recorded,
    within TOL_SPLIT of its plain version, with each phase's time, the
    plain version's and the einsum route's (daq_refiners' post_unet
    signatures too); the blocked dot at each probe case and dtype, with its share of the bound,
    TOP/s and ratio to the library call, and a 3-link captured chain
    against the same chain run eagerly; the up path's kernel at each f32
    signature recorded (the four up levels at B=9, 5, 1, 12 and 36 and at
    the validations' 128^2) against its plain version and cuDNN's f32
    transposed conv (TF32 off), each within TOL_UP2 of sum |x| |w|, with
    its time, its launch alone (a CUDA graph), the plain version's and the
    transposed conv's times and the bound;
 5. the unfused UNet against the reference torch golden
    (tests/golden/unet_diffusion_golden.npz);
 6. prints the card line, the kernels JSON line and, last, the result
    line {"ok": true, "device": {...}}.

Details go to chiprun_out/chip_smoke.json. ``--profile`` adds one traced
cube per path (the bench's t_start=4 row for bench_x4_bf16, one train
step each for train_gae and train_r3, ten UNet forwards of the sampler
for sample_ddpm_16, one image's chain for infer_sr3_16_128; none for
the chunked, tiled and remat rows): device
time by kernel name
(torch.profiler), the device's idle share and the seconds of each stage
(GAE encode, reverse chain, GAE decode; for a stage-1 step: forward +
loss, backward, Adam; for a stage-2 step: degradation, GAE encode, UNet
forward + backward, Adam + EMA), into chip_smoke_profile.json beside it.
train_gae writes its checkpoint under build/train_gae, train_r3 its
experiment directory under build/train_r3, the CLIs theirs under
build/infer_sr3_16_128 and build/sample_cli_ddpm_16, the zoo theirs under
build/baselines_x4 and build/gan3d_x4.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
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
UP2 = "up2_conv3x3"
# the f32 attention kernel below the flash gate (kernels/split_attention.py),
# routed by kernels/attention.py:route (SPLIT_PER_RUN below)
SPLIT = "split_attention"
# path -> {(shape, dtype name): calls} of the split kernel in its counted run
SPLIT_SIGS = {}
# (shape, dtype, records grad, on CUDA) -> calls of spatial_attention since
# zero_attention()
_ATTN_CALLS = {}
# calls of ops/fused_up.py:up2_conv3x3 per fused UNet forward (one Upsample
# each of the four levels up), whose router launches the up path's kernel
# for f32 and takes cuDNN's transposed conv for bf16
UPS_PER_FORWARD = 4
# fused Blocks per UNet forward: 54 on the wgmma route and the final conv
# (Cout = 3) on the thin one
BLOCKS_PER_FORWARD = 55
PROBE = "int8_probe"
# path -> (config, its model.diffusion changed by, launches per cube of each kernel)
R3, R3_DDIM = "pavia_x4_r3", "pavia_x4_r3_ddim"
PATHS = {
    # 55 fused Blocks per UNet forward x t_start=4; attention below the gate
    R3: ("pavia_x4_r3.json", {}, {FUSED: 220, FLASH: 0}),
    # the same with the DDIM sampler, 4 steps, eta 0; t_start removed (the JAX
    # package refuses it with DDIM): 55 fused Blocks x 4 UNet forwards
    R3_DDIM: ("pavia_x4_r3.json", {"sampler": "ddim", "ddim_steps": 4, "t_start": None},
              {FUSED: 220, FLASH: 0}),
    # 55 fused Blocks and 5 flash attentions per forward x T=20
    "pavia_x4": ("pavia_x4.json", {}, {FUSED: 1100, FLASH: 100}),
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
# per UNet forward x t_start=4 at 128^2 ... 8^2 (attention at 16^2 and 8^2,
# on the split kernel)
TRAIN, TRAIN_STEPS = "train_r3", 12
TRAIN_VAL = {FUSED: 55 * 4 * 3 * 3, FLASH: 0}
TRAIN_SCENES, TRAIN_SCENE_HW, VAL_HW = 8, 256, 128
# SR3 16->128 inference through the port's CLI (cli.infer, --process_mode
# grid) under configs/sr_sr3_16_128.json at full width, fused Blocks: the
# val split is INFER_IMAGES seeded 128^2 face-like PNGs; each image's
# continous chain runs the val schedule cut to INFER_T steps (cosine), 55
# fused Blocks per UNet forward at B=1 (attention at 16^2 and the mid block,
# on the split kernel); INFER_REPLAY steps replayed kernels against plain
INFER, INFER_IMAGES, INFER_T, INFER_REPLAY = "infer_sr3_16_128", 2, 200, 4
INFER_PER_IMAGE = {FUSED: 55 * INFER_T, FLASH: 0}
# H-sharded inference (super_resolve_spatial) under configs/pavia_x4.json on
# a ('data', 'space') = (1, 2) mesh: two ranks, each holding 256 of the 512
# latent rows (16 of 32 at the deepest level), spawned on the one card and
# joined over gloo (NCCL refuses two ranks on one device). Each replays the
# pavia_x4 cube's draws (its seed 2) and launches 55 fused Blocks per UNet
# forward on its shard, with halo rows, and 5 flash attentions on the
# gathered 128^2 level, x T=20. Two ranks share one card, so its times are
# not multi-card times. The JAX package holds its sharded chain to 1e-4 of
# its single-device chain (printed here, not gated: the kernel's per-row
# stats take atomicAdds in no fixed order, so two single-device chains
# differ too); the gate is TOL_UNET.
SPATIAL, SPATIAL_MESH, SPATIAL_SEED = "pavia_x4_spatial", (1, 2), 2
SPATIAL_PER_RANK = {FUSED: 1100, FLASH: 100}
# the seed of its one timed cube after the counted one (3 timed cubes before
# the data-parallel paths came: one keeps the script inside its time)
SPATIAL_TIMED_SEED = 3
SPATIAL_JAX_TOL = 1e-4
# the ranks gather the same latent bit for bit and each decodes it: their
# cubes (in [0, 1]) may differ in the last bits of cuDNN's convolutions
SPATIAL_RANK_TOL = 1e-6
TWO_RANKS = "two ranks share one card (gloo), not a multi-card time"
# the sampler's latent chunks: configs/pavia_x4_r3.json with
# model.diffusion.latent_chunk CHUNK on CHUNK_CUBES cubes, the JAX README's
# throughput mode: 4 x 9 = 36 latents in 3 chains of 12, 220 fused Blocks
# each. Its reference is the same batch unchunked (one chain of 36) from the
# same replayed draws: the two are held to TOL_UNET (the stats atomics alone
# move a chain by about 3e-3).
CHUNKED, CHUNKED_WHOLE, CHUNK, CHUNK_CUBES = ("pavia_x4_r3_chunked",
                                              "pavia_x4_r3_chunked:unchunked", 12, 4)
CHUNK_PATHS = {CHUNKED: {FUSED: 3 * 220, FLASH: 0}, CHUNKED_WHOLE: {FUSED: 220, FLASH: 0}}
# whole-scene tiled inference: one seeded SR cube the size of the Pavia
# Centre scene through super_resolve_tiled(TILE, OVERLAP) under the r3
# config: tile origins y 0, 480, 584 and x 0, 203, six 512^2 tiles of 220
# fused Blocks each (the r3 cube's launch signatures)
TILED, SCENE, TILE, OVERLAP = "pavia_x4_tiled", (1096, 715, 102), 512, 32
TILE_ORIGINS = [(y, x) for y in (0, 480, 584) for x in (0, 203)]
TILED_PER_SCENE = {FUSED: len(TILE_ORIGINS) * 220, FLASH: 0}
# data-parallel inference: the r3 config's cube (9 latents) through
# super_resolve with a 'data' mesh over two ranks spawned on the one card
# (gloo: NCCL refuses two ranks on one device), replaying no draws: each rank
# draws the whole batch's x_init and noise from the same generator as one
# process does, wrap-pads the 9 latents to 10 and runs its 5: 220 fused-Block
# launches per rank at B=5. The gathered latent is held to the single
# process's from the same generator (TOL_UNET). Two ranks share one card, so
# its times are not multi-card times.
R3_DP, R3_DP_SEED = "pavia_x4_r3_dp", 2
R3_DP_PER_RANK = {FUSED: 220, FLASH: 0}
# data-parallel training: train_r3's step (the r3 pipeline's train_step_from_hr
# on TRAIN_DP_CROPS HR crops of 128^2 x 102 = 36 latents) for TRAIN_DP_STEPS
# steps over two ranks on the one card (18 latents each, the gradients
# all-reduced over gloo) from the weights and draws of a one-rank run of the
# same steps; then one validation cube of 128^2 on each rank (9 latents padded
# to 10: 220 fused launches per rank at B=5). The training steps launch no
# kernel. Rank 0's first all-reduced gradients are held to the one-rank
# run's (TOL_STEP_GRAD of the largest |g|, as a card step is held to the
# CPU's) and its Adam moments after the steps to the one rank's
# (TOL_TRAIN_DP_ADAM of each leaf's largest |value|): these two catch a
# gradient summed where it should be averaged (twice the gradient, and
# twice Adam's first moment) and draws cut wrong. The share of weights further than 0.05 lr from
# the one rank's is held to TRAIN_DP_SHARE_OFF: it catches draws cut wrong
# (gradients of another batch), not a sum, since Adam's step does not see a
# gradient's scale. Adam moves a weight by about lr times its gradient's
# sign, so where a gradient near 0 takes the other sign between cuDNN's
# batch-36 and batch-18 convolutions the weight lands about 2 lr away, and
# later gradients follow. Measured on the H100 (PERF.md 6): latents from the
# trained GAE flip the sign of 9.4e-5 of the first gradients and put 7.9e-4
# of the weights past 0.05 lr, Adam's moments 5.9e-4 off; a seeded, untrained
# GAE flips 3.9e-7, and 1.1e-6 of the weights, 1.7e-4, in the same process
# or alone. The worst weight over lr and the share of sign flips are
# reported, not held: two Adam runs stay within about 2 lr a step of each
# other whatever their gradients. The ranks' states bit for bit alike.
TRAIN_DP, TRAIN_DP_STEPS, TRAIN_DP_CROPS, TRAIN_DP_SEED = "train_r3_dp", 3, 4, 61
TRAIN_DP_VAL_PER_RANK = {FUSED: 220, FLASH: 0}
TOL_TRAIN_DP_ADAM, TRAIN_DP_SHARE_OFF = 1e-2, 1e-2
UNET_PATHS = (*PATHS, *BENCH_PATHS, TRAIN, INFER, SPATIAL, *CHUNK_PATHS, TILED, R3_DP,
              TRAIN_DP)
# the split kernel's launches per counted run (or rank) where the path fixes
# them: r3 5 calls at 64^2 and the mid block at 32^2 per UNet forward x 4,
# x4 the mid block x 20; the bf16 rows keep the einsum route
SPLIT_PER_RUN = {R3: 24, R3_DDIM: 24, "pavia_x4": 20, CHUNKED: 3 * 24, CHUNKED_WHOLE: 24,
                 TILED: len(TILE_ORIGINS) * 24, BENCH: 0, BENCH_FULL: 0}
SPLIT_PER_RANK = {SPATIAL: 20, R3_DP: 24}
# train_r3's step with model.unet.remat on, against the same step without it
# from the same weights, batch and dropout generator: the loss and every
# gradient leaf within tests/test_remat.py's atol 1e-4 and rtol 1e-3; then
# REMAT_STEPS steps of each (median after 2 warm-up), peak memory of each
REMAT, REMAT_STEPS = "train_r3_remat", 5
TOL_REMAT_ABS, TOL_REMAT_REL = 1e-4, 1e-3
# unconditional generation under configs/sample_ddpm_16.json at its full
# width (the discrete-t BatchNorm UNet, unfused: no kernel of the port): one
# train step of SAMPLE_BATCH HR images of 128^2 x 3 against the CPU's, then
# DDPMModel.sample of SAMPLE_N images; the config's 2000-step ancestral chain
# when SAMPLE_CHAIN_S holds 2000 UNet forwards, else DDIM over SAMPLE_DDIM_STEPS
SAMPLE, SAMPLE_BATCH, SAMPLE_N = "sample_ddpm_16", 4, 2
SAMPLE_CHAIN_S, SAMPLE_DDIM_STEPS = 30.0, 100
# the BatchNorm running statistics after that step, card against CPU: max
# |diff| over max |CPU| per buffer (means over 65536 values a channel)
TOL_STEP_STATS = 1e-4
# the same config through the port's CLI (cli.sample): -p train for
# SAMPLE_CLI_STEPS steps of 4 seeded 128^2 PNGs (a save and a sample at the
# last), then -p val on that checkpoint; both phases' schedules cut to
# SAMPLE_CLI_T steps (linear). No kernel of the port runs.
SAMPLE_CLI, SAMPLE_CLI_STEPS, SAMPLE_CLI_T = "sample_cli_ddpm_16", 4, 100
FACES = 4  # seeded 128^2 HR images (and their 16 -> 128 SR images) for both CLIs
# color_correction_torch on the card against the numpy color_correction
TOL_COLOR = 1e-5
# torch.profiler drops device events: every flash row read 0 events in
# --profile runs once the traced cubes had come first, and on another H100
# a fresh process's two sessions each saw 4 of 5 launches. So the flash
# rows' prepass/attention split is timed with CUDA events on the C entry's
# phases (flash_times), and no gate depends on a trace.
# stage-1 GAE training through the port's CLI (cli.ae) at the Pavia GAE's
# width, device-resident scenes: 8 HR crops of 128^2 x 102 a step, so 72
# group images through the shared encoder and decoder. 64 augmented items
# / 8 = 8 steps an epoch: 2 epochs cut at TRAIN_GAE_STEPS end on the
# second epoch's save. The GAE is cuDNN convolutions: no kernel of the port.
TRAIN_GAE, TRAIN_GAE_STEPS, TRAIN_GAE_BATCH, TRAIN_GAE_EPOCHS = "train_gae", 12, 8, 2
# the perceptual term's weight in the card-vs-CPU check (the shipped 1e-3
# would hide the term under the loss's rtol), and the bands it replays
TRAIN_GAE_P_WEIGHT, TRAIN_GAE_BANDS = 1.0, (5, 50, 97)
# the baseline zoo through the port's CLI (cli.baselines) at full width on
# Pavia's 102 bands, the README's baseline command: each model trained at the
# CLI's defaults (batch 16 of HSTrainingData crops, HR 32 x scale, Adam 1e-4)
# for BASELINE_STEPS steps (--max_steps) on make_train_data's 8 scenes, then
# cli.baselines test on its checkpoint over 1 seeded scene (gt_size 64); edsr
# at scale 2 (the reference pins it), the others at 4. CEGATSR, which no CLI
# trains, as one forward at its defaults on a batch of the same size. Each
# model's reference golden (tests/golden/*_forward_golden.npz) on the card at
# the JAX tests' tolerance, and one step (CEGATSR: one forward) on the card
# against the CPU's, in f64, from the trained full-width weights on one item of
# LR 8^2 x 102. No kernel of the port runs: cuDNN convolutions.
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
# the 3-D GAN through the port's CLI (cli.gan_train) at its defaults (n_bands
# 31, fis 144, scale 4, batch 4, Adam 1e-4) on a seeded stacked-scene .npy of
# GAN3D_SCENES scenes of 31 x GAN3D_HW^2 (9 tiles of 144^2 each), for
# GAN3D_STEPS steps; both nets' goldens on the card, and one D step and one G
# step on the card against the CPU's, in f64, from the trained weights on one
# tile of LR 9^2 (D's running statistics after the step too)
GAN3D, GAN3D_STEPS, GAN3D_SCENES, GAN3D_HW = "gan3d_x4", 3, 2, 512
# DAQ quantization and the refiners at the reference's widths, f32 on the
# card: ResBlockDAQ, SSBDAQ and ResAttentionBlockDAQ at n_feats DAQ_FEATS and
# a_bit = w_bit in DAQ_BITS on DAQ_CROPS crops of DAQ_HW^2 (forward and
# backward); AttentionNet(102, 64) on one 512^2 x 102 cube; post_unet(102,
# 102) at its defaults (inner 8, image_size 128) on 4 x 128^2 x 102 in train
# mode; Codebook(4096, 512) on 1024 vectors. No kernel of the port runs but
# the split attention kernel, in post_unet's f32 forward on the card.
DAQ, DAQ_CROPS, DAQ_HW, DAQ_FEATS, DAQ_BITS, DAQ_HELD = "daq_refiners", 16, 128, 64, (4, 8), 4
# no kernel of the port, but for the split attention kernel in post_unet's forward (DAQ)
ZOO_PATHS = (BASELINES, GAN3D, DAQ)
# the paths whose split kernel signatures are checked, timed and counted
SPLIT_PATHS = (*UNET_PATHS, DAQ)
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
def recording(fused_calls, flash_calls, up2_calls):
    """Record the signature of every fused-Block, flash and up-path call the
    UNet makes. The real wrappers still run, and count their own launches."""
    from hsi_dmgasr_tpu_torch.kernels import attention as attn_mod
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod

    real_fused, real_flash = unet_mod.gn_swish_conv3x3, attn_mod.flash_attention
    real_up2 = unet_mod.up2_conv3x3

    def rec_fused(x, gn_scale, gn_bias, kernel, bias, **kw):
        x2 = kw.get("x2")
        sig = (tuple(x.shape), 0 if x2 is None else x2.shape[-1], kernel.shape[-1],
               kw.get("time_bias") is not None, kw.get("residual") is not None,
               kw.get("stats_in") is not None, kw.get("stats_in2") is not None,
               bool(kw.get("emit_stats")), kw.get("res_kernel") is not None,
               dtype_name(x.dtype))
        if kw.get("halo") is not None:  # an H-shard's launch: which shard
            sig += (shard_position(kw["mesh"]),)
        fused_calls[sig] = fused_calls.get(sig, 0) + 1
        return real_fused(x, gn_scale, gn_bias, kernel, bias, **kw)

    def rec_flash(q, k, v, scale):
        sig = (tuple(q.shape), dtype_name(q.dtype))
        flash_calls[sig] = flash_calls.get(sig, 0) + 1
        return real_flash(q, k, v, scale)

    def rec_up2(x, kernel, bias=None, **kw):
        sig = (tuple(x.shape), kernel.shape[-1], bias is not None, dtype_name(x.dtype))
        up2_calls[sig] = up2_calls.get(sig, 0) + 1
        return real_up2(x, kernel, bias, **kw)

    with mock.patch.object(unet_mod, "gn_swish_conv3x3", rec_fused), \
            mock.patch.object(attn_mod, "flash_attention", rec_flash), \
            mock.patch.object(unet_mod, "up2_conv3x3", rec_up2), attention_recording():
        yield


@contextmanager
def attention_recording():
    """Record every UNet attention call (shape, dtype, whether it records a
    graph, whether on CUDA) into _ATTN_CALLS, for ``attention_routes``."""
    from hsi_dmgasr_tpu_torch.models import unet as unet_mod

    real_attn = unet_mod.spatial_attention

    def rec_attn(q, k, v, scale, **kw):
        import torch

        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        key = (tuple(q.shape), q.dtype, grad, q.is_cuda)
        _ATTN_CALLS[key] = _ATTN_CALLS.get(key, 0) + 1
        return real_attn(q, k, v, scale, **kw)

    with mock.patch.object(unet_mod, "spatial_attention", rec_attn):
        yield


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


def pick_bound(nbytes, flops):
    """(bound_ms, bound_by) against the H100's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(sig):
    """Fused Block: each input read once, each output written once,
    activations in the signature's dtype (4 or 2 bytes), bf16 weights. An
    f32 input's conv is two bf16 products (its activation's hi and lo
    parts), the time of one at the TF32 rate."""
    (b, h, w, c), c2, cout, tb, res, sin, sin2, emit, proj, dt = sig[:10]
    ct, pix = c + c2, b * h * w
    pix_in = pix + (2 * b * w if len(sig) > 10 else 0)  # an H-shard also reads two halo rows
    nbytes = (2 if dt == "bf16" else 4) * (pix_in * ct + pix * cout * (1 + res + proj))
    nbytes += 2 * (9 + proj) * ct * cout + 4 * (b * h * 2 * (c * sin + c2 * sin2 + cout * emit))
    return pick_bound(nbytes, (2 if dt == "bf16" else 4) * pix * cout * ct * (9 + proj))


def up2_bound(sig):
    """Up path: operations 2 B (2H)(2W) 4 C Cout counted once; x and the
    output once in f32, the 3x3 weights once in f32."""
    (b, h, w, c), cout = sig[:2]
    return pick_bound(4.0 * (b * h * w * c + 4 * b * h * w * cout + 9 * c * cout),
                      2.0 * b * 4 * h * w * 4 * c * cout)


def check_up2(sig, seed):
    """The up path's kernel at one recorded f32 signature: against its
    plain version and cuDNN's f32 transposed conv, each within TOL_UP2 of
    sum |x| |w|; its time through ``up2_conv3x3`` on weights packed once (as
    ``Upsample`` keeps them), its launch alone in a CUDA graph, the plain
    version's and the transposed conv's."""
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
    got = fused_up.up2_conv3x3(x, kernel, bias, packed=packed)
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
    del got, want, scale
    ms = cuda_ms(lambda: fused_up.up2_conv3x3(x, kernel, bias, packed=packed), reps=5)
    out = torch.empty((b, 2 * h, 2 * w, cout), device="cuda")
    fn = up2_conv._entry()

    def launch():
        rc = fn(x.data_ptr(), packed.wpack.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), b, h, w, c, cout, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{UP2} launch failed: cudaError {rc}")
    kernel_ms = graph_ms(launch, calls=10, reps=5)
    plain_ms = cuda_ms(lambda: fused_up.up2_conv3x3_parity(x, kernel, bias), reps=2)
    library_ms = cuda_ms(lambda: fused_up.up2_conv3x3_transpose(x, kernel, bias), reps=3)
    b_ms, b_by = up2_bound(sig)
    return {"signature": f"f32 B={b} {h}x{w} {c}->{cout}" + ("" if with_bias else " no bias"),
            "level": f"{h}x{w}",
            "errors": {"out": errs["cudnn_f32"], **errs}, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_frac": b_ms / ms, "kernel_bound_frac": b_ms / kernel_ms,
            "vs_library": ms / library_ms}


def up2_rows(up2_sigs):
    """``check_up2`` at every f32 signature the main paths recorded (the
    kernel's route), each row with its calls per path and logged."""
    import torch

    rows = []
    f32 = sorted((kv for kv in up2_sigs.items() if kv[0][-1] == "f32"),
                 key=lambda kv: (kv[0][0][0], kv[0][0][1]))
    for i, (sig, counts) in enumerate(f32):
        row = check_up2(sig, seed=400 + i)
        row["counts"] = counts
        rows.append(row)
        log(f"{UP2} {row['signature']:<28} {counts} abs {row['errors']['out']['max_abs']:.2e} "
            f"of sum|x||w| "
            f"{row['errors']['cudnn_f32']['max_rel_sum']:.2e} (plain "
            f"{row['errors']['plain']['max_rel_sum']:.2e}) | ms {row['ms']:.3f} kernel alone "
            f"{row['kernel_ms']:.3f} plain {row['plain_ms']:.3f} cudnn f32 {row['library_ms']:.3f} "
            f"bound {row['bound_ms']:.3f} ({row['bound_by']}) of bound "
            f"{row['kernel_bound_frac']:.3f} x cudnn {row['vs_library']:.3f}")
        torch.cuda.empty_cache()
    return rows


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

    # the chunked row's B=12 and B=36 launches take up to 4x as long as
    # B=9's: fewer repeats keep their rows' share of the run's time
    reps, calls = (5, 20) if sig[0][0] <= 9 else (2, 5)
    ms = cuda_ms(lambda: fc.gn_swish_conv3x3(*args, packed=packed, **kw), reps=reps)
    kernel_ms = graph_ms(bare_launch(fc, args, kw, packed), calls=calls, reps=reps)
    plain_ms = cuda_ms(lambda: fc.gn_swish_conv3x3_plain(*args, **kw), reps=2)
    # yardstick only: one cuDNN bf16 conv on the pre-activated input
    scale, shift = fc.gn_scale_shift(args[0], args[1], args[2], kw.get("x2"),
                                     kw.get("stats_in"), kw.get("stats_in2"), 32)
    x_all = args[0] if "x2" not in kw else torch.cat([args[0], kw["x2"]], -1)
    a = x_all.to(torch.bfloat16).float() * scale[:, None, None, :] + shift[:, None, None, :]
    a = (a * torch.sigmoid(a)).to(torch.bfloat16).permute(0, 3, 1, 2)
    w = args[3].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = cuda_ms(lambda: F.conv2d(a, w, padding=1), reps=reps)
    del a, x_all, scale, shift
    b_ms, b_by = bound(sig)
    level = f"{sig[0][1]}x{sig[0][2]}" + (" shard" if len(sig) > 10 else "")
    return {"signature": describe(sig), "level": level,
            "errors": errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "kernel_ms": kernel_ms, "bound_frac": b_ms / ms, "vs_library": ms / library_ms,
            "kernel_bound_frac": b_ms / kernel_ms}


@contextmanager
def traced():
    """A torch.profiler session (CPU and CUDA) around the block, whose
    device work is synchronised inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def flash_inputs(sig, seed):
    """Strided q, k, v views of one seeded qkv tensor (f32 or bf16), as the
    UNet makes them, and the scale."""
    import torch

    (b, s, h, d), dt = sig
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, h, 3 * d), generator=gen, device="cuda").to(dtype)
    return (*qkv.split(d, dim=-1), 1.0 / math.sqrt(h * d))


def flash_times(q, k, v, scale, want, rounds=5):
    """Mean milliseconds of the flash wrapper, of its C entry's bf16
    prepass alone (0 at the head dims without one) and of its attention
    body alone, on the scratch the prepass filled: CUDA events around each
    call, the three interleaved over ``rounds`` rounds and queued behind one
    untimed call, so that all three see the card in one state (under
    sustained load its clock falls: whichever was timed second read 5-10 %
    slower). The body's output must equal ``want``, the wrapper's, bit for
    bit."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa

    out, scratch = fa.buffers(q)
    fa.run_phases(q, k, v, scale, out, scratch, 3)
    out.zero_()
    calls = {"ms": lambda: fa.flash_attention(q, k, v, scale),
             "prepass_ms": lambda: fa.run_phases(q, k, v, scale, out, scratch, 1),
             "attention_kernel_ms": lambda: fa.run_phases(q, k, v, scale, out, scratch, 2)}
    if scratch is None:
        del calls["prepass_ms"]
    calls["ms"]()
    events = []
    for _ in range(rounds):
        for name, fn in calls.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((name, start, end))
    torch.cuda.synchronize()
    times = {"ms": 0.0, "prepass_ms": 0.0, "attention_kernel_ms": 0.0}
    for name, start, end in events:
        times[name] += start.elapsed_time(end) / rounds
    if not torch.equal(out, want):
        raise AssertionError("flash: the attention body alone != the wrapper's output")
    return times


def check_flash(sig, seed):
    """Flash kernel vs plain version on the card, on strided q, k, v views
    of one qkv tensor (f32 or bf16) as the UNet makes them, and the four
    times, the prepass's and the attention body's (flash_times) and the
    einsum route's time (attention.py's matmul path, in the same
    dtype). The library yardstick is one scaled_dot_product_attention on
    bf16 copies."""
    import torch
    import torch.nn.functional as F

    from hsi_dmgasr_tpu_torch.kernels import attention as attn
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa

    (b, s, h, d), dt = sig
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, scale = flash_inputs(sig, seed)
    got = fa.flash_attention(q, k, v, scale)
    want = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    if got.dtype != dtype or want.dtype != dtype:
        raise AssertionError(f"flash {sig}: output dtypes {got.dtype}, {want.dtype}")
    timed = flash_times(q, k, v, scale, got)
    ms, pre_ms, attn_ms = timed["ms"], timed["prepass_ms"], timed["attention_kernel_ms"]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = {"max_abs": diff.max().item(), "max_rel": diff.max().item() / want.abs().max().item()}
    if not bool((diff <= TOL_FLASH_ABS + TOL_FLASH_REL * want.abs()).all()):
        raise AssertionError(f"flash {sig}: kernel vs plain {err}")
    del got, want, diff

    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale), reps=2)
    einsum_ms = cuda_ms(lambda: attn._einsum_attention(q, k, v, scale), reps=3)
    qb, kb, vb = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, scale=scale), reps=5)
    del qb, kb, vb
    flops = 4 * b * h * s * s * d
    b_ms, b_by = pick_bound(4 * q.element_size() * b * s * h * d, flops)
    return {"signature": f"{dt} B={b} S={s} H={h} D={d}", "errors": {"out": err}, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "prepass_ms": pre_ms, "prepass_share": pre_ms / ms, "attention_kernel_ms": attn_ms,
            "einsum_ms": einsum_ms, "tflops": flops / ms / 1e9}


def split_times(q, k, v, scale, rounds=5):
    """Mean milliseconds of the split kernel's wrapper, of each of its C
    entry's phases alone (the split, the logits, p . v, each on what the
    others wrote into one set of buffers) and of the einsum route, CUDA
    events around each call, interleaved over ``rounds`` rounds after one
    untimed call of each (see flash_times)."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import attention as attn
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    bufs = sa.buffers(q)
    calls = {"ms": lambda: sa.split_attention(q, k, v, scale),
             "split_ms": lambda: sa.run_phases(q, k, v, scale, *bufs, 1),
             "logits_ms": lambda: sa.run_phases(q, k, v, scale, *bufs, 2),
             "pv_ms": lambda: sa.run_phases(q, k, v, scale, *bufs, 4),
             "einsum_ms": lambda: attn._einsum_attention(q, k, v, scale)}
    for fn in calls.values():
        fn()
    events = []
    for _ in range(rounds):
        for name, fn in calls.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((name, start, end))
    torch.cuda.synchronize()
    times = dict.fromkeys(calls, 0.0)
    for name, start, end in events:
        times[name] += start.elapsed_time(end) / rounds
    return times


def check_split(sig, seed):
    """The split attention kernel vs its plain version on the card
    (TOL_SPLIT), on strided q, k, v views of one f32 qkv tensor as the UNet
    makes them; its times (split_times), the plain version's, and the
    einsum route's as the yardstick (the route it replaced)."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    (b, s, h, d), dt = sig
    q, k, v, scale = flash_inputs(sig, seed)
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
    t = split_times(q, k, v, scale)
    plain_ms = cuda_ms(lambda: sa.split_attention_plain(q, k, v, scale), reps=2)
    flops = 4 * b * h * s * s * d
    b_ms, b_by = pick_bound(4 * q.element_size() * b * s * h * d, flops)
    return {"signature": f"{dt} B={b} S={s} H={h} D={d}", "errors": {"out": err},
            "plain_ms": plain_ms, "library_ms": t["einsum_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "tflops": flops / t["ms"] / 1e9, **t}


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

    with traced() as prof:
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
    # the port's kernels the trace saw, beside the launches counted (a
    # trace may miss events: see flash_times)
    seen = {FUSED: sum(n for k, (_, n) in by_name.items() if "gn_swish_conv3x3" in k),
            FLASH: sum(n for k, (_, n) in by_name.items() if "flash_" in k)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_events": seen,
            "idle_share": 1.0 - busy_ms / wall_ms, "stages": seconds,
            "kernels": [{"name": k[:120], "ms": ms, "calls": n} for k, (ms, n) in top]}


def run_path(name, config, diffusion, expected, cube, profile):
    """Record, count, check and time one main path (its config's
    model.diffusion updated by ``diffusion``). Returns its report and the
    launch signatures it recorded. A DDIM path also runs one chain twice
    from the same x_init, with the kernels and on their plain versions."""
    import torch

    pipe = build_pipeline(config, diffusion)
    # the counted main-path run, which also records the launch signatures
    out, _, peak_gib, launches, fused_calls, flash_calls, up2_calls = counted_run(
        name, expected,
        lambda: pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(2)))
    check_cube(name, out, CUBE)
    del out
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(3 + r))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    report = {"config": config, "diffusion": diffusion, "cube_seconds": statistics.median(times),
              "cube_times": times, "peak_memory_gib": peak_gib, "launches": launches}
    log(f"[{name}] cube seconds (median of 3): {report['cube_seconds']:.4f} {times}")
    if diffusion.get("sampler") == "ddim":
        report["chain_err"] = check_chain(name, pipe, cube)

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
    return report, fused_calls, flash_calls, up2_calls


def check_chain(name, pipe, cube):
    """One reverse chain of the path's sampler on the card from a seeded
    x_init, with the kernels and again on their plain versions: elementwise
    within TOL_UNET."""
    import torch

    with torch.inference_mode():
        cond = pipe._fold(pipe.encode(cube))
        x_init = torch.randn(cond.shape, generator=torch.Generator(device="cuda").manual_seed(8),
                             device="cuda")
        got = pipe.ddpm.super_resolution(cond, x_init=x_init)
        with plain_kernels():
            want = pipe.ddpm.super_resolution(cond, x_init=x_init)
    err = divergence(got, want)
    log(f"[{name}] one chain (B=9, 512^2) from the same x_init, kernels vs plain: {err}")
    if not within(got, want, TOL_UNET):
        raise AssertionError(f"[{name}] chain with the kernels vs plain: {err}")
    return err


def spatial_rank(rank, device, weights, timed_seed):
    """One rank of pavia_x4_spatial: the pavia_x4 pipeline on the weights
    the parent saved, the launch counts set to 0, one cube through
    super_resolve_spatial replaying the pavia_x4 cube's draws while its
    launch signatures are recorded (and the gathered latent caught at the
    decode), its exact counts, then one more cube from ``timed_seed``, timed.
    Returns the counts, signatures, bytes gathered, peak memory, times,
    latent and cube."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.parallel import dmgasr_mesh

    use_f32_policy()
    mesh = dmgasr_mesh(*SPATIAL_MESH)
    torch.cuda.set_device(mesh.device)
    config, diffusion, _ = PATHS["pavia_x4"]
    pipe = build_pipeline(config, diffusion)
    state = torch.load(weights, map_location=mesh.device)
    pipe.gae.load_state_dict(state["gae"])
    pipe.ddpm.eval_unet.load_state_dict(state["unet"])
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")

    def sharded_cube(seed):
        return pipe.super_resolve_spatial(
            cube, mesh, generator=torch.Generator(device="cuda").manual_seed(seed),
            replay_noise=True)

    fused_calls, flash_calls, up2_calls = {}, {}, {}
    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    zero_up2()
    zero_attention()
    mesh.gathered.clear()
    torch.cuda.reset_peak_memory_stats()
    with recording(fused_calls, flash_calls, up2_calls), \
            mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out = sharded_cube(SPATIAL_SEED)
    torch.cuda.synchronize()
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
    gathered = dict(mesh.gathered)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != SPATIAL_PER_RANK or bd.LAUNCHES:
        raise AssertionError(f"[{SPATIAL}] rank {rank}: {launches}, {bd.LAUNCHES} blocked-dot "
                             f"launches per cube, expected {SPATIAL_PER_RANK} and none")
    # an H-shard's up path is up2_conv3x3_spatial's transposed conv, not the router
    launches[UP2] = up2_launches(f"{SPATIAL}:rank{rank}", 0, up2_calls)
    routes, split_calls = attention_routes(f"{SPATIAL}:rank{rank}", SPLIT_PER_RANK[SPATIAL])
    launches[SPLIT] = routes["split"]
    check_cube(SPATIAL, out, CUBE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded_cube(timed_seed)
    torch.cuda.synchronize()
    return {"launches": launches, "fused_calls": fused_calls, "flash_calls": flash_calls,
            "up2_calls": up2_calls, "split_calls": split_calls,
            "gathered_bytes": gathered, "peak_memory_gib": peak_gib,
            "cube_seconds": time.perf_counter() - t0,
            "latent": decode.call_args[0][0].cpu(), "cube": out.cpu()}


def run_spatial():
    """pavia_x4_spatial, in the parent: the pavia_x4 pipeline's single-device
    cube twice from the same draws (the latent caught at the decode: the
    reference, and the spread two single-device chains show), its weights
    saved for the ranks; then the two ranks (multihost.launch, a file://
    store), each checked for its counts and cube; the ranks' cubes equal;
    the sharded latent against the single-device one within TOL_UNET.
    Returns its report and its ranks' launch signatures, summed."""
    import tempfile

    import torch

    from hsi_dmgasr_tpu_torch.parallel import multihost

    config, diffusion, _ = PATHS["pavia_x4"]
    pipe = build_pipeline(config, diffusion)
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

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(spatial_rank, SPATIAL_MESH[0] * SPATIAL_MESH[1],
                             f"file://{store}/rendezvous", args=(weights, SPATIAL_TIMED_SEED))
    shutil.rmtree(store, ignore_errors=True)
    secs = time.perf_counter() - t0
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
    log(f"[{SPATIAL}] mesh {SPATIAL_MESH} ({TWO_RANKS}): sharded latent chain vs single-device "
        f"{err}; within the JAX package's {SPATIAL_JAX_TOL} (not gated): {meets_jax}; two "
        f"single-device chains from the same draws differ by {spread}")
    if not within(ranks[0]["latent"], single[0], TOL_UNET):
        raise AssertionError(f"[{SPATIAL}] sharded chain vs single-device: {err}")
    fused_calls, flash_calls, up2_calls = {}, {}, {}
    for r in ranks:
        for mine, calls in ((fused_calls, r["fused_calls"]), (flash_calls, r["flash_calls"]),
                            (up2_calls, r["up2_calls"])):
            for sig, n in calls.items():
                mine[sig] = mine.get(sig, 0) + n
    launches = {k: sum(r["launches"][k] for r in ranks) for k in (FUSED, FLASH, UP2, SPLIT)}
    SPLIT_SIGS[SPATIAL] = merged_split(ranks)
    times = [r["cube_seconds"] for r in ranks]
    report = {"mesh": SPATIAL_MESH, "note": TWO_RANKS, "launches": launches,
              "launches_per_rank": [r["launches"] for r in ranks],
              "cube_seconds": times[0], "cube_seconds_per_rank": times,
              "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
              "gathered_bytes_per_cube": [r["gathered_bytes"] for r in ranks],
              "sharded_vs_single": err, "within_jax_tol": meets_jax,
              "single_device_spread": spread, "ranks_seconds": secs,
              "ranks_cube_max_diff": cube_diff, "decode_repeat_max_diff": decode_repeat}
    log(f"[{SPATIAL}] ({TWO_RANKS}) cube seconds (rank 0; per rank): "
        f"{report['cube_seconds']:.4f} {times}; peak memory per rank "
        f"{[round(g, 2) for g in report['peak_memory_gib']]} GiB; bytes gathered per cube by "
        f"rank {report['gathered_bytes_per_cube']}; launches per rank "
        f"{report['launches_per_rank']}; the ranks took {secs:.1f} s in all")
    return report, fused_calls, flash_calls, up2_calls


def zero_up2():
    """The up path's route counts to 0."""
    from hsi_dmgasr_tpu_torch.kernels import up2_conv

    for route in up2_conv.LAUNCHES_BY_ROUTE:
        up2_conv.LAUNCHES_BY_ROUTE[route] = 0


def up2_launches(name, forwards, up2_calls):
    """The up path in a run of ``forwards`` fused UNet forwards, its counts
    set to 0 (``zero_up2``) before it: UPS_PER_FORWARD recorded calls a
    forward, and the router counted each f32 call on the kernel and each
    other on the transposed conv. Returns the kernel's launches."""
    from hsi_dmgasr_tpu_torch.kernels import up2_conv

    routes = dict(up2_conv.LAUNCHES_BY_ROUTE)
    calls = sum(up2_calls.values())
    f32 = sum(n for sig, n in up2_calls.items() if sig[-1] == "f32")
    if calls != UPS_PER_FORWARD * forwards or routes != {"kernel": f32, "transpose": calls - f32}:
        raise AssertionError(f"[{name}] up path: routes {routes}, {calls} calls recorded ({f32} "
                             f"f32), expected {UPS_PER_FORWARD} a UNet forward x {forwards}, "
                             "each f32 call on the kernel")
    return routes["kernel"]


def zero_attention():
    """The attention router's counts, the split kernel's launches and the
    recorded attention calls to 0."""
    from hsi_dmgasr_tpu_torch.kernels import attention
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    attention.LAUNCHES_BY_ROUTE.update(dict.fromkeys(attention.LAUNCHES_BY_ROUTE, 0))
    sa.LAUNCHES = 0
    _ATTN_CALLS.clear()


def attention_routes(name, expected_split=None):
    """The attention calls since ``zero_attention``: the router's counts
    held to the route ``attention.route`` gives each call ``recording``
    recorded (so every CUDA f32 call below the flash gate that records no
    graph, at a shape the split kernel takes, launched it), the split
    kernel's launches to its route's count and, where given, to
    ``expected_split``. Returns the routes and the split kernel's
    signatures {(shape, dtype name): calls}."""
    from hsi_dmgasr_tpu_torch.kernels import attention
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa

    want, split = dict.fromkeys(attention.LAUNCHES_BY_ROUTE, 0), {}
    for (shape, dtype, grad, cuda), n in _ATTN_CALLS.items():
        route = attention.route(dtype, cuda, shape[1], shape[3], grad, shape[0] * shape[2])
        want[route] += n
        if route == "split":
            sig = (shape, dtype_name(dtype))
            split[sig] = split.get(sig, 0) + n
    routes = dict(attention.LAUNCHES_BY_ROUTE)
    log(f"[{name}] attention routes {routes}, split kernel launches {sa.LAUNCHES}")
    if (routes != want or sa.LAUNCHES != routes["split"]
            or (expected_split is not None and routes["split"] != expected_split)):
        raise AssertionError(f"[{name}] attention routes {routes} ({sa.LAUNCHES} split launches), "
                             f"the recorded calls' routes {want}, expected {expected_split} "
                             "split launches")
    return routes, split


def merged_split(ranks):
    """The split kernel's signatures summed over ranks' reports."""
    mine = {}
    for r in ranks:
        for sig, n in r["split_calls"].items():
            mine[sig] = mine.get(sig, 0) + n
    return mine


def counted_run(name, expected, run):
    """One main-path run: the launch counts set to 0 and the peak memory
    reset just before ``run()``, its launch signatures recorded, the exact
    counts (recorded and counted) read just after. Returns its output,
    seconds, peak memory, launches and signatures (fused, flash, up path)."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    fused_calls, flash_calls, up2_calls = {}, {}, {}
    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    fc.LAUNCHES_BY_ROUTE = dict.fromkeys(fc.LAUNCHES_BY_ROUTE, 0)
    zero_up2()
    zero_attention()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(fused_calls, flash_calls, up2_calls):
        out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
    recorded = {FUSED: sum(fused_calls.values()), FLASH: sum(flash_calls.values())}
    routes = dict(fc.LAUNCHES_BY_ROUTE)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{name}] main path: {launches} kernel launches ({len(fused_calls)} fused signatures, "
        f"routes {routes}), {secs:.4f} s, peak memory {peak_gib:.2f} GiB")
    if launches != expected or recorded != expected or bd.LAUNCHES:
        raise AssertionError(f"[{name}] {launches} launches ({recorded} recorded), "
                             f"{bd.LAUNCHES} blocked-dot launches, expected {expected}")
    # one thin launch (the final conv, Cout = 3) per UNet forward, the rest wgmma
    n_fused = expected[FUSED]
    if routes != {"thin": n_fused // BLOCKS_PER_FORWARD,
                  "wgmma": n_fused - n_fused // BLOCKS_PER_FORWARD}:
        raise AssertionError(f"[{name}] fused routes {routes}: expected one thin launch per "
                             f"{BLOCKS_PER_FORWARD} fused launches")
    launches[UP2] = up2_launches(name, n_fused // BLOCKS_PER_FORWARD, up2_calls)
    log(f"[{name}] up path: {launches[UP2]} kernel launches, {len(up2_calls)} signatures")
    routes, SPLIT_SIGS[name] = attention_routes(
        name, SPLIT_PER_RUN.get(name, SPLIT_PER_RANK.get(name.split(":rank")[0])))
    launches[SPLIT] = routes["split"]
    return out, secs, peak_gib, launches, fused_calls, flash_calls, up2_calls


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
    run (660 and 220 fused launches), its cubes checked, its peak memory
    read; the two latents and cubes within TOL_UNET (the difference
    printed); then each timed once more, chunked first. Returns both rows'
    reports and signatures."""
    import torch

    config, diffusion, _ = PATHS[R3]
    pipe = build_pipeline(config, {**diffusion, "latent_chunk": CHUNK})
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
            out, secs, peak, launches, fused_calls, flash_calls, up2_calls = counted_run(
                name, CHUNK_PATHS[name],
                lambda: pipe.super_resolve(cubes, x_init=x_init, noise_seq=noise))
        check_cube(name, out, cubes.shape)
        outs[name] = (decode.call_args[0][0], out)
        runs[name] = ({"config": config, "latent_chunk": chunk, "cubes": CHUNK_CUBES,
                       "counted_run_seconds": secs, "peak_memory_gib": peak,
                       "launches": launches}, fused_calls, flash_calls, up2_calls)
    err = {what: divergence(outs[CHUNKED][i], outs[CHUNKED_WHOLE][i])
           for i, what in enumerate(("latent", "cube"))}
    log(f"[{CHUNKED}] chunked ({CHUNK_CUBES * GAE_CFG['G']} latents in chains of {CHUNK}) vs "
        f"unchunked, from the same draws: {err}")
    if not all(within(outs[CHUNKED][i], outs[CHUNKED_WHOLE][i], TOL_UNET) for i in (0, 1)):
        raise AssertionError(f"[{CHUNKED}] chunked vs unchunked: {err}")
    del outs
    for name, chunk in ((CHUNKED, CHUNK), (CHUNKED_WHOLE, None)):
        with latent_chunk(pipe, chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.super_resolve(cubes, x_init=x_init, noise_seq=noise)
            torch.cuda.synchronize()
        report = runs[name][0]
        report["seconds"] = time.perf_counter() - t0
        report["cube_seconds"] = report["seconds"] / CHUNK_CUBES
        log(f"[{name}] {report['cube_seconds']:.4f} s per cube ({CHUNK_CUBES} cubes in "
            f"{report['seconds']:.4f} s; the counted run {report['counted_run_seconds']:.4f} s), "
            f"peak memory {report['peak_memory_gib']:.2f} GiB")
    runs[CHUNKED][0]["chunked_vs_unchunked"] = err
    # latent_chunk chunks the chain only (as the JAX package's does): the
    # GAE encodes and decodes all 36 group images at once. Each stage's
    # peak above the memory held before it
    gae_gib = {}
    for stage, fn in (("encode", lambda: pipe.encode(cubes)),
                      ("decode", lambda: pipe.decode(pipe._unfold(x_init, CHUNK_CUBES)))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        gae_gib[stage] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    runs[CHUNKED][0]["gae_stage_peak_gib"] = gae_gib
    log(f"[{CHUNKED}] the GAE on {CHUNK_CUBES} cubes, peak above what is held: {gae_gib} GiB "
        f"(held before them: {held / 2 ** 30:.2f} GiB)")
    del pipe, cubes, x_init, noise
    torch.cuda.empty_cache()
    return runs


def run_tiled():
    """pavia_x4_tiled: one seeded SR cube of SCENE through the r3 pipeline's
    super_resolve_tiled(TILE, OVERLAP), a counted run (1320 fused launches),
    every tile's output kept; the scene's shape, finite, in [0, 1]; the last
    tile against super_resolve of the same patch drawing from the same
    generator (the tile's own of split_generator), within TOL_UNET."""
    import torch

    from hsi_dmgasr_tpu_torch.diffusion import split_generator

    config, diffusion, _ = PATHS[R3]
    pipe = build_pipeline(config, diffusion)
    scene = torch.rand(SCENE, generator=torch.Generator(device="cuda").manual_seed(12),
                       device="cuda")
    tiles, real = [], pipe.super_resolve

    def keep(*args, **kw):
        tiles.append(real(*args, **kw))
        return tiles[-1]

    with mock.patch.object(pipe, "super_resolve", keep):
        out, secs, peak, launches, fused_calls, flash_calls, up2_calls = counted_run(
            TILED, TILED_PER_SCENE, lambda: pipe.super_resolve_tiled(
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
    log(f"[{TILED}] {len(tiles)} tiles of {TILE}^2 (overlap {OVERLAP}) over {SCENE}: "
        f"{secs:.4f} s per scene, peak memory {peak:.2f} GiB; tile {k} at ({y0}, {x0}) vs "
        f"super_resolve of its patch from the same generator: {err}")
    if not within(tiles[k], want, TOL_UNET):
        raise AssertionError(f"[{TILED}] tile {k} vs super_resolve: {err}")
    report = {"config": config, "scene": SCENE, "tile": TILE, "overlap": OVERLAP,
              "tiles": len(tiles), "scene_seconds": secs, "peak_memory_gib": peak,
              "launches": launches, "tile_vs_super_resolve": err}
    del pipe, scene, out, tiles, want
    torch.cuda.empty_cache()
    return report, fused_calls, flash_calls, up2_calls


def run_train_remat(dirs, gae_ckpt, train_report):
    """train_r3_remat: train_r3's configuration with model.unet.remat off and
    on, each a fresh stage-2 pipeline from seed 0 on the GAE train_gae saved:
    the counts set to 0, one step's loss and gradients from the same HR
    crops and the same dropout generator, then REMAT_STEPS steps through
    train_step_from_hr (median after 2 warm-up) and their peak memory. The
    remat step's loss and every gradient within atol 1e-4, rtol 1e-3 of
    the plain step's; no kernel launched."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv

    opt = train_config(os.path.join(ROOT, "build", REMAT), dirs, gae_ckpt)
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]
    hr = torch.rand((opt["datasets"]["train"]["batch_size"], size, size, GAE_CFG["n_colors"]),
                    generator=torch.Generator(device="cuda").manual_seed(14), device="cuda")
    steps = {}
    fc.LAUNCHES = 0
    fa.LAUNCHES = 0
    bd.LAUNCHES = 0
    for remat in (False, True):
        opt["model"]["unet"]["remat"] = remat
        pipe = drv.build_pipeline(opt, seed=0)
        with torch.no_grad():
            sr = pipe._degrade_fn((size, size), opt["scale"])(hr)
            batch = {"HR": pipe._fold(pipe._encode(hr)), "SR": pipe._fold(pipe._encode(sr))}
        dropout = torch.Generator(device="cuda").manual_seed(15)
        loss = pipe.ddpm.compute_grads(batch, generator=dropout)
        grads = {n: p.grad.detach().clone() for n, p in pipe.ddpm.unet.named_parameters()}
        del batch, sr
        pipe.ddpm.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.train_step_from_hr(hr, scale=opt["scale"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        steps[remat] = {"loss": float(loss), "grads": grads, "step_seconds":
                        statistics.median(times[2:]), "step_times": times,
                        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del pipe
        torch.cuda.empty_cache()
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"[{REMAT}] the train steps launched {launches}, expected none")
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
    for key, st in (("plain", plain), ("remat", remat)):
        report[key] = {k: st[k] for k in ("step_seconds", "step_times", "peak_memory_gib")}
    report["slowdown"] = remat["step_seconds"] / plain["step_seconds"]
    log(f"[{REMAT}] remat vs plain step (same weights, crops, dropout generator): "
        f"{report['remat_vs_plain']}")
    if leaves or loss_err > TOL_REMAT_ABS + TOL_REMAT_REL * abs(plain["loss"]):
        raise AssertionError(f"[{REMAT}] remat step vs plain step: {report['remat_vs_plain']}")
    log(f"[{REMAT}] ms per step (median of {REMAT_STEPS - 2} after 2 warm-up): plain "
        f"{plain['step_seconds'] * 1e3:.2f}, remat {remat['step_seconds'] * 1e3:.2f} "
        f"({report['slowdown']:.3f}x); peak memory plain {plain['peak_memory_gib']:.2f} GiB, "
        f"remat {remat['peak_memory_gib']:.2f} GiB ({TRAIN}'s driver steps: "
        f"{train_report['peak_memory_gib']:.2f} GiB)")
    return report


def log_profile(name, prof):
    log(f"[{name}] profile: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}, "
        f"port kernel events {prof['kernel_events']}, stages {prof['stages']}")
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

    args = bench.parse_args([])
    model = bench.Bench(args, torch.device("cuda"))
    cube = bench.make_cube(args, model)
    reports = {}
    for name, t_start in ((BENCH, args.t_start), (BENCH_FULL, None)):
        out, _, peak_gib, launches, fused_calls, flash_calls, up2_calls = counted_run(
            name, BENCH_PATHS[name], lambda: model.super_resolve(cube, 2, t_start))
        check_cube(name, out, (args.batch, model.size, model.size, model.channels))
        del out
        reports[name] = ({"t_start": t_start, "peak_memory_gib": peak_gib,
                          "launches": launches}, fused_calls, flash_calls, up2_calls)

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
    steps, ema_errs, val, fused_calls, flash_calls, up2_calls = [], [], {}, {}, {}, {}
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
        val["train_launches"] = kernel_counts()
        fc.LAUNCHES = fa.LAUNCHES = 0
        zero_up2()
        zero_attention()
        with recording(fused_calls, flash_calls, up2_calls):
            res = real_validate(*args, **kw)
        torch.cuda.synchronize()
        val["launches"] = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
        val["split"], SPLIT_SIGS[TRAIN] = attention_routes(f"{TRAIN} validation")
        val["up2"] = up2_launches(f"{TRAIN} validation", TRAIN_VAL[FUSED] // BLOCKS_PER_FORWARD,
                                  up2_calls)
        return res

    zero_counts()
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
    if val.get("train_launches") != {FUSED: 0, FLASH: 0, DOT: 0, UP2: 0, SPLIT: 0}:
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
    val_pngs = decoded_pngs(os.path.join(opt["path"]["results"], "1"), {
        f"{TRAIN_STEPS}_{i}_{k}.png": (VAL_HW, VAL_HW, 3)
        for i in range(1, 4) for k in ("sr", "hr", "inf", "err")})
    log(f"[{TRAIN}] the validation's {len(val_pngs)} PNGs (3 bands of sr, hr and input, the "
        f"Jet error map) decode to {VAL_HW}^2 x 3")
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
              "ema_worst_rel_err": max(ema_errs),
              "launches": {**val["launches"], UP2: val["up2"], SPLIT: val["split"]["split"]}}
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
    return report, fused_calls, flash_calls, up2_calls


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
    within TOL_STEP_STATS of the CPU's). Returns the comparison and the
    card's step seconds."""
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(model.compute_grads(batch, t=t, noise=noise))
        grads = {n: p.grad.detach().cpu() for n, p in model.unet.named_parameters()}
        model.apply_gradients()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = {n: b.detach().cpu() for n, b in model.unet.named_buffers() if n in before}
        out[dev] = (loss, grads, stats, secs)
        log(f"[{SAMPLE}] one train step of {SAMPLE_BATCH} x {size}^2 x 3 on {dev}: {secs:.2f} s")
        del model
    (loss_cpu, g_cpu, s_cpu, _), (loss_gpu, g_gpu, s_gpu, step_s) = out["cpu"], out["cuda"]
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
    return res, step_s


def run_sample(profile):
    """Unconditional generation under configs/sample_ddpm_16.json at its full
    width on seeded orthogonal weights: counts to 0, one train step against
    the CPU's (sample_step_against_cpu), then DDPMModel.sample of SAMPLE_N
    images: one UNet forward timed first, and the config's 2000-step
    ancestral chain run when 2000 forwards take at most SAMPLE_CHAIN_S,
    else DDIM over SAMPLE_DDIM_STEPS. Checks the samples finite and no
    kernel launch; reads the peak memory."""
    import torch

    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    opt = sample_opt()
    fc.LAUNCHES = fa.LAUNCHES = bd.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    ddpm = DDPMModel(opt, seed=0)
    report = {"config": "sample_ddpm_16.json", "card_vs_cpu_step": None}
    report["card_vs_cpu_step"], report["train_step_seconds"] = sample_step_against_cpu(
        opt, {k: v.cpu() for k, v in ddpm.unet.state_dict().items()})
    size, T = opt["model"]["diffusion"]["image_size"], ddpm.val_diffusion.schedule.num_timesteps
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((SAMPLE_N, size, size, 3), generator=gen, device="cuda")
    t = torch.full((SAMPLE_N,), T - 1, dtype=torch.int32, device="cuda")
    times = []
    with torch.inference_mode():
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ddpm._denoise(x, t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    fwd_s = statistics.median(times[2:])
    ancestral = fwd_s * T <= SAMPLE_CHAIN_S
    if not ancestral:
        opt["model"]["diffusion"].update(sampler="ddim", ddim_steps=SAMPLE_DDIM_STEPS)
    chain = f"ancestral, {T} steps" if ancestral else f"DDIM, {SAMPLE_DDIM_STEPS} steps"
    log(f"[{SAMPLE}] one UNet forward (B={SAMPLE_N}, {size}^2): {fwd_s * 1e3:.2f} ms; x {T} = "
        f"{fwd_s * T:.1f} s against {SAMPLE_CHAIN_S} s: the chain is {chain}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ddpm.sample(SAMPLE_N, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
    log(f"[{SAMPLE}] sample of {tuple(out.shape)}: {secs:.2f} s ({chain}), peak memory "
        f"{peak_gib:.2f} GiB, kernel launches {launches}, range [{out.min().item():.3f}, "
        f"{out.max().item():.3f}]")
    if tuple(out.shape) != (SAMPLE_N, size, size, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[{SAMPLE}] samples {tuple(out.shape)} or non-finite values")
    if launches != {FUSED: 0, FLASH: 0, DOT: 0}:
        raise AssertionError(f"[{SAMPLE}] launched {launches}, expected no kernel")
    report.update(unet_forward_s=fwd_s, chain=chain, sample_seconds=secs,
                  peak_memory_gib=peak_gib, launches=launches)
    if profile:
        def forwards():
            with torch.inference_mode():
                for _ in range(10):
                    ddpm._denoise(x, t)

        report["profile"] = profile_cube(forwards, (("unet_forward",
                                                     lambda _: forwards()),))
        log_profile(SAMPLE, report["profile"])
    del ddpm, out, x
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
    t_cli = time.perf_counter()
    with mock.patch.object(GAETrainer, "train_step", timed_step):
        trainer = ae.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t_cli
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
              "roofline_share_f32": flops / step_s / (peak_tflops * 1e12), "launches": launches,
              "cli_seconds": cli_s, "cli_seconds_per_step": cli_s / TRAIN_GAE_STEPS}
    log(f"[{TRAIN_GAE}] the CLI: {cli_s:.2f} s for {TRAIN_GAE_STEPS} steps and the save (the "
        f"scenes' loading and the native resize included), {cli_s / TRAIN_GAE_STEPS:.3f} s a step")
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


def run_infer(profile, faces):
    """SR3 inference as a user runs it: ``cli.infer.main`` on
    configs/sr_sr3_16_128.json at full width with ``model.unet.fuse`` on and
    ``--process_mode grid``, on the card, over the first INFER_IMAGES
    images of ``faces``; the val schedule cut to INFER_T steps. Counts: 0
    before the CLI, read around each image's chain (exactly
    INFER_PER_IMAGE each) and at the end, while the launch signatures are
    recorded. Checks every written PNG decodes to its shape, each chain's
    output finite, one full-width B=1 forward and the first INFER_REPLAY
    steps of the chain (replayed from one seeded x_init and noise) with the
    kernels against their plain versions (TOL_UNET), and cli.eval's
    PSNR/SSIM over the written pairs finite. Times each image, one
    forward, and reads the peak memory."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hsi_dmgasr_tpu_torch.cli import eval as eval_cli
    from hsi_dmgasr_tpu_torch.cli import infer
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
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
    images, models, fused_calls, flash_calls, up2_calls = [], [], {}, {}, {}
    real_sr = DDPMModel.super_resolution

    def counted(self, cond, *a, **kw):
        torch.cuda.synchronize()
        n0, t0 = fc.LAUNCHES, time.perf_counter()
        out = real_sr(self, cond, *a, **kw)
        torch.cuda.synchronize()
        images.append({"s": time.perf_counter() - t0, "launches": fc.LAUNCHES - n0,
                       "shape": tuple(out.shape), "finite": bool(torch.isfinite(out).all())})
        models.append(self)
        return out

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(fused_calls, flash_calls, up2_calls), \
            mock.patch.object(DDPMModel, "super_resolution", counted):
        infer.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES}
    recorded = {FUSED: sum(fused_calls.values()), FLASH: sum(flash_calls.values())}
    want = {k: v * INFER_IMAGES for k, v in INFER_PER_IMAGE.items()}
    frames = 1 + len([t for t in range(INFER_T) if t % (1 | (INFER_T // 10)) == 0])
    log(f"[{INFER}] main path: {launches} kernel launches ({len(fused_calls)} fused signatures, "
        f"{recorded} recorded), per image {[im['launches'] for im in images]}, peak memory "
        f"{peak_gib:.2f} GiB, the CLI {cli_s:.2f} s")
    if (launches != want or recorded != want or bd.LAUNCHES or len(images) != INFER_IMAGES
            or any(im["launches"] != INFER_PER_IMAGE[FUSED] for im in images)):
        raise AssertionError(f"[{INFER}] {launches} launches ({recorded} recorded, "
                             f"{bd.LAUNCHES} blocked-dot), per image "
                             f"{[im['launches'] for im in images]}, expected {INFER_PER_IMAGE} "
                             f"per image")
    if any(not im["finite"] or im["shape"] != (frames, 128, 128, 3) for im in images):
        raise AssertionError(f"[{INFER}] chain outputs {images}")
    launches[UP2] = up2_launches(INFER, want[FUSED] // BLOCKS_PER_FORWARD, up2_calls)
    routes, SPLIT_SIGS[INFER] = attention_routes(INFER)
    launches[SPLIT] = routes["split"]
    results = os.path.join(root, "exp", "results")
    grid = (int(math.sqrt(frames)) * 128, math.ceil(frames / int(math.sqrt(frames))) * 128, 3)
    decoded_pngs(results, {f"{i}_{n}.png": (grid if n == "sr_process" else (128, 128, 3))
                           for i in range(INFER_IMAGES)
                           for n in ("sr", "hr", "inf", "sr_process")})
    image_s = statistics.median(im["s"] for im in images)
    log(f"[{INFER}] seconds per image (median of {INFER_IMAGES}; {INFER_T} B=1 UNet forwards "
        f"each): {image_s:.4f} {[im['s'] for im in images]}; {INFER_T / image_s:.1f} UNet "
        f"forwards/s; {frames}-frame process grids decode")

    model = models[0]
    unet, d = model.eval_unet, model.val_diffusion
    gen = torch.Generator(device="cuda").manual_seed(15)
    with torch.inference_mode():
        cond = torch.rand((1, 128, 128, 3), generator=gen, device="cuda") * 2 - 1
        x = torch.cat([cond, torch.randn(cond.shape, generator=gen, device="cuda")], -1)
        t = torch.full((1, 1), 0.5, device="cuda")
        unet_err = check_unet(INFER, unet, x, t)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unet(x, t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fwd_s = statistics.median(times[2:])
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
    log(f"[{INFER}] full-width UNet forward (B=1, 128^2): kernels vs plain {unet_err}; "
        f"forward {fwd_s * 1e3:.2f} ms (median of 5 after 2): x 2000 (the config's schedule) = "
        f"{fwd_s * 2000:.1f} s an image, x {INFER_T} = {fwd_s * INFER_T:.2f} s")
    log(f"[{INFER}] the chain's first {INFER_REPLAY} steps from one x_init and noise, kernels "
        f"vs plain: {chain_err}")
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
              "image_seconds": image_s, "image_times": [im["s"] for im in images],
              "unet_forwards_per_second": INFER_T / image_s, "cli_seconds": cli_s,
              "peak_memory_gib": peak_gib, "launches": launches,
              "unet_forward_s": fwd_s, "unet_forward_err": unet_err,
              "replayed_steps_err": chain_err, "eval": metrics}
    if profile:
        def image():
            with torch.inference_mode():
                model.super_resolution(cond, generator=gen, continous=True)

        def forward(_):
            with torch.inference_mode():
                return unet(x, t)

        prof = profile_cube(image, (("unet_forward", forward),))
        prof["fused_device_ms"] = sum(k["ms"] for k in prof["kernels"]
                                      if "gn_swish_conv3x3" in k["name"])
        report["profile"] = prof
        log_profile(INFER, prof)
        log(f"[{INFER}] one traced image: fused-Block device ms {prof['fused_device_ms']:.1f}, "
            f"idle share {prof['idle_share']:.4f}")
    del models, model, unet
    torch.cuda.empty_cache()
    return report, fused_calls, flash_calls, up2_calls


def run_sample_cli(faces):
    """Unconditional generation as a user runs it: ``cli.sample.main`` on
    configs/sample_ddpm_16.json at full width, both schedules cut to
    SAMPLE_CLI_T steps: ``-p train`` for SAMPLE_CLI_STEPS steps of the
    FACES images (print every 2, a checkpoint and a sample at the last),
    then ``-p val`` resuming that checkpoint through --resume
    (path.resume_state), one process grid and one final. Counts: 0 before,
    none after. Checks the files, that the val phase resumed the trained
    step, and times each sample."""
    import torch

    from hsi_dmgasr_tpu_torch.cli import sample
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
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
    samples, models = [], []
    real = DDPMModel.sample

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        models.append(self)
        return out

    fc.LAUNCHES = fa.LAUNCHES = bd.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(root, "train", "checkpoint", f"I{SAMPLE_CLI_STEPS}_E0")
    with mock.patch.object(DDPMModel, "sample", timed):
        for phase, extra in (("train", []), ("val", ["--resume", ckpt])):
            argv = ["-c", cfg, "-p", phase, "--experiments_root", os.path.join(root, phase)]
            log(f"[{SAMPLE_CLI}] python -m hsi_dmgasr_tpu_torch.cli.sample "
                f"{' '.join(argv + extra)}")
            t0 = time.perf_counter()
            sample.main(argv + extra)
            torch.cuda.synchronize()
            log(f"[{SAMPLE_CLI}] -p {phase}: {time.perf_counter() - t0:.2f} s")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES}
    if launches != {FUSED: 0, FLASH: 0, DOT: 0}:
        raise AssertionError(f"[{SAMPLE_CLI}] launched {launches}, expected no kernel")
    if not os.path.exists(os.path.join(ckpt, "state.pt")):
        raise AssertionError(f"[{SAMPLE_CLI}] no checkpoint {ckpt}")
    resumed = models[-1]
    if (resumed.begin_step, resumed.step) != (SAMPLE_CLI_STEPS, SAMPLE_CLI_STEPS):
        raise AssertionError(f"[{SAMPLE_CLI}] the val phase resumed at "
                             f"{(resumed.begin_step, resumed.step)}")
    frames = 1 + len([t for t in range(SAMPLE_CLI_T) if t % (1 | (SAMPLE_CLI_T // 10)) == 0])
    grid = (int(math.sqrt(frames)) * 128, math.ceil(frames / int(math.sqrt(frames))) * 128, 3)
    decoded_pngs(os.path.join(root, "train", "results"),
                 {f"{SAMPLE_CLI_STEPS}_sample.png": (128, 128, 3)})
    decoded_pngs(os.path.join(root, "val", "results"),
                 {"0_sample_process.png": grid, "sample_0.png": (128, 128, 3)})
    log(f"[{SAMPLE_CLI}] seconds per sample ({SAMPLE_CLI_T} ancestral steps, B=1): "
        f"{samples}, peak memory {peak_gib:.2f} GiB, kernel launches {launches}; the val phase "
        f"resumed step {resumed.step}; the PNGs decode")
    del models, resumed
    torch.cuda.empty_cache()
    return {"config": "sample_ddpm_16.json", "n_timestep": SAMPLE_CLI_T,
            "steps": SAMPLE_CLI_STEPS, "sample_seconds": samples, "peak_memory_gib": peak_gib,
            "launches": launches}


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


# ------------------------------------------------------------ the baseline zoo


def no_launches(name, launches, split=0):
    """No kernel launched but ``split`` launches of the split attention
    kernel (daq_refiners' post_unet: the router's count of its recorded
    calls; 0 elsewhere)."""
    if launches != {FUSED: 0, FLASH: 0, DOT: 0, UP2: 0, SPLIT: split}:
        raise AssertionError(f"[{name}] launched {launches}, expected no kernel but {split} "
                             "split attention launches")


def kernel_counts():
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc
    from hsi_dmgasr_tpu_torch.kernels import split_attention as sa
    from hsi_dmgasr_tpu_torch.kernels import up2_conv

    return {FUSED: fc.LAUNCHES, FLASH: fa.LAUNCHES, DOT: bd.LAUNCHES,
            UP2: up2_conv.LAUNCHES_BY_ROUTE["kernel"], SPLIT: sa.LAUNCHES}


def zero_counts():
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot as bd
    from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
    from hsi_dmgasr_tpu_torch.kernels import fused_conv as fc

    fc.LAUNCHES = fa.LAUNCHES = bd.LAUNCHES = 0
    zero_up2()
    zero_attention()


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
        t0 = time.perf_counter()
        loss, module = run(dev)
        out[dev] = (loss, {n: g.detach().double().cpu() for n, g in leaves(module).items()})
        log(f"[{name}] the f64 step on {dev}: {time.perf_counter() - t0:.2f} s")
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
    """The baseline zoo as a user runs it (see BASELINES above). Counts: 0
    before, none after. Per model: every step's loss finite, ms per train
    step (synchronised, the host's data loading outside it) and the CLI's
    seconds per step (with it), peak memory, seconds per test scene, the
    test metrics finite, the golden on the card, one f64 step on the card
    against the CPU's. Returns the report."""
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
    t_path = time.perf_counter()
    for name, scale in BASELINE_MODELS:
        steps = []

        def timed_step(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = real_step(self, *a, **kw)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t, "loss": float(loss)})
            return loss

        out = os.path.join(root, name)
        common = ["--model", name, "--n_colors", str(c), "--scale", str(scale)]
        argv = ["train", *common, "--data", dirs["mat"], "--max_steps", str(BASELINE_STEPS),
                "--out", out]
        log(f"[{BASELINES}] python -m hsi_dmgasr_tpu_torch.cli.baselines {' '.join(argv)}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(BaselineTrainer, "train_step", timed_step):
            trainer = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [st["loss"] for st in steps]
        if len(steps) != BASELINE_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"[{BASELINES}] {name}: {len(steps)} steps, losses {losses}")
        scenes = []

        def recorded_qa(x_true, x_pred, *a, **k):
            scenes.append((x_true, x_pred, real_qa(x_true, x_pred, *a, **k)))
            return scenes[-1][2]

        t0 = time.perf_counter()
        with mock.patch.object(cli, "quality_assessment", recorded_qa):
            qa = cli.main(["test", *common, "--data", test_dir, "--ckpt", out])
        test_s = time.perf_counter() - t0
        qa = {k: float(v) for k, v in qa.items()}  # numpy scalars, for the JSON report
        if len(scenes) != 1:
            raise AssertionError(f"[{BASELINES}] {name} tested {len(scenes)} scenes")
        constant = checked_metrics(f"{BASELINES}:{name}", scenes)
        rep = {"scale": scale, "losses": losses, "step_times": [st["s"] for st in steps],
               "step_seconds": statistics.median(st["s"] for st in steps[1:]),
               "cli_train_seconds": cli_s, "cli_seconds_per_step": cli_s / BASELINE_STEPS,
               "peak_memory_gib": peak_gib,
               "test_seconds_per_scene": test_s, "test": qa, "test_constant_bands": constant,
               "params": sum(p.numel() for p in trainer.model.parameters())}
        log(f"[{BASELINES}] {name} x{scale}: {rep['params']} params, losses {losses}; "
            f"ms per train step (median of steps 2-{BASELINE_STEPS}, {BASELINE_BATCH} crops of "
            f"{32 * scale}^2 x {c}) {rep['step_seconds'] * 1e3:.2f}; the CLI's train "
            f"{cli_s:.2f} s (data on the host, the native resize, included; "
            f"{cli_s / BASELINE_STEPS:.2f} s a step); peak memory {peak_gib:.2f} GiB; test "
            f"{test_s:.3f} s a scene, {qa} ({constant[0]} constant bands)")

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
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = model(x, lms)
            torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
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
        "forward_seconds": fwd_s, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card_vs_cpu_forward_f64": cpu_vs_card,
        "golden_max_abs_err": golden_on_card("cegatsr", pb.CEGATSR, kind=kind, kw=kw, atol=atol)}
    log(f"[{BASELINES}] cegatsr (defaults: n_subs 8, n_ovls 2, out_feats 64, 3 blocks, x4): "
        f"forward of {BASELINE_BATCH} x 32^2 x {c} in {fwd_s * 1e3:.2f} ms, peak memory "
        f"{report['models']['cegatsr']['peak_memory_gib']:.2f} GiB; {report['models']['cegatsr']}")
    del model, x, lms, y
    report["seconds"] = time.perf_counter() - t_path
    report["launches"] = launches = kernel_counts()
    no_launches(BASELINES, launches)
    log(f"[{BASELINES}] {report['seconds']:.1f} s, kernel launches {launches}")
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
    """The 3-D GAN as a user trains it (see GAN3D above). Counts: 0 before,
    none after. Checks every step's losses finite, both goldens on the card,
    the checkpoint back bit for bit, and one D step then one G step on the
    card against the CPU's in f64 (both losses, every gradient of both nets
    within TOL_STEP_GRAD of its leaf's largest, D's running statistics
    within TOL_STEP_STATS). Times each step (ms, synchronised) and reads
    the peak memory. Returns the report."""
    import numpy as np
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
    steps = []
    real_step = GAN3DTrainer.train_step

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g_loss, d_loss = real_step(self, *a, **kw)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t, "g": float(g_loss), "d": float(d_loss)})
        return g_loss, d_loss

    argv = ["--data", data, "--max_steps", str(GAN3D_STEPS), "--out", out]
    log(f"[{GAN3D}] python -m hsi_dmgasr_tpu_torch.cli.gan_train {' '.join(argv)}")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(GAN3DTrainer, "train_step", timed_step):
        trainer = gan_train.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = kernel_counts()
    no_launches(GAN3D, launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(steps) != GAN3D_STEPS or not all(math.isfinite(st[k]) for st in steps for k in "gd"):
        raise AssertionError(f"[{GAN3D}] steps {steps}")
    fresh = GAN3DTrainer(seed=5, device="cuda")
    fresh.load(out)
    for a, b in ((trainer.G, fresh.G), (trainer.D, fresh.D)):
        if not all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items()):
            raise AssertionError(f"[{GAN3D}] {out} did not load back bit for bit")
    report = {"cli": "cli.gan_train " + " ".join(argv), "launches": launches,
              "step_times": [st["s"] for st in steps],
              "step_seconds": statistics.median(st["s"] for st in steps[1:]),
              "losses": [(st["g"], st["d"]) for st in steps], "cli_seconds": cli_s,
              "peak_memory_gib": peak_gib}
    log(f"[{GAN3D}] {GAN3D_STEPS} steps (g, d) {report['losses']}; ms per step (D then G, "
        f"median of steps 2-{GAN3D_STEPS}, 4 tiles of 144^2 x 31) "
        f"{report['step_seconds'] * 1e3:.2f}; the CLI {cli_s:.2f} s; peak memory "
        f"{peak_gib:.2f} GiB; the checkpoint back bit for bit")

    report["golden_max_abs_err"] = {
        "G": golden_on_card("gan3d:G", pb.GAN3DGenerator, "gsd::", kw={"n_bands": 31},
                            x="g_x", y="g_y"),
        "D": golden_on_card("gan3d:D", pb.GAN3DDiscriminator, "dsd::", x="d_x", y="d_y")}

    # one D step then one G step, f64, card against CPU, from the trained nets
    lr_cube, hr = ICVLTiles(data, s=4, fis=36)[0]
    g_sd = {k: v.detach().cpu() for k, v in trainer.G.state_dict().items()}
    d_sd = {k: v.detach().cpu() for k, v in trainer.D.state_dict().items()}
    stats, losses = {}, {}

    def step(dev):
        """The D step's loss is returned (and held by grads_against_cpu); the
        G step's loss and D's running statistics are kept for below."""
        tr = GAN3DTrainer(device=dev)
        tr.G.load_state_dict(g_sd)
        tr.D.load_state_dict(d_sd)
        tr.G.double()
        tr.D.double()
        g_loss, d_loss = tr.train_step(lr_cube[None], hr[None])
        losses[dev] = g_loss.item()
        stats[dev] = {k: v.detach().double().cpu() for k, v in tr.D.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}
        return d_loss.item(), tr

    res = grads_against_cpu(
        GAN3D, step, lambda tr: {**{f"G.{n}": p.grad for n, p in tr.G.named_parameters()},
                                 **{f"D.{n}": p.grad for n, p in tr.D.named_parameters()}})
    res["g_loss_rel_err"] = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
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


def timed_steps(step, n=5, warmup=2):
    """Median milliseconds of ``step()`` (synchronised) after ``warmup``
    calls, and the peak memory over all of them (GiB)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2 ** 30


def run_daq_refiners():
    """daq_refiners (see DAQ above): for each module, its forward on the
    card (f32; the DAQ blocks on the first DAQ_HELD crops in f64, where no
    statistic lands on a rounding boundary by chance) against the CPU's,
    one f64 step on the card against the CPU's (grads_against_cpu), and ms
    per f32 train step (forward, backward of mean(y^2), Adam) with its
    peak memory. Counts: 0 before; after, no kernel but the split attention
    kernel, as often as the router sent the recorded attention calls there.
    Returns the report."""
    import torch

    from hsi_dmgasr_tpu_torch.models import refiners
    from hsi_dmgasr_tpu_torch.ops import quantize

    zero_counts()
    t_path = time.perf_counter()
    report = {}
    gen = torch.Generator().manual_seed(51)

    def seeded(ctor):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(52)
            return ctor()

    def held(name, ctor, inputs, f64_inputs, out_of, train=False):
        """The module's forward card vs CPU, its f64 step card vs CPU, its
        f32 train step's ms and peak memory."""
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
        m = seeded(ctor).cuda().train(train)
        opt = torch.optim.Adam(m.parameters(), lr=1e-4)
        x_card = tuple(a.cuda() for a in inputs)

        def train_step():
            opt.zero_grad(set_to_none=True)
            y = m(*x_card)
            loss = codebook_loss(y) if isinstance(m, refiners.Codebook) else out_of(y).pow(2).mean()
            loss.backward()
            opt.step()

        ms, gib = timed_steps(train_step)
        report[name] = {"forward_card_vs_cpu": err, "forward_dtype": str(dtype),
                        "card_vs_cpu_step": step_err, "ms_per_step": ms, "peak_memory_gib": gib,
                        "input": [list(a.shape) for a in inputs]}
        log(f"[{DAQ}] {name} on {[tuple(a.shape) for a in inputs]}: forward card vs CPU "
            f"({dtype}) {err}; f64 step {step_err}; {ms:.2f} ms per f32 step (forward, backward, "
            f"Adam), peak memory {gib:.2f} GiB")
        del m, opt, x_card
        torch.cuda.empty_cache()

    def codebook_loss(out):
        z_q, _, loss = out
        return z_q.sum() + loss

    with attention_recording():
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
    report["seconds"] = time.perf_counter() - t_path
    report["launches"] = launches = kernel_counts()
    routes, SPLIT_SIGS[DAQ] = attention_routes(DAQ)
    no_launches(DAQ, launches, routes["split"])
    log(f"[{DAQ}] {report['seconds']:.1f} s, kernel launches {launches}")
    return report


# ---------------------------------------------------- data-parallel ranks


def r3_dp_rank(rank, device, weights, seed):
    """One rank of pavia_x4_r3_dp: the r3 pipeline on the parent's weights
    with a 'data' mesh over the two ranks, the counts set to 0, one cube
    super-resolved (9 latents wrap-padded to 10, this rank's 5) while its
    launch signatures are recorded and the gathered latent is caught at the
    decode. Returns the counts, signatures, bytes gathered, peak memory,
    seconds and latent."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy

    use_f32_policy()
    torch.cuda.set_device(device)
    config, diffusion, _ = PATHS[R3]
    pipe = build_pipeline(config, diffusion, n_devices=2)
    mesh = pipe.ddpm.mesh
    state = torch.load(weights, map_location=device)
    pipe.gae.load_state_dict(state["gae"])
    pipe.ddpm.eval_unet.load_state_dict(state["unet"])
    cube = torch.rand(CUBE, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out, secs, peak_gib, launches, fused_calls, flash_calls, up2_calls = counted_run(
            f"{R3_DP}:rank{rank}", R3_DP_PER_RANK,
            lambda: pipe.super_resolve(cube, generator=torch.Generator(
                device="cuda").manual_seed(seed)))
    check_cube(R3_DP, out, CUBE)
    # one more cube, timed: the counted one also paid each launch's first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.super_resolve(cube, generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    torch.cuda.synchronize()
    timed = time.perf_counter() - t0
    batches = sorted({sig[0][0] for sig in fused_calls})
    if batches != [5]:
        raise AssertionError(f"[{R3_DP}] rank {rank} launched at batch sizes {batches}, "
                             "expected 5 (9 latents wrap-padded to 10 over 2 ranks)")
    return {"mesh": mesh.n_data, "launches": launches, "fused_calls": fused_calls,
            "flash_calls": flash_calls, "up2_calls": up2_calls,
            "split_calls": SPLIT_SIGS[f"{R3_DP}:rank{rank}"],
            "gathered_bytes": dict(mesh.gathered),
            "peak_memory_gib": peak_gib, "counted_seconds": secs, "seconds": timed,
            "latent": decode.call_args[0][0].cpu()}


def run_r3_dp():
    """pavia_x4_r3_dp: the r3 pipeline's single-process cube (its latent
    caught at the decode), its weights saved; then two ranks on the one card
    (multihost.launch over gloo, a file:// store), each checked for its
    counts (220 fused launches at B=5); the ranks' gathered latents equal;
    the data-parallel latent against the single-process one within
    TOL_UNET (the divergence reported). Returns its report and its ranks'
    launch signatures, summed."""
    import tempfile

    import torch

    from hsi_dmgasr_tpu_torch.parallel import multihost

    config, diffusion, _ = PATHS[R3]
    pipe = build_pipeline(config, diffusion)
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

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(r3_dp_rank, 2, f"file://{store}/rendezvous",
                             args=(weights, R3_DP_SEED))
    shutil.rmtree(store, ignore_errors=True)
    secs = time.perf_counter() - t0
    if [r["mesh"] for r in ranks] != [2, 2]:
        raise AssertionError(f"[{R3_DP}] the ranks' meshes: {[r['mesh'] for r in ranks]}")
    latents_equal = torch.equal(ranks[0]["latent"], ranks[1]["latent"])
    err = divergence(ranks[0]["latent"], single)
    log(f"[{R3_DP}] ({TWO_RANKS}) the ranks' gathered latents equal: {latents_equal}; the "
        f"data-parallel latent vs the single process's from the same draws: {err} (TOL_UNET "
        f"{TOL_UNET})")
    if not latents_equal or not within(ranks[0]["latent"], single, TOL_UNET):
        raise AssertionError(f"[{R3_DP}] latents equal {latents_equal}, vs single {err}")
    fused_calls, flash_calls, up2_calls = {}, {}, {}
    for r in ranks:
        for mine, calls in ((fused_calls, r["fused_calls"]), (flash_calls, r["flash_calls"]),
                            (up2_calls, r["up2_calls"])):
            for sig, n in calls.items():
                mine[sig] = mine.get(sig, 0) + n
    launches = {k: sum(r["launches"][k] for r in ranks) for k in (FUSED, FLASH, UP2, SPLIT)}
    SPLIT_SIGS[R3_DP] = merged_split(ranks)
    report = {"config": config, "note": TWO_RANKS, "launches": launches,
              "launches_per_rank": [r["launches"] for r in ranks],
              "cube_seconds": [r["seconds"] for r in ranks],
              "counted_cube_seconds": [r["counted_seconds"] for r in ranks],
              "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
              "gathered_bytes_per_cube": [r["gathered_bytes"] for r in ranks],
              "dp_vs_single": err, "ranks_seconds": secs}
    log(f"[{R3_DP}] ({TWO_RANKS}) cube seconds per rank {report['cube_seconds']} (the counted "
        f"cube {report['counted_cube_seconds']}); peak memory "
        f"per rank {[round(g, 2) for g in report['peak_memory_gib']]} GiB; bytes gathered "
        f"{report['gathered_bytes_per_cube']}; launches per rank {report['launches_per_rank']}; "
        f"the ranks took {secs:.1f} s in all")
    return report, fused_calls, flash_calls, up2_calls


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
    and the GAE), each on TRAIN_DP_CROPS HR crops drawn from ``hr_seed``,
    timed (synchronised). Returns the pipeline, losses, step times and the
    first step's gradients (on the CPU)."""
    import torch

    from hsi_dmgasr_tpu_torch.train import stage2_driver as drv

    pipe = drv.build_pipeline(opt, seed=0, device=device)
    pipe.ddpm.unet.load_state_dict(state)
    gen = torch.Generator(device="cuda").manual_seed(hr_seed)
    size = opt["datasets"]["train"]["l_resolution"] * opt["scale"]
    losses, times, grads = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_DP_STEPS):
        hr = torch.rand((TRAIN_DP_CROPS, size, size, GAE_CFG["n_colors"]), generator=gen,
                        device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(pipe.train_step_from_hr(hr, scale=opt["scale"])))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if grads is None:  # the step leaves its (all-reduced) gradients in place
            grads = {n: p.grad.detach().cpu() for n, p in pipe.ddpm.unet.named_parameters()}
    return pipe, losses, times, grads


def train_dp_rank(rank, device, opt, weights, one_rank):
    """One rank of train_r3_dp: TRAIN_DP_STEPS steps from the parent's
    weights with a 'data' mesh over the two ranks (18 of the 36 latents a
    step), then its state against the one-rank run's (rank 0) and its
    digest, and one validation cube under the fused Blocks (its 9 latents
    padded to 10, B=5 a rank) with its launches counted."""
    import torch

    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.parallel.multihost import synchronize

    use_f32_policy()
    torch.cuda.set_device(device)
    zero_counts()
    pipe, losses, times, grads = train_dp_steps(opt, torch.load(weights, map_location=device),
                                                TRAIN_DP_SEED, device)
    ddpm = pipe.ddpm
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    train_launches = kernel_counts()
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
    synchronize()  # rank 0 compared its state first: start the timed cube together
    with mock.patch.object(pipe, "decode", wraps=pipe.decode) as decode:
        out, secs, _, launches, fused_calls, flash_calls, up2_calls = counted_run(
            f"{TRAIN_DP}:rank{rank}", TRAIN_DP_VAL_PER_RANK,
            lambda: pipe.super_resolve(val, generator=torch.Generator(
                device="cuda").manual_seed(6)))
    check_cube(TRAIN_DP, out, tuple(val.shape))
    return {"mesh": ddpm.mesh.n_data, "losses": losses, "times": times, "peak_memory_gib": peak_gib,
            "train_launches": train_launches, "worst_leaf_rel_err": worst, "digest": digest,
            "reduced_bytes": reduced, "val_launches": launches, "val_seconds": secs,
            "fused_calls": fused_calls, "flash_calls": flash_calls, "up2_calls": up2_calls,
            "split_calls": SPLIT_SIGS[f"{TRAIN_DP}:rank{rank}"],
            "val_latent": decode.call_args[0][0].cpu()}


def run_train_r3_dp(dirs, gae_ckpt):
    """train_r3_dp (see TRAIN_DP above): the one-rank run of TRAIN_DP_STEPS
    steps from seeded weights (its final weights, EMA and Adam state saved),
    then the same steps over two ranks on the one card from the same
    weights and draws: rank 0's first gradients and state against the
    one-rank run's (the gates under TRAIN_DP above), the ranks' states
    bit for bit alike (digests), no kernel launch in the steps, and each
    rank's validation cube with its launches. Returns its report and the
    validation's launch signatures, summed over the ranks."""
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
    pipe, losses, times, grads = train_dp_steps(opt, init, TRAIN_DP_SEED, "cuda")
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_rank = os.path.join(work, "one_rank.pt")
    torch.save({**{k: v.detach().cpu() for k, v in train_state(pipe.ddpm).items()},
                **{f"grad.{n}": g for n, g in grads.items()}}, one_rank)
    del grads
    one_ms = statistics.median(times[1:]) * 1e3
    log(f"[{TRAIN_DP}] one rank: losses {losses}, ms per step {[round(t * 1e3, 2) for t in times]}")
    del pipe, init
    torch.cuda.empty_cache()

    opt2 = copy.deepcopy(opt)
    opt2["n_devices"] = 2
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="store-", dir=work)
    ranks = multihost.launch(train_dp_rank, 2, f"file://{store}/rendezvous",
                             args=(opt2, weights, one_rank))
    shutil.rmtree(store, ignore_errors=True)
    secs = time.perf_counter() - t0
    for f in (weights, one_rank):
        os.remove(f)
    if [r["mesh"] for r in ranks] != [2, 2]:
        raise AssertionError(f"[{TRAIN_DP}] the ranks' meshes: {[r['mesh'] for r in ranks]}")
    for r in ranks:
        no_launches(f"{TRAIN_DP} steps", r["train_launches"])
    alike = ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["losses"] == ranks[1]["losses"]
    worst = ranks[0]["worst_leaf_rel_err"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], losses))
    val_equal = torch.equal(ranks[0]["val_latent"], ranks[1]["val_latent"])
    log(f"[{TRAIN_DP}] ({TWO_RANKS}) the ranks' weights, EMA and Adam state bit for bit alike: "
        f"{alike}; rank 0 vs the one-rank run, worst leaf over its largest |value|: {worst}; "
        f"losses {ranks[0]['losses']} vs {losses} (worst rel {loss_err:.2e}); validation "
        f"latents alike: {val_equal}")
    off = (worst["grad_max_abs_over_max_g"] > TOL_STEP_GRAD
           or worst["unet_share_off"] > TRAIN_DP_SHARE_OFF or worst["adam"] > TOL_TRAIN_DP_ADAM)
    if not alike or not val_equal or off or loss_err > TOL_STEP_LOSS:
        raise AssertionError(f"[{TRAIN_DP}] alike {alike}, val {val_equal}, worst {worst}, "
                             f"loss {loss_err}")
    fused_calls, flash_calls, up2_calls = {}, {}, {}
    for r in ranks:
        for mine, calls in ((fused_calls, r["fused_calls"]), (flash_calls, r["flash_calls"]),
                            (up2_calls, r["up2_calls"])):
            for sig, n in calls.items():
                mine[sig] = mine.get(sig, 0) + n
    launches = {k: sum(r["val_launches"][k] for r in ranks) for k in (FUSED, FLASH, UP2, SPLIT)}
    SPLIT_SIGS[TRAIN_DP] = merged_split(ranks)
    step_ms = [statistics.median(r["times"][1:]) * 1e3 for r in ranks]
    reduced = [r["reduced_bytes"].get("gradients", 0) / TRAIN_DP_STEPS for r in ranks]
    report = {"note": TWO_RANKS, "steps": TRAIN_DP_STEPS, "latents_per_step": TRAIN_DP_CROPS * 9,
              "ms_per_step": step_ms, "one_rank_ms_per_step": one_ms,
              "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
              "one_rank_peak_memory_gib": one_peak,
              "allreduced_bytes_per_step": reduced, "worst_leaf_rel_err": worst,
              "loss_rel_err": loss_err, "launches": launches,
              "val_seconds": [r["val_seconds"] for r in ranks], "ranks_seconds": secs}
    log(f"[{TRAIN_DP}] ({TWO_RANKS}) ms per step per rank (median of steps 2-{TRAIN_DP_STEPS}) "
        f"{[round(m, 2) for m in step_ms]} against one rank's {one_ms:.2f}; peak memory per rank "
        f"{[round(g, 2) for g in report['peak_memory_gib']]} GiB (one rank {one_peak:.2f}); bytes "
        f"all-reduced a step per rank {reduced}; validation launches {launches}; the ranks took "
        f"{secs:.1f} s in all")
    return report, fused_calls, flash_calls, up2_calls


def kernel_entry(name, source, replaces, rows, launches):
    """The kernels-line entry: times summed over the counted main-path
    runs (launches of each signature x time per launch), per path too.
    ``launches`` maps each path that runs the kernel to its count."""
    paths = {}
    for path in launches:
        n = {k: sum(r["counts"].get(path, 0) * r[k] for r in rows)
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
    runs = {path: run_path(path, config, diffusion, expected, cube, args.profile)
            for path, (config, diffusion, expected) in PATHS.items()}
    log(f"[{R3_DDIM}] cube seconds {runs[R3_DDIM][0]['cube_seconds']:.4f} beside "
        f"{R3}'s {runs[R3][0]['cube_seconds']:.4f} (4 UNet forwards each)")
    del cube
    torch.cuda.empty_cache()
    runs[SPATIAL] = run_spatial()
    runs[R3_DP] = run_r3_dp()
    runs.update(run_bench(args.profile))
    dirs = make_train_data(os.path.join(ROOT, "build", "scenes"))
    report["paths"][TRAIN_GAE], gae_ckpt = run_train_gae(args.profile, dirs)
    runs[TRAIN] = run_train(args.profile, dirs, gae_ckpt)
    torch.cuda.empty_cache()
    runs[TRAIN_DP] = run_train_r3_dp(dirs, gae_ckpt)
    report["paths"][SAMPLE] = run_sample(args.profile)
    faces = make_faces(os.path.join(ROOT, "build", "faces"))
    runs[INFER] = run_infer(args.profile, faces)
    report["paths"][SAMPLE_CLI] = run_sample_cli(faces)
    # the memory modes run after every other path, so that those paths'
    # peak-memory readings do not depend on the large B=36 and tiled
    # allocations before them
    torch.cuda.empty_cache()
    runs.update(run_chunked())
    runs[TILED] = run_tiled()
    report["paths"][REMAT] = run_train_remat(dirs, gae_ckpt, runs[TRAIN][0])
    torch.cuda.empty_cache()
    report["paths"][BASELINES] = run_baselines(dirs)
    report["paths"][GAN3D] = run_gan3d()
    torch.cuda.empty_cache()
    report["paths"][DAQ] = run_daq_refiners()
    report["color_correction_max_abs"] = check_color_correction()
    fused_sigs, flash_sigs, up2_sigs = {}, {}, {}
    for path, (path_report, fused_calls, flash_calls, up2_calls) in runs.items():
        report["paths"][path] = path_report
        for sigs, calls in ((fused_sigs, fused_calls), (flash_sigs, flash_calls),
                            (up2_sigs, up2_calls)):
            for sig, n in calls.items():
                sigs.setdefault(sig, dict.fromkeys(UNET_PATHS, 0))[path] = n
    report["paths"][PROBE] = probe = run_probe()
    split_sigs = {}
    for path in SPLIT_PATHS:
        for sig, n in SPLIT_SIGS.get(path, {}).items():
            split_sigs.setdefault(sig, dict.fromkeys(SPLIT_PATHS, 0))[path] = n

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
    flash_all = list(flash_sigs.items()) + extra
    torch.cuda.empty_cache()
    for i, (sig, counts) in enumerate(flash_all):
        row = check_flash(sig, 200 + i)
        row["counts"] = counts
        flash_rows.append(row)
        err = row["errors"]["out"]
        log(f"flash {row['signature']:<30} {counts} abs {err['max_abs']:.2e} rel "
            f"{err['max_rel']:.2e} | ms {row['ms']:.3f} ({row['tflops']:.1f} TFLOP/s; prepass "
            f"{row['prepass_ms']:.3f} ms, {row['prepass_share']:.3f} of it; attention kernel "
            f"{row['attention_kernel_ms']:.3f}) plain "
            f"{row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
            f"einsum {row['einsum_ms']:.3f} bound {row['bound_ms']:.3f} ({row['bound_by']})")
        torch.cuda.empty_cache()
    split_rows = []
    for i, (sig, counts) in enumerate(sorted(split_sigs.items(), key=lambda kv: kv[0][0])):
        row = check_split(sig, 400 + i)
        row["counts"] = counts
        split_rows.append(row)
        err = row["errors"]["out"]
        log(f"split {row['signature']:<30} {counts} abs {err['max_abs']:.2e} ({err['of_bound']:.2e} "
            f"of (1 + 2A) W) | ms {row['ms']:.3f} ({row['tflops']:.1f} TFLOP/s counted once; split "
            f"{row['split_ms']:.3f}, logits {row['logits_ms']:.3f}, p.v {row['pv_ms']:.3f}) plain "
            f"{row['plain_ms']:.3f} einsum {row['einsum_ms']:.3f} bound {row['bound_ms']:.3f} "
            f"({row['bound_by']})")
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
    up2 = up2_rows(up2_sigs)
    report["fused_signatures"], report["flash_signatures"] = fused_rows, flash_rows
    report["dot_signatures"], report["up2_signatures"] = dot_rows, up2
    report["split_signatures"] = split_rows
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
        return {p: report["paths"][p]["launches"][kernel] for p in (*UNET_PATHS, *ZOO_PATHS)}

    entries = [
        kernel_entry(FUSED, "hsi_dmgasr_tpu_torch/csrc/fused_conv.cu",
                     "hsi_dmgasr_tpu/kernels/fused_conv.py:824", fused_rows, launches(FUSED)),
        kernel_entry(FLASH, "hsi_dmgasr_tpu_torch/csrc/flash_attention.cu",
                     "hsi_dmgasr_tpu/kernels/flash_attention.py:119", flash_rows,
                     launches(FLASH)),
        kernel_entry(UP2, "hsi_dmgasr_tpu_torch/csrc/up2_conv.cu",
                     "none (hsi_dmgasr_tpu/ops/fused_up.py:up2_conv3x3 is XLA's)", up2,
                     launches(UP2)),
        kernel_entry(SPLIT, "hsi_dmgasr_tpu_torch/csrc/split_attention.cu",
                     "none (hsi_dmgasr_tpu/kernels/attention.py:_xla_attention is XLA's)",
                     split_rows, {p: report["paths"][p]["launches"][SPLIT] for p in SPLIT_PATHS}),
        kernel_entry(DOT, "hsi_dmgasr_tpu_torch/csrc/blocked_dot.cu",
                     "tools/microbench_int8.py:88", dot_rows,
                     {PROBE: probe["launches"][DOT],
                      **{p: report["paths"][p]["launches"][DOT] for p in ZOO_PATHS}}),
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
                       for p in (*PATHS, BENCH, TRAIN_GAE, TRAIN, SAMPLE, INFER)}, f,
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
