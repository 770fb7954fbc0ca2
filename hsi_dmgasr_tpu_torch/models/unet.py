"""SR3/DDPM denoising UNet (PyTorch, NHWC activations).

Port of ``hsi_dmgasr_tpu/models/unet.py``. One module covers both
reference variants (reference model/networks.py:85-88 picks per
``which_model_G``):

  * SR3 (``time_embedding="continuous"``, ``norm="group"``): the WaveGrad
    encoding of the continuous noise level, GroupNorm, additive noise
    injection x + Linear(emb) (sr3_modules/unet.py:18-263);
  * DDPM (``time_embedding="discrete"``, ``norm="batch"``): the sinusoidal
    embedding of the integer timestep, BatchNorm with flax's rules (the
    biased batch variance and momentum 0.9 for the running statistics),
    injection x + Linear(swish(emb)) (ddpm_modules/unet.py:19-110).

Module names give the reference's torch keys (``noise_level_mlp.1`` or
``time_mlp.1``, ``downs.N``, ``mid.N``, ``ups.N``, ``block1.block.0/3``,
``noise_func.noise_func.0`` or ``mlp.1``, ``res_conv``,
``attn.norm/qkv/out``, ``final_conv.block.0/3``), so reference ``.pth``
state_dicts load directly.

``fuse_blocks=True`` (in eval mode) runs every GroupNorm resblock Block
and the final conv through the fused GroupNorm -> swish -> conv3x3 kernel
(kernels/fused_conv.py) with the JAX package's routing: block1 takes the
time bias, emits its output's per-row moments and folds the 1x1
res_conv; block2 takes the residual and block1's moments; the skip stack
carries (tensor, moments) so up-path GroupNorms need no stats pass; the
skip rides the kernel as a second source per ``fuse_skip`` ("auto": only
when dim_out < 128), and boundary convs and attention reset the moment
chain. ``fuse_stats=False`` turns the moment chain off (every fused
GroupNorm reduces its own input). The kernel is a GroupNorm kernel: the
BatchNorm variant keeps its Blocks unfused, as the JAX package's gate
does, and only its up path takes the exact dilated conv.

``spatial`` (the JAX package's ``spatial_axis``), a ``parallel.mesh.Mesh``
passed to ``forward``, runs the fused inference forward on this rank's
H-shard of every activation: the fused Blocks get their neighbours' halo
rows and the whole image's GroupNorm moments, the initial conv and the
downsamples are ``conv3x3_spatial``, the upsamples
``up2_conv3x3_spatial``, and attention gathers its input over 'space',
runs the single-device block and keeps its own rows. Any unfused Block
under ``spatial`` raises ``NotImplementedError``, as in the JAX package.

``remat`` (``model.unet.remat``) recomputes each resblock in the backward
instead of keeping its activations (``torch.utils.checkpoint``, the JAX
package's ``nn.remat`` of ``ResnetBlocWithAttn``), only while autograd
records: at inference and on the fused path it changes nothing. The
recompute replays each block's dropout masks from its generator's state
at the forward and leaves BatchNorm's running statistics where the
forward moved them, so a step with remat is the step without it.

Mixed precision follows the JAX package: the module's dtype is its
weights' (``.to(torch.bfloat16)`` for bf16 inference), the activations
follow the input's dtype, the norms compute in f32 and round once, and
the noise encoding stays in the noise level's dtype.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import spatial_attention
from ..kernels import up2_conv
from ..kernels.fused_conv import gn_swish_conv3x3, pack_conv3x3
from ..ops.blocks import Conv2d
from ..ops.fused_up import parity_taps, up2_conv3x3
from ..parallel.spatial import (conv3x3_spatial, exchange_halo, gather_rows,
                                up2_conv3x3_spatial)
from ..utils.profiling import traced

_SPATIAL_UNFUSED = ("spatial sharding requires the fused inference path "
                    "(fuse_blocks, GroupNorm, eval mode)")


def swish(x):
    return x * torch.sigmoid(x)


def continuous_noise_encoding(noise_level, dim):
    """WaveGrad positional encoding of gamma (sr3_modules/unet.py:18-31):
    (B, 1) -> (B, dim) as [sin(g e^-k), cos(g e^-k)]."""
    count = dim // 2
    step = torch.arange(count, dtype=noise_level.dtype, device=noise_level.device) / count
    enc = noise_level * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], -1)


def discrete_time_encoding(t, dim):
    """Sinusoidal embedding of the integer timestep (ddpm_modules/unet.py:19-34):
    (B,) -> (B, dim) as [sin(t f), cos(t f)], f = 10000^(-2k/dim), in f32."""
    inv_freq = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / dim))
    sin_in = t.reshape(-1).float()[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(sin_in), torch.cos(sin_in)], -1)


class TimeEmbedding(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return discrete_time_encoding(t, self.dim)


class PositionalEncoding(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level):
        return continuous_noise_encoding(noise_level, self.dim)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class GroupNorm(nn.GroupNorm):
    """torch.nn.GroupNorm on NHWC tensors, computed in f32 (the weights
    promoted) and rounded once to x.dtype, as the JAX package's ``GN``."""

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2).float(), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over every axis but the last of channels-last tensors
    (N, H, W of NHWC; N, D, H, W of NDHWC, the 3-D GAN's discriminator) with
    flax's rules (the JAX package's ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)``), computed in f32 (f64 for an f64 input) and rounded
    once to x.dtype. In train mode it normalises with the batch's mean and
    its biased variance E[x^2] - E[x]^2 (clipped at 0), and moves the
    running statistics by running = 0.9 running + 0.1 batch with that same
    biased variance (torch's own rule would take the
    unbiased one); in eval mode it normalises with the running statistics.
    The buffers keep torch's names, so reference state_dicts load.

    With ``mesh`` set (``parallel.data_parallel.sync_batchnorm``, a data
    mesh of more than 1) the train-mode moments are the global batch's:
    the sum, the sum of squares and the count are all-reduced over the
    ranks, as XLA reduces them over the JAX package's mesh."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.decay = momentum  # flax's momentum: the running statistics' weight
        self.recomputing = False  # set during a remat recompute: the forward moved them
        self.mesh = None

    def _moments(self, xf):
        axes = tuple(range(xf.dim() - 1))
        if self.mesh is None:
            mean = xf.mean(axes)
            return mean, (xf * xf).mean(axes)
        from ..parallel.data_parallel import AllReduceSum

        count = torch.full((1,), xf.numel() // xf.shape[-1], dtype=xf.dtype, device=xf.device)
        sums = AllReduceSum.apply(torch.cat([xf.sum(axes), (xf * xf).sum(axes), count]),
                                  self.mesh, "batchnorm")
        c = xf.shape[-1]
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32, or f64 for f64
        if self.training:
            mean, mean_sq = self._moments(xf)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            if not self.recomputing:
                with torch.no_grad():
                    self.running_mean.copy_(self.decay * self.running_mean
                                            + (1 - self.decay) * mean)
                    self.running_var.copy_(self.decay * self.running_var
                                           + (1 - self.decay) * var)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype))
             + self.bias.to(xf.dtype))
        return y.to(x.dtype)


def make_norm(norm, channels, groups):
    """GroupNorm(groups) or BatchNorm, eps 1e-5 (the JAX package's ``Norm``)."""
    if norm == "group":
        return GroupNorm(groups, channels, eps=1e-5)
    if norm == "batch":
        return BatchNorm(channels)
    raise ValueError(f"norm {norm!r}: 'group' or 'batch'")


class Dropout(nn.Module):
    """Dropout whose mask is drawn from ``self.generator`` (set by the
    trainer for each step, so a step is a function of its seed), as
    flax's: keep with probability 1 - p and scale the kept by 1/(1 - p).
    The identity in eval mode. With ``self.rows`` = (n, start, stop), x
    holds rows start:stop of a global batch of n (a data-parallel rank):
    the global batch's mask is drawn and cut, so the ranks' masks are the
    single process's."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None
        self.rows = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        shape = x.shape if self.rows is None else (self.rows[0], *x.shape[1:])
        keep = torch.empty(shape, device=x.device).bernoulli_(keep_prob,
                                                              generator=self.generator)
        if self.rows is not None:
            keep = keep[self.rows[1]:self.rows[2]]
        return torch.where(keep.bool(), x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def packed_once(module, weights, pack):
    """``pack()``, kept on ``module`` until one of ``weights`` changes: the
    key is each weight's (data_ptr, _version, device), so an in-place update
    (Adam, the EMA), a load_state_dict or a move repacks."""
    key = tuple((w.data_ptr(), w._version, w.device) for w in weights)
    if key != module._packed_key:
        module._packed, module._packed_key = pack(), key
    return module._packed


def remat_contexts(block):
    """The (forward, recompute) contexts of one ``checkpoint`` of ``block``.
    checkpoint restores only the global RNGs for its recompute; a Dropout
    here draws from its own generator, which has moved on by then. So the
    forward notes each generator's state, the recompute runs from it and
    then puts the generator back where it was; and the recompute does not
    move BatchNorm's running statistics a second time."""
    gens = {id(m.generator): m.generator for m in block.modules()
            if isinstance(m, Dropout) and m.generator is not None and m.training}
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    at_forward = {}

    @contextmanager
    def forward():
        at_forward.update((k, g.get_state()) for k, g in gens.items())
        yield

    @contextmanager
    def recompute():
        now = {k: g.get_state() for k, g in gens.items()}
        for k, g in gens.items():
            g.set_state(at_forward[k])
        for m in norms:
            m.recomputing = True
        try:
            yield
        finally:
            for k, g in gens.items():
                g.set_state(now[k])
            for m in norms:
                m.recomputing = False

    return forward(), recompute()


class Block(nn.Module):
    """norm -> swish -> dropout -> 3x3 conv (sr3_modules/unet.py:80-91).

    ``forward`` is the reference Block; ``fused`` runs the same Block
    through the fused kernel with its extras, using weights packed once
    per weight version (a load_state_dict repacks)."""

    def __init__(self, dim, dim_out, groups=32, dropout=0.0, norm="group"):
        super().__init__()
        self.block = nn.Sequential(
            make_norm(norm, dim, groups), Swish(),
            Dropout(dropout) if dropout else nn.Identity(),
            Conv2d(dim, dim_out, 3))
        self._packed = None
        self._packed_key = None

    def forward(self, x):
        return self.block(x)

    def _pack(self, res_conv):
        convs = (self.block[3],) if res_conv is None else (self.block[3], res_conv)
        return packed_once(self, [c.weight for c in convs], lambda: pack_conv3x3(
            *(c.weight.permute(2, 3, 1, 0) for c in convs)))

    def fused(self, x, time_bias=None, residual=None, x2=None, stats_in=None,
              emit_stats=False, res_conv=None, stats_in2=None, spatial=None):
        """Under ``spatial`` x (and x2) are H-shards: their halo rows are
        exchanged and handed to the kernel with the mesh."""
        gn, conv = self.block[0], self.block[3]
        res_k = res_b = None
        if res_conv is not None:
            res_k, res_b = res_conv.weight.permute(2, 3, 1, 0), res_conv.bias
        halo = halo2 = None
        if spatial is not None:
            halo = exchange_halo(x, spatial)
            if x2 is not None:
                halo2 = exchange_halo(x2, spatial)
        return gn_swish_conv3x3(
            x, gn.weight, gn.bias, conv.weight.permute(2, 3, 1, 0), conv.bias,
            time_bias=time_bias, residual=residual, x2=x2, stats_in=stats_in,
            num_groups=gn.num_groups, eps=gn.eps, emit_stats=emit_stats,
            res_kernel=res_k, res_bias=res_b, stats_in2=stats_in2,
            mesh=spatial, halo=halo, halo2=halo2,
            packed=self._pack(res_conv) if x.is_cuda else None)


class FeatureWiseAffine(nn.Module):
    """Additive noise-level conditioning, x + Linear(emb)
    (sr3_modules/unet.py:34-50, use_affine_level=False)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(in_channels, out_channels))

    def bias(self, emb):
        return self.noise_func(emb)

    def forward(self, x, emb):
        return x + self.noise_func(emb)[:, None, None, :]


class ResnetBlock(nn.Module):
    """block1 -> noise injection -> block2 -> + res_conv(x)
    (sr3_modules/unet.py:94-111). The injection is SR3's ``noise_func``,
    x + Linear(emb), or with ``discrete`` the DDPM variant's ``mlp``,
    x + Linear(swish(emb)) (ddpm_modules/unet.py:82-95)."""

    def __init__(self, dim, dim_out, noise_level_emb_dim=None, dropout=0.0,
                 norm_groups=32, fuse=False, fuse_skip="auto", fuse_stats=True,
                 norm="group", discrete=False):
        super().__init__()
        self.dim_out = dim_out
        # the fused kernel is a GroupNorm kernel (the JAX package's gate)
        self.fuse = fuse and norm == "group"
        # the skip rides the kernel as x2 ("auto": while dim_out under-fills
        # the JAX package's 128-lane tile), else the concat is materialised
        self.fuse_skip = dim_out < 128 if fuse_skip == "auto" else bool(fuse_skip)
        self.fuse_stats = fuse_stats
        self.noise_func = self.mlp = None
        if noise_level_emb_dim and discrete:
            self.mlp = nn.Sequential(Swish(), nn.Linear(noise_level_emb_dim, dim_out))
        elif noise_level_emb_dim:
            self.noise_func = FeatureWiseAffine(noise_level_emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups, norm=norm)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups, dropout=dropout, norm=norm)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, emb, x2=None, stats_in=None, emit_stats=False,
                x2_stats=None, spatial=None):
        """Returns (out, stats); stats are the output's per-row moments
        on the fused path with ``emit_stats``, else None."""
        if self.fuse and not self.training:
            return self._fused(x, emb, x2, stats_in, emit_stats, x2_stats, spatial)
        if spatial is not None:
            raise NotImplementedError(_SPATIAL_UNFUSED)
        xin = torch.cat([x, x2], -1) if x2 is not None else x
        h = self.block1(xin)
        if self.noise_func is not None:
            h = self.noise_func(h, emb)
        elif self.mlp is not None:
            h = h + self.mlp(emb)[:, None, None, :]
        return self.block2(h) + self.res_conv(xin), None

    def _fused(self, x, emb, x2, stats_in, emit_stats, x2_stats, spatial):
        if x2 is not None and not self.fuse_skip:
            # concat, and concat the moments when both are known
            x = torch.cat([x, x2], -1)
            both = stats_in is not None and x2_stats is not None
            stats_in = torch.cat([stats_in, x2_stats], -1) if both else None
            x2 = x2_stats = None
        emit_stats = emit_stats and self.fuse_stats
        c_in = x.shape[-1] + (x2.shape[-1] if x2 is not None else 0)
        tb = self.noise_func.bias(emb) if self.noise_func is not None else None
        res_conv = self.res_conv if c_in != self.dim_out else None
        parts = self.block1.fused(x, time_bias=tb, x2=x2, emit_stats=self.fuse_stats,
                                  stats_in=stats_in, res_conv=res_conv,
                                  stats_in2=x2_stats, spatial=spatial)
        parts = parts if isinstance(parts, tuple) else (parts,)
        h, s1 = parts[0], parts[1] if self.fuse_stats else None
        if res_conv is not None:
            res = parts[-1]
        else:
            res = torch.cat([x, x2], -1) if x2 is not None else x
        out = self.block2.fused(h, residual=res, stats_in=s1, emit_stats=emit_stats,
                                spatial=spatial)
        return out if emit_stats else (out, None)


class SelfAttention(nn.Module):
    """Full-spatial attention over flattened H*W tokens, scale 1/sqrt(C)
    (sr3_modules/unet.py:114-143)."""

    def __init__(self, in_channel, n_head=1, norm_groups=32, norm="group"):
        super().__init__()
        self.n_head = n_head
        self.norm = make_norm(norm, in_channel, norm_groups)
        self.qkv = Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = Conv2d(in_channel, in_channel, 1)

    @traced("unet.attention")
    def forward(self, x, spatial=None):
        """Under ``spatial`` x is an H-shard: the whole image is gathered,
        the single-device block runs on it on every rank, and the rank
        keeps its own rows. Attention is global and runs only at the small
        levels, and this keeps the sharded output that of one device."""
        h_loc = x.shape[1]
        if spatial is not None:
            x = gather_rows(x, spatial, "attention")
        b, h, w, c = x.shape
        head_dim = c // self.n_head
        qkv = self.qkv(self.norm(x)).reshape(b, h * w, self.n_head, 3 * head_dim)
        q, k, v = qkv.split(head_dim, dim=-1)
        out = spatial_attention(q, k, v, scale=1.0 / math.sqrt(c))
        out = self.out(out.reshape(b, h, w, c)) + x
        if spatial is None:
            return out
        i = spatial.space_idx
        return out[:, i * h_loc:(i + 1) * h_loc].contiguous()


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, noise_level_emb_dim=None, norm_groups=32,
                 dropout=0.0, with_attn=False, fuse=False, fuse_skip="auto",
                 fuse_stats=True, norm="group", discrete=False):
        super().__init__()
        self.with_attn = with_attn
        self.res_block = ResnetBlock(dim, dim_out, noise_level_emb_dim, dropout,
                                     norm_groups, fuse, fuse_skip, fuse_stats, norm, discrete)
        if with_attn:
            self.attn = SelfAttention(dim_out, norm_groups=norm_groups, norm=norm)

    def forward(self, x, emb, x2=None, stats_in=None, x2_stats=None, spatial=None):
        """Returns (out, stats); attention changes the tensor, so it
        resets the moment chain."""
        x, stats = self.res_block(x, emb, x2=x2, stats_in=stats_in,
                                  x2_stats=x2_stats, emit_stats=not self.with_attn,
                                  spatial=spatial)
        if self.with_attn:
            x, stats = self.attn(x, spatial=spatial), None
        return x, stats


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=2)

    def forward(self, x, spatial=None):
        if spatial is not None:
            return conv3x3_spatial(x, self.conv.weight.permute(2, 3, 1, 0), self.conv.bias,
                                   spatial, stride=2)
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3)
        self._packed = None
        self._packed_key = None

    def _pack(self, kernel):
        return packed_once(self, (self.conv.weight,),
                           lambda: up2_conv.pack_up2(parity_taps(kernel)))

    @traced("unet.up_conv")
    def forward(self, x, fused=False, spatial=None):
        kernel = self.conv.weight.permute(2, 3, 1, 0)
        if spatial is not None:
            return up2_conv3x3_spatial(x, kernel, self.conv.bias, spatial)
        if fused:
            packed = self._pack(kernel) if up2_conv.takes(x, kernel) else None
            return up2_conv3x3(x, kernel, self.conv.bias, packed=packed)
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(up.permute(0, 2, 3, 1))


class UNet(nn.Module):
    """The SR3/DDPM UNet (sr3_modules/unet.py:162-263 topology): every down
    layer's output goes onto the skip stack; each up level consumes
    res_blocks + 1 skips. ``time_embedding`` "continuous" (SR3, the noise
    level, ``noise_level_mlp``) or "discrete" (DDPM, the integer t,
    ``time_mlp``); ``norm`` "group" or "batch"."""

    def __init__(self, in_channel=6, out_channel=3, inner_channel=32,
                 norm_groups=32, channel_mults=(1, 2, 4, 8, 8), attn_res=(8,),
                 res_blocks=3, dropout=0.0, with_noise_level_emb=True,
                 image_size=128, fuse_blocks=False, fuse_skip="auto", fuse_stats=True,
                 time_embedding="continuous", norm="group", remat=False):
        super().__init__()
        if time_embedding not in ("continuous", "discrete"):
            raise ValueError(f"time_embedding {time_embedding!r}: 'continuous' or 'discrete'")
        self.in_channel = in_channel
        self.fuse_blocks = fuse_blocks
        self.remat = remat
        self.time_embedding = time_embedding
        self.norm = norm
        discrete = time_embedding == "discrete"
        emb_dim = inner_channel if with_noise_level_emb else None
        mlp = (nn.Sequential(
            TimeEmbedding(inner_channel) if discrete else PositionalEncoding(inner_channel),
            nn.Linear(inner_channel, inner_channel * 4), Swish(),
            nn.Linear(inner_channel * 4, inner_channel))
            if with_noise_level_emb else None)
        # the reference's names: time_mlp in ddpm_modules, noise_level_mlp in sr3_modules
        self.noise_level_mlp = self.time_mlp = None
        if discrete:
            self.time_mlp = mlp
        else:
            self.noise_level_mlp = mlp

        def resblock(dim, dim_out, with_attn):
            return ResnetBlocWithAttn(dim, dim_out, emb_dim, norm_groups, dropout,
                                      with_attn, fuse_blocks, fuse_skip, fuse_stats, norm,
                                      discrete)

        num_mults = len(channel_mults)
        pre = inner_channel
        feat_channels = [pre]
        now_res = image_size
        downs = [Conv2d(in_channel, inner_channel, 3)]
        for ind in range(num_mults):
            use_attn = now_res in attn_res
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(resblock(pre, ch, use_attn))
                feat_channels.append(ch)
                pre = ch
            if ind != num_mults - 1:
                downs.append(Downsample(pre))
                feat_channels.append(pre)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([resblock(pre, pre, True), resblock(pre, pre, False)])
        ups = []
        for ind in reversed(range(num_mults)):
            use_attn = now_res in attn_res
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(resblock(pre + feat_channels.pop(), ch, use_attn))
                pre = ch
            if ind > 0:
                ups.append(Upsample(pre))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, groups=norm_groups, norm=norm)

    def set_dropout_generator(self, generator, rows=None):
        """The generator every Dropout draws its masks from, and the rows
        (n, start, stop) of a global batch the input holds (None: all)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator
                m.rows = rows

    @contextmanager
    def fusing(self):
        """Every GroupNorm Block fused inside the block, whatever
        ``fuse_blocks`` says (the JAX package's ``clone(fuse_blocks=True)``
        for its spatial sampler)."""
        blocks = [m for m in self.modules() if isinstance(m, ResnetBlock)]
        saved = self.fuse_blocks, [b.fuse for b in blocks]
        self.fuse_blocks = True
        for b in blocks:
            b.fuse = self.norm == "group"
        try:
            yield self
        finally:
            self.fuse_blocks = saved[0]
            for b, f in zip(blocks, saved[1]):
                b.fuse = f

    def fused_routes(self):
        """(Blocks, up path): whether a forward runs each on its fused route.
        Both need ``fuse_blocks`` in eval mode; the Blocks also GroupNorm,
        the fused kernel's norm."""
        up = self.fuse_blocks and not self.training
        return up and self.norm == "group", up

    @traced("unet.forward")
    def forward(self, x, time, spatial=None):
        """x: (B, H, W, in_channel) NHWC; time: the (B, 1) noise level, or
        with the discrete embedding the (B,) integer timestep. ``spatial``:
        this rank's mesh, x its H-shard (the fused inference path only)."""
        blocks, fused = self.fused_routes()
        if spatial is not None and not blocks:
            raise NotImplementedError(_SPATIAL_UNFUSED)
        mlp = self.time_mlp if self.time_mlp is not None else self.noise_level_mlp
        emb = mlp(time) if mlp is not None else None
        remat = self.remat and torch.is_grad_enabled() and not fused

        def resblock(layer, h, **kw):
            if remat:
                return checkpoint(layer, h, emb, use_reentrant=False,
                                  context_fn=partial(remat_contexts, layer), **kw)
            return layer(h, emb, spatial=spatial, **kw)

        if spatial is None:
            h = self.downs[0](x)
        else:
            conv = self.downs[0]
            h = conv3x3_spatial(x, conv.weight.permute(2, 3, 1, 0), conv.bias, spatial)
        feats = [(h, None)]
        h_stats = None
        for layer in self.downs[1:]:
            if isinstance(layer, ResnetBlocWithAttn):
                h, h_stats = resblock(layer, h, stats_in=h_stats)
            else:
                h, h_stats = layer(h, spatial=spatial), None
            feats.append((h, h_stats))
        for layer in self.mid:
            h, h_stats = resblock(layer, h, stats_in=h_stats)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                x2, x2_stats = feats.pop()
                h, h_stats = resblock(layer, h, x2=x2, stats_in=h_stats, x2_stats=x2_stats)
            else:
                h, h_stats = layer(h, fused=fused, spatial=spatial), None
        if blocks:
            return self.final_conv.fused(h, stats_in=h_stats, spatial=spatial)
        return self.final_conv(h)
