"""SR3 denoising UNet (PyTorch, NHWC activations).

Port of the SR3 variant of ``hsi_dmgasr_tpu/models/unet.py``: continuous
noise-level embedding, GroupNorm, additive noise injection
(reference model/sr3_modules/unet.py:18-263). Module names give the
reference's torch keys (``noise_level_mlp.1``, ``downs.N``, ``mid.N``,
``ups.N``, ``block1.block.0/3``, ``noise_func.noise_func.0``,
``res_conv``, ``attn.norm/qkv/out``, ``final_conv.block.0/3``), so
reference ``.pth`` state_dicts load directly.

``fuse_blocks=True`` (in eval mode) runs every resblock Block and the
final conv through the fused GroupNorm -> swish -> conv3x3 kernel
(kernels/fused_conv.py) with the JAX package's routing: block1 takes the
time bias, emits its output's per-row moments and folds the 1x1
res_conv; block2 takes the residual and block1's moments; the skip stack
carries (tensor, moments) so up-path GroupNorms need no stats pass; the
skip rides the kernel as a second source per ``fuse_skip`` ("auto": only
when dim_out < 128), and boundary convs and attention reset the moment
chain. ``fuse_stats=False`` turns the moment chain off (every fused
GroupNorm reduces its own input).

Mixed precision follows the JAX package: the module's dtype is its
weights' (``.to(torch.bfloat16)`` for bf16 inference), the activations
follow the input's dtype, GroupNorm computes in f32 and rounds once, and
the noise encoding stays in the noise level's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import spatial_attention
from ..kernels.fused_conv import gn_swish_conv3x3, pack_conv3x3
from ..ops.blocks import Conv2d
from ..ops.fused_up import up2_conv3x3


def swish(x):
    return x * torch.sigmoid(x)


def continuous_noise_encoding(noise_level, dim):
    """WaveGrad positional encoding of gamma (sr3_modules/unet.py:18-31):
    (B, 1) -> (B, dim) as [sin(g e^-k), cos(g e^-k)]."""
    count = dim // 2
    step = torch.arange(count, dtype=noise_level.dtype, device=noise_level.device) / count
    enc = noise_level * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], -1)


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


class Dropout(nn.Module):
    """Dropout whose mask is drawn from ``self.generator`` (set by the
    trainer for each step, so a step is a function of its seed), as
    flax's: keep with probability 1 - p and scale the kept by 1/(1 - p).
    The identity in eval mode."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        keep = torch.empty(x.shape, device=x.device).bernoulli_(keep_prob,
                                                                generator=self.generator)
        return torch.where(keep.bool(), x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


class Block(nn.Module):
    """norm -> swish -> dropout -> 3x3 conv (sr3_modules/unet.py:80-91).

    ``forward`` is the reference Block; ``fused`` runs the same Block
    through the fused kernel with its extras, using weights packed once
    per weight version (a load_state_dict repacks)."""

    def __init__(self, dim, dim_out, groups=32, dropout=0.0):
        super().__init__()
        self.block = nn.Sequential(
            GroupNorm(groups, dim, eps=1e-5), Swish(),
            Dropout(dropout) if dropout else nn.Identity(),
            Conv2d(dim, dim_out, 3))
        self._packed = None
        self._packed_key = None

    def forward(self, x):
        return self.block(x)

    def _pack(self, res_conv):
        weights = [self.block[3].weight]
        if res_conv is not None:
            weights.append(res_conv.weight)
        key = tuple((w.data_ptr(), w._version, w.device) for w in weights)
        if key != self._packed_key:
            res_k = None if res_conv is None else res_conv.weight.permute(2, 3, 1, 0)
            self._packed = pack_conv3x3(self.block[3].weight.permute(2, 3, 1, 0), res_k)
            self._packed_key = key
        return self._packed

    def fused(self, x, time_bias=None, residual=None, x2=None, stats_in=None,
              emit_stats=False, res_conv=None, stats_in2=None):
        gn, conv = self.block[0], self.block[3]
        res_k = res_b = None
        if res_conv is not None:
            res_k, res_b = res_conv.weight.permute(2, 3, 1, 0), res_conv.bias
        return gn_swish_conv3x3(
            x, gn.weight, gn.bias, conv.weight.permute(2, 3, 1, 0), conv.bias,
            time_bias=time_bias, residual=residual, x2=x2, stats_in=stats_in,
            num_groups=gn.num_groups, eps=gn.eps, emit_stats=emit_stats,
            res_kernel=res_k, res_bias=res_b, stats_in2=stats_in2,
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
    (sr3_modules/unet.py:94-111)."""

    def __init__(self, dim, dim_out, noise_level_emb_dim=None, dropout=0.0,
                 norm_groups=32, fuse=False, fuse_skip="auto", fuse_stats=True):
        super().__init__()
        self.dim_out = dim_out
        self.fuse = fuse
        # the skip rides the kernel as x2 ("auto": while dim_out under-fills
        # the JAX package's 128-lane tile), else the concat is materialised
        self.fuse_skip = dim_out < 128 if fuse_skip == "auto" else bool(fuse_skip)
        self.fuse_stats = fuse_stats
        self.noise_func = (FeatureWiseAffine(noise_level_emb_dim, dim_out)
                           if noise_level_emb_dim else None)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups, dropout=dropout)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, emb, x2=None, stats_in=None, emit_stats=False,
                x2_stats=None):
        """Returns (out, stats); stats are the output's per-row moments
        on the fused path with ``emit_stats``, else None."""
        if self.fuse and not self.training:
            return self._fused(x, emb, x2, stats_in, emit_stats, x2_stats)
        xin = torch.cat([x, x2], -1) if x2 is not None else x
        h = self.block1(xin)
        if self.noise_func is not None:
            h = self.noise_func(h, emb)
        return self.block2(h) + self.res_conv(xin), None

    def _fused(self, x, emb, x2, stats_in, emit_stats, x2_stats):
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
                                  stats_in2=x2_stats)
        parts = parts if isinstance(parts, tuple) else (parts,)
        h, s1 = parts[0], parts[1] if self.fuse_stats else None
        if res_conv is not None:
            res = parts[-1]
        else:
            res = torch.cat([x, x2], -1) if x2 is not None else x
        out = self.block2.fused(h, residual=res, stats_in=s1, emit_stats=emit_stats)
        return out if emit_stats else (out, None)


class SelfAttention(nn.Module):
    """Full-spatial attention over flattened H*W tokens, scale 1/sqrt(C)
    (sr3_modules/unet.py:114-143)."""

    def __init__(self, in_channel, n_head=1, norm_groups=32):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm(norm_groups, in_channel, eps=1e-5)
        self.qkv = Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = Conv2d(in_channel, in_channel, 1)

    def forward(self, x):
        b, h, w, c = x.shape
        head_dim = c // self.n_head
        qkv = self.qkv(self.norm(x)).reshape(b, h * w, self.n_head, 3 * head_dim)
        q, k, v = qkv.split(head_dim, dim=-1)
        out = spatial_attention(q, k, v, scale=1.0 / math.sqrt(c))
        return self.out(out.reshape(b, h, w, c)) + x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, noise_level_emb_dim=None, norm_groups=32,
                 dropout=0.0, with_attn=False, fuse=False, fuse_skip="auto",
                 fuse_stats=True):
        super().__init__()
        self.with_attn = with_attn
        self.res_block = ResnetBlock(dim, dim_out, noise_level_emb_dim, dropout,
                                     norm_groups, fuse, fuse_skip, fuse_stats)
        if with_attn:
            self.attn = SelfAttention(dim_out, norm_groups=norm_groups)

    def forward(self, x, emb, x2=None, stats_in=None, x2_stats=None):
        """Returns (out, stats); attention changes the tensor, so it
        resets the moment chain."""
        x, stats = self.res_block(x, emb, x2=x2, stats_in=stats_in,
                                  x2_stats=x2_stats, emit_stats=not self.with_attn)
        if self.with_attn:
            x, stats = self.attn(x), None
        return x, stats


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3)

    def forward(self, x, fused=False):
        if fused:
            return up2_conv3x3(x, self.conv.weight.permute(2, 3, 1, 0), self.conv.bias)
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(up.permute(0, 2, 3, 1))


class UNet(nn.Module):
    """The SR3 UNet (sr3_modules/unet.py:162-263 topology): every down
    layer's output goes onto the skip stack; each up level consumes
    res_blocks + 1 skips."""

    def __init__(self, in_channel=6, out_channel=3, inner_channel=32,
                 norm_groups=32, channel_mults=(1, 2, 4, 8, 8), attn_res=(8,),
                 res_blocks=3, dropout=0.0, with_noise_level_emb=True,
                 image_size=128, fuse_blocks=False, fuse_skip="auto", fuse_stats=True):
        super().__init__()
        self.in_channel = in_channel
        self.fuse_blocks = fuse_blocks
        emb_dim = inner_channel if with_noise_level_emb else None
        self.noise_level_mlp = (nn.Sequential(
            PositionalEncoding(inner_channel),
            nn.Linear(inner_channel, inner_channel * 4), Swish(),
            nn.Linear(inner_channel * 4, inner_channel))
            if with_noise_level_emb else None)

        def resblock(dim, dim_out, with_attn):
            return ResnetBlocWithAttn(dim, dim_out, emb_dim, norm_groups, dropout,
                                      with_attn, fuse_blocks, fuse_skip, fuse_stats)

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
        self.final_conv = Block(pre, out_channel, groups=norm_groups)

    def set_dropout_generator(self, generator):
        """The generator every Dropout draws its masks from."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def forward(self, x, time):
        """x: (B, H, W, in_channel) NHWC; time: (B, 1) noise level."""
        fused = self.fuse_blocks and not self.training
        emb = self.noise_level_mlp(time) if self.noise_level_mlp is not None else None

        h = self.downs[0](x)
        feats = [(h, None)]
        h_stats = None
        for layer in self.downs[1:]:
            if isinstance(layer, ResnetBlocWithAttn):
                h, h_stats = layer(h, emb, stats_in=h_stats)
            else:
                h, h_stats = layer(h), None
            feats.append((h, h_stats))
        for layer in self.mid:
            h, h_stats = layer(h, emb, stats_in=h_stats)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                x2, x2_stats = feats.pop()
                h, h_stats = layer(h, emb, x2=x2, stats_in=h_stats, x2_stats=x2_stats)
            else:
                h, h_stats = layer(h, fused=fused), None
        if fused:
            return self.final_conv.fused(h, stats_in=h_stats)
        return self.final_conv(h)
