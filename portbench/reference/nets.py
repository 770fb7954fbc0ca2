"""The plain reference of DMGASR's two networks, in plain PyTorch (NCHW).

The GAE of DMGASR (band groups, a shared SSPSR-style encoder and decoder,
the overlap average and a residual trunk) and the SR3 UNet (WaveGrad noise
encoding, GroupNorm resblocks with additive noise injection, attention at
the nominal resolutions of ``attn_res``, nearest x2 upsampling), written
from the published architecture (github.com/handsomewzy/HSI-DMGASR,
``AE.py``, ``model/sr3_modules/unet.py``). The attribute names give the
reference's state_dict keys, so one state_dict loads into these modules
and into the system under test alike. Nothing here imports the system
under test.

Precision: float32 with TF32 off, except where ``Precision`` says the
configuration states otherwise. The configurations run the UNet's
GroupNorm Blocks through a fused kernel whose stated function rounds its
conv weights (and the folded 1x1 projection's) to bfloat16, and long
attention through a flash kernel whose stated function rounds q * scale,
k, v and the probabilities to bfloat16 into f32 sums; ``Precision`` carries
those roundings so that the reference computes what the configuration
states and nothing lower.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class Precision:
    """The roundings the configuration states beyond float32."""

    block_weights_bf16: bool = False   # the Blocks' conv (and 1x1 projection) weights
    flash_bf16: bool = False           # long attention's operands and probabilities
    flash_min_tokens: int = 8192       # attention this long (and D % 128 == 0) is "long"
    attn_query_block: int = 2048       # queries per block of the reference's attention

    @classmethod
    def from_config(cls, cfg, train=False):
        """The inference precision of ``cfg["precision"]``; training runs
        every Block and attention in float32 (the unfused autograd path)."""
        p = cfg.get("precision") or {}
        if train:
            return cls()
        return cls(block_weights_bf16=p.get("fused_block_weights") == "bfloat16",
                   flash_bf16=p.get("flash_operands") == "bfloat16",
                   flash_min_tokens=int(p.get("flash_min_tokens", 8192)))


@contextmanager
def lower_precision():
    """TF32 in cuDNN's convolutions and in matmuls: the precision one step
    below the configurations' f32, for the control of the correctness
    check."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def conv(x, weight, bias=None, stride=1):
    k = weight.shape[-1]
    return F.conv2d(x, weight, bias, stride=stride, padding=k // 2)


# ------------------------------------------------------------------------ GAE


class Conv(nn.Module):
    """A conv with the reference's ``default_conv`` padding."""

    def __init__(self, cin, cout, k=3, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return conv(x, self.weight, self.bias)


class Seq(nn.Module):
    """Children named by their index in an ``nn.Sequential`` of the
    reference (its state_dict keys), of which only the given ones carry
    weights; ``seq[i]`` is child i, iteration goes by index."""

    def __init__(self, layers):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __getitem__(self, i):
        return self._modules[str(i)]

    def __iter__(self):
        return (self._modules[k] for k in sorted(self._modules, key=int))


class ResBlock(nn.Module):
    """conv, leaky ReLU 0.01, conv; x + 0.1 * body (common.py ResBlock)."""

    def __init__(self, n, k):
        super().__init__()
        self.body = Seq({0: Conv(n, n, k), 2: Conv(n, n, k)})

    def forward(self, x):
        return self.body[2](F.leaky_relu(self.body[0](x), 0.01)) * 0.1 + x


class CALayer(nn.Module):
    def __init__(self, n, reduction=3):
        super().__init__()
        self.conv_du = Seq({0: Conv(n, n // reduction, 1), 2: Conv(n // reduction, n, 1)})

    def forward(self, x):
        y = x.mean((2, 3), keepdim=True)
        y = torch.relu(self.conv_du[0](y))
        return x * torch.sigmoid(self.conv_du[2](y))


class ResAttentionBlock(nn.Module):
    """1x1 conv, leaky ReLU, 1x1 conv, channel attention; x + 0.1 * body."""

    def __init__(self, n):
        super().__init__()
        self.body = Seq({0: Conv(n, n, 1), 2: Conv(n, n, 1), 3: CALayer(n)})

    def forward(self, x):
        y = self.body[2](F.leaky_relu(self.body[0](x), 0.01))
        return self.body[3](y) * 0.1 + x


class SSB(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.spa = ResBlock(n, 3)
        self.spc = ResAttentionBlock(n)

    def forward(self, x):
        return self.spc(self.spa(x))


class SSPN(nn.Module):
    def __init__(self, n, n_blocks):
        super().__init__()
        self.net = Seq({i: SSB(n) for i in range(n_blocks)})

    def forward(self, x):
        y = x
        for block in self.net:
            y = block(y)
        return y + x


class BranchUnit(nn.Module):
    """head conv, SSPN, no upsampling, no tail (AE.py BranchUnit)."""

    def __init__(self, cin, n_feats, n_blocks):
        super().__init__()
        self.head = Conv(cin, n_feats, 3)
        self.body = SSPN(n_feats, n_blocks)

    def forward(self, x):
        return self.body(self.head(x))


class Coder(nn.Module):
    def __init__(self, cin, cout, n_feats):
        super().__init__()
        self.branch = BranchUnit(cin, n_feats, 3)
        self.final = Conv(n_feats, cout, 3)

    def forward(self, x):
        return self.final(self.branch(x))


def group_indices(n_colors, n_subs, n_ovls):
    """(G, n_subs) band indices of the overlapping groups (AE.py:273-280)."""
    G = math.ceil((n_colors - n_ovls) / (n_subs - n_ovls))
    idx = np.zeros((G, n_subs), dtype=np.int64)
    for g in range(G):
        sta = (n_subs - n_ovls) * g
        end = min(sta + n_subs, n_colors)
        idx[g] = np.arange(end - n_subs, end)
    return idx


class GAE(nn.Module):
    """The grouped autoencoder: encode (B, C, H, W) into (B, G, 3, H, W)
    latents; decode back through the overlap average and the trunk."""

    def __init__(self, n_subs, n_ovls, n_colors, n_feats, latent=3):
        super().__init__()
        self.idx = group_indices(n_colors, n_subs, n_ovls)
        self.G, self.n_subs, self.n_colors, self.latent = (self.idx.shape[0], n_subs,
                                                           n_colors, latent)
        self.Encoder = Coder(n_subs, latent, n_feats)
        self.Decoder = Coder(latent, n_subs, n_feats)
        self.trunk = BranchUnit(n_colors, 32, 2)
        self.final = Conv(32, n_colors, 3)

    def encode(self, x):
        b, c, h, w = x.shape
        groups = torch.stack([x[:, i] for i in self.idx], 1)  # (B, G, n_subs, H, W)
        z = self.Encoder(groups.reshape(b * self.G, self.n_subs, h, w))
        return z.reshape(b, self.G, self.latent, h, w)

    def decode(self, z):
        b, g, lc, h, w = z.shape
        dec = self.Decoder(z.reshape(b * g, lc, h, w)).reshape(b, g, self.n_subs, h, w)
        y = torch.zeros((b, self.n_colors, h, w), dtype=dec.dtype, device=dec.device)
        count = torch.zeros(self.n_colors, dtype=dec.dtype, device=dec.device)
        for gi, bands in enumerate(self.idx):
            y[:, bands] += dec[:, gi]
            count[bands] += 1
        y = y / count[None, :, None, None]
        return self.final(self.trunk(y)) + y


# ----------------------------------------------------------------------- UNet


class GroupNorm(nn.Module):
    def __init__(self, groups, channels):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, 1e-5)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Block(nn.Module):
    """GroupNorm, swish, dropout (Block 2 of a resblock), 3x3 conv."""

    def __init__(self, dim, dim_out, groups):
        super().__init__()
        self.block = Seq({0: GroupNorm(groups, dim), 3: Conv(dim, dim_out, 3)})

    def forward(self, x, prec, dropout=None):
        a = self.block[0](x)
        a = a * torch.sigmoid(a)
        if dropout is not None:
            a = dropout(a)
        w = self.block[3].weight
        return conv(a, _bf16(w) if prec.block_weights_bf16 else w, self.block[3].bias)


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, groups):
        super().__init__()
        self.noise_func = nn.Module()
        self.noise_func.noise_func = Seq({0: Linear(emb_dim, dim_out)})
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = Conv(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, emb, prec, dropout=None):
        h = self.block1(x, prec)
        h = h + self.noise_func.noise_func[0](emb)[:, :, None, None]
        h = self.block2(h, prec, dropout)
        if self.res_conv is None:
            return h + x
        w = self.res_conv.weight
        return h + conv(x, _bf16(w) if prec.block_weights_bf16 else w, self.res_conv.bias)


def attention(q, k, v, scale, prec):
    """softmax(q k^T * scale) v over (B, S, D) tokens, in blocks of queries.
    Long attention (``prec.flash_bf16``) rounds q * scale, k, v and the
    probabilities to bfloat16 into f32 sums, as the flash kernel's stated
    function does; the probabilities are normalised by their f32 sum."""
    b, s, d = q.shape
    long = prec.flash_bf16 and s >= prec.flash_min_tokens and d % 128 == 0
    out = torch.empty_like(q)
    kt = (_bf16(k) if long else k).transpose(1, 2)
    vv = _bf16(v) if long else v
    for i in range(0, s, prec.attn_query_block):
        qb = q[:, i:i + prec.attn_query_block]
        if long:
            logits = _bf16(qb * scale) @ kt
        else:
            logits = (qb @ kt) * scale
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        den = p.sum(-1, keepdim=True)
        out[:, i:i + prec.attn_query_block] = ((_bf16(p) if long else p) @ vv) / den
    return out


class SelfAttention(nn.Module):
    """One-head attention over the H*W tokens, scale 1/sqrt(C)."""

    def __init__(self, c, groups):
        super().__init__()
        self.norm = GroupNorm(groups, c)
        self.qkv = Conv(c, 3 * c, 1, bias=False)
        self.out = Conv(c, c, 1)

    def forward(self, x, prec):
        b, c, h, w = x.shape
        qkv = self.qkv(self.norm(x)).reshape(b, 3 * c, h * w).transpose(1, 2)
        q, k, v = qkv.split(c, dim=-1)
        o = attention(q, k, v, 1.0 / math.sqrt(c), prec)
        return self.out(o.transpose(1, 2).reshape(b, c, h, w)) + x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, groups, with_attn):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, emb_dim, groups)
        self.attn = SelfAttention(dim_out, groups) if with_attn else None

    def forward(self, x, emb, prec, dropout=None):
        x = self.res_block(x, emb, prec, dropout)
        return self.attn(x, prec) if self.attn is not None else x


class Downsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x):
        return conv(x, self.conv.weight, self.conv.bias, stride=2)


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def noise_encoding(gamma, dim):
    """WaveGrad encoding of the (B, 1) noise level: [sin, cos](g e^-k)."""
    count = dim // 2
    step = torch.arange(count, dtype=gamma.dtype, device=gamma.device) / count
    enc = gamma * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], -1)


class UNet(nn.Module):
    """The SR3 UNet. Attention sits where the nominal resolution, counted
    down from ``image_size`` by the downsamples, is in ``attn_res``, and in
    the first mid block."""

    def __init__(self, in_channel, out_channel, inner, groups, mults, attn_res,
                 res_blocks, image_size):
        super().__init__()
        self.inner = inner
        self.noise_level_mlp = Seq({1: Linear(inner, inner * 4), 3: Linear(inner * 4, inner)})
        downs = {0: Conv(in_channel, inner, 3)}
        feats, pre, now = [inner], inner, image_size
        for ind, m in enumerate(mults):
            ch = inner * m
            for _ in range(res_blocks):
                downs[len(downs)] = ResnetBlocWithAttn(pre, ch, inner, groups, now in attn_res)
                feats.append(ch)
                pre = ch
            if ind != len(mults) - 1:
                downs[len(downs)] = Downsample(pre)
                feats.append(pre)
                now //= 2
        self.downs = Seq(downs)
        self.mid = Seq({0: ResnetBlocWithAttn(pre, pre, inner, groups, True),
                        1: ResnetBlocWithAttn(pre, pre, inner, groups, False)})
        ups = {}
        for ind in reversed(range(len(mults))):
            ch = inner * mults[ind]
            for _ in range(res_blocks + 1):
                ups[len(ups)] = ResnetBlocWithAttn(pre + feats.pop(), ch, inner, groups,
                                                   now in attn_res)
                pre = ch
            if ind > 0:
                ups[len(ups)] = Upsample(pre)
                now *= 2
        self.ups = Seq(ups)
        self.final_conv = Block(pre, out_channel, groups)

    @classmethod
    def from_config(cls, cfg):
        u = cfg["model"]["unet"]
        return cls(u["in_channel"], u["out_channel"], u["inner_channel"], u["norm_groups"],
                   tuple(u["channel_multiplier"]), tuple(u["attn_res"]), u["res_blocks"],
                   cfg["model"]["diffusion"]["image_size"])

    def forward(self, x, gamma, prec, dropout=None):
        """x (B, in_channel, H, W), gamma (B, 1) -> eps (B, out_channel, H, W).
        ``dropout``: a function applied to Block 2's activation in every
        resblock, in the order the forward runs them (None at inference)."""
        mlp = self.noise_level_mlp
        emb = mlp[3](F.silu(mlp[1](noise_encoding(gamma, self.inner))))
        h = self.downs[0](x)
        feats = [h]
        for layer in list(self.downs)[1:]:
            h = layer(h, emb, prec, dropout) if isinstance(layer, ResnetBlocWithAttn) else layer(h)
            feats.append(h)
        for layer in self.mid:
            h = layer(h, emb, prec, dropout)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                h = layer(torch.cat([h, feats.pop()], 1), emb, prec, dropout)
            else:
                h = layer(h)
        return self.final_conv(h, prec)


def gae_from_config(cfg):
    g = cfg["gae_widths"]
    return GAE(g["n_subs"], g["n_ovls"], g["n_colors"], g["n_feats"])
