"""CEGATSR baseline (reference GAE/CEGATSR.py): a port of
``hsi_dmgasr_tpu/models/baselines/cegatsr.py``.

A GCN/CNN dual-branch grouped SR net: each band group is embedded by a
strided conv into a token grid, a kNN graph over the token features
feeds a multi-head GAT, and a transposed conv restores the resolution.
The CNN branch (a depthwise-separable stack) is computed and unused, as
in the reference's forward (CEGATSR.py:366 ``y = GCN_result``). The
reference builds the graph with scipy ``cdist`` on the host per batch
item (CEGATSR.py:243-252); here, as in the JAX package, the distances
and the 7 nearest (self included) are one matmul and a ``topk`` on the
device. Module names give the reference keys (``branch.head.head.head``,
``branch.head.body.attention_N.{W,a}``, ``branch.head.last.last``,
``branch.body.{point_conv,depth_conv,BN}``, ``trunk.{head,body,upsample}``).
NHWC in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.blocks import SSPN, Conv2d, Upsampler
from ...ops.extra import Deconv2d
from ..unet import Dropout
from .groups import BandGroups


def knn_adjacency(tokens, k=7):
    """(B, N, C) -> (B, N, N) 0/1 adjacency of the k nearest tokens
    (euclidean, self included): the reference's argsort-rank <= 6 test
    (CEGATSR.py:247). The squared distances come from one matmul; with
    TF32 on, the card's matmul can reorder the 7th neighbour
    (``device.use_f32_policy`` turns it off)."""
    sq = (tokens * tokens).sum(-1)
    d2 = sq[:, :, None] - 2.0 * torch.einsum("bnc,bmc->bnm", tokens, tokens) + sq[:, None, :]
    idx = torch.topk(-d2, k, dim=-1).indices
    return torch.zeros_like(d2).scatter_(-1, idx, 1.0)


class GraphAttentionLayer(nn.Module):
    """Dense GAT layer (CEGATSR.py:71-120): ``W`` (in, out) and ``a``
    (2 out, 1) as the reference holds them, xavier-uniform at init."""

    def __init__(self, in_features, out_features, alpha=0.2, concat=True):
        super().__init__()
        self.out_features, self.alpha, self.concat = out_features, alpha, concat
        self.W = nn.Parameter(nn.init.xavier_uniform_(torch.empty(in_features, out_features)))
        self.a = nn.Parameter(nn.init.xavier_uniform_(torch.empty(2 * out_features, 1)))

    def forward(self, x, adj):
        h = x @ self.W  # (B, N, F)
        # e_ij = leaky_relu(a^T [h_i || h_j]) = leaky_relu(a_1^T h_i + a_2^T h_j)
        a1, a2 = self.a[:self.out_features, 0], self.a[self.out_features:, 0]
        e = F.leaky_relu((h @ a1)[:, :, None] + (h @ a2)[:, None, :], self.alpha)
        e = torch.where(adj > 0, e, torch.full((), -1e12, dtype=e.dtype, device=e.device))
        h_prime = torch.softmax(e, dim=2) @ h
        return torch.relu(h_prime) if self.concat else h_prime


class GAT(nn.Module):
    """Multi-head GAT, heads concatenated, then an output head
    (CEGATSR.py:124-146). Dropout 0.6 in train mode draws from each
    Dropout's ``generator`` (``models/unet.py:Dropout``)."""

    def __init__(self, features, n_heads=2, alpha=0.2, dropout=0.6):
        super().__init__()
        for i in range(n_heads):
            self.add_module(f"attention_{i}", GraphAttentionLayer(features, features, alpha))
        self.n_heads = n_heads
        self.out_att = GraphAttentionLayer(n_heads * features, features, alpha, concat=False)
        self.drop_in, self.drop_mid = Dropout(dropout), Dropout(dropout)

    def forward(self, x, adj):
        x = self.drop_in(x)
        x = torch.cat([getattr(self, f"attention_{i}")(x, adj) for i in range(self.n_heads)], 2)
        x = F.elu(self.out_att(self.drop_mid(x), adj))
        return torch.log_softmax(x, dim=2)


class _Embed(nn.Module):
    """The strided 3x3 conv that makes the token grid, held as ``head``."""

    def __init__(self, feats):
        super().__init__()
        self.head = Conv2d(feats, feats, 3, stride=2)

    def forward(self, x):
        return self.head(x)


class _Restore(nn.Module):
    """The x2 transposed conv back to the group's size (padding 1, output
    padding 1, CEGATSR.py:62-63), held as ``last``."""

    def __init__(self, feats):
        super().__init__()
        self.last = Deconv2d(feats, feats, 3, 2, 1, output_padding=1)

    def forward(self, x):
        return self.last(x)


class GCNUnit(nn.Module):
    """strided conv -> kNN graph -> GAT -> transposed conv
    (CEGATSR.py:269-303)."""

    def __init__(self, feats):
        super().__init__()
        self.head, self.body, self.last = _Embed(feats), GAT(feats), _Restore(feats)

    def forward(self, x):
        y = self.head(x)
        b, h, w, c = y.shape
        tokens = y.reshape(b, h * w, c)
        t = self.body(tokens, knn_adjacency(tokens.detach()))
        return self.last(t.reshape(b, h, w, c))


class CNNUnit(nn.Module):
    """Depthwise-separable double stack (CEGATSR.py:306-341); both passes
    share the point and depth convs. ``BN`` is declared, as in the
    reference, and never used."""

    def __init__(self, feats):
        super().__init__()
        self.point_conv = Conv2d(feats, feats, 1, bias=False)
        self.depth_conv = Conv2d(feats, feats, 3, groups=feats)
        self.BN = nn.BatchNorm2d(feats)

    def forward(self, x):
        lrelu = lambda t: F.leaky_relu(t, 0.01)  # noqa: E731
        y = lrelu(self.depth_conv(lrelu(self.point_conv(x))))
        return lrelu(self.depth_conv(lrelu(self.point_conv(y))))


class GCNCNNUnit(nn.Module):
    """The shared per-group branch (CEGATSR.py:344-375)."""

    def __init__(self, n_subs, feats, up_scale, use_tail=True):
        super().__init__()
        self.pre = Conv2d(n_subs, feats, 3)
        self.head = GCNUnit(feats)
        self.body = CNNUnit(feats)
        self.last = Conv2d(feats, feats, 3)
        self.upsample = Upsampler(up_scale, feats)
        self.tail = Conv2d(feats, n_subs, 3) if use_tail else None

    def forward(self, x):
        y = self.pre(x)
        gcn = self.head(y)
        self.body(y)  # computed and unused, as in the reference (CEGATSR.py:366)
        y = self.upsample(self.last(gcn))
        return self.tail(y) if self.tail is not None else y


class _Trunk(nn.Module):
    """head conv, SSPN (CALayer reduction 16, CEGATSR.py:199), x2 upsampler."""

    def __init__(self, in_feats, feats, n_blocks, res_scale):
        super().__init__()
        self.head = Conv2d(in_feats, feats, 3)
        self.body = SSPN(feats, n_blocks, nn.ReLU(), res_scale, ca_reduction=16)
        self.upsample = Upsampler(2, feats)

    def forward(self, x):
        return self.upsample(self.body(self.head(x)))


class CEGATSR(nn.Module):
    """The grouped GCN/CNN SR model (CEGATSR.py:429-511). Its Dropouts act
    in train mode only; set their ``generator``s for a seeded step."""

    def __init__(self, n_subs=8, n_ovls=2, in_feats=31, n_blocks=3, out_feats=64, n_scale=4,
                 res_scale=0.1):
        super().__init__()
        self.groups = BandGroups(in_feats, n_subs, n_ovls)
        self.branch = GCNCNNUnit(n_subs, out_feats, up_scale=n_scale // 2)
        self.trunk = _Trunk(in_feats, out_feats, n_blocks, res_scale)
        self.skip_conv = Conv2d(in_feats, out_feats, 3)
        self.final = Conv2d(out_feats, in_feats, 3)

    def forward(self, x, lms):
        """x: (B, h, w, C) LR; lms: (B, h*n_scale, w*n_scale, C) bicubic-up."""
        y = self.trunk(self.groups.merge(self.branch(self.groups.fold(x)), x.shape[0]))
        return self.final(y + self.skip_conv(lms))
