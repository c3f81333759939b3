"""Cross-attention between masked-input and reference features (reference:
models/transformer.py), used at the deepest level of LNet's visual encoder.

q and k come from the masked stream, v from the reference stream; GELU is
the tanh approximation. Submodule names follow the reference
(``layers.{d}.0`` = PreNorm2(CrossAttention), ``layers.{d}.1`` =
PreNorm(FeedForward)).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # net.0 Linear, net.1 GELU, net.2 Dropout, net.3 Linear (reference)
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(approximate="tanh"),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    """transformer.py:54-87."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.project = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim))
                       if self.project else nn.Identity())

    def forward(self, x, y):
        b, n, _ = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(y))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class PreNorm2(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.normx = nn.LayerNorm(dim)
        self.normy = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x, y):
        return self.fn(self.normx(x), self.normy(y))


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class CrossTransformer(nn.Module):
    """transformer.py:89-112 over flattened spatial tokens: x (masked) and
    y (reference) are [B, C, H, W]; returns the refined x."""

    def __init__(self, dim, depth=2, heads=4, dim_head=64, mlp_dim=256):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([PreNorm2(dim, CrossAttention(dim, heads, dim_head)),
                           PreNorm(dim, FeedForward(dim, mlp_dim))])
            for _ in range(depth)])

    def forward(self, x, y):
        b, c, h, w = x.shape
        xt = x.flatten(2).transpose(1, 2)
        yt = y.flatten(2).transpose(1, 2)
        for attn, ff in self.layers:
            xt = attn(xt, yt) + xt
            xt = ff(xt) + xt
        return xt.transpose(1, 2).reshape(b, c, h, w)
