"""A toy transformer family for the benchmark's tests: the layers a
transformer configuration brings to the reference (``nn.Linear``,
``nn.LayerNorm``, ``nn.GELU``, softmax attention, a leaf that no shared
seeding rule knows), at a size the CPU runs in a blink.

A 4x4 patch embedding and its LayerNorm, ``depth`` pre-norm blocks
(attention with a learned layer scale, then an MLP of ratio 4), a
LayerNorm and a linear classifier per token, and a bilinear x4 back to the
image's size. The tests copy this file to
``benchmark/reference/families/toy_transformer.py`` of a temporary tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

PATCH = 4
EPS = 1e-6


class AttentionCore(nn.Module):
    """softmax(q k^T / sqrt(d)) v over ``heads`` heads of [B, N, C] tokens."""

    def __init__(self, heads: int):
        super().__init__()
        self.heads = heads

    def forward(self, q, k, v):
        b, n, c = q.shape
        q, k, v = (t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)
                   for t in (q, k, v))
        a = torch.softmax(q @ k.transpose(-2, -1) * (c // self.heads) ** -0.5, dim=-1)
        return (a @ v).transpose(1, 2).reshape(b, n, c)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.q, self.kv, self.proj = nn.Linear(dim, dim), nn.Linear(dim, 2 * dim), nn.Linear(dim, dim)
        self.core = AttentionCore(heads)

    def forward(self, x):
        k, v = self.kv(x).chunk(2, dim=-1)
        return self.proj(self.core(self.q(x), k, v))


class Residual(nn.Module):
    """x + gamma * fn(norm(x)): one pre-norm residual branch."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm, self.fn = nn.LayerNorm(dim, eps=EPS), fn
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x + self.gamma * self.fn(self.norm(x))


class ToyTransformer(nn.Module):
    ROUNDED_OUTPUTS = (AttentionCore, Residual)
    SEEDED_RULES = {"gamma": lambda z, u: 0.5 + u}

    def __init__(self, num_classes: int, dim: int, heads: int, depth: int):
        super().__init__()
        self.embed = nn.Conv2d(3, dim, PATCH, PATCH)
        self.embed_norm = nn.LayerNorm(dim, eps=EPS)
        self.blocks = nn.Sequential(*[
            m for _ in range(depth) for m in (
                Residual(dim, Attention(dim, heads)),
                Residual(dim, nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                            nn.Linear(4 * dim, dim))))])
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x):
        b, _, h, w = x.shape
        y = self.embed_norm(self.embed(x).flatten(2).transpose(1, 2))
        y = self.head(self.norm(self.blocks(y)))
        y = y.transpose(1, 2).reshape(b, -1, h // PATCH, w // PATCH)
        return F.interpolate(y, scale_factor=PATCH, mode="bilinear", align_corners=False)


def build(arch: dict) -> nn.Module:
    return ToyTransformer(arch["num_classes"], arch["dim"], arch["heads"], arch["depth"])
