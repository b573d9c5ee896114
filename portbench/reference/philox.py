"""Philox4x32-10 (Salmon et al., SC'11) normals in plain torch.

The port's CUDA rollouts draw a chain's step noise in the kernel: the pair of
standard normals for dimensions 2q and 2q + 1 of chain c at step i is
Box-Muller on the first two words of Philox4x32-10 at counter (c, i, q, 0)
under the key (seed low word, seed high word), with
u1 = ((w0 >> 8) + 1) / 2^24 in (0, 1] and u2 = (w1 >> 8) / 2^24 in [0, 1).
This module computes the same numbers from the same seed with int64 tensor
arithmetic, so the reference sees the draws the program saw without reading
anything the program made.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b for a < 2^32 and int64 b in
    [0, 2^32), without overflowing int64: b is split into 16-bit halves."""
    t1 = a * (b & 0xFFFF)
    t2 = a * (b >> 16)
    mid = t1 + ((t2 & 0xFFFF) << 16)
    return ((t2 >> 16) + (mid >> 32)) & _MASK, mid & _MASK


def philox_words(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 on counters (c0..c3)
    (int64 tensors or ints that broadcast) under keys k0, k1 (ints or int64
    tensors that broadcast)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) if not torch.is_tensor(c) else c
                      for c in (c0, c1, c2, c3))
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_normals(seeds, n_chains: int, steps, dim: int, device) -> torch.Tensor:
    """Standard normals (S, len(steps), n_chains, dim) in float32 for the
    Philox seeds `seeds` (a list of ints, one per seed group S), chains
    0..n_chains-1 and the step indices `steps`."""
    seeds = torch.as_tensor([int(s) for s in seeds], dtype=torch.int64, device=device)
    k0 = (seeds & _MASK).view(-1, 1, 1, 1)
    k1 = ((seeds >> 32) & _MASK).view(-1, 1, 1, 1)
    step = torch.as_tensor(list(steps), dtype=torch.int64, device=device).view(1, -1, 1, 1)
    chain = torch.arange(n_chains, dtype=torch.int64, device=device).view(1, 1, -1, 1)
    pairs = (dim + 1) // 2
    pair = torch.arange(pairs, dtype=torch.int64, device=device).view(1, 1, 1, -1)
    w0, w1, _, _ = philox_words(chain, step, pair, 0, k0, k1)
    u1 = ((w0 >> 8) + 1).double() * (1.0 / 16777216.0)
    u2 = (w1 >> 8).double() * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = 2.0 * math.pi * u2
    normals = torch.stack([r * torch.cos(angle), r * torch.sin(angle)], dim=-1)
    return normals.flatten(-2)[..., :dim].float()
