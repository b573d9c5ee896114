"""The log-Gaussian Cox process on the Finnish pines data (Moller et al.
1998; the CMCD paper's 1600-dimensional posterior), for the reference. The
unit square is cut into 40 x 40 cells; the latent field z has the prior
N(mu, K) with K(m, n) = 1.91 exp(-|m - n| / (40 / 33)) over cell indices and
mu = log 126 - 1.91 / 2, and each cell's count is Poisson with rate
exp(z) / 1600. Everything is worked out here from data/pines.csv (the
point pattern, a copy of the benchmark's own): the bin counts, the Gram
matrix, its Cholesky factor, its inverse and the precision, in float64,
then cast to float32.

  log pi(z) = -D/2 log 2 pi - log|L| - |L^{-1}(z - mu)|^2 / 2 + sum(z c - e^z / D)
  grad log pi(z) = -K^{-1}(z - mu) + c - e^z / D
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

PINES = os.path.join(os.path.dirname(__file__), "data", "pines.csv")
GRID, SIGNAL_VARIANCE, LENGTH_SCALE = 40, 1.91, 1.0 / 33


class Lgcp:
    dim = GRID * GRID

    def __init__(self, device):
        points = np.loadtxt(PINES, delimiter=",")
        cells = np.minimum(np.floor(points * GRID).astype(np.int64), GRID - 1)
        counts = np.bincount(cells[:, 0] * GRID + cells[:, 1], minlength=self.dim)
        ij = np.indices((GRID, GRID)).reshape(2, -1).T.astype(np.float64)
        dist = np.sqrt(((ij[:, None, :] - ij[None, :, :]) ** 2).sum(-1))
        gram = SIGNAL_VARIANCE * np.exp(-dist / (GRID * LENGTH_SCALE))
        chol = np.linalg.cholesky(gram)
        chol_inv = np.linalg.solve(chol, np.eye(self.dim))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.chol_inv = f32(chol_inv)
        self.prec = f32(chol_inv.T @ chol_inv)
        self.counts = f32(counts)
        self.mu = math.log(126.0) - 0.5 * SIGNAL_VARIANCE
        self.a = 1.0 / self.dim
        self.norm = -0.5 * self.dim * math.log(2 * math.pi) - float(np.log(np.diag(chol)).sum())

    def log_prob(self, z):
        white = (z - self.mu) @ self.chol_inv.T
        poisson = torch.sum(z * self.counts - self.a * torch.exp(z), -1)
        return self.norm - 0.5 * torch.sum(white * white, -1) + poisson

    def score(self, z):
        return -((z - self.mu) @ self.prec) + self.counts - self.a * torch.exp(z)


def make_target(device):
    return Lgcp(device)
