"""Log-Gaussian Cox process on the Finnish pines data, 1600-dim
(cmcd_tpu/targets/lgcp.py).

The same 40 x 40 discretisation, kernel (sigma^2 = 1.91, length scale 1/33)
and Poisson likelihood; the port reads its own copy of the data
(`data/pines.csv`). The grid, the Gram matrix, its Cholesky factor L and
L^{-1} are built once, in float64 numpy, when the target is made:

  whitened:    log p(w) = -D/2 log 2pi - |w|^2 / 2 + sum(x * counts - a e^x),
               x = L w + mu
  unwhitened:  log p(z) = -D/2 log 2pi - log|L| - |L^{-1}(z - mu)|^2 / 2
                          + sum(z * counts - a e^z)

with a = 1 / D and mu = log 126 - sigma^2 / 2. The unwhitened form reads
L^{-1} as the JAX package does, (z - mu) @ L^{-1}^T, not a triangular
solve. The target also keeps the float32 constants the kernel-form score
reads (ops/target_grads.py::LgcpScore), so that nothing is rebuilt per
step: L, the precision matrix Sigma^{-1} = L^{-T} L^{-1} (formed in float64,
then cast) and the bin counts, on the target's device. The
log-density runs in the input's dtype.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from cmcd_tpu_torch.targets.base import Target

DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "pines.csv")
SIGNAL_VARIANCE = 1.91
LENGTH_SCALE = 1.0 / 33


def get_bin_counts(points: np.ndarray, num_bins_per_dim: int) -> np.ndarray:
    """Points per grid cell; a point on the upper edge falls into the last
    bin (cmcd_tpu/targets/lgcp.py::get_bin_counts)."""
    idx = np.minimum(np.floor(points * num_bins_per_dim).astype(int), num_bins_per_dim - 1)
    counts = np.zeros((num_bins_per_dim, num_bins_per_dim))
    for row, col in idx:
        counts[row, col] += 1
    return counts


def get_bin_vals(num_bins: int) -> np.ndarray:
    """Grid coordinates in row-major (i, j) order, float64."""
    ii, jj = np.meshgrid(np.arange(num_bins), np.arange(num_bins), indexing="ij")
    return np.stack([ii.ravel(), jj.ravel()], axis=-1).astype(np.float64)


def gram_matrix(bin_vals, signal_variance, num_grid_per_dim, raw_length_scale):
    """K(m, n) = sv * exp(-|m - n| / (M * ell)), float64."""
    diff = bin_vals[:, None, :] - bin_vals[None, :, :]
    dist = np.sqrt(np.sum(diff * diff, axis=-1))
    return signal_variance * np.exp(-dist / (num_grid_per_dim * raw_length_scale))


def make_lgcp(use_whitened: bool = False, file_path: str | None = None, num_dim: int = 1600,
              device=None) -> Target:
    """The LGCP target on `device` (the caller's; load_target resolves it).
    file_path None or "" is the bundled pines.csv."""
    grid = int(math.isqrt(num_dim))
    if grid * grid != num_dim:
        raise ValueError("num_dim must be a square number for LGCP")
    file_path = file_path or DATA_PATH
    pines = np.genfromtxt(file_path, delimiter=",")
    counts = get_bin_counts(pines, grid).reshape(num_dim)
    a = 1.0 / num_dim
    gram = gram_matrix(get_bin_vals(grid), SIGNAL_VARIANCE, grid, LENGTH_SCALE)
    chol = np.linalg.cholesky(gram)
    chol_inv = np.linalg.inv(chol)
    half_log_det = float(np.sum(np.log(np.abs(np.diag(chol)))))
    white_norm = -0.5 * num_dim * math.log(2.0 * math.pi)
    unwhite_norm = white_norm - half_log_det
    mu = math.log(126.0) - 0.5 * SIGNAL_VARIANCE

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    constants = {"chol": f32(chol), "prec": f32(chol_inv.T @ chol_inv), "counts": f32(counts),
                 "mu": mu, "a": a}
    chol_t, chol_inv_t, counts_t = constants["chol"], f32(chol_inv), constants["counts"]

    def poisson(x):
        return torch.sum(x * counts_t.to(x.dtype) - a * torch.exp(x), dim=-1)

    def whitened_log_prob(w):
        """w: (N, D) -> (N,)."""
        prior = white_norm - 0.5 * torch.sum(w * w, dim=-1)
        return prior + poisson(w @ chol_t.to(w.dtype).T + mu)

    def unwhitened_log_prob(z):
        """z: (N, D) -> (N,)."""
        white = (z - mu) @ chol_inv_t.to(z.dtype).T
        return unwhite_norm - 0.5 * torch.sum(white * white, dim=-1) + poisson(z)

    return Target(
        name="lgcp",
        dim=num_dim,
        log_prob=whitened_log_prob if use_whitened else unwhitened_log_prob,
        params={
            "use_whitened": use_whitened,
            "num_dim": num_dim,
            "default_data": os.path.abspath(file_path) == os.path.abspath(DATA_PATH),
        },
        constants=constants,
    )
