"""Bayesian logistic regression targets: log_australian, log_ionosphere,
log_sonar (cmcd_tpu/targets/logreg.py).

The model is
  w ~ N(0, I_dim);  y_i ~ Bernoulli(logits = x_i . w)
over z-scored features with a constant-1 bias column prepended, so dim is
the dataset's feature count plus one (15, 35, 61). The datasets are the
JAX package's .npz files, copied byte for byte into `data/`; they are read
with the same numpy operations on the stored dtypes (float32 features,
float64 labels in {-1, 1}), so X and y agree with the JAX package's bit for
bit. The target also keeps the float32 data the kernel-form score reads
(ops/target_grads.py::LogregScore), on the target's device, so that nothing
is rebuilt per step: X (n_data, dim), y (n_data,) and the kernels' copy,
X^T (dim x n_data, row-major) followed by y, in one flat tensor.

The log-likelihood y l - softplus(l) is written as y l + logsigmoid(-l):
the same function, whose first and second derivatives autograd forms
without an overflow at |l| > 88 (the eager KL loss differentiates the
score, so a NaN there would reach the parameters).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cmcd_tpu_torch.distributions import LOG_2PI
from cmcd_tpu_torch.targets.base import Target

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
# The datasets the port serves, by the name after "log_"; a1a and madelon
# wait in ROADMAP queue A (A5c2, A5c3).
DATASETS = ("australian", "ionosphere", "sonar")


def _standardize_and_pad(x):
    """Z-score the features (a zero std left as 1), then prepend a
    constant-1 bias column, in numpy on x's own dtype as the JAX package
    does (the ones are float64, so the result is float64)."""
    mean = np.mean(x, axis=0)
    std = np.std(x, axis=0)
    std[std == 0] = 1.0
    x = (x - mean) / std
    return np.hstack([np.ones((x.shape[0], 1)), x])


def load_logreg_data(dset: str):
    """(X (n_data, dim), y (n_data,)) of a dataset as float32 numpy arrays:
    the labels mapped from {-1, 1} to {0, 1} on their stored dtype first,
    then cast, in the JAX package's order."""
    if dset not in DATASETS:
        raise NotImplementedError(
            f"logistic regression on {dset!r} is not ported yet: see ROADMAP queue A "
            "(A5c2 a1a, A5c3 madelon)")
    data = np.load(os.path.join(DATA_DIR, f"{dset}.npz"))
    x, y = data["X"], data["Y"]
    y = (y + 1) // 2
    x = _standardize_and_pad(x)
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


def make_logreg(dset: str = "sonar", device=None) -> Target:
    """The posterior of `dset` on `device` (the caller's; load_target
    resolves it)."""
    x_np, y_np = load_logreg_data(dset)
    x = torch.as_tensor(x_np, device=device)
    y = torch.as_tensor(y_np, device=device)
    kernel_data = torch.cat([x.T.reshape(-1), y]).contiguous()

    def log_prob(w):
        """w: (N, dim) -> (N,), in w's dtype."""
        log_prior = -0.5 * torch.sum(w * w + LOG_2PI, dim=-1)
        logits = w @ x.to(w.dtype).T  # (N, n_data)
        log_lik = torch.sum(y.to(w.dtype) * logits + torch.nn.functional.logsigmoid(-logits),
                            dim=-1)
        return log_prior + log_lik

    return Target(name=f"log_{dset}", dim=x_np.shape[1], log_prob=log_prob,
                  params={"dset": dset},
                  constants={"x": x, "y": y, "kernel_data": kernel_data})
