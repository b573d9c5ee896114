"""Work counts of lgcp_k8 (the rule of the port's chip_smoke.py::_work_wide,
copied here): FP32 operations and device-memory bytes of each role from the
configuration's shapes. A point costs the net (layer 1's state part D x F,
layer 2 F x F, the head D x F: 2 D F + F^2 multiply-adds), the unwhitened
score (one D x D product) and ~30 operations a dimension; the split sweep
the same again for the VJP in z and the Hessian product. The bytes: the
weights and the target's matrix once, the states in and out.

  rollout      B1's wide form (with the trajectory and noise stores when
               training).
  backward     B12, the split KL sweep.
  weight_pass  the net's weight gradients outside the kernel, one batched
               pass over the K + 1 stored points of every chain: the
               forward again (2 D F + F^2), the cotangent back through the
               head and layer 2 (D F + F^2) and the three weight products
               (D F + 2 F^2) multiply-adds a point. Counted in the step's
               operations (mfu), matched to no kernel role.
"""

from __future__ import annotations


def _bound_parts(n, k, dim, in_dim, store):
    points = (k + 1) * n
    net = 2 * (2 * dim * in_dim + in_dim * in_dim)
    score = 2 * dim * dim
    elem = 30 * dim
    weights = 4 * (2 * dim * in_dim + in_dim * in_dim + 2 * in_dim + dim + k * (in_dim + 20))
    consts = 4 * (dim * dim + dim + 2)
    io = 4 * (dim * n + 2 * n + 2 * dim + k)
    stores = 4 * dim * (points + k * n) if store else 0
    rollout = (points * (net + score + elem), weights + consts + io + stores)
    sweep_bytes = (weights + consts + 4 * dim * (points + k * n) + 4 * (n + dim * n)
                   + 4 * (dim * points + dim * n) + 4 * (1 + k + 2 * dim))
    sweep = (points * (2 * (net + score) + 2 * elem), sweep_bytes)
    weight_pass = 2 * points * (4 * dim * in_dim + 4 * in_dim * in_dim)
    return rollout, sweep, weight_pass


def per_unit(config: dict, traffic: dict) -> dict:
    """{role: {"flops", "bytes", "launches"}} per unit of the traffic."""
    f = config["flags"]
    k, dim = f["nbridges"], config["dim"]
    in_dim = dim + f["emb_dim"]
    if traffic["loop"] == "train":
        rollout, sweep, weight_pass = _bound_parts(f["N"], k, dim, in_dim, True)
        return {"rollout": {"flops": rollout[0], "bytes": rollout[1], "launches": 1},
                "backward": {"flops": sweep[0], "bytes": sweep[1], "launches": 1},
                "weight_pass": {"flops": weight_pass, "bytes": 0, "launches": 1}}
    rollout, _, _ = _bound_parts(traffic["n_samples"], k, dim, in_dim, False)
    return {"rollout": {"flops": rollout[0], "bytes": rollout[1],
                        "launches": traffic["groups"]}}
