"""Work counts of many_gmm_var: FP32 operations and device-memory bytes of
each kernel role, from the configuration's shapes alone (the rule of the
port's chip_smoke.py::_work, copied here so that the yardstick lives with
the benchmark). A point is one of the (K + 1) N states of a rollout; every
input byte is counted once read and every output byte once written.

  rollout   B1, the tile rollout: the score net (layer 2, layer 1's state
            part, the head) and the 40-component score at every point.
  backward  B2, the VarGrad replay: the apply again, W2 g_a2 and the outer
            product into dW2, on the stored trajectory.
"""

from __future__ import annotations


def _rollout(n, k, in_dim, n_mix, store):
    points = (k + 1) * n
    score = 6 * n_mix
    net_apply = in_dim * in_dim + 4 * in_dim
    weights = 4 * (2 * in_dim + k * in_dim + k * (in_dim - 2) + in_dim * in_dim + 3 * in_dim
                   + 2 + 2 * n_mix)
    flops = 2 * points * (net_apply + score)
    nbytes = 4 * (3 * n + k) + weights + 4 * (3 * n) + (8 * points if store else 0)
    return flops, nbytes, weights, score


def _backward(n, k, in_dim, n_mix):
    points = (k + 1) * n
    _, _, weights, score = _rollout(n, k, in_dim, n_mix, True)
    flops = 2 * points * (3 * in_dim * in_dim + 8 * in_dim + score)
    nbytes = 8 * points + 4 * (n + k) + weights + 4 * (in_dim * in_dim + 5 * in_dim + 8
                                                      + (k + 1) * (2 * in_dim + 2))
    return flops, nbytes


def per_unit(config: dict, traffic: dict) -> dict:
    """{role: {"flops", "bytes", "launches"}} per unit of the traffic (a
    training step, or an evaluation request of `groups` launches on
    `n_samples` chains)."""
    f = config["flags"]
    k, in_dim, n_mix = f["nbridges"], config["dim"] + f["emb_dim"], config["n_mixes"]
    if traffic["loop"] == "train":
        n = f["N"]
        fl, nb, _, _ = _rollout(n, k, in_dim, n_mix, True)
        bf, bb = _backward(n, k, in_dim, n_mix)
        return {"rollout": {"flops": fl, "bytes": nb, "launches": 1},
                "backward": {"flops": bf, "bytes": bb, "launches": 1}}
    fl, nb, _, _ = _rollout(traffic["n_samples"], k, in_dim, n_mix, False)
    return {"rollout": {"flops": fl, "bytes": nb, "launches": traffic["groups"]}}
