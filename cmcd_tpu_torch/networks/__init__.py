"""Score network factory (cmcd_tpu/networks/__init__.py).

Only the geffner arch is ported; the PIS nets ("dds", "dds_grad") wait for
ROADMAP queue A.
"""

from cmcd_tpu_torch.networks.geffner import GeffnerNet, build_geffner_network


def build_score_network(x_dim, emb_dim, nbridges, nlayers=2,
                        arch="geffner", generator=None, device=None, rho_dim=0):
    """Returns (net, apply_fn): apply_fn(net, x, i) -> (N, x_dim) with x
    (N, x_dim + rho_dim)."""
    if arch != "geffner":
        raise NotImplementedError(
            f"nn arch {arch!r} is not ported yet: see ROADMAP queue A (PIS nets)"
        )
    return build_geffner_network(x_dim, emb_dim, nbridges, nlayers,
                                 generator=generator, device=device, rho_dim=rho_dim)


__all__ = ["GeffnerNet", "build_geffner_network", "build_score_network"]
