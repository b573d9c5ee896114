"""Score network factory (cmcd_tpu/networks/__init__.py): the geffner net
and the PIS nets ("dds", "dds_grad")."""

from cmcd_tpu_torch.networks.geffner import GeffnerNet, build_geffner_network
from cmcd_tpu_torch.networks.pis import (
    PISGradNet,
    PISNet,
    build_pis_grad_network,
    build_pis_network,
)


def build_score_network(x_dim, emb_dim, nbridges, nlayers=2, arch="geffner", generator=None,
                        device=None, rho_dim=0, fully_connected_units=None,
                        target_log_prob=None):
    """Returns (net, apply_fn): apply_fn(net, x, i) -> (N, x_dim) with x
    (N, x_dim + rho_dim). arch "geffner" (emb_dim, nbridges, nlayers), "dds"
    or "dds_grad" (fully_connected_units, default [64, 64]; dds_grad needs
    target_log_prob for its score feature)."""
    if arch == "geffner":
        return build_geffner_network(x_dim, emb_dim, nbridges, nlayers, generator=generator,
                                     device=device, rho_dim=rho_dim)
    units = list(fully_connected_units or [64, 64])
    if arch == "dds":
        return build_pis_network(x_dim, units, rho_dim, generator=generator, device=device)
    if arch == "dds_grad":
        if target_log_prob is None:
            raise ValueError("dds_grad arch needs target_log_prob for its grad feature")
        return build_pis_grad_network(x_dim, units, rho_dim, target_log_prob,
                                      generator=generator, device=device)
    raise ValueError(f"Unknown nn arch: {arch}")


__all__ = ["GeffnerNet", "PISGradNet", "PISNet", "build_geffner_network",
           "build_pis_grad_network", "build_pis_network", "build_score_network"]
