"""Parameters from the JAX package into the port.

params_from_jax takes `jax.device_get(params)` of cmcd_tpu.initialize (a
tree of numpy arrays) and returns the port's params: the same
{"train": ..., "notrain": ...} tree of f32 tensors, with the geffner net as
a GeffnerNet whose nn.Linear weights are the JAX (in, out) matrices
transposed. The tests feed both packages the same weights this way.
"""

from __future__ import annotations

import numpy as np
import torch

from cmcd_tpu_torch.networks.geffner import GeffnerNet


def _t(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


@torch.no_grad()
def geffner_from_jax(sn, device=None) -> GeffnerNet:
    """A GeffnerNet holding the JAX geffner params `sn` (numpy tree)."""
    emb = np.asarray(sn["emb"])
    nbridges, emb_dim = emb.shape
    in_dim, x_dim = np.asarray(sn["head"]["w"]).shape
    if in_dim != x_dim + emb_dim:
        raise NotImplementedError("geffner nets on [z, rho] are not ported yet")
    net = GeffnerNet(x_dim, emb_dim, nbridges, nlayers=len(sn["layers"]), device=device)
    for lin, layer in zip([*net.layers, net.head], [*sn["layers"], sn["head"]]):
        lin.weight.copy_(_t(layer["w"], device).t())
        lin.bias.copy_(_t(layer["b"], device))
    net.emb.copy_(_t(emb, device))
    net.factor_sn.copy_(_t(sn["factor_sn"], device).reshape(()))
    return net


def geffner_to_numpy(net: GeffnerNet) -> dict:
    """The inverse of geffner_from_jax: the JAX layout as numpy arrays."""
    dense = lambda lin: {"w": lin.weight.detach().t().cpu().numpy(),
                         "b": lin.bias.detach().cpu().numpy()}
    return {
        "layers": [dense(lin) for lin in net.layers],
        "head": dense(net.head),
        "emb": net.emb.detach().cpu().numpy(),
        "factor_sn": net.factor_sn.detach().cpu().numpy(),
    }


def params_from_jax(tree, device=None):
    """Convert a numpy tree of JAX params (nested dicts) to the port's."""

    def convert(key, value):
        if key in ("sn",):
            return geffner_from_jax(value, device)
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        return _t(value, device)

    return {k: convert(k, v) for k, v in tree.items()}
