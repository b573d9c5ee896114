"""Parameters between the JAX package and the port, both ways.

params_from_jax takes `jax.device_get(params)` of cmcd_tpu.initialize (a
tree of numpy arrays) and returns the port's params: the same
{"train": ..., "notrain": ...} tree of f32 tensors, with the score net as a
GeffnerNet, PISNet or PISGradNet (picked from the tree's keys: "emb",
"time_coder", "time_coder_grad") whose nn.Linear weights are the JAX
(in, out) matrices transposed. The tests feed both packages the same
weights this way. The PIS nets' time coefficients are no leaf of JAX's
tree (jnp.linspace inside the apply): the caller hands JAX's bits in as
`pis_coeff`, and dds_grad its `target_log_prob`. MCD_DNF's second net,
"sn2", converts as "sn" does.

params_to_numpy and grads_to_numpy go back: a port tree (values, or the
`.grad` of every leaf after `loss.backward()`) as nested dicts of numpy
arrays in the JAX layout (`layers[i]["w"]` is `Linear.weight.T`), so that
`jax.tree_util` flattens it in the same leaf order as `jax.grad`'s result
and a test can compare leaf by leaf. A leaf the loss does not use (eta and
gamma in an overdamped mode) has no `.grad`; JAX gives it zeros, and so
does grads_to_numpy.

The constructors build on the card unless told otherwise (device=None,
utils/device.resolve_device).
"""

from __future__ import annotations

import numpy as np
import torch

from cmcd_tpu_torch.networks.geffner import GeffnerNet
from cmcd_tpu_torch.networks.pis import PISGradNet, PISNet
from cmcd_tpu_torch.utils.device import resolve_device


def _t(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


@torch.no_grad()
def geffner_from_jax(sn, device=None) -> GeffnerNet:
    """A GeffnerNet holding the JAX geffner params `sn` (numpy tree)."""
    device = resolve_device(device)
    emb = np.asarray(sn["emb"])
    nbridges, emb_dim = emb.shape
    in_dim, x_dim = np.asarray(sn["head"]["w"]).shape
    rho_dim = in_dim - x_dim - emb_dim  # the net of the full-sn underdamped modes sees [z, rho]
    if rho_dim not in (0, x_dim):
        raise ValueError(f"geffner net of in_dim {in_dim}: neither [z] nor [z, rho] with "
                         f"x_dim {x_dim} and emb_dim {emb_dim}")
    net = GeffnerNet(x_dim, emb_dim, nbridges, nlayers=len(sn["layers"]), device=device,
                     rho_dim=rho_dim)
    for lin, layer in zip([*net.layers, net.head], [*sn["layers"], sn["head"]]):
        lin.weight.copy_(_t(layer["w"], device).t())
        lin.bias.copy_(_t(layer["b"], device))
    net.emb.copy_(_t(emb, device))
    net.factor_sn.copy_(_t(sn["factor_sn"], device).reshape(()))
    return net


def _copy_dense(lins, layers, device):
    for lin, layer in zip(lins, layers):
        lin.weight.copy_(_t(layer["w"], device).t())
        lin.bias.copy_(_t(layer["b"], device))


@torch.no_grad()
def pis_from_jax(sn, device=None, pis_coeff=None, target_log_prob=None) -> PISNet:
    """A PISNet ("time_coder" in the tree) or PISGradNet ("time_coder_grad")
    holding the JAX PIS params `sn` (numpy tree); pis_coeff: the time
    coefficients the JAX net uses (jnp.linspace's float32 bits), or None to
    keep the port's own."""
    device = resolve_device(device)
    state = sn["state_net"]
    units = [np.asarray(layer["w"]).shape[1] for layer in state[:-1]]
    x_dim = np.asarray(state[-1]["w"]).shape[1]
    in_dim = np.asarray(state[0]["w"]).shape[0] - units[0]
    if "time_coder_grad" in sn:
        net = PISGradNet(x_dim, units, in_dim - x_dim, target_log_prob, device=device)
        _copy_dense(net.time_coder_state, sn["time_coder_state"], device)
        _copy_dense(net.time_coder_grad, sn["time_coder_grad"], device)
    else:
        net = PISNet(x_dim, units, in_dim - x_dim, device=device)
        _copy_dense(net.time_coder, sn["time_coder"], device)
    _copy_dense(net.state_net, state, device)
    net.timestep_phase.copy_(_t(sn["timestep_phase"], device))
    if pis_coeff is not None:
        net.coeff.copy_(_t(np.asarray(pis_coeff).reshape(-1), device))
    return net


def _value(t):
    return t.detach().cpu().numpy()


def _grad(t):
    return _value(torch.zeros_like(t) if t.grad is None else t.grad)


def geffner_to_numpy(net: GeffnerNet, leaf=_value) -> dict:
    """The inverse of geffner_from_jax: the JAX layout as numpy arrays."""
    dense = lambda lin: {"w": leaf(lin.weight).T, "b": leaf(lin.bias)}
    return {
        "layers": [dense(lin) for lin in net.layers],
        "head": dense(net.head),
        "emb": leaf(net.emb),
        "factor_sn": leaf(net.factor_sn),
    }


def pis_to_numpy(net: PISNet, leaf=_value) -> dict:
    """The inverse of pis_from_jax (the coefficients are no leaf of JAX's
    tree and stay out)."""
    dense = lambda lins: [{"w": leaf(lin.weight).T, "b": leaf(lin.bias)} for lin in lins]
    out = {"timestep_phase": leaf(net.timestep_phase), "state_net": dense(net.state_net)}
    if isinstance(net, PISGradNet):
        out["time_coder_state"] = dense(net.time_coder_state)
        out["time_coder_grad"] = dense(net.time_coder_grad)
    else:
        out["time_coder"] = dense(net.time_coder)
    return out


def _to_numpy(tree, leaf):
    if isinstance(tree, GeffnerNet):
        return geffner_to_numpy(tree, leaf)
    if isinstance(tree, PISNet):
        return pis_to_numpy(tree, leaf)
    if isinstance(tree, dict):
        return {k: _to_numpy(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def params_to_numpy(tree) -> dict:
    """A port tree's values in the JAX layout (nested dicts of numpy)."""
    return _to_numpy(tree, _value)


def grads_to_numpy(tree) -> dict:
    """The `.grad` of every leaf of a port tree in the JAX layout; zeros
    where a leaf has none."""
    return _to_numpy(tree, _grad)


def params_from_jax(tree, device=None, pis_coeff=None, target_log_prob=None):
    """Convert a numpy tree of JAX params (nested dicts) to the port's; the
    net's arch from its keys (pis_coeff and target_log_prob: pis_from_jax)."""
    device = resolve_device(device)

    def convert(key, value):
        if key in ("sn", "sn2") and "emb" in value:
            return geffner_from_jax(value, device)
        if key in ("sn", "sn2"):
            return pis_from_jax(value, device, pis_coeff, target_log_prob)
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        return _t(value, device)

    return {k: convert(k, v) for k, v in tree.items()}
