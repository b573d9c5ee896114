"""The score nets as the overdamped kernels see them (counterpart of
cmcd_tpu/ops/pallas_nets.py: pack_pis_t, pis_apply_t, pack_pis_grad_t,
pis_grad_apply_t, make_kernel_net), and the plain apply from those weights
that the kernels' plain versions differentiate.

The kernels with a net tile (csrc/overdamped.cu, kl.cu, vargrad.cu) take a
net policy (csrc/cmcd_common.cuh: GeffnerNet, PisNet) and one layout for
both: w1x (din, F) the input rows of layer 1, c1 (rows, F) the part of
layer 1 that is the same for every chain, w2 (F, F) input x output, b2
(F,), headw (D, F), headb (D,). Geffner: F = in_dim, c1 = emb @ W1[din:] +
b1 with K rows (pack_geffner). PIS ("dds", "dds_grad", networks/pis.py):
F the state net's width, and

    c1[t]  = W1[D:] h_t(t) + b1,   t = 0..K (K + 1 rows: the CAIS backward
                                   net asks for t = K at the last step)
    gate[t] = g_t(t)                dds_grad's gate MLP, (K + 1, D)

with h_t the time coder on [sin, cos](coeff * t + phase). The tables do not
depend on the chain, so pis_view forms them once per call, with autograd
on: the sine's argument in the net's float32 (as its own forward), the rest
in float64, so that the card's TF32 setting cannot round them. Handed to a
kernel's torch.autograd.Function as inputs, they take the gradients the
kernels return (d c1 per point from the per-point sums G1, d gate from the
gate sums) back through autograd to the time coder, phase, W1[D:], b1 and
the gate MLP, the split geffner's c1 has in ops/vargrad.assemble_grads.

The row of a point's net: geffner min(idx, K - 1) (its embedding has K
rows), PIS idx itself (net_row).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cmcd_tpu_torch.networks.geffner import GeffnerNet, softplus
from cmcd_tpu_torch.networks.pis import LGV_CLIP, NN_CLIP, PISGradNet, PISNet, gelu

# csrc/cmcd_common.cuh's net codes (the `arch` of every launch with a net).
ARCH_GEFFNER, ARCH_PIS = 0, 1


def is_pis(sn) -> bool:
    return isinstance(sn, PISNet)


def net_word(sn):
    """"dds" or "dds_grad" for a PIS net (the suffix of its launch forms),
    None for geffner or no net."""
    if not is_pis(sn):
        return None
    return "dds_grad" if isinstance(sn, PISGradNet) else "dds"


def net_width(sn) -> int:
    """The kernels' feature count F: geffner's in_dim, a PIS net's width."""
    return sn.units[0] if is_pis(sn) else sn.in_dim


def gate_slots(sn, dim: int) -> int:
    """The per-warp gate sums of the backward kernels (NET::gate_slots)."""
    return dim if is_pis(sn) else 0


def check_kernel_net(what: str, sn, nbridges: int, dim: int):
    """Raise unless the kernels take the net `sn`: the two-layer geffner net
    with nbridges embedding rows, or a PIS net of two equal widths on the
    state (dim) alone."""
    if isinstance(sn, GeffnerNet):
        if len(sn.layers) != 2:
            raise NotImplementedError(f"{what}: the kernels inline the two-layer geffner net")
        if sn.nbridges != nbridges:
            raise ValueError(f"{what}: net embedding rows != nbridges")
    elif is_pis(sn):
        if len(sn.units) != 2 or sn.units[0] != sn.units[1]:
            raise NotImplementedError(
                f"{what}: the kernels inline PIS nets of two equal widths, not {sn.units}")
        if sn.rho_dim or sn.x_dim != dim:
            raise ValueError(f"{what}: a PIS net on x_dim {sn.x_dim} + rho_dim {sn.rho_dim}, "
                             f"the kernels take the state alone (dim {dim})")
    else:
        raise NotImplementedError(f"{what}: the kernels inline the geffner and PIS nets only")


def net_row(sn, idx, nbridges: int):
    """The table row of the net at time index idx (an int or a tensor of
    them): geffner's clamped to K - 1, a PIS net's idx itself."""
    if is_pis(sn):
        return idx
    if torch.is_tensor(idx):
        return idx.clamp(max=nbridges - 1)
    return min(idx, nbridges - 1)


def pis_view(sn: PISNet, nbridges: int, dtype=torch.float32) -> dict:
    """The kernels' view of a PIS net (w1x, c1, w2, b2, headw, headb and,
    for dds_grad, gate) as functions of its parameters (autograd on where the caller has it):
    the tables formed once in float64 and every entry cast to dtype."""
    l0, l1, head = sn.state_net
    din = sn.in_dim
    t = torch.arange(nbridges + 1, dtype=sn.coeff.dtype, device=sn.coeff.device)[:, None]
    arg = (sn.coeff * t + sn.timestep_phase).double()   # the net's own argument
    emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    lin = lambda x, layer: F.linear(x, layer.weight.double(), layer.bias.double())
    tc0, tc1 = sn.time_coder_layers()
    h_t = lin(gelu(lin(emb, tc0)), tc1)
    c1 = F.linear(h_t, l0.weight[:, din:].double(), l0.bias.double())
    view = {"w1x": l0.weight[:, :din].t(), "c1": c1, "w2": l1.weight.t(), "b2": l1.bias,
            "headw": head.weight, "headb": head.bias}
    if isinstance(sn, PISGradNet):
        g = lin(emb, sn.time_coder_grad[0])
        for layer in sn.time_coder_grad[1:]:
            g = lin(gelu(g), layer)
        view["gate"] = g
    return {k: v.to(dtype).contiguous() for k, v in view.items()}


@torch.no_grad()
def pack_geffner(sn: GeffnerNet):
    """The kernel's view of the geffner net: (w1x (din, in), c1 (K, in), emb,
    w2 (in, in) as input x output, b2, headw (x_dim, in), headb, factor),
    din = x_dim + rho_dim the columns of the net's input ahead of the
    embedding.

    c1 = emb @ W1[din:] + b1 is the embedding half of layer 1, the same for
    every chain; it is formed in float64 so that the TF32 setting of the
    card cannot round it."""
    din = sn.x_dim + sn.rho_dim
    l1, l2 = sn.layers
    w1 = l1.weight.t()                                   # (in, in): input x output
    c1 = (sn.emb.double() @ w1[din:].double() + l1.bias.double()).float()
    return (
        w1[:din].contiguous(), c1.contiguous(), sn.emb.detach().contiguous(),
        l2.weight.t().contiguous(), l2.bias.detach().contiguous(),
        sn.head.weight.detach().contiguous(), sn.head.bias.detach().contiguous(),
        sn.factor_sn.detach().reshape(()),
    )


@torch.no_grad()
def pack(sn, nbridges: int) -> dict:
    """What a launch passes for the net: {"weights": [w1x, c1, emb, w2, b2,
    headw, headb] (emb None for PIS), "factor": factor_sn (1 for PIS),
    "in_dim": F, "emb_dim", "arch", "gate": the gate table or None}."""
    if not is_pis(sn):
        *weights, factor = pack_geffner(sn)
        return {"weights": weights, "factor": factor, "in_dim": sn.in_dim,
                "emb_dim": sn.emb_dim, "arch": ARCH_GEFFNER, "gate": None}
    v = pis_view(sn, nbridges)
    return {"weights": [v["w1x"], v["c1"], None, v["w2"], v["b2"], v["headw"], v["headb"]],
            "factor": torch.ones((), device=v["c1"].device), "in_dim": net_width(sn),
            "emb_dim": 0, "arch": ARCH_PIS, "gate": v.get("gate")}


def function_inputs(sn, nbridges: int) -> tuple:
    """(names, tensors): the net's inputs to the fused losses'
    torch.autograd.Functions, whose gradients the backward kernels return
    under those names: geffner's parameters, or a PIS net's view formed
    here from its parameters (so autograd carries the view's gradients on
    to them)."""
    if not is_pis(sn):
        names, tensors = zip(*sn.named_parameters())
        return list(names), list(tensors)
    view = pis_view(sn, nbridges)
    return list(view), list(view.values())


def plain_weights(sn, nbridges: int, dtype, device) -> dict:
    """The leaves the plain versions differentiate in, in dtype: geffner's
    parameters by name, or a PIS net's view (the names of function_inputs)."""
    if is_pis(sn):
        with torch.no_grad():
            src = pis_view(sn, nbridges, dtype)
    else:
        src = dict(sn.named_parameters())
    return {name: torch.as_tensor(p, device=device).detach().to(dtype).clone()
            .requires_grad_(True) for name, p in src.items()}


def geffner_from_weights(weights: dict, z, rows):
    """The geffner net from a dict of its parameters (so that autograd
    differentiates in them, in their dtype): z (..., N, dim) with embedding
    row(s) `rows`, an index or a tensor of one index per leading entry."""
    emb = weights["emb"][rows]
    emb = emb[..., None, :].expand(*z.shape[:-1], -1)
    h = torch.cat([z, emb], dim=-1)
    for i in range(2):
        h = h + softplus(F.linear(h, weights[f"layers.{i}.weight"], weights[f"layers.{i}.bias"]))
    return F.linear(h, weights["head.weight"], weights["head.bias"]) * weights["factor_sn"]


def pis_from_weights(weights: dict, z, rows, gt=None):
    """A PIS net from its kernel view (pis_view's entries), as the kernels
    compute it: z (..., N, D) at table row(s) `rows`; gt the target's kernel
    score at z, which dds_grad's gate term reads (stop-gradient, clipped at
    1e2)."""
    c1 = weights["c1"][rows][..., None, :]
    h = gelu(z @ weights["w1x"] + c1)
    h = gelu(h @ weights["w2"] + weights["b2"])
    out = torch.clamp(F.linear(h, weights["headw"], weights["headb"]), -NN_CLIP, NN_CLIP)
    if "gate" in weights:
        out = out + weights["gate"][rows][..., None, :] * torch.clamp(gt.detach(), -LGV_CLIP,
                                                                      LGV_CLIP)
    return out


def apply_from_weights(sn, weights: dict, z, rows, gt=None):
    """The kernels' net (plain_weights' leaves) at z and table row(s) rows."""
    if is_pis(sn):
        return pis_from_weights(weights, z, rows, gt)
    return geffner_from_weights(weights, z, rows)


def plain_apply(sn, nbridges: int):
    """The plain rollout's net: f(z, idx, gt) -> (N, D) at time index idx,
    as the kernels compute it (geffner: the module itself, which clamps its
    row; PIS: its view, formed once)."""
    if not is_pis(sn):
        return lambda z, idx, gt: sn(z, idx)
    with torch.no_grad():
        view = pis_view(sn, nbridges, sn.coeff.dtype)
    return lambda z, idx, gt: pis_from_weights({k: v.to(z.dtype) for k, v in view.items()},
                                               z, idx, gt)


def pis_grads(out_a, out_b, sn, dim: int, nbridges: int, row_shift: bool = False) -> dict:
    """A PIS net's view gradients from a backward kernel's sums (the layout
    of ops/vargrad.assemble_grads; out_b's rows end in the gate sums). Point
    j's net used row j, or with row_shift (ULA_sn) row j - 1 and none at
    j = 0, whose table row K then gets nothing."""
    width = net_width(sn)
    sq = width * width
    g1 = out_b[:, :width]
    d_c1 = torch.cat([g1[1:], torch.zeros_like(g1[:1])]) if row_shift else g1
    grads = {
        "w1x": out_a[sq + (dim + 1) * width:sq + (2 * dim + 1) * width].view(dim, width),
        "c1": d_c1,
        "w2": out_a[:sq].view(width, width),
        "b2": out_a[sq + dim * width:sq + (dim + 1) * width],
        "headw": out_a[sq:sq + dim * width].view(dim, width),
    }
    if isinstance(sn, PISGradNet):
        g = out_b[:, 2 * width + 2:2 * width + 2 + dim]
        grads["gate"] = torch.cat([g[1:], torch.zeros_like(g[:1])]) if row_shift else g
    return grads
