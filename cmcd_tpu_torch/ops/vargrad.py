"""The VarGrad backward, replaying a stored trajectory or rolling it again:
wrappers of the two CUDA kernels (csrc/vargrad.cu) and their plain PyTorch
versions.

Counterpart of cmcd_tpu/ops/pallas_vargrad.py::evolve_vargrad_bwd_replay and
::evolve_vargrad_bwd_pallas, with the port's layout: traj (K + 1, N, dim)
holds z_0..z_K as the fused rollout stored them (ops/overdamped.py,
return_trajectory=True), cot (N,) is the cotangent of each chain's summed
log-weight increments. The re-rolling form takes z0 (N, dim) and the
rollout's seed (or its injected noise) instead of the trajectory and makes
every z_j again, so nothing is stored between forward and backward. Both
return the gradient of  sum_n cot_n * sum_i (bk_lp_i - fk_lp_i)  with every
state held fixed (VarGrad's stop-gradient), as a dict
  {"eps": (), "betas": (K,), "vd_mean": (dim,), "vd_logdiag": (dim,),
   "sn": {parameter name of the GeffnerNet: gradient in that parameter's shape}}
or, for a PIS net, "sn" keyed by the names of its kernel view (ops/nets.py:
w1x, c1, w2, b2, headw, headb and dds_grad's gate), which the fused losses
hand on to autograd.

The kernels write every derivative out by hand and reduce over chains and
points themselves; the wrapper only transposes the one product it also makes on
the way in (c1 = emb @ W1[dim:] + b1, ops/nets.pack_geffner): from
the kernel's per-point sums over chains it forms d emb, d W1[dim:] and d b1
with two small matrix products. A PIS net's tables (ops/nets.pis_view) get
the per-point sums as they are. The plain version states the point loss
over the whole (K + 1, N) array and lets torch.autograd differentiate it.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cmcd_tpu_torch.distributions import LOG_2PI
from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR, OverdampedSpec
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops.overdamped import (
    EPS_SCHEDULES,
    MAX_SMEM,
    check_logreg_form,
    check_net,
    check_target,
    count_launch,
    evolve_overdamped_fused_plain,
)
from cmcd_tpu_torch.ops.target_grads import (
    KERNEL_DIMS,
    MAX_TARGET_FLOATS,
    kernel_target,
    n_target_floats,
)
from cmcd_tpu_torch.schedules import eps_per_step

# The kernels' limits, mirrored from csrc/cmcd_tile.cuh and csrc/vargrad.cu
# (checked against the built kernels' own in _library()).
GROUPS = 4                # NG of the replay kernel: groups of feature threads
CHAINS_PER_GROUP = 8      # TC
CHAINS_PER_TILE = GROUPS * CHAINS_PER_GROUP
GROUP_THREADS = 160       # FW_MAX: feature threads of one group


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def scalar_slots(dim: int) -> dict:
    """Slots<D> of csrc/cmcd_tile.cuh: where each scalar gradient sits among
    the sums that close a block's len_a (eps, vd mean, vd logdiag, factor_sn,
    head bias, gamma). A warp keeps the same slots with the two betas of its
    point before gamma."""
    return {"eps": 0, "vd_mean": slice(1, 1 + dim), "vd_logdiag": slice(1 + dim, 1 + 2 * dim),
            "factor_sn": 1 + 2 * dim, "head.bias": slice(2 + 2 * dim, 2 + 3 * dim),
            "gamma": 2 + 3 * dim}


def block_scalars(dim: int) -> int:
    """nsc_block(D): the scalar sums that close a block's len_a."""
    return scalar_slots(dim)["gamma"] + 1


def warp_scalars(dim: int) -> int:
    """nscal(D): the scalar sums a warp keeps (a block's and the two betas)."""
    return block_scalars(dim) + 2


def tile_floats(groups: int, in_dim: int, n_par: int, dim: int, gate: int = 0) -> int:
    """Floats of shared memory of the backward kernels' tile (csrc/
    cmcd_tile.cuh: W2 and the dW2 accumulator, the hidden tile both ways,
    the h2 / g_a2 tile, the dim head rows, the target's n_par constants and
    the per-warp scalars, with a PIS net's `gate` sums)."""
    ip, tb = _round_up(in_dim, 4), groups * CHAINS_PER_GROUP
    return (2 * ip * (ip + 1) + 2 * tb * ip + ip * (tb + 4) + dim * ip
            + _round_up(n_par, 4) + (warp_scalars(dim) + gate) * (groups * GROUP_THREADS // 32))


def extra_floats(dim: int) -> tuple:
    """Floats of shared memory beside the tile: (per chain of the tile, per
    warp of the block). VarGrad kernels: three states and g_out (dim-vectors),
    the cotangent."""
    return (4 * dim + 1, 0)


def smem_bytes(in_dim: int, n_par: int, groups: int = GROUPS, extra=None, *, dim: int,
               gate: int = 0) -> int:
    """Dynamic shared memory of one block of a backward kernel for a target
    of dimension dim: the tile (with `gate` sums a warp: a PIS net's dim,
    ops/nets.gate_slots) and the kernel's own `extra` floats per chain and
    per warp (default this module's extra_floats(dim))."""
    per_chain, per_warp = extra_floats(dim) if extra is None else extra
    return 4 * (tile_floats(groups, in_dim, n_par, dim, gate)
                + per_chain * groups * CHAINS_PER_GROUP
                + per_warp * (groups * GROUP_THREADS // 32))


def kernel_fits(in_dim: int, n_par: int, dim: int, extra=None, gate: int = 0) -> bool:
    """True if a net of width in_dim and a target of n_par constants and
    dimension dim fit one block of a backward kernel at four groups, the
    larger form: a group's feature threads, the shared memory (`extra` and
    `gate` as in smem_bytes)."""
    return (
        in_dim >= 1
        and _round_up(in_dim, 32) <= GROUP_THREADS
        and 1 <= n_par <= MAX_TARGET_FLOATS
        and smem_bytes(in_dim, n_par, GROUPS, extra, dim=dim, gate=gate) <= MAX_SMEM
    )


def sweep_grid(n: int, device) -> tuple:
    """(groups, blocks) of a kernel that walks chain tiles sequentially (the
    re-rolling backward, the KL reverse sweep): tiles of 32 chains on four
    groups of feature threads, or, when those would leave SMs idle, tiles of
    16 chains on two; at most one block per SM, each taking tiles b, b + B, ..."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = 2 if -(-n // CHAINS_PER_TILE) < sms else 4
    return groups, min(-(-n // (groups * CHAINS_PER_GROUP)), sms)


def len_a(in_dim: int, dim: int, din: int | None = None) -> int:
    """Floats of a block's sums over its points (csrc/cmcd_tile.cuh): dW2,
    dheadW (dim rows), db2, dW1[:din] (din default dim), and the scalar sums
    of scalar_slots."""
    din = dim if din is None else din
    return in_dim * in_dim + (1 + dim + din) * in_dim + block_scalars(dim)


def len_b(in_dim: int, gate: int = 0) -> int:
    """Floats of a block's sums at one point: G1, GH1, the two betas and a
    PIS net's `gate` sums."""
    return 2 * in_dim + 2 + gate


# The VarGrad kernels' spec: the point loss with every state held fixed.
VARGRAD_SPECS = (CAIS_VAR,)


def check_backward_config(what, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule,
                          fits=None, specs=VARGRAD_SPECS, sn2=None):
    """Raise on what the backward kernels do not take (both devices): a spec
    outside `specs`, a target the kernels do not inline at this dim, and for
    a spec with a net the two-layer geffner net or a PIS net of two equal
    widths (ops/nets.kernel_net_ok) at a width that fits one block
    (`fits`(width, n_par, dim, gate=...), default this module's
    kernel_fits; for DNF also sn2, a geffner net as sn, and nets=2)."""
    if spec not in specs:
        raise NotImplementedError(f"{what}: no kernel for spec {spec}")
    check_target(what, grad_logp, dim)
    check_logreg_form(what, grad_logp, spec, sn)
    if spec.use_sn2_bwd and sn2 is None:
        raise ValueError(f"{what}: DNF needs the second net's weights (sn2)")
    if spec.fwd_sn or spec.bwd_sn:
        two = {"nets": 2} if spec.use_sn2_bwd else {}
        check_net(what, sn, nbridges, dim, lambda width: (fits or kernel_fits)(
            width, n_target_floats(grad_logp), dim, gate=nets.gate_slots(sn, dim), **two),
            sn2 if spec.use_sn2_bwd else None)
    if eps_schedule not in EPS_SCHEDULES:
        raise ValueError(f"unknown eps schedule {eps_schedule!r}")
    if betas.shape != (nbridges,):
        raise ValueError(f"{what}: betas {tuple(betas.shape)} do not match K={nbridges}")


def check_device_tensors(what, dev, tensors):
    """A kernel reads raw pointers: contiguous f32 on its device, or raise."""
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous f32 on {dev}")


def _check(traj, cot, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule):
    n = cot.shape[0]
    check_backward_config("replay backward", betas, grad_logp, spec, dim, nbridges, sn,
                          eps_schedule)
    if traj.shape != (nbridges + 1, n, dim) or cot.shape != (n,):
        raise ValueError(
            f"replay backward: shapes traj {tuple(traj.shape)}, cot {tuple(cot.shape)} "
            f"do not match N={n}, dim={dim}, K={nbridges}"
        )


def _net_at_all_points(sn, weights: dict, traj, nbridges: int, gt):
    """The net at every stored point from its leaves (ops/nets.plain_weights):
    traj (K + 1, N, dim) -> (K + 1, N, dim), point j at table row
    ops/nets.net_row(j) (geffner min(j, K - 1), PIS j); gt the kernel score
    at every point, for dds_grad's gate term."""
    rows = nets.net_row(sn, torch.arange(nbridges + 1, device=traj.device), nbridges)
    return nets.apply_from_weights(sn, weights, traj, rows, gt)


def evolve_vargrad_bwd_replay_plain(
    traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """The kernel's function in plain torch: the point loss over the whole
    (K + 1, N) array, differentiated by autograd, in traj's dtype (float64
    to arbitrate between float32 summation orders). All states are data."""
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    leaf = lambda t: torch.as_tensor(t, device=traj.device).detach().to(traj.dtype) \
        .clone().requires_grad_(True)
    theta = {"eps": leaf(eps), "betas": leaf(betas), "vd_mean": leaf(vd_mean),
             "vd_logdiag": leaf(vd_logdiag)}
    weights = nets.plain_weights(sn, nbridges, traj.dtype, traj.device)
    traj = traj.detach()
    with torch.no_grad():
        gt_raw = gt = grad_logp(traj.reshape(-1, dim)).reshape(traj.shape)
        if clip_t is not None:
            gt = torch.clamp(gt, -clip_t, clip_t)
    with torch.enable_grad():
        sn_out = _net_at_all_points(sn, weights, traj, nbridges, gt_raw)
        gq = -(traj - theta["vd_mean"]) * torch.exp(-2.0 * theta["vd_logdiag"])
        if clip_q is not None:
            gq = torch.clamp(gq, -clip_q, clip_q)
        e = eps_per_step(theta["eps"], nbridges, eps_schedule)[:, None, None]
        b = theta["betas"][:, None, None]
        drift = b * gt[:-1] + (1.0 - b) * gq[:-1]      # at z_i under beta_i
        drift_next = b * gt[1:] + (1.0 - b) * gq[1:]  # at z_{i+1} under beta_i
        z, z_next = traj[:-1], traj[1:]
        fk_mean = z + e * drift - e * sn_out[:-1]
        bk_mean = z_next + e * drift_next + e * sn_out[1:]

        def log_prob(x, mean):
            r = x - mean
            return (-0.5 * torch.sum(r * r, -1) / (2.0 * e[..., 0])
                    - 0.5 * dim * (torch.log(2.0 * e[..., 0]) + LOG_2PI))

        deltas = torch.sum(log_prob(z, bk_mean) - log_prob(z_next, fk_mean), dim=0)
        loss = torch.sum(cot.detach().to(traj.dtype) * deltas)
        names = list(theta) + list(weights)
        grads = torch.autograd.grad(loss, [*theta.values(), *weights.values()])
    out = dict(zip(names, grads))
    return {**{k: out[k] for k in theta}, "sn": {k: out[k] for k in weights}}


def evolve_vargrad_bwd_reroll_plain(
    z0, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False, seed=0, noise=None,
):
    """The re-rolling kernel's function in plain torch: roll the trajectory
    again (ops/overdamped's plain rollout under the same injected noise, or
    under torch.randn draws from `seed`, which agree with the kernel's Philox
    draws in distribution only), then the replay's plain version on it."""
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping)
    _, _, traj = evolve_overdamped_fused_plain(
        z0, torch.zeros_like(cot), betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
        seed=seed, noise=noise, return_trajectory=True, **kwargs)
    return evolve_vargrad_bwd_replay_plain(
        traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, **kwargs)


def declare_limits(lib, prefix: str, extra, what: str):
    """Declare the limit queries of a backward kernel's library and check the
    module's formula (with the kernel's `extra`, a function of the state's
    dim) against them at every instantiated dim, for the geffner net (gate 0)
    and a PIS net (gate: its dim gate sums a warp): shared memory at both
    group counts, and what fits at the edges of the threads (160 / 161
    features), the shared memory (144 / 145 at dim 2; at dim 10 136 / 137
    for the KL sweep, 140 / 141 for the VarGrad kernels) and the target's
    constants."""
    i = ctypes.c_int
    get = lambda name: getattr(lib, f"cmcd_{prefix}_{name}")
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    get("chains_per_group").restype = i
    get("fits").argtypes = [i, i, i, i]
    get("fits").restype = i
    get("smem_bytes").argtypes = [i, i, i, i, i]
    get("smem_bytes").restype = ctypes.c_longlong
    get("len_a").argtypes = [i, i]
    get("len_b").argtypes = [i, i]
    get("len_a").restype = get("len_b").restype = i
    if get("chains_per_group")() != CHAINS_PER_GROUP:
        raise RuntimeError(f"{what} and its wrapper disagree on the chains of a group")
    for dim in sorted(set(KERNEL_DIMS.values())):
        for gate in (0, dim):
            for in_dim, n_par in ((0, 80), (18, 1), (22, 18), (58, 1), (64, 80), (132, 80),
                                  (136, 1), (137, 1), (140, 1), (141, 1), (144, 128), (145, 80),
                                  (160, 129), (161, 80), (132, 0)):
                if (bool(get("fits")(in_dim, n_par, dim, gate))
                        != kernel_fits(in_dim, n_par, dim, extra(dim), gate)
                        or any(get("smem_bytes")(g, in_dim, n_par, dim, gate)
                               != smem_bytes(in_dim, n_par, g, extra(dim), dim=dim, gate=gate)
                               for g in (2, 4))
                        or get("len_a")(in_dim, dim) != len_a(in_dim, dim)
                        or get("len_b")(in_dim, gate) != len_b(in_dim, gate)):
                    raise RuntimeError(
                        f"{what} and its wrapper disagree on what fits one block at "
                        f"in_dim {in_dim}, {n_par} target floats, dim {dim}, gate {gate}"
                    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("vargrad")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_vargrad_replay.argtypes = [p] * 18 + [i] * 8 + [f] * 3 + [i, p, p]
    lib.cmcd_vargrad_replay.restype = ctypes.c_int
    lib.cmcd_vargrad_reroll.argtypes = [p] * 20 + [i] * 9 + [f] * 3 + [i, p, p]
    lib.cmcd_vargrad_reroll.restype = ctypes.c_int
    declare_limits(lib, "vargrad", extra_floats, "csrc/vargrad.cu")
    return lib


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def marshal(what, sn, dim, nbridges, eps, grad_logp, dev, blocks, points, splits):
    """What every backward launch with a net passes besides its own data:
    ([eps0, factor_sn], the net as the kernels see it (ops/nets.pack: its
    weights, in_dim, emb_dim, arch and gate table), the target
    (ops/target_grads.kernel_target: code, constants, inverse variance), the
    scratch and result buffers (part_a, part_b, out_a, out_b))."""
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()
    packed = nets.pack(sn, nbridges)
    scal = torch.stack([f32(eps).reshape(()), packed["factor"].to(dev, torch.float32)])
    for t in packed["weights"] + [packed["gate"]]:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"{what}: net weights must be f32 on {dev}")
    width = packed["in_dim"]
    la, lb = len_a(width, dim), len_b(width, nets.gate_slots(sn, dim))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    buffers = [new(blocks, la), new(points, splits, lb), new(la), new(points, lb)]
    return scal, packed, kernel_target(grad_logp, dev), buffers


def clips(spec, grad_clipping):
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    return (math.inf if clip_t is None else clip_t, math.inf if clip_q is None else clip_q)


def raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: {lib.cmcd_error_string(err).decode()} ({err})")


def assemble_grads(out_a, out_b, sn, dim, nbridges, row_shift=False):
    """The gradient dict from a backward kernel's sums. out_a: dW2 (in x
    out), dheadW (dim x in), db2, dW1[:din] (din = dim + the net's rho_dim),
    then eps, mean (dim), logdiag (dim), factor, headb (dim), gamma (left out
    here: only the underdamped sweep has it, ops/kl_underdamped.py). out_b per point: G1 = sum_n g_a1,
    GH1 = sum_n g_h1, dbeta_j (the point's forward term), dbeta_{j-1} (its
    backward term), and a PIS net's gate sums. Point j's net used embedding
    row min(j, K - 1) (a PIS net: table row j), or with row_shift (the
    backward net at i, ULA_sn) row j - 1 and none at j = 0."""
    in_dim = nets.net_width(sn)
    din = dim + sn.rho_dim
    sq = in_dim * in_dim
    s, at = out_a[sq + (dim + 1 + din) * in_dim:], scalar_slots(dim)
    g_betas = out_b[:nbridges, 2 * in_dim] + out_b[1:, 2 * in_dim + 1]
    head = {"eps": s[at["eps"]], "betas": g_betas, "vd_mean": s[at["vd_mean"]],
            "vd_logdiag": s[at["vd_logdiag"]]}
    if nets.is_pis(sn):
        g_sn = nets.pis_grads(out_a, out_b, sn, dim, nbridges, row_shift)
        return {**head, "sn": {**g_sn, "headb": s[at["head.bias"]]}}
    g_w2 = out_a[:sq].view(in_dim, in_dim)
    g_headw = out_a[sq:sq + dim * in_dim].view(dim, in_dim)
    g_b2 = out_a[sq + dim * in_dim:sq + (dim + 1) * in_dim]
    g_w1x = out_a[sq + (dim + 1) * in_dim:sq + (dim + 1 + din) * in_dim].view(din, in_dim)
    g1, gh1 = out_b[:, :in_dim], out_b[:, in_dim:2 * in_dim]
    # Point K used embedding row K - 1: fold it in (or shift every point one
    # row down), then transpose c1's product: d c1 -> d emb, d W1[din:], d b1;
    # emb also feeds h0 directly.
    if row_shift:
        d_c1, d_emb = g1[1:].clone(), gh1[1:, din:].clone()
    else:
        d_c1 = g1[:nbridges].clone()
        d_c1[nbridges - 1] += g1[nbridges]
        d_emb = gh1[:nbridges, din:].clone()
        d_emb[nbridges - 1] += gh1[nbridges, din:]
    w1 = sn.layers[0].weight.detach().t()            # (in, out)
    d_emb = d_emb + d_c1 @ w1[din:].t()
    g_w1 = torch.cat([g_w1x, sn.emb.detach().t() @ d_c1])  # (in, out)
    return {
        **head,
        "sn": {
            "layers.0.weight": g_w1.t(), "layers.0.bias": d_c1.sum(0),
            "layers.1.weight": g_w2.t(), "layers.1.bias": g_b2,
            "head.weight": g_headw, "head.bias": s[at["head.bias"]],
            "emb": d_emb, "factor_sn": s[at["factor_sn"]],
        },
    }


def _launch(lib, traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *,
            dim, nbridges, sn, eps_schedule, grad_clipping, splits, stream):
    """Marshal the arguments, launch the replay kernel, assemble the dict."""
    points = nbridges + 1
    scal, net, (code, tpar, inv_var), buffers = marshal(
        "replay backward", sn, dim, nbridges, eps, grad_logp, traj.device, points * splits,
        points, splits)
    err = lib.cmcd_vargrad_replay(
        ptr(traj), ptr(cot), ptr(betas), ptr(scal),
        *(ptr(t) for t in net["weights"]),
        ptr(tpar), ptr(vd_mean), ptr(vd_logdiag),
        *(ptr(t) for t in buffers),
        cot.shape[0], nbridges, net["in_dim"], net["emb_dim"], tpar.numel(),
        EPS_SCHEDULES[eps_schedule], splits, code,
        inv_var, *clips(spec, grad_clipping), net["arch"], ptr(net["gate"]),
        ctypes.c_void_p(stream),
    )
    raise_on(err, lib, "vargrad replay")
    return assemble_grads(buffers[2], buffers[3], sn, dim, nbridges)


def _launch_reroll(lib, z0, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *,
                   dim, nbridges, sn, eps_schedule, grad_clipping, seed, noise, groups, blocks,
                   stream):
    """Marshal the arguments, launch the re-rolling kernel, assemble the dict."""
    points = nbridges + 1
    scal, net, (code, tpar, inv_var), buffers = marshal(
        "reroll backward", sn, dim, nbridges, eps, grad_logp, z0.device, blocks, points, blocks)
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=z0.device).reshape(1)
    err = lib.cmcd_vargrad_reroll(
        ptr(z0), ptr(cot), ptr(betas), ptr(noise), ptr(scal), ptr(seed_t),
        *(ptr(t) for t in net["weights"]),
        ptr(tpar), ptr(vd_mean), ptr(vd_logdiag),
        *(ptr(t) for t in buffers),
        cot.shape[0], nbridges, net["in_dim"], net["emb_dim"], tpar.numel(),
        EPS_SCHEDULES[eps_schedule], blocks, groups, code,
        inv_var, *clips(spec, grad_clipping), net["arch"], ptr(net["gate"]),
        ctypes.c_void_p(stream),
    )
    raise_on(err, lib, "vargrad reroll")
    return assemble_grads(buffers[2], buffers[3], sn, dim, nbridges)


@torch.no_grad()
def evolve_vargrad_bwd_replay(
    traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """VarGrad gradient from the stored trajectory, in one launch of the
    backward kernel and one of its reduction.

    traj: (K + 1, N, dim) f32; cot: (N,) f32; betas: (K,); eps: scalar tensor
    or float; vd_mean / vd_logdiag: (dim,); grad_logp: a kernel-form score of
    ops/target_grads at its KERNEL_DIMS dim; sn: the GeffnerNet or a PIS net. Returns the
    gradient dict described in the module docstring.
    """
    _check(traj, cot, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule)
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping)
    if traj.device.type == "cpu":
        return evolve_vargrad_bwd_replay_plain(
            traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, **kwargs
        )
    if traj.device.type != "cuda":
        raise ValueError(f"replay backward: no kernel for device {traj.device}")
    dev = traj.device
    check_device_tensors("replay backward", dev, (traj, cot, betas, vd_mean, vd_logdiag))
    # Enough blocks to fill the card once: one per point, times chain splits.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-cot.shape[0] // CHAINS_PER_TILE)
    splits = max(1, min(tiles, -(-sms // (nbridges + 1))))
    grads = _launch(
        _library(), traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
        splits=splits, stream=torch.cuda.current_stream(dev).cuda_stream, **kwargs,
    )
    count_launch(evolve_vargrad_bwd_replay, launch_form(grad_logp, sn))
    return grads


def launch_form(grad_logp, sn) -> str:
    """The VarGrad kernels' form of a launch: the target, and "/dds" or
    "/dds_grad" after it for a PIS net."""
    word = nets.net_word(sn)
    return grad_logp.kernel_name + (f"/{word}" if word else "")


# Launches in all, and by form (launch_form).
evolve_vargrad_bwd_replay.launches = 0
evolve_vargrad_bwd_replay.form_launches = {}


@torch.no_grad()
def evolve_vargrad_bwd_reroll(
    z0, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False, seed=0, noise=None,
):
    """VarGrad gradient with the trajectory rolled again from z0 inside the
    kernel, in one launch and one of its reduction; nothing but z0 is kept
    from the forward.

    z0: (N, dim) f32, the rollout's start; seed: the rollout's seed (int or
    one-element integer tensor), whose Philox draws the kernel makes again;
    noise: the rollout's injected (K, N, dim) normals instead. The rest as
    evolve_vargrad_bwd_replay, and the same gradient dict.
    """
    n = cot.shape[0]
    check_backward_config("reroll backward", betas, grad_logp, spec, dim, nbridges, sn,
                          eps_schedule)
    if z0.shape != (n, dim) or cot.shape != (n,) or (
            noise is not None and noise.shape != (nbridges, n, dim)):
        raise ValueError(f"reroll backward: shapes do not match N={n}, dim={dim}, K={nbridges}")
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping, seed=seed, noise=noise)
    if z0.device.type == "cpu":
        return evolve_vargrad_bwd_reroll_plain(
            z0, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, **kwargs
        )
    if z0.device.type != "cuda":
        raise ValueError(f"reroll backward: no kernel for device {z0.device}")
    dev = z0.device
    check_device_tensors("reroll backward", dev, [z0, cot, betas, vd_mean, vd_logdiag]
                         + ([noise] if noise is not None else []))
    groups, blocks = sweep_grid(n, dev)
    grads = _launch_reroll(
        _library(), z0, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
        groups=groups, blocks=blocks, stream=torch.cuda.current_stream(dev).cuda_stream,
        **kwargs,
    )
    count_launch(evolve_vargrad_bwd_reroll, launch_form(grad_logp, sn))
    return grads


evolve_vargrad_bwd_reroll.launches = 0
evolve_vargrad_bwd_reroll.form_launches = {}
