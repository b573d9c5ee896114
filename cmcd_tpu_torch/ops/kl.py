"""The KL reverse sweep: wrapper of the CUDA kernels (csrc/kl.cu) and their
plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_pallas for the
overdamped specs that differentiate through the state (SWEEP_SPECS: CAIS,
with one net in both kernels and the backward net at i + 1; ULA_SN, with the
net in the backward kernel at i; ULA, with no net; DNF, with zero drift, the
net sn in the forward mean and a second geffner net sn2 in the backward
mean, whose sweep reads no score: "sn2" joins the gradient dict, keyed as
"sn", and betas and vd get zeros), on the many_gmm and the
3-mode gmm scores (dim 2) and the funnel's and the standard normal's (dim
10), and CAIS with the geffner net on the Bayesian logistic regressions
(dim 15, 35, 61; built from csrc/kl_logreg.cu, ops/overdamped.source_for),
with the port's layout: traj (K + 1, N, dim) and noise
(K, N, dim) as the fused rollout stored them (ops/overdamped.py,
return_trajectory and return_noise), cot (N,) the cotangent of each chain's
summed log-weight increments, g_zfinal (N, dim) that of its final state.
Nothing is stopped: the KL loss differentiates through the whole rollout, so
the state cotangent chains backward through every step, through the target
score's Jacobian and the net's. Returns (grads, g_z0): the gradient of
  sum_n [ cot_n * sum_i (bk_lp_i - fk_lp_i) + g_zfinal_n . z_K ]
in theta as the dict of ops/vargrad.py,
  {"eps": (), "betas": (K,), "vd_mean": (dim,), "vd_logdiag": (dim,),
   "sn": {parameter name of the GeffnerNet: gradient in that parameter's shape}}
("sn" empty for ULA; for a PIS net keyed by its kernel view's names,
ops/nets.py), and in the initial state, g_z0 (N, dim), for the
reparameterised draw. The net is the geffner net or a PIS net ("dds",
"dds_grad"), whose point p takes table row p (geffner: min(p, K - 1)).

The sweep visits each stored point once, from z_K down to z_0 (the
derivation is the header of csrc/kl.cu): the point's score (and net output)
serve both the step that ends there and the step that starts there, so each
is applied and transposed once. The kernels write every derivative out; the
plain version walks the same sweep with torch ops, the score's Hessian
product from ops/target_grads (the scores' hvp methods) and the net's
VJP from torch.autograd, in the dtype of `traj` (float64 to arbitrate
between two float32 summation orders).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches a kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.integrators.overdamped import CAIS, DNF, ULA, ULA_SN, OverdampedSpec
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops import vargrad as vg
from cmcd_tpu_torch.ops.overdamped import (
    EPS_SCHEDULES,
    checked_data,
    count_launch,
    form_key,
    source_for,
)
from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, MAX_TARGET_FLOATS, kernel_target
from cmcd_tpu_torch.schedules import eps_at_step

# The specs the sweep takes: those that keep the state in the graph.
SWEEP_SPECS = (CAIS, ULA, ULA_SN, DNF)
# The net-free sweep (kl_ula_sweep): chains per block.
ULA_CHAINS_PER_BLOCK = 8


def ula_len_sums(dim: int) -> int:
    """Floats of a block's sums in the net-free sweep: eps, vd mean, vd logdiag."""
    return 1 + 2 * dim


def extra_floats(dim: int) -> tuple:
    """Floats of shared memory beside the tile (ops/vargrad.smem_bytes). Per
    chain: three states, g_out, the state cotangent and the two carries
    (dim-vectors), the cotangent; per warp: its share of the net's input VJP
    for a group's chains (TC dim-vectors)."""
    return (7 * dim + 1, dim * vg.CHAINS_PER_GROUP)


def dnf_smem_bytes(in_dim: int, dim: int, groups: int = vg.GROUPS) -> int:
    """Dynamic shared memory of one block of DNF's sweep (csrc/kl.cu
    dnf_smem_bytes): the tile with no target constants, whose dW2 slot holds
    the second net's W2, that net's head rows and per-warp sums, the carry
    form's per-chain buffers and two nets' shares of the input VJP."""
    ip = vg._round_up(in_dim, 4)
    per_chain, per_warp = extra_floats(dim)
    return vg.smem_bytes(in_dim, 0, groups, (per_chain, 2 * per_warp + vg.warp_scalars(dim)),
                         dim=dim) + 4 * dim * ip


def kernel_fits(in_dim: int, n_par: int, dim: int, gate: int = 0, nets: int = 1) -> bool:
    """ops/vargrad.kernel_fits for one block of the sweep kernel (gate: a PIS
    net's gate sums a warp, ops/nets.gate_slots); nets 2: DNF's form, two
    geffner nets, no score (n_par not read)."""
    if nets == 2:
        return (in_dim >= 1 and vg._round_up(in_dim, 32) <= vg.GROUP_THREADS and gate == 0
                and n_par <= MAX_TARGET_FLOATS and dnf_smem_bytes(in_dim, dim) <= vg.MAX_SMEM)
    return vg.kernel_fits(in_dim, n_par, dim, extra_floats(dim), gate)



def _check(traj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn, sn2,
           eps_schedule):
    n = cot.shape[0]
    vg.check_backward_config("KL reverse sweep", betas, grad_logp, spec, dim, nbridges, sn,
                             eps_schedule, fits=kernel_fits, specs=SWEEP_SPECS, sn2=sn2)
    if (traj.shape != (nbridges + 1, n, dim) or noise.shape != (nbridges, n, dim)
            or cot.shape != (n,) or g_zfinal.shape != (n, dim)):
        raise ValueError(
            f"KL reverse sweep: shapes traj {tuple(traj.shape)}, noise {tuple(noise.shape)}, "
            f"cot {tuple(cot.shape)}, g_zfinal {tuple(g_zfinal.shape)} do not match N={n}, "
            f"dim={dim}, K={nbridges}"
        )


def _dnf_sweep_plain(traj, noise, cot, g_zfinal, eps, sn, sn2, nbridges, eps_schedule):
    """DNF's sweep (the derivation in csrc/kl.cu), point by point from z_K to
    z_0 in traj's dtype: sn(z_p, p) serves step p's forward mean (p < K),
    sn2(z_p, row(p, K)) step p - 1's backward mean (p >= 1), each
    transposed at its point by torch.autograd; no drift, so betas and vd
    get zeros."""
    K, dt, dev = nbridges, traj.dtype, traj.device
    as_t = lambda t: torch.as_tensor(t, device=dev).detach().to(dt)
    cot, eps0 = as_t(cot), as_t(eps).reshape(())
    step = [eps_at_step(eps0, j, K, eps_schedule) for j in range(K)]
    slope = [eps_at_step(1.0, j, K, eps_schedule) - eps_at_step(0.0, j, K, eps_schedule)
             for j in range(K)]
    leaves = {"sn": nets.plain_weights(sn, K, dt, dev), "sn2": nets.plain_weights(sn2, K, dt, dev)}
    g_w = {key: {name: torch.zeros_like(w) for name, w in ws.items()}
           for key, ws in leaves.items()}
    g_eps = torch.zeros((), dtype=dt, device=dev)
    c = cot[:, None]

    def vjp(key, net, z, row, g_out):
        """The net's output at (z, row) and, for the cotangent g_out(output)
        of it, the state's: its weights' gradients are summed into g_w."""
        with torch.enable_grad():
            z_in = z.clone().requires_grad_(True)
            out = nets.apply_from_weights(net, leaves[key], z_in, row)
        g = g_out(out.detach())
        g_z, *g_wp = torch.autograd.grad(out, [z_in, *leaves[key].values()], g)
        for name, gw in zip(g_w[key], g_wp):
            g_w[key][name] += gw
        return out.detach(), g_z

    fk, direct = None, as_t(g_zfinal)
    for p in range(K, -1, -1):
        z = traj[p].detach()
        total = direct
        if p <= K - 1:  # z_p starts step p: fk_mean = z_p - e sn(z_p, p)
            e = step[p]
            out, g_z = vjp("sn", sn, z, p, lambda o: -e * fk)
            g_eps = g_eps - slope[p] * torch.sum(fk * out)
            total = total + g_z
        if p >= 1:  # step p - 1's backward mean: z_p + e sn2(z_p, row(p, K))
            e = step[p - 1]
            parts = {}

            def g_sn2(o):
                r = traj[p - 1] - (z + e * o)
                parts["r"], parts["g_mean"] = r, c * r / (2.0 * e)
                return e * parts["g_mean"]

            out, g_z = vjp("sn2", sn2, z, nets.net_row(sn2, p, K), g_sn2)
            r, g_mean = parts["r"], parts["g_mean"]
            g_e = torch.sum(g_mean * out) + torch.sum(c * r * r) / (2.0 * e) ** 2
            total = total + g_mean + g_z
            g_e = g_e + torch.sum(total * noise[p - 1]) / torch.sqrt(2.0 * e)
            g_eps = g_eps + slope[p - 1] * g_e
            fk, direct = total, total - g_mean
    zeros = torch.zeros(traj.shape[-1], dtype=dt, device=dev)
    grads = {"eps": g_eps, "betas": torch.zeros(K, dtype=dt, device=dev), "vd_mean": zeros,
             "vd_logdiag": zeros.clone(), **g_w}
    return grads, total


@torch.no_grad()
def evolve_kl_bwd_plain(
    traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp,
    spec: OverdampedSpec, *, dim: int, nbridges: int, sn=None, sn2=None,
    eps_schedule: str = "", grad_clipping: bool = False, split: bool = False,
):
    """The kernels' function in plain torch, point by point from z_K to z_0,
    in traj's dtype, for every spec of SWEEP_SPECS. Carried between points:
    fk, the cotangent of the forward mean of the step that starts at the
    point, and direct, what the point's state gets from that step besides
    (g_zfinal at z_K). Point p's net output is sn(z_p, row p) for CAIS
    (ops/nets.net_row: geffner's min(p, K - 1)), serving both steps, and
    sn(z_p, p - 1) for ULA_SN, serving the backward mean of step p - 1 only
    (none at p = 0). A PIS net is its kernel view (ops/nets.plain_weights),
    dds_grad's gate term on the kernel score at z_p.

    split (the split sweep's plain version, ops/kl_split.py): the net's VJP
    in z only, "sn" left empty, and a third result, the stack (K + 1, N,
    dim) of each point's net-output cotangent g_sn.

    DNF (sn2 its second net): _dnf_sweep_plain, no split form."""
    if spec.use_sn2_bwd:
        return _dnf_sweep_plain(traj, noise, cot, g_zfinal, eps, sn, sn2, nbridges,
                                eps_schedule)
    K, dt, dev = nbridges, traj.dtype, traj.device
    as_t = lambda t: torch.as_tensor(t, device=dev).detach().to(dt)
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    betas, mu, logdiag, cot = as_t(betas), as_t(vd_mean), as_t(vd_logdiag), as_t(cot)
    eps0 = as_t(eps).reshape(())
    # eps_j = eps0 * slope_j + offset_j in every schedule.
    step = [eps_at_step(eps0, j, K, eps_schedule) for j in range(K)]
    slope = [eps_at_step(1.0, j, K, eps_schedule) - eps_at_step(0.0, j, K, eps_schedule)
             for j in range(K)]
    viv = torch.exp(-2.0 * logdiag)
    net = spec.bwd_sn
    weights = nets.plain_weights(sn, K, dt, dev) if net else {}
    g_w = {name: torch.zeros_like(w) for name, w in weights.items()}
    g_eps = torch.zeros((), dtype=dt, device=dev)
    g_betas, g_mu, g_ld = torch.zeros_like(betas), torch.zeros_like(mu), torch.zeros_like(mu)
    c = cot[:, None]

    fk, direct, gsn = None, as_t(g_zfinal), []
    for p in range(K, -1, -1):
        z = traj[p].detach()
        net_on = net and (spec.fwd_sn or p >= 1)
        sn_out = torch.zeros_like(z)
        gt = grad_logp(z)
        if net_on:
            with torch.enable_grad():
                z_in = z.clone().requires_grad_(True)
                row = nets.net_row(sn, p, K) if spec.fwd_sn else p - 1
                sn_graph = nets.apply_from_weights(sn, weights, z_in, row, gt)
            sn_out = sn_graph.detach()
        gq = -(z - mu) * viv
        gtc = gt if clip_t is None else torch.clamp(gt, -clip_t, clip_t)
        gqc = gq if clip_q is None else torch.clamp(gq, -clip_q, clip_q)
        g_gt, g_sn, g_gq = torch.zeros_like(z), torch.zeros_like(z), torch.zeros_like(z)
        total = direct
        if p <= K - 1:  # z_p starts step p
            b, e = betas[p], step[p]
            fwd_sn = sn_out if spec.fwd_sn else 0.0
            g_eps = g_eps + slope[p] * torch.sum(fk * ((b * gtc + (1.0 - b) * gqc) - fwd_sn))
            g_betas[p] += torch.sum(e * fk * (gtc - gqc))
            g_gt, g_gq = g_gt + b * e * fk, g_gq + (1.0 - b) * e * fk
            if spec.fwd_sn:
                g_sn = g_sn - e * fk
        if p >= 1:  # z_p is where step p - 1's backward mean is formed
            b, e = betas[p - 1], step[p - 1]
            drift = b * gtc + (1.0 - b) * gqc
            r = traj[p - 1] - (z + e * drift + e * sn_out)
            g_mean = c * r / (2.0 * e)
            g_e = torch.sum(g_mean * (drift + sn_out)) + torch.sum(c * r * r) / (2.0 * e) ** 2
            g_betas[p - 1] += torch.sum(e * g_mean * (gtc - gqc))
            g_gt, g_sn = g_gt + b * e * g_mean, g_sn + e * g_mean
            g_gq = g_gq + (1.0 - b) * e * g_mean
            total = total + g_mean
        g_gt = torch.where(gt == gtc, g_gt, torch.zeros_like(g_gt))   # a clipped score
        g_gq = torch.where(gq == gqc, g_gq, torch.zeros_like(g_gq))   # passes nothing
        g_mu += torch.sum(g_gq * viv, dim=0)
        g_ld += torch.sum(g_gq * (-2.0 * gq), dim=0)
        total = total - viv * g_gq + grad_logp.hvp(z, g_gt)
        if net_on:
            leaves = [z_in] if split else [z_in, *weights.values()]
            g_zin, *g_wp = torch.autograd.grad(sn_graph, leaves, g_sn)
            for name, g in zip(g_w, g_wp):
                g_w[name] += g
            total = total + g_zin
            gsn.append(g_sn)
        if p >= 1:  # z_p = fk_mean_{p-1} + sqrt(2 e) xi_{p-1}
            g_e = g_e + torch.sum(total * noise[p - 1]) / torch.sqrt(2.0 * e)
            g_eps = g_eps + slope[p - 1] * g_e
            fk, direct = total, total - g_mean
    if split:
        grads = {"eps": g_eps, "betas": g_betas, "vd_mean": g_mu, "vd_logdiag": g_ld, "sn": {}}
        return grads, total, torch.stack(gsn[::-1])
    grads = {"eps": g_eps, "betas": g_betas, "vd_mean": g_mu, "vd_logdiag": g_ld, "sn": g_w}
    return grads, total


@functools.lru_cache(maxsize=None)
def _library(source: str = "kl") -> ctypes.CDLL:
    """The built library of csrc/<source>.cu: "kl" (every form), or
    "kl_logreg" (cmcd_kl_reverse_sweep and the limits only, the carry form
    on the logistic regressions); its limits checked against this module's
    copy."""
    lib = build.load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_kl_reverse_sweep.argtypes = [p] * 21 + [i] * 10 + [f] * 3 + [i, p, p, i, p]
    lib.cmcd_kl_reverse_sweep.restype = i
    if source == "kl_logreg":
        vg.declare_limits(lib, "kl", extra_floats, "csrc/kl_logreg.cu")
        return lib
    lib.cmcd_kl_ula_sweep.argtypes = [p] * 14 + [i] * 5 + [f] * 3 + [p]
    lib.cmcd_kl_ula_sweep.restype = i
    lib.cmcd_kl_ula_chains_per_block.restype = i
    lib.cmcd_kl_ula_len_sums.argtypes = [i]
    lib.cmcd_kl_ula_len_sums.restype = i
    lib.cmcd_kl_dnf_sweep.argtypes = [p] * 25 + [i] * 8 + [p]
    lib.cmcd_kl_dnf_sweep.restype = i
    lib.cmcd_kl_dnf_fits.argtypes = [i, i]
    lib.cmcd_kl_dnf_fits.restype = i
    lib.cmcd_kl_dnf_smem_bytes.argtypes = [i, i, i]
    lib.cmcd_kl_dnf_smem_bytes.restype = ctypes.c_longlong
    vg.declare_limits(lib, "kl", extra_floats, "csrc/kl.cu")
    # DNF's form at both dims: the shared memory's edge (at dim 2 140 / 141
    # features, at dim 10 132 / 133) and past the threads' (161).
    for dim in sorted(set(KERNEL_DIMS.values())):
        for in_dim in (0, 1, 18, 22, 58, 132, 133, 140, 141, 160, 161):
            if (bool(lib.cmcd_kl_dnf_fits(in_dim, dim)) != kernel_fits(in_dim, 0, dim, nets=2)
                    or any(lib.cmcd_kl_dnf_smem_bytes(g, in_dim, dim)
                           != dnf_smem_bytes(in_dim, dim, g) for g in (2, 4))):
                raise RuntimeError("csrc/kl.cu and ops/kl.py disagree on what fits one block "
                                   f"of DNF's sweep at in_dim {in_dim}, dim {dim}")
    if lib.cmcd_kl_ula_chains_per_block() != ULA_CHAINS_PER_BLOCK or any(
            lib.cmcd_kl_ula_len_sums(d) != ula_len_sums(d) for d in set(KERNEL_DIMS.values())):
        raise RuntimeError("csrc/kl.cu and ops/kl.py disagree on the net-free sweep's layout")
    return lib


def _launch(lib, traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *,
            dim, nbridges, sn, eps_schedule, grad_clipping, groups, blocks, stream):
    """Marshal the arguments, launch the sweep with a net, and assemble
    (grads, g_z0)."""
    points = nbridges + 1
    scal, net, (code, tpar, inv_var), buffers = vg.marshal(
        "KL reverse sweep", sn, dim, nbridges, eps, grad_logp, traj.device, blocks, points,
        blocks)
    data, n_data = checked_data(grad_logp, traj.device, "KL reverse sweep")
    g_z0 = torch.empty_like(g_zfinal)
    ptr = vg.ptr
    err = lib.cmcd_kl_reverse_sweep(
        ptr(traj), ptr(noise), ptr(cot), ptr(g_zfinal), ptr(betas), ptr(scal),
        *(ptr(t) for t in net["weights"]),
        ptr(tpar), ptr(vd_mean), ptr(vd_logdiag),
        *(ptr(t) for t in buffers), ptr(g_z0),
        cot.shape[0], nbridges, net["in_dim"], net["emb_dim"], tpar.numel(),
        EPS_SCHEDULES[eps_schedule], blocks, groups, int(spec.fwd_sn), code,
        inv_var, *vg.clips(spec, grad_clipping), net["arch"], ptr(net["gate"]), ptr(data),
        n_data, ctypes.c_void_p(stream),
    )
    vg.raise_on(err, lib, "KL reverse sweep")
    grads = vg.assemble_grads(buffers[2], buffers[3], sn, dim, nbridges,
                              row_shift=not spec.fwd_sn)
    return grads, g_z0


def _launch_dnf(lib, traj, noise, cot, g_zfinal, eps, *, dim, nbridges, sn, sn2,
                eps_schedule, groups, blocks, stream):
    """Marshal the arguments, launch DNF's sweep, and assemble (grads, g_z0):
    each net's sums as ops/vargrad.assemble_grads reads them, eps from the
    first net's, zeros for betas and vd."""
    dev, n, points = traj.device, cot.shape[0], nbridges + 1
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())
    packed = [nets.pack(net, nbridges) for net in (sn, sn2)]
    for t in packed[0]["weights"] + packed[1]["weights"]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"KL reverse sweep: net weights must be f32 on {dev}")
    scal = torch.stack([f32(eps), f32(packed[0]["factor"]), f32(packed[1]["factor"])])
    in_dim, ip = packed[0]["in_dim"], vg._round_up(packed[0]["in_dim"], 4)
    la, lb = vg.len_a(in_dim, dim), vg.len_b(in_dim)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    gw2, part_a, part_b = new(blocks, 2, ip, ip + 1), new(blocks, 2 * la), new(points, blocks,
                                                                               2 * lb)
    out_a, out_b, g_z0 = new(2 * la), new(points, 2 * lb), torch.empty_like(g_zfinal)
    ptr = vg.ptr
    err = lib.cmcd_kl_dnf_sweep(
        ptr(traj), ptr(noise), ptr(cot), ptr(g_zfinal), ptr(scal),
        *(ptr(t) for t in packed[0]["weights"]), *(ptr(t) for t in packed[1]["weights"]),
        ptr(gw2), ptr(part_a), ptr(part_b), ptr(out_a), ptr(out_b), ptr(g_z0),
        n, nbridges, in_dim, packed[0]["emb_dim"], dim, EPS_SCHEDULES[eps_schedule], blocks,
        groups, ctypes.c_void_p(stream),
    )
    vg.raise_on(err, lib, "KL reverse sweep (DNF)")
    g1 = vg.assemble_grads(out_a[:la], out_b[:, :lb], sn, dim, nbridges)
    g2 = vg.assemble_grads(out_a[la:], out_b[:, lb:], sn2, dim, nbridges)
    return {**{k: v for k, v in g1.items() if k != "sn"}, "sn": g1["sn"], "sn2": g2["sn"]}, g_z0


def _launch_ula(lib, traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp,
                spec, *, dim, nbridges, eps_schedule, grad_clipping, stream):
    """Marshal the arguments, launch the net-free sweep, and assemble
    (grads, g_z0)."""
    dev, n = traj.device, cot.shape[0]
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    blocks = -(-n // ULA_CHAINS_PER_BLOCK)
    scal = torch.as_tensor(eps, dtype=torch.float32, device=dev).reshape(1).contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    la = ula_len_sums(dim)
    part_a, part_b = new(blocks, la), new(nbridges, blocks)
    out_a, out_b, g_z0 = new(la), new(nbridges), torch.empty_like(g_zfinal)
    ptr = vg.ptr
    err = lib.cmcd_kl_ula_sweep(
        ptr(traj), ptr(noise), ptr(cot), ptr(g_zfinal), ptr(betas), ptr(scal), ptr(tpar),
        ptr(vd_mean), ptr(vd_logdiag), ptr(part_a), ptr(part_b), ptr(out_a), ptr(out_b),
        ptr(g_z0), n, nbridges, tpar.numel(), EPS_SCHEDULES[eps_schedule], code,
        inv_var, *vg.clips(spec, grad_clipping), ctypes.c_void_p(stream),
    )
    vg.raise_on(err, lib, "KL reverse sweep (no net)")
    grads = {"eps": out_a[0], "betas": out_b, "vd_mean": out_a[1:1 + dim],
             "vd_logdiag": out_a[1 + dim:1 + 2 * dim], "sn": {}}
    return grads, g_z0


@torch.no_grad()
def evolve_kl_bwd(
    traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp,
    spec: OverdampedSpec, *, dim: int, nbridges: int, sn=None, sn2=None,
    eps_schedule: str = "", grad_clipping: bool = False,
):
    """KL (backprop-through-time) gradient from the stored trajectory and
    noise, in one launch of a sweep kernel and one of its reduction.

    traj: (K + 1, N, dim) f32; noise: (K, N, dim) f32; cot: (N,); g_zfinal:
    (N, dim); betas: (K,); eps: scalar tensor or float; vd_mean / vd_logdiag:
    (dim,); grad_logp: a kernel-form score of ops/target_grads at its
    KERNEL_DIMS dim; spec: one of SWEEP_SPECS; sn: the GeffnerNet or a PIS net (None for
    ULA); sn2: DNF's second net (None for every other spec). Returns (the
    gradient dict of the module docstring, g_z0 (N, dim)).
    """
    _check(traj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn, sn2,
           eps_schedule)
    kwargs = dict(dim=dim, nbridges=nbridges, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping)
    if traj.device.type == "cpu":
        return evolve_kl_bwd_plain(
            traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
            sn=sn, sn2=sn2, **kwargs
        )
    if traj.device.type != "cuda":
        raise ValueError(f"KL reverse sweep: no kernel for device {traj.device}")
    dev = traj.device
    vg.check_device_tensors("KL reverse sweep", dev,
                            (traj, noise, cot, g_zfinal, betas, vd_mean, vd_logdiag))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec)
    if spec == ULA:
        out = _launch_ula(_library(), *args, stream=stream, **kwargs)
    elif spec == DNF:
        groups, blocks = vg.sweep_grid(cot.shape[0], dev)
        out = _launch_dnf(_library(), traj, noise, cot, g_zfinal, eps, sn=sn, sn2=sn2,
                          dim=dim, nbridges=nbridges, eps_schedule=eps_schedule, groups=groups,
                          blocks=blocks, stream=stream)
    else:
        groups, blocks = vg.sweep_grid(cot.shape[0], dev)
        out = _launch(_library(source_for(grad_logp, "kl")), *args, sn=sn, groups=groups,
                      blocks=blocks, stream=stream, **kwargs)
    count_launch(evolve_kl_bwd, form_key(spec, grad_logp, sn))
    return out


# Launches in all, and by form ("<CAIS|ULA_sn|ULA|DNF>/<target>[/dds|/dds_grad]",
# ops/overdamped.form_key).
evolve_kl_bwd.launches = 0
evolve_kl_bwd.form_launches = {}
