"""The underdamped KL reverse sweep: wrapper of the CUDA kernel
(csrc/kl_underdamped.cu) and its plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_underdamped for the
three approximate-refresh specs U_A_LP, U_A_LP_SNA and U_A_LP_SN (no net, a
net on z, a net on [z, rho']), with the port's layout: ztraj and rtraj
(K + 1, N, dim) and the draws (K + 1, N, dim) as the fused rollout stored
them (ops/underdamped.py, return_state=True), cot (N,) the cotangent of each
chain's log-weight increments (the endpoint momentum terms included),
g_zfinal (N, dim) that of its final position. Nothing is stopped: the
cotangents of position and momentum chain backward through every leapfrog
step, the target score's Jacobian and the net's. Returns (grads, g_z0): the
gradient of
  sum_n [ cot_n * w_delta_n + g_zfinal_n . z_K ]
as {"eps": (), "gamma": (), "eta": () (zero: the approximate refresh does
not use it), "betas": (K,), "vd_mean": (dim,), "vd_logdiag": (dim,),
"sn": {parameter name: gradient} (absent without a net)}, and in the
initial position, g_z0 (N, dim). The initial -log N(rho_0; 0, I) term gets
no gradient: rho_0 is a draw.

The sweep visits each stored point once, from point K down to 0 (the
derivation is the header of csrc/kl_underdamped.cu): the score at z_p serves
both half-kicks that touch z_p, so one Hessian product per point carries
both, and the net of step p (at z_p, or at [z_p, rho'_p]) is applied and
transposed once. The plain version walks the same sweep with torch ops, the
score's Hessian product from ops/target_grads.ManyGMMScore.hvp and the net's
VJP from torch.autograd, in the dtype of `ztraj` (float64 to arbitrate
between two float32 summation orders).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.integrators import underdamped as ud
from cmcd_tpu_torch.ops import build
from cmcd_tpu_torch.ops import vargrad as vg
from cmcd_tpu_torch.ops.overdamped import MAX_SMEM, pack_geffner
from cmcd_tpu_torch.ops.target_grads import MAX_TARGET_FLOATS
from cmcd_tpu_torch.ops.underdamped import check_config, net_input_width, uses_net

# The approximate-refresh specs; the exact, exact_fwd and CAIS_UHA forms of
# the TPU sweep are still to port (ROADMAP A6b).
KERNEL_SPECS = (ud.U_A_LP, ud.U_A_LP_SNA, ud.U_A_LP_SN)
XIN = 4  # floats of a chain's net input buffer: [z, rho']

# Floats of shared memory beside the tile (ops/vargrad.tile_floats). Per
# chain: z_p, rho_p, xi, rho'_p, g_out, the backward mean's cotangent and the
# two carries (2-vectors), the net's input (XIN), the cotangent; per warp:
# its share of the net's input VJP for a group's chains (TC x XIN).
EXTRA_FLOATS = (8 * 2 + XIN + 1, vg.CHAINS_PER_GROUP * XIN)


def smem_bytes(in_dim: int, n_par: int, groups: int = vg.GROUPS) -> int:
    return vg.smem_bytes(in_dim, n_par, groups, EXTRA_FLOATS, dim=2)


def kernel_fits(in_dim: int, n_par: int) -> bool:
    """True if a net of width in_dim (0: no net) and the many_gmm's n_par
    constants (its means, an even count) fit one block of the sweep at four
    groups."""
    return (0 <= in_dim and vg._round_up(in_dim, 32) <= vg.GROUP_THREADS
            and 2 <= n_par <= MAX_TARGET_FLOATS and n_par % 2 == 0
            and smem_bytes(in_dim, n_par) <= MAX_SMEM)


def _check(ztraj, rtraj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn):
    what = "underdamped KL sweep"
    check_config(what, KERNEL_SPECS, spec, grad_logp, dim, nbridges, sn, kernel_fits)
    n = cot.shape[0]
    shape = (nbridges + 1, n, dim)
    if (ztraj.shape != shape or rtraj.shape != shape or noise.shape != shape
            or cot.shape != (n,) or g_zfinal.shape != (n, dim) or betas.shape != (nbridges,)):
        raise ValueError(f"{what}: shapes do not match N={n}, dim={dim}, K={nbridges}")


@torch.no_grad()
def evolve_kl_bwd_underdamped_plain(
    ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, eta, vd_mean, vd_logdiag,
    grad_logp, spec: ud.UnderdampedSpec, *, dim: int, nbridges: int, sn=None,
):
    """The kernel's function in plain torch, point by point from K to 0, in
    ztraj's dtype. Carried between points: gz, the cotangent z_p gets from
    step p's position update, and gr2, that of step p's momentum after its
    first half-kick (rho''_p); at point K the seeds g_zfinal and
    -cot rho_K."""
    K, dt, dev = nbridges, ztraj.dtype, ztraj.device
    as_t = lambda t: torch.as_tensor(t, device=dev).detach().to(dt)
    betas, mu, logdiag, cot = as_t(betas), as_t(vd_mean), as_t(vd_logdiag), as_t(cot)
    e, gam = as_t(eps).reshape(()), as_t(gamma).reshape(())
    a = gam * e
    s = torch.sqrt(2.0 * a)
    v = torch.exp(-2.0 * logdiag)
    c = cot[:, None]
    net = uses_net(spec)
    weights = {name: as_t(p).requires_grad_(True) for name, p in sn.named_parameters()} \
        if net else {}
    g_w = {name: torch.zeros_like(w) for name, w in weights.items()}
    g_e = g_a = g_s = torch.zeros((), dtype=dt, device=dev)
    g_betas, g_mu, g_ld = torch.zeros_like(betas), torch.zeros_like(mu), torch.zeros_like(mu)

    gz, gr2 = as_t(g_zfinal), None
    for p in range(K, -1, -1):
        z, rho = ztraj[p].detach(), rtraj[p].detach()
        gt = grad_logp(z)
        gq = -(z - mu) * v
        g_gt, g_gq = torch.zeros_like(z), torch.zeros_like(z)
        if p <= K - 1:  # step p starts here
            xi = noise[p + 1]
            rp = rho * (1.0 - a) + s * xi
            g_x = None
            if net:
                x = torch.cat([z, rp], -1) if spec.bwd_sn == "full" else z
                with torch.enable_grad():
                    x_in = x.clone().requires_grad_(True)
                    sn_graph = vg.geffner_from_weights(weights, x_in, p)
                sn_out = sn_graph.detach()
                bk = rp * (1.0 - a) + 2.0 * a * sn_out
            else:
                bk = rp * (1.0 - a)
            r = (rho - bk) / s
            g_bk = c * r / s
            g_s = g_s + torch.sum(c * r * r) / s
            g_a = g_a + torch.sum(-rp * g_bk)
            if net:
                g_a = g_a + torch.sum(2.0 * sn_out * g_bk)
                g_x, *g_wp = torch.autograd.grad(sn_graph, [x_in, *weights.values()],
                                                 2.0 * a * g_bk)
                for name, g in zip(g_w, g_wp):
                    g_w[name] += g
            g_rp = gr2 + (1.0 - a) * g_bk
            if g_x is not None and spec.bwd_sn == "full":
                g_rp = g_rp + g_x[:, dim:]
            g_s = g_s + torch.sum(xi * g_rp)
            g_a = g_a + torch.sum(-rho * g_rp)
            g_rho = (1.0 - a) * g_rp - g_bk
            total = gz if g_x is None else gz + g_x[:, :dim]
            # The first half-kick at z_p under beta_p.
            b = betas[p]
            d_f = b * gt + (1.0 - b) * gq
            g_e = g_e + 0.5 * torch.sum(d_f * gr2)
            g_betas[p] += 0.5 * e * torch.sum((gt - gq) * gr2)
            g_gt, g_gq = g_gt + 0.5 * e * b * gr2, g_gq + 0.5 * e * (1.0 - b) * gr2
        else:  # point K: the final +log N(rho_K; 0, I) and the target term
            g_rho = -c * rho
            total = gz
        if p >= 1:  # step p - 1's second half-kick at z_p under beta_{p-1}
            b = betas[p - 1]
            d_b = b * gt + (1.0 - b) * gq
            g_e = g_e + 0.5 * torch.sum(d_b * g_rho)
            g_betas[p - 1] += 0.5 * e * torch.sum((gt - gq) * g_rho)
            g_gt, g_gq = g_gt + 0.5 * e * b * g_rho, g_gq + 0.5 * e * (1.0 - b) * g_rho
        g_mu += torch.sum(g_gq * v, dim=0)
        g_ld += torch.sum(g_gq * (-2.0 * gq), dim=0)
        total = total - v * g_gq + grad_logp.hvp(z, g_gt)
        if p >= 1:  # z_p = z_{p-1} + e rho''_{p-1}
            rpp = rho - 0.5 * e * d_b
            g_e = g_e + torch.sum(rpp * total)
            gz, gr2 = total, g_rho + e * total
    g_a = g_a + g_s / s  # s = sqrt(2 a)
    grads = {"eps": g_e + gam * g_a, "gamma": e * g_a, "eta": torch.zeros_like(e),
             "betas": g_betas, "vd_mean": g_mu, "vd_logdiag": g_ld}
    if net:
        grads["sn"] = g_w
    return grads, total


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("kl_underdamped")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_kl_ud_sweep.argtypes = [p] * 22 + [i] * 8 + [f] + [p]
    lib.cmcd_kl_ud_sweep.restype = i
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_kl_ud_chains_per_group.restype = i
    lib.cmcd_kl_ud_fits.argtypes = [i, i]
    lib.cmcd_kl_ud_fits.restype = i
    lib.cmcd_kl_ud_smem_bytes.argtypes = [i, i, i]
    lib.cmcd_kl_ud_smem_bytes.restype = ctypes.c_longlong
    lib.cmcd_kl_ud_len_a.argtypes = [i, i]
    lib.cmcd_kl_ud_len_a.restype = i
    if lib.cmcd_kl_ud_chains_per_group() != vg.CHAINS_PER_GROUP:
        raise RuntimeError("csrc/kl_underdamped.cu and its wrapper disagree on the chains "
                           "of a group")
    for in_dim, n_par in ((0, 80), (18, 2), (134, 80), (144, 128), (145, 80), (160, 130),
                          (161, 80), (134, 0), (134, 81)):
        if (bool(lib.cmcd_kl_ud_fits(in_dim, n_par)) != kernel_fits(in_dim, n_par)
                or any(lib.cmcd_kl_ud_smem_bytes(g, in_dim, n_par) != smem_bytes(in_dim, n_par, g)
                       for g in (2, 4))
                or any(lib.cmcd_kl_ud_len_a(in_dim, din) != vg.len_a(in_dim, 2, din)
                       for din in (0, 2, 4))):
            raise RuntimeError(
                "csrc/kl_underdamped.cu and its wrapper disagree on what fits one block at "
                f"in_dim {in_dim}, {n_par} target floats")
    return lib


def _assemble(out_a, out_b, sn, spec, dim, nbridges):
    """The gradient dict from the kernel's sums (the layout of
    ops/vargrad.assemble_grads, with gamma's scalar)."""
    if uses_net(spec):
        grads = vg.assemble_grads(out_a, out_b, sn, dim, nbridges)
        in_dim = sn.in_dim
    else:
        grads, in_dim = {}, 0
    s = out_a[in_dim * in_dim + (3 + net_input_width(spec, dim)) * in_dim:]
    at = vg.scalar_slots(dim)
    grads.update({
        "eps": s[at["eps"]], "gamma": s[at["gamma"]], "eta": torch.zeros_like(s[0]),
        "betas": out_b[:nbridges, 2 * in_dim] + out_b[1:, 2 * in_dim + 1],
        "vd_mean": s[at["vd_mean"]], "vd_logdiag": s[at["vd_logdiag"]],
    })
    return grads


def _launch(lib, ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, vd_mean, vd_logdiag,
            grad_logp, spec, *, dim, nbridges, sn, groups, blocks, stream):
    """Marshal the arguments, launch the sweep and its reduction on
    `stream`, and assemble (grads, g_z0)."""
    dev = ztraj.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())
    din = net_input_width(spec, dim)
    weights, in_dim, emb_dim, factor = [None] * 7, 0, 0, torch.zeros((), device=dev)
    if din:
        *weights, factor = pack_geffner(sn)
        in_dim, emb_dim = sn.in_dim, sn.emb_dim
    scal = torch.stack([f32(eps), factor.to(dev, torch.float32), f32(gamma)])
    means = grad_logp.means.to(dev, torch.float32).reshape(-1).contiguous()
    points = nbridges + 1
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    la, lb = vg.len_a(in_dim, 2, din), vg.len_b(in_dim)
    buffers = [new(blocks, la), new(points, blocks, lb), new(la), new(points, lb)]
    g_z0 = torch.empty_like(g_zfinal)
    err = lib.cmcd_kl_ud_sweep(
        vg.ptr(ztraj), vg.ptr(rtraj), vg.ptr(noise), vg.ptr(cot), vg.ptr(g_zfinal),
        vg.ptr(betas), vg.ptr(scal), *(vg.ptr(t) for t in weights),
        vg.ptr(means), vg.ptr(vd_mean), vg.ptr(vd_logdiag),
        *(vg.ptr(t) for t in buffers), vg.ptr(g_z0),
        cot.shape[0], nbridges, din, in_dim, emb_dim, means.numel(), blocks, groups,
        grad_logp.inv_var, ctypes.c_void_p(stream),
    )
    vg.raise_on(err, lib, "underdamped KL sweep")
    return _assemble(buffers[2], buffers[3], sn, spec, dim, nbridges), g_z0


@torch.no_grad()
def evolve_kl_bwd_underdamped(
    ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, eta, vd_mean, vd_logdiag,
    grad_logp, spec: ud.UnderdampedSpec, *, dim: int, nbridges: int, sn=None,
):
    """KL (backprop-through-time) gradient of the underdamped rollout from
    its stored positions, momenta and draws, in one launch of the sweep
    kernel and one of its reduction.

    ztraj, rtraj, noise: (K + 1, N, dim) f32; cot: (N,); g_zfinal: (N, dim);
    betas: (K,); eps, gamma, eta: scalar tensors or floats; vd_mean /
    vd_logdiag: (dim,); grad_logp: ops/target_grads.ManyGMMScore; sn: the
    GeffnerNet (None for U_A_LP). Returns (the gradient dict of the module
    docstring, g_z0 (N, dim)).
    """
    _check(ztraj, rtraj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn)
    if ztraj.device.type == "cpu":
        return evolve_kl_bwd_underdamped_plain(
            ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, eta, vd_mean, vd_logdiag,
            grad_logp, spec, dim=dim, nbridges=nbridges, sn=sn)
    if ztraj.device.type != "cuda":
        raise ValueError(f"underdamped KL sweep: no kernel for device {ztraj.device}")
    dev = ztraj.device
    vg.check_device_tensors("underdamped KL sweep", dev,
                            (ztraj, rtraj, noise, cot, g_zfinal, betas, vd_mean, vd_logdiag))
    groups, blocks = vg.sweep_grid(cot.shape[0], dev)
    out = _launch(_library(), ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, vd_mean,
                  vd_logdiag, grad_logp, spec, dim=dim, nbridges=nbridges, sn=sn, groups=groups,
                  blocks=blocks, stream=torch.cuda.current_stream(dev).cuda_stream)
    evolve_kl_bwd_underdamped.launches += 1
    return out


evolve_kl_bwd_underdamped.launches = 0
