"""The UHA KL reverse sweep: wrapper of the CUDA kernel (csrc/kl_uha.cu) and
its plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_uha with the port's
layout: ztraj, rtraj and the draws (K + 1, N, dim) as the fused UHA rollout
stored them (ops/uha.py, return_state=True), cot (N,) the cotangent of each
chain's log-weight increments, g_zfinal (N, dim) that of its final position.
Nothing is stopped: the cotangents of position and momentum chain backward
through every leapfrog step and the target score's Hessian, and the initial
momentum rho_0 = e^{md} xi_0 passes md its share. Returns (grads, g_z0): the
gradient of
  sum_n [ cot_n * w_delta_n + g_zfinal_n . z_K ]
as {"eps": (), "eta": (), "md": (dim,), "betas": (K,), "vd_mean": (dim,),
"vd_logdiag": (dim,)}, and in the initial position, g_z0 (N, dim).

The sweep visits each stored point once, from point K down to 0 (the
derivation is the header of csrc/kl_uha.cu): the inner positions of a
bridge's leapfrog are recomputed from its stored rows, and one Hessian
product at each stored point serves both half-kicks that touch it. The
plain version walks the same sweep with torch ops and the score's Hessian
product from ops/target_grads, in the dtype of `ztraj` (float64 to arbitrate
between two float32 summation orders).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.ops import build
from cmcd_tpu_torch.ops.overdamped import count_launch
from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, kernel_target
from cmcd_tpu_torch.ops.uha import (
    CHAINS_PER_BLOCK,
    MAX_LFSTEPS,
    UHA_TARGETS,
    check_config,
    eps_eta,
)
from cmcd_tpu_torch.ops.vargrad import check_device_tensors, ptr, raise_on


def len_sums(dim: int) -> int:
    """Floats of a block's sums: eps, eta, md, vd mean, vd logdiag."""
    return 2 + 3 * dim


def _check(ztraj, rtraj, noise, cot, g_zfinal, betas, grad_logp, dim, nbridges, lfsteps):
    what = "UHA KL sweep"
    check_config(what, grad_logp, dim, nbridges, lfsteps)
    n = cot.shape[0]
    shape = (nbridges + 1, n, dim)
    if (ztraj.shape != shape or rtraj.shape != shape or noise.shape != shape
            or cot.shape != (n,) or g_zfinal.shape != (n, dim) or betas.shape != (nbridges,)):
        raise ValueError(f"{what}: shapes do not match N={n}, dim={dim}, K={nbridges}")


@torch.no_grad()
def evolve_kl_bwd_uha_plain(
    ztraj, rtraj, noise, cot, g_zfinal, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, *,
    dim: int, nbridges: int, lfsteps: int = 1,
):
    """The kernel's function in plain torch, point by point from K to 0, in
    ztraj's dtype. Carried between points: tz, the whole cotangent of
    z_{p+1}, and gr, that of its bridge's last momentum before the second
    half-kick; at point K the seeds g_zfinal and 0."""
    _check(ztraj, rtraj, noise, cot, g_zfinal, betas, grad_logp, dim, nbridges, lfsteps)
    K, dt, dev = nbridges, ztraj.dtype, ztraj.device
    as_t = lambda t: torch.as_tensor(t, device=dev).detach().to(dt)
    betas, mu, logdiag, md, cot = as_t(betas), as_t(vd_mean), as_t(vd_logdiag), as_t(md), as_t(cot)
    e, et = as_t(eps).reshape(()), as_t(eta).reshape(())
    E, V, Q = torch.exp(md), torch.exp(-2.0 * md), torch.exp(-2.0 * logdiag)
    sq = torch.sqrt(1.0 - et**2)
    c = cot[:, None]
    g_e = g_eta = torch.zeros((), dtype=dt, device=dev)
    g_E, g_V, g_mu, g_ld = (torch.zeros_like(md) for _ in range(4))
    g_betas = torch.zeros_like(betas)
    col = lambda t: torch.sum(t, dim=0)  # a per-dimension sum over the chains

    def g_terms(gt, gq, b, u):
        """A cotangent u of G(y) = -(b gt + (1 - b) gq) at y: betas' share,
        and g_gt, g_gq (vd's shares added here)."""
        nonlocal g_mu, g_ld
        g_gq = -(1.0 - b) * u
        g_mu = g_mu + col(Q * g_gq)
        g_ld = g_ld + col(-2.0 * gq * g_gq)
        return torch.sum((gt - gq) * -u), -b * u, g_gq

    tz, gr = as_t(g_zfinal), None
    for p in range(K, -1, -1):
        z, rp = ztraj[p], rtraj[p]
        gt = grad_logp(z)
        gq = -(z - mu) * Q
        g_gt, g_gq = torch.zeros_like(z), torch.zeros_like(z)
        if p <= K - 1:  # bridge p starts here
            b, xi = betas[p], noise[p + 1]
            rho = et * rp + sq * (E * xi)
            ys = [z]
            rs = [rho - 0.5 * e * -(b * gt + (1.0 - b) * gq)]
            for _ in range(1, lfsteps):
                y = ys[-1] + e * (V * rs[-1])
                ys.append(y)
                rs.append(rs[-1] - e * -(b * grad_logp(y) + (1.0 - b) * -(y - mu) * Q))
            g_r, g_y = gr, tz
            for l in range(lfsteps - 1, -1, -1):
                g_r = g_r + e * V * g_y  # y_{l+1} = y_l + e V r_l
                g_e = g_e + torch.sum(V * rs[l] * g_y)
                g_V = g_V + col(e * rs[l] * g_y)
                if l == 0:
                    break
                y = ys[l]  # r_l = r_{l-1} - e G(y_l)
                gtl, gql = grad_logp(y), -(y - mu) * Q
                g_e = g_e + torch.sum((b * gtl + (1.0 - b) * gql) * g_r)
                g_b, ggt, ggq = g_terms(gtl, gql, b, -e * g_r)
                g_betas[p] += g_b
                g_y = g_y + grad_logp.hvp(y, ggt) - Q * ggq
            # r_0 = rho - (e / 2) G(z_p), the refresh and delta's q0 term.
            g_e = g_e + 0.5 * torch.sum((b * gt + (1.0 - b) * gq) * g_r)
            g_b, ggt, ggq = g_terms(gt, gq, b, -0.5 * e * g_r)
            g_betas[p] += g_b
            g_gt, g_gq = g_gt + ggt, g_gq + ggq
            g_rho = g_r + c * V * rho
            g_V = g_V + col(0.5 * c * rho * rho)
            g_eta = g_eta + torch.sum(g_rho * (rp - et / sq * (E * xi)))
            g_E = g_E + col(sq * xi * g_rho)
            zc, rc = g_y, et * g_rho
        else:  # point K
            zc, rc = tz, torch.zeros_like(z)
        if p >= 1:  # bridge p - 1 ends here: rp is its new momentum
            b = betas[p - 1]
            gr = rc - c * V * rp
            g_V = g_V + col(-0.5 * c * rp * rp)
            g_e = g_e + 0.5 * torch.sum((b * gt + (1.0 - b) * gq) * gr)
            g_b, ggt, ggq = g_terms(gt, gq, b, -0.5 * e * gr)
            g_betas[p - 1] += g_b
            g_gt, g_gq = g_gt + ggt, g_gq + ggq
        tz = zc + grad_logp.hvp(z, g_gt) - Q * g_gq
    # rho_0 = e^{md} xi_0: d rho_0 / d md = rho_0.
    g_md = E * g_E - 2.0 * V * g_V + col(rc * rtraj[0])
    return {"eps": g_e, "eta": g_eta, "md": g_md, "betas": g_betas, "vd_mean": g_mu,
            "vd_logdiag": g_ld}, tz


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("kl_uha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_kl_uha_sweep.argtypes = [p] * 16 + [i] * 5 + [f] + [p]
    lib.cmcd_kl_uha_sweep.restype = i
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_kl_uha_len_sums.argtypes = [i]
    lib.cmcd_kl_uha_len_sums.restype = i
    dims = sorted({KERNEL_DIMS[t] for t in UHA_TARGETS})
    if (lib.cmcd_kl_uha_chains_per_block(), lib.cmcd_kl_uha_max_lfsteps(),
            [lib.cmcd_kl_uha_len_sums(d) for d in dims]) != (
                CHAINS_PER_BLOCK, MAX_LFSTEPS, [len_sums(d) for d in dims]):
        raise RuntimeError("csrc/kl_uha.cu and ops/kl_uha.py disagree on their limits")
    return lib


def _launch(lib, ztraj, rtraj, noise, cot, g_zfinal, betas, eps, eta, md, vd_mean, vd_logdiag,
            grad_logp, *, nbridges, lfsteps, stream):
    """Marshal the arguments, launch the sweep and its reduction on
    `stream`, and assemble (grads, g_z0)."""
    dev, n, dim = ztraj.device, cot.shape[0], ztraj.shape[-1]
    blocks, la = -(-n // CHAINS_PER_BLOCK), len_sums(dim)
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    scal = eps_eta(dev, eps, eta)  # a name keeps it alive through the call
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    part_a, part_b, out_a, out_b = new(blocks, la), new(nbridges, blocks), new(la), new(nbridges)
    g_z0 = torch.empty_like(g_zfinal)
    err = lib.cmcd_kl_uha_sweep(
        ptr(ztraj), ptr(rtraj), ptr(noise), ptr(cot), ptr(g_zfinal), ptr(betas),
        ptr(scal), ptr(md), ptr(vd_mean), ptr(vd_logdiag), ptr(tpar),
        ptr(part_a), ptr(part_b), ptr(out_a), ptr(out_b), ptr(g_z0),
        n, nbridges, lfsteps, code, tpar.numel(), inv_var, ctypes.c_void_p(stream),
    )
    raise_on(err, lib, "UHA KL sweep")
    grads = {"eps": out_a[0], "eta": out_a[1], "md": out_a[2:2 + dim], "betas": out_b,
             "vd_mean": out_a[2 + dim:2 + 2 * dim], "vd_logdiag": out_a[2 + 2 * dim:]}
    return grads, g_z0


@torch.no_grad()
def evolve_kl_bwd_uha(
    ztraj, rtraj, noise, cot, g_zfinal, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, *,
    dim: int, nbridges: int, lfsteps: int = 1,
):
    """KL (backprop-through-time) gradient of the UHA rollout from its stored
    positions, momenta and draws, in one launch of the sweep kernel and one
    of its reduction.

    ztraj, rtraj, noise: (K + 1, N, dim) f32; cot: (N,); g_zfinal: (N, dim);
    betas: (K,); eps, eta: scalar tensors or floats; md, vd_mean,
    vd_logdiag: (dim,); grad_logp: a kernel-form score of ops/target_grads on a
    target of ops/uha.UHA_TARGETS.
    Returns (the gradient dict of the module docstring, g_z0 (N, dim)).
    """
    args = (ztraj, rtraj, noise, cot, g_zfinal, betas, eps, eta, md, vd_mean, vd_logdiag,
            grad_logp)
    kw = dict(dim=dim, nbridges=nbridges, lfsteps=lfsteps)
    if ztraj.device.type == "cpu":
        return evolve_kl_bwd_uha_plain(*args, **kw)
    _check(ztraj, rtraj, noise, cot, g_zfinal, betas, grad_logp, dim, nbridges, lfsteps)
    if ztraj.device.type != "cuda":
        raise ValueError(f"UHA KL sweep: no kernel for device {ztraj.device}")
    dev = ztraj.device
    check_device_tensors("UHA KL sweep", dev, (ztraj, rtraj, noise, cot, g_zfinal, betas, md,
                                               vd_mean, vd_logdiag))
    out = _launch(_library(), *args, nbridges=nbridges, lfsteps=lfsteps,
                  stream=torch.cuda.current_stream(dev).cuda_stream)
    count_launch(evolve_kl_bwd_uha, grad_logp.kernel_name)
    return out


# Launches in all, and by target (form_launches).
evolve_kl_bwd_uha.launches = 0
evolve_kl_bwd_uha.form_launches = {}
