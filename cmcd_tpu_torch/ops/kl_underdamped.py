"""The underdamped KL reverse sweep: wrapper of the CUDA kernel
(csrc/kl_underdamped.cu) and its plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_underdamped for all
seven underdamped specs (KERNEL_SPECS): the approximate refresh (U_A_LP,
U_A_LP_SNA, U_A_LP_SN: no net, a net on z, a net on [z, rho']), the exact one
(U_E_LP, U_E_LP_SNA), the exact forward with the approximate backward
(U_EA_LP_SN) and CAIS_UHA (the net in both momentum kernels, the cosine eps
schedule, the target score clipped at 1e2), on the many_gmm and 3-mode gmm
scores (dim 2) and the funnel's (dim 10), with the port's layout: ztraj and
rtraj (K + 1, N, dim) and the draws (K + 1, N, dim) as the fused rollout
stored them (ops/underdamped.py, return_state=True), cot (N,) the cotangent
of each chain's log-weight increments (the endpoint momentum terms
included), g_zfinal (N, dim) that of its final position. Nothing is stopped:
the cotangents of position and momentum chain backward through every
leapfrog step, the target score's Jacobian (masked where the clip holds)
and the nets'. Returns (grads, g_z0): the gradient of
  sum_n [ cot_n * w_delta_n + g_zfinal_n . z_K ]
as {"eps": (), "gamma": (), "eta": (), "betas": (K,), "vd_mean": (dim,),
"vd_logdiag": (dim,), "sn": {parameter name: gradient} (absent without a
net)}, and in the initial position, g_z0 (N, dim). gamma's gradient is zero
under the exact refresh and eta's under the others (neither reads it; the
JAX package gives zeros too). The initial -log N(rho_0; 0, I) term gets no
gradient: rho_0 is a draw.

The sweep visits each stored point once, from point K down to 0 (the
derivation is the header of csrc/kl_underdamped.cu): the score at z_p serves
both half-kicks that touch z_p, so one Hessian product per point carries
both, and the nets of step p (the backward one at z_p or [z_p, rho'_p];
CAIS_UHA's forward one at [z_p, rho_p]) are applied and transposed at
point p. The kernel hands the refresh's scalars on by the chain rule it
writes out; the plain version walks the same sweep with torch ops, the
score's Hessian product from ops/target_grads, the nets' VJPs and the
step's scalars (ops/underdamped.step_scalars) through torch.autograd, in the
dtype of `ztraj` (float64 to arbitrate between two float32 summation
orders).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.integrators import underdamped as ud
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops import vargrad as vg
from cmcd_tpu_torch.ops.nets import pack_geffner
from cmcd_tpu_torch.ops.overdamped import MAX_SMEM, count_launch
from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, MAX_TARGET_FLOATS, kernel_target
from cmcd_tpu_torch.ops.underdamped import (
    KERNEL_SPECS,
    REFRESH,
    UD_TARGETS,
    check_config,
    form_key,
    net_input_width,
    step_scalars,
    uses_net,
)


def extra_floats(dim: int) -> tuple:
    """Floats of shared memory beside the tile (ops/vargrad.tile_floats), one
    layout for every form: per chain z_p, rho_p, xi, rho'_p, g_out, the
    backward mean's cotangent, the two carries, CAIS_UHA's forward net
    output, Grho' and backward g_x[z] (dim-vectors), the net's input (2 dim)
    and the cotangent; per warp its share of the net's input VJP for a
    group's chains (TC x 2 dim)."""
    return (13 * dim + 1, vg.CHAINS_PER_GROUP * 2 * dim)


def smem_bytes(in_dim: int, n_par: int, dim: int, groups: int = vg.GROUPS) -> int:
    return vg.smem_bytes(in_dim, n_par, groups, extra_floats(dim), dim=dim)


def kernel_fits(in_dim: int, n_par: int, dim: int) -> bool:
    """True if a net of width in_dim (0: no net) and a target of n_par
    constants and dimension dim fit one block of the sweep at four groups."""
    return (0 <= in_dim and vg._round_up(in_dim, 32) <= vg.GROUP_THREADS
            and 1 <= n_par <= MAX_TARGET_FLOATS
            and smem_bytes(in_dim, n_par, dim) <= MAX_SMEM)


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
    -cot rho_K. Per step the cotangents of its scalars (e, the refresh's
    factors, scales and gain, and the log-normalisers' D (log s_f - log s_b)
    summed over the chains) go through autograd of step_scalars to eps, gamma
    and eta at the end."""
    K, dt, dev = nbridges, ztraj.dtype, ztraj.device
    as_t = lambda t: torch.as_tensor(t, device=dev).detach().to(dt)
    betas, mu, logdiag, cot = as_t(betas), as_t(vd_mean), as_t(vd_logdiag), as_t(cot)
    leaves = [as_t(x).reshape(()).requires_grad_(True) for x in (eps, gamma, eta)]
    with torch.enable_grad():
        scal = [step_scalars(spec, *leaves, p, K) for p in range(K)]
    v = torch.exp(-2.0 * logdiag)
    c = cot[:, None]
    clip = ud.CAIS_UHA_CLIP if spec.cais else None
    net, bwd_net = uses_net(spec), spec.bwd_sn != "none"
    weights = {name: as_t(p).requires_grad_(True) for name, p in sn.named_parameters()} \
        if net else {}
    g_w = {name: torch.zeros_like(w) for name, w in weights.items()}
    zero = torch.zeros((), dtype=dt, device=dev)
    # Per step: the cotangents of (e, cf, sf, sb, cb, gain) and of the
    # forward net's factor 2 aux (CAIS_UHA).
    g_scal = [[zero] * 7 for _ in range(K)]
    g_betas, g_mu, g_ld = torch.zeros_like(betas), torch.zeros_like(mu), torch.zeros_like(mu)
    n_cot = torch.sum(cot)

    def net_vjp(x, row):
        """The net at x, row `row`: its output, and the VJP that takes a
        cotangent of the output, adds the weights' share to g_w and returns
        x's."""
        with torch.enable_grad():
            x_in = x.clone().requires_grad_(True)
            out = nets.geffner_from_weights(weights, x_in, row)

        def vjp(g):
            g_x, *g_wp = torch.autograd.grad(out, [x_in, *weights.values()], g)
            for name, gw in zip(g_w, g_wp):
                g_w[name] += gw
            return g_x

        return out.detach(), vjp

    gz, gr2 = as_t(g_zfinal), None
    for p in range(K, -1, -1):
        z, rho = ztraj[p].detach(), rtraj[p].detach()
        gt = grad_logp(z)
        gtc, mask = gt, None
        if clip is not None:
            gtc = torch.clamp(gt, -clip, clip)
            mask = (gt >= -clip) & (gt <= clip)
        gq = -(z - mu) * v
        g_gt, g_gq = torch.zeros_like(z), torch.zeros_like(z)
        if p <= K - 1:  # step p starts here
            e, aux, cf, sf, sb, cb, gain = (None if t is None else t.detach() for t in scal[p])
            g = g_scal[p]
            xi = noise[p + 1]
            fk = rho * cf
            if spec.fwd_sn:
                snf, vjp_f = net_vjp(torch.cat([z, rho], -1), p)
                fk = fk - 2.0 * aux * snf
            rp = fk + sf * xi
            g_x = None
            bk = rp * cb
            if bwd_net:
                sn_out, vjp_b = net_vjp(torch.cat([z, rp], -1) if spec.bwd_sn == "full" else z, p)
                bk = bk + gain * sn_out
            r = (rho - bk) / sb
            g_bk = c * r / sb
            g[3] = g[3] + torch.sum(c * r * r) / sb
            g[4] = g[4] + torch.sum(rp * g_bk)
            if bwd_net:
                g[5] = g[5] + torch.sum(sn_out * g_bk)
                g_x = vjp_b(gain * g_bk)
            g_rp = gr2 + cb * g_bk
            if spec.bwd_sn == "full":
                g_rp = g_rp + g_x[:, dim:]
            g[2] = g[2] + torch.sum(xi * g_rp)
            g[1] = g[1] + torch.sum(rho * g_rp)
            g_rho = cf * g_rp - g_bk
            total = gz if g_x is None else gz + g_x[:, :dim]
            if spec.fwd_sn:
                g[6] = g[6] - torch.sum(snf * g_rp)
                g_xf = vjp_f(-2.0 * aux * g_rp)
                total = total + g_xf[:, :dim]
                g_rho = g_rho + g_xf[:, dim:]
            # The first half-kick at z_p under beta_p.
            b = betas[p]
            d_f = b * gtc + (1.0 - b) * gq
            g[0] = g[0] + 0.5 * torch.sum(d_f * gr2)
            g_betas[p] += 0.5 * e * torch.sum((gtc - gq) * gr2)
            g_gt, g_gq = g_gt + 0.5 * e * b * gr2, g_gq + 0.5 * e * (1.0 - b) * gr2
        else:  # point K: the final +log N(rho_K; 0, I) and the target term
            g_rho = -c * rho
            total = gz
        if p >= 1:  # step p - 1's second half-kick at z_p under beta_{p-1}
            e_b = scal[p - 1][0].detach()
            b = betas[p - 1]
            d_b = b * gtc + (1.0 - b) * gq
            g_scal[p - 1][0] = g_scal[p - 1][0] + 0.5 * torch.sum(d_b * g_rho)
            g_betas[p - 1] += 0.5 * e_b * torch.sum((gtc - gq) * g_rho)
            g_gt, g_gq = g_gt + 0.5 * e_b * b * g_rho, g_gq + 0.5 * e_b * (1.0 - b) * g_rho
        g_mu += torch.sum(g_gq * v, dim=0)
        g_ld += torch.sum(g_gq * (-2.0 * gq), dim=0)
        if mask is not None:
            g_gt = torch.where(mask, g_gt, torch.zeros_like(g_gt))
        total = total - v * g_gq + grad_logp.hvp(z, g_gt)
        if p >= 1:  # z_p = z_{p-1} + e rho''_{p-1}
            rpp = rho - 0.5 * e_b * d_b
            g_scal[p - 1][0] = g_scal[p - 1][0] + torch.sum(rpp * total)
            gz, gr2 = total, g_rho + e_b * total
    # The scalars' cotangents, and the log-normalisers' D (log s_f - log s_b)
    # of every chain (zero unless s_f and s_b differ: exact_fwd), to eps,
    # gamma and eta.
    with torch.enable_grad():
        objective = zero
        for (e, aux, cf, sf, sb, cb, gain), g in zip(scal, g_scal):
            objective = objective + (g[0] * e + g[1] * cf + g[2] * sf + g[3] * sb + g[4] * cb
                                     + g[5] * gain + n_cot * dim * (torch.log(sf) - torch.log(sb)))
            if spec.fwd_sn:
                objective = objective + g[6] * 2.0 * aux
        g_eps, g_gamma, g_eta = (zero if t is None else t for t in torch.autograd.grad(
            objective, leaves, allow_unused=True))
    grads = {"eps": g_eps, "gamma": g_gamma, "eta": g_eta,
             "betas": g_betas, "vd_mean": g_mu, "vd_logdiag": g_ld}
    if net:
        grads["sn"] = g_w
    return grads, total


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("kl_underdamped")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_kl_ud_sweep.argtypes = [p] * 22 + [i] * 11 + [f] + [p]
    lib.cmcd_kl_ud_sweep.restype = i
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_kl_ud_chains_per_group.restype = i
    lib.cmcd_kl_ud_fits.argtypes = [i, i, i]
    lib.cmcd_kl_ud_fits.restype = i
    lib.cmcd_kl_ud_smem_bytes.argtypes = [i, i, i, i]
    lib.cmcd_kl_ud_smem_bytes.restype = ctypes.c_longlong
    lib.cmcd_kl_ud_len_a.argtypes = [i, i, i]
    lib.cmcd_kl_ud_len_a.restype = i
    if lib.cmcd_kl_ud_chains_per_group() != vg.CHAINS_PER_GROUP:
        raise RuntimeError("csrc/kl_underdamped.cu and its wrapper disagree on the chains "
                           "of a group")
    for dim in sorted({KERNEL_DIMS[t] for t in UD_TARGETS}):
        for in_dim, n_par in ((0, 80), (18, 2), (68, 1), (134, 80), (136, 18), (140, 1),
                              (144, 128), (145, 80), (160, 130), (161, 80), (134, 0)):
            if (bool(lib.cmcd_kl_ud_fits(in_dim, n_par, dim)) != kernel_fits(in_dim, n_par, dim)
                    or any(lib.cmcd_kl_ud_smem_bytes(g, in_dim, n_par, dim)
                           != smem_bytes(in_dim, n_par, dim, g) for g in (2, 4))
                    or any(lib.cmcd_kl_ud_len_a(in_dim, dim, din) != vg.len_a(in_dim, dim, din)
                           for din in (0, dim, 2 * dim))):
                raise RuntimeError(
                    "csrc/kl_underdamped.cu and its wrapper disagree on what fits one block at "
                    f"in_dim {in_dim}, {n_par} target floats, dim {dim}")
    return lib


def _assemble(out_a, out_b, sn, spec, dim, nbridges):
    """The gradient dict from the kernel's sums (the layout of
    ops/vargrad.assemble_grads; the gamma slot holds the refresh parameter's
    gradient: eta's under the exact refresh, gamma's under the others)."""
    if uses_net(spec):
        grads = vg.assemble_grads(out_a, out_b, sn, dim, nbridges)
        in_dim = sn.in_dim
    else:
        grads, in_dim = {}, 0
    s = out_a[in_dim * in_dim + (1 + dim + net_input_width(spec, dim)) * in_dim:]
    at = vg.scalar_slots(dim)
    g_th, zero = s[at["gamma"]], torch.zeros_like(s[0])
    exact = spec.refresh == "exact"
    grads.update({
        "eps": s[at["eps"]], "gamma": zero if exact else g_th, "eta": g_th if exact else zero,
        "betas": out_b[:nbridges, 2 * in_dim] + out_b[1:, 2 * in_dim + 1],
        "vd_mean": s[at["vd_mean"]], "vd_logdiag": s[at["vd_logdiag"]],
    })
    return grads


def _launch(lib, ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, eta, vd_mean,
            vd_logdiag, grad_logp, spec, *, dim, nbridges, sn, groups, blocks, stream):
    """Marshal the arguments, launch the sweep and its reduction on
    `stream`, and assemble (grads, g_z0)."""
    dev = ztraj.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())
    din = net_input_width(spec, dim)
    weights, in_dim, emb_dim, factor = [None] * 7, 0, 0, torch.zeros((), device=dev)
    if din:
        *weights, factor = pack_geffner(sn)
        in_dim, emb_dim = sn.in_dim, sn.emb_dim
    scal = torch.stack([f32(eps), factor.to(dev, torch.float32), f32(gamma), f32(eta)])
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    points = nbridges + 1
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    la, lb = vg.len_a(in_dim, dim, din), vg.len_b(in_dim)
    buffers = [new(blocks, la), new(points, blocks, lb), new(la), new(points, lb)]
    g_z0 = torch.empty_like(g_zfinal)
    err = lib.cmcd_kl_ud_sweep(
        vg.ptr(ztraj), vg.ptr(rtraj), vg.ptr(noise), vg.ptr(cot), vg.ptr(g_zfinal),
        vg.ptr(betas), vg.ptr(scal), *(vg.ptr(t) for t in weights),
        vg.ptr(tpar), vg.ptr(vd_mean), vg.ptr(vd_logdiag),
        *(vg.ptr(t) for t in buffers), vg.ptr(g_z0),
        cot.shape[0], nbridges, din, in_dim, emb_dim, tpar.numel(), code,
        REFRESH[spec.refresh], int(spec.cais), blocks, groups, inv_var,
        ctypes.c_void_p(stream),
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
    vd_logdiag: (dim,); grad_logp: a kernel-form score of ops/target_grads on
    a target of UD_TARGETS at its KERNEL_DIMS dim; sn: the GeffnerNet (None
    for the specs without a net). Returns (the gradient dict of the module
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
    out = _launch(_library(), ztraj, rtraj, noise, cot, g_zfinal, betas, eps, gamma, eta,
                  vd_mean, vd_logdiag, grad_logp, spec, dim=dim, nbridges=nbridges, sn=sn,
                  groups=groups, blocks=blocks, stream=torch.cuda.current_stream(dev).cuda_stream)
    count_launch(evolve_kl_bwd_underdamped, form_key(spec, grad_logp))
    return out


# Launches in all, and by form ("<mode>/<target>", ops/underdamped.form_key).
evolve_kl_bwd_underdamped.launches = 0
evolve_kl_bwd_underdamped.form_launches = {}
