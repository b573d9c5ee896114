"""The fused underdamped rollout: wrapper of the CUDA kernel
(csrc/underdamped.cu) and its plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_underdamped.py::evolve_underdamped_pallas
for all seven specs of integrators/underdamped.py, with the port's layout:
z0 (N, dim), w0 (N,), betas (K,), injected noise (K + 1, N, dim) (row 0 the
initial momentum, row i + 1 the refresh draw of step i), all f32; eps,
gamma and eta scalars. w0 is added to the rollout's log-weight increments,
which include the two endpoint momentum terms. With return_state=True also
the stores the KL reverse sweep (ops/kl_underdamped.py) reads: z_0..z_K and
rho_0..rho_K (each (K + 1, N, dim), entry j the state before step j) and the
draws (K + 1, N, dim). The kernel covers the many_gmm and 3-mode gmm
scores (dim 2) and Neal's funnel's (dim 10; ops/target_grads.py: TARGETS,
KERNEL_DIMS), the target a template parameter, with the two-layer geffner
net on [z] or [z, rho']; the wrapper raises on anything else, a dim other
than the target's instance included.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cmcd_tpu_torch.integrators import UNDERDAMPED
from cmcd_tpu_torch.integrators import underdamped as ud
from cmcd_tpu_torch.networks.geffner import GeffnerNet
from cmcd_tpu_torch.ops import build
from cmcd_tpu_torch.ops.nets import pack_geffner
from cmcd_tpu_torch.ops.overdamped import (
    MAX_SMEM,
    _f32,
    check_target,
    count_launch,
)
from cmcd_tpu_torch.ops.target_grads import (
    KERNEL_DIMS,
    MAX_TARGET_FLOATS,
    kernel_target,
    n_target_floats,
)
from cmcd_tpu_torch.schedules import eps_cosine_sq

# The kernel's limits, mirrored from csrc/underdamped.cu (checked against the
# built kernel's own in _library()).
CHAINS_PER_BLOCK = 8      # TC
MAX_THREADS = 256         # one thread per net feature
REFRESH = {"approx": 0, "exact": 1, "exact_fwd": 2}
# The targets the underdamped kernels (B6, B7) are instantiated for
# (csrc/underdamped.cu, csrc/kl_underdamped.cu: dispatch_target<false>).
UD_TARGETS = ("many_gmm", "gmm", "funnel")
KERNEL_SPECS = (ud.U_A_LP, ud.U_A_LP_SNA, ud.U_A_LP_SN, ud.U_E_LP, ud.U_E_LP_SNA,
                ud.U_EA_LP_SN, ud.CAIS_UHA)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(in_dim: int, n_par: int, dim: int) -> int:
    """Dynamic shared memory of one block for a target of dimension dim
    (the kernel's layout: W2, two hidden tiles, the dim head rows, the
    target's n_par constants and the per-chain exchange: the net's input
    [z, rho'] of 2 dim, the score point, the score and the net's output)."""
    ip, tc = _round_up(in_dim, 4), CHAINS_PER_BLOCK
    return 4 * (ip * ip + 2 * tc * ip + dim * ip + _round_up(n_par, 4) + tc * 5 * dim)


def kernel_fits(in_dim: int, n_par: int, dim: int) -> bool:
    """True if a net of width in_dim (0: no net) and a target of n_par
    constants and dimension dim fit one block."""
    return (in_dim >= 0 and _round_up(in_dim, 32) <= MAX_THREADS
            and 1 <= n_par <= MAX_TARGET_FLOATS
            and smem_bytes(in_dim, n_par, dim) <= MAX_SMEM)


def form_key(spec: ud.UnderdampedSpec, grad_logp) -> str:
    """The name of a launch's form in form_launches: "<mode>/<target>"."""
    mode = next(m for m, s in UNDERDAMPED.items() if s == spec)
    return f"{mode}/{grad_logp.kernel_name}"


def uses_net(spec: ud.UnderdampedSpec) -> bool:
    return spec.fwd_sn or spec.bwd_sn != "none"


def net_input_width(spec: ud.UnderdampedSpec, dim: int) -> int:
    """Columns of the net's input ahead of the embedding: 0 (no net), dim
    (the state) or 2 dim ([z, rho])."""
    return {"none": 0, "state": dim, "full": 2 * dim}[spec.bwd_sn]


def check_config(what, specs, spec, grad_logp, dim, nbridges, sn, fits):
    """Raise on what an underdamped kernel does not take (both devices): a
    spec outside `specs`, a score outside UD_TARGETS, a dim other than the
    target's instance (KERNEL_DIMS), a net that is not the spec's two-layer
    geffner net on nbridges rows, a width that does not fit one block
    (`fits(in_dim, n_par, dim)`)."""
    if spec not in specs:
        raise NotImplementedError(f"{what}: no kernel for spec {spec}")
    name = getattr(grad_logp, "kernel_name", None)
    if name in KERNEL_DIMS and name not in UD_TARGETS:
        raise NotImplementedError(
            f"{what}: the underdamped kernels take {', '.join(UD_TARGETS)} only; the other "
            "targets' scores wait for ROADMAP B11 (A5c, A9)")
    check_target(what, grad_logp, dim)
    in_dim = 0
    if uses_net(spec):
        if not isinstance(sn, GeffnerNet) or len(sn.layers) != 2:
            raise NotImplementedError(f"{what}: the kernel inlines the two-layer geffner net")
        if sn.nbridges != nbridges or sn.x_dim != dim:
            raise ValueError(f"{what}: the net has {sn.nbridges} embedding rows and "
                             f"{sn.x_dim} outputs, not K={nbridges} and dim {dim}")
        if sn.x_dim + sn.rho_dim != net_input_width(spec, dim):
            raise ValueError(f"{what}: spec {spec} needs a net on "
                             f"{net_input_width(spec, dim)} input columns")
        in_dim = sn.in_dim
    if not fits(in_dim, n_target_floats(grad_logp), dim):
        raise NotImplementedError(f"{what}: in_dim {in_dim} does not fit one block")


def _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, noise):
    check_config("fused underdamped rollout", KERNEL_SPECS, spec, grad_logp, dim, nbridges, sn,
                 kernel_fits)
    n = z0.shape[0]
    if z0.shape != (n, dim) or w0.shape != (n,) or betas.shape != (nbridges,):
        raise ValueError(
            f"fused underdamped rollout: shapes z0 {tuple(z0.shape)}, w0 {tuple(w0.shape)}, "
            f"betas {tuple(betas.shape)} do not match N={n}, dim={dim}, K={nbridges}"
        )
    if noise is not None and noise.shape != (nbridges + 1, n, dim):
        raise ValueError(f"fused underdamped rollout: noise must be {(nbridges + 1, n, dim)}")


def step_scalars(spec, eps, gamma, eta, i: int, nbridges: int):
    """The step's (e, aux, fk coefficient, s_f, s_b, bk coefficient, gain):
    step size, gamma e, the refresh mean's factor, the two kernels' scales,
    the backward mean's factor and the net's gain."""
    e = eps_cosine_sq(eps, i, nbridges) if spec.cais else eps
    if spec.refresh == "exact":
        s = torch.sqrt(1.0 - eta**2)
        return e, None, eta, s, s, eta, 2.0 * (1.0 - eta)
    if spec.refresh == "exact_fwd":
        aux = gamma * eps
        ee = torch.exp(-aux)
        return e, aux, ee, torch.sqrt(1.0 - ee**2), torch.sqrt(2.0 * aux), 1.0 - aux, 2.0 * aux
    aux = gamma * e
    s = torch.sqrt(2.0 * aux)
    return e, aux, 1.0 - aux, s, s, 1.0 - aux, 2.0 * aux


@torch.no_grad()
def evolve_underdamped_fused_plain(
    z0, w0, betas, eps, gamma, eta, vd_mean, vd_logdiag, grad_logp,
    spec: ud.UnderdampedSpec, *, dim: int, nbridges: int, sn=None, seed=0, noise=None,
    generator=None, return_state: bool = False,
):
    """The kernel's math in eager torch, step by step: the same carry of the
    score from z_{i+1} into step i + 1, the same clip and the same weight
    formula. Without injected noise the draws come from `generator`, or from
    a generator seeded with `seed` on z0's device (not the kernel's Philox
    stream: the two agree in distribution only), the initial momentum first.
    Returns (z (N, dim), w (N,)), with return_state also (z_0..z_K,
    rho_0..rho_K, the draws), each (K + 1, N, dim) (the draws: the injected
    tensor itself, if there was one)."""
    as_t = lambda t: torch.as_tensor(t, dtype=z0.dtype, device=z0.device)
    eps, gamma, eta = as_t(eps), as_t(gamma), as_t(eta)
    clip_t = ud.CAIS_UHA_CLIP if spec.cais else None
    inv_var_q = torch.exp(-2.0 * vd_logdiag)
    if noise is None and generator is None:
        generator = torch.Generator(device=z0.device).manual_seed(int(seed))

    def draw(j):
        if noise is not None:
            return noise[j]
        return torch.randn(z0.shape, generator=generator, device=z0.device)

    def grad_u(gt, z, beta):
        gq = -(z - vd_mean) * inv_var_q
        if clip_t is not None:
            gt = torch.clamp(gt, -clip_t, clip_t)
        return -(beta * gt + (1.0 - beta) * gq)

    log_2pi = math.log(2.0 * math.pi)
    z, rho = z0, draw(0)
    draws, zs, rhos = [rho], [z], [rho]
    wd = 0.5 * torch.sum(rho * rho, -1) + 0.5 * dim * log_2pi
    gt = grad_logp(z)
    for i in range(nbridges):
        e, aux, cf, sf, sb, cb, gain = step_scalars(spec, eps, gamma, eta, i, nbridges)
        beta = betas[i]
        xi = draw(i + 1)
        draws.append(xi)
        fk = rho * cf
        if spec.fwd_sn:
            fk = fk - 2.0 * aux * sn(torch.cat([z, rho], -1), i)
        rp = fk + sf * xi
        rpp = rp - e * grad_u(gt, z, beta) / 2.0
        z_new = z + e * rpp
        gt_new = grad_logp(z_new)
        bk = rp * cb
        if spec.bwd_sn == "state":
            bk = bk + gain * sn(z, i)
        elif spec.bwd_sn == "full":
            bk = bk + gain * sn(torch.cat([z, rp], -1), i)
        r = (rho - bk) / sb
        fk_lp = -0.5 * torch.sum(xi * xi, -1) - dim * (0.5 * log_2pi + torch.log(sf))
        bk_lp = -0.5 * torch.sum(r * r, -1) - dim * (0.5 * log_2pi + torch.log(sb))
        wd = wd + (bk_lp - fk_lp)
        rho = rpp - e * grad_u(gt_new, z_new, beta) / 2.0
        z, gt = z_new, gt_new
        zs.append(z)
        rhos.append(rho)
    wd = wd - 0.5 * torch.sum(rho * rho, -1) - 0.5 * dim * log_2pi
    out = (z, w0 + wd)
    if return_state:
        out += (torch.stack(zs), torch.stack(rhos),
                noise if noise is not None else torch.stack(draws))
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("underdamped")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_underdamped_rollout.argtypes = [p] * 21 + [i] * 10 + [f] * 2 + [p]
    lib.cmcd_underdamped_rollout.restype = ctypes.c_int
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_underdamped_chains_per_block.restype = i
    lib.cmcd_underdamped_fits.argtypes = [i, i, i]
    lib.cmcd_underdamped_fits.restype = i
    lib.cmcd_underdamped_smem_bytes.argtypes = [i, i, i]
    lib.cmcd_underdamped_smem_bytes.restype = ctypes.c_longlong
    if lib.cmcd_underdamped_chains_per_block() != CHAINS_PER_BLOCK:
        raise RuntimeError("csrc/underdamped.cu and ops/underdamped.py disagree on TC")
    for dim in sorted({KERNEL_DIMS[t] for t in UD_TARGETS}):
        for in_dim in (0, 1, 18, 68, 132, 134, 216, 224, 225, 228, 256, 257):
            for n_par in (0, 1, 2, 18, 80, 81, 128, 130):
                if (bool(lib.cmcd_underdamped_fits(in_dim, n_par, dim))
                        != kernel_fits(in_dim, n_par, dim)
                        or lib.cmcd_underdamped_smem_bytes(in_dim, n_par, dim)
                        != smem_bytes(in_dim, n_par, dim)):
                    raise RuntimeError(
                        "csrc/underdamped.cu and ops/underdamped.py disagree on what fits one "
                        f"block at in_dim {in_dim}, {n_par} target floats, dim {dim}")
    return lib


def _launch(lib, z0, w0, betas, eps, gamma, eta, vd_mean, vd_logdiag, grad_logp, spec, *,
            dim, nbridges, sn, seed, noise, return_state, stream):
    """Marshal the arguments and launch the rollout on `stream`: (z, w) and,
    with return_state, the three stores."""
    dev = z0.device
    din = net_input_width(spec, dim)
    weights, in_dim, emb_dim, factor = [None] * 7, 0, 0, torch.zeros((), device=dev)
    if din:
        *weights, factor = pack_geffner(sn)
        in_dim, emb_dim = sn.in_dim, sn.emb_dim
        for t in weights:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"fused underdamped rollout: net weights must be f32 on {dev}")
    scal = torch.stack([_f32(eps, dev).reshape(()), factor.to(dev, torch.float32),
                        _f32(gamma, dev).reshape(()), _f32(eta, dev).reshape(())])
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    vd_inv_var = torch.exp(-2.0 * vd_logdiag).contiguous()
    n = z0.shape[0]
    z_out, w_out = torch.empty_like(z0), torch.empty_like(w0)
    stores = [None] * 3
    if return_state:
        stores = [z0.new_empty((nbridges + 1, n, dim)) for _ in range(2)]
        stores.append(z0.new_empty((nbridges + 1, n, dim)) if noise is None else None)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    err = lib.cmcd_underdamped_rollout(
        ptr(z0), ptr(w0), ptr(betas), ptr(noise), ptr(scal), ptr(seed_t),
        *(ptr(t) for t in weights),
        ptr(tpar), ptr(vd_mean), ptr(vd_inv_var), ptr(z_out), ptr(w_out),
        *(ptr(t) for t in stores),
        n, nbridges, din, in_dim, emb_dim, tpar.numel(), code, REFRESH[spec.refresh],
        int(spec.fwd_sn), int(spec.cais), inv_var,
        ud.CAIS_UHA_CLIP if spec.cais else math.inf, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"underdamped rollout kernel failed: {lib.cmcd_error_string(err).decode()} ({err})")
    if return_state:
        return z_out, w_out, stores[0], stores[1], noise if noise is not None else stores[2]
    return z_out, w_out


@torch.no_grad()
def evolve_underdamped_fused(
    z0, w0, betas, eps, gamma, eta, vd_mean, vd_logdiag, grad_logp,
    spec: ud.UnderdampedSpec, *, dim: int, nbridges: int, sn=None, seed=0, noise=None,
    return_state: bool = False,
):
    """Run nbridges underdamped leapfrog steps for every chain in one launch.

    z0: (N, dim) f32; w0: (N,) f32; betas: (K,); eps, gamma, eta: scalar
    tensors or floats; vd_mean / vd_logdiag: (dim,); grad_logp: a
    kernel-form score of ops/target_grads on a target of UD_TARGETS at its
    KERNEL_DIMS dim; sn: the GeffnerNet (on [z] for the state
    specs, [z, rho] for the full ones; None without a net); seed: int or
    one-element integer tensor (read on the device, so no host sync); noise:
    optional (K + 1, N, dim) standard normals. Returns (z (N, dim), w (N,));
    with return_state also (z_0..z_K, rho_0..rho_K, the draws), each
    (K + 1, N, dim): the kernel's Philox normals as it stored them, or the
    injected tensor itself.
    """
    _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, noise)
    if z0.device.type == "cpu":
        return evolve_underdamped_fused_plain(
            z0, w0, betas, eps, gamma, eta, vd_mean, vd_logdiag, grad_logp, spec, dim=dim,
            nbridges=nbridges, sn=sn, seed=seed, noise=noise, return_state=return_state)
    if z0.device.type != "cuda":
        raise ValueError(f"fused underdamped rollout: no kernel for device {z0.device}")
    dev = z0.device
    for t in [z0, w0, betas, vd_mean, vd_logdiag] + ([noise] if noise is not None else []):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "fused underdamped rollout: z0, w0, betas, vd params and noise must be "
                f"contiguous f32 on {dev}")
    out = _launch(_library(), z0, w0, betas, eps, gamma, eta, vd_mean, vd_logdiag, grad_logp,
                  spec, dim=dim, nbridges=nbridges, sn=sn, seed=seed, noise=noise,
                  return_state=return_state,
                  stream=torch.cuda.current_stream(dev).cuda_stream)
    count_launch(evolve_underdamped_fused, form_key(spec, grad_logp))
    return out


# Launches in all, and by form ("<mode>/<target>", form_key).
evolve_underdamped_fused.launches = 0
evolve_underdamped_fused.form_launches = {}
