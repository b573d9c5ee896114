"""The fused UHA rollout: wrapper of the CUDA kernel (csrc/uha.cu) and its
plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_uha.py::evolve_uha_pallas with the
port's layout: z0 (N, dim), betas (K,), injected noise (K + 1, N, dim) (row 0
the initial momentum's base draw, row i + 1 the refresh draw of bridge i),
all f32; eps and eta scalars, md, vd_mean and vd_logdiag (dim,). Returns
(z_K (N, dim), w_delta (N,)), the summed -1/2 (|rho_new|^2 - |rho|^2) in the
metric e^{-2 md} of every bridge. With return_state=True also the stores the
reverse sweep (ops/kl_uha.py) reads: z_0..z_K and rho_0..rho_K (each
(K + 1, N, dim), entry j the state before bridge j) and the draws
(K + 1, N, dim). The kernel covers the many_gmm and the 3-mode gmm scores
(ops/target_grads.py) at dim 2 and Neal's funnel's at dim 10, and up to
MAX_LFSTEPS leapfrog steps a bridge; check_config raises on anything else.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.ops import build
from cmcd_tpu_torch.ops.overdamped import _f32, check_target, count_launch
from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, MAX_TARGET_FLOATS, kernel_target
from cmcd_tpu_torch.ops.vargrad import check_device_tensors, ptr

# The kernels' limits, mirrored from csrc/uha.cu and csrc/kl_uha.cu (checked
# against the built kernels' own in _library()).
CHAINS_PER_BLOCK = 8      # one warp per chain
MAX_LFSTEPS = 8           # leapfrog steps a bridge; the sweep keeps them in registers


# The targets the UHA kernels are instantiated for (csrc/uha.cu,
# csrc/kl_uha.cu: dispatch_target<false>, the target's D a template parameter).
UHA_TARGETS = ("many_gmm", "gmm", "funnel")


def check_config(what, grad_logp, dim, nbridges, lfsteps):
    """Raise on what the UHA kernels do not take (both devices): a score
    outside UHA_TARGETS, a dim other than the target's instance
    (KERNEL_DIMS), more constants than the kernels hold, lfsteps outside
    1..MAX_LFSTEPS, no bridge."""
    name = getattr(grad_logp, "kernel_name", None)
    if name in KERNEL_DIMS and name not in UHA_TARGETS:
        raise NotImplementedError(
            f"{what}: the UHA kernels take {', '.join(UHA_TARGETS)} only; {name} and the other "
            "targets' scores wait for ROADMAP B11 (A5c, A9)")
    check_target(what, grad_logp, dim)
    if not 1 <= lfsteps <= MAX_LFSTEPS:
        raise NotImplementedError(f"{what}: lfsteps must lie in 1..{MAX_LFSTEPS}, got {lfsteps}")
    if nbridges < 1:
        raise ValueError(f"{what}: needs at least one bridge")


def kernel_covers(grad_logp, dim: int, nbridges: int, lfsteps: int) -> bool:
    """True if check_config would pass."""
    try:
        check_config("", grad_logp, dim, nbridges, lfsteps)
    except (NotImplementedError, ValueError):
        return False
    return True


def _check(z0, betas, grad_logp, dim, nbridges, lfsteps, noise):
    what = "fused UHA rollout"
    check_config(what, grad_logp, dim, nbridges, lfsteps)
    n = z0.shape[0]
    if z0.shape != (n, dim) or betas.shape != (nbridges,):
        raise ValueError(f"{what}: shapes z0 {tuple(z0.shape)}, betas {tuple(betas.shape)} do "
                         f"not match dim={dim}, K={nbridges}")
    if noise is not None and noise.shape != (nbridges + 1, n, dim):
        raise ValueError(f"{what}: noise must be {(nbridges + 1, n, dim)}")


@torch.no_grad()
def evolve_uha_fused_plain(
    z0, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, *, dim: int, nbridges: int,
    lfsteps: int = 1, seed=0, noise=None, return_state: bool = False,
):
    """The kernel's math in eager torch, bridge by bridge: the same carry of
    the score from one kick to the next and the same weight formula, in
    z0's dtype. Without injected noise the draws come from a generator
    seeded with `seed` on z0's device (not the kernel's Philox stream: the
    two agree in distribution only), the initial momentum first. Returns (z (N, dim), w_delta (N,)), with return_state also
    (z_0..z_K, rho_0..rho_K, the draws), each (K + 1, N, dim) (the draws:
    the injected tensor itself, if there was one)."""
    _check(z0, betas, grad_logp, dim, nbridges, lfsteps, noise)
    as_t = lambda t: torch.as_tensor(t, dtype=z0.dtype, device=z0.device)
    eps, eta, md = as_t(eps), as_t(eta), as_t(md)
    vd_mean, inv_var_q = as_t(vd_mean), torch.exp(-2.0 * as_t(vd_logdiag))
    exp_md, inv_var = torch.exp(md), torch.exp(-2.0 * md)
    scale = torch.sqrt(1.0 - eta**2)
    generator = torch.Generator(device=z0.device).manual_seed(int(seed))

    def draw(j):
        if noise is not None:
            return noise[j]
        return torch.randn(z0.shape, generator=generator, device=z0.device, dtype=z0.dtype)

    def grad_u(gt, z, beta):
        return -(beta * gt + (1.0 - beta) * (-(z - vd_mean) * inv_var_q))

    xi = draw(0)
    z, rho = z0, exp_md * xi
    draws, zs, rhos = [xi], [z], [rho]
    w = torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device)
    gt = grad_logp(z)
    for i in range(nbridges):
        beta = betas[i]
        xi = draw(i + 1)
        draws.append(xi)
        rho = eta * rho + scale * (exp_md * xi)
        q0 = torch.sum(rho * rho * inv_var, -1)
        rho = rho - eps * grad_u(gt, z, beta) / 2.0
        z = z + eps * (rho * inv_var)
        for _ in range(lfsteps - 1):
            gt = grad_logp(z)
            rho = rho - eps * grad_u(gt, z, beta)
            z = z + eps * (rho * inv_var)
        gt = grad_logp(z)
        rho = rho - eps * grad_u(gt, z, beta) / 2.0
        w = w - 0.5 * (torch.sum(rho * rho * inv_var, -1) - q0)
        zs.append(z)
        rhos.append(rho)
    out = (z, w)
    if return_state:
        out += (torch.stack(zs), torch.stack(rhos),
                noise if noise is not None else torch.stack(draws))
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("uha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_uha_rollout.argtypes = [p] * 14 + [i] * 5 + [f] + [p]
    lib.cmcd_uha_rollout.restype = i
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    if (lib.cmcd_uha_chains_per_block(), lib.cmcd_uha_max_lfsteps(),
            lib.cmcd_uha_max_target_floats()) != (CHAINS_PER_BLOCK, MAX_LFSTEPS,
                                                  MAX_TARGET_FLOATS):
        raise RuntimeError("csrc/uha.cu and ops/uha.py disagree on their limits")
    return lib


def eps_eta(dev, eps, eta):
    """[eps, eta] as one f32 tensor on `dev`: the kernels read them there, so
    a call makes no host sync."""
    return torch.stack([_f32(eps, dev).reshape(()), _f32(eta, dev).reshape(())])


def _launch(lib, z0, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, *, nbridges,
            lfsteps, seed, noise, return_state, stream):
    """Marshal the arguments and launch the rollout on `stream`: (z, w) and,
    with return_state, the three stores."""
    dev, (n, dim) = z0.device, z0.shape
    scal = eps_eta(dev, eps, eta)
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    z_out = torch.empty_like(z0)
    w_out = z0.new_empty((n,))
    stores = [None] * 3
    if return_state:
        stores = [z0.new_empty((nbridges + 1, n, dim)) for _ in range(2)]
        stores.append(z0.new_empty((nbridges + 1, n, dim)) if noise is None else None)
    err = lib.cmcd_uha_rollout(
        ptr(z0), ptr(betas), ptr(noise), ptr(scal), ptr(seed_t), ptr(md), ptr(vd_mean),
        ptr(vd_logdiag), ptr(tpar), ptr(z_out), ptr(w_out), *(ptr(t) for t in stores),
        n, nbridges, lfsteps, code, tpar.numel(), inv_var, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"UHA rollout kernel failed: {lib.cmcd_error_string(err).decode()} "
                           f"({err})")
    if return_state:
        return z_out, w_out, stores[0], stores[1], noise if noise is not None else stores[2]
    return z_out, w_out


@torch.no_grad()
def evolve_uha_fused(
    z0, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, *, dim: int, nbridges: int,
    lfsteps: int = 1, seed=0, noise=None, return_state: bool = False,
):
    """Run nbridges UHA bridges for every chain in one launch.

    z0: (N, dim) f32; betas: (K,); eps, eta: scalar tensors or floats; md,
    vd_mean, vd_logdiag: (dim,); grad_logp: a kernel-form score of
    ops/target_grads on a target of UHA_TARGETS; seed: int or one-element
    integer tensor (read on the device, so no host sync); noise: optional
    (K + 1, N, dim) standard normals. Returns (z (N, dim), w_delta (N,));
    with return_state also (z_0..z_K, rho_0..rho_K, the draws), each
    (K + 1, N, dim): the kernel's Philox normals as it used them, or the
    injected tensor itself.
    """
    _check(z0, betas, grad_logp, dim, nbridges, lfsteps, noise)
    if z0.device.type == "cpu":
        return evolve_uha_fused_plain(
            z0, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp, dim=dim,
            nbridges=nbridges, lfsteps=lfsteps, seed=seed, noise=noise,
            return_state=return_state)
    if z0.device.type != "cuda":
        raise ValueError(f"fused UHA rollout: no kernel for device {z0.device}")
    dev = z0.device
    check_device_tensors("fused UHA rollout", dev, [z0, betas, md, vd_mean, vd_logdiag]
                         + ([noise] if noise is not None else []))
    out = _launch(_library(), z0, betas, eps, eta, md, vd_mean, vd_logdiag, grad_logp,
                  nbridges=nbridges, lfsteps=lfsteps, seed=seed, noise=noise,
                  return_state=return_state,
                  stream=torch.cuda.current_stream(dev).cuda_stream)
    count_launch(evolve_uha_fused, grad_logp.kernel_name)
    return out


# Launches in all, and by target (form_launches).
evolve_uha_fused.launches = 0
evolve_uha_fused.form_launches = {}
