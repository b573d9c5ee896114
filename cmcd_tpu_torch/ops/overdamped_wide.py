"""The wide form of the fused overdamped rollout: wrapper of the CUDA kernel
(csrc/overdamped_wide.cu) for the 1600-D LGCP, with the tile form's plain
twin.

Counterpart of cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas
where the JAX package runs it at LGCP's width, with the tile form's
signature and layout (ops/overdamped.py::evolve_overdamped_fused): z0 (N,
dim), w0 (N,), betas (K,), injected noise (K, N, dim); with
return_trajectory also z_0..z_K as (K + 1, N, dim) and with return_noise the
draws (K, N, dim), which the split KL sweep (ops/kl_split.py) reads. The
kernel takes CAIS (and CAIS_VAR, whose forward is the same) with the
two-layer geffner net on [z, emb] and the LGCP score inlined, unwhitened or
whitened (ops/target_grads.WIDE_TARGETS), at a dim and width the caller
gives at run time (a multiple of 4 each). Its plain twin is the tile form's
evolve_overdamped_fused_plain, which is D-generic.

On a CPU tensor the wrapper runs the plain twin; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, OverdampedSpec
from cmcd_tpu_torch.networks.geffner import GeffnerNet
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops.overdamped import (
    EPS_SCHEDULES,
    _f32,
    count_launch,
    evolve_overdamped_fused_plain,
)
from cmcd_tpu_torch.ops.target_grads import WIDE_TARGETS, kernel_target

# The kernels' layout, mirrored from csrc/cmcd_wide.cuh so that the gates
# (ops/fused.supports_fused) decide without a card; _library() checks this
# copy against the built kernels' own.
CHAINS_PER_BLOCK = 4   # TBW: the chains of one block
THREADS = 512          # threads of one block
RED_SLOTS = 8          # per-warp floats of a block sum
MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
# The specs the wide rollout takes (one net in both kernels, the backward
# net at i + 1).
WIDE_SPECS = (CAIS, CAIS_VAR)
# One chain's workspace vectors: (of length dim, of length in_dim).
ROLLOUT_WS = (8, 2)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(in_dim: int, dim: int) -> int:
    """Dynamic shared memory of one block: the staging rows of its chains
    and the block sums."""
    return 4 * (CHAINS_PER_BLOCK * _round_up(max(in_dim, dim), 4)
                + (THREADS // 32) * RED_SLOTS)


def kernel_fits(in_dim: int, n_par: int, dim: int) -> bool:
    """True if the wide kernels take a geffner net of width in_dim on a
    state of dim: both a multiple of 4 (the float4 walks), in_dim >= dim,
    the LGCP's two constants (mu, a) and the staging rows in one block's
    shared memory. The matrices stay in device memory: no width limit
    besides."""
    return (dim >= 4 and dim % 4 == 0 and in_dim >= dim and in_dim % 4 == 0
            and n_par == 2 and smem_bytes(in_dim, dim) <= MAX_SMEM)


def ws_floats(counts: tuple, in_dim: int, dim: int) -> int:
    """Floats of one chain's workspace: counts[0] vectors of dim, counts[1]
    of in_dim, each padded to a multiple of 4."""
    return counts[0] * _round_up(dim, 4) + counts[1] * _round_up(in_dim, 4)


def check_wide_target(what, grad_logp, dim):
    """Raise unless the wide kernels take the target: the LGCP score at the
    state's dim."""
    name = getattr(grad_logp, "kernel_name", None)
    if name not in WIDE_TARGETS:
        raise NotImplementedError(
            f"{what}: the wide kernels inline the LGCP score only (ops/target_grads.LgcpScore)")
    if grad_logp.dim != dim:
        raise ValueError(f"{what}: dim must be {grad_logp.dim} ({name}), got {dim}")


def check_wide_net(what, sn, nbridges, dim):
    """Raise unless the wide kernels take the net: the two-layer geffner net
    on [z, emb] with nbridges embedding rows, at a width that fits."""
    if not isinstance(sn, GeffnerNet) or len(sn.layers) != 2 or sn.rho_dim:
        raise NotImplementedError(f"{what}: the wide kernels inline the two-layer geffner net "
                                  "on [z, emb] only")
    if sn.nbridges != nbridges:
        raise ValueError(f"{what}: net embedding rows != nbridges")
    if not kernel_fits(sn.in_dim, 2, dim):
        raise NotImplementedError(f"{what}: a net of width {sn.in_dim} on dim {dim} does not "
                                  "fit the wide kernels (widths a multiple of 4)")


def _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule, noise):
    what = "wide rollout"
    if spec not in WIDE_SPECS:
        raise NotImplementedError(f"{what}: spec {spec} has no kernel")
    check_wide_target(what, grad_logp, dim)
    check_wide_net(what, sn, nbridges, dim)
    if eps_schedule not in EPS_SCHEDULES:
        raise ValueError(f"unknown eps schedule {eps_schedule!r}")
    n = z0.shape[0]
    if z0.shape != (n, dim) or w0.shape != (n,) or betas.shape != (nbridges,):
        raise ValueError(
            f"{what}: shapes z0 {tuple(z0.shape)}, w0 {tuple(w0.shape)}, "
            f"betas {tuple(betas.shape)} do not match N={n}, dim={dim}, K={nbridges}"
        )
    if noise is not None and noise.shape != (nbridges, n, dim):
        raise ValueError(f"{what}: noise must be {(nbridges, n, dim)}")


# The plain twin: the tile form's, which is D-generic.
evolve_overdamped_wide_plain = evolve_overdamped_fused_plain


def declare_layout(lib, prefix: str, ws_counts: tuple, what: str):
    """Declare a wide kernel library's layout queries and check this
    module's formulas against them at LGCP's widths and at the edges."""
    i = ctypes.c_int
    get = lambda name: getattr(lib, f"cmcd_{prefix}_{name}")
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    get("chains_per_block").restype = i
    get("fits").argtypes = [i, i, i]
    get("fits").restype = i
    get("smem_bytes").argtypes = [i, i]
    get("smem_bytes").restype = ctypes.c_longlong
    get("ws_floats").argtypes = [i, i]
    get("ws_floats").restype = ctypes.c_longlong
    if get("chains_per_block")() != CHAINS_PER_BLOCK:
        raise RuntimeError(f"{what} and its wrapper disagree on the chains of a block")
    for in_dim, dim in ((1620, 1600), (1600, 1600), (84, 64), (420, 400), (22, 2), (1618, 1600),
                        (14000, 13000), (14600, 14000)):
        emb = in_dim - dim
        if (bool(get("fits")(in_dim, dim, emb)) != kernel_fits(in_dim, 2, dim)
                or get("smem_bytes")(in_dim, dim) != smem_bytes(in_dim, dim)
                or get("ws_floats")(in_dim, dim) != ws_floats(ws_counts, in_dim, dim)):
            raise RuntimeError(f"{what} and its wrapper disagree on the layout at in_dim "
                               f"{in_dim}, dim {dim}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("overdamped_wide")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_wide_rollout.argtypes = [p] * 23 + [i] * 7 + [f] * 2 + [p]
    lib.cmcd_wide_rollout.restype = i
    lib.cmcd_wide_threads.restype = i
    lib.cmcd_wide_score_probe.argtypes = [p] * 9 + [i] * 3 + [p]
    lib.cmcd_wide_score_probe.restype = i
    if lib.cmcd_wide_threads() != THREADS:
        raise RuntimeError("csrc/cmcd_wide.cuh and ops/overdamped_wide.py disagree on THREADS")
    declare_layout(lib, "wide", ROLLOUT_WS, "csrc/overdamped_wide.cu")
    return lib


@torch.no_grad()
def score_and_hvp(grad_logp, x, u):
    """(score(x), H(x) u) for x, u (N, dim): on CUDA tensors through the
    device functions the wide kernels inline (a probe kernel that no path
    launches, for the card's check against float64), on the CPU the plain
    LgcpScore."""
    check_wide_target("LGCP score probe", grad_logp, x.shape[1])
    if x.device.type == "cpu":
        return grad_logp(x), grad_logp.hvp(x, u)
    dev, (n, dim) = x.device, x.shape
    code, mat, counts, tpar = wide_target_args(grad_logp, dev)
    rows = _round_up(n, CHAINS_PER_BLOCK)
    pad = lambda t: torch.cat([t, t.new_zeros(rows - n, dim)]).contiguous()
    xp, up = pad(x.float()), pad(u.float())
    gt, hv, ez, tmp = (torch.zeros_like(xp) for _ in range(4))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _library().cmcd_wide_score_probe(
        ptr(mat), ptr(counts), ptr(tpar), ptr(xp), ptr(up), ptr(gt), ptr(hv), ptr(ez), ptr(tmp),
        rows, dim, code, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"LGCP score probe failed: {_library().cmcd_error_string(err).decode()}")
    return gt[:n], hv[:n]


def wide_net_args(sn, nbridges: int, dev):
    """The net as a wide launch passes it: ([w1z, c1, emb, w2, b2, headw,
    headb] f32 on dev, factor_sn, in_dim, emb_dim)."""
    packed = nets.pack(sn, nbridges)
    for t in packed["weights"]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"wide kernels: net weights must be f32 on {dev}")
    return packed["weights"], packed["factor"], packed["in_dim"], packed["emb_dim"]


def wide_target_args(grad_logp, dev):
    """The LGCP as a wide launch passes it: (code, mat, counts, [mu, a])."""
    code, tpar, _ = kernel_target(grad_logp, dev)
    mat, counts = grad_logp.mat, grad_logp.counts
    for t in (mat, counts):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"wide kernels: the LGCP constants must be contiguous f32 on {dev}")
    return code, mat, counts, tpar


def form_key(grad_logp) -> str:
    """The name of a wide launch's form in form_launches: "CAIS/<target>"."""
    return f"CAIS/{grad_logp.kernel_name}"


@torch.no_grad()
def evolve_overdamped_wide(
    z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False, seed=0, noise=None, return_trajectory: bool = False,
    return_noise: bool = False,
):
    """Run nbridges steps of CAIS (or CAIS_VAR) for every chain in one launch,
    the arguments and results of ops/overdamped.evolve_overdamped_fused:
    grad_logp the LGCP score (ops/target_grads.LgcpScore) at dim, sn the
    two-layer GeffnerNet on [z, emb]."""
    _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule, noise)
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping, seed=seed, noise=noise)
    if z0.device.type == "cpu":
        return evolve_overdamped_wide_plain(
            z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
            return_trajectory=return_trajectory, return_noise=return_noise, **kwargs
        )
    if z0.device.type != "cuda":
        raise ValueError(f"wide rollout: no kernel for device {z0.device}")
    dev = z0.device
    for t in [z0, w0, betas, vd_mean, vd_logdiag] + ([noise] if noise is not None else []):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"wide rollout: z0, w0, betas, vd params and noise must be "
                             f"contiguous f32 on {dev}")
    out = _launch(_library(), z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
                  stored=(return_trajectory, return_noise),
                  stream=torch.cuda.current_stream(dev).cuda_stream, **kwargs)
    count_launch(evolve_overdamped_wide, form_key(grad_logp))
    return out


def _launch(lib, z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *, dim, nbridges,
            sn, eps_schedule, grad_clipping, seed, noise, stored, stream):
    """Marshal the arguments and launch the rollout on `stream`: (z, w) and
    the stores asked for (stored: trajectory, noise)."""
    dev = z0.device
    weights, factor, in_dim, emb_dim = wide_net_args(sn, nbridges, dev)
    code, mat, counts, tpar = wide_target_args(grad_logp, dev)
    scal = torch.stack([_f32(eps, dev).reshape(()), _f32(factor, dev).reshape(())])
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    vd_inv_var = torch.exp(-2.0 * vd_logdiag).contiguous()
    n = z0.shape[0]
    blocks = -(-n // CHAINS_PER_BLOCK)
    ws = torch.empty(blocks * CHAINS_PER_BLOCK * ws_floats(ROLLOUT_WS, in_dim, dim),
                     dtype=torch.float32, device=dev)
    z_out, w_out = torch.empty_like(z0), torch.empty_like(w0)
    return_trajectory, return_noise = stored
    traj = z0.new_empty((nbridges + 1, n, dim)) if return_trajectory else None
    draws = z0.new_empty((nbridges, n, dim)) if return_noise and noise is None else None
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    err = lib.cmcd_wide_rollout(
        ptr(z0), ptr(w0), ptr(betas), ptr(noise), ptr(scal), ptr(seed_t),
        *(ptr(t) for t in weights), ptr(mat), ptr(counts), ptr(tpar), ptr(vd_mean),
        ptr(vd_inv_var), ptr(z_out), ptr(w_out), ptr(traj), ptr(draws), ptr(ws),
        n, nbridges, dim, in_dim, emb_dim, EPS_SCHEDULES[eps_schedule], code,
        math.inf if clip_t is None else clip_t, math.inf if clip_q is None else clip_q,
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"wide rollout kernel failed: {lib.cmcd_error_string(err).decode()} ({err})")
    out = (z_out, w_out)
    if return_trajectory:
        out += (traj,)
    if return_noise:
        out += (noise if noise is not None else draws,)
    return out


# Launches in all, and by form ("CAIS/lgcp", "CAIS/lgcp_whitened").
evolve_overdamped_wide.launches = 0
evolve_overdamped_wide.form_launches = {}
