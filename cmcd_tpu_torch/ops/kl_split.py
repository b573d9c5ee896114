"""The split KL reverse sweep ("B12"): wrapper of the CUDA kernel
(csrc/kl_split.cu) for the 1600-D LGCP and its plain PyTorch version.

Counterpart of the split branch of
cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_pallas (net_grads_outside, the
form the JAX package takes for a net past 4 MB): the CAIS sweep from z_K
down to z_0 runs in the kernel with the state's cotangents only, and writes
each stored point's net-output cotangent g_sn; the net's weight gradients
then come from one batched autograd pass of the plain net over the stored
trajectory (every point p at embedding row min(p, K - 1)) seeded with those
cotangents (net_weight_grads), as JAX takes them from one XLA vjp. That
pass is plain large matrix products outside any kernel, on either device.

The layout is ops/kl.py's: traj (K + 1, N, dim) and noise (K, N, dim) as
the wide rollout stored them (ops/overdamped_wide.py), cot (N,), g_zfinal
(N, dim). Returns (grads, g_z0, gsn): the gradient dict of ops/kl.py with
"sn" keyed by the GeffnerNet's parameter names, g_z0 (N, dim), and the
cotangent stack gsn (K + 1, N, dim). The kernel reads the stored draws;
JAX's float32 split path rebuilds them from the trajectory, a difference of
about an ulp of z over the step scale. The plain version is ops/kl.py's
plain sweep in its split mode (the net's VJP in z only), then the same
weight pass.

The kernel is one cooperative launch of as many blocks as the card holds
at once (one an SM), which carry every chain through each point together
(csrc/kl_split.cu says how). The wrapper takes the sizes of its scratch
from the library.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmcd_tpu_torch.integrators.overdamped import CAIS, OverdampedSpec
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops import overdamped_wide as wide
from cmcd_tpu_torch.ops.kl import evolve_kl_bwd_plain
from cmcd_tpu_torch.ops.overdamped import EPS_SCHEDULES, count_launch
from cmcd_tpu_torch.ops.vargrad import check_device_tensors, clips, ptr, raise_on

# The spec of the split sweep: one net in both kernels, carried.
SPLIT_SPECS = (CAIS,)


def len_sums(dim: int, nbridges: int) -> int:
    """Floats of the kernel's sums: eps, betas (K), vd mean, vd logdiag."""
    return 1 + nbridges + 2 * dim


def _check(traj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule):
    what = "split KL sweep"
    if spec not in SPLIT_SPECS:
        raise NotImplementedError(f"{what}: no kernel for spec {spec}")
    wide.check_wide_target(what, grad_logp, dim)
    wide.check_wide_net(what, sn, nbridges, dim)
    if eps_schedule not in EPS_SCHEDULES:
        raise ValueError(f"unknown eps schedule {eps_schedule!r}")
    n = cot.shape[0]
    if (traj.shape != (nbridges + 1, n, dim) or noise.shape != (nbridges, n, dim)
            or cot.shape != (n,) or g_zfinal.shape != (n, dim) or betas.shape != (nbridges,)):
        raise ValueError(
            f"{what}: shapes traj {tuple(traj.shape)}, noise {tuple(noise.shape)}, "
            f"cot {tuple(cot.shape)}, g_zfinal {tuple(g_zfinal.shape)}, betas "
            f"{tuple(betas.shape)} do not match N={n}, dim={dim}, K={nbridges}"
        )


def net_weight_grads(sn, traj, gsn, nbridges: int) -> dict:
    """The geffner net's parameter gradients from the per-point cotangents
    of its output: one batched autograd pass of the net at every stored
    point (row min(p, K - 1)), in traj's dtype, seeded with gsn (the
    cotangent of the output with factor_sn applied, so factor_sn gets its
    gradient too)."""
    weights = nets.plain_weights(sn, nbridges, traj.dtype, traj.device)
    rows = torch.arange(nbridges + 1, device=traj.device).clamp(max=nbridges - 1)
    with torch.enable_grad():
        out = nets.geffner_from_weights(weights, traj.detach(), rows)
        grads = torch.autograd.grad(out, list(weights.values()), gsn.to(traj.dtype))
    return dict(zip(weights, grads))


@torch.no_grad()
def evolve_kl_split_plain(
    traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp,
    spec: OverdampedSpec, *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """The kernel's function and the weight pass in plain torch, in traj's
    dtype (float64 to arbitrate): (grads, g_z0, gsn)."""
    grads, g_z0, gsn = evolve_kl_bwd_plain(
        traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
        dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
        grad_clipping=grad_clipping, split=True)
    grads["sn"] = net_weight_grads(sn, traj, gsn, nbridges)
    return grads, g_z0, gsn


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("kl_split")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.cmcd_kl_split_sweep.argtypes = [p] * 24 + [i] * 7 + [f] * 2 + [i, p]
    lib.cmcd_kl_split_sweep.restype = i
    lib.cmcd_error_string.argtypes = [i]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    for name, args, res in (("blocks", [i], i), ("groups", [i], i), ("ws_floats", [i, i, i], ll),
                            ("slot_floats", [i, i, i, i], ll), ("len_sums", [i, i], i)):
        fn = getattr(lib, f"cmcd_kl_split_{name}")
        fn.argtypes, fn.restype = args, res
    if any(lib.cmcd_kl_split_len_sums(d, k) != len_sums(d, k) for d, k in ((1600, 8), (64, 3))):
        raise RuntimeError("csrc/kl_split.cu and ops/kl_split.py disagree on the sums' layout")
    return lib


@functools.lru_cache(maxsize=None)
def _blocks(dev: torch.device, code: int) -> int:
    """Blocks of one launch on the card: as many as are co-resident."""
    lib = _library()
    with torch.cuda.device(dev):
        blocks = lib.cmcd_kl_split_blocks(code)
    raise_on(max(-blocks, 0), lib, "split KL sweep")
    if blocks == 0:
        raise RuntimeError("split KL sweep: no block of the kernel fits an SM of the card")
    return blocks


def _launch(lib, traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
            *, dim, nbridges, sn, eps_schedule, grad_clipping, stream):
    """Marshal the arguments and launch the sweep: (the small gradients,
    g_z0, gsn, the grid)."""
    dev, n = traj.device, cot.shape[0]
    weights, factor, in_dim, emb_dim = wide.wide_net_args(sn, nbridges, dev)
    code, mat, counts, tpar = wide.wide_target_args(grad_logp, dev)
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())
    scal = torch.stack([f32(eps), f32(factor)])
    blocks = _blocks(dev, code)
    ls = len_sums(dim, nbridges)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    bsum, out = new(blocks, 1 + nbridges), new(ls)
    part = new(2 * lib.cmcd_kl_split_slot_floats(n, in_dim, dim, blocks))
    ws = new(lib.cmcd_kl_split_ws_floats(n, in_dim, dim))
    g_z0, gsn = torch.empty_like(g_zfinal), new(nbridges + 1, n, dim)
    err = lib.cmcd_kl_split_sweep(
        ptr(traj), ptr(noise), ptr(cot), ptr(g_zfinal), ptr(betas), ptr(scal),
        *(ptr(t) for t in weights), ptr(mat), ptr(counts), ptr(tpar), ptr(vd_mean),
        ptr(vd_logdiag), ptr(bsum), ptr(part), ptr(out), ptr(g_z0), ptr(gsn), ptr(ws),
        n, nbridges, dim, in_dim, emb_dim, EPS_SCHEDULES[eps_schedule], code,
        *clips(spec, grad_clipping), blocks, ctypes.c_void_p(stream),
    )
    raise_on(err, lib, "split KL sweep")
    grads = {"eps": out[0], "betas": out[1:1 + nbridges],
             "vd_mean": out[1 + nbridges:1 + nbridges + dim],
             "vd_logdiag": out[1 + nbridges + dim:ls]}
    return grads, g_z0, gsn, {"blocks": blocks, "chain_groups": lib.cmcd_kl_split_groups(n)}


@torch.no_grad()
def evolve_kl_split(
    traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp,
    spec: OverdampedSpec, *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """KL (backprop-through-time) gradient of CAIS on the LGCP from the
    stored trajectory and noise: one cooperative launch of the split sweep,
    then the batched weight pass. The arguments are
    ops/kl.evolve_kl_bwd's with grad_logp the LGCP score and sn the
    two-layer GeffnerNet on [z, emb]; returns (grads, g_z0, gsn)."""
    _check(traj, noise, cot, g_zfinal, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule)
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping)
    args = (traj, noise, cot, g_zfinal, betas, eps, vd_mean, vd_logdiag, grad_logp, spec)
    if traj.device.type == "cpu":
        return evolve_kl_split_plain(*args, **kwargs)
    if traj.device.type != "cuda":
        raise ValueError(f"split KL sweep: no kernel for device {traj.device}")
    dev = traj.device
    check_device_tensors("split KL sweep", dev,
                         (traj, noise, cot, g_zfinal, betas, vd_mean, vd_logdiag))
    grads, g_z0, gsn, grid = _launch(_library(), *args,
                                     stream=torch.cuda.current_stream(dev).cuda_stream, **kwargs)
    count_launch(evolve_kl_split, wide.form_key(grad_logp))
    evolve_kl_split.last_grid = grid
    grads["sn"] = net_weight_grads(sn, traj, gsn, nbridges)
    return grads, g_z0, gsn


# Launches in all, and by form ("CAIS/lgcp", "CAIS/lgcp_whitened"); the
# last launch's grid ({"blocks", "chain_groups"}).
evolve_kl_split.launches = 0
evolve_kl_split.form_launches = {}
evolve_kl_split.last_grid = None
