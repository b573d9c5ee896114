"""The VarGrad replay backward: wrapper of the CUDA kernel (csrc/vargrad.cu)
and its plain PyTorch version.

Counterpart of cmcd_tpu/ops/pallas_vargrad.py::evolve_vargrad_bwd_replay,
with the port's layout: traj (K + 1, N, dim) holds z_0..z_K as the fused
rollout stored them (ops/overdamped.py, return_trajectory=True), cot (N,) is
the cotangent of each chain's summed log-weight increments. Returns the
gradient of  sum_n cot_n * sum_i (bk_lp_i - fk_lp_i)  with every state held
fixed (VarGrad's stop-gradient), as a dict
  {"eps": (), "betas": (K,), "vd_mean": (dim,), "vd_logdiag": (dim,),
   "sn": {parameter name of the GeffnerNet: gradient in that parameter's shape}}.

The kernel writes every derivative out by hand and reduces over chains and
points itself; the wrapper only transposes the one product it also makes on
the way in (c1 = emb @ W1[dim:] + b1, ops/overdamped.pack_geffner): from
the kernel's per-point sums over chains it forms d emb, d W1[dim:] and d b1
with two small matrix products. The plain version states the point loss
over the whole (K + 1, N) array and lets torch.autograd differentiate it.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from cmcd_tpu_torch.distributions import LOG_2PI
from cmcd_tpu_torch.integrators.overdamped import OverdampedSpec
from cmcd_tpu_torch.networks.geffner import GeffnerNet, softplus
from cmcd_tpu_torch.ops import build
from cmcd_tpu_torch.ops.overdamped import EPS_SCHEDULES, MAX_MIX, MAX_SMEM, pack_geffner
from cmcd_tpu_torch.schedules import eps_per_step

# The kernel's limits, mirrored from csrc/vargrad.cu (checked against the
# built kernel's own in _library()).
GROUPS = 4                # NG: groups of feature threads in a block
CHAINS_PER_TILE = 32      # TB = NG * 8
MAX_THREADS = 640


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(in_dim: int, n_mix: int) -> int:
    """Dynamic shared memory of one block (the kernel's layout: W2 and the
    dW2 accumulator, the hidden tile both ways, the h2 / g_a2 tile, head,
    means, per-chain exchange and the per-warp scalars)."""
    ip, tb = _round_up(in_dim, 4), CHAINS_PER_TILE
    floats = (2 * ip * (ip + 1) + 2 * tb * ip + ip * (tb + 4) + 2 * ip
              + _round_up(2 * n_mix, 4) + 4 * tb * 2 + tb + 10 * (MAX_THREADS // 32))
    return 4 * floats


def kernel_fits(in_dim: int, n_mix: int) -> bool:
    """True if a net of width in_dim and a score of n_mix components fit
    one block of the backward kernel."""
    return (
        in_dim >= 1
        and GROUPS * _round_up(in_dim, 32) <= MAX_THREADS
        and 1 <= n_mix <= MAX_MIX
        and smem_bytes(in_dim, n_mix) <= MAX_SMEM
    )


def _len_a(in_dim: int) -> int:
    return in_dim * in_dim + 5 * in_dim + 8


def _len_b(in_dim: int) -> int:
    return 2 * in_dim + 2


def _check(traj, cot, betas, grad_logp, spec, dim, nbridges, sn, eps_schedule):
    """Raise on what the kernel does not take (both devices)."""
    if not (spec.fwd_sn and spec.bwd_sn and spec.bwd_sn_offset == 1):
        raise NotImplementedError(
            "replay backward: the point-centric gradient needs the CAIS kernel "
            f"structure (net in both kernels, backward net at i + 1), got {spec}"
        )
    if getattr(grad_logp, "kernel_name", None) != "many_gmm":
        raise NotImplementedError(
            "replay backward: the kernel inlines the many_gmm score only "
            "(ops/target_grads.score_for_target)"
        )
    if dim != 2:
        raise ValueError(f"replay backward: dim must be 2 (many_gmm), got {dim}")
    if not isinstance(sn, GeffnerNet) or len(sn.layers) != 2:
        raise NotImplementedError(
            "replay backward: the kernel inlines the two-layer geffner net on the state"
        )
    if sn.nbridges != nbridges:
        raise ValueError("replay backward: net embedding rows != nbridges")
    if not kernel_fits(sn.in_dim, grad_logp.means.shape[0]):
        raise NotImplementedError(
            f"replay backward: in_dim {sn.in_dim} does not fit one block"
        )
    if eps_schedule not in EPS_SCHEDULES:
        raise ValueError(f"unknown eps schedule {eps_schedule!r}")
    n = cot.shape[0]
    if traj.shape != (nbridges + 1, n, dim) or cot.shape != (n,) or betas.shape != (nbridges,):
        raise ValueError(
            f"replay backward: shapes traj {tuple(traj.shape)}, cot {tuple(cot.shape)}, "
            f"betas {tuple(betas.shape)} do not match N={n}, dim={dim}, K={nbridges}"
        )


def _net_at_all_points(weights: dict, traj, nbridges: int):
    """The geffner net at every stored point: traj (K + 1, N, dim) ->
    (K + 1, N, dim), point j with embedding row min(j, K - 1)."""
    rows = torch.arange(nbridges + 1, device=traj.device).clamp(max=nbridges - 1)
    emb = weights["emb"][rows][:, None, :].expand(-1, traj.shape[1], -1)
    h = torch.cat([traj, emb], dim=-1)
    for i in range(2):
        h = h + softplus(F.linear(h, weights[f"layers.{i}.weight"], weights[f"layers.{i}.bias"]))
    return F.linear(h, weights["head.weight"], weights["head.bias"]) * weights["factor_sn"]


def evolve_vargrad_bwd_replay_plain(
    traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """The kernel's function in plain torch: the point loss over the whole
    (K + 1, N) array, differentiated by autograd. All states are data."""
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    leaf = lambda t: torch.as_tensor(t, dtype=torch.float32, device=traj.device) \
        .detach().clone().requires_grad_(True)
    theta = {"eps": leaf(eps), "betas": leaf(betas), "vd_mean": leaf(vd_mean),
             "vd_logdiag": leaf(vd_logdiag)}
    weights = {name: leaf(p) for name, p in sn.named_parameters()}
    traj = traj.detach()
    with torch.no_grad():
        gt = grad_logp(traj.reshape(-1, dim)).reshape(traj.shape)
        if clip_t is not None:
            gt = torch.clamp(gt, -clip_t, clip_t)
    with torch.enable_grad():
        sn_out = _net_at_all_points(weights, traj, nbridges)
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
        loss = torch.sum(cot.detach() * deltas)
        names = list(theta) + list(weights)
        grads = torch.autograd.grad(loss, [*theta.values(), *weights.values()])
    out = dict(zip(names, grads))
    return {**{k: out[k] for k in theta}, "sn": {k: out[k] for k in weights}}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("vargrad")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_vargrad_replay.argtypes = [p] * 18 + [i] * 7 + [f] * 3 + [p]
    lib.cmcd_vargrad_replay.restype = ctypes.c_int
    lib.cmcd_error_string.argtypes = [ctypes.c_int]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_vargrad_chains_per_tile.restype = ctypes.c_int
    lib.cmcd_vargrad_fits.argtypes = [i, i]
    lib.cmcd_vargrad_fits.restype = ctypes.c_int
    lib.cmcd_vargrad_smem_bytes.argtypes = [i, i]
    lib.cmcd_vargrad_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.cmcd_vargrad_len_a, lib.cmcd_vargrad_len_b):
        fn.argtypes = [i]
        fn.restype = ctypes.c_int
    if lib.cmcd_vargrad_chains_per_tile() != CHAINS_PER_TILE:
        raise RuntimeError("csrc/vargrad.cu and ops/vargrad.py disagree on the chain tile")
    # Every edge of the limits: shared memory (144/145 features), threads
    # (160/161) and the score's lanes (0, 1, 64, 65 components).
    for in_dim in (0, 1, 3, 18, 132, 144, 145, 148, 160, 161, 302):
        for n_mix in (0, 1, 40, 64, 65):
            if (bool(lib.cmcd_vargrad_fits(in_dim, n_mix)) != kernel_fits(in_dim, n_mix)
                    or lib.cmcd_vargrad_smem_bytes(in_dim, n_mix) != smem_bytes(in_dim, n_mix)
                    or lib.cmcd_vargrad_len_a(in_dim) != _len_a(in_dim)
                    or lib.cmcd_vargrad_len_b(in_dim) != _len_b(in_dim)):
                raise RuntimeError(
                    "csrc/vargrad.cu and ops/vargrad.py disagree on what fits one "
                    f"block at in_dim {in_dim}, {n_mix} components"
                )
    return lib


def _launch(lib, traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *,
            dim, nbridges, sn, eps_schedule, grad_clipping, splits, stream):
    """Marshal the arguments, launch, and assemble the gradient dict."""
    dev = traj.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()
    w1z, c1, emb, w2, b2, headw, headb, factor = pack_geffner(sn, dim)
    scal = torch.stack([f32(eps).reshape(()), factor.to(dev, torch.float32)])
    means = f32(grad_logp.means)
    weights = [w1z, c1, emb, w2, b2, headw, headb]
    for t in weights:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"replay backward: net weights must be f32 on {dev}")
    n, in_dim, points = cot.shape[0], sn.in_dim, nbridges + 1
    la, lb = _len_a(in_dim), _len_b(in_dim)
    part_a = torch.empty((points * splits, la), dtype=torch.float32, device=dev)
    part_b = torch.empty((points, splits, lb), dtype=torch.float32, device=dev)
    out_a = torch.empty(la, dtype=torch.float32, device=dev)
    out_b = torch.empty((points, lb), dtype=torch.float32, device=dev)
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.cmcd_vargrad_replay(
        ptr(traj), ptr(cot), ptr(betas), ptr(scal),
        *(ptr(t) for t in weights),
        ptr(means), ptr(vd_mean), ptr(vd_logdiag),
        ptr(part_a), ptr(part_b), ptr(out_a), ptr(out_b),
        n, nbridges, in_dim, sn.emb_dim, means.shape[0],
        EPS_SCHEDULES[eps_schedule], splits,
        grad_logp.inv_var,
        math.inf if clip_t is None else clip_t,
        math.inf if clip_q is None else clip_q,
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = lib.cmcd_error_string(err).decode()
        raise RuntimeError(f"vargrad replay kernel failed: {msg} ({err})")

    # out_a: dW2 (in x out), dheadW, db2, dW1[:dim], then eps, mean, logdiag,
    # factor, headb. out_b per point: G1 = sum_n g_a1, GH1 = sum_n g_h1,
    # dbeta_j (forward term), dbeta_{j-1} (backward term).
    sq = in_dim * in_dim
    g_w2 = out_a[:sq].view(in_dim, in_dim)
    g_headw = out_a[sq:sq + 2 * in_dim].view(2, in_dim)
    g_b2 = out_a[sq + 2 * in_dim:sq + 3 * in_dim]
    g_w1z = out_a[sq + 3 * in_dim:sq + 5 * in_dim].view(2, in_dim)
    s = out_a[sq + 5 * in_dim:]
    g1, gh1 = out_b[:, :in_dim], out_b[:, in_dim:2 * in_dim]
    g_betas = out_b[:nbridges, 2 * in_dim] + out_b[1:, 2 * in_dim + 1]
    # Point K used embedding row K - 1: fold it in, then transpose c1's
    # product: d c1 -> d emb, d W1[dim:], d b1; emb also feeds h0 directly.
    d_c1 = g1[:nbridges].clone()
    d_c1[nbridges - 1] += g1[nbridges]
    d_emb = gh1[:nbridges, dim:].clone()
    d_emb[nbridges - 1] += gh1[nbridges, dim:]
    w1 = sn.layers[0].weight.detach().t()            # (in, out)
    d_emb = d_emb + d_c1 @ w1[dim:].t()
    g_w1 = torch.cat([g_w1z, sn.emb.detach().t() @ d_c1])  # (in, out)
    return {
        "eps": s[0], "betas": g_betas, "vd_mean": s[1:3], "vd_logdiag": s[3:5],
        "sn": {
            "layers.0.weight": g_w1.t(), "layers.0.bias": d_c1.sum(0),
            "layers.1.weight": g_w2.t(), "layers.1.bias": g_b2,
            "head.weight": g_headw, "head.bias": s[6:8],
            "emb": d_emb, "factor_sn": s[5],
        },
    }


@torch.no_grad()
def evolve_vargrad_bwd_replay(
    traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, eps_schedule: str = "",
    grad_clipping: bool = False,
):
    """VarGrad gradient from the stored trajectory, in one launch of the
    backward kernel and one of its reduction.

    traj: (K + 1, N, dim) f32; cot: (N,) f32; betas: (K,); eps: scalar tensor
    or float; vd_mean / vd_logdiag: (dim,); grad_logp:
    ops/target_grads.ManyGMMScore; sn: the GeffnerNet. Returns the gradient
    dict described in the module docstring.
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
    for t in (traj, cot, betas, vd_mean, vd_logdiag):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "replay backward: traj, cot, betas and vd params must be "
                f"contiguous f32 on {dev}"
            )
    # Enough blocks to fill the card once: one per point, times chain splits.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-cot.shape[0] // CHAINS_PER_TILE)
    splits = max(1, min(tiles, -(-sms // (nbridges + 1))))
    grads = _launch(
        _library(), traj, cot, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
        splits=splits, stream=torch.cuda.current_stream(dev).cuda_stream, **kwargs,
    )
    evolve_vargrad_bwd_replay.launches += 1
    return grads


evolve_vargrad_bwd_replay.launches = 0
