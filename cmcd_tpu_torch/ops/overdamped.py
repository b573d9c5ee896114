"""The fused overdamped rollout: wrapper of the CUDA kernel
(csrc/overdamped.cu) and its plain PyTorch twin.

Counterpart of cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas,
with the port's layout: z0 (N, dim), w0 (N,), betas (K,), injected noise
(K, N, dim), all f32; with return_trajectory=True also the stored path
z_0..z_K as (K + 1, N, dim), which the VarGrad backward (ops/vargrad.py)
reads, and with return_noise=True the draws xi_0..xi_{K-1} as (K, N, dim),
which the KL reverse sweep (ops/kl.py) reads beside it. The kernel covers
every overdamped spec (FORMS: CAIS and CAIS_VAR, ULA_SN with the net in
the backward kernel only, ULA without a net, and DNF with zero drift and two
geffner nets, the second in the backward mean: sn2) on the many_gmm and the
3-mode gmm scores (dim 2) and on the funnel's and the standard normal's
(dim 10; ops/target_grads.py: TARGETS, KERNEL_DIMS) with the two-layer
geffner net or a PIS net ("dds", "dds_grad" of two equal widths; ops/nets.py
forms its tables, csrc/overdamped.cu takes it as a template parameter; DNF
takes geffner nets only, as the JAX package); and, built from a source of
its own (csrc/overdamped_logreg.cu, source_for), CAIS with the geffner net
on the Bayesian logistic regressions (dim 15, 35, 61; LOGREG_TARGETS),
whose dataset the kernel reads through a pointer of its own. The wrapper
raises on anything else, a dim other than the target's instance included.
DNF reads no score: its form is instantiated by the state's dimension
alone.

On a CPU tensor the wrapper runs the plain twin; on a CUDA tensor it
launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cmcd_tpu_torch.integrators.overdamped import (
    CAIS,
    CAIS_VAR,
    DNF,
    ULA,
    ULA_SN,
    OverdampedSpec,
)
from cmcd_tpu_torch.ops import build, nets
from cmcd_tpu_torch.ops.target_grads import (
    KERNEL_DIMS,
    LOGREG_TARGETS,
    MAX_TARGET_FLOATS,
    TARGETS,
    WIDE_TARGETS,
    kernel_data,
    kernel_target,
    n_target_floats,
)
from cmcd_tpu_torch.schedules import eps_at_step

# The kernel's limits, mirrored from csrc/overdamped.cu so that the gate
# (ops/fused.supports_fused) can decide without a card; _library() checks
# this copy against the built kernel's own.
CHAINS_PER_BLOCK = 8      # TC
MAX_THREADS = 256         # one thread per net feature
MAX_SMEM = 232448         # bytes of shared memory a block may use on sm_90
EPS_SCHEDULES = {"": 0, "linear": 1, "cos_sq": 2}
# The kernel's form of each spec (csrc/overdamped.cu): 0 the net in both
# kernels, backward net at i + 1; 1 the net in the backward kernel at i; 2 no
# net; 3 DNF's two nets and no drift. The words name a form in the launch
# counts (form_launches).
FORMS = {CAIS: 0, CAIS_VAR: 0, ULA_SN: 1, ULA: 2, DNF: 3}
FORM_WORDS = ("CAIS", "ULA_sn", "ULA", "DNF")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def uses_net(spec: OverdampedSpec) -> bool:
    """True if the spec applies the score net in either kernel (all but ULA)."""
    return spec.fwd_sn or spec.bwd_sn


def smem_bytes(in_dim: int, n_par: int, dim: int, nets: int = 1) -> int:
    """Dynamic shared memory of one block of the tile form for a target of
    dimension dim (the kernel's layout: W2 and the dim head rows of each of
    `nets` nets, two hidden tiles, the target's n_par constants and the
    per-chain exchange). nets 2: DNF's form, which keeps no constants."""
    ip = _round_up(in_dim, 4)
    tc = CHAINS_PER_BLOCK
    return 4 * (nets * (ip * ip + dim * ip) + 2 * tc * ip + _round_up(n_par, 4)
                + 3 * tc * dim)


def kernel_fits(in_dim: int, n_par: int, dim: int, nets: int = 1) -> bool:
    """True if `nets` nets of width in_dim and a target of n_par constants
    and dimension dim fit one block of the tile form (threads, shared
    memory). With nets 2 (DNF, no score in the bridge) n_par is not read."""
    if nets == 2:
        n_par = 0
    return (
        in_dim >= 1
        and _round_up(in_dim, 32) <= MAX_THREADS
        and (nets == 2 or 1 <= n_par <= MAX_TARGET_FLOATS)
        and smem_bytes(in_dim, n_par, dim, nets) <= MAX_SMEM
    )



def check_target(what, grad_logp, dim):
    """Raise unless the kernels take the target: a kernel_name of TARGETS at
    the dim its template is instantiated at (KERNEL_DIMS: 2 for the
    mixtures, 10 for the funnel and the standard normal)."""
    name = getattr(grad_logp, "kernel_name", None)
    if name not in TARGETS or name in WIDE_TARGETS:
        raise NotImplementedError(
            f"{what}: the kernel inlines the many_gmm, gmm, funnel and standard normal "
            "scores only (ops/target_grads.score_for_target; the LGCP runs through the "
            "wide forms, ops/overdamped_wide.py and ops/kl_split.py)"
        )
    want = KERNEL_DIMS[name]
    if dim != want or getattr(grad_logp, "dim", want) != want:
        raise ValueError(f"{what}: dim must be {want} ({name}), got {dim}")
    if n_target_floats(grad_logp) > MAX_TARGET_FLOATS:
        raise NotImplementedError(f"{what}: more than {MAX_TARGET_FLOATS // 2} components")


def source_for(grad_logp, source: str = "overdamped") -> str:
    """The csrc source whose library launches `source`'s kernel on this
    target: "<source>_logreg" for a logistic regression (its instances
    compile apart, csrc/overdamped_logreg.cu and csrc/kl_logreg.cu), else
    `source` itself."""
    return f"{source}_logreg" if grad_logp.kernel_name in LOGREG_TARGETS else source


def check_logreg_form(what, grad_logp, spec, sn):
    """Raise unless the logistic regression instances take (spec, net):
    they are built for the CAIS carry with the geffner net (MCD_CAIS_sn's
    rollout and KL sweep) only."""
    if grad_logp.kernel_name not in LOGREG_TARGETS:
        return
    if spec != CAIS or sn is None or nets.is_pis(sn):
        raise NotImplementedError(
            f"{what}: on {grad_logp.kernel_name} the kernels are instantiated for "
            "MCD_CAIS_sn with the geffner net only (ROADMAP queue B: the logistic "
            "regressions in B2/B5, in the ULA, ULA_sn and DNF forms, with the PIS nets, "
            "in B6-B9)")


def check_net(what, sn, nbridges, dim, fits, sn2=None):
    """Raise unless a kernel with a net tile takes `sn`
    (ops/nets.check_kernel_net) at a width that `fits`(width); with sn2 (DNF)
    also the second net, a geffner net of the same width, as both are."""
    nets.check_kernel_net(what, sn, nbridges, dim)
    width = nets.net_width(sn)
    if sn2 is not None:
        nets.check_kernel_net(what, sn2, nbridges, dim)
        if nets.is_pis(sn) or nets.is_pis(sn2):
            raise NotImplementedError(f"{what}: DNF takes geffner nets only (JAX: "
                                      "no fused DNF with the PIS nets)")
        if nets.net_width(sn2) != width or sn2.rho_dim or sn.rho_dim:
            raise ValueError(f"{what}: DNF's two nets must be state-only and of one width")
    if not fits(width):
        raise NotImplementedError(f"{what}: a net of width {width} does not fit one block")


def form_key(spec: OverdampedSpec, grad_logp, sn=None) -> str:
    """The name of a launch's form in form_launches: "<form>/<target>", and
    "/dds" or "/dds_grad" after it for a PIS net."""
    word = nets.net_word(sn) if uses_net(spec) else None
    return f"{FORM_WORDS[FORMS[spec]]}/{grad_logp.kernel_name}" + (f"/{word}" if word else "")


def count_launch(wrapper, form: str):
    """One launch of `wrapper`'s kernel in `form`: its count and its form's
    (the wrapper's `launches` and `form_launches`)."""
    wrapper.launches += 1
    wrapper.form_launches[form] = wrapper.form_launches.get(form, 0) + 1


def _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, sn2, eps_schedule, noise):
    """Raise on what the kernel does not take (both devices)."""
    what = "fused rollout"
    if spec not in FORMS:
        raise NotImplementedError(f"{what}: spec {spec} has no kernel")
    check_target(what, grad_logp, dim)
    check_logreg_form(what, grad_logp, spec, sn)
    if spec.use_sn2_bwd and sn2 is None:
        raise ValueError(f"{what}: DNF needs the second net's weights (sn2)")
    if uses_net(spec):
        check_net(what, sn, nbridges, dim, lambda width: kernel_fits(
            width, n_target_floats(grad_logp), dim, 2 if spec.use_sn2_bwd else 1),
            sn2 if spec.use_sn2_bwd else None)
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


@torch.no_grad()
def evolve_overdamped_fused_plain(
    z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, sn2=None, eps_schedule: str = "",
    grad_clipping: bool = False, seed=0, noise=None, generator=None,
    return_trajectory: bool = False, return_noise: bool = False,
):
    """The kernel's math in eager torch, step by step: the same clips, the
    same carry of the score (and, for CAIS, of the net output) and the same
    weight formula, for every spec of FORMS (sn unused by ULA). DNF: no
    drift and no score; the forward net at (z_i, i), sn2 at (z_{i+1}, i + 1).
    Without injected noise the draws come from `generator`, or from a
    generator seeded with `seed` on z0's device (not the kernel's Philox
    stream: the two agree in distribution only). Returns (z (N, dim), w (N,)),
    with return_trajectory also traj (K + 1, N, dim) = z_0..z_K, and with
    return_noise also the draws (K, N, dim) (the injected tensor itself, if
    there was one)."""
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    inv_var_q = torch.exp(-2.0 * vd_logdiag)
    if noise is None and generator is None:
        generator = torch.Generator(device=z0.device).manual_seed(int(seed))

    def grad_u(gt, z, beta):
        gq = -(z - vd_mean) * inv_var_q
        if clip_t is not None:
            gt = torch.clamp(gt, -clip_t, clip_t)
        if clip_q is not None:
            gq = torch.clamp(gq, -clip_q, clip_q)
        return -(beta * gt + (1.0 - beta) * gq)

    z, w = z0, w0
    traj, draws = [z0], []
    net = nets.plain_apply(sn, nbridges) if uses_net(spec) else None
    bwd_net = nets.plain_apply(sn2, nbridges) if spec.use_sn2_bwd else net
    score = (lambda x: None) if spec.zero_drift else grad_logp
    drift = (lambda gt_, z_, beta_: 0.0) if spec.zero_drift else grad_u
    gt = score(z)
    # CAIS carries the net output from one step's backward mean into the
    # next's forward mean; DNF's forward net is applied afresh each step.
    carry = spec.fwd_sn and not spec.use_sn2_bwd
    sn_cur = net(z, 0, gt) if carry else None
    for i in range(nbridges):
        eps_i = eps_at_step(eps, i, nbridges, eps_schedule)
        scale = torch.sqrt(2.0 * torch.as_tensor(eps_i))
        beta = betas[i]
        fk_mean = z - eps_i * drift(gt, z, beta)
        if spec.fwd_sn:
            fk_mean = fk_mean - eps_i * (sn_cur if carry else net(z, i, gt))
        if noise is None:
            xi = torch.randn(z.shape, generator=generator, device=z.device)
            if return_noise:
                draws.append(xi)
        else:
            xi = noise[i]
        z_new = fk_mean + scale * xi
        gt_new = score(z_new)
        bk_mean = z_new - eps_i * drift(gt_new, z_new, beta)
        if spec.bwd_sn:
            sn_new = bwd_net(z_new, i + spec.bwd_sn_offset, gt_new)
            bk_mean = bk_mean + eps_i * sn_new
        resid = (z - bk_mean) * (1.0 / scale)
        w = w - 0.5 * (torch.sum(resid * resid, -1) - torch.sum(xi * xi, -1))
        z, gt = z_new, gt_new
        if carry:
            sn_cur = sn_new
        if return_trajectory:
            traj.append(z)
    out = (z, w)
    if return_trajectory:
        out += (torch.stack(traj),)
    if return_noise:
        out += (noise if noise is not None else torch.stack(draws),)
    return out


@functools.lru_cache(maxsize=None)
def _library(source: str = "overdamped") -> ctypes.CDLL:
    """The built library of csrc/<source>.cu ("overdamped", or
    "overdamped_logreg": the same entry points), its limits checked
    against this module's copy."""
    lib = build.load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cmcd_overdamped_rollout.argtypes = [p] * 20 + [i] * 8 + [f] * 3 + [i] + [p] * 9 + [i, p]
    lib.cmcd_overdamped_rollout.restype = ctypes.c_int
    if source == "overdamped_logreg":
        lib.cmcd_logreg_probe.argtypes = [p] * 4 + [i] * 3 + [p] * 3
        lib.cmcd_logreg_probe.restype = ctypes.c_int
    lib.cmcd_error_string.argtypes = [ctypes.c_int]
    lib.cmcd_error_string.restype = ctypes.c_char_p
    lib.cmcd_overdamped_chains_per_block.restype = ctypes.c_int
    lib.cmcd_overdamped_fits.argtypes = [i, i, i, i]
    lib.cmcd_overdamped_fits.restype = ctypes.c_int
    lib.cmcd_overdamped_smem_bytes.argtypes = [i, i, i, i]
    lib.cmcd_overdamped_smem_bytes.restype = ctypes.c_longlong
    if lib.cmcd_overdamped_chains_per_block() != CHAINS_PER_BLOCK:
        raise RuntimeError(f"csrc/{source}.cu and ops/overdamped.py disagree on TC")
    # Every edge of the limits at both instantiated dims: shared memory
    # (228/229 features at dim 2, 224/225 at dim 10; two nets 164/165 and
    # 160/161), threads (256/257) and the target's constants (0, 1, 18, 80,
    # 128, 129 floats).
    for dim in sorted(set(KERNEL_DIMS.values())):
        for in_dim in (0, 1, 3, 18, 58, 132, 160, 161, 164, 165, 224, 225, 228, 229, 256, 257,
                       302):
            for n_par in (0, 1, 18, 80, 128, 129):
                for n_nets in (1, 2):
                    if (bool(lib.cmcd_overdamped_fits(in_dim, n_par, dim, n_nets))
                            != kernel_fits(in_dim, n_par, dim, n_nets)
                            or lib.cmcd_overdamped_smem_bytes(in_dim, n_par, dim, n_nets)
                            != smem_bytes(in_dim, n_par, dim, n_nets)):
                        raise RuntimeError(
                            f"csrc/{source}.cu and ops/overdamped.py disagree on what fits "
                            f"one block at in_dim {in_dim}, {n_par} target floats, dim {dim}, "
                            f"{n_nets} nets"
                        )
    return lib


def checked_data(grad_logp, dev, what):
    """ops/target_grads.kernel_data of a launch's target, its dataset (if it
    has one) checked contiguous f32 on dev: (tensor or None, n_data)."""
    data, n_data = kernel_data(grad_logp)
    if data is not None and (data.device != dev or data.dtype != torch.float32
                             or not data.is_contiguous()):
        raise ValueError(f"{what}: the target's dataset must be contiguous f32 on {dev}")
    return data, n_data


def _f32(t, device):
    return torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()


@torch.no_grad()
def evolve_overdamped_fused(
    z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec: OverdampedSpec,
    *, dim: int, nbridges: int, sn=None, sn2=None, eps_schedule: str = "",
    grad_clipping: bool = False, seed=0, noise=None, return_trajectory: bool = False,
    return_noise: bool = False,
):
    """Run nbridges steps of `spec` (a key of FORMS) for every chain in one launch.

    z0: (N, dim) f32; w0: (N,) f32; betas: (K,); eps: scalar tensor or float;
    vd_mean / vd_logdiag: (dim,); grad_logp: a kernel-form score of
    ops/target_grads (TARGETS) at its KERNEL_DIMS dim; sn: the GeffnerNet or
    a PIS net (None for ULA); sn2: DNF's second net (geffner, the width of
    sn), None for every other spec; seed: int or one-element
    integer tensor (read on the device, so no host sync); noise: optional
    (K, N, dim) standard normals. Returns (z (N, dim), w (N,)); with
    return_trajectory also traj (K + 1, N, dim): row 0 is z0, row K equals z;
    with return_noise also the draws (K, N, dim) the kernel used: its Philox
    normals as it stored them, or the injected tensor itself.
    """
    _check(z0, w0, betas, grad_logp, spec, dim, nbridges, sn, sn2, eps_schedule, noise)
    kwargs = dict(dim=dim, nbridges=nbridges, sn=sn, sn2=sn2, eps_schedule=eps_schedule,
                  grad_clipping=grad_clipping, seed=seed, noise=noise)
    if z0.device.type == "cpu":
        return evolve_overdamped_fused_plain(
            z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec,
            return_trajectory=return_trajectory, return_noise=return_noise, **kwargs
        )
    if z0.device.type != "cuda":
        raise ValueError(f"fused rollout: no kernel for device {z0.device}")
    dev = z0.device
    tensors = [z0, w0, betas, vd_mean, vd_logdiag] + ([noise] if noise is not None else [])
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "fused rollout: z0, w0, betas, vd params and noise must be "
                f"contiguous f32 on {dev}"
            )
    out = _launch(_library(source_for(grad_logp)), z0, w0, betas, eps, vd_mean, vd_logdiag,
                  grad_logp, spec,
                  stored=(return_trajectory, return_noise),
                  stream=torch.cuda.current_stream(dev).cuda_stream, **kwargs)
    count_launch(evolve_overdamped_fused, form_key(spec, grad_logp, sn))
    return out


def logreg_score_probe(grad_logp, x, u):
    """(score(x), H(x) u) of a logistic regression for x, u (N, dim): on
    CUDA tensors through the device functions the kernels inline (a probe
    kernel of csrc/overdamped_logreg.cu that no path launches, for the
    card's check against float64), on the CPU the plain LogregScore."""
    if grad_logp.kernel_name not in LOGREG_TARGETS:
        raise NotImplementedError("logreg score probe: not a logistic regression")
    check_target("logreg score probe", grad_logp, x.shape[1])
    if x.device.type == "cpu":
        return grad_logp(x), grad_logp.hvp(x, u)
    dev = x.device
    code, tpar, _ = kernel_target(grad_logp, dev)
    data, n_data = checked_data(grad_logp, dev, "logreg score probe")
    xc, uc = x.float().contiguous(), u.float().contiguous()
    gt, hv = torch.empty_like(xc), torch.empty_like(xc)
    lib = _library("overdamped_logreg")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.cmcd_logreg_probe(ptr(xc), ptr(uc), ptr(tpar), ptr(data), n_data, x.shape[0],
                                code, ptr(gt), ptr(hv),
                                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"logreg score probe failed: {lib.cmcd_error_string(err).decode()}")
    return gt, hv


def _pack_net(sn, nbridges, dev):
    """ops/nets.pack of a launch's net, its tensors checked f32 on dev."""
    packed = nets.pack(sn, nbridges)
    for t in packed["weights"] + [packed["gate"]]:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"fused rollout: net weights must be f32 on {dev}")
    return packed


def _launch(lib, z0, w0, betas, eps, vd_mean, vd_logdiag, grad_logp, spec, *, dim, nbridges,
            sn, sn2, eps_schedule, grad_clipping, seed, noise, stored, stream):
    """Marshal the arguments and launch the rollout on `stream`: (z, w) and
    the stores asked for (stored: trajectory, noise)."""
    dev = z0.device
    form = FORMS[spec]
    if uses_net(spec):
        packed = _pack_net(sn, nbridges, dev)
        weights, factor = packed["weights"], packed["factor"]
        in_dim, emb_dim, arch, gate = (packed[k] for k in ("in_dim", "emb_dim", "arch", "gate"))
    else:
        factor, weights, in_dim, emb_dim, arch, gate = 0.0, [None] * 7, 0, 0, 0, None
    factor2, weights2 = 0.0, [None] * 7
    if spec.use_sn2_bwd:
        packed2 = _pack_net(sn2, nbridges, dev)
        weights2, factor2 = packed2["weights"], packed2["factor"]
    scal = torch.stack([_f32(eps, dev).reshape(()), _f32(factor, dev).reshape(()),
                        _f32(factor2, dev).reshape(())])
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    code, tpar, inv_var = kernel_target(grad_logp, dev)
    data, n_data = checked_data(grad_logp, dev, "fused rollout")
    vd_inv_var = torch.exp(-2.0 * vd_logdiag).contiguous()
    n = z0.shape[0]
    z_out = torch.empty_like(z0)
    w_out = torch.empty_like(w0)
    return_trajectory, return_noise = stored
    traj = z0.new_empty((nbridges + 1, n, dim)) if return_trajectory else None
    draws = z0.new_empty((nbridges, n, dim)) if return_noise and noise is None else None
    clip_t = spec.clip_target if grad_clipping else None
    clip_q = spec.clip_vd if grad_clipping else None
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    err = lib.cmcd_overdamped_rollout(
        ptr(z0), ptr(w0), ptr(betas), ptr(noise), ptr(scal), ptr(seed_t),
        *(ptr(t) for t in weights),
        ptr(tpar), ptr(vd_mean), ptr(vd_inv_var), ptr(z_out), ptr(w_out),
        ptr(traj), ptr(draws),
        n, nbridges, in_dim, emb_dim, tpar.numel(), EPS_SCHEDULES[eps_schedule], form, code,
        inv_var,
        math.inf if clip_t is None else clip_t,
        math.inf if clip_q is None else clip_q,
        arch, ptr(gate), *(ptr(t) for t in weights2), ptr(data), n_data,
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"overdamped rollout kernel failed: {lib.cmcd_error_string(err).decode()} ({err})")
    out = (z_out, w_out)
    if return_trajectory:
        out += (traj,)
    if return_noise:
        out += (noise if noise is not None else draws,)
    return out


# Launches in all, and by form ("<CAIS|ULA_sn|ULA|DNF>/<target>[/dds|/dds_grad]", form_key).
evolve_overdamped_fused.launches = 0
evolve_overdamped_fused.form_launches = {}
