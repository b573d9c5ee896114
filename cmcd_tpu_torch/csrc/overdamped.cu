// Fused overdamped CMCD rollout for NVIDIA Hopper (sm_90a): CAIS / CAIS_VAR,
// ULA_sn and plain ULA.
//
// Replaces cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas (the
// TPU kernel "B1") on the many_gmm and the 3-mode gmm targets (dim 2), Neal's
// funnel and the standard normal (dim 10), the target a template parameter
// whose D sizes every per-chain array (cmcd_common.cuh), in three forms:
//  * overdamped_rollout<T, true, 1>: the net in both kernels, the backward
//    net at i + 1 (CAIS, CAIS_VAR; the clip constants are the spec's);
//  * overdamped_rollout<T, false, 0>: the net in the backward kernel only, at
//    (z_{i+1}, i) (ULA_sn); step i's forward mean has no net;
//  * ula_rollout<T>: no net at all (ULA), one warp per chain;
//  * dnf_rollout<D>: MCD_DNF, zero drift and two geffner nets: the forward
//    net sn at (z_i, i), the second net sn2 in the backward mean at
//    (z_{i+1}, row(i + 1, K)), each with its own factor (the replaced
//    branch is pallas_overdamped.py:412-422). No score enters the bridge,
//    so the form is instantiated by the state's dimension D (2, 10) and
//    serves every target of that D.
// The score net is a template parameter (cmcd_common.cuh): the geffner net
// (two residual softplus layers, a head, a per-bridge embedding table and
// factor_sn) or a PIS net ("dds", "dds_grad": two gelu layers on [z, h_t],
// the time coder's output a table c1 of K + 1 rows the wrapper forms, the
// output clipped, dds_grad's gate table g_t when its pointer is set; the
// replaced PIS apply is cmcd_tpu/ops/pallas_nets.py::pis_apply_t and
// ::pis_grad_apply_t). The net's table row at the backward net of step i is
// NET::row(i + off, K): geffner clamps it to K - 1, PIS takes K. The
// Python wrapper is
// cmcd_tpu_torch/ops/overdamped.py::evolve_overdamped_fused; its plain
// PyTorch twin evolve_overdamped_fused_plain states the same math step by
// step. The step's pieces (net layers, head, score, schedule, Philox) are
// in cmcd_common.cuh, shared with the other kernels.
//
// One launch runs all K steps for every chain. Per step, for one chain:
//   eps_i    = eps schedule at i; scale = sqrt(2 eps_i)
//   gradU    = -(beta_i * clip(gt, ct) + (1 - beta_i) * clip(gq, cq)),
//              gq = -(z - vd_mean) * exp(-2 vd_logdiag)
//   fk_mean  = z - eps_i * gradU(gt, z) [- eps_i * sn(z, i)]          (CAIS)
//   z'       = fk_mean + scale * xi
//   gt'      = the target's score at z'; sn' = net output at
//              (z', NET::row(i + off, K)), off 1 (CAIS) or 0 (ULA_sn)
//   bk_mean  = z' - eps_i * gradU(gt', z') [+ eps_i * sn']           (CAIS, ULA_sn)
//   w       += -0.5 * (|(z - bk_mean) / scale|^2 - |xi|^2)
// and gt' (and for CAIS sn') is carried into step i + 1, so each step costs
// one score evaluation and, with a net, one net apply. ULA's spec has no
// clip constants: it never clips, under grad_clipping too. DNF's step is
//   fk_mean = z - eps_i * sn(z, i);  z' = fk_mean + scale * xi
//   bk_mean = z' + eps_i * sn2(z', row(i + 1, K))
//   w      += -0.5 * (|(z - bk_mean) / scale|^2 - |xi|^2)
// with nothing to carry: sn at z_{i+1} is the other net's, so a step costs
// two net applies. W2 of both nets (2 x 68 KiB at in_dim 132) sits in shared
// memory beside one pair of hidden tiles, which the two applies take in turn.
//
// What bounds it on the H100. With the net, per chain-step about
// 2 x 132^2 FMAs at emb_dim 130 (in_dim 132), the score 40 components with
// one exp each, and the chain state is O(1) bytes: the kernel is bound by
// arithmetic and by on-chip (shared memory) bandwidth, not by device memory.
// N = 2000 chains x K = 256 steps is ~9e9 FMAs. Without the net (ULA) the
// step is one score, a chain of warp reductions: latency along the chain.
//
// What the design does about it:
//  * The whole rollout runs in one launch; chain state (z, w, the carried
//    score and net output) stays in registers and shared memory; nothing but
//    z0, w0 (and injected noise) is read from device memory per chain.
//  * Layer 1 of the net sees h0 = [z, emb_i]. Its embedding part
//    emb_i @ W1[2:] + b1 is the same for every chain, so the wrapper
//    precomputes it for all K bridges (c1, K x in_dim, one small matrix
//    product per call) and the kernel does only the 2 x in_dim part per
//    chain. That halves the per-chain-step FMAs to ~in_dim^2.
//  * A block owns a tile of TC chains. W2 (in_dim^2 f32, 68 KiB at
//    in_dim 132) sits in dynamic shared memory for the whole rollout.
//    Thread f computes output feature f of layer 2 for all TC chains, so
//    each W2 element read from shared memory feeds TC FMAs and the hidden
//    states are read as broadcast float4s.
//  * The head and the score are reductions: one warp per chain, lanes over
//    features or components, warp shuffles to reduce.
//  * ULA has no net, so no tile: ula_rollout gives each chain a warp (lanes
//    over the target's components, as uha.cu) and keeps the chain's state in
//    every lane's registers, with no barrier in the loop and no shared
//    memory but the target's constants. (A score-only branch of the tile
//    kernel, as underdamped.cu runs its net-free specs, would pay the tile's
//    block barriers and shared exchange every step for nothing.)
//  * Noise is a counter-based Philox4x32-10 keyed by (seed) with counter
//    (chain, step, q, 0), so a later kernel can regenerate any step's draw;
//    Box-Muller turns two words into dimensions 2q and 2q + 1 of a step's
//    draw (philox_normals). An injected (K, N, D) noise array replaces it for
//    exact comparisons. All forms use the same counter: one seed gives every
//    form the same draws.
//  * Training needs the path, not only its end: with a trajectory pointer
//    the kernel also stores z_0..z_K as (K + 1, N, D), 4 D bytes per
//    chain-step, for the VarGrad replay backward (vargrad.cu) to read; with
//    a noise pointer also the Philox draws xi_0..xi_{K-1} as (K, N, D), which
//    the KL reverse sweeps (kl.cu) read beside the path.
//  * The state's D (2 for the mixtures, 10 for the funnel) is the target's,
//    a compile-time constant: an owner thread walks its chain's D-vectors in
//    registers and the block exchanges TC x D floats through shared memory.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.
//  * The tile form overdamped_rollout<T, NET, FWD_SN, BWD_OFF> is defined in
//    overdamped_rollout.cuh, shared with overdamped_logreg.cu, which builds
//    its logistic regression instances in a process of its own.

#include "overdamped_rollout.cuh"

namespace {

using namespace cmcd;

constexpr int ULA_CPB = 8;  // chains (warps) per block of ula_rollout

// Plain ULA: one warp per chain, every lane the chain's state, no barrier in
// the loop; lane 0 stores.
template <class T>
__global__ void __launch_bounds__(ULA_CPB * 32) ula_rollout(const RolloutArgs a) {
  constexpr int D = T::D;
  __shared__ float par_s[MAX_PAR];
  for (int idx = threadIdx.x; idx < a.net.n_par; idx += blockDim.x) par_s[idx] = a.net.tpar[idx];
  __syncthreads();
  const int chain = blockIdx.x * ULA_CPB + (threadIdx.x >> 5);
  if (chain >= a.n) return;  // a whole warp: no barrier follows
  const bool lead = (threadIdx.x & 31) == 0;
  const T target(par_s, a.net.n_par, a.net.inv_var_t);
  const int K = a.nbridges;
  const float eps0 = a.scal[0];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  float z[D], gt[D], vm[D], viv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = a.vd_inv_var[d];
    z[d] = a.z0[(size_t)chain * D + d];
    if (lead && a.traj != nullptr) a.traj[(size_t)chain * D + d] = z[d];
  }
  float w = a.w0[chain];
  target.score(z, gt);

  for (int i = 0; i < K; ++i) {
    const float eps_i = eps_at(eps0, i, K, a.eps_schedule);
    const float scale = sqrtf(2.0f * eps_i), inv_scale = 1.0f / scale;
    const float beta = a.betas[i];
    float xi[D], zn[D], gtn[D], xi2 = 0.f, r2 = 0.f;
    draw<D>(a, seed, chain, true, lead, i, xi);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float gq = -(z[d] - vm[d]) * viv[d];
      const float gu = -(beta * clip_f(gt[d], a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
      zn[d] = (z[d] - eps_i * gu) + scale * xi[d];
      xi2 += xi[d] * xi[d];
    }
    target.score(zn, gtn);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float gq = -(zn[d] - vm[d]) * viv[d];
      const float gu = -(beta * clip_f(gtn[d], a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
      const float r = (z[d] - (zn[d] - eps_i * gu)) * inv_scale;
      r2 += r * r;
      z[d] = zn[d];
      gt[d] = gtn[d];
      if (lead && a.traj != nullptr) a.traj[((size_t)(i + 1) * a.n + chain) * D + d] = z[d];
    }
    w += -0.5f * (r2 - xi2);
  }
  if (lead) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.z_out[(size_t)chain * D + d] = z[d];
    a.w_out[chain] = w;
  }
}

// MCD_DNF: zero drift, the forward net at (z_i, i) and the second net in
// the backward mean at (z_{i+1}, row(i + 1, K)), both geffner nets of one
// width; each step applies both in turn on the block's one pair of hidden
// tiles. Thread c < TC owns chain blockIdx.x * TC + c as in
// overdamped_rollout.
template <int D>
__global__ void __launch_bounds__(MAX_THREADS) dnf_rollout(const RolloutArgs a) {
  using NET = GeffnerNet;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const NetArgs& net2 = a.net2;
  const int ip = net.in_pad, K = a.nbridges;
  float* w2s = reinterpret_cast<float*>(smem4);  // in_pad x in_pad: sn's W2
  float* w2s2 = w2s + ip * ip;                   // in_pad x in_pad: sn2's W2
  float* h1s = w2s2 + ip * ip;                   // TC x in_pad
  float* h2s = h1s + TC * ip;                    // TC x in_pad
  float* hws = h2s + TC * ip;                    // D x in_pad: sn's head rows
  float* hws2 = hws + D * ip;                    // D x in_pad: sn2's head rows
  float* z_s = hws2 + D * ip;                    // TC x D: z_i
  float* zn_s = z_s + TC * D;                    // TC x D: z_{i+1}
  float* sn_s = zn_s + TC * D;                   // TC x D: the last apply's output

  const int tid = threadIdx.x, nthr = blockDim.x, in = net.in_dim;
  load_w2(net, w2s, ip);
  load_w2(net2, w2s2, ip);
  for (int idx = tid; idx < 2 * TC * ip; idx += nthr) h1s[idx] = 0.f;  // h1s and h2s
  for (int idx = tid; idx < D * ip; idx += nthr) {
    const int j = idx / ip, k = idx - j * ip;
    hws[idx] = k < in ? net.headw[j * in + k] : 0.f;
    hws2[idx] = k < in ? net2.headw[j * in + k] : 0.f;
  }
  const NoTarget<D> none{};  // point_eval's target: no score is asked for (zs null)

  const bool feat = tid < in;
  float w1z[D], w1z2[D];
  load_w1x<D>(net, tid, w1z);
  load_w1x<D>(net2, tid, w1z2);
  const float b2f = feat ? net.b2[tid] : 0.f, b2f2 = feat ? net2.b2[tid] : 0.f;
  const float eps0 = a.scal[0], factor = a.scal[1], factor2 = a.scal[2];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  const bool owner = tid < TC;
  const int chain = blockIdx.x * TC + tid;
  const bool live = owner && chain < a.n;
  float z[D], w = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) z[d] = 0.f;
  if (owner) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (live) z[d] = a.z0[(size_t)chain * D + d];
      if (live && a.traj != nullptr) a.traj[(size_t)chain * D + d] = z[d];
    }
    if (live) w = a.w0[chain];
  }

  for (int i = 0; i < K; ++i) {
    if (owner) {
#pragma unroll
      for (int d = 0; d < D; ++d) z_s[tid * D + d] = z[d];
    }
    __syncthreads();
    point_eval<D, NoTarget<D>, NET>(net, i, w1z, b2f, factor, w2s, h1s, h2s, hws, none, z_s,
                                    nullptr, nullptr, sn_s);
    float eps_i = 0.f, inv_scale = 0.f, xi2 = 0.f;
    if (owner) {
      eps_i = eps_at(eps0, i, K, a.eps_schedule);
      const float scale = sqrtf(2.0f * eps_i);
      inv_scale = 1.0f / scale;
      float xi[D];
      draw<D>(a, seed, chain, live, true, i, xi);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        zn_s[tid * D + d] = (z[d] - eps_i * sn_s[tid * D + d]) + scale * xi[d];
        xi2 += xi[d] * xi[d];
      }
    }
    __syncthreads();
    point_eval<D, NoTarget<D>, NET>(net2, NET::row(i + 1, K), w1z2, b2f2, factor2, w2s2, h1s,
                                    h2s, hws2, none, zn_s, nullptr, nullptr, sn_s);
    if (owner) {
      float r2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float zn = zn_s[tid * D + d];
        const float r = (z[d] - (zn + eps_i * sn_s[tid * D + d])) * inv_scale;
        r2 += r * r;
        z[d] = zn;
        if (live && a.traj != nullptr)
          a.traj[((size_t)(i + 1) * a.n + chain) * D + d] = zn;
      }
      w += -0.5f * (r2 - xi2);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.z_out[(size_t)chain * D + d] = z[d];
    a.w_out[chain] = w;
  }
}

template <int D>
cudaError_t launch_dnf(const RolloutArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.net.in_dim, 0, D, 2);
  cudaError_t err = cudaFuncSetAttribute(dnf_rollout<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dnf_rollout<D><<<(a.n + TC - 1) / TC, round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, class NET>
cudaError_t launch_net_form(const RolloutArgs& a, int form, cudaStream_t stream) {
  return form == 0 ? launch_tile<T, NET, true, 1>(a, stream)
                   : launch_tile<T, NET, false, 0>(a, stream);
}

template <class T>
cudaError_t launch_form(const RolloutArgs& a, int form, int arch, cudaStream_t stream) {
  if (form < 2) {
    return dispatch_net(arch, [&](auto tag) {
      return launch_net_form<T, typename decltype(tag)::type>(a, form, stream);
    });
  }
  ula_rollout<T><<<(a.n + ULA_CPB - 1) / ULA_CPB, ULA_CPB * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`. form: 0 CAIS (net in both kernels,
// backward net at i + 1), 1 ULA_sn (net in the backward kernel only, at i),
// 2 ULA (no net: the net pointers may be null, in_dim and emb_dim 0), 3 DNF
// (zero drift; the forward net and, in the w1z2..headb2 pointers, the
// backward mean's second net, both geffner of one width; the target's
// constants are not read, only its D). arch:
// 0 the geffner net (in_dim = D + emb_dim), 1 a PIS net (in_dim its width,
// emb_dim 0, emb null, c1 K + 1 rows; gate the dds_grad gate table (K + 1,
// D), or null for dds).
// target: 0 many_gmm (tpar its n_par / 2 means, inv_var_t its 1 / scale^2),
// 1 the 3-mode gmm (tpar its 18 constants), both 2-D; 2 the funnel (tpar its
// sig), 3 the standard normal (tpar its precision), both 10-D; every
// array's last axis is the target's D. traj and noise_out may be null
// (nothing stored). tdata and n_data: a target's dataset, which none of this
// source's targets reads (overdamped_logreg.cu's entry of the same name takes
// the logistic regressions'). Returns a cudaError_t (0 on success).
int cmcd_overdamped_rollout(const float* z0, const float* w0, const float* betas,
                            const float* noise, const float* scal, const long long* seed,
                            const float* w1z, const float* c1, const float* emb,
                            const float* w2, const float* b2, const float* headw,
                            const float* headb, const float* tpar, const float* vd_mean,
                            const float* vd_inv_var, float* z_out, float* w_out, float* traj,
                            float* noise_out, int n, int nbridges, int in_dim, int emb_dim,
                            int n_par, int eps_schedule, int form, int target, float inv_var_t,
                            float clip_t, float clip_q, int arch, const float* gate,
                            const float* w1z2, const float* c12, const float* emb2,
                            const float* w22, const float* b22, const float* headw2,
                            const float* headb2, const float* tdata, int n_data,
                            void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (form < 0 || form > 3 || !target_ok(target, n_par)) return (int)cudaErrorInvalidValue;
  const int d = target_dim(target);
  const int nets = form == 3 ? 2 : 1;
  if (form != 2 && (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d, nets)))
    return (int)cudaErrorInvalidValue;
  if (form == 3 && (arch != 0 || w1z2 == nullptr || c12 == nullptr || emb2 == nullptr ||
                    w22 == nullptr || b22 == nullptr || headw2 == nullptr || headb2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t, gate};
  const NetArgs net2{w1z2, c12, emb2, w22, b22, headw2, headb2, tpar,
                     in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t, nullptr};
  const RolloutArgs a{z0, w0, betas, noise, scal, seed, net, net2, vd_mean, vd_inv_var, z_out,
                      w_out, traj, noise_out, n, nbridges, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 3) return (int)(d == 2 ? launch_dnf<2>(a, s) : launch_dnf<10>(a, s));
  return (int)dispatch_target(target, [&](auto tag) {
    return launch_form<typename decltype(tag)::type>(a, form, arch, s);
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_overdamped_chains_per_block() { return TC; }

// The launch's own limits at state dimension d with `nets` nets (2: DNF),
// for the wrapper to check its copy against.
int cmcd_overdamped_fits(int in_dim, int n_par, int d, int nets) {
  return fits(in_dim, n_par, d, nets) ? 1 : 0;
}

long long cmcd_overdamped_smem_bytes(int in_dim, int n_par, int d, int nets) {
  return (long long)smem_bytes(in_dim, n_par, d, nets);
}

}  // extern "C"
