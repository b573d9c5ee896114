// Fused underdamped (leapfrog) CMCD rollout for NVIDIA Hopper (sm_90a), all
// seven specs of the underdamped family.
//
// Replaces cmcd_tpu/ops/pallas_underdamped.py::evolve_underdamped_pallas
// (the TPU kernel "B6") on the many_gmm and 3-mode gmm targets (D = 2) and
// Neal's funnel (D = 10) with the two-layer geffner net; the TPU-only time
// chunking of the stored windows is not ported. The Python wrapper is
// cmcd_tpu_torch/ops/underdamped.py::evolve_underdamped_fused; its plain
// PyTorch version evolve_underdamped_fused_plain states the same math step
// by step. Net layers, head, targets, schedule and Philox are
// cmcd_common.cuh's.
//
// One launch runs all K steps for every chain. Per step i, for one chain
// (e = eps0, or eps0 cos^2 of the schedule for CAIS_UHA; a = gamma e, or
// gamma eps0 for exact_fwd):
//   refresh   approx:    fk = rho (1 - a),   s_f = s_b = sqrt(2 a)
//             exact:     fk = eta rho,       s_f = s_b = sqrt(1 - eta^2)
//             exact_fwd: fk = exp(-a) rho,   s_f = sqrt(1 - exp(-2a)), s_b = sqrt(2 a)
//             fwd_sn (CAIS_UHA): fk -= 2 a sn([z, rho], i)
//   rho'      = fk + s_f xi_{i+1}
//   leapfrog  rho'' = rho' - e gradU(z) / 2;  z' = z + e rho'';  rho_new = rho'' - e gradU(z') / 2
//             gradU(x) = -(beta_i clip(gt(x), ct) + (1 - beta_i) gq(x)), ct = 1e2 for
//             CAIS_UHA, else none
//   bk        = rho' (1 - a) [eta rho' for exact] + gain sn_b,  gain = 2 a [2 (1 - eta)],
//             sn_b = sn(z, i) (state net), sn([z, rho'], i) (full net) or 0
//   w        += log N(rho; bk, s_b^2) - log N(rho'; fk, s_f^2)
// with -log N(rho_0; 0, I) before the first step and +log N(rho_K; 0, I)
// after the last. The score at z' is carried into step i + 1, where it is
// gt(z_{i+1}) under beta_{i+1}: each step evaluates the target score once.
//
// What bounds it on the H100. Per chain-step one net apply (two for
// CAIS_UHA; none for the plain modes), about in_dim^2 FMAs at in_dim 134, the
// target's score (40 components for many_gmm, O(D) for the funnel), and O(D)
// bytes of chain state: bound by arithmetic and on-chip bandwidth, not by
// device memory.
//
// What the design does about it (B1's design, overdamped.cu):
//  * One launch, chain state in the owner thread's registers, W2 in shared
//    memory for the whole rollout, thread f owns net feature f for the TC
//    chains of a block, one warp per chain for the head and the score.
//  * The target is a template parameter (ManyGmmTarget, Gmm3Target,
//    FunnelTarget); its D sizes every per-chain array.
//  * The net's input is [z, rho'] (DIN = 2 D, full net), z (DIN = D, state
//    net) or nothing (DIN = 0): a template parameter, so the modes without a
//    net carry no net code. The net apply at [z, rho'] and the score at z'
//    share one pass (both points are known once rho' is), so a step costs
//    three barriers.
//  * Layer 1's embedding half (emb_i @ W1[DIN:] + b1) is the wrapper's
//    product, once per call, as in B1.
//  * Noise is Philox4x32-10 keyed by the seed with counter (chain, j, q):
//    j = 0 the initial momentum, j = i + 1 the refresh of step i, pair q
//    dimensions 2q and 2q + 1 (philox_normals). An injected (K + 1, N, D)
//    stack in the same layout replaces it.
//  * KL training needs the path: with store pointers the owner thread also
//    writes z_0..z_K and rho_0..rho_K (each (K + 1, N, D), entry j the state
//    before step j) and the draws (K + 1, N, D) that the reverse sweep
//    (kl_underdamped.cu) reads.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include "cmcd_common.cuh"

namespace {

using namespace cmcd;

constexpr int MAX_THREADS = 256;
constexpr float LOG_2PI_F = 1.8378770664093453f;

struct UdArgs {
  const float* z0;          // (n, D)
  const float* w0;          // (n,)
  const float* betas;       // (K,)
  const float* noise;       // (K + 1, n, D) or nullptr: in-kernel Philox
  const float* scal;        // [eps0, factor_sn, gamma, eta]
  const long long* seed;    // one int64
  NetArgs net;
  const float* vd_mean;     // (D,)
  const float* vd_inv_var;  // (D,): exp(-2 logdiag)
  float* z_out;             // (n, D)
  float* w_out;             // (n,)
  float* ztraj;             // (K + 1, n, D) or nullptr: z_0..z_K
  float* rtraj;             // (K + 1, n, D) or nullptr: rho_0..rho_K
  float* noise_out;         // (K + 1, n, D) or nullptr: the Philox draws as used
  int n, nbridges, refresh, fwd_sn, cais;
  float clip_t;
};

// Dynamic shared memory of one block for a d-dimensional target: W2, the
// two hidden tiles, the d head rows, the target's constants and the
// per-chain exchange (net input [z, rho'] of 2 d, score point, score, net
// output). Without a net (in_dim 0) only the constants and the exchange.
__host__ inline size_t smem_bytes(int in_dim, int n_par, int d) {
  const int in_pad = round_up(in_dim, 4);
  size_t floats = (size_t)in_pad * in_pad + 2 * TC * in_pad + (size_t)d * in_pad +
                  round_up(n_par, 4) + (size_t)TC * 5 * d;
  return floats * sizeof(float);
}

__host__ inline bool fits(int in_dim, int n_par, int d) {
  return in_dim >= 0 && round_up(in_dim, 32) <= MAX_THREADS && n_par >= 1 &&
         n_par <= MAX_PAR && smem_bytes(in_dim, n_par, d) <= MAX_SMEM;
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, size_t row, int n, int chain,
                                          const float v[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[(row * n + chain) * D + d] = v[d];
}

// Draw j of a live chain: injected, or Philox (stored when asked).
template <int D>
__device__ __forceinline__ void draw(const UdArgs& a, unsigned long long seed, int chain,
                                     bool live, int j, float xi[D]) {
  if (a.noise != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = live ? a.noise[((size_t)j * a.n + chain) * D + d] : 0.f;
  } else {
    philox_normals<D>(seed, (uint32_t)chain, (uint32_t)j, xi);
    if (live && a.noise_out != nullptr) store_row<D>(a.noise_out, j, a.n, chain, xi);
  }
}

template <class T, int DIN>
__global__ void __launch_bounds__(MAX_THREADS) underdamped_rollout(const UdArgs a) {
  constexpr int D = T::D, XIN = 2 * D;  // XIN: floats of a chain's net input [z, rho']
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // in_pad x in_pad
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  float* h1s = w2s + ip * ip;                       // TC x in_pad
  float* h2s = h1s + TC * ip;                       // TC x in_pad
  float* hws = h2s + TC * ip;                       // D x in_pad
  float* par = hws + D * ip;                        // the target's constants (padded to 4)
  float* xin_s = par + round_up(net.n_par, 4);      // TC x DIN: the net's input
  float* zn_s = xin_s + TC * XIN;                   // TC x D: where the score is wanted
  float* gt_s = zn_s + TC * D;                      // TC x D
  float* sn_s = gt_s + TC * D;                      // TC x D

  const int tid = threadIdx.x, nthr = blockDim.x;
  float w1x[DIN > 0 ? DIN : 1];
  float b2f = 0.f;
  if constexpr (DIN > 0) {
    load_w2(net, w2s, ip);
    for (int idx = tid; idx < 2 * TC * ip; idx += nthr) h1s[idx] = 0.f;  // h1s and h2s
    for (int idx = tid; idx < D * ip; idx += nthr) {
      const int j = idx / ip, k = idx - j * ip;
      hws[idx] = k < in ? net.headw[j * in + k] : 0.f;
    }
    load_w1x<DIN>(net, tid, w1x);
    b2f = tid < in ? net.b2[tid] : 0.f;
  }
  for (int idx = tid; idx < net.n_par; idx += nthr) par[idx] = net.tpar[idx];
  const T target(par, net.n_par, net.inv_var_t);
  const float eps0 = a.scal[0], factor = a.scal[1], gamma = a.scal[2], eta = a.scal[3];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  // Thread c < TC owns chain blockIdx.x * TC + c; tiles past n run on zeros
  // and store nothing.
  const bool owner = tid < TC;
  const int chain = blockIdx.x * TC + tid;
  const bool live = owner && chain < a.n;
  float z[D], rho[D], gt[D], vm[D], viv[D], wd = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) z[d] = rho[d] = gt[d] = vm[d] = viv[d] = 0.f;
  if (owner) {
    draw<D>(a, seed, chain, live, 0, rho);
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      vm[d] = a.vd_mean[d];
      viv[d] = a.vd_inv_var[d];
      if (live) z[d] = a.z0[(size_t)chain * D + d];
      zn_s[tid * D + d] = z[d];
      r2 += rho[d] * rho[d];
    }
    wd = 0.5f * r2 + 0.5f * (float)D * LOG_2PI_F;  // -log N(rho_0; 0, I)
    if (live && a.ztraj != nullptr) {
      store_row<D>(a.ztraj, 0, a.n, chain, z);
      store_row<D>(a.rtraj, 0, a.n, chain, rho);
    }
  }
  __syncthreads();
  score_eval(target, zn_s, gt_s);
  if (owner) {
#pragma unroll
    for (int d = 0; d < D; ++d) gt[d] = gt_s[tid * D + d];
  }

  for (int i = 0; i < K; ++i) {
    // The step's scalars (uniform over the block) and the owner's draw.
    const float e = a.cais ? eps0 * eps_slope(i, K, 2) : eps0;
    float cf, sf, sb, cb, gain, aux = 0.f;
    if (a.refresh == 1) {  // exact
      cf = eta;
      sf = sqrtf(1.0f - eta * eta);
      sb = sf;
      cb = eta;
      gain = 2.0f * (1.0f - eta);
    } else if (a.refresh == 2) {  // exact_fwd: eta = exp(-gamma eps0)
      aux = gamma * eps0;
      const float ee = expf(-aux);
      cf = ee;
      sf = sqrtf(1.0f - ee * ee);
      sb = sqrtf(2.0f * aux);
      cb = 1.0f - aux;
      gain = 2.0f * aux;
    } else {  // approx
      aux = gamma * e;
      cf = 1.0f - aux;
      sf = sqrtf(2.0f * aux);
      sb = sf;
      cb = cf;
      gain = 2.0f * aux;
    }
    const float beta = a.betas[i];
    float xi[D], fk[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = fk[d] = 0.f;
    if (owner) {
      draw<D>(a, seed, chain, live, i + 1, xi);
#pragma unroll
      for (int d = 0; d < D; ++d) fk[d] = rho[d] * cf;
    }

    // CAIS_UHA: the net in the forward refresh, at [z, rho], row i.
    if constexpr (DIN == XIN) {
      if (a.fwd_sn) {
        if (owner) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            xin_s[tid * XIN + d] = z[d];
            xin_s[tid * XIN + D + d] = rho[d];
          }
        }
        __syncthreads();
        point_eval<DIN>(net, i, w1x, b2f, factor, w2s, h1s, h2s, hws, target, xin_s,
                        (const float*)nullptr, gt_s, sn_s);
        if (owner) {
#pragma unroll
          for (int d = 0; d < D; ++d) fk[d] = fk[d] - 2.0f * aux * sn_s[tid * D + d];
        }
      }
    }

    // Refresh, the first half-kick and the drift; the net's input and the
    // score point of the step's pass.
    float rp[D], rpp[D], xi2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) rp[d] = rpp[d] = 0.f;
    if (owner) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rp[d] = fk[d] + sf * xi[d];
        const float gq = -(z[d] - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gt[d], a.clip_t) + (1.0f - beta) * gq);
        rpp[d] = rp[d] - e * gu / 2.0f;
        zn_s[tid * D + d] = z[d] + e * rpp[d];
        if constexpr (DIN > 0) xin_s[tid * DIN + d] = z[d];
        if constexpr (DIN == XIN) xin_s[tid * XIN + D + d] = rp[d];
        xi2 += xi[d] * xi[d];
      }
    }
    __syncthreads();
    if constexpr (DIN > 0) {
      point_eval<DIN>(net, i, w1x, b2f, factor, w2s, h1s, h2s, hws, target, xin_s, zn_s, gt_s,
                      sn_s);
    } else {
      score_eval(target, zn_s, gt_s);
    }

    // The second half-kick at z' and the step's log-weight increment.
    if (owner) {
      float r2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float zn = zn_s[tid * D + d], gtn = gt_s[tid * D + d];
        const float gq = -(zn - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gtn, a.clip_t) + (1.0f - beta) * gq);
        float bk = rp[d] * cb;
        if constexpr (DIN > 0) bk = bk + gain * sn_s[tid * D + d];
        const float r = (rho[d] - bk) / sb;
        r2 += r * r;
        rho[d] = rpp[d] - e * gu / 2.0f;
        z[d] = zn;
        gt[d] = gtn;
      }
      const float fk_lp = -0.5f * xi2 - (float)D * (0.5f * LOG_2PI_F + logf(sf));
      const float bk_lp = -0.5f * r2 - (float)D * (0.5f * LOG_2PI_F + logf(sb));
      wd = wd + (bk_lp - fk_lp);
      if (live && a.ztraj != nullptr) {
        store_row<D>(a.ztraj, i + 1, a.n, chain, z);
        store_row<D>(a.rtraj, i + 1, a.n, chain, rho);
      }
    }
  }

  if (live) {
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) r2 += rho[d] * rho[d];
    wd = wd - 0.5f * r2 - 0.5f * (float)D * LOG_2PI_F;  // +log N(rho_K; 0, I)
#pragma unroll
    for (int d = 0; d < D; ++d) a.z_out[(size_t)chain * D + d] = z[d];
    a.w_out[chain] = a.w0[chain] + wd;
  }
}

template <class T, int DIN>
cudaError_t launch(const UdArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.net.in_dim, a.net.n_par, T::D);
  cudaError_t err = cudaFuncSetAttribute(underdamped_rollout<T, DIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // One thread per net feature; without a net one warp per chain.
  const int threads = DIN > 0 ? round_up(a.net.in_dim, 32) : TC * 32;
  const int blocks = (a.n + TC - 1) / TC;
  underdamped_rollout<T, DIN><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_din(const UdArgs& a, int din, cudaStream_t stream) {
  constexpr int D = T::D;
  if (din == 2 * D) return launch<T, 2 * D>(a, stream);
  if (din == D) return launch<T, D>(a, stream);
  return launch<T, 0>(a, stream);
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`. din: the net's input columns ahead of
// the embedding (0: no net, in_dim and emb_dim 0 and the weights null; D:
// the state; 2 D: [z, rho']). target: 0 many_gmm (means the n_par / 2
// means, inv_var_t its 1 / scale^2), 1 the 3-mode gmm (its 18 constants),
// both D = 2; 2 the funnel (its sig), D = 10; every array's last axis is the
// target's D. refresh: 0 approx, 1 exact, 2 exact_fwd. The three stores are
// all null or all set. Returns a cudaError_t (0 on success).
int cmcd_underdamped_rollout(const float* z0, const float* w0, const float* betas,
                             const float* noise, const float* scal, const long long* seed,
                             const float* w1x, const float* c1, const float* emb,
                             const float* w2, const float* b2, const float* headw,
                             const float* headb, const float* means, const float* vd_mean,
                             const float* vd_inv_var, float* z_out, float* w_out, float* ztraj,
                             float* rtraj, float* noise_out, int n, int nbridges, int din,
                             int in_dim, int emb_dim, int n_par, int target, int refresh,
                             int fwd_sn, int cais, float inv_var_t, float clip_t, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (target < 0 || target > 2 || !target_ok(target, n_par)) return (int)cudaErrorInvalidValue;
  const int d = target_dim(target);
  if (din != 0 && din != d && din != 2 * d) return (int)cudaErrorInvalidValue;
  if (in_dim != (din > 0 ? din + emb_dim : 0) || !fits(in_dim, n_par, d))
    return (int)cudaErrorInvalidValue;
  if (refresh < 0 || refresh > 2 || (fwd_sn && din != 2 * d)) return (int)cudaErrorInvalidValue;
  if ((ztraj == nullptr) != (rtraj == nullptr)) return (int)cudaErrorInvalidValue;
  const NetArgs net{w1x, c1, emb, w2, b2, headw, headb, means,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t};
  const UdArgs a{z0, w0, betas, noise, scal, seed, net, vd_mean, vd_inv_var, z_out, w_out,
                 ztraj, rtraj, noise_out, n, nbridges, refresh, fwd_sn, cais, clip_t};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_target<false>(target, [&](auto tag) {
    return launch_din<typename decltype(tag)::type>(a, din, s);
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_underdamped_chains_per_block() { return TC; }

// The launch's own limits at state dimension d, for the wrapper to check its
// copy against.
int cmcd_underdamped_fits(int in_dim, int n_par, int d) { return fits(in_dim, n_par, d) ? 1 : 0; }

long long cmcd_underdamped_smem_bytes(int in_dim, int n_par, int d) {
  return (long long)smem_bytes(in_dim, n_par, d);
}

}  // extern "C"
