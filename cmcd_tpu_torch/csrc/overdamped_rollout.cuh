// The tile form of the overdamped rollout (B1), shared by the sources that
// instantiate it: overdamped.cu (the mixtures, the funnel and the standard
// normal, beside the ULA and DNF forms) and overdamped_logreg.cu (the
// logistic regressions, whose instances compile in a process of their own).
// The kernel's design and the step it takes are in overdamped.cu's header.
// Its definitions have internal linkage (an unnamed namespace): each source
// that includes this header builds a library of its own, with its own copy.

#pragma once

#include "cmcd_common.cuh"

namespace {

using namespace cmcd;

constexpr int MAX_THREADS = 256;

struct RolloutArgs {
  const float* z0;          // (n, D)
  const float* w0;          // (n,)
  const float* betas;       // (K,)
  const float* noise;       // (K, n, D) or nullptr: in-kernel Philox
  const float* scal;        // [eps0, factor_sn, DNF's sn2 factor_sn]
  const long long* seed;    // one int64
  NetArgs net;              // net pointers null for ULA
  NetArgs net2;             // DNF's second net; pointers null for the other forms
  const float* vd_mean;     // (D,)
  const float* vd_inv_var;  // (D,): exp(-2 logdiag)
  float* z_out;             // (n, D)
  float* w_out;             // (n,)
  float* traj;              // (K + 1, n, D) or nullptr: z_0..z_K
  float* noise_out;         // (K, n, D) or nullptr: the Philox draws as used
  int n, nbridges, eps_schedule;
  float clip_t, clip_q;
};

// Dynamic shared memory of one block for a d-dimensional target: W2 and the
// head of each of `nets` nets, the two hidden tiles, the target's constants
// and the per-chain exchange (the layouts in overdamped_rollout and, nets 2
// with no constants, dnf_rollout).
__host__ inline size_t smem_bytes(int in_dim, int n_par, int d, int nets = 1) {
  const int in_pad = round_up(in_dim, 4);
  size_t floats = (size_t)nets * ((size_t)in_pad * in_pad + (size_t)d * in_pad) +
                  2 * TC * in_pad + round_up(n_par, 4) + 3 * TC * d;
  return floats * sizeof(float);
}

// What one block holds: one thread per net feature, the target's constants
// (none read by DNF's two-net form) and the shared memory above.
__host__ inline bool fits(int in_dim, int n_par, int d, int nets = 1) {
  if (nets == 2) n_par = 0;
  return in_dim >= 1 && round_up(in_dim, 32) <= MAX_THREADS &&
         (nets == 2 || (n_par >= 1 && n_par <= MAX_PAR)) &&
         smem_bytes(in_dim, n_par, d, nets) <= MAX_SMEM;
}

// The draws of step i of a chain: injected, or Philox (stored when asked).
template <int D>
__device__ __forceinline__ void draw(const RolloutArgs& a, unsigned long long seed, int chain,
                                     bool live, bool store, int i, float xi[D]) {
  if (a.noise != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = live ? a.noise[((size_t)i * a.n + chain) * D + d] : 0.f;
    return;
  }
  philox_normals<D>(seed, (uint32_t)chain, (uint32_t)i, xi);
  if (live && store && a.noise_out != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.noise_out[((size_t)i * a.n + chain) * D + d] = xi[d];
  }
}

// FWD_SN: the net in the forward mean at (z_i, i), carried from the step
// before; BWD_OFF: the backward net's row offset (1 with FWD_SN, CAIS; 0
// without, ULA_sn); NET: GeffnerNet or PisNet.
template <class T, class NET, bool FWD_SN, int BWD_OFF>
__global__ void __launch_bounds__(MAX_THREADS) overdamped_rollout(const RolloutArgs a) {
  constexpr int D = T::D;
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // in_pad x in_pad
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  float* h1s = w2s + ip * ip;                    // TC x in_pad
  float* h2s = h1s + TC * ip;                    // TC x in_pad
  float* hws = h2s + TC * ip;                    // D x in_pad
  float* par = hws + D * ip;                     // the target's n_par constants
  float* zn_s = par + round_up(net.n_par, 4);    // TC x D
  float* gt_s = zn_s + TC * D;                   // TC x D
  float* sn_s = gt_s + TC * D;                   // TC x D

  const int tid = threadIdx.x, nthr = blockDim.x;
  load_w2(net, w2s, ip);
  for (int idx = tid; idx < 2 * TC * ip; idx += nthr) h1s[idx] = 0.f;  // h1s and h2s
  for (int idx = tid; idx < D * ip; idx += nthr) {
    const int j = idx / ip, k = idx - j * ip;
    hws[idx] = k < in ? net.headw[j * in + k] : 0.f;
  }
  for (int idx = tid; idx < net.n_par; idx += nthr) par[idx] = net.tpar[idx];
  const T target = make_target<T>(par, net);

  const bool feat = tid < in;
  float w1z[D];
  load_w1x<D>(net, tid, w1z);
  const float b2f = feat ? net.b2[tid] : 0.f;
  const float eps0 = a.scal[0], factor = a.scal[1];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  // Thread c < TC owns chain blockIdx.x * TC + c and keeps its state in
  // registers; tiles past n run on zeros and store nothing.
  const bool owner = tid < TC;
  const int chain = blockIdx.x * TC + tid;
  const bool live = owner && chain < a.n;
  float z[D], gt[D], sn[D], vm[D], viv[D], w = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) z[d] = gt[d] = sn[d] = vm[d] = viv[d] = 0.f;
  if (owner) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      vm[d] = a.vd_mean[d];
      viv[d] = a.vd_inv_var[d];
      if (live) z[d] = a.z0[(size_t)chain * D + d];
      zn_s[tid * D + d] = z[d];
      if (live && a.traj != nullptr) a.traj[(size_t)chain * D + d] = z[d];
    }
    if (live) w = a.w0[chain];
  }
  __syncthreads();

  if constexpr (FWD_SN) {
    point_eval<D, T, NET>(net, 0, w1z, b2f, factor, w2s, h1s, h2s, hws, target, zn_s, zn_s,
                          gt_s, sn_s);
  } else {
    score_eval(target, zn_s, gt_s);
  }
  if (owner) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gt[d] = gt_s[tid * D + d];
      if constexpr (FWD_SN) sn[d] = sn_s[tid * D + d];
    }
  }

  for (int i = 0; i < K; ++i) {
    float eps_i = 0.f, inv_scale = 0.f, beta = 0.f, xi2 = 0.f;
    if (owner) {
      eps_i = eps_at(eps0, i, K, a.eps_schedule);
      const float scale = sqrtf(2.0f * eps_i);
      inv_scale = 1.0f / scale;
      beta = a.betas[i];
      float xi[D];
      draw<D>(a, seed, chain, live, true, i, xi);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float gq = -(z[d] - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gt[d], a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
        float fk = z[d] - eps_i * gu;
        if constexpr (FWD_SN) fk = fk - eps_i * sn[d];
        zn_s[tid * D + d] = fk + scale * xi[d];
        xi2 += xi[d] * xi[d];
      }
    }
    __syncthreads();
    point_eval<D, T, NET>(net, NET::row(i + BWD_OFF, K), w1z, b2f, factor, w2s, h1s, h2s, hws,
                          target, zn_s, zn_s, gt_s, sn_s);
    if (owner) {
      float r2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float zn = zn_s[tid * D + d];
        const float gtn = gt_s[tid * D + d], snn = sn_s[tid * D + d];
        const float gq = -(zn - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gtn, a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
        const float bk = (zn - eps_i * gu) + eps_i * snn;
        const float r = (z[d] - bk) * inv_scale;
        r2 += r * r;
        z[d] = zn;
        gt[d] = gtn;
        if constexpr (FWD_SN) sn[d] = snn;
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

template <class T, class NET, bool FWD_SN, int BWD_OFF>
cudaError_t launch_tile(const RolloutArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.net.in_dim, a.net.n_par, T::D);
  cudaError_t err = cudaFuncSetAttribute(overdamped_rollout<T, NET, FWD_SN, BWD_OFF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.n + TC - 1) / TC;
  overdamped_rollout<T, NET, FWD_SN, BWD_OFF>
      <<<blocks, round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
