// Fused UHA (Uncorrected Hamiltonian Annealing) rollout for NVIDIA Hopper
// (sm_90a).
//
// Replaces cmcd_tpu/ops/pallas_uha.py::evolve_uha_pallas (the TPU kernel
// "B8") on the many_gmm and the 3-mode gmm targets (D = 2) and Neal's funnel
// (D = 10); the TPU-only
// time chunking of the stored windows is not ported. The Python wrapper is
// cmcd_tpu_torch/ops/uha.py::evolve_uha_fused; its plain PyTorch version
// evolve_uha_fused_plain states the same math step by step. The targets'
// scores and Philox are cmcd_common.cuh's.
//
// One launch runs all K bridges for every chain. Per bridge i, for one chain
// (E = e^{md}, V = e^{-2 md}, elementwise over the D dimensions):
//   rho     = eta rho + sqrt(1 - eta^2) E xi_{i+1}          (partial refresh)
//   q0      = sum rho^2 V
//   leapfrog, L = lfsteps:
//     rho  -= e gradU(z) / 2;  z += e V rho
//     L - 1 times: rho -= e gradU(z);  z += e V rho
//     rho  -= e gradU(z) / 2
//   w      -= (sum rho^2 V - q0) / 2
// with gradU(x) = -(beta_i gt(x) + (1 - beta_i) gq(x)), gq(x) = -(x - mu)
// e^{-2 logdiag}, no clip, and rho_0 = E xi_0 before the first bridge. The
// weight compares the new momentum with the refreshed one (the Sum(md)
// normalisers cancel). The score at the bridge's last position is carried
// into the next bridge's first half-kick: L score evaluations a bridge.
//
// What bounds it on the H100. Per chain and bridge L scores (40 components,
// or 6 pairs for gmm, each a few warp reductions; the funnel's O(D) sums,
// every lane alike), and O(D) state; the stores are 12 D bytes per chain and
// bridge. Neither operations nor bytes:
// the bound is a few microseconds, and the kernel's time is the latency of
// K * L dependent score evaluations along a chain.
//
// What the design does about it:
//  * One warp per chain, lanes over the mixture's components (two each for
//    many_gmm's 40, one of 6 pairs for gmm), as ScoreLanes in the other
//    kernels: the score is a handful of shuffle reductions, and 2000 chains
//    make 2000 warps, about 15 per SM of 132, to hide each other's latency.
//  * Every lane keeps the chain's state in registers (the same values in
//    all lanes), so no shared memory or barrier is needed after the target's
//    constants are loaded; lane 0 stores.
//  * The target is a template parameter (ManyGmmTarget, Gmm3Target,
//    FunnelTarget), the state dimension its D. Draw j's D normals come from
//    Philox pairs q = 0..D/2 - 1 (dimensions 2q, 2q + 1), the layout of the
//    other kernels (philox_normals).
//  * Noise is Philox4x32-10 keyed by the seed with counter (chain, j, q): j = 0
//    the initial momentum, j = i + 1 the refresh of bridge i (B6's layout).
//    An injected (K + 1, N, D) stack in the same layout replaces it.
//  * KL training needs the path: with store pointers lane 0 also writes
//    z_0..z_K and rho_0..rho_K (each (K + 1, N, D), entry j the state before
//    bridge j) and the draws (K + 1, N, D) that the reverse sweep (kl_uha.cu)
//    reads.
//  * f32 throughout.

#include "cmcd_common.cuh"

namespace {

using namespace cmcd;

constexpr int CPB = 8;              // chains (warps) per block
constexpr int MAX_LFSTEPS = 8;      // the sweep's limit (kl_uha.cu); the rollout keeps it too

struct UhaArgs {
  const float* z0;          // (n, D)
  const float* betas;       // (K,)
  const float* noise;       // (K + 1, n, D) or nullptr: in-kernel Philox
  const float* scal;        // [eps, eta]
  const long long* seed;    // one int64
  const float* md;          // (D,)
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  const float* tpar;        // the target's constants
  float* z_out;             // (n, D)
  float* w_out;             // (n,)
  float* ztraj;             // (K + 1, n, D) or nullptr: z_0..z_K
  float* rtraj;             // (K + 1, n, D) or nullptr: rho_0..rho_K
  float* noise_out;         // (K + 1, n, D) or nullptr: the Philox draws as used
  int n, nbridges, lfsteps, n_par;
  float inv_var;            // many_gmm's 1 / scale^2
};

template <int D>
__device__ __forceinline__ void store_row(float* dst, int row, int n, int chain, const float v[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[((size_t)row * n + chain) * D + d] = v[d];
}

// Draw j of a chain: injected, or Philox (stored by lane 0 when asked).
template <int D>
__device__ __forceinline__ void draw(const UhaArgs& a, unsigned long long seed, int chain, int j,
                                     bool lead, float xi[D]) {
  if (a.noise != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = a.noise[((size_t)j * a.n + chain) * D + d];
    return;
  }
#pragma unroll
  for (int d = 0; d < D; d += 2) {
    const float2 g = philox_normal2(seed, (uint32_t)chain, (uint32_t)j, (uint32_t)(d / 2));
    xi[d] = g.x;
    if (d + 1 < D) xi[d + 1] = g.y;
  }
  if (lead && a.noise_out != nullptr) store_row<D>(a.noise_out, j, a.n, chain, xi);
}

template <class T>
__global__ void __launch_bounds__(CPB * 32) uha_rollout(const UhaArgs a) {
  constexpr int D = T::D;
  __shared__ float par_s[MAX_PAR];
  for (int idx = threadIdx.x; idx < a.n_par; idx += blockDim.x) par_s[idx] = a.tpar[idx];
  __syncthreads();
  const int chain = blockIdx.x * CPB + (threadIdx.x >> 5);
  if (chain >= a.n) return;  // a whole warp: no barrier follows
  const bool lead = (threadIdx.x & 31) == 0;
  const T target(par_s, a.n_par, a.inv_var);
  const unsigned long long seed = (unsigned long long)a.seed[0];
  const float e = a.scal[0], eta = a.scal[1];
  const float sq = sqrtf(1.0f - eta * eta);
  const bool store = a.ztraj != nullptr;

  float em[D], iv[D], vm[D], vq[D], z[D], rho[D], gt[D], xi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    em[d] = expf(a.md[d]);
    iv[d] = expf(-2.0f * a.md[d]);
    vm[d] = a.vd_mean[d];
    vq[d] = expf(-2.0f * a.vd_logdiag[d]);
    z[d] = a.z0[(size_t)chain * D + d];
  }
  draw<D>(a, seed, chain, 0, lead, xi);
#pragma unroll
  for (int d = 0; d < D; ++d) rho[d] = em[d] * xi[d];
  if (lead && store) {
    store_row<D>(a.ztraj, 0, a.n, chain, z);
    store_row<D>(a.rtraj, 0, a.n, chain, rho);
  }
  target.score(z, gt);
  float w = 0.f;

  for (int i = 0; i < a.nbridges; ++i) {
    const float beta = a.betas[i];
    draw<D>(a, seed, chain, i + 1, lead, xi);
    float q0 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      rho[d] = eta * rho[d] + sq * (em[d] * xi[d]);
      q0 += rho[d] * rho[d] * iv[d];
    }
    // gradU(x) = -(beta gt + (1 - beta) gq); `scale` is the kick's e or e / 2.
    auto kick = [&](float scale) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float gq = -(z[d] - vm[d]) * vq[d];
        rho[d] = rho[d] - scale * (-(beta * gt[d] + (1.0f - beta) * gq));
      }
    };
    kick(0.5f * e);
#pragma unroll
    for (int d = 0; d < D; ++d) z[d] = z[d] + e * (rho[d] * iv[d]);
    for (int l = 1; l < a.lfsteps; ++l) {
      target.score(z, gt);
      kick(e);
#pragma unroll
      for (int d = 0; d < D; ++d) z[d] = z[d] + e * (rho[d] * iv[d]);
    }
    target.score(z, gt);
    kick(0.5f * e);
    float q1 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) q1 += rho[d] * rho[d] * iv[d];
    w = w - 0.5f * (q1 - q0);
    if (lead && store) {
      store_row<D>(a.ztraj, i + 1, a.n, chain, z);
      store_row<D>(a.rtraj, i + 1, a.n, chain, rho);
    }
  }
  if (lead) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.z_out[(size_t)chain * D + d] = z[d];
    a.w_out[chain] = w;
  }
}

template <class T>
cudaError_t launch(const UhaArgs& a, cudaStream_t stream) {
  const int blocks = (a.n + CPB - 1) / CPB;
  uha_rollout<T><<<blocks, CPB * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`. target: 0 many_gmm (tpar the n_par / 2
// means, inv_var its 1 / scale^2), 1 the 3-mode gmm (tpar its 18 constants),
// both D = 2; 2 the funnel (tpar its sig), D = 10.
// The three stores are all null or all set (noise_out null where noise is
// injected). Returns a cudaError_t (0 on success).
int cmcd_uha_rollout(const float* z0, const float* betas, const float* noise, const float* scal,
                     const long long* seed, const float* md, const float* vd_mean,
                     const float* vd_logdiag, const float* tpar, float* z_out, float* w_out,
                     float* ztraj, float* rtraj, float* noise_out, int n, int nbridges,
                     int lfsteps, int target, int n_par, float inv_var, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaErrorInvalidValue;
  if (lfsteps < 1 || lfsteps > MAX_LFSTEPS || !target_ok(target, n_par))
    return (int)cudaErrorInvalidValue;
  if ((ztraj == nullptr) != (rtraj == nullptr)) return (int)cudaErrorInvalidValue;
  const UhaArgs a{z0, betas, noise, scal, seed, md, vd_mean, vd_logdiag, tpar, z_out, w_out,
                  ztraj, rtraj, noise_out, n, nbridges, lfsteps, n_par, inv_var};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_target<false>(target, [&](auto tag) {
    return launch<typename decltype(tag)::type>(a, s);
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The launch's own limits, for the wrapper to check its copy against.
int cmcd_uha_chains_per_block() { return CPB; }

int cmcd_uha_max_lfsteps() { return MAX_LFSTEPS; }

int cmcd_uha_max_target_floats() { return MAX_PAR; }

}  // extern "C"
