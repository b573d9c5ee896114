// The wide form of the fused overdamped CMCD rollout for NVIDIA Hopper
// (sm_90a): CAIS (and CAIS_VAR, the same forward) with the geffner net at
// the width of the 1600-D LGCP, whose score is inlined.
//
// Replaces cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas (the
// TPU kernel "B1") where the JAX package runs it at D = 1600
// (cmcd_tpu/ops/fused.py: the LGCP fits its VMEM budget): the training
// rollout with its trajectory and noise stores, and the 30 x 500
// evaluation. The tile form (overdamped.cu) keeps W2 in shared memory and a
// thread per net feature, so it stops at 160-232 features; here the net is
// 1620 wide and the matrices stay in device memory (cmcd_wide.cuh says how a
// block walks them). The Python wrapper is
// cmcd_tpu_torch/ops/overdamped_wide.py::evolve_overdamped_wide; its plain
// twin is the tile form's, evolve_overdamped_fused_plain, which is
// D-generic.
//
// Per step, for one chain (as overdamped.cu):
//   eps_i    = eps schedule at i; scale = sqrt(2 eps_i)
//   gradU    = -(beta_i * clip(gt, ct) + (1 - beta_i) * clip(gq, cq)),
//              gq = -(z - vd_mean) * exp(-2 vd_logdiag)
//   fk_mean  = z - eps_i * gradU(gt, z) - eps_i * sn
//   z'       = fk_mean + scale * xi
//   gt'      = the LGCP score at z'; sn' = the net at (z', min(i + 1, K - 1))
//   bk_mean  = z' - eps_i * gradU(gt', z') + eps_i * sn'
//   w       += -0.5 * (|(z - bk_mean) / scale|^2 - |xi|^2)
// and gt', sn' are carried into step i + 1: one score and one net apply a
// point. Noise is the same Philox4x32-10 stream as every other rollout
// (philox_normal2 at counter (chain, step, pair q) for dimensions 2q and
// 2q + 1), or an injected (K, N, D) array; with a noise pointer the draws are
// stored, with a trajectory pointer z_0..z_K, for the split KL sweep
// (kl_split.cu) to read.
//
// What bounds it and what the design does about it: cmcd_wide.cuh. A block
// holds a tile of TBW chains; their vectors (z, z', gt, gt', sn, sn', the
// hidden layers, scratch) sit in the workspace, and the per-chain sums of
// the log-weight (|xi|^2, |r|^2) are block sums in fixed order.

#include "cmcd_wide.cuh"

namespace {

using namespace cmcd;
using namespace cmcd::wide;

// One chain's workspace: 8 vectors of D (z, z', gt, gt', sn, sn', tmp and
// the score's ez) and 2 of F (h1, h2).
constexpr int ROLL_ND = 8, ROLL_NF = 2;

struct RolloutArgs {
  const float* z0;          // (n, D)
  const float* w0;          // (n,)
  const float* betas;       // (K,)
  const float* noise;       // (K, n, D) or nullptr: in-kernel Philox
  const float* scal;        // [eps0, factor_sn]
  const long long* seed;    // one int64
  WideNet net;
  WideTarget tgt;
  const float* vd_mean;     // (D,)
  const float* vd_inv_var;  // (D,): exp(-2 logdiag)
  float* z_out;             // (n, D)
  float* w_out;             // (n,)
  float* traj;              // (K + 1, n, D) or nullptr: z_0..z_K
  float* noise_out;         // (K, n, D) or nullptr: the Philox draws as used
  float* ws;                // (blocks * TBW, chain_floats(ROLL_ND, ROLL_NF))
  int n, nbridges, d, eps_schedule;
  float clip_t, clip_q;
};

template <bool WH>
__global__ void __launch_bounds__(THREADS) wide_rollout(const RolloutArgs a) {
  extern __shared__ float4 smem4[];
  const int d = a.d, f = a.net.f, K = a.nbridges, sp = stage_pitch(f, d);
  float* vs = reinterpret_cast<float*>(smem4);  // TBW x sp
  float* red = vs + TBW * sp;                   // NWARP x RED
  const int dp = round_up(d, 4), fp = round_up(f, 4);
  const size_t cs = chain_floats(ROLL_ND, ROLL_NF, d, f);
  float* base = a.ws + (size_t)blockIdx.x * TBW * cs;
  Vec z{base, cs}, zn{base + dp, cs}, gt{base + 2 * dp, cs}, gtn{base + 3 * dp, cs};
  Vec sn{base + 4 * dp, cs}, snn{base + 5 * dp, cs}, tmp{base + 6 * dp, cs};
  const Vec ez{base + 7 * dp, cs};
  const Vec h1{base + 8 * dp, cs}, h2{base + 8 * dp + fp, cs};
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int chain0 = blockIdx.x * TBW;
  const float eps0 = a.scal[0], factor = a.scal[1];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  // Chains past n run on zeros and store nothing.
  float w[TBW];
#pragma unroll
  for (int c = 0; c < TBW; ++c) {
    const int chain = chain0 + c;
    const bool live = chain < a.n;
    w[c] = live ? a.w0[chain] : 0.f;
    for (int k = tid; k < d; k += nthr) {
      const float v = live ? a.z0[(size_t)chain * d + k] : 0.f;
      z(c, k) = v;
      if (live && a.traj != nullptr) a.traj[(size_t)chain * d + k] = v;
    }
  }
  lgcp_score<WH>(a.tgt, d, vs, sp, z, gt, ez, tmp);
  net_apply(a.net, d, 0, factor, vs, sp, z, h1, h2, sn, nullptr, nullptr);

  for (int i = 0; i < K; ++i) {
    const float eps_i = eps_at(eps0, i, K, a.eps_schedule);
    const float scale = sqrtf(2.0f * eps_i), inv_scale = 1.0f / scale;
    const float beta = a.betas[i];
    __syncthreads();
    float xi2[TBW];
#pragma unroll
    for (int c = 0; c < TBW; ++c) {
      xi2[c] = 0.f;
      const int chain = chain0 + c;
      const bool live = chain < a.n;
      for (int q = tid; 2 * q < d; q += nthr) {  // the pair of dimensions 2q, 2q + 1
        float2 g = make_float2(0.f, 0.f);
        if (a.noise == nullptr) g = philox_normal2(seed, (uint32_t)chain, (uint32_t)i, (uint32_t)q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * q + h;
          if (k >= d) break;
          float xi = h == 0 ? g.x : g.y;
          const size_t at = ((size_t)i * a.n + chain) * d + k;
          if (a.noise != nullptr) {
            xi = live ? a.noise[at] : 0.f;
          } else if (live && a.noise_out != nullptr) {
            a.noise_out[at] = xi;
          }
          const float zk = z(c, k);
          const float gq = -(zk - a.vd_mean[k]) * a.vd_inv_var[k];
          const float gu = -(beta * clip_f(gt(c, k), a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
          const float fk = (zk - eps_i * gu) - eps_i * sn(c, k);
          zn(c, k) = fk + scale * xi;
          xi2[c] += xi * xi;
        }
      }
    }
    block_sum<TBW>(xi2, red);
    lgcp_score<WH>(a.tgt, d, vs, sp, zn, gtn, ez, tmp);
    net_apply(a.net, d, i + 1 < K ? i + 1 : K - 1, factor, vs, sp, zn, h1, h2, snn, nullptr,
              nullptr);
    __syncthreads();
    float r2[TBW];
#pragma unroll
    for (int c = 0; c < TBW; ++c) {
      r2[c] = 0.f;
      const int chain = chain0 + c;
      const bool live = chain < a.n;
      for (int k = tid; k < d; k += nthr) {
        const float znk = zn(c, k);
        const float gq = -(znk - a.vd_mean[k]) * a.vd_inv_var[k];
        const float gu = -(beta * clip_f(gtn(c, k), a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
        const float bk = (znk - eps_i * gu) + eps_i * snn(c, k);
        const float r = (z(c, k) - bk) * inv_scale;
        r2[c] += r * r;
        if (live && a.traj != nullptr) a.traj[((size_t)(i + 1) * a.n + chain) * d + k] = znk;
      }
    }
    block_sum<TBW>(r2, red);
#pragma unroll
    for (int c = 0; c < TBW; ++c) w[c] += -0.5f * (r2[c] - xi2[c]);
    Vec t = z; z = zn; zn = t;  // the new point is carried: its state, score and net
    t = gt; gt = gtn; gtn = t;
    t = sn; sn = snn; snn = t;
  }

#pragma unroll
  for (int c = 0; c < TBW; ++c) {
    const int chain = chain0 + c;
    if (chain >= a.n) continue;
    for (int k = tid; k < d; k += nthr) a.z_out[(size_t)chain * d + k] = z(c, k);
    if (tid == 0) a.w_out[chain] = w[c];
  }
}

// The inlined LGCP score and Hessian product alone, for a check against
// float64: gt = score(x), hv = H(x) u for every row of x (n a multiple of
// TBW; ez and tmp scratch of x's shape). The rollout and the split sweep run
// these same device functions; no path launches this kernel.
template <bool WH>
__global__ void __launch_bounds__(THREADS) lgcp_score_probe(WideTarget t, const float* x,
                                                            const float* u, float* gt, float* hv,
                                                            float* ez, float* tmp, int d) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);
  const size_t off = (size_t)blockIdx.x * TBW * d;
  const Vec X{const_cast<float*>(x) + off, (size_t)d}, U{const_cast<float*>(u) + off, (size_t)d};
  const Vec G{gt + off, (size_t)d}, H{hv + off, (size_t)d};
  const Vec E{ez + off, (size_t)d}, T{tmp + off, (size_t)d};
  const int sp = stage_pitch(d, d);
  lgcp_score<WH>(t, d, vs, sp, X, G, E, T);
  __syncthreads();
  lgcp_hvp_add<WH>(t, d, vs, sp, U, E, T, H);
}

}  // namespace

extern "C" {

// Launches lgcp_score_probe on `stream`: n rows (a multiple of the tile),
// hv zeroed by the caller. Returns a cudaError_t (0 on success).
int cmcd_wide_score_probe(const float* mat, const float* counts, const float* tpar,
                          const float* x, const float* u, float* gt, float* hv, float* ez,
                          float* tmp, int n, int dim, int target, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n % TBW != 0 || !fits(dim, dim, 0)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dim, dim);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_lgcp(target, [&](auto tag) {
    constexpr bool WH = decltype(tag)::value;
    cudaError_t err = cudaFuncSetAttribute(lgcp_score_probe<WH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    lgcp_score_probe<WH><<<n / TBW, THREADS, smem, s>>>(WideTarget{mat, counts, tpar}, x, u, gt,
                                                        hv, ez, tmp, dim);
    return cudaGetLastError();
  });
}

// Launches the wide rollout on `stream`: target 4 the LGCP (mat its
// precision matrix Sigma^{-1}), 5 the whitened LGCP (mat its Cholesky factor
// L); tpar = [mu, a]; the geffner net on [z, emb] with in_dim = dim + emb_dim;
// ws the workspace (cmcd_wide_ws_floats per chain, for every chain of
// the last tile too). traj and noise_out may be null (nothing stored).
// Returns a cudaError_t (0 on success).
int cmcd_wide_rollout(const float* z0, const float* w0, const float* betas, const float* noise,
                      const float* scal, const long long* seed, const float* w1z,
                      const float* c1, const float* emb, const float* w2, const float* b2,
                      const float* headw, const float* headb, const float* mat,
                      const float* counts, const float* tpar, const float* vd_mean,
                      const float* vd_inv_var, float* z_out, float* w_out, float* traj,
                      float* noise_out, float* ws, int n, int nbridges, int dim, int in_dim,
                      int emb_dim, int eps_schedule, int target, float clip_t, float clip_q,
                      void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (!fits(in_dim, dim, emb_dim)) return (int)cudaErrorInvalidValue;
  const RolloutArgs a{z0, w0, betas, noise, scal, seed,
                      WideNet{w1z, c1, emb, w2, b2, headw, headb, in_dim, emb_dim},
                      WideTarget{mat, counts, tpar}, vd_mean, vd_inv_var, z_out, w_out, traj,
                      noise_out, ws, n, nbridges, dim, eps_schedule, clip_t, clip_q};
  const size_t smem = smem_bytes(in_dim, dim);
  const int blocks = (n + TBW - 1) / TBW;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_lgcp(target, [&](auto tag) {
    constexpr bool WH = decltype(tag)::value;
    cudaError_t err = cudaFuncSetAttribute(wide_rollout<WH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    wide_rollout<WH><<<blocks, THREADS, smem, s>>>(a);
    return cudaGetLastError();
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The layout's constants and formulas, for the wrapper to check its copy.
int cmcd_wide_chains_per_block() { return TBW; }
int cmcd_wide_threads() { return THREADS; }
int cmcd_wide_fits(int in_dim, int dim, int emb_dim) { return fits(in_dim, dim, emb_dim) ? 1 : 0; }
long long cmcd_wide_smem_bytes(int in_dim, int dim) { return (long long)smem_bytes(in_dim, dim); }
long long cmcd_wide_ws_floats(int in_dim, int dim) {
  return (long long)chain_floats(ROLL_ND, ROLL_NF, dim, in_dim);
}

}  // extern "C"
