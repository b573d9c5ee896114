// Fused overdamped CMCD rollout for NVIDIA Hopper (sm_90a), CAIS / CAIS_VAR.
//
// Replaces cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas (the
// TPU kernel "B1") for the specs whose forward and backward kernels both use
// the score net, with the backward net at i + 1 (CAIS, CAIS_VAR), on the
// many_gmm target (dim 2) with the geffner net (two residual softplus layers,
// a head, a per-bridge embedding table and factor_sn). The Python wrapper is
// cmcd_tpu_torch/ops/overdamped.py::evolve_overdamped_fused; its plain
// PyTorch twin evolve_overdamped_fused_plain states the same math step by
// step.
//
// One launch runs all K steps for every chain. Per step, for one chain:
//   eps_i    = eps schedule at i; scale = sqrt(2 eps_i)
//   gradU    = -(beta_i * clip(gt, ct) + (1 - beta_i) * clip(gq, cq)),
//              gq = -(z - vd_mean) * exp(-2 vd_logdiag)
//   fk_mean  = z - eps_i * gradU(gt, z) - eps_i * sn(z, i)
//   z'       = fk_mean + scale * xi
//   gt', sn' = many_gmm score at z', net output at (z', min(i + 1, K - 1))
//   bk_mean  = z' - eps_i * gradU(gt', z') + eps_i * sn'
//   w       += -0.5 * (|(z - bk_mean) / scale|^2 - |xi|^2)
// and (gt', sn') are carried into step i + 1 (the CAIS carry), so each step
// costs one net apply and one score evaluation.
//
// What bounds it on the H100. Per chain-step the net costs about
// 2 x 132^2 FMAs at emb_dim 130 (in_dim 132), the score 40 components with one
// exp each, and the chain state is O(1) bytes: the kernel is bound by
// arithmetic and by on-chip (shared memory) bandwidth, not by device memory.
// N = 2000 chains x K = 256 steps is ~9e9 FMAs.
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
//  * The head and the 40-component score are reductions: one warp per chain,
//    lanes over features or components, warp shuffles to reduce.
//  * Noise is a counter-based Philox4x32-10 keyed by (seed) with counter
//    (chain, step, 0, 0), so a later kernel can regenerate any step's draw;
//    Box-Muller turns two words into the two normals of a step. An injected
//    (K, N, 2) noise array replaces it for exact comparisons.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TC = 8;          // chains per block
constexpr int DIM = 2;         // state dimension (many_gmm)
constexpr int MAX_MIX = 64;    // score components: two per lane
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // 227 KiB a block may use on sm_90

struct RolloutArgs {
  const float* z0;          // (n, 2)
  const float* w0;          // (n,)
  const float* betas;       // (K,)
  const float* noise;       // (K, n, 2) or nullptr: in-kernel Philox
  const float* scal;        // [eps0, factor_sn]
  const long long* seed;    // one int64
  const float* w1z;         // (2, in): rows of layer-1 W (in x out) for z
  const float* c1;          // (K, in): emb_i @ W1[2:] + b1
  const float* emb;         // (K, emb_dim)
  const float* w2;          // (in, in): layer-2 W, row k = input feature k
  const float* b2;          // (in,)
  const float* headw;       // (2, in)
  const float* headb;       // (2,)
  const float* means;       // (n_mix, 2)
  const float* vd_mean;     // (2,)
  const float* vd_inv_var;  // (2,): exp(-2 logdiag)
  float* z_out;             // (n, 2)
  float* w_out;             // (n,)
  int n, nbridges, in_dim, in_pad, emb_dim, n_mix, eps_schedule;
  float inv_var_t, clip_t, clip_q;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dynamic shared memory of one block: W2, the two hidden tiles, the head,
// the means and the per-chain exchange (the layout in overdamped_rollout).
__host__ inline size_t smem_bytes(int in_dim, int n_mix) {
  const int in_pad = round_up(in_dim, 4);
  size_t floats = (size_t)in_pad * in_pad + 2 * TC * in_pad + 2 * in_pad +
                  round_up(2 * n_mix, 4) + 3 * TC * DIM;
  return floats * sizeof(float);
}

// What one block holds: one thread per net feature, two score components
// per lane, and the shared memory above.
__host__ inline bool fits(int in_dim, int n_mix) {
  return in_dim >= 1 && round_up(in_dim, 32) <= MAX_THREADS && n_mix >= 1 &&
         n_mix <= MAX_MIX && smem_bytes(in_dim, n_mix) <= MAX_SMEM;
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// jnp.clip semantics: NaN passes through.
__device__ __forceinline__ float clip_f(float x, float c) {
  return x < -c ? -c : (x > c ? c : x);
}

__device__ __forceinline__ float eps_at(float eps0, int i, int k, int sched) {
  if (sched == 2) {  // cos_sq
    float phase = (float)i / (float)k;
    float c = cosf((phase + 0.008f) / 1.008f * 0.5f * 3.14159265358979f);
    return eps0 * c * c;
  }
  if (sched == 1) return (1e-4f - eps0) / (float)(k - 1) * (float)i + eps0;  // linear
  return eps0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11) on counter c with key (k0, k1).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0], hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2], hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
}

// The two standard normals of (chain, step): Box-Muller on two Philox words.
__device__ __forceinline__ float2 philox_normal2(unsigned long long seed, uint32_t chain,
                                                 uint32_t step) {
  uint32_t c[4] = {chain, step, 0u, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  const float u1 = (float)((c[0] >> 8) + 1u) * (1.0f / 16777216.0f);  // (0, 1]
  const float u2 = (float)(c[1] >> 8) * (1.0f / 16777216.0f);         // [0, 1)
  const float r = sqrtf(-2.0f * logf(u1));
  float s, co;
  sincospif(2.0f * u2, &s, &co);
  return make_float2(r * co, r * s);
}

// Target score and net output at the TC points in zn_s, bridge index idx;
// writes gt_s and sn_s. Every thread of the block must call it.
__device__ __forceinline__ void point_eval(const RolloutArgs& a, int idx, float w1z0,
                                           float w1z1, float b2f, float factor,
                                           const float* w2s, float* h1s, float* h2s,
                                           const float* hws, const float* mus,
                                           const float* zn_s, float* gt_s, float* sn_s) {
  const int tid = threadIdx.x, in = a.in_dim, ip = a.in_pad;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const bool feat = tid < in;

  // Layer 1: h1 = h0 + softplus(z @ W1[:2] + c1[idx]), h0 = [z, emb_idx].
  if (feat) {
    const float cf = a.c1[(size_t)idx * in + tid];
    const float e = tid >= DIM ? a.emb[(size_t)idx * a.emb_dim + tid - DIM] : 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float x0 = zn_s[c * DIM], x1 = zn_s[c * DIM + 1];
      const float pre = fmaf(x1, w1z1, fmaf(x0, w1z0, cf));
      const float h0 = tid == 0 ? x0 : (tid == 1 ? x1 : e);
      h1s[c * ip + tid] = h0 + softplus_f(pre);
    }
  }
  __syncthreads();

  // Layer 2: h2 = h1 + softplus(h1 @ W2 + b2); thread f owns feature f.
  if (feat) {
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[c] = 0.f;
#pragma unroll 2
    for (int k = 0; k < ip; k += 4) {
      const float wa = w2s[(k + 0) * ip + tid];
      const float wb = w2s[(k + 1) * ip + tid];
      const float wc = w2s[(k + 2) * ip + tid];
      const float wd = w2s[(k + 3) * ip + tid];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float4 h = *reinterpret_cast<const float4*>(h1s + c * ip + k);
        acc[c] = fmaf(h.x, wa, acc[c]);
        acc[c] = fmaf(h.y, wb, acc[c]);
        acc[c] = fmaf(h.z, wc, acc[c]);
        acc[c] = fmaf(h.w, wd, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < TC; ++c)
      h2s[c * ip + tid] = h1s[c * ip + tid] + softplus_f(acc[c] + b2f);
  }
  __syncthreads();

  // Head and many_gmm score: one warp per chain.
  for (int c = warp; c < TC; c += nwarp) {
    float s0 = 0.f, s1 = 0.f;
    for (int k = lane; k < in; k += 32) {
      const float h = h2s[c * ip + k];
      s0 = fmaf(h, hws[k], s0);
      s1 = fmaf(h, hws[ip + k], s1);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);

    const float x0 = zn_s[c * DIM], x1 = zn_s[c * DIM + 1];
    float l0 = -INFINITY, l1 = -INFINITY;
    const int j0 = lane, j1 = lane + 32;
    if (j0 < a.n_mix) {
      const float dx = x0 - mus[2 * j0], dy = x1 - mus[2 * j0 + 1];
      l0 = -0.5f * a.inv_var_t * (dx * dx + dy * dy);
    }
    if (j1 < a.n_mix) {
      const float dx = x0 - mus[2 * j1], dy = x1 - mus[2 * j1 + 1];
      l1 = -0.5f * a.inv_var_t * (dx * dx + dy * dy);
    }
    const float m = warp_max(fmaxf(l0, l1));
    const float e0 = j0 < a.n_mix ? expf(l0 - m) : 0.f;
    const float e1 = j1 < a.n_mix ? expf(l1 - m) : 0.f;
    float sum = e0 + e1;
    float a0 = (j0 < a.n_mix ? e0 * mus[2 * j0] : 0.f) + (j1 < a.n_mix ? e1 * mus[2 * j1] : 0.f);
    float a1 = (j0 < a.n_mix ? e0 * mus[2 * j0 + 1] : 0.f) +
               (j1 < a.n_mix ? e1 * mus[2 * j1 + 1] : 0.f);
    sum = warp_sum(sum);
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      sn_s[c * DIM] = (s0 + a.headb[0]) * factor;
      sn_s[c * DIM + 1] = (s1 + a.headb[1]) * factor;
      gt_s[c * DIM] = a.inv_var_t * (a0 / sum - x0);
      gt_s[c * DIM + 1] = a.inv_var_t * (a1 / sum - x1);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS) overdamped_rollout(const RolloutArgs a) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // in_pad x in_pad
  const int ip = a.in_pad, in = a.in_dim, K = a.nbridges;
  float* h1s = w2s + ip * ip;                    // TC x in_pad
  float* h2s = h1s + TC * ip;                    // TC x in_pad
  float* hws = h2s + TC * ip;                    // 2 x in_pad
  float* mus = hws + 2 * ip;                     // n_mix x 2 (padded to 4)
  float* zn_s = mus + round_up(2 * a.n_mix, 4);  // TC x 2
  float* gt_s = zn_s + TC * DIM;                 // TC x 2
  float* sn_s = gt_s + TC * DIM;                 // TC x 2

  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int idx = tid; idx < ip * ip; idx += nthr) {
    const int k = idx / ip, f = idx - k * ip;
    w2s[idx] = (k < in && f < in) ? a.w2[k * in + f] : 0.f;
  }
  for (int idx = tid; idx < 2 * TC * ip; idx += nthr) h1s[idx] = 0.f;  // h1s and h2s
  for (int idx = tid; idx < 2 * ip; idx += nthr) {
    const int j = idx / ip, k = idx - j * ip;
    hws[idx] = k < in ? a.headw[j * in + k] : 0.f;
  }
  for (int idx = tid; idx < 2 * a.n_mix; idx += nthr) mus[idx] = a.means[idx];

  const bool feat = tid < in;
  const float w1z0 = feat ? a.w1z[tid] : 0.f;
  const float w1z1 = feat ? a.w1z[in + tid] : 0.f;
  const float b2f = feat ? a.b2[tid] : 0.f;
  const float eps0 = a.scal[0], factor = a.scal[1];
  const unsigned long long seed = (unsigned long long)a.seed[0];

  // Thread c < TC owns chain blockIdx.x * TC + c and keeps its state in
  // registers; tiles past n run on zeros and store nothing.
  const bool owner = tid < TC;
  const int chain = blockIdx.x * TC + tid;
  const bool live = owner && chain < a.n;
  float z[DIM] = {0.f, 0.f}, gt[DIM] = {0.f, 0.f}, sn[DIM] = {0.f, 0.f};
  float vm[DIM] = {0.f, 0.f}, viv[DIM] = {0.f, 0.f}, w = 0.f;
  if (owner) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      vm[d] = a.vd_mean[d];
      viv[d] = a.vd_inv_var[d];
      if (live) z[d] = a.z0[chain * DIM + d];
      zn_s[tid * DIM + d] = z[d];
    }
    if (live) w = a.w0[chain];
  }
  __syncthreads();

  point_eval(a, 0, w1z0, w1z1, b2f, factor, w2s, h1s, h2s, hws, mus, zn_s, gt_s, sn_s);
  if (owner) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      gt[d] = gt_s[tid * DIM + d];
      sn[d] = sn_s[tid * DIM + d];
    }
  }

  for (int i = 0; i < K; ++i) {
    float eps_i = 0.f, inv_scale = 0.f, beta = 0.f, xi2 = 0.f;
    if (owner) {
      eps_i = eps_at(eps0, i, K, a.eps_schedule);
      const float scale = sqrtf(2.0f * eps_i);
      inv_scale = 1.0f / scale;
      beta = a.betas[i];
      float xi[DIM];
      if (a.noise != nullptr) {
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          xi[d] = live ? a.noise[((size_t)i * a.n + chain) * DIM + d] : 0.f;
      } else {
        const float2 g = philox_normal2(seed, (uint32_t)chain, (uint32_t)i);
        xi[0] = g.x;
        xi[1] = g.y;
      }
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float gq = -(z[d] - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gt[d], a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
        const float fk = (z[d] - eps_i * gu) - eps_i * sn[d];
        zn_s[tid * DIM + d] = fk + scale * xi[d];
        xi2 += xi[d] * xi[d];
      }
    }
    __syncthreads();
    point_eval(a, min(i + 1, K - 1), w1z0, w1z1, b2f, factor, w2s, h1s, h2s, hws, mus, zn_s,
               gt_s, sn_s);
    if (owner) {
      float r2 = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float zn = zn_s[tid * DIM + d];
        const float gtn = gt_s[tid * DIM + d], snn = sn_s[tid * DIM + d];
        const float gq = -(zn - vm[d]) * viv[d];
        const float gu = -(beta * clip_f(gtn, a.clip_t) + (1.0f - beta) * clip_f(gq, a.clip_q));
        const float bk = (zn - eps_i * gu) + eps_i * snn;
        const float r = (z[d] - bk) * inv_scale;
        r2 += r * r;
        z[d] = zn;
        gt[d] = gtn;
        sn[d] = snn;
      }
      w += -0.5f * (r2 - xi2);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.z_out[chain * DIM + d] = z[d];
    a.w_out[chain] = w;
  }
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`. Returns a cudaError_t (0 on success).
int cmcd_overdamped_rollout(const float* z0, const float* w0, const float* betas,
                            const float* noise, const float* scal, const long long* seed,
                            const float* w1z, const float* c1, const float* emb,
                            const float* w2, const float* b2, const float* headw,
                            const float* headb, const float* means, const float* vd_mean,
                            const float* vd_inv_var, float* z_out, float* w_out, int n,
                            int nbridges, int in_dim, int emb_dim, int n_mix, int eps_schedule,
                            float inv_var_t, float clip_t, float clip_q, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (in_dim != DIM + emb_dim || !fits(in_dim, n_mix)) return (int)cudaErrorInvalidValue;
  const int threads = round_up(in_dim, 32);
  const int in_pad = round_up(in_dim, 4);
  const size_t smem = smem_bytes(in_dim, n_mix);
  cudaError_t err = cudaFuncSetAttribute(
      overdamped_rollout, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  RolloutArgs a{z0, w0, betas, noise, scal, seed, w1z, c1, emb, w2, b2, headw, headb, means,
                vd_mean, vd_inv_var, z_out, w_out, n, nbridges, in_dim, in_pad, emb_dim, n_mix,
                eps_schedule, inv_var_t, clip_t, clip_q};
  const int blocks = (n + TC - 1) / TC;
  overdamped_rollout<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_overdamped_chains_per_block() { return TC; }

// The launch's own limits, for the wrapper to check its copy against.
int cmcd_overdamped_fits(int in_dim, int n_mix) { return fits(in_dim, n_mix) ? 1 : 0; }

long long cmcd_overdamped_smem_bytes(int in_dim, int n_mix) {
  return (long long)smem_bytes(in_dim, n_mix);
}

}  // extern "C"
