// The tile form of the wide kernels (csrc/overdamped_wide.cu, the K-step CAIS
// rollout of B1 at LGCP's width): the geffner net's apply, the LGCP score
// and its Hessian product, all for a tile of TBW chains whose vectors are
// D = 1600 and F = D + emb_dim = 1620 floats long. The split KL reverse
// sweep B12 (csrc/kl_split.cu) takes only the net's and the target's
// argument structs, block_sum and dispatch_lgcp from here: it spreads each
// product over the whole grid instead (its header says how).
//
// Why a form of its own. The tile kernels (cmcd_tile.cuh, cmcd_common.cuh)
// keep W2 in shared memory and give each net feature a thread, so their net
// is at most 160 wide and their D a compile-time constant of a few floats.
// At LGCP the net's W1[:D], W2 and head are 1600 x 1620, 1620 x 1620 and
// 1600 x 1620 floats (10.4, 10.5, 10.4 MB) and the score reads a 1600 x 1600
// matrix (Sigma^{-1}, or the Cholesky factor L: 10.2 MB): nothing of that
// fits a block's 227 KB. Here every matrix stays in device memory (41.6 MB,
// which the 50 MB L2 holds across the steps), D and F are run-time values,
// and a chain's vectors live in a global workspace the wrapper allocates.
//
// Work split of one block (THREADS threads, one tile of TBW chains). Every
// matrix-vector product of a step is one pass over its matrix, each element
// loaded once and used for all TBW chains from registers:
//  * stage(): the TBW input vectors into shared memory (TBW x SP floats),
//    where every thread reads them as broadcast float4s;
//  * col_product (out[j] = sum_i v[i] M[i][j], M row-major R x C): thread q
//    walks the columns 4q..4q+3 down the rows with float4 loads, so
//    neighbouring threads read neighbouring addresses. Layers 1 and 2 (W in
//    x out) and L^T in the whitened score;
//  * row_product (out[i] = sum_j M[i][j] v[j]): a warp walks two rows with
//    float4 loads over its lanes and reduces with shuffles. The head,
//    Sigma^{-1} (symmetric in exact arithmetic, read as rows as the JAX
//    kernel reads it) and L.
// A block is alone in reading its matrices, so what bounds it is how many
// bytes each SM keeps in flight from L2: each thread issues eight float4
// loads (col_product) or eight (row_product, four of each row) before it
// uses them. With one scalar load a column and four rows a round, the first
// design streamed 19 GB/s an SM (19.6 ms a rollout at N=20, K=8, the same at
// N=500; NVIDIA H100 80GB HBM3, 700 W, chip_smoke phase 34).
// Each product hands every (chain, output) sum to an epilogue (a lambda)
// that writes the workspace. Between two products the block synchronises;
// elementwise passes walk the workspace with the output index over the
// threads and the chain innermost.
//
// What bounds it. A chain-point costs 2 (D F + F F + D F) + 2 D^2 (4 D^2
// whitened) FLOPs, ~20.8 M at LGCP; a block moves all 41.6 MB of matrices
// from L2 once a point, whatever TBW. So the rollout is FP32-operations-bound
// in principle (3.7 GFLOP at N=20, K=8: 0.056 ms at 67 TFLOP/s) but a block
// streams 374 MB from L2 through one SM over K + 1 points. At N=20 the
// rollout's grid fills 5 of 132 SMs (at N=500, 125): spreading its products
// over several blocks is later work (kl_split.cu does so for the sweep, a
// cooperative grid), as are wgmma, TMA and bf16.

#pragma once

#include "cmcd_common.cuh"

namespace cmcd {
namespace wide {

constexpr int TBW = 4;         // chains of one tile (one block)
constexpr int THREADS = 512;   // threads of one block
constexpr int NWARP = THREADS / 32;
constexpr int RED = 8;         // per-warp slots of a block sum (at most 8 values)

// The geffner net as the wide kernels see it (device pointers, f32): the
// same layout as the tile kernels' NetArgs, with run-time widths.
struct WideNet {
  const float* w1z;    // (D, F): rows of layer-1 W (in x out) for z
  const float* c1;     // (K, F): emb_i @ W1[D:] + b1, formed by the wrapper
  const float* emb;    // (K, E)
  const float* w2;     // (F, F): input x output
  const float* b2;     // (F,)
  const float* headw;  // (D, F)
  const float* headb;  // (D,)
  int f, e;            // F = D + E, E
};

// The LGCP as the wide kernels see it: mat Sigma^{-1} (unwhitened) or L
// (whitened), the bin counts and par = [mu, a] (ops/target_grads.target_floats).
struct WideTarget {
  const float* mat;     // (D, D)
  const float* counts;  // (D,)
  const float* par;     // [mu, a]
};

// Floats of shared memory of one block: the staging rows and the block sums.
__host__ __device__ inline int stage_pitch(int f, int d) { return round_up(f > d ? f : d, 4); }
__host__ inline size_t smem_bytes(int f, int d) {
  return sizeof(float) * ((size_t)TBW * stage_pitch(f, d) + NWARP * RED);
}

// What a launch takes: the geffner net on [z, emb] (f = d + e), row lengths
// a multiple of 4 (the float4 walks) and the shared memory of one block.
__host__ inline bool fits(int f, int d, int e) {
  return d >= 4 && d % 4 == 0 && e >= 0 && f == d + e && f % 4 == 0 &&
         smem_bytes(f, d) <= MAX_SMEM;
}

// One chain's vectors in the workspace: `n` of length d then `m` of length f,
// each padded to a multiple of 4 floats.
__host__ __device__ inline size_t chain_floats(int nd, int nf, int d, int f) {
  return (size_t)nd * round_up(d, 4) + (size_t)nf * round_up(f, 4);
}

// Barrier, then `val(c, k)` for chain c < TBW and k < n into the staging rows
// (pitch sp), then barrier: the products read the rows after it.
template <class V>
__device__ __forceinline__ void stage(float* vs, int sp, int n, V val) {
  __syncthreads();
#pragma unroll
  for (int c = 0; c < TBW; ++c)
    for (int k = threadIdx.x; k < n; k += blockDim.x) vs[c * sp + k] = val(c, k);
  __syncthreads();
}

// out(c, j) = sum_{i < R} vs[c][i] * M[i * C + j] for j < C, handed to
// epi(c, j, sum); R and C multiples of 4. Thread q walks the four columns
// 4q..4q+3 down the rows with float4 loads, eight rows a round: 128 bytes
// of each thread in flight, which is what keeps one SM's stream from L2
// going (a block is alone in reading its matrices a point).
template <class E>
__device__ __forceinline__ void col_product(const float* __restrict__ M, int R, int C,
                                            const float* vs, int sp, E epi) {
  const int c4 = C / 4;
  const float4* __restrict__ m4 = reinterpret_cast<const float4*>(M);
  for (int q = threadIdx.x; q < c4; q += blockDim.x) {
    float4 acc[TBW];
#pragma unroll
    for (int c = 0; c < TBW; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    for (; i + 8 <= R; i += 8) {
      float4 m[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) m[u] = __ldg(m4 + (size_t)(i + u) * c4 + q);
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(vs + c * sp + i);
        const float4 vb = *reinterpret_cast<const float4*>(vs + c * sp + i + 4);
        const float v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[c].x = fmaf(v[u], m[u].x, acc[c].x);
          acc[c].y = fmaf(v[u], m[u].y, acc[c].y);
          acc[c].z = fmaf(v[u], m[u].z, acc[c].z);
          acc[c].w = fmaf(v[u], m[u].w, acc[c].w);
        }
      }
    }
    for (; i < R; i += 4) {
      float4 m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) m[u] = __ldg(m4 + (size_t)(i + u) * c4 + q);
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(vs + c * sp + i);
        const float v[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[c].x = fmaf(v[u], m[u].x, acc[c].x);
          acc[c].y = fmaf(v[u], m[u].y, acc[c].y);
          acc[c].z = fmaf(v[u], m[u].z, acc[c].z);
          acc[c].w = fmaf(v[u], m[u].w, acc[c].w);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < TBW; ++c) {
      epi(c, 4 * q, acc[c].x);
      epi(c, 4 * q + 1, acc[c].y);
      epi(c, 4 * q + 2, acc[c].z);
      epi(c, 4 * q + 3, acc[c].w);
    }
  }
}

// out(c, i) = sum_{j < C} M[i * C + j] * vs[c][j] for i < R, handed to
// epi(c, i, sum) on lane 0 of the row's warp; C a multiple of 4 (rows of M
// 16-byte aligned). A warp walks two rows at once, four float4 loads of each
// in flight a lane, and reduces with shuffles.
template <class E>
__device__ __forceinline__ void row_product(const float* __restrict__ M, int R, int C,
                                            const float* vs, int sp, E epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int c4 = C / 4;
  for (int i0 = warp; i0 < R; i0 += 2 * nwarp) {
    const int i1 = i0 + nwarp;
    const bool two = i1 < R;
    float acc0[TBW], acc1[TBW];
#pragma unroll
    for (int c = 0; c < TBW; ++c) acc0[c] = acc1[c] = 0.f;
    const float4* __restrict__ r0 = reinterpret_cast<const float4*>(M + (size_t)i0 * C);
    const float4* __restrict__ r1 = reinterpret_cast<const float4*>(M + (size_t)(two ? i1 : i0) * C);
    int j4 = lane;
    for (; j4 + 96 < c4; j4 += 128) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = __ldg(r0 + j4 + 32 * u);
        b[u] = __ldg(r1 + j4 + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < TBW; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(vs + c * sp + 4 * (j4 + 32 * u));
          acc0[c] = fmaf(a[u].x, v.x, fmaf(a[u].y, v.y, fmaf(a[u].z, v.z, fmaf(a[u].w, v.w, acc0[c]))));
          acc1[c] = fmaf(b[u].x, v.x, fmaf(b[u].y, v.y, fmaf(b[u].z, v.z, fmaf(b[u].w, v.w, acc1[c]))));
        }
      }
    }
    for (; j4 < c4; j4 += 32) {
      const float4 a = __ldg(r0 + j4), b = __ldg(r1 + j4);
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(vs + c * sp + 4 * j4);
        acc0[c] = fmaf(a.x, v.x, fmaf(a.y, v.y, fmaf(a.z, v.z, fmaf(a.w, v.w, acc0[c]))));
        acc1[c] = fmaf(b.x, v.x, fmaf(b.y, v.y, fmaf(b.z, v.z, fmaf(b.w, v.w, acc1[c]))));
      }
    }
#pragma unroll
    for (int c = 0; c < TBW; ++c) {
      acc0[c] = warp_sum(acc0[c]);
      acc1[c] = warp_sum(acc1[c]);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        epi(c, i0, acc0[c]);
        if (two) epi(c, i1, acc1[c]);
      }
    }
  }
}

// v[q] summed over the block, the same on every thread, in fixed order
// (warps, then the warps' sums in order); NV <= RED. Every thread calls it.
template <int NV>
__device__ __forceinline__ void block_sum(float v[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const float s = warp_sum(v[q]);
    if (lane == 0) red[warp * RED + q] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) s += red[w * RED + q];
    v[q] = s;
  }
  __syncthreads();
}

// A tile's vector: chain c's row of a workspace vector (chain stride cs).
struct Vec {
  float* p;
  size_t cs;
  __device__ float& operator()(int c, int k) const { return p[(size_t)c * cs + k]; }
};

// The LGCP score at the tile's points x into gt, and into ez what its Hessian
// product reads: a e^x (unwhitened) or a e^{L x + mu} (whitened); tmp is
// scratch (d).
//   unwhitened  gt = -Sigma^{-1} (x - mu) + counts - a e^x
//   whitened    gt = -x + L^T (counts - a e^{L x + mu})
template <bool WH>
__device__ __forceinline__ void lgcp_score(const WideTarget& t, int d, float* vs, int sp,
                                           const Vec& x, const Vec& gt, const Vec& ez,
                                           const Vec& tmp) {
  const float mu = t.par[0], a = t.par[1];
  if constexpr (!WH) {
    stage(vs, sp, d, [&](int c, int k) { return x(c, k) - mu; });
    row_product(t.mat, d, d, vs, sp, [&](int c, int i, float s) {
      const float e = a * expf(x(c, i));
      ez(c, i) = e;
      gt(c, i) = -s + t.counts[i] - e;
    });
  } else {
    stage(vs, sp, d, [&](int c, int k) { return x(c, k); });
    row_product(t.mat, d, d, vs, sp, [&](int c, int i, float s) {
      const float e = a * expf(s + mu);
      ez(c, i) = e;
      tmp(c, i) = t.counts[i] - e;
    });
    stage(vs, sp, d, [&](int c, int k) { return tmp(c, k); });
    col_product(t.mat, d, d, vs, sp, [&](int c, int j, float s) { gt(c, j) = -x(c, j) + s; });
  }
}

// The score's Jacobian applied to u (symmetric), added to acc, at the points
// whose ez the score left (tmp scratch):
//   unwhitened  -Sigma^{-1} u - a e^x * u
//   whitened    -u - L^T (a e^{L x + mu} * L u)
template <bool WH>
__device__ __forceinline__ void lgcp_hvp_add(const WideTarget& t, int d, float* vs, int sp,
                                             const Vec& u, const Vec& ez, const Vec& tmp,
                                             const Vec& acc) {
  stage(vs, sp, d, [&](int c, int k) { return u(c, k); });
  if constexpr (!WH) {
    row_product(t.mat, d, d, vs, sp, [&](int c, int i, float s) {
      acc(c, i) += -s - ez(c, i) * u(c, i);
    });
  } else {
    row_product(t.mat, d, d, vs, sp, [&](int c, int i, float s) { tmp(c, i) = ez(c, i) * s; });
    stage(vs, sp, d, [&](int c, int k) { return tmp(c, k); });
    col_product(t.mat, d, d, vs, sp, [&](int c, int j, float s) {
      acc(c, j) += -u(c, j) - s;
    });
  }
}

// The geffner net at the tile's points x, embedding row idx:
//   a1 = x @ W1[:D] + c1[idx],  h1 = [x, emb_idx] + softplus(a1)
//   a2 = h1 @ W2 + b2,          h2 = h1 + softplus(a2)
//   sn = (h2 @ headW^T + headb) * factor
// h1, h2 (f) are scratch; with s1, s2 non-null also sigmoid(a1), sigmoid(a2)
// for the VJP.
__device__ __forceinline__ void net_apply(const WideNet& net, int d, int idx, float factor,
                                          float* vs, int sp, const Vec& x, const Vec& h1,
                                          const Vec& h2, const Vec& sn, const Vec* s1,
                                          const Vec* s2) {
  const int f = net.f;
  const float* c1 = net.c1 + (size_t)idx * f;
  const float* emb = net.emb + (size_t)idx * net.e;
  stage(vs, sp, d, [&](int c, int k) { return x(c, k); });
  col_product(net.w1z, d, f, vs, sp, [&](int c, int j, float s) {
    const float a1 = s + c1[j];
    const float h0 = j < d ? vs[c * sp + j] : emb[j - d];
    h1(c, j) = h0 + softplus_f(a1);
    if (s1 != nullptr) (*s1)(c, j) = sigmoid_f(a1);
  });
  stage(vs, sp, f, [&](int c, int k) { return h1(c, k); });
  col_product(net.w2, f, f, vs, sp, [&](int c, int j, float s) {
    const float a2 = s + net.b2[j];
    h2(c, j) = vs[c * sp + j] + softplus_f(a2);
    if (s2 != nullptr) (*s2)(c, j) = sigmoid_f(a2);
  });
  stage(vs, sp, f, [&](int c, int k) { return h2(c, k); });
  row_product(net.headw, d, f, vs, sp, [&](int c, int i, float s) {
    sn(c, i) = (s + net.headb[i]) * factor;
  });
}

// Calls f(std::bool_constant-like tag) with the whitened flag of target code
// `target` (ops/target_grads.TARGETS: 4 lgcp, 5 lgcp_whitened).
template <bool B>
struct WhTag {
  static constexpr bool value = B;
};

template <class F>
__host__ inline cudaError_t dispatch_lgcp(int target, F f) {
  if (target == 4) return f(WhTag<false>{});
  if (target == 5) return f(WhTag<true>{});
  return cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace cmcd
