// What the backward kernels (vargrad.cu, kl.cu, kl_underdamped.cu) share:
// the score net's apply and its hand-written VJP on a tile of chains, the
// per-block partial sums and the kernel that reduces them.
//
// The net's input x is DIN columns wide (the state z, or [z, rho'] for the
// underdamped modes whose net sees the momentum), its head D wide (the
// target's dimension). With out = h2 @ headW^T + headb, sn = out * factor_sn
// and g_out the cotangent of out (the caller's, D per chain):
//   dheadW[d] = g_out[d] h2;  g_h2 = g_out @ headW
//   g_a2 = g_h2 * sigmoid(a2);  db2 = g_a2;  dW2 = h1 (x) g_a2
//   g_h1 = g_h2 + W2 g_a2;  g_a1 = g_h1 * sigmoid(a1);  dW1[:DIN] = x (x) g_a1
//   g_x  = g_h1[:DIN] + W1[:DIN] g_a1      (the identity path counts)
// each summed over the chains a block sees. The embedding half of layer 1
// is a product of the wrapper (c1 = emb @ W1[DIN:] + b1, once per call), so
// its transpose is the wrapper's too: a block returns the per-point sums
// over chains G1[j] = sum_n g_a1 and GH1[j] = sum_n g_h1, from which two
// small products give demb, dW1[DIN:], db1.
//
// The net is a template parameter (cmcd_common.cuh: GeffnerNet, PisNet).
// A PIS net has no identity path (g_h1 = W2 g_a2, g_x = W1[:D] g_a1), gelu'
// in the place of the sigmoids, and its table c1[t] = W1[D:] h_t(t) + b1
// is the wrapper's product as geffner's is: G1[j] is d c1 at point j's row,
// and autograd carries it to the time coder outside the kernel (GH1 is
// summed but unused). dds_grad's gate term g_t[t] * clip(gt(z), 1e2) is
// stop-gradient in z, so it adds nothing to the VJP in z; its table's
// gradient is the per-point sum sum_n g_sn * clip(gt) (D floats, after the
// two betas of len_b).
//
// Work split of one block of NG groups of feature threads on a tile of
// TB = NG * TC chains: thread (g, f) owns feature f for the TC chains of
// group g through the apply and the VJP (activations and sigmoids stay in
// its registers), and column f of dW2 for the g-th share of the rows k in
// the outer product, where it reads h1 transposed as broadcast float4s. W2
// and the block's dW2 sit in shared memory with row stride in_pad + 1 (odd,
// so both the column walk of the apply and the row walk of W2 g_a2 are free
// of bank conflicts). A feature thread keeps its own g_a1 and g_h1 for its TC
// chains and forms g_x one column at a time (at D = 10 the whole TC x DIN
// block of it would be 80 more registers a thread). Blocks run in no order,
// so nothing accumulates across them: each block writes its partial sums to
// scratch and partials_reduce adds them in block order. No atomics: the same inputs give the same bits.

#pragma once

#include "cmcd_common.cuh"

namespace cmcd {

constexpr int FW_MAX = 160;  // feature threads of one group: in_dim <= 160
// Per-warp scalars for a D-dimensional state: eps, vd mean xD, vd logdiag xD,
// factor, headb xD (summed over the block), beta_fk, beta_bk (per point),
// gamma (summed over the block; the underdamped sweep's, zero elsewhere). At
// D = 2 the slots are 0, 1-2, 3-4, 5, 6-7, 8, 9, 10. The scalars of len_a
// are slots 0..HEADB+D-1 and gamma (ops/vargrad.scalar_slots).
__host__ __device__ constexpr int nscal(int d) { return 5 + 3 * d; }      // slots a warp keeps
__host__ __device__ constexpr int nsc_block(int d) { return 3 + 3 * d; }  // scalars of len_a
// A PIS net's warp keeps D more slots after gamma (GATE: the point's sums of
// dds_grad's gate gradient), a geffner net's none: NET::gate_slots(D).
template <int D>
struct Slots {
  static constexpr int EPS = 0, MEAN = 1, LOGDIAG = 1 + D, FACTOR = 1 + 2 * D,
                       HEADB = 2 + 2 * D, BETA = 2 + 3 * D, GAMMA = 4 + 3 * D,
                       GATE = 5 + 3 * D;
  static constexpr int N = nscal(D), BLOCK = nsc_block(D);
};

// Per-feature sums of a thread: headW xD, b2, W1[:DIN] xDIN, G1, GH1.
__host__ __device__ constexpr int nfeat(int d, int din) { return 3 + d + din; }

// Partials summed over every block: dW2 (in x in), dheadW (D x in), db2,
// dW1[:DIN] (DIN x in), then eps, mean xD, logdiag xD, factor, headb xD, gamma.
__host__ __device__ inline int len_a(int in_dim, int d, int din) {
  return in_dim * in_dim + (1 + d + din) * in_dim + nsc_block(d);
}
// Partials of one point: G1 (in), GH1 (in), dbeta_j, dbeta_{j-1}, and the
// `gate` sums of a PIS net (NET::gate_slots(D): D, or 0 for geffner).
__host__ __device__ inline int len_b(int in_dim, int gate = 0) { return 2 * in_dim + 2 + gate; }

// Floats of shared memory the tile itself takes (the layout in Tile), for a
// D-dimensional state and `gate` slots a warp (NET::gate_slots(D)).
__host__ __device__ inline size_t tile_floats(int ng, int in_dim, int n_par, int d,
                                              int gate = 0) {
  const int ip = round_up(in_dim, 4), tb = ng * TC;
  return (size_t)2 * ip * (ip + 1) + 2 * tb * ip + (size_t)ip * (tb + 4) + (size_t)d * ip +
         round_up(n_par, 4) + (nscal(d) + gate) * (ng * FW_MAX / 32);
}

// The tile's shared memory, carved from `base`; `rest` is the first float
// past it, for the kernel's own per-chain buffers.
template <int NG, int D, class NET = GeffnerNet>
struct Tile {
  static constexpr int TB = NG * TC;   // chains per tile
  static constexpr int TBP = TB + 4;   // row stride of the transposed hidden tile
  static constexpr int G = NET::gate_slots(D);  // gate slots a warp
  static constexpr int NS = Slots<D>::N + G;    // slots a warp
  float *w2s, *gw2s, *h1s, *xs, *h1t, *hws, *par, *sc_s, *rest;
  int ws;

  __device__ Tile(float* base, const NetArgs& net) {
    const int ip = net.in_pad;
    ws = ip + 1;
    w2s = base;                                // in_pad x ws
    gw2s = w2s + ip * ws;                      // in_pad x ws: dW2 of this block
    h1s = gw2s + ip * ws;                      // TB x in_pad
    xs = h1s + TB * ip;                        // TB x in_pad: h2, then g_a2
    h1t = xs + TB * ip;                        // in_pad x TBP: h1 transposed
    hws = h1t + ip * TBP;                      // D x in_pad
    par = hws + D * ip;                        // the target's n_par constants
    sc_s = par + round_up(net.n_par, 4);       // warps x NS
    rest = sc_s + NS * (NG * FW_MAX / 32);
  }
};

// A thread's place among the feature threads and the weights it keeps.
template <int D, int DIN>
struct FeatThread {
  int g, f;      // group, feature
  bool feat;     // f < in_dim
  float w1x[DIN > 0 ? DIN : 1], b2f, hw[D];

  __device__ FeatThread(const NetArgs& net, int ng) {
    const int fw = blockDim.x / ng;
    g = threadIdx.x / fw;
    f = threadIdx.x - g * fw;
    feat = f < net.in_dim;
    if constexpr (DIN > 0) load_w1x<DIN>(net, f, w1x);
    b2f = feat ? net.b2[f] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) hw[d] = feat ? net.headw[d * net.in_dim + f] : 0.f;
  }
};

// What a feature thread keeps from the apply for the VJP.
struct FeatRegs {
  float sig1[TC], sig2[TC], h2v[TC];
};

// Fills the tile's constants and zeroes its accumulators; every thread of
// the block calls it, and the block synchronizes before the first use.
template <int NG, int D, class NET>
__device__ __forceinline__ void tile_init(const Tile<NG, D, NET>& t, const NetArgs& net) {
  const int ip = net.in_pad, in = net.in_dim, tid = threadIdx.x, nthr = blockDim.x;
  load_w2(net, t.w2s, t.ws);
  // gw2s, h1s, xs and h1t follow w2s: zero them all (pad columns stay zero).
  for (int i = tid; i < ip * t.ws + 2 * t.TB * ip + ip * t.TBP; i += nthr) t.gw2s[i] = 0.f;
  for (int i = tid; i < D * ip; i += nthr) {
    const int d = i / ip, k = i - d * ip;
    t.hws[i] = k < in ? net.headw[d * in + k] : 0.f;
  }
  for (int i = tid; i < net.n_par; i += nthr) t.par[i] = net.tpar[i];
  for (int i = tid; i < (nthr >> 5) * t.NS; i += nthr) t.sc_s[i] = 0.f;
}

// The net's two layers at the TB inputs in xc_s (TB x DIN), table row idx:
// h1 into h1s and (transposed) h1t, h2 into xs; the activations'
// derivatives and h2 of this thread's feature stay in r. Ends with a barrier.
template <int NG, int D, int DIN, class NET>
__device__ __forceinline__ void tile_layers(const Tile<NG, D, NET>& t, const NetArgs& net,
                                            const FeatThread<D, DIN>& th, int idx,
                                            const float* xc_s, FeatRegs& r) {
  const int ip = net.in_pad, g = th.g, f = th.f;
  float h1v[TC];
  if (th.feat) {
    float a1[TC];
    layer1_feature<DIN, NET>(net, idx, f, th.w1x, xc_s + g * TC * DIN, a1, h1v);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      r.sig1[c] = NET::dact(a1[c]);
      t.h1s[(g * TC + c) * ip + f] = h1v[c];
    }
    float4* col = reinterpret_cast<float4*>(t.h1t + f * t.TBP + g * TC);
    col[0] = make_float4(h1v[0], h1v[1], h1v[2], h1v[3]);
    col[1] = make_float4(h1v[4], h1v[5], h1v[6], h1v[7]);
  }
  __syncthreads();

  if (th.feat) {
    float acc[TC];
    layer2_feature(t.w2s, t.ws, t.h1s + g * TC * ip, ip, f, acc);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float a2 = acc[c] + th.b2f;
      r.sig2[c] = NET::dact(a2);
      if constexpr (NET::RESIDUAL) {
        r.h2v[c] = h1v[c] + softplus_f(a2);
      } else {
        r.h2v[c] = NET::act(a2);
      }
      t.xs[(g * TC + c) * ip + f] = r.h2v[c];
    }
  }
  __syncthreads();
}

// The net's VJP at the tile's inputs xc_s (TB x DIN) from go_s (TB x D),
// the cotangent of the head's raw output per chain: adds this thread's sums
// into ft (dheadW xD, db2, dW1[:DIN] xDIN, G1, GH1) and the tile's dW2 into
// gw2s. With gz_s (warps x TC x DIN) each warp also leaves its share of
// g_x = g_h1[:DIN] + W1[:DIN] g_a1 (PIS: W1[:DIN] g_a1) for its group's
// chains there. Every thread of the block calls it after the block has
// synchronized on go_s; ends with a barrier.
template <int NG, int D, int DIN, class NET>
__device__ __forceinline__ void tile_vjp(const Tile<NG, D, NET>& t, const NetArgs& net,
                                         const FeatThread<D, DIN>& th, const float* xc_s,
                                         const float* go_s, const FeatRegs& r,
                                         float ft[nfeat(D, DIN)], float* gz_s) {
  constexpr int TB = NG * TC;
  const int ip = net.in_pad, in = net.in_dim, g = th.g, f = th.f, ws = t.ws;
  // Head backward and g_a2 = g_h2 * sigmoid(a2); g_a2 replaces h2 in xs.
  float gh2[TC];
  if (th.feat) {
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int cc = g * TC + c;
      const float go0 = go_s[cc * D];
      ft[0] = fmaf(go0, r.h2v[c], ft[0]);
      float gh = go0 * th.hw[0];
#pragma unroll
      for (int d = 1; d < D; ++d) {
        const float god = go_s[cc * D + d];
        ft[d] = fmaf(god, r.h2v[c], ft[d]);
        gh = gh + god * th.hw[d];
      }
      gh2[c] = gh;
      const float ga2 = gh2[c] * r.sig2[c];
      ft[D] += ga2;
      t.xs[cc * ip + f] = ga2;
    }
  }
  __syncthreads();

  // g_h1 and g_a1 of this thread's feature for its group's TC chains (zero
  // for a thread past in_dim).
  float gh1[TC], ga1[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) gh1[c] = ga1[c] = 0.f;
  if (th.feat) {
    // g_h1[c][f] = g_h2[c][f] + sum_k W2[f][k] g_a2[c][k]: row f of W2.
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[c] = 0.f;
    const float* wrow = t.w2s + f * ws;
    const float* gs = t.xs + g * TC * ip;
#pragma unroll 2
    for (int k = 0; k < ip; k += 4) {
      const float wa = wrow[k], wb = wrow[k + 1], wc = wrow[k + 2], wd = wrow[k + 3];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(gs + c * ip + k);
        acc[c] = fmaf(v.x, wa, acc[c]);
        acc[c] = fmaf(v.y, wb, acc[c]);
        acc[c] = fmaf(v.z, wc, acc[c]);
        acc[c] = fmaf(v.w, wd, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int cc = g * TC + c;
      gh1[c] = NET::RESIDUAL ? gh2[c] + acc[c] : acc[c];
      ga1[c] = gh1[c] * r.sig1[c];
#pragma unroll
      for (int d = 0; d < DIN; ++d) ft[D + 1 + d] = fmaf(xc_s[cc * DIN + d], ga1[c], ft[D + 1 + d]);
      ft[D + 1 + DIN] += ga1[c];
      ft[D + 2 + DIN] += gh1[c];
    }
  }
  if (gz_s != nullptr) {  // uniform over the block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 0; d < DIN; ++d) {
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float sd =
            warp_sum(fmaf(ga1[c], th.w1x[d], NET::RESIDUAL && f == d ? gh1[c] : 0.f));
        if (lane == 0) gz_s[(warp * TC + c) * DIN + d] = sd;
      }
    }
  }

  if (th.feat) {
    // dW2[k][f] += sum_c h1[c][k] g_a2[c][f] over all TB chains, for the
    // rows k of this thread's group.
    float ga[TB];
#pragma unroll
    for (int c = 0; c < TB; ++c) ga[c] = t.xs[c * ip + f];
    const int kper = (in + NG - 1) / NG;
    const int k1 = min(in, (g + 1) * kper);
    for (int k = g * kper; k < k1; ++k) {
      float s = t.gw2s[k * ws + f];
      const float4* hk = reinterpret_cast<const float4*>(t.h1t + k * t.TBP);
#pragma unroll
      for (int c4 = 0; c4 < TB / 4; ++c4) {
        const float4 h = hk[c4];
        s = fmaf(h.x, ga[4 * c4], s);
        s = fmaf(h.y, ga[4 * c4 + 1], s);
        s = fmaf(h.z, ga[4 * c4 + 2], s);
        s = fmaf(h.w, ga[4 * c4 + 3], s);
      }
      t.gw2s[k * ws + f] = s;
    }
  }
  __syncthreads();
}

// Column d of one chain's g_x from the shares tile_vjp left in gz_s: the
// warps of the chain's group, in order.
template <int NG, int DIN>
__device__ __forceinline__ float tile_gz(const float* gz_s, int chain_in_tile, int d) {
  const int wpg = (blockDim.x >> 5) / NG;
  const int g = chain_in_tile / TC, c = chain_in_tile - g * TC;
  float s = 0.f;
  for (int w = g * wpg; w < (g + 1) * wpg; ++w) s += gz_s[(w * TC + c) * DIN + d];
  return s;
}

// The per-point partials of this block (G1, GH1, the two beta scalars and a
// PIS net's gate sums) into pb (len_b floats): written, or added to what an
// earlier tile of the same block left there. Zeroes them for the next point.
// Every thread calls it after a barrier; it ends with one.
template <int NG, int D, int DIN, class NET>
__device__ __forceinline__ void flush_point(const Tile<NG, D, NET>& t, const NetArgs& net,
                                            const FeatThread<D, DIN>& th,
                                            float ft[nfeat(D, DIN)], float* pb, bool add) {
  constexpr int NS = Tile<NG, D, NET>::NS, BETA = Slots<D>::BETA, GATE = Slots<D>::GATE;
  constexpr int G = Tile<NG, D, NET>::G;
  const int ip = net.in_pad, in = net.in_dim, tid = threadIdx.x, nthr = blockDim.x;
  const int nwarp = nthr >> 5;
  if (th.feat) {
    t.xs[(th.g * 2) * ip + th.f] = ft[D + 1 + DIN];
    t.xs[(th.g * 2 + 1) * ip + th.f] = ft[D + 2 + DIN];
  }
  ft[D + 1 + DIN] = ft[D + 2 + DIN] = 0.f;
  __syncthreads();
  for (int i = tid; i < 2 * in; i += nthr) {
    const int q = i / in, c = i - q * in;
    float s = 0.f;
    for (int gg = 0; gg < NG; ++gg) s += t.xs[(gg * 2 + q) * ip + c];
    pb[i] = add ? pb[i] + s : s;
  }
  if (tid < 2 + G) {  // the betas, then the gate sums: slots BETA, BETA + 1, GATE..
    const int slot = tid < 2 ? BETA + tid : GATE + tid - 2;
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) {
      s += t.sc_s[w * NS + slot];
      t.sc_s[w * NS + slot] = 0.f;
    }
    pb[2 * in + tid] = add ? pb[2 * in + tid] + s : s;
  }
  __syncthreads();
}

// The partials this block sums over all its points into pa (len_a floats):
// dW2 from shared memory; the per-feature sums across the NG groups and the
// scalars across the warps, in fixed order. The per-feature sums pass
// through xs (TB = NG x TC rows) TC rows a group at a time: at D = 10 there
// are 21 of them a feature. Every thread calls it after a barrier; it ends
// with one.
template <int NG, int D, int DIN, class NET>
__device__ __forceinline__ void flush_block(const Tile<NG, D, NET>& t, const NetArgs& net,
                                            const FeatThread<D, DIN>& th,
                                            const float ft[nfeat(D, DIN)], float* pa) {
  constexpr int NQ = 1 + D + DIN;  // dheadW (D x in), db2, dW1[:DIN] (DIN x in)
  constexpr int NS = Tile<NG, D, NET>::NS, NB = Slots<D>::BLOCK;
  const int ip = net.in_pad, in = net.in_dim, tid = threadIdx.x, nthr = blockDim.x;
  const int nwarp = nthr >> 5;
  for (int i = tid; i < in * in; i += nthr) {
    const int k = i / in, c = i - k * in;
    pa[i] = t.gw2s[k * t.ws + c];
  }
#pragma unroll
  for (int q0 = 0; q0 < NQ; q0 += TC) {
    const int nq = NQ - q0 < TC ? NQ - q0 : TC;
    if (th.feat) {
#pragma unroll
      for (int q = q0; q < q0 + nq; ++q) t.xs[(th.g * TC + q - q0) * ip + th.f] = ft[q];
    }
    __syncthreads();
    for (int i = tid; i < nq * in; i += nthr) {
      const int q = i / in, c = i - q * in;
      float s = 0.f;
      for (int gg = 0; gg < NG; ++gg) s += t.xs[(gg * TC + q) * ip + c];
      pa[in * in + q0 * in + i] = s;
    }
    __syncthreads();
  }
  if (tid < NB) {
    const int slot = tid < NB - 1 ? tid : Slots<D>::GAMMA;
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) s += t.sc_s[w * NS + slot];
    pa[in * in + NQ * in + tid] = s;
  }
  __syncthreads();
}

// Adds the partials in block order: out_a[e] over all blocks, out_b[j][e]
// over the `splits` blocks that saw point j.
__global__ void partials_reduce(const float* part_a, const float* part_b, float* out_a,
                                float* out_b, int nblocks, int la, int npoints, int splits,
                                int lb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < la) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += part_a[(size_t)b * la + e];
    out_a[e] = s;
  } else if (e - la < npoints * lb) {
    const int e2 = e - la, j = e2 / lb, q = e2 - j * lb;
    float s = 0.f;
    for (int t = 0; t < splits; ++t) s += part_b[((size_t)j * splits + t) * lb + q];
    out_b[e2] = s;
  }
}

// Launches partials_reduce for part_a (nblocks, len_a) and part_b (npoints,
// splits, len_b) on `stream`; d, din: the state's and the net input's columns;
// gate: the net's gate sums a point (len_b).
inline cudaError_t launch_reduce(const float* part_a, const float* part_b, float* out_a,
                                 float* out_b, int nblocks, int npoints, int splits,
                                 int in_dim, int d, int din, cudaStream_t stream,
                                 int gate = 0) {
  const int la = len_a(in_dim, d, din), lb = len_b(in_dim, gate), total = la + npoints * lb;
  partials_reduce<<<(total + 255) / 256, 256, 0, stream>>>(part_a, part_b, out_a, out_b,
                                                           nblocks, la, npoints, splits, lb);
  return cudaGetLastError();
}

}  // namespace cmcd
