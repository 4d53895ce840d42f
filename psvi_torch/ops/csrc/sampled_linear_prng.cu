// Kernel B4: the fused S-sample variational dense op with its noise drawn
// inside the kernels, hand-written for Hopper (sm_90a). Four ops that share
// one generator:
//
//   k_prng_fwd    y[s] = x[s] . W_s^T + b_s
//   k_prng_dx     dx[s] = g[s] . W_s
//   dparam        dmu_w = sum_s P_s, drho_w = sum_s P_s * eps_s * sigmoid(rho_w),
//                 P_s = g[s]^T . x[s], and the bias terms (P_s's column of ones),
//                 in two kernels: k_prng_dparam_partial (P over splits of N)
//                 and k_prng_dparam_reduce (the sum over splits, eps, sigmoid)
//   nkl           nkl[s] = sum over the layer of log p(theta_s) - log q(theta_s), in
//                 two kernels: k_prng_nkl (the terms of a tile of elements for a
//                 group of samples, summed over the tile) and k_prng_nkl_reduce
//                 (the sum over tiles)
//
// with W_s = mu_w + softplus(rho_w) * eps_w[s], b_s = mu_b + softplus(rho_b) *
// eps_b[s]; x (S, N, Din), g (S, N, Dout), mu_w/rho_w (Dout, Din), mu_b/rho_b
// (Dout), all fp32 and row-major. They replace the TPU kernels of
// psvi_tpu/ops/pallas_vi.py: _prng_fwd_kernel (:178, pallas_call at :285 in
// sampled_linear_prng :263), _prng_dx_kernel (:194, call :317 in _prng_bwd_rule
// :307), _prng_dparam_kernel (:207, call :330) and _prng_nkl_kernel (:240, call
// :369 in vi_linear_nkl_prng :362). The plain PyTorch versions with the same
// math are in ../sampled_linear_prng.py.
//
// The noise. The TPU kernels seed the TPU's own generator with (seed, sample);
// those bits cannot be had here. Every kernel below calls philox4x32_10 (the
// counter-based generator of Salmon et al., SC 2011), so eps is a pure function
// of (seed, s, e) and of nothing else:
//   key     = (low 32 bits of the 64-bit seed, high 32 bits)
//   counter = (e, s, 0, 0)
// where s is the sample and e the flat index of the parameter in the layer:
// e = o * Din + i for a weight, Dout * Din + o for a bias. It does not depend on
// the block, the N tile or the launch shape, so the four kernels, however they
// tile, draw one eps. Philox word 0 gives k1 and word 1 gives k2 (their top 23
// bits; words 2 and 3 go unused), and Box-Muller takes JAX's form
// (pallas_vi.py:163-175): u1 = k1 * 2^-23 + 2^-24, u2 = k2 * 2^-23,
// eps = sqrt(-2 ln u1) * cos(2 pi u2), in logf, sqrtf and cosf. The library is
// built without --use_fast_math, so eps stays within a few ulps of the plain
// version. As in JAX the key carries no layer index: the caller gives each
// layer its own seed. psvi_philox_bits writes raw generator words, so that the
// generator can be held against the plain one bit for bit.
//
// Every C entry allocates nothing (dparam's and the NKL's scratch come from
// the caller), launches on the given stream and returns the launch error, or
// 0. There are no atomics: every output is one fixed-order chain of
// operations, so a rerun gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sampled_linear_gemm.cuh"  // cp.async, rows_of_float4, softplus_f, the forward

constexpr int THREADS = 256;
static_assert(THREADS == slgemm::THREADS, "k_prng_dx draws W_s with the forward's cluster helper");
constexpr int PAD = 4;  // keeps shared rows 16-byte aligned and spreads the banks
constexpr int TM = 4;   // register micro-tile side per thread (dx's and dparam's GEMMs)

struct Key {
  unsigned lo, hi;
};

// Philox4x32-10: ten rounds, the key bumped by the Weyl constants between them.
static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, Key k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.lo += 0x9E3779B9u;
      k.hi += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.lo, lo1, hi0 ^ c.w ^ k.hi, lo0);
  }
  return c;
}

// eps(seed, s, e): one Philox call, Box-Muller on its words 0 and 1.
static __device__ __forceinline__ float normal_at(Key k, int s, unsigned e) {
  const uint4 w = philox4x32_10(make_uint4(e, (unsigned)s, 0u, 0u), k);
  const float u1 = (float)(w.x >> 9) * 1.1920928955078125e-7f + 5.9604644775390625e-8f;
  const float u2 = (float)(w.y >> 9) * 1.1920928955078125e-7f;
  return sqrtf(-2.f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}

__global__ void k_philox_bits(const unsigned* __restrict__ ctr, Key k, unsigned* __restrict__ out,
                              int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint4 w = philox4x32_10(make_uint4(ctr[4 * j], ctr[4 * j + 1], ctr[4 * j + 2],
                                           ctr[4 * j + 3]), k);
  out[4 * j] = w.x;
  out[4 * j + 1] = w.y;
  out[4 * j + 2] = w.z;
  out[4 * j + 3] = w.w;
}

// ---------------------------------------------------------------------------
// k_prng_fwd: y[s] = x[s] . W_s^T + b_s with eps drawn in place of read: the
// block and the product loop of sampled_linear_gemm.cuh, which kernel B3
// (sampled_linear.cu) shares.
//
// What bounds it on this card: operations. At fc1 of the LeNet main path
// (S = 10, N = 356, 400 -> 120) the product is 2*S*N*Din*Dout = 0.342 GFLOP,
// run as three TF32 passes on the tensor cores, 2.07 us at 495 TFLOP/s, and
// drawing each eps once is S*(Dout*Din + Dout) normals of about 110 operations,
// 0.053 G, 0.8 us at 67 TFLOP/s fp32: 2.9 us against 7.8 MB of x, y and
// parameters, 2.3 us at 3.35 TB/s. Without eps the bytes are S*Dout*Din*4 =
// 1.9 MB fewer than B3's.
//
// What the design does about it. A block owns (sample, 32 outputs, a split of
// N from _fwd_plan in ../sampled_linear.py) and builds its tile of W_s once
// in shared memory; the n_splits blocks of one (output tile, sample) form a
// thread block cluster that shares the draws, as k_prng_dx's does
// (slgemm::cluster_draw_rows, rows in groups of 4): each eps is drawn once
// for its sample, where a block per (N tile, output tile) would draw it
// ceil(N / 64) times. Each block draws its 32 biases itself. x streams
// through a cp.async ring whose
// first stages are issued before the draws, and the product runs as 3xTF32
// mma.sync on the tensor cores with fp32 accumulation: allowed here, on a
// first-order once_differentiable op, and only on B3 and B4
// (psvi_torch/device.py); it holds the gate of 1e-5 * max|ref| against the
// plain fp32 version, which one TF32 pass does not.
//
// The draws: each eps still costs about 110 dependent operations, so
// building W_s takes longer here than B3's reads of eps (PERF.md).
// W_s[o, i] of sample s: mu_w + softplus(rho_w) * eps, eps drawn here.
static __device__ __forceinline__ float draw_w(const float* mu_w, const float* rho_w, Key key,
                                               int s, int Din, int o, int i) {
  const unsigned idx = (unsigned)o * Din + i;
  return mu_w[idx] + softplus_f(rho_w[idx]) * normal_at(key, s, idx);
}

// The forward's W_s tile: rows in groups of 4, shared over the cluster.
struct DrawW {
  const float* mu_w;
  const float* rho_w;
  Key key;
  int Din, Dout, n_splits;

  __device__ __forceinline__ void operator()(float* ws, int ldw, int s, int k0, int cols,
                                             int rows) const {
    const int o0 = blockIdx.x * slgemm::BO;
    slgemm::cluster_draw_rows(ws, ldw, cols, rows, 4, n_splits, [&](int r, int c) {
      const int o = o0 + r, k = k0 + c;
      return o < Dout && k < Din ? draw_w(mu_w, rho_w, key, s, Din, o, k) : 0.f;
    });
  }
};

struct DrawB {
  const float* mu_b;
  const float* rho_b;
  Key key;
  int Din, Dout;

  __device__ __forceinline__ void operator()(float* bs, int s) const {
    const int r = threadIdx.x, o = blockIdx.x * slgemm::BO + r;
    if (r < slgemm::BO) {
      bs[r] = o < Dout ? mu_b[o] + softplus_f(rho_b[o]) *
                                       normal_at(key, s, (unsigned)Dout * Din + o)
                       : 0.f;
    }
  }
};

__global__ void __launch_bounds__(slgemm::THREADS)
k_prng_fwd(const float* __restrict__ x, const float* __restrict__ mu_w,
           const float* __restrict__ rho_w, const float* __restrict__ mu_b,
           const float* __restrict__ rho_b, float* __restrict__ y, int S, int N, int Din,
           int Dout, int n_splits, int x_vec, Key key) {
  extern __shared__ float4 w_dyn[];
  slgemm::sampled_fwd_block(x, y, reinterpret_cast<float*>(w_dyn), S, N, Din, Dout, n_splits,
                            x_vec != 0, DrawW{mu_w, rho_w, key, Din, Dout, n_splits},
                            DrawB{mu_b, rho_b, key, Din, Dout});
}

// ---------------------------------------------------------------------------
// k_prng_dx: dx[s] = g[s] . W_s. It replaces _prng_dx_kernel
// (psvi_tpu/ops/pallas_vi.py:194, pallas_call at :317).
//
// What bounds it on this card: operations. At fc1 (S = 10, N = 356,
// 400 -> 120) the product is 2*S*N*Din*Dout = 0.342 GFLOP and drawing each
// eps once is S*Dout*Din normals of about 111 operations, 0.054 G: 5.9 us at
// 67 TFLOP/s, against 7.8 MB of g, dx and parameters, 2.3 us at 3.35 TB/s.
//
// What the design does about it. A block owns dx[s, its split of N, 64
// input columns]: the grid is (Din / 64) x n_splits x S, where the plan
// (_dx_plan in ../sampled_linear_prng.py) splits N into runs of whole 64-point
// tiles until the grid reaches one and a half waves of the 132 SMs, each split
// at least 64 points and at most 8 splits. The n_splits blocks of one sample
// and one column tile form a thread block cluster.
//   Phase 1 builds W_s[:, i0 .. i0 + 63] for all Dout rows in each block's
//   dynamic shared memory (Dout * 256 bytes, 30 KB at fc1). The cluster's
//   blocks share the draws (slgemm::cluster_draw_rows, rows in chunks of
//   16): each draws its share of the rows, then copies the others' rows out
//   of their shared memory (distributed shared memory), so each eps is drawn
//   once for its sample, where a block per (sample, N tile) drew it
//   ceil(N / 64) times. Where W_s has fewer 16-row chunks than the cluster
//   has blocks (fc3), each block draws all of it instead.
//   Phase 2 walks the split's N tiles, each through Dout in chunks of 16: the
//   g chunks (64 points x 16 outputs, row-major as g) come through a ring of
//   six stages filled with cp.async, five chunks in flight while one is
//   used, and the first five are issued before phase 1, so their copies
//   overlap the draws; each of the 256 threads accumulates a 4 x 4 register
//   micro-tile against the resident W tile. The generator's registers are
//   free again by then: drawing and the FMA loop share no loop.
// g's chunks go by 16-byte copies when its rows are a multiple of 4 floats
// and 16-byte aligned, else by 4-byte copies (Dout = 10 at fc3). Where Dout * 256 bytes exceed 96 KB (Dout > 384), the block walks
// Dout in chunks of 384 rows, builds each chunk of W_s in turn and adds its
// sum into the dx rows it owns: one block owns them, so the order is fixed.
constexpr int XI = 64;   // input columns a block
constexpr int XN = 64;   // points a tile
constexpr int XK = 16;   // outputs a staged g chunk
constexpr int XW = 384;  // most rows of W_s resident at once: 96 KB
constexpr int XSTAGES = 6;  // g chunks in the ring: five in flight while one is used

// g[s, n0 .. n0 + 63, o0 .. o0 + 15] into dst (row-major, as in g); zero
// past N or past o_end.
static __device__ __forceinline__ void stage_g(float (*dst)[XK + PAD], const float* gg, int n0,
                                               int N, int o0, int o_end, int Dout, bool vec,
                                               int tid) {
  static_assert(XN * XK / 4 == THREADS, "one 16-byte copy a thread");
  if (vec) {
    const int r = tid / (XK / 4), q = tid % (XK / 4), n = n0 + r, o = o0 + 4 * q;
    float* d = &dst[r][4 * q];
    if (n < N && o < o_end) {
      cp_async16(d, gg + (long long)n * Dout + o);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < XN * XK; e += THREADS) {
      const int r = e / XK, kk = e % XK, n = n0 + r, o = o0 + kk;
      if (n < N && o < o_end) {
        cp_async4(&dst[r][kk], gg + (long long)n * Dout + o);
      } else {
        dst[r][kk] = 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
k_prng_dx(const float* __restrict__ g, const float* __restrict__ mu_w,
          const float* __restrict__ rho_w, float* __restrict__ dx, int S, int N, int Din,
          int Dout, int n_splits, int g_vec, Key key) {
  extern __shared__ float4 w_dyn[];
  float* ws = reinterpret_cast<float*>(w_dyn);              // ws[r * XI + c] = W_s[d0 + r, i0 + c]
  __shared__ __align__(16) float gs[XSTAGES][XN][XK + PAD];  // gs[n][o], the cp.async ring
  const int i0 = blockIdx.x * XI, tid = threadIdx.x;
  const int tn = tid / (XI / TM), ti = tid % (XI / TM);
  // this split's N tiles, as _split_bounds(N, n_splits, XN) cuts them
  const int tiles = (N + XN - 1) / XN;
  const int t_begin = (int)((long long)blockIdx.y * tiles / n_splits);
  const int t_end = (int)((long long)(blockIdx.y + 1) * tiles / n_splits);
  float acc[TM][TM];

  for (int s = blockIdx.z; s < S; s += gridDim.z) {
    const float* gg = g + (long long)s * N * Dout;
    float* dxs = dx + (long long)s * N * Din;
    for (int d0 = 0; d0 < Dout; d0 += XW) {
      const int o_end = min(Dout, d0 + XW);
      const int chunks = (o_end - d0 + XK - 1) / XK;
      // step j: N tile t_begin + j / chunks, g chunk j % chunks; the ring
      // runs on across tile boundaries
      const int steps = (t_end - t_begin) * chunks;
      auto stage = [&](int j) {
        stage_g(gs[j % XSTAGES], gg, (t_begin + j / chunks) * XN, N, d0 + (j % chunks) * XK,
                o_end, Dout, g_vec, tid);
      };
      __syncthreads();  // no thread still reads the ring or the previous rows of W_s
      // the first chunks of g are in flight while phase 1 draws
      for (int j = 0; j < XSTAGES - 1; ++j) {
        if (j < steps) stage(j);
        cp_async_commit();
      }
      // phase 1: W_s[d0 .., i0 .. i0 + 63] in chunks of 16 rows, drawn once
      // for the cluster where it has a chunk for each block (else, as fc3's
      // 16 rows, by each block alone); rows past o_end and columns past Din
      // are 0
      slgemm::cluster_draw_rows(ws, XI, XI, chunks * XK, XK, n_splits, [&](int r, int c) {
        const int o = d0 + r, i = i0 + c;
        return o < o_end && i < Din ? draw_w(mu_w, rho_w, key, s, Din, o, i) : 0.f;
      });
      // phase 2
      for (int j = 0; j < steps; ++j) {
        cp_async_wait<XSTAGES - 2>();
        __syncthreads();  // chunk j has landed, W_s is written, step j - 1's stage is free
        if (j + XSTAGES - 1 < steps) stage(j + XSTAGES - 1);
        cp_async_commit();
        const int st = j % XSTAGES, n0 = (t_begin + j / chunks) * XN, c = j % chunks;
        if (c == 0) {  // a new tile: 0, or the sum of the earlier Dout chunks
#pragma unroll
          for (int a = 0; a < TM; ++a) {
            const int n = n0 + tn * TM + a;
#pragma unroll
            for (int b = 0; b < TM; ++b) {
              const int i = i0 + ti * TM + b;
              acc[a][b] = (d0 > 0 && n < N && i < Din) ? dxs[(long long)n * Din + i] : 0.f;
            }
          }
        }
        const float* wc = ws + c * XK * XI + ti * TM;
#pragma unroll
        for (int k4 = 0; k4 < XK; k4 += 4) {
          float gv[TM][4];
#pragma unroll
          for (int a = 0; a < TM; ++a) {
            const float4 v = *reinterpret_cast<const float4*>(&gs[st][tn * TM + a][k4]);
            gv[a][0] = v.x;
            gv[a][1] = v.y;
            gv[a][2] = v.z;
            gv[a][3] = v.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(wc + (k4 + kk) * XI);
            const float wv[TM] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int a = 0; a < TM; ++a)
#pragma unroll
              for (int b = 0; b < TM; ++b) acc[a][b] = fmaf(gv[a][kk], wv[b], acc[a][b]);
          }
        }
        if (c == chunks - 1) {
#pragma unroll
          for (int a = 0; a < TM; ++a) {
            const int n = n0 + tn * TM + a;
            if (n >= N) continue;
#pragma unroll
            for (int b = 0; b < TM; ++b) {
              const int i = i0 + ti * TM + b;
              if (i < Din) dxs[(long long)n * Din + i] = acc[a][b];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dparam in two kernels. It replaces _prng_dparam_kernel
// (psvi_tpu/ops/pallas_vi.py:207, pallas_call at :330). On the TPU the grid
// runs in order and the kernel adds each (sample, N tile) into its outputs
// (pallas_vi.py:225-237); Hopper's blocks run in no order, so the sum over
// S and N is split across blocks and finished by a second, fixed-order pass.
// Column Din is the bias: its activation is 1, so P_s[o, Din] = sum_n g[s,n,o].
//
// What bounds it on this card: operations, the same 2*S*N*Din*Dout product as
// the forward (0.342 GFLOP at fc1) plus S*(Dout*Din + Dout) normals, each
// drawn once (0.055 G): 5.9 us at 67 TFLOP/s, against 7.8 MB of g, x and
// parameters, 2.3 us at 3.35 TB/s.
//
// What the design does about it. One block walking all of S*N for its output
// tile is latency: 52 blocks at fc1, 3 at fc3, each through S*N/32 chunks.
//   k_prng_dparam_partial: a batched partial product, no eps. The grid is
//   (Din + 1) / 64 x Dout / 64 x S * n_splits; the plan (_dparam_plan in
//   ../sampled_linear_prng.py) splits N evenly until the grid covers the 132
//   SMs and no split walks more than 256 points, each split at least 32
//   points. A block takes B3's proven shape: a
//   64 x 64 tile of P over one split of one sample, 256 threads, 4 x 4
//   register micro-tiles; the 16-point chunks of g and x come through a ring
//   of five stages filled with cp.async, four chunks (32 KB) in flight while
//   one is used: with about one block an SM, one chunk in flight (8 KB) left
//   each chunk waiting out device memory's latency. 16-byte copies where a
//   row is a multiple of 4 floats and 16-byte aligned, 4-byte copies else (g
//   at Dout = 10). It writes P to part[s][k][o][i], i <= Din (3.8 MB at fc1,
//   in L2).
//   k_prng_dparam_reduce: one thread an output e, neighbours on neighbouring
//   e (coalesced), in a fixed order: for each s, P = sum over the splits k,
//   dmu += P, drho += P * eps(s, e); then sigmoid(rho). Each eps is drawn
//   once for each (s, e), as before, four samples' draws side by side.
// No TF32 and no tensor cores: the gate is 1e-5 * max |ref| in true fp32, and
// TF32 keeps about three digits; the fp32 bound at fc1 is already 2.4 times
// under torch.bmm's time. A 3xTF32 mma.sync pass 1 is a later PR's choice.
constexpr int DT = 64;  // outputs o and inputs i a block (pass 1)
constexpr int DK = 16;  // points a staged chunk
constexpr int DSTAGES = 5;  // chunks in the ring: four in flight while one is used

// Rows [n, n + 16) (up to n_end) of a (rows, D) matrix, columns [c0, c0 + 64),
// into dst; column `one` (the bias column, or -1) is 1 on a row in range,
// every other entry outside the matrix or the split is 0.
static __device__ __forceinline__ void stage_rows(float (*dst)[DT + PAD], const float* src, int n,
                                                  int n_end, int D, int c0, int one, bool vec,
                                                  int tid) {
  static_assert(DK * DT / 4 == THREADS, "one 16-byte copy a thread");
  if (vec) {  // D % 4 == 0, so a 4-float group lies inside [0, D) or outside it
    const int kk = tid / (DT / 4), q = tid % (DT / 4), r = n + kk, c = c0 + 4 * q;
    float* d = &dst[kk][4 * q];
    if (r < n_end && c < D) {
      cp_async16(d, src + (long long)r * D + c);
    } else {
      const float v = (r < n_end && c == one) ? 1.f : 0.f;
      *reinterpret_cast<float4*>(d) = make_float4(v, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < DK * DT; e += THREADS) {
      const int kk = e / DT, cc = e % DT, r = n + kk, c = c0 + cc;
      if (r < n_end && c < D) {
        cp_async4(&dst[kk][cc], src + (long long)r * D + c);
      } else {
        dst[kk][cc] = (r < n_end && c == one) ? 1.f : 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
k_prng_dparam_partial(const float* __restrict__ g, const float* __restrict__ x,
                      float* __restrict__ part, int S, int N, int Din, int Dout, int n_splits,
                      int g_vec, int x_vec) {
  __shared__ __align__(16) float gs[DSTAGES][DK][DT + PAD];  // gs[n][o]
  __shared__ __align__(16) float xs[DSTAGES][DK][DT + PAD];  // xs[n][i], 1 in column Din
  const int i0 = blockIdx.x * DT, o0 = blockIdx.y * DT, tid = threadIdx.x;
  const int to = tid / (DT / TM), ti = tid % (DT / TM);
  const long long E1 = (long long)Dout * (Din + 1);
  for (int z = blockIdx.z; z < S * n_splits; z += gridDim.z) {
    // split k of sample s, as _split_bounds(N, n_splits) cuts it
    const int s = z / n_splits, k = z % n_splits;
    const int n_begin = (int)((long long)k * N / n_splits);
    const int n_end = (int)((long long)(k + 1) * N / n_splits);
    const float* gg = g + (long long)s * N * Dout;
    const float* xg = x + (long long)s * N * Din;
    const int chunks = (n_end - n_begin + DK - 1) / DK;
    auto stage = [&](int c) {
      const int st = c % DSTAGES, n = n_begin + c * DK;
      stage_rows(gs[st], gg, n, n_end, Dout, o0, -1, g_vec, tid);
      stage_rows(xs[st], xg, n, n_end, Din, i0, Din, x_vec, tid);
    };
    float acc[TM][TM];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;

    __syncthreads();  // no thread still reads the ring
    for (int c = 0; c < DSTAGES - 1; ++c) {
      if (c < chunks) stage(c);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<DSTAGES - 2>();
      __syncthreads();  // chunk c has landed, and chunk c - 1's stage is free
      if (c + DSTAGES - 1 < chunks) stage(c + DSTAGES - 1);
      cp_async_commit();
      const int st = c % DSTAGES;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&gs[st][kk][to * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&xs[st][kk][ti * TM]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    float* pz = part + (long long)z * E1;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int o = o0 + to * TM + a;
      if (o >= Dout) continue;
#pragma unroll
      for (int b = 0; b < TM; ++b) {
        const int i = i0 + ti * TM + b;
        if (i <= Din) pz[(long long)o * (Din + 1) + i] = acc[a][b];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
k_prng_dparam_reduce(const float* __restrict__ part, const float* __restrict__ rho_w,
                     const float* __restrict__ rho_b, float* __restrict__ dmu_w,
                     float* __restrict__ drho_w, float* __restrict__ dmu_b,
                     float* __restrict__ drho_b, int S, int Din, int Dout, int n_splits,
                     Key key) {
  const long long E1 = (long long)Dout * (Din + 1);
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < E1;
       t += (long long)gridDim.x * THREADS) {
    const int o = (int)(t / (Din + 1)), i = (int)(t % (Din + 1));
    const unsigned e = i < Din ? (unsigned)o * Din + i : (unsigned)Dout * Din + o;
    // four samples at a time: their draws and loads are independent, so
    // they run side by side; the sums still run s = 0, 1, ... in order
    float mu = 0.f, rho = 0.f;
    for (int s0 = 0; s0 < S; s0 += 4) {
      float p[4], ep[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u;
        p[u] = 0.f;
        ep[u] = 0.f;
        if (s < S) {
          const float* ps = part + (long long)s * n_splits * E1 + t;
          for (int k = 0; k < n_splits; ++k) p[u] += ps[(long long)k * E1];
          ep[u] = normal_at(key, s, e);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < S) {
          mu += p[u];
          rho += p[u] * ep[u];
        }
      }
    }
    if (i < Din) {
      const long long idx = (long long)o * Din + i;
      dmu_w[idx] = mu;
      drho_w[idx] = rho / (1.f + expf(-rho_w[idx]));
    } else {
      dmu_b[o] = mu;
      drho_b[o] = rho / (1.f + expf(-rho_b[o]));
    }
  }
}

// ---------------------------------------------------------------------------
// k_prng_nkl + k_prng_nkl_reduce: nkl[s] = sum over the layer's elements e of
// lp - lq, with
//   lp = -(theta / sd_p)^2 / 2 - ln sd_p - ln(2 pi) / 2,  theta = mu + sd * eps,
//   lq = -eps^2 / 2 - ln sd - ln(2 pi) / 2,               sd = softplus(rho),
// as pallas_vi.py:249-254 writes them.
//
// What bounds it on this card: operations, S*(Dout*Din + Dout) normals of
// about 110 operations and about 12 more each for the two densities; 10
// samples of fc1 are 0.48 M normals, about 0.9 us at 67 TFLOP/s, against 0.39
// MB of parameters. The first design ran a block per sample, so at S = 10 ten
// SMs did the work (0.102 ms at fc1).
//
// What the design does about it. The grid is (element tiles) x (sample
// groups), _nkl_plan in ../sampled_linear_prng.py: a tile is NKL_TILE = 256
// elements, a thread each, and the groups are as few as keep the grid at
// NKL_BLOCKS or more blocks (the samples dealt evenly: spg a group). A thread
// loads its element's mu and rho once, forms sd and ln sd once, and draws eps
// with the one normal_at(key, s, e) for each sample of its group, four side
// by side. Each sample's 256 terms are added by a fixed tree (warp shuffles,
// then the 8 warps in order) into part[s][tile]; k_prng_nkl_reduce adds each
// sample's tile partials in tile order into nkl[s], a warp a sample: the
// lanes load 32 tiles at once and every lane adds them in order through
// shuffles. It is launched as a programmatic dependent launch, so that its
// launch overlaps k_prng_nkl; it waits for k_prng_nkl's writes
// (griddepcontrol.wait) before it reads. No atomics: a rerun gives the same
// bits.
constexpr int NKL_TILE = THREADS;  // elements a block, one a thread
constexpr int NKL_CHUNK = 32;      // samples a round of the block's partial sums

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
k_prng_nkl(const float* __restrict__ mu_w, const float* __restrict__ rho_w,
           const float* __restrict__ mu_b, const float* __restrict__ rho_b,
           float* __restrict__ part, int S, int Din, int Dout, int spg, float prior_sd,
           Key key) {
  __shared__ float red[NKL_CHUNK][THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned W = (unsigned)Dout * Din;
  const long long el = (long long)blockIdx.x * NKL_TILE + tid;
  const bool on = el < (long long)W + Dout;
  const unsigned e = (unsigned)el;
  const float half_log_2pi = 0.918938533204672742f, log_prior = logf(prior_sd);
  float m = 0.f, sd = 1.f;
  if (on) {
    m = e < W ? mu_w[e] : mu_b[e - W];
    sd = softplus_f(e < W ? rho_w[e] : rho_b[e - W]);
  }
  const float log_sd = logf(sd);
  const int s0 = blockIdx.y * spg, ns = min(spg, S - s0);
  const int tiles = gridDim.x;
  // let k_prng_nkl_reduce launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  for (int c0 = 0; c0 < ns; c0 += NKL_CHUNK) {
    const int nc = min(NKL_CHUNK, ns - c0);
    for (int u0 = 0; u0 < nc; u0 += 4) {
      float t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        t[u] = 0.f;
        if (on && u0 + u < nc) {
          const float eps = normal_at(key, s0 + c0 + u0 + u, e);
          const float x = (m + sd * eps) / prior_sd;
          const float lp = -0.5f * x * x - log_prior - half_log_2pi;
          const float lq = -0.5f * eps * eps - log_sd - half_log_2pi;
          t[u] = lp - lq;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = warp_sum(t[u]);
        if (lane == 0 && u0 + u < nc) red[u0 + u][warp] = v;
      }
    }
    __syncthreads();
    if (tid < nc) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) acc += red[tid][w];
      part[(long long)(s0 + c0 + tid) * tiles + blockIdx.x] = acc;
    }
    __syncthreads();  // red is free for the next round
  }
}

__global__ void __launch_bounds__(THREADS)
k_prng_nkl_reduce(const float* __restrict__ part, float* __restrict__ nkl, int S, int tiles) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // k_prng_nkl has finished
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp
  const float* ps = part + s * tiles;
  float acc = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const float v = t0 + lane < tiles ? ps[t0 + lane] : 0.f;
    const int nt = min(32, tiles - t0);
    for (int k = 0; k < nt; ++k) acc += __shfl_sync(0xffffffffu, v, k);
  }
  if (lane == 0) nkl[s] = acc;
}

// ---------------------------------------------------------------------------
extern "C" int psvi_philox_bits(const unsigned* ctr, unsigned* out, int n, unsigned key_lo,
                                unsigned key_hi, void* stream) {
  if (n <= 0) return 0;
  k_philox_bits<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ctr, Key{key_lo, key_hi}, out, n);
  return static_cast<int>(cudaGetLastError());
}

// n_splits: _fwd_plan's splits of N (1 <= n_splits <= min(8, ceil(N / 64))),
// which is also the cluster size.
extern "C" int psvi_prng_fwd(const float* x, const float* mu_w, const float* rho_w,
                             const float* mu_b, const float* rho_b, float* y, int S, int N,
                             int Din, int Dout, int n_splits, unsigned key_lo, unsigned key_hi,
                             void* stream) {
  if (S <= 0 || N <= 0 || Dout <= 0) return 0;
  if (n_splits < 1 || n_splits > 8 || n_splits > slgemm::cdiv(N, slgemm::BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = slgemm::smem_bytes(Din, Dout);
  const cudaError_t err = slgemm::allow_smem(k_prng_fwd, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster of the n_splits blocks of one (output tile, sample)
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = n_splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slgemm::cdiv(Dout, slgemm::BO), n_splits, S < 65535 ? S : 65535);
  cfg.blockDim = dim3(slgemm::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, k_prng_fwd, x, mu_w, rho_w, mu_b, rho_b, y, S,
                                             N, Din, Dout, n_splits,
                                             static_cast<int>(rows_of_float4(x, Din)),
                                             Key{key_lo, key_hi}));
}

// n_splits: _dx_plan's splits of N (1 <= n_splits <= min(8, ceil(N / 64))),
// which is also the cluster size: 8 is the most a portable cluster holds.
extern "C" int psvi_prng_dx(const float* g, const float* mu_w, const float* rho_w, float* dx,
                            int S, int N, int Din, int Dout, int n_splits, unsigned key_lo,
                            unsigned key_hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || N <= 0 || Din <= 0) return 0;
  if (Dout <= 0) {  // no outputs to sum over: dx is 0
    return static_cast<int>(cudaMemsetAsync(dx, 0, sizeof(float) * S * N * Din, st));
  }
  const int rows = Dout < XW ? (Dout + XK - 1) / XK * XK : XW;
  const int smem = rows * XI * static_cast<int>(sizeof(float));
  constexpr int ring = XSTAGES * XN * (XK + PAD) * static_cast<int>(sizeof(float));
  if (smem + ring > 48 * 1024) {  // above 48 KB a block must ask for its shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(k_prng_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // a cluster of the n_splits blocks of one (column tile, sample)
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = n_splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Din + XI - 1) / XI, n_splits, S < 65535 ? S : 65535);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, k_prng_dx, g, mu_w, rho_w, dx, S, N, Din,
                                             Dout, n_splits, static_cast<int>(rows_of_float4(g, Dout)),
                                             Key{key_lo, key_hi}));
}

// part: the scratch of pass 1, S * n_splits * Dout * (Din + 1) floats;
// n_splits: _dparam_plan's splits of N (1 <= n_splits <= max(1, N / 32)).
extern "C" int psvi_prng_dparam(const float* g, const float* x, const float* rho_w,
                                const float* rho_b, float* dmu_w, float* drho_w, float* dmu_b,
                                float* drho_b, float* part, int S, int N, int Din, int Dout,
                                int n_splits, unsigned key_lo, unsigned key_hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dout <= 0) return 0;
  if (S > 0) {
    const int zs = S * n_splits;
    const dim3 grid((Din + 1 + DT - 1) / DT, (Dout + DT - 1) / DT, zs < 65535 ? zs : 65535);
    k_prng_dparam_partial<<<grid, THREADS, 0, st>>>(g, x, part, S, N, Din, Dout, n_splits,
                                                    rows_of_float4(g, Dout),
                                                    rows_of_float4(x, Din));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long E1 = (long long)Dout * (Din + 1);
  const long long need = (E1 + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(need < (1 << 20) ? need : (1 << 20));
  k_prng_dparam_reduce<<<blocks, THREADS, 0, st>>>(part, rho_w, rho_b, dmu_w, drho_w, dmu_b,
                                                   drho_b, S, Din, Dout, n_splits,
                                                   Key{key_lo, key_hi});
  return static_cast<int>(cudaGetLastError());
}

// part: the scratch of pass 1, S * tiles floats, tiles = ceil(Dout * (Din + 1)
// / 256); spg: _nkl_plan's samples a group (1 <= spg <= S), the groups
// ceil(S / spg) (at most 65535).
extern "C" int psvi_prng_nkl(const float* mu_w, const float* rho_w, const float* mu_b,
                             const float* rho_b, float* nkl, float* part, int S, int Din,
                             int Dout, int spg, float prior_sd, unsigned key_lo, unsigned key_hi,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  const long long E = (long long)Dout * (Din + 1);
  const long long tiles = (E + NKL_TILE - 1) / NKL_TILE, groups = (S + (long long)spg - 1) / spg;
  if (spg < 1 || spg > S || tiles < 1 || tiles > 0x7fffffff || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  k_prng_nkl<<<dim3((unsigned)tiles, (unsigned)groups), THREADS, 0, st>>>(
      mu_w, rho_w, mu_b, rho_b, part, S, Din, Dout, spg, prior_sd, Key{key_lo, key_hi});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + THREADS / 32 - 1) / (THREADS / 32));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const float* cpart = part;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, k_prng_nkl_reduce, cpart, nkl, S, static_cast<int>(tiles)));
}
