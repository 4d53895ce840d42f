// Kernel B4: the fused S-sample variational dense op with its noise drawn
// inside the kernels, hand-written for Hopper (sm_90a). Four kernels that
// share one generator:
//
//   k_prng_fwd    y[s] = x[s] . W_s^T + b_s
//   k_prng_dx     dx[s] = g[s] . W_s
//   k_prng_dparam dmu_w = sum_s P_s, drho_w = sum_s P_s * eps_s * sigmoid(rho_w),
//                 P_s = g[s]^T . x[s], and the bias terms (P_s's column of ones)
//   k_prng_nkl    nkl[s] = sum over the layer of log p(theta_s) - log q(theta_s)
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
// Every C entry allocates nothing, launches on the given stream and returns
// the launch error, or 0. There are no atomics: every output is one
// fixed-order chain of operations, so a rerun gives the same bits.

#include <cuda_runtime.h>
#include <math.h>

constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps shared rows 16-byte aligned and spreads the banks

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

static __device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
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
// k_prng_fwd and k_prng_dx: kernel B3's tiling (sampled_linear.cu) with eps
// drawn in place of read.
//
// What bounds them on this card: operations. At fc1 of the LeNet main path
// (S = 10, N = 356, 400 -> 120) the product is 2*S*N*Din*Dout = 0.342 GFLOP and
// drawing each eps once is S*(Dout*Din + Dout) normals of about 110 operations,
// 0.053 G; 5.9 us at 67 TFLOP/s against 7.8 MB of x, y and parameters, 2.3 us at
// 3.35 TB/s. Without eps the bytes are S*Dout*Din*4 = 1.9 MB fewer than B3's.
//
// What the design does about it, simply: each block owns one 64 x 64 output
// tile of one sample and walks the reduction in chunks of 16; it stages the
// activation chunk and builds the W_s chunk, mu_w + softplus(rho_w) * eps, in
// shared memory from eps it draws itself, then each of its 256 threads
// accumulates a 4 x 4 register micro-tile with fp32 FMA. eps never touches
// device memory. The price is drawing every eps once per tile of the other
// dimension (ceil(N / 64) times): a later PR can keep W_s's rows of a block in
// shared memory across N tiles, or draw two normals from one Philox call.
// No TF32 and no tensor cores: the port holds true fp32.
constexpr int BT = 64;  // rows (points) and columns (outputs or inputs) per block
constexpr int BK = 16;  // reduction chunk staged in shared memory
constexpr int TM = 4;   // micro-tile side per thread

__global__ void __launch_bounds__(THREADS)
k_prng_fwd(const float* __restrict__ x, const float* __restrict__ mu_w,
           const float* __restrict__ rho_w, const float* __restrict__ mu_b,
           const float* __restrict__ rho_b, float* __restrict__ y, int N, int Din, int Dout,
           Key key) {
  // both tiles k-major: xs[k][n], ws[k][o]
  __shared__ __align__(16) float xs[BK][BT + PAD];
  __shared__ __align__(16) float ws[BK][BT + PAD];
  const int s = blockIdx.z, n0 = blockIdx.y * BT, o0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tn = tid / (BT / TM), to = tid % (BT / TM);
  const float* xg = x + (long long)s * N * Din;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Din; k0 += BK) {
    // neighbouring threads read neighbouring k of one row (coalesced)
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, n = n0 + r, k = k0 + kk;
      xs[kk][r] = (n < N && k < Din) ? xg[(long long)n * Din + k] : 0.f;
    }
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, o = o0 + r, k = k0 + kk;
      float w = 0.f;
      if (o < Dout && k < Din) {
        const unsigned i = (unsigned)o * Din + k;
        w = mu_w[i] + softplus_f(rho_w[i]) * normal_at(key, s, i);
      }
      ws[kk][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tn * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][to * TM]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int o = o0 + to * TM + j;
    if (o >= Dout) continue;
    const unsigned eb = (unsigned)Dout * Din + o;
    const float bias = mu_b[o] + softplus_f(rho_b[o]) * normal_at(key, s, eb);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int n = n0 + tn * TM + i;
      if (n < N) y[((long long)s * N + n) * Dout + o] = acc[i][j] + bias;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
k_prng_dx(const float* __restrict__ g, const float* __restrict__ mu_w,
          const float* __restrict__ rho_w, float* __restrict__ dx, int N, int Din, int Dout,
          Key key) {
  // gs[o][n] = g[s, n, o], ws[o][i] = W_s[o, i], both over a chunk of outputs o
  __shared__ __align__(16) float gs[BK][BT + PAD];
  __shared__ __align__(16) float ws[BK][BT + PAD];
  const int s = blockIdx.z, n0 = blockIdx.y * BT, i0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tn = tid / (BT / TM), ti = tid % (BT / TM);
  const float* gg = g + (long long)s * N * Dout;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Dout; c0 += BK) {
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, n = n0 + r, o = c0 + kk;
      gs[kk][r] = (n < N && o < Dout) ? gg[(long long)n * Dout + o] : 0.f;
    }
    // neighbouring threads read neighbouring inputs i of one row o (coalesced)
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int kk = e / BT, r = e % BT, o = c0 + kk, i = i0 + r;
      float w = 0.f;
      if (o < Dout && i < Din) {
        const unsigned idx = (unsigned)o * Din + i;
        w = mu_w[idx] + softplus_f(rho_w[idx]) * normal_at(key, s, idx);
      }
      ws[kk][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[kk][tn * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][ti * TM]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + tn * TM + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = i0 + ti * TM + j;
      if (c < Din) dx[((long long)s * N + n) * Din + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// k_prng_dparam. On the TPU the grid runs in order and the kernel adds each
// (sample, N tile) into its outputs (pallas_vi.py:225-237); Hopper's blocks run
// in no order, so here each block owns a 32 x 32 tile of the (Dout, Din + 1)
// outputs and loops inside itself over s and, within each s, over all of N.
// Column Din is the bias: its activation is 1, so P_s[o, Din] = sum_n g[s,n,o].
// After P_s is whole the block draws eps_s once per output, adds P_s to dmu and
// P_s * eps_s to the raw drho; the epilogue multiplies by sigmoid(rho).
//
// What bounds it on this card: operations, the same 2*S*N*Din*Dout product as
// the forward (0.342 GFLOP at fc1) plus S*(Dout*Din + Dout) normals, each drawn
// once. What the design does about it: 2 x 2 register micro-tiles over
// N chunks of 32 staged in shared memory, and no atomics, so a rerun is
// bitwise. Its weakness is the grid: (Din + 1) / 32 x Dout / 32 blocks, 52 at
// fc1 and 3 at fc3 on 132 SMs; splitting N or S across blocks would need a
// second, fixed-order pass, left to a later PR.
constexpr int DT = 32;  // outputs o and inputs i per block
constexpr int DK = 32;  // points per staged chunk
constexpr int DM = 2;   // micro-tile side per thread

__global__ void __launch_bounds__(THREADS)
k_prng_dparam(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ rho_w, const float* __restrict__ rho_b,
              float* __restrict__ dmu_w, float* __restrict__ drho_w,
              float* __restrict__ dmu_b, float* __restrict__ drho_b, int S, int N, int Din,
              int Dout, Key key) {
  __shared__ __align__(16) float gs[DK][DT + PAD];  // gs[n][o]
  __shared__ __align__(16) float xs[DK][DT + PAD];  // xs[n][i], 1 in column Din
  const int i0 = blockIdx.x * DT, o0 = blockIdx.y * DT;
  const int tid = threadIdx.x;
  const int to = tid / (DT / DM), ti = tid % (DT / DM);
  float mu[DM][DM], rho[DM][DM];
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int b = 0; b < DM; ++b) mu[a][b] = rho[a][b] = 0.f;

  for (int s = 0; s < S; ++s) {
    const float* gg = g + (long long)s * N * Dout;
    const float* xg = x + (long long)s * N * Din;
    float p[DM][DM];
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < DM; ++b) p[a][b] = 0.f;
    for (int n0 = 0; n0 < N; n0 += DK) {
      // neighbouring threads read neighbouring o (or i) of one row n (coalesced)
      for (int e = tid; e < DK * DT; e += THREADS) {
        const int kk = e / DT, r = e % DT, n = n0 + kk, o = o0 + r, i = i0 + r;
        gs[kk][r] = (n < N && o < Dout) ? gg[(long long)n * Dout + o] : 0.f;
        xs[kk][r] = n >= N ? 0.f : i < Din ? xg[(long long)n * Din + i] : (i == Din ? 1.f : 0.f);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float2 ga = *reinterpret_cast<const float2*>(&gs[kk][to * DM]);
        const float2 xb = *reinterpret_cast<const float2*>(&xs[kk][ti * DM]);
        const float gv[DM] = {ga.x, ga.y};
        const float xv[DM] = {xb.x, xb.y};
#pragma unroll
        for (int a = 0; a < DM; ++a)
#pragma unroll
          for (int b = 0; b < DM; ++b) p[a][b] = fmaf(gv[a], xv[b], p[a][b]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      const int o = o0 + to * DM + a;
#pragma unroll
      for (int b = 0; b < DM; ++b) {
        const int i = i0 + ti * DM + b;
        if (o >= Dout || i > Din) continue;
        const unsigned e = i < Din ? (unsigned)o * Din + i : (unsigned)Dout * Din + o;
        mu[a][b] += p[a][b];
        rho[a][b] += p[a][b] * normal_at(key, s, e);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < DM; ++a) {
    const int o = o0 + to * DM + a;
#pragma unroll
    for (int b = 0; b < DM; ++b) {
      const int i = i0 + ti * DM + b;
      if (o >= Dout || i > Din) continue;
      if (i < Din) {
        const long long idx = (long long)o * Din + i;
        dmu_w[idx] = mu[a][b];
        drho_w[idx] = rho[a][b] / (1.f + expf(-rho_w[idx]));
      } else {
        dmu_b[o] = mu[a][b];
        drho_b[o] = rho[a][b] / (1.f + expf(-rho_b[o]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// k_prng_nkl: one block per sample. Each thread sums lp - lq over the elements
// e = tid, tid + 256, ... in order, with
//   lp = -(theta / sd_p)^2 / 2 - ln sd_p - ln(2 pi) / 2,  theta = mu + sd * eps,
//   lq = -eps^2 / 2 - ln sd - ln(2 pi) / 2,               sd = softplus(rho),
// as pallas_vi.py:249-254 writes them; then a fixed tree over the block's 256
// partial sums gives nkl[s]. Deterministic.
//
// What bounds it on this card: operations, S*(Dout*Din + Dout) normals and
// about 20 more operations each for the two log densities; 10 samples of fc1
// are 0.48 M normals, about 0.9 us at 67 TFLOP/s, against 0.39 MB of
// parameters. What the design does about it: every parameter is read once per
// sample from L2 (the whole layer is 0.39 MB), every eps drawn once, and
// S blocks fill the card when S is large (4000 in the KL check); at S = 10 ten
// SMs do the work, which a later PR can split over more blocks per sample.
__global__ void __launch_bounds__(THREADS)
k_prng_nkl(const float* __restrict__ mu_w, const float* __restrict__ rho_w,
           const float* __restrict__ mu_b, const float* __restrict__ rho_b,
           float* __restrict__ nkl, int Din, int Dout, float prior_sd, Key key) {
  __shared__ float red[THREADS];
  const int s = blockIdx.x, tid = threadIdx.x;
  const unsigned W = (unsigned)Dout * Din, E = W + Dout;
  const float half_log_2pi = 0.918938533204672742f, log_prior = logf(prior_sd);
  float acc = 0.f;
  for (unsigned e = tid; e < E; e += THREADS) {
    const float m = e < W ? mu_w[e] : mu_b[e - W];
    const float sd = softplus_f(e < W ? rho_w[e] : rho_b[e - W]);
    const float eps = normal_at(key, s, e);
    const float t = (m + sd * eps) / prior_sd;
    const float lp = -0.5f * t * t - log_prior - half_log_2pi;
    const float lq = -0.5f * eps * eps - logf(sd) - half_log_2pi;
    acc += lp - lq;
  }
  red[tid] = acc;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) nkl[s] = red[0];
}

// ---------------------------------------------------------------------------
extern "C" int psvi_philox_bits(const unsigned* ctr, unsigned* out, int n, unsigned key_lo,
                                unsigned key_hi, void* stream) {
  if (n <= 0) return 0;
  k_philox_bits<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ctr, Key{key_lo, key_hi}, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvi_prng_fwd(const float* x, const float* mu_w, const float* rho_w,
                             const float* mu_b, const float* rho_b, float* y, int S, int N,
                             int Din, int Dout, unsigned key_lo, unsigned key_hi, void* stream) {
  if (S <= 0 || N <= 0 || Dout <= 0) return 0;
  const dim3 grid((Dout + BT - 1) / BT, (N + BT - 1) / BT, S);
  k_prng_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mu_w, rho_w, mu_b, rho_b, y, N, Din, Dout, Key{key_lo, key_hi});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvi_prng_dx(const float* g, const float* mu_w, const float* rho_w, float* dx,
                            int S, int N, int Din, int Dout, unsigned key_lo, unsigned key_hi,
                            void* stream) {
  if (S <= 0 || N <= 0 || Din <= 0) return 0;
  const dim3 grid((Din + BT - 1) / BT, (N + BT - 1) / BT, S);
  k_prng_dx<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, mu_w, rho_w, dx, N, Din, Dout, Key{key_lo, key_hi});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvi_prng_dparam(const float* g, const float* x, const float* rho_w,
                                const float* rho_b, float* dmu_w, float* drho_w, float* dmu_b,
                                float* drho_b, int S, int N, int Din, int Dout, unsigned key_lo,
                                unsigned key_hi, void* stream) {
  if (Dout <= 0) return 0;
  const dim3 grid((Din + 1 + DT - 1) / DT, (Dout + DT - 1) / DT);
  k_prng_dparam<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, rho_w, rho_b, dmu_w, drho_w, dmu_b, drho_b, S, N, Din, Dout,
      Key{key_lo, key_hi});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvi_prng_nkl(const float* mu_w, const float* rho_w, const float* mu_b,
                             const float* rho_b, float* nkl, int S, int Din, int Dout,
                             float prior_sd, unsigned key_lo, unsigned key_hi, void* stream) {
  if (S <= 0) return 0;
  k_prng_nkl<<<S, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mu_w, rho_w, mu_b, rho_b, nkl, Din, Dout, prior_sd, Key{key_lo, key_hi});
  return static_cast<int>(cudaGetLastError());
}
