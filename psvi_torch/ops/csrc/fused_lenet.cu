// Fused LeNet inner unroll (the bilevel step's T differentiable inner Adam
// iterations), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pair of psvi_tpu/ops/fused_lenet.py::make_fused_unroll:
//
//   psvi_lenet_fwd  replaces kernel A (pallas_call at fused_lenet.py:973):
//                   for t = 1..T, θ = μ + softplus(ρ)·ε_t; conv1 over the four
//                   pool parities, max (the winning parity kept as a uint8),
//                   bias, ReLU; the same for conv2; fc1-fc3; the categorical
//                   NLL weighted by cw = N·f(v) plus the dense-layer KL; the
//                   gradient by hand backprop; torch-exact Adam. Stores
//                   (p_t, m_t, n_t) for every t and the T inner losses.
//   psvi_lenet_rev  replaces kernel B (pallas_call at fused_lenet.py:997):
//                   for t = T..1, recompute iteration t's forward and gradient
//                   at p_{t-1} (and m_t, n_t from it, not from the history),
//                   the Adam VJP (d√n/dn = 0 at n = 0) to ḡ_t, then
//                   the VJP of g_t = ∇_p L_inner as forward-over-reverse: a
//                   tangent pass in direction ḡ_t through the sampling, both
//                   pooled convs (at the stored parity), the fc stack, the head
//                   and the backprop, giving H·ḡ_t (into p̄), the mixed term at
//                   the input (into ū) and ∂/∂cw (into c̄w); plus the inner-loss
//                   cotangent. Finally c̄w → v̄, ᾱ. The history from
//                   psvi_lenet_fwd spares the TPU kernel B's forward replay.
//
// The plain PyTorch versions with the same math are lenet_fwd_torch,
// lenet_rev_torch and rev_iter_torch_lenet in ../fused_lenet.py.
//
// What bounds it on this card: operations. One iteration's forward is about
// 0.83 GFLOP at S=10, M=100 (conv1 0.235, conv2 0.48, fc1 0.096, fc2+fc3 0.02).
// The pool keeps one conv output in four, so the passes after the pooled
// forward (backprop, weight gradients, the tangent pass) touch the winners
// only: psvi_lenet_fwd needs about 27.5 GFLOP at T=20 (0.41 ms at 67 TFLOP/s
// fp32) and psvi_lenet_rev about 61 GFLOP (0.91 ms), as chip_smoke.py's
// lenet_work counts them; the bytes (history, noise) are about 80 MB, 0.02 ms.
//
// What the design does about it. Each C entry loops over t on the host and
// issues a fixed sequence of kernels on the given stream (21 an iteration
// forward, 43 reverse). The one geometry supports() admits is fixed at
// compile time (LK1, LK2, LKS, LH), so the conv loops unroll.
// - Convolutions and what runs back through them work from shared-memory
//   tiles, one block per (sample, chunk of TILE_PTS points): the block stages
//   the sample's conv weights once, then each point's maps, and every tap is
//   a shared-memory read with no data-dependent branch.
//   k_conv1, k_conv2: a thread a pooled output (conv1: the six channels of a
//   position), the four parities' sums from one input window in registers.
//   k_conv2_back: the unpooled δ map (δ at the winning parity, 0 at the
//   other three) in a zero halo of k − 1, so the transposed conv tests
//   neither the winner nor a bound; it does four times the winners' FMAs
//   (0.94 GFLOP a launch at S=10, M=100: 14 µs at the fp32 rate) and is
//   bound by its shared-memory loads (16 for 35 FMAs a thread-step) and the
//   two barriers a point. k_ubar_part does the same for conv1's unpooled maps,
//   one block per (point, sample), and k_ubar_sum adds the samples in order.
//   k_conv2_wpart, k_conv1_wpart: weight-gradient partials a chunk, gathered
//   from the staged maps at the winners' offsets: bound by those gathers.
// - The fc layers, their backward and weight gradients: one batched GEMM on
//   32 × 32 tiles, 2 × 2 register micro-tiles and a register prefetch of the
//   next k tile; a tangent's two terms (δ̇·W + δ·Ẇ) in one launch. At M = 100
//   rows a sample its tiles barely fill the card: it is bound by latency, and
//   larger micro-tiles ran slower (scripts/torch_lenet_gemm_sweep.py).
// - Reductions over S and M are a fixed-order second pass (per-(sample,
//   chunk) partials, then a sum per output, or one block per bias and a block
//   sum), never float atomics, so a rerun gives the same bits.
// - Every product is fp32 FMA on CUDA cores: no TF32, no tensor cores. The
//   reverse is second order (one bf16 pass collapsed the u-hypergradient on
//   the TPU), and what holds these kernels back is shared-memory traffic and
//   latency, not the FMA rate.
// Left for later: fusing the launches of an iteration and a CUDA graph over
// the host loop.
//
// Layouts: params flat, per layer [mu_w | rho_w | mu_b | rho_b], conv weights
// (K, C, k, k), fc weights (o, i); a noise draw, θ and the per-sample gradients
// flat, per layer [w (S, ...) | b (S, o)]; activations (S, M, ...) with the
// pooled maps (S, M, K, P, P) and the flatten channel-major.
//
// Each C entry allocates nothing (the caller passes a workspace sized by
// psvi_lenet_workspace) and returns the first launch error, or 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NL 5
#define MAXC 32
#define MAXS 64
#define MAXM 1024
#define TPB 256
#define GBM 32   // k_gemm: output tile rows
#define GBN 32   // and columns
#define GBK 64   // its k tile
#define GTY 16   // threads along the tile's rows
#define GTX 16   // and along its columns: a 2 × 2 micro-tile each
#define GTHREADS (GTY * GTX)
#define RED 1024

// The one geometry supports() admits (LeNetCfg): conv1 1→6 and conv2 6→16,
// 5 × 5, on 28 × 28 images; make_net refuses any other. The conv and ū
// tiles are sized from it at compile time.
#define LK1 6
#define LK2 16
#define LKS 5
#define LQ (LKS * LKS)
#define LH 28
#define LPAD ((LKS - 1) / 2)
#define LP1 (LH / 2)              // 14: pooled conv1 side
#define LH2 (LP1 - LKS + 1)       // 10: conv2 output side
#define LP2 (LH2 / 2)             // 5: pooled conv2 side
#define W2N (LK2 * LK1 * LQ)      // 2400: one sample's conv2 weights
#define A1N (LK1 * LP1 * LP1)     // 1176: one point's pooled conv1 maps
#define TILE_PTS 2                // points per block of the conv tiles
#define C2_THREADS (LK2 * LP2 * LP2)  // 400: k_conv2, a pooled output each
#define CB_RUN 7                  // k_conv2_back: outputs a thread, along x
#define CB_THREADS 192            // 168 = K1·P1·2 threads sum, the rest load
#define DH (LH2 + 2 * (LKS - 1))  // 18: unpooled δ map side with its halo
#define DMAP (LK2 * DH * DH)      // 5184: one unpooled δ map
#define C1_THREADS (LP1 * LP1)    // 196: k_conv1, a pooled position each
#define WP_THREADS 480            // k_conv2_wpart: five weights a thread
#define W1_THREADS 600            // k_conv1_wpart: a weight over 49 positions each
#define W1STR 37                  // its image's row stride: a tap row a bank apart
#define UB_RUN 7                  // k_ubar_part: outputs a thread, along x
#define UB_THREADS 128            // 112 = H·H/7 threads sum, the rest load
#define UH (LH + 2 * LPAD)        // 32: conv1's unpooled map side with its halo
#define USTR (UH + 1)             // 33: its row stride, conflict-free

struct Net {
  int S, M, T, nc, K1, K2, k, q, H, pad, P1, H2, P2, F0, F1, F2;
  int parameterised, use_alpha;
  int nw[NL], nb[NL];  // weights and biases of each layer
  int joff[NL + 1];    // layer offset in one sample's [w | b] sequence
  int toff[NL];        // layer offset in a flat draw (ε, θ, per-sample grads)
  int poff[NL];        // layer offset in the flat parameter vector
  int J, P, E;
  float N, prior_sd, sp2inv, adam_eps, lr;
  double b1, b2;
};

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float relu_f(float x) { return x > 0.f ? x : 0.f; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (max) over the block, in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) sh[32] = x;
  }
  __syncthreads();
  return sh[32];
}

__device__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float x = lane < nw ? sh[lane] : -INFINITY;
    x = warp_max(x);
    if (lane == 0) sh[32] = x;
  }
  __syncthreads();
  return sh[32];
}

#define GRID_LOOP(i, n) \
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (n); i += gridDim.x * blockDim.x)

// Element j of one sample's [w | b] sequence: its layer, its μ and ρ in the
// flat parameter vector, and (per sample) its place in a flat draw.
struct Elem {
  int l, isw, local, jm, jr;
  __device__ Elem(const Net& n, int j) {
    l = 0;
    while (j >= n.joff[l + 1]) ++l;
    const int r = j - n.joff[l], nw = n.nw[l], nb = n.nb[l];
    isw = r < nw;
    local = isw ? r : r - nw;
    jm = isw ? n.poff[l] + r : n.poff[l] + 2 * nw + local;
    jr = jm + (isw ? nw : nb);
  }
  __device__ int at(const Net& n, int s) const {
    return isw ? n.toff[l] + s * n.nw[l] + local
               : n.toff[l] + n.S * n.nw[l] + s * n.nb[l] + local;
  }
  __device__ float dense() const { return l >= 2 ? 1.f : 0.f; }
};

__device__ __forceinline__ void bias_corr(const Net& n, int t, float& bc1, float& bc2s) {
  bc1 = (float)(1.0 - pow(n.b1, (double)t));
  bc2s = (float)sqrt(1.0 - pow(n.b2, (double)t));
}

// ---------------------------------------------------------------------------
// kernels

// cw = N·[e^α·] f(v), f = softmax or identity. One block.
__global__ void __launch_bounds__(RED)
k_core_weights(Net n, const float* __restrict__ v, const float* __restrict__ alpha, float* cw) {
  __shared__ float sh[33];
  float mx = 0.f, se = 1.f;
  if (n.parameterised) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < n.M; j += blockDim.x) m = fmaxf(m, v[j]);
    mx = block_max(m, sh);
    float s = 0.f;
    for (int j = threadIdx.x; j < n.M; j += blockDim.x) s += expf(v[j] - mx);
    se = block_sum(s, sh);
  }
  const float ea = n.use_alpha ? expf(alpha[0]) : 1.f;
  for (int j = threadIdx.x; j < n.M; j += blockDim.x) {
    float f = n.parameterised ? expf(v[j] - mx) / se : v[j];
    if (n.use_alpha) f = ea * f;
    cw[j] = n.N * f;
  }
}

// θ = μ + softplus(ρ)·ε, or (gdir given) its tangent ġ_μ + sigmoid(ρ)·ġ_ρ·ε.
__global__ void __launch_bounds__(TPB)
k_sample(Net n, const float* __restrict__ p, const float* __restrict__ gdir,
         const float* __restrict__ eps, float* out) {
  GRID_LOOP(idx, n.E) {
    int l = 0;
    while (l + 1 < NL && idx >= n.toff[l + 1]) ++l;
    const int r = idx - n.toff[l], nw = n.nw[l], nb = n.nb[l];
    int jm, jr;
    if (r < n.S * nw) {
      jm = n.poff[l] + r % nw;
      jr = jm + nw;
    } else {
      jm = n.poff[l] + 2 * nw + (r - n.S * nw) % nb;
      jr = jm + nb;
    }
    out[idx] = gdir ? gdir[jm] + sigmoid_f(p[jr]) * gdir[jr] * eps[idx]
                    : p[jm] + softplus_f(p[jr]) * eps[idx];
  }
}

// conv1 + pool1 + bias over shared-memory tiles. One block per (sample s,
// chunk of TILE_PTS points); it stages W1_s and b1_s (or Ẇ1_s and ḃ1_s)
// once, then each point's image in a zero halo of pad, so no tap needs a
// test; thread (i, j) computes pooled position (i, j) of the six channels.
// Plain: p1 = max over the four parities + b, winner in par1; each parity
// sums in the order (dy, dx) and the first parity wins a tie (strict >).
// With TAN, the tangent at the stored winner: out = conv(u, Ẇ) + ḃ.
template <bool TAN>
__global__ void __launch_bounds__(C1_THREADS)
k_conv1(Net n, const float* __restrict__ u, const float* __restrict__ th,
        const float* __restrict__ thd, uint8_t* par1, float* p1, float* out) {
  __shared__ float Us[UH * UH], W1s[LK1 * LQ], B1s[LK1];
  const int s = blockIdx.y, m0 = blockIdx.x * TILE_PTS, tid = threadIdx.x;
  const float* w1 = (TAN ? thd : th) + n.toff[0];
  for (int e = tid; e < LK1 * LQ; e += C1_THREADS) W1s[e] = w1[s * LK1 * LQ + e];
  if (tid < LK1) B1s[tid] = w1[n.S * LK1 * LQ + s * LK1 + tid];
  for (int e = tid; e < UH * UH; e += C1_THREADS) Us[e] = 0.f;  // the halo stays zero
  const float* x = Us + 2 * (tid / LP1) * UH + 2 * (tid % LP1);
  const int m1 = min(m0 + TILE_PTS, n.M);
  for (int m = m0; m < m1; ++m) {
    __syncthreads();  // the previous point's image is read
    for (int e = tid; e < LH * LH; e += C1_THREADS)
      Us[(e / LH + LPAD) * UH + e % LH + LPAD] = u[m * LH * LH + e];
    __syncthreads();
    const int base = (s * n.M + m) * A1N + tid;
    if constexpr (TAN) {
      for (int kk = 0; kk < LK1; ++kk) {
        const int idx = base + kk * LP1 * LP1, par = par1[idx];
        const float* xp = x + (par >> 1) * UH + (par & 1);
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < LKS; ++dy)
#pragma unroll
          for (int dx = 0; dx < LKS; ++dx)
            acc = fmaf(xp[dy * UH + dx], W1s[kk * LQ + dy * LKS + dx], acc);
        out[idx] = acc + B1s[kk];
      }
    } else {
      float xr[LKS + 1][LKS + 1];  // the 6 × 6 input window of the four parities
#pragma unroll
      for (int r = 0; r <= LKS; ++r)
#pragma unroll
        for (int e = 0; e <= LKS; ++e) xr[r][e] = x[r * UH + e];
      for (int kk = 0; kk < LK1; ++kk) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // parity 2a + b
#pragma unroll
        for (int dy = 0; dy < LKS; ++dy)
#pragma unroll
          for (int dx = 0; dx < LKS; ++dx) {
            const float w = W1s[kk * LQ + dy * LKS + dx];
#pragma unroll
            for (int par = 0; par < 4; ++par)
              acc[par] = fmaf(xr[(par >> 1) + dy][(par & 1) + dx], w, acc[par]);
          }
        float best = acc[0];
        int bp = 0;
#pragma unroll
        for (int par = 1; par < 4; ++par) {
          if (acc[par] > best) {
            best = acc[par];
            bp = par;
          }
        }
        const int idx = base + kk * LP1 * LP1;
        p1[idx] = best + B1s[kk];
        par1[idx] = (uint8_t)bp;
      }
    }
  }
}

// conv2 + pool2 + bias over shared-memory tiles. One block per (sample s,
// chunk of TILE_PTS points), one thread per pooled output (kk, i, j) of a
// point, position-major so that a warp reads two input windows (broadcast)
// and sixteen filters (distinct banks). The block stages W_s (and Ẇ_s) once,
// then for each point its relu(p1) map (and the masked tangent map
// p1 > 0 ? p1d : 0), K1·P1² floats each.
// Plain: p2 = max over the four parities + b, winner in par2; each parity
// sums in the order (c, dy, dx) and the first parity wins a tie (strict >).
// With TAN, the tangent at the stored winner:
// out = conv(ȧ1, W) + conv(a1, Ẇ) + ḃ.
template <bool TAN>
__global__ void __launch_bounds__(C2_THREADS)
k_conv2(Net n, const float* __restrict__ p1, const float* __restrict__ p1d,
        const float* __restrict__ th, const float* __restrict__ thd, uint8_t* par2, float* p2,
        float* out) {
  __shared__ float Ws[W2N], Xs[A1N];
  __shared__ float Wds[TAN ? W2N : 1], Xds[TAN ? A1N : 1];
  const int s = blockIdx.y, m0 = blockIdx.x * TILE_PTS, tid = threadIdx.x;
  const int kk = tid % LK2, pos = tid / LK2, i = pos / LP2, j = pos % LP2;
  const float* W = th + n.toff[1] + s * W2N;
  for (int e = tid; e < W2N; e += C2_THREADS) {
    Ws[e] = W[e];
    if constexpr (TAN) Wds[e] = thd[n.toff[1] + s * W2N + e];
  }
  const float bias = (TAN ? thd : th)[n.toff[1] + n.S * W2N + s * LK2 + kk];
  const int m1 = min(m0 + TILE_PTS, n.M);
  for (int m = m0; m < m1; ++m) {
    const int sm = s * n.M + m;
    __syncthreads();  // the previous point's maps are read
    for (int e = tid; e < A1N; e += C2_THREADS) {
      const float pv = p1[sm * A1N + e];
      Xs[e] = relu_f(pv);
      if constexpr (TAN) Xds[e] = pv > 0.f ? p1d[sm * A1N + e] : 0.f;
    }
    __syncthreads();
    const int idx = sm * (LK2 * LP2 * LP2) + kk * (LP2 * LP2) + pos;
    if constexpr (TAN) {
      const int par = par2[idx], a = par >> 1, b = par & 1;
      float acc_a = 0.f, acc_b = 0.f;  // conv(ȧ1, W), conv(a1, Ẇ)
      for (int c = 0; c < LK1; ++c) {
        const int xo = c * LP1 * LP1 + (2 * i + a) * LP1 + 2 * j + b;
        const int wo = (kk * LK1 + c) * LQ;
#pragma unroll
        for (int dy = 0; dy < LKS; ++dy)
#pragma unroll
          for (int dx = 0; dx < LKS; ++dx)
            acc_a = fmaf(Xds[xo + dy * LP1 + dx], Ws[wo + dy * LKS + dx], acc_a);
#pragma unroll
        for (int dy = 0; dy < LKS; ++dy)
#pragma unroll
          for (int dx = 0; dx < LKS; ++dx)
            acc_b = fmaf(Xs[xo + dy * LP1 + dx], Wds[wo + dy * LKS + dx], acc_b);
      }
      out[idx] = acc_a + acc_b + bias;
    } else {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // parity 2a + b
      for (int c = 0; c < LK1; ++c) {
        const float* x = Xs + c * LP1 * LP1 + 2 * i * LP1 + 2 * j;
        const float* w = Ws + (kk * LK1 + c) * LQ;
        // row r of the 6 × 6 input window feeds parity a at dy = r − a
#pragma unroll
        for (int r = 0; r <= LKS; ++r) {
          float xr[LKS + 1];
#pragma unroll
          for (int e = 0; e <= LKS; ++e) xr[e] = x[r * LP1 + e];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int dy = r - a;
            if (dy < 0 || dy >= LKS) continue;
#pragma unroll
            for (int dx = 0; dx < LKS; ++dx) {
              const float wv = w[dy * LKS + dx];
              acc[2 * a] = fmaf(xr[dx], wv, acc[2 * a]);
              acc[2 * a + 1] = fmaf(xr[dx + 1], wv, acc[2 * a + 1]);
            }
          }
        }
      }
      float best = acc[0];
      int bp = 0;
#pragma unroll
      for (int par = 1; par < 4; ++par) {
        if (acc[par] > best) {
          best = acc[par];
          bp = par;
        }
      }
      p2[idx] = best + bias;
      par2[idx] = (uint8_t)bp;
    }
  }
}

// Batched fp32 GEMM of one or two operand pairs, one GBM × GBN output tile
// per block, a 2 × 2 register micro-tile per thread:
// O[b](r, c) = Σ_p Σ_k A_p[b](r, k)·B_p[b](k, c) (+ bias[b](c)), then zeroed
// where the output mask is ≤ 0. The pairs share their shapes and strides (a
// tangent's two terms, as δ̇·W + δ·Ẇ); their k tiles run as one sequence, and
// each thread loads the next tile into registers while the block multiplies
// the current one from shared memory. An operand mask zeroes an operand
// entry where the mask (same strides) is ≤ 0: relu(x) is x masked by x.
struct GemmArgs {
  int R, C, K, pairs;
  const float *A[2], *Am[2];
  long long Ab, Ar, Ak;
  const float *B[2], *Bm[2];
  long long Bb, Bk, Bc;
  float* O;
  long long Ob, Or, Oc;
  const float* bias;
  long long biasb;
  const float* Om;
};

// one operand element of tile (pair, k0) or 0 outside the matrix or where
// its mask is ≤ 0
__device__ __forceinline__ float gemm_operand(const float* X, const float* Xm, long long o,
                                              bool in) {
  if (!in) return 0.f;
  const float x = X[o];
  return Xm && !(Xm[o] > 0.f) ? 0.f : x;
}

__global__ void __launch_bounds__(GTHREADS) k_gemm(GemmArgs g) {
  constexpr int MI = GBM / GTY, NJ = GBN / GTX;  // the micro-tile
  constexpr int LA = GBM * GBK / GTHREADS, LB = GBK * GBN / GTHREADS;
  __shared__ float As[2][GBK][GBM + 1], Bs[2][GBK][GBN + 1];
  const int tid = threadIdx.x, tx = tid % GTX, ty = tid / GTX, b = blockIdx.z;
  const int r0 = blockIdx.y * GBM, c0 = blockIdx.x * GBN;
  // the tile elements this thread loads, along each operand's contiguous axis
  int ar[LA], ak[LA], bk[LB], bc[LB];
#pragma unroll
  for (int e = 0; e < LA; ++e) {
    const int i = tid + e * GTHREADS;
    ar[e] = g.Ar == 1 ? i % GBM : i / GBK;
    ak[e] = g.Ar == 1 ? i / GBM : i % GBK;
  }
#pragma unroll
  for (int e = 0; e < LB; ++e) {
    const int i = tid + e * GTHREADS;
    bk[e] = g.Bk == 1 ? i % GBK : i / GBN;
    bc[e] = g.Bk == 1 ? i / GBK : i % GBN;
  }
  const int nk = (g.K + GBK - 1) / GBK, steps = nk * g.pairs;
  float ra[LA], rb[LB];
  auto load = [&](int step) {
    const int p = step / nk, k0 = (step % nk) * GBK;
    const float* A = g.A[p] + b * g.Ab;
    const float* Am = g.Am[p] ? g.Am[p] + b * g.Ab : nullptr;
    const float* B = g.B[p] + b * g.Bb;
    const float* Bm = g.Bm[p] ? g.Bm[p] + b * g.Bb : nullptr;
#pragma unroll
    for (int e = 0; e < LA; ++e) {
      const int r = r0 + ar[e], k = k0 + ak[e];
      ra[e] = gemm_operand(A, Am, r * g.Ar + k * g.Ak, r < g.R && k < g.K);
    }
#pragma unroll
    for (int e = 0; e < LB; ++e) {
      const int k = k0 + bk[e], c = c0 + bc[e];
      rb[e] = gemm_operand(B, Bm, k * g.Bk + c * g.Bc, k < g.K && c < g.C);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < LA; ++e) As[buf][ak[e]][ar[e]] = ra[e];
#pragma unroll
    for (int e = 0; e < LB; ++e) Bs[buf][bk[e]][bc[e]] = rb[e];
  };
  float acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float av[MI], bv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) av[i] = As[buf][kk][ty + GTY * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = Bs[buf][kk][tx + GTX * j];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = r0 + ty + GTY * i, c = c0 + tx + GTX * j;
      if (r < g.R && c < g.C) {
        const long long o = b * g.Ob + r * g.Or + c * g.Oc;
        float val = acc[i][j];
        if (g.bias) val += g.bias[b * g.biasb + c];
        if (g.Om && !(g.Om[o] > 0.f)) val = 0.f;
        g.O[o] = val;
      }
    }
  }
}

// Categorical head per (s, m): nll and δ = cw·(softmax − onehot); with zd
// given, the tangent δ̇ = cw·P·(ż − P·ż) and cwd = (P − Y)·ż.
__global__ void __launch_bounds__(TPB)
k_head(Net n, const float* __restrict__ z, const float* __restrict__ zd,
       const int* __restrict__ y, const float* __restrict__ cw, float* nll, float* d,
       float* dd, float* cwd) {
  const int nc = n.nc;
  GRID_LOOP(idx, n.S * n.M) {
    const int pt = idx % n.M, yc = y[pt];
    const float* Z = z + idx * nc;
    float pr[MAXC];
    float mx = Z[0];
    for (int c = 1; c < nc; ++c) mx = fmaxf(mx, Z[c]);
    float se = 0.f;
    for (int c = 0; c < nc; ++c) se += expf(Z[c] - mx);
    const float lse = mx + logf(se);
    for (int c = 0; c < nc; ++c) pr[c] = expf(Z[c] - lse);
    if (zd) {
      const float* D = zd + idx * nc;
      float pzd = 0.f, cz = 0.f;
      for (int c = 0; c < nc; ++c) {
        pzd = fmaf(pr[c], D[c], pzd);
        cz = fmaf(pr[c] - (c == yc ? 1.f : 0.f), D[c], cz);
      }
      for (int c = 0; c < nc; ++c) dd[idx * nc + c] = cw[pt] * pr[c] * (D[c] - pzd);
      cwd[idx] = cz;
    } else {
      nll[idx] = lse - Z[yc];
      for (int c = 0; c < nc; ++c) d[idx * nc + c] = cw[pt] * (pr[c] - (c == yc ? 1.f : 0.f));
    }
  }
}

// Back through conv2 + pool2 to the pooled conv1 map, as a transposed conv
// over shared-memory tiles with no branch on the pool winner. One block per
// (sample s, chunk of TILE_PTS points); it stages W_s (and Ẇ_s) once, then
// for each point builds the unpooled δ map (K2, H2, H2) of dA (and of dB):
// δ at the winning parity from par2, 0 at the other three, inside a zero
// halo of k − 1, so no tap needs a bounds test. Thread (c, y, half) sums
// seven outputs of channel c, row y:
// out = (p1 > 0)·Σ_k Σ_{dy,dx} [dA·W (+ dB·Ẇ)] at conv2 output (y−dy, x−dx),
// each in the order (k, dy, dx).
template <bool TAN>
__global__ void __launch_bounds__(CB_THREADS)
k_conv2_back(Net n, const float* __restrict__ dA, const float* __restrict__ dB,
             const uint8_t* __restrict__ par2, const float* __restrict__ th,
             const float* __restrict__ thd, const float* __restrict__ p1, float* out) {
  extern __shared__ float smem[];
  float* Ws = smem;           // W_s (K2, K1, k, k)
  float* Ds = Ws + W2N;       // unpooled dA (K2, DH, DH)
  float* Wds = Ds + DMAP;     // Ẇ_s
  float* Dds = Wds + W2N;     // unpooled dB
  const int s = blockIdx.y, m0 = blockIdx.x * TILE_PTS, tid = threadIdx.x;
  for (int e = tid; e < W2N; e += CB_THREADS) {
    Ws[e] = th[n.toff[1] + s * W2N + e];
    if constexpr (TAN) Wds[e] = thd[n.toff[1] + s * W2N + e];
  }
  for (int e = tid; e < DMAP; e += CB_THREADS) {  // the halo stays zero
    Ds[e] = 0.f;
    if constexpr (TAN) Dds[e] = 0.f;
  }
  const int c = tid / (2 * LP1), y = (tid % (2 * LP1)) >> 1, x0 = (tid & 1) * CB_RUN;
  const int m1 = min(m0 + TILE_PTS, n.M);
  for (int m = m0; m < m1; ++m) {
    const int sm = s * n.M + m;
    __syncthreads();  // the previous point's maps are read
    for (int e = tid; e < LK2 * LH2 * LH2; e += CB_THREADS) {
      const int kk = e / (LH2 * LH2), oy = (e / LH2) % LH2, ox = e % LH2;
      const int q = sm * (LK2 * LP2 * LP2) + kk * (LP2 * LP2) + (oy >> 1) * LP2 + (ox >> 1);
      const bool win = par2[q] == (((oy & 1) << 1) | (ox & 1));
      const int at = kk * DH * DH + (oy + LKS - 1) * DH + ox + LKS - 1;
      Ds[at] = win ? dA[q] : 0.f;
      if constexpr (TAN) Dds[at] = win ? dB[q] : 0.f;
    }
    __syncthreads();
    if (tid < LK1 * LP1 * 2) {
      float acc[CB_RUN];
#pragma unroll
      for (int i = 0; i < CB_RUN; ++i) acc[i] = 0.f;
      for (int kk = 0; kk < LK2; ++kk) {
#pragma unroll
        for (int dy = 0; dy < LKS; ++dy) {
          const int ro = kk * DH * DH + (y - dy + LKS - 1) * DH + x0;
          const int wo = (kk * LK1 + c) * LQ + dy * LKS;
          float r[CB_RUN + LKS - 1], rd[TAN ? CB_RUN + LKS - 1 : 1];
#pragma unroll
          for (int e = 0; e < CB_RUN + LKS - 1; ++e) {
            r[e] = Ds[ro + e];
            if constexpr (TAN) rd[e] = Dds[ro + e];
          }
#pragma unroll
          for (int dx = 0; dx < LKS; ++dx) {
            const float w = Ws[wo + dx];
            float wd = 0.f;
            if constexpr (TAN) wd = Wds[wo + dx];
#pragma unroll
            for (int i = 0; i < CB_RUN; ++i) {
              acc[i] = fmaf(r[i - dx + LKS - 1], w, acc[i]);
              if constexpr (TAN) acc[i] = fmaf(rd[i - dx + LKS - 1], wd, acc[i]);
            }
          }
        }
      }
      const int ob = (sm * LK1 + c) * (LP1 * LP1) + y * LP1 + x0;
#pragma unroll
      for (int i = 0; i < CB_RUN; ++i) out[ob + i] = p1[ob + i] > 0.f ? acc[i] : 0.f;
    }
  }
}

// conv2 weight gradient per (sample, chunk of TILE_PTS points) over
// shared-memory tiles: part[(s, chunk), w] = Σ_m Σ_{i,j} dA·a1 (+ dB·ȧ1) at
// the winner's input position, a1 = relu(p1), ȧ1 = p1 > 0 ? p1d : 0. For
// each point the block stages a1 (and ȧ1), δ (and its tangent) and the
// winners' input offsets; thread t sums weights t + e·WP_THREADS, e < 5.
template <bool TAN>
__global__ void __launch_bounds__(WP_THREADS)
k_conv2_wpart(Net n, const float* __restrict__ dA, const float* __restrict__ dB,
              const uint8_t* __restrict__ par2, const float* __restrict__ p1,
              const float* __restrict__ p1d, float* part) {
  constexpr int NQ = LK2 * LP2 * LP2, NE = W2N / WP_THREADS;
  __shared__ float Xs[A1N], Xds[TAN ? A1N : 1], Ds[NQ], Dds[TAN ? NQ : 1];
  __shared__ int Os[NQ];  // input offset of each pooled output's winner
  const int s = blockIdx.y, m0 = blockIdx.x * TILE_PTS, tid = threadIdx.x;
  int xo[NE], qo[NE];
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int w = tid + e * WP_THREADS;
    const int dx = w % LKS, dy = (w / LKS) % LKS, c = (w / LQ) % LK1, kk = w / (LQ * LK1);
    xo[e] = c * LP1 * LP1 + dy * LP1 + dx;
    qo[e] = kk * LP2 * LP2;
    acc[e] = 0.f;
  }
  const int m1 = min(m0 + TILE_PTS, n.M);
  for (int m = m0; m < m1; ++m) {
    const int sm = s * n.M + m;
    __syncthreads();  // the previous point's tiles are read
    for (int e = tid; e < A1N; e += WP_THREADS) {
      const float pv = p1[sm * A1N + e];
      Xs[e] = relu_f(pv);
      if constexpr (TAN) Xds[e] = pv > 0.f ? p1d[sm * A1N + e] : 0.f;
    }
    for (int e = tid; e < NQ; e += WP_THREADS) {
      const int q = sm * NQ + e, par = par2[q], i = (e / LP2) % LP2, j = e % LP2;
      Os[e] = (2 * i + (par >> 1)) * LP1 + 2 * j + (par & 1);
      Ds[e] = dA[q];
      if constexpr (TAN) Dds[e] = dB[q];
    }
    __syncthreads();
    for (int pos = 0; pos < LP2 * LP2; ++pos) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int q = qo[e] + pos, at = Os[q] + xo[e];
        acc[e] = fmaf(Ds[q], Xs[at], acc[e]);
        if constexpr (TAN) acc[e] = fmaf(Dds[q], Xds[at], acc[e]);
      }
    }
  }
  const int row = s * gridDim.x + blockIdx.x;
#pragma unroll
  for (int e = 0; e < NE; ++e) part[row * W2N + tid + e * WP_THREADS] = acc[e];
}

// conv1 weight gradient per (sample, chunk of TILE_PTS points) over
// shared-memory tiles: part[(s, chunk), w] = Σ_m Σ_{i,j} dA·u at the winner's
// input position (u carries no tangent). For each point the block stages u
// in a zero halo of pad, δ and the winners' input offsets; thread (g, w)
// sums weight w over a quarter g of the pooled positions, and the quarters
// add in order.
__global__ void __launch_bounds__(W1_THREADS)
k_conv1_wpart(Net n, const float* __restrict__ dA, const uint8_t* __restrict__ par1,
              const float* __restrict__ u, float* part) {
  constexpr int NW = LK1 * LQ, NP = LP1 * LP1, NG = W1_THREADS / NW, PG = NP / NG;
  __shared__ float Us[UH * W1STR], Ds[LK1 * NP], Sum[W1_THREADS];
  __shared__ int Os[LK1 * NP];  // input offset of each pooled output's winner
  const int s = blockIdx.y, m0 = blockIdx.x * TILE_PTS, tid = threadIdx.x;
  const int w = tid % NW, g = tid / NW, kk = w / LQ, dy = (w / LKS) % LKS, dx = w % LKS;
  const int xo = dy * W1STR + dx, qo = kk * NP + g * PG;
  for (int e = tid; e < UH * W1STR; e += W1_THREADS) Us[e] = 0.f;  // the halo stays zero
  float acc = 0.f;
  const int m1 = min(m0 + TILE_PTS, n.M);
  for (int m = m0; m < m1; ++m) {
    const int sm = s * n.M + m;
    __syncthreads();  // the previous point's tiles are read
    for (int e = tid; e < LH * LH; e += W1_THREADS)
      Us[(e / LH + LPAD) * W1STR + e % LH + LPAD] = u[m * LH * LH + e];
    for (int e = tid; e < LK1 * NP; e += W1_THREADS) {
      const int q = sm * A1N + e, par = par1[q], i = (e / LP1) % LP1, j = e % LP1;
      Os[e] = (2 * i + (par >> 1)) * W1STR + 2 * j + (par & 1);
      Ds[e] = dA[q];
    }
    __syncthreads();
    for (int p = 0; p < PG; ++p) acc = fmaf(Ds[qo + p], Us[Os[qo + p] + xo], acc);
  }
  Sum[tid] = acc;
  __syncthreads();
  if (tid < NW) {
    float tot = 0.f;
    for (int q = 0; q < NG; ++q) tot += Sum[q * NW + tid];
    part[(s * gridDim.x + blockIdx.x) * NW + tid] = tot;
  }
}

// Second pass of a conv weight gradient: G[off + s·nw + w] = Σ_r part over
// the partials of sample s, one a chunk of TILE_PTS points, in order.
__global__ void __launch_bounds__(TPB)
k_reduce_m(Net n, const float* __restrict__ part, int nw, float* G) {
  const int rows = (n.M + TILE_PTS - 1) / TILE_PTS;
  GRID_LOOP(idx, n.S * nw) {
    const int s = idx / nw, w = idx % nw;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += part[(s * rows + r) * nw + w];
    G[idx] = acc;
  }
}

static int n_biases(const Net& n) { return n.nb[0] + n.nb[1] + n.nb[2] + n.nb[3] + n.nb[4]; }

// Per-sample bias gradients of all five layers: Σ_m Σ_pos δ. One block per
// (sample, bias), launched with S·(number of biases) blocks: its threads
// take the M·positions terms in a fixed stride, then a fixed-order block sum.
__global__ void __launch_bounds__(TPB)
k_bias(Net n, const float* __restrict__ dp1, const float* __restrict__ dp2,
       const float* __restrict__ d1, const float* __restrict__ d2,
       const float* __restrict__ d3, float* G) {
  __shared__ float sh[33];
  const int NB = n.nb[0] + n.nb[1] + n.nb[2] + n.nb[3] + n.nb[4];
  const int s = blockIdx.x / NB;
  int r = blockIdx.x % NB, l = 0;
  while (r >= n.nb[l]) r -= n.nb[l++];
  const float* src = l == 0 ? dp1 : l == 1 ? dp2 : l == 2 ? d1 : l == 3 ? d2 : d3;
  const int npos = l == 0 ? n.P1 * n.P1 : l == 1 ? n.P2 * n.P2 : 1;
  const int row = n.nb[l] * npos;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n.M * npos; i += blockDim.x) {
    const int m = i / npos, pos = i - m * npos;
    acc += src[(long long)(s * n.M + m) * row + r * npos + pos];
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) G[n.toff[l] + n.S * n.nw[l] + s * n.nb[l] + r] = acc;
}

// ∂L/∂μ and ∂L/∂ρ of element e from the per-sample gradients G (and h =
// ∂L/∂σ, so that ∂L/∂ρ = sigmoid(ρ)·h). KL only for the dense layers.
__device__ __forceinline__ void elem_grad(const Net& n, const Elem& e, const float* p,
                                          const float* G, const float* eps, float& gmu,
                                          float& grho, float& h) {
  float gs = 0.f, gse = 0.f;
  for (int s = 0; s < n.S; ++s) {
    const int q = e.at(n, s);
    gs += G[q];
    gse = fmaf(G[q], eps[q], gse);
  }
  const float mu = p[e.jm], rho = p[e.jr], sd = softplus_f(rho), kl = e.dense();
  h = gse + kl * (-1.f / sd + sd * n.sp2inv);
  gmu = gs + kl * mu * n.sp2inv;
  grho = sigmoid_f(rho) * h;
}

// torch-exact Adam on both parameters of each element; writes hist[t].
__global__ void __launch_bounds__(TPB)
k_adam(Net n, int t, const float* __restrict__ p, const float* __restrict__ m,
       const float* __restrict__ nv, const float* __restrict__ G,
       const float* __restrict__ eps, float* p1, float* m1, float* n1) {
  float bc1, bc2s;
  bias_corr(n, t, bc1, bc2s);
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  GRID_LOOP(j, n.J) {
    const Elem e(n, j);
    float g[2], h;
    elem_grad(n, e, p, G, eps, g[0], g[1], h);
    const int q[2] = {e.jm, e.jr};
    for (int r = 0; r < 2; ++r) {
      const float mo = b1 * m[q[r]] + c1 * g[r];
      const float no = b2 * nv[q[r]] + c2 * (g[r] * g[r]);
      const float den = (no > 0.f ? sqrtf(no) : 0.f) / bc2s + n.adam_eps;
      m1[q[r]] = mo;
      n1[q[r]] = no;
      p1[q[r]] = p[q[r]] - n.lr * (mo / bc1) / den;
    }
  }
}

// losses[t−1] = Σ_s Σ_m cw_m·nll + KL(dense layers) at p. One block.
__global__ void __launch_bounds__(RED)
k_loss(Net n, const float* __restrict__ nll, const float* __restrict__ cw,
       const float* __restrict__ p, float* losses, int t) {
  __shared__ float sh[33];
  float part = 0.f;
  for (int i = threadIdx.x; i < n.S * n.M; i += blockDim.x) part = fmaf(nll[i], cw[i % n.M], part);
  const float sp = n.prior_sd;
  for (int j = n.joff[2] + threadIdx.x; j < n.J; j += blockDim.x) {
    const Elem e(n, j);
    const float mu = p[e.jm], sd = softplus_f(p[e.jr]);
    part += logf(sp / sd) + (sd * sd + mu * mu) / (2.f * sp * sp) - 0.5f;
  }
  const float loss = block_sum(part, sh);
  if (threadIdx.x == 0) losses[t - 1] = loss;
}

// Adam VJP of iteration t at p̄_t: m̄_t, n̄_t and ḡ_t; m̄, n̄ become
// m̄_{t−1} = β₁·m̄_t, n̄_{t−1} = β₂·n̄_t. p̄ is updated later (k_hvp). m_t and
// n_t are formed again from m_{t−1}, n_{t−1} and the recomputed gradient, as
// k_adam does: at t = 1 the VJP of the step −lr·sign(g) is the difference of
// two terms ∝ 1/|g| that cancel only when m_t, n_t come from the same g.
__global__ void __launch_bounds__(TPB)
k_adam_vjp(Net n, int t, const float* __restrict__ p, const float* __restrict__ mp,
           const float* __restrict__ np, const float* __restrict__ G,
           const float* __restrict__ eps, const float* __restrict__ pbar, float* mbar,
           float* nbar, float* gbar) {
  float bc1, bc2s;
  bias_corr(n, t, bc1, bc2s);
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  GRID_LOOP(j, n.J) {
    const Elem e(n, j);
    float g[2], h;
    elem_grad(n, e, p, G, eps, g[0], g[1], h);
    const int q[2] = {e.jm, e.jr};
    for (int r = 0; r < 2; ++r) {
      const float mt = b1 * mp[q[r]] + c1 * g[r];
      const float nn = b2 * np[q[r]] + c2 * (g[r] * g[r]);
      const float den = (nn > 0.f ? sqrtf(nn) : 0.f) / bc2s + n.adam_eps;
      const float mb = mbar[q[r]] - pbar[q[r]] * n.lr / (bc1 * den);
      const float ds = nn > 0.f ? 0.5f / sqrtf(nn) : 0.f;
      const float nb = nbar[q[r]] + pbar[q[r]] * n.lr * (mt / bc1) / (den * den) * ds / bc2s;
      gbar[q[r]] = c1 * mb + 2.f * c2 * g[r] * nb;
      mbar[q[r]] = (float)n.b1 * mb;
      nbar[q[r]] = (float)n.b2 * nb;
    }
  }
}

// p̄_{t−1} = p̄_t + H·ḡ_t + dl_t·g_t, with H·ḡ from the tangent gradients Gd.
__global__ void __launch_bounds__(TPB)
k_hvp(Net n, int t, const float* __restrict__ p, const float* __restrict__ G,
      const float* __restrict__ Gd, const float* __restrict__ eps,
      const float* __restrict__ gbar, const float* __restrict__ dlosses, float* pbar) {
  const float dl = dlosses[t - 1];
  GRID_LOOP(j, n.J) {
    const Elem e(n, j);
    float gmu, grho, h;
    elem_grad(n, e, p, G, eps, gmu, grho, h);
    float ds = 0.f, dse = 0.f;
    for (int s = 0; s < n.S; ++s) {
      const int q = e.at(n, s);
      ds += Gd[q];
      dse = fmaf(Gd[q], eps[q], dse);
    }
    const float rho = p[e.jr], sd = softplus_f(rho), sg = sigmoid_f(rho), kl = e.dense();
    const float gm = gbar[e.jm], gr = gbar[e.jr];
    pbar[e.jm] += ds + kl * gm * n.sp2inv + dl * gmu;
    pbar[e.jr] += sg * (1.f - sg) * gr * h + sg * (dse + kl * (1.f / (sd * sd) + n.sp2inv) * sg * gr) +
                  dl * grho;
  }
}

// ū's share of sample s at point m, over shared-memory tiles:
// part[(s, m), y, x] = Σ_k Σ_{dy,dx} [(δ̇ + dl·δ)·W1 + δ·Ẇ1] at the conv1
// output (y+pad−dy, x+pad−dx) when it won its pool window. One block per
// (m, s); for each conv1 channel k it builds the unpooled maps of δ̇ + dl·δ
// and δ (H × H, zero at the losing parities, in a zero halo of pad), so no
// tap needs a test. Thread (x run, y) sums seven outputs of row y, each in
// the order (k, dy, dx).
__global__ void __launch_bounds__(UB_THREADS)
k_ubar_part(Net n, int t, const float* __restrict__ dp1d, const float* __restrict__ dp1,
            const uint8_t* __restrict__ par1, const float* __restrict__ th,
            const float* __restrict__ thd, const float* __restrict__ dlosses, float* part) {
  __shared__ float Es[UH * USTR], Fs[UH * USTR], W1[LK1 * LQ], W1d[LK1 * LQ];
  const float dl = dlosses[t - 1];
  const int m = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int sm = s * n.M + m;
  for (int e = tid; e < UH * USTR; e += UB_THREADS) {  // the halo stays zero
    Es[e] = 0.f;
    Fs[e] = 0.f;
  }
  for (int e = tid; e < LK1 * LQ; e += UB_THREADS) {
    W1[e] = th[n.toff[0] + s * LK1 * LQ + e];
    W1d[e] = thd[n.toff[0] + s * LK1 * LQ + e];
  }
  const int y = tid % LH, x0 = (tid / LH) * UB_RUN;
  float acc[UB_RUN];
#pragma unroll
  for (int i = 0; i < UB_RUN; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < LK1; ++kk) {
    __syncthreads();  // the previous channel's maps are read
    const int qb = (sm * LK1 + kk) * (LP1 * LP1);
    for (int e = tid; e < LH * LH; e += UB_THREADS) {
      const int oy = e / LH, ox = e % LH;
      const int q = qb + (oy >> 1) * LP1 + (ox >> 1);
      const bool win = par1[q] == (((oy & 1) << 1) | (ox & 1));
      const int at = (oy + LPAD) * USTR + ox + LPAD;
      Es[at] = win ? dp1d[q] + dl * dp1[q] : 0.f;
      Fs[at] = win ? dp1[q] : 0.f;
    }
    __syncthreads();
    if (tid < LH * (LH / UB_RUN)) {
#pragma unroll
      for (int dy = 0; dy < LKS; ++dy) {
        const int ro = (y + 2 * LPAD - dy) * USTR + x0;
        float e[UB_RUN + LKS - 1], f[UB_RUN + LKS - 1];
#pragma unroll
        for (int i = 0; i < UB_RUN + LKS - 1; ++i) {
          e[i] = Es[ro + i];
          f[i] = Fs[ro + i];
        }
#pragma unroll
        for (int dx = 0; dx < LKS; ++dx) {
          const float w = W1[kk * LQ + dy * LKS + dx], wd = W1d[kk * LQ + dy * LKS + dx];
#pragma unroll
          for (int i = 0; i < UB_RUN; ++i) {
            acc[i] = fmaf(e[i - dx + 2 * LPAD], w, acc[i]);
            acc[i] = fmaf(f[i - dx + 2 * LPAD], wd, acc[i]);
          }
        }
      }
    }
  }
  if (tid < LH * (LH / UB_RUN)) {
#pragma unroll
    for (int i = 0; i < UB_RUN; ++i) part[sm * (LH * LH) + y * LH + x0 + i] = acc[i];
  }
}

// ū[m] += Σ_s part[(s, m)], the samples in order.
__global__ void __launch_bounds__(TPB)
k_ubar_sum(Net n, const float* __restrict__ part, float* ubar) {
  GRID_LOOP(idx, n.M * LH * LH) {
    const int m = idx / (LH * LH), p = idx % (LH * LH);
    float acc = 0.f;
    for (int s = 0; s < n.S; ++s) acc += part[(s * n.M + m) * (LH * LH) + p];
    ubar[idx] += acc;
  }
}

// c̄w[m] += Σ_s (P − Y)·ż + dl·nll.
__global__ void __launch_bounds__(TPB)
k_cwbar(Net n, int t, const float* __restrict__ cwd, const float* __restrict__ nll,
        const float* __restrict__ dlosses, float* cwbar) {
  const float dl = dlosses[t - 1];
  GRID_LOOP(m, n.M) {
    float acc = 0.f;
    for (int s = 0; s < n.S; ++s) acc += cwd[s * n.M + m] + dl * nll[s * n.M + m];
    cwbar[m] += acc;
  }
}

// c̄w → v̄, ᾱ through cw = N·[e^α·] f(v). One block.
__global__ void __launch_bounds__(RED)
k_cw_vjp(Net n, const float* __restrict__ cwbar, const float* __restrict__ cw,
         const float* __restrict__ v, const float* __restrict__ alpha, float* g_v,
         float* g_alpha) {
  __shared__ float sh[33];
  const int M = n.M;
  float mx = 0.f, se = 1.f;
  if (n.parameterised) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < M; j += blockDim.x) m = fmaxf(m, v[j]);
    mx = block_max(m, sh);
    float s = 0.f;
    for (int j = threadIdx.x; j < M; j += blockDim.x) s += expf(v[j] - mx);
    se = block_sum(s, sh);
  }
  const float scale = n.N * (n.use_alpha ? expf(alpha[0]) : 1.f);
  float dot = 0.f, ga = 0.f;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const float f = n.parameterised ? expf(v[j] - mx) / se : v[j];
    dot = fmaf(f, scale * cwbar[j], dot);
    ga = fmaf(cwbar[j], cw[j], ga);
  }
  dot = block_sum(dot, sh);
  ga = block_sum(ga, sh);
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const float fb = scale * cwbar[j];
    g_v[j] = n.parameterised ? (expf(v[j] - mx) / se) * (fb - dot) : fb;
  }
  if (threadIdx.x == 0) g_alpha[0] = n.use_alpha ? ga : 0.f;
}

// ---------------------------------------------------------------------------
// host side: the Net, the workspace, and the per-iteration launch sequences

// dims = [S, M, T, nc, K1, K2, k, H, F1, F2, parameterised, use_alpha]
// hyper = [N, prior_sd, b1, b2, adam_eps, lr]
static int make_net(Net* n, const int* dims, const double* hyper) {
  n->S = dims[0]; n->M = dims[1]; n->T = dims[2]; n->nc = dims[3];
  n->K1 = dims[4]; n->K2 = dims[5]; n->k = dims[6]; n->H = dims[7];
  n->F1 = dims[8]; n->F2 = dims[9];
  n->parameterised = dims[10]; n->use_alpha = dims[11];
  n->q = n->k * n->k;
  n->pad = (n->k - 1) / 2;
  n->P1 = n->H / 2;
  n->H2 = n->P1 - n->k + 1;
  n->P2 = n->H2 / 2;
  n->F0 = n->K2 * n->P2 * n->P2;
  if (n->S < 1 || n->S > MAXS || n->M < 1 || n->M > MAXM || n->nc < 1 || n->nc > MAXC ||
      n->T < 1 || n->K1 < 1 || n->K2 < 1 || n->k < 1 || n->k % 2 == 0 || n->H % 4 ||
      n->H2 <= 0 || n->H2 % 2 || n->F1 < 1 || n->F2 < 1 || n->K1 != LK1 || n->K2 != LK2 ||
      n->k != LKS || n->H != LH)
    return 1;
  const int nw[NL] = {n->K1 * n->q, n->K2 * n->K1 * n->q, n->F1 * n->F0, n->F2 * n->F1,
                      n->nc * n->F2};
  const int nb[NL] = {n->K1, n->K2, n->F1, n->F2, n->nc};
  int j = 0, t = 0, p = 0;
  for (int l = 0; l < NL; ++l) {
    n->nw[l] = nw[l];
    n->nb[l] = nb[l];
    n->joff[l] = j;
    n->toff[l] = t;
    n->poff[l] = p;
    j += nw[l] + nb[l];
    t += n->S * (nw[l] + nb[l]);
    p += 2 * (nw[l] + nb[l]);
  }
  n->joff[NL] = j;
  n->J = j;
  n->E = t;
  n->P = p;
  n->N = (float)hyper[0];
  n->prior_sd = (float)hyper[1];
  n->sp2inv = (float)(1.0 / (hyper[1] * hyper[1]));
  n->b1 = hyper[2];
  n->b2 = hyper[3];
  n->adam_eps = (float)hyper[4];
  n->lr = (float)hyper[5];
  return 0;
}

struct Work {
  float *theta, *p1, *p2, *z1, *z2, *z3, *nll, *d3, *d2, *d1, *dp2, *dp1, *G, *part, *cw;
  // reverse sweep only
  float *thetad, *p1d, *p2d, *z1d, *z2d, *z3d, *d3d, *d2d, *d1d, *dp2d, *dp1d, *Gd;
  float *gbar, *mbar, *nbar, *cwd, *cwbar;
  uint8_t *par1, *par2;
};

// Carve the workspace (or, with null bases, count it): nf floats, nb bytes.
static void carve(const Net& n, int rev, float* wf, uint8_t* wb, Work* w, long long* nf,
                  long long* nbytes) {
  const long long SM = (long long)n.S * n.M;
  const long long A1 = SM * n.K1 * n.P1 * n.P1, A2 = SM * n.F0;
  // partials: a conv weight gradient's (a sample and chunk of points each),
  // then ū's (H² a sample and point)
  const long long part = SM * (n.nw[1] > n.nw[0] ? n.nw[1] : n.nw[0]);
  long long of = 0, ob = 0;
  auto F = [&](long long cnt) {
    float* r = wf ? wf + of : nullptr;
    of += (cnt + 63) / 64 * 64;
    return r;
  };
  auto B = [&](long long cnt) {
    uint8_t* r = wb ? wb + ob : nullptr;
    ob += (cnt + 255) / 256 * 256;
    return r;
  };
  w->theta = F(n.E); w->p1 = F(A1); w->p2 = F(A2);
  w->z1 = F(SM * n.F1); w->z2 = F(SM * n.F2); w->z3 = F(SM * n.nc); w->nll = F(SM);
  w->d3 = F(SM * n.nc); w->d2 = F(SM * n.F2); w->d1 = F(SM * n.F1);
  w->dp2 = F(A2); w->dp1 = F(A1); w->G = F(n.E); w->part = F(part); w->cw = F(n.M);
  w->par1 = B(A1); w->par2 = B(A2);
  if (rev) {
    w->thetad = F(n.E); w->p1d = F(A1); w->p2d = F(A2);
    w->z1d = F(SM * n.F1); w->z2d = F(SM * n.F2); w->z3d = F(SM * n.nc);
    w->d3d = F(SM * n.nc); w->d2d = F(SM * n.F2); w->d1d = F(SM * n.F1);
    w->dp2d = F(A2); w->dp1d = F(A1); w->Gd = F(n.E);
    w->gbar = F(n.P); w->mbar = F(n.P); w->nbar = F(n.P); w->cwd = F(SM); w->cwbar = F(n.M);
  }
  if (nf) *nf = of;
  if (nbytes) *nbytes = ob;
}

static int blocks(long long count) {
  long long b = (count + TPB - 1) / TPB;
  return (int)(b < 1 ? 1 : (b > 132 * 32 ? 132 * 32 : b));
}

#define LAUNCH(kernel, count, ...) kernel<<<blocks(count), TPB, 0, st>>>(__VA_ARGS__)

// The conv tiles' grid: (chunks of TILE_PTS points, samples); the last chunk
// may be ragged.
static dim3 tiles(const Net& n) { return dim3((n.M + TILE_PTS - 1) / TILE_PTS, n.S); }

// k_conv2_back's dynamic shared memory: W_s and one unpooled δ map (30.3 KB),
// twice that with the tangent's (60.7 KB, above the 48 KB default).
#define CB_SMEM ((W2N + DMAP) * (int)sizeof(float))

static cudaError_t set_smem_limits() {
  return cudaFuncSetAttribute(k_conv2_back<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              2 * CB_SMEM);
}

// A strided batched operand: element (b, r, c) at p[b·sb + r·sr + c·sc],
// optionally zeroed where mask ≤ 0.
struct Mat {
  const float *p, *mask;
  long long sb, sr, sc;
};

// O = A·B (+ A2·B2, where A2.p is given: the same strides as A and B)
// (+ bias), masked by omask.
static void gemm(cudaStream_t st, int batch, int R, int C, int K, Mat A, Mat B, Mat A2, Mat B2,
                 float* O, long long ob, long long orr, long long oc, const float* bias,
                 long long biasb, const float* omask) {
  GemmArgs g{R, C, K, A2.p ? 2 : 1, {A.p, A2.p}, {A.mask, A2.mask}, A.sb, A.sr, A.sc,
             {B.p, B2.p}, {B.mask, B2.mask}, B.sb, B.sr, B.sc, O, ob, orr, oc, bias, biasb, omask};
  dim3 grid((C + GBN - 1) / GBN, (R + GBM - 1) / GBM, batch);
  k_gemm<<<grid, GTHREADS, 0, st>>>(g);
}

// The fc layers l = 2, 3, 4: input act (S, M, in) (pre-activation, relu'd),
// output (S, M, out), sampled weights th (S, out, in), biases (S, out).
struct Fc {
  int in, out;
  const float *W, *b;   // θ
  const float *Wd, *bd; // θ̇
};

static Fc fc(const Net& n, const float* th, const float* thd, int l) {
  const int in = l == 2 ? n.F0 : l == 3 ? n.F1 : n.F2;
  const int out = n.nb[l];
  const int wo = n.toff[l], bo = n.toff[l] + n.S * n.nw[l];
  return Fc{in, out, th + wo, th + bo, thd ? thd + wo : nullptr, thd ? thd + bo : nullptr};
}

static Mat act(const Net& n, const float* x, const float* mask, int width) {
  return Mat{x, mask, (long long)n.M * width, width, 1};
}

// out (S, M, o) = [relu-masked] x · Wᵀ (+ x2 · W2ᵀ) (+ bias)
static void fc_fwd(const Net& n, cudaStream_t st, const Fc& f, Mat x, const float* W,
                   float* out, const float* bias, Mat x2 = Mat{}, const float* W2 = nullptr) {
  const long long wb = (long long)f.out * f.in;
  gemm(st, n.S, n.M, f.out, f.in, x, Mat{W, nullptr, wb, 1, f.in}, x2,
       Mat{W2, nullptr, wb, 1, f.in}, out, (long long)n.M * f.out, f.out, 1, bias, f.out,
       nullptr);
}

// out (S, M, in) = (d (S, M, o) · W (o, in) (+ d2 · W2)), masked by omask
static void fc_bwd(const Net& n, cudaStream_t st, const Fc& f, const float* d, const float* W,
                   float* out, const float* omask, const float* d2 = nullptr,
                   const float* W2 = nullptr) {
  const long long wb = (long long)f.out * f.in;
  gemm(st, n.S, n.M, f.in, f.out, act(n, d, nullptr, f.out), Mat{W, nullptr, wb, f.in, 1},
       d2 ? act(n, d2, nullptr, f.out) : Mat{}, Mat{W2, nullptr, wb, f.in, 1}, out,
       (long long)n.M * f.in, f.in, 1, nullptr, 0, omask);
}

// G (S, o, in) = dᵀ (o × M) · x (M × in) (+ d2ᵀ · x2)
static void fc_wgrad(const Net& n, cudaStream_t st, const Fc& f, const float* d, Mat x,
                     float* G, const float* d2 = nullptr, Mat x2 = Mat{}) {
  const long long db = (long long)n.M * f.out;
  gemm(st, n.S, f.out, f.in, n.M, Mat{d, nullptr, db, 1, f.out}, x,
       d2 ? Mat{d2, nullptr, db, 1, f.out} : Mat{}, x2, G, (long long)f.out * f.in, f.in, 1,
       nullptr, 0, nullptr);
}

// Iteration forward and first-order gradient at p: θ, activations, nll, δ's
// and the per-sample gradients G.
static void forward_backward(const Net& n, const Work& w, const float* p, const float* et,
                             const float* u, const int* y, const float* cw, cudaStream_t st) {
  const long long SM = (long long)n.S * n.M;
  LAUNCH(k_sample, n.E, n, p, nullptr, et, w.theta);
  k_conv1<false><<<tiles(n), C1_THREADS, 0, st>>>(n, u, w.theta, nullptr, w.par1, w.p1, nullptr);
  k_conv2<false><<<tiles(n), C2_THREADS, 0, st>>>(n, w.p1, nullptr, w.theta, nullptr, w.par2,
                                                   w.p2, nullptr);
  const Fc f1 = fc(n, w.theta, nullptr, 2), f2 = fc(n, w.theta, nullptr, 3),
           f3 = fc(n, w.theta, nullptr, 4);
  fc_fwd(n, st, f1, act(n, w.p2, w.p2, n.F0), f1.W, w.z1, f1.b);
  fc_fwd(n, st, f2, act(n, w.z1, w.z1, n.F1), f2.W, w.z2, f2.b);
  fc_fwd(n, st, f3, act(n, w.z2, w.z2, n.F2), f3.W, w.z3, f3.b);
  LAUNCH(k_head, SM, n, w.z3, nullptr, y, cw, w.nll, w.d3, nullptr, nullptr);
  fc_bwd(n, st, f3, w.d3, f3.W, w.d2, w.z2);
  fc_bwd(n, st, f2, w.d2, f2.W, w.d1, w.z1);
  fc_bwd(n, st, f1, w.d1, f1.W, w.dp2, w.p2);
  k_conv2_back<false><<<tiles(n), CB_THREADS, CB_SMEM, st>>>(n, w.dp2, nullptr, w.par2, w.theta,
                                                               nullptr, w.p1, w.dp1);
  k_conv2_wpart<false><<<tiles(n), WP_THREADS, 0, st>>>(n, w.dp2, nullptr, w.par2, w.p1,
                                                         nullptr, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[1], n, w.part, n.nw[1], w.G + n.toff[1]);
  k_conv1_wpart<<<tiles(n), W1_THREADS, 0, st>>>(n, w.dp1, w.par1, u, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[0], n, w.part, n.nw[0], w.G + n.toff[0]);
  fc_wgrad(n, st, f1, w.d1, act(n, w.p2, w.p2, n.F0), w.G + n.toff[2]);
  fc_wgrad(n, st, f2, w.d2, act(n, w.z1, w.z1, n.F1), w.G + n.toff[3]);
  fc_wgrad(n, st, f3, w.d3, act(n, w.z2, w.z2, n.F2), w.G + n.toff[4]);
  k_bias<<<n.S * n_biases(n), TPB, 0, st>>>(n, w.dp1, w.dp2, w.d1, w.d2, w.d3, w.G);
}

// The tangent of forward_backward in direction θ̇ (w.thetad): activations'
// and δ's tangents, ∂/∂cw per (s, m) in cwd, and the tangent per-sample
// gradients Gd.
static void tangent(const Net& n, const Work& w, const float* u, const int* y, const float* cw,
                    cudaStream_t st) {
  const long long SM = (long long)n.S * n.M;
  k_conv1<true><<<tiles(n), C1_THREADS, 0, st>>>(n, u, w.theta, w.thetad, w.par1, nullptr, w.p1d);
  k_conv2<true><<<tiles(n), C2_THREADS, 0, st>>>(n, w.p1, w.p1d, w.theta, w.thetad, w.par2,
                                                  nullptr, w.p2d);
  const Fc f1 = fc(n, w.theta, w.thetad, 2), f2 = fc(n, w.theta, w.thetad, 3),
           f3 = fc(n, w.theta, w.thetad, 4);
  // ż = ȧ·Wᵀ + a·Ẇᵀ + ḃ, ȧ the tangent masked by the pre-activation
  fc_fwd(n, st, f1, act(n, w.p2d, w.p2, n.F0), f1.W, w.z1d, f1.bd, act(n, w.p2, w.p2, n.F0),
         f1.Wd);
  fc_fwd(n, st, f2, act(n, w.z1d, w.z1, n.F1), f2.W, w.z2d, f2.bd, act(n, w.z1, w.z1, n.F1),
         f2.Wd);
  fc_fwd(n, st, f3, act(n, w.z2d, w.z2, n.F2), f3.W, w.z3d, f3.bd, act(n, w.z2, w.z2, n.F2),
         f3.Wd);
  LAUNCH(k_head, SM, n, w.z3, w.z3d, y, cw, nullptr, nullptr, w.d3d, w.cwd);
  // δ̇_in = (δ̇·W + δ·Ẇ)·mask
  fc_bwd(n, st, f3, w.d3d, f3.W, w.d2d, w.z2, w.d3, f3.Wd);
  fc_bwd(n, st, f2, w.d2d, f2.W, w.d1d, w.z1, w.d2, f2.Wd);
  fc_bwd(n, st, f1, w.d1d, f1.W, w.dp2d, w.p2, w.d1, f1.Wd);
  k_conv2_back<true><<<tiles(n), CB_THREADS, 2 * CB_SMEM, st>>>(n, w.dp2d, w.dp2, w.par2, w.theta,
                                                                  w.thetad, w.p1, w.dp1d);
  // Ġ = δ̇ᵀ·a + δᵀ·ȧ
  k_conv2_wpart<true><<<tiles(n), WP_THREADS, 0, st>>>(n, w.dp2d, w.dp2, w.par2, w.p1, w.p1d,
                                                        w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[1], n, w.part, n.nw[1], w.Gd + n.toff[1]);
  k_conv1_wpart<<<tiles(n), W1_THREADS, 0, st>>>(n, w.dp1d, w.par1, u, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[0], n, w.part, n.nw[0], w.Gd + n.toff[0]);
  fc_wgrad(n, st, f1, w.d1d, act(n, w.p2, w.p2, n.F0), w.Gd + n.toff[2], w.d1,
           act(n, w.p2d, w.p2, n.F0));
  fc_wgrad(n, st, f2, w.d2d, act(n, w.z1, w.z1, n.F1), w.Gd + n.toff[3], w.d2,
           act(n, w.z1d, w.z1, n.F1));
  fc_wgrad(n, st, f3, w.d3d, act(n, w.z2, w.z2, n.F2), w.Gd + n.toff[4], w.d3,
           act(n, w.z2d, w.z2, n.F2));
  k_bias<<<n.S * n_biases(n), TPB, 0, st>>>(n, w.dp1d, w.dp2d, w.d1d, w.d2d, w.d3d, w.Gd);
}

extern "C" int psvi_lenet_workspace(const int* dims, int rev, long long* sizes) {
  Net n;
  const double hyper[6] = {1, 1, 0.9, 0.999, 1e-8, 0};
  if (make_net(&n, dims, hyper)) return 1;
  Work w;
  carve(n, rev, nullptr, nullptr, &w, &sizes[0], &sizes[1]);
  return 0;
}

extern "C" int psvi_lenet_fwd(const float* p0, const float* u, const int* y, const float* v,
                              const float* alpha, const float* eps, float* losses, float* hist,
                              float* cw, float* wsf, uint8_t* wsb, const int* dims,
                              const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper)) return (int)cudaErrorInvalidValue;
  Work w;
  carve(n, 0, wsf, wsb, &w, nullptr, nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  const long long P = n.P;
  cudaMemcpyAsync(hist, p0, P * sizeof(float), cudaMemcpyDeviceToDevice, st);
  cudaMemsetAsync(hist + P, 0, 2 * P * sizeof(float), st);
  k_core_weights<<<1, RED, 0, st>>>(n, v, alpha, cw);
  for (int t = 1; t <= n.T; ++t) {
    const float* p = hist + (t - 1) * 3 * P;
    float* p1 = hist + t * 3 * P;
    const float* et = eps + (long long)(t - 1) * n.E;
    forward_backward(n, w, p, et, u, y, cw, st);
    LAUNCH(k_adam, n.J, n, t, p, p + P, p + 2 * P, w.G, et, p1, p1 + P, p1 + 2 * P);
    k_loss<<<1, RED, 0, st>>>(n, w.nll, cw, p, losses, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int psvi_lenet_rev(const float* hist, const float* pbar_in, const float* dlosses,
                              const float* u, const int* y, const float* v, const float* alpha,
                              const float* eps, float* pbar, float* ubar, float* g_v,
                              float* g_alpha, float* wsf, uint8_t* wsb, const int* dims,
                              const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper)) return (int)cudaErrorInvalidValue;
  Work w;
  carve(n, 1, wsf, wsb, &w, nullptr, nullptr);
  const cudaError_t se = set_smem_limits();
  if (se != cudaSuccess) return (int)se;
  cudaStream_t st = (cudaStream_t)stream;
  const long long P = n.P;
  cudaMemcpyAsync(pbar, pbar_in, P * sizeof(float), cudaMemcpyDeviceToDevice, st);
  cudaMemsetAsync(w.mbar, 0, P * sizeof(float), st);
  cudaMemsetAsync(w.nbar, 0, P * sizeof(float), st);
  cudaMemsetAsync(ubar, 0, (size_t)n.M * n.H * n.H * sizeof(float), st);
  cudaMemsetAsync(w.cwbar, 0, n.M * sizeof(float), st);
  k_core_weights<<<1, RED, 0, st>>>(n, v, alpha, w.cw);
  for (int t = n.T; t >= 1; --t) {
    const float* p = hist + (t - 1) * 3 * P;
    const float* et = eps + (long long)(t - 1) * n.E;
    forward_backward(n, w, p, et, u, y, w.cw, st);
    LAUNCH(k_adam_vjp, n.J, n, t, p, p + P, p + 2 * P, w.G, et, pbar, w.mbar, w.nbar, w.gbar);
    LAUNCH(k_sample, n.E, n, p, w.gbar, et, w.thetad);
    tangent(n, w, u, y, w.cw, st);
    LAUNCH(k_hvp, n.J, n, t, p, w.G, w.Gd, et, w.gbar, dlosses, pbar);
    k_ubar_part<<<dim3(n.M, n.S), UB_THREADS, 0, st>>>(n, t, w.dp1d, w.dp1, w.par1, w.theta,
                                                       w.thetad, dlosses, w.part);
    LAUNCH(k_ubar_sum, (long long)n.M * LH * LH, n, w.part, ubar);
    LAUNCH(k_cwbar, n.M, n, t, w.cwd, w.nll, dlosses, w.cwbar);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k_cw_vjp<<<1, RED, 0, st>>>(n, w.cwbar, w.cw, v, alpha, g_v, g_alpha);
  return (int)cudaGetLastError();
}
