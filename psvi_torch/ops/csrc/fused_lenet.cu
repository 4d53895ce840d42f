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
// What the design does about it, simply: each C entry loops over t on the
// host and issues a fixed sequence of kernels on the given stream, each with
// one thread per output (S·M·K1·14² = 1.18 M threads for conv1+pool1 at the
// flagship), so every phase fills the 132 SMs. The fc layers and their
// backward and weight gradients go through one shared-memory-tiled fp32 GEMM,
// batched over S. Reductions over S and M are a fixed-order second pass (per-
// (sample, point) partials, then a sum per output, or one block per bias and
// a block sum), never float atomics, so a rerun gives the same bits. Every product is fp32 FMA on CUDA cores: no
// TF32, no tensor cores (one bf16 pass collapsed the u-hypergradient on the
// TPU). Left for later: tensor cores (wgmma) for the convs and the GEMM,
// fusing the ~20 launches of a forward iteration (~50 of a reverse one), and a
// CUDA graph over the host loop.
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
#define TILE 16
#define RED 1024

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

// conv1 (one input channel, 'same' padding) at pooled position (i, j) and
// parity par: Σ_{dy,dx} u[2i+a+dy-pad, 2j+b+dx-pad]·w[dy, dx].
__device__ __forceinline__ float conv1_at(const Net& n, const float* um, const float* w, int i,
                                          int j, int par) {
  const int a = par >> 1, b = par & 1;
  float acc = 0.f;
  for (int dy = 0; dy < n.k; ++dy) {
    const int y = 2 * i + a + dy - n.pad;
    if (y < 0 || y >= n.H) continue;
    for (int dx = 0; dx < n.k; ++dx) {
      const int x = 2 * j + b + dx - n.pad;
      if (x < 0 || x >= n.H) continue;
      acc = fmaf(um[y * n.H + x], w[dy * n.k + dx], acc);
    }
  }
  return acc;
}

// conv1 + pool1 + bias: p1 = max over parities + b, winner in par1. With thd
// given, the tangent at the stored winner: out = conv(u, Ẇ) + ḃ.
__global__ void __launch_bounds__(TPB)
k_conv1(Net n, const float* __restrict__ u, const float* __restrict__ th,
        const float* __restrict__ thd, uint8_t* par1, float* p1, float* out) {
  const int PP = n.P1 * n.P1;
  GRID_LOOP(idx, n.S * n.M * n.K1 * PP) {
    const int pos = idx % PP, i = pos / n.P1, j = pos % n.P1;
    const int kk = (idx / PP) % n.K1, m = (idx / (PP * n.K1)) % n.M;
    const int s = idx / (PP * n.K1 * n.M);
    const float* um = u + m * n.H * n.H;
    const int wo = n.toff[0] + (s * n.K1 + kk) * n.q;
    const int bo = n.toff[0] + n.S * n.nw[0] + s * n.K1 + kk;
    if (thd) {
      out[idx] = conv1_at(n, um, thd + wo, i, j, par1[idx]) + thd[bo];
    } else {
      float best = 0.f;
      int bp = 0;
      for (int par = 0; par < 4; ++par) {
        const float c = conv1_at(n, um, th + wo, i, j, par);
        if (par == 0 || c > best) {
          best = c;
          bp = par;
        }
      }
      p1[idx] = best + th[bo];
      par1[idx] = (uint8_t)bp;
    }
  }
}

// conv2 (unpadded) at pooled position (i, j), parity par, over input maps
// a (S, M, K1, P1, P1) at (s, m): Σ_c Σ_{dy,dx} x(c, 2i+a+dy, 2j+b+dx)·w; x is
// relu(p1), or (mode 1) the masked tangent p1 > 0 ? p1d : 0.
__device__ __forceinline__ float conv2_at(const Net& n, const float* p1sm, const float* p1dsm,
                                          const float* w, int i, int j, int par) {
  const int a = par >> 1, b = par & 1, PP = n.P1 * n.P1;
  float acc = 0.f;
  for (int c = 0; c < n.K1; ++c) {
    const float* xs = p1sm + c * PP;
    const float* xd = p1dsm ? p1dsm + c * PP : nullptr;
    const float* wc = w + c * n.q;
    for (int dy = 0; dy < n.k; ++dy) {
      const int row = (2 * i + a + dy) * n.P1 + 2 * j + b;
      for (int dx = 0; dx < n.k; ++dx) {
        const float pv = xs[row + dx];
        const float x = xd ? (pv > 0.f ? xd[row + dx] : 0.f) : relu_f(pv);
        acc = fmaf(x, wc[dy * n.k + dx], acc);
      }
    }
  }
  return acc;
}

// conv2 + pool2 + bias: p2 (S, M, K2·P2²) = max over parities + b, winner in
// par2. With thd given, the tangent at the winner:
// out = conv(ȧ1, W) + conv(a1, Ẇ) + ḃ.
__global__ void __launch_bounds__(TPB)
k_conv2(Net n, const float* __restrict__ p1, const float* __restrict__ p1d,
        const float* __restrict__ th, const float* __restrict__ thd, uint8_t* par2, float* p2,
        float* out) {
  const int PP = n.P2 * n.P2, PP1 = n.P1 * n.P1;
  GRID_LOOP(idx, n.S * n.M * n.K2 * PP) {
    const int pos = idx % PP, i = pos / n.P2, j = pos % n.P2;
    const int kk = (idx / PP) % n.K2, sm = idx / (PP * n.K2), s = sm / n.M;
    const float* x = p1 + sm * n.K1 * PP1;
    const int wo = n.toff[1] + (s * n.K2 + kk) * n.K1 * n.q;
    const int bo = n.toff[1] + n.S * n.nw[1] + s * n.K2 + kk;
    if (thd) {
      const int par = par2[idx];
      out[idx] = conv2_at(n, x, p1d + sm * n.K1 * PP1, th + wo, i, j, par) +
                 conv2_at(n, x, nullptr, thd + wo, i, j, par) + thd[bo];
    } else {
      float best = 0.f;
      int bp = 0;
      for (int par = 0; par < 4; ++par) {
        const float c = conv2_at(n, x, nullptr, th + wo, i, j, par);
        if (par == 0 || c > best) {
          best = c;
          bp = par;
        }
      }
      p2[idx] = best + th[bo];
      par2[idx] = (uint8_t)bp;
    }
  }
}

// Batched fp32 GEMM, one 16×16 output tile per block through shared memory:
// O[b](r, c) = Σ_k A[b](r, k)·B[b](k, c) (+ O if acc) (+ bias[b](c)), then
// zeroed where the output mask is ≤ 0. An operand mask zeroes an operand
// entry where the mask (same strides) is ≤ 0: relu(x) is x masked by x.
struct GemmArgs {
  int R, C, K;
  const float *A, *Am;
  long long Ab, Ar, Ak;
  const float *B, *Bm;
  long long Bb, Bk, Bc;
  float* O;
  long long Ob, Or, Oc;
  const float* bias;
  long long biasb;
  const float* Om;
  int acc;
};

__global__ void __launch_bounds__(TILE* TILE) k_gemm(GemmArgs g) {
  __shared__ float As[TILE][TILE + 1], Bs[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const float* A = g.A + b * g.Ab;
  const float* Am = g.Am ? g.Am + b * g.Ab : nullptr;
  const float* B = g.B + b * g.Bb;
  const float* Bm = g.Bm ? g.Bm + b * g.Bb : nullptr;
  // load along the operand's contiguous axis
  const int ar = g.Ar == 1 ? tx : ty, ak = g.Ar == 1 ? ty : tx;
  const int bk = g.Bk == 1 ? tx : ty, bc = g.Bk == 1 ? ty : tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += TILE) {
    {
      const int r = r0 + ar, k = k0 + ak;
      float a = 0.f;
      if (r < g.R && k < g.K) {
        const long long o = r * g.Ar + k * g.Ak;
        a = A[o];
        if (Am && !(Am[o] > 0.f)) a = 0.f;
      }
      As[ar][ak] = a;
    }
    {
      const int k = k0 + bk, c = c0 + bc;
      float x = 0.f;
      if (k < g.K && c < g.C) {
        const long long o = k * g.Bk + c * g.Bc;
        x = B[o];
        if (Bm && !(Bm[o] > 0.f)) x = 0.f;
      }
      Bs[bk][bc] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) acc = fmaf(As[ty][kk], Bs[kk][tx], acc);
    __syncthreads();
  }
  const int r = r0 + ty, c = c0 + tx;
  if (r < g.R && c < g.C) {
    const long long o = b * g.Ob + r * g.Or + c * g.Oc;
    float val = acc;
    if (g.acc) val += g.O[o];
    if (g.bias) val += g.bias[b * g.biasb + c];
    if (g.Om && !(g.Om[o] > 0.f)) val = 0.f;
    g.O[o] = val;
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

// Back through conv2 + pool2 to the pooled conv1 map, a gather over the
// conv2 outputs each input feeds (only pool winners carry δ):
// out = (p1 > 0)·Σ_k Σ_{dy,dx} [dA·W (+ dB·Ẇ)] at conv2 output (y−dy, x−dx).
__global__ void __launch_bounds__(TPB)
k_conv2_back(Net n, const float* __restrict__ dA, const float* __restrict__ dB,
             const uint8_t* __restrict__ par2, const float* __restrict__ th,
             const float* __restrict__ thd, const float* __restrict__ p1, float* out) {
  const int PP1 = n.P1 * n.P1, PP2 = n.P2 * n.P2;
  GRID_LOOP(idx, n.S * n.M * n.K1 * PP1) {
    if (!(p1[idx] > 0.f)) {
      out[idx] = 0.f;
      continue;
    }
    const int pos = idx % PP1, yy = pos / n.P1, xx = pos % n.P1;
    const int c = (idx / PP1) % n.K1, sm = idx / (PP1 * n.K1), s = sm / n.M;
    const float* W = th + n.toff[1] + s * n.nw[1];
    const float* Wd = thd ? thd + n.toff[1] + s * n.nw[1] : nullptr;
    float acc = 0.f;
    for (int kk = 0; kk < n.K2; ++kk) {
      const int qb = (sm * n.K2 + kk) * PP2;
      for (int dy = 0; dy < n.k; ++dy) {
        const int oy = yy - dy;
        if (oy < 0 || oy >= n.H2) continue;
        for (int dx = 0; dx < n.k; ++dx) {
          const int ox = xx - dx;
          if (ox < 0 || ox >= n.H2) continue;
          const int q = qb + (oy >> 1) * n.P2 + (ox >> 1);
          if (par2[q] != (((oy & 1) << 1) | (ox & 1))) continue;
          const int w = ((kk * n.K1 + c) * n.k + dy) * n.k + dx;
          acc = fmaf(dA[q], W[w], acc);
          if (dB) acc = fmaf(dB[q], Wd[w], acc);
        }
      }
    }
    out[idx] = acc;
  }
}

// conv2 weight gradient per (sample, point): part[(s,m), w] =
// Σ_{i,j} dA·a1 (+ dB·ȧ1) at the winner's input position, a1 = relu(p1),
// ȧ1 = p1 > 0 ? p1d : 0.
__global__ void __launch_bounds__(TPB)
k_conv2_wpart(Net n, const float* __restrict__ dA, const float* __restrict__ dB,
              const uint8_t* __restrict__ par2, const float* __restrict__ p1,
              const float* __restrict__ p1d, float* part) {
  const int nw = n.nw[1], PP1 = n.P1 * n.P1, PP2 = n.P2 * n.P2;
  GRID_LOOP(idx, n.S * n.M * nw) {
    const int w = idx % nw, sm = idx / nw;
    const int dx = w % n.k, dy = (w / n.k) % n.k, c = (w / n.q) % n.K1, kk = w / (n.q * n.K1);
    const float* x = p1 + (sm * n.K1 + c) * PP1;
    const float* xd = dB ? p1d + (sm * n.K1 + c) * PP1 : nullptr;
    const int qb = (sm * n.K2 + kk) * PP2;
    float acc = 0.f;
    for (int i = 0; i < n.P2; ++i) {
      for (int j = 0; j < n.P2; ++j) {
        const int q = qb + i * n.P2 + j, par = par2[q];
        const int at = (2 * i + (par >> 1) + dy) * n.P1 + 2 * j + (par & 1) + dx;
        const float pv = x[at];
        acc = fmaf(dA[q], relu_f(pv), acc);
        if (dB && pv > 0.f) acc = fmaf(dB[q], xd[at], acc);
      }
    }
    part[idx] = acc;
  }
}

// conv1 weight gradient per (sample, point): part[(s,m), w] =
// Σ_{i,j} dA·u at the winner's input position (u carries no tangent).
__global__ void __launch_bounds__(TPB)
k_conv1_wpart(Net n, const float* __restrict__ dA, const uint8_t* __restrict__ par1,
              const float* __restrict__ u, float* part) {
  const int nw = n.nw[0], PP1 = n.P1 * n.P1;
  GRID_LOOP(idx, n.S * n.M * nw) {
    const int w = idx % nw, sm = idx / nw, m = sm % n.M;
    const int dx = w % n.k, dy = (w / n.k) % n.k, kk = w / n.q;
    const float* um = u + m * n.H * n.H;
    const int qb = (sm * n.K1 + kk) * PP1;
    float acc = 0.f;
    for (int i = 0; i < n.P1; ++i) {
      for (int j = 0; j < n.P1; ++j) {
        const int q = qb + i * n.P1 + j, par = par1[q];
        const int yy = 2 * i + (par >> 1) + dy - n.pad, xx = 2 * j + (par & 1) + dx - n.pad;
        if (yy < 0 || yy >= n.H || xx < 0 || xx >= n.H) continue;
        acc = fmaf(dA[q], um[yy * n.H + xx], acc);
      }
    }
    part[idx] = acc;
  }
}

// Second pass of a conv weight gradient: G[off + s·nw + w] = Σ_m part.
__global__ void __launch_bounds__(TPB)
k_reduce_m(Net n, const float* __restrict__ part, int nw, float* G) {
  GRID_LOOP(idx, n.S * nw) {
    const int s = idx / nw, w = idx % nw;
    float acc = 0.f;
    for (int m = 0; m < n.M; ++m) acc += part[(s * n.M + m) * nw + w];
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

// ū[m, y, x] += Σ_s Σ_k Σ_{dy,dx} [(δ̇ + dl·δ)·W1 + δ·Ẇ1] at the conv1 output
// (y+pad−dy, x+pad−dx) when it won its pool window: a gather, no atomics.
__global__ void __launch_bounds__(TPB)
k_ubar(Net n, int t, const float* __restrict__ dp1d, const float* __restrict__ dp1,
       const uint8_t* __restrict__ par1, const float* __restrict__ th,
       const float* __restrict__ thd, const float* __restrict__ dlosses, float* ubar) {
  const float dl = dlosses[t - 1];
  const int HH = n.H * n.H, PP1 = n.P1 * n.P1;
  GRID_LOOP(idx, n.M * HH) {
    const int m = idx / HH, yy = (idx % HH) / n.H, xx = idx % n.H;
    float acc = 0.f;
    for (int s = 0; s < n.S; ++s) {
      for (int kk = 0; kk < n.K1; ++kk) {
        const int wo = n.toff[0] + (s * n.K1 + kk) * n.q;
        const int qb = ((s * n.M + m) * n.K1 + kk) * PP1;
        for (int dy = 0; dy < n.k; ++dy) {
          const int oy = yy + n.pad - dy;
          if (oy < 0 || oy >= n.H) continue;
          for (int dx = 0; dx < n.k; ++dx) {
            const int ox = xx + n.pad - dx;
            if (ox < 0 || ox >= n.H) continue;
            const int q = qb + (oy >> 1) * n.P1 + (ox >> 1);
            if (par1[q] != (((oy & 1) << 1) | (ox & 1))) continue;
            const int w = wo + dy * n.k + dx;
            acc = fmaf(dp1d[q] + dl * dp1[q], th[w], acc);
            acc = fmaf(dp1[q], thd[w], acc);
          }
        }
      }
    }
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
      n->H2 <= 0 || n->H2 % 2 || n->F1 < 1 || n->F2 < 1)
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

// A strided batched operand: element (b, r, c) at p[b·sb + r·sr + c·sc],
// optionally zeroed where mask ≤ 0.
struct Mat {
  const float *p, *mask;
  long long sb, sr, sc;
};

static void gemm(cudaStream_t st, int batch, int R, int C, int K, Mat A, Mat B, float* O,
                 long long ob, long long orr, long long oc, const float* bias, long long biasb,
                 const float* omask, int acc) {
  GemmArgs g{R, C, K, A.p, A.mask, A.sb, A.sr, A.sc, B.p, B.mask, B.sb, B.sr, B.sc,
             O, ob, orr, oc, bias, biasb, omask, acc};
  dim3 grid((C + TILE - 1) / TILE, (R + TILE - 1) / TILE, batch);
  k_gemm<<<grid, dim3(TILE, TILE), 0, st>>>(g);
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

// out (S, M, o) = [relu-masked] x · Wᵀ (+ acc) (+ bias)
static void fc_fwd(const Net& n, cudaStream_t st, const Fc& f, Mat x, const float* W,
                   float* out, const float* bias, int acc) {
  gemm(st, n.S, n.M, f.out, f.in, x, Mat{W, nullptr, (long long)f.out * f.in, 1, f.in}, out,
       (long long)n.M * f.out, f.out, 1, bias, f.out, nullptr, acc);
}

// out (S, M, in) = d (S, M, o) · W (o, in) (+ acc), masked by omask
static void fc_bwd(const Net& n, cudaStream_t st, const Fc& f, const float* d, const float* W,
                   float* out, const float* omask, int acc) {
  gemm(st, n.S, n.M, f.in, f.out, act(n, d, nullptr, f.out),
       Mat{W, nullptr, (long long)f.out * f.in, f.in, 1}, out, (long long)n.M * f.in, f.in, 1,
       nullptr, 0, omask, acc);
}

// G (S, o, in) = dᵀ (o × M) · x (M × in) (+ acc)
static void fc_wgrad(const Net& n, cudaStream_t st, const Fc& f, const float* d, Mat x,
                     float* G, int acc) {
  gemm(st, n.S, f.out, f.in, n.M, Mat{d, nullptr, (long long)n.M * f.out, 1, f.out}, x, G,
       (long long)f.out * f.in, f.in, 1, nullptr, 0, nullptr, acc);
}

// Iteration forward and first-order gradient at p: θ, activations, nll, δ's
// and the per-sample gradients G.
static void forward_backward(const Net& n, const Work& w, const float* p, const float* et,
                             const float* u, const int* y, const float* cw, cudaStream_t st) {
  const long long SM = (long long)n.S * n.M;
  LAUNCH(k_sample, n.E, n, p, nullptr, et, w.theta);
  LAUNCH(k_conv1, SM * n.K1 * n.P1 * n.P1, n, u, w.theta, nullptr, w.par1, w.p1, nullptr);
  LAUNCH(k_conv2, SM * n.F0, n, w.p1, nullptr, w.theta, nullptr, w.par2, w.p2, nullptr);
  const Fc f1 = fc(n, w.theta, nullptr, 2), f2 = fc(n, w.theta, nullptr, 3),
           f3 = fc(n, w.theta, nullptr, 4);
  fc_fwd(n, st, f1, act(n, w.p2, w.p2, n.F0), f1.W, w.z1, f1.b, 0);
  fc_fwd(n, st, f2, act(n, w.z1, w.z1, n.F1), f2.W, w.z2, f2.b, 0);
  fc_fwd(n, st, f3, act(n, w.z2, w.z2, n.F2), f3.W, w.z3, f3.b, 0);
  LAUNCH(k_head, SM, n, w.z3, nullptr, y, cw, w.nll, w.d3, nullptr, nullptr);
  fc_bwd(n, st, f3, w.d3, f3.W, w.d2, w.z2, 0);
  fc_bwd(n, st, f2, w.d2, f2.W, w.d1, w.z1, 0);
  fc_bwd(n, st, f1, w.d1, f1.W, w.dp2, w.p2, 0);
  LAUNCH(k_conv2_back, SM * n.K1 * n.P1 * n.P1, n, w.dp2, nullptr, w.par2, w.theta, nullptr,
         w.p1, w.dp1);
  LAUNCH(k_conv2_wpart, SM * n.nw[1], n, w.dp2, nullptr, w.par2, w.p1, nullptr, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[1], n, w.part, n.nw[1], w.G + n.toff[1]);
  LAUNCH(k_conv1_wpart, SM * n.nw[0], n, w.dp1, w.par1, u, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[0], n, w.part, n.nw[0], w.G + n.toff[0]);
  fc_wgrad(n, st, f1, w.d1, act(n, w.p2, w.p2, n.F0), w.G + n.toff[2], 0);
  fc_wgrad(n, st, f2, w.d2, act(n, w.z1, w.z1, n.F1), w.G + n.toff[3], 0);
  fc_wgrad(n, st, f3, w.d3, act(n, w.z2, w.z2, n.F2), w.G + n.toff[4], 0);
  k_bias<<<n.S * n_biases(n), TPB, 0, st>>>(n, w.dp1, w.dp2, w.d1, w.d2, w.d3, w.G);
}

// The tangent of forward_backward in direction θ̇ (w.thetad): activations'
// and δ's tangents, ∂/∂cw per (s, m) in cwd, and the tangent per-sample
// gradients Gd.
static void tangent(const Net& n, const Work& w, const float* u, const int* y, const float* cw,
                    cudaStream_t st) {
  const long long SM = (long long)n.S * n.M;
  LAUNCH(k_conv1, SM * n.K1 * n.P1 * n.P1, n, u, w.theta, w.thetad, w.par1, nullptr, w.p1d);
  LAUNCH(k_conv2, SM * n.F0, n, w.p1, w.p1d, w.theta, w.thetad, w.par2, nullptr, w.p2d);
  const Fc f1 = fc(n, w.theta, w.thetad, 2), f2 = fc(n, w.theta, w.thetad, 3),
           f3 = fc(n, w.theta, w.thetad, 4);
  // ż = ȧ·Wᵀ + a·Ẇᵀ + ḃ, ȧ the tangent masked by the pre-activation
  fc_fwd(n, st, f1, act(n, w.p2d, w.p2, n.F0), f1.W, w.z1d, nullptr, 0);
  fc_fwd(n, st, f1, act(n, w.p2, w.p2, n.F0), f1.Wd, w.z1d, f1.bd, 1);
  fc_fwd(n, st, f2, act(n, w.z1d, w.z1, n.F1), f2.W, w.z2d, nullptr, 0);
  fc_fwd(n, st, f2, act(n, w.z1, w.z1, n.F1), f2.Wd, w.z2d, f2.bd, 1);
  fc_fwd(n, st, f3, act(n, w.z2d, w.z2, n.F2), f3.W, w.z3d, nullptr, 0);
  fc_fwd(n, st, f3, act(n, w.z2, w.z2, n.F2), f3.Wd, w.z3d, f3.bd, 1);
  LAUNCH(k_head, SM, n, w.z3, w.z3d, y, cw, nullptr, nullptr, w.d3d, w.cwd);
  // δ̇_in = (δ̇·W + δ·Ẇ)·mask
  fc_bwd(n, st, f3, w.d3d, f3.W, w.d2d, nullptr, 0);
  fc_bwd(n, st, f3, w.d3, f3.Wd, w.d2d, w.z2, 1);
  fc_bwd(n, st, f2, w.d2d, f2.W, w.d1d, nullptr, 0);
  fc_bwd(n, st, f2, w.d2, f2.Wd, w.d1d, w.z1, 1);
  fc_bwd(n, st, f1, w.d1d, f1.W, w.dp2d, nullptr, 0);
  fc_bwd(n, st, f1, w.d1, f1.Wd, w.dp2d, w.p2, 1);
  LAUNCH(k_conv2_back, SM * n.K1 * n.P1 * n.P1, n, w.dp2d, w.dp2, w.par2, w.theta, w.thetad,
         w.p1, w.dp1d);
  // Ġ = δ̇ᵀ·a + δᵀ·ȧ
  LAUNCH(k_conv2_wpart, SM * n.nw[1], n, w.dp2d, w.dp2, w.par2, w.p1, w.p1d, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[1], n, w.part, n.nw[1], w.Gd + n.toff[1]);
  LAUNCH(k_conv1_wpart, SM * n.nw[0], n, w.dp1d, w.par1, u, w.part);
  LAUNCH(k_reduce_m, (long long)n.S * n.nw[0], n, w.part, n.nw[0], w.Gd + n.toff[0]);
  fc_wgrad(n, st, f1, w.d1d, act(n, w.p2, w.p2, n.F0), w.Gd + n.toff[2], 0);
  fc_wgrad(n, st, f1, w.d1, act(n, w.p2d, w.p2, n.F0), w.Gd + n.toff[2], 1);
  fc_wgrad(n, st, f2, w.d2d, act(n, w.z1, w.z1, n.F1), w.Gd + n.toff[3], 0);
  fc_wgrad(n, st, f2, w.d2, act(n, w.z1d, w.z1, n.F1), w.Gd + n.toff[3], 1);
  fc_wgrad(n, st, f3, w.d3d, act(n, w.z2, w.z2, n.F2), w.Gd + n.toff[4], 0);
  fc_wgrad(n, st, f3, w.d3, act(n, w.z2d, w.z2, n.F2), w.Gd + n.toff[4], 1);
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
    LAUNCH(k_ubar, (long long)n.M * n.H * n.H, n, t, w.dp1d, w.dp1, w.par1, w.theta, w.thetad,
           dlosses, ubar);
    LAUNCH(k_cwbar, n.M, n, t, w.cwd, w.nll, dlosses, w.cwbar);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k_cw_vjp<<<1, RED, 0, st>>>(n, w.cwbar, w.cw, v, alpha, g_v, g_alpha);
  return (int)cudaGetLastError();
}
