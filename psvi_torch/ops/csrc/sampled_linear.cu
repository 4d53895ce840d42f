// Kernel B3: the fused S-sample variational dense forward, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of psvi_tpu/ops/pallas_vi.py::sampled_linear:
// _fwd_kernel (pallas_vi.py:57), launched by _sampled_linear_pallas
// (pallas_call at pallas_vi.py:84). For every sample s,
//
//   W_s = mu_w + softplus(rho_w) * eps_w[s],   b_s = mu_b + softplus(rho_b) * eps_b[s]
//   y[s] = x[s] . W_s^T + b_s
//
// with x (S, N, Din), mu_w/rho_w (Dout, Din), mu_b/rho_b (Dout), eps_w
// (S, Dout, Din), eps_b (S, Dout), y (S, N, Dout), all fp32 and row-major.
// The plain PyTorch version with the same math is sampled_linear_reference in
// ../sampled_linear.py; the backward stays in torch products there, as JAX
// computes its _bwd in XLA outside any kernel.
//
// What bounds it on this card: operations. At the LeNet main path (N = M + B
// = 356, S = 10) fc1 (400 -> 120) is 2*S*N*Din*Dout = 0.342 GFLOP, 5.1 us at
// 67 TFLOP/s fp32, against 9.7 MB of inputs and output, 2.9 us at 3.35 TB/s;
// fc2 (120 -> 84) is bound by operations too, fc3 (84 -> 10) by bytes (its
// noise and x rows). The sampling itself is a few operations per weight.
//
// What the design does about it, simply: the sampled weights W_s are never
// written to device memory. Each block owns one 64 x 64 tile of y[s] (64
// points by 64 outputs) and walks Din in chunks of 16: it stages the x chunk
// and builds the W_s chunk, mu_w + softplus(rho_w) * eps_w[s], in shared
// memory, then each of its 256 threads accumulates a 4 x 4 register
// micro-tile with fp32 FMA. The epilogue adds the sampled bias. Ragged edges
// (N, Din, Dout not multiples of the tile) are masked with zeros on load and
// skipped on store. Each output is one fixed-order chain of FMAs over Din and
// there are no atomics, so a rerun gives the same bits. No TF32 and no tensor
// cores: the port holds true fp32 (psvi_torch/device.py). Left for later:
// wgmma (which needs a TF32 or split-bf16 design that keeps fp32 accuracy),
// cp.async or TMA double buffering, and tiles sized to the narrow layers
// (fc3's Dout = 10 leaves most of a 64-wide tile idle).
//
// The C entry allocates nothing, launches on the given stream and returns the
// launch error, or 0.

#include <cuda_runtime.h>
#include <math.h>

constexpr int BN = 64;  // points (rows of x) per block
constexpr int BO = 64;  // outputs per block
constexpr int BK = 16;  // Din chunk staged in shared memory
constexpr int TN = 4;   // micro-tile rows per thread
constexpr int TO = 4;   // micro-tile outputs per thread
constexpr int THREADS = (BN / TN) * (BO / TO);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned and spreads the banks

static __device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(THREADS)
k_sampled_linear(const float* __restrict__ x, const float* __restrict__ mu_w,
                 const float* __restrict__ rho_w, const float* __restrict__ mu_b,
                 const float* __restrict__ rho_b, const float* __restrict__ eps_w,
                 const float* __restrict__ eps_b, float* __restrict__ y, int N, int Din,
                 int Dout) {
  // both tiles transposed, k-major: xs[k][n], ws[k][o]
  __shared__ __align__(16) float xs[BK][BN + PAD];
  __shared__ __align__(16) float ws[BK][BO + PAD];
  const int s = blockIdx.z, n0 = blockIdx.y * BN, o0 = blockIdx.x * BO;
  const int tid = threadIdx.x;
  const int tn = tid / (BO / TO), to = tid % (BO / TO);
  const float* xg = x + (long long)s * N * Din;
  const float* eg = eps_w + (long long)s * Dout * Din;
  float acc[TN][TO];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Din; k0 += BK) {
    // neighbouring threads read neighbouring k of one row (coalesced)
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, n = n0 + r, k = k0 + kk;
      xs[kk][r] = (n < N && k < Din) ? xg[(long long)n * Din + k] : 0.f;
    }
    for (int e = tid; e < BO * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, o = o0 + r, k = k0 + kk;
      float w = 0.f;
      if (o < Dout && k < Din) {
        const long long i = (long long)o * Din + k;
        w = mu_w[i] + softplus_f(rho_w[i]) * eg[i];
      }
      ws[kk][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tn * TN]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][to * TO]);
      const float av[TN] = {a.x, a.y, a.z, a.w};
      const float bv[TO] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TO; ++j) {
    const int o = o0 + to * TO + j;
    if (o >= Dout) continue;
    const float bias = mu_b[o] + softplus_f(rho_b[o]) * eps_b[(long long)s * Dout + o];
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int n = n0 + tn * TN + i;
      if (n < N) y[((long long)s * N + n) * Dout + o] = acc[i][j] + bias;
    }
  }
}

extern "C" int psvi_sampled_linear(const float* x, const float* mu_w, const float* rho_w,
                                   const float* mu_b, const float* rho_b, const float* eps_w,
                                   const float* eps_b, float* y, int S, int N, int Din,
                                   int Dout, void* stream) {
  if (S <= 0 || N <= 0 || Dout <= 0) return 0;
  const dim3 grid((Dout + BO - 1) / BO, (N + BN - 1) / BN, S);
  k_sampled_linear<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b, y, N, Din, Dout);
  return static_cast<int>(cudaGetLastError());
}
