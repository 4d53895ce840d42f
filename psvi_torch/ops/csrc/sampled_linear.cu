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
// What bounds it on this card: bytes. At the LeNet main path (N = M + B =
// 356, S = 10) fc1 (400 -> 120) is 2*S*N*Din*Dout = 0.342 GFLOP, run as three
// TF32 passes on the tensor cores, 2.07 us at 495 TFLOP/s, against 9.7 MB of
// inputs and output, 2.9 us at 3.35 TB/s; fc2 (120 -> 84) and fc3 (84 -> 10)
// are bound by bytes too (their noise and x rows). The sampling itself is a
// few operations per weight.
//
// What the design does about it: the block and the product loop of
// sampled_linear_gemm.cuh, which B4a's k_prng_fwd shares. A block owns
// (sample, 32 outputs, a split of N from _fwd_plan in ../sampled_linear.py),
// builds its tile of W_s = mu_w + softplus(rho_w) * eps_w[s] and of b_s once
// in shared memory, reading mu, rho and eps once a block (16-byte loads,
// four of each in flight a thread; no cluster: the blocks of a split read
// the same tile from L2), and never writes the sampled weights to device
// memory; x streams through a cp.async ring, and the product runs as 3xTF32
// mma.sync on the tensor cores with fp32 accumulation. This corrected
// product is allowed here, on a first-order once_differentiable op, and
// only on B3 and B4a (psvi_torch/device.py): it holds the gate of 1e-5 *
// max|ref| against the plain fp32 version, which one TF32 pass does not.
// Each output is one fixed-order chain of mma's and adds and there are no
// atomics, so a rerun gives the same bits.
//
// The C entry allocates nothing, launches on the given stream and returns the
// launch error, or 0.

#include <cuda_runtime.h>
#include <math.h>

#include "sampled_linear_gemm.cuh"

using slgemm::THREADS;

// W_s's tile from mu_w, rho_w and eps_w[s]; neighbouring threads on
// neighbouring columns of a row. Where all three have rows of 4k floats,
// 16-byte aligned, by 16-byte loads, four of each a thread in flight (their
// latency, not their bytes, bounds the build); else four floats a thread.
struct ReadW {
  const float* mu_w;
  const float* rho_w;
  const float* eps_w;
  int Din, Dout, vec;

  __device__ __forceinline__ void operator()(float* ws, int ldw, int s, int k0, int cols,
                                             int rows) const {
    const int o0 = blockIdx.x * slgemm::BO;
    const float* eg = eps_w + (long long)s * Dout * Din;
    if (vec) {  // Din % 4 == 0, so a 4-float group lies inside [0, Din) or outside it
      const int q = cols / 4, n = rows * q;
      for (int v0 = threadIdx.x; v0 < n; v0 += 4 * THREADS) {
        float4 m[4], r[4], e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = v0 + u * THREADS, o = o0 + v / q, k = k0 + 4 * (v % q);
          m[u] = r[u] = e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (v < n && o < Dout && k < Din) {
            const long long i = (long long)o * Din + k;
            m[u] = *reinterpret_cast<const float4*>(mu_w + i);
            r[u] = *reinterpret_cast<const float4*>(rho_w + i);
            e[u] = *reinterpret_cast<const float4*>(eg + i);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = v0 + u * THREADS, o = o0 + v / q;
          if (v >= n) continue;
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (o < Dout) {
            w = make_float4(m[u].x + softplus_f(r[u].x) * e[u].x,
                            m[u].y + softplus_f(r[u].y) * e[u].y,
                            m[u].z + softplus_f(r[u].z) * e[u].z,
                            m[u].w + softplus_f(r[u].w) * e[u].w);
          }
          *reinterpret_cast<float4*>(ws + (v / q) * ldw + 4 * (v % q)) = w;
        }
      }
      return;
    }
    const int n = rows * cols;
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * THREADS) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS, r = e / cols, c = e % cols, o = o0 + r, k = k0 + c;
        if (e >= n) continue;
        float w = 0.f;
        if (o < Dout && k < Din) {
          const long long i = (long long)o * Din + k;
          w = mu_w[i] + softplus_f(rho_w[i]) * eg[i];
        }
        ws[r * ldw + c] = w;
      }
    }
  }
};

struct ReadB {
  const float* mu_b;
  const float* rho_b;
  const float* eps_b;
  int Dout;

  __device__ __forceinline__ void operator()(float* bs, int s) const {
    const int r = threadIdx.x, o = blockIdx.x * slgemm::BO + r;
    if (r < slgemm::BO) {
      bs[r] = o < Dout ? mu_b[o] + softplus_f(rho_b[o]) * eps_b[(long long)s * Dout + o] : 0.f;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
k_sampled_linear(const float* __restrict__ x, const float* __restrict__ mu_w,
                 const float* __restrict__ rho_w, const float* __restrict__ mu_b,
                 const float* __restrict__ rho_b, const float* __restrict__ eps_w,
                 const float* __restrict__ eps_b, float* __restrict__ y, int S, int N, int Din,
                 int Dout, int n_splits, int x_vec, int w_vec) {
  extern __shared__ float4 w_dyn[];
  slgemm::sampled_fwd_block(x, y, reinterpret_cast<float*>(w_dyn), S, N, Din, Dout, n_splits,
                            x_vec != 0, ReadW{mu_w, rho_w, eps_w, Din, Dout, w_vec},
                            ReadB{mu_b, rho_b, eps_b, Dout});
}

// n_splits: _fwd_plan's splits of N (1 <= n_splits <= ceil(N / 64)).
extern "C" int psvi_sampled_linear(const float* x, const float* mu_w, const float* rho_w,
                                   const float* mu_b, const float* rho_b, const float* eps_w,
                                   const float* eps_b, float* y, int S, int N, int Din,
                                   int Dout, int n_splits, void* stream) {
  if (S <= 0 || N <= 0 || Dout <= 0) return 0;
  if (n_splits < 1 || n_splits > slgemm::cdiv(N, slgemm::BN)) return cudaErrorInvalidValue;
  const int smem = slgemm::smem_bytes(Din, Dout);
  const cudaError_t err = slgemm::allow_smem(k_sampled_linear, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(slgemm::cdiv(Dout, slgemm::BO), n_splits, S < 65535 ? S : 65535);
  k_sampled_linear<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b, y, S, N, Din, Dout, n_splits,
      static_cast<int>(rows_of_float4(x, Din)),
      static_cast<int>(rows_of_float4(mu_w, Din) && rows_of_float4(rho_w, Din) &&
                       rows_of_float4(eps_w, Din)));
  return static_cast<int>(cudaGetLastError());
}
