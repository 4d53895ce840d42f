// Fused nested PSVI step for the dense mean-field family, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel psvi_tpu/ops/fused_nested.py::fused_nested_outer
// (one Pallas/Mosaic kernel that traced jax.value_and_grad of _nested_core).
// The reverse sweep that JAX derived by tracing is derived by hand here and
// split into three kernels, each a single launch per outer step:
//
//   nested_fwd    T inner iterations: sample θ = μ + softplus(ρ)·ε_t, forward
//                 the MLP on u for all S samples, NLL weighted by
//                 cw = N·f(v) plus the analytic KL, the first-order gradient
//                 by hand backprop, the torch-exact Adam step. Stores
//                 (p, m, n) for every t in a (T+1)·3·P history buffer.
//   nested_outer  the outer IW-ELBO on (u, minibatch) from paramsT and its
//                 first-order backward to p̄_T, the direct ū, c̄w and z̄.
//   nested_rev    t = T..1: Adam VJP (zero derivative of sqrt at n = 0) to
//                 ḡ_t, then forward-over-reverse — a tangent pass in
//                 direction ḡ_t through the forward and the backprop — giving
//                 the Hessian-vector product and the mixed ∂²/∂p∂u, ∂²/∂p∂cw,
//                 ∂²/∂p∂z terms; finally c̄w → v̄, ᾱ.
//
// Two likelihood heads, chosen at run time by Net::gaussian: categorical on
// nc logits against int32 class labels (δ = c·(softmax − onehot), Hessian
// the softmax Jacobian), or Gaussian at precision τ on one output against
// float targets z (NLL ½τ(z − Z)² + log(1/√τ) + ½log 2π, δ = c·τ·(Z − z),
// Hessian the constant τ). ∂NLL/∂z = −τ·(Z − z), so the target cotangent z̄
// (regressors learn z) is minus the head's δ summed over samples: from the
// IW-ELBO's δ in nested_outer, from the tangent δ̇ = cw·τ·Ż in each
// iteration of nested_rev. Only the head functions below branch on it.
//
// The plain PyTorch twins with the same math are nested_fwd_torch,
// nested_outer_torch and nested_rev_torch in ../fused_nested.py.
//
// What bounds it on this card: not bytes and not FLOPs. At the slice's
// shapes (fn 2-40-4, M=48, S=10, T=10) a step is tens of MFLOP over well
// under a MB, about a microsecond of either roofline. The time is set by
// the T dependent iterations, each a chain of ~2L+5 phases that must
// finish before the next starts (sample → layer-by-layer forward → head →
// backprop → reduce over samples + Adam), i.e. by barrier latency and the
// serial depth of each phase.
//
// What the design does about it: every phase of an iteration runs inside
// one block of 1024 threads, separated by __syncthreads() instead of
// kernel launches or grid barriers, so there is one launch per kernel per
// outer step and no host round trip inside the unroll. Activations and
// scratch live in global memory (L2-resident at these sizes), so the same
// code serves widths that do not fit shared memory. All arithmetic is fp32
// FMA on CUDA cores (no TF32, no tensor cores): one bf16 pass in these
// products collapsed the u-hypergradient on the TPU. Using one SM of 132
// is the known cost of this simple design; spreading the per-sample phase
// over SMs with a cooperative grid barrier is later work.
//
// Layouts: params flat, per layer [mu_w (o,i) | rho_w (o,i) | mu_b (o) |
// rho_b (o)]; a noise draw (and θ) flat, per layer [w (S,o,i) | b (S,o)];
// activations per layer (S, NP, o), NP = the points of the forward.
//
// Each C entry launches one kernel on the given stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#define MAXL 8
#define MAXS 32
#define NTHREADS 1024

struct Net {
  int L, S, T, M, B, NP;
  int parameterised, use_alpha, gaussian;
  int in[MAXL], out[MAXL];
  int poff[MAXL];  // layer offset in the flat parameter vector
  int eoff[MAXL];  // layer offset in a flat noise draw / θ
  int zoff[MAXL];  // layer offset in the activation buffers
  int P, E;
  float N, NB, prior_sd, sp2inv, adam_eps, lr;
  float tau, scale, nll_c;  // Gaussian: precision, 1/√τ, log(1/√τ) + ½log 2π
  double b1, b2;
};

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. sh holds >= 33 floats.
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

// Input of layer l at (sample s, point pt, feature k): the data point for
// l = 0 (u rows first, then minibatch rows), relu(z^{l-1}) otherwise.
__device__ __forceinline__ float act_in(const Net& n, int l, int s, int pt, int k,
                                        const float* X0, const float* X1, const float* z) {
  if (l == 0) return pt < n.M ? X0[pt * n.in[0] + k] : X1[(pt - n.M) * n.in[0] + k];
  const float a = z[n.zoff[l - 1] + (s * n.NP + pt) * n.in[l] + k];
  return a > 0.f ? a : 0.f;
}

// Tangent of that input (the data carries no tangent).
__device__ __forceinline__ float act_tan(const Net& n, int l, int s, int pt, int k,
                                         const float* z, const float* zd) {
  if (l == 0) return 0.f;
  const int q = n.zoff[l - 1] + (s * n.NP + pt) * n.in[l] + k;
  return z[q] > 0.f ? zd[q] : 0.f;
}

// θ = μ + softplus(ρ)·ε for every layer and sample.
__device__ void sample_theta(const Net& n, const float* p, const float* eps, float* theta) {
  for (int l = 0; l < n.L; ++l) {
    const int o = n.out[l], nw = o * n.in[l];
    const float* pl = p + n.poff[l];
    const float* el = eps + n.eoff[l];
    float* tl = theta + n.eoff[l];
    for (int j = threadIdx.x; j < n.S * nw; j += blockDim.x) {
      const int k = j % nw;
      tl[j] = pl[k] + softplus_f(pl[nw + k]) * el[j];
    }
    for (int j = threadIdx.x; j < n.S * o; j += blockDim.x) {
      const int k = j % o;
      tl[n.S * nw + j] = pl[2 * nw + k] + softplus_f(pl[2 * nw + o + k]) * el[n.S * nw + j];
    }
  }
  __syncthreads();
}

// θ̇ = ġ_μ + sigmoid(ρ)·ġ_ρ·ε: the tangent of θ in direction gdir.
__device__ void tangent_theta(const Net& n, const float* p, const float* gdir,
                              const float* eps, float* thetad) {
  for (int l = 0; l < n.L; ++l) {
    const int o = n.out[l], nw = o * n.in[l];
    const float* pl = p + n.poff[l];
    const float* gl = gdir + n.poff[l];
    const float* el = eps + n.eoff[l];
    float* tl = thetad + n.eoff[l];
    for (int j = threadIdx.x; j < n.S * nw; j += blockDim.x) {
      const int k = j % nw;
      tl[j] = gl[k] + sigmoid_f(pl[nw + k]) * gl[nw + k] * el[j];
    }
    for (int j = threadIdx.x; j < n.S * o; j += blockDim.x) {
      const int k = j % o;
      tl[n.S * nw + j] =
          gl[2 * nw + k] + sigmoid_f(pl[2 * nw + o + k]) * gl[2 * nw + o + k] * el[n.S * nw + j];
    }
  }
  __syncthreads();
}

// z^l[s,pt,:] = a^{l-1}[s,pt,:]·W_sᵀ + b_s, layer by layer.
__device__ void forward(const Net& n, const float* theta, const float* X0, const float* X1,
                        float* z) {
  for (int l = 0; l < n.L; ++l) {
    const int i = n.in[l], o = n.out[l];
    const float* W = theta + n.eoff[l];
    const float* bb = W + n.S * o * i;
    const int tot = n.S * n.NP * o;
    for (int idx = threadIdx.x; idx < tot; idx += blockDim.x) {
      const int oo = idx % o, sp = idx / o, pt = sp % n.NP, s = sp / n.NP;
      const float* w = W + (s * o + oo) * i;
      float acc = 0.f;
      for (int k = 0; k < i; ++k) acc = fmaf(act_in(n, l, s, pt, k, X0, X1, z), w[k], acc);
      z[n.zoff[l] + idx] = acc + bb[s * o + oo];
    }
    __syncthreads();
  }
}

// ż^l = ȧ^{l-1}·Wᵀ + a^{l-1}·Ẇᵀ + ḃ (inner points only: X is u).
__device__ void tangent_forward(const Net& n, const float* theta, const float* thetad,
                                const float* X0, const float* z, float* zd) {
  for (int l = 0; l < n.L; ++l) {
    const int i = n.in[l], o = n.out[l];
    const float* W = theta + n.eoff[l];
    const float* Wd = thetad + n.eoff[l];
    const float* bd = Wd + n.S * o * i;
    const int tot = n.S * n.NP * o;
    for (int idx = threadIdx.x; idx < tot; idx += blockDim.x) {
      const int oo = idx % o, sp = idx / o, pt = sp % n.NP, s = sp / n.NP;
      const float* w = W + (s * o + oo) * i;
      const float* wd = Wd + (s * o + oo) * i;
      float acc = 0.f;
      for (int k = 0; k < i; ++k) {
        acc = fmaf(act_tan(n, l, s, pt, k, z, zd), w[k], acc);
        acc = fmaf(act_in(n, l, s, pt, k, X0, nullptr, z), wd[k], acc);
      }
      zd[n.zoff[l] + idx] = acc + bd[s * o + oo];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float log_sum_exp(const float* Z, int nc) {
  float mx = Z[0];
  for (int c = 1; c < nc; ++c) mx = fmaxf(mx, Z[c]);
  float se = 0.f;
  for (int c = 0; c < nc; ++c) se += expf(Z[c] - mx);
  return mx + logf(se);
}

// The head at one (sample, point) with outputs Z and the target at index i
// of y (int labels or float reals): returns the NLL and, if d is non-null,
// writes coef·∂NLL/∂Z into d.
__device__ __forceinline__ float head(const Net& n, const float* Z, const void* y, int i,
                                      float coef, float* d) {
  if (n.gaussian) {
    const float t = static_cast<const float*>(y)[i];
    const float r = (t - Z[0]) / n.scale;
    if (d) d[0] = coef * (n.tau * (Z[0] - t));
    return 0.5f * r * r + n.nll_c;
  }
  const int nc = n.out[n.L - 1], yc = static_cast<const int*>(y)[i];
  const float lse = log_sum_exp(Z, nc);
  if (d)
    for (int c = 0; c < nc; ++c) d[c] = coef * (expf(Z[c] - lse) - (c == yc ? 1.f : 0.f));
  return lse - Z[yc];
}

// Its tangent in direction Zd: writes coef·∂²NLL/∂Z²·Zd into e and returns
// ∂NLL/∂Z·Zd.
__device__ __forceinline__ float head_tangent(const Net& n, const float* Z, const float* Zd,
                                              const void* y, int i, float coef, float* e) {
  if (n.gaussian) {
    e[0] = coef * (n.tau * Zd[0]);
    return n.tau * (Z[0] - static_cast<const float*>(y)[i]) * Zd[0];
  }
  const int nc = n.out[n.L - 1], yc = static_cast<const int*>(y)[i];
  const float lse = log_sum_exp(Z, nc);
  float pz = 0.f, nd = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float pc = expf(Z[c] - lse);
    pz = fmaf(pc, Zd[c], pz);
    nd = fmaf(pc - (c == yc ? 1.f : 0.f), Zd[c], nd);
  }
  for (int c = 0; c < nc; ++c) e[c] = coef * expf(Z[c] - lse) * (Zd[c] - pz);
  return nd;
}

// Inner head: δ^L = cw·∂NLL/∂Z. Returns this thread's share of
// Σ_s Σ_m cw_m·NLL.
__device__ float head_inner(const Net& n, const float* z, const void* y, const float* cw,
                            float* delta) {
  const int nc = n.out[n.L - 1];
  float part = 0.f;
  for (int idx = threadIdx.x; idx < n.S * n.NP; idx += blockDim.x) {
    const int pt = idx % n.NP;
    const float* Z = z + n.zoff[n.L - 1] + idx * nc;
    part += cw[pt] * head(n, Z, y, pt, cw[pt], delta + n.zoff[n.L - 1] + idx * nc);
  }
  __syncthreads();
  return part;
}

// g_z[m] −= Σ_s δ^L[s, m] over the first M points of a head δ (Gaussian
// only: the targets carry no cotangent otherwise).
__device__ void zbar_from_head(const Net& n, const float* delta, float* g_z) {
  if (!n.gaussian) return;
  for (int m = threadIdx.x; m < n.M; m += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n.S; ++s) acc += delta[n.zoff[n.L - 1] + s * n.NP + m];
    g_z[m] -= acc;
  }
}

// δ^{l-1} = (δ^l·W_s) ⊙ 1[z^{l-1} > 0], for l = L-1..1. dd/thetad non-null
// selects the tangent: δ̇^{l-1} = (δ̇^l·W + δ^l·Ẇ) ⊙ 1[z^{l-1} > 0].
__device__ void backward(const Net& n, const float* theta, const float* z, float* delta,
                         const float* thetad, float* dd) {
  for (int l = n.L - 1; l >= 1; --l) {
    const int i = n.in[l], o = n.out[l];
    const float* W = theta + n.eoff[l];
    const float* Wd = thetad ? thetad + n.eoff[l] : nullptr;
    const int tot = n.S * n.NP * i;
    for (int idx = threadIdx.x; idx < tot; idx += blockDim.x) {
      const int k = idx % i, sp = idx / i, s = sp / n.NP;
      const float* d = delta + n.zoff[l] + sp * o;
      const float* w = W + s * o * i + k;
      float acc = 0.f;
      if (dd) {
        const float* ddl = dd + n.zoff[l] + sp * o;
        const float* wd = Wd + s * o * i + k;
        for (int oo = 0; oo < o; ++oo) {
          acc = fmaf(ddl[oo], w[oo * i], acc);
          acc = fmaf(d[oo], wd[oo * i], acc);
        }
        dd[n.zoff[l - 1] + idx] = z[n.zoff[l - 1] + idx] > 0.f ? acc : 0.f;
      } else {
        for (int oo = 0; oo < o; ++oo) acc = fmaf(d[oo], w[oo * i], acc);
        delta[n.zoff[l - 1] + idx] = z[n.zoff[l - 1] + idx] > 0.f ? acc : 0.f;
      }
    }
    __syncthreads();
  }
}

// Σ_pt δ^l[s,pt,oo]·a^{l-1}[s,pt,k] (k < 0: the bias, Σ_pt δ).
__device__ __forceinline__ float grad_sample(const Net& n, int l, int s, int oo, int k,
                                             const float* delta, const float* z,
                                             const float* X0, const float* X1) {
  const int o = n.out[l];
  const float* d = delta + n.zoff[l] + s * n.NP * o + oo;
  float acc = 0.f;
  if (k < 0) {
    for (int pt = 0; pt < n.NP; ++pt) acc += d[pt * o];
  } else {
    for (int pt = 0; pt < n.NP; ++pt)
      acc = fmaf(d[pt * o], act_in(n, l, s, pt, k, X0, X1, z), acc);
  }
  return acc;
}

// Its tangent: Σ_pt δ̇·a + δ·ȧ (inner points).
__device__ __forceinline__ float grad_sample_tan(const Net& n, int l, int s, int oo, int k,
                                                 const float* delta, const float* dd,
                                                 const float* z, const float* zd,
                                                 const float* X0) {
  const int o = n.out[l];
  const float* d = delta + n.zoff[l] + s * n.NP * o + oo;
  const float* e = dd + n.zoff[l] + s * n.NP * o + oo;
  float acc = 0.f;
  if (k < 0) {
    for (int pt = 0; pt < n.NP; ++pt) acc += e[pt * o];
  } else {
    for (int pt = 0; pt < n.NP; ++pt) {
      acc = fmaf(e[pt * o], act_in(n, l, s, pt, k, X0, nullptr, z), acc);
      acc = fmaf(d[pt * o], act_tan(n, l, s, pt, k, z, zd), acc);
    }
  }
  return acc;
}

// Element j of layer l's weight+bias block: indices of μ and ρ in the
// layer's parameters, of sample s's noise, and the (unit, feature) pair.
struct Elem {
  int jm, jr, oo, k;
  __device__ Elem(const Net& n, int l, int j) {
    const int o = n.out[l], nw = o * n.in[l];
    if (j < nw) {
      jm = j; jr = nw + j; oo = j / n.in[l]; k = j % n.in[l];
    } else {
      jm = 2 * nw + (j - nw); jr = 2 * nw + o + (j - nw); oo = j - nw; k = -1;
    }
  }
  __device__ int eidx(const Net& n, int l, int s) const {
    const int o = n.out[l], nw = o * n.in[l];
    return k >= 0 ? s * nw + oo * n.in[l] + k : n.S * nw + s * o + oo;
  }
};

// Σ_s G_s and Σ_s G_s·ε_s of the inner gradient for element e.
__device__ __forceinline__ void inner_grad_sums(const Net& n, int l, const Elem& e,
                                                const float* eps, const float* delta,
                                                const float* z, const float* X0,
                                                float& gs, float& gse) {
  const float* el = eps + n.eoff[l];
  gs = 0.f; gse = 0.f;
  for (int s = 0; s < n.S; ++s) {
    const float a = grad_sample(n, l, s, e.oo, e.k, delta, z, X0, nullptr);
    gs += a;
    gse = fmaf(a, el[e.eidx(n, l, s)], gse);
  }
}

__device__ __forceinline__ void bias_corr(const Net& n, int t, float& bc1, float& bc2s) {
  bc1 = (float)(1.0 - pow(n.b1, (double)t));
  bc2s = (float)sqrt(1.0 - pow(n.b2, (double)t));
}

// cw = N·[e^α·] f(v), f = softmax or identity.
__device__ void core_weights(const Net& n, const float* v, const float* alpha, float* cw,
                             float* sh) {
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
  __syncthreads();
}

// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
nested_fwd_kernel(Net n, const float* __restrict__ p0, const float* __restrict__ u,
                  const void* __restrict__ y, const float* __restrict__ v,
                  const float* __restrict__ alpha, const float* __restrict__ eps,
                  float* losses, float* hist, float* cw, float* theta, float* z,
                  float* delta) {
  __shared__ float sh[33];
  const int P = n.P;
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    hist[j] = p0[j];
    hist[P + j] = 0.f;
    hist[2 * P + j] = 0.f;
  }
  core_weights(n, v, alpha, cw, sh);  // ends with a barrier
  for (int t = 1; t <= n.T; ++t) {
    const float* p = hist + (t - 1) * 3 * P;
    const float* m = p + P;
    const float* nv = p + 2 * P;
    float* p1 = hist + t * 3 * P;
    float* m1 = p1 + P;
    float* n1 = p1 + 2 * P;
    const float* et = eps + (t - 1) * n.E;
    sample_theta(n, p, et, theta);
    forward(n, theta, u, nullptr, z);
    float part = head_inner(n, z, y, cw, delta);
    backward(n, theta, z, delta, nullptr, nullptr);
    float bc1, bc2s;
    bias_corr(n, t, bc1, bc2s);
    for (int l = 0; l < n.L; ++l) {
      const int o = n.out[l], nw = o * n.in[l];
      const int off = n.poff[l];
      for (int j = threadIdx.x; j < nw + o; j += blockDim.x) {
        const Elem e(n, l, j);
        float gs, gse;
        inner_grad_sums(n, l, e, et, delta, z, u, gs, gse);
        const float mu = p[off + e.jm], rho = p[off + e.jr];
        const float sd = softplus_f(rho), sg = sigmoid_f(rho);
        const float g[2] = {gs + mu * n.sp2inv, sg * (gse - 1.f / sd + sd * n.sp2inv)};
        const int q[2] = {off + e.jm, off + e.jr};
        part += logf(n.prior_sd / sd) + (sd * sd + mu * mu) / (2.f * n.prior_sd * n.prior_sd) - 0.5f;
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
    const float loss = block_sum(part, sh);  // its barriers also publish p1
    if (threadIdx.x == 0) losses[t - 1] = loss;
  }
}

__global__ void __launch_bounds__(NTHREADS)
nested_outer_kernel(Net n, const float* __restrict__ pT, const float* __restrict__ u,
                    const void* __restrict__ y, const float* __restrict__ cw,
                    const float* __restrict__ xb, const void* __restrict__ yb,
                    const float* __restrict__ eps, float* loss, float* pbar, float* ubar,
                    float* cwbar, float* zbar, float* theta, float* z, float* delta,
                    float* nll) {
  __shared__ float sh_ps[MAXS], sh_da[MAXS], sh_nk[MAXS];
  __shared__ float c_ps[MAXS], c_da[MAXS], c_nk[MAXS];
  const int S = n.S, M = n.M, NP = n.NP, nc = n.out[n.L - 1];
  const float sp = n.prior_sd;
  const float hl2pi = 0.91893853320467274178f;  // ½·log 2π
  sample_theta(n, pT, eps, theta);
  forward(n, theta, u, xb, z);
  for (int idx = threadIdx.x; idx < S * NP; idx += blockDim.x) {
    const int pt = idx % NP;
    const float* Z = z + n.zoff[n.L - 1] + idx * nc;
    nll[idx] = pt < M ? head(n, Z, y, pt, 0.f, nullptr) : head(n, Z, yb, pt - M, 0.f, nullptr);
  }
  __syncthreads();
  // per-sample pseudo NLL, data NLL and log p(θ_s) − log q(θ_s): a warp each
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int s = wid; s < S; s += nwarp) {
    float ps = 0.f, da = 0.f, nk = 0.f;
    for (int pt = lane; pt < NP; pt += 32) {
      const float x = nll[s * NP + pt];
      if (pt < M) ps = fmaf(cw[pt], x, ps);
      else da += x;
    }
    for (int l = 0; l < n.L; ++l) {
      const int o = n.out[l], nw = o * n.in[l];
      const float* pl = pT + n.poff[l];
      const float* tl = theta + n.eoff[l];
      for (int j = lane; j < nw + o; j += 32) {
        const Elem e(n, l, j);
        const float th = tl[e.eidx(n, l, s)];
        const float mu = pl[e.jm], sd = softplus_f(pl[e.jr]);
        const float a = th / sp, r = (th - mu) / sd;
        nk += (-0.5f * a * a - logf(sp) - hl2pi) - (-0.5f * r * r - logf(sd) - hl2pi);
      }
    }
    ps = warp_sum(ps);
    da = warp_sum(da);
    nk = warp_sum(nk);
    if (lane == 0) {
      sh_ps[s] = ps;
      sh_da[s] = n.NB * da;
      sh_nk[s] = nk;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // self-normalized IW weights, the loss and ∂loss/∂{pseudo, data, nkl}
    float mx = -INFINITY, mean_lw = 0.f;
    for (int s = 0; s < S; ++s) {
      const float lw = -sh_ps[s] + sh_nk[s];
      mx = fmaxf(mx, lw);
      mean_lw += lw;
    }
    mean_lw /= S;
    float se = 0.f;
    for (int s = 0; s < S; ++s) se += expf(-sh_ps[s] + sh_nk[s] - mx);
    // d = data − pseudo centred at its weighted mean in two passes, so the
    // coefficients c_ps sum to zero in fp32 as they do exactly (|d| ~ 10²)
    float dref = 0.f;
    for (int s = 0; s < S; ++s) {
      c_da[s] = expf(-sh_ps[s] + sh_nk[s] - mx) / se;  // w_s
      dref += c_da[s] * (sh_da[s] - sh_ps[s]);
    }
    float dcbar = 0.f;
    for (int s = 0; s < S; ++s) dcbar += c_da[s] * ((sh_da[s] - sh_ps[s]) - dref);
    for (int s = 0; s < S; ++s) {
      const float q = c_da[s] * (((sh_da[s] - sh_ps[s]) - dref) - dcbar) - 1.f / S;
      c_nk[s] = q;
      c_ps[s] = -c_da[s] - q;
    }
    loss[0] = dref + dcbar - mean_lw;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < S * NP; idx += blockDim.x) {
    const int s = idx / NP, pt = idx % NP;
    const float* Z = z + n.zoff[n.L - 1] + idx * nc;
    float* d = delta + n.zoff[n.L - 1] + idx * nc;
    if (pt < M) head(n, Z, y, pt, c_ps[s] * cw[pt], d);
    else head(n, Z, yb, pt - M, c_da[s] * n.NB, d);
  }
  // c̄w = Σ_s c_ps·NLL with the NLL centred over the samples: the c_ps sum
  // to zero, so the value is the same, but the part of the NLL that all
  // samples share (for a Gaussian head most of it, the log-normaliser) no
  // longer cancels in fp32
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float mean = 0.f;
    for (int s = 0; s < S; ++s) mean += nll[s * NP + m];
    mean /= S;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(c_ps[s], nll[s * NP + m] - mean, acc);
    cwbar[m] = acc;
    zbar[m] = 0.f;
  }
  __syncthreads();
  zbar_from_head(n, delta, zbar);  // the head δ is final: backward writes below it
  backward(n, theta, z, delta, nullptr, nullptr);
  // p̄_T: likelihood terms through θ plus the NKL terms
  for (int l = 0; l < n.L; ++l) {
    const int o = n.out[l], nw = o * n.in[l];
    const float* pl = pT + n.poff[l];
    const float* el = eps + n.eoff[l];
    const float* tl = theta + n.eoff[l];
    for (int j = threadIdx.x; j < nw + o; j += blockDim.x) {
      const Elem e(n, l, j);
      const float mu = pl[e.jm], rho = pl[e.jr];
      const float sd = softplus_f(rho);
      float mub = 0.f, sdb = 0.f;
      for (int s = 0; s < S; ++s) {
        const int q = e.eidx(n, l, s);
        const float g = grad_sample(n, l, s, e.oo, e.k, delta, z, u, xb);
        const float th = tl[q], r = (th - mu) / sd, c = c_nk[s];
        const float thb = g + c * (-th * n.sp2inv + r / sd);
        mub += thb - c * r / sd;
        sdb += el[q] * thb + c * (1.f - r * r) / sd;
      }
      pbar[n.poff[l] + e.jm] = mub;
      pbar[n.poff[l] + e.jr] = sdb * sigmoid_f(rho);
    }
  }
  // direct ū = Σ_s δ^0[s, m, :]·W0_s
  {
    const int D = n.in[0], o = n.out[0];
    const float* W = theta + n.eoff[0];
    for (int idx = threadIdx.x; idx < M * D; idx += blockDim.x) {
      const int m = idx / D, k = idx % D;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const float* d = delta + n.zoff[0] + (s * NP + m) * o;
        const float* w = W + s * o * D + k;
        for (int oo = 0; oo < o; ++oo) acc = fmaf(d[oo], w[oo * D], acc);
      }
      ubar[idx] = acc;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
nested_rev_kernel(Net n, const float* __restrict__ hist, const float* __restrict__ pbar_in,
                  const float* __restrict__ ubar_in, const float* __restrict__ cwbar_in,
                  const float* __restrict__ zbar_in, const float* __restrict__ u,
                  const void* __restrict__ y, const float* __restrict__ cw,
                  const float* __restrict__ v, const float* __restrict__ alpha,
                  const float* __restrict__ eps, float* g_u, float* g_v, float* g_alpha,
                  float* g_z, float* theta, float* thetad,
                  float* z, float* delta, float* zd, float* dd, float* nlld, float* h,
                  float* gbar, float* pbar, float* mbar, float* nbar, float* cwbar) {
  __shared__ float sh[33];
  const int P = n.P, S = n.S, M = n.M, D = n.in[0], nc = n.out[n.L - 1];
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    pbar[j] = pbar_in[j];
    mbar[j] = 0.f;
    nbar[j] = 0.f;
  }
  for (int j = threadIdx.x; j < M * D; j += blockDim.x) g_u[j] = ubar_in[j];
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    cwbar[j] = cwbar_in[j];
    g_z[j] = zbar_in[j];
  }
  __syncthreads();
  for (int t = n.T; t >= 1; --t) {
    const float* p = hist + (t - 1) * 3 * P;
    const float* mt = hist + t * 3 * P + P;
    const float* nt = hist + t * 3 * P + 2 * P;
    const float* et = eps + (t - 1) * n.E;
    // recompute iteration t's forward and first-order gradient at p_{t-1}
    sample_theta(n, p, et, theta);
    forward(n, theta, u, nullptr, z);
    head_inner(n, z, y, cw, delta);
    backward(n, theta, z, delta, nullptr, nullptr);
    float bc1, bc2s;
    bias_corr(n, t, bc1, bc2s);
    // Adam VJP: (p̄_t, m̄, n̄) → ḡ_t and the carried m̄, n̄
    for (int l = 0; l < n.L; ++l) {
      const int o = n.out[l], nw = o * n.in[l];
      const int off = n.poff[l];
      for (int j = threadIdx.x; j < nw + o; j += blockDim.x) {
        const Elem e(n, l, j);
        float gs, gse;
        inner_grad_sums(n, l, e, et, delta, z, u, gs, gse);
        const float mu = p[off + e.jm], rho = p[off + e.jr];
        const float sd = softplus_f(rho), sg = sigmoid_f(rho);
        const float hr = gse - 1.f / sd + sd * n.sp2inv;  // ∂L/∂σ
        const float g[2] = {gs + mu * n.sp2inv, sg * hr};
        const int q[2] = {off + e.jm, off + e.jr};
        h[off + e.jr] = hr;
        for (int r = 0; r < 2; ++r) {
          const float nq = nt[q[r]];
          const float den = (nq > 0.f ? sqrtf(nq) : 0.f) / bc2s + n.adam_eps;
          const float pb = pbar[q[r]];
          const float mb = mbar[q[r]] - pb * n.lr / (bc1 * den);
          const float dsq = nq > 0.f ? 0.5f / sqrtf(nq) : 0.f;
          const float nb = nbar[q[r]] + pb * n.lr * (mt[q[r]] / bc1) / (den * den) * dsq / bc2s;
          gbar[q[r]] = c1 * mb + 2.f * c2 * g[r] * nb;
          mbar[q[r]] = b1 * mb;
          nbar[q[r]] = b2 * nb;
        }
      }
    }
    __syncthreads();
    // tangent pass in direction ḡ_t
    tangent_theta(n, p, gbar, et, thetad);
    tangent_forward(n, theta, thetad, u, z, zd);
    for (int idx = threadIdx.x; idx < S * M; idx += blockDim.x) {
      const int m = idx % M, q = n.zoff[n.L - 1] + idx * nc;
      nlld[idx] = head_tangent(n, z + q, zd + q, y, m, cw[m], dd + q);
    }
    __syncthreads();
    backward(n, theta, z, delta, thetad, dd);
    // accumulate ū, c̄w, z̄ and p̄_{t-1} = p̄_t + H·ḡ_t
    {
      const int o = n.out[0];
      const float* W = theta + n.eoff[0];
      const float* Wd = thetad + n.eoff[0];
      for (int idx = threadIdx.x; idx < M * D; idx += blockDim.x) {
        const int m = idx / D, k = idx % D;
        float acc = 0.f;
        for (int s = 0; s < S; ++s) {
          const float* d = delta + n.zoff[0] + (s * M + m) * o;
          const float* e = dd + n.zoff[0] + (s * M + m) * o;
          const float* w = W + s * o * D + k;
          const float* wd = Wd + s * o * D + k;
          for (int oo = 0; oo < o; ++oo) {
            acc = fmaf(e[oo], w[oo * D], acc);
            acc = fmaf(d[oo], wd[oo * D], acc);
          }
        }
        g_u[idx] += acc;
      }
    }
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += nlld[s * M + m];
      cwbar[m] += acc;
    }
    zbar_from_head(n, dd, g_z);
    for (int l = 0; l < n.L; ++l) {
      const int o = n.out[l], nw = o * n.in[l];
      const int off = n.poff[l];
      const float* el = et + n.eoff[l];
      for (int j = threadIdx.x; j < nw + o; j += blockDim.x) {
        const Elem e(n, l, j);
        float gd = 0.f, gde = 0.f;
        for (int s = 0; s < S; ++s) {
          const float a = grad_sample_tan(n, l, s, e.oo, e.k, delta, dd, z, zd, u);
          gd += a;
          gde = fmaf(a, el[e.eidx(n, l, s)], gde);
        }
        const float rho = p[off + e.jr];
        const float sd = softplus_f(rho), sg = sigmoid_f(rho);
        const float gm = gbar[off + e.jm], gr = gbar[off + e.jr];
        pbar[off + e.jm] += gd + gm * n.sp2inv;
        pbar[off + e.jr] += sg * (1.f - sg) * gr * h[off + e.jr] +
                            sg * (gde + (1.f / (sd * sd) + n.sp2inv) * sg * gr);
      }
    }
    __syncthreads();
  }
  // c̄w → v̄, ᾱ through cw = N·[e^α·] f(v)
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
// host side: the Net description and the C entries

// dims = [L, S, T, M, B, parameterised, use_alpha, gaussian, widths[0..L]]
// hyper = [N, prior_sd, b1, b2, adam_eps, lr, tau]
static int make_net(Net* n, const int* dims, const double* hyper, int with_batch) {
  n->L = dims[0]; n->S = dims[1]; n->T = dims[2]; n->M = dims[3]; n->B = dims[4];
  n->parameterised = dims[5]; n->use_alpha = dims[6]; n->gaussian = dims[7];
  if (n->L < 1 || n->L > MAXL || n->S < 1 || n->S > MAXS || n->M < 1) return 1;
  n->NP = with_batch ? n->M + n->B : n->M;
  int poff = 0, eoff = 0, zoff = 0;
  for (int l = 0; l < n->L; ++l) {
    n->in[l] = dims[8 + l];
    n->out[l] = dims[9 + l];
    n->poff[l] = poff;
    n->eoff[l] = eoff;
    n->zoff[l] = zoff;
    poff += 2 * (n->out[l] * n->in[l] + n->out[l]);
    eoff += n->S * (n->out[l] * n->in[l] + n->out[l]);
    zoff += n->S * n->NP * n->out[l];
  }
  n->P = poff;
  n->E = eoff;
  n->N = (float)hyper[0];
  n->NB = (float)(hyper[0] / (n->B > 0 ? n->B : 1));
  n->prior_sd = (float)hyper[1];
  n->sp2inv = (float)(1.0 / (hyper[1] * hyper[1]));
  n->b1 = hyper[2];
  n->b2 = hyper[3];
  n->adam_eps = (float)hyper[4];
  n->lr = (float)hyper[5];
  if (n->gaussian && (n->out[n->L - 1] != 1 || !(hyper[6] > 0.0))) return 1;
  n->tau = (float)hyper[6];
  n->scale = (float)(1.0 / sqrt(hyper[6]));
  n->nll_c = (float)(log(1.0 / sqrt(hyper[6])) + 0.91893853320467274178);
  return 0;
}

extern "C" int psvi_nested_fwd(const float* p0, const float* u, const void* y, const float* v,
                               const float* alpha, const float* eps, float* losses, float* hist,
                               float* cw, float* theta, float* z, float* delta,
                               const int* dims, const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 0)) return (int)cudaErrorInvalidValue;
  nested_fwd_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(n, p0, u, y, v, alpha, eps,
                                                              losses, hist, cw, theta, z, delta);
  return (int)cudaGetLastError();
}

extern "C" int psvi_nested_outer(const float* pT, const float* u, const void* y, const float* cw,
                                 const float* xb, const void* yb, const float* eps, float* loss,
                                 float* pbar, float* ubar, float* cwbar, float* zbar,
                                 float* theta, float* z, float* delta, float* nll,
                                 const int* dims, const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 1)) return (int)cudaErrorInvalidValue;
  nested_outer_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(
      n, pT, u, y, cw, xb, yb, eps, loss, pbar, ubar, cwbar, zbar, theta, z, delta, nll);
  return (int)cudaGetLastError();
}

extern "C" int psvi_nested_rev(const float* hist, const float* pbar_in, const float* ubar_in,
                               const float* cwbar_in, const float* zbar_in, const float* u,
                               const void* y, const float* cw, const float* v,
                               const float* alpha, const float* eps, float* g_u, float* g_v,
                               float* g_alpha, float* g_z, float* theta, float* thetad,
                               float* z, float* delta, float* zd, float* dd, float* nlld,
                               float* h, float* gbar, float* pbar, float* mbar, float* nbar,
                               float* cwbar, const int* dims, const double* hyper,
                               void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 0)) return (int)cudaErrorInvalidValue;
  nested_rev_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(
      n, hist, pbar_in, ubar_in, cwbar_in, zbar_in, u, y, cw, v, alpha, eps, g_u, g_v,
      g_alpha, g_z, theta, thetad, z, delta, zd, dd, nlld, h, gbar, pbar, mbar, nbar, cwbar);
  return (int)cudaGetLastError();
}
