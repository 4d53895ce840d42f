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
// What bounds them on this card: not bytes and not FLOPs. At the main paths'
// shapes (fn 2-40-4, M=48, S=10, T=10) a step is tens of MFLOP over well
// under a MB, about a microsecond of either roofline. The time is latency:
// T dependent iterations, each a chain of phases that must finish before the
// next starts. Measured (scripts/torch_nested_phase_split.py, the phase
// clock below) on the first design, one block of 1024 threads with every map
// in global memory, 72 % of nested_fwd and 79 % of nested_rev went to the
// per-parameter sums over (sample, point): one thread walked all S·M pairs
// for a parameter, each step a trip to L2. Most of the rest went to the
// layer passes over the same maps in L2; a barrier cost under a µs. The
// same design of nested_outer spent 58 % of its 0.376 ms at four_blobs
// (M + B = 176 points) in p̄_T's one-thread S·(M+B) sums and 33 % in the
// forward and backward over maps in L2.
//
// What the design does about it. Each kernel launches once per outer step
// as a thread block cluster of C <= 8 blocks (_nested_plan in
// ../fused_nested.py: C, the samples a block holds, where the maps live).
// - Block r holds samples [r·S/C, (r+1)·S/C): their θ_s (and θ̇_s), their
//   maps z, δ (and ż, δ̇) at the inner points (nested_outer: the M + B
//   points of u and the minibatch) and their per-sample partial
//   sums, in dynamic shared memory where they fit (227 KB), else in the
//   global scratch the wrapper allocates; the same code reads either through
//   generic pointers. Sampling, the layer passes, the head and the per-sample
//   sums of a sample run in its block (1024 threads; nested_rev 512, so that
//   none spills), a thread an output, separated by __syncthreads(). So a
//   sample's passes run on an SM of their own.
// - The per-sample sums (G_s = Σ_pt δ·a of every weight and bias with
//   G_s·ε_s, their tangents, the per-sample ū; nested_outer's NLLs, NKL and
//   p̄_T terms) are spread a thread a (sample, parameter), each over the
//   points in order.
// - Block r owns a slice of the parameters (and of ū's, c̄w's and z̄'s
//   entries): it adds the S per-sample partials in sample order, reading the
//   other blocks' shared memory (distributed shared memory), a lane a sample
//   and all in one round, then runs Adam (nested_fwd) or the Adam VJP and p̄'s
//   update (nested_rev) for its slice and writes its slice of the history;
//   nested_outer's owners write their slices of p̄_T, ū, c̄w (the NLL centred
//   over the samples) and z̄. Between its two phases every block reads the S
//   samples' (pseudo, data, NKL) sums and works out the IW coefficients in
//   one thread, in sample order, with d centred in two passes: the same bits
//   in every block.
//   cluster.sync() separates the phases that need every sample; p_t and ḡ_t
//   cross in global memory, read after the cluster barrier's release/acquire
//   with ld.global.cg. Adam's bias corrections (double pow) are worked out
//   once per launch, a thread an iteration.
// - Both kernels compute the inner gradient with the same functions
//   (blk_sample_sums, by_groups) in the same order, whatever the plan: at
//   t = 1 the Adam VJP cancels only if m_t, n_t come from the gradient the
//   reverse sweep recomputes. Every sum runs in a fixed order with no
//   atomics, so a rerun gives the same bits.
// - All arithmetic is fp32 FMA on CUDA cores (no TF32, no tensor cores): one
//   bf16 pass in these products collapsed the u-hypergradient on the TPU.
// - The Net description is a __grid_constant__ parameter: indexing it by a
//   run-time layer reads the parameter bank, with no copy to a local stack.
// What is left an iteration is the layer passes of a block's samples (an
// instruction-bound thread an output, index arithmetic included), the
// owners' sums, and two (nested_fwd) or three (nested_rev) cluster barriers;
// nested_outer has three barriers in its one pass.
//
// Layouts: params flat, per layer [mu_w (o,i) | rho_w (o,i) | mu_b (o) |
// rho_b (o)]; a noise draw flat, per layer [w (S,o,i) | b (S,o)]; one
// sample's θ, and any per-parameter per-sample array, per layer [w (o,i) |
// b (o)] (its element index q = qoff[l] + j); one sample's maps per layer
// (NP, o): NP = M (nested_fwd, nested_rev) or M + B (nested_outer: u's rows,
// then the minibatch's).
//
// Each C entry launches one kernel on the given stream, allocates nothing,
// and returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define MAXL 8
#define MAXS 32
#define OUTER_THREADS 1024  // a block of nested_outer's cluster
#define FWD_THREADS 1024  // a block of nested_fwd's cluster
// a block of nested_rev's cluster: it takes about 106 registers a thread,
// and at 1024 threads (64 registers each) it spills
#define REV_THREADS 512
#define MAX_CLUSTER 8     // the portable cluster size
// dynamic shared memory a block of a kernel's cluster may take: the
// card's 232,448 bytes a block less room for the static arrays
#define SMEM_CAP (232448 - 1024)

struct Net {
  int L, S, T, M, B, NP;
  int parameterised, use_alpha, gaussian;
  int in[MAXL], out[MAXL];
  int poff[MAXL];  // layer offset in the flat parameter vector
  int eoff[MAXL];  // layer offset in a flat noise draw / θ
  int qoff[MAXL];  // layer offset in one sample's θ (element index)
  int cumo[MAXL];  // units before layer l: layer offset in one point's maps
  int P, E, nE, U;  // nE = E / S elements a sample, U = Σ out units a point
  float N, NB, prior_sd, sp2inv, adam_eps, lr;
  float tau, scale, nll_c;  // Gaussian: precision, 1/√τ, log(1/√τ) + ½log 2π
  double b1, b2;
};

// The launch plan of a kernel (_nested_plan): C blocks in one
// cluster, spb = ⌈S/C⌉ the most samples a block holds, the maps in shared
// memory or not, and the dynamic shared bytes a block.
struct Plan {
  int C, spb, shared, smem;
};

#ifdef NESTED_PHASE_CLOCK
// Phase clock (instrumented builds only, scripts/torch_nested_phase_split.py):
// thread 0 of block 0 writes (phase id, %globaltimer) at each phase boundary
// into g_clock; PHASE first waits for its whole block, so a phase ends when
// the block's slowest thread does.
#define CLOCK_MAX 4096
__device__ unsigned long long g_clock[2 * CLOCK_MAX];
__device__ int g_clock_n;
__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_INIT int clk_n = 0
#define PHASE(id)                                                   \
  do {                                                              \
    __syncthreads();                                                \
    if (blockIdx.x == 0 && threadIdx.x == 0 && clk_n < CLOCK_MAX) { \
      g_clock[2 * clk_n] = (id);                                    \
      g_clock[2 * clk_n + 1] = globaltimer_ns();                    \
      ++clk_n;                                                      \
    }                                                               \
  } while (0)
#define PHASE_END \
  if (blockIdx.x == 0 && threadIdx.x == 0) g_clock_n = clk_n
extern "C" int psvi_nested_phase_clock(unsigned long long* out, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_clock_n, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));
  return (int)e;
}
#else
#define PHASE_INIT
#define PHASE(id)
#define PHASE_END
#endif

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

// Element j of layer l's weight+bias block (weights, then biases): the
// indices of its μ and ρ in the layer's parameters.
struct Elem {
  int jm, jr;
  __device__ Elem(const Net& n, int l, int j) {
    const int nw = n.out[l] * n.in[l];
    jm = j < nw ? j : nw + j;
    jr = j < nw ? nw + j : nw + n.out[l] + j;
  }
};

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
// nested_fwd and nested_rev: a cluster of blocks, each over its own samples

#define NWARPS (FWD_THREADS / 32)

// One per-sample array of `size` floats (θ_s, a map, a partial sum). With
// the maps in shared memory each block holds its samples' copies at `base`,
// in its own dynamic shared memory; else all S copies lie at `base`, in
// global memory (slot() picks).
struct Slot {
  float* base;
  int size;
};

__device__ __forceinline__ Slot slot(const Plan& pl, float* sh, float* gl, int size) {
  return Slot{pl.shared ? sh : gl, size};
}

// This block's samples [s0, s0 + ns) and where every sample lives.
struct Ctx {
  int s0, ns, shared;
  const unsigned char* blk;  // each sample's block rank
  const unsigned char* loc;  // its index in that block

  // own sample i's copy
  __device__ __forceinline__ float* mine(const Slot& a, int i) const {
    return a.base + (shared ? i : s0 + i) * a.size;
  }
  // entry idx of sample s's copy, wherever it lies: in another block's
  // shared memory, or in global memory that another block wrote (read past
  // L1, after a cluster barrier)
  __device__ __forceinline__ float peer(const Slot& a, int s, int idx) const {
    if (shared) {
      return cg::this_cluster().map_shared_rank(a.base + loc[s] * a.size, (unsigned)blk[s])[idx];
    }
    return __ldcg(a.base + s * a.size + idx);
  }
};

// The slice [lo, hi) of [0, count) that block r of C owns.
__device__ __forceinline__ void owned(int count, int r, int C, int& lo, int& hi) {
  lo = (int)((long long)count * r / C);
  hi = (int)((long long)count * (r + 1) / C);
}

// The layer of element q (an index into one sample's θ).
__device__ __forceinline__ int layer_of(const Net& n, int q) {
  int l = 0;
  while (l + 1 < n.L && q >= n.qoff[l + 1]) ++l;
  return l;
}

// ε_s of element j of layer l (weights, then biases) in a flat draw.
__device__ __forceinline__ float eps_of(const Net& n, const float* eps, int l, int j, int s) {
  const int o = n.out[l], nw = o * n.in[l];
  return eps[n.eoff[l] + (j < nw ? s * nw + j : n.S * nw + s * o + (j - nw))];
}

// θ_i = μ + softplus(ρ)·ε_{s0+i} (gdir null), or the tangent of θ in
// direction gdir, θ̇_i = ġ_μ + sigmoid(ρ)·ġ_ρ·ε, for every layer into out.
// p and gdir may hold other blocks' writes: read past L1.
__device__ __forceinline__ void blk_sample(const Net& n, const Ctx& c, const float* p,
                                           const float* gdir, const float* eps,
                                           const Slot& out) {
  for (int l = 0; l < n.L; ++l) {
    const int o = n.out[l], nw = o * n.in[l], nq = nw + o;
    const float* pl = p + n.poff[l];
    for (int idx = threadIdx.x; idx < c.ns * nq; idx += blockDim.x) {
      const int i = idx / nq, j = idx - i * nq;
      // μ, ρ and ε of element j (weights, then biases)
      const int jm = j < nw ? j : nw + j, jr = j < nw ? nw + j : nw + o + j;
      const float e = eps_of(n, eps, l, j, c.s0 + i);
      float* th = c.mine(out, i) + n.qoff[l];
      if (gdir) {
        const float* gl = gdir + n.poff[l];
        th[j] = __ldcg(gl + jm) + sigmoid_f(__ldcg(pl + jr)) * __ldcg(gl + jr) * e;
      } else {
        th[j] = __ldcg(pl + jm) + softplus_f(__ldcg(pl + jr)) * e;
      }
    }
  }
  __syncthreads();
}

// z^l_i[pt,:] = a^{l-1}_i[pt,:]·W_iᵀ + b_i layer by layer, a thread an
// output, over the NP points: the inner kernels' M points of u, or
// nested_outer's M points of u and then the B rows of xb.
__device__ __forceinline__ void blk_forward(const Net& n, const Ctx& c, const float* u,
                                            const float* xb, const Slot& TH, const Slot& Z) {
  const int M = n.NP;
  for (int l = 0; l < n.L; ++l) {
    const int in = n.in[l], o = n.out[l], per = M * o;
    for (int idx = threadIdx.x; idx < c.ns * per; idx += blockDim.x) {
      const int i = idx / per, r = idx - i * per, pt = r / o, oo = r - pt * o;
      const float* th = c.mine(TH, i) + n.qoff[l];
      const float* w = th + oo * in;
      float* z = c.mine(Z, i);
      float acc = 0.f;
      if (l == 0) {
        const float* a = pt < n.M ? u + pt * in : xb + (pt - n.M) * in;
        for (int k = 0; k < in; ++k) acc = fmaf(a[k], w[k], acc);
      } else {
        const float* a = z + M * n.cumo[l - 1] + pt * in;
        for (int k = 0; k < in; ++k) {
          const float x = a[k];
          acc = fmaf(x > 0.f ? x : 0.f, w[k], acc);
        }
      }
      z[M * n.cumo[l] + r] = acc + th[o * in + oo];
    }
    __syncthreads();
  }
}

// ż^l_i = ȧ^{l-1}_i·W_iᵀ + a^{l-1}_i·Ẇ_iᵀ + ḃ_i (the data carries no tangent).
__device__ __forceinline__ void blk_tangent_forward(const Net& n, const Ctx& c, const float* u,
                                                    const Slot& TH, const Slot& THD,
                                                    const Slot& Z, const Slot& ZD) {
  const int M = n.M;
  for (int l = 0; l < n.L; ++l) {
    const int in = n.in[l], o = n.out[l], per = M * o;
    for (int idx = threadIdx.x; idx < c.ns * per; idx += blockDim.x) {
      const int i = idx / per, r = idx - i * per, pt = r / o, oo = r - pt * o;
      const float* w = c.mine(TH, i) + n.qoff[l] + oo * in;
      const float* thd = c.mine(THD, i) + n.qoff[l];
      const float* wd = thd + oo * in;
      float* zd = c.mine(ZD, i);
      float acc = 0.f;
      if (l == 0) {
        const float* a = u + pt * in;
        for (int k = 0; k < in; ++k) acc = fmaf(a[k], wd[k], acc);
      } else {
        const int q = M * n.cumo[l - 1] + pt * in;
        const float* a = c.mine(Z, i) + q;
        const float* ad = zd + q;
        for (int k = 0; k < in; ++k) {
          const float x = a[k];
          acc = fmaf(x > 0.f ? ad[k] : 0.f, w[k], acc);
          acc = fmaf(x > 0.f ? x : 0.f, wd[k], acc);
        }
      }
      zd[M * n.cumo[l] + r] = acc + thd[o * in + oo];
    }
    __syncthreads();
  }
}

// Inner head: δ^L_i = cw·∂NLL/∂Z. Returns this thread's share of
// Σ_i Σ_m cw_m·NLL.
__device__ __forceinline__ float blk_head(const Net& n, const Ctx& c, const void* y,
                                          const float* cw, const Slot& Z, const Slot& DL) {
  const int M = n.M, nc = n.out[n.L - 1], top = M * n.cumo[n.L - 1];
  float part = 0.f;
  for (int idx = threadIdx.x; idx < c.ns * M; idx += blockDim.x) {
    const int i = idx / M, pt = idx - i * M, q = top + pt * nc;
    part += cw[pt] * head(n, c.mine(Z, i) + q, y, pt, cw[pt], c.mine(DL, i) + q);
  }
  __syncthreads();
  return part;
}

// δ^{l-1}_i = (δ^l_i·W_i) ⊙ 1[z^{l-1}_i > 0] for l = L-1..1, a thread an
// output, over the NP points; with THD and DD the tangent δ̇^{l-1} =
// (δ̇^l·W + δ^l·Ẇ) ⊙ 1[z > 0] into DD instead.
__device__ __forceinline__ void blk_backward(const Net& n, const Ctx& c, const Slot& TH,
                                             const Slot& Z, const Slot& DL, const Slot* THD,
                                             const Slot* DD) {
  const int M = n.NP;
  for (int l = n.L - 1; l >= 1; --l) {
    const int in = n.in[l], o = n.out[l], per = M * in;
    for (int idx = threadIdx.x; idx < c.ns * per; idx += blockDim.x) {
      const int i = idx / per, r = idx - i * per, pt = r / in, k = r - pt * in;
      const float* d = c.mine(DL, i) + M * n.cumo[l] + pt * o;
      const float* w = c.mine(TH, i) + n.qoff[l] + k;
      const bool on = c.mine(Z, i)[M * n.cumo[l - 1] + r] > 0.f;
      float acc = 0.f;
      if (DD) {
        const float* e = c.mine(*DD, i) + M * n.cumo[l] + pt * o;
        const float* wd = c.mine(*THD, i) + n.qoff[l] + k;
        for (int oo = 0; oo < o; ++oo) {
          acc = fmaf(e[oo], w[oo * in], acc);
          acc = fmaf(d[oo], wd[oo * in], acc);
        }
        c.mine(*DD, i)[M * n.cumo[l - 1] + r] = on ? acc : 0.f;
      } else {
        for (int oo = 0; oo < o; ++oo) acc = fmaf(d[oo], w[oo * in], acc);
        c.mine(DL, i)[M * n.cumo[l - 1] + r] = on ? acc : 0.f;
      }
    }
    __syncthreads();
  }
}

// G_i[q] = Σ_pt δ^l_i[pt,oo]·a^{l-1}_i[pt,k] of every weight (of every
// bias, Σ_pt δ^l_i[pt,oo]), the points in order, a thread a (sample,
// element), into X_i[q], and G_i[q]·ε_i[q] into X_i[nE + q]. Both kernels'
// inner gradient comes from here. A cluster barrier follows it.
__device__ __forceinline__ void blk_sample_sums(const Net& n, const Ctx& c, const float* u,
                                                const float* eps, const Slot& Z, const Slot& DL,
                                                const Slot& X) {
  const int M = n.M;
  for (int l = 0; l < n.L; ++l) {
    const int in = n.in[l], o = n.out[l], nw = o * in, nq = nw + o;
    for (int idx = threadIdx.x; idx < c.ns * nq; idx += blockDim.x) {
      const int i = idx / nq, j = idx - i * nq;
      const float ep = eps_of(n, eps, l, j, c.s0 + i);
      const int oo = j < nw ? j / in : j - nw, k = j - oo * in;
      const float* d = c.mine(DL, i) + M * n.cumo[l] + oo;
      float acc = 0.f;
      if (j >= nw) {
        for (int pt = 0; pt < M; ++pt) acc += d[pt * o];
      } else if (l == 0) {
        const float* a = u + k;
        for (int pt = 0; pt < M; ++pt) acc = fmaf(d[pt * o], a[pt * in], acc);
      } else {
        const float* a = c.mine(Z, i) + M * n.cumo[l - 1] + k;
        for (int pt = 0; pt < M; ++pt) {
          const float x = a[pt * in];
          acc = fmaf(d[pt * o], x > 0.f ? x : 0.f, acc);
        }
      }
      float* x = c.mine(X, i) + n.qoff[l] + j;
      x[0] = acc;
      x[n.nE] = acc * ep;
    }
  }
}

// The per-sample tangent sums: Ġ_i[q] = Σ_pt δ̇·a + δ·ȧ of every weight and
// bias into GD_i[q] and Ġ_i[q]·ε_i[q] into GD_i[nE + q], and ū_i[m,k] =
// Σ_oo δ̇^0_i[m,oo]·W0_i[oo,k] + δ^0_i[m,oo]·Ẇ0_i[oo,k] into US. A cluster
// barrier follows it.
__device__ __forceinline__ void blk_tangent_sums(const Net& n, const Ctx& c, const float* u,
                                                 const float* eps, const Slot& TH,
                                                 const Slot& THD, const Slot& Z, const Slot& DL,
                                                 const Slot& ZD, const Slot& DD, const Slot& GD,
                                                 const Slot& US) {
  const int M = n.M;
  for (int l = 0; l < n.L; ++l) {
    const int in = n.in[l], o = n.out[l], nw = o * in, nq = nw + o;
    for (int idx = threadIdx.x; idx < c.ns * nq; idx += blockDim.x) {
      const int i = idx / nq, j = idx - i * nq;
      const float ep = eps_of(n, eps, l, j, c.s0 + i);
      const int oo = j < nw ? j / in : j - nw, k = j - oo * in;
      const float* d = c.mine(DL, i) + M * n.cumo[l] + oo;
      const float* e = c.mine(DD, i) + M * n.cumo[l] + oo;
      float acc = 0.f;
      if (j >= nw) {
        for (int pt = 0; pt < M; ++pt) acc += e[pt * o];
      } else if (l == 0) {
        const float* a = u + k;
        for (int pt = 0; pt < M; ++pt) acc = fmaf(e[pt * o], a[pt * in], acc);
      } else {
        const int q = M * n.cumo[l - 1] + k;
        const float* a = c.mine(Z, i) + q;
        const float* ad = c.mine(ZD, i) + q;
        for (int pt = 0; pt < M; ++pt) {
          const float x = a[pt * in];
          acc = fmaf(e[pt * o], x > 0.f ? x : 0.f, acc);
          acc = fmaf(d[pt * o], x > 0.f ? ad[pt * in] : 0.f, acc);
        }
      }
      float* x = c.mine(GD, i) + n.qoff[l] + j;
      x[0] = acc;
      x[n.nE] = acc * ep;
    }
  }
  const int D = n.in[0], o = n.out[0], MD = M * D;
  for (int idx = threadIdx.x; idx < c.ns * MD; idx += blockDim.x) {
    const int i = idx / MD, r = idx - i * MD, m = r / D, k = r - m * D;
    const float* d = c.mine(DL, i) + m * o;
    const float* e = c.mine(DD, i) + m * o;
    const float* w = c.mine(TH, i) + k;
    const float* wd = c.mine(THD, i) + k;
    float acc = 0.f;
    for (int oo = 0; oo < o; ++oo) {
      acc = fmaf(e[oo], w[oo * D], acc);
      acc = fmaf(d[oo], wd[oo * D], acc);
    }
    c.mine(US, i)[r] = acc;
  }
}

// The owners' sums over samples. Work item w of [0, count) goes to a group
// of S lanes of a warp (⌊32/S⌋ groups a warp): lane k of the group loads
// sample k's two entries, load(w, k, x, xe), all in one round of remote
// loads; the group adds them in sample order with shuffles (the same order,
// and so the same bits, as one thread adding them s = 0..S-1), and its lane
// 0 runs done(w, Σ x, Σ xe). Every lane of a warp runs the same rounds.
template <class Load, class Done>
__device__ __forceinline__ void by_groups(int count, int S, const Load& load, const Done& done) {
  const int G = 32 / S, lane = threadIdx.x & 31, grp = lane / S, k = lane - grp * S;
  const int src0 = (grp < G ? grp : 0) * S;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int w0 = warp * G; w0 < count; w0 += nwarps * G) {
    const int w = w0 + grp;
    const bool on = grp < G && w < count;
    float x = 0.f, xe = 0.f;
    if (on) load(w, k, x, xe);
    float sx = 0.f, sxe = 0.f;
    for (int s = 0; s < S; ++s) {
      sx += __shfl_sync(0xffffffffu, x, src0 + s);
      sxe += __shfl_sync(0xffffffffu, xe, src0 + s);
    }
    if (on && k == 0) done(w, sx, sxe);
  }
}

// This block's samples, and each sample's block and index there.
__device__ __forceinline__ Ctx make_ctx(const Net& n, const Plan& pl, unsigned char* blk,
                                        unsigned char* loc) {
  const int r = (int)cg::this_cluster().block_rank(), S = n.S, C = pl.C;
  Ctx c;
  c.s0 = r * S / C;
  c.ns = (r + 1) * S / C - c.s0;
  c.shared = pl.shared;
  c.blk = blk;
  c.loc = loc;
  const int s = threadIdx.x;
  if (s < S) {
    int b = 0;
    while ((b + 1) * S / C <= s) ++b;
    blk[s] = (unsigned char)b;
    loc[s] = (unsigned char)(s - b * S / C);
  }
  __syncthreads();
  return c;
}

// The launch's dynamic shared memory.
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 dyn4[];
  return reinterpret_cast<float*>(dyn4);
}

// Adam's bias corrections (1 − β₁ᵗ, √(1 − β₂ᵗ)) of every iteration into
// bc[2(t−1)], bc[2(t−1)+1], a thread an iteration: double-precision pow is
// long enough to matter once an iteration. Block-private; a barrier follows.
__device__ __forceinline__ void bias_corrections(const Net& n, float* bc) {
  for (int t = threadIdx.x; t < n.T; t += blockDim.x) bias_corr(n, t + 1, bc[2 * t], bc[2 * t + 1]);
}

// nested_fwd. Shared memory: cw (M, padded to 4 floats), then, with the maps
// there, spb copies each of θ (nE), z and δ (M·U), and G with G·ε (2·nE).
// Global mode: θ, z, δ at theta, z, delta and G at xg, S copies each. lpart
// holds each warp's share of each iteration's loss, T·C·32 floats; bcs each
// block's bias corrections, C·2T floats.
__global__ void __launch_bounds__(FWD_THREADS)
nested_fwd_kernel(const __grid_constant__ Net n, const __grid_constant__ Plan pl,
                  const float* __restrict__ p0, const float* __restrict__ u,
                  const void* __restrict__ y,
                  const float* __restrict__ v, const float* __restrict__ alpha,
                  const float* __restrict__ eps, float* losses, float* hist, float* cw,
                  float* theta, float* z, float* delta, float* xg, float* lpart, float* bcs) {
  __shared__ float sh[33];
  __shared__ unsigned char blk[MAXS], loc[MAXS];
  PHASE_INIT;
  PHASE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = pl.C, spb = pl.spb;
  const int P = n.P, M = n.M, nE = n.nE, MU = M * n.U;
  const Ctx c = make_ctx(n, pl, blk, loc);
  float* cws = dyn_smem();
  float* base = cws + ((M + 3) & ~3);
  const Slot TH = slot(pl, base, theta, nE), Z = slot(pl, base + spb * nE, z, MU);
  const Slot DL = slot(pl, base + spb * (nE + MU), delta, MU);
  const Slot X = slot(pl, base + spb * (nE + 2 * MU), xg, 2 * nE);
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  float* bc = bcs + 2 * n.T * r;
  int qlo, qhi;
  owned(nE, r, C, qlo, qhi);
  bias_corrections(n, bc);
  core_weights(n, v, alpha, cws, sh);  // ends with a barrier
  if (r == 0) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) cw[j] = cws[j];
  }
  for (int q = qlo + threadIdx.x; q < qhi; q += blockDim.x) {
    const int l = layer_of(n, q);
    const Elem e(n, l, q - n.qoff[l]);
    const int js[2] = {n.poff[l] + e.jm, n.poff[l] + e.jr};
    for (int k = 0; k < 2; ++k) {
      hist[js[k]] = p0[js[k]];
      hist[P + js[k]] = 0.f;
      hist[2 * P + js[k]] = 0.f;
    }
  }
  PHASE(1);
  for (int t = 1; t <= n.T; ++t) {
    // p_{t-1}: at t > 1 every block's writes of the last iteration
    const float* p = t == 1 ? p0 : hist + (t - 1) * 3 * P;
    const float* m = hist + (t - 1) * 3 * P + P;
    const float* nv = m + P;
    float* p1 = hist + t * 3 * P;
    float* m1 = p1 + P;
    float* n1 = p1 + 2 * P;
    const float* et = eps + (t - 1) * n.E;
    blk_sample(n, c, p, nullptr, et, TH);
    PHASE(2);
    blk_forward(n, c, u, u, TH, Z);
    PHASE(3);
    float part = blk_head(n, c, y, cws, Z, DL);
    PHASE(4);
    blk_backward(n, c, TH, Z, DL, nullptr, nullptr);
    PHASE(5);
    blk_sample_sums(n, c, u, et, Z, DL, X);
    PHASE(20);
    cluster.sync();  // every sample's G is written
    PHASE(6);
    const float bc1 = bc[2 * (t - 1)], bc2s = bc[2 * (t - 1) + 1];
    // this slice's inner gradient (Σ_s G_s, Σ_s G_s·ε_s) and Adam step
    by_groups(qhi - qlo, n.S,
              [&](int w, int k, float& x, float& xe) {
                x = c.peer(X, k, qlo + w);
                xe = c.peer(X, k, nE + qlo + w);
              },
              [&](int w, float gs, float gse) {
                const int q = qlo + w, l = layer_of(n, q), off = n.poff[l];
                const Elem e(n, l, q - n.qoff[l]);
                const int qq[2] = {off + e.jm, off + e.jr};
                const float mu = __ldcg(p + qq[0]), rho = __ldcg(p + qq[1]);
                const float sd = softplus_f(rho), sg = sigmoid_f(rho);
                const float g[2] = {gs + mu * n.sp2inv, sg * (gse - 1.f / sd + sd * n.sp2inv)};
                const float pv[2] = {mu, rho};
                part += logf(n.prior_sd / sd) +
                        (sd * sd + mu * mu) / (2.f * n.prior_sd * n.prior_sd) - 0.5f;
                for (int k = 0; k < 2; ++k) {
                  const float mo = b1 * m[qq[k]] + c1 * g[k];
                  const float no = b2 * nv[qq[k]] + c2 * (g[k] * g[k]);
                  const float den = (no > 0.f ? sqrtf(no) : 0.f) / bc2s + n.adam_eps;
                  m1[qq[k]] = mo;
                  n1[qq[k]] = no;
                  p1[qq[k]] = pv[k] - n.lr * (mo / bc1) / den;
                }
              });
    part = warp_sum(part);
    if ((threadIdx.x & 31) == 0) lpart[((t - 1) * C + r) * NWARPS + (threadIdx.x >> 5)] = part;
    PHASE(18);
    cluster.sync();  // p_t is written, and no block reads G any more
    PHASE(7);
  }
  // each inner loss: the blocks' and warps' shares in order
  if (r == 0) {
    for (int t = threadIdx.x; t < n.T; t += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < C * NWARPS; ++k) acc += __ldcg(lpart + t * C * NWARPS + k);
      losses[t] = acc;
    }
  }
  PHASE(16);
  PHASE_END;
}

// ---------------------------------------------------------------------------
// nested_outer: a cluster of blocks, each over its own samples, one pass

// Each own sample's NLL at every point (the pseudo points' into NL), and its
// three per-sample sums into SC: the pseudo NLL Σ_m cw_m·NLL, the data NLL
// N/B·Σ_b NLL and log p(θ) − log q(θ) over its nE elements. The block's warps
// are dealt to its samples, ⌊32/ns⌋ each; a warp's lanes take the points and
// the elements in a fixed stride, the warp adds its lanes by shuffles, and
// thread i adds sample i's warps in order. red holds ≥ 96 floats.
__device__ __forceinline__ void outer_nll_sums(const Net& n, const Ctx& c, const float* pT,
                                               const float* cw, const void* y, const void* yb,
                                               const Slot& TH, const Slot& Z, const Slot& NL,
                                               const Slot& SC, float* red) {
  const float sp = n.prior_sd, hl2pi = 0.91893853320467274178f;  // ½·log 2π
  const int M = n.M, NP = n.NP, nc = n.out[n.L - 1], top = NP * n.cumo[n.L - 1];
  const int lane = threadIdx.x & 31, nw = (blockDim.x >> 5) / c.ns;
  const int i = (threadIdx.x >> 5) / nw, wi = (threadIdx.x >> 5) - i * nw;
  float ps = 0.f, da = 0.f, nk = 0.f;
  if (i < c.ns) {
    const float* Z0 = c.mine(Z, i) + top;
    for (int pt = wi * 32 + lane; pt < NP; pt += nw * 32) {
      if (pt < M) {
        const float x = head(n, Z0 + pt * nc, y, pt, 0.f, nullptr);
        c.mine(NL, i)[pt] = x;
        ps = fmaf(cw[pt], x, ps);
      } else {
        da += head(n, Z0 + pt * nc, yb, pt - M, 0.f, nullptr);
      }
    }
    const float* th = c.mine(TH, i);
    for (int q = wi * 32 + lane; q < n.nE; q += nw * 32) {
      const int l = layer_of(n, q);
      const Elem e(n, l, q - n.qoff[l]);
      const float* pl = pT + n.poff[l];
      const float mu = pl[e.jm], sd = softplus_f(pl[e.jr]);
      const float a = th[q] / sp, r = (th[q] - mu) / sd;
      nk += (-0.5f * a * a - logf(sp) - hl2pi) - (-0.5f * r * r - logf(sd) - hl2pi);
    }
  }
  ps = warp_sum(ps);
  da = warp_sum(da);
  nk = warp_sum(nk);
  if (lane == 0 && i < c.ns) {
    float* rw = red + 3 * (i * nw + wi);
    rw[0] = ps;
    rw[1] = da;
    rw[2] = nk;
  }
  __syncthreads();
  if ((int)threadIdx.x < c.ns) {
    float sum[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < nw; ++w)
      for (int k = 0; k < 3; ++k) sum[k] += red[3 * (threadIdx.x * nw + w) + k];
    float* sc = c.mine(SC, threadIdx.x);
    sc[0] = sum[0];
    sc[1] = n.NB * sum[1];
    sc[2] = sum[2];
  }
}

// The self-normalised IW weights of the S samples, the loss (block 0 writes
// it) and ∂loss/∂{pseudo, data, nkl} of each sample into cf = [c_ps | c_da |
// c_nk] (MAXS each): thread s < S reads sample s's sums into tr = [pseudo |
// data | nkl], then thread 0 works them out in sample order, the same bits
// in every block. Ends with a barrier.
__device__ __forceinline__ void outer_coefficients(const Net& n, const Ctx& c, const Slot& SC,
                                                   float* tr, float* cf, float* loss, int r) {
  const int S = n.S;
  float *sh_ps = tr, *sh_da = tr + MAXS, *sh_nk = tr + 2 * MAXS;
  float *c_ps = cf, *c_da = cf + MAXS, *c_nk = cf + 2 * MAXS;
  if ((int)threadIdx.x < S) {
    const int s = threadIdx.x;
    sh_ps[s] = c.peer(SC, s, 0);
    sh_da[s] = c.peer(SC, s, 1);
    sh_nk[s] = c.peer(SC, s, 2);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
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
    if (r == 0) loss[0] = dref + dcbar - mean_lw;
  }
  __syncthreads();
}

// The head's δ of each own sample at every point: c_ps·cw_m·∂NLL/∂Z at the
// pseudo points, c_da·N/B·∂NLL/∂Z at the minibatch rows.
__device__ __forceinline__ void outer_head(const Net& n, const Ctx& c, const float* cw,
                                           const void* y, const void* yb, const float* cf,
                                           const Slot& Z, const Slot& DL) {
  const int M = n.M, NP = n.NP, nc = n.out[n.L - 1], top = NP * n.cumo[n.L - 1];
  for (int idx = threadIdx.x; idx < c.ns * NP; idx += blockDim.x) {
    const int i = idx / NP, pt = idx - i * NP, s = c.s0 + i, q = top + pt * nc;
    const float* Zp = c.mine(Z, i) + q;
    float* d = c.mine(DL, i) + q;
    if (pt < M) head(n, Zp, y, pt, cf[s] * cw[pt], d);
    else head(n, Zp, yb, pt - M, cf[MAXS + s] * n.NB, d);
  }
  __syncthreads();
}

// Each own sample's p̄_T partials and ū, one work list over the layers, a
// thread an item (at the main paths every item has a thread of its own).
// Element q of layer l: G = Σ_pt δ^l[pt,oo]·a^{l-1}[pt,k] over the NP points
// in order (the bias: Σ_pt δ), then with the NKL's terms, thb = G +
// c_nk·(−θ/σ_p² + r/σ), r = (θ − μ)/σ, the μ part thb − c_nk·r/σ into
// X_i[q] and the σ part ε·thb + c_nk·(1 − r²)/σ into X_i[nE + q]. Item nE +
// m·D + k: ū_i[m,k] = Σ_oo δ^0_i[m,oo]·W0_i[oo,k] into US. A cluster barrier
// follows it.
__device__ __forceinline__ void outer_sample_sums(const Net& n, const Ctx& c, const float* pT,
                                                  const float* u, const float* xb,
                                                  const float* eps, const float* c_nk,
                                                  const Slot& TH, const Slot& Z, const Slot& DL,
                                                  const Slot& X, const Slot& US) {
  const int M = n.M, NP = n.NP, nE = n.nE, D = n.in[0], per = nE + M * D;
  for (int idx = threadIdx.x; idx < c.ns * per; idx += blockDim.x) {
    const int i = idx / per, q = idx - i * per, s = c.s0 + i;
    const float* th = c.mine(TH, i);
    if (q >= nE) {
      const int r = q - nE, m = r / D, k = r - m * D, o = n.out[0];
      const float* d = c.mine(DL, i) + m * o;
      float acc = 0.f;
      for (int oo = 0; oo < o; ++oo) acc = fmaf(d[oo], th[oo * D + k], acc);
      c.mine(US, i)[r] = acc;
      continue;
    }
    const int l = layer_of(n, q), j = q - n.qoff[l];
    const int in = n.in[l], o = n.out[l], nw = o * in;
    const int oo = j < nw ? j / in : j - nw, k = j - oo * in;
    const float* d = c.mine(DL, i) + NP * n.cumo[l] + oo;
    float acc = 0.f;
    if (j >= nw) {
      for (int pt = 0; pt < NP; ++pt) acc += d[pt * o];
    } else if (l == 0) {
      for (int pt = 0; pt < M; ++pt) acc = fmaf(d[pt * o], u[pt * in + k], acc);
      for (int pt = M; pt < NP; ++pt) acc = fmaf(d[pt * o], xb[(pt - M) * in + k], acc);
    } else {
      const float* a = c.mine(Z, i) + NP * n.cumo[l - 1] + k;
      for (int pt = 0; pt < NP; ++pt) {
        const float x = a[pt * in];
        acc = fmaf(d[pt * o], x > 0.f ? x : 0.f, acc);
      }
    }
    const float* pl = pT + n.poff[l];
    const Elem e(n, l, j);
    const float mu = pl[e.jm], sd = softplus_f(pl[e.jr]);
    const float r = (th[q] - mu) / sd, cn = c_nk[s];
    const float thb = acc + cn * (-th[q] * n.sp2inv + r / sd);
    float* x = c.mine(X, i) + q;
    x[0] = thb - cn * r / sd;
    x[nE] = eps_of(n, eps, l, j, s) * thb + cn * (1.f - r * r) / sd;
  }
}

// The owned slice [mlo, mhi) of c̄w and z̄: c̄w_m = Σ_s c_ps·(NLL_s − mean_s
// NLL), the NLL centred over the samples (the c_ps sum to zero, so the value
// is the same, but the part of the NLL that all samples share — for a
// Gaussian head most of it, the log-normaliser — no longer cancels in fp32),
// and under the Gaussian head z̄_m = −Σ_s δ^L[s, m] (zeros for class labels).
// by_groups' lanes: lane k of a group loads sample k's NLL and δ, the group
// adds them in sample order with shuffles.
__device__ __forceinline__ void outer_cwbar_zbar(const Net& n, const Ctx& c, const float* c_ps,
                                                 const Slot& NL, const Slot& DL, int mlo, int mhi,
                                                 float* cwbar, float* zbar) {
  const int S = n.S, G = 32 / S, lane = threadIdx.x & 31, grp = lane / S, k = lane - grp * S;
  const int src0 = (grp < G ? grp : 0) * S, top = n.NP * n.cumo[n.L - 1];
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, count = mhi - mlo;
  for (int w0 = warp * G; w0 < count; w0 += nwarps * G) {
    const int m = mlo + w0 + grp;
    const bool on = grp < G && w0 + grp < count;
    float x = 0.f, xd = 0.f;
    if (on) {
      x = c.peer(NL, k, m);
      if (n.gaussian) xd = c.peer(DL, k, top + m);
    }
    float mean = 0.f, zs = 0.f;
    for (int s = 0; s < S; ++s) {
      mean += __shfl_sync(0xffffffffu, x, src0 + s);
      zs += __shfl_sync(0xffffffffu, xd, src0 + s);
    }
    mean /= S;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      acc = fmaf(c_ps[s], __shfl_sync(0xffffffffu, x, src0 + s) - mean, acc);
    }
    if (on && k == 0) {
      cwbar[m] = acc;
      zbar[m] = n.gaussian ? -zs : 0.f;
    }
  }
}

// nested_outer. Shared memory, with the maps there: spb copies each of θ
// (nE), z and δ over the NP = M + B points (NP·U), the p̄_T partials (2·nE),
// ū_i (M·D), the pseudo NLLs (M) and the per-sample sums (4). Global mode:
// θ, z, δ at theta, z, delta, and the partials, ū_i, NLLs and sums at xg, S
// copies each. Block r owns slices of p̄_T's elements, of ū and of c̄w, z̄:
// it adds the S samples' partials in sample order.
__global__ void __launch_bounds__(OUTER_THREADS)
nested_outer_kernel(const __grid_constant__ Net n, const __grid_constant__ Plan pl,
                    const float* __restrict__ pT, const float* __restrict__ u,
                    const void* __restrict__ y, const float* __restrict__ cw,
                    const float* __restrict__ xb, const void* __restrict__ yb,
                    const float* __restrict__ eps, float* loss, float* pbar, float* ubar,
                    float* cwbar, float* zbar, float* theta, float* z, float* delta, float* xg) {
  // first each warp's per-sample sums (outer_nll_sums), then the S samples'
  // sums; then c_ps, c_da, c_nk
  __shared__ float sh[3 * MAXS], cf[3 * MAXS];
  __shared__ unsigned char blk[MAXS], loc[MAXS];
  PHASE_INIT;
  PHASE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = pl.C, spb = pl.spb, S = n.S;
  const int nE = n.nE, MD = n.M * n.in[0], NPU = n.NP * n.U;
  const Ctx c = make_ctx(n, pl, blk, loc);
  float* base = dyn_smem();
  const Slot TH = slot(pl, base, theta, nE), Z = slot(pl, base + spb * nE, z, NPU);
  const Slot DL = slot(pl, base + spb * (nE + NPU), delta, NPU);
  float* sums = base + spb * (nE + 2 * NPU);
  const Slot X = slot(pl, sums, xg, 2 * nE);
  const Slot US = slot(pl, sums + spb * 2 * nE, xg + S * 2 * nE, MD);
  const Slot NL = slot(pl, sums + spb * (2 * nE + MD), xg + S * (2 * nE + MD), n.M);
  const Slot SC = slot(pl, sums + spb * (2 * nE + MD + n.M), xg + S * (2 * nE + MD + n.M), 4);
  int qlo, qhi, ulo, uhi, mlo, mhi;
  owned(nE, r, C, qlo, qhi);
  owned(MD, r, C, ulo, uhi);
  owned(n.M, r, C, mlo, mhi);
  PHASE(1);
  blk_sample(n, c, pT, nullptr, eps, TH);
  PHASE(2);
  blk_forward(n, c, u, xb, TH, Z);
  PHASE(3);
  outer_nll_sums(n, c, pT, cw, y, yb, TH, Z, NL, SC, sh);
  PHASE(22);
  cluster.sync();  // every sample's sums are written
  PHASE(6);
  outer_coefficients(n, c, SC, sh, cf, loss, r);
  PHASE(23);
  outer_head(n, c, cw, y, yb, cf, Z, DL);
  PHASE(4);
  blk_backward(n, c, TH, Z, DL, nullptr, nullptr);
  PHASE(5);
  outer_sample_sums(n, c, pT, u, xb, eps, cf + 2 * MAXS, TH, Z, DL, X, US);
  PHASE(20);
  cluster.sync();  // every sample's partials are written
  PHASE(7);
  // this block's slices of p̄_T and ū, the samples in order: one work list
  const int nq = qhi - qlo;
  by_groups(nq + (uhi - ulo), S,
            [&](int w, int k, float& x, float& xe) {
              if (w < nq) {
                x = c.peer(X, k, qlo + w);
                xe = c.peer(X, k, nE + qlo + w);
              } else {
                x = c.peer(US, k, ulo + w - nq);
              }
            },
            [&](int w, float sx, float sxe) {
              if (w < nq) {
                const int q = qlo + w, l = layer_of(n, q), off = n.poff[l];
                const Elem e(n, l, q - n.qoff[l]);
                pbar[off + e.jm] = sx;
                pbar[off + e.jr] = sxe * sigmoid_f(pT[off + e.jr]);
              } else {
                ubar[ulo + w - nq] = sx;
              }
            });
  PHASE(15);
  outer_cwbar_zbar(n, c, cf, NL, DL, mlo, mhi, cwbar, zbar);
  PHASE(14);
  cluster.sync();  // no block reads another's shared memory any more
  PHASE(16);
  PHASE_END;
}

// nested_rev. Shared memory, with the maps there: spb copies each of θ, θ̇
// (nE), z, δ, ż, δ̇ (M·U), G with G·ε and Ġ with Ġ·ε (2·nE each), ū_i (M·D)
// and the tangent NLL (M). Global mode: the maps at theta, thetad, z, delta,
// zd, dd, the tangent NLL at nlld, and G, Ġ, ū_i at xg, S copies each. h,
// gbar, pbar, mbar, nbar (P) and cwbar (M) are global scratch; each block
// touches only its slice, but gbar, which every block reads after a cluster
// barrier. bcs: each block's bias corrections, C·2T floats.
__global__ void __launch_bounds__(REV_THREADS)
nested_rev_kernel(const __grid_constant__ Net n, const __grid_constant__ Plan pl,
                  const float* __restrict__ hist, const float* __restrict__ pbar_in,
                  const float* __restrict__ ubar_in,
                  const float* __restrict__ cwbar_in, const float* __restrict__ zbar_in,
                  const float* __restrict__ u, const void* __restrict__ y,
                  const float* __restrict__ cw, const float* __restrict__ v,
                  const float* __restrict__ alpha, const float* __restrict__ eps, float* g_u,
                  float* g_v, float* g_alpha, float* g_z, float* theta, float* thetad,
                  float* z, float* delta, float* zd, float* dd, float* nlld, float* h,
                  float* gbar, float* pbar, float* mbar, float* nbar, float* cwbar, float* xg,
                  float* bcs) {
  __shared__ float sh[33];
  __shared__ unsigned char blk[MAXS], loc[MAXS];
  PHASE_INIT;
  PHASE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = pl.C, spb = pl.spb;
  const int P = n.P, S = n.S, M = n.M, D = n.in[0], nc = n.out[n.L - 1];
  const int nE = n.nE, MU = M * n.U, MD = M * D, top = M * n.cumo[n.L - 1];
  const Ctx c = make_ctx(n, pl, blk, loc);
  float* base = dyn_smem();
  const Slot TH = slot(pl, base, theta, nE), THD = slot(pl, base + spb * nE, thetad, nE);
  float* maps = base + 2 * spb * nE;
  const Slot Z = slot(pl, maps, z, MU), DL = slot(pl, maps + spb * MU, delta, MU);
  const Slot ZD = slot(pl, maps + 2 * spb * MU, zd, MU);
  const Slot DD = slot(pl, maps + 3 * spb * MU, dd, MU);
  float* sums = maps + 4 * spb * MU;
  const Slot X = slot(pl, sums, xg, 2 * nE);
  const Slot GD = slot(pl, sums + 2 * spb * nE, xg + 2 * S * nE, 2 * nE);
  const Slot US = slot(pl, sums + 4 * spb * nE, xg + 4 * S * nE, MD);
  const Slot NL = slot(pl, sums + 4 * spb * nE + spb * MD, nlld, M);
  const float b1 = (float)n.b1, b2 = (float)n.b2;
  const float c1 = (float)(1.0 - n.b1), c2 = (float)(1.0 - n.b2);
  float* bc = bcs + 2 * n.T * r;
  int qlo, qhi, ulo, uhi, mlo, mhi;
  owned(nE, r, C, qlo, qhi);
  owned(MD, r, C, ulo, uhi);
  owned(M, r, C, mlo, mhi);
  bias_corrections(n, bc);
  for (int q = qlo + threadIdx.x; q < qhi; q += blockDim.x) {
    const int l = layer_of(n, q);
    const Elem e(n, l, q - n.qoff[l]);
    const int js[2] = {n.poff[l] + e.jm, n.poff[l] + e.jr};
    for (int k = 0; k < 2; ++k) {
      pbar[js[k]] = pbar_in[js[k]];
      mbar[js[k]] = 0.f;
      nbar[js[k]] = 0.f;
    }
  }
  for (int j = ulo + threadIdx.x; j < uhi; j += blockDim.x) g_u[j] = ubar_in[j];
  for (int j = mlo + threadIdx.x; j < mhi; j += blockDim.x) {
    cwbar[j] = cwbar_in[j];
    g_z[j] = zbar_in[j];
  }
  __syncthreads();  // the bias corrections
  PHASE(1);
  for (int t = n.T; t >= 1; --t) {
    const float* p = hist + (t - 1) * 3 * P;
    const float* mt = hist + t * 3 * P + P;
    const float* nt = hist + t * 3 * P + 2 * P;
    const float* et = eps + (t - 1) * n.E;
    // recompute iteration t's forward and first-order gradient at p_{t-1}
    blk_sample(n, c, p, nullptr, et, TH);
    PHASE(2);
    blk_forward(n, c, u, u, TH, Z);
    PHASE(3);
    blk_head(n, c, y, cw, Z, DL);
    PHASE(4);
    blk_backward(n, c, TH, Z, DL, nullptr, nullptr);
    PHASE(5);
    blk_sample_sums(n, c, u, et, Z, DL, X);
    PHASE(20);
    cluster.sync();  // every sample's G is written
    PHASE(6);
    const float bc1 = bc[2 * (t - 1)], bc2s = bc[2 * (t - 1) + 1];
    // Adam VJP: (p̄_t, m̄, n̄) → ḡ_t and the carried m̄, n̄, for this slice
    by_groups(qhi - qlo, S,
              [&](int w, int k, float& x, float& xe) {
                x = c.peer(X, k, qlo + w);
                xe = c.peer(X, k, nE + qlo + w);
              },
              [&](int w, float gs, float gse) {
                const int q = qlo + w, l = layer_of(n, q), off = n.poff[l];
                const Elem e(n, l, q - n.qoff[l]);
                const int qq[2] = {off + e.jm, off + e.jr};
                const float mu = p[qq[0]], rho = p[qq[1]];
                const float sd = softplus_f(rho), sg = sigmoid_f(rho);
                const float hr = gse - 1.f / sd + sd * n.sp2inv;  // ∂L/∂σ
                const float g[2] = {gs + mu * n.sp2inv, sg * hr};
                h[qq[1]] = hr;
                for (int k = 0; k < 2; ++k) {
                  const float nq = nt[qq[k]];
                  const float den = (nq > 0.f ? sqrtf(nq) : 0.f) / bc2s + n.adam_eps;
                  const float pb = pbar[qq[k]];
                  const float mb = mbar[qq[k]] - pb * n.lr / (bc1 * den);
                  const float dsq = nq > 0.f ? 0.5f / sqrtf(nq) : 0.f;
                  const float nb =
                      nbar[qq[k]] + pb * n.lr * (mt[qq[k]] / bc1) / (den * den) * dsq / bc2s;
                  gbar[qq[k]] = c1 * mb + 2.f * c2 * g[k] * nb;
                  mbar[qq[k]] = b1 * mb;
                  nbar[qq[k]] = b2 * nb;
                }
              });
    PHASE(18);
    cluster.sync();  // ḡ_t is written, and no block reads G any more
    PHASE(7);
    // tangent pass in direction ḡ_t
    blk_sample(n, c, p, gbar, et, THD);
    PHASE(9);
    blk_tangent_forward(n, c, u, TH, THD, Z, ZD);
    PHASE(10);
    for (int idx = threadIdx.x; idx < c.ns * M; idx += blockDim.x) {
      const int i = idx / M, m = idx - i * M, q = top + m * nc;
      c.mine(NL, i)[m] = head_tangent(n, c.mine(Z, i) + q, c.mine(ZD, i) + q, y, m, cw[m],
                                      c.mine(DD, i) + q);
    }
    __syncthreads();
    PHASE(11);
    blk_backward(n, c, TH, Z, DL, &THD, &DD);
    PHASE(12);
    blk_tangent_sums(n, c, u, et, TH, THD, Z, DL, ZD, DD, GD, US);
    PHASE(21);
    cluster.sync();  // every sample's tangent sums are written
    PHASE(13);
    // this slice of p̄_{t-1} = p̄_t + H·ḡ_t, ū, c̄w and z̄, the samples in
    // order: one work list
    const int nq = qhi - qlo, nu = uhi - ulo, nm = mhi - mlo;
    by_groups(nq + nu + nm, S,
              [&](int w, int k, float& x, float& xe) {
                if (w < nq) {
                  x = c.peer(GD, k, qlo + w);
                  xe = c.peer(GD, k, nE + qlo + w);
                } else if (w < nq + nu) {
                  x = c.peer(US, k, ulo + w - nq);
                } else {
                  x = c.peer(NL, k, mlo + w - nq - nu);
                  if (n.gaussian) xe = c.peer(DD, k, top + mlo + w - nq - nu);
                }
              },
              [&](int w, float sx, float sxe) {
                if (w < nq) {
                  const int q = qlo + w, l = layer_of(n, q), off = n.poff[l];
                  const Elem e(n, l, q - n.qoff[l]);
                  const int jm = off + e.jm, jr = off + e.jr;
                  const float rho = p[jr], gm = gbar[jm], gr = gbar[jr];
                  const float sd = softplus_f(rho), sg = sigmoid_f(rho);
                  pbar[jm] += sx + gm * n.sp2inv;
                  pbar[jr] += sg * (1.f - sg) * gr * h[jr] +
                              sg * (sxe + (1.f / (sd * sd) + n.sp2inv) * sg * gr);
                } else if (w < nq + nu) {
                  g_u[ulo + w - nq] += sx;
                } else {
                  const int m = mlo + w - nq - nu;
                  cwbar[m] += sx;
                  if (n.gaussian) g_z[m] -= sxe;  // z̄ −= Σ_s δ̇^L[s, m]
                }
              });
    PHASE(15);
  }
  cluster.sync();  // c̄w is whole, and no block reads another's shared memory any more
  if (r == 0) {
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
      const float cb = __ldcg(cwbar + j);
      dot = fmaf(f, scale * cb, dot);
      ga = fmaf(cb, cw[j], ga);
    }
    dot = block_sum(dot, sh);
    ga = block_sum(ga, sh);
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      const float fb = scale * __ldcg(cwbar + j);
      g_v[j] = n.parameterised ? (expf(v[j] - mx) / se) * (fb - dot) : fb;
    }
    if (threadIdx.x == 0) g_alpha[0] = n.use_alpha ? ga : 0.f;
  }
  PHASE(16);
  PHASE_END;
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
  int poff = 0, eoff = 0, units = 0;
  for (int l = 0; l < n->L; ++l) {
    n->in[l] = dims[8 + l];
    n->out[l] = dims[9 + l];
    n->poff[l] = poff;
    n->eoff[l] = eoff;
    n->qoff[l] = eoff / n->S;
    n->cumo[l] = units;
    poff += 2 * (n->out[l] * n->in[l] + n->out[l]);
    eoff += n->S * (n->out[l] * n->in[l] + n->out[l]);
    units += n->out[l];
  }
  n->P = poff;
  n->E = eoff;
  n->nE = eoff / n->S;
  n->U = units;
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

// A plan's C blocks, ⌈S/C⌉ samples at most a block, and shared bytes:
// `fixed` floats a block plus, with the maps in shared memory, `per` floats
// a sample it holds (_nested_plan computes the same).
static bool plan_ok(const Net& n, const Plan& pl, long long per, long long fixed) {
  if (pl.C < 1 || pl.C > MAX_CLUSTER || pl.C > n.S || pl.spb != (n.S + pl.C - 1) / pl.C) {
    return false;
  }
  const long long need = 4 * (fixed + (pl.shared ? pl.spb * per : 0));
  return need == pl.smem && need <= SMEM_CAP;
}

// One cluster of the plan's C blocks.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(const Plan& pl, int threads, void* stream) : attr(), cfg() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = pl.C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(pl.C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// plan = [C, spb, shared, smem bytes] (_nested_plan); xg: the per-sample
// sums in global mode (2·E floats); lpart: T·C·32 floats; bcs: C·2T floats.
extern "C" int psvi_nested_fwd(const float* p0, const float* u, const void* y, const float* v,
                               const float* alpha, const float* eps, float* losses, float* hist,
                               float* cw, float* theta, float* z, float* delta, float* xg,
                               float* lpart, float* bcs, const int* plan, const int* dims,
                               const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 0)) return (int)cudaErrorInvalidValue;
  const Plan pl{plan[0], plan[1], plan[2], plan[3]};
  if (!plan_ok(n, pl, 3LL * n.nE + 2LL * n.M * n.U, (n.M + 3) & ~3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(nested_fwd_kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(pl, FWD_THREADS, stream);
  return (int)cudaLaunchKernelEx(&cl.cfg, nested_fwd_kernel, n, pl, p0, u, y, v, alpha, eps,
                                 losses, hist, cw, theta, z, delta, xg, lpart, bcs);
}

// plan as psvi_nested_fwd's; xg: the per-sample partials, ū_i, pseudo NLLs
// and sums in global mode (2·E + S·M·D + S·M + 4·S floats).
extern "C" int psvi_nested_outer(const float* pT, const float* u, const void* y, const float* cw,
                                 const float* xb, const void* yb, const float* eps, float* loss,
                                 float* pbar, float* ubar, float* cwbar, float* zbar,
                                 float* theta, float* z, float* delta, float* xg, const int* plan,
                                 const int* dims, const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 1)) return (int)cudaErrorInvalidValue;
  const Plan pl{plan[0], plan[1], plan[2], plan[3]};
  const long long per = 3LL * n.nE + 2LL * n.NP * n.U + (long long)n.M * n.in[0] + n.M + 4;
  if (!plan_ok(n, pl, per, 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(nested_outer_kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(pl, OUTER_THREADS, stream);
  return (int)cudaLaunchKernelEx(&cl.cfg, nested_outer_kernel, n, pl, pT, u, y, cw, xb, yb, eps,
                                 loss, pbar, ubar, cwbar, zbar, theta, z, delta, xg);
}

// plan as psvi_nested_fwd's; xg: the per-sample sums in global mode
// (4·E + S·M·D floats); bcs: C·2T floats.
extern "C" int psvi_nested_rev(const float* hist, const float* pbar_in, const float* ubar_in,
                               const float* cwbar_in, const float* zbar_in, const float* u,
                               const void* y, const float* cw, const float* v,
                               const float* alpha, const float* eps, float* g_u, float* g_v,
                               float* g_alpha, float* g_z, float* theta, float* thetad,
                               float* z, float* delta, float* zd, float* dd, float* nlld,
                               float* h, float* gbar, float* pbar, float* mbar, float* nbar,
                               float* cwbar, float* xg, float* bcs, const int* plan,
                               const int* dims, const double* hyper, void* stream) {
  Net n;
  if (make_net(&n, dims, hyper, 0)) return (int)cudaErrorInvalidValue;
  const Plan pl{plan[0], plan[1], plan[2], plan[3]};
  const long long per = 6LL * n.nE + 4LL * n.M * n.U + (long long)n.M * n.in[0] + n.M;
  if (!plan_ok(n, pl, per, 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(nested_rev_kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch cl(pl, REV_THREADS, stream);
  return (int)cudaLaunchKernelEx(&cl.cfg, nested_rev_kernel, n, pl, hist, pbar_in, ubar_in,
                                 cwbar_in, zbar_in, u, y, cw, v, alpha, eps, g_u, g_v, g_alpha,
                                 g_z, theta, thetad, z, delta, zd, dd, nlld, h, gbar, pbar, mbar,
                                 nbar, cwbar, xg, bcs);
}
