// The sampled-linear forward shared by kernels B3 (sampled_linear.cu,
// k_sampled_linear: eps read from memory) and B4a (sampled_linear_prng.cu,
// k_prng_fwd: eps drawn in the kernel):
//
//   y[s] = x[s] . W_s^T + b_s,   W_s = mu_w + softplus(rho_w) * eps_w[s]
//
// with x (S, N, Din), y (S, N, Dout), fp32 and row-major. Both kernels run
// sampled_fwd_block below and differ only in how a block builds its tile of
// W_s and b_s (the BuildW and BuildB functors each .cu defines). B4a draws
// its tile through cluster_draw_rows below, which B4b's k_prng_dx shares.
//
// The block. The grid is Dout / 32 x n_splits x S. A block owns (sample s,
// 32 outputs o0 .. o0 + 31, one split of N: a run of whole 64-point tiles,
// as _split_bounds(N, n_splits, 64) in ../sampled_linear_prng.py cuts it;
// the plan is _fwd_plan in ../sampled_linear.py). It builds W_s[o0 .. o0 +
// 31, :] once, in dynamic shared memory, and b_s[o0 .. o0 + 31] once, then
// walks its split's tiles, each through Din in chunks of 32 columns: the x
// chunks (64 points x 32 columns) come through a ring of four stages filled
// with cp.async, three in flight while one is used, and the first three are
// issued before W_s is built, so their copies overlap the build. 16-byte
// copies where x's rows are a multiple of 4 floats and 16-byte aligned, else
// 4-byte copies. Where Din exceeds KW = 512 columns, the block walks Din in
// chunks of 512: it builds each chunk of W_s in turn and adds that chunk's
// sum into the y rows it owns (the first chunk adds the bias), so one block
// owns each output and the order is fixed.
//
// Shared memory, all dynamic but b_s: W_s's tile is R x WS floats, R =
// min(32, Dout rounded up to 16) rows and WS = min(Din, 512) rounded up to
// 32, plus 4 (a row stride of 4 mod 8 floats puts the eight rows of a
// fragment load on distinct banks); the x ring after it is 4 x 64 x 36
// floats. At fc1 (400 -> 120) 53,760 + 36,864 bytes, at most 66,048 +
// 36,864: two blocks fit on a SM. A 64-output block (one a SM) and deeper
// rings (6 or 8 stages, or 64-column chunks) were no faster on an H100
// (scripts/torch_b4_backward_sweep.py and PERF.md).
//
// The product loop: 3xTF32 on the tensor cores with fp32 accumulation. Each
// operand is split as a = a_hi + a_lo, a_hi = cvt.rna.tf32(a), a_lo =
// cvt.rna.tf32(a - a_hi), as its fragment is loaded from shared memory (W_s
// stays fp32 in shared memory: its split form would double the tile and
// leave one block a SM). Each warp owns 16 points x 16 outputs, 1 x 2 tiles
// of mma.sync.m16n8k8.tf32; per 8 columns of Din it issues a_hi.b_lo and
// a_lo.b_hi into one accumulator (the small terms) and a_hi.b_hi into
// another, and the epilogue adds the two. a_lo.b_lo is dropped: it and the
// rounding of a_lo are each about 2^-22 of a product, so y keeps fp32
// accuracy (one TF32 pass keeps about three digits, and does not hold the
// kernels' gate of 1e-5 * max|ref| against the plain fp32 version). This
// corrected product is allowed on B3 and B4a, once_differentiable
// first-order ops, and only there: every product on the second-order nested
// path runs in true fp32 (psvi_torch/device.py). The mma order is fixed and
// there are no atomics, so a rerun gives the same bits, whatever the split
// count. Ragged edges are zeros in shared memory: points past N, columns
// past Din (up to the 32-column chunk) and outputs past Dout (up to 16); a
// warp whose points or outputs all lie past the edge skips its mma steps.
//
// What bounds it on the card, as measured (H100, PERF.md): a block walks
// its tiles one after another, and a 64 x 32 tile over Din = 400 takes about
// 12 us: the x copies, the operand splits and the mma steps, each about a
// third, overlap little with eight warps a block. So the plan evens out the
// tiles a split walks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// cp.async: a copy from device memory into shared memory that the issuing
// thread does not wait for. A commit closes a group of the copies issued so
// far; wait<n> holds the thread until all but the newest n groups have
// landed, and a barrier after it shows them to the whole block. The 16-byte
// form needs both addresses 16-byte aligned; the 4-byte form takes any float.
static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows of length D whose every row starts 16-byte aligned: the 16-byte copies.
static inline bool rows_of_float4(const void* p, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

static __device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

namespace slgemm {

constexpr int THREADS = 256;  // eight warps: 4 (points) x 2 (outputs)
constexpr int BN = 64;        // points a tile
constexpr int BO = 32;        // outputs a block
constexpr int KC = 32;        // Din columns a staged x chunk
constexpr int KW = 512;       // most Din columns of W_s resident at once
constexpr int STAGES = 4;     // x chunks in the ring: three in flight while one is used
constexpr int XS = KC + 4;    // row stride of a staged x chunk (4 mod 8: no bank conflicts)

static __host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows of the W_s tile a block with outputs from o0 builds: up to 32, the
// outputs past Dout up to a multiple of 16 (a warp's width) as zeros.
static __host__ __device__ __forceinline__ int tile_rows(int Dout, int o0) {
  const int r = cdiv(Dout - o0, 16) * 16;
  return r < BO ? r : BO;
}

// Columns of a resident chunk of W_s, padded to whole x chunks (at least one).
static __host__ __device__ __forceinline__ int chunk_cols(int kw) {
  return (kw > 0 ? cdiv(kw, KC) : 1) * KC;
}

// Row stride of the resident W_s tile.
static __host__ __device__ __forceinline__ int w_stride(int Din) {
  return chunk_cols(Din < KW ? Din : KW) + 4;
}

// Dynamic shared memory of a block: the largest W_s tile, then the x ring.
static inline int smem_bytes(int Din, int Dout) {
  return (tile_rows(Dout, 0) * w_stride(Din) + STAGES * BN * XS) * static_cast<int>(sizeof(float));
}

// Static shared memory of a block: b_s.
constexpr int STATIC_BYTES = BO * static_cast<int>(sizeof(float));

// Above 48 KB in all a block must ask for its shared memory.
template <class Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem + STATIC_BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// x[s, n0 .. n0 + 63, k0 .. k0 + 31] into dst (row-major, as in x); zero
// past N or past Din.
static __device__ __forceinline__ void stage_x(float (*dst)[XS], const float* xg, int n0, int N,
                                               int k0, int Din, bool vec, int tid) {
  if (vec) {  // Din % 4 == 0, so a 4-float group lies inside [0, Din) or outside it
    for (int v = tid; v < BN * KC / 4; v += THREADS) {
      const int r = v / (KC / 4), q = v % (KC / 4), n = n0 + r, k = k0 + 4 * q;
      float* d = &dst[r][4 * q];
      if (n < N && k < Din) {
        cp_async16(d, xg + (long long)n * Din + k);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = tid; e < BN * KC; e += THREADS) {
      const int r = e / KC, c = e % KC, n = n0 + r, k = k0 + c;
      if (n < N && k < Din) {
        cp_async4(&dst[r][c], xg + (long long)n * Din + k);
      } else {
        dst[r][c] = 0.f;
      }
    }
  }
}

// A tile of W_s drawn once for a thread block cluster (B4a's k_prng_fwd and
// B4b's k_prng_dx): ws holds `rows` rows of `cols` drawn columns at row
// stride ldw, and the rows go in groups of `group`. Block `rank` of the
// cluster's n_splits draws groups [rank, rank + 1) * groups / n_splits into
// its own ws, then copies the other blocks' groups out of their shared
// memory (distributed shared memory), keeping four 16-byte loads a thread in
// flight; so each element is drawn once for the cluster. Where the tile has
// fewer groups than the cluster has blocks, each block draws all of it: two
// cluster barriers cost more than the draws they save. draw(r, c) gives
// element (r, c), zero past the tile's edges. A draw is a long dependent
// chain behind two loads, so each thread runs four side by side,
// neighbouring threads on neighbouring columns of a row. ws is 16-byte
// aligned and ldw a multiple of 4. On return ws is whole, and no block of
// the cluster reads another's shared memory any more.
template <class Draw>
static __device__ __forceinline__ void cluster_draw_rows(float* ws, int ldw, int cols, int rows,
                                                         int group, int n_splits,
                                                         const Draw& draw) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), tid = threadIdx.x;
  const int groups = rows / group;
  const bool share = n_splits > 1 && groups >= n_splits;
  const int e_lo = share ? group * (rank * groups / n_splits) * cols : 0;
  const int e_hi = share ? group * ((rank + 1) * groups / n_splits) * cols : rows * cols;
  for (int e0 = e_lo + tid; e0 < e_hi; e0 += 4 * THREADS) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS, r = e / cols, c = e % cols;
      if (e < e_hi) ws[r * ldw + c] = draw(r, c);
    }
  }
  if (!share) return;
  cluster.sync();  // every block's rows are written
  for (int q = 0; q < n_splits; ++q) {
    if (q == rank) continue;
    const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(ws, q));
    float4* dst = reinterpret_cast<float4*>(ws);
    const int lo = group * (q * groups / n_splits) * ldw / 4;
    const int hi = group * ((q + 1) * groups / n_splits) * ldw / 4;
    for (int v0 = lo + tid; v0 < hi; v0 += 4 * THREADS) {
      float4 t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (v0 + u * THREADS < hi) t[u] = src[v0 + u * THREADS];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (v0 + u * THREADS < hi) dst[v0 + u * THREADS] = t[u];
      }
    }
  }
  cluster.sync();  // no block writes its ws again, or exits, while another reads it
}

// a = hi + lo, each a TF32 value (cvt.rna: round to nearest, ties away from
// zero) in a 32-bit register with its low 13 bits zero.
static __device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  hi &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
  lo &= 0xffffe000u;
}

// d += a . b for one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 fp32.
static __device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragments of m16n8k8 TF32 (PTX ISA, "Matrix fragments for mma.m16n8k8"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8, a[r][k]): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
//   B (8 x 8, b[k][n]):  b0 = (t, g), b1 = (t + 4, g)
//   D (16 x 8, d[r][n]): d0 = (g, 2t), d1 = (g, 2t + 1), d2 = (g + 8, 2t), d3 = (g + 8, 2t + 1)
// A is x (rows points, columns Din) and B is W_s^T, read from W_s's rows
// (w[n][k], row stride ldw): B's column layout.
static __device__ __forceinline__ void load_a(const float* p, int ld, int g, int t,
                                              unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_tf32(p[g * ld + t], hi[0], lo[0]);
  split_tf32(p[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(p[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

static __device__ __forceinline__ void load_b(const float* w, int ldw, int g, int t,
                                              unsigned (&hi)[2], unsigned (&lo)[2]) {
  split_tf32(w[g * ldw + t], hi[0], lo[0]);
  split_tf32(w[g * ldw + t + 4], hi[1], lo[1]);
}

// The warp's 16 x 16 tile over one 32-column chunk: xc is the staged x chunk
// at the warp's first point, wc W_s at the warp's first output and the
// chunk's first column. small gets the cross terms, big a_hi.b_hi.
static __device__ __forceinline__ void mma_chunk(const float* xc, const float* wc, int ldw, int g,
                                                 int t, float (&big)[2][4], float (&small)[2][4]) {
#pragma unroll
  for (int k8 = 0; k8 < KC; k8 += 8) {
    unsigned ah[4], al[4], bh[2][2], bl[2][2];
    load_a(xc + k8, XS, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < 2; ++j) load_b(wc + 8 * j * ldw + k8, ldw, g, t, bh[j], bl[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma_tf32(small[j], ah, bl[j]);
      mma_tf32(small[j], al, bh[j]);
      mma_tf32(big[j], ah, bh[j]);
    }
  }
}

// One block's share of y (see the note at the top). build_w(ws, ldw, s, k0,
// cols, rows) writes W_s[o0 + r, k0 + c] to ws[r * ldw + c] for r < rows and
// c < cols, with zeros past Dout and past Din, and leaves it visible to the
// whole block's next barrier; build_b(bs, s) writes b_s[o0 + r] to bs[r] for
// r < 32 (zero past Dout) from threads r.
template <class BuildW, class BuildB>
static __device__ __forceinline__ void sampled_fwd_block(const float* __restrict__ x,
                                                         float* __restrict__ y, float* ws, int S,
                                                         int N, int Din, int Dout, int n_splits,
                                                         bool x_vec, const BuildW& build_w,
                                                         const BuildB& build_b) {
  __shared__ float bs[BO];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // the warp's points 16 wm .., outputs 16 wn ..
  const int o0 = blockIdx.x * BO, rows = tile_rows(Dout, o0), ldw = w_stride(Din);
  // the cp.async ring after the largest W_s tile: stage st is xs[st * BN + n][k]
  float(*xs)[XS] = reinterpret_cast<float(*)[XS]>(ws + tile_rows(Dout, 0) * ldw);
  // this split's N tiles, as _split_bounds(N, n_splits, 64) cuts them
  const int tiles = cdiv(N, BN);
  const int t_begin = (int)((long long)blockIdx.y * tiles / n_splits);
  const int t_end = (int)((long long)(blockIdx.y + 1) * tiles / n_splits);
  const bool warp_o = o0 + 16 * wn < Dout;
  float big[2][4], small[2][4];

  for (int s = blockIdx.z; s < S; s += gridDim.z) {
    const float* xg = x + (long long)s * N * Din;
    float* yg = y + (long long)s * N * Dout;
    for (int k0 = 0; k0 < (Din > 0 ? Din : 1); k0 += KW) {
      const int cols = chunk_cols(min(KW, Din - k0)), chunks = cols / KC;
      // step j: N tile t_begin + j / chunks, x chunk j % chunks; the ring
      // runs on across tile boundaries
      const int steps = (t_end - t_begin) * chunks;
      auto stage = [&](int j) {
        stage_x(xs + (j % STAGES) * BN, xg, (t_begin + j / chunks) * BN, N,
                k0 + (j % chunks) * KC, Din, x_vec, tid);
      };
      __syncthreads();  // no thread still reads the ring, W_s or b_s
      // the first chunks of x are in flight while the block builds W_s
      for (int j = 0; j < STAGES - 1; ++j) {
        if (j < steps) stage(j);
        cp_async_commit();
      }
      if (k0 == 0) build_b(bs, s);
      build_w(ws, ldw, s, k0, cols, rows);
      for (int j = 0; j < steps; ++j) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // chunk j has landed, W_s is built, step j - 1's stage is free
        if (j + STAGES - 1 < steps) stage(j + STAGES - 1);
        cp_async_commit();
        const int n0 = (t_begin + j / chunks) * BN, c = j % chunks;
        if (c == 0) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int r = 0; r < 4; ++r) big[jj][r] = small[jj][r] = 0.f;
        }
        if (warp_o && n0 + 16 * wm < N) {
          mma_chunk(&xs[(j % STAGES) * BN + 16 * wm][0], ws + 16 * wn * ldw + c * KC, ldw, g, t,
                    big, small);
        }
        if (c == chunks - 1) {  // the tile's sum over this chunk of Din: into y
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int n = n0 + 16 * wm + g + 8 * (r / 2);
              const int oo = 16 * wn + 8 * jj + 2 * t + r % 2, o = o0 + oo;
              if (n < N && o < Dout) {
                float* yp = yg + (long long)n * Dout + o;
                const float v = big[jj][r] + small[jj][r];
                *yp = k0 == 0 ? v + bs[oo] : *yp + v;
              }
            }
        }
      }
    }
  }
}

}  // namespace slgemm
