// Dense arrow-block SpMM for NVIDIA Hopper (sm_90a): the two products of
// one arrow level whose blocks are stored as dense (nb, w, w) stacks,
// against features blocked like the rows, X (nb, w, k) float32:
//
//   K2 column_blocks_spmm:  out[b] = A_bb X_b + A_b0 X_0
//                                    [+ A_b,b-1 X_{b-1} + A_b,b+1 X_{b+1}]
//                           for b = 1 .. nb-1 (block row 0 is K3's);
//   K3 head_blocks_spmm:    out[0] = sum_b A_0b X_b.
//
// K2 runs over a range of block rows b = first .. first + rows - 1 of
// the operand, its stacks and output holding those rows only: one
// level's rows 1 .. nb-1, or a mesh rank's own blocks inside its operand
// [X_0; X_prev; own; X_next] with no blocks stored for the others.
//
// Blocks are float32 or bfloat16 (a template parameter); sums are
// float32; the output is float32 and written once.  The JAX package's TPU
// kernels these replace are ops/pallas_blocks.py:column_spmm_pallas
// (bodies _column_kernel and _column_kernel_banded) for K2 and
// ops/pallas_blocks.py:head_spmm_pallas (body _head_kernel) for K3.
// Their VMEM row-tile budget does not carry over; neither do the shifted
// copies x_lo / x_hi that arrow_spmm_pallas concatenates: K2 indexes
// X_{b-1} and X_{b+1} directly, skipping X_{nb} (which would be zero)
// with a bound check.  Nor does the TPU head kernel's sequential grid,
// which revisits one output tile with b innermost: CTAs run in no order.
//
// Bound.  Every block is read once (K2: 2 or 4 stacks; K3: 1) and does
// 2k operations per 4 (f32) or 2 (bf16) bytes.  At k = 16 that is 8
// operations a byte for f32 blocks, under the card's 20 (67 TFLOP/s of
// f32 FMA over 3.35 TB/s): bytes bound both kernels.  At k = 128 it is
// 64 a byte: float32 FMA throughput bounds them.
//
// Design.  A tiled SIMT GEMM on the f32 pipe, no tensor cores (TF32
// would leave the float32 validation gate; split-TF32 is later work).
// A CTA owns a BM-row tile of one block row and BN feature columns; each
// thread holds a TM x TN float32 micro-tile (rows ty + TY i, columns in
// float4 groups (tx + TX g) * 4).  Three configurations, chosen by k
// (ops/cuda_blocks.py:TILES mirrors the choice):
//   Narrow  k <= 16   64 x 16 outputs,   64 threads of 4 x 4,
//                     4 stages (3 with bf16 blocks), ~5 CTAs an SM;
//   Mid     k <= 64  128 x 64 outputs,  256 threads of 8 x 4, 3 stages;
//   Wide    k >  64  128 x 128 outputs, 256 threads of 8 x 8, 4 stages,
//                     one CTA an SM with up to 255 registers.
// At k = 128 one Wide CTA covers all 128 feature columns, so each block
// tile is read from memory once, and the 8 x 8 micro-tile needs half the
// shared-memory reads per FMA of a 4 x 4 one.  Narrow keeps the grid
// wide where bytes bind (992 K2 CTAs at nb = 32, w = 2048).
//
// The contraction runs over a flat sequence of BK = 32-deep tiles: every
// (A, X) pair of the CTA (K2: 2 to 4; K3: its chunk of b) times
// ceil(w / BK) tiles, through a ring of STAGES (A tile, X tile) buffers
// in dynamic shared memory.  Tiles are copied with cp.async.cg, 16 bytes
// a copy, STAGES - 1 tiles ahead of the one being multiplied, so loads
// overlap FMAs across tiles and across pairs; one __syncthreads a tile
// both publishes the landed tile and frees the buffer the next copy
// overwrites.  A bf16 tile is copied raw and widened to f32 when read
// into registers.  The ragged edge (w or k off a tile) is zero-filled by
// cp.async's src-size operand.  Where a 16-byte copy cannot be used (w
// not a multiple of 16 / sizeof(block), k not a multiple of 4, or an
// operand not 16-byte aligned: the wrapper's `vec`), the same ring is
// filled by plain masked loads.  The A tile's row stride is BK plus one
// 16-byte chunk, so the compute loop's reads do not conflict on a bank.
//
// K3 splits the block axis: CTA z of pass 1 sums its contiguous chunk of
// b into partial z of a (S, w, k) float32 workspace the caller
// allocates; pass 2 adds the S partials in the order z = 0 .. S-1 into
// the output (with S = 1, pass 1 writes the output and pass 2 is
// skipped).  The caller picks the chunk from the shapes alone
// (ops/cuda_blocks.py:head_split), so the sum order is fixed.  Two
// launches rather than a last-CTA-reduces counter: no fences, no
// counter to reset, and pass 2 costs a few microseconds.  Each output
// element of K2 and K3 is summed in one fixed order (no atomics), so
// runs are bit-identical.  Every offset into A, X, the workspace and out
// is 64-bit (nb * w * w passes 2^31 at n = 2^20, w = 2048).
//
// Interface: plain C, built with nvcc -shared and loaded with ctypes
// (ops/_build.py, ops/cuda_blocks.py).  Launches go on the caller's
// stream; nothing is allocated or synchronised here.  The return value
// is cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;        // contraction depth of one tile

template <int BM_, int BN_, int TM_, int TN_, int AV_, int STAGES_F32_,
          int STAGES_BF16_, int MINB_>
struct Cfg {
  static constexpr int BM = BM_;          // output rows of a CTA
  static constexpr int BN = BN_;          // feature columns of a CTA
  static constexpr int TM = TM_;          // rows of a thread
  static constexpr int TN = TN_;          // columns of a thread
  static constexpr int AV = AV_;          // depth of one block-value read
  static constexpr int STAGES_F32 = STAGES_F32_;    // ring buffers, f32
  static constexpr int STAGES_BF16 = STAGES_BF16_;  // ring buffers, bf16
  static constexpr int MINB = MINB_;      // CTAs an SM should hold
  static constexpr int TX = BN / TN;      // threads along the columns
  static constexpr int TY = BM / TM;      // threads along the rows
  static constexpr int NT = TX * TY;
  static_assert(TN % 4 == 0, "columns come in float4 groups");
  static_assert(AV == 2 || AV == 4, "block values are read 2 or 4 deep");
};

// Wide runs one CTA an SM: its 8 x 8 micro-tile takes about 170
// registers, over the 128 that two CTAs an SM would allow, and 2-deep
// block reads keep fewer values live.  Narrow takes 4 buffers with f32
// blocks and 3 with bf16 ones, so that more CTAs fit an SM for the
// widening work (PERF.md, PR 4).
using Narrow = Cfg<64, 16, 4, 4, 4, 4, 3, 4>;
using Mid = Cfg<128, 64, 8, 4, 4, 3, 3, 2>;
using Wide = Cfg<128, 128, 8, 8, 2, 4, 4, 1>;

// Shared-memory layout of one ring buffer: the BM x BK block tile (raw
// block dtype, row stride AS) then the BK x BN feature tile.
template <typename TA, class C>
struct Ring {
  static constexpr int STAGES =
      sizeof(TA) == 4 ? C::STAGES_F32 : C::STAGES_BF16;
  static constexpr int AS = BK + 16 / static_cast<int>(sizeof(TA));
  static constexpr int A_BYTES = C::BM * AS * static_cast<int>(sizeof(TA));
  static constexpr int X_BYTES = BK * C::BN * 4;
  static constexpr int STAGE = A_BYTES + X_BYTES;
  static constexpr int BYTES = STAGE * STAGES;
  static_assert(STAGES >= 2, "a ring needs two buffers");
  static_assert(A_BYTES % 16 == 0 && X_BYTES % 16 == 0, "16-byte buffers");
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;       // src-size 0: sixteen zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two or four consecutive block values as f32, from shared memory
// aligned to their size (a bf16 value widens by a shift).
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load_a(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load_a(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load_a(const __nv_bfloat16* p,
                                       float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(u.x);
  v[1] = bf16_hi(u.x);
  v[2] = bf16_lo(u.y);
  v[3] = bf16_hi(u.y);
}
__device__ __forceinline__ void load_a(const __nv_bfloat16* p,
                                       float (&v)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  v[0] = bf16_lo(u);
  v[1] = bf16_hi(u);
}

// Fill one ring buffer with the block tile of `a` at (row0, k0) and the
// feature tile of `x` at (k0, n0), zero outside the operands.  VEC: as
// 16-byte cp.async copies (asynchronous; the caller commits), else as
// plain masked loads.
template <typename TA, bool VEC, class C>
__device__ __forceinline__ void load_tile(const TA* __restrict__ a,
                                          const float* __restrict__ x,
                                          int w, int k, int row0, int n0,
                                          int k0, TA* sa, float* sx,
                                          int tid) {
  constexpr int AS = Ring<TA, C>::AS;
  if constexpr (VEC) {
    constexpr int E = 16 / static_cast<int>(sizeof(TA));   // 4 f32, 8 bf16
    constexpr int PER_ROW = BK / E;
    constexpr int CHUNKS = C::BM * PER_ROW;
    static_assert(CHUNKS % C::NT == 0, "whole block chunks per thread");
#pragma unroll
    for (int it = 0; it < CHUNKS / C::NT; ++it) {
      const int c = it * C::NT + tid;
      const int m = c / PER_ROW;
      const int kk = (c % PER_ROW) * E;
      const int r = row0 + m;
      const int col = k0 + kk;
      const bool in = r < w && col < w;    // w % E == 0: all in or all out
      cp_async_16(sa + m * AS + kk,
                  in ? a + static_cast<int64_t>(r) * w + col : a, in);
    }
    constexpr int X_ROW = C::BN / 4;
    constexpr int X_CHUNKS = BK * X_ROW;
    static_assert(X_CHUNKS % C::NT == 0, "whole feature chunks per thread");
#pragma unroll
    for (int it = 0; it < X_CHUNKS / C::NT; ++it) {
      const int c = it * C::NT + tid;
      const int kk = c / X_ROW;
      const int n = (c % X_ROW) * 4;
      const int r = k0 + kk;
      const int col = n0 + n;
      const bool in = r < w && col < k;    // k % 4 == 0: all in or all out
      cp_async_16(sx + kk * C::BN + n,
                  in ? x + static_cast<int64_t>(r) * k + col : x, in);
    }
  } else {
    static_assert((C::BM * BK) % C::NT == 0, "whole elements per thread");
#pragma unroll 4
    for (int it = 0; it < C::BM * BK / C::NT; ++it) {
      const int c = it * C::NT + tid;
      const int m = c / BK;
      const int kk = c % BK;
      const int r = row0 + m;
      const int col = k0 + kk;
      sa[m * AS + kk] = (r < w && col < w)
                            ? a[static_cast<int64_t>(r) * w + col]
                            : TA(0.0f);
    }
    static_assert((BK * C::BN) % C::NT == 0, "whole elements per thread");
#pragma unroll 4
    for (int it = 0; it < BK * C::BN / C::NT; ++it) {
      const int c = it * C::NT + tid;
      const int kk = c / C::BN;
      const int n = c % C::BN;
      const int r = k0 + kk;
      const int col = n0 + n;
      sx[kk * C::BN + n] = (r < w && col < k)
                               ? x[static_cast<int64_t>(r) * k + col]
                               : 0.0f;
    }
  }
}

// acc += (block tile) @ (feature tile) for one ring buffer, kk in order.
template <typename TA, class C>
__device__ __forceinline__ void multiply(const TA* sa, const float* sx,
                                         int tx, int ty,
                                         float (&acc)[C::TM][C::TN]) {
  constexpr int AS = Ring<TA, C>::AS;
#pragma unroll
  for (int kk = 0; kk < BK; kk += C::AV) {
    float av[C::TM][C::AV];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      load_a(sa + (ty + i * C::TY) * AS + kk, av[i]);
    }
#pragma unroll
    for (int j = 0; j < C::AV; ++j) {
      float xv[C::TN];
#pragma unroll
      for (int g = 0; g < C::TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            sx + (kk + j) * C::BN + (tx + g * C::TX) * 4);
        xv[4 * g] = v.x;
        xv[4 * g + 1] = v.y;
        xv[4 * g + 2] = v.z;
        xv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
#pragma unroll
        for (int n = 0; n < C::TN; ++n) {
          acc[i][n] = fmaf(av[i][j], xv[n], acc[i][n]);
        }
      }
    }
  }
}

// acc += sum over the CTA's (A, X) pairs p < npairs of A_p[row tile, :]
// @ X_p[:, column tile], through the ring.  `pairs.a(p)` and
// `pairs.x(p)` give pair p's (w, w) block and (w, k) feature block.
template <typename TA, bool VEC, class C, class Pairs>
__device__ __forceinline__ void mainloop(const Pairs& pairs, int npairs,
                                         int w, int k, int row0, int n0,
                                         unsigned char* smem,
                                         float (&acc)[C::TM][C::TN]) {
  using R = Ring<TA, C>;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  const int per = (w + BK - 1) / BK;
  const int total = npairs * per;
  auto issue = [&](int t) {
    if (t < total) {
      const int p = t / per;
      const int k0 = (t - p * per) * BK;
      unsigned char* buf = smem + (t % R::STAGES) * R::STAGE;
      load_tile<TA, VEC, C>(pairs.a(p), pairs.x(p), w, k, row0, n0, k0,
                            reinterpret_cast<TA*>(buf),
                            reinterpret_cast<float*>(buf + R::A_BYTES), tid);
    }
    if constexpr (VEC) cp_async_commit();   // empty groups keep the count
  };
#pragma unroll 1
  for (int t = 0; t < R::STAGES - 1; ++t) issue(t);
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if constexpr (VEC) cp_async_wait<R::STAGES - 2>();   // tile t landed
    // Every thread's copies of tile t are visible, and every thread is
    // done with tile t - 1, whose buffer the next issue overwrites.
    __syncthreads();
    issue(t + R::STAGES - 1);
    const unsigned char* buf = smem + (t % R::STAGES) * R::STAGE;
    multiply<TA, C>(reinterpret_cast<const TA*>(buf),
                    reinterpret_cast<const float*>(buf + R::A_BYTES), tx, ty,
                    acc);
  }
}

template <bool VEC, class C>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int w,
                                           int k, int row0, int n0,
                                           const float (&acc)[C::TM][C::TN]) {
  const int tx = threadIdx.x % C::TX;
  const int ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = row0 + ty + i * C::TY;
    if (r >= w) continue;
    float* row = out + static_cast<int64_t>(r) * k;
#pragma unroll
    for (int g = 0; g < C::TN / 4; ++g) {
      const int c = n0 + (tx + g * C::TX) * 4;
      if (VEC && c + 4 <= k) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < k) row[c + q] = acc[i][4 * g + q];
        }
      }
    }
  }
}

// K2's pairs of operand block row b, stored at z = b - first: (A_bb,
// X_b), (A_b0, X_0), (A_b,b-1, X_{b-1}), (A_b,b+1, X_{b+1}).
template <typename TA>
struct ColumnPairs {
  const TA* diag;
  const TA* col;
  const TA* lo;
  const TA* hi;
  const float* feat;
  int64_t z, b, ww, wk;
  __device__ __forceinline__ const TA* a(int p) const {
    const TA* s = p == 0 ? diag : p == 1 ? col : p == 2 ? lo : hi;
    return s + z * ww;
  }
  __device__ __forceinline__ const float* x(int p) const {
    const int64_t xb = p == 0 ? b : p == 1 ? 0 : p == 2 ? b - 1 : b + 1;
    return feat + xb * wk;
  }
};

// K3's pairs of one chunk: (A_0b, X_b) for b = b0, b0 + 1, ...
template <typename TA>
struct HeadPairs {
  const TA* head;
  const float* feat;
  int64_t b0, ww, wk;
  __device__ __forceinline__ const TA* a(int p) const {
    return head + (b0 + p) * ww;
  }
  __device__ __forceinline__ const float* x(int p) const {
    return feat + (b0 + p) * wk;
  }
};

// K2: grid (ceil(k / BN), ceil(w / BM), rows); stored row z is operand
// block row b = first + z.
template <typename TA, bool VEC, class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
column_blocks_kernel(const TA* __restrict__ diag, const TA* __restrict__ col,
                     const TA* __restrict__ lo, const TA* __restrict__ hi,
                     const float* __restrict__ x, float* __restrict__ out,
                     int nb, int w, int k, int first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * C::BN;
  const int row0 = blockIdx.y * C::BM;
  const int64_t z = blockIdx.z;
  const int64_t b = first + z;
  const int64_t wk = static_cast<int64_t>(w) * k;
  const ColumnPairs<TA> pairs{diag, col, lo, hi, x, z, b,
                              static_cast<int64_t>(w) * w, wk};
  // Banded (lo set, uniform over the CTA): X_{b+1} exists below nb.
  const int npairs = lo == nullptr ? 2 : (b + 1 < nb ? 4 : 3);
  float acc[C::TM][C::TN] = {};
  mainloop<TA, VEC, C>(pairs, npairs, w, k, row0, n0, smem, acc);
  store_tile<VEC, C>(out + z * wk, w, k, row0, n0, acc);
}

// K3 pass 1: grid (ceil(k / BN), ceil(w / BM), S); CTA z sums blocks
// [z * chunk, min(nb, (z + 1) * chunk)) into part[z].
template <typename TA, bool VEC, class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
head_blocks_kernel(const TA* __restrict__ head, const float* __restrict__ x,
                   float* __restrict__ part, int nb, int w, int k,
                   int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * C::BN;
  const int row0 = blockIdx.y * C::BM;
  const int64_t b0 = static_cast<int64_t>(blockIdx.z) * chunk;
  const int64_t wk = static_cast<int64_t>(w) * k;
  const HeadPairs<TA> pairs{head, x, b0, static_cast<int64_t>(w) * w, wk};
  const int npairs = static_cast<int>(
      b0 + chunk <= nb ? chunk : nb - b0);   // the last chunk may be short
  float acc[C::TM][C::TN] = {};
  mainloop<TA, VEC, C>(pairs, npairs, w, k, row0, n0, smem, acc);
  store_tile<VEC, C>(part + blockIdx.z * wk, w, k, row0, n0, acc);
}

// K3 pass 2: out[i] = part[0][i] + part[1][i] + ... + part[S-1][i].
constexpr int SUM_THREADS = 256;

__global__ void __launch_bounds__(SUM_THREADS)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int64_t n, int parts) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * SUM_THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * SUM_THREADS +
                   threadIdx.x;
       i < n; i += step) {
    float s = __ldg(part + i);
#pragma unroll 8
    for (int z = 1; z < parts; ++z) s += __ldg(part + z * n + i);
    out[i] = s;
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename TA, bool VEC, class C>
cudaError_t launch_column(const void* diag, const void* col, const void* lo,
                          const void* hi, const float* x, float* out, int nb,
                          int w, int k, int first, int rows, cudaStream_t s) {
  const auto kernel = column_blocks_kernel<TA, VEC, C>;
  const int smem = Ring<TA, C>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((k + C::BN - 1) / C::BN, (w + C::BM - 1) / C::BM, rows);
  kernel<<<grid, C::NT, smem, s>>>(
      static_cast<const TA*>(diag), static_cast<const TA*>(col),
      static_cast<const TA*>(lo), static_cast<const TA*>(hi), x, out, nb, w,
      k, first);
  return cudaGetLastError();
}

template <typename TA, bool VEC, class C>
cudaError_t launch_head(const void* head, const float* x, float* out,
                        float* part, int nb, int w, int k, int chunk,
                        cudaStream_t s) {
  const auto kernel = head_blocks_kernel<TA, VEC, C>;
  const int smem = Ring<TA, C>::BYTES;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int parts = (nb + chunk - 1) / chunk;
  float* dst = parts == 1 ? out : part;
  const dim3 grid((k + C::BN - 1) / C::BN, (w + C::BM - 1) / C::BM, parts);
  kernel<<<grid, C::NT, smem, s>>>(static_cast<const TA*>(head), x, dst, nb,
                                   w, k, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const int64_t n = static_cast<int64_t>(w) * k;
  const int64_t want = (n + SUM_THREADS - 1) / SUM_THREADS;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  sum_parts_kernel<<<blocks, SUM_THREADS, 0, s>>>(part, out, n, parts);
  return cudaGetLastError();
}

// The tile by feature count; ops/cuda_blocks.py:TILES mirrors it.
template <typename TA, bool VEC>
cudaError_t column_for(const void* diag, const void* col, const void* lo,
                       const void* hi, const float* x, float* out, int nb,
                       int w, int k, int first, int rows, cudaStream_t s) {
  if (k <= 16) {
    return launch_column<TA, VEC, Narrow>(diag, col, lo, hi, x, out, nb, w,
                                          k, first, rows, s);
  }
  if (k <= 64) {
    return launch_column<TA, VEC, Mid>(diag, col, lo, hi, x, out, nb, w, k,
                                       first, rows, s);
  }
  return launch_column<TA, VEC, Wide>(diag, col, lo, hi, x, out, nb, w, k,
                                      first, rows, s);
}

template <typename TA, bool VEC>
cudaError_t head_for(const void* head, const float* x, float* out,
                     float* part, int nb, int w, int k, int chunk,
                     cudaStream_t s) {
  if (k <= 16) {
    return launch_head<TA, VEC, Narrow>(head, x, out, part, nb, w, k, chunk,
                                        s);
  }
  if (k <= 64) {
    return launch_head<TA, VEC, Mid>(head, x, out, part, nb, w, k, chunk, s);
  }
  return launch_head<TA, VEC, Wide>(head, x, out, part, nb, w, k, chunk, s);
}

bool bad_shape(int nb, int w, int k, int min_nb) {
  // Grid y is ceil(w / BM) with BM >= 64; grid z at most nb.
  return nb < min_nb || w < 1 || k < 1 || (w + 63) / 64 > 65535 ||
         nb > 65535;
}

}  // namespace

// block_dtype: 0 = float32 blocks, 1 = bfloat16 blocks; x is the float32
// (nb, w, k) operand, the stacks (rows, w, w) and out float32 (rows, w,
// k) hold operand block rows first .. first + rows - 1, all contiguous.
// vec: every operand is 16-byte aligned, w * sizeof(block) % 16 == 0 and
// k % 4 == 0.  lo and hi are null unless banded.  Returns a cudaError_t
// (0 is success), -1 for an unknown block dtype, -2 for a shape the grid
// cannot hold or a row range outside 1 .. nb - 1 (nb < 2 included: there
// is no block row besides X_0's).
extern "C" int arrow_column_spmm(int block_dtype, int vec, const void* diag,
                                 const void* col, const void* lo,
                                 const void* hi, const void* x, void* out,
                                 int nb, int w, int k, int first, int rows,
                                 void* stream) {
  if (block_dtype != 0 && block_dtype != 1) return -1;
  if (bad_shape(nb, w, k, 2) || first < 1 || rows < 1 || rows > nb - first)
    return -2;
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (block_dtype == 0) {
    e = vec ? column_for<float, true>(diag, col, lo, hi, xx, o, nb, w, k,
                                      first, rows, s)
            : column_for<float, false>(diag, col, lo, hi, xx, o, nb, w, k,
                                       first, rows, s);
  } else {
    e = vec ? column_for<__nv_bfloat16, true>(diag, col, lo, hi, xx, o, nb,
                                              w, k, first, rows, s)
            : column_for<__nv_bfloat16, false>(diag, col, lo, hi, xx, o, nb,
                                               w, k, first, rows, s);
  }
  return static_cast<int>(e);
}

// out is the (w, k) head block row, float32 and contiguous (block 0 of
// the level output K2 fills).  chunk: blocks per CTA of pass 1, so S =
// ceil(nb / chunk) partials; part is a float32 (S, w, k) workspace,
// unused (may be null) when S = 1.  Returns as arrow_column_spmm, and
// -3 for a chunk below 1 or a missing workspace.
extern "C" int arrow_head_spmm(int block_dtype, int vec, const void* head,
                               const void* x, void* out, void* part, int nb,
                               int w, int k, int chunk, void* stream) {
  if (block_dtype != 0 && block_dtype != 1) return -1;
  if (bad_shape(nb, w, k, 1)) return -2;
  if (chunk < 1 || (chunk < nb && part == nullptr)) return -3;
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto* p = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (block_dtype == 0) {
    e = vec ? head_for<float, true>(head, xx, o, p, nb, w, k, chunk, s)
            : head_for<float, false>(head, xx, o, p, nb, w, k, chunk, s);
  } else {
    e = vec ? head_for<__nv_bfloat16, true>(head, xx, o, p, nb, w, k, chunk,
                                            s)
            : head_for<__nv_bfloat16, false>(head, xx, o, p, nb, w, k, chunk,
                                             s);
  }
  return static_cast<int>(e);
}

extern "C" const char* arrow_blocks_error_string(int code) {
  if (code == -1) return "unknown block dtype";
  if (code == -2) return "shape out of range for the kernel's grid";
  if (code == -3) return "head split without a workspace";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
