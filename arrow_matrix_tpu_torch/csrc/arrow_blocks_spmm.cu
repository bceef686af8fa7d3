// Dense arrow-block SpMM for NVIDIA Hopper (sm_90a): the two products of
// one arrow level whose blocks are stored as dense (nb, w, w) stacks,
// against features blocked like the rows, X (nb, w, k) float32:
//
//   K2 column_blocks_spmm:  out[b] = A_bb X_b + A_b0 X_0
//                                    [+ A_b,b-1 X_{b-1} + A_b,b+1 X_{b+1}]
//                           for b = 1 .. nb-1 (block row 0 is K3's);
//   K3 head_blocks_spmm:    out[0] = sum_b A_0b X_b.
//
// Blocks are float32 or bfloat16 (a template parameter, converted to
// float32 as they are staged); sums are float32; the output is float32
// and written once.  The JAX package's TPU kernels these replace are
// ops/pallas_blocks.py:column_spmm_pallas (bodies _column_kernel and
// _column_kernel_banded) for K2 and ops/pallas_blocks.py:head_spmm_pallas
// (body _head_kernel) for K3.  Their VMEM row-tile budget does not carry
// over; neither do the shifted copies x_lo / x_hi that
// arrow_spmm_pallas concatenates: K2 indexes X_{b-1} and X_{b+1}
// directly, skipping X_{nb} (which would be zero) with a bound check.
//
// Design: a tiled SIMT GEMM, no tensor cores (TF32 would leave the
// float32 validation gate).  A CTA owns a BM = 64-row tile of one block
// row and BN (16, 32 or 64) feature columns; its (BM/4) * (BN/4)
// threads each hold a 4 x 4 float32 micro-tile, rows ty + 16 i and
// columns 4 tx .. 4 tx + 3.  The contraction runs in BK = 32-deep
// tiles of A (16-byte loads, four f32 or eight bf16 a thread, when the
// width allows) and of X staged in shared memory, over the 2 or 4
// (A, X) pairs of K2 or the nb pairs of K3 in turn, into the same
// registers.  The A tile's row stride is BK + 4 floats, so neither its
// 16-byte stores nor the compute loop's 16-byte reads conflict on a
// bank.  Each output element's sum runs in one fixed order, so runs
// are deterministic (no atomics).  Widths and feature counts that are
// not multiples of a tile are masked; every offset into A, X and out is
// 64-bit (nb * w * w passes 2^31 at n = 2^20, w = 2048).
//
// Bound.  Every block is read once (K2: 2 or 4 stacks; K3: 1) and does
// 2k operations per 4 (f32) or 2 (bf16) bytes.  At k = 16 that is 8
// operations a byte for f32 blocks, under the card's 20 (67 TFLOP/s of
// f32 FMA over 3.35 TB/s): bytes bound both kernels.  At k = 128 it is
// 64 a byte: float32 FMA throughput bounds them.  K3's grid is only
// ceil(w / 64) * ceil(k / BN) CTAs (32 at w = 2048, k = 16, on 132
// SMs), each walking all nb blocks, so K3 is slow for its bytes.
// Later work: wgmma with bf16 blocks (or split-TF32 for f32 blocks),
// TMA staging of the block tiles in a multi-stage ring, and a
// deterministic split of K3 over b (partials reduced in a fixed order).
//
// Interface: plain C, built with nvcc -shared and loaded with ctypes
// (ops/_build.py, ops/cuda_blocks.py).  Launches go on the caller's
// stream; nothing is allocated or synchronised here.  The return value
// is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows of a CTA
constexpr int BK = 32;        // contraction depth of one staged tile
constexpr int AS = BK + 4;    // row stride of the staged A tile, floats

template <int BN>
__host__ __device__ constexpr int threads_for() {
  return (BM / 4) * (BN / 4);
}

template <int BN>
struct Tiles {
  float a[BM][AS];            // A rows [row0, row0 + BM), depth [k0, k0 + BK)
  float x[BK][BN];            // X rows [k0, k0 + BK), columns [n0, n0 + BN)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Stage the BM x BK tile of the (w, w) block `a` at (row0, k0) into s,
// as float32, zero outside the block.  VEC: 16-byte loads (w is a
// multiple of 16 / sizeof(TA) and `a` is 16-byte aligned).
template <typename TA, bool VEC, int NT>
__device__ __forceinline__ void stage_a(const TA* __restrict__ a, int w,
                                        int row0, int k0, float (*s)[AS],
                                        int tid) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(TA);        // 4 f32 or 8 bf16
    constexpr int PER_ROW = BK / E;
    constexpr int CHUNKS = BM * PER_ROW;
    static_assert(CHUNKS % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < CHUNKS / NT; ++it) {
      const int c = it * NT + tid;
      const int m = c / PER_ROW;
      const int kk = (c % PER_ROW) * E;
      const int r = row0 + m;
      const int col = k0 + kk;
      float v[E];
      if (r < w && col < w) {   // w % E == 0: the chunk is all inside
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            a + static_cast<int64_t>(r) * w + col));
        const TA* e = reinterpret_cast<const TA*>(&raw);
#pragma unroll
        for (int i = 0; i < E; ++i) v[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) v[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        *reinterpret_cast<float4*>(&s[m][kk + i]) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    }
  } else {
    static_assert((BM * BK) % NT == 0, "whole elements per thread");
#pragma unroll 4
    for (int it = 0; it < BM * BK / NT; ++it) {
      const int c = it * NT + tid;
      const int m = c / BK;
      const int kk = c % BK;
      const int r = row0 + m;
      const int col = k0 + kk;
      s[m][kk] = (r < w && col < w)
                     ? to_f32(a[static_cast<int64_t>(r) * w + col])
                     : 0.0f;
    }
  }
}

// Stage the BK x BN tile of the (w, k) feature block `x` at (k0, n0).
template <int BN, int NT>
__device__ __forceinline__ void stage_x(const float* __restrict__ x, int w,
                                        int k, int k0, int n0,
                                        float (*s)[BN], int tid) {
  static_assert((BK * BN) % NT == 0, "whole elements per thread");
#pragma unroll
  for (int it = 0; it < BK * BN / NT; ++it) {
    const int c = it * NT + tid;
    const int kk = c / BN;
    const int n = c % BN;
    const int r = k0 + kk;
    const int col = n0 + n;
    s[kk][n] = (r < w && col < k)
                   ? __ldg(x + static_cast<int64_t>(r) * k + col)
                   : 0.0f;
  }
}

// acc += A[row0 tile, :] @ X[:, n0 tile] for one (w, w) block A and one
// (w, k) feature block X, over the whole contraction.
template <typename TA, bool VEC, int BN>
__device__ __forceinline__ void accumulate(const TA* __restrict__ a,
                                           const float* __restrict__ x,
                                           int w, int k, int row0, int n0,
                                           Tiles<BN>& t, float (&acc)[4][4]) {
  constexpr int NT = threads_for<BN>();
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  for (int k0 = 0; k0 < w; k0 += BK) {
    stage_a<TA, VEC, NT>(a, w, row0, k0, t.a, tid);
    stage_x<BN, NT>(x, w, k, k0, n0, t.x, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(&t.a[ty + 16 * i][kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&t.x[kk + j][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = lane(av[i], j);
          acc[i][0] = fmaf(s, xv.x, acc[i][0]);
          acc[i][1] = fmaf(s, xv.y, acc[i][1]);
          acc[i][2] = fmaf(s, xv.z, acc[i][2]);
          acc[i][3] = fmaf(s, xv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
}

template <int BN>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int w,
                                           int k, int row0, int n0,
                                           const float (&acc)[4][4]) {
  const int tx = threadIdx.x % (BN / 4);
  const int ty = threadIdx.x / (BN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= w) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < k) out[static_cast<int64_t>(r) * k + c] = acc[i][j];
    }
  }
}

// K2: grid (ceil(k / BN), ceil(w / BM), nb - 1); block row b = z + 1.
template <typename TA, bool VEC, int BN>
__global__ void __launch_bounds__(threads_for<BN>())
column_blocks_kernel(const TA* __restrict__ diag, const TA* __restrict__ col,
                     const TA* __restrict__ lo, const TA* __restrict__ hi,
                     const float* __restrict__ x, float* __restrict__ out,
                     int nb, int w, int k) {
  __shared__ __align__(16) Tiles<BN> t;
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int64_t b = static_cast<int64_t>(blockIdx.z) + 1;
  const int64_t ww = static_cast<int64_t>(w) * w;
  const int64_t wk = static_cast<int64_t>(w) * k;
  float acc[4][4] = {};
  accumulate<TA, VEC, BN>(diag + b * ww, x + b * wk, w, k, row0, n0, t, acc);
  accumulate<TA, VEC, BN>(col + b * ww, x, w, k, row0, n0, t, acc);
  if (lo != nullptr) {      // banded; uniform over the CTA
    accumulate<TA, VEC, BN>(lo + b * ww, x + (b - 1) * wk, w, k, row0, n0,
                            t, acc);
    if (b + 1 < nb) {
      accumulate<TA, VEC, BN>(hi + b * ww, x + (b + 1) * wk, w, k, row0,
                              n0, t, acc);
    }
  }
  store_tile<BN>(out + b * wk, w, k, row0, n0, acc);
}

// K3: grid (ceil(k / BN), ceil(w / BM)); the CTA walks every block b.
template <typename TA, bool VEC, int BN>
__global__ void __launch_bounds__(threads_for<BN>())
head_blocks_kernel(const TA* __restrict__ head, const float* __restrict__ x,
                   float* __restrict__ out, int nb, int w, int k) {
  __shared__ __align__(16) Tiles<BN> t;
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int64_t ww = static_cast<int64_t>(w) * w;
  const int64_t wk = static_cast<int64_t>(w) * k;
  float acc[4][4] = {};
  for (int64_t b = 0; b < nb; ++b) {
    accumulate<TA, VEC, BN>(head + b * ww, x + b * wk, w, k, row0, n0, t,
                            acc);
  }
  store_tile<BN>(out, w, k, row0, n0, acc);
}

template <typename TA, bool VEC, int BN>
cudaError_t launch_column(const void* diag, const void* col, const void* lo,
                          const void* hi, const float* x, float* out, int nb,
                          int w, int k, cudaStream_t s) {
  const dim3 grid((k + BN - 1) / BN, (w + BM - 1) / BM, nb - 1);
  column_blocks_kernel<TA, VEC, BN><<<grid, threads_for<BN>(), 0, s>>>(
      static_cast<const TA*>(diag), static_cast<const TA*>(col),
      static_cast<const TA*>(lo), static_cast<const TA*>(hi), x, out, nb, w,
      k);
  return cudaGetLastError();
}

template <typename TA, bool VEC, int BN>
cudaError_t launch_head(const void* head, const float* x, float* out, int nb,
                        int w, int k, cudaStream_t s) {
  const dim3 grid((k + BN - 1) / BN, (w + BM - 1) / BM);
  head_blocks_kernel<TA, VEC, BN><<<grid, threads_for<BN>(), 0, s>>>(
      static_cast<const TA*>(head), x, out, nb, w, k);
  return cudaGetLastError();
}

// Feature columns of a CTA: the smallest of 16, 32, 64 that covers k,
// else 64 with more CTAs along x.
template <typename TA, bool VEC>
cudaError_t column_for(const void* diag, const void* col, const void* lo,
                       const void* hi, const float* x, float* out, int nb,
                       int w, int k, cudaStream_t s) {
  if (k <= 16) {
    return launch_column<TA, VEC, 16>(diag, col, lo, hi, x, out, nb, w, k, s);
  }
  if (k <= 32) {
    return launch_column<TA, VEC, 32>(diag, col, lo, hi, x, out, nb, w, k, s);
  }
  return launch_column<TA, VEC, 64>(diag, col, lo, hi, x, out, nb, w, k, s);
}

template <typename TA, bool VEC>
cudaError_t head_for(const void* head, const float* x, float* out, int nb,
                     int w, int k, cudaStream_t s) {
  if (k <= 16) return launch_head<TA, VEC, 16>(head, x, out, nb, w, k, s);
  if (k <= 32) return launch_head<TA, VEC, 32>(head, x, out, nb, w, k, s);
  return launch_head<TA, VEC, 64>(head, x, out, nb, w, k, s);
}

bool bad_shape(int nb, int w, int k, int min_nb) {
  return nb < min_nb || w < 1 || k < 1 || (w + BM - 1) / BM > 65535 ||
         nb - 1 > 65535;
}

}  // namespace

// block_dtype: 0 = float32 blocks, 1 = bfloat16 blocks; x and out are
// float32 (nb, w, k), contiguous.  vec: every block stack is 16-byte
// aligned and w * sizeof(block) % 16 == 0.  lo and hi are null unless
// banded.  Returns a cudaError_t (0 is success), -1 for an unknown
// block dtype, -2 for a shape the grid cannot hold (nb < 2 included:
// K2 then has no block row to compute).
extern "C" int arrow_column_spmm(int block_dtype, int vec, const void* diag,
                                 const void* col, const void* lo,
                                 const void* hi, const void* x, void* out,
                                 int nb, int w, int k, void* stream) {
  if (block_dtype != 0 && block_dtype != 1) return -1;
  if (bad_shape(nb, w, k, 2)) return -2;
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (block_dtype == 0) {
    e = vec ? column_for<float, true>(diag, col, lo, hi, xx, o, nb, w, k, s)
            : column_for<float, false>(diag, col, lo, hi, xx, o, nb, w, k, s);
  } else {
    e = vec ? column_for<__nv_bfloat16, true>(diag, col, lo, hi, xx, o, nb,
                                              w, k, s)
            : column_for<__nv_bfloat16, false>(diag, col, lo, hi, xx, o, nb,
                                               w, k, s);
  }
  return static_cast<int>(e);
}

// out is the (w, k) head block row, float32 and contiguous (block 0 of
// the level output K2 fills).
extern "C" int arrow_head_spmm(int block_dtype, int vec, const void* head,
                               const void* x, void* out, int nb, int w,
                               int k, void* stream) {
  if (block_dtype != 0 && block_dtype != 1) return -1;
  if (bad_shape(nb, w, k, 1)) return -2;
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (block_dtype == 0) {
    e = vec ? head_for<float, true>(head, xx, o, nb, w, k, s)
            : head_for<float, false>(head, xx, o, nb, w, k, s);
  } else {
    e = vec ? head_for<__nv_bfloat16, true>(head, xx, o, nb, w, k, s)
            : head_for<__nv_bfloat16, false>(head, xx, o, nb, w, k, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* arrow_blocks_error_string(int code) {
  if (code == -1) return "unknown block dtype";
  if (code == -2) return "shape out of range for the kernel's grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
