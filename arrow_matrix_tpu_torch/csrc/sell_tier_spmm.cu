// K1: the folded SELL operator's SpMM for NVIDIA Hopper (sm_90a), every
// tier of the operator in one launch,
//
//     out[row0_t + r, :] = sum_{j < m_t} w_t[j, r] * x[cols_t[j, r], :]
//
// with w[j, r] = data[j, r] (weighted) or (j < deg[r]) (binary graph
// adjacency, no value array).  Sums are taken in float32 whatever the
// carriage of x (float32, bfloat16, or a pre-quantized int8 table whose
// scale the caller applies); a bfloat16 output is rounded once.
//
// Replaces the TPU kernel ops/pallas_sell.py:_make_slab_call (bodies
// kernel_stream / kernel_vectorized) of the JAX package, which the JAX
// package launches once per tier.  What that kernel does for the TPU's
// sake -- granule lines of 8 packed rows, column indices in SMEM by
// scalar prefetch, a ring of DMA waves -- is not carried over: Hopper
// gathers a row with ordinary 16-byte loads from the row-major carriage.
//
// Bound.  Bytes: a gathered row gets one multiply-add per element, far
// below the card's operations per byte.  What held the per-tier design
// back was latency, not bandwidth: one launch per tier, each ending in a
// tail; hub rows of thousands of slots walked by the groups of one CTA;
// four dependent index -> row loads in flight per group.
//
// Design.  One launch walks a work list built on the host
// (ops/worklist.py, which documents it): a table of tiers and one item
// per CTA, the hub tiers' items first so the longest chains start
// first.  A CTA of kThreads threads is cut into thread groups of
// `group` lanes; a lane holds VEC features of a row (16 bytes when the
// rows allow 16-byte loads), so a gathered row is one run of 16-byte
// loads.  Each group walks one chunk of at most 128 slots of one row
// (ops/worklist.py:CHUNK_SLOTS; the chunk_slots knob), BATCH slots at a
// time: first the BATCH column indices (and weights), then the BATCH row
// gathers, all in flight before the first add, which takes them in slot
// order.  BATCH is 8 by default, and 4 for int8, whose lanes widen 16
// values into 16 accumulators and so hold more registers a row.
// A row's chunk sums are added in one order fixed by the row's chunk
// count alone, whatever k: in blocks of kBlock (8) consecutive chunks,
// each block summed in chunk order, and the block sums added in block
// order.  The chunks of a row that one CTA holds are added so through
// shared memory; a row with more chunks than a CTA holds is split over
// several CTAs, each writing one float32 partial per block to a
// workspace, and a second launch adds a row's block partials in order.
// (kBlock is the fewest groups a CTA has, at 32 lanes a group, so a
// split item always holds whole blocks.)  A column of a product at any
// k therefore has the same bits as the same column at another k: the
// serving runtime's batches and column slabs rely on it.  No atomics:
// two runs give the same bits.  Binary rows stop at deg[r].  All
// offsets into x and out are 64-bit.
//
// Launch knobs (ops/kernel_contract.py declares them, ops/worklist.py
// checks them): BATCH in {4, 8} and the launch bound's least CTAs per
// SM, MINB in {1, 2}, are template parameters, one instance each; the
// chunk length is the work list's.  BATCH and MINB leave every sum's
// order as it is
// (the adds follow the slots, whatever the batch; registers hold the
// same values), so they keep the bits; the chunk length changes S and
// so the order of a row's chunk sums.
//
// Interface: plain C, built with nvcc -shared and loaded with ctypes
// (ops/_build.py, ops/cuda_sell.py).  The launches go on the caller's
// stream; nothing is allocated or synchronised here.  The return value
// is cudaGetLastError() after the launches, or a negative code for
// arguments the kernel does not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 128;
// Chunks of one block of a row's sum order: kThreads / 32, the fewest
// groups of a CTA (ops/worklist.py:CHUNK_BLOCK).
constexpr int kBlock = 8;

// One row of the tier table (ops/worklist.py:TIER_FIELDS), eight int64.
struct Tier {
  const int32_t* cols;   // (m_t, n_t) slot-major
  const void* w;         // data (m_t, n_t) float32, or deg (n_t,) int32
  int64_t row0;          // first output row
  int64_t m_t, n_t;
  int64_t chunk;         // L: slots of one chunk
  int64_t split;         // S: chunks of one row
  int64_t unused;
};
static_assert(sizeof(Tier) == 64, "eight int64 fields");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A lane's VEC elements of one gathered row, as loaded: one 16-byte
// vector (VECLOAD) or one element.
template <typename TX, bool VECLOAD>
struct Raw {
  using type = TX;
};
template <typename TX>
struct Raw<TX, true> {
  using type = uint4;
};

template <typename TX, bool VECLOAD>
__device__ __forceinline__ typename Raw<TX, VECLOAD>::type load_raw(
    const TX* __restrict__ p) {
  if constexpr (VECLOAD) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return *p;
  }
}

template <typename TX, int VEC, bool VECLOAD, bool BINARY>
__device__ __forceinline__ void accumulate(
    float (&acc)[VEC], const typename Raw<TX, VECLOAD>::type& raw,
    float w) {
  if constexpr (VECLOAD) {
    static_assert(VEC * sizeof(TX) == 16, "one 16-byte load");
    const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] = BINARY ? acc[i] + to_f32(e[i]) : fmaf(w, to_f32(e[i]), acc[i]);
    }
  } else {
    acc[0] = BINARY ? acc[0] + to_f32(raw) : fmaf(w, to_f32(raw), acc[0]);
  }
}

// Grid (items, col_blocks).  Item (tier, row0, chunk0, part): part < 0,
// the CTA holds rows row0 .. row0 + P / S - 1 whole and writes them;
// else it holds chunks chunk0 .. chunk0 + P - 1 of row row0 and writes
// the sum of each of their blocks of kBlock chunks to part[part],
// part[part + 1], ...
template <typename TX, typename TO, bool BINARY, int VEC, bool VECLOAD,
          int BATCH, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
sell_kernel(const Tier* __restrict__ tiers, const int4* __restrict__ items,
            const TX* __restrict__ x, TO* __restrict__ out,
            float* __restrict__ part, int k, int group) {
  using RawT = typename Raw<TX, VECLOAD>::type;
  __shared__ float red[VEC * kThreads];

  const int4 item = items[blockIdx.x];
  const Tier& tier = tiers[item.x];
  const int64_t n_t = tier.n_t;
  const int m_t = static_cast<int>(tier.m_t);
  const int length = static_cast<int>(tier.chunk);
  const int split = static_cast<int>(tier.split);
  const bool direct = item.w < 0;

  const int p = kThreads / group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x % group;
  // Chunks of a row in this CTA, the group's row and chunk.
  const int cps = direct ? split : min(p, split - item.z);
  const int rows_here = direct ? p / split : 1;
  const int local = direct ? g / split : 0;
  const int c_local = direct ? g - local * split : g;
  const int64_t row = static_cast<int64_t>(item.y) + local;
  const int64_t col0 =
      (static_cast<int64_t>(blockIdx.y) * group + lane) * VEC;
  const bool row_ok = local < rows_here && row < n_t;
  const bool work = row_ok && c_local < cps && col0 < k;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

  if (work && m_t > 0) {
    const int chunk = (direct ? 0 : item.z) + c_local;
    int end = m_t;
    if constexpr (BINARY) {
      end = min(end, __ldg(static_cast<const int32_t*>(tier.w) + row));
    }
    const int lo = chunk * length;
    const int hi = min(lo + length, end);
    const int32_t* cptr = tier.cols + row;
    const float* wptr = static_cast<const float*>(tier.w) + row;
    const TX* xcol = x + col0;
    for (int j = lo; j < hi; j += BATCH) {
      int64_t off[BATCH];
      float w[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const bool live = j + b < hi;
        const int64_t s = static_cast<int64_t>(j + b) * n_t;
        off[b] = live ? static_cast<int64_t>(__ldg(cptr + s)) * k : -1;
        w[b] = (BINARY || !live) ? 1.0f : __ldg(wptr + s);
      }
      RawT raw[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        raw[b] = off[b] >= 0 ? load_raw<TX, VECLOAD>(xcol + off[b]) : RawT{};
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        // A slot past the chunk loaded zeros: adding them changes nothing.
        accumulate<TX, VEC, VECLOAD, BINARY>(acc, raw[b], w[b]);
      }
    }
  }

  // The group leading a block of kBlock chunks sums the block in chunk
  // order; for a direct row the first group then adds the block sums in
  // block order.  cps and direct are uniform across the CTA, so every
  // barrier is reached by all of its threads.
  const bool leader = c_local % kBlock == 0;
  if (cps > 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[i * kThreads + threadIdx.x] = acc[i];
    __syncthreads();
    if (row_ok && leader && c_local < cps) {
      const int last = min(kBlock, cps - c_local);
      for (int t = 1; t < last; ++t) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[i] += red[i * kThreads + threadIdx.x + t * group];
        }
      }
    }
    if (direct && cps > kBlock) {
      __syncthreads();  // every block read its chunks
      if (row_ok && leader && c_local < cps) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) red[i * kThreads + threadIdx.x] = acc[i];
      }
      __syncthreads();
      if (row_ok && c_local == 0) {
        for (int b = kBlock; b < cps; b += kBlock) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[i] += red[i * kThreads + threadIdx.x + b * group];
          }
        }
      }
    }
  }
  if (!work || !leader || (direct && c_local != 0)) return;

  const int lim = (k - col0) < VEC ? static_cast<int>(k - col0) : VEC;
  if (direct) {
    TO* o = out + (tier.row0 + row) * static_cast<int64_t>(k) + col0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (i < lim) store(o + i, acc[i]);
    }
  } else {
    float* o = part + (static_cast<int64_t>(item.w) + c_local / kBlock) * k +
               col0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (i < lim) o[i] = acc[i];
    }
  }
}

// Pass 2, one CTA per split row (out row, first partial, partials):
// out[row] = part[first] + part[first + 1] + ... in order, the row's
// block sums in block order.
template <typename TO>
__global__ void __launch_bounds__(kSumThreads)
sum_rows_kernel(const int32_t* __restrict__ rows,
                const float* __restrict__ part, TO* __restrict__ out,
                int k) {
  const int64_t orow = rows[3 * blockIdx.x];
  const int64_t first = rows[3 * blockIdx.x + 1];
  const int parts = rows[3 * blockIdx.x + 2];
  for (int c = threadIdx.x; c < k; c += kSumThreads) {
    float acc = __ldg(part + first * k + c);
    for (int q = 1; q < parts; ++q) acc += __ldg(part + (first + q) * k + c);
    store(out + orow * k + c, acc);
  }
}

template <typename TX, typename TO, bool BINARY, bool VECLOAD, int BATCH,
          int MINB>
cudaError_t launch(const void* tiers, const void* items, const void* rows,
                   const void* x, void* out, void* part, int n_items,
                   int n_rows, int k, int group, cudaStream_t s) {
  constexpr int VEC = VECLOAD ? static_cast<int>(16 / sizeof(TX)) : 1;
  const int per_row = (k + VEC - 1) / VEC;
  const int col_blocks = (per_row + group - 1) / group;
  if (col_blocks > 65535) return cudaErrorInvalidValue;
  auto* o = static_cast<TO*>(out);
  auto* p = static_cast<float*>(part);
  if (n_items > 0) {
    sell_kernel<TX, TO, BINARY, VEC, VECLOAD, BATCH, MINB>
        <<<dim3(static_cast<unsigned>(n_items),
                static_cast<unsigned>(col_blocks)),
           kThreads, 0, s>>>(static_cast<const Tier*>(tiers),
                             static_cast<const int4*>(items),
                             static_cast<const TX*>(x), o, p, k, group);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_rows > 0) {
    sum_rows_kernel<TO><<<static_cast<unsigned>(n_rows), kSumThreads, 0,
                          s>>>(static_cast<const int32_t*>(rows), p, o, k);
  }
  return cudaGetLastError();
}

// Arguments of one product, passed down the dispatch unchanged.
struct Args {
  const void* tiers;
  const void* items;
  const void* rows;
  const void* x;
  void* out;
  void* part;
  int n_items, n_rows, k, group;
  cudaStream_t s;
};

template <typename TX, typename TO, bool BINARY, bool VECLOAD, int BATCH>
cudaError_t by_minb(const Args& a, int minb) {
  if (minb == 1) {
    return launch<TX, TO, BINARY, VECLOAD, BATCH, 1>(
        a.tiers, a.items, a.rows, a.x, a.out, a.part, a.n_items, a.n_rows,
        a.k, a.group, a.s);
  }
  return launch<TX, TO, BINARY, VECLOAD, BATCH, 2>(
      a.tiers, a.items, a.rows, a.x, a.out, a.part, a.n_items, a.n_rows,
      a.k, a.group, a.s);
}

// The batches of every carriage: 4 and 8.
template <typename TX, typename TO, bool BINARY, bool VECLOAD>
cudaError_t by_batch(const Args& a, int batch, int minb) {
  switch (batch) {
    case 4:
      return by_minb<TX, TO, BINARY, VECLOAD, 4>(a, minb);
    case 8:
      return by_minb<TX, TO, BINARY, VECLOAD, 8>(a, minb);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TO>
cudaError_t dispatch(int binary, int vecload, const Args& a, int batch,
                     int minb) {
  if (binary) {
    return vecload ? by_batch<TX, TO, true, true>(a, batch, minb)
                   : by_batch<TX, TO, true, false>(a, batch, minb);
  }
  return vecload ? by_batch<TX, TO, false, true>(a, batch, minb)
                 : by_batch<TX, TO, false, false>(a, batch, minb);
}

}  // namespace

// carriage: 0 = float32 -> float32, 1 = bfloat16 -> bfloat16,
//           2 = int8 -> float32.
// vecload: x is 16-byte aligned and k * itemsize % 16 == 0.
// tiers: (T, 8) int64 tier table; items: (n_items, 4) int32; rows:
// (n_rows, 3) int32 split rows; part: float32 workspace of the split
// items' block sums (null when n_rows is 0).  group: lanes of a thread
// group, a power of two up to 32 (ops/worklist.py:lanes).  batch: slot
// loads in flight a lane (4, 8); ctas_per_sm: the launch
// bound's least CTAs per SM (1, 2).
// Returns a cudaError_t (0 is success), -1 for an unknown carriage, -2
// for a group the kernel does not take, -3 for split rows without a
// workspace, -4 for a batch the carriage does not take, -5 for a
// ctas_per_sm the kernel does not take.
extern "C" int sell_spmm(int carriage, int binary, int vecload,
                         const void* tiers, const void* items,
                         const void* rows, const void* x, void* out,
                         void* part, int n_items, int n_rows, int k,
                         int group, int batch, int ctas_per_sm,
                         void* stream) {
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) return -2;
  if (n_rows > 0 && part == nullptr) return -3;
  if (batch != 4 && batch != 8) return -4;
  if (ctas_per_sm != 1 && ctas_per_sm != 2) return -5;
  const Args a{tiers, items, rows, x, out, part, n_items, n_rows, k, group,
               static_cast<cudaStream_t>(stream)};
  switch (carriage) {
    case 0:
      return static_cast<int>(
          dispatch<float, float>(binary, vecload, a, batch, ctas_per_sm));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16, __nv_bfloat16>(
          binary, vecload, a, batch, ctas_per_sm));
    case 2:
      return static_cast<int>(
          dispatch<int8_t, float>(binary, vecload, a, batch, ctas_per_sm));
    default:
      return -1;
  }
}

extern "C" const char* sell_error_string(int code) {
  if (code == -1) return "unknown carriage";
  if (code == -2) return "group the kernel does not take";
  if (code == -3) return "split rows without a workspace";
  if (code == -4) return "batch the carriage does not take";
  if (code == -5) return "ctas_per_sm the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
