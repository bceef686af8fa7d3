// K4: the row gather, and the fused gather-add, for Hopper (sm_90a).
//
// Replaces the TPU kernel make_pallas_granule(...).run in
// tools/pallas_gather_probe.py (pallas_call at :148), which computes
// x[idx] by copying each slot's whole 512-byte granule line (8 rows of 16
// f32: the TPU's DMA unit) HBM -> VMEM and then selecting the wanted
// sub-row.  On Hopper a 64-byte row is two 32-byte sectors and is read
// alone, so this kernel gathers rows, never lines:
//
//   gather      out[s, :] = x[idx[s], :]
//   gather-add  out[s, :] = out[s, :] + x[idx[s], :]   (in place: one f32
//               addition, the base first, as partials[i-1] + agg[bwd])
//
// x (n, k) f32 row-major, idx (S,) int32 in [0, n) (not checked, as on
// the TPU), out (S, k) f32, any k >= 1; out must not overlap x (the
// wrapper checks).  The gather copies bits: -0.0 and NaN payloads stay.
// The source may come in two parts, x = [x1; x2] with x1's `split` rows
// first, read where they lie: a mesh exchange gathers from its own rows
// and the slots it received without concatenating them.
//
// Bound: memory.  (distinct rows x k x 4 + S x k x 4 + S x 4) bytes over
// the memory rate, plus S x k x 4 for the base read of the gather-add.
//
// Design.  A row belongs to a group of `lanes` threads, the power of two
// that covers its items (16-byte vectors where k % 4 == 0 and x and out
// are 16-byte aligned, else single floats), at most a warp: 4 lanes at
// k = 16, so a warp covers 8 rows a load, and a whole warp at k = 128.
// A group owns kBatch rows, one CTA's worth of groups apart, so that for
// each batch slot the warp's groups read consecutive indices and write
// one contiguous run of rows.  A thread loads its kBatch indices first,
// then issues all kBatch row loads (ld.global.nc) before any store; a row
// wider than its group is walked in passes of one item a lane.  A CTA of
// 256 threads so keeps 256 x 8 x 16 B = 32 KB of loads in flight, where
// Little's law asks about 0.7 us x 3.35 TB/s / 132 SMs = 18 KB an SM.
// Stores are streaming (st.global.cs), so that written rows do not evict
// gathered ones from the 50 MB L2.  Offsets are 64-bit.  TMA has no row
// gather on Hopper, and a bulk copy per 64-byte row costs more to issue
// than it moves, so the design is plain vector loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// T is float4 (the vector body) or float (the scalar body); `width` is
// k in items of T.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                  long long split, const int* __restrict__ idx,
                  T* __restrict__ out, long long slots, int width,
                  int lanes) {
  const int groups = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  // Batch slot b of this group is row first + b * groups.
  const long long first =
      static_cast<long long>(blockIdx.x) * groups * kBatch +
      threadIdx.x / lanes;
  const T* src[kBatch];                // each row's start
  bool live[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long s = first + static_cast<long long>(b) * groups;
    live[b] = s < slots;
    const long long r = live[b] ? __ldg(idx + s) : 0;
    src[b] = r < split ? x + r * width : x2 + (r - split) * width;
  }
  for (int c = lane; c < width; c += lanes) {
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (live[b]) v[b] = __ldg(src[b] + c);
    if (kAdd) {
      T base[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (live[b])
          base[b] = __ldcs(out + (first + static_cast<long long>(b) *
                                  groups) * width + c);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (live[b]) v[b] = add(base[b], v[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (live[b])
        __stcs(out + (first + static_cast<long long>(b) * groups) * width + c,
               v[b]);
  }
}

template <typename T, bool kAdd>
cudaError_t launch(const void* x, const void* x2, long long split,
                   const void* idx, void* out, long long slots, int width,
                   cudaStream_t stream) {
  int lanes = 1;
  while (lanes < width && lanes < 32) lanes *= 2;
  const long long rows_per_cta =
      static_cast<long long>(kThreads / lanes) * kBatch;
  const unsigned grid =
      static_cast<unsigned>((slots + rows_per_cta - 1) / rows_per_cta);
  row_gather_kernel<T, kAdd><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2), split,
      static_cast<const int*>(idx), static_cast<T*>(out), slots, width,
      lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (S, k) f32 = x[idx] (add = 0), or out += x[idx] in place (add = 1);
// x = [x1; x2] (x1's first `split` rows, then x2's), both (., k) f32, idx
// (S,) int32 (one source: x2 = x1 and split its row count).  The caller
// checks shapes, dtypes, contiguity and that out overlaps neither part,
// and launches nothing for S = 0 or k = 0.  The vector body runs where
// k % 4 == 0 and x1, x2 and out are 16-byte aligned, the scalar body
// otherwise.  Returns 0 or the cudaError_t of the launch.
int row_gather(const void* x1, const void* x2, long long split,
               const void* idx, void* out, long long slots, int k, int add,
               void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = k % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x1) |
                    reinterpret_cast<uintptr_t>(x2) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaError_t e;
  if (vec)
    e = add ? launch<float4, true>(x1, x2, split, idx, out, slots, k / 4,
                                   stream)
            : launch<float4, false>(x1, x2, split, idx, out, slots, k / 4,
                                    stream);
  else
    e = add ? launch<float, true>(x1, x2, split, idx, out, slots, k, stream)
            : launch<float, false>(x1, x2, split, idx, out, slots, k,
                                   stream);
  return static_cast<int>(e);
}

const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
