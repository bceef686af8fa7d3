// K4: the granule gather, by waves of async copies, for Hopper (sm_90a).
//
// Replaces the TPU kernel make_pallas_granule(...).run in
// tools/pallas_gather_probe.py (pallas_call at :148), which copies each
// slot's 512-byte granule line HBM -> VMEM with its own async copy,
// `wave` copies in flight, and then selects the wanted sub-row.
//
// What it computes: out.reshape(S, 16)[s] = x[idx[s]], with x packed as
// (n / 8, 128) f32 (8 rows of 16 features make one 512-byte line) and
// idx (S,) int32 in [0, n) -- not checked here, as on the TPU.
//
// Design.  A CTA of 8 warps owns `block` consecutive slots, as a grid
// step of the TPU kernel does, but the TPU kernel stages all `block`
// lines in VMEM (512 KB at block 1024) and a CTA has at most 227 KB of
// shared memory, so the CTA stages one wave of `wave` lines at a time
// (16 KB at wave 32).  Each warp copies whole lines with cp.async.cg
// (32 lanes x 16 bytes = one line), the CTA waits for the whole wave
// (commit, wait_group 0, __syncthreads), then 4 threads a slot store the
// 64-byte sub-row (idx % 8) as float4s, and the next wave is issued:
// all of a wave lands before the next starts, as on the TPU.  The
// sub-row is copied bit for bit (a -0.0 stays -0.0; the plain version's
// mask-and-sum gives +0.0).  Offsets into x and out are 64-bit.
//
// Bound: a gather of S rows of 64 B, (distinct rows x 64 + S x 64 +
// S x 4) bytes over the memory rate.  The design moves whole lines,
// S x 512 B, an 8x read amplification; rings of waves in flight and
// cp.async.bulk (TMA) copies are later designs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerLine = 8;        // C
constexpr int kLineF4 = 32;            // 128 floats = 32 float4 per line
constexpr int kRowF4 = 4;              // 16 floats = 4 float4 per row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
granule_gather_kernel(const float4* __restrict__ x,
                      const int* __restrict__ idx,
                      float4* __restrict__ out, int block, int wave) {
  extern __shared__ float4 lines[];    // wave lines of 32 float4
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * block;
  for (int base = 0; base < block; base += wave) {
    const int64_t s0 = first + base;
    for (int j = warp; j < wave; j += kWarps) {
      const int64_t g = __ldg(idx + s0 + j) / kRowsPerLine;
      cp_async_16(lines + j * kLineF4 + lane, x + g * kLineF4 + lane);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int t = threadIdx.x; t < wave * kRowF4; t += kThreads) {
      const int j = t / kRowF4;
      const int q = t % kRowF4;
      const int sub = __ldg(idx + s0 + j) % kRowsPerLine;
      out[(s0 + j) * kRowF4 + q] = lines[j * kLineF4 + sub * kRowF4 + q];
    }
    __syncthreads();                   // the wave's lines are free again
  }
}

}  // namespace

extern "C" {

// out (S / 8, 128) f32 = the gathered rows; x_packed (n_lines, 128) f32,
// idx (S,) int32.  The caller checks S % block == 0, block % wave == 0,
// block % 8 == 0, 16-byte alignment and wave * 512 <= 227 KB.  Returns 0
// or the cudaError_t of the launch.
int granule_gather(const void* x_packed, const void* idx, void* out,
                   long long slots, int block, int wave, void* stream) {
  const size_t smem = static_cast<size_t>(wave) * kLineF4 * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        granule_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>(slots / block);
  granule_gather_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x_packed), static_cast<const int*>(idx),
      static_cast<float4*>(out), block, wave);
  return static_cast<int>(cudaGetLastError());
}

const char* granule_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
