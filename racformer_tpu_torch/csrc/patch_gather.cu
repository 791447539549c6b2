// Patch gather (kernel K2) for NVIDIA Hopper, sm_90a: the forward of the
// training samplers' bilinear sample.
//
// Replaces the Pallas TPU kernel `_kernel` (racformer_tpu/ops/gather_kernel.py,
// launched by `_gather_pallas` through `patch_sample_pallas`), together with
// the y-mix that follows it in XLA. For point p of slab s it computes
//
//   out[s, p, c] = (1 - wy) * xl[c] + wy * xl[c + C]
//   xl           = (1 - wx) * F[s, row, x0p, :] + wx * F[s, row, x0p + 1, :]
//
// over a zero-bordered, y-fused map F [S, R, Wp, 2C] (channels [0, C) hold
// row y0, [C, 2C) row y0 + 1, see ops/bilinear.py): the bilinear sample at
// the clamped corner (row, x0p). Unlike K1 (csrc/gather_fold.cu) nothing is
// summed over points: the training path weights and sums the per-point
// samples in PyTorch, where autograd sees them.
//
// What bounds it: memory. Each point reads two 2C-channel columns (2 x 256 B
// in bf16 at C = 64) and writes C values, for 4 * C multiply-adds. The
// design only makes the reads coalesced: one warp per point, lane l owns
// output channels (2l, 2l + 1) of each 64-channel block and reads them as
// bf16x2 (float2 for f32 maps), so each warp load is one contiguous 128-byte
// segment of a column; the lerps run in f32 registers and the output is
// stored once in the map dtype. The TPU kernel's 8-aligned 16-wide windows,
// packed (row << 16) | xb words and hat-weight reductions are not needed.
//
// Contract: every array is contiguous, C is even (the Python wrapper checks
// these and raises); 0 <= row < R and 0 <= x0p <= Wp - 2 (the samplers
// guarantee it by clamping the coordinates to [-PAD, W] before adding PAD;
// nothing checks it here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) patch_gather_kernel(
    const T* __restrict__ fused, const int32_t* __restrict__ row,
    const int32_t* __restrict__ x0p, const float* __restrict__ wx,
    const float* __restrict__ wy, T* __restrict__ out, int64_t map_stride,
    int wp, int c, int k) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= k) return;
  const int s = blockIdx.y;
  const int c2 = 2 * c;
  const int64_t q = static_cast<int64_t>(s) * k + p;
  const T* col0 = fused + s * map_stride +
                  (static_cast<int64_t>(row[q]) * wp + x0p[q]) * c2;
  const T* col1 = col0 + c2;
  const float fx = wx[q];
  const float gx = 1.f - fx;
  const float fy = wy[q];
  const float gy = 1.f - fy;
  T* dst = out + q * c;
  for (int cb = 2 * lane; cb < c; cb += 64) {
    const float2 t0 = load2(col0 + cb);
    const float2 b0 = load2(col0 + c + cb);
    const float2 t1 = load2(col1 + cb);
    const float2 b1 = load2(col1 + c + cb);
    store2(dst + cb, (t0.x * gx + t1.x * fx) * gy + (b0.x * gx + b1.x * fx) * fy,
           (t0.y * gx + t1.y * fx) * gy + (b0.y * gx + b1.y * fx) * fy);
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* row, const void* x0p,
                   const void* wx, const void* wy, void* out, int s,
                   int64_t map_stride, int wp, int c, int k,
                   cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, s);
  patch_gather_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(x0p), static_cast<const float*>(wx),
      static_cast<const float*>(wy), static_cast<T*>(out), map_stride, wp, c,
      k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 map/output, 1 = bfloat16 map/output. Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int racformer_patch_gather(int dtype, const void* fused,
                                      const void* row, const void* x0p,
                                      const void* wx, const void* wy,
                                      void* out, int s, int64_t map_stride,
                                      int wp, int c, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(fused, row, x0p, wx, wy, out, s, map_stride, wp, c,
                           k, st);
    case 1:
      return launch<__nv_bfloat16>(fused, row, x0p, wx, wy, out, s,
                                   map_stride, wp, c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
