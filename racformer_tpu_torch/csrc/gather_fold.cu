// Fused fold gather (kernel K1) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_make_fold_kernel`
// (racformer_tpu/ops/gather_kernel.py, launched by `_gather_fold_pallas`).
// For output row o of slab s it computes
//
//   out[s, o, c] = sum_{j < fold} a_j * xl_j[c] + b_j * xl_j[c + C]
//   xl_j         = (1 - wx_j) * F[s, row_j, x0p_j, :] + wx_j * F[s, row_j, x0p_j + 1, :]
//   a_j = (1 - wy_j) * wl_j,  b_j = wy_j * wl_j,  j = o * fold + (0..fold-1)
//
// over a zero-bordered, y-fused map F [S, R, Wp, 2C] (channels [0, C) hold
// row y0, [C, 2C) row y0 + 1, see ops/bilinear.py), i.e. the bilinear sample
// at the clamped corner, weighted by the scalar wl (level softmax or
// attention weight) and summed over `fold` consecutive points.
//
// What bounds it: memory. Each point reads two 2C-channel columns (2 x 256 B
// in bf16 at C = 64) for 4 * C multiply-adds; the decoder's three sites
// gather ~15M points per streaming step, up to ~8 GB of mostly L2-missing
// reads, far below the card's arithmetic rate. The design therefore only
// makes the reads coalesced and keeps everything after the gather in
// registers:
//   * one warp per output row (one fold group), rows of one slab along
//     blockIdx.x, slabs along blockIdx.y;
//   * lane l owns output channels (2l, 2l + 1) of each 64-channel block and
//     reads them as bf16x2 (float2 for f32 maps), so every warp load is one
//     contiguous 128-byte segment of a column;
//   * the x-lerp, y-mix, weight and fold sum accumulate in f32 registers;
//     the output is stored once in the map dtype.
// None of the TPU layout tricks (8-aligned 16-wide windows, packed
// (row << 16) | xb words, fold-mask matmuls, lane rolls) are needed here.
//
// Contract: F, the per-point arrays and out are contiguous, C is even and
// K % fold == 0 (the Python wrapper checks these and raises); 0 <= row < R
// and 0 <= x0p <= Wp - 2 (the samplers guarantee it by clamping the
// coordinates to [-PAD, W] before adding PAD; nothing checks it here).

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
__global__ void __launch_bounds__(32 * kWarpsPerBlock) gather_fold_kernel(
    const T* __restrict__ fused, const int32_t* __restrict__ row,
    const int32_t* __restrict__ x0p, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ wl,
    T* __restrict__ out, int64_t map_stride, int wp, int c, int k, int fold,
    int n_out) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (o >= n_out) return;
  const int s = blockIdx.y;
  const int c2 = 2 * c;
  const T* map = fused + s * map_stride;
  const int64_t p0 = static_cast<int64_t>(s) * k + static_cast<int64_t>(o) * fold;
  T* dst = out + (static_cast<int64_t>(s) * n_out + o) * c;

  for (int cb = 2 * lane; cb < c; cb += 64) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int j = 0; j < fold; ++j) {
      const int64_t p = p0 + j;
      const T* col0 =
          map + (static_cast<int64_t>(row[p]) * wp + x0p[p]) * c2;
      const T* col1 = col0 + c2;
      const float fx = wx[p];
      const float gx = 1.f - fx;
      const float a = (1.f - wy[p]) * wl[p];
      const float b = wy[p] * wl[p];
      const float2 t0 = load2(col0 + cb);
      const float2 b0 = load2(col0 + c + cb);
      const float2 t1 = load2(col1 + cb);
      const float2 b1 = load2(col1 + c + cb);
      acc0 += a * (t0.x * gx + t1.x * fx) + b * (b0.x * gx + b1.x * fx);
      acc1 += a * (t0.y * gx + t1.y * fx) + b * (b0.y * gx + b1.y * fx);
    }
    store2(dst + cb, acc0, acc1);
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* row, const void* x0p,
                   const void* wx, const void* wy, const void* wl, void* out,
                   int s, int64_t map_stride, int wp, int c, int k, int fold,
                   cudaStream_t stream) {
  const int n_out = k / fold;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock, s);
  gather_fold_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(x0p), static_cast<const float*>(wx),
      static_cast<const float*>(wy), static_cast<const float*>(wl),
      static_cast<T*>(out), map_stride, wp, c, k, fold, n_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 map/output, 1 = bfloat16 map/output. Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int racformer_gather_fold(int dtype, const void* fused,
                                     const void* row, const void* x0p,
                                     const void* wx, const void* wy,
                                     const void* wl, void* out, int s,
                                     int64_t map_stride, int wp, int c, int k,
                                     int fold, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(fused, row, x0p, wx, wy, wl, out, s, map_stride,
                           wp, c, k, fold, st);
    case 1:
      return launch<__nv_bfloat16>(fused, row, x0p, wx, wy, wl, out, s,
                                   map_stride, wp, c, k, fold, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
