// Corner re-gather with the location gradients (kernel K4) for NVIDIA
// Hopper, sm_90a: d_wx and d_wy of the training samplers' bilinear sample.
//
// Replaces the Pallas TPU kernel `_kernel_corners`
// (racformer_tpu/ops/gather_kernel.py, launched by `_gather_corners_pallas`
// through `patch_corners_pallas`), which returns the four un-lerped corners
// of each point, together with the XLA reduction that turns them into the
// location gradients (ops/bilinear.py `_patch_sample_bwd_impl`). For point p
// of slab s with cotangent g [C] and corners v00, v01 (top row, columns x0p
// and x0p + 1) and v10, v11 (bottom row) of the y-fused map F [S, R, Wp, 2C]:
//
//   d_wx[s, p] = sum_c g[c] * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)
//   d_wy[s, p] = sum_c g[c] * (bot - top)
//   top = v00 * (1 - wx) + v01 * wx,  bot = v10 * (1 - wx) + v11 * wx
//
// What bounds it: memory, as for K2: two 2C-channel columns and C cotangents
// read per point, two floats written. The corners never leave registers, so
// the [S, K, 4C] corner tensor the TPU path writes and re-reads is gone. One
// warp per point, lane l owns channels (2l, 2l + 1) of each 64-channel block
// (bf16x2 / float2 loads, 128-byte segments per warp load); each lane sums
// its channels in f32 and a butterfly of warp shuffles sums the lanes.
//
// Contract: every array is contiguous, C is even (the Python wrapper checks
// these and raises); 0 <= row < R and 0 <= x0p <= Wp - 2 (guaranteed by the
// samplers' clamp; not checked here).

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

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) corner_grads_kernel(
    const T* __restrict__ fused, const T* __restrict__ g,
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    const float* __restrict__ wx, const float* __restrict__ wy,
    float* __restrict__ d_wx, float* __restrict__ d_wy, int64_t map_stride,
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
  const T* src = g + q * c;
  float sx = 0.f, sy = 0.f;
  for (int cb = 2 * lane; cb < c; cb += 64) {
    const float2 gv = load2(src + cb);
    const float2 v00 = load2(col0 + cb);
    const float2 v10 = load2(col0 + c + cb);
    const float2 v01 = load2(col1 + cb);
    const float2 v11 = load2(col1 + c + cb);
    sx += gv.x * ((v01.x - v00.x) * gy + (v11.x - v10.x) * fy) +
          gv.y * ((v01.y - v00.y) * gy + (v11.y - v10.y) * fy);
    const float top0 = v00.x * gx + v01.x * fx, top1 = v00.y * gx + v01.y * fx;
    const float bot0 = v10.x * gx + v11.x * fx, bot1 = v10.y * gx + v11.y * fx;
    sy += gv.x * (bot0 - top0) + gv.y * (bot1 - top1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
  }
  if (lane == 0) {
    d_wx[q] = sx;
    d_wy[q] = sy;
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* g, const void* row,
                   const void* x0p, const void* wx, const void* wy,
                   void* d_wx, void* d_wy, int s, int64_t map_stride, int wp,
                   int c, int k, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, s);
  corner_grads_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const T*>(g),
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(x0p),
      static_cast<const float*>(wx), static_cast<const float*>(wy),
      static_cast<float*>(d_wx), static_cast<float*>(d_wy), map_stride, wp, c,
      k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 map and cotangent, 1 = bfloat16 map and cotangent; the
// location gradients are float32. Returns the CUDA error code of the launch
// (0 = cudaSuccess).
extern "C" int racformer_patch_corner_grads(int dtype, const void* fused,
                                            const void* g, const void* row,
                                            const void* x0p, const void* wx,
                                            const void* wy, void* d_wx,
                                            void* d_wy, int s,
                                            int64_t map_stride, int wp, int c,
                                            int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(fused, g, row, x0p, wx, wy, d_wx, d_wy, s,
                           map_stride, wp, c, k, st);
    case 1:
      return launch<__nv_bfloat16>(fused, g, row, x0p, wx, wy, d_wx, d_wy, s,
                                   map_stride, wp, c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
