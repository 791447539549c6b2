// Patch scatter-add (kernel K3) for NVIDIA Hopper, sm_90a: the map gradient
// of the training samplers' bilinear sample (the backward of K2).
//
// Replaces the Pallas TPU kernel `_kernel` of racformer_tpu/ops/scatter_kernel.py
// (launched by `_scatter_pallas` from `bilinear._patch_sample_bwd_impl`). For
// point p of slab s with cotangent g [C] it adds
//
//   dF[s, row, x0p + b, c]     += h_b * bf16(g[c] * (1 - wy))
//   dF[s, row, x0p + b, C + c] += h_b * bf16(g[c] * wy),    h_0 = 1 - wx, h_1 = wx
//
// into an f32 gradient map dF [S, R, Wp, 2C] in the y-fused layout of the
// forward's map. The two y-weighted cotangents are rounded to bf16 before the
// x-weights, as the JAX backward rounds its fused cotangent operand
// (ops/bilinear.py `_patch_sample_bwd_impl`), so both packages sum the same
// terms.
//
// What bounds it: the atomic adds. Each point adds 4 * C f32 values (1 KB at
// C = 64) into two columns of the map; at the training path's shapes the
// points of one slab hit the same columns many times, so the adds contend in
// L2. The TPU kernel kept the whole gradient map resident in VMEM and
// updated 16-wide windows in sequence; Hopper has no 100 MB on-chip memory
// and its blocks run in parallel, so this kernel follows the reference's
// CUDA backward (`msmv_sampling_backward.cu`): one warp per point, lane l owns
// channels (2l, 2l + 1) of each 64-channel block, reads its cotangents as
// bf16x2 (float2 for f32) and issues `atomicAdd`s of f32 (red.global.add),
// which neighbouring lanes aim at neighbouring words of one column. The sums
// land in a different order from run to run.
//
// Contract: every array is contiguous, C is even, dF is zeroed by the caller
// (the Python wrapper allocates it and checks the rest); 0 <= row < R and
// 0 <= x0p <= Wp - 2 (guaranteed by the samplers' clamp; not checked here).

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) patch_scatter_kernel(
    const T* __restrict__ g, const int32_t* __restrict__ row,
    const int32_t* __restrict__ x0p, const float* __restrict__ wx,
    const float* __restrict__ wy, float* __restrict__ acc, int64_t map_stride,
    int wp, int c, int k) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= k) return;
  const int s = blockIdx.y;
  const int c2 = 2 * c;
  const int64_t q = static_cast<int64_t>(s) * k + p;
  float* col0 = acc + s * map_stride +
                (static_cast<int64_t>(row[q]) * wp + x0p[q]) * c2;
  float* col1 = col0 + c2;
  const float fx = wx[q];
  const float gx = 1.f - fx;
  const float fy = wy[q];
  const float gy = 1.f - fy;
  const T* src = g + q * c;
  for (int cb = 2 * lane; cb < c; cb += 64) {
    const float2 gv = load2(src + cb);
    const float t0 = round_bf16(gv.x * gy), t1 = round_bf16(gv.y * gy);
    const float b0 = round_bf16(gv.x * fy), b1 = round_bf16(gv.y * fy);
    atomicAdd(col0 + cb, gx * t0);
    atomicAdd(col0 + cb + 1, gx * t1);
    atomicAdd(col0 + c + cb, gx * b0);
    atomicAdd(col0 + c + cb + 1, gx * b1);
    atomicAdd(col1 + cb, fx * t0);
    atomicAdd(col1 + cb + 1, fx * t1);
    atomicAdd(col1 + c + cb, fx * b0);
    atomicAdd(col1 + c + cb + 1, fx * b1);
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* row, const void* x0p,
                   const void* wx, const void* wy, void* acc, int s,
                   int64_t map_stride, int wp, int c, int k,
                   cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, s);
  patch_scatter_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(x0p), static_cast<const float*>(wx),
      static_cast<const float*>(wy), static_cast<float*>(acc), map_stride, wp,
      c, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 cotangent, 1 = bfloat16 cotangent; the gradient map is
// always float32. Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int racformer_patch_scatter(int dtype, const void* g,
                                       const void* row, const void* x0p,
                                       const void* wx, const void* wy,
                                       void* acc, int s, int64_t map_stride,
                                       int wp, int c, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, row, x0p, wx, wy, acc, s, map_stride, wp, c, k,
                           st);
    case 1:
      return launch<__nv_bfloat16>(g, row, x0p, wx, wy, acc, s, map_stride,
                                   wp, c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
