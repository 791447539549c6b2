// Point tiles for the per-point kernels on sm_90a: the training samplers'
// K2 (patch_gather.cu) and K4 (patch_corner_grads.cu), and the eval path's
// fold gather K1 (gather_fold.cu).
//
// Each reads, for every point, the two adjacent columns x0p and x0p + 1 of
// one fused row of the y-fused map F [S, R, Wp, 2C]: 4C contiguous values
// (512 B in bf16 or f16 at C = 64). How they walk the points:
//
//   * 16-byte loads. A group of lanes serves one point (K1: one output, its
//     fold points in turn), each lane 16 bytes (kVec channels) of each of
//     the four corner halves: 8 lanes in bf16 or f16, 16 in f32 cover 64 channels
//     (kSpan); a wider C takes more passes. One warp load instruction reads
//     32 / kPerPoint points' 128-byte runs.
//   * A tile of 32 points per warp (K1: whole fold groups, at most 32
//     points). Each lane reads one point's inputs (coalesced), turns them
//     into the column's offset in the map and hands them to the lane group
//     that samples the point by __shfl_sync, so no map load waits on a
//     dependent index load of its own.
//   * kInFlight points per lane group in flight (set by each kernel): every
//     map load of that many points is issued before any arithmetic on them.
//   * A grid sized to the card: as many blocks as stay resident on all SMs
//     (fewer if the tiles need fewer), each warp striding over the tiles of
//     the flattened S x K points in order, so the warps in flight work on
//     neighbouring points of one or two slabs and share the map columns
//     those slabs hold in L2. The ragged last tile is masked.
//
// Contract (the Python wrappers check the first three and raise; they
// allocate the outputs, aligned): every array is contiguous, the map and
// any [S, K, C] input or output lie at 16-byte aligned addresses, C is a
// multiple of kVec (8 in bf16 and f16, 4 in f32);
// 0 <= row < R and 0 <= x0p <= Wp - 2 (the samplers' clamp; unchecked).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace point_tiles {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 32;  // points per warp tile, one per lane
constexpr int kSpan = 64;  // channels a lane group covers in one pass

// The points each lane group keeps in flight are the kernel's own choice
// (kInFlight in each kernel's source); in patch_gather.cu and
// patch_corner_grads.cu it must divide kRounds.
template <typename T>
struct Lanes {
  static constexpr int kVec = 16 / sizeof(T);     // channels per 16-byte load
  static constexpr int kPerPoint = kSpan / kVec;  // lanes per point: 8 / 16
  static constexpr int kGroups = 32 / kPerPoint;  // points per warp load
  static constexpr int kRounds = kTile / kGroups;  // points per group per tile
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of T as f32
template <typename T>
__device__ __forceinline__ void to_float(const uint4& v, float* f);

template <>
__device__ __forceinline__ void to_float<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& v,
                                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <>
__device__ __forceinline__ void to_float<__half>(const uint4& v, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// kVec f32 values rounded to T, as 16 bytes
template <typename T>
__device__ __forceinline__ uint4 from_float(const float* f);

template <>
__device__ __forceinline__ uint4 from_float<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 from_float<__nv_bfloat16>(const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return r;
}

template <>
__device__ __forceinline__ uint4 from_float<__half>(const float* f) {
  uint4 r;
  __half2* h = reinterpret_cast<__half2*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  return r;
}

// The map offset of point q's column x0p (elements); 0 past the end.
__device__ __forceinline__ int64_t column_of(
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    int64_t q, int64_t n, int k, int64_t map_stride, int wp, int c2) {
  if (q >= n) return 0;
  return (q / k) * map_stride +
         (static_cast<int64_t>(__ldg(row + q)) * wp + __ldg(x0p + q)) * c2;
}

// One point: the map offset of its column x0p (elements) and its weights.
struct Point {
  int64_t col;
  float wx, wy;
};

// Point q of the flattened [S, K] inputs; past the end a dummy that is never
// sampled.
__device__ __forceinline__ Point own_point(
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    const float* __restrict__ wx, const float* __restrict__ wy, int64_t q,
    int64_t n, int k, int64_t map_stride, int wp, int c2) {
  if (q >= n) return {0, 0.f, 0.f};
  return {column_of(row, x0p, q, n, k, map_stride, wp, c2), __ldg(wx + q),
          __ldg(wy + q)};
}

__device__ __forceinline__ Point shfl_point(const Point& p, int src) {
  return {__shfl_sync(0xffffffffu, p.col, src),
          __shfl_sync(0xffffffffu, p.wx, src),
          __shfl_sync(0xffffffffu, p.wy, src)};
}

// Blocks of the grid for `tiles` warp tiles: the resident capacity of the
// card (every SM full at the kernel's occupancy), or fewer if the tiles
// need fewer. `cap` caches the capacity across calls (one card per process).
template <typename Kernel>
cudaError_t grid_blocks_for_tiles(Kernel kernel, int64_t tiles, int* cap,
                                  int* blocks) {
  if (*cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, 32 * kWarpsPerBlock, 0);
    if (err != cudaSuccess) return err;
    *cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  *blocks = static_cast<int>(need < *cap ? need : *cap);
  return cudaSuccess;
}

// The same for n points in tiles of kTile.
template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, int64_t n, int* cap, int* blocks) {
  return grid_blocks_for_tiles(kernel, (n + kTile - 1) / kTile, cap, blocks);
}

}  // namespace point_tiles
