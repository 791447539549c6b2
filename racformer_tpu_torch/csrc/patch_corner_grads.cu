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
// the [S, K, 4C] corner tensor the TPU path writes and re-reads is gone. The
// first design (one warp per point, 4-byte loads, a 5-step butterfly over
// the warp for two floats) ran at a fifth to a quarter of the bound, bound
// by latency and issue. This design walks the points as K2 does
// (point_tiles.cuh: a lane group per point, 16-byte loads of the four
// corner halves and of g, kInFlight points of each group in flight, a warp
// tile of 32 points, a grid sized to the card). Each lane sums its kVec
// channels in f32; a butterfly inside the lane group (3 shuffle steps in
// bf16, 4 in f32) sums the group, a shuffle hands each point's sums to the
// lane that read its inputs, and the warp stores d_wx and d_wy once per
// tile, one coalesced 128-byte store each. The sums run in a fixed order
// without atomics, so two runs give the same bits. On an H100 (700 W) at the
// image site in bf16 it takes 0.37-0.42 ms against 0.82-0.84 ms for the
// first design and 1.08-1.11 ms for a staged design, tried and removed
// (bulk copies of each point's run into shared memory, see patch_gather.cu);
// like K2 it moves every point's corners through L2.

#include "point_tiles.cuh"

namespace {

using namespace point_tiles;

// Points each lane group keeps in flight, chosen on an H100: 8 beat 4 in
// both dtypes (image site bf16 0.3805 against 0.4657 ms; f32 0.7584 against
// 0.7837, BEV sites 0.3504-0.3601 against 0.3734-0.3815). It takes 254-255
// registers, one block of 8 warps per SM.
constexpr int kInFlight = 8;

// Adds point's share of d_wx, d_wy over kVec channels to sx, sy: the corner
// halves v00, v10, v01, v11 and the cotangent in v[0..4].
template <typename T>
__device__ __forceinline__ void accumulate(const uint4* v, float fx, float fy,
                                           float& sx, float& sy) {
  constexpr int V = Lanes<T>::kVec;
  float v00[V], v10[V], v01[V], v11[V], gv[V];
  to_float<T>(v[0], v00);
  to_float<T>(v[1], v10);
  to_float<T>(v[2], v01);
  to_float<T>(v[3], v11);
  to_float<T>(v[4], gv);
  const float gx = 1.f - fx, gy = 1.f - fy;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sx += gv[j] * ((v01[j] - v00[j]) * gy + (v11[j] - v10[j]) * fy);
    const float top = v00[j] * gx + v01[j] * fx;
    const float bot = v10[j] * gx + v11[j] * fx;
    sy += gv[j] * (bot - top);
  }
}

// Sums sx, sy over the lane group (all its lanes get the sums), then hands
// the sums of the group's point of round r to the lane that holds that
// point's inputs (lane r * kGroups + group), which keeps them in dx, dy.
template <typename T>
__device__ __forceinline__ void reduce_to_owner(float sx, float sy, int r,
                                                float& dx, float& dy) {
  using L = Lanes<T>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = L::kPerPoint / 2; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
  }
  const int src = (lane % L::kGroups) * L::kPerPoint;
  const float x = __shfl_sync(0xffffffffu, sx, src);
  const float y = __shfl_sync(0xffffffffu, sy, src);
  if (lane / L::kGroups == r) {
    dx = x;
    dy = y;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) corner_grads_kernel(
    const T* __restrict__ fused, const T* __restrict__ g,
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    const float* __restrict__ wx, const float* __restrict__ wy,
    float* __restrict__ d_wx, float* __restrict__ d_wy, int64_t map_stride,
    int wp, int c, int k, int64_t n) {
  using L = Lanes<T>;
  constexpr int U = kInFlight;
  static_assert(L::kRounds % U == 0, "kInFlight must divide kRounds");
  const int lane = threadIdx.x & 31;
  const int grp = lane / L::kPerPoint;
  const int c0 = (lane % L::kPerPoint) * L::kVec;  // this lane's first channel
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t t = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  Point mine = own_point(row, x0p, wx, wy, t * kTile + lane, n, k, map_stride,
                         wp, 2 * c);
  for (; t < tiles; t += step) {
    const int64_t first = t * kTile;
    const int count = static_cast<int>(n - first < kTile ? n - first : kTile);
    // the next tile's point inputs, in flight while this tile samples
    const Point next = own_point(row, x0p, wx, wy, first + step * kTile + lane,
                                 n, k, map_stride, wp, 2 * c);
    float dx = 0.f, dy = 0.f;  // this lane's point's sums
#pragma unroll
    for (int r0 = 0; r0 < L::kRounds; r0 += U) {
      Point p[U];
      float sx[U], sy[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = shfl_point(mine, (r0 + u) * L::kGroups + grp);
        sx[u] = sy[u] = 0.f;
      }
      for (int cb = c0; cb < c; cb += kSpan) {
        uint4 v[U][5];  // corners v00, v10, v01, v11, then g
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = (r0 + u) * L::kGroups + grp;
          if (i < count) {
            const T* col = fused + p[u].col + cb;
#pragma unroll
            for (int h = 0; h < 4; ++h) v[u][h] = load16(col + h * c);
            v[u][4] = load16(g + (first + i) * c + cb);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if ((r0 + u) * L::kGroups + grp < count)
            accumulate<T>(v[u], p[u].wx, p[u].wy, sx[u], sy[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) reduce_to_owner<T>(sx[u], sy[u], r0 + u, dx, dy);
    }
    if (lane < count) {
      d_wx[first + lane] = dx;
      d_wy[first + lane] = dy;
    }
    mine = next;
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* g, const void* row,
                   const void* x0p, const void* wx, const void* wy,
                   void* d_wx, void* d_wy, int s, int64_t map_stride, int wp,
                   int c, int k, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(s) * k;
  int blocks = 0;
  static int cap = 0;
  const cudaError_t err = grid_blocks(corner_grads_kernel<T>, n, &cap, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  corner_grads_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const T*>(g),
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(x0p),
      static_cast<const float*>(wx), static_cast<const float*>(wy),
      static_cast<float*>(d_wx), static_cast<float*>(d_wy), map_stride, wp, c,
      k, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 map and cotangent; the
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
    case 2:
      return launch<__half>(fused, g, row, x0p, wx, wy, d_wx, d_wy, s,
                            map_stride, wp, c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
