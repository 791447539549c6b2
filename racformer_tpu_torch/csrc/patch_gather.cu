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
// What bounds it: memory. Each point reads two 2C-channel columns (512 B in
// bf16 at C = 64) and writes C values, for 9 f32 operations per channel; the
// columns a slab's points share are read from device memory once at best
// (the bound of chip_smoke.py counts them so). The first design, one warp
// per point with 4-byte loads and two dependent load latencies per point,
// ran at a quarter to a third of that bound: it was bound by latency and
// issue, not bytes (halving the bytes, bf16 against f32, barely moved it).
// This design (point_tiles.cuh) reads each point with four 16-byte loads
// per lane of a lane group, keeps kInFlight points of each group in flight,
// takes the per-point inputs coalesced for a warp's tile of 32 points (the
// next tile's while this one samples) and walks the points in order on a
// grid sized to the card, so the warps in flight share the current slab's
// columns in L2. The lerps run in f32 registers and the output is rounded
// once to the map dtype and stored 16 bytes per lane, a warp store covering
// consecutive points. On an H100 (700 W) at the image site in bf16 it takes
// 0.33-0.34 ms against 0.60-0.63 ms for the first design. A staged design
// was tried and removed: a producer warp copied each point's 512-byte run
// into a shared-memory ring with cp.async.bulk on mbarriers, and it took
// 1.04-1.06 ms, since each point is its own bulk copy and an SM completes
// about one per 59 ns. What is left above the bound: every point's 512 B
// still pass from L2 to an SM (the bound counts each column once from
// device memory), 4.1-4.6 TB/s of L2 traffic at these times; at the BEV
// sites (0.16-0.18 ms) that is about the time of reading every column from
// device memory (0.19 ms), against a bound of 0.08 ms.
//
// The TPU kernel's 8-aligned 16-wide windows, packed (row << 16) | xb words
// and hat-weight reductions are not needed.

#include "point_tiles.cuh"

namespace {

using namespace point_tiles;

// Points each lane group keeps in flight, chosen on an H100 at the image
// site: in bf16 8 (0.3475 ms) beat 4 (0.3693); in f32 4 (0.7452) beat 8
// (0.8067): with 8 a lane takes 208-218 registers against 122-126, one
// block per SM instead of two, so no more bytes are in flight per SM.
// float16 takes bf16's count: the same 16-bit lanes and bytes per point.
template <typename T>
constexpr int kInFlight = sizeof(T) == 2 ? 8 : 4;

// The bilinear sample of kVec channels from the corner halves v (top and
// bottom of column x0p, then of x0p + 1), rounded to T.
template <typename T>
__device__ __forceinline__ uint4 lerp(const uint4* v, float fx, float fy) {
  constexpr int V = Lanes<T>::kVec;
  float t0[V], b0[V], t1[V], b1[V], o[V];
  to_float<T>(v[0], t0);
  to_float<T>(v[1], b0);
  to_float<T>(v[2], t1);
  to_float<T>(v[3], b1);
  const float gx = 1.f - fx, gy = 1.f - fy;
#pragma unroll
  for (int j = 0; j < V; ++j)
    o[j] = (t0[j] * gx + t1[j] * fx) * gy + (b0[j] * gx + b1[j] * fx) * fy;
  return from_float<T>(o);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) patch_gather_kernel(
    const T* __restrict__ fused, const int32_t* __restrict__ row,
    const int32_t* __restrict__ x0p, const float* __restrict__ wx,
    const float* __restrict__ wy, T* __restrict__ out, int64_t map_stride,
    int wp, int c, int k, int64_t n) {
  using L = Lanes<T>;
  constexpr int V = L::kVec;
  constexpr int U = kInFlight<T>;
  static_assert(L::kRounds % U == 0, "kInFlight must divide kRounds");
  const int lane = threadIdx.x & 31;
  const int grp = lane / L::kPerPoint;
  const int c0 = (lane % L::kPerPoint) * V;  // this lane's first channel
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
#pragma unroll
    for (int r0 = 0; r0 < L::kRounds; r0 += U) {
      Point p[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        p[u] = shfl_point(mine, (r0 + u) * L::kGroups + grp);
      for (int cb = c0; cb < c; cb += kSpan) {
        uint4 v[U][4];  // top / bottom of column x0p, then x0p + 1
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if ((r0 + u) * L::kGroups + grp < count) {
            const T* col = fused + p[u].col + cb;
#pragma unroll
            for (int h = 0; h < 4; ++h) v[u][h] = load16(col + h * c);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = (r0 + u) * L::kGroups + grp;
          if (i < count)
            *reinterpret_cast<uint4*>(out + (first + i) * c + cb) =
                lerp<T>(v[u], p[u].wx, p[u].wy);
        }
      }
    }
    mine = next;
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* row, const void* x0p,
                   const void* wx, const void* wy, void* out, int s,
                   int64_t map_stride, int wp, int c, int k,
                   cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(s) * k;
  int blocks = 0;
  static int cap = 0;
  const cudaError_t err = grid_blocks(patch_gather_kernel<T>, n, &cap, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  patch_gather_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(x0p), static_cast<const float*>(wx),
      static_cast<const float*>(wy), static_cast<T*>(out), map_stride, wp, c,
      k, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 map/output. Returns the
// CUDA error code of the launch (0 = cudaSuccess).
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
    case 2:
      return launch<__half>(fused, row, x0p, wx, wy, out, s, map_stride, wp,
                            c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
