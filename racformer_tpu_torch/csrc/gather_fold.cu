// Fused fold gather (kernel K1) for NVIDIA Hopper, sm_90a: the eval path's
// bilinear sample, weighted and summed over `fold` points.
//
// Replaces the Pallas TPU kernel `_make_fold_kernel`
// (racformer_tpu/ops/gather_kernel.py, launched by `_gather_fold_pallas`
// through `patch_sample_fold`). For output row o of slab s it computes
//
//   out[s, o, c] = sum_{j < fold} a_j * xl_j[c] + b_j * xl_j[c + C]
//   xl_j         = (1 - wx_j) * F[s, row_j, x0p_j, :] + wx_j * F[s, row_j, x0p_j + 1, :]
//   a_j = (1 - wy_j) * wl_j,  b_j = wy_j * wl_j,  j = o * fold + (0..fold-1)
//
// over a zero-bordered, y-fused map F [S, R, Wp, 2C] (channels [0, C) hold
// row y0, [C, 2C) row y0 + 1, see ops/bilinear.py), i.e. the bilinear sample
// at the clamped corner, weighted by the scalar wl (level softmax or
// attention weight) and summed over `fold` consecutive points. Arithmetic
// is f32; each output is rounded once to the map dtype.
//
// What bounds it: bytes. Each point reads two 2C-channel columns (512 B in
// bf16 at C = 64) for 11 f32 operations per channel. At the image site a
// slab's touched columns stay in L2, so what limits the kernel is every
// point's 512 B passing from L2 to an SM (0.78 GB per call at flagship shape
// in bf16, 1.5 GB in f32); at the BEV sites a slab's map is mostly touched
// and each column read several times, so device memory for the map is the
// floor. The first design ran one warp per output, each lane reading 4
// bytes (bf16x2) or 8 (float2) of a column, one point at a time, each
// point's map loads waiting on that point's own index loads: in bf16 it was
// bound by that latency, not by bytes. This design walks the points as K2
// does (point_tiles.cuh):
//   * a lane group serves one output (8 lanes in bf16, 16 in f32, 16 bytes
//     per lane of each of the four corner halves, 64 channels a pass);
//   * a warp tile holds whole fold groups: 32 / fold outputs for fold <= 32
//     (8 at fold = 4, 32 points), one output for a larger fold (its points
//     taken 32 at a time); each lane reads one point's row, x0p, wx, wy and
//     wl (coalesced; the next tile's while this one samples), turns them
//     into the column's offset and a = (1 - wy) wl, b = wy wl, and hands
//     them out by __shfl_sync, so no map load waits on an index load;
//   * kInFlight points of each lane group in flight: every map load of
//     that many points (a whole fold group, or two in f32) is issued before
//     any arithmetic on them; the x-lerp, y-mix, weight and fold sum
//     accumulate in f32 registers and each output is stored once, 16 bytes
//     per lane, the groups of a warp storing neighbouring outputs;
//   * a grid sized to the card, each warp striding over the tiles of the
//     flattened S x K / fold outputs in order, so the warps in flight share
//     one slab's columns in L2. The ragged last tile is masked.
// On an NVIDIA H100 80GB HBM3 (700 W), against the first design in the
// same call (chip_smoke.py): in the eval step K1 takes 1.36-1.37 ms over
// its 18 launches against 2.11 ms; at the flagship shapes with uniform
// points, bf16, one wrapper call timed, 0.2036-0.2076 ms at the image site
// against 0.2475-0.2479 and 0.1082-0.1142 at the BEV sites against
// 0.1227-0.1342. Bare launches (scripts/sweep_fold_in_flight.py) take
// 0.1914-0.1918 ms at the image site, about 4.1 TB/s from L2 (K2 moves
// 4.6 TB/s with its outputs). In bf16 two blocks per SM (128 registers,
// 140 bytes of spill) beat one: one fold group in flight at one block (164
// registers) took 0.2054-0.2160 ms and two fold groups (255 registers)
// 0.2120-0.2192. In f32 two blocks lost (0.3796-0.3951 ms against
// 0.3247-0.3410), and two fold groups at one block level with one at the
// image site and lead by up to 8% at the BEV sites in two of three calls.
// None of the TPU layout tricks (8-aligned 16-wide windows, packed
// (row << 16) | xb words, fold-mask matmuls, lane rolls) are needed here.
//
// Contract (the Python wrapper checks the first four and raises, and
// allocates the output aligned): every array is contiguous, the map and the
// output lie at 16-byte aligned addresses, C is a multiple of kVec (8 in
// bf16 and f16, 4 in f32), K % fold == 0;
// 0 <= row < R and 0 <= x0p <= Wp - 2 (the samplers guarantee it by
// clamping the coordinates to [-PAD, W] before adding PAD; unchecked).

#include "point_tiles.cuh"

namespace {

using namespace point_tiles;

// Points each lane group keeps in flight (one fold group of the decoder's
// fold = 4 in bf16 and f16, two in f32), and the blocks per SM asked of ptxas (2
// caps a thread at 128 registers): chosen on the card, see the note above;
// float16 takes bf16's, whose lanes and bytes per point it shares.
template <typename T>
constexpr int kInFlight = sizeof(T) == 2 ? 4 : 8;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;

// Outputs of one warp tile: whole fold groups, at most kTile points.
__host__ __device__ inline int tile_outputs(int fold) {
  return fold <= kTile ? kTile / fold : 1;
}

// One point: the map offset of its column x0p (elements), its x-lerp weight
// and its y-mix weights times wl.
struct FoldPoint {
  int64_t col;
  float wx, a, b;
};

// Point q of the flattened [S, K] inputs; past the end a dummy that is never
// sampled.
__device__ __forceinline__ FoldPoint own_fold_point(
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wl, int64_t q, int64_t n, int k,
    int64_t map_stride, int wp, int c2) {
  if (q >= n) return {0, 0.f, 0.f, 0.f};
  const float y = __ldg(wy + q), w = __ldg(wl + q);
  return {column_of(row, x0p, q, n, k, map_stride, wp, c2), __ldg(wx + q),
          (1.f - y) * w, y * w};
}

__device__ __forceinline__ FoldPoint shfl_fold_point(const FoldPoint& p,
                                                     int src) {
  return {__shfl_sync(0xffffffffu, p.col, src),
          __shfl_sync(0xffffffffu, p.wx, src),
          __shfl_sync(0xffffffffu, p.a, src),
          __shfl_sync(0xffffffffu, p.b, src)};
}

// Adds one point's weighted sample of kVec channels to acc: the corner
// halves v (top and bottom of column x0p, then of x0p + 1).
template <typename T>
__device__ __forceinline__ void accumulate(const uint4* v, const FoldPoint& p,
                                           float* acc) {
  constexpr int V = Lanes<T>::kVec;
  float t0[V], b0[V], t1[V], b1[V];
  to_float<T>(v[0], t0);
  to_float<T>(v[1], b0);
  to_float<T>(v[2], t1);
  to_float<T>(v[3], b1);
  const float gx = 1.f - p.wx;
#pragma unroll
  for (int i = 0; i < V; ++i)
    acc[i] += p.a * (t0[i] * gx + t1[i] * p.wx) + p.b * (b0[i] * gx + b1[i] * p.wx);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kMinBlocks<T>) gather_fold_kernel(
    const T* __restrict__ fused, const int32_t* __restrict__ row,
    const int32_t* __restrict__ x0p, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ wl,
    T* __restrict__ out, int64_t map_stride, int wp, int c, int k, int fold,
    int64_t n_out) {
  using L = Lanes<T>;
  constexpr int V = L::kVec;
  constexpr int U = kInFlight<T>;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L::kPerPoint;
  const int c0 = (lane % L::kPerPoint) * V;  // this lane's first channel
  const int64_t n = n_out * fold;             // points
  const int per_tile = tile_outputs(fold);
  const int64_t tiles = (n_out + per_tile - 1) / per_tile;
  // the walk of each lane group over a tile: its outputs grp, grp + kGroups,
  // ..., fold points each, in the same steps for every group of the warp
  const int walk = (per_tile + L::kGroups - 1) / L::kGroups * fold;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  int64_t t = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  FoldPoint mine = own_fold_point(row, x0p, wx, wy, wl, t * per_tile * fold + lane,
                                  n, k, map_stride, wp, 2 * c);
  for (; t < tiles; t += step) {
    const int64_t first = t * per_tile;  // the tile's first output
    const int64_t p0 = first * fold;     // and its first point
    const int count = static_cast<int>(
        n_out - first < per_tile ? n_out - first : per_tile);
    // the next tile's point inputs, in flight while this tile samples
    const FoldPoint next = own_fold_point(row, x0p, wx, wy, wl,
                                          p0 + step * per_tile * fold + lane, n,
                                          k, map_stride, wp, 2 * c);
    for (int cb0 = 0; cb0 < c; cb0 += kSpan) {  // warp-uniform: lanes shuffle
      const int cb = cb0 + c0;
      const bool active = cb < c;  // false for idle lanes of a narrow C
      FoldPoint win = mine;  // points p0 + 32 w + lane, window w = j / 32
      int i = grp, j = 0;    // the group's current output and its point
      float acc[V] = {};
      for (int s0 = 0; s0 < walk; s0 += U) {
        FoldPoint p[U];
        int at[U];     // output of each step, or -1 past the group's walk
        bool ends[U];  // whether the step's point ends its output
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // fold > 32: the output's next 32 points (j is the same in every
          // group, so the whole warp reloads)
          if (j > 0 && (j & (kTile - 1)) == 0)
            win = own_fold_point(row, x0p, wx, wy, wl, p0 + j + lane, n, k,
                                 map_stride, wp, 2 * c);
          p[u] = shfl_fold_point(win, (i * fold + j) & (kTile - 1));
          at[u] = s0 + u < walk && i < count ? i : -1;
          ends[u] = j == fold - 1;
          if (++j == fold) {
            j = 0;
            i += L::kGroups;
          }
        }
        uint4 v[U][4];  // top / bottom of column x0p, then x0p + 1
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (at[u] >= 0 && active) {
            const T* col = fused + p[u].col + cb;
#pragma unroll
            for (int h = 0; h < 4; ++h) v[u][h] = load16(col + h * c);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (at[u] >= 0 && active) accumulate<T>(v[u], p[u], acc);
          if (ends[u]) {
            if (at[u] >= 0 && active)
              *reinterpret_cast<uint4*>(out + (first + at[u]) * c + cb) =
                  from_float<T>(acc);
#pragma unroll
            for (int q = 0; q < V; ++q) acc[q] = 0.f;
          }
        }
      }
    }
    mine = next;
  }
}

template <typename T>
cudaError_t launch(const void* fused, const void* row, const void* x0p,
                   const void* wx, const void* wy, const void* wl, void* out,
                   int s, int64_t map_stride, int wp, int c, int k, int fold,
                   cudaStream_t stream) {
  const int64_t n_out = static_cast<int64_t>(s) * (k / fold);
  const int per_tile = tile_outputs(fold);
  int blocks = 0;
  static int cap = 0;
  const cudaError_t err = grid_blocks_for_tiles(
      gather_fold_kernel<T>, (n_out + per_tile - 1) / per_tile, &cap, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  gather_fold_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(fused), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(x0p), static_cast<const float*>(wx),
      static_cast<const float*>(wy), static_cast<const float*>(wl),
      static_cast<T*>(out), map_stride, wp, c, k, fold, n_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 map/output. Returns the
// CUDA error code of the launch (0 = cudaSuccess).
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
    case 2:
      return launch<__half>(fused, row, x0p, wx, wy, wl, out, s, map_stride,
                            wp, c, k, fold, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
