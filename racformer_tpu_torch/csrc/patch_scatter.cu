// Patch scatter-add (kernel K3) for NVIDIA Hopper, sm_90a: the map gradient
// of the training samplers' bilinear sample (the backward of K2).
//
// Replaces the Pallas TPU kernel `_kernel` of racformer_tpu/ops/scatter_kernel.py
// (line 47, `pallas_call` at line 100, launched by `_scatter_pallas` from
// racformer_tpu/ops/bilinear.py:266 `_patch_sample_bwd_impl`). For point p of
// slab s with cotangent g [C] it adds
//
//   dF[s, row, x0p + b, c]     += h_b * bf16(g[c] * (1 - wy))
//   dF[s, row, x0p + b, C + c] += h_b * bf16(g[c] * wy),    h_0 = 1 - wx, h_1 = wx
//
// into the gradient dF [S, R, Wp, 2C] of the y-fused map, accumulated in f32
// and returned in g's dtype (the map's: f32, bf16 or f16), rounded once. The
// two y-weighted cotangents are rounded to bf16 before the x-weights,
// whatever the map dtype, as the JAX backward rounds its fused cotangent
// operand (`.astype(jnp.bfloat16)`, then the sum cast to the map dtype), so
// both packages sum the same terms.
//
// What bounds it: memory. The least traffic is the output map, written once
// in its dtype (1.17 GB in bf16 at the image site [32, 792, 180, 128]), plus
// the cotangents read once (303 MB) and 16 B of per-point inputs: ~0.45 ms at
// 3.35 TB/s. An atomic design (f32 atomicAdds into a zeroed f32 map in device
// memory, then a cast) moves ~8 GB for that result: the zero fill, the
// scattered read-modify-writes, the cast's read of the f32 map and its write.
//
// The design: every point adds into exactly one fused row (s, row), both
// channel halves, columns x0p and x0p + 1, so the map gradient splits by
// destination row, and one row's f32 accumulator (Wp * 2C * 4 B: 92,160 B at
// the image site, 67,584 B at the BEV sites) fits in a block's shared memory,
// as the TPU kernel kept the whole slab's map in VMEM.
//   1. Bucket the points by row, stably (count_chunks, scan_chunks,
//      fill_chunks): per-chunk row counts, their prefix over rows and
//      chunks, and a fill that writes each point's record (index, x0p and
//      row, wx, wy: 16 B) to its slot, so a bucket lists its points in
//      ascending index and the accumulation reads its inputs coalesced.
//   2. Cut the bucketed points into tiles of about kSpan (1,024) points,
//      one block each (accumulate_tiles). A tile boundary never splits a
//      bucket of at most kSpan points; a larger bucket (a hot row) is cut
//      every kSpan points from its start, so its pieces are the first rows
//      of consecutive tiles. The block walks its points in windows of up to
//      128, staged in shared memory (records, row keys and the cotangents,
//      loaded by the whole block in 16-byte pieces; the next window's loads
//      fly while a window is added), and adds each run of one row into the
//      f32 accumulator without atomics: a thread owns one channel pair in
//      every 16th column (at C = 16, 32 and 64; below 64 some lanes of a
//      warp own none), a warp picks the window's points that
//      touch its columns with a ballot, sums consecutive points of one
//      column in registers and adds the sum into its own accumulator
//      elements.
//   3. When the row changes, the block converts the finished row to the map
//      dtype, stores it once with 16-byte stores and zeroes the accumulator.
//      A piece of a hot row goes to the tile's f32 slot instead, and
//      finish_rows, one block per row, sums a hot row's slots in tile order
//      and stores the row, and stores zeros for rows without points (this
//      replaces the zero fill; rows without points cluster, so one tile does
//      not write them all). Nothing map-sized in f32 exists in device memory:
//      the slots take one f32 row per tile (213 MB at the image site).
// Atomic-free, and so repeatable: the bucket order is stable, every register
// and accumulator sum runs in that order and the slots are summed in tile
// order, so two runs give bitwise equal results. The other way, shared f32
// atomicAdds with one warp per point, would add in a varying order, and
// sm_90a has no native shared f32 add: the compiler emits a compare-and-swap
// loop (ATOMS.CAST.SPIN) for each. Hot rows and hot columns: real sampling
// points cluster (chip_smoke.py phase 8 prints the largest bucket and the
// busiest column of each site's K3 inputs in a train step). Tiles bound a
// block's work by kSpan points whatever the rows, and the register sums
// turn a hot column's run into one accumulator update per run, not one per
// point. What is left above the bound: the adds of a window do not overlap
// its row stores, and a hot column keeps one or two warps of a block busy
// while the others wait at the window's barrier.
//
// Contract: every array is contiguous, C is 16, 32, 64, 128, 256 or 512
// (whole warps of channel-pair owners; 16 and 32 are embed_dims 64 and 128
// at 4 groups, the VoD smoke's width and the next), a map row
// plus two staged windows fits in shared memory, R <= 7,264 (8 histograms of
// R rows per bucketing block), Wp <= 65,536, S * K < 2^31 (the Python wrapper
// checks these and raises); 0 <= row < R and 0 <= x0p <= Wp - 2 (the
// samplers' clamp; not checked). Scratch from the wrapper: counts
// [S, ceil(K / 1024), R], offsets [S * R + 1], records [S * K, 4], all int32,
// and slots [ceil(S * K / kSpan), Wp * 2C] f32.

#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;          // accumulate_tiles: 16 warps, two blocks per SM
constexpr int kTilePieces = 2 * kThreads;  // 16-byte cotangent pieces per window (16 KB)
constexpr int kMaxWindow = 128;        // points per window
constexpr int kChunk = 1024;          // points of a slab that one warp buckets in order
constexpr int kSpan = 1024;           // bucketed points per tile of accumulate_tiles
constexpr int kChunkWarps = 8;        // chunks per block of the bucketing kernels
constexpr int kChunkUnroll = 4;       // 32-point groups whose loads a warp keeps in flight
constexpr int kScanThreads = 1024;
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Two f32 values rounded to a 16-bit map dtype T, as one 32-bit pair.
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type of(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type of(float x, float y) {
    return __floats2half2_rn(x, y);
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Step 1 in three kernels. A chunk is kChunk consecutive points of one slab;
// warp w of block b takes chunk b * kChunkWarps + w, numbered slab-major.
// count_chunks: each warp counts its chunk's points per row into its own
// shared-memory histogram and writes it to counts [S][chunks per slab][R].
__global__ void __launch_bounds__(kChunkWarps * 32) count_chunks(
    const int32_t* __restrict__ row, int32_t* __restrict__ counts, int rows,
    int k, int nc, int chunks) {
  extern __shared__ int32_t hist[];  // [kChunkWarps][rows]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kChunkWarps + warp;
  if (chunk >= chunks) return;
  int32_t* mine = hist + warp * rows;
  for (int r = lane; r < rows; r += 32) mine[r] = 0;
  __syncwarp();
  const int base = chunk / nc * k;
  const int lo = chunk % nc * kChunk, hi = min(k, lo + kChunk);
  for (int i0 = lo; i0 < hi; i0 += 32 * kChunkUnroll) {
    int key[kChunkUnroll];
#pragma unroll
    for (int u = 0; u < kChunkUnroll; ++u) {
      const int i = i0 + 32 * u + lane;
      key[u] = i < hi ? row[base + i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kChunkUnroll; ++u)
      if (key[u] >= 0) atomicAdd(mine + key[u], 1);
  }
  __syncwarp();
  int32_t* dst = counts + static_cast<int64_t>(chunk) * rows;
  for (int r = lane; r < rows; r += 32) dst[r] = mine[r];
}

// scan_chunks, one block per slab s: offsets[s * R + r] = s * K + (points of
// the slab in rows < r), and counts[s][c][r] becomes the first slot of chunk
// c's points in bucket (s, r): the chunks of a bucket follow in chunk order.
__global__ void __launch_bounds__(kScanThreads) scan_chunks(
    int32_t* __restrict__ counts, int32_t* __restrict__ offsets, int rows,
    int k, int nc) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage scan;
  const int s = blockIdx.x;
  int32_t* slab = counts + static_cast<int64_t>(s) * nc * rows;
  int done = s * k;  // S * K < 2^31 (checked by the wrapper)
  for (int r0 = 0; r0 < rows; r0 += kScanThreads) {
    const int r = r0 + threadIdx.x;
    int total = 0;
    if (r < rows)
      for (int c = 0; c < nc; ++c) total += slab[c * rows + r];
    int run, all;
    Scan(scan).ExclusiveSum(total, run, all);
    __syncthreads();  // the scan's storage is reused next round
    run += done;
    if (r < rows) {
      offsets[s * rows + r] = run;
      for (int c = 0; c < nc; ++c) {
        const int v = slab[c * rows + r];
        slab[c * rows + r] = run;
        run += v;
      }
    }
    done += all;
  }
  if (s == gridDim.x - 1 && threadIdx.x == 0) offsets[gridDim.x * rows] = done;
}

// fill_chunks: each warp walks its chunk in order and writes every point's
// record (point, x0p + (row << 16), wx bits, wy bits) to its slot; ranks
// among a group's points of one row come from __match_any_sync in lane
// order, so every bucket lists its points in ascending index: stable and
// repeatable.
__global__ void __launch_bounds__(kChunkWarps * 32) fill_chunks(
    const int32_t* __restrict__ row, const int32_t* __restrict__ x0p,
    const float* __restrict__ wx, const float* __restrict__ wy,
    const int32_t* __restrict__ counts, int4* __restrict__ records, int rows,
    int k, int nc, int chunks) {
  extern __shared__ int32_t hist[];  // [kChunkWarps][rows]: next slot per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kChunkWarps + warp;
  if (chunk >= chunks) return;
  int32_t* mine = hist + warp * rows;
  const int32_t* src = counts + static_cast<int64_t>(chunk) * rows;
  for (int r = lane; r < rows; r += 32) mine[r] = src[r];
  __syncwarp();
  const int base = chunk / nc * k;
  const int lo = chunk % nc * kChunk, hi = min(k, lo + kChunk);
  for (int i0 = lo; i0 < hi; i0 += 32 * kChunkUnroll) {
    int key[kChunkUnroll], xv[kChunkUnroll];
    float fx[kChunkUnroll], fy[kChunkUnroll];
#pragma unroll
    for (int u = 0; u < kChunkUnroll; ++u) {
      const int i = i0 + 32 * u + lane;
      const bool ok = i < hi;
      key[u] = ok ? row[base + i] : -1;
      xv[u] = ok ? x0p[base + i] : 0;
      fx[u] = ok ? wx[base + i] : 0.f;
      fy[u] = ok ? wy[base + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kChunkUnroll; ++u) {
      const int i = i0 + 32 * u + lane;
      const unsigned active = __ballot_sync(kFull, i < hi);
      if (i < hi) {
        const unsigned peers = __match_any_sync(active, key[u]);
        const int slot = mine[key[u]] + __popc(peers & ((1u << lane) - 1u));
        records[slot] = make_int4(base + i, xv[u] | (key[u] << 16),
                                  __float_as_int(fx[u]), __float_as_int(fy[u]));
        __syncwarp(active);  // every peer has read the slot base
        if (lane == __ffs(peers) - 1) mine[key[u]] += __popc(peers);
      }
      __syncwarp();  // the new bases are visible to the next group
    }
  }
}

// Stores the row in the map dtype (or an f32 slot) and zeroes the
// accumulator for the next.
__device__ __forceinline__ void store_row(float* out, float* acc, int n) {
  float4* src = reinterpret_cast<float4*>(acc);
  float4* dst = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    dst[i] = src[i];
    src[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T>  // bf16 or f16; n is a multiple of 8
__device__ __forceinline__ void store_row(T* out, float* acc, int n) {
  float4* src = reinterpret_cast<float4*>(acc);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) {
    const float4 a = src[2 * i], b = src[2 * i + 1];
    src[2 * i] = src[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    typename Pair<T>::type h[4] = {Pair<T>::of(a.x, a.y), Pair<T>::of(a.z, a.w),
                                   Pair<T>::of(b.x, b.y), Pair<T>::of(b.z, b.w)};
    dst[i] = *reinterpret_cast<const uint4*>(h);
  }
}

// The bucket (s * R + row) of a record.
__device__ __forceinline__ int record_key(int4 r, int k, int rows) {
  return r.x / k * rows + (r.y >> 16);
}

// The first bucketed point of tile i: i * kSpan, moved forward to the end of
// the bucket it falls in when that bucket holds at most kSpan points, or
// back to the last multiple of kSpan from the bucket's start otherwise.
__device__ __forceinline__ int tile_start(int i, const int4* __restrict__ records,
                                          const int32_t* __restrict__ offsets,
                                          int k, int rows) {
  const int p = i * kSpan;
  const int b = record_key(__ldg(records + p), k, rows);
  const int lo = offsets[b], hi = offsets[b + 1];
  if (hi - lo > kSpan) return lo + (p - lo) / kSpan * kSpan;
  return lo == p ? p : hi;
}

// Flags in masks[j / 32] bit j % 32 the window's points j < m that start a
// run of one row (whole warps call it).
__device__ __forceinline__ void run_starts(const int* keys, unsigned* masks,
                                           int m, int window) {
  const int j = threadIdx.x;
  if (j < ((window + 31) & ~31)) {
    const bool f = j < m && (j == 0 || keys[j] != keys[j - 1]);
    const unsigned bits = __ballot_sync(kFull, f);
    if ((j & 31) == 0) masks[j >> 5] = bits;
  }
}

// The end of the run that starts at a: the next flagged point, or m.
__device__ __forceinline__ int run_end(const unsigned* masks, int a, int m) {
  for (int j = a + 1; j < m; j = (j | 31) + 1) {
    const unsigned bits = masks[j >> 5] >> (j & 31);
    if (bits) return min(m, j + __ffs(bits) - 1);
  }
  return m;
}

__device__ __forceinline__ void add_column(float* acc, int x, int c2, int pair,
                                           float2 top, float2 bot) {
  float2* a = reinterpret_cast<float2*>(acc + x * c2 + 2 * pair);
  float2* b = reinterpret_cast<float2*>(acc + x * c2 + c2 / 2 + 2 * pair);
  float2 u = *a, v = *b;
  u.x += top.x;
  u.y += top.y;
  v.x += bot.x;
  v.y += bot.y;
  *a = u;
  *b = v;
}

// Steps 2 and 3: block i takes tile i, the bucketed points
// [tile_start(i), tile_start(i + 1)), in windows of `window` points staged in
// shared memory: their records, row keys, run flags and cotangents, loaded
// by the whole block (16-byte pieces, two per thread). The next window's
// cotangents and the records of the window after it are in flight while a
// window is added. Thread t owns channel pair p = t % owners (channels
// 2p, 2p + 1 of both halves) in the columns x with x % classes == t / owners,
// owners = max(C / 2, 32), so each warp is one class (below C = 64 the lanes
// p >= C / 2 own no pair and only take part in the warp's ballots); a warp
// finds the points of a run that touch its columns with a ballot and sums
// the terms of consecutive points of one column in registers before adding
// them to its accumulator elements: every element has one owner, which adds
// in bucket order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) accumulate_tiles(
    const T* __restrict__ g, const int4* __restrict__ records,
    const int32_t* __restrict__ offsets, T* __restrict__ out,
    float* __restrict__ slots, int npts, int k, int rows, int wp, int c,
    int window) {
  constexpr int kPer = kTilePieces / kThreads;  // cotangent pieces per thread
  extern __shared__ float4 smem[];
  const int c2 = 2 * c, n = wp * c2;
  const int ppp = c * static_cast<int>(sizeof(T)) / 16;  // pieces per point
  float* acc = reinterpret_cast<float*>(smem);
  int4* trec = reinterpret_cast<int4*>(acc + n);           // [2][window]
  uint4* tg = reinterpret_cast<uint4*>(trec + 2 * window);  // [window * ppp]
  const T* tgv = reinterpret_cast<const T*>(tg);
  int* tkey = reinterpret_cast<int*>(tg + window * ppp);     // [2][window]
  unsigned* tmask = reinterpret_cast<unsigned*>(tkey + 2 * window);  // [2][4]
  const int pairs = c / 2, owners = pairs < 32 ? 32 : pairs;
  const int mask = kThreads / owners - 1;
  const int cls = threadIdx.x / owners, pair = threadIdx.x % owners;
  const bool owner = pair < pairs;
  const int lane = threadIdx.x & 31, tid = threadIdx.x;

  const int tile = blockIdx.x;
  const int start = tile_start(tile, records, offsets, k, rows);
  const int end = static_cast<int64_t>(tile + 1) * kSpan < npts
                      ? tile_start(tile + 1, records, offsets, k, rows)
                      : npts;
  if (start >= end) return;
  // the tile's first row is the only one that may continue in other tiles
  const int first = record_key(__ldg(records + start), k, rows);
  const bool split = offsets[first] < start || offsets[first + 1] > end;
  auto flush = [&](int key) {  // the whole block, between barriers
    if (key == first && split)
      store_row(slots + static_cast<int64_t>(tile) * n, acc, n);
    else
      store_row(out + static_cast<int64_t>(key) * n, acc, n);
  };

  for (int i = tid; i < n / 4; i += kThreads)
    smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int m = min(window, end - start);
  if (tid < m) {
    const int4 r = __ldg(records + start + tid);
    trec[tid] = r;
    tkey[tid] = record_key(r, k, rows);
  }
  int wn = start + m, mn = min(window, end - wn);  // the next window
  int4 rec = tid < mn ? __ldg(records + wn + tid) : make_int4(0, 0, 0, 0);
  __syncthreads();
  run_starts(tkey, tmask, m, window);
  uint4 gv[kPer];
#pragma unroll
  for (int h = 0; h < kPer; ++h) {
    const int p = tid + h * kThreads;
    if (p < m * ppp)
      gv[h] = __ldg(reinterpret_cast<const uint4*>(
                        g + static_cast<int64_t>(trec[p / ppp].x) * c) +
                    p % ppp);
  }
  int buf = 0, pending = -1;  // the row in the accumulator
  while (m > 0) {
    // stage this window's cotangents (in gv) and the next one's records
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int p = tid + h * kThreads;
      if (p < m * ppp) tg[p] = gv[h];
    }
    const int nb = buf ^ 1;
    if (tid < mn) {
      trec[nb * window + tid] = rec;
      tkey[nb * window + tid] = record_key(rec, k, rows);
    }
    __syncthreads();  // window staged
    run_starts(tkey + nb * window, tmask + nb * 4, mn, window);
    // in flight while this window is added: the next window's cotangents,
    // the records of the window after it
    const int4* tnext = trec + nb * window;
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int p = tid + h * kThreads;
      if (p < mn * ppp)
        gv[h] = __ldg(reinterpret_cast<const uint4*>(
                          g + static_cast<int64_t>(tnext[p / ppp].x) * c) +
                      p % ppp);
    }
    const int wa = wn + mn, ma = min(window, end - wa);
    rec = tid < ma ? __ldg(records + wa + tid) : make_int4(0, 0, 0, 0);

    const int4* tcur = trec + buf * window;
    const int* kcur = tkey + buf * window;
    const unsigned* mcur = tmask + buf * 4;
    for (int a = 0; a < m;) {
      const int b = run_end(mcur, a, m);
      const int key = kcur[a];
      if (key != pending) {  // the same on every thread
        if (pending >= 0) {
          __syncthreads();  // every warp has added the row
          flush(pending);
          __syncthreads();  // stored and zeroed
        }
        pending = key;
      }
      float2 top = make_float2(0.f, 0.f), bot = top;
      int cx = -1;  // the column whose terms top / bot hold
      auto add = [&](int4 r, float2 gp) {  // one point's terms, in order
        const int xs = r.y & 0xffff, dx = (cls - xs) & mask;
        if (xs + dx != cx) {
          if (cx >= 0 && owner) add_column(acc, cx, c2, pair, top, bot);
          cx = xs + dx;
          top = bot = make_float2(0.f, 0.f);
        }
        const float fx = __int_as_float(r.z), fy = __int_as_float(r.w);
        const float h = dx ? fx : 1.f - fx, gy = 1.f - fy;
        top.x += h * round_bf16(gp.x * gy);
        top.y += h * round_bf16(gp.y * gy);
        bot.x += h * round_bf16(gp.x * fy);
        bot.y += h * round_bf16(gp.y * fy);
      };
      for (int t0 = a; t0 < b; t0 += 32) {
        const int j = t0 + lane;
        const int x0 = j < b ? tcur[j].y & 0xffff : 0;
        unsigned todo = __ballot_sync(kFull, j < b && ((cls - x0) & mask) <= 1);
        while (todo) {  // two points at a time: both points' loads in flight
          const int s1 = __ffs(todo) - 1;
          todo &= todo - 1;
          const int s2 = todo ? __ffs(todo) - 1 : s1;
          todo &= todo - 1;
          const int4 r1 = tcur[t0 + s1], r2 = tcur[t0 + s2];
          const float2 zero = make_float2(0.f, 0.f);
          const float2 g1 = owner ? load2(tgv + (t0 + s1) * c + 2 * pair) : zero;
          const float2 g2 = owner ? load2(tgv + (t0 + s2) * c + 2 * pair) : zero;
          add(r1, g1);
          if (s2 != s1) add(r2, g2);
        }
      }
      if (cx >= 0 && owner) add_column(acc, cx, c2, pair, top, bot);
      a = b;
    }
    __syncthreads();  // the window is consumed
    buf = nb;
    m = mn;
    wn = wa;
    mn = ma;
  }
  flush(pending);
}

// Step 3 for the rows no tile stored: zeros for a row without points, and
// for a hot row the sum of its pieces' slots in tile order.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads) finish_rows(
    const int32_t* __restrict__ offsets, const float* __restrict__ slots,
    T* __restrict__ out, int n) {
  const int lo = offsets[blockIdx.x], hi = offsets[blockIdx.x + 1];
  T* dst = out + static_cast<int64_t>(blockIdx.x) * n;
  if (lo == hi) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int pieces = n * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < pieces; i += kFinishThreads)
      d[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // a bucket of more than kSpan points starts tile i0 and is cut at every
  // kSpan points, into the first rows of tiles i0 .. i1
  const int i0 = lo / kSpan + (lo % kSpan != 0), i1 = (hi - 1) / kSpan;
  if (hi - lo <= kSpan || i1 == i0) return;  // stored whole by its tile
  const float4* src = reinterpret_cast<const float4*>(slots);
  for (int i = threadIdx.x; i < n / 4; i += kFinishThreads) {
    float4 s = src[static_cast<int64_t>(i0) * (n / 4) + i];
    for (int t = i0 + 1; t <= i1; ++t) {
      const float4 v = src[static_cast<int64_t>(t) * (n / 4) + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(dst)[i] = s;
    } else {
      typename Pair<T>::type h[2] = {Pair<T>::of(s.x, s.y),
                                     Pair<T>::of(s.z, s.w)};
      reinterpret_cast<uint2*>(dst)[i] = *reinterpret_cast<const uint2*>(h);
    }
  }
}

// Points per window at C channels of `bytes` each: at most kTilePieces pieces.
int window_points(int c, int bytes) {
  return min(kMaxWindow, kTilePieces / (c * bytes / 16));
}

int shared_bytes(int wp, int c, int bytes) {
  const int w = window_points(c, bytes);
  return wp * 2 * c * 4 + w * (2 * 16 + c * bytes + 2 * 4) + 2 * 4 * 4;
}

cudaError_t bucket(const int32_t* row, const int32_t* x0p, const float* wx,
                   const float* wy, int32_t* counts, int32_t* offsets,
                   int4* records, int s, int rows, int k, cudaStream_t st) {
  const int nc = (k + kChunk - 1) / kChunk, chunks = s * nc;
  const int blocks = (chunks + kChunkWarps - 1) / kChunkWarps;
  const int smem = kChunkWarps * rows * 4;
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        count_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fill_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (blocks > 0) {
    count_chunks<<<blocks, kChunkWarps * 32, smem, st>>>(row, counts, rows, k,
                                                        nc, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scan_chunks<<<s, kScanThreads, 0, st>>>(counts, offsets, rows, k, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return err;
  fill_chunks<<<blocks, kChunkWarps * 32, smem, st>>>(
      row, x0p, wx, wy, counts, records, rows, k, nc, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* g, const void* row, const void* x0p,
                   const void* wx, const void* wy, void* counts,
                   void* offsets, void* records, void* slots, void* out, int s,
                   int rows, int wp, int c, int k, cudaStream_t st) {
  cudaError_t err = bucket(
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(x0p),
      static_cast<const float*>(wx), static_cast<const float*>(wy),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(offsets),
      static_cast<int4*>(records), s, rows, k, st);
  if (err != cudaSuccess) return err;
  const int bytes = static_cast<int>(sizeof(T)), npts = s * k, n = wp * 2 * c;
  const int tiles = (npts + kSpan - 1) / kSpan;
  if (tiles > 0) {
    const int smem = shared_bytes(wp, c, bytes);
    static int allowed = 48 * 1024;  // per instantiation: raised once, kept
    if (smem > allowed) {
      err = cudaFuncSetAttribute(accumulate_tiles<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      allowed = smem;
    }
    accumulate_tiles<T><<<tiles, kThreads, smem, st>>>(
        static_cast<const T*>(g), static_cast<const int4*>(records),
        static_cast<const int32_t*>(offsets), static_cast<T*>(out),
        static_cast<float*>(slots), npts, k, rows, wp, c,
        window_points(c, bytes));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  finish_rows<T><<<s * rows, kFinishThreads, 0, st>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float*>(slots),
      static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// The bucketing alone (step 1), for checks: offsets [S*R + 1] and records
// [S*K, 4] (point, x0p + (row << 16), wx bits, wy bits) in bucket order;
// counts is scratch of S * ceil(K / 1024) * R int32.
extern "C" int racformer_bucket_rows(const void* row, const void* x0p,
                                     const void* wx, const void* wy,
                                     void* counts, void* offsets,
                                     void* records, int s, int rows, int k,
                                     void* stream) {
  return static_cast<int>(bucket(
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(x0p),
      static_cast<const float*>(wx), static_cast<const float*>(wy),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(offsets),
      static_cast<int4*>(records), s, rows, k,
      static_cast<cudaStream_t>(stream)));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, for g and the gradient map `out`
// [S, R, Wp, 2C] alike; slots holds ceil(S * K / 1024) f32 rows (kSpan).
// Returns the CUDA error code of the first launch or call that failed
// (0 = cudaSuccess).
extern "C" int racformer_patch_scatter(int dtype, const void* g,
                                       const void* row, const void* x0p,
                                       const void* wx, const void* wy,
                                       void* counts, void* offsets,
                                       void* records, void* slots, void* out,
                                       int s, int rows, int wp, int c, int k,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, row, x0p, wx, wy, counts, offsets, records,
                           slots, out, s, rows, wp, c, k, st);
    case 1:
      return launch<__nv_bfloat16>(g, row, x0p, wx, wy, counts, offsets,
                                   records, slots, out, s, rows, wp, c, k,
                                   st);
    case 2:
      return launch<__half>(g, row, x0p, wx, wy, counts, offsets, records,
                            slots, out, s, rows, wp, c, k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
