// Linear assignment (the Hungarian set matching of the detection loss) for
// NVIDIA Hopper, sm_90a.
//
// Replaces no Pallas kernel. The JAX package solves the same problems in its
// graph, on the device, with lax.while_loops (`_lap_single` in
// racformer_tpu/train/matching.py); the port solved them on the host
// (`train/matching.py::lap_single`), which copied the cost to the host, so
// the host waited for the forward, and then stepped a Python loop while the
// device stood idle. This kernel runs `lap_single`'s algorithm step for step
// in float32, so its matches are the host solver's bit for bit: the e-maxx
// Jonker-Volgenant shortest augmenting path with a virtual column 0, one
// Dijkstra phase per row i = 1..G over columns 0..Q, each step
//
//   cur      = (cost[i0] - u[i0]) - v            on the unused columns
//   minv, way <- cur, j0                         where cur < minv
//   j1       = argmin(used ? 1e18 : minv)        the lowest column on ties
//   delta    = that minimum
//   u[p[j]] += delta, v[j] -= delta              on the used columns
//   minv[j] -= delta                             on the others
//
// until the column j1 reached is free, then the augmenting walk along `way`.
// Nothing is reordered: no multiply exists to contract into an FMA, and the
// library is built without fast-math.
//
// What bounds it: latency. A problem is a chain of dependent steps (up to
// ~2,000 for a [64, 900] cost whose rows are mostly padding: each padded
// row walks through every column the padded rows before it took), and a
// step is one pass over Q + 1 columns and one argmin over them. Bytes and
// operations are negligible (~4 KB read and ~4,000 simple operations a
// step), so what counts is the time of one step. The design:
//   - one block of 256 threads per problem; the problems of a call run side
//     by side on their own SMs;
//   - each thread owns the columns tid, tid + 256, ... (kCols of them) and
//     keeps their v, minv and used flags in registers for the whole solve;
//     p (column -> row), way and u live in shared memory, where the serial
//     augmenting walk and the row potentials are read;
//   - the problem is transposed once, at the start, so that row i0 of a
//     step is read contiguously: as many rows as fit beside the state go
//     to shared memory (62 of 64 at Q = 900), the rest to a [G, Q] scratch
//     in device memory that the wrapper allocates (L2 keeps it);
//   - the argmin is a register min over a thread's columns in ascending
//     order, a shuffle reduction in each warp, one block barrier, and a
//     shuffle reduction of the warps' results that every warp repeats, so
//     every thread holds j1 and delta without a second barrier (the warps'
//     results alternate between two slots, so that a fast warp's next write
//     cannot meet a slow warp's read).
// The shuffle reductions keep the lower column of two equal values, as
// np.argmin keeps the first. Costs must be finite (`match_cost` replaces NaN
// and infinities), as the host solver assumes.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = 1.0e18f;  // lap_single's _INF
constexpr int kMaxShared = 232448;  // dynamic shared memory a Hopper block can use

// (v, j) <- the lower of (v, j) and (ov, oj): the smaller value, on equal
// values the smaller column.
__device__ __forceinline__ void keep_lower(float& v, int& j, float ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

// The lowest (v, j) over groups of `width` lanes, in every lane of the group.
template <int kWidth>
__device__ __forceinline__ void argmin_lanes(float& v, int& j) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oj = __shfl_xor_sync(0xffffffffu, j, o);
    keep_lower(v, j, ov, oj);
  }
}

// The shared memory of one block: the state, then the rows held there.
__host__ __device__ inline size_t state_bytes(int q, int g) {
  return size_t(q + 1) * 8 + size_t(g + 1) * 4 + 2 * kWarps * 8;
}

template <int kCols>
__global__ void __launch_bounds__(kThreads) lap_kernel(
    const float* __restrict__ cost, float* __restrict__ scratch,
    int64_t* __restrict__ out, int q, int g, int rows_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* p_s = reinterpret_cast<int*>(smem);       // [Q + 1] column -> row
  int* way_s = p_s + (q + 1);                    // [Q + 1]
  float* u_s = reinterpret_cast<float*>(way_s + (q + 1));  // [G + 1]
  float* slot_v = u_s + (g + 1);                 // [2][kWarps]
  int* slot_j = reinterpret_cast<int*>(slot_v + 2 * kWarps);  // [2][kWarps]
  float* rows_s = reinterpret_cast<float*>(slot_j + 2 * kWarps);  // [rows_shared, Q]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t prob = blockIdx.x;
  const float* src = cost + prob * q * g;  // [Q, G]
  float* rows_g = scratch + prob * g * q;  // [G, Q]

  // transpose: element (column c, row r) of [Q, G] to row r, column c
  for (int e = tid; e < q * g; e += kThreads) {
    const int c = e / g, r = e - c * g;
    const float x = src[e];
    if (r < rows_shared)
      rows_s[r * q + c] = x;
    else
      rows_g[int64_t(r) * q + c] = x;
  }
  for (int j = tid; j <= q; j += kThreads) p_s[j] = 0;
  for (int i = tid; i <= g; i += kThreads) u_s[i] = 0.f;
  float v[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = 0.f;

  int parity = 0;
  for (int i = 1; i <= g; ++i) {
    if (tid == 0) p_s[0] = i;
    for (int j = tid; j <= q; j += kThreads) way_s[j] = 0;
    __syncthreads();  // the transpose, the previous walk, p[0] and way
    float minv[kCols];
    int row_of[kCols];  // p of the thread's columns (they change only in the walk)
    unsigned used = 0;  // bit k: column tid + k * kThreads
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int j = tid + k * kThreads;
      minv[k] = kMasked;
      row_of[k] = j <= q ? p_s[j] : 0;
    }
    int j0 = 0, i0 = i;
    while (true) {
      if (j0 % kThreads == tid) used |= 1u << (j0 / kThreads);
      const float ui0 = u_s[i0];
      const float* row = i0 - 1 < rows_shared
                             ? rows_s + (i0 - 1) * q
                             : rows_g + int64_t(i0 - 1) * q;
      float best = INFINITY;
      int best_j = INT_MAX;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = tid + k * kThreads;
        if (j <= q) {
          float masked = kMasked;
          if (!(used >> k & 1u)) {  // column 0 is used from the start
            const float cur = (row[j - 1] - ui0) - v[k];
            if (cur < minv[k]) {
              minv[k] = cur;
              way_s[j] = j0;
            }
            masked = minv[k];
          }
          if (masked < best) {  // ascending columns: the first of equals stays
            best = masked;
            best_j = j;
          }
        }
      }
      argmin_lanes<32>(best, best_j);
      if (lane == 0) {
        slot_v[parity * kWarps + warp] = best;
        slot_j[parity * kWarps + warp] = best_j;
      }
      __syncthreads();
      float delta = lane < kWarps ? slot_v[parity * kWarps + lane] : INFINITY;
      int j1 = lane < kWarps ? slot_j[parity * kWarps + lane] : INT_MAX;
      argmin_lanes<kWarps>(delta, j1);
      delta = __shfl_sync(0xffffffffu, delta, 0);
      j1 = __shfl_sync(0xffffffffu, j1, 0);
      parity ^= 1;
      // the used columns' rows are distinct and exclude p[j1], the row the
      // next step reads: no thread writes a u that another reads
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (tid + k * kThreads <= q) {
          if (used >> k & 1u) {
            u_s[row_of[k]] += delta;
            v[k] -= delta;
          } else {
            minv[k] -= delta;
          }
        }
      }
      j0 = j1;
      i0 = p_s[j0];
      if (i0 == 0) break;
    }
    if (tid == 0) {  // the augmenting walk (way was written before the last barrier)
      while (j0 != 0) {
        const int j1 = way_s[j0];
        p_s[j0] = p_s[j1];
        j0 = j1;
      }
    }
    __syncthreads();  // the walk before the next phase resets way
  }
  for (int j = tid + 1; j <= q; j += kThreads) {
    const int r = p_s[j];
    if (r > 0) out[prob * g + r - 1] = j - 1;
  }
}

template <int kCols>
int launch(const float* cost, float* scratch, int64_t* out, int problems,
           int q, int g, cudaStream_t stream) {
  const size_t state = state_bytes(q, g);
  const size_t room = (kMaxShared - state) / (size_t(q) * 4);
  const int rows_shared = room < size_t(g) ? int(room) : g;
  const int smem = int(state + size_t(rows_shared) * q * 4);
  static int allowed = 48 * 1024;  // per instantiation: raised once, kept
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = kMaxShared;
  }
  lap_kernel<kCols><<<problems, kThreads, smem, stream>>>(cost, scratch, out,
                                                          q, g, rows_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost [problems, q, g] float32, scratch [problems, g, q] float32, out
// [problems, g] int64: the matched column (query) of each row (GT), for
// 1 <= g <= q and q + 1 <= 32 * 256 columns (the register state).
extern "C" int racformer_lap_assign(const void* cost, void* scratch, void* out,
                                    int problems, int q, int g, void* stream) {
  if (problems < 1 || g < 1 || g > q || q + 1 > 32 * kThreads ||
      state_bytes(q, g) > size_t(kMaxShared))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const float*>(cost);
  auto* s = static_cast<float*>(scratch);
  auto* o = static_cast<int64_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = (q + kThreads) / kThreads;  // ceil((q + 1) / kThreads)
  if (cols <= 1) return launch<1>(c, s, o, problems, q, g, st);
  if (cols <= 2) return launch<2>(c, s, o, problems, q, g, st);
  if (cols <= 4) return launch<4>(c, s, o, problems, q, g, st);
  if (cols <= 8) return launch<8>(c, s, o, problems, q, g, st);
  if (cols <= 16) return launch<16>(c, s, o, problems, q, g, st);
  return launch<32>(c, s, o, problems, q, g, st);
}
