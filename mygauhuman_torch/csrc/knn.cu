// Kernel A: exact-f32 brute-force k nearest neighbours over a small
// reference set (k <= 3, R <= 16,384, 3-D points).
//
// Replaces: mygauhuman_tpu/ops/pallas_knn.py::_knn_kernel (entry
// knn_small_refs). Same function: d2 = max(|q|^2 + |r|^2 - 2 (qx rx + qy ry
// + qz rz), 0) + penalty (0 valid, 3e38 masked), the self match set to 3e38
// when exclude_self, and the k smallest (d2, index) pairs in ascending
// order with ties going to the lower index (the k argmin passes of the
// TPU kernel).
//
// Bound: operations. About 11 fp32 operations per (query, ref) pair on the
// CUDA cores (cross term 5, norm sum, doubling, subtraction, clamp, penalty,
// compare): 0.52 GFLOP at 6,912 x 6,890, ~8 us at 67 TFLOP/s; the bytes
// (12 B per point, 8 B per output) are negligible. No tensor cores: the
// K = 3 contraction gains nothing from them and TF32 would mis-pick
// neighbours.
//
// Design: the card has to be filled with warps that each issue many
// independent pairs.
//   - Refs are split into S = 32 slices, and the 32 lanes of a warp (one
//     query group) each scan one slice (slice s takes every S-th ref of a
//     staged tile, so the lanes read neighbouring float4s). A block of 128
//     threads is 4 query groups: 432 blocks of 4 warps at Q = 6,912 (13.1
//     warps per SM on 132 SMs), 1,024 at Q = 16,384 (31.0 warps per SM).
//     With half the warps (16 slices) the scan stalled on latency.
//   - Each thread holds QB = 4 queries in registers, so every staged ref
//     serves 4 pairs. Refs are staged through shared memory in tiles of
//     TILE = 2,048 points as float4 {x, y, z, |r|^2} plus the penalty (when
//     masked): one 128-bit load per ref for 4 pairs, and 4 barriers for the
//     6,890 SMPL vertices. k = 1 selects without a branch.
//   - Each (thread, query) keeps a running top-k of its slice by strict `<`
//     insertion, which keeps equal distances in index order. The S partial
//     lists of a query are then merged by a butterfly of shuffles over the
//     group's lanes in the lexicographic order of (d2, index). That order
//     is total and the slices are disjoint, so the merge gives exactly the
//     k smallest pairs of a single scan, ties to the lower index included,
//     whatever the order of the merge steps.
// The file is compiled with -fmad=false and keeps the plain version's
// operation order (|q|^2 + |r|^2 - 2 cross, clamp, then + penalty), so every
// distance rounds as the plain PyTorch version's separate multiplies and
// adds do: the kernel is bit-equal to it. Without a mask the penalty is 0,
// and adding +0 to the clamped distance (never -0) changes no bit, so that
// case skips it.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float BIG = 3e38f;
constexpr int S = 32;                    // ref slices: the lanes of a query group
constexpr int QB = 4;                    // queries per thread
constexpr int THREADS = 128;             // 4 query groups
constexpr int QPB = THREADS / S * QB;    // 16 queries per block
constexpr int TILE = 2048;               // refs staged per round (a multiple of S)
constexpr unsigned FULL = 0xffffffffu;

// (d, i) before (bd, bi) in the lexicographic order of (distance, index)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, i) into a list kept in (distance, index) order; every slot
// index is a compile-time constant, so the list stays in registers.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
#pragma unroll
  for (int m = K - 1; m >= 0; --m) {
    if (before(d, i, bd[m], bi[m])) {
      if (m > 0 && before(d, i, bd[m - 1], bi[m - 1])) {
        bd[m] = bd[m - 1];
        bi[m] = bi[m - 1];
      } else {
        bd[m] = d;
        bi[m] = i;
      }
    }
  }
}

template <int K, bool EXCLUDE_SELF, bool MASKED>
__global__ void __launch_bounds__(THREADS) knn_kernel(
    const float* __restrict__ q, const float* __restrict__ r,
    const uint8_t* __restrict__ mask, int Q, int R, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  __shared__ float4 s_ref[TILE];   // x, y, z, |r|^2
  __shared__ float s_pen[TILE];
  const int s = threadIdx.x % S;                         // this lane's slice
  const int q0 = blockIdx.x * QPB + threadIdx.x / S * QB;   // its first query
  float qx[QB], qy[QB], qz[QB], qn[QB];
  float bd[QB][K];
  int bi[QB][K];
#pragma unroll
  for (int u = 0; u < QB; ++u) {
    const int qi = q0 + u;
    qx[u] = qi < Q ? q[3 * qi] : 0.f;
    qy[u] = qi < Q ? q[3 * qi + 1] : 0.f;
    qz[u] = qi < Q ? q[3 * qi + 2] : 0.f;
    qn[u] = qx[u] * qx[u] + qy[u] * qy[u] + qz[u] * qz[u];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      bd[u][m] = INFINITY;
      bi[u][m] = 0;
    }
  }

  for (int base = 0; base < R; base += TILE) {
    const int n = min(TILE, R - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float x = r[3 * (base + j)];
      const float y = r[3 * (base + j) + 1];
      const float z = r[3 * (base + j) + 2];
      s_ref[j] = make_float4(x, y, z, x * x + y * y + z * z);
      if (MASKED) s_pen[j] = mask[base + j] ? 0.f : BIG;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = s; j < n; j += S) {
      const float4 rv = s_ref[j];
      const float pen = MASKED ? s_pen[j] : 0.f;
      const int idx = base + j;
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const float cross = qx[u] * rv.x + qy[u] * rv.y + qz[u] * rv.z;
        float d = fmaxf(qn[u] + rv.w - 2.0f * cross, 0.f);
        if (MASKED) d += pen;
        if (EXCLUDE_SELF && idx == q0 + u) d = BIG;
        // the slice is scanned in index order, so strict `<` on the
        // distance alone is the (distance, index) order; k = 1 selects
        // without a branch
        if (K == 1) {
          const bool lt = d < bd[u][0];
          bd[u][0] = lt ? d : bd[u][0];
          bi[u][0] = lt ? idx : bi[u][0];
        } else if (d < bd[u][K - 1]) {
          insert<K>(bd[u], bi[u], d, idx);
        }
      }
    }
  }

  // merge the group's S slice lists: after the butterfly every lane of the
  // group holds the query's k smallest pairs
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      float pd[K];
      int pi[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        pd[m] = __shfl_xor_sync(FULL, bd[u][m], off);
        pi[m] = __shfl_xor_sync(FULL, bi[u][m], off);
      }
#pragma unroll
      for (int m = 0; m < K; ++m) insert<K>(bd[u], bi[u], pd[m], pi[m]);
    }
  }
  // Fewer than k refs below BIG (masked, excluded or missing refs): the
  // plain version's argmin passes, which set each pick to BIG, then return
  // (BIG, the lowest index holding BIG) in every later slot: the lowest of
  // the picks so far and of the refs at exactly BIG.
#pragma unroll
  for (int u = 0; u < QB; ++u) {
    int v = 1;   // slots kept: those below BIG, and always the first
#pragma unroll
    for (int m = 1; m < K; ++m) v += bd[u][m] < BIG;
    int lo = bi[u][0];
#pragma unroll
    for (int m = 1; m < K; ++m) {
      if (m < v || (m == v && bd[u][m] == BIG)) lo = min(lo, bi[u][m]);
    }
#pragma unroll
    for (int m = 1; m < K; ++m) {
      if (m >= v) {
        bd[u][m] = BIG;
        bi[u][m] = lo;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QB; ++u) {
    const int qi = q0 + u;
    if (s == u && qi < Q) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        out_d[qi * K + m] = bd[u][m];
        out_i[qi * K + m] = bi[u][m];
      }
    }
  }
}

template <int K, bool EXCLUDE_SELF>
void launch_masked(const float* q, const float* r, const uint8_t* mask, int Q, int R,
                   float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((Q + QPB - 1) / QPB);
  if (mask != nullptr) {
    knn_kernel<K, EXCLUDE_SELF, true><<<grid, THREADS, 0, stream>>>(q, r, mask, Q, R,
                                                                     out_d, out_i);
  } else {
    knn_kernel<K, EXCLUDE_SELF, false><<<grid, THREADS, 0, stream>>>(q, r, mask, Q, R,
                                                                      out_d, out_i);
  }
}

template <int K>
void launch(const float* q, const float* r, const uint8_t* mask, int Q, int R,
            int exclude_self, float* out_d, int* out_i, cudaStream_t stream) {
  if (exclude_self) {
    launch_masked<K, true>(q, r, mask, Q, R, out_d, out_i, stream);
  } else {
    launch_masked<K, false>(q, r, mask, Q, R, out_d, out_i, stream);
  }
}

}  // namespace

extern "C" int knn_small_refs(const float* q, const float* r,
                              const uint8_t* mask, int Q, int R, int k,
                              int exclude_self, float* out_d, int* out_i,
                              cudaStream_t stream) {
  switch (k) {
    case 1:
      launch<1>(q, r, mask, Q, R, exclude_self, out_d, out_i, stream);
      break;
    case 2:
      launch<2>(q, r, mask, Q, R, exclude_self, out_d, out_i, stream);
      break;
    case 3:
      launch<3>(q, r, mask, Q, R, exclude_self, out_d, out_i, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
