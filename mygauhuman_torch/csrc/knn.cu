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
// Design: one query per thread, its running top-k in registers. The refs
// are staged through shared memory in tiles of TILE points (x, y, z, |r|^2,
// penalty), so every thread of a block reads the same ref at the same time
// (a shared-memory broadcast). Strict `<` insertion keeps equal distances
// in index order, which is the first-occurrence tie-break. The file is
// compiled with -fmad=false so the sums round exactly as the plain PyTorch
// version's separate multiplies and adds do.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float BIG = 3e38f;
constexpr int TILE = 1024;
constexpr int THREADS = 64;

template <int K>
__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ r,
                           const uint8_t* __restrict__ mask,
                           int Q, int R, int exclude_self,
                           float* __restrict__ out_d,
                           int* __restrict__ out_i) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sn[TILE], sp[TILE];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  const float qn = qx * qx + qy * qy + qz * qz;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    bd[m] = INFINITY;
    bi[m] = 0;
  }

  for (int base = 0; base < R; base += TILE) {
    const int n = min(TILE, R - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float x = r[3 * (base + j)];
      const float y = r[3 * (base + j) + 1];
      const float z = r[3 * (base + j) + 2];
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      sn[j] = x * x + y * y + z * z;
      sp[j] = (mask == nullptr || mask[base + j]) ? 0.f : BIG;
    }
    __syncthreads();
    if (qi >= Q) continue;
    for (int j = 0; j < n; ++j) {
      const float cross = qx * sx[j] + qy * sy[j] + qz * sz[j];
      float d = fmaxf(qn + sn[j] - 2.0f * cross, 0.f) + sp[j];
      if (exclude_self && base + j == qi) d = BIG;
      if (d < bd[K - 1]) {
        // insert (d, index) keeping (distance, index) order; every slot
        // index is a compile-time constant, so bd/bi stay in registers
#pragma unroll
        for (int m = K - 1; m >= 0; --m) {
          if (d < bd[m]) {
            if (m > 0 && d < bd[m - 1]) {
              bd[m] = bd[m - 1];
              bi[m] = bi[m - 1];
            } else {
              bd[m] = d;
              bi[m] = base + j;
            }
          }
        }
      }
    }
  }
  if (qi < Q) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      out_d[qi * K + m] = bd[m];
      out_i[qi * K + m] = bi[m];
    }
  }
}

}  // namespace

extern "C" int knn_small_refs(const float* q, const float* r,
                              const uint8_t* mask, int Q, int R, int k,
                              int exclude_self, float* out_d, int* out_i,
                              cudaStream_t stream) {
  const dim3 grid((Q + THREADS - 1) / THREADS);
  switch (k) {
    case 1:
      knn_kernel<1><<<grid, THREADS, 0, stream>>>(q, r, mask, Q, R,
                                                  exclude_self, out_d, out_i);
      break;
    case 2:
      knn_kernel<2><<<grid, THREADS, 0, stream>>>(q, r, mask, Q, R,
                                                  exclude_self, out_d, out_i);
      break;
    case 3:
      knn_kernel<3><<<grid, THREADS, 0, stream>>>(q, r, mask, Q, R,
                                                  exclude_self, out_d, out_i);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
