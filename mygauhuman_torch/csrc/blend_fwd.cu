// Kernel C: forward alpha blend of depth-sorted per-tile instance lists.
//
// Replaces both forward blend kernels of the TPU package:
//   mygauhuman_tpu/ops/pallas_blend.py::_blend_row_kernel (entry
//     blend_rows_raw, planar [C+3, H, W] output) and
//   mygauhuman_tpu/ops/pallas_blend.py::_blend_kernel (entry
//     blend_tiles_raw, tile-major [T, C+3, P] output),
// selected here by the `planar` flag, with `tile_base` offsetting local
// tile ids into a global tile grid for the pixel coordinates.
//
// Input: the instance matrix data [D, ns] (rows x, y, conic xx/xy/yy,
// opacity, depth, ones, then the features), each tile's contiguous slice
// [starts[t], starts[t] + counts[t]) in front-to-back order. Per pixel:
// alpha = min(0.99, op exp(power)); an instance is skipped if power > 0 or
// alpha < 1/255; it is included while T (1 - alpha) >= 1e-4, with weight
// w = alpha T. A pixel stops at the first instance that fails that test
// (the sticky `done` of the CUDA reference's renderCUDA): T is the product
// over every valid alpha so far, and the final T counts only included
// instances, as the spec (ops/blend.py) does with its full cumprod. Output
// rows: C colours, sum w, sum w depth, final T; the background is added by
// the caller (finish_planar / finish_tiles).
//
// Bound: bytes. The (C + 3) H W fp32 output dominates (about 23 MB for 19
// channels at 512^2), plus the 7 + C rows of each instance some pixel
// evaluates; the operations (about 20 fp32 per (pixel, instance) pair
// evaluated, plus 2 (C + 2) per included pair) come to about 0.06 GFLOP
// per 512^2 frame of the synthetic serving scene.
//
// Design: one block per tile, one thread per pixel (tile_w x tile_h <= 1024
// threads). Instances are staged through shared memory one batch of P at a
// time (each thread loads one instance's columns, coalesced along ns), and
// the block leaves the loop once every pixel is done (__syncthreads_count).
// Accumulation is fp32 in registers.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr int HDR = 8;  // rows before the features in the instance matrix

__global__ void blend_fwd_kernel(const float* __restrict__ data, int ns,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ counts, int tile_base,
                                 int tiles_x, int C, int tile_w, int tile_h,
                                 int planar, int out_h, int out_w,
                                 float* __restrict__ out) {
  extern __shared__ float sm[];
  const int P = tile_w * tile_h;
  float* s_x = sm;
  float* s_y = sm + P;
  float* s_cxx = sm + 2 * P;
  float* s_cxy = sm + 3 * P;
  float* s_cyy = sm + 4 * P;
  float* s_op = sm + 5 * P;
  float* s_dep = sm + 6 * P;
  float* s_feat = sm + 7 * P;  // [C][P]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[t];
  const int count = counts[t];
  const int tg = tile_base + t;
  const int lx = tid % tile_w;
  const int ly = tid / tile_w;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + lx);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + ly);

  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;
  float w_sum = 0.f, d_sum = 0.f, T = 1.f;
  bool done = false;

  for (int b0 = 0; b0 < count; b0 += P) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done ? 1 : 0) == P) break;
    const int j = b0 + tid;
    if (j < count) {
      const long long col = static_cast<long long>(start) + j;
      s_x[tid] = data[col];
      s_y[tid] = data[ns + col];
      s_cxx[tid] = data[2LL * ns + col];
      s_cxy[tid] = data[3LL * ns + col];
      s_cyy[tid] = data[4LL * ns + col];
      s_op[tid] = data[5LL * ns + col];
      s_dep[tid] = data[6LL * ns + col];
      for (int c = 0; c < C; ++c) {
        s_feat[c * P + tid] = data[static_cast<long long>(HDR + c) * ns + col];
      }
    }
    __syncthreads();
    const int n = min(P, count - b0);
    for (int i = 0; i < n && !done; ++i) {
      const float dx = s_x[i] - px;
      const float dy = s_y[i] - py;
      const float power =
          -0.5f * (s_cxx[i] * dx * dx + s_cyy[i] * dy * dy) - s_cxy[i] * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(0.99f, s_op[i] * expf(power));
      if (alpha < 1.f / 255.f) continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < 1e-4f) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) acc[c] += w * s_feat[c * P + i];
      }
      w_sum += w;
      d_sum += w * s_dep[i];
      T = test_t;
    }
  }

  // rows: C colours, w_sum, d_sum, final_t
  const int rows = C + 3;
  if (planar) {
    const int y = (t / tiles_x) * tile_h + ly;
    const int x = (t % tiles_x) * tile_w + lx;
    const long long plane = static_cast<long long>(out_h) * out_w;
    float* o = out + static_cast<long long>(y) * out_w + x;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) o[c * plane] = acc[c];
    }
    o[C * plane] = w_sum;
    o[(C + 1) * plane] = d_sum;
    o[(C + 2) * plane] = T;
  } else {
    float* o = out + static_cast<long long>(t) * rows * P + tid;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) o[c * P] = acc[c];
    }
    o[C * P] = w_sum;
    o[(C + 1) * P] = d_sum;
    o[(C + 2) * P] = T;
  }
}

}  // namespace

extern "C" int blend_fwd(const float* data, int ns, const int* starts,
                         const int* counts, int n_tiles, int tile_base,
                         int tiles_x, int C, int tile_w, int tile_h,
                         int planar, int out_h, int out_w, float* out,
                         cudaStream_t stream) {
  if (C < 1 || C > MAX_C || tile_w * tile_h > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    const int P = tile_w * tile_h;
    const size_t smem = static_cast<size_t>(7 + C) * P * sizeof(float);
    blend_fwd_kernel<<<n_tiles, P, smem, stream>>>(
        data, ns, starts, counts, tile_base, tiles_x, C, tile_w, tile_h,
        planar, out_h, out_w, out);
  }
  return static_cast<int>(cudaGetLastError());
}
