// Kernel D: backward of the forward alpha blend (kernel C), per-instance
// gradient rows.
//
// Replaces the blend backward kernel of the TPU package:
//   mygauhuman_tpu/ops/pallas_blend_bwd.py::_blend_bwd_kernel (entries
//     blend_tiles_bwd_raw / blend_pallas_bwd_raw).
//
// Input: the forward's instance matrix data [D, ns] (rows x, y, conic
// xx/xy/yy, opacity, depth, ones, then Cf = D - 8 feature rows), each tile's
// contiguous slice [starts[t], starts[t] + counts[t]) in front-to-back order,
// and the tile-major cotangents cot [T, P, Cf + 3] (colour, then sum w, sum w
// depth, final T). Output: one gradient row per instance, grads [ns, D]:
//   0 d_x | 1 d_y | 2 d_cxx | 3 d_cxy | 4 d_cyy | 5 d_op | 6 d_depth | 7 0
//   | 8.. d_feat
// Rows of instances no pixel includes stay as the caller zeroed them.
//
// Math (the TPU kernel's): alpha = min(0.99, op exp(power)); an instance is
// valid iff power <= 0 and alpha >= 1/255; it is included while the full
// transmittance over every valid alpha stays >= 1e-4, so a pixel's included
// instances are the valid ones before its first failing instance (`stop`).
// With q_i = f_i . g_color + g_alpha + depth_i g_depth and
// S_i = sum_{j > i, included} w_j q_j,
//   dL/dalpha_i = T_i q_i - (S_i + T_final g_T) / max(1 - alpha_i, 1e-6),
// chained through the clamp only where op exp(power) < 0.99.
//
// Design: one block per tile, one thread per pixel, so one block owns every
// gradient row of its tile's slice and no two blocks write the same row.
//   pass 1, front to back: T, the pixel's `stop` and T_final (as kernel C);
//     the block's extent is the largest `stop` of its pixels.
//   pass 2, back to front (the reference backward.cu's replay): T_i by
//     dividing T back, T_i = T_{i+1} / (1 - alpha_i) from T_final, and S_i
//     accumulated exactly as a running suffix (no prefix subtraction, so no
//     cancellation), then each instance's 7 + Cf components summed over the
//     tile's pixels: butterfly warp shuffles, then the warps' partials in
//     warp order from shared memory. Every sum runs in a fixed order and there
//     are no atomics, so the rows are the same bits on every run.
// Instances are staged through shared memory in batches of B columns.
//
// Bound: bytes, at the training bench point (512^2, 19 channels): the
// [T, P, Cf + 3] cotangent (about 28 MB at Cf = 24) dominates the instance
// rows read and the [ns, D] rows written. The warp reductions (7 + Cf
// shuffle trees per instance and warp that includes it) are what the kernel
// spends its time on; a warp in which no pixel includes an instance skips its
// trees.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr int HDR = 8;              // rows before the features
constexpr int MAX_K = 7 + MAX_C;    // reduced components per instance
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void blend_bwd_kernel(const float* __restrict__ data, int ns,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ counts, int tile_base,
                                 int tiles_x, int Cf, int tile_w, int tile_h,
                                 const float* __restrict__ cot, int B,
                                 float* __restrict__ grads) {
  extern __shared__ float sm[];
  __shared__ int s_max[32];
  const int P = tile_w * tile_h;
  const int nwarps = P / 32;
  const int K = 7 + Cf;
  const int D = HDR + Cf;
  float* s_inst = sm;           // [7 + Cf][B]: x y cxx cxy cyy op depth feat..
  float* s_part = sm + K * B;   // [nwarps][K][B] per-warp partial sums

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[t];
  const int count = counts[t];
  if (count <= 0) return;
  const int tg = tile_base + t;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + tid % tile_w);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + tid / tile_w);

  const float* c = cot + (static_cast<long long>(t) * P + tid) * (Cf + 3);
  float gc[MAX_C];
#pragma unroll
  for (int k = 0; k < MAX_C; ++k) gc[k] = k < Cf ? c[k] : 0.f;
  const float g_alpha = c[Cf];
  const float g_depth = c[Cf + 1];
  const float g_t = c[Cf + 2];

  // ---- pass 1: front to back, T_final and the first failing instance
  float T = 1.f;
  int stop = count;
  bool done = false;
  for (int b0 = 0; b0 < count; b0 += B) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done ? 1 : 0) == P) break;
    for (int j = tid; j < 6 * B; j += P) {
      const int r = j / B, i = j % B;
      if (b0 + i < count) {
        s_inst[r * B + i] = data[static_cast<long long>(r) * ns + start + b0 + i];
      }
    }
    __syncthreads();
    const int n = min(B, count - b0);
    for (int i = 0; i < n && !done; ++i) {
      const float dx = s_inst[i] - px;
      const float dy = s_inst[B + i] - py;
      const float power = -0.5f * (s_inst[2 * B + i] * dx * dx + s_inst[4 * B + i] * dy * dy) -
                          s_inst[3 * B + i] * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(0.99f, s_inst[5 * B + i] * expf(power));
      if (alpha < 1.f / 255.f) continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < 1e-4f) {
        done = true;
        stop = b0 + i;
        break;
      }
      T = test_t;
    }
  }
  const float t_final = T;
  const float tail = t_final * g_t;

  // the block's extent: rows past every pixel's stop stay zero
  const int wmax = __reduce_max_sync(FULL, stop);
  if (lane == 0) s_max[warp] = wmax;
  __syncthreads();
  int n_stop = 0;
  for (int w = 0; w < nwarps; ++w) n_stop = max(n_stop, s_max[w]);

  // ---- pass 2: back to front
  float t_cur = t_final;
  float S = 0.f;
  for (int hi = n_stop; hi > 0; hi -= B) {
    const int lo = max(hi - B, 0);
    const int nb = hi - lo;
    __syncthreads();   // the previous batch's reads are done
    for (int j = tid; j < K * B; j += P) {
      const int r = j / B, i = j % B;
      if (i < nb) {
        const int row = r < 7 ? r : r + 1;   // skip the ones row
        s_inst[r * B + i] = data[static_cast<long long>(row) * ns + start + lo + i];
      }
    }
    __syncthreads();
    for (int i = hi - 1; i >= lo; --i) {
      const int bi = i - lo;
      float v[MAX_K];
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) v[k] = 0.f;
      bool incl = false;
      if (i < stop) {
        const float dx = s_inst[bi] - px;
        const float dy = s_inst[B + bi] - py;
        const float cxx = s_inst[2 * B + bi];
        const float cxy = s_inst[3 * B + bi];
        const float cyy = s_inst[4 * B + bi];
        const float op = s_inst[5 * B + bi];
        const float power = -0.5f * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy;
        if (power <= 0.f) {
          const float e_p = expf(power);
          const float raw = op * e_p;
          const float alpha = fminf(0.99f, raw);
          if (alpha >= 1.f / 255.f) {
            incl = true;
            const float one_m = 1.f - alpha;
            const float t_before = t_cur / one_m;
            const float w = alpha * t_before;
            float q = g_alpha + s_inst[6 * B + bi] * g_depth;
#pragma unroll
            for (int k = 0; k < MAX_C; ++k) {
              if (k < Cf) q += s_inst[(7 + k) * B + bi] * gc[k];
            }
            const float d_a = t_before * q - (S + tail) / fmaxf(one_m, 1e-6f);
            S += w * q;
            t_cur = t_before;
            v[6] = w * g_depth;
#pragma unroll
            for (int k = 0; k < MAX_C; ++k) v[7 + k] = w * gc[k];
            if (raw < 0.99f) {
              const float d_power = d_a * op * e_p;
              v[0] = d_power * (-(cxx * dx + cxy * dy));
              v[1] = d_power * (-(cyy * dy + cxy * dx));
              v[2] = d_power * (-0.5f * dx * dx);
              v[3] = d_power * (-dx * dy);
              v[4] = d_power * (-0.5f * dy * dy);
              v[5] = d_a * e_p;
            }
          }
        }
      }
      float* part = s_part + warp * K * B + bi;
      if (__any_sync(FULL, incl)) {
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          if (k < K) {
            const float s = warp_sum(v[k]);
            if (lane == 0) part[k * B] = s;
          }
        }
      } else if (lane == 0) {
        for (int k = 0; k < K; ++k) part[k * B] = 0.f;
      }
    }
    __syncthreads();
    // the tile's rows lo .. hi - 1: sum the warps' partials in warp order
    for (int j = tid; j < nb * D; j += P) {
      const int bi = j / D, g = j % D;
      const int k = g < 7 ? g : (g == 7 ? -1 : g - 1);
      float s = 0.f;
      if (k >= 0) {
        for (int w = 0; w < nwarps; ++w) s += s_part[(w * K + k) * B + bi];
      }
      grads[static_cast<long long>(start + lo + bi) * D + g] = s;
    }
  }
}

}  // namespace

extern "C" int blend_bwd(const float* data, int ns, const int* starts,
                         const int* counts, int n_tiles, int tile_base,
                         int tiles_x, int Cf, int tile_w, int tile_h,
                         const float* cot, int batch, float* grads,
                         cudaStream_t stream) {
  const int P = tile_w * tile_h;
  if (Cf < 1 || Cf > MAX_C || P > 1024 || P % 32 != 0 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    const int K = 7 + Cf;
    const size_t smem = static_cast<size_t>(K) * batch * (1 + P / 32) * sizeof(float);
    if (smem + 32 * sizeof(int) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    blend_bwd_kernel<<<n_tiles, P, smem, stream>>>(
        data, ns, starts, counts, tile_base, tiles_x, Cf, tile_w, tile_h, cot,
        batch, grads);
  }
  return static_cast<int>(cudaGetLastError());
}
