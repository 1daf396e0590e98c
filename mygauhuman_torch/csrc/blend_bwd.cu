// Kernel D: backward of the forward alpha blend (kernel C), per-instance
// gradient rows, in three launches: D1 (T checkpoints), D1s (chunk sums)
// and D2 (rows).
//
// Replaces the blend backward kernel of the TPU package:
//   mygauhuman_tpu/ops/pallas_blend_bwd.py:51 _blend_bwd_kernel, reached
//   through blend_tiles_bwd_raw (:364) -> pl.pallas_call (:426), and through
//   blend_pallas_bwd_raw, which calls blend_tiles_bwd_raw.
//
// Input: the forward's instance matrix data [D, ns] (rows x, y, conic
// xx/xy/yy, opacity, depth, ones, then Cf = D - 8 feature rows, of which the
// first C carry data), each tile's contiguous slice [starts[t], starts[t] +
// counts[t]) in front-to-back order (the slices are disjoint column ranges
// of [0, ns), as binning makes them), and the tile-major cotangents
// cot [T, P, Cf + 3] (colour, then sum w, sum w depth, final T). Output: one
// gradient row per instance, grads [ns, D]:
//   0 d_x | 1 d_y | 2 d_cxx | 3 d_cxy | 4 d_cyy | 5 d_op | 6 d_depth | 7 0
//   | 8.. d_feat (the Cf - C pad rows 0)
// Rows of instances no pixel includes stay as the caller zeroed them.
//
// Math (the TPU kernel's): alpha = min(0.99, op exp(power)); an instance is
// valid iff power <= 0 and alpha >= 1/255 (built with -fmad=false, as kernel
// C is: both round power, so alpha, as the plain version); it is included while the full
// transmittance over every valid alpha stays >= 1e-4, so a pixel's included
// instances are the valid ones before its first failing instance (`stop`).
// With q_i = f_i . g_color + g_alpha + depth_i g_depth and
// S_i = sum_{j > i, included} w_j q_j,
//   dL/dalpha_i = T_i q_i - (S_i + T_final g_T) / max(1 - alpha_i, 1e-6),
// chained through the clamp only where op exp(power) < 0.99.
//
// Bound: operations, at the training bench point (512^2, C = 19, 117 of
// 1,024 tiles holding instances): ~0.36 GFLOP (both passes evaluate the
// pairs before each pixel stops, the included pairs add the gradient
// arithmetic) against ~8 MB moved, 0.0054 ms at 67 TFLOP/s fp32. The work
// is small; what costs time is getting it spread over the card: a tile's
// list is a serial chain in T and S, and a few tiles hold ~1,000 instances.
//
// Design: each tile's slice is cut into chunks of CH = 32 consecutive
// instances (the last one ragged), and the serial chain is carried across
// chunks by per-pixel checkpoints, so that chunks replay in parallel.
//   D1 (blend_bwd_ckpt), one block per tile, one thread per pixel: kernel
//     C's front-to-back loop without the colours, the same serial product
//     for T in the same order (so its include decisions are kernel C's),
//     writing T before every chunk of its tile (T_final once the pixel has
//     stopped) and per pixel `stop` and T_final. No reductions. Each block
//     also finds its first chunk slot (the chunks of the tiles before it,
//     summed over counts in the block) and writes the slot -> (tile, chunk)
//     map, so the host never reads counts. One block still walks the
//     longest tile, so D1 keeps only what the chain needs: the colour and
//     w q arithmetic would lengthen every serial step.
//   D1s (blend_bwd_sums), one block per chunk slot, one thread per pixel:
//     from the chunk's T checkpoint forward over its instances before the
//     pixel's stop, the chunk's sum of w q over the included ones.
//   D2 (blend_bwd_rows), one block per chunk slot, one thread per pixel:
//     T at the chunk's end is the next chunk's checkpoint (T_final for the
//     tile's last chunk), S at its end the sum of the tile's later chunk
//     sums taken from the last one down; the block walks its <= 32
//     instances back to front, dividing T back and keeping S as an exact
//     running suffix (as the CUDA reference's backward.cu replay does), so
//     no division or prefix subtraction runs across more than one chunk.
//     Pixels whose stop is at or before the chunk's start skip it, and a
//     block in which every pixel does returns at once. Each instance's
//     7 + C components that carry data are summed over the warp by a
//     reduce-scatter butterfly (31 shuffles for up to 32 components; lane
//     k ends with component k; components 32.. of C > 25 by shuffle trees)
//     into shared memory [warp][CH][7 + C], and the warps' partials are
//     summed in warp order at the chunk's end. A block owns its chunk's
//     rows, so there are no atomics and every sum runs in a fixed order:
//     the rows are the same bits on every run.
// Scratch (the wrapper's torch.empty), compact: G = ceil(ns / CH) +
// n_tiles chunk slots bound the chunks of disjoint slices, so two [G, P]
// fp32 checkpoints, [T, P] stop and T_final and the [G] map: ~6 MB at the
// 512^2 bench point (ns = 32,768, 1,024 tiles of 256 px).
// The grids of D1s and D2 are G blocks; slots past the tiles' chunks return
// at once.
//
// Tensor cores are not used. The feature rows are a [CH x P] . [P x C]
// product (sum_p w_{p,i} g_{p,k}), but the function is a few microseconds
// of fp32 work at its bound, this design's time is parallelism and latency
// (serial chains, one-instance-at-a-time reductions), not arithmetic, and
// the fp32 tolerance (1e-4 of each column's max) would need 3xTF32 splits.
#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;              // instances per chunk
constexpr int MAX_C = 32;
constexpr int HDR = 8;              // rows before the features
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One step of the reduce-scatter butterfly: the lane keeps one half (the
// upper one where `up`) and adds the partner's copy of it.
__device__ __forceinline__ float halve(bool up, float lo, float hi, int off) {
  const float send = up ? lo : hi;
  const float keep = up ? hi : lo;
  return keep + __shfl_xor_sync(FULL, send, off);
}

// ---- D1: checkpoints of T ------------------------------------------------
// The alpha of UNROLL instances is computed before their serial T steps,
// so that the independent math of the next instances overlaps the chain.
constexpr int UNROLL = 4;   // divides CH and the batch (P, whole warps)

__global__ void blend_bwd_ckpt_kernel(
    const float* __restrict__ data, int ns, const int* __restrict__ starts,
    const int* __restrict__ counts, int n_tiles, int tile_base, int tiles_x,
    int tile_w, int tile_h, int max_chunks, float* __restrict__ ck_t,
    int* __restrict__ stop_out, float* __restrict__ t_final,
    int2* __restrict__ chunk_map, int* __restrict__ n_chunks) {
  extern __shared__ float sm[];
  __shared__ int s_red[32];
  const int P = tile_w * tile_h;
  float* s_x = sm;
  float* s_y = sm + P;
  float* s_cxx = sm + 2 * P;
  float* s_cxy = sm + 3 * P;
  float* s_cyy = sm + 4 * P;
  float* s_op = sm + 5 * P;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = max(counts[t], 0);
  const bool last = t == n_tiles - 1;
  if (count == 0 && !last) return;

  // this tile's first chunk slot: the chunks of the tiles before it
  int part = 0;
  for (int j = tid; j < t; j += P) part += (max(counts[j], 0) + CH - 1) / CH;
  part = __reduce_add_sync(FULL, part);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < P / 32; ++w) off += s_red[w];
  const int nch = (count + CH - 1) / CH;
  if (last && tid == 0) *n_chunks = min(off + nch, max_chunks);
  // slots past max_chunks exist only if slices overlap (outside the
  // contract): such a tile marks the slots it reaches as empty and writes
  // nothing else, so its rows stay zero
  const bool fits = off + nch <= max_chunks;
  for (int c = tid; c < nch && off + c < max_chunks; c += P) {
    chunk_map[off + c] = make_int2(fits ? t : -1, c);
  }
  if (count == 0 || !fits) return;

  const int start = starts[t];
  const int tg = tile_base + t;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + tid % tile_w);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + tid / tile_w);
  float* ckt = ck_t + static_cast<long long>(off) * P + tid;   // chunk k at [k * P]

  // kernel C's loop (csrc/blend_fwd.cu) without the colours: the same
  // serial product for T, with a checkpoint at each chunk start
  float T = 1.f;
  int stop = count, ck = 0;   // ck: checkpoints written
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
    }
    __syncthreads();
    const int n = min(P, count - b0);
    for (int i = 0; i < n && !done; i += UNROLL) {
      float al[UNROLL];   // alpha of a valid instance, else 0
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + u;
        al[u] = 0.f;
        if (iu < n) {
          const float dx = s_x[iu] - px;
          const float dy = s_y[iu] - py;
          const float power = -0.5f * (s_cxx[iu] * dx * dx + s_cyy[iu] * dy * dy) -
                              s_cxy[iu] * dx * dy;
          if (power <= 0.f) {
            const float alpha = fminf(0.99f, s_op[iu] * expf(power));
            if (alpha >= 1.f / 255.f) al[u] = alpha;
          }
        }
      }
      if ((b0 + i) % CH == 0) ckt[static_cast<long long>(ck++) * P] = T;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (al[u] > 0.f) {
          const float test_t = T * (1.f - al[u]);
          if (test_t < 1e-4f) {
            done = true;
            stop = b0 + i + u;
            break;
          }
          T = test_t;
        }
      }
    }
  }
  // the chunks after the pixel's stop hold T_final
  for (int k = ck; k < nch; ++k) ckt[static_cast<long long>(k) * P] = T;
  stop_out[static_cast<long long>(t) * P + tid] = stop;
  t_final[static_cast<long long>(t) * P + tid] = T;
}

// ---- D1s: chunk sums ---------------------------------------------------------
// One block per chunk slot, one thread per pixel: from the chunk's T
// checkpoint forward over its instances before the pixel's stop, the sum of
// w q over the included ones.
__global__ void __launch_bounds__(256) blend_bwd_sums_kernel(
    const float* __restrict__ data, int ns, const int* __restrict__ starts,
    const int* __restrict__ counts, int tile_base, int tiles_x, int C, int Cf,
    int tile_w, int tile_h, const float* __restrict__ cot, int max_chunks,
    const float* __restrict__ ck_t, const int* __restrict__ stop_in,
    const int2* __restrict__ chunk_map, const int* __restrict__ n_chunks,
    float* __restrict__ ck_s) {
  extern __shared__ float sm[];   // [7 + C][CH]: x y cxx cxy cyy op depth feat..
  const int P = tile_w * tile_h;
  const int K = 7 + C;
  const int g = blockIdx.x;
  if (g >= min(*n_chunks, max_chunks)) return;
  const int2 tc = chunk_map[g];
  if (tc.x < 0) return;
  const int t = tc.x;
  const int cs = tc.y * CH;
  const int tid = threadIdx.x;
  const int n = min(CH, counts[t] - cs);
  const long long pix = static_cast<long long>(t) * P + tid;
  const int hi = max(0, min(n, stop_in[pix] - cs));   // this pixel's instances
  float* out = ck_s + static_cast<long long>(g) * P + tid;
  if (!__syncthreads_or(hi > 0)) {   // no pixel reaches the chunk
    *out = 0.f;
    return;
  }
  const long long col0 = static_cast<long long>(starts[t]) + cs;
  for (int j = tid; j < K * CH; j += P) {
    const int r = j / CH, i = j % CH;
    if (i < n) {
      const int row = r < 7 ? r : r + 1;   // skip the ones row
      sm[j] = data[static_cast<long long>(row) * ns + col0 + i];
    }
  }
  const int tg = tile_base + t;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + tid % tile_w);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + tid / tile_w);
  const float* cp = cot + pix * (Cf + 3);
  float gc[MAX_C];
#pragma unroll
  for (int k = 0; k < MAX_C; ++k) gc[k] = k < C ? cp[k] : 0.f;
  const float g_alpha = cp[Cf];
  const float g_depth = cp[Cf + 1];
  float T = ck_t[static_cast<long long>(g) * P + tid];
  float sum = 0.f;
  __syncthreads();
  for (int i = 0; i < hi; ++i) {
    const float dx = sm[i] - px;
    const float dy = sm[CH + i] - py;
    const float power = -0.5f * (sm[2 * CH + i] * dx * dx + sm[4 * CH + i] * dy * dy) -
                        sm[3 * CH + i] * dx * dy;
    if (power > 0.f) continue;
    const float alpha = fminf(0.99f, sm[5 * CH + i] * expf(power));
    if (alpha < 1.f / 255.f) continue;
    float q = g_alpha + sm[6 * CH + i] * g_depth;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) {
      if (k < C) q += sm[(7 + k) * CH + i] * gc[k];
    }
    sum += alpha * T * q;
    T *= 1.f - alpha;
  }
  *out = sum;
}

// ---- D2: rows --------------------------------------------------------------
// NF: feature components held in registers; 25 while 7 + C <= 32 (one
// butterfly), 32 otherwise (components 32.. by shuffle trees).
template <int NF>
__global__ void __launch_bounds__(256, 3) blend_bwd_rows_kernel(
    const float* __restrict__ data, int ns, const int* __restrict__ starts,
    const int* __restrict__ counts, int tile_base, int tiles_x, int C, int Cf,
    int tile_w, int tile_h, const float* __restrict__ cot, int max_chunks,
    const float* __restrict__ ck_t, const float* __restrict__ ck_s,
    const int* __restrict__ stop_in, const float* __restrict__ t_final,
    const int2* __restrict__ chunk_map, const int* __restrict__ n_chunks,
    float* __restrict__ grads) {
  extern __shared__ float sm[];
  const int P = tile_w * tile_h;
  const int K = 7 + C;          // components that carry data
  const int D = HDR + Cf;
  float* s_inst = sm;           // [K][CH]: x y cxx cxy cyy op depth feat..
  float* s_part = sm + K * CH;  // [P / 32][CH][K] per-warp sums

  const int g = blockIdx.x;
  if (g >= min(*n_chunks, max_chunks)) return;
  const int2 tc = chunk_map[g];
  if (tc.x < 0) return;
  const int t = tc.x;
  const int c = tc.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = counts[t];
  const int cs = c * CH;                        // the chunk's first instance
  const int n = min(CH, count - cs);
  const int nch = (count + CH - 1) / CH;
  const long long pix = static_cast<long long>(t) * P + tid;
  const int stop = stop_in[pix];
  const int hi = max(0, min(n, stop - cs));     // this pixel's instances: i < hi
  if (!__syncthreads_or(hi > 0)) return;        // no pixel reaches the chunk

  const long long col0 = static_cast<long long>(starts[t]) + cs;
  for (int j = tid; j < K * CH; j += P) {
    const int r = j / CH, i = j % CH;
    if (i < n) {
      const int row = r < 7 ? r : r + 1;   // skip the ones row
      s_inst[j] = data[static_cast<long long>(row) * ns + col0 + i];
    }
  }

  const int tg = tile_base + t;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + tid % tile_w);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + tid / tile_w);
  const float* cp = cot + pix * (Cf + 3);
  float gc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) gc[k] = k < C ? cp[k] : 0.f;
  const float g_alpha = cp[Cf];
  const float g_depth = cp[Cf + 1];
  const float tf = t_final[pix];
  const float tail = tf * cp[Cf + 2];
  // T after the chunk, and S after it: the tile's later chunk sums, from
  // the last one down
  const float* cks = ck_s + static_cast<long long>(g - c) * P + tid;
  float t_cur = c + 1 < nch ? ck_t[static_cast<long long>(g + 1) * P + tid] : tf;
  float S = 0.f;
  for (int k = nch - 1; k > c; --k) S += cks[static_cast<long long>(k) * P];

  float* part = s_part + warp * CH * K;
  const int hw = __reduce_max_sync(FULL, hi);   // no lane reaches i >= hw
  for (int i = hw; i < n; ++i) {
    for (int k = lane; k < K; k += 32) part[i * K + k] = 0.f;
  }
  __syncthreads();   // s_inst staged

  for (int i = hw - 1; i >= 0; --i) {
    float w = 0.f;
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bool incl = false;
    if (i < hi) {
      const float dx = s_inst[i] - px;
      const float dy = s_inst[CH + i] - py;
      const float cxx = s_inst[2 * CH + i];
      const float cxy = s_inst[3 * CH + i];
      const float cyy = s_inst[4 * CH + i];
      const float op = s_inst[5 * CH + i];
      const float power = -0.5f * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy;
      if (power <= 0.f) {
        const float e_p = expf(power);
        const float raw = op * e_p;
        const float alpha = fminf(0.99f, raw);
        if (alpha >= 1.f / 255.f) {
          incl = true;
          const float one_m = 1.f - alpha;
          const float t_before = t_cur / one_m;
          w = alpha * t_before;
          float q = g_alpha + s_inst[6 * CH + i] * g_depth;
#pragma unroll
          for (int k = 0; k < NF; ++k) {
            if (k < C) q += s_inst[(7 + k) * CH + i] * gc[k];
          }
          const float d_a = t_before * q - (S + tail) / fmaxf(one_m, 1e-6f);
          S += w * q;
          t_cur = t_before;
          if (raw < 0.99f) {
            const float d_power = d_a * op * e_p;
            h[0] = d_power * (-(cxx * dx + cxy * dy));
            h[1] = d_power * (-(cyy * dy + cxy * dx));
            h[2] = d_power * (-0.5f * dx * dx);
            h[3] = d_power * (-dx * dy);
            h[4] = d_power * (-0.5f * dy * dy);
            h[5] = d_a * e_p;
          }
        }
      }
    }
    float* row = part + i * K;
    if (!__any_sync(FULL, incl)) {
      for (int k = lane; k < K; k += 32) row[k] = 0.f;
      continue;
    }
    // component k of this lane: 0..5 header, 6 depth, 7.. features
    auto comp = [&](int k) -> float {
      if (k < 6) return h[k];
      if (k == 6) return w * g_depth;
      return k - 7 < NF ? w * gc[k - 7] : 0.f;
    };
    float a[16], b[8], e[4], f[2];
    const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = halve(u16, comp(k), comp(k + 16), 16);
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = halve(u8, a[k], a[k + 8], 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = halve(u4, b[k], b[k + 4], 4);
#pragma unroll
    for (int k = 0; k < 2; ++k) f[k] = halve(u2, e[k], e[k + 2], 2);
    const float mine = halve(lane & 1, f[0], f[1], 1);   // component `lane`
    if (lane < K) row[lane] = mine;
    if (NF > 25) {
#pragma unroll
      for (int k = 32; k < 7 + NF; ++k) {
        if (k < K) {
          const float s = warp_sum(comp(k));
          if (lane == 0) row[k] = s;
        }
      }
    }
  }
  __syncthreads();

  // the chunk's rows: the warps' partials summed in warp order
  const int nwarps = P / 32;
  for (int j = tid; j < n * D; j += P) {
    const int i = j / D, col = j % D;
    const int k = col < 7 ? col : (col == 7 || col >= HDR + C ? -1 : col - 1);
    float s = 0.f;
    if (k >= 0) {
      for (int w = 0; w < nwarps; ++w) s += s_part[(w * CH + i) * K + k];
    }
    grads[(col0 + i) * D + col] = s;
  }
}

bool bad_shape(int C, int Cf, int P, int max_p) {
  return C < 1 || C > Cf || Cf > MAX_C || P > max_p || P % 32 != 0;
}

}  // namespace

// D1. Scratch: ck_t [max_chunks, P] f32, stop_out [n_tiles, P] i32,
// t_final [n_tiles, P] f32, chunk_map [max_chunks] int2, n_chunks [1] i32.
extern "C" int blend_bwd_ckpt(const float* data, int ns, const int* starts,
                              const int* counts, int n_tiles, int tile_base,
                              int tiles_x, int tile_w, int tile_h,
                              int max_chunks, float* ck_t, int* stop_out,
                              float* t_final, int* chunk_map, int* n_chunks,
                              cudaStream_t stream) {
  const int P = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(6) * P * sizeof(float);
  if (P > 1024 || P % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0) {
    blend_bwd_ckpt_kernel<<<n_tiles, P, smem, stream>>>(
        data, ns, starts, counts, n_tiles, tile_base, tiles_x, tile_w, tile_h,
        max_chunks, ck_t, stop_out, t_final, reinterpret_cast<int2*>(chunk_map),
        n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// D1s: one block per chunk slot of D1's scratch; writes ck_s [max_chunks, P]
// for the slots in use.
extern "C" int blend_bwd_sums(const float* data, int ns, const int* starts,
                              const int* counts, int n_tiles, int tile_base,
                              int tiles_x, int C, int Cf, int tile_w,
                              int tile_h, const float* cot, int max_chunks,
                              const float* ck_t, const int* stop_in,
                              const int* chunk_map, const int* n_chunks,
                              float* ck_s, cudaStream_t stream) {
  const int P = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(7 + C) * CH * sizeof(float);
  if (bad_shape(C, Cf, P, 256)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0 && max_chunks > 0) {
    blend_bwd_sums_kernel<<<max_chunks, P, smem, stream>>>(
        data, ns, starts, counts, tile_base, tiles_x, C, Cf, tile_w, tile_h, cot,
        max_chunks, ck_t, stop_in, reinterpret_cast<const int2*>(chunk_map),
        n_chunks, ck_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// D2: one block per chunk slot of D1's scratch; writes the rows of the
// chunks some pixel reaches.
extern "C" int blend_bwd_rows(const float* data, int ns, const int* starts,
                              const int* counts, int n_tiles, int tile_base,
                              int tiles_x, int C, int Cf, int tile_w,
                              int tile_h, const float* cot, int max_chunks,
                              const float* ck_t, const float* ck_s,
                              const int* stop_in, const float* t_final,
                              const int* chunk_map, const int* n_chunks,
                              float* grads, cudaStream_t stream) {
  const int P = tile_w * tile_h;
  const int K = 7 + C;
  const size_t smem = static_cast<size_t>(K) * CH * (1 + P / 32) * sizeof(float);
  if (bad_shape(C, Cf, P, 256) || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0 && max_chunks > 0) {
    const int2* map = reinterpret_cast<const int2*>(chunk_map);
    if (K <= 32) {
      blend_bwd_rows_kernel<25><<<max_chunks, P, smem, stream>>>(
          data, ns, starts, counts, tile_base, tiles_x, C, Cf, tile_w, tile_h,
          cot, max_chunks, ck_t, ck_s, stop_in, t_final, map, n_chunks, grads);
    } else {
      blend_bwd_rows_kernel<MAX_C><<<max_chunks, P, smem, stream>>>(
          data, ns, starts, counts, tile_base, tiles_x, C, Cf, tile_w, tile_h,
          cot, max_chunks, ck_t, ck_s, stop_in, t_final, map, n_chunks, grads);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
