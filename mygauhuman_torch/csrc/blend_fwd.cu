// Kernel C: forward alpha blend of depth-sorted per-tile instance lists.
//
// Replaces both forward blend kernels of the TPU package:
//   mygauhuman_tpu/ops/pallas_blend.py::_blend_row_kernel (entry
//     blend_rows_raw, planar [C+3, H, W] output) and
//   mygauhuman_tpu/ops/pallas_blend.py::_blend_kernel (entry
//     blend_tiles_raw, tile-major [T, C+3, P] output),
// selected here by the `planar` flag, with `tile_base` offsetting local
// tile ids into a global tile grid for the pixel coordinates. A tile-major
// launch may hold several images of `tiles_per_image` tiles each, one after
// another (the occlusion bake's cube faces): a tile's pixel coordinates are
// those of its index within its image. A launch of one image passes its
// own tile count, so its tiles keep their coordinates.
//
// Input: the instance matrix data [D, ns] (rows x, y, conic xx/xy/yy,
// opacity, depth, ones, then the features), each tile's contiguous slice
// [starts[t], starts[t] + counts[t]) in front-to-back order. Per pixel:
// alpha = min(0.99, op exp(power)); an instance is skipped if power > 0 or
// alpha < 1/255 (built with -fmad=false, so that power rounds as the plain
// version's and an alpha at the 1/255 test falls on the same side); it is
// included while T (1 - alpha) >= 1e-4, with weight
// w = alpha T. A pixel stops at the first instance that fails that test
// (the sticky `done` of the CUDA reference's renderCUDA): T is the product
// over every valid alpha so far, and the final T counts only included
// instances, as the spec (ops/blend.py) does with its full cumprod. Output
// rows: C colours, sum w, sum w depth, final T; the background is added by
// the caller (finish_planar / finish_tiles).
//
// Checkpoint mode (a differentiated forward, t_start != nullptr): the same
// pass also writes what kernel D's backward launches read
// (csrc/blend_bwd.cu, the layout its D1 launch writes): per pixel, T before
// each chunk of CH = 32 instances of its tile (T_final from the pixel's
// stop on) into the compact slots off_t + c, off_t the chunks of the tiles
// before tile t (summed over counts on the device); the pixel's stop (its
// first failing instance, count if none) and T_final; the slot -> (tile,
// chunk) map and the number of slots in use. Same serial product in the
// same order as D1, so the same bits. The chunk sums stay for D1s.
//
// Bound: bytes. The (C + 3) H W fp32 output dominates (about 23 MB for 19
// channels at 512^2), plus the 7 + C rows of each instance some pixel
// evaluates; the operations (about 20 fp32 per (pixel, instance) pair
// evaluated, plus 2 (C + 2) per included pair) come to about 0.06 GFLOP
// per 512^2 frame of the synthetic serving scene.
//
// Design: what sets the time is the longest tile (about 1 in 9 tiles holds
// instances, the longest up to the 1,024-instance cap), whose pixels each
// walk the whole list as one serial chain in T.
//   - Sub-tile blocks: a tile's P pixels are split over ceil(P / 64) blocks
//     of 64 threads (2 warps), one thread per pixel, so that a long tile
//     runs on several SMs at once. The grid is n_tiles x sub-blocks, a
//     function of shapes alone; blocks of empty tiles skip to their output.
//     Each block stages the same instance batches (the bytes are small; L2
//     serves the repeats).
//   - Alpha off the chain: alpha does not depend on T, so each group of
//     GROUP staged instances has its power, alpha and skip flags evaluated
//     first, without branches, into registers; the group is then walked in
//     order with the chain alone (test T (1 - alpha), the sticky first
//     failure, w = alpha T), predicated. The expressions and the order of
//     the fp32 product of T are those of the original one-block-per-tile
//     kernel and of D1, so the include decisions are theirs.
//   - The accumulations follow in the same order, for the instances some
//     pixel of the warp includes (a warp vote; the others would add w = 0).
//     Shared-memory loads are what the SMs holding the longest tiles run
//     short of, so each staged instance is a record of float4s {x, y, cxx,
//     cxy}, {cyy, op, 0, 0}, then the C features and the depth four at a
//     time: an evaluation reads two 128-bit broadcasts and an included
//     instance ceil((C + 1) / 4) more. Accumulators stay in registers.
//   - Staging is asynchronous (cp.async), two batches of BATCH instances in
//     turn, so the next batch's loads are in flight while this one is
//     blended. A block leaves once every pixel is done (__syncthreads_count
//     per batch); a warp whose pixels are all done skips the groups' work.
// At the training capture (opacity 0.1: no pixel saturates, every pixel
// walks its whole list) the tiles near the cap still take about 0.1 ms on
// an H100 SXM: about 70 instructions per (pixel, instance) in one warp per
// 32 pixels, on SMs that hold several such blocks at once.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr int HDR = 8;        // rows before the features in the instance matrix
constexpr int BLOCK = 64;     // pixels (threads) per block
constexpr int BATCH = 128;    // instances staged per round (two buffers)
constexpr int GROUP = 8;      // instances whose alpha is evaluated ahead of the chain
constexpr int CH = 32;        // kernel D's chunk (csrc/blend_bwd.cu CH)
constexpr unsigned FULL = 0xffffffffu;
static_assert(BATCH % CH == 0 && CH % GROUP == 0 && BATCH % BLOCK == 0, "batch shape");

// Checkpoint-mode outputs (kernel D's scratch, csrc/blend_bwd.cu D1).
struct Checkpoints {
  int max_chunks;
  float* t_start;    // [max_chunks, P]
  int* stop;         // [n_tiles, P]
  float* t_final;    // [n_tiles, P]
  int2* chunk_map;   // [max_chunks]
  int* n_chunks;     // [1]
};

// Stage batch `bi` of the tile's list into `buf` with asynchronous copies
// (every thread a few instances, each value its own 4-byte copy): a record
// is {x, y, cxx, cxy}, {cyy, op, 0, 0}, then the C features and the depth
// four at a time (zeros past them), and the records up to the next whole
// group are zeros.
template <int NF4>
__device__ __forceinline__ void stage(float4* buf, const float* __restrict__ data, int ns,
                                      int start, int count, int bi, int C, int tid) {
  constexpr int REC = 2 + NF4;
  const int b0 = bi * BATCH;
  const int n = min(BATCH, count - b0);
  const int n_pad = min(BATCH, (n + GROUP - 1) / GROUP * GROUP);
#pragma unroll
  for (int m = 0; m < BATCH / BLOCK; ++m) {
    const int j = tid + m * BLOCK;
    if (j >= n_pad) break;
    float* rec = reinterpret_cast<float*>(buf + j * REC);
    if (j >= n) {
#pragma unroll
      for (int v = 0; v < 4 * REC; ++v) rec[v] = 0.f;
      continue;
    }
    const float* col = data + static_cast<long long>(start) + b0 + j;
#pragma unroll
    for (int r = 0; r < 6; ++r) {   // x y cxx cxy | cyy op
      __pipeline_memcpy_async(rec + r, col + static_cast<long long>(r) * ns, 4);
    }
    rec[6] = 0.f;
    rec[7] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NF4; ++c) {
      if (c < C) {
        __pipeline_memcpy_async(rec + 8 + c, col + static_cast<long long>(HDR + c) * ns, 4);
      } else if (c == C) {
        __pipeline_memcpy_async(rec + 8 + c, col + 6LL * ns, 4);   // depth
      } else {
        rec[8 + c] = 0.f;
      }
    }
  }
}

// NF4: float4s of features and depth per staged instance (ceil((C + 1) / 4)).
template <int NF4, bool CKPT>
__global__ void __launch_bounds__(BLOCK, 4) blend_fwd_kernel(
    const float* __restrict__ data, int ns, const int* __restrict__ starts,
    const int* __restrict__ counts, int n_tiles, int n_sub, int tile_base,
    int tiles_per_image, int tiles_x, int C, int tile_w, int tile_h, int planar,
    int out_h, int out_w, float* __restrict__ out, Checkpoints ck) {
  constexpr int REC = 2 + NF4;   // float4s per staged instance
  extern __shared__ float4 s_rec[];   // [2][BATCH][REC]: two batches in turn
  __shared__ int s_red[BLOCK / 32];
  const int P = tile_w * tile_h;
  const int t = blockIdx.x / n_sub;
  const int tid = threadIdx.x;
  const int p = (blockIdx.x % n_sub) * BLOCK + tid;   // pixel in the tile
  const bool live = p < P;
  const int start = starts[t];
  const int count = max(counts[t], 0);
  const int tg = (tile_base + t) % tiles_per_image;
  const int lx = p % tile_w;
  const int ly = p / tile_w;
  const float px = static_cast<float>((tg % tiles_x) * tile_w + lx);
  const float py = static_cast<float>((tg / tiles_x) * tile_h + ly);

  // checkpoint mode: this tile's first chunk slot, the chunks of the tiles
  // before it (as D1 finds it)
  int off = 0, nch = 0;
  bool fits = false;
  float* ckt = nullptr;
  if (CKPT && (count > 0 || t == n_tiles - 1)) {
    int part = 0;
#pragma unroll 8
    for (int j = tid; j < t; j += BLOCK) part += (max(counts[j], 0) + CH - 1) / CH;
    part = __reduce_add_sync(FULL, part);
    if ((tid & 31) == 0) s_red[tid >> 5] = part;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) off += s_red[w];
    nch = (count + CH - 1) / CH;
    // slots past max_chunks exist only if slices overlap (outside the
    // contract): such a tile marks the slots it reaches as empty and writes
    // no checkpoints, as D1 does
    fits = off + nch <= ck.max_chunks;
    if (blockIdx.x % n_sub == 0) {
      if (t == n_tiles - 1 && tid == 0) *ck.n_chunks = min(off + nch, ck.max_chunks);
      for (int c = tid; c < nch && off + c < ck.max_chunks; c += BLOCK) {
        ck.chunk_map[off + c] = make_int2(fits ? t : -1, c);
      }
    }
    if (fits && live) ckt = ck.t_start + static_cast<long long>(off) * P + p;
  }

  float acc[4 * NF4];   // the C colours, then the depth sum
#pragma unroll
  for (int c = 0; c < 4 * NF4; ++c) acc[c] = 0.f;
  float w_sum = 0.f, T = 1.f;
  bool done = !live;
  int stop = count;

  const int nb = (count + BATCH - 1) / BATCH;
  int b_left = nb * BATCH;   // where the block left its loop (a chunk start)
  if (nb > 0) stage<NF4>(s_rec, data, ns, start, count, 0, C, tid);
  __pipeline_commit();
  for (int bi = 0; bi < nb; ++bi) {
    const int b0 = bi * BATCH;
    const int n = min(BATCH, count - b0);
    const float4* rec = s_rec + (bi & 1) * BATCH * REC;
    // the next batch's copies go out before this one is used
    if (bi + 1 < nb) {
      stage<NF4>(s_rec + ((bi + 1) & 1) * BATCH * REC, data, ns, start, count, bi + 1, C, tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    // the barrier that makes the batch visible; a block whose pixels are
    // all done leaves
    if (__syncthreads_count(done ? 1 : 0) == BLOCK) {
      b_left = b0;
      break;
    }
    for (int g0 = 0; g0 < n; g0 += GROUP) {
      if (CKPT && (b0 + g0) % CH == 0 && ckt != nullptr) {
        ckt[static_cast<long long>((b0 + g0) / CH) * P] = T;
      }
      if (__all_sync(FULL, done)) continue;   // nothing left to include
      // alpha of the group's instances (0 where skipped), off the chain;
      // slots past the batch are zero records, skipped
      float al[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const float4 h0 = rec[(g0 + u) * REC];
        const float4 h1 = rec[(g0 + u) * REC + 1];
        const float dx = h0.x - px;
        const float dy = h0.y - py;
        const float power = -0.5f * (h0.z * dx * dx + h1.x * dy * dy) - h0.w * dx * dy;
        const float alpha = fminf(0.99f, h1.y * expf(power));
        const bool skip = g0 + u >= n || power > 0.f || alpha < 1.f / 255.f;
        al[u] = skip ? 0.f : alpha;
      }
      // the chain, in order, predicated: T (1 - alpha), the sticky first
      // failure, w = alpha T (0 where not included)
      float wv[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const float test_t = T * (1.f - al[u]);
        const bool valid = !done && al[u] > 0.f;
        const bool fail = valid && test_t < 1e-4f;
        const bool inc = valid && !fail;
        if (fail) stop = b0 + g0 + u;
        done = done || fail;
        wv[u] = inc ? al[u] * T : 0.f;
        T = inc ? test_t : T;
      }
      // the accumulations, in the same order, of the instances some pixel
      // of the warp includes (the others add w = 0, which leaves a sum as
      // it is): shared-memory loads are what the busy SMs run short of
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        if (!__any_sync(FULL, wv[u] > 0.f)) continue;
        const float4* r = rec + (g0 + u) * REC + 2;
#pragma unroll
        for (int k = 0; k < NF4; ++k) {
          const float4 v = r[k];
          acc[4 * k] += wv[u] * v.x;
          acc[4 * k + 1] += wv[u] * v.y;
          acc[4 * k + 2] += wv[u] * v.z;
          acc[4 * k + 3] += wv[u] * v.w;
        }
        w_sum += wv[u];
      }
    }
    __syncthreads();   // the batch is read before its buffer is staged again
  }
  __pipeline_wait_prior(0);   // no copy in flight when the block ends

  if (!live) return;
  if (CKPT) {
    // the chunks after the block left its loop hold T_final
    if (ckt != nullptr) {
      for (int k = b_left / CH; k < nch; ++k) ckt[static_cast<long long>(k) * P] = T;
    }
    ck.stop[static_cast<long long>(t) * P + p] = stop;
    ck.t_final[static_cast<long long>(t) * P + p] = T;
  }
  // rows: C colours, w_sum, d_sum, final_t
  const int rows = C + 3;
  if (planar) {
    const int y = (t / tiles_x) * tile_h + ly;
    const int x = (t % tiles_x) * tile_w + lx;
    const long long plane = static_cast<long long>(out_h) * out_w;
    float* o = out + static_cast<long long>(y) * out_w + x;
#pragma unroll
    for (int c = 0; c < 4 * NF4; ++c) {
      if (c < C) o[c * plane] = acc[c];
    }
    o[C * plane] = w_sum;
    o[(C + 1) * plane] = acc[C];
    o[(C + 2) * plane] = T;
  } else {
    float* o = out + static_cast<long long>(t) * rows * P + p;
#pragma unroll
    for (int c = 0; c < 4 * NF4; ++c) {
      if (c < C) o[c * P] = acc[c];
    }
    o[C * P] = w_sum;
    o[(C + 1) * P] = acc[C];
    o[(C + 2) * P] = T;
  }
}

template <int NF4>
void launch(const float* data, int ns, const int* starts, const int* counts,
            int n_tiles, int tile_base, int tiles_per_image, int tiles_x, int C,
            int tile_w, int tile_h, int planar, int out_h, int out_w, float* out,
            const Checkpoints& ck, cudaStream_t stream) {
  const int n_sub = (tile_w * tile_h + BLOCK - 1) / BLOCK;
  const size_t smem = static_cast<size_t>(2 * BATCH) * (2 + NF4) * sizeof(float4);
  const dim3 grid(n_tiles * n_sub);
  if (ck.t_start != nullptr) {
    blend_fwd_kernel<NF4, true><<<grid, BLOCK, smem, stream>>>(
        data, ns, starts, counts, n_tiles, n_sub, tile_base, tiles_per_image, tiles_x,
        C, tile_w, tile_h, planar, out_h, out_w, out, ck);
  } else {
    blend_fwd_kernel<NF4, false><<<grid, BLOCK, smem, stream>>>(
        data, ns, starts, counts, n_tiles, n_sub, tile_base, tiles_per_image, tiles_x,
        C, tile_w, tile_h, planar, out_h, out_w, out, ck);
  }
}

}  // namespace

// t_start == nullptr: the plain forward (no checkpoint arguments read).
// Otherwise checkpoint mode, writing t_start [max_chunks, P], stop and
// t_final [n_tiles, P], chunk_map [max_chunks] int2 and n_chunks [1].
extern "C" int blend_fwd(const float* data, int ns, const int* starts,
                         const int* counts, int n_tiles, int tile_base,
                         int tiles_per_image, int tiles_x, int C, int tile_w, int tile_h,
                         int planar, int out_h, int out_w, float* out,
                         int max_chunks, float* t_start, int* stop,
                         float* t_final, int* chunk_map, int* n_chunks,
                         cudaStream_t stream) {
  if (C < 1 || C > MAX_C || tile_w * tile_h > 1024 || tiles_per_image < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Checkpoints ck{max_chunks, t_start, stop, t_final,
                       reinterpret_cast<int2*>(chunk_map), n_chunks};
  if (n_tiles > 0) {
    switch ((C + 4) / 4) {
#define BLEND_FWD_CASE(nf4)                                                   \
  case nf4:                                                                   \
    launch<nf4>(data, ns, starts, counts, n_tiles, tile_base, tiles_per_image, \
                tiles_x, C, tile_w, tile_h, planar, out_h, out_w, out, ck,     \
                stream);                                                      \
    break;
      BLEND_FWD_CASE(1)
      BLEND_FWD_CASE(2)
      BLEND_FWD_CASE(3)
      BLEND_FWD_CASE(4)
      BLEND_FWD_CASE(5)
      BLEND_FWD_CASE(6)
      BLEND_FWD_CASE(7)
      BLEND_FWD_CASE(8)
      BLEND_FWD_CASE(9)
#undef BLEND_FWD_CASE
    }
  }
  return static_cast<int>(cudaGetLastError());
}
