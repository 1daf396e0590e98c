// Kernel B: the per-Gaussian LBS deform chain, forward and backward.
//
// Replaces: mygauhuman_tpu/ops/pallas_deform.py::_kernel (math in
// _deform_math, entry _deform_rows_pallas) with `deform_rows`, and the
// backward of its custom_vjp, _deform_bwd (jax.vjp of _deform_rows_jnp, which
// XLA compiles to a few fusions), with `deform_rows_bwd`. Per Gaussian:
// adjugate inverse of the blended big-pose rotation (|det| < 1e-8 guard),
// inverse skinning of point, normal and translation, the combined blendshape
// offset, forward skinning to the target pose, then the global Rg / Th
// transform. Layout (component-major, as the JAX kernel): abig/asrc [12, N]
// rows (r00 r01 r02 t0 r10 r11 r12 t1 r20 r21 r22 t2), packed [9, N] rows
// (point 3, normal 3, offset 3), scalars [32] (Rg 9, Rg^-1 9, Th 3, pad);
// output [21, N] rows (smpl point 3, world point 3, transform 9,
// translation 3, world normal 3).
//
// Bound: bytes. The forward reads 33 floats and writes 21 per Gaussian
// (216 B, 1.5 MB at N = 6,912: ~0.45 us at 3.35 TB/s) for ~300 fp32
// operations; the backward reads 33 + 21 (the cotangent) and writes 33
// (348 B) for ~800, the chain's recompute included. Without the scalars'
// gradient, as the training step asks, the target-pose point and
// translation go unused, and with them the source translation rows: 30 + 21
// rows in, 33 out (336 B, ~0.82 us at N = 8,192) for ~670 operations. Both
// are far below the compute rate, and at these N a launch is a few
// microseconds of latency: one wave of loads, the chain in registers, one
// wave of stores.
//
// Design: one thread per Gaussian for any N (no block padding), reads and
// writes coalesced along the N axis. Blocks of 64 threads, so that the
// serving N = 6,912 and the training N = 8,192 / 16,384 spread over 108 /
// 128 / 256 of the 132 SMs instead of 27 / 32 / 64 blocks of 256. The
// backward recomputes the forward chain in registers (nothing is saved but
// the inputs) and runs its adjoint in reverse; the guard makes det a
// constant, so a guarded Gaussian takes no gradient through det. Flags (a
// null output) say which gradients to write. The scalars' gradient is a sum
// over N without atomics: each warp sums its 32 Gaussians' shares by an xor
// butterfly into a [21, ceil(N / 32)] scratch, and a second launch of one
// block (a warp per entry) sums that in a fixed order, so the bits do not
// change between runs. Compiled with -fmad=false and written op for op as
// the plain PyTorch versions (ops/pallas_deform.py: deform_rows_plain,
// deform_rows_bwd_plain), so each agrees with its plain version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

struct M3 {
  float a00, a01, a02, a10, a11, a12, a20, a21, a22;
};
struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mat_vec(const M3& m, const V3& v) {
  return {m.a00 * v.x + m.a01 * v.y + m.a02 * v.z,
          m.a10 * v.x + m.a11 * v.y + m.a12 * v.z,
          m.a20 * v.x + m.a21 * v.y + m.a22 * v.z};
}

// m^T v
__device__ __forceinline__ V3 mat_t_vec(const M3& m, const V3& v) {
  return {m.a00 * v.x + m.a10 * v.y + m.a20 * v.z,
          m.a01 * v.x + m.a11 * v.y + m.a21 * v.z,
          m.a02 * v.x + m.a12 * v.y + m.a22 * v.z};
}

__device__ __forceinline__ M3 mat_mat(const M3& a, const M3& b) {
  return {a.a00 * b.a00 + a.a01 * b.a10 + a.a02 * b.a20,
          a.a00 * b.a01 + a.a01 * b.a11 + a.a02 * b.a21,
          a.a00 * b.a02 + a.a01 * b.a12 + a.a02 * b.a22,
          a.a10 * b.a00 + a.a11 * b.a10 + a.a12 * b.a20,
          a.a10 * b.a01 + a.a11 * b.a11 + a.a12 * b.a21,
          a.a10 * b.a02 + a.a11 * b.a12 + a.a12 * b.a22,
          a.a20 * b.a00 + a.a21 * b.a10 + a.a22 * b.a20,
          a.a20 * b.a01 + a.a21 * b.a11 + a.a22 * b.a21,
          a.a20 * b.a02 + a.a21 * b.a12 + a.a22 * b.a22};
}

// a^T b
__device__ __forceinline__ M3 mat_t_mat(const M3& a, const M3& b) {
  return {a.a00 * b.a00 + a.a10 * b.a10 + a.a20 * b.a20,
          a.a00 * b.a01 + a.a10 * b.a11 + a.a20 * b.a21,
          a.a00 * b.a02 + a.a10 * b.a12 + a.a20 * b.a22,
          a.a01 * b.a00 + a.a11 * b.a10 + a.a21 * b.a20,
          a.a01 * b.a01 + a.a11 * b.a11 + a.a21 * b.a21,
          a.a01 * b.a02 + a.a11 * b.a12 + a.a21 * b.a22,
          a.a02 * b.a00 + a.a12 * b.a10 + a.a22 * b.a20,
          a.a02 * b.a01 + a.a12 * b.a11 + a.a22 * b.a21,
          a.a02 * b.a02 + a.a12 * b.a12 + a.a22 * b.a22};
}

// a b^T
__device__ __forceinline__ M3 mat_mat_t(const M3& a, const M3& b) {
  return {a.a00 * b.a00 + a.a01 * b.a01 + a.a02 * b.a02,
          a.a00 * b.a10 + a.a01 * b.a11 + a.a02 * b.a12,
          a.a00 * b.a20 + a.a01 * b.a21 + a.a02 * b.a22,
          a.a10 * b.a00 + a.a11 * b.a01 + a.a12 * b.a02,
          a.a10 * b.a10 + a.a11 * b.a11 + a.a12 * b.a12,
          a.a10 * b.a20 + a.a11 * b.a21 + a.a12 * b.a22,
          a.a20 * b.a00 + a.a21 * b.a01 + a.a22 * b.a02,
          a.a20 * b.a10 + a.a21 * b.a11 + a.a22 * b.a12,
          a.a20 * b.a20 + a.a21 * b.a21 + a.a22 * b.a22};
}

// x @ Rg^-1 (row-vector convention of lbs.py apply_rg_inv)
__device__ __forceinline__ V3 apply_rgi(const M3& rgi, const V3& v) {
  return {v.x * rgi.a00 + v.y * rgi.a10 + v.z * rgi.a20,
          v.x * rgi.a01 + v.y * rgi.a11 + v.z * rgi.a21,
          v.x * rgi.a02 + v.y * rgi.a12 + v.z * rgi.a22};
}

__device__ __forceinline__ V3 add(const V3& a, const V3& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// Entry k (row-major) of a matrix, component k of a vector: k is a constant
// once the loops that call these are unrolled, so the values stay in
// registers.
__device__ __forceinline__ float at(const M3& m, int k) {
  switch (k) {
    case 0: return m.a00;
    case 1: return m.a01;
    case 2: return m.a02;
    case 3: return m.a10;
    case 4: return m.a11;
    case 5: return m.a12;
    case 6: return m.a20;
    case 7: return m.a21;
    default: return m.a22;
  }
}
__device__ __forceinline__ float at(const V3& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

// One Gaussian's inputs, read coalesced along N.
struct In {
  M3 b, rs;
  V3 bt, st, q, n, o;
};

__device__ __forceinline__ In load_in(const float* __restrict__ ab,
                                      const float* __restrict__ as,
                                      const float* __restrict__ pk, long long s,
                                      int n) {
  In v;
  v.b = {ab[0 * s + n], ab[1 * s + n], ab[2 * s + n],
         ab[4 * s + n], ab[5 * s + n], ab[6 * s + n],
         ab[8 * s + n], ab[9 * s + n], ab[10 * s + n]};
  v.bt = {ab[3 * s + n], ab[7 * s + n], ab[11 * s + n]};
  v.rs = {as[0 * s + n], as[1 * s + n], as[2 * s + n],
          as[4 * s + n], as[5 * s + n], as[6 * s + n],
          as[8 * s + n], as[9 * s + n], as[10 * s + n]};
  v.st = {as[3 * s + n], as[7 * s + n], as[11 * s + n]};
  v.q = {pk[0 * s + n], pk[1 * s + n], pk[2 * s + n]};
  v.n = {pk[3 * s + n], pk[4 * s + n], pk[5 * s + n]};
  v.o = {pk[6 * s + n], pk[7 * s + n], pk[8 * s + n]};
  return v;
}

__device__ __forceinline__ M3 load_m3(const float* __restrict__ p) {
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
}

// The chain up to the target pose: what the outputs and the adjoint read.
struct Chain {
  M3 cof;   // adjugate (A .. I) of the big-pose blend
  bool guard;  // |det| < 1e-8: det replaced by a constant
  float inv;
  M3 r;     // the inverse blend
  V3 u;     // point - big-pose translation
  V3 x, nrm, tr;     // T pose: point and translation with the offset, normal
  V3 smpl, nrm2, tr2;  // target pose
  M3 tf;    // rs r
};

__device__ __forceinline__ Chain chain(const In& v) {
  Chain c;
  const M3& b = v.b;
  // inverse of the big-pose blend: adjugate with the det guard
  c.cof = {b.a11 * b.a22 - b.a12 * b.a21, b.a02 * b.a21 - b.a01 * b.a22,
           b.a01 * b.a12 - b.a02 * b.a11, b.a12 * b.a20 - b.a10 * b.a22,
           b.a00 * b.a22 - b.a02 * b.a20, b.a02 * b.a10 - b.a00 * b.a12,
           b.a10 * b.a21 - b.a11 * b.a20, b.a01 * b.a20 - b.a00 * b.a21,
           b.a00 * b.a11 - b.a01 * b.a10};
  float det = b.a00 * c.cof.a00 + b.a01 * c.cof.a10 + b.a02 * c.cof.a20;
  c.guard = fabsf(det) < 1e-8f;
  if (c.guard) {
    const float sign = (det > 0.f) ? 1.f : ((det < 0.f) ? -1.f : 0.f);
    det = sign * 1e-8f + 1e-12f;
  }
  c.inv = 1.0f / det;
  const M3& k = c.cof;
  c.r = {k.a00 * c.inv, k.a01 * c.inv, k.a02 * c.inv, k.a10 * c.inv, k.a11 * c.inv,
         k.a12 * c.inv, k.a20 * c.inv, k.a21 * c.inv, k.a22 * c.inv};

  // big pose -> T pose, then the combined blendshape offset
  c.u = {v.q.x - v.bt.x, v.q.y - v.bt.y, v.q.z - v.bt.z};
  c.x = add(mat_vec(c.r, c.u), v.o);
  c.nrm = mat_vec(c.r, v.n);
  c.tr = add(mat_vec(c.r, {-v.bt.x, -v.bt.y, -v.bt.z}), v.o);

  // T pose -> target pose
  c.smpl = add(mat_vec(v.rs, c.x), v.st);
  c.nrm2 = mat_vec(v.rs, c.nrm);
  c.tf = mat_mat(v.rs, c.r);
  c.tr2 = add(mat_vec(v.rs, c.tr), v.st);
  return c;
}

__global__ void __launch_bounds__(THREADS) deform_fwd_kernel(
    const float* __restrict__ ab, const float* __restrict__ as,
    const float* __restrict__ pk, const float* __restrict__ sc, int N,
    float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long s = N;
  const Chain c = chain(load_in(ab, as, pk, s, n));
  const M3 rg = load_m3(sc), rgi = load_m3(sc + 9);
  const V3 th = {sc[18], sc[19], sc[20]};

  // SMPL -> world
  const V3 wp = add(apply_rgi(rgi, c.smpl), th);
  const V3 wn = apply_rgi(rgi, c.nrm2);
  const M3 tf = mat_mat(rg, c.tf);
  const V3 trw = add(apply_rgi(rgi, c.tr2), th);

  const float rows[21] = {c.smpl.x, c.smpl.y, c.smpl.z, wp.x, wp.y, wp.z,
                          tf.a00, tf.a01, tf.a02, tf.a10, tf.a11, tf.a12,
                          tf.a20, tf.a21, tf.a22, trw.x, trw.y, trw.z,
                          wn.x, wn.y, wn.z};
#pragma unroll
  for (int k = 0; k < 21; ++k) out[k * s + n] = rows[k];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) deform_bwd_kernel(
    const float* __restrict__ ab, const float* __restrict__ as,
    const float* __restrict__ pk, const float* __restrict__ sc,
    const float* __restrict__ g, int N, float* __restrict__ d_ab,
    float* __restrict__ d_as, float* __restrict__ d_pk,
    float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  // a warp wholly past N has no partial to write
  if (blockIdx.x * blockDim.x + (threadIdx.x & ~(WARP - 1)) >= N) return;
  const long long s = N;
  float shares[21];   // this Gaussian's share of the scalars' gradient
#pragma unroll
  for (int k = 0; k < 21; ++k) shares[k] = 0.f;
  if (live) {
    const In v = load_in(ab, as, pk, s, n);
    const Chain c = chain(v);
    const M3 rg = load_m3(sc), rgi = load_m3(sc + 9);
    const V3 gs = {g[0 * s + n], g[1 * s + n], g[2 * s + n]};
    const V3 gw = {g[3 * s + n], g[4 * s + n], g[5 * s + n]};
    const M3 gT = {g[6 * s + n], g[7 * s + n], g[8 * s + n],
                   g[9 * s + n], g[10 * s + n], g[11 * s + n],
                   g[12 * s + n], g[13 * s + n], g[14 * s + n]};
    const V3 gtr = {g[15 * s + n], g[16 * s + n], g[17 * s + n]};
    const V3 gn = {g[18 * s + n], g[19 * s + n], g[20 * s + n]};

    // SMPL -> world
    const V3 d_smpl = add(gs, mat_vec(rgi, gw));
    const V3 d_nrm2 = mat_vec(rgi, gn);
    const V3 d_tr2 = mat_vec(rgi, gtr);
    const M3 d_tf = mat_t_mat(rg, gT);
    if (partial != nullptr) {
      const M3 d_rg = mat_mat_t(gT, c.tf);
#pragma unroll
      for (int k = 0; k < 9; ++k) shares[k] = at(d_rg, k);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          shares[9 + 3 * i + j] = at(c.smpl, i) * at(gw, j) + at(c.nrm2, i) * at(gn, j) +
                                  at(c.tr2, i) * at(gtr, j);
      shares[18] = gw.x + gtr.x;
      shares[19] = gw.y + gtr.y;
      shares[20] = gw.z + gtr.z;
    }

    // T pose -> target pose
    const V3 d_st = add(d_smpl, d_tr2);
    const M3 dtf_rt = mat_mat_t(d_tf, c.r);
    float d_rs[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        d_rs[3 * i + j] = at(d_smpl, i) * at(c.x, j) + at(d_nrm2, i) * at(c.nrm, j) +
                          at(dtf_rt, 3 * i + j) + at(d_tr2, i) * at(c.tr, j);
    const V3 d_x = mat_t_vec(v.rs, d_smpl);
    const V3 d_nrm = mat_t_vec(v.rs, d_nrm2);
    const V3 d_tr = mat_t_vec(v.rs, d_tr2);
    const M3 d_r0 = mat_t_mat(v.rs, d_tf);

    // the combined blendshape offset, then big pose -> T pose
    const V3 d_o = add(d_x, d_tr);
    const V3 mbt = {-v.bt.x, -v.bt.y, -v.bt.z};
    float d_r[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        d_r[3 * i + j] = at(d_r0, 3 * i + j) + at(d_x, i) * at(c.u, j) +
                         at(d_nrm, i) * at(v.n, j) + at(d_tr, i) * at(mbt, j);
    const V3 d_q = mat_t_vec(c.r, d_x);
    const V3 d_n = mat_t_vec(c.r, d_nrm);
    const V3 d_mbt = mat_t_vec(c.r, d_tr);
    const V3 d_bt = {-(d_q.x + d_mbt.x), -(d_q.y + d_mbt.y), -(d_q.z + d_mbt.z)};

    // r = cofactors * inv, inv = 1 / det; where the guard fired, det is a
    // constant and takes no gradient
    float dA = d_r[0] * c.inv, dB = d_r[1] * c.inv, dC = d_r[2] * c.inv;
    float dD = d_r[3] * c.inv, dE = d_r[4] * c.inv, dF = d_r[5] * c.inv;
    float dG = d_r[6] * c.inv, dH = d_r[7] * c.inv, dI = d_r[8] * c.inv;
    float d_inv = d_r[0] * c.cof.a00;
#pragma unroll
    for (int k = 1; k < 9; ++k) d_inv = d_inv + d_r[k] * at(c.cof, k);
    const float d_det = c.guard ? 0.f : -d_inv * c.inv * c.inv;
    // det = b00 A + b01 D + b02 G
    const M3& b = v.b;
    dA = dA + d_det * b.a00;
    dD = dD + d_det * b.a01;
    dG = dG + d_det * b.a02;
    const float A = c.cof.a00, D = c.cof.a10, G = c.cof.a20;
    const float db[9] = {
        d_det * A + dE * b.a22 - dF * b.a12 - dH * b.a21 + dI * b.a11,
        d_det * D - dB * b.a22 + dC * b.a12 + dH * b.a20 - dI * b.a10,
        d_det * G + dB * b.a21 - dC * b.a11 - dE * b.a20 + dF * b.a10,
        -dD * b.a22 + dF * b.a02 + dG * b.a21 - dI * b.a01,
        dA * b.a22 - dC * b.a02 - dG * b.a20 + dI * b.a00,
        -dA * b.a21 + dC * b.a01 + dD * b.a20 - dF * b.a00,
        dD * b.a12 - dE * b.a02 - dG * b.a11 + dH * b.a01,
        -dA * b.a12 + dB * b.a02 + dG * b.a10 - dH * b.a00,
        dA * b.a11 - dB * b.a01 - dD * b.a10 + dE * b.a00};

    if (d_ab != nullptr) {
      const float rows[12] = {db[0], db[1], db[2], d_bt.x, db[3], db[4], db[5], d_bt.y,
                              db[6], db[7], db[8], d_bt.z};
#pragma unroll
      for (int k = 0; k < 12; ++k) d_ab[k * s + n] = rows[k];
    }
    if (d_as != nullptr) {
      const float rows[12] = {d_rs[0], d_rs[1], d_rs[2], d_st.x, d_rs[3], d_rs[4],
                              d_rs[5], d_st.y, d_rs[6], d_rs[7], d_rs[8], d_st.z};
#pragma unroll
      for (int k = 0; k < 12; ++k) d_as[k * s + n] = rows[k];
    }
    if (d_pk != nullptr) {
      const float rows[9] = {d_q.x, d_q.y, d_q.z, d_n.x, d_n.y, d_n.z,
                             d_o.x, d_o.y, d_o.z};
#pragma unroll
      for (int k = 0; k < 9; ++k) d_pk[k * s + n] = rows[k];
    }
  }
  if (partial == nullptr) return;
  // each warp's 32 shares, summed by a butterfly (zeros past N)
  const int nw = (N + WARP - 1) / WARP;
  const int w = n / WARP;
#pragma unroll
  for (int k = 0; k < 21; ++k) {
    const float t = warp_sum(shares[k]);
    if ((threadIdx.x & (WARP - 1)) == 0) partial[k * nw + w] = t;
  }
}

// One block, a warp per entry: lane l sums partials l, l + 32, ... in turn,
// then a butterfly over the lanes; entries 21-31 are 0.
__global__ void __launch_bounds__(21 * WARP) deform_bwd_scalars_kernel(
    const float* __restrict__ partial, int nw, float* __restrict__ d_sc) {
  const int k = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  float acc = 0.f;
  for (int i = lane; i < nw; i += WARP) acc = acc + partial[k * nw + i];
  acc = warp_sum(acc);
  if (lane == 0) d_sc[k] = acc;
  if (k == 0 && lane >= 21) d_sc[lane] = 0.f;
}

}  // namespace

// Threads per block of both entries, for a caller that reports the launch.
extern "C" int deform_threads() { return THREADS; }

extern "C" int deform_rows(const float* abig, const float* asrc,
                           const float* packed, const float* scalars, int N,
                           float* out, cudaStream_t stream) {
  if (N > 0) {
    deform_fwd_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        abig, asrc, packed, scalars, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_abig / d_asrc / d_packed / d_scalars may each be null (not asked for);
// partial is a [21, ceil(N / 32)] scratch, needed with d_scalars.
extern "C" int deform_rows_bwd(const float* abig, const float* asrc,
                               const float* packed, const float* scalars,
                               const float* g, int N, float* d_abig,
                               float* d_asrc, float* d_packed, float* partial,
                               float* d_scalars, cudaStream_t stream) {
  if (d_scalars == nullptr) partial = nullptr;
  if (N > 0) {
    deform_bwd_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        abig, asrc, packed, scalars, g, N, d_abig, d_asrc, d_packed, partial);
  }
  if (d_scalars != nullptr) {
    deform_bwd_scalars_kernel<<<1, 21 * WARP, 0, stream>>>(
        partial, (N + WARP - 1) / WARP, d_scalars);
  }
  return static_cast<int>(cudaGetLastError());
}
