// Kernel B: the per-Gaussian LBS deform chain.
//
// Replaces: mygauhuman_tpu/ops/pallas_deform.py::_kernel (math in
// _deform_math, entry _deform_rows_pallas). Per Gaussian: adjugate inverse
// of the blended big-pose rotation (|det| < 1e-8 guard), inverse skinning
// of point, normal and translation, the combined blendshape offset,
// forward skinning to the target pose, then the global Rg / Th transform.
// Layout (component-major, as the JAX kernel): abig/asrc [12, N] rows
// (r00 r01 r02 t0 r10 r11 r12 t1 r20 r21 r22 t2), packed [9, N] rows
// (point 3, normal 3, offset 3), scalars [32] (Rg 9, Rg^-1 9, Th 3, pad);
// output [21, N] rows (smpl point 3, world point 3, transform 9,
// translation 3, world normal 3).
//
// Bound: bytes, and in practice launch latency. 33 floats in and 21 out
// per Gaussian = 216 B (1.5 MB at N = 6,912), ~0.45 us at 3.35 TB/s; the
// ~310 fp32 operations per Gaussian are far below the compute rate.
//
// Design: one thread per Gaussian for any N (no block padding), reads and
// writes coalesced along the N axis. Compiled with -fmad=false and written
// op for op as the plain PyTorch version, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

// x @ Rg^-1 (row-vector convention of lbs.py apply_rg_inv)
__device__ __forceinline__ V3 apply_rgi(const float* rgi, const V3& v) {
  return {v.x * rgi[0] + v.y * rgi[3] + v.z * rgi[6],
          v.x * rgi[1] + v.y * rgi[4] + v.z * rgi[7],
          v.x * rgi[2] + v.y * rgi[5] + v.z * rgi[8]};
}

__global__ void deform_kernel(const float* __restrict__ ab,
                              const float* __restrict__ as,
                              const float* __restrict__ pk,
                              const float* __restrict__ sc, int N,
                              float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long s = N;
  const float b00 = ab[0 * s + n], b01 = ab[1 * s + n], b02 = ab[2 * s + n];
  const float bt0 = ab[3 * s + n];
  const float b10 = ab[4 * s + n], b11 = ab[5 * s + n], b12 = ab[6 * s + n];
  const float bt1 = ab[7 * s + n];
  const float b20 = ab[8 * s + n], b21 = ab[9 * s + n], b22 = ab[10 * s + n];
  const float bt2 = ab[11 * s + n];
  const M3 rs = {as[0 * s + n], as[1 * s + n], as[2 * s + n],
                 as[4 * s + n], as[5 * s + n], as[6 * s + n],
                 as[8 * s + n], as[9 * s + n], as[10 * s + n]};
  const float st0 = as[3 * s + n], st1 = as[7 * s + n], st2 = as[11 * s + n];
  const float q0 = pk[0 * s + n], q1 = pk[1 * s + n], q2 = pk[2 * s + n];
  const float n0 = pk[3 * s + n], n1 = pk[4 * s + n], n2 = pk[5 * s + n];
  const float o0 = pk[6 * s + n], o1 = pk[7 * s + n], o2 = pk[8 * s + n];
  const M3 rg = {sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7], sc[8]};
  const float* rgi = sc + 9;
  const float th0 = sc[18], th1 = sc[19], th2 = sc[20];

  // inverse of the big-pose blend: adjugate with the det guard
  const float A = b11 * b22 - b12 * b21;
  const float B = b02 * b21 - b01 * b22;
  const float C = b01 * b12 - b02 * b11;
  const float D = b12 * b20 - b10 * b22;
  const float E = b00 * b22 - b02 * b20;
  const float F = b02 * b10 - b00 * b12;
  const float G = b10 * b21 - b11 * b20;
  const float H = b01 * b20 - b00 * b21;
  const float I = b00 * b11 - b01 * b10;
  float det = b00 * A + b01 * D + b02 * G;
  if (fabsf(det) < 1e-8f) {
    const float sign = (det > 0.f) ? 1.f : ((det < 0.f) ? -1.f : 0.f);
    det = sign * 1e-8f + 1e-12f;
  }
  const float inv = 1.0f / det;
  const M3 r = {A * inv, B * inv, C * inv, D * inv, E * inv,
                F * inv, G * inv, H * inv, I * inv};

  // big pose -> T pose, then the combined blendshape offset
  V3 x = mat_vec(r, {q0 - bt0, q1 - bt1, q2 - bt2});
  V3 nrm = mat_vec(r, {n0, n1, n2});
  V3 tr = mat_vec(r, {-bt0, -bt1, -bt2});
  x = {x.x + o0, x.y + o1, x.z + o2};
  tr = {tr.x + o0, tr.y + o1, tr.z + o2};

  // T pose -> target pose
  const V3 sp = mat_vec(rs, x);
  const V3 smpl = {sp.x + st0, sp.y + st1, sp.z + st2};
  nrm = mat_vec(rs, nrm);
  M3 tf = mat_mat(rs, r);
  tr = mat_vec(rs, tr);
  tr = {tr.x + st0, tr.y + st1, tr.z + st2};

  // SMPL -> world
  const V3 wp = apply_rgi(rgi, smpl);
  const V3 wn = apply_rgi(rgi, nrm);
  tf = mat_mat(rg, tf);
  const V3 trw = apply_rgi(rgi, tr);

  const float rows[21] = {smpl.x, smpl.y, smpl.z,
                          wp.x + th0, wp.y + th1, wp.z + th2,
                          tf.a00, tf.a01, tf.a02, tf.a10, tf.a11, tf.a12,
                          tf.a20, tf.a21, tf.a22,
                          trw.x + th0, trw.y + th1, trw.z + th2,
                          wn.x, wn.y, wn.z};
#pragma unroll
  for (int k = 0; k < 21; ++k) out[k * s + n] = rows[k];
}

}  // namespace

extern "C" int deform_rows(const float* abig, const float* asrc,
                           const float* packed, const float* scalars, int N,
                           float* out, cudaStream_t stream) {
  if (N > 0) {
    deform_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        abig, asrc, packed, scalars, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}
