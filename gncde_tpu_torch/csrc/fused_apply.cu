// K12 and K13: the dense per-layer fused equivariant apply.
//
// Replaces the TPU kernels gncde_tpu/ops/pallas/fused_basis.py (_kernel /
// _pallas_forward: backend "pallas") and gncde_tpu/ops/pallas/pipeline.py
// (_make_kernel / fused_conv_stream: backend "pipeline"). Both compute, per
// batch element, on materialised f32 planes A = A(t), dA = dA(t) (B, n, n):
//
//   out = (q00 A + q01 dA) M + (q10 A + q11 dA)^T M
//         + dvec * M + u (x) s + 1 (x) w
//
// with M (B, n, H), dvec, u (B, n), s, w (B, H) and q (2, 2) shared by the
// batch. K12's wrapper passes q = [[1 + p1_0, 1 + p1_1], [p2_0, p2_1]] and
// w = v M + c7 s; K13's passes the q and wrow of pipeline._rank_structure
// (for dM: the transposed operator's). The function is the same, so one
// __global__ kernel serves both entry points.
//
// Layout: K1's row pass without the Hermite evaluation. A CTA owns BM rows
// of one element (grid (ceil(n / BM), B)); for each BK-deep tile it reads
// its row panel of A and dA and the transposed column panel (for the C^T M
// part of its own rows), forms C = R + C'^T in shared memory and multiplies
// with f32 FMA. The TPU pipeline kernel accumulates C^T M over its
// sequential grid into one VMEM buffer; across parallel CTAs that would need
// float atomics, which add in no fixed order, so here each CTA owns its
// output rows and reads the planes a second time instead: every output
// element is summed by one thread in a fixed order, and two launches are
// bitwise equal (the checkpointed adjoint's recomputation needs that).
//
// What bounds it on the card: bytes. The least work reads A and dA once
// (8 n^2 bytes per element) against 4 n^2 H FLOPs; this kernel reads them
// twice (row and column panels; the second read mostly hits L2) and sweeps
// the output columns in chunks of HC = 64. Plain f32 FMA from shared
// memory; no tensor cores or TMA yet.
#include <cuda_runtime.h>

namespace fa {

constexpr int BM = 16;   // rows per CTA
constexpr int BK = 32;   // reduce tile depth
constexpr int NT = 256;  // threads per CTA
constexpr int HC = 64;   // output columns per sweep
constexpr int PPT = BM * HC / NT;

__global__ void __launch_bounds__(NT)
apply_kernel(const float* __restrict__ A, const float* __restrict__ dA, int n,
             const float* __restrict__ q, const float* __restrict__ M, int H,
             const float* __restrict__ dvec, const float* __restrict__ u,
             const float* __restrict__ s, const float* __restrict__ w,
             float* __restrict__ out) {
  __shared__ float Cs[BM][BK + 1];
  __shared__ float Ms[BK][HC];
  const int b = blockIdx.y, r0 = blockIdx.x * BM, tid = threadIdx.x;
  const long long pb = (long long)b * n * n;
  const float* Mb = M + (long long)b * n * H;
  const float q00 = __ldg(q), q01 = __ldg(q + 1), q10 = __ldg(q + 2), q11 = __ldg(q + 3);

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    float acc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < n; k0 += BK) {
      // Row panel R[i, k] (coalesced along k).
      for (int e = tid; e < BM * BK; e += NT) {
        const int i = e / BK, kk = e % BK, gi = r0 + i, gk = k0 + kk;
        float v = 0.f;
        if (gi < n && gk < n) {
          const long long o = pb + (long long)gi * n + gk;
          v = q00 * __ldg(A + o) + q01 * __ldg(dA + o);
        }
        Cs[i][kk] = v;
      }
      for (int e = tid; e < BK * hc; e += NT) {
        const int kk = e / hc, h = e % hc, gk = k0 + kk;
        Ms[kk][h] = gk < n ? Mb[(long long)gk * H + h0 + h] : 0.f;
      }
      __syncthreads();
      // Column panel C'[k, i] of the CTA's own rows (coalesced along i).
      for (int e = tid; e < BM * BK; e += NT) {
        const int kk = e / BM, i = e % BM, gi = r0 + i, gk = k0 + kk;
        if (gi < n && gk < n) {
          const long long o = pb + (long long)gk * n + gi;
          Cs[i][kk] += q10 * __ldg(A + o) + q11 * __ldg(dA + o);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int p = tid + j * NT, i = p / HC, h = p % HC;
        if (h < hc) {
          float a = acc[j];
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) a += Cs[i][kk] * Ms[kk][h];
          acc[j] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * NT, i = p / HC, h = p % HC, gi = r0 + i;
      if (h < hc && gi < n) {
        const long long o = ((long long)b * n + gi) * H + h0 + h;
        const long long vb = (long long)b * n + gi, hb = (long long)b * H + h0 + h;
        out[o] = acc[j] + __ldg(dvec + vb) * M[o] + __ldg(u + vb) * __ldg(s + hb) +
                 __ldg(w + hb);
      }
    }
  }
}

}  // namespace fa

using namespace fa;

// A, dA: (B, n, n) f32; q: device (4,) f32 row-major (q00, q01, q10, q11);
// M, out: (B, n, H) f32; dvec, u: (B, n); s, w: (B, H). Returns the first
// CUDA error.
extern "C" int gncde_fused_apply(const float* A, const float* dA, int B, int n,
                                 const float* q, const float* M, int H,
                                 const float* dvec, const float* u, const float* s,
                                 const float* w, float* out, cudaStream_t stream) {
  if (B < 1 || n < 1 || H < 1) return (int)cudaErrorInvalidValue;
  apply_kernel<<<dim3((n + BM - 1) / BM, B), NT, 0, stream>>>(A, dA, n, q, M, H, dvec, u,
                                                              s, w, out);
  return (int)cudaGetLastError();
}
