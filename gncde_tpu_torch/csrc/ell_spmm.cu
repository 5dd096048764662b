// K10: ELL SpMM, out[b, r, :] = sum_k values[b, r, k] * M[b, indices[b, r, k], :].
//
// Replaces the TPU kernel gncde_tpu/ops/pallas/sparse_spmm.py (_spmm_kernel /
// _spmm_pallas). On the TPU that kernel stayed a seed: Mosaic could not lower
// a vectorised sublane gather, so its scalar row loop lost to XLA's gather and
// ops/sparse.py kept the gather. On Hopper a gather is an ordinary load, so
// this kernel serves ell_spmm itself.
//
// Layout. indices (B, n, K) int32 with padding slots == n, values (B, n, K)
// f32, M (B, n, H) f32, out (B, n, H) f32. Each operand has its own batch
// stride in elements (0 for an operand shared by the batch: no copy). The
// inner (n, K) and (n, H) dims are contiguous.
//
// One row per group of G lanes (G a power of two, the least that covers
// the row's H columns in VEC-wide pieces, at least 8 and at most 32), so a
// warp runs 32 / G rows. The group reads its row's K indices and values
// once, G slots at a time, one slot per lane (coalesced; the next G while
// this G's rows of M are gathered), and broadcasts each slot to the group
// with __shfl_sync; each lane then gathers its VEC columns of M[indices[k]]
// (one float4 where H % 4 == 0 and M is 16-byte aligned: VEC = 4), eight
// slots' rows in flight at once. The
// (n, K, H) gathered intermediate of the XLA formulation never exists.
// Padding slots (index == n, or anything outside [0, n)) are skipped: M is
// not padded with a zero row. Each output is one fmaf chain over the slots
// in slot order, as in the first version of this kernel (one thread per
// output), so the results are bitwise repeatable and bitwise that version's.
// Columns beyond G * VEC (H > 128) are swept in further passes over the row.
// The launch takes 1, 2, 4 or 8 warps a CTA, the most that still gives
// every SM two CTAs (the caller passes the SM count), so small problems (the flagship: 1,600 rows) spread
// over the card and large ones (n = 32768) do not pay for tiny CTAs.
//
// What bounds it on the card: bytes. Per output row it moves K indices and
// values (8 K bytes), K gathered rows of M (4 K H bytes, mostly from the
// 50 MB L2: each row of M is gathered by about K rows) and one row written,
// against 2 K H flops; far below the card's 20 flops per byte. At the
// scaled point (n = 32768, K = 129) the indices and values are 34 MB, read
// once from device memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace ell {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ void fma(float v, T m, float (&a)[1]) {
    a[0] = fmaf(v, m, a[0]);
  }
};
template <>
struct Vec<4> {
  typedef float4 T;
  static __device__ __forceinline__ void fma(float v, T m, float (&a)[4]) {
    a[0] = fmaf(v, m.x, a[0]);
    a[1] = fmaf(v, m.y, a[1]);
    a[2] = fmaf(v, m.z, a[2]);
    a[3] = fmaf(v, m.w, a[3]);
  }
};

template <int VEC>
__global__ void ell_rows_kernel(const int* __restrict__ idx, long long idx_bs,
                                const float* __restrict__ vals, long long val_bs,
                                const float* __restrict__ M, long long m_bs,
                                float* __restrict__ out, int B, int n, int K, int H,
                                int G) {
  typedef typename Vec<VEC>::T VT;
  const int lane = threadIdx.x & 31, lg = lane & (G - 1);
  const long long rows = (long long)B * n;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  // Lanes past the last row still take part in the shuffles, with no slots.
  const bool live = row < rows;
  const int b = live ? (int)(row / n) : 0;
  const int r = live ? (int)(row - (long long)b * n) : 0;
  const int* ir = idx + b * idx_bs + (long long)r * K;
  const float* vr = vals + b * val_bs + (long long)r * K;
  const float* Mb = M + b * m_bs;
  float* orow = out + row * H;
  for (int c0 = 0; c0 < H; c0 += G * VEC) {
    const int c = c0 + lg * VEC;
    const bool on = live && c < H;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    // The next chunk's slots are loaded while this chunk's rows of M are
    // gathered. Within a chunk, slots go eight at a time: eight broadcasts,
    // then eight gathers in flight together, then the eight fmaf in slot
    // order.
    int nj = live && lg < K ? __ldg(ir + lg) : -1;
    float nv = live && lg < K ? __ldg(vr + lg) : 0.f;
    for (int k0 = 0; k0 < K; k0 += G) {
      const int my_j = nj;
      const float my_v = nv;
      const int kn = k0 + G + lg;
      nj = live && kn < K ? __ldg(ir + kn) : -1;
      nv = live && kn < K ? __ldg(vr + kn) : 0.f;
      const int nk = K - k0 < G ? K - k0 : G;
      for (int u0 = 0; u0 < nk; u0 += 8) {
        int j[8];
        float v[8];
        VT m[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          j[q] = __shfl_sync(0xffffffffu, my_j, u0 + q, G);
          v[q] = __shfl_sync(0xffffffffu, my_v, u0 + q, G);
          if (!(on && u0 + q < nk && j[q] >= 0 && j[q] < n)) j[q] = -1;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (j[q] >= 0)
            m[q] = __ldg(reinterpret_cast<const VT*>(Mb + (long long)j[q] * H + c));
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (j[q] >= 0) Vec<VEC>::fma(v[q], m[q], acc);
      }
    }
    if (on) {
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(orow + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      else
        orow[c] = acc[0];
    }
  }
}

}  // namespace ell

extern "C" int gncde_ell_spmm(const int* idx, long long idx_bs, const float* vals,
                              long long val_bs, const float* M, long long m_bs,
                              float* out, int B, int n, int K, int H, int sms,
                              cudaStream_t stream) {
  if (B < 1 || n < 1 || K < 1 || H < 1 || sms < 1 || idx_bs < 0 || val_bs < 0 || m_bs < 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = H % 4 == 0 && ((uintptr_t)M & 15) == 0 && m_bs % 4 == 0 &&
                    ((uintptr_t)out & 15) == 0;
  const int per = vec4 ? 4 : 1;
  // At least 8 lanes a row, so a chunk holds eight slots to gather at once.
  int G = 8;
  while (G < 32 && G * per < H) G *= 2;
  const long long warps = ((long long)B * n * G + 31) / 32;
  int wpc = 1;
  while (wpc < 8 && warps >= (long long)2 * wpc * 2 * (long long)sms) wpc *= 2;
  const long long grid = (warps + wpc - 1) / wpc;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (vec4)
    ell::ell_rows_kernel<4><<<(unsigned)grid, 32 * wpc, 0, stream>>>(
        idx, idx_bs, vals, val_bs, M, m_bs, out, B, n, K, H, G);
  else
    ell::ell_rows_kernel<1><<<(unsigned)grid, 32 * wpc, 0, stream>>>(
        idx, idx_bs, vals, val_bs, M, m_bs, out, B, n, K, H, G);
  return (int)cudaGetLastError();
}
