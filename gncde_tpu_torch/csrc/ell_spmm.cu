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
// One thread per output entry (b, r, c), threads in c-fastest order, so the
// threads of one row read the row's K indices and values once each
// (broadcast within the warp) and gather M[indices[r, k], :] as one
// coalesced row segment. The (n, K, H) gathered intermediate of the XLA
// formulation never exists. Padding slots (index == n, or anything outside
// [0, n)) are skipped: M is not padded with a zero row. Each output is
// summed over k in slot order by one thread, so the result is bitwise
// repeatable.
//
// What bounds it on the card: bytes. Per output row it moves K indices and
// values (8 K bytes), K gathered rows of M (4 K H bytes, mostly from the
// 50 MB L2: each row of M is gathered by about K rows) and one row written,
// against 2 K H flops; far below the card's 20 flops per byte.
#include <cuda_runtime.h>

namespace ell {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
ell_spmm_kernel(const int* __restrict__ idx, long long idx_bs,
                const float* __restrict__ vals, long long val_bs,
                const float* __restrict__ M, long long m_bs,
                float* __restrict__ out, int B, int n, int K, int H) {
  const long long per_b = (long long)n * H;
  const long long total = per_b * B;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < total;
       e += (long long)gridDim.x * NT) {
    const int b = (int)(e / per_b);
    const long long rc = e - (long long)b * per_b;
    const int r = (int)(rc / H);
    const int c = (int)(rc - (long long)r * H);
    const int* ir = idx + b * idx_bs + (long long)r * K;
    const float* vr = vals + b * val_bs + (long long)r * K;
    const float* Mb = M + b * m_bs;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = __ldg(ir + k);
      if (j >= 0 && j < n) acc = fmaf(__ldg(vr + k), __ldg(Mb + (long long)j * H + c), acc);
    }
    out[e] = acc;
  }
}

}  // namespace ell

extern "C" int gncde_ell_spmm(const int* idx, long long idx_bs, const float* vals,
                              long long val_bs, const float* M, long long m_bs,
                              float* out, int B, int n, int K, int H,
                              cudaStream_t stream) {
  if (B < 1 || n < 1 || K < 1 || H < 1 || idx_bs < 0 || val_bs < 0 || m_bs < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * n * H;
  const long long blocks = (total + ell::NT - 1) / ell::NT;
  const int grid = (int)(blocks < 1048576 ? blocks : 1048576);
  ell::ell_spmm_kernel<<<grid, ell::NT, 0, stream>>>(idx, idx_bs, vals, val_bs, M, m_bs,
                                                      out, B, n, K, H);
  return (int)cudaGetLastError();
}
