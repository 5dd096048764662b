// K1: the forward vector-field kernel of the perm-equiv field, on the
// undirected 8-term basis or the directed 11-term one.
//
// Replaces the TPU megakernel gncde_tpu/ops/pallas/megakernel.py
// (_make_vf_body / _make_kernel / _forward_batched, both values of its
// ``directed`` flag). That kernel keeps one
// eval's whole n x n working set (about 24 n^2 bytes) in one TensorCore's
// VMEM. An SM has at most 227 KB of shared memory, and one element's four
// f32 planes at n = 400 are 2.56 MB, so here rows are split across CTAs
// (megakernel_common.cuh): grid (ceil(n/16), B), 1 + L launches per eval.
//
// What bounds it on the card: bytes. Each layer's row pass regenerates its
// tiles of C = B1 + B2^T from the four planes (8 plane reads per element of
// C: the row tile and the transposed column tile), about 32 n^2 bytes per
// element per layer, against 4 n H FLOPs per element of C. One batch's
// planes (B x 2.56 MB at n = 400) fit in the 50 MB L2, so the re-reads of
// later layers mostly hit L2. A, dA and A_bar never reach device memory; the
// matmuls are f32 FMA from shared memory (tensor cores are later work).
// The directed basis adds one sweep over the planes in the prep pass, for
// the column sums (each CTA owns the columns with its rows' indices), and
// O(n) work per row.
//
// K1bf (``bf16``): the same passes on bfloat16 planes (half the bytes of
// the only O(n^2) reads), the two n x n products per layer on the tensor
// cores with JAX's bf16 rounding points (megakernel_common.cuh, BF). It is
// bound by bytes as K1 is: 4 n H bf16 FLOPs per element of C are far below
// the card's 295 FLOP per byte, and the tile regeneration, not the
// products, takes its time.
#include "megakernel_common.cuh"

using namespace mk;

// ptrs: host array of 5 device pointers per layer (norm_w, norm_b, W, lin_b,
// basis); dims: host array of (hin, hout) per layer; directed: the basis
// is the (11, 2) directed stack (else (8, 2)). stats: (B, NSTAT, n). Mbuf
// holds L (B, n, ldm) buffers, layer l's M in the l-th (ldm >= every
// layer's width), so the caller can read each layer's M back. Returns the
// first CUDA error.
template <bool DIR, bool BF>
static int mk_fwd(const Planes<BF>& P, const int* idx, const float* tau, const float* Z,
                  int B, int n, int L, const int* dims, const void* const* ptrs,
                  float* stats, float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, B);
  const long long mstride = (long long)B * n * ldm;
  Layer l0 = layer_from(ptrs, dims, 0);
  prep_kernel<DIR, BF><<<grid, NT, 0, stream>>>(P, idx, tau, n, Z, dims[0], l0, Mbuf,
                                                ldm, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    Layer lp = layer_from(ptrs, dims, l);
    Layer ln = last ? lp : layer_from(ptrs, dims, l + 1);
    float* Mc = Mbuf + l * mstride;
    float* Mn = last ? nullptr : Mbuf + (l + 1) * mstride;
    fwd_rows_kernel<DIR, BF><<<grid, NT, 0, stream>>>(
        P, idx, tau, n, stats, lp, Mc, ldm, last ? out : nullptr,
        dims[2 * l + 1], last ? 0 : 1, last ? 0 : 1, ln, Mn, ldm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <bool BF>
static int mk_fwd_basis(const void* d, const void* c, const void* b, const void* a,
                        long long bstride, const int* idx, const float* tau,
                        const float* Z, int B, int n, int L, const int* dims,
                        const void* const* ptrs, int directed, float* stats, float* Mbuf,
                        int ldm, float* out, cudaStream_t stream) {
  using T = typename Planes<BF>::T;
  const Planes<BF> P{static_cast<const T*>(d), static_cast<const T*>(c),
                     static_cast<const T*>(b), static_cast<const T*>(a), bstride};
  if (directed)
    return mk_fwd<true, BF>(P, idx, tau, Z, B, n, L, dims, ptrs, stats, Mbuf, ldm, out,
                            stream);
  return mk_fwd<false, BF>(P, idx, tau, Z, B, n, L, dims, ptrs, stats, Mbuf, ldm, out,
                           stream);
}

// Planes d, c, b, a: float32, or bfloat16 when bf16 (K1bf).
extern "C" int gncde_mk_fwd(const void* d, const void* c, const void* b,
                            const void* a, long long plane_bstride,
                            const int* idx, const float* tau, const float* Z,
                            int B, int n, int L, const int* dims,
                            const void* const* ptrs, int directed, int bf16,
                            float* stats, float* Mbuf, int ldm, float* out,
                            cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return mk_fwd_basis<true>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs,
                              directed, stats, Mbuf, ldm, out, stream);
  return mk_fwd_basis<false>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs,
                             directed, stats, Mbuf, ldm, out, stream);
}
