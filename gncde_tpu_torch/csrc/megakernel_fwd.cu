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
#include "megakernel_common.cuh"

using namespace mk;

// ptrs: host array of 5 device pointers per layer (norm_w, norm_b, W, lin_b,
// basis); dims: host array of (hin, hout) per layer; directed: the basis
// is the (11, 2) directed stack (else (8, 2)). stats: (B, NSTAT, n). Mbuf
// holds two ping-pong (B, n, ldm) buffers of M, ldm >= every layer's
// width. Returns the first CUDA error.
template <bool DIR>
static int mk_fwd(const Planes& P, const int* idx, const float* tau, const float* Z,
                  int B, int n, int L, const int* dims, const void* const* ptrs,
                  float* stats, float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, B);
  const long long mstride = (long long)B * n * ldm;
  Layer l0 = layer_from(ptrs, dims, 0);
  prep_kernel<DIR><<<grid, NT, 0, stream>>>(P, idx, tau, n, Z, dims[0], l0, Mbuf, ldm,
                                            stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    Layer lp = layer_from(ptrs, dims, l);
    Layer ln = last ? lp : layer_from(ptrs, dims, l + 1);
    float* Mc = Mbuf + (l % 2) * mstride;
    float* Mn = Mbuf + ((l + 1) % 2) * mstride;
    fwd_rows_kernel<DIR><<<grid, NT, 0, stream>>>(
        P, idx, tau, n, stats, lp, Mc, ldm, last ? out : nullptr,
        dims[2 * l + 1], last ? 0 : 1, last ? 0 : 1, ln, Mn, ldm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int gncde_mk_fwd(const float* d, const float* c, const float* b,
                            const float* a, long long plane_bstride,
                            const int* idx, const float* tau, const float* Z,
                            int B, int n, int L, const int* dims,
                            const void* const* ptrs, int directed, float* stats,
                            float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm))
    return (int)cudaErrorInvalidValue;
  const Planes P{d, c, b, a, plane_bstride};
  if (directed)
    return mk_fwd<true>(P, idx, tau, Z, B, n, L, dims, ptrs, stats, Mbuf, ldm, out,
                        stream);
  return mk_fwd<false>(P, idx, tau, Z, B, n, L, dims, ptrs, stats, Mbuf, ldm, out,
                       stream);
}
