// K1: the forward vector-field kernel of the perm-equiv field, on the
// undirected 8-term basis or the directed 11-term one.
//
// Replaces the TPU megakernel gncde_tpu/ops/pallas/megakernel.py
// (_make_vf_body / _make_kernel / _forward_batched, both values of its
// ``directed`` flag). That kernel keeps one
// eval's whole n x n working set (about 24 n^2 bytes) in one TensorCore's
// VMEM. An SM has at most 227 KB of shared memory, and one element's four
// f32 planes at n = 400 are 2.56 MB, so here rows are split across CTAs
// (megakernel_common.cuh), 1 + L launches per eval: the prep pass on grid
// (ceil(n/16), B), then one row pass per layer (rows_kernel, on the
// layer's plan from ops/megakernel.py row_plan: 4-16 rows and 32-128
// output columns a CTA, so every shape the configs use runs at least 132
// CTAs).
//
// What bounds it on the card: operations by the count (the trade's 316
// MFLOP, 4.7 us at an H100's f32 peak, against 6.4 MB of planes, Z and
// output),
// the latency of each CTA's chain in practice. Each layer's row pass forms
// its rows of C = B1 + B2^T from the four planes once (8 plane reads per
// element of C: the row and the transposed column), about 32 n^2 bytes
// per element per layer, mostly from L2 (one batch's planes, B x 2.56 MB
// at n = 400, fit in the 50 MB L2). A, dA and A_bar never reach device
// memory; the matmuls are f32 FMA on a register micro-tile, M streamed
// through a cp.async ring. The first version of the row pass (fwd_rows,
// which only the design probes still run) regenerated C's tiles for every
// 64-column chunk, on 16-row CTAs, with no copy pipeline: 0.69 ms a trade
// eval (NVIDIA H100 80GB HBM3, 700.00 W). The directed basis adds
// one sweep over the planes in the prep pass, for the column sums (each
// CTA owns the columns with its rows' indices), and O(n) work per row.
//
// K1bf (``bf16``): the same passes on bfloat16 planes (half the bytes of
// the only O(n^2) reads) and the same plans (row_plan with bf16, its own
// shared memory), each layer's rows_bf_kernel forming B1 and B2^T in bf16
// once and running the two n x n products on the tensor cores with JAX's
// bf16 rounding points (megakernel_common.cuh, BF). It is bound by bytes:
// 4 n H bf16 FLOPs per element of C are far below the card's 295 FLOP per
// byte; in practice, like K1, by each CTA's serial chain (the plane reads
// and forming, the ring).
#include "megakernel_common.cuh"

using namespace mk;

template <bool BF>
static int mk_fwd_basis(const void* d, const void* c, const void* b, const void* a,
                        long long bstride, const int* idx, const float* tau,
                        const float* Z, int B, int n, int L, const int* dims,
                        const void* const* ptrs, const int* plan, int directed,
                        float* stats, float* Mbuf, int ldm, float* out,
                        cudaStream_t stream) {
  using T = typename Planes<BF>::T;
  const Planes<BF> P{static_cast<const T*>(d), static_cast<const T*>(c),
                     static_cast<const T*>(b), static_cast<const T*>(a), bstride};
  if (directed)
    return mk_fwd<true, BF>(P, idx, tau, Z, B, n, L, dims, ptrs, plan, stats, Mbuf, ldm, out,
                            stream);
  return mk_fwd<false, BF>(P, idx, tau, Z, B, n, L, dims, ptrs, plan, stats, Mbuf, ldm, out,
                           stream);
}

// ptrs: host array of 5 device pointers per layer (norm_w, norm_b, W, lin_b,
// basis); dims: host array of (hin, hout) per layer; directed: the basis
// is the (11, 2) directed stack (else (8, 2)). stats: (B, NSTAT, n). Mbuf
// holds L (B, n, ldm) buffers, layer l's M in the l-th (ldm >= every
// layer's width), so the caller can read each layer's M back (mk::mk_fwd).
// Planes d, c, b, a: float32, or bfloat16 when bf16 (K1bf). plan: host
// array of (bm, cc, groups) per layer, the row pass's launch plan
// (ops/megakernel.py row_plan).
extern "C" int gncde_mk_fwd(const void* d, const void* c, const void* b,
                            const void* a, long long plane_bstride,
                            const int* idx, const float* tau, const float* Z,
                            int B, int n, int L, const int* dims,
                            const void* const* ptrs, const int* plan, int directed, int bf16,
                            float* stats, float* Mbuf, int ldm, float* out,
                            cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm) || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return mk_fwd_basis<true>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs,
                              plan, directed, stats, Mbuf, ldm, out, stream);
  return mk_fwd_basis<false>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs,
                             plan, directed, stats, Mbuf, ldm, out, stream);
}

// Dynamic shared memory of one row-pass CTA on plan (bm, cw) of an H-wide
// layer, in bytes (megakernel_common.cuh rows_smem_bytes; bf16: the bf16
// pass's): the planner's formula (ops/megakernel.py row_smem_bytes, same
// arguments) must agree with it (a card test checks).
extern "C" int gncde_row_smem_bytes(int n, int bm, int cw, int H, int bf16) {
  return rows_smem_bytes(bf16 != 0, n, bm, cw, H);
}
