// K2bf and K2dbf: K2 under fusion_precision bf16, on bf16 planes, either
// basis (megakernel_bwd.cu is the f32 K2, K2d).
//
// Replaces gncde_tpu/ops/pallas/megakernel_bwd.py _make_bwd_kernel(bf16=True)
// (its mm_dtype: the products of bf16 operands) behind bwd_call /
// bwd_call_batched, both values of its ``directed`` flag. What it computes
// is ops/megakernel_bwd.py plain_vf_bwd_bf16: the forward recomputed as
// K1bf computes it; per layer C^T formed in bf16 (each product and sum
// rounded), dM's product C^T gb and the basis cotangents' P = gb Mb^T of the
// bf16-rounded g and M on the tensor cores, the basis dots against the
// planes' f32 values; everything else f32.
//
// Launches: K1bf's prep pass and its bf16 row pass rows_bf_kernel per layer
// but the last, on K1bf's plan (megakernel_common.cuh rows_body,
// ops/megakernel.py row_plan with bf16), so M_l and x_l are K1bf's bit for
// bit; then per
// layer in reverse the bf16 instantiation of bwd_sweep.cuh's sweep
// (bwd_sweep_bf_kernel) on the layer's plan (ops/megakernel_bwd.py
// bwd_row_plan with bf16), its finish for a layer of several column groups,
// and the reduction. What bounds it on the card: each sweep CTA's serial
// chain (the forming of its rows' operands from the bf16 planes, the ring,
// the tiles' rounding); the products are a few mma.sync a warp per tile, and
// the bytes (the bf16 planes once, M and g) are microseconds at 3.35 TB/s.
#include "bwd_sweep.cuh"

using namespace mk;

// gncde_mk_bwd's arguments on bf16 planes; plan: K1bf's row plans (the
// recompute's).
extern "C" int gncde_mk_bwd_bf16(const void* d, const void* c, const void* b, const void* a,
                                 long long plane_bstride, const int* idx, const float* tau,
                                 const float* Z, const float* G, int B, int n, int L,
                                 const int* dims, const void* const* ptrs, const int* plan,
                                 const int* bplan, int directed, int need_tau, float* stats,
                                 float* Mbuf, float* Xbuf, float* gbuf, int ldm, float* dZ,
                                 float* part, long long part_floats, float* work,
                                 long long work_floats, int ptot, float* red,
                                 cudaStream_t stream) {
  if (!bwd_dims_ok(B, n, L, dims, ldm, directed, ptot)) return (int)cudaErrorInvalidValue;
  const Planes<true> P{static_cast<const bf16*>(d), static_cast<const bf16*>(c),
                       static_cast<const bf16*>(b), static_cast<const bf16*>(a),
                       plane_bstride};
  if (directed)
    return mk_bwd<true, true>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                              stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                              work_floats, ptot, red, stream);
  return mk_bwd<false, true>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                             stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                             work_floats, ptot, red, stream);
}
