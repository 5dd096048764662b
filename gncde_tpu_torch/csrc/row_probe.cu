// The row pass's design probes (tools/kernel_times_torch.py K1-ablation
// and K1bf-ablation): K1 (csrc/megakernel_fwd.cu) on the undirected basis
// with every row pass instantiated with the RowProbe bits ``probe``
// (csrc/megakernel_common.cuh): bits 1-32 drop parts of its work (the
// outputs are then wrong), RP_TF32 takes the products as 3xTF32 mma.sync;
// and K1bf on bf16 planes with bits 1-32 (gncde_mk_fwd_bf16_probe). Only the
// bit sets below are built; any other, a directed basis or (f32) a plan
// with cc = 2 is refused. Kept apart from megakernel_fwd.cu so that the main
// path's library builds none of these instantiations.
#include "megakernel_common.cuh"

using namespace mk;

template <int PROBE>
static int run_bf16(const void* d, const void* c, const void* b, const void* a,
                    long long bstride, const int* idx, const float* tau, const float* Z, int B,
                    int n, int L, const int* dims, const void* const* ptrs, const int* plan,
                    float* stats, float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  const Planes<true> P{static_cast<const bf16*>(d), static_cast<const bf16*>(c),
                       static_cast<const bf16*>(b), static_cast<const bf16*>(a), bstride};
  return mk_fwd<false, true, PROBE>(P, idx, tau, Z, B, n, L, dims, ptrs, plan, stats, Mbuf,
                                    ldm, out, stream);
}

template <int PROBE>
static int run(const void* d, const void* c, const void* b, const void* a, long long bstride,
               const int* idx, const float* tau, const float* Z, int B, int n, int L,
               const int* dims, const void* const* ptrs, const int* plan, float* stats,
               float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  const Planes<false> P{static_cast<const float*>(d), static_cast<const float*>(c),
                        static_cast<const float*>(b), static_cast<const float*>(a), bstride};
  return mk_fwd<false, false, PROBE>(P, idx, tau, Z, B, n, L, dims, ptrs, plan, stats, Mbuf,
                                     ldm, out, stream);
}

extern "C" int gncde_mk_fwd_probe(const void* d, const void* c, const void* b,
                                  const void* a, long long plane_bstride, const int* idx,
                                  const float* tau, const float* Z, int B, int n, int L,
                                  const int* dims, const void* const* ptrs, const int* plan,
                                  int directed, float* stats, float* Mbuf, int ldm,
                                  float* out, int probe, cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm) || plan == nullptr || directed)
    return (int)cudaErrorInvalidValue;
#define GNCDE_ROW_PROBE(BITS)                                                                \
  case BITS:                                                                                 \
    return run<BITS>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs, plan,      \
                     stats, Mbuf, ldm, out, stream);
  switch (probe) {
    GNCDE_ROW_PROBE(RP_NO_PLANES)
    GNCDE_ROW_PROBE(RP_NO_FORM)
    GNCDE_ROW_PROBE(RP_NO_PRODUCT)
    GNCDE_ROW_PROBE(RP_NO_RING)
    GNCDE_ROW_PROBE(RP_NO_COLSUM)
    GNCDE_ROW_PROBE(RP_NO_NEXT)
    GNCDE_ROW_PROBE(RP_NO_FORM | RP_NO_PRODUCT | RP_NO_COLSUM | RP_NO_NEXT)
    GNCDE_ROW_PROBE(63)
    GNCDE_ROW_PROBE(RP_TF32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNCDE_ROW_PROBE
}

// gncde_mk_fwd_probe's arguments on bf16 planes: K1bf's passes with the
// RowProbe bits ``probe`` (1-32; the sets below).
extern "C" int gncde_mk_fwd_bf16_probe(const void* d, const void* c, const void* b,
                                       const void* a, long long plane_bstride, const int* idx,
                                       const float* tau, const float* Z, int B, int n, int L,
                                       const int* dims, const void* const* ptrs,
                                       const int* plan, int directed, float* stats,
                                       float* Mbuf, int ldm, float* out, int probe,
                                       cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm) || plan == nullptr || directed)
    return (int)cudaErrorInvalidValue;
#define GNCDE_ROW_PROBE(BITS)                                                                \
  case BITS:                                                                                 \
    return run_bf16<BITS>(d, c, b, a, plane_bstride, idx, tau, Z, B, n, L, dims, ptrs, plan, \
                          stats, Mbuf, ldm, out, stream);
  switch (probe) {
    GNCDE_ROW_PROBE(RP_NO_PLANES)
    GNCDE_ROW_PROBE(RP_NO_FORM)
    GNCDE_ROW_PROBE(RP_NO_PRODUCT)
    GNCDE_ROW_PROBE(RP_NO_RING)
    GNCDE_ROW_PROBE(RP_NO_COLSUM)
    GNCDE_ROW_PROBE(RP_NO_NEXT)
    GNCDE_ROW_PROBE(RP_NO_FORM | RP_NO_PRODUCT | RP_NO_COLSUM | RP_NO_NEXT)
    GNCDE_ROW_PROBE(63)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNCDE_ROW_PROBE
}
