// The f32 reverse sweep's design probes (tools/kernel_times_torch.py
// K2-ablation): K2 (csrc/megakernel_bwd.cu) on the undirected basis,
// without dtau, with every sweep launch instantiated with the BwdProbe bits
// ``probe`` (csrc/bwd_sweep.cuh): each drops parts of its work (the
// cotangents are then wrong). Only the bit sets below are built; any other,
// the directed basis or a plan with cc = 2 is refused. Kept apart from
// megakernel_bwd.cu so that the main path's library builds none of these
// instantiations.
#include "bwd_sweep.cuh"

using namespace mk;

extern "C" int gncde_mk_bwd_probe(const void* d, const void* c, const void* b, const void* a,
                                  long long plane_bstride, const int* idx, const float* tau,
                                  const float* Z, const float* G, int B, int n, int L,
                                  const int* dims, const void* const* ptrs, const int* plan,
                                  const int* bplan, float* stats, float* Mbuf, float* Xbuf,
                                  float* gbuf, int ldm, float* dZ, float* part,
                                  long long part_floats, float* work, long long work_floats,
                                  int ptot, float* red, int probe, cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm)) return (int)cudaErrorInvalidValue;
  const Planes<false> P{static_cast<const float*>(d), static_cast<const float*>(c),
                        static_cast<const float*>(b), static_cast<const float*>(a),
                        plane_bstride};
#define GNCDE_BWD_PROBE(BITS)                                                                \
  case BITS:                                                                                 \
    return mk_bwd<false, false, BITS>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan,  \
                                      0, stats, Mbuf, Xbuf, gbuf, ldm, dZ, part,            \
                                      part_floats, work, work_floats, ptot, red, stream);
  switch (probe) {
    GNCDE_BWD_PROBE(BP_NO_PLANES)
    GNCDE_BWD_PROBE(BP_NO_FORM)
    GNCDE_BWD_PROBE(BP_NO_PRODUCT)
    GNCDE_BWD_PROBE(BP_NO_RING)
    GNCDE_BWD_PROBE(BP_NO_COLSUM)
    GNCDE_BWD_PROBE(BP_NO_FORM | BP_NO_PRODUCT | BP_NO_COLSUM)
    GNCDE_BWD_PROBE(31)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNCDE_BWD_PROBE
}
