// The bf16 reverse sweep's design probes (tools/kernel_times_torch.py
// K2bf-ablation): K2bf (csrc/megakernel_bwd_bf.cu) on the undirected basis,
// without dtau, with every sweep launch instantiated with the BwdProbe bits
// ``probe`` (csrc/bwd_sweep.cuh): each drops parts of its work (the
// cotangents are then wrong). Only the bit sets below are built; any other,
// or the directed basis, is refused. Kept apart from megakernel_bwd_bf.cu
// so that the main path's library builds none of these instantiations.
#include "bwd_sweep.cuh"

using namespace mk;

extern "C" int gncde_mk_bwd_bf16_probe(const void* d, const void* c, const void* b,
                                       const void* a, long long plane_bstride,
                                       const int* idx, const float* tau, const float* Z,
                                       const float* G, int B, int n, int L, const int* dims,
                                       const void* const* ptrs, const int* bplan,
                                       float* stats, float* Mbuf, float* Xbuf, float* gbuf,
                                       int ldm, float* dZ, float* part, long long part_floats,
                                       float* work, long long work_floats, int ptot,
                                       float* red, int probe, cudaStream_t stream) {
  if (!bwd_dims_ok(B, n, L, dims, ldm, 0, ptot)) return (int)cudaErrorInvalidValue;
  const Planes<true> P{static_cast<const bf16*>(d), static_cast<const bf16*>(c),
                       static_cast<const bf16*>(b), static_cast<const bf16*>(a),
                       plane_bstride};
#define GNCDE_BWD_BF_PROBE(BITS)                                                             \
  case BITS:                                                                                 \
    return mk_bwd<false, true, BITS>(P, idx, tau, Z, G, B, n, L, dims, ptrs, nullptr, bplan, \
                                     0, stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, \
                                     work, work_floats, ptot, red, stream);
  switch (probe) {
    GNCDE_BWD_BF_PROBE(BP_NO_PLANES)
    GNCDE_BWD_BF_PROBE(BP_NO_FORM)
    GNCDE_BWD_BF_PROBE(BP_NO_PRODUCT)
    GNCDE_BWD_BF_PROBE(BP_NO_RING)
    GNCDE_BWD_BF_PROBE(BP_NO_COLSUM)
    GNCDE_BWD_BF_PROBE(31)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNCDE_BWD_BF_PROBE
}
