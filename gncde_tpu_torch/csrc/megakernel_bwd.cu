// K2: the fused backward of one vector-field eval of the perm-equiv field,
// on the undirected 8-term basis or the directed 11-term one, f32 planes
// (K2, K2d; the bf16 K2bf and K2dbf are megakernel_bwd_bf.cu).
//
// Replaces gncde_tpu/ops/pallas/megakernel_bwd.py (_make_bwd_kernel /
// bwd_call / bwd_call_batched, both values of its ``directed`` flag),
// which holds about 38 n^2 bytes per eval in
// one TensorCore's VMEM. Here the forward is recomputed by K1's own row
// pass on K1's plan (megakernel_common.cuh rows_kernel), so M_l and x_l
// are K1's bit for bit, keeping each layer's M and input x in device
// memory ((L, B, n, H) floats of scratch), then one sweep per layer walks
// the stack in reverse: bwd_sweep.cuh's, on a plan of its own per layer
// (ops/megakernel_bwd.py bwd_row_plan). Each CTA forms its rows of C^T and
// of the planes' values once a layer, M's and g's tiles come through a
// cp.async ring, and the basis cotangents are inner products of A, dA
// (ddA) with P = g M^T, so they come out as row dots instead of n x n
// products. dW, dlin_b, dnorm and the basis terms are written as per-CTA
// partial sums and reduced over CTAs in a second pass (deterministic, no
// atomics). The per-element parameter cotangents are summed over the batch
// by the wrapper, as the JAX side does.
//
// The directed basis (DIR) changes only O(n) terms: the recomputed forward
// reads the column sums of K1's directed prep pass, and the rank-term
// cotangents (p4 .. p6', megakernel_bwd.py:249-268) and the directed dtau
// chain (:292-302) are row dots against the column sums cA, cdA, cddA
// beside the row sums. The reduction vector's basis block grows from 16 to
// 22 entries.
#include "bwd_sweep.cuh"

using namespace mk;

// directed: the layers' basis is the (11, 2) directed stack (else (8, 2));
// planes float32. Mbuf, Xbuf: (L, B, n, ldm) scratch for the recomputed
// forward (Xbuf[0] unused: layer 0 reads Z), ldm >= every layer's width.
// gbuf: (L, B, n, ldm), gbuf[l] the masked cotangent of x_l for l >= 1
// (gbuf[0] unused: layer 0 writes dZ), so the caller can read every layer's
// inputs back. stats: (B, NSTAT, n). plan: host array of K1's row-pass plan
// per layer (bm, cc, groups; ops/megakernel.py row_plan), the forward
// recompute's; bplan: host array of the reverse sweep's plan per layer (bm,
// cc, groups; ops/megakernel_bwd.py bwd_row_plan). part: the layers'
// partial blocks (ops/megakernel_bwd.py bwd_layout), part_floats of them;
// work: the sweep's scratch for its layers of several column groups,
// work_floats (may be NULL when none has). red: (B, ptot) reduced
// per-element grads, layer blocks in order. dZ: (B, n, hin0).
extern "C" int gncde_mk_bwd(const void* d, const void* c, const void* b,
                            const void* a, long long plane_bstride,
                            const int* idx, const float* tau, const float* Z,
                            const float* G, int B, int n, int L,
                            const int* dims, const void* const* ptrs, const int* plan,
                            const int* bplan, int directed, int need_tau,
                            float* stats, float* Mbuf, float* Xbuf, float* gbuf, int ldm,
                            float* dZ, float* part, long long part_floats, float* work,
                            long long work_floats, int ptot, float* red,
                            cudaStream_t stream) {
  if (!bwd_dims_ok(B, n, L, dims, ldm, directed, ptot)) return (int)cudaErrorInvalidValue;
  const Planes<false> P{static_cast<const float*>(d), static_cast<const float*>(c),
                        static_cast<const float*>(b), static_cast<const float*>(a),
                        plane_bstride};
  if (directed)
    return mk_bwd<true, false>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                               stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                               work_floats, ptot, red, stream);
  return mk_bwd<false, false>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                              stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                              work_floats, ptot, red, stream);
}

// The dynamic shared memory, in bytes, of one reverse-sweep CTA of bm rows
// and cw columns on an H-wide layer, as the launch computes it
// (bwd_smem_floats; bf16: the bf16 sweep's, bwd_smem_bytes_bf): the
// planner's formula (ops/megakernel_bwd.py bwd_smem_bytes, same arguments)
// must agree with it (a card test checks).
extern "C" int gncde_bwd_smem_bytes(int n, int bm, int cw, int H, int tau, int bf16) {
  const int rw = rows_width(cw, H);
  return bf16 ? bwd_smem_bytes_bf(n, bm, rw, tau != 0)
              : 4 * bwd_smem_floats(n, bm, rw, tau != 0);
}
