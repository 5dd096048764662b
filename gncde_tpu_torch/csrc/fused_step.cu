// K11: one explicit FSAL Runge-Kutta step of the undirected perm-equiv
// field in one cooperative launch.
//
// Replaces gncde_tpu/ops/pallas/fused_step.py (_make_step_kernel /
// _step_call): one pallas_call per solver step, grid (batch, stages), the
// stage derivatives k_1 .. k_S in VMEM. On the TPU that grid runs in order
// on one core. Here the vf eval of each stage is K1's row pass split over
// CTAs (megakernel_common.cuh): grid (ceil(n / BM), B), each CTA owning BM
// rows of one batch element, and the phases that need every row of the
// previous one are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()). Per stage s (0-based, the
// tableau's stage s + 1):
//
//   1. the CTA's rows of the stage input  Yi = y + h sum_{j<=s} a[s][j] k_j
//      (k_0 = f0; row-local: a CTA reads only its own rows of the k's,
//      which it wrote itself);
//   2. prep_rows at (idx[b, s], tau[b, s]): the row statistics and layer
//      0's M rows;                                          -- grid sync --
//   3. L x fwd_rows (each layer reads every row of the previous M); the
//      last writes the CTA's rows of k_{s+1} into ks[b, s]. -- grid sync
//      after each layer (the next stage's prep overwrites the statistics
//      that the last layer still reads in other CTAs) --
//
// and after the last stage the row-local y1 = y + h sum_j b_j k_j,
// err = h sum_j e_j k_j and f1 = k_S. The tableau rows are kernel
// arguments, so one build serves Tsit5, Dopri5 and Bosh3.
//
// The stage combinations are formed in the per-stage solver's order (terms
// in stage order, every product and sum rounded once: __fmul_rn / __fadd_rn,
// no contraction), and each vf eval is K1's arithmetic (the same device
// functions), so a step follows the per-stage K1 route closely. No atomics:
// every output element is written by one thread in a fixed order, so two
// launches are bitwise equal, as the checkpointed adjoint's recomputation
// of a step needs. One code path writes ks whether or not the caller
// differentiates. Stage s reads only the slots k_1 .. k_s, which it has
// written (an explicit tableau's a[s][j] vanishes for j > s), so no unset
// slot, and no 0 * inf, reaches a stage input; the TPU kernel zeroes its
// VMEM scratch for the same reason.
//
// What bounds it on the card: per stage and layer it regenerates its tiles
// of C from the four planes (one element's planes are 2.56 MB at n = 400,
// so the re-reads after the first mostly hit L2) and does 4 n^2 H FLOPs
// per element in f32 FMA; the least time is set by the S L (4 n^2 H) f32
// FLOPs per element, not by the one read of the planes. The cooperative
// launch needs every CTA resident (256 threads, about 21 KB of static
// shared memory a CTA): gncde_fused_step_capacity gives how many fit, and
// the wrapper launches the batch in chunks that do.
#include <cooperative_groups.h>

#include "megakernel_common.cuh"

namespace cg = cooperative_groups;
using namespace mk;

namespace fs {

constexpr int SMAX = 8;  // most evaluated stages (Tsit5, Dopri5: 6; Bosh3: 3)
constexpr int LMAX = 8;  // most layers

struct StepArgs {
  Planes P;
  const int* idx;    // (B, S) interval of each stage's node
  const float* tau;  // (B, S) offset into it
  const float* h;    // (B,)
  const float* y;    // (B, n, H)
  const float* f0;   // (B, n, H)
  float a[SMAX][SMAX];  // a[s][j]: weight of k_j (k_0 = f0) in stage s's input
  float bw[SMAX + 1];   // solution weights of k_0 .. k_S
  float ew[SMAX + 1];   // error weights of k_0 .. k_S
  Layer layers[LMAX];
  int S, n, H, L, ldm;
  int b0;        // first batch element of this launch (blockIdx.y offset)
  int Btot;      // batch size of the buffers
  float* stats;  // (B, 6, n)
  float* Mbuf;   // (2, B, n, ldm)
  float* Yi;     // (B, n, H) stage input
  float* ks;     // (B, S, n, H): k_1 .. k_S
  float* y1;     // (B, n, H)
  float* err;
  float* f1;
};

__global__ void __launch_bounds__(NT) step_kernel(const StepArgs A) {
  cg::grid_group grid = cg::this_grid();
  const int b = A.b0 + blockIdx.y, r0 = blockIdx.x * BM;
  const int n = A.n, H = A.H, S = A.S, L = A.L;
  const long long nH = (long long)n * H;
  const long long mhalf = (long long)A.Btot * n * A.ldm;  // one M buffer
  // This CTA's rows of the (n, H) operands of element b: elements
  // own .. own + cnt - 1 of each.
  const long long own = (long long)b * nH + (long long)r0 * H;
  const int cnt = (min(r0 + BM, n) - r0) * H;
  const float* y = A.y + own;
  const float* f0 = A.f0 + own;
  float* Yi = A.Yi + own;
  float* kown = A.ks + (long long)b * S * nH + (long long)r0 * H;  // slot 0
  const float hb = __ldg(A.h + b);

  for (int s = 0; s < S; ++s) {
    // 1. The stage input, own rows.
    for (int e = threadIdx.x; e < cnt; e += NT) {
      float acc = __fmul_rn(A.a[s][0], f0[e]);
      for (int j = 1; j <= s; ++j)
        acc = __fadd_rn(acc, __fmul_rn(A.a[s][j], kown[(j - 1) * nH + e]));
      Yi[e] = __fadd_rn(y[e], __fmul_rn(hb, acc));
    }
    __syncthreads();
    // 2. Statistics and layer 0's M rows at the stage's node.
    const long long base =
        (long long)b * A.P.bstride + (long long)__ldg(A.idx + b * S + s) * n * n;
    const float t = __ldg(A.tau + b * S + s);
    prep_rows(A.P, base, t, b, r0, n, A.Yi, H, A.layers[0], A.Mbuf, A.ldm, A.stats);
    grid.sync();
    // 3. The layer stack. fwd_rows stores row gi of element b at
    // F + (b n + gi) ldf, so F is shifted to land in slot s of ks.
    for (int l = 0; l < L; ++l) {
      const bool last = l == L - 1;
      float* F = last ? A.ks + ((long long)b * (S - 1) + s) * nH : nullptr;
      fwd_rows(A.P, base, t, b, r0, n, A.stats, A.layers[l], A.Mbuf + (l % 2) * mhalf,
               A.ldm, F, H, last ? 0 : 1, last ? 0 : 1, A.layers[last ? l : l + 1],
               A.Mbuf + ((l + 1) % 2) * mhalf, A.ldm);
      grid.sync();
    }
  }

  // The step's outputs, own rows; k_S is slot S - 1.
  float* y1 = A.y1 + own;
  float* err = A.err + own;
  float* f1 = A.f1 + own;
  for (int e = threadIdx.x; e < cnt; e += NT) {
    const float k0 = f0[e];
    float bacc = __fmul_rn(A.bw[0], k0), eacc = __fmul_rn(A.ew[0], k0);
    for (int j = 1; j <= S; ++j) {
      const float kj = kown[(j - 1) * nH + e];
      bacc = __fadd_rn(bacc, __fmul_rn(A.bw[j], kj));
      eacc = __fadd_rn(eacc, __fmul_rn(A.ew[j], kj));
    }
    y1[e] = __fadd_rn(y[e], __fmul_rn(hb, bacc));
    err[e] = __fmul_rn(hb, eacc);
    f1[e] = kown[(S - 1) * nH + e];
  }
}

}  // namespace fs

using namespace fs;

// How many CTAs of step_kernel can be resident at once on the current
// device (blocks per SM times SMs); 0 on error.
extern "C" int gncde_fused_step_capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_kernel, NT, 0) !=
      cudaSuccess)
    return 0;
  return per_sm * sms;
}

// One step for batch elements b0 .. b0 + nb - 1 (one cooperative launch,
// grid (ceil(n / BM), nb)). Buffers are sized for the whole batch Btot.
// amat: host (S, S) row-major; bvec, berr: host (S + 1); dims, ptrs: host
// arrays as for K1. Returns the first CUDA error.
extern "C" int gncde_fused_step(const float* d, const float* c, const float* b,
                                const float* a, long long plane_bstride, const int* idx,
                                const float* tau, const float* h, const float* y,
                                const float* f0, int Btot, int b0, int nb, int n, int S,
                                const float* amat, const float* bvec, const float* berr,
                                int L, const int* dims, const void* const* ptrs,
                                float* stats, float* Mbuf, int ldm, float* Yi, float* ks,
                                float* y1, float* err, float* f1, cudaStream_t stream) {
  if (L < 1 || L > LMAX || S < 1 || S > SMAX || nb < 1 || b0 < 0 || b0 + nb > Btot ||
      n < 1 || !dims_ok(dims, L, ldm))
    return (int)cudaErrorInvalidValue;
  const int H = dims[0];
  if (dims[2 * L - 1] != H) return (int)cudaErrorInvalidValue;  // k and y alike
  StepArgs A;
  A.P = Planes{d, c, b, a, plane_bstride};
  A.idx = idx;
  A.tau = tau;
  A.h = h;
  A.y = y;
  A.f0 = f0;
  for (int s = 0; s < SMAX; ++s)
    for (int j = 0; j < SMAX; ++j) A.a[s][j] = (s < S && j < S) ? amat[s * S + j] : 0.f;
  for (int j = 0; j <= SMAX; ++j) {
    A.bw[j] = j <= S ? bvec[j] : 0.f;
    A.ew[j] = j <= S ? berr[j] : 0.f;
  }
  for (int l = 0; l < L; ++l) A.layers[l] = layer_from(ptrs, dims, l);
  A.S = S;
  A.n = n;
  A.H = H;
  A.L = L;
  A.ldm = ldm;
  A.b0 = b0;
  A.Btot = Btot;
  A.stats = stats;
  A.Mbuf = Mbuf;
  A.Yi = Yi;
  A.ks = ks;
  A.y1 = y1;
  A.err = err;
  A.f1 = f1;
  void* args[] = {&A};
  const dim3 grid((n + BM - 1) / BM, nb);
  cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)step_kernel, grid, dim3(NT), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
