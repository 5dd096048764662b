// K7: the enc_idx per-edge MLP modulation of both planes, in one pass.
//
// Replaces the TPU kernel gncde_tpu/ops/pallas/modulate.py (_mod_kernel /
// modulate_pair), with out_dtype f32 (K7) or bf16 (K7bf, under
// fusion_precision bf16: models/vector_fields/fields.py). For every element (b, i, j) and each plane X of (A, dA),
// with that plane's MLP of width W (a template parameter, compiled for the
// reference's 8):
//
//   r_c = relu(((wa_c X + Ei[i, c]) + Ej[c, j]) + b1_c)      c < W
//   (depth - 1) x  r_v = relu(hb_v + sum_c hw[v, c] r_c)
//   out = ob + sum_c ow_c r_c
//
// Ei (n, 2W) holds both MLPs' node-i terms side by side, Ej (2W, n) their
// node-j terms; both come from two small products outside the kernel
// (ops/modulate.py). The chain runs in f32 for either output type; K7bf
// rounds each output once to bf16 (__float2bfloat16_rn), as the TPU
// kernel's store does (outA_ref[:] = oA.astype(out_dtype)).
//
// Layout. Planes (B, n, n) f32, unpadded. One CTA of NT threads owns NT
// consecutive columns j of one row i of one batch element (grid
// (ceil(n / NT), n, B)); each thread evaluates both planes' chains for its
// element in registers and writes both outputs. Both planes' weights and
// the row's Ei terms are staged in shared memory once per CTA (dynamic,
// sized by the depth); Ej is read per column, coalesced. No reductions
// across threads, so the result is bitwise repeatable.
//
// What bounds it on the card: at width 8 and depth 2 each element costs
// about 184 f32 operations per plane against 8 bytes moved per plane (one
// read, one write), so arithmetic and memory are about equal. This first
// version is plain FMA in registers, one element per thread; it keeps the
// planes' one read and one write, which is the floor for the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace md {

constexpr int NT = 256;

// Floats of one MLP's packed weights: [wa W | b1 W | (hw W W | hb W) x
// (depth-1) | ow W | ob].
template <int W>
__host__ __device__ constexpr int wstride(int depth) {
  return 3 * W + 1 + (depth - 1) * (W * W + W);
}

// One plane's chain for one element. p: that MLP's packed weights; ei: the
// row's W node-i terms; Ej: that MLP's (W, n) node-j terms.
template <int W>
__device__ __forceinline__ float chain(float x, const float* p, const float* ei,
                                       const float* __restrict__ Ej, int n, int j,
                                       int depth) {
  const float* wa = p;
  const float* b1 = p + W;
  float r[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    // ((wa X + Ei) + Ej) + b1, each rounded, as the plain version adds them.
    const float z = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(wa[c], x), ei[c]), __ldg(Ej + (long long)c * n + j)),
        b1[c]);
    r[c] = fmaxf(z, 0.f);
  }
  const float* hl = p + 2 * W;
  for (int l = 0; l < depth - 1; ++l, hl += W * W + W) {
    float h[W];
#pragma unroll
    for (int v = 0; v < W; ++v) {
      float acc = hl[W * W + v];
#pragma unroll
      for (int c = 0; c < W; ++c) acc = fmaf(hl[v * W + c], r[c], acc);
      h[v] = fmaxf(acc, 0.f);
    }
#pragma unroll
    for (int v = 0; v < W; ++v) r[v] = h[v];
  }
  float out = hl[W];  // ob, after ow
#pragma unroll
  for (int c = 0; c < W; ++c) out = fmaf(hl[c], r[c], out);
  return out;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int W, typename OT>
__global__ void __launch_bounds__(NT)
modulate_kernel(const float* __restrict__ A, const float* __restrict__ dA, int n,
                int depth, const float* __restrict__ wts, const float* __restrict__ Ei,
                const float* __restrict__ Ej, OT* __restrict__ outA,
                OT* __restrict__ outD) {
  extern __shared__ float sm[];  // [2][wstride] weights, then the row's 2W Ei terms
  const int i = blockIdx.y, b = blockIdx.z;
  const int ws = wstride<W>(depth);
  for (int e = threadIdx.x; e < 2 * ws; e += NT) sm[e] = __ldg(wts + e);
  float* ei = sm + 2 * ws;
  if (threadIdx.x < 2 * W) ei[threadIdx.x] = __ldg(Ei + (long long)i * 2 * W + threadIdx.x);
  __syncthreads();
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= n) return;
  const long long off = ((long long)b * n + i) * n + j;
  store(outA + off, chain<W>(__ldg(A + off), sm, ei, Ej, n, j, depth));
  store(outD + off,
        chain<W>(__ldg(dA + off), sm + ws, ei + W, Ej + (long long)W * n, n, j, depth));
}

}  // namespace md

// K7 at width 8. A, dA: (B, n, n) f32; wts: (2, wstride) packed weights
// of the A and dA MLPs; Ei: (n, 16); Ej: (16, n); outA, outD: (B, n, n),
// f32 (out_bf16 = 0, K7) or bf16 (out_bf16 = 1, K7bf).
extern "C" int gncde_modulate(const float* A, const float* dA, int n, int B, int depth,
                              const float* wts, int wstride, const float* Ei,
                              const float* Ej, int out_bf16, void* outA, void* outD,
                              cudaStream_t stream) {
  constexpr int W = 8;
  if (n < 1 || B < 1 || depth < 1 || n > 65535 || B > 65535 ||
      wstride != md::wstride<W>(depth))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * wstride + 2 * W);
  const dim3 grid((n + md::NT - 1) / md::NT, n, B);
  if (out_bf16)
    md::modulate_kernel<W, __nv_bfloat16><<<grid, md::NT, smem, stream>>>(
        A, dA, n, depth, wts, Ei, Ej, static_cast<__nv_bfloat16*>(outA),
        static_cast<__nv_bfloat16*>(outD));
  else
    md::modulate_kernel<W, float><<<grid, md::NT, smem, stream>>>(
        A, dA, n, depth, wts, Ei, Ej, static_cast<float*>(outA),
        static_cast<float*>(outD));
  return (int)cudaGetLastError();
}
