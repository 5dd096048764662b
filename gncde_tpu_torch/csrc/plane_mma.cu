// K4, K6a (K6a-bf) and K6b (K6b-bf): the main path's entry points of the
// tensor-core plane sweeps in plane_mma.cuh (their design and arithmetic
// are described there). The ablation probes of K6a and K6b are
// plane_probe.cu's, so this library builds none of their instantiations.
#include "plane_mma.cuh"

// K4. A, dA: (B, n, n) bf16, 16-byte aligned; cvec: device (c_col0, c_col1,
// c_row0, c_row1) f32; G, M: (B, n, H) bf16; row_out, col_out: (B, n, H)
// f32; part: S > 1: scratch of S * 2 * B * n * H floats; dwpart: scratch of
// B * ceil(n / 64) * 2 * S * ceil(H / chunk) * 4 floats; dw: (B, 4) f32.
extern "C" int gncde_tiled_bwd2(const void* A, const void* dA, int n, const float* cvec,
                                const void* G, const void* M, int B, int H, float* row_out,
                                float* col_out, float* part, float* dwpart, float* dw, int S,
                                cudaStream_t stream) {
  if (!pk::args_ok(A, dA, n, n, B, H, S, part) || !dwpart) return (int)cudaErrorInvalidValue;
  pk::Args g{A, dA, cvec, G, G, static_cast<const pk::bf16*>(M), row_out, col_out, part,
             dwpart, n, n, H, B, S, H % 8 == 0 && pk::aligned16(G)};
  const int chunks = (H + pk::chunk_of(H) - 1) / pk::chunk_of(H);
  int err = pk::by_chunk(H, [&](auto hb) {
    return pk::launch_sweep<pk::OP_K4, pk::bf16, pk::bf16, decltype(hb)::value>(g, chunks,
                                                                              stream);
  });
  if (err == 0) err = pk::finish_parts(g, stream);
  if (err != 0) return err;
  const int nblk = (n + pk::BO - 1) / pk::BO * 2 * S * chunks;
  pk::sum_blocks_kernel<<<B, 32, 0, stream>>>(dwpart, nblk, dw);
  return (int)cudaGetLastError();
}

// K6a and K6a-bf. A, dA: (B, nr, nc), f32 (planes_bf16 = 0) or bf16 (1),
// 16-byte aligned; cvec: device (cr0, cr1, cc0, cc1) f32; Mk: (B, nc, H), Mi:
// (B, nr, H), f32 (vecs_bf16 = 0) or bf16 (1, with bf16 planes only);
// row_out: (B, nr, H) f32; col_out: (B, nc, H) f32; part: S > 1: scratch of
// S * B * (nr + nc) * H floats.
extern "C" int gncde_pair(const void* A, const void* dA, int nr, int nc, const float* cvec,
                          const void* Mk, const void* Mi, int B, int H, int planes_bf16,
                          int vecs_bf16, float* row_out, float* col_out, float* part, int S,
                          cudaStream_t stream) {
  if (!pk::args_ok(A, dA, nr, nc, B, H, S, part) || (vecs_bf16 && !planes_bf16))
    return (int)cudaErrorInvalidValue;
  const int ev = vecs_bf16 ? 8 : 4;  // vector elements a 16-byte granule
  pk::Args g{A, dA, cvec, Mk, Mi, nullptr, row_out, col_out, part, nullptr, nr, nc, H, B, S,
             H % ev == 0 && pk::aligned16(Mk) && pk::aligned16(Mi)};
  const int chunks = (H + pk::chunk_of(H) - 1) / pk::chunk_of(H);
  int err = pk::by_chunk(H, [&](auto hb) {
    constexpr int HB = decltype(hb)::value;
    if (!planes_bf16)
      return pk::launch_sweep<pk::OP_PAIR, float, float, HB>(g, chunks, stream);
    if (!vecs_bf16)
      return pk::launch_sweep<pk::OP_PAIR, pk::bf16, float, HB>(g, chunks, stream);
    return pk::launch_sweep<pk::OP_PAIR, pk::bf16, pk::bf16, HB>(g, chunks, stream);
  });
  return err != 0 ? err : pk::finish_parts(g, stream);
}

// K6b and K6b-bf. A, dA: (B, nr, nc); Gr, Mi: (B, nr, H); Mk, Gc: (B, nc,
// H); all f32 (bf16_in = 0) or all bf16 (1); S: the parts of H (the plan,
// ops/pair.py pair_dw_plan); part: scratch of B * tiles * S * 4 floats,
// tiles = ceil(nr / 64) ceil(nc / 64); dw: (B, 4) f32.
extern "C" int gncde_pair_dw(const void* A, const void* dA, int nr, int nc, const void* Gr,
                             const void* Mk, const void* Mi, const void* Gc, int B, int H,
                             int bf16_in, int S, float* part, float* dw, cudaStream_t stream) {
  pk::DwArgs g;
  if (!pk::dw_args(g, A, dA, nr, nc, Gr, Mk, Mi, Gc, B, H, S, part, bf16_in ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  return bf16_in ? pk::launch_pair_dw<pk::bf16>(g, dw, stream)
                 : pk::launch_pair_dw<float>(g, dw, stream);
}

// K6b's plane tile and the columns of H one stage of its ring holds
// (pk::DT, pk::DHK), written to out[0], out[1]: ops/pair.py's DW_TILE and
// DW_HK, which size the parts buffer, must agree (a card test checks).
extern "C" int gncde_pair_dw_dims(int* out) {
  out[0] = pk::DT;
  out[1] = pk::DHK;
  return 0;
}
