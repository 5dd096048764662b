// The design probes of K4/K6a's sweep and of K6b (tools/kernel_times_torch.py
// K6a-ablation, K6b-ablation): plane_mma.cuh's kernels instantiated with
// ablation flags that drop parts of their work (the outputs are then
// wrong; only the time is read). Only the flag sets below are built. Kept
// apart from plane_mma.cu so that the main path's library builds none of
// these instantiations.
#include "plane_mma.cuh"

// The ablation of K6a's f32 sweep (f32 planes and vectors, chunks of 64
// columns: H > 32): gncde_pair's arguments and `drop`, the D flags of one
// variant (0; D_MMA; D_FORM; D_PLANES; D_VECS; D_MMA | D_FORM; all four
// work flags; D_COLS; D_ROWS). Its outputs are meaningless except for
// drop = 0; only its time is read (tools/kernel_times_torch.py).
extern "C" int gncde_pair_probe(const void* A, const void* dA, int nr, int nc,
                                const float* cvec, const void* Mk, const void* Mi, int B,
                                int H, float* row_out, float* col_out, float* part, int S,
                                int drop, cudaStream_t stream) {
  if (!pk::args_ok(A, dA, nr, nc, B, H, S, part) || H <= 32) return (int)cudaErrorInvalidValue;
  pk::Args g{A, dA, cvec, Mk, Mi, nullptr, row_out, col_out, part, nullptr, nr, nc, H, B, S,
             H % 4 == 0 && pk::aligned16(Mk) && pk::aligned16(Mi)};
  const int chunks = (H + 63) / 64;
  int err;
  switch (drop) {
    case 0: err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, 0>(g, chunks, stream); break;
    case pk::D_MMA:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_MMA>(g, chunks, stream);
      break;
    case pk::D_FORM:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_FORM>(g, chunks, stream);
      break;
    case pk::D_PLANES:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_PLANES>(g, chunks, stream);
      break;
    case pk::D_VECS:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_VECS>(g, chunks, stream);
      break;
    case pk::D_MMA | pk::D_FORM:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_MMA | pk::D_FORM>(
          g, chunks, stream);
      break;
    case 15: err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, 15>(g, chunks, stream); break;
    case pk::D_COLS:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_COLS>(g, chunks, stream);
      break;
    case pk::D_ROWS:
      err = pk::launch_sweep<pk::OP_PAIR, float, float, 64, pk::D_ROWS>(g, chunks, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : pk::finish_parts(g, stream);
}

// The ablation of K6b (tools/kernel_times_torch.py K6b-ablation):
// gncde_pair_dw's arguments and `drop`, the DwDrop flags of one variant (0;
// DW_NO_MMA; DW_NO_VECS; DW_NO_PLANES; all three). Its outputs are
// meaningless except for drop = 0; only its time is read.
extern "C" int gncde_pair_dw_probe(const void* A, const void* dA, int nr, int nc,
                                   const void* Gr, const void* Mk, const void* Mi,
                                   const void* Gc, int B, int H, int bf16_in, int S,
                                   float* part, float* dw, int drop, cudaStream_t stream) {
  pk::DwArgs g;
  if (!pk::dw_args(g, A, dA, nr, nc, Gr, Mk, Mi, Gc, B, H, S, part, bf16_in ? 8 : 4))
    return (int)cudaErrorInvalidValue;
#define GNCDE_DW_PROBE(BITS)                                                        \
  case BITS:                                                                        \
    return bf16_in ? pk::launch_pair_dw<pk::bf16, BITS>(g, dw, stream)              \
                   : pk::launch_pair_dw<float, BITS>(g, dw, stream);
  switch (drop) {
    GNCDE_DW_PROBE(0)
    GNCDE_DW_PROBE(pk::DW_NO_MMA)
    GNCDE_DW_PROBE(pk::DW_NO_VECS)
    GNCDE_DW_PROBE(pk::DW_NO_PLANES)
    GNCDE_DW_PROBE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GNCDE_DW_PROBE
}
