"""GPU smoke test of the PyTorch/Hopper port (gncde_tpu_torch).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing one line before the last:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build every kernel from gncde_tpu_torch/csrc (K1, K2, the tiled kernels
     K3-K6b, K7, K8/K9, K10, K11, K12/K13, and their directed and bf16
     instantiations), one nvcc per source, all started together (nvcc
     seconds per source);
  3. K1 (forward vf kernel) against its plain PyTorch version at the
     flagship shape (n=400, B=4, widths 16 -> 16 -> 16), the bench shape
     (widths 32 x 4) and the trade shape (n=255, B=4, widths 32 -> 32 -> 32
     -> 32 -> 512: the CDE-wrapper field of configs/tgb/trade_*, whose last
     layer the kernels sweep in chunks of 64 columns), per-element planes
     and (idx, tau); max abs err <= 1e-4 * max|ref|;
  4. K2 (backward vf kernel) against the plain autograd version at the same
     shapes, with and without the tau cotangent; every cotangent within
     1e-3 * max|ref|;
  5. the main path: ``gncde_tpu_torch.run.dyn.main`` trains the flagship
     config configs/dyn/perm_equiv_gncde.yaml for 3 epochs at full width
     on the card; every train loss must be finite and both kernels must
     have launched;
  6. the tiled kernels K3 (fwd2), K4 (bwd2), K5a (dw2) and K5b (dw) against
     their plain versions at the tgbn-genre shape (n=1505, H 8 and 128,
     B=1) and one small odd shape (n=300, H=5, B=2); max abs err <= 1e-4 *
     max|ref| (the same bf16 operands and B1/B2 roundings on both sides; only
     the order of the f32 sums differs); for K3 also the time of two cuBLAS
     bf16 products on pre-formed B1, B2 as a yardstick (not one call for the
     same function); every time twice: over 20 wrapper calls with CUDA
     events (``ms``, host work inside) and as the device time of 20 calls
     in a torch.profiler trace (``device_ms``, :func:`device_ms`);
  7. the TGB main path: ``gncde_tpu_torch.run.tgb.main`` trains
     configs/tgb/genre_perm_equiv_gncde.yaml for one epoch at full width
     (n=1505, hidden 8, 3 layers) on a tgbn-genre-scale surrogate written by
     tools/fetch_tgb.py (gravity model, seed 2, 1505 nodes, 130,000 edges
     per snapshot) cut from 133 snapshots to 12, in windows of 3 starting
     every 4 (the config's own are 10 long), split 1/1/1 (1 train, 1
     validation, 1 test window); every train loss and the validation NDCG@10
     must be finite and K3 and K4 must have launched;
  8. the enc_idx kernels K7 (modulate_pair), K6a (pair) and K6b (pair_dw)
     against their plain versions at the tgbn-genre shape (n=1505, H 8 and
     128, B=1) and n=300, H=5, B=2; max abs err <= 1e-5 * max|ref| for K7
     (no reductions), <= 1e-4 for K6a/K6b (f32 sums in another order); for
     K6a also the time of two cuBLAS f32 products on pre-formed B1, B2 as a
     yardstick;
  9. the enc_idx main path: ``gncde_tpu_torch.run.tgb.main`` trains
     configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml for one epoch at full
     width (n=1505, vf hidden 8, 3 layers, idx_dim 8, two modulation MLPs of
     width 8 and depth 2) on phase 7's surrogate and windows; every train
     loss and the validation NDCG@10 must be finite, K7, K6a and K6b must
     have launched, and K3 and K4 must not have (enc_idx bypasses them);
 10. the sparse controls' kernels K8 (BCSR SpMM), K9 (BCSR SDDMM) and K10
     (ELL SpMM) against their plain versions at three shapes: the flagship
     (B=4, n=400, bs=128, the flagship data's own union pattern at one t,
     H=16; ELL with that data's K), the scaled point (B=1, n=32768, bs=128,
     a circular +-64 band: kb=3, H=32; ELL K=129) and an odd one (B=2,
     n=300, bs=32, H=5, per-element patterns with padded slots); max abs err
     <= 1e-4 * max|ref| (f32, summation order); beside each, one PyTorch
     library call for the same function as a yardstick (a BSR tensor @ M,
     sparse.sampled_addmm at the block pattern's CSR, a CSR tensor @ M);
     kernels and library calls timed as in phase 6 (``ms`` and
     ``device_ms``);
 11. the main path with ``sparse_control=true sparse_format=bcsr``: first
     the flagship field at the trainer's init through the BCSR control
     against phase 5's K1 route on the same data, at three times per
     element, max abs err <= 1e-4 * max|ref| (the same function by another
     route), and the gradients of sum(f * W) with respect to the state and
     every field parameter (K9, K8 on the transposed layout against K2),
     each within 1e-3 * max|ref|; then one epoch of the flagship config at
     full width through ``gncde_tpu_torch.run.dyn``, without the trainer's
     evaluation (as in phases 12, 16, 20 and 21; phase 15 evaluates after its
     last epoch, phase 5 after each): finite losses, K8 and K9 launched, K1/K2
     not, and the first train loss within 5e-2 relative of phase 5's (a
     sanity bound: the adaptive controller puts correct routes up to 1.3%
     apart);
 12. the same with ``sparse_format=ell`` for one epoch: K10 launched, K8,
     K9, K1, K2 not;
 13. the scaled BCSR step of benchmarks/bcsr_scale.py: n=32768, a circular
     +-64 band (4.2 M edges per knot), bs=128, H=32, 3 layers, 3 knots; the
     control built from edge lists (no n x n object anywhere) with its
     coefficient tiles stored in bf16, as the JAX script stores them (the
     evaluated tiles that reach K8/K9 are float32, as in JAX), Heun at dt0
     0.25 (8 evals), one warm-up and three SGD steps at lr 1e-3; finite,
     moving losses, K8 and K9 launched;
 14. K11 (the fused RK step) against its plain version (the stage loop of
     plain vf evals) at the flagship (B=4, n=400, 16 -> 16 -> 16, Tsit5) and
     bench (widths 32 x 4) shapes, y1, err and f1 within 1e-4 * max|ref|,
     two launches bitwise equal, and its backward (one K2 per stage) against
     autograd of the plain step within 1e-3; K12 and K13 (the dense
     per-layer fused apply) at the flagship layer (B=4, n=400, H=16) and
     n=300, H=5, B=2, and K5c (tiled_abar_apply's 4-slab apply) at n=1505,
     H 8 and 128, and n=300, H=5, B=2, each within 1e-4;
 15. the main path with the fused step on (``ops.set_fused_step(True)``):
     first the step at the trainer's init through K11 against the per-stage
     K1 route on the same (t, y, h, f0), y1 within 1e-5 * max|ref| and the
     gradients of sum(y1 * W) (state, every field parameter) within 1e-3 of
     K2's per-stage route; then three epochs of the flagship, evaluated
     after the last: finite
     losses, K11 and K2 launched, fewer K1 launches than phase 5, the first
     loss within 5e-2 of phase 5's;
 16. the flagship with ``fusion_backend=pipeline`` and then
     ``fusion_backend=pallas``, one epoch each: the field at init through
     the backend against phase 5's K1 route (1e-4) and its gradients against
     K2's (1e-3), then training with K13 (respectively K12) launched and K1,
     K2 not; finite losses, the first within 5e-2 of phase 5's;
 17. the directed 11-term basis: K1, K2 (with and without the tau
     cotangent) and K11 with its backward on the directed basis (K1d, K2d,
     K11d) against their plain versions at the flagship and trade shapes
     (K11d: flagship and bench), make_inputs with an (11, 2) basis on
     planes whose column sums differ from their row sums by more than a
     tenth of their scale (so a row/column swap cannot pass); bounds K1d
     1e-4, K2d 1e-3 per cotangent, K11d 1e-4 forward and 1e-3 backward;
     then the directed flagship field at the trainer's init through the
     pipeline and pallas backends and the BCSR and ELL controls against the
     directed K1 route (1e-4) and its gradients against directed K2's
     (1e-3), phase 11's route check; then the directed tiled eval at n=1505
     (genre widths 8 -> 8 -> 8 -> 128) through K3 against its plain version
     on the same bf16 planes (1e-4), with its error against the f32 dense
     directed oracle beside it;
 18. the trade main path: ``gncde_tpu_torch.run.tgb.main`` trains
     configs/tgb/trade_perm_equiv_dir_gncde.yaml for one epoch at full
     width (n=255, hidden 32, 4 layers, last layer 512, windows of 3) on
     tools/fetch_tgb.py's tgbn-trade surrogate (seed 0, whose first 16
     snapshots touch all 255 nodes) cut to 16 snapshots, windows of 3
     starting every 5, split 1/1/1; finite losses and NDCG@10, directed K1
     and K2 launched, K3 and K4 not;
 19. the genre main path on the directed basis:
     configs/tgb/genre_perm_equiv_dir_gncde.yaml at full width (n=1505, 3
     layers, last 128) on phase 7's surrogate and windows; K3
     and K4 launched, K1 and K2 not, finite losses and NDCG;
 20. the directed flagship (``model.vector_field.name=
     PermEquivDirGraphVectorField``) with the fused step on, on phase 5's
     data: the step at the trainer's init through directed K11 against the
     per-stage directed K1 route (y1 1e-5, gradients 1e-3 of K2's), then
     one epoch: finite losses, K11 and K2 launched.
 21. fusion_precision bf16: K1bf, K2bf (flagship, bench and trade shapes)
     and K11bf (flagship and bench, Tsit5), each on both bases (K1dbf,
     K2dbf, K11dbf), against their plain bf16 versions on the same bf16
     planes, layer by layer: each layer of the plain version starts from
     the kernel's own M, input and cotangent, read back from its scratch,
     and every layer's values and outputs are held to 1e-4 (K1bf) and 1e-3
     (K2bf) of max|ref|; K11bf's stage derivatives against one plain K1bf
     eval each at the stage input formed from the kernel's own, y1 and err
     formed from them (1e-4), every K2bf launch of its backward layer by
     layer (1e-3; a single stage's basis cotangents 5e-3);
     two launches bitwise equal; the free-running errors beside them.
     Then the flagship field at init and its gradients (state and every
     field parameter) through K1bf/K2bf on phase 5's data, both
     bases: bitwise equal to a K1bf and a K2bf launch on the same inputs,
     which are held layer by layer as above; their distance to the f32
     K1/K2 route finite and nonzero (the witness that the bf16 kernels
     ran); the step at init through K11bf against the per-stage K1bf route
     (y1 1e-5, gradients 5e-3: the two routes sum the stage
     cotangents in another order before K2bf rounds them to bf16); then one
     epoch of the flagship with ``fusion_precision=bf16`` per stage, one
     with the fused step and one of the directed flagship fused: finite
     losses, the bf16 kernels launched and the f32 K1, K2, K11 not.
 22. the bf16 enc_idx kernels against their plain versions at phase 8's
     shapes and the trade width (n=255, H=512): K7bf (bf16 output) within
     one bf16 ulp per element beyond K7's f32 bound and bitwise K7's f32
     output rounded once; K6a-bf on bf16 planes with f32 vectors (the
     forward) and with bf16 vectors (the backward) and K6b-bf on bf16
     operands within 1e-4 * max|ref|; each timed beside the f32 kernel;
 23. configs/tgb/trade_perm_equiv_dir_enc_idx_gncde.yaml (the directed
     enc_idx field: n=255, hidden 32, 4 layers, last layer 512, an mlp
     index encoder of width 512) through ``gncde_tpu_torch.run.tgb.main``
     on phase 18's surrogate and windows, no evaluation of the initial
     model; finite
     losses and NDCG@10, K7, K6a and K6b launched, the Hermite kernels
     (K1-K4) and the bf16 ones not;
 24. configs/tgb/genre_perm_equiv_dir_enc_idx_gncde.yaml (n=1505, 8 -> 8
     -> 8 -> 128) on phase 7's surrogate and windows, with the same checks;
 25. fusion_precision bf16 on the enc_idx route: the directed enc_idx field
     at benchmarks/enc_idx_micro.py's two shapes (trade n=255, H=32, 4
     layers; genre n=1505, H=8, 3 layers; idx_dim 512, T=6 knots, planes
     uniform * 0.1, t=0.37, B=1) through K7bf -> K6a-bf (backward K6a-bf,
     K6b-bf) against the plain versions on the CPU: the field against the
     plain stack started from K7bf's own planes within 1e-4 * max|ref|;
     each plane-pair apply of the route against its plain version from the
     route's own inputs and output cotangents (outputs 1e-4, d_M and the c
     cotangents 1e-3, the bf16 plane cotangents one ulp), and the
     modulation MLPs' and the embedding's gradients against the plain
     chain's from the route's own plane cotangents (5e-3); the free-running
     gradients printed beside; the f32 route's distance finite and
     nonzero; then one training window of phase 23's config under
     ``ops.set_fusion_precision("bf16")``: finite losses, K7bf, K6a-bf and
     K6b-bf launched, K7, K6a, K6b and the Hermite kernels not.
 26. the megakernel design probes P1-P6 (benchmarks/mk_probe*.py) at their
     own shape (n=400, H=32, L=3, B=16, T=12, bf16 planes): the probe timer
     ``gncde_tpu_torch.run.mk_probe`` (10 chained evals, 2 Tsit5 steps, 3
     blocks) launches every variant -- K1-4mm (P1, P5 v4mm, v4mm_mt,
     v4mm_bf16), K1bf with the probe flags (P3 red, notr, red_notr; P4's
     nine ablations), K1bf (P2's arrangements, P3 current, P4 full, P5
     full, P6 seq) and K11bf (P6 fusedstep); then each eval variant against
     its plain version layer by layer from its own M within 1e-4 * max|ref|
     (P4 dma_only 1e-5), P2 fixedslice bitwise P2 current, P6 seq and
     fusedstep each stage by stage against the plain step on their own
     stage derivatives, each stage layer by layer (1e-4), and fusedstep against seq (y1 1e-5, err and
     f1 1e-4), each timed beside its plain version, each with the bound of
     what its own function reads and does (``probe_bound``).
Phase 12's route check also computes the gradients twice and requires them
bitwise equal (the ELL backward has no scatter).
Then one JSON line of every kernel (launches on its main path: calls of its
wrapper, each counted once where it launches its kernel; a K3 call whose
reduce extent is split makes two CUDA launches, the parts and their sum;
error, times and the bound: the larger of the bytes its function must move at 3.35 TB/s
and the products that function needs at the card's peak for their operands'
type). The last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device the script fails before phase 1.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FLAGSHIP = "configs/dyn/perm_equiv_gncde.yaml"
SHAPES = {
    "flagship": dict(n=400, B=4, widths=(16, 16, 16)),
    "bench": dict(n=400, B=4, widths=(32, 32, 32, 32)),
    "trade": dict(n=255, B=4, widths=(32, 32, 32, 32, 512)),
}
K1_TOL = 1e-4
K2_TOL = 1e-3
#: The bf16 kernels (phase 21) against their plain versions, layer by layer.
#: Both round the same operands at the same points, but their f32
#: intermediates (each layer's M, the cotangents, so the ReLU masks) differ
#: in their last bits (summation order), and rounding such a value to bf16
#: moves it by a whole bf16 ulp where it straddles a rounding boundary; the
#: flips compound through the layers (PERF.md: up to 4.1e-2 of max|ref| on a
#: deep layer's basis cotangent, a sum with cancellation). So each layer of
#: the plain version starts from the kernel's own M, x and cotangent, read
#: back from its scratch (``trace``), and every layer's values and every
#: output are held to the f32 kernels' bounds, K1_TOL and K2_TOL: only one
#: layer's f32 sums separate the two. The free-running error (the plain
#: version alone from the inputs) is printed beside it.
#: K11bf's stages cannot be read back layer by layer from its cooperative
#: launch: each stage derivative is held against one plain K1bf eval at the
#: stage input formed from the kernel's own stage derivatives, y1 and err
#: against their combinations of them, all to STEP_TOL (a stage is a whole
#: K1bf eval, free-running: measured up to 6.4e-5 at the STEP_SHAPES,
#: PERF.md). Its backward: every K2bf launch layer by layer (K2_TOL), and the
#: gradients bitwise those of the explicit chain over those launches. The
#: basis cotangents of one stage's launch are held to BF16_STAGE_BASIS_TOL,
#: five times K2_TOL: at the bench shape a middle layer's basis
#: cotangents of a single stage cancel to a small fraction of their terms,
#: so the f32 summation order alone moves them by up to 4.1e-3 of their
#: scale on the card (the plain version's own f32 error there is 6.8e-4,
#: against float64 on the CPU; the f32 K11d's summed gradients in that cell
#: differ from their plain version by 5.7e-4, PERF.md).
BF16_STAGE_BASIS_TOL = 5e-3
TILED_TOL = 1e-4
#: tgbn-genre shapes of the tiled kernels (the config's layer widths 8, 8,
#: and the CDE wrapper's 8 * 8 * 2 = 128) and one small odd shape.
TILED_SHAPES = {"genre-H8": dict(n=1505, H=8, B=1), "genre-H128": dict(n=1505, H=128, B=1),
                "odd": dict(n=300, H=5, B=2)}
MODULATE_TOL = 1e-5
PAIR_TOL = 1e-4
#: The TGB phases (7, 9, 18, 19, 23-25) each run one epoch of three windows
#: of 3 snapshots (the trade configs' window), split 1/1/1: one training
#: window, one validation, one test. The genre phases (7, 9, 19, 24) train
#: on the tgbn-genre surrogate cut to 12 snapshots, windows starting every
#: 4; the trade phases (18, 23, 25) on the tgbn-trade one cut to 16, every
#: 5. Each surrogate is written once and shared (:func:`surrogate_dir`).
#: Depth cuts, each made when a whole script ran past its 1200 s: phase 7
#: ran the genre config's own windows of 10 (40 snapshots, 275 s of a
#: 1072 s script on the card) until a script ran past 1200 s on another
#: machine of the same kind; phases 9, 19, 23-25 had 2-3 test windows, 18
#: three training windows and 19 two.
GENRE_SNAPSHOTS = 12
ONE_EACH = "dataset.split_ratio=[0.34,0.34,0.32]"
GENRE_WINDOWS = ("dataset.window_size=3", "dataset.stride=4", ONE_EACH)
TRADE_WINDOWS = ("dataset.window_size=3", "dataset.stride=5", ONE_EACH)
SPARSE_TOL = 1e-4
#: The flagship field through a sparse control against phase 5's K1 route,
#: on the flagship data at the trainer's init (relative to max|ref|), and
#: its gradients against K2's (as K2 against its plain version).
SPARSE_VF_TOL = 1e-4
SPARSE_GRAD_TOL = 1e-3
#: First train loss of the sparse main paths against phase 5's (relative). A
#: sanity bound, not the precise check (SPARSE_VF_TOL is): routes whose fields
#: agree to 1e-15 in float64 give first losses 0.93% apart in float64 on the
#: CPU, and the card's K1 and BCSR routes 1.3% apart in float32, because the
#: adaptive controller's reject storms at the graph events amplify rounding.
SPARSE_LOSS_RTOL = 5e-2
#: Epochs of phases 11 and 12 (the flagship's main path through K8/K9, K10);
#: phase 11 was cut from three when a whole script took 1236 s of its 1200.
BCSR_EPOCHS = 1
#: The flagship runs after phase 5 (phases 11, 12, 15, 16, 20 and 21)
#: evaluate once at most: the trainer evaluates every ``eval_freq`` epochs,
#: three passes over the validation and test data that take about one
#: training step's time, so the one-epoch runs skip it (NO_EVAL) and phase
#: 15 evaluates after its last epoch only. Each of these routes' field and
#: gradients are held at the trainer's init by the phase's route check;
#: phase 5 evaluates every epoch. Cut when a whole script ran past its 1200 s.
NO_EVAL = "eval_freq=2"
ELL_EPOCHS = 1
#: benchmarks/bcsr_scale.py's point.
SCALED = dict(n=32768, bw=64, bs=128, H=32, L=3, T=3)
#: Phase 14: K11 at the flagship and bench shapes (Tsit5), K12/K13 at the
#: flagship layer and an odd shape, K5c at the tiled shapes.
STEP_SHAPES = {"flagship": SHAPES["flagship"], "bench": SHAPES["bench"]}
APPLY_SHAPES = {"flagship-layer": dict(n=400, H=16, B=4), "odd": dict(n=300, H=5, B=2)}
STEP_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
APPLY_TOL = 1e-4
ABAR_TOL = 1e-4
#: Phase 15: the step at init through K11 against the per-stage K1 route.
STEP_ROUTE_TOL = 1e-5
FUSED_EPOCHS = 3
#: Phase 16: one epoch per backend.
BACKEND_EPOCHS = 1
#: Phases 17-20: the directed basis. The flagship takes the directed field
#: by this override; phase 17 holds it at init through these routes.
DIRECTED_FIELD = ("model.vector_field.name=PermEquivDirGraphVectorField",)
DIRECTED_ROUTES = ("pipeline", "pallas", "bcsr", "ell")
NBASIS_DIRECTED = 11
DIR_SHAPES = {"flagship": SHAPES["flagship"], "trade": SHAPES["trade"]}
#: The directed tiled eval of phase 17: the genre config's widths at n=1505.
DIR_TILED = dict(n=1505, widths=(8, 8, 8, 128), B=1, T=4)
#: Phase 18: the trade surrogate (seed 0: its first 16 snapshots touch all
#: 255 nodes) cut to 16 snapshots.
TRADE_CONFIG = "configs/tgb/trade_perm_equiv_dir_gncde.yaml"
TRADE_SNAPSHOTS = 16
TRADE_SEED = 0
TRADE_NODES = 255
#: Phase 19: the directed genre config.
GENRE_DIR_CONFIG = "configs/tgb/genre_perm_equiv_dir_gncde.yaml"
#: Phase 20: one epoch of the directed flagship with the fused step.
DIRECTED_EPOCHS = 1
#: Phase 21: fusion_precision bf16. The flagship field at init and its
#: gradients through K1bf/K2bf: each eval's launches held layer by layer
#: against the plain versions (K1_TOL, K2_TOL) and bitwise equal to the
#: route's value and gradients; the distance to the f32 route (K1/K2) is
#: the witness that the bf16 kernels ran: finite and nonzero. It has no
#: upper bound: it is the bf16 rounding of the function itself, which the
#: JAX package's bf16 field shows too (tests/test_torch_bf16.py), measured
#: on the flagship data up to 6.4e-2 for the field and 0.59 for a basis
#: gradient (PERF.md). The step through K11bf against the per-stage K1bf
#: route: y1 STEP_ROUTE_TOL, gradients BF16_STEP_ROUTE_GRAD_TOL, five times
#: K2_TOL: both routes run K2bf per stage, but their explicit chain and
#: autograd sum the stage cotangents in another order, and the bf16
#: rounding of those cotangents in K2bf turns the last-bit differences into
#: bf16 ulps (measured 3.1e-3 on the flagship's layer-1 basis gradients,
#: whose bf16 rounding effect is 0.49 of their scale).
BF16_STEP_ROUTE_GRAD_TOL = 5e-3
BF16_EPOCHS = 1
BF16 = ("fusion_precision=bf16",)
#: Phases 22-25: the directed enc_idx field and the bf16 enc_idx route.
#: Phase 22 holds K7bf to its plain version within one bf16 ulp per element
#: (the f32 chain's last bits may differ, and rounding then moves an element
#: a whole ulp) and K6a-bf, K6b-bf to PAIR_TOL (the same bf16 operands;
#: only the order of the f32 sums differs), at phase 8's shapes and the
#: trade width (the trade config's last layer, 32 * 8 * 2 = 512). K7bf's
#: ulp bound allows K7's f32 bound (MODULATE_TOL of max|ref|) besides the
#: ulp: near zero the chain's f32 sums cancel, and their last bits are many
#: bf16 ulps of a tiny element. K7bf is also bitwise K7's f32 output rounded
#: once (the same device code up to the store).
PAIR_BF16_SHAPES = {**TILED_SHAPES, "trade-H512": dict(n=255, H=512, B=1)}
K7BF_ULPS = 1.0
#: Phases 23-25: the reference's directed enc_idx configs at full width, on
#: phases 18's and 9's cuts.
TRADE_DIR_ENC_IDX_CONFIG = "configs/tgb/trade_perm_equiv_dir_enc_idx_gncde.yaml"
GENRE_DIR_ENC_IDX_CONFIG = "configs/tgb/genre_perm_equiv_dir_enc_idx_gncde.yaml"
#: Phase 25: the directed enc_idx field at benchmarks/enc_idx_micro.py's
#: shapes (``bench_shape``: T = 6 knots on [0, 1], planes uniform * 0.1,
#: t = 0.37, B = 1, an emb encoder of width 512, output width H) under
#: bf16, through K7bf -> K6a-bf (backward K6a-bf, K6b-bf), against the plain
#: versions on the CPU (:func:`enc_idx_bf16_errors`): the field to
#: ENC_IDX_BF16_TOL (the forward rounds nothing after K7bf's planes, so only
#: f32 sums differ); the backward from the route's own intermediates, as
#: phase 21 holds K2bf: it rounds each layer's output cotangent to bf16,
#: where an f32 last-bit difference upstream flips a whole ulp, and
#: free-running the c cotangents of a layer drift by up to 2.5e-3 (PERF.md). The modulation
#: MLPs' and the embedding's gradients are held to
#: ENC_IDX_BF16_MOD_GRAD_TOL, BF16_STAGE_BASIS_TOL's cap (the chain sums the
#: plane cotangents over n^2 edges).
ENC_IDX_MICRO_SHAPES = {"trade": dict(n=255, H=32, L=4, idx_dim=512),
                        "genre": dict(n=1505, H=8, L=3, idx_dim=512)}
ENC_IDX_BF16_TOL = 1e-4
ENC_IDX_BF16_MOD_GRAD_TOL = 5e-3
ENC_IDX_KERNELS = ("K7", "K6a", "K6b")
ENC_IDX_BF16_KERNELS = ("K7bf", "K6a-bf", "K6b-bf")
#: The kernels a directed enc_idx run must not launch: the Hermite-factorised
#: kernels of either regime (the per-edge MLP breaks the factorisation).
HERMITE_KERNELS = ("K1", "K2", "K3", "K4", "K1bf", "K2bf")
#: Phase 26, the design probes: each variant against its plain version on
#: the same bf16 planes, layer by layer from the kernel's own M (as K1bf),
#: at K1_TOL; P4 dma_only (f32 row sums, no rounding) at PROBE_DMA_TOL. P6:
#: seq and fusedstep each stage by stage against the plain step, each stage
#: layer by layer from a K1bf launch's M (bf16 flips compound over free
#: layers: 1.6e-4 at this shape), at STEP_TOL, and K11bf's y1 against the per-stage
#: K1bf route at STEP_ROUTE_TOL, its err and f1 at STEP_TOL. The probe timer (``gncde_tpu_torch.run.mk_probe``,
#: the phase's main path) runs with fewer repetitions than its defaults.
PROBE_DMA_TOL = 1e-5
PROBE_TIMER_ARGS = ("--evals", "10", "--steps", "2", "--blocks", "3")
# Published H100 SXM peaks (NVIDIA data sheet) for the bounds.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound(nbytes, *ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations, given as (count, peak) pairs, each over the peak
    for its type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, sum(f / peak for f, peak in ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; refusing to run")
    return torch


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})
    return smi


def phase_build():
    from gncde_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = _build.sources()
    _build.build(names)
    emit({"phase": 2, "sources": names, "build_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.BUILD_SECONDS)})


def make_inputs(torch, n, B, widths, seed=0, T=8, nbasis=8):
    """Per-element planes and (idx, tau), node state and layer params of
    the given widths (input, then each layer's output); each layer's basis
    is ``(nbasis, 2)``: 8 for the undirected basis, 11 for the directed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    planes = tuple(t(rng.uniform(-0.05, 0.1, (B, T - 1, n, n))) for _ in range(4))
    idx = torch.tensor(rng.permutation(T - 1)[:B], device=dev)
    tau = t(rng.uniform(0.0, 0.2, B))
    Z = t(rng.normal(size=(B, n, widths[0])))
    layers = []
    for hin, hout in zip(widths[:-1], widths[1:]):
        lim = 1.0 / np.sqrt(hin)
        layers.append(dict(
            norm_w=t(1.0 + 0.1 * rng.normal(size=hin)),
            norm_b=t(0.1 * rng.normal(size=hin)),
            W=t(rng.uniform(-lim, lim, (hout, hin))),
            lin_b=t(rng.uniform(-lim, lim, hout)),
            basis=t(rng.uniform(-1 / 15, 1 / 15, (nbasis, 2))),
        ))
    G = t(rng.normal(size=(B, n, widths[-1])))
    return planes, idx, tau, Z, layers, G


def assert_asymmetric(torch, planes, idx, tau, what):
    """The planes' A(tau) has column sums that differ from its row sums by
    more than a tenth of their scale, so a directed kernel that swapped a
    column sum for a row sum would fail its check."""
    from gncde_tpu_torch.ops import megakernel as mk

    A, _ = mk.hermite(planes, idx, tau)
    rA, cA = A.sum(-1), A.sum(-2)
    gap, scale = float((cA - rA).abs().max()), float(rA.abs().max())
    if not gap > 0.1 * scale:
        raise RuntimeError(f"{what}: planes too symmetric for a directed check "
                           f"(max|cA - rA| {gap:.3e}, max|rA| {scale:.3e})")
    return gap / scale


def k1_bound(s, bf16=False):
    """(bound_ms, bound_by) of one K1 (or K1d) call at shape ``s``: the four
    f32 interval planes read once, Z read, the output written; one product
    C M per layer in f32. ``bf16`` (K1bf): the planes are bf16 and each
    layer takes two bf16 products, B1 Mh and B2^T Mh."""
    n, B, w = s["n"], s["B"], s["widths"]
    if bf16:
        return bound(4 * 2 * n * n * B + 4 * n * B * (w[0] + w[-1]),
                     (sum(4 * n * n * h * B for h in w[1:]), BF16_FLOPS))
    return bound(4 * 4 * n * n * B + 4 * n * B * (w[0] + w[-1]),
                 (sum(2 * n * n * h * B for h in w[1:]), F32_FLOPS))


def probe_bound(key, s):
    """(bound_ms, bound_by) of one eval of the probe variant ``key`` at shape
    ``s``, from what its own function reads and does: the bf16 planes it
    reads (P4 no_hermite only a and b), Z unless dma_only, the red operand
    (B, n, 4) of P3 red and red_notr, the output; per layer its bf16
    products, 2 n^2 h FLOPs each: four for K1-4mm (P1, P5 v4mm*), one for
    P4 no_rowmm / no_colmm, none for dma_only (its n^2 f32 adds), two for
    the rest (K1bf's :func:`k1_bound`)."""
    n, B, w = s["n"], s["B"], s["widths"]
    name = key.split("/")[1]
    if name == "dma_only":
        return bound(4 * 2 * n * n * B + 4 * n * B * w[-1], (4 * n * n * B, F32_FLOPS))
    planes = 2 if name == "no_hermite" else 4
    extra = 4 * 4 * n * B if name in ("red", "red_notr") else 0
    products = (4 if name in ("restructured", "v4mm", "v4mm_mt", "v4mm_bf16")
                else 1 if name in ("no_rowmm", "no_colmm") else 2)
    return bound(planes * 2 * n * n * B + 4 * n * B * (w[0] + w[-1]) + extra,
                 (sum(products * 2 * n * n * h * B for h in w[1:]), BF16_FLOPS))


def k2_bound(s, bf16=False):
    """(bound_ms, bound_by) of one K2 (or K2d) call: planes, Z and G read,
    dZ written; per layer the forward recompute C M, C^T g and P = g M^T,
    then the four basis dots <A|dA, P>, <A|dA, P^T>. ``bf16`` (K2bf): bf16
    planes; the recompute's two products, C^T gb and P in bf16, the basis
    dots in f32."""
    n, B, w = s["n"], s["B"], s["widths"]
    if bf16:
        return bound(4 * 2 * n * n * B + 4 * n * B * (2 * w[0] + w[-1]),
                     (sum(8 * h * n * n * B for h in w[1:]), BF16_FLOPS),
                     (sum(8 * n * n * B for _ in w[1:]), F32_FLOPS))
    return bound(4 * 4 * n * n * B + 4 * n * B * (2 * w[0] + w[-1]),
                 (sum((6 * h + 8) * n * n * B for h in w[1:]), F32_FLOPS))


def check_errs(errs, tol, what):
    """Raises unless every rel err in ``errs`` is finite and within ``tol``."""
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise RuntimeError(f"{what}: rel errs above {tol}: {bad}")


def bf16_k1_stepwise(torch, planes, idx, tau, Z, layers):
    """One K1bf launch against its plain version layer by layer: the
    kernel's output and ``({what: rel err}, max abs err)`` of its output and
    every layer's M against the plain version that applies the kernel's own
    M (read back from its scratch) to each layer."""
    from gncde_tpu_torch.ops import megakernel as mk

    trace, mine = {}, {}
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, True, trace=trace)
    ref = mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers, given_M=trace["M"], trace=mine)
    pairs = [("out", got, ref)] + [(f"M{l}", a, b)
                                   for l, (a, b) in enumerate(zip(trace["M"], mine["M"]))]
    return got, errs_of(torch, pairs)


def bf16_k2_stepwise(torch, planes, idx, tau, Z, layers, G, need_tau):
    """One K2bf launch against its plain version layer by layer: the
    kernel's ``(dtau, dZ, per_layer)`` and ``({what: rel err}, max abs
    err)`` of every output and of each layer's M, input x and masked input
    cotangent, the plain version starting each layer from the kernel's own
    (read back from its scratch)."""
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    trace, mine = {}, {}
    got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau, True, trace=trace)
    ref = mkb.plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, need_tau, given=trace,
                                trace=mine)
    pairs = k2_pairs(got, ref, need_tau)
    for key in ("M", "X", "g"):
        pairs += [(f"{key}{l}", a, b) for l, (a, b) in enumerate(zip(trace[key], mine[key]))
                  if a is not None]
    return got, errs_of(torch, pairs)


def k2_pairs(got, ref, need_tau):
    """(what, kernel, plain) of K2's outputs: dZ, dtau (``need_tau``) and
    every layer's parameter cotangents."""
    pairs = [("dZ", got[1], ref[1])] + ([("dtau", got[0], ref[0])] if need_tau else [])
    for l, (gl, rl) in enumerate(zip(got[2], ref[2])):
        pairs += [(f"{what}{l}", a, b) for what, a, b in
                  zip(("dnorm_w", "dnorm_b", "dW", "dlin_b", "dbasis"), gl, rl)]
    return pairs


def errs_of(torch, pairs):
    """``({what: rel err}, max abs err)`` of (what, got, ref) triples; raises
    on a shape mismatch or a non-finite value."""
    errs, worst_abs = {}, 0.0
    for what, a, b in pairs:
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"{what}: bad output {tuple(a.shape)}")
        errs[what] = rel_err(torch, a, b)[0]
        worst_abs = max(worst_abs, float((a - b).abs().max()))
    return errs, worst_abs


def bf16_step_bwd_stepwise(torch, tab, planes, ts, t, y, h, f0, ks, layers, cotangents,
                           needs):
    """K11bf's backward (``fused_step.step_vjp`` with one K2bf per stage) on
    the kernel's stage derivatives ``ks``, each K2bf launch held layer by
    layer against the plain K2bf (:func:`bf16_k2_stepwise`): the chain's
    outputs and, per stage from the last, ``({what: rel err}, max abs
    err)``."""
    from gncde_tpu_torch.ops import fused_step as tfs

    stages = []

    def stage_bwd(planes_, idx, tau, Yi, layers_, G, need_tau):
        got, errs = bf16_k2_stepwise(torch, planes_, idx, tau, Yi, layers_, G, need_tau)
        stages.append(errs)
        return got

    out = tfs.step_vjp(tab, planes, ts, t, y, h, f0, ks, layers, *cotangents, needs,
                       stage_bwd)
    return out, stages


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20, warmup=3):
    """``(ms, {kernel name: ms})``: the device time per call of ``fn``
    without its host work. ``iters`` back-to-back calls are traced with
    torch.profiler and the durations of their device events (kernels,
    copies, memsets; ``profile_step_torch.device_events``) summed, in total
    and by name, over ``iters``. Where the trace holds no device event (no
    CUPTI), the calls are captured in one CUDA graph and its replay is timed
    with CUDA events instead (no names)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from profile_step_torch import device_events

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
    if events:
        by_name = {}
        for name, _, dur in events:
            by_name[name] = by_name.get(name, 0.0) + dur / iters / 1e3
        return sum(by_name.values()), by_name
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, {}


def rel_err(torch, got, ref):
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0), scale


def phase_k1(torch, results, name="K1", phase=3, shapes=SHAPES, nbasis=8, bf16=False):
    """K1 (or, with ``nbasis`` 11, K1d; with ``bf16``, K1bf on bf16 planes,
    held layer by layer: :func:`bf16_k1_stepwise`) against its plain
    version."""
    from gncde_tpu_torch.ops import megakernel as mk

    plain_eval = mk.plain_vf_eval_bf16 if bf16 else mk.plain_vf_eval
    for label, s in shapes.items():
        planes, idx, tau, Z, layers, _ = make_inputs(torch, **s, nbasis=nbasis)
        extra = {}
        if nbasis == NBASIS_DIRECTED:
            extra["col_row_gap"] = assert_asymmetric(torch, planes, idx, tau, f"{name} {label}")
        if bf16:
            planes = tuple(p.to(torch.bfloat16) for p in planes)
            got, (errs, abs_err) = bf16_k1_stepwise(torch, planes, idx, tau, Z, layers)
        else:
            got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
        ref = plain_eval(planes, idx, tau, Z, layers)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output {tuple(got.shape)}")
        if bf16 and not torch.equal(got, mk.megakernel_vf_eval(planes, idx, tau, Z, layers,
                                                               bf16)):
            raise RuntimeError(f"{name} {label}: two launches differ")
        err, scale = rel_err(torch, got, ref)
        if bf16:
            extra.update(stepwise_rel_errs=errs, free_running_rel_err=err)
            err = max(errs.values())
        else:
            abs_err = float((got - ref).abs().max())
        ms = time_ms(torch, lambda: mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16))
        plain_ms = time_ms(torch, lambda: plain_eval(planes, idx, tau, Z, layers))
        bms, by = k1_bound(s, bf16)
        emit({"phase": phase, "kernel": name, "shape": label, **s,
              "max_abs_err": abs_err, "max_abs_ref": scale, "rel_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, **extra})
        if not err <= K1_TOL:
            raise RuntimeError(f"{name} {label}: rel err {err:.3e} > {K1_TOL}")
        results.setdefault(name, []).append((label, abs_err, ms, plain_ms))


def phase_k2(torch, results, name="K2", phase=4, shapes=SHAPES, nbasis=8, bf16=False):
    """K2 (or, with ``nbasis`` 11, K2d) against autograd of the plain K1;
    with ``bf16``, K2bf on bf16 planes against its plain version layer by
    layer (:func:`bf16_k2_stepwise`)."""
    from gncde_tpu_torch.ops import megakernel_bwd as mkb

    plain_bwd = mkb.plain_vf_bwd_bf16 if bf16 else mkb.plain_vf_bwd
    for label, s in shapes.items():
        planes, idx, tau, Z, layers, G = make_inputs(torch, **s, nbasis=nbasis)
        if nbasis == NBASIS_DIRECTED:
            assert_asymmetric(torch, planes, idx, tau, f"{name} {label}")
        if bf16:
            planes = tuple(p.to(torch.bfloat16) for p in planes)
        for need_tau in (False, True):
            extra = {}
            if bf16:
                got, (errs, worst_abs) = bf16_k2_stepwise(torch, planes, idx, tau, Z, layers,
                                                          G, need_tau)
            else:
                got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
            ref = plain_bwd(planes, idx, tau, Z, layers, G, need_tau)
            torch.cuda.synchronize()
            free_errs, free_abs = errs_of(torch, k2_pairs(got, ref, need_tau))
            if bf16:
                extra["free_running_rel_errs"] = free_errs
            else:
                errs, worst_abs = free_errs, free_abs
            worst = max(errs.values())
            ms = time_ms(torch, lambda: mkb.megakernel_vf_bwd(
                planes, idx, tau, Z, layers, G, need_tau, bf16))
            plain_ms = time_ms(torch, lambda: plain_bwd(
                planes, idx, tau, Z, layers, G, need_tau))
            bms, by = k2_bound(s, bf16)
            emit({"phase": phase, "kernel": name, "shape": label, **s,
                  "need_tau": need_tau, "max_rel_err": worst,
                  "max_abs_err": worst_abs, "rel_errs": errs,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, **extra})
            check_errs(errs, K2_TOL, f"{name} {label} need_tau={need_tau}")
            results.setdefault(name, []).append((label, worst_abs, ms, plain_ms))


def phase_train(torch, cache):
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import megakernel_bwd as mkb
    from gncde_tpu_torch.run import dyn

    with tempfile.TemporaryDirectory() as tmp:
        mk.megakernel_vf_eval.launches = 0
        mkb.megakernel_vf_bwd.launches = 0
        t0 = time.perf_counter()
        res = dyn.main([
            "--config", FLAGSHIP,
            "epochs=3", "eval_freq=1", "log_freq=1", "min_epochs=0",
            f"dataset.cache_dir={cache}", f"checkpoint_dir={tmp}/ckpt/",
            "device=cuda", "wandb.mode=disabled",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = mk.megakernel_vf_eval.launches, mkb.megakernel_vf_bwd.launches
    losses = res["train_losses"]
    emit({"phase": 5, "train_losses": losses,
          "train_step_s": res["train_step_s"], "solver_steps": res["solver_steps"],
          "device": res["device"], "k1_launches": k1, "k2_launches": k2,
          "best_validation_loss": res["validation_loss"], "wall_s": wall})
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"main path ran on {res['device']}, not cuda")
    if k1 <= 0 or k2 <= 0:
        raise RuntimeError(f"kernels not launched on the main path: K1 {k1}, K2 {k2}")
    return {"K1": k1, "K2": k2}, losses


def make_tiled_inputs(torch, n, H, B, seed=0):
    """bf16 planes (B, n, n), bf16 vectors (B, n, H), four f32 slabs
    (B, n, n) and the coefficient vector, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def bf16(x):
        return torch.tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)

    A = bf16(rng.uniform(0.0, 1.0, (B, n, n)))
    dA = bf16(rng.normal(0.0, 1.0, (B, n, n)))
    M, G = bf16(rng.normal(size=(B, n, H))), bf16(rng.normal(size=(B, n, H)))
    slabs = tuple(torch.tensor(rng.normal(0.0, 0.1, (B, n, n)).astype(np.float32), device=dev)
                  for _ in range(4))
    cvec = torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev)
    return A, dA, M, G, slabs, cvec


def tiled_bound(name, n, H, B):
    """(bound_ms, bound_by) of one tiled kernel call: each input read once,
    each output written once, and the products the function needs (not the
    kernel's own algorithm) at the peak for their operands' type: bf16
    matrix products on bf16 operands, f32 inner products with f32 planes."""
    nn, nh = n * n * B, n * H * B  # plane and vector elements
    if name == "K3":  # bf16 A, dA, M -> f32 rowpart, colpart: B1 M and B2^T M
        return bound(2 * 2 * nn + 2 * nh + 2 * 4 * nh + 16, (4 * nn * H, BF16_FLOPS))
    if name == "K4":  # bf16 A, dA, G, M -> f32 dM parts and dw4: (c_col.(A, dA)) g,
        # (c_row.(A, dA))^T g and P = G M^T, then <A|dA, P>, <A|dA, P^T>
        return bound(2 * 2 * nn + 2 * 2 * nh + 2 * 4 * nh + 16 + 4 * 4 * B,
                     (6 * nn * H, BF16_FLOPS), (8 * nn, F32_FLOPS))
    if name == "K5a":  # bf16 A, dA, G, M -> dw4: P = G M^T, four inner products
        return bound(2 * 2 * nn + 2 * 2 * nh + 4 * 4 * B,
                     (2 * nn * H, BF16_FLOPS), (8 * nn, F32_FLOPS))
    # K5b: four f32 slabs, bf16 G, M -> dw8: P = G M^T, eight inner products
    return bound(4 * 4 * nn + 2 * 2 * nh + 8 * 4 * B,
                 (2 * nn * H, BF16_FLOPS), (16 * nn, F32_FLOPS))


def phase_tiled(torch, results):
    from gncde_tpu_torch.ops import tiled as tt

    for label, s in TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        A, dA, M, G, slabs, cvec = make_tiled_inputs(torch, n, H, B)
        calls = {
            "K3": (lambda: tt.fwd2_call(A, dA, cvec, M),
                   lambda: tt.plain_fwd2(A, dA, cvec, M)),
            "K4": (lambda: tt.bwd2_call(A, dA, cvec, G, M),
                   lambda: tt.plain_bwd2(A, dA, cvec, G, M)),
            "K5a": (lambda: (tt.dw2_call(A, dA, G, M),),
                    lambda: (tt.plain_dw2(A, dA, G, M),)),
            "K5b": (lambda: (tt.dw_call(slabs, G, M),),
                    lambda: (tt.plain_dw(slabs, G, M),)),
        }
        for name, (kernel, plain) in calls.items():
            got, ref, again = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            errs, worst_abs = [], 0.0
            for a, b, c in zip(got, ref, again):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise RuntimeError(f"{name} {label}: bad output {tuple(a.shape)}")
                if not torch.equal(a, c):
                    raise RuntimeError(f"{name} {label}: two launches differ")
                err, _ = rel_err(torch, a, b)
                errs.append(err)
                worst_abs = max(worst_abs, float((a - b).abs().max()))
            ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            dev_ms, dev_by_name = device_ms(torch, kernel)
            bms, by = tiled_bound(name, n, H, B)
            line = {"phase": 6, "kernel": name, "shape": label, **s,
                    "max_abs_err": worst_abs, "max_rel_err": max(errs), "ms": ms,
                    "device_ms": dev_ms, "device_by_name": dev_by_name,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
            extra = {"device_ms": dev_ms}
            if name == "K3":
                # Two calls on B1, B2 formed beforehand: a yardstick, not one
                # call for K3's function (which forms them itself).
                c = cvec.to(torch.bfloat16)
                B1 = c[0] * A + c[1] * dA
                B2t = (c[2] * A + c[3] * dA).transpose(-2, -1)
                two = lambda: (torch.matmul(B1, M), torch.matmul(B2t, M))  # noqa: E731
                extra["yardstick_two_cublas_bf16_products_ms"] = time_ms(torch, two)
                extra["yardstick_device_ms"] = device_ms(torch, two)[0]
                line.update(extra)
            emit(line)
            if not max(errs) <= TILED_TOL:
                raise RuntimeError(f"{name} {label}: rel err {max(errs):.3e} > {TILED_TOL}")
            results.setdefault(name, {})[label] = (worst_abs, ms, plain_ms, bms, by, extra)


def write_surrogate(out: Path, name: str, snapshots: int, seed: int) -> None:
    """tools/fetch_tgb.py's ``name`` surrogate (tgbn-genre or tgbn-trade)
    cut to ``snapshots`` snapshots (the tool is numpy-only, loaded by path).
    The generator is sequential, so a cut keeps the first snapshots."""
    tool = Path(__file__).resolve().parent / "tools" / "fetch_tgb.py"
    spec = importlib.util.spec_from_file_location("fetch_tgb", tool)
    fetch_tgb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fetch_tgb)
    fetch_tgb.SCALES[name]["num_years"] = snapshots
    fetch_tgb.synthetic(name, out, seed=seed)


def write_genre_surrogate(out: Path, snapshots: int) -> None:
    """The tgbn-genre surrogate cut to ``snapshots`` snapshots. Seed 2's
    first 12 snapshots, and so every longer cut, touch all 1505 nodes, the
    config's n (seed 0's pair pool misses a node)."""
    write_surrogate(out, "tgbn-genre", snapshots, 2)


def write_trade_surrogate(out: Path, snapshots: int = TRADE_SNAPSHOTS) -> None:
    """The tgbn-trade surrogate (seed 0) cut to ``snapshots`` snapshots;
    raises unless they touch all 255 nodes, the trade configs' n."""
    from gncde_tpu_torch.data import tgb

    write_surrogate(out, "tgbn-trade", snapshots, TRADE_SEED)
    edges = tgb.load_tgb_edgelist("tgbn-trade-synth", str(out))
    if edges.num_nodes != TRADE_NODES:
        raise RuntimeError(f"the trade surrogate's first {snapshots} snapshots touch "
                           f"{edges.num_nodes} nodes, not {TRADE_NODES}")


def counters():
    from gncde_tpu_torch.ops import (bcsr, ell_spmm, fused_basis, fused_step, megakernel,
                                     megakernel_bwd, modulate, pair, pipeline, tiled)

    return {"K1": megakernel.megakernel_vf_eval, "K2": megakernel_bwd.megakernel_vf_bwd,
            "K1bf": megakernel.megakernel_vf_eval.bf16,
            "K2bf": megakernel_bwd.megakernel_vf_bwd.bf16,
            "K11bf": fused_step.fused_step_call.bf16,
            "K3": tiled.fwd2_call, "K4": tiled.bwd2_call, "K5a": tiled.dw2_call,
            "K5b": tiled.dw_call, "K5c": tiled.abar_call, "K6a": pair.pair_call,
            "K6b": pair.pair_dw_call, "K7": modulate.modulate_pair,
            "K7bf": modulate.modulate_pair.bf16, "K6a-bf": pair.pair_call.bf16,
            "K6b-bf": pair.pair_dw_call.bf16, "K8": bcsr.bcsr_spmm,
            "K9": bcsr.bcsr_sddmm, "K10": ell_spmm.ell_spmm_call,
            "K11": fused_step.fused_step_call, "K12": fused_basis._pallas_forward,
            "K13": pipeline.fused_conv_stream}


_SURROGATES = {}


def surrogate_dir(dataset: str, snapshots: int) -> Path:
    """The ``dataset`` surrogate (genre or trade) cut to ``snapshots``,
    written on first use into a temporary directory that lives until the
    script exits; later phases only read it."""
    if "root" not in _SURROGATES:
        _SURROGATES["root"] = tempfile.TemporaryDirectory()
    out = Path(_SURROGATES["root"].name) / f"{dataset}-{snapshots}"
    if not out.exists():
        if dataset == "tgbn-trade":
            write_trade_surrogate(out, snapshots)
        else:
            write_genre_surrogate(out, snapshots)
    return out


def run_tgb(torch, phase, config, snapshots, windows, dataset="tgbn-genre"):
    """One epoch of a TGB config on the ``dataset`` surrogate (genre or
    trade) in ``windows`` (one training window) through the CLI's entry
    point, without the trainer's evaluation of the initial model
    (``eval_at_init``: the epoch's own evaluation checks the same, and each
    skipped pass over the validation and test windows costs 4-50 s of the
    script's 1200 s); returns the launch counts of that run."""
    from gncde_tpu_torch.run import tgb

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = surrogate_dir(dataset, snapshots)
        data_s = time.perf_counter() - t0
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        res = tgb.main([
            "--config", config,
            f"dataset.name={dataset}-synth", "dataset.frequency=None",
            f"dataset.data_dir={data}", f"dataset.cache_dir={tmp}/cache",
            f"checkpoint_dir={tmp}/ckpt/", "epochs=1", "eval_freq=1", "min_epochs=0",
            "eval_at_init=false", "device=cuda", "wandb.mode=disabled", *windows,
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    ndcg = res["validation_metrics"].get("validation_ndcg@10", float("nan"))
    emit({"phase": phase, "config": config, "train_losses": losses,
          "train_step_s": res["train_step_s"],
          "validation_metrics": res["validation_metrics"],
          "best_epoch": res["best_epoch"], "device": res["device"],
          "launches": launches, "surrogate_write_s": data_s, "wall_s": wall})
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"phase {phase}: non-finite or missing train losses: {losses}")
    if not math.isfinite(ndcg):
        raise RuntimeError(f"phase {phase}: validation NDCG@10 is not finite: {ndcg}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase {phase}: ran on {res['device']}, not cuda")
    return launches


def phase_tgb(torch):
    launches = run_tgb(torch, 7, "configs/tgb/genre_perm_equiv_gncde.yaml", GENRE_SNAPSHOTS,
                       GENRE_WINDOWS)
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise RuntimeError(f"tiled kernels not launched on the TGB path: {launches}")
    return launches


def phase_enc_idx(torch):
    launches = run_tgb(torch, 9, "configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml",
                       GENRE_SNAPSHOTS, GENRE_WINDOWS)
    if min(launches["K7"], launches["K6a"], launches["K6b"]) <= 0:
        raise RuntimeError(f"enc_idx kernels not launched on the enc_idx path: {launches}")
    if launches["K3"] or launches["K4"]:
        raise RuntimeError(f"the enc_idx path launched the Hermite tiled kernels: {launches}")
    return launches


def make_pair_inputs(torch, n, H, B, seed=0):
    """f32 planes (B, n, n), f32 vectors (B, n, H), the coefficient vector,
    a node embedding (n, 8) and the two modulation MLPs of the enc_idx
    config (width 8, depth 2), from ``seed``."""
    import numpy as np

    from gncde_tpu_torch.nn import MLP

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def f(*shape, loc=0.0, scale=1.0):
        return torch.tensor(rng.normal(loc, scale, shape).astype(np.float32), device=dev)

    gen = torch.Generator().manual_seed(seed)
    mlps = [MLP(17, 1, 8, 2, generator=gen).to(dev) for _ in range(2)]
    return dict(A=f(B, n, n, loc=0.1, scale=0.3), dA=f(B, n, n, scale=0.5),
                Mk=f(B, n, H), Mi=f(B, n, H), Gr=f(B, n, H), Gc=f(B, n, H),
                cvec=torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev),
                emb=f(n, 8), mlps=mlps)


def pair_bound(name, n, H, B, w=8, depth=2, plane_bytes=4, vec_bytes=4):
    """(bound_ms, bound_by) of one enc_idx kernel call: each input read once,
    each output written once (f32 sums, the planes and vectors at their
    sizes), and the operations the function needs at the peak for their
    operands' type: f32 at 67 TFLOP/s, the products of bf16 planes and bf16
    vectors (K6a-bf's backward form, K6b-bf) at the bf16 989 TFLOP/s."""
    nn, nh = n * n * B, n * H * B
    peak = BF16_FLOPS if plane_bytes == vec_bytes == 2 else F32_FLOPS
    if name.startswith("K6a"):  # A, dA, Mk, Mi -> rowpart, colpart: B1, B2, two products
        return bound(2 * plane_bytes * nn + 2 * vec_bytes * nh + 2 * 4 * nh + 16,
                     (6 * nn, F32_FLOPS), (4 * nn * H, peak))
    if name.startswith("K6b"):  # A, dA, Gr, Mk, Mi, Gc -> dw4: Gr Mk^T, Mi Gc^T, 4 dots
        return bound(2 * plane_bytes * nn + 4 * vec_bytes * nh + 4 * 4 * B,
                     (8 * nn, F32_FLOPS), (4 * nn * H, peak))
    # K7: A, dA (f32) -> A_m, dA_m (plane_bytes each); per element and plane:
    # first layer 4w (mul, two adds, relu), (depth-1) hidden layers 2w^2 + w,
    # head 2w.
    per = 4 * w + (depth - 1) * (2 * w * w + w) + 2 * w
    return bound(2 * 4 * nn + 2 * plane_bytes * nn + 2 * 2 * 4 * n * w,
                 (2 * per * nn, F32_FLOPS))


def phase_pair(torch, results):
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp

    for label, s in TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        x = make_pair_inputs(torch, n, H, B)
        ma, md = x["mlps"]
        pair_args = (x["A"], x["dA"], x["cvec"], x["Mk"], x["Mi"])
        dw_args = tuple(x[k] for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
        calls = {
            "K6a": (lambda: tp.pair_call(*pair_args), lambda: tp.plain_pair(*pair_args),
                    PAIR_TOL),
            "K6b": (lambda: (tp.pair_dw_call(*dw_args),),
                    lambda: (tp.plain_pair_dw(*dw_args),), PAIR_TOL),
        }
        if label != "genre-H8":  # K7 does not depend on H
            calls["K7"] = (
                lambda: tmod.modulate_pair(x["A"], x["dA"], ma, md, x["emb"]),
                lambda: tmod.plain_modulate_pair(x["A"], x["dA"], ma, md, x["emb"]),
                MODULATE_TOL)
        for name, (kernel, plain, tol) in calls.items():
            with torch.no_grad():
                got, ref, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                errs, worst_abs = [], 0.0
                for a, b, c in zip(got, ref, again):
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        raise RuntimeError(f"{name} {label}: bad output {tuple(a.shape)}")
                    if not torch.equal(a, c):
                        raise RuntimeError(f"{name} {label}: two launches differ")
                    err, _ = rel_err(torch, a, b)
                    errs.append(err)
                    worst_abs = max(worst_abs, float((a - b).abs().max()))
                ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            bms, by = pair_bound(name, n, H, B)
            line = {"phase": 8, "kernel": name, "shape": label, **s,
                    "max_abs_err": worst_abs, "max_rel_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
            extra = {}
            if name == "K6a":
                c = x["cvec"]
                B1 = c[0] * x["A"] + c[1] * x["dA"]
                B2t = (c[2] * x["A"] + c[3] * x["dA"]).transpose(-2, -1)
                extra["yardstick_two_cublas_f32_products_ms"] = time_ms(
                    torch, lambda: (torch.matmul(B1, x["Mk"]), torch.matmul(B2t, x["Mi"])))
            if name == "K7":
                # The wrapper's input preparation is a dozen small torch ops;
                # the launch alone on prepared inputs, for comparison.
                inputs = tmod.kernel_inputs(ma, md, x["emb"])
                extra["launch_only_ms"] = time_ms(
                    torch, lambda: tmod.launch(x["A"], x["dA"], *inputs))
            emit({**line, **extra})
            if not max(errs) <= tol:
                raise RuntimeError(f"{name} {label}: rel err {max(errs):.3e} > {tol}")
            results.setdefault(name, {})[label] = (worst_abs, ms, plain_ms, bms, by, extra)


def flagship_setup(cache, overrides=()):
    """The flagship config's trainer (for its model and seed; ``overrides``
    such as :data:`DIRECTED_FIELD` change its model) and its training dict,
    from the data cache phase 5 wrote."""
    from gncde_tpu_torch.run import common
    from gncde_tpu_torch.train.trainer import Trainer

    with open(FLAGSHIP) as f:
        cfg = common.apply_overrides(common.safe_load(f.read()),
                                     [f"dataset.cache_dir={cache}", *overrides])
    tr = Trainer.from_dict(cfg)
    return tr, tr.dataset.get_training_data()


def flagship_sparse_inputs(torch, cache, H=16, seed=0):
    """The flagship data's own sparse controls at one t per element (train
    dict, bs 128): a BCSR A(t) (its union pattern gives kb) and an ELL A(t)
    (its K), node features M and a cotangent X of width H."""
    import numpy as np

    from gncde_tpu_torch.interp import build_sparse_control

    _, d = flagship_setup(cache)
    ts, coeffs = d["train_t"], d["train_graph_path_coeffs"]
    t = ts[:, ts.shape[1] // 3] + 0.01
    dev = torch.device("cuda")
    b = build_sparse_control("cubic", ts, coeffs, "bcsr", block_size=128).to(dev)
    e = build_sparse_control("cubic", ts, coeffs, "ell").to(dev)
    val, ell = b.adj(t.to(dev)), e.adj(t.to(dev))
    B, n = ts.shape[0], val.layout.n
    rng = np.random.default_rng(seed)
    M, X = (torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=val.layout.block_idx, blocks=val.blocks, nblocks=val.layout.nblocks,
                indices=ell.indices, values=ell.values, M=M, X=X, n=n, bs=128, H=H, B=B)


def scaled_sparse_inputs(torch, n, bw, bs, H, seed=0):
    """The scaled point: a circular +-bw band at bs (BCSR from the edge
    list, no n x n object) and the same band as an ELL (K = 2 bw + 1)."""
    import numpy as np

    from gncde_tpu_torch.ops import bcsr as tb

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    i = np.repeat(np.arange(n), 2 * bw + 1)
    dst = (i + np.tile(np.arange(-bw, bw + 1), n)) % n
    w = (0.1 * rng.random(i.size)).astype(np.float32)
    m = tb.bcsr_from_edges(i, dst, w, n, bs)
    M, X = (torch.tensor(rng.normal(size=(1, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=m.block_idx.to(dev), blocks=m.blocks.to(dev), nblocks=m.nblocks.to(dev),
                indices=torch.tensor(dst.reshape(n, -1).astype(np.int32), device=dev),
                values=torch.tensor(w.reshape(n, -1), device=dev), M=M, X=X, n=n, bs=bs,
                H=H, B=1)


def odd_sparse_inputs(torch, n=300, bs=32, H=5, B=2, K=7, seed=0):
    """Per-element block patterns (bands of different widths and one far
    entry each) widened to one slot count, so padded slots exist; an ELL
    with distinct columns per row and padding (index n) in every row."""
    import numpy as np

    from gncde_tpu_torch.ops import bcsr as tb

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    i, j = np.indices((n, n))
    dense = []
    for b in range(B):
        A = np.where(np.abs(i - j) <= 4 + 20 * b, rng.normal(size=(n, n)), 0.0)
        A[b, n - 1 - b] = 0.5
        dense.append(A.astype(np.float32))
    kb = max(tb.bcsr_from_dense(A, bs).kb for A in dense)
    mats = [tb.bcsr_from_dense(A, bs, kb) for A in dense]
    idx = np.stack([np.sort(np.concatenate([rng.choice(n, K - 2, replace=False),
                                            [n, n]])) for _ in range(B * n)])
    M, X = (torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=dev)
            for _ in range(2))
    return dict(idx=torch.stack([m.block_idx for m in mats]).to(dev),
                blocks=torch.stack([m.blocks for m in mats]).to(dev),
                nblocks=torch.stack([m.nblocks for m in mats]).to(dev),
                indices=torch.tensor(idx.reshape(B, n, K).astype(np.int32), device=dev),
                values=torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32),
                                    device=dev), M=M, X=X, n=n, bs=bs, H=H, B=B)


def _batched(x, core):
    return x if x.dim() == core + 1 else x.unsqueeze(0)


def sparse_library_calls(torch, x):
    """One PyTorch call per kernel for the same function, as yardsticks:
    a BSR tensor @ M (K8), ``sparse.sampled_addmm`` at the stored blocks'
    element CSR (K9), a CSR tensor @ M (K10); the batch as one
    block-diagonal matrix, padded slots and padding entries left out."""
    n, bs, H = x["n"], x["bs"], x["H"]
    idx, blocks, nblocks = _batched(x["idx"], 2), _batched(x["blocks"], 4), _batched(
        x["nblocks"], 1)
    B, nb, kb = idx.shape
    if blocks.shape[0] != B:
        blocks = blocks.expand(B, *blocks.shape[1:])
    N = B * nb * bs
    dev = idx.device
    valid = torch.arange(kb, device=dev) < nblocks.unsqueeze(-1)  # (B, nb, kb)
    cols = (idx.long() + nb * torch.arange(B, device=dev)[:, None, None])[valid]
    crow = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      valid.sum(-1).reshape(-1).cumsum(0)])
    vals = blocks[valid].contiguous()
    Mp = torch.zeros((B, nb * bs, H), device=dev)
    Mp[:, :n] = x["M"]
    Xp = torch.zeros((B, nb * bs, H), device=dev)
    Xp[:, :n] = x["X"]
    Mf, Xf = Mp.reshape(N, H), Xp.reshape(N, H)
    calls = {}
    A_bsr = torch.sparse_bsr_tensor(crow, cols, vals, size=(N, N))
    calls["K8"] = lambda: A_bsr @ Mf
    # K9: every element of a stored block, rows of a block row sharing their
    # column list (sorted: block columns ascend within a block row).
    per_row = valid.sum(-1).reshape(-1) * bs  # entries in each row of a block row
    row_nnz = per_row.repeat_interleave(bs)
    crow9 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), row_nnz.cumsum(0)])
    blk_cols = (cols[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        (per_row).cumsum(0)[:-1]])
    pieces = [blk_cols[s:s + c] for s, c in zip(starts.tolist(), per_row.tolist())]
    col9 = torch.cat([p.repeat(bs) for p in pieces])
    S = torch.sparse_csr_tensor(crow9, col9, torch.zeros(col9.numel(), device=dev),
                                size=(N, N))
    YT = Mf.t().contiguous()
    calls["K9"] = lambda: torch.sparse.sampled_addmm(S, Xf, YT, beta=0.0)
    ind, val = _batched(x["indices"], 2), _batched(x["values"], 2)
    ind = ind.expand(val.shape[0], *ind.shape[1:]).long()
    order = ind.argsort(-1)
    ind, val = ind.gather(-1, order), val.gather(-1, order)
    ok = ind < n
    Bv = ind.shape[0]
    c10 = (ind + n * torch.arange(Bv, device=dev)[:, None, None])[ok]
    crow10 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        ok.sum(-1).reshape(-1).cumsum(0)])
    A_csr = torch.sparse_csr_tensor(crow10, c10, val[ok].contiguous(), size=(Bv * n, Bv * n))
    Mc = _batched(x["M"], 2).expand(Bv, n, H).reshape(Bv * n, H).contiguous()
    calls["K10"] = lambda: A_csr @ Mc
    return calls


def sparse_bound(name, x):
    """(bound_ms, bound_by) of one call: each input read once, each output
    written once (f32, int32 indices), and the f32 operations this data
    needs (valid slots only; ELL entries whose index is not padding)."""
    n, bs, H = x["n"], x["bs"], x["H"]
    B = x["B"]
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    nh = B * n * H * 4
    if name in ("K8", "K9"):
        from gncde_tpu_torch.ops.bcsr import slot_mask

        kb = x["idx"].shape[-1]
        vs = int(slot_mask(x["idx"], x["nblocks"]).sum()) * (B if x["nblocks"].dim() == 1
                                                             else 1)
        flops = 2 * vs * bs * bs * H
        if name == "K8":
            return bound(nbytes(x["idx"]) + nbytes(x["blocks"]) + 2 * nh, (flops, F32_FLOPS))
        out = B * x["idx"].shape[-2] * kb * bs * bs * 4
        return bound(nbytes(x["idx"]) + 2 * nh + out, (flops, F32_FLOPS))
    nnz = int((x["indices"] < n).sum())
    if x["indices"].dim() == 2:
        nnz *= B
    return bound(nbytes(x["indices"]) + nbytes(x["values"]) + 2 * nh,
                 (2 * nnz * H, F32_FLOPS))


def phase_sparse_kernels(torch, cache, results):
    from gncde_tpu_torch.ops import bcsr as tb
    from gncde_tpu_torch.ops import ell_spmm as tell

    s = SCALED
    cases = {"flagship": lambda: flagship_sparse_inputs(torch, cache),
             "scaled": lambda: scaled_sparse_inputs(torch, s["n"], s["bw"], s["bs"], s["H"]),
             "odd": lambda: odd_sparse_inputs(torch)}
    for label, make in cases.items():
        t0 = time.perf_counter()
        x = make()
        setup_s = time.perf_counter() - t0
        mat = tb.BCSR(x["idx"], x["blocks"], x["n"])
        calls = {
            "K8": (lambda: tb.bcsr_spmm(mat, x["M"]), lambda: tb.bcsr_spmm_plain(mat, x["M"])),
            "K9": (lambda: tb.bcsr_sddmm(x["idx"], x["X"], x["M"], x["bs"]),
                   lambda: tb.bcsr_sddmm_plain(x["idx"], x["X"], x["M"], x["bs"])),
            "K10": (lambda: tell.ell_spmm_call(x["indices"], x["values"], x["M"]),
                    lambda: tell.plain_ell_spmm(x["indices"], x["values"], x["M"])),
        }
        try:
            lib, lib_err = sparse_library_calls(torch, x), None
        except Exception as exc:  # the yardstick only; the kernels are held below
            lib, lib_err = {}, f"{type(exc).__name__}: {exc}"
        for name, (kernel, plain) in calls.items():
            with torch.no_grad():
                got, ref, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name} {label}: bad output {tuple(got.shape)}")
                if not torch.equal(got, again):
                    raise RuntimeError(f"{name} {label}: two launches differ")
                err, scale = rel_err(torch, got, ref)
                abs_err = float((got - ref).abs().max())
                ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
                dev_ms, dev_by_name = device_ms(torch, kernel)
                library_ms = library_dev_ms = None
                library_by_name, err_text = {}, lib_err
                if name in lib:
                    try:
                        library_ms = time_ms(torch, lib[name])
                        library_dev_ms, library_by_name = device_ms(torch, lib[name])
                    except Exception as exc:
                        err_text = f"{type(exc).__name__}: {exc}"
            bms, by = sparse_bound(name, x)
            shape = {k: x[k] for k in ("n", "bs", "H", "B")}
            shape.update(kb=x["idx"].shape[-1], K=x["indices"].shape[-1])
            emit({"phase": 10, "kernel": name, "shape": label, **shape, "setup_s": setup_s,
                  "max_abs_err": abs_err, "max_abs_ref": scale, "rel_err": err, "ms": ms,
                  "device_ms": dev_ms, "device_by_name": dev_by_name,
                  "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": library_ms, "library_device_ms": library_dev_ms,
                  "library_device_by_name": library_by_name, "library_error": err_text})
            if not err <= SPARSE_TOL:
                raise RuntimeError(f"{name} {label}: rel err {err:.3e} > {SPARSE_TOL}")
            results.setdefault(name, {})[label] = (abs_err, ms, plain_ms, bms, by, library_ms,
                                                   shape, {"device_ms": dev_ms,
                                                           "library_device_ms": library_dev_ms})
        del x, mat, calls, lib
        torch.cuda.empty_cache()


def route_errors(torch, vf, y, ts, ref_ctrl, ctrl, seed=0, backend=None, repeat=False,
                 precision=None, launches=None):
    """The field ``vf`` through ``ctrl`` against ``ref_ctrl``: the max abs
    err over max|ref| of ``f(t, y)`` at three times per element of ``ts``,
    and a dict of the same for the gradients of ``sum(f * W)`` (W normal
    from ``seed``) with respect to y and every parameter of ``vf``. With
    ``backend`` (or ``precision``) the second route runs under that fusion
    backend (or precision; the first under the default); with ``repeat`` it
    runs twice and must give bitwise equal values and gradients. A
    ``launches`` dict receives the kernel launches of the second route."""
    from gncde_tpu_torch import ops

    def run(ctrl_):
        vf.zero_grad(set_to_none=True)
        y_ = y.detach().clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(seed)
        outs, loss = [], 0.0
        for k in (0.17, 0.5, 0.83):
            out = vf(ts[:, 0] + k * (ts[:, -1] - ts[:, 0]), y_, ctrl_)
            loss = loss + (out * torch.randn(out.shape, generator=gen).to(out.device)).sum()
            outs.append(out.detach())
        loss.backward()
        grads = {"y": y_.grad, **{k: p.grad for k, p in vf.named_parameters()}}
        return torch.stack(outs), grads

    ref, ref_grads = run(ref_ctrl)
    if backend is not None:
        ops.set_fusion_backend(backend)
    if precision is not None:
        ops.set_fusion_precision(precision)
    try:
        before = {k: f.launches for k, f in counters().items()}
        got, got_grads = run(ctrl)
        if launches is not None:
            torch.cuda.synchronize()
            launches.update({k: f.launches - before[k] for k, f in counters().items()})
        if repeat:
            again, again_grads = run(ctrl)
            same = torch.equal(got, again) and all(
                (g is None and again_grads[k] is None) or torch.equal(g, again_grads[k])
                for k, g in got_grads.items())
            if not same:
                raise RuntimeError("two evaluations of the field and its gradients "
                                   "through the same route differ in their bits")
    finally:
        if backend is not None:
            ops.set_fusion_backend("auto")
        if precision is not None:
            ops.set_fusion_precision("f32")
    grad_errs = {}
    for k, g_ref in ref_grads.items():
        g = got_grads[k]
        if g is None or g_ref is None:
            if g is not g_ref:
                raise RuntimeError(f"gradient of {k}: one route gives none")
            continue
        grad_errs[k] = rel_err(torch, g, g_ref)[0]
    return rel_err(torch, got, ref)[0], grad_errs


def sparse_route_error(torch, cache, fmt):
    """:func:`route_errors` of the flagship field at the trainer's init
    through the ``fmt`` sparse control (K8/K9 or K10) against the same field
    through phase 5's slim control (K1/K2), at y = the initial linear map of
    the data's y0 and three times per element of the training dict."""
    from gncde_tpu_torch.interp import build_sparse_control
    from gncde_tpu_torch.models.continuous import make_control

    tr, d = flagship_setup(cache)
    dev = torch.device("cuda")
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    ts, coeffs = d["train_t"], d["train_graph_path_coeffs"]
    dense = make_control(tr.model.interpolation, ts.to(dev), tuple(c.to(dev) for c in coeffs))
    sparse = build_sparse_control(tr.model.interpolation, ts, coeffs, fmt,
                                  block_size=128).to(dev)
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"].to(dev))
    for f in counters().values():
        f.launches = 0
    errs = route_errors(torch, model.vector_field, y, ts.to(dev), dense, sparse,
                        repeat=fmt == "ell")
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters().items()}
    want = ("K1", "K2") + (("K8", "K9") if fmt == "bcsr" else ("K10",))
    if min(launches[k] for k in want) <= 0:
        raise RuntimeError(f"route check through {fmt}: launches {launches}; want {want} > 0")
    del dense, sparse, model
    torch.cuda.empty_cache()
    return errs


def phase_sparse_train(torch, phase, fmt, epochs, cache, first_loss_ref):
    """``epochs`` of the flagship config through the dyn CLI with
    ``sparse_control=true sparse_format=fmt``, after the field check of
    :func:`sparse_route_error`; returns the launch counts of the run."""
    from gncde_tpu_torch.run import dyn

    vf_err, grad_errs = sparse_route_error(torch, cache, fmt)
    with tempfile.TemporaryDirectory() as tmp:
        for f in counters().values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = dyn.main([
            "--config", FLAGSHIP, f"epochs={epochs}", NO_EVAL, "log_freq=1",
            "min_epochs=0", f"dataset.cache_dir={cache}", f"checkpoint_dir={tmp}/ckpt/",
            "device=cuda", "wandb.mode=disabled", "sparse_control=true",
            f"sparse_format={fmt}", "sparse_block_size=128",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    rel = abs(losses[0] - first_loss_ref) / abs(first_loss_ref) if losses else float("nan")
    attempts = [a + r for a, r in zip(res["solver_steps"].get("num_accepted_steps", []),
                                      res["solver_steps"].get("num_rejected_steps", []))]
    emit({"phase": phase, "sparse_format": fmt, "vf_rel_err_vs_k1_route": vf_err,
          "grad_rel_errs_vs_k2_route": grad_errs, "train_losses": losses,
          "first_loss_phase5": first_loss_ref, "first_loss_rel_diff": rel,
          "train_step_s": res["train_step_s"], "solver_steps": res["solver_steps"],
          "solver_attempts_last_step": attempts, "control_bytes": res["control_bytes"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(), "device": res["device"],
          "launches": launches, "wall_s": wall})
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"phase {phase}: non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase {phase}: ran on {res['device']}, not cuda")
    if not vf_err <= SPARSE_VF_TOL:
        raise RuntimeError(f"phase {phase}: the field through the {fmt} control is "
                           f"{vf_err:.3e} off phase 5's K1 route (> {SPARSE_VF_TOL})")
    bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
    if bad:
        raise RuntimeError(f"phase {phase}: gradients through the {fmt} control off phase "
                           f"5's K2 route by more than {SPARSE_GRAD_TOL}: {bad}")
    if not rel <= SPARSE_LOSS_RTOL:
        raise RuntimeError(f"phase {phase}: first loss {losses[0]} vs phase 5's "
                           f"{first_loss_ref}: rel diff {rel:.3e} > {SPARSE_LOSS_RTOL}")
    want = ("K8", "K9") if fmt == "bcsr" else ("K10",)
    never = {"K1", "K2", "K8", "K9", "K10"} - set(want)
    if min(launches[k] for k in want) <= 0 or any(launches[k] for k in never):
        raise RuntimeError(f"phase {phase}: launches {launches}; want {want} > 0 and "
                           f"{sorted(never)} = 0")
    return launches


def phase_scaled(torch):
    """benchmarks/bcsr_scale.py's point as a training step on the card."""
    import numpy as np

    from gncde_tpu_torch.interp import bcsr_control_from_edge_snapshots
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField
    from gncde_tpu_torch.solve import ConstantStepSize, ODETerm, SaveAt, diffeqsolve
    from gncde_tpu_torch.train.trainer import tensor_bytes

    s = SCALED
    n, bw, bs, H, L, T = (s[k] for k in ("n", "bw", "bs", "H", "L", "T"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    i = np.repeat(np.arange(n), 2 * bw + 1)
    src, dst = i, (i + np.tile(np.arange(-bw, bw + 1), n)) % n
    snaps = [(src, dst, (0.1 * rng.random(src.size)).astype(np.float32)) for _ in range(T)]
    t0 = time.perf_counter()
    ctrl = bcsr_control_from_edge_snapshots(np.linspace(0.0, 1.0, T, dtype=np.float32),
                                            snaps, n, block_size=bs,
                                            dtype=torch.bfloat16).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    coeff_bytes = tensor_bytes([ctrl.path.coeffs, ctrl.path.coeffs_T])
    vf = PermEquivGraphVectorField(H, H, H, L, 1, n,
                                   generator=torch.Generator().manual_seed(1)).to(dev)
    y0 = torch.tensor((0.1 * rng.normal(size=(1, n, H))).astype(np.float32), device=dev)

    def step():
        for p in vf.parameters():
            p.grad = None
        sol = diffeqsolve(ODETerm(vf), "Heun", t0=0.0, t1=1.0, dt0=0.25, y0=y0, args=ctrl,
                          stepsize_controller=ConstantStepSize(), saveat=SaveAt(t1=True),
                          max_steps=8)
        loss = sol.ys.square().mean()
        loss.backward()
        with torch.no_grad():
            for p in vf.parameters():
                p -= 1e-3 * p.grad
        return float(loss.detach())

    for f in counters().values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(3)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    launches = {k: f.launches for k, f in counters().items()}
    emit({"phase": 13, **s, "edges_per_knot": int(src.size), "control_build_s": build_s,
          "coefficient_bytes": coeff_bytes,
          "dense_f32_plane_bytes": 4 * 4 * (T - 1) * n * n, "losses": losses,
          "step_s": step_s, "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    if not all(math.isfinite(v) for v in losses) or len(set(losses)) < len(losses):
        raise RuntimeError(f"phase 13: losses not finite or not moving: {losses}")
    if launches["K8"] <= 0 or launches["K9"] <= 0:
        raise RuntimeError(f"phase 13: K8/K9 not launched: {launches}")
    if any(c.dtype != torch.bfloat16 for c in (*ctrl.path.coeffs, *ctrl.path.coeffs_T)):
        raise RuntimeError("phase 13: the coefficient tiles are not stored in bf16")
    return launches


def probe_stepwise(torch, v, planes, idx, tau, Z, layers, rvec=None):
    """One launch of a probe eval variant against its plain version, layer
    by layer from the kernel's own M (read back through ``trace``, as
    :func:`bf16_k1_stepwise`); P4 dma_only (no layers) on its output alone.
    Returns the kernel's output and ``({what: rel err}, max abs err)``."""
    trace, mine = {}, {}
    got = v(planes, idx, tau, Z, layers, rvec=rvec, trace=trace)
    if "M" not in trace:
        return got, errs_of(torch, [("out", got, v.plain(planes, idx, tau, Z, layers,
                                                         rvec=rvec))])
    ref = v.plain(planes, idx, tau, Z, layers, rvec=rvec, given_M=trace["M"], trace=mine)
    pairs = [("out", got, ref)] + [(f"M{l}", a, b)
                                   for l, (a, b) in enumerate(zip(trace["M"], mine["M"]))]
    return got, errs_of(torch, pairs)


def phase_probes(torch, results):
    """Phase 26: the megakernel design probes P1-P6 (``ops/mk_probe.py``) at
    their own shape (n=400, H=32, L=3, B=16, T=12, bf16 planes). First the
    probe timer, the phase's main path, with every count set to 0 before it
    and read after it (every variant must have launched); then each variant
    at t=0.37 against its plain version (:func:`probe_stepwise`; P6 ``seq``
    and ``fusedstep`` stage by stage against the plain step from their own
    stage derivatives, each stage layer by layer from the M of a K1bf launch
    on its input, the free-running distance printed beside, and
    fusedstep against seq), P2 ``fixedslice`` bitwise ``current`` on the
    same planes, and the times of every wrapper and plain version, each
    beside its own bound (:func:`probe_bound`). Returns the timer's
    launches per variant."""
    from gncde_tpu_torch.ops import fused_step as tfs
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import mk_probe as mp
    from gncde_tpu_torch.run import mk_probe as timer
    from gncde_tpu_torch.solve.tableaus import get_tableau

    ps = mp.PROBE_SHAPE
    n, H, L, B = ps["n"], ps["H"], ps["L"], ps["B"]
    shape = dict(n=n, B=B, widths=(H,) * (L + 1))
    mp.reset_launches()
    for f in counters().values():
        f.launches = 0
    t0 = time.perf_counter()
    timings = timer.main(list(PROBE_TIMER_ARGS))
    timer_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in mp.VARIANTS.items()}
    emit({"phase": 26, "timer_s": timer_s, "timer_args": list(PROBE_TIMER_ARGS),
          "launches": launches})
    if any(c <= 0 for c in launches.values()):
        raise RuntimeError(f"phase 26: variants not launched by the timer: {launches}")

    case = timer.make_case(n, H, L, B, ps["T"], torch.device("cuda"))
    planes, ts, layers, y = case["planes"], case["ts"], case["layers"], case["y0"]
    t = torch.full((B,), 0.37, device=y.device)
    idx, tau = mk.interval(ts, t)
    sliced = tuple(p[:, 3:4].contiguous() for p in planes)
    idx3, idx0 = torch.full_like(idx, 3), torch.zeros_like(idx)
    rows = results.setdefault("probes", {})
    with torch.no_grad():
        k1bf = mk.megakernel_vf_eval(planes, idx, tau, y, layers, bf16=True)
        for key, v in mp.VARIANTS.items():
            if v.kind != "eval":
                continue
            p_, i_ = (sliced, idx0) if key == "P2/fixedslice" else (planes, idx)
            rvec = mp.red_operand(p_, i_, tau, case["reductions"]) if v.needs_red else None
            got, (errs, abs_err) = probe_stepwise(torch, v, p_, i_, tau, y, layers, rvec)
            free = rel_err(torch, got, v.plain(p_, i_, tau, y, layers, rvec=rvec))[0]
            extra = dict(stepwise_rel_errs=errs, free_running_rel_err=free,
                         bitwise_k1bf=key != "P2/fixedslice" and torch.equal(got, k1bf))
            if key == "P2/fixedslice":
                current = mk.megakernel_vf_eval(planes, idx3, tau, y, layers, bf16=True)
                extra["bitwise_current"] = torch.equal(got, current)
                if not extra["bitwise_current"]:
                    raise RuntimeError("phase 26 P2/fixedslice: not bitwise P2/current on "
                                       "the same planes")
            ms = time_ms(torch, lambda: v(p_, i_, tau, y, layers, rvec=rvec))
            plain_ms = time_ms(torch, lambda: v.plain(p_, i_, tau, y, layers, rvec=rvec),
                               iters=5, warmup=1)
            tol = PROBE_DMA_TOL if key == "P4/dma_only" else K1_TOL
            kbms, kby = probe_bound(key, shape)
            emit({"phase": 26, "variant": key, "family": v.family, **shape,
                  "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": kbms,
                  "bound_by": kby, "timer": timings[key], **extra})
            check_errs(errs, tol, f"phase 26 {key}")
            rows[key] = (abs_err, ms, plain_ms, kbms, kby, dict(timer=timings[key], **extra))

        def stage(p_, i_, tau_, yi, layers_):
            # The plain eval of a stage input, layer by layer from the M of a
            # K1bf launch on it (K11bf computes bitwise the per-stage K1bf).
            trace = {}
            mk.megakernel_vf_eval(p_, i_, tau_, yi, layers_, bf16=True, trace=trace)
            return mk.plain_vf_eval_bf16(p_, i_, tau_, yi, layers_, given_M=trace["M"])

        tab = get_tableau("tsit5")
        S = tab.num_stages - 1
        t, h = torch.full((B,), 0.02, device=y.device), torch.full((B,), 0.09, device=y.device)
        f0 = mk.megakernel_vf_eval(planes, *mk.interval(ts, t), y, layers, bf16=True)
        seq, fused = (mp.VARIANTS[f"P6/{k}"] for k in ("seq", "fusedstep"))
        step = {k: v(planes, ts, t, y, h, f0, layers, tab) for k, v in
                (("seq", seq), ("fusedstep", fused))}
        ref = seq.plain(planes, ts, t, y, h, f0, layers, tab)
        names = ("y1", "err", "f1", "ks")
        route, _ = errs_of(torch, list(zip(names[:3], step["fusedstep"], step["seq"])))
        sbms, sby = step_bound(n, B, shape["widths"], S, True)
        for key, v in (("P6/seq", seq), ("P6/fusedstep", fused)):
            name = key.split("/")[1]
            free, _ = errs_of(torch, list(zip(names, step[name], ref)))
            stepwise = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab, True,
                                           given_ks=step[name][3], stage=stage)
            errs, abs_err = errs_of(torch, list(zip(names, step[name], stepwise)))
            ms = time_ms(torch, lambda: v(planes, ts, t, y, h, f0, layers, tab))
            plain_ms = time_ms(torch, lambda: v.plain(planes, ts, t, y, h, f0, layers, tab),
                               iters=5, warmup=1)
            extra = dict(stepwise_rel_errs=errs, free_running_rel_errs=free)
            if name == "fusedstep":
                extra.update(rel_errs_vs_seq=route, ctas=B * -(-n // 16),
                             bitwise_seq=all(torch.equal(a, b) for a, b in
                                             zip(step["fusedstep"], step["seq"])),
                             resident_ctas=tfs.capacity(y.device, False, True))
            emit({"phase": 26, "variant": key, "family": v.family, **shape, "method": "tsit5",
                  "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": sbms,
                  "bound_by": sby, "timer": timings[key], **extra})
            rows[key] = (abs_err, ms, plain_ms, sbms, sby, dict(timer=timings[key], **extra))
            check_errs(errs, STEP_TOL, f"phase 26 {key} stage by stage")
        check_errs({"y1": route["y1"]}, STEP_ROUTE_TOL, "phase 26 P6 fusedstep vs seq")
        check_errs({k: route[k] for k in ("err", "f1")}, STEP_TOL,
                   "phase 26 P6 fusedstep vs seq")
    return launches


def make_step_inputs(torch, n, B, widths, seed=0, T=8, nbasis=8):
    """K11's inputs: make_inputs' planes and layers (basis ``(nbasis, 2)``),
    per-element knots (B, T), a query time inside each element's third
    interval, a step h and an FSAL derivative f0, from ``seed``."""
    import numpy as np

    planes, _, _, y, layers, _ = make_inputs(torch, n, B, widths, seed=seed, T=T,
                                             nbasis=nbasis)
    rng = np.random.default_rng(seed + 100)
    dev = torch.device("cuda")
    ts = torch.tensor(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), 1).astype(np.float32),
                      device=dev)
    t = ts[:, 2] + 0.01
    h = torch.tensor(rng.uniform(0.02, 0.08, B).astype(np.float32), device=dev)
    f0 = torch.tensor((0.1 * rng.normal(size=y.shape)).astype(np.float32), device=dev)
    return planes, ts, t, y, h, f0, layers


def step_bound(n, B, widths, S, bf16=False):
    """(bound_ms, bound_by) of one K11 step: the four interval planes read
    once, y and f0 read, y1, err, f1 and the S stage derivatives written;
    S x L products (B1 M and B2^T M, 4 n^2 H each) per element in f32 (with
    ``bf16``, K11bf: bf16 planes and bf16 products)."""
    H = widths[0]
    nh = 4 * B * n * H
    plane_bytes, peak = (2, BF16_FLOPS) if bf16 else (4, F32_FLOPS)
    return bound(4 * plane_bytes * B * n * n + nh * (5 + S),
                 (S * sum(4 * n * n * h * B for h in widths[1:]), peak))


def apply_bound(n, H, B):
    """(bound_ms, bound_by) of one K12/K13 call: A, dA read once, M read,
    out written, the O(n) vectors; the two combinations and two products."""
    return bound(4 * B * (2 * n * n + 2 * n * H + 2 * n + 2 * H),
                 (B * (6 * n * n + 4 * n * n * H), F32_FLOPS))


def abar_bound(n, H, B, slab_bytes=4):
    """(bound_ms, bound_by) of one K5c call: four slabs read once, bf16 M
    read, rowpart and colpart written (f32); the two 4-term combinations in
    f32 and the two bf16 products."""
    return bound(B * (4 * slab_bytes * n * n + 2 * n * H + 2 * 4 * n * H),
                 (B * 14 * n * n, F32_FLOPS), (B * 4 * n * n * H, BF16_FLOPS))


def check_k11(torch, label, s, name, phase, nbasis=8, bf16=False):
    """K11 (or, with ``nbasis`` 11, K11d) at shape ``s`` against its plain
    version (Tsit5): y1, err, f1 and ks within STEP_TOL, two launches
    bitwise equal, and its backward (one K2 per stage) against autograd of
    the plain step within STEP_GRAD_TOL; emits one line and returns the
    kernels line's tuple. With ``bf16`` (K11bf, on bf16 planes) the plain
    step is formed stage by stage from the kernel's stage derivatives, and
    every K2bf launch of the backward is held layer by layer
    (:func:`bf16_step_bwd_stepwise`, STEP_GRAD_TOL; its basis cotangents
    BF16_STAGE_BASIS_TOL); the free-running errors are printed beside
    them."""
    import numpy as np

    from gncde_tpu_torch.ops import fused_step as tfs
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    S = tab.num_stages - 1
    planes, ts, t, y, h, f0, layers = make_step_inputs(torch, **s, nbasis=nbasis)
    extra = {}
    if nbasis == NBASIS_DIRECTED:
        idx, tau = mk.interval(ts, t)
        extra["col_row_gap"] = assert_asymmetric(torch, planes, idx, tau, f"{name} {label}")
    if bf16:
        planes = tuple(p.to(torch.bfloat16) for p in planes)
    kernel = lambda: tfs.fused_step_call(planes, ts, t, y, h, f0, layers, tab,  # noqa: E731
                                         bf16)
    plain = lambda: tfs._step_reference(planes, ts, t, y, h, f0, layers, tab,  # noqa: E731
                                        bf16)
    names = ("y1", "err", "f1", "ks")
    with torch.no_grad():
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        for what, a, c in zip(names, got, again):
            if not torch.equal(a, c):
                raise RuntimeError(f"{name} {label} {what}: two launches differ")
        errs, worst_abs = errs_of(torch, list(zip(names, got, ref)))
        if bf16:
            extra["free_running_rel_errs"] = errs
            stepwise = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab, True,
                                           given_ks=got[3])
            errs, worst_abs = errs_of(torch, list(zip(names, got, stepwise)))
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
    # The backward: the manual chain (one K2 per stage) against autograd
    # of the plain step, on the gradients of sum(y1 W0 + err W1 + f1 W2).
    flat = [p for lp in layers for p in
            (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"], *lp["basis"])]
    rng = np.random.default_rng(1)
    W = [torch.tensor(rng.normal(size=y.shape).astype(np.float32), device=y.device)
         for _ in range(3)]

    def grads(step):
        leaves = [x.detach().clone().requires_grad_(True) for x in (y, f0, *flat)]
        outs = step(leaves[0], leaves[1], leaves[2:])
        torch.autograd.backward(outs[:3], W)
        return [x.grad for x in leaves]

    fused_grads = lambda: grads(lambda y_, f0_, fl: tfs.FusedRKStep.apply(  # noqa: E731
        tab, nbasis, bf16, ts, t, y_, h, f0_, *planes, *fl))
    needs = (False, True, False, True, True)  # y, f0 and the layer parameters
    if bf16:
        from gncde_tpu_torch.ops import megakernel_bwd as mkb

        # The free-running reference: the same chain rule with the plain
        # K2bf per stage on the kernel's stage derivatives.
        def plain_grads():
            out = tfs.step_vjp(tab, planes, ts, t, y, h, f0, got[3], layers, *W, needs,
                               mkb.plain_vf_bwd_bf16)
            return [out[1], out[3], *out[4]]
    else:
        plain_grads = lambda: grads(lambda y_, f0_, fl: tfs._step_reference(  # noqa: E731
            planes, ts, t, y_, h, f0_, mk._unflatten(fl, nbasis), tab))
    bwd_ref, bwd_got = plain_grads(), fused_grads()
    bwd_errs = [rel_err(torch, a, b)[0] for a, b in zip(bwd_got, bwd_ref)]
    if bf16:
        out, stages = bf16_step_bwd_stepwise(torch, tab, planes, ts, t, y, h, f0, got[3],
                                             layers, W, needs)
        if not all(torch.equal(a, b) for a, b in zip(bwd_got, [out[1], out[3], *out[4]])):
            raise RuntimeError(f"{name} {label}: the backward's gradients are not the "
                               "chain's over its K2bf launches")
        extra.update(free_running_bwd_rel_errs=bwd_errs, stage_bwd_worst=[
            max(e.items(), key=lambda kv: kv[1]) for e, _ in stages])
        bwd_errs = [e for errs_, _ in stages for k, e in errs_.items()
                    if not k.startswith("dbasis")]
        for i, (errs_, _) in enumerate(stages):
            check_errs({k: e for k, e in errs_.items() if k.startswith("dbasis")},
                       BF16_STAGE_BASIS_TOL, f"{name} {label} backward, stage {S - i}")
    fwd_bwd_ms, plain_fwd_bwd_ms = time_ms(torch, fused_grads), time_ms(torch, plain_grads)
    bms, by = step_bound(s["n"], s["B"], s["widths"], S, bf16)
    emit({"phase": phase, "kernel": name, "shape": label, **s, "method": "tsit5",
          "resident_ctas": tfs.capacity(y.device, nbasis == NBASIS_DIRECTED, bf16),
          "ctas": s["B"] * -(-s["n"] // 16),
          "max_abs_err": worst_abs, "rel_errs": errs, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bms, "bound_by": by, "bwd_max_rel_err": max(bwd_errs),
          "fwd_bwd_ms": fwd_bwd_ms, "plain_fwd_bwd_ms": plain_fwd_bwd_ms, **extra})
    check_errs(errs, STEP_TOL, f"{name} {label}")
    if not max(bwd_errs) <= STEP_GRAD_TOL:
        raise RuntimeError(f"{name} {label} backward: rel err {max(bwd_errs):.3e} > "
                           f"{STEP_GRAD_TOL}")
    return (worst_abs, ms, plain_ms, bms, by,
            dict(fwd_bwd_ms=fwd_bwd_ms, plain_fwd_bwd_ms=plain_fwd_bwd_ms))


def phase_fused_kernels(torch, results):
    """Phase 14: K11, K12, K13 and K5c against their plain versions."""
    import numpy as np

    from gncde_tpu_torch.ops import fused_basis as tfb
    from gncde_tpu_torch.ops import pipeline as tpl
    from gncde_tpu_torch.ops import tiled as tt

    for label, s in STEP_SHAPES.items():
        results.setdefault("K11", {})[label] = check_k11(torch, label, s, "K11", 14)

    for label, s in APPLY_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        rng = np.random.default_rng(2)
        f = lambda *shape, sc=1.0: torch.tensor(  # noqa: E731
            (sc * rng.normal(size=shape)).astype(np.float32), device="cuda")
        A, dA, M = f(B, n, n, sc=0.1), f(B, n, n, sc=0.1), f(B, n, H)
        dvec, u, sv, w, q = f(B, n), f(B, n), f(B, H), f(B, H), f(2, 2)
        calls = {
            "K12": (lambda: tfb._pallas_forward(A, dA, M, q, dvec, u, sv, w),
                    lambda: tfb.plain_pallas_forward(A, dA, M, q, dvec, u, sv, w)),
            "K13": (lambda: tpl.fused_conv_stream(A, dA, M, dvec, u, sv, w, q),
                    lambda: tpl.plain_conv_stream(A, dA, M, dvec, u, sv, w, q)),
        }
        for name, (kernel, plain) in calls.items():
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {label}: bad output {tuple(got.shape)}")
            if not torch.equal(got, again):
                raise RuntimeError(f"{name} {label}: two launches differ")
            err, scale = rel_err(torch, got, ref)
            abs_err = float((got - ref).abs().max())
            ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
            bms, by = apply_bound(n, H, B)
            emit({"phase": 14, "kernel": name, "shape": label, **s, "max_abs_err": abs_err,
                  "max_abs_ref": scale, "rel_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bms, "bound_by": by})
            if not err <= APPLY_TOL:
                raise RuntimeError(f"{name} {label}: rel err {err:.3e} > {APPLY_TOL}")
            results.setdefault(name, {})[label] = (abs_err, ms, plain_ms, bms, by, {})

    for label, s in TILED_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        _, _, M, _, slabs, _ = make_tiled_inputs(torch, n, H, B)
        wvec = torch.tensor(np.random.default_rng(3).normal(size=(B, 8)).astype(np.float32),
                            device="cuda")
        kernel = lambda: tt.abar_call(slabs, wvec, M)  # noqa: E731
        plain = lambda: tt.plain_abar(slabs, wvec, M)  # noqa: E731
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        errs, worst_abs = [], 0.0
        for a, b, c in zip(got, ref, again):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise RuntimeError(f"K5c {label}: bad output {tuple(a.shape)}")
            if not torch.equal(a, c):
                raise RuntimeError(f"K5c {label}: two launches differ")
            errs.append(rel_err(torch, a, b)[0])
            worst_abs = max(worst_abs, float((a - b).abs().max()))
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        bms, by = abar_bound(n, H, B)
        emit({"phase": 14, "kernel": "K5c", "shape": label, **s, "max_abs_err": worst_abs,
              "max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
              "bound_by": by})
        if not max(errs) <= ABAR_TOL:
            raise RuntimeError(f"K5c {label}: rel err {max(errs):.3e} > {ABAR_TOL}")
        results.setdefault("K5c", {})[label] = (worst_abs, ms, plain_ms, bms, by, {})
    torch.cuda.empty_cache()


def flagship_model_on_card(torch, cache, overrides=()):
    """The flagship model (with ``overrides``) at the trainer's init on the
    card, phase 5's slim control of the training dict, the state y = the
    initial linear map of the data's y0, and the knots."""
    from gncde_tpu_torch.models.continuous import make_control

    tr, d = flagship_setup(cache, overrides)
    dev = torch.device("cuda")
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    ts = d["train_t"].to(dev)
    ctrl = make_control(tr.model.interpolation, ts,
                        tuple(c.to(dev) for c in d["train_graph_path_coeffs"]))
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"].to(dev))
    return model, ctrl, y, ts


def step_route_errors(torch, cache, seed=0, overrides=()):
    """The flagship step (with ``overrides``) at the trainer's init through
    K11 against the per-stage K1 route on the same (t, y, h, f0) (f0 = the
    field at t, h a fiftieth of each element's span): rel errs of (y1, err,
    f1), and those of the gradients of sum(y1 * W) (W normal from ``seed``)
    with respect to y and every field parameter that gets one (K11's chain
    of K2s against K2 per stage), and the launch counts of the fused run."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.solve.solve import _rk_step
    from gncde_tpu_torch.solve.tableaus import get_tableau

    model, ctrl, y, ts = flagship_model_on_card(torch, cache, overrides)
    vf = model.vector_field
    tab = get_tableau(model.method)
    t = ts[:, 0] + 0.1 * (ts[:, -1] - ts[:, 0])
    h = (ts[:, -1] - ts[:, 0]) / 50
    with torch.no_grad():
        f0 = vf(t, y, ctrl)
    W = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed)).to(y.device)

    def run(fused):
        ops.set_fused_step(fused)
        try:
            vf.zero_grad(set_to_none=True)
            y_ = y.detach().clone().requires_grad_(True)
            outs = _rk_step(tab, vf, t, y_, h, ctrl, f0)
            (outs[0] * W).sum().backward()
        finally:
            ops.set_fused_step(False)
        grads = {"y": y_.grad, **{k: p.grad for k, p in vf.named_parameters()}}
        return [o.detach() for o in outs], grads

    ref, ref_grads = run(False)
    for f in counters().values():
        f.launches = 0
    got, got_grads = run(True)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters().items()}
    errs = {k: rel_err(torch, a, b)[0] for k, a, b in zip(("y1", "err", "f1"), got, ref)}
    if any((g is None) != (got_grads[k] is None) for k, g in ref_grads.items()):
        raise RuntimeError("the fused and per-stage steps give gradients to different "
                           "parameters")
    grad_errs = {k: rel_err(torch, got_grads[k], g)[0] for k, g in ref_grads.items()
                 if g is not None}
    del model, ctrl
    torch.cuda.empty_cache()
    return errs, grad_errs, launches


def phase_fused_step_train(torch, cache, first_loss_ref, k1_phase5):
    """Phase 15: the flagship trains with the fused step on."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.run import dyn

    errs, grad_errs, route_launches = step_route_errors(torch, cache)
    with tempfile.TemporaryDirectory() as tmp:
        for f in counters().values():
            f.launches = 0
        ops.set_fused_step(True)
        try:
            t0 = time.perf_counter()
            res = dyn.main([
                "--config", FLAGSHIP, f"epochs={FUSED_EPOCHS}", f"eval_freq={FUSED_EPOCHS}",
                "log_freq=1", "min_epochs=0", f"dataset.cache_dir={cache}",
                f"checkpoint_dir={tmp}/ckpt/",
                "device=cuda", "wandb.mode=disabled",
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.set_fused_step(False)
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    rel = abs(losses[0] - first_loss_ref) / abs(first_loss_ref) if losses else float("nan")
    emit({"phase": 15, "step_rel_errs_vs_k1_route": errs,
          "grad_rel_errs_vs_k2_route": grad_errs, "route_launches": route_launches,
          "train_losses": losses, "first_loss_phase5": first_loss_ref,
          "first_loss_rel_diff": rel, "train_step_s": res["train_step_s"],
          "solver_steps": res["solver_steps"], "best_validation_loss": res["validation_loss"],
          "device": res["device"], "launches": launches, "k1_launches_phase5": k1_phase5,
          "wall_s": wall})
    if len(losses) != FUSED_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"phase 15: non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase 15: ran on {res['device']}, not cuda")
    if route_launches["K11"] <= 0:
        raise RuntimeError(f"phase 15: the route check did not launch K11: {route_launches}")
    if not errs["y1"] <= STEP_ROUTE_TOL:
        raise RuntimeError(f"phase 15: y1 through K11 is {errs['y1']:.3e} off the per-stage "
                           f"K1 route (> {STEP_ROUTE_TOL})")
    bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
    if bad:
        raise RuntimeError(f"phase 15: gradients through K11 off the per-stage K2 route by "
                           f"more than {SPARSE_GRAD_TOL}: {bad}")
    if not rel <= SPARSE_LOSS_RTOL:
        raise RuntimeError(f"phase 15: first loss {losses[0]} vs phase 5's {first_loss_ref}: "
                           f"rel diff {rel:.3e} > {SPARSE_LOSS_RTOL}")
    if launches["K11"] <= 0 or launches["K2"] <= 0 or not launches["K1"] < k1_phase5:
        raise RuntimeError(f"phase 15: launches {launches}; want K11 > 0, K2 > 0 and K1 < "
                           f"phase 5's {k1_phase5}")
    return launches


def phase_backend_train(torch, cache, first_loss_ref):
    """Phase 16: the flagship through the pipeline (K13) and pallas (K12)
    backends, one epoch each; returns the launch counts of each run."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.run import dyn

    out = {}
    for backend, kernel in (("pipeline", "K13"), ("pallas", "K12")):
        model, ctrl, y, ts = flagship_model_on_card(torch, cache)
        vf_err, grad_errs = route_errors(torch, model.vector_field, y, ts, ctrl, ctrl,
                                         backend=backend)
        del model, ctrl
        with tempfile.TemporaryDirectory() as tmp:
            for f in counters().values():
                f.launches = 0
            try:
                t0 = time.perf_counter()
                res = dyn.main([
                    "--config", FLAGSHIP, f"epochs={BACKEND_EPOCHS}", NO_EVAL,
                    "log_freq=1", "min_epochs=0", f"dataset.cache_dir={cache}",
                    f"checkpoint_dir={tmp}/ckpt/", "device=cuda", "wandb.mode=disabled",
                    f"fusion_backend={backend}",
                ])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                ops.set_fusion_backend("auto")
            launches = {k: f.launches for k, f in counters().items()}
        losses = res["train_losses"]
        rel = abs(losses[0] - first_loss_ref) / abs(first_loss_ref) if losses else float("nan")
        attempts = [a + r for a, r in zip(res["solver_steps"].get("num_accepted_steps", []),
                                          res["solver_steps"].get("num_rejected_steps", []))]
        emit({"phase": 16, "fusion_backend": backend, "vf_rel_err_vs_k1_route": vf_err,
              "grad_rel_errs_vs_k2_route": grad_errs, "train_losses": losses,
              "first_loss_phase5": first_loss_ref, "first_loss_rel_diff": rel,
              "train_step_s": res["train_step_s"], "solver_steps": res["solver_steps"],
              "solver_attempts_last_step": attempts, "device": res["device"],
              "launches": launches, "wall_s": wall})
        if len(losses) != BACKEND_EPOCHS or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"phase 16 {backend}: non-finite or missing losses: {losses}")
        if not res["device"].startswith("cuda"):
            raise RuntimeError(f"phase 16 {backend}: ran on {res['device']}, not cuda")
        if not vf_err <= SPARSE_VF_TOL:
            raise RuntimeError(f"phase 16 {backend}: the field is {vf_err:.3e} off phase 5's "
                               f"K1 route (> {SPARSE_VF_TOL})")
        bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
        if bad:
            raise RuntimeError(f"phase 16 {backend}: gradients off phase 5's K2 route by "
                               f"more than {SPARSE_GRAD_TOL}: {bad}")
        if not rel <= SPARSE_LOSS_RTOL:
            raise RuntimeError(f"phase 16 {backend}: first loss {losses[0]} vs phase 5's "
                               f"{first_loss_ref}: rel diff {rel:.3e} > {SPARSE_LOSS_RTOL}")
        if launches[kernel] <= 0 or launches["K1"] or launches["K2"]:
            raise RuntimeError(f"phase 16 {backend}: launches {launches}; want {kernel} > 0 "
                               f"and K1 = K2 = 0")
        out[kernel] = launches
    return out


def directed_route_errors(torch, model, y, ts, coeffs, interpolation, block_size=128):
    """:func:`route_errors` of ``model``'s field at ``y`` through each of
    :data:`DIRECTED_ROUTES` -- the ``pipeline`` and ``pallas`` backends on
    the slim control, the BCSR (``block_size``) and ELL controls -- against
    the default route on the slim control (K1/K2 on the card, the dense
    layer stack on the CPU). ``ts`` and ``coeffs`` are the training dict's
    (on the CPU); the model and ``y`` sit on their device. Returns {route:
    (field rel err, {y or parameter: gradient rel err})}."""
    from gncde_tpu_torch.interp import build_sparse_control
    from gncde_tpu_torch.models.continuous import make_control

    dev = y.device
    ts_d = ts.to(dev)
    dense = make_control(interpolation, ts_d, tuple(c.to(dev) for c in coeffs))
    vf = model.vector_field
    out = {}
    for route in DIRECTED_ROUTES:
        if route in ("pipeline", "pallas"):
            out[route] = route_errors(torch, vf, y, ts_d, dense, dense, backend=route)
        else:
            ctrl = build_sparse_control(interpolation, ts, coeffs, route,
                                        block_size=block_size).to(dev)
            out[route] = route_errors(torch, vf, y, ts_d, dense, ctrl, repeat=route == "ell")
    return out


def directed_tiled_errors(torch, seed=5):
    """The directed field's tiled eval (K3 per layer) at :data:`DIR_TILED`
    against the same eval with K3's plain version on the same bf16 planes,
    and against the f32 dense directed oracle (``plain_vf_eval``); returns
    (rel err vs the plain version, rel err vs the oracle, K3 launches,
    column/row gap)."""
    import numpy as np

    from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField
    from gncde_tpu_torch.ops import megakernel as mk
    from gncde_tpu_torch.ops import tiled as tt

    n, widths, B, T = (DIR_TILED[k] for k in ("n", "widths", "B", "T"))
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    ts = t(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), 1))
    planes = tuple(t(rng.uniform(-0.05, 0.1, (B, T - 1, n, n))) for _ in range(4))
    tq = ts[:, 1] + 0.05
    H = widths[0]
    vf = PermEquivDirGraphVectorField(H, widths[1], widths[-1], len(widths) - 1, 8, n,
                                      generator=torch.Generator().manual_seed(seed)).to(dev)
    Z = t(rng.normal(size=(B, n, H)))
    idx, tau = mk.interval(ts, tq)
    gap = assert_asymmetric(torch, planes, idx, tau, "directed tiled eval")
    red = tt.cubic_plane_reductions(planes)
    with torch.no_grad():
        before = tt.fwd2_call.launches
        got = tt.tiled_vf_eval(planes, ts, tq, Z, vf, red=red)
        torch.cuda.synchronize()
        launched = tt.fwd2_call.launches - before
        real = tt.fwd2_call
        tt.fwd2_call = tt.plain_fwd2  # the same eval, K3's plain version
        try:
            ref = tt.tiled_vf_eval(planes, ts, tq, Z, vf, red=red)
        finally:
            tt.fwd2_call = real
        oracle = mk.plain_vf_eval(planes, idx, tau, Z, mk.layer_params(vf))
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"directed tiled eval: bad output {tuple(got.shape)}")
    return rel_err(torch, got, ref)[0], rel_err(torch, got, oracle)[0], launched, gap


def phase_directed_kernels(torch, cache, results):
    """Phase 17: K1d, K2d and K11d against their plain versions, the
    directed flagship field at init through every other route, and the
    directed tiled eval."""
    phase_k1(torch, results, "K1d", 17, DIR_SHAPES, NBASIS_DIRECTED)
    phase_k2(torch, results, "K2d", 17, DIR_SHAPES, NBASIS_DIRECTED)
    for label, s in STEP_SHAPES.items():
        results.setdefault("K11d", {})[label] = check_k11(torch, label, s, "K11d", 17,
                                                          NBASIS_DIRECTED)

    tr, d = flagship_setup(cache, DIRECTED_FIELD)
    dev = torch.device("cuda")
    model = tr.model.build(torch.Generator().manual_seed(tr.seed)).to(dev)
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"].to(dev))
    for f in counters().values():
        f.launches = 0
    errs = directed_route_errors(torch, model, y, d["train_t"], d["train_graph_path_coeffs"],
                                 tr.model.interpolation)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters().items()}
    del model, y, d
    torch.cuda.empty_cache()
    tiled_err, oracle_err, k3_launched, gap = directed_tiled_errors(torch)
    emit({"phase": 17, "routes": {r: {"vf_rel_err_vs_k1d_route": e,
                                      "grad_rel_errs_vs_k2d_route": g}
                                  for r, (e, g) in errs.items()},
          "route_launches": launches, "tiled": {
              **DIR_TILED, "rel_err_vs_plain": tiled_err, "rel_err_vs_f32_dense_oracle":
              oracle_err, "k3_launches": k3_launched, "col_row_gap": gap}})
    want = ("K1", "K2", "K8", "K9", "K10", "K12", "K13")
    if min(launches[k] for k in want) <= 0:
        raise RuntimeError(f"phase 17 route check: launches {launches}; want {want} > 0")
    for route, (vf_err, grad_errs) in errs.items():
        if not vf_err <= SPARSE_VF_TOL:
            raise RuntimeError(f"phase 17: the directed field through {route} is "
                               f"{vf_err:.3e} off the K1d route (> {SPARSE_VF_TOL})")
        bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
        if bad:
            raise RuntimeError(f"phase 17: gradients through {route} off the K2d route by "
                               f"more than {SPARSE_GRAD_TOL}: {bad}")
    if k3_launched <= 0 or not tiled_err <= TILED_TOL:
        raise RuntimeError(f"phase 17: the directed tiled eval is {tiled_err:.3e} off its "
                           f"plain version (> {TILED_TOL}) or K3 did not launch "
                           f"({k3_launched})")


def phase_trade(torch):
    """Phase 18: the directed trade config trains through K1d and K2d."""
    launches = run_tgb(torch, 18, TRADE_CONFIG, TRADE_SNAPSHOTS, TRADE_WINDOWS,
                       dataset="tgbn-trade")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise RuntimeError(f"phase 18: directed K1/K2 not launched: {launches}")
    if launches["K3"] or launches["K4"]:
        raise RuntimeError(f"phase 18: the n=255 path launched the tiled kernels: {launches}")
    return launches


def phase_genre_dir(torch):
    """Phase 19: the directed genre config trains through K3 and K4."""
    launches = run_tgb(torch, 19, GENRE_DIR_CONFIG, GENRE_SNAPSHOTS, GENRE_WINDOWS)
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise RuntimeError(f"phase 19: tiled kernels not launched: {launches}")
    if launches["K1"] or launches["K2"]:
        raise RuntimeError(f"phase 19: the n=1505 path launched K1/K2: {launches}")
    return launches


def phase_directed_fused_train(torch, cache):
    """Phase 20: the directed flagship with the fused step on: the step at
    init through K11d against the per-stage K1d route, then one epoch."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.run import dyn

    errs, grad_errs, route_launches = step_route_errors(torch, cache,
                                                          overrides=DIRECTED_FIELD)
    with tempfile.TemporaryDirectory() as tmp:
        for f in counters().values():
            f.launches = 0
        ops.set_fused_step(True)
        try:
            t0 = time.perf_counter()
            res = dyn.main([
                "--config", FLAGSHIP, f"epochs={DIRECTED_EPOCHS}", NO_EVAL,
                "log_freq=1", "min_epochs=0", f"dataset.cache_dir={cache}",
                f"checkpoint_dir={tmp}/ckpt/", "device=cuda", "wandb.mode=disabled",
                *DIRECTED_FIELD,
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.set_fused_step(False)
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    emit({"phase": 20, "step_rel_errs_vs_k1d_route": errs,
          "grad_rel_errs_vs_k2d_route": grad_errs, "route_launches": route_launches,
          "train_losses": losses, "train_step_s": res["train_step_s"],
          "solver_steps": res["solver_steps"], "device": res["device"],
          "launches": launches, "wall_s": wall})
    if len(losses) != DIRECTED_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"phase 20: non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"phase 20: ran on {res['device']}, not cuda")
    if route_launches["K11"] <= 0:
        raise RuntimeError(f"phase 20: the route check did not launch K11: {route_launches}")
    if not errs["y1"] <= STEP_ROUTE_TOL:
        raise RuntimeError(f"phase 20: y1 through K11d is {errs['y1']:.3e} off the per-stage "
                           f"K1d route (> {STEP_ROUTE_TOL})")
    bad = {k: v for k, v in grad_errs.items() if not v <= SPARSE_GRAD_TOL}
    if bad:
        raise RuntimeError(f"phase 20: gradients through K11d off the per-stage K2d route by "
                           f"more than {SPARSE_GRAD_TOL}: {bad}")
    if launches["K11"] <= 0 or launches["K2"] <= 0:
        raise RuntimeError(f"phase 20: launches {launches}; want K11 > 0 and K2 > 0")
    return launches


def bf16_route_check(torch, cache, overrides=()):
    """The flagship field (with ``overrides``) at the trainer's init under
    fusion_precision bf16, at :func:`route_errors`' three times: each eval
    and its gradients (of sum(f * W), W normal) through the field, bitwise
    equal to one K1bf and one K2bf launch on the same inputs, each held layer
    by layer against its plain version (:func:`bf16_k1_stepwise`,
    :func:`bf16_k2_stepwise`); and :func:`route_errors` of the bf16 control
    against the f32 one (K1/K2). Returns ``(stepwise rel errs, field rel
    err and gradient rel errs against the f32 route, launches of the bf16
    route)``."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.ops import megakernel as mk

    model, ctrl, y, ts = flagship_model_on_card(torch, cache, overrides)
    ops.set_fusion_precision("bf16")
    try:
        _, ctrl_bf, _, _ = flagship_model_on_card(torch, cache, overrides)
    finally:
        ops.set_fusion_precision("f32")
    if ctrl_bf.path.coeffs[0].dtype != torch.bfloat16:
        raise RuntimeError("phase 21: the bf16 control does not store bf16 stacks")
    vf = model.vector_field
    launches = {}
    vf_err, grad_errs = route_errors(torch, vf, y, ts, ctrl, ctrl_bf, precision="bf16",
                                     launches=launches)
    path, layers, flat = ctrl_bf.path, mk.layer_params(vf), mk.flatten_params(vf)
    planes = tuple(path.coeffs)
    knots = path.ts if path.ts.dim() == 2 else path.ts.unsqueeze(0).expand(y.shape[0], -1)
    gen = torch.Generator().manual_seed(0)
    stepwise = {}
    ops.set_fusion_precision("bf16")
    try:
        for k in (0.17, 0.5, 0.83):
            t = ts[:, 0] + k * (ts[:, -1] - ts[:, 0])
            vf.zero_grad(set_to_none=True)
            y_ = y.detach().clone().requires_grad_(True)
            out = vf(t, y_, ctrl_bf)
            W = torch.randn(out.shape, generator=gen).to(out.device)
            (out * W).sum().backward()
            idx, tau = mk.interval(knots, t)
            with torch.no_grad():
                got, (e1, _) = bf16_k1_stepwise(torch, planes, idx, tau, y, layers)
                (_, dZ, per_layer), (e2, _) = bf16_k2_stepwise(torch, planes, idx, tau, y,
                                                               layers, W, False)
            same = (torch.equal(got, out.detach()) and torch.equal(dZ, y_.grad)
                    and all(torch.equal(g, p.grad)
                            for g, p in zip(mk.flat_grads(per_layer), flat)))
            if not same:
                raise RuntimeError("phase 21: the bf16 route's value or gradients are not "
                                   "those of its K1bf and K2bf launches")
            stepwise[f"t{k}"] = {"K1bf": e1, "K2bf": e2}
    finally:
        ops.set_fusion_precision("f32")
    del model, ctrl, ctrl_bf
    torch.cuda.empty_cache()
    return stepwise, vf_err, grad_errs, launches


def bf16_train(torch, cache, fused, overrides=()):
    """One epoch of the flagship (with ``overrides``) with
    ``fusion_precision=bf16``, per stage or with the fused step; returns the
    result and the launch counts."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.run import dyn

    with tempfile.TemporaryDirectory() as tmp:
        for f in counters().values():
            f.launches = 0
        ops.set_fused_step(fused)
        try:
            t0 = time.perf_counter()
            res = dyn.main([
                "--config", FLAGSHIP, f"epochs={BF16_EPOCHS}", NO_EVAL, "log_freq=1",
                "min_epochs=0", f"dataset.cache_dir={cache}", f"checkpoint_dir={tmp}/ckpt/",
                "device=cuda", "wandb.mode=disabled", *BF16, *overrides,
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ops.set_fused_step(False)
            ops.set_fusion_precision("f32")
        launches = {k: f.launches for k, f in counters().items()}
    losses = res["train_losses"]
    attempts = [a + r for a, r in zip(res["solver_steps"].get("num_accepted_steps", []),
                                      res["solver_steps"].get("num_rejected_steps", []))]
    line = {"fused_step": fused, "directed": bool(overrides), "train_losses": losses,
            "train_step_s": res["train_step_s"], "solver_attempts_last_step": attempts,
            "solver_steps": res["solver_steps"], "device": res["device"],
            "launches": launches, "wall_s": wall}
    what = f"phase 21 ({'fused' if fused else 'per stage'}{', directed' if overrides else ''})"
    if len(losses) != BF16_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{what}: non-finite or missing train losses: {losses}")
    if not res["device"].startswith("cuda"):
        raise RuntimeError(f"{what}: ran on {res['device']}, not cuda")
    want = ("K11bf", "K2bf", "K1bf") if fused else ("K1bf", "K2bf")
    f32 = ("K1", "K2", "K11") + (() if fused else ("K11bf",))
    if min(launches[k] for k in want) <= 0 or any(launches[k] for k in f32):
        raise RuntimeError(f"{what}: launches {launches}; want {want} > 0 and {f32} = 0")
    return line, launches


def phase_bf16(torch, cache, results):
    """Phase 21: fusion_precision bf16. K1bf, K2bf, K11bf (both bases)
    against their plain bf16 versions; the flagship field at init through
    K1bf/K2bf against the f32 route (both bases) and the step through K11bf
    against the per-stage K1bf route; then one epoch per stage, one fused,
    and one of the directed field fused. Returns the three runs' launches."""
    from gncde_tpu_torch import ops

    phase_k1(torch, results, "K1bf", 21, SHAPES, 8, bf16=True)
    phase_k1(torch, results, "K1dbf", 21, SHAPES, NBASIS_DIRECTED, bf16=True)
    phase_k2(torch, results, "K2bf", 21, SHAPES, 8, bf16=True)
    phase_k2(torch, results, "K2dbf", 21, SHAPES, NBASIS_DIRECTED, bf16=True)
    for label, s in STEP_SHAPES.items():
        results.setdefault("K11bf", {})[label] = check_k11(torch, label, s, "K11bf", 21,
                                                           bf16=True)
        results.setdefault("K11dbf", {})[label] = check_k11(torch, label, s, "K11dbf", 21,
                                                            NBASIS_DIRECTED, bf16=True)

    routes = {}
    for basis, overrides in (("undirected", ()), ("directed", DIRECTED_FIELD)):
        stepwise, vf_err, grad_errs, launches = bf16_route_check(torch, cache, overrides)
        for at, errs in stepwise.items():
            check_errs(errs["K1bf"], K1_TOL, f"phase 21 {basis} {at}: the route's K1bf")
            check_errs(errs["K2bf"], K2_TOL, f"phase 21 {basis} {at}: the route's K2bf")
        zero = {k: e for k, e in [("field", vf_err), *grad_errs.items()]
                if not (math.isfinite(e) and e > 0.0)}
        if zero:
            raise RuntimeError(f"phase 21 {basis}: the bf16 route's distance to the f32 route "
                               f"must be finite and nonzero: {zero}")
        if launches["K1bf"] <= 0 or launches["K2bf"] <= 0 or launches["K1"] or launches["K2"]:
            raise RuntimeError(f"phase 21 {basis}: the bf16 route launched {launches}")
        ops.set_fusion_precision("bf16")
        try:
            step_errs, step_grad_errs, step_launches = step_route_errors(
                torch, cache, overrides=overrides)
        finally:
            ops.set_fusion_precision("f32")
        if step_launches["K11bf"] <= 0 or step_launches["K11"]:
            raise RuntimeError(f"phase 21 {basis}: the step route launched {step_launches}")
        if not step_errs["y1"] <= STEP_ROUTE_TOL:
            raise RuntimeError(f"phase 21 {basis}: y1 through K11bf is {step_errs['y1']:.3e} "
                               f"off the per-stage K1bf route (> {STEP_ROUTE_TOL})")
        check_errs(step_grad_errs, BF16_STEP_ROUTE_GRAD_TOL,
                   f"phase 21 {basis}: gradient through K11bf against the per-stage route")
        routes[basis] = {"stepwise_rel_errs": stepwise,
                         "vf_rel_err_vs_f32_route": vf_err,
                         "grad_rel_errs_vs_f32_route": grad_errs, "route_launches": launches,
                         "step_rel_errs_vs_k1bf_route": step_errs,
                         "step_grad_rel_errs_vs_k2bf_route": step_grad_errs,
                         "step_route_launches": step_launches}

    runs = {"per_stage": bf16_train(torch, cache, False),
            "fused": bf16_train(torch, cache, True),
            "directed_fused": bf16_train(torch, cache, True, DIRECTED_FIELD)}
    emit({"phase": 21, "routes": routes, "train": {k: v[0] for k, v in runs.items()}})
    return {k: v[1] for k, v in runs.items()}


def bf16_ulps(torch, got, ref, slack=MODULATE_TOL):
    """Largest distance of two bf16 tensors in units of one bf16 ulp of the
    reference element plus ``slack`` of max|ref| (the f32 error the two
    values may carry before their rounding to bf16)."""
    g, r = got.double(), ref.double()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return float(((g - r).abs() / (ulp + slack * float(r.abs().max()))).max())


def phase_pair_bf16(torch, results):
    """Phase 22: K7bf, K6a-bf (with the forward's f32 vectors and the
    backward's bf16 ones) and K6b-bf against their plain versions on the
    same card tensors at :data:`PAIR_BF16_SHAPES`, each timed beside the f32
    kernel on the same shape."""
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp

    bf = torch.bfloat16
    for label, s in PAIR_BF16_SHAPES.items():
        n, H, B = s["n"], s["H"], s["B"]
        x = make_pair_inputs(torch, n, H, B)
        ma, md = x["mlps"]
        A, dA = x["A"].to(bf), x["dA"].to(bf)
        vb = {k: x[k].to(bf) for k in ("Mk", "Mi", "Gr", "Gc")}
        f32_pair = (x["A"], x["dA"], x["cvec"], x["Mk"], x["Mi"])
        f32_dw = tuple(x[k] for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
        # name: (args, kernel, plain, the f32 kernel on this shape, bound sizes)
        calls = {
            "K6a-bf": ((A, dA, x["cvec"], x["Mk"], x["Mi"]), tp.pair_call, tp.plain_pair,
                       lambda: tp.pair_call(*f32_pair), dict(plane_bytes=2)),
            "K6a-bf-bf16-vectors": ((A, dA, x["cvec"], vb["Mk"], vb["Mi"]), tp.pair_call,
                                    tp.plain_pair, lambda: tp.pair_call(*f32_pair),
                                    dict(plane_bytes=2, vec_bytes=2)),
            "K6b-bf": ((A, dA, vb["Gr"], vb["Mk"], vb["Mi"], vb["Gc"]),
                       lambda *a: (tp.pair_dw_call(*a),), lambda *a: (tp.plain_pair_dw(*a),),
                       lambda: tp.pair_dw_call(*f32_dw), dict(plane_bytes=2, vec_bytes=2)),
        }
        if label != "genre-H8":  # K7 does not depend on H
            calls["K7bf"] = ((x["A"], x["dA"], ma, md, x["emb"], bf), tmod.modulate_pair,
                             tmod.plain_modulate_pair,
                             lambda: tmod.modulate_pair(x["A"], x["dA"], ma, md, x["emb"]),
                             dict(plane_bytes=2))
        for name, (args, kernel, plain, f32_kernel, sizes) in calls.items():
            with torch.no_grad():
                got, ref, again = kernel(*args), plain(*args), kernel(*args)
                torch.cuda.synchronize()
                errs, rels, worst_abs = [], [], 0.0
                for a, b, c in zip(got, ref, again):
                    if (a.shape != b.shape or a.dtype != b.dtype
                            or not torch.isfinite(a.float()).all()):
                        raise RuntimeError(f"{name} {label}: bad output {tuple(a.shape)} "
                                           f"{a.dtype}")
                    if not torch.equal(a, c):
                        raise RuntimeError(f"{name} {label}: two launches differ")
                    rels.append(rel_err(torch, a.float(), b.float())[0])
                    errs.append(bf16_ulps(torch, a, b) if name == "K7bf" else rels[-1])
                    worst_abs = max(worst_abs, float((a.float() - b.float()).abs().max()))
                if name == "K7bf" and not all(
                        torch.equal(a, b.to(bf)) for a, b in zip(got, f32_kernel())):
                    raise RuntimeError(f"K7bf {label}: not K7's f32 output rounded once")
                ms = time_ms(torch, lambda: kernel(*args))
                plain_ms = time_ms(torch, lambda: plain(*args))
                f32_ms = time_ms(torch, f32_kernel)
            bms, by = pair_bound(name, n, H, B, **sizes)
            tol = K7BF_ULPS if name == "K7bf" else PAIR_TOL
            extra = {"max_rel_err": max(rels), "f32_kernel_ms": f32_ms}
            if name == "K7bf":
                extra["max_bf16_ulps"] = max(errs)
            emit({"phase": 22, "kernel": name, "shape": label, **s, "max_abs_err": worst_abs,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "tol": tol, **extra})
            if not max(errs) <= tol:
                raise RuntimeError(f"phase 22: {name} {label} is {max(errs):.3e} off its plain "
                                   f"version (> {tol}{' bf16 ulps' if name == 'K7bf' else ''})")
            results.setdefault(name, {})[label] = (worst_abs, ms, plain_ms, bms, by, extra)


def check_launches(launches, phase, want, forbidden):
    if min(launches[k] for k in want) <= 0 or any(launches[k] for k in forbidden):
        raise RuntimeError(f"phase {phase}: launches {launches}; want {want} > 0 and "
                           f"{forbidden} = 0")


def phase_dir_enc_idx(torch, phase, config, snapshots, windows, dataset):
    """Phases 23 (trade) and 24 (genre): one training window of a directed
    enc_idx config at full width through K7, K6a and K6b."""
    launches = run_tgb(torch, phase, config, snapshots, windows, dataset=dataset)
    check_launches(launches, phase, ENC_IDX_KERNELS, HERMITE_KERNELS + ENC_IDX_BF16_KERNELS)
    return launches


def enc_idx_micro_case(torch, n, H, L, idx_dim, seed=0, device="cuda"):
    """benchmarks/enc_idx_micro.py's ``bench_shape`` on ``device``: the
    directed enc_idx field (emb encoder) with output width H, a control of
    T = 6 knots on [0, 1] with planes uniform * 0.1 (f32 stacks), the state
    normal, t = 0.37, B = 1, from ``seed``."""
    import numpy as np

    from gncde_tpu_torch.interp import (CubicInterpolation, MatrixControl,
                                        backward_hermite_coefficients)
    from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    vf = PermEquivDirGraphVectorField(H, H, H, L, 1, n, enc_idx=True, enc_type="emb",
                                      idx_dim=idx_dim,
                                      generator=torch.Generator().manual_seed(seed)).to(dev)
    ts = torch.linspace(0.0, 1.0, 6, device=dev)[None]
    A = torch.tensor((rng.uniform(size=(1, 6, n, n)) * 0.1).astype(np.float32), device=dev)
    ctrl = MatrixControl(CubicInterpolation(ts, backward_hermite_coefficients(ts, A)))
    y = torch.tensor(rng.normal(size=(1, n, H)).astype(np.float32), device=dev)
    return vf, ctrl, y, torch.full((1,), 0.37, device=dev)


def enc_idx_bf16_errors(torch, vf, ctrl, y, t, seed=0):
    """The enc_idx field ``vf`` at ``(t, y)`` under fusion_precision bf16
    (set by the caller) and its gradients of sum(f * W) (W normal from
    ``seed``) through the kernels (K7bf, K6a-bf, K6b-bf), held against the
    plain versions on the CPU from the route's own intermediates:

    * ``field``: the value against the plain stack started from K7bf's own
      planes (K7bf launched again on the field's A(t), dA(t): no reductions,
      so bitwise its launch in the field); the forward rounds nothing after
      the planes, so only f32 sums differ;
    * ``pair``: every plane-pair apply of the route (one per layer), its
      outputs and its six cotangents from the route's own output cotangents,
      against the plain versions on the same inputs: ``fwd`` (rowpart,
      colpart), ``d_M`` (d_Mk, d_Mi), ``d_c`` (the coefficient cotangents,
      which reach the basis) as relative errors, ``d_planes`` in bf16 ulps
      beyond PAIR_TOL;
    * ``modulation``: the gradients of the modulation MLPs and the index
      encoder against the plain f32 chain's backward from the route's own
      total plane cotangents (bf16, as the route sums them);
    * ``free_running``: every gradient against the plain stack run alone
      from K7bf's planes (reported, not held: the backward rounds each
      layer's output cotangents to bf16, where f32 last-bit differences flip
      whole bf16 ulps, and the flips compound over the layers).

    Returns ``(errors, the kernel route's launches, its value)``."""
    import copy

    from gncde_tpu_torch.models.vector_fields.fields import enc_idx_planes
    from gncde_tpu_torch.ops import modulate as tmod
    from gncde_tpu_torch.ops import pair as tp

    class GivenPlanes(torch.autograd.Function):
        """Forward: the given planes; backward: their cotangent in f32 to
        the plain chain, as the field's fused modulation does."""

        @staticmethod
        def forward(ctx, planes, chain):
            return planes.clone()

        @staticmethod
        def backward(ctx, g):
            return None, g.float()

    records, plane_grads = [], {}
    apply = tp.plane_pair_apply

    def recording(*args):
        rec = {"args": tuple(a.detach() for a in args)}
        out = apply(*args)
        rec["out"] = tuple(o.detach() for o in out)
        for k, o in zip(("g_r", "g_c"), out):
            o.register_hook(lambda g, k=k: rec.__setitem__(k, g))
        if not records:  # the modulated planes: their total cotangents
            for k, P in zip(("A", "dA"), args[:2]):
                P.register_hook(lambda g, k=k: plane_grads.__setitem__(k, g))
        records.append(rec)
        return out

    W = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed)).to(y.device)
    vf.zero_grad(set_to_none=True)
    y_ = y.detach().clone().requires_grad_(True)
    before = {k: f.launches for k, f in counters().items()}
    tp.plane_pair_apply = recording
    try:
        out = vf(t, y_, ctrl)
        (out * W).sum().backward()
    finally:
        tp.plane_pair_apply = apply
    if y.is_cuda:
        torch.cuda.synchronize()
    launches = {k: f.launches - before[k] for k, f in counters().items()}
    grads = {"state": y_.grad, **{k: p.grad for k, p in vf.named_parameters()}}

    # The plain stack on the CPU from K7bf's own planes.
    with torch.no_grad():
        A_t, dA_t = enc_idx_planes(ctrl, t, y.shape[0])
        planes = tmod.modulate_pair(A_t, dA_t, vf.msg_func_adj, vf.msg_func_adj_deriv,
                                    vf.idx_enc.node_embedding(), torch.bfloat16)
    vc = copy.deepcopy(vf).cpu()
    vc.zero_grad(set_to_none=True)
    emb = vc.idx_enc.node_embedding()
    chains = (tmod.modulate_matrix(A_t.cpu(), vc.msg_func_adj, emb),
              tmod.modulate_matrix(dA_t.cpu(), vc.msg_func_adj_deriv, emb))
    A_m, dA_m = (GivenPlanes.apply(P.cpu(), c) for P, c in zip(planes, chains))
    yc = y.detach().cpu().requires_grad_(True)
    ref = tp.tiled_vf_eval_planes(A_m, dA_m, yc, vc)
    (ref * W.cpu()).sum().backward()
    ref_grads = {"state": yc.grad, **{k: p.grad for k, p in vc.named_parameters()}}
    errs = {"field": rel_err(torch, out.detach().cpu(), ref.detach())[0],
            "free_running": {k: rel_err(torch, g.cpu(), ref_grads[k])[0]
                             for k, g in grads.items()}}

    # Each plane-pair apply of the route against its plain version, from the
    # route's own inputs and output cotangents.
    pair = {"fwd": 0.0, "d_M": 0.0, "d_c": 0.0, "d_planes": 0.0}
    for rec in records:
        res = []
        for dev in (y.device, torch.device("cpu")):  # the route's device, the plain one
            leaves = [a.detach().to(dev).requires_grad_(True) for a in rec["args"]]
            o = apply(*leaves)
            res.append((o, torch.autograd.grad(o, leaves, (rec["g_r"].to(dev),
                                                           rec["g_c"].to(dev)))))
        (ko, kg), (po, pg) = res
        for a, b, c in zip(ko, rec["out"], po):
            if not torch.equal(a.detach(), b):
                raise RuntimeError("a plane-pair apply of the route is not repeatable")
            pair["fwd"] = max(pair["fwd"], rel_err(torch, a.detach().cpu(), c.detach())[0])
        d_pl = [bf16_ulps(torch, a.cpu(), b, PAIR_TOL) for a, b in zip(kg[:2], pg[:2])]
        pair["d_planes"] = max(pair["d_planes"], *d_pl)
        pair["d_c"] = max(pair["d_c"], *(rel_err(torch, a.cpu(), b)[0]
                                         for a, b in zip(kg[2:4], pg[2:4])))
        pair["d_M"] = max(pair["d_M"], *(rel_err(torch, a.cpu(), b)[0]
                                         for a, b in zip(kg[4:], pg[4:])))
    errs["pair"] = pair

    # The modulation's gradients from the route's own plane cotangents.
    vc.zero_grad(set_to_none=True)
    emb = vc.idx_enc.node_embedding()
    chains = (tmod.modulate_matrix(A_t.cpu(), vc.msg_func_adj, emb),
              tmod.modulate_matrix(dA_t.cpu(), vc.msg_func_adj_deriv, emb))
    torch.autograd.backward(chains, (plane_grads["A"].float().cpu(),
                                     plane_grads["dA"].float().cpu()))
    errs["modulation"] = {k: rel_err(torch, grads[k].cpu(), p.grad)[0]
                          for k, p in vc.named_parameters()
                          if k.startswith(("idx_enc", "msg_func_adj"))}
    errs["layers_records"] = len(records)
    return errs, launches, out.detach()


def check_enc_idx_bf16(errs, what):
    """Raise unless :func:`enc_idx_bf16_errors` are within phase 25's bounds:
    the field ENC_IDX_BF16_TOL; each pair apply's outputs PAIR_TOL, its d_M
    and d_c (the state's and the layers' gradients are these through f32
    glue) K2_TOL, its bf16 plane cotangents one ulp; the modulation's
    gradients ENC_IDX_BF16_MOD_GRAD_TOL."""
    p = errs["pair"]
    bad = {k: v for k, v, tol in (
        ("field", errs["field"], ENC_IDX_BF16_TOL), ("pair fwd", p["fwd"], PAIR_TOL),
        ("pair d_M", p["d_M"], K2_TOL), ("pair d_c", p["d_c"], K2_TOL),
        ("pair d_planes (bf16 ulps)", p["d_planes"], K7BF_ULPS),
        *((f"modulation {k}", v, ENC_IDX_BF16_MOD_GRAD_TOL)
          for k, v in errs["modulation"].items())) if not v <= tol}
    if bad:
        raise RuntimeError(f"{what}: off the plain versions: {bad}")


def phase_enc_idx_bf16(torch):
    """Phase 25: fusion_precision bf16 on the enc_idx route. The directed
    enc_idx field at :data:`ENC_IDX_MICRO_SHAPES` through K7bf -> K6a-bf
    (backward K6a-bf, K6b-bf) against the plain versions
    (:func:`enc_idx_bf16_errors`), and its distance to the f32 route
    (finite and nonzero: the witness that the bf16 kernels ran); then one
    bf16 training window of phase 23's config. Returns that window's
    launches."""
    from gncde_tpu_torch import ops

    ops.set_fusion_precision("bf16")
    try:
        for label, s in ENC_IDX_MICRO_SHAPES.items():
            vf, ctrl, y, t = enc_idx_micro_case(torch, **s)
            errs, launches, out = enc_idx_bf16_errors(torch, vf, ctrl, y, t)
            ops.set_fusion_precision("f32")
            with torch.no_grad():
                out32 = vf(t, y, ctrl)
            ops.set_fusion_precision("bf16")
            f32_dist = rel_err(torch, out, out32)[0]
            emit({"phase": 25, "shape": label, **s, **errs, "f32_route_rel_dist": f32_dist,
                  "launches": launches})
            what = f"phase 25 {label}"
            L = s["L"]
            if (launches["K7bf"], launches["K6a-bf"], launches["K6b-bf"]) != (1, 2 * L, L) or any(
                    launches[k] for k in ENC_IDX_KERNELS + HERMITE_KERNELS):
                raise RuntimeError(f"{what}: launches {launches}")
            check_enc_idx_bf16(errs, what)
            if not (math.isfinite(f32_dist) and f32_dist > 0.0):
                raise RuntimeError(f"{what}: the bf16 field's distance to the f32 route must "
                                   f"be finite and nonzero: {f32_dist}")
            del vf, ctrl, y, out, out32
            torch.cuda.empty_cache()
        launches = run_tgb(torch, 25, TRADE_DIR_ENC_IDX_CONFIG, TRADE_SNAPSHOTS, TRADE_WINDOWS,
                           dataset="tgbn-trade")
    finally:
        ops.set_fusion_precision("f32")
    check_launches(launches, 25, ENC_IDX_BF16_KERNELS, ENC_IDX_KERNELS + HERMITE_KERNELS)
    return launches


def main() -> int:
    torch = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = time.perf_counter() - t0
        return out

    timed(1, phase_device, torch)
    timed(2, phase_build)
    results = {}
    timed(3, phase_k1, torch, results)
    timed(4, phase_k2, torch, results)
    with tempfile.TemporaryDirectory() as cache:  # phases 5, 10-12, 15-17, 20, 21 share the flagship data
        dyn_launches, dyn_losses = timed(5, phase_train, torch, cache)
        timed(6, phase_tiled, torch, results)
        tgb_launches = timed(7, phase_tgb, torch)
        timed(8, phase_pair, torch, results)
        enc_launches = timed(9, phase_enc_idx, torch)
        timed(10, phase_sparse_kernels, torch, cache, results)
        bcsr_launches = timed(11, phase_sparse_train, torch, 11, "bcsr", BCSR_EPOCHS, cache,
                              dyn_losses[0])
        ell_launches = timed(12, phase_sparse_train, torch, 12, "ell", ELL_EPOCHS, cache,
                             dyn_losses[0])
        timed(13, phase_scaled, torch)
        timed(14, phase_fused_kernels, torch, results)
        fused_launches = timed(15, phase_fused_step_train, torch, cache, dyn_losses[0],
                               dyn_launches["K1"])
        backend_launches = timed(16, phase_backend_train, torch, cache, dyn_losses[0])
        timed(17, phase_directed_kernels, torch, cache, results)
        trade_launches = timed(18, phase_trade, torch)
        timed(19, phase_genre_dir, torch)
        dir_fused_launches = timed(20, phase_directed_fused_train, torch, cache)
        bf16_launches = timed(21, phase_bf16, torch, cache, results)
    timed(22, phase_pair_bf16, torch, results)
    timed(23, phase_dir_enc_idx, torch, 23, TRADE_DIR_ENC_IDX_CONFIG, TRADE_SNAPSHOTS,
          TRADE_WINDOWS, "tgbn-trade")
    timed(24, phase_dir_enc_idx, torch, 24, GENRE_DIR_ENC_IDX_CONFIG, GENRE_SNAPSHOTS,
          GENRE_WINDOWS, "tgbn-genre")
    enc_bf16_launches = timed(25, phase_enc_idx_bf16, torch)
    probe_launches = timed(26, phase_probes, torch, results)
    emit({"phase_wall_s": walls})

    flagship = SHAPES["flagship"]
    kernels = []
    # K1/K1d and K2/K2d at the flagship shape; the directed kernels'
    # launches are phase 18's and 20's (every K1 and K2 launch there is on
    # the directed basis).
    dir_launches = {k: trade_launches[k] + dir_fused_launches[k] for k in ("K1", "K2")}
    for name, src, rep, (bms, by), launches in (
        ("K1", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:277", k1_bound(flagship), dyn_launches["K1"]),
        ("K2", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:412", k2_bound(flagship), dyn_launches["K2"]),
        ("K1d", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:160", k1_bound(flagship), dir_launches["K1"]),
        ("K2d", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:249", k2_bound(flagship), dir_launches["K2"]),
    ):
        _, err, ms, plain_ms = results[name][0]  # flagship shape
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None,
                        "shape": "flagship"})
    for name, rep in (("K3", "gncde_tpu/ops/pallas/tiled.py:345"),
                      ("K4", "gncde_tpu/ops/pallas/tiled.py:476"),
                      ("K5a", "gncde_tpu/ops/pallas/tiled.py:748"),
                      ("K5b", "gncde_tpu/ops/pallas/tiled.py:275")):
        err, ms, plain_ms, bms, by, extra = results[name]["genre-H128"]
        kernels.append({"name": name, "route": "cuda",
                        "source": "gncde_tpu_torch/csrc/tiled.cu", "replaces": rep,
                        "launches": tgb_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "genre-H128", **extra})
    for name, src, rep, label in (
        ("K6a", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:572",
         "genre-H128"),
        ("K6b", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:638",
         "genre-H128"),
        ("K7", "gncde_tpu_torch/csrc/modulate.cu", "gncde_tpu/ops/pallas/modulate.py:146",
         "genre-H128"),
    ):
        err, ms, plain_ms, bms, by, extra = results[name][label]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": enc_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "genre (n=1505, B=1)" if name == "K7"
                        else label, **extra})
    for name, src, rep, launches in (
        ("K8", "gncde_tpu_torch/csrc/bcsr.cu", "gncde_tpu/ops/bcsr.py:244", bcsr_launches),
        ("K9", "gncde_tpu_torch/csrc/bcsr.cu", "gncde_tpu/ops/bcsr.py:362", bcsr_launches),
        ("K10", "gncde_tpu_torch/csrc/ell_spmm.cu", "gncde_tpu/ops/pallas/sparse_spmm.py:58",
         ell_launches),
    ):
        err, ms, plain_ms, bms, by, library_ms, shape, extra = results[name]["flagship"]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": library_ms, "shape": f"flagship {shape}", **extra})
    # No single PyTorch call computes K5c, K11, K11d, K12 or K13 (library_ms null).
    for name, src, rep, label, launches in (
        ("K5c", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:202",
         "genre-H128", tgb_launches["K5c"]),
        ("K11", "gncde_tpu_torch/csrc/fused_step.cu",
         "gncde_tpu/ops/pallas/fused_step.py:144", "flagship", fused_launches["K11"]),
        ("K11d", "gncde_tpu_torch/csrc/fused_step.cu",
         "gncde_tpu/ops/pallas/fused_step.py:86", "flagship", dir_fused_launches["K11"]),
        ("K12", "gncde_tpu_torch/csrc/fused_apply.cu",
         "gncde_tpu/ops/pallas/fused_basis.py:66", "flagship-layer",
         backend_launches["K12"]["K12"]),
        ("K13", "gncde_tpu_torch/csrc/fused_apply.cu", "gncde_tpu/ops/pallas/pipeline.py:94",
         "flagship-layer", backend_launches["K13"]["K13"]),
    ):
        err, ms, plain_ms, bms, by, extra = results[name][label]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": label, **extra,
                        **({"path": "phase 7's count: tiled_abar_apply has no caller "
                                    "but its tests (phase 14 holds it)"}
                           if name == "K5c" else {})})
    # The bf16 kernels: their launches are phase 21's training runs' (per
    # stage: K1bf, K2bf; fused: K11bf; the directed fused run: K1dbf, K2dbf,
    # K11dbf); no single PyTorch call computes any of them.
    per_stage, fused, dfused = (bf16_launches[k] for k in
                                ("per_stage", "fused", "directed_fused"))
    for name, src, rep, (bms, by), launches in (
        ("K1bf", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:81", k1_bound(flagship, True),
         per_stage["K1bf"]),
        ("K2bf", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:65", k2_bound(flagship, True),
         per_stage["K2bf"]),
        ("K1dbf", "gncde_tpu_torch/csrc/megakernel_fwd.cu",
         "gncde_tpu/ops/pallas/megakernel.py:81", k1_bound(flagship, True), dfused["K1bf"]),
        ("K2dbf", "gncde_tpu_torch/csrc/megakernel_bwd.cu",
         "gncde_tpu/ops/pallas/megakernel_bwd.py:65", k2_bound(flagship, True),
         dfused["K2bf"]),
    ):
        _, err, ms, plain_ms = results[name][0]  # flagship shape
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "flagship"})
    for name, launches in (("K11bf", fused["K11bf"]), ("K11dbf", dfused["K11bf"])):
        err, ms, plain_ms, bms, by, extra = results[name]["flagship"]
        kernels.append({"name": name, "route": "cuda",
                        "source": "gncde_tpu_torch/csrc/fused_step.cu",
                        "replaces": "gncde_tpu/ops/pallas/fused_step.py:86",
                        "launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None, "shape": "flagship", **extra})
    # The bf16 enc_idx kernels at the trade width (n=255, H=512: the trade
    # config's last layer); their launches are phase 25's training window's.
    for name, src, rep in (
        ("K7bf", "gncde_tpu_torch/csrc/modulate.cu", "gncde_tpu/ops/pallas/modulate.py:146"),
        ("K6a-bf", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:572"),
        ("K6b-bf", "gncde_tpu_torch/csrc/tiled.cu", "gncde_tpu/ops/pallas/tiled.py:638"),
    ):
        err, ms, plain_ms, bms, by, extra = results[name]["trade-H512"]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": enc_bf16_launches[name], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
               "shape": "trade (n=255, B=1)" if name == "K7bf" else "trade-H512", **extra}
        if name == "K6a-bf":  # the backward's form: bf16 vectors
            err, ms, plain_ms, bms, by, extra = results["K6a-bf-bf16-vectors"]["trade-H512"]
            row["bf16_vectors"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bms, "bound_by": by, **extra}
        kernels.append(row)
    # The design probes at their own shape (n=400, B=16, 32 x 4); their
    # launches are phase 26's timer run's. Bound: one K1bf eval's (P6: one
    # K11bf step's); no single PyTorch call computes any of them.
    from gncde_tpu_torch.ops import mk_probe as mp

    for key, v in mp.VARIANTS.items():
        err, ms, plain_ms, bms, by, extra = results["probes"][key]
        kernels.append({"name": key, "route": "cuda", "source": v.source,
                        "replaces": v.replaces, "launches": probe_launches[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": None, "family": v.family,
                        "shape": "probe n=400 B=16 32x4", **extra})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
