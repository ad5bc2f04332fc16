"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build every kernel source in ``scaling_rgcn_training_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print ``ptxas``'s registers
   and spills of every kernel;
3. the span kernels against their plain PyTorch versions on the card, for
   ``out``, ``dx`` and ``dW``: at a small edge-case shape (d_in 63, d_out 4
   and 11, empty relations, nodes with no edges, chunks that end inside a
   64-edge tile) and at the bench shape (N 200,000, E 4,000,000, 91
   relation slots, d 64 -> hidden 16 -> C 8); plus wide rows over 30
   relations (several relation passes of the row route); the forward (#1,
   ``csrc/span_fwd_tc.cu``) and the backward (#2, ``csrc/span_bwd_tc.cu``),
   both on the tensor cores, also against their dataflows
   (``span_forward_tiled_plain``, ``span_backward_tiled_plain``) at the
   small shapes, and their earlier routes on the CUDA cores
   (``span_forward_rows``, ``span_backward_rows``) against the plain
   versions everywhere (at the small shapes with one row of x and one of
   g scaled by 1e-37); two runs give the same bits; at the bench shape,
   L1 and L2 in float32 and bfloat16, the times of #1 and #2, of their
   earlier routes and of the plain versions, #2's dx and dW halves alone,
   beside the bounds (``span_kernels.forward_cost``, ``backward_cost``),
   and in float32 the signed errors against float64 of #1's out and #2's
   dx and dW (each at most ``MAX_BIAS``); then the conv's autograd on the
   card against the same conv on the CPU;
4. the segment-sum, grouped-matmul and d_rhs kernels against their plain
   versions: edge cases (empty groups and rows, groups spanning tiles, row
   counts off the tiles, widths of every class the kernels dispatch on:
   h 4 to 130, 63 -> 4 and 11, 16 -> 8, 8 -> 16, 24 -> 32, 8 -> 130,
   300 -> 11, 256 x 64) and every product and sum of an edge-mode step at
   the bench shape (#4 over 91 groups: 64 -> 16 and 16 -> 8, d_lhs
   16 -> 64 and 8 -> 16; #5 64 x 16 and 16 x 8; #3 [4M, h] -> 200k rows
   for h 8, 16, 64, through the edges' dst or src permutation, the forward
   sums with ``norm``); #3 (``csrc/segment_kernels.cu``
   ``segment_sum_kernel``, the gather and the scale inside) at every
   width class with and without ``perm`` and ``scale`` and with values off
   an aligned address, also against its earlier route
   (``sorted_segment_sum_rows``) bit for bit; #4 and #5
   (``csrc/grouped_kernels.cu`` ``gmm_tc_kernel``, ``drhs_tc_kernel``, on
   the tensor cores) also
   against their earlier routes on the CUDA cores (``gmm_simt``,
   ``gmm_drhs_simt``) everywhere and their dataflows (``gmm_tiled_plain``,
   ``gmm_drhs_tiled_plain``) at the edge cases and layer 1; two runs give
   the same bits; kernel, earlier-route, plain and library times of #3's
   layer-1 sums, with their gathers and without (the library yardstick:
   ``index_select``, then one ``torch.segment_reduce``) and of every #4
   and #5 product of the step, each beside its earlier route (in turns),
   one ``torch.matmul`` per group and its bound (``gmm_cost``,
   ``gmm_drhs_cost``), and in float32 their signed errors against float64
   (each at most ``MAX_BIAS``);
5. ``Trainer.fit`` of the baseline embedding model at the bench shape, 10
   epochs in float32 and 10 with bfloat16 edge streams, first with the
   fused conv (span kernels), then on the same graph built without the span
   plan with ``backend="pallas"`` (edge mode: kernels #3, #4, #5; its f32
   losses must match the fused run's); the fused f32 step is timed again
   with #1's and then #2's earlier route swapped in, and the edge-mode f32
   step with #4's and #5's, then with #3's (whose losses must keep their
   bits: printed), in turns with the redesigned kernels (the swap is this
   script's: no main path calls the earlier routes); then
   ``aggr="attention"`` for 5 epochs: finite losses, the kernels' launch
   counters advanced on every step (and the earlier routes of #1, #2, #3,
   #4 and #5 on none), ms/step and peak memory; and one f32 step's
   per-layer aggregation gradients (dx, dW of both layers, from the fused
   step's inputs and upstream gradients) by #2, #8's redesign and edge
   mode against float64: signed and largest errors;
6. ``rgcn_conv`` in ``mode="auto"`` on a layer too wide for the span
   kernels (128 -> 64) at the bench N and E: it must take the edge mode
   and match the plain versions, forward and backward;
7. the CLI on the GPU (summary pre-training, transfer, fine-tuning) on a
   synthetic dataset, once with ``-emb 128 -hl 64`` (a first layer the
   span kernels refuse), once with ``-backend pallas -aggr attention`` and
   once with no ``-exp`` (summation, MLP and attention heads); the results
   JSON must exist and hold every experiment run;
8. the halo partition on S = 4 virtual shards of the card: the halo
   exchange (#6) and fused halo-aggregate (#7) kernels against their plain
   versions in float32 and bfloat16 at edge cases (S = 1, 2, 3; H not a
   multiple of the vector width; d 4, 11, 63; a peer that ships no rows; a
   shard with no halo edges) and at the bench shape (H ~ 50k rows per
   pair, layers 64 -> 16 and 16 -> 8), #7 (``csrc/halo_kernels.cu``
   ``fused_halo_tc``: #1's chunk kernel over the shards' rows on the
   tensor cores, the CSR sum, the halo buffer's copy) also against its
   dataflow (``fused_halo_aggregate_tiled_plain``) and its earlier route
   (``fused_halo_aggregate_rows``), every halo buffer bit for bit, the
   same bits on two runs; at the bench shape, both layers, #7's times
   beside its earlier route's, the plain version's, the library exchange
   plus #1 on each shard's local and halo plans, and its bound
   (``fused_halo.fused_halo_cost``), #6's beside the library exchange and
   one ``transpose().contiguous()`` of the stacked sends, and in float32
   #7's signed error against float64 per shard (at most ``MAX_BIAS``);
   at every case the send gather's transpose (#3 over each shard's CSR of
   ``send_idx``, the call of both halo backwards) on cotangents that are
   zero in the padding slots against its plain version and ``index_add``
   in float64, the same bits on two runs, and at the bench shape its time
   beside its plain version's and one f32 ``index_add_`` a shard;
   then ``Trainer.fit`` at the bench shape over the 4 shards: halo
   partition with the library exchange, #6 and #7 in float32, #6 and #7
   with bfloat16 streams, and the edge partition (``backend="pallas"``);
   losses within 1e-4 relative of phase 5's single-device run of the same
   dtype (bfloat16: 5e-3), the kernels' launch counters advanced on every
   step, ms/step and peak memory; the halo f32 step with the library
   exchange timed again with #1's and then #2's earlier route swapped in,
   and the halo #7 f32 step with #7's, in turns with the tensor-core
   kernel, 10 steps each; and #1 and its row route per call on shard 0's
   local and halo segments (host microseconds until a call returns, card
   milliseconds);
9. kernel #8 (the one-pass backward of the attribution microbench), both
   routes, against their plain versions: the redesign
   (``span_backward_variant``, ``bwd_tc_kernel`` on the tensor cores over
   the bucket plan; ``base``, ``nodw``, ``nodx``, ``tf32``) and the earlier
   route (``span_backward_variant_simt``; ``base``, ``nodw``, ``nodx``,
   ``statrmw``): at phase 3's edge cases (63 -> 4 and 11, 11 -> 63 over
   32-row buckets, three with no edges; 128 -> 32 over 30 relations, 8
   relation passes of the redesign) and at the bench shape (layers 1 and
   2, and the redesign's ``base`` over the plan with ``dst`` folded into
   4,096 rows), float32 and bfloat16; two runs of the redesign must give
   the same bits of dx and dW, two of the earlier route the same dx bits
   (its dW sums with shared-memory atomics); at the bench shape, the
   redesign's float32 dx bits against #2's, the peak memory one call of
   each adds, and ``base``'s time beside its plain version, then in turns
   with #2 and the earlier route, beside its bound
   (``span_kernels.backward_cost``); then the microbench's entry point in
   this process for layers 1 and 2 in float32 and bfloat16 (each row's
   time beside its bound; both routes' launch counters must move), and
   once as ``python -m scaling_rgcn_training_tpu_torch.bwd_variants
   --inner 3``, which must exit 0;
10. ``Trainer.fit`` of the MLP and attention heads at the bench shape with
   4 transferred embeddings (d 64; the attention head has 4 heads of 16),
   the embedding frozen, 10 epochs in float32: finite losses, 4
   span_forward and 2 span_backward launches a step, ms/step and peak
   memory; the attention head's every MHA call on the fused route (the
   recorder's ``att.fused``; ``att.plain`` 0), ``mha_forward`` 2 and
   ``mha_backward`` 1 launches a step (so in every attention fit: phase
   17's too);
11. checkpoint, resume, plan cache, summary writers and the native
   parser: the bench shape's ``build_rel_edges`` (span plan) and 4-shard
   halo partition built cold into the plan cache and loaded warm (every
   field of the warm plan equal to the cold one's; seconds and MB); then
   float32 ``Trainer.fit`` runs that checkpoint every ``k`` epochs, are
   stopped by their ``on_epoch`` hook after ``k`` and are resumed by a
   Trainer of another seed, whose losses must have the bits of the
   unbroken runs of phases 5 and 8: fused on the warm plan (#1, #2;
   k = 4 of 10), edge mode (#3, #4, #5; 4 of 10) and halo #7 on the warm
   4-shard plan (#7, #2; 2 of 5), each launching its kernels, with the
   checkpoint's write and read ms and MB; the CLI on phase 7's graph with
   ``-ckpt_dir D`` (the summary pre-training's ``transfer_SYNTH_0.npz``
   only), then ``-ckpt_every 2`` for 4 epochs and for 6 (the second
   resumes the fit at epoch 4), whose metric series, final state and test
   metrics must equal an unbroken 6-epoch run's from a copy of the same
   transfer file, ``-sum dummy`` and ``-sum bisim`` on
   summaries written with the port's code (the bisimulation from a
   FLUID-format folder of the graph's 1- and 2-forward bisimulation
   classes, ``graphs/synthetic.py`` ``write_bisim_output``) and ``-e_viz
   true -plan_cache P`` (a finite ``[N, 63]`` ``.npy``, entries in P);
   and the native and Python parses of a 200,000-entity graph at degree 8
   (the same graph; their seconds), which fails if the native parser did
   not run;
12. training across processes at the bench shape (``multihost_sim``'s
   loop, 10 steps): 2 processes x 2 shards sharing the card over gloo, the
   halo partition with the library exchange, #6 and #7 in float32 and #7
   with bfloat16 streams, #6 and #7 reading the other process's rows
   through CUDA IPC, and the edge partition in float32 and bfloat16 (#4,
   #3 and #5 on each process's shards, the partial sums and cotangents
   summed across the processes); losses against the single-process
   4-shard run of the same mode on the card (float32 rtol 1e-5 and atol
   1e-6, bfloat16 rtol 5e-3 and atol 5e-3 of the first loss; the edge
   partition's first loss with its bits), each child's launches of its
   mode's kernels on every step and of no other, the replicated state's
   bits the same on both processes, #6, #7 and the library exchange
   across processes against their plain versions at S = 2 and 4 (a peer
   that ships no rows), one layer of the edge partition across processes
   against one process's at S = 2 and 4 (a process whose shards hold only
   padding rows), ms/step and peak memory of each process, the MB each
   process gathers a step in the edge partition, and per call at layer
   1's width #6, #7 and the library exchange across processes and in one
   process beside their bounds, the whole aggregation's forward with the
   library exchange and with #6, each overlapped and blocked
   (``RGCN_HALO_BLOCK_OVERLAP``), the host barrier, and the edge
   partition's cross-process sums beside their bytes; with 2 cards or
   more also 2 processes x 1 card over NCCL;
13. the AM shape (``bench_shape.AM_*``: N 1,600,000, E 12,000,000, 267
   relation slots, 64 -> 16 -> 11, 8,192 labelled rows; ``am_phase``):
   ``rehearse_am``'s loop fused with bfloat16 streams and in float32
   (``AM_INNER`` x (1 + ``AM_CALLS``) steps each) and in edge mode, float32,
   ``AM_EDGE_STEPS`` steps, the edge-mode losses within 1e-4 relative of
   the fused f32 run's at every step, #1 and #2 (and no #3-#5) launched
   on every fused step, #3, #4 and #5 (and no #1, #2) on every edge-mode
   step, ms/step and peak memory of each; #1 and #2 at 64 -> 16 and
   16 -> 11, #3 with its gather and #4 and #5 at layer 1's shapes, float32
   and bfloat16, against their plain versions on that graph (phases 3 and
   4's helpers, tolerances and two-run bits), each timed beside its bound;
   ``rehearse_am_dist``'s uniform graph (no reorder) partitioned once over
   S = 8 virtual shards of the card, its traffic model (H, true boundary
   rows, modelled wire bytes), #6 and #7 on it at both layers against
   their plain versions (phase 8's helper), then ``rehearse_am_dist``'s
   loop with the library exchange, #6 and #7, each in bfloat16 and
   float32, ``AM_HALO_STEPS`` steps, every step launching its mode's
   kernels and no other counted kernel, each run's losses within 1e-4
   relative (bfloat16: 5e-3, phase 8's criteria) of the same loop from the
   same parameters and dtype unpartitioned through the fused conv;
14. the port's timing entry point ``bench`` (the JAX ``bench.py``; its
   own graph, typ in ``[0, 90)``, not ``bench_shape``'s) at its defaults
   as ``python -m scaling_rgcn_training_tpu_torch.bench``, with bfloat16
   streams and in float32: its JSON line (the JAX keys, finite), #1 and #2
   at 2 launches a timed step and no other kernel; the float32 steps again
   in this process, each step through the kernels and through their plain
   versions from the same parameters (losses within 1e-4 relative, the
   gradients' relative L2 distances printed), the last loss with the
   subprocess's bits, and the plain versions' own chain beside it
   (reported); ``utils/tracing.py`` ``determinism_check`` on two float32
   steps (``bench_phase``);
15. the port's scaling entry point ``bench_scaling`` (the JAX
   ``scripts/bench_scaling.py``: the SBM graph, N 100,000, E 2,000,000)
   over k = 1, 2 and 4 shards of the card (2 and 4 as virtual shards),
   with the library exchange and again with ``RGCN_HALO_PALLAS_A2A=fused``
   on the same partitions: the JAX keys, finite numbers,
   ``measures_hardware_scaling`` false for virtual shards, every timed
   step launching its exchange's kernels, each count's losses against
   k = 1's (``scaling_phase``);
16. the halo exchange's overlap with the owner-local aggregation
   (``overlap_phase``): ``measure_overlap`` at the JAX script's defaults
   (N 100,000, E 1,000,000, 25 slots, 64 -> 16, 8 virtual shards of the
   card) with the library exchange and with #6, both arms
   (``RGCN_HALO_BLOCK_OVERLAP`` unset and set): ms per aggregation,
   forward and forward + backward, the arms' outputs and gradients bit for
   bit, and from a trace of one forward and one backward per arm the
   compute-stream kernels that ran inside the exchange stream's window
   (the blocked arm's must be 0), as ``python -m`` (its traces in a
   process of its own); then one step of ``multihost_sim``'s loop on
   phase 8's graph and widths (4 virtual shards, 4,096 labelled rows)
   with each exchange, float32 and bfloat16 streams, in both arms: the
   loss and every gradient bit for bit, two overlapped steps repeating
   their bits (``determinism_check``), ms/step of each arm (in turns);
   with 2 cards or more the same on the real cards;
17. the step as one graph (``train/step_graph.py``, ``step_graph_phase``):
   ``Trainer.fit`` at the bench shape, 10 epochs, fused f32 and bf16, edge
   mode f32, the attention head (its dropout on), and the halo partition
   over 4 virtual shards with the library exchange, #6 and #7, each with
   ``RGCN_EAGER_STEP=1`` and unset in the order eager, graph, graph,
   eager: the same loss, validation and parameter bits in all four runs,
   the same launches a step, each route's ms/step, host ms/step and peak
   MiB (allocated and reserved). Every ``Trainer.fit``, ``rehearse_am``,
   ``bench`` and ``bench_scaling`` run of the earlier phases takes the
   graph route (one card), its replays counted in ``LAUNCHES``.

18. node-major rows sharded over the cards (``node_shard_phase``; the JAX
   package's ``node_sharding``: each shard's embedding rows, activations
   and Adam moments on its own card, ``parallel/mesh.py`` ``NodeRows``):
   ``bench_scaling --virtual`` over k = 1, 2, 4 virtual shards of the
   card, eager and as a graph, the same loss bits, losses within 1e-5 of
   k = 1's; with 2 cards or more, ``bench_scaling`` over 1, 2, 4 cards in
   float32 and bfloat16 (losses against k = 1's, the card-to-card MB a
   step against what the layout must move and the profiler's peer copies,
   card 0's peak against the others'), and ``rehearse_am_dist``'s step at
   the AM shape over the cards against 8 virtual shards of one card; with
   1 card that part prints "skipped (1 card)";
19. the attention head's kernels (``ops/attention_kernels.py``
   ``mha_forward``, ``mha_backward`` with dx and with x frozen;
   ``csrc/attention_kernels.cu``) at the attention cell's shape (N
   1,666,764, 3 summaries of 63, 3 heads) and at phase 10's (N 200,000, 4
   of 64, 4 heads), dropout 0.2 from the plain route's own draw, against
   ``mha_self_attention(...)[0]`` and its autograd: output, dx and the
   four parameter gradients, one launch a call, the same bits twice; at
   AM's shape both kernels' times beside the plain route's and their
   bounds (``mha_cost``).

20. the featureless basis layer's kernels (``ops/basis_kernels.py``
   ``basis_forward``, ``basis_backward``; ``csrc/basis_kernels.cu``) at
   the basis cell's shape (N 1,666,764, 267 slots, 11,976,642 uniform
   edges, 40 bases of 10) against the plain route's autograd on the card:
   output and the four leaves' gradients, one launch a call, the same
   bits twice; both passes' times beside the plain route's and their
   bounds (``basis_cost``, the benchmark's ``basis_calls``). Then a
   ``FeaturelessModel`` fit through ``Trainer.fit`` at that shape (the
   step graph's warm-ups, capture and replays): every layer-1 call on the
   kernels (``basis.fused``, never ``basis.plain``), and each step's
   launches of both, which the kernels line reports.

``--only 14,15`` runs the named phases and the earlier ones they read
(``NEEDS``; 1 and 2 always), then prints their numbers and the last line,
with no kernels line. With no argument every phase runs. The seconds of
the whole run are printed before the JSON lines.

Tolerances: float32 within rtol 1e-4 and atol 1e-4 * max|ref| (summation
order differs), bfloat16 inputs within 2e-2 * max|ref|.

The second-to-last line is a JSON object with one entry per kernel (#1's,
#2's, #3's, #4's, #5's, #7's and #8's with ``previous_ms``, their earlier
routes' times in the same run; #3's, #4's, #5's, #7's and #8's with the
CUDA kernels they launch; #6's and #7's with ``cross_process``, phase 12's
per-call times across processes and the launches of each child; #3's,
#4's and #5's with ``cross_process``, the launches of each child in phase
12's float32 edge-partition run; #1's and #2's with
``bench_launches_per_step``, phase 14's; #1's, #2's, #3's and #7's with
``bench_scaling_launches``, phase 15's over both exchanges); the line
before it holds the run's other numbers (phase 13's under ``am_shape``,
phase 14's under ``bench``, phase 15's under ``bench_scaling``, phase
16's under ``overlap``, phase 17's under ``step_graph``, phase 18's
under ``node_shard``, phase 19's under ``attention_kernels``, phase 20's
under ``basis_kernels``; #1's, #2's
and #3's ``node_shard_launches``; the attention kernels' entries at AM's
shape, with phase 10's launches); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "scaling_rgcn_training_tpu_torch"

EPOCHS = 10
ATT_EPOCHS = 5
HALO_EPOCHS = 5
HALO_SHARDS = 4
WARMUP = 3
# signed error of #1's and #2's f32 sums against float64, relative (a sum
# cut toward zero on every call gave -4e-8 and moved phase 5's losses)
MAX_BIAS = 1e-8
JAX_PKG = "scaling_rgcn_training_tpu/"
PHASES = tuple(range(1, 21))
# the earlier phases whose results a phase reads (``--only``)
NEEDS = {4: (3,), 5: (3,), 6: (3,), 8: (3, 5), 9: (3,), 10: (3,),
         11: (3, 5, 8)}
DEV = "cuda"
# entities of the CLI's synthetic graph (phases 7 and 11) and of phase 11's
# parse of the native parser against the Python one
CLI_ENTITIES = 20_000
PARSE_ENTITIES = 200_000
# phase 13 at the AM shape: rehearse_am's first call and timed calls of
# AM_INNER steps (its knobs' defaults), edge-mode and halo steps
AM_INNER, AM_CALLS = 5, 3
AM_EDGE_STEPS = 10
AM_HALO_STEPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def check_close(name: str, got, ref, bf16: bool) -> float:
    """f32: |got - ref| <= 1e-4 * max|ref| + 1e-4 * |ref|;
    bf16 inputs: |got - ref| <= 2e-2 * max|ref|."""
    import torch

    got, ref = got.detach().float(), ref.detach().float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    diff = (got - ref).abs()
    if bf16:
        ok = bool((diff <= 2e-2 * scale).all())
    else:
        ok = bool((diff <= 1e-4 * scale + 1e-4 * ref.abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"  {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(kernel, plain, library=None, reps=20, plain_reps=3) -> dict:
    """CUDA-event times, in the order plain, kernel, [library, library,]
    kernel, plain; each the mean of its two batches."""
    for f in (kernel, plain, library):
        if f is not None:
            f()
    p1, k1 = cuda_time_ms(plain, plain_reps), cuda_time_ms(kernel, reps)
    lib = None
    if library is not None:
        lib = (cuda_time_ms(library, reps) + cuda_time_ms(library, reps)) / 2
    k2, p2 = cuda_time_ms(kernel, reps), cuda_time_ms(plain, plain_reps)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float, unit: str) -> dict:
    """Least time on an H100 SXM: the larger of bytes over the HBM rate and
    operations over the peak rate of the unit that runs them (the input
    type's, or ``tf32``): ``bwd_variants.bound``, the port's one copy of
    the card's rates."""
    from scaling_rgcn_training_tpu_torch.bwd_variants import bound as card_bound

    return card_bound(n_bytes, ops, unit)


def random_graph(rng, n, e, slots, n_live=None, live_rels=None):
    n_live = n if n_live is None else n_live
    src = rng.integers(0, n_live, e).astype(np.int32)
    dst = rng.integers(0, n_live, e).astype(np.int32)
    rels = np.arange(slots) if live_rels is None else np.asarray(live_rels)
    typ = rels[rng.integers(0, len(rels), e)].astype(np.int32)
    return src, dst, typ


def dtype_name(dtype) -> str:
    return str(dtype)[6:]


def signed_error(got, ref64) -> float:
    """Signed error of ``got`` against the float64 ``ref64``, relative to
    the sum of |ref64|: a sum cut toward zero on every call shows here long
    before it breaks the tolerance."""
    return float(((got.double() - ref64) * ref64.sign()).sum()) / float(
        ref64.abs().sum())


def compare_span_kernels(sk, plan, d_in, d_out, dtype, rng, tag, timing=False,
                         tiled=False):
    """span_forward / span_backward against their plain versions, and their
    earlier routes ``span_forward_rows`` / ``span_backward_rows`` (with
    ``tiled``, both also against their ``*_tiled_plain`` dataflows, and row
    0 of x and of g scaled by 1e-37); with ``timing``, each half of the
    backward alone and, for float32 inputs, the signed errors against
    float64 of out, dx and dW."""
    import torch

    dev = plan.device
    bf16 = dtype == torch.bfloat16
    x = torch.as_tensor(rng.standard_normal((plan.num_nodes, d_in)),
                        dtype=torch.float32).to(dev, dtype)
    w = torch.as_tensor(rng.standard_normal((plan.num_slots, d_in, d_out)) * 0.2,
                        dtype=torch.float32).to(dev, dtype)
    g = torch.as_tensor(rng.standard_normal((plan.num_nodes, d_out)),
                        dtype=torch.float32).to(dev, dtype)
    if tiled:
        x[0] *= 1e-37   # rows far below the kernels' fixed-point grids
        g[0] *= 1e-37
    out = sk.span_forward(x, w, plan)
    rows = sk.span_forward_rows(x, w, plan)
    torch.cuda.synchronize()
    out_ref = sk.span_forward_plain(x, w, plan)
    dx, dw = sk.span_backward(g, x, w, plan)
    bwd_rows = sk.span_backward_rows(g, x, w, plan)
    torch.cuda.synchronize()
    dx_ref, dw_ref = sk.span_backward_plain(g, x, w, plan)
    torch.cuda.synchronize()
    res = {
        "fwd_err": check_close(f"{tag} out", out, out_ref, bf16),
        "bwd_err": max(check_close(f"{tag} dx", dx, dx_ref, bf16),
                       check_close(f"{tag} dW", dw, dw_ref, bf16)),
    }
    check_close(f"{tag} out (row route)", rows, out_ref, bf16)
    check_close(f"{tag} dx (row route)", bwd_rows[0], dx_ref, bf16)
    check_close(f"{tag} dW (row route)", bwd_rows[1], dw_ref, bf16)
    if tiled:
        res["fwd_err"] = max(res["fwd_err"], check_close(
            f"{tag} out vs tiled plain", out,
            sk.span_forward_tiled_plain(x, w, plan), bf16))
        tdx, tdw = sk.span_backward_tiled_plain(g, x, w, plan)
        res["bwd_err"] = max(res["bwd_err"],
                             check_close(f"{tag} dx vs tiled plain", dx, tdx, bf16),
                             check_close(f"{tag} dW vs tiled plain", dw, tdw, bf16))
    # a second run must give the same bits (no atomics, fixed-order sums)
    dx2, dw2 = sk.span_backward(g, x, w, plan)
    out2 = sk.span_forward(x, w, plan)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        fail(f"{tag}: two kernel runs differ")
    if timing:
        e = plan.fwd_src.numel()
        ops = 2 * e * d_in * d_out
        # order: plain, #1, row route, row route, #1, plain
        res["fwd"] = time_kernel(lambda: sk.span_forward(x, w, plan),
                                 lambda: sk.span_forward_plain(x, w, plan),
                                 lambda: sk.span_forward_rows(x, w, plan),
                                 reps=20, plain_reps=5)
        res["fwd"]["previous_ms"] = res["fwd"]["library_ms"]
        res["fwd"]["library_ms"] = None
        res["fwd"].update(bound(*sk.forward_cost(x, w, plan)))
        # the row route's own bound (CUDA-core FMAs over the forward CSR)
        res["fwd"]["previous_bound_ms"] = bound(nbytes(
            x, w, plan.fwd_rowptr, plan.fwd_src, plan.fwd_rel, plan.fwd_norm,
            out), ops, dtype_name(dtype))["bound_ms"]
        # order: plain, #2, earlier route, earlier route, #2, plain
        res["bwd"] = time_kernel(lambda: sk.span_backward(g, x, w, plan),
                                 lambda: sk.span_backward_plain(g, x, w, plan),
                                 lambda: sk.span_backward_rows(g, x, w, plan),
                                 reps=20, plain_reps=5)
        res["bwd"]["previous_ms"] = res["bwd"]["library_ms"]
        res["bwd"]["library_ms"] = None
        res["bwd"].update(bound(*sk.backward_cost(g, x, w, plan)))
        for half in ("dx", "dw"):
            call = lambda: sk.span_backward_half(g, x, w, plan, half)
            call()
            res["bwd"][f"{half}_ms"] = cuda_time_ms(call, 20)
        if not bf16:
            ref64 = sk.span_forward_plain(x.double(), w.double(), plan)
            res["fwd"]["bias"] = signed_error(out, ref64)
            res["fwd"]["previous_bias"] = signed_error(rows, ref64)
            dx64, dw64 = sk.span_backward_plain(g.double(), x.double(),
                                                w.double(), plan)
            for key, got, ref in (("dx", dx, dx64), ("dw", dw, dw64),
                                  ("previous_dx", bwd_rows[0], dx64),
                                  ("previous_dw", bwd_rows[1], dw64)):
                res["bwd"][f"{key}_bias"] = signed_error(got, ref)
            del ref64, dx64, dw64
            f, b = res["fwd"], res["bwd"]
            print(f"  {tag} signed error against float64: span_forward "
                  f"{f['bias']:.2e} (row route {f['previous_bias']:.2e}), "
                  f"span_backward dx {b['dx_bias']:.2e} dW {b['dw_bias']:.2e} "
                  f"(earlier route {b['previous_dx_bias']:.2e}, "
                  f"{b['previous_dw_bias']:.2e}); limit {MAX_BIAS:.0e}",
                  flush=True)
            for name, value in (("span_forward", f["bias"]),
                                ("span_backward dx", b["dx_bias"]),
                                ("span_backward dW", b["dw_bias"])):
                if abs(value) > MAX_BIAS:
                    fail(f"{tag}: {name}'s sums are biased ({value:.2e})")
        f, b = res["fwd"], res["bwd"]
        print(f"  {tag} times: span_forward {f['ms']:.4f} ms (row route "
              f"{f['previous_ms']:.4f} ms, plain {f['plain_ms']:.4f} ms; "
              f"bound {f['bound_ms']:.4f} ms {f['bound_by']}, the row "
              f"route's {f['previous_bound_ms']:.4f} ms), span_backward "
              f"{b['ms']:.4f} ms (dx half {b['dx_ms']:.4f}, dW half "
              f"{b['dw_ms']:.4f}; earlier route {b['previous_ms']:.4f} ms, "
              f"plain {b['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"{b['bound_by']})", flush=True)
    return res


def check_segment(vals, rowptr, tag, perm=None, scale=None,
                  timing=False) -> dict:
    """Kernel #3 (``csrc/segment_kernels.cu`` ``segment_sum_kernel``: the
    gather through ``perm`` and the ``scale`` inside) against its plain
    version, and the bits of its earlier route (``sorted_segment_sum_rows``:
    the multiply and ``index_select`` as passes, then
    ``segment_sum_rows_kernel``) and of a second run. With ``timing``: in
    turns with the earlier route, beside the plain version, the library
    path (``index_select``, then one ``torch.segment_reduce``) and the
    bound (``vals``, ``perm``, ``scale``, ``rowptr`` and ``out`` each read
    or written once)."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
        sorted_segment_sum, sorted_segment_sum_plain, sorted_segment_sum_rows)

    kw = {"perm": perm, "scale": scale}
    out = sorted_segment_sum(vals, rowptr, **kw)
    again = sorted_segment_sum(vals, rowptr, **kw)
    rows = sorted_segment_sum_rows(vals, rowptr, **kw)
    torch.cuda.synchronize()
    ref = sorted_segment_sum_plain(vals, rowptr, **kw)
    res = {"err": check_close(f"{tag} segment_sum", out, ref,
                              vals.dtype == torch.bfloat16)}
    if not torch.equal(out, again):
        fail(f"{tag}: two segment_sum runs differ")
    if not torch.equal(out, rows):
        fail(f"{tag}: segment_sum differs from its earlier route's bits")
    del rows, again, ref
    if not timing:
        return res
    offsets = rowptr.long()

    def library():
        v = vals if scale is None else vals.float() * scale[:, None]
        v = v if perm is None else v.index_select(0, perm)
        return torch.segment_reduce(v, "sum", offsets=offsets)

    # order: plain, kernel, earlier route, earlier route, kernel, plain
    res.update(time_kernel(lambda: sorted_segment_sum(vals, rowptr, **kw),
                           lambda: sorted_segment_sum_plain(vals, rowptr, **kw),
                           lambda: sorted_segment_sum_rows(vals, rowptr, **kw)))
    res["previous_ms"] = res["library_ms"]
    library()
    res["library_ms"] = (cuda_time_ms(library, 20)
                         + cuda_time_ms(library, 20)) / 2
    moved = [t for t in (vals, perm, scale, rowptr, out) if t is not None]
    res.update(bound(nbytes(*moved),
                     vals.numel() * (1 if scale is None else 2), "float32"))
    print(f"  {tag} segment_sum times: {res['ms']:.4f} ms (earlier route "
          f"{res['previous_ms']:.4f}, plain {res['plain_ms']:.4f}, "
          f"index_select + segment_reduce {res['library_ms']:.4f}; bound "
          f"{res['bound_ms']:.4f} ms {res['bound_by']})", flush=True)
    return res


def check_grouped(lhs, rhs, gout, sizes, tag, timing=False,
                  tiled=False) -> dict:
    """Kernels #4 (gmm) and #5 (gmm_drhs, unless ``gout`` is None) on the
    tensor cores against their plain versions and their earlier routes on
    the CUDA cores (``gmm_simt``, ``gmm_drhs_simt``); with ``tiled`` also
    against their dataflows (``gmm_tiled_plain``, ``gmm_drhs_tiled_plain``);
    two runs give the same bits. With ``timing``: each beside its earlier
    route (in turns), its plain version, one ``torch.matmul`` per group and
    its bound (``gmm_cost``, ``gmm_drhs_cost``), and for float32 inputs the
    signed error against float64 (at most ``MAX_BIAS``)."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops import grouped_kernels as gk

    bf16 = lhs.dtype == torch.bfloat16
    out, out2 = gk.gmm(lhs, rhs, sizes), gk.gmm(lhs, rhs, sizes)
    simt = gk.gmm_simt(lhs, rhs, sizes)
    torch.cuda.synchronize()
    if out.dtype != lhs.dtype:
        fail(f"{tag}: gmm gave {out.dtype} for {lhs.dtype}")
    res = {"gmm": {"err": check_close(f"{tag} grouped_matmul", out,
                                      gk.gmm_plain(lhs, rhs, sizes), bf16)}}
    check_close(f"{tag} grouped_matmul vs its earlier route", out, simt, bf16)
    if tiled:
        res["gmm"]["err"] = max(res["gmm"]["err"], check_close(
            f"{tag} grouped_matmul vs tiled plain", out,
            gk.gmm_tiled_plain(lhs, rhs, sizes), bf16))
    if not torch.equal(out, out2):
        fail(f"{tag}: two grouped_matmul runs differ")
    if gout is not None:
        drhs, drhs2 = gk.gmm_drhs(lhs, gout, sizes), gk.gmm_drhs(lhs, gout, sizes)
        drhs_simt = gk.gmm_drhs_simt(lhs, gout, sizes)
        torch.cuda.synchronize()
        if drhs.dtype != torch.float32:
            fail(f"{tag}: gmm_drhs gave {drhs.dtype}")
        res["drhs"] = {"err": check_close(
            f"{tag} grouped_drhs", drhs, gk.gmm_drhs_plain(lhs, gout, sizes),
            bf16)}
        check_close(f"{tag} grouped_drhs vs its earlier route", drhs,
                    drhs_simt, bf16)
        if tiled:
            res["drhs"]["err"] = max(res["drhs"]["err"], check_close(
                f"{tag} grouped_drhs vs tiled plain", drhs,
                gk.gmm_drhs_tiled_plain(lhs, gout, sizes), bf16))
        if not torch.equal(drhs, drhs2):
            fail(f"{tag}: two grouped_drhs runs differ")
    if not timing:
        return res
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    spans = [(g, a, b) for g, (a, b) in enumerate(zip(offs[:-1], offs[1:]))]
    calls = {"gmm": (lambda: gk.gmm(lhs, rhs, sizes),
                     lambda: gk.gmm_simt(lhs, rhs, sizes),
                     lambda: gk.gmm_plain(lhs, rhs, sizes),
                     lambda: torch.cat([lhs[a:b] @ rhs[g] for g, a, b in spans]),
                     gk.gmm_cost(lhs, rhs, sizes))}
    if gout is not None:
        calls["drhs"] = (
            lambda: gk.gmm_drhs(lhs, gout, sizes),
            lambda: gk.gmm_drhs_simt(lhs, gout, sizes),
            lambda: gk.gmm_drhs_plain(lhs, gout, sizes),
            lambda: torch.stack([lhs[a:b].T @ gout[a:b] for g, a, b in spans]),
            gk.gmm_drhs_cost(lhs, gout, sizes))
    for key, (kernel, earlier, plain, library, cost) in calls.items():
        # order: plain, kernel, earlier route, earlier route, kernel, plain
        r = res[key]
        r.update(time_kernel(kernel, plain, earlier))
        r["previous_ms"] = r["library_ms"]
        library()
        r["library_ms"] = (cuda_time_ms(library, 20)
                           + cuda_time_ms(library, 20)) / 2
        r.update(bound(*cost))
        print(f"  {tag} {key} times: {r['ms']:.4f} ms (earlier route "
              f"{r['previous_ms']:.4f}, plain {r['plain_ms']:.4f}, per-group "
              f"matmul {r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"{r['bound_by']})", flush=True)
    if not bf16:
        ref = gk.gmm_plain(lhs.double(), rhs.double(), sizes)
        res["gmm"]["bias"] = signed_error(out, ref)
        res["gmm"]["previous_bias"] = signed_error(simt, ref)
        del ref
        if gout is not None:
            ref = gk.gmm_drhs_plain(lhs.double(), gout.double(), sizes)
            res["drhs"]["bias"] = signed_error(drhs, ref)
            res["drhs"]["previous_bias"] = signed_error(drhs_simt, ref)
            del ref
        for key, r in res.items():
            print(f"  {tag} {key} signed error against float64: "
                  f"{r['bias']:.2e} (earlier route {r['previous_bias']:.2e}); "
                  f"limit {MAX_BIAS:.0e}", flush=True)
            if abs(r["bias"]) > MAX_BIAS:
                fail(f"{tag}: {key}'s sums are biased ({r['bias']:.2e})")
    return res


def conv_autograd_check(rng):
    """rgcn_conv values and gradients: kernels on the card vs the plain
    versions on the CPU, same inputs."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        build_rel_edges, init_rgcn_layer, rgcn_conv)

    n, e, slots, d_in, d_out = 700, 5000, 9, 63, 11
    src, dst, typ = random_graph(rng, n, e, slots, n_live=600,
                                 live_rels=[0, 1, 3, 4, 6])
    gen = torch.Generator().manual_seed(0)
    layer = init_rgcn_layer(gen, slots, d_in, d_out)
    x0 = torch.randn((n, d_in), generator=gen)
    gout = torch.randn((n, d_out), generator=gen)
    results = {}
    for dev in (DEV, "cpu"):
        edges = build_rel_edges(src, dst, typ, n, slots, device=dev)
        lay = init_rgcn_layer(gen, slots, d_in, d_out).to(dev)
        lay.load_state_dict(layer.state_dict())
        x = x0.to(dev).requires_grad_(True)
        out = rgcn_conv(x, edges, lay)
        (out * gout.to(dev)).sum().backward()
        results[dev] = [t.detach().cpu() for t in
                        (out, x.grad, lay.weight.grad, lay.root.grad, lay.bias.grad)]
    for name, got, ref in zip(("out", "dx", "dweight", "droot", "dbias"),
                              results[DEV], results["cpu"]):
        check_close(f"conv autograd {name}", got, ref, bf16=False)


def run_fit(graph, compute_dtype, epochs, launches, head="summation",
            keep=False, **trainer_kw):
    """One ``Trainer.fit`` from the seed-0 parameters of ``head`` (the
    MLP and attention heads with their transferred embedding frozen, as
    the CLI's default); returns losses, validation accuracies, median
    ms/step and host ms/step (the time to issue a step, before the
    synchronisation that ends it), peak MiB allocated and reserved, the
    launch counts of each step and, with ``keep``, the parameters after
    the fit (on the card). The attention head's every MHA call must take
    the fused route (``att.fused``, never ``att.plain``), launching
    ``mha_forward`` twice and ``mha_backward`` once a step."""
    import torch
    from scaling_rgcn_training_tpu_torch.bench_shape import bench_trainer
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.utils import tracing

    trainer, model = bench_trainer(epochs, DEV, compute_dtype, head,
                                   **trainer_kw)
    stamps, per_step, host = [], [], []

    def on_epoch(epoch):
        host.append(time.perf_counter() - stamps[-1])
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(dict(launches))

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    per_step.append(dict(launches))
    torch.cuda.reset_peak_memory_stats()
    frozen = () if head == "summation" else ("embedding",)
    before = tracing.counters()
    _, accs, losses, _, _ = trainer.fit(model, graph, bce_loss, "sigmoid",
                                        sum_graph=False, frozen=frozen,
                                        verbose=False, on_epoch=on_epoch)
    att = {k: tracing.counters().get(k, 0) - before.get(k, 0)
           for k in ("att.fused", "att.plain")}
    name = f"{head} {compute_dtype or 'float32'} {trainer_kw}"
    if len(losses) != epochs or not all(np.isfinite(losses)):
        fail(f"trainer {name}: losses {losses}")
    first = min(WARMUP, epochs - 1)
    step = statistics.median((np.diff(stamps) * 1e3)[first:])
    host_ms = statistics.median(np.asarray(host[first:]) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    reserved = torch.cuda.max_memory_reserved() / 2**20
    print(f"  trainer {name} ({trainer.step_route()}): {step:.3f} ms/step, "
          f"host {host_ms:.3f} (median from step {first}; each step = "
          f"validation eval + loss/grad + Adam), loss {losses[0]:.7f} -> "
          f"{losses[-1]:.7f}, val acc {accs[0]:.4f} -> {accs[-1]:.4f}, peak "
          f"{peak:.0f} MiB (reserved {reserved:.0f})", flush=True)
    steps = [{k: b[k] - a[k] for k in a} for a, b in zip(per_step, per_step[1:])]
    if head == "attention":
        # every call on the fused route, its kernels twice and once a step
        # (the validation and the training forward, the backward)
        print(f"  trainer {name}: MHA calls {att}", flush=True)
        if att["att.plain"] or not att["att.fused"]:
            fail(f"trainer {name}: the head's MHA left the fused route: "
                 f"{att}")
        for i, st in enumerate(steps):
            if (st["mha_forward"], st["mha_backward"]) != (2, 1):
                fail(f"trainer {name}: step {i} launched mha_forward "
                     f"{st['mha_forward']} and mha_backward "
                     f"{st['mha_backward']} times, expected 2 and 1")
    return {"losses": losses, "accs": accs, "step_ms": step,
            "host_ms": host_ms, "peak_mib": peak, "reserved_mib": reserved,
            "steps": steps, "route": trainer.step_route(),
            "params": [p.detach().clone() for p in model.parameters()]
            if keep else None}


def layer_gradients(edges, plain_edges, splits) -> dict:
    """One float32 train step's per-layer aggregation gradients at the
    bench shape, before Adam: the fused model's forward and BCE backward
    give each layer's input x, weight w and upstream g; then dx and dW of
    that layer from #2 (the fused step's ``span_backward``), from #8's
    redesign (``span_backward_variant``, base) and from edge mode (#4, #3
    and #5 through the edge conv's autograd), each against the float64
    plain version: the signed error (``signed_error``) and the largest
    |error| over max|ref|. Printed and returned; the f32 tolerance of
    ``check_close`` holds them."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        materialize_weight, relational_aggregate)
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss

    _, model = bs.bench_trainer(1, DEV)
    x, saved = model.embedding, []
    for i, layer in enumerate((model.rgcn1, model.rgcn2)):
        w = materialize_weight(layer)
        agg = relational_aggregate(x, w, edges, "fused")
        agg.retain_grad()
        saved.append((x.detach(), w.detach(), agg))
        x = agg + x @ layer.root + layer.bias
        x = torch.relu(x) if i == 0 else x
    bce_loss(x[splits["x_train"]], splits["y_train"]).backward()
    buckets = bk.plan_buckets(edges.span)

    def edge_mode(xin, w, g):
        xe, we = xin.clone().requires_grad_(), w.clone().requires_grad_()
        relational_aggregate(xe, we, plain_edges, "edge",
                             backend="pallas").backward(g)
        return xe.grad, we.grad

    out = {}
    for layer, (xin, w, agg) in zip(("layer1", "layer2"), saved):
        g = agg.grad.contiguous()
        refs = sk.span_backward_plain(g.double(), xin.double(), w.double(),
                                      edges.span)
        routes = {"fused #2": sk.span_backward(g, xin, w, edges.span),
                  "#8 base": bk.span_backward_variant(g, xin, w, buckets),
                  "edge mode": edge_mode(xin, w, g)}
        for route, got in routes.items():
            for name, a, ref in zip(("dx", "dW"), got, refs):
                tag = f"{layer} {name} {route}"
                check_close(f"gradient {tag}", a, ref, False)
                rel = float((a.double() - ref).abs().max()) / float(
                    ref.abs().max())
                out[tag] = {"signed": signed_error(a, ref), "max_rel": rel}
                print(f"  gradient {tag}: signed error "
                      f"{out[tag]['signed']:+.3e}, max |error| / max|ref| "
                      f"{rel:.3e}", flush=True)
    return out


def require_per_step(tag, steps, least):
    """Every step launched each kernel of ``least`` at least that often,
    and the earlier routes of #1, #2, #3, #4, #5 and #7
    (``span_forward_rows``, ``span_backward_rows``,
    ``sorted_segment_sum_rows``, ``gmm_simt``, ``gmm_drhs_simt``,
    ``fused_halo_aggregate_rows``) and #2's halves alone never."""
    for i, st in enumerate(steps):
        for k, n in least.items():
            if st[k] < n:
                fail(f"{tag}: step {i} launched {k} {st[k]} times, "
                     f"expected at least {n}")
        for k in ("span_forward_rows", "span_backward_rows",
                  "span_backward_half", "fused_halo_aggregate_rows",
                  "grouped_matmul_simt", "grouped_drhs_simt",
                  "segment_sum_rows"):
            if st[k]:
                fail(f"{tag}: step {i} launched {k}")


def route_swap(graph, launches, kernel, **fit_kw) -> dict:
    """Median ms/step and losses of float32 ``Trainer.fit`` runs on
    ``graph`` with ``kernel`` (``span_forward``, #1; ``span_backward``, #2;
    ``fused_halo_aggregate``, #7; ``grouped``, #4 and #5 together;
    ``segment_sum``, #3) as redesigned and with its earlier route
    (``span_forward_rows``, ``span_backward_rows``,
    ``fused_halo_aggregate_rows``; ``gmm_simt`` and ``gmm_drhs_simt``;
    ``sorted_segment_sum_rows``) swapped in wherever the code binds it
    (``rgcn_conv``; for #2 also ``fused_halo``; #7 in ``fused_halo``; #4
    and #5 in ``grouped_kernels``, #5 also in ``rgcn_conv``; #3 in
    ``rgcn_conv``), in the order redesigned, earlier route, earlier route,
    redesigned (the swap is this script's: no main path calls the earlier
    routes). ``same_losses``: every run's losses have the same bits."""
    from scaling_rgcn_training_tpu_torch.ops import grouped_kernels as gk
    from scaling_rgcn_training_tpu_torch.ops import rgcn_conv
    from scaling_rgcn_training_tpu_torch.ops import segment_kernels as segk
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo

    if kernel == "grouped":
        binds = [(gk, "gmm", gk.gmm_simt), (gk, "gmm_drhs", gk.gmm_drhs_simt),
                 (rgcn_conv, "gmm_drhs", gk.gmm_drhs_simt)]
    elif kernel == "segment_sum":
        binds = [(rgcn_conv, "sorted_segment_sum",
                  segk.sorted_segment_sum_rows)]
    else:
        owner, modules = {
            "span_forward": (sk, (rgcn_conv,)),
            "span_backward": (sk, (rgcn_conv, fused_halo)),
            "fused_halo_aggregate": (fused_halo, (fused_halo,))}[kernel]
        binds = [(mod, kernel, getattr(owner, f"{kernel}_rows"))
                 for mod in modules]
    shipped = [getattr(mod, name) for mod, name, _ in binds]
    swap = {"redesigned": [], "earlier route": []}
    losses = []
    for route in ("redesigned", "earlier route", "earlier route",
                  "redesigned"):
        for (mod, name, earlier), fn in zip(binds, shipped):
            setattr(mod, name, fn if route == "redesigned" else earlier)
        try:
            fit = run_fit(graph, None, EPOCHS, launches, **fit_kw)
        finally:
            for (mod, name, _), fn in zip(binds, shipped):
                setattr(mod, name, fn)
        swap[route].append(fit["step_ms"])
        losses.append(fit["losses"])
    swap["same_losses"] = all(l == losses[0] for l in losses)
    swap["losses"] = losses[0]
    return swap


def host_cost(plans) -> dict:
    """Per call of #1 and of its row route on each ``(tag, plan)``, float32
    at layers 1 and 2: host microseconds until it returns (``perf_counter``
    over 50 calls that the card is still running) and card milliseconds
    (CUDA events)."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(1)
    res = {}
    for tag, plan in plans:
        for d_in, d_out in ((bs.D, bs.HL), (bs.HL, bs.C)):
            x = torch.randn(plan.num_src, d_in, generator=gen, device=DEV)
            w = torch.randn(plan.num_slots, d_in, d_out, generator=gen,
                            device=DEV) * 0.2
            for name, fn in (("span_forward", sk.span_forward),
                             ("span_forward_rows", sk.span_forward_rows)):
                call = lambda: fn(x, w, plan)
                call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    call()
                host_us = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
                key = f"{tag} {d_in}->{d_out} {name}"
                res[key] = {"host_us": host_us, "ms": cuda_time_ms(call, 20)}
                print(f"  {key}: host {host_us:.1f} us a call, card "
                      f"{res[key]['ms']:.4f} ms", flush=True)
    return res


def wide_auto_check(edges, rng, launches, reset):
    """rgcn_conv(mode="auto") on a 128 -> 64 layer (beyond the span kernels)
    at the bench N and E: it takes the edge mode, runs kernels #3, #4 and
    #5, and matches the plain versions forward and backward."""
    import torch
    from scaling_rgcn_training_tpu_torch.bench_shape import N, SLOTS
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import (
        RGCNLayer, auto_mode, rgcn_conv)

    d_in, d_out = 128, 64
    mode = auto_mode(edges, d_in, d_out)
    if mode != "edge":
        fail(f"auto picked {mode!r} for {d_in} -> {d_out} at the bench shape")
    t = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape) * s, dtype=torch.float32).to(DEV)
    layer = RGCNLayer(t(SLOTS, d_in, d_out, s=0.1), t(d_in, d_out, s=0.1),
                      t(d_out, s=0.1))
    x = t(N, d_in).requires_grad_(True)
    g = t(N, d_out)
    reset()
    out = rgcn_conv(x, edges, layer, backend="pallas", mode="auto")
    (out * g).sum().backward()
    torch.cuda.synchronize()
    counts = dict(launches)
    print(f"  auto -> {mode}, launches {counts}", flush=True)
    if counts["span_forward"] or counts["span_backward"] or \
            counts["grouped_matmul"] < 2 or counts["segment_sum"] < 2 or \
            counts["grouped_drhs"] < 1:
        fail(f"wide auto conv launched {counts}")
    with torch.no_grad():
        xd, w = x.detach(), layer.weight.detach()
        ref = sk.span_forward_plain(xd, w, edges.span) + xd @ layer.root + layer.bias
        dx, dw = sk.span_backward_plain(g, xd, w, edges.span)
        dx = dx + g @ layer.root.T
    check_close("wide auto out", out, ref, False)
    check_close("wide auto dx", x.grad, dx, False)
    check_close("wide auto dW", layer.weight.grad, dw, False)


def halo_edge_case_graph(rng, s_n, n_nodes, e, slots):
    """Host halo partition of random edges over ``s_n`` shards in which
    shard 1 (when there is one) has no halo edges and the last shard (from
    3 shards on) ships no rows; ``halo_multiple=1``, so H is whatever the
    graph needs."""
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        halo_partition_edges)

    n_per = -(-n_nodes // s_n)
    dst = rng.integers(0, n_nodes, e)
    src = rng.integers(0, n_nodes, e)
    owner = dst // n_per
    if s_n >= 2:
        m = owner == 1
        src[m] = np.minimum(n_per + rng.integers(0, n_per, int(m.sum())),
                            n_nodes - 1)
    if s_n >= 3:
        m = (src // n_per == s_n - 1) & (owner != s_n - 1)
        src[m] = rng.integers(0, n_per, int(m.sum()))
    typ = rng.integers(0, slots, e)
    return halo_partition_edges(src, dst, typ, n_nodes, slots, s_n,
                                pad_to_multiple=8, halo_multiple=1)


def check_halo_kernels(he, d_in, d_out, dtype, tag, timing=False) -> dict:
    """Kernels #6 and #7 against their plain versions on the placed halo
    partition ``he``: #6 exact; #7 within the stated tolerance of its plain
    version, of its dataflow in PyTorch (``fused_halo_aggregate_tiled_plain``)
    and of its earlier route (``fused_halo_aggregate_rows``), every halo
    buffer exact; both the same bits on two runs. With ``timing``: one
    exchange of the S sends and one layer forward of #7 over every shard,
    beside their plain versions (for #6 the library exchange and one
    ``transpose().contiguous()`` of the stacked sends; for #7 its earlier
    route, its call without the buffer, and the library exchange plus #1 on
    each shard's local and halo plans: the same function), and for float32
    #7's signed error against float64. Then the send gather's transpose
    (#3 over each shard's CSR of ``send_idx``, both halo backwards' call)
    on cotangents that are zero in the padding slots, against its plain
    version, ``index_add`` over ``send_idx`` in float64 and a second run's
    bits; with ``timing`` its time beside the plain version's and one f32
    ``index_add_`` a shard."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.ops.segment_kernels import (
        sorted_segment_sum_plain)
    from scaling_rgcn_training_tpu_torch.parallel import fused_halo as fh
    from scaling_rgcn_training_tpu_torch.parallel import ring_halo as rh

    s_n, n_per, h = he.num_shards, he.n_per, he.halo
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(s_n * 1000 + d_in + d_out)
    x = torch.randn(s_n * n_per, d_in, generator=gen, device=DEV).to(dtype)
    xs = list(x.split(n_per))
    w = (torch.randn(he.num_slots, d_in, d_out, generator=gen, device=DEV)
         * 0.2).to(dtype)
    sends = [xs[s].index_select(0, sh.send_idx).view(s_n, h, d_in)
             for s, sh in enumerate(he.shards)]
    got, again = rh.halo_exchange(sends), rh.halo_exchange(sends)
    torch.cuda.synchronize()
    for a, b, c, d in zip(got, again, rh.halo_exchange_plain(sends),
                          rh.halo_exchange_library(sends)):
        if not (torch.equal(a, c) and torch.equal(d, c)):
            fail(f"{tag}: halo_exchange differs from its plain version")
        if not torch.equal(a, b):
            fail(f"{tag}: two halo_exchange runs differ")
    g_sends = []
    for sh in he.shards:
        used = torch.zeros(s_n * h, dtype=torch.bool, device=DEV)
        used[sh.send_perm.long()] = True
        g_send = (torch.randn(s_n * h, d_in, generator=gen, device=DEV)
                  * used[:, None]).to(dtype)
        got, again = (rh.send_transpose(g_send, sh),
                      rh.send_transpose(g_send, sh))
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{tag}: two send_transpose runs differ")
        name = f"{tag} shard {sh.fused.shard} send_transpose"
        check_close(name, got, sorted_segment_sum_plain(
            g_send, sh.send_rowptr, sh.send_perm), bf16)
        ref64 = torch.zeros(n_per, d_in, dtype=torch.float64,
                            device=DEV).index_add_(0, sh.send_idx,
                                                   g_send.double())
        check_close(f"{name} vs index_add in float64", got, ref64, bf16)
        g_sends.append(g_send)
    def exchange_span():
        # the same function by the library exchange, then #1 on each
        # shard's local and halo segments
        recvs = rh.halo_exchange_library(
            [xs[s].index_select(0, sh.send_idx).view(s_n, h, d_in)
             for s, sh in enumerate(he.shards)])
        return [sk.span_forward(xs[s], w, sh.local.span)
                + sk.span_forward(recvs[s].view(s_n * h, d_in), w,
                                  sh.halo.span)
                for s, sh in enumerate(he.shards)]

    res = {"exchange_err": 0.0, "fused_err": 0.0}
    spans = exchange_span() if timing and not bf16 else None
    for sh in he.shards:
        agg, buf = fh.fused_halo_aggregate(xs, w, sh.fused)
        agg2, buf2 = fh.fused_halo_aggregate(xs, w, sh.fused)
        rows, rows_buf = fh.fused_halo_aggregate_rows(xs, w, sh.fused)
        torch.cuda.synchronize()
        ref, ref_buf = fh.fused_halo_aggregate_plain(xs, w, sh.fused)
        tiled, tiled_buf = fh.fused_halo_aggregate_tiled_plain(xs, w, sh.fused)
        for name, b in (("#7", buf), ("the earlier route's", rows_buf),
                        ("the tiled plain's", tiled_buf)):
            if not torch.equal(b, ref_buf):
                fail(f"{tag} shard {sh.fused.shard}: {name} halo buffer "
                     "differs")
        if not (torch.equal(agg, agg2) and torch.equal(buf, buf2)):
            fail(f"{tag}: two fused_halo_aggregate runs differ")
        name = f"{tag} shard {sh.fused.shard} fused_halo_aggregate"
        res["fused_err"] = max(res["fused_err"],
                               check_close(name, agg, ref, bf16),
                               check_close(f"{name} vs tiled plain", agg,
                                           tiled, bf16))
        check_close(f"{name} (row route)", rows, ref, bf16)
        if timing and not bf16:
            ref64 = fh.fused_halo_aggregate_plain(
                [t.double() for t in xs], w.double(), sh.fused, False)[0]
            res.setdefault("bias", []).append(signed_error(agg, ref64))
            res.setdefault("previous_bias", []).append(
                signed_error(rows, ref64))
            res.setdefault("span_bias", []).append(
                signed_error(spans[sh.fused.shard], ref64))
            del ref64
    print(f"  {tag} halo_exchange: same bits as the plain version and the "
          f"library exchange (S {s_n}, H {h}, d {d_in})", flush=True)
    if "bias" in res:
        print(f"  {tag} signed error against float64 per shard: "
              f"fused_halo_aggregate {[f'{v:.2e}' for v in res['bias']]} "
              f"(row route {[f'{v:.2e}' for v in res['previous_bias']]}, "
              f"library exchange + span_forward "
              f"{[f'{v:.2e}' for v in res['span_bias']]}); "
              f"limit {MAX_BIAS:.0e}", flush=True)
        if max(abs(v) for v in res["bias"]) > MAX_BIAS:
            fail(f"{tag}: fused_halo_aggregate's sums are biased "
                 f"({res['bias']})")
    if timing:
        stacked = torch.stack(sends)
        res["exchange"] = time_kernel(
            lambda: rh.halo_exchange(sends),
            lambda: rh.halo_exchange_plain(sends),
            lambda: stacked.transpose(0, 1).contiguous())
        res["exchange"]["library_exchange_ms"] = cuda_time_ms(
            lambda: rh.halo_exchange_library(sends), 20)
        # bytes only: every block read once and written once
        res["exchange"].update(bound(2 * nbytes(*sends), 0,
                                     dtype_name(dtype)))

        def over_shards(fn, **kw):
            return lambda: [fn(xs, w, sh.fused, **kw) for sh in he.shards]

        # order: plain, #7, earlier route, earlier route, #7, plain
        r = res["fused"] = time_kernel(
            over_shards(fh.fused_halo_aggregate),
            over_shards(fh.fused_halo_aggregate_plain),
            over_shards(fh.fused_halo_aggregate_rows), reps=10, plain_reps=1)
        r["previous_ms"], r["library_ms"] = r["library_ms"], None
        # the validation forward's call: no halo buffer
        r["no_buffer_ms"] = cuda_time_ms(
            over_shards(fh.fused_halo_aggregate, want_buf=False), 10)
        exchange_span()
        r["exchange_span_ms"] = cuda_time_ms(exchange_span, 10)
        costs = [fh.fused_halo_cost(xs, w, sh.fused) for sh in he.shards]
        r.update(bound(sum(c[0] for c in costs), sum(c[1] for c in costs),
                       costs[0][2]))
        for key, name in (("exchange", "halo_exchange"),
                          ("fused", "fused_halo_aggregate")):
            r = res[key]
            print(f"  {tag} {name} times: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"{r['bound_by']})", flush=True)
        r = res["fused"]
        print(f"  {tag} fused_halo_aggregate over {s_n} shards "
              f"{r['ms']:.4f} ms: earlier route {r['previous_ms']:.4f}, "
              f"without the halo buffer {r['no_buffer_ms']:.4f}, library "
              f"exchange + span_forward on the local and halo plans "
              f"{r['exchange_span_ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        print(f"  {tag} library exchange {res['exchange']['library_exchange_ms']:.4f}"
              f" ms, transpose().contiguous() {res['exchange']['library_ms']:.4f}"
              " ms", flush=True)
        g32 = [g.float() for g in g_sends]
        r = res["send_transpose"] = time_kernel(
            lambda: [rh.send_transpose(g, sh)
                     for g, sh in zip(g_sends, he.shards)],
            lambda: [sorted_segment_sum_plain(g, sh.send_rowptr, sh.send_perm)
                     for g, sh in zip(g_sends, he.shards)],
            lambda: [torch.zeros(n_per, d_in, device=DEV).index_add_(
                0, sh.send_idx, g) for g, sh in zip(g32, he.shards)])
        print(f"  {tag} send_transpose over {s_n} shards {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, f32 index_add_ "
              f"{r['library_ms']:.4f})", flush=True)
    return res


def halo_phase(bench_src, bench_dst, bench_typ, splits, fits, launches,
               reset) -> dict:
    """Phase 8: kernels #6 and #7, then the trainer over 4 virtual shards."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, device_put_halo_edges, halo_partition_edges)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
    from scaling_rgcn_training_tpu_torch.parallel.spmd import (
        device_put_sharded_edges, shard_rel_edges)

    rng = np.random.default_rng(8)
    errs = {"exchange": 0.0, "fused": 0.0}
    for s_n in (1, 2, 3):
        he = device_put_halo_edges(
            halo_edge_case_graph(rng, s_n, 301 * s_n - 3, 2500 * s_n, 7),
            make_mesh(devices=(DEV,) * s_n))
        for d_in, d_out in ((63, 4), (4, 11), (11, 63)):
            for dtype in (torch.float32, torch.bfloat16):
                r = check_halo_kernels(he, d_in, d_out, dtype,
                                       f"S {s_n} {d_in}->{d_out} "
                                       f"{dtype_name(dtype)}")
                errs["fused"] = max(errs["fused"], r["fused_err"])

    mesh = make_mesh(devices=(DEV,) * HALO_SHARDS)
    t0 = time.perf_counter()
    he = device_put_halo_edges(halo_partition_edges(
        bench_src, bench_dst, bench_typ, bs.N, bs.SLOTS, HALO_SHARDS), mesh)
    print(f"bench-shape halo partition ({HALO_SHARDS} shards, n_per "
          f"{he.n_per}, H {he.halo}, local edges "
          f"{[sh.local.num_edges for sh in he.shards]}, halo edges "
          f"{[sh.halo.num_edges for sh in he.shards]}) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    bench = {}
    for d_in, d_out, layer in ((bs.D, bs.HL, "layer1"), (bs.HL, bs.C, "layer2")):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_halo_kernels(
                he, d_in, d_out, dtype,
                f"bench {layer} {d_in}->{d_out} {dtype_name(dtype)}",
                timing=True)
            errs["fused"] = max(errs["fused"], r["fused_err"])
            bench[(layer, dtype_name(dtype))] = r

    halo_graph = DeviceGraph(edges=he, **splits)
    # segment_sum: the send gathers' transposes, 4 shards x 2 layers
    runs = (("halo library", None, None,
             {"span_forward": 32, "span_backward": 16, "segment_sum": 8}),
            ("halo #6", "1", None,
             {"halo_exchange": 6, "span_forward": 32, "span_backward": 16,
              "segment_sum": 8}),
            ("halo #7", "fused", None,
             {"fused_halo_aggregate": 16, "span_backward": 16,
              "segment_sum": 8}),
            ("halo #6 bf16", "1", "bfloat16",
             {"halo_exchange": 6, "span_forward": 32, "span_backward": 16,
              "segment_sum": 8}),
            ("halo #7 bf16", "fused", "bfloat16",
             {"fused_halo_aggregate": 16, "span_backward": 16,
              "segment_sum": 8}))
    counts = {}
    try:
        for name, env, cd, least in runs:
            if env is None:
                os.environ.pop(EXCHANGE_ENV, None)
            else:
                os.environ[EXCHANGE_ENV] = env
            reset()
            fits[(name, cd)] = run_fit(halo_graph, cd, HALO_EPOCHS, launches,
                                       mesh=mesh, partition="halo")
            counts[name] = dict(launches)
            require_per_step(name, fits[(name, cd)]["steps"], least)
    finally:
        os.environ.pop(EXCHANGE_ENV, None)
    if counts["halo library"]["halo_exchange"] or \
            counts["halo library"]["fused_halo_aggregate"]:
        fail(f"library-exchange run launched {counts['halo library']}")
    # #1 and #2 against their earlier routes on the halo step (library
    # exchange, f32), #7 against its earlier route on the halo #7 step, and
    # #1 per call at the segments' sizes (shard 0)
    halo_swap = {}
    for kernel in ("span_forward", "span_backward", "fused_halo_aggregate"):
        mode = "#7" if kernel == "fused_halo_aggregate" else "library"
        try:
            if mode == "#7":
                os.environ[EXCHANGE_ENV] = "fused"
            halo_swap[kernel] = s = route_swap(halo_graph, launches, kernel,
                                               mesh=mesh, partition="halo")
        finally:
            os.environ.pop(EXCHANGE_ENV, None)
        print(f"  halo {mode} f32 ms/step, {kernel} on the tensor cores "
              f"{s['redesigned']} vs its earlier route {s['earlier route']} "
              "(order: redesigned, earlier, earlier, redesigned)",
              flush=True)
    sh = he.shards[0]
    per_call = host_cost((("shard 0 local", sh.local.span),
                          ("shard 0 halo", sh.halo.span)))

    t0 = time.perf_counter()
    se = device_put_sharded_edges(shard_rel_edges(
        bench_src, bench_dst, bench_typ, bs.N, bs.SLOTS, HALO_SHARDS), mesh)
    print(f"bench-shape edge partition built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    reset()
    fits[("edge partition", None)] = run_fit(
        DeviceGraph(edges=se, **splits), None, HALO_EPOCHS, launches,
        mesh=mesh, partition="edge", backend="pallas")
    counts["edge partition"] = dict(launches)
    require_per_step("edge partition", fits[("edge partition", None)]["steps"],
                     {"grouped_matmul": 24, "segment_sum": 24,
                      "grouped_drhs": 8})

    for (name, cd), f in list(fits.items()):
        if not (name.startswith("halo") or name == "edge partition"):
            continue
        ref = fits[("fused", cd)]["losses"][:HALO_EPOCHS]
        rtol = 1e-4 if cd is None else 5e-3
        rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], ref))
        if not np.allclose(f["losses"], ref, rtol=rtol, atol=0):
            fail(f"{name} {cd or 'float32'} losses {f['losses']} differ from "
                 f"the single-device fused run's {ref}")
        print(f"  {name} {cd or 'float32'} losses match the single-device "
              f"fused run's (max rel diff {rel:.2e}, limit {rtol:.0e})",
              flush=True)
    return {"bench": bench, "errs": errs, "counts": counts,
            "swap": halo_swap, "per_call": per_call, "mesh": mesh,
            "graph": halo_graph}


def check_bwd_variants(plan, d_in, d_out, dtype, rng, tag, variants=None,
                       simt=True, timing=False, bucket_rows=None) -> dict:
    """Kernel #8's variants against their plain versions on ``plan``: the
    redesign's (``bwd_tc_kernel`` over the bucket plan of ``bucket_rows``
    rows; two runs must give the same bits of dx and dW) and, with
    ``simt``, the earlier route's (the same dx bits; its dW adds with
    shared-memory atomics). With ``timing``, in float32 the redesign's dx
    bits against #2's (``span_backward``), the peak memory one call of
    each adds, and the redesign's ``base`` timed beside its plain version,
    then in turns with #2 and the earlier route; its bound is #2's function's
    (``span_kernels.backward_cost``)."""
    import torch
    from scaling_rgcn_training_tpu_torch.bwd_variants import peak_mib
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    dev = plan.device
    bf16 = dtype == torch.bfloat16
    t = lambda *shape, s=1.0: torch.as_tensor(
        rng.standard_normal(shape) * s, dtype=torch.float32).to(dev, dtype)
    x, g = t(plan.num_src, d_in), t(plan.num_nodes, d_out)
    w = t(plan.num_slots, d_in, d_out, s=0.2)
    buckets = bk.plan_buckets(plan, bucket_rows or bk.BUCKET_ROWS)
    res = {"err": 0.0}
    routes = [("", lambda v: bk.span_backward_variant(g, x, w, buckets, v),
               lambda v: bk.span_backward_variant_plain(g, x, w, buckets, v),
               variants or bk.VARIANTS)]
    if simt:
        routes.append((
            "simt ", lambda v: bk.span_backward_variant_simt(g, x, w, plan, v),
            lambda v: bk.span_backward_variant_simt_plain(g, x, w, plan, v),
            bk.SIMT_VARIANTS))
    for route, kernel, plain, names in routes:
        for v in names:
            got, again = kernel(v), kernel(v)
            torch.cuda.synchronize()
            for name, a, b, c in zip(("dx", "dW"), got, again, plain(v)):
                if a is None:
                    continue
                res["err"] = max(res["err"], check_close(
                    f"{tag} {route}{v} {name}", a, c, bf16))
                res[f"{route}{v} {name} same bits"] = bool(torch.equal(a, b))
    same = {k: v for k, v in res.items() if k.endswith("same bits")}
    print(f"  {tag}: two runs give the same bits: {same}", flush=True)
    # the redesign adds without atomics; the earlier route's dx is written
    # once per row by one warp, its dW's shared atomics add in no fixed order
    if not all(v for k, v in same.items()
               if not k.startswith("simt ") or " dx " in k):
        fail(f"{tag}: two runs of #8 give other bits")
    if timing:
        new = lambda: bk.span_backward_variant(g, x, w, buckets)
        shipped = lambda: sk.span_backward(g, x, w, plan)
        earlier = lambda: bk.span_backward_variant_simt(g, x, w, plan)
        if not bf16:
            dx_new, dx_2 = new()[0], shipped()[0]
            res["dx bits of #2"] = bool(torch.equal(dx_new, dx_2))
            print(f"  {tag}: dx has #2's bits: {res['dx bits of #2']} "
                  f"({int((dx_new != dx_2).sum())} of {dx_new.numel()} "
                  f"differ, max {float((dx_new - dx_2).abs().max()):.3e})",
                  flush=True)
            del dx_new, dx_2
        res["peak_mib"] = peak_mib(new)
        res["shipped_peak_mib"] = peak_mib(shipped)
        res.update(time_kernel(new, lambda: bk.span_backward_variant_plain(
            g, x, w, buckets), reps=20, plain_reps=5))
        # in turns: redesign, #2, earlier route, earlier route, #2, redesign
        turns = [cuda_time_ms(f, 20) for f in (new, shipped, earlier, earlier,
                                               shipped, new)]
        res["turns_ms"] = (turns[0] + turns[5]) / 2
        res["shipped_ms"] = (turns[1] + turns[4]) / 2
        res["previous_ms"] = (turns[2] + turns[3]) / 2
        res.update(bound(*sk.backward_cost(g, x, w, plan)))
        blocks, rels, tiles = bk.tc_launch_shape(g, w, buckets)
        print(f"  {tag} span_backward_variant (base) {res['ms']:.4f} ms "
              f"(in turns {res['turns_ms']:.4f}; #2 {res['shipped_ms']:.4f}, "
              f"earlier route {res['previous_ms']:.4f}; plain "
              f"{res['plain_ms']:.4f}; bound {res['bound_ms']:.4f} "
              f"{res['bound_by']}); {blocks} blocks, {rels} relations a "
              f"pass, stages of {tiles} tiles; peak +{res['peak_mib']:.1f} "
              f"MiB a call (#2 +{res['shipped_peak_mib']:.1f})", flush=True)
    return res


def bwd_variant_phase(small, wide, bench_plan, rng, launches, reset) -> dict:
    """Phase 9: kernel #8 (both routes) at edge cases and the bench shape,
    then the attribution microbench through its entry point."""
    import torch
    from scaling_rgcn_training_tpu_torch import bwd_variants as bwv
    from scaling_rgcn_training_tpu_torch.bench_shape import C, D, HL
    from scaling_rgcn_training_tpu_torch.ops import bwd_kernels as bk

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        # 32-row buckets: 16 buckets, the last part-filled, the last three
        # with no edges
        for d_in, d_out in ((63, 4), (63, 11), (11, 63)):
            err = max(err, check_bwd_variants(
                small, d_in, d_out, dtype, rng,
                f"small {d_in}->{d_out} {name}", bucket_rows=32)["err"])
        # 128 -> 32 takes 8 relation passes of the redesign at 32 rows
        err = max(err, check_bwd_variants(
            wide, 128, 32, dtype, rng, f"small 128->32 30 slots {name}",
            bucket_rows=32)["err"])
    folded = bk.fold_dst(bench_plan, bwv.WINDOW)
    base = None
    for d_in, d_out, layer in ((D, HL, "layer1"), (HL, C, "layer2")):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"bench {layer} {d_in}->{d_out} {dtype_name(dtype)}"
            r = check_bwd_variants(bench_plan, d_in, d_out, dtype, rng, tag,
                                   timing=True)
            if (layer, dtype) == ("layer1", torch.float32):
                base = r
            err = max(err, r["err"], check_bwd_variants(
                folded, d_in, d_out, dtype, rng, f"{tag} dst folded",
                variants=("base",), simt=False)["err"])
    del folded

    rows = {}
    reset()
    for d_in, d_out in ((D, HL), (HL, C)):
        for dtype in ("float32", "bfloat16"):
            out = bwv.main(["--d-in", str(d_in), "--d-out", str(d_out),
                            "--dtype", dtype, "--inner", "5"])
            rows[f"{d_in}->{d_out} {dtype}"] = out["rows"]
    counts = dict(launches)
    print(f"  microbench launches {counts}", flush=True)
    for kname in ("span_backward_variant", "span_backward_variant_simt"):
        if not counts[kname]:
            fail(f"the microbench launched {kname} no time")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", f"{PKG}.bwd_variants",
                          "--inner", "3"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    print("\n".join(res.stdout.splitlines()[-16:-1]), flush=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], file=sys.stderr)
        fail(f"python -m {PKG}.bwd_variants --inner 3 exited {res.returncode}")
    return {"err": err, "base": base, "rows": rows,
            "launches": counts["span_backward_variant"],
            "simt_launches": counts["span_backward_variant_simt"]}


def run_cli(extra, tag, exps=("summation",), root=None, results="results"):
    """The CLI on the card; ``exps`` is its ``-exp`` (none: every head)
    and the experiments its report must hold. ``root``: the directory of
    its data and of ``results`` (a new one by default). Returns its
    standard output and its report."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_cli_") as tmp:
        root = root or tmp
        exp = ["-exp", exps[0]] if len(exps) == 1 else []
        cmd = [sys.executable, "-m", f"{PKG}.main", "-dataset", "SYNTH",
               *exp, "-epochs", "5", "-i", "1",
               "-synth_entities", str(CLI_ENTITIES), "-synth_degree", "8",
               "-device", DEV, "-data_root", os.path.join(root, "data"),
               "-results_root", os.path.join(root, results), *extra]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        tail = "\n".join(res.stdout.splitlines()[-8:])
        print(tail, flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            fail(f"CLI {tag} exited {res.returncode}")
        reports = [os.path.join(d, f)
                   for d, _, fs in os.walk(os.path.join(root, results))
                   for f in fs if f.endswith(".json")]
        report = [r for r in reports if os.path.basename(r).startswith("report_")]
        if not report:
            fail(f"CLI {tag} wrote no results JSON ({reports})")
        with open(report[0]) as fh:
            report = json.load(fh)
        missing = set(exps) - set(report)
        if missing:
            fail(f"CLI {tag}: the report holds no {sorted(missing)}")
        print(f"  CLI {tag} ok in {time.perf_counter() - t0:.1f} s: "
              f"{sorted(os.path.basename(r) for r in reports)}", flush=True)
        return res.stdout, report


class Interrupt(Exception):
    """Raised by phase 11's ``on_epoch`` hook to stop a fit."""


def same_plan(a, b, tag, path="plan") -> None:
    """Fail unless two plans hold the same dataclasses, ints and tuples,
    and tensors and arrays of the same dtype, shape and values."""
    import dataclasses

    import torch

    if type(a) is not type(b):
        fail(f"{tag}: {path} is {type(a).__name__} and {type(b).__name__}")
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_plan(getattr(a, f.name), getattr(b, f.name), tag,
                      f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            fail(f"{tag}: {path} differs")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"{tag}: {path} differs")
    elif isinstance(a, tuple):
        if len(a) != len(b):
            fail(f"{tag}: {path} has {len(a)} and {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            same_plan(x, y, tag, f"{path}[{i}]")
    elif a != b:
        fail(f"{tag}: {path} is {a!r} and {b!r}")


def resume_check(tag, graph, epochs, every, unbroken, launches, reset,
                 least, **fit_kw) -> dict:
    """Phase 11: a float32 ``Trainer.fit`` of the bench shape that
    checkpoints every ``every`` epochs and is stopped by its ``on_epoch``
    hook after ``every`` epochs, then resumed by a Trainer of another
    seed; its losses must have the bits of ``unbroken`` (the same fit
    without checkpoints, phase 5 or 8). Both runs must launch every
    kernel of ``least``. Returns the ms of each write and read of the
    checkpoint and its MB on disk."""
    import torch
    from scaling_rgcn_training_tpu_torch.bench_shape import bench_trainer
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer

    ms = {"write": [], "read": []}
    stopped = []

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def stop(epoch):
        if epoch + 1 == every:
            raise Interrupt

    shipped = Trainer._save_fit, Trainer._restore_fit
    Trainer._save_fit = timed(shipped[0], "write")
    Trainer._restore_fit = timed(shipped[1], "read")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_ckpt_") as tmp:
        path = os.path.join(tmp, "fit.npz")
        try:
            for seed, hook in ((0, stop), (1, None)):
                trainer, model = bench_trainer(epochs, DEV, seed=seed,
                                               **fit_kw)
                trainer.ckpt_every = every
                reset()
                try:
                    losses = trainer.fit(model, graph, bce_loss, "sigmoid",
                                         sum_graph=False, verbose=False,
                                         on_epoch=hook, ckpt_path=path)[2]
                except Interrupt:
                    stopped = ms["write"][-1:]
                run = "interrupted" if hook else "resumed"
                for k in least:
                    if not launches[k]:
                        fail(f"{tag} resume: the {run} run launched no {k}")
        finally:
            Trainer._save_fit, Trainer._restore_fit = shipped
        mb = sum(os.path.getsize(os.path.join(tmp, f))
                 for f in os.listdir(tmp)) / 1e6
    if not stopped or len(ms["read"]) != 1:
        fail(f"{tag} resume: wrote {ms['write']}, read {ms['read']}")
    if losses != unbroken:
        fail(f"{tag} resume: losses {losses} are not the unbroken run's "
             f"{unbroken}")
    print(f"  {tag} resume: stopped after {every} of {epochs} epochs, "
          f"resumed by a Trainer of another seed: the unbroken run's loss "
          f"bits; checkpoint {mb:.1f} MB, write {ms['write']} ms, read "
          f"{ms['read']} ms", flush=True)
    return {"mb": mb, "write_ms": ms["write"], "read_ms": ms["read"]}


def plan_cache_check(src, dst, typ, mesh):
    """Phase 11: each bench-shape plan built cold into the plan cache and
    loaded warm; every field of the warm plan must equal the cold one's.
    Returns the seconds of each and the entry's MB, and the warm plans."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        device_put_halo_edges, halo_partition_edges)

    out, warm = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_plans_") as tmp:
        builds = {
            "build_rel_edges (span plan)": lambda: build_rel_edges(
                src, dst, typ, bs.N, bs.SLOTS, device=DEV, cache_dir=tmp),
            f"halo partition ({HALO_SHARDS} shards)": lambda:
                device_put_halo_edges(halo_partition_edges(
                    src, dst, typ, bs.N, bs.SLOTS, HALO_SHARDS,
                    cache_dir=tmp), mesh)}
        for tag, build in builds.items():
            before = set(os.listdir(tmp))
            plans, secs = [], []
            for _ in ("cold", "warm"):
                t0 = time.perf_counter()
                plans.append(build())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            (entry,) = set(os.listdir(tmp)) - before
            same_plan(plans[1], plans[0], f"plan cache {tag}")
            mb = os.path.getsize(os.path.join(tmp, entry)) / 1e6
            print(f"  plan cache {tag}: cold {secs[0]:.2f} s, warm "
                  f"{secs[1]:.2f} s, {mb:.1f} MB on disk, the warm plan "
                  "equals the cold one field by field", flush=True)
            out[tag] = {"cold_s": secs[0], "warm_s": secs[1], "mb": mb}
            warm[tag] = plans[1]
            del plans
    return out, warm


def cli_checkpoint_phase() -> dict:
    """Phase 11's CLI runs on the SYNTH graph of phase 7: ``-ckpt_dir D``
    alone (it writes the summary pre-training's ``transfer_SYNTH_0.npz``
    and no fit checkpoint), then ``-ckpt_dir D -ckpt_every 2`` for 4
    epochs and for 6 (both resume the summary pre-training; the second
    resumes the fine-tuning at epoch 4), against an unbroken 6-epoch run
    from the same transfer file (copied into a fresh ``-ckpt_dir``): the
    same metric series, the same final parameters bit for bit and the same
    test metrics; then ``-sum dummy`` and ``-sum bisim`` on summaries this
    function writes with the port's summary writers, and ``-e_viz true
    -plan_cache P``."""
    from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
    from scaling_rgcn_training_tpu_torch.graphs.summarize.bisim import (
        create_bisim_map_nt)
    from scaling_rgcn_training_tpu_torch.graphs.summarize.dummy import (
        create_dummy_sum_map)
    from scaling_rgcn_training_tpu_torch.graphs.synthetic import (
        ensure_synthetic_dataset, write_bisim_output)
    from scaling_rgcn_training_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_cli_ckpt_") as tmp:
        # the CLI's own SYNTH graph (-synth_entities, -synth_degree 8)
        ds = ensure_synthetic_dataset(os.path.join(tmp, "data"),
                                      num_entities=CLI_ENTITIES,
                                      avg_degree=8.0)
        org = os.path.join(ds, "SYNTH_complete.nt")
        create_dummy_sum_map(org, os.path.join(ds, "dummy", "sum"),
                             os.path.join(ds, "dummy", "map"), "SYNTH",
                             n_sum_nodes=1000, seed=0)
        fluid = write_bisim_output(org, os.path.join(tmp, "bisimOutput"),
                                   os.path.join(ds, "bisim", "sum"), "SYNTH")
        os.makedirs(os.path.join(ds, "bisim", "map"))
        maps = create_bisim_map_nt(fluid, os.path.join(ds, "bisim", "map",
                                                       "SYNTH_map_"),
                                   "SYNTH", org)
        print(f"  wrote dummy summaries and the bisimulation maps {maps}",
              flush=True)

        ckpt, whole = os.path.join(tmp, "ck"), os.path.join(tmp, "ck_whole")
        cli_ckpt = lambda d, epochs, tag, every=("-ckpt_every", "2"): run_cli(
            ["-ckpt_dir", d, *every, "-epochs", str(epochs)],
            " ".join(["-ckpt_dir", *every, "-epochs", str(epochs)])
            + f" ({tag})",
            root=tmp, results=f"results_{tag}")
        cli_ckpt(ckpt, 4, "transfer", every=())
        transfer = os.path.join(ckpt, "transfer_SYNTH_0.npz")
        if not os.path.exists(transfer) or any(
                f.startswith("fit_") for f in os.listdir(ckpt)):
            fail(f"-ckpt_dir without -ckpt_every wrote {os.listdir(ckpt)}")
        os.makedirs(whole)
        shutil.copy(transfer, whole)
        stopped = cli_ckpt(ckpt, 4, "stopped")
        resumed = cli_ckpt(ckpt, 6, "resumed")
        unbroken = cli_ckpt(whole, 6, "unbroken")
        for stdout, name, d in ((stopped[0], "stopped", ckpt),
                                (resumed[0], "resumed", ckpt),
                                (unbroken[0], "unbroken", whole)):
            if "Resuming summary pre-training from " \
                    f"{os.path.join(d, 'transfer_SYNTH_0.npz')}" not in stdout:
                fail(f"the {name} -ckpt_dir run did not resume the summary "
                     f"pre-training from {d}")
        if "Resumed fit from" not in resumed[0] or \
                "at epoch 4" not in resumed[0]:
            fail("the resumed -ckpt_dir run did not resume its fit at "
                 "epoch 4")
        if "Resumed fit from" in stopped[0] + unbroken[0]:
            fail("the stopped or the unbroken -ckpt_dir run resumed a fit")
        (a_arr, a_meta), (b_arr, b_meta) = (
            load_checkpoint(os.path.join(d, "fit_SYNTH_summation_0.npz"))
            for d in (ckpt, whole))
        if a_meta["series"] != b_meta["series"] or \
                len(a_meta["series"]["loss"]) != 6:
            fail(f"resumed CLI run's series {a_meta['series']} differ from "
                 f"the unbroken run's {b_meta['series']}")
        if sorted(a_arr) != sorted(b_arr) or not all(
                np.array_equal(a_arr[k], b_arr[k]) for k in a_arr):
            fail("resumed CLI run's final state differs from the unbroken "
                 "run's")
        tests = {k: v for k, v in resumed[1].items() if k.startswith("Test")}
        if not tests or tests != {k: unbroken[1][k] for k in tests}:
            fail(f"resumed CLI run's test metrics {tests} differ from the "
                 "unbroken run's")
        print(f"  the -ckpt_dir run stopped at epoch 4 resumed from "
              f"{transfer} and its fit checkpoint: 6 epochs' series "
              f"{a_meta['series']['loss']}, final state ({len(a_arr)} "
              f"arrays) and test metrics {tests} equal the unbroken run's; "
              f"{ckpt} holds {sorted(os.listdir(ckpt))}", flush=True)
        out["ckpt_files"] = sorted(os.listdir(ckpt))
        for kind in ("dummy", "bisim"):
            run_cli(["-sum", kind], f"-sum {kind}", root=tmp,
                    results=f"results_{kind}")
        plans = os.path.join(tmp, "plans")
        run_cli(["-e_viz", "true", "-plan_cache", plans],
                "-e_viz true -plan_cache", root=tmp, results="results_viz")
        emb = np.load(os.path.join(tmp, "results_viz", "embeddings",
                                   "SYNTH_attr_embedding.npy"))
        graph = Graph("SYNTH")
        if graph.init_from_native(org) is None:
            fail("the native parser did not run")
        if emb.shape != (graph.num_nodes, 63) or not np.isfinite(emb).all():
            fail(f"-e_viz saved {emb.shape}, expected "
                 f"({graph.num_nodes}, 63) finite")
        out["plan_entries"] = sorted(os.listdir(plans))
        if not out["plan_entries"]:
            fail(f"-plan_cache {plans} holds no entry")
        print(f"  -e_viz saved a finite {emb.shape} embedding; the plan "
              f"cache holds {out['plan_entries']}", flush=True)
    return out


def native_parse_check() -> dict:
    """Phase 11: the native and the Python parse of a synthetic graph of
    ``PARSE_ENTITIES`` entities at degree 8 give the same graph; their
    seconds."""
    from scaling_rgcn_training_tpu_torch.graphs import _native, nt
    from scaling_rgcn_training_tpu_torch.graphs.graph import Graph
    from scaling_rgcn_training_tpu_torch.graphs.synthetic import (
        generate_synthetic_nt)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="smoke_nt_") as tmp:
        path = generate_synthetic_nt(os.path.join(tmp, "big.nt"),
                                     num_entities=PARSE_ENTITIES,
                                     avg_degree=8.0)
        t0 = time.perf_counter()
        if _native.get_lib() is None:
            fail("the native parser did not build (no g++)")
        build_s = time.perf_counter() - t0
        parses = _native.PARSES
        native, py = Graph("native"), Graph("python")
        t0 = time.perf_counter()
        native.init_from_native(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py.init_graph(nt.read_lines(path))
        python_s = time.perf_counter() - t0
    if _native.PARSES != parses + 1:
        fail("the native parser did not run")
    for k in ("nodes", "relations", "num_edges"):
        if getattr(native, k) != getattr(py, k):
            fail(f"native and Python parses differ in {k}")
    for k in ("edge_src", "edge_dst", "edge_type"):
        if not np.array_equal(getattr(native, k), getattr(py, k)):
            fail(f"native and Python parses differ in {k}")
    print(f"  native parse of {native.num_nodes} nodes, "
          f"{len(native.edge_src)} edges: {native_s:.2f} s (library ready "
          f"in {build_s:.2f} s), Python {python_s:.2f} s; the same graph",
          flush=True)
    return {"nodes": native.num_nodes, "edges": int(len(native.edge_src)),
            "native_s": native_s, "python_s": python_s, "build_s": build_s}


def multihost_phase(cards: int) -> dict:
    """Phase 12: ``multihost_sim`` at the bench shape (its loop: embedding
    -> conv -> ReLU -> conv -> BCE over 4,096 labelled rows -> Adam 0.05)
    over 2 processes x 2 shards sharing the card: the halo partition with
    the library exchange, #6 and #7 in float32 and #7 with bfloat16
    streams, and the edge partition (#4, #3 and #5 on each process's
    shards, the partial sums and cotangents summed across the processes
    through the host over gloo) in float32 and bfloat16, 10 steps each,
    against the single-process run of the same 4 shards on the card
    (phase 8's layout) in the same call (``multihost_sim``'s tolerances:
    float32 rtol 1e-5, bfloat16 rtol 5e-3 with an absolute floor; the edge
    partition's first loss with the one-process run's bits); every child
    must launch its mode's kernels on every step and no other counted
    kernel (``multihost_sim`` raises otherwise, and the record is checked
    here), and both processes must end with the same bits of every
    replicated tensor and Adam moment. ``--check``: #6, #7 and the library
    exchange across processes against their plain versions at S = 2 and
    4, and one layer of the edge partition across processes against one
    process's (the summed output and the cotangents bit for bit) at S = 2
    and 4, a process whose shards hold only padding rows among them. Per call at layer 1's width, across
    processes and in one process: #6, the library exchange and #7 beside
    their bounds, the host barrier alone, and the edge partition's
    cross-process sums (forward: each process's 2 partials; backward: the
    ``[N, D]`` and ``w`` cotangents) beside their bytes. With 2 cards or
    more, also 2 processes x 1 card over NCCL, float32."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch import multihost_sim as mh

    env = {"MH_NODES": str(bs.N), "MH_EDGES": str(bs.E),
           "MH_RELS": str(bs.R), "MH_STEPS": "10", "MH_REORDER": "0",
           "MH_BF16": "0", "MH_LABELLED": str(bs.N_TRAIN)}
    layouts = [("2 processes x 2 shards, one card", ["--shards-per-proc", "2",
                "--cards", "1", "--modes",
                "library-f32,kernel-f32,fused-f32,fused-bf16,edge-f32,"
                "edge-bf16", "--check", "--time-calls"])]
    if cards >= 2:
        layouts.append(("2 processes x 1 card, NCCL", [
            "--shards-per-proc", "1", "--cards", "2", "--modes",
            "library-f32,kernel-f32,fused-f32,edge-f32", "--time-calls"]))
    else:
        print("  2 processes x 1 card over NCCL: skipped (1 card)", flush=True)
    # the kernels each mode must launch on every step
    needs = {"library": ("span_forward", "span_backward", "segment_sum"),
             "kernel": ("halo_exchange", "span_backward", "segment_sum"),
             "fused": ("fused_halo_aggregate", "span_backward",
                       "segment_sum"),
             "edge": ("grouped_matmul", "segment_sum", "grouped_drhs")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        for name, extra in layouts:
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                             prefix="smoke_multihost_") as wd:
                t0 = time.perf_counter()
                try:
                    rec = mh.run(["--device", "cuda", "--procs", "2",
                                  "--widths", f"{bs.D},{bs.HL},{bs.C}",
                                  "--workdir", wd, "--timeout", "400",
                                  *extra])
                except RuntimeError as e:
                    fail(f"multihost {name}: {e}")
            print(f"  multihost {name}: {time.perf_counter() - t0:.1f} s in "
                  f"all (backend {rec['backend']}, n_per {rec['n_per']}, H "
                  f"{rec['halo']}, edge shard rows {rec['edge_shard_rows']}; "
                  "partitions built once in "
                  f"{ {k: round(v, 2) for k, v in rec['partition_build_s'].items()} }"
                  " s, loaded by the processes in "
                  f"{[{k: round(v, 2) for k, v in c.items()} for c in rec['plan_load_s']]}"
                  " s)", flush=True)
            for tag, m in rec["modes"].items():
                pairs = list(zip(m["multi_process_losses"],
                                 m["single_process_losses"]))
                rel = max(abs(a - b) / abs(b) for a, b in pairs)
                diff = max(abs(a - b) for a, b in pairs)
                edge = tag.startswith("edge")
                memory = (f"peak MiB {m['peak_mib']}" if edge else
                          f"peak MiB {m['peak_mib']} + IPC buffers "
                          f"{m['shared_mib']}")
                print(f"  multihost {name} {tag}: ms/step {m['ms_per_step']} "
                      f"(one process: {m['single_ms_per_step']:.3f}), "
                      f"{memory} (one process: {m['single_peak_mib']:.0f}), "
                      f"losses {m['multi_process_losses'][0]:.7f} -> "
                      f"{m['multi_process_losses'][-1]:.7f}, max rel diff "
                      f"{rel:.2e}, max abs diff {diff:.2e} (rtol "
                      f"{m['rtol']:.0e}, atol {m['atol']:.1e}), replicated "
                      "state the same bits on both processes: "
                      f"{m['replicated_bits_equal']}", flush=True)
                if edge:
                    print(f"  multihost {name} {tag}: each process gathered "
                          f"{m['gathered_mb_per_step']} MB out a step (as "
                          "many in from the other); the one-process run's "
                          f"bits: first loss {m['first_loss_same_bits']}, "
                          f"every loss {m['loss_series_same_bits']}",
                          flush=True)
                if not m["loss_parity"]:
                    fail(f"multihost {name} {tag}: losses "
                         f"{m['multi_process_losses']} differ from the "
                         f"single-process run's {m['single_process_losses']}"
                         + (f" (first loss same bits: "
                            f"{m['first_loss_same_bits']})" if edge else ""))
                if not m["replicated_bits_equal"]:
                    fail(f"multihost {name} {tag}: the processes ended with "
                         "different bits of the replicated state")
                need = needs[tag.split("-")[0]]
                for proc in m["launches"]:
                    if len(proc) != 10 or not all(
                            all(st[k] for k in need) for st in proc):
                        fail(f"multihost {name} {tag}: a child missed its "
                             f"kernels on a step: {proc}")
            if "--check" in extra and not (rec.get("check")
                                           and rec.get("edge_check")):
                fail(f"multihost {name}: --check left no record")
            for child, checks in enumerate(rec.get("check", [])):
                print(f"  multihost {name} process {child}: #6, #7 and the "
                      "library exchange across processes match their plain "
                      f"versions at {[c['shards'] for c in checks]} shards "
                      f"(#7 max_abs_err {max(c['fused_err'] for c in checks):.2e})",
                      flush=True)
            for child, checks in enumerate(rec.get("edge_check", [])):
                print(f"  multihost {name} process {child}: the edge "
                      "partition's summed output and x, w cotangents across "
                      "processes have one process's bits, f32 and bf16, at "
                      "(S, E, this process's real edges a shard) "
                      f"{[(c['shards'], c['edges'], c['local_edges']) for c in checks]}",
                      flush=True)
            calls = rec["calls"]
            for key in ("halo_exchange", "library_exchange",
                        "fused_halo_aggregate"):
                multi = [c[key]["ms"] for c in calls["multi"]]
                print(f"  multihost {name} {key} per call at "
                      f"{calls['single']['d_in']}->{calls['single']['d_out']}"
                      f" f32: across processes {multi} ms (bound "
                      f"{calls['multi'][0][key]['bound_ms']:.4f}), one "
                      f"process {calls['single'][key]['ms']:.4f} ms (bound "
                      f"{calls['single'][key]['bound_ms']:.4f})", flush=True)
            one = calls["single"]["halo_aggregate"]
            for key in one:
                multi = [round(c["halo_aggregate"][key], 4)
                         for c in calls["multi"]]
                print(f"  multihost {name} halo_aggregate {key} forward per "
                      f"call at {calls['single']['d_in']}->"
                      f"{calls['single']['d_out']} f32: across processes "
                      f"{multi} ms, one process {one[key]:.4f} ms",
                      flush=True)
            ec = rec["edge_calls"]
            for key in ("forward_sum", "backward_sum"):
                multi = [c[key] for c in ec["multi"]]
                one = (f"; one process over its 4 shards "
                       f"{ec['single'][key]['ms']:.4f} ms")
                print(f"  multihost {name} edge partition {key} per call at "
                      f"{ec['single']['d_in']}->{ec['single']['d_out']} f32: "
                      f"across processes {[round(c['ms'], 3) for c in multi]}"
                      f" ms, {multi[0]['mb_out']:.2f} MB out and "
                      f"{multi[0]['mb_in']:.2f} MB in a process{one}",
                      flush=True)
            print(f"  multihost {name} host barrier "
                  f"{[round(c['barrier_ms'], 4) for c in calls['multi']]} ms"
                  f" a call; in the run {rec['barrier']}", flush=True)
            out[name] = rec
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def am_phase(launches, reset) -> dict:
    """Phase 13: the AM shape (``bench_shape.AM_*``: N 1,600,000, E
    12,000,000, 267 slots, 64 -> 16 -> 11, 8,192 labelled rows).

    (a) ``rehearse_am``'s loop on one card: fused with bfloat16 streams
    (the JAX script's arm) and in float32, ``AM_INNER`` x (1 + ``AM_CALLS``)
    steps each, and edge mode in float32 (``mode="edge"``,
    ``backend="pallas"``) for ``AM_EDGE_STEPS``; the fused f32 and edge f32
    losses agree within 1e-4 relative at every step (phase 5's criterion),
    the fused runs launch #1 and #2 on every step and no #3, #4, #5, the
    edge run #3, #4 and #5 and no #1, #2; each run's peak memory.
    (b) #1 and #2 at 64 -> 16 and 16 -> 11, #3 with its gather and #4, #5
    at layer 1's shapes, in float32 and bfloat16, on that graph, and #6
    and #7 at S = 8 on (c)'s partition at both layers: against their plain
    versions (phases 3, 4 and 8's helpers and tolerances), the same bits
    on two runs, each time beside its bound.
    (c) ``rehearse_am_dist``'s uniform graph (no reorder), its halo
    partition over 8 virtual shards of the card built once (and its
    traffic model: H, true boundary rows, the modelled wire bytes), then
    ``rehearse_am_dist``'s loop with the library exchange, #6 and #7, each
    in bfloat16 and float32, ``AM_HALO_STEPS`` steps, every step launching
    its mode's kernels and no other counted kernel; each run's losses
    within 1e-4 relative (bfloat16: 5e-3, phase 8's criteria) of the same
    loop from the same parameters and dtype run unpartitioned through the
    fused conv on the card."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch import multihost_sim as mh
    from scaling_rgcn_training_tpu_torch import rehearse_am as ra
    from scaling_rgcn_training_tpu_torch import rehearse_am_dist as rd
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, device_put_halo_edges, padded_num_nodes)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(DEV)
    bf16 = torch.bfloat16
    k = {"nodes": bs.AM_N, "edges": bs.AM_E, "rels": bs.AM_R,
         "dim": bs.AM_D, "hidden": bs.AM_HL, "inner": AM_INNER,
         "calls": AM_CALLS, "plan_cache": None}
    out = {"runs": {}, "kernels": {}, "halo": {}}
    t0 = time.perf_counter()
    edges, rows, targets, slots, plan_s = ra.build_edges(k, dev)
    print(f"AM edges (N {bs.AM_N}, E {bs.AM_E}, {slots} slots, "
          f"{edges.span.num_chunks} relation chunks) built in {plan_s:.2f} "
          f"s, placed in {time.perf_counter() - t0 - plan_s:.2f} s",
          flush=True)
    out["plan_build_s"] = plan_s

    # (a) the one-card loop
    edge_k = dict(k, inner=AM_EDGE_STEPS // 2, calls=1)
    for name, cd, mode, kk in (("fused bf16", bf16, "fused", k),
                               ("fused f32", None, "fused", k),
                               ("edge f32", None, "edge", edge_k)):
        reset()
        res = ra.run(kk, dev, edges, rows, targets, slots, cd, mode)
        n_steps = kk["inner"] * (1 + kk["calls"])
        if len(res["losses"]) != n_steps or \
                not np.isfinite(res["losses"]).all():
            fail(f"AM {name}: losses {res['losses']}")
        if mode == "fused":
            require_per_step(f"AM {name}", res["launches"],
                             {"span_forward": 2, "span_backward": 2})
            off = ("segment_sum", "grouped_matmul", "grouped_drhs")
        else:
            require_per_step(f"AM {name}", res["launches"],
                             {"grouped_matmul": 4, "segment_sum": 4,
                              "grouped_drhs": 2})
            off = ("span_forward", "span_backward")
        if any(st[n] for st in res["launches"] for n in off):
            fail(f"AM {name} launched one of {off}: {res['launches'][0]}")
        print(f"  AM {name} ({res['step']}): {res['ms_per_step']:.3f} "
              f"ms/step (host {res['host_ms_per_step']:.3f}) over "
              f"{kk['calls'] * kk['inner']} steps after a first call of "
              f"{kk['inner']} ({res['first_call_s']:.2f} s), peak "
              f"{res['peak_mib']:.0f} MiB (reserved "
              f"{res['reserved_mib']:.0f}), loss {res['losses'][0]:.7f} -> "
              f"{res['losses'][-1]:.7f}, launches a step "
              f"{res['launches'][-1]}", flush=True)
        out["runs"][name] = {key: res[key] for key in (
            "ms_per_step", "host_ms_per_step", "first_call_s", "peak_mib",
            "reserved_mib", "step", "losses", "call_ms")}
        out["runs"][name]["launches_step"] = res["launches"][-1]
    fused_l = out["runs"]["fused f32"]["losses"][:AM_EDGE_STEPS]
    edge_l = out["runs"]["edge f32"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(edge_l, fused_l))
    if not np.allclose(edge_l, fused_l, rtol=1e-4, atol=0):
        fail(f"AM edge-mode f32 losses {edge_l} differ from fused {fused_l}")
    print(f"  AM edge-mode f32 losses match the fused run's at every step "
          f"(max rel diff {rel:.2e}, limit 1e-04)", flush=True)

    # (b) #1-#5 against their plain versions on the AM graph
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=DEV).manual_seed(13)
    for d_in, d_out, layer in ((bs.AM_D, bs.AM_HL, "layer1"),
                               (bs.AM_HL, bs.AM_C, "layer2")):
        for dtype in (torch.float32, bf16):
            out["kernels"][f"span {layer} {dtype_name(dtype)}"] = \
                compare_span_kernels(
                    sk, edges.span, d_in, d_out, dtype, rng,
                    f"AM {layer} {d_in}->{d_out} {dtype_name(dtype)}",
                    timing=True)
    for dtype in (torch.float32, bf16):
        name = dtype_name(dtype)
        t = lambda *shape, s=1.0: (torch.randn(
            shape, generator=gen, device=DEV) * s).to(dtype)
        for h, side in ((bs.AM_HL, "dst"), (bs.AM_D, "src")):
            rp = edges.dst_rowptr if side == "dst" else edges.src_rowptr
            perm = getattr(edges, f"{side}_perm")
            out["kernels"][f"segment_sum [E, {h}] -> {side} {name}"] = \
                check_segment(t(bs.AM_E, h), rp,
                              f"AM [E, {h}] -> {side} rows {name} perm"
                              f"{'+scale' if side == 'dst' else ''}",
                              perm=perm,
                              scale=edges.norm if side == "dst" else None,
                              timing=True)
        r = check_grouped(t(bs.AM_E, bs.AM_D),
                          t(slots, bs.AM_D, bs.AM_HL, s=0.2),
                          t(bs.AM_E, bs.AM_HL), edges.group_sizes,
                          f"AM {bs.AM_D}->{bs.AM_HL} {name}", timing=True)
        out["kernels"][f"grouped_matmul {name}"] = r["gmm"]
        out["kernels"][f"grouped_drhs {name}"] = r["drhs"]
    del edges, rows, targets
    torch.cuda.empty_cache()

    # (c) 8 virtual shards: the dist rehearsal's uniform graph, no reorder
    drng = np.random.default_rng(0)
    typ = rd.relations(drng, k)
    src, dst = rd.gen(drng, "uniform", bs.AM_N, bs.AM_E)
    arm, host = rd.traffic_arm("uniform", False, src, dst, typ, k)
    mesh = make_mesh(devices=(DEV,) * rd.S)
    t0 = time.perf_counter()
    he = device_put_halo_edges(host, mesh)
    del host
    print(f"AM halo partition ({rd.S} shards, n_per {he.n_per}, H "
          f"{he.halo}, local edges {[sh.local.num_edges for sh in he.shards]}"
          f", halo edges {[sh.halo.num_edges for sh in he.shards]}) built in "
          f"{arm['plan_build_s']:.2f} s, placed in "
          f"{time.perf_counter() - t0:.2f} s; traffic model: true boundary "
          f"rows {arm['true_boundary_rows_total']}, modelled wire "
          f"{arm['wire_bytes_per_step_per_device']} bytes a step and card",
          flush=True)
    out["halo"]["arm"] = arm
    for d_in, d_out, layer in ((bs.AM_D, bs.AM_HL, "layer1"),
                               (bs.AM_HL, bs.AM_C, "layer2")):
        for dtype in (torch.float32, bf16):
            r = check_halo_kernels(
                he, d_in, d_out, dtype,
                f"AM S {rd.S} {layer} {d_in}->{d_out} {dtype_name(dtype)}",
                timing=True)
            out["kernels"][f"halo {layer} {dtype_name(dtype)}"] = r
    n_pad = padded_num_nodes(he)
    params = rd.make_params(n_pad, k, slots)
    refs = {}
    for cd in (bf16, None):
        t0 = time.perf_counter()
        ref_conv = rd.unpartitioned_conv(src, dst, typ, n_pad, slots, dev, cd)
        print(f"  AM unpartitioned edges of the same graph built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        reset()
        ref = refs[cd] = rd.run_loop(params, ref_conv, dev, AM_HALO_STEPS)
        del ref_conv
        torch.cuda.empty_cache()
        name = f"unpartitioned {dtype_name(cd or torch.float32)}"
        print(f"  AM {name} fused: {ref['ms_per_step']:.3f} ms/step, peak "
              f"{ref['peak_mib']:.0f} MiB, loss {ref['losses'][0]:.7f} -> "
              f"{ref['losses'][-1]:.7f}", flush=True)
        out["halo"][name] = {
            key: ref[key] for key in ("ms_per_step", "peak_mib", "losses")}
    try:
        for mode, env, key in (("library", None, "library"),
                               ("#6", "1", "kernel"), ("#7", "fused", "fused")):
            if env is None:
                os.environ.pop(EXCHANGE_ENV, None)
            else:
                os.environ[EXCHANGE_ENV] = env
            # multihost_sim's loop: the same launches a shard and step, and
            # none of the kernels the mode does not use
            want = dict.fromkeys(ra.COUNTED, 0)
            want.update((n, c * rd.S) for n, c in mh.EXPECTED[key].items())
            if mode == "#6":
                want["halo_exchange"] = 4
            for cd in (bf16, None):
                name = f"halo {mode} {dtype_name(cd or torch.float32)}"
                reset()
                res = rd.run_loop(params, rd.halo_conv(he, mesh, cd), dev,
                                  AM_HALO_STEPS, mesh)
                if not np.isfinite(res["losses"]).all():
                    fail(f"AM {name}: losses {res['losses']}")
                for i, st in enumerate(res["launches"]):
                    bad = {n: (st[n], c) for n, c in want.items()
                           if st[n] != c}
                    if bad:
                        fail(f"AM {name} step {i}: launches (got, want) {bad}")
                line = (f"  AM {name}: {res['ms_per_step']:.3f} ms/step "
                        f"(first step {res['first_step_s']:.2f} s), peak "
                        f"{res['peak_mib']:.0f} MiB, loss "
                        f"{res['losses'][0]:.7f} -> {res['losses'][-1]:.7f}")
                ref = refs[cd]["losses"]
                rtol = 1e-4 if cd is None else 5e-3
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(res["losses"], ref))
                if not np.allclose(res["losses"], ref, rtol=rtol, atol=0):
                    fail(f"AM {name} losses {res['losses']} differ from the "
                         f"unpartitioned run's {ref}")
                line += (f"; matches the unpartitioned run (max rel diff "
                         f"{rel:.2e}, limit {rtol:.0e})")
                print(line, flush=True)
                out["halo"][name] = {key: res[key] for key in (
                    "ms_per_step", "first_step_s", "peak_mib", "losses")}
    finally:
        os.environ.pop(EXCHANGE_ENV, None)
    return out


def bench_phase() -> dict:
    """Phase 14: the port's ``bench`` at its defaults (the JAX ``bench.py``
    graph: N 200,000, E 4,000,000, 45 relations -> 91 slots, typ in
    ``[0, 90)``, 4,096 labelled rows from the same generator; 64 -> 16 ->
    8; 40 steps a call, the best of 8 calls; the per-relation baseline
    loop) in a subprocess, with bfloat16 streams and in float32: its JSON
    line must parse, carry the JAX line's keys with finite numbers, and
    read #1 and #2 at 2 launches a timed step and every other kernel at 0.
    Then the float32 run's 360 steps again in this process (the same
    graph and model), each step's loss and gradients through the kernels
    and through their plain versions (``span_forward_plain``,
    ``span_backward_plain``, one pass a relation) from the same
    parameters, the kernels' gradients taking the step: every loss within
    1e-4 relative (the gradients' relative L2 distances printed), and the
    last loss with the subprocess's bits. The plain
    versions' own 360-step chain is reported beside it, not held: two
    chains that round their sums differently drift apart as Adam carries
    each step's rounding into the next. Last,
    ``tracing.determinism_check`` on two float32 steps from the same state
    (their losses and every parameter after them, through the kernels)
    must return true."""
    import re

    import torch

    from scaling_rgcn_training_tpu_torch import bench
    from scaling_rgcn_training_tpu_torch import rehearse_am as ra
    from scaling_rgcn_training_tpu_torch.ops import rgcn_conv
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk
    from scaling_rgcn_training_tpu_torch.train.losses import bce_loss
    from scaling_rgcn_training_tpu_torch.train.optim import make_optimizer
    from scaling_rgcn_training_tpu_torch.train.step_graph import EAGER_ENV
    from scaling_rgcn_training_tpu_torch.utils import tracing

    jax_keys = ("metric", "value", "unit", "vs_baseline", "compute_dtype",
                "ms_per_step", "baseline_ms_per_step",
                "hbm_bytes_per_step_est", "achieved_gbps_est")
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        os.environ.pop(key)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"{PKG}.bench"], cwd=ROOT,
            env=dict(env, BENCH_COMPUTE_DTYPE=dtype), capture_output=True,
            text=True, timeout=600)
        if res.returncode != 0:
            fail(f"bench {dtype} exited {res.returncode}: "
                 f"{res.stderr[-3000:]}")
        try:
            line = json.loads(res.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            fail(f"bench {dtype}: no JSON line last: {res.stdout[-2000:]}")
        missing = [k for k in jax_keys + ("device", "peak_mib",
                                          "launches_per_step")
                   if k not in line]
        if missing:
            fail(f"bench {dtype}: keys {missing} missing from {line}")
        nums = [line[k] for k in jax_keys if k not in ("metric", "unit",
                                                        "compute_dtype")]
        if not all(np.isfinite(v) and v > 0 for v in nums):
            fail(f"bench {dtype}: a number not finite and positive: {line}")
        got = {k: v for k, v in line["launches_per_step"].items() if v}
        if got != {"span_forward": 2, "span_backward": 2}:
            fail(f"bench {dtype}: launches a step {got}, want span_forward "
                 "2 and span_backward 2 and no other")
        found = re.findall(r"^optimized: .* loss=(\S+)$", res.stderr, re.M)
        if not found:
            fail(f"bench {dtype}: no loss in its log: {res.stderr[-2000:]}")
        line["final_loss"] = float(found[-1])
        line["wall_s"] = time.perf_counter() - t0
        print(f"  bench {dtype}: {line['ms_per_step']:.4f} ms/step, "
              f"{line['value'] / 1e6:.2f} M edges/s, vs_baseline "
              f"{line['vs_baseline']:.3f} (baseline "
              f"{line['baseline_ms_per_step']:.3f} ms/step), "
              f"{line['achieved_gbps_est']:.1f} GB/s est, peak "
              f"{line['peak_mib']} MiB, final loss "
              f"{line['final_loss']!r}; {line['wall_s']:.1f} s", flush=True)
        out[dtype] = line

    # the float32 run's steps in this process, each step's loss and
    # gradients by the kernels and by the plain versions bound in their
    # place (rgcn_conv's names: the fused dataflow calls no other) from the
    # same parameters; the kernels' gradients take the step
    k = dict(bench.knobs(), compute_dtype=None, dtype_name="float32")
    edges, rows, targets, slots = bench.build(k, DEV)
    shipped = rgcn_conv.span_forward, rgcn_conv.span_backward
    plain_fns = sk.span_forward_plain, sk.span_backward_plain

    def bind(fns):
        rgcn_conv.span_forward, rgcn_conv.span_backward = fns

    model = bench.init_model(k, slots, DEV)
    layers = (model.rgcn1, model.rgcn2)
    params = [model.embedding, *(p for l in layers for p in l.parameters())]
    opt = make_optimizer(params, bench.LR, bench.WEIGHT_DECAY)
    conv = bench.step_conv(edges, k)

    def loss_and_grads():
        z = torch.relu(conv(model.embedding, layers[0]))
        loss = bce_loss(conv(z, layers[1]).index_select(0, rows), targets)
        return loss.detach(), torch.autograd.grad(loss, params)

    t0 = time.perf_counter()
    worst_loss = worst_grad = 0.0
    steps = k["inner"] * (1 + k["steps"])
    for step in range(steps):
        loss, grads = loss_and_grads()
        bind(plain_fns)
        try:
            p_loss, p_grads = loss_and_grads()
        finally:
            bind(shipped)
        rel = float((loss - p_loss).abs() / p_loss.abs())
        # each gradient's relative L2 distance (reported: an element-wise
        # bound fails wherever the two sums put a pre-activation on either
        # side of the ReLU's kink)
        grad = max(float((g - r).norm() / r.norm().clamp_min(1e-30))
                   for g, r in zip(grads, p_grads))
        worst_loss, worst_grad = max(worst_loss, rel), max(worst_grad, grad)
        if not rel <= 1e-4:
            fail(f"bench float32 step {step}: the kernels' loss {float(loss)} "
                 f"is {rel:.2e} from the plain versions' {float(p_loss)}")
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
    final = float(loss)
    same = final == out["float32"]["final_loss"]
    print(f"  bench float32, {steps} steps in this process, each from the "
          f"same parameters through the kernels and the plain versions: "
          f"losses within {worst_loss:.2e} relative (limit 1e-4), gradients "
          f"within {worst_grad:.2e} relative L2 distance; the "
          f"last loss {final!r} has the subprocess's bits: {same} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not same:
        fail(f"bench float32: the last loss in this process {final!r} is "
             f"not the subprocess's {out['float32']['final_loss']!r}")
    del model, params, opt
    # the plain versions' own chain from the same start (reported: Adam
    # carries the sums' rounding from step to step), eagerly: the plain
    # versions read the plan's offsets on the host, which no capture takes
    bind(plain_fns)
    os.environ[EAGER_ENV] = "1"
    try:
        t0 = time.perf_counter()
        plain = bench.run(k, edges, rows, targets, slots, k["steps"])
    finally:
        bind(shipped)
        os.environ.pop(EAGER_ENV, None)
    plain_loss = plain["losses"][-1]
    free_rel = abs(final - plain_loss) / abs(plain_loss)
    print(f"  bench float32, the plain versions' own {len(plain['losses'])} "
          f"steps: last loss {plain_loss!r}, {free_rel:.2e} from the "
          f"kernels' ({time.perf_counter() - t0:.1f} s)", flush=True)

    def two_steps():
        model = bench.init_model(k, slots, DEV)
        res = ra.train(model.embedding, (model.rgcn1, model.rgcn2),
                       bench.step_conv(edges, k), rows, targets,
                       bench.WEIGHT_DECAY, 2, 0)
        return res["losses"], [p.detach() for p in model.parameters()]

    deterministic = tracing.determinism_check(two_steps)
    print(f"  determinism_check of two float32 steps from one state: "
          f"{deterministic}", flush=True)
    if not deterministic:
        fail("two float32 bench steps from one state gave different bits")
    torch.cuda.empty_cache()
    return {"lines": out, "stepwise_loss_rel_diff": worst_loss,
            "stepwise_grad_rel_l2": worst_grad,
            "final_loss_bits_as_subprocess": same,
            "plain_chain_final_loss": plain_loss,
            "plain_chain_final_rel_diff": free_rel,
            "deterministic": deterministic}


def scaling_phase(launches, reset) -> dict:
    """Phase 15: the port's ``bench_scaling`` at its defaults (the JAX
    script's SBM graph: N 100,000, E 2,000,000, 20 relations -> 41 slots,
    64 communities, 90% of the edges inside one, the locality reorder for
    k > 1; 64 -> 16 -> 8, float32; 5 steps a call, 3 timed calls) over k
    = 1, 2 and 4 shards of the card (``--max-shards 4``: k beyond the card
    count as virtual shards), with the library exchange, then again with
    ``RGCN_HALO_PALLAS_A2A=fused`` (#7) on the same partitions. Every line
    must carry the JAX script's keys with finite numbers,
    ``measures_hardware_scaling`` true only where the k shards lie on k
    cards, every timed step must launch the exchange's kernels (library:
    #1, #2 and, for k > 1, #3, the send gathers' transpose; #7: #7, #2
    and, for k > 1, #3), and every count's losses must match k = 1's
    within rtol 1e-5 and atol 1e-6 (phase 12's float32 criterion: the
    loss falls below 1e-4 within the 25 steps, so a relative bound alone
    would hold rounding noise to 1e-8 absolute)."""
    import torch

    from scaling_rgcn_training_tpu_torch import bench_scaling as bsc
    from scaling_rgcn_training_tpu_torch.parallel.halo import EXCHANGE_ENV

    jax_keys = ("devices", "ms_per_step", "edges_per_s", "efficiency",
                "throughput_retention", "hardware", "halo_rows_per_shard",
                "measures_hardware_scaling")
    want = {"library": ("span_forward", "span_backward", "segment_sum"),
            "#7": ("fused_halo_aggregate", "span_backward", "segment_sum")}
    cards = torch.cuda.device_count()
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        os.environ.pop(key)
    kept, out, counts = {}, {}, {}
    try:
        for exchange in (None, "fused"):
            if exchange:
                os.environ[EXCHANGE_ENV] = exchange
            else:
                os.environ.pop(EXCHANGE_ENV, None)
            t0 = time.perf_counter()
            reset()
            recs = bsc.main(["--max-shards", "4"], partitions=kept)
            name = recs[0]["exchange"]
            counts[name] = dict(launches)
            if [r["devices"] for r in recs] != [1, 2, 4]:
                fail(f"bench_scaling {name}: counts "
                     f"{[r['devices'] for r in recs]}")
            for rec in recs:
                k = rec["devices"]
                missing = [key for key in jax_keys if key not in rec]
                if missing:
                    fail(f"bench_scaling {name} k={k}: keys {missing} "
                         "missing")
                if not all(np.isfinite(rec[key]) for key in jax_keys
                           if key != "hardware") or \
                        not np.isfinite(rec["losses"]).all():
                    fail(f"bench_scaling {name} k={k}: a number not finite: "
                         f"{rec}")
                if rec["measures_hardware_scaling"] is not (k <= cards):
                    fail(f"bench_scaling {name} k={k}: "
                         f"measures_hardware_scaling "
                         f"{rec['measures_hardware_scaling']} on {cards} "
                         "card(s)")
                # one shard ships no rows: no send transpose (#3)
                short = [n for n in want[name]
                         if not rec["launches_per_step"][n] > 0
                         and (k > 1 or n != "segment_sum")]
                if short:
                    fail(f"bench_scaling {name} k={k}: no launch of {short}")
                if not np.allclose(rec["losses"], recs[0]["losses"],
                                   rtol=1e-5, atol=1e-6):
                    fail(f"bench_scaling {name} k={k}: losses "
                         f"{rec['losses']} differ from k=1's "
                         f"{recs[0]['losses']}")
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(rec["losses"], recs[0]["losses"]))
                print(f"  bench_scaling {name} k={k}: "
                      f"{rec['ms_per_step']:.4f} ms/step, "
                      f"{rec['edges_per_s'] / 1e6:.2f} M edges/s, efficiency "
                      f"{rec['efficiency']:.3f}, retention "
                      f"{rec['throughput_retention']:.3f}, halo rows "
                      f"{rec['halo_rows_per_shard']}, hardware scaling "
                      f"{rec['measures_hardware_scaling']}, peak "
                      f"{rec['peak_mib']} MiB, losses within "
                      f"{rel:.2e} of k=1's", flush=True)
            print(f"  bench_scaling {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            out[name] = recs
    finally:
        os.environ.pop(EXCHANGE_ENV, None)
    return {"records": out, "launches": counts}


def overlap_phase(launches, reset) -> dict:
    """Phase 16: the halo exchange's overlap with the owner-local
    aggregation, both arms (the module docstring). ``measure_overlap``
    runs as ``python -m``, its traces taken in a process of its own: a
    trace taken late in this process held no exchange-stream work."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch import measure_overlap as mo
    from scaling_rgcn_training_tpu_torch import multihost_sim as mh
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, device_put_halo_edges, halo_partition_edges,
        padded_num_nodes)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
    from scaling_rgcn_training_tpu_torch.parallel.ring_halo import (
        exchange_stream)

    cards = torch.cuda.device_count()
    layouts = [(f"{mo.knobs()['devices']} virtual shards", [])]
    if cards >= 2:
        layouts.append((f"{cards} cards", ["--cards"]))
    else:
        print("  real cards: skipped (1 card)", flush=True)
    out = {"measure_overlap": {}, "step": {}}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OV_") and k != EXCHANGE_ENV}
    env["PYTHONPATH"] = ROOT
    for name, extra in layouts:
        for exchange in ("library", "kernel"):
            tag = f"measure_overlap {name} {exchange}"
            run_env = dict(env)
            if mo.EXCHANGES[exchange] is not None:
                run_env[EXCHANGE_ENV] = mo.EXCHANGES[exchange]
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m",
                                  f"{PKG}.measure_overlap", *extra],
                                 cwd=ROOT, env=run_env, capture_output=True,
                                 text=True, timeout=600)
            if res.returncode != 0:
                fail(f"{tag} exited {res.returncode}: {res.stderr[-3000:]}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            if not rec["same_bits"]:
                fail(f"{tag}: the arms' outputs or gradients differ")
            for arm, a in rec["arms"].items():
                for way, win in a["window"].items():
                    if arm == "blocked" and win["inside"]:
                        fail(f"{tag} blocked {way}: {win['inside']} compute "
                             f"kernels inside the exchange window "
                             f"{win['kernels']}")
                print(f"  {tag} {arm}: {a['ms_per_agg']:.4f} ms/agg "
                      f"forward, {a['ms_per_agg_fwd_bwd']:.4f} forward + "
                      "backward; compute kernels inside the exchange "
                      f"window: forward {mo.describe(a['window']['forward'])}"
                      f" {a['window']['forward']['kernels']}, backward "
                      f"{mo.describe(a['window']['backward'])} "
                      f"{a['window']['backward']['kernels']}", flush=True)
            print(f"  {tag}: H {rec['halo_rows']}, {rec['card']}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            out["measure_overlap"][f"{name} {exchange}"] = rec
    dev = torch.device(DEV, torch.cuda.current_device())
    if torch.cuda.current_stream(dev) == exchange_stream(dev):
        fail("this process's current stream is the halo exchange stream")
    src, dst, typ = bs.bench_edges()
    steps = [("4 virtual shards", make_mesh(devices=(DEV,) * HALO_SHARDS))]
    if cards >= 2:
        steps.append((f"{cards} cards", make_mesh(cards)))
    for name, mesh in steps:
        t0 = time.perf_counter()
        he = device_put_halo_edges(halo_partition_edges(
            src, dst, typ, bs.N, bs.SLOTS, mesh.size), mesh)
        print(f"  bench-shape halo partition over {name} built in "
              f"{time.perf_counter() - t0:.2f} s (H {he.halo})", flush=True)
        params = mh.make_params(padded_num_nodes(he), (bs.D, bs.HL, bs.C),
                                bs.SLOTS)
        rows, y = mh.labels(bs.N, bs.C, bs.N_TRAIN)
        for cd in (None, torch.bfloat16):
            step = mo.make_step(mesh, he, params, rows, y, cd)
            for exchange in ("library", "kernel"):
                tag = (f"bench-shape halo step {name} {exchange} "
                       f"{dtype_name(cd or torch.float32)}")
                reset()
                res = mo.compare_step(step, mesh.devices, exchange)
                if not (res["same_bits"] and res["repeats_bits"]):
                    fail(f"{tag}: the arms' bits equal {res['same_bits']}, "
                         f"two overlapped steps repeat {res['repeats_bits']}")
                if not launches["span_forward"] or not launches[
                        "span_backward"] or (exchange == "kernel" and
                                             not launches["halo_exchange"]):
                    fail(f"{tag}: its kernels did not run {dict(launches)}")
                print(f"  {tag}: loss {res['loss']!r} and every gradient the "
                      "same bits in both arms, repeated by two overlapped "
                      "steps; ms/step overlapped "
                      f"{res['ms_per_step']['overlapped']:.3f}, blocked "
                      f"{res['ms_per_step']['blocked']:.3f} (in turns)",
                      flush=True)
                out["step"][tag] = res
            del step
        del he
        torch.cuda.empty_cache()
    return out


# phase 17's configurations: (name, graph, compute dtype, head, halo
# exchange)
STEP_CONFIGS = (("fused f32", "fused", None, "summation", None),
                ("fused bf16", "fused", "bfloat16", "summation", None),
                ("edge f32", "edge", None, "summation", None),
                ("attention head", "fused", None, "attention", None),
                ("halo library", "halo", None, "summation", None),
                ("halo #6", "halo", None, "summation", "1"),
                ("halo #7", "halo", None, "summation", "fused"))


def step_graph_phase(graphs, launches, reset) -> dict:
    """Phase 17: the step as one graph (``train/step_graph.py``). Each of
    ``STEP_CONFIGS`` at the bench shape (``graphs``: the fused and
    edge-mode ``DeviceGraph`` s and the halo partition over
    ``HALO_SHARDS`` virtual shards with its mesh; each built here when
    absent), ``EPOCHS`` epochs of ``Trainer.fit`` from one seed with
    ``RGCN_EAGER_STEP=1`` (eager) and unset (the graph), in the order
    eager, graph, graph, eager: every run's losses, validation accuracies
    and parameters with the first run's bits, the same launches a step in
    both routes, each route's median ms/step and host ms/step (the time to
    issue a step), peak MiB allocated and reserved."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges
    from scaling_rgcn_training_tpu_torch.parallel.halo import (
        EXCHANGE_ENV, device_put_halo_edges, halo_partition_edges)
    from scaling_rgcn_training_tpu_torch.parallel.mesh import make_mesh
    from scaling_rgcn_training_tpu_torch.train.step_graph import EAGER_ENV

    splits = bs.bench_splits(DEV)
    edges = bs.bench_edges()
    if "fused" not in graphs:
        graphs["fused"] = DeviceGraph(edges=build_rel_edges(
            *edges, bs.N, bs.SLOTS, device=DEV), **splits)
    if "edge" not in graphs:
        graphs["edge"] = DeviceGraph(edges=build_rel_edges(
            *edges, bs.N, bs.SLOTS, device=DEV, span=False), **splits)
    if "halo" not in graphs:
        graphs["mesh"] = make_mesh(devices=(DEV,) * HALO_SHARDS)
        graphs["halo"] = DeviceGraph(edges=device_put_halo_edges(
            halo_partition_edges(*edges, bs.N, bs.SLOTS, HALO_SHARDS),
            graphs["mesh"]), **splits)
    out = {}
    try:
        for name, kind, cd, head, exchange in STEP_CONFIGS:
            kw = {"edge": {"backend": "pallas"},
                  "halo": {"mesh": graphs.get("mesh"), "partition": "halo"},
                  "fused": {}}[kind]
            if exchange is None:
                os.environ.pop(EXCHANGE_ENV, None)
            else:
                os.environ[EXCHANGE_ENV] = exchange
            runs, ref = {"eager": [], "graph": []}, None
            for route in ("eager", "graph", "graph", "eager"):
                if route == "eager":
                    os.environ[EAGER_ENV] = "1"
                else:
                    os.environ.pop(EAGER_ENV, None)
                torch.cuda.empty_cache()
                reset()
                f = run_fit(graphs[kind], cd, EPOCHS, launches, head=head,
                            keep=True, **kw)
                if f["route"] != route:
                    fail(f"step {name}: the {route} run took the "
                         f"{f['route']} route")
                if ref is None:
                    ref = f
                elif not (f["losses"] == ref["losses"]
                          and f["accs"] == ref["accs"]
                          and all(torch.equal(a, b) for a, b in
                                  zip(f["params"], ref["params"]))):
                    fail(f"step {name}: a {route} run's losses, accuracies or "
                         f"parameters differ from the first eager run's "
                         f"bits: {f['losses']} vs {ref['losses']}")
                if f["steps"] != ref["steps"]:
                    fail(f"step {name}: {route} launches a step "
                         f"{f['steps']} differ from eager's {ref['steps']}")
                if f is not ref:
                    f["params"] = None
                runs[route].append(f)
            ref["params"] = None
            rec = {"launches_step": {k: v for k, v in
                                     ref["steps"][-1].items() if v},
                   "loss_last": ref["losses"][-1]}
            for route, fs in runs.items():
                rec[route] = {key: [float(f[key]) for f in fs] for key in (
                    "step_ms", "host_ms", "peak_mib", "reserved_mib")}
            out[name] = rec
            ms = lambda v: "/".join(f"{x:.3f}" for x in v)
            mib = lambda v: "/".join(f"{x:.0f}" for x in v)
            e, g = rec["eager"], rec["graph"]
            print(f"  step {name}: ms/step eager {ms(e['step_ms'])}, graph "
                  f"{ms(g['step_ms'])}; host ms/step eager "
                  f"{ms(e['host_ms'])}, graph {ms(g['host_ms'])}; peak MiB "
                  f"eager {mib(e['peak_mib'])} (reserved "
                  f"{mib(e['reserved_mib'])}), graph {mib(g['peak_mib'])} "
                  f"(reserved {mib(g['reserved_mib'])}); launches a step "
                  f"{rec['launches_step']}; the same loss, accuracy and "
                  f"parameter bits in all 4 runs", flush=True)
    finally:
        os.environ.pop(EXCHANGE_ENV, None)
        os.environ.pop(EAGER_ENV, None)
    return out


def cross_card_model(k, host, perm, shards: int, esize: int) -> int:
    """The bytes ``bench_scaling``'s step at ``k`` must move between
    ``shards`` cards, one shard a card, with the library exchange: each
    layer's halo blocks forward and their cotangents back, ``2 S (S - 1) H
    d`` elements of ``esize`` bytes; every layer's replicated ``w`` (in
    the stream dtype), ``root`` and ``bias`` (float32) out to each other
    card and their summed cotangents back; the labelled rows that lie off
    the first card, logits to it and cotangents back (float32)."""
    from scaling_rgcn_training_tpu_torch import bench_scaling as bsc

    widths = ((k["dim"], k["hidden"]), (k["hidden"], bsc.CLASSES))
    halo = 2 * shards * (shards - 1) * host.halo * sum(
        d_in for d_in, _ in widths) * esize
    params = 2 * (shards - 1) * sum(
        host.num_slots * d_in * d_out * esize + (d_in * d_out + d_out) * 4
        for d_in, d_out in widths)
    labelled = perm[:min(bsc.LABELLED, k["nodes"])]
    off = int((labelled // host.n_per != 0).sum())
    return halo + params + 2 * off * bsc.CLASSES * 4


def am_over_cards(am_cards: int, reset) -> dict:
    """Phase 18's AM part: ``rehearse_am_dist``'s uniform graph at the
    full AM shape, partitioned once over 8 shards, its executed step over
    ``am_cards`` cards (8 / cards shards a card) and over 8 virtual
    shards of one card, float32 and bfloat16, ``AM_HALO_STEPS`` steps:
    finite losses, the cards' within 1e-4 (float32; bfloat16 5e-3)
    relative of the one card's, each card's peak beside the one card's."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch import rehearse_am_dist as rd

    k = {"nodes": bs.AM_N, "edges": bs.AM_E, "rels": bs.AM_R,
         "dim": bs.AM_D, "hidden": bs.AM_HL}
    slots = 2 * bs.AM_R + 1
    drng = np.random.default_rng(0)
    typ = rd.relations(drng, k)
    src, dst = rd.gen(drng, "uniform", bs.AM_N, bs.AM_E)
    t0 = time.perf_counter()
    host = rd.partition(src, dst, typ, bs.AM_N, slots)
    print(f"  AM halo partition ({rd.S} shards) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    dev = torch.device(DEV)
    for cd in (None, torch.bfloat16):
        name = dtype_name(cd or torch.float32)
        runs = {}
        for where, n_cards in (("one card", None),
                               (f"{am_cards} cards", am_cards)):
            torch.cuda.empty_cache()
            reset()
            runs[where] = rec = rd.executed_step(
                src, dst, typ, k, dev, AM_HALO_STEPS, cd, 1.0, n_cards,
                host)
            if not rec["loss_finite"]:
                fail(f"AM {where} {name}: losses {rec['losses']}")
            print(f"  AM node-sharded {where} ({rec['cards']} card(s), "
                  f"{rec['step']}) {name}: {rec['ms_per_step']:.3f} "
                  f"ms/step, peak MiB by card {rec['peak_mib_per_card']}"
                  f", loss {rec['losses'][0]:.7f} -> "
                  f"{rec['losses'][-1]:.7f}", flush=True)
        ref, got = runs["one card"]["losses"], \
            runs[f"{am_cards} cards"]["losses"]
        rtol = 1e-4 if cd is None else 5e-3
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        if not np.allclose(got, ref, rtol=rtol, atol=0):
            fail(f"AM over {am_cards} cards {name}: losses {got} differ "
                 f"from one card's {ref}")
        print(f"  AM over {am_cards} cards {name}: losses within "
              f"{rel:.2e} of one card's (limit {rtol:.0e})", flush=True)
        out[name] = {where: {key: r[key] for key in (
            "cards", "step", "ms_per_step", "peak_mib_per_card",
            "peak_device_memory_mib", "losses")}
            for where, r in runs.items()}
    return out


def node_shard_phase(launches, reset) -> dict:
    """Phase 18: node-major rows sharded over the cards
    (``parallel/mesh.py`` ``NodeRows``: each shard's embedding rows,
    activations and Adam moments on its own card).

    (a) One card: ``bench_scaling --virtual`` at its defaults over k = 1,
    2 and 4 virtual shards of the card, float32, the library exchange,
    with ``RGCN_EAGER_STEP=1`` and unset: every count's losses within
    rtol 1e-5, atol 1e-6 of k = 1's (phase 15's criterion), the eager and
    the graph route with the same loss bits, every timed step launching
    #1, #2 and (k > 1) #3.
    (b) With 2 cards or more (1 shard a card, up to 4): ``bench_scaling``
    at k = 1, 2, 4 with ``--trace``, float32 and bfloat16 streams: losses
    against k = 1's (float32 as (a); bfloat16 rtol 5e-3, atol 5e-3 of the
    first loss, phase 12's), the card-to-card MB a step
    (``cross_card_mb_per_step``, the port's counter) within 5% of what the
    layout must move (:func:`cross_card_model`) and of the profiler's
    peer copies in the traced steps, and at the largest k card 0's peak
    within 25% of the other cards' mean; then ``rehearse_am_dist``'s
    executed step at the full AM shape (its uniform graph, partitioned
    once over 8 shards) over the cards (8 / cards shards a card) and over
    8 virtual shards of one card, float32 and bfloat16, ``AM_HALO_STEPS``
    steps: finite losses, the cards' within 1e-4 (float32; bfloat16 5e-3)
    relative of the one card's, each card's peak beside the one card's.
    With 1 card (b) prints "skipped (1 card)"."""
    import torch
    from scaling_rgcn_training_tpu_torch import bench_scaling as bsc
    from scaling_rgcn_training_tpu_torch.parallel.halo import EXCHANGE_ENV
    from scaling_rgcn_training_tpu_torch.train.step_graph import EAGER_ENV

    cards = torch.cuda.device_count()
    want = ("span_forward", "span_backward", "segment_sum")
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        os.environ.pop(key)
    os.environ.pop(EXCHANGE_ENV, None)
    kept, out = {}, {"virtual": {}, "cards": None, "am": None,
                     "launches": {}}

    def check_records(tag, recs, f32=True):
        base = recs[0]["losses"]
        for rec in recs:
            c = rec["devices"]
            if not np.isfinite(rec["losses"]).all():
                fail(f"{tag} k={c}: losses {rec['losses']}")
            rtol, atol = (1e-5, 1e-6) if f32 else (5e-3, 5e-3 * abs(base[0]))
            if not np.allclose(rec["losses"], base, rtol=rtol, atol=atol):
                fail(f"{tag} k={c}: losses {rec['losses']} differ from "
                     f"k=1's {base} (rtol {rtol}, atol {atol})")
            short = [n for n in want if not rec["launches_per_step"][n] > 0
                     and (c > 1 or n != "segment_sum")]
            if short:
                fail(f"{tag} k={c}: no launch of {short}")

    try:
        # (a) virtual shards of one card, eager and graph
        runs = {}
        for route in ("eager", "graph"):
            if route == "eager":
                os.environ[EAGER_ENV] = "1"
            else:
                os.environ.pop(EAGER_ENV, None)
            reset()
            recs = bsc.main(["--max-shards", "4", "--virtual"],
                            partitions=kept)
            out["launches"][f"virtual {route}"] = dict(launches)
            if [r["devices"] for r in recs] != [1, 2, 4] or \
                    any(r["step"] != route or r["cards"] != 1 for r in recs):
                got = [(r["devices"], r["step"], r["cards"]) for r in recs]
                fail(f"node-sharded virtual {route}: counts, routes or "
                     f"cards {got}")
            check_records(f"node-sharded virtual {route}", recs)
            runs[route] = recs
        os.environ.pop(EAGER_ENV, None)
        for e, g in zip(runs["eager"], runs["graph"]):
            if e["losses"] != g["losses"]:
                fail(f"node-sharded virtual k={e['devices']}: eager losses "
                     f"{e['losses']} and graph {g['losses']} differ in bits")
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(g["losses"], runs["graph"][0]["losses"]))
            print(f"  node-sharded k={g['devices']} virtual shards: eager "
                  f"{e['ms_per_step']:.4f} / graph {g['ms_per_step']:.4f} "
                  f"ms/step, the same loss bits, within {rel:.2e} of k=1, "
                  f"peak {g['peak_mib_per_card']} MiB, cross-card MB a step "
                  f"{g['cross_card_mb_per_step']}", flush=True)
        out["virtual"] = runs
        if cards < 2:
            print("  real cards: skipped (1 card)", flush=True)
            return out

        # (b) one shard a card
        most = max(c for c in bsc.COUNTS if c <= min(cards, 4))
        out["cards"] = {}
        with tempfile.TemporaryDirectory(prefix="node_shard_") as tmp:
            for cd, esize in ((None, 4), ("bf16", 2)):
                name = "bfloat16" if cd else "float32"
                if cd:
                    os.environ["BENCH_COMPUTE_DTYPE"] = cd
                reset()
                recs = bsc.main(["--max-shards", str(most), "--trace",
                                 os.path.join(tmp, name)], partitions=kept)
                os.environ.pop("BENCH_COMPUTE_DTYPE", None)
                out["launches"][f"cards {name}"] = dict(launches)
                check_records(f"node-sharded cards {name}", recs, cd is None)
                for rec in recs:
                    c = rec["devices"]
                    perm, host = kept[c]
                    model = cross_card_model(bsc.knobs(), host, perm, c,
                                             esize) / 1e6
                    got, traced = (rec["cross_card_mb_per_step"],
                                   rec["peer_copy_mb_per_step"])
                    rec["cross_card_model_mb"] = model
                    if rec["cards"] != c or abs(got - model) > 0.05 * model \
                            or abs(traced - got) > 0.05 * max(got, 1e-9):
                        fail(f"node-sharded cards {name} k={c}: {rec['cards']}"
                             f" cards, cross-card MB a step {got} (model "
                             f"{model}, peer copies traced {traced})")
                    peaks = rec["peak_mib_per_card"]
                    print(f"  node-sharded k={c} cards {name}: "
                          f"{rec['ms_per_step']:.4f} ms/step ({rec['step']}), "
                          f"host {rec['host_ms_per_step']:.4f}, cross-card "
                          f"{got:.4f} MB a step (model {model:.4f}, traced "
                          f"peer copies {traced:.4f}), peak MiB by card "
                          f"{peaks}", flush=True)
                top = recs[-1]["peak_mib_per_card"]
                others = [v for key, v in top.items() if key != "0"]
                if abs(top["0"] - np.mean(others)) > 0.25 * np.mean(others):
                    fail(f"node-sharded cards {name} k={most}: card 0's peak "
                         f"{top['0']} MiB is not within 25% of the others' "
                         f"{others}")
                out["cards"][name] = recs

        out["am"] = am_over_cards(
            max(c for c in (1, 2, 4, 8) if c <= cards), reset)
    finally:
        os.environ.pop(EAGER_ENV, None)
        os.environ.pop("BENCH_COMPUTE_DTYPE", None)
    return out


# phase 19: the attention head's fused kernels at the attention cell's
# shape (rgcn_bench/configs/rgcn_am_attention.json: AM's 1,666,764 nodes, 3
# summaries of 63, 3 heads) and at phase 10's head (the bench shape's
# ``NUM_SUMS`` summaries of 64); (L, N, d, H); dropout as the model's
ATT_SHAPES = {"am": (3, 1_666_764, 63, 3), "bench": (4, 200_000, 64, 4)}
ATT_DROPOUT = 0.2


def mha_cost(L, n, d, H, backward) -> tuple:
    """(bytes, FLOP) of ``mha_forward``, or of ``mha_backward`` without dx,
    over ``n`` nodes by the kernels' algebra (``csrc/attention_kernels.cu``):
    8 d^2 + 4 H L d FLOP a node forward, 20 d^2 + 8 H L d backward; x read,
    y written (gy read), the dropout draw's first-query entries read."""
    flop = n * ((20 if backward else 8) * d * d
                + (8 if backward else 4) * H * L * d)
    return 4 * (L * n * d + n * d + n * H * L), flop


def attention_phase(launches, reset) -> dict:
    """Phase 19: ``ops/attention_kernels.py`` ``mha_forward`` and
    ``mha_backward`` (with dx, and with x frozen as the attention cell
    runs it) at ``ATT_SHAPES`` with the dropout draw on, against the
    plain-op MHA's row ``mha_self_attention(...)[0]`` and its autograd fed
    the same draw: the output, dx and the four parameter gradients within
    ``check_close``'s float32 tolerance, one launch count a call, the same
    bits on two runs; at AM's shape both kernels' times beside the plain
    route's (``time_kernel``: the row's forward without grad, and its
    autograd backward over the parameters) and their bounds (``mha_cost``
    on the CUDA cores' f32 rate)."""
    import torch
    from scaling_rgcn_training_tpu_torch.models import attention as tatt
    from scaling_rgcn_training_tpu_torch.ops import attention_kernels as tak

    names = ("y", "dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b")
    out = {}
    for tag, (L, n, d, H) in ATT_SHAPES.items():
        g = torch.Generator().manual_seed(0)
        x = torch.rand((L, n, d), generator=g).to(DEV)
        att = tatt.init_mha(g, d).to(DEV)
        gy = torch.randn((n, d), generator=g).to(DEV)
        params = tuple(att.parameters())
        if not tak.fused_ok(x, H, *params):
            fail(f"attention {tag}: the kernels refuse L={L} d={d} H={H}")
        gen = torch.Generator(device=DEV)
        gen.manual_seed(1)
        xr = x.clone().requires_grad_(True)
        ref = tatt.mha_self_attention(att, xr, H, ATT_DROPOUT, gen)[0]
        refs = (ref.detach(), *torch.autograd.grad(ref, (xr, *params), gy))
        del ref, xr
        # the plain route's own draw: the same shape from the same state
        gen.manual_seed(1)
        draw = torch.rand((n, H, L, L), generator=gen, device=DEV)
        reset()
        runs = []
        for _ in range(2):
            y = tak.mha_forward(x, *params, draw, ATT_DROPOUT, H)
            full = tak.mha_backward(gy, x, *params, draw, ATT_DROPOUT, H, True)
            frozen = tak.mha_backward(gy, x, *params, draw, ATT_DROPOUT, H,
                                      False)
            if frozen[0] is not None:
                fail(f"attention {tag}: mha_backward wrote dx unasked")
            runs.append((y, *full, *frozen[1:]))
        torch.cuda.synchronize()
        got = (launches["mha_forward"], launches["mha_backward"])
        if got != (2, 4):
            fail(f"attention {tag}: launches (mha_forward, mha_backward) "
                 f"{got}, expected (2, 4)")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"attention {tag}: two runs gave different bits")
        errs = {nm: check_close(f"attention {tag} {nm}", a, b, False)
                for nm, a, b in zip(names, runs[0], refs)}
        errs.update({f"{nm}, x frozen": check_close(
            f"attention {tag} {nm}, x frozen", a, b, False)
            for nm, a, b in zip(names[2:], runs[0][6:], refs[2:])})
        rec = {"L": L, "nodes": n, "d": d, "heads": H,
               "max_abs_err": max(errs.values()), "errs": errs}
        del runs, refs
        if tag == "am":
            with torch.enable_grad():
                yp = tatt.mha_self_attention(att, x, H, ATT_DROPOUT, gen)[0]

            def plain_forward():
                with torch.no_grad():
                    return tatt.mha_self_attention(att, x, H, ATT_DROPOUT,
                                                   gen)[0]

            for kname, kernel, plain, backward in (
                    ("mha_forward", lambda: tak.mha_forward(
                        x, *params, draw, ATT_DROPOUT, H), plain_forward,
                     False),
                    ("mha_backward", lambda: tak.mha_backward(
                        gy, x, *params, draw, ATT_DROPOUT, H, False),
                     lambda: torch.autograd.grad(yp, params, gy,
                                                 retain_graph=True), True)):
                t = time_kernel(kernel, plain)
                n_bytes, flop = mha_cost(L, n, d, H, backward)
                rec[kname] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                              "bytes": n_bytes, "flop": flop,
                              **bound(n_bytes, flop, "float32")}
                print(f"  attention am {kname}: {t['ms']:.3f} ms, plain "
                      f"{t['plain_ms']:.3f}, bound "
                      f"{rec[kname]['bound_ms']:.3f} "
                      f"({rec[kname]['bound_by']})", flush=True)
            del yp
        out[tag] = rec
        del x, att, gy, draw, params
        torch.cuda.empty_cache()
    return out


# phase 20: the basis layer at the basis cell's shape
# (rgcn_bench/configs/rgcn_am_paper_basis.json): nodes, slots, edges, bases,
# width
BASIS_SHAPE = (1_666_764, 267, 11_976_642, 40, 10)


def basis_cost(n, slots, e, bases, h, backward) -> tuple:
    """(bytes, FLOP) any implementation of a pass must move in float32:
    the bases read once (and their gradient written, backward), ``comp``
    (and its gradient), 12 B an edge, the ``[n, h]`` output written (the
    gradient read, backward); ``2 bases h`` FLOP an edge forward, twice
    that backward."""
    k = 2 if backward else 1
    return (4 * (k * n * bases * h + k * slots * bases + n * h) + 12 * e,
            2 * k * e * bases * h)


def basis_phase(launches, reset) -> dict:
    """Phase 20: ``ops/basis_kernels.py`` at ``BASIS_SHAPE``: output and
    the four leaves' gradients against ``basis_conv_plain``'s autograd
    within ``check_close``'s float32 tolerance, one launch a call, the same
    bits on two runs; both passes' times beside the plain route's
    (``time_kernel``) and their bounds (``basis_cost``)."""
    import torch
    from scaling_rgcn_training_tpu_torch.ops import basis_kernels as bk
    from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

    n, slots, e, bases, h = BASIS_SHAPE
    src, dst, typ = random_graph(np.random.default_rng(20), n, e, slots)
    t0 = time.perf_counter()
    edges = build_rel_edges(src, dst, typ, n, slots, device=DEV)
    perm = edges.basis_perm
    print(f"  basis plan {time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device=DEV).manual_seed(20)
    leaves = [torch.rand(shape, generator=g, device=DEV) - 0.5 for shape in
              ((n, bases, h), (slots, bases), (n, h), (h,))]
    gy = torch.randn((n, h), generator=g, device=DEV)
    why = bk.refusal(*leaves, edges.span)
    if why is not None:
        fail(f"basis: the kernels refuse the cell's shape: {why}")
    params = [t.clone().requires_grad_() for t in leaves]
    ref = bk.basis_conv_plain(*params, edges)
    refs = (ref.detach(), *torch.autograd.grad(ref, params, gy))
    del ref, params
    reset()
    runs = []
    for _ in range(2):
        y = bk.basis_forward(*leaves, edges.span, perm)
        dv, dcomp = bk.basis_backward(gy, leaves[0], leaves[1], edges.span)
        runs.append((y, dv, dcomp))
    torch.cuda.synchronize()
    got = (launches["basis_forward"], launches["basis_backward"])
    if got != (2, 2):
        fail(f"basis: launches (basis_forward, basis_backward) {got}, "
             "expected (2, 2)")
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("basis: two runs gave different bits")
    errs = {nm: check_close(f"basis {nm}", a, b, False) for nm, a, b in
            zip(("out", "d_bases", "d_comp"), runs[0], refs)}
    del runs, refs
    rec = {"nodes": n, "slots": slots, "edges": e, "bases": bases,
           "width": h, "max_abs_err": max(errs.values()), "errs": errs}
    params = [t.clone().requires_grad_() for t in leaves]
    with torch.enable_grad():
        yp = bk.basis_conv_plain(*params, edges)

    def plain_forward():
        with torch.no_grad():
            return bk.basis_conv_plain(*leaves, edges)

    for kname, kernel, plain, backward in (
            ("basis_forward", lambda: bk.basis_forward(
                *leaves, edges.span, perm), plain_forward, False),
            ("basis_backward", lambda: bk.basis_backward(
                gy, leaves[0], leaves[1], edges.span),
             lambda: torch.autograd.grad(yp, params, gy, retain_graph=True),
             True)):
        t = time_kernel(kernel, plain, reps=10)
        n_bytes, flop = basis_cost(n, slots, e, bases, h, backward)
        rec[kname] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bytes": n_bytes, "flop": flop,
                      **bound(n_bytes, flop, "float32")}
        print(f"  basis {kname}: {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f}, bound {rec[kname]['bound_ms']:.3f} "
              f"({rec[kname]['bound_by']})", flush=True)
    del yp, params, leaves
    torch.cuda.empty_cache()
    rec["fit"] = basis_fit(edges, launches, reset)
    return rec


# phase 20's fit: epochs (2 eager warm-ups, the capture, replays) and the
# basis cell's labels, classes, learning rate and L2
BASIS_FIT = {"epochs": 8, "train": 802, "val": 198, "classes": 11,
             "lr": 0.01, "weight_decay": 5e-4}


def basis_fit(edges, launches, reset) -> dict:
    """A ``FeaturelessModel`` (``models/heads.py``
    ``init_featureless_model``) fit through ``Trainer.fit`` on ``edges``
    at ``BASIS_SHAPE`` with ``BASIS_FIT``'s labels and optimizer, the
    cross-entropy loss. Every layer-1 call must take the kernels
    (``basis.fused``, never ``basis.plain``); returns the launches of
    ``basis_forward`` and ``basis_backward`` of each step (each step's
    validation and training forwards and one backward), the median
    ms/step from the first replay and the reserved peak."""
    import torch
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu_torch.models.heads import (
        init_featureless_model)
    from scaling_rgcn_training_tpu_torch.train.losses import ce_loss
    from scaling_rgcn_training_tpu_torch.train.trainer import Trainer
    from scaling_rgcn_training_tpu_torch.utils import tracing

    n, slots, _, bases, h = BASIS_SHAPE
    cfg = BASIS_FIT
    rng = np.random.default_rng(21)
    labelled = rng.choice(n, cfg["train"] + cfg["val"], replace=False)
    y = np.eye(cfg["classes"], dtype=np.float32)[
        rng.integers(0, cfg["classes"], labelled.size)]
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=DEV)
    lab = lambda a: torch.as_tensor(a, device=DEV)
    cut = cfg["train"]
    graph = DeviceGraph(edges=edges, x_train=idx(labelled[:cut]),
                        y_train=lab(y[:cut]), x_val=idx(labelled[cut:]),
                        y_val=lab(y[cut:]))
    model = init_featureless_model(torch.Generator().manual_seed(21), slots,
                                   h, cfg["classes"], n, num_bases=bases,
                                   device=DEV)
    trainer = Trainer(None, None, cfg["epochs"], None, cfg["lr"],
                      cfg["weight_decay"], seed=0, device=DEV)
    stamps, per_step = [], []

    def on_epoch(epoch):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(dict(launches))

    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    per_step.append(dict(launches))
    before = tracing.counters()
    _, accs, losses, _, _ = trainer.fit(model, graph, ce_loss, "softmax",
                                        sum_graph=False, verbose=False,
                                        on_epoch=on_epoch)
    calls = {k: tracing.counters().get(k, 0) - before.get(k, 0)
             for k in ("basis.fused", "basis.plain")}
    if calls["basis.plain"] or not calls["basis.fused"]:
        fail(f"basis fit: layer 1 left the kernels: {calls}")
    if len(losses) != cfg["epochs"] or not all(np.isfinite(losses)):
        fail(f"basis fit: losses {losses}")
    kinds = ("basis_forward", "basis_backward")
    steps = [{k: b[k] - a[k] for k in kinds}
             for a, b in zip(per_step, per_step[1:])]
    if any(st != steps[0] for st in steps) or not all(steps[0].values()):
        fail(f"basis fit: the steps launched {steps}")
    route = trainer.step_route()
    if route != "graph":
        fail(f"basis fit: the step took the {route} route, not the graph")
    step_ms = statistics.median(np.diff(stamps[WARMUP:]) * 1e3)
    reserved = torch.cuda.max_memory_reserved() / 2**20
    print(f"  basis fit ({route}): {step_ms:.3f} ms/step, "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, calls {calls}, "
          f"launches a step {steps[0]}, reserved peak {reserved:.0f} MiB",
          flush=True)
    del model, trainer, graph
    torch.cuda.empty_cache()
    return {"route": route, "calls": calls,
            "per_step": steps[0], "step_ms": step_ms,
            "reserved_mib": reserved, "losses": losses}


def phases_to_run(argv) -> set:
    """The phases of ``--only N,M,...`` (every phase without it), with the
    phases whose results they read (``NEEDS``); 1 and 2 always run."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help="comma-separated phases "
                    "(with the phases they need; default: all)")
    only = ap.parse_args(argv).only
    if only is None:
        return set(PHASES)
    want = {1, 2}
    todo = [int(v) for v in only.split(",")]
    while todo:
        n = todo.pop()
        if n not in PHASES:
            ap.error(f"no phase {n}")
        if n not in want:
            want.add(n)
            todo.extend(NEEDS.get(n, ()))
    return want


def main(argv=None) -> None:
    want = phases_to_run(argv)
    phase("1 environment")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        fail(f"{PKG}/ is not beside this script: run it from a checkout")
    sys.path.insert(0, ROOT)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    from scaling_rgcn_training_tpu_torch.train.step_graph import EAGER_ENV
    print(f"{EAGER_ENV}={os.environ.get(EAGER_ENV)!r} (unset: every train "
          "step on one card runs as a captured CUDA graph)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    phase("2 build")
    from scaling_rgcn_training_tpu_torch import bench_shape as bs
    from scaling_rgcn_training_tpu_torch.ops import cuda_build
    from scaling_rgcn_training_tpu_torch.ops import span_kernels as sk

    t0 = time.perf_counter()
    paths = cuda_build.build()
    print(f"built {sorted(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
    launches, reset = cuda_build.LAUNCHES, cuda_build.reset_launch_counts
    from scaling_rgcn_training_tpu_torch.graphs.device import DeviceGraph

    splits, fits = bs.bench_splits(DEV), {}

    if 3 in want:
        phase("3 span kernels vs plain versions")
        from scaling_rgcn_training_tpu_torch.ops.rgcn_conv import build_rel_edges

        rng = np.random.default_rng(0)
        # edge cases: nodes 400..499 have no edges, relations 1, 4, 6, 8 none
        src, dst, typ = random_graph(rng, 500, 3000, 9, n_live=400,
                                     live_rels=[0, 2, 3, 5, 7])
        small = build_rel_edges(src, dst, typ, 500, 9, device=DEV).span
        for d_in, d_out in ((63, 4), (63, 11), (11, 63)):
            for dtype in (torch.float32, torch.bfloat16):
                compare_span_kernels(sk, small, d_in, d_out, dtype, rng,
                                     f"small {d_in}->{d_out} {dtype_name(dtype)}",
                                     tiled=True)
        # wide rows and 30 relations: W takes several shared-memory passes
        src, dst, typ = random_graph(rng, 400, 6000, 30)
        wide = build_rel_edges(src, dst, typ, 400, 30, device=DEV).span
        for dtype in (torch.float32, torch.bfloat16):
            compare_span_kernels(sk, wide, 128, 32, dtype, rng,
                                 f"small 128->32 30 slots {dtype_name(dtype)}",
                                 tiled=True)
        t0 = time.perf_counter()
        src, dst, typ = bs.bench_edges()
        edges = build_rel_edges(src, dst, typ, bs.N, bs.SLOTS, device=DEV)
        print(f"bench-shape edges built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        bench = {}
        for d_in, d_out, layer in ((bs.D, bs.HL, "layer1"), (bs.HL, bs.C, "layer2")):
            for dtype in (torch.float32, torch.bfloat16):
                bench[(layer, dtype_name(dtype))] = compare_span_kernels(
                    sk, edges.span, d_in, d_out, dtype, rng,
                    f"bench {layer} {d_in}->{d_out} {dtype_name(dtype)}", timing=True)
        conv_autograd_check(rng)

    if 4 in want:
        phase("4 segment-sum, grouped-matmul and d_rhs kernels vs plain versions")
        from scaling_rgcn_training_tpu_torch.ops.segment_kernels import segment_rowptr

        errs = {"segment_sum": 0.0, "grouped_matmul": 0.0, "grouped_drhs": 0.0}

        def note(res):
            for kname, key in (("grouped_matmul", "gmm"), ("grouped_drhs", "drhs"),
                               ("segment_sum", "seg")):
                if key in res:
                    errs[kname] = max(errs[kname], res[key]["err"])
            return res

        keys = np.sort(np.concatenate([rng.integers(0, 600, 3000) * 2,
                                       np.full(700, 901)])).astype(np.int32)
        rowptr = torch.as_tensor(segment_rowptr(keys, 1301)).to(DEV)
        sizes = torch.tensor([0, 1500, 3, 0, 2049, 1, 0, 777], device=DEV)
        m = int(sizes.sum())
        gen = torch.Generator(device=DEV).manual_seed(0)
        new_bench = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            t = lambda *shape, s=1.0: (torch.randn(
                shape, generator=gen, device=DEV) * s).to(dtype)
            # every width class of the kernels' dispatch (csrc/*.cu): #3 with
            # and without the gather and the scale, and with the values one
            # element off an aligned address (a narrower load width)
            e_small = len(keys)
            perm = torch.randperm(e_small, generator=gen, device=DEV).int()
            scale = torch.rand(e_small, generator=gen, device=DEV) + 0.1
            for h in (4, 8, 11, 16, 32, 64, 130):
                v = t(e_small * h + 1)
                note({"seg": check_segment(v[:-1].view(e_small, h), rowptr,
                                           f"small h {h} {name}")})
                note({"seg": check_segment(v[:-1].view(e_small, h), rowptr,
                                           f"small h {h} {name} perm+scale",
                                           perm=perm, scale=scale)})
                note({"seg": check_segment(v[1:].view(e_small, h), rowptr,
                                           f"small h {h} {name} perm+scale offset",
                                           perm=perm, scale=scale)})
            # every width class of the tensor-core kernels (column tiles past
            # 64, depth chunks past GMM_DEPTH) and of the earlier routes
            for k, n in ((63, 4), (16, 8), (8, 16), (63, 11), (24, 32), (256, 64),
                         (8, 130), (300, 11)):
                note(check_grouped(t(m, k), t(len(sizes), k, n, s=0.2), t(m, n),
                                   sizes, f"small {k}->{n} {name}", tiled=True))
            # every product of an edge-mode step at the bench shape, each timed:
            # layer 1 (D -> HL) and layer 2 (HL -> C) with their dW, then their
            # d_lhs (HL -> D, C -> HL); layer 1's also against the dataflows
            for k, n in ((bs.D, bs.HL), (bs.HL, bs.C)):
                r = note(check_grouped(
                    t(bs.E, k), t(bs.SLOTS, k, n, s=0.2), t(bs.E, n),
                    edges.group_sizes, f"bench {k}->{n} {name}", timing=True,
                    tiled=k == bs.D))
                new_bench[("grouped_matmul", f"{k}->{n}", name)] = r["gmm"]
                new_bench[("grouped_drhs", f"{k}x{n}", name)] = r["drhs"]
            for k, n in ((bs.HL, bs.D), (bs.C, bs.HL)):
                r = note(check_grouped(t(bs.E, k), t(bs.SLOTS, k, n, s=0.2), None,
                                       edges.group_sizes,
                                       f"bench d_lhs {k}->{n} {name}",
                                       timing=True))
                new_bench[("grouped_matmul", f"d_lhs {k}->{n}", name)] = r["gmm"]
            # every sum of an edge-mode step, on the edges' own permutations
            # (computed as RelEdges computes them, and not cached on `edges`,
            # so phase 5's fused runs do not hold them): the forward onto dst
            # rows (h HL, C) with norm, dx onto src rows (h D, HL); layer 1's
            # are timed, and so is each without the gather (values already in
            # key order), the shape the kernel was timed at before it gathered
            for h, side, timed in ((bs.HL, "dst", True), (bs.C, "dst", False),
                                   (bs.D, "src", True), (bs.HL, "src", False)):
                rp = edges.dst_rowptr if side == "dst" else edges.src_rowptr
                perm = getattr(type(edges), f"{side}_perm").func(edges)
                kw = {"perm": perm, "scale": edges.norm if side == "dst" else None}
                vals = t(bs.E, h)
                r = note({"seg": check_segment(
                    vals, rp, f"bench [E, {h}] -> {side} rows {name} "
                    f"perm{'+scale' if side == 'dst' else ''}", timing=timed,
                    **kw)})["seg"]
                if timed:
                    key = "segment_sum" if side == "dst" else "segment_sum dx"
                    new_bench[(key, f"[E, {h}]", name)] = r
                    new_bench[(key, f"[E, {h}] no perm", name)] = note(
                        {"seg": check_segment(
                            vals, rp, f"bench [E, {h}] -> {side} rows {name} "
                            "no perm", timing=True)})["seg"]
                del vals, perm, kw   # phase 5's peak memory holds none of them

    if 5 in want:
        phase("5 trainer at the bench shape")
        reset()
        for cd in (None, "bfloat16"):
            fits[("fused", cd)] = run_fit(DeviceGraph(edges=edges, **splits), cd,
                                          EPOCHS, launches)
            require_per_step(f"fused {cd}", fits[("fused", cd)]["steps"],
                             {"span_forward": 4, "span_backward": 2})
        fused_launches = dict(launches)
        # the end-to-end effect of #1's and #2's redesigns
        swap = {}
        for kernel in ("span_forward", "span_backward"):
            swap[kernel] = s = route_swap(DeviceGraph(edges=edges, **splits),
                                          launches, kernel)
            print(f"  fused f32 ms/step, {kernel} on the tensor cores "
                  f"{s['redesigned']} vs its earlier route {s['earlier route']} "
                  "(order: redesigned, earlier, earlier, redesigned)",
                  flush=True)

        t0 = time.perf_counter()
        plain_edges = build_rel_edges(src, dst, typ, bs.N, bs.SLOTS, device=DEV,
                                      span=False)
        print(f"bench-shape edges without the span plan built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        non_fused = DeviceGraph(edges=plain_edges, **splits)
        reset()
        for cd in (None, "bfloat16"):
            fits[("edge", cd)] = run_fit(non_fused, cd, EPOCHS, launches,
                                         backend="pallas")
            require_per_step(f"edge mode {cd}", fits[("edge", cd)]["steps"],
                             {"grouped_matmul": 4, "segment_sum": 4,
                              "grouped_drhs": 2})
        edge_launches = dict(launches)
        if edge_launches["span_forward"] or edge_launches["span_backward"]:
            fail(f"edge-mode trainer launched span kernels: {edge_launches}")
        # the end-to-end effect of #4's and #5's redesigns
        swap["grouped"] = s = route_swap(non_fused, launches, "grouped",
                                         backend="pallas")
        print(f"  edge-mode f32 ms/step, gmm and gmm_drhs on the tensor cores "
              f"{s['redesigned']} vs their earlier routes {s['earlier route']} "
              "(order: redesigned, earlier, earlier, redesigned)", flush=True)
        # the end-to-end effect of #3's redesign (the gather and the scale
        # inside the kernel); its sums are the earlier route's, bit for bit
        swap["segment_sum"] = s = route_swap(non_fused, launches, "segment_sum",
                                             backend="pallas")
        print(f"  edge-mode f32 ms/step, segment_sum with the gather inside "
              f"{s['redesigned']} vs its earlier route {s['earlier route']} "
              "(order: redesigned, earlier, earlier, redesigned); the same loss "
              f"bits on both routes: {s['same_losses']}; as the first edge-mode "
              f"run's: {s['losses'] == fits[('edge', None)]['losses']}",
              flush=True)
        fused_l, edge_l = (fits[(k, None)]["losses"] for k in ("fused", "edge"))
        if not np.allclose(edge_l, fused_l, rtol=1e-4, atol=0):
            fail(f"edge-mode f32 losses {edge_l} differ from fused {fused_l}")
        print(f"  edge-mode f32 losses match the fused run's (max rel diff "
              f"{max(abs(a - b) / abs(b) for a, b in zip(edge_l, fused_l)):.2e})",
              flush=True)
        # where the fused/edge loss gap starts: one step's gradients, per layer
        grads = layer_gradients(edges, plain_edges, splits)
        reset()
        fits[("attention", None)] = run_fit(non_fused, None, ATT_EPOCHS, launches,
                                            backend="pallas", aggr="attention")
        require_per_step("attention", fits[("attention", None)]["steps"],
                         {"grouped_matmul": 1, "grouped_drhs": 1})
        att_launches = dict(launches)

    if 6 in want:
        phase("6 auto mode on a layer too wide for the span kernels")
        wide_auto_check(edges, rng, launches, reset)

    if 7 in want:
        phase("7 CLI on the GPU")
        # layer 1 (128 -> 64) is wider than the span kernels take: auto mode
        # runs it non-fused
        run_cli(["-emb", "128", "-hl", "64"], "summation -emb 128 -hl 64")
        run_cli(["-backend", "pallas", "-aggr", "attention"],
                "summation -backend pallas -aggr attention")
        run_cli([], "no -exp", exps=("summation", "mlp", "attention"))

    if 8 in want:
        phase(f"8 halo partition on {HALO_SHARDS} virtual shards of the card")
        halo = halo_phase(src, dst, typ, splits, fits, launches, reset)

    if 9 in want:
        phase("9 kernel #8, the one-pass backward, and its microbench")
        bwd = bwd_variant_phase(small, wide, edges.span, rng, launches, reset)

    if 10 in want:
        phase("10 MLP and attention heads at the bench shape")
        head_launches = {}
        for head in ("mlp", "attention"):
            reset()
            f = fits[(f"{head} head", None)] = run_fit(
                DeviceGraph(edges=edges, **splits), None, EPOCHS, launches,
                head=head)
            require_per_step(f"{head} head", f["steps"],
                             {"span_forward": 4, "span_backward": 2})
            head_launches[f"{head} head"] = dict(launches)

    if 11 in want:
        phase("11 checkpoint, resume, plan cache, summary writers and the "
              "native parser")
        from scaling_rgcn_training_tpu_torch.parallel.halo import EXCHANGE_ENV

        # the plans at the bench shape cold and warm; the fused and halo #7
        # resumes below train on the warm (cached) plans
        ckpt = {"resume": {}}
        ckpt["plan_cache"], warm = plan_cache_check(src, dst, typ, halo["mesh"])
        ckpt["resume"]["fused"] = resume_check(
            "fused f32", DeviceGraph(edges=warm["build_rel_edges (span plan)"],
                                     **splits), EPOCHS, 4,
            fits[("fused", None)]["losses"], launches, reset,
            ("span_forward", "span_backward"))
        ckpt["resume"]["edge"] = resume_check(
            "edge-mode f32", non_fused, EPOCHS, 4, fits[("edge", None)]["losses"],
            launches, reset, ("grouped_matmul", "segment_sum", "grouped_drhs"),
            backend="pallas")
        os.environ[EXCHANGE_ENV] = "fused"
        try:
            ckpt["resume"]["halo #7"] = resume_check(
                f"halo #7 f32 ({HALO_SHARDS} shards)", DeviceGraph(
                    edges=warm[f"halo partition ({HALO_SHARDS} shards)"],
                    **splits), HALO_EPOCHS, 2, fits[("halo #7", None)]["losses"],
                launches, reset, ("fused_halo_aggregate", "span_backward"),
                mesh=halo["mesh"], partition="halo")
        finally:
            os.environ.pop(EXCHANGE_ENV, None)
        del warm
        ckpt["cli"] = cli_checkpoint_phase()
        ckpt["native_parse"] = native_parse_check()

    if 12 in want:
        phase("12 training across processes (multihost_sim: halo and edge "
              "partitions) at the bench shape")
        multihost = multihost_phase(torch.cuda.device_count())
        shared = multihost["2 processes x 2 shards, one card"]

    if 13 in want:
        phase("13 the AM shape (rehearse_am, rehearse_am_dist) on the card")
        torch.cuda.empty_cache()
        am = am_phase(launches, reset)

    if 14 in want:
        phase("14 bench (the JAX bench's timing entry point) at its defaults")
        torch.cuda.empty_cache()
        bench_res = bench_phase()

    if 15 in want:
        phase("15 bench_scaling (halo scaling over 1, 2 and 4 shards) on "
              "the card")
        torch.cuda.empty_cache()
        scaling = scaling_phase(launches, reset)

    if 16 in want:
        phase("16 halo overlap (measure_overlap)")
        torch.cuda.empty_cache()
        overlap = overlap_phase(launches, reset)

    if 17 in want:
        phase("17 the step as one graph (eager and graph routes in turns)")
        torch.cuda.empty_cache()
        graphs = {}
        if 5 in want:
            graphs.update(fused=DeviceGraph(edges=edges, **splits),
                          edge=non_fused)
        if 8 in want:
            graphs.update(halo=halo["graph"], mesh=halo["mesh"])
        t0 = time.perf_counter()
        step_graph = step_graph_phase(graphs, launches, reset)
        del graphs
        print(f"  phase 17: {time.perf_counter() - t0:.1f} s", flush=True)

    if 18 in want:
        phase("18 node-sharded mesh (each shard's rows on its own card)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        node_shard = node_shard_phase(launches, reset)
        print(f"  phase 18: {time.perf_counter() - t0:.1f} s", flush=True)

    if 19 in want:
        phase("19 the attention head's kernels against the plain-op MHA")
        att_kernels = attention_phase(launches, reset)

    if 20 in want:
        phase("20 the basis layer's kernels against the plain route")
        basis = basis_phase(launches, reset)

    print(f"chip_smoke: phases {sorted(want)} in "
          f"{time.perf_counter() - _T0:.1f} s", flush=True)
    if want != set(PHASES):
        # a partial run (--only): the new phases' numbers, no kernels line
        print(json.dumps({"card": card, "only": sorted(want),
                          **({"bench": bench_res} if 14 in want else {}),
                          **({"bench_scaling": scaling} if 15 in want
                             else {}),
                          **({"overlap": overlap} if 16 in want else {}),
                          **({"step_graph": step_graph} if 17 in want
                             else {}),
                          **({"node_shard": node_shard} if 18 in want
                             else {}),
                          **({"attention_kernels": att_kernels}
                             if 19 in want else {}),
                          **({"basis_kernels": basis} if 20 in want
                             else {}),
                          **({"head_launches": head_launches} if 10 in want
                             else {})}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    kernels = []
    b = bench[("layer1", "float32")]
    for kname, key, src_file, replaces in (
            ("span_forward", "fwd", "span_fwd_tc.cu", "span_kernels.py:425"),
            ("span_backward", "bwd", "span_bwd_tc.cu", "span_kernels.py:542")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/{src_file}",
            "replaces": JAX_PKG + "ops/" + replaces,
            "launches": fused_launches[kname],
            "max_abs_err": max(v[f"{key}_err"] for v in bench.values()),
            "ms": b[key]["ms"], "plain_ms": b[key]["plain_ms"],
            "bound_ms": b[key]["bound_ms"], "bound_by": b[key]["bound_by"],
            "library_ms": None, "previous_ms": b[key]["previous_ms"]})
    for kname, shape, src_file, replaces in (
            ("segment_sum", "[E, 16]", "segment_kernels.cu",
             "segment_kernels.py:87"),
            ("grouped_matmul", "64->16", "grouped_kernels.cu",
             "pallas_kernels.py:56"),
            ("grouped_drhs", "64x16", "grouped_kernels.cu",
             "pallas_kernels.py:114")):
        r = new_bench[(kname, shape, "float32")]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{PKG}/csrc/{src_file}",
            "replaces": JAX_PKG + "ops/" + replaces,
            "launches": edge_launches[kname], "max_abs_err": errs[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        # the CUDA kernels it launches at the bench shape, and its earlier
        # route's time (sorted_segment_sum_rows, gmm_simt, gmm_drhs_simt)
        # in this run; #3's figures are its main-path call, [E, 16] onto
        # dst rows through dst_perm with norm
        kernels[-1].update(
            kernels={"segment_sum": ["segment_sum_kernel"],
                     "grouped_matmul": ["gmm_tc_kernel"],
                     "grouped_drhs": ["drhs_tc_kernel",
                                      "drhs_reduce_kernel"]}[kname],
            previous_ms=r["previous_ms"])
        # phase 12's edge partition across 2 processes: each child's
        # launches in its 10 float32 steps
        kernels[-1]["cross_process"] = {"launches": [
            sum(st[kname] for st in proc)
            for proc in shared["modes"]["edge-f32"]["launches"]]}
    for kname, key, replaces, run in (
            ("halo_exchange", "exchange", "ring_halo.py:42", "halo #6"),
            ("fused_halo_aggregate", "fused", "fused_halo.py:307",
             "halo #7")):
        r = halo["bench"][("layer1", "float32")][key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/halo_kernels.cu",
            "replaces": JAX_PKG + "parallel/" + replaces,
            "launches": halo["counts"][run][kname],
            "max_abs_err": halo["errs"][key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
        calls = shared["calls"]
        kernels[-1]["cross_process"] = {
            "ms": max(c[kname]["ms"] for c in calls["multi"]),
            "one_process_ms": calls["single"][kname]["ms"],
            "bound_ms": calls["multi"][0][kname]["bound_ms"],
            "library_exchange_ms": max(c["library_exchange"]["ms"]
                                       for c in calls["multi"]),
            "launches": [sum(st[kname] for st in proc) for proc in
                         shared["modes"][{"halo_exchange": "kernel-f32",
                                          "fused_halo_aggregate":
                                          "fused-f32"}[kname]]["launches"]]}
        if key == "fused":
            # span_tc.cuh's chunk kernel over the shards' rows and CSR sum,
            # then the halo buffer's copy (halo_kernels.cu fused_halo_tc)
            kernels[-1].update(
                kernels=["span_msg_kernel", "span_msg_sum_kernel",
                         "halo_buf_kernel"], previous_ms=r["previous_ms"])
    # the redesign's three kernels (bwd_variants.cu bwd_tc_kernel and its
    # W staging and dW reduce); previous_ms: the earlier route's base
    kernels.append({
        "name": "span_backward_variant", "route": "cuda",
        "source": f"{PKG}/csrc/bwd_variants.cu",
        "replaces": "scripts/bwd_variants.py:76",
        "launches": bwd["launches"], "max_abs_err": bwd["err"],
        **{k: bwd["base"][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "previous_ms")},
        "library_ms": None,
        "kernels": ["bwd_wsplit_kernel", "bwd_tc_kernel",
                    "bwd_tc_reduce_kernel"]})
    # the attention head's kernels (no Pallas counterpart: the JAX package
    # leaves its MHA to XLA); launches: phase 10's attention-head fit
    for kname, kernel_names in (
            ("mha_forward", ["mha_pack_kernel", "mha_fwd_kernel"]),
            ("mha_backward", ["mha_pack_kernel", "mha_bwd_kernel",
                              "mha_reduce_kernel"])):
        r = att_kernels["am"][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/attention_kernels.cu",
            "replaces": JAX_PKG + "models/attention.py:48",
            "launches": head_launches["attention head"][kname],
            "max_abs_err": max(v["max_abs_err"]
                               for v in att_kernels.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "kernels": kernel_names})
    # the featureless basis layer's kernels (no Pallas counterpart: the
    # JAX package materialises the relation weights)
    for kname, kernel_names in (
            ("basis_forward", ["basis_msg_kernel", "basis_sum_kernel"]),
            ("basis_backward", ["basis_bwd_kernel",
                                "basis_dcomp_chunk_kernel",
                                "basis_dcomp_reduce_kernel"])):
        r = basis[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/basis_kernels.cu",
            "replaces": JAX_PKG + "ops/rgcn_conv.py materialize_weight",
            "launches": basis["fit"]["per_step"][kname],
            "max_abs_err": basis["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "kernels": kernel_names})
    # the launches of this slice's paths: bench's per timed step (phase
    # 14's float32 line), bench_scaling's over phase 15's drive
    for entry in kernels:
        kname = entry["name"]
        if kname in ("span_forward", "span_backward"):
            entry["bench_launches_per_step"] = \
                bench_res["lines"]["float32"]["launches_per_step"][kname]
        ran = sum(c[kname] for c in scaling["launches"].values())
        if ran:
            entry["bench_scaling_launches"] = ran
        # phase 18's node-sharded bench_scaling runs
        ran = sum(c[kname] for c in node_shard["launches"].values())
        if ran:
            entry["node_shard_launches"] = ran
    print(json.dumps({
        "card": card,
        "bench_shape_ms": {
            **{f"{k} {layer} {dt}": v[k] for (layer, dt), v in bench.items()
               for k in ("fwd", "bwd")},
            **{" ".join(key): v for key, v in new_bench.items()},
            **{f"{k} {layer} {dt}": v[k] for (layer, dt), v in
               halo["bench"].items() for k in ("exchange", "fused")
               if k in v}},
        "step": {f"{mode} {cd or 'float32'}": {
            "step_ms": f["step_ms"], "peak_mib": f["peak_mib"],
            "loss_first": f["losses"][0], "loss_last": f["losses"][-1],
            "launches_step0": f["steps"][0]} for (mode, cd), f in fits.items()},
        "fused_f32_step_ms_by_route": {
            k: swap[k] for k in ("span_forward", "span_backward")},
        "edge_f32_step_ms_by_route": {
            k: swap[k] for k in ("grouped", "segment_sum")},
        "halo_f32_step_ms_by_route": halo["swap"],
        "halo_span_forward_per_call": halo["per_call"],
        "launches": {"fused": fused_launches, "edge": edge_launches,
                     "attention": att_launches, **halo["counts"],
                     **head_launches},
        "bwd_variants": bwd["rows"], "layer_gradients": grads,
        "checkpoint": ckpt,
        "multihost": {name: {k: rec.get(k) for k in (
            "backend", "modes", "calls", "edge_calls", "edge_check",
            "barrier", "plan_load_s")}
            for name, rec in multihost.items()},
        "am_shape": am, "bench": bench_res, "bench_scaling": scaling,
        "overlap": overlap, "step_graph": step_graph,
        "node_shard": node_shard, "attention_kernels": att_kernels,
        "basis_kernels": basis}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
