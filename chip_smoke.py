#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card; without one (or without the repo beside it) it exits
non-zero and prints no result.

Phases, each printed as it ends:

1. card: name, power limit and count (``nvidia-smi``);
2. build: ``nvcc`` compiles every kernel source of the paths
   (``local_reduce``, ``ring``, ``flash_attention_3xtf32`` (f32),
   ``flash_attention_wgmma`` (bf16), ``flash_attention_bwd_3xtf32`` (f32)
   and ``flash_attention_bwd_wgmma`` (bf16)), all in parallel, and ptxas's
   register and spill lines go to stderr;
3. kernel vs plain: K1 ``masked_average`` and K2 ``elastic_average_step``
   against their plain versions on the card, at the main path's shapes
   (K = 16 workers x 64M floats with a 12-of-16 threshold mask, and the
   bench's packed K = 8 stacks), plus the zero mask (K2 leaves X
   bit-identical, K1 gives zeros and count 0), ragged widths (17, 1000,
   65537) and K above the register-resident bound (40); then K3, the ring
   allreduce (one cluster launch a call), against its plain version, bit
   for bit in every mode: n in {2, 3, 4, 8, 16, 24} ranks (24: two ranks a
   CTA), ``seg_rows`` in {1, 4, 512}, ragged data, a per-rank mask applied
   inside the kernel at n in {3, 8, 16, 24}, int8 segments wider than one
   cluster's item (a team of clusters agreeing on each scale: n 8 at
   ``seg_rows`` 2048), an int8 all-zero segment, and the full shape, n = 8
   ranks x 25,000,000 floats (BASELINE config 4's ResNet-50 buffer; 48
   buckets) under a 6-of-8 mask passed to the kernel, with every rank's
   row checked against rank 0's; its ptxas report (registers, spills) and
   launch plan (ranks per CTA, cluster, clusters, item width, int8 team,
   shared memory) are printed; then K4, the
   flash-attention forward, against its plain version (the f32 kernel's
   ptxas registers and spills and its shared memory at every D printed
   first): the flagship shape (B 8, T 2048, H 16, D 128) in bf16, causal,
   through the bf16 Hopper kernel (``flash_attention_wgmma``), the same in
   f32 at B 2 through the split-TF32 one (``flash_attention_3xtf32``), each
   counter moving for every shape of its dtype and for no other, a repeat
   bit-identical; non-causal; D in {32, 64, 96, 128, 256}; T in {1024,
   1536, 4096}; grouped-query K/V (4 and 1 KV heads); T 576 and 1088
   (ragged 128-row blocks) with 4 and 1 KV heads; and the lse within 1e-4;
   then K4's backward (dq, dk, dv)
   and the forward's lse against the plain versions: the flagship in bf16
   through the Hopper kernels (``flash_attention_bwd_wgmma``), f32 at B 2
   through the split-TF32 Hopper kernels (``flash_attention_bwd_3xtf32``),
   each counter moving for every shape of its dtype and for no other (both
   kernels' ptxas registers and spills and each kernel's shared memory are
   printed), non-causal, D in {32, 64, 128, 256}, T in {1024, 4096}, H 16
   over 4 and 1 KV heads, T 576 and 1088 (ragged 128-key blocks) with 4
   and 1 KV heads, every shape launched twice and held to bit equality; and
   the gradients through ``local_attention`` at a gated shape (the autograd
   path) against the plain version's;
4. main paths, each with its launch counters set to 0 just before it and
   read just after: (a) threshold rounds at K = 16 x 64M (each round's
   result from ``masked_average``, the fold from ``elastic_average_step`` on
   the packed form), checked against the same rounds through the plain
   versions, then the bench (the ``local_threshold_reduce_bw`` metric) and
   ``bench_suite.run_suite`` for configs 1 to 5; (b) for each compress
   mode, ``threshold_allreduce(line_mesh(8), ..., schedule="pallas_ring")``
   at 8 x 25M (the mask rides into K3: one launch a round, checked) against
   the same round through the plain K3, and one ``measure_allreduce``
   record, printed on its own line; (c) the butterfly
   ``threshold_allreduce(grid_mesh(4, 4), ...)`` at 16 x 64M (config 2's
   shape) against a float64 sum; (d) the Transformer LM's serving path at
   the flagship width (vocab 256, d_model 2048, 16 heads, 8 layers, seeded
   random weights): the bf16 forward on B 8 x T 2048 copy-task tokens
   (K4 once a layer through the bf16 Hopper kernel, finite logits); the
   f32 forward (K4 once a layer through the split-TF32 one) against
   ``LMGenerator.decode_logits(chunk=256)``, whose nonzero offsets take the
   dense or blockwise path (no K4); ``LMGenerator.generate`` with the
   2048-token prompt and 32 greedy steps in f32 (K4 at prefill), its first
   8 tokens against a naive re-forward; then ``lm-generate`` at that width
   in bf16, whose prefill ms and decode ms per token are printed on their
   own line; (e) the LM's training path: the flagship in bf16 through
   ``LongContextTrainer.train_step`` on copy-task batches (K4's forward and
   backward 8 times a step each, both through the Hopper kernels, finite
   losses, contributors 1), then a
   ``valid=[0]`` step (loss 0, contributors 0); the whole model's f32
   gradient (2 layers, B 2, T 2048) with the kernels (the f32 forward and
   backward through ``flash_attention_3xtf32`` and
   ``flash_attention_bwd_3xtf32``) against the same model's with
   the plain attention; ``lm-generate --train-steps`` at a small gated width
   (d 128, 4 heads, 2 layers, T 1024; its f32 backward through the same
   kernels), whose last loss must be below its first, with the copy
   accuracy printed; (f) ``DPTrainer`` on the MLP over virtual ranks:
   bench-suite config 3 (its record printed, one K1 launch a step), then
   ``MLP(hidden=(2048, 2048))`` (bench-mfu's width, 5,824,522 parameters)
   over ``line_mesh(8)`` at 16 rows a rank in f32: K1 against
   ``masked_average_reference`` on a step's ``(8, 5824522)`` gradient
   stack, with every rank and with rank 7 masked, and the parameters after
   the update from either average, bit for bit; a step with 8 contributors,
   one with 7, then 20 steps with a falling loss, one K1 launch each; one
   step each of the bf16 and int8 syncs (the int8 ring's rows
   bit-identical) and of both with error feedback under a masked rank (its
   bf16 residual row more than 50x any other's; the int8 residual equal to
   the ring's per-hop errors plus the masked rank's whole gradient), none
   launching K1; an overlapped f32 step with rank 7 masked (K1 once a leaf,
   6 launches, each leaf's K1 output equal to the matching slice of one
   fused K1 average of all the leaves' cotangent rows, bit for bit; the
   parameters within rtol 1e-5, atol 1e-7 of the fused step's); an
   overlapped bf16 + EF and int8 + EF step each under a masked rank (no K1;
   every leaf's new residual equal to its formula on the folded rows, bit for
   bit; the bf16 masked row more than 10x any other's); an accumulated step
   of 4 microbatches (one K1 launch; loss within 1e-5 and parameters within
   2e-5 of a plain step on the same batch); ``train_chain`` for 2 steps on
   card-drawn batches, ``train-mlp`` for 5 steps, the ``bench-mfu
   --workload mlp`` record and ``train-mlp --overlap`` / ``--accum 2`` for 3
   steps each (6 and 1 K1 launches a step); (g) ``DPTrainer`` on ResNet-50
   (``ResNet50(classes=1000)``, 25,557,032 parameters, 161 leaves) over
   ``line_mesh(8)``, 64 px ``imagenet_like`` images, 2 rows a rank: the f32
   forward against the same seed's model on the CPU within 1e-4 of
   max|logit|, under PyTorch's default cuDNN setting (the model turns TF32
   off for its convs and hands the setting back); K1 against ``masked_average_reference`` on a step's ``(8,
   25557032)`` stack (the float4 path), with every rank and with rank 7
   masked, and the update from either, bit for bit; then, counted, 3 f32
   steps with ``bucket_size=262,144`` on one batch (loss finite and
   falling), an overlapped f32 step (161 K1 launches, each equal to the
   fused average's slice), an accumulated step (one), a bf16-compute step
   (one) and an int8 + EF step (none); ``train-resnet`` for 3 steps (its
   ``(8, 23528522)`` stack, the scalar path), ``bench-mfu --workload
   resnet`` and ``graft_entry.entry()`` / ``dryrun_multichip(8)``; (h) the
   host engine (``control.LocalAllreduceSystem``, its round buffers on the
   card, its bookkeeping on the host), each run against the same run on the
   CPU, every node's every flush (data and counts) bit for bit: BASELINE
   config 1 (``bench_suite.config1_local_engine()``, 4 workers x 1,000,000
   floats, chunk 262,144, thresholds 1.0, 30 rounds; its record printed on
   its own line; every round buffer seen as the messages go is on the
   card); 3 rounds of it under ``torch.profiler``, with no copy between
   host and card and no K1-K4 kernel; ResNet-50's gradient, 4 workers x 25,557,032
   floats at the same chunk, 5 rounds (seconds, MB/s, the median round
   time from Start to completion ended by a synchronize, and the device's
   busy share under the profiler, printed); the host tier of config 5
   (200,000 floats, chunk 16,384, thresholds 0.75, 10 rounds, every message
   of worker 3 lost: all 10 rounds at node 0, counts in {0, 3}); the 2-D
   butterfly at 1M floats (counts 4); ``ElasticAverageBinder`` with the
   weights on the card (4 nodes, alpha 0.5, 5 rounds: the spread between the
   nodes' weights falls every round, the weights within rtol 1e-6 of the
   CPU run's); ``local-demo --size 1000000 --rounds 5`` naming the card; no
   K1-K4 launch in the whole phase; (i) checkpoints and resume:
   ``Zero1DPTrainer`` at the JAX ``bench-checkpoint --trainer zero1`` width
   (``MLP(hidden=(2048,) * 8)``, 31,002,634 parameters, Adam 1e-3,
   ``line_mesh(8)``, 16 rows a rank): 3 f32 steps (the second with rank 3
   masked), K1 once each, the flat weights bit-equal to ``DPTrainer``'s over
   the same steps; a bf16 + EF step in its stages, the residual equal to
   ``c - bf16(c·v)`` bit for bit, the masked row more than 50x any other's,
   no K1; that trainer saved over 8 ranks and restored over 4 (weights and
   Adam's state equal, the residual's sum within rtol 1e-6); then, for each
   of the four stores (``TrainerCheckpointer``, ``DeltaCheckpointer`` and
   their async forms) and each of ZeRO-1 (f32), ``DPTrainer`` on
   ``MLP(2048, 2048)`` with int8 + EF (the plain ring: no K1) and the
   LM at the flagship's width cut to 1 of its 8 layers, in bf16 at B 2
   (K4's forward and backward once a layer a step): save, 2 more steps (for the async stores while the writer
   drains), restore into a second trainer whose state must be the one of
   the moment of the save, the same 2 steps, every tensor equal to the
   saver's bit for bit; the async stores' host buffers pinned; then
   ``bench-checkpoint`` at the flagship's width in bf16, 1 layer, for the
   full and the delta store (``--skip-sync``) and with ``--trainer zero1``, each record printed
   on its own line
   (capture stall, save wall, step time during the save, sync stall, delta
   stats), its K1 or K4 launches equal to its steps; (j) the TCP control
   plane, the nodes' round buffers on the card: the wire codec's C++ built
   with g++; BASELINE config 1 over loopback TCP (``cluster-master --nodes 4
   --size 1000000 --chunk 262144 --rounds 8 --th 1.0`` and four
   ``cluster-node`` processes on the card, and the same with ``--device
   cpu``), each node's last flush against the numpy mean of the four seeded
   payloads (rtol 1e-5, atol 1e-6, counts 4), every node on ``wire=native``
   and the master with no CUDA context; ResNet-50's gradient (25,557,032
   floats, ``--streams 3``, 1 round) in f32 and with ``--wire-dtype f16``
   (within 2e-3 of max|mean|); the four clusters at once, each on its own
   ports; each run's node rounds, MB/s, stage times (``d2h`` and ``h2d``:
   the copies off and onto the card), wire path and device, the median
   round and the runs beside it printed; in this process's event loop,
   ``MasterProcess`` with ``NodeProcess(device="cuda")`` nodes: the 2-D
   butterfly, thresholds 0.75 with a node stopped mid-run (re-mesh), a late
   joiner, and an int8 policy (each flush within two int8 steps of the mean,
   the error feedback's residuals on the card, the mean over rounds closer
   than one round); ``obs demo --nodes 2``; ``bench-wire --uring
   --intra-chunk --congestion`` with its payloads on the card; no K1-K4
   launch; (k) elasticity: config 5's record
   (``bench_suite.config5_dropout_recovery``: the host tier and the re-mesh
   tier on ``{0: [rank], 1: []}``, a zero-rank control node dropping and
   rejoining, the MoE tier over 4 nodes of 2 ranks; every flag true, one K1
   launch for each of its 15 f32 steps); ``ElasticDPTrainer`` on
   ``MLP(hidden=(2048, 2048))`` over 4 nodes x 2 virtual ranks, 16 rows a rank, f32: 2 steps, node 3 silent (6
   ranks), 2 steps, node 3 back (8 ranks), 2 steps, K1 once a step, every
   step bit-equal to a continuation oracle (a fresh ``DPTrainer`` restored
   from a ``Snapshot`` at each re-mesh) and the final parameters within
   rtol 2e-4, atol 2e-5 of the same cycle on the CPU, each re-mesh's
   seconds alone and with its first step printed (drop, rejoin, warm
   drop) with the snapshot's bytes; 5 more drop/rejoin cycles, after which
   ``torch.cuda.memory_allocated`` is at most 1 MiB above its value after
   the first; the compress ladder (``apply_policy_wire`` "f16", "int8",
   "") with a step at each rung; the int8 + EF trainer's residual sum kept
   across 8 -> 6 ranks within 1e-6 of max|sum|; ``train-cluster-master
   --nodes 2`` with two ``train-cluster-node`` processes on the card,
   ``--model mlp`` and ``--model lm`` side by side (each node's steps, sync rounds
   applied, falling loss and device printed; the master without a CUDA
   context); ``elastic-demo --family dp --nodes 4`` (8 -> 6 -> 8 ranks, 30
   K1 launches); (l) chaos: ``ElasticDPTrainer`` on ``MLP(2048, 2048)``
   over 4 nodes x 2 virtual ranks, 16 rows a rank, f32, for 24 steps, its
   live nodes at each step set by the first ``membership_schedule(seed, 4,
   24)`` from seed 0 that re-meshes at least twice (seed, schedule and
   ``leader_kill_step`` printed): K1 once a step, every step bit-equal to
   the continuation oracle, the final parameters within rtol 2e-4, atol
   2e-5 of the same schedule on the CPU, each re-mesh's seconds alone and
   with its first step printed; the zoo's ``zero1`` trainer (ZeRO-1, SGD
   with momentum 0.9, the momentum sharded over the ranks) at the same width
   under the same schedule: K1 once a step, at every re-mesh the gathered
   momentum bit-equal to what it was before and nonzero, every step's
   parameters and momentum within rtol 2e-4, atol 2e-5 of one unsharded
   ``torch.optim.SGD`` over the whole batch that never re-meshes;
   ``chaos-train --family dp`` and ``zero1``
   (3 nodes, the victim's seeded crash at round 12, 10 rounds after it)
   with the nodes on the card: the victim's exit 23, every survivor's
   device, steps, K1 launches (one an f32 step), re-meshes and loss before
   and after the kill printed, no CUDA context in the drill's process or
   the master; the ``chaos`` drill at config 1's size (1,000,000 floats,
   chunk 262,144, seed 1234, 20 rounds, the default spec; the injected
   counts and the median round printed); ``LocalAllreduceSystem`` at config 1's size
   under a spec that drops, duplicates, reorders and corrupts (thresholds
   0.75, 10 rounds), every flush bit-equal to the same run on the CPU and
   the event log byte-identical; ``chaos-adapt``, ``chaos-recover`` and
   ``chaos-failover`` (each 10 rounds after the wiped node's restore),
   ``chaos-gossip`` and ``chaos-scale`` (2x4 grid, 2 shards) with the JAX
   Makefile's levers, every summary printed on its own line with the
   drill's wall seconds and the drills it ran beside (four at a time, each
   started as soon as one ends); ``train-mlp --profile-dir`` (a Chrome trace
   holding K1, 5 launches); (m) the int8 KV cache and MoE: the flagship LM
   in bf16 served from an int8 cache (B 8, prompt 2048): the cache's bytes
   against the bf16 cache's ((D + 4) / 2D), K4 once a layer at the prefill
   (the dequantize branch) and the prefill's logits within 2e-2 of max|logit|
   of the plain attention over the same dequantized cache, no K4 launch in
   decode, one decode step of ``quantized_cache_attention`` within 1e-5 of
   max|out| of the CPU's, the greedy tokens' agreement and the prefill
   logits' difference between the int8 and bf16 caches, ``lm-generate
   --cache-quant int8`` beside ``lm-generate`` (prefill_ms, ms_per_token);
   the MoE LM at ``bench-mfu --workload moe``'s defaults (8 experts, top-1,
   capacity factor 1.25, scatter dispatch, bf16, 2.28B parameters, B 8 x T
   2048): K4's bf16 forward and backward once a layer a step, a 20-step
   chain whose loss falls (the dropped fraction printed), two steps under
   ``torch.profiler``, the peak memory, the floor on the active parameters,
   ``bench-mfu --workload moe`` and ``--mu-bf16``; at a dense width (d 128,
   T 256) three SGD steps on the card within 1e-4 of the CPU's and the
   scatter dispatch within 1e-5 of the einsum; ``train-moe`` at its defaults
   with a falling loss and config 5's MoE fields from (k)'s record; (n) sequence and tensor parallelism over
   virtual ranks: ``LongContextTrainer`` on the flagship in bf16 over
   ``data_seq_model_mesh(2, 2, 2)`` with Ulysses (8 ranks: 4 rows a
   replica, 1,024 columns a seq rank, 8 heads a model rank, 4 a Ulysses
   rank): K4's forward and backward once a layer a step (the 8 ranks in one
   launch) and K1 once a step (the replicated gradient class), one step's
   loss and full-shape gradients against the 1 x 1 trainer's from the same
   weights and batch, a 16-step chain whose loss falls, ms a step (median of
   3), peak memory and two steps under ``torch.profiler``; ``bench-mfu --dp
   2 --sp 2`` (ring attention, its blocks plain einsums: no K4; K1 once a
   step), its record with the peak memory printed, MFU on the one card;
   ``train-lm``'s width (d 128, 4 heads, 2 layers, T 256) in f32 by SGD:
   ring and Ulysses on ``data_seq_mesh(2, 2)``, ``data_seq_model_mesh(2, 2,
   2)`` with an f32, a bf16 and an int8 wire and overlapped, each three
   steps on the card against the CPU (replica row 1 masked at the second)
   and, every row valid, against the 1 x 1 trainer on the card; then
   ``train-lm --dp 2 --sp 2 --tp 2 --impl ulysses --compress bf16``,
   ``train-lm --dp 2 --sp 4 --overlap`` (falling losses) and
   ``elastic-demo --family lc`` (8 ranks, dp 2 x sp 4 -> dp 3 x sp 2 ->
   dp 2 x sp 4); callable alone as ``chip_smoke.sharded_lm_path(dev,
   card_info(dev))`` after ``_build.build("local_reduce",
   "flash_attention_wgmma", "flash_attention_bwd_wgmma")``; (o) sharded
   decode: ``LMGenerator`` over (model,) tp 2, (seq,) sp 4 and (seq,
   model) 2 x 2 at the flagship in bf16 (B 8, a 2048-token prompt), each
   with the bf16 and the int8 cache: the prefill and 8 teacher-forced
   tokens, every rank's logits equal and within 2e-2 (seq meshes) or
   1.6e-2 (tp 2) of max|logit| of the unsharded generator's, K4's forward
   once a layer at the TP-only prefill (both ranks in one launch) and
   nowhere else, ms a token (the slope between 4 and 16 tokens), prefill
   ms, a rank's cache bytes and the peak memory beside the unsharded
   generator's; in f32 the teacher-forced logits within 1e-5 (tp 2) or
   2e-5 (seq meshes) of max|logit|, 1e-2 with the int8 cache, and the
   greedy tokens of every mesh and cache equal to the unsharded
   generator's; a control with one rank's cache zeroed after the prefill
   (tp 2, sp 4; each precision and cache) outside those limits;
   ``lm-generate --sp 2 --tp 2`` with each cache; (p) MoE over virtual
   ranks at the bench width (8 experts top-1, scatter, bf16, B 8 x T
   2048): one step over (data, expert) = (2, 4) and one over (data, seq,
   expert) = (1, 2, 4) with Ulysses against the one-rank step at 2 of the
   8 layers, capacity factor 8.0 (nothing dropped) and the aux loss out of
   the gradient (the loss within 2e-4 relative, each gradient within 5e-2
   of its max|grad|), K4's forward and backward once a layer a step for
   all ranks and K1 once a step; the full depth at capacity 1.25 over (2,
   4): a 16-step chain whose loss falls, ms a step, peak memory, two steps
   under ``torch.profiler``; train-moe's width over (2, 2, 2) on the card
   against the CPU with the bf16 wire and overlapped; ``train-moe --dp 2
   --ep 2 --sp 2 --compress bf16`` and ``--overlap``; ``elastic-demo
   --family moe`` over 8 ranks (dp 2 x ep 4 -> dp 3 x ep 2 -> dp 2 x ep 4);
5. timings: K1 and K2 at K = 16 x 64M, K3 in each mode at 8 x 25M (padded to
   whole buckets), K4 at the flagship shape in bf16 and in f32 at B 2, each
   by CUDA events, beside its plain version, the nearest PyTorch library
   call (``scaled_dot_product_attention`` for K4, timed only) and the bound
   (f32: split TF32's rate, with the share of the f32-FMA bound printed
   beside it); K4's backward at the same shapes, beside the plain backward,
   SDPA's backward (its forward + backward minus its forward) and the bound
   of its five products; one flagship bf16 forward, for K4's share of it; one
   prefill and 8 decode steps under ``torch.profiler`` (device busy share,
   top kernels); the flagship bf16 training step (median of 5, host clock
   ended by a synchronize; K4's forward + backward share of it) and two
   steps under ``torch.profiler``; and ``bench-mfu``'s record (slope-timed
   MFU of the same step); the flagship-width f32 training step at B 2
   (median of 5, host clock; K4's forward's and backward's shares of it
   from their CUDA-event times) and two such steps under ``torch.profiler``
   (device busy share, top kernels, K4's kernels); the DP step at
   ``MLP(2048, 2048)`` (median of 5, host clock ended by a synchronize),
   K1 by CUDA events on its ``(8, 5824522)`` stack beside its plain
   version, ``torch.mv`` and its bound, K1's share of the step, and two
   steps under ``torch.profiler``; the same for the ResNet-50 step, with K1
   on its ``(8, 25557032)`` stack and ``bench-mfu --workload resnet``'s
   ms/step and MFU; at both widths the overlapped step's time and K1 once a
   leaf against its one fused launch;
6. one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, ...}`` line.

Kernel and plain version are compared with rtol = atol = 1e-6 (the JAX
package's tolerance); the kernels avoid FMA contraction, so the error is
expected to be exactly 0, and K1, K2 and K3 (f32, bf16 and int8) are held to
bit equality. K4 sums in another order than its plain version (dense products)
and in bf16 rounds P to bf16 for the PV product: f32 is held to
rtol = atol = 1e-4, bf16 to rtol = atol = 2e-2. K4's backward (which in
bf16 also rounds P and dS to bf16 before their products) is held to 1e-4
(f32) and 2e-2 (bf16) of the plain version's max|grad|, its lse within 1e-4,
and the whole model's f32 gradient to 1e-4 of each tensor's max|grad|. The
LM's f32 forward and its decode-path oracle must agree within 1e-4 x
max|logit|.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import sys
import time

SEED = 0
K_WORKERS = 16
DATA = 64 * 1024 * 1024  # floats per worker: BASELINE config 2's buffer
ALPHA = 0.125
ROUNDS = 3
RTOL = ATOL = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# f32-accurate products on the tensor cores in split TF32: three TF32
# products each at the H100 SXM's dense TF32 rate
TF32X3_OPS_PER_S = 494.7e12 / 3
BF16_OPS_PER_S = 989.4e12  # H100 SXM dense bf16 on the tensor cores
RING_RANKS = 8
RING_FLOATS = 25_000_000  # BASELINE config 4: ResNet-50's gradient buffer
RING_MODES = (None, "bf16", "int8")
# the flagship LM (the JAX package's bench_mfu.py defaults): 404M parameters
LM = dict(vocab=256, d_model=2048, n_heads=16, n_layers=8)
LM_BATCH, LM_SEQ, LM_GEN, LM_GREEDY_CHECK = 8, 2048, 32, 8
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4  # relative to max|logit|
# K4's backward, relative to max|grad|; the whole model's f32 gradient with
# the kernels against the plain attention, relative to each tensor's max|grad|
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_GRAD_TOL = 1e-4
TRAIN_STEPS = 3  # flagship training steps on the main path
TRAIN_LM = dict(vocab=64, d_model=128, n_heads=4, n_layers=2)  # lm-generate --train-steps
TRAIN_LM_SEQ, TRAIN_LM_STEPS = 1024, 40
# the DP trainer at bench-mfu --workload mlp's width: 5,824,522 parameters
DP_RANKS, DP_HIDDEN, DP_ROWS, DP_STEPS = 8, (2048, 2048), 16, 20
DP_PARAMS = 784 * 2048 + 2048 + 2048 * 2048 + 2048 + 2048 * 10 + 10
# a masked rank's bf16 EF row against every other's norm (the JAX package's
# band, tests/test_train.py); under overlap, tests/test_overlap.py's
EF_BF16_RATIO = 50.0
EF_OVERLAP_RATIO = 10.0
DP_LEAVES = 6  # MLP(2048, 2048): three kernels and three biases
# ResNet-50 (BASELINE config 4) over the same ranks: 64 px imagenet_like
# images, 2 rows a rank; train-resnet's default model has 10 classes
RESNET_CLASSES, RESNET_SIZE, RESNET_ROWS, RESNET_STEPS = 1000, 64, 2, 3
RESNET_PARAMS, RESNET10_PARAMS, RESNET_LEAVES = 25_557_032, 23_528_522, 161
RESNET_LR = 0.01  # at 0.1 the third step on one batch diverges (7.8, 3.1, 38.8)
# the host engine (phase h): BASELINE config 1 (4 workers x 1M floats, chunk
# 262,144, thresholds 1.0, 30 rounds), ResNet-50's gradient at the same chunk,
# the host tier of config 5 (200,000 floats, chunk 16,384, thresholds 0.75,
# 10 rounds, worker 3's messages lost), the 2-D butterfly and the elastic
# binder (alpha 0.5), each against the same run on the CPU
ENGINE_FLOATS, ENGINE_CHUNK, ENGINE_ROUNDS, ENGINE_BIG_ROUNDS = 1_000_000, 262_144, 30, 5
DROPOUT_FLOATS, DROPOUT_CHUNK, DROPOUT_ROUNDS = 200_000, 16_384, 10
BUTTERFLY_ROUNDS, ELASTIC_ROUNDS, ELASTIC_ALPHA, ELASTIC_RTOL = 5, 5, 0.5, 1e-6
# checkpoints (phase i): ZeRO-1 at the JAX bench-checkpoint --trainer zero1
# width, MLP(hidden=(2048,) * 8) over 8 virtual ranks, Adam 1e-3; steps between
# a save and the comparison of a resume; the LM's resumes and bench-checkpoint
# at the flagship's width cut to 1 of its 8 layers (0.62 GB of state a store
# instead of 4.85: the script's time limit), their batch and baseline steps;
# the disk the LM stores need (a sync and an async store at once, and room)
ZERO1_HIDDEN, ZERO1_PARAMS, ZERO1_ROWS, ZERO1_STEPS = (2048,) * 8, 31_002_634, 16, 3
CKPT_LM = dict(LM, n_layers=1)
CKPT_STEPS_AFTER, CKPT_LM_BATCH, CKPT_BENCH_BASELINE, CKPT_FREE_BYTES = 2, 2, 5, 4e9
MASK3 = [1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0]  # rank 3 masked
# the TCP control plane (phase j): BASELINE config 1 between 4 node processes
# (1M floats, chunk 262,144, thresholds 1.0, 8 rounds; cut from 20) on the
# card and on the CPU, and ResNet-50's gradient over three payload streams for
# 1 round (cut from 3) in f32 and f16, the four clusters run at once (each on
# its own ports; cut from one after another). The standby takeover runs in
# phase (l)'s chaos-failover (cut from a run of its own here)
CLUSTER_NODES, CLUSTER_FLOATS, CLUSTER_CHUNK, CLUSTER_ROUNDS = 4, 1_000_000, 262_144, 8
CLUSTER_BIG_ROUNDS = 1
# elasticity (phase k): the DP cell's width over 4 nodes x 2 virtual ranks, the
# node that drops, the re-mesh cycles of the leak check and the bytes they may
# leave allocated, the training cluster's step budgets (long enough that both
# learners are still stepping when the rounds start), the CPU run's tolerance
ELASTIC_NODES, ELASTIC_PER_NODE, ELASTIC_LOST = 4, 2, 3
LEAK_CYCLES, LEAK_BYTES = 5, 1 << 20
CLUSTER_TRAIN_STEPS = {"mlp": 1000, "lm": 500}
STEP_TOL_KW = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_dp.py's STEP_TOL
# chaos (phase l): the elastic trainer's steps under the seeded membership
# schedule (over ELASTIC_NODES nodes); the host engine under a spec that
# drops, duplicates, reorders and corrupts (config 1's size, thresholds 0.75);
# chaos-scale's pod, cut from the JAX Makefile's 2x8 grid in 4 shards to 2x4
# in 2 so that the script stays inside its time limit on a slower host
# (every node process pays for its interpreter, torch and a CUDA context)
CHAOS_STEPS = 24
CHAOS_LOCAL_SPEC = "drop:p=0.02;duplicate:p=0.05;reorder:p=0.05;corrupt:p=0.05"
CHAOS_LOCAL_SEED, CHAOS_LOCAL_CHUNK, CHAOS_LOCAL_ROUNDS = 0, 262_144, 10
CHAOS_SCALE_GRID, CHAOS_SCALE_SHARDS = "2x4", 2
# the drills' depth, cut for the time limit: chaos-train's crash at round 12
# and 10 rounds after it (JAX defaults 30 and 25), the chaos drill's 20
# rounds (50), chaos-recover's and chaos-failover's 10 rounds after the
# restore (40; their crash stays at round 25: at round 8 chaos-failover's
# respawned node found no complete replica of its checkpoint to restore from)
CHAOS_TRAIN_DEPTH = ("--kill-at-round", "12", "--post-rounds", "10")
CHAOS_ROUNDS = 20
CHAOS_RESTORE_DEPTH = ("--min-post-rounds", "10")
DRILL_WIDTH = 4  # drills running at once
# the int8 KV cache and MoE (phase m): the serving cell is the flagship's; the
# MoE cell is bench-mfu --workload moe's defaults (8 experts, top-1, capacity
# factor 1.25, auto -> scatter, bf16, 2.28B parameters), its chain long enough
# to see the loss fall (Adam at the bench's lr 1e-3 first lifts it: 6.02 ->
# 9.93 by the third step, back to 6.13 by the seventh); the small card-vs-CPU
# width keeps attention dense (T 256) so that routing decisions see the same
# logits to ~1e-6 on both sides, and steps by SGD (the Adam hazard: a first
# Adam step is nearly a sign step)
MOE = dict(vocab=256, d_model=2048, n_heads=16, n_layers=8, n_experts=8, seq_len=2048)
MOE_BATCH, MOE_CHAIN = 8, 20
MOE_SMALL = dict(vocab=64, d_model=128, n_heads=4, n_layers=2, n_experts=4, seq_len=256)
MOE_SMALL_BATCH, MOE_SMALL_STEPS, MOE_SMALL_TOL = 8, 3, 1e-4  # relative
# sequence and tensor parallelism (phase n): (n1) the flagship over
# data_seq_model_mesh(2, 2, 2) with Ulysses at bench-mfu's lr (8 virtual
# ranks: 4 rows a replica, 1,024 columns a seq rank, 8 heads a model rank, 4 a
# Ulysses rank), one step against the 1 x 1 trainer's from the same weights
# and batch (bf16: the loss relative, each leaf's gradient of its max|grad|),
# a chain whose loss falls; (n3) train-lm's defaults in f32 by SGD (the Adam
# hazard), each mesh three steps (the second with replica row 1 masked) on the
# card against the CPU and, all rows valid, against the 1 x 1 trainer on the
# card; bf16 and int8 wires held to tests/test_compress_sharded.py's bands
SHARDED_MESH, SHARDED_CHAIN = (2, 2, 2), 16
# measured on an H100 (PERF.md, PR 18): loss 1.93e-5 relative, gradients
# 2.28e-2 of max|grad| (bf16 partial sums rounded before the TP psum)
SHARDED_LOSS_TOL, SHARDED_GRAD_TOL = 2e-4, 5e-2
# sharded decode (phase o): the flagship in bf16 over each decode mesh of
# virtual ranks (the JAX tests' tp 2, sp 4 and seq x model 2 x 2), a
# 2048-token prompt then 8 teacher-forced tokens, the decode slope between 4
# and 16 tokens
DECODE_MESHES = {"tp2": ((2,), ("model",)), "sp4": ((4,), ("seq",)),
                 "sp2_tp2": ((2, 2), ("seq", "model"))}
DECODE_TF, DECODE_GEN = 8, 16
# the teacher-forced logits of a mesh against the unsharded generator's, of
# max|logit|, each limit set from an H100's readings (PERF.md). bf16, each
# cache: the seq meshes within FLASH_TOL's bf16 band (the int8 cache's decode
# check's; the seq merge changes the summation order; read 1.16e-2-1.55e-2),
# tp 2 within DECODE_TP_BF16_TOL: its heads reduce as on one device, and only
# each rank's partial out-projection and MLP sums are rounded to bf16 before
# the psum over model (read 1.16e-2 and 1.53e-2 with the int8 cache: one
# bf16 step of the largest logit). f32 with the f32 cache: tp 2 within
# DECODE_TP_F32_TOL (read 2.67e-6), the seq meshes within DECODE_SEQ_F32_TOL
# (3.21e-6-3.26e-6; K4's split TF32 at the unsharded prefill against the seq
# ranks' f32 partials); with the int8 cache every mesh within
# DECODE_INT8_F32_TOL (4.00e-3-4.72e-3: a K or V element that lands on the
# other side of an int8 rounding step moves by max|row|/127).
# DECODE_CONTROL_RANK: a control zeroes this rank's cache after the prefill
# (tp 2: half the heads; sp 4: a quarter of the slots) and must fail the
# limit of its mesh, precision and cache (read 0.20-0.69)
DECODE_TP_BF16_TOL, DECODE_TP_F32_TOL, DECODE_SEQ_F32_TOL = 1.6e-2, 1e-5, 2e-5
DECODE_INT8_F32_TOL = 1e-2
DECODE_CONTROL_RANK = 1
# MoE over virtual ranks (phase p): (p1) the bench width's one-rank step
# against (data, expert) = (2, 4) and (data, seq, expert) = (1, 2, 4) with
# Ulysses at capacity factor 8.0 (nothing drops: the JAX tests' oracle), its
# depth cut to 2 of 8 layers (at 8.0 the expert activations of 8 layers,
# 16,384 slots an expert, would not fit the card beside the one-rank trainer's
# state); (p2) the full depth at the bench's 1.25 over (2, 4), a chain long
# enough for Adam at 1e-3 to bring the loss down (phase m's note). The (p1)
# steps leave the aux loss out of the gradient (aux_coef 0): its Switch
# statistics are per rank, so its value depends on how the rows are split
# (the JAX tests hold a mesh against the dense mesh with the same row split;
# here the one-rank step has one row group), and the cross-entropy's gradient
# is what the all_to_all pair, the attention and the sums must give. (p3)
# train-moe's width (vocab 64, d 128, 4 heads, 2 layers, 4 experts, T 64)
MOE_MESHES = {"data2_expert4": ((2, 4), ("data", "expert"), "ring"),
              "data1_seq2_expert4": ((1, 2, 4), ("data", "seq", "expert"), "ulysses")}
MOE_ORACLE_LAYERS, MOE_ORACLE_CF, MOE_PAR_CHAIN = 2, 8.0, 16
MOE_TRAIN = dict(vocab=64, d_model=128, n_heads=4, n_layers=2, n_experts=4)
MOE_TRAIN_SEQ = 64
SMALL_LM = dict(vocab=64, d_model=128, n_heads=4, n_layers=2)
SMALL_LM_SEQ, SMALL_LM_BATCH, SMALL_LM_STEPS, SMALL_LM_LR = 256, 8, 3, 0.1
SMALL_LM_TOL = 1e-5  # card vs CPU and f32 meshes vs 1 x 1: losses relative, params of max
# card vs CPU on a compressed wire: an element whose sum lands apart by float
# dust may round to the next bf16 value or int8 quantum on one side only
WIRE_CARD_TOL = 1e-3
WIRE_BANDS = {"bf16": (5e-3, 1e-2), "int8": (5e-2, 0.1)}  # loss relative, drift of max
# quantized_cache_attention on the card vs the CPU, of max|out|, with decode's
# bf16 q: f32 scores and sums on both sides, the output rounded to bf16, so
# an element may round one bf16 ulp apart (at most 2^-7 of its magnitude)
QCA_TOL = 2.0 ** -7


def ring_name(mode: str | None) -> str:
    """The kernels line's name of K3 in one compress mode."""
    return f"ring_allreduce_{mode or 'f32'}"


SOURCE = {
    "masked_average": "akka_allreduce_tpu_torch/ops/csrc/local_reduce.cu",
    "elastic_average_step": "akka_allreduce_tpu_torch/ops/csrc/local_reduce.cu",
    **{ring_name(m): "akka_allreduce_tpu_torch/ops/csrc/ring.cu" for m in RING_MODES},
    "flash_attention_bf16": "akka_allreduce_tpu_torch/ops/csrc/flash_attention_wgmma.cu",
    "flash_attention_f32": "akka_allreduce_tpu_torch/ops/csrc/flash_attention_3xtf32.cu",
    "flash_attention_bwd_bf16": "akka_allreduce_tpu_torch/ops/csrc/flash_attention_bwd_wgmma.cu",
    "flash_attention_bwd_f32": "akka_allreduce_tpu_torch/ops/csrc/flash_attention_bwd_3xtf32.cu",
}
REPLACES = {
    "masked_average": "akka_allreduce_tpu/ops/local_reduce.py:79",
    "elastic_average_step": "akka_allreduce_tpu/ops/local_reduce.py:142",
    **{ring_name(m): "akka_allreduce_tpu/ops/ring.py:264" for m in RING_MODES},
    # the flash branch of local_attention (the library Pallas kernel)
    "flash_attention_bf16": "akka_allreduce_tpu/ops/local_attention.py:378",
    "flash_attention_f32": "akka_allreduce_tpu/ops/local_attention.py:378",
    # the library kernel's custom VJP, run through the call at :395
    # (_flash_attention_bwd_dkv and _flash_attention_bwd_dq)
    "flash_attention_bwd_bf16": "akka_allreduce_tpu/ops/local_attention.py:395",
    "flash_attention_bwd_f32": "akka_allreduce_tpu/ops/local_attention.py:395",
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def zero(counts: dict) -> None:
    """Set every launch counter of a kernel module to 0."""
    for key in counts:
        counts[key] = 0


def phase(label: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": label, "s": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def flash_name(dtype) -> str:
    """The kernels line's name of K4 in one dtype."""
    return "flash_attention_" + ("bf16" if str(dtype).endswith("bfloat16") else "f32")


def check_flash(dev, gen) -> tuple[dict, float, float]:
    """K4 against its plain version at every listed shape; returns the error
    at each dtype's flagship shape, the largest error elsewhere and the
    largest lse error. Every shape must go through the kernel
    ``forward_kernel`` names for its dtype, and its lse must be within 1e-4
    of the plain version's; each flagship must repeat bit for bit."""
    import torch

    from akka_allreduce_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    b, t, h, d = LM_BATCH, LM_SEQ, LM["n_heads"], LM["d_model"] // LM["n_heads"]
    flagship = {bf16: (b, t, h, h, d, True), f32: (2, t, h, h, d, True)}
    shapes = [(dt, shape) for dt, shape in flagship.items()]
    shapes += [(bf16, (2, t, h, h, d, False)), (f32, (2, 1024, 4, 4, d, False))]
    for dt in (bf16, f32):
        shapes += [(dt, (2, 1024, 4, 4, hd, True)) for hd in (32, 64, 96, 128, 256)]
        shapes += [(dt, (1, tt, 4, 4, 128, True)) for tt in (1024, 1536, 4096)]
        shapes += [(dt, (2, t, h, 4, d, True)), (dt, (1, 1024, 8, 1, 64, True))]
    # T a multiple of 64 but not of 128: the Hopper kernels' ragged blocks
    shapes += [(dt, (1, tt, 8, hkv, hd, causal)) for dt in (bf16, f32) for tt in (576, 1088)
               for hkv, hd in ((4, 128), (1, 64), (1, 256)) for causal in (True, False)]
    err, other, lse_err = {}, 0.0, 0.0
    for dt, (bb, tt, hh, hkv, hd, causal) in shapes:
        q = torch.randn((bb, tt, hh, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((bb, tt, hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((bb, tt, hkv, hd), generator=gen, device=dev).to(dt)
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention(q, k, v, causal=causal)
        want, want_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                      return_lse=True)
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        what = f"flash {dt} B{bb} T{tt} H{hh}/{hkv} D{hd} causal={causal}"
        require(all(fa.LAUNCHES[n] == before[n] + (n == fa.forward_kernel(dt))
                    for n in ("flash_attention_wgmma", "flash_attention_3xtf32")),
                f"{what}: the kernel forward_kernel names was launched")
        require(got.shape == want.shape and got.dtype == dt, f"{what}: shape/dtype")
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        e = float((got.float() - want.float()).abs().max())
        require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                f"{what}: max abs err {e}")
        _, lse = fa._forward(q, k, v, causal, hd ** -0.5)
        e_lse = float((lse - want_lse).abs().max())
        require(e_lse <= 1e-4, f"{what}: lse max abs err {e_lse}")
        lse_err = max(lse_err, e_lse)
        if (bb, tt, hh, hkv, hd, causal) == flagship[dt]:
            err[flash_name(dt)] = e
            again = fa.flash_attention(q, k, v, causal=causal)
            require(torch.equal(got, again), f"{what}: a repeat differs")
            del again
        else:
            other = max(other, e)
        del q, k, v, got, want, want_lse
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err, other, lse_err


def check_flash_bwd(dev, gen) -> dict:
    """K4's backward (dq, dk, dv) and the forward's lse against the plain
    versions at every listed shape, each backward launched twice and held to
    bit equality; then the autograd path through ``local_attention`` at a
    gated shape. Returns the errors (relative to max|grad|) at each dtype's
    flagship shape and the largest elsewhere."""
    import torch

    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_attention as la

    bf16, f32 = torch.bfloat16, torch.float32
    b, t, h, d = LM_BATCH, LM_SEQ, LM["n_heads"], LM["d_model"] // LM["n_heads"]
    flagship = {bf16: (b, t, h, h, d, True), f32: (2, t, h, h, d, True)}
    shapes = [(dt, shape) for dt, shape in flagship.items()]
    shapes += [(bf16, (2, t, h, h, d, False)), (f32, (2, 1024, 4, 4, d, False))]
    for dt in (bf16, f32):
        shapes += [(dt, (2, 1024, 4, 4, hd, True)) for hd in (32, 64, 128, 256)]
        shapes += [(dt, (1, tt, 4, 4, 128, True)) for tt in (1024, 4096)]
        shapes += [(dt, (2, t, h, 4, d, True)), (dt, (1, 1024, h, 1, 64, True))]
    # T a multiple of 64 but not of 128: the Hopper kernels' ragged key blocks
    shapes += [(dt, (1, tt, 8, hkv, hd, causal)) for dt in (bf16, f32) for tt in (576, 1088)
               for hkv, hd in ((4, 128), (1, 64), (1, 256)) for causal in (True, False)]

    def rel(got, want) -> float:
        return float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)

    err, other, lse_err = {}, 0.0, 0.0
    for dt, (bb, tt, hh, hkv, hd, causal) in shapes:
        q = torch.randn((bb, tt, hh, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((bb, tt, hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((bb, tt, hkv, hd), generator=gen, device=dev).to(dt)
        do = torch.randn((bb, tt, hh, hd), generator=gen, device=dev).to(dt)
        tol = BWD_TOL[str(dt).split(".")[-1]]
        what = f"flash bwd {dt} B{bb} T{tt} H{hh}/{hkv} D{hd} causal={causal}"
        o, lse = fa._forward(q, k, v, causal, hd ** -0.5)
        _, want_lse = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
        e_lse = float((lse - want_lse).abs().max())
        require(e_lse <= 1e-4, f"{what}: lse max abs err {e_lse}")
        lse_err = max(lse_err, e_lse)
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        require(all(fa.LAUNCHES[n] == before[n] + 2 * (n == fa.backward_kernel(dt))
                    for n in ("flash_attention_bwd_wgmma", "flash_attention_bwd_3xtf32")),
                f"{what}: the kernels backward_kernel names were launched")
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        e = 0.0
        for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            require(g.shape == w.shape and g.dtype == dt, f"{what}: {name} shape/dtype")
            require(bool(torch.isfinite(g).all()), f"{what}: {name} non-finite")
            require(torch.equal(g, g2), f"{what}: {name} differs between two launches")
            e = max(e, rel(g, w))
        require(e <= tol, f"{what}: max err {e} of max|grad|")
        if (bb, tt, hh, hkv, hd, causal) == flagship[dt]:
            err["flash_attention_bwd_" + ("bf16" if dt == bf16 else "f32")] = e
        else:
            other = max(other, e)
        del q, k, v, do, o, lse, want_lse, got, again, want
        torch.cuda.empty_cache()

    # fault 1's repair: gradients through local_attention at a gated shape
    autograd_err = {}
    for dt in (bf16, f32):
        q, k, v, do = (torch.randn((2, 1024, 4, 64), generator=gen, device=dev).to(dt)
                       for _ in range(4))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = dict(fa.LAUNCHES)
        la.local_attention(*leaves, causal=True).backward(do)
        require(all(fa.LAUNCHES[n] == before[n] + (n in ("flash_attention_bwd",
                                                         fa.backward_kernel(dt)))
                    for n in ("flash_attention_bwd", "flash_attention_bwd_wgmma",
                              "flash_attention_bwd_3xtf32")),
                "local_attention's backward launched K4's backward")
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        fa.flash_attention_reference(*plain, causal=True).backward(do)
        e = max(rel(a.grad, b_.grad) for a, b_ in zip(leaves, plain))
        require(e <= BWD_TOL[str(dt).split(".")[-1]], f"autograd {dt}: err {e}")
        autograd_err[str(dt).split(".")[-1]] = e
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"err": err, "other": other, "lse_max_abs_err": lse_err,
            "autograd_err": autograd_err}


def ptxas_report(lib_name: str, log: str) -> dict:
    """Per kernel of one K4 source with a ``_smem`` entry (``fwd<D>`` of the
    f32 forward; ``dq<D>``, ``dkv<D>`` of a backward): ptxas's registers and
    spill bytes from the build log, and the dynamic shared memory one CTA
    takes (from the library's own tile set)."""
    import ctypes

    from akka_allreduce_tpu_torch.ops import _build

    smem = getattr(_build.load(lib_name), f"akka_{lib_name}_smem")
    bwd = "_bwd_" in lib_name
    smem.argtypes = [ctypes.c_int64, ctypes.c_int] if bwd else [ctypes.c_int64]
    smem.restype = ctypes.c_int
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"flash_(?:bwd_(dq|dkv)|fwd_3xtf32)_kernelILi(\d+)E", ln)
        if "Compiling entry" in ln and m:
            kind, d = m.group(1) or "fwd", int(m.group(2))
            cur = f"{kind}<{d}>"
            out[cur] = {"smem": smem(d, int(kind == "dkv")) if bwd else smem(d)}
        elif cur and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[cur].update(spill_stores=int(st), spill_loads=int(ld))
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def lm_main_path(dev) -> dict:
    """The LM's serving path at the flagship width; returns K4's launches per
    dtype, the figures of each part and the bf16 model and tokens (kept for
    the forward's timing)."""
    import contextlib
    import io

    import torch

    from akka_allreduce_tpu_torch.__main__ import main as cli_main
    from akka_allreduce_tpu_torch.models import LMGenerator, SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.ops import flash_attention as fa

    count = fa.LAUNCHES
    x, _ = next(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED).batches(LM_BATCH, 1))
    tokens = torch.from_numpy(x).to(dev)
    n_layers = LM["n_layers"]

    # (a) the flagship forward in bf16: K4 once a layer
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, seed=SEED, device=dev)
    zero(count)
    with torch.no_grad():
        logits16 = model(tokens)
    torch.cuda.synchronize()
    launches_a = count["flash_attention_wgmma"]
    require(launches_a == count["flash_attention"] == n_layers,
            f"bf16 forward: K4 launches {count}")
    require(logits16.shape == (LM_BATCH, LM_SEQ, LM["vocab"])
            and logits16.dtype == torch.float32, "bf16 logits shape")
    require(bool(torch.isfinite(logits16).all()), "bf16 logits finite")

    # (b) f32: the forward (K4) against the decode path in 256-token chunks
    model32 = TransformerLM(**LM, compute_dtype=torch.float32, seed=SEED, device=dev)
    zero(count)
    with torch.no_grad():
        logits32 = model32(tokens)
    torch.cuda.synchronize()
    launches_b = count["flash_attention_3xtf32"]
    require(launches_b == count["flash_attention"] == n_layers
            and count["flash_attention_wgmma"] == 0, f"f32 forward: K4 launches {count}")
    gen = LMGenerator(model32, max_len=LM_SEQ + LM_GEN)
    oracle = gen.decode_logits(tokens, chunk=256)
    torch.cuda.synchronize()
    require(count["flash_attention"] == n_layers, "decode_logits(chunk=256) ran no K4")
    scale = float(logits32.abs().max())
    oracle_err = float((logits32 - oracle).abs().max())
    require(bool(torch.isfinite(logits32).all()) and oracle_err <= LOGIT_TOL * scale,
            f"f32 forward vs decode_logits: {oracle_err} of max|logit| {scale}")
    bf16_vs_f32 = float((logits16 - logits32).abs().max())
    del oracle, logits16

    # (c) generation in f32: K4 at prefill; greedy tokens vs a naive re-forward
    zero(count)
    out = gen.generate(tokens, LM_GEN)
    torch.cuda.synchronize()
    launches_c = count["flash_attention_3xtf32"]
    require(launches_c == count["flash_attention"] == n_layers
            and count["flash_attention_wgmma"] == 0, f"generate: prefill K4 launches {count}")
    require(out.shape == (LM_BATCH, LM_GEN), "generated tokens shape")
    seq = tokens
    with torch.no_grad():
        for _ in range(LM_GREEDY_CHECK):
            nxt = torch.argmax(model32(seq)[:, -1], dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    naive = seq[:, LM_SEQ:].to(torch.int32)
    require(torch.equal(out[:, :LM_GREEDY_CHECK], naive),
            f"greedy tokens vs naive re-forward: {out[:, :LM_GREEDY_CHECK].tolist()} "
            f"vs {naive.tolist()}")
    del model32, gen, logits32, seq
    torch.cuda.empty_cache()

    # (d) the lm-generate command at the flagship width in bf16
    zero(count)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([
            "lm-generate", "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
            "--heads", str(LM["n_heads"]), "--layers", str(n_layers),
            "--batch", str(LM_BATCH), "--prompt-len", str(LM_SEQ),
            "--gen", str(LM_GEN), "--bf16",
        ])
    torch.cuda.synchronize()
    launches_d = count["flash_attention_wgmma"]
    lines = buf.getvalue().strip().splitlines()
    print("\n".join(ln for ln in lines if not ln.startswith(("prompt", "decoded"))),
          flush=True)
    record = json.loads(lines[-1])
    require(rc == 0 and launches_d > 0 and launches_d == count["flash_attention"],
            f"lm-generate: rc {rc}, K4 launches {count}")
    require(record["prefill_ms"] > 0 and record["ms_per_token"] > 0,
            f"lm-generate record {record}")
    torch.cuda.empty_cache()
    return {
        "launches": {"flash_attention_bf16": launches_a + launches_d,
                     "flash_attention_f32": launches_b + launches_c},
        "per_part": {"a_forward_bf16": launches_a, "b_forward_f32": launches_b,
                     "c_generate_f32": launches_c, "d_lm_generate_bf16": launches_d},
        "oracle_err": oracle_err,
        "max_abs_logit": scale,
        "bf16_vs_f32_logits": bf16_vs_f32,
        "greedy": out[0, :LM_GREEDY_CHECK].tolist(),
        "record": record,
        "model": model,
        "tokens": tokens,
    }


def lm_train_path(dev) -> dict:
    """The LM's training path: (a) the flagship in bf16 through
    ``LongContextTrainer.train_step`` (K4 forward and backward once a layer
    each step), then a ``valid=[0]`` step; (b) the whole model's f32
    gradient with the kernels against the plain attention (2 layers, B 2,
    T 2048); (c) ``lm-generate --train-steps`` at a small gated width.
    Returns the launches per dtype and the figures of each part."""
    import contextlib
    import io
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch.__main__ import main as cli_main
    from akka_allreduce_tpu_torch.models import SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_attention as la
    from akka_allreduce_tpu_torch.train import LongContextTrainer

    count = fa.LAUNCHES
    n_layers = LM["n_layers"]

    # (a) the flagship in bf16
    trainer = LongContextTrainer(**LM, seq_len=LM_SEQ, compute_dtype=torch.bfloat16,
                                 learning_rate=1e-3, seed=SEED, device=dev)
    batches = list(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED).batches(
        LM_BATCH, TRAIN_STEPS + 1))
    zero(count)
    losses = []
    for x, y in batches[:TRAIN_STEPS]:
        m = trainer.train_step(x, y)
        require(math.isfinite(m.loss) and m.contributors == 1.0, f"flagship step {m}")
        losses.append(m.loss)
    torch.cuda.synchronize()
    launches_a = dict(count)
    require(launches_a == {"flash_attention": n_layers * TRAIN_STEPS,
                           "flash_attention_wgmma": n_layers * TRAIN_STEPS,
                           "flash_attention_3xtf32": 0,
                           "flash_attention_bwd": n_layers * TRAIN_STEPS,
                           "flash_attention_bwd_wgmma": n_layers * TRAIN_STEPS,
                           "flash_attention_bwd_3xtf32": 0},
            f"flagship steps: launches {launches_a}")
    dropped = trainer.train_step(*batches[TRAIN_STEPS], valid=[0.0])
    require(dropped.loss == 0.0 and dropped.contributors == 0.0,
            f"valid=[0] step {dropped}")
    launches_a = dict(count)
    del trainer
    torch.cuda.empty_cache()

    # (b) the f32 gradient of 2 layers at B 2 x T 2048, kernels vs plain
    model = TransformerLM(**{**LM, "n_layers": 2}, seed=SEED, device=dev)
    x, y = (torch.from_numpy(a).to(dev).long() for a in batches[0])
    x, y = x[:2], y[:2]

    def grads():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x).reshape(-1, LM["vocab"]), y.reshape(-1)).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    zero(count)
    got = grads()
    torch.cuda.synchronize()
    launches_b = dict(count)
    require(launches_b == {"flash_attention": 2, "flash_attention_wgmma": 0,
                           "flash_attention_3xtf32": 2, "flash_attention_bwd": 2,
                           "flash_attention_bwd_wgmma": 0, "flash_attention_bwd_3xtf32": 2},
            f"f32 gradient: launches {launches_b}")
    with mock.patch.object(la, "flash_attention", lambda q, k, v, causal, sm_scale:
                           fa.flash_attention_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale)):
        want = grads()
    require(dict(count) == launches_b, "the plain-attention gradient launched a kernel")
    grad_err = 0.0
    for name in want:
        e = float((got[name] - want[name]).abs().max()) / max(
            float(want[name].abs().max()), 1e-30)
        require(e <= MODEL_GRAD_TOL, f"f32 model gradient {name}: err {e} of max|grad|")
        grad_err = max(grad_err, e)
    del model, got, want
    torch.cuda.empty_cache()

    # (c) lm-generate --train-steps at a small gated width (f32)
    zero(count)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([
            "lm-generate", "--vocab", str(TRAIN_LM["vocab"]),
            "--d-model", str(TRAIN_LM["d_model"]), "--heads", str(TRAIN_LM["n_heads"]),
            "--layers", str(TRAIN_LM["n_layers"]), "--batch", "8",
            "--train-steps", str(TRAIN_LM_STEPS), "--seq-len", str(TRAIN_LM_SEQ),
            "--prompt-len", str(TRAIN_LM_SEQ // 2 + 1), "--gen", "16",
        ])
    torch.cuda.synchronize()
    launches_c = dict(count)
    lines = buf.getvalue().strip().splitlines()
    trained = next(ln for ln in lines if ln.startswith("trained "))
    first, last = (float(s) for s in trained.split("loss ")[1].split(" -> "))
    accuracy = next(ln for ln in lines if ln.startswith("copy accuracy"))
    print(trained + "; " + accuracy, flush=True)
    require(rc == 0 and last < first, f"lm-generate --train-steps: rc {rc}, {trained}")
    want_c = TRAIN_LM["n_layers"] * TRAIN_LM_STEPS
    require(launches_c["flash_attention"] >= want_c
            and launches_c["flash_attention_3xtf32"] == launches_c["flash_attention"]
            and launches_c["flash_attention_bwd"] == want_c
            and launches_c["flash_attention_bwd_3xtf32"] == want_c
            and launches_c["flash_attention_wgmma"] == 0
            and launches_c["flash_attention_bwd_wgmma"] == 0,
            f"lm-generate --train-steps: launches {launches_c}")
    torch.cuda.empty_cache()
    return {
        "launches": {
            "flash_attention_bf16": launches_a["flash_attention_wgmma"],
            "flash_attention_f32": (launches_b["flash_attention_3xtf32"]
                                    + launches_c["flash_attention_3xtf32"]),
            "flash_attention_bwd_bf16": launches_a["flash_attention_bwd_wgmma"],
            "flash_attention_bwd_f32": (launches_b["flash_attention_bwd_3xtf32"]
                                        + launches_c["flash_attention_bwd_3xtf32"]),
        },
        "per_part": {"a_flagship_bf16": launches_a, "b_model_grad_f32": launches_b,
                     "c_lm_generate_train_f32": launches_c},
        "losses": losses,
        "model_grad_err": grad_err,
        "copy": {"loss_first": first, "loss_last": last, "line": accuracy},
    }


@contextlib.contextmanager
def watch_leaf_syncs(trainer):
    """Keep what the trainer's per-leaf syncs see in an overlapped step, in
    backward order: each leaf's ``(n, leaf)`` cotangent rows (a hook on the
    leaf's broadcast fires just before its sync), with EF its residual before
    the step and its view into ``_ef``; and each K1 output."""
    from akka_allreduce_tpu_torch.comm import allreduce as ar

    seen = {"ct": [], "e": [], "k1": []}
    sync, k1 = trainer._leaf_sync, ar.masked_average

    def watched(p, *args, **kw):
        out = sync(p, *args, **kw)
        # (p, e, v) with EF: keep the residual before the step, and its view
        e = (args[0].detach().clone(), args[0]) if len(args) == 2 else None

        def hook(g):
            seen["ct"].append(g.detach().reshape(g.shape[0], -1).clone())
            seen["e"].append(e)

        out.register_hook(hook)
        return out

    def k1_kept(x, valid):
        avg, cnt = k1(x, valid)
        seen["k1"].append(avg)
        return avg, cnt

    trainer._leaf_sync, ar.masked_average = watched, k1_kept
    try:
        yield seen
    finally:
        trainer._leaf_sync, ar.masked_average = sync, k1


def check_overlap_k1(seen: dict, valid, what: str) -> int:
    """Each leaf's K1 output against the matching slice of one fused K1
    average of all the leaves' cotangent rows, bit for bit (K1 is independent
    per column). Returns the leaves compared."""
    import torch

    from akka_allreduce_tpu_torch.ops import local_reduce as lr

    require(len(seen["k1"]) == len(seen["ct"]) > 0, f"{what}: a K1 output a leaf")
    whole, _ = lr.masked_average(torch.cat(seen["ct"], dim=1), valid)
    start = 0
    for ct, out in zip(seen["ct"], seen["k1"]):
        require(torch.equal(out.reshape(-1), whole[start:start + ct.shape[1]]),
                f"{what}: a leaf's K1 output differs from the fused average's slice")
        start += ct.shape[1]
    return len(seen["k1"])


def check_overlap_ef(seen: dict, v, compress: str, what: str) -> None:
    """Every leaf's new residual against its formula on the folded rows
    ``c = g + e``: ``c - bf16(c v)`` or ``ring_ef_residual(c, v, hop errors)``,
    bit for bit."""
    import torch

    from akka_allreduce_tpu_torch.comm.allreduce import ring_allreduce_sum, ring_ef_residual

    require(len(seen["e"]) == len(seen["ct"]) > 0, f"{what}: every leaf seen")
    for ct, (e0, view) in zip(seen["ct"], seen["e"]):
        c = ct + e0.reshape(ct.shape)
        if compress == "int8":
            _, hop = ring_allreduce_sum(c * v[:, None], compress="int8", return_residual=True)
            want = ring_ef_residual(c, v, hop)
        else:
            want = c - (c * v[:, None]).to(torch.bfloat16).float()
        require(torch.equal(view.reshape(c.shape), want), f"{what}: a leaf's residual")


def run_cli(argv: list[str]) -> tuple[int, str]:
    """The port's CLI in this process: (exit code, its standard output)."""
    from akka_allreduce_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def dp_train_path(dev) -> dict:
    """``DPTrainer`` on the MLP over virtual ranks: (a) bench-suite config 3,
    its K1 launches equal to its steps; (b) at bench-mfu's width
    (``MLP(hidden=(2048, 2048))``, ``line_mesh(8)``, 16 rows a rank, f32):
    K1 against its plain version on a step's gradient stack and the update
    from either average, bit for bit; then, counted, a step with every rank,
    one with rank 7 masked and 20 training steps, one K1 launch each; one
    step of each compressed sync (bf16, int8, and both with EF under a
    masked rank), none launching K1; (c) ``train_chain`` for 2 steps,
    ``train-mlp`` for 5 and the ``bench-mfu --workload mlp`` record.
    Returns the launches and figures of each part, with the trainer and a
    step's stack for the timings."""
    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import bench_suite
    from akka_allreduce_tpu_torch.comm.allreduce import ring_allreduce_sum, ring_ef_residual
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer, TrainStepMetrics

    count = lr.LAUNCHES
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def k1(n: int) -> int:
        """K1's launches for n f32 syncs (the CPU, in a rehearsal, launches none)."""
        return n if on_card else 0

    # (a) bench-suite config 3
    zero(count)
    rec3 = bench_suite.config3_mlp_step(device=dev)
    sync()
    print(json.dumps(rec3), flush=True)
    launches_a = dict(count)
    require(launches_a == {"masked_average": k1(rec3["steps_taken"]),
                           "elastic_average_step": 0},
            f"config 3: one K1 launch a step: {launches_a}, {rec3['steps_taken']} steps")
    require(rec3["loss_last"] < rec3["loss_first"] and math.isfinite(rec3["device_step_ms"])
            and rec3["path"] == ("k1_masked_average" if on_card else "plain_masked_average"),
            f"config 3 record {rec3}")

    # (b) the bench-mfu width
    mesh = line_mesh(DP_RANKS, device=dev)

    def trainer(**kw):
        return DPTrainer(MLP(hidden=DP_HIDDEN, seed=SEED, device=dev), mesh, **kw)

    def on_dev(x, y):
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev).long()

    batches = list(mnist_like(seed=SEED).batches(DP_RANKS * DP_ROWS, DP_STEPS + 2))
    masked7 = [1.0] * (DP_RANKS - 1) + [0.0]
    t = trainer()
    require(t.param_count == DP_PARAMS, f"MLP(2048, 2048) params {t.param_count}")
    stack, _ = t.rank_gradients(*on_dev(*batches[0]))
    require(stack.shape == (DP_RANKS, DP_PARAMS) and bool(torch.isfinite(stack).all()),
            f"gradient stack {tuple(stack.shape)}")
    p0 = t.get_flat_params()
    for bits in ([1.0] * DP_RANKS, masked7):
        v = torch.tensor(bits, device=dev)
        got, cnt = lr.masked_average(stack, v)
        want, want_cnt = lr.masked_average_reference(stack, v)
        require(torch.equal(got, want) and float(cnt) == float(want_cnt) == sum(bits),
                f"K1 on the step's stack, mask {bits}: max abs err "
                f"{float((got - want).abs().max())}")
        t.apply_gradients(want)
        p_plain = t.get_flat_params()
        t.set_flat_params(p0)
        t.apply_gradients(got)
        require(np.array_equal(t.get_flat_params(), p_plain),
                f"parameters after the update from K1's average, mask {bits}")
        t.set_flat_params(p0)
    del got, want
    sync()

    zero(count)
    m_all = t.train_step(*batches[0])
    m_7 = t.train_step(*batches[1], valid=masked7)
    require(m_all.contributors == DP_RANKS and m_7.contributors == DP_RANKS - 1,
            f"contributors {m_all.contributors}, {m_7.contributors}")
    losses = [t.train_step(x, y).loss for x, y in batches[2:]]
    sync()
    require(all(math.isfinite(loss) for loss in losses) and losses[-1] < losses[0],
            f"{DP_STEPS} steps: losses {losses}")
    require(dict(count) == {"masked_average": k1(DP_STEPS + 2), "elastic_average_step": 0},
            f"one K1 launch an f32 step: {dict(count)}")

    compressed = {}
    masked3 = [1.0, 1.0, 1.0, 0.0] + [1.0] * (DP_RANKS - 4)
    for compress, ef in (("bf16", False), ("int8", False), ("bf16", True), ("int8", True)):
        tc = trainer(compress=compress, error_feedback=ef)
        x, y = on_dev(*batches[0])
        if compress == "int8" and not ef:
            cstack, _ = tc.rank_gradients(x, y)
            rows = ring_allreduce_sum(cstack, compress="int8")
            require(all(torch.equal(rows[r], rows[0]) for r in range(1, DP_RANKS)),
                    "int8 ring rows bit-identical")
            del cstack, rows
        if compress == "int8" and ef:
            # the step's three stages, to hold the residual against the
            # ring's own per-hop errors on the same stack
            v3 = torch.tensor(masked3, device=dev)
            cstack, rank_losses = tc.rank_gradients(x, y)
            average, cnt = tc.sync(cstack, v3)
            _, hop = ring_allreduce_sum(cstack * v3[:, None], compress="int8",
                                        return_residual=True)
            require(torch.equal(tc._ef, ring_ef_residual(cstack, v3, hop)),
                    "int8 EF: the residual is c (1 - v) plus the ring's per-hop errors")
            tc.apply_gradients(average)
            m = TrainStepMetrics(1, float((rank_losses * v3).sum() / cnt), float(cnt))
            del cstack, hop
        else:
            m = tc.train_step(x, y, valid=masked3 if ef else None)
        flat = tc.get_flat_params()
        require(math.isfinite(m.loss) and bool(np.isfinite(flat).all())
                and m.contributors == DP_RANKS - ef, f"{compress} ef={ef} step {m}")
        entry = {"loss": m.loss, "contributors": m.contributors}
        if ef:
            norms = tc._ef.norm(dim=1)
            ratio = float(norms[3]) / float(torch.cat([norms[:3], norms[4:]]).max())
            # int8's per-hop errors grow with the width (the JAX trainer's
            # too): its band is held through the residual's formula above
            require(compress == "int8" or ratio > EF_BF16_RATIO,
                    f"{compress} EF: masked rank's row {ratio:.1f}x the others'")
            entry["masked_ef_ratio"] = ratio
        compressed[f"{compress}{'_ef' if ef else ''}"] = entry
        del tc
    require(count["masked_average"] == k1(DP_STEPS + 2), "a compressed sync launched K1")
    launches_b = dict(count)

    # (b2) overlap and accumulation at the same width, rank 7 masked
    zero(count)
    x, y = on_dev(*batches[0])
    v7 = torch.tensor(masked7, device=dev)
    t_o, t_f = trainer(overlap=True), trainer()
    with watch_leaf_syncs(t_o) as seen:
        m_o = t_o.train_step(x, y, valid=masked7)
        sync()
    overlap_launches = count["masked_average"]
    require(overlap_launches == k1(DP_LEAVES) and m_o.contributors == DP_RANKS - 1,
            f"overlapped f32 step: one K1 launch a leaf, {dict(count)}, {m_o}")
    if on_card:
        check_overlap_k1(seen, v7, "MLP overlap")
    del seen
    m_f = t_f.train_step(x, y, valid=masked7)
    overlap_err = float(np.abs(t_o.get_flat_params() - t_f.get_flat_params()).max())
    require(np.allclose(t_o.get_flat_params(), t_f.get_flat_params(), rtol=1e-5, atol=1e-7)
            and abs(m_o.loss - m_f.loss) < 1e-5,
            f"overlapped vs fused step: max abs {overlap_err}, losses {m_o.loss} {m_f.loss}")
    zero(count)
    overlap_ef = {}
    v3 = torch.tensor(masked3, device=dev)
    for compress in ("bf16", "int8"):
        te = trainer(overlap=True, compress=compress, error_feedback=True)
        with watch_leaf_syncs(te) as seen:
            m = te.train_step(x, y, valid=masked3)
        check_overlap_ef(seen, v3, compress, f"overlap {compress} + EF")
        del seen
        norms = te._ef.norm(dim=1)
        ratio = float(norms[3]) / float(torch.cat([norms[:3], norms[4:]]).max())
        require(m.contributors == DP_RANKS - 1 and math.isfinite(m.loss)
                and (compress == "int8" or ratio > EF_OVERLAP_RATIO),
                f"overlap {compress} + EF: {m}, masked row {ratio:.1f}x the others'")
        overlap_ef[compress] = {"loss": m.loss, "masked_ef_ratio": ratio}
        del te
    require(count["masked_average"] == 0, f"compressed overlap launched K1: {dict(count)}")
    t_a, t_p = trainer(), trainer()
    m_a = t_a.train_step_accum(x, y, 4)
    accum_launches = count["masked_average"]
    m_p = t_p.train_step(x, y)
    accum_err = float(np.abs(t_a.get_flat_params() - t_p.get_flat_params()).max())
    require(accum_launches == k1(1) and abs(m_a.loss - m_p.loss) < 1e-5 and accum_err <= 2e-5,
            f"accumulated step (4 microbatches): {accum_launches} K1 launches, losses "
            f"{m_a.loss} {m_p.loss}, params max abs {accum_err}")
    del t_a, t_p, t_f
    sync()

    # (c) the entry points
    zero(count)
    chain = t.train_chain(mnist_like(seed=SEED).device_sampler(), 2, DP_ROWS)
    sync()
    require(len(chain) == 2 and all(math.isfinite(m.loss) for m in chain)
            and count["masked_average"] == k1(2), f"train_chain {chain}, {dict(count)}")
    rc, out = run_cli(["train-mlp", "--steps", "5", "--batch", str(DP_RANKS * DP_ROWS),
                       "--hidden", *map(str, DP_HIDDEN),
                       *([] if on_card else ["--device", "cpu"])])
    sync()
    cli_line = out.strip().splitlines()[-1]
    print(cli_line, flush=True)
    require(rc == 0 and count["masked_average"] == k1(2 + 5),
            f"train-mlp: rc {rc}, {dict(count)}")
    rc, out = run_cli(["bench-mfu", "--workload", "mlp", "--batch", str(DP_RANKS * DP_ROWS),
                       "--hidden", *map(str, DP_HIDDEN),
                       *([] if on_card else ["--device", "cpu"])])
    sync()
    mfu_rec = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(mfu_rec), flush=True)
    require(rc == 0 and mfu_rec["ms_per_step"] > 0 and mfu_rec["hidden"] == list(DP_HIDDEN)
            and count["masked_average"] >= k1(2 + 5 + 1), f"bench-mfu --workload mlp {mfu_rec}")
    cli_lines = {}
    for flags, per_step in ((["--overlap"], DP_LEAVES), (["--accum", "2"], 1)):
        before = count["masked_average"]
        rc, out = run_cli(["train-mlp", "--steps", "3", "--batch", str(DP_RANKS * DP_ROWS),
                           "--hidden", *map(str, DP_HIDDEN), *flags,
                           *([] if on_card else ["--device", "cpu"])])
        sync()
        cli_lines[flags[0]] = out.strip().splitlines()[-1]
        print(cli_lines[flags[0]], flush=True)
        require(rc == 0 and count["masked_average"] - before == k1(3 * per_step),
                f"train-mlp {flags}: rc {rc}, {count['masked_average'] - before} K1 launches")
    launches_c = dict(count)
    return {
        "launches": launches_a["masked_average"] + launches_b["masked_average"]
        + overlap_launches + accum_launches + launches_c["masked_average"],
        "per_part": {"a_config3": launches_a["masked_average"],
                     "b_width_2048": launches_b["masked_average"],
                     "b2_overlap_step": overlap_launches, "b2_accum_step": accum_launches,
                     "c_entry_points": launches_c["masked_average"]},
        "config3": rec3, "losses": losses, "masked_step": m_7.loss,
        "compressed": compressed, "bench_mfu": mfu_rec, "train_mlp": cli_line,
        "overlap": {"max_abs_vs_fused": overlap_err, "loss": m_o.loss, "ef": overlap_ef},
        "accum": {"max_abs_vs_plain": accum_err, "loss": m_a.loss, "plain_loss": m_p.loss},
        "train_mlp_overlap_accum": cli_lines,
        "trainer": t, "overlap_trainer": t_o, "batches": batches, "stack": stack,
        "accum_steps": 4,
    }


def resnet_train_path(dev) -> dict:
    """``DPTrainer`` on ResNet-50 (``ResNet50(classes=1000)``, 25,557,032
    parameters) over ``line_mesh(8)``, 64 px ``imagenet_like`` images, 2 rows
    a rank, f32: the forward on the card against the same seed's model on
    the CPU (1e-4 of max|logit|); K1 against ``masked_average_reference`` on
    a step's ``(8, 25557032)`` stack and the update from either, bit for bit,
    with every rank and with rank 7 masked; then, counted, a few bucketed
    steps on one batch (its loss finite and falling: the batch's 16 images
    are learnt), one overlapped step (K1 once a leaf, each equal to the
    fused average's slice), one accumulated step (one K1 launch), one bf16
    compute step (one) and one int8 + EF step (none); then ``train-resnet``
    (its ``(8, 23528522)`` stack through K1), ``bench-mfu --workload resnet``
    and ``graft_entry.entry()`` / ``dryrun_multichip(8)``."""
    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import graft_entry
    from akka_allreduce_tpu_torch.models import ResNet50, imagenet_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    count = lr.LAUNCHES
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def k1(n: int) -> int:
        return n if on_card else 0

    def model(**kw):
        return ResNet50(RESNET_CLASSES, seed=SEED, device=dev, **kw)

    data = imagenet_like(RESNET_SIZE, RESNET_CLASSES, seed=SEED)
    x, y = next(data.batches(DP_RANKS * RESNET_ROWS, 1))
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev).long()
    masked7 = [1.0] * (DP_RANKS - 1) + [0.0]
    v7 = torch.tensor(masked7, device=dev)

    # (a) the f32 forward against the same seed's model on the CPU, under
    # PyTorch's own cuDNN setting (TF32 allowed): the model turns it off
    # for its convs and hands it back
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        got = model()(xd[:4]).cpu()
        want = ResNet50(RESNET_CLASSES, seed=SEED, device="cpu")(torch.from_numpy(x[:4]))
    forward_err = float((got - want).abs().max() / want.abs().max())
    require(forward_err <= LOGIT_TOL and torch.backends.cudnn.allow_tf32 == tf32,
            f"ResNet-50 f32 logits vs the CPU: {forward_err} (cuDNN TF32 {tf32} -> "
            f"{torch.backends.cudnn.allow_tf32})")

    # (b) K1 on a step's stack, and the update from either average
    mesh = line_mesh(DP_RANKS, device=dev)
    t = DPTrainer(model(), mesh, learning_rate=RESNET_LR, bucket_size=262_144)
    require(t.param_count == RESNET_PARAMS and len(t._params) == RESNET_LEAVES,
            f"ResNet-50 params {t.param_count}, leaves {len(t._params)}")
    stack, _ = t.rank_gradients(xd, yd)
    require(stack.shape == (DP_RANKS, RESNET_PARAMS) and bool(torch.isfinite(stack).all()),
            f"ResNet-50 gradient stack {tuple(stack.shape)}")
    p0 = t.get_flat_params()
    for bits in ([1.0] * DP_RANKS, masked7):
        v = torch.tensor(bits, device=dev)
        avg, cnt = lr.masked_average(stack, v)
        ref, ref_cnt = lr.masked_average_reference(stack, v)
        require(torch.equal(avg, ref) and float(cnt) == float(ref_cnt) == sum(bits),
                f"K1 on ResNet-50's stack, mask {bits}: max abs err "
                f"{float((avg - ref).abs().max())}")
        t.apply_gradients(ref)
        p_plain = t.get_flat_params()
        t.set_flat_params(p0)
        t.apply_gradients(avg)
        require(np.array_equal(t.get_flat_params(), p_plain),
                f"ResNet-50 parameters after the update from K1's average, mask {bits}")
        t.set_flat_params(p0)
    del avg, ref
    sync()

    # (c) counted steps
    zero(count)
    losses = [t.train_step(xd, yd, valid=masked7 if i == 1 else None).loss
              for i in range(RESNET_STEPS)]
    sync()
    steps_launches = count["masked_average"]
    require(all(math.isfinite(loss) for loss in losses) and losses[-1] < losses[0]
            and steps_launches == k1(RESNET_STEPS),
            f"ResNet-50 f32 steps: losses {losses}, {steps_launches} K1 launches")
    zero(count)
    t_o = DPTrainer(model(), mesh, learning_rate=RESNET_LR, overlap=True)
    with watch_leaf_syncs(t_o) as seen:
        m_o = t_o.train_step(xd, yd, valid=masked7)
        sync()
    overlap_launches = count["masked_average"]
    require(overlap_launches == k1(RESNET_LEAVES) and m_o.contributors == DP_RANKS - 1
            and math.isfinite(m_o.loss),
            f"ResNet-50 overlapped step: {overlap_launches} K1 launches, {m_o}")
    if on_card:
        check_overlap_k1(seen, v7, "ResNet-50 overlap")
    del seen
    zero(count)
    t_a = DPTrainer(model(), mesh, learning_rate=RESNET_LR, bucket_size=262_144)
    m_a = t_a.train_step_accum(x, y, RESNET_ROWS)
    accum_launches = count["masked_average"]
    del t_a
    zero(count)
    t_b = DPTrainer(model(compute_dtype=torch.bfloat16), mesh, learning_rate=RESNET_LR,
                    bucket_size=262_144)
    m_b = t_b.train_step(xd, yd)
    bf16_launches = count["masked_average"]
    del t_b
    zero(count)
    t_8 = DPTrainer(model(), mesh, learning_rate=RESNET_LR, compress="int8",
                    error_feedback=True)
    m_8 = t_8.train_step(xd, yd, valid=masked7)
    int8_launches = count["masked_average"]
    require(bool(torch.isfinite(t_8._ef).all()), "ResNet-50 int8 EF residual finite")
    del t_8
    sync()
    require(accum_launches == k1(1) and bf16_launches == k1(1) and int8_launches == 0
            and all(math.isfinite(m.loss) for m in (m_a, m_b, m_8))
            and m_8.contributors == DP_RANKS - 1,
            f"ResNet-50: accum {accum_launches} / bf16 {bf16_launches} / int8 EF "
            f"{int8_launches} K1 launches, losses {m_a.loss} {m_b.loss} {m_8.loss}")

    # (d) the entry points
    zero(count)
    rc, out = run_cli(["train-resnet", *(["--steps", "3"] if on_card else [
        "--steps", "1", "--device", "cpu", "--image-size", "8", "--batch", "8"])])
    sync()
    train_lines = out.strip().splitlines()
    print("\n".join(train_lines), flush=True)
    require(rc == 0 and train_lines[0].startswith(
        "ResNet params: 23.5M" if on_card else "ResNet params: ")
        and count["masked_average"] == k1(3),
        f"train-resnet: rc {rc}, {dict(count)}")
    train_launches = count["masked_average"]
    zero(count)
    rc, out = run_cli(["bench-mfu", "--workload", "resnet", *([] if on_card else [
        "--device", "cpu", "--image-size", "8"])])
    sync()
    mfu_rec = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(mfu_rec), flush=True)
    require(rc == 0 and mfu_rec["ms_per_step"] > 0 and mfu_rec["batch"] == DP_RANKS
            and (mfu_rec["params_m"] == 25.6 or not on_card)
            and (not on_card or 0 < mfu_rec["value"] < 1)
            and count["masked_average"] >= k1(1), f"bench-mfu --workload resnet {mfu_rec}")
    mfu_launches = count["masked_average"]
    zero(count)
    fn, args = graft_entry.entry(device=dev)
    logits = fn(*args)
    require(tuple(logits.shape) == (4, RESNET_CLASSES) and bool(torch.isfinite(logits).all()),
            f"graft_entry.entry(): {tuple(logits.shape)}")
    del fn, args, logits
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(DP_RANKS, device=dev)
    sync()
    dry = buf.getvalue().strip().splitlines()
    print("\n".join(dry), flush=True)
    require(any(ln.startswith("dryrun train_chain ok") for ln in dry)
            and count["masked_average"] == k1(4), f"dryrun_multichip(8): {dict(count)}")
    dry_launches = count["masked_average"]
    return {
        "launches": steps_launches + overlap_launches + accum_launches + bf16_launches
        + train_launches + mfu_launches + dry_launches,
        "per_part": {"steps": steps_launches, "overlap_step": overlap_launches,
                     "accum_step": accum_launches, "bf16_step": bf16_launches,
                     "int8_ef_step": int8_launches, "train_resnet": train_launches,
                     "bench_mfu": mfu_launches, "dryrun_multichip": dry_launches},
        "forward_err": forward_err, "losses": losses, "overlap_loss": m_o.loss,
        "accum_loss": m_a.loss, "bf16_loss": m_b.loss, "int8_ef_loss": m_8.loss,
        "train_resnet": train_lines[-1], "bench_mfu": mfu_rec,
        "trainer": t, "overlap_trainer": t_o, "batch": (xd, yd), "stack": stack,
        "accum_steps": RESNET_ROWS,
    }


def engine_flushes_equal(card_run, cpu_run) -> int:
    """Every node's every flush of two engine runs (kept outputs): the same
    rounds in the same order, data and counts bit for bit. Returns the
    number of flushes compared."""
    import torch

    n = 0
    for node, (a, b) in enumerate(zip(card_run.outputs, cpu_run.outputs)):
        require([o.iteration for o in a] == [o.iteration for o in b],
                f"node {node} flushed rounds {[o.iteration for o in a]} against "
                f"the CPU's {[o.iteration for o in b]}")
        for x, y in zip(a, b):
            require(x.data.is_cuda and x.count.is_cuda, "the outputs lie on the card")
            require(torch.equal(x.data.cpu(), y.data) and torch.equal(x.count.cpu(), y.count),
                    f"node {node} round {x.iteration}: the card's flush equals the CPU's")
            n += 1
    return n


def engine_buffers(system) -> list:
    """Every live round buffer's storage in a local engine system."""
    out = []
    for node in system.nodes.values():
        for worker in node.workers.values():
            if worker.rounds is not None:
                out += [b._sums for b in worker.rounds._scattered.values()]
                out += [b._data for b in worker.rounds._reduced.values()]
    return out


def kernel_counts() -> dict:
    """The launch counters of K1-K4, keyed by module and kernel."""
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.ops import ring as rk

    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{k}": v
            for mod in (lr, rk, fa) for k, v in mod.LAUNCHES.items()}


def profile_engine(fn) -> dict:
    """``fn()`` under ``torch.profiler``: ``profile_window``'s busy share
    and top kernels, plus the copies it saw from device to host, host to
    device and device to device (``copy_`` between two tensors on the card is
    a ``cudaMemcpyAsync``, not a kernel), the kernel launches, and the K1-K4
    kernels among them by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)
              and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernels = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        "dtoh": sum(e.count for e in events if e.key.startswith("Memcpy DtoH")),
        "htod": sum(e.count for e in events if e.key.startswith("Memcpy HtoD")),
        "dtod": sum(e.count for e in events if e.key.startswith("Memcpy DtoD")),
        "launches": sum(e.count for e in kernels),
        "k1_k4": [e.key[:60] for e in kernels if re.search(
            r"masked_average|elastic|ring|flash", e.key)],
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]],
    }


def host_engine_path(dev, card: dict) -> dict:
    """Phase (h): the host engine, its round buffers on the card, each run
    against the same run on the CPU; no K1-K4 launch anywhere in it."""
    import statistics

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import bench_suite
    from akka_allreduce_tpu_torch.binder import ElasticAverageBinder
    from akka_allreduce_tpu_torch.config import (
        AllreduceConfig,
        LineMasterConfig,
        MasterConfig,
        MetaDataConfig,
    )
    from akka_allreduce_tpu_torch.control import LocalAllreduceSystem
    from akka_allreduce_tpu_torch.control.local import local_engine

    def run(size, **kw):
        return local_engine(size, **kw).run()

    before = kernel_counts()
    out: dict = {}

    # BASELINE config 1: the record, then the same rounds kept and checked
    rec = bench_suite.config1_local_engine(device=dev)
    print(json.dumps(rec), flush=True)
    require(rec["rounds"] == ENGINE_ROUNDS and rec["engine"] == "cuda"
            and rec["device"] == card["name"] and rec["throughput_mbs"] > 0,
            f"config 1 record {rec}")
    card_run = local_engine(ENGINE_FLOATS, rounds=ENGINE_ROUNDS, device=dev,
                                        keep_outputs=True)
    seen: dict = {}  # every live round buffer, looked at as each message is sent

    def look(env) -> bool:
        seen.update((t.data_ptr(), t.is_cuda) for t in engine_buffers(card_run.system))
        return False  # drops nothing

    card_run.system.router.drop_filter = look
    card_run.run()
    cpu_run = run(ENGINE_FLOATS, rounds=ENGINE_ROUNDS, device="cpu", keep_outputs=True)
    require(seen and all(seen.values()), f"every round buffer on the card ({len(seen)} seen)")
    out["config1"] = {"record": rec, "flushes_equal": engine_flushes_equal(card_run, cpu_run),
                      "buffers_seen_on_card": len(seen),
                      "cpu_throughput_mbs": round(
                          cpu_run.rounds * ENGINE_FLOATS * 4 / cpu_run.seconds / 1e6, 1)}
    require(all((o.count == 4).all() for o in card_run.outputs[0]), "config 1 counts 4")
    del card_run, cpu_run

    # a profiled window over 3 rounds of config 1: no copy back to the host
    prof = profile_engine(local_engine(ENGINE_FLOATS, rounds=3, device=dev).run)
    require(prof["dtoh"] == prof["htod"] == 0,
            f"no copy between host and card in a round: {prof['dtoh']}, {prof['htod']}")
    require(not prof["k1_k4"], f"no K1-K4 kernel on the engine's path: {prof['k1_k4']}")
    prof["launches_per_round"] = prof["launches"] / 3
    prof["dtod_per_round"] = prof["dtod"] / 3
    out["config1_profile"] = prof

    # ResNet-50's gradient at the size a deployment syncs
    card_run = run(RESNET_PARAMS, rounds=ENGINE_BIG_ROUNDS, device=dev, keep_outputs=True)
    cpu_run = run(RESNET_PARAMS, rounds=ENGINE_BIG_ROUNDS, device="cpu", keep_outputs=True)
    big = {"flushes_equal": engine_flushes_equal(card_run, cpu_run),
           "rounds": card_run.rounds, "seconds": card_run.seconds,
           "throughput_mbs": card_run.rounds * RESNET_PARAMS * 4 / card_run.seconds / 1e6,
           "cpu_seconds": cpu_run.seconds,
           "cpu_throughput_mbs": cpu_run.rounds * RESNET_PARAMS * 4 / cpu_run.seconds / 1e6}
    require(big["rounds"] == ENGINE_BIG_ROUNDS, f"25.5M rounds {big['rounds']}")
    del card_run, cpu_run
    torch.cuda.empty_cache()
    rounds_ms = []

    def round_done(line, r, latency, done, workers):
        # the line master's latency runs from the round's Start to this
        # completion; the synchronize ends it when the card has finished too
        started = time.monotonic() - latency
        torch.cuda.synchronize()
        rounds_ms.append((time.monotonic() - started) * 1e3)

    timed = local_engine(RESNET_PARAMS, rounds=ENGINE_BIG_ROUNDS, device=dev)
    timed.system.master.on_round_complete = round_done
    timed.run()
    del timed
    big["round_ms_median"] = statistics.median(rounds_ms)
    big["round_ms"] = rounds_ms
    prof = profile_engine(local_engine(RESNET_PARAMS, rounds=ENGINE_BIG_ROUNDS,
                                                   device=dev).run)
    require(prof["dtoh"] == prof["htod"] == 0 and not prof["k1_k4"], f"25.5M profile {prof}")
    big["profile"] = prof
    out["resnet_grad"] = big
    print(f"host engine, 4 workers x {RESNET_PARAMS} floats, chunk {ENGINE_CHUNK}, "
          f"{ENGINE_BIG_ROUNDS} rounds ({card['name']}, {card['power_limit']}): "
          f"{big['seconds']:.4f} s, {big['throughput_mbs']:.1f} MB/s, median round "
          f"(Start to completion) {big['round_ms_median']:.3f} ms, device busy "
          f"{prof['busy_share'] * 100:.1f}%, "
          f"{prof['launches'] / ENGINE_BIG_ROUNDS:.0f} kernels and "
          f"{prof['dtod'] / ENGINE_BIG_ROUNDS:.0f} device-to-device copies a round; CPU "
          f"{big['cpu_seconds']:.4f} s", flush=True)

    # dropout: the host tier of config 5, every message of worker 3 lost
    drop = dict(chunk=DROPOUT_CHUNK, th=0.75, rounds=DROPOUT_ROUNDS, drop_worker=3,
                keep_outputs=True)
    card_run = run(DROPOUT_FLOATS, device=dev, **drop)
    cpu_run = run(DROPOUT_FLOATS, device="cpu", **drop)
    node0 = card_run.outputs[0]
    require(len(node0) == DROPOUT_ROUNDS, f"dropout: node 0 flushed {len(node0)} rounds")
    counts = sorted({int(c) for o in node0 for c in torch.unique(o.count).tolist()})
    require(set(counts) <= {0, 3}, f"dropout counts {counts}")
    out["dropout"] = {"flushes_equal": engine_flushes_equal(card_run, cpu_run),
                      "node0_rounds": len(node0), "counts": counts,
                      "dropped": card_run.system.router.dropped,
                      "seconds": card_run.seconds}
    del card_run, cpu_run

    # the 2-D butterfly: dim 0's concat(sum, counts) feeds dim 1
    card_run = run(ENGINE_FLOATS, dims=2, rounds=BUTTERFLY_ROUNDS, device=dev,
                   keep_outputs=True)
    cpu_run = run(ENGINE_FLOATS, dims=2, rounds=BUTTERFLY_ROUNDS, device="cpu",
                  keep_outputs=True)
    require(all((o.count == 4).all() for outs in card_run.outputs for o in outs),
            "2-D counts 4")
    out["butterfly_2d"] = {"flushes_equal": engine_flushes_equal(card_run, cpu_run),
                           "seconds": card_run.seconds}
    del card_run, cpu_run

    # ElasticAverageBinder with the weights on the card
    def elastic(device) -> list:
        rng = np.random.default_rng(SEED)
        weights = {i: torch.from_numpy(rng.standard_normal(ENGINE_FLOATS).astype(
            np.float32)).to(device) for i in range(4)}
        history: dict[int, list] = {i: [] for i in range(4)}

        def setter(i):
            def set_weights(w):
                weights[i] = w
                history[i].append(w)
            return set_weights

        binders = [ElasticAverageBinder(lambda i=i: weights[i], setter(i), ELASTIC_ALPHA)
                   for i in range(4)]
        cfg = AllreduceConfig(
            metadata=MetaDataConfig(data_size=ENGINE_FLOATS, max_chunk_size=ENGINE_CHUNK),
            line_master=LineMasterConfig(round_window=2, max_rounds=ELASTIC_ROUNDS),
            master=MasterConfig(node_num=4))
        system = LocalAllreduceSystem(4, [b.data_source for b in binders],
                                      [b.data_sink for b in binders], cfg, device=device)
        system.start()
        system.run_until_quiescent()
        require(all(b.rounds_applied == ELASTIC_ROUNDS for b in binders), "elastic rounds")
        spread = [float((torch.stack([history[i][r] for i in range(4)]).amax(0)
                         - torch.stack([history[i][r] for i in range(4)]).amin(0)).max())
                  for r in range(ELASTIC_ROUNDS)]
        return [weights[i] for i in range(4)], spread

    w_card, spread = elastic(dev)
    w_cpu, spread_cpu = elastic("cpu")
    require(all(w.is_cuda for w in w_card), "the binder's weights stay on the card")
    require(all(b < a for a, b in zip(spread, spread[1:])),
            f"the spread falls every round: {spread}")
    err = max(float(((a.cpu() - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in zip(w_card, w_cpu))
    require(all(torch.allclose(a.cpu(), b, rtol=ELASTIC_RTOL, atol=0)
                for a, b in zip(w_card, w_cpu)), f"elastic weights vs the CPU's: {err}")
    out["elastic"] = {"spread": spread, "spread_cpu": spread_cpu, "max_rel_err": err}

    # the CLI on the card
    rc, text = run_cli(["local-demo", "--size", str(ENGINE_FLOATS), "--rounds", "5"])
    line = text.strip().splitlines()[-1]
    require(rc == 0 and "rounds_completed=5" in line and "engine=cuda" in line
            and card["name"] in line, f"local-demo: {line}")
    out["local_demo"] = line
    print(line, flush=True)

    require(kernel_counts() == before, "no K1-K4 launch on the host engine's path")
    out["k1_k4_launches"] = 0
    return out


def spawn_role(*argv: str, log):
    """One role of the TCP cluster (``cluster_cli.spawn_role``), its stderr
    in the file ``log``."""
    from akka_allreduce_tpu_torch.cluster_cli import spawn_role as spawn

    with open(log, "w") as err:
        return spawn(*argv, stderr=err)


def log_tails(d) -> str:
    """The last lines of every role's stderr log under ``d``."""
    from pathlib import Path

    return "\n".join(f"--- {p.name}\n" + "\n".join(p.read_text().splitlines()[-15:])
                     for p in sorted(Path(d).glob("*.log")))


def read_endpoint(proc, prefix: str) -> str:
    """The endpoint on ``proc``'s first stdout line that starts with
    ``prefix``, read under ``cluster_cli.read_until``'s deadline."""
    return read_lines(proc, prefix)[-1].split()[3]


def read_lines(proc, prefix: str) -> list[str]:
    from akka_allreduce_tpu_torch.cluster_cli import read_until

    try:
        return read_until(proc, prefix)
    except RuntimeError as e:
        raise RuntimeError(f"chip_smoke check failed: {e}") from None


def jsonl(path) -> list[dict]:
    from pathlib import Path

    p = Path(path)
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln.strip()] if p.exists() else []


_MEANS: dict = {}


def payload_mean(size: int, seeds) -> "np.ndarray":
    """The numpy mean of the nodes' seeded payloads (``cluster-node`` draws
    ``default_rng(seed).standard_normal(size)``, its seed its node id),
    kept for the next run of the same shape."""
    import numpy as np

    key = (size, tuple(seeds))
    if key not in _MEANS:
        acc = np.zeros(size, np.float64)
        for s in key[1]:
            acc += np.random.default_rng(s).standard_normal(size).astype(np.float32)
        _MEANS[key] = (acc / len(key[1])).astype(np.float32)
    return _MEANS[key]


def tcp_cluster_run(root, tag: str, size: int, rounds: int, device: str,
                    extra=(), nodes: int = CLUSTER_NODES, timeout: float = 180.0) -> dict:
    """``cluster-master`` and ``nodes`` ``cluster-node`` processes over
    loopback TCP: each node's last flush (``--flush-out``), its stage record
    (``--metrics-out``) and its output lines, the master's round records."""
    import numpy as np

    d = root / tag
    d.mkdir()
    master = spawn_role("cluster-master", "--nodes", str(nodes), "--size", str(size),
                        "--chunk", str(CLUSTER_CHUNK), "--rounds", str(rounds),
                        "--th", "1.0", "--metrics-out", str(d / "master.jsonl"), *extra,
                        log=d / "master.log")
    procs = [master]
    try:
        seed = read_endpoint(master, "master listening on ")
        for k in range(nodes):
            procs.append(spawn_role("cluster-node", "--seed", seed, "--device", device,
                                    "--flush-out", str(d / f"flush{k}.npz"),
                                    "--metrics-out", str(d / f"node{k}.jsonl"),
                                    log=d / f"node{k}.log"))
        t0 = time.perf_counter()
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        wall = time.perf_counter() - t0
        require(all(p.returncode == 0 for p in procs),
                f"{tag}: exit codes {[p.returncode for p in procs]}: {outs}\n{log_tails(d)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    require("master cuda_initialized=False" in outs[0], f"{tag}: the master started CUDA")
    stats = [next(r for r in jsonl(d / f"node{k}.jsonl") if r.get("kind") == "node_stage_times")
             for k in range(nodes)]
    flushes = [np.load(d / f"flush{k}.npz") for k in range(nodes)]
    round_s = [r["latency_s"] for r in jsonl(d / "master.jsonl") if r.get("kind") == "round"]
    return {"stats": stats, "flushes": flushes, "round_s": round_s, "wall_s": wall,
            "node_lines": [ln for o in outs[1:] for ln in o.splitlines()
                           if " shut down " in ln or " stage times " in ln]}


def check_tcp_flushes(run: dict, size: int, tag: str, f16: bool = False) -> float:
    """Every node's last flush against the numpy mean of the seeded payloads:
    rtol 1e-5, atol 1e-6 (f32), or within 2e-3 of max|mean| (f16, and lossy);
    every count 4. Returns the largest error."""
    import numpy as np

    want = payload_mean(size, range(len(run["flushes"])))
    worst = 0.0
    for k, f in enumerate(run["flushes"]):
        count = f["count"]
        require(int(count.min()) == len(run["flushes"]), f"{tag} node {k}: counts {count.min()}")
        avg = f["data"] / count
        err = float(np.abs(avg - want).max())
        if f16:
            rel = err / float(np.abs(want).max())
            require(0 < rel < 2e-3, f"{tag} node {k}: f16 error {rel} of max|mean|")
        else:
            require(np.allclose(avg, want, rtol=1e-5, atol=1e-6), f"{tag} node {k}: {err}")
        worst = max(worst, err)
    return worst


def tcp_summary(run: dict, card: dict, device: str) -> dict:
    """What a TCP run prints: each node's rounds, MB/s, stage times, wire
    path and device, the median round, the card."""
    import statistics

    stage_keys = ("encode", "socket_write", "decode", "handler", "d2h", "h2d")
    nodes = [{"node": s["node"], "rounds": s["rounds"], "mb_per_s": s["mb_per_s"],
              "wall_s": s["wall_s"], "wire": s["wire"], "device": s["device"],
              **{k: s[k] for k in stage_keys}} for s in run["stats"]]
    wall = sum(s["wall_s"] for s in run["stats"])
    copies = sum(s["d2h"] + s["h2d"] for s in run["stats"])
    return {"nodes": nodes, "round_s_median": statistics.median(run["round_s"]),
            "round_s": run["round_s"], "copy_share_of_node_wall": copies / wall,
            "device": device, "card": card["smi"]}


def inproc_cluster(device, *, nodes: int, size: int, rounds: int = -1, dims: int = 1,
                   th: float = 1.0, policy=None, chunk: int = 65_536, hb: float = 0.2,
                   timeout: float = 1.0, script=None, deadline: float = 60.0) -> dict:
    """A ``MasterProcess`` and ``nodes`` ``NodeProcess``es in this process's
    event loop over loopback TCP, the nodes' buffers and payloads on
    ``device``. ``script(h)`` (a coroutine function) drives the run; without
    one the master's round budget does. Returns the harness: inputs (numpy),
    every node's outputs, the live nodes."""
    import asyncio

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.config import (
        AllreduceConfig,
        LineMasterConfig,
        MasterConfig,
        MetaDataConfig,
        ThresholdConfig,
    )
    from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess, NodeProcess
    from akka_allreduce_tpu_torch.protocol import AllReduceInput

    cfg = AllreduceConfig(
        threshold=ThresholdConfig(th, th, th),
        metadata=MetaDataConfig(data_size=size, max_chunk_size=chunk),
        line_master=LineMasterConfig(round_window=2, max_rounds=rounds),
        master=MasterConfig(node_num=nodes, dimensions=dims, heartbeat_interval_s=hb,
                            heartbeat_timeout_s=timeout),
    )
    h = {"inputs": [np.random.default_rng(i).standard_normal(size).astype(np.float32)
                    for i in range(nodes + 2)], "outputs": {}, "nodes": {}}
    payloads = [torch.from_numpy(x).to(device) for x in h["inputs"]]

    async def add_node(i: int):
        node = NodeProcess(h["seed"], lambda req, i=i: AllReduceInput(payloads[i]),
                           lambda out, i=i: h["outputs"].setdefault(i, []).append(out),
                           preferred_node_id=i, device=device)
        await node.start()
        await node.wait_welcomed()
        h["nodes"][i] = node
        return node

    async def until(pred, limit: float = 30.0):
        loop = asyncio.get_running_loop()
        end = loop.time() + limit
        while not pred():
            require(loop.time() < end, "an in-process cluster's condition was not reached")
            await asyncio.sleep(0.02)

    h["add_node"], h["until"] = add_node, until

    async def run():
        master = h["master"] = MasterProcess(cfg, port=0)
        if policy is not None:
            master.grid.set_policy(policy)
        h["seed"] = await master.start()
        try:
            for i in range(nodes):
                await add_node(i)
            if script is None:
                await master.run_until_done(timeout=deadline)
                await until(lambda: all(len(h["outputs"].get(i, [])) >= rounds
                                        for i in range(nodes)))
            else:
                await script(h)
        finally:
            for node in h["nodes"].values():
                await node.stop()
            await master.stop()

    asyncio.run(asyncio.wait_for(run(), deadline))
    return h


def inproc_mean_err(h: dict, nodes, contributors, count: int) -> float:
    """Nodes' last flushes against the numpy mean of ``contributors``'
    inputs (rtol 1e-5, atol 1e-6), every count ``count``, every output on
    the payloads' device."""
    import numpy as np

    want = np.mean([h["inputs"][k] for k in contributors], axis=0)
    worst = 0.0
    for i in nodes:
        out = h["outputs"][i][-1]
        require(int(out.count.min()) == count, f"node {i}: counts {int(out.count.min())}")
        avg = out.average().cpu().numpy()
        err = float(np.abs(avg - want).max())
        require(np.allclose(avg, want, rtol=1e-5, atol=1e-6), f"node {i}: {err}")
        worst = max(worst, err)
    return worst


def cluster_path(dev, card: dict) -> dict:
    """Phase (j): the TCP control plane with the nodes' round buffers on the
    card. BASELINE config 1 (nodes on the card and on the CPU) and
    ResNet-50's gradient (f32 and f16 wires) over TCP between node
    processes, the four clusters at once, in-process clusters on the card
    (butterfly, dropout at th 0.75, a late joiner, an int8 policy with error
    feedback), ``obs demo`` and ``bench-wire``; no K1-K4 launch."""
    import asyncio
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import native
    from akka_allreduce_tpu_torch.protocol import RoundPolicy

    before = kernel_counts()
    out: dict = {"card": card["smi"]}
    t0 = time.perf_counter()
    require(native.available(), "the wire codec's C++ builds and loads")
    out["native_build_s"] = time.perf_counter() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cluster_"))
    t0 = time.perf_counter()
    try:
        # over TCP, at once, each cluster on its own ports: config 1 with 4
        # node processes on the card and on the CPU; ResNet-50's gradient
        # over three payload streams, f32 then f16; and in this thread ``obs
        # demo``'s cluster. Their readings are taken beside the others' load
        # (``with``)
        runs = {"config1_cuda": (CLUSTER_FLOATS, CLUSTER_ROUNDS, str(dev), ()),
                "config1_cpu": (CLUSTER_FLOATS, CLUSTER_ROUNDS, "cpu", ())}
        for wire in ("f32", "f16"):
            runs[f"resnet_grad_{wire}"] = (RESNET_PARAMS, CLUSTER_BIG_ROUNDS, str(dev),
                                           ("--streams", "3", "--wire-dtype", wire))
        with ThreadPoolExecutor(len(runs)) as pool:
            done = {tag: pool.submit(tcp_cluster_run, root, tag, *args)
                    for tag, args in runs.items()}
            out["obs_demo"] = {**obs_demo_run(root, dev), "s": time.perf_counter() - t0}
            results = {tag: f.result() for tag, f in done.items()}
        out["tcp_clusters_s"] = time.perf_counter() - t0
        for tag, run in results.items():
            size, rounds, device, _ = runs[tag]
            err = check_tcp_flushes(run, size, tag, f16=tag == "resnet_grad_f16")
            for s in run["stats"]:
                require(s["rounds"] >= rounds, f"{tag}: node rounds {s['rounds']}")
                require(s["wire"] == "native", f"{tag}: node {s['node']} ran wire={s['wire']}")
                want = card["name"] if device != "cpu" else "cpu"
                require(s["device"] == want, f"{tag}: node device {s['device']}")
            out[tag] = {**tcp_summary(run, card, device), "max_abs_err": err,
                        "wall_s": run["wall_s"],
                        "with": [t for t in (*runs, "obs demo") if t != tag]}
            print("\n".join(run["node_lines"]), flush=True)
        shutil.rmtree(root / "resnet_grad_f32")
        shutil.rmtree(root / "resnet_grad_f16")
        t0 = time.perf_counter()

        # in-process clusters on the card, in this process's event loop
        h = inproc_cluster(dev, nodes=4, dims=2, size=CLUSTER_FLOATS, rounds=3)
        require(all(o.data.device == dev for outs in h["outputs"].values() for o in outs),
                "the butterfly's outputs lie on the card")
        out["butterfly_2d"] = {"max_abs_err": inproc_mean_err(h, range(4), range(4), 4),
                               "s": time.perf_counter() - t0}
        t0 = time.perf_counter()

        async def dropout(h):
            await h["until"](lambda: min(len(h["outputs"].get(i, [])) for i in range(4)) >= 2)
            await h["nodes"].pop(3).stop()  # no leave: its heartbeats stop
            await h["until"](lambda: 3 not in h["master"].grid.nodes)
            f0 = len(h["outputs"][0])
            await h["until"](lambda: len(h["outputs"][0]) >= f0 + 3)

        h = inproc_cluster(dev, nodes=4, size=200_000, chunk=16_384, th=0.75,
                           hb=0.05, timeout=0.25, script=dropout)
        require(sorted(h["master"].grid.nodes) == [0, 1, 2], "the master re-meshed")
        # th_complete 0.75 may flush with a quarter of the chunks unfilled
        # (count 0); every filled element holds the three survivors
        last = h["outputs"][0][-1]
        counts = last.count.cpu().numpy()
        full = counts == 3
        require(set(np.unique(counts)) <= {0, 3} and full.mean() >= 0.75,
                f"th 0.75 counts: {np.unique(counts)}, filled {full.mean()}")
        want = np.mean(h["inputs"][:3], axis=0)
        avg = last.average().cpu().numpy()
        require(np.allclose(avg[full], want[full], rtol=1e-5, atol=1e-6), "th 0.75 flush")
        out["dropout_th075"] = {
            "flushes_node0": len(h["outputs"][0]), "filled_share": float(full.mean()),
            "max_abs_err": float(np.abs(avg[full] - want[full]).max()),
            "s": time.perf_counter() - t0}
        t0 = time.perf_counter()

        async def late(h):
            await h["until"](lambda: min(len(h["outputs"].get(i, [])) for i in range(2)) >= 2)
            await h["add_node"](2)
            await h["until"](lambda: sorted(h["master"].grid.nodes) == [0, 1, 2])
            await h["until"](lambda: len(h["outputs"].get(2, [])) >= 2)

        h = inproc_cluster(dev, nodes=2, size=CLUSTER_FLOATS, script=late)
        out["late_joiner"] = {"max_abs_err": inproc_mean_err(h, [2], [0, 1, 2], 3),
                              "s": time.perf_counter() - t0}
        t0 = time.perf_counter()

        h = inproc_cluster(dev, nodes=4, size=CLUSTER_FLOATS, rounds=6,
                           policy=RoundPolicy(wire="int8"))
        out["int8_ef"] = {**int8_ef_check(h, dev), "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        rc, text = run_cli(["bench-wire", "--json", "--uring", "--intra-chunk",
                            "--congestion", "--device", str(dev)])
        records = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
        require(rc == 0 and len(records) == 4 and records[0]["native_loaded"]
                and records[0]["device"] == card["name"], f"bench-wire: {text}")
        out["bench_wire"] = records
        out["bench_wire_s"] = time.perf_counter() - t0
        print(text, flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(kernel_counts() == before, "no K1-K4 launch on the cluster path")
    out["k1_k4_launches"] = 0
    return out


def int8_ef_check(h: dict, dev) -> dict:
    """An int8 policy's rounds: each flush within two int8 steps of the
    numpy mean (``2 max|x| / 127``), the error feedback's residuals held
    on the card, and the mean over rounds closer to the exact mean than a
    single round."""
    import numpy as np

    want = np.mean(h["inputs"][:4], axis=0)
    bound = 2 * max(float(np.abs(x).max()) for x in h["inputs"][:4]) / 127
    errs, avgs = [], []
    for i in range(4):
        for o in h["outputs"][i]:
            require(int(o.count.min()) == 4, "int8 rounds: counts 4")
            avg = o.average().cpu().numpy()
            avgs.append(avg)
            errs.append(float(np.abs(avg - want).max()))
    require(max(errs) <= bound and max(errs) > 0, f"int8 error {max(errs)} vs {bound}")
    residuals = [r for node in h["nodes"].values() for w in node.node.workers.values()
                 for r in w._ef_residual.values()]
    require(residuals and all(r.device == dev for r in residuals), "EF residuals on the card")
    first = float(np.abs(np.mean([a for a in avgs[:1]], axis=0) - want).max())
    rounds_mean = float(np.abs(np.mean(avgs, axis=0) - want).max())
    require(rounds_mean < first, f"EF: the mean over rounds {rounds_mean} vs one round {first}")
    return {"max_abs_err": max(errs), "bound": bound, "mean_over_rounds_err": rounds_mean,
            "residuals_on_card": len(residuals)}


def obs_demo_run(root, dev) -> dict:
    """``obs demo --nodes 2`` (a master and two node processes on the card):
    its merged trace holds round traces across line master, worker and
    transport."""
    rc, text = run_cli(["obs", "demo", "--nodes", "2", "--out-dir", str(root / "obs"),
                        "--device", str(dev)])
    require(rc == 0 and "round trace(s) spanning" in text, f"obs demo: {text}")
    print(text, flush=True)
    return {"lines": text.strip().splitlines()}


# -- phase (k): elasticity ----------------------------------------------------------


def snapshot_bytes(snap) -> int:
    """Bytes a ``Snapshot`` holds on the host (parameters, optimizer state,
    the EF residual)."""
    import numpy as np

    def walk(x) -> int:
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        return int(np.asarray(x).nbytes) if x is not None else 0

    return walk(snap.params) + walk(snap.opt_state) + walk(snap.ef) + walk(snap.custom)


def continuation_oracle(source, hidden, n_ranks: int, dev):
    """A fresh ``DPTrainer`` on ``MLP(hidden)`` over ``n_ranks`` ranks,
    restored from a ``Snapshot`` of ``source``: what an elastic trainer must
    equal bit for bit from a re-mesh on."""
    from akka_allreduce_tpu_torch.models import MLP
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer, Snapshot

    o = DPTrainer(MLP(hidden=hidden, seed=SEED, device=dev), line_mesh(n_ranks, device=dev))
    Snapshot.capture(source).restore_into(o)
    return o


def elastic_dp_cycle(dev, hidden, rows: int, *, oracle: bool = False,
                     leak_cycles: int = 0) -> dict:
    """``ElasticDPTrainer`` on ``MLP(hidden)`` over 4 nodes x 2 virtual ranks,
    ``rows`` rows a rank, f32: 2 steps, node 3 silent (6 ranks), 2 steps,
    node 3 back (8 ranks), 2 steps, each re-mesh timed alone and with its
    first step. With ``oracle``, a fresh ``DPTrainer`` restored from a
    ``Snapshot`` of the one before it (the first from the elastic trainer's)
    takes every step beside it and the two are compared bit for bit at
    every step. With ``leak_cycles``, that many more drop/rejoin cycles
    follow (the first of them the warm drop), a step after each re-mesh,
    and ``memory_allocated`` is read after the first cycle and after the
    last. On the card, ``built_bytes`` is what the new elastic trainer
    holds once built (its one copy of the weights; the model it was given is
    freed). Returns the trainer, its K1 launches a step and the figures."""
    import gc

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.train import ElasticDPTrainer, Snapshot

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    now = {"t": 0.0}
    nodes = {n: list(range(n * ELASTIC_PER_NODE, (n + 1) * ELASTIC_PER_NODE))
             for n in range(ELASTIC_NODES)}
    survivors = [n for n in nodes if n != ELASTIC_LOST]

    def allocated() -> int:
        gc.collect()
        sync()
        return torch.cuda.memory_allocated(dev) if on_card else 0

    mem0 = allocated()
    e = ElasticDPTrainer(MLP(hidden=hidden, seed=SEED, device=dev), nodes,
                         clock=lambda: now["t"], device=dev)
    ds = mnist_like(seed=SEED)
    out: dict = {"k1_per_step": [], "losses": [], "ranks": [], "remesh": {}, "oracle_equal": [],
                 "built_bytes": allocated() - mem0}
    state = {"offset": 0, "oracle": None}

    def fresh_oracle(source):
        return continuation_oracle(source, hidden, e.n_devices, dev)

    def step():
        """One elastic step (and the oracle's); returns its metrics and the
        elastic step's seconds (it ends in its loss's host read)."""
        x, y = next(iter(ds.batches(rows * e.n_devices, 1, seed_offset=state["offset"])))
        state["offset"] += 1
        before = lr.LAUNCHES["masked_average"]
        t0 = time.perf_counter()
        m = e.train_step(x, y)
        seconds = time.perf_counter() - t0
        out["k1_per_step"].append(lr.LAUNCHES["masked_average"] - before)
        out["losses"].append(m.loss)
        out["ranks"].append(e.n_devices)
        if state["oracle"] is not None:
            mo = state["oracle"].train_step(x, y)
            out["oracle_equal"].append(
                mo.loss == m.loss and mo.contributors == m.contributors
                and np.array_equal(state["oracle"].get_flat_params(), e.get_flat_params()))
        return m, seconds

    def remesh(kind: str, alive) -> None:
        for n in alive:
            e.heartbeat(n)
        now["t"] += 60.0 if "drop" in kind else 1.0
        for n in alive:
            e.heartbeat(n)
        old = state["oracle"]
        snap = Snapshot.capture(e.trainer)
        sync()
        t0 = time.perf_counter()
        require(e.poll(), f"{kind}: no re-mesh")
        remesh_s = time.perf_counter() - t0
        if old is not None:
            state["oracle"] = fresh_oracle(old)
            del old
        m, step_s = step()
        out["remesh"].setdefault(kind, {"remesh_s": remesh_s, "first_step_s": remesh_s + step_s,
                                        "ranks": e.n_devices, "loss": m.loss,
                                        "snapshot_bytes": snapshot_bytes(snap)})

    if oracle:
        state["oracle"] = fresh_oracle(e.trainer)
    step(), step()
    remesh("drop", survivors)
    step()
    remesh("rejoin", list(nodes))
    step()
    require(out["ranks"] == [8, 8, 6, 6, 8, 8], f"ranks a step {out['ranks']}")
    require(e.generation == 2, f"generation {e.generation}")
    out["params"] = e.get_flat_params()
    if oracle:
        require(all(out["oracle_equal"]), f"continuation oracle: {out['oracle_equal']}")
        state["oracle"] = None
    if leak_cycles:
        out["mem_after_first_cycle"] = allocated()
        for k in range(leak_cycles):
            remesh("warm_drop" if k == 0 else "drop_again", survivors)
            remesh("rejoin_again", list(nodes))
        out["mem_after_cycles"] = allocated()
    out["trainer"] = e
    return out


def start_train_cluster(root, model: str, dev) -> dict:
    """Start ``train-cluster-master --nodes 2`` and two ``train-cluster-node``
    processes on ``dev`` with the model flags' defaults; returns the run for
    :func:`finish_train_cluster`."""
    d = root / f"train_cluster_{model}"
    d.mkdir()
    steps = str(CLUSTER_TRAIN_STEPS[model])
    master = spawn_role("train-cluster-master", "--nodes", "2", "--model", model,
                        log=d / "master.log")
    procs = [master]
    try:
        lines = read_lines(master, "master listening on ")
        first, seed = lines[0], lines[-1].split()[3]
        for k in range(2):
            procs.append(spawn_role("train-cluster-node", "--seed", seed, "--model", model,
                                    "--steps", steps, "--data-seed", str(k),
                                    "--device", str(dev), log=d / f"node{k}.log"))
    except BaseException:
        stop_all(procs)
        raise
    return {"model": model, "dir": d, "steps": steps, "procs": procs, "first": first,
            "t0": time.perf_counter()}


def stop_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def finish_train_cluster(run: dict, dev) -> dict:
    """Wait for a run of :func:`start_train_cluster`: each node's ``trained
    ...`` line, its rounds applied and its losses (falling, at least one
    round applied, on ``dev``); the master without a CUDA context."""
    model, procs, steps = run["model"], run["procs"], run["steps"]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
        require(all(p.returncode == 0 for p in procs),
                f"train-cluster {model}: exit codes {[p.returncode for p in procs]}: "
                f"{outs}\n{log_tails(run['dir'])}")
    finally:
        stop_all(procs)
    require("master cuda_initialized=False" in outs[0],
            f"train-cluster {model}: the master started CUDA")
    nodes = []
    for out in outs[1:]:
        line = next(ln for ln in out.splitlines() if ln.startswith("trained "))
        rounds = int(line.split("(")[1].split()[0])
        first_loss, last_loss = (float(v) for v in
                                 line.split("loss ")[1].split(";")[0].split(" -> "))
        require(line.startswith(f"trained {steps} steps") and rounds >= 1
                and last_loss < first_loss and (dev.type != "cuda" or "cuda" in line),
                f"train-cluster {model} node: {line}")
        nodes.append({"line": line, "rounds_applied": rounds,
                      "loss_first": first_loss, "loss_last": last_loss})
    return {"model_line": run["first"].strip(), "nodes": nodes,
            "s": time.perf_counter() - run["t0"]}


def elastic_path(dev, card: dict) -> dict:
    """Phase (k): elasticity on the card. Config 5's record; the DP cycle at
    the DP cell's width (``ElasticDPTrainer`` on ``MLP(2048, 2048)``, 4 nodes
    x 2 ranks, 16 rows a rank): K1 once a step, bit-equal to the
    continuation oracle at every step, within ``STEP_TOL`` of the same
    cycle on the CPU, the drop, rejoin and warm drop timed; 5 more
    drop/rejoin cycles with no memory left behind; the int8 + EF cycle's
    residual sum across 8 -> 6 ranks; the compress ladder through
    ``apply_policy_wire``; ``train-cluster-master`` with two
    ``train-cluster-node`` processes on the card (``--model mlp`` and
    ``lm``); ``elastic-demo --family dp --nodes 4``. Returns the K1
    launches of the elastic trainers' steps and the figures."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch import bench_suite
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.train import ElasticDPTrainer

    on_card = dev.type == "cuda"
    count = lr.LAUNCHES
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def k1(n: int) -> int:
        return n if on_card else 0

    out: dict = {"card": card["smi"]}
    launches = {}

    # config 5, both tiers
    zero(count)
    rec = bench_suite.config5_dropout_recovery(device=dev)
    sync()
    print(json.dumps(rec), flush=True)
    launches["config5"] = count["masked_average"]
    flags = [k for k, v in rec.items() if k.endswith("remeshed") and v is not None]
    require(all(rec[k] is True for k in flags) and len(flags) == 6
            and rec["zero_device_control_node"] is True and rec["rounds_completed"] == 10
            and 2.0 <= rec["mean_contributors"] <= 3.0, f"config 5 record {rec}")
    # the DP and ZeRO-1 trainers at one rank and the MoE trainer over 8 and
    # 6 ranks: 5 f32 steps each, one K1 launch a step
    require(launches["config5"] == k1(15) and count["elastic_average_step"] == 0,
            f"config 5: one K1 launch an f32 step: {dict(count)}")
    out["config5"] = {k: rec[k] for k in (
        "rounds_completed", "mean_contributors", "drop_remesh_and_first_step_s",
        "rejoin_remesh_and_first_step_s", "warm_drop_remesh_and_first_step_s",
        "drop_remesh_s", "rejoin_remesh_s", "warm_drop_remesh_s",
        "zero1_drop_remesh_and_first_step_s", "long_context_drop_remesh_and_first_step_s",
        "moe_remeshed", "moe_drop_remesh_and_first_step_s",
        "moe_rejoin_remesh_and_first_step_s", "moe_warm_drop_remesh_and_first_step_s",
        "moe_post_rejoin_loss")}

    # the DP cycle at the DP cell's width, against the continuation oracle
    zero(count)
    cyc = elastic_dp_cycle(dev, DP_HIDDEN, DP_ROWS, oracle=True, leak_cycles=LEAK_CYCLES)
    e = cyc.pop("trainer")
    steps = len(cyc["k1_per_step"])
    require(cyc["k1_per_step"] == [k1(1)] * steps,
            f"K1 once an elastic step: {cyc['k1_per_step']}")
    launches["dp_cycle"] = sum(cyc["k1_per_step"])
    require(e.param_count == DP_PARAMS and all(math.isfinite(v) for v in cyc["losses"]),
            f"DP cycle: {e.param_count} params, losses {cyc['losses']}")
    grown = cyc["mem_after_cycles"] - cyc["mem_after_first_cycle"]
    require(grown <= LEAK_BYTES, f"{LEAK_CYCLES} re-mesh cycles left {grown} bytes allocated")
    # one copy of the weights: the wrapper keeps no template on the card
    require(cyc["built_bytes"] < 1.5 * 4 * DP_PARAMS,
            f"the elastic trainer holds {cyc['built_bytes']} bytes once built "
            f"({4 * DP_PARAMS} bytes of weights)")
    cpu = elastic_dp_cycle(torch.device("cpu"), DP_HIDDEN, DP_ROWS)
    cpu_err = float(np.abs(cyc["params"] - cpu["params"]).max())
    require(np.allclose(cyc["params"], cpu["params"], **STEP_TOL_KW),
            f"DP cycle on the card vs the CPU: max abs {cpu_err}")
    del cpu
    out["dp_cycle"] = {"losses": cyc["losses"][:6], "ranks": cyc["ranks"][:6],
                       "remesh": cyc["remesh"], "oracle": "bit-equal at every step",
                       "vs_cpu_max_abs": cpu_err, "memory_grown_bytes": grown,
                       "memory_after_first_cycle": cyc["mem_after_first_cycle"],
                       "built_bytes": cyc["built_bytes"],
                       "steps": steps}
    print(f"elastic DP trainer built: {cyc['built_bytes']} bytes on the card for "
          f"{4 * DP_PARAMS} bytes of weights", flush=True)
    for kind, r in cyc["remesh"].items():
        print(f"elastic DP re-mesh ({kind}, -> {r['ranks']} ranks, MLP{DP_HIDDEN}, "
              f"{card['name']}, {card['power_limit']}): re-mesh {r['remesh_s'] * 1e3:.3f} ms, "
              f"with its first step {r['first_step_s'] * 1e3:.3f} ms, snapshot "
              f"{r['snapshot_bytes']} bytes", flush=True)

    # the compress ladder through the policy wire, on the same trainer
    zero(count)
    ladder = {}
    ds = mnist_like(seed=SEED)
    for wire, mode in (("f16", "bf16"), ("int8", "int8"), ("", None)):
        require(e.apply_policy_wire(wire) and e.compress_mode == mode,
                f"policy wire {wire!r}: compress {e.compress_mode}")
        x, y = next(iter(ds.batches(DP_ROWS * e.n_devices, 1, seed_offset=100)))
        m = e.train_step(x, y)
        require(math.isfinite(m.loss) and m.contributors == e.n_devices, f"{wire!r} step {m}")
        ladder[wire or "inherit"] = {"compress": mode, "loss": m.loss}
    sync()
    require(count["masked_average"] == k1(1), f"ladder: one f32 step's K1: {dict(count)}")
    launches["ladder"] = count["masked_average"]
    out["ladder"] = ladder
    del e

    # int8 + EF: the residual's sum across 8 -> 6 ranks
    zero(count)
    now = {"t": 0.0}
    nodes = {n: list(range(n * ELASTIC_PER_NODE, (n + 1) * ELASTIC_PER_NODE))
             for n in range(ELASTIC_NODES)}
    ei = ElasticDPTrainer(MLP(hidden=DP_HIDDEN, seed=SEED, device=dev), nodes,
                          compress="int8", error_feedback=True, clock=lambda: now["t"],
                          device=dev)
    x, y = next(iter(ds.batches(DP_ROWS * 8, 1, seed_offset=200)))
    ei.train_step(x, y, valid=[1.0] * 7 + [0.0])
    before = ei.trainer._ef.double().sum(0).cpu().numpy()
    for n in nodes:
        ei.heartbeat(n)
    now["t"] += 60.0
    for n in nodes:
        if n != ELASTIC_LOST:
            ei.heartbeat(n)
    require(ei.poll() and ei.n_devices == 6 and ei.trainer.error_feedback
            and ei.trainer.compress == "int8", "int8 + EF: re-mesh to 6 ranks")
    after = ei.trainer._ef.double().sum(0).cpu().numpy()
    ef_err = float(np.abs(after - before).max() / np.abs(before).max())
    require(ef_err <= 1e-6, f"int8 + EF residual sum across 8 -> 6: {ef_err} of max|sum|")
    x, y = next(iter(ds.batches(DP_ROWS * 6, 1, seed_offset=201)))
    m = ei.train_step(x, y)
    sync()
    require(math.isfinite(m.loss) and count["masked_average"] == 0,
            f"int8 + EF step at 6 ranks {m}, {dict(count)}")
    out["int8_ef"] = {"residual_sum_err_of_max": ef_err, "loss_at_6": m.loss}
    del ei
    if on_card:
        torch.cuda.empty_cache()

    # the training cluster over TCP, its learners on the card: the MLP's and
    # the LM's clusters side by side (each a master and two node processes)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    runs = []
    try:
        for model in ("mlp", "lm"):
            runs.append(start_train_cluster(root, model, dev))
        for run in runs:
            res = finish_train_cluster(run, dev)
            print(res["model_line"], flush=True)
            print("\n".join(n["line"] for n in res["nodes"]), flush=True)
            out[f"train_cluster_{run['model']}"] = res
    finally:
        for run in runs:
            stop_all(run["procs"])
        shutil.rmtree(root, ignore_errors=True)

    # elastic-demo on the card: 30 f32 steps, one K1 launch each
    zero(count)
    rc, text = run_cli(["elastic-demo", "--family", "dp", "--nodes", "4",
                        *([] if on_card else ["--device", "cpu"])])
    sync()
    require(rc == 0 and "re-meshed to 3 nodes / 6 ranks" in text
            and "re-meshed to 4 nodes / 8 ranks" in text and "final generation 2" in text,
            f"elastic-demo: rc {rc}\n{text}")
    require(count["masked_average"] == k1(30), f"elastic-demo: {dict(count)}")
    launches["elastic_demo"] = count["masked_average"]
    out["elastic_demo"] = [ln for ln in text.splitlines() if "re-meshed" in ln]
    out["launches_by_part"] = launches
    out["launches"] = sum(launches.values())
    return out


# -- phase (l): chaos -----------------------------------------------------------


def chaos_schedule(nodes: int, steps: int) -> tuple[int, dict, list]:
    """The first seed from 0 whose ``membership_schedule(seed, nodes,
    steps)`` (the JAX defaults ``flap_p`` 0.03, ``flap_len`` (3, 8)) changes
    the live set at least twice; returns it, the schedule and the live
    nodes at each step."""
    from akka_allreduce_tpu_torch.control.chaos import membership_schedule

    everyone = tuple(range(nodes))
    for seed in range(1000):
        sched = membership_schedule(seed, nodes, steps)
        lives = [tuple(n for n in everyone if n not in sched.get(s, ())) for s in range(steps)]
        if sum(a != b for a, b in zip([everyone, *lives], lives)) >= 2:
            return seed, sched, lives
    raise RuntimeError("no seed below 1000 re-meshes twice")


def elastic_schedule_run(dev, lives, *, oracle: bool) -> dict:
    """``ElasticDPTrainer`` on ``MLP(DP_HIDDEN)`` over 4 nodes x 2 virtual
    ranks, ``DP_ROWS`` rows a rank, f32, one step at each entry of
    ``lives`` with the membership set to it first (``apply_membership``,
    as the TCP cluster's view drives it). With ``oracle``, a fresh
    ``DPTrainer`` restored from a ``Snapshot`` of the one before it at every
    re-mesh (``continuation_oracle``, as in elastic_dp_cycle) takes each step beside
    it, compared bit for bit. Returns the K1 launches a step, each re-mesh's
    seconds alone and with its first step, and the final parameters."""
    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.train import ElasticDPTrainer

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    nodes = {n: list(range(n * ELASTIC_PER_NODE, (n + 1) * ELASTIC_PER_NODE))
             for n in range(ELASTIC_NODES)}
    e = ElasticDPTrainer(MLP(hidden=DP_HIDDEN, seed=SEED, device=dev), nodes, device=dev)
    ds = mnist_like(seed=SEED)
    orc = continuation_oracle(e.trainer, DP_HIDDEN, e.n_devices, dev) if oracle else None
    out: dict = {"k1_per_step": [], "ranks": [], "losses": [], "remesh": [], "equal": []}
    for s, live in enumerate(lives):
        remesh_s = None
        if live != e.member_nodes:
            sync()
            t0 = time.perf_counter()
            require(e.apply_membership(live), f"step {s}: no re-mesh to {live}")
            remesh_s = time.perf_counter() - t0
            if orc is not None:
                orc = continuation_oracle(orc, DP_HIDDEN, e.n_devices, dev)
        x, y = next(iter(ds.batches(DP_ROWS * e.n_devices, 1, seed_offset=s)))
        before = lr.LAUNCHES["masked_average"]
        t0 = time.perf_counter()
        m = e.train_step(x, y)  # ends in its loss's host read
        step_s = time.perf_counter() - t0
        out["k1_per_step"].append(lr.LAUNCHES["masked_average"] - before)
        out["ranks"].append(e.n_devices)
        out["losses"].append(m.loss)
        if remesh_s is not None:
            out["remesh"].append({"step": s, "to": list(live), "ranks": e.n_devices,
                                  "remesh_s": remesh_s, "first_step_s": remesh_s + step_s})
        if orc is not None:
            mo = orc.train_step(x, y)
            out["equal"].append(mo.loss == m.loss and mo.contributors == m.contributors
                                and np.array_equal(orc.get_flat_params(), e.get_flat_params()))
    out["generation"] = e.generation
    out["params"] = e.get_flat_params()
    return out


def zero1_schedule_run(dev, lives) -> dict:
    """The zoo's ``zero1`` trainer (``Zero1DPTrainer``, SGD at the zoo's
    rate with momentum 0.9, each rank's momentum on its shard) in an
    ``ElasticTrainer`` on ``MLP(DP_HIDDEN)`` over 4 nodes x 2 virtual
    ranks, ``DP_ROWS`` rows a rank, f32, one step at each entry of
    ``lives``. Beside it one unsharded ``torch.optim.SGD`` with the same
    rate and momentum over the whole batch, which never re-meshes, takes
    each step. At every re-mesh the rebuilt trainer's gathered momentum must
    equal the old one's bit for bit and be nonzero (a re-mesh that lost the
    sharded state fails here); after every step its parameters and momentum
    must be within ``STEP_TOL`` (the momentum's atol scaled by its largest
    entry) of the unsharded optimizer's. Returns the K1 launches a step, each
    re-mesh's seconds and the largest differences."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from akka_allreduce_tpu_torch._device import ieee_f32
    from akka_allreduce_tpu_torch.binder.api import leaf_order
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.train import ElasticTrainer, Zero1DPTrainer
    from akka_allreduce_tpu_torch.train.zoo import _ZERO1_LR

    def sgd(params):
        return torch.optim.SGD(params, lr=_ZERO1_LR, momentum=0.9)

    def factory(mesh, compress=None):  # the zoo's _make_zero1 at the DP cell's width
        return Zero1DPTrainer(MLP(hidden=DP_HIDDEN, seed=SEED, device=mesh.device), mesh,
                              optimizer=sgd, compress=compress,
                              error_feedback=compress is not None)

    def momentum(t) -> torch.Tensor:
        """The trainer's momentum, its ranks' shards gathered, unpadded."""
        shards = t.checkpoint_capture()["opt_state"]["trace"]
        return torch.cat([m.reshape(-1) for m in shards])[:t.param_count].clone()

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    nodes = {n: list(range(n * ELASTIC_PER_NODE, (n + 1) * ELASTIC_PER_NODE))
             for n in range(ELASTIC_NODES)}
    e = ElasticTrainer(factory, nodes, device=dev)
    ref = MLP(hidden=DP_HIDDEN, seed=SEED, device=dev)
    names = leaf_order(ref)
    named = dict(ref.named_parameters())
    ref_opt = sgd([named[n] for n in names])
    ds = mnist_like(seed=SEED)
    out: dict = {"k1_per_step": [], "remesh": [], "param_err": 0.0, "momentum_err": 0.0}
    for s, live in enumerate(lives):
        if live != e.member_nodes:
            before = momentum(e.trainer)
            sync()
            t0 = time.perf_counter()
            require(e.apply_membership(live), f"zero1 step {s}: no re-mesh to {live}")
            remesh_s = time.perf_counter() - t0
            after = momentum(e.trainer)
            require(torch.equal(before, after) and float(before.abs().max()) > 0,
                    f"zero1 re-mesh at step {s}: the sharded momentum was not carried "
                    f"(max |m| {float(before.abs().max())} -> {float(after.abs().max())})")
            out["remesh"].append({"step": s, "to": list(live), "ranks": e.n_devices,
                                  "remesh_s": remesh_s,
                                  "momentum_max_abs": float(before.abs().max())})
        x, y = next(iter(ds.batches(DP_ROWS * e.n_devices, 1, seed_offset=s)))
        k1 = lr.LAUNCHES["masked_average"]
        m = e.train_step(x, y)
        out["k1_per_step"].append(lr.LAUNCHES["masked_average"] - k1)
        require(math.isfinite(m.loss), f"zero1 step {s}: loss {m.loss}")
        ref_opt.zero_grad()
        with ieee_f32():
            F.cross_entropy(ref(torch.as_tensor(x, device=dev)),
                            torch.as_tensor(y, device=dev).long()).backward()
        ref_opt.step()
        with torch.no_grad():
            want_p = torch.cat([named[n].reshape(-1) for n in names]).cpu().numpy()
            want_m = torch.cat([ref_opt.state[named[n]]["momentum_buffer"].reshape(-1)
                                for n in names]).cpu().numpy()
        got_p, got_m = e.get_flat_params(), momentum(e.trainer).cpu().numpy()
        scale = float(np.abs(want_m).max())
        require(np.allclose(got_p, want_p, **STEP_TOL_KW)
                and np.allclose(got_m, want_m, rtol=STEP_TOL_KW["rtol"],
                                atol=STEP_TOL_KW["atol"] * scale),
                f"zero1 step {s}: params {np.abs(got_p - want_p).max()}, momentum "
                f"{np.abs(got_m - want_m).max()} of max {scale}")
        out["param_err"] = max(out["param_err"], float(np.abs(got_p - want_p).max()))
        out["momentum_err"] = max(out["momentum_err"], float(np.abs(got_m - want_m).max()))
    out["generation"] = e.generation
    out["loss"] = m.loss
    return out


def run_drills(root, drills, *, dev, width: int = DRILL_WIDTH,
               timeout: float = 480) -> list[dict]:
    """Run the drills (``(name, argv)`` pairs), at most ``width`` at a time,
    each started as soon as a running one ends, in the order given: each
    ``python -m akka_allreduce_tpu_torch <name> <argv>`` with its nodes on
    ``dev``, its stderr (and its roles') in a log and its own process
    group, killed whole if it outlives ``timeout``; each must exit 0 with an
    empty ``failures`` list in its summary JSON (its last stdout line).
    Returns the summaries in the order given, each with its wall seconds,
    the drills that ran beside it for some of its time (``with``: its
    readings were taken under their load) and its output directory."""
    import signal
    import subprocess

    pending, runs = list(drills), []

    def start(name, argv):
        d = root / "_".join((name, *argv[:2]))
        d.mkdir()
        cli = [name, *argv, "--out-dir", str(d / "out"), "--device", str(dev)]
        with open(d / "drill.log", "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "akka_allreduce_tpu_torch", *cli],
                stdout=subprocess.PIPE, stderr=err, text=True, start_new_session=True)
        runs.append({"name": name, "argv": list(argv), "dir": d, "cli": cli,
                     "proc": proc, "t0": time.perf_counter()})

    try:
        # a drill prints a few lines before its summary, far below a pipe's
        # buffer, so polling cannot stall one
        while pending or any("t1" not in r for r in runs):
            while pending and sum("t1" not in r for r in runs) < width:
                start(*pending.pop(0))
            now = time.perf_counter()
            for r in runs:
                if "t1" not in r and (r["proc"].poll() is not None
                                      or now - r["t0"] > timeout):
                    r["t1"] = now
            time.sleep(0.1)
        for r in runs:
            r["wall_s"] = r["t1"] - r["t0"]
            r["stdout"] = r["proc"].communicate(timeout=5)[0] if r["proc"].poll() is not None else ""
    finally:
        for r in runs:
            try:
                os.killpg(r["proc"].pid, signal.SIGKILL)  # the drill's roles, if any are left
            except ProcessLookupError:
                pass
            r["proc"].wait(timeout=30)
    out = []
    for r in runs:
        lines = r["stdout"].strip().splitlines()
        tail = "\n".join((r["dir"] / "drill.log").read_text().splitlines()[-25:])
        require(r["proc"].returncode == 0 and lines,
                f"{' '.join(r['cli'])}: rc {r['proc'].returncode} after {r['wall_s']:.1f} s "
                f"(limit {timeout} s)\n{r['stdout'][-3000:]}\n{tail}")
        summary = json.loads(lines[-1])
        require(summary.get("failures", []) == [], f"{r['name']}: {summary}")
        summary["wall_s"] = r["wall_s"]
        summary["with"] = [" ".join((o["name"], *o["argv"][:2])) for o in runs
                           if o is not r and o["t0"] < r["t1"] and r["t0"] < o["t1"]]
        print(json.dumps({"drill": r["name"], "argv": r["argv"], **summary}), flush=True)
        summary["out_dir"] = str(r["dir"] / "out")
        out.append(summary)
    return out


def chaos_path(dev, card: dict) -> dict:
    """Phase (l): the chaos tools on the card. (l1) ``ElasticDPTrainer`` at
    the DP cell's width under the first seeded ``membership_schedule`` that
    re-meshes twice: K1 once a step, every step bit-equal to the
    continuation oracle, the final parameters within ``STEP_TOL`` of the
    same schedule on the CPU, each re-mesh timed; ``leader_kill_step``
    printed beside the schedule. (l2) ``chaos-train --family dp`` and
    ``zero1`` (depth cut: ``CHAOS_TRAIN_DEPTH``), the nodes on the card: the victim ends
    with exit 23, every survivor re-meshes within the loss band, K1 once an
    f32 step in each node, neither the drill's process nor the master with
    a CUDA context. (l3) the ``chaos`` drill at config 1's size. (l4)
    ``LocalAllreduceSystem`` under a spec that drops, duplicates, reorders
    and corrupts, on the card against the CPU: every flush bit-equal, the
    event log byte-identical. (l5) ``chaos-adapt``, ``chaos-failover``,
    ``chaos-gossip`` and ``chaos-scale`` with the JAX Makefile's levers.
    The drills run four at a time (each its own cluster on its own ports),
    each started as soon as one ends. Then ``train-mlp --profile-dir``. Returns K1's
    launches in this process and the figures."""
    import shutil
    import statistics
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.config import ChaosConfig
    from akka_allreduce_tpu_torch.control.chaos import CRASH_EXIT_CODE, leader_kill_step
    from akka_allreduce_tpu_torch.control.local import local_engine
    from akka_allreduce_tpu_torch.ops import local_reduce as lr

    count = lr.LAUNCHES
    out: dict = {"card": card["smi"]}
    launches = {}

    # (l1) the elastic DP trainer under the seeded membership schedule
    seed, sched, lives = chaos_schedule(ELASTIC_NODES, CHAOS_STEPS)
    kill = leader_kill_step(seed, CHAOS_STEPS)
    print(f"membership schedule (seed {seed}, {ELASTIC_NODES} nodes, {CHAOS_STEPS} steps): "
          f"{ {s: sorted(v) for s, v in sorted(sched.items())} }; leader_kill_step {kill}",
          flush=True)
    zero(count)
    run = elastic_schedule_run(dev, lives, oracle=True)
    torch.cuda.synchronize(dev)
    require(run["k1_per_step"] == [1] * CHAOS_STEPS, f"K1 once a step: {run['k1_per_step']}")
    # the oracle's steps launch K1 too (as many again); the path's are the elastic steps'
    require(count["masked_average"] == 2 * CHAOS_STEPS, f"K1 launches: {dict(count)}")
    launches["schedule"] = sum(run["k1_per_step"])
    require(all(run["equal"]) and len(run["equal"]) == CHAOS_STEPS,
            f"continuation oracle: {run['equal']}")
    require(len(run["remesh"]) >= 2 and run["generation"] == len(run["remesh"])
            and all(math.isfinite(v) for v in run["losses"]), f"schedule run: {run['remesh']}")
    cpu = elastic_schedule_run(torch.device("cpu"), lives, oracle=False)
    cpu_err = float(np.abs(run["params"] - cpu["params"]).max())
    require(np.allclose(run["params"], cpu["params"], **STEP_TOL_KW),
            f"schedule run on the card vs the CPU: max abs {cpu_err}")
    for r in run["remesh"]:
        print(f"chaos re-mesh at step {r['step']} (-> nodes {r['to']}, {r['ranks']} ranks, "
              f"MLP{DP_HIDDEN}, {card['name']}, {card['power_limit']}): re-mesh "
              f"{r['remesh_s'] * 1e3:.3f} ms, with its first step "
              f"{r['first_step_s'] * 1e3:.3f} ms", flush=True)
    out["schedule"] = {"seed": seed, "silent": {str(s): sorted(v) for s, v in sched.items()},
                       "leader_kill_step": kill, "ranks": run["ranks"],
                       "losses": [run["losses"][0], run["losses"][-1]],
                       "remesh": run["remesh"], "oracle": "bit-equal at every step",
                       "vs_cpu_max_abs": cpu_err}
    del run, cpu
    # ZeRO-1 under the same schedule: the sharded momentum carried at every re-mesh
    zero(count)
    z1 = zero1_schedule_run(dev, lives)
    torch.cuda.synchronize(dev)
    require(z1["k1_per_step"] == [1] * CHAOS_STEPS and count["masked_average"] == CHAOS_STEPS
            and len(z1["remesh"]) == len(out["schedule"]["remesh"]),
            f"zero1 schedule: K1 {z1['k1_per_step']}, re-meshes {z1['remesh']}")
    launches["schedule_zero1"] = sum(z1["k1_per_step"])
    for r in z1["remesh"]:
        print(f"zero1 re-mesh at step {r['step']} (-> nodes {r['to']}, {r['ranks']} ranks, "
              f"MLP{DP_HIDDEN}, {card['name']}, {card['power_limit']}): "
              f"{r['remesh_s'] * 1e3:.3f} ms, momentum (max |m| {r['momentum_max_abs']:.6g}) "
              "carried bit for bit", flush=True)
    out["schedule_zero1"] = {k: z1[k] for k in ("remesh", "param_err", "momentum_err",
                                                 "generation", "loss")}
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    try:
        # (l2) chaos-train, the nodes' trainers on the card, beside (l3) the
        # chaos drill at config 1's size, the nodes' payloads on the card
        levers = ("--uring", "--intra-chunk", "1048576", "--congestion")
        # the longest first, so that the short ones fill in behind them
        drills = [
            ("chaos-failover", ("--seed", "1234", "--streams", "2", "--gossip",
                                *CHAOS_RESTORE_DEPTH, *levers)),
            ("chaos-recover", ("--seed", "1234", "--streams", "2", "--gossip",
                               *CHAOS_RESTORE_DEPTH, *levers)),
            ("chaos-scale", ("--seed", "1234", "--grid", CHAOS_SCALE_GRID, "--line-shards",
                             str(CHAOS_SCALE_SHARDS), "--streams", "2", *levers)),
            ("chaos-adapt", ("--seed", "1234", "--streams", "2", "--gossip", *levers)),
            ("chaos-train", ("--family", "dp", *CHAOS_TRAIN_DEPTH)),
            ("chaos-train", ("--family", "zero1", *CHAOS_TRAIN_DEPTH)),
            ("chaos-gossip", ("--seed", "1234", "--streams", "2", *levers)),
            ("chaos", ("--size", str(CLUSTER_FLOATS), "--chunk", str(CLUSTER_CHUNK),
                       "--seed", "1234", "--rounds", str(CHAOS_ROUNDS))),
        ]
        # On an H100 host a drill is bound by its processes' start-up, not
        # its rounds (chaos-train dp: 45.9 of 50.6 s before its first round;
        # import torch alone 6.7 s): one after another the eight took 422.6
        # s and the script 1,063 s of its 1,200. Run DRILL_WIDTH at a time
        # their start-ups overlap (three groups of three took 57.7-71.8 s; a
        # drill's wall 0.92-1.23x its wall alone, on another host), and a
        # drill starts as soon as one ends (the eight: 114.6 s four at a
        # time, 126.4 s five at a time: their start-ups share 8 CPU cores).
        # A drill's readings are taken beside its siblings' load, which its
        # summary line names (``with``).
        summaries = {}
        t0 = time.perf_counter()
        for (name, argv), s in zip(drills, run_drills(root, drills, dev=dev)):
            summaries["_".join((name, *argv[:2])) if name == "chaos-train" else name] = s
        out["drills_s"] = time.perf_counter() - t0
        for family in ("dp", "zero1"):
            s = summaries[f"chaos-train_--family_{family}"]
            require(s["victim_exit"] == CRASH_EXIT_CODE and s["master_done"]
                    and s["parent_cuda_initialized"] is False
                    and s["master_cuda_initialized"] is False, f"chaos-train {family}: {s}")
            for k, node in s["node_summaries"].items():
                require(node["remeshes"] >= 1 and node["device"].startswith("device=cuda")
                        and node["k1_launches"] == node["steps"],
                        f"chaos-train {family} node {k}: {node}")
                c, rec = s["continuity"][k], s["crash_to_first_post_remesh_step"].get(k, {})
                print(f"chaos-train {family} survivor {k}: {node['device']}; {node['steps']} "
                      f"steps, {node['k1_launches']} K1 launches, {node['remeshes']} re-meshes "
                      f"(generation {node['generation']}); loss median {c['pre_median']} before "
                      f"the kill -> {c['post_median']} after (bar {c['bar']}); crash to first "
                      f"post-re-mesh step {rec.get('from_victim_last_step_s')} s", flush=True)
            out[f"chaos_train_{family}"] = {k: s[k] for k in (
                "wall_s", "victim_exit", "survivor_rounds", "continuity", "node_summaries",
                "crash_to_first_post_remesh_step")}
        s = summaries.pop("chaos")
        lat = [r["latency_s"] for r in jsonl(Path(s["out_dir"]) / "rounds.jsonl")
               if r.get("kind") == "round"]
        require(s["rounds_completed"] > 0 and s["master_done"] and lat, f"chaos: {s}")
        out["chaos"] = {"wall_s": s["wall_s"], "rounds_completed": s["rounds_completed"],
                        "chaos_events": s["chaos_events"], "node_exits": s["node_exits"],
                        "median_round_ms": statistics.median(lat) * 1e3}
        print(f"chaos drill at {CLUSTER_FLOATS} floats ({card['name']}, "
              f"{card['power_limit']}): {s['rounds_completed']} rounds under "
              f"{s['chaos_events']}, median round {out['chaos']['median_round_ms']:.3f} ms",
              flush=True)
        for name in ("chaos-adapt", "chaos-recover", "chaos-failover", "chaos-gossip",
                     "chaos-scale"):
            s = summaries[name]
            s.pop("out_dir")
            out[name.replace("-", "_")] = s

        # (l4) the host engine's router under chaos, on the card against the CPU
        zero(count)
        spec = ChaosConfig(seed=CHAOS_LOCAL_SEED, spec=CHAOS_LOCAL_SPEC)
        runs = [local_engine(CLUSTER_FLOATS, chunk=CHAOS_LOCAL_CHUNK, rounds=CHAOS_LOCAL_ROUNDS,
                             th=0.75, device=d, keep_outputs=True, chaos=spec).run()
                for d in (dev, torch.device("cpu"))]
        logs = [r.system.router.chaos.event_log_jsonl() for r in runs]
        require(logs[0] == logs[1] and runs[0].rounds >= 1
                and set(runs[0].system.router.chaos.counts()) == {
                    "drop", "duplicate", "reorder", "corrupt"},
                f"local chaos: logs equal {logs[0] == logs[1]}, rounds {runs[0].rounds}, "
                f"{runs[0].system.router.chaos.counts()}")
        flushes = engine_flushes_equal(*runs)
        require(count["masked_average"] == 0, f"local chaos launched K1: {dict(count)}")
        out["local_chaos"] = {"rounds": runs[0].rounds, "flushes_equal": flushes,
                              "events": runs[0].system.router.chaos.counts(),
                              "seconds": runs[0].seconds, "cpu_seconds": runs[1].seconds}
        print(f"local engine under chaos ({CLUSTER_FLOATS} floats, {card['name']}): "
              f"{runs[0].rounds} rounds, {flushes} flushes bit-equal to the CPU's, "
              f"event log byte-identical ({len(logs[0].splitlines())} events)", flush=True)
        del runs

        # train-mlp --profile-dir on the card: the trace holds K1
        zero(count)
        prof = root / "profile"
        rc, text = run_cli(["train-mlp", "--steps", "5", "--profile-dir", str(prof)])
        torch.cuda.synchronize(dev)
        traces = list(prof.glob("*.json"))
        require(rc == 0 and len(traces) == 1 and "masked_average" in traces[0].read_text(),
                f"train-mlp --profile-dir: rc {rc}, {traces}\n{text}")
        require(count["masked_average"] == 5, f"train-mlp: one K1 a step: {dict(count)}")
        launches["train_mlp_profile"] = count["masked_average"]
        out["train_mlp_profile"] = {"trace_bytes": traces[0].stat().st_size,
                                    "line": text.strip().splitlines()[-1]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches_by_part"] = launches
    out["launches"] = sum(launches.values())
    return out


def int8_serving(dev, card: dict) -> dict:
    """(m1) The flagship LM (bf16, B 8, prompt 2048) served from an int8 KV
    cache: the cache's bytes against the bf16 cache's; the prefill's K4
    launches (once a layer: the dequantize branch reaches ``local_attention``)
    and its logits against the plain attention over the same dequantized
    cache; no K4 launch in decode; one decode step of
    ``quantized_cache_attention`` on the card against the CPU; the greedy
    tokens and prefill logits of the int8 and the bf16 cache; and
    ``lm-generate --cache-quant int8`` beside ``lm-generate`` (both ``--bf16``
    at the flagship), their records printed. Returns K4's launches and the
    figures."""
    from unittest import mock

    import torch

    from akka_allreduce_tpu_torch.models import LMGenerator, SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_attention as la

    count = fa.LAUNCHES
    n_layers, hd = LM["n_layers"], LM["d_model"] // LM["n_heads"]
    x, _ = next(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED).batches(LM_BATCH, 1))
    tokens = torch.from_numpy(x).to(dev)
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, seed=SEED, device=dev)
    gen8 = LMGenerator(model, max_len=LM_SEQ + LM_GEN, cache_quant="int8")
    gen16 = LMGenerator(model, max_len=LM_SEQ + LM_GEN)
    out: dict = {}
    launches = 0

    def new_cache(gen):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cache = gen.init_cache(LM_BATCH)
        torch.cuda.synchronize()
        return cache, torch.cuda.memory_allocated() - before

    c8, bytes8 = new_cache(gen8)
    c16, bytes16 = new_cache(gen16)
    out["cache_bytes"] = {"int8": bytes8, "bf16": bytes16, "ratio": bytes8 / bytes16,
                          "expected_ratio": (hd + 4) / (2 * hd)}
    require(abs(bytes8 / bytes16 - (hd + 4) / (2 * hd)) < 0.005,
            f"int8 cache bytes {bytes8} vs bf16 {bytes16}")
    require(c8.k[0].dtype == torch.int8 and c8.k_scale[0].dtype == torch.float32,
            "int8 cache dtypes")

    # the prefill: the dequantize branch, K4 once a layer
    zero(count)
    with torch.no_grad():
        logits8 = model(tokens, c8)
    torch.cuda.synchronize()
    out["prefill_launches"] = dict(count)
    require(count["flash_attention"] == count["flash_attention_wgmma"] == n_layers
            and count["flash_attention_3xtf32"] == 0, f"int8 prefill: K4 launches {count}")
    launches += count["flash_attention_wgmma"]
    with mock.patch.object(la, "flash_attention", lambda q, k, v, causal, sm_scale:
                           fa.flash_attention_reference(q, k, v, causal=causal,
                                                        sm_scale=sm_scale)), torch.no_grad():
        plain = model(tokens, gen8.init_cache(LM_BATCH))
    torch.cuda.synchronize()
    require(count["flash_attention"] == n_layers, "the plain prefill launched K4")
    scale = float(plain.abs().max())
    err = float((logits8 - plain).abs().max()) / scale
    out["prefill_vs_plain_of_max_logit"] = err
    require(bool(torch.isfinite(logits8).all()) and err <= FLASH_TOL["bfloat16"],
            f"int8 prefill vs the plain attention: {err} of max|logit| {scale}")
    del plain

    # decode: the fused branch over the int8 slots, no K4
    zero(count)
    tok = torch.argmax(logits8[:, -1], dim=-1)[:, None]
    with torch.no_grad():
        for _ in range(4):
            tok = torch.argmax(model(tok, c8)[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    require(all(n == 0 for n in count.values()), f"int8 decode launched K4: {count}")
    live = c8.index
    q = torch.randn((LM_BATCH, 1, LM["n_heads"], hd), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev, dtype=torch.bfloat16)  # as decode's q
    args = (q, c8.k[0][:, :live], c8.k_scale[0][:, :live], c8.v[0][:, :live],
            c8.v_scale[0][:, :live])
    got = la.quantized_cache_attention(*args, q_offset=live - 1).cpu()
    want = la.quantized_cache_attention(*(a.cpu() for a in args), q_offset=live - 1)
    qca_err = float((got - want).abs().max()) / float(want.abs().max())
    out["decode_step_card_vs_cpu_of_max"] = qca_err
    require(qca_err <= QCA_TOL, f"quantized_cache_attention card vs CPU: {qca_err}")
    del c8, c16, args

    # the int8 cache against the bf16 one: greedy tokens, prefill logits
    zero(count)
    out8 = gen8.generate(tokens, LM_GEN)
    out16 = gen16.generate(tokens, LM_GEN)
    with torch.no_grad():
        logits16 = model(tokens, gen16.init_cache(LM_BATCH))
    torch.cuda.synchronize()
    require(count["flash_attention_wgmma"] == count["flash_attention"] == 3 * n_layers,
            f"two generations and a prefill: K4 launches {count}")
    launches += count["flash_attention_wgmma"]
    diff = (logits8 - logits16).abs()
    out["greedy_agreement"] = float((out8 == out16).float().mean())
    out["first_token_agreement"] = float((out8[:, 0] == out16[:, 0]).float().mean())
    out["logits_int8_vs_bf16"] = {"max": float(diff.max()), "mean": float(diff.mean()),
                                  "max_abs_logit": float(logits16.abs().max())}
    del logits8, logits16, diff, model, gen8, gen16
    torch.cuda.empty_cache()

    # the command, int8 beside bf16, at the flagship
    argv = ["lm-generate", "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
            "--heads", str(LM["n_heads"]), "--layers", str(n_layers), "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_SEQ), "--gen", str(LM_GEN), "--bf16"]
    for name, extra in (("int8", ["--cache-quant", "int8"]), ("bf16", [])):
        zero(count)
        rc, text = run_cli(argv + extra)
        torch.cuda.synchronize()
        rec = json.loads(text.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        require(rc == 0 and rec["prefill_ms"] > 0 and rec["ms_per_token"] > 0
                and rec["cache_quant"] == (extra[-1] if extra else None)
                and count["flash_attention_wgmma"] == count["flash_attention"] > 0,
                f"lm-generate {name}: rc {rc}, {rec}, {count}")
        launches += count["flash_attention_wgmma"]
        out[f"lm_generate_{name}"] = {k: rec[k] for k in (
            "prefill_ms", "ms_per_token", "tokens_per_s", "device", "power_limit")}
    torch.cuda.empty_cache()
    r8, r16 = out["lm_generate_int8"], out["lm_generate_bf16"]
    print(f"int8 KV cache (B {LM_BATCH}, prompt {LM_SEQ}, bf16, {card['name']}, "
          f"{card['power_limit']}): cache {bytes8} B vs bf16 {bytes16} B "
          f"({bytes8 / bytes16:.4f}x); prefill {r8['prefill_ms']:.3f} ms vs "
          f"{r16['prefill_ms']:.3f} ms; decode {r8['ms_per_token']:.3f} vs "
          f"{r16['ms_per_token']:.3f} ms/token; greedy agreement "
          f"{out['greedy_agreement']:.3f}; logits max |diff| "
          f"{out['logits_int8_vs_bf16']['max']:.4f}, mean "
          f"{out['logits_int8_vs_bf16']['mean']:.5f}", flush=True)
    out["launches"] = {"flash_attention_bf16": launches}
    return out


def moe_training(dev, card: dict) -> dict:
    """(m2) The MoE LM at ``bench-mfu --workload moe``'s defaults: one
    ``train_step`` with K4's forward and backward once a layer; a chain
    whose loss falls (the dropped fraction printed); two steps under
    ``torch.profiler``; the peak memory; the floor from
    ``transformer_train_flops`` on the active parameters; ``bench-mfu
    --workload moe`` and ``--mu-bf16``, their records printed. Then at a
    small width three steps on the card against the same steps on the CPU,
    and the scatter dispatch against the einsum on the card. Returns K4's
    launches and the figures."""
    from unittest import mock

    import torch

    from akka_allreduce_tpu_torch.models import lm_copy_task
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.train import MoETrainer
    from akka_allreduce_tpu_torch.utils import moe_active_params, transformer_train_flops

    count = fa.LAUNCHES
    n_layers = MOE["n_layers"]
    out: dict = {}
    launches = {"flash_attention_bf16": 0, "flash_attention_bwd_bf16": 0}

    def take(what: str, steps: int) -> None:
        require(count["flash_attention"] == count["flash_attention_wgmma"] == n_layers * steps
                and count["flash_attention_bwd"] == count["flash_attention_bwd_wgmma"]
                == n_layers * steps and count["flash_attention_3xtf32"] == 0
                and count["flash_attention_bwd_3xtf32"] == 0,
                f"{what}: K4 once a layer a step, forward and backward: {count}")
        launches["flash_attention_bf16"] += count["flash_attention_wgmma"]
        launches["flash_attention_bwd_bf16"] += count["flash_attention_bwd_wgmma"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = MoETrainer(**MOE, compute_dtype=torch.bfloat16, learning_rate=1e-3,
                         seed=SEED, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    ds = lm_copy_task(MOE["seq_len"], vocab=MOE["vocab"], seed=SEED)
    batches = list(ds.batches(MOE_BATCH, 3))
    zero(count)
    m = trainer.train_step(*batches[0])
    torch.cuda.synchronize()
    take("one step", 1)
    require(math.isfinite(m.loss) and m.contributors == 1.0, f"MoE step {m}")
    zero(count)
    hist = trainer.train_chain(ds.device_sampler(), MOE_CHAIN, MOE_BATCH)
    torch.cuda.synchronize()
    take("the chain", MOE_CHAIN)
    losses = [m.loss] + [h.loss for h in hist]
    out["losses"] = losses
    out["dropped"] = [m.dropped] + [h.dropped for h in hist]
    out["aux"] = [m.aux_loss] + [h.aux_loss for h in hist]
    require(all(math.isfinite(v) for v in losses) and sum(losses[-3:]) / 3 < losses[0],
            f"MoE loss does not fall: {losses}")

    def two_steps():
        for x, y in batches[1:]:
            trainer.train_step(x, y)

    zero(count)
    prof = profile_window(two_steps, top=12)
    take("the profiled steps", 2)
    out["profile"] = {**prof, "steps": 2}
    print(json.dumps({"moe_train_profile": out["profile"]}), flush=True)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    active = moe_active_params(trainer.model, 1, MOE["n_experts"])
    out["params"], out["active_params"] = trainer.param_count, active
    out["floor_ms"] = transformer_train_flops(
        n_params=active, batch=MOE_BATCH, seq=MOE["seq_len"], d_model=MOE["d_model"],
        n_layers=n_layers) / BF16_OPS_PER_S * 1e3
    del trainer, hist
    torch.cuda.empty_cache()

    chain = MoETrainer.train_chain
    for name, extra in (("bench_mfu", []), ("bench_mfu_mu_bf16", ["--mu-bf16"])):
        ran = [0]  # the steps of every chain the bench runs, counted apart from K4

        def counted(self, sampler, steps, *a, **k):
            ran[0] += steps
            return chain(self, sampler, steps, *a, **k)

        zero(count)
        with mock.patch.object(MoETrainer, "train_chain", counted):
            rc, text = run_cli(["bench-mfu", "--workload", "moe", *extra])
        torch.cuda.synchronize()
        rec = json.loads(text.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        require(rc == 0 and rec["value"] is not None and 0 < rec["value"] < 1
                and rec["device"] == card["name"] and rec["mu_bf16"] == bool(extra),
                f"bench-mfu --workload moe {extra}: {rec}")
        require(ran[0] > 0, f"bench-mfu {name} ran no training step")
        take(f"bench-mfu {name}", ran[0])
        out[name] = {k: rec[k] for k in (
            "value", "ms_per_step", "spread_pct", "params_m", "active_params_m",
            "dropped_frac", "tflops_per_s", "compile_s")}
        out[name]["steps"] = ran[0]
        torch.cuda.empty_cache()

    # a small width: the card against the CPU, the scatter against the einsum
    kw = dict(**MOE_SMALL, seed=SEED, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    cpu = MoETrainer(**kw, device="cpu")
    on_card = MoETrainer(**kw, device=dev)
    on_card.set_flat_params(cpu.get_flat_params())
    small = list(lm_copy_task(MOE_SMALL["seq_len"], vocab=MOE_SMALL["vocab"],
                              seed=SEED).batches(MOE_SMALL_BATCH, MOE_SMALL_STEPS))
    zero(count)
    worst = 0.0
    for x, y in small:
        a, b = on_card.train_step(x, y), cpu.train_step(x, y)
        for key in ("loss", "aux_loss", "dropped"):
            e = abs(getattr(a, key) - getattr(b, key)) / max(abs(getattr(b, key)), 1e-6)
            worst = max(worst, e)
            require(e <= MOE_SMALL_TOL, f"small MoE step {key}: card {a} vs CPU {b}")
    got, want = on_card.get_flat_params(), cpu.get_flat_params()
    perr = float(abs(got - want).max() / abs(want).max())
    require(perr <= MOE_SMALL_TOL and all(n == 0 for n in count.values()),
            f"small MoE parameters card vs CPU: {perr} of max|param|; launches {count}")
    tokens = torch.from_numpy(small[0][0]).to(dev)
    with torch.no_grad():
        ys = {}
        for impl in ("scatter", "einsum"):
            for block in on_card.model.blocks:
                block.dispatch_impl = impl
            ys[impl] = on_card.model(tokens)
    serr = float((ys["scatter"][0] - ys["einsum"][0]).abs().max()) / float(
        ys["einsum"][0].abs().max())
    require(serr <= 1e-5 and float(ys["scatter"][1]) == float(ys["einsum"][1])
            and float(ys["scatter"][2]) == float(ys["einsum"][2]),
            f"scatter vs einsum on the card: {serr} of max|logit|")
    out["small"] = {"steps": MOE_SMALL_STEPS, "metrics_rel_err": worst,
                    "params_err_of_max": perr, "scatter_vs_einsum_of_max_logit": serr,
                    "tolerance": MOE_SMALL_TOL}
    del cpu, on_card, ys
    torch.cuda.empty_cache()
    b = out["bench_mfu"]
    print(f"MoE training (bench-mfu --workload moe defaults: {out['params'] / 1e9:.3f}B "
          f"parameters, {out['active_params'] / 1e6:.1f}M active, B {MOE_BATCH} x T "
          f"{MOE['seq_len']}, bf16; {card['name']}, {card['power_limit']}): bench-mfu "
          f"{b['ms_per_step']} ms/step, MFU {b['value']} (--mu-bf16 "
          f"{out['bench_mfu_mu_bf16']['ms_per_step']} ms/step, MFU "
          f"{out['bench_mfu_mu_bf16']['value']}); floor {out['floor_ms']:.2f} ms at "
          f"{BF16_OPS_PER_S / 1e12:.1f} TFLOP/s; peak memory {out['peak_memory_gb']:.2f} GB; "
          f"device busy {out['profile']['busy_share'] * 100:.1f}%; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, dropped {out['dropped'][-1]:.4f}", flush=True)
    out["launches"] = launches
    return out


def moe_int8_path(dev, card: dict, config5: dict) -> dict:
    """Phase (m): (m1) :func:`int8_serving`; (m2) :func:`moe_training`; (m3)
    ``train-moe`` at its defaults with a falling loss and config 5's MoE
    fields from phase (k)'s record (``elastic-demo --family moe`` runs in
    phase (p), over 8 ranks). Returns K4's launches by kernel name and the
    figures."""
    import torch

    from akka_allreduce_tpu_torch.ops import flash_attention as fa

    serving = int8_serving(dev, card)
    training = moe_training(dev, card)
    count = fa.LAUNCHES
    zero(count)
    rc, text = run_cli(["train-moe"])
    torch.cuda.synchronize()
    line = text.strip().splitlines()[-1]
    first, last = (float(v) for v in line.split("loss ")[1].split(" (aux")[0].split(" -> "))
    print(line, flush=True)
    require(rc == 0 and last < first and line.startswith("moe: 30 steps on 1 devices"),
            f"train-moe: rc {rc}\n{text}")
    require(all(n == 0 for n in count.values()), f"train-moe: K4 {count}")
    moe5 = {k: v for k, v in config5.items() if k.startswith("moe_")}
    require(moe5.get("moe_remeshed") is True and len(moe5) == 5
            and all(v is not None for v in moe5.values()), f"config 5's MoE fields {moe5}")
    launches = dict(serving.pop("launches"))
    for name, n in training.pop("launches").items():
        launches[name] = launches.get(name, 0) + n
    return {"launches": launches, "int8_serving": serving, "moe_training": training,
            "train_moe": line, "config5_moe": moe5}


# -- phase (n): sequence and tensor parallelism over virtual ranks ------------------


def grad_err_of_max(a, b) -> float:
    """The largest, over leaves, of max|a - b| / max|b| (full-shape grads)."""
    return max(float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
               for n in b)


def sharded_lm_path(dev, card: dict) -> dict:
    """Phase (n): ``LongContextTrainer`` over virtual ranks. (n1) The flagship
    in bf16 over ``data_seq_model_mesh(2, 2, 2)`` with Ulysses: one step with
    K4's forward and backward once a layer (the 8 ranks folded into one
    launch) and K1 once (the replicated class), its loss and full-shape
    gradients against the 1 x 1 trainer's from the same weights and batch; a
    chain whose loss falls; ms a step, peak memory and two profiled steps.
    (n2) ``bench-mfu --dp 2 --sp 2`` (ring: no K4, K1 once a step), MFU on
    the one card. (n3) ``train-lm``'s defaults in f32: ring and Ulysses on
    ``data_seq_mesh(2, 2)``, ``data_seq_model_mesh(2, 2, 2)`` in f32, bf16,
    int8 and overlapped, each against the CPU (replica row 1 masked at the
    second step) and against the 1 x 1 trainer on the card. (n4)
    ``train-lm --dp 2 --sp 2 --tp 2 --impl ulysses --compress bf16``,
    ``train-lm --dp 2 --sp 4 --overlap`` and ``elastic-demo --family lc``.
    Returns the launches and the figures."""
    import statistics
    from unittest import mock

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.models import SyntheticCopyLM, lm_copy_task
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.parallel import data_seq_mesh, data_seq_model_mesh, spec_axes
    from akka_allreduce_tpu_torch.train import LongContextTrainer

    k1, k4 = lr.LAUNCHES, fa.LAUNCHES
    n_layers = LM["n_layers"]
    launches = {"masked_average": 0, "flash_attention_bf16": 0, "flash_attention_bwd_bf16": 0}
    out: dict = {}

    def take(what: str, steps: int, k1_per_step: int | None, k4_per_step: int) -> None:
        """Hold the counts since the last ``take`` to ``steps`` steps' worth
        (``k1_per_step`` None: any), add them to the phase's, set them to 0."""
        torch.cuda.synchronize()
        want4 = k4_per_step * n_layers * steps
        require(k4["flash_attention"] == k4["flash_attention_wgmma"] == want4
                and k4["flash_attention_bwd"] == k4["flash_attention_bwd_wgmma"] == want4
                and k4["flash_attention_3xtf32"] == k4["flash_attention_bwd_3xtf32"] == 0
                and (k1_per_step is None or k1["masked_average"] == k1_per_step * steps),
                f"{what}: launches K1 {dict(k1)}, K4 {dict(k4)} for {steps} steps")
        launches["masked_average"] += k1["masked_average"]
        launches["flash_attention_bf16"] += k4["flash_attention_wgmma"]
        launches["flash_attention_bwd_bf16"] += k4["flash_attention_bwd_wgmma"]
        zero(k1)
        zero(k4)

    # (n1) the flagship over (data, seq, model) = (2, 2, 2), Ulysses
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(**LM, seq_len=LM_SEQ, compute_dtype=torch.bfloat16, learning_rate=1e-3,
              seed=SEED, device=dev)
    sharded = LongContextTrainer(data_seq_model_mesh(*SHARDED_MESH, device=dev),
                                 seq_impl="ulysses", **kw)
    single = LongContextTrainer(**kw)
    require((sharded.dp, sharded.sp, sharded.tp, sharded.n_devices) == (2, 2, 2, 8)
            and torch.equal(sharded.flat_params_tensor(), single.flat_params_tensor()),
            "the sharded and the 1 x 1 trainer from the same weights")
    batches = list(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED).batches(LM_BATCH, 6))
    zero(k1)
    zero(k4)
    m = sharded.train_step(*batches[0])
    take("the sharded flagship step", 1, 1, 1)
    out["first_step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    got = {n: p.grad.clone() for n, p in sharded.model.named_parameters()}
    m1 = single.train_step(*batches[0])
    take("the 1 x 1 flagship step", 1, 0, 1)
    want = {n: p.grad for n, p in single.model.named_parameters()}
    loss_err = abs(m.loss - m1.loss) / abs(m1.loss)
    grad_err = grad_err_of_max(got, want)
    out["vs_1x1"] = {"loss": m.loss, "loss_1x1": m1.loss, "loss_rel_err": loss_err,
                     "grad_err_of_max": grad_err, "loss_tol": SHARDED_LOSS_TOL,
                     "grad_tol": SHARDED_GRAD_TOL}
    print(json.dumps({"sharded_vs_1x1": out["vs_1x1"]}), flush=True)
    require(m.contributors == 2.0 and m1.contributors == 1.0 and loss_err <= SHARDED_LOSS_TOL
            and grad_err <= SHARDED_GRAD_TOL, f"the sharded step vs the 1 x 1: {out['vs_1x1']}")
    del single, got, want
    torch.cuda.empty_cache()
    hist = sharded.train_chain(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED)
                               .device_sampler(), SHARDED_CHAIN, LM_BATCH // SHARDED_MESH[0])
    take("the sharded chain", SHARDED_CHAIN, 1, 1)
    losses = [m.loss] + [h.loss for h in hist]
    out["losses"] = losses
    require(all(math.isfinite(v) for v in losses) and sum(losses[-3:]) / 3 < losses[0],
            f"the sharded flagship's loss does not fall: {losses}")
    times = []
    for x, y in batches[1:4]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sharded.train_step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)

    def two_steps():
        for x, y in batches[4:6]:
            sharded.train_step(x, y)

    prof = profile_window(two_steps, top=12)
    take("the timed and profiled steps", 5, 1, 1)
    out["step_ms"], out["step_ms_all"] = statistics.median(times), times
    out["profile"] = {**prof, "steps": 2}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"sharded_train_profile": out["profile"]}), flush=True)
    del sharded, hist
    torch.cuda.empty_cache()

    # (n2) bench-mfu --dp 2 --sp 2: the ring over 4 ranks, K1 once a step
    ran = [0]
    chain = LongContextTrainer.train_chain

    def counted(self, sampler, steps, *a, **k):
        ran[0] += steps
        return chain(self, sampler, steps, *a, **k)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(LongContextTrainer, "train_chain", counted):
        rc, text = run_cli(["bench-mfu", "--dp", "2", "--sp", "2"])
    torch.cuda.synchronize()
    rec = json.loads(text.strip().splitlines()[-1])
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(rec), flush=True)
    require(rc == 0 and rec["value"] is not None and 0 < rec["value"] < 1
            and rec["virtual_ranks"] == 4 and (rec["dp"], rec["sp"]) == (2, 2)
            and rec["device"] == card["name"] and ran[0] > 0,
            f"bench-mfu --dp 2 --sp 2: {rec}, {ran[0]} steps")
    take("bench-mfu --dp 2 --sp 2", ran[0], 1, 0)
    out["bench_mfu"] = {k: rec[k] for k in ("value", "ms_per_step", "spread_pct",
                                            "tflops_per_s", "peak_memory_gb", "virtual_ranks")}
    out["bench_mfu"]["steps"] = ran[0]
    torch.cuda.empty_cache()

    # (n3) a small width: every mesh on the card against the CPU and the 1 x 1
    small = list(lm_copy_task(SMALL_LM_SEQ, vocab=SMALL_LM["vocab"], seed=SEED).batches(
        SMALL_LM_BATCH, SMALL_LM_STEPS))
    kw = dict(**SMALL_LM, seq_len=SMALL_LM_SEQ, seed=SEED,
              optimizer=lambda ps: torch.optim.SGD(ps, lr=SMALL_LM_LR))
    cases = {
        "ring_dp2_sp2": ((2, 2), dict(seq_impl="ring")),
        "ulysses_dp2_sp2": ((2, 2), dict(seq_impl="ulysses")),
        "tp_2x2x2": ((2, 2, 2), dict(seq_impl="ring")),
        "tp_2x2x2_bf16": ((2, 2, 2), dict(seq_impl="ring", compress="bf16")),
        "tp_2x2x2_int8": ((2, 2, 2), dict(seq_impl="ring", compress="int8")),
        "tp_2x2x2_overlap": ((2, 2, 2), dict(seq_impl="ring", overlap=True)),
    }

    def mesh_of(shape, device):
        return (data_seq_mesh(*shape, device=device) if len(shape) == 2
                else data_seq_model_mesh(*shape, device=device))

    def run(trainer, masked: bool):
        rows = [trainer.train_step(x, y, [1.0, 0.0] if masked and i == 1 else None)
                for i, (x, y) in enumerate(small)]
        return [(r.loss, r.contributors) for r in rows], trainer.get_flat_params()

    one = LongContextTrainer(**kw, device=dev)
    init = one.get_flat_params()
    base, base_params = run(one, False)
    del one
    zero(k1)
    zero(k4)
    out["small"] = {}
    for name, (shape, ckw) in cases.items():
        cpu = LongContextTrainer(mesh_of(shape, "cpu"), **kw, **ckw)
        card_t = LongContextTrainer(mesh_of(shape, dev), **kw, **ckw)
        for t in (cpu, card_t):
            t.set_flat_params(init)
        leaves = sum(not spec_axes(s) for s in card_t._specs.values())
        per_step = (leaves if ckw.get("overlap") else 1) if "compress" not in ckw else 0
        a, pa = run(card_t, True)
        b, pb = run(cpu, True)
        take(f"{name} on the card", SMALL_LM_STEPS, per_step, 0)
        loss_err = max(abs(x[0] - y[0]) / abs(y[0]) for x, y in zip(a, b))
        perr = float(np.abs(pa - pb).max() / np.abs(pb).max())
        wire = ckw.get("compress")
        tol = SMALL_LM_TOL if wire is None else WIRE_CARD_TOL
        require([c for _, c in a] == [c for _, c in b] == [2.0, 1.0, 2.0]
                and loss_err <= tol and perr <= tol,
                f"{name}: card vs CPU losses {a} / {b}, params {perr} of max (tol {tol})")
        card_t.set_flat_params(init)
        c, pc = run(card_t, False)
        take(f"{name} against the 1 x 1", SMALL_LM_STEPS, per_step, 0)
        l1 = max(abs(x[0] - y[0]) / abs(y[0]) for x, y in zip(c, base))
        d1 = float(np.abs(pc - base_params).max() / np.abs(base_params).max())
        ltol, dtol = WIRE_BANDS.get(wire, (SMALL_LM_TOL, SMALL_LM_TOL))
        require(l1 <= ltol and d1 <= dtol,
                f"{name} vs the 1 x 1 on the card: losses {c} / {base}, drift {d1} "
                f"(bands {ltol}, {dtol})")
        out["small"][name] = {"card_vs_cpu_loss": loss_err, "card_vs_cpu_params": perr,
                              "card_vs_cpu_tol": tol, "vs_1x1_loss": l1, "vs_1x1_drift": d1,
                              "vs_1x1_bands": [ltol, dtol], "k1_per_step": per_step}
        del cpu, card_t
    torch.cuda.empty_cache()
    print(json.dumps({"sharded_small": out["small"]}), flush=True)

    # (n4) the commands
    for name, argv in (
            ("train_lm_tp_ulysses_bf16", ["train-lm", "--dp", "2", "--sp", "2", "--tp", "2",
                                          "--impl", "ulysses", "--compress", "bf16"]),
            ("train_lm_sp4_overlap", ["train-lm", "--dp", "2", "--sp", "4", "--overlap"])):
        rc, text = run_cli(argv)
        print(text, flush=True)
        trend = re.search(r"loss (\S+) -> (\S+)", text)
        require(rc == 0 and trend and float(trend.group(2)) < float(trend.group(1)),
                f"{' '.join(argv)}: rc {rc}\n{text}")
        out[name] = [float(trend.group(1)), float(trend.group(2))]
        take(" ".join(argv), 1, None, 0)
    rc, text = run_cli(["elastic-demo", "--family", "lc"])
    print(text, flush=True)
    require(rc == 0 and "8 ranks on" in text and "dp3 x sp2 (generation 1)" in text
            and "dp2 x sp4 (generation 2)" in text,
            f"elastic-demo --family lc: rc {rc}\n{text}")
    take("elastic-demo --family lc", 1, None, 0)
    out["elastic_demo"] = [ln for ln in text.splitlines() if "re-meshed" in ln]
    print(f"DP x SP x TP training (the flagship over data_seq_model_mesh(2, 2, 2), Ulysses, "
          f"bf16; {card['name']}, {card['power_limit']}): {out['step_ms']:.1f} ms a step "
          f"(median of {len(times)}, host clock), peak memory {out['peak_memory_gb']:.2f} GB, "
          f"device busy {out['profile']['busy_share'] * 100:.1f}%; vs the 1 x 1 step: loss "
          f"{out['vs_1x1']['loss_rel_err']:.2e} relative, gradients "
          f"{out['vs_1x1']['grad_err_of_max']:.2e} of max; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; bench-mfu --dp 2 --sp 2 {out['bench_mfu']['ms_per_step']} "
          f"ms/step, MFU {out['bench_mfu']['value']} (one card), peak "
          f"{out['bench_mfu']['peak_memory_gb']:.2f} GB", flush=True)
    out["launches"] = launches
    return out


# -- phase (o): sharded decode over virtual ranks --------------------------------


def teacher_forced(gen, tokens, prompt: int, *, every_rank: bool = False,
                   after_prefill=None):
    """``gen``'s logits over ``tokens`` (B, T): the first ``prompt`` tokens
    in one prefill, then one decode step a token (``every_rank``: every
    rank's, (R, B, T, vocab)); ``after_prefill(cache)`` runs between them."""
    import torch

    cache = gen.init_cache(tokens.shape[0])
    params = gen.place_params()
    out = [gen.step(cache, tokens[:, :prompt], params=params, every_rank=every_rank)]
    if after_prefill is not None:
        after_prefill(cache)
    for i in range(prompt, tokens.shape[1]):
        out.append(gen.step(cache, tokens[:, i:i + 1], params=params, every_rank=every_rank))
    return torch.cat(out, dim=-2)


def cache_bytes_a_rank(cache) -> int:
    """One rank's bytes of a cache (a ``RankKVCache``'s first row)."""
    parts = cache.k + cache.v + (cache.k_scale or []) + (cache.v_scale or [])
    ranked = hasattr(cache, "seq_shards")
    return sum((t[0] if ranked else t).numel() * t.element_size() for t in parts)


def decode_timing(gen, prompt) -> dict:
    """The decode slope (ms a token between ``DECODE_GEN`` and its quarter,
    median of 3, host clock ended by a synchronize), the prefill (median of
    3) and the peak memory of those runs."""
    import statistics

    import torch

    lo, hi = DECODE_GEN // 4, DECODE_GEN

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gen.generate(prompt, lo)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    slopes = [(timed(lambda: gen.generate(prompt, hi)) - timed(lambda: gen.generate(prompt, lo)))
              / (hi - lo) * 1e3 for _ in range(3)]
    def prefill_ms() -> float:
        cache = gen.init_cache(prompt.shape[0])
        return timed(lambda: gen.step(cache, prompt)) * 1e3

    prefill = [prefill_ms() for _ in range(3)]
    return {"ms_per_token": statistics.median(slopes), "ms_per_token_all": slopes,
            "prefill_ms": statistics.median(prefill), "prefill_ms_all": prefill,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


DECODE_TIMING_PREFILLS = 10  # decode_timing's: the warm-up, 3 slope pairs, 3 prefills


def sharded_decode_path(dev, card: dict) -> dict:
    """Phase (o): ``LMGenerator`` over meshes of virtual ranks at the
    flagship's width in bf16 (B 8, a 2048-token prompt): tensor-parallel
    over ``(model,)`` tp 2, sequence-sharded over ``(seq,)`` sp 4 and both
    over ``(seq, model)`` 2 x 2, each with the bf16 and the int8 cache.
    Teacher-forced logits (the prefill, then ``DECODE_TF`` one-token steps)
    equal on every rank and within ``FLASH_TOL`` bf16 of max|logit| of the
    unsharded generator's, tp 2 within ``DECODE_TP_BF16_TOL``; a control
    with one rank's cache zeroed after the prefill (tp 2, sp 4) outside
    those limits; K4's forward once a layer at the TP-only prefill (all
    ranks in one launch, the int8 cache's dequantize branch too) and
    nowhere else; ms a token, prefill ms, a rank's cache bytes and the peak
    memory; in f32, the teacher-forced logits of every mesh within
    ``DECODE_TP_F32_TOL`` (tp 2) or ``DECODE_SEQ_F32_TOL`` (the seq meshes)
    of the unsharded generator's, ``DECODE_INT8_F32_TOL`` with the int8
    cache, the control outside them, and
    greedy generation equal to the unsharded generator's tokens;
    ``lm-generate --sp 2 --tp 2`` with each cache. Returns K4's launches and
    the figures."""
    import torch

    from akka_allreduce_tpu_torch.models import LMGenerator, SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.parallel import RankMesh

    count = fa.LAUNCHES
    n_layers = LM["n_layers"]
    launches = {"flash_attention_bf16": 0, "flash_attention_f32": 0}
    x, _ = next(SyntheticCopyLM(LM_SEQ + LM_GEN, vocab=LM["vocab"], seed=SEED).batches(
        LM_BATCH, 1))
    tokens = torch.from_numpy(x[:, :LM_SEQ + DECODE_TF]).to(dev)
    prompt = tokens[:, :LM_SEQ]
    max_len = LM_SEQ + LM_GEN
    out: dict = {"meshes": {}}

    def take(what: str, k4: int, dtype: str = "bf16") -> None:
        torch.cuda.synchronize()
        kernel = "flash_attention_wgmma" if dtype == "bf16" else "flash_attention_3xtf32"
        require(count["flash_attention"] == count[kernel] == k4
                and sum(count.values()) == 2 * k4, f"{what}: K4 launches {dict(count)}")
        launches[f"flash_attention_{dtype}"] += k4
        zero(count)

    def lose_a_rank(cache) -> None:
        for t in cache.k + cache.v + (cache.k_scale or []) + (cache.v_scale or []):
            t[DECODE_CONTROL_RANK].zero_()

    def held(got, want, limit: float, what: str) -> float:
        """``got``'s worst logit error of max|logit| of ``want``, required
        within ``limit``."""
        err = float((got - want).abs().max()) / float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= limit,
                f"{what}: logits vs the unsharded decode {err} of max|logit| (limit {limit})")
        return err

    def control(gen, want, limit: float, what: str, k4: int, dtype: str) -> float:
        """The same with ``DECODE_CONTROL_RANK``'s cache zeroed after the
        prefill, required outside ``limit``."""
        got = teacher_forced(gen, tokens, LM_SEQ, after_prefill=lose_a_rank)
        take(f"{what} control", k4, dtype)
        err = float((got - want).abs().max()) / float(want.abs().max())
        require(err > limit, f"{what}: with rank {DECODE_CONTROL_RANK}'s cache zeroed the "
                f"logits are {err} of max|logit| from the unsharded decode, within the "
                f"limit {limit}")
        return err

    def limits(axes, dtype: str, quant) -> float:
        if dtype == "bf16":
            return FLASH_TOL["bfloat16"] if "seq" in axes else DECODE_TP_BF16_TOL
        if quant == "int8":
            return DECODE_INT8_F32_TOL
        return DECODE_SEQ_F32_TOL if "seq" in axes else DECODE_TP_F32_TOL

    controls = {"tp2", "sp4"}
    out["controls"] = {}
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, seed=SEED, device=dev)
    for quant in (None, "int8"):
        qname = quant or "bf16"
        zero(count)
        one = LMGenerator(model, max_len, cache_quant=quant)
        want = teacher_forced(one, tokens, LM_SEQ)
        take(f"the unsharded {qname} decode", n_layers)
        for name, (shape, axes) in DECODE_MESHES.items():
            mesh = RankMesh(axes, shape, dev)
            gen = LMGenerator(model, max_len, cache_quant=quant, mesh=mesh)
            got = teacher_forced(gen, tokens, LM_SEQ, every_rank=True)
            k4 = n_layers if "seq" not in axes else 0  # the TP-only prefill
            take(f"{name} {qname} teacher-forced", k4)
            equal = all(torch.equal(got[0], got[r]) for r in range(1, mesh.size))
            require(equal, f"{name} {qname}: every rank's logits equal")
            limit = limits(axes, "bf16", quant)
            err = held(got[0], want, limit, f"{name} {qname}")
            del got
            if name in controls:
                out["controls"][f"{name}_{qname}"] = control(
                    gen, want, limit, f"{name} {qname}", k4, "bf16")
            cache = gen.init_cache(LM_BATCH)
            rank_bytes = cache_bytes_a_rank(cache)
            del cache
            t = decode_timing(gen, prompt)
            take(f"{name} {qname} timing", k4 * DECODE_TIMING_PREFILLS)
            out["meshes"][f"{name}_{qname}"] = {
                "ranks": mesh.size, "logits_err_of_max": err, "limit": limit,
                "k4_at_prefill": k4, "cache_bytes_a_rank": rank_bytes, **t}
            print(json.dumps({"sharded_decode": f"{name}_{qname}",
                              **out["meshes"][f"{name}_{qname}"]}), flush=True)
            del gen
            torch.cuda.empty_cache()
        t = decode_timing(one, prompt)
        take(f"the unsharded {qname} timing", n_layers * DECODE_TIMING_PREFILLS)
        out["meshes"][f"unsharded_{qname}"] = {
            "ranks": 1, "cache_bytes_a_rank": cache_bytes_a_rank(one.init_cache(LM_BATCH)), **t}
        print(json.dumps({"sharded_decode": f"unsharded_{qname}",
                          **out["meshes"][f"unsharded_{qname}"]}), flush=True)
        del one, want
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    # in f32: the teacher-forced logits and the greedy tokens of each mesh
    # against the unsharded generator's
    model32 = TransformerLM(**LM, seed=SEED, device=dev)
    out["greedy"], out["f32_logits_err_of_max"] = {}, {}
    for quant in (None, "int8"):
        qname = quant or "f32"
        one = LMGenerator(model32, max_len, cache_quant=quant)
        want = teacher_forced(one, tokens, LM_SEQ)
        ref = one.generate(prompt, LM_GEN)
        take(f"the unsharded f32 {qname} decode", 2 * n_layers, "f32")
        for name, (shape, axes) in DECODE_MESHES.items():
            gen = LMGenerator(model32, max_len, cache_quant=quant,
                              mesh=RankMesh(axes, shape, dev))
            k4 = n_layers if "seq" not in axes else 0
            limit = limits(axes, "f32", quant)
            out["f32_logits_err_of_max"][f"{name}_{qname}"] = held(
                teacher_forced(gen, tokens, LM_SEQ), want, limit, f"{name} f32 {qname}")
            take(f"{name} f32 {qname} teacher-forced", k4, "f32")
            if name in controls:
                out["controls"][f"{name}_f32_{qname}"] = control(
                    gen, want, limit, f"{name} f32 {qname}", k4, "f32")
            toks = gen.generate(prompt, LM_GEN)
            take(f"{name} f32 {qname} generation", n_layers if "seq" not in axes else 0, "f32")
            agree = float((toks == ref).float().mean())
            out["greedy"][f"{name}_{qname}"] = agree
            require(agree == 1.0,
                    f"{name} f32 {qname}: greedy tokens vs the unsharded generator's: {agree}")
    print(json.dumps({"sharded_decode_greedy_agreement": out["greedy"],
                      "f32_logits_err_of_max": out["f32_logits_err_of_max"],
                      "limits": {"tp_bf16": DECODE_TP_BF16_TOL, "seq_bf16": FLASH_TOL["bfloat16"],
                                 "tp_f32": DECODE_TP_F32_TOL, "seq_f32": DECODE_SEQ_F32_TOL,
                                 "int8_f32": DECODE_INT8_F32_TOL},
                      "controls_rank_zeroed": out["controls"]}), flush=True)
    del model32
    torch.cuda.empty_cache()

    # the command at the flagship: --sp 2 --tp 2, each cache
    argv = ["lm-generate", "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
            "--heads", str(LM["n_heads"]), "--layers", str(n_layers), "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_SEQ), "--gen", str(DECODE_GEN), "--bf16",
            "--sp", "2", "--tp", "2"]
    for name, extra in (("bf16", []), ("int8", ["--cache-quant", "int8"])):
        rc, text = run_cli(argv + extra)
        torch.cuda.synchronize()
        rec = json.loads(text.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        require(rc == 0 and rec["prefill_ms"] > 0 and rec["ms_per_token"] > 0
                and (rec["sp"], rec["tp"]) == (2, 2) and rec["device"] == card["name"]
                and rec["cache_quant"] == (extra[-1] if extra else None),
                f"lm-generate --sp 2 --tp 2 {name}: rc {rc}, {rec}")
        take(f"lm-generate --sp 2 --tp 2 {name}", 0)  # seq-sharded: no K4
        out[f"lm_generate_sp2_tp2_{name}"] = {k: rec[k] for k in (
            "prefill_ms", "ms_per_token", "tokens_per_s", "device", "power_limit")}
    m = out["meshes"]
    print(f"sharded decode (the flagship, bf16, B {LM_BATCH}, prompt {LM_SEQ}; {card['name']}, "
          f"{card['power_limit']}): ms a token "
          + ", ".join(f"{k} {v['ms_per_token']:.2f}" for k, v in m.items())
          + "; prefill ms " + ", ".join(f"{k} {v['prefill_ms']:.1f}" for k, v in m.items())
          + "; cache bytes a rank "
          + ", ".join(f"{k} {v['cache_bytes_a_rank']}" for k, v in m.items()), flush=True)
    out["launches"] = launches
    return out


# -- phase (p): MoE over virtual ranks --------------------------------------------


def moe_parallel_path(dev, card: dict) -> dict:
    """Phase (p): ``MoETrainer`` over virtual ranks at the bench width
    (``MOE``: d 2048, 16 heads, 8 experts top-1, scatter, bf16, B 8 x T
    2048, Adam 1e-3). (p1) One step over (data, expert) = (2, 4) and one
    over (data, seq, expert) = (1, 2, 4) with Ulysses, each against the
    one-rank trainer's step from the same weights and batch at capacity
    factor 8.0 (nothing dropped: routing is partition-independent) with the
    aux loss out of the gradient, at ``MOE_ORACLE_LAYERS`` layers: the loss within ``SHARDED_LOSS_TOL``
    relative and each gradient within ``SHARDED_GRAD_TOL`` of its max|grad|;
    K4's forward and backward once a layer a step (the ranks in one launch)
    and K1 once a step (the replicated class). (p2) The full depth at the
    bench's capacity factor 1.25 over (2, 4): a chain whose loss falls, ms a
    step (median of 3), peak memory, two steps under ``torch.profiler``.
    (p3) ``train-moe``'s width over (2, 2, 2) by SGD with the bf16 wire and
    overlapped, three steps on the card against the CPU; ``train-moe --dp 2
    --ep 2 --sp 2 --compress bf16`` and ``--overlap`` (falling losses).
    (p4) ``elastic-demo --family moe`` over 8 ranks. Returns the launches
    and the figures."""
    import statistics

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.models import lm_copy_task
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.parallel import RankMesh
    from akka_allreduce_tpu_torch.train import MoETrainer

    k1, k4 = lr.LAUNCHES, fa.LAUNCHES
    launches = {"masked_average": 0, "flash_attention_bf16": 0, "flash_attention_bwd_bf16": 0}
    out: dict = {}

    def take(what: str, steps: int, layers: int, k1_per_step: int | None) -> None:
        torch.cuda.synchronize()
        want4 = layers * steps
        require(k4["flash_attention"] == k4["flash_attention_wgmma"] == want4
                and k4["flash_attention_bwd"] == k4["flash_attention_bwd_wgmma"] == want4
                and k4["flash_attention_3xtf32"] == k4["flash_attention_bwd_3xtf32"] == 0
                and (k1_per_step is None or k1["masked_average"] == k1_per_step * steps),
                f"{what}: launches K1 {dict(k1)}, K4 {dict(k4)} for {steps} steps")
        launches["masked_average"] += k1["masked_average"]
        launches["flash_attention_bf16"] += k4["flash_attention_wgmma"]
        launches["flash_attention_bwd_bf16"] += k4["flash_attention_bwd_wgmma"]
        zero(k1)
        zero(k4)

    ds = lm_copy_task(MOE["seq_len"], vocab=MOE["vocab"], seed=SEED)
    x, y = next(ds.batches(MOE_BATCH, 1))

    # (p1) the sharded steps against the one-rank step, nothing dropped
    torch.cuda.empty_cache()
    kw = dict(MOE, n_layers=MOE_ORACLE_LAYERS, capacity_factor=MOE_ORACLE_CF, aux_coef=0.0,
              compute_dtype=torch.bfloat16, learning_rate=1e-3, seed=SEED)
    zero(k1)
    zero(k4)
    one = MoETrainer(**kw, device=dev)
    init = one.flat_params_tensor()
    m1 = one.train_step(x, y)
    take("the one-rank MoE step", 1, MOE_ORACLE_LAYERS, 0)
    want = {n: p.grad.clone() for n, p in one.model.named_parameters()}
    del one
    torch.cuda.empty_cache()
    out["vs_one_rank"] = {}
    for name, (shape, axes, impl) in MOE_MESHES.items():
        torch.cuda.reset_peak_memory_stats()
        t = MoETrainer(RankMesh(axes, shape, dev), seq_impl=impl, **kw)
        t.set_flat_params(init)
        m = t.train_step(x, y)
        take(f"the MoE step over {name}", 1, MOE_ORACLE_LAYERS, 1)
        got = {n: p.grad for n, p in t.model.named_parameters()}
        loss_err = abs(m.loss - m1.loss) / abs(m1.loss)
        grad_err = grad_err_of_max(got, want)
        rec = {"loss": m.loss, "loss_one_rank": m1.loss, "loss_rel_err": loss_err,
               "aux": m.aux_loss, "aux_one_rank": m1.aux_loss, "dropped": m.dropped,
               "grad_err_of_max": grad_err, "peak_memory_gb":
               torch.cuda.max_memory_allocated() / 1e9}
        out["vs_one_rank"][name] = rec
        print(json.dumps({"moe_vs_one_rank": name, **rec}), flush=True)
        require(m.dropped == m1.dropped == 0.0 and m.contributors == shape[0]
                and loss_err <= SHARDED_LOSS_TOL and grad_err <= SHARDED_GRAD_TOL,
                f"the MoE step over {name} vs the one-rank step: {rec}")
        del t, got
        torch.cuda.empty_cache()
    del want, init

    # (p2) the full depth at the bench's capacity factor over (2, 4)
    torch.cuda.reset_peak_memory_stats()
    shape, axes, _ = MOE_MESHES["data2_expert4"]
    t = MoETrainer(RankMesh(axes, shape, dev), **MOE, compute_dtype=torch.bfloat16,
                   learning_rate=1e-3, seed=SEED)
    n_layers = MOE["n_layers"]
    batches = list(ds.batches(MOE_BATCH, 6, seed_offset=1))
    m = t.train_step(*batches[0])
    take("the bench-width MoE step over (2, 4)", 1, n_layers, 1)
    out["first_step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    hist = t.train_chain(ds.device_sampler(), MOE_PAR_CHAIN, MOE_BATCH // (shape[0] * shape[1]))
    take("the MoE chain over (2, 4)", MOE_PAR_CHAIN, n_layers, 1)
    losses = [m.loss] + [h.loss for h in hist]
    out["losses"], out["dropped"] = losses, [m.dropped] + [h.dropped for h in hist]
    require(all(math.isfinite(v) for v in losses) and sum(losses[-3:]) / 3 < losses[0],
            f"the MoE chain over (2, 4): the loss does not fall: {losses}")
    times = []
    for bx, by in batches[1:4]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t.train_step(bx, by)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)

    def two_steps():
        for bx, by in batches[4:6]:
            t.train_step(bx, by)

    prof = profile_window(two_steps, top=12)
    take("the timed and profiled MoE steps", 5, n_layers, 1)
    out["step_ms"], out["step_ms_all"] = statistics.median(times), times
    out["profile"] = {**prof, "steps": 2}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"moe_parallel_profile": out["profile"]}), flush=True)
    del t, hist
    torch.cuda.empty_cache()

    # (p3) train-moe's width: card against CPU, then the commands
    small = list(lm_copy_task(MOE_TRAIN_SEQ, vocab=64, seed=SEED).batches(8, 3))
    skw = dict(MOE_TRAIN, seq_len=MOE_TRAIN_SEQ, capacity_factor=4.0, seed=SEED,
               optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    out["small"] = {}
    for name, ckw in (("bf16", dict(compress="bf16")), ("overlap", dict(overlap=True))):
        runs = []
        for d in (dev, torch.device("cpu")):
            tr = MoETrainer(RankMesh(("data", "seq", "expert"), (2, 2, 2), d), **skw, **ckw)
            if runs:
                tr.set_flat_params(runs[0][2])
            init_params = tr.get_flat_params()
            rows = [tr.train_step(bx, by, [1.0, 0.0] if i == 1 else None)
                    for i, (bx, by) in enumerate(small)]
            runs.append(([(r.loss, r.contributors) for r in rows], tr.get_flat_params(),
                         init_params))
        take(f"train-moe's width {name} on the card and the CPU", 3, 0,
             None if name == "overlap" else 0)
        (a, pa, _), (b, pb, _) = runs
        loss_err = max(abs(p[0] - q[0]) / abs(q[0]) for p, q in zip(a, b))
        perr = float(np.abs(pa - pb).max() / np.abs(pb).max())
        tol = WIRE_CARD_TOL if name == "bf16" else SMALL_LM_TOL
        require([c for _, c in a] == [c for _, c in b] == [2.0, 1.0, 2.0]
                and loss_err <= tol and perr <= tol,
                f"train-moe's width {name}: card vs CPU losses {a} / {b}, params {perr} of max")
        out["small"][name] = {"card_vs_cpu_loss": loss_err, "card_vs_cpu_params": perr,
                              "tol": tol}
    print(json.dumps({"moe_parallel_small": out["small"]}), flush=True)
    for name, extra in (("bf16", ["--compress", "bf16"]), ("overlap", ["--overlap"])):
        rc, text = run_cli(["train-moe", "--dp", "2", "--ep", "2", "--sp", "2", *extra])
        print(text, flush=True)
        trend = re.search(r"loss (\S+) -> (\S+)", text)
        require(rc == 0 and "mesh dp=2 x sp=2 x ep=2" in text and "on 8 devices" in text
                and trend and float(trend.group(2)) < float(trend.group(1)),
                f"train-moe --dp 2 --ep 2 --sp 2 {name}: rc {rc}\n{text}")
        out[f"train_moe_{name}"] = [float(trend.group(1)), float(trend.group(2))]
        take(f"train-moe {name}", 0, 0, None)

    # (p4) elastic-demo --family moe over the JAX assignment's 8 ranks
    rc, text = run_cli(["elastic-demo", "--family", "moe"])
    print(text, flush=True)
    require(rc == 0 and "8 ranks on" in text and "dp3 x ep2 (generation 1)" in text
            and "dp2 x ep4 (generation 2)" in text, f"elastic-demo --family moe: rc {rc}\n{text}")
    take("elastic-demo --family moe", 0, 0, None)
    out["elastic_demo"] = [ln for ln in text.splitlines() if "re-meshed" in ln]
    v = out["vs_one_rank"]
    print(f"MoE over virtual ranks (bench width, bf16; {card['name']}, {card['power_limit']}): "
          f"(2, 4) {out['step_ms']:.1f} ms a step (median of {len(times)}, host clock), peak "
          f"{out['peak_memory_gb']:.2f} GB, device busy "
          f"{out['profile']['busy_share'] * 100:.1f}%; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          "vs the one-rank step at capacity factor 8.0: "
          + ", ".join(f"{k} loss {r['loss_rel_err']:.2e}, gradients "
                      f"{r['grad_err_of_max']:.2e} of max" for k, r in v.items()), flush=True)
    out["launches"] = launches
    return out


def live_state(trainer, clone: bool = False) -> dict:
    """Every tensor of a trainer's checkpoint state by key path, where it
    lies (on the card; Adam's step counters on the host): the shard-local
    capture of the trainer-defined protocol, or the pytree form. ``clone``
    copies each where it lies."""
    from akka_allreduce_tpu_torch.train import checkpoint as ckpt

    tree = (trainer.checkpoint_capture() if hasattr(trainer, "checkpoint_capture")
            else ckpt.capture_state(trainer)[0])
    return {k: (v.detach().clone() if clone else v.detach()) for k, v in ckpt.tree_items(tree)}


def states_equal(a: dict, b: dict) -> tuple[bool, float]:
    """(bit-equal, max abs difference) of two ``live_state``s."""
    import torch

    if a.keys() != b.keys():
        return False, math.inf
    err = max((float((x.double() - b[k].double()).abs().max()) for k, x in a.items()
               if x.numel()), default=0.0)
    return all(torch.equal(x, b[k]) for k, x in a.items()), err


def resume_cycles(name: str, a, b, batches, root) -> dict:
    """For each of the four stores: save ``a``, step it on ``batches`` (for
    the async stores while the writer drains), restore ``b``, whose state
    must then be that of the moment of the save, and step ``b`` on the same
    batches: every tensor equal to ``a``'s, bit for bit. The async stores'
    host buffers must be pinned. Returns each store's seconds: the save call
    (the step loop's stall), the save until durable, the restore."""
    import shutil

    import torch

    from akka_allreduce_tpu_torch.train import (
        AsyncDeltaCheckpointer,
        AsyncTrainerCheckpointer,
        DeltaCheckpointer,
        TrainerCheckpointer,
    )

    on_card = a.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def steps(t):
        for x, y in batches:
            m = t.train_step(x, y)
            require(math.isfinite(m.loss), f"{name} step {m}")

    out = {}
    for cls in (TrainerCheckpointer, DeltaCheckpointer, AsyncTrainerCheckpointer,
                AsyncDeltaCheckpointer):
        what = f"{name} {cls.__name__}"
        ref, saved_step = live_state(a, clone=True), a.step_num
        directory = root / f"{name}_{cls.__name__}"
        sync()
        t0 = time.perf_counter()
        ck = cls(directory)
        require(ck.save(a) is not False, f"{what}: save")
        save_s = time.perf_counter() - t0
        steps(a)  # for the async stores, while the writer drains
        if hasattr(ck, "wait_until_finished"):
            ck.wait_until_finished()
            bufs = ck.host_buffers.buffers.values()
            require(not on_card or (bufs and all(buf.is_pinned() for buf in bufs)),
                    f"{what}: the capture's host buffers are pinned")
        wall_s = time.perf_counter() - t0
        require(not states_equal(live_state(a), ref)[0],
                f"{what}: the steps after the save changed the live state")
        t0 = time.perf_counter()
        require(ck.restore(b) == saved_step, f"{what}: the restored step")
        sync()
        restore_s = time.perf_counter() - t0
        equal, err = states_equal(live_state(b), ref)
        require(equal, f"{what}: the restored state is the state at save (max abs {err})")
        del ref
        steps(b)
        equal, err = states_equal(live_state(a), live_state(b))
        require(equal, f"{what}: the resumed state bit-equal to the saver's (max abs {err})")
        ck.close()
        shutil.rmtree(directory)
        out[cls.__name__] = {"save_call_s": save_s, "save_wall_s": wall_s,
                             "restore_s": restore_s}
    return out


def checkpoint_path(dev, card: dict) -> dict:
    """Phase (i): checkpoints and resume. ZeRO-1 at the JAX ``bench-checkpoint
    --trainer zero1`` width (f32: K1 once a step, the flat weights bit-equal
    to ``DPTrainer``'s; bf16 + EF: the residual formula; saved over 8 ranks,
    restored over 4); resume equality through each of the four stores for
    ZeRO-1 in f32, ``DPTrainer`` on ``MLP(2048, 2048)`` with int8 + EF (the
    plain ring, no K1) and the LM at the flagship's width, 1 layer, in bf16
    (K4's forward and backward in every step); ``bench-checkpoint`` at that
    width for both stores and
    for ``--trainer zero1``. Returns the launches and figures."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from akka_allreduce_tpu_torch.models import MLP, SyntheticCopyLM, mnist_like
    from akka_allreduce_tpu_torch.ops import flash_attention as fa
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import (
        DeltaCheckpointer,
        DPTrainer,
        LongContextTrainer,
        Zero1DPTrainer,
    )

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def launched(n: int) -> int:
        """Kernel launches for n calls (the CPU, in a rehearsal, launches none)."""
        return n if on_card else 0

    k1, k4 = lr.LAUNCHES, fa.LAUNCHES
    marks: dict[str, tuple[int, int, int]] = {}

    def mark(part: str) -> None:
        """The counts K1, K4's forward and its backward reached after ``part``."""
        sync()
        marks[part] = (k1["masked_average"], k4["flash_attention_wgmma"],
                       k4["flash_attention_bwd_wgmma"])

    def since(part: str) -> tuple[int, int, int]:
        sync()
        now = (k1["masked_average"], k4["flash_attention_wgmma"],
               k4["flash_attention_bwd_wgmma"])
        return tuple(n - m for n, m in zip(now, marks[part]))

    def adam(ps):
        return torch.optim.Adam(ps, lr=1e-3)

    def zero1(n: int = DP_RANKS, seed: int = SEED, **kw):
        return Zero1DPTrainer(MLP(hidden=ZERO1_HIDDEN, seed=seed, device=dev),
                              line_mesh(n, device=dev), optimizer=adam, **kw)

    out: dict = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        free = shutil.disk_usage(root).free
        out["disk_free_gb"] = free / 1e9
        require(free >= CKPT_FREE_BYTES, f"{free / 1e9:.1f} GB free under {root}; the "
                f"flagship stores need {CKPT_FREE_BYTES / 1e9:.0f}")
        zero(k1)
        zero(k4)
        mark("start")

        # (a) ZeRO-1 in f32 against DPTrainer, K1 once a step
        z = zero1()
        d = DPTrainer(MLP(hidden=ZERO1_HIDDEN, seed=SEED, device=dev),
                      line_mesh(DP_RANKS, device=dev), optimizer=adam)
        require(z.param_count == ZERO1_PARAMS
                and z.optimizer_shard_elems * DP_RANKS == z._padded,
                f"ZeRO-1 at width: {z.param_count} params")
        require(np.array_equal(z.get_flat_params(), d.get_flat_params()), "the same weights")
        batches = list(mnist_like(seed=SEED).batches(DP_RANKS * ZERO1_ROWS,
                                                     ZERO1_STEPS + CKPT_STEPS_AFTER))
        losses = []
        for i, (x, y) in enumerate(batches[:ZERO1_STEPS]):
            valid = MASK3 if i == 1 else None
            mark("zero1_step")
            mz = z.train_step(x, y, valid)
            require(since("zero1_step") == (launched(1), 0, 0), "one K1 launch a ZeRO-1 f32 step")
            md = d.train_step(x, y, valid)
            require(mz.loss == md.loss and mz.contributors == md.contributors
                    == DP_RANKS - (i == 1), f"ZeRO-1 {mz} vs DPTrainer {md}")
            losses.append(mz.loss)
        require(np.array_equal(z.get_flat_params(), d.get_flat_params()),
                "ZeRO-1's flat weights bit-equal to DPTrainer's")
        require(since("start") == (launched(2 * ZERO1_STEPS), 0, 0), "K1 in (a)")
        del d
        out["zero1_f32"] = {"losses": losses}
        mark("a")

        # (b) bf16 + EF: e' = c - bf16(c v) with rank 3 masked; no K1
        te = zero1(compress="bf16", error_feedback=True)
        te.train_step(*batches[0])  # a nonzero residual to fold in
        e0 = te._ef.clone()
        v3 = torch.tensor(MASK3, device=dev)
        stack, _ = te.rank_gradients(*te._place_batch(*batches[1]))
        average, count = te.reduce_scatter(stack, v3)
        c = stack + e0
        require(torch.equal(te._ef, c - (c * v3[:, None]).to(torch.bfloat16).float()),
                "ZeRO-1 bf16 EF: e' = c - bf16(c v)")
        te.apply_shards(average)
        te.step_num += 1
        norms = te._ef.norm(dim=1)
        ratio = float(norms[3]) / float(torch.cat([norms[:3], norms[4:]]).max())
        require(float(count) == DP_RANKS - 1 and ratio > EF_BF16_RATIO
                and since("a") == (0, 0, 0),
                f"ZeRO-1 bf16 EF: masked row {ratio:.1f}x the others', count {float(count)}")
        out["zero1_bf16_ef"] = {"masked_ef_ratio": ratio}
        del stack, average, c, e0

        # (c) ZeRO-1 saved over 8 ranks, restored over 4
        with DeltaCheckpointer(root / "remesh") as ck:
            ck.save(te)
            t4 = zero1(4, compress="bf16", error_feedback=True)
            require(ck.restore(t4) == te.step_num, "restored over 4 ranks")
        s8, s4 = te.checkpoint_state(), t4.checkpoint_state()
        require(np.array_equal(s8["flat_params"], s4["flat_params"])
                and all(np.array_equal(p, q) for p, q in zip(s8["opt_state"][0],
                                                             s4["opt_state"][0]))
                and np.allclose(s4["ef_sum"], s8["ef_sum"], rtol=1e-6, atol=0)
                and np.abs(s8["ef_sum"]).max() > 0, "8 -> 4 ranks: the v2 form kept")
        out["remesh_8_to_4"] = {
            "shard_elems": [te.optimizer_shard_elems, t4.optimizer_shard_elems],
            "ef_sum_max_abs_err": float(np.abs(s4["ef_sum"] - s8["ef_sum"]).max())}
        del te, t4, s8, s4
        shutil.rmtree(root / "remesh")
        torch.cuda.empty_cache()

        # (d) resume equality through each store
        mark("c")
        out["resume_zero1"] = resume_cycles("zero1", z, zero1(seed=SEED + 1),
                                            batches[ZERO1_STEPS:], root)
        require(since("c") == (launched(8 * CKPT_STEPS_AFTER), 0, 0), "K1 in ZeRO-1's resumes")
        del z
        mark("d_zero1")

        def dp_int8(seed: int):
            return DPTrainer(MLP(hidden=DP_HIDDEN, seed=seed, device=dev),
                             line_mesh(DP_RANKS, device=dev), optimizer=adam,
                             compress="int8", error_feedback=True)

        dp_batches = list(mnist_like(seed=SEED).batches(DP_RANKS * DP_ROWS,
                                                        1 + CKPT_STEPS_AFTER))
        da, db = dp_int8(SEED), dp_int8(SEED + 1)
        da.train_step(*dp_batches[0], valid=MASK3)  # rank 3's gradient banked
        db.train_step(*dp_batches[0])
        out["resume_dp_int8_ef"] = resume_cycles("dp_int8_ef", da, db, dp_batches[1:], root)
        require(since("d_zero1") == (0, 0, 0), "the int8 sync launched a kernel")
        del da, db
        torch.cuda.empty_cache()

        lm_batches = list(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED).batches(
            CKPT_LM_BATCH, 1 + CKPT_STEPS_AFTER))

        def lm(seed: int):
            return LongContextTrainer(**CKPT_LM, seq_len=LM_SEQ, compute_dtype=torch.bfloat16,
                                      learning_rate=1e-3, seed=seed, device=dev)

        mark("d_dp")
        la, lb = lm(SEED), lm(SEED + 1)
        la.train_step(*lm_batches[0])
        lb.train_step(*lm_batches[0])
        out["resume_lm_bf16"] = resume_cycles("lm_bf16", la, lb, lm_batches[1:], root)
        lm_steps = CKPT_LM["n_layers"] * (2 + 8 * CKPT_STEPS_AFTER)
        require(since("d_dp") == (0, launched(lm_steps), launched(lm_steps))
                and k4["flash_attention_3xtf32"] == 0,
                f"LM resumes: K4's forward and backward once a layer a step, {dict(k4)}")
        del la, lb
        torch.cuda.empty_cache()
        mark("d")

        # (e) bench-checkpoint at the flagship's width, 1 layer (both stores),
        # and --trainer zero1
        lm_flags = ["--d-model", str(CKPT_LM["d_model"]), "--layers", str(CKPT_LM["n_layers"]),
                    "--seq-len", str(LM_SEQ), "--vocab", str(CKPT_LM["vocab"]), "--bf16"]
        zero1_flags = ["--trainer", "zero1", "--d-model", str(ZERO1_HIDDEN[0]),
                       "--layers", str(len(ZERO1_HIDDEN))]
        records = {}
        # the delta store's synchronous save (about 12 s at the flagship on an
        # H100) is skipped to keep the phase short; bench-checkpoint --store
        # delta without --skip-sync measures it
        for label, flags in (("lm_orbax", lm_flags),
                             ("lm_delta", [*lm_flags, "--store", "delta", "--skip-sync"]),
                             ("zero1_orbax", zero1_flags)):
            mark(label)
            rc, text = run_cli(["bench-checkpoint", "--dir", str(root), "--baseline-steps",
                                str(CKPT_BENCH_BASELINE), *flags,
                                *([] if on_card else ["--device", "cpu"])])
            rec = json.loads(text.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            steps = 1 + CKPT_BENCH_BASELINE + rec["steps_during_async_save"]
            want = ((0, launched(CKPT_LM["n_layers"] * steps),
                     launched(CKPT_LM["n_layers"] * steps))
                    if label.startswith("lm") else (launched(steps), 0, 0))
            require(rc == 0 and rec["metric"] == "checkpoint_stall"
                    and rec["platform"] == card["name"]
                    and rec["saved_step"] == 1 + CKPT_BENCH_BASELINE
                    and ((rec["sync_save_stall_s"] is None) == ("--skip-sync" in flags))
                    and rec["async_save_wall_s"] >= rec["async_capture_stall_s"] > 0
                    and (rec["delta_stats"] is None) == (label != "lm_delta")
                    and since(label) == want and not any(root.iterdir()),
                    f"bench-checkpoint {label}: {rec}, launches {since(label)} for {want}")
            records[label] = rec
            torch.cuda.empty_cache()
        out["bench_checkpoint"] = records
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = since("start")
    out["launches"] = {"masked_average": total[0], "flash_attention_bf16": total[1],
                       "flash_attention_bwd_bf16": total[2]}
    out["launches_by_part"] = {
        "a_zero1_vs_dp": marks["a"][0],
        "d_resume": [m - s for m, s in zip(marks["d"], marks["c"])],
        "e_bench_checkpoint": [n - m for n, m in zip(total, marks["d"])],
    }
    return out


def median_step_ms(step, batches, steps: int = 5) -> tuple[float, list[float]]:
    """Median host-clock ms of ``steps`` calls ``step(x, y)`` (each ended by
    a synchronize) on ``batches``, after one warm-up call."""
    import statistics

    import torch

    step(*batches[0])
    times = []
    for x, y in batches[1:steps + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def time_overlap_k1(trainer, stack, v) -> dict:
    """K1 by CUDA events: once a leaf over the leaves' ``(n, leaf)`` rows
    (an overlapped step's launches) against one launch on the whole stack."""
    import torch

    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.utils import cuda_event_ms

    rows = [r.contiguous() for r in torch.split(stack, trainer._sizes, dim=1)]
    return {"per_leaf_total_ms": cuda_event_ms(
                lambda: [lr.masked_average(r, v) for r in rows], 20),
            "fused_ms": cuda_event_ms(lambda: lr.masked_average(stack, v), 20),
            "leaves": len(rows)}


def time_dp_step(path: dict, steps: int = 5) -> dict:
    """A DP path's step (MLP or ResNet-50): the fused, the overlapped and
    the accumulated step's median host-clock ms over ``steps`` steps (each
    ended by a synchronize), after one warm-up step; K1 by CUDA events on a step's
    ``(8, P)`` gradient stack with all ranks, beside its plain version,
    ``torch.mv`` + sum + clamp + div and its bound; K1 once a leaf (an
    overlapped step's launches) against its one fused launch; two fused
    steps under ``torch.profiler``."""
    import torch

    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.utils import cuda_event_ms

    t, stack = path["trainer"], path["stack"]
    batches = path.get("batches") or [path["batch"]] * (steps + 3)
    step_ms, times = median_step_ms(t.train_step, batches, steps)
    overlap_ms, overlap_times = median_step_ms(path["overlap_trainer"].train_step, batches,
                                               steps)
    accum = path["accum_steps"]
    accum_ms, accum_times = median_step_ms(
        lambda x, y: t.train_step_accum(x, y, accum), batches, steps)
    v = torch.ones(DP_RANKS, device=stack.device)
    k, p = stack.shape
    k1 = {
        "ms": cuda_event_ms(lambda: lr.masked_average(stack, v), 50),
        "plain_ms": cuda_event_ms(lambda: lr.masked_average_reference(stack, v), 10),
        "library_ms": cuda_event_ms(
            lambda: torch.mv(stack.t(), v) / torch.clamp_min(v.sum(), 1.0), 50),
        "bound_ms": (k * p + k + p + 1) * 4 / HBM_BYTES_PER_S * 1e3,
    }

    def two_steps():
        for x, y in batches[steps + 1:steps + 3]:
            t.train_step(x, y)

    overlap_profile = profile_window(
        lambda: path["overlap_trainer"].train_step(*batches[steps + 1]), top=8)
    return {"step_ms": step_ms, "step_ms_all": times, "k1": k1,
            "k1_share": k1["ms"] / step_ms,
            "overlap_step_ms": overlap_ms, "overlap_step_ms_all": overlap_times,
            "accum_step_ms": accum_ms, "accum_step_ms_all": accum_times, "accum_steps": accum,
            "overlap_k1": {**time_overlap_k1(t, stack, v),
                           "device_ms_in_step": sum(e[1] for e in overlap_profile["k1"]),
                           "launches_in_step": sum(e[2] for e in overlap_profile["k1"])},
            "overlap_profile": overlap_profile,
            "profile": {**profile_window(two_steps, top=8), "steps": 2}}


def time_train_step(dev, dtype=None, batch: int = LM_BATCH, steps: int = 5) -> dict:
    """The flagship's training step in ``dtype`` (bf16 by default) at
    ``batch``: median host-clock ms over ``steps`` steps (each ends in its
    loss's host read), after one warm-up step; then two steps under
    ``torch.profiler``; and the peak memory of them all."""
    import statistics

    import torch

    from akka_allreduce_tpu_torch.models import SyntheticCopyLM
    from akka_allreduce_tpu_torch.train import LongContextTrainer

    torch.cuda.reset_peak_memory_stats()
    trainer = LongContextTrainer(**LM, seq_len=LM_SEQ, compute_dtype=dtype or torch.bfloat16,
                                 learning_rate=1e-3, seed=SEED, device=dev)
    batches = list(SyntheticCopyLM(LM_SEQ, vocab=LM["vocab"], seed=SEED + 1).batches(
        batch, steps + 3))
    trainer.train_step(*batches[0])
    times = []
    for x, y in batches[1:steps + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    def two_steps():
        for x, y in batches[steps + 1:steps + 3]:
            trainer.train_step(x, y)

    out = {
        "param_count": trainer.param_count,
        "step_ms": statistics.median(times),
        "step_ms_all": times,
        "profile": {**profile_window(two_steps, top=12), "steps": 2},
    }
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del trainer
    torch.cuda.empty_cache()
    return out


def profile_window(fn, top: int = 6) -> dict:
    """``fn()`` under ``torch.profiler``: the host-clock wall time, the
    summed device time of its kernels (user annotations such as
    ``Optimizer.step#Adam.step`` left out: they would count their kernels
    twice; kernel names may hold ``#`` too, as in ``{lambda(float)#1}``),
    the device's busy share, the ``top`` kernels by device time and every
    K4 kernel (``flash_*``) and K1 kernel (``masked_average_kernel``) with
    its device time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)
               and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in ranked],
            "flash": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                      for e in kernels if "flash_" in e.key],
            "k1": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                   for e in kernels if "masked_average_kernel" in e.key]}


def profile_lm(model, tokens, steps: int = 8) -> dict:
    """One prefill and ``steps`` greedy decode steps of ``model`` under
    ``torch.profiler``: for each, the host-clock wall time, the summed
    device time of its kernels, the device's busy share and the kernels
    that took the most device time."""
    import torch

    from akka_allreduce_tpu_torch.models import LMGenerator

    gen = LMGenerator(model, max_len=tokens.shape[1] + steps + 1)
    cache = gen.init_cache(tokens.shape[0])

    out = {}
    with torch.no_grad():
        out["prefill"] = profile_window(lambda: model(tokens, cache))
        tok = tokens[:, -1:]

        def decode():
            nonlocal tok
            for _ in range(steps):
                tok = torch.argmax(model(tok, cache)[:, -1], dim=-1)[:, None]

        out["decode"] = profile_window(decode)
    out["decode"]["steps"] = steps
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run", file=sys.stderr)
        return 1

    from akka_allreduce_tpu_torch import bench, bench_suite
    from akka_allreduce_tpu_torch.comm import measure_allreduce, threshold_allreduce
    from akka_allreduce_tpu_torch.config import ThresholdConfig
    from akka_allreduce_tpu_torch.ops import _build
    from akka_allreduce_tpu_torch.ops import local_reduce as lr
    from akka_allreduce_tpu_torch.ops import ring as rk
    from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
    from akka_allreduce_tpu_torch.utils import MetricsLogger, card_info, cuda_event_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick in fp32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. card --------------------------------------------------------------
    card = card_info(dev)
    phase("card", t_start, name=card["name"], power_limit=card["power_limit"],
          count=card["count"])

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build("local_reduce", "ring", "flash_attention_3xtf32",
                         "flash_attention_wgmma", "flash_attention_bwd_3xtf32",
                         "flash_attention_bwd_wgmma")
    for path in paths.values():
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print("\n".join(ptxas), file=sys.stderr)
    phase("build", t0, libraries=[str(p.name) for p in paths.values()])

    def threshold_mask(k: int, gen: torch.Generator) -> torch.Tensor:
        """The first reduce_count(k) workers of a seeded arrival order."""
        need = ThresholdConfig(th_reduce=0.75).reduce_count(k)
        order = torch.randperm(k, generator=gen)
        valid = torch.zeros(k)
        valid[order[:need]] = 1.0
        return valid.to(dev)

    def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
        require(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                f"{what}: max abs err {err}")
        return err

    def check_pair(x: torch.Tensor, valid: torch.Tensor, what: str) -> tuple[float, float]:
        """K1 and K2 on x (K, data) or packed, each against its plain version;
        returns (K1 error, K2 error). x is left untouched."""
        flat = x.reshape(x.shape[0], -1)
        avg, count = lr.masked_average(flat, valid)
        ref_avg, ref_count = lr.masked_average_reference(flat, valid)
        e1 = compare(avg, ref_avg, f"masked_average {what}")
        require(float(count) == float(ref_count), f"count {what}")
        del avg, ref_avg
        xk = x.clone()
        out = lr.elastic_average_step(xk, valid, ALPHA)
        require(out is xk, "elastic_average_step returns the caller's tensor")
        ref = lr.elastic_average_step_reference(x, valid, ALPHA)
        e2 = compare(xk, ref, f"elastic_average_step {what}")
        return e1, e2

    # -- 3. kernel vs plain -----------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mask_gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((K_WORKERS, DATA), generator=gen, device=dev)
    valid = threshold_mask(K_WORKERS, mask_gen)
    require(int(valid.sum()) == 12, "12-of-16 threshold mask")
    err = {"masked_average": 0.0, "elastic_average_step": 0.0}

    def note(errs: tuple[float, float]) -> None:
        err["masked_average"] = max(err["masked_average"], errs[0])
        err["elastic_average_step"] = max(err["elastic_average_step"], errs[1])

    note(check_pair(x, valid, f"K={K_WORKERS} x {DATA}"))
    torch.cuda.empty_cache()
    # the bench's packed K = 8 stacks (configs 2 and 4, bench.py)
    for floats in (64 * 1024 * 1024, 25_000_000):
        xb = lr.pack_tiles(torch.randn((8, floats // 8), generator=gen, device=dev))
        note(check_pair(xb, torch.ones(8, device=dev), f"packed {tuple(xb.shape)}"))
        del xb

    zeros = torch.zeros(K_WORKERS, device=dev)
    avg, count = lr.masked_average(x, zeros)
    require(float(count) == 0.0 and not bool(avg.any()), "zero mask: zeros and count 0")
    xz = x.clone()
    lr.elastic_average_step(xz, zeros, ALPHA)
    require(torch.equal(xz.view(torch.int32), x.view(torch.int32)),
            "zero mask: elastic_average_step leaves X bit-identical")
    del xz, avg
    torch.cuda.empty_cache()

    small = []
    for k, data in ((16, 1000), (16, 17), (16, 65537), (3, 1000), (40, 1000), (40, 17)):
        xs = torch.randn((k, data), generator=gen, device=dev)
        small.append(check_pair(xs, threshold_mask(k, mask_gen), f"K={k} x {data}"))
        # a 16-byte-misaligned but contiguous stack takes the scalar path
        buf = torch.randn(k * data + 1, generator=gen, device=dev)
        small.append(check_pair(buf[1:].view(k, data), threshold_mask(k, mask_gen),
                                f"misaligned K={k} x {data}"))
    torch.cuda.synchronize()
    phase("kernel_vs_plain", t0, max_abs_err=err,
          small_max_abs_err=[max(e[0] for e in small), max(e[1] for e in small)],
          tolerance={"rtol": RTOL, "atol": ATOL})

    # -- 3b. K3 vs plain ----------------------------------------------------------
    t0 = time.perf_counter()

    def check_ring(got: torch.Tensor, want: torch.Tensor, mode, what: str) -> float:
        """K3 against its plain version, bit for bit in every mode; every
        rank's row against rank 0's (int8 within rtol 2e-6, atol 1e-6: each
        gather hop requantizes, as on the TPU). Returns the largest absolute
        difference."""
        err_ = compare(got, want, what)
        require(torch.equal(got, want), f"{what}: not bit-identical")
        for d in range(1, got.shape[0]):
            if mode == "int8":
                require(torch.allclose(got[d], got[0], rtol=2e-6, atol=1e-6),
                        f"{what}: rank {d} differs from rank 0")
            else:
                require(torch.equal(got[d], got[0]),
                        f"{what}: rank {d} differs from rank 0")
        return err_

    # per kernel (ring_kernel<0|1|2>: f32, bf16, int8): registers and spills
    ring_ptxas = [ln.strip() for ln in paths["ring"].with_suffix(".log").read_text()
                  .splitlines()
                  if "registers" in ln or "spill" in ln or "entry function" in ln]
    print("ring ptxas:\n" + "\n".join(ring_ptxas), flush=True)
    ring_small = 0.0
    for n in (2, 3, 4, 8, 16, 24):
        for seg_rows in (1, 4, 512):
            xs = torch.randn((n, 2 * n * seg_rows * 128 + 37), generator=gen,
                             device=dev)
            keep = xs.clone()
            for mode in RING_MODES:
                before = rk.LAUNCHES["ring_allreduce"]
                got = rk.ring_kernel_allreduce_sum(xs, seg_rows=seg_rows, compress=mode)
                require(rk.LAUNCHES["ring_allreduce"] == before + 1,
                        "one ring launch a call")
                want = rk.ring_kernel_allreduce_sum_reference(
                    xs, seg_rows=seg_rows, compress=mode)
                ring_small = max(ring_small, check_ring(
                    got, want, mode, f"ring n={n} seg_rows={seg_rows} {mode}"))
            require(torch.equal(xs, keep), f"ring n={n}: the stack is never written")
            del xs, keep, got, want
    for n in (3, 8, 16, 24):  # a per-rank mask applied inside the kernel
        xs = torch.randn((n, 3 * n * 4 * 128 + 53), generator=gen, device=dev)
        vm = (torch.arange(n, device=dev) % 3 != 1).float()
        for mode in RING_MODES:
            ring_small = max(ring_small, check_ring(
                rk.ring_kernel_allreduce_sum(xs, seg_rows=4, compress=mode, valid=vm),
                rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=4, compress=mode,
                                                       valid=vm),
                mode, f"ring n={n} masked {mode}"))
    # int8 segments wider than one cluster's item: a team of clusters agrees
    wide_data = 2 * 8 * 2048 * 128 + 37
    wide = rk.ring_plan(8, data=wide_data, seg_rows=2048, compress="int8")
    require(wide["team"] > 1, f"int8 team across clusters: {wide}")
    xs = torch.randn((8, wide_data), generator=gen, device=dev)
    ring_small = max(ring_small, check_ring(
        rk.ring_kernel_allreduce_sum(xs, seg_rows=2048, compress="int8"),
        rk.ring_kernel_allreduce_sum_reference(xs, seg_rows=2048, compress="int8"),
        "int8", "ring n=8 seg_rows=2048 int8 (team)"))
    del xs
    xz = torch.randn((4, 4 * 4 * 128), generator=gen, device=dev)
    xz[:, :4 * 128] = 0.0  # an all-zero int8 segment on every rank
    zr = rk.ring_kernel_allreduce_sum(xz, seg_rows=4, compress="int8")
    check_ring(zr, rk.ring_kernel_allreduce_sum_reference(xz, seg_rows=4,
                                                          compress="int8"),
               "int8", "ring int8 all-zero segment")
    require(not bool(zr[:, :4 * 128].any()), "all-zero segment reduces to zeros")

    xr = torch.randn((RING_RANKS, RING_FLOATS), generator=gen, device=dev)
    ring_valid = threshold_mask(RING_RANKS, mask_gen)
    require(int(ring_valid.sum()) == 6, "6-of-8 threshold mask")
    ring_ref = {}  # rank 0's plain-K3 result per mode, for the main path
    ring_plans = {}
    for mode in RING_MODES:
        got = rk.ring_kernel_allreduce_sum(xr, compress=mode, valid=ring_valid)
        want = rk.ring_kernel_allreduce_sum_reference(xr, compress=mode, valid=ring_valid)
        err[ring_name(mode)] = check_ring(
            got, want, mode, f"ring {RING_RANKS} x {RING_FLOATS} {mode}")
        ring_ref[mode] = want[0].clone()
        ring_plans[ring_name(mode)] = rk.ring_plan(RING_RANKS, data=RING_FLOATS,
                                                   compress=mode)
        del got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("ring_vs_plain", t0, small_max_abs_err=ring_small,
          max_abs_err={ring_name(m): err[ring_name(m)] for m in RING_MODES},
          int8_team_plan=wide, plans=ring_plans, ptxas=ring_ptxas,
          tolerance={"f32": "bit-exact", "bf16": "bit-exact", "int8": "bit-exact"})

    # -- 3c. K4 vs plain ---------------------------------------------------------
    t0 = time.perf_counter()
    fwd_ptxas = ptxas_report("flash_attention_3xtf32", paths[
        "flash_attention_3xtf32"].with_suffix(".log").read_text())
    print("flash_attention_3xtf32 ptxas: " + json.dumps(fwd_ptxas), flush=True)
    require(len(fwd_ptxas) == 8 and all("registers" in r for r in fwd_ptxas.values()),
            f"ptxas report of every flash_attention_3xtf32 kernel: {sorted(fwd_ptxas)}")
    flash_err, flash_other, flash_lse = check_flash(dev, gen)
    err.update(flash_err)
    phase("flash_vs_plain", t0, max_abs_err=flash_err,
          other_shapes_max_abs_err=flash_other, lse_max_abs_err=flash_lse,
          ptxas=fwd_ptxas,
          tolerance={"f32": {"rtol": FLASH_TOL["float32"], "atol": FLASH_TOL["float32"]},
                     "bf16": {"rtol": FLASH_TOL["bfloat16"],
                              "atol": FLASH_TOL["bfloat16"]}, "lse_abs": 1e-4})

    # -- 3d. K4's backward vs plain ------------------------------------------------
    t0 = time.perf_counter()
    bwd_ptxas = {}
    for lib_name in ("flash_attention_bwd_wgmma", "flash_attention_bwd_3xtf32"):
        report = ptxas_report(lib_name, paths[lib_name].with_suffix(".log").read_text())
        print(f"{lib_name} ptxas: " + json.dumps(report), flush=True)
        require(len(report) == 16 and all("registers" in r for r in report.values()),
                f"ptxas report of every {lib_name} kernel: {sorted(report)}")
        bwd_ptxas[lib_name] = report
    bwd = check_flash_bwd(dev, gen)
    err.update(bwd["err"])
    phase("flash_bwd_vs_plain", t0, max_err_of_max_grad=bwd["err"],
          other_shapes_max_err_of_max_grad=bwd["other"],
          lse_max_abs_err=bwd["lse_max_abs_err"],
          local_attention_autograd_err=bwd["autograd_err"], ptxas=bwd_ptxas,
          repeat="bit-identical (every shape launched twice)",
          tolerance={"f32": BWD_TOL["float32"], "bf16": BWD_TOL["bfloat16"],
                     "of": "max|grad| of the plain version", "lse_abs": 1e-4})

    # -- 4. main path -------------------------------------------------------------
    t0 = time.perf_counter()
    x0 = x.clone()
    round_gen = torch.Generator().manual_seed(SEED + 1)
    masks = [threshold_mask(K_WORKERS, round_gen) for _ in range(ROUNDS)]
    for key in lr.LAUNCHES:
        lr.LAUNCHES[key] = 0
    xt = lr.pack_tiles(x)  # DATA is a whole number of tiles: a view of x
    results = []
    for v in masks:
        results.append(lr.masked_average(x, v))  # the round's output
        lr.elastic_average_step(xt, v, ALPHA)  # folded into every replica
    per_round = {key: n / ROUNDS for key, n in lr.LAUNCHES.items()}
    bench_rec = bench.main([])
    records = bench_suite.run_suite(quick=False, device=dev)
    torch.cuda.synchronize()
    launches = dict(lr.LAUNCHES)
    require(all(n > 0 for n in launches.values()), f"every kernel launched: {launches}")

    # the same rounds through the plain versions (no kernel launches)
    for r, v in enumerate(masks):
        ref_avg, ref_count = lr.masked_average_reference(x0, v)
        avg, count = results[r]
        compare(avg, ref_avg, f"round {r} result")
        require(float(count) == float(ref_count) == 12.0, f"round {r} count")
        x0 = lr.elastic_average_step_reference(x0, v, ALPHA)
    compare(x, x0, "state after the rounds")
    require(xt.shape == (K_WORKERS, DATA // 128, 128), "packed state shape")
    del x0, results
    torch.cuda.empty_cache()
    require(bench_rec["metric"].startswith("local_threshold_reduce_bw_64Mfloat")
            and bench_rec["value"] > 0, f"bench record {bench_rec}")
    require([r["config"] for r in records] == [1, 2, 3, 4, 5], "configs 1 to 5")
    dropout_rec = records.pop()
    require(dropout_rec["remeshed"] is True and dropout_rec["rounds_completed"] == 10
            and dropout_rec["device"] == card["name"], f"record {dropout_rec}")
    engine_rec = records.pop(0)
    require(engine_rec["engine"] == "cuda" and engine_rec["throughput_mbs"] > 0
            and engine_rec["device"] == card["name"], f"record {engine_rec}")
    for rec in records:
        require(math.isfinite(rec.get("seconds_per_iter", rec.get("device_step_ms")))
                and rec.get("seconds_per_iter", rec.get("device_step_ms")) > 0
                and rec["device"] == card["name"] and rec["power_limit"]
                == card["power_limit"], f"record {rec}")
    phase("main_path", t0, rounds=ROUNDS, launches_per_round=per_round,
          launches=launches)

    # -- 4b. main path: the threshold allreduce over 8 virtual ranks ------------
    t0 = time.perf_counter()
    line8 = line_mesh(RING_RANKS)
    oracle = (xr.double() * ring_valid.double()[:, None]).sum(0)
    scale = float(oracle.abs().max())
    ring_launches, ring_records, ring_round_ms = {}, {}, {}
    ring_calls = 1 + 2 + 10  # the round, then measure_allreduce's warmup and iters
    for mode in RING_MODES:
        rk.LAUNCHES["ring_allreduce"] = 0
        res = threshold_allreduce(line8, xr, ring_valid, schedule="pallas_ring",
                                  compress=mode)
        rounds = MetricsLogger()
        rec = measure_allreduce(line8, RING_FLOATS, schedule="pallas_ring",
                                compress=mode, iters=10, warmup=2, logger=rounds)
        torch.cuda.synchronize()
        ring_launches[ring_name(mode)] = rk.LAUNCHES["ring_allreduce"]
        require(rk.LAUNCHES["ring_allreduce"] == ring_calls,
                f"one ring launch a round ({mode}): {rk.LAUNCHES['ring_allreduce']}")
        print(json.dumps(rec.to_dict()), flush=True)
        ring_records[mode] = rec.to_dict()
        ring_round_ms[ring_name(mode)] = [m.latency_s * 1e3 for m in rounds.records]
        require(rec.path == "virtual_ranks_one_card" and rec.device == card["name"]
                and rec.bus_gbps_median > 0, f"bandwidth record {rec}")
        # the same round through the plain versions: mask, plain K3, count
        compare(res.sum, ring_ref[mode], f"pallas_ring {mode} round")
        require(torch.equal(res.sum, ring_ref[mode]), f"{mode} round bit-exact")
        require(bool((res.count == 6.0).all()), f"pallas_ring {mode} count")
        tol = {None: 1e-5, "bf16": 2e-2, "int8": 8e-2}[mode]
        rel = float((res.sum.double() - oracle).abs().max()) / scale
        require(rel < tol, f"pallas_ring {mode} vs the f64 sum: {rel}")
        del res
    del oracle, ring_ref
    torch.cuda.empty_cache()
    phase("ring_main_path", t0, launches=ring_launches, calls=ring_calls,
          bus_gbps_median={ring_name(m): r["bus_gbps_median"]
                           for m, r in ring_records.items()},
          round_ms=ring_round_ms,
          note="bus GB/s over 8 virtual ranks on one card: HBM figures")

    # -- 4c. main path: the 16-rank butterfly at config 2's shape -----------------
    t0 = time.perf_counter()
    res = threshold_allreduce(grid_mesh(4, 4), x, valid, schedule="butterfly")
    oracle = torch.zeros(DATA, dtype=torch.float64, device=dev)
    for k in range(K_WORKERS):
        oracle += x[k].double() * float(valid[k])
    torch.cuda.synchronize()
    require(res.sum.shape == (DATA,) and bool(torch.isfinite(res.sum).all()),
            "butterfly sum finite")
    require(bool((res.count == 12.0).all()), "butterfly count 12")
    bf_err = float((res.sum.double() - oracle).abs().max())
    require(torch.allclose(res.sum.double(), oracle, rtol=1e-5, atol=1e-5),
            f"butterfly vs the f64 sum: {bf_err}")
    del res, oracle
    bf_ms = []
    for _ in range(3):  # the round's time on the host clock, warmed
        t1 = time.perf_counter()
        threshold_allreduce(grid_mesh(4, 4), x, valid, schedule="butterfly")
        torch.cuda.synchronize()
        bf_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.empty_cache()
    phase("butterfly_main_path", t0, ranks=K_WORKERS, floats=DATA,
          max_abs_err_vs_f64=bf_err, round_ms=bf_ms)

    # -- 4d. main path: the Transformer LM's serving path -------------------------
    t0 = time.perf_counter()
    lm = lm_main_path(dev)
    rec = lm["record"]
    print(f"lm serving (B {LM_BATCH}, prompt {LM_SEQ}, bf16, {card['name']}, "
          f"{card['power_limit']}): prefill {rec['prefill_ms']:.3f} ms, decode "
          f"{rec['ms_per_token']:.3f} ms/token", flush=True)
    phase("lm_main_path", t0, launches=lm["launches"], launches_by_part=lm["per_part"],
          forward_vs_decode_logits_max_abs=lm["oracle_err"],
          max_abs_logit=lm["max_abs_logit"], tolerance_rel=LOGIT_TOL,
          bf16_vs_f32_logits_max_abs=lm["bf16_vs_f32_logits"],
          greedy_row0=lm["greedy"], prefill_ms=rec["prefill_ms"],
          ms_per_token=rec["ms_per_token"])

    # -- 4e. main path: the Transformer LM's training path ------------------------
    t0 = time.perf_counter()
    train = lm_train_path(dev)
    phase("lm_train_path", t0, launches=train["launches"],
          launches_by_part=train["per_part"], flagship_losses=train["losses"],
          model_grad_f32_max_err_of_max_grad=train["model_grad_err"],
          model_grad_tolerance=MODEL_GRAD_TOL, copy_task=train["copy"])

    # -- 4f. main path: the DP trainer on the MLP over virtual ranks -------------
    t0 = time.perf_counter()
    dp = dp_train_path(dev)
    phase("dp_train_path", t0, launches={"masked_average": dp["launches"]},
          launches_by_part=dp["per_part"], losses=dp["losses"], masked_step=dp["masked_step"],
          compressed=dp["compressed"], config3={k: dp["config3"][k] for k in (
              "step_ms", "device_step_ms", "loss_first", "loss_last", "steps_taken")},
          bench_mfu={k: dp["bench_mfu"][k] for k in ("value", "ms_per_step", "spread_pct")},
          k1_vs_plain="bit-identical on the step's (8, 5824522) stack, and the update",
          overlap=dp["overlap"], accum=dp["accum"],
          train_mlp_overlap_accum=dp["train_mlp_overlap_accum"])

    # -- 4g. main path: the DP trainer on ResNet-50 over virtual ranks ------------
    t0 = time.perf_counter()
    rn = resnet_train_path(dev)
    phase("resnet_train_path", t0, launches={"masked_average": rn["launches"]},
          launches_by_part=rn["per_part"], forward_f32_vs_cpu_of_max_logit=rn["forward_err"],
          losses=rn["losses"], overlap_loss=rn["overlap_loss"], accum_loss=rn["accum_loss"],
          bf16_loss=rn["bf16_loss"], int8_ef_loss=rn["int8_ef_loss"],
          train_resnet=rn["train_resnet"],
          bench_mfu={k: rn["bench_mfu"][k] for k in ("value", "ms_per_step", "spread_pct")},
          k1_vs_plain=f"bit-identical on the step's (8, {RESNET_PARAMS}) stack, and the update")

    # -- 4h. the host engine, its round buffers on the card -----------------------
    t0 = time.perf_counter()
    eng = host_engine_path(dev, card)
    big = eng["resnet_grad"]
    phase("host_engine_path", t0, k1_k4_launches=eng["k1_k4_launches"],
          config1={"throughput_mbs": eng["config1"]["record"]["throughput_mbs"],
                   "seconds": eng["config1"]["record"]["seconds"],
                   "cpu_throughput_mbs": eng["config1"]["cpu_throughput_mbs"],
                   "flushes_equal_to_cpu": eng["config1"]["flushes_equal"],
                   "buffers_seen_on_card": eng["config1"]["buffers_seen_on_card"]},
          config1_profile={k: eng["config1_profile"][k] for k in (
              "dtoh", "htod", "launches_per_round", "dtod_per_round", "busy_share",
              "wall_ms", "device_ms", "top")},
          resnet_grad={k: big[k] for k in (
              "seconds", "throughput_mbs", "round_ms_median", "round_ms", "cpu_seconds",
              "cpu_throughput_mbs", "flushes_equal")},
          resnet_grad_profile={k: big["profile"][k] for k in (
              "dtoh", "htod", "dtod", "launches", "busy_share", "wall_ms", "device_ms",
              "top")},
          dropout=eng["dropout"], butterfly_2d=eng["butterfly_2d"], elastic=eng["elastic"])

    # -- 4i. checkpoints and resume, ZeRO-1 ----------------------------------------
    t0 = time.perf_counter()
    ck = checkpoint_path(dev, card)
    phase("checkpoint_path", t0, launches=ck["launches"],
          launches_by_part=ck["launches_by_part"], disk_free_gb=ck["disk_free_gb"],
          zero1_f32=ck["zero1_f32"], zero1_bf16_ef=ck["zero1_bf16_ef"],
          remesh_8_to_4=ck["remesh_8_to_4"], resume_zero1=ck["resume_zero1"],
          resume_dp_int8_ef=ck["resume_dp_int8_ef"], resume_lm_bf16=ck["resume_lm_bf16"],
          bench_checkpoint={k: {f: r[f] for f in (
              "async_capture_stall_s", "async_save_wall_s", "steps_during_async_save",
              "baseline_ms_per_step", "ms_per_step_during_save", "sync_save_stall_s",
              "delta_stats", "state_gb", "params_m")} for k, r in ck["bench_checkpoint"].items()},
          resume="every store, every trainer: the restored state is the state at save and "
          "the resumed steps bit-equal to the saver's")

    # -- 4j. the TCP control plane, the nodes' round buffers on the card ---------
    t0 = time.perf_counter()
    cl = cluster_path(dev, card)
    phase("cluster_path", t0, card=card["smi"], k1_k4_launches=cl["k1_k4_launches"],
          native_build_s=cl["native_build_s"],
          **{k: cl[k] for k in ("config1_cuda", "butterfly_2d", "dropout_th075",
                                "late_joiner", "int8_ef")},
          bench_wire=cl["bench_wire"])

    # -- 4k. elasticity: re-mesh cycles, the training cluster ---------------------
    t0 = time.perf_counter()
    el = elastic_path(dev, card)
    phase("elastic_path", t0, card=card["smi"], launches={"masked_average": el["launches"]},
          launches_by_part=el["launches_by_part"],
          **{k: el[k] for k in ("config5", "dp_cycle", "ladder", "int8_ef",
                                "train_cluster_mlp", "train_cluster_lm", "elastic_demo")})

    # -- 4l. chaos: the seeded schedule, the drills, the router's injector ------
    t0 = time.perf_counter()
    ch = chaos_path(dev, card)
    phase("chaos_path", t0, card=card["smi"], launches={"masked_average": ch["launches"]},
          launches_by_part=ch["launches_by_part"],
          **{k: v for k, v in ch.items() if k not in ("card", "launches", "launches_by_part")})

    # -- 4m. the int8 KV cache and MoE on one card ---------------------------------
    t0 = time.perf_counter()
    mi = moe_int8_path(dev, card, el["config5"])
    phase("moe_int8_path", t0, card=card["smi"], launches=mi["launches"],
          **{k: v for k, v in mi.items() if k != "launches"})

    # -- 4n. sequence and tensor parallelism over virtual ranks ---------------------
    t0 = time.perf_counter()
    sq = sharded_lm_path(dev, card)
    phase("sharded_lm_path", t0, card=card["smi"], launches=sq["launches"],
          **{k: v for k, v in sq.items() if k not in ("launches", "profile")})

    # the timings' stacks wait on the host while phases (o) and (p) run: the
    # bench-width MoE step over (2, 4) peaks at 73.5 GB of the card's 80
    parked = {"x": x.cpu(), "xr": xr.cpu()}
    del x, xt, xr
    torch.cuda.empty_cache()

    # -- 4o. sharded decode over virtual ranks ---------------------------------------
    t0 = time.perf_counter()
    sd = sharded_decode_path(dev, card)
    phase("sharded_decode_path", t0, card=card["smi"], launches=sd["launches"],
          **{k: v for k, v in sd.items() if k != "launches"})

    # -- 4p. MoE over virtual ranks ----------------------------------------------------
    t0 = time.perf_counter()
    mp = moe_parallel_path(dev, card)
    phase("moe_parallel_path", t0, card=card["smi"], launches=mp["launches"],
          **{k: v for k, v in mp.items() if k not in ("launches", "profile")})

    x, xr = parked["x"].to(dev), parked["xr"].to(dev)
    del parked

    # -- 5. timings at K = 16 x 64M -----------------------------------------------
    t0 = time.perf_counter()
    k = K_WORKERS
    ones = torch.ones(k, device=dev)
    keep, pull = 1.0 - ALPHA, ALPHA

    def library_average():
        return torch.mv(x.t(), valid) / torch.clamp_min(valid.sum(), 1.0)

    def library_step():
        x.addr_(ones, library_average(), beta=keep, alpha=pull)

    timing = {
        "masked_average": {
            "ms": cuda_event_ms(lambda: lr.masked_average(x, valid), 20),
            "plain_ms": cuda_event_ms(lambda: lr.masked_average_reference(x, valid), 5),
            "library_ms": cuda_event_ms(library_average, 20),
            "bytes": (k * DATA + k + DATA + 1) * 4,
            "ops": 2 * k * DATA + DATA,
        },
        "elastic_average_step": {
            "ms": cuda_event_ms(lambda: lr.elastic_average_step(x, valid, ALPHA), 20),
            "plain_ms": cuda_event_ms(
                lambda: lr.elastic_average_step_reference(x, valid, ALPHA), 5),
            "library_ms": cuda_event_ms(library_step, 20),
            "bytes": (2 * k * DATA + k) * 4,
            "ops": 2 * k * DATA + DATA + 3 * k * DATA,
        },
    }
    require(bool(torch.isfinite(x).all()), "state finite after the timing loops")
    del x
    torch.cuda.empty_cache()

    # K3 at 8 x 25M padded to whole buckets (the shape every earlier timing used)
    n = RING_RANKS
    padded = -(-RING_FLOATS // (n * 512 * 128)) * n * 512 * 128
    xp = torch.nn.functional.pad(xr, (0, padded - RING_FLOATS))
    del xr
    hops = 2 * (n - 1) * padded  # elements sent over all ranks and steps
    per_element_ops = {None: 0, "bf16": 2, "int8": 6}  # cast pair / int8 codec
    for mode in RING_MODES:
        timing[ring_name(mode)] = {
            "ms": cuda_event_ms(
                lambda: rk.ring_kernel_allreduce_sum(xp, compress=mode), 10),
            "plain_ms": cuda_event_ms(
                lambda: rk.ring_kernel_allreduce_sum_reference(xp, compress=mode), 3),
            "library_ms": cuda_event_ms(
                lambda: xp.sum(0, keepdim=True).expand_as(xp).contiguous(), 10)
            if mode is None else None,
            "bytes": 2 * n * padded * 4,
            "ops": (n - 1) * padded + per_element_ops[mode] * hops,
        }
    del xp
    torch.cuda.empty_cache()

    # K4 at the flagship shape (bf16) and in f32 at B 2, causal
    from akka_allreduce_tpu_torch.ops import flash_attention as fa

    heads, hd = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    for dt, bb in ((torch.bfloat16, LM_BATCH), (torch.float32, 2)):
        q, k, v = (torch.randn((bb, LM_SEQ, heads, hd), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))  # SDPA's (B, H, T, D)
        timing[flash_name(dt)] = {
            "ms": cuda_event_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20),
            "plain_ms": cuda_event_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=True), 3),
            "library_ms": cuda_event_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 20),
            "bytes": 4 * q.numel() * q.element_size(),
            "ops": 4 * bb * heads * LM_SEQ * LM_SEQ * hd / 2,
            "ops_per_s": BF16_OPS_PER_S if dt == torch.bfloat16 else TF32X3_OPS_PER_S,
        }
        tk = timing[flash_name(dt)]
        print(f"K4 forward {flash_name(dt)} (B {bb}, T {LM_SEQ}, H {heads}, D {hd}, "
              f"causal; {fa.forward_kernel(dt)}): {tk['ms']:.4f} ms, "
              f"{tk['ops'] / tk['ms'] / 1e9:.1f} TFLOP/s; SDPA {tk['library_ms']:.4f} ms, "
              f"{tk['ops'] / tk['library_ms'] / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, qt, kt, vt
    # K4's backward at the same shapes: the wrapper (both kernels, di inside
    # the first) beside the plain version and SDPA's backward (forward +
    # backward minus forward); the bound is its five products
    for dt, bb in ((torch.bfloat16, LM_BATCH), (torch.float32, 2)):
        q, k, v, do = (torch.randn((bb, LM_SEQ, heads, hd), generator=gen,
                                   device=dev).to(dt) for _ in range(4))
        o, lse = fa._forward(q, k, v, True, hd ** -0.5)
        ql, kl, vl = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
        dol = do.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), (ql, kl, vl), dol)

        sdpa_ms = cuda_event_ms(sdpa, 20)
        name = "flash_attention_bwd_" + ("bf16" if dt == torch.bfloat16 else "f32")
        timing[name] = {
            "ms": cuda_event_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True), 10),
            "plain_ms": cuda_event_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True),
                3),
            "library_ms": cuda_event_ms(sdpa_both, 10) - sdpa_ms,
            "bytes": 8 * q.numel() * q.element_size() + lse.numel() * 4,
            "ops": 5 * bb * heads * LM_SEQ * LM_SEQ * hd,
            "ops_per_s": BF16_OPS_PER_S if dt == torch.bfloat16 else TF32X3_OPS_PER_S,
        }
        del q, k, v, do, o, lse, ql, kl, vl, dol
        torch.cuda.empty_cache()
    model, tokens = lm.pop("model"), lm.pop("tokens")
    with torch.no_grad():
        forward_ms = cuda_event_ms(lambda: model(tokens), 5, warmup=1)
    flash_share = LM["n_layers"] * timing["flash_attention_bf16"]["ms"] / forward_ms
    prof = profile_lm(model, tokens)
    print(json.dumps({"profile": prof}), flush=True)
    del model, tokens
    torch.cuda.empty_cache()

    # the flagship training step, its profile, and bench-mfu's slope-timed MFU
    from akka_allreduce_tpu_torch.__main__ import main as cli_main
    from akka_allreduce_tpu_torch.utils import transformer_train_flops

    step = time_train_step(dev)
    print(json.dumps({"train_profile": step["profile"]}), flush=True)
    # the flagship width's f32 training step at B 2: K4's f32 forward and
    # backward run 8 times each in it, at the shape timed above
    step32 = time_train_step(dev, torch.float32, batch=2)
    print(json.dumps({"train_profile_f32": step32["profile"]}), flush=True)
    k4_fwd_f32_share = (LM["n_layers"] * timing["flash_attention_f32"]["ms"]
                        / step32["step_ms"])
    k4_bwd_f32_share = (LM["n_layers"] * timing["flash_attention_bwd_f32"]["ms"]
                        / step32["step_ms"])
    floor_ms = transformer_train_flops(
        n_params=step["param_count"], batch=LM_BATCH, seq=LM_SEQ,
        d_model=LM["d_model"], n_layers=LM["n_layers"]) / BF16_OPS_PER_S * 1e3
    k4_train_share = LM["n_layers"] * (timing["flash_attention_bf16"]["ms"] + timing[
        "flash_attention_bwd_bf16"]["ms"]) / step["step_ms"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        require(cli_main(["bench-mfu"]) == 0, "bench-mfu")
    mfu_rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(mfu_rec), flush=True)
    require(mfu_rec["value"] is not None and 0 < mfu_rec["value"] < 1
            and mfu_rec["device"] == card["name"], f"bench-mfu record {mfu_rec}")
    torch.cuda.empty_cache()

    # the DP step at bench-mfu's width, K1's share of it, its profile
    dp_time = time_dp_step(dp)
    print(json.dumps({"dp_profile": dp_time["profile"]}), flush=True)
    dp_launches = dp["launches"]
    del dp
    torch.cuda.empty_cache()
    rn_time = time_dp_step(rn)
    print(json.dumps({"resnet_profile": rn_time["profile"],
                      "resnet_overlap_profile": rn_time["overlap_profile"]}), flush=True)
    dp_launches += rn["launches"]
    rn_mfu = rn["bench_mfu"]
    del rn
    torch.cuda.empty_cache()

    path_launches = {**launches, **ring_launches}
    path_launches["masked_average"] += dp_launches + el["launches"] + ch["launches"]
    for part in (lm["launches"], train["launches"], ck["launches"], mi["launches"],
                 sq["launches"], sd["launches"], mp["launches"]):
        for name, n in part.items():
            path_launches[name] = path_launches.get(name, 0) + n
    kernels = []
    for name, t in timing.items():
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / t.get("ops_per_s", FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": path_launches[name],
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": bound_by,
            "library_ms": t["library_ms"],
        })
        library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"{name}: {t['ms']:.4f} ms, {t['bytes'] / t['ms'] / 1e6:.1f} GB/s, "
              f"{t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s "
              f"({max(bytes_ms, ops_ms) / t['ms'] * 100:.1f}% of the bound "
              f"{max(bytes_ms, ops_ms):.4f} ms, by {bound_by}); plain "
              f"{t['plain_ms']:.4f} ms; library {library}", flush=True)
    for name in ("flash_attention_f32", "flash_attention_bwd_f32"):
        t = timing[name]
        print(f"{name}: {t['ops'] / TF32X3_OPS_PER_S * 1e3 / t['ms'] * 100:.1f}% of the "
              f"split-TF32 bound {t['ops'] / TF32X3_OPS_PER_S * 1e3:.4f} ms, "
              f"{t['ops'] / FP32_OPS_PER_S * 1e3 / t['ms'] * 100:.1f}% of the f32-FMA "
              f"bound {t['ops'] / FP32_OPS_PER_S * 1e3:.4f} ms; SDPA "
              f"{t['ops'] / TF32X3_OPS_PER_S * 1e3 / t['library_ms'] * 100:.1f}% of the "
              f"split-TF32 bound", flush=True)
    print(f"flagship bf16 forward (B {LM_BATCH} x T {LM_SEQ}): {forward_ms:.3f} ms; "
          f"K4 x {LM['n_layers']} = {flash_share * 100:.1f}% of it", flush=True)
    print(f"flagship bf16 train step (B {LM_BATCH} x T {LM_SEQ}, {card['name']}, "
          f"{card['power_limit']}): {step['step_ms']:.3f} ms (floor {floor_ms:.1f} ms "
          f"at {BF16_OPS_PER_S / 1e12:.1f} TFLOP/s); K4 forward + backward x "
          f"{LM['n_layers']} = {k4_train_share * 100:.1f}% of it; device busy "
          f"{step['profile']['busy_share'] * 100:.1f}%; bench-mfu "
          f"{mfu_rec['ms_per_step']} ms/step, MFU {mfu_rec['value']}", flush=True)
    print(f"flagship-width f32 train step (B 2 x T {LM_SEQ}, {card['name']}, "
          f"{card['power_limit']}): {step32['step_ms']:.3f} ms (median of "
          f"{len(step32['step_ms_all'])}, host clock); K4 forward x {LM['n_layers']} = "
          f"{k4_fwd_f32_share * 100:.1f}% and backward x {LM['n_layers']} = "
          f"{k4_bwd_f32_share * 100:.1f}% of it; device busy "
          f"{step32['profile']['busy_share'] * 100:.1f}%", flush=True)
    k1 = dp_time["k1"]
    print(f"DP step, MLP(2048, 2048) over {DP_RANKS} virtual ranks x {DP_ROWS} rows, f32 "
          f"({card['name']}, {card['power_limit']}): {dp_time['step_ms']:.3f} ms (median "
          f"of {len(dp_time['step_ms_all'])}, host clock); K1 on the ({DP_RANKS}, "
          f"{DP_PARAMS}) stack {k1['ms']:.4f} ms ({k1['bound_ms'] / k1['ms'] * 100:.1f}% "
          f"of its {k1['bound_ms']:.4f} ms bound; plain {k1['plain_ms']:.4f} ms, library "
          f"{k1['library_ms']:.4f} ms) = {dp_time['k1_share'] * 100:.2f}% of the step; "
          f"device busy {dp_time['profile']['busy_share'] * 100:.1f}%", flush=True)
    for label, tm, p in (("MLP(2048, 2048)", dp_time, DP_PARAMS),
                         ("ResNet-50", rn_time, RESNET_PARAMS)):
        ok1 = tm["overlap_k1"]
        print(f"DP {label}, {card['name']}, {card['power_limit']}: fused step "
              f"{tm['step_ms']:.3f} ms, overlapped {tm['overlap_step_ms']:.3f} ms, accumulated "
              f"over {tm['accum_steps']} microbatches {tm['accum_step_ms']:.3f} ms (medians of "
              f"{len(tm['step_ms_all'])}, host clock); K1 over an overlapped step's "
              f"{ok1['leaves']} leaves {ok1['per_leaf_total_ms']:.4f} ms by CUDA events "
              f"({ok1['device_ms_in_step']:.4f} ms of device time over "
              f"{ok1['launches_in_step']} launches in a profiled step; the overlapped step "
              f"{tm['overlap_profile']['busy_share'] * 100:.1f}% busy) against one fused "
              f"launch on (8, {p}) {ok1['fused_ms']:.4f} ms", flush=True)
    k1r = rn_time["k1"]
    print(f"ResNet-50 DP step (8 virtual ranks x {RESNET_ROWS} rows, {RESNET_SIZE} px, f32, "
          f"{card['name']}, {card['power_limit']}): {rn_time['step_ms']:.3f} ms; device busy "
          f"{rn_time['profile']['busy_share'] * 100:.1f}%; K1 on the ({DP_RANKS}, "
          f"{RESNET_PARAMS}) stack {k1r['ms']:.4f} ms ({k1r['bound_ms'] / k1r['ms'] * 100:.1f}% "
          f"of its {k1r['bound_ms']:.4f} ms bound; plain {k1r['plain_ms']:.4f} ms, library "
          f"{k1r['library_ms']:.4f} ms) = {rn_time['k1_share'] * 100:.2f}% of the step; "
          f"bench-mfu --workload resnet {rn_mfu['ms_per_step']} ms/step, MFU "
          f"{rn_mfu['value']}", flush=True)
    phase("timings", t0, library_note="masked_average: torch.mv + sum + clamp + "
          "div; elastic_average_step: the same plus Tensor.addr_; "
          "ring_allreduce_f32: xs.sum(0, keepdim=True).expand_as(xs).contiguous(); "
          "bf16 and int8 rings: none; flash_attention: "
          "F.scaled_dot_product_attention(is_causal=True) on (B, H, T, D) views; "
          "flash_attention_bwd: the same call's forward + backward "
          "(torch.autograd.grad) minus its forward",
          ring_shape=[RING_RANKS, padded], flash_shape={"bf16": [LM_BATCH, LM_SEQ, heads, hd],
                                               "f32": [2, LM_SEQ, heads, hd]},
          forward_ms=forward_ms, flash_share_of_forward=flash_share,
          train_step_ms=step["step_ms"], train_step_ms_all=step["step_ms_all"],
          train_floor_ms=floor_ms, train_peak_memory_gb=step["peak_memory_gb"],
          k4_share_of_train_step=k4_train_share,
          f32_train_step_ms=step32["step_ms"], f32_train_step_ms_all=step32["step_ms_all"],
          k4_fwd_share_of_f32_train_step=k4_fwd_f32_share,
          k4_bwd_share_of_f32_train_step=k4_bwd_f32_share,
          bench_mfu={"mfu": mfu_rec["value"], "ms_per_step": mfu_rec["ms_per_step"],
                     "spread_pct": mfu_rec["spread_pct"]},
          dp_step_ms=dp_time["step_ms"], dp_step_ms_all=dp_time["step_ms_all"],
          dp_k1=dp_time["k1"], dp_k1_share=dp_time["k1_share"],
          dp_overlap_step_ms=dp_time["overlap_step_ms"], dp_overlap_k1=dp_time["overlap_k1"],
          dp_accum_step_ms=dp_time["accum_step_ms"],
          resnet_accum_step_ms=rn_time["accum_step_ms"],
          resnet_step_ms=rn_time["step_ms"], resnet_step_ms_all=rn_time["step_ms_all"],
          resnet_overlap_step_ms=rn_time["overlap_step_ms"],
          resnet_overlap_step_ms_all=rn_time["overlap_step_ms_all"],
          resnet_k1=rn_time["k1"], resnet_k1_share=rn_time["k1_share"],
          resnet_overlap_k1=rn_time["overlap_k1"],
          resnet_bench_mfu={"mfu": rn_mfu["value"], "ms_per_step": rn_mfu["ms_per_step"],
                            "spread_pct": rn_mfu["spread_pct"]},
          busy_share={"dp_step": dp_time["profile"]["busy_share"],
                      "resnet_step": rn_time["profile"]["busy_share"],
                      "prefill": prof["prefill"]["busy_share"],
                      "decode": prof["decode"]["busy_share"],
                      "train": step["profile"]["busy_share"],
                      "train_f32": step32["profile"]["busy_share"]})

    # -- 6. result lines ----------------------------------------------------------
    phase("total", t_start)
    print(json.dumps({"kernels": kernels}))
    print(card["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
