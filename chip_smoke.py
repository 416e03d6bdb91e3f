#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed on its own line(s); any failure raises and the
script exits non-zero without the final result line:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. the build: nvcc compiles the twelve kernel sources of ``src/repro_torch/
   kernels/csrc`` for sm_90a, one process each, all at once (timed, with
   ptxas' register, stack and spill report; the instances of the ADC
   searches and of the search pass ``am_search`` shares with
   ``am_search_imc`` again on a line of their own, ``ptxas_adc``), and
   beside them the tensor-core rate probe ``tools/mma_rate.cu`` and the
   empty kernel of ``tools/launch_floor.cu``;
2. each kernel against its plain PyTorch version on the card, over the
   differential geometry grid, tie and padding cases and the full-width
   shapes: ``pack_bits``, ``am_search_packed`` (both modes, every block
   size; ties planted in several column splits at B = 300 and 32) and
   ``am_search`` bit-exact (±1 queries on its int8 route, dyadic ones on
   its fp32 route, the route of every call checked); ``encode_pack``
   bit-exact on dyadic
   features and within the stated tolerance on float features;
   ``qail_update`` (every block size) bit-exact in its targets, misses
   and (at a dyadic lr and payload) its delta, and within |delta error|
   <= 2^-20 * sum|terms| at lr = 0.02; ``binary_mvm`` bit-exact on dyadic
   features and within |error| <= 2^-20 * sum|x*w| on float features;
   ``unpack_bits`` bit-exact; ``am_search_imc`` on 128x128, 64x128 and
   256x128 arrays at ADC 16, 6 and 3 bits, with and without offsets, on
   a ±1 AM (its int8 route), a dyadic-noise AM (fp32 route, bit-exact)
   and a sigma = 0.5 noise AM (fp32 route; a query may differ only where
   a tile's partial sum lies within 2^-20 * sum|terms| of an ADC rounding
   boundary); ``am_search_multibit`` at every cell width (2, 4, 8 at full
   width) on the same arrays, with offsets and a 4-bit ADC, bit-exact on
   ±1 queries (int8 route) and on dyadic non-integer ones (fp32 route);
   the route of every call is checked; ``am_shortlist`` and
   ``am_search_sparse`` (fused and ``am_search_sparse_gathered``) bit-exact
   over D in {8, 100, 1000, 1024}, G and C in {1, 2, 45, 448} and ragged
   counts, S in {1, 3, G}, k in {1, 5, candidates + 2}, forced ties and
   the global-scratch path; ``am_shortlist`` at its plan's G split, each
   launch's route (tile or stream) counted;
3. the main path at the paper's widest MNIST point
   (``paper_config("mnist", "1024x1024")``: f = 784, D = C = 1024, R =
   0.8, lr = 0.02; batch 256, 25 k-means iterations) on the full
   synthetic MNIST: ``MemhdModel.create`` -> ``fit`` ->
   ``deploy(target="packed")`` -> ``serve_batches`` staged and fused at
   depth 2; kernel launch counts are zeroed just before and read just
   after, and staged == fused == the plain ``MemhdModel.predict`` bit for
   bit on dyadic-rounded test features;
4. the training path, same model and seeds: ``fit(use_kernel=True)``
   (every minibatch one ``qail_update`` launch, 235 x 100) -> the
   trained AM deployed three ways (``target="unpacked"``,
   ``target="packed", mode="unpack"``, ``target="packed"``) -> the same
   request stream served through each; launch counts zeroed just before
   and read just after, every fit launch on ``qail_update``'s int8
   route and every unpacked serving launch on ``am_search``'s (their
   route counts); the kernel fit's binary AM agrees with the plain
   fit's on >= 99.9 % of cells and its test accuracy within 0.005; all
   pipelines and the plain predict agree on every request, and no
   dispatch fell back to the plain tier;
5. the kernel fit against the plain fit under dyadic conditions
   (features on a 2^-4 grid, lr = 2^-4): ``fp``, ``binary`` and every
   epoch's miss bit-equal, at D = C = 128 and at full width, 10 epochs,
   every kernel-fit launch on the int8 route;
6. the serving CLI: staged, ``--fused``, ``--target unpacked`` and
   ``--mode unpack``; then the port's four example drivers
   (``examples/*_torch.py``, phase ``examples``) as subprocesses on the
   card, all at once, each to a zero exit with its own check:
   ``train_lm_torch --preset smoke`` past its warm-up (the loss drops;
   every SSD chunk an ``ssd_chunk`` launch), ``imc_mapping_report_torch``
   (Table II and the head's accuracy), ``quickstart_torch`` (its parity
   asserts; every MEMHD kernel launched) and ``serve_lm_torch``
   (``flash_decode`` launched), read from each one's ``kernel launches``
   line;
7. the trainer CLI (``repro_torch.launch.train --arch memhd --smoke
   --steps 10``): a run killed at step 7 (exit 42), its resume and a
   clean run give the same ``am_digest``, on the card and on the CPU;
8. reproducibility: two 128 x 128 fits from the same seeds agree, plain
   and through the ``qail_update`` kernel;
9. the device-fidelity paths on the main path's trained model: the
   ``ops.encode_mvm`` / ``ops.unpack_bits`` entry points (phase
   ``entry_points``); ``deploy(target="imc")`` with the ideal sim (== the
   plain predict on every request, every launch on ``am_search_imc``'s
   int8 route) and with a noisy, faulty, drifting 6-bit-ADC sim (== the
   plain ``ref.am_search_imc`` on the same burned AM, every launch on its
   fp32 route), served through ``serve_batches`` (phase ``imc_path``);
   ``fit(cell_bits=4, use_kernel=True)`` -> ``deploy(target="multibit")``
   served (== the plain ``multibit_predict``, every QAT launch on
   ``qail_update``'s int8 route and every search on
   ``am_search_multibit``'s; phase ``multibit_path``);
   ``python -m repro_torch.launch.robustness_report`` at its defaults and
   at 1024 x 1024 (phase ``robustness``); launch counts zeroed just
   before each path and read just after, no ``torch-ref`` tier;
10. the hierarchical paths: ``deploy(target="hierarchical")`` of the main
   path's model (G = 45) served with ``serve_batches(topk=...)``: at S = G
   top-1 == the packed flat predictions and top-5 == ``ref.am_search_topk``
   on every request, S = 8 recall printed (phase ``hier_path``, counts
   zeroed just before and read just after); the reference's huge-label
   sweep point, a planted AM at C = 100,000, D = 1024, G = 448, clustered
   on the card by ``build_search_state``, then ``am_shortlist`` +
   ``am_search_sparse`` at S = 8 and 16, k = 1 and 5: recall@1 >= 0.99 at
   S = 8, bit-exact against the plain versions, the device time against
   the flat ``am_search_packed`` at the same C and batch; S = G at C = 512
   == ``am_search_packed`` (phase ``hier_huge``);
11. the LM inference path (phase group ``lm``): ``flash_decode`` and
   ``ssd_chunk`` against their plain versions (``lm_kernels_vs_plain``:
   GQA 5x / MHA / MQA heads, S of 1 to 32,768, ragged lengths with 0 and
   1, float32 and bfloat16; the hymba and mamba2 SSD geometries at Q of
   1, 20 and 256, chained and strided chunks); hymba-1.5b at full width
   with random weights from a seed: ``T.forward`` at B = 2, S = 2,048
   (``lm_forward``: bfloat16 on the kernel path, 256 ``ssd_chunk``
   launches; float32 kernel path == plain path within LM_TOL) and
   ``generate`` at B = 4, prompt 256, gen 64 (``lm_serve``: 32 x 319
   ``flash_decode`` launches; in float32, from a shared prefill, the
   plain path teacher-forced on the kernel path's 64 greedy steps gives
   the same logits step by step and the same greedy choices up to the
   first low-margin step, and every decode step == forward); the LM
   serving CLI at mamba2-130m (``lm_cli``); ``flash_decode`` also with
   the decode softcap (``FD_SOFTCAP``, both dtypes, every case);
   then the phase group ``lm_families``, random weights from seeds:
   deepseek-v2-lite-16b at full width in float32 cut to 1 dense + 2 MoE
   layers (``lm_deepseek_f32``: teacher-forced decode over S = 128 ==
   forward at every position within LM_TOL; one MoE layer == each token
   through its chosen experts at 512 tokens, dropless, and == the CPU at
   1024, above the 4096-slot switch, with dropped slots), at full width
   and depth (``lm_deepseek_serve``: in bfloat16 ``generate`` at B 4,
   prompt 32, gen 32 timed, decode and forward profiles, ``T.forward`` at
   B 2 x S 256 timed, peak memory; in float32 that forward's last
   position == the prefill's last decode step within 2e-2 max|logits|);
   deepseek-v3-671b at full width cut to 1 dense + 1 MoE layer plus the
   MTP block (``lm_deepseek_v3``: 8 decode steps == forward at B 2 x S
   64, peak memory); musicgen-medium and internvl2-2b at full width and
   depth (``lm_modalities``: float32 decode kernel path == plain path,
   48 x 16 and 24 x 16 ``flash_decode`` launches on the cuda tier, counts
   zeroed just before and read just after; musicgen's decode == forward
   at the last position; bfloat16 ms per step); qwen1.5-32b at full width
   cut to 8 of 64 layers with the int8 KV cache (``lm_quant``: decode over
   S = 256 == the bf16-cache decode within 5e-2 max|logits| at every step;
   the caches' bytes);
12. the ``kernels`` line: launches on the paths, device time, the plain
   version's time and the bound of each kernel at the paths' shapes
   (``qail_update`` also on random targets, where most rows miss, both on
   its int8 route, and on a noise-perturbed AM view, checked to take its
   fp32 route (``ms_fp32_route``, with that route's bound); the
   hierarchical kernels at the huge-label shape; ``flash_decode`` at
   B = 8, S = 32,768 and ``ssd_chunk`` at B = 8, Q = 256), and
   ``launches_by_path`` on the rows whose kernels phases 13, 14, 16 and
   17 run (``binary_mvm``, ``am_search``: baselines; ``qail_update``,
   ``am_search_packed``, ``pack_bits``: online; the serving kernels:
   sharded; ``qail_update``: fit_sharded), and
   ``library_ms`` (cuBLAS SGEMM through ``torch.matmul`` for
   ``binary_mvm``, ``scaled_dot_product_attention`` for
   ``flash_decode``); the ``flash_decode`` row also carries the served
   shape's time and SDPA's there (B = 4, S = 320: ``ms_serve_shape``,
   ``library_ms_serve_shape``) and the float32 instance's time at the
   row's shape (``ms_f32``), each also with the decode softcap
   (``ms_softcap``, ``ms_serve_shape_softcap``, ``ms_f32_softcap``), and
   the ``lm_families`` launches in ``launches_by_path`` (the
   ``ssd_chunk`` row the ``lm_train`` path's); the ``am_search`` row (``ms`` on the ±1
   queries, the int8 route, bound by the bytes) the fp32 route on dyadic
   queries (``ms_fp32_route``, ``bound_ms_fp32_route``) and ``routes``;
   the ``am_search_packed`` (popcount) row the time at each ``block_b``
   (``ms_by_block_b``, ``grid_by_block_b``) and at a served request's
   B = 32 (``ms_b32``, ``bound_ms_b32``, ``plan_b32``); the
   ``am_search_imc`` row (``ms`` on the
   noisy instance, the fp32 route) the ideal instance's time and bound on
   the int8 route (``ms_int8_route``, ``bound_ms_int8_route``) and the
   route of each (``routes``); the ``am_search_multibit`` row the fp32
   route on dyadic queries (``ms_fp32_route``, ``bound_ms_fp32_route``)
   and ``routes``; the ``ssd_chunk`` row the forward's batch
   (B = 2: ``ms_serve_shape``, its bound) and the bound at the fp32 FMA rate
   (``bound_ms_fp32_fma``) beside the tensor-core one; the
   ``am_search_packed_unpack`` row the time at each ``block_b``
   (``ms_by_block_b``); the ``am_shortlist`` row (S = 8, on its tile route,
   bound at the 1-bit rate) its plan, S = 16 (``ms_s16``), its plan's G
   split timed against one split and against the narrowest at B = 256,
   512, 1024 and 2048 (``ms_by_batch``) and ``routes``; a row of its own,
   ``am_shortlist_served``, at the served hierarchical shape (B = 32, the
   main model's G = 45, S = G); ``pack_bits`` and ``unpack_bits`` their
   plans' grids; every row ``launch_floor_ms``, the empty kernel's time
   (``tools/launch_floor.cu``, timed as the kernels are); the
   ``am_search_sparse`` row the gathered entry on
   this run's gather (``ms_gathered``, checked equal to the fused one), k
   = 5 (``ms_k5``) and a block's SM cycles split between scoring and
   selection (``block_cycles_scoring``, ``block_cycles_selection``, from
   the kernel's clock64() stamps). Before it, on a
   line of its own, the tile
   sweep of the fp32 mainloop that ``binary_mvm`` and ``encode_pack``
   share (``sgemm_tile_sweep``: every tile bit-exact, then timed), and
   the ``rates`` line: the peaks the bounds use, the SM count and clock,
   and ``mma_rate``, the measured issue rates of the int8 and the 1-bit
   ``mma.sync`` (whose ratio sets the 1-bit peak that bounds popcount
   mode);
13. the Table I baselines (phase ``baselines``): BasicHDC, QuantHD,
   LeHDC and SearcHD (N = 64) fit at D = 10,240 on the full synthetic
   MNIST (fit seconds, accuracy, memory KB, the id_level encode's
   seconds); ``ops.predict_classes`` (``am_search``, every launch on its
   int8 route; C = 10 and 640) == ``BaselineModel.predict`` on every test
   row; BasicHDC's encode through ``binary_mvm`` (D = 10,240) == the
   plain product on dyadic features; ``fit(init_method="random")`` at
   the main point through ``qail_update``;
14. online serving (phase ``online``): the ``OnlineEngine`` in-process at
   the 1024 x 1024 point trained without its last class, a Poisson
   stream with a drifted same-C fold and a class-append fold (before
   it, a batch launched on the old generation and still queued when a
   class-append fold swaps equals the old artifact's predict; each
   fold minibatch a ``qail_update`` launch on its int8 route, counted);
   every response == the plain predict of the generation that served
   it, ``recompiles_steady_state`` 0, launch counts zeroed just before
   and read just after, the stream under ``torch.profiler``
   (``online_profile``: the engine's ``fold`` / ``rewarm`` / ``dispatch``
   / ``device_wait`` ranges); the ``serve_online --smoke --append-class``
   CLI and ``serve_memhd --metrics-out/--trace-out`` as subprocesses,
   both files parsed; beside them (``record_cli``) ``serve_memhd --smoke
   --fused``, ``serve_memhd --smoke`` and ``serve_online --smoke
   --append-class`` with ``--record-dir``: each ``BENCH_<name>.json``
   names this card and its ``nvidia-smi`` power limit, its metrics and
   meta equal the printed report's, and the dispatch tiers hold the
   path's kernels under ``cuda`` only. Phases 13 and 14 run after the
   hierarchical paths;
15. the autotuner (phase ``autotune``): ``repro_torch.kernels.autotune``
   over every spec at its ``DEFAULT_GEOMETRIES`` into a temporary cache,
   every candidate bit-exact against its plain version on the card (each
   winner printed with its times and the card's power limit); then, at
   the main path's geometries, which the committed cache
   (``kernels/autotune_cache.json``) holds for this card,
   ``ops.am_search_packed``, ``ops.qail_update`` and ``ops.encode_pack``
   with ``block_b=None`` launch the committed configuration (their
   launches by configuration, ``kernels.config_launches()``) and equal
   the default configuration bit for bit, while a batch below the tuned
   range and unpack mode (which the tuner does not time) launch the
   default (phase ``autotune_dispatch``). After phase 17 the
   ``dispatched_batches`` line gives the batches (B) the CUDA dispatches
   of the tuned kernels had over every phase so far, and the share inside
   the tuned range. Every phase before it already ran with the committed
   tiles, and the kernels line's rows of these three kernels add the
   tuned configuration and its time (``tuned``, ``ms_tuned``) beside the
   default's ``ms``;
16. sharded serving (phase ``sharded``): the main path's model deployed
   packed (staged and fused), unpacked, imc (ideal), multibit 4-bit and
   hierarchical (top-5), each wrapped in ``ShardedArtifact`` over two
   shards of the card and served with the ragged request stream (through
   ``serve_batches`` and, for the first requests, odd row counts
   included, directly): every response equals the unwrapped artifact's,
   launch counts zeroed just before and read just after, no ``torch-ref``
   tier; then ``serve_memhd --devices 1`` and ``serve_online --smoke
   --append-class --devices 1`` in-process (``recompiles_steady_state``
   0; phase ``sharded_cli``);
17. the data-parallel fit (phase ``fit_sharded``): ``fit_sharded`` over
   two shards of the card equals it over one in ``fp``, ``binary`` and
   every epoch's miss under phase 5's exact conditions with the ±1
   payload (``update_with="binary"``), at D = C = 128 and at full width,
   10 epochs, each shard delta one ``qail_update`` launch on its int8
   route (shards x batches x epochs); at the paper's lr, 20 epochs (cut
   from 100), its binary AM agrees with ``fit(use_kernel=True)``'s on >=
   95 % of cells and its accuracy within 0.05;
18. LM training (phase group ``lm_train``, after ``lm_families``):
   ``repro_torch.launch.train.run`` on mamba2-130m at full width and
   depth (bf16, chunk 256, remat) at the trainer's defaults (seq 256,
   batch 8) for 6 steps (``lm_train``: per-step loss, ms and tokens/s
   from the run's events, every loss finite, every SSD chunk on the
   ``ssd_chunk`` kernel, counts zeroed just before and read just after,
   the params of the last checkpoint moved from the seed's); at that
   width and batch the step-0 gradient norm (finite), the float32 kernel
   route's loss and gradient against the plain route's (``TRAIN_GRAD_TOL``
   x max|leaf| a leaf; the worst leaf logged) and one bf16 train step
   timed and under ``torch.profiler`` (``lm_train_grads``,
   ``lm_train_profile``); hymba-1.5b at full width and depth, 2 steps,
   attention and SSM both trained (``lm_train_hymba``); deepseek-v2-lite
   at full width cut to 1 dense MLA + 1 MoE layer, 2 steps, ``lb_loss``
   finite and > 0, the routed experts' gradients non-zero
   (``lm_train_deepseek``); deepseek-v3's smoke config, one step from a
   zero state: the router bias moved by exactly +-0.001 and the MTP loss
   in the metrics (``lm_train_v3``); the LM trainer CLI at the smoke
   config killed at step 12, resumed from step 10, within 1e-5 of a
   clean run's last loss (``lm_train_resume``);
19. the sharded LM paths (phase group ``lm_sharded``, after
   ``lm_train``) on meshes of the card twice: qwen1.5-32b at full width
   cut to 8 of 64 layers decoding sequence-parallel over (data 1, model
   2) through ``make_serve_step(cfg, rules)`` (``lm_seq_parallel``: each
   run from its own cache filled from a seed, no prefill, the
   sequence-parallel one built as per-member blocks under the rules; in
   float32 at B 4, S 8,192, len 8,000, 8 steps every step's logits == the
   unsharded decode within LM_TOL x max|logit|; in bfloat16 at S 32,768,
   len 32,000 both timed a step and their difference reported; 2
   ``flash_decode`` launches a layer a step, all cuda, counts zeroed just
   before and read just after; the recorded collectives, three
   all-reduces a layer); deepseek-v2-lite cut to 1 dense + 1 MoE layer in
   float32 with the expert-parallel MoE over (data 1, model 2)
   (``lm_expert_parallel``: the MoE layer at B 2 x S 256 == the local
   path within LM_TOL x max with equal counts at cf = E; at the published
   cf the dropped slots == the per-(source, expert) capacity rule's and
   every token with none dropped == local; ``T.forward`` under the rules;
   4 decode steps == the unsharded model's); mamba2-130m at full width,
   3 int8 error-feedback pod steps over pod 2 at the trainer's batch
   (``lm_pod_train``, steps 1 to 3, each checked from what the step itself
   reduced: losses finite; the ring-reduced gradient within 5 % of
   max|exact float32 mean| of every leaf and equal on both members; the
   members' residuals and the AdamW update exact; every ``ssd_chunk``
   launch cuda; each step's recorded wire bytes == the ring model's); the
   MEMHD dry runs at their defaults on the
   abstract (16, 16) mesh and ``repro_torch.launch.dryrun`` on
   mamba2-130m x train_4k, a CPU subprocess started with the group
   (``lm_dryrun``: their rooflines). The ``kernels`` line gives
   ``flash_decode`` and ``ssd_chunk`` their ``lm_sharded`` launches;
20. mixed precision (phase group ``lm_mixed``, after ``lm_sharded``):
   mamba2-130m at full width and depth with float32 params and bfloat16
   activations (the one mixed config the reference runs): at the
   trainer's batch (seq 256, batch 8) the bf16 forward logits and the
   float32 gradients on the kernel route against the plain route, each
   within MIXED_YARDSTICKS x the bf16 yardstick (the plain route's mixed
   run against its float32-activation run of the same params:
   max|logits| overall, a gradient leaf leaf by leaf); MIXED_STEPS train
   steps from step 1
   (the schedule's lr is 0 at step 0) at the trainer's lr and schedule:
   losses finite, the params float32 and moved at every step, the AdamW
   moments fp32, every SSD chunk on the ``ssd_chunk`` kernel (steps x
   layers x chunks x 2 under remat, counts zeroed just before and read
   just after), ms and tokens/s a step, one step under
   ``torch.profiler`` (``lm_mixed_profile``), the peak memory; decode at
   B 4 (prefill as decode, then greedy): the caches bfloat16 at init and
   after every step the conv window float32 and the state bfloat16, as
   the reference's; ms a step; ``launch.serve.generate`` == that loop
   token for token. The ``kernels`` line gives ``ssd_chunk`` its
   ``lm_mixed`` launches;
21. the reverse mix (phase group ``lm_reverse``, after ``lm_mixed``):
   bfloat16 params with float32 activations, which the reference runs on
   every architecture. hymba-1.5b at full width and depth
   (``lm_reverse_serve``): ``generate`` at B 4, 32 + 16 tokens, timed and
   counted (every ``flash_decode`` launch cuda), the teacher-forced
   decode of its tokens on the kernel route (reproducing them) and the
   plain route within LM_TOL x max|logit| a step, ``T.forward`` over them
   on both routes (every ``ssd_chunk`` launch cuda) within LM_TOL, the
   caches' dtypes; mamba2-130m at full width and depth
   (``lm_reverse_train``): the step-1 loss and bfloat16 gradients, kernel
   route against plain route (REVERSE_GRAD_TOL x max|leaf| plus
   REVERSE_GRAD_STEPS bfloat16 steps), 3 train steps from step 1 at the
   trainer's batch (finite losses, params bfloat16, moments fp32, the
   params moved, steps x layers x chunks x 2 ``ssd_chunk`` launches
   under remat, all cuda), ms and tokens/s a step, one step under
   ``torch.profiler``
   (``lm_reverse_profile``), the peak memory; deepseek-v2-lite cut to 1
   dense + 3 MoE layers (``lm_reverse_deepseek``: the forward at B 2 x S
   256 timed, 4 decode steps over the float32 latent cache == the
   forward's last position within SERVE_TOL, the peak memory);
   qwen1.5-32b cut to 8 layers with the int8 cache (``lm_reverse_quant``:
   64 teacher-forced steps within QUANT_TOL of the float32-cache decode
   and of the forward, the caches int8 with float16 scales). Every run
   checks float32 logits and residual stream on the card. The ``kernels``
   line gives ``flash_decode`` and ``ssd_chunk`` their ``lm_reverse``
   launches.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# the fp32 rate outside the tensor cores and the int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# The 1-bit tensor-core peak (mma.sync.m16n8k256 .b1 .and.popc), which
# the data sheet does not give: tools/mma_rate.cu measures one b1 mma
# issuing at the rate of one m16n8k32 .s8 mma while covering 8x its
# elements (the ratio this run measures is logged in "rates"), so the
# peak is 8x the int8 one.
B1_OPS_PER_S = 8 * INT8_OPS_PER_S
# Hopper issues __popc at 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute 9.0).
POPC_PER_CLK_PER_SM = 16
MMA_RATE_SRC = os.path.join(HERE, "tools", "mma_rate.cu")
LAUNCH_FLOOR_SRC = os.path.join(HERE, "tools", "launch_floor.cu")

# Differential grid (batch, features, dim, columns): the reference's
# tests/test_kernel_parity.py GEOMS, plus Dp = 13 (D = 100, not a
# multiple of 4 bytes) and the main path's full width.
GEOMS = [(1, 16, 128, 128), (8, 784, 128, 128), (3, 100, 130, 257),
         (5, 617, 512, 300), (2, 64, 120, 26), (1, 9, 9, 3),
         (4, 32, 100, 50)]
FULL = (1024, 784, 1024, 1024)
TRAIN_B = 256  # the QAIL minibatch: qail_update's full-width shape
EPOCHS = 100  # the paper's QAIL epochs: the main path runs them uncut
DYADIC_EPOCHS = 10
DYADIC_WIDTHS = (128, 1024)  # D = C: misses stay high at 128 (PERF.md)
MAIN_KERNELS = ("pack_bits", "am_search_packed", "encode_pack")
NEW_KERNELS = ("qail_update", "am_search", "am_search_packed_unpack")
TRAINER_DEVICES = ("cuda", "cpu")
# Device-fidelity kernels: arrays (rows, cols), ADC widths, cell widths.
IMC_ARRAYS = ((128, 128), (64, 128), (256, 128))
IMC_ADC_BITS = (16, 6, 3)
MULTIBIT_CELL_BITS_FULL = (2, 4, 8)
NOISY_SIM = dict(adc_bits=6, noise_sigma=0.5, fault_p0=0.01, fault_p1=0.01,
                 drift_sigma=1.0, seed=7)
MULTIBIT_EPOCHS = 3  # the fit(cell_bits=4) fine-tune of multibit_path
ROBUSTNESS_RUNS = ([], ["--dim", "1024", "--columns", "1024",
                        "--finetune-epochs", "2"])
# The hierarchical kernels' grid, and the reference's huge-label sweep
# point (benchmarks/hierarchical_search.py: planted prototypes with bit
# flips, noisy copies of centroids as queries).
HIER_D = (8, 100, 1000, 1024)
HIER_GC = ((1, 1), (2, 2), (45, 300), (448, 1000), (2, 257), (3, 9))
HUGE = dict(c=100_000, d=1024, g_plant=316, g=448, batch=256,
            proto_flip=0.08, query_flip=0.10, shortlists=(8, 16))
EXACT = dict(c=512, g_plant=23, g=23)  # S = G anchor of the sweep
# The batches at which am_shortlist's plan is timed against one G split
# and the narrowest (the huge-label shape's queries repeated), and the
# served hierarchical request: B = 32 against the main model's G = 45
# super-centroids at S = G.
SHORTLIST_BATCHES = (256, 512, 1024, 2048)
HIER_SERVE_B = 32
RECALL_FLOOR = 0.99
# The LM inference path: hymba-1.5b at full width (random weights from a
# seed), the one supported model whose path runs both LM kernels.
LM_ARCH = "hymba-1.5b"
LM_FORWARD = (2, 2048)      # B, S: local and global attention, 8 chunks
LM_SERVE = (4, 256, 64)     # B, prompt, gen
# f32 logits, kernel path against plain path: |d| <= LM_TOL * max|plain|.
# The paths differ only in summation order inside the two kernels
# (~1e-6 relative per layer); a wrong mask, decay or head is O(1).
LM_TOL = 1e-3
# flash_decode's grid: (H, KV, Dh) GQA 5x (hymba), MHA, MQA; cache lengths.
FD_HEADS = ((25, 5, 64), (4, 4, 128), (6, 1, 32))
FD_S = (1, 127, 320, 1024, 1600, 32768)
# ssd_chunk's grid: (H, N, P) at hymba's and mamba2's geometries; Q.
SSD_GEOMS = {"hymba": (50, 16, 64), "mamba2": (24, 128, 64)}
SSD_Q = (1, 20, 256)
# The kernels line's shapes: flash_decode at hymba's global layer with
# the decode_32k context, ssd_chunk at hymba's chunk.
FD_ROW = dict(b=8, s=32768, h=25, kv=5, dh=64)
# ... and at hymba's decode as lm_serve runs it (B 4, cache 320).
FD_SERVE = dict(b=4, s=320, h=25, kv=5, dh=64)
SSD_ROW = dict(b=8, q=256, h=50, n=16, p=64)
SSD_SERVE_B = 2  # ... and at the forward's batch (lm_forward: B 2)
# ... and the bound at the shape the LM train step launches (mamba2-130m,
# B 8 x S 256: one chunk of 256; phase group lm_train), on bf16 and on
# float32 operands (lm_mixed, lm_reverse).
SSD_TRAIN = dict(b=8, q=256, h=24, n=128, p=64)
# The decode softcap of flash_decode's softcap cases (Gemma 2's value).
FD_SOFTCAP = 30.0
# The remaining LM families (phase group ``lm_families``), random weights
# from seeds. deepseek-v2-lite-16b in float32 cut to the smoke depth (1
# dense + 2 MoE layers): decode == forward over S at B 2, one MoE layer
# against a plain per-expert loop at T tokens under the dropless limit
# (T * k <= 4096) and against the CPU above it.
DS_ARCH = "deepseek-v2-lite-16b"
DS_F32_DEPTH = (1, 2)
DS_F32_S = 128
DS_MOE_TOKENS = (512, 1024)       # T * 6 = 3072 (dropless), 6144 (cap 120)
# ... then at full depth: generate and T.forward timed in bfloat16, and in
# float32 T.forward held against the prefill's last decode step at the
# reference's own (float32) bound.
DS_SERVE = (4, 32, 32)            # B, prompt, gen
DS_FORWARD = (2, 256)             # B, S: 3072 routed slots, dropless
SERVE_TOL = 2e-2                  # tests/test_models.py:139
# deepseek-v3-671b at full width cut to 1 dense + 1 MoE layer (+ the MTP
# block's params): decode steps == forward at B 2.
V3_ARCH = "deepseek-v3-671b"
V3_DEPTH = (1, 1)
V3_STEPS = 8
V3_FORWARD = (2, 64)
# musicgen-medium and internvl2-2b at full width and depth: decode steps
# (float32 kernel path == plain path; bfloat16 timed) at B 2; musicgen's
# 64 conditioning tokens, internvl2's 256 patches ahead of 32 text tokens.
MODALITY_B = 2
MODALITY_STEPS = 16
VLM_TEXT = 32
# qwen1.5-32b at full width, 8 of 64 layers, with the int8 KV cache:
# teacher-forced decode against the bf16-cache decode of the same params
# (tests/test_kv_quant.py:48's bound).
QUANT_ARCH = "qwen1.5-32b"
QUANT_LAYERS = 8
QUANT_DECODE = (2, 256)           # B, S
QUANT_TOL = 5e-2
# The Table I baselines at the paper's width (SearcHD's N as published),
# and the random-init fit's epochs at the main point (cut from 100).
BASELINE_KINDS = ("basic", "quanthd", "lehdc", "searchd")
BASELINE_DIM = 10_240
BASELINE_N = 64
RANDOM_EPOCHS = 20
# The online stream at the main point without its last class: fit epochs
# (cut from 100), QAIL epochs per fold, the engine's batch budget,
# requests a phase and their Poisson rate.
ONLINE = dict(epochs=20, fold_epochs=2, max_batch=256, requests=120,
              rate=2000.0)
ENGINE_RANGES = ("fold", "rewarm", "dispatch", "device_wait")
# Multi-device MEMHD on the one card: two shards of one device; the
# requests served directly through the wrapper (odd row counts pad); the
# paper-lr fit_sharded's epochs (cut from 100), its binary agreement with
# fit(use_kernel=True) and its accuracy gap (the reference's contract,
# tests/test_qail_engine.py::TestFitSharded).
SHARDS = 2
SHARDED_DIRECT_REQUESTS = 32
SHARDED_EPOCHS = 20
SHARDED_AGREE, SHARDED_ACC_GAP = 0.95, 0.05
# LM training (phase ``lm_train``): mamba2-130m at full width and depth
# (bf16, chunk 256, remat on) through the trainer at its defaults (seq
# 256, batch 8) for TRAIN_STEPS steps; its float32 gradient on the kernel
# route against the plain route at the same width and batch, each leaf
# within TRAIN_GRAD_TOL x max|leaf|: ssd_chunk's stated float32 error is
# 1e-4 + 1e-4|y| a chunk, and LM_TOL gives the 24 layers that carry it
# the margin the float32 forward's logits are held to. hymba-1.5b at
# full width and depth and deepseek-v2-lite cut to one dense MLA layer
# and one MoE layer (16B params with AdamW state exceed 80 GB) take
# TRAIN_FAMILY_STEPS steps; deepseek-v3's smoke config one (one
# full-width v3 MoE layer is 11B params); the crash / resume at the
# smoke config as tests/test_train_loop.py runs it.
TRAIN_ARCH = "mamba2-130m"
TRAIN_STEPS = 6
TRAIN_GRAD_TOL = 1e-3
TRAIN_FAMILY_STEPS = 2
TRAIN_DS_DEPTH = (1, 1)
TRAIN_RESUME = ["--smoke", "--steps", "20", "--seq-len", "64",
                "--global-batch", "2", "--ckpt-every", "5",
                "--log-every", "100"]
RESUME_TOL = 1e-5                 # tests/test_train_loop.py:63
# The sharded LM paths (phase group ``lm_sharded``) on a mesh of the one
# card twice, (data 1, model 2) or pod 2. The sequence-parallel decode:
# qwen1.5-32b at full width cut to SP_LAYERS layers (lm_quant's cut), the
# bf16 KV cache filled from a seed to ``len`` (no prefill); float32
# against the unsharded decode_step (LM_TOL x max|logit|), then bfloat16
# at the decode_32k context timed (its difference reported, not gated).
SP_ARCH = "qwen1.5-32b"
SP_LAYERS = 8
SP_CHECK = (4, 8192, 8000, 8)      # B, S, len, steps (float32)
SP_TIMED = (4, 32768, 32000, 8)    # ... bfloat16
# The expert-parallel MoE: deepseek-v2-lite at full width cut to 1 dense +
# 1 MoE layer (lm_train's cut), float32: the MoE layer at B x S tokens
# against the local path at cf = E (nothing drops) and at the published
# cf (the capacity rule's drops), T.forward and EP_DECODE decode steps
# under the rules against the unsharded model.
EP_ARCH = "deepseek-v2-lite-16b"
EP_DEPTH = (1, 1)
EP_FORWARD = (2, 256)              # B, S
EP_DECODE = 4
# The int8 error-feedback pod step: mamba2-130m at full width and depth,
# bf16, the trainer's batch (seq 256, batch 8), pod 2, POD_STEPS steps
# from step 1; each step's reduced gradient within POD_GRAD_TOL x max|exact
# float32 mean| of every leaf (tests/test_distributed.py's ring bound).
POD_STEPS = 3
POD_GRAD_TOL = 0.05
# Mixed precision (phase group ``lm_mixed``): mamba2-130m at full width and
# depth, float32 params with bfloat16 activations; MIXED_STEPS train steps
# from step 1 at the trainer's batch; decode at (B, prompt, new tokens).
MIXED = dict(param_dtype="float32", activation_dtype="bfloat16")
MIXED_STEPS = 3
MIXED_DECODE = (4, 32, 16)
# The kernel route and the plain route round their activations to bf16
# apart (the kernel's float32 SSD output differs in its last bits, which
# flips bf16 roundings that the residual stream carries on), so each lies
# about a yardstick from the float32-activation run and the two within
# twice that: MIXED_YARDSTICKS. Measured at most 0.94 (a gradient leaf;
# the forward 0.69).
MIXED_YARDSTICKS = 2.0
# bfloat16 params with float32 activations (phase group ``lm_reverse``):
# hymba-1.5b serving at (B, prompt, new tokens), mamba2-130m training
# (REVERSE_STEPS steps), deepseek-v2-lite cut to 1 dense + 3 MoE layers
# (forward at DS_FORWARD, REVERSE_DS_DECODE decode steps) and qwen1.5-32b's
# int8-cache cut at REVERSE_QUANT_DECODE (B, S).
REVERSE_DECODE = (4, 32, 16)
REVERSE_STEPS = 3
REVERSE_DS_DEPTH = (1, 3)
REVERSE_DS_DECODE = 4
REVERSE_QUANT_DECODE = (2, 64)
# A reverse-mix gradient is bfloat16: the kernel route's and the plain
# route's float32 gradients part by at most the float32 tolerance
# (TRAIN_GRAD_TOL x max|leaf|, as lm_train_grads), and rounding to
# bfloat16 adds a step at max|leaf| (``bf16_step``) where it flips; a
# leaf whose gradient is a bfloat16 sum of bfloat16-rounded terms (the
# tied embedding: the scatter-add of 2,048 token rows and the head's
# cotangent) adds one where each flips. The check allows
# REVERSE_GRAD_STEPS; measured 2 (the embedding) on an H100.
REVERSE_GRAD_TOL = TRAIN_GRAD_TOL
REVERSE_GRAD_STEPS = 4
# The example drivers (phase ``examples``): train_lm_torch runs past its
# 20-step warm-up; quickstart_torch launches every MEMHD kernel.
EXAMPLE_TRAIN_STEPS = 40
QUICKSTART_KERNELS = ("pack_bits", "am_search_packed",
                      "am_search_packed_unpack", "encode_pack",
                      "qail_update", "am_search", "binary_mvm",
                      "unpack_bits", "am_search_imc", "am_search_multibit",
                      "am_shortlist")


def check(cond, what) -> None:
    """Fail the run (assert statements vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# The record_cli phase: the --record-dir runs, each into its own directory
# (a record is named by its CLI), and the kernels each must dispatch, all
# on cuda: the fused chain (``predict_from_features``: encode_pack into
# the popcount search), the staged one (pack_rows into the popcount
# search) and the online stream (staged serving, folds through
# qail_update).
RECORD_RUNS = {
    "serve_memhd --fused": ["repro_torch.launch.serve_memhd", "--smoke",
                            "--fused"],
    "serve_memhd": ["repro_torch.launch.serve_memhd", "--smoke"],
    "serve_online --append-class": ["repro_torch.launch.serve_online",
                                    "--smoke", "--append-class"],
}
RECORD_KERNELS = {
    "serve_memhd --fused": {"predict_from_features"},
    "serve_memhd": {"am_search_packed", "pack_rows"},
    "serve_online --append-class": {"am_search_packed", "pack_rows",
                                    "qail_update"},
}
RECORD_KEYS = {"schema_version", "bench", "created_unix", "git_sha",
               "torch_version", "device", "meta", "metrics"}


def start_record_runs(env, root):
    """Start the RECORD_RUNS as subprocesses, each writing its record,
    stdout and stderr (and the online run its metrics snapshot) into a
    directory of its own under ``root``: [(label, process, directory)]."""
    runs = []
    for i, (label, cmd) in enumerate(RECORD_RUNS.items()):
        out = os.path.join(root, str(i))
        os.makedirs(out)
        extra = (["--metrics-out", os.path.join(out, "metrics.json")]
                 if "serve_online" in cmd[0] else [])
        with open(os.path.join(out, "stdout.txt"), "w") as so, \
                open(os.path.join(out, "stderr.txt"), "w") as se:
            runs.append((label, subprocess.Popen(
                [sys.executable, "-m", *cmd, "--record-dir", out, *extra],
                env=env, stdout=so, stderr=se), out))
    return runs


def record_metrics(report) -> dict:
    """What ``from_report`` makes of a report's numeric fields."""
    return {k: {"us_per_call": float(v) * 1e3 if k.startswith("lat_ms")
                else 0.0, "derived": str(v), "value": float(v)}
            for k, v in report.items()
            if not isinstance(v, bool) and isinstance(v, (int, float))}


def snapshot_tiers(snap) -> dict:
    """{kernel: {tier: count}} from a metrics snapshot's dispatches."""
    out = {}
    for key, n in snap["kernel_dispatch_total"]["values"].items():
        kernel = re.search(r'kernel="([^"]+)"', key).group(1)
        tier = re.search(r'tier="([^"]+)"', key).group(1)
        out.setdefault(kernel, {}).setdefault(tier, 0)
        out[kernel][tier] += int(n)
    return out


def bf16_ulp(x):
    """One bfloat16 unit in the last place at |x| (2^-8 at 0)."""
    import torch
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def bf16_step(x: float) -> float:
    """One bfloat16 step (unit in the last place) at |x|."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def map_tree(fn, tree):
    """``fn`` on every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def bound(nbytes, ops, rate):
    """(ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over ``rate``."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def check_int8_routes(launches, what) -> dict:
    """qail_update's route counts since the last reset: every launch of
    the path on the int8 route (integer operands: ±1 queries against a ±1
    AM or multi-bit codes)."""
    from repro_torch.kernels import qail_update
    routes = qail_update.route_counts()
    check(routes == {"int8": launches, "fp32": 0},
          ("qail_update routes", what, routes, launches))
    return routes


def check_routes(mod, want, what) -> dict:
    """The route counts of ``mod`` (am_search, am_search_imc or
    am_search_multibit) since its last reset are ``want``."""
    routes = mod.route_counts()
    check(routes == want, (mod.__name__, "routes", what, routes, want))
    return routes


def one_route(mod, route) -> dict:
    """One call's route counts: 1 on ``route``."""
    return {**dict.fromkeys(mod.ROUTES, 0), route: 1}


def ptxas_entries(build_log, names) -> list:
    """Registers, stack and spills of every kernel instance whose mangled
    name contains one of ``names``, from ptxas' -v report."""
    out, cur = [], None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            cur = {"entry": fn} if any(n in fn for n in names) else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and ("spill" in ln or "Used" in ln):
            cur.setdefault("report", []).append(ln.strip())
    return out


def ssd_bound(b, q, h, n, p, nbytes):
    """ssd_chunk's bound at float32 accuracy with bf16 x, B and C, each
    product counted at the type and number of terms it needs: the causal
    triangle of C B^T, one exact bf16 product; the triangle of G x (G
    float32 in three bf16 terms, x exact), three bf16 products; C S and
    the state update (a float32 operand in TF32 hi and lo against an exact
    one), two TF32 products each; against the bytes. (ms, what bounds
    it)."""
    tri = b * h * q * (q + 1)  # 2 flops per entry of the Q(Q+1)/2 triangle
    t_ops = (tri * (n + 3 * p) / BF16_FLOP_PER_S
             + 2 * 4 * b * h * q * n * p / TF32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_bound_f32(b, q, h, n, p, nbytes):
    """ssd_chunk's bound on float32 x, B and C: every product has two
    float32 operands, so each runs as three TF32 products (hi and lo
    terms: lo*hi' + hi*lo' + hi*hi'); against the bytes."""
    ops = 3 * b * h * (q * (q + 1) * (n + p) + 4 * q * n * p)
    return bound(nbytes, ops, TF32_FLOP_PER_S)


def ssd_nbytes(b, q, h, n, p, es):
    """ssd_chunk's bytes: x, B, C (``es`` bytes each) and dt, da, the
    state (float32) read once; y (``es``) and the new state written."""
    return (es * 2 * b * q * h * p + es * 2 * b * q * h * n
            + 4 * 2 * b * q * h + 4 * 2 * b * h * n * p)


def time_device_ms(fn, samples: int = 21, calls: int = 10) -> float:
    """Median device time of one call, in ms.

    Each sample parks the stream behind ``torch.cuda._sleep`` while the
    host enqueues ``calls`` calls, so the events bracket back-to-back
    device work and not the host's launch overhead. The sleep lasts four
    times the host's enqueue of ``calls`` calls after the warm-up (at
    least ~1 ms, at most ~0.2 s): a fast kernel behind a heavy wrapper
    would otherwise be timed at the host's rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # _sleep counts SM clock cycles: 2e9 a second is above the H100's
    # top clock, so the sleep lasts at least as long as asked.
    cycles = min(max(2_000_000, int(4 * enqueue_s * 2e9)), 400_000_000)
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        self.np, self.torch = np, torch
        self.dev = torch.device("cuda")
        self.max_err = {"pack_bits": 0.0, "am_search_packed": 0.0,
                        "encode_pack": 0.0, "qail_update": 0.0,
                        "am_search": 0.0, "am_search_packed_unpack": 0.0,
                        "binary_mvm": 0.0, "unpack_bits": 0.0,
                        "am_search_imc": 0.0, "am_search_multibit": 0.0,
                        "am_shortlist": 0.0, "am_search_sparse": 0.0,
                        "am_shortlist_served": 0.0,
                        "flash_decode": 0.0, "ssd_chunk": 0.0}
        self.path_launches = {}  # kernel -> launches on its own path
        self.families_launches = {}  # flash_decode's lm_families launches
        self.sp_launches = 0     # flash_decode's lm_sharded launches
        self.pod_launches = 0    # ssd_chunk's lm_sharded launches
        self.mixed_launches = 0  # ssd_chunk's lm_mixed launches
        # flash_decode's and ssd_chunk's lm_reverse launches
        self.reverse_launches = {"flash_decode": 0, "ssd_chunk": 0}
        self.batches_seen = {}   # kernel -> {B: CUDA dispatches}

    # -- helpers ---------------------------------------------------------------
    def note_batches(self):
        """Add the batches of the CUDA dispatches since the dispatch
        counter's last reset to ``batches_seen`` (called before each
        reset)."""
        from repro_torch.kernels import ops
        for kernel, per in ops.dispatch_batches().items():
            seen = self.batches_seen.setdefault(kernel, {})
            for b, n in per.items():
                seen[b] = seen.get(b, 0) + n

    def t(self, a):
        return self.torch.as_tensor(a, device=self.dev)

    def bipolar(self, rng, shape):
        return self.t(rng.choice([-1.0, 1.0], size=shape).astype("float32"))

    def feats(self, rng, b, f, dyadic):
        x = rng.random((b, f), dtype=self.np.float32)
        if dyadic:
            x = self.np.round(x * 256) / 256
        return self.t(x.astype("float32"))

    # -- phase 1 ---------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        # tools/mma_rate.cu, compiled beside the kernels and run in the
        # kernels line's "rates" phase.
        out_dir = os.path.join(HERE, "build", "mma_rate")
        os.makedirs(out_dir, exist_ok=True)
        self.mma_rate_bin = os.path.join(out_dir, "mma_rate")
        self.floor_so = os.path.join(out_dir, "liblaunch_floor.so")
        tools = [(src, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", *extra, "-o", dst,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for src, dst, extra in (
                (MMA_RATE_SRC, self.mma_rate_bin, ()),
                (LAUNCH_FLOOR_SRC, self.floor_so,
                 ("-shared", "-Xcompiler", "-fPIC")))]
        try:
            path = _build.build()
            _build.lib()
        finally:
            outs = [(src, p.communicate(timeout=600)[0], p.returncode)
                    for src, p in tools]
        for src, out, rc in outs:
            check(rc == 0, ("nvcc", os.path.relpath(src, HERE), out))
        regs = [ln.strip() for ln in _build.build_log.splitlines()
                if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
        log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
             "library": os.path.relpath(str(path), HERE), "ptxas": regs})
        log({"phase": "ptxas_adc", "instances": ptxas_entries(
            _build.build_log, ("search_pass", "multibit_search",
                               "convert_pass"))})

    # -- phase 2 ---------------------------------------------------------------
    def check_kernels(self):
        np, torch = self.np, self.torch
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import encode_fused, pack_bits, ref
        rows = []
        for geom in GEOMS + [FULL]:
            b, f, d, c = geom
            full = geom == FULL
            rng = np.random.default_rng([1234, b, f, d, c])
            # pack_bits on byte-aligned rows, pack_rows on any D.
            x = self.bipolar(rng, (b, -(-d // 8) * 8))
            got, want = pack_bits.pack_bits(x), ref.pack_bits(x)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            xr = self.bipolar(rng, (b, d))
            check(torch.equal(asp.pack_rows(xr), ref.pack_rows(xr)), geom)
            check(err == 0, ("pack_bits", geom, err))
            if full:
                self.max_err["pack_bits"] = float(err)
            # am_search_packed: random AM, then an AM of duplicated
            # columns so every query's maximum is tied.
            q = ref.pack_rows(self.bipolar(rng, (b, d)))
            am = self.bipolar(rng, (c, d))
            dup = am[torch.arange(c, device=self.dev) % max(1, c // 3)]
            for a in (am, dup):
                am_t = ref.pack_rows(a).T.contiguous()
                w_idx, w_sim = ref.am_search_packed(q, am_t, d)
                for bb in asp.BLOCK_B_CHOICES:
                    idx, sim = asp.am_search_packed(q, am_t, n_dims=d,
                                                    block_b=bb)
                    torch.cuda.synchronize()
                    check(torch.equal(idx, w_idx), ("am_search", geom, bb))
                    err = (sim - w_sim).abs().max().item()
                    check(err == 0, ("am_search sim", geom, bb, err))
                    if full:
                        self.max_err["am_search_packed"] = max(
                            self.max_err["am_search_packed"], err)
            # encode_pack: bit-exact on dyadic features...
            proj = self.bipolar(rng, (f, d))
            xd = self.feats(rng, b, f, dyadic=True)
            got = encode_fused.encode_pack(xd, proj)
            want = ref.encode_pack(xd, proj)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            check(err == 0, ("encode_pack dyadic", geom, err))
            if full:
                self.max_err["encode_pack"] = float(err)
            # ... and on float features a sign bit may differ only where
            # |H| <= 1e-5 * sum|x| (fp32 summation-order rounding).
            xf = self.feats(rng, b, f, dyadic=False)
            h = xf @ proj
            gb = ref.unpack_bits(encode_fused.encode_pack(xf, proj))[:, :d]
            wb = ref.unpack_bits(ref.encode_pack(xf, proj))[:, :d]
            diff = gb != wb
            tol = 1e-5 * xf.abs().sum(dim=1, keepdim=True)
            outside = (diff & (h.abs() > tol)).sum().item()
            check(outside == 0, ("encode_pack float", geom, outside))
            rows.append({"geom": geom, "encode_pack_float_flips":
                         int(diff.sum().item()),
                         **self.check_new_kernels(rng, geom),
                         **self.check_fidelity_kernels(rng, geom)})
        log({"phase": "kernels_vs_plain", "ok": True, "grid": rows,
             "max_abs_err_full_width": self.max_err,
             "popcount_split_ties": self.check_split_ties()})
        self.check_hier_kernels()

    def check_split_ties(self) -> dict:
        """Both packed modes, every block_b, at B = 300 and 32 (popcount
        mode's 128- or 64-column splits and its 8-column ones): exact
        copies of a query planted in several column splits, the lowest
        index wins wherever it lies."""
        np, torch = self.np, self.torch
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import ref
        rng = np.random.default_rng([18, 300])
        d = c = 1024
        am = self.bipolar(rng, (c, d))
        q = self.bipolar(rng, (300, d))
        i = torch.arange(40, device=self.dev)
        win = 130 + 3 * i
        for cols in (win, win + 470, win + 640):
            am[cols] = q[:40]
        am[1 + 3 * i[:20]] = q[:20]
        want_idx = torch.where(i < 20, 1 + 3 * i, win).to(torch.int32)
        am_t = ref.pack_rows(am).T.contiguous()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = {}
        for b in (300, 32):
            qp = ref.pack_rows(q[:b]).contiguous()
            w_idx, w_sim = ref.am_search_packed(qp, am_t, d)
            check(torch.equal(w_idx[:min(b, 40)], want_idx[:b]),
                  "planted ties: plain")
            for mode in asp.MODES:
                for bb in asp.BLOCK_B_CHOICES:
                    idx, sim = asp.am_search_packed(qp, am_t, n_dims=d,
                                                    block_b=bb, mode=mode)
                    torch.cuda.synchronize()
                    check(torch.equal(idx, w_idx) and torch.equal(sim, w_sim),
                          ("split ties", mode, b, bb))
                    if mode == "popcount":
                        splits[f"B{b}_block_b{bb}"] = asp.launch_plan(
                            b, d // 8, c, bb, mode, sms)["cols"]
        return {"columns_per_split": splits}

    def check_hier_kernels(self):
        """am_shortlist and am_search_sparse (fused and gathered) against
        their plain versions, bit-exact, with forced ties (duplicated
        rows), exhausted slots and the global-scratch path."""
        np, torch = self.np, self.torch
        from repro_torch.deploy import hierarchical as hier
        from repro_torch.kernels import am_search_sparse as ass
        from repro_torch.kernels import am_shortlist as asl
        from repro_torch.kernels import ref

        def packed(rng, rows, d, dup):
            x = self.bipolar(rng, (rows, d))
            if dup:
                x = x[torch.arange(rows, device=self.dev) % max(1, rows // 2)]
            return ref.pack_rows(x)

        def equal(got, want, what):
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]), what)

        cases = 0
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        asl.reset_routes()
        for d in HIER_D:
            for g, c in HIER_GC:
                rng = np.random.default_rng([77, d, g, c])
                q = packed(rng, 9, d, False)
                for dup in (False, True):
                    spt = packed(rng, g, d, dup).T.contiguous()
                    for s_ in sorted({1, min(3, g), g}):
                        want = ref.am_shortlist(q, spt, d, s_)
                        equal(asl.am_shortlist(q, spt, n_dims=d, s=s_), want,
                              ("am_shortlist", d, g, s_, dup))
                        cases += 1
                    am_t = packed(rng, c, d, dup).T.contiguous()
                    lay = hier.build_layout(am_t.cpu().numpy(),
                                            rng.integers(0, g, size=c), g)
                    slab, ids, ts, tc = (self.t(a) for a in (
                        lay.slab, lay.col_ids, lay.tile_start,
                        lay.tile_count))
                    for s_ in sorted({1, min(3, g), g}):
                        short = self.t(np.stack([
                            rng.permutation(g)[:s_] for _ in range(9)])
                            .astype(np.int32))
                        tiles = ass.expand_shortlist_tiles(
                            short, ts, tc, max_tiles=lay.max_tiles,
                            null_tile=lay.null_tile)
                        gat, gid = ass.gather_shortlist(slab, ids, tiles)
                        for k in (1, 5, c + 2):
                            want = ass.am_search_sparse_plain(
                                q, slab, ids, short, ts, tc, n_dims=d, k=k,
                                max_tiles=lay.max_tiles)
                            what = ("am_search_sparse", d, g, c, s_, k, dup)
                            equal(ass.am_search_sparse(
                                q, slab, ids, short, ts, tc, n_dims=d, k=k,
                                max_tiles=lay.max_tiles), want, what)
                            equal(ass.am_search_sparse_gathered(
                                q, gat, gid, n_dims=d, k=k), want,
                                ("gathered",) + what)
                            cases += 2
                    if dup and d == 1024 and c == 1000:
                        # S = G, shortlist repeated past the shared-memory
                        # budget: the keys go through global scratch.
                        reps = -(-asl.SMEM_SLOTS // (g * lay.max_tiles
                                                    * 128)) + 1
                        wide = self.t(np.tile(np.arange(g, dtype=np.int32),
                                              (9, reps)))
                        equal(ass.am_search_sparse(
                            q, slab, ids, wide, ts, tc, n_dims=d, k=5,
                            max_tiles=lay.max_tiles),
                            ass.am_search_sparse_plain(
                                q, slab, ids, wide, ts, tc, n_dims=d, k=5,
                                max_tiles=lay.max_tiles), "sparse scratch")
                        # Past SMEM_SLOTS: S = 600 on the stream route
                        # (keys in global scratch), S = 5 split over the
                        # tile route.
                        big = packed(rng, asl.SMEM_SLOTS + 77, d, True)
                        bt = big.T.contiguous()
                        for s_, route in ((600, "stream"), (5, "tile")):
                            before = asl.route_counts()[route]
                            equal(asl.am_shortlist(q, bt, n_dims=d, s=s_),
                                  ref.am_shortlist(q, bt, d, s_),
                                  ("shortlist past SMEM_SLOTS", s_))
                            check(asl.route_counts()[route] == before + 1,
                                  ("shortlist route", s_, route))
                        cases += 3
        routes = asl.route_counts()
        check(routes["stream"] == 1 and routes["tile"] > 0, routes)
        log({"phase": "hier_kernels_vs_plain", "ok": True,
             "cases_bit_exact": cases, "dims": HIER_D,
             "groups_columns": HIER_GC, "shortlist_routes": routes})

    def check_new_kernels(self, rng, geom):
        """am_search, the unpack mode and qail_update at one geometry
        (qail_update at (TRAIN_B, D, C) for the full width)."""
        torch = self.torch
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import ref
        b, f, d, c = geom
        full = geom == FULL
        am = self.bipolar(rng, (c, d))
        dup = am[torch.arange(c, device=self.dev) % max(1, c // 3)]
        for a in (am, dup):
            # am_search: ±1 queries (its int8 route) and dyadic float ones
            # (its fp32 route), through the (D, C) transposed view of the
            # resident (C, D) AM and a copy.
            for q, route in ((self.bipolar(rng, (b, d)), "int8"),
                             (self.feats(rng, b, d, dyadic=True) - 0.5,
                              "fp32")):
                w_idx, w_sim = ref.am_search(q, a.T)
                for am_t in (a.T, a.T.contiguous()):
                    ams.reset_routes()
                    idx, sim = ams.am_search(q, am_t)
                    torch.cuda.synchronize()
                    err = (sim - w_sim).abs().max().item()
                    check(torch.equal(idx, w_idx) and err == 0,
                          ("am_search", geom, route, err))
                    check_routes(ams, one_route(ams, route),
                                 ("am_search", geom))
                    if full:
                        self.max_err["am_search"] = max(
                            self.max_err["am_search"], err)
            # the unpack mode of the packed search, every block size.
            qp = ref.pack_rows(self.bipolar(rng, (b, d)))
            am_t = ref.pack_rows(a).T.contiguous()
            w_idx, w_sim = ref.am_search_packed_unpack(qp, am_t, d)
            p_idx, p_sim = ref.am_search_packed(qp, am_t, d)
            check(torch.equal(w_idx, p_idx) and torch.equal(w_sim, p_sim),
                  ("unpack plain == popcount plain", geom))
            for bb in asp.BLOCK_B_CHOICES:
                idx, sim = asp.am_search_packed(qp, am_t, n_dims=d,
                                                block_b=bb, mode="unpack")
                torch.cuda.synchronize()
                err = (sim - w_sim).abs().max().item()
                check(torch.equal(idx, w_idx) and err == 0,
                      ("unpack", geom, bb, err))
                if full:
                    self.max_err["am_search_packed_unpack"] = max(
                        self.max_err["am_search_packed_unpack"], err)
        # qail_update: padded last row, a class that owns no centroid,
        # ties (duplicated AM columns), a dyadic and a float payload.
        qb = TRAIN_B if full else b
        out = {}
        for tie in (False, True):
            for dyadic in (True, False):
                err, rel = self.check_qail(rng, qb, d, c, tie, dyadic)
                out[f"qail_{'tie' if tie else 'rand'}_"
                    f"{'dyadic' if dyadic else 'lr0.02'}_max_err"] = err
                out.setdefault("qail_max_err_over_tol", 0.0)
                out["qail_max_err_over_tol"] = max(
                    out["qail_max_err_over_tol"], rel)
                if full and not dyadic:
                    self.max_err["qail_update"] = max(
                        self.max_err["qail_update"], err)
        return out

    def check_fidelity_kernels(self, rng, geom):
        """binary_mvm, unpack_bits, am_search_imc and am_search_multibit
        at one geometry against their plain versions."""
        np, torch = self.np, self.torch
        from repro_torch.kernels import am_search_imc as asi
        from repro_torch.kernels import am_search_multibit as asm
        from repro_torch.kernels import binary_mvm as bm
        from repro_torch.kernels import pack_bits, ref
        b, f, d, c = geom
        full = geom == FULL
        out = {}
        # binary_mvm: dyadic features bit-exact; float features within
        # 2^-20 * sum|x*w| (fp32 summation order: fmaf in k order against
        # cuBLAS).
        w = self.bipolar(rng, (f, d))
        xd = self.feats(rng, b, f, dyadic=True)
        got = bm.binary_mvm(xd, w)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.binary_mvm(xd, w)),
              ("binary_mvm dyadic", geom))
        xf = self.feats(rng, b, f, dyadic=False)
        err = (bm.binary_mvm(xf, w) - ref.binary_mvm(xf, w)).abs()
        tol = 2.0 ** -20 * (xf.abs() @ w.abs())
        check((err <= tol).all().item(), ("binary_mvm float", geom))
        out["binary_mvm_float_max_err"] = err.max().item()
        # unpack_bits over every byte value.
        p = self.t(rng.integers(0, 256, (b, -(-d // 8)), dtype=np.uint8))
        got = pack_bits.unpack_bits(p)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.unpack_bits(p)), ("unpack_bits", geom))
        if full:
            self.max_err["binary_mvm"] = out["binary_mvm_float_max_err"]
            self.max_err["unpack_bits"] = 0.0
        # am_search_imc: ±1, dyadic-noise and sigma 0.5 AMs (random and
        # duplicated columns), ±1 queries, with and without offsets.
        am = self.bipolar(rng, (c, d))
        dup = am[torch.arange(c, device=self.dev) % max(1, c // 3)]
        q = self.bipolar(rng, (b, d))
        mismatched = imc_max = 0
        for rows, cols in IMC_ARRAYS:
            gd, gc = -(-d // rows), -(-c // cols)
            off = self.t((np.round(rng.normal(0, 1, (gd, gc)) * 16) / 16)
                         .astype(np.float32))
            for a in (am, dup):
                z = self.t(rng.normal(0, 1, (c, d)).astype(np.float32))
                for noise, at in (
                        ("pm1", a), ("dyadic", a + 0.5 * (torch.round(
                            z * 64) / 64)), ("float", a + 0.5 * z)):
                    route = "int8" if noise == "pm1" else "fp32"
                    for bits in IMC_ADC_BITS:
                        for o in (None, off):
                            kw = dict(tile_rows=rows, tile_cols=cols,
                                      adc_bits=bits, adc_clip=float(rows))
                            asi.reset_routes()
                            idx, sim = asi.am_search_imc(q, at.T, o, **kw)
                            check_routes(asi, one_route(asi, route),
                                         ("am_search_imc", geom, noise))
                            w_idx, w_sim = ref.am_search_imc(
                                q, at.T, offsets=o, **kw)
                            torch.cuda.synchronize()
                            what = ("am_search_imc", geom, rows, cols,
                                    noise, bits, o is None)
                            e = (sim - w_sim).abs().max().item()
                            exact = torch.equal(idx, w_idx) and e == 0
                            if noise == "float" and not exact:
                                mismatched += self.imc_within_tolerance(
                                    q, at, o, kw, idx, sim, w_idx, w_sim,
                                    what)
                            else:
                                check(exact, what)
                            imc_max = max(imc_max, e)
        out["imc_max_err"] = imc_max
        out["imc_float_noise_queries_differing"] = mismatched
        # am_search_multibit: random codes at every cell width, a 16-bit
        # ADC without offsets and a 4-bit ADC with them, on the ±1 queries
        # (int8 route) and on dyadic non-integer ones (fp32 route).
        qd = self.t(np.round(rng.normal(0, 2, (b, d)) * 4).astype(np.float32)
                    / 4)
        mb_max = 0.0
        for cb in (MULTIBIT_CELL_BITS_FULL if full else range(2, 9)):
            qmax = 2 ** (cb - 1) - 1
            codes = self.t(rng.integers(-qmax, qmax + 1, (c, d))
                           .astype(np.int32))
            planes = ref.pack_planes(codes + qmax, cb)
            for rows, cols in IMC_ARRAYS:
                gd, gc = -(-d // rows), -(-c // cols)
                off = self.t((np.round(rng.normal(0, 4, (gd, gc)) * 16)
                              / 16).astype(np.float32))
                for (adc, o), (qq, route) in itertools.product(
                        ((16, None), (4, off)), ((q, "int8"), (qd, "fp32"))):
                    kw = dict(cell_bits=cb, tile_rows=rows, tile_cols=cols,
                              adc_bits=adc)
                    asm.reset_routes()
                    idx, sim = asm.am_search_multibit(qq, planes, o, **kw)
                    w_idx, w_sim = ref.am_search_multibit(qq, planes,
                                                          offsets=o, **kw)
                    torch.cuda.synchronize()
                    e = (sim - w_sim).abs().max().item()
                    check(torch.equal(idx, w_idx) and e == 0,
                          ("am_search_multibit", geom, cb, rows, cols, adc,
                           route))
                    check_routes(asm, one_route(asm, route),
                                 ("am_search_multibit", geom, cb, route))
                    mb_max = max(mb_max, e)
        out["multibit_max_err"] = mb_max
        if full:
            self.max_err["am_search_imc"] = imc_max
            self.max_err["am_search_multibit"] = mb_max
        return out

    def imc_within_tolerance(self, q, at, o, kw, idx, sim, w_idx, w_sim,
                             what) -> int:
        """The stated tolerance of am_search_imc on a float AM: a tile
        output may differ by one ADC step only where its pre-ADC partial
        sum lies within 2^-20 * sum|terms| of a rounding boundary, so a
        query may differ from the plain version only if one of its tiles
        does, and its similarity by at most one step per row tile.
        Called on a mismatch only (the plain version sums each slab in
        the kernel's row order, so over ±1 queries they agree exactly).
        Returns the number of differing queries."""
        np = self.np
        rows, cols = kw["tile_rows"], kw["tile_cols"]
        step = 2.0 * kw["adc_clip"] / 2 ** kw["adc_bits"]
        same = ((idx == w_idx) & (sim == w_sim)).cpu().numpy()
        bad = np.nonzero(~same)[0]
        qn = q.double().cpu().numpy()[bad]
        an = at.double().cpu().numpy()
        d = qn.shape[1]
        c = an.shape[0]
        gd = -(-d // rows)
        pad = gd * rows - d
        qr = np.pad(qn, ((0, 0), (0, pad))).reshape(len(bad), gd, rows)
        ar = np.pad(an, ((0, 0), (0, pad))).reshape(c, gd, rows)
        part = np.stack([qr[:, g] @ ar[:, g].T for g in range(gd)], 1)
        mag = np.stack([np.abs(qr[:, g]) @ np.abs(ar[:, g]).T
                        for g in range(gd)], 1)
        if o is not None:
            offs = np.repeat(o.double().cpu().numpy(), cols, axis=1)[:, :c]
            part = part + offs[None]
        part = np.clip(part, -kw["adc_clip"], kw["adc_clip"])
        frac = np.abs(part / step - np.floor(part / step) - 0.5) * step
        near = (frac <= 2.0 ** -20 * mag).any(axis=(1, 2))
        check(bool(np.all(near)), ("imc tolerance", what))
        diff = (sim - w_sim).abs().cpu().numpy()
        check(bool(np.all(diff <= gd * step)), ("imc sim tolerance", what))
        return len(bad)

    def qail_operands(self, rng, b, d, c, tie, dyadic):
        """Random qail_update operands: random targets (most rows miss), a
        padded last row, a class that owns no centroid, ties (duplicated
        AM columns) if ``tie``; a dyadic payload and lr = 2^-4, or a float
        payload and lr = 0.02. Returns (q, upd, am_t, owners, labels,
        mask, lr)."""
        np, torch = self.np, self.torch
        k = max(2, c // 3)
        am_t = self.bipolar(rng, (d, c))
        if tie:
            am_t = am_t[:, torch.arange(c, device=self.dev) % max(1, c // 3)]
        q = self.bipolar(rng, (b, d))
        owners = self.t(rng.integers(0, k, c).astype(np.int32))
        labels = rng.integers(0, k + 1, b).astype(np.int32)  # k: no owner
        mask = (rng.random(b) > 0.2).astype(np.float32)
        labels[-1], mask[-1] = -1, 0.0  # a padded row
        labels, mask = self.t(labels), self.t(mask)
        if dyadic:  # 2^-4 grid, |upd| < 2^10, lr 2^-4: exact partial sums
            upd = np.round(np.clip(rng.normal(0, 64, (b, d)), -1000, 1000)
                           * 16) / 16
            lr = 0.0625
        else:
            upd, lr = rng.normal(0, 8, (b, d)), 0.02
        return (q, self.t(upd.astype(np.float32)), am_t, owners, labels,
                mask, lr)

    def check_qail(self, rng, b, d, c, tie, dyadic):
        """qail_update at every block size against its plain version.
        Returns the max |delta error| and the max of |error| / tolerance."""
        torch = self.torch
        from repro_torch.kernels import qail_update as qu
        from repro_torch.kernels import ref
        q, upd, am_t, owners, labels, mask, lr = self.qail_operands(
            rng, b, d, c, tie, dyadic)
        w_pred, w_true, w_mis = ref.qail_targets(q, am_t, owners, labels,
                                                 mask)
        w_delta, w_miss = ref.qail_delta(upd, w_pred, w_true, w_mis, lr, c)
        w = (lr * w_mis)[:, None] * (
            torch.nn.functional.one_hot(w_true, c)
            - torch.nn.functional.one_hot(w_pred, c)).float()
        tol = 2.0 ** -20 * (w.abs().T @ upd.abs())
        max_err = max_rel = 0.0
        for bb in qu.BLOCK_B_CHOICES:
            delta, n_miss, pred_t, true_t, mis = qu.qail_update_targets(
                q, upd, am_t, owners, labels, mask, lr=lr, block_b=bb)
            torch.cuda.synchronize()
            geom = (b, d, c, tie, dyadic, bb)
            check(torch.equal(pred_t.long(), w_pred), ("qail pred_t", geom))
            check(torch.equal(true_t.long(), w_true), ("qail true_t", geom))
            check(torch.equal(mis, w_mis), ("qail mis", geom))
            check(n_miss.item() == w_miss.item(), ("qail n_miss", geom))
            err = (delta - w_delta).abs()
            if dyadic:
                check(err.max().item() == 0, ("qail delta dyadic", geom))
            rel = (err / tol.clamp_min(1e-30)).max().item()
            check((err <= tol).all().item(), ("qail delta", geom, rel))
            max_err = max(max_err, err.max().item())
            max_rel = max(max_rel, rel)
        return max_err, max_rel

    # -- phase 3 ---------------------------------------------------------------
    def main_path(self):
        np, torch = self.np, self.torch
        from repro_torch import kernels
        from repro_torch.configs.memhd_paper import paper_config
        from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
        from repro_torch.data import load_dataset
        from repro_torch.launch import serve_memhd as sm

        t0 = time.perf_counter()
        ds = load_dataset("mnist", device=self.dev)
        n_train, n_test = ds.train_x.shape[0], ds.test_x.shape[0]
        t_data = time.perf_counter() - t0
        enc, amc = paper_config("mnist", "1024x1024", batch_size=256,
                                kmeans_iters=25, epochs=EPOCHS)
        check(enc == EncoderConfig(kind="projection", features=784,
                                   dim=1024)
              and amc == MemhdConfig(dim=1024, columns=1024, classes=10,
                                     init_ratio=0.8, lr=0.02,
                                     batch_size=256, kmeans_iters=25,
                                     epochs=EPOCHS), (enc, amc))
        log({"phase": "main_path_config", "features": 784, "dim": 1024,
             "columns": 1024, "init_ratio": 0.8, "lr": 0.02,
             "batch_size": 256, "kmeans_iters": 25,
             "epochs": EPOCHS,
             "train": n_train, "test": n_test,
             "data_seconds": round(t_data, 3)})
        test_dy = np.round(ds.test_x.cpu().numpy() * 256) / 256
        test_dy = test_dy.astype(np.float32)
        reqs = sm.synthetic_requests(test_dy, 256, 32, seed=0)

        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = MemhdModel.create(0, enc, amc, device=self.dev)
        model, hist = model.fit(1, ds.train_x, ds.train_y)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        deployed = model.deploy(target="packed")
        reports, responses = {}, {}
        for fused in (False, True):
            # A warm pass runs every padded shape once; the timed pass is
            # the report, as in the serving CLI.
            sm.serve_batches(deployed, reqs, max_batch=1024, fused=fused,
                             depth=2)
            t0 = time.perf_counter()
            resp, stats = sm.serve_batches(deployed, reqs, max_batch=1024,
                                           warmup=False, fused=fused,
                                           depth=2)
            wall = time.perf_counter() - t0
            key = "fused" if fused else "staged"
            responses[key] = resp
            reports[key] = sm.build_report(deployed, reqs, stats, wall,
                                           fused=fused)
        torch.cuda.synchronize()
        launches = kernels.launches()
        self.launches = launches

        for name in MAIN_KERNELS:
            check(launches[name] > 0,
                  f"{name} was not launched on the main path")
        for r in reqs:
            plain = model.predict(self.t(r.feats)).cpu().numpy()
            check(np.array_equal(responses["staged"][r.rid],
                                 responses["fused"][r.rid]), r.rid)
            check(np.array_equal(responses["staged"][r.rid], plain), r.rid)
        acc_packed = deployed.score(ds.test_x, ds.test_y)
        acc_plain = model.score(ds.test_x, ds.test_y)
        check(acc_packed == acc_plain, (acc_packed, acc_plain))
        check(acc_packed > 0.5, acc_packed)
        log({"phase": "main_path", "fit_seconds": round(t_fit, 3),
             "init_rounds": len(hist["init"]),
             "final_train_miss": hist["curve"][-1]["train_miss"],
             "test_accuracy_packed": acc_packed,
             "test_accuracy_plain": acc_plain,
             "staged_eq_fused_eq_plain": True, "launches": launches})
        for key, rep in reports.items():
            log({"phase": f"serve_report_{key}", **rep})
        for fused in (False, True):
            self.profile_serving(deployed, reqs, fused)
        self.model, self.deployed, self.ds = model, deployed, ds
        self.enc, self.amc, self.reqs = enc, amc, reqs
        self.plain_fit = {"seconds": t_fit, "acc": acc_plain,
                          "miss": [r["train_miss"] for r in hist["curve"]]}

    def profile(self, phase, fn, **labels):
        """Device-busy share and the kernels that take the device time of
        one call of ``fn`` (torch.profiler, CUDA activity)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # Device-side events only (kernels, memcpys): the CPU op that
        # launched a kernel also reports its device time.
        rows = [(ev.self_device_time_total, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        log({"phase": phase, **labels,
             "wall_us_profiled": round(wall_us, 1),
             "device_busy_us": round(busy_us, 1),
             "device_busy_share": round(busy_us / wall_us, 4),
             "top_device_ops": [{"op": k[:80], "us": round(u, 1), "count": c}
                                for u, k, c in rows[:8]]})

    def profile_serving(self, deployed, reqs, fused, pipeline=None,
                        topk=0):
        from repro_torch.launch import serve_memhd as sm
        self.profile("serve_profile", lambda: sm.serve_batches(
            deployed, reqs, max_batch=1024, warmup=False, fused=fused,
            depth=2, topk=topk),
            pipeline=pipeline or ("fused" if fused else "staged"))

    # -- phase 4 ---------------------------------------------------------------
    def train_path(self):
        """fit(use_kernel=True) -> three deployments -> serve, with the
        launch counts zeroed just before and read just after."""
        np, torch = self.np, self.torch
        from repro_torch import kernels
        from repro_torch.core import MemhdModel
        from repro_torch.kernels import ops
        from repro_torch.launch import serve_memhd as sm
        ds, reqs = self.ds, self.reqs

        kernels.reset_launches()
        self.note_batches()
        ops.reset_dispatch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = MemhdModel.create(0, self.enc, self.amc, device=self.dev)
        model, hist = model.fit(1, ds.train_x, ds.train_y, use_kernel=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        n_batches = -(-ds.train_x.shape[0] // self.amc.batch_size)
        fit_launches = kernels.launches()["qail_update"]
        check(fit_launches == n_batches * EPOCHS,
              ("qail_update launches", fit_launches, n_batches * EPOCHS))
        fit_routes = check_int8_routes(fit_launches, "fit")

        targets = {"unpacked": dict(target="unpacked"),
                   "packed_unpack": dict(target="packed", mode="unpack"),
                   "packed_popcount": dict(target="packed")}
        reports, responses = {}, {}
        for name, kw in targets.items():
            dep = model.deploy(**kw)
            for fused in ((False,) if name == "unpacked" else (False, True)):
                sm.serve_batches(dep, reqs, max_batch=1024, fused=fused,
                                 depth=2)
                t0 = time.perf_counter()
                resp, stats = sm.serve_batches(dep, reqs, max_batch=1024,
                                               warmup=False, fused=fused,
                                               depth=2)
                wall = time.perf_counter() - t0
                key = f"{name}_{'fused' if fused else 'staged'}"
                responses[key] = resp
                reports[key] = sm.build_report(dep, reqs, stats, wall,
                                               fused=fused)
            acc = dep.score(ds.test_x, ds.test_y)
            reports[name + "_accuracy"] = acc
        torch.cuda.synchronize()
        launches = kernels.launches()
        tiers = ops.dispatch_breakdown()
        self.train_launches = launches

        for name in NEW_KERNELS:
            check(launches[name] > 0, f"{name} was not launched on the "
                                      "training path")
        from repro_torch.kernels import am_search as ams
        search_routes = check_routes(
            ams, {"int8": launches["am_search"], "fp32": 0},
            "unpacked serving")
        check("torch-ref" not in json.dumps(tiers), tiers)
        for r in reqs:
            plain = model.predict(self.t(r.feats)).cpu().numpy()
            for key, resp in responses.items():
                check(np.array_equal(resp[r.rid], plain), (key, r.rid))
        acc_kernel = model.score(ds.test_x, ds.test_y)
        for name in targets:
            check(reports[name + "_accuracy"] == acc_kernel,
                  (name, reports[name + "_accuracy"], acc_kernel))
        agree = (model.am_state["binary"]
                 == self.model.am_state["binary"]).float().mean().item()
        check(agree >= 0.999, ("binary AM agreement", agree))
        check(abs(acc_kernel - self.plain_fit["acc"]) <= 0.005,
              (acc_kernel, self.plain_fit["acc"]))
        log({"phase": "train_path",
             "fit_seconds_kernel": round(t_fit, 3),
             "fit_seconds_plain": round(self.plain_fit["seconds"], 3),
             "qail_update_launches_in_fit": fit_launches,
             "qail_update_routes_in_fit": fit_routes,
             "am_search_routes_in_serving": search_routes,
             "miss_curve_kernel": [r["train_miss"] for r in hist["curve"]],
             "miss_curve_plain": self.plain_fit["miss"],
             "test_accuracy_kernel": acc_kernel,
             "test_accuracy_plain": self.plain_fit["acc"],
             "binary_am_agreement": agree,
             "fp_max_abs_diff": (model.am_state["fp"]
                                 - self.model.am_state["fp"]
                                 ).abs().max().item(),
             "launches": launches, "dispatch_tiers": tiers})
        log({"phase": "unpacked_serving",
             "pipelines_eq_plain_predict": sorted(responses),
             "accuracy": {k[:-len("_accuracy")]: v for k, v in
                          reports.items() if k.endswith("_accuracy")}})
        for key, rep in reports.items():
            if not key.endswith("_accuracy"):
                log({"phase": f"serve_report_{key}", **rep})
        self.kmodel = model
        self.profile_training(model)

    def profile_training(self, model):
        """One QAIL epoch of the trained model, through the kernel and
        plain, under the profiler (device busy share, top kernels)."""
        from repro_torch.core import encoding, qail
        h = model.encode(self.ds.train_x)
        batches = qail.prebatch(h, encoding.binarize_query(h),
                                self.ds.train_y, self.amc.batch_size)
        for use_kernel in (True, False):
            self.profile("train_profile", lambda: qail.qail_epoch_scan(
                dict(model.am_state), self.amc, *batches,
                use_kernel=use_kernel),
                route="kernel" if use_kernel else "plain",
                batches=int(batches[0].shape[0]))

    # -- phase 9: the device-fidelity paths --------------------------------------
    def path_counts(self, fn):
        """Run ``fn`` with the launch counts and dispatch tiers zeroed just
        before and read just after: (result, launches, tiers)."""
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.kernels import ops
        kernels.reset_launches()
        self.note_batches()
        ops.reset_dispatch()
        torch.cuda.synchronize()
        result = fn()
        torch.cuda.synchronize()
        launches, tiers = kernels.launches(), ops.dispatch_breakdown()
        check("torch-ref" not in json.dumps(tiers), tiers)
        return result, launches, tiers

    def entry_points(self):
        """ops.encode_mvm on the main path's test features (B = 1024,
        f = 784, D = 1024) and ops.unpack_bits on its packed AM."""
        torch = self.torch
        from repro_torch.core import am as am_lib
        from repro_torch.kernels import ops
        feats = self.t(self.np.round(
            self.ds.test_x[:FULL[0]].cpu().numpy() * 256) / 256)
        proj = self.model.enc_params["projection"]
        rows_t = am_lib.pack_am(self.model.am_state["binary"]).T.contiguous()
        (h, unpacked), launches, tiers = self.path_counts(
            lambda: (ops.encode_mvm(feats, proj), ops.unpack_bits(rows_t)))
        for name in ("binary_mvm", "unpack_bits"):
            check(launches[name] > 0, f"{name} was not launched")
            self.path_launches[name] = launches[name]
        # Dyadic features: H is exact in any order, so equal to the plain
        # product; the unpacked AM is the model's ±1 AM.
        check(torch.equal(h, feats @ proj), "encode_mvm != feats @ proj")
        check(torch.equal(unpacked, self.model.am_state["binary"]),
              "unpack_bits(packed AM) != binary AM")
        self.entry_operands = (feats, proj, rows_t)
        log({"phase": "entry_points", "encode_mvm_shape": list(h.shape),
             "unpack_bits_shape": list(unpacked.shape),
             "launches": launches, "dispatch_tiers": tiers})

    def serve(self, dep, topk=0):
        """A warm pass, then the timed pass: (responses, report)."""
        from repro_torch.launch import serve_memhd as sm
        sm.serve_batches(dep, self.reqs, max_batch=1024, depth=2, topk=topk)
        t0 = time.perf_counter()
        resp, stats = sm.serve_batches(dep, self.reqs, max_batch=1024,
                                       warmup=False, depth=2, topk=topk)
        wall = time.perf_counter() - t0
        return resp, sm.build_report(dep, self.reqs, stats, wall, topk=topk)

    def request_queries(self, model):
        """Every request's encoded ±1 queries, concatenated, with the
        row offset of each request."""
        feats = self.np.concatenate([r.feats for r in self.reqs])
        ofs = self.np.cumsum([0] + [r.size for r in self.reqs])
        return model.encode_query(self.t(feats)), ofs

    def check_responses(self, responses, want, ofs, what):
        want = want.cpu().numpy()
        for i, r in enumerate(self.reqs):
            check(self.np.array_equal(responses[r.rid],
                                      want[ofs[i]:ofs[i + 1]]),
                  (what, r.rid))

    def imc_path(self):
        """deploy(target="imc") on the main path's model, ideal and noisy,
        served over the main path's request stream."""
        from repro_torch.core import ImcSimConfig
        from repro_torch.kernels import am_search_imc as asi
        from repro_torch.kernels import ref
        model, ds = self.model, self.ds
        sims = {"ideal": ImcSimConfig(), "noisy": ImcSimConfig(**NOISY_SIM)}

        def run():
            out = {}
            for name, sim in sims.items():
                dep = model.deploy(target="imc", sim=sim)
                asi.reset_routes()
                n0 = asi.am_search_imc.launches
                resp, rep = self.serve(dep)
                acc = dep.score(ds.test_x, ds.test_y)
                out[name] = (dep, resp, rep, acc,
                             asi.am_search_imc.launches - n0,
                             asi.route_counts())
            return out

        out, launches, tiers = self.path_counts(run)
        check(launches["am_search_imc"] > 0, "am_search_imc not launched")
        self.path_launches["am_search_imc"] = launches["am_search_imc"]
        # The ideal instance (±1 AM, no offsets) on the int8 route, the
        # noisy one (float AM) on the fp32 route, every launch.
        routes = {}
        for name, route in (("ideal", "int8"), ("noisy", "fp32")):
            n, got = out[name][4], out[name][5]
            check(n > 0 and got == {**dict.fromkeys(asi.ROUTES, 0),
                                    route: n},
                  ("am_search_imc routes", name, got, n))
            routes[name] = got
        from repro_torch.core import am as am_lib
        q, ofs = self.request_queries(model)
        owners = model.am_state["centroid_class"]
        self.check_responses(
            out["ideal"][1], am_lib.predict(model.am_state["binary"],
                                            owners, q),
            ofs, "imc ideal == plain predict")
        dep = out["noisy"][0]
        sim = sims["noisy"]
        w_idx, _ = ref.am_search_imc(
            q, dep.am_analog.T, tile_rows=sim.arr.rows,
            tile_cols=sim.arr.cols, adc_bits=sim.adc_bits,
            adc_clip=sim.clip, offsets=dep.tile_offsets)
        self.check_responses(out["noisy"][1], owners[w_idx.long()], ofs,
                             "imc noisy == ref.am_search_imc")
        acc_digital = model.score(ds.test_x, ds.test_y)
        check(out["ideal"][3] == acc_digital, (out["ideal"][3],
                                               acc_digital))
        cycles = out["ideal"][0].cycles
        check(cycles == 64 == model.imc_cost().am.cycles, cycles)
        self.imc_operands = (q[:FULL[0]].contiguous(), dep, out["ideal"][0])
        log({"phase": "imc_path", "cycles": cycles, "routes": routes,
             "accuracy_digital": acc_digital,
             "accuracy_ideal": out["ideal"][3],
             "accuracy_noisy": out["noisy"][3], "noisy_sim": NOISY_SIM,
             "ideal_eq_plain_predict": True,
             "noisy_eq_ref_am_search_imc": True,
             "launches": launches, "dispatch_tiers": tiers})
        for name in sims:
            log({"phase": f"serve_report_imc_{name}", **out[name][2]})
        self.profile_serving(out["noisy"][0], self.reqs, False,
                             pipeline="imc_noisy")

    def multibit_path(self):
        """fit(cell_bits=4) through qail_update -> deploy(target=
        "multibit", cell_bits=4) -> served."""
        from repro_torch.core import am as am_lib
        from repro_torch.imcsim import multibit_finetune
        model, ds = self.model, self.ds

        def run():
            t0 = time.perf_counter()
            tuned, hist = multibit_finetune(
                model, 2, ds.train_x, ds.train_y, 4,
                epochs=MULTIBIT_EPOCHS, use_kernel=True)
            self.torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            dep = tuned.deploy(target="multibit", cell_bits=4)
            resp, rep = self.serve(dep)
            return tuned, hist, t_fit, dep, resp, rep, dep.score(
                ds.test_x, ds.test_y)

        (tuned, hist, t_fit, dep, resp, rep, acc), launches, tiers = \
            self.path_counts(run)
        n_batches = -(-ds.train_x.shape[0] // self.amc.batch_size)
        check(launches["qail_update"] == n_batches * MULTIBIT_EPOCHS,
              ("qail_update launches", launches["qail_update"]))
        routes = check_int8_routes(launches["qail_update"], "multibit QAT")
        check(launches["am_search_multibit"] > 0,
              "am_search_multibit not launched")
        from repro_torch.kernels import am_search_multibit as asm
        mb_routes = check_routes(
            asm, {"int8": launches["am_search_multibit"], "fp32": 0},
            "multibit serving")
        self.path_launches["am_search_multibit"] = launches[
            "am_search_multibit"]
        q, ofs = self.request_queries(tuned)
        want = am_lib.multibit_predict(dep.am_planes_t, dep.centroid_class,
                                       q, 4)
        self.check_responses(resp, want, ofs,
                             "multibit == plain multibit_predict")
        planes_bytes = dep.am_planes_t.numel()
        check(planes_bytes == 4 * 128 * 1024, planes_bytes)
        self.multibit_operands = (q[:FULL[0]].contiguous(), dep)
        log({"phase": "multibit_path", "cell_bits": 4,
             "finetune_epochs": MULTIBIT_EPOCHS,
             "fit_seconds": round(t_fit, 3),
             "miss_curve": [r["train_miss"] for r in hist["curve"]],
             "accuracy_multibit": acc,
             "accuracy_binary": model.score(ds.test_x, ds.test_y),
             "resident_bytes": dep.resident_bytes,
             "planes_bytes": planes_bytes,
             "unpacked_float_bytes": 4 * 1024 * 1024,
             "cycles": dep.cycles, "eq_plain_multibit_predict": True,
             "launches": launches, "qail_update_routes": routes,
             "am_search_multibit_routes": mb_routes,
             "dispatch_tiers": tiers})
        log({"phase": "serve_report_multibit", **rep})
        self.profile_serving(dep, self.reqs, False, pipeline="multibit")

    # -- phase 10: the hierarchical paths -----------------------------------
    def hier_path(self):
        """deploy(target="hierarchical") of the main path's model, served
        top-1 and top-5 at S = G and top-1 at S = 8."""
        np, torch = self.np, self.torch
        from repro_torch.core import am as am_lib
        from repro_torch.kernels import am_shortlist as asl_mod
        from repro_torch.kernels import ref
        model = self.model

        def run():
            t0 = time.perf_counter()
            exact = model.deploy(target="hierarchical")
            torch.cuda.synchronize()
            t_deploy = time.perf_counter() - t0
            short = model.deploy(target="hierarchical", shortlist=8)
            out = {}
            for name, dep, k in (("exact_top1", exact, 1),
                                 ("exact_top5", exact, 5),
                                 ("s8_top1", short, 1)):
                out[name] = self.serve(dep, topk=k)
            return exact, short, t_deploy, out

        (exact, short, t_deploy, out), launches, tiers = self.path_counts(
            run)
        # Every served shortlist (B <= 32 against G = 45) takes the tile
        # route.
        shortlist_routes = check_routes(
            asl_mod, {"tile": launches["am_shortlist"], "stream": 0},
            "hierarchical path")
        for name in ("am_shortlist", "am_search_sparse"):
            check(launches[name] > 0, f"{name} was not launched on the "
                                      "hierarchical path")
            self.path_launches[name] = launches[name]
        q, ofs = self.request_queries(model)
        # The served shape of am_shortlist: a request's worth of queries
        # against the deployment's super-centroids, S = G.
        sq = ref.pack_rows(q[:HIER_SERVE_B])
        sspt = exact.super_packed_t
        served = asl_mod.am_shortlist(sq, sspt, n_dims=self.amc.dim,
                                      s=exact.groups)
        w_served = ref.am_shortlist(sq, sspt, self.amc.dim, exact.groups)
        check(all(torch.equal(a, b) for a, b in zip(served, w_served)),
              "am_shortlist at the served shape != plain")
        self.max_err["am_shortlist_served"] = (
            served[1] - w_served[1]).abs().max().item()
        self.hier_served = (sq, sspt, exact.groups)
        self.hier_exact = exact
        owners = model.am_state["centroid_class"]
        flat = am_lib.packed_predict(self.deployed.am_packed_t, owners, q,
                                     self.amc.dim)
        top5 = torch.cat([
            ref.am_search_topk(ref.pack_rows(q[i:i + 512]),
                               self.deployed.am_packed_t, self.amc.dim,
                               5)[0] for i in range(0, q.shape[0], 512)])
        self.check_responses({r: v[:, 0] for r, v in
                              out["exact_top1"][0].items()}, flat, ofs,
                             "hier S=G top-1 == packed flat predict")
        self.check_responses(out["exact_top5"][0], owners[top5.long()], ofs,
                             "hier S=G top-5 == ref.am_search_topk")
        got = np.concatenate([out["s8_top1"][0][r.rid][:, 0]
                              for r in self.reqs])
        recall = float(np.mean(got == flat.cpu().numpy()))
        check(exact.groups == 45 and exact.max_tiles == 1,
              (exact.groups, exact.max_tiles))
        log({"phase": "hier_path", "groups": exact.groups,
             "max_tiles": exact.max_tiles,
             "slab_tiles": exact.am_slab_t.shape[1] // 128,
             "deploy_seconds": round(t_deploy, 3),
             "resident_bytes": exact.resident_bytes,
             "flat_packed_bytes": self.deployed.resident_bytes,
             "serving_mode": [exact.serving_mode, short.serving_mode],
             "s_eq_g_top1_eq_flat": True, "s_eq_g_top5_eq_topk": True,
             "s8_class_agreement_with_flat": recall,
             "launches": launches, "shortlist_routes": shortlist_routes,
             "dispatch_tiers": tiers})
        for name, (_, rep) in out.items():
            log({"phase": f"serve_report_hier_{name}", **rep})
        self.profile_serving(short, self.reqs, False, pipeline="hier_s8_top5",
                             topk=5)

    def planted(self, rng, c, g_plant):
        """The reference bench's planted AM: (C, D) int8 bipolar rows,
        prototypes with ``proto_flip`` bit flips."""
        np = self.np
        d, chunk = HUGE["d"], 16384
        protos = rng.choice(np.array([-1, 1], np.int8), size=(g_plant, d))
        assign = rng.integers(0, g_plant, size=c)
        am = np.empty((c, d), np.int8)
        for i in range(0, c, chunk):
            blk = protos[assign[i:i + chunk]]
            flips = rng.random(blk.shape, dtype=np.float32) < HUGE[
                "proto_flip"]
            am[i:i + chunk] = np.where(flips, -blk, blk)
        return am

    def noisy_queries(self, rng, am):
        np = self.np
        src = rng.integers(0, am.shape[0], size=HUGE["batch"])
        q = am[src]
        flips = rng.random(q.shape, dtype=np.float32) < HUGE["query_flip"]
        return np.where(flips, -q, q).astype(np.int8)

    def hier_huge(self):
        """The reference's huge-label sweep point on the card: cluster,
        shortlist, sparse search, recall and device time against the
        flat packed scan."""
        np, torch = self.np, self.torch
        from repro_torch.deploy import hierarchical as hier
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import am_search_sparse as ass
        from repro_torch.kernels import am_shortlist as asl
        from repro_torch.kernels import ref
        d, c, g, b = HUGE["d"], HUGE["c"], HUGE["g"], HUGE["batch"]
        t0 = time.perf_counter()
        rng = np.random.default_rng(c)
        am = self.planted(rng, c, HUGE["g_plant"])
        qn = self.noisy_queries(rng, am)
        t_data = time.perf_counter() - t0
        # The exact best similarity, by fp32 products of the ±1 rows (exact
        # integers), chunked over C: independent of the packed kernels.
        qf = self.t(qn.astype(np.float32))
        exact = torch.full((b,), -float("inf"), device=self.dev)
        for i in range(0, c, 16384):
            blk = self.t(am[i:i + 16384]).float()
            exact = torch.maximum(exact, (qf @ blk.T).max(dim=1).values)
        qp = self.t(hier.pack_rows_np(qn))
        apt = self.t(hier.pack_rows_np(am).T.copy())

        def run():
            t0 = time.perf_counter()
            spt, lay = hier.build_search_state(
                c, am, g, kmeans_iters=8, kmeans_sample=16384,
                device=self.dev)
            torch.cuda.synchronize()
            t_cluster = time.perf_counter() - t0
            slab, ids, ts, tc = (self.t(a) for a in (
                lay.slab, lay.col_ids, lay.tile_start, lay.tile_count))
            res = {}
            for s_ in HUGE["shortlists"]:
                short, ssim = asl.am_shortlist(qp, spt, n_dims=d, s=s_)
                for k in (1, 5):
                    res[s_, k] = (short, ssim) + ass.am_search_sparse(
                        qp, slab, ids, short, ts, tc, n_dims=d, k=k,
                        max_tiles=lay.max_tiles)
            return spt, lay, (slab, ids, ts, tc), t_cluster, res

        (spt, lay, layout, t_cluster, res), launches, tiers = \
            self.path_counts(run)
        slab, ids, ts, tc = layout
        flat_idx, flat_sim = asp.am_search_packed(qp, apt, n_dims=d)
        torch.cuda.synchronize()
        check(torch.equal(flat_sim, exact), "flat packed scan != exact sims")
        out = {}
        for (s_, k), (short, ssim, idx, sim) in res.items():
            w_short = ref.am_shortlist(qp, spt, d, s_)
            check(torch.equal(short, w_short[0])
                  and torch.equal(ssim, w_short[1]), ("huge shortlist", s_))
            want = ass.am_search_sparse_plain(
                qp, slab, ids, short, ts, tc, n_dims=d, k=k,
                max_tiles=lay.max_tiles)
            check(torch.equal(idx, want[0]) and torch.equal(sim, want[1]),
                  ("huge sparse", s_, k))
            for name, e in (("am_shortlist", ssim - w_short[1]),
                            ("am_search_sparse", sim - want[1])):
                self.max_err[name] = max(self.max_err[name],
                                         e.abs().max().item())
            recall = (sim[:, 0] == exact).float().mean().item()
            out[f"s{s_}_k{k}_recall_at_1"] = recall
        check(out["s8_k1_recall_at_1"] >= RECALL_FLOOR, out)
        # Device time: the two-stage search against the flat scan.
        s8 = HUGE["shortlists"][0]
        short8 = res[s8, 1][0]

        def two_stage():
            sh, _ = asl.am_shortlist(qp, spt, n_dims=d, s=s8)
            return ass.am_search_sparse(qp, slab, ids, sh, ts, tc, n_dims=d,
                                        k=1, max_tiles=lay.max_tiles)

        def flat_ms():  # every query tile of the flat kernel
            return {bb: time_device_ms(lambda: asp.am_search_packed(
                qp, apt, n_dims=d, block_b=bb))
                for bb in asp.BLOCK_B_CHOICES}

        flat_before = flat_ms()
        hier_ms = time_device_ms(two_stage)
        flat_after = flat_ms()
        best_flat = min(min(flat_before.values()), min(flat_after.values()))
        # The exact anchor: S = G at C = 512 == am_search_packed.
        erng = np.random.default_rng(EXACT["c"])
        eam = self.planted(erng, EXACT["c"], EXACT["g_plant"])
        eq = self.t(hier.pack_rows_np(self.noisy_queries(erng, eam)))
        espt, elay = hier.build_search_state(
            EXACT["c"], eam, EXACT["g"], device=self.dev)
        eshort, _ = asl.am_shortlist(eq, espt, n_dims=d, s=EXACT["g"])
        e_idx, e_sim = ass.am_search_sparse(
            eq, *(self.t(a) for a in (elay.slab, elay.col_ids)), eshort,
            *(self.t(a) for a in (elay.tile_start, elay.tile_count)),
            n_dims=d, k=1, max_tiles=elay.max_tiles)
        f_idx, f_sim = asp.am_search_packed(
            eq, self.t(hier.pack_rows_np(eam).T.copy()), n_dims=d)
        torch.cuda.synchronize()
        check(torch.equal(e_idx[:, 0], f_idx) and torch.equal(e_sim[:, 0],
                                                               f_sim),
              "S = G at C = 512 != am_search_packed")
        self.huge = dict(qp=qp, spt=spt, layout=layout, lay=lay,
                         short8=short8)
        log({"phase": "hier_huge", "C": c, "D": d, "G": g, "B": b,
             "planted": HUGE["g_plant"], "data_seconds": round(t_data, 3),
             "cluster_seconds": round(t_cluster, 3),
             "slab_tiles": lay.n_tiles, "max_tiles": lay.max_tiles,
             "slab_bytes": int(lay.slab.size), "flat_bytes": int(apt.numel()),
             **out, "bit_exact_vs_plain": True,
             "exact_anchor_c512_eq_flat": True,
             "flat_ms_by_block_b": [flat_before, flat_after],
             "flat_default_ms": flat_before[asp.DEFAULT_BLOCK_B],
             "two_stage_s8_ms": hier_ms,
             "flat_default_over_two_stage":
                 flat_before[asp.DEFAULT_BLOCK_B] / hier_ms,
             "best_flat_over_two_stage": best_flat / hier_ms,
             "launches": launches, "dispatch_tiers": tiers})

    def robustness(self):
        """The robustness CLI as a subprocess, at its defaults and at
        1024 x 1024."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        for extra in ROBUSTNESS_RUNS:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.robustness_report",
                 *extra], env=env, capture_output=True, text=True,
                timeout=600)
            check(p.returncode == 0, p.stderr[-2000:])
            rep = json.loads(p.stdout)
            check(rep["base_sim_accuracy"] == rep["digital_accuracy"], rep)
            log({"phase": "robustness", "args": extra,
                 "seconds": round(time.perf_counter() - t0, 3),
                 **{k: rep[k] for k in ("geometry", "array", "cycles",
                                        "digital_accuracy",
                                        "base_sim_accuracy", "adc_sweep",
                                        "noise_sweep", "fault_sweep",
                                        "recovery")}})

    # -- phase 5 ---------------------------------------------------------------
    def train_dyadic(self):
        """The kernel fit and the plain fit bit-equal under dyadic
        conditions: features on a 2^-4 grid and lr = 2^-4 make every
        Eq.-(6) partial sum exact (|h| <= 784 on a 2^-4 grid, times lr:
        22 significant bits over a 256-row batch)."""
        import dataclasses
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.core import EncoderConfig, MemhdModel
        x = torch.round(self.ds.train_x * 16) / 16
        out = []
        for width in DYADIC_WIDTHS:
            enc = EncoderConfig(kind="projection", features=784, dim=width)
            amc = dataclasses.replace(self.amc, dim=width, columns=width,
                                      lr=0.0625, epochs=DYADIC_EPOCHS)
            fits = {}
            for use_kernel in (True, False):
                kernels.reset_launches()
                t0 = time.perf_counter()
                m = MemhdModel.create(0, enc, amc, device=self.dev)
                m, hist = m.fit(1, x, self.ds.train_y, use_kernel=use_kernel)
                torch.cuda.synchronize()
                fits[use_kernel] = (m.am_state,
                                    [r["train_miss"] for r in hist["curve"]],
                                    time.perf_counter() - t0)
                if use_kernel:
                    n = kernels.launches()["qail_update"]
                    check(n > 0, ("dyadic fit launches", width))
                    routes = check_int8_routes(n, ("dyadic fit", width))
            (k_am, k_miss, k_s), (p_am, p_miss, p_s) = fits[True], fits[False]
            for key in ("fp", "binary"):
                check(torch.equal(k_am[key], p_am[key]),
                      ("dyadic fit", width, key))
            check(k_miss == p_miss, ("dyadic miss curve", width))
            out.append({"dim": width, "columns": width,
                        "epochs": DYADIC_EPOCHS, "fp_equal": True,
                        "binary_equal": True, "miss_equal": True,
                        "miss_curve": k_miss, "qail_update_routes": routes,
                        "fit_seconds_kernel": round(k_s, 3),
                        "fit_seconds_plain": round(p_s, 3)})
        log({"phase": "train_dyadic", "fits": out})

    # -- phase 6 ---------------------------------------------------------------
    def cli(self):
        from repro_torch.launch import serve_memhd as sm
        base = ["--smoke", "--requests", "32", "--max-size", "24",
                "--max-batch", "128"]
        for extra in ([], ["--fused"], ["--target", "unpacked"],
                      ["--mode", "unpack"], ["--target", "imc"],
                      ["--target", "multibit", "--cell-bits", "4"],
                      ["--target", "hierarchical", "--topk", "5"],
                      ["--target", "hierarchical", "--shortlist", "4"]):
            rep = sm.main(base + extra)
            tiers = rep["metrics"]["dispatch_tiers"]
            check("torch-ref" not in json.dumps(tiers), tiers)
            log({"phase": "cli", "args": base + extra, "ok": True})

    def examples(self):
        """The port's four example drivers as subprocesses on the card, all
        started at once: each exits 0 and passes its own check, and its
        ``kernel launches`` line shows its path's kernels launched."""
        from repro_torch.configs import get_smoke_config
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            runs = {"train_lm_torch": ["--preset", "smoke", "--steps",
                                       str(EXAMPLE_TRAIN_STEPS),
                                       "--ckpt-dir", tmp],
                    "imc_mapping_report_torch": [],
                    "quickstart_torch": [],
                    "serve_lm_torch": []}
            procs = {name: subprocess.Popen(
                [sys.executable, os.path.join(HERE, "examples",
                                              f"{name}.py"), *args],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for name, args in runs.items()}
            outs = {}
            try:
                for name, proc in procs.items():
                    out, err = proc.communicate(timeout=600)
                    check(proc.returncode == 0,
                          (name, proc.returncode, err[-2000:]))
                    outs[name] = out
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
        secs = round(time.perf_counter() - t0, 3)
        launches = {}
        for name, out in outs.items():
            line = [ln for ln in out.splitlines()
                    if ln.startswith("kernel launches: ")]
            check(len(line) == 1, (name, out[-2000:]))
            launches[name] = {k: v for k, v in json.loads(
                line[0].split(": ", 1)[1]).items() if v}
        train = outs["train_lm_torch"]
        check("(drop +" in train and "no loss check" not in train,
              train[-2000:])
        scfg = get_smoke_config(TRAIN_ARCH)
        want = (EXAMPLE_TRAIN_STEPS * scfg.n_layers
                * -(-256 // scfg.blocks[0].ssm.chunk)
                * (2 if scfg.remat else 1))
        check(launches["train_lm_torch"] == {"ssd_chunk": want},
              ("train_lm_torch launches", launches, want))
        imc = outs["imc_mapping_report_torch"]
        check("=== Table II (array 128x128) ===" in imc
              and "head accuracy on synthetic 6-class task" in imc,
              imc[-2000:])
        qs = outs["quickstart_torch"]
        check("predictions bit-exact with the staged pipeline" in qs
              and "bit-exact with packed" in qs, qs[-2000:])
        got = launches["quickstart_torch"]
        check(all(got.get(k, 0) > 0 for k in QUICKSTART_KERNELS)
              and got.get("am_search_sparse", 0)
              + got.get("am_search_sparse_gathered", 0) > 0,
              ("quickstart_torch launches", got))
        check("arch=hymba-1.5b-smoke" in outs["serve_lm_torch"]
              and launches["serve_lm_torch"].get("flash_decode", 0) > 0,
              ("serve_lm_torch", launches["serve_lm_torch"]))
        log({"phase": "examples", "seconds_all_four": secs,
             "launches": launches,
             "last_lines": {name: [ln for ln in out.splitlines()
                                   if ln.strip()][-3:-1]
                            for name, out in outs.items()}})

    # -- phase 7 ---------------------------------------------------------------
    def trainer(self):
        """The trainer CLI killed at step 7, resumed, and run clean: the
        resumed and the clean run end on the same binary AM."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        out = {}
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            for device in TRAINER_DEVICES:
                def run(name, *extra):
                    cmd = [sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "memhd", "--smoke", "--steps", "10",
                           "--ckpt-every", "5", "--device", device,
                           "--ckpt-dir", os.path.join(tmp, device, name),
                           *extra]
                    return subprocess.run(cmd, env=env, capture_output=True,
                                          text=True, timeout=300)

                def result(p):
                    check(p.returncode == 0, p.stderr[-2000:])
                    return json.loads(p.stdout[p.stdout.index("{"):])

                t0 = time.perf_counter()
                crash = run("crash", "--fail-at-step", "7")
                check(crash.returncode == 42, ("crash exit", crash.returncode,
                                               crash.stderr[-2000:]))
                resumed = result(run("crash"))
                clean = result(run("clean"))
                check(resumed["resumed_from"] == 5, resumed)
                check(resumed["am_digest"] == clean["am_digest"],
                      (device, resumed["am_digest"], clean["am_digest"]))
                out[device] = {"am_digest": clean["am_digest"],
                               "resumed_from": resumed["resumed_from"],
                               "eval_acc": clean["eval_acc"],
                               "last_miss": clean["last_miss"],
                               "seconds_three_runs":
                                   round(time.perf_counter() - t0, 3)}
        digests = {v["am_digest"] for v in out.values()}
        log({"phase": "trainer", "crash_exit": 42, **out,
             "same_digest_on_every_device": len(digests) == 1})

    # -- phase 8 ---------------------------------------------------------------
    def reproducibility(self):
        torch = self.torch
        from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
        from repro_torch.data import load_dataset
        ds = load_dataset("mnist", train_per_class=300, test_per_class=50,
                          device=self.dev)
        enc = EncoderConfig(kind="projection", features=784, dim=128)
        amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=5,
                          kmeans_iters=10)
        rec = {"phase": "reproducibility"}
        for use_kernel in (False, True):
            ams = []
            for _ in range(2):
                m = MemhdModel.create(3, enc, amc, device=self.dev)
                m, _ = m.fit(4, ds.train_x, ds.train_y,
                             use_kernel=use_kernel)
                ams.append(m.am_state)
            same_bin = torch.equal(ams[0]["binary"], ams[1]["binary"])
            same_fp = torch.equal(ams[0]["fp"], ams[1]["fp"])
            check(same_bin and same_fp, (use_kernel, same_bin, same_fp))
            key = "kernel" if use_kernel else "plain"
            rec[f"{key}_binary_equal"] = same_bin
            rec[f"{key}_fp_equal"] = same_fp
        log(rec)

    # -- phase 13: the Table I baselines -----------------------------------------
    def baselines(self):
        """The four Table I baselines at the paper's 10,240-D on the full
        synthetic MNIST (SearcHD at N = 64): fit seconds, accuracy and
        memory. ``am_search`` (``ops.predict_classes``, its int8 route)
        == ``BaselineModel.predict`` on every test row; BasicHDC's encode
        through ``binary_mvm`` == the plain product on dyadic features.
        Then ``fit(init_method="random")`` at the main path's point."""
        np, torch = self.np, self.torch
        from repro_torch.core import BaselineConfig, baselines, encoding
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import ops, ref
        ds = self.ds
        test_dy = torch.round(ds.test_x * 256) / 256
        out, counts = {}, {"am_search": 0, "binary_mvm": 0}
        for kind in BASELINE_KINDS:
            cfg = BaselineConfig(kind=kind, dim=BASELINE_DIM, classes=10,
                                 n_models=BASELINE_N)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = baselines.fit_baseline(0, cfg, ds.train_x, ds.train_y,
                                           device=self.dev)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            acc = model.score(ds.test_x, ds.test_y)
            plain = torch.cat([model.predict(ds.test_x[i:i + 2048])
                               for i in range(0, ds.test_x.shape[0], 2048)])
            q = model.encode_query(ds.test_x)

            def search():
                return torch.cat([ops.predict_classes(
                    q[i:i + 2048], model.am, model.owners)
                    for i in range(0, q.shape[0], 2048)])

            pred, launches, tiers = self.path_counts(search)
            check(torch.equal(pred, plain), (kind, "am_search != predict"))
            routes = check_routes(ams, {"int8": launches["am_search"],
                                        "fp32": 0}, (kind, "baseline"))
            rec = {"fit_seconds": round(t_fit, 3), "test_accuracy": acc,
                   "memory_kb": model.memory_kb,
                   "am_shape": list(model.am.shape),
                   "am_search_eq_predict": True,
                   "am_search_routes": routes}
            counts["am_search"] += launches["am_search"]
            if kind == "basic":
                proj = model.enc_params["projection"]
                h, launches, _ = self.path_counts(
                    lambda: ops.encode_mvm(test_dy, proj))
                check(torch.equal(h, ref.binary_mvm(test_dy, proj)),
                      "binary_mvm != the plain product at D = 10,240")
                counts["binary_mvm"] += launches["binary_mvm"]
                rec["binary_mvm_eq_plain"] = True
            else:
                # The id_level encode of the training set, timed alone.
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encoding.encode(model.enc_params, model.enc_cfg, ds.train_x)
                torch.cuda.synchronize()
                rec["id_level_encode_seconds"] = round(
                    time.perf_counter() - t0, 3)
                rec["id_level_encode_rows"] = int(ds.train_x.shape[0])
            out[kind] = rec
            del model, q
        self.baseline_launches = counts

        # Random-sampling init (Fig. 5's baseline) at the main point,
        # trained through qail_update.
        from repro_torch.core import MemhdModel
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = MemhdModel.create(0, self.enc, self.amc, device=self.dev)
        model, hist = model.fit(1, ds.train_x, ds.train_y,
                                init_method="random", epochs=RANDOM_EPOCHS,
                                use_kernel=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        owners = model.am_state["centroid_class"]
        check(torch.equal(torch.bincount(owners.long(), minlength=10),
                          torch.full((10,), 1024 // 10, device=self.dev)
                          + (torch.arange(10, device=self.dev) < 4)),
              "random init's even split")
        acc = model.score(ds.test_x, ds.test_y)
        check(acc > 0.5, ("random-init accuracy", acc))
        log({"phase": "baselines", "dim": BASELINE_DIM,
             "searchd_n": BASELINE_N, "train": int(ds.train_x.shape[0]),
             "test": int(ds.test_x.shape[0]), "fits": out,
             "launches": counts,
             "random_init": {"epochs": RANDOM_EPOCHS,
                             "fit_seconds": round(t_fit, 3),
                             "test_accuracy": acc,
                             "clustering_init_test_accuracy":
                                 self.plain_fit["acc"],
                             "final_train_miss":
                                 hist["curve"][-1]["train_miss"]}})

    # -- phase 14: online serving with live class growth -------------------------
    def online(self):
        """The online engine in-process at the paper's 1024 x 1024 MNIST
        point, trained without the last class: phase A, a drifted
        same-C fold, phase B, a class-append fold, phase C. Every
        response == the plain predict of the generation that served it;
        zero steady-state rebuilds; every fold minibatch a
        ``qail_update`` launch. Then the ``serve_online`` CLI and
        ``serve_memhd --metrics-out/--trace-out`` as subprocesses."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch import obs
        from repro_torch.configs.memhd_paper import paper_config
        from repro_torch.core import MemhdModel
        from repro_torch.serve import (
            OnlineEngine, StreamingUpdater, apply_drift, feedback_burst,
            merge_events, poisson_arrivals,
        )
        ds = self.ds
        known = 9
        tr_x, tr_y = ds.train_x.cpu().numpy(), ds.train_y.cpu().numpy()
        te_x, te_y = ds.test_x.cpu().numpy(), ds.test_y.cpu().numpy()
        enc, amc = paper_config("mnist", "1024x1024", classes=known,
                                batch_size=256, kmeans_iters=25,
                                epochs=ONLINE["epochs"])
        mask = tr_y < known
        t0 = time.perf_counter()
        model = MemhdModel.create(0, enc, amc, device=self.dev)
        model, _ = model.fit(1, tr_x[mask], tr_y[mask], use_kernel=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        # A batch launched on generation 0 and still in flight when a
        # class-append fold swaps in generation 1 finishes against the
        # old artifact, and the old artifact still answers the same.
        probe = StreamingUpdater(model, model.deploy(target="packed"))
        old = probe.artifact
        xq = self.t(te_x[:1024])
        want = old.predict(xq)
        torch.cuda.synchronize()
        inflight = old.predict(xq)  # no sync: queued when the fold starts
        grow_rows = np.nonzero(tr_y == known)[0][:1024]
        probe.ingest(tr_x[grow_rows], tr_y[grow_rows])
        res = probe.fold()
        check(not res.shape_stable and probe.artifact is not old,
              "the probe fold did not swap a grown artifact")
        check(torch.equal(inflight, want), "in-flight batch changed")
        check(torch.equal(old.predict(xq), want), "old artifact changed")
        check(probe.artifact.swap_signature != old.swap_signature,
              "grown artifact kept its signature")
        del probe, old
        updater = StreamingUpdater(model, model.deploy(target="packed"),
                                   fold_epochs=ONLINE["fold_epochs"])
        engine = OnlineEngine(updater, max_batch=ONLINE["max_batch"],
                              depth=2, max_wait_ms=20.0)
        models = {0: model}
        fold = updater.fold

        def recording_fold():
            res = fold()
            if res is not None:
                models[res.generation] = updater.model
            return res

        updater.fold = recording_fold
        rng = np.random.default_rng(5)
        kw = dict(rate_qps=ONLINE["rate"], max_size=32, deadline_ms=250.0,
                  labels_pool=te_y)
        n_req, cap = ONLINE["requests"], updater.buffer_cap
        a = poisson_arrivals(te_x, n_requests=n_req, classes=range(known),
                             seed=10, **kw)
        t = a[-1].t + 1e-3
        drift_rows = rng.choice(np.nonzero(mask)[0],
                                min(cap, int(mask.sum())), replace=False)
        f1 = feedback_burst(apply_drift(tr_x[drift_rows], 0.35),
                            tr_y[drift_rows], t=t, fold=True)
        pool_b = apply_drift(te_x, 0.35)
        b = poisson_arrivals(pool_b, n_requests=n_req, classes=range(known),
                             start=t, rid_base=100_000, seed=11, **kw)
        t = b[-1].t + 1e-3
        new_rows = np.nonzero(tr_y == known)[0][:cap]
        f2 = feedback_burst(tr_x[new_rows], tr_y[new_rows], t=t, fold=True)
        c = (poisson_arrivals(pool_b, n_requests=n_req // 2,
                              classes=range(known), start=t,
                              rid_base=200_000, seed=12, **kw)
             + poisson_arrivals(te_x, n_requests=n_req // 2,
                                classes=[known], start=t, rid_base=300_000,
                                seed=13, **kw))
        events = merge_events(a, f1, b, f2, c)
        obs.TRACER.reset()
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            report, launches, tiers = self.path_counts(
                lambda: engine.serve(events))
        want_folds = ONLINE["fold_epochs"] * (
            -(-len(drift_rows) // 256) + -(-len(new_rows) // 256))
        check(launches["qail_update"] == want_folds,
              ("fold launches", launches["qail_update"], want_folds))
        fold_routes = check_int8_routes(want_folds, "online folds")
        for name in ("am_search_packed", "pack_bits"):
            check(launches[name] > 0, f"{name} was not launched online")
        check(report["recompiles_steady_state"] == 0, report)
        check(report["model_generation"] == 2, report)
        check([g["shape_stable"] for g in report["generations"]]
              == [True, False], report["generations"])
        phases = {"A": (a, 0), "B": (b, 1), "C": (c, 2)}
        stats = {}
        for name, (arr, gen) in phases.items():
            hits = rows = 0
            for ev in arr:
                r = ev.request
                check(engine.request_generation[r.rid] == gen,
                      (name, r.rid, engine.request_generation[r.rid]))
                plain = models[gen].predict(self.t(r.feats)).cpu().numpy()
                check(np.array_equal(engine.responses[r.rid], plain),
                      ("online", name, r.rid))
                hits += int((plain == r.labels).sum())
                rows += r.size
            stats[name] = {"requests": len(arr), "rows": rows,
                           "accuracy": round(hits / rows, 4)}
        self.online_launches = launches
        # Where the stream's time goes: the engine's record_function
        # ranges (host time of each; the profiler also lays each range on
        # the device timeline as a user annotation, whose length is not
        # busy time) and the device-busy total of the kernels and copies.
        ranges = {}
        device_us = 0.0
        top = []
        for ev in prof.key_averages():
            if ev.key in ENGINE_RANGES:
                rec = ranges.setdefault(ev.key, {"count": ev.count})
                if ev.device_type == DeviceType.CUDA:
                    rec["device_annotation_ms"] = round(
                        ev.self_device_time_total / 1e3, 3)
                else:
                    rec["cpu_ms"] = round(ev.cpu_time_total / 1e3, 3)
            elif (ev.device_type == DeviceType.CUDA
                    and ev.self_device_time_total > 0):
                device_us += ev.self_device_time_total
                top.append((ev.self_device_time_total, ev.key, ev.count))
        top.sort(reverse=True)
        spans = {}
        for e in obs.TRACER.events():
            s = spans.setdefault(e.name, [0, 0.0])
            s[0] += 1
            s[1] += e.dur_ns / 1e6
        log({"phase": "online", "geometry": "1024x1024", "classes": known,
             "fit_epochs": ONLINE["epochs"],
             "fit_seconds": round(t_fit, 3),
             "report": {k: report[k] for k in (
                 "requests", "rows", "batches", "avg_batch_rows",
                 "pad_overhead", "buckets", "wall_s", "qps", "rows_per_s",
                 "lat_ms_p50", "lat_ms_p95", "lat_ms_p99",
                 "service_ms_p50", "deadline_miss_rate",
                 "model_generation", "generations",
                 "recompiles_steady_state", "recompiles_excluded")},
             "phases": stats, "each_response_eq_its_generation": True,
             "preswap_inflight_eq_old_generation": True,
             "launches": launches, "dispatch_tiers": tiers,
             "fold_launches_expected": want_folds,
             "qail_update_routes_in_folds": fold_routes})
        log({"phase": "online_profile", "ranges": ranges,
             "device_busy_ms": round(device_us / 1e3, 3),
             "device_busy_share": round(device_us / 1e6 / report["wall_s"],
                                        4),
             "span_ms": {k: {"count": v[0], "ms": round(v[1], 3)}
                         for k, v in sorted(spans.items())},
             "top_device_ops": [{"op": k[:80], "us": round(u, 1),
                                 "count": n_} for u, k, n_ in top[:8]]})
        self.online_cli()

    def online_cli(self):
        """``serve_online --smoke --append-class`` and ``serve_memhd
        --metrics-out/--trace-out`` as subprocesses on the card, with the
        ``record_cli`` runs alongside."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        records = tempfile.mkdtemp(dir=build)
        t0 = time.perf_counter()
        runs = start_record_runs(env, records)
        try:
            self.online_cli_runs(env, build)
            self.record_cli(runs, t0)
        finally:
            for _, proc, _ in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(records, ignore_errors=True)

    def record_cli(self, runs, t0):
        """The ``--record-dir`` runs' records against their reports: the
        card's name and power limit as ``nvidia-smi`` gives them, every
        metric and meta field as ``obs.record.from_report`` makes it from
        the printed report, and every dispatch of the path on ``cuda``.
        The report of ``serve_memhd`` carries its dispatch tiers (in the
        record's ``meta.metrics``); the online report has none, as the
        reference's, so its run's tiers come from its ``--metrics-out``
        snapshot. ``meta.obs.dispatch_tiers`` is empty, as the
        reference's: ``from_report`` opens its recorder after the run.
        ``seconds`` counts from the runs' start (they overlap
        ``online_cli``'s)."""
        name, limit = (v.strip() for v in
                       nvidia_smi("name,power.limit").split(","))
        device = {"platform": "gpu", "name": name,
                  "power_limit_w": float(limit.split()[0]),
                  "count": self.torch.cuda.device_count()}
        logged = []
        for label, proc, out in runs:
            if proc.wait(timeout=600) != 0:
                with open(os.path.join(out, "stderr.txt")) as f:
                    check(False, (label, f.read()[-2000:]))
            with open(os.path.join(out, "stdout.txt")) as f:
                rep = json.load(f)
            bench = label.split()[0]
            path = os.path.join(out, f"BENCH_{bench}.json")
            with open(path) as f:
                rec = json.load(f)
            check(set(rec) == RECORD_KEYS, (label, sorted(rec)))
            check(rec["schema_version"] == 1 and rec["bench"] == bench,
                  (label, rec["bench"]))
            check(rec["device"] == device, (label, rec["device"], device))
            check(rec["torch_version"] == self.torch.__version__,
                  rec["torch_version"])
            want = record_metrics(rep)
            check(rec["metrics"] == want, (label, rec["metrics"], want))
            meta = {k: v for k, v in rep.items() if k not in want}
            check({k: v for k, v in rec["meta"].items() if k != "obs"}
                  == meta, (label, sorted(rec["meta"]), sorted(meta)))
            check(rec["meta"]["obs"]["dispatch_tiers"] == {},
                  (label, rec["meta"]["obs"]))
            if bench == "serve_memhd":
                tiers = rec["meta"]["metrics"]["dispatch_tiers"]
                check(rec["meta"]["obs"]["compiles_total"]
                      == rep["metrics"]["compiles_total"],
                      (label, rec["meta"]["obs"], rep["metrics"]))
            else:
                with open(os.path.join(out, "metrics.json")) as f:
                    tiers = snapshot_tiers(json.load(f))
            check(RECORD_KERNELS[label] <= set(tiers)
                  and all(set(t) == {"cuda"} for t in tiers.values()),
                  (label, tiers))
            logged.append({
                "run": label, "device": rec["device"],
                "git_sha": rec["git_sha"], "metrics": len(rec["metrics"]),
                "rows_per_s": rec["metrics"]["rows_per_s"]["value"],
                "lat_ms_p50": rec["metrics"]["lat_ms_p50"]["value"],
                "dispatch_tiers": tiers, "obs": rec["meta"]["obs"]})
        log({"phase": "record_cli",
             "seconds": round(time.perf_counter() - t0, 3),
             "records": logged})

    def online_cli_runs(self, env, build):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_online",
             "--smoke", "--append-class"], env=env, capture_output=True,
            text=True, timeout=600)
        check(p.returncode == 0, p.stderr[-2000:])
        rep = json.loads(p.stdout)
        check(rep["model_generation"] == 2, rep)
        check(rep["recompiles_steady_state"] == 0, rep)
        check([g["shape_stable"] for g in rep["generations"]]
              == [True, False], rep["generations"])
        check(rep["device"].startswith("cuda"), rep["device"])
        log({"phase": "online_cli", "seconds": round(
            time.perf_counter() - t0, 3),
            **{k: rep[k] for k in ("model_generation", "generations",
                                   "recompiles_steady_state",
                                   "recompiles_excluded", "qps",
                                   "lat_ms_p50", "lat_ms_p99", "phases")}})
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            mpath = os.path.join(tmp, "metrics.json")
            tpath = os.path.join(tmp, "trace.json")
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve_memhd",
                 "--smoke", "--requests", "32", "--metrics-out", mpath,
                 "--trace-out", tpath], env=env, capture_output=True,
                text=True, timeout=600)
            check(p.returncode == 0, p.stderr[-2000:])
            rep = json.loads(p.stdout)
            with open(mpath) as f:
                snap = json.load(f)
            with open(tpath) as f:
                trace = json.load(f)
        check(rep["metrics"]["recompiles_steady_state"] == 0, rep["metrics"])
        tiers = rep["metrics"]["dispatch_tiers"]
        check("torch-ref" not in json.dumps(tiers), tiers)
        check(snap["serve_requests_total"]["values"][""] == 64, snap.get(
            "serve_requests_total"))
        dispatch = snap["kernel_dispatch_total"]["values"]
        check(all('tier="cuda"' in k for k in dispatch), dispatch)
        gauges = snap.get("torch_device_memory_bytes", {}).get("values", {})
        check(any('device="cuda:0"' in k for k in gauges), "memory gauges")
        names = {e["name"] for e in trace["traceEvents"]}
        check({"warmup", "serve", "dispatch", "device_wait"} <= names, names)
        log({"phase": "serve_memhd_obs_files",
             "metrics_families": sorted(snap), "trace_events":
             len(trace["traceEvents"]), "span_names": sorted(names),
             "kernel_builds_total": snap["kernel_builds_total"]["values"],
             "compiles_total": rep["metrics"]["compiles_total"]})

    # -- phase 15: the autotuner ----------------------------------------------
    def tuned_operands(self):
        """The three tuned kernels' calls at the main path's shapes through
        ``ops``: {kernel: (dims, fn(block_b))}."""
        from repro_torch.core import encoding
        from repro_torch.kernels import ops, ref
        torch = self.torch
        b, f, d, c = FULL
        feats = self.t(self.np.round(
            self.ds.test_x[:b].cpu().numpy() * 256) / 256)
        proj = self.model.enc_params["projection"]
        qp = ref.pack_rows(encoding.encode_query(
            self.model.enc_params, self.model.enc_cfg, feats))
        am_t = self.deployed.am_packed_t
        km = self.kmodel
        h = km.encode(self.ds.train_x[:TRAIN_B])
        tq = encoding.binarize_query(h)
        ty = self.ds.train_y[:TRAIN_B].to(torch.int32)
        tmask = torch.ones(TRAIN_B, device=self.dev)
        tam_t = km.am_state["binary"].T
        owners = km.am_state["centroid_class"]
        lr = self.amc.lr
        self.tuned_qp = qp
        return {
            "am_search_packed": ({"D": d, "C": c}, lambda bb: (
                ops.am_search_packed(qp, am_t, n_dims=d, block_b=bb))),
            "qail_update": ({"D": d, "C": c}, lambda bb: ops.qail_update(
                tq, h, tam_t, owners, ty, tmask, lr=lr, block_b=bb)),
            "encode_pack": ({"f": f, "D": d}, lambda bb: (
                ops.encode_pack(feats, proj, block_b=bb),))}

    def autotune(self):
        """The tuner over every spec at ``DEFAULT_GEOMETRIES`` into a
        temporary cache (every candidate bit-exact against its plain
        version on the card, else it raises); then, at the main path's
        geometries, which the committed cache holds for this card,
        ``block_b=None`` through ``ops`` launches the committed
        configuration (the launches by configuration) and equals the
        default configuration bit for bit."""
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import autotune, ops, qail_update
        kind = torch.cuda.get_device_name(0)
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            entries = autotune.autotune_all(
                cache=os.path.join(tmp, "cache.json"), verbose=False)
        seconds = time.perf_counter() - t0
        n_geoms = sum(len(g) for g in autotune.DEFAULT_GEOMETRIES.values())
        check(len(entries) == n_geoms, (len(entries), n_geoms))
        winners = []
        for e in entries:
            check(e["device"] == kind and e["power_limit_w"] > 0, e)
            winners.append({k: e[k] for k in (
                "kernel", "geometry", "block_b", "tuned_batches", "best_us",
                "default_block_b", "default_us", "speedup_vs_default",
                "candidates_us",
                "same_plan", "skipped_smem", "power_limit_w")})
            if "tile" in e:
                winners[-1]["tile"] = e["tile"]
        log({"phase": "autotune", "device": kind,
             "power_limit": nvidia_smi("power.limit"),
             "seconds": round(seconds, 3), "entries": len(entries),
             "every_candidate_bit_exact": True, "winners": winners})

        check(autotune.cache_path() == autotune.DEFAULT_CACHE,
              ("ops reads", autotune.cache_path()))
        committed = autotune.load_cache(autotune.DEFAULT_CACHE)
        geoms = {(k, autotune.geometry_key(k, **dims))
                 for k, gs in autotune.DEFAULT_GEOMETRIES.items()
                 for dims in gs}
        missing = sorted(g for g in geoms
                         if f"{g[0]}|{kind}|{g[1]}" not in committed)
        check(not missing, ("the committed cache lacks", kind, missing))
        self.tuned = {}
        out = {}
        for kernel, (dims, run) in self.tuned_operands().items():
            spec = autotune.KERNELS[kernel]
            entry = committed[f"{kernel}|{kind}|"
                              f"{autotune.geometry_key(kernel, **dims)}"]
            cfg = entry.get("tile", entry["block_b"])
            kernels.reset_launches()
            got = run(None)
            torch.cuda.synchronize()
            launched = kernels.config_launches()[kernel]
            check(launched == {cfg: 1}, (kernel, "launched", launched, cfg))
            if kernel == "qail_update":
                check(qail_update.route_counts() == {"int8": 1, "fp32": 0},
                      qail_update.route_counts())
            want = run(spec.default_block_b)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  (kernel, "tuned != default"))
            self.tuned[kernel] = cfg
            out[kernel] = {"geometry": entry["geometry"], "tuned": cfg,
                           "tuned_batches": entry["tuned_batches"],
                           "default": spec.default_candidate,
                           "launched": launched,
                           "committed_best_us": entry["best_us"],
                           "committed_default_us": entry["default_us"],
                           "committed_power_limit_w":
                               entry["power_limit_w"]}
        # The packed search reads the tuned tile only in popcount mode and
        # inside the tuned batch range: 8 rows and unpack mode launch the
        # default.
        d = FULL[2]
        outside = {}
        for what, call in (
                ("B = 8", lambda: ops.am_search_packed(
                    self.tuned_qp[:8], self.deployed.am_packed_t, n_dims=d)),
                ("unpack", lambda: ops.am_search_packed(
                    self.tuned_qp, self.deployed.am_packed_t, n_dims=d,
                    mode="unpack"))):
            kernels.reset_launches()
            call()
            torch.cuda.synchronize()
            launched = kernels.config_launches()["am_search_packed"]
            check(launched == {asp.DEFAULT_BLOCK_B: 1},
                  ("am_search_packed", what, launched))
            outside[what] = launched
        log({"phase": "autotune_dispatch", "device": kind, "cache":
             os.path.relpath(autotune.DEFAULT_CACHE, HERE),
             "tuned_eq_default": True, "kernels": out,
             "am_search_packed_default_launches": outside})

    def dispatched_batches(self):
        """The batches (B) of the CUDA dispatches of the tuned kernels
        over every phase so far (plain-path runs excluded), with the share
        of them inside the tuned batch range, which ``ops`` reads the
        tuned tile for."""
        from repro_torch.kernels import autotune, ops
        self.note_batches()
        ops.reset_dispatch()
        spec_of = {"am_search_packed": "am_search_packed",
                   "search_from_features": "am_search_packed",
                   "predict_from_features": "am_search_packed",
                   "encode_pack": "encode_pack", "qail_update": "qail_update"}
        out = {}
        for kernel, spec in spec_of.items():
            seen = self.batches_seen.get(kernel, {})
            batches = autotune.KERNELS[spec].batches
            n = sum(seen.values())
            inside = sum(v for b, v in seen.items()
                         if min(batches) <= b <= max(batches))
            out[kernel] = {"dispatches": n, "tuned_batches": list(batches),
                           "in_tuned_range": inside / n if n else None,
                           "by_batch": dict(sorted(seen.items()))}
        log({"phase": "dispatched_batches", "kernels": out})

    # -- phase 16: sharded serving -------------------------------------------
    def sharded(self):
        """The main path's model deployed packed (staged and fused),
        unpacked, imc (ideal), multibit 4-bit and hierarchical (top-5),
        each wrapped in ``ShardedArtifact`` over two shards of the card and
        served with ragged requests (through ``serve_batches`` and
        directly, odd row counts included): every response equals the
        unwrapped artifact's; launch counts zeroed just before and read
        just after, no ``torch-ref`` tier. Then ``serve_memhd --devices
        1`` and ``serve_online --smoke --append-class --devices 1``."""
        np, torch = self.np, self.torch
        from repro_torch.deploy import ShardedArtifact
        from repro_torch.launch import serve_memhd as sm
        from repro_torch.launch import serve_online
        mesh = (self.dev,) * SHARDS
        deps = {
            "packed_staged": (self.deployed, False, 0,
                              ("pack_bits", "am_search_packed")),
            "packed_fused": (self.deployed, True, 0,
                             ("encode_pack", "am_search_packed")),
            "unpacked": (self.model.deploy(target="unpacked"), False, 0,
                         ("am_search",)),
            "imc_ideal": (self.imc_operands[2], False, 0,
                          ("am_search_imc",)),
            "multibit4": (self.multibit_operands[1], False, 0,
                          ("am_search_multibit",)),
            "hierarchical_top5": (self.hier_exact, False, 5,
                                  ("pack_bits", "am_shortlist",
                                   "am_search_sparse"))}
        feats = self.t(np.concatenate([r.feats for r in self.reqs]))
        ofs = np.cumsum([0] + [r.size for r in self.reqs])
        direct = self.reqs[:SHARDED_DIRECT_REQUESTS]
        out = {}
        self.sharded_launches = {}
        for name, (dep, fused, k, names) in deps.items():
            if k:
                want = dep.predict_topk(feats, k)[0]
            else:
                want = (dep.predict_features if fused else dep.predict)(feats)
            sh = ShardedArtifact(dep, mesh=mesh)
            check(sh.n_devices == SHARDS and sh.row_multiple == SHARDS,
                  sh.mesh)

            def run(sh=sh, fused=fused, k=k):
                sm.serve_batches(sh, self.reqs, max_batch=1024, depth=2,
                                 fused=fused, topk=k)
                t0 = time.perf_counter()
                resp, stats = sm.serve_batches(
                    sh, self.reqs, max_batch=1024, warmup=False, depth=2,
                    fused=fused, topk=k)
                wall = time.perf_counter() - t0
                rows = {}
                for r in direct:
                    x = self.t(r.feats)
                    rows[r.rid] = (sh.predict_topk(x, k)[0] if k else
                                   (sh.predict_features if fused
                                    else sh.predict)(x))
                return resp, sm.build_report(sh, self.reqs, stats, wall,
                                             fused=fused, topk=k), rows

            (resp, rep, rows), launches, tiers = self.path_counts(run)
            for kn in names:
                check(launches[kn] > 0, (name, kn, "not launched"))
                self.sharded_launches[kn] = (
                    self.sharded_launches.get(kn, 0) + launches[kn])
            self.check_responses(resp, want, ofs,
                                 ("sharded == unwrapped", name))
            for i, r in enumerate(direct):
                check(torch.equal(rows[r.rid], want[ofs[i]:ofs[i + 1]]),
                      ("sharded direct == unwrapped", name, r.rid))
            check(rep["devices"] == SHARDS, rep["devices"])
            out[name] = {"launches": {kn: launches[kn] for kn in names},
                         "dispatch_tiers": tiers,
                         "odd_direct_requests": sum(r.size % 2
                                                    for r in direct),
                         **{key: rep[key] for key in (
                             "rows_per_s", "rows_per_s_per_device",
                             "lat_ms_p50", "pad_overhead", "batches")}}
        log({"phase": "sharded", "mesh": [str(d) for d in sh.mesh],
             "requests": len(self.reqs), "each_response_eq_unwrapped": True,
             "deployments": out})
        t0 = time.perf_counter()
        rep = sm.main(["--smoke", "--requests", "32", "--max-size", "24",
                       "--max-batch", "128", "--devices", "1"])
        check(rep["devices"] == 1, rep["devices"])
        check(rep["metrics"]["recompiles_steady_state"] == 0, rep["metrics"])
        check("torch-ref" not in json.dumps(rep["metrics"]["dispatch_tiers"]),
              rep["metrics"])
        orep = serve_online.main(["--smoke", "--append-class", "--devices",
                                  "1"])
        check(orep["devices"] == 1 and orep["device"].startswith("cuda"),
              orep["device"])
        check(orep["model_generation"] == 2, orep)
        check(orep["recompiles_steady_state"] == 0, orep)
        check([g["shape_stable"] for g in orep["generations"]]
              == [True, False], orep["generations"])
        log({"phase": "sharded_cli", "seconds": round(
            time.perf_counter() - t0, 3),
            "serve_memhd": {k: rep[k] for k in (
                "devices", "rows_per_s", "rows_per_s_per_device")},
            "serve_online": {k: orep[k] for k in (
                "devices", "model_generation", "generations",
                "recompiles_steady_state", "phases")}})

    # -- phase 17: the data-parallel fit --------------------------------------
    def fit_sharded(self):
        """``fit_sharded`` over two shards of the card against one shard,
        under exact conditions (phase 5's dyadic features, lr = 2^-4, the
        ±1 payload: every shard delta and their bfloat16 sum exact) at
        D = C = 128 and at full width: ``fp``, ``binary`` and every epoch's
        miss equal, each shard delta one ``qail_update`` launch on its int8
        route. Then at the paper's lr against ``fit(use_kernel=True)``."""
        import dataclasses
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.core import EncoderConfig, MemhdModel
        ds = self.ds
        x = torch.round(ds.train_x * 16) / 16
        n_batches = -(-ds.train_x.shape[0] // self.amc.batch_size)
        exact = []
        for width in DYADIC_WIDTHS:
            enc = EncoderConfig(kind="projection", features=784, dim=width)
            amc = dataclasses.replace(self.amc, dim=width, columns=width,
                                      lr=0.0625, epochs=DYADIC_EPOCHS,
                                      update_with="binary")
            fits = {}
            for k in (1, SHARDS):
                kernels.reset_launches()
                t0 = time.perf_counter()
                m = MemhdModel.create(0, enc, amc, device=self.dev)
                m, hist = m.fit_sharded(1, x, ds.train_y,
                                        mesh=(self.dev,) * k)
                torch.cuda.synchronize()
                n = kernels.launches()["qail_update"]
                want = k * n_batches * DYADIC_EPOCHS
                check(n == want, ("fit_sharded launches", width, k, n, want))
                routes = check_int8_routes(n, ("fit_sharded", width, k))
                fits[k] = (m.am_state, [r["train_miss"]
                                        for r in hist["curve"]],
                           time.perf_counter() - t0, n, routes)
            one, two = fits[1], fits[SHARDS]
            for key in ("fp", "binary"):
                check(torch.equal(one[0][key], two[0][key]),
                      ("fit_sharded", width, key))
            check(one[1] == two[1], ("fit_sharded miss curve", width))
            exact.append({"dim": width, "columns": width,
                          "epochs": DYADIC_EPOCHS, "fp_equal": True,
                          "binary_equal": True, "miss_equal": True,
                          "miss_curve": two[1],
                          "launches": {1: one[3], SHARDS: two[3]},
                          "qail_update_routes": two[4],
                          "fit_seconds": {1: round(one[2], 3),
                                          SHARDS: round(two[2], 3)}})
        log({"phase": "fit_sharded_exact", "shards": SHARDS, "fits": exact})

        amc = dataclasses.replace(self.amc, epochs=SHARDED_EPOCHS)
        m = MemhdModel.create(0, self.enc, amc, device=self.dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        sh, sh_hist = m.fit_sharded(1, ds.train_x, ds.train_y,
                                    mesh=(self.dev,) * SHARDS)
        torch.cuda.synchronize()
        t_sh = time.perf_counter() - t0
        n = kernels.launches()["qail_update"]
        check(n == SHARDS * n_batches * SHARDED_EPOCHS, ("launches", n))
        routes = check_int8_routes(n, "fit_sharded paper lr")
        self.fit_sharded_launches = {"qail_update": n}
        t0 = time.perf_counter()
        kf, k_hist = m.fit(1, ds.train_x, ds.train_y, use_kernel=True)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        agree = (sh.am_state["binary"] == kf.am_state["binary"]).float(
            ).mean().item()
        acc_sh = sh.score(ds.test_x, ds.test_y)
        acc_k = kf.score(ds.test_x, ds.test_y)
        check(agree >= SHARDED_AGREE, ("binary agreement", agree))
        check(abs(acc_sh - acc_k) <= SHARDED_ACC_GAP, (acc_sh, acc_k))
        check(len(sh_hist["curve"]) == SHARDED_EPOCHS, sh_hist["curve"])
        log({"phase": "fit_sharded_paper_lr", "shards": SHARDS,
             "epochs": SHARDED_EPOCHS, "lr": amc.lr,
             "binary_agreement": agree, "accuracy_sharded": acc_sh,
             "accuracy_kernel_fit": acc_k,
             "final_miss_sharded": sh_hist["curve"][-1]["train_miss"],
             "final_miss_kernel_fit": k_hist["curve"][-1]["train_miss"],
             "fit_seconds_sharded": round(t_sh, 3),
             "fit_seconds_kernel_fit": round(t_k, 3),
             "launches": n, "qail_update_routes": routes})

    # -- phase 11: the LM inference path ---------------------------------------
    def check_lm_kernels(self):
        """flash_decode and ssd_chunk against their plain versions.

        flash_decode over GQA 5x / MHA / MQA heads, S in FD_S and ragged
        lengths (S, 0, 1, S/2 + 3) per row: float32 within 3e-5 + 3e-5|x|
        (the reference's flash_decode tolerance); bfloat16 within one bf16
        ulp of the plain result + 3e-5 (both compute in float32 and round
        once; the 3e-5 covers values near 0). ssd_chunk at hymba's and
        mamba2's geometries, Q in SSD_Q, float32 and bfloat16 inputs:
        1e-4 + 1e-4|x| (tests/test_ssd_kernel.py), plus one bf16 ulp on a
        bfloat16 y; two chained chunks == one double-length chunk; a chunk
        sliced from a longer sequence (strided batch rows)."""
        np, torch = self.np, self.torch
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ref
        from repro_torch.kernels import ssd_chunk as sc
        t0 = time.perf_counter()
        cases = 0
        for h, kv, dh in FD_HEADS:
            for s in FD_S:
                rng = np.random.default_rng([15, h, kv, dh, s])
                b = 4
                q = self.t(rng.normal(size=(b, h, dh)).astype("float32"))
                k = self.t(rng.normal(size=(b, s, kv, dh)).astype("float32"))
                v = self.t(rng.normal(size=(b, s, kv, dh)).astype("float32"))
                ln = self.t(np.asarray([s, 0, min(1, s), min(s, s // 2 + 3)],
                                       np.int32))
                for dtype, cap in itertools.product(
                        (torch.float32, torch.bfloat16), (None, FD_SOFTCAP)):
                    qd, kd, vd = (a.to(dtype) for a in (q, k, v))
                    got = fd.flash_decode(qd, kd, vd, ln, softcap=cap)
                    want = ref.flash_decode(qd, kd, vd, ln, cap)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tol = (3e-5 + 3e-5 * want.float().abs()
                           if dtype == torch.float32
                           else bf16_ulp(want) + 3e-5)
                    check(bool((err <= tol).all()),
                          ("flash_decode", h, kv, dh, s, str(dtype), cap,
                           err.max().item()))
                    check(not got[1].any(), "cache_len 0 must yield 0")
                    # The per-shard partial: the same output unrounded
                    # (float32; rounded, bit for bit the output) and the
                    # LSE.
                    got2, lse = fd.flash_decode(qd, kd, vd, ln, softcap=cap,
                                                return_lse=True)
                    _, wlse = ref.flash_decode(qd, kd, vd, ln, cap,
                                               return_lse=True)
                    fin = torch.isfinite(wlse)
                    lerr = (lse - wlse)[fin].abs()
                    check(got2.dtype == torch.float32
                          and torch.equal(got2.to(dtype), got)
                          and torch.equal(fin, torch.isfinite(lse))
                          and not fin[1].any()
                          and bool((lerr <= 1e-4 + 1e-5 * wlse[fin].abs())
                                   .all()),
                          ("flash_decode lse", h, kv, dh, s, str(dtype), cap,
                           lerr.max().item() if lerr.numel() else 0.0))
                    cases += 1
        geoms = []
        for geom, (h, n, p) in SSD_GEOMS.items():
            for qlen in SSD_Q:
                args = self.ssd_inputs(np.random.default_rng([16, h, n, qlen]),
                                       2, qlen, h, n, p)
                for dtype in (torch.float32, torch.bfloat16):
                    a = [x.to(dtype) for x in args[:3]] + list(args[3:])
                    self.ssd_equal(sc.ssd_chunk(*a), ref.ssd_chunk(*a),
                                   (geom, qlen, str(dtype)))
                    cases += 1
            geoms.append(geom)
        # Two chained chunks of 128 == one chunk of 256 (kernel only), and a
        # chunk sliced out of a longer sequence.
        h, n, p = SSD_GEOMS["hymba"]
        x, bm, cm, dt, da, s0 = self.ssd_inputs(np.random.default_rng(17), 2,
                                                512, h, n, p)
        whole = sc.ssd_chunk(x[:, :256], bm[:, :256], cm[:, :256],
                             dt[:, :256], da[:, :256], s0)
        y1, s1 = sc.ssd_chunk(x[:, :128], bm[:, :128], cm[:, :128],
                              dt[:, :128], da[:, :128], s0)
        y2, s2 = sc.ssd_chunk(x[:, 128:256], bm[:, 128:256], cm[:, 128:256],
                              dt[:, 128:256], da[:, 128:256], s1)
        self.ssd_equal((torch.cat([y1, y2], 1), s2), whole, "chained")
        cut = slice(256, 512)
        sl = [t[:, cut] for t in (x, bm, cm, dt, da)] + [s0]
        self.ssd_equal(sc.ssd_chunk(*sl), ref.ssd_chunk(*sl), "strided rows")
        log({"phase": "lm_kernels_vs_plain", "ok": True, "cases": cases + 2,
             "flash_decode_heads": FD_HEADS, "flash_decode_s": FD_S,
             "flash_decode_softcaps": [None, FD_SOFTCAP],
             "ssd_geoms": SSD_GEOMS, "ssd_q": SSD_Q,
             "seconds": round(time.perf_counter() - t0, 3)})

    def ssd_inputs(self, rng, b, q, h, n, p):
        """tests/test_ssd_kernel.py's operands: x, B, C normal; dt = 0.1|z|;
        da = -dt |z'|; a normal entering state."""
        np = self.np
        nrm = rng.normal
        dt = np.abs(nrm(size=(b, q, h))).astype("float32") * 0.1
        return (self.t(nrm(size=(b, q, h, p)).astype("float32")),
                self.t(nrm(size=(b, q, h, n)).astype("float32")),
                self.t(nrm(size=(b, q, h, n)).astype("float32")),
                self.t(dt),
                self.t(-dt * np.abs(nrm(size=(b, q, h))).astype("float32")),
                self.t(nrm(size=(b, h, n, p)).astype("float32")))

    def ssd_equal(self, got, want, what):
        torch = self.torch
        torch.cuda.synchronize()
        (y, s_), (wy, ws) = got, want
        tol = 1e-4 + 1e-4 * wy.float().abs()
        if y.dtype == torch.bfloat16:
            tol = tol + bf16_ulp(wy)
        check(y.dtype == wy.dtype and s_.dtype == torch.float32, what)
        ey = (y.float() - wy.float()).abs()
        es = (s_ - ws).abs()
        check(bool((ey <= tol).all()), ("ssd_chunk y", what,
                                        ey.max().item()))
        check(bool((es <= 1e-4 + 1e-4 * ws.abs()).all()),
              ("ssd_chunk state", what, es.max().item()))

    def lm_setup(self):
        """hymba-1.5b at full width: float32 params from a seed and their
        bfloat16 cast (the published config's dtype)."""
        import dataclasses
        torch = self.torch
        from repro_torch import generator
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        cfg = get_config(LM_ARCH)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        t0 = time.perf_counter()
        p32 = T.init_params(generator(0, self.dev), cfg32, device=self.dev)
        p16 = map_tree(lambda t: t.to(torch.bfloat16), p32)
        torch.cuda.synchronize()
        self.lm = (cfg, cfg32, p16, p32)
        log({"phase": "lm_config", "arch": cfg.name,
             "param_count": cfg.param_count(), "d_model": cfg.d_model,
             "layers": cfg.n_layers, "vocab": cfg.vocab_size,
             "padded_vocab": cfg.padded_vocab,
             "init_seconds": round(time.perf_counter() - t0, 3),
             "device_bytes": torch.cuda.memory_allocated()})

    def lm_forward(self):
        """T.forward at B = 2, S = 2048: bfloat16 on the kernel path
        (counted and timed), float32 on both paths (held equal)."""
        torch = self.torch
        from repro_torch import generator
        from repro_torch.models import transformer as T
        cfg, cfg32, p16, p32 = self.lm
        b, s = LM_FORWARD
        toks = torch.randint(0, cfg.vocab_size, (b, s), device=self.dev,
                             generator=generator(3, self.dev),
                             dtype=torch.int32)
        batch = {"tokens": toks}
        with torch.inference_mode():
            T.forward(p16, cfg, batch)  # warm-up
            t0 = time.perf_counter()
            (lg16, _), launches, tiers = self.path_counts(
                lambda: T.forward(p16, cfg, batch))
            secs = time.perf_counter() - t0
            n_chunks = -(-s // cfg.blocks[0].ssm.chunk)
            want = cfg.n_layers * n_chunks
            check(launches["ssd_chunk"] == want,
                  ("ssd_chunk launches", launches["ssd_chunk"], want))
            check(tiers == {"ssd_chunk": {"cuda": want}}, tiers)
            check(lg16.shape == (b, s, cfg.padded_vocab)
                  and bool(torch.isfinite(lg16).all()), "bf16 logits")
            t1 = time.perf_counter()
            lk, _ = T.forward(p32, cfg32, batch)
            torch.cuda.synchronize()
            secs32 = time.perf_counter() - t1
            lp, _ = T.forward(p32, cfg32, batch, use_kernel=False)
            err = (lk - lp).abs().max().item()
            scale = lp.abs().max().item()
            check(err <= LM_TOL * scale, ("f32 forward kernel vs plain", err,
                                          scale))
            bf16_vs_f32 = (lg16.float() - lp).abs().max().item()
            self.profile("lm_forward_profile",
                         lambda: T.forward(p16, cfg, batch), B=b, S=s)
        self.path_launches["ssd_chunk"] = launches["ssd_chunk"]
        log({"phase": "lm_forward", "arch": cfg.name, "B": b, "S": s,
             "seconds_bf16": round(secs, 4), "seconds_f32": round(secs32, 4),
             "tokens_per_s_bf16": round(b * s / secs, 1),
             "launches": {"ssd_chunk": launches["ssd_chunk"]},
             "dispatch_tiers": tiers,
             "f32_kernel_vs_plain_max_abs": err, "f32_logit_scale": scale,
             "tolerance": LM_TOL * scale,
             "bf16_vs_f32_max_abs": bf16_vs_f32})

    def decode_logits(self, cfg, params, caches, toks, use_kernel,
                      greedy=0):
        """decode_step from ``caches`` (updated in place) over every token
        of ``toks`` (B, S), then over ``greedy`` tokens, each the argmax of
        the step before: (the tokens fed (B, S + greedy), the logits of
        every step (B, S + greedy, vocab_size))."""
        torch = self.torch
        from repro_torch.models import transformer as T
        fed, out = [], []
        for i in range(toks.shape[1] + greedy):
            cur = (toks[:, i:i + 1] if i < toks.shape[1] else
                   out[-1].argmax(-1)[:, None].to(torch.int32))
            fed.append(cur)
            lg, caches = T.decode_step(params, cfg, {"tokens": cur}, caches,
                                       use_kernel=use_kernel)
            out.append(lg[:, :cfg.vocab_size])
        return torch.cat(fed, 1), torch.stack(out, 1)

    def lm_serve(self):
        """generate at B = 4, prompt 256, gen 64: bfloat16 on the kernel
        path (counted and timed). In float32 the kernel path prefills all
        but the last prompt token; from a copy of those caches both paths
        then take the last prompt token and the 63 tokens the kernel path
        picks greedily, and must give the same logits step by step
        (LM_TOL) and the same greedy choice at every step up to the first
        whose top-2 margin is within that tolerance: by induction the
        plain path's own greedy run then emits the same tokens up to
        there. Every decode step's logits (the prefill's too) equal
        forward's at that position (2e-2 max|logits|, the reference's
        criterion for the last one)."""
        torch = self.torch
        from repro_torch import generator
        from repro_torch.kernels import ops
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        cfg, cfg32, p16, p32 = self.lm
        b, plen, gen = LM_SERVE
        prompts = torch.randint(0, cfg.vocab_size, (b, plen),
                                device=self.dev,
                                generator=generator(4, self.dev),
                                dtype=torch.int32)
        serve.generate(cfg, p16, prompts[:, :4], 4)  # warm-up
        t0 = time.perf_counter()
        out16, launches, tiers = self.path_counts(
            lambda: serve.generate(cfg, p16, prompts, gen))
        wall = time.perf_counter() - t0
        steps = plen + gen - 1
        want = cfg.n_layers * steps
        check(launches["flash_decode"] == want,
              ("flash_decode launches", launches["flash_decode"], want))
        check(tiers == {"flash_decode": {"cuda": want}}, tiers)
        check(out16.shape == (b, plen + gen)
              and bool((out16[:, plen:] < cfg.vocab_size).all()), "tokens")
        with torch.inference_mode():
            self.profile("lm_decode_profile", lambda: self.decode_logits(
                cfg, p16, T.init_cache(cfg, b, 7, device=self.dev),
                out16[:, :7], True), B=b, steps=7)
            caches = T.init_cache(cfg32, b, plen + gen, device=self.dev)
            _, l_pre = self.decode_logits(cfg32, p32, caches,
                                          prompts[:, :-1], True)
            snap = map_tree(torch.clone, caches)
            fed, lk = self.decode_logits(cfg32, p32, caches, prompts[:, -1:],
                                         True, greedy=gen - 1)
            out_k = torch.cat([prompts[:, :-1], fed,
                               lk[:, -1].argmax(-1)[:, None].to(torch.int32)],
                              1)
            _, lp = self.decode_logits(cfg32, p32, snap, fed, False)
            err = (lk - lp).abs().amax(dim=(0, 2))
            scale = lp.abs().amax(dim=(0, 2))
            bad = (err > LM_TOL * scale).nonzero().flatten().tolist()
            check(not bad, ("f32 decode kernel vs plain, gen steps", bad[:5]))
            top2 = lp.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]       # (B, gen)
            plain_pick = lp.argmax(-1)
            agree, low_margin = [], []
            for row in range(b):
                n = 0
                for j in range(gen):
                    if margin[row, j] <= LM_TOL * scale[j]:
                        low_margin.append([row, plen + j])
                        break
                    check(plain_pick[row, j] == out_k[row, plen + j],
                          ("greedy tokens differ", row, plen + j))
                    n += 1
                agree.append(n)
            lf, _ = T.forward(p32, cfg32, {"tokens": out_k[:, :-1]})
            lf = lf[..., :cfg.vocab_size]
            dd = (torch.cat([l_pre, lk], 1) - lf).abs().amax(dim=(0, 2))
            fscale = lf.abs().max().item()
            check(dd.max().item() < 2e-2 * fscale,
                  ("decode != forward", dd.max().item(), fscale))
        self.path_launches["flash_decode"] = launches["flash_decode"]
        log({"phase": "lm_serve", "arch": cfg.name, "B": b,
             "prompt": plen, "gen": gen, "wall_s_bf16": round(wall, 4),
             "tok_per_s_bf16": round(b * (plen + gen) / wall, 1),
             "ms_per_decode_step_bf16": round(wall * 1e3 / steps, 3),
             "launches": {"flash_decode": launches["flash_decode"]},
             "dispatch_tiers": tiers,
             "f32_kernel_vs_plain_steps": gen,
             "f32_kernel_vs_plain_max_abs": err.max().item(),
             "f32_tolerance_min": (LM_TOL * scale).min().item(),
             "greedy_tokens_equal_per_row": agree,
             "first_low_margin_step": low_margin,
             "bf16_tokens_equal_f32": bool(torch.equal(out16, out_k)),
             "decode_vs_forward_steps": steps,
             "decode_vs_forward_max_abs": dd.max().item(),
             "decode_vs_forward_last_step": dd[-1].item(),
             "forward_logit_scale": fscale})
        del self.lm, p16, p32, caches, snap
        torch.cuda.empty_cache()
        # The plain-path runs above count torch-ref dispatches; later
        # phases read the dispatch counter of their own runs.
        self.note_batches()
        ops.reset_dispatch()

    def lm_cli(self):
        """The LM serving CLI as a subprocess at the reference's default
        model (mamba2-130m, full width)."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        args = ["--arch", "mamba2-130m", "--batch", "4", "--prompt-len",
                "32", "--gen", "32"]
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            *args], env=env, capture_output=True, text=True,
                           timeout=600)
        check(p.returncode == 0, p.stderr[-2000:])
        rep = json.loads(p.stdout)
        check(rep["arch"] == "mamba2-130m" and rep["tokens_total"] == 256
              and rep["device"].startswith("cuda"), rep)
        log({"phase": "lm_cli", "args": args,
             "seconds": round(time.perf_counter() - t0, 3), **rep})

    # -- phase group lm_families -------------------------------------------
    def lm_model(self, arch, depth=None, dtype="bfloat16", seed=10,
                 act=None, **kw):
        """(cfg, params, init seconds): ``arch`` at full width from a
        seed, each block group cut to ``depth`` layers when given, in
        ``dtype`` (params drawn in it leaf by leaf) with ``act``
        activations (default ``dtype``)."""
        import dataclasses
        torch = self.torch
        from repro_torch import generator
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, blocks=tuple(
                dataclasses.replace(b, repeat=n)
                for b, n in zip(cfg.blocks, depth)))
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  activation_dtype=act or dtype, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init_params(generator(seed, self.dev), cfg,
                               device=self.dev)
        torch.cuda.synchronize()
        return cfg, params, time.perf_counter() - t0

    def model_log(self, cfg, full, init_s):
        torch = self.torch
        return {"arch": full, "d_model": cfg.d_model,
                "layers": cfg.n_layers,
                "full_layers": self.full_cfg(full).n_layers,
                "param_count": cfg.param_count(), "dtype": cfg.param_dtype,
                "init_seconds": round(init_s, 3),
                "device_bytes": torch.cuda.memory_allocated()}

    def free(self):
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def tf_decode(self, cfg, params, steps, use_kernel=True, max_len=None):
        """decode_step over ``steps`` (a list of batches) from fresh caches:
        the (B, steps, ...) logits."""
        torch = self.torch
        from repro_torch.models import transformer as T
        b = next(iter(steps[0].values())).shape[0]
        caches = T.init_cache(cfg, b, max_len or len(steps), device=self.dev)
        out = []
        for sb in steps:
            lg, caches = T.decode_step(params, cfg, sb, caches,
                                       use_kernel=use_kernel)
            out.append(lg)
        return torch.stack(out, 1)

    def token_steps(self, cfg, b, s, seed):
        torch = self.torch
        from repro_torch import generator
        toks = torch.randint(0, cfg.vocab_size, (b, s), device=self.dev,
                             generator=generator(seed, self.dev),
                             dtype=torch.int32)
        return toks, [{"tokens": toks[:, i:i + 1]} for i in range(s)]

    def moe_inputs(self, shape, seed):
        """MoE layer inputs on a 2^-4 grid in [-2, 2]: normal draws plus a
        normal vector shared by every token, which gives each expert a
        router-logit offset of its own, so the load is skewed and the
        busiest experts overflow the capacity-factor bound."""
        np = self.np
        rng = np.random.default_rng(seed)
        x = rng.normal(size=shape) + rng.normal(size=shape[-1:])
        return self.t(np.clip(np.round(x * 16) / 16, -2, 2)
                      .astype("float32"))

    def lm_deepseek_f32(self):
        """deepseek-v2-lite-16b at full width in float32, cut to 1 dense +
        2 MoE layers: teacher-forced decode_step (the absorbed MLA over the
        latent cache) == forward (the materialized MLA) at every position
        within LM_TOL; one MoE layer == each token through its chosen
        experts, expert by expert, at T tokens under the dropless limit;
        above it (capacity-dropping) == the same routine on the CPU."""
        torch = self.torch
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        cfg, params, init_s = self.lm_model(DS_ARCH, DS_F32_DEPTH,
                                            "float32", seed=10)
        b, s = 2, DS_F32_S
        toks, steps = self.token_steps(cfg, b, s, 11)
        with torch.inference_mode():
            fwd, aux = T.forward(params, cfg, {"tokens": toks})
            dec = self.tf_decode(cfg, params, steps)
            err = (dec - fwd).abs().amax(dim=(0, 2))
            scale = fwd.abs().max().item()
            check(err.max().item() <= LM_TOL * scale,
                  ("deepseek f32 decode != forward", err.max().item(),
                   scale))
            check(aux["expert_counts_g1"].sum().item()
                  == 2 * b * s * cfg.blocks[1].ffn.top_k, aux.keys())
            spec = cfg.blocks[1].ffn
            lp = T._layer(params["groups"][1], 0)["ffn"]
            moe = {}
            for tokens in DS_MOE_TOKENS:
                x = self.moe_inputs((1, tokens, cfg.d_model), [12, tokens])
                y, maux = L.moe_ffn(lp, spec, x)
                cap = L.moe_capacity(tokens, spec)
                counts = maux["expert_counts"]
                dropped = int(torch.clamp_min(counts - cap, 0).sum())
                if tokens * spec.top_k <= 4096:
                    want = self.moe_per_token(lp, spec, x)
                    where = "per-expert loop"
                    check(dropped == 0, ("dropless", dropped))
                else:
                    cpu = {k: v.cpu() for k, v in lp.items()}
                    want, caux = L.moe_ffn(cpu, spec, x.cpu())
                    want = want.to(self.dev)
                    where = "cpu"
                    check(torch.equal(caux["expert_counts"],
                                      counts.cpu()), "expert counts")
                    check(dropped > 0, ("capacity regime drops", dropped))
                e_moe = (y - want).abs().max().item()
                s_moe = want.abs().max().item()
                check(e_moe <= LM_TOL * s_moe,
                      ("moe", tokens, where, e_moe, s_moe))
                moe[tokens] = {"against": where, "capacity": cap,
                               "dropped_slots": dropped,
                               "max_abs": e_moe, "scale": s_moe}
        log({"phase": "lm_deepseek_f32",
             **self.model_log(cfg, DS_ARCH, init_s),
             "depth_cut": {"dense": DS_F32_DEPTH[0], "moe": DS_F32_DEPTH[1],
                           "from": [b.repeat for b in
                                    self.full_cfg(DS_ARCH).blocks]},
             "B": b, "S": s, "decode_vs_forward_max_abs": err.max().item(),
             "forward_logit_scale": scale, "tolerance": LM_TOL * scale,
             "moe_layer": moe,
             "seconds": round(time.perf_counter() - t0, 3)})
        del params, fwd, dec, lp
        self.free()

    @staticmethod
    def full_cfg(arch):
        from repro_torch.configs import get_config
        return get_config(arch)

    def moe_per_token(self, lp, spec, x):
        """The MoE layer written plainly: each token's top-k experts (the
        router's float32 softmax, ties to the lower expert), their
        normalized weights, each expert run on the tokens that chose it,
        the shared experts added; no sort, no capacity."""
        torch = self.torch
        import torch.nn.functional as F
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        scores = torch.softmax(xt.float() @ lp["router"], dim=-1)
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        w = vals[:, :spec.top_k]
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        top = idx[:, :spec.top_k]
        contrib = torch.zeros((xt.shape[0], spec.top_k, d), device=x.device,
                              dtype=x.dtype)
        for e in range(spec.n_experts):
            tok, slot = (top == e).nonzero(as_tuple=True)
            if tok.numel():
                h = (F.silu(xt[tok] @ lp["w_gate"][e])
                     * (xt[tok] @ lp["w_up"][e]))
                contrib[tok, slot] = (h @ lp["w_down"][e]) * w[tok, slot,
                                                                None]
        y = contrib.sum(1)
        if spec.n_shared:
            y = y + (F.silu(xt @ lp["ws_gate"]) * (xt @ lp["ws_up"])
                     ) @ lp["ws_down"]
        return y.reshape(x.shape)

    def lm_deepseek_serve(self):
        """deepseek-v2-lite-16b at full width and depth. In bfloat16 (params
        drawn in bf16 leaf by leaf): generate at B 4, prompt 32, gen 32
        (timed after a warm-up), decode and forward under the profiler,
        T.forward at B 2 x S 256 (dropless) timed. Then in float32 (62.8
        GB; the bf16 params freed first): T.forward at B 2 x S 256, whose
        last position == the prefill's last decode step within SERVE_TOL *
        max|logits|, the reference's float32 bound. In bfloat16 the two
        part at this depth for the reference too: the expert weights' std
        1/sqrt(E) makes routed outputs dominate the residual, and bf16
        rounding flips expert choices that compound over 26 MoE layers
        (the reference's own bf16 decode vs forward at the smoke width:
        0.020, 0.059, 0.61 of max|logit| at 2, 8, 26 MoE layers)."""
        torch = self.torch
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(DS_ARCH, seed=13)
        init_bytes = torch.cuda.memory_allocated()
        b, plen, gen = DS_SERVE
        prompts, _ = self.token_steps(cfg, b, plen, 14)
        serve.generate(cfg, params, prompts[:, :4], 2)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = serve.generate(cfg, params, prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        steps = plen + gen - 1
        check(out.shape == (b, plen + gen)
              and bool((out[:, plen:] < cfg.vocab_size).all()), "tokens")
        fb, fs = DS_FORWARD
        toks, fsteps = self.token_steps(cfg, fb, fs, 15)
        with torch.inference_mode():
            self.profile("lm_deepseek_decode_profile", lambda: self.tf_decode(
                cfg, params, [{"tokens": out[:, i:i + 1]}
                              for i in range(4)]), B=b, steps=4)
            fwd, _ = T.forward(params, cfg, {"tokens": toks})  # warm-up
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fwd, aux = T.forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t2
            check(bool(torch.isfinite(fwd).all()), "finite bf16 logits")
            self.profile("lm_deepseek_forward_profile",
                         lambda: T.forward(params, cfg, {"tokens": toks}),
                         B=fb, S=fs)
        peak16 = torch.cuda.max_memory_allocated()
        del params, fwd, aux
        self.free()
        torch.cuda.reset_peak_memory_stats()
        cfg32, p32, init32_s = self.lm_model(DS_ARCH, dtype="float32",
                                             seed=13)
        with torch.inference_mode():
            fwd, _ = T.forward(p32, cfg32, {"tokens": toks})
            dec = self.tf_decode(cfg32, p32, fsteps)
            last = fwd[:, -1]
            err = (dec[:, -1] - last).abs().max().item()
            scale = last.abs().max().item()
            check(err < SERVE_TOL * scale,
                  ("deepseek f32 decode != forward", err, scale))
        log({"phase": "lm_deepseek_serve",
             **self.model_log(cfg, DS_ARCH, init_s),
             "param_bytes": init_bytes, "B": b, "prompt": plen, "gen": gen,
             "wall_s_bf16": round(wall, 4),
             "tok_per_s_bf16": round(b * (plen + gen) / wall, 1),
             "ms_per_decode_step_bf16": round(wall * 1e3 / steps, 3),
             "forward_bf16": {"B": fb, "S": fs, "seconds": round(fwd_s, 4),
                              "tok_per_s": round(fb * fs / fwd_s, 1),
                              "routed_slots":
                                  fb * fs * cfg.blocks[1].ffn.top_k},
             "peak_bytes_bf16": peak16,
             "f32": {"init_seconds": round(init32_s, 3),
                     "param_bytes": sum(v.numel() * v.element_size()
                                        for v in self.leaves(p32)),
                     "decode_vs_forward_last_max_abs": err,
                     "forward_logit_scale": scale,
                     "tolerance": SERVE_TOL * scale,
                     "peak_bytes": torch.cuda.max_memory_allocated()},
             "seconds": round(time.perf_counter() - t0, 3)})
        del p32, fwd, dec
        self.free()

    def lm_deepseek_v3(self):
        """deepseek-v3-671b at full width (q-LoRA MLA, 128 heads, 256
        experts, sigmoid router with bias), cut to 1 dense + 1 MoE layer
        plus the MTP block's params, bfloat16: V3_STEPS decode steps ==
        T.forward at B 2 x S 64 at those positions within SERVE_TOL."""
        torch = self.torch
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(V3_ARCH, V3_DEPTH, seed=16)
        init_peak = torch.cuda.max_memory_allocated()
        fb, fs = V3_FORWARD
        toks, steps = self.token_steps(cfg, fb, fs, 17)
        with torch.inference_mode():
            t1 = time.perf_counter()
            dec = self.tf_decode(cfg, params, steps[:V3_STEPS])
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t1
            t2 = time.perf_counter()
            fwd, aux = T.forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t2
            ref = fwd[:, :V3_STEPS].float()
            err = (dec.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(bool(torch.isfinite(fwd).all()), "finite logits")
            check(err < SERVE_TOL * scale,
                  ("deepseek-v3 decode != forward", err, scale))
            check("expert_counts_g1" in aux and "lb_loss" not in aux,
                  sorted(aux))
        log({"phase": "lm_deepseek_v3",
             **self.model_log(cfg, V3_ARCH, init_s),
             "depth_cut": {"dense": V3_DEPTH[0], "moe": V3_DEPTH[1],
                           "mtp_block": True,
                           "from": [b.repeat for b in
                                    self.full_cfg(V3_ARCH).blocks]},
             "param_bytes": sum(v.numel() * v.element_size()
                                for v in self.leaves(params)),
             "init_peak_bytes": init_peak,
             "decode_steps": V3_STEPS, "ms_per_decode_step":
                 round(dec_s * 1e3 / V3_STEPS, 3),
             "forward": {"B": fb, "S": fs, "seconds": round(fwd_s, 4)},
             "decode_vs_forward_max_abs": err, "forward_logit_scale": scale,
             "tolerance": SERVE_TOL * scale,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "seconds": round(time.perf_counter() - t0, 3)})
        del params, fwd, dec, aux
        self.free()

    def leaves(self, tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from self.leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from self.leaves(v)
        else:
            yield tree

    def lm_modalities(self):
        """musicgen-medium (frame embeds, 64 conditioning tokens, 4
        codebooks) and internvl2-2b (256 patches ahead of the text) at full
        width and depth: float32 decode steps on the kernel path (counts
        zeroed just before and read just after: layers x steps
        flash_decode launches, all on the cuda tier) == the plain path
        within LM_TOL; musicgen's last decode step == forward's last
        position (LM_TOL); internvl2's forward over patches + text; then
        bfloat16 decode steps timed."""
        import dataclasses
        torch = self.torch
        from repro_torch import generator
        from repro_torch.models import transformer as T
        for arch in ("musicgen-medium", "internvl2-2b"):
            t0 = time.perf_counter()
            cfg, p32, init_s = self.lm_model(arch, dtype="float32", seed=18)
            b, n = MODALITY_B, MODALITY_STEPS
            gen = generator(19, self.dev)
            if cfg.frontend == "audio_frames":
                frames = torch.randn((b, n, cfg.d_model), generator=gen,
                                     device=self.dev)
                cond = torch.randn((b, cfg.n_cond_tokens, cfg.d_model),
                                   generator=gen, device=self.dev)
                batch = {"frame_embeds": frames, "cond_embeds": cond}
                steps = [{"frame_embeds": frames[:, i:i + 1],
                          "cond_embeds": cond} for i in range(n)]
            else:
                toks, steps = self.token_steps(cfg, b, VLM_TEXT, 20)
                steps = steps[:n]
                batch = {"tokens": toks, "patch_feats": torch.randn(
                    (b, cfg.n_patches, T.VIT_DIM), generator=gen,
                    device=self.dev)}
            with torch.inference_mode():
                dk, launches, tiers = self.path_counts(
                    lambda: self.tf_decode(cfg, p32, steps))
                want = cfg.n_layers * n
                check(launches["flash_decode"] == want,
                      (arch, "flash_decode launches",
                       launches["flash_decode"], want))
                check(tiers == {"flash_decode": {"cuda": want}}, tiers)
                dp = self.tf_decode(cfg, p32, steps, use_kernel=False)
                err = (dk - dp).abs().max().item()
                scale = dp.abs().max().item()
                check(err <= LM_TOL * scale, (arch, "f32 decode kernel vs "
                                              "plain", err, scale))
                fwd, _ = T.forward(p32, cfg, batch)
                check(bool(torch.isfinite(fwd).all()), (arch, "forward"))
                extra = {"forward_shape": list(fwd.shape)}
                if cfg.frontend == "audio_frames":
                    fe = (dk[:, -1] - fwd[:, -1]).abs().max().item()
                    fsc = fwd[:, -1].abs().max().item()
                    check(fe <= LM_TOL * fsc,
                          (arch, "decode != forward", fe, fsc))
                    extra.update(decode_vs_forward_last_max_abs=fe,
                                 forward_last_scale=fsc)
                p16 = map_tree(lambda v: v.to(torch.bfloat16), p32)
                del p32
                self.free()
                c16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                          activation_dtype="bfloat16")
                s16 = [{k: v.to(torch.bfloat16) if v.is_floating_point()
                        else v for k, v in sb.items()} for sb in steps]
                self.tf_decode(c16, p16, s16[:2])  # warm-up
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, l16, _ = self.path_counts(
                    lambda: self.tf_decode(c16, p16, s16))
                ms16 = (time.perf_counter() - t1) * 1e3 / n
            self.families_launches[arch] = (launches["flash_decode"]
                                            + l16["flash_decode"])
            log({"phase": "lm_modalities", **self.model_log(cfg, arch,
                                                            init_s),
                 "B": b, "decode_steps": n,
                 "launches": {"flash_decode": launches["flash_decode"]},
                 "dispatch_tiers": tiers,
                 "f32_kernel_vs_plain_max_abs": err, "f32_scale": scale,
                 "tolerance": LM_TOL * scale,
                 "ms_per_decode_step_bf16": round(ms16, 3),
                 "launches_bf16": {"flash_decode": l16["flash_decode"]},
                 **extra, "seconds": round(time.perf_counter() - t0, 3)})
            del p16, dk, dp, fwd
            self.free()

    def lm_quant(self):
        """qwen1.5-32b at full width cut to QUANT_LAYERS layers, bfloat16,
        with the int8 KV cache: teacher-forced decode over S == the
        bf16-cache decode of the same params within QUANT_TOL *
        max|logits| at every step; the caches' bytes."""
        import dataclasses
        torch = self.torch
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        cfg, params, init_s = self.lm_model(QUANT_ARCH, (QUANT_LAYERS,),
                                            seed=21)
        cfgq = dataclasses.replace(cfg, kv_cache_quant=True)
        b, s = QUANT_DECODE
        _, steps = self.token_steps(cfg, b, s, 22)
        with torch.inference_mode():
            t1 = time.perf_counter()
            dq = self.tf_decode(cfgq, params, steps)
            torch.cuda.synchronize()
            q_s = time.perf_counter() - t1
            t2 = time.perf_counter()
            df = self.tf_decode(cfg, params, steps)
            torch.cuda.synchronize()
            f_s = time.perf_counter() - t2
            err = (dq.float() - df.float()).abs().amax(dim=(0, 2))
            scale = df.float().abs().amax(dim=(0, 2))
            bad = (err > QUANT_TOL * scale).nonzero().flatten().tolist()
            check(not bad, ("int8 cache decode vs bf16 cache", bad[:5]))

        def cache_bytes(c):
            return sum(v.numel() * v.element_size() for g in c
                       for layer in g for v in layer["attn"].values())
        qb = cache_bytes(T.init_cache(cfgq, b, s, device=self.dev))
        fb = cache_bytes(T.init_cache(cfg, b, s, device=self.dev))
        log({"phase": "lm_quant", **self.model_log(cfg, QUANT_ARCH, init_s),
             "depth_cut": {"layers": QUANT_LAYERS,
                           "from": self.full_cfg(QUANT_ARCH).n_layers},
             "B": b, "S": s,
             "max_rel_err": (err / scale).max().item(),
             "tolerance_rel": QUANT_TOL,
             "ms_per_decode_step_int8_cache": round(q_s * 1e3 / s, 3),
             "ms_per_decode_step_bf16_cache": round(f_s * 1e3 / s, 3),
             "cache_bytes_int8": qb, "cache_bytes_bf16": fb,
             "cache_ratio": round(fb / qb, 4),
             "seconds": round(time.perf_counter() - t0, 3)})
        del params, dq, df
        self.free()

    # -- phase group lm_train ------------------------------------------------
    def lm_batch(self, cfg, seq_len, batch, position=0):
        """The LM pipeline's batch ``position`` (seed 0) on the card."""
        from repro_torch.data.lm import LmDataConfig, PipelineState
        from repro_torch.data.lm import next_batch
        st = PipelineState(0)
        dcfg = LmDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=batch)
        for _ in range(position + 1):
            b, st = next_batch(dcfg, st)
        return {k: self.t(v) for k, v in b.items()}

    def paths(self, tree, prefix=""):
        """The leaf paths of a param tree, in ``tree_leaves`` order."""
        if isinstance(tree, dict):
            return [p for k in tree for p in self.paths(tree[k],
                                                        f"{prefix}/{k}")]
        if isinstance(tree, list):
            return [p for i, v in enumerate(tree)
                    for p in self.paths(v, f"{prefix}/{i}")]
        return [prefix.lstrip("/")]

    def moved(self, before, after):
        """The share of each leaf's elements that training changed (the
        trees walked by key: a restored tree has its keys sorted)."""
        from repro_torch.optim.adamw import tree_leaves, tree_map
        shares = tree_map(lambda a, b: (a != b).float().mean().item(),
                          before, after)
        return dict(zip(self.paths(before), tree_leaves(shares)))

    def lm_train_mamba2(self):
        """``repro_torch.launch.train.run`` on mamba2-130m at full width
        and depth: TRAIN_STEPS steps, finite losses, every SSD chunk on
        the kernel (launches counted over the run, the remat recompute
        included), the params moved (the last checkpoint against the
        seed's init)."""
        import math
        torch = self.torch
        from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.distributed.steps import init_train_state
        from repro_torch.launch import train
        from repro_torch.optim import AdamWConfig
        mcfg = get_config(TRAIN_ARCH)
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            cfg = train.TrainRunConfig(arch=TRAIN_ARCH, smoke=False,
                                       steps=TRAIN_STEPS, log_every=1,
                                       ckpt_dir=tmp, device="cuda")
            check((cfg.seq_len, cfg.global_batch) == (256, 8),
                  "the trainer's defaults are seq 256, batch 8")
            t0 = time.perf_counter()
            out, launches, tiers = self.path_counts(lambda: train.run(cfg))
            secs = time.perf_counter() - t0
            with open(os.path.join(tmp, "events.jsonl")) as f:
                events = [json.loads(ln) for ln in f]
            p0, o0 = init_train_state(cfg.seed, mcfg, AdamWConfig(lr=cfg.lr),
                                      device=self.dev)
            step, tree, _ = CheckpointManager(CheckpointConfig(tmp)).restore(
                {"params": p0, "opt": o0})
        steps = [e for e in events if e["event"] == "step"]
        check(len(steps) == TRAIN_STEPS
              and all(math.isfinite(e["loss"]) for e in steps), steps)
        chunks = -(-cfg.seq_len // mcfg.blocks[0].ssm.chunk)
        want = TRAIN_STEPS * mcfg.n_layers * chunks * (2 if mcfg.remat
                                                       else 1)
        check(launches["ssd_chunk"] == want > 0,
              ("ssd_chunk launches on the train path", launches, want))
        check(tiers == {"ssd_chunk": {"cuda": want}}, tiers)
        check(step == TRAIN_STEPS and out["steps_run"] == TRAIN_STEPS,
              (step, out))
        moved = self.moved(p0, tree["params"])
        check(moved["embed"] > 0 and moved["groups/0/ssm/w_in"] > 0
              and moved["groups/0/ssm/w_out"] > 0, moved)
        self.train_launches_lm = launches["ssd_chunk"]
        timed = steps[1:]  # step 1 carries the first call's set-up
        log({"phase": "lm_train", "arch": TRAIN_ARCH,
             "param_count": mcfg.param_count(), "layers": mcfg.n_layers,
             "d_model": mcfg.d_model, "vocab": mcfg.vocab_size,
             "dtype": mcfg.param_dtype, "chunk": mcfg.blocks[0].ssm.chunk,
             "remat": mcfg.remat, "seq_len": cfg.seq_len,
             "global_batch": cfg.global_batch, "steps": TRAIN_STEPS,
             "per_step": [{"step": e["step"], "loss": e["loss"],
                           "ms": round(e["dur_s"] * 1e3, 2),
                           "tokens_per_s": e["tokens_per_sec"]}
                          for e in steps],
             "ms_per_step_after_first": round(statistics.mean(
                 e["dur_s"] for e in timed) * 1e3, 2),
             "tokens_per_s_after_first": round(statistics.mean(
                 e["tokens_per_sec"] for e in timed), 1),
             "checkpoint_s": [e["dur_s"] for e in events
                              if e["event"] == "checkpoint"],
             "launches": {"ssd_chunk": launches["ssd_chunk"]},
             "dispatch_tiers": tiers,
             "moved_share": {k: round(v, 4) for k, v in moved.items()},
             "first_loss": out["first_loss"], "last_loss": out["last_loss"],
             "run_seconds": round(secs, 3)})
        del p0, o0, tree
        self.free()

    def lm_train_grads(self):
        """At the trainer's width and batch 0: the step-0 gradient's global
        norm (bf16, as the trainer starts), and in float32 the kernel
        route's loss and gradient against the plain route's; then one
        bf16 train step under torch.profiler."""
        import dataclasses
        import math
        torch = self.torch
        from repro_torch import generator
        from repro_torch.configs import get_config
        from repro_torch.distributed.steps import (
            init_train_state, loss_and_grads, make_train_step,
        )
        from repro_torch.models import transformer as T
        from repro_torch.optim import AdamWConfig, ScheduleConfig
        from repro_torch.optim import make_schedule
        from repro_torch.optim.adamw import _global_norm, tree_leaves
        cfg = get_config(TRAIN_ARCH)
        batch = self.lm_batch(cfg, 256, 8)
        p16, o16 = init_train_state(0, cfg, AdamWConfig(), device=self.dev)
        loss16, _, g16 = loss_and_grads(p16, cfg, batch)
        gnorm = _global_norm(g16).item()
        check(math.isfinite(gnorm) and math.isfinite(loss16.item()),
              ("step-0 grad norm", gnorm, loss16.item()))
        del g16
        step_fn = make_train_step(cfg, AdamWConfig(), make_schedule(
            ScheduleConfig(warmup_steps=20, total_steps=TRAIN_STEPS)))
        step_fn(p16, o16, batch, 1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _, m = step_fn(p16, o16, batch, 1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        self.profile("lm_train_profile",
                     lambda: step_fn(p16, o16, batch, 1), arch=TRAIN_ARCH,
                     B=8, S=256, dtype="bfloat16")
        del p16, o16, new
        self.free()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        p32 = T.init_params(generator(0, self.dev), cfg32, device=self.dev)
        lk, _, gk = loss_and_grads(p32, cfg32, batch)
        lp, _, gp = loss_and_grads(p32, cfg32, batch, use_kernel=False)
        check(abs(lk.item() - lp.item()) <= LM_TOL * abs(lp.item()),
              ("f32 loss kernel vs plain", lk.item(), lp.item()))
        worst, where = 0.0, None
        for i, (a, b) in enumerate(zip(tree_leaves(gk), tree_leaves(gp))):
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                   ).item()
            check(rel <= TRAIN_GRAD_TOL, ("f32 grad leaf", i, rel))
            if rel >= worst:
                worst, where = rel, i
        names = self.paths(p32)
        # The plain route above is a comparison, not a path: clear its
        # dispatches so that later phases' reports count their own.
        from repro_torch.kernels import ops
        self.note_batches()
        ops.reset_dispatch()
        log({"phase": "lm_train_grads", "arch": TRAIN_ARCH, "B": 8, "S": 256,
             "step0_grad_norm_bf16": gnorm, "step0_loss_bf16": loss16.item(),
             "bf16_step_ms": round(step_s * 1e3, 3),
             "bf16_step_tokens_per_s": round(8 * 256 / step_s, 1),
             "f32_loss_kernel": lk.item(), "f32_loss_plain": lp.item(),
             "f32_grad_worst_leaf": names[where],
             "f32_grad_worst_rel": worst,
             "tolerance_rel": TRAIN_GRAD_TOL,
             "f32_grad_norm": _global_norm(gk).item()})
        del p32, gk, gp
        self.free()

    def lm_train_family(self, arch, depth, seed):
        """TRAIN_FAMILY_STEPS train steps at full width (bfloat16, the
        trainer's schedule and batch): finite losses; the step-0 gradient
        for the checks of the caller. Returns (cfg, params before, params
        after, metrics of each step, step-0 grads)."""
        import math
        from repro_torch.distributed.steps import (
            loss_and_grads, make_train_step,
        )
        from repro_torch.optim import AdamWConfig, ScheduleConfig
        from repro_torch.optim import adamw_init, make_schedule
        cfg, params, init_s = self.lm_model(arch, depth, seed=seed)
        batch = self.lm_batch(cfg, 256, 8)
        _, m0, grads = loss_and_grads(params, cfg, batch)
        step_fn = make_train_step(cfg, AdamWConfig(), make_schedule(
            ScheduleConfig(warmup_steps=20, total_steps=100)))
        p, opt, metrics = params, adamw_init(params, AdamWConfig()), []
        t0 = time.perf_counter()
        for i in range(TRAIN_FAMILY_STEPS):
            p, opt, m = step_fn(p, opt, self.lm_batch(cfg, 256, 8, i), i)
            metrics.append({k: float(v) for k, v in m.items()})
        self.torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(all(math.isfinite(m["loss"]) for m in metrics), metrics)
        return cfg, params, p, metrics, m0, grads, init_s, secs

    def lm_train_hymba(self):
        cfg, before, after, metrics, _, grads, init_s, secs = \
            self.lm_train_family("hymba-1.5b", None, 20)
        moved = self.moved(before, after)
        g = grads["groups"][0]
        check(g["attn"]["wq"].abs().max().item() > 0
              and g["ssm"]["w_in"].abs().max().item() > 0,
              "hymba: attention and SSM gradients")
        check(moved["groups/0/attn/wq"] > 0 and moved["groups/0/ssm/w_in"] > 0,
              ("hymba: attention and SSM trained", moved))
        log({"phase": "lm_train_hymba", **self.model_log(cfg, "hymba-1.5b",
                                                         init_s),
             "B": 8, "S": 256, "steps": metrics,
             "seconds_steps": round(secs, 3),
             "moved_share": {k: round(v, 4) for k, v in moved.items()
                             if k.endswith(("attn/wq", "ssm/w_in", "embed"))},
             "peak_bytes": self.torch.cuda.max_memory_allocated()})
        del before, after, grads
        self.free()

    def lm_train_deepseek(self):
        import math
        cfg, before, after, metrics, m0, grads, init_s, secs = \
            self.lm_train_family(DS_ARCH, TRAIN_DS_DEPTH, 21)
        routed = {k: grads["groups"][1]["ffn"][k].abs().max().item()
                  for k in ("w_gate", "w_up", "w_down")}
        check(all(v > 0 for v in routed.values()), routed)
        lb = [m["lb_loss"] for m in metrics]
        check(all(math.isfinite(v) and v > 0 for v in lb), lb)
        moved = self.moved(before, after)
        check(moved["groups/1/ffn/w_gate"] > 0, moved)
        log({"phase": "lm_train_deepseek",
             **self.model_log(cfg, DS_ARCH, init_s),
             "depth_cut": {"dense": TRAIN_DS_DEPTH[0],
                           "moe": TRAIN_DS_DEPTH[1],
                           "from": [b.repeat for b in
                                    self.full_cfg(DS_ARCH).blocks]},
             "B": 8, "S": 256, "steps": metrics,
             "step0_lb_loss": float(m0["lb_loss"]),
             "routed_grad_max": routed, "seconds_steps": round(secs, 3),
             "peak_bytes": self.torch.cuda.max_memory_allocated()})
        del before, after, grads
        self.free()

    def lm_train_v3(self):
        """deepseek-v3's smoke config, one step from a zero AdamW state at
        step 0 (lr 0): only the aux-free update moves the router bias, by
        exactly +-0.001 (0 where a count is the mean); the MTP loss is in
        the metrics."""
        torch = self.torch
        from repro_torch import generator
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.steps import (
            BIAS_UPDATE_RATE, loss_and_grads, make_train_step,
        )
        from repro_torch.models import transformer as T
        from repro_torch.optim import AdamWConfig, ScheduleConfig
        from repro_torch.optim import adamw_init, make_schedule
        cfg = get_smoke_config(V3_ARCH)
        params = T.init_params(generator(22, self.dev), cfg, device=self.dev)
        batch = self.lm_batch(cfg, 64, 2)
        _, m0, _ = loss_and_grads(params, cfg, batch)
        counts = m0["expert_counts_g1"]
        step_fn = make_train_step(cfg, AdamWConfig(), make_schedule(
            ScheduleConfig(warmup_steps=20, total_steps=100)))
        new, _, m = step_fn(params, adamw_init(params, AdamWConfig()),
                            batch, 0)
        bias = new["groups"][1]["ffn"]["router_bias"]
        delta = bias - params["groups"][1]["ffn"]["router_bias"]
        want = BIAS_UPDATE_RATE * torch.sign(counts.mean() - counts)
        check(torch.equal(delta, want.expand_as(delta)),
              ("router_bias delta", delta.tolist(), counts.tolist()))
        check(bool((delta.abs() == BIAS_UPDATE_RATE).any()), delta.tolist())
        check("mtp_loss" in m and float(m["mtp_loss"]) > 0, sorted(m))
        log({"phase": "lm_train_v3", "arch": cfg.name,
             "router_bias_delta": delta[0].tolist(),
             "expert_counts": counts.tolist(),
             "metrics": {k: float(v) for k, v in m.items()}})

    def lm_train_resume(self):
        """The LM trainer CLI on the card at the smoke config: killed at
        step 12, resumed (from step 10), and run clean (beside the other
        two); the last losses within RESUME_TOL. On a miss, the output
        names the step of the first per-step divergence between two
        identical gradient evaluations, where a non-deterministic CUDA op
        shows."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            def cmd(name, *extra):
                return [sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", TRAIN_ARCH, *TRAIN_RESUME, "--device",
                        "cuda", "--ckpt-dir", os.path.join(tmp, name),
                        *extra]

            def run(name, *extra):
                return subprocess.run(cmd(name, *extra), env=env,
                                      capture_output=True, text=True,
                                      timeout=300)

            def result(p):
                check(p.returncode == 0, p.stderr[-2000:])
                return json.loads(p.stdout[p.stdout.index("{"):])

            # The clean run's output goes to files: a pipe left unread
            # while the other two run could fill and stall it.
            outs = [os.path.join(tmp, f"clean.{k}") for k in ("out", "err")]
            with open(outs[0], "w") as so, open(outs[1], "w") as se:
                clean_proc = subprocess.Popen(cmd("clean"), env=env,
                                              stdout=so, stderr=se)
            try:
                crash = run("crash", "--fail-at-step", "12")
                check(crash.returncode == 42,
                      ("crash exit", crash.returncode, crash.stderr[-2000:]))
                resumed = result(run("crash"))
                clean_proc.wait(timeout=300)
            finally:
                if clean_proc.poll() is None:
                    clean_proc.kill()
                    clean_proc.wait()
            texts = []
            for f in outs:
                with open(f) as fh:
                    texts.append(fh.read())
            clean = result(subprocess.CompletedProcess(
                clean_proc.args, clean_proc.returncode, *texts))
        check(resumed["resumed_from"] == 10, resumed)
        gap = abs(resumed["last_loss"] - clean["last_loss"])
        if gap >= RESUME_TOL:
            check(False, ("resumed vs clean last loss", gap,
                          self.nondeterministic_leaves()))
        log({"phase": "lm_train_resume", "arch": TRAIN_ARCH,
             "args": TRAIN_RESUME, "crash_exit": 42,
             "resumed_from": resumed["resumed_from"],
             "last_loss_resumed": resumed["last_loss"],
             "last_loss_clean": clean["last_loss"], "gap": gap,
             "tolerance": RESUME_TOL, "device": clean["device"],
             "seconds_three_runs": round(time.perf_counter() - t0, 3)})

    # -- phase group lm_sharded ------------------------------------------------
    # -- phase group lm_mixed ----------------------------------------------
    def lm_mixed(self):
        """mamba2-130m at full width and depth, float32 params with bfloat16
        activations: the forward and the gradient on the kernel route
        against the plain route, MIXED_STEPS train steps from step 1, and
        decode with the caches' dtypes after every step."""
        import dataclasses
        import math
        torch = self.torch
        from repro_torch import generator
        from repro_torch.configs import get_config
        from repro_torch.distributed.steps import (
            loss_and_grads, make_train_step,
        )
        from repro_torch.kernels import ops
        from repro_torch.launch import serve, train
        from repro_torch.models import transformer as T
        from repro_torch.optim import (
            AdamWConfig, ScheduleConfig, adamw_init, make_schedule,
        )
        from repro_torch.optim.adamw import tree_leaves
        t_ph = time.perf_counter()
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), **MIXED)
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(generator(0, self.dev), cfg, device=self.dev)
        check({p.dtype for p in tree_leaves(params)} == {torch.float32},
              "mixed params are float32")
        batches = [self.lm_batch(cfg, 256, 8, position=i)
                   for i in range(MIXED_STEPS + 1)]

        # The forward: kernel route against plain route, and the plain
        # route's float32-activation run as the bf16 yardstick.
        with torch.no_grad():
            lk, _ = T.forward(params, cfg, batches[1])
            lp, _ = T.forward(params, cfg, batches[1], use_kernel=False)
            l32, _ = T.forward(params, cfg32, batches[1], use_kernel=False)
        check(lk.dtype == lp.dtype == torch.bfloat16
              and bool(torch.isfinite(lk).all()), ("mixed logits", lk.dtype))
        fwd_err = (lk.float() - lp.float()).abs().max().item()
        fwd_yard = (lp.float() - l32).abs().max().item()
        fwd_max = lp.float().abs().max().item()
        check(fwd_err <= MIXED_YARDSTICKS * fwd_yard,
              ("mixed forward kernel vs plain", fwd_err, fwd_yard))
        del lk, lp, l32

        # The step-1 gradient, leaf by leaf against the same yardstick.
        losses = {}
        grads = {}
        for name, (c, uk) in {"kernel": (cfg, True), "plain": (cfg, False),
                              "f32": (cfg32, False)}.items():
            loss, _, g = loss_and_grads(params, c, batches[1], use_kernel=uk)
            losses[name], grads[name] = loss.item(), tree_leaves(g)
        check(all(g.dtype == torch.float32 for g in grads["kernel"]),
              "mixed gradients are float32")
        names = self.paths(params)
        worst, where, worst_rel = 0.0, None, 0.0
        for i, (a, b, c) in enumerate(zip(grads["kernel"], grads["plain"],
                                          grads["f32"])):
            err = (a - b).abs().max().item()
            yard = (b - c).abs().max().item()
            check(math.isfinite(err) and err <= MIXED_YARDSTICKS * yard,
                  ("mixed grad leaf kernel vs plain", names[i], err, yard))
            worst_rel = max(worst_rel, err / max(b.abs().max().item(),
                                                 1e-30))
            if yard > 0 and err / yard >= worst:
                worst, where = err / yard, names[i]
        del grads
        self.free()
        # The plain routes above are comparisons, not a path.
        self.note_batches()
        ops.reset_dispatch()

        # MIXED_STEPS train steps from step 1 at the trainer's lr and
        # schedule.
        rc = train.TrainRunConfig()
        opt_cfg = AdamWConfig(lr=rc.lr)
        sched = make_schedule(ScheduleConfig(warmup_steps=rc.warmup,
                                             total_steps=rc.steps))
        opt = adamw_init(params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, sched)
        per_step = []

        def run():
            nonlocal params, opt
            for step in range(1, MIXED_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, opt, m = step_fn(params, opt, batches[step], step)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                moved = self.moved(params, new)
                per_step.append({"step": step, "lr": float(sched(step)),
                                 "loss": m["loss"].item(),
                                 "ms": round(dt * 1e3, 3),
                                 "tokens_per_s": round(8 * 256 / dt, 1),
                                 "leaves_moved": sum(v > 0 for v in
                                                     moved.values()),
                                 "leaves": len(moved)})
                params = new

        _, launches, tiers = self.path_counts(run)
        chunks = -(-256 // cfg.blocks[0].ssm.chunk)
        want = MIXED_STEPS * cfg.n_layers * chunks * (2 if cfg.remat else 1)
        check(launches["ssd_chunk"] == want > 0,
              ("ssd_chunk launches on the mixed train path", launches, want))
        check(tiers == {"ssd_chunk": {"cuda": want}}, tiers)
        check(all(math.isfinite(r["loss"]) and r["lr"] > 0
                  and r["leaves_moved"] > 0 for r in per_step), per_step)
        check({p.dtype for p in tree_leaves(params)} == {torch.float32}
              and {x.dtype for x in tree_leaves(opt["m"])}
              == {x.dtype for x in tree_leaves(opt["v"])} == {torch.float32},
              "mixed params float32, moments fp32 after the steps")
        self.mixed_launches = launches["ssd_chunk"]
        self.profile("lm_mixed_profile",
                     lambda: step_fn(params, opt, batches[-1],
                                     MIXED_STEPS + 1),
                     arch=TRAIN_ARCH, B=8, S=256, dtype="float32 params, "
                     "bfloat16 activations")
        peak_train = torch.cuda.max_memory_allocated()
        del opt
        self.free()

        # Decode: prefill as decode, then greedy, the caches' dtypes read
        # after every step; generate() over the same prompts.
        b, p_len, gen = MIXED_DECODE
        prompts = torch.randint(0, cfg.vocab_size, (b, p_len),
                                generator=generator(1, self.dev),
                                device=self.dev, dtype=torch.int32)

        def ssm_dtypes(caches):
            return {(str(c["ssm"]["conv"].dtype), str(c["ssm"]["state"].dtype))
                    for g in caches for c in g}

        step_ms, toks = [], []
        with torch.inference_mode():
            caches = T.init_cache(cfg, b, p_len + gen, device=self.dev)
            check(ssm_dtypes(caches) == {("torch.bfloat16",
                                          "torch.bfloat16")},
                  ("mixed caches at init", ssm_dtypes(caches)))
            cur = prompts[:, :1]
            for t in range(p_len + gen - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = T.decode_step(params, cfg, {"tokens": cur},
                                           caches)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                check(ssm_dtypes(caches) == {("torch.float32",
                                              "torch.bfloat16")},
                      ("mixed caches after a step", t, ssm_dtypes(caches)))
                check(lg.dtype == torch.bfloat16
                      and bool(torch.isfinite(lg).all()), ("decode", t))
                if t + 1 < p_len:
                    cur = prompts[:, t + 1:t + 2]
                else:
                    cur = torch.argmax(lg[..., :cfg.vocab_size], dim=-1)[
                        :, None].to(torch.int32)
                    toks.append(cur)
            out = serve.generate(cfg, params, prompts, gen)
        check(torch.equal(out[:, p_len:], torch.cat(toks, dim=1)),
              "generate != the decode loop's greedy tokens")
        decode_ms = statistics.mean(step_ms[1:])
        log({"phase": "lm_mixed", "arch": TRAIN_ARCH,
             "gpu": nvidia_smi("name,power.limit"),
             "param_dtype": cfg.param_dtype,
             "activation_dtype": cfg.activation_dtype,
             "param_count": cfg.param_count(), "layers": cfg.n_layers,
             "d_model": cfg.d_model, "remat": cfg.remat, "B": 8, "S": 256,
             "forward_max_abs_err": fwd_err, "forward_yardstick": fwd_yard,
             "forward_max_abs_logit": fwd_max,
             "losses_step1": losses,
             "grad_worst_share_of_yardstick": worst,
             "grad_worst_leaf": where,
             "grad_worst_rel_of_max_leaf": worst_rel,
             "yardsticks_allowed": MIXED_YARDSTICKS,
             "per_step": per_step,
             "ms_per_step_after_first": round(statistics.mean(
                 r["ms"] for r in per_step[1:]), 3),
             "tokens_per_s_after_first": round(statistics.mean(
                 r["tokens_per_s"] for r in per_step[1:]), 1),
             "launches": {"ssd_chunk": launches["ssd_chunk"]},
             "dispatch_tiers": tiers,
             "peak_bytes_train": peak_train,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "decode": {"B": b, "prompt": p_len, "gen": gen,
                        "steps": len(step_ms),
                        "ms_per_step_after_first": round(decode_ms, 3),
                        "tokens_per_s": round(b * 1e3 / decode_ms, 1),
                        "cache_dtypes_after_step": ["float32 conv",
                                                    "bfloat16 state"]},
             "seconds": round(time.perf_counter() - t_ph, 3)})
        del params
        self.free()

    # -- phase group lm_reverse --------------------------------------------
    def reverse_checks(self, what, logits, hidden=None, caches=None):
        """The reverse mix's invariants of one run: float32 logits (and
        residual stream) on the card, finite, and float32 caches (int8
        rows and float16 scales under ``kv_cache_quant``) on the card:
        no product fell back to the CPU."""
        torch = self.torch
        for name, t in (("logits", logits), ("final_hidden", hidden)):
            if t is not None:
                check(t.dtype == torch.float32 and t.is_cuda
                      and bool(torch.isfinite(t).all()),
                      (what, name, t.dtype, t.device))
        if caches is not None:
            got = {(str(v.dtype), v.device.type) for g in caches
                   for layer in g for c in layer.values()
                   for v in c.values() if torch.is_tensor(v)}
            check({d for d, _ in got} <= {"torch.float32", "torch.int32",
                                          "torch.int8", "torch.float16"}
                  and {t for _, t in got} == {"cuda"}, (what, got))
            return sorted({d.removeprefix("torch.") for d, _ in got})
        return None

    def lm_reverse_serve(self):
        """hymba-1.5b at full width and depth, bfloat16 params with
        float32 activations: generate at REVERSE_DECODE (timed, counted;
        every flash_decode launch cuda), then teacher-forced decode of the
        generated tokens on the kernel route (it reproduces generate's
        tokens) and on the plain route, step by step within LM_TOL x
        max|logit|; T.forward over the same tokens on both routes (every
        ssd_chunk launch cuda) within LM_TOL."""
        torch = self.torch
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import tree_leaves
        t_ph = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(LM_ARCH, seed=31, act="float32")
        check({p.dtype for p in tree_leaves(params)} == {torch.bfloat16},
              "reverse-mix params are bfloat16")
        b, plen, gen = REVERSE_DECODE
        prompts, _ = self.token_steps(cfg, b, plen, 32)
        serve.generate(cfg, params, prompts[:, :4], 2)  # warm-up
        t0 = time.perf_counter()
        out, launches, tiers = self.path_counts(
            lambda: serve.generate(cfg, params, prompts, gen))
        wall = time.perf_counter() - t0
        steps = plen + gen - 1
        want = cfg.n_layers * steps
        check(launches["flash_decode"] == want
              and tiers == {"flash_decode": {"cuda": want}},
              ("reverse generate launches", launches, tiers, want))
        fed = [{"tokens": out[:, i:i + 1]} for i in range(steps)]
        with torch.inference_mode():
            caches = T.init_cache(cfg, b, plen + gen, device=self.dev)
            dtypes = self.reverse_checks("reverse caches at init", None,
                                         caches=caches)
            lk = []
            for sb in fed:
                lg, caches = T.decode_step(params, cfg, sb, caches)
                lk.append(lg)
            after = self.reverse_checks("reverse decode", lk[-1],
                                        caches=caches)
            lk = torch.stack(lk, 1)[..., :cfg.vocab_size]
            check(torch.equal(lk[:, plen - 1:].argmax(-1).to(torch.int32),
                              out[:, plen:]),
                  "teacher-forced kernel decode != generate's tokens")
            lp = self.tf_decode(cfg, params, fed, use_kernel=False,
                                max_len=plen + gen)[..., :cfg.vocab_size]
            err = (lk - lp).abs().amax(dim=(0, 2))
            scale = lp.abs().amax(dim=(0, 2))
            bad = (err > LM_TOL * scale).nonzero().flatten().tolist()
            check(not bad, ("reverse decode kernel vs plain", bad[:5]))
            batch = {"tokens": out}
            (fk, aux), f_launches, f_tiers = self.path_counts(
                lambda: T.forward(params, cfg, batch))
            n_chunks = -(-out.shape[1] // cfg.blocks[0].ssm.chunk)
            want_f = cfg.n_layers * n_chunks
            check(f_launches["ssd_chunk"] == want_f
                  and f_tiers == {"ssd_chunk": {"cuda": want_f}},
                  ("reverse forward launches", f_launches, f_tiers))
            self.reverse_checks("reverse forward", fk, aux["final_hidden"])
            fp, _ = T.forward(params, cfg, batch, use_kernel=False)
            f_err = (fk - fp).abs().max().item()
            f_scale = fp.abs().max().item()
            check(f_err <= LM_TOL * f_scale,
                  ("reverse forward kernel vs plain", f_err, f_scale))
            self.profile("lm_reverse_decode_profile", lambda: self.tf_decode(
                cfg, params, fed[:4]), B=b, steps=4)
        # The plain routes above are comparisons, not a path.
        self.note_batches()
        from repro_torch.kernels import ops
        ops.reset_dispatch()
        self.reverse_launches["flash_decode"] += launches["flash_decode"]
        self.reverse_launches["ssd_chunk"] += f_launches["ssd_chunk"]
        log({"phase": "lm_reverse_serve",
             **self.model_log(cfg, LM_ARCH, init_s),
             "gpu": nvidia_smi("name,power.limit"),
             "activation_dtype": cfg.activation_dtype, "B": b,
             "prompt": plen, "gen": gen, "wall_s": round(wall, 4),
             "ms_per_decode_step": round(wall * 1e3 / steps, 3),
             "tok_per_s": round(b * (plen + gen) / wall, 1),
             "launches": {"flash_decode": launches["flash_decode"],
                          "ssd_chunk": f_launches["ssd_chunk"]},
             "dispatch_tiers": tiers, "forward_tiers": f_tiers,
             "cache_dtypes_at_init": dtypes,
             "cache_dtypes_after_steps": after,
             "decode_kernel_vs_plain_max_abs": err.max().item(),
             "decode_tolerance_min": (LM_TOL * scale).min().item(),
             "forward_kernel_vs_plain_max_abs": f_err,
             "forward_tolerance": LM_TOL * f_scale,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "seconds": round(time.perf_counter() - t_ph, 3)})
        del params, caches
        self.free()

    def lm_reverse_train(self):
        """mamba2-130m at full width and depth, bfloat16 params with
        float32 activations, the trainer's batch (seq 256, batch 8): the
        step-1 loss and gradients on the kernel route against the plain
        route (REVERSE_GRAD_TOL, REVERSE_GRAD_STEPS); REVERSE_STEPS train
        steps from step 1 at the trainer's lr and schedule (losses finite,
        params bfloat16, moments fp32, at least two steps move the params,
        every SSD chunk on ``ssd_chunk``: steps x layers x chunks x 2
        under remat)."""
        import math
        torch = self.torch
        from repro_torch.distributed.steps import (
            loss_and_grads, make_train_step,
        )
        from repro_torch.kernels import ops
        from repro_torch.launch import train
        from repro_torch.models import transformer as T
        from repro_torch.optim import (
            AdamWConfig, ScheduleConfig, adamw_init, make_schedule,
        )
        from repro_torch.optim.adamw import tree_leaves
        t_ph = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(TRAIN_ARCH, seed=33,
                                            act="float32")
        batches = [self.lm_batch(cfg, 256, 8, position=i)
                   for i in range(REVERSE_STEPS + 1)]
        with torch.no_grad():
            lg, aux = T.forward(params, cfg, batches[1])
        self.reverse_checks("reverse train forward", lg,
                            aux["final_hidden"])
        del lg, aux
        (lk, _, gk), (lp, _, gp) = (
            loss_and_grads(params, cfg, batches[1], use_kernel=uk)
            for uk in (True, False))
        check(abs(lk.item() - lp.item()) <= LM_TOL * abs(lp.item()),
              ("reverse loss kernel vs plain", lk.item(), lp.item()))
        # Each leaf's error in bfloat16 steps at its max|plain leaf|.
        grad_steps = {}
        for name, a, b in zip(self.paths(params), tree_leaves(gk),
                              tree_leaves(gp)):
            check(a.dtype == b.dtype == torch.bfloat16, (name, a.dtype))
            top = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            grad_steps[name] = (max(0.0, err - REVERSE_GRAD_TOL * top)
                                / bf16_step(top) if top > 0 else 0.0)
        worst = sorted(grad_steps.items(), key=lambda kv: -kv[1])[:5]
        check(worst[0][1] <= REVERSE_GRAD_STEPS,
              ("reverse grad leaves kernel vs plain", worst))
        del gk, gp
        self.free()
        self.note_batches()
        ops.reset_dispatch()

        rc = train.TrainRunConfig()
        opt_cfg = AdamWConfig(lr=rc.lr)
        sched = make_schedule(ScheduleConfig(warmup_steps=rc.warmup,
                                             total_steps=rc.steps))
        opt = adamw_init(params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, sched)
        per_step = []

        def run():
            nonlocal params, opt
            for step in range(1, REVERSE_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, opt, m = step_fn(params, opt, batches[step], step)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                moved = self.moved(params, new)
                per_step.append({"step": step, "lr": float(sched(step)),
                                 "loss": m["loss"].item(),
                                 "ms": round(dt * 1e3, 3),
                                 "tokens_per_s": round(8 * 256 / dt, 1),
                                 "leaves_moved": sum(v > 0 for v in
                                                     moved.values()),
                                 "leaves": len(moved)})
                params = new

        _, launches, tiers = self.path_counts(run)
        chunks = -(-256 // cfg.blocks[0].ssm.chunk)
        want = REVERSE_STEPS * cfg.n_layers * chunks * (2 if cfg.remat
                                                        else 1)
        check(launches["ssd_chunk"] == want > 0
              and tiers == {"ssd_chunk": {"cuda": want}},
              ("ssd_chunk launches on the reverse train path", launches,
               tiers, want))
        check(all(math.isfinite(r["loss"]) for r in per_step)
              and sum(r["leaves_moved"] > 0 for r in per_step) >= 2,
              per_step)
        check({p.dtype for p in tree_leaves(params)} == {torch.bfloat16}
              and {x.dtype for x in tree_leaves(opt["m"])}
              == {x.dtype for x in tree_leaves(opt["v"])} == {torch.float32},
              "reverse params bfloat16, moments fp32 after the steps")
        self.reverse_launches["ssd_chunk"] += launches["ssd_chunk"]
        self.profile("lm_reverse_profile",
                     lambda: step_fn(params, opt, batches[-1],
                                     REVERSE_STEPS + 1),
                     arch=TRAIN_ARCH, B=8, S=256, dtype="bfloat16 params, "
                     "float32 activations")
        log({"phase": "lm_reverse_train",
             **self.model_log(cfg, TRAIN_ARCH, init_s),
             "gpu": nvidia_smi("name,power.limit"),
             "activation_dtype": cfg.activation_dtype, "remat": cfg.remat,
             "B": 8, "S": 256,
             "losses_step1": {"kernel": lk.item(), "plain": lp.item()},
             "grad_worst_bf16_steps": worst,
             "grad_tolerance": f"{REVERSE_GRAD_TOL} x max|leaf| + "
                               f"{REVERSE_GRAD_STEPS} bf16 steps at "
                               f"max|leaf|",
             "per_step": per_step,
             "ms_per_step_after_first": round(statistics.mean(
                 r["ms"] for r in per_step[1:]), 3),
             "tokens_per_s_after_first": round(statistics.mean(
                 r["tokens_per_s"] for r in per_step[1:]), 1),
             "launches": {"ssd_chunk": launches["ssd_chunk"]},
             "dispatch_tiers": tiers,
             "moments": "fp32",
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "seconds": round(time.perf_counter() - t_ph, 3)})
        del params, opt
        self.free()

    def lm_reverse_deepseek(self):
        """deepseek-v2-lite-16b at full width cut to REVERSE_DS_DEPTH (1
        dense + 3 MoE layers), bfloat16 params (float32 routers) with
        float32 activations: T.forward at DS_FORWARD (MLA, the MoE's
        float32 router and each layer's experts widened to float32),
        timed after a warm-up; REVERSE_DS_DECODE teacher-forced decode
        steps over the latent cache (float32) from the forward's first
        tokens, the last within SERVE_TOL x max|logit| of the forward at
        that position."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import tree_leaves
        t_ph = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(DS_ARCH, REVERSE_DS_DEPTH,
                                            seed=34, act="float32")
        check({p.dtype for p in tree_leaves(params)} == {torch.bfloat16,
                                                         torch.float32},
              "reverse deepseek params: bf16, float32 routers")
        param_bytes = torch.cuda.memory_allocated()
        fb, fs = DS_FORWARD
        toks, _ = self.token_steps(cfg, fb, fs, 35)
        n = REVERSE_DS_DECODE
        with torch.inference_mode():
            T.forward(params, cfg, {"tokens": toks})  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd, aux = T.forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            self.reverse_checks("reverse deepseek forward", fwd,
                                aux["final_hidden"])
            short, _ = T.forward(params, cfg, {"tokens": toks[:, :n]})
            self.tf_decode(cfg, params, [{"tokens": toks[:, :1]}])  # warm-up
            caches = T.init_cache(cfg, fb, n, device=self.dev)
            step_ms = []
            for i in range(n):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                dec, caches = T.decode_step(params, cfg,
                                            {"tokens": toks[:, i:i + 1]},
                                            caches)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            dtypes = self.reverse_checks("reverse deepseek decode", dec,
                                         caches=caches)
            err = (dec - short[:, -1]).abs().max().item()
            scale = short[:, -1].abs().max().item()
            check(err < SERVE_TOL * scale,
                  ("reverse deepseek decode != forward", err, scale))
        log({"phase": "lm_reverse_deepseek",
             **self.model_log(cfg, DS_ARCH, init_s),
             "gpu": nvidia_smi("name,power.limit"),
             "activation_dtype": cfg.activation_dtype,
             "depth_cut": {"layers": cfg.n_layers,
                           "from": self.full_cfg(DS_ARCH).n_layers},
             "param_bytes": param_bytes,
             "forward": {"B": fb, "S": fs, "ms": round(fwd_s * 1e3, 3),
                         "tok_per_s": round(fb * fs / fwd_s, 1)},
             "decode": {"B": fb, "steps": n,
                        "ms_per_step": [round(x, 3) for x in step_ms],
                        "cache_dtypes": dtypes},
             "decode_vs_forward_max_abs": err, "forward_logit_scale": scale,
             "tolerance": SERVE_TOL * scale,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "seconds": round(time.perf_counter() - t_ph, 3)})
        del params, fwd, aux, caches
        self.free()

    def lm_reverse_quant(self):
        """qwen1.5-32b at full width cut to QUANT_LAYERS layers, bfloat16
        params with float32 activations and the int8 KV cache:
        teacher-forced decode over REVERSE_QUANT_DECODE (the caches int8
        rows with float16 scales), every step within QUANT_TOL x
        max|logit| of the float32-cache decode of the same params, and the
        last step within it of the float forward's last position."""
        import dataclasses
        torch = self.torch
        from repro_torch.models import transformer as T
        t_ph = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = self.lm_model(QUANT_ARCH, (QUANT_LAYERS,),
                                            seed=36, act="float32")
        cfgq = dataclasses.replace(cfg, kv_cache_quant=True)
        b, s = REVERSE_QUANT_DECODE
        toks, steps = self.token_steps(cfg, b, s, 37)
        with torch.inference_mode():
            caches = T.init_cache(cfgq, b, s, device=self.dev)
            t1 = time.perf_counter()
            dq = []
            for sb in steps:
                lg, caches = T.decode_step(params, cfgq, sb, caches)
                dq.append(lg)
            torch.cuda.synchronize()
            q_s = time.perf_counter() - t1
            dtypes = self.reverse_checks("reverse int8 decode", lg,
                                         caches=caches)
            check(dtypes == ["float16", "int32", "int8"], dtypes)
            dq = torch.stack(dq, 1)
            t2 = time.perf_counter()
            df = self.tf_decode(cfg, params, steps)
            torch.cuda.synchronize()
            f_s = time.perf_counter() - t2
            err = (dq - df).abs().amax(dim=(0, 2))
            scale = df.abs().amax(dim=(0, 2))
            bad = (err > QUANT_TOL * scale).nonzero().flatten().tolist()
            check(not bad, ("reverse int8 cache decode vs float32 cache",
                            bad[:5]))
            fwd, aux = T.forward(params, cfg, {"tokens": toks})
            self.reverse_checks("reverse qwen forward", fwd,
                                aux["final_hidden"])
            last = fwd[:, -1]
            f_err = (dq[:, -1] - last).abs().max().item()
            check(f_err < QUANT_TOL * last.abs().max().item(),
                  ("reverse int8 decode vs forward", f_err))
        log({"phase": "lm_reverse_quant",
             **self.model_log(cfg, QUANT_ARCH, init_s),
             "gpu": nvidia_smi("name,power.limit"),
             "activation_dtype": cfg.activation_dtype,
             "depth_cut": {"layers": QUANT_LAYERS,
                           "from": self.full_cfg(QUANT_ARCH).n_layers},
             "B": b, "S": s, "cache_dtypes": dtypes,
             "max_rel_err_vs_float_cache": (err / scale).max().item(),
             "last_step_vs_forward_max_abs": f_err,
             "tolerance_rel": QUANT_TOL,
             "ms_per_decode_step_int8_cache": round(q_s * 1e3 / s, 3),
             "ms_per_decode_step_f32_cache": round(f_s * 1e3 / s, 3),
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "seconds": round(time.perf_counter() - t_ph, 3)})
        del params, dq, df, fwd, aux, caches
        self.free()

    def one_card_rules(self, shape, axes, **kw):
        from repro_torch.launch.mesh import make_rules, make_test_mesh
        return make_rules(make_test_mesh(shape, axes, devices=self.dev), **kw)

    def filled_caches(self, cfg, b, s, length, seed, rules=None):
        """``T.init_cache`` (under ``rules`` when given: the
        sequence-parallel decode's per-member blocks, allocated directly)
        with every K / V entry drawn from a seed (N(0, 1) in the cache's
        dtype, over the whole (B, S, KV, Dh) shape one layer at a time, so
        the blocks hold what the whole cache holds) and ``len`` =
        ``length``: a cache as a prefill of ``length`` tokens would leave
        it, without the prefill."""
        torch = self.torch
        from repro_torch import generator
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        from repro_torch.models.sharding import use_rules
        with use_rules(rules):
            caches = T.init_cache(cfg, b, s, device=self.dev)
        gen = generator(seed, self.dev)
        for group in caches:
            for layer in group:
                c = layer["attn"]
                for name in ("k", "v"):
                    if not isinstance(c[name], list):
                        c[name].copy_(torch.randn(
                            c[name].shape, generator=gen, device=self.dev,
                            dtype=c[name].dtype))
                        continue
                    blocks = c[name]
                    full = torch.randn((b, s) + tuple(blocks[0].shape[2:]),
                                       generator=gen, device=self.dev,
                                       dtype=blocks[0].dtype)
                    for (rows, keys), blk in zip(
                            L.seq_blocks(rules.mesh, b, s), blocks):
                        blk.copy_(full[rows, keys])
                    del full
                c["len"].fill_(length)
        return caches

    def timed_decode(self, step_fn, params, steps, caches):
        """(logits (B, steps, V), ms of each step): ``step_fn`` over
        ``steps``, each step timed to a synchronize."""
        torch = self.torch
        out, ms = [], []
        for sb in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = step_fn(params, sb, caches)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            out.append(lg)
        return torch.stack(out, 1), ms

    def lm_seq_parallel(self):
        """qwen1.5-32b (SP_LAYERS of 64 layers, 40 heads, KV 40, head_dim
        128) decoding sequence-parallel over (data 1, model 2) of the one
        card: make_serve_step(cfg, rules) with ``seq_parallel_decode`` and
        ``shard_seq``, each run from its own copy of a seeded cache. In
        float32 at SP_CHECK every step's logits == the unsharded
        decode_step within LM_TOL x max|logit|, every flash_decode launch
        (2 a layer a step, one a "model" shard) on the cuda tier, the
        inventory the reference's three all-reduces a layer; in bfloat16
        at SP_TIMED both timed and their difference reported, beside the
        unsharded decode's own difference between the kernel and the
        plain flash_decode (the yardstick for bf16 drift). The
        sequence-parallel run's cache is built under the rules (never
        whole), after the unsharded run's cache is freed: each run's peak
        bytes are its own."""
        import dataclasses
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.distributed.collectives import (
            collective_bytes, record_collectives,
        )
        from repro_torch.distributed.steps import make_serve_step
        from repro_torch.kernels import ops
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        rules = self.one_card_rules((1, 2), ("data", "model"),
                                    shard_seq=True)
        out = {}
        for dtype, (b, s, length, n) in (("float32", SP_CHECK),
                                         ("bfloat16", SP_TIMED)):
            self.free()
            torch.cuda.reset_peak_memory_stats()
            cfg, params, init_s = self.lm_model(
                SP_ARCH, (SP_LAYERS,), dtype=dtype, seed=40,
                seq_parallel_decode=True)
            plain_cfg = dataclasses.replace(cfg, seq_parallel_decode=False)
            _, steps = self.token_steps(cfg, b, n, 41)
            whole = self.filled_caches(plain_cfg, b, s, length, 42)
            with torch.inference_mode():
                want, ms_plain = self.timed_decode(
                    make_serve_step(plain_cfg), params, steps, whole)
            del whole
            self.free()
            peak_plain = torch.cuda.max_memory_allocated()
            # The yardstick for the sharded run's difference: the same
            # unsharded decode through the plain flash_decode (float32 P).
            whole = self.filled_caches(plain_cfg, b, s, length, 42)
            with torch.inference_mode():
                plain_route, _ = self.timed_decode(
                    lambda pp, sb, cc: T.decode_step(
                        pp, plain_cfg, sb, cc, use_kernel=False),
                    params, steps, whole)
            del whole
            self.free()
            drift = (plain_route.float() - want.float()).abs().max().item()
            del plain_route
            torch.cuda.reset_peak_memory_stats()
            sharded = self.filled_caches(cfg, b, s, length, 42, rules)
            check(all(isinstance(layer["attn"]["k"], list)
                      for group in sharded for layer in group),
                  "the sequence-parallel caches are built as blocks")
            with torch.inference_mode():
                self.note_batches()
                kernels.reset_launches()
                ops.reset_dispatch()
                with record_collectives() as coll:
                    got, ms_sp = self.timed_decode(
                        make_serve_step(cfg, rules), params, steps, sharded)
                launches = kernels.launches()["flash_decode"]
                tiers = ops.dispatch_breakdown().get("flash_decode")
            err = (got.float() - want.float()).abs().amax(dim=(0, 2))
            scale = want.float().abs().amax(dim=(0, 2))
            finite = bool(torch.isfinite(got).all())
            check(finite, ("seq-parallel logits finite", dtype))
            if dtype == "float32":
                bad = (err > LM_TOL * scale).nonzero().flatten().tolist()
                check(not bad, ("seq-parallel decode vs unsharded", bad,
                                err.max().item(), scale.max().item()))
            want_launches = 2 * SP_LAYERS * n
            check(launches == want_launches
                  and tiers == {"cuda": want_launches},
                  ("seq-parallel flash_decode launches", launches, tiers))
            kinds = [op.kind for op in coll]
            check(kinds == ["all-reduce"] * 3 * SP_LAYERS * n,
                  ("seq-parallel collectives", kinds[:6], len(kinds)))
            out[dtype] = {
                "B": b, "S": s, "len": length, "steps": n,
                "init_seconds": round(init_s, 3),
                # Step 1 carries each path's first calls at these shapes.
                "ms_per_step_unsharded": ms_plain,
                "ms_per_step_seq_parallel": ms_sp,
                "ms_after_first_unsharded": round(
                    statistics.mean(ms_plain[1:]), 3),
                "ms_after_first_seq_parallel": round(
                    statistics.mean(ms_sp[1:]), 3),
                "max_abs_logit_diff": err.max().item(),
                "max_abs_logit_diff_plain_route_unsharded": drift,
                "max_abs_logit": scale.max().item(),
                "tolerance": (LM_TOL * scale.max().item()
                              if dtype == "float32" else None),
                "flash_decode_launches": launches,
                "flash_decode_tiers": tiers,
                "collectives_per_step": {
                    "count": len(coll) // n,
                    "wire_bytes": {k: v / n for k, v in
                                   collective_bytes(coll).items()}},
                "peak_bytes_unsharded": peak_plain,
                "peak_bytes_seq_parallel": torch.cuda.max_memory_allocated()}
            self.sp_launches = self.sp_launches + launches
            del params, sharded, got, want
            self.free()
        log({"phase": "lm_seq_parallel", "arch": SP_ARCH,
             "depth_cut": {"layers": SP_LAYERS,
                           "from": self.full_cfg(SP_ARCH).n_layers},
             "mesh": {"data": 1, "model": 2}, "runs": out,
             "seconds": round(time.perf_counter() - t0, 3)})

    def lm_expert_parallel(self):
        """deepseek-v2-lite (1 dense + 1 MoE layer, full width, float32)
        with the expert-parallel MoE over (data 1, model 2) of the card: the
        MoE layer at EP_FORWARD tokens against the local path at cf = E
        (LM_TOL x max, counts equal) and at the published cf (the dropped
        slots == the per-(source, expert) capacity rule's, and every token
        with none dropped == local within LM_TOL x max); T.forward under
        the rules (finite, timed) and EP_DECODE decode steps under the rules
        against the unsharded model at the published cf within LM_TOL x
        max (no slot drops: decode's t_local is B / 2)."""
        import dataclasses
        import math
        torch = self.torch
        from repro_torch.distributed.collectives import record_collectives
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        from repro_torch.models.sharding import use_rules
        t0 = time.perf_counter()
        rules = self.one_card_rules((1, 2), ("data", "model"))
        cfg, params, init_s = self.lm_model(EP_ARCH, EP_DEPTH,
                                            dtype="float32", seed=43)
        spec = cfg.blocks[1].ffn
        lp = {k: v[0] for k, v in params["groups"][1]["ffn"].items()}
        b, s = EP_FORWARD
        x = self.moe_inputs((b, s, cfg.d_model), 44)
        res = {}
        kept = []
        orig = L._dispatch

        def spy(*a):
            buf, route = orig(*a)
            kept.append(int(route[1].sum()))
            return buf, route
        with torch.inference_mode():
            for name, cf in (("cf_E", float(spec.n_experts)),
                             ("published", spec.capacity_factor)):
                sp = dataclasses.replace(spec, capacity_factor=cf)
                want, aux0 = L._moe_ffn_local(lp, sp, x)
                L.moe_ffn(lp, sp, x, rules=rules)  # first calls, untimed
                kept.clear()
                L._dispatch = spy
                try:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    with record_collectives() as coll:
                        got, aux = L.moe_ffn(lp, sp, x, rules=rules)
                    torch.cuda.synchronize()
                    ms_ep = (time.perf_counter() - t1) * 1e3
                finally:
                    L._dispatch = orig
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                L._moe_ffn_local(lp, sp, x)
                torch.cuda.synchronize()
                ms_local = (time.perf_counter() - t2) * 1e3
                scale = want.abs().max().item()
                diff = (got - want).abs().amax(dim=-1).flatten()
                check(torch.equal(aux["expert_counts"],
                                  aux0["expert_counts"]),
                      ("expert counts", name))
                # The capacity rule, member by member.
                n, k, e = 2, spec.top_k, spec.n_experts
                t_all = b * s
                t_local = t_all // n
                cap = math.ceil(t_local * k / e * cf)
                xt = x.reshape(t_all, -1)
                dropped, lost = 0, torch.zeros(t_all, dtype=torch.bool,
                                               device=self.dev)
                for j in range(n):
                    xl = xt[j * t_local:(j + 1) * t_local]
                    _, _, top_i = L._route(xl @ lp["router"], sp,
                                           lp.get("router_bias"))
                    flat = top_i.reshape(-1)
                    order = torch.sort(flat, stable=True).indices
                    srt = flat[order]
                    start = torch.searchsorted(srt, torch.arange(
                        e, device=self.dev))
                    pos = torch.arange(flat.numel(), device=self.dev) \
                        - start[srt]
                    drop = torch.zeros_like(flat, dtype=torch.bool)
                    drop[order] = pos >= cap
                    dropped += int(drop.sum())
                    lost[j * t_local:(j + 1) * t_local] = drop.reshape(
                        t_local, k).any(-1)
                got_dropped = n * t_local * k - sum(kept)
                check(got_dropped == dropped,
                      ("dropped slots vs the capacity rule", name,
                       got_dropped, dropped))
                ok = diff[~lost]
                check(bool((ok <= LM_TOL * scale).all()),
                      ("expert-parallel vs local", name, ok.max().item(),
                       scale))
                if name == "cf_E":
                    check(dropped == 0, ("cf = E drops", dropped))
                res[name] = {
                    "capacity_factor": cf, "cap_per_source_expert": cap,
                    "dropped_slots": got_dropped,
                    "tokens_with_a_dropped_slot": int(lost.sum()),
                    "max_abs_diff_kept_tokens": ok.max().item(),
                    "max_abs_out": scale,
                    "ms_expert_parallel": round(ms_ep, 3),
                    "ms_local": round(ms_local, 3),
                    "collectives": [op.kind for op in coll]}
            # The model: forward and decode steps under the rules.
            toks, steps = self.token_steps(cfg, b, s, 45)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            with use_rules(rules):
                fwd, faux = T.forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t3
            check(bool(torch.isfinite(fwd).all()), "EP forward finite")
            dec_want = self.tf_decode(cfg, params, steps[:EP_DECODE])
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            with use_rules(rules):
                dec = self.tf_decode(cfg, params, steps[:EP_DECODE])
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t4
            derr = (dec - dec_want).abs().max().item()
            dscale = dec_want.abs().max().item()
            check(derr <= LM_TOL * dscale, ("EP decode vs unsharded", derr,
                                            dscale))
        log({"phase": "lm_expert_parallel",
             **self.model_log(cfg, EP_ARCH, init_s),
             "depth_cut": {"dense": EP_DEPTH[0], "moe": EP_DEPTH[1]},
             "mesh": {"data": 1, "model": 2}, "moe_layer": res,
             "forward": {"B": b, "S": s, "seconds": round(fwd_s, 4)},
             "decode": {"steps": EP_DECODE, "max_abs_diff": derr,
                        "max_abs_logit": dscale,
                        "ms_per_step": round(dec_s * 1e3 / EP_DECODE, 3)},
             "seconds": round(time.perf_counter() - t0, 3)})
        del params, fwd, dec, dec_want
        self.free()

    def lm_pod_train(self):
        """mamba2-130m (full width and depth, bf16) through make_train_step
        with grad_compression="int8_ef" over pod 2 of the card, the
        trainer's batch, POD_STEPS steps from step 1 (lr > 0 past the
        warmup's 0 at step 0). Every step is checked from inside: a spy on
        ``_compress_pod_grads`` keeps what the step itself reduced. Losses
        finite; the ring-reduced gradient within POD_GRAD_TOL x max|exact
        float32 mean of the members' gradients| on every leaf and equal on
        both members bit for bit; each member's new residual ==
        ``ef_int8_compress``'s on its gradient and incoming residual, and
        those residuals are what the step returns; the new params ==
        ``adamw_update`` of the old with member 0's reduced gradient, bit
        for bit, and moved; every ssd_chunk launch on the cuda tier; each
        step's recorded wire bytes == the ring model's."""
        import math
        torch = self.torch
        from repro_torch import kernels
        from repro_torch.configs import get_config
        from repro_torch.distributed import steps as S
        from repro_torch.distributed.collectives import (
            collective_bytes, record_collectives,
        )
        from repro_torch.kernels import ops
        from repro_torch.optim import AdamWConfig, ScheduleConfig
        from repro_torch.optim import make_schedule
        from repro_torch.optim.adamw import adamw_update, tree_leaves
        from repro_torch.optim.compression import ef_int8_compress
        t0 = time.perf_counter()
        cfg = get_config(TRAIN_ARCH)
        opt_cfg = AdamWConfig()
        sched = make_schedule(ScheduleConfig())
        rules = self.one_card_rules((2, 1, 1), ("pod", "data", "model"))
        pod = rules.mesh.axis_mesh("pod")
        n = pod.size
        params, opt = S.init_train_state(0, cfg, opt_cfg, device=self.dev)
        opt["ef_err"] = S.init_ef_buffers(params, n, pod.member_devices())
        batch = self.lm_batch(cfg, 256, 8)
        # The ring model's bytes a step: n - 1 hops of int8 rows and float32
        # scales, then n - 1 of float32 rows, per leaf.
        wire = 0
        for p in tree_leaves(params):
            chunk = -(-math.ceil(p.numel() / 1024) // n)
            wire += (n - 1) * chunk * (1024 + 4 + 4 * 1024)
        step_fn = S.make_train_step(cfg, opt_cfg, sched, rules,
                                    grad_compression="int8_ef")
        seen = []
        orig = S._compress_pod_grads

        def spy(grads, ef_err, mesh):
            out = orig(grads, ef_err, mesh)
            seen.append((grads, ef_err) + out)
            return out
        self.note_batches()
        kernels.reset_launches()
        ops.reset_dispatch()
        per_step, worst = [], 0.0
        for i in range(1, POD_STEPS + 1):
            prev_params, prev_opt = params, opt
            seen.clear()
            S._compress_pod_grads = spy
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with record_collectives() as coll:
                    params, opt, m = step_fn(params, opt, batch, i)
                loss = float(m["loss"])
                ms = round((time.perf_counter() - t1) * 1e3, 2)
            finally:
                S._compress_pod_grads = orig
            per_step.append({"step": i, "loss": loss, "ms": ms,
                             "lr_scale": float(sched(i)),
                             "wire_bytes": collective_bytes(coll)["total"],
                             "permutes": len(coll)})
            check(math.isfinite(loss), ("pod loss", i, loss))
            check(collective_bytes(coll)["total"] == wire,
                  ("pod wire bytes vs ring model", per_step[-1], wire))
            check(len(seen) == 1, ("pod reductions a step", len(seen)))
            grads, ef_in, reduced, ef_out = seen.pop()
            flat = [tree_leaves(t) for t in (*grads, *reduced)]
            for li in range(len(flat[0])):
                exact = sum(flat[j][li].float() for j in range(n)) / n
                got = flat[n][li]
                err = (got.float() - exact).abs().max().item()
                scale = exact.abs().max().item()
                check(err <= POD_GRAD_TOL * scale,
                      ("pod grad leaf", i, li, err, scale))
                worst = max(worst, err / scale if scale else 0.0)
                check(all(torch.equal(got, flat[n + j][li])
                          for j in range(1, n)),
                      ("pod members differ", i, li))
            for j in range(n):
                for g, e0, e1 in zip(tree_leaves(grads[j]),
                                     tree_leaves(ef_in[j]),
                                     tree_leaves(ef_out[j])):
                    check(torch.equal(ef_int8_compress(g, e0)[2], e1),
                          ("pod ef residual", i, j))
            check(opt["ef_err"] is ef_out, ("pod residuals returned", i))
            want_p, _ = adamw_update(prev_params, reduced[0], prev_opt,
                                     opt_cfg, sched(i))
            moved = False
            for a, b, p0 in zip(tree_leaves(params), tree_leaves(want_p),
                                tree_leaves(prev_params)):
                check(torch.equal(a, b), ("pod params vs adamw_update", i))
                moved = moved or not torch.equal(a, p0)
            check(moved, ("pod params moved", i))
            del grads, ef_in, reduced, ef_out, flat, want_p
            del prev_params, prev_opt
        launches = kernels.launches()["ssd_chunk"]
        tiers = ops.dispatch_breakdown().get("ssd_chunk")
        chunks = -(-256 // cfg.blocks[0].ssm.chunk)
        want = POD_STEPS * n * cfg.n_layers * chunks * (2 if cfg.remat
                                                        else 1)
        check(launches == want and tiers == {"cuda": want},
              ("pod ssd_chunk launches", launches, tiers, want))
        self.pod_launches = launches
        log({"phase": "lm_pod_train", "arch": TRAIN_ARCH,
             "param_count": cfg.param_count(), "dtype": cfg.param_dtype,
             "seq_len": 256, "global_batch": 8, "pod": n,
             "grad_worst_rel_err": worst,
             "grad_tolerance_rel": POD_GRAD_TOL,
             "ring_model_wire_bytes_per_step": wire, "per_step": per_step,
             "ms_per_step_after_first": round(sum(
                 e["ms"] for e in per_step[1:]) / (POD_STEPS - 1), 2),
             "launches": {"ssd_chunk": launches}, "dispatch_tiers": tiers,
             "seconds": round(time.perf_counter() - t0, 3)})
        del params, opt
        self.free()

    def start_dryrun_cell(self):
        """``python -m repro_torch.launch.dryrun`` for mamba2-130m x
        train_4k on the production mesh, a CPU subprocess that runs while
        the card works (the dry run counts on meta tensors)."""
        import subprocess
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                   CUDA_VISIBLE_DEVICES="")
        self.dryrun_dir = os.path.join(HERE, "reports", "dryrun_torch")
        self.dryrun_proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "mamba2-130m", "--shape", "train_4k",
             "--report-dir", self.dryrun_dir],
            env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def lm_dryrun(self):
        """The MEMHD dry runs at their defaults on the abstract (16, 16)
        mesh, and the LM cell the subprocess counted; their rooflines."""
        from repro_torch.core.distributed import (
            dryrun_epoch, dryrun_inference,
        )
        from repro_torch.launch.mesh import make_production_mesh
        t0 = time.perf_counter()
        mesh = make_production_mesh()
        reps = {"memhd_epoch": dryrun_epoch(mesh),
                "memhd_inference": dryrun_inference(mesh)}
        for name, rep in reps.items():
            r = rep["roofline"]
            check(r["flops_per_dev"] > 0 and r["useful_flops_ratio"] > 0.2,
                  (name, r["flops_per_dev"], r["useful_flops_ratio"]))
        try:
            out, _ = self.dryrun_proc.communicate(timeout=600)
        finally:
            if self.dryrun_proc.poll() is None:
                self.dryrun_proc.kill()
        check(self.dryrun_proc.returncode == 0, ("dryrun cell", out[-2000:]))
        with open(os.path.join(self.dryrun_dir,
                               "mamba2-130m__train_4k__16x16.json")) as f:
            cell = json.load(f)
        check(cell["status"] == "ok", ("dryrun cell", cell.get("error")))
        reps["mamba2-130m__train_4k"] = {
            k: cell[k] for k in ("roofline", "memory", "grad_accum",
                                 "n_collectives", "count_s")}
        log({"phase": "lm_dryrun", "mesh": "16x16", "reports": reps,
             "seconds": round(time.perf_counter() - t0, 3)})

    def nondeterministic_leaves(self):
        """The gradient leaves that differ between two evaluations of one
        loss on the same smoke params and batch (the ops under them are
        the non-deterministic ones)."""
        import torch
        from repro_torch import generator
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.steps import loss_and_grads
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import tree_leaves
        cfg = get_smoke_config(TRAIN_ARCH)
        p = T.init_params(generator(0, self.dev), cfg, device=self.dev)
        batch = self.lm_batch(cfg, 64, 2)
        names = self.paths(p)
        a = tree_leaves(loss_and_grads(p, cfg, batch)[2])
        b = tree_leaves(loss_and_grads(p, cfg, batch)[2])
        return {n: (x - y).abs().max().item()
                for n, x, y in zip(names, a, b) if not torch.equal(x, y)}

    def lm_kernel_cases(self):
        """The kernels line's rows of the LM kernels: (cases, library)."""
        np, torch = self.np, self.torch
        from repro_torch.kernels import ref
        # The LM kernels: flash_decode at hymba's global layer with the
        # decode_32k context (bf16 cache, every key valid) and ssd_chunk at
        # hymba's chunk (bf16 x, B, C; f32 dt, da, state). The kernels do
        # float32 FMAs: operations at the fp32 rate.
        from repro_torch import generator
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ssd_chunk as sc
        bf, gen = torch.bfloat16, generator(5, self.dev)
        sr = SSD_ROW

        def fd_operands(fr, dtype):
            q = torch.randn((fr["b"], fr["h"], fr["dh"]), generator=gen,
                            device=self.dev).to(dtype)
            k, v = (torch.randn((fr["b"], fr["s"], fr["kv"], fr["dh"]),
                                generator=gen, device=self.dev).to(dtype)
                    for _ in range(2))
            return q, k, v, torch.full((fr["b"],), fr["s"],
                                       dtype=torch.int32, device=self.dev)

        def sdpa_of(q, k, v):
            # scaled_dot_product_attention over the same operands (every
            # key valid): a yardstick, never called by the port.
            mask = torch.ones((k.shape[0], 1, 1, k.shape[1]),
                              dtype=torch.bool, device=self.dev)
            return lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        fr = FD_ROW
        fq, fk, fv, flen = fd_operands(fr, bf)
        # The extra fields of the flash_decode row: the served shape (with
        # SDPA there) and the float32 (SIMT) instance at the row's shape.
        serve = fd_operands(FD_SERVE, bf)
        f32 = fd_operands(fr, torch.float32)
        # And the softcap instances beside them (the row's ms stays the
        # uncapped kernel).
        self.fd_extra = {
            "ms_serve_shape": lambda: fd.flash_decode(*serve),
            "library_ms_serve_shape": sdpa_of(*serve[:3]),
            "ms_f32": lambda: fd.flash_decode(*f32),
            "ms_softcap": lambda: fd.flash_decode(
                fq, fk, fv, flen, softcap=FD_SOFTCAP),
            "ms_serve_shape_softcap": lambda: fd.flash_decode(
                *serve, softcap=FD_SOFTCAP),
            "ms_f32_softcap": lambda: fd.flash_decode(
                *f32, softcap=FD_SOFTCAP)}
        for (name, (q, k, v, ln)), cap in itertools.product(
                (("serve_shape", serve), ("f32", f32),
                 ("row_shape", (fq, fk, fv, flen))), (None, FD_SOFTCAP)):
            err = (fd.flash_decode(q, k, v, ln, softcap=cap).float()
                   - ref.flash_decode(q, k, v, ln, cap).float()).abs()
            want = ref.flash_decode(q, k, v, ln, cap).float()
            tol = (3e-5 + 3e-5 * want.abs() if q.dtype == torch.float32
                   else bf16_ulp(want) + 3e-5)
            check(bool((err <= tol).all()),
                  ("flash_decode", name, cap, err.max().item()))
        self.max_err["flash_decode"] = (
            fd.flash_decode(fq, fk, fv, flen).float()
            - ref.flash_decode(fq, fk, fv, flen).float()).abs().max().item()
        sargs = self.ssd_inputs(np.random.default_rng(18), sr["b"], sr["q"],
                                sr["h"], sr["n"], sr["p"])
        sargs = [a.to(bf) for a in sargs[:3]] + list(sargs[3:])
        (sy, ss), (wy, ws) = sc.ssd_chunk(*sargs), ref.ssd_chunk(*sargs)
        self.max_err["ssd_chunk"] = max(
            (sy.float() - wy.float()).abs().max().item(),
            (ss - ws).abs().max().item())
        sb, sq, sh, sn, sp = (sr[k] for k in ("b", "q", "h", "n", "p"))

        def ssd_bytes(b):  # x, B, C (bf16) in, dt, da, state in, y, state out
            return ssd_nbytes(b, sq, sh, sn, sp, 2)
        cases = [
            ("flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:71",
             lambda: fd.flash_decode(fq, fk, fv, flen),
             lambda: ref.flash_decode(fq, fk, fv, flen),
             bound(2 * (2 * fq.numel() + fk.numel() + fv.numel())
                   + 4 * fr["b"],
                   4 * fr["b"] * fr["h"] * fr["s"] * fr["dh"],
                   FP32_FLOP_PER_S)),
            ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:86",
             lambda: sc.ssd_chunk(*sargs), lambda: ref.ssd_chunk(*sargs),
             ssd_bound(sb, sq, sh, sn, sp, ssd_bytes(sb))),
        ]
        # The ssd_chunk row's extra fields: the forward's batch (B 2), and
        # the bound at the fp32 FMA rate (every product a float32 FMA: the
        # causal triangle (Q(Q+1)/2 entries) of C B^T (2N each) and of its
        # product with x dt (2P each), plus C S and the state update (2QNP
        # each)).
        s2 = self.ssd_inputs(np.random.default_rng(19), SSD_SERVE_B, sq, sh,
                             sn, sp)
        s2 = [a.to(bf) for a in s2[:3]] + list(s2[3:])
        self.ssd_equal(sc.ssd_chunk(*s2), ref.ssd_chunk(*s2), "serve shape")
        fma_ms, fma_by = bound(
            ssd_bytes(sb), sb * sh * (sq * (sq + 1) * (sn + sp)
                                      + 4 * sq * sn * sp), FP32_FLOP_PER_S)
        serve_ms, serve_by = ssd_bound(SSD_SERVE_B, sq, sh, sn, sp,
                                       ssd_bytes(SSD_SERVE_B))
        tr = tuple(SSD_TRAIN[k] for k in ("b", "q", "h", "n", "p"))
        train_ms, train_by = ssd_bound(*tr, ssd_nbytes(*tr, 2))
        train32_ms, train32_by = ssd_bound_f32(*tr, ssd_nbytes(*tr, 4))
        self.ssd_extra = {
            "timed": {"ms_serve_shape": lambda: sc.ssd_chunk(*s2),
                      "plain_ms_serve_shape": lambda: ref.ssd_chunk(*s2)},
            "fields": {"shape_serve": dict(SSD_ROW, b=SSD_SERVE_B),
                       "bound_ms_serve_shape": serve_ms,
                       "bound_by_serve_shape": serve_by,
                       "bound_ms_fp32_fma": fma_ms,
                       "bound_by_fp32_fma": fma_by,
                       "shape_train": SSD_TRAIN,
                       "bound_ms_train_shape": train_ms,
                       "bound_by_train_shape": train_by,
                       "bound_ms_train_shape_f32": train32_ms,
                       "bound_by_train_shape_f32": train32_by}}
        library = {}
        sdpa = sdpa_of(fq, fk, fv)
        try:
            sdpa_err = (sdpa()[:, :, 0].float()
                        - ref.flash_decode(fq, fk, fv, flen).float()
                        ).abs().max().item()
            library["flash_decode"] = sdpa
            log({"phase": "sdpa_yardstick", "max_abs_vs_plain": sdpa_err})
        except (TypeError, RuntimeError) as e:
            log({"phase": "sdpa_yardstick", "unavailable": str(e)[:300]})
        return cases, library

    def sparse_extra(self, tiles, clk_mhz):
        """The am_search_sparse row's other fields at the huge-label shape:
        the gathered entry on this run's gather (checked equal to the
        fused one), k = 5, and the split of a block's SM cycles between
        scoring (tile loads and popcounts) and the selection, from the
        kernel's clock64() stamps (mean over blocks and 5 launches)."""
        from repro_torch.kernels import am_search_sparse as ass
        torch = self.torch
        hq = self.huge["qp"]
        slab, ids, ts, tc = self.huge["layout"]
        short8 = self.huge["short8"]
        mt, d = self.huge["lay"].max_tiles, HUGE["d"]
        gat, gid = ass.gather_shortlist(slab, ids, tiles)
        gid = gid.contiguous()
        fused = ass.am_search_sparse(hq, slab, ids, short8, ts, tc,
                                     n_dims=d, k=1, max_tiles=mt)
        gathered = ass.am_search_sparse_gathered(hq, gat, gid, n_dims=d, k=1)
        check(all(torch.equal(a, b) for a, b in zip(fused, gathered)),
              "sparse gathered != fused at the huge shape")
        clk = torch.stack([ass.phase_clocks(
            hq, slab, ids, short8, ts, tc, n_dims=d, k=1, max_tiles=mt)
            for _ in range(5)]).double()
        score = (clk[..., 1] - clk[..., 0]).mean().item()
        select = (clk[..., 2] - clk[..., 1]).mean().item()
        out = {
            "ms_gathered": time_device_ms(
                lambda: ass.am_search_sparse_gathered(hq, gat, gid, n_dims=d,
                                                      k=1)),
            "gathered_bytes": gat.numel() + 4 * gid.numel(),
            "ms_k5": time_device_ms(lambda: ass.am_search_sparse(
                hq, slab, ids, short8, ts, tc, n_dims=d, k=5, max_tiles=mt)),
            "block_cycles_scoring": score, "block_cycles_selection": select,
            "selection_share": select / (score + select),
            "block_us_at_max_clock": {
                "scoring": score / clk_mhz, "selection": select / clk_mhz}}
        del gat, gid
        return out

    def shortlist_extra(self, sms) -> dict:
        """The am_shortlist row's other fields at the huge-label shape:
        its plan at S = 8 and 16, S = 16's time, one call's route, and at
        each of ``SHORTLIST_BATCHES`` the plan's grid timed against the
        grids the plan makes for a 1-SM device (the fewest G splits: one
        block of all 448 columns per 16-row tile, no merge) and for an
        unbounded one (the narrowest, MIN_SPLIT_COLS columns a split),
        each result checked equal to the plan's."""
        from repro_torch.kernels import am_shortlist as asl
        hq, hspt = self.huge["qp"], self.huge["spt"]
        (hb, hdp), hg, hd = hq.shape, hspt.shape[1], HUGE["d"]
        asl.reset_routes()
        asl.am_shortlist(hq, hspt, n_dims=hd, s=8)
        routes = check_routes(asl, one_route(asl, "tile"), "huge shortlist")
        by_batch = {}
        for b in SHORTLIST_BATCHES:
            q = hq.repeat(-(-b // hb), 1)[:b].contiguous()
            want = asl.am_shortlist(q, hspt, n_dims=hd, s=8)
            row = {}
            for name, n in (("plan", sms), ("one_split", 1),
                            ("narrowest", 1 << 30)):
                got = asl._launch(q, hspt, hd, 8, n)
                check(all(self.torch.equal(a, c)
                          for a, c in zip(got[:2], want)),
                      ("shortlist grid", b, name))
                row[f"splits_{name}"] = asl.launch_plan(
                    b, hdp, hg, 8, n)["splits"]
                row[f"ms_{name}"] = time_device_ms(
                    lambda: asl._launch(q, hspt, hd, 8, n))
            by_batch[b] = row
        return {"plan": asl.launch_plan(hb, hdp, hg, 8, sms),
                "plan_s16": asl.launch_plan(hb, hdp, hg, 16, sms),
                "ms_s16": time_device_ms(lambda: asl.am_shortlist(
                    hq, hspt, n_dims=hd, s=16)),
                "ms_by_batch": by_batch, "routes": routes}

    def imc_extra(self, iq, idep, ideal, ikw) -> dict:
        """am_search_imc on both routes at the row's shape: the noisy
        instance (the row's ``ms``) on the fp32 route, the ideal one (±1
        AM, no offsets, the 16-bit ADC of 128-row arrays) on the int8
        route, where the float operands' bytes bound it."""
        from repro_torch.kernels import am_search_imc as asi
        b, d = iq.shape
        c = ideal.am_analog.shape[0]
        sim = ideal.sim
        kw = dict(tile_rows=sim.arr.rows, tile_cols=sim.arr.cols,
                  adc_bits=sim.adc_bits, adc_clip=sim.clip)
        check(ideal.tile_offsets is None, "the ideal instance has offsets")
        routes = {}
        for name, (am, offsets, args) in (
                ("noisy", (idep.am_analog, idep.tile_offsets, ikw)),
                ("ideal", (ideal.am_analog, None, kw))):
            asi.reset_routes()
            asi.am_search_imc(iq, am.T, offsets, **args)
            routes[name] = asi.route_counts()
        check(routes == {"noisy": one_route(asi, "fp32"),
                         "ideal": one_route(asi, "int8")},
              ("am_search_imc routes", routes))
        ms, by = bound(4 * (b * d + d * c + 2 * b), 2 * b * c * d,
                       INT8_OPS_PER_S)
        return {"routes": routes, "route_of_ms": "fp32",
                "ms_int8_route": time_device_ms(
                    lambda: asi.am_search_imc(iq, ideal.am_analog.T, **kw)),
                "bound_ms_int8_route": ms, "bound_by_int8_route": by}

    def multibit_extra(self, mq, mdep, mkw) -> dict:
        """am_search_multibit's fp32 route at the row's shape: the same
        queries halved (±0.5, not integers), equal to the plain version."""
        from repro_torch.kernels import am_search_multibit as asm
        from repro_torch.kernels import ref
        b, d = mq.shape
        c = mdep.am_planes_t.shape[2]
        half = mq * 0.5
        routes = {}
        for name, qq in (("pm1", mq), ("half", half)):
            asm.reset_routes()
            idx, sim = asm.am_search_multibit(qq, mdep.am_planes_t, **mkw)
            routes[name] = asm.route_counts()
        w_idx, w_sim = ref.am_search_multibit(half, mdep.am_planes_t, **mkw)
        check(self.torch.equal(idx, w_idx) and self.torch.equal(sim, w_sim),
              "am_search_multibit fp32 route != plain")
        check(routes == {"pm1": one_route(asm, "int8"),
                         "half": one_route(asm, "fp32")},
              ("am_search_multibit routes", routes))
        ms, by = bound(4 * b * d + mdep.am_planes_t.numel() + 8 * b,
                       2 * b * c * d, FP32_FLOP_PER_S)
        return {"routes": routes, "route_of_ms": "int8",
                "ms_fp32_route": time_device_ms(
                    lambda: asm.am_search_multibit(half, mdep.am_planes_t,
                                                   **mkw)),
                "bound_ms_fp32_route": ms, "bound_by_fp32_route": by}

    def sgemm_tile_sweep(self, x, w):
        """binary_mvm and encode_pack through every block tile of their
        shared mainloop at the main path's shape (dyadic features: each
        tile's product bit-exact), on a line of its own."""
        from repro_torch.kernels import binary_mvm as bm
        from repro_torch.kernels import encode_fused, ref
        want, want_packed = x @ w, ref.encode_pack(x, w)
        rows = []
        for tile, shape in enumerate(bm.SGEMM_TILES):
            check(self.torch.equal(bm.binary_mvm_tiled(x, w, tile), want),
                  ("binary_mvm tile", shape))
            check(self.torch.equal(encode_fused.encode_pack_tiled(x, w, tile),
                                   want_packed), ("encode_pack tile", shape))
            rows.append({
                "bm_bn_tm_threads_bk": list(shape),
                "grid": list(bm.sgemm_grid(x.shape[0], w.shape[1], tile)),
                "binary_mvm_ms": time_device_ms(
                    lambda: bm.binary_mvm_tiled(x, w, tile)),
                "encode_pack_ms": time_device_ms(
                    lambda: encode_fused.encode_pack_tiled(x, w, tile))})
        log({"phase": "sgemm_tile_sweep", "shape": [*x.shape, w.shape[1]],
             "chosen": list(bm.SGEMM_TILES[bm.SGEMM_TILE]), "tiles": rows})

    # -- phase 12 --------------------------------------------------------------
    def am_search_extra(self, q, am_binary) -> dict:
        """am_search on both routes at the row's shape: the row's ±1
        queries (int8) and dyadic non-integer queries of the same batch
        (fp32, equal to the plain version), checked to take them."""
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import ref
        b, d = q.shape
        c = am_binary.shape[0]
        dy = self.t(self.np.random.default_rng([20, b, d]).integers(
            -128, 128, size=(b, d)).astype("float32") / 256)
        routes = {}
        for name, qq in (("pm1", q), ("dyadic", dy)):
            ams.reset_routes()
            idx, sim = ams.am_search(qq, am_binary.T)
            routes[name] = ams.route_counts()
        w_idx, w_sim = ref.am_search(dy, am_binary.T)
        check(self.torch.equal(idx, w_idx) and self.torch.equal(sim, w_sim),
              "am_search fp32 route != plain")
        check(routes == {"pm1": one_route(ams, "int8"),
                         "dyadic": one_route(ams, "fp32")},
              ("am_search routes", routes))
        ms, by = bound(4 * (b * d + d * c + 2 * b), 2 * b * c * d,
                       FP32_FLOP_PER_S)
        return {"routes": routes, "route_of_ms": "int8",
                "ms_fp32_route": time_device_ms(
                    lambda: ams.am_search(dy, am_binary.T)),
                "bound_ms_fp32_route": ms, "bound_by_fp32_route": by}

    def popcount_extra(self, qp, am_t, sms) -> dict:
        """Popcount mode at every block_b (B = 1024) and at a served
        request's B = 32 (default block_b), with the launch plans."""
        from repro_torch.kernels import am_search_packed as asp
        b, dp = qp.shape
        c = am_t.shape[1]
        d = FULL[2]
        q32 = qp[:32].contiguous()
        ms32, by32 = bound(q32.numel() + am_t.numel() + 8 * 32,
                           2 * 32 * c * d, B1_OPS_PER_S)
        return {
            "ms_by_block_b": {bb: time_device_ms(
                lambda: asp.am_search_packed(qp, am_t, n_dims=d, block_b=bb))
                for bb in asp.BLOCK_B_CHOICES},
            "grid_by_block_b": {bb: asp.launch_plan(
                b, dp, c, bb, "popcount", sms)["grid"]
                for bb in asp.BLOCK_B_CHOICES},
            "ms_b32": time_device_ms(
                lambda: asp.am_search_packed(q32, am_t, n_dims=d)),
            "bound_ms_b32": ms32, "bound_by_b32": by32,
            "plan_b32": asp.launch_plan(32, dp, c, asp.DEFAULT_BLOCK_B,
                                        "popcount", sms)}

    def kernel_line(self):
        np, torch = self.np, self.torch
        from repro_torch import generator
        from repro_torch.core import encoding
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import encode_fused, pack_bits, qail_update
        from repro_torch.kernels import ref

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mma_rates = json.loads(subprocess.run(
            [self.mma_rate_bin], capture_output=True, text=True, check=True,
            timeout=120).stdout)
        clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        popc_rate = sms * POPC_PER_CLK_PER_SM * clk_mhz * 1e6
        b, f, d, c = FULL
        feats = self.t(self.np.round(
            self.ds.test_x[:b].cpu().numpy() * 256) / 256)
        proj = self.model.enc_params["projection"]
        q = encoding.encode_query(self.model.enc_params,
                                  self.model.enc_cfg, feats)
        qp = ref.pack_rows(q)
        am_t = self.deployed.am_packed_t
        dp = qp.shape[1]

        # The training path's shapes: one minibatch of the kernel fit's
        # prebatched data against its final binary AM (a (D, C) view).
        km = self.kmodel
        h = km.encode(self.ds.train_x[:TRAIN_B])
        tq = encoding.binarize_query(h)
        ty = self.ds.train_y[:TRAIN_B].to(torch.int32)
        tmask = torch.ones(TRAIN_B, device=self.dev)
        tam_t = km.am_state["binary"].T
        owners = km.am_state["centroid_class"]
        lr = self.amc.lr
        am_binary = km.am_state["binary"]
        kqp = ref.pack_rows(encoding.encode_query(km.enc_params, km.enc_cfg,
                                                  feats))
        kam_t = km.deploy(target="packed").am_packed_t
        qail_bytes = 4 * (2 * TRAIN_B * d + d * c + c + 2 * TRAIN_B + c * d
                          + 1)

        cases = [
            ("pack_bits", "src/repro_torch/kernels/csrc/pack_bits.cu",
             "src/repro/kernels/pack_bits.py:43",
             lambda: pack_bits.pack_bits(q), lambda: ref.pack_bits(q),
             bound(q.numel() * 4 + q.numel() // 8, q.numel(),
                   FP32_FLOP_PER_S)),
            # Popcount mode: 2*B*C*D AND + popcount ops on the 1-bit
            # tensor cores, at their rate. (The first version's 32-bit
            # popcounts at the SMs' popc rate had a higher floor, logged
            # in "rates".)
            ("am_search_packed",
             "src/repro_torch/kernels/csrc/am_search_packed.cu",
             "src/repro/kernels/am_search_packed.py:167",
             lambda: asp.am_search_packed(qp, am_t, n_dims=d),
             lambda: ref.am_search_packed(qp, am_t, d),
             bound(qp.numel() + am_t.numel() + 8 * b, 2 * b * c * d,
                   B1_OPS_PER_S)),
            ("encode_pack", "src/repro_torch/kernels/csrc/encode_pack.cu",
             "src/repro/kernels/encode_fused.py:97",
             lambda: encode_fused.encode_pack(feats, proj),
             lambda: ref.encode_pack(feats, proj),
             bound(feats.numel() * 4 + proj.numel() * 4 + b * dp,
                   2 * b * f * d, FP32_FLOP_PER_S)),
            ("qail_update", "src/repro_torch/kernels/csrc/qail_update.cu",
             "src/repro/kernels/qail_update.py:97",
             lambda: qail_update.qail_update(tq, h, tam_t, owners, ty,
                                             tmask, lr=lr),
             lambda: ref.qail_update_delta(tq, h, tam_t, owners, ty, tmask,
                                           lr),
             # The fit's operands are integers: int8 sims (the route the
             # kernel takes), so the bytes bound it.
             bound(qail_bytes, 2 * TRAIN_B * c * d, INT8_OPS_PER_S)),
            # ±1 queries against the ±1 AM: the int8 route, where the
            # float operands' bytes bound it.
            ("am_search", "src/repro_torch/kernels/csrc/am_search.cu",
             "src/repro/kernels/am_search.py:88",
             lambda: ams.am_search(q, am_binary.T),
             lambda: ref.am_search(q, am_binary.T),
             bound(4 * (b * d + d * c + 2 * b), 2 * b * c * d,
                   INT8_OPS_PER_S)),
            ("am_search_packed_unpack",
             "src/repro_torch/kernels/csrc/am_search_packed.cu",
             "src/repro/kernels/am_search_packed.py:167",
             lambda: asp.am_search_packed(kqp, kam_t, n_dims=d,
                                          mode="unpack"),
             lambda: ref.am_search_packed_unpack(kqp, kam_t, d),
             bound(kqp.numel() + kam_t.numel() + 8 * b, 2 * b * c * d,
                   INT8_OPS_PER_S)),
        ]
        # The device-fidelity kernels at their paths' shapes: the entry
        # points' operands, the noisy imc instance (float AM, offsets,
        # 6-bit ADC) and the 4-bit multibit deployment.
        from repro_torch.kernels import am_search_imc as asi
        from repro_torch.kernels import am_search_multibit as asm
        from repro_torch.kernels import binary_mvm as bm
        efeats, eproj, rows_t = self.entry_operands
        iq, idep, ideal = self.imc_operands
        isim = idep.sim
        ikw = dict(tile_rows=isim.arr.rows, tile_cols=isim.arr.cols,
                   adc_bits=isim.adc_bits, adc_clip=isim.clip)
        mq, mdep = self.multibit_operands
        mkw = dict(cell_bits=4, tile_rows=128, tile_cols=128, adc_bits=16)
        gd, gc = idep.tile_offsets.shape
        cases += [
            ("binary_mvm", "src/repro_torch/kernels/csrc/binary_mvm.cu",
             "src/repro/kernels/binary_mvm.py:47",
             lambda: bm.binary_mvm(efeats, eproj),
             lambda: ref.binary_mvm(efeats, eproj),
             bound(4 * (b * f + f * d + b * d), 2 * b * f * d,
                   FP32_FLOP_PER_S)),
            ("unpack_bits", "src/repro_torch/kernels/csrc/pack_bits.cu",
             "src/repro/kernels/pack_bits.py:68",
             lambda: pack_bits.unpack_bits(rows_t),
             lambda: ref.unpack_bits(rows_t),
             bound(rows_t.numel() * (1 + 32), rows_t.numel() * 8,
                   FP32_FLOP_PER_S)),
            # The AM carries conductance noise: float operands, fp32 rate.
            ("am_search_imc", "src/repro_torch/kernels/csrc/am_search_imc.cu",
             "src/repro/kernels/am_search_imc.py:120",
             lambda: asi.am_search_imc(iq, idep.am_analog.T,
                                       idep.tile_offsets, **ikw),
             lambda: ref.am_search_imc(iq, idep.am_analog.T,
                                       offsets=idep.tile_offsets, **ikw),
             bound(4 * (b * d + d * c + gd * gc + 2 * b), 2 * b * c * d,
                   FP32_FLOP_PER_S)),
            # ±1 queries against small integer codes: exact in int8.
            ("am_search_multibit",
             "src/repro_torch/kernels/csrc/am_search_multibit.cu",
             "src/repro/kernels/am_search_multibit.py:138",
             lambda: asm.am_search_multibit(mq, mdep.am_planes_t, **mkw),
             lambda: ref.am_search_multibit(mq, mdep.am_planes_t, **mkw),
             bound(4 * b * d + mdep.am_planes_t.numel() + 8 * b,
                   2 * b * c * d, INT8_OPS_PER_S)),
        ]
        # The hierarchical kernels at the huge-label shape (B = 256,
        # C = 100,000, D = 1024, G = 448, S = 8, k = 1). ±1 operands, exact
        # in int8: operations at the int8 tensor-core rate. The sparse
        # search's work depends on this run's shortlists: the operations
        # count the valid columns its queries search, the bytes each slab
        # tile they touch once.
        from repro_torch.kernels import am_search_sparse as ass
        from repro_torch.kernels import am_shortlist as asl
        hq, hspt, hlay = self.huge["qp"], self.huge["spt"], self.huge["lay"]
        slab, ids, ts, tc = self.huge["layout"]
        short8 = self.huge["short8"]
        hb, hdp = hq.shape
        hg, hs, hd = hspt.shape[1], short8.shape[1], HUGE["d"]
        mt = hlay.max_tiles
        tiles = ass.expand_shortlist_tiles(short8, ts, tc, max_tiles=mt,
                                           null_tile=hlay.null_tile)
        cols = (tiles[:, :, None] * 128 + torch.arange(
            128, device=self.dev)).reshape(hb, -1)
        valid = int((ids[cols] >= 0).sum().item())
        touched = int(torch.unique(tiles).numel())
        self.hier_work = {"valid_columns_searched": valid,
                          "slab_tiles_touched": touched,
                          "slots_per_query": hs * mt * 128}
        sq, sspt, sg = self.hier_served
        cases += [
            # The tile route scores on the 1-bit tensor cores: operations
            # at their rate, against the bytes of the operands and the
            # (B, S) int32 ids and float32 sims.
            ("am_shortlist", "src/repro_torch/kernels/csrc/am_shortlist.cu",
             "src/repro/kernels/am_shortlist.py:127",
             lambda: asl.am_shortlist(hq, hspt, n_dims=hd, s=hs),
             lambda: ref.am_shortlist(hq, hspt, hd, hs),
             bound(hb * hdp + hdp * hg + hb * hs * 8, 2 * hb * hg * hd,
                   B1_OPS_PER_S)),
            ("am_shortlist_served",
             "src/repro_torch/kernels/csrc/am_shortlist.cu",
             "src/repro/kernels/am_shortlist.py:127",
             lambda: asl.am_shortlist(sq, sspt, n_dims=d, s=sg),
             lambda: ref.am_shortlist(sq, sspt, d, sg),
             bound(sq.numel() + sspt.numel() + sq.shape[0] * sg * 8,
                   2 * sq.shape[0] * sg * d, B1_OPS_PER_S)),
            ("am_search_sparse",
             "src/repro_torch/kernels/csrc/am_search_sparse.cu",
             "src/repro/kernels/am_search_sparse.py:140",
             lambda: ass.am_search_sparse(hq, slab, ids, short8, ts, tc,
                                          n_dims=hd, k=1, max_tiles=mt),
             lambda: ass.am_search_sparse_plain(hq, slab, ids, short8, ts,
                                                tc, n_dims=hd, k=1,
                                                max_tiles=mt),
             bound(touched * 128 * (hdp + 4) + hb * hdp + hb * hs * 4
                   + 2 * hg * 4 + hb * 8, 2 * valid * hd, INT8_OPS_PER_S)),
        ]
        library = {"binary_mvm": lambda: torch.matmul(efeats, eproj)}
        self.sgemm_tile_sweep(efeats, eproj)
        lm_cases, lm_library = self.lm_kernel_cases()
        cases += lm_cases
        library.update(lm_library)
        floor_lib = ctypes.CDLL(self.floor_so)
        floor_lib.empty_launch.argtypes = [ctypes.c_void_p]
        floor_lib.empty_launch.restype = ctypes.c_int
        floor_ms = time_device_ms(lambda: floor_lib.empty_launch(
            torch.cuda.current_stream().cuda_stream))
        self.path_launches["am_shortlist_served"] = self.path_launches[
            "am_shortlist"]
        out = []
        for name, src, replaces, kern, plain, (bound_ms, bound_by) in cases:
            ms = time_device_ms(kern)
            plain_ms = time_device_ms(plain, samples=21, calls=2)
            if name in self.path_launches:
                launches = self.path_launches[name]
            else:
                launches = (self.train_launches if name in NEW_KERNELS
                            else self.launches)[name]
            lib_ms = (time_device_ms(library[name]) if name in library
                      else None)
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "launch_floor_ms": floor_ms})
        row = out[[r["name"] for r in out].index("flash_decode")]
        row.update({k: time_device_ms(fn) for k, fn in self.fd_extra.items()})
        row["shape_serve"] = FD_SERVE
        row["softcap"] = FD_SOFTCAP
        if self.families_launches:
            row.setdefault("launches_by_path", {})["lm_families"] = (
                self.families_launches)
        rows = {r["name"]: r for r in out}
        rows["ssd_chunk"].setdefault("launches_by_path", {})[
            "lm_train"] = self.train_launches_lm
        rows["ssd_chunk"]["launches_by_path"]["lm_sharded"] = \
            self.pod_launches
        rows["ssd_chunk"]["launches_by_path"]["lm_mixed"] = \
            self.mixed_launches
        for name in ("flash_decode", "ssd_chunk"):
            rows[name].setdefault("launches_by_path", {})["lm_reverse"] = \
                self.reverse_launches[name]
        rows["flash_decode"].setdefault("launches_by_path", {})[
            "lm_sharded"] = self.sp_launches
        # Launches on this slice's paths, beside each row's own path.
        for name, path, counts in (
                ("binary_mvm", "baselines", self.baseline_launches),
                ("am_search", "baselines", self.baseline_launches),
                ("qail_update", "online", self.online_launches),
                ("am_search_packed", "online", self.online_launches),
                ("pack_bits", "online", self.online_launches),
                ("qail_update", "fit_sharded", self.fit_sharded_launches),
                *((name, "sharded", self.sharded_launches)
                  for name in self.sharded_launches)):
            rows[name].setdefault("launches_by_path", {})[path] = counts[
                name]
        # The autotuned kernels: the committed configuration beside the
        # default the row's ms is timed at.
        tuned = self.tuned
        for name, fn in (
                ("am_search_packed", lambda: asp.am_search_packed(
                    qp, am_t, n_dims=d, block_b=tuned["am_search_packed"])),
                ("qail_update", lambda: qail_update.qail_update(
                    tq, h, tam_t, owners, ty, tmask, lr=lr,
                    block_b=tuned["qail_update"])),
                ("encode_pack", lambda: encode_fused.encode_pack_tiled(
                    feats, proj, tuned["encode_pack"]))):
            rows[name].update({"tuned": tuned[name],
                               "ms_tuned": time_device_ms(fn)})
        rows["am_search"].update(self.am_search_extra(q, am_binary))
        rows["am_search_packed"].update(self.popcount_extra(qp, am_t, sms))
        row = out[[r["name"] for r in out].index("am_search_packed_unpack")]
        row["ms_by_block_b"] = {
            bb: time_device_ms(lambda: asp.am_search_packed(
                kqp, kam_t, n_dims=d, mode="unpack", block_b=bb))
            for bb in asp.BLOCK_B_CHOICES}
        row = out[[r["name"] for r in out].index("am_search_sparse")]
        row.update(self.sparse_extra(tiles, clk_mhz))
        rows["am_shortlist"].update(self.shortlist_extra(sms))
        rows["am_shortlist_served"]["plan"] = asl.launch_plan(
            sq.shape[0], sq.shape[1], sg, sg, sms)
        for name, n in (("pack_bits", q.numel() // 8),
                        ("unpack_bits", rows_t.numel())):
            rows[name]["plan"] = pack_bits.launch_plan(n, sms)
        rows["am_search_imc"].update(self.imc_extra(iq, idep, ideal, ikw))
        rows["am_search_multibit"].update(self.multibit_extra(mq, mdep, mkw))
        row = out[[r["name"] for r in out].index("ssd_chunk")]
        row.update({k: time_device_ms(fn, **({"samples": 21, "calls": 2}
                                             if k.startswith("plain") else {}))
                    for k, fn in self.ssd_extra["timed"].items()})
        row.update(self.ssd_extra["fields"])
        # qail_update once more on random targets at the training shape:
        # the trained AM's batch above has no misses, so there the delta
        # pass adds nothing. The bound is the same (the same bytes).
        rq = self.qail_operands(np.random.default_rng([1234, TRAIN_B, d, c]),
                                TRAIN_B, d, c, tie=False, dyadic=False)
        # The fp32 route: the trained AM view under conductance noise (a
        # float view, as noise-aware QAIL scores), checked to take it.
        noisy = tam_t + 0.05 * torch.randn(
            tam_t.shape, generator=generator(6, self.dev), device=self.dev)
        routes = {}
        for name, args in (("trained", (tq, h, tam_t, owners, ty, tmask)),
                           ("random_targets", rq[:-1]),
                           ("noisy", (tq, h, noisy, owners, ty, tmask))):
            qail_update.reset_routes()
            dl, nm = qail_update.qail_update(*args, lr=lr)
            routes[name] = qail_update.route_counts()
            check(bool(torch.isfinite(dl).all()), ("qail delta", name))
        check(routes == {"trained": {"int8": 1, "fp32": 0},
                         "random_targets": {"int8": 1, "fp32": 0},
                         "noisy": {"int8": 0, "fp32": 1}},
              ("qail_update routes", routes))
        row = out[[r["name"] for r in out].index("qail_update")]
        row.update({
            "routes": routes, "route_of_ms": "int8",
            "bound_ms_fp32_route": bound(qail_bytes, 2 * TRAIN_B * c * d,
                                         FP32_FLOP_PER_S)[0],
            "bound_by_fp32_route": bound(qail_bytes, 2 * TRAIN_B * c * d,
                                         FP32_FLOP_PER_S)[1],
            "ms_fp32_route": time_device_ms(lambda: qail_update.qail_update(
                tq, h, noisy, owners, ty, tmask, lr=lr)),
            "n_miss": qail_update.qail_update(tq, h, tam_t, owners, ty,
                                              tmask, lr=lr)[1].item(),
            "n_miss_random_targets":
                qail_update.qail_update(*rq[:-1], lr=rq[-1])[1].item(),
            "ms_random_targets": time_device_ms(
                lambda: qail_update.qail_update(*rq[:-1], lr=rq[-1])),
            "plain_ms_random_targets": time_device_ms(
                lambda: ref.qail_update_delta(*rq), samples=21, calls=2),
            "ms_random_targets_by_block_b": {
                bb: time_device_ms(lambda: qail_update.qail_update(
                    *rq[:-1], lr=rq[-1], block_b=bb))
                for bb in qail_update.BLOCK_B_CHOICES}})
        log({"phase": "rates", "sms": sms, "max_sm_clock_mhz": clk_mhz,
             "popc_per_s": popc_rate,
             "packed_search_simt_popc_floor_ms": b * c * -(-dp // 4)
                                                 / popc_rate * 1e3,
             "mma_rate": mma_rates,
             "int8_ops_per_s": INT8_OPS_PER_S,
             "b1_ops_per_s": B1_OPS_PER_S,
             "bf16_flop_per_s": BF16_FLOP_PER_S,
             "tf32_flop_per_s": TF32_FLOP_PER_S,
             "fp32_flop_per_s": FP32_FLOP_PER_S,
             "fp32_flop_per_s_from_clock": sms * 128 * 2 * clk_mhz * 1e6,
             "hbm_bytes_per_s": HBM_BYTES_PER_S,
             "shapes": {"B": b, "f": f, "D": d, "C": c,
                        "B_train": TRAIN_B,
                        "hier": {"B": HUGE["batch"], "C": HUGE["c"],
                                 "D": HUGE["d"], "G": HUGE["g"], "S": 8,
                                 "k": 1, **self.hier_work},
                        "flash_decode": FD_ROW, "ssd_chunk": SSD_ROW}})
        log({"kernels": out})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of build,kernels,main,train,fidelity,"
                         "hier,baselines,online,autotune,sharded,"
                         "fit_sharded,lm,lm_families,lm_train,lm_sharded,"
                         "lm_mixed,lm_reverse,robustness,"
                         "cli,trainer,repro "
                         "(development runs; train, fidelity, hier, "
                         "baselines, online and fit_sharded need main, "
                         "autotune needs main and train, sharded main, "
                         "fidelity and hier; the kernels line needs "
                         "kernels, main, train, fidelity, hier, baselines, "
                         "online, autotune, sharded, fit_sharded, lm, "
                         "lm_families, lm_train, lm_sharded, lm_mixed and "
                         "lm_reverse)")
    args = ap.parse_args()
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository: src/repro_torch not found")
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    gpu = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log(gpu)
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "kind": kind,
         "count": torch.cuda.device_count()})
    phases = (["build", "kernels", "main", "train", "fidelity", "hier",
               "baselines", "online", "autotune", "sharded", "fit_sharded",
               "lm", "lm_families", "lm_train", "lm_sharded", "lm_mixed",
               "lm_reverse", "robustness", "cli", "trainer", "repro"]
              if args.phases == "all" else args.phases.split(","))
    smoke = Smoke()
    t0 = time.perf_counter()
    smoke.build()
    if "kernels" in phases:
        smoke.check_kernels()
    if "main" in phases:
        smoke.main_path()
    if "train" in phases:
        smoke.train_path()
        smoke.train_dyadic()
    if "fidelity" in phases:
        smoke.entry_points()
        smoke.imc_path()
        smoke.multibit_path()
    if "hier" in phases:
        smoke.hier_path()
        smoke.hier_huge()
    if "baselines" in phases:
        t_ph = time.perf_counter()
        smoke.baselines()
        log({"phase": "baselines_group",
             "seconds": round(time.perf_counter() - t_ph, 3)})
    if "online" in phases:
        t_ph = time.perf_counter()
        smoke.online()
        log({"phase": "online_group",
             "seconds": round(time.perf_counter() - t_ph, 3)})
    for name in ("autotune", "sharded", "fit_sharded"):
        if name in phases:
            t_ph = time.perf_counter()
            getattr(smoke, name)()
            log({"phase": f"{name}_group",
                 "seconds": round(time.perf_counter() - t_ph, 3)})
    if "autotune" in phases:
        smoke.dispatched_batches()
    if "lm" in phases:
        t_lm = time.perf_counter()
        smoke.check_lm_kernels()
        smoke.lm_setup()
        smoke.lm_forward()
        smoke.lm_serve()
        smoke.lm_cli()
        log({"phase": "lm_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "lm_families" in phases:
        t_lm = time.perf_counter()
        log({"phase": "lm_families_start",
             "device_bytes": torch.cuda.memory_allocated()})
        smoke.lm_deepseek_f32()
        smoke.lm_deepseek_serve()
        smoke.lm_deepseek_v3()
        smoke.lm_modalities()
        smoke.lm_quant()
        log({"phase": "lm_families_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "lm_train" in phases:
        t_lm = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        smoke.lm_train_mamba2()
        smoke.lm_train_grads()
        smoke.lm_train_hymba()
        smoke.lm_train_deepseek()
        smoke.lm_train_v3()
        smoke.lm_train_resume()
        log({"phase": "lm_train_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "lm_sharded" in phases:
        t_lm = time.perf_counter()
        smoke.start_dryrun_cell()
        try:
            smoke.lm_seq_parallel()
            smoke.lm_expert_parallel()
            smoke.lm_pod_train()
            smoke.lm_dryrun()
        finally:
            if smoke.dryrun_proc.poll() is None:
                smoke.dryrun_proc.kill()
        log({"phase": "lm_sharded_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "lm_mixed" in phases:
        t_lm = time.perf_counter()
        smoke.lm_mixed()
        log({"phase": "lm_mixed_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "lm_reverse" in phases:
        t_lm = time.perf_counter()
        smoke.lm_reverse_serve()
        smoke.lm_reverse_train()
        smoke.lm_reverse_deepseek()
        smoke.lm_reverse_quant()
        log({"phase": "lm_reverse_group",
             "seconds": round(time.perf_counter() - t_lm, 3)})
    if "robustness" in phases:
        smoke.robustness()
    if "cli" in phases:
        smoke.cli()
        smoke.examples()
    if "trainer" in phases:
        smoke.trainer()
    if "repro" in phases:
        smoke.reproducibility()
    if all(p in phases for p in ("kernels", "main", "train", "fidelity",
                                 "hier", "baselines", "online", "autotune",
                                 "sharded", "fit_sharded", "lm",
                                 "lm_families", "lm_train", "lm_sharded",
                                 "lm_mixed", "lm_reverse")):
        smoke.kernel_line()
    log({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    log(gpu)
    if args.phases != "all":
        log({"partial_run": phases})  # a development run proves nothing
        return
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
