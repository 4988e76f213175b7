#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--tokens N] [--iters I] [--out FILE]

(I ≥ 4, 4 by default.)

Phases, in order; any failure exits non-zero:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Every kernel of the paths is built from the sources in this
   checkout (``nvcc``, one process per source, started together) and held
   to its plain-PyTorch twin on the card:
   - ``sample_fused`` at the dense path's shape (65,536 survivor tokens
     whose rows are gathered from NYTimes-sized D and Ŵ at K = 1000) and
     at edge shapes (K in {1, 2, 33, 37, 1000, 1024, 1025}, N in {1,
     129}, tied maxima, K1 the last topic, draws with u near 1), fed the
     words' K1, a1 and Q';
   - ``sample_fused_tiled`` and ``sample_sparse_tiled`` bitwise against
     their untiled kernels, and against their twins;
   - ``sample_sparse`` at edge shapes, the Q' branch finished in the
     kernel: K in {37, 1000, 1025}, L in {1, 37, 421}, rows with empty
     slots, live prefixes ending on and beside 32-slot steps, K1 absent
     from the row, u near 1, and L = 58,113 slots at K = 60,000;
   - ``vose_build`` bitwise against its twin (``mh.run_vose`` on
     ``mh.alias_queues``), with the queues built in the kernel (the main
     path's ``vose_tables``) and read (the reference's signature), on
     edge rows (all-equal weights, one dominant weight, one tiny weight;
     K in {1, 37, 1000, 1025}); ``warp_chain`` bitwise against its twin
     for topics and accepted counts (K in {1, 37, 1000, 1025}, N in {1,
     129, 4096}, uniforms within 2^-16 of 1), on the main path's streams
     with the doc proposals drawn inside (docs of one token, padding) and
     on compact streams with them given, each tiled launch bitwise
     against its untiled one.
   - the cap shapes, each just below and just past where one block's
     shared memory held its rows: the count rebuild at K = 58,100 and
     58,101 (the sorted and the any-order ``histogram`` kernel),
     ``sample_fused`` and its tiled launch at K = 25,824 and 25,825,
     both ``vose_build`` entries at K = 29,056 and 29,057, and the main
     path's chain on tables of K = 29,057.
   Masses agree within rtol 1e-5 (S' of the dense draw also within 1e-6
   of the token's total mass: it subtracts a1·b1 and can cancel); draws
   differ on at most 0.1% of tokens (of draws spread over [0, 1)), each
   within 1e-5 of the total mass of a CDF boundary (for the sparse draw:
   M, a live slot, the S'|Q' split, or a Q' topic). One fused iteration
   of the dense and the paper path on a small corpus runs on the card
   and on the CPU with the same uniforms and must agree the same way.
   Then the LM substrate (``lm``; it needs no corpus, so it runs before
   one is built), at the full published width of ``qwen1.5-0.5b`` (24
   layers, d_model 1,024, 16 heads, d_ff 2,816, vocab 151,936 padded to
   153,600, bf16) with random weights from the seed:
   (a) ``train_lm(reduced=False, steps=3, seq_len=4096, global_batch=4,
   log_every=1)``: ``SHAPES["train_4k"]``'s length, its batch of 256 cut
   to 4; every step's loss, seconds and tokens/s, the peak device memory
   and the model TFLOP/s (6·N·tokens plus the attention
   ``flash_attention`` computes, every block pair); every loss finite,
   step 1's within 1.0 of ln(153,600), the last below the first;
   (b) from an empty cache of max_len 4,096, batch 8: 8 prompt tokens,
   then 24 greedy tokens through ``make_serve_step`` (ms a token, the
   cache's bytes); ``length`` 32, every logit below ``vocab_size``
   finite; (c) with ``param_dtype="float32"``, B = 2, T = 16: each
   decoded position's logits equal ``forward_train``'s within rtol/atol
   2e-2; (d) ``reduced_config`` in float32, the same weights and batch:
   one ``train_step`` on the card gives the CPU's loss within rtol 1e-5
   and its grad norm within 1e-4; (e) one step of (a)'s shape through
   ``make_train_step`` under ``FlopCounterMode`` against its plan on the
   meta device (``launch/dryrun.py::plan_step``, made by a spawned
   process on the host beside the corpus build, and held to before the
   first LDA path): the FLOPs must be equal, the planned peak is printed
   beside ``max_memory_allocated`` (predicted within PLAN_PEAK_BAND),
   with the H100 roofline terms, the dominant one and (a)'s step's model
   FLOP/s as a share of 989 TFLOP/s. The
   substrate has no ``pallas_call`` and launches none of the counted
   kernels.
   Then the LM substrate's other families (``lm_families``), each at
   its published width, bf16, random weights from the seed:
   mamba2-370m (SSM), zamba2-1.2b (hybrid: 6 groups of 6 Mamba2 layers
   and one shared attention block, then 2), deepseek-moe-16b (MoE, 64
   experts top 6 and 2 shared), minicpm3-4b (MLA) and whisper-base
   (encoder-decoder): (a) ``train_lm(reduced=False, steps=3,
   seq_len=4096, global_batch=2, lr=3e-5)`` (whisper: 4,096 frames, 448
   decoder tokens), depth cut only where the train state (36 B a param
   plus one layer's float32 scores) passes 64 GiB: deepseek-moe-16b 2
   of 28 layers, minicpm3-4b 22 of 62; the prints of ``lm``'s (a), the
   params built beside ``param_count()``, TFLOP/s counted with MoE's
   ``active_param_count()``, no untied embedding table and the SSD chunk
   products; finite losses, step 1 within 1.0 of ln(padded vocab) and
   equal to the initial weights' loss on its batch, and steps 2-3 below
   the initial weights' losses on the same batches on average; (b) all
   layers, from an empty cache, batch 4: 8 prompt and 16 greedy tokens
   (ms a token, the prompt's ms a step, the cache's bytes: the SSM state
   and conv rows, zamba2's 6 shared-attention KV slots of 4,096, the
   compressed MLA cache of 4,096, whisper's cross K/V filled from 4,096
   frames by ``encdec.fill_cross_cache`` and 448 self slots); (c) and
   (d) as ``lm``'s, granite-moe-3b-a800m (40 experts padded to 48)
   included, (c) cut in depth only past 20 GB of float32 weights
   (deepseek-moe-16b: 7 of 28 layers). It launches none of the counted
   kernels, and frees the card before the corpus is built.
   Then the sharded LM (``lm_sharded``): four spawned ranks share the
   card in one gloo group (each its CUDA tensors; four ranks on one card
   are no scaling number), the one-device runs of the same inits and
   batches made first by this process: (a) qwen1.5-0.5b at its full
   width and depth, bf16, a step of 4 × 512 tokens, through
   ``train_lm`` on (1, 4) and through ``make_train_step`` on (2, 2)
   (tensor-parallel, ZeRO-1); (b) deepseek-moe-16b at full width, 1 of
   28 layers, one step on (2, 2) under each of ``tp`` (the all-to-all
   over ``model``), ``ep`` (over every axis), ``dp`` and ``fsdp`` (the
   rows resharded to the data shard's, the all-to-all over ``model``),
   4 × 128 tokens, at capacity factor 11 = ⌈E/k⌉, where no expert and no
   all-to-all bucket can overflow; (c) deepseek-coder-33b at full width,
   2 of 62 layers, on (1, 16): sixteen more spawned ranks of their own
   (56 query heads split a head, 8 KV heads do not divide 16: the
   sequence-parallel attention), its prefill of 16 positions and a
   prompt token and a greedy one, then one train step of 2 × 1,024 from
   the same weights, and what the ranks cost (seconds to the group, host
   memory, the card's memory with every context up); rank 0's step is
   held to its meta-device plan (FLOPs equal, the planned peak beside
   ``max_memory_allocated``, the H100 roofline terms); (d) a reduced
   float32 sharded
   step on the card == the same step on the CPU, on (2, 2); (e)
   qwen1.5-0.5b's prefill, then a prompt token and a greedy one, through
   ``make_prefill_step`` and ``make_serve_step`` from a 4,096-slot cache
   at batch 8 on (2, 2) (ZeRO-1 param blocks gathered over data a layer
   at a time, the cache's sequence over ``model``: the distributed
   flash-decode), and a prefill and a token at batch 1 on (1, 4); (f)
   deepseek-moe-16b's layer in float32, one decode step at batch 8 (the
   replicated-activation expert route); (g) one ``train_lm`` step of 4 ×
   256 tokens and a prefill and decode step at batch 4 from 1,024 slots
   for mamba2-370m (12 of 48 layers), zamba2-1.2b (7 of 38 layers, no
   prefill), minicpm3-4b (2 of 62 layers) and whisper-base (its cross
   cache filled from 1,024 frames), each on (2, 2); (h) one
   qwen1.5-0.5b step (12 of 24 layers) under the fsdp policy; (i) this
   slice's new paths on a reduced float32 config, the card == the CPU on
   the same blocks: 3 query heads on 2 (a step and a decode step), the
   dp policy's MoE and 3 expert stacks on 2. Every loss and grad norm
   against the one-device port's (bf16: losses within rtol 1e-2, grad norms
   5e-2; (d) 1e-5 and 1e-4), every decode and prefill's logits within
   5e-2 of the largest of one device's (teacher-forced on its tokens;
   (i) 1e-4), with each rank's seconds a step or a token, peak and
   collective bytes by kind.
3. One planted corpus in the NYTimes shape (M = 299,752 docs, V =
   101,636 words, ~100 M tokens, made from the seed, relabeled by
   frequency; 4,096 more documents of the same planted topics are held
   out for serving), and four paths on it, each through
   ``LDAEngine(corpus, LDAConfig(n_topics=1000, ..., fused=True,
   eval_every=1)).fit(I)``:
   - the dense path (``format="dense"``, ``balance="none"``);
   - the paper's configuration: ``format="hybrid"``,
     ``tail_sampler="sparse"``, ``balance="tiles"``;
   - warp_paper: ``sampler="warp"``, ``format="hybrid"``,
     ``balance="tiles"`` (the tiled chain), I iterations;
   - warp_dense: ``sampler="warp"``, ``balance="none"`` (the untiled
     chain), 2 iterations.
   Launch counts are zeroed just before each path and read just after;
   each path must launch its kernels (the ``histogram`` count rebuild
   builds every path's initial counts), keep its state on the card and
   its counts equal to the token count, and raise LLPT. The paper path's
   LLPT must stay within 0.02 of the dense path's after every iteration,
   and its tail tokens may not pile onto topic K−1. The hybrid sparse
   path with ``balance="none"`` (hybrid_none) runs 2 iterations as well
   (a digest after 1 too, for phases 8-9):
   ``sample_sparse``'s untiled route (the paper path's tail tiles fit
   their window), and the digest phase 8 holds dist_hybrid to. A warp
   path's share of tokens that
   accepted a proposal must lie in (0, 1) every iteration.
4. Each kernel is held to its twin, and timed against its bound, on the
   tokens its path hands it next: ``sample_fused`` on the dense path's
   next chunk, and phase 2 over all survivors with its compaction; the
   paper path's head and tail kernels (the tail's share of Q' draws
   printed, its bound counted from the live slots read); ``histogram``'s
   sorted route on the dense path's ~100 M-token W and D rebuilds, in
   turns with the any-order route and beside ``torch.bincount``, bitwise
   against both and ``index_put_``, plus a stream of split rows, and the
   any-order route on rows that overflow the tiles' windows and on an
   unsorted stream; the table build on the warp path's W̃ and the chain
   on its tokens, each beside the stages it absorbed (the queues' sort;
   the doc proposals and the gathers). One more iteration of each path is
   timed stage by stage with CUDA events.
5. Checkpoints and serving, on a path's state after its ``fit``:
   - resume, on the dense and on the paper path: ``engine.save()`` into
     a temporary directory, a fresh engine on the same corpus
     ``resume()``s it, and its topics, D and W must be bitwise the live
     engine's, and again after one more iteration on both; save, build
     and resume times, the file size and the launches are printed;
   - serving, from the dense path: ``export()``; ``from_payload`` and a
     ``save``/``load`` round trip must give W bitwise; 4 requests of
     1,024 held-out documents, 20 sweeps each, through
     ``FrozenLDAModel.fold_in`` on the card (docs/s, tokens/s, fold-in LLPT beside ``engine.score()``,
     the skip fraction of each sweep); launch counts zeroed just before
     the requests and read just after must be 80 of ``sample_fused`` and
     84 of ``histogram`` (one initial D a request); then one sweep's
     ``sample_fused`` launch is held to its twin under the rule above
     and its batch-D ``histogram`` launch bitwise, each timed beside its
     bound.
   - the serving tier (``repro_torch.serve``), on the same model:
     ``LDAService`` with 2 replicas sharing the card, the hot head sized
     to 90% of the training tokens (``hot_coverage=0.9``), 2 sweeps with
     the alias warm start; the 4,096 held-out docs submitted one request
     each (docs/s, p50/p95/p99 ms, cache hit rate, batch fill, launches
     of ``sample_fused``, ``histogram`` and ``vose_tables``); then a
     cached replica's θ and LLPT bitwise a full-table replica's on the
     same batch and seed, one more training iteration with the service
     attached (``serve.attach``) whose refreshed answers are bitwise a
     service built fresh from a freeze of the last snapshot, and replica
     0 killed mid-traffic with every request still answered.
   The checkpoint and model files live in a temporary directory outside
   the checkout, removed at the end.
6. Streamed and disk-native residency, on the same corpus at K = 1000,
   ``fused=True``, ``eval_every=1``, I iterations each (digests of the
   resident dense and paper paths' topics, D and W are taken right after
   their ``fit``; both keep one after 2 iterations as well, for phase
   7's shorter drills and disk_paper, and the dense path one after 1 for
   phases 8-9, their fits run in several calls with the digests between
   them):
   - streamed_dense: ``corpus_residency="streamed"``, 8 shards; topics,
     D, W and every iteration's LLPT bitwise the dense path's;
   - the mid-epoch resume on streamed_dense: ``run_shards(3)``,
     ``save()``, a fresh engine ``resume()``s it, both finish the epoch
     and must agree bitwise;
   - streamed_paper: the paper's configuration over 8 shards, bitwise
     the paper path;
   - disk_paper: ``ShardedCorpus.to_store`` of the same stream (8 shards,
     ``multiple=tile_size``) into the temporary directory, then
     ``LDAEngine(None, LDAConfig(..., corpus_residency="disk",
     corpus_path=...)).fit(2)``, bitwise the paper path after 2 (W
     paged by shard, tiles off: tiled == untiled; 2 epochs, not I, for
     the script's time).
   Each prints its seconds per epoch and per shard, the H2D and D2H
   bytes and the seconds ``take()`` blocked an epoch, its peak device
   memory beside its resident path's, ``last_epoch_device_bytes``,
   ``page_rows`` (disk), the store's bytes and write seconds, and its
   launches; ``sample_fused`` (streamed_dense, disk_paper),
   ``sample_fused_tiled`` and ``sample_sparse_tiled`` (streamed_paper),
   ``sample_sparse`` (disk_paper) and ``histogram``'s any-order route
   (every run's shard-by-shard count fold) must each launch.
7. The failure model, after the warp paths, on the same corpus; each drill
   goes through ``LDAEngine.fit(supervise=SupervisePolicy(...))`` under a
   ``runtime/chaos.py`` plan, prints its ``RestartReport`` and launches,
   and must end bitwise the path it replays (topics, D, W and every LLPT
   it evaluated); every path times its chunks through ``fit``'s own
   ``on_chunk``:
   - supervised_dense: no fault, checkpoints every 2 iterations; seconds
     per iteration (the chaos check and the chunk) beside the
     unsupervised dense path's, and the fit wall split into chunks,
     saves and the rest beside the unsupervised one; one dense
     ``selfcheck`` timed, then D[0, k] − 1 on the card must trip
     ``token_conservation``;
   - paper_killed: the paper path with ``selfcheck=True``, killed at step
     3: one restart, resumed from 2; recovery, checkpoint load and restore
     seconds; the packed ``selfcheck`` timed, colsum[0] − 1 must trip it;
   - streamed_killed: streamed_dense for 2 iterations, checkpoints every
     4 shards, killed at (iteration 1, shard 5): resumed from 1 inside
     the open epoch, bitwise the dense path after 2; mid-epoch and
     boundary save seconds, the mid-epoch restore's;
   - disk_faults: disk_paper from phase 6's store for 2 iterations,
     shard 3 corrupted once (absorbed by the prefetcher's retry) and
     shard 5's loads failing 3 times (past the retry budget: one
     restart), bitwise disk_paper after 2;
   - oom_degrade: a fit(2) with checkpoints, then the allocator capped
     (``set_per_process_memory_fraction``) between this run's streamed
     and resident dense peaks (12 GiB at the full size) and a fresh
     resident engine with ``stream_shards=8`` on that directory: a real
     ``torch.OutOfMemoryError``, one degrade to streamed residency, the
     peak under the cap and the allocated memory around the rebuild
     printed; the cap is lifted after and checked;
   - warp_selfcheck: warp_dense with ``selfcheck=True`` (its
     ``vose_tables`` tables checked every build); the check timed, and a
     keep-probability of 1.5 or a redirect at K must trip it.
8. The distributed trainer (``LDAEngine(backend="distributed")``,
   ``lda/distributed.py``):
   - on a one-rank NCCL group, (1, 1) mesh, at the full width:
     dist_dense and dist_hybrid (``format="hybrid"``,
     ``tail_sampler="sparse"``), ``DIST_ITERS`` (1) each (2 until PR
     31), each bitwise its single path (the dense path's digest after 1,
     hybrid_none's after 1: the real
     tokens' topics, D, W, every LLPT, the exported W); each prints its
     seconds per iteration beside its path's, one more iteration's dW
     all-reduce and scatter into dW and Δcolsum (CUDA events), its peak
     beside its path's, its count build at init (the communicators'
     set-up included) and again from the topics (equal to the live
     counts), and ``shard_corpus``'s host seconds;
   - four ranks sharing the card over gloo (spawned, each rebuilding a
     2 M-token planted corpus of 10,000 words from the seed and
     loading the kernels built above): (a) (4,1) dense with
     ``balance="tiles"``, shared rows present, and (b) (4,1) hybrid,
     each bitwise the single-device run the parent makes first; (c) the
     (2,2) topic split: D and W the histograms of its topics, after
     iteration 1 at most 1% of its topics differ from the single run's,
     each within 1e-5 of a CDF boundary's mass, and its LLPT within 0.15
     of the single run's after 2; (d) (a)'s checkpoint restored in a
     single engine, one more iteration bitwise the single run's; (e)
     (a) and (f) (c) again with ``corpus_residency="streamed"`` (4
     sub-shards a rank), each bitwise its resident run; then three
     supervised fits (``fit(supervise=)``) with a chaos fault on ONE rank:
     a step fault on rank 1 ((4,1), checkpoints every iteration), an I/O
     fault in rank 2's streamed sub-shard (``checkpoint_shards=1``), an
     out-of-memory fault on rank 3 that degrades every rank to streamed
     residency; each agreed by every rank, restarted once with the same
     restart report everywhere, and bitwise the single dense run. Their
     timings are not scaling numbers: the ranks share one card's SMs and
     gloo stages each all-reduce through the host. Every rank's launches
     count in the kernels' line.
   - every distributed and parameter-server path (phases 8, 9) prints one
     more LLPT evaluation's seconds, its peak device memory and what it
     adds above the state; on the replicated trainer (each rank's own
     tokens against its own rows, no global D) beside the gathered
     evaluation it replaced, which must give the same bits.
9. Streamed residency on the distributed trainer and the parameter
   server (``DistConfig(w_sync="ps")``), last:
   - on a one-rank NCCL group at the full width, dist_streamed_dense and
     dist_streamed_hybrid (``format="hybrid"``, ``tail_sampler="sparse"``),
     ``DIST_ITERS`` (1) each, ``corpus_residency="streamed"``, 8
     sub-shards: bitwise the dense path after 1 and hybrid_none after 1
     (topics, D, W, every LLPT, the exported W); seconds an iteration
     beside streamed_dense's and dist_dense's (hybrid: hybrid_none's and
     dist_hybrid's), the peak beside theirs, an epoch's H2D and D2H
     bytes and ``take()`` waits;
   - with no process group, ps_dense and ps_hybrid (``DIST_ITERS`` (1)
     round each): four
     workers on the card (``mesh_shape=(("data", 4), ("model", 1))``,
     staleness 0, four owners, 2 sub-shards a worker), each bitwise the
     same single path; seconds a round split into pulls, sampling,
     pushes and the host commit, ``page_rows``, the bytes pulled and
     pushed a round, the journals' bytes, the largest owner against W;
   - the parameter server's drills on the drill corpus, each bitwise the
     single dense run: an owner killed after a checkpoint and revived by
     snapshot and journal replay, with two pushes lost and resent (3
     rounds); a mid-round ``ps_*`` payload resumed in a fresh engine
     (to round 2); ``fit(4, supervise=SupervisePolicy(
     checkpoint_shards=1))``; and staleness 2 with worker 0 slowed (2
     rounds; clocks aligned at the end, ``selfcheck`` passing).
10. The rest of the LDA core (``lda_core``), last, on the same corpus at
   K = 1000:
   (a) ``LDAConfig(sampler="two_branch")`` (ESCA's two-branch baseline)
   through ``LDAEngine.fit(2)`` on the stepwise path with the default
   ``impl="kernel"`` (counts rebuilt by ``histogram``), LLPT every
   iteration: LLPT must rise, and iteration 1's draws of the first 65,536
   tokens, recomputed on the host in float64 from the same uniforms, D
   rows and Ŵ rows, may disagree only within 1e-5 of the total mass of
   a CDF boundary (their count printed); seconds per iteration,
   ``frac_s_branch``, the peak, and its LLPT after iteration 1 beside the
   dense path's (both start from the stream-0 topics);
   (b) the dense path's final D packed by ``build_sparse_rows`` at its
   max row nnz, every token drawn by ``sample_tokens_sparse_d`` (one
   ``sample_sparse`` launch) on the uniforms ``kops.sample_tokens`` draws
   with: the M decisions equal but for at most 1e-4 of the tokens, each
   within 1e-5 of the mass from M; the topic histograms within 0.01 in
   total variation; the kernel against its twin on 2^20 tokens (the rule
   of phase 2); the launch timed beside the same draw over
   ``pack_rows_sorted`` rows (top_k rows hold no ``EMPTY_IDX`` slot, so
   the kernel walks all L slots);
   (c) the moves of (b)'s first 2^18 tokens through ``ell_apply_deltas``
   on the card and on a CPU copy, on sorted and on top_k rows of that D
   at its row-nnz bound: the packed words bitwise equal, none dropped,
   densify == D plus the same moves through ``esca.delta_update_counts``,
   the sorted rows' ``EMPTY_IDX`` slots still a suffix; then
   ``ell_slot_apply`` of the moves as a dense delta (the live columns);
   each op timed;
   (d) ``reconstruct_d_rows`` of (a)'s final topics (``histogram``'s
   sorted route) == the engine's D, bitwise;
   (e) ``build_hybrid_w`` of the dense path's final W: densify == W
   bitwise, ``nbytes()`` == ``bytes_hybrid``'s total; both printed beside
   the dense W's bytes.
   The launches of (a), (b) and (d) join the kernels' line.

The line before the last holds the kernels' JSON record; the last line is
the device record. Without a CUDA card, or without ``src/repro_torch``
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
NYT_DOCS, NYT_WORDS, NYT_TOKENS = 299_752, 101_636, 100_000_000
REQUESTS, REQUEST_DOCS, SWEEPS = 4, 1024, 20  # serving: held-out requests
K_MAIN, N_SURVIVORS = 1000, 65_536
N_REAL = 1 << 22                   # tokens of a path held and timed
HIST_WIDE = (2_000_000, 1_000_000)  # tokens, rows: tiles span > 128 rows
HIST_SPLIT = (2_000_000, 300)      # tokens, rows: every row > BLOCK_TOKENS
MASS_RTOL, S_ATOL_FRAC = 1e-5, 1e-6
BOUNDARY_FRAC, MAX_MISMATCH_FRAC = 1e-5, 1e-3
WIDE_MISMATCH_FRAC = 0.05          # K = 60,000 sparse rows, as the card test
LLPT_GAP = 0.02                    # paper path vs dense path, bits
PAPER = dict(format="hybrid", tail_sampler="sparse", balance="tiles")
STREAM_SHARDS, MID_EPOCH_SHARDS = 8, 3   # streamed paths; shards before save
WARP_PAPER = dict(sampler="warp", format="hybrid", balance="tiles")
WARP_DENSE = dict(sampler="warp", balance="none")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(src))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(src),
          f"repro_torch imported from {repro_torch.__file__}, not {src}")


def counters() -> dict:
    """The launch-counted kernel wrappers, by entry (a kernel's entries,
    untiled and tiled, main path and reference signature, apart)."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.kernels import sample_warp as sw
    return {"sample_fused": sf.sample_fused_rows,
            "sample_fused_tiled": sf.sample_fused_tiled_rows,
            "sample_sparse": ss.sample_sparse_rows,
            "sample_sparse_tiled": ss.sample_sparse_tiled_rows,
            "vose_tables": sw.vose_tables,
            "vose_build": sw.vose_build,
            "warp_chain_tokens": sw.warp_chain_tokens,
            "warp_chain_tokens_tiled": sw.warp_chain_tokens_tiled,
            "warp_chain": sw.warp_chain_rows,
            "warp_chain_tiled": sw.warp_chain_tiled_rows,
            "histogram": hist.histogram_sorted,
            "histogram_any": hist.histogram}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds for the work: bytes at the HBM rate against
    float32 operations at the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2: the kernels against their twins ---------------------------------

def build_kernels() -> None:
    """Every source at once: one nvcc process each."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.kernels import sample_warp as sw
    mods = (("sample_fused.cu", sf), ("sample_sparse.cu", ss),
            ("sample_warp.cu", sw), ("histogram.cu", hist))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        logs = {name: pool.submit(mod.build) for name, mod in mods}
        logs = {name: f.result()[1] for name, f in logs.items()}
    print(f"built {', '.join(logs)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())


def boundary_distance(u, d_rows, w_rows, alpha, t_a, t_b):
    """Per token, the float64 distance (fraction of the total mass) from
    the draw to the CDF boundary between topics t_a and t_b."""
    d, w = d_rows.double(), w_rows.double()
    k1 = torch.argmax(w, dim=1)
    m = w.gather(1, k1[:, None])[:, 0] * (d.gather(1, k1[:, None])[:, 0]
                                          + alpha)
    mass = (d + alpha) * w
    mass.scatter_(1, k1[:, None], 0.0)
    cum = torch.cumsum(mass, dim=1)
    total = m + cum[:, -1]
    x = u.double() * total
    lo = torch.minimum(t_a, t_b).long()
    at_sweep = (x - m - cum.gather(1, lo[:, None])[:, 0]).abs()
    is_m = (t_a.long() == k1) | (t_b.long() == k1)
    dist = torch.where(is_m, (x - m).abs(), at_sweep)
    last = w.shape[1] - 1                 # the undershoot clamp to K-1
    clamp = (t_a == last) | (t_b == last)
    dist = torch.where(clamp, torch.minimum(dist, (x - total).abs()), dist)
    return dist / total


def compare_sample_fused(fn, twin, u, doc, word, D, W_hat, alpha, label,
                         bound_count=True):
    """Kernel ``fn(u, doc, word)`` vs its twin on the same card tensors;
    ``word`` are the rows the tokens read. Returns (max |Δmass|, topic
    mismatches, max relative mass error). ``bound_count=False`` for draws
    packed at the end of the CDF, where the boundaries of the last,
    lightest topics crowd together: each mismatch must still sit at a
    boundary."""
    n = u.shape[0]
    got = fn()
    want = twin()
    torch.cuda.synchronize()
    check(got[0].shape == (n,) and bool(((got[0] >= 0)
                                         & (got[0] < D.shape[1])).all()),
          f"{label}: topics out of range")
    max_abs, max_rel = 0.0, 0.0
    for lo in range(0, n, 8192):                 # float64 rows, bounded
        sl = slice(lo, min(lo + 8192, n))
        d_rows = D[doc[sl].long()].double()
        w_rows = W_hat[word[sl].long()].double()
        total = ((d_rows + alpha) * w_rows).sum(dim=1)
        for i, name in ((1, "M"), (2, "S'"), (3, "Q'")):
            g, w = got[i][sl].double(), want[i][sl].double()
            check(bool(torch.isfinite(g).all()), f"{label}: {name} not finite")
            err = (g - w).abs()
            tol = MASS_RTOL * w.abs() + (S_ATOL_FRAC * total if i == 2 else 0)
            check(bool((err <= tol).all()),
                  f"{label}: {name} off by {float(err.max()):.3g}")
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / total).max()))
    mism = (got[0] != want[0]).nonzero().squeeze(1)
    check(not bound_count or mism.numel() <= max(1, MAX_MISMATCH_FRAC * n),
          f"{label}: {mism.numel()} topic mismatches of {n}")
    if mism.numel():
        dist = boundary_distance(u[mism], D[doc[mism].long()],
                                 W_hat[word[mism].long()], alpha,
                                 got[0][mism], want[0][mism])
        check(bool((dist <= BOUNDARY_FRAC).all()),
              f"{label}: a topic mismatch lies {float(dist.max()):.3g} of "
              "the mass from any CDF boundary")
    return max_abs, int(mism.numel()), max_rel


def sample_fused_bound_ms(u, doc, word, topics, D, in_m) -> tuple:
    """Least time for this call: distinct rows and word stats read once +
    28 B per token, against 2 flops per topic per token (Σ d·w) + 3 per
    swept topic (the CDF)."""
    n, k = u.shape[0], D.shape[1]
    words = torch.unique(word).numel()
    rows = torch.unique(doc).numel() + words
    nbytes = rows * k * 4 + words * 12 + n * 28
    swept = (topics.long() + 1)[~in_m].sum().item()
    ms, by = bound(nbytes, 2 * n * k + 3 * swept)
    return ms, by, nbytes


def fused_pair(sf, u, doc, word, D, W_hat, stats, alpha, tiles=None):
    """(kernel call, twin call) of sample_fused or, with ``tiles =
    (first, size, win)``, of sample_fused_tiled; ``stats`` are the words'
    (K1, a1, Q')."""
    if tiles is None:
        return (lambda: sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                             alpha=alpha),
                lambda: sf.sample_fused_rows_plain(u, doc, word, D, W_hat,
                                                   *stats, alpha=alpha))
    first, size, win = tiles
    return (lambda: sf.sample_fused_tiled_rows(
                u, doc, word, first, size, D, W_hat, *stats, win_words=win,
                alpha=alpha),
            lambda: sf.sample_fused_tiled_rows_plain(
                u, doc, word, first, size, D, W_hat, *stats, win_words=win,
                alpha=alpha))


def sorted_tiles(word, size):
    """Tile starts of a word-sorted stream and the window that fits every
    tile's run (rounded up to a power of two)."""
    first = word[::size].contiguous()
    ends = torch.clamp(torch.arange(size - 1, word.shape[0] + size - 1, size,
                                    device=word.device), max=word.shape[0] - 1)
    span = int((word[ends] - first).max()) + 1
    return first, 1 << max(span - 1, 0).bit_length()


def phase_fused_kernels(seed: int) -> dict:
    from repro_torch.core import esca
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels.ref import sample_fused_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def counts(rows, k, density, top):
        c = torch.randint(0, top, (rows, k), generator=g, device=dev,
                          dtype=torch.int32)
        return c * (torch.rand((rows, k), generator=g, device=dev) < density)

    errs = {"sample_fused": 0.0, "sample_fused_tiled": 0.0}
    # edge shapes first: small, fast to fail; "u near 1" draws land at the
    # end of every CDF, where rounding decides between the last topics
    for k in (1, 2, 33, 37, 1000, 1024, 1025):
        for n, near_one in ((1, False), (129, False), (4096, True)):
            for ties in (False, True):
                D = counts(300, k, 0.1, 20)
                W = counts(500, k, 0.3, 50)
                if ties:
                    W[:, ::max(1, k // 3)] = 60        # tied maxima
                    W[::4] = 5                         # flat rows
                    W[1::4, -1] = 80                   # K1 the last topic
                W_hat = esca.compute_w_hat(W, 0.01)
                alpha = 50.0 / k
                stats = sf.word_stats_arrays(W_hat, alpha=alpha)
                u = torch.rand(n, generator=g, device=dev)
                if near_one:
                    u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
                doc = torch.randint(0, 300, (n,), generator=g, device=dev,
                                    dtype=torch.int32)
                word = torch.sort(torch.randint(
                    0, 500, (n,), generator=g, device=dev,
                    dtype=torch.int32)).values
                label = (f"K={k} N={n} ties={ties} u_near_1={near_one}")
                err, _, _ = compare_sample_fused(
                    *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u,
                    doc, word, D, W_hat, alpha, label,
                    bound_count=not near_one)
                errs["sample_fused"] = max(errs["sample_fused"], err)
                first, win = sorted_tiles(word, 128)
                win = min(win, 500)
                tiled = fused_pair(sf, u, doc, word, D, W_hat, stats, alpha,
                                   (first, 128, win))
                err, _, _ = compare_sample_fused(
                    *tiled, u, doc, word, D, W_hat, alpha,
                    "tiled " + label, bound_count=not near_one)
                errs["sample_fused_tiled"] = max(errs["sample_fused_tiled"],
                                                 err)
                a, b = tiled[0](), sf.sample_fused_rows(
                    u, doc, word, D, W_hat, *stats, alpha=alpha)
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"tiled {label}: sample_fused_tiled differs from "
                      "sample_fused")
    # the pre-gathered entry (the rows' own stats) against the reference's
    # oracle on those rows
    d_rows, w_rows = D[doc.long()], W_hat[word.long()]
    ids = torch.arange(doc.shape[0], dtype=torch.int32, device=dev)
    compare_sample_fused(
        lambda: sf.sample_fused(u, d_rows, w_rows, alpha=0.05),
        lambda: sample_fused_ref(u, d_rows, w_rows, alpha=0.05), u, ids, ids,
        d_rows, w_rows, 0.05, "pre-gathered rows", bound_count=False)
    print("sample_fused and sample_fused_tiled edge shapes: K in "
          "{1,2,33,37,1000,1024,1025} x N in {1,129} x tied maxima (K1 the "
          "last topic), and 4096 draws with u near 1: agree with their "
          "twins; tiled == untiled bitwise; the pre-gathered entry agrees "
          "with the reference's oracle")

    # the dense path's shape: survivors gathered from NYTimes-sized D and Ŵ
    D = counts(NYT_DOCS, K_MAIN, 0.05, 12)
    W = counts(NYT_WORDS, K_MAIN, 0.2, 40)
    W_hat = esca.compute_w_hat(W, 0.01)
    del W
    u = torch.rand(N_SURVIVORS, generator=g, device=dev)
    doc = torch.randint(0, NYT_DOCS, (N_SURVIVORS,), generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.sort(torch.randint(0, NYT_WORDS, (N_SURVIVORS,),
                                    generator=g, device=dev,
                                    dtype=torch.int32)).values
    alpha = 50.0 / K_MAIN
    stats = sf.word_stats_arrays(W_hat, alpha=alpha)
    max_abs, n_mism, max_rel = compare_sample_fused(
        *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u, doc, word,
        D, W_hat, alpha, "main-path shape")
    errs["sample_fused"] = max(errs["sample_fused"], max_abs)
    print(f"sample_fused main-path shape N={N_SURVIVORS} K={K_MAIN} from "
          f"D {tuple(D.shape)} and W_hat {tuple(W_hat.shape)}: max |dmass| "
          f"{max_abs:.3g} (max {max_rel:.3g} of the token's mass), "
          f"{n_mism} topic mismatches at CDF boundaries "
          f"(bound {int(MAX_MISMATCH_FRAC * N_SURVIVORS)})")

    ms = cuda_ms(lambda: sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                              alpha=alpha), reps=20)
    plain_ms = cuda_ms(lambda: sf.sample_fused_rows_plain(
        u, doc, word, D, W_hat, *stats, alpha=alpha), reps=3, warmup=1)
    topics, m, s, q = sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                           alpha=alpha)
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u, doc, word, topics, D, u * (m + s + q) < m)
    print(f"sample_fused time: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
          f"kernel at {bound_ms / ms:.1%} of its bound; single-PyTorch-call "
          "yardstick: none (no one call computes this draw)")
    del D, W_hat
    return {"errs": errs, "sample_fused": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by}}


def sparse_case(g, K, L, n, *, M=300, V=500, near_one=False, nnz=None):
    """Packed sorted D rows with empty slots (rows fuller than L keep
    their lowest topics), Ŵ, per-word stats (K1 mostly absent from a
    token's row), and n word-sorted tokens, on the card. With ``nnz``
    row r holds its first ``nnz[r % len(nnz)]`` topics of a random row
    (live prefixes ending on or beside a 32-slot step)."""
    from repro_torch.core import esca, sparse
    dev = torch.device("cuda")
    dense = torch.randint(1, 40, (M, K), generator=g, device=dev,
                          dtype=torch.int32)
    if nnz is None:
        density = torch.rand((M, 1), generator=g, device=dev) \
            * min(1.0, L / K)
        dense = dense * (torch.rand((M, K), generator=g, device=dev)
                         < density)
    else:
        perm = torch.argsort(torch.rand((M, K), generator=g, device=dev),
                             dim=1)
        want = torch.tensor(nnz, device=dev).repeat(M // len(nnz) + 1)[:M]
        dense = dense * (torch.argsort(perm, dim=1) < want[:, None])
    packed, _ = sparse.pack_rows_sorted(dense, L)
    dense = sparse.densify_rows_sorted(packed, K)      # what the rows hold
    W = torch.randint(0, 50, (V, K), generator=g, device=dev,
                      dtype=torch.int32)
    W_hat = esca.compute_w_hat(W, 0.01)
    k1_w = torch.argmax(W_hat, dim=1).to(torch.int32)
    a1_w = W_hat.max(dim=1).values.contiguous()
    alpha = 50.0 / K
    qp_w = (alpha * (W_hat.sum(dim=1) - a1_w)).contiguous()
    doc = torch.randint(0, M, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.sort(torch.randint(0, V, (n,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    b1 = dense[doc.long(), k1_w[word.long()].long()].float()
    u = torch.rand(n, generator=g, device=dev)
    if near_one:
        u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
    return dict(u=u, doc=doc, word=word, packed=packed, W_hat=W_hat,
                k1_w=k1_w, a1_w=a1_w, qp_w=qp_w, b1=b1, alpha=alpha)


def sparse_args(c, word=None):
    return (c["u"], c["doc"], c["word"] if word is None else word,
            c["packed"], c["W_hat"], c["k1_w"], c["a1_w"], c["qp_w"],
            c["b1"])


def sparse_bounds_dist(c, sel, word):
    """Per selected token, the float64 distance (fraction of the total
    mass) from its draw to the nearest boundary of the sparse draw: M,
    M plus the running S' mass at each live slot, M + S' (the S'|Q'
    split), M + S' plus the running Q' mass α·Ŵ'[k] at each topic, and
    the total."""
    from repro_torch.core.sparse import unpack_pairs
    v = word[sel].long()
    idx, val = unpack_pairs(c["packed"][c["doc"][sel].long()])
    k = c["W_hat"].shape[1]
    k1 = c["k1_w"][v].long()
    live = (val > 0) & (idx < k) & (idx.long() != k1[:, None])
    w = c["W_hat"][v[:, None], torch.clamp(idx, max=k - 1).long()].double()
    p = torch.where(live, val.double() * w, 0.0)
    m = c["a1_w"][v].double() * (c["b1"][sel].double() + c["alpha"])
    cum = m[:, None] + torch.cumsum(p, dim=1)
    wq = c["alpha"] * c["W_hat"][v].double()
    wq.scatter_(1, k1[:, None], 0.0)
    cum_q = cum[:, -1:] + torch.cumsum(wq, dim=1)
    total = cum[:, -1] + c["qp_w"][v].double()
    bounds = torch.cat([m[:, None], cum, cum_q, total[:, None]], dim=1)
    x = c["u"][sel].double() * total
    return (bounds - x[:, None]).abs().min(dim=1).values / total


def compare_sample_sparse(fn, twin, c, word, label,
                          max_frac=MAX_MISMATCH_FRAC):
    """Kernel vs twin on the same card tensors (``word`` are the words the
    tokens read); the main path's entries finish the Q' branch, so every
    topic lies in [0, K). At most ``max_frac`` of the draws may differ
    (None: no count bound, for draws packed at the end of the CDF), each
    at a boundary. Returns (max |ΔS'|, draw mismatches, Q' share)."""
    n = c["u"].shape[0]
    got, want = fn(), twin()
    torch.cuda.synchronize()
    k = c["W_hat"].shape[1]
    topic, needs_q, s = got
    check(bool(((topic >= 0) & (topic < k)).all()),
          f"{label}: topics out of range")
    check(bool(torch.isfinite(s).all()), f"{label}: S' not finite")
    err = (s.double() - want[2].double()).abs()
    check(bool((err <= MASS_RTOL * want[2].double().abs()).all()),
          f"{label}: S' off by {float(err.max()) if n else 0:.3g}")
    mism = ((topic != want[0]) | (needs_q != want[1])).nonzero().squeeze(1)
    check(max_frac is None or mism.numel() <= max(1, max_frac * n),
          f"{label}: {mism.numel()} draw mismatches of {n}")
    if mism.numel():
        dist = sparse_bounds_dist(c, mism, word)
        check(bool((dist <= BOUNDARY_FRAC).all()),
              f"{label}: a draw mismatch lies {float(dist.max()):.3g} of "
              "the mass from any boundary")
    q_share = float(needs_q.float().mean()) if n else 0.0
    return float(err.max()) if n else 0.0, int(mism.numel()), q_share


def sparse_pair(ss, c, tiles=None):
    args, alpha = sparse_args(c), c["alpha"]
    if tiles is None:
        return (lambda: ss.sample_sparse_rows(*args, alpha=alpha),
                lambda: ss.sample_sparse_rows_plain(*args, alpha=alpha))
    first, size, win = tiles
    return (lambda: ss.sample_sparse_tiled_rows(
                *args[:3], first, size, *args[3:], win_words=win,
                alpha=alpha),
            lambda: sparse_tiled_plain(ss, c, tiles))


def sparse_tiled_plain(ss, c, tiles):
    from repro_torch.kernels.sample_fused import window_rows
    first, size, win = tiles
    rows = window_rows(c["word"].long(), first.long(), size, win,
                       c["k1_w"].shape[0]).int()
    return ss.sample_sparse_rows_plain(*sparse_args(c, rows),
                                       alpha=c["alpha"])


def phase_sparse_kernels(seed: int) -> dict:
    from repro_torch.kernels import sample_sparse as ss
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    errs = {"sample_sparse": 0.0, "sample_sparse_tiled": 0.0}
    steps = [0, 1, 31, 32, 33, 63, 64, 65, 96, 97, 421]
    cases = [(K, L, n, near_one, None) for K in (37, 1000, 1025)
             for L in (1, 37, 421)
             for n, near_one in ((1, False), (4096, False), (4096, True))]
    cases += [(1000, 421, 4096, near_one, steps) for near_one in (False,
                                                                  True)]
    cases += [(60_000, 58_113, 96, False, [0, 33, 1000, 58_112, 58_113])]
    wide = []
    for K, L, n, near_one, nnz in cases:
        small = K > 2048
        c = sparse_case(g, K, L, n, near_one=near_one, nnz=nnz,
                        **(dict(M=5, V=8) if small else {}))
        label = (f"sparse K={K} L={L} N={n} u_near_1={near_one}"
                 + (" prefixes at 32-slot steps" if nnz else ""))
        # at K = 60,000 the boundaries lie ~1.7e-5 of the mass apart, so
        # more draws sit near one: the card test's 5% bound holds there
        max_frac = (None if near_one
                    else WIDE_MISMATCH_FRAC if small else MAX_MISMATCH_FRAC)
        err, n_mism, _ = compare_sample_sparse(
            *sparse_pair(ss, c), c, c["word"], label, max_frac)
        errs["sample_sparse"] = max(errs["sample_sparse"], err)
        first, win = sorted_tiles(c["word"], 128)
        tiles = (first, 128, min(win, c["k1_w"].shape[0]))
        pair = sparse_pair(ss, c, tiles)
        err, n_tiled, _ = compare_sample_sparse(*pair, c, c["word"],
                                                "tiled " + label, max_frac)
        errs["sample_sparse_tiled"] = max(errs["sample_sparse_tiled"], err)
        if small:
            wide.append((n_mism, n_tiled, n))
        a, b = pair[0](), ss.sample_sparse_rows(*sparse_args(c),
                                                alpha=c["alpha"])
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"tiled {label}: sample_sparse_tiled differs from "
              "sample_sparse")
    print("sample_sparse and sample_sparse_tiled edge shapes, Q' branch "
          "finished in the kernel: K in {37,1000,1025} x L in {1,37,421} "
          "x N in {1,4096}, rows with empty slots, K1 mostly absent from "
          "the row, 4096 draws with u near 1, live prefixes ending on and "
          "beside 32-slot steps, and L = 58,113 slots at K = 60,000 (past "
          "the old shared-memory cap): agree with their twins; tiled == "
          "untiled bitwise; draw mismatches at K = 60,000 (untiled, tiled, "
          f"of N): {wide} (bound {WIDE_MISMATCH_FRAC:.0%})")
    return errs


def phase_cap_shapes(seed: int) -> None:
    """Each kernel just below and just past where one block's shared
    memory held its rows, through a hand-written kernel either way: the
    count rebuild at K = 58,100 (sorted route) and 58,101 (any-order
    route), ``sample_fused`` and its tiled launch at K = 25,824 (staged)
    and 25,825 (rows read in place), both ``vose_build`` entries at K =
    29,056 and 29,057 (global memory), bitwise or against their twins,
    and the main path's chain, which has no cap, on tables of K =
    29,057."""
    from repro_torch.core import esca
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import ops
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels.ref import histogram_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 4)
    dev = torch.device("cuda")

    def ri(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    for K in (58_100, 58_101):
        n, rows_w, rows_d = 20_000, 60, 40
        word = torch.sort(ri(rows_w, (n,))).values
        doc = ri(rows_d, (n,))
        topics = ri(K, (n,))
        mask = (torch.rand(n, generator=g, device=dev) < 0.95).to(
            torch.int32)
        inv = torch.argsort(doc, stable=True).to(torch.int32)
        seg = doc[inv.long()].contiguous()
        plans = ops.count_plans(word, seg, n_docs=rows_d, n_words=rows_w,
                                n_topics=K)
        launched = (hist.histogram_sorted.launches, hist.histogram.launches)
        D, W = ops.update_counts(word, doc, topics, mask, inv, seg,
                                 n_docs=rows_d, n_words=rows_w, n_topics=K,
                                 plans=plans)
        torch.cuda.synchronize()
        route = 1 if plans == (None, None) else 0
        check(hist.histogram_sorted.launches - launched[0] == 2 * (1 - route)
              and hist.histogram.launches - launched[1] == 2 * route,
              f"count rebuild K={K}: not through the expected kernel")
        w = (mask > 0).to(torch.int32)
        check(torch.equal(W, histogram_ref(word, topics, w, n_rows=rows_w,
                                           n_topics=K))
              and torch.equal(D, histogram_ref(doc, topics, w,
                                               n_rows=rows_d, n_topics=K)),
              f"count rebuild K={K}: differs from index_put_")
    for K in (25_824, 25_825):
        for near_one in (False, True):
            D = ri(20, (40, K)) * (torch.rand((40, K), generator=g,
                                              device=dev) < 0.1)
            W_hat = esca.compute_w_hat(ri(50, (60, K)), 0.01)
            alpha = 50.0 / K
            stats = sf.word_stats_arrays(W_hat, alpha=alpha)
            n = 512
            u = torch.rand(n, generator=g, device=dev)
            if near_one:
                u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
            doc, word = ri(40, (n,)), torch.sort(ri(60, (n,))).values
            label = f"sample_fused K={K} u_near_1={near_one}"
            compare_sample_fused(
                *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u,
                doc, word, D, W_hat, alpha, label, bound_count=not near_one)
            first = word[::128].contiguous()
            tiled = fused_pair(sf, u, doc, word, D, W_hat, stats, alpha,
                               (first, 128, 60))
            compare_sample_fused(*tiled, u, doc, word, D, W_hat, alpha,
                                 "tiled " + label, bound_count=not near_one)
            a, b = tiled[0](), sf.sample_fused_rows(u, doc, word, D, W_hat,
                                                    *stats, alpha=alpha)
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"tiled {label}: differs from sample_fused")
    for K in (29_056, 29_057):
        check_vose(g, 40, K)
    check_tokens_chain(g, 29_057, 257, near_one=False)
    print("cap shapes: count rebuild at K = 58,100 (sorted route) and "
          "58,101 (any-order route) bitwise index_put_; sample_fused and "
          "sample_fused_tiled at K = 25,824 (staged rows) and 25,825 (rows "
          "read in place) agree with their twins, tiled == untiled "
          "bitwise; vose_build, queues built and read, at K = 29,056 "
          "(shared memory) and 29,057 (global memory) bitwise its twin; "
          "the main path's chain at K = 29,057 bitwise its twin, tiled == "
          "untiled")


def warp_weights(g, V, K, edge=True):
    """Count-shaped W̃ rows on the card; with ``edge`` the first rows are
    all equal, one dominant weight, and one tiny weight among equals."""
    dev = torch.device("cuda")
    w = torch.randint(0, 40, (V, K), generator=g, device=dev).float()
    w = w * (torch.rand((V, K), generator=g, device=dev) < 0.4) + 0.1
    if edge and V >= 3:
        w[0] = 1.0
        w[1] = 1e-3
        w[1, K // 2] = 1e3
        w[2] = 1.0
        w[2, 0] = 1e-6
    return w


def warp_chain_case(g, K, n, *, near_one=False, V=500, M=300, C=2):
    """Ids, proposals, uniforms, counts and tables of n word-sorted tokens
    on the card, for the compact-stream chain."""
    from repro_torch.kernels import sample_warp as sw
    dev = torch.device("cuda")
    tables = sw.alias_tables(warp_weights(g, V, K))
    w_hat = (tables.q * 1.01).contiguous()            # live, moved on
    D = torch.randint(0, 20, (M, K), generator=g, device=dev,
                      dtype=torch.int32)
    ri = lambda hi, shape: torch.randint(  # noqa: E731
        0, hi, shape, generator=g, device=dev, dtype=torch.int32)
    word = torch.sort(ri(V, (n,))).values
    u = torch.rand((C, 4, n), generator=g, device=dev)
    if near_one:
        u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
    ids = (ri(K, (n,)), ri(M, (n,)), word)
    return ids, (ri(K, (C, n)), u[:, :2].contiguous(), u[:, 2:].contiguous(),
                 D, w_hat, tables)


def warp_tokens_case(g, K, n, *, near_one=False, V=500, M=300, C=2):
    """Whole-corpus streams of 2n + 37 word-sorted tokens on the card (a
    tenth padding, docs of one token, an empty doc), their doc index,
    tables and counts, and the n real tokens ``idx`` the main path's chain
    runs on: (idx, streams)."""
    from repro_torch.core import mh
    from repro_torch.kernels import sample_warp as sw
    dev = torch.device("cuda")
    ri = lambda hi, shape: torch.randint(  # noqa: E731
        0, hi, shape, generator=g, device=dev, dtype=torch.int32)
    N = 2 * n + 37
    word = torch.sort(ri(V, (N,))).values
    doc = ri(M - 3, (N,))
    doc[0], doc[-1] = M - 3, M - 2
    mask = (torch.rand(N, generator=g, device=dev) < 0.9).to(torch.int32)
    mask[0] = mask[-1] = 1
    real = mask.nonzero().squeeze(1)
    pick = torch.randperm(real.numel(), generator=g, device=dev)[:n]
    idx = torch.sort(real[pick]).values.to(torch.int32)
    u = [torch.rand((C, m, N), generator=g, device=dev) for m in (3, 2, 2)]
    if near_one:
        u = [torch.clamp(1 - x * 2.0**-16, max=1 - 2.0**-24) for x in u]
    tables = sw.alias_tables(warp_weights(g, V, K))
    return idx, (ri(K, (N,)), doc, word, *u, ri(20, (M, K)),
                 (tables.q * 1.01).contiguous(), tables,
                 mh.build_doc_index(doc, mask, M))


def tokens_out(streams):
    """Fresh outputs of the main path's chain: (topics, accepted)."""
    topics = streams[0]
    return topics.clone(), torch.zeros(topics.shape, dtype=torch.uint8,
                                       device=topics.device)


def check_vose(g, V, K) -> None:
    """Both table-build entries bitwise against their twin on edge rows."""
    from repro_torch.core import mh
    from repro_torch.kernels import sample_warp as sw
    q, scaled = mh.proposal_weights(warp_weights(g, V, K))
    queues = mh.alias_queues(scaled)
    want = mh.run_vose(scaled, *queues)
    for name, got in (("vose_tables", sw.vose_tables(scaled)),
                      ("vose_build", sw.vose_build(scaled, *queues))):
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} K={K}: differs from its twin")


def check_tokens_chain(g, K, n, *, near_one) -> None:
    """The main path's chain bitwise against its twin, written at idx
    only, and its tiled launch bitwise against its untiled one."""
    from repro_torch.kernels import sample_warp as sw
    idx, streams = warp_tokens_case(g, K, n, near_one=near_one)
    alpha = 50.0 / K
    label = f"warp_chain_tokens K={K} N={n} u_near_1={near_one}"
    got = sw.warp_chain_tokens(idx, *streams, alpha=alpha,
                               out=tokens_out(streams))
    want = sw.warp_chain_tokens_plain(idx, *streams, alpha=alpha,
                                      out=tokens_out(streams))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{label}: differs from its twin")
    first, win = sorted_tiles(streams[2][idx.long()], 128)
    tiled = sw.warp_chain_tokens_tiled(idx, first, 128, *streams,
                                       win_words=min(win, 500), alpha=alpha,
                                       out=tokens_out(streams))
    check(all(torch.equal(a, b) for a, b in zip(tiled, got)),
          f"{label}: the tiled launch differs from the untiled one")


def phase_warp_kernels(seed: int) -> dict:
    """Both table-build entries and all four chain entries bitwise against
    their twins on edge shapes; each tiled chain launch bitwise against
    its untiled one."""
    from repro_torch.kernels import sample_warp as sw
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    for K in (1, 37, 1000, 1025):
        check_vose(g, 300, K)
    print("vose_build edge rows: K in {1,37,1000,1025}, all-equal, dominant "
          "and tiny weights: queues built (vose_tables) and read "
          "(vose_build), bitwise equal to its twin (mh.run_vose on "
          "mh.alias_queues)")
    for K in (1, 37, 1000, 1025):
        for n, near_one in ((1, False), (129, False), (4096, False),
                            (4096, True)):
            check_tokens_chain(g, K, n, near_one=near_one)
            ids, rest = warp_chain_case(g, K, n, near_one=near_one)
            alpha = 50.0 / K
            label = f"warp_chain K={K} N={n} u_near_1={near_one}"
            got = sw.warp_chain_rows(*ids, *rest, alpha=alpha)
            want = sw.warp_chain_rows_plain(*ids, *rest, alpha=alpha)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{label}: differs from its twin")
            check(bool(((got[0] >= 0) & (got[0] < K)).all()),
                  f"{label}: topics out of range")
            first, win = sorted_tiles(ids[2], 128)
            tiled = sw.warp_chain_tiled_rows(*ids, first, 128, *rest,
                                             win_words=min(win, 500),
                                             alpha=alpha)
            check(all(torch.equal(a, b) for a, b in zip(tiled, got)),
                  f"{label}: the tiled launch differs from the untiled one")
    print("warp_chain edge shapes: K in {1,37,1000,1025} x N in {1,129,4096}"
          ", 4096 tokens with uniforms near 1, on the main path's streams "
          "(doc proposals inside; docs of one token, padding) and on "
          "compact streams (doc proposals given): topics and accepted "
          "counts bitwise equal to the twins; tiled == untiled bitwise")
    return {"vose_build": 0.0, "warp_chain": 0.0}


def phase_small_iterations(seed: int) -> None:
    """One fused iteration of each path on a small corpus, card vs CPU,
    same uniforms."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig, LDATrainer
    from repro_torch.lda.corpus import planted_corpus
    corpus = planted_corpus(seed, n_docs=400, n_words=2000, n_tokens=60_000,
                            n_planted=40, words_per_topic=40)
    for name, kw, cap in (("dense", {}, 4096), ("paper", PAPER, 128)):
        cfg = LDAConfig(n_topics=64, tile_size=1024, **kw)
        cpu = LDATrainer(corpus, cfg, device="cpu")
        gpu = LDATrainer(corpus, cfg, device="cuda")
        state = cpu.init_state()
        for _ in range(2):
            state, _ = cpu.step(state)
        u = torch.rand(cpu.n_padded_tokens,
                       generator=torch.Generator().manual_seed(seed))
        p_cpu, p_gpu = cpu.fused_pipeline(), gpu.fused_pipeline()
        fs_cpu, _, ns_cpu = p_cpu._iteration(p_cpu.from_lda_state(state), u,
                                             capacity=cap)
        fs_gpu, _, ns_gpu = p_gpu._iteration(
            p_gpu.from_lda_state(gpu.state_from_topics(state.topics, 2)),
            u.cuda(), capacity=cap)
        t_cpu, t_gpu = fs_cpu.topics, fs_gpu.topics.cpu()
        n_mism = int((t_cpu != t_gpu).sum())
        check(abs(int(ns_cpu) - int(ns_gpu)) <= 2,
              f"{name}: survivor counts differ")
        check(n_mism <= max(1, MAX_MISMATCH_FRAC * t_cpu.numel()),
              f"{name} small iteration: {n_mism} topics differ card vs CPU")
        st = p_gpu.to_lda_state(fs_gpu)
        D_ref, W_ref = esca.update_counts(
            gpu.word_ids, gpu.doc_ids, st.topics, gpu.mask,
            n_docs=gpu.n_docs, n_words=gpu.n_words, n_topics=cfg.n_topics)
        check(torch.equal(st.D, D_ref) and torch.equal(st.W, W_ref),
              f"{name}: delta-updated counts differ from the rebuild on the "
              "card")
        print(f"small fused iteration, {name} path ({corpus.n_tokens} "
              f"tokens, K=64): card vs CPU on the same uniforms: {n_mism} "
              f"topics differ, survivors {int(ns_gpu)} vs {int(ns_cpu)}, "
              "card counts == rebuild")


# -- the LM substrate ---------------------------------------------------------

LM_ARCH = "qwen1.5-0.5b"       # the reference launcher's default --arch
LM_STEPS, LM_SEQ, LM_BATCH = 3, 4096, 4   # train_4k's length; batch 256 → 4
LM_DECODE = (8, 4096, 8, 24)   # batch, max_len, prompt tokens, new tokens
LM_CHECK_T = 16                # (c): decoded positions held to the train path
LM_LOSS0_SLACK = 1.0           # step 0 within this of ln(padded vocab)
LM_DECODE_TOL = 2e-2           # (c), as tests/test_models.py's rtol/atol
LM_CPU_LOSS_RTOL, LM_CPU_GNORM_RTOL = 1e-5, 1e-4   # (d)


def _block_pairs(sq: int, skv: int) -> int:
    """Query × key positions ``flash_attention`` computes: every block
    pair, the causally masked ones too, padded to whole blocks."""
    q_blk, kv_blk = min(512, sq), min(1024, skv)
    return (-(-sq // q_blk) * q_blk) * (-(-skv // kv_blk) * kv_blk)


def shared_block_params(cfg) -> int:
    """zamba2's shared attention block (attention, two norms, SwiGLU)."""
    d, hd = cfg.d_model, cfg.head_dim_
    return d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * d + 2 * d + 3 * d * cfg.d_ff


def lm_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """A train step's model FLOPs, fwd + bwd (3× the forward; the blocks'
    recompute under remat not counted): (6·N·tokens, the attention and
    SSD products). N is ``active_param_count()`` (MoE: the routed top k
    and the shared experts) less an untied embedding table, a gather
    that multiplies nothing (a tied table counts once, as the head),
    plus zamba2's shared block once more for each use after the first.
    Attention is 2·B·H·(Dk + Dv) a position
    pair (GQA: Dk = Dv = head_dim; MLA: qk_nope + qk_rope and v_head)
    over ``_block_pairs``. The SSD chunk products a layer forward:
    2·B·chunks·H·(2·Q·N·P + Q²·N + Q²·P) (the inter-chunk read and the
    state update; the intra-chunk scores and their product with x). The
    encoder-decoder counts its encoder on the frames, its decoder on
    min(dec_len, seq) tokens, and self and cross attention."""
    b, h = batch, cfg.n_heads
    table = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    if cfg.is_encoder_decoder:
        sd = min(cfg.dec_len, seq)
        d, hd = cfg.d_model, cfg.head_dim_
        enc = cfg.n_enc_layers * (d * (h + 2 * cfg.n_kv_heads) * hd
                                  + h * hd * d + 2 * d * cfg.d_ff + 2 * d)
        dense = 6.0 * b * (enc * seq + (cfg.param_count() - enc - table)
                           * sd)
        attn = 3.0 * 4 * b * h * hd * (
            cfg.n_enc_layers * _block_pairs(seq, seq)
            + cfg.n_layers * (_block_pairs(sd, sd) + _block_pairs(sd, seq)))
        return dense, attn
    n = cfg.active_param_count() - table
    attn = 0.0
    if cfg.family in ("ssm", "hybrid"):
        q = min(256, seq)
        chunks = -(-seq // q)
        ns, p = cfg.ssm_state, cfg.ssm_head_dim
        attn += 3.0 * cfg.n_layers * 2 * b * chunks * cfg.n_ssm_heads * (
            2 * q * ns * p + q * q * ns + q * q * p)
        if cfg.family == "hybrid" and cfg.attn_every:
            groups = cfg.n_layers // cfg.attn_every
            n += (groups - 1) * shared_block_params(cfg)
            attn += 3.0 * 4 * b * h * cfg.head_dim_ * _block_pairs(seq, seq) \
                * groups
    else:
        dk, dv = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) \
            if cfg.attn_kind == "mla" else (cfg.head_dim_, cfg.head_dim_)
        attn += 3.0 * 2 * b * h * (dk + dv) * _block_pairs(seq, seq) \
            * cfg.n_layers
    return 6.0 * n * b * seq, attn


# -- the plan against the card ------------------------------------------------

def plan_worker(path: str) -> None:
    """The meta-device plans the card's steps are held to, made on this
    host's CPU beside the corpus build: phase lm's qwen step and
    (c)'s rank 0 of (1, CODER_RANKS) (``launch/dryrun.py::plan_step``:
    FLOPs, op bytes, the live peak and the collectives)."""
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    import_port()
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.dryrun import plan_step
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.sharding import PlanMesh
    out = {"lm": plan_step(get_model(REGISTRY[LM_ARCH], "meta"), "train",
                           None, LM_SEQ, LM_BATCH)}
    label, cfg, shape, policy, seq, batch = coder_case()
    out[label] = plan_step(get_model(cfg, "meta"), "train",
                           PlanMesh(shape, ("data", "model"), 0), seq,
                           batch, policy=policy)
    out["seconds"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(out, default=float))


def start_planner(tmp: str):
    """``plan_worker`` in a spawned process: (process, its output)."""
    import multiprocessing as mp
    path = str(Path(tmp) / "plans.json")
    proc = mp.get_context("spawn").Process(target=plan_worker, args=(path,))
    proc.start()
    return proc, path


def read_plans(planner) -> dict:
    proc, path = planner
    t0 = time.perf_counter()
    proc.join(600)
    check(proc.exitcode == 0 and Path(path).exists(),
          f"the planner failed (exit code {proc.exitcode})")
    plans = json.loads(Path(path).read_text())
    print(f"[plan] the planner's process took {plans['seconds']:.1f} s "
          f"from its start; joined after the corpus build, waiting "
          f"{time.perf_counter() - t0:.1f} s")
    return plans


def held_to_plan(card: str, what: str, cfg, seq: int, batch: int,
                 mesh_shape: dict, plan: dict, got: dict) -> dict:
    """A step on the card against its meta-device plan: the FLOPs
    ``FlopCounterMode`` counted on the card must equal the plan's; the
    plan's peak beside ``max_memory_allocated`` (PLAN_PEAK_BAND, a
    prediction); the H100 roofline terms of the plan's counts, the
    dominant one, and the step's model FLOP/s (``analytic_cell``) as a
    share of the H100's 989 TFLOP/s."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.roofline.analysis import H100, roofline_terms
    from repro_torch.roofline.flops_model import analytic_cell
    hw = H100()
    terms = roofline_terms(plan["flops"], plan["bytes"], plan["traffic"], hw)
    model = analytic_cell(cfg, Shape("card", seq, batch, "train"),
                          mesh_shape, n_micro=1).model_flops
    secs = float(got["seconds"][-1])
    ratio = plan["memory"]["peak_bytes_estimate"] / got["peak_bytes"]
    rec = {"flops_card": got["flops"], "flops_plan": plan["flops"],
           "peak_card": got["peak_bytes"],
           "peak_plan": plan["memory"]["peak_bytes_estimate"],
           "peak_ratio": ratio,
           "in_band": PLAN_PEAK_BAND[0] <= ratio <= PLAN_PEAK_BAND[1],
           "terms": terms, "seconds": secs, "model_flops": model,
           "mfu": model / secs / hw.peak_flops}
    print(f"[plan] {card}: {what}: FLOPs on the card {got['flops']:.6e} "
          f"(FlopCounterMode), planned on meta {plan['flops']:.6e}; peak "
          f"planned {rec['peak_plan'] / 2**30:.3f} GiB vs "
          f"max_memory_allocated {got['peak_bytes'] / 2**30:.3f} GiB "
          f"(ratio {ratio:.3f}, predicted band {PLAN_PEAK_BAND}: "
          f"{'within' if rec['in_band'] else 'OUTSIDE'})")
    print(f"[plan] {card}: {what}: H100 terms compute "
          f"{terms['compute_s'] * 1e3:.2f} ms, memory "
          f"{terms['memory_s'] * 1e3:.2f} ms (eager op bytes "
          f"{plan['bytes'] / 2**30:.1f} GiB), collective "
          f"{terms['collective_s'] * 1e3:.2f} ms; dominant "
          f"{terms['dominant']}; the step took {secs:.3f} s: model "
          f"{model / secs / 1e12:.2f} TFLOP/s, {rec['mfu']:.2%} of 989")
    check(got["flops"] == plan["flops"],
          f"[plan] {what}: the card's FLOPs {got['flops']} differ from the "
          f"plan's {plan['flops']}")
    return rec


def plans_held(card: str, plans: dict, lm: dict, lm_sharded: dict) -> dict:
    """lm (e)'s step and (c)'s rank 0's held to their meta-device plans
    (``held_to_plan``)."""
    from repro_torch.configs import REGISTRY
    label, cfg, shape, _, seq, batch = coder_case()
    return {"lm": held_to_plan(card, f"{LM_ARCH} one step of {LM_BATCH} x "
                               f"{LM_SEQ} on one device", REGISTRY[LM_ARCH],
                               LM_SEQ, LM_BATCH, {"data": 1, "model": 1},
                               plans["lm"], lm["plan_card"]),
            label: held_to_plan(card, f"(c) {label} rank 0 of {CODER_RANKS}",
                                cfg, seq, batch, dict(zip(("data", "model"),
                                                          shape)),
                                plans[label],
                                lm_sharded["coder_ranks"][0][label])}


def coder_costs(card: str, coder: list, secs: float) -> dict:
    """What (c)'s CODER_RANKS spawned ranks cost: seconds from the spawn
    to each rank's group, its host memory, and the card's memory in use
    once every rank's context was up."""
    free, total = coder[0]["free_after_group"]
    rec = {"seconds_world": secs,
           "seconds_to_import": [r["seconds_to_import"] for r in coder],
           "seconds_to_group": [r["seconds_to_group"] for r in coder],
           "host_max_rss_bytes": [r["host_max_rss_bytes"] for r in coder],
           "card_used_after_group": total - free}
    rss = rec["host_max_rss_bytes"]
    print(f"[lm_sharded] {card}: (c)'s {CODER_RANKS} ranks: "
          f"{max(rec['seconds_to_import']):.1f} s from the spawn to the "
          f"last rank's imports (beside the four ranks' work), "
          f"{max(rec['seconds_to_group']):.1f} s from their go to the "
          f"last rank's group; host memory {sum(rss) / 2**30:.1f} GiB "
          f"summed over the ranks' peaks (largest {max(rss) / 2**30:.2f} "
          f"GiB); the card "
          f"{(total - free) / 2**30:.1f} GiB in use with every context up; "
          f"the world {secs:.1f} s from its go")
    return rec


def phase_lm(card: str, seed: int) -> dict:
    """The LM substrate at the full width of qwen1.5-0.5b: (a) train_lm
    for LM_STEPS steps at seq 4096, (b) batched greedy decode from an
    empty cache through make_serve_step, (c) decode == the train path in
    float32, (d) one reduced float32 train step on the card == the CPU,
    (e) one train step's FLOPs and peak, for its meta-device plan
    (``plans_held``)."""
    import dataclasses as dc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import REGISTRY
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.models.tree import tree_map
    from repro_torch.train.serve_step import make_serve_step
    from repro_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    zero_counts()
    cfg = REGISTRY[LM_ARCH]
    rec = {"arch": LM_ARCH}

    # (a) train at the published width
    torch.cuda.reset_peak_memory_stats()
    stamps = []

    def log(line: str) -> None:
        stamps.append(time.perf_counter())
        print(f"[lm] {line}")

    hist = train_lm(LM_ARCH, reduced=False, steps=LM_STEPS, seq_len=LM_SEQ,
                    global_batch=LM_BATCH, log_every=1, seed=seed,
                    log_fn=log)
    tokens = LM_SEQ * LM_BATCH
    secs = [tokens / hist["tokens_per_sec"][0]] + list(np.diff(stamps))
    losses = hist["loss"]
    peak = torch.cuda.max_memory_allocated()
    dense, attn = lm_flops(cfg, LM_BATCH, LM_SEQ)
    steady = float(np.mean(secs[1:]))
    rec["train"] = {"loss": losses, "seconds": [float(x) for x in secs],
                    "tokens_per_step": tokens, "peak_bytes": peak,
                    "flops_dense": dense, "flops_attn": attn,
                    "tflops": (dense + attn) / steady / 1e12}
    for i, (loss, sec) in enumerate(zip(losses, secs)):
        print(f"[lm] {card}: train step {i + 1}: loss {loss:.4f}, "
              f"{sec:.3f} s, {tokens / sec:,.0f} tokens/s")
    print(f"[lm] {card}: {LM_ARCH} full width ({cfg.param_count():,} "
          f"params, bf16), {LM_BATCH} x {LM_SEQ} tokens a step: steps 2-"
          f"{LM_STEPS} {steady:.3f} s on average, {tokens / steady:,.0f} "
          f"tokens/s, model {rec['train']['tflops']:.1f} TFLOP/s counting "
          f"6·N·tokens = {dense / 1e12:.2f} TFLOP plus flash_attention's "
          f"every block pair, fwd + bwd = {attn / 1e12:.2f} TFLOP a step "
          f"(no recompute); peak {peak / 2**30:.2f} GiB")
    check(all(np.isfinite(losses)), f"LM losses not finite: {losses}")
    ln_v = float(np.log(cfg.padded_vocab))
    check(abs(losses[0] - ln_v) < LM_LOSS0_SLACK,
          f"LM step-1 loss {losses[0]:.4f} not within {LM_LOSS0_SLACK} of "
          f"ln({cfg.padded_vocab}) = {ln_v:.4f}")
    check(losses[-1] < losses[0], f"LM loss did not fall: {losses}")

    # (b) batched greedy decode from an empty cache
    params = hist["state"]["params"]
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    api = get_model(cfg)
    serve = make_serve_step(api)
    n_b, max_len, n_prompt, n_new = LM_DECODE
    cache = api.make_cache(n_b, max_len)
    cache_bytes = cache["k"].nbytes + cache["v"].nbytes
    prompt = torch.from_numpy(make_batch(cfg, n_prompt, n_b, "train",
                                         seed=seed)["inputs"]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_prompt):
        logits, cache = serve(params, cache, prompt[:, i:i + 1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = logits.argmax(-1, keepdim=True)
    for _ in range(n_new):
        logits, cache = serve(params, cache, tok)
        tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_len = int(cache["length"])
    ms_tok = (t2 - t1) / n_new * 1e3
    rec["decode"] = {"batch": n_b, "max_len": max_len, "length": n_len,
                     "cache_bytes": cache_bytes,
                     "prompt_ms_per_step": (t1 - t0) / n_prompt * 1e3,
                     "ms_per_token": ms_tok}
    print(f"[lm] {card}: greedy decode, batch {n_b}, cache max_len "
          f"{max_len} ({cache_bytes / 2**30:.3f} GiB of K and V): prompt "
          f"{(t1 - t0) / n_prompt * 1e3:.2f} ms a step ({n_prompt} steps), "
          f"then {ms_tok:.2f} ms a token ({n_new} tokens, "
          f"{n_b * 1e3 / ms_tok:,.0f} tokens/s over the batch); length "
          f"{n_len}")
    check(n_len == n_prompt + n_new, f"decode length {n_len}")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "decode logits below vocab_size not finite")
    del params, cache, logits, tok, prompt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) decode == train at the full width, float32
    cfg32 = dc.replace(cfg, param_dtype="float32")
    api32 = get_model(cfg32)
    p32 = api32.init(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_T),
                         generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        want = transformer.forward_train(p32, toks, cfg32) \
            @ transformer.head_w(p32, cfg32)
    cache = api32.make_cache(2, LM_CHECK_T)
    worst = 0.0
    for i in range(LM_CHECK_T):
        got, cache = api32.decode(p32, cache, toks[:, i:i + 1])
        w = want[:, i, :cfg.vocab_size]
        err = (got[:, :cfg.vocab_size] - w).abs()
        check(bool((err <= LM_DECODE_TOL + LM_DECODE_TOL * w.abs()).all()),
              f"decode diverged from the train path at position {i}: max "
              f"abs err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    rec["decode_vs_train_max_abs_err"] = worst
    print(f"[lm] {card}: float32 full width, B=2, T={LM_CHECK_T}: every "
          f"decoded position's logits == forward_train's within rtol/atol "
          f"{LM_DECODE_TOL} (max abs err {worst:.3e})")
    del p32, want, cache, got
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the card == the CPU on one reduced float32 train step
    cfg_r = dc.replace(reduced_config(cfg), param_dtype="float32")
    step_cpu, init_cpu = make_train_step(get_model(cfg_r, "cpu"))
    step_gpu, _ = make_train_step(get_model(cfg_r))
    state = init_cpu(seed)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg_r, 256, 4, "train", seed=seed).items()}
    _, m_cpu = step_cpu(state, batch)
    _, m_gpu = step_gpu(tree_map(lambda x: x.cuda(), state),
                        {k: v.cuda() for k, v in batch.items()})
    pair = {k: (float(m_gpu[k]), float(m_cpu[k]))
            for k in ("loss", "grad_norm")}
    rec["card_vs_cpu"] = pair
    print(f"[lm] {card}: reduced float32 train step, card vs CPU: loss "
          f"{pair['loss'][0]:.7f} vs {pair['loss'][1]:.7f}, grad_norm "
          f"{pair['grad_norm'][0]:.7f} vs {pair['grad_norm'][1]:.7f}")
    for k, rtol in (("loss", LM_CPU_LOSS_RTOL),
                    ("grad_norm", LM_CPU_GNORM_RTOL)):
        got, want_v = pair[k]
        check(abs(got - want_v) <= rtol * abs(want_v),
              f"card {k} {got} vs CPU {want_v} beyond rtol {rtol}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the plan against the card: one step of LM_BATCH × LM_SEQ
    # through make_train_step under FlopCounterMode, its peak from the
    # state's init on
    got = {}
    api = get_model(cfg)
    step, init = make_train_step(api)
    state = init(seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_batch(
        cfg, LM_SEQ, LM_BATCH, "train", seed=seed).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, batch)
        float(m["loss"])
    got["flops"] = fc.get_total_flops()
    got["peak_bytes"] = torch.cuda.max_memory_allocated()
    # (a)'s steps are this step (train_lm's make_train_step, n_micro 1,
    # the same shapes); its steady seconds, without the counter's cost
    got["seconds"] = [steady]
    rec["plan_card"] = got                 # held to its plan after the LDA
    del state, batch, m
    gc.collect()
    rec["launches"] = read_counts()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm] {card}: launches of the counted kernels "
          f"{ {k: v for k, v in rec['launches'].items() if v} or 'none'} "
          f"(the LM substrate has no pallas_call); phase wall "
          f"{rec['seconds']:.1f} s")
    return rec


# -- the LM substrate's other families ----------------------------------------

FAMILIES = ("mamba2-370m", "zamba2-1.2b", "deepseek-moe-16b", "minicpm3-4b",
            "whisper-base")             # (a) and (b); granite: (c), (d)
FAM_STEPS, FAM_SEQ, FAM_BATCH = 3, 4096, 2   # train_4k's length; 256 → 2
FAM_LR = 3e-5                  # small, so that two steps show the update's
                               # sign: at 3e-4 and 1e-4 minicpm3-4b's loss
                               # swings by 1-2 nats from step 3 on, as the
                               # reference's does at its width
                               # (tests/lm_loss_witness.py, PERF.md §6)
FAM_DECODE = (4, 4096, 8, 16)  # batch, max_len (whisper: frames), prompt, new
FAM_TRAIN_BYTES = 64 << 30     # (a): params × 36 B + one layer's f32 scores
FAM_BYTES_PER_PARAM = 36       # bf16 params, f32 master, m, v and gradient
                               # sum, bf16 gradients, AdamW's new state
FAM_F32_BYTES = 20e9           # (c): float32 weights


def depth_for(cfg, max_params: float) -> int:
    """The most layers (at most the published depth) whose param count,
    at the published width, stays within ``max_params``."""
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    per = dataclasses.replace(cfg, n_layers=2).param_count() - one
    return int(min(cfg.n_layers, max(1, (max_params - one + per) // per)))


def train_depth(cfg) -> int:
    """(a)'s depth: the train state at FAM_BYTES_PER_PARAM a param plus
    one layer's float32 attention scores (B·H·S², none for the SSM)
    within FAM_TRAIN_BYTES."""
    scores = 0 if cfg.family == "ssm" else \
        4 * FAM_BATCH * cfg.n_heads * FAM_SEQ * FAM_SEQ
    return depth_for(cfg, (FAM_TRAIN_BYTES - scores) / FAM_BYTES_PER_PARAM)


def phase_lm_families(card: str, seed: int) -> dict:
    """The LM substrate's other families at their published widths: for
    each of FAMILIES (a) train_lm, (b) greedy decode from an empty cache;
    for those and granite-moe-3b-a800m (c) decode == the train path in
    float32 and (d) a reduced float32 train step, card == CPU."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import encdec, transformer
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.train.serve_step import make_serve_step
    from repro_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    zero_counts()
    rec = {}

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    for arch in FAMILIES + ("granite-moe-3b-a800m",):
        cfg = REGISTRY[arch]
        r = rec[arch] = {}
        t_arch = time.perf_counter()
        tag = f"[lm_families] {arch}"
        if arch in FAMILIES:
            # (a) train at the published width, depth cut by count
            n_layers = train_depth(cfg)
            cut = dataclasses.replace(cfg, n_layers=n_layers)
            torch.cuda.reset_peak_memory_stats()
            stamps = []

            def log(line: str) -> None:
                stamps.append(time.perf_counter())
                print(f"{tag}: {line}")

            hist = train_lm(arch, reduced=False,
                            n_layers=n_layers if n_layers < cfg.n_layers
                            else None, steps=FAM_STEPS, seq_len=FAM_SEQ,
                            global_batch=FAM_BATCH, lr=FAM_LR, log_every=1,
                            seed=seed, log_fn=log)
            tokens = FAM_SEQ * FAM_BATCH
            secs = [tokens / hist["tokens_per_sec"][0]] \
                + list(np.diff(stamps))
            losses = hist["loss"]
            peak = torch.cuda.max_memory_allocated()
            built = sum(x.numel() for x in tree_leaves(hist["state"]
                                                       ["params"]))
            dense, attn = lm_flops(cut, FAM_BATCH, FAM_SEQ)
            steady = float(np.mean(secs[1:]))
            r["train"] = {
                "n_layers": n_layers, "loss": losses,
                "seconds": [float(x) for x in secs], "peak_bytes": peak,
                "params_built": built, "param_count": cut.param_count(),
                "flops_dense": dense, "flops_attn": attn,
                "tflops": (dense + attn) / steady / 1e12}
            for i, (loss, sec) in enumerate(zip(losses, secs)):
                print(f"{tag} {card}: train step {i + 1}: loss {loss:.4f}, "
                      f"{sec:.3f} s, {tokens / sec:,.0f} tokens/s")
            what = "frames" if cfg.is_encoder_decoder else "tokens"
            print(f"{tag} {card}: {n_layers} of {cfg.n_layers} layers"
                  f"{'' if n_layers == cfg.n_layers else ' (depth cut)'}, "
                  f"published width, bf16: {built:,} params built "
                  f"({cut.param_count():,} by param_count()), "
                  f"{FAM_BATCH} x {FAM_SEQ} {what} a step: steps 2-"
                  f"{FAM_STEPS} {steady:.3f} s on average, "
                  f"{tokens / steady:,.0f} {what}/s, model "
                  f"{r['train']['tflops']:.1f} TFLOP/s (6·N·tokens "
                  f"{dense / 1e12:.2f} TFLOP + attention/SSD "
                  f"{attn / 1e12:.2f} TFLOP a step); peak "
                  f"{peak / 2**30:.2f} GiB")
            check(all(np.isfinite(losses)), f"{tag} losses not finite: "
                  f"{losses}")
            ln_v = float(np.log(cfg.padded_vocab))
            check(abs(losses[0] - ln_v) < LM_LOSS0_SLACK,
                  f"{tag} step-1 loss {losses[0]:.4f} not within "
                  f"{LM_LOSS0_SLACK} of ln({cfg.padded_vocab}) = {ln_v:.4f}")
            del hist
            free()
            # the initial weights on the same batches (lr = 0): steps
            # 2..n are held to theirs on average, so neither the batches'
            # spread nor one step's swing decides the check
            api = get_model(cut)
            p0 = api.init(seed)
            with torch.no_grad():
                lr0 = [float(api.loss(p0, {
                    k: torch.from_numpy(v).cuda() for k, v in make_batch(
                        cut, FAM_SEQ, FAM_BATCH, "train", step=i,
                        seed=seed).items()})) for i in range(FAM_STEPS)]
            del api, p0
            free()
            r["train"]["lr0_loss"] = lr0
            print(f"{tag} {card}: the initial weights on the same batches "
                  f"(lr 0): " + ", ".join(f"{x:.4f}" for x in lr0)
                  + "; trained minus lr 0: " + ", ".join(
                      f"{a - b:+.4f}" for a, b in zip(losses, lr0)))
            check(abs(losses[0] - lr0[0]) <= 1e-4 * lr0[0],
                  f"{tag} step-1 loss {losses[0]:.5f} is not the initial "
                  f"weights' {lr0[0]:.5f}")
            fall = float(np.mean(np.subtract(losses[1:], lr0[1:])))
            r["train"]["mean_fall"] = fall
            check(fall < 0, f"{tag} steps 2-{FAM_STEPS} lie {fall:+.5f} "
                  f"above the initial weights on the same batches, on "
                  f"average")

            # (b) greedy decode from an empty cache, the full model
            n_b, max_len, n_prompt, n_new = FAM_DECODE
            api = get_model(cfg)
            t0 = time.perf_counter()
            params = api.init(seed)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            fill_s = 0.0
            if cfg.is_encoder_decoder:
                cache = api.make_cache(n_b, cfg.dec_len, enc_len=max_len)
                frames = torch.from_numpy(make_batch(
                    cfg, max_len, n_b, "prefill", seed=seed)["frames"]).cuda()
                t0 = time.perf_counter()
                encdec.fill_cross_cache(params, cache, frames, cfg)
                torch.cuda.synchronize()
                fill_s = time.perf_counter() - t0
                del frames
                prompt = make_batch(cfg, n_prompt, n_b, "train",
                                    seed=seed)["tokens"]
            else:
                cache = api.make_cache(n_b, max_len)
                prompt = make_batch(cfg, n_prompt, n_b, "train",
                                    seed=seed)["inputs"]
            prompt = torch.from_numpy(prompt).cuda()
            cache_bytes = sum(v.nbytes for k, v in cache.items()
                              if k != "length")
            serve = make_serve_step(api)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_prompt):
                logits, cache = serve(params, cache, prompt[:, i:i + 1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok = logits.argmax(-1, keepdim=True)
            for _ in range(n_new):
                logits, cache = serve(params, cache, tok)
                tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_len = int(cache["length"])
            w_bytes = sum(x.nbytes for x in tree_leaves(params))
            r["decode"] = {
                "batch": n_b, "length": n_len, "cache_bytes": cache_bytes,
                "weight_bytes": w_bytes, "init_s": init_s,
                "cross_fill_s": fill_s,
                "prompt_ms_per_step": (t1 - t0) / n_prompt * 1e3,
                "ms_per_token": (t2 - t1) / n_new * 1e3}
            kinds = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}"
                              for k, v in cache.items() if k != "length")
            print(f"{tag} {card}: greedy decode, all {cfg.n_layers} layers "
                  f"({w_bytes / 1e9:.2f} GB of bf16 weights, init "
                  f"{init_s:.1f} s), batch {n_b}, cache {kinds} "
                  f"({cache_bytes / 2**30:.3f} GiB)"
                  + (f", cross K/V filled from {max_len} frames in "
                     f"{fill_s * 1e3:.1f} ms" if fill_s else "")
                  + f": prompt {r['decode']['prompt_ms_per_step']:.2f} ms a "
                  f"step ({n_prompt} steps), then "
                  f"{r['decode']['ms_per_token']:.2f} ms a token ({n_new} "
                  f"tokens); length {n_len}")
            check(n_len == n_prompt + n_new, f"{tag} decode length {n_len}")
            check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
                  f"{tag} decode logits below vocab_size not finite")
            del params, cache, logits, tok, prompt, api, serve
            free()

        # (c) decode == train in float32, depth cut only past FAM_F32_BYTES
        n_c = depth_for(cfg, FAM_F32_BYTES / 4)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", n_layers=n_c)
        api32 = get_model(cfg32)
        p32 = api32.init(seed)
        g = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_T),
                             generator=g).cuda()
        with torch.no_grad():
            if cfg.is_encoder_decoder:
                frames = torch.randn((2, FAM_DECODE[1], cfg.d_model),
                                     generator=g).cuda()
                cache = api32.make_cache(2, LM_CHECK_T,
                                         enc_len=FAM_DECODE[1])
                enc = encdec.fill_cross_cache(p32, cache, frames, cfg32)
                want = encdec.decode_hidden(p32, toks, enc, cfg32) \
                    @ p32["head"]["w"]
                del frames, enc
            else:
                want = transformer.forward_train(p32, toks, cfg32) \
                    @ transformer.head_w(p32, cfg32)
                cache = api32.make_cache(2, LM_CHECK_T)
        worst = 0.0
        for i in range(LM_CHECK_T):
            got, cache = api32.decode(p32, cache, toks[:, i:i + 1])
            w = want[:, i, :cfg.vocab_size]
            err = (got[:, :cfg.vocab_size] - w).abs()
            check(bool((err <= LM_DECODE_TOL + LM_DECODE_TOL * w.abs()
                        ).all()),
                  f"{tag} decode diverged from the train path at position "
                  f"{i}: max abs err {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
        r["decode_vs_train"] = {"n_layers": n_c, "max_abs_err": worst}
        print(f"{tag} {card}: float32, {n_c} of {cfg.n_layers} layers"
              f"{'' if n_c == cfg.n_layers else ' (depth cut)'}, B=2, "
              f"T={LM_CHECK_T}: every decoded position's logits == the "
              f"train path's within rtol/atol {LM_DECODE_TOL} (max abs err "
              f"{worst:.3e})")
        del p32, want, cache, got, api32
        free()

        # (d) the card == the CPU on one reduced float32 train step
        cfg_r = dataclasses.replace(reduced_config(cfg),
                                    param_dtype="float32")
        step_cpu, init_cpu = make_train_step(get_model(cfg_r, "cpu"))
        step_gpu, _ = make_train_step(get_model(cfg_r))
        state = init_cpu(seed)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            cfg_r, 256, 4, "train", seed=seed).items()}
        _, m_cpu = step_cpu(state, batch)
        _, m_gpu = step_gpu(tree_map(lambda x: x.cuda(), state),
                            {k: v.cuda() for k, v in batch.items()})
        pair = {k: (float(m_gpu[k]), float(m_cpu[k]))
                for k in ("loss", "grad_norm")}
        r["card_vs_cpu"] = pair
        print(f"{tag} {card}: reduced float32 train step, card vs CPU: loss "
              f"{pair['loss'][0]:.7f} vs {pair['loss'][1]:.7f}, grad_norm "
              f"{pair['grad_norm'][0]:.7f} vs {pair['grad_norm'][1]:.7f}")
        for k, rtol in (("loss", LM_CPU_LOSS_RTOL),
                        ("grad_norm", LM_CPU_GNORM_RTOL)):
            got_v, want_v = pair[k]
            check(abs(got_v - want_v) <= rtol * abs(want_v),
                  f"{tag} card {k} {got_v} vs CPU {want_v} beyond rtol "
                  f"{rtol}")
        del state, batch
        free()
        r["seconds"] = time.perf_counter() - t_arch
        print(f"{tag}: {r['seconds']:.1f} s")
    rec["launches"] = read_counts()
    check(not any(rec["launches"].values()),
          f"[lm_families] launched counted kernels: {rec['launches']}")
    free()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm_families] {card}: launches of the counted kernels none (the "
          f"families have no pallas_call); peak after freeing "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"phase wall {rec['seconds']:.1f} s")
    return rec


# -- the sharded LM: four ranks share the card --------------------------------

SHARD_RANKS = 4
SHARD_TIMEOUT_S = 600
SHARD_QWEN = (1, 512, 4)       # (a): steps, seq, global batch (seq 1,024
                               # until PR 31, 2 steps until PR 32)
# (b): arch, layers, seq, batch. At capacity factor ⌈E/k⌉ the all-to-all's
# buckets hold 11·t·k/P rows, mostly empty: seq 512 took ~16 GiB a rank,
# seq 256 ~20 s a step through gloo's host copies (~0.4 GB/s a rank)
SHARD_MOE = ("deepseek-moe-16b", 1, 128, 4)   # 2 layers until PR 31
# (c): arch, layers, seq, batch, on (1, CODER_RANKS): 56 query heads on
# 16 split a head (3.5 a rank) and 8 KV heads do not divide 16; a
# sequence of 1,024 does: sequence-parallel attention
SHARD_CODER = ("deepseek-coder-33b", 2, 1024, 2)
CODER_RANKS = 16
# (c): batch, cache slots, prompt, new tokens, and a prefill of 16
# positions (one a rank: the sequence-parallel layout)
SERVE_CODER, PREFILL_CODER = (2, 1024, 1, 1), 16
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL = 1e-2, 5e-2     # bf16, (a)-(c)
# steps of a case where SHARD_QWEN[0] is not kept: the MoE cases cut to
# one (PR 31: they took 46 s of the phase), fsdp's one (11-12 s a step)
SHARD_CASE_STEPS = {"moe_tp_2x2": 1, "moe_ep_2x2": 1, "qwen_fsdp_2x2": 1,
                    "moe_dp_2x2": 1, "moe_fsdp_2x2": 1}
# the plan against the card (lm's step and (c)'s rank 0): the meta
# pass's peak over the card's max_memory_allocated, predicted before the
# first run (PERF.md §6, PR 32); a reading outside it is reported, not
# fatal. The FLOPs must be equal.
PLAN_PEAK_BAND = (0.85, 1.15)


def shard_moe_cfg(cfg):
    """(b): the depth cut and the capacity factor ⌈E/k⌉: one device's cap
    is then at least T (no expert overflows) and the all-to-all's
    cap_s ≥ t·k, cap2 ≥ P·t (no bucket overflows)."""
    import dataclasses as dc
    return dc.replace(cfg, n_layers=SHARD_MOE[1],
                      capacity_factor=float(-(-cfg.n_experts
                                              // cfg.moe_top_k)))


def shard_cases(seed: int) -> list:
    """(label, config, mesh shape, policy, seq, batch), (b) and (c) and
    (a)'s make_train_step run; the same for the ranks and the parent."""
    import dataclasses as dc
    from repro_torch.configs import REGISTRY
    arch_m, _, seq_m, b_m = SHARD_MOE
    moe = shard_moe_cfg(REGISTRY[arch_m])
    _, seq_q, b_q = SHARD_QWEN
    return [("qwen_step_2x2", REGISTRY[LM_ARCH], (2, 2), "tp", seq_q, b_q),
            # (h): 12 of 24 layers (the whole depth until PR 32)
            ("qwen_fsdp_2x2", dc.replace(REGISTRY[LM_ARCH], n_layers=12),
             (2, 2), "fsdp", seq_q, b_q),
            ("moe_tp_2x2", moe, (2, 2), "tp", seq_m, b_m),
            ("moe_ep_2x2", moe, (2, 2), "ep", seq_m, b_m),
            # the dp and fsdp policies' MoE: the rows resharded to the
            # data shard's, the all-to-all over model
            ("moe_dp_2x2", moe, (2, 2), "dp", seq_m, b_m),
            ("moe_fsdp_2x2", moe, (2, 2), "fsdp", seq_m, b_m)]


def coder_case():
    """(c): (label, config, mesh shape, policy, seq, batch)."""
    import dataclasses as dc
    from repro_torch.configs import REGISTRY
    arch_c, n_c, seq_c, b_c = SHARD_CODER
    return ("coder33b_tp_1x16", dc.replace(REGISTRY[arch_c], n_layers=n_c),
            (1, CODER_RANKS), "tp", seq_c, b_c)


def shard_steps(cfg, mesh, policy: str, seq: int, batch: int, seed: int,
                device=None, steps: int = SHARD_QWEN[0],
                count_flops: bool = False, params=None) -> dict:
    """``steps`` steps of make_train_step from init_state(seed) on
    ``mesh`` (None: one device): every step's loss, grad norm, seconds
    and collective bytes by kind, and the peak after the state's init
    (the state and the steps: what a plan's peak holds). ``count_flops``: the first step
    under ``FlopCounterMode`` (its FLOPs; its seconds include the
    counter's). ``params``: this rank's blocks to start from in place of
    ``init_state(seed)``'s."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.train.train_step import make_train_step
    api = get_model(cfg, device)
    step, init = make_train_step(api, mesh, n_micro=1, policy=policy)
    state = init(seed, params=params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"loss": [], "grad_norm": [], "seconds": [], "bytes": []}
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(api.device) for k, v in make_batch(
            cfg, seq, batch, "train", step=i, seed=seed).items()}
        before = {} if mesh is None else {k: v[1] for k, v in
                                          mesh.traffic.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if count_flops and i == 0:
            with FlopCounterMode(display=False) as fc:
                state, m = step(state, b)
            out["flops"] = fc.get_total_flops()
        else:
            state, m = step(state, b)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        if mesh is not None:
            out["bytes"].append({k: v[1] - before.get(k, 0)
                                 for k, v in mesh.traffic.items()})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_card_vs_cpu(mesh, seed: int, cfg=None, policy: str = "tp",
                      seq: int = 256, n_micro: int = 2) -> dict:
    """(d): one reduced float32 step on (2, 2), on the card and on the
    CPU from the same blocks (the CPU's init) and batch; ``cfg`` and
    ``policy`` for (i)'s other families and fsdp."""
    import dataclasses as dc
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.models.tree import tree_map
    from repro_torch.configs import REGISTRY
    from repro_torch.train.train_step import make_train_step
    if cfg is None:
        cfg = dc.replace(reduced_config(REGISTRY[LM_ARCH]),
                         param_dtype="float32")
    step_cpu, init_cpu = make_train_step(get_model(cfg, "cpu"), mesh,
                                         n_micro=n_micro, policy=policy)
    step_gpu, _ = make_train_step(get_model(cfg), mesh, n_micro=n_micro,
                                  policy=policy)
    state = init_cpu(seed)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, seq, 8, "train", seed=seed).items()}
    _, m_cpu = step_cpu(state, batch)
    _, m_gpu = step_gpu(tree_map(lambda x: x.cuda(), state),
                        {k: v.cuda() for k, v in batch.items()})
    return {k: (float(m_gpu[k]), float(m_cpu[k]))
            for k in ("loss", "grad_norm")}


# (e)-(i): sharded decode and prefill, the other families and fsdp
SERVE_QWEN = (8, 4096, 1, 1)   # (e): batch, cache slots, prompt, new tokens
SERVE_QWEN_B1 = (1, 4096, 1, 0)  # (e) on (1, 4): batch 1
SERVE_MOE = (8, 1024, 1, 0)    # (f): on SHARD_MOE's layers, no prefill
# (g): arch, layers (None: every one), the train_lm step's seq and batch;
# their decode: batch, cache slots (whisper: and frames), prompt, new
SHARD_FAMILIES = (("mamba2-370m", 12), ("zamba2-1.2b", 7),
                  ("minicpm3-4b", 2), ("whisper-base", None))
# zamba2's 38 layers cut to 19 in PR 31 (its SSM weights have no rule,
# so each rank holds every one; at full depth a rank's step peaked past
# 18 GiB, and four ranks ran the shared card out of memory), then to 7
# (a group of six and one) and mamba2's 48 to 12 in PR 32, for the
# script's time
SHARD_FAM_TRAIN = (256, 4)
SHARD_FAM_DECODE = (4, 1024, 1, 0)
# bf16 logits of a sharded step against one device's: max |Δ| over the
# largest |logit| of the step (the TP sums and the flash-decode's combine
# reorder bf16 and float32 sums)
SHARD_LOGITS_RTOL = 5e-2
SHARD_CPU_LOGITS_RTOL = 1e-4   # (i): reduced float32 logits, card vs CPU


def shard_serving_params(api, mesh, seed: int):
    """The init of ``seed`` on one device, or on ``mesh`` this rank's
    blocks of it under the serving layout (``zero1_specs``), cut a leaf
    at a time from the same draws."""
    from repro_torch.models.registry import init_rank_params, param_shapes
    from repro_torch.train.partition import zero1_specs
    if mesh is None:
        return api.init(seed)
    return init_rank_params(api, mesh, zero1_specs(
        mesh, param_shapes(api.cfg)), seed)


def shard_serve(cfg, mesh, seed: int, shape: tuple, want=None,
                device=None, prefill: bool = True, params=None,
                n_prefill: int | None = None) -> dict:
    """Prefill (but the encoder-decoder, whose cross cache is filled from
    frames instead), then ``prompt`` tokens and ``new`` greedy tokens
    through ``make_serve_step`` from an empty cache of ``slots``, on
    ``mesh`` or one device. ``want``: one device's record, whose tokens
    the mesh decodes (teacher-forced) and whose logits it is held to."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import get_model, make_rank_cache
    from repro_torch.runtime.sharding import gather_leaf
    from repro_torch.train.serve_step import (logits_spec, make_fill_step,
                                              make_prefill_step,
                                              make_serve_step,
                                              serve_state_shardings)
    batch, slots, n_prompt, n_new = shape
    api = get_model(cfg, device)
    dev = api.device
    enc_len = slots if cfg.is_encoder_decoder else None
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = shard_serving_params(api, mesh, seed)
    specs = None if mesh is None else serve_state_shardings(
        api, mesh, batch, slots, enc_len)[3]
    cache = api.make_cache(batch, slots, **({"enc_len": enc_len} if enc_len
                                            else {})) \
        if mesh is None else make_rank_cache(api, mesh, specs, batch, slots,
                                             enc_len)
    step = make_serve_step(api, mesh, specs)

    def whole(x):
        if mesh is None:
            return x.float().cpu().numpy()
        return gather_leaf(x, logits_spec(mesh, batch, cfg.padded_vocab),
                           mesh).float().cpu().numpy()

    b = make_batch(cfg, max(n_prompt, n_prefill or 0, 8), batch, "train",
                   seed=seed)
    rec = {"logits": [], "seconds": []}
    moved0 = {} if mesh is None else {k: v[1] for k, v in
                                      mesh.traffic.items()}
    if cfg.is_encoder_decoder:
        prompt = torch.from_numpy(b["tokens"][:, :n_prompt]).to(dev)
        frames = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(batch, enc_len, cfg.d_model)).astype(np.float32)).to(dev)
        make_fill_step(api, mesh, specs)(params, cache, frames)
    else:
        prompt = torch.from_numpy(b["inputs"][:, :n_prompt]).to(dev)
    if prefill and not cfg.is_encoder_decoder:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = whole(make_prefill_step(api, mesh)(params, prompt if not
                                                 n_prefill else torch.from_numpy(
                                                     b["inputs"][:, :n_prefill]
                                                 ).to(dev)))
        torch.cuda.synchronize()
        rec["prefill_seconds"] = time.perf_counter() - t0
        rec["prefill"] = pre
    toks = [] if want is None else [torch.from_numpy(t).to(dev)
                                    for t in want["tokens"]]
    for i in range(n_prompt + n_new):
        if i < n_prompt:
            tok = prompt[:, i:i + 1]
        elif want is not None:
            tok = toks[i]
        else:
            tok = torch.from_numpy(rec["logits"][-1][:, :cfg.vocab_size]
                                   .argmax(-1)[:, None].astype(np.int32)
                                   ).to(dev)
        if want is None:
            toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
        rec["logits"].append(whole(logits))
    rec["tokens"] = [t.cpu().numpy() for t in toks]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    if mesh is not None:
        rec["bytes"] = {k: v[1] - moved0.get(k, 0)
                        for k, v in mesh.traffic.items()}
    check(all(np.isfinite(x[:, :cfg.vocab_size]).all()
              for x in rec["logits"]), f"{cfg.name}: decode logits not "
          "finite")
    if want is not None:                 # held to one device's, a step each
        diffs = [float(np.abs(g - w)[:, :cfg.vocab_size].max()
                       / np.abs(w[:, :cfg.vocab_size]).max())
                 for g, w in zip(rec["logits"] + [rec.get("prefill")],
                                 want["logits"] + [want.get("prefill")])
                 if g is not None]
        rec["max_rel_diff"] = max(diffs)
        for k in ("logits", "prefill", "tokens"):
            rec.pop(k, None)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def shard_family_train(arch: str, layers, mesh, seed: int) -> dict:
    """One train_lm step of a family at its published width (``layers``
    cut), on ``mesh`` or one device: the loss, seconds, peak and
    collective bytes."""
    from repro_torch.launch.train import train_lm
    seq, batch = SHARD_FAM_TRAIN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_lm(arch, reduced=False, steps=1, seq_len=seq,
                    global_batch=batch, n_layers=layers, log_every=1,
                    seed=seed, mesh=mesh, log_fn=lambda _line: None)
    torch.cuda.synchronize()
    out = {"loss": hist["loss"], "seconds": [time.perf_counter() - t0],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if mesh is not None:
        out["bytes"] = [{k: v[1] for k, v in mesh.traffic.items()}]
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_serve_cases(seed: int) -> list:
    """(label, config, mesh shape, decode shape, prefill or not) of
    (e)-(g)'s decodes. Each layer's params cross the data axis every
    token (~0.4 GB/s a rank through gloo): the MoE's 2.2 GB of float32
    experts and zamba2's 1.2 B params take no prefill."""
    import dataclasses as dc
    from repro_torch.configs import REGISTRY
    out = [("qwen_serve_2x2", REGISTRY[LM_ARCH], (2, 2), SERVE_QWEN, True),
           ("qwen_serve_1x4_b1", REGISTRY[LM_ARCH], (1, 4), SERVE_QWEN_B1,
            True),
           # float32: a bf16 router's near-ties flip a token's experts
           ("moe_serve_2x2", dc.replace(shard_moe_cfg(REGISTRY[SHARD_MOE[0]]),
                                        param_dtype="float32"), (2, 2),
            SERVE_MOE, False)]
    for arch, layers in SHARD_FAMILIES:
        cfg = REGISTRY[arch]
        if layers is not None:
            cfg = dc.replace(cfg, n_layers=layers)
        out.append((f"{arch}_serve_2x2", cfg, (2, 2), SHARD_FAM_DECODE,
                    arch != "zamba2-1.2b"))
    return out


# (i): the new paths on a reduced float32 config, card == CPU, on (2, 2)
# (PR 31's, each family's decode and qwen's fsdp step, until PR 32: their
# paths are held at full width to one device in (e)-(h)): (arch, config
# overrides, policies
# of a train step, decode or not). 3 query heads on 2 split a head (the
# sequence-parallel layout), the dp policy's MoE, and 3 expert stacks
# on 2 (the global dispatch)
SHARD_CPU_UNEVEN = (
    ("qwen1.5-0.5b", dict(n_heads=3, n_kv_heads=3), ("tp",), True),
    ("deepseek-moe-16b", {}, ("dp",), False),
    ("deepseek-moe-16b", dict(n_experts=3, expert_pad_multiple=1), ("tp",),
     False))


def shard_cpu_cases(mesh, seed: int) -> dict:
    """(i): on ``mesh``, the card against the CPU from the same blocks:
    each family's prefill and one decode step (batch 2, a cache of 16
    slots) and reduced train step (qwen's is (d)'s), and qwen's fsdp
    step."""
    import dataclasses as dc
    from repro_torch.configs import REGISTRY
    from repro_torch.models.registry import get_model, reduced_config
    from repro_torch.models.tree import tree_map
    out = {}
    cases = SHARD_CPU_UNEVEN
    for arch, over, policies, decode in cases:
        cfg = dc.replace(reduced_config(REGISTRY[arch], **over),
                         param_dtype="float32")
        if cfg.n_experts:
            cfg = dc.replace(cfg, capacity_factor=64.0)
        name = arch + "".join(f"/{k}={v}" for k, v in over.items())
        if decode:
            shape = (2, 16, 1, 0)
            blocks = shard_serving_params(get_model(cfg, "cpu"), mesh, seed)
            cpu = shard_serve(cfg, mesh, seed, shape, device="cpu",
                              params=blocks)
            out[f"{name}/decode"] = shard_serve(
                cfg, mesh, seed, shape, want=cpu,
                params=tree_map(lambda x: x.cuda(), blocks))["max_rel_diff"]
        for policy in policies:
            out[f"{name}/{policy}"] = shard_card_vs_cpu(
                mesh, seed, cfg, policy, seq=64, n_micro=1)
    return out


def shard_rank(rank: int, seed: int, single_path: str) -> dict:
    """One rank's part of lm_sharded (every rank runs every case); the
    serving cases are held to the one-device records in
    ``single_path``."""
    import pickle
    from repro_torch.launch.train import train_lm
    from repro_torch.runtime.sharding import ProcessMesh
    out = {}
    t_rank = time.perf_counter()

    def done(what: str) -> None:
        if rank == 0:
            print(f"[lm_sharded] rank 0: {what} done at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)

    steps, seq, batch = SHARD_QWEN
    mesh = ProcessMesh((1, SHARD_RANKS), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_lm(LM_ARCH, reduced=False, steps=steps, seq_len=seq,
                    global_batch=batch, log_every=1, seed=seed, mesh=mesh,
                    log_fn=lambda line: print(f"[lm_sharded] {line}"))
    torch.cuda.synchronize()
    out["qwen_train_lm_1x4"] = {
        "loss": hist["loss"], "seconds_total": time.perf_counter() - t0,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "bytes": {k: v[1] for k, v in mesh.traffic.items()}}
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    for label, cfg, shape, policy, seq, batch in shard_cases(seed):
        m = ProcessMesh(shape, ("data", "model"))
        out[label] = shard_steps(cfg, m, policy, seq, batch, seed,
                                 steps=SHARD_CASE_STEPS.get(label,
                                                            SHARD_QWEN[0]))
        done(label)
    with open(single_path, "rb") as f:     # written by the parent
        want = pickle.load(f)
    for label, cfg, shape, dshape, pre in shard_serve_cases(seed):
        out[label] = shard_serve(cfg, ProcessMesh(shape, ("data", "model")),
                                 seed, dshape, want=want[label],
                                 prefill=pre)                    # (e)-(g)
        done(label)
    for arch, layers in SHARD_FAMILIES:                          # (g)
        out[f"{arch}_train_2x2"] = shard_family_train(
            arch, layers, ProcessMesh((2, 2), ("data", "model")), seed)
        done(f"{arch}_train_2x2")
    out["card_vs_cpu"] = shard_card_vs_cpu(
        ProcessMesh((2, 2), ("data", "model")), seed)
    out["cpu_cases"] = shard_cpu_cases(                          # (i)
        ProcessMesh((2, 2), ("data", "model")), seed)
    done("(d) and (i)")
    return out


def coder_rank(rank: int, seed: int, single_path: str) -> dict:
    """(c): one rank of deepseek-coder-33b on (1, CODER_RANKS): one train
    step (rank 0's under ``FlopCounterMode``), then a prefill and
    ``SERVE_CODER``'s tokens held to the one-device record in
    ``single_path``; and what the rank cost: its seconds from its start
    to the group, the card's free memory with every rank's context up
    (rank 0), and its host memory."""
    import pickle
    import resource
    from repro_torch.runtime.sharding import ProcessMesh
    from repro_torch.models.registry import get_model
    label, cfg, shape, policy, seq, batch = coder_case()
    mesh = ProcessMesh(shape, ("data", "model"))
    out = {"free_after_group": torch.cuda.mem_get_info()}
    t_rank = time.perf_counter()

    def done(what: str) -> None:
        if rank == 0:
            print(f"[lm_sharded] (c) rank 0: {what} done at "
                  f"{time.perf_counter() - t_rank:.1f} s", flush=True)

    # the serving layout is the tp layout here (data axis 1): one init
    params = shard_serving_params(get_model(cfg), mesh, seed)
    done("init")
    with open(single_path, "rb") as f:     # written by the parent
        want = pickle.load(f)
    out["coder33b_serve_1x16"] = shard_serve(
        cfg, mesh, seed, SERVE_CODER, want=want["coder33b_serve_1x16"],
        params=params, n_prefill=PREFILL_CODER)
    done("prefill and decode")
    out[label] = shard_steps(cfg, mesh, policy, seq, batch, seed, steps=1,
                             count_flops=rank == 0, params=params)
    done("train step")
    del params
    out["host_max_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return out


def shard_worker(rank: int, world: int, init: str, seed: int, out_dir: str,
                 single_path: str, t_spawn: float, go: str | None) -> None:
    """A spawned rank of lm_sharded: the card, one gloo group of
    ``world`` (SHARD_RANKS: every case but (c); CODER_RANKS: (c)). With
    ``go`` the rank imports, then waits for that file before it touches
    the card (its start overlaps the work before it)."""
    import pickle
    import traceback
    from datetime import timedelta
    out = Path(out_dir)
    try:
        # the ranks share the card: give back what a case freed
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.set_num_threads(2 if world <= SHARD_RANKS else 1)
        import_port()
        t_import = time.time() - t_spawn
        t_go = t_spawn
        if go is not None:
            deadline = time.monotonic() + SHARD_TIMEOUT_S
            while not Path(go).exists():
                check(time.monotonic() < deadline, "no go for the ranks")
                time.sleep(0.05)
            t_go = time.time()
        torch.cuda.set_device(0)
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=SHARD_TIMEOUT_S))
        t_group = time.time() - t_go
        try:
            if world == CODER_RANKS:
                torch.zeros(1, device="cuda")      # the rank's context
                dist.barrier()
                if rank == 0:
                    print(f"[lm_sharded] (c): every rank's context up "
                          f"{time.time() - t_go:.1f} s after the go",
                          flush=True)
                result = coder_rank(rank, seed, single_path)
            else:
                result = shard_rank(rank, seed, single_path)
        finally:
            dist.destroy_process_group()
        result["seconds_to_import"] = t_import
        result["seconds_to_group"] = t_group
        with open(out / f"{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def start_shard_ranks(seed: int, tmp: str, single_path: str,
                      world: int = SHARD_RANKS, go: str | None = None):
    """``world`` spawned ranks (daemons: they die with this process)."""
    import multiprocessing as mp
    out = Path(tmp) / f"lm_sharded_{world}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    t_spawn = time.time()
    procs = [ctx.Process(target=shard_worker, daemon=True,
                         args=(r, world, str(out / "rdzv"), seed, str(out),
                               single_path, t_spawn, go))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out, time.monotonic()


def join_shard_ranks(handle) -> list:
    """The ranks' results, joined within SHARD_TIMEOUT_S of their spawn;
    a rank that fails or is late fails the phase (the rest are
    killed)."""
    import pickle
    procs, out, t0 = handle
    deadline = t0 + SHARD_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {r: (out / f"{r}.err").read_text()[-3000:]
            for r in range(len(procs)) if (out / f"{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    check(not late and not errs and all(c == 0 for c in codes),
          f"[lm_sharded] ranks: exit codes {codes}, past the deadline "
          f"{late}\n" + "\n".join(f"--- rank {r} ---\n{e}"
                                   for r, e in errs.items()))
    results = []
    for r in range(len(procs)):
        with open(out / f"{r}.pkl", "rb") as f:   # written by our ranks
            results.append(pickle.load(f))
    return results


def phase_lm_sharded(card: str, seed: int, tmp: str) -> dict:
    """The sharded LM on four ranks sharing the card, and (c) on sixteen,
    each case held to the one-device port on the same init and batches
    (made here first, then freed); (c)'s rank 0's step for its plan
    (``plans_held``)."""
    from repro_torch.launch.train import train_lm
    t_phase = time.perf_counter()
    zero_counts()
    steps, seq, batch = SHARD_QWEN
    single = {}
    single_path = str(Path(tmp) / "lm_sharded_single.pkl")
    # the four ranks start now and wait, imported, for the one-device
    # runs' end; (c)'s sixteen for the four's end
    go4 = str(Path(tmp) / "lm_sharded_go4")
    four_ranks = start_shard_ranks(seed, tmp, single_path, go=go4)
    go = str(Path(tmp) / "lm_sharded_go")
    coder_ranks = start_shard_ranks(seed, tmp, single_path, CODER_RANKS, go)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_lm(LM_ARCH, reduced=False, steps=steps, seq_len=seq,
                    global_batch=batch, log_every=1, seed=seed,
                    log_fn=lambda _line: None)
    torch.cuda.synchronize()
    single["qwen_train_lm_1x4"] = {
        "loss": hist["loss"], "seconds_total": time.perf_counter() - t0,
        "peak_bytes": torch.cuda.max_memory_allocated()}
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    for label, cfg, _, _, seq_c, batch_c in shard_cases(seed):
        single[label] = shard_steps(cfg, None, "tp", seq_c, batch_c, seed,
                                    steps=SHARD_CASE_STEPS.get(
                                        label, SHARD_QWEN[0]))
    label_c, cfg_c, _, _, seq_c, batch_c = coder_case()          # (c)
    from repro_torch.models.registry import get_model
    params_c = get_model(cfg_c).init(seed)
    serve_c = shard_serve(cfg_c, None, seed, SERVE_CODER, params=params_c,
                          n_prefill=PREFILL_CODER)
    single[label_c] = shard_steps(cfg_c, None, "tp", seq_c, batch_c, seed,
                                  steps=1, params=params_c)
    del params_c
    for arch, layers in SHARD_FAMILIES:                          # (g)
        single[f"{arch}_train_2x2"] = shard_family_train(arch, layers, None,
                                                         seed)
    serve_one = {label: shard_serve(cfg, None, seed, dshape, prefill=pre)
                 for label, cfg, _, dshape, pre in shard_serve_cases(seed)}
    serve_one["coder33b_serve_1x16"] = serve_c
    import pickle
    with open(single_path, "wb") as f:
        pickle.dump(serve_one, f)
    t_single = time.perf_counter() - t_phase
    print(f"[lm_sharded] {card}: one-device runs {t_single:.1f} s; "
          f"allocated now {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t1 = time.perf_counter()
    Path(go4).touch()
    try:
        ranks = join_shard_ranks(four_ranks)
    except BaseException:
        for p in coder_ranks[0]:
            p.kill()
        raise
    t_ranks = time.perf_counter() - t1
    t1 = time.perf_counter()
    Path(go).touch()
    coder = join_shard_ranks(coder_ranks)
    t_coder = time.perf_counter() - t1
    rec = {"single": single, "ranks": ranks, "coder_ranks": coder,
           "seconds_single": t_single, "seconds_ranks": t_ranks,
           "seconds_coder_ranks": t_coder, "max_rel_diff": {}}
    rec["coder_cost"] = coder_costs(card, coder, t_coder)
    for label, one in single.items():
        ranks_of = coder if label == label_c else ranks
        got = ranks_of[0][label]
        for r, other in enumerate(ranks_of[1:], 1):
            check(other[label]["loss"] == got["loss"],
                  f"[lm_sharded] {label}: rank {r}'s losses "
                  f"{other[label]['loss']} differ from rank 0's "
                  f"{got['loss']}")
        text = []
        for key, rtol in (("loss", SHARD_LOSS_RTOL),
                          ("grad_norm", SHARD_GNORM_RTOL)):
            if key not in one:
                continue
            rel = [abs(g - w) / abs(w) for g, w in zip(got[key], one[key])]
            rec["max_rel_diff"][f"{label}/{key}"] = max(rel)
            text.append(f"{key} {got[key]} vs one device {one[key]} "
                        f"(largest relative difference {max(rel):.2e})")
            check(all(np.isfinite(got[key])) and max(rel) <= rtol,
                  f"[lm_sharded] {label} {key}: sharded {got[key]} vs one "
                  f"device {one[key]} beyond rtol {rtol}")
        print(f"[lm_sharded] {card}: {label}: " + "; ".join(text))
        if "seconds" in one:
            print(f"[lm_sharded] {card}: {label} one device: "
                  f"{[round(x, 3) for x in one['seconds']]} s a step, peak "
                  f"{one['peak_bytes'] / 2**30:.2f} GiB")
        # (c)'s sixteen ranks: rank 0 and the slowest (their summary)
        shown = ranks_of if len(ranks_of) <= SHARD_RANKS else [
            ranks_of[0], max(ranks_of, key=lambda x: x[label]["seconds"][0])]
        for r, x in enumerate(shown):
            if "seconds" in x[label]:
                secs = f"{[round(v, 3) for v in x[label]['seconds']]} s a step"
                moved = x[label]["bytes"][-1]
                what = "the last step"
            else:                   # (a)'s train_lm: init and both steps
                secs = f"{x[label]['seconds_total']:.1f} s in all"
                moved, what = x[label]["bytes"], "in all"
            mib = {k: round(v / 2**20, 1) for k, v in moved.items()}
            print(f"[lm_sharded] {card}: {label} rank {r}: {secs}, peak "
                  f"{x[label]['peak_bytes'] / 2**30:.2f} GiB, collective "
                  f"MiB {what} {mib} ({len(ranks_of)} ranks share one "
                  "card: not a scaling number)")
    rec["serve"] = {}
    serve_cases = [(*c[:4], ranks) for c in shard_serve_cases(seed)] + [
        ("coder33b_serve_1x16", cfg_c, (1, CODER_RANKS), SERVE_CODER,
         coder)]
    for label, cfg, shape, dshape, ranks_of in serve_cases:
        one = serve_one[label]
        got = [x[label] for x in ranks_of]
        worst = max(g["max_rel_diff"] for g in got)
        one_tok = float(np.mean(one["seconds"]))
        rec["serve"][label] = {"max_rel_diff": worst, "one_device": {
            k: v for k, v in one.items() if k in ("seconds", "peak_bytes",
                                                  "prefill_seconds")},
            "ranks": got}
        print(f"[lm_sharded] {card}: {label} (batch {dshape[0]}, "
              f"{dshape[1]} slots{', frames' if cfg.is_encoder_decoder else ''}"
              f", {dshape[2]} prompt + {dshape[3]} greedy tokens) on "
              f"{shape}: logits' largest difference from one device "
              f"{worst:.2e} of the largest logit (tolerance "
              f"{SHARD_LOGITS_RTOL}); one device {one_tok:.3f} s a token, "
              f"peak {one['peak_bytes'] / 2**30:.2f} GiB")
        check(worst <= SHARD_LOGITS_RTOL,
              f"[lm_sharded] {label}: sharded logits {worst:.3e} of the "
              f"largest from one device's, beyond {SHARD_LOGITS_RTOL}")
        shown = got if len(got) <= SHARD_RANKS else [
            got[0], max(got, key=lambda g: float(np.mean(g["seconds"])))]
        for r, g in enumerate(shown):
            mib = {k: round(v / 2**20, 1) for k, v in g["bytes"].items()}
            pre = (f", prefill {g['prefill_seconds']:.3f} s"
                   if "prefill_seconds" in g else "")
            print(f"[lm_sharded] {card}: {label} rank {r}: "
                  f"{float(np.mean(g['seconds'])):.3f} s a token"
                  f"{pre}, peak {g['peak_bytes'] / 2**30:.2f} GiB, "
                  f"collective MiB in all {mib} ({len(ranks_of)} ranks "
                  "share one card: not a scaling number)")
    cpu = ranks[0]["cpu_cases"]
    rec["cpu_cases"] = cpu
    check(all(rr["cpu_cases"] == cpu for rr in ranks),
          f"[lm_sharded] (i): ranks disagree: "
          f"{[rr['cpu_cases'] for rr in ranks]}")
    for key, v in cpu.items():
        if key.endswith("/decode"):
            print(f"[lm_sharded] {card}: (i) {key} on (2, 2), reduced "
                  f"float32, card vs CPU: logits {v:.2e} of the largest "
                  f"(tolerance {SHARD_CPU_LOGITS_RTOL})")
            check(v <= SHARD_CPU_LOGITS_RTOL,
                  f"[lm_sharded] (i) {key}: card vs CPU {v:.3e}")
            continue
        print(f"[lm_sharded] {card}: (i) {key} step on (2, 2), reduced "
              f"float32, card vs CPU: loss {v['loss'][0]:.7f} vs "
              f"{v['loss'][1]:.7f}, grad_norm {v['grad_norm'][0]:.7f} vs "
              f"{v['grad_norm'][1]:.7f}")
        for k, rtol in (("loss", LM_CPU_LOSS_RTOL),
                        ("grad_norm", LM_CPU_GNORM_RTOL)):
            check(abs(v[k][0] - v[k][1]) <= rtol * abs(v[k][1]),
                  f"[lm_sharded] (i) {key} card {k} {v[k][0]} vs CPU "
                  f"{v[k][1]} beyond rtol {rtol}")
    pairs = [rr["card_vs_cpu"] for rr in ranks]
    rec["card_vs_cpu"] = pairs[0]
    for k, rtol in (("loss", LM_CPU_LOSS_RTOL),
                    ("grad_norm", LM_CPU_GNORM_RTOL)):
        got_v, want_v = pairs[0][k]
        check(all(p == pairs[0] for p in pairs),
              f"[lm_sharded] (d): ranks disagree: {pairs}")
        check(abs(got_v - want_v) <= rtol * abs(want_v),
              f"[lm_sharded] (d) card {k} {got_v} vs CPU {want_v} beyond "
              f"rtol {rtol}")
    print(f"[lm_sharded] {card}: reduced float32 step on (2, 2), card vs "
          f"CPU: loss {pairs[0]['loss'][0]:.7f} vs {pairs[0]['loss'][1]:.7f}"
          f", grad_norm {pairs[0]['grad_norm'][0]:.7f} vs "
          f"{pairs[0]['grad_norm'][1]:.7f}")
    rec["launches"] = read_counts()
    check(not any(rec["launches"].values()),
          f"[lm_sharded] launched counted kernels: {rec['launches']}")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[lm_sharded] {card}: launches of the counted kernels none (#14c "
          f"adds no pallas_call); one-device runs {t_single:.1f} s, ranks "
          f"{t_ranks:.1f} s, phase wall {rec['seconds']:.1f} s")
    return rec


# -- phase 3: the paths -------------------------------------------------------

def phase_path(corpus, label: str, kw: dict, n_iters: int, seed: int,
               checkpoint_dir: str | None = None, digests: bool = False,
               fit_kw: dict | None = None, plan=None, on_engine=None,
               digest_at: int | tuple | None = None):
    """``LDAEngine.fit`` of one path, launch counts zeroed just before and
    read just after; returns (engine, record). With ``digests`` the record
    holds the sha256 of the state's topics, D and W right after the fit;
    with ``digest_at`` (an iteration count, or a tuple of them) as well
    after each (the fit runs in a call a span, the digests between them
    and outside the timed wall).
    ``fit_kw`` goes to ``fit`` (``supervise=``), under the chaos ``plan``
    when one is given; ``on_engine(engine)`` runs before the fit. Each
    chunk is timed by ``fit``'s own ``on_chunk``; nothing here holds the
    trainer's pipeline during the fit, which a supervised restart frees."""
    from repro_torch.lda import LDAConfig, LDAEngine
    from repro_torch.runtime import chaos

    from repro_torch.train.lda_step import StreamState

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                    **kw)
    engine = LDAEngine(corpus, cfg, checkpoint_dir=checkpoint_dir)
    check(engine.device.type == "cuda", "the engine did not pick the card")
    if on_engine is not None:
        on_engine(engine)
    pipe = engine.trainer.fused_pipeline()
    residency = engine.trainer.residency
    where = "tokens on the card" if residency == "full" else \
        f"{residency}: {pipe.stream.n_shards} shards of " \
        f"{pipe.stream.shard_len:,} tokens on the host"
    print(f"[{label}] engine built ({where}) in "
          f"{time.perf_counter() - t0:.1f} s")
    pipe = None
    n_padded = engine.trainer.n_padded_tokens
    n_real = engine.trainer.n_real_tokens

    per_iter = []
    warp = kw.get("sampler") == "warp"
    # the tile-route counts at the previous chunk's end, and the dict they
    # were read from (a restart's new pipeline starts its own)
    routes = {"of": None, "at": {}}

    def on_chunk(it, chunk, dt):           # warp: tables included
        check(chunk == 1,
              f"[{label}] eval_every=1 should run 1 iteration a chunk")
        tp = engine.trainer.fused_pipeline()
        now = tp.tile_routes
        was = routes["at"] if routes["of"] is now else \
            {r: 0 for r in now}
        per_iter.append({
            "iteration": it, "seconds": dt,
            "survivors": tp.last_n_surv,
            "segments": dict(getattr(tp, "last_survivors", {})),
            "tiles": {r: now[r] - was[r] for r in now},
            "win_words": tp.win_words,
            "io": dict(getattr(tp, "last_epoch_io", {}))})
        routes.update(of=now, at=dict(now))

    # the warp paths build neither the queues nor the doc proposals in
    # PyTorch: the kernels do
    from repro_torch.core import mh
    plain = {name: 0 for name in ("alias_queues", "doc_proposals")}
    saved = {name: getattr(mh, name) for name in plain}

    def tripwire(name):
        def call(*args, **kwargs):
            plain[name] += 1
            return saved[name](*args, **kwargs)
        return call

    def state_of(engine):
        st = engine.state
        if isinstance(st, StreamState):          # disk: densified
            st = engine.trainer.fused_pipeline().to_lda_state(st)
        return st

    points = sorted({p for p in (digest_at if isinstance(digest_at, tuple)
                                 else (digest_at,)) if p and p < n_iters})
    fits = [b - a for a, b in zip([0] + points, points + [n_iters])]
    hist, wall, marks = {}, 0.0, {}
    zero_counts()
    try:
        for name in plain:
            setattr(mh, name, tripwire(name))
        for n in fits:
            t0 = time.perf_counter()
            with (chaos.active(plan) if plan is not None
                  else contextlib.nullcontext()):
                part = engine.fit(n, on_chunk=on_chunk, **(fit_kw or {}))
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            for k, v in part.items():
                hist[k] = hist.get(k, []) + v if isinstance(v, list) else v
            if digests and engine.iteration != n_iters:
                marks[engine.iteration] = digest(state_of(engine), n_padded,
                                                 n_real)
    finally:
        for name, fn in saved.items():
            setattr(mh, name, fn)
    launches = read_counts()
    if warp:
        check(not any(plain.values()),
              f"[{label}] the path called the plain {plain}")
        print(f"[{label}] calls of mh.alias_queues and mh.doc_proposals in "
              f"the path: {plain}")

    st = state_of(engine)
    for name in ("topics", "D", "W"):
        check(getattr(st, name).is_cuda,
              f"[{label}] state.{name} is not on the card")
    check(int(st.D.sum(dtype=torch.int64)) == n_real
          and int(st.W.sum(dtype=torch.int64)) == n_real,
          f"[{label}] count matrices do not sum to the token count")
    llpt = hist["llpt"]
    check(all(np.isfinite(llpt)), f"[{label}] LLPT not finite: {llpt}")
    check(len(llpt) >= 2 and llpt[-1] > llpt[0],
          f"[{label}] LLPT did not rise: {llpt}")
    # the history's stats belong to the iterations it evaluated: every one
    # here, but a supervised run's failed attempt leaves none
    frac = "frac_accepted" if warp else "frac_skipped"
    fracs = {it: st_[frac] for it, st_ in zip(hist["iteration"],
                                              hist["stats"])}
    for it in per_iter:
        it["accepted" if warp else "skip"] = fracs.get(it["iteration"])
        seg = it["segments"]
        extra = ""
        if seg:
            extra = (f", head/tail survivors {seg.get('head', 0):,}/"
                     f"{seg.get('tail', 0):,}")
        if sum(it["tiles"].values()):
            extra += (f", tiles tiled/untiled {it['tiles']['tiled']:,}/"
                      f"{it['tiles']['untiled']:,} (window "
                      f"{it['win_words']} words)")
        f = fracs.get(it["iteration"])
        name = "accepted fraction" if warp else "skip fraction"
        text = f"{name} {f:.4f}" if f is not None else f"{name} not kept"
        if warp:
            check(f is not None and 0.0 < f < 1.0,
                  f"[{label}] iteration {it['iteration']}: accepted "
                  f"fraction {f} outside (0, 1)")
        print(f"[{label}] iteration {it['iteration']}: "
              f"{n_real / it['seconds']:,.0f} tokens/s "
              f"({it['seconds']:.3f} s), {text}, survivors "
              f"{it['survivors']:,}{extra}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] LLPT after iterations {hist['iteration']}: "
          f"{[round(x, 4) for x in llpt]}")
    print(f"[{label}] kernel launches in the path: {launches}")
    print(f"[{label}] fit wall {wall:.1f} s incl. {len(llpt)} LLPT evals; "
          f"peak device memory {peak / 2**30:.2f} GiB, of which "
          f"{base / 2**30:.2f} GiB held before the path began")
    rec = {"config": kw, "tokens": n_real,
           "iters": n_iters, "launches": launches, "llpt": llpt,
           "history_iterations": hist["iteration"],
           "iterations": per_iter, "peak_bytes": peak,
           "base_bytes": base, "fit_wall_s": wall,
           "digest": digest(st, n_padded, n_real) if digests else None,
           "digests": marks}
    if "restart_report" in hist:
        rep = hist["restart_report"]
        rec["restart_report"] = dataclasses.asdict(rep)
        print(f"[{label}] RestartReport: restarts {rep.restarts}, resumed "
              f"from {rep.resumed_from}, completed {rep.completed_steps}, "
              f"faults {rep.faults}, recovery seconds "
              f"{[round(x, 3) for x in rep.recovery_seconds]}, degraded "
              f"{rep.degraded_to_streamed}, stragglers "
              f"{rep.straggler_steps}")
    return engine, rec


def sha(t) -> str:
    """sha256 of a tensor's or an array's bytes."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()


def digest(state, n_padded: int, n_real: int | None = None) -> dict:
    """sha256 of a dense state's padded topics, D and W; with ``n_real``
    also of the real tokens' topics (``topics_real``: what a distributed
    engine's canonical payload holds)."""
    out = {name: sha(getattr(state, name)[:n_padded] if name == "topics"
                     else getattr(state, name))
           for name in ("topics", "D", "W")}
    if n_real is not None:
        out["topics_real"] = sha(state.topics[:n_real])
    return out


def paper_state_checks(engine, dense_llpt) -> dict:
    """The paper path against the dense path's LLPT, its tail tokens at
    K−1 against its head's, and its packed state against dense."""
    pipe = engine.trainer.fused_pipeline()
    llpt = engine.history["llpt"]
    gaps = [abs(a - b) for a, b in zip(llpt, dense_llpt)]
    check(len(llpt) == len(dense_llpt) and max(gaps) <= LLPT_GAP,
          f"paper path LLPT {llpt} is more than {LLPT_GAP} from the dense "
          f"path's {dense_llpt}")
    topics = engine.state.topics
    tail = ~pipe.head_mask & (pipe.mask > 0)
    head = pipe.head_mask & (pipe.mask > 0)
    last = K_MAIN - 1
    tail_share = float((topics[tail] == last).float().mean())
    head_share = float((topics[head] == last).float().mean())
    # comparable: at most twice the head's share plus 1/K (the reference
    # puts most tail tokens there: its empty-slot NaN)
    check(tail_share <= 2 * head_share + 1 / K_MAIN,
          f"tail tokens at topic K-1: {tail_share:.4%} against the head's "
          f"{head_share:.4%}")
    hs = pipe.from_lda_state(engine.state)
    packed, dense = hs.nbytes(), engine.state.nbytes()
    check(int(hs.overflow) == 0, "the packed state overflowed")
    print(f"[paper] LLPT gap to the dense path per iteration: "
          f"{[round(x, 5) for x in gaps]} (bound {LLPT_GAP})")
    print(f"[paper] tokens at topic K-1: tail {tail_share:.4%} of "
          f"{int(tail.sum()):,}, head {head_share:.4%} of "
          f"{int(head.sum()):,}")
    print(f"[paper] layout: v_dense {pipe.layout.v_dense:,} head words, "
          f"d_capacity {pipe.layout.d_capacity}, {len(pipe.layout.tail_caps)}"
          f" tail buckets {pipe.layout.tail_caps}; packed state "
          f"{packed / 1e9:.3f} GB against dense {dense / 1e9:.3f} GB")
    del hs
    return {"llpt_gaps": gaps, "tail_share_last_topic": tail_share,
            "head_share_last_topic": head_share, "packed_bytes": packed,
            "dense_bytes": dense, "v_dense": pipe.layout.v_dense,
            "d_capacity": pipe.layout.d_capacity}


def phase_real_chunk(engine, seed: int) -> dict:
    """sample_fused on what the dense path hands it next, from the trained
    state: the first ``capacity`` survivors in T order (the pipeline's),
    held to the twin and timed, then phase 2 over all survivors of the
    iteration and its compaction (``nonzero``), beside the reference's
    rank scatter."""
    from repro_torch.core import esca, three_branch
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.train.lda_step import draw_uniforms, survivor_indices
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    st = engine.state
    alpha, cap, K = cfg.alpha_, pipe.capacity, st.D.shape[1]
    W_hat = esca.compute_w_hat(st.W, cfg.beta)
    stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=alpha)
    stats = (stats_w.k[:, 0].contiguous(), stats_w.a[:, 0].contiguous(),
             stats_w.q_prime.contiguous())
    u = draw_uniforms(seed, st.iteration, pipe.n_tokens, pipe.device)
    skip = three_branch.skip_phase(u, pipe.word_ids, pipe.doc_ids, st.D,
                                   stats_w, g=cfg.g, alpha=alpha).skip

    def compact_rank():             # the reference's cumsum + scatter
        rank, n_surv = three_branch.survivor_rank(skip)
        return three_branch.compact_survivor_indices(
            rank, skip, int(n_surv)).long()

    surv = survivor_indices(skip)[0]
    check(torch.equal(surv, compact_rank()),
          "the pipeline's T-order survivors differ from the rank scatter's")
    compact_ms = cuda_ms(lambda: survivor_indices(skip), reps=3)
    rank_ms = cuda_ms(compact_rank, reps=3)
    idx = surv[:cap]
    u_c, d_c, v_c = u[idx], pipe.doc_ids[idx], pipe.word_ids[idx]
    max_abs, n_mism, _ = compare_sample_fused(
        *fused_pair(sf, u_c, d_c, v_c, st.D, W_hat, stats, alpha), u_c, d_c,
        v_c, st.D, W_hat, alpha, "dense-path chunk")

    def chunk():
        return sf.sample_fused_rows(u_c, d_c, v_c, st.D, W_hat, *stats,
                                    alpha=alpha)

    def phase2():
        for lo in range(0, surv.numel(), cap):
            i = surv[lo:lo + cap]
            sf.sample_fused_rows(u[i], pipe.doc_ids[i], pipe.word_ids[i],
                                 st.D, W_hat, *stats, alpha=alpha)

    chunk_runs = [cuda_ms(chunk, reps=3, warmup=1) for _ in range(2)]
    phase2_ms = cuda_ms(phase2, reps=1, warmup=1)
    t, m, s, q = chunk()
    ms = float(np.mean(chunk_runs))
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u_c, d_c, v_c, t, st.D, u_c * (m + s + q) < m)
    rows_bytes = idx.numel() * K * 8
    out = {"n_survivors": surv.numel(), "capacity": cap, "n": idx.numel(),
           "max_abs_err": max_abs, "topic_mismatches": n_mism,
           "distinct_docs": torch.unique(d_c).numel(),
           "distinct_words": torch.unique(v_c).numel(), "ms": ms,
           "runs_ms": chunk_runs, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_bytes": nbytes,
           "rows_bytes": rows_bytes, "phase2_ms": phase2_ms,
           "compact_ms": compact_ms, "compact_rank_scatter_ms": rank_ms}
    print(f"sample_fused at the dense path's chunk, T order, "
          f"N={out['n']:,} ({out['distinct_docs']:,} docs, "
          f"{out['distinct_words']:,} words): kernel {ms:.3f} ms (runs "
          f"{[round(x, 3) for x in chunk_runs]}), bound {bound_ms:.3f} ms by "
          f"{bound_by} ({nbytes / 1e9:.2f} GB of distinct rows); the kernel "
          f"moves {rows_bytes / 1e9:.1f} GB of rows, "
          f"{rows_bytes / (ms * 1e-3) / 1e12:.2f} TB/s; {n_mism} topic "
          f"mismatches at CDF boundaries, max |dmass| {max_abs:.3g}")
    print(f"phase 2 over all {surv.numel():,} survivors in chunks of "
          f"{cap:,}: {phase2_ms:.2f} ms; its compaction (nonzero) "
          f"{compact_ms:.2f} ms, the reference's rank scatter "
          f"{rank_ms:.2f} ms")
    del surv, skip, u, W_hat
    return out


def sparse_bound_ms(c, out) -> tuple:
    """Least time of the finished sparse draw on these tokens: the live
    slots of each distinct doc row read once (4 B each); Ŵ once at each
    distinct (word, topic) the work reads: the prefix of each word's row
    up to the furthest topic any of its Q' tokens drew (a finish reads up
    to its crossing), and the live slots' topics past it; 12 B of stats a
    distinct word; and 25 B of each token's own (u, doc, word, b1 read;
    topic, needs_q, S' written). Against 3 flops a live slot a token and
    2 a Q' topic swept. Returns (ms, by, bytes, text)."""
    from repro_torch.core.sparse import unpack_pairs
    packed, d, v = c["packed"], c["doc"].long(), c["word"].long()
    topic, needs_q = out[0].long(), out[1]
    nnz = (unpack_pairs(packed)[1] > 0).sum(dim=1)
    docs = torch.unique(d)
    slots = int(nnz[docs].sum())
    reach = torch.full((c["W_hat"].shape[0],), -1, dtype=torch.long,
                       device=v.device)           # furthest Q' topic read
    reach.scatter_reduce_(0, v[needs_q], topic[needs_q], "amax")
    q_entries = int((reach + 1).sum())
    k1 = c["k1_w"].long()
    pairs = []
    for lo in range(0, d.numel(), 16_384):
        idx, val = unpack_pairs(packed[d[lo:lo + 16_384]])
        vv = v[lo:lo + 16_384, None].expand_as(idx)
        keep = (val > 0) & (idx.long() != k1[vv]) & (idx.long() > reach[vv])
        pairs.append(torch.unique(vv[keep] * c["W_hat"].shape[1]
                                  + idx[keep].long()))
    w_pairs = torch.unique(torch.cat(pairs)).numel()
    words = torch.unique(v).numel()
    nbytes = 4 * slots + 4 * (w_pairs + q_entries) + 12 * words \
        + 25 * d.numel()
    live = int(nnz[d].sum())
    swept = int((topic[needs_q] + 1).sum())
    ms, by = bound(nbytes, 3 * live + 2 * swept)
    text = (f"{slots:,} live slots of {docs.numel():,} distinct doc rows "
            f"({slots / max(docs.numel(), 1):.1f} a row, of "
            f"{packed.shape[1]} slots), Ŵ at {w_pairs:,} distinct (word, "
            f"topic) pairs past the Q' prefixes and {q_entries:,} entries "
            f"in the Q' prefixes of {int((reach >= 0).sum()):,} words "
            f"(of {int((reach >= 0).sum()) * c['W_hat'].shape[1]:,} in "
            f"their whole rows); {live / d.numel():.1f} live slots a token")
    return ms, by, nbytes, text


def phase_paper_kernels(engine, seed: int) -> dict:
    """The paper path's four kernels on the tokens it hands them next:
    the first ``N_REAL`` head and tail survivors of an iteration from the
    trained state, cut into the path's tiles. Each is held to its twin,
    tiled against untiled bitwise, and timed against its bound."""
    from repro_torch.core import esca, sparse, three_branch
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.train.lda_step import draw_uniforms
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    hs = pipe.from_lda_state(engine.state)
    D = sparse.densify_rows_sorted(hs.D, K_MAIN)
    W_hat = esca.compute_w_hat_from_colsum(
        pipe.layout.densify_w(hs.W_head, hs.W_tail), hs.colsum, cfg.beta)
    stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_)
    u = draw_uniforms(seed, hs.iteration, pipe.n_tokens, pipe.device)
    dec = three_branch.skip_phase(u, pipe.word_ids, pipe.doc_ids, D,
                                  stats_w, g=cfg.g, alpha=cfg.alpha_)
    size, win, alpha = pipe.capacity, pipe.win_words, cfg.alpha_
    out = {}
    for seg, mask in (("head", pipe.head_mask), ("tail", ~pipe.head_mask)):
        idx = ((~dec.skip) & mask).nonzero().squeeze(1)[:N_REAL]
        tiles = pipe._tiles(pipe.word_ids[idx], size, win)
        fit = tiles.fits.repeat_interleave(size)[:idx.numel()]
        idx = idx[fit]
        first = tiles.first[tiles.fits].contiguous()
        u_c, d_c, v_c = u[idx], pipe.doc_ids[idx], pipe.word_ids[idx]
        n = idx.numel()
        check(n > 0, f"no {seg} tile of the paper path fits its window")
        if seg == "head":
            stats = (stats_w.k[:, 0].contiguous(),
                     stats_w.a[:, 0].contiguous(),
                     stats_w.q_prime.contiguous())
            tiled = fused_pair(sf, u_c, d_c, v_c, D, W_hat, stats, alpha,
                               (first, size, win))
            err, n_mism, _ = compare_sample_fused(
                *tiled, u_c, d_c, v_c, D, W_hat, alpha, "paper head tiles")
            untiled = fused_pair(sf, u_c, d_c, v_c, D, W_hat, stats, alpha)
            a, b = tiled[0](), untiled[0]()
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  "paper head: sample_fused_tiled differs from sample_fused")
            t, m, s, q = a
            bound_ms, bound_by, nbytes = sample_fused_bound_ms(
                u_c, d_c, v_c, t, D, u_c * (m + s + q) < m)
            names = ("sample_fused_tiled", "sample_fused")
        else:
            c = dict(u=u_c, doc=d_c, word=v_c, packed=hs.D, W_hat=W_hat,
                     k1_w=stats_w.k[:, 0].contiguous(),
                     a1_w=stats_w.a[:, 0].contiguous(),
                     qp_w=stats_w.q_prime.contiguous(), alpha=alpha)
            c["b1"] = D[d_c.long(), c["k1_w"][v_c.long()].long()].float()
            tiled = sparse_pair(ss, c, (first, size, win))
            untiled = sparse_pair(ss, c)
            err, n_mism, q_share = compare_sample_sparse(
                *tiled, c, v_c, "paper tail tiles")
            a, b = tiled[0](), untiled[0]()
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  "paper tail: sample_sparse_tiled differs from "
                  "sample_sparse")
            print(f"[paper] tail: {q_share:.2%} of the {n:,} tail tokens "
                  "fall past M + S' and take the Q' branch (finished in "
                  "the kernel)")
            bound_ms, bound_by, nbytes, read = sparse_bound_ms(c, a)
            print(f"[paper] tail: the kernel's bound counts {read}")
            names = ("sample_sparse_tiled", "sample_sparse")
        runs = {0: [], 1: []}         # tiled, untiled, untiled, tiled
        for which in (0, 1, 1, 0):
            runs[which].append(cuda_ms((tiled, untiled)[which][0], reps=5))
        ms_t, ms_u = (float(np.mean(runs[w])) for w in (0, 1))
        plain_t = cuda_ms(tiled[1], reps=1, warmup=0)
        plain_u = cuda_ms(untiled[1], reps=1, warmup=0)
        print(f"[paper] {seg}: {n:,} survivor tokens in {int(tiles.fits.sum()):,}"
              f" tiles of {size} that fit a {win}-word window: "
              f"{names[0]} {ms_t:.3f} ms, {names[1]} {ms_u:.3f} ms on the "
              f"same tokens, timed in turns (tiled {runs[0]}, untiled "
              f"{runs[1]} ms; tiled/untiled {ms_t / ms_u:.3f}); plain twins "
              f"{plain_t:.1f} / {plain_u:.1f} ms; bound {bound_ms:.3f} ms by "
              f"{bound_by} ({nbytes / 1e9:.3f} GB); kernel at "
              f"{bound_ms / ms_t:.1%} of its bound; {n_mism} draw mismatches "
              f"at boundaries, max |dmass| {err:.3g}; tiled == untiled "
              "bitwise")
        for name, ms, plain in ((names[0], ms_t, plain_t),
                                (names[1], ms_u, plain_u)):
            out[name] = {"n": n, "ms": ms, "plain_ms": plain,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_bytes": nbytes, "max_abs_err": err}
            if seg == "tail":
                out[name]["q_share"] = q_share
    del hs, D, W_hat, dec, u
    return out


def phase_histogram(engine, seed: int) -> dict:
    """The count rebuild at the main path's shape: W over the dense path's
    ~100 M-token word-sorted stream and D over its doc-major order through
    the sorted route (the trainer's plans), each bitwise against its twin,
    ``index_put_`` and ``torch.bincount``, and timed in turns against the
    any-order route on the same tokens (sorted, any-order, any-order,
    sorted) and beside ``torch.bincount``; then a sorted stream whose rows
    are all split over several blocks, and two streams for the any-order
    route alone: sorted rows that overflow the tiles' windows and unsorted
    D rows."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels.ref import histogram_ref, histogram_sorted_ref
    tr = engine.trainer
    topics = engine.state.topics
    w = (tr.mask > 0).to(torch.int32)
    inv = tr.inv_token_idx.long()
    K = K_MAIN
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)

    def sorted_rows(n, r):
        return torch.sort(torch.randint(0, r, (n,), generator=g,
                                        device="cuda",
                                        dtype=torch.int32)).values

    sp_rows = sorted_rows(*HIST_SPLIT)
    sp_plan = hist.plan_row_blocks(hist.row_offsets(sp_rows, HIST_SPLIT[1]),
                                   K)
    fb_rows = sorted_rows(*HIST_WIDE)
    w_plan, d_plan = tr.count_plans
    # name: (rows, topics, weights, n_rows, sorted-route plan or None)
    cases = {
        "W": (tr.word_ids, topics, w, tr.n_words, w_plan),
        "D": (tr.doc_segments, topics[inv].contiguous(),
              w[inv].contiguous(), tr.n_docs, d_plan),
        "split rows": (sp_rows, topics[:HIST_SPLIT[0]].contiguous(),
                       torch.ones_like(sp_rows), HIST_SPLIT[1], sp_plan),
        "wide rows (any order)": (fb_rows, topics[:HIST_WIDE[0]].contiguous(),
                                  torch.ones_like(fb_rows), HIST_WIDE[1],
                                  None),
        "unsorted D rows (any order)": (tr.doc_ids, topics, w, tr.n_docs,
                                        None)}
    out = {}
    for name, (rows, t, wt, n_rows, plan) in cases.items():
        def any_order():
            return hist.histogram(rows, t, wt, n_rows=n_rows, n_topics=K)

        def sorted_route():
            return hist.histogram_sorted(t, wt, plan)

        want = histogram_ref(rows, t, wt, n_rows=n_rows, n_topics=K)
        flat = (rows.long() * K + t.long())[wt > 0]
        counted = torch.bincount(flat, minlength=n_rows * K)
        routes = {"any order": any_order}
        if plan is not None:
            routes["sorted"] = sorted_route
            check(torch.equal(sorted_route(), histogram_sorted_ref(t, wt,
                                                                   plan)),
                  f"histogram {name}: the sorted route differs from its "
                  "twin")
        for route, fn in routes.items():
            got = fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"histogram {name}, {route} route: differs from "
                  "index_put_")
            check(torch.equal(got.flatten().long(), counted),
                  f"histogram {name}, {route} route: differs from "
                  "torch.bincount")
            del got
        del want, counted
        n = rows.shape[0]
        runs = {r: [] for r in routes}
        turns = ("sorted", "any order", "any order", "sorted") \
            if plan is not None else ("any order",)
        for route in turns:
            runs[route].append(cuda_ms(routes[route], reps=5))
        lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=n_rows * K),
                         reps=3)
        any_ms = float(np.mean(runs["any order"]))
        any_bytes = 12 * n + n_rows * K * 4
        any_bound, _ = bound(any_bytes, n)
        rec = {"n": n, "n_rows": n_rows, "any_order_ms": any_ms,
               "any_order_runs_ms": runs["any order"],
               "any_order_bound_ms": any_bound, "library_ms": lib_ms,
               "max_abs_err": 0.0}
        line = (f"histogram {name}: {n:,} tokens into ({n_rows:,}, {K}): ")
        if plan is not None:
            ms = float(np.mean(runs["sorted"]))
            plain_ms = cuda_ms(lambda: histogram_sorted_ref(t, wt, plan),
                               reps=3)
            nbytes = 8 * n + 8 * (n_rows + 1) + 32 * plan.blocks.shape[0] \
                + 8 * plan.split_rows.numel() + n_rows * K * 4
            bound_ms, bound_by = bound(nbytes, n)
            rec.update({"ms": ms, "runs_ms": runs["sorted"],
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bound_bytes": nbytes,
                        "blocks": plan.blocks.shape[0],
                        "split_rows": plan.split_rows.numel(),
                        "max_rows": plan.max_rows})
            line += (f"sorted route {ms:.3f} ms (runs "
                     f"{[round(x, 3) for x in runs['sorted']]}; "
                     f"{plan.blocks.shape[0]:,} blocks of at most "
                     f"{plan.max_rows} rows, {plan.split_rows.numel():,} "
                     f"split rows), bound {bound_ms:.3f} ms by {bound_by} "
                     f"({nbytes / 1e9:.2f} GB), at {bound_ms / ms:.1%} of its "
                     f"bound; twin {plain_ms:.3f} ms; ")
        line += (f"any-order route {any_ms:.3f} ms (runs "
                 f"{[round(x, 3) for x in runs['any order']]}; bound "
                 f"{any_bound:.3f} ms for its 12 B a token); torch.bincount "
                 f"{lib_ms:.3f} ms (on a precomputed flat index); bitwise "
                 "equal to index_put_ and bincount")
        print(line)
        out[name] = rec
        del flat
    return out


def chain_sectors(idx, streams, alpha) -> tuple[int, int]:
    """The random reads the main path's chain needs for the tokens
    ``idx``, replayed through its plain twin: the doc index at each doc
    (length, start), perm and topics where a doc proposal takes a token's
    topic, topics at the tokens themselves, prob at every word draw and
    alias where it is not kept, and D, Ŵ and q where the chain reads them.
    Returns (reads, distinct 32 B sectors); each distinct sector read once
    is the least the chain must move from device memory."""
    from repro_torch.core import mh
    topics, doc_ids, word_ids, u_doc, u_word, u_acc, D, W_hat, tables, \
        index = streams
    i = idx.long()
    K = W_hat.shape[1]
    addrs = []

    def rec(matrix: int, flat):
        addrs.append((matrix << 40) + flat.long() // 8)

    d, w = doc_ids[i].long(), word_ids[i].long()
    rec(5, d)
    rec(6, d)
    rec(8, i)
    L = index.length[d]
    slot = torch.minimum((u_doc[:, 0][:, i] * L.float()).to(torch.int32),
                         torch.clamp(L - 1, min=0))
    pos = torch.clamp(index.start[d][None, :] + slot, 0,
                      index.perm.shape[0] - 1).long()
    t_doc = mh.doc_proposals(u_doc[:, :, i], topics, doc_ids[i], index,
                             n_topics=K, alpha=alpha)
    ka = torch.tensor(K * alpha, dtype=torch.float32, device=L.device)
    takes_pos = ~((u_doc[:, 1][:, i] < ka / (L.float() + ka)) | (L == 0))
    rec(7, pos[takes_pos])
    rec(8, index.perm[pos[takes_pos]])
    u_draw = u_word[:, :, i]
    v = w[None, :].expand(u_draw.shape[0], -1)
    j = torch.clamp((u_draw[:, 0] * K).to(torch.int32), max=K - 1)
    rec(3, v * K + j)
    keep = u_draw[:, 1] < tables.prob[v, j.long()]
    rec(4, v[~keep] * K + j[~keep])
    t_word = torch.where(keep, j, tables.alias[v, j.long()])

    def look(matrix, mat, rows):
        def lookup(k):
            rec(matrix, rows * K + k.long())
            return mat[rows, k.long()].float()
        return lookup

    mh.mh_chain(topics[i], t_doc, t_word, u_acc[:, :, i],
                lookup_d=look(0, D, d), lookup_w=look(1, W_hat, w),
                lookup_q=look(2, tables.q, w), alpha=alpha)
    flat = torch.cat([a.flatten() for a in addrs])
    return flat.numel(), torch.unique(flat).numel()


def phase_warp_path_kernels(engine, seed: int) -> dict:
    """The warp path's kernels on its own state, each bitwise against its
    twin and timed against its bound beside the stages it absorbed: the
    table build (queues inside) on the W̃ of the NYTimes-shape counts,
    against the queues' sort + the queue-reading launch; the main path's
    chain (doc proposals inside) on the first ``N_REAL`` real tokens of
    the next iteration that fit the path's tiles, tiled against untiled,
    against ``mh.doc_proposals`` + the gathers + the compact-stream
    chain."""
    from repro_torch.core import esca, mh, sparse
    from repro_torch.kernels import sample_warp as sw
    from repro_torch.train.lda_step import draw_warp_uniforms
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    hs = pipe.from_lda_state(engine.state)
    D = sparse.densify_rows_sorted(hs.D, K_MAIN)
    W_hat = esca.compute_w_hat_from_colsum(
        pipe.layout.densify_w(hs.W_head, hs.W_tail), hs.colsum, cfg.beta)
    V, K = W_hat.shape
    q, scaled = mh.proposal_weights(W_hat)
    q_cpu = mh.proposal_weights(W_hat.cpu())[0]
    q_rows = int((q.cpu() != q_cpu).any(dim=1).sum())
    del q_cpu
    got = sw.vose_tables(scaled)
    queues = mh.alias_queues(scaled)
    want = mh.run_vose(scaled, *queues)
    read = sw.vose_build(scaled, *queues)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "vose_tables on the warp path's W̃ differs from its twin")
    check(all(torch.equal(a, b) for a, b in zip(read, want)),
          "vose_build on the warp path's W̃ differs from its twin")
    del want, read
    runs = {0: [], 1: []}
    steps = (lambda: sw.vose_tables(scaled),
             lambda: sw.vose_build(scaled, *mh.alias_queues(scaled)))
    for which in (0, 1, 1, 0):
        runs[which].append(cuda_ms(steps[which], reps=3))
    vose_ms, before_ms = (float(np.mean(runs[w])) for w in (0, 1))
    queue_ms = cuda_ms(lambda: mh.alias_queues(scaled), reps=3)
    read_ms = cuda_ms(lambda: sw.vose_build(scaled, *queues), reps=3)
    vose_plain = cuda_ms(lambda: sw.vose_tables_plain(scaled), reps=1,
                         warmup=0)
    vbytes = 3 * V * K * 4
    v_bound, v_by = bound(vbytes, 3 * V * K)
    print(f"[warp_paper] table build on W̃ ({V:,}, {K}), queues inside "
          f"(vose_tables): {vose_ms:.3f} ms; before, the queues' sort + "
          f"the queue-reading launch: {queue_ms:.3f} + {read_ms:.3f} ms "
          f"alone, {before_ms:.3f} ms together (timed in turns: one launch "
          f"{runs[0]}, sort + launch {runs[1]} ms); twin {vose_plain:.1f} "
          f"ms; bound {v_bound:.3f} ms by {v_by} ({vbytes / 1e9:.2f} GB: "
          f"scaled read, prob and alias written), kernel at "
          f"{v_bound / vose_ms:.1%} of its bound; both entries bitwise "
          f"equal to the twin; q rows differing card vs CPU: {q_rows:,} of "
          f"{V:,}")
    tables = mh.AliasTables(prob=got[0], alias=got[1], q=q)
    del scaled, queues
    n_all, C = pipe.n_tokens, cfg.mh_cycles
    u = draw_warp_uniforms(seed, hs.iteration, n_all, C, pipe.device)
    size, win, alpha = pipe.capacity, pipe.win_words, cfg.alpha_
    idx = pipe.real_idx[:N_REAL]
    tiles = pipe._tiles(pipe.word_ids[idx.long()], size, win)
    idx = idx[tiles.fits.repeat_interleave(size)[:idx.numel()]]
    first = tiles.first[tiles.fits].contiguous()
    n = idx.numel()
    check(n > 0, "no warp tile fits its window")
    streams = (hs.topics, pipe.doc_ids, pipe.word_ids, *u, D, W_hat, tables,
               pipe.doc_index)
    out_t, out_u = tokens_out(streams), tokens_out(streams)
    tiled = lambda: sw.warp_chain_tokens_tiled(  # noqa: E731
        idx, first, size, *streams, win_words=win, alpha=alpha, out=out_t)
    untiled = lambda: sw.warp_chain_tokens(  # noqa: E731
        idx, *streams, alpha=alpha, out=out_u)
    a, b = tiled(), untiled()
    twin = sw.warp_chain_tokens_plain(idx, *streams, alpha=alpha,
                                      out=tokens_out(streams))
    i = idx.long()

    def before():
        """The route this kernel replaced: doc proposals and gathers in
        PyTorch, then the compact-stream chain."""
        t_doc = mh.doc_proposals(u[0][:, :, i], hs.topics, pipe.doc_ids[i],
                                 pipe.doc_index, n_topics=K, alpha=alpha)
        return sw.warp_chain_tiled_rows(
            hs.topics[i], pipe.doc_ids[i], pipe.word_ids[i], first, size,
            t_doc, u[1][:, :, i], u[2][:, :, i], D, W_hat, tables,
            win_words=win, alpha=alpha)

    rows = before()
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "warp_chain_tokens: the tiled launch differs from the untiled one")
    check(all(torch.equal(x, y) for x, y in zip(b, twin)),
          "warp_chain_tokens differs from its twin on the warp path's "
          "tokens")
    check(torch.equal(a[0][i], rows[0])
          and torch.equal(a[1][i].to(torch.int32), rows[1]),
          "warp_chain_tokens differs from the compact-stream chain fed "
          "mh.doc_proposals")
    t_doc = mh.doc_proposals(u[0][:, :, i], hs.topics, pipe.doc_ids[i],
                             pipe.doc_index, n_topics=K, alpha=alpha)
    gathered = (hs.topics[i], pipe.doc_ids[i], pipe.word_ids[i], first,
                size, t_doc, u[1][:, :, i].contiguous(),
                u[2][:, :, i].contiguous(), D, W_hat, tables)
    rows_chain = lambda: sw.warp_chain_tiled_rows(  # noqa: E731
        *gathered, win_words=win, alpha=alpha)
    runs = {0: [], 1: []}
    for which in (0, 1, 1, 0):
        runs[which].append(cuda_ms((tiled, untiled)[which], reps=5))
    ms_t, ms_u = (float(np.mean(runs[w])) for w in (0, 1))
    before_chain = cuda_ms(before, reps=3)
    rows_ms = cuda_ms(rows_chain, reps=5)
    del gathered, t_doc, rows
    plain = cuda_ms(lambda: sw.warp_chain_tokens_plain(
        idx, *streams, alpha=alpha, out=tokens_out(streams)), reps=1,
        warmup=0)
    reads, sectors = chain_sectors(idx, streams, alpha)
    cbytes = 32 * sectors + n * (4 + 8 + 28 * C + 5)
    c_bound, c_by = bound(cbytes, 14 * C * n)
    acc = float((a[1][i] > 0).float().mean())
    print(f"[warp_paper] warp_chain_tokens on {n:,} tokens in "
          f"{int(tiles.fits.sum()):,} tiles of {size} that fit a {win}-word "
          f"window, {C} cycles, doc proposals inside: tiled {ms_t:.3f} ms, "
          f"untiled {ms_u:.3f} ms on the same tokens, timed in turns (tiled "
          f"{runs[0]}, untiled {runs[1]} ms; tiled/untiled "
          f"{ms_t / ms_u:.3f}); before, doc proposals + gathers + the "
          f"compact-stream chain {before_chain:.3f} ms (that chain alone "
          f"{rows_ms:.3f} ms); twin {plain:.1f} ms; bound {c_bound:.3f} ms "
          f"by {c_by} ({reads / n / C:.2f} random reads a token a cycle "
          f"touching {sectors:,} distinct 32 B sectors, {cbytes / 1e9:.2f} "
          f"GB); tiled kernel at {c_bound / ms_t:.1%} of its bound; "
          f"{acc:.2%} of tokens accepted a proposal; tiled == untiled == "
          "twin == the compact-stream chain bitwise")
    print(f"[warp_paper] stage sums before -> after: table build, sort + "
          f"Vose {queue_ms:.3f} + {read_ms:.3f} = "
          f"{queue_ms + read_ms:.3f} ms -> one launch {vose_ms:.3f} ms; doc "
          f"proposals + chain on {n:,} tokens {before_chain:.3f} ms -> one "
          f"launch {ms_t:.3f} ms")
    del hs, D, W_hat, tables, u, streams, got, out_t, out_u, twin
    return {"vose_build": {"ms": vose_ms, "plain_ms": vose_plain,
                           "bound_ms": v_bound, "bound_by": v_by,
                           "queues_ms": queue_ms, "read_ms": read_ms,
                           "before_ms": before_ms, "q_rows_differ": q_rows,
                           "max_abs_err": 0.0},
            "warp_chain": {"n": n, "ms": ms_t, "untiled_ms": ms_u,
                           "before_ms": before_chain, "rows_ms": rows_ms,
                           "plain_ms": plain, "bound_ms": c_bound,
                           "bound_by": c_by, "max_abs_err": 0.0,
                           "reads_per_token_cycle": reads / n / C,
                           "distinct_sectors": sectors}}


def phase_breakdown(engine, targets, label: str) -> dict:
    """Device time of each stage of one more fused iteration.

    CUDA events are recorded around each listed function (wrapped where
    the pipeline looks it up, then restored), so the real path is what
    is timed. ``targets`` are (module, attribute, stage, inside): a
    stage's time excludes that of the stages named in ``inside`` that run
    within it. "other" is what lies between the stages."""
    spans = []

    def timed(stage, fn):
        @functools.wraps(fn)             # keeps a wrapper's launch count
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            spans.append((stage, start, stop))
            return out
        return call

    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in targets]
    pipe = engine.trainer.fused_pipeline()
    fs = pipe.from_lda_state(engine.state)
    try:
        for (mod, name, stage, _), (_, _, fn) in zip(targets, saved):
            setattr(mod, name, timed(stage, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.step(fs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    del fs
    stages: dict[str, float] = {}
    for stage, start, stop in spans:
        stages[stage] = stages.get(stage, 0.0) + start.elapsed_time(stop)
    for _, _, stage, inside in targets:
        for inner in inside:
            stages[stage] = stages.get(stage, 0.0) - stages.get(inner, 0.0)
    stages["other"] = wall_ms - sum(stages.values())
    print(f"[{label}] one fused iteration, {wall_ms:.1f} ms wall, by stage "
          "(CUDA events):")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms  {ms / wall_ms:6.1%}  {name}")
    return {"wall_ms": wall_ms, "stages_ms": stages}


def warp_breakdown_targets(hybrid: bool) -> list:
    """The warp iteration's stages. The queues' sort now runs inside
    "proposal build: Vose" and the doc proposals (with the gathers that
    fed the chain) inside "chain"."""
    from repro_torch.core import mh, sparse
    from repro_torch.kernels import sample_warp
    from repro_torch.train import lda_step
    build = ("proposal build: q", "proposal build: Vose")
    t = [(lda_step, "build_warp_proposal", "proposal build: W̃", build),
         (mh, "proposal_weights", build[0], ()),
         (sample_warp, "vose_tables", build[1], ()),
         (lda_step, "draw_warp_uniforms", "uniforms", ()),
         (lda_step, "warp_chain_tokens", "chain", ()),
         (lda_step, "warp_chain_tokens_tiled", "chain", ()),
         (mh, "warp_stats", "stats", ()),
         (lda_step, "scatter_changed_deltas", "±1 scatters", ())]
    if hybrid:
        t += [(sparse, "densify_rows_sorted", "densify", ()),
              (sparse, "pack_rows_sorted", "repack", ())]
    return t


def breakdown_targets(paper: bool) -> list:
    from repro_torch.core import esca, sparse, three_branch
    from repro_torch.kernels import ops
    from repro_torch.train import lda_step
    t = [(lda_step, "draw_uniforms", "uniforms", ()),
         (esca, "compute_w_hat_from_colsum", "W_hat", ()),
         (three_branch, "word_stats", "word stats", ()),
         (three_branch, "skip_phase", "skip test", ()),
         (lda_step, "survivor_indices", "compaction", ()),
         (lda_step, "sample_fused_rows", "head sampling", ()),
         (lda_step, "sample_fused_tiled_rows", "head sampling", ()),
         (lda_step, "branch_stats", "stats", ()),
         (lda_step, "scatter_changed_deltas", "±1 scatters", ())]
    if paper:
        t += [(sparse, "densify_rows_sorted", "densify", ()),
              (sparse, "pack_rows_sorted", "repack", ()),
              (ops, "sparse_tail_draw_rows", "tail draw (Q' inside)", ())]
    return t


# -- phase 5: resume and serving ---------------------------------------------

def split_held_out(corpus, n_train_docs: int):
    """The first ``n_train_docs`` documents of a planted corpus as the
    training corpus, relabeled by frequency, and the others as held-out
    documents (word-id arrays) in its vocabulary: both drawn from the same
    planted topics."""
    from types import SimpleNamespace
    from repro_torch.lda.corpus import relabel_by_frequency
    keep = corpus.doc_ids < n_train_docs
    word = corpus.word_ids[keep]
    # relabel reads the word counts and the two id arrays: the document
    # index of the corpus before relabeling is not built (~5 s at 100 M)
    train, old_to_new = relabel_by_frequency(SimpleNamespace(
        word_ids=word, doc_ids=corpus.doc_ids[keep],
        word_token_counts=np.bincount(word, minlength=corpus.n_words)
        .astype(np.int64), n_words=corpus.n_words, n_docs=n_train_docs))
    held_doc = corpus.doc_ids[~keep]
    order = np.argsort(held_doc, kind="stable")
    held_word = old_to_new[corpus.word_ids[~keep][order]]
    cuts = np.flatnonzero(np.diff(held_doc[order])) + 1
    return train, np.split(held_word, cuts)


def same_state(a, b, n_real: int) -> bool:
    """Topics of the real tokens, D and W bitwise equal."""
    return bool(torch.equal(a.topics[:n_real], b.topics[:n_real])
                and torch.equal(a.D, b.D) and torch.equal(a.W, b.W))


def phase_resume(engine, corpus, ckpt_dir: str, label: str) -> dict:
    """``save()`` a path's state after its ``fit``, build a fresh engine
    on the same corpus, ``resume()`` it, and hold topics, D and W bitwise
    to the live engine's, before and after one more iteration on both.
    Launch counts zeroed just before ``resume()`` and read after both
    engines' iteration."""
    from repro_torch.lda import LDAEngine
    n_real = corpus.n_tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = engine.save()
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    fresh = LDAEngine(corpus, engine.config, checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    fresh.resume()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume_launches = read_counts()
    check(fresh.iteration == engine.iteration,
          f"[{label} resume] iteration {fresh.iteration}, saved "
          f"{engine.iteration}")
    check(same_state(fresh.state, engine.state, n_real),
          f"[{label} resume] topics, D or W differ from the live "
          "engine's")
    saved_at = engine.iteration
    llpt = [engine.fit(1)["llpt"][-1], fresh.fit(1)["llpt"][-1]]
    torch.cuda.synchronize()
    launches = read_counts()
    check(same_state(fresh.state, engine.state, n_real),
          f"[{label} resume] after one more iteration, topics, D or W "
          "differ")
    check(llpt[0] == llpt[1], f"[{label} resume] LLPT {llpt[1]} after one "
          f"more iteration, the live engine's {llpt[0]}")
    print(f"[{label} resume] save of iteration {saved_at}: "
          f"{size / 2**20:.1f} MiB in {save_s:.2f} s; fresh engine built in "
          f"{build_s:.2f} s; resume() (load, checksum, D/W rebuilt) in "
          f"{resume_s:.2f} s; topics, D and W bitwise the live engine's, "
          f"and again after one more iteration on both (LLPT {llpt[1]:.4f} "
          f"both); launches in resume(): {resume_launches}; with one more "
          f"iteration of each engine: {launches}")
    del fresh
    return {"save_s": save_s, "bytes": size, "build_s": build_s,
            "resume_s": resume_s, "resume_launches": resume_launches,
            "launches": launches, "llpt_after": llpt[1]}


def phase_serving(engine, held: list, tmp: str, seed: int) -> dict:
    """``export()`` the dense path's state, check that ``from_payload``
    and a ``save``/``load`` round trip give W bitwise, answer REQUESTS
    requests of REQUEST_DOCS held-out documents with SWEEPS sweeps each
    (launch counts zeroed just before and read just after), then hold
    one sweep's ``sample_fused`` launch to its twin and its batch-D
    ``histogram`` launch bitwise to its twin, each timed beside its
    bound."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels.ref import histogram_sorted_ref
    from repro_torch.lda import FrozenLDAModel
    from repro_torch.core import three_branch
    from repro_torch.train.lda_step import draw_uniforms
    t0 = time.perf_counter()
    model = engine.export()
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    check(model.device.type == "cuda", "the served model is not on the card")
    t0 = time.perf_counter()
    back = FrozenLDAModel.load(model.save(os.path.join(tmp, "frozen.npz")))
    io_s = time.perf_counter() - t0
    check(back.device.type == "cuda" and np.array_equal(back.W, model.W),
          "serving: save/load changed W or left the card")
    from_payload = FrozenLDAModel.from_payload(
        engine.host_payload(), engine.corpus, engine.config,
        word_map=engine.word_map)
    check(np.array_equal(from_payload.W, model.W),
          "serving: from_payload's W differs from export()'s")
    del back, from_payload
    score = engine.score()
    requests = [held[r * REQUEST_DOCS:(r + 1) * REQUEST_DOCS]
                for r in range(REQUESTS)]
    check(all(len(r) == REQUEST_DOCS for r in requests),
          f"serving: {len(held)} held-out docs for {REQUESTS} requests")
    zero_counts()
    rows = []
    for r, docs in enumerate(requests):
        n_tok = int(sum(d.size for d in docs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.fold_in(docs, n_sweeps=SWEEPS, seed=seed + r)
        dt = time.perf_counter() - t0
        check(res.theta.shape == (REQUEST_DOCS, K_MAIN)
              and bool(np.isfinite(res.theta).all())
              and np.allclose(res.theta.sum(axis=1), 1.0, atol=1e-4),
              f"serving: request {r}'s θ is not a distribution")
        check(np.isfinite(res.llpt), f"serving: request {r}'s LLPT")
        rows.append({"seconds": dt, "docs_per_s": REQUEST_DOCS / dt,
                     "tokens": n_tok, "tokens_per_s": n_tok / dt,
                     "llpt": res.llpt,
                     "frac_skipped": res.frac_skipped.tolist()})
        print(f"[serving] request {r}: {REQUEST_DOCS} docs, {n_tok:,} "
              f"tokens, {SWEEPS} sweeps in {dt:.3f} s: "
              f"{REQUEST_DOCS / dt:,.0f} docs/s, {n_tok / dt:,.0f} tokens/s;"
              f" fold-in LLPT {res.llpt:.4f} (training LLPT "
              f"{score:.4f}); skip fraction per sweep "
              f"{[round(x, 4) for x in res.frac_skipped.tolist()]}")
    launches = read_counts()
    want = {"sample_fused": SWEEPS * REQUESTS,
            "histogram": (SWEEPS + 1) * REQUESTS}
    for name, n in want.items():
        check(launches[name] == n, f"serving: {launches[name]} launches of "
              f"{name}, expected {n} (sweeps x requests"
              f"{' + one initial D each' if name == 'histogram' else ''})")
    print(f"[serving] export() in {export_s:.2f} s, save + load of the "
          f"{model.W.nbytes / 2**20:.0f} MiB model in {io_s:.2f} s; "
          f"launches over {REQUESTS} requests: {launches}")

    # one sweep, held to the twins and timed
    batch = model.prepare_batch(requests[0])
    plan = model.count_plan(batch)
    n = batch.word_ids.shape[0]
    topics = model.transform_batch(batch, seed, n_sweeps=1)[2]
    D = model.batch_counts(batch, topics, plan)
    u = draw_uniforms(seed, 1, n, model.device)
    alpha = float(model.alpha)
    dec = three_branch.skip_phase(u, batch.word_ids, batch.doc_ids, D,
                                  model._stats, g=model.g, alpha=alpha)
    surv = ((batch.mask > 0) & ~dec.skip).nonzero().squeeze(1)
    u_s, d_s, v_s = u[surv], batch.doc_ids[surv], batch.word_ids[surv]
    stats = model._k1_a1_q
    max_abs, n_mism, _ = compare_sample_fused(
        *fused_pair(sf, u_s, d_s, v_s, D, model._w_hat, stats, alpha), u_s,
        d_s, v_s, D, model._w_hat, alpha, "serving sweep")

    def draw():
        return sf.sample_fused_rows(u_s, d_s, v_s, D, model._w_hat, *stats,
                                    alpha=alpha)

    ms = cuda_ms(draw, reps=20)
    plain_ms = cuda_ms(lambda: sf.sample_fused_rows_plain(
        u_s, d_s, v_s, D, model._w_hat, *stats, alpha=alpha), reps=3)
    t, m, s_, q = draw()
    b_ms, b_by, b_bytes = sample_fused_bound_ms(u_s, d_s, v_s, t, D,
                                                u_s * (m + s_ + q) < m)
    new = dec.k1.clone()
    new[surv] = t
    got = model.batch_counts(batch, new, plan)
    check(torch.equal(got, histogram_sorted_ref(new, batch.mask, plan)),
          "serving: the batch-D histogram differs from its twin")
    h_ms = cuda_ms(lambda: hist.histogram_sorted(new, batch.mask, plan),
                   reps=20)
    h_plain = cuda_ms(lambda: histogram_sorted_ref(new, batch.mask, plan),
                      reps=3)
    flat = (batch.doc_ids.long() * K_MAIN + new.long())[batch.mask > 0]
    h_lib = cuda_ms(lambda: torch.bincount(flat, minlength=batch.n_docs
                                           * K_MAIN), reps=20)
    rows_ = batch.n_docs
    h_bytes = 8 * n + 8 * (rows_ + 1) + 32 * plan.blocks.shape[0] \
        + 8 * plan.split_rows.numel() + rows_ * K_MAIN * 4
    h_bound, h_by = bound(h_bytes, n)
    print(f"[serving] one sweep of request 0 ({n:,} slots, "
          f"{surv.numel():,} survivors): sample_fused {ms:.4f} ms (twin "
          f"{plain_ms:.3f} ms), bound {b_ms:.4f} ms by {b_by} "
          f"({b_bytes / 1e6:.1f} MB), {n_mism} topic mismatches at CDF "
          f"boundaries, max |dmass| {max_abs:.3g}; batch-D histogram "
          f"{h_ms:.4f} ms (twin {h_plain:.3f} ms, torch.bincount "
          f"{h_lib:.4f} ms), bound {h_bound:.4f} ms by {h_by}, bitwise its "
          "twin")
    return {"export_s": export_s, "save_load_s": io_s, "score": score,
            "requests": rows, "launches": launches,
            "sweep": {"slots": n, "survivors": surv.numel(),
                      "sample_fused": {"ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": b_ms, "bound_by": b_by,
                                       "bound_bytes": b_bytes,
                                       "max_abs_err": max_abs,
                                       "topic_mismatches": n_mism},
                      "histogram": {"ms": h_ms, "plain_ms": h_plain,
                                    "library_ms": h_lib, "bound_ms": h_bound,
                                    "bound_by": h_by,
                                    "bound_bytes": h_bytes}}}


SERVE_REPLICAS, SERVE_COVERAGE, SERVE_SWEEPS = 2, 0.9, 2
SERVE_CHECK_DOCS, SERVE_KILL_DOCS = 256, 512


def phase_serve_service(engine, held: list, seed: int,
                        fold_in: dict | None = None) -> dict:
    """The serving tier on the dense path's model: ``LDAService`` with two
    replicas sharing the card, the hot head sized to 90% of the training
    tokens, 2 sweeps with the alias warm start; every held-out document
    submitted as its own request. Then: a cached replica's θ bitwise a
    full-table replica's on the same batch and seed; the engine trains one
    more iteration with the service attached, and the refreshed service
    answers bitwise as one built fresh from the last snapshot's freeze;
    replica 0 killed mid-traffic, every request still answered.
    ``fold_in`` is the serving phase's record, whose requests' docs/s the
    service's are printed beside."""
    from repro_torch.runtime import chaos
    from repro_torch.serve import (LDAService, Replica, ServeConfig,
                                   ServiceOverloaded, attach)
    from repro_torch.serve.replicas import pack_docs
    t_phase = time.perf_counter()
    model = engine.export()
    cfg = ServeConfig(n_replicas=SERVE_REPLICAS, hot_coverage=SERVE_COVERAGE,
                      n_sweeps=SERVE_SWEEPS, warm_start=True, seed=seed)
    zero_counts()
    t0 = time.perf_counter()
    svc = LDAService(model, cfg)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0
    n_tok = int(sum(d.size for d in held))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        futs = [svc.submit(d) for d in held]
    except ServiceOverloaded as exc:
        fail(f"[serve_service] a request was refused: {exc}")
    thetas = np.stack([f.result(timeout=600) for f in futs])
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = svc.stats()
    check(thetas.shape == (len(held), K_MAIN)
          and bool(np.isfinite(thetas).all())
          and np.allclose(thetas.sum(axis=1), 1.0, atol=1e-4),
          "[serve_service] a θ row is not a distribution")
    check(st["completed"] == len(held) and st["failed"] == 0
          and st["rejected"] == 0, f"[serve_service] {st}")
    for name in ("sample_fused", "histogram", "vose_tables"):
        check(launches[name] > 0,
              f"[serve_service] the service launched {name} no time")
    lat = st["latency"]
    H = svc.hot_words
    beside = ""
    if fold_in is not None:
        rates = [r["docs_per_s"] for r in fold_in["requests"]]
        beside = (f" (FrozenLDAModel.fold_in in this run, {REQUEST_DOCS:,}-"
                  f"doc requests of {SWEEPS} sweeps: {min(rates):,.0f}-"
                  f"{max(rates):,.0f} docs/s)")
    print(f"[serve_service] {len(held):,} held-out docs ({n_tok:,} tokens), "
          f"one request each, {SERVE_REPLICAS} replicas on the card, hot "
          f"head {H:,} of {model.n_words:,} words (coverage "
          f"{SERVE_COVERAGE}), {SERVE_SWEEPS} sweeps, warm start: "
          f"{len(held) / wall:,.0f} docs/s, {n_tok / wall:,.0f} tokens/s"
          f"{beside}; latency p50 {lat['p50_ms']:.1f} ms, p95 "
          f"{lat['p95_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms; cache hit "
          f"rate {st['cache_hit_rate']:.4f}; batch fill "
          f"{st['batch_fill']:.3f} over {st['batches']} batches; service "
          f"built in {build_s:.2f} s, warmed in {warm_s:.2f} s; launches "
          f"{launches}")

    # a cached replica against a full-table one, same batch and seed
    packed = pack_docs(held[:SERVE_CHECK_DOCS], n_words=model.n_words,
                       word_map=model.word_map, doc_buckets=cfg.buckets,
                       token_floor=cfg.token_floor)
    cached = svc.replicas.replicas[0]
    full = Replica(99, model, hot_words=model.n_words)
    a = cached.infer_packed(packed, seed, n_sweeps=SERVE_SWEEPS, seq=7)
    b = full.infer_packed(packed, seed, n_sweeps=SERVE_SWEEPS, seq=7)
    check(np.array_equal(a[0], b[0]) and a[1] == b[1]
          and a[2]["cache_misses"] > 0 and b[2]["cache_misses"] == 0,
          "[serve_service] the cached replica's θ or LLPT differs from the "
          "full-table replica's")
    del full

    # one more iteration with the service attached: its refreshed answers
    # against a service built from a freeze of the last snapshot
    snaps = []
    unsub = attach(engine, svc, on_snapshot=snaps.append)
    t0 = time.perf_counter()
    engine.fit(1)
    refresh_fit_s = time.perf_counter() - t0
    unsub()
    last = snaps[-1]
    check(len(snaps) == 2 and last.cursor == 0
          and last.iteration == engine.iteration
          and svc.stats()["refreshes"] == 2
          and not np.array_equal(last.W, model.W),
          f"[serve_service] snapshots {[(x.iteration, x.cursor) for x in snaps]}")
    docs = held[:SERVE_CHECK_DOCS]
    got = svc.transform(docs, key=seed, timeout=600)
    with LDAService(last.freeze(model.device),
                    dataclasses.replace(cfg, n_replicas=1)) as fresh:
        want = fresh.transform(docs, key=seed, timeout=600)
    check(np.array_equal(got, want), "[serve_service] the refreshed service "
          "differs from one built fresh from the boundary snapshot")

    # replica 0 dies holding a batch: the survivor answers every request.
    # The requests go in batches of 32, and replica 1 sleeps on its first,
    # so replica 0 surely picks one while the plan is armed
    before = svc.stats()
    kill_docs = held[:SERVE_KILL_DOCS]
    with chaos.active(chaos.FaultPlan(kill_replicas=(0,),
                                      slow_replicas={1: 0.5})):
        futs = [f for i in range(0, len(kill_docs), 32)
                for f in svc.submit_batch(kill_docs[i:i + 32])]
        killed = [f.result(timeout=600) for f in futs]
    after = svc.stats()
    check(len(killed) == SERVE_KILL_DOCS
          and all(t.shape == (K_MAIN,) for t in killed)
          and after["alive_replicas"] == SERVE_REPLICAS - 1
          and after["requeued_batches"] > before["requeued_batches"]
          and after["failed"] == 0,
          f"[serve_service] the kill drill: {after}")
    svc.close()
    print(f"[serve_service] bitwise: a cached replica (hot head {H:,}) and a "
          f"full-table one on {SERVE_CHECK_DOCS} docs, θ and LLPT; one more "
          f"training iteration published {len(snaps)} snapshots "
          f"({refresh_fit_s:.2f} s with the swaps), the refreshed service "
          f"answers as a fresh freeze of the last; replica 0 killed "
          f"mid-traffic: {SERVE_KILL_DOCS} requests in batches of 32 all "
          f"answered, "
          f"{after['requeued_batches'] - before['requeued_batches']} batch "
          f"re-queued; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "docs": len(held), "tokens": n_tok,
            "wall_s": wall, "docs_per_s": len(held) / wall,
            "tokens_per_s": n_tok / wall, "latency_ms": lat,
            "cache_hit_rate": st["cache_hit_rate"],
            "batch_fill": st["batch_fill"], "batches": st["batches"],
            "hot_words": H, "build_s": build_s, "warmup_s": warm_s,
            "refresh_fit_s": refresh_fit_s,
            "phase_s": time.perf_counter() - t_phase}


def stream_checks(engine, rec: dict, resident: dict, label: str) -> None:
    """A streamed or disk run against its resident path: topics, D, W
    (digests, at the run's last iteration) and every iteration's LLPT
    bitwise; then its epoch, shard, transfer and memory numbers."""
    pipe = engine.trainer.fused_pipeline()
    n = len(rec["llpt"])
    digests = {len(resident["llpt"]): resident["digest"],
               **resident.get("digests", {})}
    check(n in digests, f"[{label}] its resident path kept no digest at "
          f"iteration {n}")
    for name, want in digests[n].items():
        check(rec["digest"][name] == want,
              f"[{label}] {name} differs from the resident path's")
    check(rec["llpt"] == resident["llpt"][:n],
          f"[{label}] LLPT {rec['llpt']} differs from the resident "
          f"path's {resident['llpt'][:n]}")
    epochs = [it["seconds"] for it in rec["iterations"]]
    res_s = [it["seconds"] for it in resident["iterations"]]
    ios = [it["io"] for it in rec["iterations"]]
    rec["stream"] = {
        "shards": pipe.stream.n_shards, "shard_len": pipe.stream.shard_len,
        "epoch_s": epochs, "io": ios,
        "device_bytes": pipe.last_epoch_device_bytes,
        "page_rows": getattr(pipe, "page_rows", None)}
    print(f"[{label}] bitwise the resident path: topics, D, W and LLPT "
          f"after every iteration ({len(rec['llpt'])})")
    print(f"[{label}] seconds per epoch {[round(x, 3) for x in epochs]} "
          f"against the resident {[round(x, 3) for x in res_s]}")
    for i, io in enumerate(ios, start=1):
        print(f"[{label}] epoch {i}: shard seconds "
              f"{[round(x, 3) for x in io['shard_s']]}; H2D "
              f"{io['h2d_bytes'] / 1e9:.3f} GB, D2H "
              f"{io['d2h_bytes'] / 1e9:.3f} GB; take() blocked "
              f"{io['take_wait_s']:.3f} s")
    extra = "" if rec["stream"]["page_rows"] is None else \
        f"; page_rows {rec['stream']['page_rows']:,} of " \
        f"{pipe.n_words:,} W rows"
    print(f"[{label}] peak device memory {rec['peak_bytes'] / 2**30:.2f} "
          f"GiB against the resident {resident['peak_bytes'] / 2**30:.2f} "
          f"GiB; last_epoch_device_bytes "
          f"{pipe.last_epoch_device_bytes / 2**30:.3f} GiB{extra}")


def phase_mid_epoch(engine, corpus, ckpt_dir: str, label: str) -> dict:
    """``run_shards(MID_EPOCH_SHARDS)`` on a streamed engine after its
    ``fit``, ``save()`` of the mid-epoch state, a fresh engine
    ``resume()``s it, both finish the epoch (``fit(1)``), and topics, D,
    W and LLPT must agree bitwise. Launch counts zeroed just before
    ``run_shards`` and read after both fits."""
    from repro_torch.lda import LDAEngine
    pipe = engine.trainer.fused_pipeline()
    n_padded = engine.trainer.n_padded_tokens
    zero_counts()
    t0 = time.perf_counter()
    engine._state = pipe.run_shards(pipe.from_lda_state(engine.state),
                                    MID_EPOCH_SHARDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(engine.state.cursor == MID_EPOCH_SHARDS,
          f"[{label}] cursor {engine.state.cursor} after run_shards")
    t0 = time.perf_counter()
    path = engine.save()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = LDAEngine(corpus, engine.config, checkpoint_dir=ckpt_dir)
    fresh.resume()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    check(fresh.state.cursor == MID_EPOCH_SHARDS
          and fresh.iteration == engine.iteration,
          f"[{label}] the resumed engine is at cursor {fresh.state.cursor},"
          f" iteration {fresh.iteration}")
    llpt = [engine.fit(1)["llpt"][-1], fresh.fit(1)["llpt"][-1]]
    torch.cuda.synchronize()
    launches = read_counts()
    check(digest(engine.state, n_padded) == digest(fresh.state, n_padded),
          f"[{label}] topics, D or W differ after both finished the epoch")
    check(llpt[0] == llpt[1], f"[{label}] LLPT {llpt[1]} against the "
          f"live engine's {llpt[0]}")
    print(f"[{label}] run_shards({MID_EPOCH_SHARDS}) {run_s:.2f} s; save of "
          f"the mid-epoch state {os.path.getsize(path) / 2**20:.1f} MiB in "
          f"{save_s:.2f} s; a fresh engine and resume() (counts and deltas "
          f"folded) in {resume_s:.2f} s; both finish the epoch bitwise "
          f"(LLPT {llpt[1]:.4f}); launches {launches}")
    del fresh
    return {"run_shards_s": run_s, "save_s": save_s, "resume_s": resume_s,
            "bytes": os.path.getsize(path), "launches": launches,
            "llpt_after": llpt[1]}


def phase_streaming(corpus, resident: dict, args, tmp: str, paths: dict,
                    phases: dict) -> None:
    """streamed_dense and streamed_paper (``corpus_residency="streamed"``,
    STREAM_SHARDS shards), the mid-epoch resume on streamed_dense, and
    disk_paper from a CorpusStore of the same stream; each bitwise its
    resident path."""
    from repro_torch.lda.corpus import shard_stream
    streamed = dict(corpus_residency="streamed", stream_shards=STREAM_SHARDS)
    ckpt = os.path.join(tmp, "streamed")
    engine, paths["streamed_dense"] = phase_path(
        corpus, "streamed_dense", streamed, args.iters, args.seed,
        checkpoint_dir=ckpt, digests=True)
    stream_checks(engine, paths["streamed_dense"], resident["dense"],
                  "streamed_dense")
    phases["mid_epoch"] = phase_mid_epoch(engine, corpus, ckpt,
                                          "streamed_dense mid-epoch")
    del engine
    torch.cuda.empty_cache()

    engine, paths["streamed_paper"] = phase_path(
        corpus, "streamed_paper", dict(PAPER, **streamed), args.iters,
        args.seed, digests=True)
    stream_checks(engine, paths["streamed_paper"], resident["paper"],
                  "streamed_paper")
    tile_size = engine.config.tile_size
    del engine
    torch.cuda.empty_cache()

    check(bool(np.all(np.diff(corpus.word_token_counts) <= 0)),
          "the corpus is not relabeled by frequency, as its store must be")
    t0 = time.perf_counter()
    stream = shard_stream(corpus, STREAM_SHARDS, multiple=tile_size)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = stream.to_store(os.path.join(tmp, "store"))
    write_s = time.perf_counter() - t0
    del stream
    nbytes = store.nbytes()
    print(f"[disk_paper] shard_stream in {shard_s:.1f} s; CorpusStore of "
          f"{store.n_shards} shards ({nbytes / 1e9:.3f} GB) written in "
          f"{write_s:.1f} s")
    # DRILL_ITERS epochs (its shard loads bound it, 3.2-3.9 s an epoch),
    # held to the paper path's digest there
    engine, rec = phase_path(
        None, "disk_paper", dict(PAPER, corpus_residency="disk",
                                 corpus_path=store.path),
        DRILL_ITERS, args.seed, digests=True)
    rec["store"] = {"path": store.path, "bytes": nbytes, "write_s": write_s,
                    "shard_stream_s": shard_s}
    paths["disk_paper"] = rec
    stream_checks(engine, rec, resident["paper"], "disk_paper")
    del engine
    torch.cuda.empty_cache()
    for label, names in (("streamed_dense", ("sample_fused",)),
                         ("streamed_paper", ("sample_fused_tiled",
                                             "sample_sparse_tiled")),
                         ("disk_paper", ("sample_fused", "sample_sparse"))):
        for name in names + ("histogram_any",):
            check(paths[label]["launches"][name] > 0,
                  f"the {label} path launched {name} no time")


# -- phase 7: the failure model -----------------------------------------------

DRILL_ITERS = 2            # the streamed and disk drills' length: their
                           # faults fire in iterations 1 and 2, and every
                           # path's LLPT must rise over its fit
DIST_ITERS = 1             # the one-rank distributed and the PS paths'
                           # (phases 8-9; 2 until PR 31): held bitwise to
                           # the dense path's and hybrid_none's digest
                           # after it
OOM_CAP_BYTES = 12 << 30   # between the streamed (5.96) and resident (23.25
                           # GiB) dense peaks at the full size (PERF.md §5)


@contextlib.contextmanager
def timed_calls(owner, name: str, sink: list):
    """Replace ``owner.name`` (a method of an instance or a class) by a
    wrapper that appends (the call's first argument after ``self`` if it
    is an int, a step key, else None; seconds on the card) to ``sink``;
    restored on exit. The sink holds no engine, trainer or state."""
    orig = getattr(owner, name)
    own = name in vars(owner)
    first = 1 if isinstance(owner, type) else 0

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        key = args[first] if len(args) > first else None
        sink.append((int(key) if isinstance(key, (int, np.integer))
                     else None,
                     time.perf_counter() - t0))
        return out

    setattr(owner, name, call)
    try:
        yield sink
    finally:
        if own or isinstance(owner, type):
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


def held_to(rec: dict, path: dict, label: str, n: int | None = None
            ) -> None:
    """A drill that ends at iteration ``n`` (by default the path's last):
    its topics, D and W bitwise its path's digest there, and its LLPT
    after each iteration it evaluated (a supervised history holds the
    attempt that finished) bitwise the path's."""
    its = rec["history_iterations"]
    n = len(path["llpt"]) if n is None else n
    check(its[-1] == n, f"[{label}] ended at iteration {its[-1]}, not {n}")
    digests = {len(path["llpt"]): path["digest"], **path["digests"]}
    check(n in digests, f"[{label}] its path kept no digest at iteration {n}")
    for name, want in digests[n].items():
        check(rec["digest"][name] == want,
              f"[{label}] {name} differs from its path's")
    want = [path["llpt"][it - 1] for it in its]
    check(rec["llpt"] == want,
          f"[{label}] LLPT {rec['llpt']} after iterations {its}, its "
          f"path's {want}")
    print(f"[{label}] bitwise its path: topics, D, W, and LLPT after "
          f"iterations {rec['history_iterations']}")


def drill_kernels(rec: dict, label: str, names) -> None:
    for name in names:
        check(rec["launches"][name] > 0,
              f"[{label}] launched {name} no time")


def restart_report(rec: dict) -> dict:
    check("restart_report" in rec, "a supervised fit returned no report")
    return rec["restart_report"]


def selfcheck_ms(fn) -> float:
    """Milliseconds of one tripwire call (it reads its verdict back)."""
    return cuda_ms(fn, reps=5, warmup=1)


def phase_failure(corpus, paths: dict, args, tmp: str, phases: dict) -> None:
    """The failure model (``fit(supervise=)``, ``selfcheck``, the chaos
    drills) on the NYTimes corpus, each drill bitwise the path it
    replays."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.lda import LDAEngine, LDATrainer, invariants
    from repro_torch.runtime.fault import SupervisePolicy
    from repro_torch.runtime import chaos

    iters, seed = args.iters, args.seed
    t_phase = time.perf_counter()
    policy = SupervisePolicy(checkpoint_every=2, backoff_base=0.0)

    # 1. supervision with no fault: its cost on the dense path. Each chunk
    # is timed by fit's on_chunk, the hooks' window: the chaos check and
    # the chunk (the supervisor's StepTimer runs just after it); the fit
    # wall less its saves takes in everything else the supervisor adds
    saves = []
    with timed_calls(LDATrainer, "_save", saves), \
            timed_calls(LDAEngine, "save", saves):
        engine, rec = phase_path(corpus, "supervised_dense", {}, iters,
                                 seed,
                                 checkpoint_dir=os.path.join(tmp, "f_dense"),
                                 digests=True, fit_kw=dict(supervise=policy))
    held_to(rec, paths["dense"], "supervised_dense")
    rep = restart_report(rec)
    check(rep["restarts"] == 0 and not rep["faults"],
          f"[supervised_dense] a clean run restarted: {rep}")
    drill_kernels(rec, "supervised_dense", ("sample_fused", "histogram"))
    dense = paths["dense"]
    sup = [it["seconds"] for it in rec["iterations"]]
    plain = [it["seconds"] for it in dense["iterations"]]
    save_s = sum(t for _, t in saves)
    rec["save_s"] = [t for _, t in saves]
    rec["overhead"] = float(np.mean(sup[1:]) / np.mean(plain[1:]) - 1)
    rec["overhead_wall"] = float((rec["fit_wall_s"] - save_s)
                                 / dense["fit_wall_s"] - 1)
    print(f"[supervised_dense] seconds per iteration, chaos check and "
          f"chunk, {[round(x, 4) for x in sup]} against the unsupervised "
          f"dense path's {[round(x, 4) for x in plain]}: iterations "
          f"2-{iters} {rec['overhead']:+.2%}")
    print(f"[supervised_dense] fit wall {rec['fit_wall_s']:.3f} s: chunks "
          f"{sum(sup):.3f}, {len(saves)} saves {save_s:.3f} "
          f"({[round(t, 3) for t in rec['save_s']]}), the rest (init, "
          f"evals, the supervisor) {rec['fit_wall_s'] - save_s - sum(sup):.3f}"
          f"; the unsupervised fit wall {dense['fit_wall_s']:.3f} s: chunks "
          f"{sum(plain):.3f}, the rest (init, evals) "
          f"{dense['fit_wall_s'] - sum(plain):.3f}; the wall less the saves "
          f"{rec['overhead_wall']:+.2%}")
    # a real tripwire on the dense counts, on the card
    pipe = engine.trainer.fused_pipeline()
    fs = pipe.from_lda_state(engine.state)
    rec["selfcheck_dense_ms"] = selfcheck_ms(lambda: pipe.selfcheck(fs))
    k = int(torch.argmax(fs.D[0]))
    fs.D[0, k] -= 1
    try:
        pipe.selfcheck(fs)
        fail("[supervised_dense] a decremented D cell passed selfcheck")
    except invariants.InvariantViolation as e:
        check(e.invariant == "token_conservation",
              f"[supervised_dense] tripped {e.invariant}, not "
              "token_conservation")
        print(f"[supervised_dense] selfcheck on D ({tuple(fs.D.shape)}), W "
              f"({tuple(fs.W.shape)}) and colsum: "
              f"{rec['selfcheck_dense_ms']:.3f} ms; D[0, {k}] - 1 trips "
              f"it: {e}")
    phases["supervised_dense"] = rec
    del engine, pipe, fs
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the paper path under selfcheck, killed at step 3
    loads, restores = [], []
    with timed_calls(CheckpointManager, "restore_latest", loads), \
            timed_calls(LDATrainer, "state_from_payload", restores):
        engine, rec = phase_path(
            corpus, "paper_killed", dict(PAPER, selfcheck=True), iters,
            seed, checkpoint_dir=os.path.join(tmp, "f_paper"), digests=True,
            fit_kw=dict(supervise=policy),
            plan=chaos.FaultPlan(raise_at_steps=(3,)))
    held_to(rec, paths["paper"], "paper_killed")
    rep = restart_report(rec)
    check(rep["restarts"] == 1 and rep["resumed_from"] == [2]
          and rep["faults"][0].startswith("InjectedFault"),
          f"[paper_killed] report {rep}")
    drill_kernels(rec, "paper_killed", ("sample_fused_tiled",
                                        "sample_sparse_tiled", "histogram"))
    rec["restore_s"] = [round(t, 3) for _, t in restores]
    rec["load_s"] = [round(t, 3) for _, t in loads]
    pipe = engine.trainer.fused_pipeline()
    hs = pipe.from_lda_state(engine.state)
    rec["selfcheck_packed_ms"] = selfcheck_ms(lambda: pipe.selfcheck(hs))
    hs.colsum[0] -= 1
    try:
        pipe.selfcheck(hs)
        fail("[paper_killed] a decremented colsum passed selfcheck")
    except invariants.InvariantViolation as e:
        check(e.invariant == "token_conservation",
              f"[paper_killed] tripped {e.invariant}")
        print(f"[paper_killed] recovery {rep['recovery_seconds']} s, then "
              f"the next attempt's checkpoint load {rec['load_s']} s and "
              f"restore (counts rebuilt) {rec['restore_s']} s; selfcheck on "
              f"the packed counts {rec['selfcheck_packed_ms']:.3f} ms; "
              f"colsum[0] - 1 trips it: {e}")
    phases["paper_killed"] = rec
    del engine, pipe, hs
    gc.collect()
    torch.cuda.empty_cache()

    # 3. streamed_dense, killed mid-epoch, checkpoints every 4 shards
    saves, restores = [], []
    streamed = dict(corpus_residency="streamed", stream_shards=STREAM_SHARDS)

    def watch_saves(engine):
        stack.enter_context(timed_calls(engine.checkpoint_manager, "save",
                                        saves))

    with contextlib.ExitStack() as stack, \
            timed_calls(LDATrainer, "state_from_payload", restores):
        engine, rec = phase_path(
            corpus, "streamed_killed", streamed, DRILL_ITERS, seed,
            checkpoint_dir=os.path.join(tmp, "f_streamed"), digests=True,
            fit_kw=dict(supervise=SupervisePolicy(checkpoint_shards=4,
                                                  backoff_base=0.0)),
            plan=chaos.FaultPlan(raise_at_shards=((DRILL_ITERS - 1, 5),)),
            on_engine=watch_saves)
    held_to(rec, paths["dense"], "streamed_killed", DRILL_ITERS)
    rep = restart_report(rec)
    check(rep["restarts"] == 1 and rep["resumed_from"] == [DRILL_ITERS - 1],
          f"[streamed_killed] report {rep}")
    drill_kernels(rec, "streamed_killed", ("sample_fused", "histogram_any"))
    S1 = STREAM_SHARDS + 1
    rec["mid_epoch_save_s"] = [round(t, 3) for k, t in saves if k % S1]
    rec["boundary_save_s"] = [round(t, 3) for k, t in saves if not k % S1]
    rec["restore_s"] = [round(t, 3) for _, t in restores]
    print(f"[streamed_killed] mid-epoch saves {rec['mid_epoch_save_s']} s, "
          f"epoch-boundary saves {rec['boundary_save_s']} s, the mid-epoch "
          f"restore (counts and deltas folded) {rec['restore_s']} s, "
          f"recovery {rep['recovery_seconds']} s")
    phases["streamed_killed"] = rec
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # 4. disk_paper: a corrupted shard absorbed by the prefetcher's retry,
    # an I/O fault past the retry budget escalated to one restart
    plan = chaos.FaultPlan(corrupt_shards=(3,), corrupt_attempts=1,
                           io_fault_shards=(5,), io_fault_attempts=3)
    store = paths["disk_paper"]["store"]["path"]
    engine, rec = phase_path(
        None, "disk_faults", dict(PAPER, corpus_residency="disk",
                                  corpus_path=store), DRILL_ITERS, seed,
        checkpoint_dir=os.path.join(tmp, "f_disk"), digests=True,
        fit_kw=dict(supervise=policy), plan=plan)
    held_to(rec, paths["disk_paper"], "disk_faults", DRILL_ITERS)
    rep = restart_report(rec)
    corrupted = plan._attempts.get(("corrupt", 3), 0)
    io_tries = plan._attempts.get(("io", 5), 0)
    # shard 3: a corrupt load and its clean retry, then one load an epoch
    # after the restart; shard 5: three failed loads, then one an epoch
    check(rep["restarts"] == 1 and len(rep["faults"]) == 1
          and rep["faults"][0].startswith("OSError")
          and corrupted == 2 + DRILL_ITERS
          and io_tries == 3 + DRILL_ITERS,
          f"[disk_faults] report {rep}; shard 3 loads {corrupted}, shard 5 "
          f"loads {io_tries}")
    drill_kernels(rec, "disk_faults", ("sample_fused", "sample_sparse",
                                       "histogram_any"))
    print(f"[disk_faults] shard 3 corrupted once and reloaded clean on the "
          f"worker ({corrupted} loads, no restart); shard 5 failed "
          f"{plan.io_fault_attempts} loads, past the retry budget of 2: one "
          f"restart, fault {rep['faults'][0]!r}, recovery "
          f"{rep['recovery_seconds']} s")
    phases["disk_faults"] = rec
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # 5. a real out-of-memory fault on the resident dense path, degraded
    # once to streamed residency under a capped allocator
    ck = os.path.join(tmp, "f_oom")
    engine, rec = phase_path(corpus, "oom_first", {}, 2, seed,
                             checkpoint_dir=ck, fit_kw=dict(supervise=policy))
    phases["oom_first"] = rec
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # the cap lies between this run's streamed and resident dense peaks:
    # 12 GiB at the full size, their midpoint where a cut corpus lowers them
    lo, hi = (paths[k]["peak_bytes"] for k in ("streamed_dense", "dense"))
    cap = min(OOM_CAP_BYTES, (lo + hi) // 2)
    check(lo < cap < hi, f"no room for a cap between the streamed peak {lo} "
          f"and the resident peak {hi}")
    total = torch.cuda.get_device_properties(0).total_memory
    frac = cap / total
    mem = []

    def watch_rebuild(engine):
        rebuild = engine._rebuild_trainer

        def call(report=None):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            rebuild(report)
            torch.cuda.synchronize()
            mem.append((before, torch.cuda.memory_allocated()))
        engine._rebuild_trainer = call

    print(f"[oom_degrade] allocator capped at {frac:.4f} of "
          f"{total / 2**30:.2f} GiB ({cap / 2**30:.2f} GiB; the streamed and "
          f"resident dense peaks {lo / 2**30:.2f} and {hi / 2**30:.2f} GiB); "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    torch.cuda.set_per_process_memory_fraction(frac)
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            engine, rec = phase_path(
                corpus, "oom_degrade", dict(corpus_residency="full",
                                            stream_shards=STREAM_SHARDS),
                iters - 2, seed, checkpoint_dir=ck, digests=True,
                fit_kw=dict(supervise=policy), on_engine=watch_rebuild)
        residency = engine.trainer.residency
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    getter = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    lifted = getter is None or getter(0) == 1.0
    big = torch.empty(2 * cap, dtype=torch.uint8, device="cuda")
    del big
    torch.cuda.empty_cache()
    check(lifted, "the allocator cap was not lifted")
    held_to(rec, paths["dense"], "oom_degrade")
    rep = restart_report(rec)
    check(rep["restarts"] == 1 and rep["degraded_to_streamed"]
          and rep["faults"][0].startswith("OutOfMemoryError")
          and "CUDA out of memory" in rep["faults"][0]
          and residency == "streamed" and rep["resumed_from"] == [2, 2],
          f"[oom_degrade] report {rep}, residency {residency}")
    check(any("degrading once" in str(w.message) for w in warned),
          "[oom_degrade] no degrade warning")
    check(rec["peak_bytes"] <= cap,
          f"[oom_degrade] peak {rec['peak_bytes']} past the cap")
    drill_kernels(rec, "oom_degrade", ("sample_fused", "histogram",
                                       "histogram_any"))
    rec["rebuild_allocated"] = mem
    rec["cap_bytes"] = cap
    print(f"[oom_degrade] the fault: {rep['faults'][0][:160]}")
    print(f"[oom_degrade] memory allocated at the rebuild's start (the dead "
          f"attempt's state dropped, its trainer still held) and after it: "
          f"{[(round(a / 2**30, 3), round(b / 2**30, 3)) for a, b in mem]} "
          f"GiB; peak {rec['peak_bytes'] / 2**30:.2f} GiB under the cap; "
          f"recovery {rep['recovery_seconds']} s; the cap lifted "
          f"(fraction 1.0, then {2 * cap / 2**30:.1f} GiB "
          "allocated and freed)")
    phases["oom_degrade"] = rec

    # 6. warp_dense under selfcheck: the tables of vose_tables checked
    engine, rec = phase_path(corpus, "warp_selfcheck",
                             dict(WARP_DENSE, selfcheck=True), 2, seed,
                             digests=True)
    held_to(rec, paths["warp_dense"], "warp_selfcheck")
    drill_kernels(rec, "warp_selfcheck", ("vose_tables",
                                          "warp_chain_tokens", "histogram"))
    pipe = engine.trainer.fused_pipeline()
    fs = pipe.from_lda_state(engine.state)
    tables = pipe.build_proposal(fs)      # checked inside, under selfcheck
    rec["alias_check_ms"] = selfcheck_ms(
        lambda: invariants.check_alias_tables(*tables, where="chip_smoke"))
    for field, value in (("prob", 1.5), ("alias", K_MAIN)):
        bad = getattr(tables, field).clone()
        bad[0, 0] = value
        try:
            invariants.check_alias_tables(*tables._replace(**{field: bad}),
                                          where="chip_smoke")
            fail(f"[warp_selfcheck] {field}[0, 0] = {value} passed")
        except invariants.InvariantViolation as e:
            check(e.invariant == "alias_tables_valid",
                  f"[warp_selfcheck] tripped {e.invariant}")
            print(f"[warp_selfcheck] {field}[0, 0] = {value} trips it: "
                  f"{e.detail}")
        del bad
    print(f"[warp_selfcheck] check_alias_tables on the tables "
          f"({tuple(tables.prob.shape)}): {rec['alias_check_ms']:.3f} ms")
    phases["warp_selfcheck"] = rec
    del engine, pipe, fs, tables
    gc.collect()
    torch.cuda.empty_cache()
    print(f"failure-model phase wall {time.perf_counter() - t_phase:.1f} s")


# -- phase 8: the distributed trainer -----------------------------------------

DRILL_TOKENS, DRILL_DOCS = 2_000_000, 6_000   # NYTimes' tokens a doc (3 M
                                              # and 9,000 until PR 32)
DRILL_WORDS = 10_000      # the drills' vocabulary: the protocol across ranks
                          # and PS workers, not the width (dist_dense,
                          # dist_hybrid and ps_dense move NYTimes' W); the
                          # four ranks' W all-reduces go through the host
DRILL_RANKS = 4
DRILL_DIST_ITERS = 2      # the four-rank drill's fits; the single dense run
                          # goes one further for the restored checkpoint
DRILL_STREAMED = dict(corpus_residency="streamed", stream_shards=4)
DRILL_CASES = (           # (name, mesh, knobs): model axis 1 bitwise, and
                          # the topic split against the single run; each
                          # streamed case bitwise its resident one
    ("tiles_4x1", (4, 1), dict(balance="tiles")),
    ("hybrid_4x1", (4, 1), dict(format="hybrid", tail_sampler="sparse")),
    ("split_2x2", (2, 2), {}),
    ("streamed_tiles_4x1", (4, 1), dict(DRILL_STREAMED, balance="tiles")),
    ("streamed_split_2x2", (2, 2), DRILL_STREAMED),
)
STREAMED_DRILL_OF = {"streamed_tiles_4x1": "tiles_4x1",
                     "streamed_split_2x2": "split_2x2"}
# the supervised replicated fit: a chaos fault on ONE rank, each run held
# bitwise to the single dense run after its iterations (name, mesh, knobs,
# iterations, the faulted rank, its FaultPlan knobs, SupervisePolicy knobs)
SUPERVISED_DRILLS = (
    ("sup_raise_4x1", (4, 1), {}, 3, 1, dict(raise_at_steps=(2,)),
     dict(checkpoint_every=1)),
    ("sup_io_streamed_4x1", (4, 1), DRILL_STREAMED, 2, 2,
     dict(io_fault_shards=(2,)), dict(checkpoint_shards=1)),
    ("sup_oom_4x1", (4, 1), {}, 2, 3, dict(oom_at_steps=(1,)),
     dict(checkpoint_every=1)),
)
SPLIT_LLPT_GAP = 0.15     # the reference's model-axis bound
                          # (tests/test_distributed.py::test_model_axis_parity)
SPLIT_MISMATCH_FRAC = 0.01   # as tests/_torch_parity.py bounds them
DRILL_TIMEOUT_S = 400


def drill_corpus(seed: int, tokens: int):
    """The drills' planted corpus (the four ranks' and the parameter
    server's): NYTimes' tokens a document, DRILL_TOKENS tokens over
    DRILL_WORDS words, so that a W all-reduce, a page, a journal block and
    a mid-round payload are a tenth of NYTimes' W; rebuilt from the
    seed."""
    from repro_torch.lda.corpus import planted_corpus
    n = min(tokens, DRILL_TOKENS)
    return planted_corpus(seed, n_docs=max(DRILL_DOCS * n // DRILL_TOKENS, 64),
                          n_words=DRILL_WORDS, n_tokens=n, n_planted=K_MAIN)


def dist_record(engine) -> dict:
    """Digests of a distributed engine's canonical topics and gathered D
    and W (what a single path's ``digest`` holds as topics_real, D, W)."""
    topics = engine.host_payload()["topics_global"]
    D, W = engine.trainer.gather_global(engine.state)
    out = {"topics_real": sha(topics), "D": sha(D), "W": sha(W)}
    del D, W
    return out


def measured(fn) -> tuple:
    """(fn(), seconds, peak device memory, memory allocated before it):
    ``reset_peak_memory_stats`` just before, the peak read just after."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            before)


def time_evaluate(engine, label: str, want: float) -> dict:
    """One more LLPT evaluation of a distributed or PS engine's state, held
    to ``want`` (the fit's last LLPT): its seconds and the device memory
    it adds. On the replicated trainer (which evaluates each rank's own
    tokens against its own rows, no global D) also the gathered
    evaluation it replaced, timed the same way: the global D and W, then
    the single engine's padded order folded in chunks, which must give
    the same bits."""
    from repro_torch.lda import distributed as dist_mod
    tr = engine.trainer
    score, seconds, peak, before = measured(
        lambda: tr.evaluate(engine.state))
    check(score == want, f"[{label}] LLPT evaluated again {score}, the "
          f"fit's {want}")
    out = {"evaluate_s": seconds, "evaluate_peak_bytes": peak,
           "evaluate_extra_bytes": peak - before}
    if engine._backend.mesh is not None:
        arrays = [dist_mod._pinned(a, tr.device) for a in
                  dist_mod._padded_order(tr.corpus, tr.cfg.tile_size)]

        def gathered():
            D, W = tr.gather_global(engine.state)
            return dist_mod._folded_llpt(arrays, D, W, tr.cfg, tr.device)

        old, out["gathered_s"], peak, before = measured(gathered)
        out["gathered_peak_bytes"] = peak
        out["gathered_extra_bytes"] = peak - before
        check(old == score, f"[{label}] the gathered evaluation gives "
              f"{old}, the per-rank one {score}")
        del arrays
    return out


def eval_text(ev: dict) -> str:
    text = (f"an LLPT evaluation {ev['evaluate_s']:.3f} s, peak "
            f"{ev['evaluate_peak_bytes'] / 2**30:.3f} GiB, "
            f"{ev['evaluate_extra_bytes'] / 2**30:.3f} GiB above the state")
    if "gathered_s" in ev:
        text += (f" (each rank's own tokens and rows; the gathered one it "
                 f"replaced, bitwise the same value: "
                 f"{ev['gathered_s']:.3f} s, peak "
                 f"{ev['gathered_peak_bytes'] / 2**30:.3f} GiB, "
                 f"{ev['gathered_extra_bytes'] / 2**30:.3f} GiB above)")
    return text


def time_dist_iteration(engine) -> dict:
    """One more iteration of a distributed engine, its dW all-reduce and
    its scatter into the delta buffer timed with CUDA events."""
    tr = engine.trainer
    calls = []

    def timed(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            torch.cuda.synchronize()
            shape = tuple(args[0].shape) if args and isinstance(
                args[0], torch.Tensor) else None
            calls.append((name, start.elapsed_time(stop), shape))
            return out
        return call

    tr.mesh.psum = timed("psum", tr.mesh.psum)
    tr._scatter_deltas = timed("scatter_deltas", tr._scatter_deltas)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._state, _ = tr.run_fused(engine.state, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del tr.mesh.psum, tr._scatter_deltas
    delta = (tr.n_words + 1 + tr.n_shared, tr.k_local)
    psum_ms = [ms for name, ms, shape in calls
               if name == "psum" and shape == delta]
    check(len(psum_ms) == 1, f"dW all-reduces in one iteration: {calls}")
    return {"iteration_s": wall, "dw_psum_ms": psum_ms[0],
            "dw_bytes": int(np.prod(delta)) * 4,
            "scatter_deltas_ms": sum(ms for name, ms, _ in calls
                                     if name == "scatter_deltas"),
            "psum_ms_other": sum(ms for name, ms, shape in calls
                                 if name == "psum" and shape != delta)}


def phase_dist_path(corpus, label: str, kw: dict, n_iters: int, seed: int,
                    path: dict, want: dict) -> dict:
    """``LDAEngine(backend="distributed")`` on a (1, 1) mesh of the NCCL
    group, ``fit(n_iters)`` held bitwise to the single path ``path`` (its
    digest ``want`` after n_iters: topics, D, W, and every LLPT), its
    export's W too; then one more iteration timed by stage."""
    from repro_torch.lda import LDAConfig, LDAEngine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                    **kw)
    t0 = time.perf_counter()
    engine = LDAEngine(corpus, cfg, backend="distributed")
    build_s = time.perf_counter() - t0
    tr = engine.trainer
    check(engine.backend_name == "distributed"
          and engine.device.type == "cuda"
          and dict(tr.mesh.shape) == {"data": 1, "model": 1}
          and tr.mesh.backend == "nccl",
          f"[{label}] not a (1, 1) NCCL mesh on the card: {tr.mesh}")
    per_iter = []
    zero_counts()
    t0 = time.perf_counter()
    hist = engine.fit(n_iters, on_chunk=lambda it, chunk, dt: per_iter.append(
        {"iteration": it, "seconds": dt}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    got = dist_record(engine)
    for name, value in got.items():
        check(value == want[name], f"[{label}] {name} differs from the "
              f"single path's after {n_iters} iterations")
    check(hist["llpt"] == path["llpt"][:n_iters],
          f"[{label}] LLPT {hist['llpt']}, the single path's "
          f"{path['llpt'][:n_iters]}")
    check(sha(engine.export().W) == want["W"],
          f"[{label}] the exported W differs from the single path's")
    ev = time_evaluate(engine, label, hist["llpt"][-1])
    timing = time_dist_iteration(engine)
    # the count build again, its process groups now set up: the first one
    # also set up the mesh's NCCL communicators at their first all-reduce
    first_build = tr.count_build_seconds
    again = tr._state_from_topics(engine.state.topics.clone(),
                                  engine.iteration)
    rebuilt, live = tr.dense_rows(again), tr.dense_rows(engine.state)
    check(all(torch.equal(a, b) for a, b in zip(rebuilt, live)),
          f"[{label}] counts rebuilt from the topics differ from the live "
          "counts")
    del again, rebuilt, live
    single = [it["seconds"] for it in path["iterations"][:n_iters]]
    mine = [it["seconds"] for it in per_iter]
    print(f"[{label}] bitwise the single path after {n_iters} iterations: "
          f"topics, D, W, every LLPT ({[round(x, 4) for x in hist['llpt']]})"
          f" and the exported W")
    print(f"[{label}] seconds per iteration {[round(x, 4) for x in mine]} "
          f"against the single path's {[round(x, 4) for x in single]}")
    print(f"[{label}] one more iteration {timing['iteration_s']:.4f} s: dW "
          f"all-reduce ({timing['dw_bytes'] / 1e9:.3f} GB, world 1) "
          f"{timing['dw_psum_ms']:.3f} ms, scatter into dW and Δcolsum "
          f"{timing['scatter_deltas_ms']:.3f} ms, other all-reduces "
          f"{timing['psum_ms_other']:.3f} ms")
    print(f"[{label}] engine built in {build_s:.1f} s (shard_corpus on the "
          f"host {tr.shard_seconds:.2f} s); count build on the card "
          f"{first_build * 1e3:.1f} ms at init (with the communicators' set-"
          f"up), {tr.count_build_seconds * 1e3:.1f} ms again from the "
          f"topics, equal to the live counts; fit wall {wall:.1f} s; "
          f"{eval_text(ev)}; "
          f"peak device memory {peak / 2**30:.2f} GiB (the single path's "
          f"{path['peak_bytes'] / 2**30:.2f}), {base / 2**30:.2f} GiB held "
          f"before; launches {launches}")
    rec = {"config": kw, "iters": n_iters, "launches": launches,
           "llpt": hist["llpt"], "iterations": per_iter,
           "peak_bytes": peak, "base_bytes": base, "fit_wall_s": wall,
           "build_s": build_s, "shard_corpus_s": tr.shard_seconds,
           "count_build_first_s": first_build,
           "count_build_s": tr.count_build_seconds, "digest": got,
           **ev, **timing}
    del engine, tr
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def drill_rank(rank: int, seed: int, tokens: int, ckpt: str) -> dict:
    """One rank of the four-rank drill: every DRILL_CASES run, launch
    counts zeroed just before each and read just after."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig, LDAEngine
    from repro_torch.runtime.sharding import ProcessMesh
    corpus = drill_corpus(seed, tokens)
    out = {}
    for name, shape, kw in DRILL_CASES:
        cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                        **kw)
        tiles = name == "tiles_4x1"
        engine = LDAEngine(corpus, cfg, backend="distributed",
                           mesh=ProcessMesh(shape, ("data", "model")),
                           checkpoint_dir=ckpt if tiles else None)
        tr = engine.trainer
        per_iter = []

        def on_chunk(it, chunk, dt):
            per_iter.append({"iteration": it, "seconds": dt})

        rec = {"shard": tr.shard, "coords": dict(tr.mesh.coords),
               "n_shared": tr.n_shared, "shard_corpus_s": tr.shard_seconds,
               "tokens": int(tr.sc.mask[tr.shard].sum()),
               "residency": tr.residency}
        zero_counts()
        split = name.endswith("split_2x2")
        if split:
            engine.fit(1, on_chunk=on_chunk)
            rec["topics_1"] = engine.host_payload()["topics_global"]
            engine.fit(DRILL_DIST_ITERS - 1, on_chunk=on_chunk)
        else:
            engine.fit(DRILL_DIST_ITERS, on_chunk=on_chunk,
                       checkpoint_every=DRILL_DIST_ITERS if tiles else None)
        torch.cuda.synchronize()
        rec["launches"] = read_counts()
        rec["count_build_s"] = tr.count_build_seconds
        rec["llpt"] = list(engine.history["llpt"])
        rec["iterations"] = per_iter
        rec["digest"] = dist_record(engine)
        if split:
            # D and W against the histograms of the topics, on the card
            D, W = tr.gather_global(engine.state)
            topics = torch.from_numpy(
                engine.host_payload()["topics_global"]).cuda()
            c = engine.corpus
            Dh, Wh = esca.update_counts(
                torch.from_numpy(c.word_ids).cuda(),
                torch.from_numpy(c.doc_ids).cuda(), topics,
                torch.ones_like(topics), n_docs=c.n_docs,
                n_words=c.n_words, n_topics=K_MAIN)
            rec["counts_exact"] = bool(torch.equal(D, Dh)
                                       and torch.equal(W, Wh))
            del D, W, Dh, Wh, topics
        out[name] = rec
        del engine, tr
        gc.collect()
        torch.cuda.empty_cache()
    for case in SUPERVISED_DRILLS:
        out[case[0]] = supervised_drill(rank, corpus, seed, ckpt, *case)
    return out


def supervised_drill(rank: int, corpus, seed: int, ckpt: str, name: str,
                     shape, kw: dict, iters: int, faulted: int, plan: dict,
                     policy: dict) -> dict:
    """One supervised case of the four-rank drill: ``fit(supervise=)`` with
    the fault planted on rank ``faulted`` alone."""
    from repro_torch.lda import LDAConfig, LDAEngine
    from repro_torch.lda.api import SupervisePolicy
    from repro_torch.runtime import chaos
    from repro_torch.runtime.sharding import ProcessMesh
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                    **kw)
    engine = LDAEngine(corpus, cfg, backend="distributed",
                       mesh=ProcessMesh(shape, ("data", "model")),
                       checkpoint_dir=f"{ckpt}-{name}")
    fault = chaos.active(chaos.FaultPlan(**plan)) if rank == faulted \
        else contextlib.nullcontext()
    zero_counts()
    t0 = time.perf_counter()
    with fault:
        hist = engine.fit(iters, supervise=SupervisePolicy(
            backoff_base=0.0, **policy))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rep = hist["restart_report"]
    rec = {"seconds": seconds, "launches": read_counts(),
           "llpt": list(hist["llpt"]), "iterations": list(hist["iteration"]),
           "digest": dist_record(engine),
           "residency": engine.trainer.residency,
           "report": {k: getattr(rep, k) for k in (
               "completed_steps", "restarts", "resumed_from", "faults",
               "degraded_to_streamed")},
           "recovery_s": list(rep.recovery_seconds)}
    engine.trainer.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def drill_worker(rank: int, init: str, seed: int, tokens: int, ckpt: str,
                 out_dir: str, go: str) -> None:
    """A spawned rank: the card, the kernels the parent built (found by
    their source hash, not rebuilt), one gloo group of DRILL_RANKS. It
    imports, then waits for ``go`` before it touches the card (its start
    overlaps the world-1 paths)."""
    import pickle
    import traceback
    from datetime import timedelta
    out = Path(out_dir)
    try:
        torch.set_num_threads(2)
        import_port()
        deadline = time.monotonic() + DRILL_TIMEOUT_S
        while not Path(go).exists():
            check(time.monotonic() < deadline, "no go for the drill's ranks")
            time.sleep(0.05)
        torch.cuda.set_device(0)
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=DRILL_RANKS,
                                timeout=timedelta(seconds=DRILL_TIMEOUT_S))
        try:
            result = drill_rank(rank, seed, tokens, ckpt)
        finally:
            dist.destroy_process_group()
        with open(out / f"{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def start_drill_ranks(seed: int, tokens: int, ckpt: str, tmp: str):
    """DRILL_RANKS spawned ranks (daemons: they die with this process),
    each waiting for the handle's go file (``run_drill_ranks``)."""
    import multiprocessing as mp
    out = Path(tmp) / "drill"
    out.mkdir()
    go = str(out / "go")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=drill_worker, daemon=True,
                         args=(r, str(out / "rdzv"), seed, tokens, ckpt,
                               str(out), go))
             for r in range(DRILL_RANKS)]
    for p in procs:
        p.start()
    return procs, out, go


def run_drill_ranks(handle) -> list:
    """The ranks of ``start_drill_ranks`` given their go, joined within
    DRILL_TIMEOUT_S; a rank that fails or is late fails the phase (the
    rest are killed)."""
    import pickle
    procs, out, go = handle
    Path(go).touch()
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {r: (out / f"{r}.err").read_text()[-3000:]
            for r in range(DRILL_RANKS) if (out / f"{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    check(not late and not errs and all(c == 0 for c in codes),
          f"[drill] ranks: exit codes {codes}, past the deadline {late}\n"
          + "\n".join(f"--- rank {r} ---\n{e}" for r, e in errs.items()))
    results = []
    for r in range(DRILL_RANKS):
        with open(out / f"{r}.pkl", "rb") as f:   # written by our ranks
            results.append(pickle.load(f))
    return results


def drill_singles(corpus, seed: int) -> dict:
    """The drill corpus on the single-device engine: dense for
    DRILL_DIST_ITERS + 1 iterations (digests after each, topics after 1,
    the initial state for the split's boundary test), hybrid for
    DRILL_DIST_ITERS. Launches counted throughout."""
    from repro_torch.lda import LDAConfig, LDAEngine
    cfg = dict(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed)
    zero_counts()
    out = {"dense": {"digests": {}}, "hybrid": {}}
    dense = LDAEngine(corpus, LDAConfig(**cfg))
    n_real, n_padded = corpus.n_tokens, dense.trainer.n_padded_tokens
    out["init"] = dense.trainer.init_state()
    for it in range(1, DRILL_DIST_ITERS + 2):
        t0 = time.perf_counter()
        dense.fit(1)
        torch.cuda.synchronize()
        out["dense"]["digests"][it] = digest(dense.state, n_padded, n_real)
        out["dense"].setdefault("seconds", []).append(
            time.perf_counter() - t0)
        if it == 1:
            out["topics_1"] = dense.state.topics[:n_real].cpu().numpy()
    out["dense"]["llpt"] = list(dense.history["llpt"])
    del dense
    hybrid = LDAEngine(corpus, LDAConfig(**cfg, format="hybrid",
                                         tail_sampler="sparse"))
    hybrid.fit(DRILL_DIST_ITERS)
    out["hybrid"] = {"digest": digest(hybrid.state, n_padded, n_real),
                     "llpt": list(hybrid.history["llpt"])}
    del hybrid
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = read_counts()
    return out


def restore_drill_checkpoint(corpus, seed: int, ckpt: str, want: dict
                             ) -> dict:
    """(d): the tiles run's checkpoint in a single-device engine, and one
    more iteration bitwise the single run's."""
    from repro_torch.lda import LDAConfig, LDAEngine
    zero_counts()
    engine = LDAEngine(corpus, LDAConfig(n_topics=K_MAIN, eval_every=1,
                                         fused=True, seed=seed),
                       checkpoint_dir=ckpt).resume()
    check(engine.iteration == DRILL_DIST_ITERS,
          f"[drill d] restored iteration {engine.iteration}")
    engine.fit(1)
    n_padded = engine.trainer.n_padded_tokens
    got = digest(engine.state, n_padded, corpus.n_tokens)
    check(got == want, "[drill d] one more iteration from the distributed "
          "checkpoint differs from the single run's")
    launches = read_counts()
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches}


def split_boundaries(corpus, single: dict, got: np.ndarray, seed: int
                     ) -> tuple[int, float]:
    """The split run's topics after iteration 1 against the single run's:
    (mismatches, the largest distance of a mismatching draw from its CDF
    boundary, as a fraction of the token's mass, on the initial counts)."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig
    from repro_torch.train.lda_step import draw_uniforms
    cfg = LDAConfig(n_topics=K_MAIN, seed=seed)
    want = single["topics_1"]
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return 0, 0.0
    init = single["init"]
    idx = torch.from_numpy(diff).cuda()
    u = draw_uniforms(seed, 0, int(init.topics.shape[0]), "cuda")[idx]
    doc = torch.from_numpy(corpus.doc_ids).cuda()[idx].long()
    word = torch.from_numpy(corpus.word_ids).cuda()[idx].long()
    w_hat = esca.compute_w_hat(init.W, cfg.beta)
    dist = boundary_distance(u, init.D[doc].float(), w_hat[word], cfg.alpha_,
                             torch.from_numpy(got[diff]).cuda(),
                             torch.from_numpy(want[diff]).cuda())
    return int(diff.size), float(dist.max())


def supervised_checks(ranks: list, single: dict, phases: dict) -> None:
    """Each supervised case: every rank ends bitwise the single dense run
    after its iterations (topics, D, W and every LLPT it evaluated), with
    the same restart report naming the faulted rank; the out-of-memory
    case degraded every rank to streamed residency."""
    dense = single["dense"]
    keys = ("topics_real", "D", "W")
    for name, _shape, kw, iters, faulted, plan, _pol in SUPERVISED_DRILLS:
        recs = [r[name] for r in ranks]
        rep = recs[0]["report"]
        kind = next(iter(plan))
        streamed = kind == "oom_at_steps" or "corpus_residency" in kw
        check(all(r["report"] == rep for r in recs)
              and rep["restarts"] == 1 and rep["completed_steps"] == iters
              and len(rep["faults"]) == 1
              and f"rank {faulted}: " in rep["faults"][0]
              and rep["degraded_to_streamed"] == (kind == "oom_at_steps")
              and all(r["residency"] == ("streamed" if streamed else "full")
                      for r in recs),
              f"[drill {name}] restart reports {[r['report'] for r in recs]}")
        check(all({k: r["digest"][k] for k in keys}
                  == {k: dense["digests"][iters][k] for k in keys}
                  for r in recs)
              and all(v == dense["llpt"][it - 1] for it, v in
                      zip(recs[0]["iterations"], recs[0]["llpt"])),
              f"[drill {name}] differs from the single dense run after "
              f"{iters} iterations")
        launches = {k: sum(r["launches"][k] for r in recs)
                    for k in recs[0]["launches"]}
        phases[f"dist_drill_{name}"] = {
            "launches": launches, "report": rep,
            "seconds": [r["seconds"] for r in recs],
            "recovery_s": [r["recovery_s"] for r in recs]}
        print(f"[drill {name}] {kind} on rank {faulted} only: every rank "
              f"restarted once, resumed from {rep['resumed_from']}, "
              f"{rep['faults'][0]!r}; bitwise the single dense run after "
              f"{iters} iterations, every LLPT; "
              + ("every rank degraded to streamed residency; "
                 if rep["degraded_to_streamed"] else "")
              + f"fit seconds by rank "
              f"{[round(r['seconds'], 2) for r in recs]}, recovery "
              f"{[[round(x, 3) for x in r['recovery_s']] for r in recs]} s; "
              f"launches (all ranks) {launches}")


def phase_distributed(corpus, paths: dict, args, tmp: str,
                      phases: dict) -> None:
    """The distributed trainer: dist_dense and dist_hybrid on a one-rank
    NCCL group at full width, bitwise their single paths; then four gloo
    ranks sharing the card on the drill corpus: (4,1) tiles and hybrid
    bitwise the single runs, the (2,2) topic split against them, and a
    distributed checkpoint restored in a single engine."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "drill_ckpt")
    # the drill's ranks import beside the world-1 paths
    drill = start_drill_ranks(args.seed, args.tokens, ckpt, tmp)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv_nccl",
                            rank=0, world_size=1)
    try:
        paths["dist_dense"] = phase_dist_path(
            corpus, "dist_dense", {}, DIST_ITERS, args.seed, paths["dense"],
            paths["dense"]["digests"][DIST_ITERS])
        paths["dist_hybrid"] = phase_dist_path(
            corpus, "dist_hybrid", dict(PAPER, balance="none"), DIST_ITERS,
            args.seed, paths["hybrid_none"],
            paths["hybrid_none"]["digests"][DIST_ITERS])
    finally:
        dist.destroy_process_group()
    check(paths["dist_dense"]["launches"]["sample_fused"] > 0
          and paths["dist_hybrid"]["launches"]["sample_sparse"] > 0
          and all(paths[k]["launches"]["histogram_any"] > 0
                  for k in ("dist_dense", "dist_hybrid")),
          "the world-1 paths launched no sample_fused, sample_sparse or "
          "histogram")
    t_world1 = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    small = drill_corpus(args.seed, args.tokens)
    single = drill_singles(small, args.seed)
    phases["dist_drill_single"] = {"launches": single.pop("launches")}
    t_single = time.perf_counter() - t0
    print(f"[drill] corpus: {small.n_tokens:,} tokens, {small.n_docs:,} "
          f"docs, {small.n_words:,} words; single-device runs (dense "
          f"{DRILL_DIST_ITERS + 1}, hybrid {DRILL_DIST_ITERS} iterations) "
          f"in {t_single:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_drill_ranks(drill)
    t_ranks = time.perf_counter() - t0
    dense_d = single["dense"]["digests"]
    for name, _shape, _kw in DRILL_CASES:
        recs = [r[name] for r in ranks]
        check(all(r["digest"] == recs[0]["digest"] for r in recs),
              f"[drill {name}] the ranks gathered different counts")
        launches = {k: sum(r["launches"][k] for r in recs)
                    for k in recs[0]["launches"]}
        phases[f"dist_drill_{name}"] = {"launches": launches}
        secs = [[round(it["seconds"], 3) for it in r["iterations"]]
                for r in recs]
        print(f"[drill {name}] seconds per iteration by rank {secs}; "
              f"shard_corpus {recs[0]['shard_corpus_s']:.2f} s; count build "
              f"{[round(r['count_build_s'] * 1e3, 1) for r in recs]} ms; "
              f"tokens by rank {[r['tokens'] for r in recs]}; launches "
              f"(all ranks) {launches}. Not scaling numbers: the four ranks "
              "share one card's SMs, and gloo stages each all-reduce "
              "through the host")
    a = ranks[0]["tiles_4x1"]
    check(a["n_shared"] > 0, "[drill a] no shared rows under tiles")
    check({k: a["digest"][k] for k in ("topics_real", "D", "W")}
          == {k: dense_d[DRILL_DIST_ITERS][k]
              for k in ("topics_real", "D", "W")}
          and a["llpt"] == single["dense"]["llpt"][:DRILL_DIST_ITERS],
          "[drill a] (4,1) tiles differs from the single dense run")
    check(phases["dist_drill_tiles_4x1"]["launches"]["sample_fused_tiled"]
          + phases["dist_drill_tiles_4x1"]["launches"]["sample_fused"] > 0,
          "[drill a] no sample_fused launch")
    b = ranks[0]["hybrid_4x1"]
    check({k: b["digest"][k] for k in ("topics_real", "D", "W")}
          == {k: single["hybrid"]["digest"][k]
              for k in ("topics_real", "D", "W")}
          and b["llpt"] == single["hybrid"]["llpt"],
          "[drill b] (4,1) hybrid differs from the single hybrid run")
    check(phases["dist_drill_hybrid_4x1"]["launches"]["sample_sparse"] > 0,
          "[drill b] no sample_sparse launch")
    for name, resident in STREAMED_DRILL_OF.items():
        got, want = ranks[0][name], ranks[0][resident]
        check(got["residency"] == "streamed"
              and got["digest"] == want["digest"]
              and got["llpt"] == want["llpt"]
              and all(r[name]["counts_exact"] for r in ranks
                      if "counts_exact" in r[name]),
              f"[drill {name}] differs from its resident run {resident}")
    c = ranks[0]["split_2x2"]
    check(all(r["split_2x2"]["counts_exact"] for r in ranks),
          "[drill c] D or W differs from the histograms of the topics")
    n_mis, worst = split_boundaries(small, single, c["topics_1"], args.seed)
    check(n_mis <= SPLIT_MISMATCH_FRAC * small.n_tokens
          and worst <= BOUNDARY_FRAC,
          f"[drill c] after iteration 1: {n_mis} topics differ from the "
          f"single run's, the farthest {worst:.3g} of its mass from a "
          "boundary")
    gap = abs(c["llpt"][-1] - single["dense"]["llpt"][DRILL_DIST_ITERS - 1])
    check(gap <= SPLIT_LLPT_GAP, f"[drill c] LLPT gap {gap} to the single run")
    phases["dist_drill_restore"] = restore_drill_checkpoint(
        small, args.seed, ckpt, dense_d[DRILL_DIST_ITERS + 1])
    supervised_checks(ranks, single, phases)
    print(f"[drill] (a) (4,1) tiles bitwise the single dense run, "
          f"{a['n_shared']:,} shared rows; (b) (4,1) hybrid bitwise the "
          f"single hybrid run; (c) (2,2): D and W the histograms of its "
          f"topics, {n_mis} of {small.n_tokens:,} topics after iteration 1 "
          f"differ from the single run's, each within {worst:.3g} of its "
          f"mass from a CDF boundary, LLPT gap {gap:.5f} after "
          f"{DRILL_DIST_ITERS} (bound {SPLIT_LLPT_GAP}); (d) the tiles run's "
          "checkpoint restored in a single engine, one more iteration "
          "bitwise the single run; streamed (4,1) tiles and the streamed "
          "(2,2) split (4 sub-shards a rank) bitwise their resident runs")
    phases["distributed"] = {
        "launches": {k: 0 for k in counters()}, "world1_s": t_world1,
        "drill_single_s": t_single, "drill_ranks_s": t_ranks,
        "split_mismatches": n_mis, "split_worst_boundary": worst,
        "split_llpt_gap": gap, "n_shared": a["n_shared"],
        "drill": {name: {k: v for k, v in ranks[0][name].items()
                         if k != "topics_1"} for name, _s, _k in DRILL_CASES}}
    print(f"distributed phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(world 1: {t_world1:.1f} s; drill singles {t_single:.1f} s; "
          f"four ranks {t_ranks:.1f} s)")


# -- phase 9: streamed distributed residency and the parameter server ---------

PS_GRID = (("data", 4), ("model", 1))   # four workers, one process
PS_SHARDS = 2             # sub-shards a worker: each pulls and pushes a page
                          # of nearly V rows, so fewer sub-shards move fewer
PS_ITERS = 4              # the supervised PS drill's fit
PS_KILL_ROUNDS = 3        # the owner-kill drill: one round, a checkpoint,
                          # then the faults in round 2 and a revived owner
                          # serving round 3


def ps_drill_single(corpus, seed: int) -> dict:
    """The PS drill corpus on the single-device dense engine for PS_ITERS
    iterations: digests after each, every LLPT; launches counted."""
    from repro_torch.lda import LDAConfig, LDAEngine
    zero_counts()
    engine = LDAEngine(corpus, LDAConfig(n_topics=K_MAIN, eval_every=1,
                                         fused=True, seed=seed))
    n_padded = engine.trainer.n_padded_tokens
    digests = {}
    for it in range(1, PS_ITERS + 1):
        engine.fit(1)
        digests[it] = digest(engine.state, n_padded, corpus.n_tokens)
    out = {"dense": {"digests": digests,
                     "llpt": list(engine.history["llpt"])}}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = read_counts()
    return out


def dist_streamed_path(corpus, label: str, kw: dict, n_iters: int, seed: int,
                       path: dict, want: dict, beside: dict) -> dict:
    """``LDAEngine(backend="distributed", corpus_residency="streamed")`` on
    the one-rank NCCL group (1, 1), STREAM_SHARDS sub-shards, held
    bitwise to the single path ``path`` (digest ``want`` after n_iters,
    every LLPT, the exported W); its seconds an iteration and peak beside
    ``beside``'s paths."""
    from repro_torch.lda import LDAConfig, LDAEngine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                    corpus_residency="streamed", stream_shards=STREAM_SHARDS,
                    **kw)
    t0 = time.perf_counter()
    engine = LDAEngine(corpus, cfg, backend="distributed")
    build_s = time.perf_counter() - t0
    tr = engine.trainer
    check(engine.backend_name == "distributed"
          and engine.device.type == "cuda" and tr.residency == "streamed"
          and tr.stream.n_sub == STREAM_SHARDS
          and dict(tr.mesh.shape) == {"data": 1, "model": 1}
          and tr.mesh.backend == "nccl",
          f"[{label}] not a streamed (1, 1) NCCL mesh on the card")
    per_iter, io = [], []

    def on_chunk(it, chunk, dt):
        per_iter.append({"iteration": it, "seconds": dt})
        io.append({k: v for k, v in tr.last_epoch_io.items()
                   if k != "sub_s"})
        io[-1]["sub_s"] = list(tr.last_epoch_io.get("sub_s", []))

    zero_counts()
    t0 = time.perf_counter()
    hist = engine.fit(n_iters, on_chunk=on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    got = dist_record(engine)
    for name, value in got.items():
        check(value == want[name], f"[{label}] {name} differs from the "
              f"single path's after {n_iters} iterations")
    check(hist["llpt"] == path["llpt"][:n_iters],
          f"[{label}] LLPT {hist['llpt']}, the single path's "
          f"{path['llpt'][:n_iters]}")
    check(sha(engine.export().W) == want["W"],
          f"[{label}] the exported W differs from the single path's")
    ev = time_evaluate(engine, label, hist["llpt"][-1])
    mine = [round(it["seconds"], 4) for it in per_iter]
    print(f"[{label}] bitwise the single path after {n_iters} iterations: "
          f"topics, D, W, every LLPT "
          f"({[round(x, 4) for x in hist['llpt']]}) and the exported W")
    print(f"[{label}] seconds per iteration {mine}; "
          + "; ".join(f"{k} {[round(it['seconds'], 4) for it in p['iterations'][:n_iters]]}"
                      for k, p in beside.items()))
    print(f"[{label}] peak device memory {peak / 2**30:.2f} GiB ("
          + ", ".join(f"{k} {p['peak_bytes'] / 2**30:.2f}"
                      for k, p in beside.items())
          + f"), {base / 2**30:.2f} GiB held before; an epoch: H2D "
          f"{io[-1]['h2d_bytes'] / 1e9:.3f} GB, D2H "
          f"{io[-1]['d2h_bytes'] / 1e9:.3f} GB, take() blocked "
          f"{[round(e['take_wait_s'], 4) for e in io]} s, a sub-shard "
          f"{min(io[-1]['sub_s']):.4f}-{max(io[-1]['sub_s']):.4f} s; "
          f"engine built in {build_s:.1f} s (shard_corpus "
          f"{tr.shard_seconds:.2f} s), count build "
          f"{tr.count_build_seconds * 1e3:.1f} ms; fit wall {wall:.1f} s; "
          f"{eval_text(ev)}; launches {launches}")
    rec = {"config": kw, "iters": n_iters, "launches": launches, **ev,
           "llpt": hist["llpt"], "iterations": per_iter, "epoch_io": io,
           "peak_bytes": peak, "base_bytes": base, "fit_wall_s": wall,
           "build_s": build_s, "shard_corpus_s": tr.shard_seconds,
           "count_build_s": tr.count_build_seconds, "digest": got}
    engine.trainer.close()
    del engine, tr
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ps_config(seed: int, kw: dict | None = None, **dist):
    from repro_torch.lda import LDAConfig
    from repro_torch.lda.model import DistConfig
    return LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                     stream_shards=PS_SHARDS, **(kw or {}),
                     dist=DistConfig(w_sync="ps", mesh_shape=PS_GRID, **dist))


def ps_path(corpus, label: str, kw: dict, n_iters: int, seed: int,
            path: dict, want: dict) -> dict:
    """``DistConfig(w_sync="ps")``: four workers on the card, staleness 0,
    four owners; held bitwise to the single path ``path`` (digest
    ``want``, every LLPT, the exported W); seconds a round split into
    pulls, sampling, pushes and the host commit."""
    from repro_torch.lda import LDAEngine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = LDAEngine(corpus, ps_config(seed, kw))
    build_s = time.perf_counter() - t0
    tr = engine.trainer
    check(engine.backend_name == "distributed" and engine._backend.is_ps
          and engine.device.type == "cuda" and tr.sc.n_shards == 4
          and tr._R == PS_SHARDS,
          f"[{label}] not four parameter-server workers on the card")
    per_iter = []
    zero_counts()
    tr.io = tr._zero_io()
    t0 = time.perf_counter()
    hist = engine.fit(n_iters, on_chunk=lambda it, chunk, dt: per_iter.append(
        {"iteration": it, "seconds": dt}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    io = dict(tr.io)
    srv = engine.state.server
    journal = tr.journal_nbytes(engine.state)
    owner, w_bytes = srv.max_owner_nbytes(), tr.n_words * K_MAIN * 4
    init_s = tr.count_build_seconds
    got = dist_record(engine)       # its payload trims the journals
    for name, value in got.items():
        check(value == want[name], f"[{label}] {name} differs from the "
              f"single path's after {n_iters} rounds")
    check(hist["llpt"] == path["llpt"][:n_iters],
          f"[{label}] LLPT {hist['llpt']}, the single path's "
          f"{path['llpt'][:n_iters]}")
    check(sha(engine.export().W) == want["W"],
          f"[{label}] the exported W differs from the single path's")
    check(owner <= 0.35 * w_bytes, f"[{label}] an owner holds {owner:,} B "
          f"of W's {w_bytes:,}")
    ev = time_evaluate(engine, label, hist["llpt"][-1])
    rounds = max(io["rounds"] // 4, 1)
    per = {k: io[k] / rounds for k in ("pull_s", "sample_s", "push_s",
                                       "commit_s", "pull_bytes",
                                       "push_bytes")}
    mine = [round(it["seconds"], 4) for it in per_iter]
    print(f"[{label}] bitwise the single path after {n_iters} rounds: "
          f"topics, D, W, every LLPT "
          f"({[round(x, 4) for x in hist['llpt']]}) and the exported W")
    print(f"[{label}] seconds per round {mine} (the single path's "
          f"{[round(it['seconds'], 4) for it in path['iterations'][:n_iters]]}"
          f"); a round: pulls {per['pull_s']:.3f} s, sampling "
          f"{per['sample_s']:.3f} s, pushes {per['push_s']:.3f} s, host "
          f"commit {per['commit_s']:.3f} s; {io['subs'] // rounds} "
          f"sub-shards of page_rows {tr.page_rows:,} of {tr.n_words:,}: "
          f"{per['pull_bytes'] / 1e9:.3f} GB pulled and "
          f"{per['push_bytes'] / 1e9:.3f} GB pushed")
    print(f"[{label}] journals after {n_iters} rounds {journal / 1e9:.3f} "
          f"GB; the largest owner {owner / 1e6:.1f} MB of W's "
          f"{w_bytes / 1e6:.1f} MB; peak device memory {peak / 2**30:.2f} "
          f"GiB (the single path's {path['peak_bytes'] / 2**30:.2f}), "
          f"{base / 2**30:.2f} GiB held before; engine built in "
          f"{build_s:.1f} s (shard_corpus {tr.shard_seconds:.2f} s, counts "
          f"and the server's load {init_s:.2f} s); fit wall {wall:.1f} s; "
          f"{eval_text(ev)} (W and D gathered from the owners and workers, "
          f"token order pinned on the host); launches {launches}")
    rec = {"config": kw, "iters": n_iters, "launches": launches,
           "llpt": hist["llpt"], "iterations": per_iter, "round": per,
           "page_rows": tr.page_rows, "journal_bytes": journal,
           "max_owner_bytes": owner, "w_bytes": w_bytes, "peak_bytes": peak,
           "base_bytes": base, "fit_wall_s": wall, "build_s": build_s,
           "shard_corpus_s": tr.shard_seconds, "init_s": init_s,
           **ev, "digest": got}
    del engine, tr, srv
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ps_drills(small, single: dict, seed: int, tmp: str) -> dict:
    """The parameter server's drills on their own corpus, each held to the
    single dense run's digest and LLPT: an owner killed after a
    checkpoint and revived by snapshot and journal replay, with lost
    pushes resent from the journals; a mid-round ``ps_*`` payload resumed
    in a fresh engine; ``fit(PS_ITERS, supervise=SupervisePolicy(
    checkpoint_shards=1))``; and staleness 2 with a slow worker (clocks
    aligned at the end, ``selfcheck`` passing)."""
    from repro_torch.lda import LDAEngine
    from repro_torch.lda.api import SupervisePolicy
    from repro_torch.runtime import chaos
    dense = single["dense"]
    out = {}

    def held(engine, n: int, hist_llpt, label: str) -> None:
        got = dist_record(engine)
        want = {k: dense["digests"][n][k] for k in got}
        check(got == want, f"[ps drill {label}] differs from the single "
              f"run after {n} rounds")
        check(hist_llpt == dense["llpt"][n - len(hist_llpt):n],
              f"[ps drill {label}] LLPT {hist_llpt}")

    zero_counts()
    t0 = time.perf_counter()
    eng = LDAEngine(small, ps_config(seed, n_owners=3))
    h1 = eng.fit(1)
    eng.host_payload()                  # a checkpoint: snapshot, trim
    # round 1's pushes of workers 2 and 0 lost once each; owner 1 dies
    # as round 1 commits, is revived from the snapshot plus round 1's
    # journals, and serves round 2
    plan = chaos.FaultPlan(ps_kill_owners=((1, 2),),
                           ps_lose_pushes=((2, 1), (0, 1)))
    with chaos.active(plan):
        h2 = eng.fit(PS_KILL_ROUNDS - 1)
    check(plan._fired == {("ps_kill", (1, 2)), ("ps_lose", (2, 1)),
                          ("ps_lose", (0, 1))},
          f"[ps drill owner_kill] faults fired: {plan._fired}")
    held(eng, PS_KILL_ROUNDS, h1["llpt"] + h2["llpt"], "owner_kill")
    out["owner_kill"] = {"s": time.perf_counter() - t0}
    del eng

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "ps_mid_round")
    eng = LDAEngine(small, ps_config(seed), checkpoint_dir=ckpt)
    eng.fit(1)
    eng._state = eng.trainer.run_shards(eng.state, 1)
    t1 = time.perf_counter()
    path = eng.save()
    save_s = time.perf_counter() - t1
    del eng
    t1 = time.perf_counter()
    fresh = LDAEngine(small, ps_config(seed), checkpoint_dir=ckpt).resume()
    resume_s = time.perf_counter() - t1
    check(fresh.iteration == 1 and bool(fresh.state.cursors.all()),
          f"[ps drill mid_round] restored at {fresh.iteration}, cursors "
          f"{fresh.state.cursors}")
    h = fresh.fit(1)                    # the rest of round 1
    held(fresh, 2, h["llpt"], "mid_round")
    out["mid_round"] = {"s": time.perf_counter() - t0, "save_s": save_s,
                        "resume_s": resume_s,
                        "bytes": os.path.getsize(path)}
    del fresh

    t0 = time.perf_counter()
    eng = LDAEngine(small, ps_config(seed),
                    checkpoint_dir=os.path.join(tmp, "ps_supervised"))
    h = eng.fit(PS_ITERS, supervise=SupervisePolicy(checkpoint_shards=1))
    held(eng, PS_ITERS, h["llpt"], "supervised")
    rep = h["restart_report"]
    check(rep.completed_steps == PS_ITERS and rep.restarts == 0,
          f"[ps drill supervised] {rep}")
    out["supervised"] = {"s": time.perf_counter() - t0}
    del eng

    t0 = time.perf_counter()
    eng = LDAEngine(small, ps_config(seed, staleness=2))
    tr = eng.trainer
    # one run_fused of 2 rounds (a fit evaluates after each round, so no
    # worker could run ahead): workers 1-3 run round 1 on round 0's pull
    with chaos.active(chaos.FaultPlan(ps_slow_workers={0: 2})):
        eng._state, _ = tr.run_fused(tr.init_state(), 2)
    clocks = eng.state.clocks
    check(int(clocks.min()) == int(clocks.max()) == 2,
          f"[ps drill stale] clocks {clocks}")
    tr.selfcheck(eng.state)
    check(dist_record(eng) != {k: dense["digests"][2][k]
                               for k in ("topics_real", "D", "W")},
          "[ps drill stale] no pull was stale: the run equals the single "
          "run")
    out["stale"] = {"s": time.perf_counter() - t0, "llpt": eng.score()}
    del eng, tr
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = read_counts()
    print(f"[ps drills] on {small.n_tokens:,} tokens, each bitwise the "
          f"single run: owner 1 killed as round 1 committed, after a "
          f"checkpoint, and revived; pushes (2, 1) and (0, 1) lost and "
          f"resent "
          f"({out['owner_kill']['s']:.1f} s); a mid-round payload "
          f"({out['mid_round']['bytes'] / 1e6:.1f} MB, saved in "
          f"{save_s:.2f} s) resumed in a fresh engine in {resume_s:.2f} s "
          f"({out['mid_round']['s']:.1f} s); fit({PS_ITERS}, "
          f"supervise=SupervisePolicy(checkpoint_shards=1)) "
          f"({out['supervised']['s']:.1f} s). Staleness 2 with worker 0 "
          f"slowed: clocks {clocks.tolist()}, selfcheck passed, LLPT "
          f"{out['stale']['llpt']:.6f} against the single run's "
          f"{dense['llpt'][1]:.6f} "
          f"({out['stale']['s']:.1f} s); launches {out['launches']}")
    return out


def phase_streamed_ps(corpus, paths: dict, args, tmp: str,
                      phases: dict) -> None:
    """Phase 9: dist_streamed_dense and dist_streamed_hybrid on a one-rank
    NCCL group, ps_dense and ps_hybrid (four workers in this process, no
    group), each bitwise its single path; then the PS drills on their own
    corpus, held to a single dense run of it."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv_nccl9",
                            rank=0, world_size=1)
    try:
        paths["dist_streamed_dense"] = dist_streamed_path(
            corpus, "dist_streamed_dense", {}, DIST_ITERS, args.seed,
            paths["dense"], paths["dense"]["digests"][DIST_ITERS],
            {k: paths[k] for k in ("streamed_dense", "dist_dense")})
        paths["dist_streamed_hybrid"] = dist_streamed_path(
            corpus, "dist_streamed_hybrid", dict(PAPER, balance="none"),
            DIST_ITERS, args.seed, paths["hybrid_none"],
            paths["hybrid_none"]["digests"][DIST_ITERS],
            {k: paths[k] for k in ("hybrid_none", "dist_hybrid")})
    finally:
        dist.destroy_process_group()
    t_streamed = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    paths["ps_dense"] = ps_path(corpus, "ps_dense", {}, DIST_ITERS,
                                args.seed, paths["dense"],
                                paths["dense"]["digests"][DIST_ITERS])
    paths["ps_hybrid"] = ps_path(corpus, "ps_hybrid",
                                 dict(PAPER, balance="none"), DIST_ITERS,
                                 args.seed, paths["hybrid_none"],
                                 paths["hybrid_none"]["digests"][DIST_ITERS])
    t_ps = time.perf_counter() - t0
    for label, name in (("dist_streamed_dense", "sample_fused"),
                        ("dist_streamed_hybrid", "sample_sparse"),
                        ("ps_dense", "sample_fused"),
                        ("ps_hybrid", "sample_sparse")):
        for k in (name, "histogram_any"):
            check(paths[label]["launches"][k] > 0,
                  f"the {label} path launched {k} no time")
    t0 = time.perf_counter()
    small = drill_corpus(args.seed, args.tokens)
    single = ps_drill_single(small, args.seed)
    phases["ps_drill_single"] = {"launches": single.pop("launches")}
    print(f"[ps drills] corpus: {small.n_tokens:,} tokens, "
          f"{small.n_docs:,} docs, {small.n_words:,} words; the single "
          f"dense run ({PS_ITERS} iterations) in "
          f"{time.perf_counter() - t0:.1f} s")
    phases["ps_drills"] = ps_drills(small, single, args.seed, tmp)
    t_drills = time.perf_counter() - t0
    print(f"streamed-distributed and parameter-server phase wall "
          f"{time.perf_counter() - t_phase:.1f} s (streamed world 1: "
          f"{t_streamed:.1f} s; ps paths {t_ps:.1f} s; ps drills "
          f"{t_drills:.1f} s)")


# -- phase 10: the rest of the LDA core -------------------------------------

TWO_BRANCH_HELD = 65_536      # iteration 1's tokens recomputed on the host
ELL_MOVES = 1 << 18           # (c): C moves; (C, L) temporaries ~8 GiB at
                              # L ~ 1000 unblocked, a block at a time here
SPARSE_D_SLICE = 1 << 20      # (b): the kernel held to its twin
M_FLIP_FRAC = 1e-4            # (b): M decisions that may flip, at a margin
SPARSE_D_TV = 0.01            # (b): topic histograms, total variation


def two_branch_host(u, d_rows, w_rows, alpha, got, block=8192) -> tuple:
    """float64 two-branch draws of tokens on the host, against the card's
    ``got``: (disagreements, the largest distance, as a fraction of the
    token's total mass, from its float64 draw to the interval of the
    card's topic in the S branch's CDF of D∘Ŵ or the Q branch's of α·Ŵ
    after it; 0 inside either, the last Q slot taking every x past the
    end)."""
    k = w_rows.shape[1]
    n_dis, worst = 0, 0.0
    for lo in range(0, u.shape[0], block):
        d = d_rows[lo:lo + block].astype(np.float64)
        w = w_rows[lo:lo + block].astype(np.float64)
        cs = np.cumsum(d * w, axis=1)
        cdf = np.concatenate([cs, cs[:, -1:] + np.cumsum(alpha * w, axis=1)],
                             axis=1)
        total = cdf[:, -1]
        x = u[lo:lo + block].astype(np.float64) * total
        j = np.minimum((cdf <= x[:, None]).sum(axis=1), 2 * k - 1)
        t = got[lo:lo + block]
        for i in np.flatnonzero(j % k != t):
            dist = np.inf
            for c in (int(t[i]), k + int(t[i])):
                a = cdf[i, c - 1] if c else 0.0
                b = np.inf if c == 2 * k - 1 else cdf[i, c]
                dist = min(dist, max(a - x[i], x[i] - b, 0.0))
            worst = max(worst, dist / total[i])
            n_dis += 1
    return n_dis, worst


def m_flip_dist(u, doc, word, D, W_hat, alpha) -> torch.Tensor:
    """Per token, the float64 distance (fraction of the total mass) from
    its draw to the M branch's boundary: M = a1·(b1 + α), the total
    Σ_k (D + α)·Ŵ."""
    v, d = word.long(), doc.long()
    w = W_hat[v].double()
    k1 = torch.argmax(W_hat[v], dim=1)
    a1 = w.gather(1, k1[:, None])[:, 0]
    dr = D[d].double()
    m = a1 * (dr.gather(1, k1[:, None])[:, 0] + alpha)
    total = ((dr + alpha) * w).sum(dim=1)
    return (u.double() * total - m).abs() / total


def lda_core_two_branch(corpus, seed: int, dense_llpt1: float) -> tuple:
    """(a): ``sampler="two_branch"`` through ``LDAEngine.fit(2)``, stepwise,
    ``impl="kernel"``, LLPT every iteration; iteration 1's first tokens
    recomputed on the host in float64. Returns (engine, record)."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig, LDAEngine
    from repro_torch.train.lda_step import draw_uniforms
    label = "lda_core two_branch"
    engine = LDAEngine(corpus, LDAConfig(n_topics=K_MAIN, eval_every=1,
                                         sampler="two_branch", seed=seed))
    tr = engine.trainer
    check(engine.device.type == "cuda" and tr.config.impl == "kernel"
          and not tr.config.fused, f"[{label}] not the stepwise kernel path")
    n = TWO_BRANCH_HELD
    init = tr.init_state()
    W_hat0 = esca.compute_w_hat(init.W, tr.config.beta)
    d_rows = init.D[tr.doc_ids[:n].long()].cpu().numpy()
    w_rows = W_hat0[tr.word_ids[:n].long()].cpu().numpy()
    u0 = draw_uniforms(seed, 0, tr.n_padded_tokens, engine.device)[:n]
    u0 = u0.cpu().numpy()
    del init, W_hat0
    per_iter, first = [], {}

    def on_chunk(it, chunk, dt):
        per_iter.append(dt)
        if it == 1:
            first["topics"] = tr._live["fs"].topics[:n].cpu().numpy()

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    hist = engine.fit(2, on_chunk=on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    llpt = hist["llpt"]
    check(hist["iteration"] == [1, 2] and all(np.isfinite(llpt))
          and llpt[1] > llpt[0], f"[{label}] LLPT did not rise: {llpt}")
    check(launches["histogram"] > 0,
          f"[{label}] the count rebuilds launched histogram no time")
    st = engine.state
    check(int(st.D.sum(dtype=torch.int64)) == tr.n_real_tokens
          and int(st.W.sum(dtype=torch.int64)) == tr.n_real_tokens,
          f"[{label}] count matrices do not sum to the token count")
    t0 = time.perf_counter()
    n_dis, worst = two_branch_host(u0, d_rows, w_rows, tr.config.alpha_,
                                   first["topics"])
    check(worst <= BOUNDARY_FRAC,
          f"[{label}] a draw lies {worst:.3g} of the mass from the card's "
          "topic's interval")
    s_branch = [h["frac_s_branch"] for h in hist["stats"]]
    print(f"[{label}] iterations 1, 2: {per_iter[0]:.3f} s, "
          f"{per_iter[1]:.3f} s ({tr.n_real_tokens / per_iter[1]:,.0f} "
          f"tokens/s); fit wall {wall:.1f} s with 2 LLPT evaluations; "
          f"frac_s_branch {[round(x, 4) for x in s_branch]}; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[{label}] LLPT after iterations 1, 2: "
          f"{[round(x, 4) for x in llpt]}; the dense path after iteration "
          f"1, from the same stream-0 topics: {dense_llpt1:.4f}")
    print(f"[{label}] iteration 1's first {n:,} tokens recomputed in float64 "
          f"on the host ({time.perf_counter() - t0:.1f} s): {n_dis} "
          f"disagreements, each within {worst:.3g} of the mass of a CDF "
          f"boundary (bound {BOUNDARY_FRAC})")
    return engine, {"seconds": per_iter, "llpt": llpt, "peak_bytes": peak,
                    "frac_s_branch": s_branch, "fit_wall_s": wall,
                    "host_disagreements": n_dis, "host_worst": worst,
                    "launches": launches}


def lda_core_sparse_d(tr, D, W, topics, seed: int, iteration: int) -> dict:
    """(b): every token through ``sample_tokens_sparse_d`` on
    ``build_sparse_rows`` rows of D at its max row nnz, against
    ``kops.sample_tokens`` on the same uniforms; the kernel against its
    twin on a slice; the launch beside the same draw over sorted rows."""
    from repro_torch.core import esca, sparse
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.kernels.sample_fused import word_stats_arrays
    from repro_torch.train.lda_step import draw_uniforms
    label = "lda_core sparse-D"
    alpha = tr.config.alpha_
    W_hat = esca.compute_w_hat(W, tr.config.beta)
    L = int((D > 0).sum(dim=1).max())
    top = sparse.build_sparse_rows(D, L)
    u = draw_uniforms(seed, iteration, tr.n_padded_tokens, D.device)
    word, doc = tr.word_ids, tr.doc_ids
    zero_counts()
    t_sp, st_sp = kops.sample_tokens_sparse_d(u, word, doc, topics, top, D,
                                              W_hat, alpha=alpha)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["sample_sparse"] == 1,
          f"[{label}] sample_sparse launched {launches['sample_sparse']} "
          "times, not once")
    t_dn, st_dn = kops.sample_tokens(u, word, doc, topics, D, W_hat,
                                     alpha=alpha)
    real = tr.mask > 0
    k1_w, a1_w, qp_w = word_stats_arrays(W_hat, alpha=alpha)
    k1 = k1_w[word.long()]
    flips = (((t_sp == k1) != (t_dn == k1)) & real).nonzero().squeeze(1)
    n_real = int(real.sum())
    check(flips.numel() <= M_FLIP_FRAC * n_real,
          f"[{label}] {flips.numel()} M decisions differ from the dense "
          f"draw's (bound {M_FLIP_FRAC:g} of {n_real:,})")
    dist = m_flip_dist(u[flips], doc[flips], word[flips], D, W_hat, alpha)
    worst = float(dist.max()) if flips.numel() else 0.0
    check(worst <= BOUNDARY_FRAC,
          f"[{label}] an M decision flips {worst:.3g} of the mass from M")
    h_sp = torch.bincount(t_sp[real].long(), minlength=K_MAIN).double()
    h_dn = torch.bincount(t_dn[real].long(), minlength=K_MAIN).double()
    tv = 0.5 * float((h_sp - h_dn).abs().sum()) / n_real
    check(tv <= SPARSE_D_TV, f"[{label}] topic histograms {tv:.4g} apart "
          f"in total variation (bound {SPARSE_D_TV})")
    # the kernel against its twin on a slice of the same rows
    sl = slice(0, SPARSE_D_SLICE)
    c = dict(u=u[sl], doc=doc[sl], word=word[sl], packed=top, W_hat=W_hat,
             k1_w=k1_w, a1_w=a1_w, qp_w=qp_w, alpha=alpha,
             b1=D[doc[sl].long(), k1[sl].long()].float())
    err, n_mism, q_share = compare_sample_sparse(*sparse_pair(ss, c), c,
                                                 c["word"], label)
    # the whole draw over top_k rows (no EMPTY_IDX slot: every L slot
    # walked) against sorted rows of the same D, in turns
    srt, _ = sparse.pack_rows_sorted(D, L)
    b1 = D[doc.long(), k1.long()].float()
    runs = {}
    for name, rows in (("top_k", top), ("sorted", srt), ("sorted", srt),
                       ("top_k", top)):
        runs.setdefault(name, []).append(cuda_ms(
            lambda rows=rows: ss.sample_sparse_rows(
                u, doc, word, rows, W_hat, k1_w, a1_w, qp_w, b1,
                alpha=alpha), reps=1, warmup=1))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    print(f"[{label}] {n_real:,} tokens over build_sparse_rows rows of the "
          f"dense path's final D (L = {L}, its max row nnz): M decisions "
          f"differ from kops.sample_tokens' on {flips.numel()} tokens, each "
          f"within {worst:.3g} of the mass from M (bounds {M_FLIP_FRAC:g} of the tokens, "
          f"{BOUNDARY_FRAC}); topic histograms {tv:.5f} apart in total "
          f"variation (bound {SPARSE_D_TV}); stats sparse "
          f"{ {k: round(float(v), 4) for k, v in st_sp._asdict().items()} } "
          f"dense { {k: round(float(v), 4) for k, v in st_dn._asdict().items()} }")
    print(f"[{label}] kernel vs twin on {SPARSE_D_SLICE:,} tokens: {n_mism} "
          f"draw mismatches at boundaries, max |dS'| {err:.3g}, Q' share "
          f"{q_share:.2%}")
    print(f"[{label}] sample_sparse over every token: top_k rows "
          f"{ms['top_k']:.2f} ms, sorted rows {ms['sorted']:.2f} ms (in "
          f"turns: {runs}); walking all {L} slots costs "
          f"{ms['top_k'] / ms['sorted']:.2f}x")
    del srt, b1
    return {"t_sp": t_sp, "L": L, "launches": launches, "flips":
            flips.numel(), "tv": tv, "twin_mismatches": n_mism,
            "max_abs_err": err, "ms_top_k": ms["top_k"],
            "ms_sorted": ms["sorted"]}


def lda_core_ell(tr, D, W, topics, t_new) -> dict:
    """(c): the first ``ELL_MOVES`` tokens' moves through
    ``ell_apply_deltas`` on the card and on a CPU copy, on sorted rows and
    on top_k rows of D at its row-nnz bound; then ``ell_slot_apply`` with
    the same moves as a dense delta."""
    from repro_torch.core import esca, sparse
    label = "lda_core ell"
    C = ELL_MOVES
    rows, old, new = tr.doc_ids[:C], topics[:C], t_new[:C]
    wgt = ((old != new) & (tr.mask[:C] > 0)).to(torch.int32)
    D1, _ = esca.delta_update_counts(D.clone(), W.clone(), tr.word_ids[:C],
                                     rows, old, new, tr.mask[:C])
    delta = D1 - D
    lens = np.asarray(tr.corpus.doc_lengths)
    L = int(min(lens.max(), K_MAIN))               # the row-nnz bound
    out = {"moves": int(wgt.sum()), "L": L}
    for name, build in (("sorted", lambda: sparse.pack_rows_sorted(D, L)[0]),
                        ("top_k", lambda: sparse.build_sparse_rows(D, L))):
        packed = build()
        args = (rows, old, new, wgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, dropped = sparse.ell_apply_deltas(packed, *args)
        torch.cuda.synchronize()
        ms_card = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cpu, cpu_dropped = sparse.ell_apply_deltas(
            packed.cpu(), *(a.cpu() for a in args))
        ms_cpu = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got.cpu(), cpu),
              f"[{label}] {name}: the card's packed words differ from the "
              "CPU run's")
        check(int(dropped) == 0 and int(cpu_dropped) == 0,
              f"[{label}] {name}: {int(dropped)} moves dropped")
        check(torch.equal(sparse.densify_rows(got, K_MAIN), D1),
              f"[{label}] {name}: densify differs from D plus the moves "
              "through esca.delta_update_counts")
        empty = ((got >> 16) & 0xFFFF) == sparse.EMPTY_IDX
        suffix = bool((empty[:, 1:] >= empty[:, :-1]).all())
        if name == "sorted":
            check(suffix, f"[{label}] sorted rows: an EMPTY_IDX slot "
                  "precedes a used one after the moves")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = sparse.ell_slot_apply(packed, delta)
        torch.cuda.synchronize()
        ms_slot = (time.perf_counter() - t0) * 1e3
        check(torch.equal(sparse.densify_rows(slot, K_MAIN),
                          D + torch.where(D > 0, delta, 0)),
              f"[{label}] {name}: ell_slot_apply differs from the delta on "
              "the live columns")
        print(f"[{label}] {name} rows (L = {L}): ell_apply_deltas of "
              f"{C:,} tokens ({out['moves']:,} moves) {ms_card:.1f} ms on "
              f"the card, {ms_cpu:.0f} ms on the CPU, bitwise equal; 0 "
              f"dropped; densify == D + the moves; EMPTY_IDX slots a suffix: "
              f"{suffix}; ell_slot_apply of the dense delta {ms_slot:.1f} ms")
        out[name] = {"ms_card": ms_card, "ms_cpu": ms_cpu,
                     "ms_slot_apply": ms_slot, "empty_suffix": suffix}
        del packed, got, cpu, slot
    return out


def phase_lda_core(corpus, dense_topics, paths: dict, card: str, seed: int,
                   phases: dict) -> None:
    """Phase 10: the rest of the LDA core at the NYTimes shape. (a) the
    two-branch sampler through the engine; (b) the sparse-D sampler on the
    dense path's final D; (c) the ELL ops on its moves; (d) the inverted-
    index D rebuild; (e) the hybrid W."""
    from repro_torch.core import sparse
    from repro_torch.core.inverted_index import reconstruct_d_rows
    t_phase = time.perf_counter()
    engine, rec = lda_core_two_branch(corpus, seed,
                                      paths["dense"]["llpt"][0])
    tr = engine.trainer
    launches = dict(rec.pop("launches"))
    # (d) the engine's D rebuilt from its topics through the inverted index
    zero_counts()
    D_inv = reconstruct_d_rows(engine.state.topics, tr.inv_token_idx,
                               tr.doc_segments, tr.n_docs, K_MAIN,
                               plan=tr.count_plans[1])
    torch.cuda.synchronize()
    for k, v in read_counts().items():
        launches[k] += v
    check(torch.equal(D_inv, engine.state.D),
          "[lda_core] reconstruct_d_rows differs from the engine's D")
    print("[lda_core] reconstruct_d_rows of the two-branch topics == the "
          "engine's D, bitwise (histogram's sorted route)")
    del D_inv
    # (b), (c), (e) on the dense path's final state, its counts rebuilt
    topics = dense_topics["topics"].to(engine.device)
    D, W = tr.rebuild_counts(topics)
    sp = lda_core_sparse_d(tr, D, W, topics, seed, dense_topics["iteration"])
    for k, v in sp.pop("launches").items():
        launches[k] += v
    rec["sparse_d"] = sp
    rec["ell"] = lda_core_ell(tr, D, W, topics, sp.pop("t_sp"))
    counts = np.asarray(tr.corpus.word_token_counts)
    hw = sparse.build_hybrid_w(W, counts, K_MAIN)
    check(torch.equal(hw.densify(K_MAIN), W),
          "[lda_core] HybridW.densify differs from W")
    model = sparse.bytes_hybrid(counts, K_MAIN)
    check(model["total"] == hw.nbytes() and model["v_dense"] == hw.v_dense,
          f"[lda_core] bytes_hybrid {model} disagrees with the built "
          f"HybridW ({hw.nbytes()} bytes, v_dense {hw.v_dense})")
    print(f"[lda_core] HybridW of the dense path's final W: v_dense "
          f"{hw.v_dense:,} of {W.shape[0]:,} words, {len(hw.sparse.buckets)} "
          f"tail buckets (capacities {hw.sparse.capacities}); nbytes() "
          f"{hw.nbytes():,} against the dense W's {W.numel() * 4:,} "
          f"({hw.nbytes() / (W.numel() * 4):.3f}); bytes_hybrid total "
          f"{model['total']:,}; densify == W bitwise")
    rec["hybrid_w"] = {"v_dense": hw.v_dense, "nbytes": hw.nbytes(),
                       "dense_bytes": W.numel() * 4,
                       "bytes_hybrid": model["total"]}
    rec["launches"] = launches
    phases["lda_core"] = rec
    del engine, tr, D, W, topics, hw
    torch.cuda.empty_cache()
    print(f"[lda_core] {card}: launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=NYT_TOKENS)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every number as JSON to this file")
    args = ap.parse_args()
    check(args.iters >= 4, "--iters must be at least 4: a drill kills "
          "iteration 3 and another resumes at 2 for 2 more")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import_port()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        run(args, card, tmp)


def run(args, card: str, tmp: str) -> None:
    """Phases 2-9 on the card; checkpoint and model files go to ``tmp``,
    which the caller removes."""
    from repro_torch.lda.corpus import planted_corpus
    t_start = time.perf_counter()
    walls, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        """The seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        walls[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    build_kernels()
    fused = phase_fused_kernels(args.seed)
    errs = {**fused["errs"], **phase_sparse_kernels(args.seed),
            **phase_warp_kernels(args.seed)}
    phase_cap_shapes(args.seed)
    phase_small_iterations(args.seed)
    lap("kernels")
    # the LM substrate needs no corpus: it runs first, so that a late
    # timeout cannot hide it
    lm = phase_lm(card, args.seed)
    lap("lm")
    lm_families = phase_lm_families(card, args.seed)
    lap("lm_families")
    lm_sharded = phase_lm_sharded(card, args.seed, tmp)
    lap("lm_sharded")
    # the plans run on one host core beside the corpus build (host
    # NumPy); the LM steps are held to them before the LDA paths
    planner = start_planner(tmp)

    if args.tokens < NYT_TOKENS:
        print(f"cut: {args.tokens:,} tokens of NYTimes' {NYT_TOKENS:,} "
              "(M, V and K kept)")
    else:
        print(f"cut: none ({args.tokens:,} tokens, M, V and K as NYTimes)")
    t0 = time.perf_counter()
    held_docs = REQUESTS * REQUEST_DOCS
    corpus, held = split_held_out(planted_corpus(
        args.seed, n_docs=NYT_DOCS + held_docs, n_words=NYT_WORDS,
        n_tokens=args.tokens * (NYT_DOCS + held_docs) // NYT_DOCS,
        n_planted=K_MAIN), NYT_DOCS)
    print(f"corpus: {corpus.n_tokens:,} tokens, {corpus.n_docs:,} docs, "
          f"{corpus.n_words:,} words, and {len(held):,} held-out docs "
          f"({sum(d.size for d in held):,} tokens) of the same planted "
          f"topics, made in {time.perf_counter() - t0:.1f} s")
    lap("corpus")
    # joined before the first LDA path: nothing that path times runs
    # beside it
    plans = plans_held(card, read_plans(planner), lm, lm_sharded)
    lap("plans")

    paths, phases = {}, {"lm": lm, "lm_families": lm_families,
                         "lm_sharded": lm_sharded}
    engine, paths["dense"] = phase_path(corpus, "dense", {}, args.iters,
                                        args.seed,
                                        checkpoint_dir=os.path.join(tmp,
                                                                    "dense"),
                                        digests=True,
                                        digest_at=(DIST_ITERS, DRILL_ITERS))
    paths["dense"]["chunk"] = phase_real_chunk(engine, args.seed)
    histogram = phase_histogram(engine, args.seed)
    paths["dense"]["breakdown"] = phase_breakdown(
        engine, breakdown_targets(False), "dense")
    check(paths["dense"]["launches"]["sample_fused"] > 0,
          "the dense path launched sample_fused no time")
    phases["resume"] = phase_resume(engine, corpus,
                                    os.path.join(tmp, "dense"), "dense")
    phases["serving"] = phase_serving(engine, held, tmp, args.seed)
    phases["serve_service"] = phase_serve_service(engine, held, args.seed,
                                                  phases["serving"])
    # phase 10 packs the dense path's final D (its counts rebuilt there)
    dense_topics = {"topics": engine.state.topics.cpu(),
                    "iteration": engine.iteration}
    del engine
    torch.cuda.empty_cache()
    lap("dense, resume, serving")

    engine, paths["paper"] = phase_path(corpus, "paper", PAPER, args.iters,
                                        args.seed,
                                        checkpoint_dir=os.path.join(tmp,
                                                                    "paper"),
                                        digests=True, digest_at=DRILL_ITERS)
    paper = paths["paper"]
    paper.update(paper_state_checks(engine, paths["dense"]["llpt"]))
    for name in ("sample_fused_tiled", "sample_sparse_tiled"):
        check(paper["launches"][name] > 0,
              f"the paper path launched {name} no time")
    paper["kernels"] = phase_paper_kernels(engine, args.seed)
    paper["breakdown"] = phase_breakdown(engine, breakdown_targets(True),
                                         "paper")
    phases["resume_paper"] = phase_resume(engine, corpus,
                                          os.path.join(tmp, "paper"), "paper")
    del engine
    torch.cuda.empty_cache()
    # the hybrid sparse path with balance="none": sample_sparse's untiled
    # route (the paper path's tail tiles fit their window), and the digest
    # dist_hybrid is held to
    engine, paths["hybrid_none"] = phase_path(
        corpus, "hybrid_none", dict(PAPER, balance="none"), 2, args.seed,
        digests=True, digest_at=DIST_ITERS)
    check(paths["hybrid_none"]["launches"]["sample_sparse"] > 0,
          "the hybrid sparse path launched sample_sparse no time")
    del engine
    torch.cuda.empty_cache()
    lap("paper, hybrid_none")

    phase_streaming(corpus, {"dense": paths["dense"], "paper": paper}, args,
                    tmp, paths, phases)
    lap("streaming")

    engine, paths["warp_paper"] = phase_path(corpus, "warp_paper", WARP_PAPER,
                                             args.iters, args.seed)
    warp = paths["warp_paper"]
    for name in ("vose_tables", "warp_chain_tokens_tiled", "histogram"):
        check(warp["launches"][name] > 0,
              f"the warp_paper path launched {name} no time")
    warp["kernels"] = phase_warp_path_kernels(engine, args.seed)
    print("the warp breakdowns below have no 'queues (sort)' and no 'doc "
          "proposals' stage: the queues are built inside 'proposal build: "
          "Vose' and the doc proposals drawn inside 'chain', which also "
          "reads the token streams in place of the gathers that 'other' "
          "held")
    warp["breakdown"] = phase_breakdown(engine, warp_breakdown_targets(True),
                                        "warp_paper")
    del engine
    torch.cuda.empty_cache()
    engine, paths["warp_dense"] = phase_path(corpus, "warp_dense", WARP_DENSE,
                                             2, args.seed, digests=True)
    for name in ("vose_tables", "warp_chain_tokens", "histogram"):
        check(paths["warp_dense"]["launches"][name] > 0,
              f"the warp_dense path launched {name} no time")
    paths["warp_dense"]["breakdown"] = phase_breakdown(
        engine, warp_breakdown_targets(False), "warp_dense")
    del engine
    torch.cuda.empty_cache()
    lap("warp")
    phase_failure(corpus, paths, args, tmp, phases)
    lap("failure")
    phase_distributed(corpus, paths, args, tmp, phases)
    lap("distributed")
    phase_streamed_ps(corpus, paths, args, tmp, phases)
    lap("streamed_ps")
    phase_lda_core(corpus, dense_topics, paths, card, args.seed, phases)
    del dense_topics
    lap("lda_core")
    sec = {k: [it["seconds"] for it in p["iterations"]]
           for k, p in paths.items()}
    later = {k: float(np.mean(v[1:])) for k, v in sec.items() if len(v) > 1}
    for warp_name, exact in (("warp_dense", "dense"), ("warp_paper", "paper")):
        print(f"seconds per iteration after the first, same corpus and run: "
              f"{warp_name} {later[warp_name]:.3f} s against {exact} "
              f"{later[exact]:.3f} s (exact/warp "
              f"{later[exact] / later[warp_name]:.2f}); one more iteration "
              f"split by stage: {warp_name} "
              f"{paths[warp_name]['breakdown']['wall_ms']:.1f} ms, {exact} "
              f"{paths[exact]['breakdown']['wall_ms']:.1f} ms")

    sources = {"sample_fused": ("sample_fused.cu", "sample_fused.py:202"),
               "sample_fused_tiled": ("sample_fused.cu",
                                      "sample_fused.py:251"),
               "sample_sparse": ("sample_sparse.cu", "sample_sparse.py:100"),
               "sample_sparse_tiled": ("sample_sparse.cu",
                                       "sample_sparse.py:142"),
               "vose_build": ("sample_warp.cu", "sample_warp.py:107"),
               "warp_chain": ("sample_warp.cu", "sample_warp.py:107"),
               "histogram": ("histogram.cu", "histogram.py:67")}
    # sample_fused is timed at the dense path's shape, the sparse and tiled
    # ones on the paper path's tokens, the warp kernels on the warp_paper
    # path's (the chain's tiled launch), histogram on the dense path's W
    timed = {**paper["kernels"], "sample_fused": fused["sample_fused"],
             **warp["kernels"], "histogram": histogram["W"]}
    # a kernel's entries (untiled and tiled, main path and reference
    # signature) are instantiations of its one body
    counted = {"vose_build": ("vose_tables", "vose_build"),
               "warp_chain": ("warp_chain_tokens", "warp_chain_tokens_tiled",
                              "warp_chain", "warp_chain_tiled"),
               "histogram": ("histogram", "histogram_any")}
    record = {"kernels": []}
    for name, (src, ref) in sources.items():
        t = timed[name]
        launches = sum(p["launches"][c]
                       for p in [*paths.values(), *phases.values()]
                       for c in counted.get(name, (name,)))
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{ref}", "launches": launches,
            "max_abs_err": max(errs.get(name, 0.0),
                               t.get("max_abs_err", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    print(f"launches by path: "
          f"{ {k: p['launches'] for k, p in paths.items()} }; by phase: "
          f"{ {k: p['launches'] for k, p in phases.items()} }")
    print(f"phase walls (s): {walls}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after "
          "the card check")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "paths": paths,
                                        "phases": phases, "walls": walls,
                                        "histogram": histogram,
                                        "plans": plans, **record},
                                       indent=1, default=float))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
