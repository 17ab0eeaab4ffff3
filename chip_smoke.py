#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's ported paths.

Drives ``repro_torch`` on one CUDA card, through the entry points a user
calls, at chromosome scale (n = 2**27 symbols by default) on two paths:

* first, the text packing (phase ``pack_text``) — ``pack_text_dense`` on a
  2^N DNA string against its plain version and a numpy pack on the host,
  its device ms beside its byte bound, ``pack_text`` on the host
  clock;
* the DNA path — the ``genome`` dataset, dense 2-bit words
  (``range_gather_words``, ``kmer_histogram``, and ``search_bounds_words``:
  each search batch one launch), plus a batch carrying the terminal code
  (byte keys over the dense words: ``search_bounds_packed``, one launch a
  batch);
* the protein path — the ``protein`` dataset, byte-per-symbol text, the
  byte-key currency (``range_gather_pack``, ``lcp_pairs``,
  ``search_bounds_bytes``, and ``kmer_histogram`` for the partition);
* the tree + analytics path on both datasets —
  ``EraIndexer(alphabet, EraConfig(node_lcp="words")).build(s)`` →
  ``SuffixTreeIndex`` → ``index.analytics()`` → the ``analytics_serve``
  loop (``suffix_lcp_words`` on DNA, ``suffix_lcp_pairs`` on protein, the
  node build's divergence rows and the global LCP's boundaries; matching
  statistics lower-bound through ``search_bounds_words`` /
  ``search_bounds_bytes``, one launch a batch);
* the ``REPRO_WORD_COMPARE=byte`` oracle leg on ``genome`` at n = 2**25
  (``range_gather_packed``, ``search_bounds_packed`` and, for
  find-and-fetch, ``search_fetch_packed``: one launch a batch), held equal
  to the word leg;
* the out-of-core path — ``EraIndexer.build_stream`` of both strings
  under a device budget (the host state double-buffered onto the card on
  a side stream), the genome read back from a FASTA file, then
  ``append_device`` of 2^16 symbols to the genome index, its swap into a
  serving ``AsyncServer``, and ``migrate_archive`` of a byte archive;
* the sharded fabric — ``build_sharded`` of both strings over a mesh of
  four entries that all name the one card (``[cuda:0] * 4``: four shards
  on one H100), its finds, find-and-fetches and the serving stack's
  cached mode over the four shards, ``append_sharded`` and the per-shard
  archives (``migrate_archives``, ``ShardedIndex.load``,
  ``load_or_build(sharded=True)``);
* the paper's serial engine and the worker driver —
  ``EraConfig(construction="serial")`` builds of both strings (one group's
  elastic loop at a time) against the batched engine's sub-trees, the
  serial node builders (``build_impl`` numpy, scan, parallel) at 2^20,
  ``era_run.build_distributed`` (four workers, one failed mid-run, a
  checkpoint) and the ``era_run`` command line in both modes;
* find-and-fetch serving on both indexes — ``DeviceIndex.find_fetch_batch``
  (one ``search_fetch_words`` launch a batch on DNA, one
  ``search_fetch_bytes`` launch on the protein byte text, one
  ``search_fetch_packed`` launch for the DNA terminal-bearing batch) and
  the ``AsyncServer`` stack through
  ``run_closed_loop`` in its sync, async and cached modes;
* LM serving — ``repro_torch.launch.serve.serve("qwen3-1.7b",
  smoke=False)``: all 28 layers at full width (d_model 2048, 16 query and
  8 KV heads of width 128, vocab 151,936; random weights from a seed) in
  bf16, prefilling 4 prompts of 2048 tokens through the hand-written
  ``flash_attention`` kernel (its bf16 design, ``wgmma_tma``: tensor-core
  tiles fed by TMA), then decoding 32 tokens greedily.
* LM training — ``repro_torch.launch.train.train("qwen3-1.7b",
  smoke=False)``: all 28 layers at full width in float32 (TF32 off, torch's
  default), 4 x 2048 tokens a step, AdamW, each layer under remat; a
  2-layer step on the card against the CPU, a checkpoint and resume, and
  the ERA dedup filter (``data.tokens.dedup_mask``: an ``EraIndexer``
  build of the token stream through ``range_gather_words`` and
  ``kmer_histogram``).
* LM serving of the other families — ``serve(arch, smoke=False)`` in bf16,
  4 prompts of 2048 tokens and 32 generated, at published widths:
  ``falcon-mamba-7b`` (ssm, 64 layers), ``zamba2-2.7b`` (hybrid, 54
  Mamba-2 layers and 9 calls of the shared block, D 80 through
  ``flash_attention``), ``seamless-m4t-medium`` (encdec, 12 + 12 layers,
  1024 frontend frames; the encoder through the kernel's full mode),
  ``phi3.5-moe-42b-a6.6b`` (moe, GQA; cut to 4 of 32 layers) and
  ``deepseek-v2-236b`` (moe, MLA; cut to 3 of 60 layers: its dense first
  layer and 2 MoE layers of 160 experts, top 6, 2 shared).

Phases, each printing one JSON line:

1. device   — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, and the build of every CUDA kernel from ``csrc/``;
   dram_round_trip — one dependent device-memory round trip
              (``csrc/dram_latency.cu``), the unit of the search kernels'
              latency bounds;
2. parity   — each hand kernel against its plain PyTorch version on the
              card, exact equality (integer kernels), with its time (the
              search kernels at the 2^27 indexes, after their paths: each
              against the loop with the plain probes, the loop of
              single-step kernels and a counted loop, on the serving
              batch, unrouted and empty windows, terminal-tail patterns,
              the lower bound alone, NW at and past the register
              templates, B = 1, 33, 0 and 2^20 rows; byte keys on
              dense text (``search_bounds_packed``) also on the
              terminal-bearing batch, ``[c, terminal]`` pairs and 4- and
              8-bit dense indexes at 2^20; the fused
              find-and-fetch kernels against their plain version and the
              search + epilogue kernels they fuse, all four outputs, on
              the find-and-fetch batch, end-of-text windows, empty
              windows, fetch 4 and 64, NW past the templates, B = 1, 33
              and 0 and 2^20 lanes, ``search_fetch_packed`` as the
              search; the three elastic-range
              gathers also on every NW template and two nw outside them,
              0, 1, 4099 and 2^22 + 5 rows, offsets at the text's end
              (past n_real for ``range_gather_packed``), without a mask,
              with a mixed one and with every row off, on the 2-, 4- and
              8-bit dense texts and the protein and byte strings, and in
              one launch of more than 2^31 output words;
              ``kmer_histogram`` at every k the partition counts with it on
              the genome and protein strings and the BYTE string (k = 2:
              2^16 bins, the cluster layout), each with a start off every
              16-byte boundary, one window, ragged tails, a homopolymer
              and a planted motif, beside ``torch.bincount`` of the codes;
              ``suffix_lcp_words`` at bits 2, 4 and 8 on neighbour pairs
              chained as adjacent leaves, partly chained and unchained,
              with pairs at the text's end, at w = 4 … 256 and every NW
              bucket the padding allows);
3. build    — ``EraIndexer(alphabet, EraConfig()).build_device(s)``;
   build_profile — one more warm build per dataset under
              ``torch.profiler`` (and one of the byte leg, phase 7):
              device ms and calls of every kernel of the build, each port
              kernel's ms beside its bound for the counted build's rows,
              the gathers' ms and share of ``t_prepare_s``, the device's
              busy share of the build;
4. check    — ``ell`` is a permutation of the suffixes, and ``find_batch``
              equals a brute-force occurrence scan on the device (for DNA
              also on a batch of patterns ending in the terminal code);
5. serving  — the ``query_serve`` loop (batch 256, lengths 4–24);
   search_launches — one search batch per counted DNA, protein, tree,
              terminal-bearing and byte-leg path (and one byte-leg
              find-and-fetch batch), counted from 0: its search kernel
              launched once and no single-step probe, or the run fails;
   find_fetch — ``find_fetch_batch`` (fetch 32) on 256 planted and random
              patterns: ranges equal ``find_batch`` and the scan, windows
              equal the text read on the card, ``verified`` 0 where found,
              the find-and-fetch calls counted alone (one fused launch a
              batch); then its batch latency beside the search alone and
              beside the search + epilogue kernels it fuses
              (``find_fetch_ranges_unfused_ms``, equal outputs), on the
              served batch and on 256 terminal-bearing patterns;
   serving_stack — ``run_closed_loop`` in sync, async and cached mode with
              fetch 0 and 32 on a hot workload of 16,384 requests, each mode
              warmed once with every ``_dispatch`` under
              ``torch.cuda.set_sync_debug_mode("error")`` and launching
              exactly one kernel (the search, or the fused find-and-fetch)
              when it has rows, every result equal to ``find_batch`` /
              ``find_fetch_batch``;
6. tree / analytics / analytics_serving — the tree path per dataset:
              build, engine, the serving loop (batch 512, window 64, 20
              batches), then its checks against brute force on the card;
   tree_layers — the node build's layers timed alone, with CUDA events
              around each launch of the text-LCP kernel in
              ``boff_rows_from_text``: per ``lcp_from_text`` round its w,
              pending rows, adjacency share and device ms, the kernel's
              total beside ``t_rows_and_text_lcp_s`` (the rest is glue);
6c. fasta / stream — the genome codes written as a FASTA file (4
              records of 80-column lines, one in lower case, one with
              ``N`` for ``A``) and read back by ``load_fasta``, equal to
              the codes; then per dataset ``build_stream`` under a device
              budget of G x ``state_bytes_per_group(F)`` // 8 (about 16
              chunks double-buffered; genome with ``overlap`` on and off,
              protein on), each index's seven fields and ``find_batch``
              equal to the one-shot ``build_device``; chunks, the plan's
              modelled peak, seconds beside the one-shot's, bytes copied,
              copy seconds, the wait and ``overlap_frac``;
              ``max_memory_allocated`` around each whole build and, for
              genome, around the prepare stage alone (``partition``, then
              a peak reset, then ``subtree_prepare_batch`` /
              ``subtree_prepare_stream``), the stream's below half the
              one-shot's and ``overlap_frac`` above 0.5, or the run fails;
   append / append_swap / migrate — 2^16 fresh symbols appended to the
              genome index (``append_device``): the seven fields,
              ``string_codes()`` and epoch + 1 equal to ``build_device`` of
              the longer string, every ``AppendReport`` field beside the
              rebuild's seconds, ``search_bounds_words`` launched by the
              terminal-tail scan; the new index swapped into an
              ``AsyncServer`` (the cache flushed), its answers equal to a
              fresh server over the rebuild; a 2^22 genome archive saved
              with ``packing="bytes"`` migrated by ``migrate_archive``
              (True, then False), equal to a dense build;
6e. fabric_build / fabric_find / fabric_serving / fabric_append /
    fabric_archives — the sharded fabric on a mesh of ``[cuda:0] * 4``:
              ``build_sharded`` of both strings into 4 route-key shards,
              ``flat_table()`` equal to phase build's one-shot arrays,
              the same schedule (iterations), ``t_prepare_s`` beside the
              one-shot's, shard steps (one elastic gather each), the
              prepare stage's ``max_memory_allocated`` beside the
              one-shot's taken the same way; 256 patterns per dataset (a
              few shorter than ``k_route``, one built to straddle a shard
              cut: some span must cover two shards or more) and, on
              genome, the terminal-bearing batch through ``find_batch``
              and ``find_fetch_batch`` (fetch 32), equal to the one-shot
              index rebuilt from those arrays, each shard's sub-batch one
              search and one find-and-fetch launch; ``run_closed_loop``
              in cached mode, fetch 32, on the genome shards and the
              serving_stack workload, warmed once with every
              ``_dispatch_sharded`` sync-free and one launch a
              sub-batch, every result equal to the single-index
              server's, qps and latency beside serving_stack's cached
              row, per-shard hit rates; ``append_sharded`` of the same
              2^16 symbols, equal to phase append's index, epoch + 1; a
              3-shard byte archive at 2^22 migrated by
              ``migrate_archives``, loaded onto the card, answering as
              before, and a ``load_or_build(sharded=True)`` cache hit
              with the full string;
6f. serial / serial_nodes / era_run — per dataset the batched
              ``build(build_impl="none")`` and the serial engine's
              ``build`` (counted), every sub-tree's ``ell``, ``b_off``,
              ``b_c1`` and ``b_c2`` equal, ``t_prepare_s`` of both beside
              ``build_device``'s, iterations and launches; genome at
              2^20 built serially under ``build_impl`` numpy, scan and
              parallel, every node set equal to the batched tree's
              (intervals), scan's arrays equal to numpy's;
              ``build_distributed`` at 2^27 (4 workers, 4 groups a pull,
              a checkpoint under ``build/``, ``w1`` failed after 2
              groups) equal to the batched build, the queue's stats and
              each worker's groups and seconds; ``python -m
              repro_torch.launch.era_run`` at 2^20 as a subprocess in the
              worker and ``--stream`` modes, each exiting 0;
6g. trace  — the flight recorder (``repro_torch.obs``) on the card, on
              and empty before anything is built: ``build_stream`` of the
              genome at 2^22 in 4 chunks (its index checked against
              brute force), ``build_sharded`` at 2^20 over
              ``[cuda:0] * 2`` with one ``find_batch`` and one
              ``find_fetch_batch`` of 256 patterns (equal to the one-shot
              index), then the hot serving workload (16,384 requests,
              cache 512): a sync-free warm-up, then 3 timed passes with
              the recorder on and 3 off, in turns, the best of each; the
              trace and metrics written to build/trace/ and checked: a
              valid trace, the JAX package's required spans and the
              fabric's, a process track per shard, every dispatch's link
              joining a queue wait, the required metric series, every
              kernel dispatch ``impl="cuda"`` and each label's count equal
              to its kernels' launches while the recorder was on, and
              ``qps_on >= 0.5 x qps_off``;
7. byte_leg — build_device, find_batch and the analytics LCP array under
              ``REPRO_WORD_COMPARE=byte``, equal to the word leg; then a
              profiled warm byte-leg build (``build_profile``,
              ``range_gather_packed`` and ``lcp_pairs`` in the build);
8. LM       — ``parity`` of ``flash_attention`` against its plain version
              (float32 rtol 1e-5 / atol 2e-5 with TF32 off, the
              ``cuda_cores`` design; bf16 one bf16 ulp of the output, rtol
              2^-7 / atol 2e-5, the ``wgmma_tma`` design), on the JAX
              test's shapes, Sq != Sk, ragged lengths, D 16 to 256, GQA
              groups 1 to 8, q x 8 and the prefill shape; each case's
              design is checked; ``lm_serving``: ``serve`` three times
              (cold, warm, under ``torch.profiler``) with 28 kernel
              launches in each prefill and none in the decode, tokens in
              the vocabulary, the cache at 2048 + 31; ``lm_check``: in
              float32, decode steps 1 and 8 (``_sdpa`` over the cache)
              against fresh prefills (the kernel) within ``LM_TOL`` of the
              largest logit, and a 2-layer prefill on the card against the
              CPU's plain versions within ``CPU_TOL``;
   lm_train — ``train`` at full width, 6 steps (each step's loss, grad
              norm, lr and seconds between two synchronizes, the median of
              steps 2-6, tokens/s, peak memory above what earlier phases
              hold, TF32 state, then one more step under
              ``torch.profiler``: busy share and top kernels); a 2-layer
              ``train_step`` on the card against the CPU (``TRAIN_*``
              tolerances); 4 straight steps against 2 + a checkpoint + a
              resumed ``train`` (``RESUME_RTOL``), again in bf16 (its
              checkpoint restored bit for bit, ``RESUME_BF16_RTOL``, its
              wall time on the ``resume bf16`` row); ``dedup_mask`` on the
              card equal to the CPU's on the planted example batch and a
              4 x 2048 training batch, ``range_gather_words`` launched;
              no training launch of ``flash_attention``;
   lm_families — per ``FAMILY_RUNS`` entry ``serve`` cold and warm
              (times, prompt tokens/s, decode tokens/s, peak memory above
              what earlier phases hold, ``flash_attention`` launches per
              prefill equal to ``FAMILY_FLASH`` and none in the decode,
              finite logits, tokens in the vocabulary, the cache at
              2048 + 31), the cold run's prefill under
              ``torch.profiler`` (busy share, top kernels, device ms by
              ``FAMILY_KERNEL_CLASSES``: the SSM scan, the MoE router and
              scatter, softmaxes, products);
              then in float32 (TF32 off) at 2 layers (hybrid 4 in 2
              chunks), full width: decode steps 1 and 8 against fresh
              prefills (``FAMILY_DECODE_TOL``) and a 2 x 64 prefill on
              the card against the CPU, MoE expert ids equal
              (``FAMILY_CPU_TOL``); ``parity`` adds ``flash_attention`` at
              D 80 causal (H 32 = KV 32, S 2048) and D 64 full (H 16, S
              1024), bf16 and float32;
   lm_families_train — per ``FAMILY_TRAIN_RUNS`` entry a full-width
              training run in float32 (TF32 off), depth, rows and mode
              from the memory reckoning ``family_train_plan`` (each cut in
              ``reduced``; deepseek-v2 as ``value_and_grad`` alone),
              batches from ``registry.concrete_inputs``: a warm-up step
              (its gradients: none all zero, an expert's slice only if it
              got no assignment), 2 timed steps (seconds, tokens/s, peak
              memory above what earlier phases hold, predicted bytes),
              one profiled step (kernel classes, busy share, the
              backward's device ms and the SSM reverse scan's share of
              it), no ``flash_attention`` launch; then at 2 layers (hybrid
              4) the loss and every gradient leaf card against CPU (MoE
              expert ids equal, ``FAMILY_TRAIN_*`` tolerances; seamless
              in float64 on both sides);
   dryrun   — the dry run (``repro_torch.launch.dryrun``): in a
              subprocess, the ERA cells on both production meshes and
              qwen3-1.7b's four shapes on 16x16 (every cell ``ok`` but
              JAX's skip, no collective in an ERA cell), started after
              the host cost of a call through each of the five custom ops
              (``custom_op_overhead``); on the card meanwhile each ERA
              cell's per-device program at its size (2.1 G symbols, F = 2^20;
              event ms beside the cell's roofline step time, the card's
              peak beside the estimate) and qwen3-1.7b prefill at
              4 x 2048 in bf16, whose ``FlopCounterMode`` count must equal
              the (1, 1) dry run's and whose peak must lie within 0.5–2x
              of its estimate;
9. kernels  — each kernel at the main path's shapes: time, plain-version
              time, bound, and its launches on the paths above
              (``flash_attention``: the warm ``lm_serving`` and
              ``lm_families`` runs; the fused
              kernels also at 2^20 rows, beside the time of the two ported
              kernels they fuse; the fused find-and-fetch kernels beside
              ``unfused_ms`` (the search and epilogue kernels they replace)
              and a latency bound (the longest lane's dependent round trips
              times the measured one), at batch 256 and 2^20 lanes;
              the search kernels beside ``loop_ms``, the
              loop of single-step kernels they replace, with this run's
              trips per row against ``n_iter``, profiler ``device_ms`` and
              a latency bound (``pattern_probe_packed`` and
              ``probe_gather_packed`` keep their single-step rows and
              name the kernel that took their search in ``fused_into``;
              the two that took it are timed again on 256 distinct
              patterns, ``distinct``); ``flash_attention`` beside
              SDPA's time as ``library_ms``, with its bf16 ``design``,
              and both again at zamba2's D 80 (``ms_d80``,
              ``library_ms_d80``);
              the two elastic-range gathers with the rows and words their
              counted launches gathered, the excess weighted by those
              rows, their ms in the profiled builds, the gather on sorted
              positions (beside the sort for ``range_gather_pack``), and
              under a persisting L2 window, which no kernel sets: it
              measured slower); every kernel a build launches with its ms
              in the profiled builds; ``kmer_histogram`` with its layout
              and ms at every counted k beside ``bincount_ms``;
              ``suffix_lcp_words`` with the adjacency share of its
              main-path pairs, its w = 256 times and its ms in the tree;
              ``range_gather_packed`` and ``suffix_lcp_pairs`` beside
              their earlier designs (``baseline_ms``, the sources in
              ``src/repro_torch/kernels/baseline``, built beside the port's
              and timed in turns on the same inputs, outputs held equal).

Launch counts are set to 0 just before each path (build + check +
serving, the terminal-bearing check, the find-and-fetch calls of each
find_fetch phase, the fetch 0 and the fetch 32 passes of each
serving_stack phase, each stream build, the append, each fabric build,
each fabric_find batch, the fabric serving passes, the fabric append,
each serial build, the serial node builds, ``build_distributed``,
the trace phase's recorded window, each tree path
from build to the end of its serving loop, each leg
of the byte-leg phase, each LM serving run, the LM check, each training
run, each dedup call, each lm_families serving run, each
lm_families_train run, each dry-run ERA step and the dry run's prefill)
and read
just after; the phase lines carry the counts so far.  Every kernel of a
path must have launched in it.  Any failure raises and exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the rest of the repository, the script exits
non-zero and prints no result.

  python3 chip_smoke.py                # n = 2**27 (the default)
  python3 chip_smoke.py --n-log2 20    # a short run (the LM phases keep
                                       # their full size)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the card's figures (repro_torch/roofline/hopper.HopperLimits: memory
# rate, 32-bit non-tensor and bf16 tensor-core peaks), which every bound
# divides by; set by main once the package is importable
LIMITS = None
DNA_KERNELS = ("range_gather_words", "search_bounds_words", "kmer_histogram")
TERMINAL_KERNELS = ("search_bounds_packed",)
PROTEIN_KERNELS = ("kmer_histogram", "range_gather_pack", "lcp_pairs",
                   "search_bounds_bytes")
TREE_KERNELS = {
    "genome": ("kmer_histogram", "range_gather_words", "suffix_lcp_words",
               "search_bounds_words"),
    "protein": ("kmer_histogram", "range_gather_pack", "lcp_pairs",
                "suffix_lcp_pairs", "search_bounds_bytes"),
}
# the single-step probes a search no longer launches
SEARCH_STEPS = {"search_bounds_words": "pattern_probe_words",
                "search_bounds_bytes": "pattern_probe"}
# the single-step kernels of byte keys on dense text, which no path of a
# terminal-bearing batch or of the byte leg launches any more
PACKED_STEPS = ("pattern_probe_packed", "probe_gather_packed")
BYTE_LEG_KERNELS = ("range_gather_packed", "lcp_pairs", "search_bounds_packed",
                    "search_fetch_packed")
WORD_ONLY_KERNELS = ("range_gather_words", "pattern_probe_words",
                     "suffix_lcp_words", "probe_gather_words",
                     "search_bounds_words")
# every find-and-fetch batch is one fused launch
FETCH_KERNELS = {
    "genome": ("search_fetch_words",),
    "terminal": ("search_fetch_packed",),
    "protein": ("search_fetch_bytes",),
}
SEARCH_KERNELS = {"genome": "search_bounds_words",
                  "protein": "search_bounds_bytes"}
# the search and epilogue kernels the fused ones replace
UNFUSED = ("search_bounds_words", "search_bounds_bytes", "probe_gather_words",
           "pattern_probe", "range_gather_pack")
FETCH_ABSENT = {  # kernels a find-and-fetch path must not launch
    "genome": ("probe_gather_packed", "pattern_probe_words",
               "search_fetch_bytes") + UNFUSED,
    "terminal": ("probe_gather_words", "search_bounds_words",
                 "search_fetch_words", "search_fetch_bytes",
                 "search_bounds_packed") + PACKED_STEPS,
    "protein": ("probe_gather_packed", "pattern_probe_words",
                "search_fetch_words") + UNFUSED,
}
# the kernels a build_device launches, per dataset (build_profile's rows;
# byte_leg: the genome build under REPRO_WORD_COMPARE=byte)
BUILD_KERNELS = {"genome": ("kmer_histogram", "range_gather_words"),
                 "protein": ("kmer_histogram", "range_gather_pack",
                             "lcp_pairs"),
                 "byte_leg": ("kmer_histogram", "range_gather_packed",
                              "lcp_pairs")}
GATHERS = ("range_gather_words", "range_gather_pack", "range_gather_packed")
# the earlier designs of the kernels this slice redesigned, timed beside
# them in turns (the port never calls them): source directory and design
YARDSTICK_DIR = ROOT / "src" / "repro_torch" / "kernels" / "baseline"
DESIGNS = {"range_gather_packed": ("row_read", "thread_per_key_word"),
           "suffix_lcp_pairs": ("chunked_shared_suffix",
                                "thread_per_pair_word_loop")}
# the gathers' edge cases: every NW template, two nw outside them, and
# launches of 0, 1, 4099 and 2^22 + 5 rows (ragged against rows a thread)
GATHER_NW = (1, 2, 3, 4, 5, 8, 16, 32, 64)
GATHER_ROWS = (0, 1, 4099, (1 << 22) + 5)
BYTE_LEG_LOG2 = 25  # the oracle leg's n: an oracle, not a user path
STREAM_KERNELS = {"genome": ("range_gather_words", "kmer_histogram"),
                  "protein": ("range_gather_pack", "lcp_pairs")}
STREAM_FIELDS = ("ell", "sub_off", "sub_freq", "sub_prefix", "sub_plen",
                 "win_lo", "win_hi")
APPEND_LOG2 = 16      # symbols appended to the genome index
FABRIC_ENTRIES = 4    # the fabric's mesh: [cuda:0] * 4 on the one card
FABRIC_KERNELS = {"genome": ("range_gather_words",),
                  "protein": ("range_gather_pack", "lcp_pairs")}
FABRIC_SHORT = 6      # patterns shorter than k_route in fabric_find's 256
MIGRATE_LOG2 = 22     # the byte archive migrated to dense storage
FASTA_RECORDS = 4     # records of the genome FASTA file (80-column lines)
# the serial engine and the worker driver (phases serial, serial_nodes,
# era_run): the kernels every serial build launches, the node builders'
# string (2^20), the era_run subprocesses' too, and the queue's shape
SERIAL_KERNELS = {"genome": ("kmer_histogram", "range_gather_words"),
                  "protein": ("kmer_histogram", "range_gather_pack",
                              "lcp_pairs")}
SERIAL_NODES_LOG2 = 20
ERA_WORKERS, ERA_PULL, ERA_FAIL_AFTER = 4, 4, 2
FETCH = 32          # symbols fetched per match on the find-and-fetch paths
SERVE_REQUESTS = 1 << 14
# the flight recorder (phase trace): the genome string streamed at 2^22
# under a budget of a quarter of its double-buffered state (>= 4 chunks),
# the fabric at 2^20 over [cuda:0] * 2, then the serving workload with a
# 512-entry cache; the JAX package's required spans and Prometheus
# needles (benchmarks/trace_smoke.py) with the fabric's spans; each
# kernel-dispatch label (kernel, currency) with the port kernels whose
# launches it counts (on the byte string a find-and-fetch launch counts as
# the probe and the gather the JAX package composes there); and JAX's
# overhead gate, recorder-on qps >= 0.5 x recorder-off qps
TRACE_LOG2, TRACE_FABRIC_LOG2, TRACE_MESH = 22, 20, 2
TRACE_CACHE, TRACE_TIMED = 512, 3
TRACE_REQUIRED_SPANS = ("build/vertical", "prepare/step", "stream/pipeline",
                        "stream/chunk", "serve/queue_wait", "serve/pad_pack",
                        "serve/device_dispatch", "serve/consume_sync")
TRACE_FABRIC_SPANS = ("fabric/shard_loop", "fabric/step", "fabric/find_batch",
                      "fabric/find_fetch")
TRACE_REQUIRED_PROM = ("serve_cache_hit_rate", "serve_batch_fill_bucket",
                       "serve_queue_wait_ms_bucket",
                       "serve_batch_age_ms_bucket", "kernel_dispatch_total",
                       "prepare_group_iterations_bucket")
DISPATCH_KERNELS = {
    ("range_gather", "word"): ("range_gather_words",),
    ("range_gather", "packed"): ("range_gather_packed",),
    ("range_gather", "byte"): ("range_gather_pack", "search_fetch_bytes"),
    ("suffix_lcp", "word"): ("suffix_lcp_words",),
    ("suffix_lcp", "byte"): ("suffix_lcp_pairs",),
    ("pattern_probe", "word"): ("search_bounds_words",),
    ("pattern_probe", "packed"): ("search_bounds_packed",),
    ("pattern_probe", "byte"): ("search_bounds_bytes", "search_fetch_bytes"),
    ("probe_gather", "word"): ("search_fetch_words",),
    ("probe_gather", "packed"): ("search_fetch_packed",),
}
TRACE_QPS_FLOOR = 0.5
# Decode against prefill in float32 over 28 layers, as a share of the
# largest logit: the decode's _sdpa and one-row products sum in another
# order than the prefill's kernel and 513-row products (measured 6.4e-7).
LM_TOL = 1e-5
# Card against CPU, float32, 2 layers: rtol and atol as a share of the
# largest logit, those of tests/test_torch_models.py (measured 1.2e-7).
CPU_TOL = (1e-4, 2e-5)
# flash_attention in bfloat16: one bf16 ulp of each output (ulp(x) <=
# 2^-7 |x|; kernel and plain version round one float32 result each), plus
# the float32 atol for outputs near 0 (measured 1.95e-3 = 2^-9, one ulp
# of an output in [0.25, 0.5), at the prefill shape).
BF16_TOL = (2.0 ** -7, 2e-5)
# lm_train, card against CPU (float32, TF32 off, 2 layers at full width,
# one train_step from the same parameters): the loss rtol; the gradient
# norm rtol; the moments m and v each within TRAIN_MOMENT_TOL of the
# leaf's largest CPU entry plus that share of each entry (sums in another
# order, the embedding backward's atomics on the card).  Adam's first step
# moves a parameter by lr * g / (|g| + eps) ~ lr * sign(g): where |g| lies
# within the gradient's noise (the m tolerance over 1 - b1) or below
# 2e-7 (20 eps) the two sides may step opposite ways, so such entries may
# differ by 2 lr; elsewhere the ratio moves by at most eps * noise / g^2 <
# 0.05, so by 0.05 lr; both plus 1e-6 for the float32 rounding of
# parameters of magnitude ~1.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_MOMENT_TOL = 1e-4
TRAIN_NEAR_ZERO_G = 2e-7
# lm_train resume: steps 3-4 after a checkpoint against the same steps
# run straight, losses rtol (the card's embedding backward accumulates
# with atomics, so the two runs need not agree to the bit).
RESUME_RTOL = 1e-5
# the same resume in bfloat16: the checkpoint restores bit for bit, but
# the two runs' first steps may round a parameter's bf16 update the other
# way (the atomics above), which moves a loss read from bf16 logits by up
# to about one bf16 unit roundoff (2^-8).
RESUME_BF16_RTOL = 2.0 ** -8
TRAIN_STEPS = 6  # full-width steps; the step time is the median of 2-6
LM_ARCH = "qwen3-1.7b"  # the LM phases' model, at full width and depth
# lm_families: one serving run per family at published widths, (run, arch,
# layers): None keeps the published depth; phi3.5-moe (42 B parameters)
# and deepseek-v2 (236 B) are cut to what one card holds, deepseek to its
# dense first layer and two MoE layers
FAMILY_RUNS = (("ssm", "falcon-mamba-7b", None),
               ("hybrid", "zamba2-2.7b", None),
               ("encdec", "seamless-m4t-medium", None),
               ("moe_gqa", "phi3.5-moe-42b-a6.6b", 4),
               ("moe_mla", "deepseek-v2-236b", 3))
# flash_attention launches a full-depth prefill makes: every global
# self-attention from the empty cache (phi 4 of the cut model, zamba2's
# shared block after each of its 9 chunks, seamless' 12 decoder and 12
# encoder layers), none for MLA or an SSM
FAMILY_FLASH = {"ssm": 0, "hybrid": 9, "encdec": 24, "moe_gqa": 4,
                "moe_mla": 0}
# Decode against a fresh prefill, float32, 2 layers (hybrid 4: 2 chunks),
# as a share of the largest logit: the decode's _sdpa, MLA softmax or SSM
# recurrence sums in another order than the prefill's kernel or doubling
# scan, and the encdec decoder's cross-attention over encoder states of
# magnitude ~35 is near one-hot, so small differences grow (on the CPU the
# port and JAX differ by up to 5e-5 there: tests/test_torch_families.py).
FAMILY_DECODE_TOL = 1e-4
# Card against CPU, float32, the same layers: rtol and atol as a share of
# the largest logit, those of tests/test_torch_families.py.
FAMILY_CPU_TOL = (1e-4, 1e-4)
# seamless has no qk-norm: at full width q and k entries have a std of ~8
# (scale 1/sqrt(fan_in), fan_in the head count, as in the JAX package), so
# its logits' std is ~64, every softmax is near one-hot and each float32
# rounding of q or k grows ~100-fold.  The card's products round
# differently from the CPU's, so its float32 logits and encoder output
# stray from a float64 run several times further than the CPU's float32
# do, with the plain attention as with the kernel (the phase line's
# ``vs_float64``).  So seamless' card run is held against a float64 CPU
# run: its logits and encoder output no further from it than this factor
# times the same card path's with the plain versions
# (``flash_attention_ref``) in place of the kernel, plus FAMILY_CPU_TOL's
# atol; the two card runs share every product, so a fault in the kernel
# shows as the difference.
FAMILY_F64_FACTOR = 2.0

# lm_families_train: one full-width training run per family, (run, arch,
# most layers): depth, rows and mode come from the memory reckoning
# (family_train_plan); the cap keeps the phase near 150 s.  The runs hold
# FAMILY_TRAIN_BUDGET of the card's free memory at most.
FAMILY_TRAIN_RUNS = (("ssm", "falcon-mamba-7b", 8),
                     ("hybrid", "zamba2-2.7b", 12),
                     ("encdec", "seamless-m4t-medium", None),
                     ("moe_gqa", "phi3.5-moe-42b-a6.6b", None),
                     ("moe_mla", "deepseek-v2-236b", None))
FAMILY_TRAIN_SEQ = 2048
FAMILY_TRAIN_BUDGET = 0.85
# family_train_check, card against CPU at the check model's 2 layers: the
# CPU tests' tolerances (tests/test_torch_family_train.py): the loss rtol
# and each gradient leaf as a share of its largest CPU entry.  The check
# model's GQA attention is conditioned first (_condition_attention):
# without qk-norm, at published widths and the init's 1/sqrt(heads) scale
# q and k entries have a std of ~8, every softmax is near one-hot and
# float32 rounding grows past any tolerance: measured on an H100 80GB HBM3
# (700 W), card against CPU, phi3.5-moe 3.1e-3 of the embedding's
# largest gradient and zamba2 1.2e-3 (falcon-mamba 3.8e-6, deepseek-v2
# 9.9e-6), and for seamless 0.25 and 12 times a leaf's largest gradient
# between the card's float32 and a float64 CPU run (the CPU's float32 3.5
# times), 9.0 times between two float64 runs (card, CPU) whose norms and
# softmaxes round to float32 as the JAX package's do: no float64 run is a
# reference there.
FAMILY_TRAIN_LOSS_RTOL = 1e-6
FAMILY_TRAIN_GRAD_ATOL = 2e-3


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:  # seconds since the start, for the time budget
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" | "operations") for the given work."""
    t_bytes = nbytes / LIMITS.hbm_bytes_per_s * 1e3
    t_ops = ops / LIMITS.int32_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(f: int, nw: int, n_words: int) -> tuple[float, float]:
    """Bytes (offsets + text words touched + output) and 32-bit ops."""
    return (f * 4 + min(n_words, f * (nw + 1)) * 4 + f * nw * 4,
            f * nw * 20)


def probe_work(b: int, nw: int, n_words: int) -> tuple[float, float]:
    """Bytes (pos, pattern and mask rows, lengths, text words, verdict)."""
    return (b * 4 + 2 * b * nw * 4 + b * 4 + min(n_words, b * (nw + 1)) * 4
            + b * 4, b * nw * 30)


def kmer_work(n: int, k: int, base: int) -> tuple[float, float]:
    return (n + k - 1 + base**k * 4, n * (2 * k + 2))


def gather_pack_work(f: int, nw: int, n_s: int) -> tuple[float, float]:
    """Bytes (offsets + text bytes touched + output) and 32-bit ops of a
    byte-key gather: the text is read at most once."""
    return f * 4 + min(n_s, f * (4 * nw + 4)) + f * nw * 4, f * nw * 12


def lcp_work(f: int, nw: int) -> tuple[float, float]:
    """Bytes (both rows, three outputs) and ops, every word compared."""
    return 2 * f * nw * 4 + 3 * f * 4, f * nw * 4 + f * 8


def probe_bytes_work(b: int, nw: int, text_bytes: int) -> tuple[float, float]:
    """Bytes (pos, pattern and mask rows, text touched, verdict) and ops of
    a byte-key probe; ``text_bytes`` is the text it can touch."""
    return (b * 4 + 2 * b * nw * 4 + min(text_bytes, b * (4 * nw + 4))
            + b * 4, b * nw * 16)


def gather_packed_work(f: int, nw: int, bits: int,
                       n_words: int) -> tuple[float, float]:
    """Bytes (offsets, dense text words touched, key words out) and ops of
    a byte-key read from dense text: each dense word spreads to key words."""
    dense = -(-4 * nw * bits // 32) + 1
    return f * 4 + min(n_words, f * dense) * 4 + f * nw * 4, f * nw * 24


def suffix_lcp_work(lcp: torch.Tensor, w: int, syms_per_read: int,
                    text_bytes: int, read_bytes: int) -> tuple[float, float]:
    """Bytes and ops a suffix-pair LCP needs on this run's data: both
    positions in, one LCP out, and per suffix the reads up to its first
    difference (``syms_per_read`` symbols of ``read_bytes`` each)."""
    b = lcp.numel()
    reads = torch.clamp(lcp.to(torch.int64) // syms_per_read + 1,
                        max=-(-w // syms_per_read))
    total = int(reads.sum())
    return b * 12 + min(text_bytes, 2 * total * read_bytes), total * 2 * 16


def fused_work(b: int, nw_pat: int, nw_out: int, text_words: int,
               n_words: int, n_int_in: int) -> tuple[float, float]:
    """Bytes and ops of a fused probe + gather: ``n_int_in`` int32 inputs
    per row (positions, lengths), the pattern and mask rows, the text words
    this run's rows need, the verdict and the window out."""
    return (b * 4 * n_int_in + 2 * b * nw_pat * 4
            + min(n_words, text_words) * 4 + b * 4 + b * nw_out * 4,
            text_words * 30)


def span_words(pos: torch.Tensor, keys: torch.Tensor, spw: int):
    """Dense words that the 4 * ``keys`` symbols from ``pos`` lie in (none
    for no keys)."""
    last = pos.to(torch.int64) % spw + 4 * keys - 1
    return torch.where(keys > 0, last // spw + 1, 0)


def search_work(kind: str, text, ell, pat, mask, lengths, lim_p, lo0, hi0,
                n_iter: int, bounds: int):
    """What a search needs on this run's data, from the loop run with the
    plain verdicts: (trips per row, bytes, 32-bit ops, bounds).  Bytes:
    each row's pattern and mask once, its window, limits and result, and
    per trip 4 B of ``ell`` plus the text words the compare needs up to
    its first difference (words: and the word a funnel shift straddles;
    the byte string: and the word a byte pick straddles; dense words: those
    the key words' symbols span)."""
    from repro_torch.core import packing
    from repro_torch.kernels import ref as kref
    b, nw = pat.shape
    rep = lambda t: t if bounds == 1 else torch.cat([t, t])
    p2, m2, lo, hi = rep(pat), rep(mask), rep(lo0), rep(hi0)
    if kind == "words":
        l2, lp2 = rep(lengths), rep(lengths if lim_p is None else lim_p)
        per_row_in = 2 * nw * 4 + 4 * 4  # pattern, mask, lo, hi, len, lim
    else:  # byte keys: on the byte string, or over dense words ("packed")
        live = (m2 != 0).sum(1)  # zero mask words skip their load
        per_row_in = 2 * nw * 4 + 2 * 4
        probe, gather = ((kref.pattern_probe_packed_ref,
                          kref.range_gather_packed_ref) if kind == "packed"
                         else (kref.pattern_probe_ref,
                               kref.range_gather_pack_ref))
    upper = torch.arange(bounds * b, device=lo.device) >= b
    trips = torch.zeros(bounds * b, dtype=torch.int64, device=lo.device)
    text_bytes = 0
    total = ell.shape[0]
    for _ in range(n_iter):
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) // 2
        pos = ell[torch.clamp(mid, 0, total - 1)]
        if kind == "words":
            cmp = kref.pattern_probe_words_ref(text, pos, p2, m2, l2, lp2)
            spw = text.syms_per_word
            sw = kref.range_gather_words_ref(text, pos, nw * spw) & m2
            first = packing.lcp_words(sw, p2, text.bits).to(torch.int64) // spw
            read = torch.clamp(first + 1, max=nw) + 1
        else:
            cmp = probe(text, pos, p2, m2)
            neq = (gather(text, pos, 4 * nw) & m2) != p2
            first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                nw).to(torch.int64)
            keys = torch.minimum(first + 1, live)
            # the key words and the word a byte pick straddles, or the
            # dense words the keys' symbols span
            read = (span_words(pos, keys, text.syms_per_word)
                    if kind == "packed" else keys + 1)
        text_bytes += int((read * 4)[act].sum())
        trips += act
        right = torch.where(upper, cmp <= 0, cmp < 0)
        lo, hi = (torch.where(act & right, mid + 1, lo),
                  torch.where(act & ~right, mid, hi))
    n_trips = int(trips.sum())
    nbytes = b * per_row_in + bounds * b * 4 + n_trips * 4 + text_bytes
    return trips, nbytes, n_trips * (nw * 30 + 20), lo.reshape(bounds, b)


def sorted_pairs(keys: torch.Tensor, offs: torch.Tensor):
    """Offsets ordered by their key rows (unsigned, lexicographic), as
    (left, right) neighbour pairs: long shared prefixes, as adjacent
    suffix-array rows have."""
    from repro_torch.core.packing import to_u64
    from repro_torch.core.prepare import _pair_lanes, _stable_order
    order = _stable_order(_pair_lanes(
        [to_u64(keys[None, :, j]) for j in range(keys.shape[1])]))[0]
    o = offs[order]
    return o[:-1].contiguous(), o[1:].contiguous()


def occurrences(s_dev: torch.Tensor, p) -> torch.Tensor:
    """Every start of ``p`` in the device string, by narrowing the
    candidates one symbol at a time."""
    p = [int(c) for c in p]
    m = len(p)
    n1 = s_dev.shape[0]
    cand = torch.nonzero(s_dev[:max(0, n1 - m + 1)] == p[0]).flatten()
    for j in range(1, m):
        if cand.numel() == 0:
            break
        cand = cand[s_dev[cand + j] == p[j]]
    return cand


def brute_lcp(s_dev: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              chunk: int = 256) -> torch.Tensor:
    """LCP of distinct suffix pairs by symbol compare on the device string
    (the terminal is unique, so every pair differs by its end)."""
    n1 = s_dev.shape[0]
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    out = torch.zeros_like(a)
    pending = torch.arange(a.numel(), device=a.device)
    ar = torch.arange(chunk, device=a.device)
    while pending.numel():
        base = out[pending, None] + ar
        ia = torch.clamp(a[pending, None] + base, max=n1 - 1)
        ib = torch.clamp(b[pending, None] + base, max=n1 - 1)
        neq = s_dev[ia] != s_dev[ib]
        first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1), chunk)
        out[pending] += first
        pending = pending[first == chunk]
    return out


def assert_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version ({bad} entries differ)")


def brute_force(s_dev: torch.Tensor, p: np.ndarray) -> np.ndarray:
    """Every start of ``p`` in the device string, by a full scan."""
    m = len(p)
    n1 = s_dev.shape[0]
    match = torch.ones(n1 - m + 1, dtype=torch.bool, device=s_dev.device)
    for j, c in enumerate(p.tolist()):
        match &= s_dev[j:n1 - m + 1 + j] == c
    return torch.nonzero(match).flatten().cpu().numpy()


def check_index(dev, s, s_dev, pats, what: str) -> dict:
    """``ell`` a permutation of the suffixes, ``find_batch`` == scan."""
    hist = torch.bincount(dev.ell.to(torch.int64), minlength=len(s))
    if dev.n_leaves != len(s) or hist.numel() != len(s) or \
            not bool((hist == 1).all()):
        raise AssertionError(f"{what}: ell is not a permutation of 0..n")
    t0 = time.perf_counter()
    found = dev.find_batch(pats)
    t_find = time.perf_counter() - t0
    hits = 0
    for p, got_pos in zip(pats, found):
        want_pos = brute_force(s_dev, p)
        if not np.array_equal(got_pos, want_pos):
            raise AssertionError(f"{what}: find_batch disagrees with the "
                                 f"brute-force scan for pattern {p.tolist()}")
        hits += int(want_pos.size)
    return {"ell_permutation": True, "patterns": len(pats),
            "occurrences": hits, "t_find_batch_s": t_find}


def require_launches(counts: dict, kernels, what: str) -> None:
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on {what}")


def require_packs(launches: int, want: int, what: str) -> None:
    """``pack_text_dense.launches`` (outside ``ops.KERNELS``, so not in
    ``counts_now``) read after ``what``, counted from 0 just before it."""
    if launches != want:
        raise AssertionError(f"{what} launched pack_text_dense {launches} "
                             f"times, not {want}")


def flat_of(dev) -> dict:
    """A DeviceIndex's flat table on the host: its sorted prefixes, their
    leaf counts and ``ell_host`` (the layout ``ShardedIndex.flat_table``
    gives)."""
    plen = dev.sub_plen.cpu().numpy()
    pref = dev.sub_prefix.cpu().numpy()
    return {"prefixes": [tuple(int(c) for c in pref[t, :plen[t]])
                         for t in range(len(plen))],
            "freqs": dev.sub_freq.cpu().numpy(), "ell": dev.ell_host}


def require_flat(sh, want: dict, what: str) -> None:
    """``sh.flat_table()`` equal to the kept host arrays ``want``."""
    prefixes, freqs, ell = sh.flat_table()
    if prefixes != want["prefixes"]:
        raise AssertionError(f"{what}: the prefixes differ")
    for key, got in (("freqs", freqs), ("ell", ell)):
        if not np.array_equal(got, want[key]):
            raise AssertionError(f"{what}: {key} differs")


def search_batch_launches(search, kernel: str, what: str) -> None:
    """One search (or find-and-fetch) batch launches its kernel once and
    no single-step probe or epilogue kernel: counted from 0 around one
    call."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    search()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = {k: counts[k] for k in ("pattern_probe_words", "pattern_probe",
                                    "pattern_probe_packed",
                                    "probe_gather_words",
                                    "probe_gather_packed")}
    emit({"phase": "search_launches", "path": what, "kernel": kernel,
          "search_launches_per_batch": counts[kernel],
          "single_step_probe_launches": steps})
    if counts[kernel] != 1 or any(steps.values()):
        raise AssertionError(f"{what}: a search batch launched {kernel} "
                             f"{counts[kernel]} times and the single-step "
                             f"probes {steps}")


def counts_now() -> dict:
    """``ops.launch_counts()`` plus the rows and words that the three
    elastic-range gathers' counted launches gathered (their time scales
    with them, so ROADMAP queue B ranks them by them, not by launches
    alone)."""
    from repro_torch.kernels import ops
    return {**ops.launch_counts(),
            **{f"{k}_{t}": getattr(ops.KERNELS[k], t)
               for k in GATHERS for t in ("rows", "words")}}


def kernel_of(key: str) -> str | None:
    """The port kernel (``ops.KERNELS`` name) a profiler event belongs to:
    the longest kernel name that begins the event's function name."""
    import re
    from repro_torch.kernels import ops
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", key)
    base = m.group(1) if m else key
    names = [k for k in ops.KERNELS if base.startswith(k)]
    return max(names, key=len) if names else None


def attention_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                   itemsize: int) -> tuple[float, float]:
    """Bytes (q, k, v in, out written once) and FLOPs (QK^T and PV over the
    key positions each row sees) of one causal attention call."""
    pairs = sum(min(i + 1, sk) for i in range(sq))
    return ((2 * b * sq * h * d + 2 * b * sk * kv * d) * itemsize,
            4.0 * b * h * pairs * d)


def pack_text_phase(cuda, n_log2: int = 27) -> dict:
    """``pack_text_dense`` on a 2^n_log2 DNA string with the construction
    text's tail (``2 * w_max + 8`` = 520): the kernel's device ms (CUDA
    events over back-to-back launches of the C entry), one wrapper call
    (launch and flag read), ``pack_text`` on the host clock (the codes'
    pageable copy, the launch, the flag), the plain version on the card,
    a numpy pack on the host (``pack_text_stream`` in one chunk: the kind
    of host work the kernel replaced), and the byte bound; the words held
    equal to both."""
    from repro_torch.core import packing
    from repro_torch.core.alphabet import ALPHABETS
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.pack_text import pack_text_dense

    a, extra = ALPHABETS["dna"], 520
    n = 1 << n_log2
    s = a.random_string(n, seed=35)
    n_words = -(-(n + extra) // 16) + 1
    real = torch.from_numpy(s[:-1].copy()).to(cuda)
    got = pack_text_dense(real, n_words, 2, "dna")
    plain = kref.pack_text_dense_ref(real, n_words, 2)
    t0 = time.perf_counter()
    want = packing.pack_text_stream([s], a, extra=extra, device="cpu")
    numpy_s = time.perf_counter() - t0
    assert_equal(got, plain, "pack_text_dense against its plain version")
    assert_equal(got.cpu(), want.words,
                 "pack_text_dense against the numpy pack")
    fn = _build.entry("pack_text_dense", [ctypes.c_void_p, ctypes.c_longlong,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p])
    bad = torch.zeros(1, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = cuda_ms(lambda: _build.check(fn(
        real.data_ptr(), n, n_words, 2, got.data_ptr(), bad.data_ptr(),
        stream), "pack_text_dense"), reps=10, inner=20)
    call_ms = cuda_ms(lambda: pack_text_dense(real, n_words, 2), reps=10)
    plain_ms = cuda_ms(lambda: kref.pack_text_dense_ref(real, n_words, 2))
    host = []
    pack_text_dense.launches = 0
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packing.pack_text(s, a, extra=extra, device=cuda)
        host.append(time.perf_counter() - t0)
    if pack_text_dense.launches != len(host):
        raise AssertionError(f"{len(host)} pack_text calls launched "
                             f"pack_text_dense {pack_text_dense.launches} "
                             "times, not once each")
    bound_ms, bound_by = bound(n + 4 * n_words, 0)
    del real, got, plain
    torch.cuda.empty_cache()
    return {"phase": "pack_text", "n": n, "n_words": n_words,
            "kernel_ms": kernel_ms, "call_ms": call_ms,
            "pack_text_s": float(np.median(host)), "plain_ms": plain_ms,
            "numpy_s": numpy_s, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_pct": 100 * bound_ms / kernel_ms,
            "launches_per_pack_text": pack_text_dense.launches // len(host)}


def flash_parity(cuda) -> list:
    """``flash_attention`` against ``flash_attention_ref`` on the card, float32
    matrix products in full precision (TF32 off, set here).  Tolerances:
    float32 rtol 1e-5 / atol 2e-5 (the JAX test's own: the online softmax
    sums in another order); bfloat16 ``BF16_TOL``, one bf16 ulp of each
    output.  A case with a ninth field scales q by it before the cast."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, Sq, Sk, H, KV, D, causal, dtype[, q scale])
        (2, 128, 128, 4, 2, 32, True, f32),    # tests/test_flash_and_packed.py
        (1, 256, 256, 8, 8, 64, True, f32),
        (2, 128, 128, 4, 1, 32, False, f32),
        (1, 64, 64, 2, 2, 16, True, f32),
        (2, 96, 96, 4, 4, 32, True, f32),
        (1, 128, 128, 4, 2, 32, True, bf16),   # its bf16 case
        (2, 64, 128, 4, 2, 32, True, f32),     # Sq != Sk
        (2, 200, 77, 4, 2, 48, True, f32),
        (1, 1000, 1000, 4, 2, 128, True, f32),  # a ragged length
        (1, 300, 300, 8, 2, 256, True, f32),   # D 256
        (1, 300, 300, 8, 2, 256, False, bf16),
        # the edges of the bf16 wgmma + TMA kernel's 64-row, 64-key and
        # 64-column tiles and of its two warpgroups
        (1, 192, 192, 4, 4, 128, True, bf16),  # GQA group 1
        (2, 160, 160, 8, 2, 64, True, bf16),   # group 4
        (1, 256, 256, 8, 1, 128, True, bf16),  # group 8
        (2, 100, 100, 4, 2, 16, True, bf16),   # D 16
        (1, 130, 130, 4, 2, 48, False, bf16),  # D 48
        (2, 150, 150, 4, 2, 80, True, bf16),   # D 80
        (1, 300, 300, 8, 2, 256, True, bf16),  # D 256
        (2, 1, 300, 8, 2, 128, True, bf16),    # Sq 1
        (1, 1000, 1000, 4, 2, 128, True, bf16),  # Sq not a multiple of 64
        (2, 50, 40, 4, 2, 64, True, bf16),     # Sk < 64
        (1, 65, 300, 4, 2, 128, True, bf16),   # Sq < Sk
        (1, 300, 65, 4, 2, 128, True, bf16),   # Sq > Sk
        (2, 300, 300, 8, 2, 128, True, bf16, 8.0),  # q x 8: the max moves
        (4, 2048, 2048, 16, 8, 128, True, bf16),  # qwen3-1.7b's prefill
        (4, 2048, 2048, 16, 8, 128, True, f32),
        # lm_families: zamba2's shared block (D 80, padded to the DC = 2
        # template) and seamless' encoder (D 64, the full mode)
        (4, 2048, 2048, 32, 32, 80, True, bf16),
        (4, 2048, 2048, 32, 32, 80, True, f32),
        (4, 1024, 1024, 16, 16, 64, False, bf16),
        (4, 1024, 1024, 16, 16, 64, False, f32),
    ]
    gen = torch.Generator(device=cuda).manual_seed(5)
    out = []
    for b, sq, sk, h, kv, d, causal, dtype, *q_scale in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=cuda)
                   for shape in ((b, sq, h, d), (b, sk, kv, d),
                                 (b, sk, kv, d)))
        if q_scale:
            q = q * q_scale[0]
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        design = ops.flash_attention.route
        if design != ("wgmma_tma" if dtype == bf16 else "cuda_cores"):
            raise AssertionError(f"flash_attention ran {design} for {dtype}")
        want = kref.flash_attention_ref(q, k, v, causal)
        tol = (1e-5, 2e-5) if dtype == f32 else BF16_TOL
        err = float((got.float() - want.float()).abs().max())
        case = {"phase": "parity", "kernel": "flash_attention",
                "shape": [b, sq, sk, h, kv, d], "causal": causal,
                "dtype": str(dtype).replace("torch.", ""), "design": design,
                "q_scale": q_scale[0] if q_scale else 1.0,
                "max_abs_err": err,
                "rtol": tol[0], "atol": tol[1], "tf32": False}
        emit(case)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                                   atol=tol[1])
        out.append(case)
        del q, k, v, got, want
    return out


def lm_serving(cuda):
    """``serve(LM_ARCH)`` at full width in bf16 on the card, 4 prompts of
    2048 tokens and 32 generated, twice (the first warms the libraries),
    then once under ``torch.profiler``: times, peak memory above what
    earlier phases hold, flash launches per step kind, and the device time
    by kernel.
    The decode step is wrapped to read the launch count around each call
    and the cache position it returns; the path itself is unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import get_config
    cfg = get_config(LM_ARCH)
    batch, prompt_len, gen = 4, 2048, 32
    real_step = serve_mod.step_lib.make_decode_step
    seen = {"decode_launches": 0, "pos": None}

    def counted_step(cfg_, **kw):
        step = real_step(cfg_, **kw)

        def run(params, tokens, cache):
            before = ops.launch_counts()["flash_attention"]
            nxt, cache = step(params, tokens, cache)
            seen["decode_launches"] += (ops.launch_counts()["flash_attention"]
                                        - before)
            seen["pos"] = cache["pos"]
            return nxt, cache
        return run

    serve_mod.step_lib.make_decode_step = counted_step
    runs = []
    try:
        for name in ("cold", "warm", "profiled"):
            ops.reset_launch_counts()
            seen.update(decode_launches=0, pos=None)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # left by earlier phases
            # device activity only: summarizing a CPU op trace of the
            # decode's ~10^5 ops took a minute
            ctx = (profile(activities=[ProfilerActivity.CUDA])
                   if name == "profiled" else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx as prof:
                tokens, st = serve_mod.serve(
                    LM_ARCH, smoke=False, batch=batch, prompt_len=prompt_len,
                    gen=gen, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = counts_now()
            flash = counts["flash_attention"]
            row = {"phase": "lm_serving", "run": name, "arch": LM_ARCH,
                   "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "params": cfg.param_count(), "dtype": "bfloat16",
                   "batch": batch, "prompt_len": prompt_len, "gen": gen,
                   **st, "wall_s": wall,
                   "prefill_tok_s": batch * prompt_len / st["t_prefill_s"],
                   "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                      - held) / 1e9,
                   "held_before_gb": held / 1e9,
                   "flash_launches_prefill": flash - seen["decode_launches"],
                   "flash_launches_decode": seen["decode_launches"],
                   "flash_design": ops.flash_attention.route,
                   "pos": seen["pos"], "launches": counts}
            if prof is not None:
                row.update(device_breakdown(
                    prof, st["t_prefill_s"] + st["t_decode_s"]))
            emit(row)
            toks = tokens.cpu()
            if (row["flash_launches_prefill"] != cfg.n_layers
                    or seen["decode_launches"] != 0
                    or row["flash_design"] != "wgmma_tma"):
                raise AssertionError(f"lm_serving: flash_attention launched "
                                     f"{row['flash_launches_prefill']} times "
                                     f"in the prefill (want {cfg.n_layers}) "
                                     f"and {seen['decode_launches']} in the "
                                     f"decode (want 0), the last through "
                                     f"{row['flash_design']} (want "
                                     f"wgmma_tma)")
            if (toks.shape != (batch, gen) or toks.dtype != torch.int32
                    or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab):
                raise AssertionError("lm_serving: tokens out of the vocabulary")
            if seen["pos"] != prompt_len + gen - 1:
                raise AssertionError(f"lm_serving: cache pos {seen['pos']}, "
                                     f"want {prompt_len + gen - 1}")
            runs.append(row)
    finally:
        serve_mod.step_lib.make_decode_step = real_step
    return runs


def device_events(prof) -> list[tuple[float, str, int]]:
    """(ms, name, calls) of every device-side event (kernels, copies and
    sets) a profile recorded.  A host op such as ``aten::sort`` also
    reports the device time of the kernels it launched, so summing every
    row of ``key_averages()`` would count those kernels twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us and getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU:
            rows.append((us / 1e3, e.key, e.count))
    return rows


def device_breakdown(prof, span_s: float, top: int | None = 8,
                     events: list | None = None) -> dict:
    """Device milliseconds and calls by kernel name (the ``top`` largest;
    every one for None) and the device's busy share of ``span_s``: for
    ``serve`` the prefill and decode seconds it timed (the device total
    also holds the few ms of parameter init), for a build its wall.
    ``events``: ``device_events(prof)`` when the caller has them."""
    rows = sorted(device_events(prof) if events is None else events,
                  reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms": total,
            "device_busy_share": total / (span_s * 1e3) if total else None,
            "top_kernels": [{"name": k[:80], "ms": ms, "calls": c,
                             "kernel": kernel_of(k)}
                            for ms, k, c in rows[:top]]}


def lm_check(cuda):
    """Decode against prefill in float32 at full width, batch 2, prompt
    512: the logits of decode step j (``_sdpa`` over the cache) against
    the last-position logits of a fresh prefill over prompt + the j tokens
    decoded before (the ``flash_attention`` kernel, at a ragged length);
    then a 2-layer
    full-width prefill on the card against the same parameters on the CPU
    (plain versions).  Tolerances (float32 over 28 and 2 layers, sums in
    another order on the card and the CPU): see LM_TOL and CPU_TOL."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    batch, prompt_len, steps = 2, 512, (1, 8)
    ops.reset_launch_counts()
    params = T.init_params(1, cfg, torch.float32, cuda)
    rng = np.random.default_rng(21)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(batch, prompt_len), dtype=np.int32)).to(cuda)
    jmax = max(steps)
    cache = T.init_cache(cfg, batch, prompt_len + jmax + 1, torch.float32, cuda)
    logits, cache = T.forward_prefill(params, {"tokens": prompt}, cfg, cache)
    fed = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    results = []
    for j in range(1, jmax + 1):
        dec_logits, cache = T.forward_decode(params, fed[-1], cfg, cache)
        if j in steps:
            seq = torch.cat([prompt] + fed, dim=1)
            fresh = T.init_cache(cfg, batch, seq.shape[1], torch.float32, cuda)
            want, _ = T.forward_prefill(params, {"tokens": seq}, cfg, fresh)
            del fresh
            got, want = dec_logits[:, -1], want[:, -1]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            results.append({"step": j, "prefill_len": seq.shape[1],
                            "max_abs_err": err, "max_abs_logit": scale,
                            "rel_err": err / scale,
                            "argmax_equal": bool(torch.equal(
                                got.argmax(-1), want.argmax(-1)))})
            if not torch.isfinite(got).all() or err > LM_TOL * scale:
                raise AssertionError(f"lm_check: decode step {j} differs from "
                                     f"the prefill by {err} (max |logit| "
                                     f"{scale}, tolerance {LM_TOL} of it)")
        fed.append(torch.argmax(dec_logits[:, -1], -1).to(torch.int32)[:, None])
    counts = counts_now()
    emit({"phase": "lm_check", "what": "decode vs prefill", "arch": LM_ARCH,
          "dtype": "float32", "n_layers": cfg.n_layers, "batch": batch,
          "prompt_len": prompt_len, "steps": results, "tolerance": LM_TOL,
          "flash_launches": counts["flash_attention"]})
    if counts["flash_attention"] != cfg.n_layers * (1 + len(steps)):
        raise AssertionError("lm_check: every prefill layer must run "
                             "flash_attention")
    del cache, logits

    # 2 layers of the same parameters, on the card and on the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = dict(params, layers={k: _slice_tree(v, 2)
                              for k, v in params["layers"].items()})
    del params
    torch.cuda.empty_cache()
    got, _ = T.forward_prefill(p2, {"tokens": prompt}, cfg2, T.init_cache(
        cfg2, batch, prompt_len, torch.float32, cuda))
    p_cpu = _to_device(p2, "cpu")
    del p2
    torch.cuda.empty_cache()
    want, _ = T.forward_prefill(p_cpu, {"tokens": prompt.cpu()}, cfg2,
                                T.init_cache(cfg2, batch, prompt_len,
                                             torch.float32, "cpu"))
    got = got.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    emit({"phase": "lm_check", "what": "card vs cpu", "arch": LM_ARCH,
          "dtype": "float32", "n_layers": 2, "batch": batch,
          "prompt_len": prompt_len, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "rtol": CPU_TOL[0], "atol_rel": CPU_TOL[1]})
    torch.testing.assert_close(got, want, rtol=CPU_TOL[0],
                               atol=CPU_TOL[1] * scale)


def _planted_token_batch() -> np.ndarray:
    """``examples/corpus_index.py``'s batch (16 x 256 tokens, vocab
    32,000): rows 5 and 11 copy a 128-token block of row 2."""
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
    cfg = TokenPipelineConfig(vocab=32_000, batch=16, seq_len=256, seed=0)
    seqs = batch_at_step(cfg, 0)["tokens"].copy()
    seqs[5, 50:178] = seqs[2, 50:178]
    seqs[11, 0:128] = seqs[2, 50:178]
    return seqs


def train_batch_rows(cfg, seq: int, free_bytes: int) -> tuple[int, str]:
    """The full-width batch (rows of ``seq`` tokens) that fits in
    ``free_bytes``: 4 unless the reckoning says otherwise.  Parameters,
    gradients and the two float32 moments take 16 B a parameter; a row
    takes its float32 logits about 4 times (the logits, logsumexp's
    backward, the gathered label's scatter and their sum), one remat
    checkpoint a layer and about 4 copies of one layer's attention
    scores (``_sdpa``'s logits, mask, softmax and their gradient)."""
    fixed = 16 * cfg.param_count()
    per_row = (4 * seq * cfg.vocab * 4 + cfg.n_layers * seq * cfg.d_model * 4
               + 4 * cfg.n_heads * seq * seq * 4)
    for rows in (4, 2, 1):
        need = fixed + rows * per_row
        if need <= 0.9 * free_bytes:
            why = ("" if rows == 4 else
                   f"4 rows need ~{(fixed + 4 * per_row) / 1e9:.1f} GB, "
                   f"{free_bytes / 1e9:.1f} GB free")
            return rows, why
    raise AssertionError(f"lm_train: one row needs ~{need / 1e9:.1f} GB, "
                         f"{free_bytes / 1e9:.1f} GB free")


def lm_train(cuda) -> list[dict]:
    """LM training on the card (``repro_torch.launch.train``), float32,
    TF32 at torch's default (off):

    (a) ``train(LM_ARCH, smoke=False)``: all 28 layers at published
        widths, TRAIN_STEPS steps of 4 x 2048 tokens (fewer rows only if
        ``train_batch_rows`` says they do not fit), ``log_every=1``, no
        checkpoint; the train step is wrapped to time each call between
        two ``torch.cuda.synchronize`` and to read its metrics (the path
        is unchanged); then one more step of the same shapes under
        ``torch.profiler`` for the device's busy share and top kernels;
    (b) a 2-layer full-width ``train_step`` (batch 2 x 128) on the card
        against the same step on the CPU (plain versions): loss, grad
        norm, lr, m, v and the new parameters (see TRAIN_*);
    (c) at the same 2 layers (the registry's config swapped, as
        ``examples/torch_train_lm.py --hundred-m`` does), 4 straight
        steps against 2 steps + a checkpoint + a resumed ``train`` to 4,
        in float32 and again in bfloat16 (the bf16 checkpoint restored
        bit for bit against the parameters it saved; ``RESUME_BF16_RTOL``);
    (d) ``dedup_mask`` on the card, on the planted example batch and on a
        4 x 2048 training batch with one planted 256-token repeat, equal
        to the CPU's; its launches counted from 0 (``range_gather_words``
        required).

    No training launch may reach ``flash_attention``.  Returns the
    launch counts of the dedup runs (main-path launches)."""
    import dataclasses
    import shutil
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.configs.qwen3_1_7b as arch_mod
    from repro_torch import pytree
    from repro_torch.data import tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime import checkpoint

    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32["matmul_allow_tf32"]:
        raise AssertionError("lm_train: TF32 is on; torch's default is off")
    cfg = get_config(LM_ARCH)
    if arch_mod.CONFIG is not cfg:
        raise AssertionError("lm_train: the registry does not read the "
                             "config module")

    # ---- (a) full width --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    seq = 2048
    held = torch.cuda.memory_allocated()
    rows, why = train_batch_rows(cfg, seq, torch.cuda.mem_get_info()[0])
    real_make = step_lib.make_train_step
    seen = []

    def timed_make(cfg_, opt_cfg, **kw):
        step = real_make(cfg_, opt_cfg, **kw)

        def run(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            seen.append({"s": time.perf_counter() - t0,
                         "loss": float(out[2]["loss"]),
                         "grad_norm": float(out[2]["grad_norm"]),
                         "lr": float(out[2]["lr"])})
            return out
        return run

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    train_mod.step_lib.make_train_step = timed_make
    try:
        t0 = time.perf_counter()
        params, losses = train_mod.train(
            LM_ARCH, smoke=False, steps=TRAIN_STEPS, batch=rows, seq=seq,
            log_every=1, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_mod.step_lib.make_train_step = real_make
    peak = torch.cuda.max_memory_allocated() - held
    counts = counts_now()
    step_s = float(np.median([r["s"] for r in seen[1:]]))
    row = {"phase": "lm_train", "what": "full width", "arch": LM_ARCH,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "params": cfg.param_count(),
           "dtype": "float32", **tf32, "batch": rows, "seq": seq,
           "batch_cut": why or None, "steps": TRAIN_STEPS,
           "per_step": seen, "losses": losses, "wall_s": wall,
           "step_s_median_2_6": step_s, "tokens_per_s": rows * seq / step_s,
           "peak_memory_gb": peak / 1e9, "held_before_gb": held / 1e9,
           "flash_launches": counts["flash_attention"],
           "launches": {k: v for k, v in counts.items() if v}}
    if (len(seen) != TRAIN_STEPS or len(losses) != TRAIN_STEPS
            or not all(np.isfinite([r["loss"] for r in seen]))
            or not all(np.isfinite([r["grad_norm"] for r in seen]))
            or [r["loss"] for r in seen] != losses):
        emit(row)
        raise AssertionError("lm_train: a full-width step was not finite, "
                             "or the driver's losses are not its steps'")
    if counts["flash_attention"]:
        raise AssertionError("lm_train: training launched flash_attention")

    # one more step of the same shapes under the profiler (device events)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                                warmup_steps=max(10, TRAIN_STEPS // 20))
    opt_state = adamw.init(params)
    pipe = tokens.TokenPipelineConfig(vocab=cfg.vocab, batch=rows, seq_len=seq)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in tokens.batch_at_step(pipe, TRAIN_STEPS).items()}
    step = step_lib.make_train_step(cfg, opt_cfg, donate=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    row.update(profiled_step_s=prof_s,
               **device_breakdown(prof, prof_s, top=10))
    emit(row)
    del params, opt_state, batch, step, prof
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) card against CPU, 2 layers at full width ---------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=4, warmup_steps=10)
    step = step_lib.make_train_step(cfg2, opt_cfg)
    pipe = tokens.TokenPipelineConfig(vocab=cfg.vocab, batch=2, seq_len=128)
    b_np = tokens.batch_at_step(pipe, 0)
    p_card = T.init_params(3, cfg2, torch.float32, cuda)
    p_cpu = pytree.tree_map(lambda t: t.cpu(), p_card)
    ops.reset_launch_counts()
    gp, go, gm = step(p_card, adamw.init(p_card),
                      {k: torch.from_numpy(v).to(cuda) for k, v in b_np.items()})
    torch.cuda.synchronize()
    if ops.launch_counts()["flash_attention"]:
        raise AssertionError("lm_train: training launched flash_attention")
    cp, co, cm = step(p_cpu, adamw.init(p_cpu),
                      {k: torch.from_numpy(v) for k, v in b_np.items()})
    lr = float(cm["lr"])
    worst = {"m": 0.0, "v": 0.0, "params": 0.0}
    flipped = 0
    for (path, p_new), p_want, m_got, m_want, v_got, v_want in zip(
            pytree.leaves_with_paths(gp), pytree.leaves(cp),
            pytree.leaves(go.m), pytree.leaves(co.m),
            pytree.leaves(go.v), pytree.leaves(co.v)):
        name = "/".join(path)
        tols = {}
        for key, got, want in (("m", m_got, m_want), ("v", v_got, v_want)):
            got = got.cpu()
            tol = TRAIN_MOMENT_TOL * (float(want.abs().max()) + want.abs())
            err = (got - want).abs()
            worst[key] = max(worst[key], float((err / tol.clamp(min=1e-30)).max()))
            if not bool((err <= tol).all()):
                raise AssertionError(f"lm_train: {key} of {name} differs by "
                                     f"{float(err.max())} (card against CPU)")
            tols[key] = TRAIN_MOMENT_TOL * float(want.abs().max())
        g_noise = max(tols["m"] / (1 - opt_cfg.b1), TRAIN_NEAR_ZERO_G)
        near0 = (m_want.abs() / (1 - opt_cfg.b1)) <= g_noise
        allowed = 1e-6 + lr * torch.where(near0, 2.0, 0.05)
        err = (p_new.cpu() - p_want).abs()
        worst["params"] = max(worst["params"], float((err / allowed).max()))
        flipped += int(((err > 1e-6 + 0.05 * lr) & near0).sum())
        if not bool((err <= allowed).all()):
            raise AssertionError(f"lm_train: the new {name} differs by "
                                 f"{float(err.max())} (card against CPU)")
    card_cpu = {"phase": "lm_train", "what": "card vs cpu", "arch": LM_ARCH,
                "n_layers": 2, "dtype": "float32", **tf32, "batch": 2,
                "seq": 128, "loss_card": float(gm["loss"]),
                "loss_cpu": float(cm["loss"]),
                "grad_norm_card": float(gm["grad_norm"]),
                "grad_norm_cpu": float(cm["grad_norm"]),
                "lr_card": float(gm["lr"]), "lr_cpu": lr,
                "worst_share_of_tolerance": worst,
                "params_stepped_opposite": flipped,
                "tolerances": {"loss_rtol": TRAIN_LOSS_RTOL,
                               "grad_norm_rtol": TRAIN_GNORM_RTOL,
                               "moment_tol": TRAIN_MOMENT_TOL,
                               "near_zero_g": TRAIN_NEAR_ZERO_G}}
    emit(card_cpu)
    if (abs(card_cpu["loss_card"] - card_cpu["loss_cpu"])
            > TRAIN_LOSS_RTOL * abs(card_cpu["loss_cpu"])
            or abs(card_cpu["grad_norm_card"] - card_cpu["grad_norm_cpu"])
            > TRAIN_GNORM_RTOL * card_cpu["grad_norm_cpu"]
            or card_cpu["lr_card"] != lr):
        raise AssertionError("lm_train: the card's loss, grad norm or lr "
                             "differs from the CPU's")
    del p_card, p_cpu, gp, go, cp, co
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) resume, 2 layers at full width --------------------------------
    kw = dict(smoke=False, steps=4, batch=2, seq=128, log_every=1, device=cuda)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_", dir=ROOT / "build")
    arch_mod.CONFIG = cfg2  # the driver reads the registry fresh
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, straight = train_mod.train(LM_ARCH, **kw)
        _, first = train_mod.train(LM_ARCH, **{**kw, "steps": 2},
                                   ckpt_dir=ckpt_dir, ckpt_every=2)
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).iterdir())
        _, resumed = train_mod.train(LM_ARCH, **kw, ckpt_dir=ckpt_dir,
                                     ckpt_every=100)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        arch_mod.CONFIG = cfg
        shutil.rmtree(ckpt_dir)
    got = first + resumed
    err = max(abs(a - b) / abs(b) for a, b in zip(got, straight))
    res_row = {"phase": "lm_train", "what": "resume", "arch": LM_ARCH,
               "n_layers": 2, "batch": 2, "seq": 128,
               "straight": straight, "first": first, "resumed": resumed,
               "max_rel_err": err, "rtol": RESUME_RTOL,
               "checkpoint_gb": ckpt_bytes / 1e9, "wall_s": resume_s,
               "flash_launches": ops.launch_counts()["flash_attention"]}
    emit(res_row)
    if (len(got) != 4 or len(straight) != 4 or err > RESUME_RTOL
            or res_row["flash_launches"]):
        raise AssertionError("lm_train: the resumed losses differ from the "
                             "straight run's")

    # ---- (c') the same resume in bfloat16: a bf16 checkpoint both ways -----
    kw_bf16 = {**kw, "dtype": torch.bfloat16}
    ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_bf16_", dir=ROOT / "build")
    arch_mod.CONFIG = cfg2
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, straight = train_mod.train(LM_ARCH, **kw_bf16)
        saved, first = train_mod.train(LM_ARCH, **{**kw_bf16, "steps": 2},
                                       ckpt_dir=ckpt_dir, ckpt_every=2)
        path = checkpoint.latest_step_path(ckpt_dir)
        ckpt_bytes = Path(path).stat().st_size
        (restored,), _ = checkpoint.restore(path, (saved,))  # params alone
        bits_equal = all(
            r.dtype == s.dtype == torch.bfloat16 and torch.equal(
                r.view(torch.int16), s.view(torch.int16))
            for r, s in zip(pytree.leaves(restored), pytree.leaves(saved)))
        del restored, saved
        _, resumed = train_mod.train(LM_ARCH, **kw_bf16, ckpt_dir=ckpt_dir,
                                     ckpt_every=100)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        arch_mod.CONFIG = cfg
        shutil.rmtree(ckpt_dir)
    got = first + resumed
    err = max(abs(a - b) / abs(b) for a, b in zip(got, straight))
    bf16_row = {"phase": "lm_train", "what": "resume bf16", "arch": LM_ARCH,
                "n_layers": 2, "batch": 2, "seq": 128, "dtype": "bfloat16",
                "straight": straight, "first": first, "resumed": resumed,
                "max_rel_err": err, "rtol": RESUME_BF16_RTOL,
                "params_restored_bit_for_bit": bits_equal,
                "checkpoint_gb": ckpt_bytes / 1e9, "wall_s": resume_s,
                "flash_launches": ops.launch_counts()["flash_attention"]}
    emit(bf16_row)
    if (len(got) != 4 or len(straight) != 4 or err > RESUME_BF16_RTOL
            or not bits_equal or bf16_row["flash_launches"]):
        raise AssertionError("lm_train: the bf16 checkpoint did not restore "
                             "bit for bit, or its resumed losses differ")

    # ---- (d) the ERA dedup filter on the card ------------------------------
    big_cfg = tokens.TokenPipelineConfig(vocab=cfg.vocab, batch=4, seq_len=2048)
    big = tokens.batch_at_step(big_cfg, 0)["tokens"].copy()
    big[3, 100:356] = big[1, 1000:1256]
    dedup_counts = []
    for name, seqs, kw in (("planted", _planted_token_batch(),
                            dict(min_repeat=64)),
                           ("train_batch", big, {})):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        keep = tokens.dedup_mask(seqs, device=cuda, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counts_now()
        want = tokens.dedup_mask(seqs, device="cpu", **kw)
        emit({"phase": "lm_train", "what": "dedup", "batch": name,
              "shape": list(seqs.shape), **kw,
              "flagged": np.nonzero(~keep)[0].tolist(),
              "flagged_cpu": np.nonzero(~want)[0].tolist(), "s": dt,
              "launches": {k: v for k, v in c.items() if v}})
        if not np.array_equal(keep, want) or keep.all():
            raise AssertionError(f"lm_train: dedup_mask on {name} differs "
                                 "from the CPU's or flags nothing")
        require_launches(c, ("range_gather_words",), f"dedup {name}")
        dedup_counts.append(c)
    return dedup_counts


def flash_row(cuda, cases: list) -> dict:
    """``flash_attention`` at the prefill shape of qwen3-1.7b (bf16, B 4,
    S 2048, H 16, KV 8, D 128, causal): its time, the plain version's, SDPA's
    on the same inputs, and the bound (FLOPs over the bf16 tensor-core
    peak, or bytes over the memory rate, whichever is larger); then its
    time and SDPA's at zamba2's shared-block shape (D 80, H 32 = KV 32) as
    ``ms_d80`` and ``library_ms_d80``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    b, s, h, kv, d = 4, 2048, 16, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    nbytes, flops = attention_work(b, s, s, h, kv, d, 2)
    t_bytes = nbytes / LIMITS.hbm_bytes_per_s * 1e3
    t_ops = flops / LIMITS.bf16_flops * 1e3
    path = [c for c in cases if c["shape"] == [b, s, s, h, kv, d]
            and c["dtype"] == "bfloat16"]
    # 10 back-to-back calls a window: the wrapper's host work (three
    # tensor-map encodes) overlaps the device, as in the prefill
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), inner=10)
    if ops.flash_attention.route != "wgmma_tma":
        raise AssertionError("bf16 flash_attention did not run wgmma_tma")
    # zamba2's shared block: D 80 (H 32 = KV 32), beside SDPA there
    q8, k8, v8 = (torch.randn((b, s, 32, 80), generator=gen, device=cuda
                              ).to(torch.bfloat16) for _ in range(3))
    d80 = {"shape_d80": f"B={b} S={s} H=32 KV=32 D=80 causal bf16",
           "ms_d80": cuda_ms(lambda: ops.flash_attention(q8, k8, v8),
                             inner=10),
           "library_ms_d80": cuda_ms(
               lambda: F.scaled_dot_product_attention(
                   q8.transpose(1, 2), k8.transpose(1, 2),
                   v8.transpose(1, 2), is_causal=True), inner=10)}
    return {"name": "flash_attention",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "design": "wgmma_tma",
            "shape": f"B={b} S={s} H={h} KV={kv} D={d} causal bf16",
            "ms": ms,
            "plain_ms": cuda_ms(
                lambda: kref.flash_attention_ref(q, k, v, True)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), inner=10),
            "library": "torch.nn.functional.scaled_dot_product_attention"
                       "(is_causal=True, enable_gqa=True)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": path[0]["max_abs_err"], **d80}


# device kernels of a family's prefill by what they do: the first class
# whose pattern occurs in a kernel's (lower-cased) name takes it.  "mul"
# holds the scan's decay products and every other product of elements.
FAMILY_KERNEL_CLASSES = (
    ("flash_attention", ("flash_attention",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("scan_addcmul", ("addcmul",)),
    ("mul", ("mulfunctor",)),
    ("exp", ("exp_kernel",)),
    ("softmax", ("softmax",)),
    ("moe_scatter_gather", ("index_put", "indexing", "index_elementwise")),
    ("sort", ("sort",)),
    ("cumsum", ("scan",)),
    ("conv", ("conv",)),
    ("copy_cast", ("copy", "memcpy")),
)


def kernel_classes(prof, events: list | None = None) -> dict:
    """Device ms and launches of a profile's kernels by
    ``FAMILY_KERNEL_CLASSES`` (the rest as "other")."""
    out = {}
    for ms, name, calls in (device_events(prof) if events is None
                            else events):
        low = name.lower()
        cls = next((c for c, pats in FAMILY_KERNEL_CLASSES
                    if any(p in low for p in pats)), "other")
        ms0, n0 = out.get(cls, (0.0, 0))
        out[cls] = (ms0 + ms, n0 + calls)
    return {c: {"ms": ms, "calls": n} for c, (ms, n) in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def _family_check_cfg(full):
    """The family's check model: 2 layers at published widths (encdec 2 +
    2, deepseek its dense layer and one MoE layer), hybrid 4 in 2 chunks
    of 2 (the published chunk of 6 would take 12)."""
    import dataclasses
    if full.family == "encdec":
        return dataclasses.replace(full, n_enc_layers=2, n_dec_layers=2)
    if full.family == "hybrid":
        return dataclasses.replace(full, n_layers=4, attn_every=2)
    return dataclasses.replace(full, n_layers=2)


def family_checks(cuda, run: str, full) -> None:
    """Float32, TF32 off, the check model of ``_family_check_cfg``:
    (a) decode steps 1 and 8 against fresh prefills over the prompt (2 x
    256) and the tokens decoded before it, within ``FAMILY_DECODE_TOL`` of
    the largest logit; a moe model runs it at a capacity of every token
    (``capacity_factor`` E / k), since the capacity drops assignments by
    the batch's token count, which differs between a decode step and a
    prefill; (b) a prefill of a 2 x 64 prompt on the card against the same
    parameters on the CPU (plain versions), each MoE layer's expert ids
    equal first (a flip on a near-tie shows as a flip), then the logits
    within ``FAMILY_CPU_TOL``; encdec's logits and encoder output instead
    against a float64 CPU run, beside the card path run with the plain
    versions (``FAMILY_F64_FACTOR``)."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import nn as tnn
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _family_check_cfg(full)
    moe = cfg.family == "moe"
    cfg_d = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k) if moe else cfg)
    params = T.init_params(7, cfg, torch.float32, cuda)
    rng = np.random.default_rng(31)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 256),
                                           dtype=np.int32)).to(cuda)
    extra = {}
    if cfg.family == "encdec":
        extra["frontend"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_len, cfg.frontend_dim)
        ).astype(np.float32)).to(cuda)
    steps, results = (1, 8), []
    cache = T.init_cache(cfg_d, 2, 256 + max(steps) + 1, torch.float32, cuda)
    logits, cache = T.forward_prefill(params, {"tokens": prompt, **extra},
                                      cfg_d, cache)
    fed = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    for j in range(1, max(steps) + 1):
        dec, cache = T.forward_decode(params, fed[-1], cfg_d, cache)
        if j in steps:
            seq = torch.cat([prompt] + fed, dim=1)
            want, _ = T.forward_prefill(
                params, {"tokens": seq, **extra}, cfg_d,
                T.init_cache(cfg_d, 2, seq.shape[1], torch.float32, cuda))
            got, want = dec[:, -1], want[:, -1]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            results.append({"step": j, "prefill_len": seq.shape[1],
                            "max_abs_err": err, "max_abs_logit": scale,
                            "rel_err": err / scale,
                            "argmax_equal": bool(torch.equal(
                                got.argmax(-1), want.argmax(-1)))})
            if not torch.isfinite(got).all() or err > FAMILY_DECODE_TOL * scale:
                raise AssertionError(f"lm_families {run}: decode step {j} "
                                     f"differs from the prefill by {err} "
                                     f"(max |logit| {scale}, tolerance "
                                     f"{FAMILY_DECODE_TOL} of it)")
        fed.append(torch.argmax(dec[:, -1], -1).to(torch.int32)[:, None])
    emit({"phase": "lm_families", "what": "decode vs prefill", "run": run,
          "arch": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
          "config": _layer_shape(cfg), "batch": 2, "prompt_len": 256,
          "capacity_factor": cfg_d.capacity_factor if moe else None,
          "steps": results, "tolerance": FAMILY_DECODE_TOL})
    del cache, logits, dec

    # (b) card against CPU on a 2 x 64 prompt, the routing recorded
    real_moe, routed = tnn.moe, []

    def recording(p, x, cfg_):
        probs, _, ids = tnn.moe_route(p, x.reshape(-1, x.shape[-1]), cfg_)
        top = torch.sort(probs, dim=-1, descending=True).values
        routed.append((ids.cpu(), float((top[:, cfg_.top_k - 1]
                                         - top[:, cfg_.top_k]).min())))
        return real_moe(p, x, cfg_)

    short = {"tokens": prompt[:, :64], **extra}
    tnn.moe = recording
    try:
        got, got_cache = T.forward_prefill(params, short, cfg, T.init_cache(
            cfg, 2, 64, torch.float32, cuda))
        got = got.cpu()
        got_enc = got_cache["enc"].cpu() if "enc" in got_cache else None
        del got_cache
        if cfg.family == "encdec":  # the same card path, plain attention
            real_flash = ops.flash_attention
            ops.flash_attention = (lambda q, k, v, *, causal=True:
                                   kref.flash_attention_ref(q, k, v, causal))
            try:
                plain, plain_cache = T.forward_prefill(
                    params, short, cfg,
                    T.init_cache(cfg, 2, 64, torch.float32, cuda))
            finally:
                ops.flash_attention = real_flash
            plain, plain_enc = plain.cpu(), plain_cache["enc"].cpu()
            del plain_cache
        p_cpu = _to_device(params, "cpu")
        del params
        torch.cuda.empty_cache()
        short = _to_device(short, "cpu")
        want, want_cache = T.forward_prefill(
            p_cpu, short, cfg, T.init_cache(cfg, 2, 64, torch.float32, "cpu"))
    finally:
        tnn.moe = real_moe
    half = len(routed) // 2
    ids_equal = all(torch.equal(a[0], b[0])
                    for a, b in zip(routed[:half], routed[half:]))
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    row = {"phase": "lm_families", "what": "card vs cpu", "run": run,
           "arch": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
           "batch": 2, "prompt_len": 64, "moe_layers": half,
           "expert_ids_equal": ids_equal if moe else None,
           "min_top_k_margin": min((m for _, m in routed), default=None),
           "max_abs_err": err, "max_abs_logit": scale, "rel_err": err / scale,
           "rtol": FAMILY_CPU_TOL[0], "atol_rel": FAMILY_CPU_TOL[1]}
    if moe and not ids_equal:
        emit(row)
        raise AssertionError(f"lm_families {run}: the card's MoE routing "
                             "differs from the CPU's (a flip on a near-tie)")
    if cfg.family != "encdec":
        emit(row)
        torch.testing.assert_close(got, want, rtol=FAMILY_CPU_TOL[0],
                                   atol=FAMILY_CPU_TOL[1] * scale)
        return
    # encdec: the card's runs and the CPU's float32 run each against a
    # float64 CPU run, on the logits and the encoder's output
    want64, cache64 = T.forward_prefill(
        _to_device(p_cpu, torch.float64),
        {"tokens": short["tokens"], "frontend": short["frontend"].double()},
        cfg, T.init_cache(cfg, 2, 64, torch.float64, "cpu"))
    ok, row["vs_float64"] = True, {}
    for key, g, gp, w, w64 in (
            ("logits", got, plain, want, want64),
            ("enc", got_enc, plain_enc, want_cache["enc"], cache64["enc"])):
        sc = float(w64.abs().max())
        err_of = {name: float((t.double() - w64).abs().max())
                  for name, t in (("card", g), ("card_plain", gp),
                                  ("cpu", w))}
        row["vs_float64"][key] = {**{k: v / sc for k, v in err_of.items()},
                                  "max_abs": sc}
        ok &= (err_of["card"] <= FAMILY_F64_FACTOR * err_of["card_plain"]
               + FAMILY_CPU_TOL[1] * sc)
    row["f64_factor"] = FAMILY_F64_FACTOR
    emit(row)
    if not ok:
        raise AssertionError(f"lm_families {run}: with the kernel the card "
                             f"is further from a float64 run than "
                             f"{FAMILY_F64_FACTOR} x with the plain "
                             f"versions: {row['vs_float64']}")


def _layer_shape(cfg) -> dict:
    """The widths that set a family's layers (for the phase lines)."""
    keys = ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
            "n_layers", "n_enc_layers", "n_dec_layers", "n_dense_layers",
            "n_experts", "top_k", "n_shared_experts", "d_ff_expert",
            "kv_lora", "q_lora", "rope_dims", "ssm", "d_state", "d_conv",
            "expand", "ssm_heads", "attn_every", "frontend_len",
            "frontend_dim")
    return {k: getattr(cfg, k) for k in keys if getattr(cfg, k)}


def lm_families(cuda) -> list[dict]:
    """LM serving of the moe (GQA, MLA), ssm, hybrid and encdec families at
    published widths in bf16 on the card (``FAMILY_RUNS``): per run
    ``serve(arch, smoke=False)`` with 4 prompts of 2048 tokens and 32
    generated, cold then warm; the cold run's prefill under
    ``torch.profiler`` (device activity: ms by kernel and by
    ``FAMILY_KERNEL_CLASSES``, busy share of the profiled window, which
    the profiler's host work stretches; the warm row's
    ``device_busy_share_est`` divides the same device ms by the warm
    prefill's seconds).  A run
    whose depth is cut swaps its config module's ``CONFIG`` for
    ``dataclasses.replace(CONFIG, n_layers=...)`` while it runs, so the cut
    model too goes through ``serve`` (the registry reads the module).  The
    prefill and decode steps are wrapped to read the flash launches after
    the prefill, the logits' finiteness and the cache position; the path
    is unchanged.  Each run then goes through ``family_checks``.  Returns
    the warm runs' launch counts (main-path launches)."""
    import dataclasses
    import importlib
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import ARCHS
    t_phase = time.perf_counter()
    batch, prompt_len, gen = 4, 2048, 32
    step_lib = serve_mod.step_lib
    real_prefill, real_decode = (step_lib.make_prefill_step,
                                 step_lib.make_decode_step)
    seen = {}

    def prefill_maker(cfg_):
        step = real_prefill(cfg_)

        def run(params, batch_in, cache):
            prof = None
            if seen["profile"]:
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    logits, cache = step(params, batch_in, cache)
                    torch.cuda.synchronize()
                seen["prof_s"] = time.perf_counter() - t0
            else:
                logits, cache = step(params, batch_in, cache)
            seen.update(prof=prof, finite=bool(torch.isfinite(logits).all()),
                        prefill_flash=ops.launch_counts()["flash_attention"])
            return logits, cache
        return run

    def decode_maker(cfg_, **kw):
        step = real_decode(cfg_, **kw)

        def run(params, tokens, cache):
            nxt, cache = step(params, tokens, cache)
            seen["pos"] = cache["pos"]
            return nxt, cache
        return run

    out = []
    for run, arch, layers in FAMILY_RUNS:
        mod = importlib.import_module(ARCHS[arch])
        full = mod.CONFIG
        cfg = (full if layers is None
               else dataclasses.replace(full, n_layers=layers))
        depth = ((cfg.n_enc_layers, cfg.n_dec_layers)
                 if cfg.family == "encdec" else cfg.n_layers)
        reduced = (None if layers is None else
                   f"n_layers {full.n_layers} -> {layers}: "
                   f"{full.param_count() / 1e9:.1f} B parameters in bf16 "
                   f"do not fit one 80 GB card")
        mod.CONFIG = cfg
        step_lib.make_prefill_step = prefill_maker
        step_lib.make_decode_step = decode_maker
        try:
            for name in ("cold", "warm"):
                gc.collect()
                torch.cuda.empty_cache()
                ops.reset_launch_counts()
                seen.update(profile=name == "cold", pos=None)
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                tokens, st = serve_mod.serve(
                    arch, smoke=False, batch=batch, prompt_len=prompt_len,
                    gen=gen, dtype=torch.bfloat16)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = counts_now()
                toks = tokens.cpu()
                flash = counts["flash_attention"]
                row = {"phase": "lm_families", "what": "serve", "run": run,
                       "name": name, "arch": arch, "family": cfg.family,
                       "layers": depth, "reduced": reduced,
                       "config": _layer_shape(cfg),
                       "params": cfg.param_count(),
                       "active_params": cfg.active_param_count(),
                       "dtype": "bfloat16", "batch": batch,
                       "prompt_len": prompt_len, "gen": gen, **st,
                       "wall_s": wall,
                       "prefill_tok_s": batch * prompt_len / st["t_prefill_s"],
                       "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                          - held) / 1e9,
                       "held_before_gb": held / 1e9,
                       "flash_launches_prefill": seen["prefill_flash"],
                       "flash_launches_decode": flash - seen["prefill_flash"],
                       "flash_design": ops.flash_attention.route,
                       "logits_finite": seen["finite"],
                       "tokens_in_vocab": bool(
                           toks.shape == (batch, gen)
                           and toks.dtype == torch.int32
                           and int(toks.min()) >= 0
                           and int(toks.max()) < cfg.vocab),
                       "pos": seen["pos"],
                       "launches": {k: v for k, v in counts.items() if v}}
                if name == "cold":
                    row.update(profiled_prefill_s=seen["prof_s"],
                               kernel_classes=kernel_classes(seen["prof"]),
                               **device_breakdown(seen["prof"],
                                                  seen["prof_s"], top=10))
                    seen["prof"] = None
                    prefill_device_ms = row["device_ms"]
                else:  # the profiler's host work stretches its window
                    row["device_busy_share_est"] = (
                        prefill_device_ms / (st["t_prefill_s"] * 1e3))
                emit(row)
                want = FAMILY_FLASH[run]
                if (row["flash_launches_prefill"] != want
                        or row["flash_launches_decode"]
                        or (want and row["flash_design"] != "wgmma_tma")):
                    raise AssertionError(
                        f"lm_families {run}: flash_attention launched "
                        f"{row['flash_launches_prefill']} times in the "
                        f"prefill (want {want}) and "
                        f"{row['flash_launches_decode']} in the decode "
                        f"(want 0), the last through {row['flash_design']}")
                if not (row["logits_finite"] and row["tokens_in_vocab"]):
                    raise AssertionError(f"lm_families {run}: logits not "
                                         "finite or tokens out of the "
                                         "vocabulary")
                if seen["pos"] != prompt_len + gen - 1:
                    raise AssertionError(f"lm_families {run}: cache pos "
                                         f"{seen['pos']}, want "
                                         f"{prompt_len + gen - 1}")
                if name == "warm":
                    out.append(counts)
        finally:
            mod.CONFIG = full
            step_lib.make_prefill_step = real_prefill
            step_lib.make_decode_step = real_decode
        gc.collect()
        torch.cuda.empty_cache()
        family_checks(cuda, run, full)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "lm_families", "what": "total",
          "s": time.perf_counter() - t_phase})
    return out


# ---- training of the other families ----------------------------------------

def _spec_shapes(cfg) -> list[tuple[tuple, tuple]]:
    """(path, shape) of every parameter leaf of ``cfg``."""
    from repro_torch import pytree
    from repro_torch.models import transformer as T
    return [(path, leaf.shape) for path, leaf in pytree.leaves_with_paths(
        T.nn.map_specs(lambda s: s, T.model_specs(cfg)))]


def _cut_depth(full, layers: int):
    """``full`` at ``layers`` decoder layers: a moe model keeps its dense
    layers, a hybrid whole chunks, encdec ``layers`` encoder and as many
    decoder layers."""
    import dataclasses
    if full.family == "encdec":
        return dataclasses.replace(full, n_enc_layers=layers,
                                   n_dec_layers=layers)
    return dataclasses.replace(full, n_layers=layers)


def _depths(full) -> list[int]:
    """The depths a training run may cut ``full`` to, deepest first."""
    if full.family == "encdec":
        return list(range(full.n_enc_layers, 0, -1))
    if full.family == "hybrid":
        return list(range(full.n_layers, 0, -full.attn_every))
    return list(range(full.n_layers, full.n_dense_layers, -1))


def family_train_need(cfg, rows: int, seq: int, pb: int, adamw: bool) -> dict:
    """Bytes one training step of ``cfg`` needs on the card, by kind:
    ``params`` (``pb`` bytes each), ``grads`` (as many, plus the stacked
    layers' gradients once more while ``torch.unbind``'s backward stacks
    them), ``adamw`` (two float32 moments, 8 B a parameter, and the
    update's temporaries: ~2 GB of ``UPDATE_CHUNK`` slices and one
    float32 copy of the largest leaf squared by ``global_norm``),
    ``logits`` (4 float32 copies: the logits, logsumexp's backward, the
    label scatter, their sum; plus one in ``pb``), ``checkpoints`` (each
    remat unit's input), and ``layer``: the largest one layer's recompute
    and backward hold at once (the hybrid's unit is a whole chunk, whose
    Mamba-2 layers all keep their scan states ``h``).  The SSM scan's
    float32 (B, S, di, N) tensor X: Mamba-1 keeps 3 of them for the
    backward (decay, h, the drive's product) and holds ~7 more of one row
    group in its backward (the reverse scan's four buffers, its
    gradient, ``da``'s product, the drive's); Mamba-2 keeps h and ~5 of a
    group."""
    shapes = _spec_shapes(cfg)
    n = sum(int(np.prod(s)) for _, s in shapes)
    stacked = sum(int(np.prod(s)) for p, s in shapes
                  if p[0] in ("layers", "dense_layers", "enc_layers",
                              "dec_layers") and s[0] > 1)
    largest = max(int(np.prod(s)) for _, s in shapes)
    t = rows * seq
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    need = {"params": n * pb, "grads": (n + stacked) * pb,
            "adamw": (8 * n + (8 << 26) * 4 + 4 * largest) if adamw else 0,
            "logits": t * cfg.vocab * (16 + pb)}
    attn = rows * h * seq * seq * 4 * 4 + t * h * hd * pb * 8
    mlp = t * max(cfg.d_ff, 1) * pb * 6
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        from repro_torch.models import ssm
        x_total = t * cfg.d_inner * cfg.d_state * 4
        x_group = max(1, min(rows, ssm.SCAN_BYTES // (seq * cfg.d_inner
                                                      * cfg.d_state * 4)))
        x_group = x_group * seq * cfg.d_inner * cfg.d_state * 4
        inner = t * cfg.d_inner * pb * 12
        if fam == "ssm":
            layer = 3 * x_total + 7 * x_group + inner
            units = cfg.n_layers
        else:
            layer = (cfg.attn_every * (x_total + inner) + 5 * x_group
                     + attn + mlp)
            units = cfg.n_layers // cfg.attn_every
    elif fam == "encdec":
        layer = attn * 2 + mlp
        units = cfg.n_enc_layers + cfg.n_dec_layers + 1
    else:  # moe
        if cfg.mla:
            from repro_torch.models import nn as tnn
            r = rows if rows * h * seq * seq * 4 <= tnn.MLA_LOGIT_BYTES else 1
            attn = (rows * h * seq * seq * 4 + r * h * seq * seq * 4 * 3
                    + t * h * (hd + cfg.rope_dims) * pb * 8)
        e, k, fe = cfg.n_experts, cfg.top_k, cfg.d_ff_expert or cfg.d_ff
        cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 4)
        moe = (e * cap * (d + 3 * fe) * pb * 3 + t * k * d * pb * 4
               + t * k * e * 4 * 3 + t * fe * cfg.n_shared_experts * pb * 6)
        layer = attn + max(moe, mlp if cfg.n_dense_layers else 0)
        units = cfg.n_layers
    need["checkpoints"] = units * t * d * pb
    need["layer"] = layer
    need["total"] = sum(need.values())
    return need


def family_train_plan(full, free_bytes: int, max_layers: int | None) -> dict:
    """The full-width training run of ``full`` that fits
    ``FAMILY_TRAIN_BUDGET`` of ``free_bytes`` (``family_train_need``):
    the first mode of AdamW in float32, AdamW with bf16 parameters
    (float32 moments), ``value_and_grad`` alone in float32 whose
    shallowest model fits at 4, 2 or 1 rows of ``FAMILY_TRAIN_SEQ``
    tokens, the most rows first (seamless, whose depth is kept, at the
    rows where its full depth fits); then the deepest model at those rows,
    at most ``max_layers`` deep (the phase's time).  Every cut is named in
    ``reduced``."""
    budget = FAMILY_TRAIN_BUDGET * free_bytes
    depths = _depths(full)
    keep_depth = full.family == "encdec"
    modes = (("adamw", torch.float32, 4), ("adamw", torch.bfloat16, 2),
             ("value_and_grad", torch.float32, 4))
    for mode, dtype, pb in modes:
        for rows in (4, 2, 1):
            seq = FAMILY_TRAIN_SEQ
            fits = [dep for dep in depths if family_train_need(
                _cut_depth(full, dep), rows, seq, pb,
                mode == "adamw")["total"] <= budget]
            if not fits or (keep_depth and fits[0] != depths[0]):
                continue
            depth = fits[0]
            if max_layers is not None and depth > max_layers:
                depth = max(dep for dep in fits if dep <= max_layers)
            cfg = _cut_depth(full, depth)
            need = family_train_need(cfg, rows, seq, pb, mode == "adamw")
            reduced = []
            full_depth = depths[0]
            if depth != full_depth:
                why = ("the phase's time" if depth < fits[0] else
                       f"{FAMILY_TRAIN_BUDGET} of the {free_bytes / 1e9:.1f} "
                       f"GB free")
                reduced.append(f"layers {full_depth} -> {depth} ({why}; "
                               f"{cfg.param_count() / 1e9:.2f} of "
                               f"{full.param_count() / 1e9:.1f} B parameters)")
            if rows != 4:
                reduced.append(f"batch 4 x {seq} -> {rows} x {seq} tokens "
                               "(memory)")
            if dtype != torch.float32:
                reduced.append("bf16 parameters (float32 moments): float32 "
                               "AdamW does not fit")
            if mode != "adamw":
                reduced.append("value_and_grad alone, no AdamW update: "
                               "float32 or bf16 AdamW state does not fit")
            return {"cfg": cfg, "rows": rows, "seq": seq, "dtype": dtype,
                    "mode": mode, "need": need, "reduced": reduced,
                    "budget_gb": budget / 1e9}
    raise AssertionError(f"lm_families_train: {full.name} does not fit "
                         f"{budget / 1e9:.1f} GB in any mode")


def backward_split(prof) -> dict:
    """Device ms of a profiled step's backward (the autograd engine's
    top-level ``evaluate_function`` events, with the remat recompute run
    inside them) and of the scan's reverse scans (``SSMScanBackward``)
    within it; needs the profile's CPU activity."""
    mark = "autograd::engine::evaluate_function:"
    total = scan = 0.0
    for e in prof.events():
        if not e.name.startswith(mark):
            continue
        par = e.cpu_parent
        while par is not None and not par.name.startswith(mark):
            par = par.cpu_parent
        if par is not None:
            continue
        us = e.device_time_total
        total += us
        if "SSMScanBackward" in e.name:
            scan += us
    return {"backward_device_ms": total / 1e3, "scan_backward_ms": scan / 1e3,
            "scan_share_of_backward": scan / total if total else None}


def _grad_zeros(grads, assigned: dict | None, n_moe: int) -> dict:
    """Which gradient leaves are all zero; for the MoE expert weights,
    which (layer, expert) slices, those of an expert that received no
    assignment in that layer (``assigned``: layer -> expert ids) exempt.
    (A non-finite gradient shows in the step's gradient norm.)"""
    from repro_torch import pytree
    inf = float("inf")
    zero_leaves, bad_slices, exempt = [], [], 0
    for path, g in pytree.leaves_with_paths(grads):
        name = "/".join(path)
        if path[:2] == ("layers", "moe") and path[2] in ("w_gate", "w_up",
                                                         "w_down"):
            zs = (torch.linalg.vector_norm(g.flatten(2), inf, dim=-1)
                  == 0).cpu()                               # (L, E)
            for layer, expert in zs.nonzero().tolist():
                if layer < n_moe and expert not in assigned.get(layer, ()):
                    exempt += 1
                else:
                    bad_slices.append(f"{name}[{layer}, {expert}]")
            if bool(zs.all()):
                zero_leaves.append(name)
        elif float(torch.linalg.vector_norm(g, inf)) == 0:
            zero_leaves.append(name)
    return {"zero_leaves": zero_leaves, "zero_assigned_expert_slices":
            bad_slices, "exempt_expert_slices": exempt}


def _record_routing():
    """A wrapper of ``nn.moe_route`` that records each call's expert ids
    (the path is unchanged) and the list it records into."""
    from repro_torch.models import nn as tnn
    real, calls = tnn.moe_route, []

    def recording(p, xt, cfg_):
        probs, vals, ids = real(p, xt, cfg_)
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        calls.append((ids.cpu(), float(
            (top[:, cfg_.top_k - 1] - top[:, cfg_.top_k]).min())))
        return probs, vals, ids
    return real, recording, calls


def _condition_attention(params) -> None:
    """Scale the GQA attention's ``wq`` and ``wk`` (self and cross) in
    place from ``init_params``' 1/sqrt(heads) (a 3-D weight's fan-in is
    taken from its head axis, as in the JAX package) to 1/sqrt(d_model),
    their input width: q and k entries of std ~1 instead of ~8, so the
    scores are not near one-hot (``FAMILY_TRAIN_LOSS_RTOL``'s note).
    MLA's projections keep their init."""
    from repro_torch import pytree
    for path, leaf in pytree.leaves_with_paths(params):
        if path[-2:-1] in (("attn",), ("xattn",)) and path[-1] in ("wq", "wk"):
            leaf.mul_(float(np.sqrt(leaf.shape[-2] / leaf.shape[-3])))


def family_train_check(cuda, run: str, full) -> dict:
    """The loss and every gradient leaf of ``value_and_grad(make_loss_fn)``
    on the check model of ``_family_check_cfg`` (2 layers at published
    widths, hybrid 4 in 2 chunks; its GQA attention conditioned by
    ``_condition_attention``), 2 x 64 tokens from
    ``registry.concrete_inputs``, float32 and TF32 off, on the card
    against the same parameters on the CPU (plain versions): each MoE
    layer's expert ids equal first, no ``flash_attention`` launch on the
    card, then the loss within ``FAMILY_TRAIN_LOSS_RTOL`` and each leaf
    within ``FAMILY_TRAIN_GRAD_ATOL`` of its largest CPU entry (the CPU
    tests' tolerances)."""
    from repro_torch import pytree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import nn as tnn
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import concrete_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = _family_check_cfg(full)
    batch = concrete_inputs(cfg, ShapeConfig("check", "train", 64, 2),
                            seed=31, device="cpu")
    grad_fn = step_lib.value_and_grad(step_lib.make_loss_fn(cfg))
    params = T.init_params(7, cfg, torch.float32, cuda)
    _condition_attention(params)
    real, recording, routed = _record_routing()
    seconds = {}
    tnn.moe_route = recording
    try:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        loss_card, grads_card = grad_fn(params, _to_device(batch, cuda))
        torch.cuda.synchronize()
        seconds["card"] = time.perf_counter() - t1
        flash = ops.launch_counts()["flash_attention"]
        p_cpu = _to_device(params, "cpu")
        del params
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        loss_cpu, grads_cpu = grad_fn(p_cpu, batch)
        seconds["cpu"] = time.perf_counter() - t1
        del p_cpu
    finally:
        tnn.moe_route = real
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
    half = len(routed) // 2  # each run: its forward's calls, then remat's
    ids_equal = all(torch.equal(a, b) for (a, _), (b, _) in
                    zip(routed[:n_moe], routed[half:half + n_moe]))
    t1 = time.perf_counter()
    worst, worst_leaf = 0.0, None
    for (path, g), w in zip(pytree.leaves_with_paths(grads_card),
                            pytree.leaves(grads_cpu)):
        w = w.to(cuda)  # compared on the card, a leaf at a time
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        share = err / scale if scale else (0.0 if err == 0 else float("inf"))
        if share > worst:
            worst, worst_leaf = share, "/".join(path)
    seconds["compare"] = time.perf_counter() - t1
    lc, lcpu = float(loss_card), float(loss_cpu)
    loss_err = abs(lc - lcpu) / abs(lcpu)
    row = {"phase": "lm_families_train", "what": "card vs cpu", "run": run,
           "arch": cfg.name, "dtype": "float32", "layers": _layer_shape(cfg),
           "batch": 2, "seq": 64, "loss_card": lc, "loss_cpu": lcpu,
           "loss_rel_err": loss_err, "worst_grad_share": worst,
           "worst_grad_leaf": worst_leaf, "moe_layers": n_moe,
           "expert_ids_equal": ids_equal if n_moe else None,
           "min_top_k_margin": min((m for _, m in routed), default=None),
           "flash_launches": flash, "loss_rtol": FAMILY_TRAIN_LOSS_RTOL,
           "grad_atol_share": FAMILY_TRAIN_GRAD_ATOL, "seconds": seconds,
           "s": time.perf_counter() - t0}
    emit(row)
    if flash:
        raise AssertionError(f"lm_families_train {run}: training launched "
                             "flash_attention")
    if n_moe and not ids_equal:
        raise AssertionError(f"lm_families_train {run}: the card's MoE "
                             "routing differs from the CPU's")
    if not (loss_err <= FAMILY_TRAIN_LOSS_RTOL
            and worst <= FAMILY_TRAIN_GRAD_ATOL):
        raise AssertionError(f"lm_families_train {run}: card against CPU "
                             f"loss {loss_err} (rtol {FAMILY_TRAIN_LOSS_RTOL}),"
                             f" gradient {worst_leaf} {worst} of its largest "
                             f"entry (tolerance {FAMILY_TRAIN_GRAD_ATOL})")
    return row


def lm_families_train(cuda) -> list[dict]:
    """Training of the moe (GQA, MLA), ssm, hybrid and encdec families at
    published widths on the card (``FAMILY_TRAIN_RUNS``), TF32 off: per
    run the plan of ``family_train_plan`` (depth, rows and mode from the
    memory reckoning; every cut in ``reduced``), parameters from
    ``init_params``, batches from ``registry.concrete_inputs``, and
    ``make_train_step(donate=True)`` (AdamW) or ``value_and_grad`` alone:
    a warm-up step, 2 timed between two synchronizes, one under
    ``torch.profiler`` (CPU and CUDA activity: kernel classes, top
    kernels, the backward's device ms and the scan's reverse scans'
    share of it).  The warm-up step's gradients are read (through a
    wrapper of ``adamw.update``; the path is unchanged): none may be
    non-finite or all zero; an expert's slice may be zero only if the
    router gave it no assignment in that layer (counted).  Launch counts
    from 0 before each run: no ``flash_attention``.  Then
    ``family_train_check``.  Returns each run's launch counts."""
    import importlib
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import nn as tnn
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import ARCHS, concrete_inputs
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = []
    for run, arch, max_layers in FAMILY_TRAIN_RUNS:
        t_run = time.perf_counter()
        full = importlib.import_module(ARCHS[arch]).CONFIG
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        free = torch.cuda.mem_get_info()[0]
        plan = family_train_plan(full, free, max_layers)
        seconds = {"plan": time.perf_counter() - t_run}
        cfg, rows, seq = plan["cfg"], plan["rows"], plan["seq"]
        n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(11, cfg, plan["dtype"], cuda)
        shape = ShapeConfig("train", "train", seq, rows)
        batches = [concrete_inputs(cfg, shape, seed=i, dtype=plan["dtype"],
                                   device=cuda) for i in range(4)]
        if plan["mode"] == "adamw":
            opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=10,
                                        warmup_steps=2)
            opt_state = adamw.init(params)
            train_step = step_lib.make_train_step(cfg, opt_cfg, donate=True)

            def step(batch):
                _, _, m = train_step(params, opt_state, batch)
                return m["loss"], m["grad_norm"]
        else:
            grad_fn = step_lib.value_and_grad(step_lib.make_loss_fn(cfg))

            def step(batch):
                loss, grads = grad_fn(params, batch)
                return loss, adamw.global_norm(grads)
        seen, per_step = {}, []
        real_update = adamw.update
        real_route, recording, routed = _record_routing()

        def reading(opt_cfg_, grads, state, params_, **kw):
            seen["grads"] = _zero_report(grads)
            return real_update(opt_cfg_, grads, state, params_, **kw)

        def _zero_report(grads):
            assigned = {i: set(ids.unique().tolist())
                        for i, (ids, _) in enumerate(routed[:n_moe])}
            return _grad_zeros(grads, assigned, n_moe)

        # the warm-up step, its gradients read
        t0 = time.perf_counter()
        seconds["init"] = t0 - t_run - seconds["plan"]
        adamw.update, tnn.moe_route = reading, recording
        try:
            if plan["mode"] == "adamw":
                loss, gnorm = step(batches[0])
            else:
                loss, grads = grad_fn(params, batches[0])
                gnorm = adamw.global_norm(grads)
                seen["grads"] = _zero_report(grads)
                del grads
            torch.cuda.synchronize()
        finally:
            adamw.update, tnn.moe_route = real_update, real_route
        per_step.append({"s": time.perf_counter() - t0, "warm_up": True,
                         "loss": float(loss), "grad_norm": float(gnorm)})
        for batch in batches[1:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, gnorm = step(batch)
            torch.cuda.synchronize()
            per_step.append({"s": time.perf_counter() - t0,
                             "loss": float(loss), "grad_norm": float(gnorm)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss, gnorm = step(batches[3])
            torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        per_step.append({"profiled": True, "loss": float(loss),
                         "grad_norm": float(gnorm)})
        peak = torch.cuda.max_memory_allocated() - held
        counts = counts_now()
        step_s = float(np.median([r["s"] for r in per_step[1:3]]))
        t0 = time.perf_counter()
        events = device_events(prof)
        brk = device_breakdown(prof, prof_s, top=10, events=events)
        row = {"phase": "lm_families_train", "what": "train", "run": run,
               "arch": arch, "family": cfg.family, "mode": plan["mode"],
               "dtype": str(plan["dtype"]).split(".")[1],
               "config": _layer_shape(cfg), "params": cfg.param_count(),
               "reduced": plan["reduced"] or None, "batch": rows, "seq": seq,
               "tokens": rows * seq, "per_step": per_step,
               "step_s": step_s, "tokens_per_s": rows * seq / step_s,
               "peak_memory_gb": peak / 1e9, "held_before_gb": held / 1e9,
               "free_before_gb": free / 1e9,
               "predicted_gb": {k: v / 1e9 for k, v in plan["need"].items()},
               "budget_gb": plan["budget_gb"],
               "profiled_step_s": prof_s, **brk,
               "device_busy_share_est": brk["device_ms"] / (step_s * 1e3),
               "kernel_classes": kernel_classes(prof, events),
               **backward_split(prof),
               "seconds": {**seconds, "profile_read": time.perf_counter() - t0},
               **seen["grads"], "flash_launches": counts["flash_attention"],
               "launches": {k: v for k, v in counts.items() if v}}
        emit(row)
        del prof, params, batches, step
        if plan["mode"] == "adamw":
            del opt_state, train_step
        gc.collect()
        torch.cuda.empty_cache()
        if not all(np.isfinite([r[k] for r in per_step
                                for k in ("loss", "grad_norm")])):
            raise AssertionError(f"lm_families_train {run}: a loss or "
                                 "gradient norm is not finite")
        if counts["flash_attention"]:
            raise AssertionError(f"lm_families_train {run}: training "
                                 "launched flash_attention")
        if row["zero_leaves"] or row["zero_assigned_expert_slices"]:
            raise AssertionError(f"lm_families_train {run}: all-zero "
                                 f"gradients {row['zero_leaves']} "
                                 f"{row['zero_assigned_expert_slices'][:8]}")
        out.append(counts)
        family_train_check(cuda, run, full)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "lm_families_train", "what": "run total", "run": run,
              "s": time.perf_counter() - t_run})
    emit({"phase": "lm_families_train", "what": "total",
          "s": time.perf_counter() - t_phase, "card": nvidia_smi()})
    return out


def _slice_tree(tree, n: int):
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    return {k: _slice_tree(v, n) for k, v in tree.items()}


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


# ---- the dry run ------------------------------------------------------------

# (a) the dry run's cells, traced in a process of their own (its fake
# process group stays out of this one), then (c)'s (1, 1) count
DRYRUN_OUT = ROOT / "build" / "dryrun" / "smoke.json"
DRYRUN_PREFILL = (4, 2048)  # (c): qwen3-1.7b prefill rows x tokens, bf16
DRYRUN_SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{src!r}]
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import get_config
out = {out!r}
t0 = time.perf_counter()
D.main(["--arch", "era", "--multi-pod", "both", "--out", out])
D.main(["--arch", "era-packed", "--multi-pod", "both", "--out", out])
D.main(["--arch", "qwen3-1.7b", "--multi-pod", "off", "--out", out])
b, s = {prefill!r}
dev = D.fake_device("cuda")
with M.fake_world(1):
    mesh = M.make_host_mesh(device=dev)
    fn, args, in_sh, _, _ = D.build_cell(
        get_config("qwen3-1.7b"), ShapeConfig("prefill_4x2048", "prefill", s, b),
        mesh)
    counts, mem, t = D.trace_cell(fn, args, in_sh, mesh, dev)
print(json.dumps({{"flops": counts.flops, "memory": mem, "device": dev.type,
                  "collectives": len(counts.collectives),
                  "kernels": D._kernel_ops(counts),
                  "seconds": time.perf_counter() - t0}}))
"""


def start_dryrun() -> subprocess.Popen:
    """Start (a) and (c)'s trace in a subprocess (it traces fake tensors
    on the host, about a minute) that runs beside (b) and (c)'s card runs,
    whose figures are device event times, FLOP counts and peaks, no host
    time; its output goes to files beside ``DRYRUN_OUT``, and it is killed
    at exit if it is still running."""
    import atexit

    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    code = DRYRUN_SCRIPT.format(src=str(ROOT / "src"), out=str(DRYRUN_OUT),
                                prefill=DRYRUN_PREFILL)
    with open(DRYRUN_OUT.with_suffix(".out"), "w") as out, \
            open(DRYRUN_OUT.with_suffix(".err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=out, stderr=err)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def _era_card_run(cuda, packed: bool) -> tuple[dict, dict]:
    """(b): one ``era_prepare_batch`` step of the ERA dry-run cell's
    per-device program on the card, at the cell's size: a 2.1 G-symbol
    random DNA text (the 2-bit words, or the byte string) and one virtual
    tree of F = 2^20 leaves, all of them in one active area."""
    from repro_torch.core.packing import PackedText
    from repro_torch.core.prepare import PrepareState
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.era_run import era_prepare_batch

    n, f, w = D.ERA_GENOME_N, D.ERA_F_M, D.ERA_RANGE_W
    gen = torch.Generator(device=cuda).manual_seed(7)
    if packed:  # 16 random 2-bit symbols a word: uniform random words
        n_words = n // 16
        text = PackedText(torch.randint(-2**31, 2**31, (n_words,),
                                        dtype=torch.int32, device=cuda,
                                        generator=gen),
                          16 * (n_words - 1) - w, 2, 4)
        n_real = text.n_real
    else:
        text = torch.randint(0, 4, (n,), dtype=torch.uint8, device=cuda,
                             generator=gen)
        n_real = n - w
    L = torch.randint(0, n_real, (1, f), dtype=torch.int32, device=cuda,
                      generator=gen)
    zeros = torch.zeros((1, f), dtype=torch.int32, device=cuda)
    state = PrepareState(L=L, start=zeros, area=zeros.clone(),
                         b_off=torch.full_like(zeros, -1), b_c1=zeros.clone(),
                         b_c2=zeros.clone())
    step = lambda: era_prepare_batch(text, state, w=w)
    step()  # warm
    torch.cuda.synchronize(cuda)
    held = torch.cuda.memory_allocated(cuda)  # with earlier phases' memory
    args = ((text.words if packed else text).nbytes
            + sum(t.nbytes for t in state))  # the cell's argument bytes
    torch.cuda.reset_peak_memory_stats(cuda)
    ops.reset_launch_counts()
    step()
    torch.cuda.synchronize(cuda)
    counts = counts_now()
    peak_above = torch.cuda.max_memory_allocated(cuda) - held
    name = "range_gather_words" if packed else "range_gather_pack"
    kernels = (name,) if packed else (name, "lcp_pairs")
    arch = "era-genome" + ("-packed" if packed else "")
    require_launches(counts, kernels, f"the ERA dry-run cell ({arch})")
    row = {"arch": arch, "ms": cuda_ms(step, reps=5),
           "argument_bytes": args, "peak_above_resident": peak_above,
           "card_peak_bytes": args + peak_above,
           "launches": {k: counts[k] for k in kernels}}
    del text, state, L, zeros
    gc.collect()
    torch.cuda.empty_cache()
    return row, counts


def custom_op_overhead(cuda, calls: int = 2000) -> dict:
    """Host microseconds a call of each custom op on the dry run's path
    (``torch.ops.repro_torch.*``) adds to its plain launch function (the
    op's CUDA implementation, called directly): one-row (one-token)
    inputs, ``calls`` calls each, in turns (op, launch, launch, op), the
    card synchronised after each run of calls."""
    from repro_torch.core.packing import PackedText
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lcp, packed_gather as pg, range_gather

    words = torch.zeros(64, dtype=torch.int32, device=cuda)
    text = torch.zeros(64, dtype=torch.uint8, device=cuda)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    rows = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16, device=cuda)
    pt = PackedText(words, 100, 2, 4)
    ops_ = torch.ops.repro_torch
    cases = {
        "range_gather_words": (ops_.range_gather_words,
                               pg._range_gather_words_impl,
                               (words, offs, 16, 2, pt.n_real, 4, None)),
        "range_gather_packed": (ops_.range_gather_packed,
                                pg._range_gather_packed_impl,
                                (words, offs, 4, 2, pt.n_real, 4, None)),
        "range_gather_pack": (ops_.range_gather_pack,
                              range_gather._range_gather_pack_impl,
                              (text, offs, 4, None)),
        "lcp_pairs": (ops_.lcp_pairs, lcp._lcp_pairs_impl, (rows, rows, 16)),
        "flash_attention": (ops_.flash_attention, fa._flash_attention_impl,
                            (q, q, q, True)),
    }

    def run(fn, args) -> float:
        torch.cuda.synchronize(cuda)
        t = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize(cuda)
        return (time.perf_counter() - t) / calls * 1e6

    out = {}
    for name, (op, launch, args) in cases.items():
        run(op, args), run(launch, args)  # warm
        t_op = [run(op, args)]
        t_launch = [run(launch, args), run(launch, args)]
        t_op.append(run(op, args))
        out[name] = {"op_us": float(np.mean(t_op)),
                     "launch_us": float(np.mean(t_launch)),
                     "overhead_us": float(np.mean(t_op) - np.mean(t_launch))}
    emit({"phase": "custom_op_overhead", "calls": calls, "ops": out})
    return out


def dryrun_phase(cuda) -> list[dict]:
    """The dry run (``repro_torch.launch.dryrun``):

    (a) records traced in a subprocess — the two ERA cells on both
        production meshes, qwen3-1.7b at the four shapes on 16x16:
        status, peak per device, the three roofline terms, bottleneck
        and collectives; any status but ``ok`` fails (``skipped`` only
        where JAX's ``cell_is_runnable`` skips), and so does a collective
        in an ERA cell;
    (b) each ERA cell's per-device program on the card at the cell's
        size, its event ms beside the cell's roofline step time and its
        peak beside the dry run's estimate, the gathers' launches
        required;
    (c) qwen3-1.7b prefill at 4 x 2048 in bf16: the (1, 1) dry run's
        FLOPs equal ``FlopCounterMode``'s count of the real run on the
        card, and its peak estimate is within 0.5-2x of the card's peak.
    The subprocess of :func:`start_dryrun` starts after the custom ops'
    host timing and the LM phases.  Returns the launch counts of (b)'s
    and (c)'s counted runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config

    t0 = time.perf_counter()
    custom_op_overhead(cuda)
    proc = start_dryrun()
    paths, era_runs = [], []
    for packed in (True, False):
        run, counts = _era_card_run(cuda, packed)
        era_runs.append(run)
        paths.append(counts)

    # (c) the real prefill on the card, counted
    cfg = get_config("qwen3-1.7b")
    b, s = DRYRUN_PREFILL
    params = T.init_params(0, cfg, torch.bfloat16, cuda)
    cache = T.init_cache(cfg, b, s, torch.bfloat16, cuda)
    tokens = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32,
                           device=cuda, generator=torch.Generator(
                               device=cuda).manual_seed(3))
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    resident = sum(t.nbytes for t in (*[v for v in cache.values()
                                        if isinstance(v, torch.Tensor)],
                                      tokens, *_leaves(params)))
    torch.cuda.reset_peak_memory_stats(cuda)
    ops.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        logits, cache = step_lib.make_prefill_step(cfg)(
            params, {"tokens": tokens}, cache)
    torch.cuda.synchronize(cuda)
    counts = counts_now()
    paths.append(counts)
    require_launches(counts, ("flash_attention",), "the (1, 1) prefill")
    card_peak = resident + torch.cuda.max_memory_allocated(cuda) - base
    card_flops = fc.get_total_flops()
    finite = bool(torch.isfinite(logits.float()).all())
    del params, cache, tokens, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the subprocess's records
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError("the dry run failed: " + DRYRUN_OUT.with_suffix(
            ".err").read_text()[-3000:])
    traced = json.loads(DRYRUN_OUT.with_suffix(".out").read_text()
                        .strip().splitlines()[-1])
    recs = json.loads(DRYRUN_OUT.read_text())
    cells = []
    for r in recs:
        line = {k: r.get(k) for k in ("arch", "shape", "mesh", "status",
                                      "reason", "error", "t_trace_s",
                                      "kernels")}
        if r["status"] == "ok":
            t = r["roofline"]
            line.update(
                peak_per_device_bytes=r["memory"]["peak_estimate_bytes"],
                t_compute_s=t["t_compute_s"], t_memory_s=t["t_memory_s"],
                t_collective_s=t["t_collective_s"],
                bottleneck=t["bottleneck"],
                collectives=r["collectives"]["counts"])
        cells.append(line)
    emit({"phase": "dryrun", "cells": cells, "device": traced["device"],
          "subprocess_s": traced["seconds"],
          "waited_s": time.perf_counter() - t_wait})
    for r in recs:
        if r["status"] == "skipped" and r["arch"] == "qwen3-1.7b" \
                and r["shape"] == "long_500k":
            continue  # JAX's cell_is_runnable: a full-attention arch
        if r["status"] != "ok":
            raise AssertionError(f"dry-run cell {r['arch']} x {r['shape']} "
                                 f"x {r['mesh']}: {r['status']} "
                                 f"{r.get('error', r.get('reason'))}")
        if r["arch"].startswith("era") and r["collectives"]["counts"]:
            raise AssertionError(f"{r['arch']} x {r['mesh']}: collectives "
                                 f"{r['collectives']['counts']}")
    if len(recs) != 8:
        raise AssertionError(f"the dry run wrote {len(recs)} records, not 8")

    # (b) beside the cells' estimates
    by_key = {(r["arch"], r["mesh"]): r for r in recs}
    for run in era_runs:
        cell = by_key[(run["arch"], "16x16")]
        r = cell["roofline"]
        run.update(
            roofline_step_ms=1e3 * max(r["t_compute_s"], r["t_memory_s"],
                                       r["t_collective_s"]),
            dryrun_peak_estimate_bytes=cell["memory"]["peak_estimate_bytes"],
            dryrun_temp_bytes=cell["memory"]["temp_bytes"],
            dryrun_kernels=cell["kernels"])
    emit({"phase": "dryrun_era_card", "runs": era_runs})

    # (c) beside the (1, 1) trace
    est = traced["memory"]["peak_estimate_bytes"]
    line = {"phase": "dryrun_flops_card", "rows": b, "tokens": s,
            "dryrun_flops": traced["flops"], "card_flops": card_flops,
            "dryrun_memory": traced["memory"], "card_resident_bytes": resident,
            "card_peak_bytes": card_peak, "peak_ratio": est / card_peak,
            "dryrun_kernels": traced["kernels"],
            "dryrun_collectives": traced["collectives"],
            "flash_launches": counts["flash_attention"],
            "logits_finite": finite, "phase_s": time.perf_counter() - t0}
    emit(line)
    if line["dryrun_flops"] != line["card_flops"]:
        raise AssertionError(f"dry-run FLOPs {line['dryrun_flops']} != "
                             f"the card's {line['card_flops']}")
    if not 0.5 <= line["peak_ratio"] <= 2.0 or not finite:
        raise AssertionError(f"dry-run peak {est} against the card's "
                             f"{card_peak}: {line['peak_ratio']:.3f}")
    return paths


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---- the flight recorder ----------------------------------------------------

def trace_phase(n_log2: int, cfg, sync_free_server) -> dict:
    """The recorder on the card (``benchmarks/trace_smoke.py``'s checks):
    with ``repro_torch.obs`` on and empty before anything is built,
    ``build_stream`` of the genome at 2^min(22, n_log2) in >= 4 chunks,
    ``build_sharded`` at 2^min(20, n_log2) over ``[cuda:0] * 2`` with one
    ``find_batch`` and one ``find_fetch_batch`` of 256 patterns, then the
    hot serving workload: a warm-up through ``sync_free_server`` (every
    dispatch sync-free, one search launch a batch) and TRACE_TIMED timed
    ``run_closed_loop`` passes with the recorder on and off in turns, the
    best of each.  The trace and metrics go to build/trace/; the trace must
    be valid, hold the required spans (and the shards' process tracks),
    every dispatch's link must join a queue wait, the needles must be in
    the metrics, every dispatch must be ``impl="cuda"`` and each label's
    count equal the launches of its kernels while the recorder was on,
    and qps_on >= TRACE_QPS_FLOOR x qps_off.  Returns the launch counts of
    the recorded window (the path's)."""
    from repro_torch import obs
    from repro_torch.core import iomodel
    from repro_torch.core.api import EraIndexer
    from repro_torch.data.strings import dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.query_serve import make_workload
    from repro_torch.launch.serving import (
        ServeConfig,
        make_hot_workload,
        run_closed_loop,
    )
    t_phase = time.perf_counter()
    s, ax = dataset("genome", 1 << min(TRACE_LOG2, n_log2), seed=0)
    s_fab, _ = dataset("genome", 1 << min(TRACE_FABRIC_LOG2, n_log2), seed=0)
    ix = EraIndexer(ax, cfg)
    groups = ix.partition(s)  # sizes the budget; not recorded
    budget = (len(groups) * iomodel.state_bytes_per_group(ix._capacity(groups))
              // 4)
    del groups
    torch.cuda.synchronize()

    obs.configure(trace=True, metrics_on=True, clear=True)
    ops.reset_launch_counts()
    off = {k: 0 for k in ops.KERNELS}  # launches with the recorder off
    try:
        t0 = time.perf_counter()
        dev, srep = ix.build_stream(s, device_budget=budget)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        if srep.n_chunks < 4:
            raise AssertionError(f"trace: build_stream ran {srep.n_chunks} "
                                 f"chunks, not >= 4")
        s_dev = torch.from_numpy(np.asarray(s)).to("cuda")
        rng = np.random.default_rng(41)
        check = check_index(dev, s, s_dev, make_workload(
            s, rng, batch=64, min_len=4, max_len=24, planted_frac=0.7,
            n_symbols=len(ax.symbols)), "trace build_stream")
        del s_dev
        mesh = [torch.device("cuda", 0)] * TRACE_MESH
        sh = ix.build_sharded(s_fab, n_shards=TRACE_MESH, mesh=mesh)
        pats = make_workload(s_fab, rng, batch=256, min_len=4, max_len=24,
                             planted_frac=0.7, n_symbols=len(ax.symbols))
        one = EraIndexer(ax, cfg).build_device(s_fab)
        for a, b in zip(sh.find_batch(pats), one.find_batch(pats)):
            if not np.array_equal(a, b):
                raise AssertionError("trace: the sharded find differs")
        (pos, win), (pos1, win1) = (sh.find_fetch_batch(pats, fetch=FETCH),
                                    one.find_fetch_batch(pats, fetch=FETCH))
        if not (np.array_equal(win, win1)
                and all(np.array_equal(a, b) for a, b in zip(pos, pos1))):
            raise AssertionError("trace: the sharded find-and-fetch differs")
        del sh, one, pos, win, pos1, win1

        hot = make_hot_workload(s, np.random.default_rng(29),
                                n_requests=SERVE_REQUESTS, hot_pool=32,
                                hot_frac=0.8, min_len=4, max_len=24,
                                n_symbols=len(ax.symbols))
        serve_cfg = ServeConfig(pipeline=True, cache_size=TRACE_CACHE,
                                max_batch=256)
        uniq = {}
        for p in hot:
            uniq.setdefault(p.tobytes(), p)
        want = dict(zip(uniq, dev.find_batch(list(uniq.values()))))

        def same(res, what: str) -> None:
            seen = set()
            for p, (got_pos, _) in zip(hot, res):
                key = (id(got_pos), p.tobytes())
                if key not in seen:
                    seen.add(key)
                    if not np.array_equal(got_pos, want[key[1]]):
                        raise AssertionError(f"trace: a served result "
                                             f"differs from find_batch "
                                             f"({what})")

        warm = sync_free_server(dev, serve_cfg, kernel="search_bounds_words")
        same(warm.serve(hot), "warm-up")
        del warm
        qps = {"on": [], "off": []}
        for _ in range(TRACE_TIMED):
            for arm in ("on", "off"):
                obs.configure(trace=arm == "on", metrics_on=arm == "on")
                before = ops.launch_counts()
                res, st = run_closed_loop(dev, hot, serve_cfg)
                torch.cuda.synchronize()
                if arm == "off":
                    for k, v in ops.launch_counts().items():
                        off[k] += v - before[k]
                same(res, f"recorder {arm}")
                del res
                qps[arm].append(st["qps"])
        obs.configure(trace=True, metrics_on=True)
        got = counts_now()
        recorded = {k: got[k] - off[k] for k in ops.KERNELS}

        out_dir = ROOT / "build" / "trace"
        out_dir.mkdir(parents=True, exist_ok=True)
        trace_path, prom_path = obs.export_all(
            trace_path=str(out_dir / "era_trace.json"),
            metrics_path=str(out_dir / "era_metrics.prom"))
        trace = json.loads(Path(trace_path).read_text())
        prom = Path(prom_path).read_text()
        events = trace["traceEvents"]
        problems = obs.validate_chrome_trace(trace)
        names = {e["name"] for e in events if e["ph"] != "M"}
        problems += [f"missing span {n}" for n in
                     TRACE_REQUIRED_SPANS + TRACE_FABRIC_SPANS
                     if n not in names]
        tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
        problems += [f"missing track repro-era shard {k}"
                     for k in range(TRACE_MESH)
                     if f"repro-era shard {k}" not in tracks]
        link_of = lambda e: (e.get("args") or {}).get("link")
        qw = {link_of(e) for e in events if e["name"] == "serve/queue_wait"}
        dd = [link_of(e) for e in events
              if e["name"] == "serve/device_dispatch"]
        if not dd or None in dd or not set(dd) <= qw:
            problems.append("a serve/device_dispatch link joins no "
                            "serve/queue_wait")
        problems += [f"metrics miss {n}" for n in TRACE_REQUIRED_PROM
                     if n not in prom]
        if 'impl="cuda"' not in prom or 'impl="ref"' in prom:
            problems.append("a kernel dispatch ran the plain version")
        m = obs.metrics()
        labels = {}
        for inst in m.instruments():
            if inst.name == "kernel_dispatch_total":
                key = (inst.labels["kernel"], inst.labels["currency"])
                labels[f"{key[0]}/{key[1]}"] = int(inst.value)
        for (kernel, currency), fns in DISPATCH_KERNELS.items():
            n_rec = labels.get(f"{kernel}/{currency}", 0)
            n_launch = sum(recorded[f] for f in fns)
            if n_rec != n_launch:
                problems.append(f"kernel_dispatch_total{{kernel={kernel},"
                                f"currency={currency}}} {n_rec} != "
                                f"{n_launch} launches of {fns}")
        if obs.tracer().n_dropped:
            problems.append(f"the ring buffer dropped "
                            f"{obs.tracer().n_dropped} events")
        qps_on, qps_off = max(qps["on"]), max(qps["off"])
        if qps_on < TRACE_QPS_FLOOR * qps_off:
            problems.append(f"qps_on {qps_on} < {TRACE_QPS_FLOOR} x "
                            f"qps_off {qps_off}")
        if problems:
            raise AssertionError("trace: " + "; ".join(problems))
        emit({"phase": "trace", "n": len(s) - 1,
              "fabric_n": len(s_fab) - 1, "mesh": TRACE_MESH,
              "chunks": srep.n_chunks, "t_build_stream_s": t_stream,
              "check": check, "requests": len(hot),
              "spans": sum(e["ph"] == "X" for e in events),
              "events": len(events), "distinct_names": len(names),
              "names": sorted(names), "links": len(set(dd)),
              "qps_on": qps_on, "qps_off": qps_off,
              "qps_ratio": qps_on / qps_off, "qps_on_all": qps["on"],
              "qps_off_all": qps["off"],
              "trace_bytes": Path(trace_path).stat().st_size,
              "metrics_bytes": Path(prom_path).stat().st_size,
              "dispatch_total": labels, "launches_recorded": recorded,
              "launches_recorder_off": off, "sync_free_dispatch": True,
              "t_phase_s": time.perf_counter() - t_phase})
        return recorded
    finally:
        obs.configure(trace=False, metrics_on=False, clear=True)


# ---- the serial engine and the worker driver ------------------------------

def require_same_subtrees(got: dict, want: dict, what: str) -> None:
    """Every sub-tree's ``ell``, ``b_off``, ``b_c1`` and ``b_c2`` equal."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: the sub-tree prefixes differ")
    for p, st in want.items():
        for f in ("ell", "b_off", "b_c1", "b_c2"):
            if not np.array_equal(getattr(got[p], f), getattr(st, f)):
                raise AssertionError(f"{what}: sub-tree {p} {f} differs")


def serial_phase(name: str, sx: np.ndarray, ax, cfg, t_one_shot: float):
    """The batched ``build(build_impl="none")`` and the serial engine's
    (``construction="serial"``) of the same string, the serial one
    counted; every sub-tree equal.  Returns (batched sub-trees, counts)."""
    import dataclasses
    from repro_torch.core.api import BuildReport, EraIndexer
    from repro_torch.core.prepare import PrepareStats
    from repro_torch.core.vertical import VerticalStats
    from repro_torch.kernels import ops
    base = dataclasses.replace(cfg, build_impl="none")
    rep_b = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    batched = EraIndexer(ax, base).build(sx, rep_b)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    ops.reset_launch_counts()
    rep_s = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    serial = EraIndexer(ax, dataclasses.replace(
        base, construction="serial")).build(sx, rep_s)
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t0
    got = counts_now()
    require_same_subtrees(serial.subtrees, batched.subtrees,
                          f"{name} serial")
    require_launches(got, SERIAL_KERNELS[name], f"the {name} serial build")
    emit({"phase": "serial", "dataset": name, "n": len(sx) - 1,
          "groups": rep_s.n_groups, "subtrees": len(serial.subtrees),
          "capacity": rep_s.capacity, "t_prepare_s": rep_s.t_prepare,
          "batched_t_prepare_s": rep_b.t_prepare,
          "build_device_t_prepare_s": t_one_shot,
          "serial_vs_batched": rep_s.t_prepare / rep_b.t_prepare,
          "t_total_s": t_serial, "batched_t_total_s": t_batched,
          "iterations": rep_s.prepare.iterations,
          "batched_iterations": rep_b.prepare.iterations,
          "symbols_fetched": rep_s.prepare.symbols_fetched,
          "batched_symbols_fetched": rep_b.prepare.symbols_fetched,
          "equal_to_batched": True, "launches": got})
    return batched.subtrees, got


def serial_nodes_phase(n_log2: int) -> dict:
    """Genome at 2^n_log2: the serial engine under ``build_impl`` numpy,
    scan and parallel (counted together); every node set equal to the
    batched tree's, the scan's arrays equal to the stack builder's."""
    from repro_torch.core.alphabet import ALPHABETS
    from repro_torch.core.api import EraConfig, EraIndexer
    from repro_torch.core.build import nodes_to_host, nodes_to_intervals
    from repro_torch.data.strings import dataset
    from repro_torch.kernels import ops
    sx, ax = dataset("genome", 1 << n_log2, seed=0)
    t0 = time.perf_counter()
    tree = EraIndexer(ax, EraConfig()).build(sx)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    want = {p: nodes_to_intervals(st.nodes)
            for p, st in tree.subtrees.items()}
    ops.reset_launch_counts()
    seconds, built = {}, {}
    for impl in ("numpy", "scan", "parallel"):
        t0 = time.perf_counter()
        idx = EraIndexer(ax, EraConfig(construction="serial",
                                       build_impl=impl)).build(sx)
        torch.cuda.synchronize()
        seconds[impl] = time.perf_counter() - t0
        require_same_subtrees(idx.subtrees, tree.subtrees,
                              f"serial_nodes {impl}")
        built[impl] = {p: nodes_to_host(st.nodes)
                       for p, st in idx.subtrees.items()}
        for p, iv in want.items():
            if nodes_to_intervals(built[impl][p]) != iv:
                raise AssertionError(f"serial_nodes {impl}: sub-tree {p}'s "
                                     f"nodes differ from the batched tree's")
    got = counts_now()
    for p, a in built["numpy"].items():  # one algorithm, two walks
        b = built["scan"][p]
        if not all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) \
                or a.n_nodes != b.n_nodes:
            raise AssertionError(f"serial_nodes: scan and numpy differ at {p}")
    require_launches(got, SERIAL_KERNELS["genome"], "the serial_nodes builds")
    emit({"phase": "serial_nodes", "dataset": "genome", "n": len(sx) - 1,
          "subtrees": len(tree.subtrees),
          "internal_nodes": sum(len(v) for v in want.values()),
          "t_total_s": seconds, "batched_tree_t_total_s": t_batched,
          "equal_to_batched_tree": True, "launches": got})
    return got


def era_run_phase(sx: np.ndarray, ax, cfg, want: dict, n_sub_log2: int):
    """``build_distributed``: 4 workers, 4 groups a pull, a checkpoint
    under build/, worker w1 failed after 2 groups (counted), equal to the
    batched build's sub-trees; then ``python -m repro_torch.launch.era_run``
    at 2^n_sub_log2 in both modes as subprocesses that must exit 0."""
    import dataclasses
    import os
    from repro_torch.kernels import ops
    from repro_torch.launch.era_run import build_distributed
    ckpt = ROOT / "build" / "era_run_groups.jsonl"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    ckpt.unlink(missing_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx, qstats, workers = build_distributed(
        sx, ax, dataclasses.replace(cfg, build_impl="none"),
        n_workers=ERA_WORKERS, checkpoint_path=str(ckpt),
        fail_worker="w1", fail_after=ERA_FAIL_AFTER,
        groups_per_pull=ERA_PULL)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    got = counts_now()
    require_same_subtrees(idx.subtrees, want, "era_run build_distributed")
    records = ckpt.read_text().splitlines()
    if qstats["done"] != qstats["total"] or len(records) != qstats["total"]:
        raise AssertionError(f"era_run: {qstats} with {len(records)} "
                             f"checkpoint records")
    if (qstats["total"] > ERA_PULL + ERA_FAIL_AFTER
            and qstats["reattempts"] < 1):  # w1 held a group past its 2nd
        raise AssertionError("era_run: the failed worker's groups were "
                             "never re-dispatched")
    require_launches(got, SERIAL_KERNELS["genome"], "the era_run build")
    emit({"phase": "era_run", "mode": "build_distributed",
          "n": len(sx) - 1, "t_total_s": t_total, "queue": qstats,
          "checkpoint_records": len(records),
          "workers": [{"worker": w.worker, "groups": w.groups,
                       "seconds": w.seconds} for w in workers],
          "equal_to_batched": True, "launches": got})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for mode in ([], ["--stream", "--device-budget-mb", "8"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.era_run",
               "--dataset", "genome", "--n", str(1 << n_sub_log2), *mode]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        emit({"phase": "era_run", "mode": "stream" if mode else "workers",
              "cmd": " ".join(cmd[1:]), "rc": out.returncode,
              "t_wall_s": time.perf_counter() - t0,
              "stdout": out.stdout.strip().splitlines(),
              "stderr_tail": out.stderr.strip().splitlines()[-5:]})
        if out.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited {out.returncode}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27,
                    help="index the genome and protein datasets at n = 2**N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    global LIMITS
    from repro_torch.roofline.hopper import HopperLimits
    LIMITS = HopperLimits()
    from repro_torch.core import build as tbuild
    from repro_torch.core import fabric
    from repro_torch.core import packing
    from repro_torch.core.alphabet import ALPHABETS
    from repro_torch.core import iomodel
    from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
    from repro_torch.core.prepare import (
        PrepareStats,
        _pair_lanes,
        _stable_order,
        subtree_prepare_batch,
        subtree_prepare_stream,
    )
    from repro_torch.core.query import DeviceIndex, _pack_query_batch
    from repro_torch.core.vertical import VerticalStats
    from repro_torch.data.strings import dataset, load_fasta, synthetic_string
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.pack_text import pack_text_dense
    from repro_torch.launch.analytics_serve import make_query, serve_engine
    from repro_torch.launch import gather_bench, hist_lcp_bench
    from repro_torch.launch.gather_bench import persisting_l2_window
    from repro_torch.launch.query_serve import make_workload, serve_index
    from repro_torch.launch.serving import (
        AsyncServer,
        ServeConfig,
        make_hot_workload,
        run_closed_loop,
    )
    from repro_torch.launch.warmstart import (
        load_or_build,
        migrate_archive,
        migrate_archives,
    )

    cuda = torch.device("cuda")
    emit(pack_text_phase(cuda, args.n_log2))

    def dram_round_trip_ms() -> float:
        """Milliseconds of one dependent device-memory round trip
        (``csrc/dram_latency.cu``): a single thread's walk of a random
        cycle over 2^23 nodes 128 B apart (1 GiB, 20x the L2), 2^17 links a
        launch, each launch resuming where the last stopped (no line is
        visited twice), per link, the median of 5 CUDA-event windows."""
        nodes, stride, hops = 1 << 23, 32, 1 << 17
        gen = torch.Generator(device=cuda).manual_seed(5)
        perm = torch.randperm(nodes, device=cuda, generator=gen)
        nxt = torch.zeros(nodes * stride, dtype=torch.int32, device=cuda)
        nxt[perm * stride] = (torch.roll(perm, -1) * stride).to(torch.int32)
        node = (perm[:1] * stride).to(torch.int32)
        fn = _build.entry("dram_latency", [ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p])
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: _build.check(fn(
            nxt.data_ptr(), hops, node.data_ptr(), stream),
            "dram_latency")) / hops
        del nxt, perm, node
        torch.cuda.empty_cache()
        return ms

    def fused_reads(kind: str, ptx, pos, pat, mask, nw_out: int) -> int:
        """Text words the fused kernel reads for these rows: each row reads
        until its window is written and its verdict is decided, plus the
        word its funnel shift straddles."""
        spw, nw_pat = ptx.syms_per_word, pat.shape[1]
        if kind == "words":
            sw = kref.range_gather_words_ref(ptx, pos, nw_pat * spw) & mask
            first = packing.lcp_words(sw, pat, ptx.bits).to(torch.int64) // spw
        else:
            neq = (kref.range_gather_packed_ref(ptx, pos, 4 * nw_pat)
                   & mask) != pat
            first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                nw_pat).to(torch.int64)
        need = torch.clamp(torch.clamp(first + 1, max=nw_pat), min=nw_out)
        if kind == "packed":
            need = -(-4 * need // spw)
        return int((need + 1).sum())

    def fused_case(kind: str, ptx, pos, pat, mask, lengths, fetch: int,
                   inner: int) -> dict:
        """A fused kernel against its plain version and against the two
        ported kernels it fuses, launched one after the other (exact);
        the three times and the bound."""
        if kind == "words":
            nw_out, n_in = -(-fetch // ptx.syms_per_word), 2
            fused = lambda: ops.probe_gather_words(ptx, pos, pat, mask,
                                                   lengths, fetch)
            plain = lambda: kref.probe_gather_words_ref(
                ptx, pos, pat, mask, lengths, fetch=fetch)
            two = lambda: (ops.pattern_probe_words(ptx, pos, pat, mask,
                                                   lengths),
                           ops.range_gather_words(ptx, pos, fetch))
        else:
            nw_out, n_in = fetch // 4, 1
            fused = lambda: ops.probe_gather_packed(ptx, pos, pat, mask, fetch)
            plain = lambda: kref.probe_gather_packed_ref(ptx, pos, pat, mask,
                                                         fetch=fetch)
            two = lambda: (ops.pattern_probe_packed(ptx, pos, pat, mask),
                           ops.range_gather_packed(ptx, pos, fetch))
        got = fused()
        for g, p_, t_, part in zip(got, plain(), two(), ("verdict", "window")):
            assert_equal(g, p_, f"probe_gather_{kind} {part}")
            assert_equal(g, t_, f"probe_gather_{kind} {part} vs two launches")
        b_ms, b_by = bound(*fused_work(
            pos.shape[0], pat.shape[1], nw_out,
            fused_reads(kind, ptx, pos, pat, mask, nw_out),
            ptx.words.shape[0], n_in))
        return {"rows": pos.shape[0], "nw_pat": pat.shape[1], "fetch": fetch,
                "max_abs_err": 0,
                "verdicts": {str(v): int((got[0] == v).sum())
                             for v in (-1, 0, 1)},
                "ms": cuda_ms(fused, inner=inner),
                "plain_ms": cuda_ms(plain, inner=max(1, inner // 5)),
                "two_launch_ms": cuda_ms(two, inner=inner),
                "bound_ms": b_ms, "bound_by": b_by}

    def fused_parity(name: str, ptx, sx: np.ndarray, ax) -> None:
        """Both fused kernels on 4096 rows of a dense text (suffixes that
        run into the terminal included), fetch wider and narrower than the
        pattern; word rows hold real symbols, byte-key rows planted
        suffixes of the terminal-padded string."""
        nr = ptx.n_real
        b = 4096
        sp_x = ax.pad_string(sx, extra=64)
        for m, fetch in ((8, 32), (16, 4), (24, 32), (64, 16)):
            pos_np = rng.integers(0, nr + 1, size=b).astype(np.int32)
            pos_np[-64:] = rng.integers(max(0, nr - m), nr + 1, size=64)
            lens = torch.from_numpy(
                rng.integers(1, m + 1, size=b).astype(np.int32)).to(cuda)
            sym = rng.integers(0, len(ax.symbols),
                               size=(b, m)).astype(np.int32)
            sym_t = sym.copy()
            for i in range(0, b, 2):
                p = int(pos_np[i])
                seg = sx[p:min(p + m, nr)]
                sym[i, :seg.size] = seg
                sym_t[i] = sp_x[p:p + m]
            pos = torch.from_numpy(pos_np).to(cuda)
            rows = {"words": _pack_query_batch(
                        ptx, torch.from_numpy(sym).to(cuda), lens),
                    "packed": _pack_query_batch(
                        None, torch.from_numpy(sym_t).to(cuda), lens,
                        word=False)}
            for kind, (pat, mask) in rows.items():
                emit({"phase": "parity", "kernel": f"probe_gather_{kind}",
                      "text": name, "bits": ptx.bits, "m_pad": m,
                      **fused_case(kind, ptx, pos, pat, mask, lens, fetch,
                                   inner=20)})

    def check_find_fetch(dev, s_dev: torch.Tensor, pats, what: str):
        """``find_fetch_batch``: ranges equal ``find_batch`` and the scan,
        each window equals the text at its first match read on the card
        (the terminal past the end), −1 where nothing matched, and the
        fused verdict is 0 wherever the pattern occurs.  Returns the
        checks and the launch counts of the two find-and-fetch calls alone
        (counted from 0)."""
        n1 = s_dev.shape[0]
        found = dev.find_batch(pats)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ranges, wins = dev.find_fetch_batch(pats, fetch=FETCH)
        t_ff = time.perf_counter() - t0
        padded, lengths, route = dev.pad_batch(pats)
        start, count, win, verified = dev.find_fetch_ranges(
            padded, lengths, route, fetch=FETCH)
        counts = counts_now()
        hits = 0
        for p, r, f in zip(pats, ranges, found):
            want = brute_force(s_dev, np.asarray(p))
            if not (np.array_equal(r, f) and np.array_equal(r, want)):
                raise AssertionError(f"{what}: find_fetch_batch disagrees "
                                     f"with find_batch or the scan for "
                                     f"pattern {np.asarray(p).tolist()}")
            hits += int(want.size)
        has = count > 0
        if not np.array_equal(win.cpu().numpy(), wins):
            raise AssertionError(f"{what}: find_fetch_batch and "
                                 f"find_fetch_ranges disagree")
        if bool((verified[has] != 0).any()):
            raise AssertionError(f"{what}: a matched row failed the fused "
                                 f"verdict")
        pos0 = dev.ell[torch.clamp(start, 0, dev.n_leaves - 1)].to(torch.int64)
        idx = torch.clamp(pos0[:, None] + torch.arange(FETCH, device=cuda),
                          max=n1 - 1)
        want_win = torch.where(has[:, None], s_dev[idx].to(torch.int32), -1)
        if not torch.equal(win, want_win):
            raise AssertionError(f"{what}: a fetched window differs from "
                                 f"the text at its match")
        return {"patterns": len(pats), "matched": int(has.sum()),
                "occurrences": hits, "fetch": FETCH,
                "windows_past_end": int(((pos0 + FETCH > n1 - 1) & has).sum()),
                "t_find_fetch_batch_s": t_ff}, counts

    @contextlib.contextmanager
    def search_as_loop():
        """The search kernels swapped for the loop they replace (n_iter
        single-step probe launches and the small ops around each), the
        yardstick of an end-to-end search."""
        saved = (ops.search_bounds_words, ops.search_bounds_bytes,
                 ops.search_bounds_packed)
        ops.search_bounds_words = (
            lambda pt, ell, pat, mask, lengths, lim_p, lo0, hi0, **kw:
            ops.search_loop(ops.pattern_probe_words, pt, ell, pat, mask,
                            lengths, lim_p, lo0, hi0, **kw))
        ops.search_bounds_bytes = (
            lambda sp, ell, pat, mask, lo0, hi0, **kw: ops.search_loop(
                ops.pattern_probe, sp, ell, pat, mask, None, None, lo0, hi0,
                **kw))
        ops.search_bounds_packed = (
            lambda pt, ell, pat, mask, lo0, hi0, **kw: ops.search_loop(
                ops.pattern_probe_packed, pt, ell, pat, mask, None, None, lo0,
                hi0, **kw))
        try:
            yield
        finally:
            (ops.search_bounds_words, ops.search_bounds_bytes,
             ops.search_bounds_packed) = saved

    @contextlib.contextmanager
    def fetch_unfused():
        """The fused find-and-fetch kernels swapped for what they replace:
        the search kernel, then the epilogue kernels (``probe_gather_words``
        on dense words, ``pattern_probe`` + ``range_gather_pack`` on the
        byte string; byte keys on dense text: the loop of
        ``pattern_probe_packed`` steps, then ``probe_gather_packed``) and
        the torch ops of the decode (``search.fetch_composition`` with the
        ported kernels)."""
        from repro_torch.kernels.search import fetch_composition
        saved = (ops.search_fetch_words, ops.search_fetch_bytes,
                 ops.search_fetch_packed)
        ops.search_fetch_words = (
            lambda pt, ell, pat, mask, lengths, lo0, hi0, **kw:
            fetch_composition(pt, ell, pat, mask, lengths, lo0, hi0,
                              word=True, plain=False, **kw))
        ops.search_fetch_bytes = ops.search_fetch_packed = (
            lambda st, ell, pat, mask, lo0, hi0, **kw: fetch_composition(
                st, ell, pat, mask, None, lo0, hi0, word=False, plain=False,
                **kw))
        try:
            yield
        finally:
            (ops.search_fetch_words, ops.search_fetch_bytes,
             ops.search_fetch_packed) = saved

    def fetch_latency(dev, pats) -> dict:
        """Host milliseconds from dispatch to a synchronised result of the
        search alone (``find_batch_ranges``), of the same search through
        the loop of single-step probes the search kernels replace, of
        find-and-fetch (``find_fetch_ranges``, one fused launch) and of
        find-and-fetch through the search and epilogue kernels it fuses,
        on the same padded batch: medians of 20 runs each, taken in turns
        after one warm-up of each."""
        padded, lengths, route = dev.pad_batch(pats)

        def loop_ranges():
            with search_as_loop():
                return dev.find_batch_ranges(padded, lengths, route)

        def unfused_fetch():
            with fetch_unfused():
                return dev.find_fetch_ranges(padded, lengths, route,
                                             fetch=FETCH)

        calls = {"find_batch_ranges_ms": lambda: dev.find_batch_ranges(
                     padded, lengths, route),
                 "find_batch_ranges_loop_ms": loop_ranges,
                 "find_fetch_ranges_ms": lambda: dev.find_fetch_ranges(
                     padded, lengths, route, fetch=FETCH),
                 "find_fetch_ranges_unfused_ms": unfused_fetch}
        for got, want, part in zip(calls["find_batch_ranges_ms"](),
                                   loop_ranges(), ("start", "count")):
            assert_equal(got, want, f"find_batch_ranges {part} against the "
                                    f"loop of single-step probes")
        for got, want, part in zip(calls["find_fetch_ranges_ms"](),
                                   unfused_fetch(),
                                   ("start", "count", "window", "verified")):
            assert_equal(got, want, f"find_fetch_ranges {part} against the "
                                    f"search and epilogue kernels it fuses")
        times = {k: [] for k in calls}
        for _ in range(21):
            for k, fn in calls.items():
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
        return {k: float(np.median(v[1:])) * 1e3 for k, v in times.items()}

    def require_fetch(counts: dict, path: str, what: str) -> None:
        require_launches(counts, FETCH_KERNELS[path], what)
        for name in FETCH_ABSENT[path]:
            if counts[name]:
                raise AssertionError(f"{name} was launched on {what}")

    class SyncFreeServer(AsyncServer):
        """An AsyncServer whose every ``_dispatch`` (``_dispatch_sharded``
        on a ShardedIndex) runs under
        ``torch.cuda.set_sync_debug_mode("error")`` (any call that
        synchronises the host with the card raises) and launches exactly
        one kernel, ``kernel``, per (sub-)batch with rows to search (none
        when the cache answered it all), with the host seconds of each
        dispatch, each wait for a batch's events and each consume after
        it."""

        def __init__(self, *args, kernel: str, **kw):
            super().__init__(*args, **kw)
            self.kernel = kernel
            self.t_dispatch, self.t_wait, self.t_consume = [], [], []

        def _dispatch(self):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                flight = super()._dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if flight is not None:
                self.t_dispatch.append(time.perf_counter() - t0)
                got = {k: v - before[k]
                       for k, v in ops.launch_counts().items()
                       if v != before[k]}
                subs = (len(flight.out) if self.sharded
                        else int(flight.n_rows > 0))
                if got != ({self.kernel: subs} if subs else {}):
                    raise AssertionError(f"a served batch of {flight.n_rows}"
                                         f" rows in {subs} sub-batches "
                                         f"launched {got}, not one "
                                         f"{self.kernel} each")
                if len(flight.ready) != subs:
                    raise AssertionError("a sub-batch recorded no event")
            return flight

        def _consume(self, flight):
            t0 = time.perf_counter()
            flight.wait()
            t1 = time.perf_counter()
            super()._consume(flight)
            self.t_wait.append(t1 - t0)
            self.t_consume.append(time.perf_counter() - t1)

        def host_ms(self) -> dict:
            """Median host milliseconds per batch of each step."""
            return {f"{k}_ms": float(np.median(v)) * 1e3 for k, v in (
                ("dispatch", self.t_dispatch), ("wait", self.t_wait),
                ("consume", self.t_consume))}

    def device_ms(fn) -> float | None:
        """Milliseconds of device time (kernels and copies) that
        ``torch.profiler`` records while ``fn`` runs; None when it records
        none."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = sum(r[0] for r in device_events(prof))
        return ms if ms else None

    stack_rows = {}  # (dataset, mode, fetch) -> its serving_stack line

    def serving_stack(dev, sx: np.ndarray, ax, name: str) -> dict:
        """``run_closed_loop`` in sync, async and cached mode, with fetch 0
        and FETCH, on a hot workload; each mode warmed once by a
        sync-free-dispatch pass that checks each batch's one launch, then
        timed; every result of both passes equal to ``find_batch`` /
        ``find_fetch_batch`` on the same patterns.  Returns the launch
        counts of the nine passes of each fetch, by fetch."""
        pats = make_hot_workload(sx, np.random.default_rng(29),
                                 n_requests=SERVE_REQUESTS, hot_pool=32,
                                 hot_frac=0.8, min_len=4, max_len=24,
                                 n_symbols=len(ax.symbols))
        uniq = {}
        for p in pats:
            uniq.setdefault(p.tobytes(), p)
        t0 = time.perf_counter()
        want_pos = dict(zip(uniq, dev.find_batch(list(uniq.values()))))
        ranges, wins = dev.find_fetch_batch(list(uniq.values()), fetch=FETCH)
        for k, r in zip(uniq, ranges):
            if not np.array_equal(r, want_pos[k]):
                raise AssertionError(f"{name}: find_fetch_batch ranges "
                                     f"disagree with find_batch")
        want_win = dict(zip(uniq, wins))
        del ranges
        emit({"phase": "serving_stack", "dataset": name,
              "requests": len(pats), "distinct_patterns": len(uniq),
              "positions_per_pass": sum(want_pos[p.tobytes()].size
                                        for p in pats),
              "t_reference_s": time.perf_counter() - t0})

        def check(res, fetch: int, what: str) -> None:
            seen = set()
            for p, (pos, win) in zip(pats, res):
                k = p.tobytes()
                if (id(pos), k) not in seen:
                    seen.add((id(pos), k))
                    if not np.array_equal(pos, want_pos[k]):
                        raise AssertionError(f"{what}: positions differ "
                                             f"from find_batch")
                if fetch and not np.array_equal(win, want_win[k]):
                    raise AssertionError(f"{what}: a window differs from "
                                         f"find_fetch_batch")
                if not fetch and win is not None:
                    raise AssertionError(f"{what}: a window without fetch")

        counts = {}
        for fetch in (0, FETCH):
            ops.reset_launch_counts()
            kernel = FETCH_KERNELS[name][0] if fetch else SEARCH_KERNELS[name]
            base = None
            for mode, kw in (("sync", dict(pipeline=False, cache_size=0)),
                             ("async", dict(pipeline=True, cache_size=0)),
                             ("cached", dict(pipeline=True, cache_size=4096))):
                cfg = ServeConfig(queue_depth=1024, max_batch=256,
                                  max_wait_ms=1.0, fetch=fetch, **kw)
                what = f"{name} serving {mode} fetch={fetch}"
                t0 = time.perf_counter()
                warm = SyncFreeServer(dev, cfg, kernel=kernel)
                check(warm.serve(pats), fetch, what + " (warm-up)")
                t_warm = time.perf_counter() - t0
                res, st = run_closed_loop(dev, pats, cfg)
                check(res, fetch, what)
                del res
                base = st["qps"] if mode == "sync" else base
                busy = {}
                if fetch:  # a third pass under the profiler: device time
                    d_ms = device_ms(lambda: run_closed_loop(dev, pats, cfg))
                    busy = {"device_ms_per_pass": d_ms,
                            "device_busy_share": None if d_ms is None
                            else d_ms / (st["wall_s"] * 1e3)}
                stack_rows[(name, mode, fetch)] = row = {
                      "phase": "serving_stack", "dataset": name,
                      "mode": mode, "fetch": fetch, "qps": st["qps"],
                      "lat_p50_ms": st["lat_p50_ms"],
                      "lat_p99_ms": st["lat_p99_ms"],
                      "vs_sync": st["qps"] / base,
                      "cache_hit_rate": st["cache"]["hit_rate"],
                      "cache": st["cache"], "batches": st["batches"],
                      "rows_padded": st["rows_padded"],
                      "shapes": st["shapes"], "wall_s": st["wall_s"],
                      "warm_pass_s": t_warm, "warm_pass_host": warm.host_ms(),
                      **busy, "sync_free_dispatch": True,
                      "per_batch_launches": {kernel: 1},
                      "equal_to_find_batch": True}
                emit(row)
            counts[fetch] = counts_now()
            emit({"phase": "serving_stack", "dataset": name, "fetch": fetch,
                  "launches": counts[fetch]})
        return counts
    def search_rows(dev, pats, word: bool, m_pad=None):
        """A batch's packed rows and routed windows on the card: (pat,
        mask, lengths, lo0, hi0)."""
        from repro_torch.core.query import _route_window
        padded, lengths, route = dev.pad_batch(pats, m_pad=m_pad)
        t = lambda x: torch.from_numpy(x).to(cuda)
        len_t = t(lengths)
        pat, mask = _pack_query_batch(dev.s_text, t(padded), len_t, word)
        lo0, hi0 = _route_window(dev.win_lo, dev.win_hi, dev.pows, dev.spans,
                                 len_t, t(route), dev.k_route)
        return pat, mask, len_t, lo0.contiguous(), hi0.contiguous()

    def terminal_cases(sx: np.ndarray, ax) -> list:
        """Byte-key patterns that end at the text's last symbols, run into
        the terminal, and every ``[c, terminal]``."""
        n_real = len(sx) - 1
        tail = [np.asarray(sx[n_real - k:n_real]) for k in range(1, 25)]
        tail += [np.append(sx[n_real - k:n_real], ax.terminal_code)
                 .astype(np.uint8) for k in range(24)]
        return tail + [np.array([c, ax.terminal_code], np.uint8)
                       for c in range(len(ax.symbols))]

    def distinct_cases(sx: np.ndarray, ax, rng) -> list:
        """256 distinct byte-key patterns, the byte leg's traffic: the
        terminal cases and planted or random patterns of 4-24 symbols."""
        tail = terminal_cases(sx, ax)
        return tail + make_workload(sx, rng, batch=256 - len(tail),
                                    min_len=4, max_len=24, planted_frac=0.7,
                                    n_symbols=len(ax.symbols))

    def per_call(fn, calls: int = 20):
        """Profiler device ms per call (event windows of back-to-back small
        launches hold the wrappers' host time)."""
        ms = device_ms(lambda: [fn() for _ in range(calls)])
        return None if ms is None else ms / calls

    def search_parity(kind: str, dev, sx: np.ndarray, ax, name: str,
                      serving=None, timed: bool = True) -> dict | None:
        """A search kernel against the loop with the plain probes, the loop
        of single-step kernels and the counted loop of ``search_work``
        (exact) on the serving batch (``serving``, else 256 patterns of
        4-24 symbols; routed windows) and its edges: unrouted and empty
        windows, patterns that end at the terminal tail (byte keys: also
        running into the terminal, and every ``[c, terminal]``), the lower
        bound alone (words: with a pattern limit below the compare
        length), NW at and past the register-template edges, B = 1, 33, 0
        and 2^20 rows.  ``kind``: "words", "bytes" (the byte string) or
        "packed" (byte keys over dense words).  Returns the kernel's row at
        the serving shape when ``timed``."""
        kernel = f"search_bounds_{kind}"
        word = kind == "words"
        step, plain_probe = {
            "words": (ops.pattern_probe_words, kref.pattern_probe_words_ref),
            "bytes": (ops.pattern_probe, kref.pattern_probe_ref),
            "packed": (ops.pattern_probe_packed,
                       kref.pattern_probe_packed_ref)}[kind]
        srng = np.random.default_rng(23)
        n_real = len(sx) - 1
        total = dev.n_leaves

        batch_rows = lambda pats, m_pad=None: search_rows(dev, pats, word,
                                                          m_pad)

        def calls(pat, mask, lengths, lo0, hi0, bounds, lim_p=None):
            kw = dict(n_iter=dev.n_iter, bounds=bounds)
            if word:
                args = (dev.s_text, dev.ell, pat, mask, lengths, lim_p, lo0,
                        hi0)
                fused = lambda: ops.search_bounds_words(*args, **kw)
            else:
                args = (dev.s_text, dev.ell, pat, mask, None, None, lo0, hi0)
                fused = lambda: getattr(ops, kernel)(
                    dev.s_text, dev.ell, pat, mask, lo0, hi0, **kw)
            return (fused, lambda: ops.search_loop(plain_probe, *args, **kw),
                    lambda: ops.search_loop(step, *args, **kw))

        def case(what, pat, mask, lengths, lo0, hi0, bounds=2, lim_p=None):
            fused, plain, loop = calls(pat, mask, lengths, lo0, hi0, bounds,
                                       lim_p)
            got = fused()
            assert_equal(got, plain(), f"{kernel} {name} {what}")
            assert_equal(got, loop(), f"{kernel} {name} {what} against the "
                                      f"loop of single-step kernels")
            trips, _, _, want = search_work(kind, dev.s_text, dev.ell, pat,
                                            mask, lengths, lim_p, lo0, hi0,
                                            dev.n_iter, bounds)
            assert_equal(got, want, f"{kernel} {name} {what} against the "
                                    f"counted loop")
            emit({"phase": "parity", "kernel": kernel, "text": name,
                  "case": what, "rows": bounds * pat.shape[0],
                  "nw": pat.shape[1], "bounds": bounds, "max_abs_err": 0,
                  "trips_max": int(trips.max()) if trips.numel() else 0,
                  "n_iter": dev.n_iter})

        if serving is None:
            serving = make_workload(sx, srng, batch=256, min_len=4,
                                    max_len=24, planted_frac=0.7,
                                    n_symbols=len(ax.symbols))
        pat, mask, lengths, lo0, hi0 = batch_rows(serving)
        case("serving", pat, mask, lengths, lo0, hi0)
        case("unrouted", pat, mask, lengths, torch.zeros_like(lo0),
             torch.full_like(hi0, total))
        empty = torch.randint(0, total + 1, lo0.shape, device=cuda,
                              dtype=torch.int32)
        case("empty", pat, mask, lengths, empty, empty.clone())
        pick = torch.randint(0, 3, lo0.shape, device=cuda)
        case("mixed", pat, mask, lengths,
             torch.where(pick == 0, lo0, torch.where(pick == 1, 0, empty)),
             torch.where(pick == 0, hi0, torch.where(pick == 1, total,
                                                     empty)))
        tail = ([np.asarray(sx[n_real - k:n_real]) for k in range(1, 25)]
                if word else terminal_cases(sx, ax))
        case("terminal_tail", *batch_rows(tail))
        lim_p = (torch.clamp(lengths - torch.randint_like(lengths, 0, 8),
                             min=0) if word else None)
        case("lower_bound" + ("_lim_p" if word else ""), pat, mask, lengths,
             lo0, hi0, bounds=1, lim_p=lim_p)
        spw = dev.s_text.syms_per_word if word else 4
        for nw in (1, 2, 3, 4, 8, 16, 17, 32 if word else 128):
            pats = []
            for i in range(256):  # lengths that need all nw words
                m = int(srng.integers((nw - 1) * spw + 1, nw * spw + 1))
                if i % 2:
                    p0 = int(srng.integers(0, n_real - m))
                    pats.append(np.asarray(sx[p0:p0 + m]))
                else:
                    pats.append(srng.integers(0, len(ax.symbols), m)
                                .astype(np.uint8))
            case(f"nw={nw}", *batch_rows(pats, m_pad=nw * spw))
        for b in (1, 33, 0):
            case(f"B={b}", pat[:b], mask[:b], lengths[:b], lo0[:b], hi0[:b])
        idx = torch.randint(0, pat.shape[0], (1 << 19,), device=cuda)
        large = (pat[idx].contiguous(), mask[idx].contiguous(), lengths[idx],
                 lo0[idx], hi0[idx])
        case("2^20 rows", *large)
        if not timed:
            return None

        def timing(pat, mask, lengths, lo0, hi0):
            """Times and bounds of both bounds in one launch."""
            fused, plain, loop = calls(pat, mask, lengths, lo0, hi0, 2)
            trips, nbytes, n_ops, _ = search_work(
                kind, dev.s_text, dev.ell, pat, mask, lengths, None, lo0,
                hi0, dev.n_iter, 2)
            b_ms, b_by = bound(nbytes, n_ops)
            return {"ms": cuda_ms(fused, inner=100),
                    "device_ms": per_call(fused),
                    "loop_ms": cuda_ms(loop, inner=10),
                    "loop_device_ms": per_call(loop, calls=2),
                    "plain_ms": cuda_ms(plain, inner=2),
                    "bound_ms": b_ms, "bound_by": b_by,
                    # the longest lane's dependent round trips: its window
                    # and pattern row, the first ell entry, one per trip
                    "latency_bound_ms": (int(trips.max()) + 2) * dram_rt_ms,
                    "trips_max": int(trips.max()),
                    "trips_mean": float(trips.to(torch.float64).mean())}

        # the row: the serving batch, both bounds in one launch
        fl, _, ll = calls(*large, 2)
        trips_l, nbytes_l, n_ops_l, _ = search_work(
            kind, dev.s_text, dev.ell, *large[:3], None, *large[3:],
            dev.n_iter, 2)
        bl_ms, bl_by = bound(nbytes_l, n_ops_l)
        win = (hi0 - lo0).to(torch.float64)
        replaces = {"words": "src/repro/kernels/packed_gather.py:335",
                    "bytes": "src/repro/kernels/pattern_probe.py:57",
                    "packed": "src/repro/kernels/packed_gather.py:159"}[kind]
        return {"name": kernel, "replaces": replaces,
                "replaces_loop": "src/repro/core/query.py:114",
                "shape": f"rows={2 * pat.shape[0]} nw={pat.shape[1]} "
                         f"bounds=2 (B={pat.shape[0]})",
                "patterns_distinct": n_distinct(pat, mask),
                **timing(pat, mask, lengths, lo0, hi0),
                "bound_note": "this run's trips' bytes over 3.35 TB/s; the "
                              "kernel is bound by dependent DRAM latency "
                              "times trips, not bytes",
                "n_iter": dev.n_iter, "window_max": int(win.max()),
                "window_mean": float(win.mean()),
                "large": {"shape": f"rows={2 * large[0].shape[0]} "
                                   f"nw={pat.shape[1]} bounds=2",
                          "ms": cuda_ms(fl, inner=5),
                          "loop_ms": cuda_ms(ll, inner=1),
                          "bound_ms": bl_ms, "bound_by": bl_by,
                          "trips_mean": float(trips_l.to(torch.float64)
                                              .mean())},
                **distinct_row(kind, sx, ax, srng, batch_rows, case,
                               timing)}

    def n_distinct(pat: torch.Tensor, mask: torch.Tensor) -> int:
        rows = torch.cat([pat, mask], 1).to(torch.int64)
        return int(torch.unique(rows, dim=0).shape[0])

    def distinct_row(kind: str, sx, ax, rng, batch_rows, case,
                     timing) -> dict:
        """Byte keys over dense words (a served batch repeats its patterns,
        whose trips then share cache lines): the same times on 256
        distinct patterns, checked first like every case."""
        if kind != "packed":
            return {}
        rows_d = batch_rows(distinct_cases(sx, ax, rng))
        case("distinct", *rows_d)
        return {"distinct": {"shape": f"B={rows_d[0].shape[0]} "
                                      f"nw={rows_d[0].shape[1]}",
                             "patterns_distinct": n_distinct(*rows_d[:2]),
                             **timing(*rows_d)}}

    def fetch_parity(kind: str, dev, sx: np.ndarray, ax, name: str,
                     serving=None, timed: bool = True) -> dict | None:
        """A fused find-and-fetch kernel against its plain version
        (``search.fetch_composition`` with the plain probes) and the search
        and epilogue kernels it fuses (exact, all four outputs) on the
        find-and-fetch batch (``serving``, else 256 patterns of 4-24
        symbols; routed windows, fetch 32) and its edges: unrouted, empty
        and mixed windows, patterns at the text's end (windows past
        n_real; byte keys: also running into the terminal, and every
        ``[c, terminal]``), fetch narrower and wider than the pattern, NW
        past the register templates, B = 1, B = 33, B = 0 and 2^20 lanes
        (2^19 patterns).  ``kind`` as :func:`search_parity`.  Returns the
        kernel's row when ``timed``."""
        from repro_torch.kernels.search import fetch_composition
        kernel = f"search_fetch_{kind}"
        word = kind == "words"
        frng = np.random.default_rng(31)
        n_real = len(sx) - 1
        total = dev.n_leaves

        def calls(pat, mask, lengths, lo0, hi0, fetch):
            kw = dict(n_iter=dev.n_iter, fetch=fetch)
            if word:
                fused = lambda: ops.search_fetch_words(
                    dev.s_text, dev.ell, pat, mask, lengths, lo0, hi0, **kw)
            else:
                fused = lambda: getattr(ops, kernel)(
                    dev.s_text, dev.ell, pat, mask, lo0, hi0, **kw)
            comp = lambda plain: fetch_composition(
                dev.s_text, dev.ell, pat, mask, lengths if word else None,
                lo0, hi0, word=word, plain=plain, **kw)
            return fused, lambda: comp(True), lambda: comp(False)

        def case(what, pat, mask, lengths, lo0, hi0, fetch=FETCH):
            fused, plain, unfused = calls(pat, mask, lengths, lo0, hi0, fetch)
            got = fused()
            for g, p_, u, part in zip(got, plain(), unfused(),
                                      ("start", "count", "window",
                                       "verified")):
                assert_equal(g, p_, f"{kernel} {name} {what} {part}")
                assert_equal(g, u, f"{kernel} {name} {what} {part} against "
                                   f"the kernels it fuses")
            emit({"phase": "parity", "kernel": kernel, "text": name,
                  "case": what, "patterns": pat.shape[0],
                  "nw": pat.shape[1], "fetch": fetch, "max_abs_err": 0,
                  "matched": int((got[1] > 0).sum())})

        def work(pat, mask, lengths, lo0, hi0, fetch):
            """(bytes, ops, longest trips) of the fused kernel on this run's
            data: the search's (``search_work``) less its (2, B) result,
            plus per pattern the ell entry at its lower bound, the text its
            verdict and window need (each word once, counted as
            ``search_work`` counts a trip's; no window where the pattern
            did not occur) and the four outputs."""
            trips, nbytes, n_ops, bnd = search_work(
                kind, dev.s_text, dev.ell, pat, mask, lengths, None, lo0,
                hi0, dev.n_iter, 2)
            b, nw = pat.shape
            pos0 = dev.ell[torch.clamp(bnd[0], 0, total - 1)]
            if word:
                nw_out = -(-fetch // dev.s_text.syms_per_word)
                text = 4 * fused_reads("words", dev.s_text, pos0, pat, mask,
                                       nw_out)
            else:
                gather = (kref.range_gather_packed_ref if kind == "packed"
                          else kref.range_gather_pack_ref)
                neq = (gather(dev.s_text, pos0, 4 * nw) & mask) != pat
                first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                    nw).to(torch.int64)
                verdict = torch.minimum(first + 1, (mask != 0).sum(1))
                found = bnd[1] > bnd[0]
                keys = torch.where(found, torch.clamp(verdict, min=fetch // 4),
                                   verdict)
                read = (span_words(pos0, keys, dev.s_text.syms_per_word)
                        if kind == "packed" else keys + 1)
                text = int((read * 4).sum())
            nbytes += b * 4 + text + b * (fetch + 3) * 4 - 2 * b * 4
            return (nbytes, n_ops + b * (nw * 30 + fetch * 6),
                    int(trips.max()) if trips.numel() else 0)

        if serving is None:
            serving = make_workload(sx, frng, batch=256, min_len=4,
                                    max_len=24, planted_frac=0.7,
                                    n_symbols=len(ax.symbols))
        rows_b = search_rows(dev, serving, word)
        pat, mask, lengths, lo0, hi0 = rows_b
        case("fetch", *rows_b)
        tail = ([np.asarray(sx[n_real - k:n_real]) for k in range(1, 25)]
                if word else terminal_cases(sx, ax))
        case("terminal_tail", *search_rows(dev, tail, word))
        empty = torch.randint(0, total + 1, lo0.shape, device=cuda,
                              dtype=torch.int32)
        case("empty", pat, mask, lengths, empty, empty.clone())
        case("unrouted", pat, mask, lengths, torch.zeros_like(lo0),
             torch.full_like(hi0, total))
        pick = torch.randint(0, 3, lo0.shape, device=cuda)
        case("mixed", pat, mask, lengths,
             torch.where(pick == 0, lo0, torch.where(pick == 1, 0, empty)),
             torch.where(pick == 0, hi0, torch.where(pick == 1, total,
                                                     empty)))
        case("fetch=4", *rows_b, fetch=4)
        case("fetch=64", *rows_b, fetch=64)
        spw = dev.s_text.syms_per_word if word else 4
        for nw in (3, 16, 17, 32 if word else 128):
            pats = []
            for i in range(256):  # lengths that need all nw words
                m = int(frng.integers((nw - 1) * spw + 1, nw * spw + 1))
                if i % 2:
                    p0 = int(frng.integers(0, n_real - m))
                    pats.append(np.asarray(sx[p0:p0 + m]))
                else:
                    pats.append(frng.integers(0, len(ax.symbols), m)
                                .astype(np.uint8))
            case(f"nw={nw}", *search_rows(dev, pats, word, nw * spw))
        for b in (1, 33, 0):
            case(f"B={b}", *(x[:b] for x in rows_b))
        idx = torch.randint(0, pat.shape[0], (1 << 19,), device=cuda)
        large = tuple(x[idx].contiguous() for x in rows_b)
        case("2^20 lanes", *large)
        if not timed:
            return None

        # the longest lane's dependent round trips: its window and pattern
        # row, the first ell entry, one per trip, then the ell entry at the
        # lower bound and the text there
        lat = lambda trips: (trips + 4) * dram_rt_ms

        def timing(pat, mask, lengths, lo0, hi0):
            """Times and bounds at fetch FETCH, beside the search alone."""
            fused, plain, unfused = calls(pat, mask, lengths, lo0, hi0,
                                          FETCH)
            nbytes, n_ops, trips_max = work(pat, mask, lengths, lo0, hi0,
                                            FETCH)
            b_ms, b_by = bound(nbytes, n_ops)
            search = lambda: ops.search_bounds(
                dev.s_text, dev.ell, pat, mask, lengths, None, lo0, hi0,
                n_iter=dev.n_iter, bounds=2, word=word)
            return {"ms": cuda_ms(fused, inner=100),
                    "plain_ms": cuda_ms(plain, inner=2),
                    "unfused_ms": cuda_ms(unfused, inner=20),
                    "search_ms": cuda_ms(search, inner=100),
                    "device_ms": per_call(fused),
                    "unfused_device_ms": per_call(unfused),
                    "search_device_ms": per_call(search),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "latency_bound_ms": lat(trips_max),
                    "trips_max": trips_max}

        # the row: the find-and-fetch batch, and 2^20 lanes
        fl, pl, ul = calls(*large, FETCH)
        nbytes_l, n_ops_l, trips_l = work(*large, FETCH)
        bl_ms, bl_by = bound(nbytes_l, n_ops_l)
        replaces = {"words": "src/repro/kernels/probe_gather.py:80",
                    "bytes": "src/repro/kernels/pattern_probe.py:57",
                    "packed": "src/repro/kernels/probe_gather.py:174"}[kind]
        return {"name": kernel, "replaces": replaces,
                "replaces_composition": "src/repro/core/query.py:207",
                "shape": f"B={pat.shape[0]} lanes={2 * pat.shape[0]} "
                         f"nw={pat.shape[1]} fetch={FETCH}",
                "patterns_distinct": n_distinct(pat, mask),
                **timing(*rows_b),
                "bound_note": "this run's trips' and epilogue's bytes over "
                              "3.35 TB/s; latency_bound_ms: the longest "
                              "lane's dependent round trips (trips + 4) "
                              "times the measured DRAM round trip",
                "dram_round_trip_ms": dram_rt_ms,
                "large": {"shape": f"B={large[0].shape[0]} "
                                   f"lanes={2 * large[0].shape[0]} "
                                   f"nw={pat.shape[1]} fetch={FETCH}",
                          "ms": cuda_ms(fl, inner=5),
                          "plain_ms": cuda_ms(pl, reps=1),
                          "unfused_ms": cuda_ms(ul, inner=2),
                          "bound_ms": bl_ms, "bound_by": bl_by,
                          "latency_bound_ms": lat(trips_l),
                          "trips_max": trips_l},
                **distinct_row(kind, sx, ax, frng,
                               lambda pats: search_rows(dev, pats, word),
                               case, timing)}

    def gather_call(kernel: str):
        return getattr(ops, kernel), getattr(kref, f"{kernel}_ref")

    def edge_offsets(f: int, hi: int) -> torch.Tensor:
        """int32[f] offsets in [0, hi], the last 64 at the end."""
        offs = torch.randint(0, hi + 1, (f,), device=cuda, dtype=torch.int32)
        k = min(f, 64)
        if k:
            offs[-k:] = torch.arange(hi - k + 1, hi + 1, device=cuda,
                                     dtype=torch.int32)
        return offs

    def gather_edges(kernel: str, text, hi: int, spw: int, name: str) -> None:
        """A redesigned gather against its plain version on every NW
        template and two nw outside them (as far as the text's read
        contract reaches), launches of GATHER_ROWS rows, offsets up to
        ``hi`` (the text's end), without a mask, with a mixed one and with
        every row masked off (exact)."""
        fn, plain = gather_call(kernel)
        # the dense texts' read contract: w up to their extra symbols
        limit = 2 * cfg.w_max + 8 if kernel != "range_gather_pack" else 1e9
        ws = [nw * spw for nw in GATHER_NW if nw * spw <= limit]
        cases = 0
        for w in ws:
            for f in GATHER_ROWS:
                offs = edge_offsets(f, hi)
                for mask in (None, torch.rand(f, device=cuda) < 0.5,
                             torch.zeros(f, dtype=torch.bool, device=cuda)):
                    assert_equal(fn(text, offs, w, mask=mask),
                                 plain(text, offs, w, mask),
                                 f"{kernel} {name} w={w} rows={f} "
                                 f"mask={None if mask is None else 'on'}")
                    cases += 1
        emit({"phase": "parity", "kernel": kernel, "text": name,
              "case": "edges", "w": ws, "rows": list(GATHER_ROWS),
              "masks": ["none", "mixed", "all off"], "cases": cases,
              "max_abs_err": 0})

    def gather_past_2_31(kernel: str, text, hi: int, w: int, nw: int,
                         name: str) -> None:
        """One launch with more than 2^31 output words (nw = 16 rows, as
        ``REPRO_COMPACT=off`` reaches at w = 256): the rows whose words lie
        past 2^31 against the plain version on those rows alone, a mixed
        mask on; the 8 GiB output is freed after."""
        fn, plain = gather_call(kernel)
        first = (1 << 31) // nw
        f = first + (1 << 20)
        offs = edge_offsets(f, hi)
        mask = offs % 7 != 0
        out = fn(text, offs, w, mask=mask)
        assert_equal(out[first:], plain(text, offs[first:], w, mask[first:]),
                     f"{kernel} {name} past 2^31 words")
        emit({"phase": "parity", "kernel": kernel, "text": name,
              "case": "past 2^31 words", "rows": f, "w": w,
              "words": f * nw, "rows_checked": f - first, "max_abs_err": 0})
        del out, offs, mask
        torch.cuda.empty_cache()

    def l2_window_row(fn, buf: torch.Tensor) -> dict:
        """The kernel's time without and under a persisting L2 window over
        its text (the measuring harness of ``gather_bench``; no kernel of
        the port sets one), in turns off, on, on, off."""
        off = [cuda_ms(fn)]
        with persisting_l2_window(buf) as ratio:
            on = [cuda_ms(fn), cuda_ms(fn)]
        off.append(cuda_ms(fn))
        return {"off_ms": float(np.median(off)), "on_ms": float(np.median(on)),
                "hit_ratio": ratio}

    def build_bounds(counts: dict, n_sym: int) -> dict:
        """Least ms of the port kernels a counted build launched, from its
        launches and the gathers' row and word tallies: a gather moves its
        offsets, mask bytes and keys (its scattered text reads, which can
        hit L2, left out), ``lcp_pairs`` both key rows and three outputs
        per row (its rows are the byte gather's: ``range_gather_pack`` on
        a byte string, ``range_gather_packed`` in the byte leg),
        ``kmer_histogram`` the string once per launch."""
        b = {k: ((5 * counts[f"{k}_rows"] + 4 * counts[f"{k}_words"])
                 / LIMITS.hbm_bytes_per_s * 1e3) for k in GATHERS}
        byte = ("range_gather_pack", "range_gather_packed")
        b["lcp_pairs"] = ((8 * sum(counts[f"{k}_words"] for k in byte)
                           + 12 * sum(counts[f"{k}_rows"] for k in byte))
                          / LIMITS.hbm_bytes_per_s * 1e3)
        b["kmer_histogram"] = (counts["kmer_histogram"] * n_sym
                               / LIMITS.hbm_bytes_per_s * 1e3)
        return b

    def build_profile(name: str, sx: np.ndarray, ax, t_prepare_s: float,
                      counts: dict) -> dict:
        """One more warm ``build_device`` of ``name`` (the counted build's
        tallies and seconds stay as they were) under ``torch.profiler``:
        device ms and calls per kernel name, the two gathers' ms and
        their share of the counted build's ``t_prepare_s``, the device's
        busy share of the build's wall, and each port kernel's ms beside
        its bound for the counted build's work (``counts``).  CUDA events
        around each launch of the build's port kernels give the same ms
        where the profiler records none for a kernel loaded with ctypes."""
        from torch.profiler import ProfilerActivity, profile
        events = {k: [] for k in BUILD_KERNELS[name]}
        saved = {k: getattr(ops, k) for k in events}

        def timed(kname, fn):
            def call(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                events[kname].append((e0, e1))
                return out
            return call

        torch.cuda.synchronize()
        report = BuildReport(VerticalStats(), PrepareStats())
        try:
            for k, fn in saved.items():
                setattr(ops, k, timed(k, fn))
            # device activity only: recording every host op of a build
            # costs minutes of post-processing
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                dev = EraIndexer(ax, cfg).build_device(sx, report)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(ops, k, fn)
        del dev
        torch.cuda.empty_cache()
        brk = device_breakdown(prof, wall, top=None)
        per = {k: {"ms": 0.0, "calls": 0} for k in events}
        for r in brk["top_kernels"]:
            if r["kernel"] in per:
                per[r["kernel"]]["ms"] += r["ms"]
                per[r["kernel"]]["calls"] += r["calls"]
        bounds = build_bounds(counts, len(sx))
        for k, evs in events.items():
            per[k]["event_ms"] = sum(a.elapsed_time(b) for a, b in evs)
            per[k]["launches"] = len(evs)
            per[k]["ms_in_build"] = (per[k]["ms"] if per[k]["calls"]
                                     else per[k]["event_ms"])
            per[k]["source"] = "profiler" if per[k]["calls"] else "events"
            per[k]["bound_ms"] = bounds[k]
            per[k]["excess_ms"] = per[k]["ms_in_build"] - bounds[k]
        gathers = sum(v["ms_in_build"] for k, v in per.items()
                      if k in GATHERS)
        row = {"phase": "build_profile", "dataset": name, "n": len(sx) - 1,
               "t_total_s": wall, "t_prepare_s": report.t_prepare,
               "counted_t_prepare_s": t_prepare_s,
               "device_ms": brk["device_ms"],
               "device_busy_share": brk["device_busy_share"],
               "port_kernels": per, "gathers_ms": gathers,
               "gathers_share_of_t_prepare": gathers / (t_prepare_s * 1e3),
               "kernels": brk["top_kernels"]}
        emit(row)
        return row

    kmer_rows: dict = {}  # (dataset, k) -> the kernel's ms, path, yardstick
    lcp_w256: dict = {}  # text -> suffix_lcp_words ms at w = 256, by chain

    def lcp_word_cases(name: str, ptx, offs: torch.Tensor) -> None:
        """``suffix_lcp_words`` against its plain version on neighbour
        pairs in the order of their 64-symbol keys (long shared prefixes;
        ``pos_a[i + 1] == pos_b[i]`` on every row, as adjacent leaves),
        the same pairs with 30 % of the chain cut and in a random order
        (no adjacency), each with pairs at ``n_real - 1`` and ``n_real``;
        at w = 4, 64, 128, 256 and at every NW bucket and two widths
        outside them that the text's padding allows.  Timed at w = 4, 64
        and 256 on the chained pairs, at 256 also unchained."""
        nr, spw = ptx.n_real, ptx.syms_per_word
        pa, pb = sorted_pairs(ops.range_gather_words(ptx, offs, 64), offs)
        end_a = torch.tensor([nr - 1, nr, nr - 1, nr, 0], dtype=torch.int32,
                             device=cuda)
        end_b = torch.tensor([nr, nr - 1, nr - 2, 0, nr], dtype=torch.int32,
                             device=cuda)
        cut = torch.rand(pa.shape[0], device=cuda) < 0.3
        perm = torch.randperm(pa.shape[0], device=cuda)
        chains = {"full": (pa, pb),
                  "partial": (torch.where(cut, pa.flip(0), pa), pb),
                  "none": (pa[perm], pb[perm])}
        chains = {c: (torch.cat([a, end_a]).contiguous(),
                      torch.cat([b_, end_b]).contiguous())
                  for c, (a, b_) in chains.items()}
        room = (ptx.words.shape[0] - 1) * spw - nr  # symbols past n_real
        widths = sorted({4, 64, 128, 256} | {
            nw * spw for nw in (1, 2, 3, 4, 8, 16, 24, 32, 64)
            if nw * spw + spw <= room})
        for chain, (a, b_) in chains.items():
            share = float((a[1:] == b_[:-1]).float().mean())
            for w in widths:
                got = ops.suffix_lcp_words(ptx, a, b_, w)
                assert_equal(got, kref.suffix_lcp_words_ref(ptx, a, b_, w),
                             f"suffix_lcp_words {name} {chain} w={w}")
                if not ((chain == "full" and w in (4, 64, 256))
                        or (chain == "none" and w == 256)):
                    continue
                b_ms, b_by = bound(*suffix_lcp_work(
                    got, w, spw, ptx.nbytes, 8))
                row = {"ms": cuda_ms(lambda: ops.suffix_lcp_words(
                    ptx, a, b_, w))}
                if w == 256:
                    lcp_w256.setdefault(name, {})[chain] = row["ms"]
                emit({"phase": "parity", "kernel": "suffix_lcp_words",
                      "text": name, "bits": ptx.bits, "rows": a.shape[0],
                      "w": w, "chain": chain, "adjacent_share": share,
                      "max_abs_err": 0,
                      "saturated_rows": int((got == w).sum()), **row,
                      "plain_ms": cuda_ms(
                          lambda: kref.suffix_lcp_words_ref(ptx, a, b_, w)),
                      "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "parity", "kernel": "suffix_lcp_words",
                  "text": name, "bits": ptx.bits, "chain": chain,
                  "adjacent_share": share, "rows": a.shape[0],
                  "widths_checked": widths, "max_abs_err": 0})

    def kmer_parity(name: str, sp: torch.Tensor, n_win: int, k: int,
                    base: int) -> None:
        """``kmer_histogram`` against its plain version on the whole
        string (timed, beside ``torch.bincount`` of the precomputed codes:
        a yardstick for the counting step alone) and on its edge cases: a
        start off every 16-byte boundary, one window, ragged tails, a
        homopolymer and a densely planted 64-symbol motif."""
        got = ops.kmer_histogram(sp, n_win, k, base)
        path = ops.kmer_histogram.last_path
        assert_equal(got, kref.kmer_histogram_ref(sp, n_win, k, base),
                     f"kmer_histogram {name} k={k}")
        assert int(got.sum()) == n_win
        m = 1 << 20
        head = sp[:m + 64]
        motif = head[:64].clone()
        planted = head.clone()
        for o in range(0, m, 640):
            planted[o:o + 64] = motif
        homo = torch.full_like(head, int(head[0]))
        cases = [(f"offset {o}", head[o:], m - 15) for o in range(1, 16)]
        cases += [(f"ragged {r}", head, r) for r in (1, 15, 31, 33, 4097)]
        cases += [("homopolymer", homo, m), ("motif", planted, m)]
        for case, text, nc in cases:
            assert_equal(ops.kmer_histogram(text, nc, k, base),
                         kref.kmer_histogram_ref(text, nc, k, base),
                         f"kmer_histogram {name} k={k} {case}")
        codes = torch.zeros(n_win, dtype=torch.int64, device=cuda)
        for d in range(k):
            codes = codes * base + sp[d:d + n_win].to(torch.int64)
        bincount_ms = cuda_ms(lambda: torch.bincount(codes,
                                                     minlength=base**k))
        del codes
        b_ms, b_by = bound(*kmer_work(n_win, k, base))
        row = {"ms": cuda_ms(lambda: ops.kmer_histogram(sp, n_win, k, base)),
               "last_path": path, "bincount_ms": bincount_ms}
        kmer_rows[(name, k)] = row
        emit({"phase": "parity", "kernel": "kmer_histogram", "text": name,
              "n": n_win, "k": k, "bins": base**k, "max_abs_err": 0,
              "edge_cases": len(cases), **row,
              "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                  sp, n_win, k, base)),
              "bound_ms": b_ms, "bound_by": b_by})

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the earlier designs' nvcc runs beside the port's
        yard_future = pool.submit(lambda: {
            **gather_bench.build_baseline(YARDSTICK_DIR),
            **hist_lcp_bench.build_baseline(YARDSTICK_DIR)})
        compile_s = _build.build_all()
        yard = yard_future.result()
    t_build_kernels = time.perf_counter() - t0
    for name in _build.SOURCES:  # load every library once
        _build.library(name)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": t_build_kernels,
          "nvcc_s": compile_s, "build_dir": str(_build.build_dir()),
          "yardsticks": sorted(yard)})
    for name in _build.SOURCES:  # registers / spills from -Xptxas -v
        log = (_build.build_dir() / f"{name}.log")
        if log.exists():
            lines = [l.strip() for l in log.read_text().splitlines()
                     if "registers" in l or "spill" in l]
            emit({"phase": "ptxas", "kernel": name, "report": lines})
    dram_rt_ms = dram_round_trip_ms()
    emit({"phase": "dram_round_trip", "ms": dram_rt_ms,
          "note": "one thread's dependent __ldcg walk of a random cycle over "
                  "1 GiB, no line visited twice (csrc/dram_latency.cu), ms "
                  "per hop"})

    # ---- data -------------------------------------------------------------
    n = 1 << args.n_log2
    t0 = time.perf_counter()
    s, alpha = dataset("genome", n, seed=0)
    emit({"phase": "data", "dataset": "genome", "n": n,
          "t_generate_s": time.perf_counter() - t0})
    cfg = EraConfig()
    pt = packing.pack_text(s, alpha, extra=2 * cfg.w_max + 8, device=cuda)
    n_real = pt.n_real
    rng = np.random.default_rng(7)

    # ---- 2. kernel parity (exact) -----------------------------------------
    f = 1 << 20
    tail = np.arange(max(0, n_real - 255), n_real + 1)
    offs_np = np.concatenate([rng.integers(0, n_real + 1, size=f - tail.size),
                              tail]).astype(np.int32)
    offs = torch.from_numpy(offs_np).to(cuda)
    for w in (4, 8, 16, 32, 64, 128, 256):
        got = ops.range_gather_words(pt, offs, w)
        want = kref.range_gather_words_ref(pt, offs, w)
        assert_equal(got, want, f"range_gather_words w={w}")
        nw = got.shape[1]
        b_ms, b_by = bound(*gather_work(f, nw, pt.words.shape[0]))
        emit({"phase": "parity", "kernel": "range_gather_words", "rows": f,
              "w": w, "max_abs_err": 0,
              "ms": cuda_ms(lambda: ops.range_gather_words(pt, offs, w)),
              "plain_ms": cuda_ms(
                  lambda: kref.range_gather_words_ref(pt, offs, w)),
              "bound_ms": b_ms, "bound_by": b_by})
    gather_edges("range_gather_words", pt, n_real, pt.syms_per_word, "genome")
    gather_past_2_31("range_gather_words", pt, n_real,
                     16 * pt.syms_per_word, 16, "genome")

    b = 512
    m_pad = 64
    lengths_np = rng.integers(4, m_pad + 1, size=b).astype(np.int32)
    pos_np = rng.integers(0, n_real + 1, size=b).astype(np.int32)
    pos_np[-32:] = rng.integers(max(0, n_real - m_pad), n_real + 1, size=32)
    sym = rng.integers(0, len(alpha.symbols), size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 2):  # plant the suffix itself: verdict 0 or ±1 at $
        p = int(pos_np[i])
        seg = s[p:min(p + m_pad, n_real)]
        sym[i, :seg.size] = seg
    patterns = torch.from_numpy(sym).to(cuda)
    lengths = torch.from_numpy(lengths_np).to(cuda)
    pos = torch.from_numpy(pos_np).to(cuda)
    pat_d, mask_d = _pack_query_batch(pt, patterns, lengths)
    got = ops.pattern_probe_words(pt, pos, pat_d, mask_d, lengths)
    want = kref.pattern_probe_words_ref(pt, pos, pat_d, mask_d, lengths)
    assert_equal(got, want, "pattern_probe_words")
    b_ms, b_by = bound(*probe_work(b, pat_d.shape[1], pt.words.shape[0]))
    emit({"phase": "parity", "kernel": "pattern_probe_words", "rows": b,
          "m_pad": m_pad, "max_abs_err": 0,
          "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
          "ms": cuda_ms(lambda: ops.pattern_probe_words(
              pt, pos, pat_d, mask_d, lengths), inner=100),
          "plain_ms": cuda_ms(lambda: kref.pattern_probe_words_ref(
              pt, pos, pat_d, mask_d, lengths), inner=20),
          "bound_ms": b_ms, "bound_by": b_by})

    # pattern_probe_packed: byte-key rows over the DNA dense text, patterns
    # cut from the terminal-padded string so they carry the terminal code
    sp_dna = alpha.pad_string(s, extra=m_pad)
    sym_t = rng.integers(0, alpha.base, size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 2):
        sym_t[i] = sp_dna[pos_np[i]:pos_np[i] + m_pad]
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(sym_t).to(cuda), lengths, word=False)
    got = ops.pattern_probe_packed(pt, pos, pat_b, mask_b)
    want = kref.pattern_probe_packed_ref(pt, pos, pat_b, mask_b)
    assert_equal(got, want, "pattern_probe_packed")
    nw_dense = -(-m_pad // pt.syms_per_word)
    b_ms, b_by = bound(*probe_work(b, nw_dense, pt.words.shape[0]))
    emit({"phase": "parity", "kernel": "pattern_probe_packed", "rows": b,
          "m_pad": m_pad, "max_abs_err": 0,
          "terminal_rows": int((sym_t == alpha.terminal_code).any(1).sum()),
          "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
          "ms": cuda_ms(lambda: ops.pattern_probe_packed(
              pt, pos, pat_b, mask_b), inner=100),
          "plain_ms": cuda_ms(lambda: kref.pattern_probe_packed_ref(
              pt, pos, pat_b, mask_b), inner=20),
          "bound_ms": b_ms, "bound_by": b_by})
    del sp_dna
    fused_parity("genome", pt, s, alpha)

    s_pad = torch.from_numpy(np.concatenate(
        [s, np.full(8, alpha.terminal_code, np.uint8)])).to(cuda)
    n_win = len(s)
    for k in range(1, 7):
        kmer_parity("genome", s_pad, n_win, k, alpha.base)
    del offs, got, want, pat_d, mask_d, pat_b, mask_b
    torch.cuda.empty_cache()

    # range_gather_packed and suffix_lcp_words on the DNA (2-bit) build
    # text and a PROTEIN_CLASS (4-bit) text; the LCP pairs are neighbours
    # in the order of their 64-symbol keys (long shared prefixes), and
    # the offsets include the last n_real positions
    pc_alpha = ALPHABETS["protein_class"]
    dense_texts = {"genome": pt, "protein_class": packing.pack_text(
        synthetic_string(pc_alpha, n, seed=0, repeat_fraction=0.15),
        pc_alpha, extra=2 * cfg.w_max + 8, device=cuda),
        "byte": packing.pack_text(
            synthetic_string(ALPHABETS["byte"], min(n, 1 << 24), seed=0,
                             repeat_fraction=0.10),
            ALPHABETS["byte"], extra=2 * cfg.w_max + 8, device=cuda)}
    for name, ptx in dense_texts.items():
        nr = ptx.n_real
        # every BITS x NW template, offsets at and past n_real
        gather_edges("range_gather_packed", ptx, nr + 32, 4, name)
        if name == "genome":
            gather_past_2_31("range_gather_packed", ptx, nr, 64, 16, name)
        if name == "byte":  # the 8-bit words: suffix_lcp_words' bits 8 only
            lcp_word_cases(name, ptx, torch.from_numpy(np.concatenate(
                [rng.integers(0, nr + 1, size=f - 256),
                 np.arange(nr - 255, nr + 1)]).astype(np.int32)).to(cuda))
            continue
        if name == "protein_class":
            gather_edges("range_gather_words", ptx, nr, ptx.syms_per_word,
                         name)
        tail = np.arange(max(0, nr - 255), nr + 1)
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        for w in (4, 16, 64, 256):
            got = ops.range_gather_packed(ptx, offs, w)
            want = kref.range_gather_packed_ref(ptx, offs, w)
            assert_equal(got, want, f"range_gather_packed {name} w={w}")
            b_ms, b_by = bound(*gather_packed_work(f, w // 4, ptx.bits,
                                                   ptx.words.shape[0]))
            emit({"phase": "parity", "kernel": "range_gather_packed",
                  "text": name, "bits": ptx.bits, "rows": f, "w": w,
                  "max_abs_err": 0,
                  "ms": cuda_ms(lambda: ops.range_gather_packed(ptx, offs, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.range_gather_packed_ref(ptx, offs, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
        lcp_word_cases(name, ptx, offs)
    del dense_texts, ptx, offs, got, want
    torch.cuda.empty_cache()

    # byte-key kernels over the protein text (the build's padding) and a
    # BYTE-alphabet text (codes up to 255: hazard C5)
    t0 = time.perf_counter()
    s_prot, protein = dataset("protein", n, seed=0)
    n_byte = min(n, 1 << 24)
    s_byte, byte_alpha = dataset("byte", n_byte, seed=0)
    emit({"phase": "data", "dataset": "protein", "n": n,
          "byte_parity_n": n_byte, "t_generate_s": time.perf_counter() - t0})
    texts = {}
    for name, (sx, ax) in {"protein": (s_prot, protein),
                           "byte": (s_byte, byte_alpha)}.items():
        texts[name] = (sx, ax, torch.from_numpy(
            ax.pad_string(sx, extra=2 * cfg.w_max + 8)).to(cuda))
    for name, (sx, ax, sp) in texts.items():  # the partition's counts
        for k in range(1, 4 if name == "protein" else 3):
            kmer_parity(name, sp, len(sx), k, ax.base)
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        tail = np.concatenate([np.arange(nr - 255, nr + 1),
                               np.arange(nr + 1, sp.shape[0], 61)])
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        for w in (4, 8, 16, 32, 64, 128, 256):
            got = ops.range_gather_pack(sp, offs, w)
            want = kref.range_gather_pack_ref(sp, offs, w)
            assert_equal(got, want, f"range_gather_pack {name} w={w}")
            b_ms, b_by = bound(*gather_pack_work(f, w // 4, sp.shape[0]))
            emit({"phase": "parity", "kernel": "range_gather_pack",
                  "text": name, "rows": f, "w": w, "max_abs_err": 0,
                  "ms": cuda_ms(lambda: ops.range_gather_pack(sp, offs, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.range_gather_pack_ref(sp, offs, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
        del got, want
        gather_edges("range_gather_pack", sp, sp.shape[0] - 1, 4, name)
        if name == "protein":
            gather_past_2_31("range_gather_pack", sp, sp.shape[0] - 1, 64, 16,
                             name)

    pt_byte = packing.pack_text(s_byte, byte_alpha, extra=2 * cfg.w_max + 8,
                                device=cuda)
    gather_edges("range_gather_words", pt_byte, pt_byte.n_real,
                 pt_byte.syms_per_word, "byte")
    fused_parity("byte", pt_byte, s_byte, byte_alpha)
    del pt_byte

    # lcp_pairs on sorted byte-key rows: a repeated eighth of the offsets
    # gives identical neighbours, the byte text bytes >= 128
    sx, ax, sp = texts["byte"]
    base_offs = rng.integers(0, len(sx), size=f - f // 8)
    offs = torch.from_numpy(np.concatenate(
        [base_offs, base_offs[:f // 8]]).astype(np.int32)).to(cuda)
    for w in (4, 8, 16, 32, 64, 128, 256):
        keys = ops.range_gather_pack(sp, offs, w)
        nw = keys.shape[1]
        order = _stable_order(_pair_lanes(
            [packing.to_u64(keys[None, :, j]) for j in range(nw)]))[0]
        keys = keys[order].contiguous()
        prev = torch.cat([keys[:1], keys[:-1]]).contiguous()
        got = ops.lcp_pairs(prev, keys, w)
        want = kref.lcp_pairs_ref(prev, keys, w)
        for g, x, part in zip(got, want, ("lcp", "c1", "c2")):
            assert_equal(g, x, f"lcp_pairs {part} w={w}")
        b_ms, b_by = bound(*lcp_work(f, nw))
        emit({"phase": "parity", "kernel": "lcp_pairs", "rows": f, "w": w,
              "max_abs_err": 0, "equal_rows": int((got[0] == w).sum()),
              "high_byte_rows": int(((got[1] >= 128) | (got[2] >= 128)).sum()),
              "ms": cuda_ms(lambda: ops.lcp_pairs(prev, keys, w)),
              "plain_ms": cuda_ms(lambda: kref.lcp_pairs_ref(prev, keys, w)),
              "bound_ms": b_ms, "bound_by": b_by})
    del keys, prev, got, want, order

    # pattern_probe: 512 rows of lengths 4-64 on each text, suffixes
    # running into the terminal
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        sp_np = ax.pad_string(sx, extra=m_pad)
        pos_np = rng.integers(0, nr + 1, size=b).astype(np.int32)
        pos_np[-32:] = rng.integers(max(0, nr - m_pad), nr + 1, size=32)
        sym = rng.integers(0, len(ax.symbols), size=(b, m_pad)).astype(np.int32)
        for i in range(0, b, 2):
            sym[i] = sp_np[pos_np[i]:pos_np[i] + m_pad]
        pos = torch.from_numpy(pos_np).to(cuda)
        pat_b, mask_b = _pack_query_batch(
            None, torch.from_numpy(sym).to(cuda), lengths, word=False)
        got = ops.pattern_probe(sp, pos, pat_b, mask_b)
        want = kref.pattern_probe_ref(sp, pos, pat_b, mask_b)
        assert_equal(got, want, f"pattern_probe {name}")
        b_ms, b_by = bound(*probe_bytes_work(b, m_pad // 4, sp.shape[0]))
        emit({"phase": "parity", "kernel": "pattern_probe", "text": name,
              "rows": b, "m_pad": m_pad, "max_abs_err": 0,
              "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
              "ms": cuda_ms(lambda: ops.pattern_probe(sp, pos, pat_b, mask_b),
                            inner=100),
              "plain_ms": cuda_ms(lambda: kref.pattern_probe_ref(
                  sp, pos, pat_b, mask_b), inner=20),
              "bound_ms": b_ms, "bound_by": b_by})
    # suffix_lcp_pairs on the protein text and the byte text (codes >=
    # 128), neighbour pairs in key order and the last positions
    slcp = ops.KERNELS["suffix_lcp_pairs"]
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        tail = np.arange(nr - 255, nr + 1)
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        pa, pb = sorted_pairs(ops.range_gather_pack(sp, offs, 64), offs)
        for w in (4, 64, 256):
            got = slcp(sp, pa, pb, w)
            want = kref.suffix_lcp_pairs_ref(sp, pa, pb, w)
            assert_equal(got, want, f"suffix_lcp_pairs {name} w={w}")
            b_ms, b_by = bound(*suffix_lcp_work(got, w, 4, sp.shape[0], 8))
            emit({"phase": "parity", "kernel": "suffix_lcp_pairs",
                  "text": name, "rows": pa.shape[0], "w": w,
                  "max_abs_err": 0, "saturated_rows": int((got == w).sum()),
                  "ms": cuda_ms(lambda: slcp(sp, pa, pb, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.suffix_lcp_pairs_ref(sp, pa, pb, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
    del pa, pb
    del texts, offs, got, want, pat_b, mask_b, s_byte, sp
    torch.cuda.empty_cache()

    # ---- 3-5. the DNA path (build, check, serving; counted) ----------------
    ops.reset_launch_counts()
    pack_text_dense.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    dev = EraIndexer(alpha, cfg).build_device(s, report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    after_build = counts_now()
    emit({"phase": "build", "dataset": "genome", "n": n,
          "memory_bytes": cfg.memory_bytes, "f_max": cfg.f_max,
          "t_total_s": t_build, "t_vertical_s": report.t_vertical,
          "t_prepare_s": report.t_prepare,
          "scans": report.vertical.scans,
          "iterations": report.prepare.iterations,
          "ranges": report.prepare.ranges,
          "active_history": report.prepare.active_history,
          "groups": report.n_groups, "prefixes": report.n_prefixes,
          "capacity": report.capacity, "n_subtrees": dev.n_subtrees,
          "k_route": dev.k_route, "n_iter": dev.n_iter,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": after_build,
          "pack_text_dense_launches": pack_text_dense.launches})
    # the dense text packed on the card twice: construction and serving
    require_packs(pack_text_dense.launches, 2, "the DNA build")
    t_prepare, build_counts = {"genome": report.t_prepare}, after_build
    # the one-shot index's host arrays, which the fabric phases compare with
    one_shot = {"genome": {**flat_of(dev), "t_prepare_s": report.t_prepare,
                           "iterations": report.prepare.iterations}}
    s_dev = torch.from_numpy(s).to(cuda)
    qrng = np.random.default_rng(11)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(alpha.symbols))
    emit({"phase": "check", "dataset": "genome",
          **check_index(dev, s, s_dev, pats, "genome"),
          "launches": counts_now()})
    stats = serve_index(dev, s, alpha, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    dna_counts = counts_now()
    emit({"phase": "serving", "dataset": "genome", **stats,
          "launches": dna_counts,
          "pack_text_dense_launches": pack_text_dense.launches})
    require_launches(dna_counts, DNA_KERNELS, "the DNA path")
    require_packs(pack_text_dense.launches, 2, "the DNA build and serving")
    for name in ("range_gather_words", "kmer_histogram"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the build")
    if dna_counts["search_bounds_words"] <= after_build["search_bounds_words"]:
        raise AssertionError("the search never launched search_bounds_words")
    if dna_counts["pattern_probe_words"]:
        raise AssertionError("the DNA path launched the single-step probe")
    search_batch_launches(lambda: dev.find_batch_ranges(
        *dev.pad_batch(pats)), "search_bounds_words", "genome find_batch")

    # ---- 4b. the DNA terminal-bearing batch (counted) ----------------------
    term = alpha.terminal_code
    tpats = [np.asarray(s[len(s) - k:]) for k in (1, 2, 3, 5, 9, 17, 24)]
    tpats += [np.array([c, term], np.uint8) for c in range(term)]
    tpats += make_workload(s, qrng, batch=8, min_len=4, max_len=24,
                           planted_frac=0.7, n_symbols=len(alpha.symbols))
    ops.reset_launch_counts()
    term_check = check_index(dev, s, s_dev, tpats, "genome terminal batch")
    term_counts = counts_now()
    emit({"phase": "check", "dataset": "genome", "batch": "terminal-bearing",
          **term_check, "launches": term_counts})
    require_launches(term_counts, TERMINAL_KERNELS, "the terminal batch")
    if (term_counts["pattern_probe_words"]
            or term_counts["search_bounds_words"]):
        raise AssertionError("a terminal-bearing batch took the word probe")
    for name in PACKED_STEPS:
        if term_counts[name]:
            raise AssertionError(f"{name} was launched on the terminal batch")
    search_batch_launches(lambda: dev.find_batch_ranges(
        *dev.pad_batch(tpats)), "search_bounds_packed",
        "genome terminal find_batch")

    # ---- 5b. find-and-fetch and the serving stack on the DNA index ---------
    frng = np.random.default_rng(17)
    ff_pats = make_workload(s, frng, batch=256, min_len=4, max_len=24,
                            planted_frac=0.7, n_symbols=len(alpha.symbols))
    ff_check, ff_counts = check_find_fetch(dev, s_dev, ff_pats,
                                           "genome find_fetch")
    emit({"phase": "find_fetch", "dataset": "genome", **ff_check,
          "launches": ff_counts})
    require_fetch(ff_counts, "genome", "the genome find-and-fetch path")
    emit({"phase": "find_fetch_latency", "dataset": "genome",
          "batch": len(ff_pats), **fetch_latency(dev, ff_pats)})
    ff_check, tff_counts = check_find_fetch(dev, s_dev, tpats,
                                            "genome terminal fetch")
    emit({"phase": "find_fetch", "dataset": "genome",
          "batch": "terminal-bearing", **ff_check, "launches": tff_counts})
    require_fetch(tff_counts, "terminal", "the terminal-bearing fetch")
    search_batch_launches(lambda: dev.find_fetch_ranges(
        *dev.pad_batch(tpats), fetch=FETCH), "search_fetch_packed",
        "genome terminal find_fetch")
    # a served terminal-bearing batch: the patterns above repeated to 256
    tpats256 = (tpats * (256 // len(tpats) + 1))[:256]
    emit({"phase": "find_fetch_latency", "dataset": "genome",
          "batch": len(tpats256), "patterns": "terminal-bearing",
          **fetch_latency(dev, tpats256)})
    dna_serve_counts = serving_stack(dev, s, alpha, "genome")
    require_fetch(dna_serve_counts[FETCH], "genome",
                  "the genome serving stack")

    # the fused kernels at the find-and-fetch shape (a served batch of 256,
    # fetch 32, at each pattern's lower-bound suffix) and at 2^20 rows
    fetch_rows = []
    big = 1 << 20
    for kind, pats_b, replaces in (
            ("words", ff_pats, "src/repro/kernels/probe_gather.py:80"),
            ("packed", (tpats * 14)[:256],
             "src/repro/kernels/probe_gather.py:174")):
        padded, lens, route = dev.pad_batch(pats_b)
        lens_t = torch.from_numpy(lens).to(cuda)
        start, _ = dev.find_batch_ranges(padded, lens, route)
        pos0 = dev.ell[torch.clamp(start, 0, dev.n_leaves - 1)]
        pat, mask = _pack_query_batch(dev.s_text,
                                      torch.from_numpy(padded).to(cuda),
                                      lens_t, kind == "words")
        row = fused_case(kind, dev.s_text, pos0, pat, mask, lens_t, FETCH,
                         inner=100)
        reps = big // pos0.shape[0]
        pos_l = dev.ell[torch.randint(0, dev.n_leaves, (big,), device=cuda)]
        large = fused_case(kind, dev.s_text, pos_l, pat.repeat(reps, 1),
                           mask.repeat(reps, 1), lens_t.repeat(reps), FETCH,
                           inner=1)
        shape = lambda r: (f"rows={r['rows']} nw_pat={r['nw_pat']} "
                           f"fetch={FETCH}")
        fetch_rows.append({
            "name": f"probe_gather_{kind}", "replaces": replaces,
            "shape": shape(row), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "two_launch_ms": row["two_launch_ms"],
            "large": {"shape": shape(large), **{
                k: large[k] for k in ("ms", "plain_ms", "two_launch_ms",
                                      "bound_ms", "bound_by")}}})
    del pos0, pos_l, pat, mask, lens_t

    # ---- 6a. DNA kernels at the main path's shapes -------------------------
    rows = []
    # range_gather_words: the first elastic step reads w = 4 symbols after
    # every suffix; ell holds all n + 1 of them, in suffix-array order
    ell = dev.ell
    got = ops.range_gather_words(pt, ell, 4)
    want = kref.range_gather_words_ref(pt, ell, 4)
    assert_equal(got, want, "range_gather_words (main-path shape)")
    b_ms, b_by = bound(*gather_work(ell.shape[0], got.shape[1],
                                    pt.words.shape[0]))
    ell_sorted = torch.sort(ell).values
    rows.append({"name": "range_gather_words",
                 "replaces": "src/repro/kernels/packed_gather.py:265",
                 "shape": f"rows={ell.shape[0]} w=4", "rows": ell.shape[0],
                 "ms": cuda_ms(lambda: ops.range_gather_words(pt, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_words_ref(pt, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "sorted_offsets_ms": cuda_ms(
                     lambda: ops.range_gather_words(pt, ell_sorted, 4)),
                 "l2_window": l2_window_row(
                     lambda: ops.range_gather_words(pt, ell, 4), pt.words)})
    del got, want, ell_sorted
    # pattern_probe_words: one search step of a served batch (2B rows)
    pats = make_workload(s, qrng, batch=256, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(alpha.symbols))
    padded, lens, _ = dev.pad_batch(pats)
    padded_t = torch.from_numpy(padded).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    pat_w, mask_w = _pack_query_batch(dev.s_text, padded_t, lens_t)
    pat2 = torch.cat([pat_w, pat_w])
    mask2 = torch.cat([mask_w, mask_w])
    len2 = torch.cat([lens_t, lens_t])
    pos2 = ell[torch.randint(0, ell.shape[0], (pat2.shape[0],), device=cuda)]
    got = ops.pattern_probe_words(dev.s_text, pos2, pat2, mask2, len2)
    want = kref.pattern_probe_words_ref(dev.s_text, pos2, pat2, mask2, len2)
    assert_equal(got, want, "pattern_probe_words (main-path shape)")
    b_ms, b_by = bound(*probe_work(pat2.shape[0], pat2.shape[1],
                                   dev.s_text.words.shape[0]))
    rows.append({"name": "pattern_probe_words",
                 "replaces": "src/repro/kernels/packed_gather.py:335",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe_words(
                     dev.s_text, pos2, pat2, mask2, len2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_words_ref(
                     dev.s_text, pos2, pat2, mask2, len2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    # pattern_probe_packed: one search step of a served terminal-bearing
    # batch (2B rows of byte keys over the served dense text)
    padded, lens, _ = dev.pad_batch(tpats256)
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(padded).to(cuda),
        torch.from_numpy(lens).to(cuda), word=False)
    pat2 = torch.cat([pat_b, pat_b])
    mask2 = torch.cat([mask_b, mask_b])
    got = ops.pattern_probe_packed(dev.s_text, pos2, pat2, mask2)
    want = kref.pattern_probe_packed_ref(dev.s_text, pos2, pat2, mask2)
    assert_equal(got, want, "pattern_probe_packed (main-path shape)")
    b_ms, b_by = bound(*probe_work(
        pat2.shape[0], -(-pat2.shape[1] * 4 // dev.s_text.syms_per_word),
        dev.s_text.words.shape[0]))
    rows.append({"name": "pattern_probe_packed",
                 "replaces": "src/repro/kernels/packed_gather.py:159",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe_packed(
                     dev.s_text, pos2, pat2, mask2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_packed_ref(
                     dev.s_text, pos2, pat2, mask2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    rows.append(search_parity("words", dev, s, alpha, "genome"))
    rows.append(fetch_parity("words", dev, s, alpha, "genome"))
    # byte keys on the dense genome text: the served terminal-bearing batch
    rows.append(search_parity("packed", dev, s, alpha, "genome",
                              serving=tpats256))
    rows.append(fetch_parity("packed", dev, s, alpha, "genome",
                             serving=tpats256))
    # ... and on 4- and 8-bit dense indexes (protein_class, and protein
    # packed dense) at 2^20, every case, untimed
    for a_name, bits in (("protein_class", 4), ("protein", 8)):
        ax = ALPHABETS[a_name]
        sx = synthetic_string(ax, min(n, 1 << 20), seed=3,
                              repeat_fraction=0.15)
        dx = EraIndexer(ax, cfg).build_device(sx, packing="dense")
        if not (dx.packed and dx.s_text.bits == bits):
            raise AssertionError(f"{a_name}: not a {bits}-bit dense index")
        search_parity("packed", dx, sx, ax, f"{a_name} {bits}-bit",
                      timed=False)
        fetch_parity("packed", dx, sx, ax, f"{a_name} {bits}-bit",
                     timed=False)
        del dx, sx
    # kmer_histogram: the deepest kernel-counted DNA partition scan (t = 6)
    k = 6
    b_ms, b_by = bound(*kmer_work(n_win, k, alpha.base))
    rows.append({"name": "kmer_histogram",
                 "replaces": "src/repro/kernels/kmer_histogram.py:46",
                 "shape": f"n={n_win} k={k}",
                 "ms": cuda_ms(lambda: ops.kmer_histogram(
                     s_pad, n_win, k, alpha.base)),
                 "last_path": ops.kmer_histogram.last_path,
                 "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                     s_pad, n_win, k, alpha.base)),
                 "bound_ms": b_ms, "bound_by": b_by})
    del dev, ell, pt, s_dev, s_pad, got, want, pos2, pat2, mask2, len2
    torch.cuda.empty_cache()
    profiles = {"genome": build_profile("genome", s, alpha,
                                        t_prepare["genome"], build_counts)}

    # ---- 3-5. the protein path (build, check, serving; counted) ------------
    s_dna = s
    s = s_prot
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    dev = EraIndexer(protein, cfg).build_device(s, report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    after_build = counts_now()
    emit({"phase": "build", "dataset": "protein", "n": n,
          "memory_bytes": cfg.memory_bytes, "f_max": cfg.f_max,
          "t_total_s": t_build, "t_vertical_s": report.t_vertical,
          "t_prepare_s": report.t_prepare,
          "scans": report.vertical.scans,
          "iterations": report.prepare.iterations,
          "ranges": report.prepare.ranges,
          "active_history": report.prepare.active_history,
          "groups": report.n_groups, "prefixes": report.n_prefixes,
          "capacity": report.capacity, "n_subtrees": dev.n_subtrees,
          "k_route": dev.k_route, "n_iter": dev.n_iter,
          "packed": dev.packed, "string_nbytes": dev.string_nbytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": after_build})
    t_prepare["protein"] = report.t_prepare
    one_shot["protein"] = {**flat_of(dev), "t_prepare_s": report.t_prepare,
                           "iterations": report.prepare.iterations}
    for name in ("kmer_histogram", "range_gather_pack", "lcp_pairs"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the "
                                 f"protein build")
    s_dev = torch.from_numpy(s).to(cuda)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(protein.symbols))
    emit({"phase": "check", "dataset": "protein",
          **check_index(dev, s, s_dev, pats, "protein"),
          "launches": counts_now()})
    stats = serve_index(dev, s, protein, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    prot_counts = counts_now()
    emit({"phase": "serving", "dataset": "protein", **stats,
          "launches": prot_counts})
    require_launches(prot_counts, PROTEIN_KERNELS, "the protein path")
    if prot_counts["search_bounds_bytes"] <= after_build["search_bounds_bytes"]:
        raise AssertionError("the protein search never launched "
                             "search_bounds_bytes")
    if prot_counts["pattern_probe"]:
        raise AssertionError("the protein path launched the single-step probe")
    search_batch_launches(lambda: dev.find_batch_ranges(
        *dev.pad_batch(pats)), "search_bounds_bytes", "protein find_batch")
    ff_pats = make_workload(s, frng, batch=256, min_len=4, max_len=24,
                            planted_frac=0.7, n_symbols=len(protein.symbols))
    ff_check, prot_ff_counts = check_find_fetch(dev, s_dev, ff_pats,
                                                "protein find_fetch")
    emit({"phase": "find_fetch", "dataset": "protein", **ff_check,
          "launches": prot_ff_counts})
    require_fetch(prot_ff_counts, "protein", "the protein find-and-fetch path")
    emit({"phase": "find_fetch_latency", "dataset": "protein",
          "batch": len(ff_pats), **fetch_latency(dev, ff_pats)})
    prot_serve_counts = serving_stack(dev, s, protein, "protein")
    require_fetch(prot_serve_counts[FETCH], "protein",
                  "the protein serving stack")
    del s_dev

    # ---- 6b. protein kernels at the main path's shapes ---------------------
    # range_gather_pack + lcp_pairs: the first elastic step reads w = 4
    # symbols after every suffix from the build's padded text; in ell
    # (suffix-array) order the keys are sorted, as after the step's sort
    sp = EraIndexer(protein, cfg)._pad(s)
    ell = dev.ell
    got = ops.range_gather_pack(sp, ell, 4)
    want = kref.range_gather_pack_ref(sp, ell, 4)
    assert_equal(got, want, "range_gather_pack (main-path shape)")
    b_ms, b_by = bound(*gather_pack_work(ell.shape[0], 1, sp.shape[0]))
    # the same rows at 4-aligned offsets: what the unaligned reads cost
    ell_aligned = ell & ~3
    rows.append({"name": "range_gather_pack",
                 "replaces": "src/repro/kernels/range_gather.py:44",
                 "shape": f"rows={ell.shape[0]} w=4", "rows": ell.shape[0],
                 "ms": cuda_ms(lambda: ops.range_gather_pack(sp, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_pack_ref(sp, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "aligned_offsets_ms": cuda_ms(
                     lambda: ops.range_gather_pack(sp, ell_aligned, 4)),
                 "l2_window": l2_window_row(
                     lambda: ops.range_gather_pack(sp, ell, 4), sp)})
    # the untried fix of ROADMAP queue B: sort the positions first (the
    # gather on sorted rows, and the sort itself with its permutation)
    ell_sorted = torch.sort(ell).values
    rows[-1].update(
        sorted_offsets_ms=cuda_ms(
            lambda: ops.range_gather_pack(sp, ell_sorted, 4)),
        sort_ms=cuda_ms(lambda: torch.sort(ell), reps=3))
    del ell_aligned, ell_sorted
    keys = got
    prev = torch.cat([keys[:1], keys[:-1]]).contiguous()
    del want
    got = ops.lcp_pairs(prev, keys, 4)
    want = kref.lcp_pairs_ref(prev, keys, 4)
    for g, x, part in zip(got, want, ("lcp", "c1", "c2")):
        assert_equal(g, x, f"lcp_pairs {part} (main-path shape)")
    b_ms, b_by = bound(*lcp_work(keys.shape[0], 1))
    rows.append({"name": "lcp_pairs",
                 "replaces": "src/repro/kernels/lcp.py:47",
                 "shape": f"rows={keys.shape[0]} w=4",
                 "ms": cuda_ms(lambda: ops.lcp_pairs(prev, keys, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.lcp_pairs_ref(prev, keys, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    del got, want, keys, prev, sp
    # pattern_probe: one search step of a served batch (2B rows)
    pats = make_workload(s, qrng, batch=256, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(protein.symbols))
    padded, lens, _ = dev.pad_batch(pats)
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(padded).to(cuda),
        torch.from_numpy(lens).to(cuda), word=False)
    pat2 = torch.cat([pat_b, pat_b])
    mask2 = torch.cat([mask_b, mask_b])
    pos2 = ell[torch.randint(0, ell.shape[0], (pat2.shape[0],), device=cuda)]
    got = ops.pattern_probe(dev.s_text, pos2, pat2, mask2)
    want = kref.pattern_probe_ref(dev.s_text, pos2, pat2, mask2)
    assert_equal(got, want, "pattern_probe (main-path shape)")
    b_ms, b_by = bound(*probe_bytes_work(pat2.shape[0], pat2.shape[1],
                                         dev.s_text.shape[0]))
    rows.append({"name": "pattern_probe",
                 "replaces": "src/repro/kernels/pattern_probe.py:57",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe(
                     dev.s_text, pos2, pat2, mask2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_ref(
                     dev.s_text, pos2, pat2, mask2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    rows.append(search_parity("bytes", dev, s, protein, "protein"))
    rows.append(fetch_parity("bytes", dev, s, protein, "protein"))

    del dev, ell, got, want, pos2, pat2, mask2
    torch.cuda.empty_cache()
    profiles["protein"] = build_profile("protein", s, protein,
                                        t_prepare["protein"], after_build)

    # ---- 6c. the out-of-core stream build per dataset (counted) -----------
    def write_fasta(path: Path, sx: np.ndarray, ax) -> None:
        """``sx`` as FASTA_RECORDS records of 80-column lines, each under
        a header and a ``;`` comment; record 1 in lower case, record 2
        with ``N`` for every first symbol (the reader maps both back)."""
        chars = np.frombuffer(ax.symbols.encode(), np.uint8)[sx[:-1]]
        edges = np.linspace(0, chars.size, FASTA_RECORDS + 1).astype(int)
        with open(path, "wb") as f:
            for r, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
                rec = chars[lo:hi].copy()
                if r == 1:
                    rec = np.frombuffer(rec.tobytes().lower(), np.uint8)
                if r == 2:
                    rec[rec == ord(ax.symbols[0])] = ord("N")
                full = rec.size // 80
                lines = np.full((full, 81), ord("\n"), np.uint8)
                lines[:, :80] = rec[:full * 80].reshape(full, 80)
                f.write(f">record{r} synthetic\n;seed 0\n".encode())
                f.write(lines.tobytes())
                if rec.size > full * 80:
                    f.write(rec[full * 80:].tobytes() + b"\n")
                f.write(b"\n")

    def prepare_peak(ix, sx: np.ndarray, budget=None, mesh=None) -> dict:
        """``max_memory_allocated`` around the prepare stage alone: the
        partition and the device text first, then a reset of the peak,
        then ``subtree_prepare_batch`` (``budget`` and ``mesh`` None),
        ``subtree_prepare_stream`` or ``fabric.sharded_prepare`` over
        ``mesh``; bytes resident before it beside."""
        groups = ix.partition(sx)
        cap = ix._capacity(groups)
        text = ix._device_text(sx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if mesh is not None:
            state = fabric.sharded_prepare(text, groups, cap,
                                           ix.config.elastic_config(),
                                           mesh=mesh)
            torch.cuda.synchronize()
        elif budget is None:
            state = subtree_prepare_batch(text, groups, cap,
                                          ix.config.elastic_config())
            torch.cuda.synchronize()
        else:
            state, _ = subtree_prepare_stream(
                text, groups, cap, ix.config.elastic_config(),
                device_budget=budget)
        t = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del state, text, groups
        return {"max_memory_allocated": peak, "resident_before": resident,
                "t_prepare_s": t}

    def whole_build(fn) -> tuple:
        """``fn()``'s result, seconds and ``max_memory_allocated`` around
        it (the peak reset first), with the launches it made, counted
        from 0."""
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        return out, t, {"max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                        "resident_before": resident}, counts_now()

    def stream_phase(name: str, sx: np.ndarray, ax,
                     overlaps=(True, False), prepare_peaks: bool = True):
        """``build_stream`` at G x state_bytes_per_group(F) // 8 of device
        budget (about 16 chunks double-buffered), once per ``overlap``,
        each index equal to the one-shot ``build_device`` (seven fields
        and ``find_batch``); the peaks of the whole builds and, with
        ``prepare_peaks``, of the prepare stages alone, beside the
        one-shot's taken the same way.  Returns (the one-shot index, the
        indexer, the stream runs' launch counts)."""
        ix = EraIndexer(ax, cfg)
        report = BuildReport(VerticalStats(), PrepareStats())
        one_shot, t_one, mem_one, _ = whole_build(
            lambda: ix.build_device(sx, report))
        one = {"t_total_s": t_one, "t_vertical_s": report.t_vertical,
               "t_prepare_s": report.t_prepare, **mem_one}
        groups_n, cap = report.n_groups, report.capacity
        budget = groups_n * iomodel.state_bytes_per_group(cap) // 8
        pats = make_workload(sx, np.random.default_rng(41), batch=64,
                             min_len=8, max_len=24, planted_frac=0.7,
                             n_symbols=len(ax.symbols))
        want_found = one_shot.find_batch(pats)
        runs, counts = {}, []
        for overlap in overlaps:
            rep = BuildReport(VerticalStats(), PrepareStats())
            (dev, srep), t_all, mem, got = whole_build(
                lambda: ix.build_stream(sx, rep, device_budget=budget,
                                        overlap=overlap))
            for field in STREAM_FIELDS:
                if not torch.equal(getattr(one_shot, field),
                                   getattr(dev, field)):
                    raise AssertionError(f"{name} stream (overlap="
                                         f"{overlap}): {field} differs "
                                         f"from the one-shot build")
            for a_, b_ in zip(want_found, dev.find_batch(pats)):
                if not np.array_equal(a_, b_):
                    raise AssertionError(f"{name} stream (overlap="
                                         f"{overlap}): find_batch differs")
            require_launches(got, STREAM_KERNELS[name],
                             f"the {name} stream build")
            plan = iomodel.plan_stream(groups_n, cap, budget_bytes=budget,
                                       double_buffer=overlap)
            runs["overlap" if overlap else "sync"] = {
                "n_chunks": srep.n_chunks,
                "groups_per_chunk": plan.groups_per_chunk,
                "plan_peak_bytes": plan.peak_bytes,
                "t_prepare_s": rep.t_prepare, "t_total_s": t_all,
                "t_vertical_s": rep.t_vertical,
                "iterations": srep.iterations,
                "chunk_iters_max": max(srep.chunk_iters),
                "bytes_copied": srep.bytes_copied, "copy_s": srep.copy_s,
                "copy_hidden_s": srep.copy_hidden_s,
                "copy_wait_s": srep.copy_wait_s,
                "overlap_frac": srep.overlap_frac, **mem,
                "equal_to_one_shot": True, "launches": got}
            counts.append(got)
            del dev
        row = {"phase": "stream", "dataset": name, "n": len(sx) - 1,
               "groups": groups_n, "capacity": cap,
               "device_budget": budget, "one_shot": one, "runs": runs}
        if prepare_peaks:
            gc.collect()
            torch.cuda.empty_cache()
            row["prepare_stage"] = {
                "one_shot": prepare_peak(ix, sx),
                "stream": prepare_peak(ix, sx, budget)}
            st = row["prepare_stage"]
            row["prepare_peak_ratio"] = (
                st["stream"]["max_memory_allocated"]
                / st["one_shot"]["max_memory_allocated"])
        emit(row)
        if groups_n >= 16:  # a budget that splits: the stream's contract
            if runs[next(iter(runs))]["n_chunks"] < 8:
                raise AssertionError(f"{name} stream: fewer than 8 chunks")
            if "overlap" in runs and runs["overlap"]["overlap_frac"] <= 0.5:
                raise AssertionError(f"{name} stream: overlap_frac "
                                     f"{runs['overlap']['overlap_frac']}")
            if prepare_peaks and row["prepare_peak_ratio"] >= 0.5:
                raise AssertionError(f"{name} stream: the prepare-stage peak"
                                     f" is not below half the one-shot's")
        return one_shot, ix, counts

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fasta = Path(tmp) / "genome.fa"
        write_fasta(fasta, s_dna, alpha)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        s_fa = load_fasta(str(fasta), alpha)
        t_read = time.perf_counter() - t0
        if not np.array_equal(s_fa, s_dna):
            raise AssertionError("load_fasta does not give back the codes")
        emit({"phase": "fasta", "dataset": "genome", "n": len(s_fa) - 1,
              "records": FASTA_RECORDS, "file_bytes": fasta.stat().st_size,
              "t_write_s": t_write, "t_load_fasta_s": t_read,
              "equal_to_codes": True})
    dna_index, dna_ix, stream_counts = stream_phase("genome", s_fa, alpha)
    del s_fa
    _, _, prot_stream_counts = stream_phase(
        "protein", s_prot, protein, overlaps=(True,), prepare_peaks=False)
    stream_counts += prot_stream_counts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6d. append to the genome index, swap it into a server (counted) ---
    arng = np.random.default_rng(3)  # the JAX tests' ``_appended`` rule
    s_new = np.concatenate([s_dna[:-1], arng.integers(
        0, alpha.base - 1, size=1 << APPEND_LOG2, dtype=np.uint8),
        s_dna[-1:]])
    (dna_index2, arep), t_append, mem_append, append_counts = whole_build(
        lambda: dna_ix.append_device(dna_index, s_new))
    full_report = BuildReport(VerticalStats(), PrepareStats())
    full, t_full, mem_full, _ = whole_build(
        lambda: dna_ix.build_device(s_new, full_report))
    for field in STREAM_FIELDS:
        if not torch.equal(getattr(full, field), getattr(dna_index2, field)):
            raise AssertionError(f"append: {field} differs from a rebuild")
    if not np.array_equal(full.string_codes(), dna_index2.string_codes()):
        raise AssertionError("append: string_codes differs from a rebuild")
    if dna_index2.epoch != dna_index.epoch + 1:
        raise AssertionError("append: the epoch did not advance by one")
    require_launches(append_counts, ("search_bounds_words",
                                     "range_gather_words"), "the append")
    emit({"phase": "append", "dataset": "genome", "n_old": len(s_dna) - 1,
          "appended": 1 << APPEND_LOG2,
          **{k: getattr(arep, k) for k in (
              "n_old", "n_new", "b_star", "n_prefixes", "n_affected",
              "leaves_rebuilt", "leaves_reused", "partition_fallback",
              "t_scan", "t_partition", "t_prepare", "t_merge")},
          "t_total_report_s": arep.t_total, "reuse_frac": arep.reuse_frac,
          "t_append_s": t_append, **{f"append_{k}": v
                                     for k, v in mem_append.items()},
          "rebuild": {"t_total_s": t_full,
                      "t_vertical_s": full_report.t_vertical,
                      "t_prepare_s": full_report.t_prepare, **mem_full},
          "epoch": dna_index2.epoch, "equal_to_rebuild": True,
          "launches": append_counts})
    serve_cfg = ServeConfig(pipeline=True, cache_size=4096, max_batch=256)
    swap_pats = make_workload(s_new, np.random.default_rng(43), batch=256,
                              min_len=12, max_len=24, planted_frac=0.7,
                              n_symbols=len(alpha.symbols))
    swap_pats += [s_new[len(s_new) - 1 - k:len(s_new) - 1]
                  for k in (12, 16, 20)]  # the appended tail
    srv = AsyncServer(dna_index, serve_cfg)
    srv.serve(swap_pats)
    warm = len(srv.cache)
    info = srv.update_index(dna_index2)
    if not (info["flushed"] and info["epoch"] == dna_index.epoch + 1
            and len(srv.cache) == 0 and warm > 0):
        raise AssertionError(f"update_index did not flush: {info}")
    got = srv.serve(swap_pats)
    want = AsyncServer(full, serve_cfg).serve(swap_pats)
    for (a_, _), (b_, _) in zip(got, want):
        if not np.array_equal(a_, b_):
            raise AssertionError("the swapped server disagrees with a fresh "
                                 "server over the rebuild")
    emit({"phase": "append_swap", "dataset": "genome", **info,
          "cache_before_swap": warm, "requests": len(swap_pats),
          "equal_to_fresh_server": True})
    appended = {**flat_of(dna_index2), "epoch": dna_index2.epoch,
                "s_new": s_new, "report": arep}
    del srv, dna_index, dna_index2, full, got, want, s_new
    gc.collect()
    torch.cuda.empty_cache()

    # a byte-layout genome archive migrated to dense storage in place
    s_mig, _ = dataset("genome", 1 << min(MIGRATE_LOG2, args.n_log2), seed=1)
    ix_mig = EraIndexer(alpha, cfg)
    dev_b = ix_mig.build_device(s_mig, packing="bytes")
    dense = ix_mig.build_device(s_mig, packing="dense")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "genome_bytes")
        dev_b.save(path)
        t0 = time.perf_counter()
        first = migrate_archive(path)
        t_mig = time.perf_counter() - t0
        second = migrate_archive(path)
        mig = DeviceIndex.load(path)
    if not (first is True and second is False and mig.packed):
        raise AssertionError(f"migrate_archive returned {first}, {second}")
    if not torch.equal(mig.s_text.words, dense.s_text.words):
        raise AssertionError("the migrated words differ from a dense build")
    for field in STREAM_FIELDS:
        if not torch.equal(getattr(mig, field), getattr(dense, field)):
            raise AssertionError(f"migrated archive: {field} differs")
    mig_pats = make_workload(s_mig, np.random.default_rng(47), batch=64,
                             min_len=4, max_len=24, planted_frac=0.7,
                             n_symbols=len(alpha.symbols))
    for a_, b_, c_ in zip(mig.find_batch(mig_pats),
                          dense.find_batch(mig_pats),
                          dev_b.find_batch(mig_pats)):
        if not (np.array_equal(a_, b_) and np.array_equal(a_, c_)):
            raise AssertionError("the migrated archive answers differently")
    emit({"phase": "migrate", "dataset": "genome", "n": len(s_mig) - 1,
          "migrated": first, "second_call": second, "t_migrate_s": t_mig,
          "equal_to_dense_build": True})
    del dev_b, dense, mig, s_mig
    torch.cuda.empty_cache()

    # ---- 6e. the sharded fabric on the one card (counted) -----------------
    # four shards on cuda:0: the mesh repeats the one card
    mesh = [torch.device("cuda", 0)] * FABRIC_ENTRIES
    fabric_idx, fabric_one, fabric_counts = {}, {}, []
    for name, sx, ax in (("genome", s_dna, alpha),
                         ("protein", s_prot, protein)):
        ix = EraIndexer(ax, cfg)
        rep = BuildReport(VerticalStats(), PrepareStats())
        sh, t_all, mem, got = whole_build(lambda: ix.build_sharded(
            sx, n_shards=FABRIC_ENTRIES, report=rep, mesh=mesh))
        require_flat(sh, one_shot[name], f"{name} fabric_build")
        if rep.prepare.iterations != one_shot[name]["iterations"]:
            raise AssertionError(f"{name} fabric_build: the schedule differs "
                                 f"from the one-shot's")
        require_launches(got, FABRIC_KERNELS[name],
                         f"the {name} fabric build")
        fabric_counts.append(got)
        gc.collect()
        torch.cuda.empty_cache()
        stage = {"one_shot": prepare_peak(ix, sx),
                 "fabric": prepare_peak(ix, sx, mesh=mesh)}
        above = {k: v["max_memory_allocated"] - v["resident_before"]
                 for k, v in stage.items()}
        emit({"phase": "fabric_build", "dataset": name, "n": len(sx) - 1,
              "mesh": len(mesh), "devices": len(set(mesh)),
              "stats": sh.stats(), "t_prepare_s": rep.t_prepare,
              "one_shot_t_prepare_s": one_shot[name]["t_prepare_s"],
              "prepare_vs_one_shot": (rep.t_prepare
                                      / one_shot[name]["t_prepare_s"]),
              "t_vertical_s": rep.t_vertical, "t_total_s": t_all,
              "iterations": rep.prepare.iterations,
              "one_shot_iterations": one_shot[name]["iterations"],
              # one elastic gather a shard step
              "shard_steps": got[FABRIC_KERNELS[name][0]],
              "whole_build": mem, "prepare_stage": stage,
              "prepare_stage_above": above,
              "prepare_above_vs_one_shot": (above["fabric"]
                                            / above["one_shot"]),
              "equal_to_one_shot": True, "launches": got})
        fabric_idx[name] = sh
        want = one_shot[name]
        fabric_one[name] = DeviceIndex.from_prepare(
            alphabet=ax, s=sx, prefixes=want["prefixes"],
            freqs=want["freqs"], ell=torch.from_numpy(want["ell"]),
            device=cuda)

    def straddler(sh) -> np.ndarray:
        """The longest route prefix whose cell interval holds a shard cut
        strictly inside: its span covers two shards or more."""
        best = None
        for cell in sh.cell_lo[1:].tolist():
            digits = [(cell // sh.base ** (sh.k_route - 1 - j)) % sh.base
                      for j in range(sh.k_route)]
            for j in range(sh.k_route - 1, 0, -1):
                if cell % sh.base ** (sh.k_route - j):
                    if best is None or j > len(best):
                        best = np.asarray(digits[:j], np.int32)
                    break
        if best is None:
            raise AssertionError("every shard cut lies on a one-symbol "
                                 "route boundary: no span can cross one")
        return best

    def fabric_check(sh, one, pats, what: str) -> dict:
        """Sharded finds and finds-and-fetches of ``pats`` (counted from
        0) equal to the one-shot index's; returns timings and counts."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = sh.find_batch(pats)
        got_ff, got_win = sh.find_fetch_batch(pats, fetch=FETCH)
        t_sharded = time.perf_counter() - t0
        got_counts = counts_now()
        t0 = time.perf_counter()
        want = one.find_batch(pats)
        want_ff, want_win = one.find_fetch_batch(pats, fetch=FETCH)
        t_one = time.perf_counter() - t0
        for a_, b_, c_ in zip(want, got, got_ff):
            if not (np.array_equal(a_, b_) and np.array_equal(a_, c_)):
                raise AssertionError(f"{what}: positions differ from the "
                                     f"one-shot index's")
        if not np.array_equal(want_win, got_win):
            raise AssertionError(f"{what}: windows differ")
        return {"t_sharded_s": t_sharded, "t_one_shot_s": t_one,
                "occurrences": sum(int(a_.size) for a_ in want),
                "launches": got_counts}

    def per_shard_launches(sh, pats, what: str) -> dict:
        """Each shard's sub-batch of ``pats``: one search launch, one
        find-and-fetch launch (byte keys when it carries the
        terminal)."""
        subs = {}
        for k, idxs in sorted(sh._split_batch(pats).items()):
            shard = sh.shards[k]
            sub = [pats[i] for i in idxs]
            term = max(int(np.max(p)) for p in sub) >= sh.base - 1
            kind = ("terminal" if term and shard.packed
                    else "genome" if shard.packed else "protein")
            search = (TERMINAL_KERNELS[0] if kind == "terminal"
                      else SEARCH_KERNELS[kind])
            search_batch_launches(lambda: shard.find_batch_ranges(
                *shard.pad_batch(sub)), search, f"{what} shard {k}")
            search_batch_launches(lambda: shard.find_fetch_ranges(
                *shard.pad_batch(sub), fetch=FETCH), FETCH_KERNELS[kind][0],
                f"{what} shard {k} fetch")
            subs[k] = len(sub)
        return subs

    for name, sx, ax in (("genome", s_dna, alpha),
                         ("protein", s_prot, protein)):
        sh = fabric_idx[name]
        frng = np.random.default_rng(53)
        # with one-symbol routes (k_route 1: the short run's sizes) no cut
        # can fall inside a route cell
        short = [straddler(sh)] if sh.k_route > 1 else []
        for _ in range(FABRIC_SHORT - 1 if sh.k_route > 1 else 0):
            # planted, 3 .. k_route - 1
            m = int(frng.integers(min(3, sh.k_route - 1), sh.k_route))
            i = int(frng.integers(0, len(sx) - 1 - m))
            short.append(np.asarray(sx[i:i + m], np.int32))
        pats = short + make_workload(
            sx, frng, batch=256 - len(short), min_len=sh.k_route,
            max_len=24, planted_frac=0.7, n_symbols=len(ax.symbols))
        spans = [sh.shard_span(p) for p in pats]
        multi = sum(hi > lo for lo, hi in spans)
        if not multi and sh.k_route > 1:
            raise AssertionError(f"{name} fabric_find: no span covers two "
                                 f"shards")
        row = fabric_check(sh, fabric_one[name], pats, f"{name} fabric_find")
        fabric_counts.append(row["launches"])
        row["per_shard_rows"] = per_shard_launches(sh, pats,
                                                   f"{name} fabric_find")
        extra = {}
        if name == "genome":  # byte keys on dense text
            extra = fabric_check(sh, fabric_one[name], tpats,
                                 "genome fabric_find terminal-bearing")
            fabric_counts.append(extra["launches"])
            require_launches(extra["launches"],
                             TERMINAL_KERNELS + FETCH_KERNELS["terminal"],
                             "the fabric's terminal-bearing batch")
            extra["per_shard_rows"] = per_shard_launches(
                sh, tpats, "genome fabric_find terminal-bearing")
            extra = {"terminal_bearing": {"patterns": len(tpats), **extra}}
        require_launches(row["launches"], (SEARCH_KERNELS[name],)
                         + FETCH_KERNELS[name], f"the {name} fabric finds")
        emit({"phase": "fabric_find", "dataset": name, "patterns": len(pats),
              "short": [p.tolist() for p in short], "k_route": sh.k_route,
              "spans_over_two_or_more_shards": multi,
              "widest_span": max(hi - lo + 1 for lo, hi in spans),
              **row, "search_launches_per_shard_batch": 1,
              "equal_to_one_shot": True, **extra})

    # the genome serving stack's cached mode, fetch 32, on the sharded index
    sh = fabric_idx["genome"]
    hot = make_hot_workload(s_dna, np.random.default_rng(29),
                            n_requests=SERVE_REQUESTS, hot_pool=32,
                            hot_frac=0.8, min_len=4, max_len=24,
                            n_symbols=len(alpha.symbols))
    serve_cfg = ServeConfig(queue_depth=1024, max_batch=256, max_wait_ms=1.0,
                            fetch=FETCH, pipeline=True, cache_size=4096)
    t0 = time.perf_counter()
    want = AsyncServer(fabric_one["genome"], serve_cfg).serve(hot)
    t_single = time.perf_counter() - t0

    def same_as_single(res, what: str) -> None:
        seen = set()
        for (a_, wa), (b_, wb) in zip(want, res):
            if (id(a_), id(b_)) in seen:
                continue
            seen.add((id(a_), id(b_)))
            if not (np.array_equal(a_, b_) and np.array_equal(wa, wb)):
                raise AssertionError(f"{what}: a result differs from the "
                                     f"single-index server's")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    warm = SyncFreeServer(sh, serve_cfg, kernel=FETCH_KERNELS["genome"][0])
    same_as_single(warm.serve(hot), "fabric serving (warm-up)")
    t_warm = time.perf_counter() - t0
    res, st = run_closed_loop(sh, hot, serve_cfg)
    same_as_single(res, "fabric serving")
    del res, want
    serve_counts = counts_now()
    fabric_counts.append(serve_counts)
    require_launches(serve_counts, FETCH_KERNELS["genome"],
                     "the fabric serving stack")
    single = stack_rows[("genome", "cached", FETCH)]
    emit({"phase": "fabric_serving", "dataset": "genome", "mode": "cached",
          "fetch": FETCH, "requests": len(hot), "shards": sh.n_shards,
          "qps": st["qps"], "lat_p50_ms": st["lat_p50_ms"],
          "lat_p99_ms": st["lat_p99_ms"], "wall_s": st["wall_s"],
          "single_index": {k: single[k] for k in (
              "qps", "lat_p50_ms", "lat_p99_ms", "wall_s")},
          "qps_vs_single_index": st["qps"] / single["qps"],
          "cache_hit_rate": st["cache"]["hit_rate"],
          "per_shard_hit_rate": [c["hit_rate"]
                                 for c in st["cache"]["per_shard"]],
          "cache": st["cache"], "batches": st["batches"],
          "rows_padded": st["rows_padded"], "shapes": st["shapes"],
          "warm_pass_s": t_warm, "warm_pass_host": warm.host_ms(),
          "t_single_index_check_s": t_single, "sync_free_dispatch": True,
          "per_sub_batch_launches": {FETCH_KERNELS["genome"][0]: 1},
          "equal_to_single_index": True, "launches": serve_counts})
    del warm, hot

    # the phase-append symbols appended to the sharded genome index
    (sh2, srep), t_app, mem_app, app_counts = whole_build(
        lambda: EraIndexer(alpha, cfg).append_sharded(sh, appended["s_new"]))
    require_flat(sh2, appended, "fabric_append")
    if not sh2.epoch == sh.epoch + 1 == appended["epoch"]:
        raise AssertionError("fabric_append: the epoch did not advance by one")
    require_launches(app_counts, ("search_bounds_words", "range_gather_words"),
                     "the fabric append")
    fabric_counts.append(app_counts)
    arep = appended["report"]
    report_keys = ("n_old", "n_new", "b_star", "n_prefixes", "n_affected",
                   "leaves_rebuilt", "leaves_reused", "partition_fallback",
                   "t_scan", "t_partition", "t_prepare", "t_merge")
    emit({"phase": "fabric_append", "dataset": "genome",
          "appended": len(appended["s_new"]) - len(s_dna),
          "shards": sh2.n_shards,
          "stats": sh2.stats(), "epoch": sh2.epoch,
          "report": {k: getattr(srep, k) for k in report_keys},
          "t_total_report_s": srep.t_total, "t_append_s": t_app,
          "append_device": {**{k: getattr(arep, k) for k in report_keys},
                            "t_total_report_s": arep.t_total},
          **{f"append_{k}": v for k, v in mem_app.items()},
          "equal_to_append_device": True, "launches": app_counts})
    del sh2, appended, fabric_idx, fabric_one, sh
    gc.collect()
    torch.cuda.empty_cache()

    # a 3-shard byte-layout archive at 2^22: migrated, loaded, warm-started
    s_mig, _ = dataset("genome", 1 << min(MIGRATE_LOG2, args.n_log2), seed=1)
    sh_b = EraIndexer(alpha, cfg).build_sharded(s_mig, n_shards=3, mesh=mesh,
                                                packing="bytes")
    mig_pats = make_workload(s_mig, np.random.default_rng(59), batch=64,
                             min_len=4, max_len=24, planted_frac=0.7,
                             n_symbols=len(alpha.symbols))
    want = sh_b.find_batch(mig_pats)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "genome_shards")
        sh_b.save(path)
        files = fabric.ShardedIndex.shard_files(path)
        if len(files) != 3:
            raise AssertionError(f"fabric_archives: {len(files)} shard files")
        t0 = time.perf_counter()
        done = migrate_archives(path)
        t_mig = time.perf_counter() - t0
        again = migrate_archives(path)
        if done != files or again:
            raise AssertionError(f"migrate_archives gave {done}, then {again}")
        t0 = time.perf_counter()
        loaded = fabric.ShardedIndex.load(path, device=cuda)
        t_load = time.perf_counter() - t0
        if not all(d.packed and d.device.type == "cuda"
                   for d in loaded.shards):
            raise AssertionError("fabric_archives: a loaded shard is not "
                                 "dense on the card")
        for a_, b_ in zip(want, loaded.find_batch(mig_pats)):
            if not np.array_equal(a_, b_):
                raise AssertionError("fabric_archives: the migrated shards "
                                     "answer differently")
        builds = []
        hit, s_back, _, t_hit = load_or_build(
            path, "genome", len(s_mig) - 1, 1,
            load=lambda p: fabric.ShardedIndex.load(p, device=cuda),
            build=lambda *a: builds.append(1), sharded=True)
        if builds or not np.array_equal(s_back, s_mig):
            raise AssertionError("load_or_build(sharded=True) rebuilt or "
                                 "lost the full string")
    emit({"phase": "fabric_archives", "dataset": "genome",
          "n": len(s_mig) - 1, "shards": len(files), "migrated": len(done),
          "second_call": len(again), "t_migrate_archives_s": t_mig,
          "t_load_s": t_load, "t_load_or_build_s": t_hit,
          "cache_hit": True, "full_string": True,
          "equal_after_migration": True})
    del sh_b, loaded, hit, s_mig, want
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6g. the flight recorder (counted: the recorded window) ------------
    trace_counts = trace_phase(args.n_log2, cfg, SyncFreeServer)
    require_launches(trace_counts, ("range_gather_words",
                                    "search_bounds_words",
                                    "search_fetch_words", "kmer_histogram"),
                     "the traced path")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6f. the serial engine and the worker driver ----------------------
    # (counted): the serial builds of both strings against the batched
    # engine's sub-trees, the node builders at 2^20, build_distributed
    # with a failed worker and the era_run command line
    serial_counts = []
    for name, sx, ax in (("genome", s_dna, alpha),
                         ("protein", s_prot, protein)):
        batched_sub, got = serial_phase(name, sx, ax, cfg,
                                        one_shot[name]["t_prepare_s"])
        serial_counts.append(got)
        if name == "genome":
            genome_sub = batched_sub
        del batched_sub
        gc.collect()
        torch.cuda.empty_cache()
    serial_counts.append(serial_nodes_phase(SERIAL_NODES_LOG2))
    serial_counts.append(era_run_phase(s_dna, alpha, cfg, genome_sub,
                                       SERIAL_NODES_LOG2))
    del genome_sub
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. the tree + analytics path per dataset (counted) ----------------
    def tree_path(name: str, sx: np.ndarray, ax) -> dict:
        """EraIndexer.build (node_lcp="words") -> SuffixTreeIndex ->
        analytics() -> the analytics_serve loop, counted from the build to
        the end of the loop; then the checks and the new kernel's row."""
        cfg_w = EraConfig(node_lcp="words")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        report = BuildReport(VerticalStats(), PrepareStats())
        t0 = time.perf_counter()
        index = EraIndexer(ax, cfg_w).build(sx, report)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        emit({"phase": "tree", "dataset": name, "n": len(sx) - 1,
              "node_lcp": "words", "t_total_s": t_total,
              "t_vertical_s": report.t_vertical,
              "t_prepare_s": report.t_prepare, "t_build_s": report.t_build,
              "iterations": report.prepare.iterations,
              "groups": report.n_groups, "prefixes": report.n_prefixes,
              "n_leaves": index.n_leaves, "n_internal": index.n_internal,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": counts_now()})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = index.analytics()
        torch.cuda.synchronize()
        t_eng = time.perf_counter() - t0
        emit({"phase": "analytics", "dataset": name, "t_analytics_s": t_eng,
              "n_subtrees": eng.dev.n_subtrees, "levels": eng.vals.shape[0],
              "table_bytes": eng.vals.numel() * 4 + eng.vals_rev.numel() * 4,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": counts_now()})
        stats = serve_engine(eng, sx, ax, np.random.default_rng(1),
                             batch=512, iters=20, window=64,
                             planted_frac=0.7)
        counts = counts_now()
        emit({"phase": "analytics_serving", "dataset": name, **stats,
              "launches": counts})
        require_launches(counts, TREE_KERNELS[name], f"the {name} tree path")
        kernel = TREE_KERNELS[name][-1]
        if counts[SEARCH_STEPS[kernel]]:
            raise AssertionError(f"the {name} tree path launched the "
                                 f"single-step probe")
        q = make_query(sx, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(ax.symbols))
        search_batch_launches(lambda: eng.matching_stats(q, window=64),
                              kernel, f"{name} matching_stats")

        # -- tree checks: text-derived divergence rows == the prepare
        #    state's b_off on every sub-tree; find == brute force
        s_dev = torch.from_numpy(sx).to(cuda)
        prefixes = sorted(index.subtrees)
        freqs = np.array([index.subtrees[p].freq for p in prefixes])
        ell_all = np.concatenate([index.subtrees[p].ell for p in prefixes])
        boff_all = np.concatenate([index.subtrees[p].b_off
                                   for p in prefixes])
        inner = np.ones(ell_all.size, bool)
        inner[np.cumsum(freqs) - freqs] = False  # each sub-tree's first row
        text = EraIndexer(ax, cfg_w)._device_text(sx)
        t0 = time.perf_counter()
        rows = tbuild.boff_rows_from_text(
            text, torch.from_numpy(ell_all)[None].to(cuda), len(sx))[0]
        t_rows = time.perf_counter() - t0
        if not np.array_equal(rows.cpu().numpy()[inner], boff_all[inner]):
            raise AssertionError(f"{name}: boff_rows_from_text disagrees "
                                 f"with the prepare state's b_off")
        del rows
        pats = make_workload(sx, qrng, batch=64, min_len=4, max_len=24,
                             planted_frac=0.7, n_symbols=len(ax.symbols))
        for p in pats:
            want_pos = occurrences(s_dev, p).sort().values.cpu().numpy()
            if not np.array_equal(index.find(p), want_pos):
                raise AssertionError(f"{name}: find disagrees with the scan "
                                     f"for pattern {p.tolist()}")
        emit({"phase": "check", "dataset": name, "path": "tree",
              "boff_rows_equal": int(inner.sum()), "t_boff_rows_s": t_rows,
              "find_patterns": len(pats)})

        # -- analytics checks against brute force on the card
        total = eng.total
        ell_dev = eng.dev.ell
        bnd = eng.dev.sub_off[1:].to(torch.int64)
        rnd = torch.randint(1, total, (4096,), device=cuda)
        rows_q = torch.cat([bnd, rnd])
        want = brute_lcp(s_dev, ell_dev[rows_q - 1], ell_dev[rows_q])
        if not torch.equal(eng.lcp[rows_q].to(torch.int64), want):
            raise AssertionError(f"{name}: LCP array disagrees with brute "
                                 f"force")
        k = 6 if name == "genome" else 3
        starts, kcounts = eng.kmer_spectrum(k)
        hist = ops.kmer_histogram(s_dev, total - k + 1, k, ax.base)
        wins = s_dev[torch.from_numpy(starts).to(cuda)[:, None]
                     + torch.arange(k, device=cuda)].to(torch.int64)
        codes = torch.zeros(wins.shape[0], dtype=torch.int64, device=cuda)
        for j in range(k):
            codes = codes * ax.base + wins[:, j]
        if not (torch.equal(hist[codes].cpu().to(torch.int64),
                            torch.from_numpy(kcounts))
                and int((hist > 0).sum()) == len(kcounts)
                and int(hist.sum()) == int(kcounts.sum())):
            raise AssertionError(f"{name}: kmer_spectrum({k}) disagrees with "
                                 f"the kmer_histogram counts")
        rep = eng.longest_repeat()
        rep_p = sx[rep["witness"]:rep["witness"] + rep["length"]]
        rep_occ = int(occurrences(s_dev, rep_p).numel())
        if rep_occ != rep["count"]:
            raise AssertionError(f"{name}: longest repeat occurs {rep_occ} "
                                 f"times, the engine says {rep['count']}")
        q = make_query(sx, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(ax.symbols))
        ms, wit = eng.matching_stats(q, window=64)
        q_dev = torch.from_numpy(np.concatenate(
            [q, np.zeros(64, np.uint8)])).to(cuda)
        ar = torch.arange(64, device=cuda)
        has = torch.from_numpy(np.nonzero(ms > 0)[0]).to(cuda)
        ms_dev = torch.from_numpy(ms.astype(np.int64)).to(cuda)
        wit_dev = torch.from_numpy(wit.astype(np.int64)).to(cuda)
        in_match = ar[None, :] < ms_dev[has, None]
        s_win = s_dev[torch.clamp(wit_dev[has, None] + ar, max=len(sx) - 1)]
        q_win = q_dev[has[:, None] + ar]
        if bool(((s_win != q_win) & in_match).any()):
            raise AssertionError(f"{name}: a matching-statistics witness "
                                 f"does not match the query")
        open_pos = np.nonzero((ms < 64) & (np.arange(len(q)) + ms < len(q)))[0]
        sample = qrng.choice(open_pos, size=min(256, open_pos.size),
                             replace=False)
        for i in sample:
            if occurrences(s_dev, q[i:i + ms[i] + 1]).numel():
                raise AssertionError(f"{name}: matching statistic at {i} is "
                                     f"not maximal")
        emit({"phase": "check", "dataset": name, "path": "analytics",
              "lcp_rows_checked": int(rows_q.numel()),
              "boundaries": int(bnd.numel()), "kmer_k": k,
              "distinct_kmers": len(kcounts),
              "longest_repeat": rep, "matched_positions": int(has.numel()),
              "maximal_checked": int(sample.size),
              "distinct_substrings": eng.distinct_substrings()})
        del eng, s_dev, hist, wins, codes, q_dev, ms_dev, wit_dev, s_win
        del q_win, in_match, has, rows_q, want, ell_dev
        index._analytics = index._device = None
        torch.cuda.empty_cache()

        # -- the layers of the node build, each timed alone: the loop of
        #    EraIndexer._attach_nodes_batched split at its device syncs
        #    (padded rows + text-derived divergence rows, the chunked
        #    Cartesian-tree build, the compact extraction and host copy)
        t_rows = t_cart = t_host = 0.0
        cells, chunks = 0, 0
        ell_dev = torch.from_numpy(ell_all).to(cuda)
        first = np.cumsum(freqs) - freqs
        # CUDA events around each launch of the text-LCP kernel inside
        # boff_rows_from_text (as build_profile times the build's kernels):
        # per launch its w, pending rows, adjacency share and device ms
        lcp_attr = ("suffix_lcp_words" if isinstance(text, packing.PackedText)
                    else "_suffix_lcp_bytes")
        lcp_kernel = getattr(ops, lcp_attr)
        launches = []

        def timed_lcp(s_text, pa, pb, w):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = lcp_kernel(s_text, pa, pb, w)
            e1.record()
            adjacent = ((pa[1:] == pb[:-1]).sum() if pa.shape[0] > 1
                        else torch.zeros((), device=cuda))
            launches.append((w, pa.shape[0], adjacent, e0, e1))
            return out

        setattr(ops, lcp_attr, timed_lcp)
        try:
            for f_pad, bucket in tbuild.bucket_pad_widths(freqs):
                t0 = time.perf_counter()
                idx = np.zeros((len(bucket), f_pad), np.int64)
                for r, e in enumerate(bucket):
                    idx[r, :freqs[e]] = first[e] + np.arange(freqs[e])
                mask = torch.from_numpy(
                    np.arange(f_pad)[None, :] < freqs[bucket][:, None]
                ).to(cuda)
                ell_rows = torch.where(mask, ell_dev[torch.from_numpy(
                    idx).to(cuda)], len(sx))
                boff_rows = tbuild.boff_rows_from_text(text, ell_rows,
                                                       len(sx))
                torch.cuda.synchronize()
                t_rows += time.perf_counter() - t0
                t0 = time.perf_counter()
                nodes = tbuild.build_parallel_batch(ell_rows, boff_rows,
                                                    len(sx))
                torch.cuda.synchronize()
                t_cart += time.perf_counter() - t0
                t0 = time.perf_counter()
                tbuild.unpad_nodes_rows(nodes, freqs[bucket])
                t_host += time.perf_counter() - t0
                cells += len(bucket) * f_pad
                chunks += -(-len(bucket) // tbuild.rows_per_chunk(f_pad))
                del idx, mask, ell_rows, boff_rows, nodes
        finally:
            setattr(ops, lcp_attr, lcp_kernel)
        del ell_dev
        torch.cuda.empty_cache()
        # one lcp_from_text call per bucket: its rounds run w = 64, 128,
        # 256, 256, ...; a launch at the first w starts the next call
        rounds: list[dict] = []
        r = -1
        for w_l, rows_l, adj, e0, e1 in launches:
            r = 0 if w_l == launches[0][0] else r + 1
            if r == len(rounds):
                rounds.append({"round": r, "w": w_l, "launches": 0,
                               "rows": 0, "adjacent": 0, "ms": 0.0})
            rounds[r]["launches"] += 1
            rounds[r]["rows"] += rows_l
            rounds[r]["adjacent"] += int(adj)
            rounds[r]["ms"] += e0.elapsed_time(e1)
        for rd in rounds:
            rd["adjacent_share"] = rd.pop("adjacent") / max(rd["rows"], 1)
        lcp_ms = sum(rd["ms"] for rd in rounds)
        lcp_rows = sum(rd["rows"] for rd in rounds)
        tree_lcp = {"kernel": lcp_kernel.__name__,
                    "ms_in_tree": lcp_ms, "rows": lcp_rows,
                    "adjacent_share": (sum(rd["adjacent_share"] * rd["rows"]
                                           for rd in rounds)
                                       / max(lcp_rows, 1)),
                    # positions in, LCP out, per tallied row
                    "bound_ms": bound(lcp_rows * 12, 0)[0]}
        emit({"phase": "tree_layers", "dataset": name,
              "t_rows_and_text_lcp_s": t_rows, "t_cartesian_build_s": t_cart,
              "t_extract_to_host_s": t_host, "padded_cells": cells,
              "chunks": chunks, "text_lcp": tree_lcp,
              "text_lcp_glue_s": t_rows - lcp_ms / 1e3,
              "text_lcp_rounds": rounds})

        # -- the layers of the engine, each timed alone
        t0 = time.perf_counter()
        dev_i = index.to_device()
        torch.cuda.synchronize()
        t_flatten = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcp_host = AnalyticsEngine.from_index(index, dev=dev_i).lcp_host
        torch.cuda.synchronize()
        t_from_index = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        AnalyticsEngine.from_device(dev_i, lcp_host)
        torch.cuda.synchronize()
        t_sparse = time.perf_counter() - t0
        emit({"phase": "analytics_layers", "dataset": name,
              "t_flatten_s": t_flatten, "t_sparse_tables_s": t_sparse,
              "t_lcp_fill_s": t_from_index - t_sparse})
        del dev_i
        torch.cuda.empty_cache()

        # -- the new kernel at the node build's main shape: the first
        #    lcp_from_text round reads every adjacent leaf pair at w = 64
        ell_t = torch.from_numpy(ell_all).to(cuda)
        pa = ell_t[:-1][torch.from_numpy(inner[1:]).to(cuda)].contiguous()
        pb = ell_t[1:][torch.from_numpy(inner[1:]).to(cuda)].contiguous()
        del ell_t
        w = 64
        chunk = 1 << 24
        if isinstance(text, packing.PackedText):
            kname, kfn, pfn = ("suffix_lcp_words", ops.suffix_lcp_words,
                               kref.suffix_lcp_words_ref)
            work = lambda lcp: suffix_lcp_work(lcp, w, text.syms_per_word,
                                               text.nbytes, 8)
            replaces = "src/repro/kernels/packed_gather.py:415"
        else:
            kname, kfn, pfn = ("suffix_lcp_pairs", ops.KERNELS["suffix_lcp_pairs"],
                               kref.suffix_lcp_pairs_ref)
            work = lambda lcp: suffix_lcp_work(lcp, w, 4, text.shape[0], 8)
            replaces = "src/repro/kernels/suffix_lcp.py:46"
        got = kfn(text, pa, pb, w)
        for c0 in range(0, pa.shape[0], chunk):  # the plain version in chunks
            assert_equal(got[c0:c0 + chunk],
                         pfn(text, pa[c0:c0 + chunk], pb[c0:c0 + chunk], w),
                         f"{kname} (main-path shape)")
        b_ms, b_by = bound(*work(got))
        call = lambda: kfn(text, pa, pb, w)
        earlier = {}
        if kname in yard:  # the earlier design, in turns on the same pairs
            old = lambda: hist_lcp_bench.baseline_slcp(yard[kname], text, pa,
                                                       pb, w)
            assert_equal(old(), got, f"{kname}'s earlier design")
            ms, old_ms = gather_bench.in_turns(
                {"ms": call, "baseline_ms": old}).values()
            earlier = {"design": DESIGNS[kname][0], "baseline_ms": old_ms,
                       "baseline_design": DESIGNS[kname][1]}
        else:
            ms = cuda_ms(call)
        row = {"name": kname, "replaces": replaces,
               "shape": f"rows={pa.shape[0]} w={w}",
               "adjacent_share": float((pa[1:] == pb[:-1]).float().mean()),
               "ms_in_tree": {name: {"ms_in_tree": tree_lcp["ms_in_tree"],
                                     "bound_ms": tree_lcp["bound_ms"],
                                     "rows": tree_lcp["rows"]}},
               "ms": ms, **earlier,
               "plain_ms": cuda_ms(lambda: [
                   pfn(text, pa[c0:c0 + chunk], pb[c0:c0 + chunk], w)
                   for c0 in range(0, pa.shape[0], chunk)], reps=1),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_note": f"plain version run in chunks of {chunk} rows"}
        del got, pa, pb, text, index
        torch.cuda.empty_cache()
        return {"counts": counts, "row": row}

    from repro_torch.core.analytics import AnalyticsEngine
    qrng = np.random.default_rng(13)
    tree = {"genome": tree_path("genome", s_dna, alpha),
            "protein": tree_path("protein", s_prot, protein)}
    rows += [tree["genome"]["row"], tree["protein"]["row"]]
    del s_prot

    # ---- 7. the REPRO_WORD_COMPARE=byte oracle leg on genome (counted) ------
    n_leg = 1 << min(BYTE_LEG_LOG2, args.n_log2)
    s_leg, _ = dataset("genome", n_leg, seed=0)
    leg_pats = make_workload(s_leg, qrng, batch=64, min_len=4, max_len=24,
                             planted_frac=0.7, n_symbols=len(alpha.symbols))
    leg_q = make_query(s_leg, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(alpha.symbols))
    legs = {}
    for leg in ("word", "byte"):
        with gather_bench.word_compare(leg):
            ops.reset_launch_counts()
            report = BuildReport(VerticalStats(), PrepareStats())
            t0 = time.perf_counter()
            dev = EraIndexer(alpha, cfg).build_device(s_leg, report)
            torch.cuda.synchronize()
            t_leg = time.perf_counter() - t0
            leg_build = counts_now()
            found = dev.find_batch(leg_pats)
            fetched = dev.find_fetch_batch(leg_pats, fetch=FETCH)
            _, eng = EraIndexer(alpha, EraConfig(build_impl="none")
                                ).build_analytics(s_leg)
            ms_leg = eng.matching_stats(leg_q, window=64)
            legs[leg] = {"ell": dev.ell.cpu().numpy(), "found": found,
                         "fetched": fetched,
                         "lcp": eng.lcp_host, "ms": ms_leg,
                         "counts": counts_now(), "t_build_s": t_leg,
                         "t_prepare_s": report.t_prepare,
                         "build_counts": leg_build}
            if leg == "byte":  # each batch one launch (counted from 0)
                padded_l = dev.pad_batch(leg_pats)
                search_batch_launches(
                    lambda: dev.find_batch_ranges(*padded_l),
                    "search_bounds_packed", "byte leg find_batch")
                search_batch_launches(
                    lambda: dev.find_fetch_ranges(*padded_l, fetch=FETCH),
                    "search_fetch_packed", "byte leg find_fetch")
                search_batch_launches(
                    lambda: eng.matching_stats(leg_q, window=64),
                    "search_bounds_packed", "byte leg matching_stats")
            if leg == "byte":
                leg_ell = dev.ell
            del dev, eng
            torch.cuda.empty_cache()
    # one more warm byte-leg build under the profiler: the byte-key
    # kernels' device ms in the build beside their bounds
    with gather_bench.word_compare("byte"):
        profiles["byte_leg"] = build_profile(
            "byte_leg", s_leg, alpha, legs["byte"]["t_prepare_s"],
            legs["byte"]["build_counts"])
    wl, bl = legs["word"], legs["byte"]
    same = (np.array_equal(wl["ell"], bl["ell"])
            and all(np.array_equal(a, b)
                    for a, b in zip(wl["found"], bl["found"]))
            and all(np.array_equal(a, b)
                    for a, b in zip(bl["found"], bl["fetched"][0]))
            and all(np.array_equal(a, b)
                    for a, b in zip(wl["fetched"][0], bl["fetched"][0]))
            and np.array_equal(wl["fetched"][1], bl["fetched"][1])
            and np.array_equal(wl["lcp"], bl["lcp"])
            and all(np.array_equal(a, b) for a, b in zip(wl["ms"], bl["ms"])))
    emit({"phase": "byte_leg", "dataset": "genome", "n": n_leg,
          "equal_to_word_leg": same,
          "t_build_word_s": wl["t_build_s"], "t_build_byte_s": bl["t_build_s"],
          "launches_word": wl["counts"], "launches": bl["counts"]})
    if not same:
        raise AssertionError("the byte leg disagrees with the word leg")
    require_launches(bl["counts"], BYTE_LEG_KERNELS, "the byte leg")
    for name in WORD_ONLY_KERNELS + PACKED_STEPS:
        if bl["counts"][name]:
            raise AssertionError(f"{name} ran under REPRO_WORD_COMPARE=byte")

    # range_gather_packed at the byte leg's main shape: the first elastic
    # step reads w = 4 symbols after every suffix of the dense build text
    pt_leg = EraIndexer(alpha, cfg)._device_text(s_leg)
    got = ops.range_gather_packed(pt_leg, leg_ell, 4)
    want = kref.range_gather_packed_ref(pt_leg, leg_ell, 4)
    assert_equal(got, want, "range_gather_packed (main-path shape)")
    old = lambda: gather_bench.baseline_packed(yard["range_gather_packed"],
                                               pt_leg, leg_ell, 4)
    assert_equal(old(), want, "range_gather_packed's earlier design")
    b_ms, b_by = bound(*gather_packed_work(leg_ell.shape[0], 1, pt_leg.bits,
                                           pt_leg.words.shape[0]))
    ms, old_ms = gather_bench.in_turns({
        "ms": lambda: ops.range_gather_packed(pt_leg, leg_ell, 4),
        "baseline_ms": old}).values()
    rows.append({"name": "range_gather_packed",
                 "replaces": "src/repro/kernels/packed_gather.py:93",
                 "shape": f"rows={leg_ell.shape[0]} w=4",
                 "rows": leg_ell.shape[0], "ms": ms,
                 "design": DESIGNS["range_gather_packed"][0],
                 "baseline_ms": old_ms,
                 "baseline_design": DESIGNS["range_gather_packed"][1],
                 "plain_ms": cuda_ms(lambda: kref.range_gather_packed_ref(
                     pt_leg, leg_ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    del got, want, pt_leg, leg_ell, old

    # ---- 9. LM serving: qwen3-1.7b prefill -> decode (flash_attention) ----
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_start",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    flash_cases = flash_parity(cuda)
    lm_runs = lm_serving(cuda)
    lm_check(cuda)
    dedup_counts = lm_train(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    family_counts = lm_families(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    family_train_counts = lm_families_train(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_counts = dryrun_phase(cuda)

    rows += fetch_rows
    rows.append(flash_row(cuda, flash_cases))  # row 13, the last ported
    # the LM's main path is one serve call: the warm run, counted from 0
    lm_main = next(r["launches"] for r in lm_runs if r["run"] == "warm")
    paths = [dna_counts, term_counts, ff_counts, tff_counts,
             *dna_serve_counts.values(), prot_counts, prot_ff_counts,
             *prot_serve_counts.values(), tree["genome"]["counts"],
             tree["protein"]["counts"], bl["counts"], lm_main,
             *stream_counts, append_counts, *fabric_counts, *serial_counts,
             trace_counts, *dedup_counts, *family_counts,
             *family_train_counts, *dryrun_counts]
    counts = {name: sum(c[name] for c in paths) for name in ops.KERNELS}
    for row in rows:  # a gather's excess from the rows its launches read
        if row["name"] in GATHERS:
            got_rows, got_words = (sum(c.get(f"{row['name']}_{k}", 0)
                                       for c in paths)
                                   for k in ("rows", "words"))
            row.update(rows_gathered=got_rows, words_gathered=got_words,
                       row_weighted_excess_ms=got_rows / row["rows"]
                       * (row["ms"] - row["bound_ms"]))
        in_build = {d: {k: p["port_kernels"][row["name"]][k]
                        for k in ("ms_in_build", "bound_ms", "excess_ms")}
                    for d, p in profiles.items()
                    if row["name"] in p["port_kernels"]}
        if in_build:
            row["ms_in_build"] = in_build
    by_name = {row["name"]: row for row in rows}
    for step, fused, yard in (("pattern_probe_packed", "search_bounds_packed",
                               "loop_ms"),
                              ("probe_gather_packed", "search_fetch_packed",
                               "unfused_ms")):
        # the single-step kernels keep their rows; the search they served
        # is one kernel now
        f = by_name[fused]
        by_name[step]["fused_into"] = {
            "name": fused, "launches": counts[fused],
            **{k: f[k] for k in ("ms", "device_ms", yard,
                                 "latency_bound_ms", "distinct")}}
    for row in rows:
        if row["name"] == "kmer_histogram":  # every counted partition scan
            row["per_k_ms"] = {f"{d} k={k}": v["ms"]
                               for (d, k), v in kmer_rows.items()}
            row["per_k_path"] = {f"{d} k={k}": v["last_path"]
                                 for (d, k), v in kmer_rows.items()}
            row["bincount_ms"] = kmer_rows[("genome", 6)]["bincount_ms"]
            row["bincount_note"] = (
                "torch.bincount of the precomputed codes at the row's shape: "
                "a yardstick for the counting step alone, not the function")
        if row["name"] == "suffix_lcp_words":
            row["w256_ms"] = lcp_w256
    kernels = []
    for row in rows:
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": row.get("source", f"src/repro_torch/kernels/"
                                                    f"csrc/{row['name']}.cu"),
                        "replaces": row["replaces"],
                        "launches": counts[row["name"]],
                        "max_abs_err": row.get("max_abs_err", 0),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms"),
                        "shape": row["shape"],
                        # what the redesign queue ranks by (ROADMAP)
                        "launch_excess_ms": counts[row["name"]]
                        * (row["ms"] - row["bound_ms"]),
                        **{k: v for k, v in row.items()
                           if k in ("aligned_offsets_ms", "plain_note",
                                    "two_launch_ms", "large", "library",
                                    "design", "sorted_offsets_ms",
                                    "sort_ms", "rows_gathered",
                                    "words_gathered", "ms_in_build",
                                    "l2_window",
                                    "row_weighted_excess_ms", "loop_ms",
                                    "replaces_loop", "bound_note",
                                    "trips_max", "trips_mean", "n_iter",
                                    "window_max", "window_mean",
                                    "last_path", "per_k_ms", "per_k_path",
                                    "bincount_ms", "bincount_note",
                                    "adjacent_share", "w256_ms",
                                    "ms_in_tree", "unfused_ms",
                                    "latency_bound_ms", "dram_round_trip_ms",
                                    "replaces_composition", "search_ms",
                                    "device_ms", "unfused_device_ms",
                                    "search_device_ms", "baseline_ms",
                                    "baseline_design", "loop_device_ms",
                                    "fused_into", "distinct",
                                    "patterns_distinct", "ms_d80",
                                    "library_ms_d80", "shape_d80")}})
    if sorted(k["name"] for k in kernels) != sorted(ops.KERNELS):
        raise AssertionError("the kernels line misses a kernel")
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
