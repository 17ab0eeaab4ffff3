"""Quickstart on the PyTorch port: build an ERA suffix-tree index and query
it, section for section as ``examples/quickstart.py`` does with the JAX
package.

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 20000

Section 7 (the flight recorder) writes ``era_trace.json`` and
``era_metrics.prom`` under ``--out-dir`` (default ``build/quickstart``).
"""

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np

from repro_torch.core.api import (
    AppendReport,
    BuildReport,
    EraConfig,
    EraIndexer,
)
from repro_torch.core.prepare import PrepareStats
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset

OUT = Path(__file__).resolve().parents[1] / "build" / "quickstart"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch "
                         "versions) [cuda]")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--out-dir", default=str(OUT),
                    help="where section 7 writes the trace and metrics")
    args = ap.parse_args(argv)
    device = args.device

    # 1. a string to index (synthetic DNA with planted repeats)
    s, alphabet = dataset("dna", args.n, seed=0)
    print(f"string: {len(s):,} symbols over Σ={alphabet.symbols!r}+'$' "
          f"on {device}")

    # 2. build under a tight memory budget so the vertical partitioner has
    #    real work to do.  construction="batched" (the default) stacks every
    #    virtual tree into one (G, F) state and drives one elastic-range
    #    loop on the device, then builds every sub-tree's nodes in batched
    #    Cartesian-tree calls; construction="serial" is the paper's one
    #    group at a time, with the same arrays.
    cfg = EraConfig(memory_bytes=64 << 10, r_bytes=4 << 10,
                    construction="batched")
    report = BuildReport(VerticalStats(), PrepareStats())
    idx = EraIndexer(alphabet, cfg, device=device).build(s, report)
    print(f"built {len(idx.subtrees)} sub-trees in {report.n_groups} virtual "
          f"trees; F_M={report.f_max}")
    print(f"  vertical: {report.t_vertical:.2f}s "
          f"({report.vertical.scans} scans)")
    print(f"  prepare : {report.t_prepare:.2f}s ({report.prepare.iterations} "
          f"elastic iterations, ranges {min(report.prepare.ranges)}–"
          f"{max(report.prepare.ranges)})")
    print(f"  build   : {report.t_build:.2f}s "
          f"({idx.n_leaves:,} leaves, {idx.n_internal:,} internal nodes)")

    # 3. query: all occurrences of a pattern
    pattern = s[1234:1244]
    hits = idx.find(pattern)
    print(f"pattern {alphabet.decode(pattern)!r}: {len(hits)} occurrences "
          f"at {hits[:8].tolist()}…")
    assert 1234 in hits

    # 4. the same query through the tree walk (the paper's O(|P|) descent)
    assert np.array_equal(hits, idx.find_walk(pattern))
    print("tree-walk search agrees ✓")

    # 5. batched device path: a list of patterns resolves with one routing
    #    gather and one search launch (repro_torch.core.query)
    batch = [s[i:i + 8] for i in (100, 2_000, len(s) // 2)] + [pattern]
    batch_hits = idx.find_batch(batch)
    assert np.array_equal(batch_hits[-1], hits)
    print(f"batched device search agrees ✓ "
          f"({[len(h) for h in batch_hits]} hits per pattern)")

    # 5b. serving-only deployments: build_device goes string -> DeviceIndex
    #     directly, the leaf arrays gathered into suffix-array order on the
    #     device without the per-prefix sub-tree dict
    ix = EraIndexer(alphabet, cfg, device=device)
    dev = ix.build_device(s)
    assert np.array_equal(dev.find_batch([pattern])[0], hits)
    print("direct string -> DeviceIndex pipeline agrees ✓")

    # 5c. dense packing: with packing="auto" the DNA string is stored at 2
    #     bits a symbol and every read works on the packed words; the
    #     results equal packing="bytes"
    dev_bytes = EraIndexer(alphabet, dataclasses.replace(cfg, packing="bytes"),
                           device=device).build_device(s)
    assert dev.packed and dev.s_bits == alphabet.dense_bits == 2
    for a, b in zip(dev.find_batch(batch), dev_bytes.find_batch(batch)):
        assert np.array_equal(a, b)
    print(f"dense-packed index agrees ✓ (string storage: "
          f"{dev.string_nbytes:,} B packed vs {dev_bytes.string_nbytes:,} B "
          f"bytes — {dev_bytes.string_nbytes / dev.string_nbytes:.1f}x smaller)")

    # 5d. word-parallel querying: dense words are the compare currency;
    #     REPRO_WORD_COMPARE=byte runs the byte-key oracle on the same index
    prev = os.environ.get("REPRO_WORD_COMPARE")
    os.environ["REPRO_WORD_COMPARE"] = "byte"
    try:
        oracle_hits = dev.find_batch(batch)
    finally:
        if prev is None:
            del os.environ["REPRO_WORD_COMPARE"]
        else:
            os.environ["REPRO_WORD_COMPARE"] = prev
    for a, b in zip(dev.find_batch(batch), oracle_hits):
        assert np.array_equal(a, b)
    print("word-compare probes agree with the byte-key oracle ✓")

    # 5e. sustained serving: repro_torch.launch.serving coalesces admitted
    #     requests into pow2-bucketed batches, dispatches each without a
    #     host sync and consumes the previous one meanwhile; a route cache
    #     answers repeated patterns at admission
    from repro_torch.launch.serving import ServeConfig, run_closed_loop
    stream = [s[i:i + 12] for i in (100, 2_000, 100, len(s) // 2, 100, 2_000)]
    served, stats = run_closed_loop(
        dev, stream, ServeConfig(pipeline=True, cache_size=256, max_batch=2))
    for (pos, _), p in zip(served, stream):
        assert np.array_equal(pos, idx.find(p))
    print(f"continuous-batching server agrees ✓ ({stats['batches']} batches, "
          f"cache hit rate {stats['cache']['hit_rate']:.0%})")

    # 6. analytics: the global LCP array over the flattened index
    eng = idx.analytics()
    rep = eng.longest_repeat()
    motif = alphabet.decode(s[rep["witness"]:rep["witness"] + rep["length"]])
    print(f"longest repeated substring: {rep['length']} symbols × "
          f"{rep['count']} occurrences ({motif[:32]!r}…)")
    print(f"distinct substrings: {eng.distinct_substrings():,}")
    rng = np.random.default_rng(1)
    query = np.concatenate([s[500:540],
                            rng.integers(0, 4, size=40).astype(np.uint8)])
    ms, witness = eng.matching_stats(query)
    assert ms[0] >= 40  # the planted slice matches at least itself
    print(f"matching statistics: planted head matches {ms[0]} symbols, "
          f"random tail averages {ms[40:].mean():.1f}")

    # 7. observability: the flight recorder (repro_torch.obs) traces spans
    #    and counts metrics across the build, the kernels and the serving
    #    stack — off by default (REPRO_TRACE=1 / REPRO_METRICS=1, or
    #    obs.configure in a script).  Turn it on BEFORE making what you
    #    want observed: instruments bind when they are created.
    from repro_torch import obs
    obs.configure(trace=True, metrics_on=True, clear=True)
    dev2 = ix.build_device(s, max_pattern_len=64)
    run_closed_loop(dev2, stream,
                    ServeConfig(pipeline=True, cache_size=256, max_batch=2))
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace_path, prom_path = obs.export_all(
        trace_path=str(out / "era_trace.json"),
        metrics_path=str(out / "era_metrics.prom"))
    spans = obs.tracer().events()
    hits_total = obs.metrics().counter("serve_cache_hits_total").value
    dispatches = sum(i.value for i in obs.metrics().instruments()
                     if i.name == "kernel_dispatch_total")
    print(f"flight recorder: {len(spans)} spans -> {trace_path} "
          f"(open at https://ui.perfetto.dev or chrome://tracing)")
    print(f"metrics snapshot -> {prom_path} (cache hits counted: "
          f"{hits_total:.0f}, kernel dispatches: {dispatches:.0f})")
    obs.configure(trace=False, metrics_on=False, clear=True)

    # 8. sharded index fabric: build_sharded runs the elastic loop over a
    #    mesh of devices (by default every device of the indexer's type; a
    #    device may repeat) and cuts the leaf arrays by route key into
    #    shards; find_batch splits each batch by route.  save() writes one
    #    archive per shard ({path}_shard{k}.npz).
    sh = ix.build_sharded(s, n_shards=2, max_pattern_len=64)
    for a, b in zip(sh.find_batch(batch), dev.find_batch(batch)):
        assert np.array_equal(a, b)
    print(f"sharded fabric agrees ✓ ({sh.n_shards} shards over "
          f"{len(set(sh.mesh))} device(s), route depth k={sh.k_route}; "
          f"serve with: python -m repro_torch.launch.serving --shards N, "
          f"bench with: python -m repro_torch.launch.shard_run --mode bench)")

    # 9. out-of-core streaming + incremental append: build_stream slices the
    #    groups into chunks whose state fits device_budget bytes and copies
    #    chunk k+1 onto the device behind chunk k's loop; append_device
    #    extends a built index, rebuilding only the affected sub-trees, and
    #    bumps its epoch so AsyncServer.update_index flushes its caches.
    dev_s, sr = ix.build_stream(s, device_budget=64 << 10,
                                max_pattern_len=64)
    for a, b in zip(dev_s.find_batch(batch), dev.find_batch(batch)):
        assert np.array_equal(a, b)
    print(f"streaming build agrees ✓ ({sr.n_chunks} chunks, "
          f"overlap_frac={sr.overlap_frac:.2f})")
    extra = np.random.default_rng(9).integers(
        0, alphabet.base - 1, size=500).astype(s.dtype)
    s_grown = np.concatenate([s[:-1], extra, s[-1:]])
    tight = EraIndexer(alphabet,
                       dataclasses.replace(cfg, memory_bytes=8 << 10),
                       device=device)
    dev_t = tight.build_device(s, max_pattern_len=64)
    arep = AppendReport()
    dev_g, _ = tight.append_device(dev_t, s_grown, arep)
    full = tight.build_device(s_grown, max_pattern_len=64)
    for a, b in zip(dev_g.find_batch(batch), full.find_batch(batch)):
        assert np.array_equal(a, b)
    print(f"incremental append agrees ✓ (rebuilt {arep.n_affected}/"
          f"{arep.n_prefixes} sub-trees, reuse_frac={arep.reuse_frac:.2f}, "
          f"epoch {dev_t.epoch}→{dev_g.epoch})")

    # 10. engine knobs: REPRO_SORT=lexsort and REPRO_COMPACT=off pin the
    #     oracle engines, EraConfig(node_lcp="words") rebuilds the node
    #     build's divergence rows from the text — all as in the JAX
    #     package.  Its tile autotuning has no counterpart in the port:
    #     each card kernel has one launch shape (a sweep of the block size
    #     found none worth choosing), so --autotune is accepted by the
    #     drivers without effect.
    print("autotuned tiles: no counterpart in the port (one launch shape "
          "per kernel; the drivers accept --autotune without effect)")


if __name__ == "__main__":
    main()
