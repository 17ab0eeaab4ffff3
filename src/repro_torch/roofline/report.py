"""The dry-run and roofline tables from the dry run's JSON records — the
port of ``repro.roofline.report``: the same tables from the same records.

The port's records (:mod:`repro_torch.launch.dryrun`) time the trace
under ``t_trace_s``, where the JAX package's time the compile under
``t_compile_s``; the ``compile`` column shows whichever the record holds.

    PYTHONPATH=src python -m repro_torch.roofline.report [--json experiments/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import json


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | per-dev peak mem | compile | collectives |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "ok":
            mem = _fmt_bytes(r["memory"]["peak_estimate_bytes"])
            colls = ",".join(f"{k}×{v}" for k, v in
                             sorted(r["collectives"]["counts"].items())) or "none"
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {mem} "
                f"| {r.get('t_compile_s', r.get('t_trace_s', '-'))}s | {colls} |")
        else:
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                f"| - | - | {reason} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | t_compute | t_memory | t_collective | "
        "bottleneck | MODEL_FLOPS/HLO | MFU@roofline | one-line diagnosis |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        diag = _diagnose(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_fmt_s(t['t_compute_s'])} | {_fmt_s(t['t_memory_s'])} "
            f"| {_fmt_s(t['t_collective_s'])} | **{t['bottleneck']}** "
            f"| {t['useful_flops_ratio']:.2f} | {t['mfu_upper_bound'] * 100:.1f}% "
            f"| {diag} |")
    return "\n".join(lines)


def _diagnose(r) -> str:
    t = r["roofline"]
    bt = t["bottleneck"]
    shape = r["shape"]
    if r["arch"].startswith("era"):
        return "string gather + key sort traffic; zero-collective step proves no-merge parallelism"
    if bt == "memory":
        if shape.startswith("train") or shape.startswith("prefill"):
            return "S² attention logits/probs HBM traffic dominates → flash-attention kernel"
        return "KV-cache streaming is the floor; raise batch or quantize cache"
    if bt == "collective":
        return "vocab-sharded CE gather + TP all-reduces → local one-hot CE, overlap"
    if t["useful_flops_ratio"] < 0.6:
        return "full-remat recompute wastes FLOPs → dots-saveable policy"
    return "near compute roofline"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="experiments/dryrun_torch.json")
    args = ap.parse_args()
    with open(args.json) as f:
        recs = json.load(f)
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    err = [r for r in recs if r["status"] == "error"]
    print(f"## Dry-run summary: {len(ok)} ok / {len(skip)} skipped / {len(err)} errors\n")
    print(dryrun_table(recs))
    print()
    print("## Roofline\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
