"""Time ``kmer_histogram``, ``suffix_lcp_words`` and ``suffix_lcp_pairs``
on the card, optionally beside an earlier version of their CUDA sources.

  python -m repro_torch.launch.hist_lcp_bench                 # n = 2**27
  python -m repro_torch.launch.hist_lcp_bench --baseline DIR  # A/B

``kmer_histogram`` (phase ``kmer``): the genome and protein strings at
n = 2**N and a BYTE string of 2**N symbols, at every k the vertical
partition counts with the kernel (DNA k = 1…6, protein k = 1…3, BYTE
k = 1, 2), as CUDA-event windows (``ms``) and as the profiler's kernel
time (``device_ms``); beside the planned layout, every other layout that
holds the bins (warp copies, one histogram per block, clusters of 2 and 4
blocks), and ``torch.bincount``
of the precomputed codes (``bincount_ms``: a yardstick for the counting
step alone, not the same function).

``suffix_lcp_words`` (phases ``lcp`` and ``lcp_rounds``): the genome
index's ``ell`` at n = 2**N; the main-path pairs are adjacent suffixes
(``ell[:-1]``, ``ell[1:]``) at w = 64, also in a random order (no
adjacency to share), then the pairs still saturated at w = 128 and 256,
and 2**20 random offsets paired as neighbours in the order of their
64-symbol keys (the smoke's parity pairs) at w = 4, 64 and 256; then
``lcp_from_text`` over all adjacent pairs, the node build's loop, with
CUDA events around each launch.  ``suffix_lcp_pairs`` (the same phases,
``kernel`` naming it): the same pairs of the protein index's ``ell`` on
its terminal-padded byte string (the protein tree's main path), the
pending w = 128 round, the parity pairs, and the analytics' boundary
pairs (the last leaf of each sub-tree against the first of the next, at
the width that covers the longest prefix, no adjacency).

With ``--baseline DIR``: the same calls through the kernels built from
whichever of ``DIR/kmer_histogram.cu``, ``DIR/suffix_lcp_words.cu`` and
``DIR/suffix_lcp_pairs.cu`` it holds (the earlier C entry points of the
first two: no layout arguments, and the terminal's substitution word;
``src/repro_torch/kernels/baseline`` holds the earlier
``suffix_lcp_pairs.cu``), in turns (current, baseline, baseline,
current), their outputs held equal; ``lcp_from_text`` with each kernel in
the same turns; then, with an earlier ``kmer_histogram``, one profiled
warm ``build_device`` per dataset with each (phase ``kmer_build_ab``).

Each result is one JSON line; the card's ``nvidia-smi`` name and power
limit come first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import build as tbuild
from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.packing import _sub_word, pack_text, to_u64
from repro_torch.core.prepare import PrepareStats, _pair_lanes, _stable_order
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset
from repro_torch.kernels import _build
from repro_torch.kernels import kmer_histogram as tkmer
from repro_torch.kernels import ops
from repro_torch.launch.gather_bench import _emit, compile_baseline, in_turns

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint
KMER_KS = {"genome": range(1, 7), "protein": range(1, 4), "byte": (1, 2)}


BASELINE_ARGS = {  # the earlier C entry points
    "kmer_histogram": [_P, _I64, _I32, _I32, _I32, _P, _P, _P],
    "suffix_lcp_words": [_P, _I64, _P, _P, _I64, _I32, _I32, _I32, _I64,
                         _U32, _P, _P],
    "suffix_lcp_pairs": [_P, _I64, _P, _P, _I64, _I32, _P, _P],
}


def build_baseline(src: Path) -> dict[str, ctypes.CDLL]:
    """The earlier kernels whose sources ``src`` holds, compiled, entry
    points typed."""
    names = [n for n in BASELINE_ARGS if (src / f"{n}.cu").exists()]
    if not names:
        raise FileNotFoundError(f"{src} holds none of "
                                f"{', '.join(BASELINE_ARGS)} (.cu)")
    libs = compile_baseline(src, names)
    for name, lib in libs.items():
        getattr(lib, name).argtypes = BASELINE_ARGS[name]
        getattr(lib, name).restype = _I32
    return libs


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def baseline_kmer(lib, s, n, k, base):
    out = torch.empty(base**k, dtype=torch.int32, device=s.device)
    used = ctypes.c_int(0)
    _build.check(lib.kmer_histogram(s.data_ptr(), n, k, base, base**k,
                                    out.data_ptr(), ctypes.byref(used),
                                    _stream()), "baseline kmer_histogram")
    return out


def baseline_lcp(lib, pt, pa, pb, w):
    out = torch.empty(pa.shape[0], dtype=torch.int32, device=pa.device)
    if pa.shape[0]:
        _build.check(lib.suffix_lcp_words(
            pt.words.data_ptr(), pt.words.shape[0], pa.data_ptr(),
            pb.data_ptr(), pa.shape[0], -(-w // pt.syms_per_word), w, pt.bits,
            pt.n_real, _sub_word(pt.bits, pt.terminal), out.data_ptr(),
            _stream()), "baseline suffix_lcp_words")
    return out


def baseline_slcp(lib, sp, pa, pb, w):
    out = torch.empty(pa.shape[0], dtype=torch.int32, device=pa.device)
    if pa.shape[0]:
        _build.check(lib.suffix_lcp_pairs(
            sp.data_ptr(), sp.shape[0], pa.data_ptr(), pb.data_ptr(),
            pa.shape[0], w, out.data_ptr(), _stream()),
            "baseline suffix_lcp_pairs")
    return out


# per text-LCP kernel: the ops attribute lcp_from_text reaches, the
# kernel as a function of (text, pa, pb, w), its earlier C call, and the
# 64-symbol key read that orders the parity pairs
LCP = {
    "suffix_lcp_words": ("suffix_lcp_words",
                         lambda t, a, b, w: ops.suffix_lcp_words(t, a, b, w),
                         baseline_lcp,
                         lambda t, o: ops.range_gather_words(t, o, 64)),
    "suffix_lcp_pairs": ("_suffix_lcp_bytes",
                         lambda t, a, b, w: ops._suffix_lcp_bytes(t, a, b, w),
                         baseline_slcp,
                         lambda t, o: ops.range_gather_pack(t, o, 64)),
}


def _layouts(nbins: int, smem_optin: int) -> dict[str, tkmer.Plan]:
    """Every layout that holds ``nbins`` bins in ``smem_optin`` bytes."""
    out = {}
    copies = 32 * nbins * 4
    if copies <= smem_optin:
        out["warp_copies"] = tkmer.Plan("warp_copies", copies, 1, 0)
    if nbins * 4 <= smem_optin:
        out["block"] = tkmer.Plan("block", nbins * 4, 1, 0)
    else:
        for c in (2, 4):
            log2 = (-(-nbins // c) - 1).bit_length()
            if 4 << log2 <= smem_optin:
                out[f"cluster:{c}"] = tkmer.Plan("cluster", 4 << log2, c,
                                                 log2)
    return out


def _codes(s, n, k, base):
    codes = torch.zeros(n, dtype=torch.int64, device=s.device)
    for d in range(k):
        codes = codes * base + s[d:d + n].to(torch.int64)
    return codes


def _events_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def boundary_pairs(dev) -> tuple:
    """The analytics' boundary pairs of a built index: the last leaf of
    each sub-tree against the first of the next, at the width that covers
    the longest prefix (``AnalyticsEngine.from_index``)."""
    bnd = dev.sub_off[1:].to(torch.int64)
    w = -(-(int(dev.sub_plen.max()) + 1) // 4) * 4
    return (f"boundary w={w}", dev.ell[bnd - 1].contiguous(),
            dev.ell[bnd].contiguous(), w)


def kmer_bench(texts: dict, base_lib) -> None:
    _, smem_optin = tkmer.device_limits(torch.device("cuda"))
    for name, (s_pad, n, base) in texts.items():
        for k in KMER_KS[name]:
            nbins = base**k
            want = tkmer.kmer_histogram(s_pad, n, k, base)
            path = tkmer.kmer_histogram.last_path
            calls = {"ms": lambda: tkmer.kmer_histogram(s_pad, n, k, base)}
            for label, lay in _layouts(nbins, smem_optin).items():
                calls[f"{label}_ms"] = (lambda lay=lay: tkmer.kmer_histogram(
                    s_pad, n, k, base, layout=lay))
            if base_lib is not None:
                calls["baseline_ms"] = lambda: baseline_kmer(
                    base_lib, s_pad, n, k, base)
            for label, fn in calls.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"kmer {name} k={k} {label} differs")
            codes = _codes(s_pad, n, k, base)
            bincount_ms = _events_ms(lambda: torch.bincount(codes,
                                                            minlength=nbins))
            del codes
            device = {f"device_{key}": v for key, v in in_turns(
                calls, device=True, key="kmer_histogram").items()}
            _emit({"phase": "kmer", "dataset": name, "n": n, "k": k,
                   "bins": nbins, "path": path, **in_turns(calls), **device,
                   "bincount_ms": bincount_ms})


def sorted_pairs(keys, offs):
    """Offsets ordered by their key rows, as neighbour pairs."""
    order = _stable_order(_pair_lanes(
        [to_u64(keys[None, :, j]) for j in range(keys.shape[1])]))[0]
    o = offs[order]
    return o[:-1].contiguous(), o[1:].contiguous()


def _share(pa, pb) -> float:
    """Share of rows whose pos_a is the previous row's pos_b."""
    if pa.shape[0] < 2:
        return 0.0
    return float((pa[1:] == pb[:-1]).float().mean())


@contextlib.contextmanager
def timed_lcp(kernel: str, rounds: list, base_lib=None):
    """The ``ops`` text-LCP kernel that ``lcp_from_text`` reaches (or the
    baseline kernel) with CUDA events around each launch; each launch
    appends (w, rows, share, events)."""
    attr, _, base_fn, _ = LCP[kernel]
    saved = getattr(ops, attr)

    def call(text, pa, pb, w):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = (base_fn(base_lib, text, pa, pb, w) if base_lib is not None
               else saved(text, pa, pb, w))
        e1.record()
        rounds.append((w, pa.shape[0], _share(pa, pb), e0, e1))
        return out

    setattr(ops, attr, call)
    try:
        yield
    finally:
        setattr(ops, attr, saved)


def lcp_bench(kernel: str, text, ell, n_real: int, rng, base_lib,
              extra_cases=()) -> None:
    """The text-LCP ``kernel`` on ``text`` (a dense text for
    ``suffix_lcp_words``, the padded byte string for ``suffix_lcp_pairs``)
    at the main-path, pending and parity pairs of ``ell`` and
    ``extra_cases``, then ``lcp_from_text`` over ``ell``'s adjacent pairs,
    beside ``base_lib``'s kernel when given."""
    _, fn, base_fn, keys64 = LCP[kernel]
    a, b = ell[:-1].contiguous(), ell[1:].contiguous()
    perm = torch.from_numpy(rng.permutation(a.shape[0])).cuda()
    cases = [("main adjacent", a, b, 64), ("main shuffled", a[perm], b[perm],
                                           64)]
    lcp = fn(text, a, b, 64)
    for w in (128, 256):  # the pairs an lcp_from_text round still holds
        sat = lcp == w // 2
        a, b = a[sat] + w // 2, b[sat] + w // 2
        cases.append((f"pending w={w}", a, b, w))
        lcp = fn(text, a, b, w)
    offs = torch.from_numpy(rng.integers(0, n_real + 1, size=1 << 20)
                            .astype(np.int32)).cuda()
    pa, pb = sorted_pairs(keys64(text, offs), offs)
    cases += [(f"parity w={w}", pa, pb, w) for w in (4, 64, 256)]
    for shape, pa, pb, w in [*cases, *extra_cases]:
        calls = {"ms": lambda: fn(text, pa, pb, w)}
        if base_lib is not None:
            calls["baseline_ms"] = lambda: base_fn(base_lib, text, pa, pb, w)
        want = calls["ms"]()
        for label, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"{kernel} {shape}: {label} differs")
        device = {f"device_{key}": v for key, v in in_turns(
            calls, device=True, key=kernel).items()}
        _emit({"phase": "lcp", "kernel": kernel, "shape": shape,
               "rows": pa.shape[0], "w": w, "adjacent_share": _share(pa, pb),
               **in_turns(calls), **device})
    # the node build's loop over every adjacent pair, each kernel in turns
    a, b = ell[:-1].contiguous(), ell[1:].contiguous()
    who_order = (["current", "baseline", "baseline", "current"]
                 if base_lib is not None else ["current", "current"])
    runs = {}
    accs = {}
    for who in who_order:
        rounds = []
        lib = base_lib if who == "baseline" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_lcp(kernel, rounds, lib):
            accs[who] = tbuild.lcp_from_text(text, a, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.setdefault(who, []).append({
            "wall_s": wall,
            "kernel_ms": sum(e0.elapsed_time(e1) for *_, e0, e1 in rounds),
            "rounds": [{"w": w, "rows": r, "adjacent_share": sh,
                        "ms": e0.elapsed_time(e1)}
                       for w, r, sh, e0, e1 in rounds]})
    if base_lib is not None and not torch.equal(accs["current"],
                                                accs["baseline"]):
        raise AssertionError("lcp_from_text: kernel and baseline differ")
    _emit({"phase": "lcp_rounds", "kernel": kernel, "pairs": a.shape[0],
           **{f"{who}_{k}": float(np.median([r[k] for r in rs]))
              for who, rs in runs.items() for k in ("wall_s", "kernel_ms")},
           "runs": runs})


def _profiled_build(s, alpha) -> dict:
    """One warm ``build_device`` under the profiler: seconds, the
    ``kmer_histogram`` kernels' device ms and all device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    report = BuildReport(VerticalStats(), PrepareStats())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dev = EraIndexer(alpha, EraConfig()).build_device(s, report)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del dev
    torch.cuda.empty_cache()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU]
    ms = lambda rs: sum(getattr(e, "self_device_time_total", 0)
                        for e in rs) / 1e3
    return {"t_total_s": wall, "t_vertical_s": report.t_vertical,
            "kmer_ms": ms([e for e in rows if "kmer_histogram" in e.key]),
            "device_ms": ms(rows)}


def kmer_build_ab(strings: dict, lib) -> None:
    """Profiled warm builds with the current and the baseline
    ``kmer_histogram``, in turns, per dataset."""
    saved = ops.kmer_histogram
    for name, (s, alpha) in strings.items():
        EraIndexer(alpha, EraConfig()).build_device(s)  # warm-up
        runs = {"current": [], "baseline": []}
        for who in ("current", "baseline", "baseline", "current"):
            if who == "baseline":
                ops.kmer_histogram = (lambda sx, n, k, base: baseline_kmer(
                    lib, sx, n, k, base))
            try:
                runs[who].append(_profiled_build(s, alpha))
            finally:
                ops.kmer_histogram = saved
        _emit({"phase": "kmer_build_ab", "dataset": name,
               **{f"{who}_{k}": float(np.median([r[k] for r in rs]))
                  for who, rs in runs.items() for k in rs[0]},
               "runs": runs})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory of earlier kmer_histogram.cu, "
                         "suffix_lcp_words.cu or suffix_lcp_pairs.cu to time "
                         "beside these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hist_lcp_bench: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    _emit({"phase": "device", "nvidia_smi": smi,
           "name": torch.cuda.get_device_name(0)})
    _build.build_all()
    base_libs = build_baseline(args.baseline) if args.baseline else {}
    n = 1 << args.n_log2
    rng = np.random.default_rng(5)
    strings = {name: dataset(name, n, seed=0) for name in ("genome",
                                                           "protein")}
    texts = {}
    for name, (s, alpha) in strings.items():
        pad = np.full(8, alpha.terminal_code, np.uint8)
        texts[name] = (torch.from_numpy(np.concatenate([s, pad])).cuda(),
                       len(s), alpha.base)
    texts["byte"] = (torch.from_numpy(rng.integers(0, 256, size=n + 8)
                                      .astype(np.uint8)).cuda(), n, 256)
    kmer_bench(texts, base_libs.get("kmer_histogram"))
    del texts
    cfg = EraConfig()
    s, alpha = strings["genome"]
    ell = EraIndexer(alpha, cfg).build_device(s).ell
    pt = pack_text(s, alpha, extra=2 * cfg.w_max + 8, device="cuda")
    lcp_bench("suffix_lcp_words", pt, ell, pt.n_real, rng,
              base_libs.get("suffix_lcp_words"))
    del ell, pt
    torch.cuda.empty_cache()
    s, alpha = strings["protein"]
    dev = EraIndexer(alpha, cfg).build_device(s)
    sp = torch.from_numpy(alpha.pad_string(s, extra=2 * cfg.w_max + 8)).cuda()
    lcp_bench("suffix_lcp_pairs", sp, dev.ell, len(s) - 1, rng,
              base_libs.get("suffix_lcp_pairs"),
              extra_cases=[boundary_pairs(dev)])
    del dev, sp
    torch.cuda.empty_cache()
    if "kmer_histogram" in base_libs:
        kmer_build_ab(strings, base_libs["kmer_histogram"])
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
