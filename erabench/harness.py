"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics.  Driven by data: the cell, its configuration,
its traffic, its entry and each metric are files found by name
(``erabench/README.md``)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from erabench.data import strings
from erabench.reference import suffix_order as ref_mod

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names, whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (names may hold ``.`` or ``-``)."""
    name = "erabench._loaded." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell and everything its name leads to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path = ROOT

    @property
    def n(self) -> int:
        return int(self.config["n"])


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """Everything ``BENCHMARK.json`` and the cell's files say about ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    row = rows[0]
    here = root / "erabench"
    spec = load_json(here / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (row["config"], row["traffic"]):
        raise ValueError(f"{name}: its file and BENCHMARK.json disagree")
    config = load_json(here / "configs" / f"{row['config']}.json")
    traffic = load_json(here / "traffic" / f"{row['traffic']}.json")
    entry = load_module(here / "entries" / f"{traffic['entry']}.py")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(row["chips"]), config, traffic, entry, e2e,
                per_layer, root)


def make_strings(cell: Cell, seed: int) -> list[np.ndarray]:
    c = cell.config
    return [strings.synthetic_string(
        cell.n, len(c["symbols"]), seed, k,
        repeat_fraction=float(c["repeat_fraction"]),
        repeat_len=int(c["repeat_len"]))
        for k in range(int(cell.traffic["pool"]))]


@dataclasses.dataclass
class Build:
    string: int
    wall_s: float
    peak_bytes: int
    record: dict


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    builds: list = dataclasses.field(default_factory=list)
    trace: object = None     # tracing.TraceData of a traced run
    checks: dict = dataclasses.field(default_factory=dict)
    pool: list = dataclasses.field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_alphabet(cell: Cell):
    from repro_torch.core.alphabet import ALPHABETS
    alphabet = ALPHABETS[cell.config["alphabet"]]
    if alphabet.symbols != cell.config["symbols"]:
        raise ValueError(f"{cell.config['alphabet']}: the program's symbols "
                         "differ from the configuration's")
    return alphabet


def era_config(cell: Cell) -> dict:
    return {**cell.config["era_config"],
            **cell.traffic.get("era_config", {})}


def measure(cell: Cell, seed: int, seconds: float, trace: bool, *,
            device, t_start: float, log=print) -> tuple[Run, list]:
    """Set-up and the window.  Returns the run and, per build, the host
    output the comparison reads."""
    from repro_torch import obs
    device = torch.device(device)
    run = Run(cell)
    on_card = device.type == "cuda"
    if trace:
        obs.configure(trace=True, clear=True)  # before the program binds
    t = time.perf_counter()
    pool = make_strings(cell, seed)
    t_strings = time.perf_counter() - t
    params = cell.traffic.get("params", {})
    program = cell.entry.make(program_alphabet(cell), era_config(cell),
                              params, device)
    t = time.perf_counter()
    result, _ = cell.entry.run(program, pool[0], params)  # the warm build
    del result
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s (strings {t_strings:.3f} s, warm build "
        f"{time.perf_counter() - t:.3f} s); window of {seconds} s")

    kept = []
    traced = trace and on_card
    if traced:
        from erabench import tracing
        from repro_torch.kernels import ops
    span = obs.tracer().span
    with contextlib.ExitStack() as stack:
        if traced:
            taps = stack.enter_context(tracing.KernelTaps())
            dtrace = stack.enter_context(tracing.DeviceTrace())
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        while not run.builds or time.perf_counter() - t0 < seconds:
            s_i = len(run.builds) % len(pool)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            tb = time.perf_counter()
            with span("erabench/build", string=s_i):
                result, record = cell.entry.run(program, pool[s_i], params)
            t_ret = time.perf_counter()
            peak = torch.cuda.max_memory_allocated(device) if on_card else 0
            with span("erabench/keep"):
                kept.append((s_i, cell.entry.keep(result)))
            del result
            run.builds.append(Build(s_i, t_ret - tb, int(peak), record))
    run.window_s = t_ret - t0  # the last build's return closes the window
    if traced:
        run.trace = tracing.summarize(
            dtrace, taps, tracing.host_spans(obs.tracer()), t0_ns,
            t0_ns + int(run.window_s * 1e9), tuple(ops.KERNELS))
        del dtrace
    log(f"{len(run.builds)} builds in {run.window_s:.3f} s: "
        + " ".join(f"{b.wall_s:.3f}" for b in run.builds) + " s; peaks "
        + " ".join(f"{b.peak_bytes / 2**30:.3f}" for b in run.builds)
        + " GiB")
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run.pool = pool
    return run, kept


def judge(run: Run, kept: list, device, *, log=print) -> None:
    """Every kept build against the reference of its string; fills
    ``run.checks`` ({name: {"value", "limit"}}) with every count summed
    over the builds and the builds that differed."""
    device = torch.device(device)
    cell = run.cell
    base = len(cell.config["symbols"]) + 1
    f_max = ref_mod.f_max_of(int(era_config(cell)["memory_bytes"]))
    totals: dict = {}
    wrong = 0
    for s_i, s in enumerate(run.pool):
        mine = [kp for i, kp in kept if i == s_i]
        if not mine:
            continue
        t = time.perf_counter()
        ref = ref_mod.index_tables(torch.from_numpy(s).to(device), base,
                                   f_max, tree=cell.entry.TREE)
        log(f"reference of string {s_i}: {time.perf_counter() - t:.3f} s")
        for kp in mine:
            counts = cell.entry.check(kp, ref)
            wrong += any(counts.values())
            for name, v in counts.items():
                totals[name] = totals.get(name, 0) + int(v)
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    run.checks = {name: {"value": v, "limit": 0} for name, v in totals.items()}
    run.checks["wrong_builds"] = {"value": wrong, "limit": 0}


def correct(run: Run) -> bool:
    return (bool(run.builds) and bool(run.checks)
            and all(c["value"] <= c["limit"] for c in run.checks.values()))


def metric_values(run: Run, trace: bool) -> dict:
    """{name: {"value", "unit"}} of the metrics this run reports: the
    cell's end-to-end metrics, or with ``trace`` its per-layer ones; a
    reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        path = run.cell.root / "erabench" / "metrics" / f"{m['name']}.py"
        value = load_module(path).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def result_line(run: Run, trace: bool, device) -> dict:
    device = torch.device(device)
    on_card = device.type == "cuda"
    line = {
        "correct": correct(run),
        "attempted": len(run.builds),
        "failed": int(run.checks.get("wrong_builds", {}).get(
            "value", len(run.builds))),
        "metrics": metric_values(run, trace),
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": run.cell.chips,
            "memory_peak_bytes": max((b.peak_bytes for b in run.builds),
                                     default=0),
        },
    }
    if trace:
        tr = run.trace
        line["device"]["busy_s"] = tr.busy_s if tr else 0.0
        line["device"]["window_s"] = tr.window_s if tr else run.window_s
        if tr:
            line["breakdown"] = {"device_ops": tr.device_ops,
                                 "idle_gaps": tr.idle_gaps}
    line["checks"] = run.checks  # last: each number compared, its limit
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, root: Path = ROOT,
             log=None) -> dict:
    """One run of cell ``name``: its result line (the caller prints it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = find_cell(name, root)
    run, kept = measure(cell, seed, seconds, trace, device=device,
                        t_start=t_start, log=log)
    judge(run, kept, device, log=log)
    return result_line(run, trace, device)
