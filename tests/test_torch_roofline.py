"""PyTorch port vs the JAX package: the roofline terms and the report.

``repro_torch.roofline.analysis`` reckons each collective's wire bytes
from a recorded (kind, result bytes, group size), where
``repro.roofline.analysis.parse_collectives`` parses the same facts from
HLO text: synthetic HLO lines of every kind, with iota and list replica
groups and g = 1, 2, 16, 256 (and tuple results, ``-start`` forms) go
through the JAX parser and the same facts through the port.  The terms
divide by a limits object: given one built here from JAX's TPU constants
(none of them enters the port), ``RooflineTerms.to_dict()`` equals
JAX's.  ``repro_torch.roofline.report`` prints JAX's tables from the same
records.  Equal means equal: strings and counts exactly, floats to
1e-12 relative (the port adds the in-node and network shares of the wire
time separately).
"""

import pytest

from repro.roofline import analysis as jax_an
from repro.roofline import report as jax_report
from repro_torch.roofline import analysis as an
from repro_torch.roofline import report
from repro_torch.roofline.hopper import HopperLimits

_DT = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1}
GROUPS = (1, 2, 16, 256)


def _hlo_line(kind: str, shape: str, g: int, style: str, start: bool) -> str:
    groups = (f"replica_groups=[{256 // g if g < 256 else 1},{g}]<=[256]"
              if style == "iota" else
              "replica_groups={{" + ",".join(str(i) for i in range(g)) + "}}")
    op = kind + ("-start" if start else "")
    return (f"  %c.1 = {shape} {op}({shape} %p.0), channel_id=3, {groups}, "
            f"use_global_device_ids=true, to_apply=%add")


def _shape_bytes(shape: str) -> int:
    total = 0
    for part in shape.strip("()").split(", "):
        dt, dims = part.split("[")
        n = 1
        for d in dims.split("]")[0].split(","):
            if d:
                n *= int(d)
        total += n * _DT[dt]
    return total


SHAPES = ("f32[1024,16]{1,0}", "bf16[8,4096,128]{2,1,0}", "s32[7]{0}",
          "(bf16[64,64]{1,0}, f32[32]{0})")


@pytest.mark.parametrize("kind", an.KINDS)
@pytest.mark.parametrize("style", ["iota", "list"])
def test_wire_bytes_equal_jax_parse(kind, style):
    records, lines = [], []
    for g in GROUPS:
        for shape in SHAPES:
            for start in (False, True):
                lines.append(_hlo_line(kind, shape, g, style, start))
                records.append((kind, _shape_bytes(shape), g, g <= 8))
                one = jax_an.parse_collectives(lines[-1])
                assert one.count_by_kind == {kind: 1}
                assert an.wire_bytes(kind, records[-1][1], g) == \
                    pytest.approx(one.wire_bytes, rel=1e-12)
    want = jax_an.parse_collectives("\n".join(lines))
    got = an.collective_stats(records)
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert got.total_bytes == want.total_bytes
    # the in-node groups (g <= 8 here) are the part not on the network
    net = sum(an.wire_bytes(*r[:3]) for r in records if not r[3])
    assert got.network_wire_bytes == pytest.approx(net, rel=1e-12)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        an.wire_bytes("all-scatter", 8, 2)


def _tpu_limits() -> HopperLimits:
    ici = jax_an.ICI_LINKS * jax_an.ICI_BW
    return HopperLimits(hbm_bytes_per_s=jax_an.HBM_BW,
                        bf16_flops=jax_an.PEAK_FLOPS,
                        nvlink_bytes_per_s=ici, network_bytes_per_s=ici)


TERMS = [
    dict(flops=3.1e15, hbm_bytes=2.2e11, wire_bytes=4.0e9, chips=256,
         model_flops=5.5e17),
    dict(flops=1.0e12, hbm_bytes=8.0e12, wire_bytes=0.0, chips=512,
         model_flops=2.0e14),
    dict(flops=2.0e9, hbm_bytes=1.0e6, wire_bytes=7.5e12, chips=256,
         model_flops=0.0),
    dict(flops=0.0, hbm_bytes=0.0, wire_bytes=0.0, chips=1, model_flops=0.0),
]


@pytest.mark.parametrize("kw", TERMS)
@pytest.mark.parametrize("net_share", [0.0, 0.5, 1.0])
def test_terms_equal_jax_on_jax_limits(kw, net_share):
    want = jax_an.RooflineTerms(**kw).to_dict()
    got = an.RooflineTerms(**kw, network_wire_bytes=net_share * kw["wire_bytes"],
                           limits=_tpu_limits()).to_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k


def test_terms_default_to_hopper_and_split_links():
    lim = HopperLimits()
    t = an.RooflineTerms(flops=lim.bf16_flops, hbm_bytes=lim.hbm_bytes_per_s,
                         wire_bytes=lim.nvlink_bytes_per_s
                         + lim.network_bytes_per_s,
                         network_wire_bytes=lim.network_bytes_per_s, chips=8)
    assert (t.t_compute, t.t_memory) == (1.0, 1.0)
    assert t.t_collective == pytest.approx(2.0, rel=1e-12)
    assert t.bottleneck == "collective"


class _Counts:
    flops, hbm_bytes = 4.0e12, 1.0e9
    collectives = [("all-reduce", 1 << 20, 16, False),
                   ("all-gather", 1 << 10, 4, True)]


def test_terms_from_counts():
    terms, coll = an.terms_from_counts(_Counts, 256, 1.0e15)
    assert coll.count_by_kind == {"all-reduce": 1, "all-gather": 1}
    assert terms.wire_bytes == coll.wire_bytes
    assert terms.network_wire_bytes == 2 * 15 / 16 * (1 << 20)
    assert terms.flops == 4.0e12 and terms.chips == 256


def _records():
    ok = lambda arch, shape, mesh, tc, tm, tx, useful, colls, peak, t: {
        "arch": arch, "shape": shape, "mesh": mesh, "remat_policy": "none",
        "variant": "base", "status": "ok", "t_compile_s": t,
        "memory": {"peak_estimate_bytes": peak},
        "collectives": {"counts": colls},
        "roofline": {"t_compute_s": tc, "t_memory_s": tm,
                     "t_collective_s": tx,
                     "bottleneck": max(
                         {"compute": tc, "memory": tm, "collective": tx}.items(),
                         key=lambda kv: kv[1])[0],
                     "useful_flops_ratio": useful,
                     "mfu_upper_bound": useful * 0.37}}
    return [
        ok("qwen3-1.7b", "train_4k", "16x16", 0.8, 0.3, 0.1, 0.45,
           {"all-reduce": 28, "all-gather": 3}, 3.2e10, 12.5),
        ok("qwen3-1.7b", "prefill_32k", "2x16x16", 0.01, 0.4, 0.02, 0.9,
           {}, 5.0e9, 3.0),
        ok("qwen3-1.7b", "decode_32k", "16x16", 1e-5, 2e-3, 0.0, 0.99,
           {"all-gather": 1}, 7.7e8, 1.1),
        ok("gemma3-4b", "train_4k", "16x16", 0.1, 0.2, 3.0, 0.8,
           {"reduce-scatter": 2}, 1.0e12, 40.0),
        ok("falcon-mamba-7b", "long_500k", "16x16", 0.0, 5e-4, 2e-7, 0.7,
           {}, 12.0, 0.5),
        ok("era-genome", "prepare_2.1G", "16x16", 1e-4, 0.03, 0.0, 0.0,
           {}, 2.2e9, 9.9),
        {"arch": "qwen3-14b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped",
         "reason": "full-attention arch: long_500k skipped (DESIGN.md)"},
        {"arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "2x16x16",
         "status": "error", "error": "RuntimeError: " + "x" * 100},
    ]


def test_tables_equal_jax():
    recs = _records()
    assert report.dryrun_table(recs) == jax_report.dryrun_table(recs)
    assert report.roofline_table(recs) == jax_report.roofline_table(recs)
    for r in recs:
        if r["status"] == "ok":
            assert report._diagnose(r) == jax_report._diagnose(r)
    for x in (0, 1e-7, 2.5e-4, 0.5, 3.25, 1234.5):
        assert report._fmt_s(x) == jax_report._fmt_s(x)
    for b in (None, 0, 1023, 4096, 5.5e9, 3e15, 2e18):
        assert report._fmt_bytes(b) == jax_report._fmt_bytes(b)


def test_table_reads_the_trace_time():
    rec = dict(_records()[0])
    del rec["t_compile_s"]
    rec["t_trace_s"] = 7.25
    assert "| 7.25s |" in report.dryrun_table([rec])


def test_report_main(tmp_path, capsys):
    import json

    path = tmp_path / "d.json"
    path.write_text(json.dumps(_records()))
    import sys

    argv = sys.argv
    sys.argv = ["report", "--json", str(path)]
    try:
        report.main()
        port = capsys.readouterr().out
        jax_report.main()
        jax_out = capsys.readouterr().out
    finally:
        sys.argv = argv
    assert port == jax_out
    assert port.startswith("## Dry-run summary: 6 ok / 1 skipped / 1 errors")
