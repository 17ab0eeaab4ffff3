"""PyTorch port vs the JAX package: the reports of the three launch modules.

``query_serve.serve_queries``, ``analytics_serve.serve_analytics`` and
``serving.serve_stream`` of the port (on the CPU) and of the JAX package,
on the same dataset, seed and sizes: every field that does not depend on
timing (hits, ``mean_match_len``, ``distinct_substrings``,
``longest_repeat``, counts, batch shapes, cache counters) is equal
exactly, and every timing field is rounded to the places JAX rounds it
to.  The port's extra keys (``device``, ``n_iter``) are its only others.
"""

import pytest

from repro.launch import analytics_serve as j_analytics
from repro.launch import query_serve as j_query
from repro.launch import serving as j_serving
from repro_torch.launch import analytics_serve as t_analytics
from repro_torch.launch import query_serve as t_query
from repro_torch.launch import serving as t_serving

# the timing fields of the JAX reports and the places each is rounded to
TIMING = {"t_build_s": 3, "qps": 1, "batch_p50_ms": 3, "batch_p99_ms": 3,
          "positions_per_s": 1, "lat_p50_ms": 3, "lat_p99_ms": 3,
          "wall_s": 4, "vs_sync": 2}
PORT_ONLY = {"device", "n_iter"}

REPORTS = {
    "query_serve": (t_query.serve_queries, j_query.serve_queries,
                    dict(n=2500, batch=32, iters=3, memory_bytes=4096,
                         seed=3)),
    "query_serve_protein": (t_query.serve_queries, j_query.serve_queries,
                            dict(n=2000, batch=16, iters=2,
                                 memory_bytes=4096, seed=5)),
    "analytics_serve": (t_analytics.serve_analytics,
                        j_analytics.serve_analytics,
                        dict(n=3000, batch=128, iters=2, window=32, seed=2)),
    "serving": (t_serving.serve_stream, j_serving.serve_stream,
                dict(n=2000, requests=192, seed=4)),
}


def _assert_report(got: dict, want: dict, where: str) -> None:
    assert set(got) - PORT_ONLY == set(want), where
    for key, w in want.items():
        g = got[key]
        if key in TIMING:
            assert g == round(g, TIMING[key]), f"{where}.{key} = {g!r}"
        elif isinstance(w, dict):
            _assert_report(g, w, f"{where}.{key}")
        else:
            assert g == w, f"{where}.{key}: {g!r} != {w!r}"


@pytest.mark.parametrize("module", sorted(REPORTS))
def test_launch_report_equals_jax(module):
    port, jax_fn, kw = REPORTS[module]
    dataset = "protein" if module.endswith("protein") else "dna"
    got = port(dataset, device="cpu", **kw)
    want = jax_fn(dataset, **kw)
    _assert_report(got, want, module)
    assert got["device"] == "cpu"
