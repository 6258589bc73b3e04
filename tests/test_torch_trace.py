"""The port's counters, latency histograms and phase timer
(``split_learning_torch/runtime/trace.py``) against the JAX package's.

Every comparison is exact: the same call sequence (seeded numpy streams
of durations, including 0, a negative, NaN and values past the last
bucket) gives equal snapshots, percentiles and registries.  The last
test holds every string literal the port passes to ``.inc`` or
``.observe`` to the declared registries, as the JAX package's
``counters`` analyzer does for its own sources, and a stress test
holds the counters, histograms and span journal under thread contention.
"""

from __future__ import annotations

import ast
import json
import math
import os
import pathlib
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.runtime import trace as jtrace
from split_learning_torch.runtime import trace as ttrace
from split_learning_torch.runtime.spans import Tracer

PORT = pathlib.Path(__file__).resolve().parents[1] / "split_learning_torch"


def _durations(seed: int, n: int = 600) -> list[float]:
    """Log-uniform durations from 0.1 µs to 200 s, with the edge cases
    spliced in: 0, a negative (a clock stepping back), NaN, and values
    past the last bound (~64 s)."""
    rng = np.random.default_rng(seed)
    xs = list(10.0 ** rng.uniform(-7, np.log10(200.0), n))
    for i, v in zip((3, 50, 97, 201, 333, 404),
                    (0.0, -0.25, float("nan"), 64.0, 150.0, 1e-6)):
        xs.insert(i, v)
    return xs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_jax_package(seed):
    assert ttrace.LatencyHistogram.BOUNDS == jtrace.LatencyHistogram.BOUNDS
    th, jh = ttrace.LatencyHistogram(), jtrace.LatencyHistogram()
    assert th.snapshot() == jh.snapshot() == {}
    assert th.percentile(50) == jh.percentile(50) == 0.0
    for i, v in enumerate(_durations(seed)):
        th.observe(v)
        jh.observe(v)
        if i in (0, 5, 99):   # the snapshot of a short stream too
            assert th.snapshot() == jh.snapshot()
    assert th.snapshot() == jh.snapshot()
    for q in (0, 1, 50, 95, 99, 100):
        a, b = th.percentile(q), jh.percentile(q)
        assert a == b and math.isfinite(a)
    # NaN and the negative count (as 0); values past ~64 s land in the
    # overflow bucket and the max keeps them
    assert th.snapshot()["count"] == len(_durations(seed))
    assert th.snapshot()["max_ms"] >= 150.0 * 1e3


def test_histogram_set_matches_jax_package():
    ts, js = ttrace.HistogramSet(), jtrace.HistogramSet()
    names = sorted(ttrace.HISTOGRAM_NAMES)
    rng = np.random.default_rng(7)
    durs = _durations(7, 300)
    for v in durs:
        name = names[int(rng.integers(len(names)))]
        ts.observe(name, v)
        js.observe(name, v)
    assert ts.snapshot() == js.snapshot()
    assert set(ts.snapshot()) <= ttrace.HISTOGRAM_NAMES
    for name in names:
        for q in (50, 95, 99):
            assert ts.hist(name).percentile(q) == \
                js.hist(name).percentile(q)


def test_wire_counters_match_jax_package():
    tw, jw = ttrace.WireCounters(), jtrace.WireCounters()
    rng = np.random.default_rng(3)
    queues = ("intermediate_queue_1_0", "gradient_queue_1_client_1_0",
              "rpc_queue", "reply_client_1_0", "aggregate_queue_0_1")
    for _ in range(400):
        op = int(rng.integers(6))
        q = queues[int(rng.integers(len(queues)))]
        n = int(rng.integers(1, 1 << 20))
        secs = float(rng.uniform(0, 0.01))
        for w in (tw, jw):
            if op == 0:
                w.count_out(q, n)
            elif op == 1:
                w.count_in(q, n)
            elif op == 2:
                w.count_raw(q, n)
            elif op == 3:
                w.add_encode(secs)
            elif op == 4:
                w.add_decode(secs)
            else:
                w.note_send_depth(n % 9)
    assert tw.snapshot() == jw.snapshot()
    assert tw.per_queue() == jw.per_queue()
    snap = tw.snapshot()
    assert snap["data_bytes_out"] > 0 and snap["send_queue_hwm"] == 8
    assert snap["data_bytes_out"] < snap["bytes_out_total"]


def test_registries_match_jax_package():
    assert ttrace.FAULT_COUNTER_NAMES == jtrace.FAULT_COUNTER_NAMES
    assert ttrace.HISTOGRAM_NAMES == jtrace.HISTOGRAM_NAMES


def test_fault_counters_match_jax_package():
    tf, jf = ttrace.FaultCounters(), jtrace.FaultCounters()
    for name, n in (("drops", 1), ("lost", 3), ("drops", 2),
                    ("agg_dup_drops", 1)):
        tf.inc(name, n)
        jf.inc(name, n)
    assert tf.snapshot() == jf.snapshot()
    assert tf.total() == jf.total() == 7


def test_step_timer_summary_has_the_jax_packages_shape():
    tt, jt = ttrace.StepTimer(), jtrace.StepTimer()
    for timer, make in ((tt, lambda: torch.ones(4) * 2),
                        (jt, lambda: jnp.ones(4) * 2)):
        for _ in range(2):
            with timer.phase("train") as fence:
                fence(make())
                fence({"a": [make(), (make(), 3)]})
        with timer.phase("validate"):
            pass
        timer.record("checkpoint", 0.5)
    ts, js = tt.summary(), jt.summary()
    assert list(ts) == list(js) == ["checkpoint", "train", "validate"]
    for name in ts:
        assert set(ts[name]) == set(js[name]) == {"total_s", "count",
                                                   "mean_s"}
        assert ts[name]["count"] == js[name]["count"]
        assert all(isinstance(v, float) for k, v in ts[name].items()
                   if k != "count")
    assert ts["checkpoint"] == js["checkpoint"]
    tt.reset()
    assert tt.summary() == {}


def _literal_names(method: str) -> list[tuple[str, str, int]]:
    """Every ``.<method>("literal", ...)`` call in the port's sources:
    (name, file, line)."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == method and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((node.args[0].value,
                            str(path.relative_to(PORT)), node.lineno))
    return out


@pytest.mark.parametrize("method,registry", [
    ("inc", "FAULT_COUNTER_NAMES"), ("observe", "HISTOGRAM_NAMES")])
def test_port_literals_are_declared(method, registry):
    names = _literal_names(method)
    assert names, f"no .{method}(...) literal found: the scan is broken"
    declared = getattr(ttrace, registry)
    bad = [n for n in names if n[0] not in declared]
    assert not bad, f"undeclared {registry} names: {bad}"
    if method == "observe":
        # the round-tracing plane's clocks are all fed somewhere
        assert {n[0] for n in names} >= {
            "frame_rtt", "queue_wait", "transport_rtt", "step", "encode",
            "decode", "agg_fold"}


def test_counters_histograms_and_journal_under_thread_contention(tmp_path):
    """More threads than cores hammer one HistogramSet, one WireCounters
    and one span journal with the switch interval shortened: no update
    is lost and every journal line is whole."""
    hists, wire = ttrace.HistogramSet(), ttrace.WireCounters()
    tracer = Tracer("stress", journal_dir=tmp_path, flush_every=7)
    n_threads, n_ops = 2 * (os.cpu_count() or 4), 400

    def work(i: int) -> None:
        for k in range(n_ops):
            hists.observe("step", k * 1e-5)
            wire.count_out("intermediate_queue_1_0", 3)
            wire.add_decode(1e-6)
            tracer.start("publish", always=False, worker=i).end(nbytes=k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tracer.close()
    total = n_threads * n_ops
    assert hists.snapshot()["step"]["count"] == total
    snap = wire.snapshot()
    assert snap["msgs_out"] == snap["decode_n"] == total
    assert snap["data_bytes_out"] == 3 * total
    lines = (tmp_path / "spans-stress.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert len(recs) == total and len({r["span"] for r in recs}) == total
