"""The port's live telemetry plane against the JAX package's, on the CPU.

``split_learning_torch/runtime/telemetry.py`` and ``sketch.py`` are the
JAX package's framework-free modules, copied.  Each scenario here runs
the same inputs, under the same injected ``now`` clocks, through both
packages' classes and asserts equal results: the gauge registry, the
snapshot's dict round trip (garbage degrading to ``None``), the
emitter's beats, send-failure count and stop, the ``FleetMonitor``'s
states, transitions, straggler scores and ``snapshot()`` under
duplicated, reordered, silent and recovering clients, the digest
roll-up (``build_digest`` / ``note_digest`` / ``drop_digest`` and the
watchlist cap), the sketches' merges and quantiles, the ``/metrics``
page byte for byte and ``lint_prometheus``'s findings on the JAX
package's own negative cases.  The port's exporter is then driven over
localhost beside the JAX package's.  One difference is held on its own:
the port's emitter beats on a fixed grid, on a fake clock.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from split_learning_torch.runtime import sketch as tsk
from split_learning_torch.runtime import telemetry as ttel
from split_learning_torch.runtime import trace as ttr
from split_learning_tpu.runtime import sketch as jsk
from split_learning_tpu.runtime import telemetry as jtel
from split_learning_tpu.runtime import trace as jtr

PKGS = {"jax": (jtel, jsk, jtr), "torch": (ttel, tsk, ttr)}


def both(fn):
    """``fn(telemetry, sketch, trace)`` for each package: (jax, torch)."""
    return tuple(fn(*PKGS[k]) for k in ("jax", "torch"))


def _beat(seq, t, rate=10.0, part="c", **kw):
    return {"part": part, "t": t, "seq": seq, "samples": seq * 10,
            "samples_per_s": rate, **kw}


# -- registries and snapshots ----------------------------------------------

def test_gauge_registry_and_states_match():
    assert ttr.GAUGE_NAMES == jtr.GAUGE_NAMES
    assert ttel.HEALTH_STATES == jtel.HEALTH_STATES
    assert list(tsk._SEVERITY) == list(ttel.HEALTH_STATES)
    assert tsk.DIGEST_GAUGE_NAMES <= ttr.GAUGE_NAMES
    assert tsk.DIGEST_COUNTER_NAMES <= ttr.FAULT_COUNTER_NAMES
    for name in ("heartbeat_errors", "stale_heartbeats", "fleet_lost_drops"):
        assert name in ttr.FAULT_COUNTER_NAMES


def test_gauge_set_matches():
    def run(tel, sk, tr):
        g = tel.GaugeSet()
        out = [g.get("round"), g.get("round", 7.0)]
        g.set("round", 3)
        g.set("epoch", 1.5)
        g.set("round", 4)
        out += [g.get("round"), g.snapshot()]
        return out
    j, t = both(run)
    assert j == t == [None, 7.0, 4.0, {"round": 4.0, "epoch": 1.5}]


SNAPSHOT_INPUTS = [
    _beat(1, 100.0),
    dict(_beat(2, 101.0), stage=2, round=3, kind="agg_node",
         gauges={"round": 3.0}, counters={"drops": 1},
         wire={"bytes_out_total": 10}, latency={"step": {"p95_ms": 2.0}}),
    dict(_beat(3, 102.0), future_field=1, v=2),   # a newer sender
    {"part": "c"},                                 # missing t and seq
    {"part": "c", "t": 1.0, "seq": 1, "bogus": 1, "samples": 0},
    ["not", "a", "dict"],
    None,
    "garbage",
    {"part": "c", "t": 1.0, "seq": 1, "gauges": None},
]


@pytest.mark.parametrize("i", range(len(SNAPSHOT_INPUTS)))
def test_snapshot_round_trip_matches(i):
    d = SNAPSHOT_INPUTS[i]

    def run(tel, sk, tr):
        s = tel.TelemetrySnapshot.from_dict(d)
        return None if s is None else s.as_dict()
    j, t = both(run)
    assert j == t
    if isinstance(d, dict) and "t" in d:
        assert t is not None and t["part"] == "c"


# -- the emitter --------------------------------------------------------------

def test_emitter_beats_match():
    def run(tel, sk, tr):
        fc, wc, hs = tr.FaultCounters(), tr.WireCounters(), tr.HistogramSet()
        g = tel.GaugeSet()
        n = {"v": 0}
        sent = []
        em = tel.TelemetryEmitter("client_1_0", sent.append, interval=0.5,
                                  faults=fc, wire=wc, hists=hs, gauges=g,
                                  samples_fn=lambda: n["v"], stage=1)
        out = []
        for k, now in enumerate((100.0, 100.5, 101.0, 101.5, 102.0)):
            n["v"] = (k * 8) if k < 3 else 4   # a per-round reset at k = 3
            g.set("round", k // 3)
            fc.inc("drops")
            wc.count_out("intermediate_queue_1_0", 100 * (k + 1))
            hs.observe("step", 0.001 * (k + 1))
            out.append(em.snapshot(now=now).as_dict())
        em.note_samples(5)
        return out
    j, t = both(run)
    assert j == t
    assert [b["seq"] for b in t] == [1, 2, 3, 4, 5]
    assert t[2]["samples_per_s"] > 0 and t[2]["round"] == 0
    assert t[3]["round"] == 1 and t[0]["stage"] == 1


def _emitter_run(tel, tr, send, interval=0.01, wait_calls=1):
    fc = tr.FaultCounters()
    calls = {"n": 0}

    def counted(d):
        calls["n"] += 1
        send(d)
    em = tel.TelemetryEmitter("c", counted, interval=interval, faults=fc)
    em.start()
    em.start()   # idempotent
    deadline = time.monotonic() + 30.0
    while calls["n"] < wait_calls and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    thread = em._thread
    em.stop()
    return calls["n"], fc.snapshot().get("heartbeat_errors", 0), thread


class ChaosCrash(RuntimeError):
    """Matched by name, as the emitter matches the transports' own."""


@pytest.mark.parametrize("kind", ["errors", "chaos_crash"])
def test_emitter_send_failures_match(kind):
    def send(d):
        raise (OSError("gone") if kind == "errors" else ChaosCrash("dead"))

    def run(tel, sk, tr):
        n, errors, thread = _emitter_run(tel, tr, send,
                                         wait_calls=3 if kind == "errors"
                                         else 1)
        return n, errors, thread.is_alive()
    j, t = both(run)
    assert j == t
    # three failures in a row stop the thread; a scripted crash at once,
    # uncounted (the process is dead, not flaky)
    assert t == ((3, 3, False) if kind == "errors" else (1, 0, False))


def test_emitter_stop_and_disabled_match():
    def run(tel, sk, tr):
        sent = []
        n, errors, thread = _emitter_run(tel, tr, sent.append,
                                         wait_calls=2)
        off = tel.TelemetryEmitter("c", sent.append, interval=0)
        off.start()
        return n >= 2, errors, thread.is_alive(), off._thread is None, \
            all(d["part"] == "c" for d in sent)
    j, t = both(run)
    assert j == t == (True, 0, False, True, True)


@pytest.mark.parametrize("cost", [0.3, 1.2])
def test_emitter_beats_on_a_fixed_grid(monkeypatch, cost):
    """Where the JAX package's thread waits a whole interval after each
    beat, the port's beats at start + k * interval whatever a beat
    costs (the GIL shared with training threads included); a beat
    longer than the interval skips the slots it covered instead of
    sending them in a burst.  Driven on a fake clock."""
    import types
    clock = {"t": 100.0}
    beats = []

    def send(d):
        beats.append(round(clock["t"], 6))
        clock["t"] += cost

    class Stop:
        waits = 0

        def wait(self, timeout):
            clock["t"] += timeout
            Stop.waits += 1
            return Stop.waits > 6

        def set(self):
            pass

    monkeypatch.setattr(ttel, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"], time=lambda: clock["t"]))
    em = ttel.TelemetryEmitter("c", send, interval=0.5)
    em._stop = Stop()
    em._run()
    assert beats == ([100.5, 101.0, 101.5, 102.0, 102.5, 103.0]
                     if cost < 0.5 else
                     [100.5, 101.7, 102.9, 104.1, 105.3, 106.5])


# -- the fleet monitor --------------------------------------------------------

def _monitor_script(tel, tr):
    """One long beat stream through a FleetMonitor: first contact, a
    duplicate and a reordered beat, a frame from a client with heartbeats
    off, the pump gate, silence through degraded and straggler to lost,
    recovery through degraded, a rate-scored straggler, async version
    lag, forget and the on_lost hook.  Returns everything observable."""
    fc, g = tr.FaultCounters(), tel.GaugeSet()
    fm = tel.FleetMonitor(interval=1.0, liveness_timeout=5.0, gauges=g,
                          faults=fc)
    lost_hook = []
    fm.on_lost = lost_hook.append
    out = []

    def look(now):
        out.append(("advance", now, sorted(fm.advance(now=now)),
                    fm.states(), fm.snapshot(now=now)))
    for c in ("a", "b", "c"):
        out.append(fm.note_heartbeat(c, _beat(1, 100.0, 10.0, c,
                                              stage=1, round=0), now=100.0))
    fm.note_frame("quiet", now=100.0)       # heartbeats disabled there
    look(100.2)
    out.append(fm.note_heartbeat("a", _beat(1, 100.0), now=100.3))   # dup
    out.append(fm.note_heartbeat("a", _beat(2, 101.0, 11.0, "a"),
                                 now=101.0))
    out.append(fm.note_heartbeat("a", _beat(1, 100.5), now=101.1))  # late
    out.append(fm.note_heartbeat("b", _beat(2, 101.0, 2.0, "b",
                                            gauges={"compute_samples_per_s":
                                                    50.0}), now=101.0))
    out.append(fm.note_heartbeat("c", _beat(2, 101.0, 9.0, "c",
                                            gauges={"compute_samples_per_s":
                                                    52.0}), now=101.0))
    look(101.2)                             # b rate-scored straggler
    fm.note_pump(now=101.2)
    for now in (102.9, 103.5, 104.0):
        fm.note_pump(now=now)
        for c in ("a", "b"):
            fm.note_heartbeat(c, _beat(int(now * 10), now, 10.0, c),
                              now=now)
        look(now)                           # c degrades, then straggles
    look(120.0)                             # pump stale: frozen
    for c in ("a", "b"):
        fm.note_heartbeat(c, _beat(1200, 120.0, 10.0, c), now=120.0)
    fm.note_pump(now=120.0)
    look(120.1)                             # c, quiet lost
    out.append(fm.note_heartbeat("c", _beat(1, 99.0), now=120.2))  # stale
    out.append(fm.note_heartbeat("c", _beat(99, 120.3, 10.0, "c"),
                                 now=120.3))   # back: degraded
    for c in ("a", "b"):
        fm.note_heartbeat(c, _beat(1300, 120.3, 10.0, c), now=120.3)
    fm.note_pump(now=120.4)
    look(120.4)                             # c healthy again
    fm.note_version(5)
    fm.note_client_version("a", 3, now=120.5)
    fm.note_client_version("a", 2, now=120.5)   # older: ignored
    fm.note_pump(now=120.5)
    look(120.5)                             # a stale by version lag
    fm.forget("quiet")
    fm.watch("b")
    fm.watch("b", pinned=False)
    out.append(("paged", fm.snapshot(now=121.0, series=False, page=0,
                                     per_page=2),
                fm.snapshot(now=121.0, client="a"), fm.tracked_clients(),
                sorted(fm.lost()), fm.state("a"), fm.state("nobody")))
    out.append(("transitions", list(fm.transitions)))
    out.append(("hook", lost_hook, fc.snapshot(), g.snapshot()))
    return out


def test_fleet_monitor_matches():
    j, t = both(lambda tel, sk, tr: _monitor_script(tel, tr))
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a == b
    tx = t[-2][1]
    trail = [(r["client"], r["from"], r["to"]) for r in tx]
    assert ("b", "healthy", "straggler") in trail
    assert ("c", "straggler", "lost") in trail
    assert ("c", "lost", "degraded") in trail     # recovery climbs back
    assert ("c", "degraded", "healthy") in trail
    hook, faults, gauges = t[-1][1:]
    assert sorted(hook) == ["c", "quiet"]
    assert faults == {"stale_heartbeats": 3}
    assert gauges["fleet_size"] == 4


def _digest_script(tel, sk, tr):
    """Two node monitors build digests; a server monitor folds them (and a
    duplicate, a garbage one), keeps a capped watchlist, then drops one
    node's digest."""
    out = []
    nodes = {}
    for n, clients in (("node_0", ("a", "b", "c")),
                       ("node_1", ("d", "e"))):
        fm = tel.FleetMonitor(interval=1.0, liveness_timeout=5.0)
        for i, c in enumerate(clients):
            fm.note_heartbeat(c, _beat(1, 100.0, 10.0 - 4 * (c == "b"), c,
                                       stage=1 + i % 2,
                                       latency={"step": {"p95_ms": 3.0 + i}},
                                       gauges={"compute_samples_per_s":
                                               40.0 + i},
                                       counters={"drops": i}), now=100.0)
        fm.advance(now=100.1)
        nodes[n] = fm
    fc = tr.FaultCounters()
    srv = tel.FleetMonitor(interval=1.0, liveness_timeout=5.0, faults=fc,
                           watchlist_size=2)
    srv.note_heartbeat("direct", _beat(1, 100.0, 9.0, "direct"), now=100.0)
    for seq, now in ((1, 100.2), (2, 101.2)):
        for n, fm in nodes.items():
            d = fm.build_digest(n, seq, now=now, k=2)
            out.append(("digest", n, d))
            out.append(srv.note_digest(n, d, now=now))
    out.append(srv.note_digest("node_0", out[-4][2], now=101.3))   # dup
    out.append(srv.note_digest("node_1", {"t": "x"}, now=101.3))
    out.append(srv.note_digest("node_1", None, now=101.3))
    out.append(("advance", sorted(srv.advance(now=101.4)),
                srv.snapshot(now=101.4), srv.digest_totals()))
    srv.drop_digest("node_1", now=101.5)
    out.append(("dropped", srv.snapshot(now=101.5), fc.snapshot()))
    return out


def test_digest_roll_up_matches():
    j, t = both(_digest_script)
    assert j == t
    snap = t[-2][2]
    assert t[-5:-2] == [False, False, False]   # duplicate, garbage, None
    assert snap["digest"]["clients"] == 5
    assert len(snap["watchlist"]) <= 2
    assert t[-1][2] == {"stale_digests": 3}


# -- sketches -----------------------------------------------------------------

def test_sketches_match():
    def run(tel, sk, tr):
        a, b = sk.ValueSketch(), sk.ValueSketch()
        for v in (0.5, 1.0, 3.0, 7.5, 100.0, None, 0.0, -1.0,
                  float("nan"), float("inf")):
            a.observe(v)
        for v in (2.0, 2.1, 2.2, 50.0):
            b.observe(v)
        m = sk.ValueSketch().merge(a).merge(b.as_dict()).merge(None) \
            .merge({"n": "x"})
        w = sk.WorstK(3)
        for cid, st, sc in (("x", "healthy", 1.0), ("y", "lost", None),
                            ("z", "straggler", 0.2), ("x", "degraded", 0.9),
                            ("q", "healthy", 0.1), ("", "lost", 0.0)):
            w.add(cid, st, sc, view={"k": cid})
        w2 = sk.WorstK(2).merge(w).merge([{"client": "r", "state": "lost",
                                           "score": 0.0}])
        d1, d2 = sk.empty_digest(), sk.empty_digest()
        d1.update(node="n0", t=1.0, seq=1, clients=2,
                  states={"healthy": 2}, counters={"drops": 3}, samples=9,
                  rate=a.as_dict(), worst=w.top(),
                  stages={"1": {"n": 2, "crate": b.as_dict(),
                                "step_ms": a.as_dict()}},
                  transitions=[{"t": 0.5, "client": "x"}])
        d2.update(node="n1", t=2.0, seq=4, clients=1,
                  states={"lost": 1}, counters={"drops": 1}, samples=1,
                  crate=b.as_dict(), worst=w2.top())
        merged = sk.merge_digests([d1, d2, None], k=2)
        return ([a.quantile(q) for q in (0, 50, 95, 100)], a.mean(),
                m.as_dict(), [m.quantile(q) for q in (25, 50, 99)],
                sk.ValueSketch().quantile(50),
                sk.ValueSketch.from_dict("bad"), w.top(), w2.top(), merged,
                sk.digest_quantiles(merged),
                [sk.decode_digest(x) for x in (d1, {"states": []},
                                               {"t": "nan?"}, 3)],
                [sk.bucket_index(x) for x in (0.001, 1.0, 1.19, 1e6)])
    j, t = both(run)
    assert j == t
    assert t[8]["clients"] == 3 and t[8]["counters"] == {"drops": 4}


# -- the /metrics page --------------------------------------------------------

def _render(tel, sk, tr, cap=None):
    fc = tr.FaultCounters()
    fc.inc("drops", 2)
    fc.inc("retraces")
    wc = tr.WireCounters()
    wc.count_out("rpc_queue", 123)
    wc.count_in("reply_c", 45)
    hs = tr.HistogramSet()
    for v in (0.001, 0.002, 0.004, 0.5):
        hs.observe("frame_rtt", v)
    hs.observe("step", 0.03)
    g = tel.GaugeSet()
    g.set("round", 2)
    g.set("mfu", 0.31)
    g.set("agg_shadow_bytes", 4096)
    g.set("samples_per_s", float("nan"))   # not finite: left out
    fm = tel.FleetMonitor(interval=1.0, liveness_timeout=10.0, gauges=g)
    fm.note_heartbeat('we"ird\\name\n', _beat(1, 100.0, 10.0), now=100.0)
    fm.note_heartbeat("c2", _beat(1, 100.0, 1.0, gauges={"mfu": 0.2}),
                      now=100.0)
    fm.note_heartbeat("c3", _beat(1, 100.0, 8.0), now=100.0)
    fm.note_version(4)
    fm.note_client_version("c3", 2, now=100.0)
    fm.advance(now=100.5)
    node = tel.FleetMonitor(interval=1.0, liveness_timeout=10.0)
    node.note_heartbeat("d1", _beat(1, 100.0, 5.0), now=100.0)
    fm.note_digest("node_0", node.build_digest("node_0", 1, now=100.2),
                   now=100.2)
    # the page reads the monitor's clock: pin it to the script's
    orig = fm.snapshot
    fm.snapshot = lambda **kw: orig(now=101.0, **kw)
    return tel.render_prometheus(fleet=fm, faults=fc, wire=wc, hists=hs,
                                 gauges=g, max_client_series=cap)


@pytest.mark.parametrize("cap", [None, 2])
def test_render_prometheus_byte_for_byte(cap):
    j, t = both(lambda tel, sk, tr: _render(tel, sk, tr, cap))
    assert t == j
    assert ttel.lint_prometheus(t) == jtel.lint_prometheus(j) == []
    assert "sl_fleet_digest_nodes 1" in t
    # the cap keeps the worst first: the hostile name is a healthy one
    assert (r"we\"ird\\name\n" in t) == (cap is None)
    assert ("sl_fleet_client_series 2" in t) == (cap == 2)


LINT_NEGATIVES = [
    "0bad_name 1\n",
    "# TYPE m counter\nm{l=unquoted} 1\n",
    '# TYPE m counter\nm{l="v"} notafloat\n',
    "no_type_declared 1\n",
    '# TYPE m gauge\nm{a="1"} 1\nm{a="1"} 2\n',
    '# TYPE m gauge\nm{a="x\\q"} 1\n',
    '# TYPE m bogus\nm 1\n',
    '# HELP 9m help\n# TYPE m gauge\nm 1\n',
    '# TYPE m gauge\nm{a="1",a="2"} 1\n',
    '# TYPE m gauge\nm{a="1" 1\n',
    '# TYPE m gauge\nm{1a="1"} 1\n',
    ('# HELP http_requests_total Total requests.\n'
     '# TYPE http_requests_total counter\n'
     'http_requests_total{method="post",code="200"} 1027\n'
     '# TYPE rpc_duration_seconds summary\n'
     'rpc_duration_seconds{quantile="0.5"} 4.3e-05\n'
     'rpc_duration_seconds_count 2693\n'),
]


@pytest.mark.parametrize("i", range(len(LINT_NEGATIVES)))
def test_lint_findings_match(i):
    text = LINT_NEGATIVES[i]
    j, t = both(lambda tel, sk, tr: tel.lint_prometheus(text))
    assert j == t
    assert bool(t) == (i != len(LINT_NEGATIVES) - 1)


# -- the exporter over localhost ----------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, None


def _post(url):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_exporter_over_localhost_matches():
    def run(tel, sk, tr):
        fm = tel.FleetMonitor(interval=1.0, liveness_timeout=10.0)
        fm.note_heartbeat("c1", _beat(1, 100.0), now=100.0)
        fm.note_heartbeat("c2", _beat(1, 100.0, 9.0), now=100.0)
        fm.advance(now=100.1)
        seen = []

        def fleet(query=None):
            seen.append(dict(query or {}))
            return fm.snapshot(now=100.2, client=(query or {}).get("client"))
        ex = tel.TelemetryExporter(
            lambda: tel.render_prometheus(fleet=fm), fleet).start()
        try:
            assert ex.url.startswith("http://127.0.0.1:") and ex.port > 0
            m = _get(f"{ex.url}/metrics")
            f = _get(f"{ex.url}/fleet")
            one = _get(f"{ex.url}/fleet?client=c2&full=1")
            missing = _get(f"{ex.url}/nope")
            prof = _post(f"{ex.url}/profile?steps=2")
            # concurrent scrapes (the exporter's threads) while the
            # monitor is fed
            errs = []

            def scrape():
                for _ in range(5):
                    s, _, body = _get(f"{ex.url}/metrics")
                    errs.extend(tel.lint_prometheus(body) if s == 200
                                else [s])
            ths = [threading.Thread(target=scrape) for _ in range(4)]
            for th in ths:
                th.start()
            for k in range(20):
                fm.note_heartbeat("c1", _beat(2 + k, 101.0 + k), now=101.0)
            for th in ths:
                th.join(timeout=30)
        finally:
            ex.close()
        return (m[0], m[1], tel.lint_prometheus(m[2]), f[0], f[1],
                json.loads(f[2]), json.loads(one[2]), missing[0], prof,
                seen[-1], errs)
    j, t = both(run)
    assert j == t
    assert t[0] == 200 and t[1].startswith("text/plain") and t[2] == []
    assert t[3] == 200 and t[5]["clients"]["c1"]["state"] == "healthy"
    assert list(t[6]["clients"]) == ["c2"]
    assert t[7] == 404 and t[8] == 404   # no profile_fn: as the JAX one
    assert t[9] == {"client": "c2", "full": "1"}
