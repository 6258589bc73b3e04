"""A traced protocol round in the port against the JAX package's, on the
CPU.

The smallest VGG protocol parity recipe (``tests/test_torch_vgg_round.py``
``PROTOCOL``: VGG16 cut at layer 7, ``clients: [1, 1]``, float32, the
int8 codec on both data planes, the stage-update kernels, the sharded
fold), here at server momentum 0.9, runs one round in one process
through each package with tracing on (the default ``observability``
block, heartbeats off so that no timer-driven frame reaches the rpc
queue), and once more through the port with tracing off.  Checks, all
exact:

* per participant, the multiset of ``(span name, parent span's name,
  round)`` is the JAX package's, and every ``consume`` span's parent is
  a ``publish`` span in the sender's journal;
* the latency histograms' counts per name and participant, the
  process-wide ``queue_wait`` count, and the wire counters' frames,
  encodes and decodes are the JAX package's;
* the wire counters' data-plane bytes are what the bus carried, and
  exceed the JAX package's by 2 bytes a frame: each frame's pickled
  metadata names its message class's module, and ``split_learning_torch``
  is two characters longer than ``split_learning_tpu`` (a property of
  the reference's frame format, not a fault);
* the traced round is bit for bit the untraced one, its data frames
  exactly 32 bytes longer each;
* ``tools/sl_trace.py`` splits the port's round into components that sum
  to the round's wall within 1 ms.

Beside the round: a ``ReliableTransport`` exchange with duplicated
envelopes observes ``transport_rtt`` once per arrival in both packages,
and ``run_training`` in process writes ``phases`` with the JAX
package's keys.
"""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import test_torch_vgg_round as vgg
from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import bus as jbus
from split_learning_tpu.runtime import trace as jtrace
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, from_jax_stats
from split_learning_torch.runtime import bus as tbus
from split_learning_torch.runtime import trace as ttrace
from split_learning_torch.runtime.server import run_inproc

ROOT = pathlib.Path(__file__).resolve().parents[1]

RECIPE = dict(
    vgg.PROTOCOL,
    aggregation=dict(vgg.PROTOCOL["aggregation"],
                     **{"server-momentum": 0.9}),
    observability={"heartbeat-interval": 0})

#: span names of planes the port does not have yet, left out of the
#: structural comparison: the perf plane's CompileWatch spans (its
#: per-round records are off in the JAX run as well)
UNPORTED_SPANS = frozenset({"compile"})

#: the data-plane queues' frames here: 2 activations and 2 gradients
DATA_FRAMES = 4


def _serve_jax(cfg, p0, s0):
    """The JAX package's protocol round over one shared in-process bus;
    (result, server, clients)."""
    bus = jbus.InProcTransport()
    server = JServer(cfg, transport=bus, client_timeout=120)
    server.ctx.init_variables = lambda: {"params": p0, "batch_stats": s0}
    clients = [JClient(cfg, f"client_{s}_{i}", s, transport=bus)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    result = server.serve()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "client thread failed to stop"
    return result, server, clients


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _counts(hists) -> dict:
    return {name: h["count"] for name, h in hists.snapshot().items()}


def _journals(directory: pathlib.Path) -> list[dict]:
    """Every span record under ``directory`` (the run-scoped journals,
    not their compat links)."""
    recs = []
    for path in sorted(directory.rglob("spans-*.jsonl")):
        if not path.is_symlink():
            recs += [json.loads(line)
                     for line in path.read_text().splitlines()]
    return recs


def _structure(recs: list[dict]) -> dict:
    by_id = {r["span"]: r for r in recs}
    out: dict = collections.defaultdict(collections.Counter)
    for r in recs:
        if r["name"] in UNPORTED_SPANS:
            continue
        parent = by_id.get(r.get("parent"))
        out[r["part"]][(r["name"], parent["name"] if parent else None,
                        r.get("round"))] += 1
    return dict(out)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory, init_vars):
    p0, s0 = init_vars
    tmp = tmp_path_factory.mktemp("trace_round")
    jc = jcfg.from_dict(dict(RECIPE, **{"log-path": str(tmp / "jax")},
                             perf={"enabled": False}))
    hist0 = {"jax": _counts(jtrace.default_histograms),
             "port": _counts(ttrace.default_histograms)}
    wire0 = jtrace.default_wire_counters.snapshot()
    jres, jserver, jclients = _serve_jax(jc, p0, s0)
    jwire = _delta(jtrace.default_wire_counters.snapshot(), wire0)

    def port(label: str, enabled: bool):
        cfg = tcfg.from_dict(dict(
            RECIPE, **{"log-path": str(tmp / label)},
            observability=dict(RECIPE["observability"], enabled=enabled)))
        w0 = ttrace.default_wire_counters.snapshot()
        run = run_inproc(cfg, device="cpu", client_timeout=120,
                         init_params=from_jax_params(p0),
                         init_stats=from_jax_stats(s0))
        return run, _delta(ttrace.default_wire_counters.snapshot(), w0)

    traced, twire = port("port", True)
    hist1 = {"jax": _counts(jtrace.default_histograms),
             "port": _counts(ttrace.default_histograms)}
    untraced, _ = port("untraced", False)
    return {"tmp": tmp, "jax": (jres, jserver, jclients, jwire),
            "traced": traced, "twire": twire, "untraced": untraced,
            "queue_wait": {k: hist1[k].get("queue_wait", 0)
                           - hist0[k].get("queue_wait", 0)
                           for k in hist1}}


@pytest.fixture(scope="module")
def init_vars(no_dropout_registries):
    model = vgg.jsplit.SplitModel(
        specs=vgg.jsplit.model_registry()[vgg.NAME]())
    x = np.zeros((1, 32, 32, 3), np.float32)
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(0), x)
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


@pytest.fixture(scope="module")
def no_dropout_registries():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (vgg.jsplit, vgg.tsplit):
            mp.setitem(mod._REGISTRY, vgg.NAME,
                       vgg._no_dropout(mod._REGISTRY[vgg.NAME], mod))
        yield


def test_span_structure_matches_jax_package(rounds):
    jrecs = _journals(rounds["tmp"] / "jax")
    trecs = _journals(rounds["tmp"] / "port")
    jstruct, tstruct = _structure(jrecs), _structure(trecs)
    assert set(tstruct) == {"server", "client_1_0", "client_2_0"}
    assert tstruct == jstruct
    for recs in (jrecs, trecs):
        # one trace: the server's id, adopted by the clients from START
        assert len({r["trace"] for r in recs}) == 1
        by_id = {r["span"]: r for r in recs}
        consumes = [r for r in recs if r["name"] == "consume"]
        assert len(consumes) == DATA_FRAMES + 2   # + the two UPDATEs
        for c in consumes:
            pub = by_id[c["parent"]]
            assert pub["name"] == "publish" and pub["part"] != c["part"]
            assert pub["queue"] == c["queue"] and pub["kind"] == c["kind"]


def test_histograms_and_wire_counters_match_jax_package(rounds):
    jres, jserver, jclients, jwire = rounds["jax"]
    run, twire = rounds["traced"], rounds["twire"]
    assert _counts(run.server.ctx.hists) == _counts(jserver.ctx.hists)
    for tc, jc in zip(run.clients, jclients):
        assert tc.client_id == jc.client_id
        assert _counts(tc.hists) == _counts(jc.hists)
    assert _counts(run.server.ctx.hists)["frame_rtt"] == 2   # UPDATEs
    assert _counts(run.server.ctx.hists)["agg_fold"] == 2
    assert sum(_counts(c.hists)["frame_rtt"] for c in run.clients) \
        == DATA_FRAMES
    qw = rounds["queue_wait"]
    assert qw["port"] == qw["jax"] > 0
    for key in ("msgs_out", "msgs_in", "encode_n", "decode_n",
                "raw_bytes_out", "data_raw_bytes_out"):
        assert twire[key] == jwire[key], key
    # the port counts what its bus carried on the data plane
    bus = run.bus.bytes_out_snapshot()
    data = sum(n for q, n in bus.items()
               if q.startswith(("intermediate_queue", "gradient_queue")))
    assert twire["data_bytes_out"] == data
    # and 2 bytes a frame more than the JAX package: the pickled
    # metadata names the message class's module
    name_gap = len("split_learning_torch") - len("split_learning_tpu")
    assert twire["data_bytes_out"] - jwire["data_bytes_out"] \
        == name_gap * DATA_FRAMES


def test_traced_round_is_bit_for_bit_the_untraced_round(rounds):
    a, b = rounds["traced"], rounds["untraced"]
    assert a.result.history[0].num_samples \
        == b.result.history[0].num_samples == 8
    for ta, tb in ((a.result.params, b.result.params),
                   (a.result.stats, b.result.stats)):
        assert ta.keys() == tb.keys()
        for layer in ta:
            for k, t in ta[layer].items():
                assert torch.equal(t, tb[layer][k]), (layer, k)
    assert a.result.history[0].val_loss == b.result.history[0].val_loss
    # no journal without tracing, and 32 context bytes a data frame
    assert not list((rounds["tmp"] / "untraced").rglob("spans-*.jsonl"))
    ba, bb = a.bus.bytes_out_snapshot(), b.bus.bytes_out_snapshot()
    for q in ba:
        if q.startswith(("intermediate_queue", "gradient_queue")):
            assert ba[q] - bb[q] == 32 * 2, q   # 2 frames a queue


def test_sl_trace_splits_the_ports_round(rounds, tmp_path):
    out = tmp_path / "trace.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "sl_trace.py"),
         str(rounds["tmp"] / "port"), "--json", "-o", str(out)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout[proc.stdout.index("["):])
    assert len(report) == 1
    rep = report[0]
    assert abs(rep["components_sum_s"] - rep["wall_s"]) <= 1e-3, rep
    assert rep["frame_edges"] == DATA_FRAMES + 2
    assert rep["wall_s"] > 0 and rep["validate_s"] > 0
    trace = json.loads(out.read_text())
    flows = [e for e in trace["traceEvents"] if e["ph"] == "s"]
    assert len(flows) == DATA_FRAMES + 2


def _reliable_exchange(mod, hists, q: str = "intermediate_queue_1_0"):
    """Ten payloads through a ReliableTransport pair over one in-process
    bus, every third data envelope published twice; returns the
    payloads received and the ``transport_rtt`` observations made."""
    inner = mod.InProcTransport()
    publish = inner.publish
    n_env = [0]

    def twice(queue, payload):
        publish(queue, payload)
        if queue == q:
            if n_env[0] % 3 == 0:
                publish(queue, payload)
            n_env[0] += 1
    inner.publish = twice
    before = _counts(hists).get("transport_rtt", 0)
    tx = mod.ReliableTransport(inner, sender="a", redeliver_s=30.0)
    rx = mod.ReliableTransport(inner, sender="b", redeliver_s=30.0)
    try:
        for i in range(10):
            tx.publish(q, b"payload %d" % i)
        got = [rx.get(q, timeout=10.0) for _ in range(10)]
        assert rx.get(q, timeout=0.3) is None   # the last duplicate
    finally:
        tx.close()
        rx.close()
    return got, _counts(hists)["transport_rtt"] - before


def test_reliable_transport_rtt_counts_every_arrival_as_jax_does():
    tgot, tn = _reliable_exchange(tbus, ttrace.default_histograms)
    jgot, jn = _reliable_exchange(jbus, jtrace.default_histograms)
    assert tgot == jgot == [b"payload %d" % i for i in range(10)]
    assert tn == jn == 14   # ten frames and four duplicates


def test_run_training_writes_the_jax_packages_phases(tmp_path):
    import test_torch_round as tiny
    from split_learning_tpu.run import synthesize_registrations as jregs
    from split_learning_tpu.runtime.context import MeshContext
    from split_learning_tpu.runtime.log import Logger as JLogger
    from split_learning_tpu.runtime.loop import run_training as jrun
    from split_learning_tpu.runtime.plan import plan_clusters as jplan
    from split_learning_torch.run import synthesize_registrations as tregs
    from split_learning_torch.runtime.context import TorchContext
    from split_learning_torch.runtime.log import Logger as TLogger
    from split_learning_torch.runtime.loop import run_training as trun
    from split_learning_torch.runtime.plan import plan_clusters as tplan

    records = {}
    for label in ("jax", "port"):
        d = dict(tiny.TINY, **{"global-rounds": 1,
                               "log-path": str(tmp_path / label)},
                 distribution={"num-samples": 8},
                 checkpoint={"save": True,
                             "directory": str(tmp_path / label / "ck")})
        log_dir = tmp_path / label / "log"
        if label == "jax":
            cfg = jcfg.from_dict(d)
            jrun(cfg, MeshContext(cfg), jplan(cfg, jregs(cfg)),
                 JLogger(log_dir, console=False))
        else:
            cfg = tcfg.from_dict(d)
            trun(cfg, TorchContext(cfg, device="cpu"),
                 tplan(cfg, tregs(cfg)), TLogger(log_dir, console=False))
        lines = [json.loads(line) for line in
                 (log_dir / "metrics.jsonl").read_text().splitlines()]
        records[label] = [r for r in lines if r.get("kind") == "round"]
        names = {r["name"] for r in _journals(tmp_path / label)}
        assert {"round", "train", "validate", "checkpoint"} <= names
    tphases = records["port"][0]["phases"]
    jphases = records["jax"][0]["phases"]
    assert list(tphases) == list(jphases) == ["checkpoint", "train",
                                              "validate"]
    for name in tphases:
        assert set(tphases[name]) == set(jphases[name])
        assert tphases[name]["count"] == jphases[name]["count"] == 1
