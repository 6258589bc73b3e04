"""A protocol round that loses a client, through the port's telemetry
plane and the JAX package's, on the CPU.

A tiny float32 KWT at ``[2, 1]`` under strict SDA (``sda-size: 2``),
one batch a feeder: the head steps both feeders' batches as one window
in sorted origin order, so that every client's steps are fixed.
``client_1_1`` dies of a scripted crash right after its only activation
goes out, before its epoch fence.  With heartbeats every 0.5 s
and a liveness timeout of 10 s, far above any stall a loaded test host
causes, both packages' ``FleetMonitor`` mark the same client ``lost``,
release the NOTIFY and UPDATE barriers early with the same
``fleet_lost_drops``, fold the same surviving UPDATEs and end with
parameters within 1e-4 of each other (the float32 wire's bound in
``tests/test_torch_protocol.py``).  Nothing is asserted on walls.

Then the port's round runs in a process where ``jax``, ``flax``,
``optax``, ``split_learning_tpu`` and ``ml_dtypes`` cannot be imported,
with heartbeats on and the exporter serving: every scrape of
``/metrics`` taken mid-round lints clean, ``/fleet`` names the clients,
``tools/sl_top.py`` renders it, every UPDATE carries a snapshot and
``metrics.jsonl`` gets a ``kind=fleet`` record.
"""

import ast
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.runtime import chaos as tchaos
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime import trace as ttrace
from split_learning_torch.runtime.bus import InProcTransport as TBus
from split_learning_torch.runtime.client import ProtocolClient as TClient
from split_learning_torch.runtime.server import ProtocolServer as TServer
from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import chaos as jchaos
from split_learning_tpu.runtime import protocol as jproto
from split_learning_tpu.runtime import trace as jtrace
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.server import ProtocolServer as JServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "split_learning_tpu", "ml_dtypes")
#: the modules of the telemetry plane and every module it touched
PLANE = ("telemetry.py", "sketch.py", "trace.py", "protocol.py",
         "client.py", "server.py", "aggregate.py")
DEAD = "client_1_1"
LIVENESS = 10.0
TOL = 1e-4

TINY = {
    "model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
    "global-rounds": 1, "synthetic-size": 48, "val-max-batches": 1,
    "val-batch-size": 16, "compute-dtype": "float32",
    "model-kwargs": {"embed_dim": 16, "num_heads": 2, "mlp_dim": 32,
                     "dropout_rate": 0.0},
    "topology": {"cut-layers": [2]},
    "aggregation": {"strategy": "sda", "sda-size": 2, "sda-strict": True,
                    "local-rounds": 1},
    "distribution": {"num-samples": 4},
    "transport": {"wire-dtype": "float32"},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "sgd",
                 "learning-rate": 0.05, "momentum": 0.9},
    "observability": {"heartbeat-interval": 0.5,
                      "liveness-timeout": LIVENESS},
    "checkpoint": {"save": False},
}
CRASH = {"client": DEAD, "queue": "intermediate_queue*", "after": 1}


@pytest.mark.parametrize("name", PLANE)
def test_plane_modules_import_no_jax(name):
    tree = ast.parse((ROOT / "split_learning_torch/runtime" / name)
                     .read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names
    assert not [n for n in names if n.split(".")[0] in BLOCKED], names


def _recording(base, proto):
    """``base`` bus that notes who sent each UPDATE (and whether it
    carried a snapshot) and counts heartbeat frames by client."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.updates: list = []
            self.beats: dict = {}
            self._asm = proto.FrameAssembler()
            self._rec = threading.Lock()

        def publish(self, queue, payload):
            if queue == proto.RPC_QUEUE:
                with self._rec:
                    msg = self._asm.feed(payload)
                    kind = type(msg).__name__
                    if kind == "Update":
                        self.updates.append((msg.client_id,
                                             bool(msg.telemetry)))
                    elif kind == "Heartbeat":
                        self.beats[msg.client_id] = \
                            self.beats.get(msg.client_id, 0) + 1
            super().publish(queue, payload)
    return Recording


def _run(server, clients, crash_cls, **serve_kw):
    crashed = []

    def run(c):
        try:
            c.run()
        except crash_cls:
            crashed.append(c.client_id)
    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    try:
        result = server.serve(**serve_kw)
    finally:
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread failed to stop"
    return result, crashed


def _ids(cfg):
    return [(f"client_{s}_{i}", s) for s, n in enumerate(cfg.clients, 1)
            for i in range(n)]


def _lost_drops(faults, before):
    return faults.snapshot().get("fleet_lost_drops", 0) \
        - before.get("fleet_lost_drops", 0)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_round_that_loses_a_client_matches_the_jax_package(tmp_path):
    jc = jcfg.from_dict(dict(TINY, **{"log-path": str(tmp_path / "jax")}))
    tc = tcfg.from_dict(dict(TINY, **{"log-path": str(tmp_path / "torch")}))
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])

    jbus = _recording(JBus, jproto)()
    jserver = JServer(jc, transport=jbus, client_timeout=120)
    jserver.ctx.init_variables = lambda: {"params": p0, "batch_stats": {}}
    jcrash = jchaos.ChaosTransport(
        jbus, jcfg.ChaosConfig(enabled=True, crash=(CRASH,)), name=DEAD)
    before = jtrace.default_fault_counters.snapshot()
    jres, jcrashed = _run(jserver, [
        JClient(jc, cid, s, transport=jcrash if cid == DEAD else jbus)
        for cid, s in _ids(jc)], jchaos.ChaosCrash)
    j_drops = _lost_drops(jserver.ctx.faults, before)

    tbus = _recording(TBus, tproto)()
    tserver = TServer(tc, tbus, client_timeout=120, device="cpu")
    tcrash = tchaos.ChaosTransport(
        tbus, tcfg.ChaosConfig(enabled=True, crash=(CRASH,)), name=DEAD)
    before = ttrace.default_fault_counters.snapshot()
    tclients = [TClient(tc, cid, s, tcrash if cid == DEAD else tbus,
                        device="cpu") for cid, s in _ids(tc)]
    tres, tcrashed = _run(tserver, tclients, tchaos.ChaosCrash,
                          init_params=from_jax_params(p0))
    t_drops = _lost_drops(tserver.ctx.faults, before)

    assert jcrashed == tcrashed == [DEAD]
    jfleet, tfleet = jserver.ctx.fleet, tserver.ctx.fleet
    assert jfleet.lost() == tfleet.lost() == frozenset({DEAD})
    # NOTIFY and UPDATE each released early for the dead feeder
    assert j_drops == t_drops == 2
    for fleet in (jfleet, tfleet):
        # no survivor was ever marked lost
        assert {t["client"] for t in fleet.transitions
                if t["to"] == "lost"} == {DEAD}
    want = {"client_1_0", "client_2_0"}
    assert {c for c, _ in jbus.updates} == {c for c, _ in tbus.updates} \
        == want
    assert all(tel for _, tel in tbus.updates)   # every UPDATE a snapshot
    assert all(tbus.beats.get(c, 0) > 0 for c in want)
    # the crashed client's heartbeat thread ended with it
    dead = next(c for c in tclients if c.client_id == DEAD)
    assert dead.telemetry._thread is None
    a, b = jres.history[0], tres.history[0]
    assert a.ok and b.ok and a.num_samples == b.num_samples == 4
    assert abs(a.val_loss - b.val_loss) < TOL, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(tres.params, tserver.ctx.full_model)))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    start = dict(jax.tree_util.tree_leaves_with_path(p0))
    assert len(flat_j) == len(final_t)
    moved = 0.0
    for path, leaf in flat_j:
        np.testing.assert_allclose(final_t[path], leaf, rtol=TOL, atol=TOL,
                                   err_msg=str(path))
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert moved > 1e-3   # the round trained


def test_fleet_round_with_exporter_runs_with_jax_blocked(tmp_path):
    d = dict(TINY, **{
        "log-path": str(tmp_path), "global-rounds": 2, "clients": [2, 2],
        "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
        "aggregation": {"strategy": "fedavg"},
        "distribution": {"num-samples": 8},
        "observability": {"heartbeat-interval": 0.25,
                          "liveness-timeout": 60.0, "http-port": 0}})
    code = "\n".join([
        "import json, pathlib, sys, threading, urllib.request",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "sys.path.insert(0, 'tools')",
        "import sl_top",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime import server as srv",
        "from split_learning_torch.runtime.telemetry import lint_prometheus",
        "made = []",
        "Server = srv.ProtocolServer",
        "class Kept(Server):",
        "    def __init__(self, *a, **kw):",
        "        super().__init__(*a, **kw)",
        "        made.append(self)",
        "srv.ProtocolServer = Kept",
        "scrapes, done = [], threading.Event()",
        "def poll():",
        "    while not done.is_set():",
        "        if made and made[0].exporter is not None:",
        "            url = made[0].exporter.url",
        "            try:",
        "                with urllib.request.urlopen(url + '/metrics',"
        " timeout=5) as r:",
        "                    m = r.read().decode()",
        "                f = sl_top.fetch_fleet(url)",
        "            except Exception:",
        "                f = None",
        "            if f is not None:",
        "                scrapes.append((lint_prometheus(m), f))",
        "        done.wait(0.1)",
        "th = threading.Thread(target=poll, daemon=True)",
        "th.start()",
        f"run = srv.run_inproc(from_dict({d!r}), device='cpu',"
        " client_timeout=300)",
        "done.set(); th.join(timeout=10)",
        "assert [(r.ok, r.num_samples) for r in run.result.history]"
        " == [(True, 16), (True, 16)], run.result.history",
        "ids = {'client_1_0', 'client_1_1', 'client_2_0', 'client_2_1'}",
        "assert scrapes, 'no scrape landed mid-round'",
        "assert all(errs == [] for errs, _ in scrapes)",
        "assert any(set(f['clients']) == ids for _, f in scrapes)",
        "out = sl_top.render_fleet(scrapes[-1][1], color=False)",
        "assert 'client_2_1' in out and 'STATE' in out, out",
        "fleet = run.server.ctx.fleet",
        "assert not fleet.lost() and set(fleet.states()) == ids",
        "assert all(c['counters'] is not None"
        " for c in fleet.snapshot()['clients'].values())",
        "assert all(c.telemetry._thread is None for c in run.clients)",
        f"recs = [json.loads(l) for l in pathlib.Path({str(tmp_path)!r})"
        ".joinpath('metrics.jsonl').read_text().splitlines()]",
        "fl = [r for r in recs if r.get('kind') == 'fleet']",
        "assert len(fl) == 2 and set(fl[-1]['fleet']['clients']) == ids",
        "assert run.server.exporter is not None",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('fleet round ok', len(scrapes))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "fleet round ok" in out.stdout
