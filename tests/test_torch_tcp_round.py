"""The port's protocol round over TCP, on the CPU.

Participants run in threads of this process, but every frame crosses a
socket: the server and each client build their transport stack from the
config (``make_runtime_transport``: a ``TcpTransport`` to the broker, a
second connection for receive prefetch, the async sender outermost), as
the deployment's processes do.  The config is test_torch_protocol.py's
tiny float32 TinyLlama (``clients: [1, 1, 1]``, ``control-count: 1``,
dropout 0, two rounds, the sharded fold with FedAvgM at 0.9).

* Against the port's in-process round (one shared ``InProcTransport``)
  the TCP round is equal bit for bit: samples, validation losses and
  every final parameter, with the float32 wire and with the int8 codec.
  The transport moves bytes; with one batch in flight every stage steps
  in the same order, so nothing else may differ.
* Against the JAX package's TCP round (its own broker and stack) from
  the same initial weights (``convert.from_jax_params``), at
  test_torch_protocol.py's tolerances: float32 wire — samples equal,
  validation loss and parameters within 1e-4; int8 — every parameter
  within 1e-2 and 99 % within 1e-4.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime.bus import Broker as JBroker
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import from_jax_params, to_jax_params
from split_learning_torch.runtime.bus import AsyncTransport, Broker
from split_learning_torch.runtime.client import ProtocolClient
from split_learning_torch.runtime.server import ProtocolServer, run_inproc

from test_torch_protocol import INT8, TINY_PROTOCOL

VARIANTS = {"fp32_wire": {}, "int8_codec": INT8}


def _dicts(tmp, over, port=None):
    d = dict(TINY_PROTOCOL, **over, **{"log-path": str(tmp)})
    if port is not None:
        d["transport"] = dict(d["transport"], kind="tcp", port=port)
    return d


def _clients(cfg, make):
    return [make(cfg, f"client_{s}_{i}", s)
            for s, n in enumerate(cfg.clients, start=1) for i in range(n)]


def _serve(server, clients, **kw):
    errors = []

    def run(c):
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    result = server.serve(**kw)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "client thread failed to stop"
    assert not errors, errors
    return result


def run_torch_tcp(cfg, init_params):
    broker = Broker("127.0.0.1", 0)
    try:
        cfg = dataclasses.replace(cfg, transport=dataclasses.replace(
            cfg.transport, port=broker.port))
        server = ProtocolServer(cfg, device="cpu", client_timeout=120)
        assert isinstance(server.ctx.bus, AsyncTransport)
        clients = _clients(cfg, lambda c, cid, s: ProtocolClient(
            c, cid, s, device="cpu"))
        res = _serve(server, clients, init_params=init_params)
        return server, clients, res, broker.stats()
    finally:
        broker.close()


def run_jax_tcp(cfg, p0):
    broker = JBroker("127.0.0.1", 0)
    try:
        cfg = dataclasses.replace(cfg, transport=dataclasses.replace(
            cfg.transport, port=broker.port))
        server = JServer(cfg, client_timeout=120)
        server.ctx.init_variables = lambda: {"params": p0,
                                             "batch_stats": {}}
        return _serve(server, _clients(cfg, lambda c, cid, s: JClient(
            c, cid, s)))
    finally:
        broker.close()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request, tmp_path_factory):
    from split_learning_tpu.runtime.context import MeshContext
    variant = request.param
    tmp = tmp_path_factory.mktemp(variant)
    over = VARIANTS[variant]
    jc = jcfg.from_dict(_dicts(tmp / "jax", over, port=0))
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    init = from_jax_params(p0)
    inproc = run_inproc(tcfg.from_dict(_dicts(tmp / "inproc", over)),
                        device="cpu", client_timeout=120,
                        init_params=init)
    tcp = run_torch_tcp(tcfg.from_dict(_dicts(tmp / "tcp", over, port=0)),
                        init)
    return {"variant": variant, "p0": p0, "inproc": inproc, "tcp": tcp,
            "jax": run_jax_tcp(jc, p0)}


def test_tcp_round_equals_inproc_round_bit_for_bit(runs):
    a = runs["inproc"].result
    server, _, b, _ = runs["tcp"]
    assert len(a.history) == len(b.history) == 2
    for ra, rb in zip(a.history, b.history):
        assert ra.ok and rb.ok
        assert ra.num_samples == rb.num_samples == 32
        assert ra.val_loss == rb.val_loss, (ra, rb)
    assert a.params.keys() == b.params.keys()
    for layer, sd in a.params.items():
        assert sd.keys() == b.params[layer].keys()
        for k, t in sd.items():
            assert torch.equal(t, b.params[layer][k]), (layer, k)


def test_tcp_round_went_through_the_broker(runs):
    """Every participant's frames crossed the broker: START and UPDATE
    weights both ways, and each data-plane hop."""
    server, clients, res, stats = runs["tcp"]
    assert stats["published"] == stats["delivered"] > 0
    assert stats["depth"] == 0 and stats["backpressure_pauses"] == 0
    weights = sum(t.numel() * 4 for sd in res.params.values()
                  for t in sd.values())
    # two rounds of START down and UPDATE up, each a full model's weights
    assert stats["bytes_in"] > 4 * weights
    out = server.ctx.bus.bytes_out_snapshot()
    assert sum(n for q, n in out.items() if q.startswith("reply_")) \
        > 2 * weights
    if runs["variant"] == "int8_codec":
        assert all(c.raw_bytes_out for c in clients[:2])


def test_tcp_round_matches_jax_package_tcp_round(runs):
    tol, bulk = ((1e-4, 1.0) if runs["variant"] == "fp32_wire"
                 else (1e-2, 0.99))
    jres = runs["jax"]
    server, _, tres, _ = runs["tcp"]
    assert len(jres.history) == len(tres.history) == 2
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok
        assert a.num_samples == b.num_samples == 32
        assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = to_jax_params(tres.params, server.ctx.full_model)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jres.params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(final_t))
    assert len(flat_j) == len(flat_t)
    close = total = 0
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], leaf, rtol=tol, atol=tol,
                                   err_msg=str(path))
        close += int((np.abs(flat_t[path] - leaf) <= 1e-4).sum())
        total += leaf.size
    assert close >= bulk * total, (close, total)
