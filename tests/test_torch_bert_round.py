"""BERT with LoRA as the port's protocol round, and two KWT variants in
process, against the JAX package's, on the CPU.

**The protocol round.**  A tiny float32 BERT (hidden 32, 2 heads, 2
blocks, FFN 64, vocab 128, the 128-token AG-News sequences; dropout off)
with ``lora-rank: 8, lora-alpha: 16`` at ``clients: [1, 1]``, cut 2, the
int8 codec on both cut directions, one round through both packages'
``ProtocolServer`` and one ``ProtocolClient`` thread per client over an
``InProcTransport``, from the same weights, with the JAX package's
adapters (each client draws its own at START) injected into the port's
clients.  ``control-count: 1`` keeps the clients in lockstep
(``tests/test_torch_protocol.py``).  Held:

* samples equal, validation loss within 1e-4, every merged parameter
  within 1e-2 and 99% of them within 1e-4 (``test_torch_protocol.py``'s
  int8 tolerances; measured: loss 2.5e-6 apart, largest parameter
  difference 3.6e-7, every parameter within 1e-4);
* the wire, leaf by leaf.  The activation is ``(hidden, mask)``: a
  quantized float hidden leaf and the bool mask; the gradient is
  ``(hidden gradient, mask gradient)``: a quantized hidden gradient and
  float32 zeros for the mask (the JAX package's ``float0`` cotangent),
  in both packages.  The masks are equal bit for bit in both directions.
  The JAX package's first activation and first gradient tree, handed to
  the port's client, give the JAX package's codes and scales bit for bit
  as its codec's numpy twin (``quantize_np``, which divides in IEEE
  float32 as the port does) computes them, with their dtypes and shapes;
  against the payload the JAX package sent, whose XLA:CPU chain divides
  by the constant qmax as a multiply by its reciprocal, each scale is
  within one ulp and the codes equal in every tile whose scale is equal
  and at most one step apart elsewhere (``tests/test_torch_codec.py``'s
  rule; measured: 1 of 64 activation tiles and 4 of 64 gradient tiles
  one ulp off, no code).  Each package's own first activation
  quantizes float32 values that differ by summation order, so a code
  may flip at a .5 boundary: those payloads are held to 99.9% equal
  codes (measured: all equal; 39 and 58 of 64 scales an ulp apart).

**The variants in process.**  ``examples/variants/dcsl.yaml`` (SDA,
``sda-size: 2``, 2 local rounds) and ``flex.yaml`` (periodic,
``t-client: 2, t-global: 4``) as written, but for float32 compute, the
position embedding's dropout off (the parity recipe) and dcsl's depth
(1 of its 2 rounds: its lr decay recompiles the JAX package's step,
≈ 40 s here, and ``tests/test_torch_strategies.py`` holds the decay),
through both packages' ``run_training`` from the same weights.  AdamW (lr 1e-3)
turns float32 summation-order noise on near-zero gradients into whole
steps (``tests/test_torch_strategies.py``), so the parameters are held
in norm: samples and validated rounds equal, validation loss within
1e-3 (measured 3.1e-6 for dcsl and 1.1e-6 for flex), every parameter
within 1e-2 of the JAX package's (measured 2.6e-3 and 3.0e-3), the
run's parameter change within 5e-2 of the JAX package's in norm
(measured 1.1e-2 and 1.1e-2).
"""

import copy
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu import config as jcfg
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime import client as jclient
from split_learning_tpu.runtime.bus import InProcTransport as JBus
from split_learning_tpu.runtime.client import ProtocolClient as JClient
from split_learning_tpu.runtime.codec import quant as jquant
from split_learning_tpu.runtime.codec import wire_raw_nbytes as j_raw_nbytes
from split_learning_tpu.runtime.context import MeshContext
from split_learning_tpu.runtime.log import Logger as JLogger
from split_learning_tpu.runtime.loop import run_training as jrun
from split_learning_tpu.runtime.plan import plan_clusters as jplan
from split_learning_tpu.runtime.protocol import QuantLeaf as JQuantLeaf
from split_learning_tpu.runtime.server import ProtocolServer as JServer
from split_learning_torch import config as tcfg
from split_learning_torch.convert import (
    from_jax_lora, from_jax_params, to_jax_params,
)
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime import client as tclient
from split_learning_torch.runtime.codec import wire_raw_nbytes
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger as TLogger
from split_learning_torch.runtime.loop import run_training as trun
from split_learning_torch.runtime.plan import plan_clusters as tplan
from split_learning_torch.runtime.protocol import Float0, QuantLeaf
from split_learning_torch.runtime.server import run_inproc

ROOT = pathlib.Path(__file__).resolve().parents[1]

BERT_LORA = {
    "model": "BERT", "dataset": "AGNEWS", "clients": [1, 1],
    "global-rounds": 1, "synthetic-size": 32, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 32, "num_heads": 2,
                     "intermediate_size": 64, "n_block": 2,
                     "max_position_embeddings": 128, "dropout_rate": 0.0},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 16},
    "transport": {"wire-dtype": "float32",
                  "codec": {"intermediate": "int8", "gradient": "int8"}},
    "kernels": {"quantize": True, "dequantize": True},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "adamw",
                 "learning-rate": 1e-3, "lora-rank": 8, "lora-alpha": 16},
    "checkpoint": {"save": False},
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A recorded wire tree as host values (a float0 leaf as its
    shape)."""
    def conv(leaf):
        if getattr(leaf, "dtype", None) == jax.dtypes.float0:
            return Float0(np.shape(leaf))
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().numpy().copy()
        if isinstance(leaf, Float0):
            return leaf
        return np.array(leaf)
    return tuple(conv(t) for t in tree) if isinstance(tree, tuple) \
        else conv(tree)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """One LoRA protocol round in each package, recording the first
    activation and gradient wire tree (before the codec) and payload
    (after it) of each."""
    tmp = tmp_path_factory.mktemp("bert_round")
    d = dict(BERT_LORA, **{"log-path": str(tmp)})
    jc, tc = jcfg.from_dict(d), tcfg.from_dict(d)
    p0 = jax.tree_util.tree_map(np.asarray,
                                MeshContext(jc).init_variables()["params"])
    mp = pytest.MonkeyPatch()
    lock = threading.Lock()
    rec = {"jax": {}, "torch": {}}
    drawn = {}
    real_init = jclient.lora_init

    def spy_init(rng, frozen, **kw):
        out = real_init(rng, frozen, **kw)
        drawn.setdefault(frozenset(frozen), []).append(
            jax.tree_util.tree_map(np.asarray, out))
        return out
    mp.setattr(jclient, "lora_init", spy_init)
    real_out, real_host = JClient._wire_out, JClient._wire_host

    def wire_out(self, tree, family, queue):
        with lock:
            rec["jax"].setdefault(family + "_tree", _np(tree))
            rec["jax"].setdefault(family + "_raw",
                                  j_raw_nbytes(tree, np.float32))
        return real_out(self, tree, family, queue)

    def wire_host(self, tree, family):
        out = real_host(self, tree, family)
        with lock:
            rec["jax"].setdefault(family, out)
        return out
    mp.setattr(JClient, "_wire_out", wire_out)
    mp.setattr(JClient, "_wire_host", wire_host)
    try:
        bus = JBus()
        server = JServer(jc, transport=bus, client_timeout=120)
        server.ctx.init_variables = lambda: {"params": p0,
                                             "batch_stats": {}}
        clients = [JClient(jc, f"client_{s}_0", s, transport=bus)
                   for s in (1, 2)]
        threads = [threading.Thread(target=c.run, daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        jres = server.serve()
        for t in threads:
            t.join(timeout=60)

        queues = {k: list(v) for k, v in drawn.items()}

        def inject(gen, frozen, model, **kw):
            tree = queues[frozenset(frozen)].pop(0)
            return {k: {n: {f: t.to(gen.device) for f, t in e.items()}
                        for n, e in v.items()}
                    for k, v in from_jax_lora(tree).items()}
        mp.setattr(tclient, "lora_init", inject)
        real_payload = tclient.ProtocolClient._wire_payload

        def wire_payload(self, tree, family, queue):
            out = real_payload(self, tree, family, queue)
            with lock:
                rec["torch"].setdefault(family + "_tree", _np(tree))
                rec["torch"].setdefault(family, out)
            return out
        mp.setattr(tclient.ProtocolClient, "_wire_payload", wire_payload)
        run = run_inproc(tc, device="cpu", client_timeout=120,
                         init_params=from_jax_params(p0))
    finally:
        mp.undo()
    assert sorted(len(v) for v in drawn.values()) == [1, 1]
    return jc, tc, p0, jres, run, rec


def test_lora_protocol_round_matches_the_jax_packages(rounds):
    jc, tc, p0, jres, run, rec = rounds
    (a,), (b,) = jres.history, run.result.history
    assert a.ok and b.ok and a.num_samples == b.num_samples == 16
    assert abs(a.val_loss - b.val_loss) < 1e-4, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(run.result.params, run.server.ctx.full_model)))
    close = total = 0
    moved = False
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jres.params)):
        np.testing.assert_allclose(final_t[path], w, rtol=0, atol=1e-2,
                                   err_msg=str(path))
        close += int((np.abs(final_t[path] - w) <= 1e-4).sum())
        total += w.size
        start = dict(jax.tree_util.tree_leaves_with_path(p0))[path]
        moved |= not np.array_equal(w, start)
    assert close >= 0.99 * total and moved


def _check_structure(payload, grad: bool):
    hidden, mask = payload
    assert isinstance(hidden, (QuantLeaf, JQuantLeaf))
    assert hidden.bits == 8 and hidden.tile == 256
    assert tuple(hidden.shape) == (4, 128, 32)
    assert np.asarray(hidden.q).dtype == np.int8
    assert np.asarray(hidden.scale).dtype == np.float32
    mask = np.asarray(mask)
    assert mask.shape == (4, 128)
    if grad:
        assert mask.dtype == np.float32 and not mask.any()
    else:
        assert mask.dtype == np.bool_ and mask[:, 0].all()


@pytest.mark.parametrize("family", ["intermediate", "gradient"])
def test_payloads_match_leaf_by_leaf(rounds, family):
    jc, tc, p0, jres, run, rec = rounds
    want, got = rec["jax"][family], rec["torch"][family]
    grad = family == "gradient"
    _check_structure(want, grad)
    _check_structure(got, grad)
    assert np.asarray(got[1]).tobytes() == np.asarray(want[1]).tobytes()
    same = np.mean(np.asarray(got[0].q) == np.asarray(want[0].q))
    assert same >= 0.999, same
    # the port's wire tree: a float hidden leaf and the mask (a Float0
    # marker in the gradient)
    t_tree = rec["torch"][family + "_tree"]
    assert isinstance(t_tree[1], Float0) if grad else \
        t_tree[1].dtype == np.bool_
    # the JAX package's tree through the port's wire path
    j_tree = rec["jax"][family + "_tree"]
    client = run.clients[0 if family == "intermediate" else 1]
    port_tree = tuple(leaf if isinstance(leaf, Float0)
                      else torch.from_numpy(np.array(leaf))
                      for leaf in j_tree)
    again = client._wire_payload(port_tree, family, "q")
    # the dense-equivalent bytes count the mask's gradient as the JAX
    # package counts its float0 leaf: 4 bytes an element
    assert wire_raw_nbytes(port_tree, torch.float32) == \
        rec["jax"][family + "_raw"]
    twin = jquant.quantize_np(j_tree[0], 256, 8)
    g, w = again[0], want[0]
    assert tuple(g.shape) == tuple(w.shape) == tuple(twin.shape)
    assert (g.bits, g.tile) == (w.bits, w.tile)
    for f in ("q", "scale"):
        ga, wa = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
        ta = np.asarray(getattr(twin, f))
        assert ga.dtype == wa.dtype == ta.dtype and ga.shape == wa.shape
        assert ga.tobytes() == ta.tobytes(), f
    gs, ws = np.asarray(g.scale), np.asarray(w.scale)
    assert np.all(np.abs(gs.view(np.int32) - ws.view(np.int32)) <= 1)
    diff = np.abs(np.asarray(g.q, np.int32) - np.asarray(w.q, np.int32)
                  ).reshape(-1, 256)
    assert not diff[gs == ws].any() and diff.max() <= 1
    gm, wm = np.asarray(again[1]), np.asarray(want[1])
    assert gm.dtype == wm.dtype and gm.tobytes() == wm.tobytes()


#: the variants run in process through both packages, with their rounds
#: (None: the YAML's)
VARIANTS = {"dcsl": 1, "flex": None}


def _variant(tmp_path, name):
    import yaml
    d = yaml.safe_load((ROOT / "examples" / "variants" / f"{name}.yaml")
                       .read_text())
    d["compute-dtype"] = "float32"
    d["model-kwargs"] = dict(d["model-kwargs"], dropout_rate=0.0)
    d["checkpoint"] = {"save": False}
    d["log-path"] = str(tmp_path)
    d.pop("limited-time", None)
    if VARIANTS[name] is not None:
        d["global-rounds"] = VARIANTS[name]
    return jcfg.from_dict(d), tcfg.from_dict(d)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_in_process_matches_the_jax_packages(tmp_path, name):
    jc, tc = _variant(tmp_path, name)
    jctx = MeshContext(jc)
    p0 = jax.tree_util.tree_map(np.asarray, jctx.init_variables()["params"])
    jres = jrun(jc, jctx, jplan(jc, jregs(jc)),
                JLogger(tmp_path / "jax", console=False),
                init_params=copy.deepcopy(p0))
    tctx = TorchContext(tc, device="cpu")
    tres = trun(tc, tctx, tplan(tc, tregs(tc)),
                TLogger(tmp_path / "torch", console=False),
                init_params=from_jax_params(p0))
    assert len(jres.history) == len(tres.history) == jc.global_rounds
    for a, b in zip(jres.history, tres.history):
        assert a.ok and b.ok and a.num_samples == b.num_samples
        assert (a.val_loss is None) == (b.val_loss is None)
        if a.val_loss is not None:
            assert abs(a.val_loss - b.val_loss) < 1e-3, (a, b)
    final_t = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(tres.params, tctx.full_model)))
    start = dict(jax.tree_util.tree_leaves_with_path(p0))
    num = den = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jres.params)):
        np.testing.assert_allclose(final_t[path], w, rtol=0, atol=1e-2,
                                   err_msg=str(path))
        num += float(((final_t[path] - w) ** 2).sum())
        den += float(((w - start[path]) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 5e-2, (num / den) ** 0.5
