"""The top-k and delta wire codecs and the legacy per-tensor int8 wire
dtype: the port against the JAX package, on the CPU.

* ``TopKCodec`` (``gradient: "topk:<frac>"``) over three error-feedback
  steps to one queue (and one step to another), on a gradient tree with
  a ReLU-like leaf (exact zeros, so ``k`` may exceed the nonzeros), a
  leaf below the sparse floor (dense) and a ``float0``/:class:`Float0`
  leaf: every densified leaf and every residual bit for bit; the
  indices equal wherever the kept magnitudes are distinct (nonzero).
* ``DeltaCodec`` (``rpc: "delta:int8"`` and ``"delta:bf16"``) over two
  rounds against one base: the int8 codes, scales and shape, the bf16
  words, and the carried residual bit for bit.
* ``DeltaShadow``: the fold of a delta equal bit for bit, a version gap
  refused (``delta_resyncs``), ``clear``.
* the error-feedback sidecar: both codecs' residuals written beside the
  checkpoint and read back equal, through the client's own save and
  load.
* the legacy int8 leaf (``transport.wire-dtype: int8``): codes and
  scale of the port's quantizer equal ``_quant_int8``'s (all-zero and
  non-finite leaves too), through the plain wire path and a frame round
  trip, and its decode bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.runtime import client as jclient
from split_learning_tpu.runtime.codec import delta as jdelta
from split_learning_tpu.runtime.codec import quant as jquant
from split_learning_tpu.runtime.codec import sparse as jsparse
from split_learning_tpu.runtime.codec.specs import parse_spec
from split_learning_tpu.runtime.protocol import QuantLeaf as JQuantLeaf
from split_learning_tpu.runtime.trace import FaultCounters as JFaults
from split_learning_torch.runtime import client as tclient
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime.codec import delta as tdelta
from split_learning_torch.runtime.codec import quant as tquant
from split_learning_torch.runtime.codec import sparse as tsparse
from split_learning_torch.runtime.trace import FaultCounters as TFaults


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def _grad(step: int):
    rng = np.random.default_rng(100 + step)
    relu = rng.standard_normal((4, 8, 8)).astype(np.float32)
    relu[rng.random(relu.shape) < 0.97] = 0.0   # fewer nonzeros than k
    return {"h": rng.standard_normal((6, 50)).astype(np.float32),
            "relu": relu,
            "small": rng.standard_normal((3, 5)).astype(np.float32)}


def _jtree(g):
    return {**{k: jnp.asarray(v) for k, v in g.items()},
            "mask": np.zeros((4,), jax.dtypes.float0)}


def _ttree(g):
    return {**{k: torch.from_numpy(v.copy()) for k, v in g.items()},
            "mask": tproto.Float0((4,))}


def test_topk_three_error_feedback_steps():
    spec = parse_spec("topk:0.05")
    jc = jsparse.TopKCodec(spec, faults=JFaults())
    tc = tsparse.TopKCodec(spec, faults=TFaults())
    for step, queue in ((0, "g_a"), (1, "g_a"), (2, "g_a"), (3, "g_b")):
        g = _grad(step)
        jw = jc.encode(jc.prepare(_jtree(g), key=queue))
        tw = tc.encode(tc.prepare(_ttree(g), key=queue))
        for name in ("h", "relu"):
            assert isinstance(tw[name], tproto.SparseLeaf)
            jd = np.asarray(jsparse.densify_leaf(jw[name]))
            td = tsparse.densify_leaf(tw[name]).numpy()
            assert _bits(td) == _bits(jd), (step, name)
            nz = np.asarray(jw[name].val) != 0
            assert np.array_equal(np.asarray(tw[name].idx)[
                np.asarray(tw[name].val) != 0],
                np.asarray(jw[name].idx)[nz]), (step, name)
            assert tw[name].idx.dtype == np.int32
        assert _bits(tw["small"]) == _bits(jw["small"])   # dense floor
        assert _bits(tw["mask"]) == _bits(jw["mask"])     # float0 zeros
        js, ts = jc.state_dict(), tc.state_dict()
        assert sorted(js) == sorted(ts)
        for k in js:
            assert _bits(ts[k]) == _bits(js[k]), (step, k)
    assert tc.faults.snapshot() == {"topk_dense_fallbacks": 4}


@pytest.mark.parametrize("spec", ("delta:int8", "delta:int8:64",
                                  "delta:bf16"))
def test_delta_codec_matches(spec):
    rng = np.random.default_rng(5)
    base = {"layer1": {"w": rng.standard_normal((33, 20)).astype(
                np.float32), "b": rng.standard_normal(20).astype(
                np.float32)},
            "layer2": {"w": rng.standard_normal((300,)).astype(
                np.float32), "n": np.arange(3, dtype=np.int32)}}
    jc = jdelta.DeltaCodec(parse_spec(spec), faults=JFaults())
    tc = tdelta.DeltaCodec(parse_spec(spec), faults=TFaults())
    for r in range(2):
        trained = jax.tree_util.tree_map(
            lambda a: (a + rng.standard_normal(a.shape).astype(a.dtype)
                       * np.float32(1e-3)) if a.dtype == np.float32
            else a + 1, base)
        jd = jc.encode_update(trained, base)
        td = tc.encode_update(trained, base)
        for layer in base:
            for k, ref in jd[layer].items():
                got = td[layer][k]
                if isinstance(ref, JQuantLeaf):
                    assert isinstance(got, tproto.QuantLeaf)
                    assert _bits(got.q) == _bits(ref.q)
                    assert _bits(got.scale) == _bits(ref.scale)
                    assert (got.tile, got.bits, got.shape) == (
                        ref.tile, ref.bits, ref.shape)
                elif np.asarray(ref).dtype.name == "bfloat16":
                    assert got.dtype == torch.bfloat16
                    assert got.view(torch.int16).numpy().tobytes() == \
                        np.asarray(ref).view(np.int16).tobytes()
                else:
                    assert _bits(got) == _bits(ref)
        js, ts = jc.state_dict(), tc.state_dict()
        assert sorted(js) == sorted(ts)
        assert all(_bits(ts[k]) == _bits(js[k]) for k in js), r
        # the server's decode of the port's delta is the JAX package's
        # (which leaves a bf16 leaf in bf16: numpy does not class
        # ml_dtypes' bfloat16 as floating; its fold casts it)
        back_j = jdelta.decode_delta_tree(jd)
        back_t = tdelta.decode_delta_tree(td)
        for layer in base:
            for k in base[layer]:
                assert _bits(back_t[layer][k]) == _bits(np.asarray(
                    back_j[layer][k]).astype(back_t[layer][k].dtype))


def test_delta_shadow_fold_gap_and_clear():
    rng = np.random.default_rng(9)
    base = {"layer3": {"w": rng.standard_normal((40, 7)).astype(
        np.float32), "i": np.arange(4, dtype=np.int32)}}
    trained = {"layer3": {"w": base["layer3"]["w"] + np.float32(0.01),
                          "i": np.arange(4, dtype=np.int32) * 2}}
    spec = parse_spec("delta:int8")
    delta = tdelta.DeltaCodec(spec, faults=TFaults()).encode_update(
        trained, base)
    jdel = jdelta.DeltaCodec(spec, faults=JFaults()).encode_update(
        trained, base)
    js = jdelta.DeltaShadow(faults=JFaults())
    ts = tdelta.DeltaShadow(faults=TFaults())
    for s in (js, ts):
        s.note_sent("c1", 4, base)
        assert s.version_for("c1") == 4
    full_j = js.fold("c1", 4, jdel)
    full_t = ts.fold("c1", 4, delta)
    for k in base["layer3"]:
        assert _bits(full_t["layer3"][k]) == _bits(full_j["layer3"][k])
    assert np.array_equal(full_t["layer3"]["i"], trained["layer3"]["i"])
    assert ts.nbytes() == js.nbytes() == 40 * 7 * 4 + 16
    # a version gap: the shadow holds v4, the delta claims v3
    assert ts.fold("c1", 3, delta) is None
    assert js.fold("c1", 3, jdel) is None
    assert ts.faults.snapshot() == js.faults.snapshot() == {
        "delta_folds": 1, "delta_resyncs": 1}
    ts.clear("c1")
    assert ts.version_for("c1") is None and ts.nbytes() == 0
    assert ts.fold("c1", 4, delta) is None


def test_ef_sidecar_round_trip(tmp_path):
    from split_learning_torch.config import from_dict
    from split_learning_torch.runtime.bus import InProcTransport
    from split_learning_torch.runtime.checkpoint import (
        load_sidecar, save_sidecar,
    )
    d = {"transport": {"codec": {"gradient": "topk:0.1",
                                 "rpc": "delta:int8"}},
         "checkpoint": {"directory": str(tmp_path / "ckpt"), "save": True},
         "log-path": str(tmp_path / "logs")}
    c = tclient.ProtocolClient(from_dict(d), "c7", 1,
                               transport=InProcTransport(), device="cpu")
    g, r = c.codecs["gradient"], c.codecs["rpc"]
    g.prepare(_ttree(_grad(0)), key="gq")
    rng = np.random.default_rng(3)
    base = {"l": {"w": rng.standard_normal(500).astype(np.float32)}}
    r.encode_update({"l": {"w": base["l"]["w"] + np.float32(0.3)}}, base)
    before = {f: c.codecs[f].state_dict() for f in ("gradient", "rpc")}
    assert before["gradient"] and before["rpc"]
    c._save_ef_state()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ef_c7_gradient.pt", "ef_c7_rpc.pt"]
    fresh = tclient.ProtocolClient(
        from_dict(dict(d, checkpoint=dict(d["checkpoint"], load=True))),
        "c7", 1, transport=InProcTransport(), device="cpu")
    for f in ("gradient", "rpc"):
        after = fresh.codecs[f].state_dict()
        assert sorted(after) == sorted(before[f])
        assert all(_bits(after[k]) == _bits(before[f][k]) for k in after)
    # the sidecar on its own: absent reads as None
    save_sidecar(tmp_path / "x", "s", {"a": np.arange(3, dtype=np.int32)})
    assert load_sidecar(tmp_path / "x", "s")["a"].tolist() == [0, 1, 2]
    assert load_sidecar(tmp_path / "x", "missing") is None


def test_legacy_int8_wire_leaf():
    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal((4, 9)).astype(np.float32),
              np.zeros((3, 3), np.float32),
              np.array([1.0, np.inf, -2.0], np.float32),
              (rng.standard_normal(17) * 1e-3).astype(np.float32)]
    for a in leaves:
        ref = jclient._quant_int8(a)
        got = tquant.quantize_per_tensor_np(a)
        if not isinstance(ref, JQuantLeaf):   # non-finite: raw float32
            assert not isinstance(got, tproto.QuantLeaf)
            assert _bits(got) == _bits(ref)
            continue
        assert _bits(got.q) == _bits(ref.q) and got.scale == ref.scale
        assert (got.tile, got.shape) == (0, None)
        assert _bits(tquant.dequantize_leaf_np(got)) == _bits(
            jquant.dequantize_leaf_np(ref))
        assert _bits(tquant.dequantize_leaf(got)) == _bits(
            np.asarray(jquant.dequantize_leaf(ref)))
    # the plain wire path with wire-dtype int8, through a frame
    tree = (torch.from_numpy(leaves[0]), tproto.Float0((2, 3)))
    wire = tclient._to_wire_tree(tree, tclient.wire_torch_dtype("int8"))
    jwire = jclient._to_wire_tree((leaves[0], np.zeros(
        (2, 3), jax.dtypes.float0)), np.int8)
    assert _bits(wire[0].q) == _bits(jwire[0].q)
    assert wire[0].scale == jwire[0].scale
    assert _bits(wire[1]) == _bits(jwire[1])
    msg = tproto.Activation(data_id="x", data=wire, labels=np.zeros(
        4, np.int32), trace=["c"], cluster=0, round_idx=1)
    back = tproto.decode(tproto.encode(msg))
    out = tclient._from_wire_tree(back.data, "cpu")
    assert _bits(out[0]) == _bits(np.asarray(jclient._from_wire_tree(
        jwire)[0]))


def test_wire_int8_example_runs_in_the_port(tmp_path):
    """``examples/wire_int8_tcp.yaml`` (the legacy int8 wire dtype) as
    the protocol round in one process: both packages' validation refuse
    it as written (``transport.allow-global-lossy`` is the opt-in it
    lacks), so it runs with that opt-in, over the in-process bus, one
    round.  Its activations and gradients cross as per-tensor int8."""
    import pathlib

    import yaml

    from split_learning_torch.config import ConfigError, from_dict
    from split_learning_torch.runtime.server import run_inproc
    root = pathlib.Path(__file__).resolve().parents[1]
    d = yaml.safe_load((root / "examples/wire_int8_tcp.yaml").read_text())
    with pytest.raises(ConfigError, match="allow-global-lossy"):
        from_dict(d)
    d["transport"] = dict(d["transport"], kind="inproc",
                          **{"allow-global-lossy": True})
    d.update({"global-rounds": 1, "log-path": str(tmp_path),
              "checkpoint": {"save": False}})
    run = run_inproc(from_dict(d), device="cpu", client_timeout=300)
    assert [(r.ok, r.num_samples) for r in run.result.history] == [
        (True, 96)]
    sent = run.bus.bytes_out_snapshot()
    act = sum(n for q, n in sent.items() if q.startswith("intermediate"))
    grad = sum(n for q, n in sent.items() if q.startswith("gradient"))
    # 12 batches of (8, 99, 16) values each way: int8 codes plus framing
    assert 12 * 8 * 99 * 16 < act < 2 * 12 * 8 * 99 * 16
    assert 12 * 8 * 99 * 16 < grad < 2 * 12 * 8 * 99 * 16
