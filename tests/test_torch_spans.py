"""The port's span tracer and wire trace context
(``split_learning_torch/runtime/spans.py``) against the JAX package's.

* the 32-byte context is byte for byte the JAX package's for the same
  ids and send time, and a malformed one decodes to None;
* the same scripted sequence of nested, explicitly parented, recorded
  and cross-thread spans writes journals with the JAX package's keys,
  names, threads and parent structure;
* a disabled tracer writes nothing and sends no context; at
  ``sample-rate: 0`` only the structural spans are written;
* a tensor frame and a chunked UPDATE encoded with a context give back
  the same ``_ctx`` in either package's assembler, whichever package
  encoded them.
"""

from __future__ import annotations

import json
import pathlib
import threading

import numpy as np
import pytest

from split_learning_tpu import config as jcfg
from split_learning_tpu.runtime import protocol as jproto
from split_learning_tpu.runtime import spans as jspans
from split_learning_torch import config as tcfg
from split_learning_torch.runtime import protocol as tproto
from split_learning_torch.runtime import spans as tspans

TRACE = "0123456789abcdef" * 2
SPAN = "fedcba9876543210"


@pytest.mark.parametrize("t_send", [0.0, 1.5, 1760000000.123456])
def test_pack_ctx_is_the_jax_packages(t_send):
    raw = tspans.pack_ctx(TRACE, SPAN, t_send)
    assert raw == jspans.pack_ctx(TRACE, SPAN, t_send)
    assert len(raw) == tspans.CTX_BYTES == jspans.CTX_BYTES == 32
    assert tspans.unpack_ctx(raw) == jspans.unpack_ctx(raw) \
        == (TRACE, SPAN, t_send)


@pytest.mark.parametrize("raw", [None, b"", b"\x00" * 31, b"\x00" * 33])
def test_unpack_ctx_refuses_malformed_input(raw):
    assert tspans.unpack_ctx(raw) is None
    assert jspans.unpack_ctx(raw) is None


def _script(mod, directory: pathlib.Path, **kw):
    """The same span sequence through either package's Tracer."""
    tr = mod.Tracer("client_1_0", journal_dir=directory, flush_every=3,
                    **kw)
    tr.adopt_trace_id(TRACE)
    with tr.span("client_round", round=0, stage=1) as root:
        sp = tr.start("fwd", always=False, round=0)
        sp.end()
        pub = tr.start("publish", always=False, queue="q", kind="Activation")
        ctx = tr.wire_context(pub)

        def sender():
            # ended on another thread: no tracer thread state touched
            pub.end(nbytes=1234)
        t = threading.Thread(target=sender, name="async-sender")
        t.start()
        t.join()
        with tr.span("inner", round=0):
            tr.record("consume", 10.0, 10.5, parent=SPAN, queue="q",
                      kind="Gradient", rtt_ms=1.0)
            tr.start("bwd", always=False, round=0).end()
        explicit = tr.start("update_wait", parent=root.id, round=0)
        explicit.end()
        tr.record("update_stage", 11.0, 11.0, always=True, stage=2)
    tr.flush()
    tr.close()
    # after close nothing more is written
    tr.start("late").end()
    return ctx, pub


def _journal(directory: pathlib.Path) -> list[dict]:
    path = directory / "spans-client_1_0.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _structure(recs: list[dict]) -> list[tuple]:
    names = {r["span"]: r["name"] for r in recs}
    return [(r["name"], names.get(r["parent"], r["parent"]),
             r["thread"] if r["thread"] != "MainThread" else "main",
             tuple(sorted(k for k in r)),
             {k: v for k, v in r.items()
              if k not in ("span", "parent", "ts", "dur", "thread")})
            for r in recs]


def test_journal_records_match_jax_package(tmp_path):
    tctx, tpub = _script(tspans, tmp_path / "t")
    jctx, jpub = _script(jspans, tmp_path / "j")
    trecs, jrecs = _journal(tmp_path / "t"), _journal(tmp_path / "j")
    assert len(trecs) == len(jrecs) == 8
    assert _structure(trecs) == _structure(jrecs)
    for rec in trecs:
        assert rec["v"] == tspans.SCHEMA_VERSION == 1
        assert rec["trace"] == TRACE and rec["part"] == "client_1_0"
        assert rec["dur"] >= 0
    by_name = {r["name"]: r for r in trecs}
    # the publish span's context names it; ended on another thread, it
    # keeps the thread it was opened on
    assert tspans.unpack_ctx(tctx)[:2] == (TRACE, tpub.id)
    assert by_name["publish"]["thread"] == "MainThread"
    assert by_name["publish"]["nbytes"] == 1234
    assert by_name["consume"]["parent"] == SPAN
    assert by_name["consume"]["ts"] == 10.0 and \
        by_name["consume"]["dur"] == 0.5
    # a span ended outside its context manager's stack keeps its parent
    assert by_name["fwd"]["parent"] == by_name["client_round"]["span"]
    assert by_name["bwd"]["parent"] == by_name["inner"]["span"]


def test_disabled_tracer_writes_nothing(tmp_path):
    for mod in (tspans, jspans):
        tr = mod.Tracer("server", enabled=False, journal_dir=tmp_path)
        with tr.span("round", round=0) as s:
            assert s is mod.NULL_SPAN
            pub = tr.start("publish", always=False)
            assert tr.wire_context(pub) == b""
            assert tr.record("consume", 0.0, 1.0) is None
        tr.flush()
        tr.close()
    assert list(tmp_path.iterdir()) == []


def test_sample_rate_zero_keeps_only_structural_spans(tmp_path):
    for mod, d in ((tspans, tmp_path / "t"), (jspans, tmp_path / "j")):
        tr = mod.Tracer("client_1_0", sample_rate=0.0, journal_dir=d)
        with tr.span("client_round", round=0):
            for _ in range(20):
                tr.start("fwd", always=False).end()
                pub = tr.start("publish", always=False)
                assert tr.wire_context(pub) == b""
                tr.record("consume", 0.0, 1.0, parent=SPAN)
            tr.record("update_stage", 0.0, 0.0, always=True)
        tr.close()
    for d in (tmp_path / "t", tmp_path / "j"):
        names = sorted(json.loads(line)["name"] for line in
                       (d / "spans-client_1_0.jsonl").read_text()
                       .splitlines())
        assert names == ["client_round", "update_stage"]


def test_make_tracer_reads_the_observability_block(tmp_path):
    for cfgmod, mod in ((tcfg, tspans), (jcfg, jspans)):
        d = tmp_path / mod.__name__.split(".")[0]
        cfg = cfgmod.from_dict({"log-path": str(d), "observability": {
            "sample-rate": 0.25, "flush-every": 7}})
        tr = mod.make_tracer(cfg, "client_2_0")
        assert tr.enabled and tr.sample_rate == 0.25
        assert tr._journal._flush_every == 7
        # the run-scoped layout, with the compat link at the flat path
        assert tr._journal.path.parent.parent.name == "runs"
        assert (d / "spans-client_2_0.jsonl").is_symlink()
        tr.close()
        off = mod.make_tracer(cfgmod.from_dict(
            {"log-path": str(d), "observability": {"enabled": False}}),
            "server")
        assert not off.enabled and off._journal is None


def _activation(mod):
    rng = np.random.default_rng(0)
    return mod.Activation(
        data_id="d" * 32, data=rng.standard_normal((4, 16)).astype(
            np.float32), labels=np.arange(4, dtype=np.int32),
        trace=["client_1_0"], cluster=0, round_idx=3)


def _update(mod):
    rng = np.random.default_rng(1)
    params = {"layer1": {"kernel": rng.standard_normal((64, 64)).astype(
        np.float32), "bias": np.zeros(64, np.float32)}}
    return mod.Update(client_id="client_1_0", stage=1, cluster=0,
                      params=params, num_samples=8, round_idx=3)


@pytest.mark.parametrize("which", ["activation", "chunked_update"])
def test_frames_carry_the_same_context_in_both_packages(which):
    ctx = jspans.pack_ctx(TRACE, SPAN, 1234.5)
    make = _activation if which == "activation" else _update
    max_bytes = None if which == "activation" else 4096
    tparts = tproto.encode_parts(make(tproto), max_bytes, ctx=ctx)
    jparts = jproto.encode_parts(make(jproto), max_bytes, ctx=ctx)
    assert len(tparts) == len(jparts)
    if which == "chunked_update":
        assert len(tparts) > 2   # chunked: every chunk header holds ctx
    # the context sits at the same offset of every part in both packages
    # (the pickled metadata behind it names each package's own classes)
    offsets = [p.find(ctx) for p in tparts]
    assert offsets == [p.find(ctx) for p in jparts]
    assert all(o > 0 for o in offsets)
    for parts, asm in ((tparts, tproto.FrameAssembler()),
                       (jparts, jproto.FrameAssembler())):
        msg = None
        for part in parts:
            msg = asm.feed(part)
        assert msg is not None and msg._ctx == ctx
        assert tspans.unpack_ctx(msg._ctx) == (TRACE, SPAN, 1234.5)
    # without a context every part is exactly 32 bytes shorter: frame
    # lengths stay deterministic
    bare = tproto.encode_parts(make(tproto), max_bytes)
    assert len(bare) == len(tparts)
    # every chunk header carries the context, and so does the frame the
    # chunks cut up
    extra = 32 * len(bare) + (32 if which == "chunked_update" else 0)
    assert sum(map(len, tparts)) - sum(map(len, bare)) == extra
