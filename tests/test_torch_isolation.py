"""The port stands alone: it imports no JAX, nothing of the JAX package
and not ``ml_dtypes``, and its entry points run on the GPU unless the
caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "split_learning_torch"
BLOCKED = ("jax", "flax", "optax", "split_learning_tpu", "ml_dtypes")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_with_jax_blocked():
    """Every module of the port, and chip_smoke, imports in a process
    where jax, flax, optax, split_learning_tpu and ml_dtypes cannot be
    imported."""
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('isolated ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "isolated ok" in proc.stdout


#: the control plane: planner copies of numpy-only modules of the JAX
#: package, and the profiler
CONTROL_PLANE = ("split_learning_torch.planner.cluster",
                 "split_learning_torch.planner.selection",
                 "split_learning_torch.planner.throughput",
                 "split_learning_torch.profiler")


def test_control_plane_runs_with_jax_blocked():
    """The planner modules and the profiler are among the modules
    imported above, and they run — KMeans, the GMM threshold, the cut
    re-plan, a profiler shape pass and ``plan_clusters`` in auto mode
    with selection — in a process where JAX and the JAX package cannot
    be imported."""
    assert set(CONTROL_PLANE) <= set(_port_modules())
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "import numpy as np, torch",
        "from split_learning_torch.planner.cluster import kmeans_cluster",
        "from split_learning_torch.planner.selection import select_devices",
        "from split_learning_torch.planner.throughput import replan_cuts",
        "from split_learning_torch import profiler",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.run import synthesize_registrations",
        "from split_learning_torch.runtime.plan import plan_clusters",
        "labels, sizes = kmeans_cluster(np.eye(4)[[0, 0, 1, 1]], 2)",
        "assert sorted(sizes) == [[2], [2]]",
        "keep, thr = select_devices([100, 101, 99, 9.0])",
        "assert keep.tolist() == [True, True, True, False]",
        "assert replan_cuts([[[1.0, 1, 1]]] * 2, [[0.0]] * 2, [1.0] * 3,"
        " [1])['cuts'] in ([1], [2])",
        "bounds, flops = profiler.shape_pass('VGG16_CIFAR10',"
        " torch.zeros(2, 32, 32, 3))",
        "assert len(bounds) == 52 and flops[0] > 0",
        "cfg = from_dict({'model': 'VGG16', 'dataset': 'CIFAR10',"
        " 'clients': [4, 2], 'topology': {'mode': 'auto',"
        " 'num-clusters': 2, 'selection': True}, 'distribution':"
        " {'mode': 'dirichlet', 'alpha': 0.3}})",
        "regs = synthesize_registrations(cfg, {'client_1_1':"
        " {'speed': 1.0}})",
        "assert len(plan_clusters(cfg, regs)) == 2",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('control plane ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "control plane ok" in proc.stdout


#: the modules of BASELINE configs 3 and 4
NEW_MODELS = ("split_learning_torch.models.resnet",
              "split_learning_torch.models.vit",
              "split_learning_torch.models.transformer")


def test_resnet_and_vit_run_with_jax_blocked():
    """ResNet-50 and ViT-S/16 (the modules above, and the converter of
    their nested statistics) import and train a step in a process where
    JAX and the JAX package cannot be imported; flops-mode profiling of
    the ViT is refused, naming its layer kinds."""
    assert set(NEW_MODELS) <= set(_port_modules())
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "import torch",
        f"for m in {NEW_MODELS!r}:",
        "    __import__(m)",
        "from split_learning_torch.models import build_model",
        "from split_learning_torch.convert import from_jax_stats,"
        " to_jax_stats",
        "from split_learning_torch import profiler",
        "m = build_model('ResNet50_CIFAR100')",
        "m(torch.randn(2, 8, 8, 3), train=True).sum().backward()",
        "m.commit_stats()",
        "st = m.stats_tree()",
        "assert len(st) == 17 and 'bn1.mean' in st['layer4'], list(st)",
        "back = from_jax_stats(to_jax_stats(st))",
        "assert all(torch.equal(back[k][n], t) for k, v in st.items()"
        " for n, t in v.items())",
        "v = build_model('ViT_S16_CIFAR10', n_block=1)",
        "assert v(torch.randn(2, 32, 32, 3), train=True).shape == (2, 10)",
        "try:",
        "    profiler.profile_model('ViT_S16_CIFAR10', 2, method='flops',"
        " model_kwargs={'n_block': 1}, device='cpu')",
        "    raise AssertionError('flops mode counted a ViT')",
        "except NotImplementedError as e:",
        "    assert 'PreLNBlock' in str(e) and 'ClsNorm' in str(e), e",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('new models ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "new models ok" in proc.stdout


#: the modules of the BERT and KWT slice
TEXT_AUDIO = ("split_learning_torch.models.bert",
              "split_learning_torch.models.kwt",
              "split_learning_torch.ops.lora",
              "split_learning_torch.data.mfcc",
              "split_learning_torch.data.wordpiece")


def test_bert_lora_and_kwt_train_with_jax_blocked(tmp_path):
    """BERT with LoRA (in process and as the protocol round with the int8
    codec) and KWT train, their data providers and the numpy MFCC run,
    and flops-mode profiling refuses both models by layer kind, in a
    process where JAX and the JAX package cannot be imported."""
    assert set(TEXT_AUDIO) <= set(_port_modules())
    bert = {"model": "BERT", "dataset": "AGNEWS", "clients": [1, 1],
            "synthetic-size": 64, "val-max-batches": 1,
            "val-batch-size": 4, "compute-dtype": "float32",
            "model-kwargs": {"vocab_size": 64, "hidden_size": 16,
                             "num_heads": 2, "intermediate_size": 32,
                             "n_block": 1, "max_position_embeddings": 128},
            "topology": {"cut-layers": [2]},
            "distribution": {"num-samples": 8},
            "learning": {"batch-size": 4, "control-count": 1,
                         "optimizer": "adamw", "lora-rank": 4},
            "checkpoint": {"save": False}, "log-path": str(tmp_path)}
    kwt = dict(bert, model="KWT", dataset="SPEECHCOMMANDS",
               **{"model-kwargs": {"embed_dim": 8, "num_heads": 2,
                                   "mlp_dim": 16}},
               learning={"batch-size": 4, "control-count": 2,
                         "optimizer": "adamw"})
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "import numpy as np, torch",
        f"for m in {TEXT_AUDIO!r}:",
        "    __import__(m)",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.run import run_local",
        "from split_learning_torch.runtime.server import run_inproc",
        "from split_learning_torch.data import get_dataset",
        "from split_learning_torch.data.mfcc import compute_mfcc",
        "from split_learning_torch import profiler",
        f"bert, kwt = {bert!r}, {kwt!r}",
        "for d in (bert, kwt):",
        "    res = run_local(from_dict(d), device='cpu')",
        "    assert [r.ok for r in res.history] == [True], res.history",
        "    assert res.history[0].num_samples == 8",
        "bert['transport'] = {'codec': {'intermediate': 'int8',"
        " 'gradient': 'int8'}}",
        "run = run_inproc(from_dict(bert), device='cpu', client_timeout=60)",
        "assert [r.ok for r in run.result.history] == [True]",
        "assert all(c.runner.lora is not None for c in run.clients)",
        "for name in ('AGNEWS', 'EMOTION', 'SPEECHCOMMANDS'):",
        "    assert len(get_dataset(name, synthetic_size=4)) == 4",
        "assert compute_mfcc(np.zeros(16000) + 0.1).shape == (40, 98)",
        "for key, kw, kinds in (('BERT_AGNEWS', bert['model-kwargs'],"
        " ('BertBlock', 'BertEmbeddings', 'Pooler')),"
        " ('KWT_SPEECHCOMMANDS', kwt['model-kwargs'],"
        " ('PreLNBlock', 'LayerNorm'))):",
        "    try:",
        "        profiler.profile_model(key, 2, method='flops',"
        " model_kwargs=kw, device='cpu')",
        "        raise AssertionError('flops mode counted ' + key)",
        "    except NotImplementedError as e:",
        "        assert all(k in str(e) for k in kinds), e",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('bert and kwt ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "bert and kwt ok" in proc.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_names_a_blocked_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in BLOCKED, (path, node.lineno, n)


TINY = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1],
    "synthetic-size": 16, "val-max-batches": 1, "val-batch-size": 2,
    "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 32, "hidden_size": 16, "num_heads": 2,
                     "num_kv_heads": 1, "intermediate_size": 32,
                     "n_block": 1, "use_flash": True},
    "topology": {"cut-layers": [2]}, "distribution": {"num-samples": 8},
    "learning": {"batch-size": 2, "control-count": 2, "optimizer": "adamw"},
    "checkpoint": {"save": False},
}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg(tmp_path):
    from split_learning_torch.config import from_dict
    return from_dict(dict(TINY, **{"log-path": str(tmp_path)}))


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from split_learning_torch.device import resolve_device
    from split_learning_torch.run import main, run_local
    from split_learning_torch.runtime.context import TorchContext
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchContext(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local(cfg)
    yaml_path = tmp_path / "tiny.yaml"
    import yaml
    yaml_path.write_text(yaml.safe_dump(dict(TINY, **{
        "log-path": str(tmp_path)})))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", str(yaml_path)])


def test_entry_points_run_on_cpu_when_asked(no_gpu, tmp_path, capsys):
    from split_learning_torch.run import main, run_local
    res = run_local(_cfg(tmp_path), device="cpu")
    assert [r.ok for r in res.history] == [True]
    assert res.history[0].num_samples == 8
    import yaml
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(yaml.safe_dump(dict(TINY, **{
        "log-path": str(tmp_path)})))
    main(["--config", str(yaml_path), "--device", "cpu"])
    assert "round 0: ok=True samples=8" in capsys.readouterr().out


def test_protocol_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """The protocol server and client default to CUDA and raise without
    it, before they build a transport; without a transport from the
    caller they build the configured stack."""
    from split_learning_torch.runtime.bus import (
        AsyncTransport, InProcTransport,
    )
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.server import ProtocolServer
    cfg, bus = _cfg(tmp_path), InProcTransport()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolServer(cfg, bus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolClient(cfg, "client_1_0", 1, bus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtocolServer(cfg)
    own = ProtocolClient(cfg, "client_1_0", 1, None, device="cpu")
    assert isinstance(own.bus, AsyncTransport)
    assert isinstance(own.bus.inner, InProcTransport)
    own.bus.close()
    ProtocolClient(cfg, "client_1_0", 1, bus, device="cpu")


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero and prints no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_strict_sda_protocol_round_runs_with_jax_blocked(tmp_path):
    """Strict SDA over the protocol round (``[2, 1]``, ``sda-size: 2``:
    DCSL's per-device queue, the head's two-origin windows, the feeders'
    epoch fences) trains in a process where JAX and the JAX package
    cannot be imported."""
    kwt = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
           "synthetic-size": 48, "val-max-batches": 1, "val-batch-size": 8,
           "compute-dtype": "float32",
           "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
           "topology": {"cut-layers": [2]},
           "distribution": {"num-samples": 8},
           "aggregation": {"strategy": "sda", "sda-size": 2,
                           "sda-strict": True},
           "learning": {"batch-size": 4, "control-count": 2,
                        "optimizer": "adamw"},
           "checkpoint": {"save": False}, "log-path": str(tmp_path)}
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime.server import run_inproc",
        f"run = run_inproc(from_dict({kwt!r}), device='cpu',"
        " client_timeout=300)",
        "assert [(r.ok, r.num_samples) for r in run.result.history]"
        " == [(True, 16)], run.result.history",
        "head = run.clients[-1]",
        "assert head.sda_strict and head.sda_size == 2",
        "assert head.sda_feeders == ['client_1_0', 'client_1_1']",
        "q = 'intermediate_queue_1_0_pclient_2_0'",
        "assert run.bus.bytes_out_snapshot().get(q, 0) > 0",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('strict sda ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "strict sda ok" in proc.stdout


def test_chaos_reliable_sharded_stack_runs_with_jax_blocked():
    """The full transport stack of a participant — the async sender over
    the reliable layer over chaos injection over a 2-shard broker plane,
    as ``make_runtime_transport`` builds it from the config — carries the
    JAX package's acceptance recipe's stream (seed 1234) exact and in
    order to another participant's stack, in a process where JAX and the
    JAX package cannot be imported."""
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime import bus",
        "from split_learning_torch.runtime.chaos import ("
        "ChaosTransport, make_runtime_transport)",
        "from split_learning_torch.runtime.trace import FaultCounters",
        "base = bus.find_port_block(2)",
        "brokers = [bus.Broker('127.0.0.1', base + i) for i in range(2)]",
        "cfg = from_dict({'model': 'KWT', 'dataset': 'SPEECHCOMMANDS',"
        " 'clients': [1, 1], 'broker': {'shards': 2},"
        " 'transport': {'kind': 'tcp', 'port': base, 'reliable': True,"
        " 'redeliver-s': 0.05},"
        " 'chaos': {'enabled': True, 'seed': 1234, 'drop': 0.10,"
        " 'duplicate': 0.10, 'reorder': 0.15, 'corrupt': 0.05,"
        " 'delay': 0.10, 'delay-s': 0.005}})",
        "fc = FaultCounters()",
        "tx = make_runtime_transport(cfg, 'client_1_0', faults=fc)",
        "rx = make_runtime_transport(cfg, 'client_2_0', faults=fc)",
        "assert isinstance(tx.inner.inner, ChaosTransport)",
        "assert isinstance(tx.inner.inner.inner, bus.ShardedTcpTransport)",
        "queues = ['intermediate_queue_1_0', 'gradient_queue_1_client_1_1']",
        "assert {bus.shard_for(q, 2) for q in queues} == {0, 1}",
        "for q in queues:",
        "    sent = [b'%s-%03d' % (q.encode(), i) for i in range(60)]",
        "    for m in sent:",
        "        tx.publish(q, m)",
        "    got = [bytes(rx.get(q, timeout=30)) for _ in sent]",
        "    assert got == sent, (q, got[:5])",
        "snap = fc.snapshot()",
        "for k in ('drops', 'duplicates', 'reorders', 'corruptions',"
        " 'delays', 'redeliveries', 'dedup_hits', 'corrupt_rejected'):",
        "    assert snap.get(k), (k, snap)",
        "tx.close()",
        "rx.close()",
        "for b in brokers:",
        "    b.close()",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('chaos stack ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "chaos stack ok" in proc.stdout


#: the modules of the async and codec slice
ASYNC_CODECS = ("split_learning_torch.ops.auxiliary",
                "split_learning_torch.runtime.codec.sparse",
                "split_learning_torch.runtime.codec.delta")


def test_async_round_with_topk_and_delta_runs_with_jax_blocked(tmp_path):
    """An async round (aux heads, no gradient frames) with the top-k
    gradient codec and the delta UPDATE codec, and a sync round with the
    same codecs (top-k gradients on the wire), run in a process where JAX
    and the JAX package cannot be imported."""
    assert set(ASYNC_CODECS) <= set(_port_modules())
    kwt = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [2, 1],
           "global-rounds": 2, "synthetic-size": 48, "val-max-batches": 1,
           "val-batch-size": 8, "compute-dtype": "float32",
           "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
           "topology": {"cut-layers": [2]},
           "distribution": {"num-samples": 8},
           "transport": {"codec": {"gradient": "topk:0.05",
                                   "rpc": "delta:int8"}},
           "learning": {"mode": "async", "batch-size": 4,
                        "optimizer": "adamw"},
           "checkpoint": {"save": False}, "log-path": str(tmp_path)}
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime.server import run_inproc",
        f"kwt = {kwt!r}",
        "for mode in ('async', 'sync'):",
        "    kwt['learning']['mode'] = mode",
        "    run = run_inproc(from_dict(kwt), device='cpu',"
        " client_timeout=300)",
        "    assert [(r.ok, r.num_samples) for r in run.result.history]"
        " == [(True, 16)] * 2, run.result.history",
        "    grad = sum(n for q, n in run.bus.bytes_out_snapshot().items()"
        " if q.startswith('gradient_queue'))",
        "    assert (grad == 0) == (mode == 'async'), (mode, grad)",
        "    assert all(c.aux_head is not None for c in run.clients[:2])"
        " == (mode == 'async')",
        "    assert run.server.ctx.faults.snapshot().get('delta_folds')",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('async codecs ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "async codecs ok" in proc.stdout


def test_aggregator_tree_round_runs_with_jax_blocked(tmp_path):
    """The aggregator tree over the protocol round (``[4, 2]``, fan-in 2,
    2 levels, the ``delta:int8:64`` partial codec) trains in a process
    where JAX and the JAX package cannot be imported, also with one
    aggregator killed (the direct-to-root fallback)."""
    kwt = {"model": "KWT", "dataset": "SPEECHCOMMANDS", "clients": [4, 2],
           "synthetic-size": 48, "val-max-batches": 1, "val-batch-size": 8,
           "compute-dtype": "float32",
           "model-kwargs": {"embed_dim": 8, "num_heads": 2, "mlp_dim": 16},
           "topology": {"cut-layers": [2]},
           "distribution": {"num-samples": 8},
           "transport": {"codec": {"partial": "delta:int8:64"}},
           "aggregation": {"strategy": "fedavg", "fan-in": 2, "levels": 2},
           "learning": {"batch-size": 4, "control-count": 1,
                        "optimizer": "sgd"},
           "checkpoint": {"save": False}, "log-path": str(tmp_path)}
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "import split_learning_torch.runtime.codec.partial",
        "from split_learning_torch.config import from_dict",
        "from split_learning_torch.runtime import aggregate",
        "from split_learning_torch.runtime.server import run_inproc",
        "from split_learning_torch.runtime.trace import"
        " default_fault_counters as faults",
        f"cfg = from_dict({kwt!r})",
        "for kill in (False, True):",
        "    if kill:",
        "        aggregate.L1Aggregator.TEST_KILL.add('aggregator_0_1')",
        "    run = run_inproc(cfg, device='cpu', client_timeout=300)",
        "    assert [(r.ok, r.num_samples) for r in run.result.history]"
        " == [(True, 32)], run.result.history",
        "    fold = run.server.ctx.last_fold",
        "    assert fold.partials == 2 and fold.folded == 2, fold",
        "    assert run.bus.bytes_out_snapshot().get('aggregate_queue_0_3')",
        "assert faults.snapshot().get('agg_l1_fallbacks') == 1",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('aggregator tree ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "aggregator tree ok" in proc.stdout
