"""The port's profiler (``python -m split_learning_torch.profiler``)
against the JAX package's, on the CPU.

* ``size_data`` — the fp32-equivalent bytes after each layer, from the
  port's shape pass on the meta device — equals the JAX package's list
  exactly (VGG16_CIFAR10 at batch 32, a small TinyLlama).
* ``flops`` mode: the parity target is the planner's decision, not the
  number.  From the port's profile and from the JAX package's,
  ``partition`` (2 stages) and ``partition_multiway`` (3 stages) choose
  the same cuts, for VGG16_CIFAR10 and for a small TinyLlama (2 and 3
  blocks, hidden 64, batch 4, sequence 256).  The port counts FLOPs with
  ``FlopCounterMode`` and formulas in XLA's convention
  (``profiler.XLA_STYLE_FLOPS``: a conv counts only the taps inside the
  input, plus its bias; one FLOP per element of arithmetic; reductions
  per input element; none for transcendentals).  The per-layer
  differences that remain:

  - VGG16_CIFAR10: none; all 52 layers are equal.
  - TinyLlama: the embedding — XLA counts its gather's index arithmetic
    (≈ 1.19 FLOPs per output element), the port floors it at
    ``size_data × 1e-3`` (ratio 0.003–0.004); each decoder block is 1.7 %
    (hidden 64) to 4 % (hidden 32) lower in the port — XLA expands the
    SiLU's sigmoid into arithmetic and counts the causal mask's iota
    comparisons; the final RMSNorm and the LM head are equal.  With the
    flash kernel on, XLA's cost analysis of the interpret-mode Pallas
    kernel counts 2.9× the dense block while the port's shape pass
    counts the dense path, so the two packages' flops profiles of a
    ``use_flash`` model lead to different cuts.  At hidden 32 with 4
    blocks two 3-stage cuts tie in the port's counts (the transfer term
    dominates such tiny layers) and the JAX package's extra block FLOPs
    break the tie the other way.
* The CLI's ``profiling.json`` goes through the client's ``--profile``
  into its REGISTER and the server's plan; ``time`` mode times every
  layer; ``profile_network`` measures through an ``InProcTransport``.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from split_learning_tpu.profiler import profile_model as jprofile
from split_learning_torch import profiler as tprof
from split_learning_torch.planner import partition, partition_multiway

VGG = "VGG16_CIFAR10"
LLAMA = "TinyLlama_TINYSTORIES"


def _llama_kw(n_block):
    return {"vocab_size": 256, "hidden_size": 64, "num_heads": 4,
            "num_kv_heads": 2, "intermediate_size": 128,
            "n_block": n_block}


PROFILES = {"vgg": (VGG, {}, 32), "llama2": (LLAMA, _llama_kw(2), 4),
            "llama3": (LLAMA, _llama_kw(3), 4)}


@pytest.fixture(scope="module")
def flops_profiles():
    """(port, JAX package) flops-mode profiles of each model."""
    out = {}
    for name, (key, kw, batch) in PROFILES.items():
        out[name] = (
            tprof.profile_model(key, batch, model_kwargs=kw,
                                method="flops", device="cpu", repeats=2),
            jprofile(key, batch, model_kwargs=kw, method="flops",
                     repeats=2))
    return out


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_size_data_equal(flops_profiles, name):
    t, j = flops_profiles[name]
    assert t["size_data"] == j["size_data"]
    assert all(isinstance(s, int) for s in t["size_data"])
    assert len(t["exe_time"]) == len(j["exe_time"])
    assert t["speed"] > 0 and t["network"] == 0.0


def _cuts(profile, stages):
    exe, net = [profile["exe_time"]], [1e9]
    if stages == 2:
        return partition(exe, net, exe, net, profile["size_data"])
    return partition_multiway([exe] * stages, [net] * stages,
                              profile["size_data"])


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("stages", [2, 3])
def test_flops_profiles_choose_the_same_cuts(flops_profiles, name, stages):
    t, j = flops_profiles[name]
    assert _cuts(t, stages) == _cuts(j, stages)


def test_vgg_flops_equal_layer_by_layer(flops_profiles):
    t, j = flops_profiles["vgg"]
    np.testing.assert_allclose(t["exe_time"], j["exe_time"], rtol=1e-6)


def test_time_mode_times_every_layer():
    kw = _llama_kw(2)
    prof = tprof.profile_model(LLAMA, 2, model_kwargs=kw, method="time",
                               device="cpu", warmup=1, repeats=2)
    assert len(prof["exe_time"]) == len(prof["size_data"]) == 5
    assert all(t > 0 and math.isfinite(t) for t in prof["exe_time"])
    assert prof["speed"] > 0
    with pytest.raises(ValueError, match="unknown method"):
        tprof.profile_model(LLAMA, 2, model_kwargs=kw, method="wall",
                            device="cpu")


def test_profile_network_through_inproc_transport():
    from split_learning_torch.runtime.bus import InProcTransport
    bus = InProcTransport()
    rate = tprof.profile_network(bus, sizes_mb=(1, 2), repeats=2)
    assert rate > 0 and math.isfinite(rate)
    assert bus.get("bandwidth_probe", timeout=0.01) is None


TINY_YAML = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [2, 1],
    "model-kwargs": _llama_kw(2), "topology": {"mode": "auto"},
    "learning": {"batch-size": 2},
}


def test_cli_profile_reaches_register_and_plan(tmp_path, monkeypatch):
    """``python -m split_learning_torch.profiler`` writes
    ``profiling.json``; ``python -m split_learning_torch.client --profile``
    embeds it in REGISTER, and the server's plan cuts from it."""
    import yaml
    from split_learning_torch import client as client_main
    from split_learning_torch.config import from_dict
    from split_learning_torch.runtime import client as rclient
    from split_learning_torch.runtime.plan import Registration, plan_clusters
    from split_learning_torch.runtime.protocol import RPC_QUEUE, decode

    cfg_path, out = tmp_path / "tiny.yaml", tmp_path / "profiling.json"
    cfg_path.write_text(yaml.safe_dump(dict(
        TINY_YAML, **{"log-path": str(tmp_path)})))
    proc = subprocess.run(
        [sys.executable, "-m", "split_learning_torch.profiler", "--config",
         str(cfg_path), "--output", str(out), "--method", "flops",
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    prof = json.loads(out.read_text())
    assert summary == {"layers": 5, "speed": prof["speed"],
                       "network": 0.0}
    assert set(prof) == {"exe_time", "size_data", "speed", "network"}

    monkeypatch.setattr(rclient.ProtocolClient, "run", lambda self: None)
    client = client_main.main(["--config", str(cfg_path), "--layer_id", "1",
                               "--client_id", "client_1_0", "--profile",
                               str(out), "--device", "cpu"])
    try:
        client.register()
        msg = decode(client.bus.get(RPC_QUEUE, timeout=5.0))
    finally:
        client.bus.close()
    assert msg.client_id == "client_1_0" and msg.profile == prof
    cfg = from_dict(TINY_YAML)
    regs = [Registration(msg.client_id, 1, profile=msg.profile),
            Registration("client_1_1", 1, profile=prof),
            Registration("client_2_0", 2)]
    # the bf16 wire (the default) ships half the profile's fp32 bytes
    assert cfg.transport.wire_dtype_normalized == "bfloat16"
    exe, net = [prof["exe_time"]] * 2, [1e9] * 2
    assert plan_clusters(cfg, regs)[0].cuts == partition(
        exe, net, exe, net, [s * 0.5 for s in prof["size_data"]])


def test_profiler_cli_raises_without_gpu(tmp_path, monkeypatch):
    import torch
    import yaml
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY_YAML))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.main(["--config", str(cfg_path), "--output",
                    str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
