"""Offline device/model profiler feeding the partition planner.

Port of the JAX package's ``profiler.py`` (the reference's
``profiling.py``): per-layer forward execution times, per-layer
activation byte sizes, device speed = batch / full-forward time, and a
bandwidth probe publishing 1–9 MB payloads through a transport; the
result is written to ``profiling.json``, which ``python -m
split_learning_torch.client --profile`` embeds in its REGISTER.

* ``size_data`` comes from a shape pass of the port's
  :class:`~split_learning_torch.models.split.SplitModel` on the ``meta``
  device, one layer at a time — exact, nothing computed.  Float leaves
  count 4 bytes each whatever the model's dtype (the planner applies the
  wire dtype's ratio at plan time, ``runtime/plan.py``).
* ``exe_time`` has two modes.  ``"time"``: each layer's forward on the
  device, timed by CUDA events (``perf_counter`` on the CPU), the median
  of the repeats after warm-up, in seconds.  ``"flops"``: the layer's
  FLOPs on the shape pass, over 1e12, floored at ``size_data × 1e-3``
  so that no layer is free (the planner compares only ratios).  They
  are counted by :class:`torch.utils.flop_counter.FlopCounterMode` with
  formulas in the convention of XLA's cost analysis, which the JAX
  package reads (:data:`XLA_STYLE_FLOPS`), so that both packages' flops
  profiles lead the planner to the same cuts.  Every layer of VGG16 and
  ResNet-50 counts as XLA does; a model holding a layer kind whose
  count differs (:func:`check_flops_countable`: the ViT's and KWT's
  pre-LN block and CLS LayerNorm, BERT's embeddings, blocks, half-blocks
  and tanh pooler) is refused in this mode, naming the kind, rather than
  profiled with a count that is wrong.  A boundary that is a tuple
  (BERT's ``(hidden, mask)``) sums its leaves' bytes.
* ``speed`` is always the wall-clock samples/s of the full forward on
  the device (the GMM straggler selection compares it across devices).
* ``network`` is measured through one of the port's transports
  (:func:`profile_network`).

Usage (on the card; ``--device cpu`` asks for the CPU)::

    python -m split_learning_torch.profiler --config configs/baseline2.yaml
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop

from split_learning_torch.device import resolve_device
from split_learning_torch.models import build_model


def _leaves(x) -> list:
    """The tensors of a layer boundary (a tensor or a tuple/list/dict of
    them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for item in x for t in _leaves(item)]


def _nbytes(x) -> int:
    return sum(t.numel() * (4 if t.is_floating_point()
                            else t.element_size()) for t in _leaves(x))


def _like(x, device):
    """Zeros shaped like boundary ``x`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    return type(x)(_like(t, device) for t in x)


def example_batch(model_key: str, batch_size: int,
                  model_kwargs: dict | None = None) -> torch.Tensor:
    """Zeros shaped and typed like one batch of ``model_key``'s inputs
    (on the CPU)."""
    from split_learning_torch.data import make_data_loader
    from split_learning_torch.runtime.validation import (
        dataset_for_model, dataset_kwargs_for_model,
    )
    ds = make_data_loader(dataset_for_model(model_key), 1, train=False,
                          synthetic_size=8,
                          dataset_kwargs=dataset_kwargs_for_model(
                              model_key, model_kwargs))
    x0, _ = next(iter(ds))
    arr = np.asarray(x0)
    return torch.zeros((batch_size,) + arr.shape[1:],
                       dtype=torch.from_numpy(arr).dtype)


def _numel(shape) -> int:
    return math.prod(shape)


def _conv_flops(x_shape, w_shape, bias, stride, padding, dilation,
                transposed, *args, out_shape=None, **kwargs) -> int:
    """2 × the multiply-adds of the taps that land inside the input,
    plus one per output for the bias: XLA's count, which leaves out the
    zero padding (torch's own formula counts every tap)."""
    if transposed:
        return conv_flop(x_shape, w_shape, bias, stride, padding, dilation,
                         transposed, *args, out_shape=out_shape)
    taps = 1
    for d, (n_in, k) in enumerate(zip(x_shape[2:], w_shape[2:])):
        s, p, dil = stride[d], padding[d], dilation[d]
        taps *= sum(1 for o in range(out_shape[2 + d]) for j in range(k)
                    if 0 <= o * s - p + j * dil < n_in)
    macs = out_shape[0] * w_shape[0] * w_shape[1] * taps
    return 2 * macs + (_numel(out_shape) if bias is not None else 0)


def _per_output(*args, out_shape=None, **kwargs) -> int:
    return _numel(out_shape)


def _per_input(x_shape, *args, out_shape=None, **kwargs) -> int:
    return _numel(x_shape)


def _softmax_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 4 * _numel(x_shape)   # max, subtract, sum, divide


def _pool_flops(x_shape, kernel, *args, out_shape=None, **kwargs) -> int:
    return (math.prod(kernel) - 1) * _numel(out_shape[0])


_aten = torch.ops.aten
#: FLOP formulas in XLA's cost-analysis convention, beside torch's own
#: for the products (mm, bmm, addmm, SDPA): one FLOP per element of an
#: arithmetic op or a comparison, one per input element of a reduction,
#: none for a transcendental (exp, rsqrt, sigmoid, sin, cos) or a move
XLA_STYLE_FLOPS = {
    _aten.convolution: _conv_flops,
    **{op: _per_output for op in (
        _aten.add, _aten.sub, _aten.mul, _aten.div, _aten.neg, _aten.pow,
        _aten.relu, _aten.maximum, _aten.minimum, _aten.clamp_min,
        _aten.where, _aten.masked_fill, _aten.silu)},
    **{op: _per_input for op in (_aten.sum, _aten.mean, _aten.amax)},
    _aten._softmax: _softmax_flops,
    _aten.max_pool2d_with_indices: _pool_flops,
}


def _uncounted_kinds():
    """Layer kinds whose forward FLOPs :data:`XLA_STYLE_FLOPS` does not
    count as XLA's cost analysis does: the LayerNorm, softmax, tanh and
    tanh-gelu chains (a ViT-S block counts 474543680 against XLA's
    476188160, the CLS LayerNorm 5384 against 5386) — in the ViT's and
    KWT's blocks and CLS LayerNorms, and in BERT's embeddings (their
    LayerNorm), blocks, half-blocks and pooler."""
    from split_learning_torch.models.split import LayerNorm
    from split_learning_torch.models.transformer import (
        BertAttentionSublayer, BertBlock, BertEmbeddings, BertFfnSublayer,
        Pooler, PreLNBlock,
    )
    from split_learning_torch.models.vit import ClsNorm
    return (PreLNBlock, ClsNorm, LayerNorm, BertEmbeddings, BertBlock,
            BertAttentionSublayer, BertFfnSublayer, Pooler)


def check_flops_countable(model: torch.nn.Module) -> None:
    """Raise ``NotImplementedError`` naming every layer kind of ``model``
    (a :class:`SplitModel`) whose FLOPs flops mode cannot count in XLA's
    convention."""
    kinds = _uncounted_kinds()
    bad = sorted({type(m).__name__ for m in model.layers.values()
                  if isinstance(m, kinds)})
    if bad:
        raise NotImplementedError(
            f"flops mode cannot count layer kind(s) {', '.join(bad)} in "
            "XLA's convention yet; profile this model in time mode "
            "(ROADMAP.md A.7)")


def shape_pass(model_key: str, example: torch.Tensor,
               model_kwargs: dict | None = None) -> tuple[list, list]:
    """The model on the ``meta`` device, layer by layer: (the boundary
    after each layer, each layer's forward FLOPs by
    :data:`XLA_STYLE_FLOPS`).  Attention runs its dense path here
    (``use_flash`` off): the same shapes and math, and the flash
    kernels have no meta-device path."""
    kw = dict(model_kwargs or {})
    if "use_flash" in kw:
        kw["use_flash"] = False
    full = build_model(model_key, device="meta",
                       generator=torch.Generator(), **kw)
    x = _like(example, "meta")
    bounds, flops = [], []
    with torch.no_grad():
        for i in range(1, len(full.specs) + 1):
            counter = FlopCounterMode(display=False,
                                      custom_mapping=XLA_STYLE_FLOPS)
            with counter:
                x = full.shard(i - 1, i)(x, train=False)
            bounds.append(x)
            flops.append(float(counter.get_total_flops()))
    return bounds, flops


def _median_s(fn, device: torch.device, warmup: int, repeats: int) -> float:
    """Median seconds of ``fn()`` over ``repeats`` after ``warmup`` calls:
    CUDA events on the card, ``perf_counter`` on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def profile_model(model_key: str, batch_size: int = 32,
                  model_kwargs: dict | None = None,
                  example: torch.Tensor | None = None,
                  method: str = "flops", warmup: int = 2,
                  repeats: int = 5, seed: int = 0, device=None) -> dict:
    """Per-layer cost + activation-size profile of a registered model on
    ``device`` (CUDA unless the CPU is asked for).

    Returns ``{exe_time, size_data, speed, network}`` (``network`` is
    filled by :func:`profile_network`; 0.0 here)."""
    if method not in ("flops", "time"):
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    kw = dict(model_kwargs or {})
    if example is None:
        example = example_batch(model_key, batch_size, kw)
    bounds, flops = shape_pass(model_key, example, kw)
    size_data = [_nbytes(b) for b in bounds]

    gen = torch.Generator(device=device).manual_seed(seed)
    full = build_model(model_key, device=device, generator=gen, **kw)
    if method == "flops":
        check_flops_countable(full)
    full.eval()
    exe_time: list[float] = []
    with torch.no_grad():
        if method == "flops":
            exe_time = [max(f, size * 1e-3) / 1e12
                        for f, size in zip(flops, size_data)]
        else:
            inputs = [example] + bounds[:-1]
            for i, x in enumerate(inputs, start=1):
                layer, x_in = full.shard(i - 1, i), _like(x, device)
                exe_time.append(_median_s(
                    lambda: layer(x_in, train=False), device, warmup,
                    repeats))
        # speed is ALWAYS the wall clock of the full forward: flop
        # counts are hardware-independent and would make the GMM
        # selection across devices a silent no-op
        x_full = _like(example, device)

        def forward():
            full(x_full, train=False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        forward()
        ts = []
        for _ in range(max(2, repeats // 2)):
            t0 = time.perf_counter()
            forward()
            ts.append(time.perf_counter() - t0)
    speed = float(example.shape[0]
                  / max(float(statistics.median(ts)), 1e-9))
    return {"exe_time": exe_time, "size_data": size_data, "speed": speed,
            "network": 0.0}


def profile_network(transport, sizes_mb: Sequence[int] = range(1, 10),
                    repeats: int = 5,
                    queue: str = "bandwidth_probe") -> float:
    """Bytes/s through ``transport``: 1–9 MB payloads published and
    fetched back, averaged (a round trip moves each payload twice)."""
    rates = []
    for mb in sizes_mb:
        payload = b"\x00" * (mb * 1_000_000)
        for _ in range(repeats):
            t0 = time.perf_counter()
            transport.publish(queue, payload)
            got = transport.get(queue, timeout=30.0)
            dt = time.perf_counter() - t0
            if got is None:
                # the payload still in flight would surface as a stale
                # message and corrupt the next sample's timing
                transport.purge([queue])
                continue
            rates.append(len(payload) * 2 / dt)
    return float(np.mean(rates)) if rates else 0.0


def write_profile(path: str, profile: dict) -> None:
    with open(path, "w") as f:
        json.dump(profile, f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Profile a model + link for the partition planner "
                    "(reference profiling.py parity).")
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--output", default="profiling.json")
    ap.add_argument("--method", choices=["flops", "time"], default="time")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--probe-network", action="store_true",
                    help="also measure the configured transport's "
                         "bandwidth (tcp: needs the broker)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from split_learning_torch.config import from_yaml
    cfg = from_yaml(args.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prof = profile_model(
        cfg.model_key, batch_size=args.batch or cfg.learning.batch_size,
        model_kwargs=dict(cfg.model_kwargs or {}), method=args.method,
        device=device)
    if args.probe_network:
        from split_learning_torch.runtime.bus import make_transport
        bus = make_transport(cfg.transport.kind, cfg.transport.host,
                             cfg.transport.port)
        try:
            prof["network"] = profile_network(bus)
        finally:
            bus.close()
    write_profile(args.output, prof)
    print(json.dumps({"layers": len(prof["exe_time"]),
                      "speed": prof["speed"],
                      "network": prof["network"]}))
    return prof


if __name__ == "__main__":
    main()
