"""Protocol client: the reference's ``client.py`` + ``RpcClient`` +
``Train_*`` stack as one generic runner.

Port of the synchronous part of the JAX package's ``runtime/client.py``.
Lifecycle: REGISTER -> wait on ``reply_{id}`` -> START builds the shard
model and (stage 1) the data loader -> READY -> SYN runs the streaming
hot loop -> NOTIFY/PAUSE -> UPDATE with the trained shard -> STOP.

One generic :class:`ShardRunner` plays the reference's three roles:

* stage 1: event-driven 1F1B with a bounded in-flight window
  (``control-count``) and backward-time activation recomputation — the
  forward runs without a graph, and the backward re-runs it with one and
  backpropagates the received cotangent;
* middle stages: trace-routed forward/backward relay;
* last stage: loss + backward, the input gradient returned along the
  popped trace; a NaN loss flags the round.

Each client runs on the caller's device (CUDA unless the CPU is asked
for).  Many client threads may share one card: every op launches on the
thread's current stream, and tensors cross participants only as host
bytes through the bus.  Without a transport from the caller, a client
builds its configured stack (``runtime/chaos.py``
``make_runtime_transport``).  On a deferred bus (the async sender) an
activation or gradient's codec, device-to-host fetch and frame encode
run in a thunk on the sender thread, on the CUDA stream that produced
the tensor.

Left out (each raises ``NotImplementedError`` when its config asks for
it): async decoupled mode and auxiliary heads, server-side data
aggregation windows wider than one batch (DCSL SDA), sync-overlap ticks,
LoRA adapters, FLEX hold STARTs without weights, the legacy int8 wire
dtype.  Heartbeats, tracing spans and scheduler knobs are not emitted.
"""

from __future__ import annotations

import dataclasses
import uuid
import zlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from split_learning_torch.config import Config, LearningConfig
from split_learning_torch.data import make_data_loader, subset_seed
from split_learning_torch.device import resolve_device
from split_learning_torch.models import build_model
from split_learning_torch.parallel.pipeline import clip_by_global_norm
from split_learning_torch.runtime.bus import QueueClosed, Transport
from split_learning_torch.runtime.codec import make_codecs, wire_raw_nbytes
from split_learning_torch.runtime.context import make_optimizer
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, Activation, EpochEnd, FrameAssembler, Gradient, Notify,
    Pause, QuantLeaf, Ready, Register, Start, Stop, Syn, Update, encode,
    encode_parts, gradient_queue, host_tensor, intermediate_queue,
    reply_queue,
)
from split_learning_torch.runtime.validation import (
    dataset_for_model, dataset_kwargs_for_model,
)

_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


def wire_torch_dtype(name: str) -> torch.dtype:
    from split_learning_torch.config import TransportConfig
    name = TransportConfig.WIRE_DTYPE_ALIASES.get(name, name)
    if name not in _WIRE_DTYPES:
        raise NotImplementedError(
            f"transport.wire-dtype {name} (the legacy per-tensor int8 "
            "quantizer) is not ported; use transport.codec int8/int4")
    return _WIRE_DTYPES[name]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_wire_tree(tree, dtype: torch.dtype):
    """Device tree -> host payload: float leaves cast to the wire dtype
    on the device, then fetched (bfloat16 stays a CPU tensor, numpy
    cannot hold it); others at their own dtype."""
    def conv(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        t = leaf.detach()
        if t.is_floating_point():
            t = t.to(dtype)
        t = t.cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return _map(conv, tree)


def _from_wire_tree(tree, device: torch.device):
    """Wire payload tree -> device tensors.  Self-describing: a
    QuantLeaf decodes without the sender's codec config."""
    def conv(leaf):
        if isinstance(leaf, QuantLeaf):
            from split_learning_torch.runtime.codec.quant import (
                dequantize_leaf,
            )
            return dequantize_leaf(leaf, device)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        return host_tensor(np.ascontiguousarray(leaf)).to(device)
    return _map(conv, tree)


@dataclasses.dataclass
class _AbortPause(Pause):
    """Local sentinel: the round was abandoned (STOP/fresh START arrived
    mid-loop) — unwind WITHOUT publishing any UPDATE."""


def learning_from_dict(learning: dict | None) -> LearningConfig:
    d = dict(learning or {})
    known = {f.name for f in dataclasses.fields(LearningConfig)}
    return LearningConfig(**{k: v for k, v in d.items() if k in known})


class ShardRunner:
    """Forward / recompute-backward / optimizer step for one shard.

    BatchNorm statistics change once per consumed batch, as in the JAX
    package: the graph-free forward leaves them as they are, and
    :meth:`apply_update` keeps those of the backward's recompute (or of
    the last stage's one forward) with the optimizer step.  The
    recompute replays the forward's dropout masks."""

    def __init__(self, model_key: str, start_layer: int, end_layer: int,
                 learning: dict | None, model_kwargs: dict, device,
                 seed: int = 0):
        self.learning_dict = dict(learning or {})
        self.learning = learning_from_dict(learning)
        if self.learning.lora_rank > 0:
            raise NotImplementedError(
                "learning.lora-rank > 0 (LoRA adapters, ops/lora.py) is not "
                "ported yet; it comes with the fine-tuning slice")
        self.start_layer = start_layer
        self.end_layer = end_layer
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model = build_model(model_key, start_layer, end_layer,
                                 device=device, generator=gen,
                                 **model_kwargs)
        self.model.train()
        self.optimizer = None

    def load(self, params: dict, stats: dict | None = None) -> None:
        """Adopt a START shard (parameters and BatchNorm statistics) and
        a fresh optimizer (the reference rebuilds its optimizer every
        round)."""
        self.model.load_state_tree(params)
        self.model.load_stats_tree(stats or {})
        self.optimizer = make_optimizer(self.learning,
                                        self.model.parameters())

    def fwd(self, x: torch.Tensor):
        """Forward without a graph: the backward recomputes it.  Returns
        (output, the dropout generators' states for that recompute)."""
        rng = self.model.rng_state()
        with torch.no_grad():
            return self.model(x, train=True), rng

    def bwd(self, x: torch.Tensor, ct: torch.Tensor, rng: list):
        """Recompute the forward with the masks of :meth:`fwd` (``rng``)
        and backpropagate the received cotangent into the parameters'
        ``.grad``; returns the input gradient (None for integer
        inputs)."""
        now = self.model.rng_state()
        self.model.set_rng_state(rng)
        xr = x.detach().requires_grad_(x.is_floating_point())
        out = self.model(xr, train=True)
        self.model.set_rng_state(now)
        out.backward(ct.to(out.dtype))
        return xr.grad

    def last_step(self, x: torch.Tensor, labels: torch.Tensor):
        """Last stage: float32 cross entropy, gradients into ``.grad``;
        returns (loss, input gradient)."""
        xr = x.detach().requires_grad_(x.is_floating_point())
        logits = self.model(xr, train=True)
        loss = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.reshape(-1).long())
        loss.backward()
        return loss.detach(), xr.grad

    def apply_update(self) -> None:
        """The optimizer step on the batch's gradients, and the batch's
        BatchNorm statistics kept."""
        self.model.commit_stats()
        params = list(self.model.parameters())
        if self.learning.clip_grad_norm:
            clip_by_global_norm(params, self.learning.clip_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def state_tree(self) -> dict:
        return self.model.state_tree()

    def stats_tree(self) -> dict:
        return self.model.stats_tree()


@dataclasses.dataclass
class _Inflight:
    x: Any
    trace: list
    n: int = 0   # batch size; counted into num_samples at BACKWARD time
    rng: list = dataclasses.field(default_factory=list)   # fwd's masks


class ProtocolClient:
    """One split-learning client (reference ``client.py`` +
    ``src/RpcClient.py``), on ``device`` (CUDA unless the CPU is asked
    for), speaking over ``transport``."""

    def __init__(self, cfg: Config, client_id: str, stage: int,
                 transport: Transport | None = None,
                 cluster: int | None = None, profile: dict | None = None,
                 logger: Logger | None = None, device=None):
        lrn = cfg.learning
        if lrn.mode == "async":
            raise NotImplementedError(
                "learning.mode: async (decoupled stages with auxiliary "
                "heads) is not ported yet; it comes with the async slice")
        if lrn.sync_overlap:
            raise NotImplementedError(
                "learning.sync-overlap is not ported yet; it comes with "
                "the async slice")
        self.cfg = cfg
        self.client_id = client_id
        self.stage = stage
        self.cluster = cluster
        self.profile = profile
        self.device = resolve_device(device)
        # a stack built here is closed (its sender flushed) by run()
        self._own_bus = transport is None
        if transport is None:
            from split_learning_torch.runtime.chaos import (
                make_runtime_transport,
            )
            transport = make_runtime_transport(cfg, client_id)
        self.bus = transport
        from split_learning_torch.runtime.trace import default_fault_counters
        self.faults = default_fault_counters
        # chunked-frame reassembly is per consumer thread; the client is
        # single-threaded over its queues
        self._assembler = FrameAssembler()
        self._chunk_bytes = cfg.transport.chunk_mb << 20
        self.log = logger or Logger.for_run(cfg, client_id, console=False)
        self.wire_dtype = wire_torch_dtype(cfg.transport.wire_dtype)
        # per-queue-family wire codecs (transport.codec); families
        # without a policy take the plain wire-dtype path
        self.codecs = make_codecs(cfg, faults=self.faults)
        #: dense-equivalent bytes of every codec'd payload, per queue —
        #: the denominator of the wire compression ratio
        self.raw_bytes_out: dict[str, int] = {}
        self.runner: ShardRunner | None = None
        self.loader = None
        self.epochs = 1
        self.fence = 0
        self.n_stages = cfg.num_stages
        self.round_ok = True
        self.num_samples = 0
        # device-resident NaN sentinel: the last stage folds
        # isfinite(loss) into it without a host sync; _send_update reads
        # it once per round
        self._ok_dev = None

    # -- control plane -----------------------------------------------------

    def _decode(self, raw: bytes, queue: str | None = None):
        """Tolerant decode: a frame that fails a checksum (or any guard
        inside decode) is dropped and counted, never fatal.  Returns None
        for dropped frames and for a chunk of a still-partial message."""
        try:
            return self._assembler.feed(raw)
        except Exception as e:  # noqa: BLE001 — see docstring
            self.faults.inc("corrupt_rejected")
            self.log.warning(f"dropping undecodable frame on {queue}: {e}")
            return None

    def _publish_parts(self, queue: str, build) -> None:
        """Data-plane publish: ``build()`` produces the frame part list.
        On a deferred bus the thunk is enqueued and runs on the sender
        thread, so batch k's codec, fetch and encode overlap batch k+1's
        compute; on a plain bus it runs inline.

        The thunk holds a reference to every tensor it reads, so the
        caching allocator cannot hand that memory on, and those tensors
        are fresh outputs (a forward's result, an input gradient) that
        the training thread never writes again.  On the card it runs on
        the stream that was current here at publish time, so its
        kernels and its copy are ordered after the ones that produced
        its inputs."""
        if not getattr(self.bus, "deferred", False):
            for part in build():
                self.bus.publish(queue, part)
            return
        if self.device.type == "cuda":
            stream, inner = torch.cuda.current_stream(self.device), build

            def build():
                with torch.cuda.stream(stream):
                    return inner()
        self.bus.publish(queue, build)

    # -- wire codec plumbing -----------------------------------------------

    def _count_raw(self, tree, family: str, queue: str) -> None:
        """Counts the pre-codec dense-equivalent bytes of a codec'd
        payload (on the training thread), so the compression ratio is
        measured."""
        if family in self.codecs:
            self.raw_bytes_out[queue] = (self.raw_bytes_out.get(queue, 0)
                                         + wire_raw_nbytes(
                                             tree, self.wire_dtype))

    def _wire_payload(self, tree, family: str, queue: str):
        """Device tree -> wire payload tree: codec ``prepare`` (the
        quantize kernel) then ``encode`` (the fetch) when a policy
        covers ``family``, else the plain device cast and host fetch.
        Runs inside the publish thunk."""
        c = self.codecs.get(family)
        if c is None:
            return _to_wire_tree(tree, self.wire_dtype)
        return c.encode(c.prepare(tree, key=queue))

    def register(self):
        self.bus.publish(RPC_QUEUE, encode(Register(
            client_id=self.client_id, stage=self.stage,
            cluster=self.cluster, profile=self.profile)))
        self.log.info(f"[>>>] REGISTER stage={self.stage}")

    def run(self):
        """Blocking lifecycle loop; returns on STOP (and then closes a
        transport stack it built itself)."""
        try:
            self._run()
        finally:
            if self._own_bus:
                self.bus.close()

    def _run(self):
        """Until the first START arrives, REGISTER is re-sent every few
        seconds: a client that comes up before the server would
        otherwise lose its registration to the server's startup purge."""
        self.register()
        q = reply_queue(self.client_id)
        started = False
        while True:
            try:
                raw = self.bus.get(q, timeout=None if started else 3.0)
            except (QueueClosed, ConnectionError, OSError) as e:
                if not started:
                    raise
                self.log.warning(f"transport closed ({e}); shutting down")
                return
            if raw is None:
                if not started:
                    self.register()
                continue
            msg = self._decode(raw, q)
            if msg is None:
                continue
            if isinstance(msg, Start):
                started = True
                self._on_start(msg)
                self.bus.publish(RPC_QUEUE, encode(Ready(
                    client_id=self.client_id, round_idx=self.fence)))
                self.log.info("[>>>] READY")
            elif isinstance(msg, Syn):
                self._on_syn(msg)
            elif isinstance(msg, Stop):
                self.log.info(f"[<<<] STOP {msg.reason}")
                return
            else:
                self.log.warning(f"unexpected control message {msg}")

    def _on_start(self, msg: Start):
        self.log.info(f"[<<<] START layers=[{msg.start_layer}, "
                      f"{msg.end_layer}] cluster={msg.cluster}")
        self.cluster = msg.cluster
        extra = msg.extra or {}
        self.epochs = int(extra.get("epochs", 1))
        if int(extra.get("sda_size", 1)) > 1:
            raise NotImplementedError(
                "server-side data aggregation windows (sda-size > 1, DCSL) "
                "are not ported yet; they come with the strategies slice")
        # server-assigned per-invocation generation: stamps every message
        # this client sends so strays from an abandoned invocation drop
        self.fence = int(extra.get("gen", msg.round_idx))
        self.n_stages = int(extra.get("n_stages", self.cfg.num_stages))
        if msg.params is None:
            raise NotImplementedError(
                "START without weights (FLEX client-side persistence) is "
                "not ported yet; it comes with the strategies slice")
        r = self.runner
        if (r is None or (r.start_layer, r.end_layer)
                != (msg.start_layer, msg.end_layer)
                or r.learning_dict != dict(msg.learning or {})):
            model_kwargs = dict(self.cfg.model_kwargs or {})
            if self.cfg.compute_dtype == "bfloat16":
                model_kwargs.setdefault("dtype", torch.bfloat16)
            self.runner = ShardRunner(
                self.cfg.model_key, msg.start_layer, msg.end_layer,
                msg.learning, model_kwargs, self.device,
                seed=self.cfg.seed
                + zlib.crc32(self.client_id.encode()) % 100000)
        self.runner.load(_from_wire_tree(msg.params, self.device),
                         _from_wire_tree(msg.batch_stats or {},
                                         self.device))
        self._build_loader(msg)

    def _build_loader(self, msg: Start):
        """(Re)build the stage-1 data loader from a START's label counts:
        per-client subset seed, re-salted per round under
        ``distribution.refresh``."""
        if self.stage == 1 and msg.label_counts is not None:
            self.loader = make_data_loader(
                dataset_for_model(self.cfg.model_key),
                self.runner.learning.batch_size,
                distribution=np.asarray(msg.label_counts), train=True,
                seed=subset_seed(self.cfg.seed, self.client_id,
                                 msg.round_idx,
                                 (msg.extra or {}).get("refresh", False)),
                synthetic_size=self.cfg.synthetic_size,
                dataset_kwargs=dataset_kwargs_for_model(
                    self.cfg.model_key, self.cfg.model_kwargs))

    def _on_syn(self, msg: Syn):
        self.log.info(f"[<<<] SYN round={msg.round_idx}")
        self.round_ok = True
        self._ok_dev = torch.ones((), dtype=torch.bool, device=self.device)
        self.num_samples = 0
        if self.stage == 1:
            pause = self._train_first()
        elif self.stage == self.n_stages:
            pause = self._train_last()
        else:
            pause = self._train_middle()
        if isinstance(pause, _AbortPause):
            return   # round abandoned: the server stopped counting us
        self._send_update(with_weights=pause.send_weights)

    def _send_update(self, with_weights: bool):
        # the round's ONE host sync of the NaN sentinel
        if self._ok_dev is not None and not bool(self._ok_dev):
            self.round_ok = False
        params_h = stats_h = None
        if with_weights:
            params_h, stats_h = (
                {layer: {k: t.detach().cpu().numpy()
                         for k, t in sd.items()}
                 for layer, sd in tree.items()}
                for tree in (self.runner.state_tree(),
                             self.runner.stats_tree()))
        # TENSOR-framed and chunked: a shard UPDATE is the biggest frame
        # a client publishes.  The weights were fetched above, on this
        # thread: the next START loads into the same parameters in place
        msg = Update(
            client_id=self.client_id, stage=self.stage,
            cluster=self.cluster, params=params_h, batch_stats=stats_h,
            num_samples=self.num_samples, ok=self.round_ok,
            round_idx=self.fence, version=self.fence)
        self._publish_parts(
            RPC_QUEUE, lambda: encode_parts(msg, self._chunk_bytes))
        # the next START re-initialises the moments anyway: free them now,
        # while the server folds, rather than holding them on the card
        self.runner.optimizer = None
        self.log.info(f"[>>>] UPDATE samples={self.num_samples} "
                      f"ok={self.round_ok}"
                      + ("" if with_weights else " (no weights)"))

    def _redeliver(self, msg) -> Pause:
        """A STOP or a fresh START arriving mid-training: requeue it for
        the run() loop and unwind the hot loop without uploading (the
        server is shutting down, or timed this client out of the round
        and moved on)."""
        self.bus.publish(reply_queue(self.client_id), encode(msg))
        if isinstance(msg, Start):
            self.log.warning("START while mid-round: rejoining next round")
        return _AbortPause(send_weights=False)

    def _wait_pause(self) -> Pause:
        q = reply_queue(self.client_id)
        while True:
            raw = self.bus.get(q)
            if raw is None:
                continue
            msg = self._decode(raw, q)
            if msg is None:
                continue
            if isinstance(msg, Pause):
                self.log.info("[<<<] PAUSE")
                return msg
            if isinstance(msg, (Stop, Start)):
                return self._redeliver(msg)
            self.log.warning(f"ignoring {type(msg).__name__} while "
                             f"awaiting PAUSE")

    def _check_pause(self) -> Pause | None:
        """Non-blocking-ish control poll from inside a hot loop."""
        q = reply_queue(self.client_id)
        raw = self.bus.get(q, timeout=0.001)
        if raw is None:
            return None
        msg = self._decode(raw, q)
        if isinstance(msg, Pause):
            return msg
        if isinstance(msg, (Stop, Start)):
            return self._redeliver(msg)
        return None

    # -- hot loops -----------------------------------------------------------

    def _backward(self, ent: _Inflight, g: Gradient):
        """Recompute + backprop one received gradient, step, count."""
        gx = self.runner.bwd(ent.x, _from_wire_tree(g.data, self.device),
                             ent.rng)
        self.runner.apply_update()
        # counted here, not at dispatch: a mid-loop PAUSE abandons
        # in-flight forwards, and the FedAvg weight must only cover
        # samples whose update was applied
        self.num_samples += ent.n
        return gx

    def _send_gradient(self, gx, data_id: str, trace: list) -> None:
        origin = trace[-1]
        q = gradient_queue(self.stage - 1, origin)
        self._count_raw(gx, "gradient", q)
        trace, fence = list(trace)[:-1], self.fence
        self._publish_parts(q, lambda: encode_parts(Gradient(
            data_id=data_id, data=self._wire_payload(gx, "gradient", q),
            trace=trace, round_idx=fence), self._chunk_bytes))

    def _send_activation(self, out, q: str, data_id: str, labels,
                         trace: list) -> None:
        self._count_raw(out, "intermediate", q)
        cluster, fence = self.cluster, self.fence
        self._publish_parts(q, lambda: encode_parts(Activation(
            data_id=data_id, data=self._wire_payload(out, "intermediate", q),
            labels=labels, trace=trace, cluster=cluster, round_idx=fence),
            self._chunk_bytes))

    def _train_first(self) -> Pause:
        """Bounded-in-flight 1F1B streaming (``src/train/VGG16.py:61-136``)."""
        r = self.runner
        inflight: dict[str, _Inflight] = {}
        grad_q = gradient_queue(self.stage, self.client_id)
        out_q = intermediate_queue(self.stage, self.cluster)
        cap = max(1, r.learning.control_count)
        n_fwd = n_bwd = 0
        for _ in range(self.epochs):
            data_iter = iter(self.loader)
            # prefetch one batch: exhaustion must be known at the LAST
            # dispatch, not when the in-flight cap next frees
            next_item = next(data_iter, None)
            exhausted = next_item is None
            while not (exhausted and n_fwd == n_bwd):
                raw = self.bus.get(grad_q, timeout=0.0005)
                if raw is not None:
                    g = self._decode(raw, grad_q)
                    if g is None or g.round_idx != self.fence:
                        continue   # corrupt, or from a dropped round
                    ent = inflight.pop(g.data_id, None)
                    if ent is None:   # no longer tracked (cut round)
                        continue
                    self._backward(ent, g)
                    n_bwd += 1
                    continue
                if exhausted or len(inflight) >= cap:
                    # idle: check for an early PAUSE/STOP rather than
                    # waiting forever for gradients that will never come
                    pause = self._check_pause()
                    if pause is not None:
                        self.log.warning(
                            f"PAUSE mid-loop with {len(inflight)} in flight")
                        return pause
                    continue
                x, labels = next_item
                next_item = next(data_iter, None)
                x = torch.from_numpy(np.asarray(x)).to(self.device)
                data_id = uuid.uuid4().hex
                out, rng = r.fwd(x)
                inflight[data_id] = _Inflight(x=x, trace=[self.client_id],
                                              n=len(labels), rng=rng)
                self._send_activation(out, out_q, data_id,
                                      np.asarray(labels, np.int32),
                                      [self.client_id])
                n_fwd += 1
                if next_item is None:
                    exhausted = True
        self.bus.publish(RPC_QUEUE, encode(Notify(
            client_id=self.client_id, cluster=self.cluster,
            round_idx=self.fence)))
        self.log.info(f"[>>>] NOTIFY fwd={n_fwd} bwd={n_bwd}")
        return self._wait_pause()

    def _train_middle(self) -> Pause:
        r = self.runner
        in_q = intermediate_queue(self.stage - 1, self.cluster)
        out_q = intermediate_queue(self.stage, self.cluster)
        grad_q = gradient_queue(self.stage, self.client_id)
        inflight: dict[str, _Inflight] = {}
        while True:
            pause = self._check_pause()
            if pause is not None:
                self.log.info("[<<<] PAUSE")
                return pause
            raw = self.bus.get(grad_q, timeout=0.0005)
            if raw is not None:
                g = self._decode(raw, grad_q)
                if g is None or g.round_idx != self.fence:
                    continue
                ent = inflight.pop(g.data_id, None)
                if ent is None:
                    continue
                gx = self._backward(ent, g)
                self._send_gradient(gx, g.data_id, ent.trace)
                continue
            raw = self.bus.get(in_q, timeout=0.0005)
            if raw is None:
                continue
            act = self._decode(raw, in_q)
            if act is None or act.round_idx != self.fence \
                    or isinstance(act, EpochEnd):
                continue   # corrupt, from a dropped round, or a fence
            x = _from_wire_tree(act.data, self.device)
            out, rng = r.fwd(x)
            inflight[act.data_id] = _Inflight(x=x, trace=list(act.trace),
                                              n=len(act.labels), rng=rng)
            self._send_activation(out, out_q, act.data_id,
                                  act.labels,
                                  list(act.trace) + [self.client_id])

    def _train_last(self) -> Pause:
        """Loss + backward + routed input-gradient return
        (``src/train/VGG16.py:138-191``), one received batch a step (the
        SDA window of one)."""
        in_q = intermediate_queue(self.stage - 1, self.cluster)
        while True:
            pause = self._check_pause()
            if pause is not None:
                self.log.info("[<<<] PAUSE")
                return pause
            raw = self.bus.get(in_q, timeout=0.001)
            if raw is None:
                continue
            act = self._decode(raw, in_q)
            if act is None or act.round_idx != self.fence \
                    or isinstance(act, EpochEnd):
                continue
            self._last_step(act)

    def _last_step(self, act: Activation) -> None:
        r = self.runner
        x = _from_wire_tree(act.data, self.device)
        labels = torch.from_numpy(np.asarray(act.labels, np.int32)).to(
            self.device)
        loss, gx = r.last_step(x, labels)
        # NaN sentinel (src/train/VGG16.py:169), folded on the device and
        # synced once per round in _send_update
        self._ok_dev = self._ok_dev & torch.isfinite(loss)
        r.apply_update()
        self.num_samples += len(act.labels)
        self._send_gradient(gx, act.data_id, act.trace)
