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
  popped trace; a NaN loss flags the round.  Under SDA (DCSL) the head
  gathers a window of batches from distinct feeders and steps them as
  one concatenated batch, splitting the input gradient back per origin:
  the elastic window flushes a partial window when idle, the strict one
  waits for every feeder and drains leftovers only behind the feeders'
  epoch fences (relayed by middle stages at their quorum of copies).

The data plane follows the START: a 2LS pair's own forward queue, or
DCSL's round-robin scatter over the next stage's per-device queues.  A
START without weights (FLEX's hold round) keeps the shard, its optimizer
state and the loader's position, and a PAUSE that asks for no weights
gets an UPDATE with sample counts only.

A stage boundary may be a tuple of tensors (BERT's ``(hidden, mask)``):
only its float leaves backpropagate, and the gradient of a bool or int
leaf crosses the wire as zeros (:class:`~split_learning_torch.runtime.
protocol.Float0`), as the JAX package sends its ``float0`` cotangent.
With ``learning.lora-rank > 0`` a shard trains LoRA adapters drawn from
its own generator at every START over its target kernels (and the
classifier, on the last shard), the rest frozen, and its UPDATE carries
the merged weights.

Each client runs on the caller's device (CUDA unless the CPU is asked
for).  Many client threads may share one card: every op launches on the
thread's current stream, and tensors cross participants only as host
bytes through the bus.  Without a transport from the caller, a client
builds its configured stack (``runtime/chaos.py``
``make_runtime_transport``: the async sender over the reliable layer
over chaos injection, each as its config asks, on one broker or a
sharded plane) and closes every layer of it when ``run`` ends.  A
scripted :class:`~split_learning_torch.runtime.chaos.ChaosCrash` is not
caught: it unwinds ``run`` as the process's death, as in the JAX
package (a client process exits 1).  Each UPDATE logs the process's
cumulative fault counters (``round faults (cumulative): ...`` and a
``kind=faults`` record) when they changed.  On a deferred bus (the async
sender) an activation or gradient's codec, device-to-host fetch and
frame encode run in a thunk on the sender thread, on the CUDA stream
that produced the tensor.

Async decoupled mode (``learning.mode: async``): every non-final stage
trains against a local auxiliary head on its cut boundary
(:mod:`split_learning_torch.ops.auxiliary`) and steps right after its
forward, so no gradient crosses the wire; the last stage steps on the
true loss and returns nothing.  A PAUSE starts a bounded drain of the
in-flight activation stream (every feeder's last epoch fence, or
:data:`ASYNC_DRAIN_IDLE_S` of silence).  The head and its optimizer
state are client-local, shaped from one forward of the boundary and
reset when its shape signature changes.  After its UPDATE a stage-1
client keeps ticking locally (nothing published) until the next control
frame arrives; those samples are banked for the next round's UPDATE and
kept only across a hold START (a re-seed discards the shard work they
trained).  A START arriving mid-round uploads the round's work, late:
the server admits it through its bounded-staleness window.

Wire codecs: the ``gradient`` family may be top-k with error feedback,
and the ``rpc`` family sends the UPDATE as a quantized delta against the
START's weights when the version the server advertised still matches
(else the full frame).  With ``checkpoint.save`` the codecs' residuals
are written as sidecars beside the checkpoint after every UPDATE, and
read back at start-up with ``checkpoint.load``.  The legacy per-tensor
int8 wire dtype (``transport.wire-dtype: int8``) quantizes every
data-plane payload on the host.

Under the aggregator tree (``aggregation.fan-in``) the START names the
client's group (``agg_group``) and the UPDATE goes to that group's
``aggregate_queue`` instead of ``rpc_queue``.

Round tracing (``observability``): the client's span tracer, wire
counters and latency histograms are its transport stack's when the stack
has them (``bus.tracer``, ``bus.wire``, ``bus.hists``), else its own
tracer, the process-wide :data:`~split_learning_torch.runtime.trace.
default_wire_counters` and a fresh histogram set.  It adopts the
server's trace id from START, journals a ``client_round`` span a round
with the hot loops' ``fwd``, ``bwd``, ``sda_step`` and ``aux_step`` spans
inside it (the ``step`` histogram times each), a ``publish`` span per
data frame and UPDATE whose id and send time ride the frame as its
32-byte wire context, and a ``consume`` span per received frame that
carries one, parented to the sender's ``publish`` (the ``frame_rtt``
histogram reads its send time).  Each UPDATE is followed by cumulative
``kind=wire_client`` and ``kind=latency`` records when they changed.
The ``step`` clock stops when the step's launches return, not when the
card has run them, as the JAX package's stops at dispatch.

The live telemetry plane (``observability.heartbeat-interval`` > 0, the
default): a :class:`~split_learning_torch.runtime.telemetry.
TelemetryEmitter` thread, started at the first START and stopped however
``run`` ends (a crashed client stops reporting healthy), publishes a
HEARTBEAT on the rpc queue every interval: the fault counters, the wire
counters, the latency histograms, the gauges (``round`` at SYN,
``epoch``, stage 1's ``inflight``, a later stage's ``queue_depth``) and
the EWMA samples/s of the host-side sample counter.  It reads host
integers and host counters only, so it never waits on the card.  Every
UPDATE carries the same snapshot.

Left out (raises ``NotImplementedError`` when its config asks for it):
sync-overlap ticks (and their speculative forwards across a hold START).
The perf plane's records and scheduler knobs are not emitted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
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
from split_learning_torch.ops.lora import (
    lora_forward, lora_init, lora_merge, lora_trainable, split_frozen,
)
from split_learning_torch.parallel.pipeline import (
    backward_boundary, clip_by_global_norm, cut_boundary, tree_leaves,
)
from split_learning_torch.runtime.bus import QueueClosed, Transport
from split_learning_torch.runtime.codec import make_codecs, wire_raw_nbytes
from split_learning_torch.runtime.context import make_optimizer
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, Activation, EpochEnd, FrameAssembler, Float0, Gradient,
    Heartbeat, Notify, Pause, QuantLeaf, Ready, Register, SparseLeaf, Start,
    Stop, Syn, Update, aggregate_queue, encode, encode_parts,
    gradient_queue, host_tensor, intermediate_queue, reply_queue,
)
from split_learning_torch.runtime.spans import make_tracer, unpack_ctx
from split_learning_torch.runtime.telemetry import GaugeSet, TelemetryEmitter
from split_learning_torch.runtime.validation import (
    dataset_for_model, dataset_kwargs_for_model,
)

_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "int8": torch.int8}

#: async drain-on-pause idle grace (seconds): a PAUSEd async consumer
#: keeps eating its in-flight activation stream until every origin
#: feeder's last epoch fence arrived, or the queue was silent this long
#: (a delayed stream's tail beyond it is dropped, not waited for)
ASYNC_DRAIN_IDLE_S = 0.5


def wire_torch_dtype(name: str) -> torch.dtype:
    """``transport.wire-dtype`` as a torch dtype; ``int8`` stands for
    the legacy per-tensor quantizer."""
    from split_learning_torch.config import TransportConfig
    return _WIRE_DTYPES[TransportConfig.WIRE_DTYPE_ALIASES.get(name, name)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_wire_tree(tree, dtype: torch.dtype):
    """Device tree -> host payload: float leaves cast to the wire dtype
    on the device, then fetched (bfloat16 stays a CPU tensor, numpy
    cannot hold it); a :class:`Float0` gradient as zeros of the wire
    dtype; others at their own dtype.  ``torch.int8`` is the legacy
    per-tensor quantizer: each float leaf is fetched in float32 and
    quantized on the host, a :class:`Float0` ships float32 zeros."""
    legacy = dtype == torch.int8

    def conv(leaf):
        if isinstance(leaf, Float0):
            if legacy:
                return np.zeros(leaf.shape, np.float32)
            leaf = torch.zeros(leaf.shape, dtype=dtype)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        t = leaf.detach()
        if t.is_floating_point():
            if legacy:
                from split_learning_torch.runtime.codec.quant import (
                    quantize_per_tensor_np,
                )
                return quantize_per_tensor_np(t.float().cpu().numpy())
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
        if isinstance(leaf, SparseLeaf):
            from split_learning_torch.runtime.codec.sparse import (
                densify_leaf,
            )
            return densify_leaf(leaf, device)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        return host_tensor(np.ascontiguousarray(leaf)).to(device)
    return _map(conv, tree)


def _concat(trees: list):
    """One boundary tree of a window's batches, leaf by leaf along the
    batch axis (a window of one is its batch as it is)."""
    if len(trees) == 1:
        return trees[0]
    if isinstance(trees[0], tuple):
        return tuple(torch.cat(leaves) for leaves in zip(*trees))
    return torch.cat(trees)


def _rows(tree, off: int, n: int):
    """Rows ``off:off + n`` of a gradient tree (a :class:`Float0` leaf
    by its shape)."""
    def rows(leaf):
        if isinstance(leaf, Float0):
            return Float0((n, *leaf.shape[1:]))
        return leaf[off:off + n]
    if isinstance(tree, tuple):
        return tuple(rows(leaf) for leaf in tree)
    return rows(tree)


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
    recompute replays the forward's dropout masks.

    With ``lora_rank > 0`` each :meth:`load` draws fresh adapters from
    the runner's own generator (seeded from ``seed``, so each client has
    its own) over the shard's target kernels; the model's last layer
    trains too when this shard holds it, and every other parameter is
    frozen.  A shard with neither (``lora_noop``) trains all its
    parameters.  :meth:`state_tree` is then the merged weights.

    In async mode (``learning.mode: async``) the runner knows its
    auxiliary head's architecture (``aux``; the label space comes from
    the model key, so a token dataset raises here) and draws a head's
    weights from its own generator (:meth:`init_aux_head`)."""

    #: this round's LoRA adapters (None: the shard trains its parameters)
    lora: dict | None = None

    def __init__(self, model_key: str, start_layer: int, end_layer: int,
                 learning: dict | None, model_kwargs: dict, device,
                 seed: int = 0):
        self.learning_dict = dict(learning or {})
        self.learning = learning_from_dict(learning)
        self.start_layer = start_layer
        self.end_layer = end_layer
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model = build_model(model_key, start_layer, end_layer,
                                 device=device, generator=gen,
                                 **model_kwargs)
        self.model.train()
        self.optimizer = None
        self.lora_noop = False
        self._trainable: list = []
        self._lora_gen = torch.Generator(device=device).manual_seed(seed)
        self.aux = None
        if self.learning.mode == "async":
            from split_learning_torch.ops.auxiliary import (
                build_aux_head, num_classes_for,
            )
            self.aux = build_aux_head(self.learning.aux_head,
                                      num_classes_for(model_key),
                                      hidden=self.learning.aux_hidden)
            self._aux_gen = torch.Generator(device=device).manual_seed(
                seed + 1)

    @property
    def is_final_shard(self) -> bool:
        return (self.end_layer == -1
                or self.end_layer >= len(self.model.specs))

    def partition_params(self) -> list:
        """The tensors this round trains (the JAX package's
        ``partition_params``): every parameter without LoRA; with it,
        fresh adapters over the target kernels plus the model's last
        layer when this shard holds it."""
        self.lora, self.lora_noop = None, False
        lrn = self.learning
        if lrn.lora_rank <= 0:
            return list(self.model.parameters())
        head = ([self.model.specs[-1].name] if self.is_final_shard
                else [])
        frozen, trained = split_frozen(self.model.state_tree(), head)
        adapters = lora_init(self._lora_gen, frozen, self.model,
                             targets=lrn.lora_targets, rank=lrn.lora_rank)
        if not adapters and not trained:
            # no target kernel and no classifier in this shard: freezing
            # everything would train nothing
            self.lora_noop = True
            return list(self.model.parameters())
        self.lora = adapters
        return lora_trainable(self.model, adapters, list(trained))

    def load(self, params: dict, stats: dict | None = None) -> None:
        """Adopt a START shard (parameters and BatchNorm statistics) and
        a fresh optimizer (the reference rebuilds its optimizer every
        round) over this round's trainable tensors."""
        self.model.load_state_tree(params)
        self.model.load_stats_tree(stats or {})
        self._trainable = self.partition_params()
        self.optimizer = make_optimizer(self.learning, self._trainable)

    def relearn(self, learning: dict | None) -> None:
        """New learning settings (an lr decay) over the kept weights and
        trained tensors: a fresh optimizer, as the reference builds one
        at every START."""
        self.learning_dict = dict(learning or {})
        self.learning = learning_from_dict(learning)
        self.optimizer = make_optimizer(self.learning, self._trainable)

    def _apply(self, x):
        if self.lora is None:
            return self.model(x, train=True)
        lrn = self.learning
        return lora_forward(self.model, self.lora, lrn.lora_alpha,
                            lrn.lora_rank, x, train=True)

    def fwd(self, x):
        """Forward without a graph: the backward recomputes it.  Returns
        (output, the dropout generators' states for that recompute)."""
        rng = self.model.rng_state()
        with torch.no_grad():
            return self._apply(x), rng

    @staticmethod
    def _input_grads(xr):
        """The gradient tree of a boundary input: each float leaf's
        gradient (zeros where unused), :class:`Float0` for a bool or int
        leaf of a tuple; None for a plain integer input (stage 1's
        token ids: nothing upstream)."""
        def grad(t):
            if not t.is_floating_point():
                return Float0(t.shape)
            return t.grad if t.grad is not None else torch.zeros_like(t)
        if isinstance(xr, tuple):
            return tuple(grad(t) for t in xr)
        return grad(xr) if xr.is_floating_point() else None

    def bwd(self, x, ct, rng: list):
        """Recompute the forward with the masks of :meth:`fwd` (``rng``)
        and backpropagate the received cotangent (of the output's float
        leaves) into the trained tensors' ``.grad``; returns the input
        gradient tree."""
        now = self.model.rng_state()
        self.model.set_rng_state(rng)
        xr = cut_boundary(x)
        out = self._apply(xr)
        self.model.set_rng_state(now)
        cts = [c for o, c in zip(tree_leaves(out), tree_leaves(ct))
               if o.is_floating_point()]
        backward_boundary(out, cts)
        return self._input_grads(xr)

    def last_step(self, x, labels: torch.Tensor, input_grad: bool = True):
        """Last stage: float32 cross entropy, gradients into ``.grad``;
        returns (loss, input gradient tree, or None when
        ``input_grad`` is off: async mode returns nothing upstream)."""
        xr = cut_boundary(x) if input_grad else x
        logits = self._apply(xr)
        loss = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.reshape(-1).long())
        loss.backward()
        return loss.detach(), (self._input_grads(xr) if input_grad
                               else None)

    def boundary(self, x):
        """This shard's output on ``x`` without a graph, the dropout
        generators left as they were: the shape probe of an aux head."""
        rng = self.model.rng_state()
        with torch.no_grad():
            out = self._apply(x)
        self.model.set_rng_state(rng)
        return out

    def init_aux_head(self, boundary):
        """A fresh aux head for ``boundary`` from the runner's own
        generator (:func:`~split_learning_torch.ops.auxiliary.
        init_aux_params`)."""
        from split_learning_torch.ops.auxiliary import init_aux_params
        device = self._aux_gen.device
        return init_aux_params(self.aux, self._aux_gen, boundary,
                               device=device)

    def aux_step(self, x, labels: torch.Tensor, head):
        """Decoupled forward + the aux head's float32 cross entropy, the
        shard's and the head's gradients into ``.grad`` in one backward
        (no wire cotangent); returns (loss, the boundary output,
        detached: it still streams downstream)."""
        out = self._apply(x)
        logits = head(out)
        loss = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.reshape(-1).long())
        loss.backward()
        return loss.detach(), _map(lambda t: t.detach(), out)

    def apply_update(self) -> None:
        """The optimizer step on the batch's gradients, and the batch's
        BatchNorm statistics kept."""
        self.model.commit_stats()
        if self.learning.clip_grad_norm:
            clip_by_global_norm(self._trainable,
                                self.learning.clip_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def state_tree(self) -> dict:
        """The shard's parameters; with LoRA the merged weights (peft's
        ``merge_and_unload``)."""
        tree = self.model.state_tree()
        if self.lora is None:
            return tree
        lrn = self.learning
        with torch.no_grad():
            return lora_merge(tree, self.lora, lrn.lora_alpha,
                              lrn.lora_rank)

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
        if cfg.learning.sync_overlap:
            raise NotImplementedError(
                "learning.sync-overlap is not ported yet; it comes with "
                "a later slice")
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
        from split_learning_torch.runtime.trace import (
            HistogramSet, default_fault_counters, default_wire_counters,
        )
        self.faults = default_fault_counters
        self._fault_base: dict | None = None
        # round tracing: the stack's tracer, wire counters and
        # histograms when make_runtime_transport built them, else this
        # client's own (the wire counters the process-wide ones)
        self.wire = getattr(self.bus, "wire", None) \
            or default_wire_counters
        self.tracer = getattr(self.bus, "tracer", None) \
            or make_tracer(cfg, client_id)
        self.hists = getattr(self.bus, "hists", None) or HistogramSet()
        self._wire_base: dict | None = None
        self._hist_base: dict | None = None
        self.round_idx: int | None = None   # the START's round
        # chunked-frame reassembly is per consumer thread; the client is
        # single-threaded over its queues
        self._assembler = FrameAssembler()
        self._chunk_bytes = cfg.transport.chunk_mb << 20
        self.log = logger or Logger.for_run(cfg, client_id, console=False)
        # the live telemetry plane: gauges and the heartbeat thread
        # (started at the first START); its snapshot reads num_samples,
        # a host int counted where each batch's update is applied
        self.gauges = GaugeSet()
        #: (frames, bytes) of the heartbeats this client has published
        self.heartbeats = (0, 0)
        self.telemetry = TelemetryEmitter(
            client_id, self._send_heartbeat,
            interval=cfg.observability.heartbeat_interval,
            faults=self.faults, wire=self.wire, hists=self.hists,
            gauges=self.gauges, samples_fn=lambda: self.num_samples,
            stage=stage)
        self.wire_dtype = wire_torch_dtype(cfg.transport.wire_dtype)
        # per-queue-family wire codecs (transport.codec); families
        # without a policy take the plain wire-dtype path
        self.codecs = make_codecs(cfg, faults=self.faults)
        #: dense-equivalent bytes of every codec'd payload, per queue —
        #: the denominator of the wire compression ratio
        self.raw_bytes_out: dict[str, int] = {}
        self.runner: ShardRunner | None = None
        self.loader = None
        self._loader_counts: list | None = None
        self.epochs = 1
        self.fence = 0
        # the data plane, from START (SDA overrides from SYN): the SDA
        # window, strict SDA's fence quorum and feeder set, the 2LS pair
        # queue, the DCSL scatter peers
        self.sda_size = 1
        self.sda_strict = False
        self.sda_fence_quorum = 1
        self.sda_feeders: list | None = None
        self.pair = None
        self.sda_peers: list | None = None
        self.n_stages = cfg.num_stages
        self.round_ok = True
        self.num_samples = 0
        # device-resident NaN sentinel: the last stage folds
        # isfinite(loss) into it without a host sync; _send_update reads
        # it once per round
        self._ok_dev = None
        # delta codec state: (version, base tree) of the last weighted
        # START, and the shadow version the server advertised; a delta
        # goes out only when the two agree (else the full frame)
        self._delta_base = None
        self._delta_advert = None
        self._agg_group = None   # aggregator-tree group (aggregation.fan-in)
        # async mode: the client-local aux head, its optimizer, the
        # boundary shape signature that resets them, and the key
        # (layers, batch shapes) the signature was taken at
        self.aux_head = None
        self.aux_optimizer = None
        self._aux_sig = None
        self._aux_key = None
        self._aux_learning = None
        # samples of overlap ticks between this round's UPDATE and the
        # next START (credited to the next UPDATE), and control frames
        # an overlap loop popped for run() to handle in order
        self._overlap_samples = 0
        self._pending_ctrl: list = []
        if cfg.checkpoint.load:
            self._load_ef_state()

    # -- control plane -----------------------------------------------------

    def _decode(self, raw: bytes, queue: str | None = None):
        """Tolerant decode: a frame that fails a checksum (or any guard
        inside decode) is dropped and counted, never fatal.  Returns None
        for dropped frames and for a chunk of a still-partial message.

        A decoded message that carries a wire trace context becomes a
        *consume* span parented to the sender's publish span (the
        cross-participant edge), and its send time feeds ``frame_rtt``."""
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            msg = self._assembler.feed(raw)
        except Exception as e:  # noqa: BLE001 — see docstring
            self.faults.inc("corrupt_rejected")
            self.log.warning(f"dropping undecodable frame on {queue}: {e}")
            self.wire.add_decode(time.perf_counter() - t0)
            return None
        dt = time.perf_counter() - t0
        self.wire.add_decode(dt)
        self.hists.observe("decode", dt)
        if msg is not None:
            ctx = unpack_ctx(getattr(msg, "_ctx", None))
            if ctx is not None:
                _, sender_span, t_send = ctx
                rtt = max(0.0, t_wall - t_send)
                self.hists.observe("frame_rtt", rtt)
                self.tracer.record(
                    "consume", t_wall, t_wall + dt, parent=sender_span,
                    queue=queue, kind=type(msg).__name__,
                    nbytes=len(raw), rtt_ms=round(rtt * 1e3, 3),
                    round=getattr(msg, "round_idx", None))
        return msg

    def _publish_parts(self, queue: str, build,
                       kind: str | None = None) -> None:
        """Data-plane publish: ``build(ctx)`` produces the frame part
        list carrying the wire trace context ``ctx``.  On a deferred bus
        the thunk is enqueued and runs on the sender thread, so batch k's
        codec, fetch and encode overlap batch k+1's compute; on a plain
        bus it runs inline.  The *publish* span opens here (its queue
        time included) and closes when the frame's bytes exist; its id
        rides ``ctx`` to the receiver's consume span.

        The thunk holds a reference to every tensor it reads, so the
        caching allocator cannot hand that memory on, and those tensors
        are fresh outputs (a forward's result, an input gradient) that
        the training thread never writes again.  On the card it runs on
        the stream that was current here at publish time, so its
        kernels and its copy are ordered after the ones that produced
        its inputs."""
        span = self.tracer.start("publish", always=False, queue=queue,
                                 kind=kind, round=self.round_idx)
        ctx = self.tracer.wire_context(span)
        if not getattr(self.bus, "deferred", False):
            t0 = time.perf_counter()
            parts = build(ctx)
            dt = time.perf_counter() - t0
            self.wire.add_encode(dt)
            self.hists.observe("encode", dt)
            span.end(nbytes=sum(len(p) for p in parts))
            for part in parts:
                self.bus.publish(queue, part)
                self.wire.count_out(queue, len(part))
            return
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def thunk():
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                parts = build(ctx)
            span.end(nbytes=sum(len(p) for p in parts))
            return parts
        self.bus.publish(queue, thunk)

    # -- wire codec plumbing -----------------------------------------------

    def _count_raw(self, tree, family: str, queue: str) -> None:
        """Counts the pre-codec dense-equivalent bytes of a codec'd
        payload (on the training thread), so the compression ratio is
        measured."""
        if family in self.codecs:
            n = wire_raw_nbytes(tree, self.wire_dtype)
            self.raw_bytes_out[queue] = self.raw_bytes_out.get(queue, 0) + n
            self.wire.count_raw(queue, n)

    def _wire_payload(self, tree, family: str, queue: str):
        """Device tree -> wire payload tree: codec ``prepare`` (the
        quantize kernel) then ``encode`` (the fetch) when a policy
        covers ``family``, else the plain device cast and host fetch.
        Runs inside the publish thunk."""
        c = self.codecs.get(family)
        if c is None:
            return _to_wire_tree(tree, self.wire_dtype)
        return c.encode(c.prepare(tree, key=queue))

    def _encode_update_wire(self, params_h):
        """(wire params tree, delta base version) of this round's
        UPDATE: a quantized delta against the START's weights when the
        version chain is intact, else the full float32 frame (the resync
        path: a restarted client, a moved shadow, no rpc codec)."""
        rpc = self.codecs.get("rpc")
        if rpc is None or params_h is None:
            return params_h, None
        base = self._delta_base
        if (base is None or self._delta_advert is None
                or base[0] != self._delta_advert):
            return params_h, None   # the server counts the full frame
        ver, base_tree = base
        n = wire_raw_nbytes(params_h, torch.float32)
        self.raw_bytes_out[RPC_QUEUE] = self.raw_bytes_out.get(RPC_QUEUE, 0) + n
        self.wire.count_raw(RPC_QUEUE, n)
        return rpc.encode_update(params_h, base_tree), ver

    def _ef_stateful_codecs(self):
        for family in ("gradient", "rpc"):
            c = self.codecs.get(family)
            if c is not None and hasattr(c, "state_dict"):
                yield family, c

    def _save_ef_state(self) -> None:
        """Each stateful codec's error-feedback residuals, as a sidecar
        beside the checkpoint, so that a restarted client resumes with
        its unsent mass instead of dropping it."""
        from split_learning_torch.runtime.checkpoint import save_sidecar
        for family, c in self._ef_stateful_codecs():
            state = c.state_dict()
            if state:
                save_sidecar(self.cfg.checkpoint.directory,
                             f"ef_{self.client_id}_{family}", state)

    def _load_ef_state(self) -> None:
        from split_learning_torch.runtime.checkpoint import load_sidecar
        for family, c in self._ef_stateful_codecs():
            state = load_sidecar(self.cfg.checkpoint.directory,
                                 f"ef_{self.client_id}_{family}")
            if state:
                c.load_state_dict(state)

    def register(self):
        self.bus.publish(RPC_QUEUE, encode(Register(
            client_id=self.client_id, stage=self.stage,
            cluster=self.cluster, profile=self.profile)))
        self.log.info(f"[>>>] REGISTER stage={self.stage}")

    def _send_heartbeat(self, snapshot: dict) -> None:
        """One HEARTBEAT on the rpc queue (from the emitter's thread; not
        logged: a frame an interval would drown the protocol trace).
        :attr:`heartbeats` counts the frames and bytes sent."""
        raw = encode(Heartbeat(client_id=self.client_id,
                               round_idx=self.round_idx or 0,
                               telemetry=snapshot))
        self.bus.publish(RPC_QUEUE, raw)
        frames, nbytes = self.heartbeats
        self.heartbeats = (frames + 1, nbytes + len(raw))

    def run(self):
        """Blocking lifecycle loop; returns on STOP.  However it ends
        (STOP, a closed bus, a scripted crash), the heartbeat thread
        stops, a transport stack the client built itself is closed,
        every layer of it, and the span journal is flushed and closed."""
        try:
            self._run()
        finally:
            self.telemetry.stop()
            if self._own_bus:
                self.bus.close()
            self.tracer.close()

    def _run(self):
        """Until the first START arrives, REGISTER is re-sent every few
        seconds: a client that comes up before the server would
        otherwise lose its registration to the server's startup purge."""
        self.register()
        q = reply_queue(self.client_id)
        started = False
        while True:
            try:
                # control frames an overlap loop already popped come
                # first, in the order they arrived
                raw = (self._pending_ctrl.pop(0) if self._pending_ctrl
                       else self.bus.get(q, timeout=None if started
                                         else 3.0))
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
                # heartbeats begin at the first START (idempotent), so the
                # server hears this client through the shard build
                self.telemetry.start()
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
        # join the server's run-scoped trace: every span this client
        # journals and every wire context it sends carries its id
        if extra.get("trace_id"):
            self.tracer.adopt_trace_id(extra["trace_id"])
        self.round_idx = msg.round_idx
        self.epochs = int(extra.get("epochs", 1))
        # server-assigned per-invocation generation: stamps every message
        # this client sends so strays from an abandoned invocation drop
        self.fence = int(extra.get("gen", msg.round_idx))
        self.n_stages = int(extra.get("n_stages", self.cfg.num_stages))
        self.sda_size = int(extra.get("sda_size", 1))
        self.sda_strict = bool(extra.get("sda_strict", False))
        self.sda_fence_quorum = int(extra.get("sda_fence_quorum", 1))
        self.sda_feeders = extra.get("sda_feeders")
        self.pair = extra.get("pair")
        self.sda_peers = extra.get("sda_peers")
        # the delta codec's version chain: the shadow version the server
        # holds for this client
        self._delta_advert = extra.get("delta_base_version")
        # aggregator tree: the round UPDATE goes to this group's
        # aggregate queue instead of rpc_queue (None: straight to the
        # root; re-read every START).  Tree rounds advertise no delta
        # base, so the full frame follows
        self._agg_group = extra.get("agg_group")
        if msg.params is None:
            self._hold(msg)
            return
        if self.codecs.get("rpc") is not None \
                and self._delta_advert is not None:
            # the base is the shard exactly as received: the server's
            # shadow holds the same float32 bytes
            self._delta_base = (self._delta_advert, msg.params)
        if self._overlap_samples:
            # overlap ticks trained the previous seed's shard, which this
            # START replaces: that work never reaches the fold, so its
            # samples are not credited (the aux head keeps its progress)
            self.log.info(f"overlap: {self._overlap_samples} old-seed "
                          "samples uncounted (shard re-seeded)")
            self._overlap_samples = 0
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
        if self.runner.lora_noop:
            self.log.warning(
                "lora_rank set but no target kernels in this shard; "
                "training full shard parameters instead")
        self._build_loader(msg)

    def _hold(self, msg: Start) -> None:
        """A START without weights (FLEX's hold round,
        ``other/FLEX/src/Server.py:220-226``): the shard, its optimizer
        state and the loader's position stay.  New learning settings
        give a fresh optimizer over the kept weights
        (:meth:`ShardRunner.relearn`), as does a hold after an UPDATE
        that carried the weights (which freed the moments); the loader
        is rebuilt when ``distribution.refresh`` re-samples every round
        or the START's label counts moved."""
        r = self.runner
        if r is None or (r.start_layer, r.end_layer) != (
                msg.start_layer, msg.end_layer):
            raise RuntimeError(
                "START without params but no matching local shard "
                f"(layers [{msg.start_layer}, {msg.end_layer}])")
        changed = r.learning_dict != dict(msg.learning or {})
        if changed or r.optimizer is None:
            r.relearn(msg.learning)
            if changed:
                self._reset_aux()   # as the JAX package rebuilds it
            self.log.info("fresh optimizer over the kept weights")
        else:
            self.log.info("keeping local shard weights (no re-seed)")
        # the delta base survives a hold only while it still matches the
        # server's shadow; a drifted advertisement means a full frame
        if (self._delta_base is not None
                and self._delta_base[0] != self._delta_advert):
            self._delta_base = None
        if (self.stage == 1 and msg.label_counts is not None
                and ((msg.extra or {}).get("refresh")
                     or [int(c) for c in msg.label_counts]
                     != self._loader_counts)):
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
            # a hold START rebuilds the loader when its counts move
            self._loader_counts = [int(c) for c in msg.label_counts]

    def _on_syn(self, msg: Syn):
        self.log.info(f"[<<<] SYN round={msg.round_idx}")
        # the server's responsive-set overrides: a previous-stage client
        # dropped at the READY barrier must not leave this one waiting
        # for fence copies or fences that never come
        if msg.sda_fence_quorum is not None:
            self.sda_fence_quorum = int(msg.sda_fence_quorum)
        if msg.sda_feeders is not None:
            self.sda_feeders = list(msg.sda_feeders)
        self.round_ok = True
        self._ok_dev = torch.ones((), dtype=torch.bool, device=self.device)
        # overlap-tick samples survive only a hold START (the kept shard
        # is what this round's UPDATE uploads); a re-seed zeroed them
        self.num_samples, self._overlap_samples = self._overlap_samples, 0
        self.gauges.set("round", msg.round_idx)
        # the round's root span on this participant: hot-loop and
        # publish spans parent under it
        with self.tracer.span("client_round", round=msg.round_idx,
                              stage=self.stage):
            if self._async_mode:
                pause = (self._train_first_async() if self.stage == 1
                         else self._train_last_async()
                         if self.stage == self.n_stages
                         else self._train_middle_async())
            elif self.stage == 1:
                pause = self._train_first()
            elif self.stage == self.n_stages:
                pause = self._train_last()
            else:
                pause = self._train_middle()
            if isinstance(pause, _AbortPause):
                self.tracer.flush()
                return   # round abandoned: the server stopped counting us
            self._send_update(with_weights=pause.send_weights)
        # pipelined async rounds: keep ticking while the server folds,
        # validates and fans the next START out
        self._overlap_ticks()
        # a finished round's spans are durable even if the process dies
        # while idle between rounds
        self.tracer.flush()

    def _send_update(self, with_weights: bool):
        # the round's ONE host sync of the NaN sentinel
        if self._ok_dev is not None and not bool(self._ok_dev):
            self.round_ok = False
        params_h = stats_h = delta_base = None
        if with_weights:
            params_h, stats_h = (
                {layer: {k: t.detach().cpu().numpy()
                         for k, t in sd.items()}
                 for layer, sd in tree.items()}
                for tree in (self.runner.state_tree(),
                             self.runner.stats_tree()))
            # rpc codec: ``trained - base`` against the START's version
            # when the chain is intact, the full float32 frame otherwise
            params_h, delta_base = self._encode_update_wire(params_h)
        # TENSOR-framed and chunked: a shard UPDATE is the biggest frame
        # a client publishes.  The weights were fetched above, on this
        # thread: the next START loads into the same parameters in place.
        # It carries one telemetry snapshot, heartbeats on or off
        msg = Update(
            client_id=self.client_id, stage=self.stage,
            cluster=self.cluster, params=params_h, batch_stats=stats_h,
            num_samples=self.num_samples, ok=self.round_ok,
            round_idx=self.fence, delta_base=delta_base,
            # the generation these weights were seeded from: the
            # server's staleness window reads it
            version=self.fence,
            telemetry=self.telemetry.snapshot().as_dict())
        dest = (RPC_QUEUE if self._agg_group is None
                else aggregate_queue(self.cluster, self._agg_group))
        self._publish_parts(
            dest, lambda ctx: encode_parts(msg, self._chunk_bytes, ctx=ctx),
            kind="Update")
        if self.cfg.checkpoint.save and self.codecs:
            # error-feedback residuals are durable client state
            self._save_ef_state()
        if with_weights and not self._async_mode:
            # the server folds the weights and the next START re-seeds
            # the shard with a fresh optimizer: free the moments now,
            # while the server folds, rather than holding them on the
            # card.  Without weights the shard is held, moments and all;
            # an async shard keeps training between rounds (overlap
            # ticks) and keeps them too
            self.runner.optimizer = None
        self.log.info(f"[>>>] UPDATE samples={self.num_samples} "
                      f"ok={self.round_ok}"
                      + ("" if with_weights else " (no weights)"))
        # the fault counters live per process: each client surfaces its
        # own, cumulative, once a round they changed
        snap = {k: v for k, v in self.faults.snapshot().items() if v}
        if snap and snap != self._fault_base:
            self._fault_base = snap
            self.log.info("round faults (cumulative): " + " ".join(
                f"{k}={v}" for k, v in sorted(snap.items())))
            self.log.metric(kind="faults", client=self.client_id,
                            round_idx=self.fence, **snap)
        # the wire counters and the latency percentiles follow the same
        # contract: cumulative, written when they changed
        wsnap = {k: v for k, v in self.wire.snapshot().items() if v}
        if wsnap and wsnap != self._wire_base:
            self._wire_base = wsnap
            self.log.metric(kind="wire_client", client=self.client_id,
                            round_idx=self.round_idx, **wsnap)
        hsnap = self.hists.snapshot()
        if hsnap and hsnap != self._hist_base:
            self._hist_base = hsnap
            self.log.metric(kind="latency", client=self.client_id,
                            round_idx=self.round_idx, **hsnap)

    def _redeliver(self, msg) -> Pause:
        """A STOP or a fresh START arriving mid-training: requeue it for
        the run() loop and unwind the hot loop without uploading (the
        server is shutting down, or timed this client out of the round
        and moved on).  In async mode a START instead uploads the
        round's work first: the UPDATE carries the old seed's version,
        and the server's bounded-staleness window folds it at a decayed
        weight."""
        self.bus.publish(reply_queue(self.client_id), encode(msg))
        if isinstance(msg, Start):
            if self._async_mode:
                self.log.info("START mid-round (async): uploading a late "
                              "update, swapping seeds at the tick")
                return Pause(send_weights=True)
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
        sp = self.tracer.start("bwd", always=False, round=self.round_idx)
        t_sp = time.perf_counter()
        gx = self.runner.bwd(ent.x, _from_wire_tree(g.data, self.device),
                             ent.rng)
        self.runner.apply_update()
        sp.end()
        self.hists.observe("step", time.perf_counter() - t_sp)
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
        self._publish_parts(q, lambda ctx: encode_parts(Gradient(
            data_id=data_id, data=self._wire_payload(gx, "gradient", q),
            trace=trace, round_idx=fence), self._chunk_bytes, ctx=ctx),
            kind="Gradient")

    def _send_activation(self, out, q: str, data_id: str, labels,
                         trace: list) -> None:
        self._count_raw(out, "intermediate", q)
        cluster, fence = self.cluster, self.fence
        self._publish_parts(q, lambda ctx: encode_parts(Activation(
            data_id=data_id, data=self._wire_payload(out, "intermediate", q),
            labels=labels, trace=trace, cluster=cluster, round_idx=fence),
            self._chunk_bytes, ctx=ctx), kind="Activation")

    def _train_first(self) -> Pause:
        """Bounded-in-flight 1F1B streaming (``src/train/VGG16.py:61-136``)
        over :meth:`_out_queues`; under strict SDA each epoch's last
        batch is followed by an :class:`EpochEnd` fence down every
        out-queue."""
        r = self.runner
        inflight: dict[str, _Inflight] = {}
        grad_q = gradient_queue(self.stage, self.client_id)
        out_qs = self._out_queues()
        cap = max(1, r.learning.control_count)
        n_fwd = n_bwd = 0

        def fence_epoch(ep: int) -> None:
            # right after the epoch's last activation (per-queue FIFO
            # orders it last) and before this client's gradient wait:
            # the strict head drains the leftovers whose gradients that
            # wait needs only behind the fence
            if self.sda_strict and self.sda_size > 1:
                for q in out_qs:
                    self.bus.publish(q, encode(EpochEnd(
                        client_id=self.client_id, round_idx=self.fence,
                        epoch=ep)))

        for ep in range(self.epochs):
            self.gauges.set("epoch", ep)
            data_iter = iter(self.loader)
            # prefetch one batch: exhaustion must be known at the LAST
            # dispatch, not when the in-flight cap next frees (a strict
            # head holds this feeder's batches until the fence)
            next_item = next(data_iter, None)
            exhausted = next_item is None
            if exhausted:
                fence_epoch(ep)
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
                    self.gauges.set("inflight", len(inflight))
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
                sp = self.tracer.start("fwd", always=False,
                                       round=self.round_idx, spliced=False)
                out, rng = r.fwd(x)
                sp.end()
                inflight[data_id] = _Inflight(x=x, trace=[self.client_id],
                                              n=len(labels), rng=rng)
                self.gauges.set("inflight", len(inflight))
                self._send_activation(out, out_qs[n_fwd % len(out_qs)],
                                      data_id,
                                      np.asarray(labels, np.int32),
                                      [self.client_id])
                n_fwd += 1
                if next_item is None:
                    exhausted = True
                    fence_epoch(ep)
        self.bus.publish(RPC_QUEUE, encode(Notify(
            client_id=self.client_id, cluster=self.cluster,
            round_idx=self.fence)))
        self.log.info(f"[>>>] NOTIFY fwd={n_fwd} bwd={n_bwd}")
        return self._wait_pause()

    def _out_queues(self) -> list[str]:
        """Forward queues: the next stage's per-device queues when
        ``sda_peers`` is set (DCSL's round-robin scatter,
        ``other/DCSL/src/Scheduler.py:21-26, :110-133``), the rotation's
        start staggered by a stable hash of this client's id so that
        feeders do not convoy onto one head; else the one shared (or
        2LS pair) queue."""
        if self.sda_peers:
            qs = [intermediate_queue(self.stage, self.cluster, p)
                  for p in self.sda_peers]
            off = zlib.crc32(self.client_id.encode()) % len(qs)
            return qs[off:] + qs[:off]
        return [intermediate_queue(self.stage, self.cluster, self.pair)]

    def _train_middle(self) -> Pause:
        """Trace-routed relay.  A strict-SDA fence goes on down every
        out-queue once, when its quorum of copies (one from each
        previous-stage client) has arrived: this loop forwards on
        receipt, so every activation it fences has gone ahead of it."""
        r = self.runner
        in_q = intermediate_queue(self.stage - 1, self.cluster, self.pair)
        out_qs = self._out_queues()
        grad_q = gradient_queue(self.stage, self.client_id)
        inflight: dict[str, _Inflight] = {}
        fence_copies: dict[tuple[str, int], int] = {}
        quorum = max(1, self.sda_fence_quorum)
        n_fwd = 0
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
            if act is None or act.round_idx != self.fence:
                continue   # corrupt, or from a dropped round
            if isinstance(act, EpochEnd):
                key = (act.client_id, act.epoch)
                fence_copies[key] = fence_copies.get(key, 0) + 1
                if fence_copies[key] == quorum:
                    for q in out_qs:
                        self.bus.publish(q, raw)
                continue
            x = _from_wire_tree(act.data, self.device)
            sp = self.tracer.start("fwd", always=False, round=self.round_idx)
            out, rng = r.fwd(x)
            sp.end()
            inflight[act.data_id] = _Inflight(x=x, trace=list(act.trace),
                                              n=len(act.labels), rng=rng)
            self.gauges.set("queue_depth", len(inflight))
            self._send_activation(out, out_qs[n_fwd % len(out_qs)],
                                  act.data_id, act.labels,
                                  list(act.trace) + [self.client_id])
            n_fwd += 1

    def _train_last(self) -> Pause:
        """Loss + backward + routed input-gradient return
        (``src/train/VGG16.py:138-191``), a window of batches a step
        (:meth:`_sda_step`; DCSL's SDA, ``other/DCSL/src/Scheduler.py:
        152-191``): one batch from each of ``sda_size`` distinct origins
        (the stage-1 feeders, ``trace[0]``), a second batch of an origin
        waiting for the next window.  Each arriving frame is decoded to
        the device at once.

        * Elastic (the default): an idle spell of 0.25 s flushes a
          partial window and lowers the width to what is alive; it rises
          again as more origins send.
        * Strict (``aggregation.sda-strict``): a hard ``sda_size``
          barrier, popped in sorted origin order; leftovers drain only
          when a full window can never form again, i.e. fewer than
          ``sda_size`` origins have batches buffered or epochs unfenced
          (a fence counts once its ``sda_fence_quorum`` of copies is in)
          — or at PAUSE."""
        in_q = intermediate_queue(self.stage - 1, self.cluster, self.pair)
        pending: dict[str, list[Activation]] = {}
        idle_flush_s = 0.25
        idle_since: float | None = None
        strict = self.sda_strict
        width = max(1, self.sda_size)
        target = width
        n_epochs = max(1, self.epochs)
        # per-origin fenced epochs: an origin is out of the game once it
        # has fenced every epoch of the round
        fences: dict[str, int] = {}
        self._sda_fences = fences
        fence_copies: dict[tuple[str, int], int] = {}
        quorum = max(1, self.sda_fence_quorum)

        def live() -> list[str]:
            return [o for o, q in pending.items() if q]

        def pop_window(require_full: bool) -> list[Activation] | None:
            # sorted, not arrival order: the concatenation order must not
            # depend on thread timing
            origins = sorted(live())
            if not origins or (require_full and len(origins) < target):
                return None
            return [pending[o].pop(0) for o in origins[:width]]

        def drain(require_full: bool) -> None:
            while (w := pop_window(require_full)):
                self._sda_step(w)

        def drain_dead_barrier() -> None:
            feeders = set(self.sda_feeders or ()) or set(pending)
            while True:
                possible = ({o for o in feeders
                             if fences.get(o, 0) < n_epochs}
                            | set(live()))
                if len(possible) >= target:
                    return
                w = pop_window(require_full=False)
                if not w:
                    return
                self._sda_step(w)

        while True:
            pause = self._check_pause()
            if pause is not None:
                drain(require_full=False)   # everything buffered first
                self.log.info("[<<<] PAUSE")
                return pause
            raw = self.bus.get(in_q, timeout=0.001)
            if raw is None:
                if strict:
                    continue   # hard barrier: wait for traffic or a fence
                now = time.monotonic()
                idle_since = idle_since if idle_since is not None else now
                if now - idle_since >= idle_flush_s:
                    w = pop_window(require_full=False)
                    if w:
                        target = len(w)
                        self._sda_step(w)
                continue
            act = self._decode(raw, in_q)
            if act is None or act.round_idx != self.fence:
                continue   # corrupt, or from a dropped round
            if isinstance(act, EpochEnd):
                key = (act.client_id, act.epoch)
                fence_copies[key] = fence_copies.get(key, 0) + 1
                if fence_copies[key] == quorum:
                    fences[act.client_id] = fences.get(act.client_id, 0) + 1
                if strict:
                    drain(require_full=True)
                    drain_dead_barrier()
                continue
            idle_since = None   # current-round traffic only
            act.data = _from_wire_tree(act.data, self.device)
            pending.setdefault(act.trace[0], []).append(act)
            self.gauges.set("queue_depth",
                            sum(len(q) for q in pending.values()))
            n_live = len(live())
            if n_live > target:
                target = min(width, n_live)
            w = pop_window(require_full=True)
            if w:
                self._sda_step(w)
            elif strict:
                # a batch buffered behind a barrier that is already dead
                # must not wait for a fence that has come and gone
                drain_dead_barrier()

    def _sda_step(self, window: list[Activation]) -> None:
        """One loss + backward + optimizer step on a window's batches
        concatenated in window order; the input gradient is split back
        per origin batch, and each part is sent (through the codec on
        its own) to that batch's previous hop."""
        r = self.runner
        sizes = [len(a.labels) for a in window]
        sp = self.tracer.start("sda_step", always=False,
                               round=self.round_idx, window=len(window))
        t_sp = time.perf_counter()
        x = _concat([a.data for a in window])
        labels = torch.from_numpy(np.concatenate(
            [np.asarray(a.labels, np.int32) for a in window])).to(
            self.device)
        loss, gx = r.last_step(x, labels)
        # NaN sentinel (src/train/VGG16.py:169), folded on the device and
        # synced once per round in _send_update
        self._ok_dev = self._ok_dev & torch.isfinite(loss)
        r.apply_update()
        sp.end()
        self.hists.observe("step", time.perf_counter() - t_sp)
        self.num_samples += sum(sizes)
        off = 0
        for act, n in zip(window, sizes):
            part = gx if len(window) == 1 else _rows(gx, off, n)
            off += n
            self._send_gradient(part, act.data_id, act.trace)

    # -- async decoupled mode (learning.mode: async) -------------------------

    @property
    def _async_mode(self) -> bool:
        r = self.runner
        return r is not None and r.learning.mode == "async"

    def _reset_aux(self) -> None:
        self.aux_head = None
        self.aux_optimizer = None
        self._aux_sig = None
        self._aux_key = None
        self._aux_learning = None

    def _ensure_aux(self, x) -> None:
        """Shape (or re-shape) the aux head for the current boundary.

        The boundary comes from one forward of this shard on the live
        batch, taken again only when the shard's layers or the batch's
        shapes moved.  A changed shape signature means a re-plan moved
        the cut: the head AND its optimizer state reset; an unchanged
        one keeps both, so the local probe keeps converging across
        rounds.  The head's optimizer is the shard's kind with its own
        state, and follows the shard's learning settings."""
        from split_learning_torch.ops.auxiliary import aux_shapes_signature
        r = self.runner
        key = (r.start_layer, r.end_layer,
               tuple(tuple(t.shape) for t in (
                   x if isinstance(x, tuple) else (x,))))
        if self.aux_head is None or key != self._aux_key:
            boundary = r.boundary(x)
            sig = aux_shapes_signature(boundary)
            if sig != self._aux_sig:
                if self._aux_sig is not None:
                    self.log.info("aux head re-shaped (re-plan moved the "
                                  "cut): optimizer state reset")
                self.aux_head = r.init_aux_head(boundary)
                self.aux_optimizer = None
                self._aux_sig = sig
            self._aux_key = key
        if self.aux_optimizer is None \
                or self._aux_learning != r.learning_dict:
            # new learning settings (an lr decay) reach the head's
            # optimizer as they reach the shard's; its state is kept
            # while the optimizer's kind is
            opt = make_optimizer(r.learning, self.aux_head.parameters())
            if type(opt) is type(self.aux_optimizer):
                opt.state = self.aux_optimizer.state
            self.aux_optimizer = opt
            self._aux_learning = r.learning_dict

    def _aux_tick(self, x, labels: torch.Tensor, n: int):
        """One decoupled tick: forward + aux loss, then the shard's and
        the head's steps.  Returns the boundary output."""
        r = self.runner
        self._ensure_aux(x)
        sp = self.tracer.start("aux_step", always=False, round=self.round_idx)
        t_sp = time.perf_counter()
        loss, out = r.aux_step(x, labels, self.aux_head)
        self._ok_dev = self._ok_dev & torch.isfinite(loss)
        r.apply_update()
        params = list(self.aux_head.parameters())
        if r.learning.clip_grad_norm:
            clip_by_global_norm(params, r.learning.clip_grad_norm)
        self.aux_optimizer.step()
        self.aux_optimizer.zero_grad(set_to_none=True)
        sp.end()
        self.hists.observe("step", time.perf_counter() - t_sp)
        self.num_samples += n
        return out

    def _overlap_ticks(self) -> None:
        """Pipelined rounds: after the round's UPDATE leaves, a stage-1
        async client keeps ticking on its current weights (aux steps,
        nothing published) while the server folds, validates and fans
        the next START out.  At most one pass over the loader; any
        control frame ends it and is handed back to run() in arrival
        order.  The samples are banked for the next round's UPDATE
        (kept only across a hold START)."""
        if (not self._async_mode or self.stage != 1
                or self.loader is None or self.aux_head is None):
            return
        q = reply_queue(self.client_id)
        ticked = 0
        for x, labels in self.loader:
            try:
                raw = self.bus.get(q, timeout=0.0005)
            except (QueueClosed, ConnectionError, OSError):
                return   # transport gone between rounds: run() exits
            if raw is not None:
                self._pending_ctrl.append(raw)
                break
            self._aux_tick(torch.from_numpy(np.asarray(x)).to(self.device),
                           torch.from_numpy(np.asarray(labels, np.int32))
                           .to(self.device), len(labels))
            # _aux_tick counted them into this round's (sent) UPDATE:
            # move the credit to the next round
            self.num_samples -= len(labels)
            self._overlap_samples += len(labels)
            ticked += 1
        if ticked:
            self.log.info(f"async overlap: {ticked} local ticks "
                          f"({self._overlap_samples} samples banked for "
                          "the next round)")

    def _train_first_async(self) -> Pause:
        """Stage-1 decoupled loop: a local aux step per batch, the
        activations streamed downstream, no gradient wait (the gradient
        queue and its codec stay dormant).  Each epoch ends with an
        :class:`EpochEnd` fence down every out-queue, so a PAUSEd
        consumer's drain ends as soon as every feeder's last fence
        lands."""
        out_qs = self._out_queues()
        n_fwd = 0
        for ep in range(self.epochs):
            self.gauges.set("epoch", ep)
            data_iter = iter(self.loader)
            while True:
                pause = self._check_pause()
                if pause is not None:
                    return pause
                item = next(data_iter, None)
                if item is None:
                    break
                x, labels = item
                labels = np.asarray(labels, np.int32)
                out = self._aux_tick(
                    torch.from_numpy(np.asarray(x)).to(self.device),
                    torch.from_numpy(labels).to(self.device), len(labels))
                self._send_activation(out, out_qs[n_fwd % len(out_qs)],
                                      uuid.uuid4().hex, labels,
                                      [self.client_id])
                n_fwd += 1
            for q in out_qs:
                self.bus.publish(q, encode(EpochEnd(
                    client_id=self.client_id, round_idx=self.fence,
                    epoch=ep)))
        self.bus.publish(RPC_QUEUE, encode(Notify(
            client_id=self.client_id, cluster=self.cluster,
            round_idx=self.fence)))
        self.log.info(f"[>>>] NOTIFY fwd={n_fwd} (async)")
        return self._wait_pause()

    def _drained(self, fenced: set, last_rx: float) -> bool:
        """The PAUSE drain's exit test: every origin feeder's last epoch
        fence arrived (per-queue FIFO: nothing it covers is still
        upstream), or the in-queue was idle past the grace."""
        feeders = set(self.sda_feeders or ())
        if feeders and feeders <= fenced:
            return True
        return time.monotonic() - last_rx > ASYNC_DRAIN_IDLE_S

    def _async_consume(self, step) -> Pause:
        """A later stage's decoupled loop: ``step(act, raw)`` on every
        frame of this round (``raw`` its bytes); an :class:`EpochEnd`
        goes to ``step`` too (a middle stage relays it) and, at a
        feeder's last epoch, fences this stage's PAUSE drain.  A PAUSE does not
        abandon the in-flight stream: the feeders NOTIFY the moment
        their data is dispatched, well before the stream is in."""
        in_q = intermediate_queue(self.stage - 1, self.cluster, self.pair)
        fenced: set = set()
        paused: Pause | None = None
        last_rx = time.monotonic()
        while True:
            if paused is None:
                pause = self._check_pause()
                if isinstance(pause, _AbortPause):
                    return pause     # round abandoned: nothing to drain
                if pause is not None:
                    paused = pause
                    last_rx = time.monotonic()
            elif self._drained(fenced, last_rx):
                self.log.info("[<<<] PAUSE (stream drained)")
                return paused
            raw = self.bus.get(in_q, timeout=0.001)
            if raw is None:
                continue
            act = self._decode(raw, in_q)
            if act is None or act.round_idx != self.fence:
                continue
            if isinstance(act, EpochEnd) and act.epoch >= self.epochs - 1:
                fenced.add(act.client_id)
            step(act, raw)
            # the grace measures the in-queue's silence, not this step's
            # compute (the JAX package's step returns at dispatch)
            last_rx = time.monotonic()

    def _train_middle_async(self) -> Pause:
        """Middle stage: a local aux step on every upstream activation,
        its output forwarded downstream; fences relayed as they come."""
        out_qs = self._out_queues()
        n_fwd = [0]

        def step(act, raw) -> None:
            if isinstance(act, EpochEnd):
                for q in out_qs:
                    self.bus.publish(q, raw)
                return
            labels = np.asarray(act.labels, np.int32)
            out = self._aux_tick(
                _from_wire_tree(act.data, self.device),
                host_tensor(labels).to(self.device), len(labels))
            self._send_activation(out, out_qs[n_fwd[0] % len(out_qs)],
                                  act.data_id, act.labels,
                                  list(act.trace) + [self.client_id])
            n_fwd[0] += 1
        return self._async_consume(step)

    def _train_last_async(self) -> Pause:
        """Last stage: the true loss and a local step per received batch,
        and no input gradient returned (the point of the mode)."""
        r = self.runner

        def step(act, _) -> None:
            if isinstance(act, EpochEnd):
                return
            labels = host_tensor(np.asarray(act.labels, np.int32)).to(
                self.device)
            x = _from_wire_tree(act.data, self.device)
            sp = self.tracer.start("sda_step", always=False,
                                   round=self.round_idx, window=1)
            t_sp = time.perf_counter()
            loss, _ = r.last_step(x, labels, input_grad=False)
            self._ok_dev = self._ok_dev & torch.isfinite(loss)
            r.apply_update()
            sp.end()
            self.hists.observe("step", time.perf_counter() - t_sp)
            self.num_samples += len(act.labels)
        return self._async_consume(step)
