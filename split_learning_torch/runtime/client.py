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

Left out (each raises ``NotImplementedError`` when its config asks for
it): async decoupled mode and auxiliary heads, sync-overlap ticks (and
their speculative forwards across a hold START), the legacy int8 wire
dtype.  Heartbeats, tracing spans and scheduler knobs are not emitted.
"""

from __future__ import annotations

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
    Notify, Pause, QuantLeaf, Ready, Register, Start, Stop, Syn, Update,
    encode, encode_parts, gradient_queue, host_tensor, intermediate_queue,
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
    cannot hold it); a :class:`Float0` gradient as zeros of the wire
    dtype; others at their own dtype."""
    def conv(leaf):
        if isinstance(leaf, Float0):
            leaf = torch.zeros(leaf.shape, dtype=dtype)
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
    parameters.  :meth:`state_tree` is then the merged weights."""

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

    def last_step(self, x, labels: torch.Tensor):
        """Last stage: float32 cross entropy, gradients into ``.grad``;
        returns (loss, input gradient tree)."""
        xr = cut_boundary(x)
        logits = self._apply(xr)
        loss = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.reshape(-1).long())
        loss.backward()
        return loss.detach(), self._input_grads(xr)

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
        self._fault_base: dict | None = None
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
        """Blocking lifecycle loop; returns on STOP.  However it ends
        (STOP, a closed bus, a scripted crash), a transport stack the
        client built itself is closed, every layer of it."""
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
        if msg.params is None:
            self._hold(msg)
            return
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
        if r.learning_dict != dict(msg.learning or {}) \
                or r.optimizer is None:
            r.relearn(msg.learning)
            self.log.info("fresh optimizer over the kept weights")
        else:
            self.log.info("keeping local shard weights (no re-seed)")
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
        if with_weights:
            # the server folds the weights and the next START re-seeds
            # the shard with a fresh optimizer: free the moments now,
            # while the server folds, rather than holding them on the
            # card.  Without weights the shard is held, moments and all
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
            out, rng = r.fwd(x)
            inflight[act.data_id] = _Inflight(x=x, trace=list(act.trace),
                                              n=len(act.labels), rng=rng)
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
        x = _concat([a.data for a in window])
        labels = torch.from_numpy(np.concatenate(
            [np.asarray(a.labels, np.int32) for a in window])).to(
            self.device)
        loss, gx = r.last_step(x, labels)
        # NaN sentinel (src/train/VGG16.py:169), folded on the device and
        # synced once per round in _send_update
        self._ok_dev = self._ok_dev & torch.isfinite(loss)
        r.apply_update()
        self.num_samples += sum(sizes)
        off = 0
        for act, n in zip(window, sizes):
            part = gx if len(window) == 1 else _rows(gx, off, n)
            off += n
            self._send_gradient(part, act.data_id, act.trace)
