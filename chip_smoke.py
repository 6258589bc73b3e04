"""Chip smoke test of the PyTorch/CUDA port (``split_learning_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure.  Phases 1-3 run first, alone, so that
the kernels are timed with nothing else on the card; phases 4-31 then
run in four groups at once, each group a process of its own on the card
running its phases in order (:data:`PHASE_GROUPS`: TinyLlama, BERT and
the telemetry plane's round; VGG16's baseline 1; baselines 2-4; KWT-1's variants and chaos), so their
walls, idle shares and profiles are taken beside the other groups' work:

1. device — requires CUDA; prints the card's name and power limit
   (``nvidia-smi``) and sets both TF32 switches explicitly (off);
2. build — compiles every kernel source of ``split_learning_torch/csrc``
   (flash attention, the wire quantizer, the stage update) with ``nvcc``,
   one compiler process per source, all started together;
3. kernels — holds each kernel against its plain PyTorch version at the
   main paths' shapes and times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (a yardstick
   only: the port never calls it).  Flash attention within stated
   tolerances (bf16 at the slice's shapes and at D = 128, float32 causal
   and not, odd sequence lengths, every head dim), each forward and
   backward case checked to take the kernels its route names (bf16
   D >= 16: the bf16 tensor-core kernels; float32 and D = 8: the
   ``_simt`` ones); the float32-route forward and backward pair also at
   the slice's shapes (in float32, the dtype of their route; the
   split-TF32 forward and backward pair bounded by float32 bytes or by
   three TF32 products a float32 one at 495 TFLOP/s, their CUDA-core
   bound beside), timed beside the tensor-core kernels and SDPA (the
   backward
   against SDPA's backward with its backend pinned, by profiler device
   time beside that of delta + dK/dV + dQ); the quantizer on both of its
   routes (bf16, fp16 and float32 frames at tile 256 with NaN, inf and
   all-zero tiles, int8 and int4; tiles 1024 (vec), 2048, 64 and 7
   (generic); ragged leaves; a view 2 bytes off 16-byte alignment;
   rounding-ties and zero-scale tiles down each route), each case
   checked by the launch counters to take the route it names, the
   dequantizer on both of its routes (each case checked to take the
   route it names: tiles 256, 1024, 2048 and 64 the vec kernel, tile 7
   and codes 1 byte off 16-byte alignment the generic one), finalize
   (float32, bf16, fp16, int32 with rounding and
   ties, ragged n % 4 = 1, 2, 3, a view 4 bytes off 16-byte alignment)
   and momentum bit for bit, among them the VGG round's own shapes (the
   (32, 16, 16, 64) bf16 and float32 frames at tile 256, int8 and int4;
   the (4096, 4096) and (64,) float32 leaves) and config 3's (the (64,
   32, 32, 256) bf16 and float32 frames, int8; the (512, 512, 3, 3)
   leaf); the codec and stage-update kernels then timed, beside their
   plain versions, library calls and bounds, at the VGG round's shapes
   (the bf16 int8 frame, the float32 int8 frame beside it, the (4096,
   4096) leaf), at config 3's (the (64, 32, 32, 64) and (64, 32, 32,
   256) bf16 int8 frames, the (512, 512, 3, 3) leaf) and at the
   TinyLlama shapes of earlier slices (an (8, 256, 2048) frame, bf16
   int8, bf16 int4 and float32 int8; the (32000, 2048) leaf), by events
   and by profiler device time.  A tiny
   TinyLlama's logits and gradients through the flash kernels are held
   against its dense-attention path, and a tiny protocol round with every
   kernel flag on against the same round through the plain chains;
4. slice — one training round of full-width TinyLlama-1.1B
   (``configs/baseline5.yaml``: 4 stages, AdamW, bf16, batch 8,
   control-count 4, with ``use_flash: true``, 128 samples = 4 steps)
   through ``split_learning_torch.run.run_local`` on CUDA, with the
   kernels' launch counts zeroed just before and read just after (the
   bf16 forward takes the tensor-core kernel, 176 launches a step, each
   tensor-core backward kernel 88 a step, and the float32-route
   ``_simt`` kernels are launched 0 times);
5. profile — the same round once more, warm, with its device kernels
   traced by ``torch.profiler`` (not counted) and summed by name from the
   trace's kineto events: round wall, the device's busy and idle share,
   and the kernels that take the most device time;
6. protocol — the protocol round at the same width (11 of the 22
   blocks, cut ``[1, 6, 9]``, for the script's time): ``ProtocolServer``
   in this thread and one ``ProtocolClient`` thread per client over a
   shared ``InProcTransport``, ``clients: [2, 1, 1, 1]``, an int8 codec
   on both cut directions, the sharded (CUDA) fold with
   ``server-momentum: 0.9`` for 2 rounds (the second launches the
   momentum kernel on the velocity the first carried), every kernel
   flag on — then one more round with ``server-momentum: 0``, because
   with momentum every TinyLlama leaf takes the momentum kernel and only
   a plain FedAvg round finalizes.  Counts zeroed before and read after
   (each tensor-core backward kernel 88 launches a round, the vec
   quantizer and the dequantizer 48, the ``_simt`` kernels and the
   generic quantizer 0);
7. protocol_tcp — the first of those rounds in the deployment shape
   (one round, for the script's length; ``variants_tcp`` carries a
   second START to running client processes): one
   ``python -m split_learning_torch.broker`` and one process each for
   the server and the five clients, all on the card, over TCP with the
   async sender and receive prefetch.  The samples and each kernel's
   launches across the processes must equal the in-process run's a
   round; reports the phase walls beside the in-process
   ones, the broker's bytes by queue family, each process's peak memory
   and the card's by ``nvidia-smi``;
8. step_check — one float32 train step of VGG16/CIFAR10 (cut 7), of
   ResNet-50 (cuts ``[3, 6]``), of ViT-S/16 (cut ``[10]``), of KWT-1
   (cut 2) and of BERT-base with LoRA rank 8 (cut 4, padded rows; the
   adapters and the classifier trained), dropout off, on the CPU, on the
   card and in float64 on the CPU from the same weights, statistics and
   batch: the card's loss, statistics and gradients no farther from
   float64 than twice the CPU's float32 step, and VGG16's loss and
   statistics within stated tolerances of the CPU's;
9. vgg_slice — the default round in process (``run_local``) on
   ``config.yaml`` (1 round, ``[1, 1]``) and on
   ``configs/baseline1.yaml`` (1 of its 5 rounds, ``[2, 2]``: two
   lockstep columns) as written otherwise, bf16, with every launch
   counter 0 (every ``kernels:`` flag is off); samples, validation,
   the checkpoint's parameters and statistics checked; then
   ``config.yaml``'s round once more, warm and traced (vgg_profile);
10. vgg_protocol — baseline 1 as the protocol round in one process with
   the int8 codec on both cut directions, every kernel flag on and the
   sharded fold: one round at ``server-momentum: 0.9``, one at 0.  The
   quantizer, dequantizer, momentum and finalize kernels must launch, the
   quantizer on bf16 activation frames and float32 gradient frames, once
   per frame, and every one of their launches is held bit for bit
   against the kernel's plain version on the same inputs;
11. vgg_tcp — ``config.yaml`` as processes over TCP (broker, server, two
   clients), one round, with the samples of the same round in one
   process;
12. profiler — ``python -m split_learning_torch.profiler --config
   configs/baseline2.yaml`` as a process on the card (``time`` mode: each
   VGG16 layer's forward at batch 32 by CUDA events), then ``flops``
   mode; prints each layer's time and boundary bytes, the full forward's
   samples/s and the bandwidth through an ``InProcTransport``; checks
   ``size_data`` against the same function on the CPU and the
   throughput-balance cut from the card's profile (printed beside the
   even split);
13. baseline2_slice — BASELINE config 2 in process (``run_local``) as
   written but for its rounds (1 of 5): 4 stage-1 clients at 2500
   samples clustered by KMeans into 2, selection on, the even cut,
   every launch counter 0; then 1 round with the card's profile
   registered for every client (the auto cut from the card's times);
14. baseline2_protocol — baseline 2 as the protocol round in one process,
   every client registering the card's profile and one stage-1 client
   a tenth as fast: GMM selection rejects it (the server's plans equal
   ``plan_clusters`` on the same registrations, and the rejected client
   is never STARTed), both clusters train and fold on their own queues;
   the int8 codec both ways, every kernel flag on, the sharded fold at
   ``server-momentum`` 0.9 then 0; every quantize, dequantize, momentum
   and finalize launch held bit for bit against its plain version;
15. strategies — SDA, relay, cluster relay, periodic and FedAsync in
   process at full VGG16 width on baseline 2's geometry, 2 rounds of
   256 samples a client, each held to its own contract (samples,
   validated rounds, finite losses, FedAsync's per-merge checkpoints);
16. baseline3_slice — BASELINE config 3 in process (``run_local``) as
   written but for its depth (1 of its 5 rounds):
   ResNet-50/CIFAR-100, ``[2, 2, 2]``, cuts ``[3, 6]``, batch 64, bf16,
   every launch counter 0, the 17 layers of (nested) BatchNorm
   statistics in the checkpoint; then one round once more, warm and
   traced (its idle share);
17. baseline3_protocol — config 3 as the protocol round in one process:
   three stages, six clients, the int8 codec on both directions of both
   cuts, every kernel flag on, the sharded fold at ``server-momentum``
   0.9 then 0; every quantize, dequantize, momentum and finalize launch
   held bit for bit against its plain version;
18. baseline4_slice — BASELINE config 4 in process as written but for
   its depth (1 of its 5 rounds): ViT-S/16 on CIFAR-10, ``[2,
   1]``, cut ``[10]``, AdamW with weight decay 0.05, dropout 0.1, bf16;
   then one round warm and traced;
19. kwt_slice — KWT-1 on SpeechCommands in process
   (``configs/kwt1_speechcommands.yaml``: its published width, ``[2,
   2]``, cut 2, AdamW 1e-3, batch 32, bf16), 1 of its 3 rounds, every
   launch counter 0; then one round warm and traced;
20. variants — the eight ``examples/variants/*.yaml`` in process as
   written (KWT in relay, cluster relay, SDA, strict SDA in two and
   three stages, periodic and FedAsync; the fine-grained BERT_EMOTION in
   FedAvg), each to its end, its final validation loss and accuracy
   reported;
21. variants_protocol — the seven KWT variants as the protocol round in
   one process at KWT-1's published width (their ``model-kwargs``
   dropped; batch 32, 128 samples a client, bf16, the int8 codec both
   ways, the quantize, dequantize and stage-update kernels with the
   sharded fold; strategy, clients, topology, rounds and SDA and FLEX
   settings as written): relay's START cycles, FLEX's hold rounds (no
   weight bytes), SDA's windows (distinct origins, at most sda-size,
   every sample consumed; strict fences through a middle stage), 2LS's
   pairs (each head hears its pair's feeders); every quantize,
   dequantize and finalize launch held bit for bit and counted as
   ``VARIANT_LAUNCHES`` predicts; then ``dcsl_strict_deep`` with a
   stage-1 feeder that registers and never answers, dropped at READY,
   each round completing with the live feeder's samples;
22. variants_tcp — ``dcsl_strict`` at the same width as broker, server
   and three client processes over TCP: the in-process samples, every
   UPDATE folded, the predicted launches;
23. chaos_protocol — ``dcsl_strict`` at the same width with
   ``control-count: 1`` in one process, twice fault-free (their final
   parameters equal bit for bit), then under the JAX package's
   acceptance recipe (seed 1234: drop 0.10, duplicate 0.10, reorder
   0.15, corrupt 0.05, delay 0.10 of 5 ms) with ``transport.reliable``,
   each participant on its own ``make_runtime_transport`` stack (async
   sender, reliable layer, chaos) over the shared bus: its final
   parameters bit for bit the fault-free ones, its samples and its
   quantize, dequantize and finalize launches theirs (each held bit for
   bit), drops, redeliveries, duplicates, dedup hits, corruptions and
   rejected corrupt frames all counted;
24. chaos_tcp — the same config as processes on a two-shard broker plane
   (``python -m split_learning_torch.broker --shards 2``,
   ``broker.shards: 2``), fault-free, then under the recipe with
   reliable delivery on every protocol queue, the shard that owns
   ``intermediate_queue_0_0`` SIGKILLed after the server's first SYN and
   started again on its port with the supervisor's restart command: both
   runs' rounds ok with the in-process samples, the participants'
   ``kind=faults`` records showing reconnects and every fault above,
   frames on both shards, and the chaos run's final checkpoint bit for
   bit the fault-free run's;
25. bert_slice — BERT-base on AG-News with LoRA (rank 8, alpha 16, the
   default targets) in process (``configs/bert_lora_agnews.yaml``: full
   width, ``[2, 2]``, cut 4, batch 32, 512 samples a client, AdamW,
   bf16), 2 rounds, the frozen leaves unchanged and the adapted ones
   moved; then one round warm and traced;
26. bert_protocol — the same model as the protocol round in one process:
   the int8 codec on the ``(hidden, mask)`` boundary both ways, every
   kernel flag on, the sharded fold at ``server-momentum`` 0.9 then 0;
   every quantize, dequantize, momentum and finalize launch held bit for
   bit against its plain version, and each count equal to the one the
   batches, directions and parameter leaves predict;
27. async_protocol — baseline 1 (VGG16/CIFAR10, ``[2, 2]``, cut 7,
   batch 32, 2500 samples a client) in async mode as the protocol round
   in one process: ``pooled-linear`` aux heads, ``max-staleness: 2``,
   ``staleness-decay: 0.5``, every kernel flag on, the sharded fold at
   ``server-momentum: 0.9``.  Run a, ``async-quorum: 0``, 3 rounds with
   the int8 activation codec and ``rpc: delta:int8``: no gradient frame,
   every UPDATE a delta at most 0.3 of the float32 frame it replaces.
   Run b, ``async-quorum: 2``, 2 rounds, one feeder's first UPDATE held
   back until its next START: a stale admit at weight 0.5, no barrier
   waiting out the client timeout.  Every quantize, dequantize, finalize
   and momentum launch of both runs held bit for bit, the finalize and
   momentum ones on the decayed total weight too;
28. codec_protocol — baseline 1 in sync mode, 2 rounds, ``intermediate:
   int8``, ``gradient: "topk:0.05"``, ``rpc: delta:int8``: gradient
   bytes ≈ 0.1 of the float32 dense frames, every top-k step held to the
   error-feedback identity with its residual carried, every UPDATE a
   delta, every quantize, dequantize, finalize and momentum launch held
   bit for bit;
29. tree_protocol — baseline 1 at ``[4, 2]`` under the thread-mode
   aggregator tree (fan-in 2, 2 levels: the root folds 2 partials, one
   level-2 aggregator 2 level-1 partials): run a with raw float32
   partials, the root bit for bit the host fold of the six tapped
   UPDATEs in canonical (stage, group, client) order; run b with the
   ``delta:int8:64`` partial codec and one level-1 aggregator killed,
   completed through the counted direct-to-root fallback, bit for bit
   the same fold through the codec and within its derived bound of the
   fold without it, its root partial bytes against run a's; every
   quantize, dequantize, finalize and momentum launch held bit for bit;
30. trace_protocol — cell 6's round (baseline 1, int8 on both data
   planes, every kernel flag, the sharded fold at momentum 0.9) with
   each feeder paired to its own head, run a traced at ``sample-rate:
   1.0`` and run b untraced: a bit for bit b, the same launches, every
   one held bit for bit; one schema-v1 journal a participant on the
   server's trace id; every consume span parented to a publish span of
   its sender, as many client consumes as dequantize launches and
   data-queue publishes as quantize launches; the latency histograms and
   the wire counters against the spans and the bus, a's data bytes 32 a
   part above b's; ``phases`` in ``kind=round``; ``tools/sl_trace.py``'s
   critical-path components summing to the round's wall within 1 ms.
   Phases 9, 11 and 23 read their own runs' journals again: the loop's
   spans and phases in process, one trace and complete edges across the
   TCP processes, ``transport_rtt`` under chaos;
31. fleet_protocol — cell 6's round with heartbeats every 0.5 s, a
   liveness timeout of 4 s and the exporter serving, a thread scraping
   ``/metrics`` and ``/fleet`` every 0.4 s: run a (FedAvgM 0.9) every
   scrape lint-clean, every client seen healthy after its SYN, each
   client's heartbeats at least its training wall over 0.5 s less 2,
   every UPDATE carrying a snapshot, a ``kind=fleet`` record naming
   every client, ``tools/sl_top.py`` rendering it; run b (momentum 0)
   ``client_1_1`` killed by a scripted crash at its second activation,
   its heartbeat thread ending with it, marked ``lost`` and its barrier
   released early (``fleet_lost_drops``), the survivors' UPDATEs folded,
   no survivor ever ``lost``, the wall under run a's + 4 + 5 s; every
   quantize, dequantize, finalize and momentum launch held bit for bit.
   Every protocol phase prints its clients' heartbeat frames and bytes;
32. summary — a ``{"kernels": [...]}`` line (each kernel's launches on
   its main path: the VGG protocol round for the codec and stage-update
   kernels, the TinyLlama protocol round for the flash kernels; every
   path's in ``launches_by_path``; the times and bounds at that path's
   shapes, and the codec and stage-update rows' at config 3's in
   ``baseline3_shapes`` and at the BERT round's in ``bert_shapes``),
   then the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --group NAME WORKDIR OUT`` runs one group of
phases (:func:`run_group`).  ``python3 chip_smoke.py --participant
MODULE ARG...`` is the TCP phases' participant runner: it runs
``MODULE.main(ARG...)`` and prints that process's launch counts and
peak memory.  ``python3 chip_smoke.py
--trace-cost [PAIRS]`` measures the round tracer's cost on phase 30's
round, traced and untraced in turns (:func:`measure_trace_cost`).

It imports nothing of JAX.  It exits non-zero, printing no result, when
there is no CUDA device or when the port's package is not beside it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import signal
import tempfile
import threading
import time

import torch
import torch.nn.functional as F

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

# H100 SXM data-sheet peaks (dense): device memory and compute rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the float32 and D = 8 forward and backward pair run each float32
# product as three TF32 products on the tensor cores (split TF32): their
# operations bound
SPLIT_TF32_KERNELS = ("flash_fwd_simt", "flash_bwd_dkv_simt",
                      "flash_bwd_dq_simt")
PEAK_TF32 = 495e12

# the slice's flash-attention shapes: (B*H, S, D) = (8*32, 256, 64), bf16
SLICE_SHAPE = (8 * 32, 256, 64)
# the flash kernels of the float32 and D = 8 route (the split-TF32
# forward and backward pair)
SIMT_KERNELS = ("flash_fwd_simt", "flash_bwd_dkv_simt", "flash_bwd_dq_simt")
# the kernels that the bf16 main paths must never launch: the float32-route
# flash kernels and the generic quantizer and dequantizer (the wire's tile
# 256 on an aligned frame, and the codes it decodes into, take the vec
# kernels)
OFF_PATH_KERNELS = SIMT_KERNELS + ("quantize_generic", "dequantize_generic")
# one activation / gradient frame at a cut: (batch, sequence, hidden)
FRAME_SHAPE = (8, 256, 2048)
# the codec frames timed beside the bf16 int8 one of the kernel rows,
# each one FRAME_SHAPE frame at tile 256: (label, dtype, bits)
CODEC_FRAMES = (("bf16 int4", torch.bfloat16, 4),
                ("f32 int8", torch.float32, 8))
# the largest parameter leaf (embedding and LM head): (vocab, hidden)
LEAF_SHAPE = (32000, 2048)
# the VGG round's shapes, where the codec and stage-update kernels run on
# their main path: the cut-7 activation / gradient frame at batch 32
# (bf16 activations, float32 gradients, tile 256), the largest parameter
# leaf (layer 50's Dense) and the smallest statistics leaf
VGG_FRAME_SHAPE = (32, 16, 16, 64)
VGG_LEAF_SHAPE = (4096, 4096)
VGG_STATS_SHAPE = (64,)
# the VGG frames timed beside the bf16 int8 one of the kernel rows
VGG_CODEC_FRAMES = (("f32 int8", torch.float32, 8),)
#: the widest tile (bf16 values) a block of the generic quantizer stages
#: in shared memory (``kSpanBytes`` of ``csrc/quant.cu``): one value more
#: takes its windows, read twice
GENERIC_SPAN_VALUES_BF16 = 16384
#: BASELINE config 3's protocol round (ResNet-50, batch 64): the bf16
#: activation frames at cuts 3 and 6, and its largest leaf (a 3x3 conv
#: kernel of 512 -> 512 channels)
B3_FRAME_SHAPES = ((64, 32, 32, 64), (64, 32, 32, 256))
B3_LEAF_SHAPE = (512, 512, 3, 3)
#: the BERT-base protocol round (batch 32, 128 tokens): the activation
#: frame's hidden leaf (bf16; its gradient float32), and its largest leaf
#: (the word-embedding table, folded in float32)
BERT_FRAME_SHAPE = (32, 128, 768)
BERT_LEAF_SHAPE = (28996, 768)
SOURCES = ("flash_attention", "quant", "update")
# where the protocol phases run (a CPU rehearsal of the script sets "cpu")
DEVICE = "cuda"
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("split_learning_torch/csrc/flash_attention.cu",
                  "split_learning_tpu/ops/flash_attention.py:62"),
    "flash_fwd_simt": ("split_learning_torch/csrc/flash_attention.cu",
                       "split_learning_tpu/ops/flash_attention.py:62"),
    "flash_bwd_dkv": ("split_learning_torch/csrc/flash_attention.cu",
                      "split_learning_tpu/ops/flash_attention.py:134"),
    "flash_bwd_dq": ("split_learning_torch/csrc/flash_attention.cu",
                     "split_learning_tpu/ops/flash_attention.py:173"),
    "flash_bwd_dkv_simt": ("split_learning_torch/csrc/flash_attention.cu",
                           "split_learning_tpu/ops/flash_attention.py:134"),
    "flash_bwd_dq_simt": ("split_learning_torch/csrc/flash_attention.cu",
                          "split_learning_tpu/ops/flash_attention.py:173"),
    "quantize": ("split_learning_torch/csrc/quant.cu",
                 "split_learning_tpu/ops/kernels/quant.py:37"),
    "quantize_generic": ("split_learning_torch/csrc/quant.cu",
                         "split_learning_tpu/ops/kernels/quant.py:37"),
    "dequantize": ("split_learning_torch/csrc/quant.cu",
                   "split_learning_tpu/ops/kernels/quant.py:92"),
    "dequantize_generic": ("split_learning_torch/csrc/quant.cu",
                           "split_learning_tpu/ops/kernels/quant.py:92"),
    "finalize": ("split_learning_torch/csrc/update.cu",
                 "split_learning_tpu/ops/kernels/update.py:53"),
    "momentum": ("split_learning_torch/csrc/update.cu",
                 "split_learning_tpu/ops/kernels/update.py:81"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} tf32 off")


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def _print_ptxas(text: str) -> None:
    """Each kernel's registers, spills and shared memory from nvcc's
    ``-Xptxas -v`` report, under the kernel's demangled name."""
    try:
        text = subprocess.run(["c++filt"], input=text, capture_output=True,
                              text=True, timeout=60).stdout or text
    except (OSError, subprocess.SubprocessError):
        pass
    func, spills = "?", ""
    for line in text.splitlines():
        body = line.split("ptxas info    :")[-1].strip()
        if "Compiling entry function" in body:
            func = _kernel_name(body.split("'")[1] if "'" in body else body)
        elif "spill" in body:
            spills = body
        elif "Used" in body:
            print(f"  ptxas: {func}: {body}; {spills}")


def phase_build():
    import split_learning_torch
    from split_learning_torch.ops.kernels import build
    check(pathlib.Path(split_learning_torch.__file__).resolve().is_relative_to(
        HERE), f"split_learning_torch imported from outside {HERE}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name in SOURCES:
        build.load(name)
    secs = time.perf_counter() - t0
    for name, lib_path in paths.items():
        print(f"build: {lib_path.name} (nvcc {build.BUILD_SECONDS[name]:.2f}"
              " s)")
        log = lib_path.with_name(lib_path.name + ".log")
        if log.exists():
            _print_ptxas(log.read_text())
    print(f"build: all sources in {secs:.2f} s")


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

_FLUSH = None


def _time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median time of ``fn()`` in ms from CUDA events, the 50 MB L2
    flushed before each launch (the caller's inputs start cold).

    Every rep is enqueued before any is read: the 512 MB flush keeps the
    card busy for ~0.2 ms, so the host has enqueued ``fn()``'s launch by
    the time the card reaches the start event, and a short kernel's
    time does not include the host's call overhead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _max_err(out, ref) -> tuple[float, float]:
    out, ref = out.float(), ref.float()
    return (float((out - ref).abs().max()), float(ref.abs().max()))


def _tolerance(dtype, kind: str, ref_max: float) -> float:
    """Allowed max |kernel - plain| against the float32 plain version.

    bf16 outputs: the kernel rounds each output to bf16 once (relative
    error <= 2^-8) and sums in another order than the plain version;
    allow 2^-7 of the largest |value| (lse is float32 in both: 1e-4 of
    it, for the summation order of up to S exponentials).
    float32: the JAX package's own flash-vs-dense tolerances (2e-5 for
    o/lse, 5e-4 for gradients), relative to max(1, largest |value|)."""
    scale = max(1.0, ref_max)
    if dtype == torch.bfloat16:
        return (1e-4 if kind == "lse" else 2.0 ** -7) * scale
    return (2e-5 if kind in ("o", "lse") else 5e-4) * scale


def _bytes_and_flops(name: str, shape, dtype, causal: bool):
    """Least bytes moved (each input read once, each output written
    once) and the multiply-adds these inputs need (causal: only the
    visible (q, k) pairs)."""
    bh, s, d = shape
    el = torch.tensor([], dtype=dtype).element_size()
    mat, row = bh * s * d * el, bh * s * 4
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    if name.startswith("flash_fwd"):   # q,k,v -> o, lse; QK^T and PV
        return 4 * mat + row, 4 * d * pairs
    if name.startswith("flash_bwd_dkv"):   # q,k,v,dO,lse,delta -> dk,dv
        return 6 * mat + 2 * row, 8 * d * pairs
    return 5 * mat + 2 * row, 6 * d * pairs   # dq: 3 products


def _check_tf32_sass() -> dict:
    """The split-TF32 kernels' machine code (the float32-route forward
    and backward pair), from ``cuobjdump -sass`` of the built flash
    library: the TF32 tensor-core products (``HMMA.1688.F32.TF32``) and
    the float32 FMAs (``FFMA``) of each instantiation.  Fails unless all
    30 (3 kernels x 2 dtypes x 5 head dims) have TF32 products."""
    from split_learning_torch.ops.kernels import build
    tool = pathlib.Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    try:
        sass = subprocess.run(["c++filt"], input=sass, capture_output=True,
                              text=True, timeout=60).stdout or sass
    except (OSError, subprocess.SubprocessError):
        pass
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            func = name if "_x3_kernel" in name else None
            if func:
                counts[func] = {"tf32_mma": 0, "ffma": 0}
        elif func and "HMMA.1688.F32.TF32" in line:
            counts[func]["tf32_mma"] += 1
        elif func and " FFMA " in line:
            counts[func]["ffma"] += 1
    for func, c in sorted(counts.items()):
        print(f"  sass: {func}: {c['tf32_mma']} HMMA.1688.F32.TF32, "
              f"{c['ffma']} FFMA")
    check(len(counts) == 30 and all(c["tf32_mma"] for c in counts.values()),
          f"split-TF32 kernels: expected 30 instantiations with TF32 "
          f"tensor-core products, got {counts}")
    return counts


def phase_kernels() -> dict:
    from split_learning_torch.ops import flash_attention as fa
    sass = _check_tf32_sass()

    cases = [("slice bf16 causal", SLICE_SHAPE, torch.bfloat16, True),
             ("bf16 D=128 S=256 causal", (16, 256, 128), torch.bfloat16,
              True),
             ("f32 causal", (16, 256, 64), torch.float32, True),
             ("f32 non-causal", (16, 256, 64), torch.float32, False),
             ("bf16 odd S=48 causal", (16, 48, 64), torch.bfloat16, True),
             ("f32 odd S=48 non-causal", (16, 48, 64), torch.float32,
              False)]
    # every other head dim the kernels are built for, at a ragged S
    for d in (8, 16, 32, 128):
        cases += [(f"bf16 D={d} S=100 causal", (8, 100, d), torch.bfloat16,
                   True),
                  (f"f32 D={d} S=80 non-causal", (8, 80, d), torch.float32,
                   False)]
    results = {}
    for ci, (label, shape, dtype, causal) in enumerate(cases):
        q, k, v, do = _inputs(shape, dtype, seed=ci)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1)
        lse_in = lse_ref.contiguous()
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(
            q.float(), k.float(), v.float(), do.float(), lse_in, delta,
            causal)
        dq_ref = fa.flash_bwd_dq_reference(
            q.float(), k.float(), v.float(), do.float(), lse_in, delta,
            causal)
        o_ref32, _ = fa.flash_fwd_reference(q.float(), k.float(),
                                            v.float(), causal)

        route = fa._fwd_route(dtype, shape[-1])
        sfx = "" if fa._bwd_route(dtype, shape[-1]) == "tc" else "_simt"
        dkv_name, dq_name = f"flash_bwd_dkv{sfx}", f"flash_bwd_dq{sfx}"

        def launched(call, want, what):
            before = dict(fa.LAUNCHES)
            out = call()
            took = {n for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]}
            check(took == {want}, f"{what} {label}: launched {took}, its "
                  f"route is {want}")
            return out

        o, lse = launched(lambda: fa.flash_fwd(q, k, v, causal), route,
                          "flash_fwd")
        dk, dv = launched(lambda: fa.flash_bwd_dkv(q, k, v, do, lse_in,
                                                   delta, causal),
                          dkv_name, "flash_bwd_dkv")
        dq = launched(lambda: fa.flash_bwd_dq(q, k, v, do, lse_in, delta,
                                              causal), dq_name,
                      "flash_bwd_dq")
        errs = {route: [("o", o, o_ref32), ("lse", lse, lse_ref)],
                dkv_name: [("dk", dk, dk_ref), ("dv", dv, dv_ref)],
                dq_name: [("dq", dq, dq_ref)]}
        if ci == 0:
            # the float32-route kernels at the slice's shapes too, on its
            # bf16 inputs: they are the yardsticks of the bf16 ones
            o_s, lse_s = fa._launch_fwd("flash_fwd_simt", q, k, v, causal)
            errs["flash_fwd_simt"] = [("o", o_s, o_ref32),
                                      ("lse", lse_s, lse_ref)]
            dk_s, dv_s = fa._launch_dkv("simt", q, k, v, do, lse_in, delta,
                                        causal)
            errs["flash_bwd_dkv_simt"] = [("dk", dk_s, dk_ref),
                                          ("dv", dv_s, dv_ref)]
            errs["flash_bwd_dq_simt"] = [("dq", fa._launch_dq(
                "simt", q, k, v, do, lse_in, delta, causal), dq_ref)]
        torch.cuda.synchronize()
        for name, outs in errs.items():
            worst = 0.0
            for kind, out, ref in outs:
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name} {label}: non-finite {kind}")
                err, ref_max = _max_err(out, ref)
                tol = _tolerance(dtype, kind, ref_max)
                print(f"  {name:18s} {label:24s} {kind:3s} max_abs_err "
                      f"{err:.3e} (max|ref| {ref_max:.3g}, tol {tol:.3e})")
                check(err <= tol, f"{name} {label}: {kind} max_abs_err "
                      f"{err} > tol {tol}")
                worst = max(worst, err)
            if ci == 0:
                results[name] = {"max_abs_err": worst}

        if ci != 0:
            continue
        # times at the slice's shapes: the tensor-core kernels on its
        # bf16 inputs, the float32-route ones on the same values in
        # float32, the dtype whose route they are
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, lse32 = fa.flash_fwd_reference(q32, k32, v32, causal)
        lse32 = lse32.contiguous()
        delta32 = (do32 * o32).sum(-1)
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_reference(q, k, v, causal)),
            "flash_fwd_simt": (
                lambda: fa._launch_fwd("flash_fwd_simt", q32, k32, v32,
                                       causal),
                lambda: fa.flash_fwd_reference(q32, k32, v32, causal)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dkv_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse_in, delta, causal),
                lambda: fa.flash_bwd_dq_reference(
                    q32, k32, v32, do32, lse_in, delta, causal)),
            "flash_bwd_dkv_simt": (
                lambda: fa._launch_dkv("simt", q32, k32, v32, do32, lse32,
                                       delta32, causal),
                lambda: fa.flash_bwd_dkv_reference(
                    q32, k32, v32, do32, lse32, delta32, causal)),
            "flash_bwd_dq_simt": (
                lambda: fa._launch_dq("simt", q32, k32, v32, do32, lse32,
                                      delta32, causal),
                lambda: fa.flash_bwd_dq_reference(
                    q32, k32, v32, do32, lse32, delta32, causal)),
        }
        b, h = 8, 32
        q4, k4, v4, q4_32, k4_32, v4_32 = (
            t.view(b, h, shape[1], shape[2])
            for t in (q, k, v, q32, k32, v32))
        sdpa = (lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True))
        sdpa32 = (lambda: F.scaled_dot_product_attention(
            q4_32, k4_32, v4_32, is_causal=True))
        library = {"flash_fwd": sdpa, "flash_fwd_simt": sdpa32}
        bwd_ms, bwd_split = {}, {}
        bwd_ms["tc"], bwd_split["tc"] = _backward_yardstick(
            q, k, v, do, o, lse_in, causal, (q4, k4, v4))
        bwd_ms["simt"], bwd_split["simt"] = _backward_yardstick(
            q32, k32, v32, do32, o32, lse32, causal, (q4_32, k4_32, v4_32))
        for name, (kern, plain) in runs.items():
            simt = name.endswith("_simt")
            row_dtype = torch.float32 if simt else dtype
            nbytes, flops = _bytes_and_flops(name, shape, row_dtype, causal)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[row_dtype] * 1e3
            r = results[name]
            if name in SPLIT_TF32_KERNELS:
                # bounded by the arithmetic the kernel runs: three TF32
                # products a float32 one; the CUDA-core bound beside it
                # keeps earlier rows comparable
                r["arith"] = "split TF32 (3 x mma.sync m16n8k8 tf32)"
                r["cuda_core_bound_ms"] = max(t_bytes, t_ops)
                t_ops = 3 * flops / PEAK_TF32 * 1e3
                if "bwd" in name:
                    r["port_backward_split"] = bwd_split["simt"]
                r["sass"] = {f: c for f, c in sass.items()
                             if name.removesuffix("_simt") + "_x3" in f}
            r["timed_at"] = (f"{str(row_dtype).replace('torch.', '')} "
                             f"{tuple(shape)} causal")
            r["ms"] = _time_ms(kern)
            r["device_ms"] = _device_ms(kern)[0]
            r["plain_ms"] = _time_ms(plain)
            # the backward's library call computes dq, dk and dv together
            # (timed by device time only)
            bwd = bwd_ms["simt" if simt else "tc"]
            r["library_ms"] = (_time_ms(library[name]) if name in library
                               else bwd)
            r["library_device_ms"] = (_device_ms(library[name])[0]
                                      if name in library else bwd)
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            r["bytes"], r["flops"] = nbytes, flops
            print(f"  {name:18s} kernel {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f})  plain "
                  f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            if "arith" in r:
                print(f"  {name:18s} arithmetic {r['arith']}: bound "
                      f"{r['bound_ms']:.4f} ms (bytes {t_bytes:.4f}, 3 x "
                      f"{flops / 1e9:.2f} GFLOP at {PEAK_TF32 / 1e12:.0f} "
                      f"TFLOP/s {t_ops:.4f}); CUDA-core bound "
                      f"{r['cuda_core_bound_ms']:.4f} ms")
    return results


def _device_ms(fn, reps: int = 20) -> tuple[float, dict]:
    """Device time of one ``fn()`` in ms from ``torch.profiler`` (CUPTI),
    each of ``reps`` runs after the L2 flush of :func:`_time_ms` (whose
    own fill kernel is left out), and the time of each kernel it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _time_ms(fn, reps=1, warmup=3)   # warm, and the flush buffer made
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _FLUSH.zero_()
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or _device_us(e) <= 0
                or "FillFunctor<unsigned char>" in e.key):
            continue
        name = _kernel_name(e.key)
        per[name] = per.get(name, 0.0) + _device_us(e) / 1e3 / reps
    return sum(per.values()), per


def _sdpa_backward(q4, k4, v4, do4):
    """SDPA's backward (dq, dk and dv together) as one autograd call on
    one recorded node, its backend pinned: the first of cuDNN, flash and
    memory-efficient attention that takes these inputs.  Returns the
    call and the backend's name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q4, k4, v4))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                            retain_graph=True),
                backend.name)
    raise SmokeFailure("no SDPA backend takes the slice's shapes")


def _backward_yardstick(q, k, v, do, o, lse, causal,
                        qkv4) -> tuple[float, dict]:
    """The library's backward at the slice's shapes against the port's:
    profiler device time of SDPA's backward (pinned backend) beside that
    of the port's backward as ``_Flash.backward`` runs it on the route of
    the inputs' dtype — the ``delta`` pre-pass, then dK/dV and dQ.
    Returns the library's device time in ms, and the port's split into
    those three parts with the library's backend and total beside it."""
    from split_learning_torch.ops import flash_attention as fa
    lib_call, backend = _sdpa_backward(*qkv4, do.view_as(qkv4[0]))
    lib_ms, lib_split = _device_ms(lib_call)
    print(f"  sdpa backward ({backend}, {q.dtype}; dq, dk, dv in one "
          "call): device "
          f"{lib_ms:.4f} ms, events {_time_ms(lib_call):.4f} ms; kernels "
          + ", ".join(f"{n[:60]} {t:.4f}" for n, t in lib_split.items()))

    def port_backward():
        delta = (do.float() * o.float()).sum(dim=-1)
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    ms, split = _device_ms(port_backward)
    print(f"  port backward (delta + dK/dV + dQ): device {ms:.4f} ms = "
          f"{ms / lib_ms:.2f}x the library's; kernels "
          + ", ".join(f"{n[:60]} {t:.4f}" for n, t in split.items()))
    parts = {"delta": 0.0, "dkv": 0.0, "dq": 0.0}
    for n, t in split.items():
        part = ("dkv" if "flash_bwd_dkv" in n else
                "dq" if "flash_bwd_dq" in n else "delta")
        parts[part] += t
    print(f"  port backward split ({q.dtype}): delta pre-pass "
          f"{parts['delta']:.4f} ms, dK/dV {parts['dkv']:.4f}, dQ "
          f"{parts['dq']:.4f}; sdpa ({backend}) {lib_ms:.4f} ms, kernels "
          + ", ".join(n[:80] for n in lib_split))
    return lib_ms, {**parts, "total": ms, "sdpa": lib_ms,
                    "sdpa_backend": backend,
                    "sdpa_kernels": list(lib_split)}


def phase_model_check() -> None:
    """A tiny TinyLlama in float32 on the card: logits and parameter
    gradients through the flash kernels against the dense path, at the
    JAX package's model-level tolerance (5e-4)."""
    from split_learning_torch.models import build_model
    kw = dict(vocab_size=64, hidden_size=128, num_heads=4, num_kv_heads=2,
              intermediate_size=256, n_block=2)
    x = torch.randint(0, 64, (2, 48), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    y = torch.roll(x, -1, dims=1)
    outs = []
    for flash in (True, False):
        m = build_model("TinyLlama_TINYSTORIES", device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1),
                        use_flash=flash, **kw)
        logits = m(x)
        F.cross_entropy(logits.reshape(-1, 64), y.reshape(-1)).backward()
        outs.append((logits.detach(),
                     {n: p.grad.detach() for n, p in m.named_parameters()}))
    (l1, g1), (l2, g2) = outs
    err = float((l1 - l2).abs().max())
    gerr = max(float((g1[n] - g2[n]).abs().max()) for n in g1)
    print(f"  tiny TinyLlama f32 flash vs dense: logits max_abs_err "
          f"{err:.3e}, grads max_abs_err {gerr:.3e} (tol 5e-4)")
    check(err <= 5e-4 and gerr <= 5e-4, "tiny model flash vs dense")
    phase_loss_check()


def phase_loss_check(devices=("cpu", "cuda")) -> None:
    """The pipeline's bf16 cross entropy on the card against the same
    function on the CPU (which tests/test_torch_bf16_loss.py holds equal
    to optax's): bf16 logits (512, 32000), sigma 3, from a numpy seed.
    The loss must be equal and the logits' gradients within one bf16 ulp
    of the largest gradient."""
    import numpy as np
    from split_learning_torch.parallel.pipeline import PipelineModel
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((512, 32000)) * 3).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 32000, 512))
    out = []
    for dev in devices:
        xd = x.clone().to(dev).requires_grad_(True)
        loss = PipelineModel.loss_from_logits(xd, y.to(dev))
        loss.backward()
        out.append((float(loss.detach()), xd.grad.float().cpu()))
    (cpu, cpu_g), (card, card_g) = out
    f32 = float(F.cross_entropy(x.float(), y))
    gerr = float((cpu_g - card_g).abs().max())
    gmax = float(cpu_g.abs().max())
    print(f"  bf16 loss (512, 32000): card {card} cpu {cpu} float32 "
          f"{f32:.6f}; grads max_abs_err {gerr:.3e} (tol "
          f"{2 ** -8 * gmax:.3e})")
    check(card == cpu and gerr <= 2 ** -8 * gmax,
          "bf16 loss on the card differs from the CPU's")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes (NaN payloads compare as bits)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _bitwise(name: str, label: str, out, ref) -> None:
    same = (out.dtype == ref.dtype and out.shape == ref.shape
            and torch.equal(_bits(out), _bits(ref)))
    print(f"  {name:10s} {label:36s} bitwise {'equal' if same else 'DIFFER'}")
    check(same, f"{name} {label}: kernel differs from its plain version")


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of memory traffic and ``ops``
    float32 operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_triple(name: str, kern, plain, library, nbytes: int,
                 ops: int) -> dict:
    """Kernel, plain and library times plus the bound (bytes over the
    memory rate or float32 operations over the CUDA-core rate).  The
    kernel and the library call are timed twice: by CUDA events
    (``ms``, ``library_ms``) and by profiler device time
    (``device_ms``, ``library_device_ms``), which leaves out the
    events' own ≈ 4–6 µs — as long as a codec kernel's bound."""
    bound, by = _bound(nbytes, ops)
    r = {"ms": _time_ms(kern), "device_ms": _device_ms(kern)[0],
         "plain_ms": _time_ms(plain),
         "library_ms": _time_ms(library) if library is not None else None,
         "library_device_ms": (_device_ms(library)[0]
                               if library is not None else None),
         "bound_ms": bound, "bound_by": by,
         "bytes": nbytes, "ops": ops, "max_abs_err": 0.0}
    lib = ("none" if library is None else f"{r['library_ms']:.4f} ms "
           f"(device {r['library_device_ms']:.4f})")
    print(f"  {name:16s} kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f})  plain {r['plain_ms']:.4f} ms  library "
          f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop)")
    return r


def _codec_frames(g, shape, frames) -> dict:
    """Events and profiler device time of the quantizer and the
    dequantizer, each on both routes (the generic kernels are the vec
    kernels' predecessors), on each ``(label, dtype, bits)`` of
    ``frames`` at ``shape``, of ``torch.mul`` (the dequantizer's library
    yardstick) on the int8 codes, and of the dequantizer's write floor
    (``fill_`` of its float32 output: the same bytes written, nothing
    read; a yardstick only), each beside its bound."""
    from split_learning_torch.ops.kernels import quant as kq
    out = {}
    for label, dtype, bits in frames:
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
        n, t_count = x.numel(), x.numel() // 256
        q, s = kq.quantize_tiles(x, tile=256, bits=bits)
        codes_b = q.numel()
        quant_b = x.element_size() * n + codes_b + 4 * t_count
        calls = {f"quantize {route}": (
            lambda route=route: kq._launch_quantize(route, x, 256, bits),
            quant_b, 5 * n) for route in kq.QUANT_ROUTES}
        calls.update({f"dequantize {route}": (
            lambda route=route: kq._launch_dequantize(route, q, s, 256,
                                                      bits),
            codes_b + 4 * t_count + 4 * n, n)
            for route in kq.DEQUANT_ROUTES})
        out32 = torch.empty(n, device="cuda")
        calls["fill floor"] = (lambda: out32.fill_(0), 4 * n, 0)
        if bits == 8:
            calls["torch.mul"] = (
                lambda: torch.mul(q.view(t_count, 256), s[:, None]),
                codes_b + 4 * t_count + 4 * n, n)
        rows = {}
        for name, (fn, nbytes, ops) in calls.items():
            bound, by = _bound(nbytes, ops)
            rows[name] = {"ms": _time_ms(fn), "device_ms": _device_ms(fn)[0],
                          "bound_ms": bound, "bound_by": by}
            r = rows[name]
            share = r["bound_ms"] / r["device_ms"]
            print(f"  codec frame {label:9s} {name:20s} device "
                  f"{r['device_ms']:.4f} ms ({share:.0%} of the bound "
                  f"{r['bound_ms']:.4f}), events {r['ms']:.4f}")
        out[label] = rows
    return out


def _launched(kq, call, route: str, label: str, what: str = "quantize"):
    """``call()``, checked by the launch counters to launch the
    quantizer (``what="dequantize"``: the dequantizer) kernel of
    ``route`` and no other kernel."""
    routes = kq.QUANT_ROUTES if what == "quantize" else kq.DEQUANT_ROUTES
    before = dict(kq.LAUNCHES)
    out = call()
    took = {k for k in kq.LAUNCHES if kq.LAUNCHES[k] != before[k]}
    check(took == {routes[route]},
          f"{what} {label}: launched {took}, expected route {route}")
    return out


def _wire_times(frame, acc, base, vel, tw: float) -> dict:
    """The kernel rows of the codec and stage-update kernels: each timed
    beside its plain version, its library call and its bound, on one
    activation ``frame`` at tile 256 (int8, both quantizer routes) and
    one float32 parameter leaf ``acc`` (with ``base`` and ``vel`` for
    momentum)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    n, esize = frame.numel(), frame.element_size()
    q, s = kq.quantize_tiles(frame, tile=256, bits=8)
    t_count = s.numel()
    tw_t = torch.tensor(tw, dtype=torch.float32, device="cuda")
    leaf_n = acc.numel()
    # the dequantizer's write floor: a fill of its float32 output writes
    # the same bytes and reads nothing (a yardstick; the port never
    # calls it)
    out32 = torch.empty(t_count * 256, device="cuda")
    floor = {"ms": _time_ms(lambda: out32.fill_(0)),
             "device_ms": _device_ms(lambda: out32.fill_(0))[0],
             "bytes": 4 * n}
    print(f"  {'fill floor':16s} device {floor['device_ms']:.4f} ms, events "
          f"{floor['ms']:.4f} ms (fill_ of the dequantizer's "
          f"{4 * n / 1e6:.1f} MB float32 output)")
    rows = {
        # float in, int8 codes + float32 scales out; abs, max, divide,
        # round and clip a value.  Both routes on the same frame
        "quantize": _time_triple(
            "quantize", lambda: kq.quantize_tiles(frame, tile=256, bits=8),
            lambda: kq.quantize_reference(frame, 256, 8), None,
            esize * n + n + 4 * t_count, 5 * n),
        "quantize_generic": _time_triple(
            "quantize_generic",
            lambda: kq._launch_quantize("generic", frame, 256, 8),
            lambda: kq.quantize_reference(frame, 256, 8), None,
            esize * n + n + 4 * t_count, 5 * n),
        # int8 codes + scales in, float32 out; one multiply a value.
        # library: one broadcast multiply of the codes by their scales
        "dequantize": _time_triple(
            "dequantize", lambda: kq.dequantize_tiles(q, s, tile=256,
                                                       bits=8),
            lambda: kq.dequantize_reference(q, s, 256, 8),
            lambda: torch.mul(q.view(t_count, 256), s[:, None]),
            n + 4 * t_count + 4 * n, n),
        "dequantize_generic": _time_triple(
            "dequantize_generic",
            lambda: kq._launch_dequantize("generic", q, s, 256, 8),
            lambda: kq.dequantize_reference(q, s, 256, 8),
            lambda: torch.mul(q.view(t_count, 256), s[:, None]),
            n + 4 * t_count + 4 * n, n),
        # float32 in and out; one divide.  library: torch.div
        "finalize": _time_triple(
            "finalize", lambda: ku.finalize_leaf(acc, tw, torch.float32),
            lambda: ku.finalize_reference(acc, tw, torch.float32),
            lambda: torch.div(acc, tw_t), 8 * leaf_n, leaf_n),
        # acc, base, velocity in; params, velocity out; five operations.
        # No single PyTorch call computes both outputs
        "momentum": _time_triple(
            "momentum", lambda: ku.momentum_leaf(acc, base, vel, tw, 0.9,
                                                 torch.float32),
            lambda: ku.momentum_reference(acc, base, vel, tw, 0.9,
                                          torch.float32), None,
            20 * leaf_n, 5 * leaf_n),
    }
    for name in kq.DEQUANT_ROUTES.values():
        rows[name]["fill_floor"] = floor
    return rows


def _generic_times(g) -> dict:
    """Rows 4b and 5b at the shapes their routes serve, on VGG's frame:
    the generic quantizer at the wire-slow codec's int8 tile 64 on the
    bf16 activation and the float32 gradient frame, the generic
    dequantizer on int8 codes at tile 100 and int4 codes at tile 48
    (tiles the vec kernel does not take).  Each by events and profiler
    device time beside its bytes bound and a fill of the same output
    bytes (codes, or float32 values: a floor of one launch and its
    writes, not a library call)."""
    from split_learning_torch.ops.kernels import quant as kq

    def row(label, fn, nbytes, fill):
        r = {"ms": _time_ms(fn), "device_ms": _device_ms(fn)[0],
             "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fill_floor_device_ms": _device_ms(fill)[0]}
        print(f"  {label:40s} device {r['device_ms']:.4f} ms, events "
              f"{r['ms']:.4f}, bound {r['bound_ms']:.5f} ms "
              f"({nbytes} B), fill floor {r['fill_floor_device_ms']:.4f}")
        return r

    out = {"quantize_generic": {}, "dequantize_generic": {}}
    frames = {}
    for dtype in (torch.bfloat16, torch.float32):
        frames[dtype] = (torch.randn(VGG_FRAME_SHAPE, generator=g,
                                     device="cuda") * 3).to(dtype)
        x = frames[dtype]
        label = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} int8 tile 64"
        q, s = _launched(kq, lambda: kq.quantize_tiles(x, tile=64, bits=8),
                         "generic", label)
        out["quantize_generic"][label] = row(
            f"quantize_generic {label}",
            lambda: kq._launch_quantize("generic", x, 64, 8),
            x.numel() * x.element_size() + q.numel() + 4 * s.numel(),
            lambda: q.fill_(0))
    x = frames[torch.bfloat16]
    for label, tile, bits in (("int8 tile 100", 100, 8),
                              ("int4 tile 48", 48, 4)):
        q, s = kq.quantize_tiles(x, tile=tile, bits=bits)
        out32 = torch.empty(s.numel() * tile, device="cuda")
        _launched(kq, lambda: kq.dequantize_tiles(q, s, tile=tile,
                                                  bits=bits),
                  "generic", label, "dequantize")
        out["dequantize_generic"][label] = row(
            f"dequantize_generic {label}",
            lambda: kq._launch_dequantize("generic", q, s, tile, bits),
            q.numel() + 4 * s.numel() + 4 * out32.numel(),
            lambda: out32.fill_(0))
    return out


def phase_wire_kernels() -> dict:
    """The quantizer (each case on the route it names), dequantizer and
    stage-update kernels against their plain versions, bit for bit —
    among the cases the VGG round's own shapes, its main path — then
    timed (:func:`_wire_times`) at those shapes: the bf16 cut-7 frame
    (32 x 16 x 16 x 64, tile 256; the float32 gradient frame beside it)
    and layer 50's float32 (4096 x 4096) leaf.  The TinyLlama shapes
    timed by earlier slices (an 8 x 256 x 2048 bf16 frame and the
    32000 x 2048 leaf, with the :data:`CODEC_FRAMES`) stand beside
    them in each row's ``tinyllama_shapes``."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    g = torch.Generator(device="cuda").manual_seed(23)

    def wire_frame(dtype):
        x = (torch.randn(FRAME_SHAPE, generator=g, device="cuda") * 3).to(
            dtype)
        flat = x.view(-1)
        flat[256 * 5:256 * 6] = 0               # an all-zero tile
        flat[256 * 9 + 17] = float("nan")       # a NaN tile
        flat[256 * 12 + 3] = float("inf")       # an inf tile
        return x

    frame = wire_frame(torch.bfloat16)
    frame16, frame32 = wire_frame(torch.float16), wire_frame(torch.float32)
    odd = torch.randn(1001, generator=g, device="cuda") * 2
    odd[40] = float("-inf")
    # a ragged leaf whose last tile (and, in bf16, last 16-byte chunk)
    # is partial
    ragged = (torch.randn(256 * 37 + 77, generator=g, device="cuda")
              * 3).to(torch.bfloat16)
    # 2 bytes off 16-byte alignment: the generic route
    shifted = frame.view(-1)[1:1 + 256 * 64]
    vgg16 = (torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda")
             * 3).to(torch.bfloat16)
    vgg32 = torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda") * 1e-3
    b3_16 = (torch.randn(B3_FRAME_SHAPES[1], generator=g, device="cuda")
             * 3).to(torch.bfloat16)
    b3_32 = torch.randn(B3_FRAME_SHAPES[1], generator=g,
                        device="cuda") * 1e-3
    bert16 = (torch.randn(BERT_FRAME_SHAPE, generator=g, device="cuda")
              * 3).to(torch.bfloat16)
    bert32 = torch.randn(BERT_FRAME_SHAPE, generator=g,
                         device="cuda") * 1e-3
    cases = [("ResNet frame bf16 int8 tile 256", b3_16, 256, 8, "vec"),
             ("ResNet frame f32 int8 tile 256", b3_32, 256, 8, "vec"),
             ("BERT frame bf16 int8 tile 256", bert16, 256, 8, "vec"),
             ("BERT frame f32 int8 tile 256", bert32, 256, 8, "vec")]
    for bits in (8, 4):
        cases += [
            (f"VGG frame bf16 int{bits} tile 256", vgg16, 256, bits, "vec"),
            (f"VGG frame f32 int{bits} tile 256", vgg32, 256, bits, "vec"),
            (f"slice frame bf16 int{bits} tile 256", frame, 256, bits, "vec"),
            (f"frame fp16 int{bits} tile 256", frame16, 256, bits, "vec"),
            (f"frame f32 int{bits} tile 256", frame32, 256, bits, "vec"),
            (f"bf16 int{bits} tile 1024", frame, 1024, bits, "vec"),
            (f"f32 int{bits} tile 1024", frame32, 1024, bits, "vec"),
            (f"bf16 int{bits} tile 2048", frame, 2048, bits, "generic"),
            (f"bf16 int{bits} tile 64", frame, 64, bits, "generic"),
            (f"ragged bf16 int{bits} tile 256 n=9549", ragged, 256, bits,
             "vec"),
            (f"ragged f32 int{bits} tile 256 n=1001", odd, 256, bits,
             "vec"),
            (f"ragged f32 int{bits} tile 7 n=1001", odd, 7, bits,
             "generic"),
            (f"view +2 B bf16 int{bits} tile 256", shifted, 256, bits,
             "generic")]
    # the generic route at the shapes it serves: the wire-slow codec's
    # tile 64 on VGG's bf16 activation and float32 gradient frames, tiles
    # the vec kernel does not take (128, 100, 48, 768), a tile one value
    # wider than a block's span (read in windows, twice) and a leaf 2
    # bytes off alignment, each frame with an all-zero, a NaN and an inf
    # tile
    def with_bad_tiles(x):
        x = x.clone()
        flat = x.view(-1)
        flat[64 * 20:64 * 24] = 0             # all-zero tiles
        flat[64 * 36 + 17] = float("nan")     # a NaN tile
        flat[64 * 48 + 3] = float("inf")      # an inf tile
        return x

    vgg16_bad, vgg32_bad = with_bad_tiles(vgg16), with_bad_tiles(vgg32)
    wide = GENERIC_SPAN_VALUES_BF16 + 1
    for bits in (8, 4):
        cases += [
            (f"VGG frame bf16 int{bits} tile 64", vgg16_bad, 64, bits,
             "generic"),
            (f"VGG frame f32 int{bits} tile 64", vgg32_bad, 64, bits,
             "generic"),
            (f"VGG frame bf16 int{bits} tile 128", vgg16_bad, 128, bits,
             "generic"),
            (f"VGG frame bf16 int{bits} tile 100", vgg16_bad, 100, bits,
             "generic"),
            (f"VGG frame bf16 int{bits} tile 48", vgg16_bad, 48, bits,
             "generic"),
            (f"VGG frame bf16 int{bits} tile 768", vgg16_bad, 768, bits,
             "generic"),
            (f"VGG frame bf16 int{bits} tile {wide}", vgg16_bad, wide,
             bits, "generic"),
            (f"VGG view +2 B bf16 int{bits} tile 64",
             vgg16_bad.view(-1)[1:], 64, bits, "generic")]
    for label, x, tile, bits, route in cases:
        q, s = _launched(kq, lambda: kq.quantize_tiles(x, tile=tile,
                                                       bits=bits),
                         route, label)
        qr, sr = kq.quantize_reference(x, tile, bits)
        torch.cuda.synchronize()
        _bitwise("quantize", label + " codes", q, qr)
        _bitwise("quantize", label + " scales", s, sr)
        # fresh codes are aligned: a tile of whole 16-byte code chunks
        # (16 int8 or 32 int4 codes) takes the vec dequantizer, any other
        # the generic one; the same codes 1 and 3 bytes off 16-byte
        # alignment take the generic one
        droute = "vec" if tile % kq.CHUNK_CODES[bits] == 0 else "generic"
        d = _launched(kq, lambda: kq.dequantize_tiles(q, s, tile=tile,
                                                      bits=bits),
                      droute, label, "dequantize")
        dr = kq.dequantize_reference(q, s, tile, bits)
        torch.cuda.synchronize()
        _bitwise("dequantize", f"{label} {droute}", d, dr)
        for off in (1, 3):
            q1 = torch.empty(q.numel() + 16, dtype=q.dtype,
                             device="cuda")[off:off + q.numel()]
            q1.copy_(q)
            d1 = _launched(kq, lambda: kq.dequantize_tiles(
                q1, s, tile=tile, bits=bits), "generic",
                f"{label} codes +{off} B", "dequantize")
            torch.cuda.synchronize()
            _bitwise("dequantize", f"{label} codes +{off} B generic", d1,
                     dr)
        # the round trip is within half a quantization step per tile
        n = x.numel()
        xf = torch.nn.functional.pad(x.reshape(-1).float(),
                                     (0, s.numel() * tile - n))
        err = (d - xf).reshape(-1, tile).abs().amax(dim=1)
        ok = torch.isfinite(s)
        check(bool((err[ok] <= s[ok] / 2 * 1.0001).all()),
              f"dequantize {label}: round trip beyond half a step")
        check(bool((~ok).sum() == (~torch.isfinite(
            xf.reshape(-1, tile))).any(dim=1).sum()),
              f"quantize {label}: NaN scales do not mark the bad tiles")
    # Edge tiles, bitwise against the plain version on both routes:
    # amax = qmax, so scale 1, holding values half-way between two codes
    # (round half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0); and a float32
    # tile whose amax / 127 underflows to a zero scale (its values
    # decode to zeros, so it has no round trip to check).
    for bits in (8, 4):
        qmax = 127.0 if bits == 8 else 7.0
        ties = torch.tensor([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5],
                            device="cuda").repeat(32)
        ties[7] = qmax
        tiny = torch.zeros(256, device="cuda")
        tiny[:4] = torch.tensor([3e-45, -3e-45, 1.4e-45, -0.0])
        edges = [(f"ties bf16 int{bits}", ties.to(torch.bfloat16)),
                 (f"ties f32 int{bits}", ties),
                 (f"zero scale f32 int{bits}", tiny)]
        for label, x in edges:
            for route in kq.QUANT_ROUTES:
                q, s = _launched(kq, lambda: kq._launch_quantize(
                    route, x, 256, bits), route, label)
                qr, sr = kq.quantize_reference(x, 256, bits)
                torch.cuda.synchronize()
                _bitwise("quantize", f"{label} {route} codes", q, qr)
                _bitwise("quantize", f"{label} {route} scales", s, sr)
                dr = kq.dequantize_reference(q, s, 256, bits)
                for droute in kq.DEQUANT_ROUTES:
                    d = _launched(kq, lambda: kq._launch_dequantize(
                        droute, q, s, 256, bits), droute, label,
                        "dequantize")
                    torch.cuda.synchronize()
                    _bitwise("dequantize", f"{label} {route} {droute}", d,
                             dr)

    acc = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 50
    small = torch.randn(4096, 64, generator=g, device="cuda") * 50
    tw = 64.0   # the slice's fold weight: two edge clients x 32 samples
    ties = torch.arange(-40, 40, device="cuda").float() * 32.0
    # a contiguous view 4 bytes off 16-byte alignment: the scalar
    # prologue, then float4 loads with element stores
    shifted = acc.view(-1)[1:]
    finalize_cases = [("leaf f32", acc, torch.float32, False),
                      ("leaf bf16", acc, torch.bfloat16, False),
                      ("leaf fp16", acc, torch.float16, False),
                      ("int32 with rounding", small, torch.int32, True),
                      ("odd 0.5 ties int32", ties, torch.int32, True),
                      ("view +4 B f32", shifted, torch.float32, False),
                      ("view +4 B bf16", shifted, torch.bfloat16, False)]
    for r in (1, 2, 3):   # ragged leaves: the scalar epilogue
        ragged = small.view(-1)[:4096 + r]
        finalize_cases += [(f"ragged n%4={r} f32", ragged, torch.float32,
                            False),
                           (f"ragged n%4={r} bf16", ragged, torch.bfloat16,
                            False),
                           (f"ragged n%4={r} int32 rnd", ragged,
                            torch.int32, True)]
    # the VGG round's leaves: layer 50's Dense kernel and a statistics
    # leaf, folded over its four clients' weights
    vgg_acc = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda") * 50
    vgg_stat = torch.rand(VGG_STATS_SHAPE, generator=g, device="cuda") * 9
    vgg_tw = 4 * 2496.0
    b3_acc = torch.randn(B3_LEAF_SHAPE, generator=g, device="cuda") * 50
    b3_tw = 2 * 2496.0
    bert_acc = torch.randn(BERT_LEAF_SHAPE, generator=g, device="cuda") * 50
    bert_tw = 2 * 512.0
    finalize_cases += [("BERT leaf 28996x768 f32", bert_acc, torch.float32,
                        False),
                       ("ResNet leaf 512x512x3x3 f32", b3_acc,
                        torch.float32, False),
                       ("VGG leaf 4096x4096 f32", vgg_acc, torch.float32,
                        False),
                       ("VGG statistics (64,) f32", vgg_stat, torch.float32,
                        False)]
    for label, a, dt, rnd in finalize_cases:
        _bitwise("finalize", label, ku.finalize_leaf(a, tw, dt, rnd=rnd),
                 ku.finalize_reference(a, tw, dt, rnd))
    base = torch.randn(LEAF_SHAPE, generator=g, device="cuda")
    vel = torch.randn(LEAF_SHAPE, generator=g, device="cuda") * 0.01
    vgg_base = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda")
    vgg_vel = torch.randn(VGG_LEAF_SHAPE, generator=g, device="cuda") * 0.01
    b3_base = torch.randn(B3_LEAF_SHAPE, generator=g, device="cuda")
    b3_vel = torch.randn(B3_LEAF_SHAPE, generator=g, device="cuda") * 0.01
    bert_base = torch.randn(BERT_LEAF_SHAPE, generator=g, device="cuda")
    bert_vel = torch.randn(BERT_LEAF_SHAPE, generator=g, device="cuda") * 0.01
    momentum_cases = [
        ("leaf", acc, base, vel, tw),
        ("BERT leaf 28996x768", bert_acc, bert_base, bert_vel, bert_tw),
        ("ResNet leaf 512x512x3x3", b3_acc, b3_base, b3_vel, b3_tw),
        ("VGG leaf 4096x4096", vgg_acc, vgg_base, vgg_vel, vgg_tw),
        ("VGG statistics (64,)", vgg_stat, vgg_stat * 0.5,
         vgg_stat * 0.01, vgg_tw)]
    for label, a, b, v, w in momentum_cases:
        p, nv = ku.momentum_leaf(a, b, v, w, 0.9, torch.float32)
        pr, nvr = ku.momentum_reference(a, b, v, w, 0.9, torch.float32)
        _bitwise("momentum", f"{label} params", p, pr)
        _bitwise("momentum", f"{label} velocity", nv, nvr)
    p, nv = ku.momentum_leaf(small, small * 0.5, small * 0.1, 3.0, 0.5,
                             torch.bfloat16)
    pr, nvr = ku.momentum_reference(small, small * 0.5, small * 0.1, 3.0,
                                    0.5, torch.bfloat16)
    _bitwise("momentum", "bf16 params", p, pr)
    _bitwise("momentum", "bf16 velocity", nv, nvr)

    # times at the VGG round's shapes, then at the TinyLlama shapes
    print("  times at the VGG round's shapes (frame bf16 "
          f"{VGG_FRAME_SHAPE} tile 256, leaf f32 {VGG_LEAF_SHAPE}):")
    vgg_frame = (torch.randn(VGG_FRAME_SHAPE, generator=g, device="cuda")
                 * 3).to(torch.bfloat16)
    out = _wire_times(vgg_frame, vgg_acc, vgg_base, vgg_vel, vgg_tw)
    vgg_frames = _codec_frames(g, VGG_FRAME_SHAPE, VGG_CODEC_FRAMES)
    print("  rows 4b and 5b at their routes' own shapes (VGG's frame):")
    for name, rows in _generic_times(g).items():
        out[name]["own_shapes"] = rows
    print("  times at the TinyLlama shapes (frame bf16 "
          f"{FRAME_SHAPE} tile 256, leaf f32 {LEAF_SHAPE}):")
    tiny = _wire_times(frame, acc, base, vel, tw)
    tiny["quantize"]["frames"] = _codec_frames(g, FRAME_SHAPE, CODEC_FRAMES)
    for name, r in out.items():
        r["shapes"] = ("frame bf16 (32, 16, 16, 64) tile 256"
                       if name.startswith(("quantize", "dequantize"))
                       else "leaf f32 (4096, 4096)")
        r["tinyllama_shapes"] = tiny[name]
    out["quantize"]["frames"] = vgg_frames
    # config 3's shapes: each frame with the ResNet leaf
    b3 = {}
    for shape in B3_FRAME_SHAPES:
        print(f"  times at config 3's shapes (frame bf16 {shape} tile 256, "
              f"leaf f32 {B3_LEAF_SHAPE}):")
        frame_b3 = (torch.randn(shape, generator=g, device="cuda")
                    * 3).to(torch.bfloat16)
        b3[shape] = _wire_times(frame_b3, b3_acc, b3_base, b3_vel, b3_tw)
    for name, r in out.items():
        if name.startswith(("quantize", "dequantize")):
            r["baseline3_shapes"] = {
                f"frame bf16 {shape} tile 256": b3[shape][name]
                for shape in B3_FRAME_SHAPES}
        else:
            r["baseline3_shapes"] = {
                f"leaf f32 {B3_LEAF_SHAPE}": b3[B3_FRAME_SHAPES[0]][name]}
    # the BERT protocol round's shapes: its bf16 activation frame (the
    # float32 gradient frame beside it) and the word-embedding leaf
    print(f"  times at the BERT round's shapes (frame bf16 "
          f"{BERT_FRAME_SHAPE} tile 256, leaf f32 {BERT_LEAF_SHAPE}):")
    bert = _wire_times(bert16, bert_acc, bert_base, bert_vel, bert_tw)
    bert["quantize"]["frames"] = _codec_frames(
        g, BERT_FRAME_SHAPE, (("f32 int8", torch.float32, 8),))
    for name, r in out.items():
        r["bert_shapes"] = bert[name]
    return out


# --------------------------------------------------------------------------
# 4. the slice: one round of full-width TinyLlama-1.1B
# --------------------------------------------------------------------------

def slice_config(workdir: pathlib.Path):
    """``configs/baseline5.yaml`` with use_flash, 128 samples (4 steps),
    2 validation batches of 8, and checkpoints and logs in ``workdir``."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / "configs" / "baseline5.yaml")
    mk = dict(cfg.model_kwargs or {})
    mk["use_flash"] = True
    cfg = dataclasses.replace(
        cfg, model_kwargs=mk, val_max_batches=2, val_batch_size=8,
        distribution=dataclasses.replace(cfg.distribution, num_samples=128),
        checkpoint=dataclasses.replace(cfg.checkpoint,
                                       directory=str(workdir / "ckpt")),
        log_path=str(workdir / "logs")).validate()
    return cfg


def phase_slice(cfg) -> dict:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.run import run_local
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    mk = cfg.model_kwargs
    lrn = cfg.learning
    print(f"  config: {cfg.model_key} {dict(mk)} clients={list(cfg.clients)} "
          f"cuts={list(cfg.topology.cut_layers)} batch={lrn.batch_size} "
          f"control-count={lrn.control_count} {lrn.optimizer} "
          f"{cfg.compute_dtype} samples={cfg.distribution.num_samples}")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    result = run_local(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)

    check(len(result.history) == 1, f"expected 1 round, got "
          f"{len(result.history)}")
    rec = result.history[0]
    check(rec.ok, f"round not ok: {rec}")
    check(math.isfinite(rec.val_loss) and math.isfinite(rec.val_accuracy),
          f"non-finite validation: {rec}")
    # the bf16 kernels are the tensor-core ones; the _simt kernels are
    # the float32 route and must not run here
    for name, n in launches.items():
        if name in SIMT_KERNELS:
            check(n == 0, f"the float32-route {name} ran {n} times on the "
                  "bf16 main path")
        else:
            check(n > 0, f"kernel {name} was not launched on the main path")
    steps = max(1, (cfg.distribution.num_samples // lrn.batch_size)
                // lrn.control_count)
    check(rec.num_samples == steps * lrn.control_count * lrn.batch_size,
          f"samples {rec.num_samples}")
    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == 1, "checkpoint missing")
    n_block = mk.get("n_block", 22)
    for layer in ("layer1", f"layer{n_block + 3}"):
        for key, t in ck["params"][layer].items():
            check(torch.equal(t, result.params[layer][key].cpu()),
                  f"checkpoint {layer}.{key} differs from the result")
    # launches per training step: the round also runs the forward kernel
    # once per block for the pipeline's one-sample width probe and once
    # per block per validation batch
    per_step = {
        "flash_fwd": (launches["flash_fwd"]
                      - n_block * (1 + cfg.val_max_batches)) / steps,
        "flash_bwd_dkv": launches["flash_bwd_dkv"] / steps,
        "flash_bwd_dq": launches["flash_bwd_dq"] / steps}
    # forward twice per block per microbatch under the wide remat policy
    check(per_step["flash_fwd"] == 2 * n_block * lrn.control_count,
          f"tensor-core forward launches per step {per_step['flash_fwd']}, "
          f"expected {2 * n_block * lrn.control_count}")
    # the backward once per block per microbatch
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        check(per_step[name] == n_block * lrn.control_count,
              f"tensor-core {name} launches per step {per_step[name]}, "
              f"expected {n_block * lrn.control_count}")
    seq = 256
    tokens = rec.num_samples * seq
    out = {"round_wall_s": rec.wall_s, "run_local_wall_s": wall,
           "train_tokens": tokens, "train_tokens_per_s": tokens / rec.wall_s,
           "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps, "launches": launches,
           "launches_per_step": per_step}
    print(f"  round wall {rec.wall_s:.3f} s (run_local {wall:.3f} s), "
          f"{tokens} training tokens, {out['train_tokens_per_s']:.1f} "
          f"tokens/s, val_loss {rec.val_loss:.4f} val_acc "
          f"{rec.val_accuracy:.4f}, peak memory "
          f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
          f"launches {launches} over {steps} steps, per training step "
          f"{per_step} (expected {n_block * lrn.control_count} for each "
          f"backward kernel and twice that for the forward under remat)")
    return out


def _kernel_name(key: str) -> str:
    """``void (anonymous namespace)::k<T, 64>(args)`` -> ``k<T, 64>``."""
    key = key.replace("(anonymous namespace)::", "")
    return key.removeprefix("void ").split("(")[0]


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


@dataclasses.dataclass
class _DeviceTotal:
    """One name's device activity in a trace: what ``key_averages()``
    gives for it (``key``, ``count``, ``self_device_time_total`` in µs)."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def _device_totals(prof) -> list:
    """The traced run's device activity (kernels, copies, fills) summed
    by name, straight from the profiler's kineto events: the same
    numbers as ``key_averages()`` over the device events, without
    building torch's event tree for every host and device event of the
    run (which took 15.4-56.8 s a traced phase on the H100)."""
    from torch.autograd import DeviceType
    totals: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        t = totals.get(ev.name())
        if t is None:
            t = totals[ev.name()] = _DeviceTotal(ev.name())
        t.count += 1
        t.self_device_time_total += ev.duration_ns() / 1e3
    return [t for t in totals.values() if t.self_device_time_total > 0]


def phase_profile(cfg) -> dict:
    """Where the time goes: the slice's round once more, warm (after the
    counted main-path run, whose launches it does not touch), with the
    device's kernels traced by ``torch.profiler`` (device activity only:
    tracing every host op of a round costs minutes) and summed by name
    (:func:`_device_totals`)."""
    from torch.profiler import ProfilerActivity, profile

    from split_learning_torch.run import run_local
    cfg = dataclasses.replace(
        cfg, checkpoint=dataclasses.replace(cfg.checkpoint, save=False))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_local(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_end = time.perf_counter()
    kernels = _device_totals(prof)
    # the trace's collection and summing, outside the run
    trace_s = time.perf_counter() - t_end
    busy_s = sum(_device_us(e) for e in kernels) / 1e6
    walls = [r.wall_s for r in res.history]
    print(f"  profiled run: round walls {[round(w, 3) for w in walls]} s, "
          f"run {wall:.3f} s, device busy {busy_s:.3f} s = "
          f"{busy_s / wall:.1%} of the run (idle {1 - busy_s / wall:.1%}); "
          f"trace collection and sums {trace_s:.3f} s")
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    for e in top:
        print(f"    {_device_us(e) / 1e3:10.1f} ms {e.count:8d}x  "
              f"{e.key[:90]}")
    flash = [e for e in kernels if "flash_" in e.key]
    for e in flash:
        print(f"    flash: {_device_us(e) / 1e3:.1f} ms {e.count}x  "
              f"{_kernel_name(e.key)}")
    return {"round_walls_s": walls, "run_wall_s": wall,
            "trace_s": trace_s,
            "device_busy_s": busy_s, "idle_share": 1 - busy_s / wall,
            "top_kernels": [{"name": e.key[:120], "count": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in top],
            "flash_kernels": [{"name": _kernel_name(e.key),
                               "count": e.count,
                               "device_ms": _device_us(e) / 1e3}
                              for e in flash]}


# --------------------------------------------------------------------------
# 6. the protocol round: server + client threads over the in-process bus
# --------------------------------------------------------------------------

def _print_heartbeats(counts: list) -> tuple:
    """Print the heartbeat frames and bytes a run's clients published
    (``counts``: each client's ``(frames, bytes)``; the telemetry plane
    is on in every default round) and return their sums."""
    frames, nbytes = (sum(c[i] for c in counts) for i in (0, 1))
    print(f"  heartbeats: {frames} frames, {nbytes} bytes from "
          f"{len(counts)} clients")
    return frames, nbytes


def run_protocol(cfg, timeout: float = 600.0, profiles: dict | None = None):
    """The protocol deployment through the port's entry point
    (``run_inproc``: the server in this thread, one client thread per
    client over a shared ``InProcTransport``, each registering its entry
    of ``profiles``) on the card."""
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import run_inproc
    try:
        # the server's protocol log goes to its run directory only
        run = run_inproc(cfg, device=DEVICE, client_timeout=timeout,
                         logger=Logger.for_run(cfg, "server",
                                               console=False),
                         profiles=profiles)
    except Exception as e:
        raise SmokeFailure(f"protocol round failed: {e!r} "
                           f"(cause: {e.__cause__!r})") from e
    _print_heartbeats([c.heartbeats for c in run.clients])
    return run.server, run.clients, run.bus, run.result


def run_protocol_tcp_threads(cfg, timeout: float = 600.0):
    """The protocol deployment with every frame over TCP, participants
    in threads of this process: a :class:`Broker` on a free port, and the
    server and each client building their transport stack from the
    config (``make_runtime_transport``: TCP, receive prefetch, the async
    sender)."""
    import threading as th
    from split_learning_torch.runtime.bus import Broker
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import ProtocolServer
    broker = Broker("127.0.0.1", 0)
    errors = []
    try:
        cfg = dataclasses.replace(cfg, transport=dataclasses.replace(
            cfg.transport, kind="tcp", port=broker.port))
        server = ProtocolServer(cfg, device=DEVICE, client_timeout=timeout,
                                logger=Logger.for_run(cfg, "server"))
        clients = [ProtocolClient(cfg, f"client_{s}_{i}", s, device=DEVICE)
                   for s, n in enumerate(cfg.clients, start=1)
                   for i in range(n)]

        def run(c):
            try:
                c.run()
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        threads = [th.Thread(target=run, args=(c,), daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        res = server.serve()
        for t in threads:
            t.join(timeout=120)
    except Exception as e:
        raise SmokeFailure(f"TCP protocol round failed: {e!r}") from e
    finally:
        broker.close()
    check(not errors and not any(t.is_alive() for t in threads),
          f"TCP protocol client failed: {errors}")
    return res


TINY_PROTOCOL = {
    "model": "TinyLlama", "dataset": "TINYSTORIES", "clients": [1, 1, 1],
    "global-rounds": 2, "synthetic-size": 64, "val-max-batches": 2,
    "val-batch-size": 4, "compute-dtype": "float32",
    "model-kwargs": {"vocab_size": 128, "hidden_size": 64, "num_heads": 4,
                     "num_kv_heads": 2, "intermediate_size": 128,
                     "n_block": 2, "use_flash": True},
    "topology": {"cut-layers": [2, 3]}, "distribution": {"num-samples": 32},
    "aggregation": {"strategy": "fedavg", "sharded": True,
                    "server-momentum": 0.9},
    "transport": {"codec": {"intermediate": "int8", "gradient": "int8"}},
    "learning": {"batch-size": 4, "control-count": 1, "optimizer": "adamw",
                 "learning-rate": 1e-3},
    "checkpoint": {"save": False},
}


def phase_protocol_check(workdir: pathlib.Path) -> dict:
    """A tiny float32 protocol round (3 stages, int8 codec, CUDA fold
    with momentum) on the card twice: every kernel flag on, then every
    flag off (the plain chains on the card).  With one batch in flight
    each stage steps in a fixed order, and each kernel equals its plain
    version bit for bit, so the two runs' validation losses and final
    parameters must agree to float32 noise (1e-5: cuBLAS may pick other
    GEMM algorithms between the runs).  Then the kernels-on round once
    more with every frame over TCP (participants in threads, the async
    sender), held to the in-process one the same way.  Its float32 forward and backward
    take the float32-route kernels: returns their launches, and the codec
    kernels' (either quantizer route may run here), in the first run."""
    from split_learning_torch.config import from_dict
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq

    runs = []
    for flags in (True, False):
        d = dict(TINY_PROTOCOL, **{"log-path": str(workdir / f"tiny{flags}"),
                                   "kernels": {"quantize": flags,
                                               "dequantize": flags,
                                               "stage-update": flags}})
        fa.reset_launches()
        kq.reset_launches()
        _, _, _, res = run_protocol(from_dict(d), timeout=120)
        if flags:
            codec = dict(kq.LAUNCHES)
            simt = {n: fa.LAUNCHES[n] for n in SIMT_KERNELS}
            check(all(simt.values()) and not any(
                fa.LAUNCHES[n] for n in fa.LAUNCHES if n not in simt),
                  f"tiny float32 round: flash launches {fa.LAUNCHES}, "
                  "expected the float32-route kernels only")
        check([r.ok for r in res.history] == [True, True],
              f"tiny protocol round not ok: {res.history}")
        runs.append(res)
    on, off = runs
    loss_err = max(abs(a.val_loss - b.val_loss)
                   for a, b in zip(on.history, off.history))
    param_err = max(float((on.params[layer][k] - t).abs().max())
                    for layer, sd in off.params.items()
                    for k, t in sd.items())
    print(f"  tiny protocol round, kernels on vs plain chains: val_loss "
          f"{[round(r.val_loss, 6) for r in on.history]} vs "
          f"{[round(r.val_loss, 6) for r in off.history]}, max |loss "
          f"diff| {loss_err:.3e}, max |param diff| {param_err:.3e} "
          "(tol 1e-5)")
    check(loss_err <= 1e-5 and param_err <= 1e-5,
          "tiny protocol round: kernels disagree with the plain chains")
    # the same kernels-on round with every frame over TCP: the codec,
    # fetch and encode of each activation and gradient run on the async
    # sender thread, on the training thread's stream
    d = dict(TINY_PROTOCOL, **{"log-path": str(workdir / "tiny_tcp"),
                               "kernels": {"quantize": True,
                                           "dequantize": True,
                                           "stage-update": True}})
    tcp = run_protocol_tcp_threads(from_dict(d), timeout=120)
    tcp_loss = max(abs(a.val_loss - b.val_loss)
                   for a, b in zip(on.history, tcp.history))
    tcp_param = max(float((on.params[layer][k] - t).abs().max())
                    for layer, sd in tcp.params.items()
                    for k, t in sd.items())
    print(f"  tiny protocol round over TCP (async sender) vs in process: "
          f"samples {[r.num_samples for r in tcp.history]}, max |loss "
          f"diff| {tcp_loss:.3e}, max |param diff| {tcp_param:.3e} "
          "(tol 1e-5)")
    check([r.num_samples for r in tcp.history]
          == [r.num_samples for r in on.history]
          and tcp_loss <= 1e-5 and tcp_param <= 1e-5,
          "tiny protocol round over TCP differs from the in-process one")
    print(f"  tiny float32 round: float32-route kernels launched {simt}, "
          f"codec kernels {codec}")
    return {**simt, **codec}


#: the protocol rounds' TinyLlama depth: 11 of its 22 blocks at full
#: width, cut in the YAML's proportions (its rounds move every weight as
#: float32 START and UPDATE frames, so their walls follow the depth)
PROTOCOL_BLOCKS = 11
PROTOCOL_CUTS = (1, 6, 9)


def protocol_config(workdir: pathlib.Path, momentum: float, rounds: int):
    """``configs/baseline5.yaml`` as the protocol slice runs it:
    use_flash, :data:`PROTOCOL_BLOCKS` of its 22 blocks cut at
    :data:`PROTOCOL_CUTS` (the YAML's ``[1, 12, 18]`` at half depth, for
    the script's time), ``clients: [2, 1, 1, 1]``, an int8 codec on both
    cut directions, every kernel flag on, the sharded fold with
    ``server-momentum`` = ``momentum``; 32 samples (4 steps of 8) per
    edge client per round, 2 validation batches of 8."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / "configs" / "baseline5.yaml")
    mk = dict(cfg.model_kwargs or {})
    mk["use_flash"] = True
    mk["n_block"] = PROTOCOL_BLOCKS
    return dataclasses.replace(
        cfg, model_kwargs=mk, clients=(2, 1, 1, 1), global_rounds=rounds,
        topology=dataclasses.replace(cfg.topology,
                                     cut_layers=PROTOCOL_CUTS),
        val_max_batches=2, val_batch_size=8,
        distribution=dataclasses.replace(cfg.distribution, num_samples=32),
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, strategy="fedavg", sharded=True,
            server_momentum=momentum),
        checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=str(workdir / "ckpt_protocol")),
        log_path=str(workdir / "logs_protocol")).validate()


def phase_protocol(workdir: pathlib.Path) -> dict:
    from split_learning_torch.runtime.bus import queue_family
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    reset, read = _reset_launches, _launch_counts

    cfg = protocol_config(workdir, momentum=0.9, rounds=2)
    mk, lrn = cfg.model_kwargs, cfg.learning
    print(f"  config: {cfg.model_key} {dict(mk)} clients={list(cfg.clients)}"
          f" cuts={list(cfg.topology.cut_layers)} batch={lrn.batch_size} "
          f"control-count={lrn.control_count} {lrn.optimizer} "
          f"{cfg.compute_dtype} samples/edge client={cfg.distribution.num_samples}"
          f" codec={cfg.transport.codec} momentum "
          f"{cfg.aggregation.server_momentum} rounds {cfg.global_rounds}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    server, clients, bus, res = run_protocol(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()

    n_edge = cfg.clients[0]
    want = n_edge * cfg.distribution.num_samples
    check(len(res.history) == 2, f"expected 2 rounds, got {res.history}")
    for rec in res.history:
        check(rec.ok, f"protocol round not ok: {rec}")
        check(math.isfinite(rec.val_loss), f"non-finite validation: {rec}")
        check(rec.num_samples == want,
              f"round {rec.round_idx}: {rec.num_samples} samples, "
              f"expected {want}")
    fold = server.ctx.last_fold
    check(fold.folded == sum(cfg.clients), f"folded {fold.folded}")
    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == 2, "checkpoint missing")
    for layer, sd in res.params.items():
        for key, t in sd.items():
            check(torch.equal(ck["params"][layer][key], t.cpu()),
                  f"checkpoint {layer}.{key} differs from the result")
    peak = torch.cuda.max_memory_allocated()

    # data-plane bytes per queue family, and the codec's dense bf16
    # equivalent (the compression ratio's denominator)
    actual = _family_bytes(bus)
    raw: dict = {}
    for c in clients:
        for q, nb in c.raw_bytes_out.items():
            raw[queue_family(q)] = raw.get(queue_family(q), 0) + nb
    wire = {fam: {"bytes": actual.get(fam, 0), "raw_bytes": raw.get(fam),
                  "ratio": (raw[fam] / actual[fam]
                            if raw.get(fam) and actual.get(fam) else None)}
            for fam in ("intermediate", "gradient", "rpc", "reply")}

    phases = server.ctx.round_phases

    # the plain-FedAvg round: only it runs the finalize kernel.  Its
    # device kernels are traced (CUDA activity only), for the device's
    # busy and idle share over a protocol round
    from torch.profiler import ProfilerActivity, profile
    cfg0 = protocol_config(workdir / "m0", momentum=0.0, rounds=1)
    torch.cuda.synchronize()
    reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        server0, _, _, res0 = run_protocol(cfg0)
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t1
    launches0 = read()
    busy_s = sum(_device_us(t) for t in _device_totals(prof)) / 1e6
    check([r.ok for r in res0.history] == [True]
          and math.isfinite(res0.history[0].val_loss),
          f"plain FedAvg protocol round failed: {res0.history}")
    total = {k: launches[k] + launches0[k] for k in launches}
    for name, n in total.items():
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the bf16 protocol path")
        else:
            check(n > 0, f"kernel {name} was not launched on the protocol "
                  "path")
    # the backward once per block per training batch of the round; the
    # vec quantizer and the dequantizer once per training batch per cut
    # per direction
    batches = n_edge * cfg.distribution.num_samples // lrn.batch_size
    per_round = mk.get("n_block", 22) * batches
    frames = batches * len(cfg.topology.cut_layers) * 2
    for name, want in (("flash_bwd_dkv", per_round),
                       ("flash_bwd_dq", per_round), ("quantize", frames),
                       ("dequantize", frames)):
        got = (launches[name] / len(res.history), launches0[name])
        check(got == (want, want), f"{name} launches per protocol round "
              f"{got}, expected {want}")

    seq = 256
    rounds = [{"round": r.round_idx, "wall_s": r.wall_s,
               "samples": r.num_samples, "val_loss": r.val_loss,
               "train_tokens_per_s": r.num_samples * seq / r.wall_s}
              for r in res.history]
    out = {"rounds": rounds, "run_wall_s": wall,
           "max_memory_allocated_bytes": peak, "wire": wire,
           "launches": launches, "launches_per_round": {
               k: v / len(res.history) for k, v in launches.items()},
           "phases": phases,
           "plain_fedavg_round": {"wall_s": res0.history[0].wall_s,
                                  "run_wall_s": wall0,
                                  "val_loss": res0.history[0].val_loss,
                                  "phases": server0.ctx.round_phases,
                                  "device_busy_s": busy_s,
                                  "idle_share_of_run": 1 - busy_s / wall0,
                                  "launches": launches0},
           "launches_total": total, "fold_update_s": fold.update_s,
           "fold_s": fold.fold_s}
    for r, ph in zip(rounds, phases):
        print(f"  round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_tokens_per_s']:.1f} "
              f"training tokens/s, val_loss {r['val_loss']:.4f}; phases "
              + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()))
    print(f"  protocol run {wall:.3f} s, peak memory {peak / 2**30:.2f} "
          f"GiB, last fold {fold.fold_s:.3f} s (update {fold.update_s:.3f}"
          f" s), launches {launches}")
    for fam, w in wire.items():
        print(f"  wire over {len(rounds)} rounds: {fam:12s} "
              f"{w['bytes']:>14d} B"
              + (f" (dense bf16 {w['raw_bytes']} B, ratio "
                 f"{w['ratio']:.3f})" if w["ratio"] else ""))
    print(f"  plain FedAvg round: wall {res0.history[0].wall_s:.3f} s, "
          f"run {wall0:.3f} s, val_loss {res0.history[0].val_loss:.4f}, "
          f"phases {server0.ctx.round_phases}, device busy {busy_s:.3f} "
          f"s = {busy_s / wall0:.1%} of the run (idle "
          f"{1 - busy_s / wall0:.1%}), launches {launches0}")
    return out


# --------------------------------------------------------------------------
# 7. protocol_tcp: the deployment shape, one process per participant
# --------------------------------------------------------------------------

#: the prefix of the one JSON line each participant runner prints
PARTICIPANT_TAG = "chip_smoke participant: "


def _launch_counts() -> dict:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    return {**fa.LAUNCHES, **kq.LAUNCHES, **ku.LAUNCHES}


def participant_main(argv: list) -> int:
    """``chip_smoke.py --participant MODULE ARG...``: run one protocol
    participant, ``MODULE.main(ARG...)``, in this process, then print one
    line, :data:`PARTICIPANT_TAG` and a JSON object: the process's kernel
    launch counts (sender thread included) and its peak device memory."""
    import importlib
    module, args = argv[0], argv[1:]
    t0 = time.perf_counter()
    role = importlib.import_module(module).main(args)
    wall = time.perf_counter() - t0
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    # the role's async sender: seconds waited for room, in thunks (codec,
    # fetch, encode) and on the socket
    bus = getattr(role, "bus", None) or getattr(
        getattr(role, "ctx", None), "bus", None)
    print(PARTICIPANT_TAG + json.dumps({
        "module": module, "argv": args, "wall_s": wall,
        "heartbeats": getattr(role, "heartbeats", None),
        "sender": {k: getattr(bus, k) for k in (
            "send_hwm", "publish_wait_s", "thunk_s", "send_s")
            if hasattr(bus, k)},
        "launches": _launch_counts(),
        "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated() if cuda else 0,
        "max_memory_reserved_bytes":
            torch.cuda.max_memory_reserved() if cuda else 0}), flush=True)
    return 0


class _SmiPoll:
    """The card's used memory by ``nvidia-smi``, polled every second in
    a thread while a phase runs; :attr:`peak_mib` is the largest
    reading."""

    def __init__(self):
        self.peak_mib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.split()
                self.peak_mib = max([self.peak_mib, *map(int, out[:1])])
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
            self._stop.wait(1.0)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=60)
        return self.peak_mib


def _read_port(log: pathlib.Path, proc, deadline: float) -> int:
    while time.monotonic() < deadline:
        text = log.read_text()
        if "python broker on" in text:
            return int(text.split("python broker on ")[1].split()[0]
                       .rsplit(":", 1)[1])
        check(proc.poll() is None, f"broker exited: {text[-2000:]}")
        time.sleep(0.1)
    raise SmokeFailure("broker did not start")


def _answers(fn, *args) -> bool:
    """Whether ``fn(*args)`` returns without a connection error."""
    try:
        fn("127.0.0.1", *args, timeout=1.0)
        return True
    except (OSError, ConnectionError):
        return False


def _metrics(log_path: pathlib.Path) -> list:
    """Every metrics record the participants wrote under ``log_path``."""
    return [json.loads(line)
            for f in sorted(log_path.glob("artifacts/runs/*/metrics.jsonl"))
            for line in f.read_text().splitlines() if line.strip()]


def _run_tcp(d: pathlib.Path, make_cfg, timeout: float, shards: int = 1,
             during=None, broker_rc: int = 0) -> tuple:
    """One protocol deployment as processes, all on ``cuda:0``: one
    ``python -m split_learning_torch.broker`` and, through
    :func:`participant_main`, one ``split_learning_torch.server`` and one
    ``split_learning_torch.client`` per configured client, over TCP
    (async sender and receive prefetch, as ``make_runtime_transport``
    builds them).  ``make_cfg(d)`` gives the configuration, whose
    transport is pointed at the broker here.  With ``shards`` > 1 the
    broker is the ``--shards`` supervisor of that many shard processes on
    a block of ports (``find_port_block``) and ``broker.shards`` says so;
    ``during(d, spawn, base)``, when given, runs in a thread beside the
    participants (``spawn(name, argv)`` starts a process in the group).
    The broker must exit ``broker_rc`` when stopped.  All run in one
    process group, killed on any failure.  Returns (the configuration,
    the wall, the broker's stats frame — a list of every shard's with
    ``shards`` > 1 —, each participant's report, the card's peak used
    memory by ``nvidia-smi``)."""
    from split_learning_torch.config import to_dict
    from split_learning_torch.runtime.bus import (
        BROKER_STATS_QUEUE, TcpTransport, broker_stats,
        collect_broker_stats, find_port_block,
    )

    d.mkdir(parents=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()   # this process's cache from earlier phases
    procs: dict = {}
    group = None

    def spawn(name: str, args: list):
        nonlocal group
        log = d / f"{name}.log"
        procs[name] = (subprocess.Popen(
            [sys.executable, *args], cwd=HERE, stdout=log.open("w"),
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONUNBUFFERED": "1"},
            process_group=0 if group is None else group), log)
        if group is None:
            group = procs[name][0].pid
        return procs[name][0]

    deadline = time.monotonic() + timeout
    smi = _SmiPoll()
    t0 = time.perf_counter()
    side: dict = {}
    try:
        if shards > 1:
            port = find_port_block(shards)
            broker = spawn("broker", ["-m", "split_learning_torch.broker",
                                      "--shards", str(shards), "--port",
                                      str(port)])
            while not all(_answers(broker_stats, port + i)
                          for i in range(shards)):
                check(broker.poll() is None and time.monotonic() < deadline,
                      "broker plane did not start: "
                      + procs["broker"][1].read_text()[-2000:])
                time.sleep(0.1)
        else:
            broker = spawn("broker", ["-m", "split_learning_torch.broker",
                                      "--port", "0"])
            port = _read_port(procs["broker"][1], broker, deadline)
        cfg = make_cfg(d)
        cfg = dataclasses.replace(
            cfg, transport=dataclasses.replace(cfg.transport, kind="tcp",
                                               port=port),
            broker=dataclasses.replace(cfg.broker, shards=shards))
        cfg_path = d / "config.json"   # JSON is YAML
        cfg_path.write_text(json.dumps(to_dict(cfg)))
        common = ["--config", str(cfg_path), "--device", DEVICE]
        me = [str(HERE / "chip_smoke.py"), "--participant"]
        spawn("server", [*me, "split_learning_torch.server", *common,
                         "--client_timeout", str(timeout)])
        for s, n in enumerate(cfg.clients, start=1):
            for i in range(n):
                cid = f"client_{s}_{i}"
                spawn(cid, [*me, "split_learning_torch.client", *common,
                            "--layer_id", str(s), "--client_id", cid])
        participants = [n for n in procs if n != "broker"]
        watcher = None
        if during is not None:
            def watch():
                try:
                    during(d, spawn, port)
                except BaseException as e:  # noqa: BLE001 — raised below
                    side["error"] = e
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
        for name in participants:
            p, log = procs[name]
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{name} missed the {timeout:.0f} s "
                                   "deadline") from None
            check(rc == 0, f"{name} exited {rc}: "
                  f"{log.read_text()[-3000:]}")
        wall = time.perf_counter() - t0
        if watcher is not None:
            watcher.join(timeout=60)
            if "error" in side:
                raise SmokeFailure(f"{side['error']!r}") from side["error"]
        if shards > 1:
            stats = collect_broker_stats("127.0.0.1", port, shards,
                                         timeout=30)
        else:
            probe = TcpTransport("127.0.0.1", port)
            stats = json.loads(bytes(probe.get(BROKER_STATS_QUEUE, 30)))
            probe.close()
        broker.terminate()
        check(broker.wait(timeout=30) == broker_rc,
              f"broker exited {broker.returncode}, not {broker_rc}")
    finally:
        card_peak_mib = smi.stop()
        if group is not None:
            try:
                os.killpg(group, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p, _ in list(procs.values()):
            p.wait(timeout=30)

    reports = {}
    for name in participants:
        log = procs[name][1]
        lines = [ln for ln in log.read_text().splitlines()
                 if ln.startswith(PARTICIPANT_TAG)]
        check(len(lines) == 1, f"{name} printed no report")
        reports[name] = json.loads(lines[0][len(PARTICIPANT_TAG):])
    _print_heartbeats([r["heartbeats"] for r in reports.values()
                       if r.get("heartbeats") is not None])
    return cfg, wall, stats, reports, card_peak_mib


def phase_protocol_tcp(workdir: pathlib.Path, inproc: dict,
                       timeout: float = 900.0) -> dict:
    """The protocol round in its deployment shape (:func:`_run_tcp`):
    the broker, the server and one process per client of ``clients: [2,
    1, 1, 1]``, at the in-process ``protocol`` phase's configuration
    (FedAvgM 0.9), one round.  ``inproc`` is that phase's result: the
    samples and the kernel launches must equal its run's a round."""
    cfg, wall, stats, reports, card_peak_mib = _run_tcp(
        workdir / "tcp",
        lambda d: protocol_config(d, momentum=0.9, rounds=1), timeout)
    launches = {k: sum(r["launches"].get(k, 0) for r in reports.values())
                for k in reports["server"]["launches"]}

    records = _metrics(pathlib.Path(cfg.log_path))
    phases = [r for r in records if r.get("kind") == "phases"]
    aggs = [r for r in records if r.get("kind") == "agg"]
    rounds = sorted((r for r in records if r.get("kind") == "round"),
                    key=lambda r: r["round_idx"])
    n_rounds = cfg.global_rounds
    check(len(rounds) == len(phases) == len(aggs) == n_rounds,
          f"expected {n_rounds} rounds, phases and folds: {len(rounds)}, "
          f"{len(phases)}, {len(aggs)}")
    want = [r["samples"] for r in inproc["rounds"]]
    for rec, agg, n in zip(rounds, aggs, want):
        check(rec["ok"] and math.isfinite(rec["val_loss"]),
              f"TCP round not ok: {rec}")
        check(rec["num_samples"] == n, f"TCP round {rec['round_idx']}: "
              f"{rec['num_samples']} samples, in-process {n}")
        check(agg["folded"] == sum(cfg.clients),
              f"TCP round folded {agg['folded']} of {sum(cfg.clients)}")
    for name, n in launches.items():
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the TCP path")
    for name in ("quantize", "dequantize", "momentum", "flash_fwd",
                 "flash_bwd_dkv", "flash_bwd_dq"):
        check(launches[name] > 0, f"kernel {name} was not launched on "
              "the TCP path")
        inproc_n = inproc["launches_per_round"][name] * n_rounds
        check(launches[name] == inproc_n, f"{name}: {launches[name]} "
              f"launches over TCP, {inproc_n} in process")

    out = {
        "run_wall_s": wall, "rounds": [
            {"round": r["round_idx"], "wall_s": r["wall_s"],
             "samples": r["num_samples"], "val_loss": r["val_loss"]}
            for r in rounds],
        "phases": [{k: v for k, v in p.items() if k.endswith("_s")}
                   for p in phases],
        "inproc_phases": inproc["phases"],
        "launches": launches,
        "launches_per_round": {k: v / n_rounds for k, v in launches.items()},
        "broker": {k: stats[k] for k in (
            "bytes_in", "bytes_out", "published", "delivered", "depth_hwm",
            "stored_bytes_hwm", "get_timeouts", "backpressure_pauses",
            "published_bytes_by_family", "delivered_bytes_by_family")},
        "processes": {n: {k: r[k] for k in (
            "wall_s", "max_memory_allocated_bytes",
            "max_memory_reserved_bytes", "sender")}
            for n, r in reports.items()},
        # the server's send queue: cumulative at each round's end
        "server_sender": [{k: w[k] for k in w if k.startswith(
            "cumulative_")} for w in records if w.get("kind") == "wire"],
        "card_memory_used_peak_mib": card_peak_mib,
    }
    for r, p, q in zip(out["rounds"], out["phases"], inproc["phases"]):
        print(f"  TCP round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, val_loss {r['val_loss']:.4f}; "
              "phases " + ", ".join(
                  f"{k} {v:.3f} (in process {q.get(k, float('nan')):.3f})"
                  for k, v in p.items()))
    print(f"  TCP run {wall:.3f} s; broker in {stats['bytes_in']} B, out "
          f"{stats['bytes_out']} B, published by family "
          f"{stats['published_bytes_by_family']}, queue high-water "
          f"{stats['stored_bytes_hwm']} B, backpressure pauses "
          f"{stats['backpressure_pauses']}")
    for n, r in out["processes"].items():
        print(f"  {n}: peak allocated "
              f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
              f"reserved {r['max_memory_reserved_bytes'] / 2**30:.2f} GiB, "
              f"wall {r['wall_s']:.1f} s, sender {r['sender']}")
    print(f"  server send queue at each round's end: {out['server_sender']}")
    print(f"  card memory used, peak by nvidia-smi: {card_peak_mib} MiB; "
          f"launches {launches}")
    return out


# --------------------------------------------------------------------------
# 8. step_check; 9-11. the default round: VGG16/CIFAR10 with BatchNorm
# statistics
# --------------------------------------------------------------------------

def yaml_config(workdir: pathlib.Path, path: str):
    """The YAML at ``path`` as written, with its checkpoints and logs in
    ``workdir``."""
    from split_learning_torch.config import from_yaml

    cfg = from_yaml(HERE / path)
    return dataclasses.replace(
        cfg, checkpoint=dataclasses.replace(
            cfg.checkpoint, directory=str(workdir / "ckpt")),
        log_path=str(workdir / "logs")).validate()


def _reset_launches() -> None:
    from split_learning_torch.ops import flash_attention as fa
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    for mod in (fa, kq, ku):
        mod.reset_launches()


def _expected_samples(cfg, protocol: bool,
                      n_clients: int | None = None) -> int:
    """A round's samples: every training stage-1 client's (all of them
    unless ``n_clients`` says) loader batches in the protocol round,
    whole M-batch steps in process."""
    lrn = cfg.learning
    batches = cfg.distribution.num_samples // lrn.batch_size
    if not protocol:
        steps = max(1, batches // lrn.control_count)
        batches = min(steps * lrn.control_count, batches)
    n = cfg.clients[0] if n_clients is None else n_clients
    return n * batches * lrn.batch_size


def _check_stats_checkpoint(cfg, result, rounds: int) -> None:
    """The checkpoint holds the run's last parameters and the BatchNorm
    statistics of every layer of ``cfg``'s model that holds one (VGG16's
    13; ResNet-50's 17, a bottleneck's nested ones under its layer;
    none for ViT), counted on the model built on the meta device."""
    from split_learning_torch.models import build_model
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    stats_layers = len(build_model(
        cfg.model_key, device="meta", generator=torch.Generator(),
        **(cfg.model_kwargs or {})).stats_tree())
    ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
    check(ck is not None and ck["round_idx"] == rounds,
          f"checkpoint missing or at the wrong round: "
          f"{ck and ck['round_idx']}")
    check(len(result.stats) == stats_layers
          and len(ck["batch_stats"]) == stats_layers,
          f"statistics of {len(result.stats)} layers, checkpoint "
          f"{len(ck['batch_stats'])}, expected {stats_layers}")
    for tree, ck_tree in ((result.params, ck["params"]),
                          (result.stats, ck["batch_stats"])):
        for layer, leaves in tree.items():
            for key, t in leaves.items():
                check(torch.equal(ck_tree[layer][key], t.cpu()),
                      f"checkpoint {layer}.{key} differs from the result")
                check(bool(torch.isfinite(t).all()),
                      f"non-finite {layer}.{key}")


#: the step checks: (label, model key, cuts, batch, microbatches,
#: BatchNorms, layers whose gradients are also held alone, bounds on the
#: card's distance from the CPU's float32 step: loss relative, each
#: statistic of its leaf's largest value; None: only the float64 ones;
#: LoRA rank, 0 for a step of every parameter)
STEP_CHECKS = (
    ("VGG16", "VGG16_CIFAR10", [7], 32, 4, 13, ("layer1", "layer47"),
     {"loss_rel": 1e-5, "stats_of_largest": 1e-4}, 0),
    ("ResNet-50", "ResNet50_CIFAR100", [3, 6], 16, 2, 53, ("layer1",),
     None, 0),
    ("ViT-S/16", "ViT_S16_CIFAR10", [10], 16, 2, 0, ("layer1",), None, 0),
    ("KWT-1", "KWT_SPEECHCOMMANDS", [2], 32, 2, 0, ("layer1", "layer4"),
     None, 0),
    ("BERT-base LoRA", "BERT_AGNEWS", [4], 4, 2, 0, ("layer2", "layer15"),
     None, 8))


def _tree_norm_err(tree, ref) -> float:
    num = sum(float((tree[k] - t).double().norm() ** 2)
              for k, t in ref.items())
    den = sum(float(t.double().norm() ** 2) for t in ref.values())
    return (num / den) ** 0.5


def _step_adapters(ref, rank: int) -> dict:
    """LoRA adapters over ``ref``'s target kernels (the model's last
    layer excluded), on the CPU, with ``b`` drawn too: at peft's init
    (``b`` zeros) every ``a`` would have a zero gradient."""
    from split_learning_torch.ops.lora import lora_init, split_frozen
    gen = torch.Generator().manual_seed(1)
    frozen, _ = split_frozen(ref.state_tree(), [ref.specs[-1].name])
    lora = lora_init(gen, frozen, ref, rank=rank)
    for entries in lora.values():
        for entry in entries.values():
            entry["b"] = torch.randn(entry["b"].shape, generator=gen) * 0.02
    return lora


def _pad_token_rows(x: torch.Tensor) -> None:
    """Padding in a (M, mb, S) batch of token ids: a row padded after 20
    tokens and a row of padding but its CLS token (the synthetic AG-News
    set has none)."""
    x[0, 1, 20:] = 0
    x[-1, 0, 1:] = 0


def phase_step_check() -> dict:
    """One float32 train step of each :data:`STEP_CHECKS` model (VGG16
    cut 7, 4 microbatches of 32; ResNet-50 cuts ``[3, 6]`` and ViT-S/16
    cut ``[10]``, 2 microbatches of 16; KWT-1 cut 2, 2 of 32; BERT-base
    with LoRA rank 8 cut 4, 2 of 4 with padded rows) on the CPU, on the
    card and in float64 on the CPU, from the same weights, statistics and
    batch, with dropout off (rate 0, as in every parity recipe).  The
    LoRA row trains its adapters (``b`` drawn non-zero, so every factor
    has a gradient) and the classifier, the base frozen.  TF32 is off,
    so the card's convs and GEMMs are IEEE float32 (cuDNN, cuBLAS), as
    oneDNN's are on the CPU; the two sum in different orders.  Batch-16
    BatchNorm training through ResNet-50's 53 BatchNorms amplifies that
    noise, and a pre-activation within float32 noise of zero flips its
    ReLU mask, which moves a few gradient entries by their whole value.
    So each quantity is held against the float64 step: the card's loss,
    running statistics and gradients (the whole tree in norm, and each
    listed layer's) no farther from it than twice the CPU's float32 step
    is, plus 1e-5 of the loss, 1e-5 of a statistic leaf's largest value
    and 1e-3 of the gradients' norm.  A row with card-vs-CPU bounds is
    also held to them."""
    import numpy as np

    from split_learning_torch.data import make_data_loader
    from split_learning_torch.models import build_model
    from split_learning_torch.models.split import Dropout
    from split_learning_torch.parallel.pipeline import PipelineModel
    from split_learning_torch.runtime.validation import dataset_for_model

    out = {}
    for label, key, cuts, batch, n_micro, n_bn, alone, vs_cpu, rank in \
            STEP_CHECKS:
        loader = make_data_loader(dataset_for_model(key), batch,
                                  train=True, seed=3, synthetic_size=256)
        batches = list(loader)[:n_micro]
        x = torch.from_numpy(np.stack([b[0] for b in batches]))
        y = torch.from_numpy(np.stack([b[1] for b in batches])
                             .astype(np.int32))
        if not x.is_floating_point():
            _pad_token_rows(x)
        ref = build_model(key, generator=torch.Generator().manual_seed(0))
        params, stats = ref.state_tree(), ref.stats_tree()
        lora0 = _step_adapters(ref, rank) if rank else None
        head = ref.specs[-1].name
        del ref
        runs = {}
        for side, dev, dtype in (("cpu", "cpu", torch.float32),
                                 (DEVICE, DEVICE, torch.float32),
                                 ("float64", "cpu", torch.float64)):
            model = build_model(key, device=dev, dtype=dtype)
            model.load_state_tree(params)
            model.load_stats_tree(stats)
            model.to(dtype)
            for mod in model.modules():
                if isinstance(mod, Dropout):
                    mod.rate = 0.0
            model.train()
            xin = x.to(dev, dtype) if x.is_floating_point() else x.to(dev)
            pipe = PipelineModel(model, cuts, example_input=xin[0],
                                 num_microbatches=n_micro)
            lora = None
            if lora0 is not None:
                lora = {k: {n: {f: t.detach().to(dev, dtype).requires_grad_()
                                for f, t in e.items()}
                            for n, e in v.items()}
                        for k, v in lora0.items()}
                for name, mod in model.layers.items():
                    mod.requires_grad_(name == head)
                pipe.lora = (lora, 16.0, rank)
            loss = pipe.accumulate(xin, y.to(dev))
            grads = {f"{name}.{n}": p.grad.double().cpu()
                     for name, mod in model.layers.items()
                     for n, p in mod.named_parameters()
                     if p.grad is not None}
            for layer, entries in (lora or {}).items():
                for k, e in entries.items():
                    grads.update({f"{layer}.{k}.lora_{f}":
                                  t.grad.double().cpu()
                                  for f, t in e.items()})
            runs[side] = {
                "loss": float(loss),
                "stats": {f"{k}.{n}": t.double().cpu()
                          for k, v in model.stats_tree().items()
                          for n, t in v.items()},
                "grads": grads}
            del model, pipe, lora
        f64 = runs["float64"]
        check(len(f64["grads"]) > 0 and all(
            float(g.abs().max()) > 0 for k, g in f64["grads"].items()
            if ".lora_" in k), f"{label}: a LoRA factor has no gradient")
        res = {"loss": {s: r["loss"] for s, r in runs.items()},
               "trained_leaves": len(f64["grads"])}
        for side in ("cpu", DEVICE):
            r = runs[side]
            check(set(r["grads"]) == set(f64["grads"]),
                  f"{label}: {side} trained other leaves than float64")
            res[side] = {
                "loss_err": abs(r["loss"] - f64["loss"]),
                "stats_err_of_largest": max(
                    (float((r["stats"][k] - t).abs().max()
                           / t.abs().max()) for k, t in f64["stats"].items()),
                    default=0.0),
                "grad_norm_err": _tree_norm_err(r["grads"], f64["grads"]),
                **{f"{layer}_grad_norm_err": _tree_norm_err(
                    r["grads"], {k: t for k, t in f64["grads"].items()
                                 if k.startswith(f"{layer}.")})
                   for layer in alone}}
        cpu, card = runs["cpu"], runs[DEVICE]
        res["card_vs_cpu"] = {
            "loss_rel_err": abs(card["loss"] - cpu["loss"])
            / abs(cpu["loss"]),
            "stats_err_of_largest": max(
                (float((card["stats"][k] - t).abs().max() / t.abs().max())
                 for k, t in cpu["stats"].items()), default=0.0)}
        print(f"  one float32 {label} step (cuts {cuts}, {n_micro} x "
              f"{batch}), CPU and card vs float64: {res}")
        cpu, card = res["cpu"], res[DEVICE]
        check(card["loss_err"] <= 2 * cpu["loss_err"]
              + 1e-5 * abs(f64["loss"]), f"{label}: card loss off by "
              f"{card['loss_err']:.3g} (CPU {cpu['loss_err']:.3g})")
        check(card["stats_err_of_largest"] <= 2 * cpu["stats_err_of_largest"]
              + 1e-5, f"{label}: card statistics off by "
              f"{card['stats_err_of_largest']:.3g} of a leaf's largest value")
        for k in card:
            if k.endswith("grad_norm_err"):
                check(card[k] <= 2 * cpu[k] + 1e-3, f"{label}: card {k} "
                      f"{card[k]:.3g} (CPU {cpu[k]:.3g})")
        if vs_cpu is not None:
            got = res["card_vs_cpu"]
            check(got["loss_rel_err"] <= vs_cpu["loss_rel"],
                  f"{label}: card loss differs from the CPU's by "
                  f"{got['loss_rel_err']:.3g} relative")
            check(got["stats_err_of_largest"] <= vs_cpu["stats_of_largest"],
                  f"{label}: card statistics differ from the CPU's by "
                  f"{got['stats_err_of_largest']:.3g} of a leaf's largest "
                  f"value")
        check(len(f64["stats"]) == 2 * n_bn,
              f"{label}: {len(f64['stats'])} statistic leaves, expected "
              f"{2 * n_bn}")
        out[label] = res
    return out


#: the kernels on the VGG protocol path (every flag on): the codec on
#: both cut directions and the stage update of the sharded fold
VGG_PATH_KERNELS = ("quantize", "quantize_generic", "dequantize",
                    "dequantize_generic", "finalize", "momentum")
#: the in-process VGG runs: (label, YAML, rounds; None: the YAML's).
#: Baseline 1 runs 1 of its 5 rounds, so that the script keeps to about
#: ten minutes with configs 3 and 4 beside it
VGG_SLICES = (("config", "config.yaml", None),
              ("baseline1", "configs/baseline1.yaml", 1))


def _run_slice(label: str, cfg) -> dict:
    """``run_local`` on ``cfg`` with every launch counter zeroed before
    and read after (every ``kernels:`` flag is off, so no kernel of the
    port may launch: the KernelPlan gate); checks each round's samples
    and validation and the checkpoint's parameters and statistics, and
    prints each round's wall, training samples/s, peak memory over its
    training (the round record's, taken before validation) and
    validation."""
    from split_learning_torch.run import run_local

    lrn = cfg.learning
    print(f"  {label}: {cfg.model_key} clients={list(cfg.clients)} "
          f"cuts={list(cfg.topology.cut_layers)} batch="
          f"{lrn.batch_size} control-count={lrn.control_count} "
          f"{lrn.optimizer} lr {lrn.learning_rate} weight decay "
          f"{lrn.weight_decay} {cfg.compute_dtype} "
          f"samples/client={cfg.distribution.num_samples} rounds "
          f"{cfg.global_rounds} remat {lrn.remat} model-kwargs "
          f"{cfg.model_kwargs}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    result = run_local(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    check(not any(launches.values()), f"{label}: kernels launched with "
          f"every kernels flag off: {launches}")
    check(len(result.history) == cfg.global_rounds,
          f"{label}: {len(result.history)} rounds")
    want = _expected_samples(cfg, protocol=False)
    rounds = []
    for rec in result.history:
        check(rec.ok and math.isfinite(rec.val_loss)
              and math.isfinite(rec.val_accuracy)
              and rec.train_peak_memory_bytes is not None,
              f"{label}: round not ok: {rec}")
        check(rec.num_samples == want, f"{label} round "
              f"{rec.round_idx}: {rec.num_samples} samples, expected "
              f"{want}")
        rounds.append({"round": rec.round_idx, "wall_s": rec.wall_s,
                       "samples": rec.num_samples,
                       "train_samples_per_s": rec.num_samples
                       / rec.wall_s, "val_loss": rec.val_loss,
                       "val_accuracy": rec.val_accuracy,
                       "train_peak_memory_bytes":
                       rec.train_peak_memory_bytes})
    _check_stats_checkpoint(cfg, result, cfg.global_rounds)
    peak = torch.cuda.max_memory_allocated()
    for r in rounds:
        print(f"  {label} round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_samples_per_s']:.1f} "
              f"training samples/s, training peak memory "
              f"{r['train_peak_memory_bytes'] / 2**30:.2f} GiB, "
              f"val_loss {r['val_loss']:.4f} val_acc "
              f"{r['val_accuracy']:.4f}")
    print(f"  {label}: run_local {wall:.3f} s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}")
    return {"run_local_wall_s": wall, "rounds": rounds,
            "max_memory_allocated_bytes": peak, "launches": launches}


def phase_vgg_slice(workdir: pathlib.Path) -> dict:
    """``run_local`` on ``config.yaml`` (1 round, ``clients: [1, 1]``)
    and on ``configs/baseline1.yaml`` (``[2, 2]``: two lockstep
    columns; 1 of its 5 rounds), each as written otherwise:
    VGG16/CIFAR10 in bfloat16 compute, cut at layer 7, SGD with
    momentum, FedAvg, validation on the 2000 synthetic test images, a
    checkpoint (:func:`_run_slice`).  Each run's loop-owned span journal
    and ``kind=round`` phases are read again (:func:`check_loop_trace`)."""
    out = {}
    for label, path, rounds in VGG_SLICES:
        cfg = yaml_config(workdir / f"vgg_{label}", path)
        if rounds is not None:
            cfg = dataclasses.replace(cfg, global_rounds=rounds)
        out[label] = _run_slice(label, cfg)
        check_loop_trace(label, cfg.log_path, cfg.global_rounds)
    return out


def vgg_protocol_config(workdir: pathlib.Path, momentum: float):
    """``configs/baseline1.yaml`` as the protocol slice runs it: one
    round, an int8 codec on both cut directions, every kernel flag on,
    the sharded (CUDA) fold with ``server-momentum`` = ``momentum``."""
    cfg = yaml_config(workdir, "configs/baseline1.yaml")
    return dataclasses.replace(
        cfg, global_rounds=1,
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, sharded=True,
            server_momentum=momentum)).validate()


def _hold_on_path(kq, ku, held: dict, seen: dict) -> dict:
    """Wrap the codec and stage-update wrappers so that every launch the
    path makes is held, bit for bit, against the kernel's plain version
    on the same inputs (no kernel launched for it).  ``held`` gathers,
    per kernel, the launches held by input shape and dtype, the
    mismatches and the seconds the holding took; ``seen`` the
    quantizer's input dtypes.  Returns the originals to restore."""
    originals = {(kq, "quantize_tiles"): kq.quantize_tiles,
                 (kq, "dequantize_tiles"): kq.dequantize_tiles,
                 (ku, "finalize_leaf"): ku.finalize_leaf,
                 (ku, "momentum_leaf"): ku.momentum_leaf}
    lock = threading.Lock()

    def hold(name, x, out, ref_fn):
        t0 = time.perf_counter()
        outs = out if isinstance(out, tuple) else (out,)
        ref = ref_fn()
        refs = ref if isinstance(ref, tuple) else (ref,)
        same = all(o.dtype == r.dtype and o.shape == r.shape
                   and torch.equal(_bits(o), _bits(r))
                   for o, r in zip(outs, refs))
        key = f"{tuple(x.shape)} {x.dtype}".replace("torch.", "")
        with lock:
            h = held.setdefault(name, {"launches": 0, "by_input": {},
                                       "mismatches": [], "s": 0.0})
            h["launches"] += 1
            h["by_input"][key] = h["by_input"].get(key, 0) + 1
            if not same:
                h["mismatches"].append(key)
            h["s"] += time.perf_counter() - t0

    def quantize_tiles(x, *, tile, bits):
        with lock:
            seen[str(x.dtype)] = seen.get(str(x.dtype), 0) + 1
        out = originals[kq, "quantize_tiles"](x, tile=tile, bits=bits)
        hold("quantize", x, out,
             lambda: kq.quantize_reference(x, tile, bits))
        return out

    def dequantize_tiles(q, scale, *, tile, bits):
        out = originals[kq, "dequantize_tiles"](q, scale, tile=tile,
                                                bits=bits)
        hold("dequantize", q, out,
             lambda: kq.dequantize_reference(q, scale, tile, bits))
        return out

    def finalize_leaf(acc, tw, dtype, *, rnd=False):
        out = originals[ku, "finalize_leaf"](acc, tw, dtype, rnd=rnd)
        hold("finalize", acc, out,
             lambda: ku.finalize_reference(acc, tw, dtype, rnd))
        return out

    def momentum_leaf(acc, base, vel, tw, m, dtype):
        out = originals[ku, "momentum_leaf"](acc, base, vel, tw, m, dtype)
        hold("momentum", acc, out, lambda: ku.momentum_reference(
            acc, base, vel, tw, m, dtype))
        return out

    kq.quantize_tiles, kq.dequantize_tiles = quantize_tiles, dequantize_tiles
    ku.finalize_leaf, ku.momentum_leaf = finalize_leaf, momentum_leaf
    return originals


def _check_held(path: str, m: float, held: dict, launches: dict) -> None:
    """One protocol run's held launches (:func:`_hold_on_path`): print
    them, and check that none differs from the kernel's plain version and
    that as many were held as the launch counters counted."""
    for name in ("quantize", "dequantize", "finalize", "momentum"):
        h = held.get(name, {"launches": 0, "by_input": {},
                            "mismatches": [], "s": 0.0})
        counted = launches[name] + launches.get(f"{name}_generic", 0)
        print(f"  momentum {m}: {name:10s} {h['launches']} launches "
              f"held against the plain version ({h['s']:.3f} s), "
              f"{len(h['mismatches'])} differ; by input "
              f"{h['by_input']}")
        check(not h["mismatches"], f"{name} differs from its plain "
              f"version on the {path} path at {h['mismatches']}")
        check(h["launches"] == counted, f"{name}: {h['launches']} "
              f"launches held, {counted} counted")


def _check_path_kernels(path: str, cfg, launches_by_m: dict, seen: dict,
                        samples: int) -> dict:
    """A protocol path's kernel launches over its momentum round
    (``launches_by_m[0.9]``) and its plain FedAvg round (``[0.0]``): no
    off-path kernel, each of the four path kernels launched (momentum in
    the momentum round, finalize in the plain one), the quantizer handed
    both frame dtypes, and one activation and one gradient frame per
    training batch of ``cfg`` at each of its cuts.  Returns the launches
    over both rounds."""
    total: dict = {}
    for launches in launches_by_m.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    for name, n in total.items():
        if name in OFF_PATH_KERNELS:
            check(n == 0, f"{name} ran {n} times on the {path} path")
    for name in ("quantize", "dequantize", "momentum", "finalize"):
        check(total[name] > 0, f"kernel {name} was not launched on the "
              f"{path} path")
    check(launches_by_m[0.9]["momentum"] > 0
          and launches_by_m[0.0]["finalize"] > 0,
          "the momentum round or the plain FedAvg round missed its kernel")
    check(seen.get("torch.float32", 0) > 0
          and seen.get("torch.bfloat16", 0) > 0,
          f"the quantizer was not handed both frame dtypes: {seen}")
    frames = (2 * len(cfg.topology.cut_layers) * samples
              // cfg.learning.batch_size)
    for name in ("quantize", "dequantize"):
        check(total[name] == frames, f"{name} launched {total[name]} "
              f"times, expected {frames}")
    print(f"  quantizer input dtypes {seen}; launches over both rounds "
          f"{total}")
    return total


def _run_protocol_path(path: str, make_cfg) -> dict:
    """A protocol path in one process (``run_inproc``): one round with
    ``server-momentum: 0.9`` (the momentum kernel on the parameters,
    finalize on the statistics), then one at 0 (finalize on every leaf),
    ``make_cfg(momentum)`` giving each round's config, counts zeroed
    before each and read after.  The activations cross each cut in
    bfloat16, the gradients in float32 (a stage's input is the
    dequantized float32 frame), so the vec quantizer runs on both
    dtypes; the dtypes it was handed are tallied here.  Every launch of
    the codec and stage-update kernels on the path is held bit for bit
    against the plain version on its own inputs (:func:`_hold_on_path`):
    the round walls include that holding, whose seconds are reported
    beside them."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    seen: dict = {}
    held_by_run: dict = {}
    runs = {}
    for m in (0.9, 0.0):
        held = held_by_run.setdefault(m, {})
        originals = _hold_on_path(kq, ku, held, seen)
        try:
            cfg = make_cfg(m)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            server, clients, bus, res = run_protocol(cfg)
            torch.cuda.synchronize()
            runs[m] = (cfg, server, clients, bus, res,
                       time.perf_counter() - t0, _launch_counts(),
                       torch.cuda.max_memory_allocated())
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
    out = {"runs": {}, "quantized_dtypes": seen}
    for m, (cfg, server, clients, bus, res, wall, launches, peak) in \
            runs.items():
        rec = res.history[0]
        want = _expected_samples(cfg, protocol=True)
        check(len(res.history) == 1 and rec.ok
              and math.isfinite(rec.val_loss),
              f"{path} round (momentum {m}) failed: {res.history}")
        check(rec.num_samples == want, f"{path} round: "
              f"{rec.num_samples} samples, expected {want}")
        check(server.ctx.last_fold.folded == sum(cfg.clients),
              f"folded {server.ctx.last_fold.folded}")
        _check_stats_checkpoint(cfg, res, 1)
        fam = _family_bytes(bus)
        out["runs"][str(m)] = {
            "round_wall_s": rec.wall_s, "run_wall_s": wall,
            "samples": rec.num_samples,
            "train_samples_per_s": rec.num_samples / rec.wall_s,
            "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
            "phases": server.ctx.round_phases, "bytes_by_family": fam,
            "fold_update_s": server.ctx.last_fold.update_s,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "held": held_by_run[m]}
        _check_held(path, m, held_by_run[m], launches)
        print(f"  momentum {m}: round wall {rec.wall_s:.3f} s (run "
              f"{wall:.3f} s), {rec.num_samples} samples, "
              f"{rec.num_samples / rec.wall_s:.1f} training samples/s, "
              f"val_loss {rec.val_loss:.4f} val_acc {rec.val_accuracy:.4f};"
              f" phases " + ", ".join(
                  f"{k} {v:.3f}" for k, v in server.ctx.round_phases[0]
                  .items()) + f"; fold update "
              f"{server.ctx.last_fold.update_s:.3f} s; bytes by queue "
              f"family {fam}; peak memory {peak / 2**30:.2f} GiB; "
              f"launches {launches}")
    out["launches_total"] = _check_path_kernels(
        path, runs[0.9][0], {m: r[6] for m, r in runs.items()}, seen,
        sum(r["samples"] for r in out["runs"].values()))
    return out


def phase_vgg_protocol(workdir: pathlib.Path) -> dict:
    """BASELINE config 1 as the protocol round in one process
    (:func:`_run_protocol_path`)."""
    return _run_protocol_path(
        "VGG protocol",
        lambda m: vgg_protocol_config(workdir / f"vgg_protocol_{m}", m))


def phase_vgg_tcp(workdir: pathlib.Path, timeout: float = 600.0) -> dict:
    """``config.yaml`` with ``transport.kind: tcp`` in its deployment
    shape (:func:`_run_tcp`: broker, server and two clients as
    processes), one round, against the same configuration run as the
    protocol round in one process: the samples must be equal, and no
    kernel runs in either (every flag off).  The processes' span journals
    share the server's trace id, and every consume span finds its publish
    parent in another process's journal (:func:`check_journal_edges`)."""
    cfg_in = yaml_config(workdir / "vgg_inproc", "config.yaml")
    _reset_launches()
    t0 = time.perf_counter()
    _, _, _, res = run_protocol(cfg_in)
    torch.cuda.synchronize()
    wall_in = time.perf_counter() - t0
    check(not any(_launch_counts().values()), "kernels launched in the "
          "in-process config.yaml protocol round")
    rec_in = res.history[0]
    check(rec_in.ok and rec_in.num_samples
          == _expected_samples(cfg_in, protocol=True),
          f"in-process config.yaml protocol round: {rec_in}")
    _check_stats_checkpoint(cfg_in, res, 1)

    cfg, wall, stats, reports, card_peak_mib = _run_tcp(
        workdir / "vgg_tcp",
        lambda d: yaml_config(d, "config.yaml"), timeout)
    launches = {k: sum(r["launches"].get(k, 0) for r in reports.values())
                for k in reports["server"]["launches"]}
    check(not any(launches.values()), f"kernels launched on the VGG TCP "
          f"path: {launches}")
    records = _metrics(pathlib.Path(cfg.log_path))
    rounds = [r for r in records if r.get("kind") == "round"]
    phases = [r for r in records if r.get("kind") == "phases"]
    check(len(rounds) == 1 and rounds[0]["ok"]
          and math.isfinite(rounds[0]["val_loss"]),
          f"VGG TCP round failed: {rounds}")
    # the processes' journals: one trace, every edge across processes
    trace = check_journal_edges("config.yaml over TCP", cfg.log_path)
    check(len(trace["participants"]) == 1 + sum(cfg.clients),
          f"journals of {trace['participants']}")
    check(rounds[0]["num_samples"] == rec_in.num_samples,
          f"VGG TCP round: {rounds[0]['num_samples']} samples, in process "
          f"{rec_in.num_samples}")
    out = {"run_wall_s": wall, "round_wall_s": rounds[0]["wall_s"],
           "samples": rounds[0]["num_samples"],
           "train_samples_per_s": rounds[0]["num_samples"]
           / rounds[0]["wall_s"],
           "val_loss": rounds[0]["val_loss"],
           "val_accuracy": rounds[0]["val_accuracy"],
           "phases": [{k: v for k, v in p.items() if k.endswith("_s")}
                      for p in phases],
           "inproc": {"round_wall_s": rec_in.wall_s, "run_wall_s": wall_in,
                      "train_samples_per_s": rec_in.num_samples
                      / rec_in.wall_s, "val_loss": rec_in.val_loss},
           "launches": launches,
           "broker_published_bytes_by_family":
               stats["published_bytes_by_family"],
           "processes": {n: {k: r[k] for k in (
               "wall_s", "max_memory_allocated_bytes")}
               for n, r in reports.items()},
           "card_memory_used_peak_mib": card_peak_mib, "trace": trace}
    print(f"  config.yaml over TCP: round wall {out['round_wall_s']:.3f} s "
          f"(in process {rec_in.wall_s:.3f} s), {out['samples']} samples, "
          f"{out['train_samples_per_s']:.1f} training samples/s (in "
          f"process {out['inproc']['train_samples_per_s']:.1f}), "
          f"val_loss {out['val_loss']:.4f} (in process "
          f"{rec_in.val_loss:.4f}); phases {out['phases']}; broker bytes "
          f"by family {out['broker_published_bytes_by_family']}; card "
          f"memory peak {card_peak_mib} MiB")
    return out


# --------------------------------------------------------------------------
# 12-15. BASELINE config 2: the control plane
# --------------------------------------------------------------------------

#: BASELINE config 2 (KMeans into 2 clusters, GMM selection)
BASELINE2 = "configs/baseline2.yaml"
#: the stage-1 client whose registered speed the protocol phase divides
#: by 10 (a member of the 3-client cluster, so selection may reject it)
STRAGGLER = "client_1_1"
#: strategies phase: samples a client (the YAML's 2500, reduced)
STRATEGY_SAMPLES = 256


def _plan_summary(plans) -> list:
    return [{"cluster": p.cluster_id, "cuts": list(p.cuts),
             "clients": [list(ids) for ids in p.clients],
             "label_counts": p.label_counts.tolist(),
             "rejected": list(p.rejected)} for p in plans]


def phase_profiler(workdir: pathlib.Path) -> dict:
    """``python -m split_learning_torch.profiler --config
    configs/baseline2.yaml`` as a process on the card (``time`` mode:
    each layer's forward by CUDA events, batch 32), then ``flops`` mode
    in this process, the same function's ``size_data`` on the CPU, and
    the bandwidth through an ``InProcTransport``.  The throughput-balance
    cut from the card's profile is printed beside the even split."""
    from split_learning_torch import profiler
    from split_learning_torch.config import from_yaml
    from split_learning_torch.planner import partition
    from split_learning_torch.runtime.bus import InProcTransport

    cfg = from_yaml(HERE / BASELINE2)
    out_path = workdir / "profiling.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "split_learning_torch.profiler", "--config",
         str(HERE / BASELINE2), "--output", str(out_path), "--device",
         DEVICE], cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"profiler CLI failed: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    prof = json.loads(out_path.read_text())
    kw = dict(cfg.model_kwargs or {})
    batch = cfg.learning.batch_size
    flops = profiler.profile_model(cfg.model_key, batch, model_kwargs=kw,
                                   method="flops", device=DEVICE)
    on_cpu = profiler.profile_model(cfg.model_key, batch, model_kwargs=kw,
                                    method="flops", device="cpu",
                                    repeats=2)
    network = profiler.profile_network(InProcTransport())
    n_layer = len(prof["exe_time"])
    check(summary["layers"] == n_layer == len(prof["size_data"]),
          f"profile of {n_layer} layers, summary {summary}")
    check(prof["size_data"] == on_cpu["size_data"] == flops["size_data"],
          "size_data differs between the card's profile and the CPU's")
    check(flops["exe_time"] == on_cpu["exe_time"],
          "flops-mode exe_time differs between the card and the CPU")
    for name, p in (("time", prof), ("flops", flops)):
        check(all(t > 0 and math.isfinite(t) for t in p["exe_time"])
              and p["speed"] > 0, f"{name} profile has a time <= 0: {p}")
    check(network > 0, f"InProcTransport bandwidth {network}")
    exe, net = [prof["exe_time"]], [1e9]
    cut = partition(exe, net, exe, net, prof["size_data"])
    check(1 <= cut[0] <= n_layer - 1, f"cut {cut} outside [1, {n_layer - 1}]")
    even = [max(1, n_layer // 2)]
    print(f"  profiler CLI ({cli_s:.1f} s, time mode, batch {batch}): "
          f"{n_layer} layers, full forward {prof['speed']:.1f} samples/s "
          f"(flops-mode run {flops['speed']:.1f})")
    print("  layer: exe_time ms (time mode), size_data bytes, flops-mode "
          "exe_time (FLOPs / 1e12)")
    for i, (t_s, size, f) in enumerate(zip(prof["exe_time"],
                                           prof["size_data"],
                                           flops["exe_time"]), start=1):
        print(f"    {i:2d}: {t_s * 1e3:.4f} ms  {size:>9d} B  {f:.6g}")
    print(f"  network through an InProcTransport: {network / 1e9:.3f} GB/s")
    fexe = [flops["exe_time"]]
    flops_cut = partition(fexe, net, fexe, net, flops["size_data"])
    print(f"  partition on the card's profile: cut {cut} (even split "
          f"{even}); on the flops profile {flops_cut}")
    return {"profile": prof, "flops_profile": flops, "cli_s": cli_s,
            "network_bytes_per_s": network, "cut": cut, "even_cut": even,
            "flops_cut": flops_cut, "speed_samples_per_s": prof["speed"]}


def baseline2_config(workdir: pathlib.Path, **changes):
    """``configs/baseline2.yaml`` as written, its checkpoints and logs in
    ``workdir``, with ``changes`` (``dataclasses.replace`` on the
    config's sections: ``{section: {field: value}}`` or a top-level
    field)."""
    cfg = yaml_config(workdir, BASELINE2)
    top = {}
    for key, val in changes.items():
        if isinstance(val, dict):
            top[key] = dataclasses.replace(getattr(cfg, key), **val)
        else:
            top[key] = val
    return dataclasses.replace(cfg, **top).validate()


def _rounds_summary(label: str, result) -> list:
    rounds = []
    for rec in result.history:
        rounds.append({"round": rec.round_idx, "wall_s": rec.wall_s,
                       "samples": rec.num_samples,
                       "train_samples_per_s": rec.num_samples / rec.wall_s,
                       "validated": rec.val_loss is not None,
                       "val_loss": rec.val_loss,
                       "val_accuracy": rec.val_accuracy})
        val = (f", val_loss {rec.val_loss:.4f} val_acc "
               f"{rec.val_accuracy:.4f}" if rec.val_loss is not None
               else ", not validated")
        print(f"  {label} round {rec.round_idx}: wall {rec.wall_s:.3f} s, "
              f"{rec.num_samples} samples, "
              f"{rec.num_samples / rec.wall_s:.1f} training samples/s{val}")
    return rounds


def phase_baseline2_slice(workdir: pathlib.Path, profile: dict) -> dict:
    """BASELINE config 2 in process (``run_local``) as written but for
    its rounds (1 of 5, for the script's time): 4 stage-1 clients at
    2500 samples each clustered by KMeans into 2,
    selection on (equal speeds: nobody rejected), the even cut without
    profiles; every ``kernels:`` flag off, so no kernel may launch.
    Then 1 round (reduced from 5) with the profiler phase's profile
    registered for every client: the auto cut from the card's times."""
    from split_learning_torch.run import run_local, synthesize_registrations
    from split_learning_torch.runtime.plan import plan_clusters

    out = {}
    profiles = {f"client_{s}_{i}": profile
                for s, n in ((1, 4), (2, 2)) for i in range(n)}
    for label, profs, rounds in (("even_cut", None, 1),
                                 ("profiled_cut", profiles, 1)):
        changes = {} if rounds is None else {"global_rounds": rounds}
        cfg = baseline2_config(workdir / f"b2_{label}", **changes)
        plans = plan_clusters(cfg, synthesize_registrations(cfg, profs))
        summary = _plan_summary(plans)
        for p in summary:
            print(f"  {label}: cluster {p['cluster']}: stage-1 "
                  f"{p['clients'][0]}, stage-2 {p['clients'][1]}, cuts "
                  f"{p['cuts']}, rejected {p['rejected']}, label counts "
                  f"{p['label_counts']}")
        check(len(plans) == 2 and not any(p.rejected for p in plans),
              f"{label}: plans {summary}")
        check(sorted(c for p in plans for c in p.stage1_clients)
              == [f"client_1_{i}" for i in range(4)],
              f"{label}: stage-1 clients {summary}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        result = run_local(cfg, device=DEVICE, profiles=profs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        check(not any(launches.values()), f"baseline 2 {label}: kernels "
              f"launched with every kernels flag off: {launches}")
        check(len(result.history) == cfg.global_rounds,
              f"{label}: {len(result.history)} rounds")
        want = _expected_samples(cfg, protocol=False)
        for rec in result.history:
            check(rec.ok and math.isfinite(rec.val_loss)
                  and math.isfinite(rec.val_accuracy),
                  f"baseline 2 {label}: round not ok: {rec}")
            check(rec.num_samples == want, f"baseline 2 {label} round "
                  f"{rec.round_idx}: {rec.num_samples} samples, expected "
                  f"{want}")
        _check_stats_checkpoint(cfg, result, cfg.global_rounds)
        peak = torch.cuda.max_memory_allocated()
        out[label] = {"plans": summary, "run_local_wall_s": wall,
                      "rounds": _rounds_summary(f"baseline 2 {label}",
                                                result),
                      "max_memory_allocated_bytes": peak,
                      "launches": launches}
        print(f"  baseline 2 {label}: run_local {wall:.3f} s, peak memory "
              f"{peak / 2**30:.2f} GiB")
    return out


def baseline2_protocol_config(workdir: pathlib.Path, momentum: float):
    """Baseline 2 as the protocol slice runs it: one round, an int8 codec
    on both cut directions, every kernel flag on, the sharded (CUDA) fold
    with ``server-momentum`` = ``momentum``."""
    return baseline2_config(
        workdir, global_rounds=1,
        transport={"codec": {"intermediate": "int8", "gradient": "int8"}},
        kernels={"quantize": True, "dequantize": True,
                 "stage_update": True},
        aggregation={"sharded": True, "server_momentum": momentum})


def phase_baseline2_protocol(workdir: pathlib.Path, profile: dict) -> dict:
    """Baseline 2 as the protocol round in one process: every client
    registers the card's profile, :data:`STRAGGLER`'s speed divided by 10;
    one round at ``server-momentum: 0.9``, one at 0.  The server's plans
    must equal ``plan_clusters`` on the same registrations here (GMM
    selection rejects exactly the same clients), the rejected client
    must never be STARTed, both clusters must train and fold on their
    own queues, and every codec and stage-update launch is held bit for
    bit against its plain version (:func:`_hold_on_path`)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.run import synthesize_registrations
    from split_learning_torch.runtime import server as server_mod
    from split_learning_torch.runtime.bus import queue_family
    from split_learning_torch.runtime.plan import plan_clusters

    profiles = {f"client_{s}_{i}": profile
                for s, n in ((1, 4), (2, 2)) for i in range(n)}
    profiles[STRAGGLER] = dict(profile, speed=profile["speed"] / 10)
    seen: dict = {}
    runs = {}
    server_plans: list = []
    folds: list = []
    plan_fn = server_mod.plan_clusters
    train = server_mod.ProtocolContext.train_cluster

    def record_plans(cfg, regs, *a, **kw):
        server_plans.append(plan_fn(cfg, regs, *a, **kw))
        return server_plans[-1]

    def record_fold(ctx, plan, *a, **kw):
        ups = train(ctx, plan, *a, **kw)
        folds.append({"cluster": plan.cluster_id,
                      "folded": ctx.last_fold.folded,
                      "samples": ctx.last_fold.n_samples})
        return ups

    for m in (0.9, 0.0):
        held: dict = {}
        originals = _hold_on_path(kq, ku, held, seen)
        server_mod.plan_clusters = record_plans
        server_mod.ProtocolContext.train_cluster = record_fold
        try:
            cfg = baseline2_protocol_config(workdir / f"b2_protocol_{m}", m)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            server, clients, bus, res = run_protocol(cfg, profiles=profiles)
            torch.cuda.synchronize()
            runs[m] = (cfg, server, clients, bus, res,
                       time.perf_counter() - t0, _launch_counts(),
                       torch.cuda.max_memory_allocated(), held)
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
            server_mod.plan_clusters = plan_fn
            server_mod.ProtocolContext.train_cluster = train
    cfg = runs[0.9][0]
    cpu_plans = plan_clusters(cfg, synthesize_registrations(cfg, profiles))
    want = _plan_summary(cpu_plans)
    for plans in server_plans:
        check(_plan_summary(plans) == want, f"server plans "
              f"{_plan_summary(plans)} differ from plan_clusters' {want}")
    rejected = [c for p in cpu_plans for c in p.rejected]
    check(rejected == [STRAGGLER], f"selection rejected {rejected}")
    for p in want:
        print(f"  cluster {p['cluster']}: stage-1 {p['clients'][0]}, "
              f"stage-2 {p['clients'][1]}, cuts {p['cuts']}, rejected "
              f"{p['rejected']}")
    out = {"plans": want, "runs": {}, "quantized_dtypes": seen,
           "folds": folds}
    n_train = sum(len(p.stage1_clients) for p in cpu_plans)
    for m, (cfg, server, clients, bus, res, wall, launches, peak,
            held) in runs.items():
        rec = res.history[0]
        expect = _expected_samples(cfg, protocol=True, n_clients=n_train)
        check(len(res.history) == 1 and rec.ok
              and math.isfinite(rec.val_loss),
              f"baseline 2 protocol round (momentum {m}) failed: "
              f"{res.history}")
        check(rec.num_samples == expect, f"baseline 2 protocol round: "
              f"{rec.num_samples} samples, expected {expect}")
        straggler = next(c for c in clients if c.client_id == STRAGGLER)
        check(straggler.runner is None, f"{STRAGGLER} was rejected but "
              "trained")
        _check_stats_checkpoint(cfg, res, 1)
        fam: dict = {}
        queues = set()
        for q, nb in bus.bytes_out_snapshot().items():
            fam[queue_family(q)] = fam.get(queue_family(q), 0) + nb
            if q.startswith("intermediate_queue"):
                queues.add(q)
        check(queues == {"intermediate_queue_1_0", "intermediate_queue_1_1"},
              f"activation queues {sorted(queues)}")
        _check_held("baseline 2 protocol", m, held, launches)
        phases = server.ctx.round_phases
        out["runs"][str(m)] = {
            "round_wall_s": rec.wall_s, "run_wall_s": wall,
            "samples": rec.num_samples,
            "train_samples_per_s": rec.num_samples / rec.wall_s,
            "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
            "phases_by_cluster": phases, "bytes_by_family": fam,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "held": held}
        print(f"  momentum {m}: round wall {rec.wall_s:.3f} s (run "
              f"{wall:.3f} s), {rec.num_samples} samples, "
              f"{rec.num_samples / rec.wall_s:.1f} training samples/s, "
              f"val_loss {rec.val_loss:.4f} val_acc {rec.val_accuracy:.4f};"
              " phases " + "; ".join(
                  f"cluster {i}: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in ph.items())
                  for i, ph in enumerate(phases))
              + f"; bytes by queue family {fam}; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {launches}")
    # both clusters trained and folded, in each run
    check([f["cluster"] for f in folds] == [0, 1, 0, 1]
          and all(f["folded"] > 0 and f["samples"] > 0 for f in folds),
          f"cluster folds {folds}")
    print(f"  folds {folds}")
    out["launches_total"] = _check_path_kernels(
        "baseline 2 protocol", runs[0.9][0],
        {m: r[6] for m, r in runs.items()}, seen,
        sum(r["samples"] for r in out["runs"].values()))
    return out


#: strategies phase: strategy -> (aggregation changes, topology changes,
#: learning changes, checkpoint changes, rounds validated of 2)
STRATEGY_RUNS = {
    "sda": ({"strategy": "sda", "local_rounds": 2}, {},
            {"lr_decay": 0.9, "lr_decay_every": 1}, {}, [True, True]),
    "relay": ({"strategy": "relay"}, {}, {}, {}, [True, True]),
    "cluster_relay": ({"strategy": "cluster_relay"}, {}, {}, {},
                      [True, True]),
    "periodic": ({"strategy": "periodic", "t_client": 1, "t_global": 2},
                 {}, {}, {}, [False, True]),
    "fedasync": ({"strategy": "fedasync"}, {"in_clusters": 2}, {},
                 {"per_merge": True}, [True, True]),
}


def phase_strategies(workdir: pathlib.Path) -> dict:
    """Each of the five strategies beside FedAvg in process at full VGG16
    width on baseline 2's geometry (its plan: 2 KMeans clusters, the
    even cut), 2 rounds.  Reduced: :data:`STRATEGY_SAMPLES` samples a
    client (2500 in the YAML) and 2 rounds (5).  Each is held to its
    own contract: the samples of a round (SDA: 2 local epochs), the
    rounds it validates (periodic: the ``t-global: 2`` boundary only),
    finite validation losses, and FedAsync's per-merge checkpoints (one
    per in-cluster merge, on disk)."""
    from split_learning_torch.run import run_local, synthesize_registrations
    from split_learning_torch.runtime import strategies as strat_mod
    from split_learning_torch.runtime.checkpoint import load_checkpoint
    from split_learning_torch.runtime.plan import plan_clusters

    out = {"reduced": {"samples_per_client": [2500, STRATEGY_SAMPLES],
                       "global_rounds": [5, 2]}}
    save = strat_mod.save_checkpoint
    for name, (agg, topo, lrn, ck, validated) in STRATEGY_RUNS.items():
        cfg = baseline2_config(
            workdir / f"strategy_{name}", global_rounds=2,
            distribution={"num_samples": STRATEGY_SAMPLES},
            aggregation=agg, topology=topo, learning=lrn, checkpoint=ck)
        plans = plan_clusters(cfg, synthesize_registrations(cfg))
        merges = []

        def spy(*a, **kw):
            merges.append(kw.get("round_idx"))
            return save(*a, **kw)
        strat_mod.save_checkpoint = spy
        _reset_launches()
        t0 = time.perf_counter()
        try:
            result = run_local(cfg, device=DEVICE)
        finally:
            strat_mod.save_checkpoint = save
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(_launch_counts().values()), f"{name}: kernels "
              "launched with every kernels flag off")
        epochs = cfg.aggregation.local_rounds if name == "sda" else 1
        want = epochs * _expected_samples(cfg, protocol=False)
        check(len(result.history) == 2, f"{name}: {result.history}")
        for rec, val in zip(result.history, validated):
            check(rec.ok and rec.num_samples == want,
                  f"{name} round {rec.round_idx}: {rec.num_samples} "
                  f"samples (expected {want}), ok {rec.ok}")
            check((rec.val_loss is not None) == val,
                  f"{name} round {rec.round_idx}: validated "
                  f"{rec.val_loss is not None}, expected {val}")
            check(rec.val_loss is None or (math.isfinite(rec.val_loss)
                                           and math.isfinite(
                                               rec.val_accuracy)),
                  f"{name} round {rec.round_idx}: {rec}")
        _check_stats_checkpoint(cfg, result, 2)
        if name == "fedasync":
            # one merge per in-cluster: 2 of the 3-client cluster, 1 of
            # the other, each round
            n_merges = sum(min(2, len(p.stage1_clients)) for p in plans)
            check(merges == [0] * n_merges + [1] * n_merges,
                  f"fedasync per-merge checkpoints at rounds {merges}")
            ck_on_disk = load_checkpoint(cfg.checkpoint.directory,
                                         cfg.model_key)
            check(ck_on_disk is not None, "no fedasync checkpoint on disk")
        else:
            check(not merges, f"{name} wrote per-merge checkpoints")
        out[name] = {"run_local_wall_s": wall, "per_merge_checkpoints":
                     len(merges),
                     "rounds": _rounds_summary(name, result)}
        print(f"  {name}: run_local {wall:.3f} s"
              + (f", {len(merges)} per-merge checkpoints" if merges
                 else ""))
    return out


# --------------------------------------------------------------------------
# 16-18. BASELINE configs 3 (ResNet-50/CIFAR-100) and 4 (ViT-S/16)
# --------------------------------------------------------------------------

BASELINE3 = "configs/baseline3.yaml"
BASELINE4 = "configs/baseline4.yaml"
def baseline3_protocol_config(workdir: pathlib.Path, momentum: float):
    """Config 3 as the protocol round runs it: one round, an int8 codec
    on both cut directions at both cuts, every kernel flag on, the
    sharded (CUDA) fold with ``server-momentum`` = ``momentum``."""
    cfg = yaml_config(workdir, BASELINE3)
    return dataclasses.replace(
        cfg, global_rounds=1,
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, sharded=True,
            server_momentum=momentum)).validate()


def phase_baseline3_slice(workdir: pathlib.Path) -> dict:
    """BASELINE config 3 in process (``run_local``) as written but for
    its depth (1 of its 5 rounds, for the script's time):
    ResNet-50/CIFAR-100, ``[2, 2, 2]`` (two lockstep columns through
    three stages, cuts ``[3, 6]``), batch 64, control-count 4, 2500
    samples a client, SGD with momentum, bf16; the nested statistics of
    all 17 layers in the checkpoint (:func:`_run_slice`).  Then one
    round once more, warm and traced (:func:`phase_profile`)."""
    cfg = dataclasses.replace(yaml_config(workdir / "b3_slice", BASELINE3),
                              global_rounds=1)
    out = _run_slice("baseline 3", cfg)
    out["profile"] = phase_profile(dataclasses.replace(cfg,
                                                       global_rounds=1))
    return out


def phase_baseline3_protocol(workdir: pathlib.Path) -> dict:
    """BASELINE config 3 as the protocol round in one process: three
    stages, six clients (two feeders at each cut), the int8 codec on both
    directions of both cuts, the sharded fold over ResNet-50's leaves at
    ``server-momentum`` 0.9 then 0; every quantize, dequantize, momentum
    and finalize launch held bit for bit against its plain version
    (:func:`_run_protocol_path`)."""
    return _run_protocol_path(
        "baseline 3 protocol",
        lambda m: baseline3_protocol_config(workdir / f"b3_protocol_{m}",
                                            m))


def phase_baseline4_slice(workdir: pathlib.Path) -> dict:
    """BASELINE config 4 in process (``run_local``) as written but for
    its depth (1 of its 5 rounds, for the script's time): ViT-S/16 on
    CIFAR-10 (12 blocks, dropout 0.1), ``[2, 1]`` (one shared stage-2
    client: the columns' stage-2 gradients averaged every step), cut
    ``[10]``, batch 64, AdamW with weight decay 0.05, bf16
    (:func:`_run_slice`; no statistics).  Then one round once more, warm
    and traced."""
    cfg = dataclasses.replace(yaml_config(workdir / "b4_slice", BASELINE4),
                              global_rounds=1)
    out = _run_slice("baseline 4", cfg)
    out["profile"] = phase_profile(dataclasses.replace(cfg,
                                                       global_rounds=1))
    return out


# --------------------------------------------------------------------------
# 19-24. the reference's own BERT (LoRA) and KWT, and the variants
# --------------------------------------------------------------------------

KWT1 = "configs/kwt1_speechcommands.yaml"
BERT_LORA = "configs/bert_lora_agnews.yaml"
#: the reference's research variants: KWT in 7 strategies, BERT_EMOTION
#: at the fine-grained indexing
VARIANTS = sorted(p.relative_to(HERE).as_posix()
                  for p in (HERE / "examples" / "variants").glob("*.yaml"))


def phase_kwt_slice(workdir: pathlib.Path) -> dict:
    """KWT-1 on SpeechCommands in process (``run_local``) at its
    published width (``configs/kwt1_speechcommands.yaml``: embed 64, 1
    head, MLP 256, 12 blocks, 40 x 98 MFCCs, 10 classes), ``[2, 2]``, cut
    2, AdamW at 1e-3, batch 32, bf16, the synthetic set, 1 of its 3
    rounds, for the script's time (:func:`_run_slice`); then one round
    once more, warm and traced."""
    cfg = dataclasses.replace(yaml_config(workdir / "kwt_slice", KWT1),
                              global_rounds=1)
    out = _run_slice("KWT-1", cfg)
    out["profile"] = phase_profile(dataclasses.replace(cfg,
                                                       global_rounds=1))
    return out


def phase_variants(workdir: pathlib.Path) -> dict:
    """The eight ``examples/variants/*.yaml`` in process on the card, as
    written (their own tiny widths): relay, cluster relay, SDA, strict
    SDA (two and three stages), periodic and FedAsync on KWT, FedAvg on
    the fine-grained BERT_EMOTION.  Each runs all its rounds, every
    round ok with samples, its last round validated with a finite loss
    and accuracy, no kernel launched (every flag off)."""
    from split_learning_torch.run import run_local

    out = {}
    for path in VARIANTS:
        name = pathlib.Path(path).stem
        cfg = yaml_config(workdir / f"variant_{name}", path)
        _reset_launches()
        t0 = time.perf_counter()
        result = run_local(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(_launch_counts().values()), f"variant {name}: "
              "kernels launched with every kernels flag off")
        hist = result.history
        check(len(hist) == cfg.global_rounds
              and all(r.ok and r.num_samples > 0 for r in hist),
              f"variant {name}: {hist}")
        last = hist[-1]
        check(last.val_loss is not None and math.isfinite(last.val_loss)
              and math.isfinite(last.val_accuracy),
              f"variant {name}: last round not validated: {last}")
        out[name] = {"model": cfg.model_key,
                     "strategy": cfg.aggregation.strategy,
                     "clients": list(cfg.clients), "run_local_wall_s": wall,
                     "rounds": len(hist),
                     "samples": [r.num_samples for r in hist],
                     "final_val_loss": last.val_loss,
                     "final_val_accuracy": last.val_accuracy}
        print(f"  {name}: {cfg.model_key} {cfg.aggregation.strategy} "
              f"clients={list(cfg.clients)} {len(hist)} rounds in "
              f"{wall:.3f} s, samples {out[name]['samples']}, final "
              f"val_loss {last.val_loss:.4f} val_acc "
              f"{last.val_accuracy:.4f}")
    return out


#: the seven KWT variants of ``examples/variants`` (the eighth,
#: ``bert_fine_grained.yaml``, is BERT_EMOTION in FedAvg)
KWT_VARIANTS = ("2ls", "cluster_fsl", "dcsl", "dcsl_strict",
                "dcsl_strict_deep", "flex", "vanilla_sl")
#: the variants as the protocol round at KWT-1's width: samples a client
#: and batch (the published config's batch; 4 batches a client an epoch)
VARIANT_SAMPLES, VARIANT_BATCH = 128, 32
#: each run's client timeout: every barrier but cluster_fsl's headless
#: second cluster's (which no later-stage client serves, in both
#: packages' plans) answers within a few seconds once the process has
#: used the card (a cold first READY of eight clients took 8.2 s)
VARIANT_TIMEOUT = 20.0
#: ``cluster_fsl``'s client timeout: its headless second cluster waits
#: it out at the NOTIFY barrier every round, while its first cluster's
#: barriers answer in about a second (it runs after ``2ls``, which takes
#: the cold READY), so a short one keeps the phase short
HEADLESS_TIMEOUT = 8.0
#: launches over each variant's whole run, as PERF.md §6 predicted them
#: before the first run: (quantize, dequantize, finalize).  One quantize
#: and one dequantize a batch a direction a cut; one finalize a
#: parameter leaf a stage a fold (KWT-1: 200 leaves, 3 in stage 1), the
#: fold running for sda and cluster_relay only; cluster_fsl's headless
#: cluster quantizes its feeders' control-count activations a round and
#: nothing else of its data plane
VARIANT_LAUNCHES = {"vanilla_sl": (48, 48, 0), "flex": (64, 64, 0),
                    "dcsl": (64, 64, 400), "dcsl_strict": (64, 64, 400),
                    "dcsl_strict_deep": (128, 128, 400),
                    "2ls": (64, 64, 0), "cluster_fsl": (40, 32, 406)}
#: the dropped-feeder run: the stage-1 client that registers and never
#: answers, and the READY deadline that drops it
GHOST, GHOST_READY_S = "client_1_1", 3.0


def variant_protocol_config(workdir: pathlib.Path, name: str):
    """``examples/variants/{name}.yaml`` as the protocol round at KWT-1's
    published width: its ``model-kwargs`` dropped (embed 64, 1 head, MLP
    256, 12 blocks, 40 x 98 MFCCs, as ``configs/kwt1_speechcommands.yaml``),
    batch 32, 128 samples a client from a 512-clip synthetic set, bf16
    compute, the int8 codec on both cut directions, the quantize,
    dequantize and stage-update kernels with the sharded fold; strategy,
    clients, topology, rounds, SDA and FLEX settings, learning rate and
    ``limited-time`` as written."""
    cfg = yaml_config(workdir, f"examples/variants/{name}.yaml")
    return dataclasses.replace(
        cfg, model_kwargs=None, compute_dtype="bfloat16",
        synthetic_size=4 * VARIANT_SAMPLES,
        learning=dataclasses.replace(cfg.learning,
                                     batch_size=VARIANT_BATCH),
        distribution=dataclasses.replace(cfg.distribution,
                                         num_samples=VARIANT_SAMPLES),
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(cfg.aggregation,
                                        sharded=True)).validate()


class _Choreography:
    """Records, while installed, what the clients of a protocol run see:
    each START (round, weights or none, extras), each SDA window (the
    head, its origins and batch sizes, its width) and each UPDATE
    (weights or none, samples, generation), by wrapping
    ``ProtocolClient``'s methods (the real ones still run)."""

    def __init__(self):
        from split_learning_torch.runtime.client import ProtocolClient
        self.cls = ProtocolClient
        self.starts, self.windows, self.updates = [], [], []
        self._orig = {k: getattr(ProtocolClient, k)
                      for k in ("_on_start", "_sda_step", "_send_update")}
        rec = self

        def on_start(self, msg):
            rec.starts.append({"client": self.client_id,
                               "round": msg.round_idx,
                               "weights": msg.params is not None,
                               "cluster": msg.cluster,
                               "extra": dict(msg.extra or {})})
            return rec._orig["_on_start"](self, msg)

        def sda_step(self, window):
            rec.windows.append({"client": self.client_id,
                                "origins": [a.trace[0] for a in window],
                                "sizes": [len(a.labels) for a in window],
                                "width": self.sda_size})
            return rec._orig["_sda_step"](self, window)

        def send_update(self, with_weights):
            rec.updates.append({"client": self.client_id,
                                "stage": self.stage, "gen": self.fence,
                                "weights": with_weights,
                                "samples": self.num_samples})
            return rec._orig["_send_update"](self, with_weights)

        for k, fn in (("_on_start", on_start), ("_sda_step", sda_step),
                      ("_send_update", send_update)):
            setattr(ProtocolClient, k, fn)

    def restore(self) -> None:
        for k, fn in self._orig.items():
            setattr(self.cls, k, fn)


def _variant_samples(cfg, plans, gone: tuple = ()) -> int:
    """Training samples a round: every stage-1 client (but those in
    ``gone``) of a plan whose last stage has a client, for each local
    epoch (a plan without one feeds a queue nobody reads, and counts
    nothing)."""
    epochs = (cfg.aggregation.local_rounds
              if cfg.aggregation.strategy == "sda" else 1)
    return sum(len(set(p.stage1_clients) - set(gone))
               * cfg.distribution.num_samples * epochs
               for p in plans if p.clients[-1])


def _check_choreography(name: str, cfg, plans, rec: _Choreography,
                        history, log_path: pathlib.Path) -> dict:
    """A variant's protocol run against its strategy's choreography:
    every SDA window of distinct origins and at most its width, every
    sample consumed; relay's START cycles; FLEX's hold rounds moving no
    weights; 2LS's heads hearing only their pair's feeders."""
    out = {}
    for w in rec.windows:
        check(len(set(w["origins"])) == len(w["origins"]) <= w["width"],
              f"{name}: window {w}")
    consumed = sum(sum(w["sizes"]) for w in rec.windows)
    check(consumed == sum(r.num_samples for r in history),
          f"{name}: heads consumed {consumed} samples of "
          f"{sum(r.num_samples for r in history)}")
    widths = sorted({len(w["origins"]) for w in rec.windows})
    out["window_widths"] = widths
    strategy = cfg.aggregation.strategy
    if strategy == "relay":
        want = cfg.global_rounds * sum(
            len(p.stage1_clients) * (1 + sum(map(len, p.clients[1:])))
            for p in plans)
        check(len(rec.starts) == want, f"{name}: {len(rec.starts)} "
              f"STARTs, relay's cycles send {want}")
        out["starts"] = len(rec.starts)
    if strategy == "periodic":
        round_of = {s["extra"]["gen"]: s["round"] for s in rec.starts}
        weighted = {"reply": set(), "rpc": set()}
        for s in rec.starts:
            if s["weights"]:
                weighted["reply"].add(s["round"])
        for u in rec.updates:
            if u["weights"]:
                weighted["rpc"].add(round_of[u["gen"]])
        wire = [r for r in _metrics(log_path) if r.get("kind") == "wire"]
        check(len(wire) == cfg.global_rounds, f"{name}: wire records "
              f"{len(wire)}")
        per = {"reply": [], "rpc": []}
        for fam in per:
            prev = 0
            for r in wire:
                per[fam].append(r[f"cumulative_{fam}_bytes"] - prev)
                prev = r[f"cumulative_{fam}_bytes"]
            top = max(per[fam])
            for i, nb in enumerate(per[fam]):
                if i not in weighted[fam]:
                    check(nb < 0.01 * top, f"{name}: {fam} bytes "
                          f"{per[fam]} (round {i} moves no weights)")
        check(weighted["reply"] and weighted["rpc"]
              and len(weighted["reply"]) < cfg.global_rounds
              and len(weighted["rpc"]) < cfg.global_rounds,
              f"{name}: rounds with weights {weighted}")
        out["bytes_by_round"] = per
        out["rounds_with_weights"] = {k: sorted(v)
                                      for k, v in weighted.items()}
        out["weighted_starts"] = sum(s["weights"] for s in rec.starts)
        out["weighted_updates"] = sum(u["weights"] for u in rec.updates)
    if cfg.topology.in_clusters > 1:
        start_of = {s["client"]: s for s in rec.starts}
        heard: dict = {}
        for w in rec.windows:
            heard.setdefault(w["client"], set()).update(w["origins"])
        check(len(heard) == sum(len(p.clients[-1]) for p in plans),
              f"{name}: heads {sorted(heard)}")
        for head, origins in heard.items():
            pair = set(start_of[head]["extra"]["sda_feeders"])
            check(start_of[head]["extra"]["pair"] is not None
                  and origins == pair,
                  f"{name}: head {head} heard {origins}, its pair {pair}")
        out["heard"] = {h: sorted(o) for h, o in heard.items()}
    return out


def _run_variant(name: str, cfg, run, gone: tuple = ()) -> dict:
    """One variant run, ``run(cfg)`` returning (server, bus, result),
    with every codec and stage-update launch held bit for bit
    (:func:`_hold_on_path`) and the clients' choreography recorded
    (:func:`_check_choreography`); every round ok with the samples of
    its live feeders (all but ``gone``), the last validated with a
    finite loss, and the quantizer handed bf16 activations and float32
    gradients."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.plan import plan_clusters

    held: dict = {}
    seen: dict = {}
    rec = _Choreography()
    originals = _hold_on_path(kq, ku, held, seen)
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        server, bus, result = run(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        rec.restore()
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    plans = plan_clusters(cfg, server.ctx.registrations)
    hist = result.history
    want = _variant_samples(cfg, plans, gone)
    check(len(hist) == cfg.global_rounds
          and all(r.ok and r.num_samples == want for r in hist),
          f"{name}: rounds {[(r.ok, r.num_samples) for r in hist]}, "
          f"expected {want} samples each")
    last = hist[-1]
    check(last.val_loss is not None and math.isfinite(last.val_loss),
          f"{name}: last round not validated: {last}")
    _check_held(name, cfg.aggregation.server_momentum, held, launches)
    check(seen.get("torch.float32", 0) and seen.get("torch.bfloat16", 0),
          f"{name}: the quantizer was not handed both frame dtypes: {seen}")
    fam = _family_bytes(bus)
    out = {"strategy": cfg.aggregation.strategy,
           "clients": list(cfg.clients), "run_wall_s": wall,
           "rounds": [{"round": r.round_idx, "wall_s": r.wall_s,
                       "samples": r.num_samples, "val_loss": r.val_loss,
                       "val_accuracy": r.val_accuracy} for r in hist],
           "phases": server.ctx.round_phases, "bytes_by_family": fam,
           "launches": launches,
           "held": {k: {"launches": h["launches"], "s": h["s"]}
                    for k, h in held.items()},
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           **_check_choreography(name, cfg, plans, rec, hist,
                                 pathlib.Path(cfg.log_path))}
    out["origins"] = sorted({o for w in rec.windows for o in w["origins"]})
    print(f"  {name}: {cfg.aggregation.strategy} clients="
          f"{list(cfg.clients)} run {wall:.3f} s; round walls "
          + ", ".join(f"{r.wall_s:.3f}" for r in hist)
          + f" s; samples {[r.num_samples for r in hist]}; final val_loss "
          f"{last.val_loss:.4f} val_acc {last.val_accuracy:.4f}; windows "
          f"of {out['window_widths']}; bytes by family {fam}; launches "
          f"{launches}; holding {sum(h['s'] for h in held.values()):.3f} s;"
          f" peak memory {out['max_memory_allocated_bytes'] / 2**30:.2f} "
          "GiB")
    for i, p in enumerate(server.ctx.round_phases):
        print(f"    train_cluster {i}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in p.items()))
    return out


def _check_variant_launches(name: str, launches: dict) -> None:
    """A variant run's launches against :data:`VARIANT_LAUNCHES`; every
    other kernel (momentum: the variants fold without server momentum;
    the flash kernels: KWT's attention is plain) launched 0 times."""
    want = dict(zip(("quantize", "dequantize", "finalize"),
                    VARIANT_LAUNCHES[name]))
    for k, n in launches.items():
        check(n == want.get(k, 0), f"{name}: {k} launched {n} times, "
              f"predicted {want.get(k, 0)}")


def _inproc_variant(cfg, timeout: float = VARIANT_TIMEOUT) -> tuple:
    server, _, bus, result = run_protocol(cfg, timeout=timeout)
    return server, bus, result


def _run_ghost(cfg, timeout: float = 120.0) -> tuple:
    """The protocol round in one process with :data:`GHOST` registering
    (so that the plan counts it) and never answering START: the server
    on the card in this thread with a READY deadline of
    :data:`GHOST_READY_S`, a client thread for every other client."""
    from split_learning_torch.runtime.bus import InProcTransport
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.protocol import (
        RPC_QUEUE, Register, encode,
    )
    from split_learning_torch.runtime.server import ProtocolServer

    bus = InProcTransport()
    server = ProtocolServer(cfg, bus, logger=Logger.for_run(
        cfg, "server", console=False), client_timeout=timeout,
        ready_timeout=GHOST_READY_S, device=DEVICE)
    clients = [ProtocolClient(cfg, f"client_{s}_{i}", s, bus, device=DEVICE)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n) if f"client_{s}_{i}" != GHOST]
    errors: list = []

    def run(client):
        try:
            client.run()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append((client.client_id, e))
            bus.close()

    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    bus.publish(RPC_QUEUE, encode(Register(client_id=GHOST, stage=1)))
    try:
        result = server.serve()
    except Exception as e:
        raise SmokeFailure(f"dropped-feeder run failed: {e!r} (clients: "
                           f"{errors})") from e
    for t in threads:
        t.join(timeout=120)
    check(not errors and not any(t.is_alive() for t in threads),
          f"dropped-feeder run: clients {errors}")
    return server, bus, result


def phase_variants_protocol(workdir: pathlib.Path) -> dict:
    """The seven KWT variants as the protocol round in one process
    (``run_inproc``) at KWT-1's width (:func:`variant_protocol_config`),
    each checked by :func:`_run_variant` and its launches held to
    :data:`VARIANT_LAUNCHES`; then ``dcsl_strict_deep`` once more with
    :data:`GHOST` registering and never answering START: dropped at the
    READY barrier, the strict head told the live feeder set with SYN,
    each round completes with the live feeder's samples well before the
    round timeout."""
    out = {}
    for name in KWT_VARIANTS:
        cfg = variant_protocol_config(workdir / f"vp_{name}", name)
        timeout = (HEADLESS_TIMEOUT if name == "cluster_fsl"
                   else VARIANT_TIMEOUT)
        out[name] = _run_variant(
            name, cfg, lambda c, t=timeout: _inproc_variant(c, t))
        _check_variant_launches(name, out[name]["launches"])
    cfg = variant_protocol_config(workdir / "vp_ghost", "dcsl_strict_deep")
    timeout = 120.0
    ghost = _run_variant("dcsl_strict_deep with a dropped feeder", cfg,
                         lambda c: _run_ghost(c, timeout), gone=(GHOST,))
    check(all(r["wall_s"] < timeout / 4 for r in ghost["rounds"]),
          f"dropped feeder: round walls {ghost['rounds']}")
    check(ghost["origins"] == ["client_1_0"],
          f"dropped feeder: the head heard {ghost['origins']}")
    out["dropped_feeder"] = ghost
    return out


def phase_variants_tcp(workdir: pathlib.Path, inproc: dict,
                       timeout: float = 300.0) -> dict:
    """``dcsl_strict`` at KWT-1's width (:func:`variant_protocol_config`)
    in its deployment shape (:func:`_run_tcp`: a broker, the server and
    three client processes over TCP, with the async sender), so that the
    strict fences cross a real broker's per-queue FIFO: each round ok
    with the in-process run's samples, every UPDATE folded, the last
    round validated with a finite loss, and the launches across the
    processes equal to :data:`VARIANT_LAUNCHES`."""
    name = "dcsl_strict"
    cfg, wall, stats, reports, card_peak_mib = _run_tcp(
        workdir / "vp_tcp", lambda d: variant_protocol_config(d, name),
        timeout)
    launches = {k: sum(r["launches"].get(k, 0) for r in reports.values())
                for k in reports["server"]["launches"]}
    records = _metrics(pathlib.Path(cfg.log_path))
    rounds = sorted((r for r in records if r.get("kind") == "round"),
                    key=lambda r: r["round_idx"])
    phases = [r for r in records if r.get("kind") == "phases"]
    aggs = [r for r in records if r.get("kind") == "agg"]
    check(len(rounds) == len(aggs) == cfg.global_rounds,
          f"{name} over TCP: {len(rounds)} rounds, {len(aggs)} folds")
    for rec, agg, want in zip(rounds, aggs, inproc[name]["rounds"]):
        check(rec["ok"] and rec["num_samples"] == want["samples"],
              f"{name} over TCP: round {rec}, in process {want}")
        check(agg["folded"] == sum(cfg.clients),
              f"{name} over TCP: folded {agg['folded']}")
    check(math.isfinite(rounds[-1]["val_loss"]),
          f"{name} over TCP: last round {rounds[-1]}")
    _check_variant_launches(name, launches)
    out = {"run_wall_s": wall,
           "rounds": [{"round": r["round_idx"], "wall_s": r["wall_s"],
                       "samples": r["num_samples"],
                       "val_loss": r["val_loss"]} for r in rounds],
           "phases": [{k: v for k, v in p.items() if k.endswith("_s")}
                      for p in phases],
           "launches": launches,
           "broker_published_bytes_by_family":
               stats["published_bytes_by_family"],
           "processes": {n: {k: r[k] for k in (
               "wall_s", "max_memory_allocated_bytes", "sender")}
               for n, r in reports.items()},
           "card_memory_used_peak_mib": card_peak_mib}
    print(f"  {name} over TCP: run {wall:.3f} s; round walls "
          + ", ".join(f"{r['wall_s']:.3f}" for r in out["rounds"])
          + f" s (in process "
          + ", ".join(f"{r['wall_s']:.3f}" for r in inproc[name]["rounds"])
          + f"); samples {[r['samples'] for r in out['rounds']]}; phases "
          f"{out['phases']}; broker bytes by family "
          f"{out['broker_published_bytes_by_family']}; launches {launches};"
          f" card memory peak {card_peak_mib} MiB")
    return out


# --------------------------------------------------------------------------
# the transport plane under injected faults
# --------------------------------------------------------------------------

#: the JAX package's acceptance recipe for chaos rounds
#: (``tests/test_chaos.py`` ``test_chaos_round_bit_identical_to_fault_free``)
CHAOS_RECIPE = {"seed": 1234, "drop": 0.10, "duplicate": 0.10,
                "reorder": 0.15, "corrupt": 0.05, "delay": 0.10,
                "delay_s": 0.005}
#: the counters the recipe must move in each chaos run
CHAOS_MOVED = ("drops", "redeliveries", "duplicates", "dedup_hits",
               "corruptions", "corrupt_rejected")
#: reliable delivery on every protocol queue over TCP, ``reply_*`` among
#: them: a SIGKILLed shard loses whatever it held (the patterns of the
#: JAX package's ``test_broker_killed_and_restarted_mid_round``)
CHAOS_TCP_RELIABLE = ("intermediate_queue*", "gradient_queue*",
                      "rpc_queue", "reply_*")
#: the shard killed in the TCP chaos run: the owner of this queue
CHAOS_KILL_QUEUE = "intermediate_queue_0_0"
#: each chaos run's client timeout; no barrier waits it out
CHAOS_TIMEOUT = 120.0


def chaos_config(workdir: pathlib.Path, chaos: bool,
                 reliable_queues: tuple | None = None):
    """The slice's path: ``dcsl_strict`` at KWT-1's width
    (:func:`variant_protocol_config`: bf16, the int8 codec both ways,
    every kernel flag, the sharded fold) with ``learning.control-count:
    1`` — lockstep feeders and the strict window's sorted pop make a
    fault-free run bit-identical to itself.  With ``chaos``,
    :data:`CHAOS_RECIPE` and ``transport.reliable`` (over
    ``reliable_queues`` when given)."""
    cfg = variant_protocol_config(workdir, "dcsl_strict")
    cfg = dataclasses.replace(cfg, learning=dataclasses.replace(
        cfg.learning, control_count=1))
    if chaos:
        cfg = dataclasses.replace(
            cfg, chaos=dataclasses.replace(cfg.chaos, enabled=True,
                                           **CHAOS_RECIPE),
            transport=dataclasses.replace(
                cfg.transport, reliable=True,
                reliable_queues=(reliable_queues
                                 or cfg.transport.reliable_queues)))
    return cfg.validate()


def _host_tree(tree: dict) -> dict:
    return {k: (_host_tree(v) if isinstance(v, dict)
                else v.detach().to("cpu", copy=True))
            for k, v in tree.items()}


def _differing_leaves(a: dict, b: dict, path: str = "") -> list:
    """The leaves of two parameter trees that are not equal bit for bit
    (a missing or extra key counts)."""
    out = [f"{path}{k}" for k in set(a) ^ set(b)]
    for k in sorted(set(a) & set(b)):
        if isinstance(a[k], dict):
            out += _differing_leaves(a[k], b[k], f"{path}{k}.")
        elif not (a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                  and torch.equal(_bits(a[k]), _bits(b[k]))):
            out.append(f"{path}{k}")
    return out


def _fault_delta(before: dict) -> dict:
    from split_learning_torch.runtime.trace import default_fault_counters
    now = default_fault_counters.snapshot()
    return {k: v - before.get(k, 0) for k, v in sorted(now.items())
            if v != before.get(k, 0)}


def phase_chaos_protocol(workdir: pathlib.Path) -> dict:
    """The slice's path (:func:`chaos_config`) as the protocol round in
    one process (``run_inproc``), each run checked and its codec and
    finalize launches held bit for bit by :func:`_run_variant`: twice
    fault-free over the shared bus (their final parameters must agree bit
    for bit: the determinism that makes the next check mean something),
    then under :data:`CHAOS_RECIPE` with every participant on its own
    ``make_runtime_transport`` stack (async sender, reliable layer, chaos)
    over that bus.  The chaos run must end bit for bit at the fault-free
    parameters, with the fault-free runs' samples and launches (a
    redelivery resends bytes, it never encodes again), the counters of
    :data:`CHAOS_MOVED` above 0, ``transport_rtt`` observed (one
    observation an envelope's arrival), and no reliable daemon left
    running."""
    from split_learning_torch.runtime.trace import (
        default_fault_counters, default_histograms,
    )

    def rtt_count() -> int:
        return default_histograms.snapshot().get(
            "transport_rtt", {}).get("count", 0)
    name = "dcsl_strict"
    out, params = {}, {}
    for label, chaos in (("fault_free_a", False), ("fault_free_b", False),
                         ("chaos", True)):
        cfg = chaos_config(workdir / f"chaos_{label}", chaos)
        box = {}

        def run(c):
            server, _, bus, result = run_protocol(c, timeout=CHAOS_TIMEOUT)
            box["result"] = result
            return server, bus, result

        before, rtt0 = default_fault_counters.snapshot(), rtt_count()
        out[label] = _run_variant(f"{name} {label}", cfg, run)
        out[label]["faults"] = _fault_delta(before)
        out[label]["transport_rtt"] = rtt_count() - rtt0
        _check_variant_launches(name, out[label]["launches"])
        params[label] = _host_tree(box["result"].params)
        print(f"  {label}: faults {out[label]['faults']}; transport_rtt "
              f"observations {out[label]['transport_rtt']}")
    differ = _differing_leaves(params["fault_free_a"],
                               params["fault_free_b"])
    check(not differ, f"the two fault-free runs differ at {differ[:8]} "
          f"({len(differ)} leaves)")
    chaos, base = out["chaos"], out["fault_free_a"]
    differ = _differing_leaves(params["chaos"], params["fault_free_a"])
    check(not differ, f"the chaos run differs from the fault-free runs "
          f"at {differ[:8]} ({len(differ)} leaves)")
    check([r["samples"] for r in chaos["rounds"]]
          == [r["samples"] for r in base["rounds"]],
          f"chaos samples {chaos['rounds']}, fault-free {base['rounds']}")
    check(chaos["launches"] == base["launches"],
          f"chaos launches {chaos['launches']}, fault-free "
          f"{base['launches']}")
    for k in CHAOS_MOVED:
        check(chaos["faults"].get(k, 0) > 0,
              f"the chaos run moved no {k}: {chaos['faults']}")
    # the reliable receiver times every envelope's arrival
    check(chaos["transport_rtt"] > 0, "the chaos run observed no "
          "transport_rtt")
    for label in ("fault_free_a", "fault_free_b"):
        check(not any(out[label]["faults"].get(k) for k in CHAOS_MOVED),
              f"{label} counted faults: {out[label]['faults']}")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("reliable-", "async-sender",
                                   "prefetch-"))]
    check(not alive, f"threads of the stacks left running: {alive}")
    n = sum(p.numel() for layer in params["chaos"].values()
            for p in layer.values())
    print(f"  chaos run bit for bit equal to both fault-free runs over "
          f"{n} parameters; launches {chaos['launches']} (fault-free "
          f"{base['launches']}); run walls {base['run_wall_s']:.3f} / "
          f"{out['fault_free_b']['run_wall_s']:.3f} / "
          f"{chaos['run_wall_s']:.3f} s")
    out["parameters_compared"] = n
    return out


def phase_chaos_tcp(workdir: pathlib.Path, inproc: dict,
                    timeout: float = 300.0) -> dict:
    """The slice's path in its deployment shape on a sharded plane
    (:func:`_run_tcp` with ``shards=2``: ``python -m
    split_learning_torch.broker --shards 2``, the server and three client
    processes with ``broker.shards: 2``): once fault-free, then under
    :data:`CHAOS_RECIPE` with reliable delivery on
    :data:`CHAOS_TCP_RELIABLE`, where the shard that owns
    :data:`CHAOS_KILL_QUEUE` is SIGKILLed once the server has logged its
    first ``SYN ->`` and started again on its port with the command line
    the supervisor printed.  Both runs: each round ok with the in-process
    run's samples, every UPDATE folded, the predicted launches.  The
    chaos run: the participants' last ``kind=faults`` records sum to
    ``reconnects`` >= 1 and to :data:`CHAOS_MOVED` above 0, both shards
    carried frames, and the server's final checkpoint equals the
    fault-free run's bit for bit."""
    from split_learning_torch.runtime.bus import (
        broker_stats, shard_for,
    )
    from split_learning_torch.runtime.checkpoint import load_checkpoint
    name = "dcsl_strict"
    victim = shard_for(CHAOS_KILL_QUEUE, 2)
    out, params = {}, {}
    for label, chaos in (("fault_free", False), ("chaos", True)):
        killed: dict = {}

        def kill_after_syn(d, spawn, base):
            log = d / "server.log"
            end = time.monotonic() + timeout
            while "SYN ->" not in log.read_text():
                check(time.monotonic() < end, "the server sent no SYN")
                time.sleep(0.02)
            pid = broker_stats("127.0.0.1", base + victim)["pid"]
            os.kill(pid, signal.SIGKILL)
            killed["t"] = time.monotonic()
            blog = d / "broker.log"
            while "(restart: " not in blog.read_text():
                check(time.monotonic() < end,
                      "the supervisor did not report the dead shard")
                time.sleep(0.02)
            cmd = blog.read_text().split("(restart: ", 1)[1].split(
                ")", 1)[0].split()
            check(cmd[1:3] == ["-m", "split_learning_torch.broker"]
                  and str(base + victim) in cmd,
                  f"restart command {cmd}")
            spawn("broker_shard_restarted", cmd[1:])
            while not _answers(broker_stats, base + victim):
                check(time.monotonic() < end, "the shard did not restart")
                time.sleep(0.05)
            killed["down_s"] = time.monotonic() - killed["t"]
            killed["command"] = " ".join(cmd)

        t0 = time.perf_counter()
        cfg, wall, stats, reports, card_peak_mib = _run_tcp(
            workdir / f"chaos_tcp_{label}",
            lambda d: chaos_config(d, chaos, CHAOS_TCP_RELIABLE),
            timeout, shards=2, during=kill_after_syn if chaos else None,
            broker_rc=1 if chaos else 0)
        phase_wall = time.perf_counter() - t0
        launches = {k: sum(r["launches"].get(k, 0)
                           for r in reports.values())
                    for k in reports["server"]["launches"]}
        records = _metrics(pathlib.Path(cfg.log_path))
        rounds = sorted((r for r in records if r.get("kind") == "round"),
                        key=lambda r: r["round_idx"])
        aggs = [r for r in records if r.get("kind") == "agg"]
        check(len(rounds) == len(aggs) == cfg.global_rounds,
              f"{label} over TCP: {len(rounds)} rounds, {len(aggs)} folds")
        for rec, agg, want in zip(rounds, aggs,
                                  inproc["fault_free_a"]["rounds"]):
            check(rec["ok"] and rec["num_samples"] == want["samples"],
                  f"{label} over TCP: round {rec}, in process {want}")
            check(agg["folded"] == sum(cfg.clients),
                  f"{label} over TCP: folded {agg['folded']}")
        _check_variant_launches(name, launches)
        last = {}
        for r in records:
            if r.get("kind") == "faults":
                last[r["participant"]] = r
        faults: dict = {}
        for r in last.values():
            for k, v in r.items():
                if isinstance(v, int) and k not in ("round_idx", "gen",
                                                    "cluster", "ts"):
                    faults[k] = faults.get(k, 0) + v
        ck = load_checkpoint(cfg.checkpoint.directory, cfg.model_key)
        check(ck is not None and ck["round_idx"] == cfg.global_rounds,
              f"{label} over TCP: checkpoint {ck and ck['round_idx']}")
        params[label] = ck["params"]
        per_shard = [{k: s.get(k) for k in (
            "shard_index", "shard", "published", "delivered",
            "uptime_s", "error", "published_bytes_by_family")}
            for s in stats]
        out[label] = {
            "run_wall_s": wall, "phase_wall_s": phase_wall,
            "rounds": [{"round": r["round_idx"], "wall_s": r["wall_s"],
                        "samples": r["num_samples"],
                        "val_loss": r["val_loss"]} for r in rounds],
            "launches": launches, "faults": faults,
            "faults_by_participant": {p: {k: v for k, v in r.items()
                                          if isinstance(v, int)}
                                      for p, r in last.items()},
            "shards": per_shard, "kill": killed,
            "card_memory_used_peak_mib": card_peak_mib}
        print(f"  {label} over 2 shards: run {wall:.3f} s; round walls "
              + ", ".join(f"{r['wall_s']:.3f}" for r in out[label][
                  "rounds"])
              + f" s; samples {[r['samples'] for r in out[label]['rounds']]}"
              f"; launches {launches}; faults {faults}; shards "
              f"{per_shard}; kill {killed}")
    chaos = out["chaos"]
    check(chaos["kill"].get("down_s") is not None,
          "the shard was never killed")
    check(chaos["faults"].get("reconnects", 0) >= 1,
          f"no participant reconnected: {chaos['faults']}")
    for k in CHAOS_MOVED:
        check(chaos["faults"].get(k, 0) > 0,
              f"the TCP chaos run moved no {k}: {chaos['faults']}")
    for s in chaos["shards"]:
        check(not s.get("error") and s["published"] > 0,
              f"shard {s} carried no frames")
    differ = _differing_leaves(params["chaos"], params["fault_free"])
    check(not differ, f"the TCP chaos run's checkpoint differs from the "
          f"fault-free run's at {differ[:8]} ({len(differ)} leaves)")
    print(f"  the TCP chaos run's checkpoint equals the fault-free run's "
          f"bit for bit; shard {victim} (owner of {CHAOS_KILL_QUEUE}) "
          f"was down {chaos['kill']['down_s']:.3f} s")
    return out


def _check_lora_result(cfg, params: dict) -> None:
    """A LoRA run's parameters: the frozen leaves (an embedding table, a
    LayerNorm, a bias of an adapted kernel) as the context drew them from
    ``cfg.seed``, an adapted kernel and the classifier moved."""
    from split_learning_torch.models import build_model
    init = build_model(cfg.model_key, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(
                           cfg.seed), **(cfg.model_kwargs or {}))
    p0 = init.state_tree()
    for layer, key in (("layer1", "word_embeddings.weight"),
                       ("layer1", "LayerNorm.weight"),
                       ("layer2", "attention.query.bias")):
        check(torch.equal(params[layer][key].cpu(), p0[layer][key].cpu()),
              f"LoRA: frozen {layer}.{key} moved")
    for layer, key in (("layer2", "attention.query.weight"),
                       (init.specs[-1].name, "classifier.weight")):
        check(not torch.equal(params[layer][key].cpu(),
                              p0[layer][key].cpu()),
              f"LoRA: trained {layer}.{key} did not move")


def phase_bert_slice(workdir: pathlib.Path) -> dict:
    """BERT-base on AG-News with LoRA in process (``run_local``) at full
    width (``configs/bert_lora_agnews.yaml``: vocab 28996, hidden 768,
    12 heads, 12 blocks, FFN 3072, 128 tokens, 4 labels; rank 8, alpha
    16, the default targets, AdamW, bf16), ``[2, 2]``, cut 4, batch 32,
    512 samples a client, 2 rounds (:func:`_run_slice`), the frozen
    leaves checked unchanged; then one round once more, warm and
    traced."""
    from split_learning_torch.runtime.checkpoint import load_checkpoint

    cfg = yaml_config(workdir / "bert_slice", BERT_LORA)
    out = _run_slice("BERT-base LoRA", cfg)
    _check_lora_result(cfg, load_checkpoint(cfg.checkpoint.directory,
                                            cfg.model_key)["params"])
    out["profile"] = phase_profile(dataclasses.replace(cfg,
                                                       global_rounds=1))
    return out


def bert_protocol_config(workdir: pathlib.Path, momentum: float):
    """``configs/bert_lora_agnews.yaml`` as the protocol round runs it:
    one round, an int8 codec on both cut directions, every kernel flag
    on, the sharded (CUDA) fold with ``server-momentum`` =
    ``momentum``."""
    cfg = yaml_config(workdir, BERT_LORA)
    return dataclasses.replace(
        cfg, global_rounds=1,
        transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "int8"}),
        kernels=dataclasses.replace(cfg.kernels, quantize=True,
                                    dequantize=True, stage_update=True),
        aggregation=dataclasses.replace(
            cfg.aggregation, sharded=True,
            server_momentum=momentum)).validate()


def phase_bert_protocol(workdir: pathlib.Path) -> dict:
    """BERT-base with LoRA as the protocol round in one process: two
    feeders and two stage-2 clients, each client drawing its own adapters
    at START and sending its merged weights; the int8 codec on the
    ``(hidden, mask)`` activations (the bf16 hidden leaf quantized, the
    bool mask as it is) and on the gradients (float32 hidden gradient
    quantized, float32 zeros for the mask), every kernel flag on, the
    sharded fold over the merged full trees at ``server-momentum`` 0.9
    then 0 (:func:`_run_protocol_path`: every quantize, dequantize,
    momentum and finalize launch held bit for bit against its plain
    version).  The launches are held to the count the round predicts:
    one quantize and one dequantize a batch a direction (the mask is
    never quantized); one momentum launch per parameter leaf of the model
    in the momentum round, one finalize per leaf in the plain one."""
    from split_learning_torch.models import build_model

    out = _run_protocol_path(
        "BERT protocol",
        lambda m: bert_protocol_config(workdir / f"bert_protocol_{m}", m))
    cfg = bert_protocol_config(workdir / "bert_protocol_count", 0.0)
    leaves = len(build_model(cfg.model_key, device="meta",
                             generator=torch.Generator()).state_dict())
    batches = (cfg.clients[0] * cfg.distribution.num_samples
               // cfg.learning.batch_size)
    want = {0.9: {"quantize": 2 * batches, "dequantize": 2 * batches,
                  "momentum": leaves, "finalize": 0},
            0.0: {"quantize": 2 * batches, "dequantize": 2 * batches,
                  "momentum": 0, "finalize": leaves}}
    for m, counts in want.items():
        got = out["runs"][str(m)]["launches"]
        for name, n in counts.items():
            check(got[name] == n, f"BERT protocol momentum {m}: {name} "
                  f"launched {got[name]} times, predicted {n}")
    out["predicted_launches"] = {str(m): c for m, c in want.items()}
    out["param_leaves"] = leaves
    print(f"  launches as predicted: {batches} batches x 2 directions, "
          f"{leaves} parameter leaves")
    return out


# --------------------------------------------------------------------------
# 27-28. async decoupled split learning and the top-k and delta codecs
# --------------------------------------------------------------------------

#: the async phase's run a: rounds at async-quorum 0
ASYNC_ROUNDS = 3
#: run b: the stage-1 client whose first UPDATE is held back until its
#: next START arrives (it then lands one version late)
LATE_CLIENT = "client_1_1"
#: run b's client timeout: no barrier may wait it out
ASYNC_TIMEOUT = 300.0


def async_protocol_config(workdir: pathlib.Path, quorum: int,
                          rounds: int, codec: dict):
    """Baseline 1 (VGG16/CIFAR10, ``[2, 2]``, cut 7, batch 32, 2500
    samples a client) in async mode: ``pooled-linear`` aux heads,
    ``max-staleness: 2``, ``staleness-decay: 0.5``, ``async-quorum`` =
    ``quorum``; ``codec`` on the wire, every kernel flag on, the sharded
    fold at ``server-momentum: 0.9`` (as :func:`vgg_protocol_config`)."""
    cfg = vgg_protocol_config(workdir, 0.9)
    return dataclasses.replace(
        cfg, global_rounds=rounds,
        transport=dataclasses.replace(cfg.transport, codec=codec),
        learning=dataclasses.replace(
            cfg.learning, mode="async", aux_head="pooled-linear",
            max_staleness=2, staleness_decay=0.5,
            async_quorum=quorum)).validate()


class _AsyncRecorder:
    """Records, while entered: each client's banked overlap samples after
    every overlap pass, the fold's staleness scales by key, and the total
    weights ``tw`` the finalize and momentum wrappers are handed (a
    wrapper over whatever is installed, restored on exit)."""

    def __init__(self, ku):
        self.ku = ku
        self.banked: list = []
        self.scales: list = []
        self.tws: dict = {"finalize": set(), "momentum": set()}

    def __enter__(self):
        from split_learning_torch.runtime import aggregate as agg
        from split_learning_torch.runtime.client import ProtocolClient
        ku, rec = self.ku, self
        self._saved = [(ProtocolClient, "_overlap_ticks",
                        ProtocolClient._overlap_ticks),
                       (agg.StreamingFold, "add_update",
                        agg.StreamingFold.add_update),
                       (ku, "finalize_leaf", ku.finalize_leaf),
                       (ku, "momentum_leaf", ku.momentum_leaf)]
        overlap, add, fin, mom = (f for _, _, f in self._saved)

        def overlap_ticks(client):
            overlap(client)
            if client._overlap_samples:
                rec.banked.append((client.client_id,
                                   client._overlap_samples))

        def add_update(fold, u, *, scale=1.0, key=None):
            rec.scales.append((key or u.client_id, scale))
            return add(fold, u, scale=scale, key=key)

        def finalize_leaf(acc, tw, dtype, *, rnd=False):
            rec.tws["finalize"].add(float(tw))
            return fin(acc, tw, dtype, rnd=rnd)

        def momentum_leaf(acc, base, vel, tw, m, dtype):
            rec.tws["momentum"].add(float(tw))
            return mom(acc, base, vel, tw, m, dtype)

        ProtocolClient._overlap_ticks = overlap_ticks
        agg.StreamingFold.add_update = add_update
        ku.finalize_leaf, ku.momentum_leaf = finalize_leaf, momentum_leaf
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


class _LateUpdateTransport:
    """One client's transport that holds back its first UPDATE and
    publishes it when that client's next START arrives, so that it lands
    exactly one version late (``tests/test_async.py``'s
    ``_UpdateCrashTransport``, but late instead of lost)."""

    def __init__(self, inner, client_id: str):
        from split_learning_torch.runtime.protocol import reply_queue
        self.inner = inner
        self.reply = reply_queue(client_id)
        self.held = None
        self.released = False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def publish(self, queue, payload):
        from split_learning_torch.runtime import protocol as proto
        if (queue == proto.RPC_QUEUE and self.held is None
                and not self.released
                and isinstance(proto.FrameAssembler().feed(payload),
                               proto.Update)):
            self.held = payload
            return
        self.inner.publish(queue, payload)

    def get(self, queue, timeout=None):
        from split_learning_torch.runtime import protocol as proto
        raw = self.inner.get(queue, timeout=timeout)
        if (raw is not None and queue == self.reply
                and self.held is not None
                and isinstance(proto.FrameAssembler().feed(raw),
                               proto.Start)):
            self.inner.publish(proto.RPC_QUEUE, self.held)
            self.held = None
            self.released = True
        return raw


def _run_late_update(cfg, timeout: float):
    """The protocol deployment of ``run_inproc`` with :data:`LATE_CLIENT`
    speaking through a :class:`_LateUpdateTransport`."""
    late = []

    def client_bus(bus, cid):
        if cid != LATE_CLIENT:
            return bus
        late.append(_LateUpdateTransport(bus, cid))
        return late[0]
    return (*_run_inproc_with(cfg, timeout, client_bus, "async run b"),
            late[0])


def _run_inproc_with(cfg, timeout: float, client_bus, label: str):
    """The protocol deployment of ``run_inproc`` (the server in this
    thread, one client thread per client over one ``InProcTransport``),
    each client speaking through ``client_bus(bus, client_id)``."""
    from split_learning_torch.runtime.bus import InProcTransport
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import ProtocolServer

    bus = InProcTransport()
    server = ProtocolServer(cfg, bus, client_timeout=timeout,
                            logger=Logger.for_run(cfg, "server",
                                                  console=False),
                            device=DEVICE)
    clients = [ProtocolClient(cfg, cid, s, client_bus(bus, cid),
                              device=DEVICE)
               for s, n in enumerate(cfg.clients, 1)
               for cid in (f"client_{s}_{i}" for i in range(n))]
    errors: list = []

    def run(c):
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((c.client_id, e))
            bus.close()
    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    try:
        res = server.serve()
    except Exception as e:
        raise SmokeFailure(f"{label} failed: {e!r} (clients: "
                           f"{errors})") from e
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), f"a {label} client did not stop")
    check(not errors, f"{label} clients failed: {errors}")
    _print_heartbeats([c.heartbeats for c in clients])
    return server, clients, bus, res


def _round_bytes(cfg, family: str) -> list:
    """Per round, the bytes the server's ``kind=wire`` records count on
    ``family`` (``rpc`` or ``data``), from their cumulative totals."""
    recs = [r for r in _metrics(pathlib.Path(cfg.log_path))
            if r.get("kind") == "wire"]
    totals = [r[f"cumulative_{family}_bytes"] for r in recs]
    return [b - a for a, b in zip([0] + totals, totals)]


def _family_bytes(bus) -> dict:
    from split_learning_torch.runtime.bus import queue_family
    fam: dict = {}
    for q, nb in bus.bytes_out_snapshot().items():
        fam[queue_family(q)] = fam.get(queue_family(q), 0) + nb
    return fam


def _rounds(label: str, cfg, res, want_samples: int | None) -> list:
    """Each round ok with finite validation (and ``want_samples``
    samples, when given); returns the rounds' walls and rates."""
    check(len(res.history) == cfg.global_rounds,
          f"{label}: {len(res.history)} rounds")
    out = []
    for rec in res.history:
        check(rec.ok and math.isfinite(rec.val_loss)
              and math.isfinite(rec.val_accuracy),
              f"{label} round {rec.round_idx} failed: {rec}")
        if want_samples is not None:
            check(rec.num_samples == want_samples, f"{label} round "
                  f"{rec.round_idx}: {rec.num_samples} samples, expected "
                  f"{want_samples}")
        out.append({"round": rec.round_idx, "wall_s": rec.wall_s,
                    "samples": rec.num_samples,
                    "train_samples_per_s": rec.num_samples / rec.wall_s,
                    "val_loss": rec.val_loss,
                    "val_accuracy": rec.val_accuracy})
    return out


def phase_async_protocol(workdir: pathlib.Path, sync: dict) -> dict:
    """Baseline 1 in async mode as the protocol round in one process
    (:func:`async_protocol_config`), every quantize, dequantize, finalize
    and momentum launch held bit for bit against its plain version
    (:func:`_hold_on_path`).

    * Run a: ``async-quorum: 0``, ``intermediate: int8`` and ``rpc:
      delta:int8``, :data:`ASYNC_ROUNDS` rounds through ``run_inproc``.
      No frame and no byte on the gradient family; every UPDATE a delta
      (``delta_folds``), the rpc family at most 0.3 of the float32 full
      frames it replaces; one quantize and one dequantize per activation
      batch; every round's samples and finite validation.
    * Run b: ``async-quorum: 2`` with :data:`LATE_CLIENT`'s first UPDATE
      held back until its next START (:class:`_LateUpdateTransport`), 2
      rounds, full float32 UPDATEs (a delta against the superseded base
      would be dropped: the server's shadow keeps one version a client,
      as in the JAX package).  At least one stale admit at weight 0.5,
      no barrier waiting out the client timeout, and the finalize and
      momentum launches on the decayed total weight held bit for bit.

    Prints the round walls, samples/s and the overlap samples banked
    between rounds beside the sync baseline-1 protocol round's
    (``sync``: :func:`phase_vgg_protocol`'s result)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.protocol import RPC_QUEUE
    from split_learning_torch.runtime.trace import default_fault_counters

    out = {}
    # -- run a
    cfg = async_protocol_config(workdir / "async_a", 0, ASYNC_ROUNDS,
                                {"intermediate": "int8",
                                 "rpc": "delta:int8"})
    held: dict = {}
    seen: dict = {}
    originals = _hold_on_path(kq, ku, held, seen)
    try:
        with _AsyncRecorder(ku) as rec:
            faults0 = default_fault_counters.snapshot()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            server, clients, bus, res = run_protocol(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launch_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    faults = _fault_delta(faults0)
    rounds = _rounds("async a", cfg, res,
                     _expected_samples(cfg, protocol=True))
    fam = _family_bytes(bus)
    grad_queues = [q for q in bus.bytes_out_snapshot()
                   if q.startswith("gradient_queue")]
    check(not grad_queues and not fam.get("gradient"),
          f"async run a sent gradient frames: {grad_queues} {fam}")
    _check_held("async protocol a", 0.9, held, launches)
    batches = (cfg.clients[0] * cfg.distribution.num_samples
               // cfg.learning.batch_size)
    for name in ("quantize", "dequantize"):
        check(launches[name] == ASYNC_ROUNDS * batches,
              f"async a: {name} launched {launches[name]} times, "
              f"expected {ASYNC_ROUNDS * batches} (activations only)")
    check(launches["quantize_generic"] == 0
          and launches["finalize"] > 0 and launches["momentum"] > 0,
          f"async a launches {launches}")
    full = sum(c.raw_bytes_out.get(RPC_QUEUE, 0) for c in clients)
    rpc = _round_bytes(cfg, "rpc")
    ratio = sum(rpc) / full if full else float("inf")
    n_up = sum(cfg.clients) * ASYNC_ROUNDS
    check(faults.get("delta_folds") == n_up
          and not faults.get("delta_full_frames")
          and not faults.get("delta_resyncs"),
          f"async a: every UPDATE a delta, {n_up} expected: {faults}")
    check(ratio <= 0.3, f"async a: rpc bytes {sum(rpc)} are {ratio:.4f} "
          f"of the float32 full frames ({full} B)")
    out["a"] = {"rounds": rounds, "run_wall_s": wall,
                "phases": server.ctx.round_phases,
                "bytes_by_family": fam, "rpc_bytes_per_round": rpc,
                "rpc_full_frame_bytes": full, "rpc_ratio": ratio,
                "faults": faults, "launches": launches, "held": held,
                "quantized_dtypes": seen,
                "overlap_banked_samples": rec.banked,
                "total_weights": {k: sorted(v)
                                  for k, v in rec.tws.items()},
                "max_memory_allocated_bytes": peak}
    # -- run b
    cfg = async_protocol_config(workdir / "async_b", 2, 2,
                                {"intermediate": "int8"})
    held_b: dict = {}
    originals = _hold_on_path(kq, ku, held_b, {})
    try:
        with _AsyncRecorder(ku) as rec_b:
            faults0 = default_fault_counters.snapshot()
            _reset_launches()
            t0 = time.perf_counter()
            server_b, _, bus_b, res_b, late = _run_late_update(
                cfg, ASYNC_TIMEOUT)
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
            launches_b = _launch_counts()
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    faults_b = _fault_delta(faults0)
    rounds_b = _rounds("async b", cfg, res_b, None)
    stale = [(k, s) for k, s in rec_b.scales if s != 1.0]
    check(late.released, "async b: the held UPDATE was never released")
    check(faults_b.get("agg_stale_admits", 0) >= 1
          and (f"{LATE_CLIENT}@v1", 0.5) in stale,
          f"async b: no stale admit of {LATE_CLIENT} at weight 0.5: "
          f"{faults_b} {stale}")
    check(not faults_b.get("timeouts")
          and all(r["wall_s"] < ASYNC_TIMEOUT for r in rounds_b),
          f"async b: a barrier waited out the client timeout: "
          f"{faults_b} {rounds_b}")
    _check_held("async protocol b", 0.9, held_b, launches_b)
    check(launches_b["finalize"] > 0 and launches_b["momentum"] > 0,
          f"async b launches {launches_b}")
    tws = {k: sorted(v) for k, v in rec_b.tws.items()}
    out["b"] = {"rounds": rounds_b, "run_wall_s": wall_b,
                "phases": server_b.ctx.round_phases,
                "bytes_by_family": _family_bytes(bus_b),
                "faults": faults_b, "stale_scales": stale,
                "launches": launches_b, "held": held_b,
                "overlap_banked_samples": rec_b.banked,
                "total_weights": tws}
    s0 = sync["runs"]["0.9"]
    for r in rounds:
        print(f"  async a round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_samples_per_s']:.1f} "
              f"training samples/s, val_loss {r['val_loss']:.4f} val_acc "
              f"{r['val_accuracy']:.4f}")
    print(f"  (sync baseline-1 protocol round: wall "
          f"{s0['round_wall_s']:.3f} s, {s0['train_samples_per_s']:.1f} "
          f"samples/s)")
    print(f"  async a: run {wall:.3f} s; phases {server.ctx.round_phases};"
          f" bytes by family {fam}; rpc per round {rpc} = {ratio:.4f} of "
          f"the float32 full frames ({full} B); overlap banked "
          f"{rec.banked}; faults {faults}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    for r in rounds_b:
        print(f"  async b round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, val_loss {r['val_loss']:.4f}")
    print(f"  async b: run {wall_b:.3f} s; stale admits {stale}; total "
          f"weights {tws}; faults {faults_b}; launches {launches_b}")
    return out


def phase_codec_protocol(workdir: pathlib.Path) -> dict:
    """Baseline 1 in sync mode as the protocol round in one process, 2
    rounds, ``intermediate: int8``, ``gradient: "topk:0.05"``, ``rpc:
    delta:int8``, every kernel flag on, the sharded fold at
    ``server-momentum: 0.9``.  Every quantize, dequantize, finalize and
    momentum launch held bit for bit (:func:`_hold_on_path`; the top-k
    gradient frames are never quantized).  Every top-k step is held to
    the error-feedback identity (the sent values plus the new residual
    equal the gradient plus the old residual, bit for bit; the sent
    entries zero in the new residual), and the steps that start from a
    carried (nonzero) residual are counted.  The gradient family's bytes
    are held to ≈ 0.1 of the float32 dense frames; every UPDATE is a
    delta (``delta_full_frames`` 0)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.codec import sparse
    from split_learning_torch.runtime.trace import default_fault_counters

    cfg = vgg_protocol_config(workdir / "codec", 0.9)
    cfg = dataclasses.replace(
        cfg, global_rounds=2, transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": "int8",
                                  "gradient": "topk:0.05",
                                  "rpc": "delta:int8"})).validate()
    ef = {"steps": 0, "carried": 0, "broken": 0}
    lock = threading.Lock()
    topk = sparse.topk_dev

    def topk_held(g, res, k):
        idx, val, new_res = topk(g, res, k)
        acc = g.reshape(-1).to(torch.float32) + res
        sent = torch.zeros_like(acc)
        sent[idx.long()] = val
        ok = (torch.equal(_bits(sent + new_res), _bits(acc))
              and not bool(new_res[idx.long()].any()))
        with lock:
            ef["steps"] += 1
            ef["carried"] += int(bool(res.any()))
            ef["broken"] += int(not ok)
        return idx, val, new_res
    held: dict = {}
    seen: dict = {}
    originals = _hold_on_path(kq, ku, held, seen)
    sparse.topk_dev = topk_held
    try:
        faults0 = default_fault_counters.snapshot()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        server, clients, bus, res = run_protocol(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        sparse.topk_dev = topk
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    faults = _fault_delta(faults0)
    rounds = _rounds("codec", cfg, res,
                     _expected_samples(cfg, protocol=True))
    _check_held("codec protocol", 0.9, held, launches)
    batches = (cfg.clients[0] * cfg.distribution.num_samples
               // cfg.learning.batch_size)
    for name in ("quantize", "dequantize"):
        check(launches[name] == 2 * batches, f"codec: {name} launched "
              f"{launches[name]} times, expected {2 * batches}")
    fam = _family_bytes(bus)
    itemsize = torch.tensor([], dtype=clients[0].wire_dtype).element_size()
    dense32 = sum(n for c in clients for q, n in c.raw_bytes_out.items()
                  if q.startswith("gradient_queue")) // itemsize * 4
    ratio = fam.get("gradient", 0) / dense32 if dense32 else float("inf")
    check(0.09 <= ratio <= 0.11, f"codec: gradient bytes "
          f"{fam.get('gradient')} are {ratio:.4f} of the float32 dense "
          f"frames ({dense32} B)")
    check(ef["steps"] == 2 * batches and not ef["broken"]
          and ef["carried"] >= ef["steps"] - 2 * cfg.clients[0]
          * cfg.clients[1], f"codec: error feedback {ef}")
    residuals = {c.client_id: {k: float(v.norm())
                               for k, v in c.codecs["gradient"]
                               .state_dict().items()}
                 for c in clients if c.stage == 2}
    check(all(v and all(n > 0 for n in v.values())
              for v in residuals.values()),
          f"codec: residuals not carried: {residuals}")
    n_up = sum(cfg.clients) * cfg.global_rounds
    check(faults.get("delta_folds") == n_up
          and not faults.get("delta_full_frames"),
          f"codec: every UPDATE a delta, {n_up} expected: {faults}")
    rpc = _round_bytes(cfg, "rpc")
    out = {"rounds": rounds, "run_wall_s": wall,
           "phases": server.ctx.round_phases, "bytes_by_family": fam,
           "gradient_dense_float32_bytes": dense32,
           "gradient_ratio": ratio, "error_feedback": ef,
           "residual_norms": residuals, "rpc_bytes_per_round": rpc,
           "delta_full_frames": faults.get("delta_full_frames", 0),
           "faults": faults, "launches": launches, "held": held,
           "quantized_dtypes": seen}
    for r in rounds:
        print(f"  codec round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_samples_per_s']:.1f} "
              f"training samples/s, val_loss {r['val_loss']:.4f} val_acc "
              f"{r['val_accuracy']:.4f}")
    print(f"  codec: run {wall:.3f} s; phases {server.ctx.round_phases}; "
          f"bytes by family {fam}; gradient {ratio:.4f} of the float32 "
          f"dense frames ({dense32} B); error feedback {ef}; rpc per round "
          f"{rpc}; delta_full_frames "
          f"{faults.get('delta_full_frames', 0)}; faults {faults}; "
          f"launches {launches}")
    return out


#: the activation codec the JAX package's scheduler grants a client it
#: finds slow on the wire (``config.yaml``'s ``wire-slow-codec``)
WIRE_SLOW_CODEC = "int8:64"


def wire_slow_protocol_config(workdir: pathlib.Path):
    """Cell 6's baseline 1 protocol round (:func:`vgg_protocol_config` at
    ``server-momentum: 0.9``, 1 round) at :data:`WIRE_SLOW_CODEC` on both
    data families, every kernel flag on."""
    cfg = vgg_protocol_config(workdir, 0.9)
    return dataclasses.replace(
        cfg, transport=dataclasses.replace(
            cfg.transport, codec={"intermediate": WIRE_SLOW_CODEC,
                                  "gradient": WIRE_SLOW_CODEC})).validate()


def check_wire_slow_launches(launches: dict, batches: int) -> None:
    """Every quantize launch of the wire-slow round on the generic route
    (a tile of 64 is 128 bytes of bf16, 256 of float32: no vec tile),
    every dequantize on the vec route (four 16-byte int8 chunks a
    tile), one of each a data frame: an activation and a gradient a
    training batch."""
    want = {"quantize_generic": 2 * batches, "quantize": 0,
            "dequantize": 2 * batches, "dequantize_generic": 0}
    for name, n in want.items():
        check(launches[name] == n, f"wire_slow: {name} launched "
              f"{launches[name]} times, expected {n}")
    check(launches["momentum"] > 0 and launches["finalize"] > 0,
          f"wire_slow: the fold's kernels were not launched: {launches}")


def phase_wire_slow_protocol(workdir: pathlib.Path) -> dict:
    """Cell 27: the wire-slow codec on cell 6's round
    (:func:`wire_slow_protocol_config`).  Every quantize, dequantize,
    finalize and momentum launch held bit for bit
    (:func:`_hold_on_path`); the launch counts by route
    (:func:`check_wire_slow_launches`); each data family's wire bytes
    held to its codes plus 4 bytes of scale a tile of 64, frame headers
    included within 1 %.  Prints the round wall, training samples/s,
    peak memory and validation."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    cfg = wire_slow_protocol_config(workdir / "wire_slow")
    held: dict = {}
    seen: dict = {}
    originals = _hold_on_path(kq, ku, held, seen)
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        server, clients, bus, res = run_protocol(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    rounds = _rounds("wire_slow", cfg, res,
                     _expected_samples(cfg, protocol=True))
    _check_held("wire-slow protocol", 0.9, held, launches)
    batches = (cfg.clients[0] * cfg.distribution.num_samples
               // cfg.learning.batch_size)
    check_wire_slow_launches(launches, batches)
    fam = _family_bytes(bus)
    itemsize = torch.tensor([], dtype=clients[0].wire_dtype).element_size()
    tile = int(WIRE_SLOW_CODEC.split(":")[1])
    coded = {}
    for family in ("intermediate", "gradient"):
        values = sum(n for c in clients for q, n in c.raw_bytes_out.items()
                     if q.startswith(f"{family}_queue")) // itemsize
        want = values + 4 * -(-values // tile)
        coded[family] = {"bytes": fam.get(family, 0), "values": values,
                         "codes_and_scales": want,
                         "ratio": fam.get(family, 0) / want}
        check(values > 0 and 1.0 <= coded[family]["ratio"] <= 1.01,
              f"wire_slow: {family} bytes {fam.get(family)} against "
              f"{want} of codes and scales for {values} values")
    out = {"rounds": rounds, "run_wall_s": wall,
           "phases": server.ctx.round_phases, "bytes_by_family": fam,
           "coded_bytes": coded, "max_memory_allocated_bytes": peak,
           "launches": launches, "held": held, "quantized_dtypes": seen}
    for r in rounds:
        print(f"  wire_slow round {r['round']}: wall {r['wall_s']:.3f} s, "
              f"{r['samples']} samples, {r['train_samples_per_s']:.1f} "
              f"training samples/s, peak memory {peak / 2**30:.2f} GiB, "
              f"val_loss {r['val_loss']:.4f} val_acc "
              f"{r['val_accuracy']:.4f}")
    print(f"  wire_slow: run {wall:.3f} s; phases "
          f"{server.ctx.round_phases}; bytes against codes and scales "
          + ", ".join(f"{f} {c['bytes']} / {c['codes_and_scales']} "
                      f"({c['ratio']:.5f})" for f, c in coded.items())
          + f"; quantized dtypes {seen}; launches {launches}")
    return out


#: the aggregator-tree phase: the stage-1 aggregator that run b kills
TREE_KILLED = "aggregator_0_0"
#: run b's partial codec
TREE_CODEC = "delta:int8:64"


def tree_protocol_config(workdir: pathlib.Path, partial: str | None):
    """Cell 6's baseline 1 (:func:`vgg_protocol_config` at
    ``server-momentum: 0.9``: VGG16/CIFAR10 at full width, cut 7, batch
    32, 2500 samples a client, int8 activations and gradients, every
    kernel, the sharded fold) at ``clients: [4, 2]`` under the
    aggregator tree (``aggregation.fan-in: 2``, ``levels: 2``), one
    round; ``partial`` the ``transport.codec`` partial spec, or None
    for raw float32 partials."""
    cfg = vgg_protocol_config(workdir, 0.9)
    codec = dict(cfg.transport.codec)
    if partial is not None:
        codec["partial"] = partial
    return dataclasses.replace(
        cfg, clients=[4, 2],
        transport=dataclasses.replace(cfg.transport, codec=codec),
        aggregation=dataclasses.replace(cfg.aggregation, fan_in=2,
                                        levels=2)).validate()


class _UpdateTap:
    """The clients' transport that keeps every frame part a client
    publishes on an aggregate queue (the round's chunked UPDATEs)."""

    def __init__(self, inner):
        self.inner = inner
        self.parts: list = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def publish(self, queue, payload):
        if queue.startswith("aggregate_queue"):
            with self._lock:
                self.parts.append(payload)
        self.inner.publish(queue, payload)

    def updates(self) -> dict:
        """The UPDATEs the parts carried, by client id."""
        from split_learning_torch.runtime import protocol as proto
        asm, out = proto.FrameAssembler(), {}
        for part in self.parts:
            msg = asm.feed(part)
            if isinstance(msg, proto.Update):
                check(msg.client_id not in out,
                      f"two UPDATEs from {msg.client_id}")
                out[msg.client_id] = msg
        return out


class _FinishSpy:
    """Records, while entered, each streaming fold's finish: the base it
    was given (on the host) and its result."""

    def __enter__(self):
        from split_learning_torch.runtime import aggregate as agg
        self.calls: list = []
        self._agg, self._finish = agg, agg.StreamingFold.finish
        finish, calls = self._finish, self.calls

        def spy(fold, base=None, momentum=0.0, velocity=None, **kw):
            host = None if base is None else _host_tree(base)
            out = finish(fold, base=base, momentum=momentum,
                         velocity=velocity, **kw)
            calls.append((host, momentum, out))
            return out
        agg.StreamingFold.finish = spy
        return self

    def __exit__(self, *exc):
        self._agg.StreamingFold.finish = self._finish


def _flat(tree) -> dict:
    import numpy as np
    from split_learning_torch.ops.fedavg import walk_items
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for p, v in walk_items(tree)}


def _tree_oracle(updates: dict, groups: list, base: dict, m: float,
                 codec: str | None, gen: int, dead: tuple = ()) -> dict:
    """The host fold of the round's UPDATEs in the tree's canonical
    (stage, group, client) order, as the tree computes it: within each
    level-1 group ``nan_to_num(float32(leaf)) * max(1, samples)`` summed
    in member order, each interior group its children's sums in key
    order, each root group's sums divided once by its total weight and
    put through FedAvgM against ``base`` (the plain versions of the
    finalize and momentum kernels, on the host).  With ``codec`` each
    partial an aggregator publishes goes through the partial codec's
    encode and decode (the delta against ``base``), except the groups in
    ``dead``, which the server's fallback drain publishes raw.  Returns
    {"params", "stats", "scales"}: the flat results, and per root stage
    and path the largest tile scale of each codec hop on its way up."""
    import numpy as np
    from split_learning_torch.ops.fedavg import unflatten_items, walk_items
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime.codec.partial import (
        decode_partial_entry, encode_partial_entry,
    )

    by_key = {g.key: g for g in groups}
    scales: dict = {}

    def add(acc, items):
        for p, c in items:
            acc[p] = acc[p] + c if p in acc else c

    def entry(g) -> dict:
        acc, sacc, w_tot, sw_tot, hops = {}, {}, 0.0, 0.0, []
        for key in g.members:
            if g.level == 1:
                u = updates[key]
                w = max(1, u.num_samples)
                w_tot += w
                add(acc, ((p, np.nan_to_num(np.asarray(v, np.float32)) * w)
                          for p, v in _flat(u.params).items()))
                if u.batch_stats:
                    sw_tot += w
                    add(sacc, ((p, np.nan_to_num(
                        np.asarray(v, np.float32)) * w)
                        for p, v in _flat(u.batch_stats).items()))
            else:
                child = entry(by_key[key])
                w_tot += child["weight"]
                sw_tot += child["stat_weight"]
                add(acc, ((p, np.nan_to_num(v))
                          for p, v in child["flat"].items()))
                add(sacc, ((p, np.nan_to_num(v))
                           for p, v in child["stat_flat"].items()))
                hops += child["hops"]
        ent = {"flat": acc, "stat_flat": sacc, "weight": w_tot,
               "stat_weight": sw_tot, "hops": hops}
        if codec is None or g.key in dead:
            return ent
        enc, cs, cb = encode_partial_entry(
            {"sums": unflatten_items(acc), "weight": w_tot,
             "stat_sums": unflatten_items(sacc), "stat_weight": sw_tot},
            codec, base=base, base_gen=gen)
        dec = decode_partial_entry(enc, cs, codec_base=cb, base=base,
                                   base_gen=gen)
        hops = hops + [{p: float(np.max(q.scale))
                        for p, q in walk_items(enc["sums"])}]
        return {"flat": _flat(dec["sums"]),
                "stat_flat": _flat(dec["stat_sums"]), "weight": w_tot,
                "stat_weight": sw_tot, "hops": hops}

    params, stats = {}, {}
    base_flat = _flat(base)
    for g in sorted((g for g in groups if g.parent is None),
                    key=lambda g: (g.stage, g.key)):
        ent = entry(g)
        tw = 0.0 + ent["weight"]
        for p, acc in ent["flat"].items():
            out, _ = ku.momentum_reference(
                torch.from_numpy(np.nan_to_num(acc)),
                torch.from_numpy(base_flat[p]),
                torch.zeros(acc.shape, dtype=torch.float32), tw, m,
                torch.float32)
            params[p] = out.numpy()
            scales[p] = sum(h.get(p, 0.0) for h in ent["hops"])
        stw = 0.0 + ent["stat_weight"]
        for p, acc in ent["stat_flat"].items():
            stats[p] = ku.finalize_reference(
                torch.from_numpy(np.nan_to_num(acc)), stw,
                torch.float32).numpy()
    return {"params": params, "stats": stats, "scales": scales}


def _bit_diffs(got: dict, want: dict) -> list:
    """Paths where two flat trees differ in keys, dtype, shape or bits."""
    out = sorted(map(str, set(got) ^ set(want)))
    for p in sorted(set(got) & set(want), key=str):
        a, b = got[p], want[p]
        if not (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()):
            out.append(str(p))
    return out


def _run_tree(label: str, cfg, kill: str | None) -> dict:
    """One tree round in process with every codec and stage-update launch
    held bit for bit (:func:`_hold_on_path`), the clients' UPDATE frames
    tapped (:class:`_UpdateTap`) and the fold's finish recorded
    (:class:`_FinishSpy`); ``kill`` an aggregator that dies at its start
    (``L1Aggregator.TEST_KILL``)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime import aggregate as agg
    from split_learning_torch.runtime.trace import default_fault_counters

    tap: list = []

    def client_bus(bus, cid):
        if not tap:
            tap.append(_UpdateTap(bus))
        return tap[0]
    held: dict = {}
    seen: dict = {}
    originals = _hold_on_path(kq, ku, held, seen)
    if kill is not None:
        agg.L1Aggregator.TEST_KILL.add(kill)
    try:
        with _FinishSpy() as spy:
            faults0 = default_fault_counters.snapshot()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            server, clients, bus, res = _run_inproc_with(
                cfg, 600.0, client_bus, label)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launch_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        agg.L1Aggregator.TEST_KILL.discard(kill)
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    faults = _fault_delta(faults0)
    rounds = _rounds(label, cfg, res, _expected_samples(cfg, protocol=True))
    _check_held(label, 0.9, held, launches)
    check(len(spy.calls) == 1, f"{label}: {len(spy.calls)} fold finishes")
    base, _, fold = spy.calls[0]
    recs = [r for r in _metrics(pathlib.Path(cfg.log_path))
            if r.get("kind") == "agg"]
    check(len(recs) == 1, f"{label}: {len(recs)} kind=agg records")
    rec = recs[0]
    samples = _expected_samples(cfg, protocol=True)
    check(rec["partials"] == fold.partials == 2 and rec["folded"] == 2
          and rec["fan_in"] == 2 and rec["levels"] == 2
          and rec["n_samples"] == samples,
          f"{label}: the root folded {rec} (expected 2 partials holding "
          f"all 6 clients' {samples} stage-1 samples)")
    batches = cfg.clients[0] * (cfg.distribution.num_samples
                                // cfg.learning.batch_size)
    n_params, n_stats = len(_flat(fold.params)), len(_flat(fold.stats))
    for name, want in (("quantize", 2 * batches), ("dequantize",
                                                   2 * batches),
                       ("quantize_generic", 0), ("momentum", n_params),
                       ("finalize", n_stats)):
        check(launches[name] == want, f"{label}: {name} launched "
              f"{launches[name]} times, expected {want}")
    updates = tap[0].updates()
    check(sorted(updates) == sorted(
        f"client_{s}_{i}" for s, n in enumerate(cfg.clients, 1)
        for i in range(n)) and all(u.round_idx == rec["gen"]
                                   for u in updates.values()),
          f"{label}: tapped UPDATEs {sorted(updates)}")
    return {"cfg": cfg, "server": server, "bus": bus, "rounds": rounds,
            "wall": wall, "faults": faults, "launches": launches,
            "held": held, "seen": seen, "peak": peak, "base": base,
            "fold": fold, "rec": rec, "updates": updates}


def phase_tree_protocol(workdir: pathlib.Path) -> dict:
    """Cell 6's baseline 1 at ``[4, 2]`` under the thread-mode aggregator
    tree (:func:`tree_protocol_config`): groups g0 {client_1_0,
    client_1_1}, g1 {client_1_2, client_1_3} and g2 {client_2_0,
    client_2_1}, and g3 {g0, g1} at level 2, so the root folds 2
    partials (g2's and g3's).  Every quantize, dequantize, finalize and
    momentum launch is held bit for bit against its plain version
    (:func:`_hold_on_path`), and the launches counted: one quantize and
    one dequantize a frame, one momentum launch a parameter leaf and one
    finalize a statistic at the root.

    * Run a, raw float32 partials: the ``kind=agg`` record shows 2
      partials and every stage-1 sample, and the root's parameters and
      statistics equal, bit for bit, the host fold of the six tapped
      UPDATEs in the tree's canonical order (:func:`_tree_oracle`).
    * Run b, ``transport.codec: {partial: "delta:int8:64"}`` with
      :data:`TREE_KILLED` dying at its start: the round completes through
      the direct-to-root fallback (``agg_l1_fallbacks``); the root equals
      bit for bit the same host fold of run b's own UPDATEs with each
      published partial through the codec (g0's substitute raw); against
      that fold without the codec every value is within the derived
      bound: half the leaf's largest tile scale for each codec hop on its
      way up (``round(x / scale)`` moves a value by at most half a step;
      a lower hop's error reaches the parent's mean at its weight share,
      at most 1), widened by 2**-16 for a tie that float32 division
      rounds the other way, plus 2**-19 of the leaf's largest value (the
      eight or so float32 roundings of the mean, base, weight and FedAvgM
      chain at 2**-24 each); the root's partial bytes against run a's
      (an int8 code a value and a float32 scale a 64 values: 1.0625 / 4
      bytes, ≈ 0.27).
      The two runs' parameters also differ by their training (the two
      heads take batches as they arrive), printed, not held."""
    import numpy as np
    from split_learning_torch.runtime import aggregate as agg

    out = {}
    a = _run_tree("tree run a", tree_protocol_config(workdir / "tree_a",
                                                     None), None)
    active = [(cid, s) for cid, u in a["updates"].items()
              for s in (u.stage,)]
    groups = agg.plan_tree(active, 2, 2)
    check([(g.idx, g.stage, g.level, g.parent) for g in groups] == [
        (0, 1, 1, 3), (1, 1, 1, 3), (2, 2, 1, None), (3, 1, 2, None)],
        f"tree plan {[g.as_dict() for g in groups]}")
    t0 = time.perf_counter()
    oracle = _tree_oracle(a["updates"], groups, a["base"], 0.9, None,
                          a["rec"]["gen"])
    diffs = (_bit_diffs(_flat(a["fold"].params), oracle["params"])
             + _bit_diffs(_flat(a["fold"].stats), oracle["stats"]))
    check(not diffs, f"tree run a: the root differs from the host fold "
          f"at {diffs[:8]}")
    oracle_s = time.perf_counter() - t0

    b = _run_tree("tree run b", tree_protocol_config(workdir / "tree_b",
                                                     TREE_CODEC),
                  TREE_KILLED)
    check(b["faults"].get("agg_l1_fallbacks", 0) >= 1
          and not b["faults"].get("partial_codec_errors"),
          f"tree run b: no counted fallback: {b['faults']}")
    check(b["rec"]["partial_codec"] == "delta",
          f"tree run b: {b['rec']}")
    gen = b["rec"]["gen"]
    codec = _tree_oracle(b["updates"], groups, b["base"], 0.9, TREE_CODEC,
                         gen, dead=(agg.group_key(0),))
    raw = _tree_oracle(b["updates"], groups, b["base"], 0.9, None, gen)
    got = _flat(b["fold"].params)
    diffs = (_bit_diffs(got, codec["params"])
             + _bit_diffs(_flat(b["fold"].stats), codec["stats"]))
    check(not diffs, f"tree run b: the root differs from the host fold "
          f"through the codec at {diffs[:8]}")
    worst = {"ratio": 0.0}
    for p, want in raw["params"].items():
        err = float(np.max(np.abs(got[p].astype(np.float64) - want)))
        bound = (0.5 * codec["scales"][p] * (1 + 2.0 ** -16)
                 + 2.0 ** -19 * float(np.max(np.abs(want))))
        check(err <= bound, f"tree run b: {p} is {err:.3e} from the "
              f"fold without the codec, bound {bound:.3e}")
        if bound and err / bound > worst["ratio"]:
            worst = {"path": str(p), "err": err, "bound": bound,
                     "ratio": err / bound}
    ratio = b["rec"]["root_ingress_bytes"] / a["rec"]["root_ingress_bytes"]
    check(0.2 <= ratio <= 0.35, f"tree run b: root partial bytes "
          f"{b['rec']['root_ingress_bytes']} are {ratio:.4f} of run a's "
          f"{a['rec']['root_ingress_bytes']}")
    pa = _flat(a["fold"].params)
    vs_a = max(float(np.max(np.abs(got[p] - pa[p]))) for p in got)
    for label, r in (("a", a), ("b", b)):
        fam = _family_bytes(r["bus"])
        out[label] = {
            "rounds": r["rounds"], "run_wall_s": r["wall"],
            "phases": r["server"].ctx.round_phases,
            "bytes_by_family": fam,
            "root_ingress_bytes": r["rec"]["root_ingress_bytes"],
            "agg_record": {k: r["rec"][k] for k in (
                "fan_in", "levels", "partials", "folded", "n_samples",
                "partial_codec", "fold_s", "update_s")},
            "faults": r["faults"], "launches": r["launches"],
            "held": r["held"], "quantized_dtypes": r["seen"],
            "update_samples": {c: u.num_samples
                               for c, u in sorted(r["updates"].items())},
            "max_memory_allocated_bytes": r["peak"]}
        for rr in r["rounds"]:
            print(f"  tree run {label}: wall {rr['wall_s']:.3f} s (run "
                  f"{r['wall']:.3f} s), {rr['samples']} samples, "
                  f"{rr['train_samples_per_s']:.1f} training samples/s, "
                  f"val_loss {rr['val_loss']:.4f} val_acc "
                  f"{rr['val_accuracy']:.4f}; phases "
                  f"{r['server'].ctx.round_phases}; bytes by family {fam}; "
                  f"root partial bytes {r['rec']['root_ingress_bytes']}; "
                  f"agg {out[label]['agg_record']}; UPDATE samples "
                  f"{out[label]['update_samples']}; faults {r['faults']}; "
                  f"peak {r['peak'] / 2**30:.2f} GiB; launches "
                  f"{r['launches']}")
    out["oracle_s"] = oracle_s
    out["root_partial_ratio"] = ratio
    out["codec_worst"] = worst
    out["max_abs_diff_b_vs_a"] = vs_a
    print(f"  tree: run a's root equals the host fold of its 6 UPDATEs bit "
          f"for bit (oracle {oracle_s:.2f} s); run b's equals the codec "
          f"fold bit for bit, worst error against the fold without the "
          f"codec {worst}; root partial bytes b / a {ratio:.4f}; "
          f"largest parameter difference b - a {vs_a:.3e} (training)")
    return out


# --------------------------------------------------------------------------
# 30. round tracing: the traced VGG16 protocol round
# --------------------------------------------------------------------------

#: the critical-path components of ``tools/sl_trace.py``, in its order
TRACE_COMPONENTS = ("compute", "compile", "wire", "queue_wait",
                    "aggregate", "control")
#: the latency histograms a traced protocol round must fill
TRACE_HISTS = ("frame_rtt", "encode", "decode", "step", "queue_wait",
               "agg_fold")
DATA_QUEUES = ("intermediate_queue", "gradient_queue")
TRACE_KERNELS = ("quantize", "dequantize", "finalize", "momentum")


def trace_protocol_config(workdir: pathlib.Path, traced: bool):
    """Cell 6's round at ``server-momentum: 0.9``
    (:func:`vgg_protocol_config`: baseline 1, int8 on both data planes,
    every kernel flag on, the sharded fold), made deterministic so that
    two runs can be held bit for bit: each feeder paired to its own head
    (``topology.in-clusters: 2``; on the shared queue the two heads take
    batches as they arrive) and lockstep feeders (``control-count: 1``;
    with 4 batches in flight a forward runs before or after an earlier
    batch's update as the gradients happen to arrive).
    ``observability`` as the YAML leaves it (on) at ``sample-rate:
    1.0``, or off."""
    cfg = vgg_protocol_config(workdir, 0.9)
    return dataclasses.replace(
        cfg, topology=dataclasses.replace(cfg.topology, in_clusters=2),
        learning=dataclasses.replace(cfg.learning, control_count=1),
        observability=dataclasses.replace(
            cfg.observability, enabled=traced, sample_rate=1.0)).validate()


def _span_records(log_path) -> list:
    """Every span record the participants journaled under ``log_path``
    (the run directories' journals, not their compat links)."""
    return [json.loads(line)
            for f in sorted(pathlib.Path(log_path).glob(
                "artifacts/runs/*/spans-*.jsonl"))
            for line in f.read_text().splitlines() if line.strip()]


def _flow_edges(recs: list) -> tuple:
    """The consume spans whose parent is a publish span of another
    participant (the frame edges), and those whose parent is not."""
    by_id = {r["span"]: r for r in recs}
    good, bad = [], []
    for r in recs:
        if r["name"] != "consume":
            continue
        pub = by_id.get(r.get("parent"))
        ok = (pub is not None and pub["name"] == "publish"
              and pub["part"] != r["part"])
        (good if ok else bad).append(r)
    return good, bad


def _sl_trace(directory: pathlib.Path, out: pathlib.Path) -> list:
    """``tools/sl_trace.py DIR --json -o OUT`` as a subprocess: the
    per-round critical-path reports."""
    proc = subprocess.run(
        [sys.executable, str(HERE / "tools" / "sl_trace.py"),
         str(directory), "--json", "-o", str(out)],
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"tools/sl_trace.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout[proc.stdout.index("["):])


def _latest_latency(records: list) -> dict:
    """Each participant's last ``kind=latency`` record (cumulative)."""
    out = {}
    for r in records:
        if r.get("kind") == "latency":
            out[r["participant"]] = r
    return out


def _run_traced(label: str, cfg) -> dict:
    """One run of :func:`trace_protocol_config` in one process with its
    codec and stage-update launches held bit for bit
    (:func:`_hold_on_path`), counted, and the data-plane parts the bus
    carried tallied (chunk parts and chunked frames apart)."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku
    from split_learning_torch.runtime import bus as tbus
    from split_learning_torch.runtime.protocol import CHUNK_MAGIC
    from split_learning_torch.runtime.trace import default_wire_counters

    held, seen = {}, {}
    parts = {"parts": 0, "chunk_parts": 0, "chunked_frames": 0}
    publish = tbus.InProcTransport.publish

    def tap(bus, queue, payload):
        if queue.startswith(DATA_QUEUES):
            parts["parts"] += 1
            if payload[:4] == CHUNK_MAGIC:
                parts["chunk_parts"] += 1
                # chunk index 0: magic | crc | message id | idx | total
                parts["chunked_frames"] += payload[24:28] == b"\0" * 4
        return publish(bus, queue, payload)

    originals = _hold_on_path(kq, ku, held, seen)
    tbus.InProcTransport.publish = tap
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_launches()
        w0 = default_wire_counters.snapshot()
        t0 = time.perf_counter()
        server, clients, bus, res = run_protocol(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        w1 = default_wire_counters.snapshot()
    finally:
        tbus.InProcTransport.publish = publish
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    rec = res.history[0]
    check(len(res.history) == 1 and rec.ok and math.isfinite(rec.val_loss),
          f"trace run {label} failed: {res.history}")
    want = _expected_samples(cfg, protocol=True)
    check(rec.num_samples == want, f"trace run {label}: "
          f"{rec.num_samples} samples, expected {want}")
    check(server.ctx.last_fold.folded == sum(cfg.clients),
          f"trace run {label}: folded {server.ctx.last_fold.folded}")
    _check_stats_checkpoint(cfg, res, 1)
    _check_held(f"trace run {label}", 0.9, held, launches)
    for name in OFF_PATH_KERNELS:
        check(launches[name] == 0, f"trace run {label}: {name} ran "
              f"{launches[name]} times")
    for name in TRACE_KERNELS:
        check(launches[name] > 0, f"trace run {label}: kernel {name} "
              "was not launched")
    # in one process every participant counts in the process-wide wire
    # registry (the bus they share carries none of its own)
    check(all(p.wire is default_wire_counters
              for p in (server.ctx, *clients)), "a participant counts its "
          "wire traffic outside the process-wide registry")
    data_bus = sum(n for q, n in bus.bytes_out_snapshot().items()
                   if q.startswith(DATA_QUEUES))
    return {"cfg": cfg, "server": server, "clients": clients, "res": res,
            "wall": wall, "launches": launches, "held": held,
            "peak": torch.cuda.max_memory_allocated(),
            "wire": {k: w1[k] - w0[k] for k in w1
                     if isinstance(w1[k], (int, float))},
            "data_bus_bytes": data_bus, "parts": parts,
            "fam": _family_bytes(bus)}


def phase_trace_protocol(workdir: pathlib.Path) -> dict:
    """Cell 26: :func:`trace_protocol_config` as the protocol round in one
    process, run a traced (the default ``observability`` block,
    ``sample-rate: 1.0``) and run b with tracing off, from the same seed
    (:func:`_run_traced`).  Fails unless:

    1. a's parameters and BatchNorm statistics are bit for bit b's;
    2. a's quantize, dequantize, finalize and momentum launches equal
       b's, every one held bit for bit against its plain version;
    3. there is one schema-v1 journal per participant, every record of
       the server's trace id (the clients adopt it from START);
    4. every consume span's parent is a publish span in the sending
       participant's journal: the clients' consumes as many as the
       dequantize launches, their data-queue publishes as many as the
       quantize launches, the server's consumes its UPDATEs;
    5. the clients' ``kind=latency`` records count ``frame_rtt`` once a
       client consume, the server's once an UPDATE folded, and
       ``encode``, ``decode``, ``step``, ``queue_wait`` and ``agg_fold``
       are filled;
    6. the wire counters' data-plane bytes are the bytes the bus carried
       on the data queues, and a's exceed b's by exactly 32 bytes a part
       (and 32 more a chunked frame, whose inner frame carries the
       context too);
    7. ``kind=round`` carries ``phases`` with train, validate and
       checkpoint;
    8. ``tools/sl_trace.py`` on a's journals (``trace.json`` beside
       them): the round's six components sum to its wall within 1 ms,
       over as many frame edges as check 4 found.

    Prints both walls and their ratio (the tracer's cost), the
    histograms, the critical-path split and its slowest edges, and the
    journals' sizes."""
    runs = {label: _run_traced(label, trace_protocol_config(
        workdir / f"trace_{label}", traced))
        for label, traced in (("a", True), ("b", False))}
    a, b = runs["a"], runs["b"]
    log_a = pathlib.Path(a["cfg"].log_path)
    # 1-2. tracing changes nothing the round computes or launches
    for what in ("params", "stats"):
        differ = _differing_leaves(_host_tree(getattr(a["res"], what)),
                                   _host_tree(getattr(b["res"], what)))
        check(not differ, f"traced and untraced {what} differ at "
              f"{differ[:8]} ({len(differ)} leaves)")
    for name in TRACE_KERNELS:
        check(a["launches"][name] == b["launches"][name],
              f"{name}: {a['launches'][name]} launches traced, "
              f"{b['launches'][name]} untraced")
    check(not _span_records(b["cfg"].log_path),
          "the untraced run journaled spans")
    # 3. one journal a participant, one trace
    journals = sorted(log_a.glob("artifacts/runs/*/spans-*.jsonl"))
    names = sorted(j.name for j in journals)
    ids = ["server"] + [c.client_id for c in a["clients"]]
    check(names == sorted(f"spans-{p}.jsonl" for p in ids),
          f"journals {names}")
    recs = _span_records(log_a)
    trace_id = a["server"].ctx.tracer.trace_id
    check(all(r["v"] == 1 for r in recs), "a record is not schema v1")
    check({r["trace"] for r in recs} == {trace_id},
          f"trace ids {sorted({r['trace'] for r in recs})}, server "
          f"{trace_id}")
    # 4. the flow edges
    edges, orphans = _flow_edges(recs)
    check(not orphans, f"{len(orphans)} consume spans without a publish "
          f"parent in the sender's journal: {orphans[:3]}")
    consumes = [e for e in edges if e["part"] != "server"]
    updates = [e for e in edges if e["part"] == "server"]
    publishes = [r for r in recs if r["name"] == "publish"
                 and r.get("queue", "").startswith(DATA_QUEUES)]
    quantized = a["launches"]["quantize"] + a["launches"]["quantize_generic"]
    check(len(consumes) == a["launches"]["dequantize"],
          f"{len(consumes)} client consume spans, "
          f"{a['launches']['dequantize']} dequantize launches")
    check(len(publishes) == quantized, f"{len(publishes)} data-queue "
          f"publish spans, {quantized} quantize launches")
    check(len(updates) == a["server"].ctx.last_fold.folded
          and all(e["kind"] == "Update" for e in updates),
          f"server consumes {[e['kind'] for e in updates]}")
    print(f"  trace run a: {len(consumes)} client consume spans = "
          f"{a['launches']['dequantize']} dequantize launches; "
          f"{len(publishes)} data-queue publish spans = {quantized} "
          f"quantize launches; {len(updates)} UPDATE consumes at the "
          f"server; {len(edges)} frame edges, 0 orphans")
    # 5. the latency histograms
    records = _metrics(log_a)
    lat = _latest_latency(records)
    check(set(lat) == set(ids), f"latency records from {sorted(lat)}")
    rtt_clients = sum(lat[c]["frame_rtt"]["count"] for c in ids[1:])
    check(rtt_clients == len(consumes), f"client frame_rtt count "
          f"{rtt_clients}, client consume spans {len(consumes)}")
    check(lat["server"]["frame_rtt"]["count"] == len(updates),
          f"server frame_rtt count {lat['server']['frame_rtt']}, "
          f"{len(updates)} UPDATEs folded")
    hists = {}
    for name in TRACE_HISTS:
        per = {p: {k: r[name][k] for k in ("count", "p50_ms", "p95_ms",
                                            "p99_ms", "max_ms")}
               for p, r in lat.items() if name in r}
        check(per and all(h["count"] > 0 for h in per.values()),
              f"histogram {name} missing or empty: {per}")
        hists[name] = per
        print(f"  histogram {name}: " + "; ".join(
            f"{p} {h['count']} p50 {h['p50_ms']} p95 {h['p95_ms']} p99 "
            f"{h['p99_ms']} max {h['max_ms']} ms" for p, h in per.items()))
    # 6. the wire counters against the bus, and the context's bytes
    for label, r in runs.items():
        check(r["wire"]["data_bytes_out"] == r["data_bus_bytes"],
              f"run {label}: wire counters' data bytes "
              f"{r['wire']['data_bytes_out']}, the bus "
              f"{r['data_bus_bytes']}")
    check(a["parts"] == b["parts"], f"data-plane parts {a['parts']} "
          f"traced, {b['parts']} untraced")
    extra = 32 * (a["parts"]["parts"] + a["parts"]["chunked_frames"])
    check(a["data_bus_bytes"] - b["data_bus_bytes"] == extra,
          f"data bytes {a['data_bus_bytes']} traced, "
          f"{b['data_bus_bytes']} untraced: not {extra} apart")
    # 7. the loop's phase timer
    rounds = [r for r in records if r.get("kind") == "round"]
    check(len(rounds) == 1 and {"train", "validate", "checkpoint"}
          <= set(rounds[0].get("phases", {})),
          f"kind=round phases {[r.get('phases') for r in rounds]}")
    # 8. the critical path
    report = _sl_trace(log_a, log_a / "trace.json")
    check(len(report) == 1, f"{len(report)} critical-path reports")
    cp = report[0]
    check(abs(cp["components_sum_s"] - cp["wall_s"]) <= 1e-3,
          f"components sum {cp['components_sum_s']} s, wall "
          f"{cp['wall_s']} s")
    check(cp["frame_edges"] == len(edges), f"sl_trace counts "
          f"{cp['frame_edges']} frame edges, the journals {len(edges)}")
    comp = cp["components_s"]
    print("  critical path of the traced round: wall "
          f"{cp['wall_s']:.6f} s = " + " + ".join(
              f"{k} {comp[k]:.6f} s ({comp[k] / cp['wall_s']:.2%})"
              for k in TRACE_COMPONENTS)
          + f" (sum {cp['components_sum_s']:.6f}); {cp['path_spans']} "
          f"spans on the path; slowest edges " + "; ".join(
              f"{e['kind']} {e['from']} -> {e['to']} on {e['queue']} "
              f"{e['rtt_ms']} ms" for e in cp["slowest_edges"][:3]))
    journal_bytes = {j.name: j.stat().st_size for j in journals}
    walls = {k: r["res"].history[0].wall_s for k, r in runs.items()}
    out = {"launches": {k: a["launches"][k] + b["launches"][k]
                        for k in a["launches"]},
           "critical_path": cp, "histograms": hists,
           "frame_edges": len(edges), "client_consumes": len(consumes),
           "data_publishes": len(publishes), "spans": len(recs),
           "journal_bytes": journal_bytes,
           "traced_vs_untraced_round_wall": walls["a"] / walls["b"]}
    for label, r in runs.items():
        rec = r["res"].history[0]
        out[label] = {
            "round_wall_s": rec.wall_s, "run_wall_s": r["wall"],
            "samples": rec.num_samples,
            "train_samples_per_s": rec.num_samples / rec.wall_s,
            "val_loss": rec.val_loss, "val_accuracy": rec.val_accuracy,
            "phases": r["server"].ctx.round_phases,
            "bytes_by_family": r["fam"], "data_parts": r["parts"],
            "wire": r["wire"], "launches": r["launches"],
            "held": r["held"], "max_memory_allocated_bytes": r["peak"]}
        print(f"  trace run {label}: round wall {rec.wall_s:.3f} s (run "
              f"{r['wall']:.3f} s), {rec.num_samples} samples, "
              f"{rec.num_samples / rec.wall_s:.1f} training samples/s, "
              f"val_loss {rec.val_loss:.4f} val_acc "
              f"{rec.val_accuracy:.4f}; phases "
              f"{r['server'].ctx.round_phases}; data parts {r['parts']}; "
              f"bytes by family {r['fam']}; peak "
              f"{r['peak'] / 2**30:.2f} GiB; launches {r['launches']}")
    print(f"  traced / untraced round wall {walls['a']:.3f} / "
          f"{walls['b']:.3f} s = {out['traced_vs_untraced_round_wall']:.4f};"
          f" {len(recs)} spans, journals {journal_bytes} B; parameters "
          f"and statistics bit for bit equal; data bytes +{extra} B "
          f"traced")
    return out


def check_journal_edges(label: str, log_path) -> dict:
    """An earlier phase's journals, read again: every participant's
    records share one trace id and every consume span finds its publish
    parent in another participant's journal (no new run)."""
    recs = _span_records(log_path)
    parts = sorted({r["part"] for r in recs})
    traces = {r["trace"] for r in recs}
    edges, orphans = _flow_edges(recs)
    check(recs and len(traces) == 1, f"{label}: {len(recs)} spans over "
          f"trace ids {sorted(traces)}")
    check(edges and not orphans, f"{label}: {len(edges)} frame edges, "
          f"{len(orphans)} consume spans without a publish parent")
    print(f"  {label}: journals of {parts} share one trace; {len(edges)} "
          f"frame edges across participants, 0 orphans")
    return {"participants": parts, "spans": len(recs),
            "frame_edges": len(edges)}


def check_loop_trace(label: str, log_path, rounds: int) -> None:
    """An in-process run's loop-owned journal and records, read again:
    ``round``, ``train``, ``validate`` and ``checkpoint`` spans a round,
    and ``phases`` with those three in every ``kind=round`` record."""
    recs = _span_records(log_path)
    counts = {n: sum(r["name"] == n for r in recs)
              for n in ("round", "train", "validate", "checkpoint")}
    check(all(n == rounds for n in counts.values())
          and {r["part"] for r in recs} == {"server"},
          f"{label}: loop spans {counts} over {rounds} rounds")
    phases = [r.get("phases", {}) for r in _metrics(pathlib.Path(log_path))
              if r.get("kind") == "round"]
    check(len(phases) == rounds and all(
        {"train", "validate", "checkpoint"} <= set(p) for p in phases),
        f"{label}: kind=round phases {phases}")
    print(f"  {label}: loop spans {counts}; phases "
          f"{[{k: v['total_s'] for k, v in p.items()} for p in phases]}")


def measure_trace_cost(pairs: int) -> dict:
    """``python3 chip_smoke.py --trace-cost PAIRS``: the round tracer's
    cost on the card, in turns.  After the build and one untraced warm-up
    round (the process's first VGG16 round pays cuDNN's set-up), cell
    26's round (:func:`trace_protocol_config`) runs traced and untraced
    ``pairs`` times, alternating which goes first (a b, b a, ...), and
    one JSON line gives every run's round and phase walls, each pair's
    traced / untraced ratio and the medians.  A measurement, not a check:
    it fails only where a phase fails."""
    phase_device()
    phase_build()
    work = pathlib.Path(tempfile.mkdtemp(prefix="slt_trace_cost_"))
    run_protocol(trace_protocol_config(work / "warm", False))
    runs = []
    for i in range(pairs):
        for traced in ((True, False) if i % 2 == 0 else (False, True)):
            cfg = trace_protocol_config(
                work / f"{'a' if traced else 'b'}{i}", traced)
            server, _, _, res = run_protocol(cfg)
            runs.append({"pair": i, "traced": traced,
                         "round_wall_s": res.history[0].wall_s,
                         "phases": server.ctx.round_phases[0]})
    walls = {t: [r["round_wall_s"] for r in runs if r["traced"] is t]
             for t in (True, False)}
    ratios = [a / b for a, b in zip(walls[True], walls[False])]
    out = {"card": torch.cuda.get_device_name(0), "runs": runs,
           "pair_ratios": ratios,
           "median_traced_s": statistics.median(walls[True]),
           "median_untraced_s": statistics.median(walls[False]),
           "median_ratio": statistics.median(ratios)}
    print(json.dumps(out))
    return out


#: cell 28's telemetry plane: heartbeat interval, liveness timeout and
#: client timeout (seconds), the client that dies in run b and the
#: activation it dies after, the scrape period of the poller
FLEET_INTERVAL = 0.5
FLEET_LIVENESS = 4.0
FLEET_TIMEOUT = 120.0
FLEET_DEAD = "client_1_1"
FLEET_CRASH_AFTER = 2
FLEET_SCRAPE_S = 0.4
#: seconds a run b may take beyond run a's wall and the liveness timeout
FLEET_SLACK_S = 5.0


def fleet_protocol_config(workdir: pathlib.Path, momentum: float):
    """Cell 28: cell 6's round (:func:`vgg_protocol_config`: baseline 1
    at ``[2, 2]``, bf16, int8 on both cut directions, every kernel flag,
    the sharded CUDA fold at ``server-momentum`` = ``momentum``) with
    heartbeats every :data:`FLEET_INTERVAL` s, a liveness timeout of
    :data:`FLEET_LIVENESS` s and the exporter on an ephemeral port."""
    cfg = vgg_protocol_config(workdir, momentum)
    return dataclasses.replace(cfg, observability=dataclasses.replace(
        cfg.observability, heartbeat_interval=FLEET_INTERVAL,
        liveness_timeout=FLEET_LIVENESS, http_port=0)).validate()


def _scrape(url: str) -> tuple:
    """One scrape of the exporter: (``/metrics`` text, ``/fleet``),
    straight to its local port whatever proxy the environment names."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(f"{url}/metrics", timeout=5) as r:
        text = r.read().decode()
    with opener.open(f"{url}/fleet", timeout=5) as r:
        fleet = json.loads(r.read())
    return text, fleet


def _run_fleet_round(cfg, label: str, dead: str | None = None) -> dict:
    """One protocol round in this process, as ``run_inproc`` runs it (the
    server in this thread, one client thread per client over one
    ``InProcTransport``), with a thread scraping the server's exporter
    every :data:`FLEET_SCRAPE_S` s.  ``dead`` speaks through a
    ``ChaosTransport`` whose crash script kills it at its
    :data:`FLEET_CRASH_AFTER`-th activation; its thread ends there."""
    from split_learning_torch.runtime.bus import InProcTransport
    from split_learning_torch.runtime.chaos import ChaosCrash, ChaosTransport
    from split_learning_torch.runtime.client import ProtocolClient
    from split_learning_torch.runtime.log import Logger
    from split_learning_torch.runtime.server import ProtocolServer
    from split_learning_torch.runtime.telemetry import lint_prometheus

    bus = InProcTransport()
    server = ProtocolServer(cfg, bus, client_timeout=FLEET_TIMEOUT,
                            logger=Logger.for_run(cfg, "server",
                                                  console=False),
                            device=DEVICE)
    check(server.exporter is not None, f"{label}: no exporter")
    ctx = server.ctx
    admitted: list = []
    admit = ctx._admit_update

    def admit_noted(msg):
        admitted.append((msg.client_id, bool(msg.telemetry)))
        return admit(msg)
    ctx._admit_update = admit_noted
    crash = dataclasses.replace(cfg.chaos, enabled=True, crash=(
        {"client": dead, "queue": "intermediate_queue*",
         "after": FLEET_CRASH_AFTER},))
    clients = [ProtocolClient(
        cfg, cid, s, ChaosTransport(bus, crash, name=cid)
        if cid == dead else bus, device=DEVICE)
        for s, n in enumerate(cfg.clients, 1)
        for cid in (f"client_{s}_{i}" for i in range(n))]
    scrapes: list = []
    failed: list = []
    done = threading.Event()

    def poll():
        url = server.exporter.url
        while not done.is_set():
            t = time.perf_counter()
            try:
                text, fleet = _scrape(url)
                scrapes.append({"t": t, "lint": lint_prometheus(text),
                                "fleet": fleet})
            except (OSError, ValueError) as e:
                failed.append(repr(e))
            done.wait(FLEET_SCRAPE_S)
    errors: list = []
    crashed: list = []

    def run(c):
        try:
            c.run()
        except ChaosCrash:
            crashed.append(c.client_id)   # the scripted death
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((c.client_id, e))
            bus.close()
    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in clients]
    poller = threading.Thread(target=poll, daemon=True)
    before = ctx.faults.snapshot()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    poller.start()
    try:
        res = server.serve()
    except Exception as e:
        raise SmokeFailure(f"{label} failed: {e!r} (clients: "
                           f"{errors})") from e
    finally:
        done.set()
        poller.join(timeout=30)
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), f"a {label} client did not stop")
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    check(not errors, f"{label} clients failed: {errors}")
    faults = {k: v - before.get(k, 0) for k, v in ctx.faults.snapshot()
              .items() if v != before.get(k, 0)}
    return {"server": server, "clients": clients, "bus": bus, "res": res,
            "scrapes": scrapes, "scrape_failures": failed,
            "admitted": admitted, "crashed": crashed, "faults": faults,
            "run_wall": run_wall, "launches": _launch_counts()}


def _fleet_summary(label: str, cfg, run: dict, want_samples: int) -> dict:
    """The checks both runs share, printed: the round ok, finite, with
    ``want_samples`` samples; every mid-round scrape of ``/metrics``
    lint-clean; every admitted UPDATE carrying a snapshot; a
    ``kind=fleet`` record naming every client; ``tools/sl_top.py``
    rendering the monitor's snapshot.  Returns the run's numbers."""
    import importlib.util
    res, server, clients = run["res"], run["server"], run["clients"]
    rec = res.history[0]
    check(len(res.history) == 1 and rec.ok and math.isfinite(rec.val_loss),
          f"{label}: the round failed: {res.history}")
    check(rec.num_samples == want_samples, f"{label}: {rec.num_samples} "
          f"samples, expected {want_samples}")
    ids = sorted(c.client_id for c in clients)
    lint = [e for sc in run["scrapes"] for e in sc["lint"]]
    check(len(run["scrapes"]) >= 5, f"{label}: {len(run['scrapes'])} "
          f"scrapes landed ({len(run['scrape_failures'])} failed)")
    check(not lint, f"{label}: /metrics does not lint: {lint[:5]}")
    check(run["admitted"] and all(tel for _, tel in run["admitted"]),
          f"{label}: an UPDATE without a snapshot: {run['admitted']}")
    recs = [r for r in _metrics(pathlib.Path(cfg.log_path))
            if r.get("kind") == "fleet"]
    check(recs and sorted(recs[-1]["fleet"]["clients"]) == ids,
          f"{label}: no kind=fleet record naming {ids}")
    spec = importlib.util.spec_from_file_location(
        "sl_top", HERE / "tools" / "sl_top.py")
    sl_top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sl_top)
    table = sl_top.render_fleet(server.ctx.fleet.snapshot(), color=False)
    check(all(c in table for c in ids), f"{label}: sl_top's table "
          f"misses a client:\n{table}")
    beats = {c.client_id: c.heartbeats for c in clients}
    frames, nbytes = _print_heartbeats(list(beats.values()))
    transitions = [(t["client"], t["from"], t["to"], t["why"])
                   for t in server.ctx.fleet.transitions]
    phases = server.ctx.round_phases[0]
    print(f"  {label}: round wall {rec.wall_s:.3f} s (run "
          f"{run['run_wall']:.3f} s), {rec.num_samples} samples, "
          f"val_loss {rec.val_loss:.4f} val_acc {rec.val_accuracy:.4f}; "
          f"phases " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 phases.items())
          + f"; {len(run['scrapes'])} scrapes lint-clean "
          f"({len(run['scrape_failures'])} failed); heartbeats by client "
          f"{beats}; {frames / max(1, len(beats)) * 1:.1f} frames and "
          f"{nbytes / max(1, frames):.0f} bytes a frame; faults "
          f"{run['faults']}; transitions {transitions}")
    print("  sl_top:\n" + "\n".join("    " + ln
                                     for ln in table.splitlines()))
    return {"round_wall_s": rec.wall_s, "run_wall_s": run["run_wall"],
            "samples": rec.num_samples, "val_loss": rec.val_loss,
            "val_accuracy": rec.val_accuracy, "phases": phases,
            "heartbeats": beats, "heartbeat_frames": frames,
            "heartbeat_bytes": nbytes,
            "bytes_by_family": _family_bytes(run["bus"]),
            "scrapes": len(run["scrapes"]),
            "scrape_failures": len(run["scrape_failures"]),
            "transitions": transitions, "faults": run["faults"],
            "admitted": run["admitted"], "launches": run["launches"]}


def phase_fleet_protocol(workdir: pathlib.Path) -> dict:
    """Cell 28: :func:`fleet_protocol_config`'s round twice in one
    process, the server's exporter scraped every :data:`FLEET_SCRAPE_S`
    s by a thread, every quantize, dequantize, finalize and momentum
    launch held bit for bit against its plain version
    (:func:`_hold_on_path`).

    Run a (FedAvgM 0.9): every client seen ``healthy`` in ``/fleet``
    after its SYN, and each client's heartbeats at least its training
    wall (SYN to the last UPDATE) over :data:`FLEET_INTERVAL`, less 2.
    Run b (momentum 0): :data:`FLEET_DEAD` dies at its
    :data:`FLEET_CRASH_AFTER`-th activation; its heartbeat thread ends
    with it, the monitor marks it ``lost`` and releases the first barrier
    that misses it early (``fleet_lost_drops`` >= 1), the survivors'
    UPDATEs fold, no survivor is ever ``lost``, and the round's wall is
    under run a's + :data:`FLEET_LIVENESS` + :data:`FLEET_SLACK_S`.  Both
    as :func:`_fleet_summary` checks them."""
    from split_learning_torch.ops.kernels import quant as kq
    from split_learning_torch.ops.kernels import update as ku

    seen: dict = {}
    out: dict = {}
    launches: dict = {}
    import gc
    gc.collect()
    torch.cuda.empty_cache()   # the group's earlier phases' cache
    smi = _SmiPoll()
    for run_key, m, dead in (("a", 0.9, None), ("b", 0.0, FLEET_DEAD)):
        held: dict = {}
        originals = _hold_on_path(kq, ku, held, seen)
        try:
            cfg = fleet_protocol_config(workdir / f"fleet_{run_key}", m)
            run = _run_fleet_round(cfg, f"fleet run {run_key}", dead)
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
        want = _expected_samples(cfg, protocol=True,
                                 n_clients=cfg.clients[0] - bool(dead))
        r = _fleet_summary(f"run {run_key}", cfg, run, want)
        _check_held("fleet protocol", m, held, run["launches"])
        r["held"] = held
        fleet = run["server"].ctx.fleet
        ids = [c.client_id for c in run["clients"]]
        survivors = [c for c in ids if c != dead]
        lost_to = {t[0] for t in r["transitions"] if t[2] == "lost"}
        # how near each client came to the checks below: its scrapes in
        # each state after its SYN, and the longest silence a scrape saw
        seen_in: dict = {c: {} for c in ids}
        silent = dict.fromkeys(ids, 0.0)
        for sc in run["scrapes"]:
            for c, v in sc["fleet"]["clients"].items():
                if c in seen_in and v.get("round") is not None:
                    seen_in[c][v["state"]] = seen_in[c].get(v["state"], 0) + 1
                if c in silent and v.get("age_s") is not None:
                    silent[c] = max(silent[c], v["age_s"])
        print(f"  run {run_key}: scrapes by state after SYN {seen_in}; "
              f"longest silence a scrape saw {silent} s (liveness "
              f"{FLEET_LIVENESS:g} s)")
        r["scrape_states"], r["longest_silence_s"] = seen_in, silent
        check(lost_to <= ({dead} if dead else set()),
              f"run {run_key}: a live client was marked lost: "
              f"{r['transitions']}")
        if dead is None:
            healthy = {c for sc in run["scrapes"]
                       for c, v in sc["fleet"]["clients"].items()
                       if v["state"] == "healthy"
                       and v.get("round") is not None}
            check(healthy == set(ids), f"run a: {sorted(set(ids) - healthy)}"
                  " never seen healthy mid-round")
            phases = r["phases"]
            train = phases["train_s"] + phases["upload_s"]
            need = train / FLEET_INTERVAL - 2
            short = {c: n for c, (n, _) in r["heartbeats"].items()
                     if n < need}
            fewest = min(n for n, _ in r["heartbeats"].values())
            print(f"  run a: training wall {train:.3f} s: at least "
                  f"{need:.1f} heartbeats a client, fewest {fewest}")
            check(not short, f"run a: too few heartbeats {short} (at "
                  f"least {need:.1f})")
            check(run["server"].ctx.last_fold.folded == len(ids),
                  f"run a folded {run['server'].ctx.last_fold.folded}")
        else:
            dead_client = next(c for c in run["clients"]
                               if c.client_id == dead)
            check(run["crashed"] == [dead], f"run b: crashed "
                  f"{run['crashed']}, not [{dead}]")
            check(dead_client.telemetry._thread is None,
                  "run b: the dead client's heartbeat thread outlived it")
            check(fleet.state(dead) == "lost",
                  f"run b: {dead} is {fleet.state(dead)}, not lost")
            drops = r["faults"].get("fleet_lost_drops", 0)
            check(drops >= 1, f"run b: no barrier released early "
                  f"({r['faults']})")
            check(sorted(c for c, _ in r["admitted"]) == sorted(survivors),
                  f"run b: UPDATEs from {r['admitted']}")
            check(run["server"].ctx.last_fold.folded == len(survivors),
                  f"run b folded {run['server'].ctx.last_fold.folded}")
            limit = out["a"]["round_wall_s"] + FLEET_LIVENESS + FLEET_SLACK_S
            print(f"  run b: wall {r['round_wall_s']:.3f} s against run a "
                  f"{out['a']['round_wall_s']:.3f} + liveness "
                  f"{FLEET_LIVENESS:g} + {FLEET_SLACK_S:g} = {limit:.3f} s "
                  f"(client timeout {FLEET_TIMEOUT:g} s); "
                  f"fleet_lost_drops {drops}")
            check(r["round_wall_s"] < limit, f"run b took "
                  f"{r['round_wall_s']:.3f} s, over {limit:.3f} s")
            r["fleet_lost_drops"] = drops
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        out[run_key] = r
    for name in OFF_PATH_KERNELS:
        check(launches.get(name, 0) == 0, f"{name} ran "
              f"{launches.get(name)} times on the fleet path")
    for name in ("quantize", "dequantize", "finalize", "momentum"):
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched "
              "on the fleet path")
    check(out["a"]["launches"]["momentum"] > 0
          and out["b"]["launches"]["finalize"] > 0,
          "the momentum run or the plain FedAvg run missed its kernel")
    out["launches"] = launches
    out["card_memory_used_peak_mib"] = smi.stop()
    print(f"  fleet launches over both runs {launches}; card memory used, "
          f"peak by nvidia-smi (every group): "
          f"{out['card_memory_used_peak_mib']} MiB")
    return out


#: phases 4-31, in groups that run at once, each in a process of its own
#: on the card (``--group NAME``, :func:`run_group`): a group runs its
#: phases in order, and a phase that reads an earlier phase's result
#: (``r``) is in that phase's group.  The groups are balanced by the
#: phases' walls on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6):
#: 234-269 s each, one after another.  Each entry is (the phase's key in
#: the result line, the phase as a function of the shared working
#: directory and the group's results so far).
PHASE_GROUPS = {
    "tinyllama": (
        ("slice", lambda w, r: phase_slice(slice_config(w))),
        ("profile", lambda w, r: phase_profile(slice_config(w))),
        ("protocol", lambda w, r: phase_protocol(w)),
        ("protocol_tcp", lambda w, r: phase_protocol_tcp(w, r["protocol"])),
        ("step_check", lambda w, r: phase_step_check()),
        ("bert_slice", lambda w, r: phase_bert_slice(w)),
        ("bert_protocol", lambda w, r: phase_bert_protocol(w)),
        ("fleet_protocol", lambda w, r: phase_fleet_protocol(w))),
    "vgg": (
        ("vgg_slice", lambda w, r: phase_vgg_slice(w)),
        ("vgg_profile", lambda w, r: phase_profile(
            yaml_config(w / "vgg_profile", "config.yaml"))),
        ("vgg_protocol", lambda w, r: phase_vgg_protocol(w)),
        ("vgg_tcp", lambda w, r: phase_vgg_tcp(w)),
        ("async_protocol",
         lambda w, r: phase_async_protocol(w, r["vgg_protocol"])),
        ("codec_protocol", lambda w, r: phase_codec_protocol(w)),
        ("tree_protocol", lambda w, r: phase_tree_protocol(w)),
        ("trace_protocol", lambda w, r: phase_trace_protocol(w))),
    "baselines": (
        ("profiler", lambda w, r: phase_profiler(w)),
        ("baseline2_slice", lambda w, r: phase_baseline2_slice(
            w, r["profiler"]["profile"])),
        ("baseline2_protocol", lambda w, r: phase_baseline2_protocol(
            w, r["profiler"]["profile"])),
        ("strategies", lambda w, r: phase_strategies(w)),
        ("baseline3_slice", lambda w, r: phase_baseline3_slice(w)),
        ("baseline3_protocol", lambda w, r: phase_baseline3_protocol(w)),
        ("baseline4_slice", lambda w, r: phase_baseline4_slice(w))),
    "kwt": (
        ("kwt_slice", lambda w, r: phase_kwt_slice(w)),
        ("variants", lambda w, r: phase_variants(w)),
        ("variants_protocol", lambda w, r: phase_variants_protocol(w)),
        ("variants_tcp",
         lambda w, r: phase_variants_tcp(w, r["variants_protocol"])),
        ("chaos_protocol", lambda w, r: phase_chaos_protocol(w)),
        ("chaos_tcp", lambda w, r: phase_chaos_tcp(w, r["chaos_protocol"])),
        ("wire_slow_protocol", lambda w, r: phase_wire_slow_protocol(w))),
}
#: seconds from the script's start by which every group must have ended:
#: the script then fails with the groups' logs, inside the 1200 s that
#: a run of it is given
GROUPS_DEADLINE_S = 1140.0
#: lines of a failed group's log repeated on standard error
GROUP_TAIL_LINES = 40


def _stop_on_term(signum, frame):
    raise SmokeFailure(f"stopped by signal {signum}")


def run_group(name: str, workdir: pathlib.Path, out: pathlib.Path) -> int:
    """``chip_smoke.py --group NAME WORKDIR OUT``: the phases of
    ``PHASE_GROUPS[NAME]`` in order, in this process, with the kernels
    the script built loaded from ``build/``; writes their results to
    ``OUT`` as one JSON object.  SIGTERM raises :class:`SmokeFailure`,
    so that a phase's own clean-up (its TCP processes) runs."""
    signal.signal(signal.SIGTERM, _stop_on_term)
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    results: dict = {}
    for key, fn in PHASE_GROUPS[name]:
        print(f"[{key}] at {time.perf_counter() - t0:.1f} s", flush=True)
        results[key] = fn(workdir, results)
    print(f"[{name} done] at {time.perf_counter() - t0:.1f} s", flush=True)
    out.write_text(json.dumps(results))
    return 0


def run_groups(workdir: pathlib.Path, t_start: float) -> dict:
    """Every group of :data:`PHASE_GROUPS` at once, one process each
    (its own session, stopped by SIGTERM and then SIGKILL on any failure
    or at :data:`GROUPS_DEADLINE_S`); prints each group's log in order
    once all have ended, and returns their results merged."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()   # the kernel phases' cache, for the groups
    procs: dict = {}
    failed = None
    try:
        for name in PHASE_GROUPS:
            log = workdir / f"group_{name}.log"
            procs[name] = (subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--group",
                 name, str(workdir), str(workdir / f"group_{name}.json")],
                cwd=HERE, stdout=log.open("w"), stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONUNBUFFERED": "1"},
                start_new_session=True), log, time.perf_counter())
        walls: dict = {}
        while failed is None and len(walls) < len(procs):
            for name, (p, _, t0) in procs.items():
                rc = p.poll()
                if rc is not None and name not in walls:
                    walls[name] = time.perf_counter() - t0
                    print(f"group {name} ended {rc} after "
                          f"{walls[name]:.1f} s", flush=True)
                    if rc != 0:
                        failed = f"group {name} exited {rc}"
            if time.perf_counter() - t_start > GROUPS_DEADLINE_S:
                failed = (f"groups {sorted(set(procs) - set(walls))} still "
                          f"running at {GROUPS_DEADLINE_S:.0f} s")
            time.sleep(0.5)
    finally:
        live = [p for p, _, _ in procs.values() if p.poll() is None]
        for p in live:
            p.terminate()
        for p in live:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        for p, _, _ in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=30)
    for name, (_, log, _) in procs.items():
        print(f"===== group {name} =====")
        print(log.read_text(), end="", flush=True)
    if failed is not None:
        # the groups' logs go to standard output; the end of each log
        # that did not finish goes to standard error too, where a caller
        # that keeps only the end of each stream still sees why
        for name, (p, log, _) in procs.items():
            if p.returncode != 0:
                tail = log.read_text().splitlines()[-GROUP_TAIL_LINES:]
                print(f"===== end of group {name} (exit {p.returncode}) "
                      "=====\n" + "\n".join(tail), file=sys.stderr,
                      flush=True)
    check(failed is None, failed)
    results: dict = {}
    for name in PHASE_GROUPS:
        results.update(json.loads(
            (workdir / f"group_{name}.json").read_text()))
    return results


def main() -> int:
    t_start = time.perf_counter()
    signal.signal(signal.SIGTERM, _stop_on_term)   # the groups stop too

    def mark(name: str) -> None:
        print(f"[{name}] at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    phase_device()
    mark("build")
    phase_build()
    mark("kernels")
    kernels = phase_kernels()
    mark("wire_kernels")
    kernels.update(phase_wire_kernels())
    mark("model_check")
    phase_model_check()
    with tempfile.TemporaryDirectory(prefix="slt_smoke_") as tmp:
        workdir = pathlib.Path(tmp)
        mark("protocol_check")
        tiny = phase_protocol_check(workdir)
        mark("groups")
        results = run_groups(workdir, t_start)
    mark("summary")
    sl, proto, tcp = (results[k] for k in ("slice", "protocol",
                                            "protocol_tcp"))
    vgg_sl, vgg_proto, vgg_tcp = (results[k] for k in (
        "vgg_slice", "vgg_protocol", "vgg_tcp"))
    b2_proto, b3_slice, b3_proto, b4_slice, kwt_slice = (
        results[k] for k in ("baseline2_protocol", "baseline3_slice",
                             "baseline3_protocol", "baseline4_slice",
                             "kwt_slice"))
    bert_slice, bert_proto = results["bert_slice"], results["bert_protocol"]
    variants_proto, variants_tcp = (results["variants_protocol"],
                                    results["variants_tcp"])
    chaos_proto, chaos_tcp = results["chaos_protocol"], results["chaos_tcp"]
    async_proto, codec_proto, tree_proto, trace_proto = (
        results[k] for k in ("async_protocol", "codec_protocol",
                             "tree_protocol", "trace_protocol"))
    wire_slow = results["wire_slow_protocol"]
    fleet = results["fleet_protocol"]
    entries = []
    for name, r in kernels.items():
        source, replaces = KERNELS[name]
        by_path = {"protocol": proto["launches_total"][name],
                   "protocol_tcp": tcp["launches"][name]}
        if name in sl["launches"]:
            by_path["slice"] = sl["launches"][name]
        if name in tiny:   # the float32 flash route, either quantizer
            by_path["tiny_float32_protocol_check"] = tiny[name]
        for label, run in vgg_sl.items():
            by_path[f"vgg_slice_{label}"] = run["launches"][name]
        by_path["vgg_protocol"] = vgg_proto["launches_total"][name]
        by_path["vgg_tcp"] = vgg_tcp["launches"][name]
        by_path["baseline2_protocol"] = b2_proto["launches_total"][name]
        by_path["baseline3_slice"] = b3_slice["launches"][name]
        by_path["baseline3_protocol"] = b3_proto["launches_total"][name]
        by_path["baseline4_slice"] = b4_slice["launches"][name]
        by_path["kwt_slice"] = kwt_slice["launches"][name]
        by_path["bert_slice"] = bert_slice["launches"][name]
        by_path["bert_protocol"] = bert_proto["launches_total"][name]
        by_path["variants_protocol"] = sum(
            variants_proto[v]["launches"][name] for v in KWT_VARIANTS)
        by_path["variants_protocol_dropped_feeder"] = variants_proto[
            "dropped_feeder"]["launches"][name]
        by_path["variants_tcp"] = variants_tcp["launches"][name]
        by_path["chaos_protocol"] = chaos_proto["chaos"]["launches"][name]
        by_path["chaos_tcp"] = chaos_tcp["chaos"]["launches"][name]
        for run in ("a", "b"):
            by_path[f"async_protocol_{run}"] = async_proto[run][
                "launches"][name]
        by_path["codec_protocol"] = codec_proto["launches"][name]
        by_path["tree_protocol"] = sum(tree_proto[run]["launches"][name]
                                       for run in ("a", "b"))
        by_path["trace_protocol"] = trace_proto["launches"][name]
        by_path["wire_slow_protocol"] = wire_slow["launches"][name]
        by_path["fleet_protocol"] = fleet["launches"].get(name, 0)
        # each kernel's main path: the VGG protocol round for the codec
        # and stage-update kernels, the TinyLlama protocol round for the
        # flash kernels
        # (VGG has no attention).  The times and bounds of a codec or
        # stage-update row are taken at the VGG round's shapes (``shapes``;
        # the TinyLlama shapes' in ``tinyllama_shapes``), and each of its
        # launches on that path was held against its plain version
        if name == "quantize_generic":
            # its path: the wire-slow codec's round (cell 27), every
            # launch held against the plain version
            main_path = "wire_slow_protocol"
            per_round = {"server-momentum 0.9": wire_slow["launches"][name]}
            held = wire_slow["held"].get("quantize", {}).get("launches", 0)
            extra_b3 = {}
        elif name in VGG_PATH_KERNELS:
            main_path = "vgg_protocol"
            per_round = {f"server-momentum {m}": run["launches"][name]
                         for m, run in vgg_proto["runs"].items()}
            held = sum(run["held"].get(name, {}).get("launches", 0)
                       for run in vgg_proto["runs"].values())
            extra_b3 = {
                "baseline3_launches_per_round": {
                    f"server-momentum {m}": run["launches"][name]
                    for m, run in b3_proto["runs"].items()},
                "baseline3_launches_held_bitwise": sum(
                    run["held"].get(name, {}).get("launches", 0)
                    for run in b3_proto["runs"].values()),
                "bert_launches_per_round": {
                    f"server-momentum {m}": run["launches"][name]
                    for m, run in bert_proto["runs"].items()},
                "bert_launches_held_bitwise": sum(
                    run["held"].get(name, {}).get("launches", 0)
                    for run in bert_proto["runs"].values()),
                "variants_protocol_launches": {
                    v: variants_proto[v]["launches"][name]
                    for v in (*KWT_VARIANTS, "dropped_feeder")},
                "variants_protocol_launches_held_bitwise": sum(
                    r["held"].get(name, {}).get("launches", 0)
                    for r in variants_proto.values()),
                "async_codec_launches_held_bitwise": sum(
                    r["held"].get(name, {}).get("launches", 0)
                    for r in (async_proto["a"], async_proto["b"],
                              codec_proto)),
                "tree_protocol_launches_held_bitwise": sum(
                    tree_proto[r]["held"].get(name, {}).get("launches", 0)
                    for r in ("a", "b"))}
        else:
            main_path = "protocol"
            per_round = proto["launches_per_round"][name]
            held = None
            extra_b3 = {}
        extra = {k: r[k] for k in ("shapes", "tinyllama_shapes", "frames",
                                   "fill_floor", "own_shapes",
                                   "baseline3_shapes", "bert_shapes",
                                   "timed_at", "arith", "cuda_core_bound_ms",
                                   "port_backward_split", "sass") if k in r}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[main_path], "launches_path": main_path,
            "launches_by_path": by_path,
            "launches_per_round": per_round,
            **({} if held is None else {"launches_held_bitwise": held}),
            **extra_b3,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # profiler device times beside the events' ms
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"], **extra})
    print(json.dumps({k: results[k] for group in PHASE_GROUPS.values()
                      for k, _ in group}))
    print(json.dumps({"kernels": entries}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--participant"]:
            sys.exit(participant_main(sys.argv[2:]))
        if sys.argv[1:2] == ["--group"]:
            sys.exit(run_group(sys.argv[2], pathlib.Path(sys.argv[3]),
                               pathlib.Path(sys.argv[4])))
        if sys.argv[1:2] == ["--trace-cost"]:
            measure_trace_cost(int((sys.argv[2:3] or ["3"])[0]))
            sys.exit(0)
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
