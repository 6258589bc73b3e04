"""A participant's transport stack, built from its config.

Port of :func:`make_runtime_transport` from the JAX package's
``runtime/chaos.py`` for the stack that the default transport
configuration builds: the base transport (in-process queues, or one
connection to the TCP broker), a second broker connection for the data
plane's receive prefetch, and the async sender as the outermost layer
(``transport.async-send``).  Fault injection (``ChaosTransport``), the
reliable layer and the sharded broker plane are not ported yet: a config
that asks for one of them raises ``NotImplementedError``.
"""

from __future__ import annotations

from split_learning_torch.config import Config
from split_learning_torch.runtime.bus import (
    AsyncTransport, Transport, make_transport,
)


def make_runtime_transport(cfg: Config, name: str,
                           faults=None) -> Transport:
    """Build participant ``name``'s transport stack from ``cfg``.

    Over TCP, with ``transport.async-send`` on (the default), the data
    plane's receive prefetchers each get their own broker connection: a
    blocked ``get`` holds a :class:`TcpTransport`'s one socket, so the
    sender thread's publishes must not queue behind it, and the
    pass-through gets are cut into short slices for the same reason."""
    later = [
        (cfg.chaos.enabled, "chaos.enabled (fault injection, "
                            "ChaosTransport)"),
        (cfg.transport.reliable, "transport.reliable (at-least-once "
                                 "delivery, ReliableTransport)"),
        (cfg.transport.kind == "tcp" and cfg.broker.shards > 1,
         "broker.shards > 1 (the sharded broker plane)"),
    ]
    for on, what in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet; the plain TCP and in-process "
                "transports are (see ROADMAP.md)")
    tcp = cfg.transport.kind == "tcp"

    def mk() -> Transport:
        return make_transport(cfg.transport.kind, cfg.transport.host,
                              cfg.transport.port, faults=faults)

    bus = mk()
    if cfg.transport.async_send:
        bus = AsyncTransport(
            bus, send_depth=cfg.transport.send_depth,
            prefetch_depth=cfg.transport.prefetch_depth,
            recv_factory=mk if tcp else None, slice_gets=tcp,
            faults=faults)
    return bus
