"""Control-plane message types.

Only :class:`Update` — the artifact a training context returns per
(client, stage) shard — is ported so far.  The rest of the JAX
package's ``runtime/protocol.py`` (the wire messages, frames and the
restricted unpickler) waits for the protocol slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Update:
    """client → server: round's trained shard parameters.

    ``round_idx`` fences aggregation: a straggler's stale round-N
    weights must not count as round N+1's contribution."""
    client_id: str
    stage: int
    cluster: int
    params: Any                     # state tree of tensors
    num_samples: int                # FedAvg weight (data_count semantics)
    ok: bool = True                 # False -> NaN seen, skip aggregation
    batch_stats: Any | None = None  # shard's running stats (BN models)
    round_idx: int = 0
    # delta-encoded Update: params holds ``trained - base`` against the
    # server's versioned shadow copy; None = full frame
    delta_base: int | None = None
    # async mode: the server generation this client's params were seeded
    # from; None = sync client (round_idx carries the same fence)
    version: int | None = None
    # piggybacked telemetry snapshot (a plain dict)
    telemetry: dict | None = None
