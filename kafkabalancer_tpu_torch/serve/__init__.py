"""kafkabalancer_tpu_torch.serve — the persistent planning daemon.

The reference is deployed as an outer loop that runs the planner once per
move and re-reads the cluster each time, so every invocation of this
package would pay the torch import, the CUDA context and the kernel load
before it plans. The daemon keeps all of that resident:

- ``daemon`` — a long-lived planning server on a unix socket
  (``python -m kafkabalancer_tpu_torch -serve``) with request coalescing,
  an idle-timeout shutdown, and a pidfile/socket liveness handshake;
- ``lanes`` — one worker lane per GPU (bucket-affinity routing, work
  stealing, a per-lane row cache, the lane watchdog and mesh-exclusive
  ``-fused-shard`` runs) and cross-request batching: a lane's
  concurrent same-bucket ``-fused`` requests share one instance-batched
  session (``-serve-microbatch``, ``-serve-batch-mode``,
  ``-serve-admission-hold``);
- ``client`` — the forwarding client embedded in the CLI (no torch, no
  numpy): every invocation forwards its parsed flags and input to a live
  daemon of this package and falls back to the in-process path,
  byte-identical, when none answers;
- ``protocol`` — the versioned length-prefixed frame protocol and this
  package's own socket path (``kafkabalancer-tpu-torch-<uid>.sock``,
  ``$KAFKABALANCER_TPU_TORCH_SOCKET``);
- ``cache`` — the incremental tensorize row cache;
- ``sessions``/``state`` — resident per-tenant cluster sessions and the
  digest/row-record machinery of the protocol-v2 delta ladder (the
  outer loop's steady state ships a digest, not the cluster);
- ``admission`` — per-tenant fair queueing, caps and deadline shedding;
- ``faults`` — the fault-injection seam (inert unless ``-serve-faults``);
- ``devmem`` — per-lane device-memory attribution;
- ``speculate`` — speculative plan-ahead (the idle window after request
  N computes request N+1's answer; a digest-matching request is a
  zero-dispatch memo read, preempted by real traffic) and the ``-watch``
  continuous controller (the daemon subscribes to Zookeeper itself and
  streams plans to a sink — no client process in the steady state);
- ``spill`` — the warm session tier (``-serve-session-spill-dir``):
  checksummed disk records of evicted, expired and flushed sessions,
  restored by a digest-matching request after a restart or a SIGKILL;
- ``edge_cache`` — the client's per-tenant shadow digest cache beside
  the socket (``<socket>.edge/``): an unchanged input skips the read
  and digest, a changed one pays O(changed rows).

``protocol``, ``client``, ``state``, ``edge_cache``, ``spill`` and
``speculate`` import neither torch nor numpy: a forwarded invocation
stays as light as an error exit.
"""

from kafkabalancer_tpu_torch.serve.protocol import (  # noqa: F401
    PROTO_VERSION,
    default_socket_path,
    resolve_socket_path,
)
