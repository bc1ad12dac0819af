"""Multi-device layer, on a ``(sweep, part)`` mesh of torch devices.

- ``sweep`` — scenario parallelism: what-if broker add/remove scenarios
  spread over its devices (:mod:`kafkabalancer_tpu_torch.parallel.sweep`);
- ``part`` — partition sharding: one solve's candidate rows split over
  its devices with an exact cross-shard combine
  (:mod:`~kafkabalancer_tpu_torch.parallel.shard_move`), and the whole
  converge session sharded (:mod:`~kafkabalancer_tpu_torch.parallel.
  shard_session` ``plan_sharded``, CLI ``-fused-shard``; its scale tier
  ``-shard-scale``), scored by the hand-written kernel
  (:mod:`~kafkabalancer_tpu_torch.parallel.shard_kernel`).

One process drives every device of a mesh by default; the shards meet in
one function, ``shard_session.gather_pool``. A mesh may also span several
processes: each calls :func:`initialize` (gloo; no arguments under
``torchrun``), then ``make_mesh`` over its own devices builds the global
grid, the session's shards meet in the same ``gather_pool`` across the
processes, and the sweep gathers its scenarios' results
(:mod:`~kafkabalancer_tpu_torch.parallel.distributed`).
"""

from kafkabalancer_tpu_torch.parallel.distributed import initialize, is_multi_host
from kafkabalancer_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "initialize", "is_multi_host"]
