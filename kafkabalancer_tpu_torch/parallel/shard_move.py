"""Partition-sharded candidate scoring for one move.

Counterpart of the reference package's ``parallel/shard_move.py``. The
``[P, R, B]`` candidate tensor of one solve splits over the mesh's
``part`` axis: each device scores the moves of its block of partition
rows against the broker-load table with ``solvers.tpu.score_moves``,
then the per-shard minima — three scalars per shard — combine on the
lead device into the global winner. The combine is tie-break exact:
shard-local flat indices are rebased to global candidate indices
(partition-major order) and the first minimum in shard order wins, which
is the unsharded ``score_moves`` argmin (a NaN included: ``argmin``
takes the first NaN, in one tensor as across shards).
"""

from __future__ import annotations

from typing import Tuple

import torch

from kafkabalancer_tpu_torch.parallel.mesh import PART_AXIS, Mesh
from kafkabalancer_tpu_torch.solvers.tpu import score_moves

Tensor = torch.Tensor


def sharded_score_moves(
    loads: Tensor,
    replicas: Tensor,
    allowed: Tensor,
    member: Tensor,
    weights: Tensor,
    nrep_cur: Tensor,
    nrep_tgt: Tensor,
    pvalid: Tensor,
    bvalid: Tensor,
    nb: Tensor,
    min_replicas: int,
    *,
    leaders: bool,
    mesh: Mesh,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Global best move with the partition rows sharded over ``mesh``'s
    ``part`` axis. Returns ``(u_min, global flat idx, su, perm)`` on the
    lead device — ``score_moves``'s contract without the tie window.

    The partition bucket must divide by the ``part`` axis size (tensorize
    with a ``min_bucket`` that is a multiple of it)."""
    S = mesh.shape[PART_AXIS]
    P_pad, R = replicas.shape
    B = loads.shape[0]
    if P_pad % S:
        raise ValueError(
            f"partition bucket {P_pad} not divisible by part axis {S}; "
            f"tensorize with min_bucket a multiple of {S}"
        )
    P_l = P_pad // S
    lead = mesh.lead
    us, gs = [], []
    su = perm = None
    for i, dev in enumerate(mesh.part):
        rows = slice(i * P_l, (i + 1) * P_l)

        def loc(t: Tensor) -> Tensor:
            return t[rows].to(dev)

        u, idx, su_i, perm_i = score_moves(
            loads.to(dev), loc(replicas), loc(allowed), loc(member),
            loc(weights), loc(nrep_cur), loc(nrep_tgt), loc(pvalid),
            bvalid.to(dev), nb.to(dev) if torch.is_tensor(nb) else nb,
            min_replicas, leaders=leaders,
        )
        us.append(u.to(lead))
        gs.append((idx + i * P_l * R * B).to(lead))
        if su is None:  # su and perm are the same on every shard
            su, perm = su_i.to(lead), perm_i.to(lead)
    u_all, g_all = torch.stack(us), torch.stack(gs)
    k = u_all.argmin()
    return u_all[k], g_all[k], su, perm
