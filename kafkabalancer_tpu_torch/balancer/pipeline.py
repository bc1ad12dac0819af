"""The ordered step pipeline (reference: balancer.go:34-65).

``balance(pl, cfg)`` runs the steps in priority order — validation, then
defaults, then feasibility repairs, then optimization — and the first step
that proposes a change short-circuits, so each call yields **at most one
reassignment** (balancer.go:57-60). A step failure raises
:class:`BalanceError` prefixed with the step name (balancer.go:55). When no
step proposes anything, an empty plan is returned (balancer.go:63-64).

Solver selection (``cfg.solver``) swaps only the optimization tail
(MoveLeaders/MoveNonLeaders — the reference's hot loop): ``tpu`` scores
every candidate move on the device (``solvers/tpu.py``, on the device
``balance`` is given) instead of the O(P*R*B^2) scan, with plans
byte-identical to the greedy tail; ``beam`` replaces both Move steps with
one lookahead search step (``solvers/beam.py``, on the same device).
Validation, defaults and repairs are identical cheap host-side steps in
every backend.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from kafkabalancer_tpu_torch.balancer import steps as _s
from kafkabalancer_tpu_torch.models import PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.partition import empty_partition_list

StepFn = Callable[[PartitionList, RebalanceConfig], Optional[PartitionList]]

# Go-style step names preserved for log/error prefixes (balancer.go:51-52).
# The validate/repair split is load-bearing: solvers/scan.py runs the
# validations+defaults unconditionally but prescreens the repair steps.
_HEAD_VALIDATE: List[Tuple[str, StepFn]] = [
    ("ValidateWeights", _s.validate_weights),
    ("ValidateReplicas", _s.validate_replicas),
    ("FillDefaults", _s.fill_defaults),
]
_HEAD_REPAIR: List[Tuple[str, StepFn]] = [
    ("RemoveExtraReplicas", _s.remove_extra_replicas),
    ("AddMissingReplicas", _s.add_missing_replicas),
    ("MoveDisallowedReplicas", _s.move_disallowed_replicas),
    ("ReassignLeaders", _s.reassign_leaders),
]
_COMMON_HEAD: List[Tuple[str, StepFn]] = _HEAD_VALIDATE + _HEAD_REPAIR


def _steps_for(
    cfg: RebalanceConfig, device: Any = None
) -> List[Tuple[str, StepFn]]:
    solver = getattr(cfg, "solver", "greedy") or "greedy"
    if solver == "greedy":
        tail: List[Tuple[str, StepFn]] = [
            ("MoveLeaders", _s.move_leaders),
            ("MoveNonLeaders", _s.move_non_leaders),
        ]
    elif solver == "tpu":
        from kafkabalancer_tpu_torch.solvers import tpu

        tail = [
            ("MoveLeaders",
             lambda pl, cfg: tpu.tpu_move_leaders(pl, cfg, device)),
            ("MoveNonLeaders",
             lambda pl, cfg: tpu.tpu_move_non_leaders(pl, cfg, device)),
        ]
    elif solver == "beam":
        # beam handles leader and follower candidates jointly in one
        # lookahead search (solvers/beam.py); one tail step replaces both
        # Move steps
        from kafkabalancer_tpu_torch.solvers import beam

        tail = [
            ("BeamSearch", lambda pl, cfg: beam.beam_move(pl, cfg, device)),
        ]
    else:
        raise _s.BalanceError(f"unknown solver {solver!r}")
    return _COMMON_HEAD + tail


def balance(
    pl: PartitionList,
    cfg: RebalanceConfig,
    log: Optional[Callable[[str], None]] = None,
    *,
    device: Any = None,
) -> PartitionList:
    """Run the step pipeline once; reference ``Balance`` (balancer.go:49-65).

    Raises :class:`BalanceError` with a ``"<StepName>: <reason>"`` message on
    failure; otherwise returns a plan with exactly one proposed reassignment,
    or an empty plan when the assignment has converged. ``device`` is
    where ``-solver=tpu`` and ``-solver=beam`` score (CUDA by default).
    """
    for name, step in _steps_for(cfg, device):
        try:
            ppl = step(pl, cfg)
        except _s.BalanceError as exc:
            raise _s.BalanceError(f"{name}: {exc}") from None
        if ppl is not None:
            if log is not None:
                log(f"{name}: {ppl}")
            return ppl

    if log is not None:
        log("no candidate changes")
    return empty_partition_list()


# Reference-style alias (Balance/balance both exported).
Balance = balance
