"""What-if scenario sweeps: broker add/remove evaluated in one call.

Counterpart of the reference package's ``parallel/sweep.py``. The
reference CLI answers "what if I add or remove broker X?" by a whole run
per scenario; here each scenario — a candidate broker set — evacuates
the replicas stranded on brokers it drops and then rebalances to
convergence with a device session. Scenarios spread over the mesh's
``sweep`` axis and run one after another on each device, as the
reference's ``lax.map`` runs them on each device group. When that axis
spans processes (``parallel/distributed.py``), each process runs the
scenarios of its own devices and the results are gathered to every
process in scenario order.

Per-scenario semantics mirror a CLI run with ``-broker-ids=<scenario>``:

- partitions with an explicit broker list keep it; all others adopt the
  scenario's broker set (``FillDefaults``, steps.go:47-56);
- stranded replicas move one at a time — first partition in list order,
  first disallowed slot, target the most-loaded allowed non-member broker
  that holds at least one replica (steps.go:117-143: a brand-new empty
  broker is never an evacuation target), loads recomputed between
  evacuations as successive ``Balance`` calls do. A scenario with no legal
  target is infeasible (the CLI's exit-3 "unable to pick replica to
  replace");
- the move session then runs with the scenario set as the configured
  zero-filled brokers, so empty added brokers are move targets
  (steps.go:150-155).

``engine``: ``xla`` runs the torch session (``scan.session``; the scoring
kernel per iteration when batched, on CUDA), ``pallas`` one launch of the
whole-session kernel per scenario (``solvers/pallas_session.py``; its
plain version on CPU tensors) and ``pallas-interpret`` that plain version
on any device.

Contract limits (explicit errors, never silent divergence):
``rebalance_leaders`` is unsupported (host-sequential by nature) and
budgets cap at 2^20 moves per scenario. An input that is not
repair-settled settles on the host once per scenario, each repair one
unit of the scenario's budget.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch import obs
from kafkabalancer_tpu_torch.balancer import steps as _s
from kafkabalancer_tpu_torch.balancer.pipeline import _HEAD_VALIDATE
from kafkabalancer_tpu_torch.models import PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import ENGINES, default_dtype, kernel_dtype
from kafkabalancer_tpu_torch.ops.cost import broker_loads, rank_brokers, unbalance
from kafkabalancer_tpu_torch.ops.runtime import next_bucket
from kafkabalancer_tpu_torch.ops.tensorize import broker_universe, tensorize
from kafkabalancer_tpu_torch.parallel import distributed
from kafkabalancer_tpu_torch.parallel.mesh import SWEEP_AXIS, Mesh, make_mesh
from kafkabalancer_tpu_torch.solvers import scan

Tensor = torch.Tensor


def stack_instances(
    rows: Sequence[np.ndarray],
    pad_to: Optional[int] = None,
    pad_row: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stack per-instance host arrays along a new leading axis — the
    sweep's per-scenario layout. ``pad_to`` pads the instance axis to that
    many rows with ``pad_row`` (default: the first row)."""
    stacked = [np.asarray(r) for r in rows]
    if pad_to is not None and len(stacked) < pad_to:
        fill = stacked[0] if pad_row is None else np.asarray(pad_row)
        stacked = stacked + [fill] * (pad_to - len(stacked))
    return np.stack(stacked)


@dataclass
class SweepResult:
    """Outcome of one what-if scenario."""

    brokers: List[int]  # the scenario's broker set
    feasible: bool  # False: a stranded replica had no legal target, or a
    # host repair step could not pick a replica (the CLI's exit-3 class)
    completed: bool  # False: the budget truncated the drain or repairs
    n_evacuations: int  # disallowed-replica moves applied
    n_moves: int  # optimization moves applied
    unbalance: float  # final objective value
    replicas: List[List[int]]  # final assignment, row-aligned with input
    n_repairs: int = 0  # host repairs applied (each one budget unit)


def _upload(a: Any, dev: Any, dtype: Any = None) -> Tensor:
    """A host array on ``dev``, cast there to ``dtype`` when given (the
    reference's on-device casts round the same way)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _stranded(
    replicas: Tensor, allowed_s: Tensor, valid: Tensor
) -> Tensor:
    """``[P, R]``: valid replica slots whose broker the scenario disallows."""
    return valid & ~allowed_s.gather(1, replicas.clamp(min=0).long())


# device-loop: the sweep's evacuation of a scenario's stranded replicas
def _evacuate(
    replicas: Tensor, member: Tensor, allowed_s: Tensor, weights: Tensor,
    nrep_cur: Tensor, ncons: Tensor, pvalid: Tensor, universe_valid: Tensor,
    budget: int, max_evac: int,
) -> Tuple[Tensor, Tensor, int, bool]:
    """Drain the stranded replicas one at a time (module docstring), each
    evacuation one unit of ``budget``, like a MoveDisallowedReplicas
    repair consuming one CLI loop iteration (kafkabalancer.go:181-209).
    Returns ``(replicas, member, n_evacuations, feasible)``.

    A move sends its replica to an allowed broker and touches no other
    slot, so the stranded slots are drained in the order they are listed
    at the start; the loop runs on the device without a host read (its
    indices are 1-element tensors: indexing with a 0-d one reads it back
    to the host), and after the first slot without a legal target nothing
    more moves (the reference's loop stops there)."""
    replicas, member = replicas.clone(), member.clone()
    P, R = replicas.shape
    B = universe_valid.shape[0]
    t0 = time.perf_counter()
    slot = torch.arange(R, device=replicas.device)[None, :]
    valid = (slot < nrep_cur[:, None]) & pvalid[:, None]
    # jaxlint: disable=R5 — the designed read: the stranded slots, once before the loop
    stranded = _stranded(replicas, allowed_s, valid).reshape(-1).nonzero()[:, 0]
    alive = torch.ones((), dtype=torch.bool, device=replicas.device)
    n = torch.zeros((), dtype=torch.int32, device=replicas.device)
    for f in stranded[: max(0, min(budget, max_evac))].view(-1, 1):
        p, sl = f // R, f % R
        loads = broker_loads(replicas, weights, nrep_cur, ncons, B)
        observed = (member & pvalid[:, None]).any(0)
        # target: most-loaded (then highest ID) allowed non-member broker
        # present in the observed-only table (steps.go:122, :129-135)
        elig = (allowed_s[p] & ~member[p])[0] & observed & universe_valid
        _, _, rank_of = rank_brokers(loads, observed & universe_valid)
        t = torch.where(elig, rank_of, -1).argmax().view(1)
        alive = alive & elig.any()
        s = replicas[p, sl].long()
        replicas[p, sl] = torch.where(alive, t, s).to(replicas.dtype)
        member[p, s] = member[p, s] & ~alive
        member[p, t] = member[p, t] | alive
        n += alive.to(torch.int32)
    # jaxlint: disable=R1 — the designed read: the evacuation's one read, after the loop
    n_evac, feasible = int(n), bool(alive)
    obs.metrics.count("sweep.evacuations", n_evac)
    obs.metrics.count("sweep.evacuation_seconds", time.perf_counter() - t0)
    return replicas, member, n_evac, feasible


def _scenario(
    replicas: Tensor, member: Tensor, allowed_base: Tensor,
    has_explicit: Tensor, scenario_mask: Tensor, weights: Tensor,
    nrep_cur: Tensor, nrep_tgt: Tensor, ncons: Tensor, pvalid: Tensor,
    universe_valid: Tensor, min_replicas: int, min_unbalance: float,
    budget: int, *, max_moves: int, max_evac: int, allow_leader: bool,
    batch: int, engine: str,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
) -> Tuple[Tensor, bool, bool, int, int, float]:
    """One scenario on the device its inputs live on: evacuation, then
    the move session. Returns ``(replicas, feasible, completed,
    n_evacuations, n_moves, unbalance)``."""
    allowed_s = torch.where(
        has_explicit[:, None], allowed_base, scenario_mask[None, :]
    )
    replicas, member, n_evac, feasible = _evacuate(
        replicas, member, allowed_s, weights, nrep_cur, ncons, pvalid,
        universe_valid, budget, max_evac,
    )
    R = replicas.shape[1]
    valid = (torch.arange(R, device=replicas.device)[None, :] < nrep_cur[:, None]) & (
        pvalid[:, None]
    )
    # did the budget truncate the drain? (distinct from infeasibility)
    completed = not bool(_stranded(replicas, allowed_s, valid).any())
    B = universe_valid.shape[0]
    loads = broker_loads(replicas, weights, nrep_cur, ncons, B)
    always_valid = scenario_mask & universe_valid
    # evacuations consumed part of the reassignment budget (the reference
    # CLI loop: each repair is one -max-reassign iteration)
    args = (
        loads, replicas, member, allowed_s, weights, nrep_cur, nrep_tgt,
        ncons, pvalid, always_valid, universe_valid, min_replicas,
        min_unbalance, budget - n_evac,
    )
    if engine == "xla":
        replicas, _l, n_moves, *_log, su = scan.session(
            *args, max_moves=max_moves, allow_leader=allow_leader, batch=batch,
            scorer=scorer,
        )
        return replicas, feasible, completed, n_evac, int(n_moves), float(su)
    from kafkabalancer_tpu_torch.solvers.pallas_session import (
        pallas_session,
        pallas_session_plain,
    )

    run = pallas_session_plain if engine == "pallas-interpret" else pallas_session
    replicas, loads_f, n_moves, *_log = run(
        *args, max(1, batch), max_moves=max_moves, allow_leader=allow_leader,
    )
    # the kernel returns no objective: recompute it over the final broker
    # table (observed ∪ scenario zero-fill, steps.go:150-155)
    observed = scan.member_from(replicas, nrep_cur, pvalid, B).any(0)
    bvalid = (always_valid | observed) & universe_valid
    su = unbalance(loads_f, bvalid, bvalid.sum().to(loads_f.dtype))
    return replicas, feasible, completed, n_evac, int(n_moves), float(su)


def sweep(
    pl: PartitionList,
    cfg: RebalanceConfig,
    scenarios: Sequence[Sequence[int]],
    max_reassign: int = 1 << 16,
    mesh: Optional[Mesh] = None,
    dtype: Any = None,
    batch: int = 1,
    engine: str = "xla",
    *,
    scorer: Optional[Callable[..., Tuple[Tensor, ...]]] = None,
) -> List[SweepResult]:
    """Evaluate ``scenarios`` (broker-ID sets); see the module docstring.
    ``pl`` is not mutated. Scenario ``i`` runs on the ``sweep`` axis'
    device ``i // ceil(S / n_sweep)`` (default mesh: every visible CUDA
    device); across processes, on the process that owns that device, and
    every process returns every result. ``dtype`` defaults per device
    (float32 on CUDA, float64 on the CPU); the pallas engines take
    float32.

    ``batch > 1`` runs each scenario's move session in the batched mode:
    faster convergence, but trajectories (and ``n_moves``) no longer match
    the ``batch=1`` pipeline-parity mode; the final unbalance stays
    comparable for ranking scenarios. ``scorer`` replaces the ``xla``
    sessions' scoring pass, as in ``scan.session``."""
    if cfg.rebalance_leaders:
        raise _s.BalanceError(
            "sweep does not support rebalance_leaders (forced leadership "
            "redistribution is host-sequential, steps.go:234-282); run "
            "scenarios through the per-move pipeline instead"
        )
    if max_reassign > (1 << 20):
        raise ValueError(
            "sweep caps max_reassign at 2^20 per scenario (one device "
            "session, no re-entry); use solvers.scan.plan for larger budgets"
        )
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    engine = scan.resolve_engine(engine)
    if mesh is None:
        mesh = make_mesh()
    devs = mesh.axis_devices(SWEEP_AXIS)
    owners = mesh.axis_owners(SWEEP_AXIS)
    spans = mesh.spans_processes(SWEEP_AXIS)

    pl_input = pl
    pl = copy.deepcopy(pl)
    cfg = copy.deepcopy(cfg)
    has_explicit_l = [p.brokers is not None for p in pl.iter_partitions()]
    for name, step in _HEAD_VALIDATE:
        try:
            step(pl, cfg)
        except _s.BalanceError as exc:
            raise _s.BalanceError(f"{name}: {exc}") from None
    settled = all(p.num_replicas == len(p.replicas) for p in pl.iter_partitions())

    # replica add/remove repairs depend on the scenario (their targets
    # follow its broker set and loads, steps.go:70-113), so an unsettled
    # input settles on the host once per scenario, as a sequential CLI
    # run with -broker-ids=<scenario> would, each repair one unit of the
    # scenario's budget (kafkabalancer.go:177-221)
    scen_pls = scen_budget = scen_feasible = None
    if not settled:
        scen_pls, scen_budget, scen_feasible = [], [], []
        for sc in scenarios:
            pl_s = copy.deepcopy(pl_input)
            cfg_s = copy.deepcopy(cfg)
            cfg_s.brokers = sorted(int(b) for b in sc)
            try:
                _repaired, left = scan._settle_head(
                    pl_s, cfg_s, max_reassign, include_reassign_leaders=False,
                )
                ok = True
            except _s.BalanceError:
                # the CLI's exit-3 class: the scenario is infeasible
                left, ok = 0, False
            scen_pls.append(pl_s)
            scen_budget.append(left if ok else 0)
            scen_feasible.append(ok)

    extra = sorted({int(b) for sc in scenarios for b in sc})
    if scen_pls is None:
        dp = tensorize(pl, cfg, extra_brokers=extra)
        scen_dps = None
    else:
        # ONE broker universe for the shared encoding and every scenario's:
        # observed ∪ cfg.brokers ∪ scenarios ∪ every post-repair replica
        # holder, so the per-scenario arrays index one dense space
        union_extra = sorted(
            {int(b) for b in broker_universe(pl, cfg, extra)}
            | {b for spl in scen_pls for p in spl.iter_partitions()
               for b in p.replicas}
        )
        dp = tensorize(pl, cfg, extra_brokers=union_extra)
        scen_dps = [
            tensorize(spl, None, extra_brokers=union_extra,
                      min_replica_bucket=dp.replicas.shape[1])
            for spl in scen_pls
        ]
        for sdp in scen_dps:
            if sdp.replicas.shape != dp.replicas.shape or not np.array_equal(
                sdp.broker_ids, dp.broker_ids
            ):
                raise _s.BalanceError(
                    "per-scenario dense shapes diverged from the shared "
                    "encoding; this is a bug"
                )
    B = dp.bvalid.shape[0]
    S = len(scenarios)
    per_dev = -(-max(1, S) // len(devs))
    scenario_mask = np.zeros((max(1, S), B), dtype=bool)
    for i, sc in enumerate(scenarios):
        for bid in sc:
            scenario_mask[i, dp.broker_index(int(bid))] = True
    has_explicit = np.asarray(
        has_explicit_l + [False] * (dp.pvalid.shape[0] - dp.np_)
    )
    max_evac = int(dp.replicas.shape[0] * dp.replicas.shape[1])
    max_moves = next_bucket(min(max_reassign, 1 << 20), 128)

    obs.metrics.count("sweep.runs")
    obs.metrics.count("sweep.scenarios", S)
    out: List[SweepResult] = []
    shared: dict = {}
    with obs.span("sweep.dispatch", scenarios=S, engine=engine,
                  per_scenario=scen_pls is not None):
        for i, sc in enumerate(scenarios):
            if owners[i // per_dev] != mesh.rank:
                continue  # another process's scenario
            dev = devs[i // per_dev]
            if dev not in shared:  # the shared inputs, once per device
                dt = kernel_dtype() if engine != "xla" else (
                    dtype if dtype is not None else default_dtype(dev)
                )
                shared[dev] = {
                    k: _upload(v, dev, dt if k in ("weights", "ncons") else None)
                    for k, v in (
                        ("allowed", dp.allowed), ("has_explicit", has_explicit),
                        ("weights", dp.weights), ("nrep_tgt", dp.nrep_tgt),
                        ("ncons", dp.ncons), ("pvalid", dp.pvalid),
                        ("bvalid", dp.bvalid), ("replicas", dp.replicas),
                        ("member", dp.member), ("nrep_cur", dp.nrep_cur),
                    )
                }
            sh = shared[dev]
            sdp = dp if scen_dps is None else scen_dps[i]
            if scen_dps is None:
                reps, mem, ncur = sh["replicas"], sh["member"], sh["nrep_cur"]
                budget = min(max_reassign, 2**31 - 1)
            else:
                reps, mem, ncur = (
                    _upload(a, dev) for a in (sdp.replicas, sdp.member, sdp.nrep_cur)
                )
                budget = min(scen_budget[i], 2**31 - 1)
            reps_f, feasible, completed, n_evac, n_moves, su = _scenario(
                reps, mem, sh["allowed"], sh["has_explicit"],
                _upload(scenario_mask[i], dev), sh["weights"],
                ncur, sh["nrep_tgt"], sh["ncons"], sh["pvalid"], sh["bvalid"],
                cfg.min_replicas_for_rebalancing, cfg.min_unbalance, budget,
                max_moves=max_moves, max_evac=max_evac,
                allow_leader=cfg.allow_leader_rebalancing, batch=max(1, batch),
                engine=engine, scorer=scorer,
            )
            n_repairs = 0
            if scen_pls is not None:
                feasible &= scen_feasible[i]
                n_repairs = max_reassign - scen_budget[i] if scen_feasible[i] else 0
                # a budget-truncated repair pass leaves replica counts off
                # target: structurally incomplete
                completed &= feasible and all(
                    p.num_replicas == len(p.replicas)
                    for p in scen_pls[i].iter_partitions()
                )
            out.append(SweepResult(
                brokers=sorted(int(b) for b in sc),
                feasible=feasible,
                completed=completed,
                n_evacuations=n_evac,
                n_moves=n_moves,
                unbalance=su,
                replicas=dp.decode_replicas(reps_f.cpu().numpy(), sdp.nrep_cur),
                n_repairs=n_repairs,
            ))
    if spans:
        # every process's results, put back in scenario order
        mine = [i for i in range(len(scenarios))
                if owners[i // per_dev] == mesh.rank]
        everyone = distributed.all_gather_object(list(zip(mine, out)))
        out = [r for _, r in sorted(
            (pair for part in everyone for pair in part), key=lambda p: p[0])]
    obs.metrics.count("sweep.infeasible", sum(1 for r in out if not r.feasible))
    return out


def best_scenario(results: Sequence[SweepResult]) -> int:
    """Index of the feasible, fully drained scenario with the lowest final
    unbalance."""
    best, best_u = -1, float("inf")
    for i, r in enumerate(results):
        if r.feasible and r.completed and r.unbalance < best_u:
            best, best_u = i, r.unbalance
    if best < 0:
        raise ValueError("no feasible scenario")
    return best
