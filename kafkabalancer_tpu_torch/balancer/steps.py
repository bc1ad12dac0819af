"""The greedy planning steps — a faithful behavioural rebuild of the
reference's step pipeline (steps.go), used as the parity oracle for the TPU
solver and as the default ``-solver=greedy`` backend.

Differences from the reference are intentional and documented:

- Steps are pure with respect to the input list (except
  :func:`fill_defaults`, which fills defaults in place exactly like the
  reference, steps.go:39-66). A step that proposes a change returns a new
  ``PartitionList`` holding a *copy* of the changed partition; the caller
  applies it explicitly (``cli.apply_assignment``). The reference instead
  leaks mutations through slice aliasing (SURVEY.md §2.2) — observable
  single-move outputs are identical, but multi-move sessions that trigger
  replica add/remove repairs are well-defined here and corrupt state there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# numpy is imported lazily inside scan_moves: balancer.steps sits on the
# import path of the daemon's jax-free forwarding client (cli -> balancer
# -> steps), and a module-level numpy import would put ~0.1 s back into
# every forwarded invocation's startup — the exact cost serving removes
from kafkabalancer_tpu_torch.balancer.costmodel import (
    BrokerLoadList,
    get_bl,
    get_broker_list,
    get_broker_list_by_load,
    get_broker_list_by_load_bl,
    get_broker_load,
    get_unbalance_bl,
)
from kafkabalancer_tpu_torch.models import Partition, PartitionList, RebalanceConfig
from kafkabalancer_tpu_torch.models.config import HOST_FLOAT_DTYPE
from kafkabalancer_tpu_torch.models.partition import single_partition_list
from kafkabalancer_tpu_torch.obs import convergence


class BalanceError(Exception):
    """A planning failure (maps to CLI exit code 3)."""


def replace_replica(p: Partition, orig: int, repl: int) -> PartitionList:
    """Reference ``replacepl`` (utils.go:166-197), acting on a copy.

    ``repl == -1`` deletes the replica; if ``repl`` is already present the
    two positions are swapped (a leadership exchange without data movement,
    utils.go:181-188); otherwise the slot is overwritten in place.

    The returned copy carries a ``_source`` reference to the partition object
    it was derived from so the CLI can apply the change to the live list by
    identity — the explicit analog of the reference's slice aliasing, and
    the only correct match when duplicate topic+partition entries exist.
    """
    src = p
    p = p.copy()
    p._source = src  # type: ignore[attr-defined]
    for idx, bid in enumerate(p.replicas):
        if bid == orig:
            if repl == -1:
                del p.replicas[idx]
            else:
                try:
                    existing = p.replicas.index(repl)
                except ValueError:
                    existing = -1
                if existing > -1:
                    p.replicas[idx], p.replicas[existing] = (
                        p.replicas[existing],
                        p.replicas[idx],
                    )
                else:
                    p.replicas[idx] = repl
            return single_partition_list(p)
    raise AssertionError(f"partition {p} replicas don't contain {orig}")


def add_replica(p: Partition, b: int) -> PartitionList:
    """Reference ``addpl`` (utils.go:199-202), acting on a copy."""
    src = p
    p = p.copy()
    p._source = src  # type: ignore[attr-defined]
    p.replicas.append(b)
    return single_partition_list(p)


def validate_weights(
    pl: PartitionList, _cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """All-or-nothing weights, no negatives (steps.go:7-23).

    Quirk preserved: when partition 0 lacks a weight but a later one has
    one, the error names partition 0 (steps.go:15).
    """
    has_weights = pl.partitions[0].weight != 0

    for p in pl.partitions:
        if has_weights and p.weight == 0:
            raise BalanceError(f"partition {p} has no weight")
        if not has_weights and p.weight != 0:
            raise BalanceError(f"partition {pl.partitions[0]} has no weight")
        if p.weight < 0:
            raise BalanceError(f"partition {p} has negative weight")

    return None


def validate_replicas(
    pl: PartitionList, _cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """No duplicate broker within a partition's replica set (steps.go:27-36)."""
    for p in pl.partitions:
        if len(set(p.replicas)) != len(p.replicas):
            raise BalanceError(f"partition {p} has duplicated replicas")
    return None


def fill_defaults(
    pl: PartitionList, cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Fill Weight/Brokers/NumReplicas defaults in place (steps.go:39-66)."""
    if pl.partitions[0].weight == 0:
        for p in pl.partitions:
            p.weight = 1.0

    brokers = cfg.brokers
    if brokers is None:
        brokers = get_broker_list(pl)
    for p in pl.partitions:
        if p.brokers is None:
            p.brokers = brokers

    for p in pl.partitions:
        if p.num_replicas == 0:
            p.num_replicas = len(p.replicas)

    return None


def remove_extra_replicas(
    pl: PartitionList, _cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Shrink over-replicated partitions (steps.go:70-89).

    Scans allowed brokers ascending by (load, ID) and removes the replica on
    the first one currently holding a replica — i.e. the *least-loaded*
    holder. (The reference README's scenario describes the opposite; code
    and test are authoritative, SURVEY.md §2.5.) May remove the leader,
    promoting the first follower. No MinReplicas gate.
    """
    # the load table is only read once a partition actually needs the
    # repair; on a compliant input this step must cost one O(P) length
    # scan, not an O(P·R) load accumulation (the per-move pipeline runs
    # it on EVERY balance() call — a resident-session daemon's entire
    # steady state)
    loads = None

    for p in pl.iter_partitions():
        if p.num_replicas >= len(p.replicas):
            continue

        if loads is None:
            loads = get_broker_load(pl)
        for b in get_broker_list_by_load(loads, p.brokers):
            if b in p.replicas:
                return replace_replica(p, b, -1)

        raise BalanceError(f"partition {p} unable to pick replica to remove")

    return None


def add_missing_replicas(
    pl: PartitionList, _cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Grow under-replicated partitions (steps.go:93-113).

    Scans allowed brokers *descending* from most-loaded (the reference's
    ``idx--`` loop, steps.go:102-106) and adds a replica on the first broker
    not already holding one — i.e. the most-loaded eligible non-member.
    """
    loads = None  # lazy, like remove_extra_replicas

    for p in pl.iter_partitions():
        if p.num_replicas <= len(p.replicas):
            continue

        if loads is None:
            loads = get_broker_load(pl)
        for b in reversed(get_broker_list_by_load(loads, p.brokers)):
            if b not in p.replicas:
                return add_replica(p, b)

        raise BalanceError(f"partition {p} unable to pick replica to add")

    return None


def move_disallowed_replicas(
    pl: PartitionList, _cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Move replicas off brokers outside the partition's allowed set
    (steps.go:117-143), to the most-loaded allowed non-member broker
    (descending scan, steps.go:129-135).

    Candidates come from the observed-load table only — no zero-fill of
    ``cfg.brokers`` (unlike ``move``), so a brand-new empty broker can never
    be the target of a disallowed-replica move (SURVEY.md §2.5).
    """
    bl = None  # lazy: built only once a violation actually exists

    # fast path: a replica's broker always appears in the observed-load
    # table (it holds that replica), so membership in the filtered
    # ``brokers_by_load`` is exactly membership in ``p.brokers`` — the
    # per-partition O(B·|brokers|) table build is only needed once a
    # violation exists. After fill_defaults most partitions share one
    # brokers-list OBJECT, so the set caches by identity (same trick as
    # the session planner's repair prescreen). On a compliant
    # 10k-partition input this step drops ~0.8 s -> ~0.01 s of the
    # stateless per-invocation cost.
    allowed_sets: dict = {}
    for p in pl.iter_partitions():
        key = id(p.brokers)
        bset = allowed_sets.get(key)
        if bset is None:
            bset = allowed_sets[key] = set(p.brokers)
        if all(rid in bset for rid in p.replicas):
            continue

        if bl is None:
            bl = get_bl(get_broker_load(pl))
        brokers_by_load = get_broker_list_by_load_bl(bl, p.brokers)
        for rid in p.replicas:
            if rid in brokers_by_load:
                continue

            for b in reversed(brokers_by_load):
                if b in p.replicas:
                    continue
                return replace_replica(p, rid, b)

            raise BalanceError(
                f"partition {p} unable to pick replica to replace broker {rid}"
            )

    return None


def greedy_move(
    pl: PartitionList, cfg: RebalanceConfig, leaders: bool
) -> Optional[PartitionList]:
    """The greedy single-move search (reference ``move``, steps.go:145-232).

    Semantics pinned for parity:

    - the broker table ``bl`` is sorted once by (load, ID) up front; both the
      source-replica scan and the target scan iterate in that fixed order;
    - first-strict-improver selection: a candidate replaces the incumbent
      only when its unbalance is strictly lower (steps.go:211), so the first
      candidate in (partition, replica, bl-rank) order achieving the global
      minimum wins;
    - the what-if delta adds/subtracts the plain follower weight even when
      moving a leader — the leader premium is *not* re-applied during the
      simulation (steps.go:185, :207). This under-models leader moves but is
      observable reference behaviour (SURVEY.md §3.3);
    - brokers from ``cfg.brokers`` with no observed load are zero-filled and
      are valid targets (steps.go:151-155);
    - accept only if the improvement exceeds ``min_unbalance``
      (steps.go:227).
    """
    best: Optional[tuple] = None

    loads = get_broker_load(pl)
    for bid in cfg.brokers or []:
        if bid not in loads:
            loads[bid] = 0.0  # a broker with no load is a valid target

    bl = get_bl(loads)

    su = get_unbalance_bl(bl)
    cu = su

    cu, best, _pos = scan_moves(
        list(pl.iter_partitions()), bl, cu, best, cfg, leaders
    )

    if cu < su - cfg.min_unbalance:
        p, r, b = best
        return replace_replica(p, r, b)

    # the decline is the observable the metrics line lacked: a
    # below-threshold exit vs a converged one vs an infeasible instance
    # (convergence.note_outcome is a thread-local dict store — always
    # on). Feasibility is deliberately NOT checked here: this decline
    # fires on EVERY balance() call once a movable class converges
    # (MoveLeaders keeps declining for the rest of a long per-move
    # session), and an O(P) existence pass per call would tax the hot
    # loop for a value only the FINAL decline's consumer needs — the
    # CLI refines already_balanced → no_feasible_candidate lazily on
    # zero-move exits (the feasible_unknown marker), and
    # classify_no_move does the full job for the fused path.
    if best is not None and cu < su:
        convergence.note_outcome(
            "below_threshold", unbalance=su, best_unbalance=cu,
            min_unbalance=cfg.min_unbalance,
        )
    else:
        convergence.note_outcome(
            "already_balanced", unbalance=su,
            min_unbalance=cfg.min_unbalance, feasible_unknown=True,
        )
    return None


def _any_feasible_candidate(
    pl: PartitionList, cfg: RebalanceConfig, leaders: bool
) -> bool:
    """Cheap existence check: is there ANY (partition, movable replica,
    target) the scan would score at all? Early-exits on the first hit
    (the common case on any rebalanceable input); used only to
    distinguish ``no_feasible_candidate`` from ``already_balanced`` on
    declining calls."""
    universe = set()
    for p in pl.iter_partitions():
        universe.update(p.replicas)
    universe.update(cfg.brokers or [])
    allowed_memo: dict = {}
    for p in pl.iter_partitions():
        if p.num_replicas < cfg.min_replicas_for_rebalancing:
            continue
        movable = p.replicas[0:1] if leaders else p.replicas[1:]
        if not movable:
            continue
        key = id(p.brokers)
        bset = allowed_memo.get(key)
        if bset is None:
            bset = allowed_memo[key] = universe.intersection(p.brokers or ())
        if bset.difference(p.replicas):
            return True
    return False


def classify_no_move(pl: PartitionList, cfg: RebalanceConfig) -> dict:
    """Classify why no (further) move is available on the CURRENT state
    — the fused session's host-side answer to the question its device
    early-exit cannot report (the while_loop only says "no candidate
    cleared the threshold", not which constraint was binding). Returns a
    ``convergence.note_outcome``-shaped dict.

    Cost: one vectorized :func:`scan_moves` pass (plus the leader pass
    under ``allow_leader_rebalancing``) — run lazily: on zero-move
    exits ONLY when a telemetry consumer exists
    (-stats/-metrics-json/-explain; the CLI resolves the session's
    ``classify_pending`` marker), and on ``-explain`` finalization.
    Never per round, and never on the served steady state of a
    converged cluster.
    """
    loads = get_broker_load(pl)
    for bid in cfg.brokers or []:
        if bid not in loads:
            loads[bid] = 0.0
    bl = get_bl(loads)
    su = get_unbalance_bl(bl)
    feasible = _any_feasible_candidate(pl, cfg, False) or (
        cfg.allow_leader_rebalancing
        and _any_feasible_candidate(pl, cfg, True)
    )
    if not feasible:
        return {"reason": "no_feasible_candidate", "unbalance": su}
    parts = list(pl.iter_partitions())
    cu, best = su, None
    if cfg.allow_leader_rebalancing:
        cu, best, _ = scan_moves(parts, bl, cu, best, cfg, True)
    cu, best, _ = scan_moves(parts, bl, cu, best, cfg, False)
    if best is not None and cu < su:
        return {
            "reason": "below_threshold", "unbalance": su,
            "best_unbalance": cu, "min_unbalance": cfg.min_unbalance,
        }
    return {
        "reason": "already_balanced", "unbalance": su,
        "min_unbalance": cfg.min_unbalance,
    }


def scan_partition_move(
    p: Partition, bl: BrokerLoadList, cu: float, best: Optional[tuple],
    cfg: RebalanceConfig, leaders: bool,
) -> "tuple[float, Optional[tuple]]":
    """One partition's slice of the greedy scan (reference ``move`` loop
    body, steps.go:167-223) — ``bl`` is mutated and restored exactly like
    the reference so candidate objectives accumulate in ``bl`` order.

    Shared by :func:`greedy_move` (every partition) and the vectorized
    solver's tie resolution (solvers/tpu.py — only partitions the device
    pass flags as candidate-window members), which is what makes the two
    paths byte-identical by construction.
    """
    if p.num_replicas < cfg.min_replicas_for_rebalancing:
        return cu, best

    movable = p.replicas[0:1] if leaders else p.replicas[1:]

    for r in movable:
        ridx = -1
        rload = 0.0
        for idx, (bid, bload) in enumerate(bl):
            if bid == r:
                ridx = idx
                rload = bload
                bl[idx][1] -= p.weight
        if ridx == -1:
            raise BalanceError(
                f"assertion failed: replica {r} not in broker loads {bl}"
            )

        for idx in range(len(bl)):
            bid = bl[idx][0]
            if bid not in p.brokers:
                continue
            # the slot's current holder set — the target must be new
            if bid in p.replicas:
                continue

            bload = bl[idx][1]
            bl[idx][1] += p.weight
            u = get_unbalance_bl(bl)

            if u < cu:
                cu = u
                best = (p, r, bid)

            bl[idx][1] = bload

        bl[ridx][1] = rload

    return cu, best


# batched scan: candidates per numpy chunk — bounds the what-if matrix at
# ~chunk×B doubles while keeping the column accumulation loop long enough
# to amortize per-op numpy overhead
_SCAN_CHUNK = 8192


def replay_broker_loads(
    bl: BrokerLoadList, moves: Sequence[Tuple[int, int, float]]
) -> list:
    """Oracle-side replay of a move log onto a broker-load table with
    the session's exact IEEE-754 op order: per move, ONE subtract on the
    source cell then ONE add on the target cell (the two ops both the
    scalar scan's what-if and the device session's
    ``loads.at[s].add(-w).at[t].add(w)`` commit perform), applied in
    move order. ``moves`` is a sequence of ``(src_broker_id,
    tgt_broker_id, applied_delta)``. Returns a fresh ``[[bid, load]]``
    table; ``bl`` is not mutated.

    This is the differential-pin harness for the sharded scale tier
    (tests/test_parallel.py): the mesh session's replicated/psum-exact
    broker-load table after k accepted moves must equal this replay of
    its own move log bit for bit — any drift in the cross-shard
    accumulation order would show up here before it could corrupt a
    plan."""
    out = [[bid, load] for bid, load in bl]
    idx = {int(bid): i for i, (bid, _load) in enumerate(out)}
    for s, t, w in moves:
        out[idx[int(s)]][1] -= w
        out[idx[int(t)]][1] += w
    return out


def scan_moves(
    parts: Sequence[Partition],
    bl: BrokerLoadList,
    cu: float,
    best: Optional[tuple],
    cfg: RebalanceConfig,
    leaders: bool,
    chunk: int = _SCAN_CHUNK,
) -> "Tuple[float, Optional[tuple], int]":
    """Vectorized replay of :func:`scan_partition_move` over ``parts`` in
    order — same ``(cu, best)`` to the last bit, plus the index into
    ``parts`` of the partition contributing ``best`` (``-1`` when ``best``
    is returned unchanged).

    Bit parity holds by construction, not by tolerance: every candidate's
    what-if table is the base ``bl`` loads with the source cell decremented
    and the target cell incremented (the exact two IEEE-754 ops the scalar
    scan performs), and the objective is accumulated COLUMN BY COLUMN in
    ``bl`` order — each candidate row sees the identical left-to-right
    float addition sequence, division-by-zero/NaN semantics included, that
    :func:`kafkabalancer_tpu_torch.balancer.costmodel.get_unbalance_bl` runs.
    First-strict-improver selection is then the first candidate, in
    (partition, replica, bl-rank) enumeration order, attaining the global
    minimum — which is the first index of that minimum in the scored
    vector. The scalar scan remains the oracle; the randomized differential
    pin is tests/test_steps.py.

    ``chunk`` bounds the what-if matrix at ``chunk × B`` doubles — the
    oracle-side CHUNKED replay: the running strict-< minimum replays
    across chunks exactly like the sharded scale tier's per-chunk winner
    combine replays across row blocks, so results are invariant to the
    chunk size (pinned by tests) and the oracle scales to candidate
    counts that would not fit one what-if matrix.
    """
    import numpy as np  # deferred: keep the jax-free client import-light

    nb = len(bl)
    base = np.array([cell[1] for cell in bl], dtype=HOST_FLOAT_DTYPE)
    bl_bids = np.array([cell[0] for cell in bl], dtype=np.int64)
    bid_to_idx = {int(b): i for i, b in enumerate(bl_bids)}

    # -explain candidate accounting (recorder installed on this thread
    # only when the flag asked for it; a handful of integer adds here)
    rec = convergence.recorder()
    entry_cu = cu
    n_scored = n_mask_allow = n_mask_member = n_mask_minrep = 0
    n_improving = n_clearing = 0

    # -- enumerate candidates (the scalar scan's exact order) -------------
    src_l: List[np.ndarray] = []
    tgt_l: List[np.ndarray] = []
    w_l: List[np.ndarray] = []
    pos_l: List[np.ndarray] = []
    r_l: List[np.ndarray] = []
    allowed_memo: dict = {}  # brokers-list identity -> bl eligibility mask
    for pos, p in enumerate(parts):
        movable = p.replicas[0:1] if leaders else p.replicas[1:]
        if p.num_replicas < cfg.min_replicas_for_rebalancing:
            if rec is not None:
                n_mask_minrep += len(movable) * nb
            continue
        if not movable:
            continue
        am = allowed_memo.get(id(p.brokers))
        if am is None:
            am = np.isin(bl_bids, np.asarray(list(p.brokers), dtype=np.int64))
            allowed_memo[id(p.brokers)] = am
        mem = np.isin(bl_bids, np.asarray(p.replicas, dtype=np.int64))
        elig = np.nonzero(am & ~mem)[0]
        if rec is not None:
            n_mov = len(movable)
            n_mask_allow += n_mov * int((~am).sum())
            n_mask_member += n_mov * int((am & mem).sum())
            n_scored += n_mov * len(elig)
        for r in movable:
            ridx = bid_to_idx.get(r)
            if ridx is None:
                raise BalanceError(
                    f"assertion failed: replica {r} not in broker loads {bl}"
                )
            n = len(elig)
            if n == 0:
                continue
            tgt_l.append(elig.astype(np.int64))
            src_l.append(np.full(n, ridx, dtype=np.int64))
            w_l.append(np.full(n, p.weight, dtype=HOST_FLOAT_DTYPE))
            pos_l.append(np.full(n, pos, dtype=np.int64))
            r_l.append(np.full(n, r, dtype=np.int64))
    if not tgt_l:
        if rec is not None:
            rec.note_scan(
                n_scored, n_mask_allow, n_mask_member, n_mask_minrep
            )
        return cu, best, -1
    src = np.concatenate(src_l)
    tgt = np.concatenate(tgt_l)
    w = np.concatenate(w_l)
    ppos = np.concatenate(pos_l)
    rids = np.concatenate(r_l)

    # -- score chunks; replay the running strict-< minimum across them ----
    winner = -1
    chunk = max(1, int(chunk))
    for lo in range(0, len(src), chunk):
        hi = min(lo + chunk, len(src))
        n = hi - lo
        mat = np.tile(base, (n, 1))
        rows = np.arange(n)
        mat[rows, src[lo:hi]] -= w[lo:hi]
        mat[rows, tgt[lo:hi]] += w[lo:hi]
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.zeros(n, dtype=HOST_FLOAT_DTYPE)
            for j in range(nb):
                s = s + mat[:, j]
            avg = s / float(nb)
            u = np.zeros(n, dtype=HOST_FLOAT_DTYPE)
            for j in range(nb):
                rel = mat[:, j] / avg - 1.0
                sq = rel * rel
                u = u + np.where(rel > 0, sq, sq / 2)
        if rec is not None:
            # threshold accounting: improving candidates that do not
            # clear min_unbalance are "masked by the threshold"
            n_improving += int(np.sum(u < entry_cu))
            n_clearing += int(np.sum(u < entry_cu - cfg.min_unbalance))
        finite = u[~np.isnan(u)]
        if finite.size == 0:
            continue  # all-NaN objectives never beat cu (NaN < cu is False)
        mn = float(finite.min())
        if mn < cu:
            cu = mn
            k = lo + int(np.flatnonzero(u == mn)[0])
            winner = k
    if rec is not None:
        rec.note_scan(n_scored, n_mask_allow, n_mask_member, n_mask_minrep)
        rec.note_scores(n_improving, n_clearing)
    if winner < 0:
        return cu, best, -1
    pos = int(ppos[winner])
    best = (parts[pos], int(rids[winner]), int(bl_bids[tgt[winner]]))
    return cu, best, pos


def distribute_leaders(
    pl: PartitionList, cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Leadership-only rebalancing (reference ``distributeLeaders``,
    steps.go:234-282).

    Bails when total unbalance is below ``min_unbalance`` (steps.go:249-253);
    otherwise hands leadership of the first eligible partition led by the
    most-loaded broker to the globally least-loaded broker. When that target
    is already a follower this becomes an in-place swap (leadership transfer
    without data movement) via :func:`replace_replica`.
    """
    loads = get_broker_load(pl)
    for bid in cfg.brokers or []:
        if bid not in loads:
            loads[bid] = 0.0

    bl = get_bl(loads)

    su = get_unbalance_bl(bl)
    if su < cfg.min_unbalance:
        convergence.note_outcome(
            "below_threshold", unbalance=su,
            min_unbalance=cfg.min_unbalance,
        )
        return None

    heavy = bl[-1][0]
    led = [p for p in pl.iter_partitions() if p.replicas[0] == heavy]
    for p in led:
        if p.num_replicas < cfg.min_replicas_for_rebalancing:
            continue
        return replace_replica(p, p.replicas[0], bl[0][0])

    convergence.note_outcome("no_feasible_candidate", unbalance=su)
    return None


def reassign_leaders(
    pl: PartitionList, cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Gate on ``rebalance_leaders`` (steps.go:301-307)."""
    if not cfg.rebalance_leaders:
        return None
    return distribute_leaders(pl, cfg)


def move_leaders(
    pl: PartitionList, cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Leader moves, gated on ``allow_leader_rebalancing`` (steps.go:292-298)."""
    if not cfg.allow_leader_rebalancing:
        return None
    return greedy_move(pl, cfg, True)


def move_non_leaders(
    pl: PartitionList, cfg: RebalanceConfig
) -> Optional[PartitionList]:
    """Follower moves — always enabled (steps.go:286-288)."""
    return greedy_move(pl, cfg, False)
