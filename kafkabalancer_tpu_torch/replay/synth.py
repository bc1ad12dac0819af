"""Deterministic multi-tenant fleet-churn synthesizer.

Counterpart of the reference package's ``replay/synth.py``, kept as a
copy: the same seed gives the same tenants, events and state text in
both packages. The replay harness (replay/harness.py) needs traffic
that looks like a fleet, not a fixture: many tenants of very different
sizes, arrival rates that drift through the (virtual) day, brokers that
fail, topics that arrive in storms, and per-partition weights that
wander enough to exercise the resident-session resync ladder.
Everything here is driven by ONE ``random.Random(seed)`` — the same
seed always produces the same tenant fleet, the same event order and
the same mutations, so a replay run is a reproducible regression gate
rather than a flaky load test.

Pieces:

- :class:`TenantState` — one tenant's cluster as the CLIENT sees it:
  plain row dicts rendered to the reassignment-JSON input format
  (codecs/readers.py) and mutated by the closed loop
  (:meth:`TenantState.apply_plan` applies the planner's emitted moves,
  exactly what the outer automation loop does in production);
- :class:`FleetSynth` — the seeded event stream: per-step tenant
  selection (skewed sizes x diurnal modulation, or uniform), plus the
  churn events at configured cadences (weight shifts -> row-level
  resyncs; broker failures -> allowlist rewrites, i.e. bulk row drift;
  topic-creation storms -> structural drift -> full re-register).

No torch and no numpy anywhere (the harness drives the client path,
which imports neither); no wall-clock reads (virtual time is the step
counter — determinism).
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Any, Dict, List, Optional, Tuple

# event kinds the synthesizer emits alongside each plan request
EV_PLAN = "plan"
EV_WEIGHT_SHIFT = "weight_shift"
EV_BROKER_FAILURE = "broker_failure"
EV_TOPIC_STORM = "topic_storm"
# watch-mode (ZkClusterSynth) change events
EV_EXTERNAL_FLIP = "external_flip"
EV_TOPIC_CREATE = "topic_create"


class TenantState:
    """One tenant's cluster state as the client's outer loop sees it."""

    def __init__(
        self,
        name: str,
        rng: random.Random,
        partitions: int,
        brokers: int,
        replicas: int,
        arrival_weight: float,
        diurnal_phase: float,
    ) -> None:
        self.name = name
        self.version = 1
        self.brokers = list(range(brokers))
        self.arrival_weight = arrival_weight
        self.diurnal_phase = diurnal_phase
        self.moves_applied = 0
        self._topic_seq = 0
        nrep = max(1, min(replicas, brokers))
        # partitions spread over ~8 topics but carry tenant-wide unique
        # partition ids, so (topic, partition) is unambiguous and the
        # closed-loop plan application needs no dedup
        n_topics = max(1, min(8, max(1, partitions) // 8 or 1))
        self.rows: List[Dict[str, Any]] = []
        for i in range(max(1, partitions)):
            self.rows.append({
                "topic": f"{name}-t{i % n_topics}",
                "partition": i,
                "replicas": rng.sample(self.brokers, nrep),
                "weight": round(0.5 + 1.5 * rng.random(), 3),
            })

    # -- rendering ---------------------------------------------------------
    def text(self) -> str:
        """The reassignment-JSON input text the real client ships."""
        return json.dumps(
            {"version": self.version, "partitions": self.rows},
            separators=(",", ":"),
        )

    # -- the closed loop ---------------------------------------------------
    def apply_plan(self, plan_text: str) -> int:
        """Apply the planner's emitted moves to this state — the outer
        automation loop's production behavior. Returns how many rows
        changed. Unknown (topic, partition) entries are ignored: the
        harness reconciles request counts, not planner semantics."""
        try:
            doc = json.loads(plan_text)
        except ValueError:
            return 0
        by_key = {
            (r["topic"], r["partition"]): r for r in self.rows
        }
        changed = 0
        for entry in doc.get("partitions") or []:
            if not isinstance(entry, dict):
                continue
            row = by_key.get((entry.get("topic"), entry.get("partition")))
            if row is None:
                continue
            new = entry.get("replicas")
            if isinstance(new, list) and new != row["replicas"]:
                row["replicas"] = [int(b) for b in new]
                changed += 1
        self.moves_applied += changed
        return changed

    # -- churn mutations ---------------------------------------------------
    def shift_weights(self, rng: random.Random, frac: float) -> int:
        """Drift a random ``frac`` of row weights (the diurnal load
        shift): a small delta per row, enough to change the state
        digest -> the session ladder's row-level resync path."""
        n = max(1, int(len(self.rows) * frac))
        for i in sorted(rng.sample(range(len(self.rows)), min(n, len(self.rows)))):
            row = self.rows[i]
            row["weight"] = round(
                max(0.05, row["weight"] * (0.8 + 0.4 * rng.random())), 3
            )
        return n

    def fail_broker(self, rng: random.Random) -> Optional[int]:
        """Fail one broker: every row gets an explicit allowlist that
        excludes it (the operator's response to a dead broker), so the
        planner steers replicas away. Rewrites every row -> the resync
        diff exceeds the client's row-ship fraction -> a full
        re-register (the worst-case session path, on purpose)."""
        if len(self.brokers) <= max(
            2, max((len(r["replicas"]) for r in self.rows), default=1)
        ):
            return None  # never fail below a plannable universe
        failed = rng.choice(self.brokers)
        self.brokers.remove(failed)
        for row in self.rows:
            row["brokers"] = list(self.brokers)
            if failed in row["replicas"] and len(self.brokers) >= len(
                row["replicas"]
            ):
                # the failed broker's replicas restart on a survivor
                # (what a reassignment tool is FOR); pick one not
                # already holding this partition
                free = [
                    b for b in self.brokers if b not in row["replicas"]
                ]
                if free:
                    row["replicas"] = [
                        rng.choice(free) if b == failed else b
                        for b in row["replicas"]
                    ]
        return failed

    def topic_storm(self, rng: random.Random, size: int) -> int:
        """A topic-creation storm: ``size`` new partitions appear at
        once (structural drift — row count changes, so the resident
        session can only re-register)."""
        self._topic_seq += 1
        nrep = max(
            1,
            min(
                max((len(r["replicas"]) for r in self.rows), default=1),
                len(self.brokers),
            ),
        )
        base = len(self.rows)
        for j in range(max(1, size)):
            self.rows.append({
                "topic": f"{self.name}-storm{self._topic_seq}",
                "partition": base + j,
                "replicas": rng.sample(self.brokers, nrep),
                "weight": round(0.5 + 1.5 * rng.random(), 3),
            })
        if any("brokers" in r for r in self.rows):
            for r in self.rows[base:]:
                r["brokers"] = list(self.brokers)
        return max(1, size)


class ZkClusterSynth:
    """A seeded Zookeeper-shaped cluster for the ``--watch`` replay:
    the synthesizer owns the fake-ZK directory tree
    (``$KAFKABALANCER_TPU_FAKE_ZK`` layout, codecs/zookeeper.py
    ``FileZkClient``) AND a mirror of every state it has ever
    published, keyed by the watch digest — so the harness can oracle
    any emitted plan against exactly the state the watcher planned
    from, regardless of read/mutation interleaving. Every mutation is
    ONE atomic topic-file publish (tmp+rename), so a concurrent watch
    read always sees a state the mirror knows."""

    def __init__(
        self,
        seed: int,
        zk_root: str,
        topics: int = 3,
        partitions_per: int = 6,
        brokers: int = 6,
        replicas: int = 2,
    ) -> None:
        self.rng = random.Random(seed ^ 0x2A7C)
        self.zk_root = zk_root
        self.brokers = list(range(max(replicas + 1, brokers)))
        self._topics_dir = os.path.join(zk_root, "brokers", "topics")
        os.makedirs(self._topics_dir, exist_ok=True)
        nrep = max(1, min(replicas, len(self.brokers)))
        # deliberately skewed initial placement (most replicas on the
        # first few brokers): the planner has real work to do
        skewed = self.brokers[:max(2, nrep)]
        self.state: Dict[str, Dict[str, List[int]]] = {}
        for t in range(max(1, topics)):
            name = f"watch-t{t}"
            self.state[name] = {
                str(i): list(self.rng.sample(
                    skewed if self.rng.random() < 0.8 else self.brokers,
                    nrep,
                ))
                for i in range(max(1, partitions_per))
            }
        self._nrep = nrep
        self._topic_seq = 0
        self.events: Dict[str, int] = {
            EV_EXTERNAL_FLIP: 0, EV_TOPIC_CREATE: 0,
        }
        # digest -> rendered oracle input text of every published state
        self.snapshots: Dict[str, str] = {}
        for name in self.state:
            self._write_topic(name)
        self.snapshot()

    # -- publishing --------------------------------------------------------
    def _write_topic(self, name: str) -> None:
        path = os.path.join(self._topics_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"version": 1, "partitions": self.state[name]},
                f, separators=(",", ":"),
            )
        os.replace(tmp, path)

    def input_text(self) -> str:
        """The current state as reassignment-JSON input — EXACTLY the
        rows (topic-sorted, partition-id int-sorted, replicas only) a
        watch read of the fake tree produces, so a ``-no-daemon`` run
        on this text is the byte oracle for the watcher's plan."""
        rows = [
            {
                "topic": t,
                "partition": int(pid),
                "replicas": self.state[t][pid],
            }
            for t in sorted(self.state)
            for pid in sorted(self.state[t], key=int)
        ]
        return json.dumps(
            {"version": 1, "partitions": rows}, separators=(",", ":")
        )

    def digest(self) -> str:
        """The watch digest of the current state (serve/state.py over
        ZK-decoded rows — version 0, the ZK read's PartitionList
        default; replicas-only rows)."""
        from kafkabalancer_tpu_torch.models import Partition
        from kafkabalancer_tpu_torch.serve import state as sstate

        canon = [
            sstate.canonical_row_bytes(*sstate.partition_fields(
                Partition(
                    topic=t, partition=int(pid),
                    replicas=list(self.state[t][pid]),
                )
            ))
            for t in sorted(self.state)
            for pid in sorted(self.state[t], key=int)
        ]
        return sstate.rows_digest(0, canon)

    def snapshot(self) -> str:
        """Record the current state's oracle text under its digest;
        returns the digest."""
        d = self.digest()
        self.snapshots[d] = self.input_text()
        return d

    # -- the closed loop ---------------------------------------------------
    def apply_plan(self, plan_text: str) -> int:
        """Apply an emitted plan to the fake cluster (the role the
        operator's reassignment tool plays in production) — one atomic
        topic publish per touched topic. Returns rows changed."""
        try:
            doc = json.loads(plan_text)
        except ValueError:
            return 0
        changed = 0
        touched = set()
        for entry in doc.get("partitions") or []:
            if not isinstance(entry, dict):
                continue
            tmap = self.state.get(entry.get("topic", ""))
            if tmap is None:
                continue
            pid = str(entry.get("partition"))
            new = entry.get("replicas")
            if pid in tmap and isinstance(new, list) and new != tmap[pid]:
                tmap[pid] = [int(b) for b in new]
                touched.add(entry["topic"])
                changed += 1
        for name in touched:
            self._write_topic(name)
        if changed:
            self.snapshot()
        return changed

    # -- churn events ------------------------------------------------------
    def external_flip(self) -> str:
        """Out-of-band drift: one partition's replica set changes
        under the watcher's feet (an operator move it did not emit) —
        the watcher must resync, never emit a stale plan."""
        name = self.rng.choice(sorted(self.state))
        pid = self.rng.choice(sorted(self.state[name], key=int))
        cur = self.state[name][pid]
        free = [b for b in self.brokers if b not in cur]
        if free:
            i = self.rng.randrange(len(cur))
            cur = list(cur)
            cur[i] = self.rng.choice(free)
            self.state[name][pid] = cur
        self._write_topic(name)
        self.events[EV_EXTERNAL_FLIP] += 1
        return self.snapshot()

    def create_topic(self, partitions: int = 2) -> str:
        """Structural drift: a new topic appears (row count changes —
        the watcher re-adopts from the fresh read)."""
        self._topic_seq += 1
        name = f"watch-new{self._topic_seq}"
        self.state[name] = {
            str(i): list(self.rng.sample(self.brokers, self._nrep))
            for i in range(max(1, partitions))
        }
        self._write_topic(name)
        self.events[EV_TOPIC_CREATE] += 1
        return self.snapshot()


class FleetSynth:
    """The seeded fleet + event stream; see the module docstring."""

    def __init__(
        self,
        seed: int,
        tenants: int = 3,
        base_partitions: int = 48,
        brokers: int = 8,
        replicas: int = 3,
        skew: float = 1.5,
        arrival: str = "weighted",
        diurnal_period: int = 64,
        diurnal_amplitude: float = 0.6,
        weight_shift_every: int = 7,
        weight_shift_frac: float = 0.1,
        broker_failure_every: int = 0,
        topic_storm_every: int = 0,
        storm_size: int = 4,
    ) -> None:
        if arrival not in ("weighted", "uniform"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        self.rng = random.Random(seed)
        self.seed = seed
        self.arrival = arrival
        self.diurnal_period = max(1, diurnal_period)
        self.diurnal_amplitude = max(0.0, min(0.95, diurnal_amplitude))
        self.weight_shift_every = max(0, weight_shift_every)
        self.weight_shift_frac = weight_shift_frac
        self.broker_failure_every = max(0, broker_failure_every)
        self.topic_storm_every = max(0, topic_storm_every)
        self.storm_size = storm_size
        self.events: Dict[str, int] = {
            EV_PLAN: 0, EV_WEIGHT_SHIFT: 0,
            EV_BROKER_FAILURE: 0, EV_TOPIC_STORM: 0,
        }
        self.tenants: List[TenantState] = []
        for i in range(max(1, tenants)):
            # zipf-skewed tenant sizes AND arrival shares: tenant 0 is
            # the whale, the tail is small — the fairness shape the
            # per-tenant attribution exists to expose
            share = 1.0 / ((i + 1) ** max(0.0, skew))
            self.tenants.append(TenantState(
                f"tenant-{i:02d}",
                self.rng,
                partitions=max(8, int(base_partitions * share)),
                brokers=brokers,
                replicas=replicas,
                arrival_weight=share,
                diurnal_phase=self.rng.random(),
            ))

    # -- arrival -----------------------------------------------------------
    def _arrival_weights(self, step: int) -> List[float]:
        if self.arrival == "uniform":
            return [1.0] * len(self.tenants)
        out = []
        for t in self.tenants:
            phase = 2.0 * math.pi * (
                step / self.diurnal_period + t.diurnal_phase
            )
            out.append(
                t.arrival_weight
                * (1.0 + self.diurnal_amplitude * math.sin(phase))
            )
        return out

    def step(self, step: int) -> Tuple[TenantState, List[str]]:
        """One virtual-time step: pick the tenant whose request fires
        (diurnal-modulated skewed arrival) and apply any churn events
        due at this step to it BEFORE the request — the request then
        carries the churned state, exactly like a production outer
        loop re-reading the cluster. Returns (tenant, event kinds)."""
        weights = self._arrival_weights(step)
        tenant = self.rng.choices(self.tenants, weights=weights, k=1)[0]
        fired = [EV_PLAN]
        self.events[EV_PLAN] += 1
        if (
            self.weight_shift_every
            and step > 0
            and step % self.weight_shift_every == 0
        ):
            tenant.shift_weights(self.rng, self.weight_shift_frac)
            self.events[EV_WEIGHT_SHIFT] += 1
            fired.append(EV_WEIGHT_SHIFT)
        if (
            self.topic_storm_every
            and step > 0
            and step % self.topic_storm_every == 0
        ):
            tenant.topic_storm(self.rng, self.storm_size)
            self.events[EV_TOPIC_STORM] += 1
            fired.append(EV_TOPIC_STORM)
        if (
            self.broker_failure_every
            and step > 0
            and step % self.broker_failure_every == 0
        ):
            if tenant.fail_broker(self.rng) is not None:
                self.events[EV_BROKER_FAILURE] += 1
                fired.append(EV_BROKER_FAILURE)
        return tenant, fired
