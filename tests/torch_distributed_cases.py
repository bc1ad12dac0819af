"""The cases of the port's two-process test, shared by the worker
processes (tests/torch_distributed_worker.py, which import no jax) and
the test itself (the same cases in one process): each returns plain JSON
values, floats as ``float.hex`` so that equality is exact."""

import copy

import numpy as np
import torch

from kafkabalancer_tpu_torch.models import default_rebalance_config
from kafkabalancer_tpu_torch.ops.tensorize import tensorize
from kafkabalancer_tpu_torch.parallel.shard_move import sharded_score_moves
from kafkabalancer_tpu_torch.parallel.shard_session import plan_sharded
from kafkabalancer_tpu_torch.parallel.sweep import sweep
from kafkabalancer_tpu_torch.solvers.tpu import oracle_loads, score_moves
from kafkabalancer_tpu_torch.utils.synth import synth_cluster

# (partitions, brokers, rf, seed) of the scorer's instances
SCORE_CLUSTERS = [(64, 8, 3, 5), (40, 6, 2, 17)]
SESSION = dict(n=96, b=8, rf=3, seed=71, budget=800, batch=8, chunk_moves=64)
SWEEP = dict(n=24, b=6, rf=2, seed=11, max_reassign=64)


def hexf(x):
    return float(x).hex()


def score_inputs(n, b, rf, seed):
    """The dense inputs of ``score_moves`` for one seeded cluster, padded
    to a multiple of 8 rows (divisible by every part axis here)."""
    pl = synth_cluster(n, b, rf=rf, seed=seed, weighted=True)
    cfg = default_rebalance_config()
    dp = tensorize(pl, cfg, min_bucket=8)
    loads = np.zeros(dp.bvalid.shape[0])
    for bid, load in oracle_loads(pl, cfg).items():
        loads[dp.broker_index(bid)] = load
    return pl, cfg, dp, (
        torch.from_numpy(loads), torch.from_numpy(dp.replicas),
        torch.from_numpy(dp.allowed), torch.from_numpy(dp.member),
        torch.from_numpy(dp.weights), torch.from_numpy(dp.nrep_cur),
        torch.from_numpy(dp.nrep_tgt), torch.from_numpy(dp.pvalid),
        torch.from_numpy(dp.bvalid), torch.tensor(float(dp.nb)), 2,
    )


def score_all(mesh):
    """``sharded_score_moves`` on ``mesh`` and the unsharded
    ``score_moves``, per instance and leader mode: ``[u, idx, su, perm]``
    each."""
    out = []
    for spec in SCORE_CLUSTERS:
        args = score_inputs(*spec)[3]
        for leaders in (False, True):
            row = []
            for u, i, su, perm in (
                sharded_score_moves(*args, leaders=leaders, mesh=mesh),
                score_moves(*args, leaders=leaders),
            ):
                row.append([hexf(u), int(i), hexf(su),
                            [int(x) for x in perm.reshape(-1)]])
            out.append(row)
    return out


def session_cfg():
    cfg = default_rebalance_config()
    cfg.min_unbalance = 1e-7
    cfg.allow_leader_rebalancing = True
    return cfg


def moves(opl):
    return [[p.topic, p.partition, list(p.replicas)]
            for p in (opl.partitions or [])]


def state(pl):
    return [[p.topic, p.partition, list(p.replicas)] for p in pl.partitions]


def session_moves(mesh, polish):
    """``plan_sharded`` on ``mesh`` for the session instance: the move log
    and the final assignment."""
    s = SESSION
    pl = synth_cluster(s["n"], s["b"], rf=s["rf"], seed=s["seed"],
                       weighted=True)
    opl = plan_sharded(pl, copy.deepcopy(session_cfg()), s["budget"], mesh,
                       batch=s["batch"], chunk_moves=s["chunk_moves"],
                       polish=polish)
    return {"moves": moves(opl), "state": state(pl)}


def sweep_instance(synth=synth_cluster):
    s = SWEEP
    pl = synth(s["n"], s["b"], rf=s["rf"], seed=s["seed"], weighted=True)
    observed = sorted({b for p in pl.partitions for b in p.replicas})
    scenarios = [
        observed,
        observed + [max(observed) + 1],
        observed + [max(observed) + 1, max(observed) + 2],
        observed[1:],
    ]
    return pl, scenarios


def sweep_row(r):
    return [r.brokers, bool(r.feasible), bool(r.completed), r.n_evacuations,
            r.n_moves, hexf(r.unbalance), r.replicas, r.n_repairs]


def sweep_fields(mesh):
    """The four-scenario sweep on ``mesh``: every field of every result."""
    pl, scenarios = sweep_instance()
    return [sweep_row(r) for r in sweep(
        pl, default_rebalance_config(), scenarios,
        max_reassign=SWEEP["max_reassign"], mesh=mesh)]
