"""The port's torch cost model against the reference's JAX cost model.

Same inputs (one numpy encoding from a seeded random cluster) go through
``kafkabalancer_tpu.ops.cost`` and ``kafkabalancer_tpu_torch.ops.cost``
on the CPU. Tolerance: zero — every output must be equal under ``==`` at
float64 and at float32, because the port's sessions are held move for
move against the reference and a last-bit difference can reorder tied
candidates. Pair outputs are compared on live pair columns; dead columns
must be +inf on both sides (their rows are don't-cares the sessions
never read).
"""

import random

import numpy as np
import pytest
import torch

from helpers import random_partition_list

from kafkabalancer_tpu.models import default_rebalance_config
from kafkabalancer_tpu.ops import cost as jcost
from kafkabalancer_tpu.ops import tensorize as jtensorize
from kafkabalancer_tpu.ops.runtime import ensure_x64

ensure_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu_torch.ops import cost as tcost  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from kafkabalancer_tpu_torch.ops.tensorize import (  # noqa: E402
    tensorize as ttensorize,
)

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
SEEDS = [3, 11, 29]


def instance(seed, restrict=False, n_parts=None, n_brokers=None):
    rng = random.Random(seed)
    pl = random_partition_list(
        rng, n_parts or rng.randint(20, 90), n_brokers or rng.randint(5, 40),
        weighted=True, with_consumers=True, filled=True,
        restrict_brokers=restrict,
    )
    return jtensorize(pl, default_rebalance_config())


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b), np.flatnonzero(a != b)[:10]


def both(dp, npdt, tdt):
    """The encoding's session inputs for each package, loads from the
    reference's broker_loads (held equal to the port's separately)."""
    loads = np.asarray(
        jcost.broker_loads(
            jnp.asarray(dp.replicas), jnp.asarray(dp.weights.astype(npdt)),
            jnp.asarray(dp.nrep_cur), jnp.asarray(dp.ncons.astype(npdt)),
            dp.bvalid.shape[0],
        )
    )
    names = ("replicas", "allowed", "member", "nrep_cur", "nrep_tgt", "pvalid",
             "bvalid")
    j = {k: jnp.asarray(getattr(dp, k)) for k in names}
    t = {k: torch.from_numpy(getattr(dp, k)) for k in names}
    for k in ("weights", "ncons"):
        j[k] = jnp.asarray(getattr(dp, k).astype(npdt))
        t[k] = torch.from_numpy(getattr(dp, k)).to(tdt)
    j["loads"] = jnp.asarray(loads)
    t["loads"] = torch.from_numpy(loads.copy())
    return j, t


def test_tensorize_matches_reference():
    from kafkabalancer_tpu.ops import tensorize as jt
    from kafkabalancer_tpu_torch.models import Partition, PartitionList

    for seed in SEEDS:
        rng = random.Random(seed)
        pl = random_partition_list(
            rng, 40, 9, weighted=True, with_consumers=True,
            restrict_brokers=True, filled=True,
        )
        # the port's own model objects, field for field
        tpl = PartitionList(
            version=1,
            partitions=[
                Partition(
                    topic=p.topic, partition=p.partition,
                    replicas=list(p.replicas), weight=p.weight,
                    num_replicas=p.num_replicas, brokers=p.brokers,
                    num_consumers=p.num_consumers,
                )
                for p in pl.partitions
            ],
        )
        a = jt(pl, default_rebalance_config())
        b = ttensorize(tpl, default_rebalance_config())
        for k in ("broker_ids", "weights", "replicas", "nrep_cur", "nrep_tgt",
                  "ncons", "allowed", "member", "pvalid", "bvalid",
                  "topic_id"):
            same(getattr(a, k), getattr(b, k))
        assert a.topics == b.topics


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_broker_loads_bit_exact(npdt, tdt, seed):
    dp = instance(seed, n_parts=300)
    j, t = both(dp, npdt, tdt)
    got = tcost.broker_loads(
        t["replicas"], t["weights"], t["nrep_cur"], t["ncons"],
        dp.bvalid.shape[0],
    )
    same(j["loads"], got)


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("n", [8, 24, 32, 48, 100, 128, 256, 384, 1100])
def test_ordered_sum_matches_reference_order(npdt, tdt, n):
    rng = np.random.default_rng(n)
    x = (rng.random(n) * rng.choice([1.0, 1e3, 1e-3], n)).astype(npdt)
    same(jnp.sum(jnp.asarray(x)), tcost.ordered_sum(torch.from_numpy(x)))
    # column sums of a [n, 12] product (the prefix-sum shape)
    a = (rng.random((n, 12)) < 0.4).astype(npdt) * x[:, None]
    import jax

    ref = jax.jit(lambda v: jnp.sum(v, axis=0))(jnp.asarray(a))
    same(ref, tcost.ordered_sum(torch.from_numpy(a), 0))


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_penalty_unbalance_rank(npdt, tdt, seed):
    dp = instance(seed)
    j, t = both(dp, npdt, tdt)
    nb = float(dp.nb)
    avg = float(np.asarray(j["loads"]).sum() / nb)
    same(
        jcost.overload_penalty(j["loads"], jnp.asarray(avg, npdt)),
        tcost.overload_penalty(t["loads"], torch.tensor(avg, dtype=tdt)),
    )
    same(
        jcost.unbalance(j["loads"], j["bvalid"], jnp.asarray(nb, npdt)),
        tcost.unbalance(t["loads"], t["bvalid"], torch.tensor(nb, dtype=tdt)),
    )
    # ties in load must break by broker index
    loads = np.asarray(j["loads"]).copy()
    loads[1::3] = loads[0]
    for a, b in zip(
        jcost.rank_brokers(jnp.asarray(loads), j["bvalid"]),
        tcost.rank_brokers(torch.from_numpy(loads), t["bvalid"]),
    ):
        same(a, b)


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_move_candidate_scores(npdt, tdt, seed):
    dp = instance(seed, restrict=True)
    j, t = both(dp, npdt, tdt)
    nb = float(dp.nb)
    _, jperm, jrank = jcost.rank_brokers(j["loads"], j["bvalid"])
    _, tperm, trank = tcost.rank_brokers(t["loads"], t["bvalid"])
    ju, jsu = jcost.move_candidate_scores(
        j["loads"], j["replicas"], j["allowed"][:, jperm],
        j["member"][:, jperm], j["bvalid"], j["bvalid"][jperm], jperm, jrank,
        j["weights"], j["nrep_cur"], j["nrep_tgt"], j["pvalid"],
        jnp.asarray(nb, npdt), 2,
    )
    tu, tsu = tcost.move_candidate_scores(
        t["loads"], t["replicas"], t["allowed"][:, tperm],
        t["member"][:, tperm], t["bvalid"], t["bvalid"][tperm], tperm, trank,
        t["weights"], t["nrep_cur"], t["nrep_tgt"], t["pvalid"],
        torch.tensor(nb, dtype=tdt), 2,
    )
    same(jsu, tsu)
    same(ju, tu)


def colo_rows(dp, npdt, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, dp.member.shape).astype(npdt)


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_factored_target_best(npdt, tdt, allow_leader, colo, seed):
    dp = instance(seed, restrict=True)
    j, t = both(dp, npdt, tdt)
    nb = float(dp.nb)
    crows = colo_rows(dp, npdt, seed) if colo else None
    jr = jcost.factored_target_best(
        j["loads"], j["replicas"], j["allowed"], j["member"], j["bvalid"],
        j["weights"], j["nrep_cur"], j["nrep_tgt"], j["ncons"], j["pvalid"],
        jnp.asarray(nb, npdt), 2, allow_leader=allow_leader,
        c_rows=None if crows is None else jnp.asarray(crows),
        lam=None if crows is None else jnp.asarray(0.25, npdt),
    )
    tr = tcost.factored_target_best(
        t["loads"], t["replicas"], t["allowed"], t["member"], t["bvalid"],
        t["weights"], t["nrep_cur"], t["nrep_tgt"], t["ncons"], t["pvalid"],
        torch.tensor(nb, dtype=tdt), 2, allow_leader=allow_leader,
        c_rows=None if crows is None else torch.from_numpy(crows),
        lam=None if crows is None else 0.25,
    )
    for a, b in zip(jr, tr):
        same(a, b)


def target_best_both(dp, j, t, npdt, tdt, allow_leader, crows, **opts):
    """``factored_target_best`` of both packages on the same inputs;
    ``opts`` values are numpy arrays or ints, passed to each side in its
    own tensor type."""
    nb = float(dp.nb)

    def conv(v, to):
        if isinstance(v, tuple):
            return tuple(conv(x, to) for x in v)
        return to(v) if isinstance(v, np.ndarray) else v

    jr = jcost.factored_target_best(
        j["loads"], j["replicas"], j["allowed"], j["member"], j["bvalid"],
        j["weights"], j["nrep_cur"], j["nrep_tgt"], j["ncons"], j["pvalid"],
        jnp.asarray(nb, npdt), 2, allow_leader=allow_leader,
        c_rows=None if crows is None else jnp.asarray(crows),
        lam=None if crows is None else jnp.asarray(0.25, npdt),
        **{k: conv(v, jnp.asarray) for k, v in opts.items()},
    )
    tr = tcost.factored_target_best(
        t["loads"], t["replicas"], t["allowed"], t["member"], t["bvalid"],
        t["weights"], t["nrep_cur"], t["nrep_tgt"], t["ncons"], t["pvalid"],
        torch.tensor(nb, dtype=tdt), 2, allow_leader=allow_leader,
        c_rows=None if crows is None else torch.from_numpy(crows),
        lam=None if crows is None else 0.25,
        **{k: conv(v, torch.from_numpy) for k, v in opts.items()},
    )
    return jr, tr


def member_cell(dp, seed):
    """A seeded (partition, broker) cell holding a replica: the source
    ``exclude_src`` bars."""
    rows, cols = np.nonzero(dp.member[: dp.np_])
    i = np.random.default_rng(seed).integers(len(rows))
    return np.asarray(rows[i], np.int32), np.asarray(cols[i], np.int32)


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_factored_target_best_top2_and_exclude_src(
    npdt, tdt, allow_leader, colo, seed
):
    """The beam search's options: ``top2`` with the ``exclude_src`` bar
    (seven outputs), and each alone."""
    dp = instance(seed, restrict=True)
    j, t = both(dp, npdt, tdt)
    crows = colo_rows(dp, npdt, seed) if colo else None
    cell = member_cell(dp, seed)
    for opts in (dict(top2=True, exclude_src=cell), dict(top2=True),
                 dict(exclude_src=cell)):
        jr, tr = target_best_both(dp, j, t, npdt, tdt, allow_leader, crows, **opts)
        assert len(jr) == len(tr) == (7 if opts.get("top2") else 4)
        for a, b in zip(jr, tr):
            same(a, b)


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("colo", [False, True])
def test_factored_target_best_exclude_p(npdt, tdt, allow_leader, colo):
    seed = SEEDS[0]
    dp = instance(seed, restrict=True)
    j, t = both(dp, npdt, tdt)
    crows = colo_rows(dp, npdt, seed) if colo else None
    B = dp.bvalid.shape[0]
    ex = np.random.default_rng(seed).integers(0, dp.np_, B).astype(np.int32)
    jr, tr = target_best_both(dp, j, t, npdt, tdt, allow_leader, crows, exclude_p=ex)
    for a, b in zip(jr, tr):
        same(a, b)


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("colo", [False, True])
def test_factored_target_best_top2_equals_exclude_call(allow_leader, colo):
    """tests/test_ops.py's identity in the port: ``top2``'s second best is
    exactly a second call with ``exclude_p`` = the first winners."""
    for seed in SEEDS:
        dp = instance(seed, restrict=True)
        _, t = both(dp, np.float64, torch.float64)
        crows = colo_rows(dp, np.float64, seed) if colo else None
        args = (
            t["loads"], t["replicas"], t["allowed"], t["member"], t["bvalid"],
            t["weights"], t["nrep_cur"], t["nrep_tgt"], t["ncons"],
            t["pvalid"], torch.tensor(float(dp.nb), dtype=torch.float64), 2,
        )
        kw = dict(
            allow_leader=allow_leader,
            c_rows=None if crows is None else torch.from_numpy(crows),
            lam=None if crows is None else 0.25,
        )
        su, v1, p1, s1, v2, p2, s2 = tcost.factored_target_best(
            *args, top2=True, **kw
        )
        su_b, v2b, p2b, s2b = tcost.factored_target_best(*args, exclude_p=p1, **kw)
        fin = torch.isfinite(v2b)
        assert fin.any()
        assert torch.equal(su, su_b) and torch.equal(v2, v2b)
        assert torch.equal(p2[fin], p2b[fin]) and torch.equal(s2[fin], s2b[fin])
        assert not bool((p2[fin] == p1[fin]).any())


@pytest.mark.parametrize("npdt,tdt", DTYPES)
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_paired_best(npdt, tdt, allow_leader, colo, seed):
    dp = instance(seed, restrict=True)
    j, t = both(dp, npdt, tdt)
    crows = colo_rows(dp, npdt, seed) if colo else None
    jv, jp, jslot, js, jt_, jlive = jcost.paired_best(
        j["loads"], j["replicas"], j["allowed"], j["member"], j["bvalid"],
        j["weights"], j["nrep_cur"], j["nrep_tgt"], j["ncons"], j["pvalid"],
        2, allow_leader=allow_leader,
        c_rows=None if crows is None else jnp.asarray(crows),
        lam=None if crows is None else jnp.asarray(0.25, npdt),
    )
    tv, tp, tslot, ts, tt, tlive = tcost.paired_best(
        t["loads"], t["replicas"], t["allowed"], t["member"], t["bvalid"],
        t["weights"], t["nrep_cur"], t["nrep_tgt"], t["ncons"], t["pvalid"],
        2, allow_leader=allow_leader,
        c_rows=None if crows is None else torch.from_numpy(crows),
        lam=None if crows is None else 0.25,
    )
    same(jlive, tlive)
    same(jv, tv)
    live = np.asarray(jlive)
    assert live.any()
    for a, b in ((jp, tp), (jslot, tslot), (js, ts), (jt_, tt)):
        same(np.asarray(a)[live], b.numpy()[live])
    # dead pair columns: no candidate, on both sides
    assert np.isinf(np.asarray(jv)[~live]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_cumsum_matches_jnp_cumsum_at_every_length(dtype):
    """The reference's float prefix sum (a blocked scan on the CPU, see
    ``ordered_cumsum``) at every length 1..1100, values over six decades
    with signed zeros; one compiled program per 100 lengths."""
    rng = np.random.default_rng(17)
    xs = []
    for n in range(1, 1101):
        x = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
        x[rng.random(n) < 0.05] = -0.0
        xs.append(x.astype(dtype))
    scan = jax.jit(lambda xs: [jnp.cumsum(x) for x in xs])
    refs = [r for i in range(0, len(xs), 100) for r in scan(xs[i : i + 100])]
    for x, ref in zip(xs, refs):
        got = tcost.ordered_cumsum(torch.from_numpy(x)).numpy()
        assert got.dtype == dtype
        assert np.array_equal(got.view(np.uint8), np.asarray(ref).view(np.uint8)), len(x)


def test_ordered_cumsum_along_a_dimension():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 5)))
    ref = np.asarray(jnp.cumsum(jnp.asarray(x.numpy()), axis=0))
    assert np.array_equal(tcost.ordered_cumsum(x, 0).numpy(), ref)
    assert np.array_equal(tcost.ordered_cumsum(x.T, 1).T.numpy(), ref)
