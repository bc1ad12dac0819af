"""The port's fused ``-rebalance-leader`` session against the reference's.

``kafkabalancer_tpu_torch.solvers.scan.plan`` with ``rebalance_leaders``
(``solvers/leader.py`` on CPU tensors) must emit the moves of
``kafkabalancer_tpu.solvers.scan.plan`` in the same order and leave the
same final assignment, at float64 and float32, for ``batch=1`` (the
reference trajectory, including the leadership-exchange branch and chunk
re-entry) and for the batched extension (batch 16, and batch 100 on 40
brokers, where more than 16 pairs meet the blocked prefix sum
``ordered_cumsum``, pinned in tests/test_torch_cost.py). Also pinned: the
move-log decode applies a ``SWAP_SLOT`` entry as the reference does.
Tolerance: none.
"""

import copy
import random

import numpy as np
import pytest
import torch

from helpers import random_partition_list
from test_balancer import P, wrap

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu_torch.models import (  # noqa: E402
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.solvers import leader as tleader  # noqa: E402
from kafkabalancer_tpu_torch.solvers import scan as tscan  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import moves, state, to_port  # noqa: E402

DTYPES = {"f64": (None, None), "f32": (jnp.float32, torch.float32)}


def cfgs(allow_leader=False, min_unbalance=None):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.rebalance_leaders = True
        c.allow_leader_rebalancing = allow_leader
        if min_unbalance is not None:
            c.min_unbalance = min_unbalance
    return j, t


def both(pl_j, pl_t, jc, tc, budget, batch, dt="f64", **kw):
    from kafkabalancer_tpu.solvers.scan import plan as jplan

    jd, td = DTYPES[dt]
    opl_j = jplan(pl_j, jc, budget, batch=batch, dtype=jd, **kw)
    opl_t = tscan.plan(pl_t, tc, budget, batch=batch, dtype=td, device="cpu", **kw)
    return moves(opl_j), moves(opl_t)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("seed", [601, 602, 603])
def test_leader_session_matches_reference_batch1(seed, allow_leader, dt):
    """tests/test_scan.py::test_leader_session_parity's set-up: leader
    redistribution first each iteration, greedy moves otherwise."""
    rng = random.Random(seed)
    pl_j = random_partition_list(rng, 16, 5, weighted=True)
    pl_t = to_port(pl_j)
    jc, tc = cfgs(allow_leader, min_unbalance=1e-6)
    ref, got = both(pl_j, pl_t, jc, tc, 24, 1, dt)
    assert ref
    assert got == ref
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_leader_session_matches_reference_synth(allow_leader, batch, dt):
    pl_j, pl_t = jsynth(300, 12, rf=3, seed=7), tsynth(300, 12, rf=3, seed=7)
    jc, tc = cfgs(allow_leader, min_unbalance=1e-5)
    ref, got = both(pl_j, pl_t, jc, tc, 400, batch, dt)
    assert ref
    assert got == ref
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_batched_leader_session_with_more_pairs_than_a_scan_block(dt):
    """40 brokers and batch 100: 20 hot/cold pairs per round, so the
    in-round gate's prefix sum runs past one 16-element block."""
    pl_j, pl_t = jsynth(480, 40, rf=3, seed=11), tsynth(480, 40, rf=3, seed=11)
    jc, tc = cfgs(min_unbalance=1e-6)
    ref, got = both(pl_j, pl_t, jc, tc, 4000, 100, dt)
    assert len(ref) > 40
    assert got == ref
    assert state(pl_t) == state(pl_j)


def test_leader_session_swap_branch():
    """tests/test_scan.py::test_leader_session_swap_branch: leadership
    handed to a broker already in the replica set swaps positions in
    place."""
    parts = [
        P("t", 0, [1, 2], weight=5.0),
        P("t", 1, [1, 2], weight=1.0),
        P("t", 2, [1, 3], weight=1.0),
    ]
    pl_j = wrap(copy.deepcopy(parts))
    pl_t = to_port(pl_j)
    jc, tc = cfgs(min_unbalance=1e-9)
    ref, got = both(pl_j, pl_t, jc, tc, 4, 1)
    assert got == ref
    assert state(pl_t) == state(pl_j)
    for p in pl_t.iter_partitions():
        assert len(set(p.replicas)) == len(p.replicas)


@pytest.mark.parametrize("batch", [1, 8])
def test_leader_plan_chunk_reentry(batch):
    """tests/test_scan.py::test_leader_plan_chunk_reentry: chunks of 2
    moves re-enter with the mutated assignment like the reference's; at
    batch 1 they end where the one-chunk run ends (a batched round that a
    chunk boundary cuts is another trajectory, in both packages)."""
    res = {}
    for chunk in (2, 8192):
        pl_j, pl_t = jsynth(40, 6, rf=2, seed=9), tsynth(40, 6, rf=2, seed=9)
        jc, tc = cfgs()
        ref, got = both(pl_j, pl_t, jc, tc, 10, batch, chunk_moves=chunk)
        assert got == ref
        assert state(pl_t) == state(pl_j)
        res[chunk] = state(pl_t)
    if batch == 1:
        assert res[2] == res[8192]


def test_batched_leader_session_respects_budget():
    _, tc = cfgs()
    opl = tscan.plan(tsynth(200, 10, rf=3, seed=11), tc, 5, batch=8,
                     device="cpu")
    assert 0 < len(opl) <= 5


def test_superseded_mask_keeps_swaps_and_breaks_runs():
    """tests/test_scan.py::test_superseded_mask_semantics on the port."""
    S = tleader.SWAP_SLOT
    cases = [
        ([0, 0, 0], [1, 1, 1], [False, False, True]),
        ([0, 0, 0], [1, 2, 1], [True, True, True]),
        ([0, 0, 0], [1, S, 1], [True, True, True]),
        ([0, 5, 0], [1, 1, 1], [False, True, True]),
    ]
    for mp, ms, keep in cases:
        assert tscan._superseded_mask(np.array(mp), np.array(ms)).tolist() == keep


@pytest.mark.parametrize("drop", [False, True])
def test_decode_applies_a_swap_entry_as_the_reference(drop):
    from kafkabalancer_tpu.balancer.steps import fill_defaults as jfill
    from kafkabalancer_tpu.models.partition import empty_partition_list as jempty
    from kafkabalancer_tpu.ops.tensorize import tensorize as jtensorize
    from kafkabalancer_tpu.solvers.leader import SWAP_SLOT
    from kafkabalancer_tpu.solvers.scan import _decode_packed as jdecode
    from kafkabalancer_tpu_torch.balancer.steps import fill_defaults as tfill
    from kafkabalancer_tpu_torch.models.partition import empty_partition_list
    from kafkabalancer_tpu_torch.ops.tensorize import tensorize as ttensorize

    assert tleader.SWAP_SLOT == SWAP_SLOT
    pl_j = wrap([P("t", 0, [1, 2, 3]), P("t", 1, [2, 3, 1]), P("t", 2, [3, 1, 2])])
    pl_t = to_port(pl_j)
    jc, tc = jdefault(), tdefault()
    jc.brokers, tc.brokers = [1, 2, 3, 4], [1, 2, 3, 4]
    jfill(pl_j, jc)
    tfill(pl_t, tc)
    dj, dt = jtensorize(pl_j, jc), ttensorize(pl_t, tc)
    # dense broker index of ID b is b - 1; the log holds a plain move, a
    # swap toward the moved-in follower, a plain move after the swap on
    # the same partition, a swap toward a middle slot, and a plain move
    mp = [0, 0, 0, 2, 1]
    ms = [2, SWAP_SLOT, 2, SWAP_SLOT, 1]
    mt = [3, 3, 2, 1, 3]
    ml = 8
    packed = np.full(3 * ml + 1, -1, np.int32)
    packed[: len(mp)] = mp
    packed[ml : ml + len(ms)] = ms
    packed[2 * ml : 2 * ml + len(mt)] = mt
    packed[-1] = len(mp)
    oj, ot = jempty(), empty_partition_list()
    assert tscan._decode_packed(packed, dt, ot, drop) == jdecode(
        packed, dj, oj, drop)
    assert moves(ot) == moves(oj)
    assert state(pl_t) == state(pl_j)
