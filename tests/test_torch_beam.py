"""The port's beam solver against the reference's.

``kafkabalancer_tpu_torch.solvers.beam`` on CPU tensors against
``kafkabalancer_tpu.solvers.beam`` at float64: one search
(``_search_once``: the accepted sequence), the whole search's logs
(``beam_search``: parents and moves at every depth), the pipeline step
(``beam_move``) and receding-horizon planning (``beam_plan``: moves in
order and the final assignment), at width 8 and depth 4, with and without
sibling expansion, the colocation penalty and leader moves; the
rotation-locked instances of tests/test_beam.py; a frontier full of equal
values (the top-k order among ties and dead beams); and an all-zero-load
cluster (a NaN objective). Tolerance: none; everything compares equal.
"""

import copy

import numpy as np
import pytest
import torch

from kafkabalancer_tpu.models import default_rebalance_config as jdefault
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import rotation_locked_cluster as jrot
from kafkabalancer_tpu.utils.synth import synth_cluster as jsynth

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu.balancer import steps as jsteps  # noqa: E402
from kafkabalancer_tpu.solvers import beam as jbeam  # noqa: E402
from kafkabalancer_tpu_torch.balancer import steps as tsteps  # noqa: E402
from kafkabalancer_tpu_torch.models import (  # noqa: E402
    default_rebalance_config as tdefault,
)
from kafkabalancer_tpu_torch.ops import cost as tcost  # noqa: E402
from kafkabalancer_tpu_torch.ops.tensorize import tensorize, to_device  # noqa: E402
from kafkabalancer_tpu_torch.solvers import beam as tbeam  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import rotation_locked_cluster as trot  # noqa: E402
from kafkabalancer_tpu_torch.utils.synth import synth_cluster as tsynth  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)
from test_torch_scan import moves, state  # noqa: E402

OPTS = [  # (siblings, lam, allow_leader)
    (s, lam, al) for s in (False, True) for lam in (0.0, 0.001)
    for al in (False, True)
]


def cfgs(siblings, lam, allow_leader, width=8, depth=4):
    j, t = jdefault(), tdefault()
    for c in (j, t):
        c.allow_leader_rebalancing = allow_leader
        c.min_unbalance = 1e-9
        c.anti_colocation = lam
        c.beam_siblings = siblings
        c.beam_width = width
        c.beam_depth = depth
    return j, t


def clusters(seed, n=240, b=12, weighted=True):
    kw = dict(rf=3, seed=seed, weighted=weighted, zipf_topics=True)
    return jsynth(n, b, **kw), tsynth(n, b, **kw)


def settled(pl_j, pl_t, jc, tc):
    """Both lists after the pipeline's validations and defaults, as the
    beam step sees them."""
    for st, pl, c in ((jsteps, pl_j, jc), (tsteps, pl_t, tc)):
        st.validate_weights(pl, c)
        st.fill_defaults(pl, c)


@pytest.mark.parametrize("siblings,lam,allow_leader", OPTS)
def test_search_once_matches_reference(siblings, lam, allow_leader):
    pl_j, pl_t = clusters(8)
    jc, tc = cfgs(siblings, lam, allow_leader)
    settled(pl_j, pl_t, jc, tc)
    a = jbeam._search_once(pl_j, jc, 4)
    b = tbeam._search_once(pl_t, tc, 4, device="cpu")
    assert a is not None and b is not None
    assert b[1] == a[1]


@pytest.mark.parametrize("siblings,lam,allow_leader", OPTS)
def test_beam_plan_matches_reference(siblings, lam, allow_leader):
    pl_j, pl_t = clusters(7)
    jc, tc = cfgs(siblings, lam, allow_leader)
    opl_j = jbeam.beam_plan(pl_j, jc, 60)
    opl_t = tbeam.beam_plan(pl_t, tc, 60, device="cpu")
    assert moves(opl_j)
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def test_beam_plan_chunked_reentry_matches_reference():
    """Sessions of 16 moves re-enter on the mutated assignment."""
    pl_j, pl_t = clusters(9)
    jc, tc = cfgs(True, 0.001, True)
    opl_j = jbeam.beam_plan(pl_j, jc, 40, chunk_moves=16)
    opl_t = tbeam.beam_plan(pl_t, tc, 40, chunk_moves=16, device="cpu")
    assert len(moves(opl_j)) > 16
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


@pytest.mark.parametrize("lam", [0.0, 0.001])
@pytest.mark.parametrize("allow_leader", [False, True])
def test_beam_move_matches_reference(allow_leader, lam):
    """Five pipeline steps in turn, each applied before the next."""
    from kafkabalancer_tpu.cli import apply_assignment as japply
    from kafkabalancer_tpu_torch.cli import apply_assignment as tapply

    pl_j, pl_t = clusters(11)
    jc, tc = cfgs(False, lam, allow_leader)
    settled(pl_j, pl_t, jc, tc)
    for _ in range(5):
        a = jbeam.beam_move(pl_j, jc)
        b = tbeam.beam_move(pl_t, tc, device="cpu")
        assert moves(a) == moves(b)
        if a is None or not a.partitions:
            break
        japply(pl_j, a.partitions[0])
        tapply(pl_t, b.partitions[0])
    assert state(pl_t) == state(pl_j)


def test_rotation_locked_instances_match_reference():
    """tests/test_beam.py's rotation-locked class: every improvement is a
    3-move rotation of uphill single steps; beam resolves each cycle, in
    the reference's order."""
    jc, tc = cfgs(True, 0.015, False)
    pl_j, pl_t = jrot(4), trot(4)
    opl_j = jbeam.beam_plan(pl_j, jc, 10000)
    opl_t = tbeam.beam_plan(pl_t, tc, 10000, device="cpu")
    assert len(moves(opl_j)) == 12
    assert moves(opl_t) == moves(opl_j)
    assert state(pl_t) == state(pl_j)


def search_inputs(pl_t, tc, weights=None):
    """``beam_search``'s inputs for both packages from one encoding."""
    dp = tensorize(pl_t, tc)
    if weights is not None:
        dp.weights[:] = weights
    d = to_device(dp, "cpu", torch.float64)
    B = dp.bvalid.shape[0]
    loads = tcost.broker_loads(d.replicas, d.weights, d.nrep_cur, d.ncons, B)
    always = np.zeros(B, bool)
    t_in = (
        loads, d.replicas, d.member, d.allowed, d.weights, d.nrep_cur,
        d.nrep_tgt, d.ncons, d.pvalid, torch.from_numpy(always), d.bvalid,
        torch.from_numpy(dp.topic_id), 2,
        torch.tensor(float(tc.anti_colocation), dtype=torch.float64),
    )
    j_in = tuple(
        jnp.asarray(x.numpy()) if torch.is_tensor(x) else jnp.int32(x)
        for x in t_in
    )
    return t_in, j_in, len(dp.topics)


@pytest.mark.parametrize("siblings", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.05])
def test_beam_search_logs_match_reference_on_ties(siblings, lam):
    """Equal partition weights on a uniform cluster: the frontier is full
    of equal values, and at depth 0 seven of the eight beams are dead
    (+inf rows). The stable ascending sort must pick the reference's
    top-k order: every parent, move and target at every depth equal."""
    pl_t = tsynth(48, 8, rf=2, seed=4, weighted=False)
    tc = tdefault()
    tc.anti_colocation = lam
    tsteps.validate_weights(pl_t, tc)
    tsteps.fill_defaults(pl_t, tc)
    t_in, j_in, n_top = search_inputs(pl_t, tc)
    n_topics = 2 * n_top if lam else 0
    kw = dict(width=8, depth=4, allow_leader=False, n_topics=n_topics,
              siblings=siblings)
    a = jbeam.beam_search(*j_in, **kw)
    b = tbeam.beam_search(*t_in, **kw)
    flat = np.asarray(a[5]).reshape(-1)
    assert (flat >= 0).any()
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_beam_search_on_a_nan_objective_matches_reference():
    """All-zero loads make the objective NaN (0/0, as the reference's
    float division gives): no state beats the start, and both packages
    return the same logs."""
    pl_t = tsynth(24, 6, rf=2, seed=2, weighted=True)
    tc = tdefault()
    tsteps.validate_weights(pl_t, tc)
    tsteps.fill_defaults(pl_t, tc)
    t_in, j_in, _ = search_inputs(pl_t, tc, weights=0.0)
    kw = dict(width=4, depth=3, allow_leader=True, n_topics=0)
    a = jbeam.beam_search(*j_in, **kw)
    b = tbeam.beam_search(*t_in, **kw)
    assert np.isnan(float(a[0]))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy(), equal_nan=True)


def test_beam_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = cfgs(False, 0.0, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbeam.beam_plan(tsynth(50, 6), tc, 10)
    pl = tsynth(50, 6)
    tsteps.validate_weights(pl, tc)
    tsteps.fill_defaults(pl, tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbeam.beam_move(copy.deepcopy(pl), tc)
