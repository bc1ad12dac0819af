"""The port's kernels on the card (``cuda``-marked; skipped without a GPU).

This file imports nothing of JAX or of the JAX package, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the reference's
tests.) The CUDA kernel is held against its plain torch version on the
inputs the session gives it (captured from a real session call) with
tolerance zero: all eight outputs equal under ``==``. The whole session
with the kernel must emit the same plan as with the plain scorer.
"""

import pytest
import torch

from kafkabalancer_tpu_torch.models import default_rebalance_config
from kafkabalancer_tpu_torch.parallel import shard_kernel as sk
from kafkabalancer_tpu_torch.solvers import scan
from kafkabalancer_tpu_torch.utils.synth import synth_cluster
from torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def cfg(allow_leader=False):
    c = default_rebalance_config()
    c.min_unbalance = 1e-7
    c.allow_leader_rebalancing = allow_leader
    return c


def captured(n_parts, n_brokers, device, seed=3):
    """The scorer's inputs at a session's first iteration (cloned)."""
    seen = []

    def capture(*args, **kw):
        if not seen:
            seen.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return sk.shard_score(*args, **kw)

    scan.plan(
        synth_cluster(n_parts, n_brokers, rf=3, seed=seed), cfg(), 1,
        batch=16, device=device, scorer=capture,
    )
    return seen[0]


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("colo", [False, True])
@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("shape", [(300, 20), (3000, 60)])
def test_kernel_matches_plain(cuda_device, shape, allow_leader, colo, restricted):
    args = captured(*shape, cuda_device)
    mem = args[2]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    if restricted:
        args[3] = torch.rand(mem.shape, generator=g, device=cuda_device) < 0.6
    crows = None
    if colo:
        crows = torch.randint(0, 4, mem.shape, generator=g, device=cuda_device)
        crows = crows.to(torch.float32)
        args[7] = args[7].clone()
        args[7][2] = 0.375
    got = sk.shard_score(*args, crows, allow_leader=allow_leader)
    ref = sk.shard_score_plain(*args, crows, allow_leader=allow_leader)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and bool((a == b).all())


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_takes_any_pair_frame(cuda_device, allow_leader):
    """Pair columns need not come from ``cost.pair_frame``: hot brokers
    that repeat, dead columns and arbitrary targets give the plain
    version's outputs too."""
    args = captured(3000, 60, cuda_device)
    B, B2 = args[2].shape[1], args[8].shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for k in (8, 9):
        args[k] = torch.randint(
            0, B, (B2,), generator=g, device=cuda_device, dtype=torch.int32
        )
    args[10] = torch.rand(B2, generator=g, device=cuda_device) < 0.7
    assert len(set(args[8].tolist())) < B2  # some hot broker repeats
    got = sk.shard_score(*args, allow_leader=allow_leader)
    ref = sk.shard_score_plain(*args, allow_leader=allow_leader)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and bool((a == b).all())


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = captured(300, 20, cuda_device)
    bad = list(args)
    bad[4] = args[4].double()  # float64 loads: the kernel is float32 only
    with pytest.raises(TypeError):
        sk.shard_score(*bad, allow_leader=False)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()  # non-contiguous cols
    with pytest.raises(ValueError):
        sk.shard_score(*bad, allow_leader=False)


@pytest.mark.parametrize("allow_leader", [False, True])
def test_kernel_session_matches_plain_session(cuda_device, allow_leader):
    sk.shard_score.launches = 0
    a = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        device=cuda_device,
    )
    assert sk.shard_score.launches > 0
    b = scan.plan(
        synth_cluster(2000, 40, seed=9), cfg(allow_leader), 5000, batch=32,
        device=cuda_device, scorer=sk.shard_score_plain,
    )
    ma = [(p.topic, p.partition, tuple(p.replicas)) for p in a.partitions]
    mb = [(p.topic, p.partition, tuple(p.replicas)) for p in b.partitions]
    assert ma and ma == mb
