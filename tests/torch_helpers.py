"""Shared helpers for the port's tests (``tests/test_torch_*.py``)."""

import numpy as np
import pytest
import torch

from kafkabalancer_tpu_torch.ops.cost import overload_penalty, pair_frame

# the suite runs in several worker processes at once; one intra-op thread
# each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip when this machine has none. The
    decision is made here, when a test runs, never at import or
    collection time: every test worker collects the same tests."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return "cuda:0"


def synthetic(P, B, device, seed, n_real=None, equal_weights=False):
    """Scoring-kernel inputs without a session, from numpy: rows
    [0, n_real) hold 3 distinct brokers of the valid ones, the rest are
    padding; some rows are below min_replicas or carry consumers; every
    third broker past the first 5 is invalid; the pair frame is
    ``cost.pair_frame`` of the loads. Returns the 12 arguments of
    ``shard_score`` (colocation counts included)."""
    rng = np.random.default_rng(seed)
    n_real = P if n_real is None else n_real
    bvalid = np.ones(B, bool)
    bvalid[5::3] = False
    valid_ids = np.flatnonzero(bvalid)
    R = 4
    replicas = np.full((P, R), -1, np.int32)
    member = np.zeros((P, B), bool)
    rf = min(3, len(valid_ids))
    ids = valid_ids[np.argsort(rng.random((n_real, len(valid_ids))), 1)[:, :rf]]
    replicas[:n_real, :rf] = ids
    member[np.arange(n_real)[:, None], ids] = True
    w = np.ones(P, np.float32) if equal_weights else rng.uniform(
        1, 10, P).astype(np.float32)
    w[n_real:] = 0
    ncur = np.where(np.arange(P) < n_real, 3, 0).astype(np.float32)
    ntgt = np.where(rng.random(P) < 0.1, 1, 3).astype(np.float32)
    ncons = (rng.integers(0, 3, P) * (rng.random(P) < 0.3)).astype(np.float32)
    pvalid = (np.arange(P) < n_real).astype(np.float32)
    cols = np.stack([w, ncur, ntgt, ncons, pvalid], axis=1)
    loads = (member * (w * (1 + ncons))[:, None]).sum(0).astype(np.float32)
    loads[~bvalid] = 0
    allowed = (rng.random((P, B)) < 0.6) & bvalid[None, :]
    crows = rng.integers(0, 4, (P, B)).astype(np.float32)
    t = {k: torch.tensor(v, device=device) for k, v in dict(
        replicas=replicas, cols=cols, member=member, allowed=allowed,
        loads=loads, bvalid=bvalid, crows=crows).items()}
    avg = t["loads"][t["bvalid"]].sum() / t["bvalid"].sum()
    F = torch.where(t["bvalid"], overload_penalty(t["loads"], avg),
                    torch.zeros_like(t["loads"]))
    scal = torch.stack([avg, torch.tensor(2.0, device=device),
                        torch.tensor(0.375, device=device)]).float()
    s_i, t_i, live = pair_frame(t["loads"], t["bvalid"])
    return [t["replicas"], t["cols"], t["member"], t["allowed"], t["loads"],
            F, t["bvalid"], scal, s_i.int().contiguous(),
            t_i.int().contiguous(), live.contiguous(), t["crows"]]
