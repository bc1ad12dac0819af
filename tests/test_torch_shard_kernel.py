"""The scoring kernel's plain torch version against the reference kernel.

``kafkabalancer_tpu_torch.parallel.shard_kernel.shard_score_plain`` —
the function the port's CUDA kernel computes, and what ``shard_score``
runs on a CPU tensor — against ``kafkabalancer_tpu.parallel.shard_kernel.
shard_score`` with the Pallas kernel in interpret mode, at float32, on
the same seeded inputs. Tolerance: zero. All eight outputs (values with
+inf equal to +inf, and rows) must be equal under ``==``.

The sweep covers allow_leader on/off, colocation counts on/off, all
brokers allowed and a restricted per-row allowed matrix, dead pair
columns (fewer real brokers than the bucket) and several row tiles.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from kafkabalancer_tpu.balancer.steps import fill_defaults
from kafkabalancer_tpu.models import default_rebalance_config
from kafkabalancer_tpu.ops import cost as jcost
from kafkabalancer_tpu.ops import tensorize as jtensorize
from kafkabalancer_tpu.ops.runtime import ensure_x64
from kafkabalancer_tpu.utils.synth import synth_cluster

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from kafkabalancer_tpu_torch.ops import cost as tcost  # noqa: E402
from kafkabalancer_tpu_torch.parallel import shard_kernel as tk  # noqa: E402
import torch_helpers  # noqa: E402,F401  (torch CPU thread setting)


def make_inputs(n_parts, seed, restricted, colo, n_brokers=20):
    """Kernel inputs as numpy arrays, float32 (the kernel's dtype)."""
    pl = synth_cluster(n_parts, n_brokers, rf=3, seed=seed, weighted=True)
    fill_defaults(pl, default_rebalance_config())
    dp = jtensorize(pl, default_rebalance_config())
    rng = np.random.default_rng(seed)
    P, B = dp.member.shape
    f32 = np.float32
    w = dp.weights.astype(f32)
    nc = dp.ncons.astype(f32)
    loads = np.asarray(
        jcost.broker_loads(
            jnp.asarray(dp.replicas), jnp.asarray(w),
            jnp.asarray(dp.nrep_cur), jnp.asarray(nc), B,
        )
    )
    bvalid = dp.bvalid.copy()
    avg = f32(loads[bvalid].sum(dtype=f32) / f32(bvalid.sum()))
    F = np.where(
        bvalid, np.asarray(jcost.overload_penalty(jnp.asarray(loads), avg)), 0
    ).astype(f32)
    allowed = dp.allowed.copy()
    if restricted:
        allowed &= rng.random((P, B)) < 0.6
    # a few rows below min_replicas and a few with consumers
    nrep_tgt = dp.nrep_tgt.copy()
    nrep_tgt[rng.random(P) < 0.1] = 1
    ncons = (rng.integers(0, 3, P) * (rng.random(P) < 0.3)).astype(f32)
    cols = np.stack(
        [w, dp.nrep_cur.astype(f32), nrep_tgt.astype(f32), ncons,
         dp.pvalid.astype(f32)], axis=1,
    )
    s_i, t_i, live = (
        x.numpy()
        for x in tcost.pair_frame(torch.tensor(loads), torch.tensor(bvalid))
    )
    return dict(
        replicas=dp.replicas, cols=cols, member=dp.member, allowed=allowed,
        loads=loads, F=F, bvalid=bvalid,
        scal=np.asarray([avg, 2.0, 0.375 if colo else 0.0], f32),
        s_i=s_i.astype(np.int32), t_i=t_i.astype(np.int32), live=live,
        c_rows=rng.integers(0, 4, (P, B)).astype(f32) if colo else None,
    )


def reference(x, allow_leader):
    B = x["member"].shape[1]
    B2 = x["s_i"].shape[0]
    ssel = np.zeros((B, B2), np.float32)
    tsel = np.zeros((B, B2), np.float32)
    cols = np.flatnonzero(x["live"])
    ssel[x["s_i"][cols], cols] = 1.0
    tsel[x["t_i"][cols], cols] = 1.0
    from kafkabalancer_tpu.parallel.shard_kernel import shard_score

    out = shard_score(
        jnp.asarray(x["replicas"]), jnp.asarray(x["cols"]),
        jnp.asarray(x["member"]), jnp.asarray(x["allowed"]),
        jnp.asarray(x["loads"][None]), jnp.asarray(x["F"][None]),
        jnp.asarray(x["bvalid"][None]), jnp.asarray(x["scal"][None]),
        jnp.asarray(ssel), jnp.asarray(tsel),
        None if x["c_rows"] is None else jnp.asarray(x["c_rows"]),
        allow_leader=allow_leader, interpret=True,
    )
    return [np.asarray(o) for o in out]


def port(x, allow_leader, all_allowed=False):
    t = {
        k: None if v is None else torch.tensor(np.ascontiguousarray(v))
        for k, v in x.items()
    }
    return tk.shard_score(
        t["replicas"], t["cols"], t["member"],
        None if all_allowed else t["allowed"], t["loads"], t["F"],
        t["bvalid"], t["scal"], t["s_i"], t["t_i"], t["live"], t["c_rows"],
        allow_leader=allow_leader,
    )


def assert_equal(ref, got):
    names = ("vf", "pf", "vl", "pl", "vpf", "ppf", "vpl", "ppl")
    for name, a, b in zip(names, ref, got):
        b = b.cpu().numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), (name, np.flatnonzero(a != b)[:8])


CASES = [
    # (n_parts -> P bucket, restricted, colo)
    (200, False, False),  # P = 256, one tile
    (500, True, False),  # P = 512, two tiles
    (1000, False, True),  # P = 1024, four tiles
    (900, True, True),
]


@pytest.mark.parametrize("allow_leader", [False, True])
@pytest.mark.parametrize("n_parts,restricted,colo", CASES)
def test_plain_matches_reference_kernel(n_parts, restricted, colo, allow_leader):
    x = make_inputs(n_parts, seed=n_parts + 7, restricted=restricted, colo=colo)
    assert not x["live"].all()  # dead pair columns are in the sweep
    ref = reference(x, allow_leader)
    assert np.isfinite(ref[0]).any() and np.isfinite(ref[4]).any()
    if allow_leader:
        assert np.isfinite(ref[2]).any()
    assert_equal(ref, port(x, allow_leader))


def test_all_allowed_mode_matches_explicit_matrix():
    """``allowed=None`` (the all-allowed mode the session uses) is the
    broker-validity row broadcast."""
    x = make_inputs(300, seed=5, restricted=False, colo=False)
    x["allowed"] = np.broadcast_to(x["bvalid"][None], x["member"].shape).copy()
    for lead in (False, True):
        a = port(x, lead)
        b = port(x, lead, all_allowed=True)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor reaches the kernel launch (which raises here, with
    no card), never the plain version."""
    called = []
    monkeypatch.setattr(tk, "shard_score_plain", lambda *a, **k: called.append(1))
    fake = torch.empty(0, device="meta")
    with pytest.raises((ValueError, RuntimeError, TypeError)):
        tk.shard_score(
            fake, fake, fake, None, fake, fake, fake, fake, fake, fake, fake,
            allow_leader=False,
        )
    assert not called
