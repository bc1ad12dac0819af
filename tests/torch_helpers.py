"""Shared helpers for the port's tests (``tests/test_torch_*.py``)."""

import contextlib
import os

import numpy as np
import pytest
import torch

from kafkabalancer_tpu_torch.ops.cost import overload_penalty, pair_frame

# the suite runs in several worker processes at once; one intra-op thread
# each keeps torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

# daemon isolation: a planning daemon of this package on the default
# per-uid socket must never serve the suite's cli.run() calls. Point the
# default socket at a path that cannot exist; tests that want a daemon
# pass -serve-socket explicitly.
os.environ["KAFKABALANCER_TPU_TORCH_SOCKET"] = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "no-torch-daemon-here.sock"
)


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


@contextlib.contextmanager
def running_daemon(**kw):
    """The port's planning daemon on a private socket (a fresh
    ``tempfile.mkdtemp`` directory: pytest's tmp_path is too deep for a
    unix socket path), served from a thread of this process with CPU
    lanes unless ``devices`` says otherwise and ``warm=False``. Yields
    ``(socket_path, daemon, log_lines)``; always shut down, with every
    wait bounded."""
    import shutil
    import tempfile
    import threading
    import time

    from kafkabalancer_tpu_torch.serve import client
    from kafkabalancer_tpu_torch.serve.daemon import Daemon

    d = tempfile.mkdtemp(prefix="kbt-")
    sock = os.path.join(d, "kb.sock")
    logs = []
    kw.setdefault("devices", ["cpu"])
    kw.setdefault("warm", False)
    kw.setdefault("idle_timeout", 120.0)
    daemon = Daemon(sock, log=logs.append, **kw)
    rc_box = []
    t = threading.Thread(
        target=lambda: rc_box.append(daemon.serve_forever()), daemon=True
    )
    t.start()
    try:
        deadline = time.monotonic() + 30
        while client.daemon_alive(sock) is None:
            if time.monotonic() > deadline or not t.is_alive():
                pytest.fail(f"daemon never became ready: {logs}")
            time.sleep(0.02)
        yield sock, daemon, logs
    finally:
        client.request_shutdown(sock)
        t.join(60)
        shutil.rmtree(d, ignore_errors=True)
    assert not t.is_alive(), "daemon thread did not exit"
    assert rc_box == [0], (rc_box, logs)


def package(name):
    """The serving surface of one package, for the differential tests
    that run one scenario through the JAX package (``"jax"``) and
    through this port (``"torch"``): its cli, client, daemon class,
    serve modules and models, plus the daemon keyword arguments that
    put it on the CPU."""
    import types

    if name == "jax":
        from kafkabalancer_tpu import cli as pcli
        from kafkabalancer_tpu import models as pmodels
        from kafkabalancer_tpu import obs as pobs
        from kafkabalancer_tpu.codecs import zookeeper as pzk
        from kafkabalancer_tpu.serve import client as pclient
        from kafkabalancer_tpu.serve import daemon as pdaemon
        from kafkabalancer_tpu.serve import edge_cache as pec
        from kafkabalancer_tpu.serve import sessions as psessions
        from kafkabalancer_tpu.serve import speculate as pspec
        from kafkabalancer_tpu.serve import spill as pspill
        from kafkabalancer_tpu.serve import state as pstate

        daemon_kw = {}
    else:
        from kafkabalancer_tpu_torch import cli as pcli
        from kafkabalancer_tpu_torch import models as pmodels
        from kafkabalancer_tpu_torch import obs as pobs
        from kafkabalancer_tpu_torch.codecs import zookeeper as pzk
        from kafkabalancer_tpu_torch.serve import client as pclient
        from kafkabalancer_tpu_torch.serve import daemon as pdaemon
        from kafkabalancer_tpu_torch.serve import edge_cache as pec
        from kafkabalancer_tpu_torch.serve import sessions as psessions
        from kafkabalancer_tpu_torch.serve import speculate as pspec
        from kafkabalancer_tpu_torch.serve import spill as pspill
        from kafkabalancer_tpu_torch.serve import state as pstate

        daemon_kw = {"devices": ["cpu"]}
    return types.SimpleNamespace(
        name=name, cli=pcli, models=pmodels, obs=pobs, zk=pzk,
        client=pclient, daemon=pdaemon, Daemon=pdaemon.Daemon,
        edge_cache=pec, sessions=psessions, speculate=pspec, spill=pspill,
        state=pstate, daemon_kw=daemon_kw,
    )


def run_pkg(pkg, args, stdin=""):
    """``cli.run`` of ``pkg`` on ``args``: ``(rc, stdout, stderr)``. An
    in-process run of the port (``-no-daemon``) plans on the CPU
    (``device="cpu"``), as the port's daemons in these tests do."""
    import io

    kw = {}
    if pkg.name == "torch" and "-no-daemon" in args:
        kw["device"] = "cpu"
    out, err = io.StringIO(), io.StringIO()
    rc = pkg.cli.run(
        io.StringIO(stdin), out, err, ["kafkabalancer"] + args, **kw
    )
    return rc, out.getvalue(), err.getvalue()


class PkgDaemon:
    """One package's daemon in a thread of this process, restartable on
    the same socket (and spill directory): ``start(**kw)`` returns the
    daemon once it answers hello, ``stop()`` sends the shutdown op and
    checks the thread ended with 0. ``kill()`` ends it WITHOUT the
    shutdown flush (the record on disk is what the continuous spill
    wrote), like a SIGKILL of a daemon process."""

    def __init__(self, pkg, sock, **kw):
        self.pkg, self.sock, self.kw = pkg, sock, kw
        self.d = self.t = self.rc_box = None
        self.logs = []

    def start(self, **kw):
        import threading
        import time

        args = dict(self.pkg.daemon_kw)
        args.update(idle_timeout=120.0, warm=False, log=self.logs.append)
        args.update(self.kw)
        args.update(kw)
        self.d = self.pkg.Daemon(self.sock, **args)
        self.rc_box = []
        d, box = self.d, self.rc_box
        self.t = threading.Thread(
            target=lambda: box.append(d.serve_forever()), daemon=True
        )
        self.t.start()
        deadline = time.monotonic() + 30
        while self.pkg.client.daemon_alive(self.sock) is None:
            if time.monotonic() > deadline or not self.t.is_alive():
                pytest.fail(f"{self.pkg.name} daemon never ready: {self.logs}")
            time.sleep(0.02)
        return self.d

    def stop(self):
        if self.t is None:
            return
        self.pkg.client.request_shutdown(self.sock)
        self.t.join(60)
        assert not self.t.is_alive(), "daemon thread did not exit"
        assert self.rc_box == [0], (self.rc_box, self.logs)
        self.t = None

    def kill(self):
        """Stop without the shutdown flush: the warm tier is detached
        first, so the records on disk are exactly what the continuous
        spill had written, and the directory claim stays behind, as
        after a SIGKILL (the next daemon of this process adopts it)."""
        self.d.spill = None
        self.d.sessions.spill = None
        self.stop()


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX daemon on one CPU device (the suite's conftest makes eight
    virtual ones): one lane, as the port's daemon has on one CPU device."""
    import jax

    devs = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: list(devs))
    yield
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs

    jobs.set_shared_registry(False)
    tobs.set_shared_registry(False)
    # leaving shared mode zeroes the tracing-request count but leaves the
    # tracer as it was: a -metrics-json client that ran in this process
    # while the daemon shared its registry can leave it enabled, and a
    # later test of the same worker would record spans it never asked for
    jobs.TRACER.disable()
    tobs.TRACER.disable()
