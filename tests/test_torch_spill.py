"""The port's warm session tier (kafkabalancer_tpu_torch/serve/spill.py
and the spill codec of serve/state.py) against the JAX package's.

The pins:

- the codec: the port packs the same rows into the same bytes as the
  JAX package (with the writer fingerprint set equal), both unpack each
  other's bytes to the same rows, and per-row hashes agree;
- the fingerprint: each package's version rides in every record, so a
  record of the other package is refused (``foreign-platform``) and a
  store holding one counts a clean cold miss, in both directions;
- the store: demotion, restore, the byte budget, overwrite accounting,
  the corrupt-record path and release run the same scenario in both
  packages with the same counters (the ``paging`` conservation identity
  ``spills + adopted == restores + corrupt_drops + evictions +
  warm_entries`` holds in each);
- the daemon: the same served scenario (register, delta, shutdown flush,
  restart, restore) through the JAX daemon and the port's daemon on a
  CPU lane prints the same plans, equal to ``-no-daemon``, with the same
  ``paging`` block; a corrupt record and a failed write stay correct;
  a SIGKILLed ``-serve`` process restores from its continuous spill.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import unittest.mock as mock

import pytest

from test_torch_cli import FIXTURE, ROOT
from torch_helpers import PkgDaemon, package, run_pkg

PKGS = ("jax", "torch")


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="kbt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _fields(topic="t", partition=0, replicas=(1, 2), weight=1.0,
            nrep=2, brokers=None, ncons=0):
    return (topic, partition, list(replicas), weight, nrep,
            None if brokers is None else list(brokers), ncons)


ROW_SETS = {
    "edge": [
        _fields(topic="tøpic-ünicode-⚡", partition=3),
        _fields(topic="empty-replicas", replicas=(), nrep=0),
        _fields(topic="max-replicas", replicas=tuple(range(65535))),
        _fields(topic="brokers-none", brokers=None),
        _fields(topic="brokers-empty", brokers=()),
        _fields(topic="brokers-set", brokers=(5, 6, 7)),
        _fields(topic="negative-weight", weight=-2.5, partition=2**40),
    ],
    "plain": [_fields(partition=i) for i in range(8)],
    "weighted": [
        _fields(topic=f"w{i % 3}", partition=i, replicas=(i % 5, 5 + i % 4),
                weight=0.1 * (i + 1), ncons=i % 3, brokers=(0, 1, 2, 5, 6, 7))
        for i in range(40)
    ],
    "empty": [],
}
META = {"tenant": "ten", "sig": "s\x00ig", "digest": "d0", "version": 1}


def _identity(st):
    return st["spills"] + st["adopted"] == (
        st["restores"] + st["corrupt_drops"] + st["evictions"]
        + st["warm_entries"]
    )


def _counts(st):
    return {k: v for k, v in st.items() if k not in ("dir",)}


# --- the codec ---------------------------------------------------------------


@pytest.mark.parametrize("rows", sorted(ROW_SETS))
def test_spill_bytes_equal_across_packages(rows):
    """Same rows, same header, same writer fingerprint: the same bytes;
    and each package unpacks the other's record to the same rows."""
    jx, pt = package("jax"), package("torch")
    data = ROW_SETS[rows]
    with mock.patch.object(jx.state, "spill_platform",
                           pt.state.spill_platform):
        jrec = jx.state.pack_spill_record(META, data)
        jback = jx.state.unpack_spill_record(jrec)
    prec = pt.state.pack_spill_record(META, data)
    assert prec == jrec
    hdr, back = pt.state.unpack_spill_record(prec)
    assert (hdr, back) == jback
    assert back == data
    assert hdr["rows"] == len(data)
    assert hdr["platform"] == pt.state.spill_platform()
    assert jx.state.read_spill_header(jrec) == pt.state.read_spill_header(prec)


@pytest.mark.parametrize("rows", ["edge", "weighted"])
def test_row_hashes_agree(rows):
    jx, pt = package("jax"), package("torch")
    for f in ROW_SETS[rows]:
        assert pt.state.fields_row_hash(f) == jx.state.fields_row_hash(f)


def test_fingerprint_is_the_package_version():
    from kafkabalancer_tpu import __version__ as jver
    from kafkabalancer_tpu_torch import __version__ as pver

    jx, pt = package("jax"), package("torch")
    assert pt.state.spill_platform() == f"{sys.byteorder}:{pver}"
    assert jx.state.spill_platform() == f"{sys.byteorder}:{jver}"
    assert pt.state.spill_platform() != jx.state.spill_platform()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_other_package_record_is_refused(writer, reader):
    w, r = package(writer), package(reader)
    rec = w.state.pack_spill_record(META, ROW_SETS["plain"])
    # the header reads (the index scan attributes it) ...
    assert r.state.read_spill_header(rec)["tenant"] == "ten"
    # ... but the validated read refuses it before any row decode
    with pytest.raises(r.state.SpillCorrupt) as ei:
        r.state.unpack_spill_record(rec)
    assert "foreign-platform" in str(ei.value)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_other_package_store_is_a_counted_cold_miss(tmp_path, writer, reader):
    """A spill directory written by the other package: the reader adopts
    the record by its header, and the restore is a counted corrupt drop
    — a cold miss, never a restore."""
    w, r = package(writer), package(reader)
    d = str(tmp_path / "spill")
    ws = w.spill.SpillStore(d)
    assert ws.open() is None
    assert ws.spill(("ten", "sig"), _mini(w))
    ws.close()
    rs = r.spill.SpillStore(d)
    assert rs.open() is None
    assert rs.stats()["adopted"] == 1
    assert rs.load(("ten", "sig")) is None
    st = rs.stats()
    assert (st["corrupt_drops"], st["restores"], st["warm_entries"]) == (1, 0, 0)
    assert _identity(st)
    rs.close()


@pytest.mark.parametrize("where", ["head", "header", "blob", "checksum"])
def test_truncated_record_raises(where):
    pt = package("torch")
    rec = pt.state.pack_spill_record(META, ROW_SETS["plain"])
    cut = {"head": 3, "header": 20, "blob": len(rec) // 2,
           "checksum": len(rec) - 7}[where]
    with pytest.raises(pt.state.SpillCorrupt):
        pt.state.unpack_spill_record(rec[:cut])


def test_bit_flips_and_version_gates_raise():
    pt = package("torch")
    rec = pt.state.pack_spill_record(META, ROW_SETS["plain"])
    for pos in (6, 15, len(rec) // 2, len(rec) - 40, len(rec) - 1):
        bad = rec[:pos] + bytes([rec[pos] ^ 0x10]) + rec[pos + 1:]
        with pytest.raises(pt.state.SpillCorrupt):
            pt.state.unpack_spill_record(bad)
    with pytest.raises(pt.state.SpillCorrupt):
        pt.state.unpack_spill_record(rec[:4] + (99).to_bytes(4, "big")
                                     + rec[8:])
    with pytest.raises(pt.state.SpillCorrupt):
        pt.state.unpack_spill_record(b"NOPE" + rec[4:])


# --- the store ---------------------------------------------------------------


def _mini(pkg, tenant="ten", sig="sig", n=4):
    from_models = pkg.models
    pl = from_models.PartitionList(version=1, partitions=[
        from_models.Partition(
            topic="t", partition=i, replicas=[1, 2], weight=1.0,
            num_replicas=2, brokers=None, num_consumers=0,
        )
        for i in range(n)
    ])
    sess = pkg.sessions.ClusterSession(tenant, sig)
    sess.snapshot_from(pl)
    return sess


def _demote_restore(pkg, d):
    spill = pkg.spill.SpillStore(d, cap_mb=4)
    assert spill.open() is None
    store = pkg.sessions.SessionStore(cap=1, spill=spill)
    s1, s2 = _mini(pkg, tenant="a"), _mini(pkg, tenant="b")
    store.put(("a", "sig"), s1)
    store.put(("b", "sig"), s2)  # evicts a past cap=1: demoted
    mid = _counts(spill.stats())
    hdr, rows = spill.load(("a", "sig"))
    restored = pkg.sessions.session_from_rows("a", "sig", hdr["version"], rows)
    assert restored.digest == s1.digest
    assert [p.replicas for p in restored.raw] == [p.replicas for p in s1.raw]
    out = (mid, _counts(spill.stats()), store.stats()["evicted_lru"],
           restored.digest, rows)
    spill.close()
    return out


def test_demotion_and_restore_match_across_packages(tmp_path):
    jx = _demote_restore(package("jax"), str(tmp_path / "j"))
    pt = _demote_restore(package("torch"), str(tmp_path / "t"))
    # record sizes differ by the fingerprint's length; everything else
    # is the same
    for doc in (jx[0], jx[1], pt[0], pt[1]):
        doc.pop("warm_bytes")
    assert pt == jx
    assert pt[0]["spills"] == 1 and pt[0]["warm_entries"] == 1
    assert pt[1]["restores"] == 1 and pt[1]["warm_entries"] == 0
    assert _identity(pt[1])


@pytest.mark.parametrize("name", PKGS)
def test_poisoned_session_is_not_spilled(tmp_path, name):
    pkg = package(name)
    spill = pkg.spill.SpillStore(str(tmp_path / "spill"))
    assert spill.open() is None
    sess = _mini(pkg)
    sess.digest = None
    assert spill.spill(("ten", "sig"), sess) is False
    sess.digest = "d"
    sess.released = True
    assert spill.spill(("ten", "sig"), sess) is False
    st = spill.stats()
    assert st["spills"] == 0 and st["write_failures"] == 0
    spill.close()


@pytest.mark.parametrize("name", PKGS)
def test_byte_budget_sweep(tmp_path, name):
    pkg = package(name)
    spill = pkg.spill.SpillStore(str(tmp_path / "spill"), cap_mb=0.002)
    assert spill.open() is None
    for i in range(8):
        spill.spill((f"t{i}", "sig"), _mini(pkg, tenant=f"t{i}", n=8))
    st = spill.stats()
    assert st["warm_bytes"] <= st["cap_bytes"]
    assert st["evictions"] >= 1 and st["spills"] == 8
    assert _identity(st)
    assert spill.load(("t7", "sig")) is not None
    assert spill.load(("t0", "sig")) is None
    spill.close()


def _overwrite(pkg, d):
    spill = pkg.spill.SpillStore(d)
    assert spill.open() is None
    sess = _mini(pkg)
    key = ("ten", "sig")
    assert spill.spill(key, sess)
    assert spill.spill(key, sess)  # same digest: skipped
    first = spill.stats()["spills"]
    sess.raw[0].replicas = [3, 4]
    sess._dirty.add(0)
    sess._refresh_digest()
    assert spill.spill(key, sess)
    st = _counts(spill.stats())
    st.pop("warm_bytes")
    spill.close()
    return first, st, sess.digest


def test_overwrite_accounting_matches_across_packages(tmp_path):
    jx = _overwrite(package("jax"), str(tmp_path / "j"))
    pt = _overwrite(package("torch"), str(tmp_path / "t"))
    assert pt == jx
    first, st, _digest = pt
    assert first == 1 and st["spills"] == 2 and st["evictions"] == 1
    assert _identity(st)


@pytest.mark.parametrize("name", PKGS)
def test_corrupt_record_is_counted_cold_miss(tmp_path, name):
    pkg = package(name)
    spill = pkg.spill.SpillStore(str(tmp_path / "spill"))
    assert spill.open() is None
    key = ("ten", "sig")
    spill.spill(key, _mini(pkg))
    path = os.path.join(spill.dir, pkg.spill.record_name(key))
    buf = bytearray(open(path, "rb").read())
    buf[len(buf) // 2] ^= 0x20
    with open(path, "wb") as f:
        f.write(bytes(buf))
    assert spill.load(key) is None
    st = spill.stats()
    assert st["corrupt_drops"] == 1 and st["restores"] == 0
    assert not os.path.exists(path)
    assert _identity(st)
    spill.close()


def test_record_names_match_across_packages():
    jx, pt = package("jax"), package("torch")
    for key in (("ten", "sig"), ("/a/b.json", "-x=1\x00-y=2"), ("⚡", "")):
        assert pt.spill.record_name(key) == jx.spill.record_name(key)


def test_warm_attribution_and_release(tmp_path):
    pkg = package("torch")
    spill = pkg.spill.SpillStore(str(tmp_path / "spill"))
    assert spill.open() is None
    store = pkg.sessions.SessionStore(cap=1, spill=spill)
    store.put(("cold", "sig"), _mini(pkg, tenant="cold"))
    store.put(("hot", "sig"), _mini(pkg, tenant="hot"))
    by = store.stats_by_tenant()
    assert by["hot"]["sessions"] == 1 and by["hot"]["warm_sessions"] == 0
    assert by["cold"]["sessions"] == 0 and by["cold"]["warm_sessions"] == 1
    assert by["cold"]["warm_bytes"] > 0
    spill.spill(("cold", "sig-b"), _mini(pkg, tenant="cold", sig="sig-b"))
    assert spill.release("cold") == 2
    st = spill.stats()
    assert st["warm_entries"] == 0 and _identity(st)
    spill.close()


def test_spill_dir_claim_rules(tmp_path):
    """A live daemon-like owner is refused; a dead owner's records are
    adopted and its write orphans swept."""
    pkg = package("torch")
    d = str(tmp_path / "spill")
    first = pkg.spill.SpillStore(d)
    assert first.open() is None
    first.spill(("ten", "sig"), _mini(pkg))
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.argv=['kafkabalancer','-serve'];"
         "print('up', flush=True); import time; time.sleep(60)"],
        stdout=subprocess.PIPE,
    )
    try:
        assert child.stdout.readline()
        with open(os.path.join(d, pkg.spill.PIDFILE_NAME), "w") as f:
            f.write(f"{child.pid}\n")
        err = pkg.spill.SpillStore(d).open()
        assert err is not None and "refusing" in err
    finally:
        child.kill()
        child.wait()
        child.stdout.close()
    with open(os.path.join(d, "half-written.kbsp.tmp"), "wb") as f:
        f.write(b"torn")
    third = pkg.spill.SpillStore(d)
    assert third.open() is None
    st = third.stats()
    assert st["adopted"] == 1 and st["warm_entries"] == 1
    assert not os.path.exists(os.path.join(d, "half-written.kbsp.tmp"))
    assert third.load(("ten", "sig")) is not None
    third.close()


# --- the daemon --------------------------------------------------------------


def _apply(state_text, plan_text):
    state = json.loads(state_text)
    for entry in json.loads(plan_text).get("partitions") or []:
        for row in state["partitions"]:
            if (row["topic"], row["partition"]) == (
                entry["topic"], entry["partition"]
            ):
                row["replicas"] = list(entry["replicas"])
                break
    return json.dumps(state)


def _durable_run(name, sock_dir, restart, faults_spec=""):
    """Register + one move through ``name``'s daemon with the warm tier
    on, a restart (``"flush"``: the shutdown op; ``"kill"``: no flush),
    then two more moves; returns the plans, the ``paging`` block and
    the tenant's restore count, each move checked against
    ``-no-daemon``."""
    pkg = package(name)
    sock = os.path.join(sock_dir, f"{name}.sock")
    spill_dir = os.path.join(sock_dir, f"{name}-spill")
    runner = PkgDaemon(pkg, sock, spill_dir=spill_dir, warm_cap_mb=16,
                       speculate=False)
    runner.start(faults_spec=faults_spec)
    state = open(FIXTURE).read()
    args = ["-input-json", "-serve-session=dur-ten", f"-serve-socket={sock}",
            "-max-reassign=1"]
    plans = []
    try:
        for step in range(3):
            want = run_pkg(pkg, ["-input-json", "-max-reassign=1",
                                 "-no-daemon"], stdin=state)
            got = run_pkg(pkg, args, stdin=state)
            assert got[:2] == want[:2], (name, step)
            plans.append(got[1])
            state = _apply(state, got[1])
            if step == 0:
                (runner.kill if restart == "kill" else runner.stop)()
                runner.start()
        doc = pkg.client.fetch_stats(sock)
    finally:
        runner.stop()
    paging = _counts(doc["paging"])
    paging.pop("warm_bytes")
    return plans, paging, doc["tenants"]["top"]["dur-ten"]["restores"]


@pytest.mark.parametrize("restart", ["flush", "kill"])
def test_restart_restores_from_the_warm_tier(sock_dir, restart):
    jx = _durable_run("jax", sock_dir, restart)
    pt = _durable_run("torch", sock_dir, restart)
    assert pt == jx
    _plans, pg, restores = pt
    assert pg["enabled"] is True and pg["restore_hits"] == 1
    assert pg["adopted"] == 1 and restores == 1
    assert _identity(pg)


@pytest.mark.parametrize("spec,want", [
    ("spill_corrupt@1", {"corrupt_drops": 1, "restore_hits": 0}),
    # every write of the first daemon failed: the restart finds nothing
    ("spill_write_fail@1,2,3,4", {"adopted": 0, "restores": 0,
                                  "restore_hits": 0}),
])
def test_bad_spill_stays_correct(sock_dir, spec, want):
    """A bit-flipped record or a failed write: the restart takes the
    cold path (a full re-register), every plan still equals
    ``-no-daemon``, in both packages alike."""
    jx = _durable_run("jax", sock_dir, "flush", faults_spec=spec)
    pt = _durable_run("torch", sock_dir, "flush", faults_spec=spec)
    assert pt == jx
    _plans, pg, _restores = pt
    for k, v in want.items():
        assert pg[k] == v, (k, pg)
    assert _identity(pg)


def test_sigkilled_serve_process_restores(sock_dir):
    """``python -m kafkabalancer_tpu_torch -serve
    -serve-session-spill-dir=D`` serves a request, is SIGKILLed, and a
    new process on the same D answers the next digest-matching request
    from the restored record: the plan of ``-no-daemon``, one restore
    hit, no re-register."""
    pkg = package("torch")
    sock = os.path.join(sock_dir, "p.sock")
    spill_dir = os.path.join(sock_dir, "spill")
    src = os.path.join(sock_dir, "cluster.json")
    shutil.copyfile(FIXTURE, src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def spawn():
        proc = subprocess.Popen(
            [sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
             f"-serve-socket={sock}", f"-serve-session-spill-dir={spill_dir}",
             "-serve-idle-timeout=120"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        deadline = time.monotonic() + 60
        while pkg.client.daemon_alive(sock) is None:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        return proc

    args = ["-input-json", f"-input={src}", "-max-reassign=1",
            f"-serve-socket={sock}", "-no-edge-cache"]
    proc = spawn()
    try:
        rc, out, _ = run_pkg(pkg, args)
        assert rc == 0
        moved = _apply(open(src).read(), out)
        with open(src, "w") as f:
            f.write(moved)
        proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
        proc = spawn()
        want = run_pkg(pkg, ["-input-json", f"-input={src}",
                             "-max-reassign=1", "-no-daemon"])
        got = run_pkg(pkg, args)
        assert got[:2] == want[:2]
        doc = pkg.client.fetch_stats(sock)
        assert doc["paging"]["restore_hits"] == 1
        assert doc["paging"]["adopted"] == 1
        assert doc["sessions"]["registered"] == 0
        assert pkg.client.request_shutdown(sock)
        proc.communicate(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
