"""The port's client edge cache (kafkabalancer_tpu_torch/serve/edge_cache.py)
against the JAX package's.

Every scenario runs through both packages' caches, each in a socket
directory of its own, and the two traces must be equal with zero
tolerance: the probe's classification (stat hit, stat changed,
unstable), the rung that answered (content hit, row splice, miss), the
digest, canonical rows and per-row hashes — and each answer must equal
the full parse of the same bytes (``state.client_state``). The digest is
what both ends of the wire key on: the daemon's memo key and the
client's cached digest must agree across packages, or every round of
the deployment loop would miss.

End to end, the same outer loop runs through each package's CLI and
daemon with the cache on: per round the rung, the hit flag the client
sends (the daemon's ``client.edge_cache_hit``) and the stdout (equal to
``-no-daemon``) match. A client that used
the cache imports neither torch nor numpy, and neither do the port's
speculation, spill and edge-cache modules.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

from test_torch_cli import FIXTURE, ROOT
from torch_helpers import PkgDaemon, package, run_pkg

TENANT = "tenant-a"
PKGS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _fresh_memory():
    for name in PKGS:
        package(name).edge_cache.reset_memory_layer()
    yield
    for name in PKGS:
        package(name).edge_cache.reset_memory_layer()


def _mk_rows(n, topic_prefix="t"):
    rows = []
    for i in range(n):
        topic = f"{topic_prefix}{i % 7}" if i % 11 else f"tøpic-ü{i % 7}"
        row = {
            "topic": topic,
            "partition": i,
            "replicas": [1 + i % 5, 2 + i % 5, 3 + i % 5],
            "weight": 1.0 + 0.25 * (i % 9),
        }
        if i % 3 == 0:
            row["brokers"] = [1, 2, 3, 4, 5]
        elif i % 3 == 1:
            row["brokers"] = None  # null != absent in canonical bytes
        rows.append(row)
    return rows


def _text(rows):
    return json.dumps({"version": 1, "partitions": rows})


def _write(path, text, backdate_s=5.0):
    """Write the input; a backdated mtime (past the unstable window)
    lets the next persist land a STABLE entry."""
    with open(path, "w") as f:
        f.write(text)
    if backdate_s:
        st = os.stat(path)
        t = st.st_mtime_ns - int(backdate_s * 1e9)
        os.utime(path, ns=(t, t))


class Side:
    """One package's view of a scenario: its cache, a socket path in a
    directory of its own, the input file, and the trace of answers."""

    def __init__(self, name, root):
        self.pkg = package(name)
        self.ec = self.pkg.edge_cache
        self.st = self.pkg.state
        d = os.path.join(root, name)
        os.makedirs(d)
        self.sock = os.path.join(d, "kb.sock")
        self.path = os.path.join(d, "cluster.json")
        self.trace = []

    def full(self, text):
        st = self.st.client_state(text, True, [])
        assert st is not None
        return st

    def seed(self, text, topics=None):
        probe = self.ec.probe_file(self.sock, TENANT, self.path, True,
                                   topics or [])
        assert probe.needs_text
        st = self.full(text)
        self.ec.persist_state(self.sock, TENANT, self.path, True,
                              topics or [], text, st, probe.stat)
        self.trace.append(("seed", st.digest))

    def record(self, what, state, text):
        """Note ``state`` (None = miss) and check it against the full
        parse of ``text``."""
        if state is None:
            self.trace.append((what, None))
            return
        want = self.full(text)
        assert state.digest == want.digest
        assert state.version == want.version
        assert list(state.canon) == list(want.canon)
        assert list(state.row_hashes) == self.st.hashes_of(want.canon)
        assert state.nrows == len(want.canon)
        self.trace.append((what, state.digest, list(state.canon),
                           list(state.row_hashes)))

    def probe(self, text, topics=None, is_json=True):
        p = self.ec.probe_file(self.sock, TENANT, self.path, is_json,
                               topics or [])
        self.trace.append(("probe", p.note, p.hit, p.needs_text))
        if not p.needs_text:
            self.record("stat", p.state, text)
        return p

    def resolve(self, p, text):
        state, hit = self.ec.resolve_text(p, text)
        self.trace.append(("resolve", hit))
        self.record("resolved", state, text)
        return state, hit


@pytest.fixture
def sides():
    root = tempfile.mkdtemp(prefix="kbt-")
    yield [Side(name, root) for name in PKGS]
    shutil.rmtree(root, ignore_errors=True)


def _both(sides, scenario, *args):
    for side in sides:
        scenario(side, *args)
    jx, pt = sides
    assert pt.trace == jx.trace
    return pt.trace


# --- rung 1 and 2 ------------------------------------------------------------


def _stat_hit(side):
    text = _text(_mk_rows(40))
    _write(side.path, text)
    side.seed(text)
    p = side.probe(text)
    assert p.note == "stat_hit" and not p.needs_text
    side.ec.reset_memory_layer()
    p = side.probe(text)
    assert p.note == "stat_hit"


def test_stat_hit_skips_read(sides):
    _both(sides, _stat_hit)


def _promotion(side):
    text = _text(_mk_rows(30))
    _write(side.path, text)
    side.seed(text)
    _write(side.path, text, backdate_s=3.0)
    p = side.probe(text)
    assert p.note == "stat_changed"
    state, hit = side.resolve(p, text)
    assert hit and state is not None
    assert side.probe(text).note == "stat_hit"


def test_content_hit_promotes_to_stat_hit(sides):
    _both(sides, _promotion)


def _identity_mismatch(side):
    text = _text(_mk_rows(12))
    _write(side.path, text)
    side.seed(text)
    assert side.probe(text, topics=["only-this"]).state is None
    assert side.probe(text, is_json=False).state is None


def test_entry_identity_mismatch_is_a_miss(sides):
    _both(sides, _identity_mismatch)


# --- rung 3: the splice ------------------------------------------------------


def _churn_cases():
    def edit_weight(rows):
        rows[7]["weight"] = 123.625

    def edit_replicas(rows):
        rows[3]["replicas"] = list(reversed(rows[3]["replicas"]))

    def add_row_middle(rows):
        rows.insert(11, {"topic": "new-tøpic", "partition": 99,
                         "replicas": [9, 8, 7], "weight": 2.5})

    def add_row_end(rows):
        rows.append({"topic": "zz", "partition": 100,
                     "replicas": [1, 2], "brokers": None})

    def delete_row(rows):
        del rows[5]

    def reorder_rows(rows):
        rows[2], rows[17] = rows[17], rows[2]

    def unicode_edit(rows):
        rows[11]["topic"] = "tøpic-ü-渋谷"

    def brokers_absent_to_null(rows):
        rows[2]["brokers"] = None

    def brokers_null_to_absent(rows):
        del rows[1]["brokers"]

    def one_move(rows):
        rows[13]["replicas"] = [rows[13]["replicas"][0], 9, 10]

    return [
        edit_weight, edit_replicas, add_row_middle, add_row_end,
        delete_row, reorder_rows, unicode_edit,
        brokers_absent_to_null, brokers_null_to_absent, one_move,
    ]


def _splice(side, churn):
    rows = _mk_rows(25)
    text_a = _text(rows)
    _write(side.path, text_a)
    side.seed(text_a)
    churn(rows)
    text_b = _text(rows)
    assert text_b != text_a
    _write(side.path, text_b)
    p = side.probe(text_b)
    assert p.note == "stat_changed"
    state, hit = side.resolve(p, text_b)
    assert state is not None and not hit
    assert side.probe(text_b).note == "stat_hit"


@pytest.mark.parametrize("churn", _churn_cases(), ids=lambda f: f.__name__)
def test_splice_matches_jax_and_the_full_parse(sides, churn):
    _both(sides, _splice, churn)


def _chain(side):
    rows = _mk_rows(25)
    text = _text(rows)
    _write(side.path, text)
    side.seed(text)
    for gen, churn in enumerate(_churn_cases()):
        churn(rows)
        rows[gen % len(rows)]["weight"] = 50.0 + gen
        text = _text(rows)
        _write(side.path, text)
        p = side.probe(text)
        state, _hit = side.resolve(p, text)
        assert state is not None, gen


def test_splice_chain_accumulates_no_drift(sides):
    _both(sides, _chain)


def _same_tick(side):
    rows = _mk_rows(20)
    text_a = _text(rows)
    _write(side.path, text_a, backdate_s=0)
    side.seed(text_a)
    st_a = os.stat(side.path)
    rows[4]["weight"] = 7.5
    text_b = _text(rows)
    assert len(text_b) == len(text_a)
    with open(side.path, "w") as f:
        f.write(text_b)
    os.utime(side.path, ns=(st_a.st_mtime_ns, st_a.st_mtime_ns))
    p = side.probe(text_b)
    assert p.note == "unstable" and p.needs_text and not p.hit
    state, hit = side.resolve(p, text_b)
    assert not hit and state is not None


def test_same_tick_rewrite_never_serves_a_stale_digest(sides):
    _both(sides, _same_tick)


def _pre_stat(side):
    text = _text(_mk_rows(10))
    _write(side.path, text)
    st = side.full(text)
    side.ec.persist_state(side.sock, TENANT, side.path, True, [], text, st,
                          None)
    side.trace.append(os.path.exists(side.ec.entry_path(side.sock, TENANT)))
    pre = side.ec.probe_file(side.sock, TENANT, side.path, True, []).stat
    _write(side.path, _text(_mk_rows(11)), backdate_s=1.0)
    side.ec.persist_state(side.sock, TENANT, side.path, True, [], text, st,
                          pre)
    side.trace.append(os.path.exists(side.ec.entry_path(side.sock, TENANT)))


def test_persist_requires_a_matching_pre_stat(sides):
    assert _both(sides, _pre_stat) == [False, False]


def test_entry_names_match_jax():
    jx, pt = package("jax"), package("torch")
    for tenant in (TENANT, "/a/b/c.json", "zk:localhost:2181", "⚡"):
        assert os.path.basename(pt.edge_cache.entry_path("s", tenant)) == (
            os.path.basename(jx.edge_cache.entry_path("s", tenant)))


# --- damaged entries ---------------------------------------------------------


def _corruptions():
    def truncate_head(buf):
        return buf[:10]

    def truncate_half(buf):
        return buf[: len(buf) // 2]

    def flip_magic(buf):
        return b"XXXX" + buf[4:]

    def flip_header_byte(buf):
        return buf[:16] + bytes([buf[16] ^ 0x5A]) + buf[17:]

    def flip_tail_byte(buf):
        i = len(buf) - 8
        return buf[:i] + bytes([buf[i] ^ 0x5A]) + buf[i + 1:]

    def empty(buf):
        return b""

    return [truncate_head, truncate_half, flip_magic, flip_header_byte,
            flip_tail_byte, empty]


def _poisoned(side, corrupt, n):
    text = _text(_mk_rows(n))
    _write(side.path, text)
    side.seed(text)
    ep = side.ec.entry_path(side.sock, TENANT)
    with open(ep, "rb") as f:
        buf = f.read()
    with open(ep, "wb") as f:
        f.write(corrupt(buf))
    side.ec.reset_memory_layer()
    p = side.probe(text)
    if p.needs_text:
        side.resolve(p, text)


@pytest.mark.parametrize("corrupt", _corruptions(), ids=lambda f: f.__name__)
def test_damaged_entry_degrades_never_lies(sides, corrupt):
    _both(sides, _poisoned, corrupt, 30)


def test_body_damage_behind_an_intact_head_reparses(sides):
    def deep_flip(buf):
        i = len(buf) - 200
        return buf[:i] + bytes([buf[i] ^ 0x5A]) + buf[i + 1:]

    _both(sides, _poisoned, deep_flip, 400)


def test_other_package_entry_is_a_miss(sides):
    """An entry written by the other package (same path shape, other
    version in its fingerprint) never answers."""
    text = _text(_mk_rows(20))
    jx, pt = sides
    for writer, reader in ((jx, pt), (pt, jx)):
        _write(writer.path, text)
        writer.seed(text)
        os.makedirs(os.path.dirname(reader.ec.entry_path(reader.sock, TENANT)),
                    exist_ok=True)
        shutil.copyfile(writer.ec.entry_path(writer.sock, TENANT),
                        reader.ec.entry_path(reader.sock, TENANT))
        shutil.copyfile(writer.path, reader.path)
        st = os.stat(writer.path)
        os.utime(reader.path, ns=(st.st_mtime_ns, st.st_mtime_ns))
        reader.ec.reset_memory_layer()
        p = reader.ec.probe_file(reader.sock, TENANT, reader.path, True, [])
        assert p.needs_text and p.state is None


# --- the -from-zk fast path --------------------------------------------------

ZK_CONN = "localhost:2181"


def _zk_write(root, topic, part_map):
    path = os.path.join(root, "brokers", "topics", topic)
    with open(path, "w") as f:
        json.dump({"version": 1, "partitions": part_map}, f)


def _zk_steps(side, root):
    ec = side.ec
    res = ec.probe_zk(side.sock, ZK_CONN, [])
    side.trace.append(("zk", res.hit, res.changed_topics, res.state.digest,
                       list(res.state.canon)))
    res = ec.probe_zk(side.sock, ZK_CONN, [])
    side.trace.append(("zk", res.hit, res.changed_topics, res.state.digest))
    _zk_write(root, "beta", {"0": [1, 3], "1": [2, 1]})
    res = ec.probe_zk(side.sock, ZK_CONN, [])
    side.trace.append(("zk", res.hit, res.changed_topics, res.state.digest,
                       list(res.state.canon)))
    res = ec.probe_zk(side.sock, ZK_CONN, ["alpha"])
    side.trace.append(("zk-filter", res.hit, res.state.digest))
    os.unlink(os.path.join(root, "brokers", "topics", "gamma"))
    res = ec.probe_zk(side.sock, ZK_CONN, [])
    side.trace.append(("zk-drop", res.hit, res.state.digest,
                       list(res.state.canon)))
    # the digest the daemon would compute from the synthesized JSON
    pl = side.pkg.zk.read_cluster(side.pkg.zk.make_zk_client(ZK_CONN), [])
    canon = [side.st.canonical_row_bytes(*side.st.partition_fields(p))
             for p in pl.iter_partitions()]
    assert res.state.digest == side.st.rows_digest(1, canon)


def test_zk_fast_path_matches_jax(sides, monkeypatch):
    root = tempfile.mkdtemp(prefix="kbt-zk-")
    try:
        os.makedirs(os.path.join(root, "brokers", "topics"))
        monkeypatch.setenv("KAFKABALANCER_TPU_FAKE_ZK", root)
        for side in sides:
            _zk_write(root, "alpha", {"0": [1, 2], "1": [2, 3]})
            _zk_write(root, "beta", {"0": [3, 1]})
            _zk_write(root, "gamma", {"0": [2, 1], "1": [1, 3]})
            _zk_steps(side, root)
        jx, pt = sides
        assert pt.trace == jx.trace
        assert [t[1] for t in pt.trace[:3]] == [False, True, False]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_zk_unreachable_is_none(sides, monkeypatch):
    monkeypatch.setenv("KAFKABALANCER_TPU_FAKE_ZK", "/nonexistent/zk")
    for side in sides:
        assert side.ec.probe_zk(side.sock, ZK_CONN, []) is None


# --- end to end through the CLI and the daemon -------------------------------


def _rung_recorder(pkg, monkeypatch, rungs):
    """Wrap ``pkg``'s probe/resolve so each forwarded invocation notes
    the rung that answered (stat_hit, content_hit, splice or miss);
    returns the list of the hit flags each forward sends."""
    ec = pkg.edge_cache
    probe_file, resolve_text = ec.probe_file, ec.resolve_text

    def probe(*a, **kw):
        p = probe_file(*a, **kw)
        rungs.append("stat_hit" if not p.needs_text else "miss")
        return p

    def resolve(p, text):
        state, hit = resolve_text(p, text)
        if state is not None:
            rungs[-1] = "content_hit" if hit else "splice"
        return state, hit

    monkeypatch.setattr(ec, "probe_file", probe)
    monkeypatch.setattr(ec, "resolve_text", resolve)
    forward_plan = pkg.client.forward_plan

    def forward(*a, **kw):
        # the hit flag the client sends with its trace context (the
        # daemon stamps it as client.edge_cache_hit)
        hits.append(kw["edge"].cache_hit)
        return forward_plan(*a, **kw)

    hits = []
    monkeypatch.setattr(pkg.client, "forward_plan", forward)
    return hits


def _edge_loop(name, root, monkeypatch):
    pkg = package(name)
    d = os.path.join(root, name)
    os.makedirs(d)
    sock = os.path.join(d, "kb.sock")
    src = os.path.join(d, "cluster.json")
    rungs = []
    hits = _rung_recorder(pkg, monkeypatch, rungs)
    runner = PkgDaemon(pkg, sock, speculate=True)
    dmn = runner.start()
    state = json.load(open(FIXTURE))
    args = ["-input-json", f"-input={src}", "-max-reassign=1"]
    trace = []

    def step(text, extra=(), backdate=5.0):
        _write(src, text, backdate_s=backdate)
        want = run_pkg(pkg, args + ["-no-daemon"])
        n = len(rungs)
        got = run_pkg(pkg, args + list(extra) + [f"-serve-socket={sock}"])
        assert got[:2] == want[:2], (name, len(trace))
        trace.append((rungs[n:], hits[-1], got[1]))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = dmn.speculator.stats()
            if st["memos"] >= 1 and not st["inflight"]:
                break
            time.sleep(0.02)
        return got[1]

    def apply(text, out):
        doc = json.loads(text)
        for e in json.loads(out).get("partitions") or []:
            for row in doc["partitions"]:
                if (row["topic"], row["partition"]) == (
                    e["topic"], e["partition"]
                ):
                    row["replicas"] = list(e["replicas"])
        return json.dumps(doc)

    try:
        text = json.dumps(state)
        out = step(text)                    # miss: register
        text = apply(text, out)
        out = step(text)                    # splice: the applied move
        text = apply(text, out)
        step(text)                          # splice again
        step(text, backdate=3.0)            # same bytes, new mtime
        with open(src) as f:
            assert f.read() == text
        out = run_pkg(pkg, args + [f"-serve-socket={sock}"])
        trace.append((rungs[-1:], hits[-1], out[1]))  # the stat hit
        step(text, extra=["-no-edge-cache"])
        spec = dmn.speculator.stats()
        fallbacks = pkg.client.fetch_stats(sock)["fallbacks"]
    finally:
        runner.stop()
    return trace, spec, fallbacks


def test_deployment_loop_rungs_match_jax(monkeypatch):
    root = tempfile.mkdtemp(prefix="kbt-")
    try:
        jx = _edge_loop("jax", root, monkeypatch)
        pt = _edge_loop("torch", root, monkeypatch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert pt == jx
    rungs = [t[0] for t in pt[0]]
    assert rungs == [["miss"], ["splice"], ["splice"], ["content_hit"],
                     ["stat_hit"], []]
    assert [t[1] for t in pt[0]] == [False, False, False, True, True, None]
    assert pt[1]["hits"] >= 2


def test_edge_client_imports_neither_torch_nor_numpy():
    """Two forwarded invocations from a fresh process (a miss that
    persists the entry, then a stat hit): the served plans, the cache
    used, and no torch, numpy or JAX import."""
    from torch_helpers import running_daemon

    with running_daemon() as (sock, d, _logs):
        src = os.path.join(os.path.dirname(sock), "cluster.json")
        _write(src, open(FIXTURE).read())
        code = (
            "import io, sys\n"
            "from kafkabalancer_tpu_torch.cli import run\n"
            "from kafkabalancer_tpu_torch import obs\n"
            "hits = []\n"
            "for _ in range(2):\n"
            "    out = io.StringIO()\n"
            "    rc = run(io.StringIO(), out, io.StringIO(),\n"
            f"             ['kafkabalancer', '-input-json', '-input', {src!r},\n"
            f"              '-serve-socket={sock}'])\n"
            "    assert rc == 0 and out.getvalue(), rc\n"
            "    hits.append(obs.metrics.snapshot()['gauges']\n"
            "                .get('client.edge_cache_hit'))\n"
            "assert hits == [False, True], hits\n"
            "assert 'kafkabalancer_tpu_torch.serve.edge_cache' in sys.modules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('torch', 'numpy', 'jax', 'kafkabalancer_tpu')]\n"
            "assert not bad, bad[:5]\n"
            "print('ok')\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
            proc.stderr)
        assert d._requests == 2


@pytest.mark.parametrize("module", [
    "serve.speculate", "serve.spill", "serve.edge_cache", "serve.client",
    "serve.state",
])
def test_serving_modules_import_neither_torch_nor_numpy(module):
    code = (
        "import sys\n"
        f"import kafkabalancer_tpu_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'numpy', 'jax', 'kafkabalancer_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
