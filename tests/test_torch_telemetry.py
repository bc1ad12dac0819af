"""The port's telemetry exporters against the reference's, on the CPU.

- ``obs/export.py``: the renderers of the scrape verbs
  (``render_prometheus``, ``render_serve_stats``) give text byte-equal to
  the reference's on the same stats document — the synthetic documents of
  tests/test_obs.py and tests/test_tenant_obs.py, and a document scraped
  from a running port daemon after served traffic; ``render_stats``,
  ``metrics_payload`` and ``chrome_trace`` give the reference's output on
  the same registry and tracer.
- The CLI's flag trio: ``-metrics-json`` matches the golden schema
  (tests/data/metrics_schema_v1.json) and is the last stdout line with
  ``-``; ``-stats`` writes to stderr; ``-trace`` is valid Chrome trace
  JSON with one track per thread; all three export on exit-3 and exit-4
  paths; none changes the plan bytes.
- Forwarding: ``-metrics-json`` and ``-explain`` travel as absolute paths,
  a served ``-trace`` writes one merged client and daemon document, and
  ``-jax-profile`` (here ``torch.profiler``) never forwards and writes a
  Chrome trace holding the ``plan`` range.
- The scrape verbs ``-serve-stats`` and ``-metrics-prom``: exit 3 with no
  daemon, 4 on an unwritable path, and neither imports torch nor numpy
  (subprocess pin).
"""

import io
import json
import os
import re
import subprocess
import sys

import pytest

from test_obs import GOLDEN
from test_tenant_obs import _tenants_doc

from kafkabalancer_tpu.obs import export as jexport
from kafkabalancer_tpu_torch import cli as tcli
from kafkabalancer_tpu_torch.obs import export as texport
from torch_helpers import running_daemon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "test.json")
METRICS = "kafkabalancer-tpu.metrics/1"


@pytest.fixture(autouse=True)
def tracers_off():
    """Either CLI leaves its process-global tracer enabled after a
    ``-stats``, ``-metrics-json`` or ``-trace`` invocation until its next
    invocation resets it; the other test files of this worker expect it
    off, so each test here ends with both reset."""
    yield
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs

    jobs.begin_invocation()
    tobs.begin_invocation()


def run_cli(args, stdin="", **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = tcli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


def local(args, stdin=""):
    return run_cli(args + ["-no-daemon"], stdin, device="cpu")


# --- the renderers ---------------------------------------------------------

SYNTHETIC_DOCS = {
    "phases": {
        "requests": 3, "uptime_s": 1.5,
        "hists": {
            "serve.phase.parse": {"count": 3, "sum": 0.123456, "p50": 0.01,
                                  "p95": 0.02, "p99": 0.03},
            "serve.request_s": {"count": 3, "sum": 1.5, "p50": 0.4,
                                "p95": 0.6, "p99": 0.7},
        },
    },
    "memory": {
        "pid": 1, "version": "x", "uptime_s": 2.0, "requests": 1,
        "coalesced": 0, "requests_inflight": 0, "slow_requests": 0,
        "crashed_requests": 0, "batch_mode": "continuous",
        "memory": [
            {"lane": 0, "hbm_bytes_in_use": 2_500_000, "hbm_bytes_limit": None,
             "residency_bytes": 1_000_000, "residency_entries": 3},
            {"lane": 1, "hbm_bytes_in_use": None, "hbm_bytes_limit": None,
             "residency_bytes": 0, "residency_entries": 0},
        ],
        "hists": {},
    },
    "tenants": _tenants_doc(),
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC_DOCS))
@pytest.mark.parametrize("render", ["render_prometheus", "render_serve_stats"])
def test_renderers_equal_reference_on_synthetic_docs(name, render):
    doc = SYNTHETIC_DOCS[name]
    assert getattr(texport, render)(doc) == getattr(jexport, render)(doc)


def parse_prom(text):
    """``{series: value}`` of Prometheus text; every line must be a
    comment or ``name{labels} value``."""
    series = {}
    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        assert m, line
        series[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return series


def served_traffic(sock, n):
    for _ in range(n):
        rc, out, err = run_cli(
            ["-input-json", f"-input={FIXTURE}", f"-serve-socket={sock}"]
        )
        assert rc == 0, err


@pytest.mark.parametrize("lanes", [1, 2])
def test_renderers_equal_reference_on_a_live_daemon_doc(lanes):
    from kafkabalancer_tpu_torch.serve import client

    devices = ["cpu"] * lanes
    with running_daemon(devices=devices, lanes=lanes) as (sock, _d, _logs):
        served_traffic(sock, 3)
        doc = client.fetch_stats(sock)
    assert doc["requests"] == 3
    for render in ("render_prometheus", "render_serve_stats"):
        assert getattr(texport, render)(doc) == getattr(jexport, render)(doc)
    series = parse_prom(texport.render_prometheus(doc))
    assert series["kafkabalancer_tpu_requests"] == 3


def test_render_stats_and_payload_equal_reference():
    from kafkabalancer_tpu.obs.metrics import MetricsRegistry as JReg
    from kafkabalancer_tpu.obs.trace import Tracer as JTracer
    from kafkabalancer_tpu_torch.obs.metrics import MetricsRegistry as TReg
    from kafkabalancer_tpu_torch.obs.trace import Tracer as TTracer

    texts = []
    for reg, tracer, exp in ((JReg(), JTracer(), jexport),
                             (TReg(), TTracer(), texport)):
        reg.count("cli.moves", 3)
        reg.gauge("plan.stop_reason", "converged")
        reg.hist_observe("serve.request_s", 0.25)
        reg.hist_observe("serve.request_s", 0.5)
        texts.append(exp.render_stats(reg, tracer, rc=0))
        payload = exp.metrics_payload(reg, tracer, rc=0)
        payload.pop("ts_epoch")
        texts.append(json.dumps(payload, sort_keys=True))
    assert texts[0] == texts[2] and texts[1] == texts[3]


# --- the CLI's flag trio -----------------------------------------------------


def test_metrics_json_schema_golden(tmp_path):
    mpath = tmp_path / "m.json"
    rc, _out, err = local(["-input-json", "-input", FIXTURE,
                           f"-metrics-json={mpath}"])
    assert rc == 0, err
    raw = mpath.read_text()
    assert raw.endswith("\n") and "\n" not in raw[:-1]
    payload = json.loads(raw)
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    assert payload["schema"] == golden["schema"] == METRICS
    assert sorted(payload) == sorted(golden["top_level_keys"])
    for sp in payload["spans"]:
        base = set(golden["span_keys"])
        assert base <= set(sp) <= base | {"attrs"}
    for ev in payload["events"]:
        assert set(golden["event_base_keys"]) <= set(ev)
    names = {s["name"] for s in payload["spans"]}
    assert {"validate_flags", "parse_input", "plan", "emit"} <= names
    assert payload["rc"] == 0
    assert payload["gauges"]["plan.stop_reason"] == "budget_exhausted"


@pytest.mark.parametrize(
    "extra", [[], ["-fused", "-fused-batch=4"], ["-solver=tpu"]],
    ids=["greedy", "fused", "tpu"],
)
def test_metrics_json_dash_is_last_stdout_line(extra):
    rc, out, _err = local(["-input-json", "-input", FIXTURE,
                           "-metrics-json=-"] + extra)
    assert rc == 0
    lines = out.strip().splitlines()
    assert json.loads(lines[0])["version"] == 1
    payload = json.loads(lines[-1])
    assert payload["schema"] == METRICS
    assert payload["counters"]["cli.changes_written"] >= 1


@pytest.mark.parametrize(
    "flags",
    [["-stats"], ["-metrics-json=M"], ["-trace=T"], ["-explain=E"],
     ["-jax-profile=P"]],
    ids=["stats", "metrics", "trace", "explain", "profile"],
)
@pytest.mark.parametrize(
    "extra", [[], ["-fused", "-fused-batch=4", "-max-reassign=20"]],
    ids=["greedy", "fused"],
)
def test_telemetry_flags_change_no_plan_bytes(tmp_path, flags, extra):
    base = ["-input-json", "-input", FIXTURE] + extra
    flags = [f.replace("=M", f"={tmp_path}/m.json")
             .replace("=T", f"={tmp_path}/t.json")
             .replace("=E", f"={tmp_path}/e.json")
             .replace("=P", f"={tmp_path}/prof") for f in flags]
    rc1, out1, _ = local(base)
    rc2, out2, err2 = local(base + flags)
    assert (rc1, out1) == (rc2, out2), err2


def test_stats_summary_goes_to_stderr():
    rc, out, err = local(["-input-json", "-input", FIXTURE, "-stats"])
    assert rc == 0
    assert "invocation telemetry (rc=0)" in err
    assert "parse_input" in err and "emit" in err
    assert "invocation telemetry" not in out


def test_disabled_trio_writes_no_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, _out, _err = local(["-input-json", "-input", FIXTURE])
    assert rc == 0
    assert os.listdir(tmp_path) == []


def chrome_events(path):
    with open(path) as fh:
        doc = json.load(fh)
    return doc["traceEvents"]


def test_trace_is_valid_chrome_trace_one_track_per_thread(tmp_path):
    tpath = tmp_path / "t.json"
    rc, _out, err = local(["-input-json", "-input", FIXTURE, "-fused",
                           "-fused-batch=4", f"-trace={tpath}"])
    assert rc == 0, err
    evs = chrome_events(tpath)
    xs = [ev for ev in evs if ev["ph"] == "X"]
    for ev in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(ev)
        assert ev["ts"] >= 0 and ev["dur"] >= 0
    tids = {ev["tid"] for ev in xs}
    named = {ev["tid"]: ev["args"]["name"] for ev in evs
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert tids <= set(named)
    names = {ev["name"] for ev in xs}
    assert {"settle", "tensorize", "plan", "emit"} <= names
    # the warm thread renders on a track of its own
    warm = [ev for ev in xs if ev["name"] == "coldstart.warm"]
    assert warm and named[warm[0]["tid"]] == "coldstart-warm"
    assert len(tids) >= 2


def test_exit3_error_path_still_exports(tmp_path):
    mpath, tpath = tmp_path / "m.json", tmp_path / "t.json"
    rc, _out, err = local(["-input-json", "-max-reassign=-1",
                           f"-metrics-json={mpath}", f"-trace={tpath}",
                           "-stats"])
    assert rc == 3
    payload = json.loads(mpath.read_text())
    assert payload["rc"] == 3 and payload["schema"] == METRICS
    assert "validate_flags" in {s["name"] for s in payload["spans"]}
    assert chrome_events(tpath)
    assert "invocation telemetry (rc=3)" in err


def test_balance_failure_exit3_still_exports(tmp_path, monkeypatch):
    from kafkabalancer_tpu_torch.solvers import scan

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed: test")

    monkeypatch.setattr(scan, "_run_chunk", broken)
    mpath = tmp_path / "m.json"
    rc, _out, err = local(["-input-json", "-input", FIXTURE, "-fused",
                           "-fused-engine=pallas", f"-metrics-json={mpath}"])
    assert rc == 3, err
    payload = json.loads(mpath.read_text())
    assert payload["rc"] == 3


def test_exit4_error_path_still_exports(tmp_path):
    class Boom(io.StringIO):
        def write(self, s):
            raise OSError("sink failed")

    mpath = tmp_path / "m.json"
    with open(FIXTURE) as fh:
        src = fh.read()
    rc = tcli.run(
        io.StringIO(src), Boom(), io.StringIO(),
        ["kafkabalancer", "-input-json", "-no-daemon",
         f"-metrics-json={mpath}"],
    )
    assert rc == 4
    payload = json.loads(mpath.read_text())
    assert payload["rc"] == 4
    assert "emit" in {s["name"] for s in payload["spans"]}


def test_unwritable_metrics_path_logged_rc_kept(tmp_path):
    rc, out, err = local(["-input-json", "-input", FIXTURE,
                          f"-metrics-json={tmp_path}/no/such/m.json"])
    assert rc == 0
    assert json.loads(out)["version"] == 1
    assert "failed writing metrics JSON" in err


# --- forwarding --------------------------------------------------------------


def test_forward_argv_makes_output_paths_absolute(tmp_path, monkeypatch):
    from kafkabalancer_tpu_torch.serve import client

    seen = []
    real = client.forward_plan

    def spy(sock, argv, *a, **k):
        seen.append(list(argv))
        return real(sock, argv, *a, **k)

    monkeypatch.setattr(client, "forward_plan", spy)
    monkeypatch.chdir(tmp_path)
    with running_daemon() as (sock, _d, _logs):
        rc, out, err = run_cli(
            ["-input-json", f"-input={FIXTURE}", "-metrics-json=m.json",
             "-explain=e.json", f"-serve-socket={sock}"]
        )
    assert rc == 0, err
    assert seen and seen[0][0] == "-no-daemon=true"
    assert f"-metrics-json={tmp_path}/m.json" in seen[0]
    assert f"-explain={tmp_path}/e.json" in seen[0]
    assert json.loads((tmp_path / "m.json").read_text())["schema"] == METRICS
    want = local(["-input-json", f"-input={FIXTURE}"])[1]
    assert out == want


def test_served_trace_is_one_merged_document(tmp_path):
    """A client process forwards with ``-trace`` (the daemon runs in this
    process, whose tracer it resets per request, so the client must be
    a process of its own): one document holds the client's spans and
    the daemon's subtree on a second process track."""
    tpath = tmp_path / "t.json"
    code = (
        "import io, sys\n"
        "from kafkabalancer_tpu_torch.cli import run\n"
        "out, err = io.StringIO(), io.StringIO()\n"
        "rc = run(io.StringIO(''), out, err, ['kafkabalancer'] + sys.argv[1:])\n"
        "assert rc == 0, err.getvalue()\n"
        "print(out.getvalue(), end='')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with running_daemon() as (sock, d, _logs):
        proc = subprocess.run(
            [sys.executable, "-c", code, "-input-json", f"-input={FIXTURE}",
             f"-trace={tpath}", f"-serve-socket={sock}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert d._requests == 1
    assert proc.stdout == local(["-input-json", f"-input={FIXTURE}"])[1]
    with open(tpath) as fh:
        doc = json.load(fh)
    xs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert "serve.forward" in {ev["name"] for ev in xs}  # the client's
    assert "plan" in {ev["name"] for ev in xs
                      if ev.get("args", {}).get("daemon")}
    assert len({ev["pid"] for ev in xs}) == 2
    assert doc["otherData"]["served"] is True


def profile_files(d):
    return [os.path.join(d, f) for f in os.listdir(d)]


@pytest.mark.parametrize(
    "extra", [[], ["-fused", "-fused-batch=4"]], ids=["greedy", "fused"]
)
def test_jax_profile_writes_a_trace_with_the_plan_range(tmp_path, extra):
    pdir = tmp_path / "prof"
    rc, out, err = local(["-input-json", "-input", FIXTURE,
                          f"-jax-profile={pdir}"] + extra)
    assert rc == 0, err
    files = profile_files(pdir)
    assert len(files) == 1 and files[0].endswith(".json")
    evs = chrome_events(files[0])
    assert any(ev.get("name") == "plan" for ev in evs)


def test_jax_profile_never_forwards(tmp_path):
    pdir = tmp_path / "prof"
    with running_daemon() as (sock, d, _logs):
        rc, out, err = run_cli(["-input-json", f"-input={FIXTURE}",
                                f"-jax-profile={pdir}",
                                f"-serve-socket={sock}"])
        assert d._requests == 0  # profiled in this process, not served
    assert rc == 0, err
    assert out == local(["-input-json", f"-input={FIXTURE}"])[1]
    assert len(profile_files(pdir)) == 1


def test_jax_profile_unwritable_directory_exits_4(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    rc, out, err = local(["-input-json", "-input", FIXTURE, "-fused",
                          f"-jax-profile={blocker}/sub"])
    assert rc == 4 and out == ""
    assert "failed creating profile directory" in err


# --- the scrape verbs --------------------------------------------------------


def test_serve_stats_and_metrics_prom_against_a_live_daemon(tmp_path):
    with running_daemon() as (sock, _d, _logs):
        served_traffic(sock, 2)
        rc, out, err = run_cli(["-serve-stats", f"-serve-socket={sock}"])
        assert rc == 0, err
        assert "  requests: 2 " in out
        rc, prom, err = run_cli(["-metrics-prom=-", f"-serve-socket={sock}"])
        assert rc == 0, err
        ppath = tmp_path / "m.prom"
        rc, pout, err = run_cli([f"-metrics-prom={ppath}",
                                 f"-serve-socket={sock}"])
        assert rc == 0 and pout == ""
    series = parse_prom(prom)
    assert series["kafkabalancer_tpu_requests"] == 2
    assert parse_prom(ppath.read_text())["kafkabalancer_tpu_requests"] == 2


@pytest.mark.parametrize("verb", ["-serve-stats", "-metrics-prom=-"])
def test_scrape_verbs_exit_3_without_a_daemon(tmp_path, verb):
    rc, out, err = run_cli([verb, f"-serve-socket={tmp_path}/none.sock"])
    assert rc == 3 and out == ""
    assert "no live daemon" in err


def test_metrics_prom_unwritable_path_exits_4(tmp_path):
    with running_daemon() as (sock, _d, _logs):
        rc, out, err = run_cli([f"-metrics-prom={tmp_path}/no/such/x.prom",
                                f"-serve-socket={sock}"])
    assert rc == 4
    assert "failed writing Prometheus exposition" in err


@pytest.mark.parametrize(
    "flags,says",
    [(["-serve", "-serve-stats"], "cannot be combined with -serve"),
     (["-metrics-prom=-", "-input=x"], "take no input")],
)
def test_scrape_verb_contradictions_exit_3(flags, says):
    rc, _out, err = run_cli(flags)
    assert rc == 3 and says in err


def test_scrape_verbs_import_neither_torch_nor_numpy(tmp_path):
    import tempfile

    d = tempfile.mkdtemp(prefix="kbt-")
    sock = os.path.join(d, "kb.sock")
    code = (
        "import io, sys\n"
        "from kafkabalancer_tpu_torch.cli import run\n"
        f"sock = {sock!r}\n"
        "rcs = []\n"
        "for verb in ('-serve-stats', '-metrics-prom=-',\n"
        f"             '-metrics-prom={tmp_path}/no/such/x.prom'):\n"
        "    out, err = io.StringIO(), io.StringIO()\n"
        "    rcs.append(run(io.StringIO(''), out, err,\n"
        "                   ['kafkabalancer', verb, '-serve-socket=' + sock]))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'numpy', 'jax', 'kafkabalancer_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print(rcs)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with running_daemon() as (live, _d, _logs):
        os.symlink(live, sock)
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120,
        )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[0, 0, 4]"
    # and with no daemon: exit 3, still without the heavy imports
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[3, 3, 3]"
