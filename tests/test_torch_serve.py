"""The port's planning daemon (kafkabalancer_tpu_torch/serve/) against its
own in-process path and against the JAX package.

The pins:

- lifecycle: handshake, pidfile, idle timeout, a stale socket swept, a
  second daemon refused;
- a SERVED invocation prints the stdout and returns the exit code of the
  port's ``-no-daemon`` run and of the JAX CLI's ``-no-daemon`` run, over
  the golden inputs of tests/test_torch_cli.py, for greedy,
  ``-fused -fused-batch=4`` and ``-fused -fused-engine=pallas`` (the JAX
  CLI's ``pallas-interpret``) on a CPU lane; stderr equals the port's
  in-process stderr modulo log timestamps;
- with no daemon, forwarding falls back in process byte-identical;
- isolation: each package's client refuses the other's daemon and falls
  back, byte-identical to ``-no-daemon``;
- a client whose request was served imports neither torch, numpy nor jax
  (subprocess);
- bad frames get an error frame; the scrape verbs answer; the serving
  and telemetry flags later slices took behave as the reference's beside
  an input.
"""

import io
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from test_torch_cli import FIXTURE, GOLDEN, ROOT

from kafkabalancer_tpu import cli as jcli
from kafkabalancer_tpu.serve import client as jclient
from kafkabalancer_tpu.serve.daemon import Daemon as JDaemon
from kafkabalancer_tpu_torch import __version__, cli
from kafkabalancer_tpu_torch.serve import client, protocol
from kafkabalancer_tpu_torch.serve.daemon import Coalescer, Daemon, PlanRequest
from torch_helpers import running_daemon

# Go-log timestamp prefix on stderr lines ("2025/01/01 00:00:00 ")
_TS = re.compile(r"^\d{4}/\d{2}/\d{2} \d{2}:\d{2}:\d{2} ", re.M)

PATHS = {
    "greedy": ([], []),
    "fused": (["-fused", "-fused-batch=4"], ["-fused", "-fused-batch=4"]),
    # the port's kernel engine on CPU tensors is its plain version, the
    # reference's plain version is its interpret mode (both float32)
    "pallas": (
        ["-fused", "-fused-engine=pallas", "-fused-batch=4"],
        ["-fused", "-fused-engine=pallas-interpret", "-fused-batch=4"],
    ),
}


def run_port(args, stdin="", **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_jax(args, stdin=""):
    out, err = io.StringIO(), io.StringIO()
    rc = jcli.run(io.StringIO(stdin), out, err, ["kafkabalancer"] + args)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cpu_daemon():
    """One CPU-lane daemon with the CLI's defaults (-serve-lanes=0,
    -serve-microbatch=4, which asks for batching) for the module's
    parity tests."""
    with running_daemon(lanes=0, microbatch=4) as (
        sock, d, logs
    ):
        yield sock, d, logs


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="kbt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _start(daemon_obj):
    rc_box = []
    t = threading.Thread(
        target=lambda: rc_box.append(daemon_obj.serve_forever()), daemon=True
    )
    t.start()
    return t, rc_box


def _wait_alive(sock, alive=client.daemon_alive):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        hello = alive(sock)
        if hello is not None:
            return hello
        time.sleep(0.02)
    pytest.fail("daemon never became ready")


# --- protocol and socket naming ----------------------------------------------


def test_socket_path_is_the_ports_own(monkeypatch):
    monkeypatch.setenv(protocol.SOCKET_ENV, "/env/path.sock")
    assert protocol.SOCKET_ENV == "KAFKABALANCER_TPU_TORCH_SOCKET"
    assert protocol.resolve_socket_path("") == "/env/path.sock"
    assert protocol.resolve_socket_path("/flag.sock") == "/flag.sock"
    monkeypatch.delenv(protocol.SOCKET_ENV)
    # the JAX package's variable never steers this package
    monkeypatch.setenv("KAFKABALANCER_TPU_SOCKET", "/jax.sock")
    path = protocol.resolve_socket_path("")
    assert path != "/jax.sock"
    assert os.path.basename(path).startswith("kafkabalancer-tpu-torch-")
    assert __version__.endswith("+torch")


def test_frame_roundtrip_and_limits():
    a, b = socket.socketpair()
    try:
        msg = {"v": 1, "op": "hello", "blob": "x" * 10000}
        protocol.write_frame(a, msg)
        assert protocol.read_frame(b) == msg
        hdr = {"v": 2, "op": "plan"}
        protocol.write_frame2(a, hdr, b"\x00raw")
        assert protocol.read_frame2(b) == (hdr, b"\x00raw")
        a.close()
        assert protocol.read_frame(b) is None
    finally:
        b.close()
    with pytest.raises(ValueError):
        protocol.write_frame(None, {"x": "y" * (protocol.MAX_FRAME_BYTES + 1)})


# --- lifecycle ---------------------------------------------------------------


def test_handshake_pidfile_and_clean_shutdown(sock_dir):
    sock = os.path.join(sock_dir, "kb.sock")
    d = Daemon(sock, idle_timeout=60.0, warm=False, devices=["cpu"],
               log=lambda _m: None)
    t, rc_box = _start(d)
    hello = _wait_alive(sock)
    assert hello["pid"] == os.getpid()
    assert hello["version"] == __version__
    assert hello["requests"] == 0
    with open(protocol.pidfile_path(sock)) as f:
        assert int(f.read().strip()) == os.getpid()
    assert client.request_shutdown(sock)
    t.join(30)
    assert not t.is_alive() and rc_box == [0]
    assert not os.path.exists(sock)
    assert not os.path.exists(protocol.pidfile_path(sock))


def test_idle_timeout_shuts_down(sock_dir):
    sock = os.path.join(sock_dir, "kb.sock")
    d = Daemon(sock, idle_timeout=0.6, warm=False, devices=["cpu"],
               log=lambda _m: None)
    t, rc_box = _start(d)
    t.join(30)
    assert not t.is_alive(), "idle timeout never fired"
    assert rc_box == [0]
    assert not os.path.exists(sock)


def test_stale_socket_is_swept_and_second_daemon_refused(sock_dir):
    sock = os.path.join(sock_dir, "kb.sock")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(sock)
    s.close()  # the file stays, nobody listens
    assert client.daemon_alive(sock) is None
    assert client.forward_plan(sock, ["-no-daemon=true"], "") is None
    logs = []
    d = Daemon(sock, idle_timeout=60.0, warm=False, devices=["cpu"],
               log=logs.append)
    t, rc_box = _start(d)
    try:
        _wait_alive(sock)
        assert any("swept stale socket" in m for m in logs), logs
        d2 = Daemon(sock, idle_timeout=60.0, warm=False, devices=["cpu"],
                    log=lambda _m: None)
        assert d2.serve_forever() == 3
        # the loser did not tear down the winner's socket
        assert client.daemon_alive(sock) is not None
    finally:
        client.request_shutdown(sock)
        t.join(30)
    assert rc_box == [0]


def test_serve_flag_checks():
    rc, _out, err = run_port(["-serve", f"-input={FIXTURE}"])
    assert rc == 3 and "-serve takes no input" in err
    rc, _out, err = run_port(["-serve", "-serve-batch-mode=bogus"])
    assert rc == 3 and "unknown -serve-batch-mode" in err
    rc, _out, err = run_port(["-serve-stats-json", f"-input={FIXTURE}"])
    assert rc == 3 and "take no input" in err


@pytest.mark.parametrize("flag", [
    "-serve-prewarm=1000x10",
    "-serve-stats",
    "-metrics-prom=-",
    "-stats",
    "-metrics-json=-",
    "-trace={out}",
], ids=["-serve-prewarm=1000x10-A8", "-serve-stats-A1", "-metrics-prom=--A1",
        "-stats-A1", "-metrics-json=--A1", "-trace=/x-A1"])
def test_flags_of_later_slices_exit_3(flag, tmp_path):
    """The serving and telemetry flags that later slices (ROADMAP.md A1,
    A8) took behave as the reference's beside an input: the scrape verbs
    exit 3 (they take no input), ``-serve-prewarm`` without ``-serve``
    changes nothing, and the telemetry flags leave the plan's bytes and
    the exit code as they are; ``-trace`` writes a Chrome trace from
    each CLI (each to a file of its own under ``tmp_path``)."""
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs

    argv = ["-input-json", f"-input={FIXTURE}", "-no-daemon"]
    port_trace = tmp_path / "port.json"
    jax_trace = tmp_path / "jax.json"
    try:
        rc, out, err = run_port(argv + [flag.format(out=port_trace)],
                                device="cpu")
        jrc, jout, _jerr = run_jax(argv + [flag.format(out=jax_trace)])
    finally:
        # a telemetry flag leaves each CLI's tracer enabled until its next
        # invocation; the other test files of this worker expect it off
        jobs.begin_invocation()
        tobs.begin_invocation()
    assert rc == jrc, err
    if flag in ("-serve-stats", "-metrics-prom=-"):
        assert rc == 3 and out == "" and "take no input" in err
    else:
        assert rc == 0
        # the plan line; -metrics-json=- appends the (per-process) metrics
        assert out.splitlines()[0] == jout.splitlines()[0]
    if flag.startswith("-trace="):
        for path in (port_trace, jax_trace):
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
            assert any(ev.get("ph") == "X" and ev["name"] == "plan"
                       for ev in events), path


def test_speculation_and_edge_cache_flags_are_accepted(sock_dir, monkeypatch):
    """Each flag takes effect as in the reference: ``-serve`` speculates
    by default and ``-serve-speculate=false`` / ``-serve-speculate-off``
    turn it off (the daemon's ``speculation.enabled``); a forwarded
    client keeps an edge-cache entry beside the socket by default and
    none with ``-no-edge-cache`` / ``-edge-cache=false`` — the answers
    are ``-no-daemon``'s either way."""
    import kafkabalancer_tpu_torch.serve.daemon as dmod

    seen = []
    monkeypatch.setattr(dmod.Daemon, "serve_forever",
                        lambda self: seen.append(self.speculator.enabled) or 0)
    sock = os.path.join(sock_dir, "spec.sock")
    for extra, want_on in (([], True), (["-serve-speculate=false"], False),
                           (["-serve-speculate-off"], False)):
        assert run_port(["-serve", f"-serve-socket={sock}"] + extra)[0] == 0
        assert seen[-1] is want_on, extra
    monkeypatch.undo()
    src = os.path.join(sock_dir, "cluster.json")
    shutil.copyfile(FIXTURE, src)
    want = run_port(["-input-json", f"-input={src}", "-no-daemon"])
    for extra, cached in ((["-no-edge-cache"], False),
                          (["-edge-cache=false"], False), ([], True)):
        with running_daemon() as (sock, _d, _logs):
            got = run_port(["-input-json", f"-input={src}",
                            f"-serve-socket={sock}"] + extra)
            assert got[:2] == want[:2], extra
            entries = (os.listdir(sock + ".edge")
                       if os.path.isdir(sock + ".edge") else [])
            assert bool(entries) is cached, (extra, entries)


def test_batching_flags_take_effect(sock_dir, monkeypatch):
    """-serve-microbatch, -serve-batch-mode and -serve-admission-hold
    configure the daemon exactly as the reference's flags configure its
    daemon (an unknown batch mode exits 3 in both), the client path
    answers ``-no-daemon``'s plan with any of them, and one CPU device
    with -serve-microbatch above 1 keeps the one-lane scheduler, which
    fuses two held same-bucket ``-fused`` requests into one round — as
    the reference's daemon does on one device."""
    import jax

    import kafkabalancer_tpu.serve.daemon as jdmod
    import kafkabalancer_tpu_torch.serve.daemon as dmod
    from kafkabalancer_tpu import obs as jobs
    from kafkabalancer_tpu_torch import obs as tobs
    from kafkabalancer_tpu_torch.serve.lanes import LaneScheduler

    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jdmod), ("torch", dmod)):
        monkeypatch.setattr(
            mod.Daemon, "serve_forever",
            lambda self, name=name: seen[name].append(
                (self.microbatch, self.batch_mode, self.admission_hold)
            ) or 0,
        )
    sock = os.path.join(sock_dir, "flags.sock")
    for extra in ([], ["-serve-microbatch=1"], ["-serve-microbatch=3"],
                  ["-serve-batch-mode=oneshot"], ["-serve-admission-hold=4"],
                  ["-serve-batch-mode=bogus"]):
        argv = ["-serve", f"-serve-socket={sock}"] + extra
        want_rc = 3 if extra and extra[-1].endswith("bogus") else 0
        assert run_port(argv)[0] == run_jax(argv)[0] == want_rc, extra
    assert seen["torch"] == seen["jax"] == [
        (4, "continuous", 0), (1, "continuous", 0), (3, "continuous", 0),
        (4, "oneshot", 0), (4, "continuous", 4),
    ]
    monkeypatch.undo()

    want = run_port(["-input-json", f"-input={FIXTURE}", "-no-daemon"])
    fused = ["-input-json", f"-input={FIXTURE}", "-fused", "-fused-batch=4",
             "-max-reassign=4"]
    want_fused = run_port(fused + ["-no-daemon"], device="cpu")
    jdevs = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: list(jdevs))
    docs = {}
    try:
        for name, make, fetch, run in (
            ("jax", lambda s: JDaemon(s, warm=False, lanes=0, microbatch=4,
                                      admission_hold=2, batch_mode="oneshot",
                                      log=lambda _m: None),
             jclient.fetch_stats, run_jax),
            ("torch", lambda s: Daemon(s, warm=False, lanes=0, microbatch=4,
                                       admission_hold=2,
                                       batch_mode="oneshot",
                                       devices=["cpu"], log=lambda _m: None),
             client.fetch_stats, run_port),
        ):
            s = os.path.join(sock_dir, f"{name}.sock")
            d = make(s)
            t = threading.Thread(target=d.serve_forever, daemon=True)
            t.start()
            deadline = time.monotonic() + 30
            mod = jclient if name == "jax" else client
            while mod.daemon_alive(s) is None:
                assert time.monotonic() < deadline, name
                time.sleep(0.02)
            try:
                if name == "torch":
                    assert isinstance(d._coalescer, LaneScheduler)
                    assert len(d._coalescer.lanes) == 1
                d._coalescer._hold_window_s = 30.0
                for extra in (["-serve-microbatch=1"],
                              ["-serve-batch-mode=oneshot"],
                              ["-serve-admission-hold=4"]):
                    got = run(["-input-json", f"-input={FIXTURE}",
                               f"-serve-socket={s}"] + extra)
                    assert got[:2] == want[:2], (name, extra)
                out = [None, None]

                def one(i, s=s, run=run):
                    out[i] = run(fused + [f"-serve-socket={s}"])

                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(2)]
                for x in threads:
                    x.start()
                for x in threads:
                    x.join(120)
                assert [o[:2] for o in out] == [want_fused[:2]] * 2, name
                docs[name] = fetch(s)
            finally:
                mod.request_shutdown(s)
                t.join(60)
    finally:
        jobs.set_shared_registry(False)
        tobs.set_shared_registry(False)
    for key in ("microbatched", "mb_occupancy", "mb_padded_slots",
                "batch_mode"):
        assert docs["torch"][key] == docs["jax"][key], key
    assert docs["torch"]["microbatched"] == 2
    assert docs["torch"]["mb_occupancy"] == {"2": 1}


# --- served parity -----------------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("idx", range(len(GOLDEN)))
def test_served_matches_in_process_and_reference(cpu_daemon, idx, path):
    sock, d, _logs = cpu_daemon
    argv, stdin = GOLDEN[idx]
    port_flags, jax_flags = PATHS[path]
    before = d._requests
    served = run_port(argv + port_flags + [f"-serve-socket={sock}"], stdin)
    local = run_port(argv + port_flags + ["-no-daemon"], stdin, device="cpu")
    ref = run_jax(argv + jax_flags + ["-no-daemon"], stdin)
    assert served[:2] == local[:2] == ref[:2]
    assert _TS.sub("", served[2]) == _TS.sub("", local[2])
    # a flag error (usage printed) exits before forwarding, and an
    # unreadable input never leaves the client (exit 1 in process);
    # everything else was served
    local_only = ("Usage of" in local[2]
                  or "-input=tests/data/missing.json" in argv)
    assert d._requests == before + (0 if local_only else 1)


def test_concurrent_served_requests_each_get_their_plan(cpu_daemon):
    sock, _d, _logs = cpu_daemon
    want = run_port(["-input-json", f"-input={FIXTURE}", "-fused",
                     "-fused-batch=4", "-no-daemon"], device="cpu")
    results = []

    def one():
        results.append(run_port(["-input-json", f"-input={FIXTURE}", "-fused",
                                 "-fused-batch=4", f"-serve-socket={sock}"]))

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert [r[:2] for r in results] == [want[:2]] * 3


def test_served_fused_without_device_exits_3_like_in_process():
    """A daemon with no device (no card, none given) plans nothing on the
    CPU by itself: -fused exits 3 exactly as the in-process run does."""
    with running_daemon(devices=[], lanes=1) as (sock, d, _logs):
        args = ["-input-json", f"-input={FIXTURE}", "-fused"]
        served = run_port(args + [f"-serve-socket={sock}"])
        local = run_port(args + ["-no-daemon"])
        assert served[0] == local[0] == 3
        assert served[1] == local[1] == ""
        assert _TS.sub("", served[2]) == _TS.sub("", local[2])
        assert d._requests == 1


# --- fallback and isolation --------------------------------------------------


def test_daemon_down_fallback_byte_identical(sock_dir):
    sock = os.path.join(sock_dir, "absent.sock")
    with open(FIXTURE) as fh:
        src = fh.read()
    cases = [
        (["-input-json", f"-input={FIXTURE}"], "", 0),
        (["-input-json"], src, 0),  # stdin read + replay
        (["-input-json"], "::malformed::", 2),
        (["-input-json", f"-input={FIXTURE}", "-broker-ids=x"], "", 3),
        (["-input-json", f"-input={FIXTURE}", "-fused"], "", 3),  # no card
        (["-input-json", "-input=/nonexistent/x.json"], "", 1),
    ]
    for args, stdin, want in cases:
        fwd = run_port(args + [f"-serve-socket={sock}"], stdin)
        local = run_port(args + ["-no-daemon"], stdin)
        assert fwd[0] == local[0] == want, (args, fwd[0], local[0])
        assert fwd[1] == local[1]
        assert _TS.sub("", fwd[2]) == _TS.sub("", local[2])


@pytest.fixture
def jax_daemon(sock_dir):
    sock = os.path.join(sock_dir, "jax.sock")
    d = JDaemon(sock, idle_timeout=60.0, warm=False, log=lambda _m: None)
    t, rc_box = _start(d)
    _wait_alive(sock, jclient.daemon_alive)
    yield sock, d
    jclient.request_shutdown(sock)
    t.join(30)
    assert rc_box == [0]


def test_port_client_refuses_the_jax_daemon(jax_daemon):
    sock, jd = jax_daemon
    assert client.daemon_alive(sock) is None  # version skew
    for args in (["-input-json", f"-input={FIXTURE}"],
                 ["-input-json", f"-input={FIXTURE}", "-fused"]):
        fwd = run_port(args + [f"-serve-socket={sock}"])
        local = run_port(args + ["-no-daemon"])
        assert fwd[:2] == local[:2]
        assert _TS.sub("", fwd[2]) == _TS.sub("", local[2])
    assert jd._requests == 0


def test_jax_client_refuses_the_port_daemon(cpu_daemon):
    sock, d, _logs = cpu_daemon
    assert jclient.daemon_alive(sock) is None
    before = d._requests
    args = ["-input-json", f"-input={FIXTURE}", "-max-reassign=3"]
    fwd = run_jax(args + [f"-serve-socket={sock}"])
    local = run_jax(args + ["-no-daemon"])
    assert fwd[:2] == local[:2]
    assert _TS.sub("", fwd[2]) == _TS.sub("", local[2])
    assert d._requests == before


def test_profiling_and_device_pinned_runs_never_forward(cpu_daemon, sock_dir):
    sock, d, _logs = cpu_daemon
    before = d._requests
    prof = os.path.join(sock_dir, "cpu.pprof")
    rc, _out, _err = run_port(["-input-json", f"-input={FIXTURE}",
                               f"-serve-socket={sock}", "-pprof",
                               f"-pprof-path={prof}"])
    assert rc == 0 and os.path.exists(prof)
    rc, _out, _err = run_port(["-input-json", f"-input={FIXTURE}",
                               f"-serve-socket={sock}"], device="cpu")
    assert rc == 0
    assert d._requests == before


def test_forward_argv_canonicalization(monkeypatch, sock_dir):
    captured = {}

    def fake_forward(sock, argv, stdin_text, **kw):
        captured["argv"] = argv
        captured["stdin"] = stdin_text
        return client.ServedResult(rc=0, stdout="", stderr="")

    monkeypatch.setattr(client, "forward_plan", fake_forward)
    monkeypatch.setattr(client, "socket_exists", lambda _p: True)
    rc, _out, _err = run_port(
        ["-input-json", "-input", FIXTURE, "-max-reassign=3", "-fused",
         "-fused-batch=4", f"-serve-socket={sock_dir}/x.sock",
         "-serve-client-timeout=5", "-no-edge-cache"]
    )
    assert rc == 0
    argv = captured["argv"]
    assert argv[0] == "-no-daemon=true"
    assert not any(a.startswith("-input=") for a in argv)
    with open(FIXTURE) as fh:
        assert captured["stdin"] == fh.read()
    assert {"-max-reassign=3", "-fused=true", "-fused-batch=4"} <= set(argv)
    assert not any(a.startswith(("-serve", "-no-edge")) for a in argv)


def test_client_process_imports_neither_torch_numpy_nor_jax(cpu_daemon):
    sock, d, _logs = cpu_daemon
    before = d._requests
    code = (
        "import io, sys\n"
        "from kafkabalancer_tpu_torch.cli import run\n"
        "out = io.StringIO()\n"
        "rc = run(io.StringIO(), out, io.StringIO(),\n"
        f"         ['kafkabalancer', '-input-json', '-input', {FIXTURE!r},\n"
        f"          '-fused', '-fused-batch=4', '-serve-socket={sock}'])\n"
        "assert rc == 0 and out.getvalue(), rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'numpy', 'jax', 'kafkabalancer_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    assert d._requests == before + 1


# --- the protocol's error paths and scrapes -----------------------------------


def test_bad_frames_get_an_error_frame(cpu_daemon):
    sock, _d, _logs = cpu_daemon

    def exchange(payload):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(30)
        s.connect(sock)
        try:
            s.sendall(payload)
            return protocol.read_frame(s)
        finally:
            s.close()

    resp = exchange(struct.pack(">I", protocol.MAX_FRAME_BYTES + 1))
    assert resp["ok"] is False and resp["op"] == "error"
    assert "exceeds" in resp["error"]
    body = b"\x00not json"
    resp = exchange(struct.pack(">I", len(body)) + body)
    assert resp["ok"] is False and resp["op"] == "error"
    body = json.dumps({"v": protocol.PROTO_VERSION, "op": "plan",
                       "argv": 42}).encode()
    resp = exchange(struct.pack(">I", len(body)) + body)
    assert resp["ok"] is False and "argv" in resp["error"]


def test_scrape_verbs(sock_dir):
    with running_daemon(lanes=0) as (sock, d, _logs):
        _scrape_verbs(sock, d, sock_dir)


def _scrape_verbs(sock, d, sock_dir):
    for _ in range(2):
        run_port(["-input-json", f"-input={FIXTURE}", f"-serve-socket={sock}"])
    rc, out, _err = run_port(["-serve-stats-json", f"-serve-socket={sock}"])
    assert rc == 0
    doc = json.loads(out)
    assert doc["schema"] == protocol.STATS_SCHEMA
    assert doc["version"] == __version__
    assert doc["requests"] == d._requests == 2
    assert doc["hists"]["serve.request_s"]["count"] == 2
    assert doc["speculation"]["enabled"] is False
    assert doc["paging"]["enabled"] is False
    assert doc["crashed_requests"] == 0
    hello = client.daemon_alive(sock)
    assert set(k for k in hello if k not in ("op", "max_v")) <= set(doc)
    path = os.path.join(sock_dir, "flight.json")
    rc, _out, _err = run_port([f"-serve-dump-trace={path}",
                               f"-serve-socket={sock}"])
    assert rc == 0
    with open(path) as fh:
        assert "traceEvents" in json.load(fh)
    absent = os.path.join(sock_dir, "absent.sock")
    rc, _out, err = run_port(["-serve-stats-json", f"-serve-socket={absent}"])
    assert rc == 3 and "no live daemon" in err


def test_coalescer_groups_same_bucket():
    release = threading.Event()
    entered = threading.Event()
    handled = []

    def handle(req, coalesced):
        if req.argv == ["block"]:
            entered.set()
            release.wait(30)
        handled.append((req.argv[0], coalesced))
        req.response = {"ok": True, "id": req.argv[0]}

    buckets = {"block": (1, 1, 1, True), "a1": (8, 2, 4, True),
               "a2": (8, 2, 4, True), "b": (16, 2, 4, False)}
    co = Coalescer(handle, lambda r: buckets[r.argv[0]])
    results = {}

    def submit(name):
        results[name] = co.submit(PlanRequest([name], None))

    threads = [threading.Thread(target=submit, args=("block",))]
    threads[0].start()
    assert entered.wait(30)
    for name in ("a1", "a2", "b"):
        threads.append(threading.Thread(target=submit, args=(name,)))
        threads[-1].start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and len(co._dq) < 3:
        time.sleep(0.01)
    assert len(co._dq) == 3
    release.set()
    for t in threads:
        t.join(30)
    co.stop()
    assert {r["id"] for r in results.values()} == {"block", "a1", "a2", "b"}
    flags = dict(handled)
    assert flags["block"] is False
    assert [flags["a1"], flags["a2"]].count(True) == 1
    assert flags["b"] is False


def test_shutdown_restores_process_globals():
    from kafkabalancer_tpu_torch import obs
    from kafkabalancer_tpu_torch.ops.tensorize import row_cache
    from kafkabalancer_tpu_torch.serve import faults

    with running_daemon(devices=["cpu", "cpu"], lanes=0,
                        faults_spec="dispatch_delay@99") as (_s, _d, _l):
        assert faults.active() is not None
        assert obs.shared_registry()
        assert obs.tracer._observer is not None
    assert faults.active() is None
    assert not obs.shared_registry()
    assert obs.tracer._observer is None
    assert row_cache() is None


def test_serve_flag_starts_a_daemon_process(sock_dir):
    """``python -m kafkabalancer_tpu_torch -serve`` on a host without a
    card: it serves greedy plans (host work) and answers -fused with the
    in-process exit 3; the shutdown op ends it with 0."""
    sock = os.path.join(sock_dir, "cli.sock")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafkabalancer_tpu_torch", "-serve",
         f"-serve-socket={sock}", "-serve-idle-timeout=120",
         "-serve-speculate-off"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        hello = _wait_alive(sock)
        assert hello["pid"] == proc.pid
        args = ["-input-json", f"-input={FIXTURE}"]
        served = run_port(args + [f"-serve-socket={sock}"])
        assert served[:2] == run_port(args + ["-no-daemon"])[:2]
        served = run_port(args + ["-fused", f"-serve-socket={sock}"])
        local = run_port(args + ["-fused", "-no-daemon"])
        assert served[:2] == local[:2] and served[0] == 3
        stats = client.fetch_stats(sock)
        assert stats["requests"] == 2
        assert client.request_shutdown(sock)
        _out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "serve: listening on" in err and "exiting after 2 requests" in err
    assert "speculative plan-ahead" not in err
