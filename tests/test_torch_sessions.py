"""Resident cluster sessions of the port's daemon (serve/sessions.py): the
reference's deployment loop — plan one move, apply it to the cluster
file, plan again — served through the protocol-v2 delta ladder.

The pins: over five rounds each served move equals the port's
in-process move and the JAX CLI's on the same file; round 1 registers
the session and every later round is a digest hit (no state shipped);
an external change to the file takes the row re-sync and still plans
right; a released tenant re-registers.
"""

import io
import json
import os
import shutil
import tempfile

import pytest

from kafkabalancer_tpu import cli as jcli
from kafkabalancer_tpu_torch import cli
from kafkabalancer_tpu_torch.codecs import write_partition_list
from kafkabalancer_tpu_torch.serve import client
from kafkabalancer_tpu_torch.serve.sessions import session_from_rows
from kafkabalancer_tpu_torch.utils.synth import synth_cluster
from torch_helpers import running_daemon

ROUNDS = 5
LOOPS = {
    "greedy": ["-input-json"],
    "solver-tpu": ["-input-json", "-solver=tpu"],
    "fused": ["-input-json", "-fused", "-fused-batch=4"],
}


def run_port(args, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.run(io.StringIO(""), out, err, ["kafkabalancer"] + args, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_jax(args):
    out, err = io.StringIO(), io.StringIO()
    rc = jcli.run(io.StringIO(""), out, err, ["kafkabalancer"] + args)
    return rc, out.getvalue()


def apply_plan(path, plan):
    """The outer loop's apply step: every row of the reassignment
    document ``plan`` replaces its partition's replicas in the file."""
    with open(path) as fh:
        doc = json.load(fh)
    rows = {(r["topic"], r["partition"]): r["replicas"]
            for r in json.loads(plan).get("partitions") or []}
    for p in doc["partitions"]:
        key = (p["topic"], p["partition"])
        if key in rows:
            p["replicas"] = rows[key]
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(rows)


@pytest.fixture
def cluster_file():
    d = tempfile.mkdtemp(prefix="kbt-")
    path = os.path.join(d, "cluster.json")
    out = io.StringIO()
    write_partition_list(out, synth_cluster(96, 10, rf=3, seed=7))
    with open(path, "w") as fh:
        fh.write(out.getvalue())
    yield path
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_outer_loop_is_served_from_a_resident_session(cluster_file, loop):
    flags = LOOPS[loop] + [f"-input={cluster_file}"]
    with running_daemon(lanes=0) as (sock, d, _logs):
        for rnd in range(ROUNDS):
            local = run_port(flags + ["-no-daemon"], device="cpu")
            ref = run_jax(flags + ["-no-daemon"])
            before = d._requests
            served = run_port(flags + [f"-serve-socket={sock}"])
            assert d._requests == before + 1, rnd
            assert served[:2] == local[:2] == ref, rnd
            assert served[0] == 0
            assert apply_plan(cluster_file, served[1]) >= 1, rnd
        st = d.sessions.stats()
        assert st["registered"] == 1
        assert st["delta_hits"] == ROUNDS - 1
        assert st["resyncs_rows"] == 0 and st["resyncs_full"] == 0


def test_external_change_takes_the_row_resync(cluster_file):
    flags = ["-input-json", f"-input={cluster_file}"]
    with running_daemon(lanes=0) as (sock, d, _logs):
        run_port(flags + [f"-serve-socket={sock}"])
        # the cluster moved on its own: one partition's replicas rotated
        with open(cluster_file) as fh:
            doc = json.load(fh)
        reps = doc["partitions"][5]["replicas"]
        doc["partitions"][5]["replicas"] = reps[1:] + reps[:1]
        with open(cluster_file, "w") as fh:
            json.dump(doc, fh)
        local = run_port(flags + ["-no-daemon"], device="cpu")
        served = run_port(flags + [f"-serve-socket={sock}"])
        assert served[:2] == local[:2]
        st = d.sessions.stats()
        assert st["resyncs_rows"] == 1 and st["delta_hits"] == 0
        # a released tenant re-registers on its next request
        assert client.release_session(sock, os.path.abspath(cluster_file)) == 1
        served = run_port(flags + [f"-serve-socket={sock}"])
        assert served[:2] == run_port(flags + ["-no-daemon"],
                                      device="cpu")[:2]
        assert d.sessions.stats()["registered"] == 2


def test_no_session_flag_ships_the_cluster_every_time(cluster_file):
    flags = ["-input-json", f"-input={cluster_file}", "-serve-no-session"]
    with running_daemon(lanes=0) as (sock, d, _logs):
        for _ in range(2):
            served = run_port(flags + [f"-serve-socket={sock}"])
            assert served[:2] == run_port(flags + ["-no-daemon"],
                                          device="cpu")[:2]
        assert d.sessions.stats()["registered"] == 0
        assert d._requests == 2


def test_session_from_rows_predicts_the_same_digest(cluster_file):
    from kafkabalancer_tpu_torch.codecs import get_partition_list_from_reader
    from kafkabalancer_tpu_torch.serve import state as sstate
    from kafkabalancer_tpu_torch.serve.sessions import ClusterSession

    with open(cluster_file) as fh:
        text = fh.read()
    pl = get_partition_list_from_reader(io.StringIO(text), True, [])
    sess = ClusterSession("t", "sig")
    sess.snapshot_from(pl)
    rebuilt = session_from_rows(
        "t", "sig", sess.version,
        [sstate.partition_fields(p) for p in sess.raw],
    )
    assert rebuilt.digest == sess.digest
    assert sstate.client_state(text, True, []).digest == sess.digest
