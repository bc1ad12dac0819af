"""Zookeeper input codec.

Reference: ``GetPartitionListFromZookeeper`` (codecs.go:95-135), built on the
kazoo-go client. The rebuild parses the connection string itself (so the
error contract is reproducible without a network stack) and performs the
actual reads through the Python ``kazoo`` client when it is importable; when
it is not, connection attempts fail with a codec error (CLI exit code 2),
which preserves the reference's observable behaviour for every tested path
(the happy ZK path is covered via the injectable client seam below —
tests/test_zookeeper.py).

Connection string format (kazoo-go semantics): ``host:port[,host:port...]
[/chroot]``. Every node must be a ``host:port`` pair (Go validates with
``net.SplitHostPort``), which is what makes ``-from-zk=.`` fail with
``failed parsing zk connection string`` (kafkabalancer_test.go:145-154).

Client seams (both jax-free):

- :func:`set_zk_client_factory` installs an in-process fake client
  (tests); the factory receives the kazoo hosts string (chroot
  included) and returns an object with the kazoo surface used here
  (``start``/``stop``/``close``/``get_children``/``get``).
- ``$KAFKABALANCER_TPU_FAKE_ZK=<dir>`` swaps in :class:`FileZkClient`,
  a directory-backed fake (``<dir>/brokers/topics/<topic>`` files hold
  the topic-state JSON) that works ACROSS processes — the replay
  harness and gate.sh drive a real ``-watch`` daemon subprocess
  through it.

The ``-watch`` daemon (serve/speculate.py ``ZkWatcher``) reuses
:func:`make_zk_client` + :func:`read_cluster` with a watch callback:
kazoo-style ``watcher=`` registration where the client supports it,
and the poll interval as the universal fallback.
"""

from __future__ import annotations

import json as _json
import os
from typing import Any, Callable, List, Optional, Tuple

from kafkabalancer_tpu_torch.codecs.readers import CodecError
from kafkabalancer_tpu_torch.models import Partition, PartitionList

WatchFn = Callable[..., None]

# test seam: an installed factory wins over kazoo AND the env fake
_client_factory: Optional[Callable[[str], Any]] = None


def set_zk_client_factory(fn: Optional[Callable[[str], Any]]) -> None:
    """Install (or clear, with None) the in-process ZK client factory.
    The factory receives the kazoo hosts string (chroot appended, the
    exact string a real KazooClient would get) and returns an
    UNSTARTED client object."""
    global _client_factory
    _client_factory = fn


def parse_zk_connection_string(conn: str) -> Tuple[List[Tuple[str, int]], str]:
    """Parse ``host:port,host:port/chroot`` into (nodes, chroot).

    Raises ValueError on malformed input, mirroring kazoo-go's
    ``ParseConnectionString`` (every node must be host:port).
    """
    if conn == "":
        raise ValueError("empty connection string")
    node_part, sep, chroot = conn.partition("/")
    if sep:
        chroot = "/" + chroot
    nodes: List[Tuple[str, int]] = []
    for addr in node_part.split(","):
        host, colon, port_s = addr.rpartition(":")
        if not colon:
            raise ValueError(f"missing port in address {addr!r}")
        if host == "":
            raise ValueError(f"missing host in address {addr!r}")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"invalid port in address {addr!r}") from None
        if not 0 < port < 65536:
            raise ValueError(f"invalid port in address {addr!r}")
        nodes.append((host, port))
    return nodes, chroot


class FileZkClient:
    """The cross-process fake-ZK seam (``$KAFKABALANCER_TPU_FAKE_ZK``):
    znode paths map to files under a root directory —
    ``/brokers/topics/<t>`` reads ``<root>/brokers/topics/<t>``.
    Writers (the replay synthesizer, gate.sh) publish each topic state
    atomically via tmp+rename, so a concurrent read always sees one
    complete JSON document. ``watcher=`` callbacks are accepted and
    ignored (the poll-interval fallback carries watch mode)."""

    def __init__(self, root: str) -> None:
        self.root = root

    def start(self, timeout: float = 10.0) -> None:
        if not os.path.isdir(self.root):
            raise RuntimeError(f"fake zk root {self.root} does not exist")

    def stop(self) -> None:
        return None

    def close(self) -> None:
        return None

    def _fs_path(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def get_children(
        self, path: str, watcher: Optional[WatchFn] = None
    ) -> List[str]:
        return sorted(
            name for name in os.listdir(self._fs_path(path))
            if not name.endswith(".tmp")
        )

    def get(
        self, path: str, watcher: Optional[WatchFn] = None
    ) -> Tuple[bytes, None]:
        with open(self._fs_path(path), "rb") as f:
            return f.read(), None


def _construct_client(hosts: str) -> Any:
    """Build (but do not start) the ZK client for a kazoo hosts string:
    installed factory > ``$KAFKABALANCER_TPU_FAKE_ZK`` file fake >
    the real kazoo client. Raises :class:`CodecError` (the reference's
    exact message) when only kazoo could serve and it is missing."""
    if _client_factory is not None:
        return _client_factory(hosts)
    fake_root = os.environ.get("KAFKABALANCER_TPU_FAKE_ZK", "")
    if fake_root:
        return FileZkClient(fake_root)
    try:
        from kazoo.client import KazooClient  # type: ignore
    except ImportError:
        raise CodecError(
            "failed reading topic list from zk: kazoo client library not available"
        ) from None
    return KazooClient(hosts=hosts, read_only=True)


def make_zk_client(conn: str) -> Any:
    """Parse ``conn``, construct the client through the seams above,
    and START it — the connected-client entry point the ``-watch``
    daemon uses (and re-uses across ticks). Raises :class:`CodecError`
    with the reference's message contract on parse/connect failures."""
    try:
        nodes, chroot = parse_zk_connection_string(conn)
    except ValueError as exc:
        raise CodecError(
            f"failed parsing zk connection string: {exc}"
        ) from None
    hosts = ",".join(f"{h}:{p}" for h, p in nodes) + chroot
    zk = _construct_client(hosts)
    try:
        zk.start(timeout=10)
    except Exception as exc:
        raise CodecError(
            f"failed reading topic list from zk: {exc}"
        ) from None
    return zk


def decode_topic_state(topic: str, data: bytes) -> List[Partition]:
    """Decode one ``/brokers/topics/<topic>`` znode payload
    (``{"version":N,"partitions":{"0":[1,2],...}}``) into partitions,
    ordered by numeric partition id — the watch event decode, shared
    by the one-shot read and the ``-watch`` loop."""
    state = _json.loads(data.decode("utf-8"))
    part_map = state.get("partitions", {})
    return [
        Partition(
            topic=topic,
            partition=int(pid_s),
            replicas=[int(r) for r in part_map[pid_s]],
        )
        for pid_s in sorted(part_map, key=int)
    ]


def _children(
    zk: Any, path: str, watcher: Optional[WatchFn]
) -> List[str]:
    if watcher is None:
        return list(zk.get_children(path))
    try:
        return list(zk.get_children(path, watcher))
    except TypeError:
        # a client without watch support: the caller's poll interval
        # is the fallback
        return list(zk.get_children(path))


def _get(
    zk: Any, path: str, watcher: Optional[WatchFn]
) -> Tuple[bytes, Any]:
    if watcher is None:
        data, stat = zk.get(path)
        return data, stat
    try:
        data, stat = zk.get(path, watcher)
        return data, stat
    except TypeError:
        data, stat = zk.get(path)
        return data, stat


def read_cluster(
    zk: Any,
    topics: Optional[List[str]] = None,
    watcher: Optional[WatchFn] = None,
) -> PartitionList:
    """Walk a STARTED client's ``/brokers/topics`` state into a
    :class:`PartitionList` — the read half shared by the one-shot
    :func:`get_partition_list_from_zookeeper` and the ``-watch`` loop.
    ``watcher`` registers kazoo-style watch callbacks on the children
    list and every topic node when the client supports them (ignored
    otherwise). Error messages preserve the reference contract."""
    topics = topics or []
    try:
        topic_names = _children(zk, "/brokers/topics", watcher)
    except CodecError:
        raise
    except Exception as exc:
        raise CodecError(
            f"failed reading topic list from zk: {exc}"
        ) from None

    pl = PartitionList()
    for topic in sorted(topic_names):
        if topics and topic not in topics:
            continue
        try:
            data, _stat = _get(zk, f"/brokers/topics/{topic}", watcher)
            parts = decode_topic_state(topic, data)
        except Exception as exc:
            raise CodecError(
                f"failed reading partition list for topic {topic} from zk: {exc}"
            ) from None
        for p in parts:
            pl.append(p)
    return pl


def get_partition_list_from_zookeeper(
    conn: str, topics: Optional[List[str]] = None
) -> PartitionList:
    """Read the cluster's partition list from Zookeeper.

    Walks ``/brokers/topics/<topic>`` state the same way the reference walks
    ``zk.Topics()`` -> ``topic.Partitions()`` (codecs.go:104-131), applying
    the topic filter (codecs.go:110-112). ``weight`` / ``num_consumers``
    enrichment is left unset, matching the reference's commented-out TODO
    (codecs.go:128-129).
    """
    zk = make_zk_client(conn)
    try:
        return read_cluster(zk, topics)
    finally:
        try:
            zk.stop()
            zk.close()
        except Exception:
            pass
