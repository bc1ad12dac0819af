"""Multi-process planning: one mesh over the devices of several processes.

Counterpart of the reference package's ``parallel/distributed.py``.
Once every process has called :func:`initialize`,
:func:`kafkabalancer_tpu_torch.parallel.mesh.make_mesh` builds its grid
from every process's local devices, and the parallel layer's programs
run over it unchanged: the sharded converge session and the sharded
scorer give each process the shards of its own devices and meet in one
combine (``shard_session.gather_pool``), and the sweep spreads its
scenarios over the processes of its ``sweep`` axis and gathers the
results in scenario order. Host orchestration (codecs, repairs, the
acceptance, the move log) is replicated: every process runs it on the
same inputs and holds the same state.

The transport is ``torch.distributed`` with the gloo backend over
host-staged tensors, one code path whatever the devices: what crosses
processes is a few ``[S, K]`` candidate pools per session iteration,
which already ends in a host read, and gloo also runs two processes on
one GPU, which NCCL cannot. Pinned by tests/test_torch_distributed.py
(two CPU processes) and ``chip_smoke.py`` phase 17 (two processes on one
card).
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional, Sequence

# seconds a collective waits for the other processes before it fails
DEFAULT_TIMEOUT_S = 600.0


def _dist() -> Any:
    import torch.distributed as dist

    return dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to a multi-process group (gloo).

    ``coordinator_address`` is ``host:port`` of process 0 (or a URL such
    as ``tcp://host:port``), with ``num_processes`` and this process's
    ``process_id``. Called with no arguments it reads the environment
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as the reference lets a TPU pod discover its own. Call it
    on every process before building a mesh.
    """
    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError("initialize() was already called in this process")
    kw: dict = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is None:
        kw["init_method"] = "env://"
    else:
        kw["init_method"] = (
            coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}"
        )
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group("gloo", **kw)


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multi_host() -> bool:
    """True when the process group spans more than one process."""
    dist = _dist()
    return bool(
        dist.is_available() and dist.is_initialized()
        and dist.get_world_size() > 1
    )


def process_index() -> int:
    """This process's index in the group (0 outside one)."""
    return _dist().get_rank() if is_multi_host() else 0


def process_count() -> int:
    """The number of processes in the group (1 outside one)."""
    return _dist().get_world_size() if is_multi_host() else 1


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's ``obj``, in process order (pickled through gloo)."""
    out: List[Any] = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def all_reduce_sum(t: Any) -> Any:
    """The sum of ``t`` over the processes, on ``t``'s device. Exact for
    the integer-valued counts it carries, in any order."""
    host = t.detach().cpu().contiguous()
    _dist().all_reduce(host)
    return host.to(t.device)


def gather_rows(t: Any, owners: Sequence[int]) -> Any:
    """Assemble a tensor whose rows are spread over the processes.

    ``owners[i]`` is the process that holds global row ``i``; ``t`` is
    this process's rows ``[n_local, ...]`` in global order. Returns the
    ``[len(owners), ...]`` tensor, identical on every process, on
    ``t``'s device. Rows travel through the host, padded to the largest
    process's count."""
    import torch

    dist = _dist()
    n = process_count()
    counts = [sum(1 for o in owners if o == r) for r in range(n)]
    if t.shape[0] != counts[process_index()]:
        raise ValueError(
            f"{t.shape[0]} local rows, the mesh gives this process "
            f"{counts[process_index()]}"
        )
    width = max(counts)
    host = t.detach().cpu()
    if host.shape[0] < width:
        host = torch.cat([host, host.new_zeros((width - host.shape[0],)
                                               + tuple(host.shape[1:]))])
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host.contiguous())
    taken = [0] * n
    rows = []
    for o in owners:
        rows.append(parts[o][taken[o]])
        taken[o] += 1
    return torch.stack(rows).to(t.device)
