"""Device meshes: an explicit ``(sweep, part)`` grid of torch devices.

Counterpart of the reference package's ``parallel/mesh.py``. Every
multi-device path of this package is written against a :class:`Mesh`
with the axes ``("sweep", "part")``: scenario parallelism
(``parallel/sweep.py`` spreads what-if scenarios over ``sweep``) ×
partition sharding (``parallel/shard_session.py`` gives each ``part``
device one block of partition rows). On one device both axes are 1.

By default one process drives the whole mesh. A device may appear more
than once: ``make_mesh(devices=["cpu"] * 8)`` runs an 8-shard session on
the CPU, and ``make_mesh(devices=["cuda:0"] * 4)`` four shards on one
card, through the same code as four cards.

After :func:`kafkabalancer_tpu_torch.parallel.distributed.initialize`,
``make_mesh`` builds the grid from every process's local devices (its
``devices`` argument, or its visible GPUs), in process order, and each
entry carries the process that owns it (``Mesh.process_index``, the
counterpart of JAX's ``d.process_index``). A process works on its own
entries only: the line of an axis is taken through its first entry
(``axis_devices``), ``local_axis`` lists the entries it owns there, and
``lead`` is the first of them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kafkabalancer_tpu_torch.parallel import distributed

SWEEP_AXIS = "sweep"
PART_AXIS = "part"


def balanced_factors(n: int) -> Tuple[int, int]:
    """Factor ``n`` into ``(a, b)``, ``a*b == n``, as square as possible
    (``a ≤ b``). Prime counts fall back to ``(1, n)``."""
    a = int(math.isqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


class Mesh:
    """A named 2-D grid of torch devices.

    ``devices`` is a numpy object array of ``torch.device`` of shape
    ``(sweep, part)``; ``shape`` maps each axis name to its size, as the
    reference's ``jax.sharding.Mesh.shape`` does. ``process_index`` is
    the grid of the processes that own the entries (all 0 in a mesh of
    one process) and ``rank`` this process's index.
    """

    def __init__(
        self, devices: np.ndarray, axis_names: Sequence[str],
        process_index: Optional[np.ndarray] = None, rank: int = 0,
    ):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D grid with two axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = (
            np.zeros(devices.shape, dtype=int) if process_index is None
            else np.asarray(process_index, dtype=int).reshape(devices.shape)
        )
        self.rank = rank
        mine = np.argwhere(self.process_index == rank)
        if not len(mine):
            raise ValueError(f"process {rank} owns no entry of the mesh")
        # the grid position of this process's first entry: the lines of
        # both axes are taken through it
        self._first = tuple(int(x) for x in mine[0])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _line(self, axis: str) -> Tuple[List[torch.device], List[int]]:
        r, c = self._first
        if self.axis_names.index(axis) == 1:
            return list(self.devices[r, :]), list(self.process_index[r, :])
        return list(self.devices[:, c]), list(self.process_index[:, c])

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` through this process's first entry
        (the grid's first row or column in a mesh of one process): the
        shards of one session (``part``) or the scenario groups of a
        sweep (``sweep``). Entries of other processes are listed too."""
        return self._line(axis)[0]

    def axis_owners(self, axis: str) -> List[int]:
        """The process of each entry of :meth:`axis_devices`."""
        return [int(o) for o in self._line(axis)[1]]

    def local_axis(self, axis: str) -> List[Tuple[int, torch.device]]:
        """``(index along the axis, device)`` of this process's entries
        of :meth:`axis_devices`."""
        devs, owners = self._line(axis)
        return [(i, d) for i, (d, o) in enumerate(zip(devs, owners))
                if o == self.rank]

    def spans_processes(self, axis: str) -> bool:
        """True when the line of ``axis`` holds entries of other
        processes, whose results then cross processes. Such a line must
        hold every process of the group (the collectives run over the
        whole group)."""
        owners = set(self.axis_owners(axis))
        if len(owners) <= 1:
            return False
        if owners != set(range(distributed.process_count())):
            raise ValueError(
                f"the {axis} axis spans processes {sorted(owners)}, not "
                f"the whole group of {distributed.process_count()}"
            )
        return True

    @property
    def part(self) -> List[torch.device]:
        """One session's shard devices, in row order."""
        return self.axis_devices(PART_AXIS)

    @property
    def lead(self) -> torch.device:
        """The device that holds a session's replicated state: this
        process's first entry on the ``part`` line."""
        return self.local_axis(PART_AXIS)[0][1]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _visible_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu', ...] to "
            "build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (SWEEP_AXIS, PART_AXIS),
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """A 2-D ``(sweep, part)`` mesh over the first ``n_devices`` devices.

    ``devices`` defaults to every visible CUDA device (it raises without
    one); a list may name one device more than once. ``shape`` overrides
    the balanced factorization. In a multi-process group (see the module
    docstring) ``devices`` are this process's devices and the grid runs
    over every process's, in process order; every process must call
    ``make_mesh`` with the same ``n_devices`` and ``shape``.
    """
    devs = (
        _visible_devices() if devices is None
        else [torch.device(d) for d in devices]
    )
    owners = [0] * len(devs)
    rank = 0
    if distributed.is_multi_host():
        rank = distributed.process_index()
        every = distributed.all_gather_object([str(d) for d in devs])
        devs = [torch.device(d) for names in every for d in names]
        owners = [r for r, names in enumerate(every) for _ in names]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devs)} available"
        )
    if shape is None:
        shape = balanced_factors(n_devices)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devs[:n_devices]
    return Mesh(
        grid.reshape(shape), axis_names,
        np.asarray(owners[:n_devices]).reshape(shape), rank,
    )


def _split(n: int, parts: int) -> int:
    if n % parts:
        raise ValueError(
            f"leading dimension {n} not divisible by {parts} shards; "
            f"tensorize with min_bucket a multiple of {parts}"
        )
    return n // parts


def shard_put(
    arr: Any, mesh: Mesh, axis: str = PART_AXIS
) -> List[torch.Tensor]:
    """Upload a host array split over ``axis`` on its leading dimension:
    shard ``i`` receives rows ``[i·n/S, (i+1)·n/S)`` straight from the
    host buffer onto the axis' ``i``-th device, so no device ever holds
    more than its own slice. Returns the ``S`` per-shard tensors, with
    ``None`` for the shards of other processes."""
    a = np.asarray(arr)
    devs = mesh.axis_devices(axis)
    n = _split(a.shape[0], len(devs))
    out: List[Optional[torch.Tensor]] = [None] * len(devs)
    for i, d in mesh.local_axis(axis):
        out[i] = torch.from_numpy(
            np.ascontiguousarray(a[i * n:(i + 1) * n])).to(d)
    return out


def replicate_put(arr: Any, mesh: Mesh) -> List[torch.Tensor]:
    """Upload a host array whole to every ``part`` device of this process
    — the upload twin of :func:`shard_put` for the small vectors every
    shard reads. A device named more than once receives one copy,
    shared."""
    a = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return to_devices(a, [d for _, d in mesh.local_axis(PART_AXIS)])


def to_devices(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t`` on each of ``devices``: one transfer per distinct device."""
    seen: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in seen:
            seen[d] = t.to(d)
        out.append(seen[d])
    return out
