"""Device meshes: an explicit ``(sweep, part)`` grid of torch devices.

Counterpart of the reference package's ``parallel/mesh.py``. Every
multi-device path of this package is written against a :class:`Mesh`
with the axes ``("sweep", "part")``: scenario parallelism
(``parallel/sweep.py`` spreads what-if scenarios over ``sweep``) ×
partition sharding (``parallel/shard_session.py`` gives each ``part``
device one block of partition rows). On one device both axes are 1.

One process drives the whole mesh. A device may appear more than once:
``make_mesh(devices=["cpu"] * 8)`` runs an 8-shard session on the CPU,
and ``make_mesh(devices=["cuda:0"] * 4)`` four shards on one card,
through the same code as four cards.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    reference's ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D grid with two axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` through the grid's first row or
        column: the shards of one session (``part``) or the scenario
        groups of a sweep (``sweep``)."""
        i = self.axis_names.index(axis)
        line = self.devices[0, :] if i == 1 else self.devices[:, 0]
        return list(line)

    @property
    def part(self) -> List[torch.device]:
        """One session's shard devices, in row order."""
        return self.axis_devices(PART_AXIS)

    @property
    def lead(self) -> torch.device:
        """The device that holds a session's replicated state."""
        return self.devices[0, 0]

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
    the balanced factorization.
    """
    devs = (
        _visible_devices() if devices is None
        else [torch.device(d) for d in devices]
    )
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
    return Mesh(grid.reshape(shape), axis_names)


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
    more than its own slice. Returns the ``S`` per-shard tensors."""
    a = np.asarray(arr)
    devs = mesh.axis_devices(axis)
    n = _split(a.shape[0], len(devs))
    return [
        torch.from_numpy(np.ascontiguousarray(a[i * n:(i + 1) * n])).to(d)
        for i, d in enumerate(devs)
    ]


def replicate_put(arr: Any, mesh: Mesh) -> List[torch.Tensor]:
    """Upload a host array whole to every ``part`` device — the upload
    twin of :func:`shard_put` for the small vectors every shard reads.
    A device named more than once receives one copy, shared."""
    a = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return to_devices(a, mesh.part)


def to_devices(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t`` on each of ``devices``: one transfer per distinct device."""
    seen: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in seen:
            seen[d] = t.to(d)
        out.append(seen[d])
    return out
