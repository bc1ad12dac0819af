"""Small cells for the CPU tests: the benchmark's cells with their
clusters cut to a size the CPU plans in well under a second."""

from typing import Any, List, Optional

from portbench import run, spec

SEED = 4294967311  # above 2**32, as the driver's seeds are

NAMES = [w["name"] for w in spec.benchmark()["workloads"]]


def cell(name: str, partitions: int = 200, brokers: int = 12,
         clients: int = 3) -> spec.Cell:
    """The cell with a cluster of ``partitions`` on ``brokers``, of which
    the last two were added, and ``clients`` clients."""
    c = spec.Cell(spec.benchmark(), name)
    c.config = dict(c.config, partitions=partitions, brokers=brokers,
                    original_brokers=brokers - 2,
                    topic_partitions=brokers - 2)
    c.traffic = dict(
        c.traffic, clients=clients, fleet=4 * clients, fleet_workers=2,
        check_sample=4,
        daemon_flags=[f"-serve-microbatch={clients}",
                      f"-serve-admission-hold={clients}"])
    return c


def run_tiny(capsys: Any, name: str, seconds: float = 2.0, seed: int = SEED,
             **kw: Any) -> "tuple[int, Optional[dict], List[str]]":
    """Run a tiny cell on the CPU; ``(rc, result line or None, stderr
    lines)``."""
    import json

    import torch

    torch.set_num_threads(1)
    rc = run.run(["--workload", name, "--seed", str(seed), "--seconds",
                  str(seconds), "--trace", "0"], device="cpu",
                 cell=kw.pop("cell", None) or cell(name), **kw)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.splitlines()

