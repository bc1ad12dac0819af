"""Device-memory attribution that never initializes CUDA.

The serving daemon reports per-lane device memory (how many bytes does
the caching allocator hold, and how many are free on the card?) in its
``hello`` and ``stats`` answers. Those answer on connection threads that
may run before the warm thread has touched the card, and a scrape must
never pay (or block on) CUDA's initialization. So
:func:`device_memory_stats` asks only when torch is already imported in
this process AND CUDA is already initialized (``sys.modules`` and
``torch.cuda.is_initialized()``); otherwise, and on a CPU lane, it
returns None.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional


def device_memory_stats(device: Any = None) -> Optional[Dict[str, int]]:
    """Live memory stats of CUDA ``device`` (default: device 0), or None.

    ``bytes_in_use`` is the caching allocator's allocated bytes,
    ``peak_bytes_in_use`` their peak, ``bytes_limit`` the card's total
    memory and ``bytes_free`` the free bytes CUDA reports. None
    means "not knowable right now": torch not imported or CUDA not
    initialized (this function never initializes it), a non-CUDA device,
    or any error. Never raises.
    """
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        dev = torch.device("cuda", 0) if device is None else torch.device(device)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "bytes_free": int(free),
        }
    except Exception:
        return None
