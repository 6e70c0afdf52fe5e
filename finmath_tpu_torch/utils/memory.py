"""Device memory introspection.

Counterpart of ``finmath_tpu.utils.memory``. The reference hand-rolls a
device memory pool and polls ``cudaMemGetInfo`` for its free share; under
PyTorch the caching allocator owns buffer lifetime, so what is kept is
the observability: how much the allocator holds, its peak, the card's
size, and a count of the live tensors (a leak canary for tests).
"""

from __future__ import annotations

import gc
import warnings
from dataclasses import dataclass
from typing import Optional

import torch

from .config import select_device


@dataclass
class DeviceMemoryInfo:
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]

    @property
    def free_fraction(self) -> Optional[float]:
        if self.bytes_limit in (None, 0) or self.bytes_in_use is None:
            return None
        return 1.0 - self.bytes_in_use / self.bytes_limit

    def __repr__(self):
        if self.bytes_limit:
            return (f"DeviceMemoryInfo(in_use={self.bytes_in_use/2**20:.1f}MiB, "
                    f"limit={self.bytes_limit/2**20:.1f}MiB, "
                    f"free={100*self.free_fraction:.1f}%)")
        return "DeviceMemoryInfo(unavailable)"


def get_device_memory_info(device=None) -> DeviceMemoryInfo:
    """Memory statistics of ``device`` (default ``select_device()``, which
    raises without a card; a CPU caller passes ``device="cpu"``).

    On a CUDA device, from PyTorch's caching allocator
    (``torch.cuda.memory_stats``) and ``torch.cuda.mem_get_info``:

    * ``bytes_in_use``: the bytes of live tensors this process allocated
      on the device (``allocated_bytes.all.current``), not the blocks the
      allocator caches for reuse;
    * ``peak_bytes_in_use``: the largest ``bytes_in_use`` since the
      process started or ``torch.cuda.reset_peak_memory_stats``;
    * ``bytes_limit``: the card's total memory.

    The allocator's statistics leave out what it does not allocate: the
    CUDA context, the libraries' workspaces and every other process on
    the card, so ``free_fraction`` is an upper bound of what is free.

    On the CPU every field is None, as on the JAX package's virtual CPU
    devices."""
    device = select_device() if device is None else torch.device(device)
    if device.type != "cuda":
        return DeviceMemoryInfo(None, None, None)
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return DeviceMemoryInfo(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        bytes_limit=int(total),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
    )


def live_device_arrays(device=None) -> int:
    """The number of live tensors on ``device`` (default
    ``select_device()``; a CPU caller passes ``device="cpu"``): a leak
    canary for tests.

    PyTorch has no registry of live tensors, so this runs a collection and
    scans the objects the garbage collector tracks, counting the
    ``torch.Tensor`` objects on the device (a CUDA device without an index matches every card).
    Every Python tensor object counts, views included; storage held only
    by C++ (tensors saved for an autograd backward pass, CUDA graph pools,
    the allocator's cache) is not seen."""
    device = select_device() if device is None else torch.device(device)

    def on_device(t: torch.Tensor) -> bool:
        if t.device.type != device.type:
            return False
        return device.index is None or t.device.index == device.index

    gc.collect()        # unreachable tensors in reference cycles go first
    with warnings.catch_warnings():
        # isinstance on some module objects fires deprecation warnings
        warnings.simplefilter("ignore")
        return sum(1 for obj in gc.get_objects()
                   if isinstance(obj, torch.Tensor) and on_device(obj))
