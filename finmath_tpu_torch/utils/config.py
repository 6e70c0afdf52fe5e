"""Device selection.

The reference's device knob is a Java system property whose negative values
wrap from the end of the device list; the JAX package reads it from
``FINMATH_TPU_DEVICE_INDEX``. The port keeps that variable and those
semantics over the CUDA devices that PyTorch sees.
"""

from __future__ import annotations

import os

import torch


def resolve_device_index(index: int, count: int) -> int:
    """``index`` into ``count`` devices; a negative index wraps from the end
    once, and an out-of-range index raises instead of picking another card."""
    resolved = index if index >= 0 else count + index
    if not 0 <= resolved < count:
        raise ValueError(
            f"device index {index} out of range for {count} CUDA devices")
    return resolved


def select_device(index: int | None = None) -> torch.device:
    """The device the port computes on.

    ``index`` (or ``FINMATH_TPU_DEVICE_INDEX`` when ``index`` is None) picks
    a CUDA device, negative values wrapping from the end. With neither set,
    the current CUDA device. There is no quiet fallback: without a CUDA
    device this raises, and a caller that wants the CPU passes
    ``device="cpu"`` to the entry point."""
    if index is None:
        raw = os.environ.get("FINMATH_TPU_DEVICE_INDEX")
        if raw is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is visible; pass device=\"cpu\" "
                    "explicitly to compute on the CPU")
            return torch.device("cuda", torch.cuda.current_device())
        index = int(raw)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", resolve_device_index(index, count))


def rank_device() -> torch.device:
    """The CUDA device of a rank of a meshed computation: ``cuda:{local
    rank}``, the local rank being ``LOCAL_RANK`` from the environment (as
    ``torchrun`` sets it), else the process group's rank modulo the
    visible devices. Raises without a CUDA device, as ``select_device``
    does; a CPU rank passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device=\"cpu\" explicitly to "
            "run a rank on the CPU")
    raw = os.environ.get("LOCAL_RANK")
    if raw is not None:
        local_rank = int(raw)
    else:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        local_rank = rank % torch.cuda.device_count()
    return torch.device(
        "cuda", resolve_device_index(local_rank, torch.cuda.device_count()))


def to_device(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values as a ``dtype`` tensor on ``device``, without waiting for
    the device: on a CUDA device the copy goes from pinned memory and does
    not block (a plain host-to-device copy synchronises the stream, which
    stalls the host behind every queued launch)."""
    t = torch.as_tensor(values, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
