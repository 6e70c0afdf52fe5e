"""Checkpoint and restore of calibrated models.

Counterpart of ``finmath_tpu.utils.serialization``, with the same file
layout: an ``.npz`` holding ``parameters`` (a float64 array) and
``metadata`` (a JSON string). A checkpoint written by either package
loads in the other bit for bit, and revaluation after a round trip is
bit-identical, valuation being a deterministic function of (parameters,
seed, shapes).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np


def save_checkpoint(path: str, parameters: np.ndarray,
                    metadata: Dict[str, Any] = None) -> None:
    """Save a calibrated parameter vector (float64) and JSON-serializable
    metadata; ``np.savez`` appends ``.npz`` to a path without it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        parameters=np.asarray(parameters, dtype=np.float64),
        metadata=json.dumps(metadata or {}),
    )


def load_checkpoint(path: str):
    """Returns (parameters float64 array, metadata dict)."""
    # append .npz as np.savez does on save, not with_suffix, which would
    # replace a dotted name segment ("model.v2" -> "model.npz")
    p = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    with np.load(p, allow_pickle=False) as data:
        params = data["parameters"]
        metadata = json.loads(str(data["metadata"]))
    return params, metadata
