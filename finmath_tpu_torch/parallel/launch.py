"""Run one function on every rank of a torch.distributed world of child
processes on this host, and collect what each rank returns.

    from finmath_tpu_torch.parallel.launch import run_world
    results = run_world("my_module:my_rank_fn", 4, backend="gloo",
                        device="cpu", kwargs={"paths": 1600})

Each rank is ``python -m finmath_tpu_torch.parallel.launch`` in a process
of its own. It joins the process group through a ``file://`` store in a
fresh temporary directory, builds its ``PathMesh`` with
``make_path_mesh(world_size, device=...)``, calls ``fn(mesh, **kwargs)``
(``fn`` named by ``"module:function"``, importable from the parent's
``sys.path``) and pickles the return value. The parent waits for every
rank with a deadline; a rank that fails or outlives the deadline ends the
world: the other ranks are killed and ``RankFailure`` carries the tail of
each rank's output. ``start_world`` returns at once, so the parent can work
while the ranks run (``World.join`` waits).

The results are unpickled in the parent: they are written by the ranks
this module started, into the directory it created.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from importlib import import_module
from pathlib import Path
from typing import Optional


# a collective that waits longer than this for another rank fails the rank
COLLECTIVE_TIMEOUT_S = 300.0


class RankFailure(RuntimeError):
    """A rank of a spawned world failed, or the world missed its
    deadline."""


def _tail(path: Path, limit: int = 4000) -> str:
    try:
        text = path.read_text(errors="replace")
    except FileNotFoundError:
        return ""
    return text[-limit:]


class World:
    """The child processes of one spawned world (see ``start_world``)."""

    def __init__(self, directory: Path, procs: list):
        self.directory = directory
        self._procs = procs

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def close(self) -> None:
        """Kill what still runs and remove the world's directory."""
        self._kill()
        shutil.rmtree(self.directory, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def join(self, timeout: float = 300.0) -> list:
        """Wait for every rank (at most ``timeout`` seconds in all) and
        return their results in rank order; on a failure or at the
        deadline kill the rest and raise ``RankFailure``."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self._procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RankFailure(self._report(
                        f"world of {len(self._procs)} ranks missed its "
                        f"{timeout:.0f} s deadline"))
                time.sleep(0.05)
            if bad:
                raise RankFailure(self._report(
                    f"rank(s) {bad} exited with "
                    f"{[codes[r] for r in bad]}"))
            results = []
            for r in range(len(self._procs)):
                with open(self.directory / f"result{r}.pkl", "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            self.close()

    def _report(self, head: str) -> str:
        self._kill()
        lines = [head]
        for r in range(len(self._procs)):
            lines.append(f"--- rank {r} output ---")
            lines.append(_tail(self.directory / f"rank{r}.log"))
        return "\n".join(lines)


def start_world(target: str, world_size: int, *, backend: str = "gloo",
                device=None, kwargs: Optional[dict] = None,
                threads: Optional[int] = None, directory=None) -> World:
    """Start ``world_size`` ranks that each run ``target`` (see the module
    docstring) and return at once. ``device``: every rank's device (a
    string or ``torch.device``; None gives each rank
    ``utils.config.rank_device``); ``threads``: ``torch.set_num_threads``
    in each rank; ``directory``: where the world's temporary directory
    goes (default: the system's; it is removed when the world ends)."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    root = Path(tempfile.mkdtemp(prefix="path_world_", dir=directory))
    spec = dict(target=target, world_size=int(world_size),
                backend=backend,
                device=None if device is None else str(device),
                kwargs=dict(kwargs or {}), threads=threads,
                store=str(root / "store"))
    with open(root / "call.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        os.path.abspath(p) for p in sys.path if isinstance(p, str))
    procs = []
    try:
        for r in range(world_size):
            log = open(root / f"rank{r}.log", "wb")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(root), str(r)],
                    stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, env=env))
            finally:
                log.close()
    except BaseException:
        World(root, procs).close()
        raise
    return World(root, procs)


def run_world(target: str, world_size: int, *, timeout: float = 300.0,
              **options) -> list:
    """``start_world(target, world_size, **options).join(timeout)``."""
    return start_world(target, world_size, **options).join(timeout)


def _rank_main(root: str, rank: int) -> int:
    import torch
    import torch.distributed as dist

    from .mesh import make_path_mesh

    root = Path(root)
    with open(root / "call.pkl", "rb") as f:
        spec = pickle.load(f)
    if spec["threads"] is not None:
        torch.set_num_threads(int(spec["threads"]))
    device = spec["device"]
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        spec["backend"], init_method=f"file://{spec['store']}",
        rank=rank, world_size=spec["world_size"],
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_path_mesh(spec["world_size"], device=device)
        module, name = spec["target"].split(":")
        fn = getattr(import_module(module), name)
        result = fn(mesh, **spec["kwargs"])
        tmp = root / f"result{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, root / f"result{rank}.pkl")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
