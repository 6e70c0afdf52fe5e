"""Multi-process scaling: the Monte-Carlo path axis over torch.distributed
ranks.

Counterpart of ``finmath_tpu.parallel.mesh``. The JAX package is one
controller over many devices: ``shard_map`` splits the path axis and
``psum`` sums over it. torch.distributed is many controllers: every rank
runs the same Python on its own device, holds one block of the path axis,
and calls each collective explicitly. NCCL carries the collectives between
CUDA devices, gloo between CPU processes; gloo with a CUDA tensor stages it
through host memory, which also lets several ranks share one card (NCCL
refuses two ranks on one GPU).

The SPMD contract: every rank makes the same calls with the same
arguments, and every public result is the same on every rank. Argument
checks run before the first collective, so that no rank raises while
another waits in one.

Autograd. ``sum_over_ranks`` all-reduces in its forward pass and passes the
cotangent through unchanged in its backward pass, and ``replicated``
(identity forward) all-reduces the gradient of a replicated input: they
are the transposes of each other, as ``psum`` and the replicated-to-varying
cast are in JAX. A replicated leaf that enters the local computation through
``replicated`` and leaves it through ``sum_over_ranks`` gets the full
gradient on every rank. Neither may run under ``torch.func`` transforms or
``forward_ad``: an in-place ``all_reduce`` there reduces the primal and
leaves the tangent local, silently. Both are custom autograd functions with
no forward-mode or batching rule, so such a use raises. Forward-mode
Jacobians reduce outside the transform instead (the LMM engine's
``jacobian``: the Jacobian of the local path sums, one all-reduce of sums
and Jacobian together, then the chain rule through the replicated rest).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.config import rank_device, select_device

FLOAT_DTYPE = torch.float32
ACC_DTYPE = torch.float64

_MASK64 = (1 << 64) - 1

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own stream: output number ``rank + 1``
    of SplitMix64 started at ``seed``, with its top bit cleared. Distinct
    for distinct ranks and deterministic, the counterpart of JAX's
    ``fold_in(PRNGKey(seed), axis_index)``."""
    z = (int(seed) + (int(rank) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class PathMesh:
    """The path axis split over the ranks of a process group: this rank,
    the world size, this rank's device and the backend. Rank r holds the
    contiguous block ``[r * n, (r + 1) * n)`` of an axis of ``W * n``
    paths (JAX's ``P(None, None, axis)`` layout).

    ``calls`` and ``seconds`` count this rank's collectives and the host
    time spent in them (on a CUDA device the device is synchronised before
    and after each one, so the time is the collective's and the wait for
    the other ranks, not the local work queued before it)."""

    def __init__(self, group, rank: int, world_size: int,
                 device: torch.device, backend: str):
        self.group = group
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = str(backend)
        self.calls = 0
        self.seconds = 0.0

    def __repr__(self) -> str:
        return (f"PathMesh(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device}, backend={self.backend!r})")

    # -- the path blocks ----------------------------------------------------
    def local_count(self, total: int, what: str = "num_paths") -> int:
        """This rank's share of ``total`` paths; an indivisible total
        raises ``ValueError`` (on every rank alike)."""
        total = int(total)
        if total % self.world_size:
            raise ValueError(f"{what} {total} not divisible by the mesh "
                             f"size {self.world_size}")
        return total // self.world_size

    def local_slice(self, total: int, what: str = "num_paths") -> slice:
        """This rank's block of a ``total``-path axis."""
        n = self.local_count(total, what)
        return slice(self.rank * n, (self.rank + 1) * n)

    # -- collectives (out of place, no autograd) ----------------------------
    def _collective(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn`` on a copy of ``x`` (in host memory for gloo and a CUDA
        tensor), its result back on ``x``'s device; counted and timed."""
        staged = self.backend == "gloo" and x.is_cuda
        buf = (x.detach().to("cpu", copy=True) if staged
               else x.detach().clone()).contiguous()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(buf)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out.to(x.device) if staged else out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "min" or "max") of ``x`` over the ranks, as a new
        tensor on ``x``'s device; ``x`` is left as it is."""
        def reduce(b):
            dist.all_reduce(b, op=_OPS[op], group=self.group)
            return b
        return self._collective(reduce, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last axis in rank
        order (the path order of the blocks)."""
        def gather(b):
            parts = [torch.empty_like(b) for _ in range(self.world_size)]
            dist.all_gather(parts, b, group=self.group)
            return torch.cat(parts, dim=-1)
        return self._collective(gather, x)


def check_mesh(mesh) -> Optional[PathMesh]:
    """``mesh`` itself when it is None or a ``PathMesh``; any other object
    (a JAX ``Mesh``, say) raises ``NotImplementedError``: path-axis
    sharding in this package runs over torch.distributed ranks only."""
    if mesh is None or isinstance(mesh, PathMesh):
        return mesh
    raise NotImplementedError(
        f"mesh={type(mesh).__name__}: path-axis sharding over "
        "torch.distributed takes a PathMesh (make_path_mesh)")


def make_path_mesh(num_ranks: Optional[int] = None, *,
                   device=None) -> PathMesh:
    """A ``PathMesh`` over the initialized default process group.

    Fails loudly, as the JAX ``make_path_mesh`` does, instead of running
    on something smaller or elsewhere: without an initialized group, when
    the world size is not ``num_ranks``, when ``device`` is a CUDA device
    and CUDA is not available, when NCCL is asked to reach the CPU, and for
    a backend other than NCCL and gloo. ``device`` defaults to the rank's
    CUDA device (``utils.config.rank_device``); there is no CPU
    fallback."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_path_mesh needs an initialized torch.distributed process "
            "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if num_ranks is not None and int(num_ranks) != world:
        raise ValueError(f"need {num_ranks} ranks, the process group has "
                         f"{world}")
    backend = str(dist.get_backend()).lower()
    if device is None:
        device = rank_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device}: CUDA is not available")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend cannot reach device {device}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: NCCL or gloo")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {device}: CUDA or CPU")
    return PathMesh(dist.group.WORLD, dist.get_rank(), world, device,
                    backend)


# ---------------------------------------------------------------------------
# the two collective helpers of the autograd design (module docstring)
# ---------------------------------------------------------------------------

class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        # the cotangent of a replicated result is replicated already
        return grad, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad), None


def sum_over_ranks(x: torch.Tensor, mesh: PathMesh) -> torch.Tensor:
    """The sum of every rank's ``x``; reverse mode passes the cotangent
    through (each rank's local part receives the replicated cotangent)."""
    return _SumOverRanks.apply(x, mesh)


def replicated(x: torch.Tensor, mesh: PathMesh) -> torch.Tensor:
    """``x``, a value equal on every rank, entering this rank's local
    computation: its gradient is all-reduced in reverse mode, so it holds
    every rank's contribution."""
    return _Replicated.apply(x, mesh)


# ---------------------------------------------------------------------------
# the path-axis helpers of the sharded engines: each takes ``mesh=None``
# for the unsharded engine and then does exactly what the engine did alone
# ---------------------------------------------------------------------------

def mesh_device(mesh: Optional[PathMesh], device=None) -> torch.device:
    """An engine's device: the mesh's under a mesh (another ``device``
    raises ``ValueError``), else ``device`` or ``select_device()``."""
    if mesh is None:
        return torch.device(device) if device is not None \
            else select_device()
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    return mesh.device


def path_block(x: torch.Tensor, mesh: Optional[PathMesh],
               what: str = "num_paths") -> torch.Tensor:
    """This rank's block of ``x``, a global tensor whose last axis is the
    path axis (an indivisible path count raises ``ValueError``), as a
    tensor of its own, so the global one can be freed; ``x`` itself
    without a mesh. The engines that promise the unmeshed stream draw the
    global block on every rank, mirror it when antithetic, and keep
    this."""
    if mesh is None:
        return x
    return x[..., mesh.local_slice(x.shape[-1], what)].clone(
        memory_format=torch.contiguous_format)


def gather_paths(x: torch.Tensor, mesh: Optional[PathMesh]) -> torch.Tensor:
    """The whole ensemble: every rank's block of ``x`` along its last axis,
    in rank order (``x`` itself without a mesh). On the same paths it is
    the unsharded engine's array."""
    return x if mesh is None else mesh.all_gather(x)


def path_means(xs, mesh: Optional[PathMesh], dim: int = -1) -> list:
    """The means of the tensors ``xs`` over their path axis ``dim``, every
    rank's paths counted: without a mesh ``torch.mean``; under one each
    tensor's float64 sum over this rank's block, one all-reduce for all of
    them (``sum_over_ranks``: reverse mode passes through), divided by the
    global count and cast back to the tensor's dtype. Never a mean of the
    ranks' means."""
    if mesh is None:
        return [torch.mean(x, dim=dim) for x in xs]
    sums = [torch.sum(x, dim=dim, dtype=ACC_DTYPE) for x in xs]
    total = sum_over_ranks(torch.cat([s.reshape(-1) for s in sums]), mesh)
    out, start = [], 0
    for x, s in zip(xs, sums):
        part = total[start:start + s.numel()].reshape(s.shape)
        start += s.numel()
        out.append((part / (x.shape[dim] * mesh.world_size)).to(x.dtype))
    return out


def path_mean(x: torch.Tensor, mesh: Optional[PathMesh],
              dim: int = -1) -> torch.Tensor:
    """``path_means([x], mesh, dim)[0]``."""
    return path_means([x], mesh, dim)[0]


def path_sum(x: torch.Tensor, mesh: Optional[PathMesh],
             dim: int = -1) -> torch.Tensor:
    """The sum of ``x`` over its path axis ``dim`` and every rank's block
    (``torch.sum`` without a mesh; a float64 sum and one all-reduce under
    one, cast back to ``x``'s dtype)."""
    if mesh is None:
        return torch.sum(x, dim=dim)
    return sum_over_ranks(torch.sum(x, dim=dim, dtype=ACC_DTYPE),
                          mesh).to(x.dtype)


def path_mean_and_stderr(x: torch.Tensor, mesh: Optional[PathMesh],
                         dim: int = -1):
    """(mean, standard error) over the path axis ``dim`` from the first two
    moments, ``sqrt(max(E[x^2] - E[x]^2, 0) / n)`` with n every rank's
    paths: both moments in one ``path_means``."""
    n = x.shape[dim] * (1 if mesh is None else mesh.world_size)
    m, m2 = path_means([x, x * x], mesh, dim)
    return m, torch.sqrt(torch.clamp_min(m2 - m * m, 0.0) / n)


# ---------------------------------------------------------------------------
# the JAX module's two sharded computations
# ---------------------------------------------------------------------------

def sharded_mean(mesh: PathMesh):
    """A function of this rank's block of a path vector that returns the
    float64-accumulated mean over every rank's block (the multi-rank
    ``getAverage``): a local float64 sum and count, one all-reduce."""
    def mean(x: torch.Tensor) -> float:
        x = torch.as_tensor(x)
        local = torch.stack([
            torch.sum(x.to(ACC_DTYPE)),
            torch.tensor(float(x.numel()), dtype=ACC_DTYPE,
                         device=x.device)])
        total, count = mesh.all_reduce(local).tolist()
        return total / count
    return mean


def mc_price_sharded(mesh: PathMesh, seed: int, total_paths: int,
                     num_steps: int, s0: float, r: float, sigma,
                     maturity: float, strike: float) -> torch.Tensor:
    """European-call Monte-Carlo price with the paths split over the ranks.

    Each rank draws its own block of ``total_paths / W`` paths from a
    generator seeded with ``rank_seed(seed, rank)``, simulates it in
    float32 on its device, and the expectation is one float64 all-reduce.
    ``sigma`` may be a float64 tensor that requires grad: the price (a
    0-dim float64 tensor, equal on every rank) differentiates through the
    collective, and ``torch.autograd.grad(price, sigma)`` is the full vega
    on every rank. An indivisible ``total_paths`` raises ``ValueError``."""
    paths = mesh.local_count(total_paths, "total_paths")
    device = mesh.device
    dt = maturity / num_steps
    sigma = torch.as_tensor(sigma, dtype=ACC_DTYPE, device=device)
    sig = replicated(sigma, mesh) if sigma.requires_grad else sigma
    sqrt_dt = float(torch.tensor(math.sqrt(dt), dtype=ACC_DTYPE)
                    .to(FLOAT_DTYPE))
    drift = ((r - 0.5 * sig * sig) * dt).to(FLOAT_DTYPE)
    vol = sig.to(FLOAT_DTYPE)
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(seed, mesh.rank))
    log_s = torch.full((paths,), math.log(s0), dtype=FLOAT_DTYPE,
                       device=device)
    for _ in range(int(num_steps)):
        dw = torch.randn(paths, generator=gen, dtype=FLOAT_DTYPE,
                         device=device) * sqrt_dt
        log_s = log_s + drift + vol * dw
    payoff = torch.clamp_min(torch.exp(log_s) - float(strike), 0.0)
    total = sum_over_ranks(torch.sum(payoff, dtype=ACC_DTYPE), mesh)
    return total / int(total_paths) * math.exp(-r * maturity)
