"""Path-axis data parallelism over torch.distributed ranks.

Run: python finmath_tpu_torch/examples/04_multichip_sharding.py [--cpu]

Counterpart of ``examples/04_multichip_sharding.py``. ``main`` starts a
world of ranks with ``parallel.launch`` (one process a rank): by default
NCCL ranks, one on each visible card; with ``device="cpu"`` (``--cpu``)
gloo ranks on the CPU, eight as the JAX script's virtual devices. Each
rank simulates its block of the Monte-Carlo path axis; expectations are
a local float64 sum and an all-reduce, and gradients flow through the
collective (``parallel.sum_over_ranks`` / ``parallel.replicated``).
Every rank returns the same results.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

# the ranks import this script by its module name in the package
TARGET = "finmath_tpu_torch.examples.04_multichip_sharding:rank_main"
CPU_RANKS = 8


def rank_main(mesh, num_paths: int = 1600) -> dict:
    """The example's work on one rank of the world (``mesh`` its
    ``parallel.PathMesh``)."""
    import torch

    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.models.lmm.exposure import SwapExposureEngine
    from finmath_tpu_torch.models.lmm.model import LMMValuationEngine

    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  device=mesh.device)
    products = [p for p in setup.products if p.exercise_index <= 10]
    sharded = LMMValuationEngine(setup.model, products, num_paths, 1,
                                 seed=31415, mesh=mesh)
    p0 = np.asarray(setup.covariance.initial_parameters)
    r = sharded.residuals(p0)

    # the loss gradient through the collective: the parameters enter the
    # local paths through replicated() and the path sums leave through
    # sum_over_ranks(), so every rank gets the full gradient
    x = torch.tensor(p0, dtype=torch.float64, device=mesh.device,
                     requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(sharded._residuals(x) ** 2), x)
    g = g.cpu().numpy()

    # XVA under the same mesh: the exposure expectations all-reduce and
    # the PFE quantiles gather the netted values
    expo = SwapExposureEngine(setup.model, first_index=2, last_index=10,
                              strike=0.004, num_paths=num_paths,
                              num_factors=1, mesh=mesh)
    prof = expo.profile(p0)
    cva, ladder = expo.cva_forward_deltas(p0, hazard_rate=0.012)
    return {"world_size": mesh.world_size, "backend": mesh.backend,
            "device": str(mesh.device), "residuals": np.asarray(r),
            "gradient": g, "dates": len(prof.times),
            "peak_ee": float(np.max(prof.ee)),
            "pfe99": float(prof.max_pfe(0.99)), "cva": float(cva),
            "ladder": np.asarray(ladder), "collectives": mesh.calls}


def main(num_ranks=None, num_paths: int = 1600, device=None,
         timeout: float = 600.0) -> dict:
    """Run ``rank_main`` on a world of ``num_ranks`` ranks: NCCL ranks on
    the visible cards (default: one a card) unless ``device="cpu"``, then
    gloo ranks on the CPU (default eight, one thread each). Prints the
    JAX script's lines from rank 0 and returns its results."""
    import torch

    from finmath_tpu_torch.parallel.launch import run_world

    if device is not None and torch.device(device).type == "cpu":
        ranks = int(num_ranks or CPU_RANKS)
        options = dict(backend="gloo", device="cpu", threads=1)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device=\"cpu\" to run gloo ranks on the CPU")
        ranks = int(num_ranks or torch.cuda.device_count())
        options = dict(backend="nccl", device=device)
    results = run_world(TARGET, ranks, timeout=timeout,
                        kwargs={"num_paths": int(num_paths)}, **options)
    first = results[0]
    for other in results[1:]:
        for key in ("residuals", "gradient", "ladder"):
            assert np.array_equal(other[key], first[key]), key
        assert other["cva"] == first["cva"]
    print(f"{first['world_size']} ranks: {first['backend']} on "
          f"{first['device'].split(':')[0]}")
    r = first["residuals"]
    print(f"sharded residuals over {first['world_size']} ranks: "
          f"{len(r)} products, rms {np.sqrt((r**2).mean()):.2e}")
    assert np.all(np.isfinite(first["gradient"]))
    print(f"loss gradient through the collective: {len(first['gradient'])} "
          f"params, finite")
    print(f"sharded exposure profile: {first['dates']} dates, peak EE "
          f"{first['peak_ee']:.2e}, PFE99 {first['pfe99']:.2e}")
    print(f"sharded CVA {first['cva']:.3e} + {first['ladder'].shape[0]}-bucket "
          f"delta ladder through the collective")
    return first


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
