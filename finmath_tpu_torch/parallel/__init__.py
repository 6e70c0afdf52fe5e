"""Path-axis sharding over torch.distributed ranks (counterpart of
``finmath_tpu.parallel``)."""

from .mesh import (PathMesh, make_path_mesh, mc_price_sharded, rank_seed,
                   replicated, sharded_mean, sum_over_ranks)

__all__ = ["PathMesh", "make_path_mesh", "mc_price_sharded", "rank_seed",
           "replicated", "sharded_mean", "sum_over_ranks"]
