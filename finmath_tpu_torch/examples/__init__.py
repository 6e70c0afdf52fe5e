"""Runnable examples of the port, counterparts of the JAX package's
``examples/`` scripts of the same names. Each script has a ``main(...)``
that takes its sizes (the JAX script's by default) and ``device=``, runs
on the CUDA card unless it is given ``device="cpu"``, and prints what the
JAX script prints. Run one from the repository root, e.g.
``python finmath_tpu_torch/examples/01_random_variables.py [--cpu]``."""
