"""Eager, factory-injected LMM swaption valuation (finmath-style workflow).

Counterpart of ``finmath_tpu.models.lmm.eager``: the op-by-op valuation
path. Every arithmetic step is a ``RandomVariable`` method call dispatched
through whatever implementation the injected factory produces, the way
finmath-lib models consume the reference backend (a
``RandomVariableFactory`` handed to the model, each Euler step issuing
individual vector operations; LIBORMarketModelCalibrationATMTest.java:283,
351-358). The factories that make sense here:

* ``RandomVariableTorchFactory``          -- eager execution on the card;
* ``RandomVariableTorchLazyFactory``      -- recorded, one flushed program
  (a CUDA graph) per reduction;
* ``RandomVariableFloatFactory``          -- the CPU float oracle;
* ``RandomVariableDifferentiableFactory`` -- tape AAD: after valuation,
  ``value.get_gradient([sigma])`` returns the swaption vega with every
  adjoint computed on the device.

The model is the workloads' configuration: spot measure, NORMAL state
space, simulation grid == tenor grid, one factor, flat volatility. The
production path is :class:`~finmath_tpu_torch.models.lmm.model.
LMMValuationEngine`; this module serves the eager and AAD workflows and
cross-checks the engine's arithmetic.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["eager_swaption_valuation"]


def eager_swaption_valuation(factory, initial_forwards: Sequence[float],
                             deltas: Sequence[float], sigma, increments,
                             exercise_index: int, num_periods: int,
                             strike: float):
    """Price a payer swaption with op-by-op RandomVariable arithmetic.

    Parameters
    ----------
    factory:
        Any object with ``create_random_variable(time, values)``, the
        injection point (ref. RandomVariableCudaFactory.java:27-34).
    initial_forwards, deltas:
        Tenor-grid forwards ``L_i(0)`` and period lengths ``delta_i``.
    sigma:
        The flat NORMAL volatility — a plain float or an already-created
        RandomVariable (pass a ``RandomVariableDifferentiable`` leaf to
        make the valuation differentiable w.r.t. it).
    increments:
        ``[steps, paths]`` Brownian increments ``dW_s`` (already scaled
        by ``sqrt(dt_s)``), a NumPy array or a tensor (row ``s`` goes to
        the factory as it is).
    exercise_index, num_periods, strike:
        Swaption terms on the tenor grid (SwaptionSimple analog).

    Returns
    -------
    The numeraire-rebased payoff ``max(swap, 0) / N(T_e)`` as a
    RandomVariable of the factory's type; its expectation is the t=0
    price (spot measure, ``N(0) = 1``).
    """
    n = len(deltas)
    e = int(exercise_index)
    if not (1 <= e and e + num_periods <= n):
        raise ValueError("swaption does not fit on the tenor grid")
    inc_shape = np.shape(increments)
    if len(inc_shape) != 2 or inc_shape[0] < e:
        raise ValueError(
            f"increments must be [steps >= {e}, paths], got shape {inc_shape}")
    deltas = [float(d) for d in deltas]
    tenor = np.concatenate([[0.0], np.cumsum(deltas)])

    make = factory.create_random_variable
    if not hasattr(sigma, "mult"):
        sigma = make(0.0, float(sigma))

    libors = [make(0.0, float(f)) for f in initial_forwards]
    numeraire = make(0.0, 1.0)

    # Euler sweep to the exercise date: step s evolves [T_s, T_{s+1})
    for s in range(e):
        dt = deltas[s]
        # spot account accrues the just-fixed period s forward
        numeraire = numeraire.accrue(libors[s], dt)
        dw = make(float(tenor[s]), increments[s])
        # spot-measure drift: mu_i = lam_i * sum_{j<=i alive} c_j with
        # c_j = delta_j / (1 + delta_j L_j) * lam_j (NORMAL state space:
        # no L_j numerator, no Ito term — model.py drift_of)
        drift_acc = None
        new_libors = list(libors)
        for i in range(s + 1, n):
            c_i = sigma.mult(deltas[i]).div(
                libors[i].mult(deltas[i]).add(1.0))
            drift_acc = c_i if drift_acc is None else drift_acc.add(c_i)
            mu_i = sigma.mult(drift_acc)
            new_libors[i] = libors[i].add(mu_i.mult(dt)).add(sigma.mult(dw))
        libors = new_libors

    # pathwise swap value at T_e: sum_i delta_i (L_i - K) P(T_e, T_{i+1})
    swap = None
    bond = make(float(tenor[e]), 1.0)           # P(T_e, T_e)
    for i in range(e, e + num_periods):
        bond = bond.discount(libors[i], deltas[i])
        leg = libors[i].sub(strike).mult(deltas[i]).mult(bond)
        swap = leg if swap is None else swap.add(leg)

    payoff = swap.floor(0.0)
    return payoff.div(numeraire)
