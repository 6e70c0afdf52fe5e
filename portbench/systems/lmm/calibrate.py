"""Calibration requests on a LIBOR market model configuration: the
program's calibration entry point, fed increments the benchmark drew, and
the comparison of its answers with the plain reference.

Every call into a layer of the program goes through ``spans.timed``, so
the benchmark's own spans and counters see it; nothing inside the
program is instrumented here.

Check (``check_requests`` of the window's distinct results, the last one
always): the reference values the calibration products at the calibrated
parameters on the same increments, and the configuration's
``limits.calibrate`` name which of these are compared:

* ``residual_gap``: the largest gap between a residual row the program
  computed at the result and the reference's row (quote units);
* ``mean_deviation``: |mean of the reference's row| (the published
  tests' assert);
* ``fit_ratio``: the reference's rms at the result over its rms at the
  start; a calibration that returns its start reads 1;
* ``stationarity``: the norm of the reference's gradient J^T r at the
  result over its norm at the start (J by central differences of step
  ``fd_step``): a least-squares minimum reads near 0, a returned start 1.

The control puts the reference, one precision below the configuration's
(bfloat16 paths, float32 sums), in the program's place: its residual row
at the result stands for the program's."""

from __future__ import annotations

import numpy as np
import torch

import spans
from reference import lmm
from seeds import sample, seed_words

CONTROL = dict(dtype=torch.bfloat16, collect=torch.float32)


class _Proxy:
    """An object whose named methods are the given callables (a layer's
    engine with its calls wrapped in spans)."""

    def __init__(self, **methods):
        self.__dict__.update(methods)


def increments(model: lmm.Model, paths: int, seed, device) -> torch.Tensor:
    """``[steps, F (+1), paths]`` float32 standard normals scaled by
    sqrt(dt), from a generator on ``device`` seeded from ``seed``; one
    more row per step for a stochastic volatility's driver."""
    steps = max(p[0] for p in model.products)
    rows = model.F + int(model.stoch_vol)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed, 1)[0])
    z = torch.randn((steps, rows, paths), generator=gen, device=device,
                    dtype=torch.float32)
    return z * torch.tensor(model.dt, dtype=torch.float32).sqrt()


class Target:
    """``request(j)`` runs one whole Levenberg-Marquardt calibration on the
    j-th of ``realizations`` increment sets drawn from ``pool_seed`` and
    returns the calibrated parameters, the program's residual row at them,
    its rms and iterations."""

    def __init__(self, cfg: dict, traffic: dict, seed, device,
                 rec: spans.Recorder):
        from finmath_tpu_torch.models.calibration import LevenbergMarquardt
        from finmath_tpu_torch.models.lmm import (ATMKernelCalibration,
                                                  LMMValuationEngine,
                                                  StochVolKernelCalibration,
                                                  build_atm_calibration,
                                                  build_benchmark_calibration)

        self.cfg, self.traffic, self.rec = cfg, traffic, rec
        self.model = lmm.Model(cfg)
        paths, F = int(traffic["paths"]), int(cfg["num_factors"])
        self.pool = pool = [
            increments(self.model, paths, [int(traffic["pool_seed"]), j],
                       device) for j in range(int(traffic["realizations"]))]
        lm = cfg["lm"]
        self._history = []
        self.j = 0
        if cfg["kind"] == "atm":
            setup = build_atm_calibration(num_paths=paths, num_factors=F,
                                          device=device)
            setup.engine = LMMValuationEngine(
                setup.model, setup.products, paths, F, device=device,
                increments=pool[0])
            jac_paths = int(traffic["jacobian_paths"])
            jac = LMMValuationEngine(
                setup.model, setup.products, jac_paths, F, device=device,
                increments=pool[0][:, :, :jac_paths])
            backend = ATMKernelCalibration(setup.engine)
            analytic = setup.analytic_engine
            setup._analytic_engine = _Proxy(
                residuals=rec.timed("analytic", analytic.residuals),
                jacobian=rec.timed("analytic", analytic.jacobian))
            setup.jacobian_engine = _Proxy(
                jacobian=rec.timed("engine_jacobian", jac.jacobian))
            residual_fn = self._residual_fn(backend.residuals, "atm_products")

            def run():
                if self.j != self._on:
                    setup.engine.set_increments(pool[self.j])
                    jac.set_increments(pool[self.j][:, :, :jac_paths])
                    self._on = self.j
                return setup.calibrate(
                    max_iterations=lm["max_iterations"],
                    accuracy=lm["accuracy"], lambda0=lm["lambda0"],
                    warm_start=traffic.get("warm_start"),
                    residual_backend=_Proxy(residuals=residual_fn))
        else:
            setup = build_benchmark_calibration(num_paths=paths,
                                                num_factors=F, device=device)
            backend = StochVolKernelCalibration(setup.engine,
                                                realizations=pool)
            residual_fn = self._residual_fn(
                lambda x: backend.residuals(x, k=self.j), "sv_products")
            jacobian_fn = rec.timed("kernel_backend",
                                    lambda x: backend.jacobian(x, k=self.j),
                                    calls="backend_calls",
                                    launches=("sv_products",
                                              2 * len(cfg["start"]) + 1))
            start = np.asarray(cfg["start"], dtype=np.float64)

            def run():
                return LevenbergMarquardt(
                    residual_fn, jacobian_fn, lambda0=lm["lambda0"],
                    max_iterations=lm["max_iterations"],
                    accuracy=lm["accuracy"],
                    lower_bound=float(lm["lower_bound"])).run(start)
        self._on = 0
        self._setup, self._backend, self._run = setup, backend, run
        self.shape = dict(num_libors=backend._n, num_factors=backend._F,
                          products=list(backend._products), paths=paths,
                          stoch_vol=cfg["kind"] != "atm",
                          displaced=bool(getattr(backend, "_displaced",
                                                 False)))

    def _residual_fn(self, fn, kernel: str):
        """The residual function handed to the LM: counted, timed, and
        every row of the request kept with its parameter vector, so that
        the row at the result is the one the program computed in the
        window."""
        timed = self.rec.timed("kernel_backend", fn, calls="backend_calls",
                               launches=(kernel, 1))

        def residuals(x):
            self.rec.count("lm_residual_calls")
            r = timed(x)
            self._history.append((np.array(x, dtype=np.float64, copy=True),
                                  np.array(r, dtype=np.float64, copy=True)))
            return r
        return residuals

    def request(self, j: int) -> dict:
        self._history.clear()
        self.j = j
        result = self._run()
        x = np.asarray(result.parameters, dtype=np.float64)
        row = next((r for xi, r in reversed(self._history)
                    if np.array_equal(xi, x)), None)
        return dict(j=j, x=x, residuals=row, rms=float(result.rms_error),
                    iterations=int(result.iterations),
                    ok=bool(np.all(np.isfinite(x)) and row is not None
                            and np.all(np.isfinite(row))))

    def close(self) -> None:
        self._setup = self._backend = self._run = None
        self._history.clear()

    def _gradient(self, x, inc):
        """J^T r of the reference's residuals at x (central differences)."""
        h = float(self.cfg["fd_step"])
        r = lmm.residuals(self.model, x, inc)
        J = np.empty((r.shape[0], x.shape[0]))
        for k in range(x.shape[0]):
            e = np.zeros_like(x)
            e[k] = h
            J[:, k] = (lmm.residuals(self.model, x + e, inc)
                       - lmm.residuals(self.model, x - e, inc)) / (2 * h)
        return J.T @ r

    def check(self, records: list, rng, control: bool = False) -> dict:
        wanted = self.cfg["limits"]["calibrate"]
        start = self.model.start()
        distinct = {}
        for i, r in enumerate(records):
            distinct[(r["j"], r["x"].tobytes())] = i
        order = sorted(distinct.values())
        picked = [order[i] for i in sample(
            len(order), int(self.traffic["check_requests"]), rng)]
        out = dict.fromkeys(wanted, 0.0)
        for i in picked:
            rec = records[i]
            inc = self.pool[rec["j"]]
            ref = lmm.residuals(self.model, rec["x"], inc)
            got = (lmm.residuals(self.model, rec["x"], inc, **CONTROL)
                   if control else rec["residuals"])
            gap = (float(np.max(np.abs(got - ref))) if got is not None
                   and got.shape == ref.shape else float("inf"))
            new = {"residual_gap": gap,
                   "mean_deviation": abs(float(np.mean(ref)))}
            if "fit_ratio" in wanted:
                r_start = lmm.residuals(self.model, start, inc)
                new["fit_ratio"] = float(np.sqrt(np.mean(ref ** 2)
                                                 / np.mean(r_start ** 2)))
            if "stationarity" in wanted:
                new["stationarity"] = float(
                    np.linalg.norm(self._gradient(rec["x"], inc))
                    / np.linalg.norm(self._gradient(start, inc)))
            for name in wanted:
                out[name] = max(out[name], new[name])
        return out
