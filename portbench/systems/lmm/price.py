"""Single-swaption price requests on a LIBOR market model configuration:
the program's pricer entry point at the configuration's initial
parameters, and the comparison of its prices with the plain reference.

Check (``check_requests`` of the window's prices drawn from the seed, the
last one always): the reference prices again on the normals the kernel
drew for that request's seed (Philox4x32-10 and Box-Muller worked out
again), and ``price_gap`` is the largest relative gap. The control puts
the reference at bfloat16 paths and float32 sums in the program's
place."""

from __future__ import annotations

import math

import numpy as np
import torch

import spans
from reference import lmm, philox
from seeds import sample

CONTROL = dict(dtype=torch.bfloat16, collect=torch.float32)


class Target:
    """``request(seed)`` prices the configuration's ``pricer`` swaption
    (exercise step, periods; the ATM strike) at ``paths`` paths with the
    given 64-bit kernel seed and returns the price, fetched to the host."""

    def __init__(self, cfg: dict, traffic: dict, seed, device,
                 rec: spans.Recorder):
        from finmath_tpu_torch.models.lmm import (build_atm_calibration,
                                                  build_benchmark_calibration)
        from finmath_tpu_torch.ops import lmm_kernel as k1
        from finmath_tpu_torch.ops import lmm_stochvol_kernel as ksv

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.model = lmm.Model(cfg)
        E, M = int(cfg["pricer"]["exercise"]), int(cfg["pricer"]["periods"])
        paths, dt = int(traffic["paths"]), float(cfg["dt"])
        F = int(cfg["num_factors"])
        if not self.model.stoch_vol:
            setup = build_atm_calibration(num_paths=256, num_factors=F,
                                          device=device)
            cov, model = setup.covariance, setup.model
            prep = cov.prepare(torch.as_tensor(
                np.asarray(cov.initial_parameters)))
            vol = (cov.vol_table(prep)
                   * cov.factor_matrix(prep)[:, 0][None, :]).numpy()
            strike = next(p.strike for p in setup.products
                          if p.exercise_index == E and p.num_periods == M)
            kernel = "swaption_paths"

            def price(seed):
                return k1.lmm_swaption_kernel(
                    seed, paths, model.num_libors, E, M, E, vol,
                    model.initial_forwards, model.deltas, dt, strike,
                    device=device)
        else:
            setup = build_benchmark_calibration(num_paths=256,
                                                num_factors=F, device=device)
            cov, model = setup.covariance, setup.model
            x0 = np.asarray(cov.initial_parameters)
            prep = cov.prepare(torch.as_tensor(x0))
            vol = cov.vol_table(prep).numpy()
            R = cov.factor_matrix(prep).numpy()
            nu, rho = (float(v) for v in cov.stoch_vol_params(prep))
            blend = float(x0[5])
            fwd0 = setup.engine._t["fwd0"].cpu().numpy()
            strike = next(p.strike for i, p in enumerate(setup.engine.products)
                          if p.exercise_index == E
                          and abs(p.strike - fwd0[i]) < 1e-10)
            kernel = "sv_swaption_paths"

            def price(seed):
                return ksv.lmm_stochvol_swaption_kernel(
                    seed, paths, model.num_libors, F, E, M, E, vol, R,
                    model.initial_forwards, model.deltas, dt, strike, blend,
                    nu, rho, device=device)
        self.shape = dict(num_factors=F, steps=E, exercise=E, periods=M,
                          paths=paths, num_libors=model.num_libors,
                          kernel=kernel)
        self._price = rec.timed("pricer", lambda seed: float(price(seed)),
                                launches=(kernel, 1))

    def request(self, seed: int) -> dict:
        p = self._price(seed)
        return dict(seed=seed, price=p, ok=bool(math.isfinite(p)))

    def close(self) -> None:
        self._price = None

    def check(self, records: list, rng, control: bool = False) -> dict:
        model = self.model
        E = int(self.cfg["pricer"]["exercise"])
        M = int(self.cfg["pricer"]["periods"])
        strike = next(p[2] for p in model.products
                      if p[0] == E and p[1] == M and (
                          not model.stoch_vol
                          or abs(p[2] - model.par_rate(E, M)) < 1e-12))
        paths = int(self.traffic["paths"])
        rows = model.F + int(model.stoch_vol)
        out = {"price_gap": 0.0}
        for i in sample(len(records), int(self.traffic["check_requests"]),
                        rng):
            rec = records[i]

            def normals_of(lo, hi, seed=rec["seed"]):
                z = philox.normals(seed, lo, hi, E * rows, self.device)
                return z.reshape(E, rows, hi - lo)
            ref = lmm.swaption_price(model, model.initial(), E, M, strike,
                                     normals_of, paths, device=self.device)
            got = (lmm.swaption_price(model, model.initial(), E, M, strike,
                                      normals_of, paths, device=self.device,
                                      **CONTROL)
                   if control else rec["price"])
            out["price_gap"] = max(out["price_gap"], abs(got - ref) / abs(ref))
        return out
