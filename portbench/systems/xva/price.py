"""Exposure-profile requests on a netting set under a LIBOR market model
configuration: the program's netting-set exposure engine, built once,
asked for a whole profile on fresh paths and its CVA and DVA per request,
and the comparison of its profiles with the plain reference.

A request is ``NettingSetExposureEngine.reseed(seed)`` (the paths drawn
anew on the device from the request's 64-bit seed), ``profile`` at the
configuration's calibrated parameters (the profile fetched to the host)
and ``cva_from_profile`` / ``dva_from_profile`` at its hazard and
recovery.

Check (``check_requests`` of the window's profiles drawn from the seed,
the last one always): the reference draws the request's normals from its
seed with torch's generator on the card, as the engine does, and values
the netting set on them in float64 (``reference/xva.py``). The engine
runs at the configuration's path precision (``precision.paths``). Each row is
compared against its own peak over the dates:

* ``profile_gap``: the largest of EE, ENE, forward value, standalone EE,
  gross EE and gross ENE;
* ``pfe_gap``: the larger of the two PFE rows;
* ``cva_gap``: the CVA's relative gap.

The control puts the reference at float32 paths, one precision below the
configuration's float64, and float64 sums, in the program's place (at
float32 sums too its regressions' normal equations overflow on the paths
whose par rate runs to 1e12, and every number reads NaN)."""

from __future__ import annotations

import numpy as np
import torch

import spans
from reference import lmm, xva
from seeds import INPUTS, sample, seed_words

CONTROL = dict(dtype=torch.float32, collect=torch.float64)


def cva(ee, times, hazard: float, recovery: float) -> float:
    """(1 - R) sum EE(t_i) PD(t_{i-1}, t_i] under a flat hazard."""
    surv = np.exp(-hazard * np.concatenate([[0.0], times]))
    return float((1.0 - recovery) * np.sum(ee * (surv[:-1] - surv[1:])))


def work_shape(cfg: dict, paths: int) -> dict:
    """What the roofline counts the work of a profile from."""
    t = cfg["trades"]
    return dict(
        num_libors=int(cfg["num_libors"]), num_factors=int(cfg["num_factors"]),
        paths=int(paths), dates=list(cfg["observation_indices"]),
        swaps=[[s["first"], s["last"]] for s in t["swaps"]],
        underlyings=[[e["exercise"], e["exercise"] + e["periods"]]
                     for e in t["europeans"]]
        + [[b["exercises"][0], b["last"]] for b in t["bermudans"]],
        europeans=[e["exercise"] for e in t["europeans"]],
        bermudans=[b["exercises"] for b in t["bermudans"]],
        quantiles=len(cfg["quantiles"]),
        path_bytes=torch.finfo(getattr(torch, cfg["precision"]["paths"])).bits
        // 8)


class Target:
    """``request(seed)`` values the configuration's netting set on the
    paths of ``seed`` and returns its profile rows and its CVA and DVA,
    on the host."""

    def __init__(self, cfg: dict, traffic: dict, seed, device,
                 rec: spans.Recorder):
        from finmath_tpu_torch.models.lmm import build_benchmark_calibration
        from finmath_tpu_torch.models.lmm.exposure import (
            CSA, BermudanSwaptionTrade, NettingSetExposureEngine, SwapTrade,
            SwaptionTrade, cva_from_profile, dva_from_profile)
        from harness import RunError

        if not hasattr(NettingSetExposureEngine, "reseed"):
            raise RunError("the program's NettingSetExposureEngine has no "
                           "reseed: it cannot draw a request's paths")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        F, paths = int(cfg["num_factors"]), int(traffic["paths"])
        t = cfg["trades"]
        trades = (
            [SwapTrade(s["first"], s["last"], s["strike"], s["payer"],
                       s["notional"]) for s in t["swaps"]]
            + [SwaptionTrade(e["exercise"], e["periods"], e["strike"],
                             e["notional"]) for e in t["europeans"]]
            + [BermudanSwaptionTrade(tuple(b["exercises"]), b["last"],
                                     b["strike"], b["notional"])
               for b in t["bermudans"]])
        model = build_benchmark_calibration(num_paths=256, num_factors=F,
                                            device=device).model
        self.engine = NettingSetExposureEngine(
            model, trades, num_paths=paths, num_factors=F,
            seed=seed_words(seed)[INPUTS],
            observation_indices=cfg["observation_indices"],
            quantiles=cfg["quantiles"], csa=CSA(**cfg["csa"]),
            dtype=getattr(torch, cfg["precision"]["paths"]), device=device)
        x = np.asarray(cfg["parameters"], dtype=np.float64)
        h, r = float(cfg["hazard_rate"]), float(cfg["recovery"])
        engine = self.engine

        def run(seed):
            engine.reseed(seed)
            prof = engine.profile(x)
            return (prof, cva_from_profile(prof, h, r),
                    dva_from_profile(prof, h, r))
        self._run = rec.timed("xva", run)
        self.shape = work_shape(cfg, paths)

    def request(self, seed: int) -> dict:
        prof, c, d = self._run(seed)
        rows = {"ee": prof.ee, "ene": prof.ene,
                "forward_value": prof.forward_value,
                "ee_standalone": prof.ee_standalone,
                "ee_gross": prof.ee_gross, "ene_gross": prof.ene_gross}
        rows.update({f"pfe{q}": v for q, v in prof.pfe.items()})
        ok = all(np.all(np.isfinite(v)) for v in rows.values()) \
            and np.isfinite(c) and np.isfinite(d)
        return dict(seed=seed, rows=rows, cva=c, dva=d, times=prof.times,
                    ok=bool(ok))

    def close(self) -> None:
        self._run = None
        self.engine = None

    def check(self, records: list, rng, control: bool = False) -> dict:
        cfg = self.cfg
        model = lmm.Model(cfg)
        x = np.asarray(cfg["parameters"], dtype=np.float64)
        blend, nu, rho = model.scalars(x)
        mk = xva.Market(vol=model.vol_table(x), factors=model.factors(x),
                        L0=model.L0, deltas=model.deltas, blend=blend,
                        nu=nu, rho=rho, dt=model.dt)
        obs = cfg["observation_indices"]
        paths = int(self.traffic["paths"])
        h, r = float(cfg["hazard_rate"]), float(cfg["recovery"])
        out = {"profile_gap": 0.0, "pfe_gap": 0.0, "cva_gap": 0.0}
        for i in sample(len(records), int(self.traffic["check_requests"]),
                        rng):
            rec = records[i]
            z = xva.normals(rec["seed"], max(obs), model.F + 1, paths,
                            self.device)

            def value(**kw):
                p = xva.profile(mk, cfg["trades"], obs, z, csa=cfg["csa"],
                                quantiles=cfg["quantiles"], **kw)
                p.update({f"pfe{q}": v for q, v in p.pop("pfe").items()})
                return p
            ref = value()
            got = value(**CONTROL) if control else rec["rows"]
            got_cva = (cva(got["ee"], rec["times"], h, r) if control
                       else rec["cva"])
            del z
            for name in ref:
                peak = float(np.max(np.abs(ref[name])))
                gap = float(np.max(np.abs(got[name] - ref[name])))
                gap = gap / peak if peak > 0.0 else gap
                key = "pfe_gap" if name.startswith("pfe") else "profile_gap"
                out[key] = float(np.max([out[key], gap]))   # NaN stays
            ref_cva = cva(ref["ee"], rec["times"], h, r)
            out["cva_gap"] = float(np.max([
                out["cva_gap"], abs(got_cva - ref_cva) / abs(ref_cva)]))
        return out
