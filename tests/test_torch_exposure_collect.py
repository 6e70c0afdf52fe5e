"""The netting-set exposure engine's per-date collector
(``ops/exposure_collect.py``): its plain version against the engine's
composition before the kernel, bit for bit, on the CPU; the wrapper's
checks; and, on a card, the CUDA kernel against the plain version (on
the engine's grid, and on a 460-period grid whose curve does not fit a
block's shared memory), its refusal of forwards that require grad, and a
profile's one launch a date against the CPU engine's profile.

The netting set: the stoch-vol benchmark model (40 libors, 5 factors),
three swaps (one forward-starting), a European and a Bermudan payer
swaption, 12 dates. The card's cases feed both versions the same forwards:
uniform on [-0.5%, 8%], and besides a path at the +1e3 clamp, one at
-1e3, one at the pole of 1 / (1 + delta L) (not finite: the path breaks),
one just above the pole (a curve of 1e5 a period, beyond float32's range
after 8 periods) and, under the spot measure, one with a zero numeraire.

The ``gpu`` tests need a card and no JAX; on a machine with the card:
``python -m pytest tests/test_torch_exposure_collect.py -m gpu
--noconftest``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.lmm import build_benchmark_calibration  # noqa: E402
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    CURATED_BASINS)
from finmath_tpu_torch.models.lmm.exposure import (  # noqa: E402
    BermudanSwaptionTrade,
    NettingSetExposureEngine,
    SwapTrade,
    SwaptionTrade,
    _bond_curve,
    _inv_numeraire,
    _relative_tables,
    _swap_geometry,
)
from finmath_tpu_torch.ops import exposure_collect as xc  # noqa: E402
from finmath_tpu_torch.utils import profiling  # noqa: E402

X = np.asarray(CURATED_BASINS[0])
OBS = list(range(1, 13))
SWAPS = [SwapTrade(1, 16, 0.025, True, 1.0),
         SwapTrade(5, 14, 0.026, False, 0.9),
         SwapTrade(1, 9, 0.018, False, 0.7)]
OPTIONS = [SwaptionTrade(6, 8, 0.024, 1.5),
           BermudanSwaptionTrade((4, 6, 8), 14, 0.023, 1.2)]


@pytest.fixture(scope="module")
def model():
    return build_benchmark_calibration(num_paths=256, device="cpu").model


def _engine(model, device, dtype=torch.float64, options=True, paths=512):
    return NettingSetExposureEngine(
        model, SWAPS + (OPTIONS if options else []), num_paths=paths,
        num_factors=5, seed=11, observation_indices=OBS, dtype=dtype,
        device=device)


def _bits_equal(a, b) -> bool:
    """Equal bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _collect_before_kernel(eng, e, ev, L, N):
    """The engine's collector as it was composed before the kernel
    (``_bond_curve``, ``_inv_numeraire``, ``swap_values`` on the engine's
    dense tables), with its buffer rule for the underlyings' flag."""
    plan = eng._collect_plan
    cp, _ = _bond_curve(eng.engine, e, L, N)
    inv_n = _inv_numeraire(eng.model, cp, N)
    raw, _ = xc.swap_values(cp, eng._swap_tables[ev], eng._strikes,
                            eng.engine.dtype)
    v_trade = eng._coef[ev][:, None] * raw
    v_net = torch.sum(v_trade, dim=0)
    s_plus = torch.sum(torch.clamp_min(v_trade, 0.0), dim=0)
    raw_u, ann_u = xc.swap_values(cp, plan.und_tables[ev],
                                  plan.und_strikes, eng.engine.dtype)
    alive = plan.und_alive[ev][:, None]
    v_und = alive * raw_u
    float_u = v_und + plan.und_strikes[:, None] * ann_u * alive
    srate = float_u / torch.clamp_min(ann_u, 1e-12)
    flag = ((v_und - v_und) + (srate - srate)).sum(dim=0) == 0.0
    return v_net, s_plus, v_und, srate, inv_n, flag


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_is_the_engines_composition(model, dtype):
    """On the CPU, ``exposure_collect_reference`` and the rows the wrapper
    writes are the pre-kernel collector's outputs bit for bit at every
    date of a simulation."""
    eng = _engine(model, "cpu", dtype)
    plan = eng._collect_plan
    out = xc.collect_buffers(plan, eng.engine._local_paths, "cpu")
    dates, launches = [], xc.LAUNCHES

    def collect(e, ev, L, N):
        before = _collect_before_kernel(eng, e, ev, L, N)
        got = xc.exposure_collect_reference(L, N, plan, ev)
        assert all(_bits_equal(a, b) for a, b in zip(got, before[:5]))
        xc.exposure_collect(L, N, plan, ev, out)
        rows = (out.net[ev], out.plus[ev], out.und[ev], out.rates[ev],
                out.inv[ev], out.und_finite[ev])
        want = before[:3] + (before[3].to(dtype),) + before[4:]
        assert all(_bits_equal(a, b) for a, b in zip(rows, want))
        dates.append(e)

    with torch.no_grad():
        eng.engine._simulate_collect(eng.engine._params(X), collect)
    assert dates == OBS
    assert xc.LAUNCHES == launches


def _cpu_inputs(model):
    eng = _engine(model, "cpu", torch.float64, paths=64)
    plan = eng._collect_plan
    ev, e = 2, OBS[2]
    n = plan.deltas.shape[0]
    L = torch.full((n - e, 64), 0.02, dtype=torch.float64)
    N = torch.ones(64, dtype=torch.float64)
    return plan, ev, L, N, xc.collect_buffers(plan, 64, "cpu")


@pytest.mark.parametrize("fault", ["dtype", "shape", "device",
                                   "path_axis", "buffer"])
def test_wrapper_rejects(model, fault):
    """The wrapper raises on a wrong dtype, shape or device and on a path
    axis that is not contiguous, before any arithmetic."""
    plan, ev, L, N, out = _cpu_inputs(model)
    if fault == "dtype":
        L = L.to(torch.float32)
    elif fault == "shape":
        L = L[1:]
    elif fault == "device":
        N = torch.empty(N.shape, dtype=N.dtype, device="meta")
    elif fault == "path_axis":
        L = L.t().contiguous().t()
    else:
        out = out._replace(rates=out.rates.to(torch.float32))
    launches = xc.LAUNCHES
    with pytest.raises(ValueError):
        xc.exposure_collect(L, N, plan, ev, out)
    assert xc.LAUNCHES == launches


# ---------------------------------------------------------------------------
# on the card (gpu marker)
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the collector kernel runs only "
                    "on the card")


def _forwards(plan, ev, paths, gen):
    """``(L [n - e, paths] path dtype, N [paths] collect dtype)``: uniform
    forwards and the special paths of the module docstring."""
    e = plan.dates[ev]
    m = plan.deltas.shape[0] - e
    L = torch.rand((m, paths), generator=gen, dtype=torch.float64)
    L = -0.005 + 0.085 * L
    L[:, 0] = 1e3
    L[:, 1] = -1e3
    L[min(2, m - 1), 2] = -1.0 / float(plan.deltas[e + min(2, m - 1)])
    L[:, 3] = (-1.0 + 1e-5) / plan.deltas[e:].cpu()
    N = 1.0 + 2.0 * torch.rand(paths, generator=gen, dtype=torch.float64)
    N[4] = 0.0
    return (L.to(plan.path_dtype).to("cuda"),
            N.to(plan.collect_dtype).to("cuda"))


def _finite(out, ev):
    f = (torch.isfinite(out.net[ev]) & torch.isfinite(out.inv[ev])
         & torch.isfinite(out.plus[ev]))
    return f & out.und_finite[ev] if out.und is not None else f


def _bounds(plan, ev, L):
    """Per path and row, what the two versions may differ by, from the
    magnitudes of the terms each sums (the plain version's arithmetic on
    absolute values, float64): an annuity of at most m terms summed in
    another order differs by at most 2 m u |terms| (u the path dtype's
    unit roundoff; both sides round each term once); a value adds three
    float64 roundings of its bonds and strike term; the netted and
    positive-part sums take T terms in another order (2 T u64 of their
    absolute sum). Each bound is doubled."""
    u = torch.finfo(plan.path_dtype).eps / 2
    u64 = torch.finfo(torch.float64).eps / 2
    e = plan.dates[ev]
    m = L.shape[0]
    cd = plan.collect_dtype
    cp = torch.cumprod(1.0 / (1.0 + plan.deltas[e:, None].to(cd)
                              * L.to(cd)), dim=0)
    cp = torch.cat([torch.ones_like(cp[:1]), cp]).to(torch.float64)

    def parts(table, strikes):
        terms = table["mask"].abs().to(torch.float64) @ cp[1:].abs()
        ann_err = 2 * m * u * terms
        mag = (cp[table["start"]].abs() + cp[table["end"]].abs()
               + strikes.abs()[:, None] * terms)
        return strikes.abs()[:, None] * ann_err + 4 * u64 * mag, ann_err, \
            mag

    raw_err, _, mag = parts(plan.swap_tables[ev], plan.swap_strikes)
    coef = plan.swap_coefs[ev].abs()[:, None]
    T = coef.shape[0]
    net = 2 * ((coef * raw_err).sum(0) + 2 * T * u64 * (coef * mag).sum(0))
    if plan.und_tables is None:
        return net, None, None
    und_err, ann_err, _ = parts(plan.und_tables[ev], plan.und_strikes)
    _, ann = xc.swap_values(cp.to(cd), plan.und_tables[ev],
                             plan.und_strikes, plan.path_dtype)
    return net, 2 * und_err, (ann, ann_err, und_err)


PAIRS = [(torch.float64, torch.float64), (torch.float32, torch.float64),
         (torch.float32, torch.float32)]
PAIR_IDS = ["f64_f64", "f32_f64", "f32_f32"]


def _kernel_matches_plain(plan, paths, seed):
    """Every date of ``plan``: the same broken paths; 1/N bit for bit; the
    netted value, positive-part sum and underlyings' values within
    ``_bounds``; the par rates within the same bounds carried through
    ``(raw + K ann) / max(ann, 1e-12)``, plus one rounding to the path
    dtype; one launch a date."""
    gen = torch.Generator().manual_seed(seed)
    ref = xc.collect_buffers(plan, paths, "cuda")
    got = xc.collect_buffers(plan, paths, "cuda")
    launches = xc.LAUNCHES
    with torch.no_grad():
        for ev in range(len(plan.dates)):
            L, N = _forwards(plan, ev, paths, gen)
            xc.write_rows(ref, ev, xc.exposure_collect_reference(L, N, plan,
                                                                 ev))
            xc.exposure_collect(L, N, plan, ev, got)
            torch.cuda.synchronize()
            ok = _finite(ref, ev)
            assert torch.equal(_finite(got, ev), ok)
            assert not bool(ok[2])                   # the pole breaks
            assert torch.equal(got.inv[ev][ok], ref.inv[ev][ok])
            net_tol, und_tol, rate_parts = _bounds(plan, ev, L)
            for name in ("net", "plus"):
                gap = (getattr(got, name)[ev] - getattr(ref, name)[ev]).abs()
                assert bool(torch.all(gap[ok] <= net_tol[ok])), name
            if plan.und_tables is None:
                continue
            gap = (got.und[ev] - ref.und[ev]).abs()
            assert bool(torch.all(gap[:, ok] <= und_tol[:, ok]))
            ann, ann_err, raw_err = rate_parts
            a = torch.clamp_min(ann, 1e-12)
            s = ref.rates[ev].to(torch.float64)
            f = s * a
            u = torch.finfo(plan.path_dtype).eps / 2
            # |d rate| <= |d f| / a + |f| |d a| / a^2, in an order that no
            # product overflows on the 1e5 curve
            rate_tol = (2 * ((raw_err + plan.und_strikes.abs()[:, None]
                              * ann_err) / a + f.abs() / a * (ann_err / a))
                        + 4 * u * s.abs())
            gap = (got.rates[ev].to(torch.float64) - s).abs()
            assert bool(torch.all(gap[:, ok] <= rate_tol[:, ok]))
    assert xc.LAUNCHES - launches == len(plan.dates)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("spot", [True, False], ids=["spot", "terminal"])
@pytest.mark.parametrize("options", [True, False], ids=["options", "swaps"])
def test_kernel_matches_plain(model, pair, spot, options):
    """The engine's grid (``_kernel_matches_plain``), the curve in shared
    memory."""
    _needs_card()
    path_dtype, collect_dtype = pair
    eng = _engine(model, "cuda", path_dtype, options, paths=4096 + 3)
    plan = dataclasses.replace(eng._collect_plan,
                               collect_dtype=collect_dtype, spot=spot)
    _kernel_matches_plain(plan, eng.engine._local_paths, 5)


def _long_plan(pair, dates, device="cuda"):
    """A plan on a 460-period grid (quarter-year periods, every third one
    half a year: uneven, so a shifted delta shows, and each 1 / delta
    exact, so ``_forwards`` hits the pole), built as the engine builds its
    own: four swaps (two forward-starting at the first date) and two
    underlyings (one matured at the last date), the first date's curve 459
    periods long."""
    n = 460
    deltas = np.where(np.arange(n) % 3 == 1, 0.5, 0.25)
    swaps = [(1, 459, 0.025), (10, 300, 0.03), (1, 250, 0.02),
             (350, 455, 0.028)]
    unds = [(5, 380, 0.024), (250, 460, 0.026)]
    path_dtype, collect_dtype = pair
    mask, start_m1, is_fwd, alive, end_m1, strikes = _swap_geometry(
        swaps, dates, deltas, n)
    coefs = alive * np.asarray([1.0, -0.8, 0.6, 1.3])[None, :]
    u_mask, u_start_m1, u_is_fwd, u_alive, u_end_m1, u_strikes = \
        _swap_geometry(unds, dates, deltas, n)
    rows, reals, counts = xc.pack_rows(dates, swaps, coefs, unds, device)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return xc.CollectPlan(
        dates=tuple(dates), deltas=f64(deltas),
        swap_tables=_relative_tables(dates, mask, start_m1, is_fwd, end_m1,
                                     path_dtype, device),
        swap_strikes=f64(strikes), swap_coefs=f64(coefs),
        und_tables=_relative_tables(dates, u_mask, u_start_m1, u_is_fwd,
                                    u_end_m1, path_dtype, device),
        und_strikes=f64(u_strikes), und_alive=f64(u_alive), rows=rows,
        reals=reals, counts=counts, path_dtype=path_dtype,
        collect_dtype=collect_dtype, spot=True)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_kernel_matches_plain_past_shared_memory(pair):
    """A grid whose early curves do not fit a block's shared memory (more
    than 223 periods with a float64 curve, 446 with a float32 one), so
    those dates keep the curve in device memory and the later ones in
    shared memory: both match the plain version (``_kernel_matches_plain``)."""
    _needs_card()
    dates = [1, 3, 200, 400]
    plan = _long_plan(pair, dates)
    lib = xc._library()
    cb = torch.finfo(pair[1]).bits // 8
    in_device = [bool(lib.exposure_collect_scratch_rows(cb, 460 - e))
                 for e in dates]
    assert in_device == ([True, True, True, False] if cb == 8
                         else [True, True, False, False])
    _kernel_matches_plain(plan, 1000 + 3, 7)


@pytest.mark.gpu
def test_kernel_refuses_grad(model):
    """The kernel has no backward: on the card, forwards that require grad
    raise under grad mode (no fallback to the plain version), and collect
    under ``torch.no_grad()``."""
    _needs_card()
    eng = _engine(model, "cuda", torch.float64, options=False, paths=256)
    plan = eng._collect_plan
    L, N = _forwards(plan, 0, 256, torch.Generator().manual_seed(3))
    out = xc.collect_buffers(plan, 256, "cuda")
    L.requires_grad_(True)
    launches = xc.LAUNCHES
    with pytest.raises(ValueError, match="no backward"):
        xc.exposure_collect(L, N, plan, 0, out)
    assert xc.LAUNCHES == launches
    with torch.no_grad():
        xc.exposure_collect(L, N, plan, 0, out)
    assert xc.LAUNCHES == launches + 1


@pytest.mark.gpu
def test_profile_launches_once_a_date(model):
    """One profile on the card: one launch a date, each date's span marked
    ``kernel=True``, and the profile equal to the CPU engine's on the same
    increments (the plain version) within 1e-9 of each row's peak: the
    two devices' step loops and collectors differ in the last bits, and
    the regressions fit on par rates that do."""
    _needs_card()
    eng = _engine(model, "cuda", torch.float64, paths=8192)
    launches = xc.LAUNCHES
    profiling.clear()
    with profiling.recording():
        prof = eng.profile(X)
    assert xc.LAUNCHES - launches == len(OBS)
    collects = [s for s in profiling.spans()
                if s.name == "finmath.xva.collect"]
    assert len(collects) == len(OBS)
    assert all(s.attrs.get("kernel") is True for s in collects)
    cpu = NettingSetExposureEngine(
        model, SWAPS + OPTIONS, num_paths=8192, num_factors=5,
        increments=eng.engine.increments.cpu(), observation_indices=OBS,
        dtype=torch.float64, device="cpu")
    want = cpu.profile(X)
    assert xc.LAUNCHES - launches == len(OBS)
    rows = [(prof.ee, want.ee), (prof.ene, want.ene),
            (prof.forward_value, want.forward_value),
            (prof.ee_standalone, want.ee_standalone)]
    for got, ref in rows:
        peak = np.max(np.abs(ref))
        assert np.all(np.abs(got - ref) <= 1e-9 * peak)
