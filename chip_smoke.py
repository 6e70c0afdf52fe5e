"""Drive the PyTorch + CUDA port (finmath_tpu_torch) once on one NVIDIA GPU
and check what it computes.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # and phase 6, the device's busy share

Phases, one line of output each (more for the kernel builds), in order:

1. the card: ``torch.cuda.get_device_name()`` and ``nvidia-smi``'s name
   and power limit (fails without a CUDA device);
2. build the kernel sources, one ``nvcc`` each, all started together: the
   Monte-Carlo path kernels (``csrc/mc_paths.cu``), every instantiation
   (libors K, factors F) of the single-swaption LMM path kernels
   (``csrc/lmm_swaption_paths.cu``) that phases 15-17 launch, and every
   one (K, F, row chunk R) of the ATM-surface kernel
   (``csrc/lmm_atm_products.cu``) and of the stoch-vol kernel
   (``csrc/lmm_stochvol_products.cu``) that phases 3-9 launch, and the
   stoch-vol backend's Black inversion kernel (``csrc/black_residuals.cu``)
   (those three without FMA contraction); print each build's
   seconds and ptxas' register/spill report;
3. the ATM kernel against its plain PyTorch version on the card at the ATM
   shapes: 100,000 paths B=1 NORMAL, 100,003 paths (ragged tail), and the
   FD-Jacobian batch B=87 at 8,192 paths DISPLACED (the build that the
   B=87 launch of phase 5 runs), then a synthetic sweep on 37 libors with
   2 factors (a partial row chunk, 8,197 paths, B=3, DISPLACED); a launch's
   float64 partials ``[B, tiles, rows]`` equal the plain partials (the
   kernel's order of additions) bit for bit, and a second launch's too;
4. slice A's main path — the reference's ATM swaption calibration at
   100,000 paths with the 5,000-path engine Jacobian and kernel residuals,
   warmed up once, then timed; it must reach |mean_dev| < 2e-4 and
   rms_dev < 2e-4 and go through the kernel (launch count > 0, one launch
   per residual call of the timed run); a second, instrumented run prints
   where the wall goes;
5. ATM kernel time at the main path's shape and at the FD batch B=87:
   the launch alone on prepacked parameter sets and preallocated partials
   (a spin kernel keeping the host's submission outside the CUDA events),
   the wrapper, and the plain version at B=1 (median of 5 after a
   warm-up);
7. the stoch-vol kernel against its plain version on the card, on the
   benchmark setup at its initial parameters and the reference's Mersenne
   realization: 81,920 paths at B=1 and the FD-Jacobian batch B=17 (the
   main path's two launch shapes), 81,923 paths (ragged tail), and B=17 at
   8,192 paths, then the synthetic sweep on 37 libors with 5 factors
   (8,197 paths, B=3); the partials bit for bit, as in phase 3; then the
   kernel-vs-engine residual gap at the first curated basin (fails above
   5e-3 vol);
8. slice B's main path — the reference's stoch-vol benchmark calibration
   (LIBORMarketModelCalibrationTest) at 81,920 paths on its Mersenne
   realization, every program warmed up, then
   ``calibrate_multistart(target_rms19=0.00198, kernel_backend=...)``
   timed; it must go through the kernel and the Black inversion kernel
   (each: launches = backend residual + Jacobian calls), give 15 finite
   deviations with |mean| < 1e-2 (the
   reference test's assert), an engine-oracle rms19 < 0.25%, and kernel
   residuals within 5e-5 of the engine's at the initial point; its
   ``stages`` dict splits the wall by stage, and the calls of each kind
   (kernel, reduced-path engine, oracle, analytic) are counted and timed;
9. stoch-vol kernel time at B=1 and B=17, 81,920 paths, as in phase 5:
   the launch alone, the wrapper and the plain version (median of 5, CUDA
   events); then the Black inversion kernel (``ops/black_residuals.py``)
   on the backend's own values at the calibrated parameters, B=1 and
   B=17: against its plain version within 1e-12 absolute (the elements
   equal bit for bit printed), the launch through its wrapper behind a
   spin and the plain version timed as above;
10. the path kernels' device generator: ``philox_normals`` bit for bit
    against the plain Philox on the card (1M normals); the Box-Muller
    radius and angle of all 2^24 values of a word's top 24 bits
    (``box_muller_parts``, the kernels' device functions) bit for bit
    against torch's ``log``, ``sqrt``, ``cos`` and ``sin`` on the card,
    which with the final product proves every normal the kernels can draw
    equal to the plain version's; and the moments of 20M normals within 5
    standard errors of N(0, 1)'s;
11. the European and Asian path kernels against their plain versions on
    the card at 1,000,000 x 100, 1,000,003 x 99 (ragged tail, odd step)
    and 8,192 x 1: every path bit for bit, a second launch too;
12. slice C's main path, the reference's MonteCarloBlackScholesModelTest
    at its full size (1M paths, 100 steps, S0 1, r 0.05, sigma 0.3, T 1,
    K 1.05): (a) the object API on the port's torch stream, (b) the same
    on the reference's Mersenne stream, (c) ``mc_european_call_price_kernel``
    — each within 0.005 of the analytic price, (c) also within 4 standard
    errors — and (d) ``mc_asian_call_price_kernel`` against the plain
    ``mc_asian_call_price`` within 4 combined standard errors, with
    0 < Asian < European; one launch per kernel call; then each route's
    wall (min of 3 after a warm-up);
13. a vector-engine sweep on the card: eleven ``RandomVariableTorch``
    operations at 1M paths against ``RandomVariableFloat`` at the JAX
    parity sweep's tolerances, and the float64 reductions against NumPy;
14. the European and Asian kernels against their plain versions, timed at
    1M x 100 (median of 5, CUDA events): the launch alone into a
    preallocated output (a spin kernel keeping the host's submission
    outside the events), the wrapper and the plain version;
15. the four single-swaption launchers (the 1-factor and the stoch-vol
    kernel, each drawing its own normals or reading injected ones) against
    their plain versions on the card, on the two configurations of phase
    16: 409,600 paths at 10 steps, 409,603 paths (ragged tail) and 8,192
    paths at one step; every path bit for bit (``torch.equal``), a second
    launch too, and each PRNG launch bitwise equal to the injected launch
    fed its own stream;
16. slice D1's main path, ``bench.py:1007 bench_lmm_pricer_kernels`` at
    409,600 paths through the port's entry points: the 5Y x 10Y ATM
    swaption of the ATM setup (80 libors, 1 factor) and the 5Y x 10Y ATM
    swaption of the benchmark setup (40 libors, 5 factors, stoch vol), at
    their initial parameters; each kernel price within 2% of the port's
    engine on another stream (printed in combined standard errors too),
    and within 1e-5 of it on one shared normal block; one launch per
    pricer call; the four prices printed to 9 digits; then the walls (min
    of 5 after a warm-up) of the engine's ``values`` and of the kernel
    entry point;
17. the four launchers against their plain versions, timed at 409,600
    paths (median of 5, CUDA events): the launch alone on a prepacked
    table (the host's submission kept outside the events), the payoffs
    wrapper (which packs the table) and the plain version;
18. the Longstaff-Schwartz regression on the card at 100,000 paths, on
    the Bermudan's basis {1, annuity, swap, swap^2} from phase 19's setup:
    the float64 betas against NumPy's least squares of the same
    Tikhonov-regularized problem (backward error under 1e-8, betas within
    cond(G) * 1e-15 relative: the Gram's condition number is about 1e11),
    ``regression_fit_predict`` on the card within 2 float32 ulps of the
    same call on the CPU;
19. BASELINE configuration 3, ``bench.py:982 bench_bermudan`` through the
    port: the ATM model (80 libors, 1 factor), 100,000 paths, exercises
    (4, 8, 12, 16), maturity 20, strike 0.01, at the initial parameters:
    the value, the duality bounds (lower <= upper, the value inside them
    to 3e-4, a gap under 25%), the share of paths exercised at each date,
    the value at least the largest European at the exercise dates and a
    single-exercise Bermudan equal to the European (3e-4, both on the
    pricer's own increments), and the wall (min of 3 after a warm-up);
20. BASELINE configuration 5, ``bench.py:1135 bench_aad_greeks``: route 1,
    ``torch.autograd`` through the differentiable 1M x 100 pricer (delta
    within 0.02, vega within 0.05 of the analytic), route 2, the tape's
    delta at 500,000 paths (within 0.02), and the LMM tape vega of the
    eager swaption valuation with the AAD factory (within 2e-3 of a
    central difference on the same increments), each with its wall;
21. BASELINE configuration 1, ``bench.py:862 bench_eager_ops`` at 100,000
    paths: eager, lazy (bit for bit equal to eager, through CUDA graphs)
    and the float oracle (within 1e-5), the 8-chain batch through
    ``averages`` (one new program; new scalars add none), each wall, and
    the break-even sweep of lazy against the float oracle at 500k, 1M and
    4M paths;
22. the matched-quality row, ``bench.py:641 bench_stochvol_matched``,
    through the public API at full width: the benchmark setup at 81,920
    scrambled Sobol paths (``brownian="sobol"``, seed 0), K = 3
    realizations (the engine's own and Sobol seeds 1, 2) on one
    ``StochVolKernelCalibration``, every program warmed before the
    threads; per realization, concurrently, the better of the first two
    curated basins, a 40-evaluation trust-region leg and a 250-evaluation
    tight leg; then 4 jittered restarts (1%, ``default_rng(11)``, 120
    evaluations) on the best realization, concurrently; the final ranking
    by the engine oracle on that realization (``set_increments``). It
    fails unless the kernel residuals are within 5e-5 of the engine's at
    the initial point on realization 0, the products kernel's and the
    Black inversion kernel's launches each equal backend calls,
    rms19 < 0.25% and |mean deviation| < 1e-2; it prints both oracles'
    rms19 per realization and restart, the wall of the chains and of the
    restarts (the Sobol generation outside it) and whether the published
    0.198% was reached;
23. ``bench.py:1232 bench_parity_1e6``: the float32 engines against the
    float64 parity engine on one stream, each within 1e-6 relative:
    ``mc_european_call_price`` at 1M x 100, the ATM setup's 144 values at
    10,000 paths, the stoch-vol benchmark at 16,384 paths; at the first
    curated basin the trimmed criterion (fewer than 0.5% of paths with a
    pathwise gap of 1e-3 or more, the kept mean within 1e-6); the strict
    tier, the card's float64 ``pathwise_values`` against the CPU's on the
    Mersenne stream (printed, not a gate); the float64 engine's ``values``
    wall over the float32's at 16,384 and 409,600 paths;
24. the engine options at full width: antithetic, predictor-corrector and
    the terminal measure on the ATM setup at 100,000 paths, each within 5
    combined standard errors of the default; the configuration of
    ``tests/test_measures_and_statespace.py`` at 1,000,000 paths (a
    lognormal caplet within 2% of Black, a grid twice as fine within 5%
    of the tenor grid, the terminal E[1/N] within 1% of the discount
    factor); the terminal-measure Bermudan at phase 19's configuration
    (within 3e-4 of phase 19's value, its bounds ordered and around it);
    the forward-delta ladder of ``bench.py:1204-1229`` route 3 (ATM,
    100,000 paths, 80 buckets, the largest within 2e-3 of a float64
    central difference on the same increments), its wall (min of 3 after
    a warm-up) and peak device memory; each phase prints its seconds;
25. ``bench.py:1474 bench_exposure`` at full width: the ATM
    setup (80 libors, 1 factor) at 50,000 paths and its initial
    parameters; the 19-date EE/ENE/PFE profile of the 10Y par payer swap
    over periods [4, 20) at quantiles (0.95, 0.99): the cold call and the
    min of 5 warm walls, peak EE, peak PFE99, the CVA at a 100 bp hazard,
    the martingale error under 1e-3; then the 20-trade netting set drawn
    from ``numpy.random.default_rng(7)`` as the bench draws it: its walls,
    peak netted and standalone EE, the netting benefit, the martingale
    error under 2e-3. Every profile collects each date in one launch of
    the collector kernel (``csrc/exposure_collect.cu``): the netting set's
    six profiles launch it once a date each (``LAUNCHES``, zeroed just
    before them), and on one simulation of its float32 paths (a tail
    block: 50,000 is not a multiple of 128) each date's launch against
    the plain version on the same forwards: the same broken paths, 1/N
    bit for bit, every output within 1e-4 (the worst case of 39-term
    float32 annuities summed in another order at these notionals), the
    device times of both over the dates and the bound from the bytes;
    phase 27 checks the mixed set's underlyings the same way;
26. ``bench.py:1558 bench_cva_deltas`` on phase 25's swap engine: the
    80-bucket dCVA/dL0 ladder at a 1.2% hazard from one reverse pass (cold
    call, min of 3 warm walls, peak device memory), all finite, every
    bucket from the swap's last index on exactly 0.0, the largest within
    2e-3 of a float64 central difference of the same CVA on the same
    paths;
27. the XVA extensions at 50,000 paths: a mixed netting set (two swaps, a
    European and a Bermudan swaption) without and with a zero-threshold,
    zero-MTA CSA lagged one date (its gross rows equal the plain
    profile), FVA on the residual profile and dynamic IM with MVA on the
    20-trade set (each equal to its rectangle rule), the single-swaption
    engine (its forward value flat to expiry within 1e-10); each wall;
28. the smile layer: ``mc_sabr_implied_vols`` at 1,000,000 paths x 64
    steps (``bench.py:1808-1816``; within 0.006 of Hagan), its walls;
    ``calibrate_sabr`` recovering the parameters from Hagan quotes; a
    caplet strip from price quotes and its repricing; the 3Y cap on a
    lognormal LMM driven by the stripped curve at 100,000 paths (within 3%
    of the quote); one CMS caplet by replication (caplet - floorlet =
    swaplet);
29. the hybrid asset-LMM on the ATM model at 100,000 antithetic paths, 79
    dates (an equity and an FX rate): martingale errors, 10Y put-call
    parity, a five-trade profile and an autocallable;
30. the Hull-White slice at ``bench.py``'s widths: the 1M-path swaption
    against Jamshidian and the 10Y curve, the 1M-path Bermudan against the
    PDE, a 1M-path TARN against the inverse floater, the calibration;
31. ``bench.py:1937 bench_credit_wwr`` (no kernel): the survival curve
    bootstrapped from five CDS quotes, CIR++ on Hull-White, the 10Y payer
    swap's wrong-way CVA at 500,000 antithetic paths and 4 CIR substeps at
    rho 0.6, 0 and -0.6 (contributions sum to the CVA, the last one zero,
    rho 0 factorizes within 3% and tracks the curve within 3e-3, the CVA
    increases in rho), its walls (cold, min of 5 warm) and peak device
    memory; the survival error at rho +-0.6 printed beside rho 0's, not
    gated (the reference's substep correlation, ``ROADMAP.md`` Queue 3);
    a 500,000-path ``CIRPPSimulation`` whose 5Y CDS legs match
    ``cds_legs``;
32. ``bench.py:2047 bench_cross_currency`` (no kernel): 1,000,000
    antithetic paths over 20 semiannual steps, the 5Y FX options within
    4.5 standard errors of the closed form, the forward, the 10Y CCS legs
    at par, the martingale diagnostics, and the exposure engine on
    ``tests/test_cross_currency.py``'s trades (the CCS's EE against the FX
    option, its forward value, EE + ENE = FV, a mirrored pair netting to
    zero, an FX forward, a foreign basis); each call's walls;
33. Jarrow-Yildirim, ``tests/test_inflation.py``'s model at 1,000,000
    paths over 20 semiannual steps (no kernel): the YoY forwards, caplets
    and floorlets within 4 standard errors of the moment propagation, the
    forwards closer than the naive ratio, a ZCIS; the walls;
34. ``bench.py:1676 bench_exotics``' single-asset legs (no kernel): the
    1M x 250 Black-Scholes facade on the port's torch stream (S0 100, r
    5%, sigma 30%, T 1, seed 42); the digital at 105 within 4 standard
    errors + 1e-4 of the closed form, the 12-date Asian plain and with the
    geometric control variate (within 4 plain standard errors of each
    other, the error cut at least 5x), the bridge up-and-out (100, 130)
    within 4 standard errors + 1e-3 of the continuous closed form, the
    floating lookback call inside ``tests/test_equity_products.py``'s BGK
    band, the 20-product book of ``bench.py:1754-1763`` through
    ``price_portfolio`` equal to the serial loop within 1e-12; each call's
    walls (a cold one, then the min of 3) and the peak device memory;
35. ``bench.py:1781-1806``: three correlated assets, 1M paths x 30 steps
    to T 1.5, seed 11; the exchange within 4 standard errors of Margrabe,
    the call on the minimum of the first two within 4 of Stulz, the
    geometric-CV basket printed; the walls;
36. ``american_ls_put_1m_x50`` (``bench.py:1662-1672``: 1M x 50, K 110,
    seed 77) against CRR at 4,000 steps under ``tests/test_american.py``'s
    bounds; the delta hedge of the 105 call on phase 34's facade
    (|value - premium| < 0.25) and the variance swap's fair strike within
    4 sigma^2 sqrt(2 dt) of sigma^2; the walls;
37. the forward-start, cliquet, compound, chooser and two-date express
    autocallable at 1M paths x 50 steps (seed 21) within 4 standard errors
    of their closed forms (the JAX tests' wider bounds for the chooser and
    the autocallable); importance sampling at 3x spot (1M paths, seed 13)
    within 4 standard errors of Black-Scholes, its standard-error reduction
    printed; ``mlmc_lookback_call`` at eps 0.03 within 2.5 eps of the
    continuous closed form, its levels, samples and walls;
38. ``bench.py:1616-1625``'s ``heston_qe_1m_x64`` and the Euler engine at
    1M antithetic paths x 128 steps against the characteristic-function
    prices (``tests/test_heston.py:113-121``'s bounds, E[V_T] within 3e-3
    of the CIR mean); ``MonteCarloHestonModel`` at 1M x 100 on
    ``tests/test_heston_facade.py``'s parameters (its bounds, the digital
    cash parity within 1e-9 once the paths that land exactly on the strike
    are counted, the peak memory); ``calibrate_heston``'s round trip in
    host seconds;
39. ``merton_1m_x16`` and ``variance_gamma_1m_x16`` (``bench.py:1627-1643``)
    against the series and the Fourier prices, Bates at 1M x 96 against its
    characteristic function, Bachelier and the displaced lognormal at 1M
    paths within 4 standard errors, the Merton facade at 1M x 50;
40. Dupire local vol on ``tests/test_local_vol.py``'s skewed surface at 1M
    x 100 (the Gyongy round trip within 0.004) and the flat surface against
    term-vol Black-Scholes; one step's nested ``jvp`` under
    ``torch.cuda.set_sync_debug_mode("error")``;
41. ``bench.py:1869 bench_slv`` at 409,600 x 100: the smile within 0.008,
    E[V_1] within 0.004 of the CIR mean, the martingale, ``leverage_at``,
    the wall, the peak memory and the device operations a step;
42. ``bench.py:2007 bench_portfolio_credit``: the Gaussian copula on 125
    names (hazards and betas from ``default_rng(1)``) at 1M antithetic
    paths (seed 7), horizons 1-10 years, the 3-7% tranche and P(>= k) for
    k = 1, 5, 10: the ETL at every horizon within 4 standard errors + 1e-6
    of the exact recursion, P(>= k) at 5 years within 5 standard errors +
    1e-4 of it, both monotone in t (``tests/test_portfolio_credit.py``'s
    bounds); the walls and the peak memory;
43. Schwartz-Smith on ``tests/test_commodity.py``'s model at 1M antithetic
    paths x 24 monthly steps: the futures martingale (4 standard errors +
    1e-9), calls and puts on the 2-year future against Black-76 and the
    calendar spread against Margrabe (4.5 standard errors + 1e-6);
44. full-revaluation market risk on ``tests/test_risk.py``'s convex book at
    1M scenarios (ES > VaR > 0, the Euler allocation summing to the ES
    within 1e-9), the delta book against delta-normal within 2%, the
    historical estimator on 500 seeded days; SA-CCR EAD and KVA on phase
    25's 10-year par-swap exposure profile at 50,000 paths (host);
45. the PDE layer at the JAX package's shapes: one European call and put
    (200 x 401) within 2e-3 of Black-Scholes, an 81-strike strip, a 32-vol
    x 81-strike ladder (200 x 401 x 2,592; its bound at the test's strikes
    90-110) and an 81-strike American put strip (400 x 801) within
    ``tests/test_pde.py``'s bounds and of CRR, the digital (400 x 800), the flat and the skewed SSVI local-vol call (200 x
    401; the flat within 4e-3 of Black-Scholes, the skewed within 4
    standard errors + 0.02 of the port's local-vol Monte Carlo at 200,000
    paths), vega by autograd within 2% of the closed form; the skewed call
    on the card against the CPU within 1e-12 relative; the walls and the
    device operations a step;
46. path-axis sharding over torch.distributed, each world spawned as child
    processes (``parallel.launch``) and joined with a deadline: (a) an
    NCCL world of one on ``cuda:0`` runs the ATM setup at full width
    (100,000 paths, the 5,000-path Jacobian engine) meshed on the
    unsharded engines' own increments, within the float64 reduction gap
    of them (values 1e-12 relative, residuals and Jacobian 1e-9), the
    kernel backend refusing the meshed engine, then the warm start and the
    LM calibration on engine residuals (|mean_dev| < 2e-4); (b) a gloo
    world of two ranks sharing the card (collectives staged through host
    memory): the ATM residuals and Jacobian against (a)'s, bitwise-equal
    parameters on both ranks after two LM iterations, the stoch-vol engine
    at 81,920 Mersenne paths and the Black-Scholes facade at 1M x 100
    (European, Asian, barrier, lookback) against the unsharded ones, and
    ``mc_price_sharded`` at 1M paths within 4 standard errors of the
    analytic price; the walls, the seconds in collectives and the peak
    memory per rank (two ranks on one card are no scaling figure);
47. path-axis sharding of the XVA engines, the hybrid and the rates,
    credit, FX, inflation, copula, commodity and market-risk simulations,
    worlds as in phase 46: (a) an NCCL world of one runs phase 25's swap
    profile (80 libors, 50,000 paths, 19 dates) and its 80-bucket CVA
    ladder meshed on the unsharded engine's increments, within 1e-12 of
    it (the PFE too; the CVA 1e-10 relative, the ladder rtol 1e-6 / atol
    1e-10); (b) a gloo world of two ranks on the card runs, each against
    the unsharded port on the same normals, the swap profile and ladder,
    the 20-trade set and its IM, phase 27's mixed set with and without a
    CSA (50,000 paths each), phase 29's hybrid on the ranks' own streams
    (100,000 paths; against the unsharded hybrid fed their draws),
    Hull-White with a TARN and a Bermudan (1M), the WWR CVA (500,000),
    cross-currency with its exposure engine and Jarrow-Yildirim (1M
    each), the copula on 125 names (1M), Schwartz-Smith (1M x 24) and the
    VaR report (1M scenarios), at ``tests/test_torch_exposure_mesh.py``'s
    and the JAX mesh tests' bounds; each part's gap, rank wall,
    collectives, seconds in them and peak memory a rank;
48. path-axis sharding of Heston-SLV and the remaining equity products,
    worlds as in phase 46 but started together: (a) an NCCL world of one
    and (b) a gloo world of two ranks on the card run phase 41's SLV (409,600 x 100: the call
    grid, ``leverage_at``, the terminal state, the fits of the first two
    steps on one cloud), phase 40's local-vol call grid (1M x 100), phase
    34's delta hedge and variance swap (1M x 250), phase 36's LS put (1M x
    50, split and in-sample, every path's cashflow) and phase 37's
    structured products (1M x 50), each against the unsharded port on the
    same stream at ``tests/test_torch_slv_products_mesh.py``'s bounds;
    (c) the utilities on the card (memory info around a 1 GiB tensor,
    ``live_device_arrays``, a Chrome trace of one ``bs_paths_kernel``
    launch in a fresh process that names the kernel (this process's
    trace printed), the ATM checkpoint round trip with bit-equal
    residuals); (d) examples 01-04 at their default sizes (02's
    fused price one ``bs_paths_kernel`` launch, 04 on NCCL ranks);
49. examples 05-16 (``finmath_tpu_torch/examples``) at their default
    sizes, one after another in this process, every kernel count set to 0
    before each and read after it: each script's own asserts; 05 takes
    exactly one ``bs_paths`` and one ``lmm_swaption_paths`` launch, its
    fused price within 0.005 of the analytic value; 16's timed
    ``residuals_and_jacobian`` is exactly one ``lmm_stochvol_products``
    launch (B = 17, 81,920 Sobol paths), within 5e-5 of the engine's
    residuals; each script's wall, kernel launches (the Black inversion
    kernel's among them) and key numbers printed;
6. with ``--profile`` only, last: device operations and busy time under
   ``torch.profiler`` for one ATM calibration, one engine Jacobian, one
   ATM kernel residual call, one stoch-vol kernel
   ``residuals_and_jacobian`` call and one reduced-path stoch-vol engine
   Jacobian, and for phases 25-45 one swap and one 20-trade profile, one
   CVA ladder, one mixed-set profile, one IM profile, one SABR smile, the
   hybrid's and Hull-White's calls, one WWR CVA and one CIR++ simulation,
   one cross-currency and one Jarrow-Yildirim simulation, and phases
   34-37's book, bridge barrier, multi-asset simulation, LS put, delta
   hedge and MLMC run, phases 38-41's engines and simulations, and phases
   42-45's copula statistics, Schwartz-Smith simulation, parametric VaR,
   ladder and local-vol solve, each against the same call's unprofiled
   wall.

Then the whole script's seconds, one JSON line with the ten kernels'
numbers (``bound_ms`` is the least time of the same work on an
H100: the larger of the operations counted from the shapes over the
published 67 TFLOP/s float32, integer operations included, and the bytes
over 3.35 TB/s; that peak counts an FMA as two operations, so a kernel that
issues none, as the slice D1 pricers do, can reach at most half of it;
the float64 Black inversion's operations over the published 34 TFLOP/s
float64; the collector's bytes alone)
and, last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before those lines; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PATHS, JAC_PATHS, SEED = 100_000, 5_000, 31415
SV_PATHS, SV_SEED, SV_TARGET_RMS19 = 81_920, 314151, 0.00198
# MonteCarloBlackScholesModelTest: S0, r, sigma, T, K; 1M paths x 100 steps
BS_PARAMS, BS_PATHS, BS_STEPS, BS_SEED = (1.0, 0.05, 0.3, 1.0, 1.05), \
    1_000_000, 100, 3141
# bench.py:1007 bench_lmm_pricer_kernels: one swaption at 409,600 paths
PRICER_PATHS, PRICER_SEED = 409_600, 2718
PRICER_E, PRICER_M, PRICER_DT = 10, 20, 0.5   # exercise step, periods, dt
# the products kernels' shapes: (libors, factors) of the ATM and benchmark
# setups, and the synthetic sweep of phases 3d / 7e (37 libors: a partial
# chunk of rows)
ATM_SHAPE, SV_SHAPE = (80, 1), (40, 5)
SYN_LIBORS, SYN_PATHS, SYN_B = 37, 8_197, 3
SYN_PRODUCTS = ((2, 10, 0.021), (2, 30, 0.02), (5, 4, 0.022),
                (5, 32, 0.0205), (11, 26, 0.02))
# bench.py:982 bench_bermudan (BASELINE configuration 3); the tape AAD
# route of bench.py:1135 bench_aad_greeks; bench.py:862 bench_eager_ops
BERMUDAN_PATHS, BERMUDAN_EXERCISES = 100_000, (4, 8, 12, 16)
BERMUDAN_MATURITY, BERMUDAN_STRIKE = 20, 0.01
TAPE_PATHS, EAGER_PATHS = 500_000, 100_000
# bench.py:641 bench_stochvol_matched: realizations and restarts; the
# path count of tests/test_measures_and_statespace.py's configuration
MATCHED_K, MATCHED_RESTARTS, MEASURE_PATHS = 3, 4, 1_000_000
# bench.py:1474 bench_exposure's paths; bench.py:1808-1816's SABR smile;
# the caplet repricing of phase 28
EXPOSURE_PATHS, SABR_PATHS, CAPLET_PATHS = 50_000, 1_000_000, 100_000
# phase 29's hybrid (antithetic) and phase 30's Hull-White paths
HYBRID_PATHS, HW_PATHS = 100_000, 1_000_000
# bench.py:1937 bench_credit_wwr's paths (phase 31) and bench.py:2047
# bench_cross_currency's (phases 32-33)
CREDIT_PATHS, XCCY_PATHS = 500_000, 1_000_000
# bench.py:1676 bench_exotics' 1M x 250 Black-Scholes facade (phases 34,
# 36), its three-asset 1M x 30 facade (35), bench_model_zoo's
# american_ls_put_1m_x50 (36), the 1M-path structured products, importance
# sampling and the MLMC accuracy of phase 37
EXOTIC_PATHS, EXOTIC_STEPS, MULTI_PATHS = 1_000_000, 250, 1_000_000
AMERICAN_PATHS, STRUCTURED_PATHS, MLMC_EPS = 1_000_000, 1_000_000, 0.03
# bench.py:1616-1643 bench_model_zoo's Heston, Merton and VG rows and the
# rest of phases 38-40 at 1M paths; bench.py:1869 bench_slv's particles
HESTON_PATHS, JUMP_PATHS, LOCAL_VOL_PATHS = 1_000_000, 1_000_000, 1_000_000
SLV_PATHS = 409_600
# bench.py:2007 bench_portfolio_credit's paths (phase 42); the 1M-path
# Schwartz-Smith simulation and market-risk scenarios of phases 43-44
COPULA_PATHS, COMMODITY_PATHS, RISK_SCENARIOS = 1_000_000, 1_000_000, 1_000_000
# phase 45: the strip's strikes, the ladder's vols (BENCHMARKS.md's
# finite-difference shapes) and the local-vol Monte Carlo's paths
PDE_STRIKES, PDE_VOLS, PDE_MC_PATHS = 81, 32, 200_000
# the published H100 SXM peaks the bound is taken against
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_F64_FLOPS = 34e12
SPIN_CYCLES = 2_000_000       # about 1 ms of the card's clock


def _sweep_operations(num_libors, num_factors, products, paths, B, *,
                      stoch_vol, displaced=False):
    """Float32 operations of one LMM path sweep as the kernels do it (an
    FMA counted as two), from the shapes: per step and alive libor the
    drift term (3), the update and clamp (5) and per factor the loading
    and three running sums (6, +1 with a local factor); the local factor
    itself (displaced 1, blended times sqrt(V) 4); per step the normals'
    scaling, the numeraire (3) and for stoch vol exp(log V / 2) and the
    log V step (10); per exercise step the running bond product (6 a
    period) and per product the payoff, its masking and its path sum
    (7), plus the ATM kernel's numeraire-adjustment row (2)."""
    n, F = num_libors, num_factors
    S = products[-1][0]
    local = 4 if stoch_vol else (1 if displaced else 0)
    per_libor = 8 + local + F * (6 + int(stoch_vol or displaced))
    per_step = F + 3 + (10 if stoch_vol else 0)
    ops = sum(per_step + (n - 1 - s) * per_libor for s in range(S))
    by_step = {}
    for e, m, _ in products:
        by_step.setdefault(e, []).append(m)
    for ms in by_step.values():
        ops += 6 * max(ms) + 7 * len(ms) + (0 if stoch_vol else 2)
    return ops * paths * B


def _pricer_operations(num_factors, steps, exercise, periods, paths, *,
                       stoch_vol):
    """Float32 operations of one single-swaption pricer launch as
    ``csrc/lmm_swaption_paths.cu`` does them, each add, multiply, divide
    and compare counted once (the kernels issue no FMA), from the shapes:
    per step and alive libor below the swap's end and the last fixing (the
    libors above reach neither the numeraire nor the payoff, and no kernel
    needs to evolve them) the 1-factor update (9: the drift term's four,
    the running sum, its scaling, the shock, the loading, the new L) or the
    stoch-vol one (12 + 7 a factor: m_j 3, the local factor 4, per factor
    the loading, the running sum and the drift and shock sums 7, the new L
    and its clamp 5); per step the scaled normals (F) and the numeraire
    (3), and for stoch vol sqrt(V) (about 8), the V step (8) and its expf
    (about 20); per path the payoff (6 a period and 5) and the stoch-vol
    constants (4). The PRNG variants' draws are the caller's to add."""
    F, S = num_factors, steps
    swept = max(exercise + periods, S)
    alive = sum(swept - 1 - s for s in range(S))
    if stoch_vol:
        per_libor, per_step, per_path = 12 + 7 * F, F + 3 + 8 + 8 + 20, 4
    else:
        per_libor, per_step, per_path = 9, F + 3, 0
    return (alive * per_libor + S * per_step + per_path + 6 * periods + 5) \
        * paths


def _bound(args, out, operations, peak_flops=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over the
    ``peak_flops`` (float32 unless given) and the bytes (each input tensor
    read once, the output written once) over the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        out.numel() * out.element_size()
    by_ops = operations / peak_flops
    by_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


#: operations of one draw of four normals (``csrc/philox.cuh``):
#: Philox4x32-10's 10 rounds of two 32-bit multiply-highs, two
#: multiply-lows and four XORs (80; the key schedule is formed once a
#: launch, not a draw), and two Box-Muller pairs at about 37 float
#: operations a normal with the accurate logf, sqrtf, sinf and cosf (148)
DRAW_OPERATIONS = 80 + 148


def _black_residuals_operations(elements, num_iter):
    """Float64 operations of one Black inversion launch as
    ``csrc/black_residuals.cu`` does them, each add, multiply, compare and
    select counted once, a division at about 10 (the IEEE sequence), a
    libdevice ``erfc`` at about 60, ``exp`` and ``log`` at about 25 and
    ``sqrt`` at about 10: per element and Newton step the total vol and
    d1, d2 (16), the two ``erfc`` and the twin's value (126), vega (29),
    the damped step (12) and the clamps (7), 190 in all; per element the
    seed, the time value and the weighting (about 65)."""
    return elements * (190 * num_iter + 65)


def _mc_path_operations(paths, steps, asian):
    """Operations of one Monte-Carlo path kernel launch, counted from the
    shapes as ``csrc/mc_paths.cu`` does the work: per draw of four normals
    (ceil(steps / 4) a path) ``DRAW_OPERATIONS``; per step the path update
    (2 for the European kernel's paired steps, 3 plus an expf of about 20
    and the running sum's add for the Asian one); per path the payoff
    (expf, subtract, max: 22; the Asian divide and max: 3)."""
    draws = -(-steps // 4)
    per_path = draws * DRAW_OPERATIONS
    per_path += steps * (24 if asian else 2) + (3 if asian else 22)
    return per_path * paths


def _mc_bound(paths, steps, asian):
    """(bound_ms, bound_by) of one Monte-Carlo path kernel launch: its
    operations (``_mc_path_operations``) over the float32 peak against its
    float32 payoffs over the memory rate."""
    by_ops = _mc_path_operations(paths, steps, asian) / PEAK_F32_FLOPS
    by_bytes = 4 * paths / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def _sweep_variants(products, lmm_kernel, lmm_stochvol_kernel,
                    swaption_paths):
    """The instantiations (K, F, R) of the two products kernels that phases
    3-9 launch (the calibrations' shapes and the synthetic sweep) and
    (K, F) of the pricer kernels that phases 15-17 launch (the two
    configurations of ``bench_lmm_pricer_kernels``; the stoch-vol one at
    the libors it sweeps at ``PRICER_E`` and at one step)."""
    return {lmm_kernel: [products.sweep_variant(*ATM_SHAPE),
                         products.sweep_variant(SYN_LIBORS, 2)],
            lmm_stochvol_kernel: [products.sweep_variant(*SV_SHAPE),
                                  products.sweep_variant(SYN_LIBORS, 5)],
            swaption_paths: [swaption_paths.pricer_variant(*ATM_SHAPE)] + [
                swaption_paths.pricer_variant(
                    *SV_SHAPE, swaption_paths.swept_libors(e, e, PRICER_M))
                for e in (PRICER_E, 1)]}


def _synthetic_sweep(torch, kind):
    """Seeded inputs of the synthetic sweep on the card: 37 libors, B = 3
    parameter sets, 8,197 paths; ATM with 2 factors DISPLACED, stoch vol
    with 5 factors from benign to a curated-basin-like set."""
    rng = np.random.default_rng(97)
    n, B, S = SYN_LIBORS, SYN_B, SYN_PRODUCTS[-1][0]
    F = 2 if kind == "atm" else 5
    rows = F if kind == "atm" else F + 1
    z = rng.standard_normal((S * rows, SYN_PATHS)).astype(np.float32)
    scal = np.zeros((B, 8), np.float32)
    scal[:, 0], scal[:, 1] = 0.5, np.sqrt(0.5)
    if kind == "atm":
        volT = (0.003 + 0.003 * rng.random((B, F * n, S))) / 4.02
        scal[:, 2] = 4.0
    else:
        volT = (0.1 + 0.2 * rng.random((B, F * n, S))) / np.sqrt(F)
        for b, (blend, nu, rho) in enumerate(((0.2, 0.3, 0.2),
                                              (0.6, 0.8, -0.4),
                                              (1.4, -1.4, -0.76))):
            scal[b, 2:6] = (blend, nu, rho, np.sqrt(1.0 - rho * rho))
    l0 = 0.02 + 0.002 * np.sin(np.arange(n))
    args = [torch.from_numpy(np.asarray(a, np.float32)).cuda()
            for a in (z, volT, scal, l0, np.full(n, 0.5))]
    kwargs = dict(num_libors=n, num_factors=F, products=SYN_PRODUCTS,
                  num_paths=SYN_PATHS)
    if kind == "atm":
        kwargs.update(events=(2, 5, 11), displaced=True)
    return args, kwargs


def _partials_equal(torch, module, plain, args, kwargs):
    """Two launches of the products kernel ``module`` into fresh partials
    against the ``plain`` partials (the kernel's order of additions): both
    launches must equal them bit for bit. Returns ``(ok, max_abs_err,
    partials)``."""
    outs = []
    for _ in range(2):
        go, partials = module.prepare(*args, **kwargs)
        go()
        outs.append(partials)
    torch.cuda.synchronize()
    ref = plain(*args, **kwargs)
    ok = (bool(torch.isfinite(outs[0]).all())
          and all(bool(torch.equal(p, ref)) for p in outs))
    return ok, float((outs[0] - ref).abs().max()), outs[0]


def _check_synthetic(torch, module, plain, kind):
    """A products kernel on the synthetic sweep against its ``plain``
    partials, bit for bit (``_partials_equal``). Returns the largest
    absolute error; raises on a failure."""
    args, kwargs = _synthetic_sweep(torch, kind)
    ok, err, _ = _partials_equal(torch, module, plain, args, kwargs)
    if not ok:
        raise SystemExit(f"chip_smoke: the {kind} kernel's partials differ "
                         f"from the plain version's on the synthetic sweep "
                         f"(max_abs_err {err:.3e})")
    return err


def _products_ms(torch, module, wrapper, args, kwargs):
    """(launch alone, wrapper) median ms of the products kernel ``module``
    on the inputs of one ``wrapper`` call: the launch on parameter sets
    packed and partials allocated beforehand, then the whole wrapper."""
    go, _ = module.prepare(*args, **kwargs)
    return (_launch_ms(torch, go),
            _time_ms(torch, lambda: wrapper(*args, **kwargs)))


def _time_ms(torch, fn, reps=5):
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _launch_ms(torch, fn, reps=5):
    """Median device time of ``fn``, which only enqueues launches, over
    ``reps`` runs after one warm-up. A spin kernel holds the stream while
    the host enqueues the start event, ``fn``'s launches and the stop
    event, so the host's submission time falls outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


class _Counted:
    """Counts the calls of a function, from any thread, and adds nothing
    else to them."""

    def __init__(self, fn):
        self.fn, self.calls, self._lock = fn, 0, threading.Lock()

    def __call__(self, *args):
        with self._lock:
            self.calls += 1
        return self.fn(*args)


class _Timed:
    """Counts the calls of a function and their host seconds (synchronised),
    for the breakdown of the calibration wall."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.seconds = torch, fn, 0, 0.0

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _profile(torch, setup, kb, sv, sv_kb, later) -> None:
    """Phase 6 (``--profile``): the device's busy share of one whole ATM
    calibration, of one call of each of its device stages, of one
    stoch-vol kernel ``residuals_and_jacobian`` call, of one call of
    the stoch-vol multistart's dominant stage, the reduced-path engine
    Jacobian, and of the calls ``later`` names (phases 25-45). Each is
    run once unprofiled (host wall, synchronised) and once under
    ``torch.profiler``; the device events of the profiled run (kernels,
    copies, memsets) give the device operation count and busy time, set
    against the unprofiled wall."""
    p0 = setup.covariance.initial_parameters
    sv_p0 = sv.covariance.initial_parameters
    sweep = sv.sweep_engine()
    runs = {
        "calibration": lambda: setup.calibrate(
            max_iterations=60, accuracy=1e-7, warm_start="analytic",
            residual_backend=kb),
        "engine jacobian (5k paths)": lambda: setup.jacobian_engine.jacobian(p0),
        "kernel residuals (100k paths)": lambda: kb.residuals(p0),
        "stoch-vol kernel residuals_and_jacobian (81,920 paths)":
            lambda: sv_kb.residuals_and_jacobian(sv_p0),
        f"stoch-vol engine jacobian ({sweep.num_paths:,} paths)":
            lambda: sweep.jacobian(sv_p0),
        **later,
    }
    out = {name: _device_busy(torch, fn) for name, fn in runs.items()}
    print("phase 6 profile: " + json.dumps(out), flush=True)


def _device_busy(torch, fn) -> dict:
    """``fn`` once unprofiled (host wall, synchronised) and once under
    ``torch.profiler``: the device events of the profiled run (kernels,
    copies, memsets) give the device operation count and busy time, set
    against the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return {"unprofiled_wall_ms": wall_ms, "device_ops": len(device),
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms}


def _slice_c(torch, smi):
    """Phases 10-14: the device generator, the Monte-Carlo path kernels
    against their plain versions, slice C's main path at the reference's
    full size, a vector-engine sweep on the card, and the kernels' times.
    Returns the two kernels' rows of the final JSON line."""
    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, EuropeanOption, MonteCarloBlackScholesModel,
        mc_asian_call_price)
    from finmath_tpu_torch.models.brownian_motion import (
        BrownianMotionFinmathMersenne)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    from finmath_tpu_torch.ops import kernels, lmm_kernel, lmm_stochvol_kernel
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch
    from finmath_tpu_torch.ops.random_variable_float import (
        RandomVariableFloat)

    S0, R, SIGMA, T, K = BS_PARAMS
    analytic = black_scholes_option_value(S0, R, SIGMA, T, K)
    df = float(np.exp(-R * T))

    # -- 10: the device generator against the plain one -------------------
    z = kernels.philox_normals(BS_SEED, 250_000, 1, "cuda")
    bitwise = bool(torch.equal(z, kernels.normal_pairs(BS_SEED, 250_000, 1,
                                                       "cuda")))
    n_bitwise = z.numel()
    # every input of Box-Muller: the radius and the angle of each of the
    # 2^24 values of w >> 8, the kernels' device functions against torch's
    # logf, sqrtf, cosf and sinf on the card, bit for bit
    parts = kernels.box_muller_parts(device="cuda")
    torch.cuda.synchronize()
    plain_parts = kernels.box_muller_parts_reference(device="cuda")
    parts_differ = [int((parts[r].view(torch.int32)
                         != plain_parts[r].view(torch.int32)).sum())
                    for r in range(3)]
    del parts, plain_parts
    big = kernels.philox_normals(BS_SEED + 1, 5_000_000, 1,
                                 "cuda").reshape(-1).double()
    n = big.numel()
    m1 = float(big.mean())
    var = float((big * big).mean()) - m1 * m1
    m4 = float((big ** 4).mean())
    moments = {"|mean|": (abs(m1), 5 / np.sqrt(n)),
               "|var - 1|": (abs(var - 1), 5 * np.sqrt(2 / n)),
               "|E z^4 - 3|": (abs(m4 - 3), 5 * np.sqrt(96 / n))}
    print(f"phase 10 generator: {n_bitwise:,} normals bitwise equal to the "
          f"plain Philox: {bitwise}; Box-Muller on all 2^24 inputs, "
          f"elements differing in a bit (radius, cos, sin): {parts_differ}; "
          f"{n:,} normals: mean={m1:.3e} "
          f"var={var:.6f} E[z^4]={m4:.5f}; "
          + ", ".join(f"{k} {v:.3e} < {b:.3e}" for k, (v, b) in
                      moments.items()), flush=True)
    del z, big
    if not (bitwise and not any(parts_differ)
            and all(v < b for v, b in moments.values())):
        raise SystemExit("chip_smoke: phase 10: the device generator "
                         "disagrees with the plain one or its moments")

    # -- 11: each path kernel against its plain version on the card --------
    runs = {"bs_paths": (kernels.bs_payoffs, kernels.bs_paths_reference),
            "asian_paths": (kernels.asian_payoffs,
                            kernels.asian_paths_reference)}
    max_abs = {name: 0.0 for name in runs}
    for paths, steps in ((BS_PATHS, BS_STEPS), (1_000_003, 99), (8_192, 1)):
        params = kernels.path_params(steps, S0, R, SIGMA, T, K)
        for name, (run, plain) in runs.items():
            got = run(BS_SEED, paths, steps, params, "cuda")
            again = run(BS_SEED, paths, steps, params, "cuda")
            torch.cuda.synchronize()
            ref = plain(BS_SEED, paths, steps, params, "cuda")
            err = (got - ref).abs()
            equal = bool(torch.equal(got.view(torch.int32),
                                     ref.view(torch.int32)))
            repeatable = bool(torch.equal(got, again))
            ok = bool(torch.isfinite(got).all()) and equal and repeatable
            max_abs[name] = max(max_abs[name], float(err.max()))
            print(f"phase 11 {name} vs plain: paths={paths} steps={steps} "
                  f"max_abs_err={float(err.max()):.3e} bit for bit: {equal}; "
                  f"bitwise repeatable={repeatable}", flush=True)
            if not ok:
                raise SystemExit(f"chip_smoke: phase 11: {name} disagrees "
                                 "with its plain version")
            del got, again, ref, err

    # -- 12: slice C's main path at the reference's full size --------------
    td = TimeDiscretization(initial=0.0, num_steps=BS_STEPS, step=T / BS_STEPS)
    model = BlackScholesModel(S0, R, SIGMA)

    def object_api():
        sim = MonteCarloBlackScholesModel(td, BS_PATHS, model, seed=BS_SEED,
                                          device="cuda")
        return EuropeanOption(T, K).get_value(sim)

    def mersenne():
        sim = MonteCarloBlackScholesModel(
            td, BS_PATHS, model, brownian=BrownianMotionFinmathMersenne(
                td, 1, BS_PATHS, BS_SEED, device="cuda"))
        return EuropeanOption(T, K).get_value(sim)

    routes = {
        "a object API": object_api,
        "b object API on the Mersenne stream": mersenne,
        "c European kernel": lambda: kernels.mc_european_call_price_kernel(
            BS_SEED, BS_PATHS, BS_STEPS, S0, R, SIGMA, T, K, device="cuda"),
        "d Asian kernel": lambda: kernels.mc_asian_call_price_kernel(
            BS_SEED, BS_PATHS, BS_STEPS, S0, R, SIGMA, T, K, device="cuda"),
        "d Asian plain loop": lambda: mc_asian_call_price(
            BS_SEED, BS_PATHS, BS_STEPS, S0, R, SIGMA, T, K, device="cuda"),
    }
    lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    values = {name: fn() for name, fn in routes.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the kernels' standard errors, from their payoffs (deterministic: the
    # payoffs the main path averaged)
    params = kernels.path_params(BS_STEPS, S0, R, SIGMA, T, K)
    se = {}
    for name in runs:
        pay = runs[name][0](BS_SEED, BS_PATHS, BS_STEPS, params,
                            "cuda").double()
        se[name] = float(pay.std()) * df / np.sqrt(BS_PATHS)
    euro = values["c European kernel"]
    asian_k, asian_p = values["d Asian kernel"], values["d Asian plain loop"]
    # both Asian estimators have the payoff's distribution: the combined
    # standard error is sqrt(2) times the kernel's
    asian_gap = abs(asian_k - asian_p)
    checks = {
        "a within 0.005 of analytic": abs(values["a object API"] - analytic)
        < 0.005,
        "b within 0.005 of analytic": abs(
            values["b object API on the Mersenne stream"] - analytic) < 0.005,
        "c within 0.005 of analytic": abs(euro - analytic) < 0.005,
        "c within 4 standard errors": abs(euro - analytic)
        < 4 * se["bs_paths"],
        "d kernel vs plain within 4 combined standard errors":
            asian_gap < 4 * np.sqrt(2) * se["asian_paths"],
        "0 < Asian < European": 0 < asian_k < euro,
        "one launch per kernel call": launches == {
            "bs_paths": 1, "asian_paths": 1, "philox_normals": 0,
            "box_muller_parts": 0},
    }
    print(f"phase 12 main path ({BS_PATHS:,} paths x {BS_STEPS} steps, "
          f"S0 {S0}, r {R}, sigma {SIGMA}, T {T}, K {K}; analytic "
          f"{analytic:.7f}): "
          + json.dumps({"values": values, "standard_errors": se,
                        "asian_kernel_minus_plain": asian_k - asian_p,
                        "launches": launches}), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 12 failed: {failed}")
    walls = {}
    for name, fn in routes.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[name] = min(times)
    print(f"phase 12 walls (s, min of 3 after a warm-up; {smi}): "
          + json.dumps(walls), flush=True)

    # -- 13: a vector-engine sweep on the card ------------------------------
    rng = np.random.default_rng(BS_SEED)
    a = (-1.0 + 2.0 * rng.random(BS_PATHS)).astype(np.float32)
    b = (0.1 + 2.0 * rng.random(BS_PATHS)).astype(np.float32)
    ops = [("add", lambda x, y: x.add(y), 1e-7),
           ("mult", lambda x, y: x.mult(y), 1e-7),
           ("div", lambda x, y: x.div(y), 2.5e-7),
           ("exp", lambda x, y: x.exp(), 2.5e-7),
           ("log", lambda x, y: y.log(), 5e-7),
           ("sqrt", lambda x, y: y.sqrt(), 5e-7),
           ("cap", lambda x, y: x.cap(y), 1e-7),
           ("floor", lambda x, y: x.floor(0.2), 1e-7),
           ("discount", lambda x, y: x.discount(y, 0.25), 2.5e-7),
           ("add_product", lambda x, y: x.add_product(y, y), 1e-7),
           ("choose", lambda x, y: x.choose(y, y.mult(-1.0)), 1e-7)]
    dev = (RandomVariableTorch(0.0, a, device="cuda"),
           RandomVariableTorch(0.0, b, device="cuda"))
    host = (RandomVariableFloat(0.0, a), RandomVariableFloat(0.0, b))
    worst = {}
    for name, op, rtol in ops:
        got = op(*dev)
        ref = np.asarray(op(*host).get_realizations(), np.float64)
        diff = np.abs(got.get_realizations().astype(np.float64) - ref)
        worst[name] = float((diff / np.maximum(1.0, np.abs(ref))).max())
        if not (got.values.is_cuda and worst[name] <= rtol):
            raise SystemExit(f"chip_smoke: phase 13: {name} exceeds "
                             f"{rtol} (max scaled error {worst[name]:.3e})")
    b64 = b.astype(np.float64)
    reductions = {"average": (dev[1].get_average(), b64.mean()),
                  "variance": (dev[1].get_variance(), b64.var())}
    red_rel = {k: abs(g - r) / abs(r) for k, (g, r) in reductions.items()}
    print("phase 13 vector engine on the card vs RandomVariableFloat "
          f"({BS_PATHS:,} paths), max |diff| / max(1, |x|): "
          + json.dumps(worst) + "; float64 reductions vs NumPy, relative: "
          + json.dumps(red_rel), flush=True)
    if not all(v < 1e-12 for v in red_rel.values()):
        raise SystemExit("chip_smoke: phase 13: float64 reductions disagree "
                         "with NumPy")
    del dev

    # -- 14: the path kernels against their plain versions, timed ----------
    rows = []
    out = torch.empty(BS_PATHS, dtype=torch.float32, device="cuda")
    p4 = [float(v) for v in params[:4].tolist()]
    for name, source_line in (("bs_paths", 94), ("asian_paths", 185)):
        run, plain = runs[name]
        # the launch alone, into a preallocated output
        ms = _launch_ms(torch, lambda: kernels._launch(
            name, f"mc_{name}_launch", out.data_ptr(), BS_PATHS, BS_STEPS,
            BS_SEED, *p4, device=out.device))
        wrapper_ms = _time_ms(torch, lambda: run(BS_SEED, BS_PATHS, BS_STEPS,
                                                 params, "cuda"))
        plain_ms = _time_ms(torch, lambda: plain(BS_SEED, BS_PATHS, BS_STEPS,
                                                 params, "cuda"))
        bound_ms, bound_by = _mc_bound(BS_PATHS, BS_STEPS,
                                       name == "asian_paths")
        print(f"phase 14 timing (median of 5, CUDA events; {smi}): {name} "
              f"paths={BS_PATHS} steps={BS_STEPS} kernel_ms={ms:.4f} "
              f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "finmath_tpu_torch/csrc/mc_paths.cu",
            "replaces": f"finmath_tpu/ops/kernels.py:{source_line}",
            "launches": launches[name],
            "max_abs_err": max_abs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    return rows


def _pricer_setups(torch):
    """The two configurations of ``bench.py:1007 bench_lmm_pricer_kernels``
    on the card, at their initial parameters: the 5Y x 10Y ATM swaption of
    the ATM setup (80 libors, 1 factor) and of the benchmark setup (40
    libors, 5 factors, stoch vol), exercise step ``PRICER_E``, ``PRICER_M``
    periods. Returns a namespace: ``kinds`` (per pricer: its shape, input
    packing, launchers, entry points and plain versions) and what the main
    path's entry points take."""
    from types import SimpleNamespace

    from finmath_tpu_torch.models.lmm import (build_atm_calibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.ops import lmm_kernel as k1
    from finmath_tpu_torch.ops import lmm_stochvol_kernel as ksv

    E, M, DT = PRICER_E, PRICER_M, PRICER_DT
    a = build_atm_calibration(num_paths=256, num_factors=1, device="cuda")
    cov = a.covariance
    a_p0 = np.asarray(cov.initial_parameters)
    prep = cov.prepare(torch.as_tensor(a_p0))
    a_vol = (cov.vol_table(prep)
             * cov.factor_matrix(prep)[:, 0][None, :]).numpy()  # bench :1042
    a_strike = next(p.strike for p in a.products
                    if p.exercise_index == E and p.num_periods == M)
    b = build_benchmark_calibration(num_paths=256, device="cuda")
    cov = b.covariance
    b_p0 = np.asarray(cov.initial_parameters)
    prep = cov.prepare(torch.as_tensor(b_p0))
    b_vol, b_R = cov.vol_table(prep).numpy(), cov.factor_matrix(prep).numpy()
    nu, rho = (float(x) for x in cov.stoch_vol_params(prep))
    blend = float(b_p0[5])
    fwd0 = b.engine._t["fwd0"].cpu().numpy()
    b_strike = next(p.strike for i, p in enumerate(b.engine.products)
                    if p.exercise_index == E and abs(p.strike - fwd0[i]) < 1e-10)
    F = b_R.shape[1]
    am, bm = a.model, b.model
    kinds = {
        "one_factor": dict(
            rows=1, n=am.num_libors, F=1, strike=a_strike,
            packed=k1.lmm_swaption_packed,
            pack=lambda S: k1.lmm_swaption_inputs(
                a_vol, am.initial_forwards, am.deltas, S, DT, a_strike,
                "cuda"),
            launchers=("lmm_swaption_paths", "lmm_swaption_paths_normals"),
            run=(k1.lmm_swaption_payoffs, k1.lmm_swaption_payoffs_injected),
            plain=(k1.lmm_swaption_paths_reference,
                   k1.lmm_swaption_payoffs_with_normals),
            replaces=("finmath_tpu/ops/lmm_kernel.py:141",
                      "finmath_tpu/ops/lmm_kernel.py:351")),
        "stochvol": dict(
            rows=F + 1, n=bm.num_libors, F=F, strike=b_strike,
            packed=ksv.lmm_stochvol_swaption_packed,
            pack=lambda S: ksv.lmm_stochvol_swaption_inputs(
                b_vol, b_R, bm.initial_forwards, bm.deltas, S, DT, b_strike,
                blend, nu, rho, "cuda"),
            launchers=("lmm_stochvol_swaption_paths",
                       "lmm_stochvol_swaption_paths_normals"),
            run=(ksv.lmm_stochvol_swaption_payoffs,
                 ksv.lmm_stochvol_swaption_payoffs_injected),
            plain=(ksv.lmm_stochvol_swaption_paths_reference,
                   ksv.lmm_stochvol_swaption_payoffs_with_normals),
            replaces=("finmath_tpu/ops/lmm_stochvol_kernel.py:157",
                      "finmath_tpu/ops/lmm_stochvol_kernel.py:362")),
    }

    return SimpleNamespace(
        kinds=kinds, am=am, bm=bm, F=F, a_p0=a_p0, b_p0=b_p0, a_vol=a_vol,
        b_vol=b_vol, b_R=b_R, blend=blend, nu=nu, rho=rho, a_strike=a_strike,
        b_strike=b_strike)


def _slice_d1(torch, smi):
    """Phases 15-17: the single-swaption LMM path kernels against their
    plain versions, slice D1's main path (``bench.py:1007
    bench_lmm_pricer_kernels`` at 409,600 paths through the port's entry
    points) and the four launchers' times. Returns their rows of the final
    JSON line."""
    from finmath_tpu_torch import convert
    from finmath_tpu_torch.models.lmm.model import (LIBORMarketModelTorch,
                                                    LMMValuationEngine,
                                                    SwaptionProduct)
    from finmath_tpu_torch.ops import _swaption_paths as sp
    from finmath_tpu_torch.ops import kernels
    from finmath_tpu_torch.ops import lmm_kernel as k1
    from finmath_tpu_torch.ops import lmm_stochvol_kernel as ksv

    P, E, M, DT = PRICER_PATHS, PRICER_E, PRICER_M, PRICER_DT
    cfg = _pricer_setups(torch)
    kinds, am, bm, F = cfg.kinds, cfg.am, cfg.bm, cfg.F
    a_p0, b_p0, a_vol, b_vol, b_R = (cfg.a_p0, cfg.b_p0, cfg.a_vol,
                                     cfg.b_vol, cfg.b_R)
    blend, nu, rho = cfg.blend, cfg.nu, cfg.rho
    a_strike, b_strike = cfg.a_strike, cfg.b_strike

    # -- 15: each launcher against its plain version on the card -----------
    max_abs = dict.fromkeys(sp.LAUNCHES, 0.0)
    for kind, c in kinds.items():
        for label, paths, e in (("a", P, E), ("b", P + 3, E), ("c", 8_192, 1)):
            args = c["pack"](e)
            swap = dict(exercise=e, periods=M)
            rows = e * c["rows"]
            z = kernels.philox_normals(PRICER_SEED, paths, -(-rows // 4),
                                       "cuda")[:rows].contiguous()
            heads = ((PRICER_SEED, paths), (z,))
            outs = []
            for name, run, plain, head in zip(c["launchers"], c["run"],
                                              c["plain"], heads):
                got = run(*head, *args, **swap)
                again = run(*head, *args, **swap)
                torch.cuda.synchronize()
                ref = plain(*head, *args, **swap)
                err = (got - ref).abs()
                p_got = float(got.sum(dtype=torch.float64)) / paths
                ok = (bool(torch.isfinite(got).all())
                      and bool(torch.equal(got, ref))
                      and bool(torch.equal(got, again)))
                max_abs[name] = max(max_abs[name], float(err.max()))
                print(f"phase 15{label} {name} vs plain: paths={paths} "
                      f"steps={e} libors={c['n']} factors={c['F']} "
                      f"max_abs_err={float(err.max()):.3e} "
                      f"price={p_got:.9f} every path bit for bit equal to "
                      f"the plain version, and a second launch: {ok}",
                      flush=True)
                if not ok:
                    raise SystemExit(f"chip_smoke: phase 15{label}: {name} "
                                     "disagrees with its plain version")
                outs.append(got)
            same = bool(torch.equal(*outs))
            print(f"phase 15{label} {kind}: PRNG launch bitwise equal to the "
                  f"injected launch on its own stream: {same}", flush=True)
            if not same:
                raise SystemExit(f"chip_smoke: phase 15{label}: the {kind} "
                                 "PRNG and injected launches disagree")
            del z, outs, got, again, ref, err

    # -- 16: slice D1's main path, bench_lmm_pricer_kernels at 409,600 ------
    def product(strike):
        return [SwaptionProduct(E, M, strike, 0.0, value_unit="VALUE")]

    no_adjustment = LIBORMarketModelTorch(
        am.libor_td, am.forward_curve, am.discount_curve, am.covariance,
        use_numeraire_adjustment=False)   # the kernel applies none
    rng = np.random.default_rng(123)
    z1 = torch.from_numpy(rng.standard_normal((E, P)).astype(np.float32))
    z5 = torch.from_numpy(rng.standard_normal(
        (E * (F + 1), P)).astype(np.float32))
    z1, z5 = z1.cuda(), z5.cuda()
    engines = {
        "one_factor": (
            LMMValuationEngine(am, product(a_strike), P, 1, 99,
                               device="cuda"),
            LMMValuationEngine(no_adjustment, product(a_strike), P, 1, 99,
                               device="cuda", increments=convert
                               .increments_from_normals(z1, 1, DT)),
            a_p0),
        "stochvol": (
            LMMValuationEngine(bm, product(b_strike), P, F, 99,
                               device="cuda"),
            LMMValuationEngine(bm, product(b_strike), P, F, 99, device="cuda",
                               increments=convert.increments_from_normals(
                                   z5, F + 1, DT)),
            b_p0),
    }
    entry = {
        "one_factor": (
            lambda: k1.lmm_swaption_kernel(
                7, P, am.num_libors, E, M, E, a_vol, am.initial_forwards,
                am.deltas, DT, a_strike, device="cuda"),
            lambda: k1.lmm_swaption_kernel_with_normals(
                z1, am.num_libors, E, M, a_vol, am.initial_forwards,
                am.deltas, DT, a_strike)),
        "stochvol": (
            lambda: ksv.lmm_stochvol_swaption_kernel(
                7, P, bm.num_libors, F, E, M, E, b_vol, b_R,
                bm.initial_forwards, bm.deltas, DT, b_strike, blend, nu, rho,
                device="cuda"),
            lambda: ksv.lmm_stochvol_swaption_kernel_with_normals(
                z5, bm.num_libors, F, E, M, b_vol, b_R, bm.initial_forwards,
                bm.deltas, DT, b_strike, blend, nu, rho)),
    }
    sp.LAUNCHES.update(dict.fromkeys(sp.LAUNCHES, 0))
    values = {kind: (float(entry[kind][0]()), float(entry[kind][1]()))
              for kind in kinds}
    torch.cuda.synchronize()
    launches = dict(sp.LAUNCHES)
    checks = {"one launch per pricer call": launches == dict.fromkeys(
        sp.LAUNCHES, 1)}
    report = {}
    for kind, c in kinds.items():
        eng, eng_sn, p0 = engines[kind]
        v_k, v_k_sn = values[kind]
        v_e, v_e_sn = float(eng.values(p0)[0]), float(eng_sn.values(p0)[0])
        # the kernel's standard error from its payoffs (deterministic: the
        # payoffs the main path averaged); both estimators have about the
        # payoff's variance, so the combined error is sqrt(2) times it
        pay = c["run"][0](7, P, *c["pack"](E), exercise=E, periods=M)
        se = float(pay.double().std()) / np.sqrt(P)
        rel, rel_sn = abs(v_k - v_e) / abs(v_e), abs(v_k_sn - v_e_sn) / abs(v_e_sn)
        report[kind] = {
            "kernel": v_k, "engine": v_e, "rel": rel,
            "combined_standard_errors": abs(v_k - v_e) / (np.sqrt(2) * se),
            "same_normals_kernel": v_k_sn, "same_normals_engine": v_e_sn,
            "same_normals_rel": rel_sn}
        checks[f"{kind}: finite positive prices"] = all(
            np.isfinite(v) and v > 0 for v in (v_k, v_e, v_k_sn, v_e_sn))
        checks[f"{kind}: kernel within 2% of the engine"] = rel < 0.02
        checks[f"{kind}: same normals within 1e-5"] = rel_sn < 1e-5
    print(f"phase 16 main path ({P:,} paths, e={E}, periods={M}): "
          + json.dumps({"values": report, "launches": launches}), flush=True)
    print("phase 16 prices: " + "; ".join(
        f"{kind} kernel {v_k:.9f} (same normals {v_sn:.9f})"
        for kind, (v_k, v_sn) in values.items()), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 16 failed: {failed}")

    def min_wall(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times)

    walls = {}
    for kind in kinds:
        eng, _, p0 = engines[kind]
        w_e = min_wall(lambda: eng.values(p0))
        w_k = min_wall(lambda: float(entry[kind][0]()))
        walls[kind] = {"engine_values_ms": w_e * 1e3,
                       "kernel_entry_point_ms": w_k * 1e3,
                       "speedup": w_e / w_k}
    print(f"phase 16 walls (min of 5 after a warm-up; {smi}): "
          + json.dumps(walls), flush=True)
    del engines, entry, z1, z5

    # -- 17: the four launchers against their plain versions, timed --------
    # ms: the launch alone (a prepacked table, a preallocated output, no
    # host submission inside the events); wrapper_ms: the payoffs entry
    # (checks, the table's packing, the output's allocation, the launch)
    rows_out = []
    for kind, c in kinds.items():
        args = c["pack"](E)
        swap = dict(exercise=E, periods=M)
        rows = E * c["rows"]
        z = torch.from_numpy(np.random.default_rng(17).standard_normal(
            (rows, P)).astype(np.float32)).cuda()
        packed = c["packed"](*args, **swap)
        out = torch.empty(P, dtype=torch.float32, device="cuda")
        base = c["launchers"][0]
        launch = (
            lambda: sp.launch_prng(base, out, PRICER_SEED, packed),
            lambda: sp.launch_injected(base, out, z, packed))
        ops = _pricer_operations(c["F"], E, E, M, P,
                                 stoch_vol=kind == "stochvol")
        for j, (name, run, plain) in enumerate(zip(
                c["launchers"], c["run"], c["plain"])):
            head = (PRICER_SEED, P) if j == 0 else (z,)
            ms = _launch_ms(torch, launch[j])
            wrapper_ms = _time_ms(torch, lambda: run(*head, *args, **swap))
            plain_ms = _time_ms(torch, lambda: plain(*head, *args, **swap))
            # the PRNG launchers also draw their normals: Philox and two
            # Box-Muller pairs per four (DRAW_OPERATIONS)
            work = ops + (-(-rows // 4) * DRAW_OPERATIONS * P if j == 0
                          else 0)
            bound_ms, bound_by = _bound(
                list(args[:3]) + ([z] if j else []), out, work)
            print(f"phase 17 timing (median of 5, CUDA events; {smi}): "
                  f"{name} paths={P} steps={E} kernel_ms={ms:.4f} "
                  f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"operations={work}", flush=True)
            rows_out.append({
                "name": name,
                "route": "cuda",
                "source": "finmath_tpu_torch/csrc/lmm_swaption_paths.cu",
                "replaces": c["replaces"][j],
                "launches": launches[name],
                "max_abs_err": max_abs[name],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            })
        del z, out
    return rows_out


def _wall_s(torch, fn, reps=3):
    """Min host seconds of ``fn`` (synchronised) over ``reps`` runs after a
    warm-up; ``fn``'s last result."""
    _, warm, out = _walls(torch, fn, reps)
    return warm, out


def _walls(torch, fn, reps):
    """(cold seconds, min warm seconds over ``reps`` runs, last result) of
    ``fn``, each run synchronised."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    return cold, min(warm), out


def _bench_chain(x, a=1.01, b=0.02):
    """``bench.py:862 bench_eager_ops``' chain (BASELINE configuration 1),
    its two leading scalars as arguments."""
    y = x.mult(a).add(b).exp().log().discount(x, 0.5)
    return y.add_product(x, x).cap(3.0).floor(0.1).sqrt()


def _slice_e(torch, smi):
    """Phases 18-21: the regression, the Bermudan swaption, AAD greeks and
    the lazy engine (BASELINE configurations 3, 5 and 1)."""
    import math

    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.black_scholes import (
        mc_european_call_price_differentiable)
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm import (BermudanSwaption,
                                              BermudanSwaptionPricer,
                                              LMMValuationEngine,
                                              SwaptionProduct,
                                              build_atm_calibration,
                                              eager_swaption_valuation)
    from finmath_tpu_torch.ops import (RandomVariableFloat,
                                       RandomVariableTorch,
                                       RandomVariableTorchFactory,
                                       RandomVariableTorchLazy, averages,
                                       lazy)
    from finmath_tpu_torch.ops.aad import (RandomVariableDifferentiable,
                                           RandomVariableDifferentiableFactory)
    from finmath_tpu_torch.ops.conditional_expectation import (
        regression_fit, regression_fit_predict)

    # -- 19's setup: bench.py:982 bench_bermudan -------------------------
    setup = build_atm_calibration(num_paths=BERMUDAN_PATHS, num_factors=1)
    model, x0 = setup.model, setup.covariance.initial_parameters
    pricer = BermudanSwaptionPricer(
        model, BermudanSwaption(BERMUDAN_EXERCISES, BERMUDAN_MATURITY,
                                BERMUDAN_STRIKE), BERMUDAN_PATHS, 1)

    # -- 18: the regression on the card -----------------------------------
    data = pricer._collect_exercise_data(pricer._engine,
                                         pricer._engine._params(x0))
    # the last regression of the backward induction: the date before the
    # last, onto the last date's exercise value
    feats, y = data[-2][2], data[-1][1]
    beta = regression_fit(feats, y)
    X = feats.double().cpu().numpy().T
    yy = y.cpu().numpy()
    gram, rhs = X.T @ X, X.T @ yy
    lam = 1e-12 * np.trace(gram)
    b = beta.cpu().numpy()
    # NumPy's float64 least squares of the same Tikhonov problem (the
    # jitter rows appended), and the card's backward error against
    # NumPy's moments
    b_ls = np.linalg.lstsq(np.vstack([X, math.sqrt(lam) * np.eye(len(b))]),
                           np.concatenate([yy, np.zeros(len(b))]),
                           rcond=None)[0]
    g_reg = gram + lam * np.eye(len(b))
    cond = float(np.linalg.cond(g_reg))
    backward = float(np.linalg.norm(g_reg @ b - rhs) / (
        np.linalg.norm(g_reg, 2) * np.linalg.norm(b) + np.linalg.norm(rhs)))
    forward = float(np.max(np.abs(b - b_ls)) / np.max(np.abs(b_ls)))
    fit_cuda = regression_fit_predict(feats, y).cpu().numpy()
    fit_cpu = regression_fit_predict(feats.cpu(), y.cpu()).numpy()
    top = float(np.max(np.abs(fit_cpu)))
    fit_ulps = float(np.max(np.abs(fit_cuda.astype(np.float64) - fit_cpu))
                     / np.spacing(np.float32(top)))
    print(f"phase 18 regression on the card ({BERMUDAN_PATHS:,} paths, basis "
          f"{{1, annuity, swap, swap^2}} at T_{BERMUDAN_EXERCISES[-2]}): "
          + json.dumps({"betas": b.tolist(), "cond": cond,
                        "backward_error": backward,
                        "betas_vs_numpy_lstsq_rel": forward,
                        "fit_cuda_vs_cpu_ulps_of_max": fit_ulps}), flush=True)
    checks = {
        "backward error below 1e-8": backward < 1e-8,
        "betas within cond * 1e-15 of NumPy's": forward < cond * 1e-15,
        "fit on cuda within 2 ulps of the CPU's": fit_ulps <= 2.0,
        "betas on cuda": beta.is_cuda,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 18 failed: {failed}")
    del data, X

    # -- 19: BASELINE configuration 3 at full width ------------------------
    wall, value = _wall_s(torch, lambda: pricer.get_value(x0))
    # one more pricing pass for the policy and the exercise dates; the
    # bounds apply that policy
    price, betas, stop = pricer._price(x0)
    shares = [float(torch.mean((stop == k).double()))
              for k in range(len(BERMUDAN_EXERCISES))]
    lower, upper = pricer.get_value_bounds(x0, betas=betas)
    euro = LMMValuationEngine(
        model, [SwaptionProduct(e, BERMUDAN_MATURITY - e, BERMUDAN_STRIKE,
                                0.0, value_unit="VALUE")
                for e in BERMUDAN_EXERCISES], BERMUDAN_PATHS, 1,
        increments=pricer._engine.increments).values(x0)
    e1, m1 = 10, 10
    par = par_swap_rate(model.forward_curve, model.discount_curve,
                        model.tenor_times[e1:e1 + m1 + 1])
    single = BermudanSwaptionPricer(model, BermudanSwaption((e1,), e1 + m1,
                                                            par),
                                    BERMUDAN_PATHS, 1)
    single_value = single.get_value(x0)
    single_euro = LMMValuationEngine(
        model, [SwaptionProduct(e1, m1, par, 0.0, value_unit="VALUE")],
        BERMUDAN_PATHS, 1, increments=single._engine.increments).values(x0)[0]
    print(f"phase 19 Bermudan ({BERMUDAN_PATHS:,} paths, 80 libors, 1 factor, "
          f"exercises {BERMUDAN_EXERCISES}, maturity {BERMUDAN_MATURITY}, "
          f"strike {BERMUDAN_STRIKE}): "
          + json.dumps({"value": value, "lower": lower, "upper": upper,
                        "exercise_shares": shares,
                        "europeans": euro.tolist(),
                        "single_exercise": single_value,
                        "single_exercise_european": float(single_euro)})
          + f"; wall {wall:.6f} s (min of 3 after a warm-up; {smi})",
          flush=True)
    slack = 3e-4
    checks = {
        "the pricing pass repeats its value": float(price) == value,
        "lower <= upper": lower <= upper,
        "bounds bracket the value": lower - slack <= value <= upper + slack,
        "gap under 25%": upper - lower < 0.25 * value,
        "at least the largest European": value >= float(euro.max()) - slack,
        "single exercise equals the European":
            abs(single_value - single_euro) < slack,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 19 failed: {failed}")
    bermudan_value = value
    del pricer, single, setup

    # -- 20: BASELINE configuration 5, AAD greeks ---------------------------
    s0_, r_, sigma_, t_, k_ = BS_PARAMS
    d1 = (math.log(s0_ / k_) + (r_ + sigma_ ** 2 / 2) * t_) / (
        sigma_ * math.sqrt(t_))
    delta_an = 0.5 * (1.0 + math.erf(d1 / math.sqrt(2.0)))
    vega_an = s0_ * math.exp(-d1 * d1 / 2) / math.sqrt(2 * math.pi) \
        * math.sqrt(t_)

    def route1():
        s0 = torch.tensor(s0_, dtype=torch.float64, device="cuda",
                          requires_grad=True)
        sigma = torch.tensor(sigma_, dtype=torch.float64, device="cuda",
                             requires_grad=True)
        price = mc_european_call_price_differentiable(
            7, BS_PATHS, BS_STEPS, s0, r_, sigma, t_, k_)
        return [float(g) for g in torch.autograd.grad(price, (s0, sigma))]

    wall1, (delta1, vega1) = _wall_s(torch, route1)
    z = np.random.default_rng(0).standard_normal(TAPE_PATHS).astype(np.float32)
    growth = RandomVariableTorch(0.0, np.exp(
        (r_ - sigma_ ** 2 / 2) * t_ + sigma_ * math.sqrt(t_) * z
    ).astype(np.float32), device="cuda")

    def route2():
        s0 = RandomVariableDifferentiable(RandomVariableTorch(0.0, s0_))
        val = s0.mult(growth).sub(k_).floor(0.0).mult(
            math.exp(-r_ * t_)).average()
        return val.get_gradient([s0])[s0.get_id()].double_value()

    wall2, delta2 = _wall_s(torch, route2)
    # the LMM tape vega (tests/test_aad.py's 6-period setup)
    deltas, fwds, e, m, strike, vol = [0.5] * 6, [
        0.020, 0.025, 0.030, 0.032, 0.034, 0.036], 2, 4, 0.030, 0.012
    inc = (np.random.default_rng(7).standard_normal((e, TAPE_PATHS))
           * math.sqrt(0.5)).astype(np.float32)

    def lmm_vega():
        factory = RandomVariableDifferentiableFactory()
        sigma = factory.create_random_variable(0.0, vol)
        value = eager_swaption_valuation(factory, fwds, deltas, sigma, inc,
                                         e, m, strike).average()
        return value.get_gradient([sigma])[sigma.get_id()].double_value()

    wall3, vega_tape = _wall_s(torch, lmm_vega)
    h = 1e-5
    up, down = (eager_swaption_valuation(
        RandomVariableTorchFactory(), fwds, deltas, vol + sgn * h, inc, e, m,
        strike).get_average() for sgn in (1.0, -1.0))
    vega_fd = (up - down) / (2 * h)
    print(f"phase 20 AAD greeks ({smi}): " + json.dumps({
        "route1_autograd_1Mx100": {"delta": delta1, "vega": vega1,
                                   "wall_s": wall1},
        "route2_tape_500k": {"delta": delta2, "wall_s": wall2},
        "lmm_tape_vega": {"vega": vega_tape, "central_difference": vega_fd,
                          "paths": TAPE_PATHS, "wall_s": wall3},
        "analytic": {"delta": delta_an, "vega": vega_an}})
        + " (walls: min of 3 after a warm-up)", flush=True)
    checks = {
        "route 1 delta within 0.02": abs(delta1 - delta_an) < 0.02,
        "route 1 vega within 0.05": abs(vega1 - vega_an) < 0.05,
        "route 2 delta within 0.02": abs(delta2 - delta_an) < 0.02,
        "LMM tape vega within 2e-3 of the difference":
            abs(vega_tape - vega_fd) < 2e-3 * abs(vega_fd),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 20 failed: {failed}")
    del growth

    # -- 21: BASELINE configuration 1, eager / lazy / float oracle ---------
    vals = np.random.default_rng(0).uniform(0.5, 2.0, EAGER_PATHS).astype(
        np.float32)
    eager_x = RandomVariableTorch(0.0, vals, device="cuda")
    lazy_x = RandomVariableTorchLazy(0.0, vals, device="cuda")
    lazy_x.cache()
    float_x = RandomVariableFloat(0.0, vals)
    walls, avgs = {}, {}
    for name, rv in (("eager", eager_x), ("lazy", lazy_x),
                     ("float_oracle", float_x)):
        walls[name], avgs[name] = _wall_s(
            torch, lambda rv=rv: _bench_chain(rv).get_average(), reps=5)
    bits_equal = bool(np.array_equal(
        _bench_chain(lazy_x).get_realizations().view(np.int32),
        _bench_chain(eager_x).get_realizations().view(np.int32)))
    leaves = [RandomVariableTorchLazy(0.0, vals, device="cuda")
              for _ in range(8)]
    for leaf in leaves:
        leaf.cache()
    n0 = lazy.program_cache_size()
    batch = averages(*[_bench_chain(leaf) for leaf in leaves])
    n1 = lazy.program_cache_size()
    captures = lazy.GRAPH_COUNTS["captures"]
    batch2 = averages(*[_bench_chain(leaf, 1.02, 0.03) for leaf in leaves])
    n2 = lazy.program_cache_size()
    new_captures = lazy.GRAPH_COUNTS["captures"] - captures
    eager2 = _bench_chain(eager_x, 1.02, 0.03).get_average()
    walls["lazy_8chains_1flush"], _ = _wall_s(
        torch, lambda: averages(*[_bench_chain(leaf) for leaf in leaves]),
        reps=5)
    sweep = {}
    for paths in (500_000, 1_000_000, 4_000_000):
        big = np.random.default_rng(1).uniform(0.5, 2.0, paths).astype(
            np.float32)
        lx = RandomVariableTorchLazy(0.0, big, device="cuda")
        lx.cache()
        fx = RandomVariableFloat(0.0, big)
        row = {name: _wall_s(torch, lambda rv=rv: _bench_chain(
            rv).get_average())[0] for name, rv in (("lazy", lx),
                                                  ("float_oracle", fx))}
        row["float_over_lazy"] = row["float_oracle"] / row["lazy"]
        sweep[str(paths)] = row
    print(f"phase 21 eager ops ({EAGER_PATHS:,} paths; {smi}): " + json.dumps({
        "averages": avgs, "walls_s": walls,
        "lazy_bitwise_equal_eager": bits_equal,
        "programs_added_by_batch": n1 - n0,
        "programs_added_by_new_scalars": n2 - n1,
        "graphs_captured_for_new_scalars": new_captures,
        "graph_counts": dict(lazy.GRAPH_COUNTS),
        "break_even_sweep_s": sweep})
        + " (walls: min after a warm-up)", flush=True)
    checks = {
        "lazy equals eager bit for bit": bits_equal
        and avgs["lazy"] == avgs["eager"],
        "both within 1e-5 of the float oracle":
            abs(avgs["eager"] - avgs["float_oracle"]) < 1e-5
            and abs(avgs["lazy"] - avgs["float_oracle"]) < 1e-5,
        "the 8-chain batch adds one program": n1 - n0 == 1,
        "new scalars add none": n2 == n1 and new_captures == 0,
        "the batch equals eager": batch == [avgs["eager"]] * 8
        and batch2 == [eager2] * 8,
        "flushes ran as graphs": lazy.GRAPH_COUNTS["replays"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 21 failed: {failed}")
    return bermudan_value


def _matched_row(torch, smi, lmm_stochvol_kernel, black_residuals):
    """Phase 22: ``bench.py:641 bench_stochvol_matched`` through the port's
    public API at 81,920 Sobol paths on the stoch-vol products kernel."""
    from scipy.optimize import least_squares

    from finmath_tpu_torch.models.lmm import (StochVolKernelCalibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        CURATED_BASINS)
    from finmath_tpu_torch.models.qmc import sobol_brownian_increments

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    setup = build_benchmark_calibration(num_paths=SV_PATHS, brownian="sobol",
                                        seed=0, device="cuda")
    eng = setup.engine
    factors = eng.num_factors + 1
    # the K realizations as the engine's injected format: Owen scramblings
    # 0 (the engine's own) .. K - 1
    incs = [sobol_brownian_increments(np.full(40, 0.5), factors, SV_PATHS,
                                      seed=k) for k in range(MATCHED_K)]
    sobol_s = time.perf_counter() - t0
    kb = StochVolKernelCalibration(eng, incs)
    p0 = setup.covariance.initial_parameters
    # build and warm every program before the threads start
    t0 = time.perf_counter()
    for k in range(MATCHED_K):
        kb.residuals(p0, k)
        kb.residuals_and_jacobian(p0, k)
    gap = float(np.abs(kb.residuals(p0, 0) - eng.residuals(p0)).max())
    eng.implied_vols(p0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    weight = kb._weight.cpu().numpy()

    def rms19_kernel(r):
        return float(np.sqrt(np.sum((r / weight) ** 2) / 19.0))

    def engine_on(k):
        # the engine oracle on realization k: its injected increments
        # swapped in place (the backend keeps copies of its own)
        eng.set_increments(incs[k])

    def rms19_engine(x):
        d = setup.deviations(x)
        return float(np.sqrt(np.sum(d ** 2) / 19.0))

    residual_calls = _Counted(kb.residuals)
    jacobian_calls = _Counted(kb.jacobian)

    def make_funs(k):
        def fun(x):
            return np.nan_to_num(residual_calls(x, k), nan=1e3, posinf=1e3,
                                 neginf=-1e3)

        def jac(x):
            return np.nan_to_num(jacobian_calls(x, k), nan=0.0, posinf=0.0,
                                 neginf=0.0)
        return fun, jac

    starts = [np.asarray(c) for c in CURATED_BASINS[:2]]

    def chain(k):
        fun, jac = make_funs(k)
        scores = [float(np.sqrt(np.mean(fun(x) ** 2))) for x in starts]
        cand = starts[int(np.argmin(scores))]
        r1 = least_squares(fun, cand, jac=jac, method="trf", x_scale="jac",
                           max_nfev=40)
        r2 = least_squares(fun, r1.x, jac=jac, method="trf", x_scale="jac",
                           max_nfev=250, ftol=1e-15, xtol=1e-15, gtol=1e-15)
        e1, e2 = rms19_kernel(fun(r1.x)), rms19_kernel(fun(r2.x))
        return (r1.x, e1) if e1 <= e2 else (r2.x, e2)

    lmm_stochvol_kernel.LAUNCHES = black_residuals.LAUNCHES = 0
    t_all = time.perf_counter()
    with ThreadPoolExecutor(max_workers=MATCHED_K) as pool:
        chains = list(pool.map(chain, range(MATCHED_K)))
    chains_s = time.perf_counter() - t_all
    best_k = int(np.argmin([e for _, e in chains]))
    best_x, best_kernel = chains[best_k]

    t0 = time.perf_counter()
    fun_b, jac_b = make_funs(best_k)
    rng = np.random.default_rng(11)
    jitter = [best_x * (1 + rng.normal(0.0, 0.01, best_x.shape[0]))
              for _ in range(MATCHED_RESTARTS)]

    def restart(w):
        rr = least_squares(fun_b, w, jac=jac_b, method="trf", x_scale="jac",
                           max_nfev=120, ftol=1e-15, xtol=1e-15)
        return rr.x, rms19_kernel(fun_b(rr.x))

    with ThreadPoolExecutor(max_workers=MATCHED_RESTARTS) as pool:
        restarts = list(pool.map(restart, jitter))
    # the final ranking by the engine oracle on the best realization
    engine_on(best_k)
    ranked = sorted((rms19_engine(x), ek, x)
                    for x, ek in [(best_x, best_kernel)] + restarts)
    best_rms, best_kernel, best_x = ranked[0]
    restarts_s = time.perf_counter() - t0
    wall = chains_s + restarts_s
    launches = lmm_stochvol_kernel.LAUNCHES
    iv_launches = black_residuals.LAUNCHES
    backend_calls = residual_calls.calls + jacobian_calls.calls
    dev = setup.deviations(best_x)
    mean_dev = float(np.mean(dev))
    per_restart_engine = [rms19_engine(x) for x, _ in restarts]
    per_realization_engine = []
    for k, (x, _) in enumerate(chains):
        engine_on(k)
        per_realization_engine.append(rms19_engine(x))
    on_cuda = (eng.increments.is_cuda and all(z.is_cuda for z in kb._z))
    print(f"phase 22 matched-quality row: paths={SV_PATHS} Sobol, "
          f"K={MATCHED_K} realizations, {MATCHED_RESTARTS} restarts; "
          f"sobol_generation_s={sobol_s:.3f} warmup_s={warm_s:.3f} "
          f"kernel_vs_engine_residuals_p0={gap:.3e} " + json.dumps({
              "wall_s": round(wall, 4), "phase_chains_s": round(chains_s, 4),
              "phase_restarts_s": round(restarts_s, 4),
              "best_realization": best_k,
              "best_rms19": best_rms, "best_rms19_kernel": best_kernel,
              "mean_dev": mean_dev,
              "per_realization_rms19_kernel": [e for _, e in chains],
              "per_realization_rms19_engine": per_realization_engine,
              "per_restart_rms19_kernel": [e for _, e in restarts],
              "per_restart_rms19_engine": per_restart_engine,
              "kernel_launches": launches,
              "inversion_launches": iv_launches,
              "backend_residual_calls": residual_calls.calls,
              "backend_jacobian_calls": jacobian_calls.calls,
              "published_0.198%_reached": best_rms <= 0.00198,
              "on_cuda": on_cuda}), flush=True)
    checks = {
        "kernel launched": launches > 0,
        "launches == backend residual + jacobian calls":
            launches == backend_calls,
        "inversion launches == backend residual + jacobian calls":
            iv_launches == backend_calls,
        "realizations on cuda": on_cuda,
        "kernel residuals within 5e-5 of the engine's at p0": gap < 5e-5,
        "15 finite deviations": bool(np.all(np.isfinite(dev))
                                     and dev.shape == (15,)),
        "rms19 < 0.25%": best_rms < 0.0025,
        "|mean_dev| < 1e-2": abs(mean_dev) < 1e-2,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 22 failed: {failed}")
    print(f"phase 22 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


def _parity(torch, smi):
    """Phase 23: ``bench.py:1232 bench_parity_1e6`` through the port."""
    from finmath_tpu_torch.models.black_scholes import mc_european_call_price
    from finmath_tpu_torch.models.lmm import (build_atm_calibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        CURATED_BASINS)

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    args = (7, BS_PATHS, BS_STEPS, 1.0, 0.05, 0.30, 1.0, 1.05)
    p32 = mc_european_call_price(*args, device="cuda")
    p64 = mc_european_call_price(*args, dtype=f64, device="cuda")
    bs_rel = abs(p32 - p64) / abs(p64)

    def pair(build, **kw):
        return tuple(build(**kw, dtype=d, device="cuda") for d in (f32, f64))

    a32, a64 = pair(build_atm_calibration, num_paths=10_000, num_factors=1,
                    seed=SEED)
    x0 = a32.covariance.initial_parameters
    v32, v64 = a32.engine.values(x0), a64.engine.values(x0)
    atm_rel = np.abs(v32 - v64) / np.abs(v64)
    s32, s64 = pair(build_benchmark_calibration, num_paths=16_384,
                    seed=SV_SEED)
    sv_p0 = s32.covariance.initial_parameters
    sv_rel = (np.abs(s32.engine.values(sv_p0) - s64.engine.values(sv_p0))
              / np.abs(s64.engine.values(sv_p0)))
    # the calibrated basin: the trimmed criterion
    basin = CURATED_BASINS[0]
    c32 = s32.engine.pathwise_values(basin)
    c64 = s64.engine.pathwise_values(basin)
    cal_rel = (np.abs(c32.mean(axis=1) - c64.mean(axis=1))
               / np.abs(c64.mean(axis=1)))
    keep = np.abs(c32 - c64).max(axis=0) < 1e-3
    trim_rel = (np.abs(c32[:, keep].mean(axis=1) - c64[:, keep].mean(axis=1))
                / np.abs(c64[:, keep].mean(axis=1)))
    n_decorr = int((~keep).sum())
    # the strict tier: the card's float64 against the CPU's float64 on the
    # Mersenne stream (evidence, not a gate)
    strict = {}
    mersenne = dict(num_paths=16_384, seed=SV_SEED, dtype=f64,
                    brownian="finmath_mersenne")
    ct = build_benchmark_calibration(**mersenne, device="cuda"
                                     ).engine.pathwise_values(basin)
    cc = build_benchmark_calibration(**mersenne, device="cpu"
                                     ).engine.pathwise_values(basin)
    gap64 = np.abs(ct - cc).max(axis=0)
    strict.update(
        untrimmed_max_rel_dev=float(np.max(
            np.abs(ct.mean(axis=1) - cc.mean(axis=1))
            / np.abs(cc.mean(axis=1)))),
        max_pathwise_gap=float(gap64.max()),
        median_pathwise_gap=float(np.median(gap64)),
        paths_beyond_1e3_gap=int((gap64 >= 1e-3).sum()))
    # the cost of the float64 engine: values' wall at 16,384 and 409,600
    walls = {}
    for paths, engines in ((16_384, (s32.engine, s64.engine)),
                           (409_600, tuple(
                               build_benchmark_calibration(
                                   num_paths=409_600, seed=SV_SEED, dtype=d,
                                   device="cuda").engine
                               for d in (f32, f64)))):
        w32, _ = _wall_s(torch, lambda: engines[0].values(basin))
        w64, _ = _wall_s(torch, lambda: engines[1].values(basin))
        walls[paths] = {"f32_ms": w32 * 1e3, "f64_ms": w64 * 1e3,
                        "f64_over_f32": w64 / w32}
    print(f"phase 23 parity f32 vs f64 ({smi}): " + json.dumps({
        "bs_mc_1M_x_100_rel": bs_rel, "bs_prices": [p32, p64],
        "atm_10k_max_rel": float(atm_rel.max()),
        "atm_10k_median_rel": float(np.median(atm_rel)),
        "stochvol_16k_p0_max_rel": float(sv_rel.max()),
        "basin_untrimmed_max_rel": float(cal_rel.max()),
        "basin_trimmed_max_rel": float(trim_rel.max()),
        "basin_decorrelated_paths": n_decorr,
        "strict_card_f64_vs_cpu_f64": strict,
        "values_wall": {str(k): v for k, v in walls.items()}}), flush=True)
    checks = {
        "Black-Scholes f32 within 1e-6 of f64": bs_rel < 1e-6,
        "ATM 144 values within 1e-6": bool(atm_rel.max() < 1e-6
                                           and atm_rel.shape == (144,)),
        "stoch-vol p0 within 1e-6": bool(sv_rel.max() < 1e-6),
        "basin trimmed within 1e-6": bool(trim_rel.max() < 1e-6),
        "basin decorrelated < 0.5% of paths": n_decorr < 5e-3 * c32.shape[1],
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 23 failed: {failed}")
    print(f"phase 23 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


def _standard_errors(c, antithetic=False):
    """Standard errors of the row means of pathwise contributions [P,
    paths]; antithetic pairs ([z, -z] halves) count as one sample."""
    if antithetic:
        half = c.shape[1] // 2
        c = 0.5 * (c[:, :half] + c[:, half:])
    return c.std(axis=1, ddof=1) / np.sqrt(c.shape[1])


def _measures_setup(tmodel, curves, cov, td, *, measure="spot",
                    state_space="normal", sim_dt=None, products=None):
    """``tests/test_measures_and_statespace.py:36-60``: 10 libors of a flat
    2.5% curve, one factor, a flat vol of 0.30, no numeraire adjustment."""
    horizon, dt, fwd = 5.0, 0.5, 0.025
    n = int(horizon / dt)
    fc = curves.ForwardCurveFromForwards(np.arange(0.0, horizon + dt, dt),
                                         np.full(n + 1, fwd), dt)
    dc = curves.DiscountCurveFromForwardCurve(fc, horizon=horizon)
    libor_td = td.TimeDiscretization(initial=0.0, num_steps=n, step=dt)
    sim_td = (td.TimeDiscretization(initial=0.0,
                                    num_steps=int(horizon / sim_dt),
                                    step=sim_dt) if sim_dt else libor_td)
    k = cov.LIBORCovarianceModelFromVolatilityAndCorrelation(
        cov.LIBORVolatilityModelPiecewiseConstant(
            sim_td, libor_td, time_grid=np.asarray([0.0]),
            maturity_grid=np.asarray([0.0]), initial_volatility=0.30),
        cov.LIBORCorrelationModelExponentialDecay(libor_td, 1, decay=0.0))
    model = tmodel.LIBORMarketModelTorch(
        libor_td, fc, dc, k, measure=measure, state_space=state_space,
        use_numeraire_adjustment=False, simulation_td=sim_td)
    if products is None:
        strike = curves.par_swap_rate(fc, dc, model.tenor_times[4:9])
        products = [tmodel.SwaptionProduct(4, 4, strike, 0.0,
                                           value_unit="VALUE")]
    return model, tmodel.LMMValuationEngine(model, products, MEASURE_PATHS,
                                            1, 4242, device="cuda")


def _engine_options(torch, smi, bermudan_value):
    """Phase 24: the engine options at full width."""
    from finmath_tpu_torch.models import curves
    from finmath_tpu_torch.models import time_discretization as td
    from finmath_tpu_torch.models.analytic import black_formula
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import covariance as cov
    from finmath_tpu_torch.models.lmm import model as tmodel
    from finmath_tpu_torch.models.lmm.bermudan import (BermudanSwaption,
                                                       BermudanSwaptionPricer)

    t_phase = time.perf_counter()
    out, checks = {}, {}
    # the ATM setup at 100,000 paths: each option against the default
    base = build_atm_calibration(num_paths=PATHS, num_factors=1, seed=SEED,
                                 device="cuda")
    x0 = base.covariance.initial_parameters
    c0 = base.engine.pathwise_values(x0)
    se0 = _standard_errors(c0)
    terminal = tmodel.LIBORMarketModelTorch(
        base.model.libor_td, base.model.forward_curve,
        base.model.discount_curve, base.covariance, measure="terminal",
        use_numeraire_adjustment=True)
    variants = {
        "antithetic": tmodel.LMMValuationEngine(
            base.model, base.products, PATHS, 1, SEED, device="cuda",
            antithetic=True),
        "predictor_corrector": tmodel.LMMValuationEngine(
            base.model, base.products, PATHS, 1, SEED, device="cuda",
            scheme="predictor_corrector"),
        "terminal": tmodel.LMMValuationEngine(
            terminal, base.products, PATHS, 1, SEED, device="cuda"),
    }
    for name, engine in variants.items():
        c = engine.pathwise_values(x0)
        se = _standard_errors(c, antithetic=name == "antithetic")
        z = np.abs(c.mean(axis=1) - c0.mean(axis=1)) / np.sqrt(se ** 2
                                                                + se0 ** 2)
        out[f"atm_{name}_max_gap_se"] = float(z.max())
        checks[f"ATM {name} within 5 combined standard errors"] = bool(
            z.shape == (144,) and z.max() < 5.0)
        del c
    del c0

    # the measures test's configuration at 1,000,000 paths
    e = 6
    caplet = [tmodel.SwaptionProduct(e, 1, 0.025, 0.0, value_unit="VALUE")]
    lmodel, leng = _measures_setup(tmodel, curves, cov, td,
                                   state_space="lognormal", products=caplet)
    sigma = np.asarray([0.30])
    c = leng.pathwise_values(sigma)[0]
    v, se = float(c.mean()), float(_standard_errors(c[None, :])[0])
    df_pay = float(lmodel.discount_curve.get_discount_factor(e * 0.5 + 0.5))
    analytic = 0.5 * df_pay * black_formula(0.025, 0.025, 0.30, e * 0.5)
    out["lognormal_caplet"] = {"mc": v, "black": analytic,
                               "rel": abs(v / analytic - 1.0),
                               "gap_se": abs(v - analytic) / se}
    checks["lognormal caplet within 2% of Black"] = \
        abs(v / analytic - 1.0) < 0.02
    _, coarse = _measures_setup(tmodel, curves, cov, td)
    _, fine = _measures_setup(tmodel, curves, cov, td, sim_dt=0.25)
    cc, cf = coarse.pathwise_values(sigma)[0], fine.pathwise_values(sigma)[0]
    vc, vf = float(cc.mean()), float(cf.mean())
    se_cf = float(np.hypot(_standard_errors(cc[None, :])[0],
                           _standard_errors(cf[None, :])[0]))
    out["refined_grid"] = {"tenor_grid": vc, "dt_0.25": vf,
                           "rel": abs(vf / vc - 1.0),
                           "gap_se": abs(vf - vc) / se_cf}
    checks["refined grid within 5% of the tenor grid"] = \
        abs(vf / vc - 1.0) < 0.05
    tmodel_t, teng = _measures_setup(tmodel, curves, cov, td,
                                     measure="terminal")
    x = teng._params(sigma)
    ev = teng._events[0]
    _, inv_sum = teng._simulate_collect(
        x, lambda e, j, L, N: teng._collect(ev, L, N))[0]
    mean_inv = float(inv_sum) / MEASURE_PATHS * teng._p0_terminal
    df_e = float(tmodel_t.discount_curve.get_discount_factor(
        float(tmodel_t.tenor_times[ev["e"]])))
    out["terminal_mean_inv_numeraire"] = {"mc": mean_inv, "df": df_e,
                                          "rel": abs(mean_inv / df_e - 1.0)}
    checks["terminal E[1/N] within 1% of the discount factor"] = \
        abs(mean_inv / df_e - 1.0) < 0.01
    del leng, coarse, fine, teng

    # the terminal-measure Bermudan at phase 19's configuration
    product = BermudanSwaption(BERMUDAN_EXERCISES, BERMUDAN_MATURITY,
                               BERMUDAN_STRIKE)
    pricer = BermudanSwaptionPricer(terminal, product, BERMUDAN_PATHS, 1,
                                    device="cuda")
    value = pricer.get_value(x0)
    lower, upper = pricer.get_value_bounds(x0)
    out["bermudan_terminal"] = {"value": value, "lower": lower,
                                "upper": upper, "spot_value": bermudan_value}
    checks["terminal Bermudan within 3e-4 of the spot value"] = \
        abs(value - bermudan_value) < 3e-4
    checks["terminal bounds ordered and around the value (3e-4)"] = \
        lower <= upper and lower - 3e-4 <= value <= upper + 3e-4

    # the forward-delta ladder (bench.py:1204-1229 route 3)
    ladder = build_atm_calibration(num_paths=PATHS, num_factors=1,
                                   seed=3141, device="cuda")
    pa = ladder.covariance.initial_parameters
    torch.cuda.reset_peak_memory_stats()
    ladder_s, (total, g) = _wall_s(
        torch, lambda: ladder.engine.forward_deltas(pa))
    peak = torch.cuda.max_memory_allocated()
    i = int(np.argmax(np.abs(g)))
    e64 = tmodel.LMMValuationEngine(
        ladder.model, ladder.products, PATHS, 1, device="cuda",
        dtype=torch.float64, increments=ladder.engine.increments)
    x64 = e64._params(pa)
    f0 = torch.as_tensor(np.asarray(ladder.model.initial_forwards),
                         dtype=torch.float64, device="cuda")
    h = 1e-5
    bump = torch.zeros_like(f0)
    bump[i] = h
    with torch.no_grad():
        fd = float((e64._values(x64, fwd0=f0 + bump).sum()
                    - e64._values(x64, fwd0=f0 - bump).sum()) / (2 * h))
    out["delta_ladder"] = {
        "buckets": int(g.shape[0]), "portfolio_value": total,
        "largest_bucket": i, "aad": float(g[i]), "central_difference_f64": fd,
        "rel": abs(g[i] / fd - 1.0), "wall_ms": ladder_s * 1e3,
        "max_memory_allocated_gb": peak / 1e9}
    checks["ladder finite, 80 buckets, not all zero"] = bool(
        g.shape == (80,) and np.all(np.isfinite(g)) and np.any(g != 0.0))
    checks["largest bucket within 2e-3 of the f64 central difference"] = \
        abs(g[i] / fd - 1.0) < 2e-3
    print(f"phase 24 engine options ({smi}): " + json.dumps(out), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 24 failed: {failed}")
    print(f"phase 24 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)



#: the collector kernel's gate against its plain version: the worst case
#: of a 39-term float32 annuity (at most 20 in the ATM setup's periods)
#: summed in another order, 2 m u |ann| ~ 1e-4 relative, times the
#: strikes and notionals of phases 25 and 27 (at most 0.03 and 2, 20
#: trades), and the par rates' share of it
COLLECT_MAX_ABS_ERR = 1e-4


def _collect_check(torch, engine, x):
    """The collector kernel against its plain version on one simulation of
    a netting-set engine's paths, date by date on the same forwards:
    ``(max_abs_err, kernel_ms, plain_ms, bound_ms)``, the largest gap of
    any output on the paths both keep, and each date's device time (CUDA
    events, median of 5) and least time (the bytes a launch reads and
    writes over the memory rate) summed over the dates. Raises where the
    two break different paths or 1/N differs."""
    from finmath_tpu_torch.ops import exposure_collect as xc

    plan = engine._collect_plan
    paths = engine.engine._local_paths
    blocks = []
    with torch.no_grad():
        engine.engine._simulate_collect(
            x, lambda e, ev, L, N: blocks.append((L.clone(), N.clone())))
    got = xc.collect_buffers(plan, paths, "cuda")
    ref = xc.collect_buffers(plan, paths, "cuda")
    K = plan.underlyings
    err = kernel_ms = plain_ms = nbytes = 0.0
    with torch.no_grad():
        for ev, (L, N) in enumerate(blocks):
            kernel_ms += _launch_ms(
                torch, lambda L=L, N=N, ev=ev: xc.exposure_collect(
                    L, N, plan, ev, got))
            plain_ms += _launch_ms(
                torch, lambda L=L, N=N, ev=ev: xc.write_rows(
                    ref, ev, xc.exposure_collect_reference(L, N, plan, ev)))
            keep = []
            for out in (got, ref):
                ok = (torch.isfinite(out.net[ev]) & torch.isfinite(out.inv[ev])
                      & torch.isfinite(out.plus[ev]))
                keep.append(ok & out.und_finite[ev] if K else ok)
            if not torch.equal(keep[0], keep[1]):
                raise SystemExit(f"chip_smoke: the collector kernel breaks "
                                 f"other paths than its plain version at "
                                 f"date {plan.dates[ev]}")
            ok = keep[1]
            if not torch.equal(got.inv[ev][ok], ref.inv[ev][ok]):
                raise SystemExit(f"chip_smoke: the collector kernel's 1/N "
                                 f"differs at date {plan.dates[ev]}")
            for name in ("net", "plus", "und", "rates"):
                a, b = getattr(got, name), getattr(ref, name)
                if a is not None:
                    gap = (a[ev].double() - b[ev].double())[..., ok].abs()
                    err = max(err, float(gap.max()))
            nbytes += (L.numel() * L.element_size()
                       + (N.numel() * N.element_size() if plan.spot else 0)
                       + 24 * paths)
            if K:
                nbytes += K * paths * (8 + got.rates.element_size()) + paths
    return err, kernel_ms, plain_ms, nbytes / PEAK_BYTES_PER_S * 1e3


def _exposure(torch, smi):
    """Phases 25-27: ``bench.py:1474 bench_exposure`` and
    ``bench.py:1558 bench_cva_deltas`` at full width, then the XVA
    extensions (a mixed netting set with and without a CSA, FVA, dynamic
    IM and MVA, the swaption engine). Returns the calls phase 6 profiles,
    by name, and the collector kernel's row of the final JSON line."""
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import exposure as xv
    from finmath_tpu_torch.ops import exposure_collect as xc

    # -- 25: the 19-date profile of a 10Y par payer swap, a 20-trade set --
    t_phase = time.perf_counter()
    setup = build_atm_calibration(num_paths=EXPOSURE_PATHS, num_factors=1,
                                  device="cuda")
    model, p0 = setup.model, setup.covariance.initial_parameters
    par = float(par_swap_rate(model.forward_curve, model.discount_curve,
                              model.tenor_times[4:21]))
    eng = xv.SwapExposureEngine(model, first_index=4, last_index=20,
                                strike=par, num_paths=EXPOSURE_PATHS,
                                num_factors=1,
                                quantiles=(0.95, 0.99), device="cuda")
    cold_s, wall_s, prof = _walls(torch, lambda: eng.profile(p0), 5)
    mart = float(np.max(np.abs(prof.forward_value
                               - eng.analytic_forward_values())))
    rng = np.random.default_rng(7)
    trades = []
    for k in range(20):
        first = int(rng.integers(1, 20))
        last = int(rng.integers(first + 1, 40))
        trades.append(xv.SwapTrade(first, last, float(rng.uniform(0.0, 0.02)),
                                   payer=bool(k % 2),
                                   notional=float(rng.uniform(0.5, 2.0))))
    nset = xv.NettingSetExposureEngine(model, trades, num_paths=EXPOSURE_PATHS,
                                       num_factors=1, device="cuda")
    xc.LAUNCHES = 0
    n_cold_s, n_wall_s, nprof = _walls(torch, lambda: nset.profile(p0), 5)
    collect_launches = xc.LAUNCHES
    c_err, c_ms, c_plain_ms, c_bound_ms = _collect_check(
        torch, nset, nset.engine._params(p0))
    n_mart = float(np.max(np.abs(nprof.forward_value
                                 - nset.analytic_forward_values())))
    out = {
        "paths": EXPOSURE_PATHS, "observation_dates": len(prof.times),
        "cold_ms": cold_s * 1e3, "wall_ms": wall_s * 1e3,
        "peak_ee": float(np.max(prof.ee)),
        "peak_pfe99": prof.max_pfe(0.99),
        "cva_100bp": eng.cva(p0, hazard_rate=0.01),
        "martingale_max_abs_err": mart,
        "netting_set_20_trades": {
            "observation_dates": len(nprof.times),
            "cold_ms": n_cold_s * 1e3, "wall_ms": n_wall_s * 1e3,
            "peak_netted_ee": float(np.max(nprof.ee)),
            "peak_standalone_ee": float(np.max(nprof.ee_standalone)),
            "peak_netting_benefit": float(np.max(nprof.netting_benefit)),
            "martingale_max_abs_err": n_mart},
        "collector_kernel": {
            "launches_six_profiles": collect_launches,
            "max_abs_err": c_err, "kernel_ms_profile": c_ms,
            "plain_ms_profile": c_plain_ms, "bound_ms_profile": c_bound_ms}}
    print(f"phase 25 bench_exposure ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "19 dates, all finite": bool(
            len(prof.times) == 19 and np.all(np.isfinite(prof.ee))
            and all(np.all(np.isfinite(v)) for v in prof.pfe.values())),
        "martingale < 1e-3": mart < 1e-3,
        "netting set finite, benefit >= 0": bool(
            np.all(np.isfinite(nprof.ee))
            and np.all(nprof.netting_benefit >= -1e-12)),
        "netting set martingale < 2e-3": n_mart < 2e-3,
        "collector kernel: one launch a date of each netting-set profile":
            collect_launches == 6 * len(nprof.times),
        f"collector kernel within {COLLECT_MAX_ABS_ERR} of its plain "
        f"version": c_err <= COLLECT_MAX_ABS_ERR,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 25 failed: {failed}")
    print(f"phase 25 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)

    # -- 26: the 80-bucket dCVA/dL0 ladder from one reverse pass -----------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    d_cold_s, d_wall_s, (cva, grad) = _walls(
        torch, lambda: eng.cva_forward_deltas(p0, hazard_rate=0.012), 3)
    peak = torch.cuda.max_memory_allocated()
    last = eng.trades[0].last_index
    i = int(np.argmax(np.abs(grad)))
    # a float64 central difference of the same CVA on the same paths
    e64 = xv.SwapExposureEngine(model, first_index=4, last_index=20,
                                strike=par, num_paths=EXPOSURE_PATHS,
                                num_factors=1,
                                quantiles=(0.95, 0.99), dtype=torch.float64,
                                increments=eng.engine.increments,
                                device="cuda")
    pd = torch.as_tensor((1.0 - 0.4) * xv._default_probability_vector(
        e64._obs_times, 0.012, None), dtype=torch.float64, device="cuda")
    x64 = e64.engine._params(p0)
    f0 = torch.as_tensor(np.asarray(model.initial_forwards),
                         dtype=torch.float64, device="cuda")
    h = 1e-5
    bump = torch.zeros_like(f0)
    bump[i] = h
    with torch.no_grad():
        fd = float((e64._cva_value(x64, f0 + bump, pd)
                    - e64._cva_value(x64, f0 - bump, pd)) / (2 * h))
    out = {"buckets": int(grad.shape[0]), "cold_ms": d_cold_s * 1e3,
           "wall_ms": d_wall_s * 1e3, "cva_120bp": cva,
           "largest_bucket": i, "aad": float(grad[i]),
           "central_difference_f64": fd, "rel": abs(grad[i] / fd - 1.0),
           "finite": bool(np.all(np.isfinite(grad))),
           "tail_exact_zero": bool(np.all(grad[last:] == 0.0)),
           "max_memory_allocated_gb": peak / 1e9}
    print(f"phase 26 bench_cva_deltas ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "80 buckets, finite, not all zero": bool(
            grad.shape == (80,) and np.all(np.isfinite(grad))
            and np.any(grad != 0.0)),
        "tail_exact_zero": out["tail_exact_zero"],
        "largest bucket within 2e-3 of the f64 central difference":
            abs(grad[i] / fd - 1.0) < 2e-3,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 26 failed: {failed}")
    print(f"phase 26 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    del e64

    # -- 27: the XVA extensions --------------------------------------------
    t_phase = time.perf_counter()
    x_, m_ = 8, 8
    strike = float(par_swap_rate(model.forward_curve, model.discount_curve,
                                 model.tenor_times[x_:x_ + m_ + 1]))
    mixed = [xv.SwapTrade(2, 16, 0.006, payer=False, notional=1.5),
             xv.SwapTrade(1, 12, 0.02, payer=True),
             xv.SwaptionTrade(x_, m_, strike),
             xv.BermudanSwaptionTrade((x_, x_ + 2, x_ + 4), x_ + m_, strike)]
    plain = xv.NettingSetExposureEngine(model, mixed, num_paths=EXPOSURE_PATHS,
                                        num_factors=1, device="cuda")
    csa = xv.NettingSetExposureEngine(
        model, mixed, num_paths=EXPOSURE_PATHS, num_factors=1, device="cuda",
        csa=xv.CSA(threshold=0.0, mta=0.0, margin_lag=1))
    m_cold_s, m_wall_s, mprof = _walls(torch, lambda: plain.profile(p0), 3)
    c_cold_s, c_wall_s, cprof = _walls(torch, lambda: csa.profile(p0), 3)
    fva_gross = xv.fva_from_profile(mprof, 0.01, 0.004, 0.012, 0.005)
    fva_csa = xv.fva_from_profile(cprof, 0.01, 0.004, 0.012, 0.005)
    i_cold_s, i_wall_s, im = _walls(torch, lambda: nset.im_profile(p0), 3)
    mva = xv.mva_from_im_profile(im, 0.008, 0.012, 0.005)
    swpt = xv.SwaptionExposureEngine(model, x_, m_, strike,
                                     num_paths=EXPOSURE_PATHS, num_factors=1,
                                     device="cuda")
    s_cold_s, s_wall_s, sprof = _walls(torch, lambda: swpt.profile(p0), 3)
    u_err = _collect_check(torch, plain, plain.engine._params(p0))[0]
    up_to_x = sprof.forward_value[:swpt._ev_x + 1]
    flat = float(np.max(np.abs(up_to_x - up_to_x[-1])))
    out = {
        "paths": EXPOSURE_PATHS,
        "mixed_set": {"trades": len(mixed), "dates": len(mprof.times),
                      "cold_ms": m_cold_s * 1e3, "wall_ms": m_wall_s * 1e3,
                      "peak_ee": float(np.max(mprof.ee)),
                      "t0_forward_value": float(mprof.forward_value[0]),
                      "peak_netting_benefit": float(
                          np.max(mprof.netting_benefit))},
        "csa_zero_threshold_lag1": {
            "cold_ms": c_cold_s * 1e3, "wall_ms": c_wall_s * 1e3,
            "peak_residual_ee": float(np.max(cprof.ee)),
            "peak_collateral_benefit": float(
                np.max(cprof.collateral_benefit))},
        "fva_gross": fva_gross, "fva_csa": fva_csa,
        "im_20_trades": {"dates": len(im.times), "cold_ms": i_cold_s * 1e3,
                         "wall_ms": i_wall_s * 1e3,
                         "peak_im": im.peak_im(), "mva_80bp": mva},
        "swaption_engine": {"dates": len(sprof.times),
                            "cold_ms": s_cold_s * 1e3,
                            "wall_ms": s_wall_s * 1e3,
                            "value": float(up_to_x[-1]),
                            "forward_value_flat_to_expiry": flat},
        "collector_kernel_mixed_set_max_abs_err": u_err}
    print(f"phase 27 XVA extensions ({smi}): " + json.dumps(out), flush=True)
    # the rectangle rules of tests/test_xva_extensions.py, by hand
    t = cprof.times
    surv = np.exp(-(0.012 + 0.005) * t)
    dt = np.diff(np.concatenate([[0.0], t]))
    fva_hand = float(np.sum(0.01 * cprof.ee * surv * dt)
                     - np.sum(0.004 * (-cprof.ene) * surv * dt))
    mva_hand = float(np.sum(0.008 * im.expected_im
                            * np.exp(-(0.012 + 0.005) * im.times) * im.dts))
    checks = {
        "CSA gross rows equal the plain profile (1e-12)": bool(
            np.allclose(cprof.ee_gross, mprof.ee, rtol=1e-12, atol=0.0)
            and np.allclose(cprof.ene_gross, mprof.ene, rtol=1e-12,
                            atol=0.0)),
        "profiles finite, netting benefit >= 0": bool(
            np.all(np.isfinite(mprof.ee)) and np.all(np.isfinite(cprof.ee))
            and np.all(mprof.netting_benefit >= -1e-12)),
        "FVA equals its rectangle rule (1e-12)": bool(
            np.isclose(fva_csa, fva_hand, rtol=1e-12, atol=0.0)),
        "IM >= 0, peak > 0, MVA its rectangle rule (1e-12)": bool(
            np.all(im.expected_im >= 0.0) and im.peak_im() > 0.0
            and np.isclose(mva, mva_hand, rtol=1e-12, atol=0.0)),
        "swaption forward value flat to expiry (1e-10)": flat < 1e-10,
        f"collector kernel within {COLLECT_MAX_ABS_ERR} of its plain "
        f"version on the mixed set's underlyings":
            u_err <= COLLECT_MAX_ABS_ERR,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 27 failed: {failed}")
    print(f"phase 27 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    calls = {"phase 25 swap profile (50,000 paths)": lambda: eng.profile(p0),
             "phase 25 20-trade profile": lambda: nset.profile(p0),
             "phase 26 cva_forward_deltas": lambda: eng.cva_forward_deltas(
                 p0, hazard_rate=0.012),
             "phase 27 mixed-set profile": lambda: plain.profile(p0),
             "phase 27 im_profile": lambda: nset.im_profile(p0)}
    return calls, {
        "name": "exposure_collect",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/exposure_collect.cu",
        "replaces": "no Pallas kernel: finmath_tpu/models/lmm/exposure.py:659 "
                    "the per-date collector, fused by XLA",
        "launches": collect_launches,
        "max_abs_err": max(c_err, u_err),
        "ms": c_ms,
        "plain_ms": c_plain_ms,
        "bound_ms": c_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def _smile(torch, smi) -> dict:
    """Phase 28: the smile layer (``bench.py:1808-1816`` and the caps and
    cube modules). Returns the call phase 6 profiles, by name."""
    from finmath_tpu_torch.models import caps, cube, sabr
    from finmath_tpu_torch.models.curves import (DiscountCurve, ForwardCurve,
                                                 swap_annuity)
    from finmath_tpu_torch.models.lmm.covariance import (
        LIBORCorrelationModelExponentialDecay,
        LIBORCovarianceModelFromVolatilityAndCorrelation)
    from finmath_tpu_torch.models.lmm.model import LIBORMarketModelTorch
    from finmath_tpu_torch.models.lmm.products import CapFloor
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    p = sabr.SABRParams(alpha=0.035, beta=0.5, rho=-0.3, nu=0.4)
    ks = np.array([0.025, 0.03, 0.035])
    cold_s, wall_s, mc = _walls(torch, lambda: sabr.mc_sabr_implied_vols(
        p, 0.03, 2.0, ks, num_paths=SABR_PATHS, num_steps=64, seed=5,
        device="cuda"), 3)
    hagan = np.array([sabr.sabr_lognormal_implied_volatility(p, 0.03, k, 2.0)
                      for k in ks])
    dev = float(np.max(np.abs(mc - hagan)))
    # calibrate_sabr on Hagan quotes (tests/test_sabr.py's smile)
    smile_ks = np.array([0.015, 0.02, 0.025, 0.03, 0.04, 0.05])
    quotes = [sabr.sabr_lognormal_implied_volatility(p, 0.03, k, 2.0)
              for k in smile_ks]
    fit = sabr.calibrate_sabr(0.03, 2.0, smile_ks, quotes, beta=0.5)
    # a caplet strip from price quotes (tests/test_caps.py's curves), its
    # repricing, and the lognormal LMM on the stripped curve
    period = 0.5
    pillars = [0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 12.0]
    zeros = [0.015, 0.017, 0.020, 0.022, 0.025, 0.027, 0.029, 0.030]
    dc = DiscountCurve(pillars, list(np.exp(-np.array(zeros)
                                            * np.array(pillars))))
    fc = ForwardCurve(dc, payment_offset=period)
    mats, strike = np.array([1.0, 2.0, 3.0]), 0.03
    truth = caps.CapletVolatilityCurve(mats, np.array([0.35, 0.29, 0.24]))
    prices = [caps.cap_value(dc, fc, caps.make_cap_schedule(float(m), period),
                             period, strike, truth.get_caplet_volatility(
                                 caps.make_cap_schedule(float(m), period)))
              for m in mats]
    stripped = caps.strip_caplet_volatilities(dc, fc, mats, prices, strike,
                                              period, quote_type="price")
    reprice = max(abs(caps.cap_value(
        dc, fc, caps.make_cap_schedule(float(m), period), period, strike,
        stripped.get_caplet_volatility(
            caps.make_cap_schedule(float(m), period))) / q - 1.0)
        for m, q in zip(mats, prices))
    libor_td = TimeDiscretization(initial=0.0, num_steps=7, step=period)
    cov = LIBORCovarianceModelFromVolatilityAndCorrelation(
        caps.LIBORVolatilityModelFromCapletCurve(libor_td, libor_td,
                                                 stripped),
        LIBORCorrelationModelExponentialDecay(libor_td, 2))
    lmm = LIBORMarketModelTorch(libor_td, fc, dc, cov, measure="spot",
                                state_space="lognormal")
    cap = CapFloor(lmm, 1, 6, strike, num_paths=CAPLET_PATHS, seed=7,
                   device="cuda")
    l_cold_s, l_wall_s, mc_cap = _walls(
        torch, lambda: cap.get_value(np.zeros(0)), 3)
    # one CMS caplet by replication on a SABR smile (tests/test_cube.py)
    ts = np.arange(0.5, 30.1, 0.5)
    curve = DiscountCurve(list(ts), list(np.exp(-0.025 * ts)))
    pay = [5.0 + (j + 1) * 0.5 for j in range(20)]
    a0 = swap_annuity(curve, pay, [0.5] * len(pay))
    s0 = float((curve.get_discount_factor(5.0)
                - curve.get_discount_factor(pay[-1])) / a0)
    mapping = cube.LinearTSRAnnuityMapping.from_curve(
        curve, s0, pay, payment_time=5.5, period_length=0.5)
    pricer = cube.CMSReplicationPricer(cube.SwaptionSmile(
        forward=s0, expiry=5.0, params=sabr.SABRParams(
            alpha=0.25 * s0 ** 0.3, beta=0.7, rho=-0.25, nu=0.25)),
        mapping, a0)
    parity = abs(pricer.caplet_value(s0) - pricer.floorlet_value(s0)
                 - pricer.swaplet_value(s0))
    out = {
        "sabr_smile": {"paths": SABR_PATHS, "steps": 64,
                       "cold_ms": cold_s * 1e3, "wall_ms": wall_s * 1e3,
                       "mc_vols": mc.tolist(), "hagan_vols": hagan.tolist(),
                       "max_vol_dev_vs_hagan": dev},
        "calibrate_sabr": {"alpha": fit.params.alpha, "rho": fit.params.rho,
                           "nu": fit.params.nu,
                           "rms_vol_error": fit.rms_vol_error},
        "caplet_strip": {"vols": stripped.volatilities.tolist(),
                         "max_reprice_rel": reprice},
        "lmm_on_stripped_curve": {"paths": CAPLET_PATHS,
                                  "cold_ms": l_cold_s * 1e3,
                                  "wall_ms": l_wall_s * 1e3,
                                  "mc_3y_cap": mc_cap,
                                  "quote": prices[-1],
                                  "rel": abs(mc_cap / prices[-1] - 1.0)},
        "cms_caplet_atm": {"value": pricer.caplet_value(s0),
                           "cms_rate": pricer.cms_rate(),
                           "parity_gap": parity}}
    print(f"phase 28 smile layer ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "SABR MC within 0.006 of Hagan": dev < 0.006,
        "calibrate_sabr recovers alpha, rho, nu": bool(
            abs(fit.params.alpha - p.alpha) < 1e-5
            and abs(fit.params.rho - p.rho) < 1e-4
            and abs(fit.params.nu - p.nu) < 1e-4),
        "stripped curve reprices its caps (1e-9)": reprice < 1e-9,
        "LMM on the stripped curve within 3% of the 3Y cap": bool(
            abs(mc_cap / prices[-1] - 1.0) < 0.03),
        "CMS caplet positive, parity to 1e-11": bool(
            pricer.caplet_value(s0) > 0.0 and parity < 1e-11),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 28 failed: {failed}")
    print(f"phase 28 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 28 mc_sabr_option_prices (1M x 64)":
            lambda: sabr.mc_sabr_option_prices(
                p, 0.03, 2.0, ks, num_paths=SABR_PATHS, num_steps=64, seed=5,
                device="cuda")}


def _hybrid(torch, smi) -> dict:
    """Phase 29: the hybrid asset-LMM at full width (no kernel): equity and
    FX under the ATM setup's rates, their martingales, put-call parity, a
    five-trade book's exposure profile and an autocallable. Returns the
    calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import hybrid as hy

    t_phase = time.perf_counter()
    paths = HYBRID_PATHS
    setup = build_atm_calibration(num_paths=paths, num_factors=1,
                                  device="cuda")
    model, p0 = setup.model, setup.covariance.initial_parameters
    n = model.num_libors
    ft = np.arange(0.5, model.tenor_times[-1] + 0.01, 0.5)
    foreign = DiscountCurve(list(ft), list(np.exp(-0.01 * ft)))
    s0 = np.array([100.0, 1.10])
    h = hy.HybridAssetLMM(model, s0, [0.20, 0.10],
                          rate_correlations=[0.3, -0.2],
                          dividend_yields=[0.01, foreign],
                          observation_indices=range(1, n), num_paths=paths,
                          num_factors=1, seed=SEED, antithetic=True,
                          device="cuda")
    cold_s, wall_s, (assets, nums) = _walls(torch, lambda: h.simulate(p0), 5)
    # the martingale errors against their own standard errors, antithetic
    # pairs counting as one sample
    disc = (assets / nums[:, None, :]).cpu().numpy()          # [E, K, paths]
    E, K = disc.shape[:2]
    target = np.stack([s0 * h._dividend_discount(ev) for ev in range(E)])
    se = _standard_errors(disc.reshape(E * K, -1),
                          antithetic=True).reshape(E, K) / target
    mart = h.martingale_errors(p0)
    mart_z = float(np.max(np.abs(mart) / se))
    del disc
    # put-call parity at 10Y (tests/test_hybrid.py:141)
    e10, strike = int(np.argmin(np.abs(model.tenor_times - 10.0))), 100.0
    c, se_c = h.european_option_value(p0, e10, strike, is_call=True)
    p, se_p = h.european_option_value(p0, e10, strike, is_call=False)
    fwd, _ = h.forward_value(p0, e10)
    df10 = float(model.discount_curve.get_discount_factor(
        model.tenor_times[e10]))
    parity = abs((c - p) - (fwd - strike * df10))
    # a five-trade equity/FX book
    book = [hy.EquityForwardTrade(0, 20, 100.0),
            hy.EquityOptionTrade(0, 40, 110.0),
            hy.EquityOptionTrade(0, 60, 90.0, is_call=False, notional=0.5),
            hy.EquityForwardTrade(1, 30, 1.10, notional=-50.0),
            hy.EquityOptionTrade(1, 20, 1.10, is_call=False, notional=80.0)]
    eng = hy.HybridExposureEngine(h, book, quantiles=(0.95,))
    p_cold_s, p_wall_s, prof = _walls(torch, lambda: eng.profile(p0), 5)
    identity = float(np.max(np.abs(prof.ee + prof.ene - prof.forward_value)))
    note = hy.HybridAutocallableNote(
        h, [2, 4, 6, 8, 10], [105.0] * 5, [0.04] * 5, 70.0,
        coupon_levels=[80.0] * 5, memory=True)
    a_cold_s, a_wall_s, (av, ae) = _walls(
        torch, lambda: note.get_value_and_error(p0), 5)
    out = {
        "paths": paths, "observation_dates": E, "assets": K,
        "simulate": {"cold_ms": cold_s * 1e3, "wall_ms": wall_s * 1e3},
        "martingale_max_abs_err": float(np.max(np.abs(mart))),
        "martingale_max_z": mart_z,
        "parity_10y": {"call": c, "put": p, "se_call": se_c, "se_put": se_p,
                       "forward": fwd, "gap": parity,
                       "bound": 4 * (se_c + se_p) + 5e-3},
        "profile_5_trades": {"cold_ms": p_cold_s * 1e3,
                             "wall_ms": p_wall_s * 1e3,
                             "peak_ee": float(np.max(prof.ee)),
                             "min_ene": float(np.min(prof.ene)),
                             "peak_pfe95": float(np.max(prof.pfe[0.95])),
                             "ee_plus_ene_minus_fv": identity},
        "autocallable": {"value": av, "stderr": ae,
                         "cold_ms": a_cold_s * 1e3,
                         "wall_ms": a_wall_s * 1e3}}
    print(f"phase 29 hybrid asset-LMM ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "martingale errors within 4.5 standard errors": bool(
            np.all(np.isfinite(mart)) and mart_z <= 4.5),
        "put-call parity at 10Y": parity < 4 * (se_c + se_p) + 5e-3,
        "profile finite, EE >= 0 >= ENE": bool(
            np.all(np.isfinite(prof.ee)) and np.all(np.isfinite(prof.ene))
            and np.all(np.isfinite(prof.pfe[0.95]))
            and np.all(prof.ee >= 0.0) and np.all(prof.ene <= 0.0)),
        "EE + ENE equals the forward value (1e-10)": identity < 1e-10,
        "autocallable finite, error > 0": bool(
            np.isfinite(av) and 0.0 < av < 2.0 and ae > 0.0),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 29 failed: {failed}")
    print(f"phase 29 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 29 hybrid simulate ({paths:,} paths, {E} dates)":
            lambda: h.simulate(p0),
            "phase 29 five-trade profile": lambda: eng.profile(p0),
            "phase 29 autocallable": lambda: note.get_value_and_error(p0)}


def _hull_white(torch, smi) -> dict:
    """Phase 30: the Hull-White slice at ``bench.py``'s widths (no kernel):
    ``hull_white_swaption_1m``, ``hw_bermudan_ls_1m_x10``, a 1M-path TARN
    and the calibration. Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import (
        HullWhiteModel, HullWhiteSimulation, calibrate_hull_white)
    from finmath_tpu_torch.models.hw_bermudan import (
        BermudanSwaption, hw_bermudan_swaption_pde)
    from finmath_tpu_torch.models.tarn import (
        TargetRedemptionNote, inverse_floater_value)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    paths = HW_PATHS
    # bench.py:1645-1661 hull_white_swaption_1m
    pil = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 15.0, 20.0])
    z = np.array([0.010, 0.012, 0.015, 0.017, 0.020, 0.022, 0.024,
                  0.025, 0.0255])
    curve = DiscountCurve(list(pil), list(np.exp(-z * pil)))
    hw = HullWhiteModel(curve, 0.12, [0.010, 0.014, 0.008],
                        vol_times=[0.0, 2.0, 5.0])
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)

    def simulate():
        return HullWhiteSimulation(hw, td, num_paths=paths, seed=7,
                                   antithetic=True, device="cuda")

    s_cold_s, s_wall_s, sim = _walls(torch, simulate, 5)
    pts = [3.0, 3.5, 4.0, 4.5, 5.0]
    an = hw.swaption(2.0, pts, 0.02)
    w_cold_s, w_wall_s, mc = _walls(
        torch, lambda: sim.mc_swaption_price(2.0, pts, 0.02), 5)
    fit10 = sim.mc_bond_price(10.0) / float(hw.df(10.0)) - 1.0
    del sim
    # bench.py:1835-1854 hw_bermudan_ls_1m_x10
    ts = np.arange(0.5, 20.1, 0.5)
    hwb = HullWhiteModel(DiscountCurve(list(ts), list(np.exp(-0.022 * ts))),
                         0.1, [0.01])
    ex = [2.0 + 0.5 * i for i in range(10)]
    bsim = HullWhiteSimulation(
        hwb, TimeDiscretization(initial=0.0, num_steps=14, step=0.5),
        num_paths=paths, seed=11, antithetic=True, device="cuda")
    prod = BermudanSwaption(ex, 7.0, 0.025)
    b_cold_s, b_wall_s, (bv, be) = _walls(
        torch, lambda: prod.get_value_and_error(bsim), 5)
    t0 = time.perf_counter()
    pde = hw_bermudan_swaption_pde(hwb, ex, 7.0, 0.025, nx=601,
                                   steps_per_year=100)
    pde_s = time.perf_counter() - t0
    # a TARN on tests/test_tarn.py's set-up with an infinite target
    tp = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    tz = np.array([0.012, 0.014, 0.017, 0.019, 0.022, 0.024, 0.026])
    hwt = HullWhiteModel(DiscountCurve(list(tp), list(np.exp(-tz * tp))),
                         0.10, 0.011)
    tsim = HullWhiteSimulation(
        hwt, TimeDiscretization(initial=0.0, num_steps=9, step=0.5),
        num_paths=paths, seed=13, antithetic=True, device="cuda")
    fix = [0.5 * i for i in range(1, 9)]
    pay = [t + 0.5 for t in fix]
    tarn = TargetRedemptionNote(fix, pay, 0.045, target=float("inf"),
                                multiplier=2.0)
    t_cold_s, t_wall_s, (tv, te) = _walls(
        torch, lambda: tarn.get_value_and_error(tsim), 5)
    t_an = inverse_floater_value(hwt, fix, pay, 0.045, multiplier=2.0)
    # calibrate_hull_white on tests/test_hull_white.py:192's case
    truth = HullWhiteModel(curve, 0.12, [0.009, 0.013], vol_times=[0.0, 3.0])
    swaptions = [
        {"expiry": 1.0, "payment_times": [1.5, 2.0, 2.5, 3.0],
         "strike": 0.015},
        {"expiry": 2.0, "payment_times": [2.5, 3.0, 3.5, 4.0],
         "strike": 0.018},
        {"expiry": 5.0, "payment_times": [5.5, 6.0, 6.5, 7.0],
         "strike": 0.022}]
    targets = [truth.swaption(s["expiry"], s["payment_times"], s["strike"])
               for s in swaptions]
    t0 = time.perf_counter()
    cal = calibrate_hull_white(curve, 0.12, [0.0, 3.0], swaptions, targets)
    cal_s = time.perf_counter() - t0
    out = {
        "paths": paths,
        "hull_white_swaption_1m": {
            "simulation_cold_ms": s_cold_s * 1e3,
            "simulation_wall_ms": s_wall_s * 1e3,
            "price_cold_ms": w_cold_s * 1e3, "price_wall_ms": w_wall_s * 1e3,
            "mc": mc, "jamshidian": an, "rel_dev": (mc - an) / an,
            "curve_fit_rel_10y": fit10},
        "hw_bermudan_ls_1m_x10": {
            "cold_ms": b_cold_s * 1e3, "wall_ms": b_wall_s * 1e3,
            "value": bv, "stderr": be, "pde_oracle": pde,
            "pde_host_s": pde_s, "dev_sigma": (bv - pde) / be},
        "tarn_1m_target_inf": {
            "cold_ms": t_cold_s * 1e3, "wall_ms": t_wall_s * 1e3,
            "value": tv, "stderr": te, "inverse_floater": t_an},
        "calibrate_hull_white": {
            "sigmas": cal.model.sigmas.tolist(),
            "rms_price_error": cal.rms_price_error,
            "iterations": cal.iterations, "host_s": cal_s}}
    print(f"phase 30 Hull-White ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "swaption within max(4e-5, 0.012 an) of Jamshidian":
            abs(mc - an) < max(4e-5, 0.012 * an),
        "10Y curve fit within 1e-3": abs(fit10) < 1e-3,
        "Bermudan within 4 e + 0.005 pde of the PDE":
            abs(bv - pde) < 4 * be + 0.005 * pde,
        "TARN within 4 e + 2e-4 an of the inverse floater":
            abs(tv - t_an) < 4 * te + 2e-4 * t_an,
        "calibration rms < 1e-9": cal.rms_price_error < 1e-9,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 30 failed: {failed}")
    print(f"phase 30 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 30 Hull-White simulation ({paths:,} x 20)": simulate,
            f"phase 30 Bermudan LS ({paths:,} x 10 dates)":
                lambda: prod.get_value_and_error(bsim),
            f"phase 30 TARN ({paths:,})":
                lambda: tarn.get_value_and_error(tsim)}


def _credit(torch, smi) -> dict:
    """Phase 31: ``bench.py:1937 bench_credit_wwr`` through the port (no
    kernel): the survival curve bootstrapped from CDS quotes, CIR++ (0.5,
    0.015, 0.08, 0.01) on Hull-White (0.1, 0.01), the 10Y semiannual payer
    par swap's CVA at 500,000 antithetic paths, 4 CIR substeps, seed 31, at
    rho 0.6, 0 and -0.6, and a ``CIRPPSimulation`` on the 20-step
    semiannual grid. Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.credit import (
        CIRPPIntensityModel, CIRPPSimulation, WrongWayRiskCVAEngine,
        bootstrap_survival_curve, cds_legs, par_swap_rate)
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import HullWhiteModel
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    paths = CREDIT_PATHS
    t_grid = np.arange(0.0, 31.0)
    dc = DiscountCurve(t_grid, np.exp(-0.03 * t_grid))
    curve = bootstrap_survival_curve(
        dc, [1.0, 3.0, 5.0, 7.0, 10.0], [0.006, 0.009, 0.012, 0.014, 0.016],
        recovery=0.4)
    intensity = CIRPPIntensityModel(curve, kappa=0.5, theta=0.015,
                                    sigma=0.08, y0=0.01)
    hw = HullWhiteModel(dc, mean_reversion=0.1, volatility=0.01)
    pay = np.arange(1, 21) * 0.5
    k = par_swap_rate(dc, pay)
    engines = {rho: WrongWayRiskCVAEngine(
        hw, intensity, pay, k, num_paths=paths, correlation=rho,
        recovery=0.4, seed=31, antithetic=True, substeps=4, device="cuda")
        for rho in (0.6, 0.0, -0.6)}
    torch.cuda.reset_peak_memory_stats()
    cold_s, wall_s, res = _walls(torch, engines[0.6].compute, 5)
    peak = torch.cuda.max_memory_allocated()
    results = {0.6: res, 0.0: engines[0.0].compute(),
               -0.6: engines[-0.6].compute()}
    surv_err = {rho: float(np.max(np.abs(
        r.expected_survival
        - curve.get_survival_probability(r.observation_times))))
        for rho, r in results.items()}
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)

    def simulate():
        return CIRPPSimulation(intensity, td, paths, seed=31,
                               antithetic=True, substeps=4, device="cuda")

    c_cold_s, c_wall_s, sim = _walls(torch, simulate, 5)
    legs_mc = sim.mc_cds_legs(dc, 5.0, recovery=0.4, payment_interval=0.5)
    legs_an = cds_legs(dc, curve, 5.0, recovery=0.4, payment_interval=0.5)
    del sim
    r0 = results[0.0]
    out = {
        "paths": paths, "observation_dates": int(pay.size),
        "cir_substeps": 4,
        "wwr_cva_rho_0.6": {
            "cold_ms": cold_s * 1e3, "wall_ms": wall_s * 1e3,
            "max_memory_allocated_gb": peak / 1e9,
            "cva_bp": 1e4 * res.cva,
            "cva_independent_bp": 1e4 * res.cva_independent,
            "wwr_ratio": res.wwr_ratio},
        "cva_bp_by_rho": {str(rho): 1e4 * r.cva for rho, r in results.items()},
        "wwr_ratio_by_rho": {str(rho): r.wwr_ratio
                             for rho, r in results.items()},
        "survival_max_err_by_rho (reference defect: substep correlation "
        "(ROADMAP Queue 3), not gated at rho != 0)":
            {str(rho): e for rho, e in surv_err.items()},
        "cirpp_simulation": {
            "cold_ms": c_cold_s * 1e3, "wall_ms": c_wall_s * 1e3,
            "mc_cds_legs_5y": legs_mc, "cds_legs_5y": legs_an}}
    print(f"phase 31 credit WWR CVA ({smi}): " + json.dumps(out), flush=True)
    checks = {
        f"contributions sum to the CVA at rho {rho}":
            abs(float(np.sum(r.contributions)) - r.cva)
            < 1e-12 + 1e-9 * abs(r.cva) for rho, r in results.items()}
    checks.update({f"last contribution below 1e-15 at rho {rho}":
                   abs(float(r.contributions[-1])) < 1e-15
                   for rho, r in results.items()})
    checks.update({
        "rho 0 factorizes within 3%":
            abs(r0.cva - r0.cva_independent) < 0.03 * r0.cva,
        "rho 0 survival within 3e-3 of the curve": surv_err[0.0] < 3e-3,
        "cva(-0.6) < cva(0) < cva(0.6)":
            results[-0.6].cva < r0.cva < results[0.6].cva,
        "mc_cds_legs within 2e-3 relative + 2e-3 of cds_legs": all(
            abs(m - a) < 2e-3 * abs(a) + 2e-3
            for m, a in zip(legs_mc, legs_an)),
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 31 failed: {failed}")
    print(f"phase 31 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 31 WWR CVA engine ({paths:,} paths, rho 0.6)":
                engines[0.6].compute,
            f"phase 31 CIR++ simulation ({paths:,} x 20 x 4)": simulate}


def _xccy_model(dc_d, dc_f):
    """``bench.py:2062-2066``'s cross-currency model."""
    from finmath_tpu_torch.models.cross_currency import CrossCurrencyModel
    from finmath_tpu_torch.models.hull_white import HullWhiteModel

    return CrossCurrencyModel(HullWhiteModel(dc_d, 0.1, 0.01),
                              HullWhiteModel(dc_f, 0.05, 0.008),
                              fx_spot=1.25, fx_vol=0.10, rho_df=0.3,
                              rho_dx=-0.2, rho_fx=0.25)


def _cross_currency(torch, smi) -> dict:
    """Phase 32: ``bench.py:2047 bench_cross_currency`` through the port (no
    kernel): 1,000,000 antithetic paths over 20 semiannual steps, seed 5;
    the 5Y FX options against the closed form, the 10Y CCS legs, the
    martingale diagnostics, and ``tests/test_cross_currency.py``'s exposure
    trades at that width. Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.cross_currency import (
        CCSTrade, CrossCurrencyExposureEngine, CrossCurrencySimulation,
        FXForwardTrade)
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    paths, x0 = XCCY_PATHS, 1.25
    t_grid = np.arange(0.0, 31.0)
    dc_d = DiscountCurve(t_grid, np.exp(-0.03 * t_grid))
    dc_f = DiscountCurve(t_grid, np.exp(-0.01 * t_grid))
    m = _xccy_model(dc_d, dc_f)
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)

    def simulate():
        return CrossCurrencySimulation(m, td, num_paths=paths, seed=5,
                                       antithetic=True, device="cuda")

    s_cold_s, s_wall_s, sim = _walls(torch, simulate, 5)
    strikes = [1.0, 1.25, 1.5]
    o_cold_s, o_wall_s, (fwd, prices, se) = _walls(
        torch, lambda: sim.mc_fx_option_prices(5.0, strikes), 5)
    cf = [m.fx_option(5.0, kk) for kk in strikes]
    pay10 = np.arange(1, 11) * 1.0
    c_cold_s, c_wall_s, (dom, fgn) = _walls(
        torch, lambda: sim.mc_ccs_legs(pay10), 5)
    diag = sim.martingale_diagnostics(5.0, 10.0)
    diag_err = {key: float(mc / an - 1.0) for key, (mc, an) in diag.items()}
    # the exposure engine on the trades of tests/test_cross_currency.py
    ccs10 = [CCSTrade(tuple(pay10))]
    e_cold_s, e_wall_s, eng = _walls(
        torch, lambda: CrossCurrencyExposureEngine(sim, ccs10), 5)
    prof = eng.profile()
    ee_err = {}
    for t in (1.0, 5.0, 9.0):
        i = list(prof.times).index(t)
        ee_err[str(t)] = float(prof.ee[i] / (m.fx_option(t, x0) / x0) - 1.0)
    fv_oracle = np.array([
        0.0 if t >= 10.0 - 1e-9 else float(
            dc_f.get_discount_factor(np.floor(t + 1e-9))
            - dc_d.get_discount_factor(np.floor(t + 1e-9)))
        for t in prof.times])
    fv_err = float(np.max(np.abs(prof.forward_value - fv_oracle)))
    decomposition = float(np.max(np.abs(prof.ee + prof.ene
                                        - prof.forward_value)))
    pay5 = tuple(np.arange(1, 6) * 1.0)
    both = CrossCurrencyExposureEngine(
        sim, [CCSTrade(pay5), CCSTrade(pay5, receive_foreign=False)]).profile()
    fxf = CrossCurrencyExposureEngine(
        sim, [FXForwardTrade(5.0, 1.3)]).profile()
    live = fxf.times < 5.0 - 1e-9
    fxf_err = float(np.max(np.abs(
        fxf.forward_value[live]
        - (x0 * float(dc_f.get_discount_factor(5.0))
           - 1.3 * float(dc_d.get_discount_factor(5.0))))))
    base = CrossCurrencyExposureEngine(sim, [CCSTrade(pay5)]).profile()
    sprd = CrossCurrencyExposureEngine(
        sim, [CCSTrade(pay5, foreign_basis=0.005)]).profile()
    cva = eng.cva(0.01)
    del sim
    out = {
        "paths": paths, "steps": 20,
        "simulation_cold_ms": s_cold_s * 1e3,
        "simulation_wall_ms": s_wall_s * 1e3,
        "fx_option_cold_ms": o_cold_s * 1e3,
        "fx_option_wall_ms": o_wall_s * 1e3,
        "fx_options_5y": {str(kk): {"mc": float(p), "stderr": float(e),
                                    "closed_form": c, "dev_se":
                                    float((p - c) / e)}
                          for kk, p, e, c in zip(strikes, prices, se, cf)},
        "fx_forward_rel_err": float(fwd / m.fx_forward(5.0) - 1.0),
        "ccs_cold_ms": c_cold_s * 1e3, "ccs_wall_ms": c_wall_s * 1e3,
        "ccs_domestic_leg_par_dev": dom - 1.0,
        "ccs_foreign_leg_par_dev": fgn / x0 - 1.0,
        "martingale_rel_err_5y_10y": diag_err,
        "exposure_cold_ms": e_cold_s * 1e3,
        "exposure_wall_ms": e_wall_s * 1e3,
        "ccs10_ee_rel_err_vs_fx_option": ee_err,
        "ccs10_forward_value_max_err": fv_err,
        "ee_plus_ene_minus_fv": decomposition,
        "mirrored_pair_max_netted_ee": float(np.max(np.abs(both.ee))),
        "fx_forward_value_max_err": fxf_err, "ccs10_cva_100bp": cva}
    print(f"phase 32 cross-currency ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "5Y FX options within 4.5 se + 1e-5 of fx_option": all(
            abs(p - c) < 4.5 * e + 1e-5 for p, e, c in zip(prices, se, cf)),
        "FX forward within 1e-3": abs(fwd / m.fx_forward(5.0) - 1.0) < 1e-3,
        "CCS legs par within 5e-4":
            abs(dom - 1.0) < 5e-4 and abs(fgn / x0 - 1.0) < 5e-4,
        "martingale diagnostics within 6e-4":
            all(abs(e) < 6e-4 for e in diag_err.values()),
        "CCS EE within 6e-3 of fx_option(t, X0) / X0":
            all(abs(e) < 6e-3 for e in ee_err.values()),
        "CCS forward value within 8e-4": fv_err < 8e-4,
        "EE + ENE = FV within 1e-12": decomposition < 1e-12,
        "mirrored pair nets to zero EE within 1e-12":
            bool(np.allclose(both.ee, 0.0, atol=1e-12)),
        "FX forward value within 8e-4 while live": fxf_err < 8e-4,
        "FX forward EE zero after expiry":
            bool(np.allclose(fxf.ee[~live], 0.0)),
        "a foreign basis raises EE":
            bool(np.all(sprd.ee[:-1] >= base.ee[:-1] - 1e-12)
                 and sprd.ee[0] > base.ee[0]),
        "CVA positive": cva > 0.0,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 32 failed: {failed}")
    print(f"phase 32 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 32 cross-currency simulation ({paths:,} x 20)": simulate}


def _inflation(torch, smi) -> dict:
    """Phase 33: Jarrow-Yildirim, ``tests/test_inflation.py``'s ``make_jy()``
    on the 20-step semiannual grid at 1,000,000 paths (the cross-currency
    engine at ``bench_cross_currency``'s width; no kernel): the YoY
    forwards, caplets and floorlets against the moment propagation, and a
    ZCIS. Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import HullWhiteModel
    from finmath_tpu_torch.models.inflation import (
        JarrowYildirimModel, JarrowYildirimSimulation)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    paths = XCCY_PATHS
    t_grid = np.arange(0.0, 21.0)
    nom = HullWhiteModel(DiscountCurve(t_grid, np.exp(-0.03 * t_grid)),
                         0.1, 0.01)
    real = HullWhiteModel(DiscountCurve(t_grid, np.exp(-0.01 * t_grid)),
                          0.2, 0.006)
    jy = JarrowYildirimModel(nom, real, 100.0, 0.012, 0.3, 0.1, -0.3)
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)

    def simulate():
        return JarrowYildirimSimulation(jy, td, num_paths=paths, seed=3,
                                        device="cuda")

    s_cold_s, s_wall_s, sim = _walls(torch, simulate, 5)
    y_cold_s, y_wall_s, _ = _walls(
        torch, lambda: sim.mc_yoy_forward(4.0, 5.0), 5)
    k_cold_s, k_wall_s, _ = _walls(
        torch, lambda: sim.mc_yoy_caplet(4.0, 5.0, 0.02), 5)
    yoy = {}
    for t1, t2 in ((4.0, 5.0), (9.0, 10.0)):
        mc, se = sim.mc_yoy_forward(t1, t2)
        naive = float(real.df(t2) / real.df(t1) * nom.df(t1) / nom.df(t2))
        yoy[f"{t1}-{t2}"] = {"mc": mc, "stderr": se,
                             "analytic": jy.yoy_forward(t1, t2),
                             "naive": naive}
    caps = {}
    for kk in (0.01, 0.02, 0.04):
        for is_cap in (True, False):
            mc, se = sim.mc_yoy_caplet(4.0, 5.0, kk, is_caplet=is_cap)
            caps[f"{'cap' if is_cap else 'floor'}let {kk}"] = {
                "mc": mc, "stderr": se,
                "analytic": jy.yoy_caplet(4.0, 5.0, kk, is_caplet=is_cap)}
    zcis_mc = sim.mc_zcis_value(5.0, 0.01)
    zcis_an = jy.zcis_value(5.0, 0.01)
    del sim
    out = {"paths": paths, "steps": 20,
           "simulation_cold_ms": s_cold_s * 1e3,
           "simulation_wall_ms": s_wall_s * 1e3,
           "mc_yoy_forward_cold_ms": y_cold_s * 1e3,
           "mc_yoy_forward_wall_ms": y_wall_s * 1e3,
           "mc_yoy_caplet_cold_ms": k_cold_s * 1e3,
           "mc_yoy_caplet_wall_ms": k_wall_s * 1e3,
           "yoy_forwards": yoy, "yoy_caplets_4y_5y": caps,
           "zcis_5y_1pct": {"mc": zcis_mc, "analytic": zcis_an}}
    print(f"phase 33 Jarrow-Yildirim ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "YoY forwards within 4 se + 1e-6": all(
            abs(v["analytic"] - v["mc"]) < 4 * v["stderr"] + 1e-6
            for v in yoy.values()),
        "YoY forwards closer than the naive ratio": all(
            abs(v["analytic"] - v["mc"]) < abs(v["naive"] - v["mc"])
            for v in yoy.values()),
        "caplets and floorlets within 4 se + 1e-6": all(
            abs(v["analytic"] - v["mc"]) < 4 * v["stderr"] + 1e-6
            for v in caps.values()),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 33 failed: {failed}")
    print(f"phase 33 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 33 Jarrow-Yildirim simulation ({paths:,} x 20)":
                simulate}


def _named_walls(torch, walls):
    """A function ``timed(name, fn)`` that runs ``fn`` as ``_walls`` does
    (a cold call, then the min of 3), records its cold and warm
    milliseconds in ``walls[name]`` and returns its last result."""
    def timed(name, fn):
        cold, warm, out = _walls(torch, fn, 3)
        walls[name] = {"cold_ms": cold * 1e3, "wall_ms": warm * 1e3}
        return out
    return timed


def _equity_exotics(torch, smi):
    """Phase 34: ``bench.py:1676 bench_exotics``' single-asset legs through
    the port (no kernel): the 1M x 250 Black-Scholes facade (S0 100, r 5%,
    sigma 30%, T 1, seed 42, the port's torch stream); the digital at 105,
    the 12-date Asian plain and with the geometric control variate, the
    bridge up-and-out (100, 130), the floating lookback call, and the
    20-product book of ``bench.py:1754-1763`` through ``price_portfolio``
    against the serial loop. Returns the facade (phase 36 hedges on it) and
    the calls phase 6 profiles, by name."""
    import math

    from finmath_tpu_torch.models import (AsianOption, BarrierOption,
                                          DigitalOption, LookbackOption,
                                          price_portfolio)
    from finmath_tpu_torch.models.analytic import (
        barrier_option_value, digital_option_value,
        lookback_floating_strike_value)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, EuropeanOption, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    s0, r, sig, t, n = 100.0, 0.05, 0.3, 1.0, EXOTIC_STEPS
    dt = t / n
    td = TimeDiscretization(initial=0.0, num_steps=n, step=dt)
    torch.cuda.reset_peak_memory_stats()

    def simulate():
        sim = MonteCarloBlackScholesModel(
            td, EXOTIC_PATHS, BlackScholesModel(s0, r, sig), seed=42,
            device="cuda")
        sim.process._lazy_states()
        return sim

    walls = {}
    timed = _named_walls(torch, walls)

    sim = timed("simulation", simulate)
    vd, ed = timed("digital", lambda: DigitalOption(t, 105.0)
                   .get_value_and_error(sim))
    dates = [round((i + 1) * t / 12 / dt) * dt for i in range(12)]
    vp, ep = timed("asian", lambda: AsianOption(dates, 100.0)
                   .get_value_and_error(sim))
    vc, ec = timed("asian_cv", lambda: AsianOption(
        dates, 100.0, control_variate="geometric").get_value_and_error(sim))
    vb, eb = timed("barrier_bridge", lambda: BarrierOption(
        t, 100.0, 130.0, "up-out", monitoring="bridge")
        .get_value_and_error(sim))
    vl, el = timed("lookback", lambda: LookbackOption(t, "floating-call")
                   .get_value_and_error(sim))
    book = [EuropeanOption(t, 85.0 + 5.0 * i, is_call=i % 2 == 0)
            for i in range(8)]
    book += [DigitalOption(t, 95.0 + 5.0 * i) for i in range(4)]
    book += [AsianOption(dates, 90.0 + 10.0 * i) for i in range(3)]
    book += [BarrierOption(t, 100.0, 125.0 + 10.0 * i, "up-out")
             for i in range(3)]
    book += [LookbackOption(t, "floating-call"),
             LookbackOption(t, "fixed-put", strike=100.0)]
    port = timed("portfolio_20", lambda: price_portfolio(sim, book))
    serial = timed("serial_20", lambda: [p.get_value_and_error(sim)
                                         for p in book])
    peak = torch.cuda.max_memory_allocated()
    an_d = digital_option_value(s0, r, sig, t, 105.0)
    an_b = barrier_option_value(s0, r, sig, t, 100.0, 130.0, "up-out")
    an_l = lookback_floating_strike_value(s0, r, sig, t, True)
    bgk = 0.5826 * sig * math.sqrt(dt)
    book_gap = max(max(abs(a - b), abs(ea - eb))
                   for (a, ea), (b, eb) in zip(port, serial))
    out = {"paths": EXOTIC_PATHS, "steps": n,
           "digital_105": {"value": vd, "stderr": ed, "closed_form": an_d},
           "asian_12": {"plain": vp, "plain_stderr": ep, "cv": vc,
                        "cv_stderr": ec, "stderr_reduction": ep / ec},
           "barrier_bridge_up_out": {"value": vb, "stderr": eb,
                                     "continuous_closed_form": an_b},
           "lookback_floating_call": {"value": vl, "stderr": el,
                                      "continuous_closed_form": an_l,
                                      "bgk_band": 2.5 * bgk * s0},
           "portfolio_20_max_gap_to_serial": book_gap,
           "walls": walls, "max_memory_allocated_gb": peak / 1e9}
    print(f"phase 34 equity exotics ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "digital within 4 se + 1e-4": abs(vd - an_d) < 4 * ed + 1e-4,
        "Asian plain and CV within 4 plain se": abs(vp - vc) < 4 * ep,
        "Asian CV cuts the error 5x": ep / ec >= 5.0,
        "bridge barrier within 4 se + 1e-3": abs(vb - an_b) < 4 * eb + 1e-3,
        "lookback inside the BGK band":
            an_l - 2.5 * bgk * s0 - 4 * el < vl < an_l + 4 * el,
        "price_portfolio equals the serial loop within 1e-12":
            book_gap < 1e-12,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 34 failed: {failed}")
    print(f"phase 34 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return sim, {
        f"phase 34 price_portfolio, 20 products ({EXOTIC_PATHS:,} x {n})":
            lambda: price_portfolio(sim, book),
        f"phase 34 bridge barrier ({EXOTIC_PATHS:,} x {n})":
            lambda: BarrierOption(t, 100.0, 130.0, "up-out",
                                  monitoring="bridge").get_value_and_error(
                sim)}


def _multi_asset(torch, smi) -> dict:
    """Phase 35: ``bench.py:1781-1806`` through the port (no kernel): three
    correlated assets (S0 100, 95, 105; vols 25%, 35%, 20%), 1M paths x 30
    steps to T 1.5, seed 11; the exchange against Margrabe, the call on the
    minimum of the first two against Stulz, the geometric-CV basket.
    Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.multi_asset import (
        BasketOption, ExchangeOption, MonteCarloMultiAssetBlackScholesModel,
        MultiAssetBlackScholesModel, RainbowOption, margrabe_exchange_value,
        stulz_rainbow_value)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    s0v, vols, r, t = [100.0, 95.0, 105.0], [0.25, 0.35, 0.2], 0.05, 1.5
    corr = [[1.0, 0.4, 0.2], [0.4, 1.0, 0.5], [0.2, 0.5, 1.0]]
    td = TimeDiscretization(initial=0.0, num_steps=30, step=t / 30)
    model = MultiAssetBlackScholesModel(s0v, r, vols, corr)
    walls = {}
    timed = _named_walls(torch, walls)

    def simulate():
        sim = MonteCarloMultiAssetBlackScholesModel(
            td, MULTI_PATHS, model, seed=11, device="cuda")
        sim.process._lazy_states()
        return sim

    sim = timed("simulation", simulate)
    exchange = ExchangeOption(t, 0, 1)
    rainbow = RainbowOption(t, 100.0, "call-on-min", asset_indices=[0, 1])
    basket = BasketOption(t, [0.4, 0.3, 0.3], 100.0,
                          control_variate="geometric")
    vx, ex = timed("exchange", lambda: exchange.get_value_and_error(sim))
    vr, er = timed("rainbow_min", lambda: rainbow.get_value_and_error(sim))
    vb, eb = timed("basket_cv", lambda: basket.get_value_and_error(sim))
    _, eb_plain = BasketOption(t, [0.4, 0.3, 0.3], 100.0) \
        .get_value_and_error(sim)
    an_x = margrabe_exchange_value(s0v[0], s0v[1], vols[0], vols[1], 0.4, t)
    an_r = stulz_rainbow_value(s0v[0], s0v[1], r, vols[0], vols[1], 0.4, t,
                               100.0, "call-on-min")
    out = {"paths": MULTI_PATHS, "steps": 30, "assets": 3,
           "exchange": {"value": vx, "stderr": ex, "margrabe": an_x},
           "rainbow_call_on_min": {"value": vr, "stderr": er, "stulz": an_r},
           "basket_cv": {"value": vb, "stderr": eb,
                         "plain_stderr": eb_plain},
           "walls": walls}
    print(f"phase 35 multi-asset ({smi}): " + json.dumps(out), flush=True)
    checks = {"exchange within 4 se of Margrabe": abs(vx - an_x) < 4 * ex,
              "call-on-min within 4 se of Stulz": abs(vr - an_r) < 4 * er,
              "basket CV finite": all(map(np.isfinite, (vb, eb)))}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 35 failed: {failed}")
    print(f"phase 35 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 35 multi-asset simulation ({MULTI_PATHS:,} x 3 x 30)":
                simulate}


def _american_hedging(torch, smi, sim) -> dict:
    """Phase 36: ``bench.py:1662-1672``'s ``american_ls_put_1m_x50`` (1M
    paths x 50 steps, K 110 put, seed 77) against CRR at 4,000 steps, and
    ``bench.py:1855-1866``'s delta hedge (call 105) and variance swap on
    phase 34's 1M x 250 facade ``sim`` (no kernel). Returns the calls
    phase 6 profiles, by name."""
    import math

    from finmath_tpu_torch.models.american import (BermudanOption,
                                                   crr_american_price)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.hedging import (DeltaHedgedPortfolio,
                                                  VarianceSwap)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)

    sim50 = MonteCarloBlackScholesModel(
        TimeDiscretization(initial=0.0, num_steps=50, step=0.02),
        AMERICAN_PATHS, BlackScholesModel(100.0, 0.05, 0.3), seed=77,
        device="cuda")
    put = BermudanOption([i * 0.02 for i in range(1, 51)], 110.0,
                         is_call=False)
    v, err = timed("american_ls_put", lambda: put.get_value_and_error(sim50))
    t0 = time.perf_counter()
    crr = crr_american_price(100.0, 0.05, 0.3, 1.0, 110.0, is_call=False,
                             num_steps=4000)
    crr_s = time.perf_counter() - t0
    hedge = DeltaHedgedPortfolio(1.0, 105.0)
    res = timed("delta_hedge", lambda: hedge.simulate(sim))
    swap = VarianceSwap(1.0)
    k = timed("variance_swap_fair_strike", lambda: swap.fair_strike(sim))
    sig, dt = 0.3, 1.0 / EXOTIC_STEPS
    out = {"american_ls_put_1m_x50": {"paths": AMERICAN_PATHS, "value": v,
                                      "stderr": err, "crr_4000": crr,
                                      "crr_host_s": crr_s},
           "delta_hedge": {**res, "replication_dev":
                           res["value"] - res["premium"]},
           "variance_swap": {"fair_strike": k, "dev_vs_sigma2": k - sig ** 2,
                             "bound": 4 * sig ** 2 * math.sqrt(2 * dt)},
           "walls": walls}
    print(f"phase 36 American and hedging ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "LS put below CRR + 3 se": v < crr + 3 * err,
        "LS put above CRR - max(5 se, 1.5%)":
            v > crr - max(5 * err, 0.015 * crr),
        "|hedge value - premium| < 0.25":
            abs(res["value"] - res["premium"]) < 0.25,
        "variance swap within 4 sigma^2 sqrt(2 dt) of sigma^2":
            abs(k - sig ** 2) < 4 * sig ** 2 * math.sqrt(2 * dt),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 36 failed: {failed}")
    print(f"phase 36 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 36 LS put ({AMERICAN_PATHS:,} x 50)":
                lambda: put.get_value_and_error(sim50),
            f"phase 36 delta hedge ({EXOTIC_PATHS:,} x {EXOTIC_STEPS})":
                lambda: hedge.simulate(sim)}


def _structured_is_mlmc(torch, smi) -> dict:
    """Phase 37 (no kernel): the structured products of
    ``tests/test_structured_products.py`` at 1M paths x 50 steps (S0 100,
    r 5%, sigma 30%, T 1, seed 21) against their closed forms;
    ``bench.py:1819-1829``'s importance sampling at 3x spot (seed 13, 1M
    paths) against Black-Scholes; ``mlmc_lookback_call`` at eps 0.03
    against the continuous closed form. Returns the calls phase 6
    profiles, by name."""
    from finmath_tpu_torch.models.analytic import (
        black_scholes_option_value, lookback_floating_strike_value)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.importance_sampling import (
        mc_european_price_importance_sampled)
    from finmath_tpu_torch.models.mlmc import mlmc_lookback_call
    from finmath_tpu_torch.models.structured_products import (
        AutocallableNote, ChooserOption, CliquetOption, CompoundOption,
        ForwardStartOption, autocallable_value_single_observation,
        chooser_option_value, cliquet_option_value, compound_option_value,
        forward_start_option_value)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    s0, r, sig, t = 100.0, 0.05, 0.3, 1.0
    walls = {}
    timed = _named_walls(torch, walls)

    sim = MonteCarloBlackScholesModel(
        TimeDiscretization(initial=0.0, num_steps=50, step=t / 50),
        STRUCTURED_PATHS, BlackScholesModel(s0, r, sig), seed=21,
        device="cuda")
    resets = [0.2, 0.4, 0.6, 0.8, 1.0]
    cases = {
        "forward_start": (ForwardStartOption(0.4, t, 1.05),
                          forward_start_option_value(s0, r, sig, 0.4, t,
                                                     1.05), 0.0),
        "cliquet": (CliquetOption(resets, -0.05, 0.08),
                    cliquet_option_value(r, sig, resets, -0.05, 0.08), 0.0),
        "compound": (CompoundOption(0.5, 5.0, t, 100.0),
                     compound_option_value(s0, r, sig, 0.5, 5.0, t, 100.0),
                     0.0),
        "chooser": (ChooserOption(0.5, t, 100.0),
                    chooser_option_value(s0, r, sig, 0.5, t, 100.0), 1e-3),
        "express_autocall": (
            AutocallableNote([0.5, t], [105.0, 100.0], [0.05, 0.08], 70.0),
            autocallable_value_single_observation(
                s0, r, sig, 0.5, t, 105.0, 0.05, 100.0, 0.08, 70.0), None),
    }
    structured = {}
    for name, (product, an, rel) in cases.items():
        v, e = timed(name, lambda p=product: p.get_value_and_error(sim))
        # 4 standard errors, or the JAX tests' wider bound
        bound = 4 * e + (1e-4 if rel is None else rel * an)
        structured[name] = {"value": v, "stderr": e, "closed_form": an,
                            "bound": bound}
    k = 3.0 * s0
    vi, ei = timed("importance_sampling_3x", lambda:
                   mc_european_price_importance_sampled(
                       13, STRUCTURED_PATHS, s0, r, sig, t, k,
                       device="cuda"))
    _, e_plain = mc_european_price_importance_sampled(
        13, STRUCTURED_PATHS, s0, r, sig, t, k, drift_shift=0.0,
        device="cuda")
    an_is = black_scholes_option_value(s0, r, sig, t, k)
    res = timed(f"mlmc_eps_{MLMC_EPS}", lambda: mlmc_lookback_call(
        s0, r, sig, t, eps=MLMC_EPS, device="cuda"))
    an_l = lookback_floating_strike_value(s0, r, sig, t, True)
    out = {"paths": STRUCTURED_PATHS, "structured": structured,
           "importance_sampling_3x": {"value": vi, "stderr": ei,
                                      "black_scholes": an_is,
                                      "stderr_reduction": e_plain / ei},
           "mlmc": {"eps": MLMC_EPS, "value": res.value,
                    "stderr": res.stderr, "closed_form": an_l,
                    "levels": res.levels, "samples": res.samples,
                    "total_fine_steps": res.total_fine_steps},
           "walls": walls}
    print(f"phase 37 structured, importance sampling, MLMC ({smi}): "
          + json.dumps(out), flush=True)
    checks = {f"{name} within its bound": abs(c["value"] - c["closed_form"])
              < c["bound"] for name, c in structured.items()}
    checks.update({
        "importance sampling within 4 se": abs(vi - an_is) < 4 * ei,
        "MLMC within 2.5 eps": abs(res.value - an_l) < 2.5 * MLMC_EPS,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 37 failed: {failed}")
    print(f"phase 37 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 37 MLMC lookback (eps {MLMC_EPS})":
                lambda: mlmc_lookback_call(s0, r, sig, t, eps=MLMC_EPS,
                                           device="cuda")}


def _digital_parity(sim, strike, maturity, rate) -> dict:
    """The digital cash parity of ``sim`` at ``strike``: call + put against
    the discount factor. Both legs pay on a strict inequality (the JAX
    package's ``_digital_kernel``), so a float32 path that lands exactly on
    the strike pays in neither; the identity is call + put = df (1 - ties /
    N), and ``parity_err`` is its gap."""
    import math

    from finmath_tpu_torch.models.equity_products import DigitalOption

    c, _ = DigitalOption(maturity, strike).get_value_and_error(sim)
    p, _ = DigitalOption(maturity, strike, is_call=False) \
        .get_value_and_error(sim)
    s_t = sim.get_asset_value(maturity).values
    ties = int((s_t == strike).sum())
    df = math.exp(-rate * maturity)
    return {"digital_call_plus_put_minus_df": c + p - df,
            "paths_on_the_strike": ties,
            "parity_err": c + p - df * (1.0 - ties / s_t.numel())}


def _heston(torch, smi) -> dict:
    """Phase 38 (no kernel): ``bench.py:1616-1625``'s ``heston_qe_1m_x64``
    (1M antithetic paths x 64 QE steps, T 1.5) and the Euler engine at 1M
    x 128 against the characteristic-function prices under
    ``tests/test_heston.py``'s bounds; the facade at 1M paths x 100 steps
    on ``tests/test_heston_facade.py``'s parameters (its bounds, the
    digital cash parity within 1e-9, the peak memory); the calibration
    round trip of ``tests/test_heston.py:207-220`` in host seconds.
    Returns the calls phase 6 profiles, by name."""
    import math

    from finmath_tpu_torch.models.black_scholes import EuropeanOption
    from finmath_tpu_torch.models.heston import (
        HestonParams, MonteCarloHestonModel, calibrate_heston,
        heston_characteristic_prices, mc_heston_european_prices)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    ks = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    hp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05, xi=0.6,
                      rho=-0.7)
    ref = heston_characteristic_prices(hp, 1.5, ks)
    ev_cir = hp.theta + (hp.v0 - hp.theta) * math.exp(-hp.kappa * 1.5)

    def engine(scheme, steps):
        return lambda: mc_heston_european_prices(
            hp, 1.5, ks, num_paths=HESTON_PATHS, num_steps=steps,
            scheme=scheme, antithetic=True, device="cuda")

    out = {"paths": HESTON_PATHS}
    for name, scheme, steps in (("heston_qe_1m_x64", "qe", 64),
                                ("heston_euler_1m_x128", "euler", 128)):
        px, fwd, ev = timed(name, engine(scheme, steps))
        out[name] = {"prices": px.tolist(), "cf": ref.tolist(),
                     "max_abs_dev_vs_cf": float(np.abs(px - ref).max()),
                     "max_rel_dev_vs_cf": float(np.abs(px - ref).max()
                                                / ref.min()),
                     "fwd_err": fwd - 100.0, "ev": ev, "ev_cir": ev_cir}

    fp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05, xi=0.4,
                      rho=-0.6)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    fks = [90.0, 100.0, 110.0]
    f_ref = heston_characteristic_prices(fp, 1.0, fks)

    def facade():
        sim = MonteCarloHestonModel(td, HESTON_PATHS, fp, seed=17,
                                    device="cuda")
        return sim, [EuropeanOption(1.0, k).get_value(sim) for k in fks]

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    sim, eur = timed("heston_facade_1m_x100", facade)
    peak = torch.cuda.max_memory_allocated()
    fwd = float(sim.get_asset_value(1.0).get_average())
    out["facade"] = {"european": eur, "cf": f_ref.tolist(),
                     "fwd_err": fwd - 100.0 * math.exp(0.03),
                     **_digital_parity(sim, 100.0, 1.0, 0.03),
                     "max_memory_allocated_gb": peak / 1e9,
                     "peak_above_live_gb": (peak - live) / 1e9}
    del sim

    mats = [0.5, 1.0, 2.0]
    cp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05, xi=0.4,
                      rho=-0.6)
    targets = [heston_characteristic_prices(cp, t, ks) for t in mats]
    t0 = time.perf_counter()
    res = calibrate_heston(100.0, 0.03, mats, [ks] * 3, targets,
                           x0=HestonParams(100.0, 0.03, v0=0.09, kappa=0.5,
                                           theta=0.09, xi=0.8, rho=-0.2))
    out["calibration"] = {"host_s": time.perf_counter() - t0,
                          "rms": res.rms_price_error,
                          "iterations": res.iterations,
                          "v0": res.params.v0, "rho": res.params.rho,
                          "theta": res.params.theta}
    out["walls"] = walls
    print(f"phase 38 Heston ({smi}): " + json.dumps(out), flush=True)
    qe, eu, fa = (out["heston_qe_1m_x64"], out["heston_euler_1m_x128"],
                  out["facade"])
    checks = {
        "QE within 0.12 of the CF": qe["max_abs_dev_vs_cf"] < 0.12,
        "QE forward within 0.15": abs(qe["fwd_err"]) < 0.15,
        "QE E[V_T] within 3e-3 of the CIR mean":
            abs(qe["ev"] - ev_cir) < 3e-3,
        "Euler within 0.15 of the CF": eu["max_abs_dev_vs_cf"] < 0.15,
        "Euler forward within 0.2": abs(eu["fwd_err"]) < 0.2,
        "facade Europeans within 0.015 ref + 0.08": all(
            abs(v - r) < 0.015 * r + 0.08 for v, r in zip(eur, f_ref)),
        "facade martingale within 0.35": abs(fa["fwd_err"]) < 0.35,
        "facade digital cash parity within 1e-9":
            abs(fa["parity_err"]) < 1e-9,
        "calibration rms below 1e-6": res.rms_price_error < 1e-6,
        "calibration v0, rho, theta": (
            abs(res.params.v0 / cp.v0 - 1) < 1e-3
            and abs(res.params.rho / cp.rho - 1) < 1e-2
            and abs(res.params.theta / cp.theta - 1) < 1e-2),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 38 failed: {failed}")
    print(f"phase 38 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 38 heston QE (1M x 64)": engine("qe", 64),
            "phase 38 heston Euler (1M x 128)": engine("euler", 128),
            "phase 38 heston facade (1M x 100)": facade}


def _jumps_gaussian(torch, smi) -> dict:
    """Phase 39 (no kernel): ``bench.py:1627-1643``'s ``merton_1m_x16`` and
    ``variance_gamma_1m_x16`` against the series and the Fourier prices
    (``tests/test_merton.py:119``'s rtol 8e-3, ``tests/test_fourier_models
    .py:122``'s 1.5e-2), Bates at 1M antithetic paths x 96 steps against
    its CF (``tests/test_bates.py:83-86``), Bachelier and the displaced
    lognormal at 1M paths within 4 standard errors of their closed forms,
    and the Merton facade at 1M x 50 (the European within 1.5e-2 of the
    series, the digital cash parity within 1e-9). Returns the calls phase 6
    profiles, by name."""
    import math

    from finmath_tpu_torch.models.bachelier import (
        BachelierParams, DisplacedLognormalParams, bachelier_analytic_price,
        bachelier_terminal_std, displaced_analytic_price,
        mc_bachelier_european_prices, mc_displaced_european_prices)
    from finmath_tpu_torch.models.bates import (
        BatesParams, bates_characteristic_prices, mc_bates_european_prices)
    from finmath_tpu_torch.models.black_scholes import EuropeanOption
    from finmath_tpu_torch.models.merton import (
        MertonParams, MonteCarloMertonModel, mc_merton_european_prices,
        merton_series_prices)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    from finmath_tpu_torch.models.variance_gamma import (
        VarianceGammaParams, mc_vg_european_prices, vg_analytic_prices)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    ks = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    n = JUMP_PATHS
    mp = MertonParams(100.0, 0.05, 0.2, jump_intensity=0.6,
                      jump_size_mean=-0.15, jump_size_std=0.25)
    vp = VarianceGammaParams(100.0, 0.04, sigma=0.18, theta=-0.14, nu=0.25)
    bp = BatesParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05, xi=0.6,
                     rho=-0.7, jump_intensity=0.6, jump_size_mean=-0.12,
                     jump_size_std=0.18)
    gp = BachelierParams(100.0, 0.03, volatility=15.0)
    dp = DisplacedLognormalParams(100.0, 0.03, 0.2, displacement=30.0)
    calls = {
        "merton_1m_x16": lambda: mc_merton_european_prices(
            mp, 1.0, ks, num_paths=n, num_steps=16, antithetic=True,
            device="cuda"),
        "variance_gamma_1m_x16": lambda: mc_vg_european_prices(
            vp, 1.25, ks, num_paths=n, num_steps=16, antithetic=True,
            device="cuda"),
        "bates_1m_x96": lambda: mc_bates_european_prices(
            bp, 1.5, ks, num_paths=n, num_steps=96, antithetic=True,
            device="cuda"),
        "bachelier_1m": lambda: mc_bachelier_european_prices(
            gp, 1.25, [-20.0, 80.0, 100.0, 120.0], num_paths=n, seed=6,
            device="cuda"),
        "displaced_1m": lambda: mc_displaced_european_prices(
            dp, 1.25, ks, num_paths=n, seed=8, device="cuda"),
    }
    refs = {
        "merton_1m_x16": merton_series_prices(mp, 1.0, ks),
        "variance_gamma_1m_x16": vg_analytic_prices(vp, 1.25, ks),
        "bates_1m_x96": bates_characteristic_prices(bp, 1.5, ks),
        "bachelier_1m": bachelier_analytic_price(
            gp, 1.25, [-20.0, 80.0, 100.0, 120.0]),
        "displaced_1m": displaced_analytic_price(dp, 1.25, ks),
    }
    # a call payoff's spread is at most the terminal value's
    se = {"bachelier_1m": math.exp(-0.03 * 1.25)
          * bachelier_terminal_std(gp, 1.25) / math.sqrt(n),
          "displaced_1m": math.exp(-0.03 * 1.25) * 130.0 * math.exp(
              0.03 * 1.25) * math.sqrt(math.expm1(0.04 * 1.25))
          / math.sqrt(n)}
    out = {"paths": n}
    for name, fn in calls.items():
        res = timed(name, fn)
        px = np.asarray(res[0])
        out[name] = {"prices": px.tolist(), "reference": refs[name].tolist(),
                     "max_rel_dev": float(np.max(np.abs(px - refs[name])
                                                 / refs[name])),
                     "max_abs_dev": float(np.max(np.abs(px - refs[name]))),
                     "fwd": res[1]}
        if len(res) == 3:
            out[name]["ev"] = res[2]
    td = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)

    def facade():
        sim = MonteCarloMertonModel(td, n, mp, seed=9, device="cuda")
        return sim, EuropeanOption(1.0, 100.0).get_value(sim)

    sim, eur = timed("merton_facade_1m_x50", facade)
    m_ref = refs["merton_1m_x16"][2]
    out["merton_facade"] = {"european": eur, "series": m_ref,
                            **_digital_parity(sim, 100.0, 1.0, 0.05)}
    del sim
    out["walls"] = walls
    print(f"phase 39 jumps and Gaussian models ({smi}): " + json.dumps(out),
          flush=True)
    ev_cir = bp.theta + (bp.v0 - bp.theta) * math.exp(-bp.kappa * 1.5)
    b = out["bates_1m_x96"]
    checks = {
        "Merton within rtol 8e-3 of the series":
            out["merton_1m_x16"]["max_rel_dev"] < 8e-3,
        "VG within rtol 1.5e-2 of the Fourier prices":
            out["variance_gamma_1m_x16"]["max_rel_dev"] < 1.5e-2,
        "Bates within rtol 1.2e-2 of the CF": b["max_rel_dev"] < 1.2e-2,
        "Bates forward within 0.15": abs(b["fwd"] - 100.0) < 0.15,
        "Bates E[V_T] within 3e-3 of the CIR mean":
            abs(b["ev"] - ev_cir) < 3e-3,
        "Bachelier within 4 standard errors":
            out["bachelier_1m"]["max_abs_dev"] < 4 * se["bachelier_1m"],
        "displaced within 4 standard errors":
            out["displaced_1m"]["max_abs_dev"] < 4 * se["displaced_1m"],
        "Merton facade European within 1.5e-2 of the series":
            abs(eur - m_ref) < 1.5e-2 * m_ref,
        "Merton facade digital cash parity within 1e-9":
            abs(out["merton_facade"]["parity_err"]) < 1e-9,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 39 failed: {failed}")
    print(f"phase 39 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {f"phase 39 {name}": fn for name, fn in calls.items()}


def _local_vol(torch, smi) -> dict:
    """Phase 40 (no kernel): ``tests/test_local_vol.py``'s skewed SSVI
    surface at 1M paths x 100 steps (seed 12): the Black-implied vols of
    ``european_call_values`` at strikes 80-120 within 0.004 of the surface
    (the Gyongy round trip, ``:113-124``); the flat surface at 1M x 50
    (seed 11) against term-vol Black-Scholes (``:103-111``); one model
    step's local variance (the nested ``torch.func.jvp``) under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
    raises. Returns the calls phase 6 profiles, by name."""
    import math

    from finmath_tpu_torch.models.analytic import (
        black_implied_volatility, black_scholes_option_value)
    from finmath_tpu_torch.models.local_vol import (
        LocalVolatilityModel, MonteCarloLocalVolModel, SSVISurface,
        european_call_values)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=0.6, gamma=0.4)
    flat = SSVISurface(sigma0=0.28, sigma_inf=0.18, tau=1.5, rho=0.0,
                       eta=0.0)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    model = LocalVolatilityModel(100.0, 0.03, surf, td)
    strikes = [80.0, 90.0, 100.0, 110.0, 120.0]

    state = model.initial_state(LOCAL_VOL_PATHS, "cuda") + 0.1 * torch.randn(
        1, LOCAL_VOL_PATHS, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.drift(7, state)
        model.factor_loadings(7, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def skew():
        sim = MonteCarloLocalVolModel(td, LOCAL_VOL_PATHS, model, seed=12,
                                      device="cuda")
        return european_call_values(sim, strikes, [1.0])

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    vals = timed("local_vol_skew_1m_x100", skew)
    peak = torch.cuda.max_memory_allocated()
    fwd, df = 100.0 * math.exp(0.03), math.exp(-0.03)
    iv_devs = [black_implied_volatility(fwd, k, 1.0, vals[0, j, 0] / df)
               - surf.implied_volatility(math.log(k / fwd), 1.0)
               for j, k in enumerate(strikes)]
    ftd = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)
    fsim = MonteCarloLocalVolModel(
        ftd, LOCAL_VOL_PATHS, LocalVolatilityModel(100.0, 0.03, flat, ftd),
        seed=11, device="cuda")
    fvals = european_call_values(fsim, [80.0, 100.0, 125.0], [1.0])
    sig = math.sqrt(flat.theta(1.0))
    flat_rows = [(float(fvals[0, j, 0]), float(fvals[0, j, 1]),
                  black_scholes_option_value(100.0, 0.03, sig, 1.0, k))
                 for j, k in enumerate([80.0, 100.0, 125.0])]
    del fsim
    out = {"paths": LOCAL_VOL_PATHS, "iv_devs": iv_devs,
           "max_abs_iv_dev": max(abs(d) for d in iv_devs),
           "flat_vs_black_scholes": flat_rows,
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9, "walls": walls,
           "jvp_step_host_syncs": 0}
    print(f"phase 40 Dupire local vol ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "Gyongy round trip within 0.004": out["max_abs_iv_dev"] < 0.004,
        "flat surface within 4 se + 1e-3 of Black-Scholes": all(
            abs(v - an) < 4 * e + 1e-3 * an for v, e, an in flat_rows),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 40 failed: {failed}")
    print(f"phase 40 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 40 local vol simulation (1M x 100)": skew}


def _slv(torch, smi) -> dict:
    """Phase 41 (no kernel): ``bench.py:1869-1932 bench_slv``, the Heston-SLV
    particle method at 409,600 paths x 100 steps (the skewed SSVI surface,
    xi 0.8, rho -0.7, strikes 85, 100, 115, seeds from 21 on as in the
    bench): the Black-implied smile within 0.008 of the surface
    (``tests/test_slv.py:99-108``), E[V_1] within 0.004 of the CIR mean,
    the martingale within 4 standard errors + 0.05, ``leverage_at(1.0)``,
    the wall (a cold call, then the min of 3), the peak memory and the
    device operations a step. Returns the calls phase 6 profiles, by
    name."""
    import math

    from finmath_tpu_torch.models.analytic import black_implied_volatility
    from finmath_tpu_torch.models.heston import HestonParams
    from finmath_tpu_torch.models.local_vol import (SSVISurface,
                                                    european_call_values)
    from finmath_tpu_torch.models.slv import (HestonSLVModel,
                                              MonteCarloHestonSLVModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=0.6, gamma=0.4)
    hp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.06, xi=0.8,
                      rho=-0.7)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    model = HestonSLVModel(hp, surf, td)
    strikes = [85.0, 100.0, 115.0]
    seeds = iter(range(21, 40))
    last = {}

    def run():
        sim = MonteCarloHestonSLVModel(td, SLV_PATHS, model,
                                       seed=next(seeds), device="cuda")
        last["sim"] = sim
        return european_call_values(sim, strikes, [1.0])

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    vals = timed("slv_particle_409600_x100", run)
    peak = torch.cuda.max_memory_allocated()
    sim = last["sim"]
    fwd, df = 100.0 * math.exp(0.03), math.exp(-0.03)
    iv_devs = [black_implied_volatility(fwd, k, 1.0, vals[0, j, 0] / df)
               - surf.implied_volatility(math.log(k / fwd), 1.0)
               for j, k in enumerate(strikes)]
    v1 = float(sim.get_variance_value(1.0).get_average())
    s1 = sim.get_asset_value(1.0)
    ev_cir = hp.theta + (hp.v0 - hp.theta) * math.exp(-hp.kappa)
    lev = sim.leverage_at(1.0, strikes)
    ops = _device_busy(torch, lambda: MonteCarloHestonSLVModel(
        td, SLV_PATHS, model, seed=99, device="cuda").process._lazy_states())
    del sim, last["sim"]
    out = {"paths": SLV_PATHS, "steps": 100, "iv_devs": iv_devs,
           "max_abs_iv_dev": max(abs(d) for d in iv_devs),
           "ev1": v1, "ev1_cir": ev_cir,
           "martingale_err": float(s1.get_average()) - fwd,
           "martingale_se": float(s1.get_standard_error()),
           "leverage_at_1": lev.tolist(),
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9,
           "device_ops_per_step": ops["device_ops"] / 100,
           "simulation_profile": ops, "walls": walls}
    print(f"phase 41 Heston-SLV ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "smile within 0.008 of the surface": out["max_abs_iv_dev"] < 0.008,
        "E[V_1] within 0.004 of the CIR mean": abs(v1 - ev_cir) < 0.004,
        "martingale within 4 se + 0.05": abs(out["martingale_err"])
            < 4 * out["martingale_se"] + 0.05,
        "leverage finite and inside the clip": bool(
            np.all(np.isfinite(lev)) and np.all(lev > model.leverage_min)
            and np.all(lev < model.leverage_max)),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 41 failed: {failed}")
    print(f"phase 41 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 41 SLV simulation (409,600 x 100)": run}


def _portfolio_credit(torch, smi) -> dict:
    """Phase 42 (no kernel): ``bench.py:2007 bench_portfolio_credit``, the
    one-factor Gaussian copula on 125 names (hazards U(0.005, 0.06) and
    betas U(0.3, 0.7) from ``default_rng(1)``, recovery 0.4, notionals
    1/125) at 1M antithetic paths (seed 7), horizons 1-10 years, the 3-7%
    tranche, P(>= k) for k = 1, 5, 10: the ETL at every horizon within 4
    standard errors + 1e-6 of the exact recursion
    (``tests/test_portfolio_credit.py:167``), P(>= k) at 5 years within 5
    standard errors + 1e-4 of it (``:177``), both monotone in t
    (``:184-185``); the walls of the latent draw and of the statistics (a
    cold call, then the min of 3) and the peak memory above what is live.
    Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.credit import SurvivalCurve
    from finmath_tpu_torch.models.portfolio_credit import (
        GaussianCopulaPortfolio, GaussianCopulaSimulation)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    rng = np.random.default_rng(1)
    hazards = rng.uniform(0.005, 0.06, 125)
    betas = rng.uniform(0.3, 0.7, 125)
    pf = GaussianCopulaPortfolio(
        [SurvivalCurve([0.0], [h]) for h in hazards], betas=betas,
        recoveries=0.4, notionals=np.full(125, 1 / 125))
    times, ks = np.arange(1.0, 11.0), (1, 5, 10)
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    sim = timed("latent_125x1m", lambda: GaussianCopulaSimulation(
        pf, num_paths=COPULA_PATHS, seed=7, device="cuda"))

    def stats():
        return sim.tranche_statistics(times, 0.03, 0.07, ks=ks)

    st = timed("tranche_statistics_10_horizons", stats)
    peak = torch.cuda.max_memory_allocated()
    exact = np.array([pf.expected_tranche_loss(t, 0.03, 0.07)
                      for t in times])
    pk5 = np.array([pf.kth_to_default_probability(5.0, k) for k in ks])
    pk_se = np.sqrt(pk5 * (1.0 - pk5) / COPULA_PATHS)
    out = {"names": 125, "paths": COPULA_PATHS, "horizons": len(times),
           "etl": st["etl"].tolist(), "etl_stderr": st["etl_stderr"].tolist(),
           "etl_exact": exact.tolist(),
           "etl_z": ((st["etl"] - exact) / st["etl_stderr"]).tolist(),
           "kth_prob_5y": st["kth_prob"][4].tolist(),
           "kth_prob_5y_exact": pk5.tolist(),
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9, "walls": walls}
    print(f"phase 42 portfolio credit ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "ETL within 4 se + 1e-6 of the exact recursion": bool(np.all(
            np.abs(st["etl"] - exact) < 4 * st["etl_stderr"] + 1e-6)),
        "P(>= k) at 5y within 5 se + 1e-4 of the exact recursion": bool(
            np.all(np.abs(st["kth_prob"][4] - pk5) < 5 * pk_se + 1e-4)),
        "ETL and P(>= k) monotone in t": bool(
            np.all(np.diff(st["etl"]) > -1e-15)
            and np.all(np.diff(st["kth_prob"], axis=0) > -1e-15)),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 42 failed: {failed}")
    print(f"phase 42 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 42 copula tranche statistics (125 x 1M, 10 horizons)":
            stats}


def _commodity(torch, smi) -> dict:
    """Phase 43 (no kernel): Schwartz-Smith on ``tests/test_commodity.py``'s
    model at 1M antithetic paths x 24 monthly steps (seed 2): the futures
    martingale at 1 year for four maturities within 4 standard errors +
    1e-9 (``:80``), calls and puts on the 2-year future within 4.5 standard
    errors + 1e-6 of Black-76 (``:94, :100``), the calendar spread within
    4.5 standard errors + 1e-6 of Margrabe and above the struck one
    (``:106``), the spot's mean within 4 standard errors of the futures
    price; the walls and the peak memory. Returns the calls phase 6
    profiles, by name."""
    import math

    from finmath_tpu_torch.models.commodity import (SchwartzSmithModel,
                                                    SchwartzSmithSimulation)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    model = SchwartzSmithModel(chi0=0.1, xi0=math.log(60.0), kappa=1.5,
                               sigma_chi=0.35, sigma_xi=0.15, rho=0.3,
                               mu_star=0.01, lambda_chi=0.05)
    td = TimeDiscretization(initial=0.0, num_steps=24, step=1 / 12)

    def simulate():
        return SchwartzSmithSimulation(model, td, num_paths=COMMODITY_PATHS,
                                       seed=2, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    sim = timed("simulation_1m_x24", simulate)
    mats, strikes = [1.5, 2.0, 3.0, 5.0], [55.0, 65.0, 75.0]
    fut, fut_se = timed("futures_4", lambda: sim.mc_futures_prices(1.0, mats))
    calls, calls_se = timed("calls_3", lambda: sim.mc_option_on_future(
        1.0, 2.0, strikes, 0.97))
    puts, puts_se = timed("puts_3", lambda: sim.mc_option_on_future(
        1.0, 2.0, strikes, 0.97, is_call=False))
    spread, spread_se = timed("calendar_spread", lambda: sim.mc_calendar_spread(
        1.0, 1.5, 2.0, 0.0, 0.97))
    struck, _ = sim.mc_calendar_spread(1.0, 1.5, 2.0, 1.0, 0.97)
    s1 = sim.spot(1.0)
    peak = torch.cuda.max_memory_allocated()
    f0 = model.futures_price(mats)
    bl_c = [model.option_on_future(1.0, 2.0, k, 0.97) for k in strikes]
    bl_p = [model.option_on_future(1.0, 2.0, k, 0.97, is_call=False)
            for k in strikes]
    mg = model.calendar_spread_margrabe(1.0, 1.5, 2.0, 0.97)
    spot_mean, spot_se = s1.get_average(), s1.get_standard_error()
    out = {"paths": COMMODITY_PATHS, "steps": 24,
           "futures": fut.tolist(), "futures_se": fut_se.tolist(),
           "futures_exact": f0.tolist(),
           "calls": calls.tolist(), "calls_black76": bl_c,
           "puts": puts.tolist(), "puts_black76": bl_p,
           "spread": spread, "spread_se": spread_se, "margrabe": mg,
           "struck_spread": struck, "spot_1y": spot_mean,
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9, "walls": walls}
    print(f"phase 43 Schwartz-Smith ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "futures martingale within 4 se + 1e-9": bool(
            np.all(np.abs(fut - f0) < 4 * fut_se + 1e-9)),
        "calls within 4.5 se + 1e-6 of Black-76": bool(
            np.all(np.abs(calls - bl_c) < 4.5 * calls_se + 1e-6)),
        "puts within 4.5 se + 1e-6 of Black-76": bool(
            np.all(np.abs(puts - bl_p) < 4.5 * puts_se + 1e-6)),
        "spread within 4.5 se + 1e-6 of Margrabe":
            abs(spread - mg) < 4.5 * spread_se + 1e-6,
        "struck spread below the unstruck": struck < spread,
        "spot mean within 4 se of the futures price":
            abs(spot_mean - float(model.futures_price(1.0))) < 4 * spot_se,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 43 failed: {failed}")
    print(f"phase 43 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 43 Schwartz-Smith simulation (1M x 24)": simulate}


def _market_risk_capital(torch, smi) -> dict:
    """Phase 44 (no kernel): ``tests/test_risk.py``'s convex book (4 options
    on 2 underlyings) at 1M scenarios (seed 5): ES > VaR > 0, the Euler
    allocation summing to the ES within 1e-9 (``:83``), the short leg's
    component negative, full revaluation below delta-normal (net long
    gamma), vol shocks adding risk; the delta book at 1M scenarios within
    2% of delta-normal (``:92``); the historical estimator on 500 days of
    ``default_rng(0)`` returns; then SA-CCR EAD and KVA (host) on phase
    25's 10-year par-swap exposure profile at 50,000 paths, finite and
    positive (``tests/test_regulatory.py:233-236``). The walls and the peak
    memory. Returns the calls phase 6 profiles, by name."""
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import exposure as xv
    from finmath_tpu_torch.models.regulatory import (SACCRTrade, kva,
                                                     saccr_ead_profile)
    from finmath_tpu_torch.models.risk import MarketRiskEngine, OptionBook

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    cov = np.array([[0.04, 0.012], [0.012, 0.09]])
    book = OptionBook(spots=[100.0, 50.0], rate=0.02,
                      underlying_index=[0, 0, 1, 1],
                      strikes=[100.0, 110.0, 50.0, 45.0],
                      expiries=[0.5, 1.0, 0.25, 1.0],
                      vols=[0.2, 0.22, 0.3, 0.28],
                      notionals=[100.0, -50.0, 80.0, 40.0],
                      is_call=[True, True, True, False])
    eng = MarketRiskEngine(book, horizon=1 / 252, device="cuda")

    def parametric():
        return eng.parametric_mc(cov, num_scenarios=RISK_SCENARIOS,
                                 quantile=0.99, seed=5)

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    rep = timed("parametric_1m", parametric)
    peak = torch.cuda.max_memory_allocated()
    vega = timed("parametric_vol_shocks_1m", lambda: eng.parametric_mc(
        cov, num_scenarios=RISK_SCENARIOS, seed=5,
        vol_covariance=np.diag([1.0, 1.0])))
    dn_convex = eng.delta_normal_var(cov, 0.99)
    delta_eng = MarketRiskEngine(
        OptionBook(spots=[100.0], rate=0.02, underlying_index=[0],
                   strikes=[20.0], expiries=[1.0], vols=[0.2],
                   notionals=[100.0]), horizon=1 / 252, device="cuda")
    cov1 = np.array([[0.04]])
    drep = timed("delta_book_1m", lambda: delta_eng.parametric_mc(
        cov1, num_scenarios=RISK_SCENARIOS, seed=7))
    dn = delta_eng.delta_normal_var(cov1, 0.99)
    hist = np.random.default_rng(0).multivariate_normal([0, 0], cov / 252,
                                                        size=500)
    hrep = timed("historical_500", lambda: eng.historical(hist,
                                                          quantile=0.99))
    # SA-CCR and KVA on phase 25's 10Y par payer swap profile
    setup = build_atm_calibration(num_paths=EXPOSURE_PATHS, num_factors=1,
                                  device="cuda")
    model, p0 = setup.model, setup.covariance.initial_parameters
    par = float(par_swap_rate(model.forward_curve, model.discount_curve,
                              model.tenor_times[4:21]))
    xeng = xv.SwapExposureEngine(model, first_index=4, last_index=20,
                                 strike=par, num_paths=EXPOSURE_PATHS,
                                 num_factors=1, quantiles=(0.95, 0.99),
                                 device="cuda")
    prof = xeng.profile(p0)
    tenor = model.tenor_times
    trades = [SACCRTrade(1.0, float(tenor[4]), float(tenor[20]))]
    t0 = time.perf_counter()
    ead = saccr_ead_profile(prof, trades)
    kva_value = kva(prof, trades, counterparty_hazard_rate=0.02)
    host_ms = (time.perf_counter() - t0) * 1e3

    def report(r):
        return {"var": r.var, "es": r.expected_shortfall,
                "mean_pnl": r.mean_pnl, "stderr_var": r.stderr_var,
                "component_es": r.component_es.tolist()}

    out = {"scenarios": RISK_SCENARIOS, "convex": report(rep),
           "convex_vol_shocks": report(vega), "delta_normal_convex": dn_convex,
           "delta_book": report(drep), "delta_normal": dn,
           "delta_book_gap": abs(drep.var - dn) / dn,
           "historical_500": report(hrep),
           "euler_identity_err": abs(float(np.sum(rep.component_es))
                                     - rep.expected_shortfall),
           "saccr_dates": len(prof.times), "ead": ead.tolist(),
           "kva": kva_value, "saccr_kva_host_ms": host_ms,
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9, "walls": walls}
    print(f"phase 44 market risk and capital ({smi}): " + json.dumps(out),
          flush=True)
    checks = {
        "ES > VaR > 0": rep.expected_shortfall > rep.var > 0,
        "Euler allocation sums to the ES within 1e-9":
            out["euler_identity_err"] < 1e-9,
        "the short leg's component negative": rep.component_es[1] < 0,
        "convex book below delta-normal": rep.var < dn_convex,
        "vol shocks add risk": vega.var > rep.var,
        "delta book within 2% of delta-normal": out["delta_book_gap"] < 0.02,
        "historical finite, ES >= VaR": bool(
            np.isfinite(hrep.var) and hrep.expected_shortfall >= hrep.var),
        "EAD finite, positive at the first date": bool(
            ead[0] > 0.0 and np.all(np.isfinite(ead))),
        "KVA finite and positive": bool(np.isfinite(kva_value)
                                        and kva_value > 0.0),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 44 failed: {failed}")
    print(f"phase 44 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 44 parametric VaR (1M scenarios)": parametric}


def _pde(torch, smi) -> dict:
    """Phase 45 (no kernel): the finite-difference layer at the JAX
    package's shapes (``BENCHMARKS.md``, "Finite-difference layer"):
    ``tests/test_pde.py``'s European call and put (200 x 401) within 2e-3
    of Black-Scholes (``:45, :50``); an 81-strike strip (60-140) within the
    strip's bound (``:134-137``) and a 32-vol (0.15-0.46) x 81-strike ladder
    (200 x 401 x 2,592) within the ladder's (``:139-149``) over the test's
    strike span 90-110, the error over the whole ladder printed (off that
    span the low-vol, far out-of-the-money calls, held to an absolute
    6e-3, carry the Crank-Nicolson kink's error); the American put (400 x
    801) within 2e-3 of CRR at 4,000 steps (``:84-88``) and an 81-strike
    American put strip (400 x 801) within 3e-3 of CRR at 2,000 steps at the
    test's strikes 100 and 120 (``:146-149``), the gap over the strip
    printed; the digital (400 x 801) within 2e-3 (``:68``); the flat SSVI
    local-vol call within 4e-3 of Black-Scholes (``:251-263``) and the
    skewed one within 4 standard errors + 0.02 of the port's local-vol
    Monte Carlo at 200,000 paths (``:265-291``); vega by autograd (100 x
    401) within 2% of the closed form (``:164-187``); the skewed call's
    grid on the card against the same solve on the CPU within 1e-12 of
    the largest value. The walls (a cold call, then the min of 3), the
    peak memory, and the device operations a step of the call and of the
    local-vol solve (from the profiles of a 20- and a 40-step solve).
    Returns the calls phase 6 profiles, by name."""
    import math
    from statistics import NormalDist

    from finmath_tpu_torch.models.american import crr_american_price
    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.local_vol import (
        LocalVolatilityModel, MonteCarloLocalVolModel, SSVISurface,
        european_call_values)
    from finmath_tpu_torch.models.pde import (
        FDMAmericanPutOption, FDMBlackScholesModel, FDMDigitalOption,
        FDMEuropeanCallOption, FDMEuropeanPutOption, FDMLocalVolatilityModel,
        fdm_black_scholes_prices, theta_scheme_solve)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    t_phase = time.perf_counter()
    walls = {}
    timed = _named_walls(torch, walls)
    s0, r, sigma, mat, k = 100.0, 0.05, 0.30, 1.0, 110.0

    def bs_model(nt, nx):
        return FDMBlackScholesModel(
            num_timesteps=nt, num_spacesteps=nx, num_standard_deviations=8.0,
            center=s0, theta=0.5, initial_value=s0, risk_free_rate=r,
            volatility=sigma)

    def lv_model(surface, nsd, ref, nt=200):
        return FDMLocalVolatilityModel(
            num_timesteps=nt, num_spacesteps=400,
            num_standard_deviations=nsd, theta=0.5, initial_value=s0,
            risk_free_rate=r, surface=surface, reference_vol=ref)

    def bs(vol, strike, is_call=True):
        return black_scholes_option_value(s0, r, vol, mat, strike, is_call)

    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    model = bs_model(200, 400)

    def call():
        return FDMEuropeanCallOption(mat, k).value(model, device="cuda")

    call_v = timed("european_call_200x401", call)
    put_v = FDMEuropeanPutOption(mat, k).value(model, device="cuda")
    strikes = np.linspace(60.0, 140.0, PDE_STRIKES)
    vols = (0.15 + 0.01 * np.arange(PDE_VOLS))[:, None]
    strip = timed("strip_81_200x401", lambda: fdm_black_scholes_prices(
        s0, r, sigma, mat, strikes, device="cuda"))

    def ladder():
        return fdm_black_scholes_prices(s0, r, vols, mat, strikes,
                                        device="cuda")

    lad = timed("ladder_32x81_200x401", ladder)
    am_model = bs_model(400, 800)
    am_put = timed("american_put_400x801", lambda: FDMAmericanPutOption(
        mat, k).value(am_model, device="cuda"))
    am_strip = timed("american_strip_81_400x801",
                     lambda: fdm_black_scholes_prices(
                         s0, r, sigma, mat, strikes, is_call=False,
                         american=True, num_timesteps=400,
                         num_spacesteps=800, device="cuda"))
    digital = timed("digital_400x801", lambda: FDMDigitalOption(
        mat, k).value(am_model, device="cuda"))
    flat = lv_model(SSVISurface(sigma0=sigma, sigma_inf=sigma, tau=1.0,
                                rho=0.0, eta=0.0, gamma=0.5), 8.0, sigma)
    flat_v = timed("local_vol_flat_200x401", lambda: FDMEuropeanCallOption(
        mat, k).value(flat, device="cuda"))
    skew_surface = SSVISurface(sigma0=0.22, sigma_inf=0.32, tau=1.2,
                               rho=-0.55, eta=0.8, gamma=0.45)
    skew = lv_model(skew_surface, 9.0, 0.35)
    lv_strikes = [90.0, 100.0, 110.0]

    def skew_call():
        return FDMEuropeanCallOption(mat, k).get_value(0.0, skew,
                                                       device="cuda")

    skew_grid = timed("local_vol_skew_200x401", skew_call)[1]
    skew_v = [FDMEuropeanCallOption(mat, kk).value(skew, device="cuda")
              for kk in lv_strikes]
    td = TimeDiscretization(initial=0.0, num_steps=100, step=mat / 100)
    mc = MonteCarloLocalVolModel(
        td, num_paths=PDE_MC_PATHS,
        model=LocalVolatilityModel(s0, r, skew_surface, td), seed=4242,
        device="cuda")
    mc_v = np.asarray(european_call_values(mc, lv_strikes, [mat]))
    del mc
    x = np.linspace(math.log(s0) - 3.0, math.log(s0) + 3.0, 401)
    terminal = np.maximum(np.exp(x) - k, 0.0)
    xq = math.log(s0)
    idx = int(np.searchsorted(x, xq)) - 1
    w = (xq - x[idx]) / (x[idx + 1] - x[idx])

    def vega_run():
        sig = torch.tensor(sigma, dtype=torch.float64, device="cuda",
                           requires_grad=True)
        ones = torch.ones(x.shape, dtype=torch.float64, device="cuda")

        def coeff_fn(t):
            del t
            return ones * r - 0.5 * sig ** 2, ones * sig ** 2, ones * r

        v = theta_scheme_solve(x, terminal, coeff_fn, mat, 100,
                               device="cuda")
        (v[idx] * (1 - w) + v[idx + 1] * w).backward()
        return float(sig.grad)

    vega = timed("vega_autograd_100x401", vega_run)
    peak = torch.cuda.max_memory_allocated()
    cpu_skew = FDMEuropeanCallOption(mat, k).get_value(0.0, skew,
                                                       device="cpu")[1]
    card_vs_cpu = float(np.max(np.abs(skew_grid - cpu_skew))
                        / np.max(np.abs(cpu_skew)))

    def ops_per_step(model_of):
        # the profiled device operations of a 40-step solve less those of
        # a 20-step one, over 20: the set-up and the factoring cancel
        n = [_device_busy(torch, lambda m=model_of(nt): FDMEuropeanCallOption(
            mat, k).value(m, device="cuda"))["device_ops"] for nt in (20, 40)]
        return (n[1] - n[0]) / 20

    ops = {"european_call": ops_per_step(lambda nt: bs_model(nt, 400)),
           "local_vol_skew": ops_per_step(
               lambda nt: lv_model(skew_surface, 9.0, 0.35, nt))}
    d2 = (math.log(s0 / k) + (r - 0.5 * sigma ** 2) * mat) \
        / (sigma * math.sqrt(mat))
    digital_exact = math.exp(-r * mat) * NormalDist().cdf(d2)
    crr = crr_american_price(s0, r, sigma, mat, k, is_call=False,
                             num_steps=4000)
    crr_strip = np.array([crr_american_price(s0, r, sigma, mat, kk,
                                             is_call=False, num_steps=2000)
                          for kk in strikes])
    test_strikes = np.isin(strikes, (100.0, 120.0))
    test_span = (strikes >= 90.0) & (strikes <= 110.0)
    strip_bs = np.array([bs(sigma, kk) for kk in strikes])
    ladder_bs = np.array([[bs(float(v), kk) for kk in strikes]
                          for v in vols[:, 0]])
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma ** 2) * mat) \
        / (sigma * math.sqrt(mat))
    vega_exact = s0 * math.exp(-0.5 * d1 ** 2) / math.sqrt(2 * math.pi) \
        * math.sqrt(mat)
    am_gap = np.abs(am_strip - crr_strip) / crr_strip
    out = {"call": call_v, "call_bs": bs(sigma, k),
           "put": put_v, "put_bs": bs(sigma, k, False),
           "strip_max_abs_err": float(np.max(np.abs(strip - strip_bs))),
           "ladder_shape": list(lad.shape),
           "ladder_max_abs_err": float(np.max(np.abs(lad - ladder_bs))),
           "ladder_max_abs_err_90_110": float(np.max(np.abs(
               lad - ladder_bs)[:, test_span])),
           "american_put": am_put, "crr_4000": crr,
           "american_strip_rel_gap_test_strikes": am_gap[test_strikes].tolist(),
           "american_strip_max_rel_gap": float(np.max(am_gap)),
           "american_strip_max_rel_gap_at": float(strikes[np.argmax(am_gap)]),
           "digital": digital, "digital_exact": digital_exact,
           "local_vol_flat": flat_v, "local_vol_skew": skew_v,
           "local_vol_mc": mc_v[0, :, 0].tolist(),
           "local_vol_mc_se": mc_v[0, :, 1].tolist(),
           "vega": vega, "vega_exact": vega_exact,
           "card_vs_cpu_rel": card_vs_cpu, "device_ops_per_step": ops,
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_live_gb": (peak - live) / 1e9, "walls": walls}
    print(f"phase 45 PDE layer ({smi}): " + json.dumps(out), flush=True)
    checks = {
        "call within 2e-3 of Black-Scholes":
            abs(call_v - bs(sigma, k)) < 2e-3 * bs(sigma, k),
        "put within 2e-3 of Black-Scholes":
            abs(put_v - bs(sigma, k, False)) < 2e-3 * bs(sigma, k, False),
        "strip within rtol 4e-3, atol 2e-3": bool(np.all(
            np.abs(strip - strip_bs) <= 2e-3 + 4e-3 * np.abs(strip_bs))),
        "ladder within 6e-3 max(value, 1) at strikes 90-110": bool(np.all(
            (np.abs(lad - ladder_bs) < 6e-3 * np.maximum(ladder_bs, 1.0))[
                :, test_span])),
        "American put within 2e-3 of CRR 4000": abs(am_put - crr)
            < 2e-3 * crr,
        "American strip within 3e-3 of CRR 2000 at 100 and 120": bool(
            np.all(am_gap[test_strikes] < 3e-3)),
        "digital within 2e-3": abs(digital - digital_exact) < 2e-3,
        "flat local vol within 4e-3 of Black-Scholes":
            abs(flat_v - bs(sigma, k)) < 4e-3 * bs(sigma, k),
        "skewed local vol within 4 se + 0.02 of the Monte Carlo": bool(
            np.all(np.abs(np.asarray(skew_v) - mc_v[0, :, 0])
                   < 4.0 * mc_v[0, :, 1] + 0.02)),
        "vega within 2% of the closed form":
            abs(vega - vega_exact) < 2e-2 * vega_exact,
        "card within 1e-12 of the CPU": card_vs_cpu < 1e-12,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 45 failed: {failed}")
    print(f"phase 45 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"phase 45 ladder (32 x 81, 200 x 401)": ladder,
            "phase 45 local-vol call (200 x 401)": skew_call}


# ---------------------------------------------------------------------------
# phase 46: path-axis sharding over torch.distributed (no kernel)
# ---------------------------------------------------------------------------

MESH_BS_PATHS, MESH_BS_STEPS = 1_000_000, 100
MESH_LM_ITERATIONS = 2
MESH_JOIN_SECONDS = 300
# the ranks import this file by its name (run as a script it is __main__)
MODULE = os.path.splitext(os.path.basename(__file__))[0]


def _mesh_atm_rank(mesh, increments, jac_increments, calibrate):
    """Phase 46, on every rank: the ATM setup at full width with its two
    engines meshed on the injected blocks (the 100,000-path residual
    engine and the 5,000-path Jacobian engine): values, residuals and the
    Jacobian at the initial parameters; with ``calibrate`` the analytic
    warm start and the LM calibration on engine residuals, and whether the
    kernel backend refuses the meshed engine; else two LM iterations from
    the initial parameters."""
    import dataclasses

    import torch

    from finmath_tpu_torch.models.lmm import (ATMKernelCalibration,
                                              build_atm_calibration)
    from finmath_tpu_torch.models.lmm.model import LMMValuationEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    setup = build_atm_calibration(num_paths=PATHS, num_factors=1, seed=SEED,
                                  jacobian_paths=JAC_PATHS, mesh=mesh)
    meshed = setup.engine.mesh is mesh and setup.jacobian_engine.mesh is mesh
    setup = dataclasses.replace(
        setup,
        engine=LMMValuationEngine(setup.model, setup.products, PATHS, 1,
                                  SEED, increments=increments, mesh=mesh),
        jacobian_engine=LMMValuationEngine(
            setup.model, setup.products, JAC_PATHS, 1, SEED,
            increments=jac_increments, mesh=mesh))
    x0 = np.asarray(setup.covariance.initial_parameters)
    out = {"meshed_setup": meshed,
           "values": setup.engine.values(x0),
           "residuals": setup.engine.residuals(x0),
           "jacobian": setup.jacobian_engine.jacobian(x0)}
    if calibrate:
        try:
            ATMKernelCalibration(setup.engine)
            out["kernel_backend_refused"] = False
        except ValueError:
            out["kernel_backend_refused"] = True
        t_cal = time.perf_counter()
        result = setup.calibrate(warm_start="analytic")
        out["calibration_s"] = time.perf_counter() - t_cal
        dev = setup.deviations(result.parameters)
        out.update(iterations=result.iterations,
                   rms_dev=float(np.sqrt(np.mean(dev ** 2))),
                   mean_dev=float(np.mean(dev)))
    else:
        result = setup.calibrate(max_iterations=MESH_LM_ITERATIONS)
        out["lm_parameters"] = result.parameters
    torch.cuda.synchronize()
    out.update(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
               wall_s=time.perf_counter() - t0,
               collective_s=mesh.seconds, collectives=mesh.calls,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def _mesh_pair_rank(mesh, increments, jac_increments):
    """Phase 46 (b), on each of two gloo ranks sharing the card: the ATM
    engines of (a) on half the block each, two LM iterations, the
    stoch-vol engine at 81,920 Mersenne paths, the Black-Scholes facade at
    1M x 100 with four products, and ``mc_price_sharded`` at 1M paths."""
    import torch

    from finmath_tpu_torch.models.lmm import build_benchmark_calibration
    from finmath_tpu_torch.parallel import mc_price_sharded

    out = _mesh_atm_rank(mesh, increments, jac_increments, calibrate=False)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sv = build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                     brownian="finmath_mersenne", mesh=mesh)
    p0 = np.asarray(sv.covariance.initial_parameters)
    out["sv_residuals"] = sv.engine.residuals(p0)
    out["sv_jacobian"] = sv.engine.jacobian(p0)
    del sv
    sim = _mesh_bs_facade(mesh)
    out["bs_prices"] = {name: p.get_value_and_error(sim)
                        for name, p in _mesh_bs_products().items()}
    out["bs_local_paths"] = int(sim.process._lazy_states().shape[-1])
    del sim
    s0, r, sigma, maturity, strike = BS_PARAMS
    out["mc_price"] = float(mc_price_sharded(
        mesh, BS_SEED, MESH_BS_PATHS, MESH_BS_STEPS, s0, r, sigma, maturity,
        strike))
    torch.cuda.synchronize()
    out.update(wall_s=out["wall_s"] + time.perf_counter() - t0,
               collective_s=mesh.seconds, collectives=mesh.calls,
               peak_gb=max(out["peak_gb"],
                           torch.cuda.max_memory_allocated() / 1e9))
    return out


def _mesh_bs_facade(mesh):
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    td = TimeDiscretization(initial=0.0, num_steps=MESH_BS_STEPS,
                            step=1.0 / MESH_BS_STEPS)
    return MonteCarloBlackScholesModel(
        td, MESH_BS_PATHS, BlackScholesModel(100.0, 0.05, 0.3), seed=5,
        mesh=mesh, device="cuda")


def _mesh_bs_products():
    from finmath_tpu_torch.models.black_scholes import EuropeanOption
    from finmath_tpu_torch.models.equity_products import (AsianOption,
                                                          BarrierOption,
                                                          LookbackOption)

    return {"european_105": EuropeanOption(1.0, 105.0),
            "asian": AsianOption([0.2, 0.6, 1.0], 100.0),
            "barrier_up_out": BarrierOption(1.0, 100.0, 130.0, "up-out"),
            "lookback_floating": LookbackOption(1.0, "floating-call")}


def _call_payoff_stderr(s0, r, sigma, maturity, strike, paths) -> float:
    """The standard error of the discounted call payoff's mean over
    ``paths`` Black-Scholes paths, from the payoff's exact second moment."""
    import math

    def ncdf(x):
        return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

    vt = sigma * math.sqrt(maturity)
    d1 = (math.log(s0 / strike) + (r + 0.5 * sigma * sigma) * maturity) / vt
    d2 = d1 - vt
    first = s0 * math.exp(r * maturity) * ncdf(d1) - strike * ncdf(d2)
    second = (s0 * s0 * math.exp((2 * r + sigma * sigma) * maturity)
              * ncdf(d1 + vt)
              - 2 * strike * s0 * math.exp(r * maturity) * ncdf(d1)
              + strike * strike * ncdf(d2))
    return math.exp(-r * maturity) * math.sqrt(
        (second - first * first) / paths)


def _path_mesh(torch, smi) -> None:
    """Phase 46 (no kernel): the meshed main path on the card, each world
    spawned as child processes with a ``file://`` store in a temporary
    directory and joined within ``MESH_JOIN_SECONDS``; a failing or hung
    rank fails the phase.

    (a) An NCCL world of one on ``cuda:0``: the ATM setup at full width
    (80 libors, 144 products, 43 parameters, 100,000 paths, the 5,000-path
    Jacobian engine, seed 31415) meshed on the unsharded engines' own
    increments, against the unsharded engines: values within 1e-12
    relative, residuals and the Jacobian within 1e-9; the kernel backend
    refuses the meshed engine; the analytic warm start and the LM
    calibration on engine residuals reach |mean_dev| < 2e-4.
    (b) A gloo world of two ranks sharing the card (NCCL refuses two ranks
    on one GPU; gloo stages each collective through host memory): the ATM
    residuals and Jacobian on half the block each against (a)'s; two LM
    iterations leave bitwise-equal parameters on both ranks; the stoch-vol
    engine at 81,920 Mersenne paths against the unsharded engine on the
    same stream (residuals and Jacobian within 1e-9); the Black-Scholes
    facade at 1M x 100 (European 105, Asian, up-out barrier, floating
    lookback) within 1e-9 relative of the unsharded facade;
    ``mc_price_sharded`` at 1M x 100 within 4 standard errors of the
    analytic price.
    Printed: each world's walls, the seconds in collectives and the peak
    device memory per rank, beside the card's name and power limit."""
    from finmath_tpu_torch.models.analytic import black_scholes_option_value
    from finmath_tpu_torch.models.lmm import (build_atm_calibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.parallel.launch import start_world

    t_phase = time.perf_counter()
    setup = build_atm_calibration(num_paths=PATHS, num_factors=1, seed=SEED,
                                  jacobian_paths=JAC_PATHS, device="cuda")
    x0 = np.asarray(setup.covariance.initial_parameters)
    blocks = dict(increments=setup.engine.increments.cpu().numpy(),
                  jac_increments=setup.jacobian_engine.increments.cpu()
                  .numpy())
    plain = {"values": setup.engine.values(x0),
             "residuals": setup.engine.residuals(x0),
             "jacobian": setup.jacobian_engine.jacobian(x0)}
    del setup

    # each world's unsharded references run while its ranks start up
    t0 = time.perf_counter()
    with start_world(f"{MODULE}:_mesh_atm_rank", 1, backend="nccl",
                     device="cuda:0",
                     kwargs=dict(calibrate=True, **blocks)) as world:
        sv = build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                         brownian="finmath_mersenne",
                                         device="cuda")
        p0 = np.asarray(sv.covariance.initial_parameters)
        sv_plain = (sv.engine.residuals(p0), sv.engine.jacobian(p0))
        del sv
        (a,) = world.join(MESH_JOIN_SECONDS)
    a_join_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with start_world(f"{MODULE}:_mesh_pair_rank", 2, backend="gloo",
                     device="cuda:0", kwargs=blocks) as world:
        sim = _mesh_bs_facade(None)
        bs_plain = {name: p.get_value_and_error(sim)
                    for name, p in _mesh_bs_products().items()}
        del sim
        torch.cuda.empty_cache()
        pair = world.join(MESH_JOIN_SECONDS)
    b_join_s = time.perf_counter() - t0
    s0, r, sigma, maturity, strike = BS_PARAMS
    analytic = black_scholes_option_value(s0, r, sigma, maturity, strike)
    stderr = _call_payoff_stderr(s0, r, sigma, maturity, strike,
                                 MESH_BS_PATHS)

    def gap(x, y):
        return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))

    def rel_gap(x, y):
        return float(np.max(np.abs(np.asarray(x) - np.asarray(y))
                            / np.maximum(np.abs(np.asarray(y)), 1e-300)))

    bs_rel = {name: max(rel_gap(rk["bs_prices"][name][0], v[0])
                        for rk in pair)
              for name, v in bs_plain.items()}
    out = {
        "a_nccl_world_1": {
            "values_rel_gap": rel_gap(a["values"], plain["values"]),
            "residuals_gap": gap(a["residuals"], plain["residuals"]),
            "jacobian_gap": gap(a["jacobian"], plain["jacobian"]),
            "iterations": a["iterations"], "rms_dev": a["rms_dev"],
            "mean_dev": a["mean_dev"], "calibration_s": a["calibration_s"],
            "rank_wall_s": a["wall_s"], "join_wall_s": a_join_s,
            "collective_s": a["collective_s"],
            "collectives": a["collectives"], "peak_gb": a["peak_gb"]},
        "b_gloo_world_2": {
            "residuals_gap_to_a": max(gap(rk["residuals"], a["residuals"])
                                      for rk in pair),
            "jacobian_gap_to_a": max(gap(rk["jacobian"], a["jacobian"])
                                     for rk in pair),
            "sv_residuals_gap": max(gap(rk["sv_residuals"], sv_plain[0])
                                    for rk in pair),
            "sv_jacobian_gap": max(gap(rk["sv_jacobian"], sv_plain[1])
                                   for rk in pair),
            "bs_rel_gap": bs_rel,
            "bs_prices": {k: list(v) for k, v in pair[0]["bs_prices"].items()},
            "bs_local_paths": [rk["bs_local_paths"] for rk in pair],
            "mc_price": pair[0]["mc_price"], "mc_analytic": analytic,
            "mc_stderr": stderr,
            "rank_wall_s": [rk["wall_s"] for rk in pair],
            "join_wall_s": b_join_s,
            "collective_s": [rk["collective_s"] for rk in pair],
            "collectives": [rk["collectives"] for rk in pair],
            "peak_gb": [rk["peak_gb"] for rk in pair]},
    }
    print(f"phase 46 path-axis sharding ({smi}): " + json.dumps(out),
          flush=True)
    print("phase 46: two ranks sharing one card are a correctness check, "
          "not a scaling figure; no multi-GPU speed-up is claimed",
          flush=True)
    checks = {
        "(a) meshed setup": a["meshed_setup"],
        "(a) NCCL on cuda:0": a["backend"] == "nccl"
        and a["device"] == "cuda:0",
        "(a) values within 1e-12 relative":
            out["a_nccl_world_1"]["values_rel_gap"] < 1e-12,
        "(a) residuals within 1e-9": out["a_nccl_world_1"]["residuals_gap"]
        < 1e-9,
        "(a) Jacobian within 1e-9": out["a_nccl_world_1"]["jacobian_gap"]
        < 1e-9,
        "(a) kernel backend refuses the mesh": a["kernel_backend_refused"],
        "(a) |mean_dev| < 2e-4": abs(a["mean_dev"]) < 2e-4,
        "(b) gloo ranks on cuda:0": all(
            rk["backend"] == "gloo" and rk["device"] == "cuda:0"
            for rk in pair),
        "(b) ATM residuals within 1e-9 of (a)":
            out["b_gloo_world_2"]["residuals_gap_to_a"] < 1e-9,
        "(b) ATM Jacobian within 1e-9 of (a)":
            out["b_gloo_world_2"]["jacobian_gap_to_a"] < 1e-9,
        "(b) LM parameters bitwise equal on both ranks": bool(
            np.array_equal(pair[0]["lm_parameters"],
                           pair[1]["lm_parameters"])),
        "(b) stoch-vol residuals within 1e-9":
            out["b_gloo_world_2"]["sv_residuals_gap"] < 1e-9,
        "(b) stoch-vol Jacobian within 1e-9":
            out["b_gloo_world_2"]["sv_jacobian_gap"] < 1e-9,
        "(b) Black-Scholes facade within 1e-9 relative":
            max(bs_rel.values()) < 1e-9,
        "(b) half the paths on each rank": all(
            rk["bs_local_paths"] == MESH_BS_PATHS // 2 for rk in pair),
        "(b) mc_price_sharded within 4 se of the analytic price":
            abs(pair[0]["mc_price"] - analytic) < 4 * stderr
            and pair[0]["mc_price"] == pair[1]["mc_price"],
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 46 failed: {failed}")
    print(f"phase 46 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 47: path-axis sharding of the XVA engines, the hybrid and the rates,
# credit, FX, inflation, copula, commodity and market-risk simulations (no
# kernel)
# ---------------------------------------------------------------------------

F2_PATHS = {"exposure": EXPOSURE_PATHS, "hybrid": HYBRID_PATHS,
            "hull_white": HW_PATHS, "wwr": CREDIT_PATHS,
            "xccy": XCCY_PATHS, "inflation": XCCY_PATHS,
            "copula": 1_000_000, "commodity": 1_000_000,
            "risk": 1_000_000}
F2_HAZARD = 0.012
# the paths of each rank's block whose state histories phase 47 compares
# bit for bit with the unsharded port's
F2_HISTORY_PATHS = 4_096


def _f2_profile(p) -> dict:
    out = {"ee": p.ee, "ene": p.ene, "forward_value": p.forward_value}
    out.update({f"pfe_{q}": v for q, v in p.pfe.items()})
    return out


def _f2_exposure(part, mesh, blocks):
    """Phase 47's exposure parts on the card (``mesh=None``: the unsharded
    port): phase 25's 10Y par payer swap (19 dates, quantiles 0.95 and
    0.99) with the 80-bucket CVA ladder, phase 25's 20-trade set with its
    IM profile, and phase 27's mixed set (two swaps, a European and a
    Bermudan swaption) without and with a zero-threshold one-date-lag CSA,
    each on the given block of increments."""
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import exposure as xv

    setup = build_atm_calibration(num_paths=8, num_factors=1, device="cuda")
    model, p0 = setup.model, setup.covariance.initial_parameters
    kw = dict(num_paths=EXPOSURE_PATHS, num_factors=1, mesh=mesh,
              increments=blocks[part],
              device=None if mesh is not None else "cuda")
    if part == "swap":
        par = float(par_swap_rate(model.forward_curve, model.discount_curve,
                                  model.tenor_times[4:21]))
        eng = xv.SwapExposureEngine(model, first_index=4, last_index=20,
                                    strike=par, quantiles=(0.95, 0.99), **kw)
        out = _f2_profile(eng.profile(p0))
        out["cva"], out["cva_deltas"] = eng.cva_forward_deltas(
            p0, hazard_rate=F2_HAZARD)
        return out
    if part == "netting_set":
        rng = np.random.default_rng(7)
        trades = []
        for k in range(20):
            first = int(rng.integers(1, 20))
            last = int(rng.integers(first + 1, 40))
            trades.append(xv.SwapTrade(
                first, last, float(rng.uniform(0.0, 0.02)),
                payer=bool(k % 2), notional=float(rng.uniform(0.5, 2.0))))
        eng = xv.NettingSetExposureEngine(model, trades, **kw)
        out = _f2_profile(eng.profile(p0))
        im = eng.im_profile(p0)
        out.update(expected_im=im.expected_im,
                   expected_im_tmoney=im.expected_im_tmoney)
        return out
    x_, m_ = 8, 8
    strike = float(par_swap_rate(model.forward_curve, model.discount_curve,
                                 model.tenor_times[x_:x_ + m_ + 1]))
    mixed = [xv.SwapTrade(2, 16, 0.006, payer=False, notional=1.5),
             xv.SwapTrade(1, 12, 0.02, payer=True),
             xv.SwaptionTrade(x_, m_, strike),
             xv.BermudanSwaptionTrade((x_, x_ + 2, x_ + 4), x_ + m_, strike)]
    out = _f2_profile(xv.NettingSetExposureEngine(model, mixed,
                                                  **kw).profile(p0))
    csa = xv.NettingSetExposureEngine(
        model, mixed, csa=xv.CSA(threshold=0.0, mta=0.0, margin_lag=1),
        **kw).profile(p0)
    out.update({f"csa_{k}": v for k, v in _f2_profile(csa).items()})
    return out


def _f2_hybrid(mesh, draws=None):
    """Phase 29's two-asset hybrid (equity and FX under the ATM setup's
    rates) at ``HYBRID_PATHS``: the martingale errors, a 10Y call, a
    three-trade book's profile and the five-date autocallable. Under a mesh
    on the ranks' own streams (antithetic), returning this rank's draws;
    without one on the given ``draws`` (every rank's, in rank order)."""
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import hybrid as hy

    setup = build_atm_calibration(num_paths=8, num_factors=1, device="cuda")
    model, p0 = setup.model, setup.covariance.initial_parameters
    n = model.num_libors
    ft = np.arange(0.5, model.tenor_times[-1] + 0.01, 0.5)
    foreign = DiscountCurve(list(ft), list(np.exp(-0.01 * ft)))
    kw = (dict(mesh=mesh, antithetic=True) if mesh is not None else
          dict(device="cuda", increments=draws[0], equity_normals=draws[1]))
    h = hy.HybridAssetLMM(model, [100.0, 1.10], [0.20, 0.10],
                          rate_correlations=[0.3, -0.2],
                          dividend_yields=[0.01, foreign],
                          observation_indices=range(1, n),
                          num_paths=F2_PATHS["hybrid"], num_factors=1,
                          seed=SEED, **kw)
    book = [hy.EquityForwardTrade(0, 20, 100.0),
            hy.EquityOptionTrade(0, 40, 110.0),
            hy.EquityForwardTrade(1, 30, 1.10, notional=-50.0)]
    out = _f2_profile(hy.HybridExposureEngine(
        h, book, quantiles=(0.95,)).profile(p0))
    out["martingale_errors"] = h.martingale_errors(p0)
    out["call_10y"] = np.asarray(h.european_option_value(p0, 20, 100.0))
    out["note"] = np.asarray(hy.HybridAutocallableNote(
        h, [2, 4, 6, 8, 10], [105.0] * 5, [0.04] * 5, 70.0,
        coupon_levels=[80.0] * 5, memory=True).get_value_and_error(p0))
    if mesh is not None:
        out["draws"] = (h.engine.increments.cpu().numpy(),
                        h.equity_normals.cpu().numpy())
    return out


def _f2_history(mesh, paths, *states):
    """The first ``F2_HISTORY_PATHS`` paths of this rank's block of each
    state tensor (path axis last) on the host; under ``mesh=None`` the
    unsharded port's paths at the offsets of the blocks of a world of two,
    in rank order."""
    if mesh is not None:
        return [s[..., :F2_HISTORY_PATHS].cpu().numpy() for s in states]
    local = paths // 2
    return [np.concatenate([s[..., r * local:r * local + F2_HISTORY_PATHS]
                            .cpu().numpy() for r in range(2)], axis=-1)
            for s in states]


def _f2_rates(part, mesh):
    """Phase 47's rates parts (every one on the unmeshed stream, so the
    unsharded port with ``mesh=None`` simulates the same paths): phase 30's
    Hull-White model with a swaption, a TARN and a Bermudan; a WWR CVA on
    Hull-White x CIR++; phase 32's cross-currency model with its FX
    options, CCS legs and a two-trade exposure profile, and
    ``tests/test_inflation.py``'s Jarrow-Yildirim model; phase 42's copula;
    phase 43's Schwartz-Smith model; ``tests/test_risk.py``'s convex book's
    parametric VaR report. A standard error's key ends in ``_stderr``;
    ``history`` holds samples of the state (``_f2_history``)."""
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import HullWhiteModel
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    dev = None if mesh is not None else "cuda"
    paths = F2_PATHS[part]
    t_grid = np.arange(0.0, 31.0)
    dc = DiscountCurve(t_grid, np.exp(-0.03 * t_grid))
    if part == "hull_white":
        from finmath_tpu_torch.models.hull_white import HullWhiteSimulation
        from finmath_tpu_torch.models.hw_bermudan import BermudanSwaption
        from finmath_tpu_torch.models.tarn import TargetRedemptionNote

        pil = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 15.0, 20.0])
        z = np.array([0.010, 0.012, 0.015, 0.017, 0.020, 0.022, 0.024,
                      0.025, 0.0255])
        hw = HullWhiteModel(DiscountCurve(list(pil), list(np.exp(-z * pil))),
                            0.12, [0.010, 0.014, 0.008],
                            vol_times=[0.0, 2.0, 5.0])
        sim = HullWhiteSimulation(
            hw, TimeDiscretization(initial=0.0, num_steps=20, step=0.5),
            num_paths=paths, seed=7, antithetic=True, mesh=mesh, device=dev)
        tarn = TargetRedemptionNote(np.arange(1, 9) * 1.0,
                                    np.arange(1, 9) * 1.0 + 0.5, 0.06, 0.06,
                                    multiplier=2.0)
        tv, te = (float(x) for x in tarn.get_value_and_error(sim))
        bv, be = (float(x) for x in BermudanSwaption(
            [1.0, 2.0, 3.0, 4.0, 5.0], 6.0, 0.02).get_value_and_error(sim))
        return {"swaption": sim.mc_swaption_price(
                    2.0, [3.0, 3.5, 4.0, 4.5, 5.0], 0.02),
                "bond_10y": sim.mc_bond_price(10.0),
                "tarn": tv, "tarn_stderr": te,
                "bermudan": bv, "bermudan_stderr": be,
                "history": _f2_history(mesh, paths, sim._xs, sim._ys)}
    if part == "wwr":
        from finmath_tpu_torch.models.credit import (
            CIRPPIntensityModel, SurvivalCurve, WrongWayRiskCVAEngine,
            par_swap_rate)

        pay = np.arange(1, 21) * 0.5
        res = WrongWayRiskCVAEngine(
            HullWhiteModel(dc, 0.1, 0.01),
            CIRPPIntensityModel(SurvivalCurve([0.0], [0.015]), kappa=0.5,
                                theta=0.015, sigma=0.08, y0=0.01),
            pay, par_swap_rate(dc, pay), num_paths=paths, correlation=0.6,
            recovery=0.4, seed=31, antithetic=True, substeps=4, mesh=mesh,
            device=dev).compute()
        return {"cva": res.cva, "cva_independent": res.cva_independent,
                "contributions": res.contributions,
                "expected_survival": res.expected_survival}
    if part == "xccy":
        from finmath_tpu_torch.models.cross_currency import (
            CCSTrade, CrossCurrencyExposureEngine, CrossCurrencySimulation,
            FXForwardTrade)

        dc_f = DiscountCurve(t_grid, np.exp(-0.01 * t_grid))
        sim = CrossCurrencySimulation(
            _xccy_model(dc, dc_f),
            TimeDiscretization(initial=0.0, num_steps=20, step=0.5),
            num_paths=paths, seed=5, antithetic=True, mesh=mesh, device=dev)
        fwd, prices, stderr = sim.mc_fx_option_prices(5.0, [1.0, 1.25, 1.5])
        out = _f2_profile(CrossCurrencyExposureEngine(
            sim, [CCSTrade(tuple(np.arange(1, 11) * 1.0)),
                  FXForwardTrade(4.0, 1.3, notional=-0.5)],
            quantiles=(0.95, 0.99)).profile())
        out.update(fx_forward=fwd, fx_prices=prices, fx_stderr=stderr,
                   ccs=np.asarray(sim.mc_ccs_legs(np.arange(1, 11) * 1.0)),
                   history=_f2_history(mesh, paths, sim._hist))
        return out
    if part == "inflation":
        from finmath_tpu_torch.models.inflation import (
            JarrowYildirimModel, JarrowYildirimSimulation)

        jy = JarrowYildirimModel(
            HullWhiteModel(dc, 0.1, 0.01),
            HullWhiteModel(DiscountCurve(t_grid, np.exp(-0.01 * t_grid)),
                           0.05, 0.006),
            cpi_initial=100.0, cpi_vol=0.012, rho_nr=0.3, rho_ni=-0.1,
            rho_ri=0.2)
        sim = JarrowYildirimSimulation(
            jy, TimeDiscretization(initial=0.0, num_steps=20, step=0.5),
            num_paths=paths, seed=3, antithetic=True, mesh=mesh, device=dev)
        yoy, yoy_se = sim.mc_yoy_forward(3.0, 4.0)
        return {"zcis": sim.mc_zcis_value(5.0, jy.zcis_par_rate(5.0)),
                "yoy": yoy, "yoy_stderr": yoy_se,
                "history": _f2_history(mesh, paths, sim.sim._hist)}
    if part == "copula":
        from finmath_tpu_torch.models.credit import SurvivalCurve
        from finmath_tpu_torch.models.portfolio_credit import (
            GaussianCopulaPortfolio, GaussianCopulaSimulation)

        rng = np.random.default_rng(1)
        hazards = rng.uniform(0.005, 0.06, 125)
        betas = rng.uniform(0.3, 0.7, 125)
        pf = GaussianCopulaPortfolio(
            [SurvivalCurve([0.0], [h]) for h in hazards], betas=betas,
            recoveries=0.4, notionals=np.full(125, 1 / 125))
        sim = GaussianCopulaSimulation(pf, num_paths=paths, seed=7,
                                       antithetic=True, mesh=mesh,
                                       device=dev)
        st = sim.tranche_statistics(np.arange(1.0, 11.0), 0.03, 0.07,
                                    ks=(1, 5, 10))
        return {"etl": st["etl"], "etl_stderr": st["etl_stderr"],
                "kth_prob": st["kth_prob"],
                "history": _f2_history(mesh, paths, sim._lat)}
    if part == "commodity":
        from finmath_tpu_torch.models.commodity import (
            SchwartzSmithModel, SchwartzSmithSimulation)

        sim = SchwartzSmithSimulation(
            SchwartzSmithModel(chi0=0.1, xi0=3.0, kappa=1.5, sigma_chi=0.25,
                               sigma_xi=0.15, rho=0.3, mu_star=0.02,
                               lambda_chi=0.05),
            TimeDiscretization(initial=0.0, num_steps=24, step=1.0 / 12.0),
            num_paths=paths, seed=2, antithetic=True, mesh=mesh, device=dev)
        f, fse = sim.mc_futures_prices(1.0, [1.5, 2.0, 3.0, 5.0])
        o, ose = sim.mc_option_on_future(1.0, 2.0, [20.0, 25.0])
        sp, sp_se = sim.mc_calendar_spread(1.0, 2.0, 3.0)
        return {"futures": f, "futures_stderr": fse, "options": o,
                "options_stderr": ose, "spread": sp, "spread_stderr": sp_se,
                "history": _f2_history(mesh, paths, sim._chis, sim._xis)}
    from finmath_tpu_torch.models.risk import MarketRiskEngine, OptionBook

    book = OptionBook(spots=[100.0, 50.0], rate=0.02,
                      underlying_index=[0, 0, 1, 1],
                      strikes=[100.0, 110.0, 50.0, 45.0],
                      expiries=[0.5, 1.0, 0.25, 1.0],
                      vols=[0.2, 0.22, 0.3, 0.28],
                      notionals=[100.0, -50.0, 80.0, 40.0],
                      is_call=[True, True, True, False])
    rep = MarketRiskEngine(book, mesh=mesh, device=dev).parametric_mc(
        np.array([[0.04, 0.012], [0.012, 0.09]]), num_scenarios=paths,
        seed=5, vol_covariance=np.diag([0.25, 0.16]))
    return {"var": rep.var, "es": rep.expected_shortfall,
            "component_es": rep.component_es, "stderr_var": rep.stderr_var,
            "mean_pnl": rep.mean_pnl}


F2_EXPOSURE_PARTS = ("swap", "netting_set", "mixed")
F2_RATES_PARTS = ("hull_white", "wwr", "xccy", "inflation", "copula",
                  "commodity", "risk")


def _f2_timed(torch, mesh, fn):
    """``fn()`` and its rank wall, collectives, seconds in them and peak
    device memory."""
    calls, seconds = mesh.calls, mesh.seconds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "collectives": mesh.calls - calls,
                 "collective_s": mesh.seconds - seconds,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _mesh_f2_rank(mesh, blocks, parts):
    """Phase 47, on every rank: each part of ``parts`` meshed, with its
    numbers."""
    import torch

    t0 = time.perf_counter()
    out, stats = {}, {}
    for part in parts:
        if part in F2_EXPOSURE_PARTS:
            fn = (lambda p=part: _f2_exposure(p, mesh, blocks))
        elif part == "hybrid":
            fn = (lambda: _f2_hybrid(mesh))
        else:
            fn = (lambda p=part: _f2_rates(p, mesh))
        out[part], stats[part] = _f2_timed(torch, mesh, fn)
    return {"results": out, "stats": stats, "rank": mesh.rank,
            "device": str(mesh.device), "backend": mesh.backend,
            "wall_s": time.perf_counter() - t0, "collectives": mesh.calls,
            "collective_s": mesh.seconds}


def _f2_gap(got, want, rel=False) -> float:
    """The largest gap between two results (dicts of arrays and floats),
    absolute or relative to ``want``."""
    gaps = [0.0]
    for k, w in want.items():
        if k in ("draws", "history"):
            continue
        g, w = (np.asarray(got[k], dtype=np.float64),
                np.asarray(w, dtype=np.float64))
        d = np.abs(g - w)
        if rel:
            d = d / np.maximum(np.abs(w), 1e-300)
        gaps.append(float(np.max(d)))
    return max(gaps)


def _f2_equal(got, want, keys) -> bool:
    return all(np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
               for k in keys)


def _path_mesh_f2(torch, smi) -> None:
    """Phase 47 (no kernel): the F2 engines meshed on the card, each world
    spawned as in phase 46 and joined within ``MESH_JOIN_SECONDS``; a
    failing or hung rank fails the phase.

    (a) An NCCL world of one on ``cuda:0``: phase 25's 10Y par payer swap
    profile at full width (80 libors, ``EXPOSURE_PATHS`` = 50,000 paths, 19
    dates, quantiles 0.95 and 0.99) meshed on the unsharded engine's
    increments, against the unsharded engine: EE, ENE, forward value and
    PFE within 1e-12, the CVA within 1e-10 relative and its 80-bucket
    ladder within rtol 1e-6 / atol 1e-10.
    (b) A gloo world of two ranks sharing the card, each part against the
    unsharded port on the card on the same normals, at ``F2_PATHS``: the
    swap profile and ladder, the 20-trade set and its IM, the mixed set
    with and without a CSA (50,000 paths); the hybrid (100,000 paths, the
    ranks' own streams, against the unsharded hybrid fed their draws); the
    Hull-White swaption, TARN and Bermudan (1M), the WWR CVA (500,000),
    cross-currency and Jarrow-Yildirim (1M each), the copula on 125 names
    (1M), Schwartz-Smith (1M x 24) and the VaR report (1M scenarios), all
    on the unmeshed stream. Bounds: ``tests/test_torch_exposure_mesh.py``'s
    for the exposure parts and the hybrid; ``tests/test_torch_rates_mesh.py``'s
    for the rest: every mean within 1e-12 relative, every standard error
    within 1e-9, the PFE, the VaR report and samples of the state
    histories (``F2_HISTORY_PATHS`` paths of each block) bit for bit.
    Printed: each part's gap, rank wall, collectives and their seconds,
    and peak device memory per rank, beside the card's name and power
    limit."""
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm import exposure as xv
    from finmath_tpu_torch.parallel.launch import start_world

    t_phase = time.perf_counter()
    # the unsharded engines' own increments: the blocks both sides price
    setup = build_atm_calibration(num_paths=8, num_factors=1, device="cuda")
    model = setup.model
    par = float(par_swap_rate(model.forward_curve, model.discount_curve,
                              model.tenor_times[4:21]))
    blocks = {"swap": xv.SwapExposureEngine(
        model, first_index=4, last_index=20, strike=par,
        num_paths=EXPOSURE_PATHS, num_factors=1,
        device="cuda").engine.increments.cpu().numpy()}
    for part, last in (("netting_set", 40), ("mixed", 16)):
        blocks[part] = xv.NettingSetExposureEngine(
            model, [xv.SwapTrade(1, last, 0.01)], num_paths=EXPOSURE_PATHS,
            num_factors=1, device="cuda").engine.increments.cpu().numpy()
    del setup

    t0 = time.perf_counter()
    with start_world(f"{MODULE}:_mesh_f2_rank", 1, backend="nccl",
                     device="cuda:0",
                     kwargs=dict(blocks={"swap": blocks["swap"]},
                                 parts=("swap",))) as world:
        plain = {"swap": _f2_exposure("swap", None, blocks)}
        (a,) = world.join(MESH_JOIN_SECONDS)
    a_join_s = time.perf_counter() - t0

    parts = F2_EXPOSURE_PARTS + ("hybrid",) + F2_RATES_PARTS
    t0 = time.perf_counter()
    with start_world(f"{MODULE}:_mesh_f2_rank", 2, backend="gloo",
                     device="cuda:0",
                     kwargs=dict(blocks=blocks, parts=parts)) as world:
        plain_s = {}
        for part in F2_EXPOSURE_PARTS[1:] + F2_RATES_PARTS:
            t1 = time.perf_counter()
            plain[part] = (_f2_exposure(part, None, blocks)
                           if part in F2_EXPOSURE_PARTS
                           else _f2_rates(part, None))
            torch.cuda.synchronize()
            plain_s[part] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        pair = world.join(MESH_JOIN_SECONDS)
    b_join_s = time.perf_counter() - t0
    draws = tuple(np.concatenate([rk["results"]["hybrid"]["draws"][i]
                                  for rk in pair], axis=-1) for i in (0, 1))
    t1 = time.perf_counter()
    plain["hybrid"] = _f2_hybrid(None, draws)
    plain_s["hybrid"] = time.perf_counter() - t1
    del draws

    ra, pa = a["results"]["swap"], plain["swap"]
    pfe_keys = [k for k in pa if k.startswith("pfe_")]
    rows = ("ee", "ene", "forward_value")

    def rows_gap(got, want, keys=rows + tuple(pfe_keys)):
        return max(_f2_gap({k: got[k] for k in keys},
                           {k: want[k] for k in keys}), 0.0)

    def ladder_ok(got, want):
        return bool(np.all(np.abs(got["cva_deltas"] - want["cva_deltas"])
                           <= 1e-10 + 1e-6 * np.abs(want["cva_deltas"])))

    out = {"a_nccl_world_1": {
        "swap_rows_pfe_gap": rows_gap(ra, pa),
        "swap_pfe_bitwise": _f2_equal(ra, pa, pfe_keys),
        "cva_rel_gap": abs(ra["cva"] - pa["cva"]) / abs(pa["cva"]),
        "ladder_gap": _f2_gap({"d": ra["cva_deltas"]},
                              {"d": pa["cva_deltas"]}),
        "rank_wall_s": a["wall_s"], "join_wall_s": a_join_s,
        "collectives": a["collectives"], "collective_s": a["collective_s"],
        "peak_gb": a["stats"]["swap"]["peak_gb"]}}
    b = {"parts": {}, "join_wall_s": b_join_s,
         "rank_wall_s": [rk["wall_s"] for rk in pair],
         "collectives": [rk["collectives"] for rk in pair],
         "collective_s": [rk["collective_s"] for rk in pair]}
    for part in parts:
        want = plain[part]
        entry = {"paths": F2_PATHS.get(part, EXPOSURE_PATHS),
                 "gap": max(_f2_gap(rk["results"][part], want)
                            for rk in pair),
                 "rel_gap": max(_f2_gap(rk["results"][part], want, rel=True)
                                for rk in pair),
                 "unsharded_s": plain_s.get(part)}
        if part in F2_EXPOSURE_PARTS + ("hybrid",):
            # each output's own gap, absolute and relative
            entry["by_key"] = {
                k: [max(_f2_gap({k: rk["results"][part][k]}, {k: w},
                                rel=rel) for rk in pair)
                    for rel in (False, True)]
                for k, w in want.items()}
        for key in ("wall_s", "collectives", "collective_s", "peak_gb"):
            entry[key] = [rk["stats"][part][key] for rk in pair]
        b["parts"][part] = entry
    out["b_gloo_world_2"] = b
    print(f"phase 47 path-axis sharding F2 ({smi}): " + json.dumps(out),
          flush=True)

    r0, r1 = (rk["results"] for rk in pair)

    def every(check):
        return all(check(rk["results"]) for rk in pair)

    def within(part, keys, atol=0.0, rtol=0.0):
        want = plain[part]
        return every(lambda r: all(np.all(
            np.abs(np.asarray(r[part][k], dtype=np.float64)
                   - np.asarray(want[k], dtype=np.float64))
            <= atol + rtol * np.abs(np.asarray(want[k], dtype=np.float64)))
            for k in keys))

    def history_ok(part):
        want = plain[part]["history"]
        h = F2_HISTORY_PATHS
        return all(np.array_equal(g, w[..., rk["rank"] * h:
                                       (rk["rank"] + 1) * h])
                   for rk in pair
                   for g, w in zip(rk["results"][part]["history"], want))

    def rates_ok(part):
        """``tests/test_torch_rates_mesh.py``'s bounds: means 1e-12
        relative, standard errors 1e-9, the PFE and the state histories
        bit for bit."""
        want = plain[part]
        errs = tuple(k for k in want if k.endswith("_stderr"))
        pfes = tuple(k for k in want if k.startswith("pfe_"))
        means = tuple(k for k in want
                      if k not in errs + pfes + ("history",))
        return (within(part, means, rtol=1e-12)
                and within(part, errs, rtol=1e-9)
                and every(lambda r: _f2_equal(r[part], want, pfes))
                and ("history" not in want or history_ok(part)))

    hyb_pfe = [k for k in plain["hybrid"] if k.startswith("pfe_")]
    checks = {
        "(a) NCCL on cuda:0": a["backend"] == "nccl"
        and a["device"] == "cuda:0",
        "(a) swap EE, ENE, forward value and PFE within 1e-12":
            out["a_nccl_world_1"]["swap_rows_pfe_gap"] < 1e-12,
        "(a) CVA within 1e-10 relative":
            out["a_nccl_world_1"]["cva_rel_gap"] < 1e-10,
        "(a) CVA ladder within rtol 1e-6 / atol 1e-10": ladder_ok(ra, pa),
        "(b) gloo ranks on cuda:0": all(
            rk["backend"] == "gloo" and rk["device"] == "cuda:0"
            for rk in pair),
        "(b) every rank returns the same results": all(
            _f2_gap(r1[p], r0[p]) == 0.0 for p in parts),
        "(b) swap rows and PFE within 1e-12":
            within("swap", rows + tuple(pfe_keys), atol=1e-12),
        "(b) swap CVA 1e-10 relative, ladder rtol 1e-6 / atol 1e-10":
            within("swap", ("cva",), rtol=1e-10)
            and every(lambda r: ladder_ok(r["swap"], plain["swap"])),
        "(b) 20-trade set within 1e-12, its IM within 1e-9":
            within("netting_set", rows + tuple(pfe_keys), atol=1e-12)
            and within("netting_set", ("expected_im", "expected_im_tmoney"),
                       atol=1e-9),
        "(b) mixed set with and without a CSA within 1e-8, PFE 1e-7":
            within("mixed", rows + tuple(f"csa_{k}" for k in rows),
                   atol=1e-8)
            and within("mixed", tuple(pfe_keys)
                       + tuple(f"csa_{k}" for k in pfe_keys), atol=1e-7),
        "(b) hybrid on the ranks' draws: values 1e-12 relative, rows 1e-9, "
        "PFE 1e-10 relative":
            within("hybrid", ("call_10y", "note"), rtol=1e-12)
            and within("hybrid", ("martingale_errors",), atol=1e-12)
            and within("hybrid", rows, atol=1e-9)
            and within("hybrid", tuple(hyb_pfe), rtol=1e-10),
        "(b) hybrid results finite": every(
            lambda r: all(np.all(np.isfinite(np.asarray(v, dtype=float)))
                          for k, v in r["hybrid"].items() if k != "draws")),
        "(a) swap PFE bit for bit": out["a_nccl_world_1"]["swap_pfe_bitwise"],
        "(b) swap and 20-trade set PFE bit for bit": every(
            lambda r: _f2_equal(r["swap"], plain["swap"], pfe_keys)
            and _f2_equal(r["netting_set"], plain["netting_set"], pfe_keys)),
        "(b) Hull-White swaption, bond, TARN and Bermudan 1e-12 relative, "
        "their errors 1e-9, the (x, Y) histories bit for bit":
            rates_ok("hull_white"),
        "(b) WWR CVA, its independent part, contributions and survival "
        "1e-12 relative": rates_ok("wwr"),
        "(b) cross-currency FX forward, options, CCS legs and exposure rows "
        "1e-12 relative, option errors 1e-9, exposure PFE and histories bit "
        "for bit": rates_ok("xccy"),
        "(b) Jarrow-Yildirim ZCIS and YoY forward 1e-12 relative, its error "
        "1e-9, the histories bit for bit": rates_ok("inflation"),
        "(b) copula ETL and P(>= k) 1e-12 relative, ETL errors 1e-9, the "
        "latent matrix bit for bit": rates_ok("copula"),
        "(b) Schwartz-Smith futures, options and calendar spread 1e-12 "
        "relative, their errors 1e-9, the histories bit for bit":
            rates_ok("commodity"),
        "(b) VaR report bit for bit (VaR, ES, component ES, the quantile's "
        "error, mean P&L)": every(lambda r: _f2_equal(
            r["risk"], plain["risk"], tuple(plain["risk"]))),
    }
    print("phase 47 bit for bit against the unsharded port: " + json.dumps({
        name: bool(ok) for name, ok in checks.items()
        if "bit for bit" in name}), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 47 failed: {failed}")
    print(f"phase 47 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 48: path-axis sharding of Heston-SLV and the remaining equity
# products, the four utilities and examples 01-04 (no kernel)
# ---------------------------------------------------------------------------

F3_SLV_STRIKES = [85.0, 100.0, 115.0]
F3_LV_STRIKES = [80.0, 90.0, 100.0, 110.0, 120.0]
F3_BIASES = ("split", "insample")


def _f3_structured():
    from finmath_tpu_torch.models.structured_products import (
        AutocallableNote, ChooserOption, CliquetOption, CompoundOption,
        ForwardStartOption)

    return {"forward_start": ForwardStartOption(0.4, 1.0, 1.05),
            "cliquet": CliquetOption([0.2, 0.4, 0.6, 0.8, 1.0], -0.05, 0.08),
            "compound": CompoundOption(0.5, 5.0, 1.0, 100.0),
            "chooser": ChooserOption(0.5, 1.0, 100.0),
            "express_autocall": AutocallableNote([0.5, 1.0], [105.0, 100.0],
                                                 [0.05, 0.08], 70.0)}


def _f3_results(mesh) -> dict:
    """Phase 48's meshed work on one rank (``mesh``), or unsharded on
    ``cuda`` (None): phase 41's SLV at 409,600 x 100 (seed 21: the call
    grid, ``leverage_at(1.0)``, the terminal state, and the fits on the
    initial cloud and on the first step's cloud of the unsharded run, this
    rank's block of it); phase 40's local-vol call grid at 1M x 100;
    phase 34's 1M x 250 facade's delta hedge and variance swap; phase 36's
    LS put at 1M x 50 in both modes with every path's cashflow (the
    exercise decisions); phase 37's five structured products at 1M x 50.
    Results are on the host, every path-wise one gathered."""
    import torch

    from finmath_tpu_torch.models.american import (BermudanOption,
                                                   _ls_cashflows)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.equity_products import (
        _deterministic_dfs, _f32)
    from finmath_tpu_torch.models.hedging import (DeltaHedgedPortfolio,
                                                  VarianceSwap)
    from finmath_tpu_torch.models.heston import HestonParams
    from finmath_tpu_torch.models.local_vol import (
        LocalVolatilityModel, MonteCarloLocalVolModel, SSVISurface,
        european_call_values)
    from finmath_tpu_torch.models.process import euler_scan
    from finmath_tpu_torch.models.slv import (HestonSLVModel,
                                              MonteCarloHestonSLVModel,
                                              _fit_conditional_variance,
                                              hat_basis)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    from finmath_tpu_torch.utils.config import to_device

    device = torch.device("cuda") if mesh is None else mesh.device

    def gather(x):
        return (x if mesh is None else mesh.all_gather(x)).cpu().numpy()

    out = {"products": {}, "cash": {}}
    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=0.6, gamma=0.4)
    hp = HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.06, xi=0.8,
                      rho=-0.7)
    td = TimeDiscretization(initial=0.0, num_steps=100, step=0.01)
    model = HestonSLVModel(hp, surf, td)
    sim = MonteCarloHestonSLVModel(td, SLV_PATHS, model, seed=21, mesh=mesh,
                                   device=device)
    out["slv_calls"] = european_call_values(sim, F3_SLV_STRIKES, [1.0])
    out["slv_leverage"] = sim.leverage_at(1.0, F3_SLV_STRIKES)
    out["slv_terminal"] = gather(sim.process._lazy_states()[-1])
    # one cloud for both fits: the unsharded run's first step (the same
    # Euler step of the unbound model on the global increments)
    cloud = euler_scan(model, model.initial_state(SLV_PATHS, device),
                       sim.brownian.increments[:1].to(device),
                       td.get_step_sizes()[:1])
    if mesh is not None:
        cloud = cloud[..., mesh.local_slice(SLV_PATHS)]
    nodes = model._nodes_on(device)
    out["slv_fits"] = {}
    for i in (0, 1):
        k = model._moneyness(i, cloud[i, 0])
        beta, m, s = _fit_conditional_variance(
            k, torch.clamp_min(cloud[i, 1], 0.0), nodes, axis_name=mesh)
        cond = beta.to(torch.float32) @ hat_basis((k - m) / s, nodes)
        out["slv_fits"][i] = (beta.cpu().numpy(), float(m), float(s),
                              float(cond.min()), float(cond.max()))
    out["slv_bound"] = mesh is None or sim.model.mesh is mesh
    del sim, cloud

    lv = MonteCarloLocalVolModel(
        td, LOCAL_VOL_PATHS, LocalVolatilityModel(100.0, 0.03, surf, td),
        seed=12, mesh=mesh, device=device)
    out["lv_calls"] = european_call_values(lv, F3_LV_STRIKES, [1.0])
    del lv

    bs = BlackScholesModel(100.0, 0.05, 0.3)
    sim = MonteCarloBlackScholesModel(
        TimeDiscretization(initial=0.0, num_steps=EXOTIC_STEPS,
                           step=1.0 / EXOTIC_STEPS),
        EXOTIC_PATHS, bs, seed=42, mesh=mesh, device=device)
    hedge = DeltaHedgedPortfolio(1.0, 105.0).simulate(sim)
    for key in ("value", "hedge_error_mean", "hedge_error_std"):
        out["products"][f"hedge_{key}"] = (hedge[key], 0.0)
    swap = VarianceSwap(1.0)
    out["products"]["variance_swap"] = swap.get_value_and_error(sim)
    out["products"]["variance_swap_strike"] = (swap.fair_strike(sim), 0.0)
    del sim

    ex = [i * 0.02 for i in range(1, 51)]
    sim = MonteCarloBlackScholesModel(
        TimeDiscretization(initial=0.0, num_steps=50, step=0.02),
        AMERICAN_PATHS, bs, seed=77, mesh=mesh, device=device)
    assets = sim.get_asset_values(ex)
    dfs = to_device(_deterministic_dfs(sim, ex)[:, None], torch.float64,
                    device)
    for bias in F3_BIASES:
        put = BermudanOption(ex, 110.0, is_call=False, foresight_bias=bias)
        out["products"][f"ls_put_{bias}"] = put.get_value_and_error(sim)
        out["cash"][bias] = gather(_ls_cashflows(
            assets, dfs, _f32(110.0, assets), False, 3, bias == "split",
            mesh))
    del sim, assets

    sim = MonteCarloBlackScholesModel(
        TimeDiscretization(initial=0.0, num_steps=50, step=0.02),
        STRUCTURED_PATHS, bs, seed=21, mesh=mesh, device=device)
    for name, product in _f3_structured().items():
        out["products"][name] = product.get_value_and_error(sim)
    del sim
    return out


def _mesh_f3_rank(mesh):
    """Phase 48, on every rank: ``_f3_results`` with its wall, the
    collectives, the seconds in them and the peak device memory."""
    import torch

    out, stats = _f2_timed(torch, mesh, lambda: _f3_results(mesh))
    return {"results": out, "stats": stats, "rank": mesh.rank,
            "device": str(mesh.device), "backend": mesh.backend}


def _f3_compare(got, want) -> dict:
    """A rank's phase 48 results against the unsharded ones, at the bounds
    of ``tests/test_torch_slv_products_mesh.py``: each gap, and whether it
    holds."""
    prod = {k: max(abs(got["products"][k][0] - v[0])
                   / max(abs(v[0]), 1.0),
                   abs(got["products"][k][1] - v[1])
                   / max(abs(v[1]), 1e-12))
            for k, v in want["products"].items()}
    grids = {k: float(np.max(np.abs(got[k] - want[k])
                             / np.maximum(np.abs(want[k]), 1e-300)))
             for k in ("lv_calls", "slv_calls")}
    flips = {b: int(np.sum(got["cash"][b] != want["cash"][b]))
             for b in F3_BIASES}
    fits = {}
    for i, (beta, m, s, lo, hi) in got["slv_fits"].items():
        wb, wm, ws, wlo, whi = want["slv_fits"][i]
        fits[i] = {"m_rel": abs(m - wm) / abs(wm),
                   "s_rel": abs(s - ws) / ws,
                   "beta_rel": float(np.max(np.abs(beta - wb))
                                     / np.max(np.abs(wb))),
                   "cond_vs_v0": max(abs(lo / 0.04 - 1), abs(hi / 0.04 - 1),
                                     abs(wlo / 0.04 - 1),
                                     abs(whi / 0.04 - 1))}
    wt = want["slv_terminal"]
    scale = np.abs(wt).max(axis=1)[:, None]
    terminal = float(np.max(np.abs(got["slv_terminal"] - wt) / scale))
    lev = float(np.max(np.abs(got["slv_leverage"] / want["slv_leverage"]
                              - 1)))
    calls_se = float(np.max(np.abs(got["slv_calls"][..., 0]
                                   - want["slv_calls"][..., 0])
                            / want["slv_calls"][..., 1]))
    gaps = {"products_rel": prod, "grids_rel": grids,
            "decision_flips": flips, "slv_fits": fits,
            "slv_terminal_rel": terminal, "slv_leverage_rel": lev,
            "slv_calls_in_se": calls_se}
    checks = {
        "products within 1e-9 relative": max(prod.values()) < 1e-9,
        "call grids within 1e-9 relative": grids["lv_calls"] < 1e-9,
        "LS put decisions equal on every path":
            not any(flips.values()),
        "SLV moments of both fits within 1e-6": all(
            f["m_rel"] < 1e-6 and f["s_rel"] < 1e-6 for f in fits.values()),
        "SLV first step E[V|k] within 1e-5 of v0": fits[0]["cond_vs_v0"]
        < 1e-5,
        "SLV second step beta within 1e-6": fits[1]["beta_rel"] < 1e-6,
        "SLV terminal state within 1e-5": terminal < 1e-5,
        "SLV leverage within 1e-4": lev < 1e-4,
        "SLV calls within 1e-3 se": calls_se < 1e-3,
        "SLV model bound to the mesh": got["slv_bound"],
    }
    return gaps, checks


# phase 48 (c): one bs_paths_kernel launch under capture_trace in a fresh
# process (argv: the repository, the trace directory)
F3_TRACE_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from finmath_tpu_torch.ops import kernels
from finmath_tpu_torch.utils.profiling import capture_trace
with capture_trace(sys.argv[2]):
    kernels.bs_paths_kernel(3141, 1_000_000, 100, 1.0, 0.05, 0.3, 1.0, 1.05,
                            device="cuda")
    torch.cuda.synchronize()
sys.exit(0 if kernels.LAUNCHES["bs_paths"] == 1 else 1)
"""


def _trace_kernels(log_dir) -> list:
    """The names of the kernel events of the one Chrome trace in
    ``log_dir``."""
    import glob

    (path,) = glob.glob(os.path.join(log_dir, "trace.*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def _f3_utilities(torch) -> dict:
    """Phase 48 (c): the utilities on the card, each check a gate."""
    import tempfile

    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.ops import kernels
    from finmath_tpu_torch.utils.memory import (get_device_memory_info,
                                                live_device_arrays)
    from finmath_tpu_torch.utils.profiling import capture_trace
    from finmath_tpu_torch.utils.serialization import (load_checkpoint,
                                                       save_checkpoint)

    gib = 2 ** 30
    torch.cuda.synchronize()
    before = get_device_memory_info()
    arrays = live_device_arrays()
    big = torch.empty(gib, dtype=torch.uint8, device="cuda")
    after = get_device_memory_info()
    arrays_with = live_device_arrays()
    del big
    arrays_after = live_device_arrays()
    total = torch.cuda.get_device_properties(0).total_memory

    s0, r, sigma, maturity, strike = BS_PARAMS
    with tempfile.TemporaryDirectory() as tmp:
        # the gate runs in a fresh process: in this one, after the
        # profiled calls of phases 38-45, the profiler misses the kernels
        # at a session's start (one session of 30,000 device operations
        # earlier is enough), so this process's trace is printed, not
        # gated
        launches = kernels.LAUNCHES["bs_paths"]
        with capture_trace(os.path.join(tmp, "here")):
            kernels.bs_paths_kernel(BS_SEED, BS_PATHS, BS_STEPS, s0, r,
                                    sigma, maturity, strike, device="cuda")
            torch.cuda.synchronize()
        traced = kernels.LAUNCHES["bs_paths"] - launches
        here = _trace_kernels(os.path.join(tmp, "here"))
        child = subprocess.run(
            [sys.executable, "-c", F3_TRACE_CHILD, REPO,
             os.path.join(tmp, "fresh")],
            capture_output=True, text=True, timeout=300)
        fresh = (_trace_kernels(os.path.join(tmp, "fresh"))
                 if child.returncode == 0 else [])
        kernel_events = [n for n in fresh if "bs_paths_kernel" in n]

        setup = build_atm_calibration(num_paths=PATHS, num_factors=1,
                                      seed=SEED, device="cuda")
        params = np.asarray(setup.covariance.initial_parameters) * 1.07
        r_before = setup.engine.residuals(params)
        save_checkpoint(os.path.join(tmp, "atm_ckpt"), params,
                        {"paths": PATHS})
        restored, meta = load_checkpoint(os.path.join(tmp, "atm_ckpt"))
        r_after = setup.engine.residuals(restored)
        del setup
    out = {"before": repr(before), "after": repr(after),
           "in_use_rise_gib": (after.bytes_in_use - before.bytes_in_use)
           / gib, "peak_gib": after.peak_bytes_in_use / gib,
           "limit_gib": after.bytes_limit / gib,
           "free_fraction": after.free_fraction,
           "live_arrays": [arrays, arrays_with, arrays_after],
           "fresh_process_trace": {
               "rc": child.returncode, "kernel_events": len(fresh),
               "bs_paths_kernel": kernel_events[0][:80]
               if kernel_events else None,
               "stderr_tail": child.stderr[-300:]
               if child.returncode else ""},
           "this_process_trace": {
               "launches": traced, "kernel_events": len(here),
               "names_bs_paths_kernel": any("bs_paths_kernel" in n
                                            for n in here)}}
    checks = {
        "bytes_in_use rises by at least 1 GiB":
            after.bytes_in_use - before.bytes_in_use >= gib,
        "peak at least the bytes in use":
            after.peak_bytes_in_use >= after.bytes_in_use,
        "limit is the card's total memory": after.bytes_limit == total,
        "free fraction in (0, 1)": 0.0 < after.free_fraction < 1.0,
        "live_device_arrays rises by one and falls back":
            arrays_with == arrays + 1 and arrays_after == arrays,
        "a fresh process's trace names bs_paths_kernel":
            child.returncode == 0 and len(kernel_events) == 1,
        "checkpoint round trip: residuals bit-equal":
            np.array_equal(restored, params) and meta == {"paths": PATHS}
            and np.array_equal(r_before, r_after),
    }
    return out, checks


def _f3_examples(torch) -> dict:
    """Phase 48 (d): the port's examples 01-04 at their default sizes on
    the card; each main's own asserts are gates (they raise)."""
    import importlib.util

    from finmath_tpu_torch.ops import kernels

    out = {}
    for name in ("01_random_variables", "02_black_scholes_greeks",
                 "03_lmm_calibration", "04_multichip_sharding"):
        spec = importlib.util.spec_from_file_location(
            f"port_example_{name}",
            os.path.join(REPO, "finmath_tpu_torch", "examples",
                         f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        launches = kernels.LAUNCHES["bs_paths"]
        t0 = time.perf_counter()
        res = module.main()
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "bs_paths_launches":
                         kernels.LAUNCHES["bs_paths"] - launches}
        if name == "02_black_scholes_greeks":
            out[name].update({k: res[k] for k in ("fused", "delta",
                                                  "delta_aad")})
        elif name == "03_lmm_calibration":
            out[name]["mean_dev"] = float(np.mean(res["deviations"]))
        elif name == "04_multichip_sharding":
            out[name].update(world_size=res["world_size"],
                             backend=res["backend"], cva=res["cva"])
    checks = {
        "example 02 prices through one bs_paths_kernel launch":
            out["02_black_scholes_greeks"]["bs_paths_launches"] == 1,
        "example 04 on NCCL ranks":
            out["04_multichip_sharding"]["backend"] == "nccl",
    }
    return out, checks


def _path_mesh_f3(torch, smi) -> None:
    """Phase 48 (no kernel). (a) An NCCL world of one on ``cuda:0`` and (b)
    a gloo world of two ranks on the card, spawned and joined as in phase
    46 but both at once, each run ``_f3_results`` meshed (phase 41's SLV
    at 409,600 x 100, phase 40's call grid at 1M x 100, phases 34, 36 and
    37's products at 1M paths) against the unsharded port on the same
    streams (computed here while the worlds run; each join wall counts
    from the phase's start) at ``tests/test_torch_slv_products_mesh.py``'s
    bounds; every rank of a world returns the same results. (c) The
    utilities: memory info around a 1 GiB tensor, ``live_device_arrays``,
    a Chrome trace around one ``bs_paths_kernel`` launch in a fresh
    process that names the kernel (and this process's, printed), the ATM
    checkpoint round trip with bit-equal residuals. (d)
    Examples 01-04 at their default sizes. Printed: the gaps, each world's
    walls, collectives and peak memory per rank, beside the card's name and
    power limit."""
    from finmath_tpu_torch.parallel.launch import start_world

    t_phase = time.perf_counter()
    # both worlds and the unsharded references run at once: each is
    # bound by its own host dispatch
    with start_world(f"{MODULE}:_mesh_f3_rank", 1, backend="nccl",
                     device="cuda:0") as world_a, \
            start_world(f"{MODULE}:_mesh_f3_rank", 2, backend="gloo",
                        device="cuda:0") as world_b:
        want = _f3_results(None)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t_phase
        (a,) = world_a.join(MESH_JOIN_SECONDS)
        a_join_s = time.perf_counter() - t_phase
        pair = world_b.join(MESH_JOIN_SECONDS)
        b_join_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    out, checks = {"unsharded_s": ref_s}, {}
    for label, ranks, join_s in (("a_nccl_world_1", [a], a_join_s),
                                 ("b_gloo_world_2", pair, b_join_s)):
        gaps, held = _f3_compare(ranks[0]["results"], want)
        out[label] = {"gaps": gaps, "join_wall_s": join_s,
                      "ranks": [dict(rk["stats"], backend=rk["backend"],
                                     device=rk["device"]) for rk in ranks]}
        checks.update({f"({label[0]}) {k}": v for k, v in held.items()})
        checks[f"({label[0]}) every rank the same results"] = all(
            rk["results"]["products"] == ranks[0]["results"]["products"]
            and all(np.array_equal(rk["results"]["cash"][b],
                                   ranks[0]["results"]["cash"][b])
                    for b in F3_BIASES)
            and np.array_equal(rk["results"]["slv_terminal"],
                               ranks[0]["results"]["slv_terminal"])
            for rk in ranks)
    checks["(a) NCCL on cuda:0"] = (a["backend"] == "nccl"
                                   and a["device"] == "cuda:0")
    checks["(b) gloo ranks on cuda:0"] = all(
        rk["backend"] == "gloo" and rk["device"] == "cuda:0" for rk in pair)
    out["c_utilities"], held = _f3_utilities(torch)
    checks.update({f"(c) {k}": v for k, v in held.items()})
    out["d_examples"], held = _f3_examples(torch)
    checks.update({f"(d) {k}": v for k, v in held.items()})
    print(f"phase 48 path-axis sharding F3, utilities, examples ({smi}): "
          + json.dumps(out), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 48 failed: {failed}")
    print(f"phase 48 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 49: examples 05-16 at their default sizes (no kernel of their own)
# ---------------------------------------------------------------------------

F4_EXAMPLES = ("05_pallas_kernels_and_bermudan",
               "06_lazy_qmc_and_reference_stream", "07_risk_ladders",
               "08_exposure_cva", "09_model_zoo", "10_exotics_and_rainbows",
               "11_rates_cube_cms_bermudan",
               "12_localvol_structured_caps_hybrid",
               "13_credit_xccy_portfolio", "14_inflation_commodity_risk",
               "15_bermudan_exposure_kva",
               "16_kernel_calibration_and_portfolio")


def _f4_key_numbers(name, res) -> dict:
    """What phase 49 prints of example ``name``'s result."""
    if name.startswith("05"):
        return {k: res[k] for k in ("analytic", "scan", "fused",
                                    "swaption_engine", "swaption_kernel",
                                    "swaption_rel_dev", "european",
                                    "bermudan")}
    if name.startswith("06"):
        return {"lazy_average": res["lazy"]["average"],
                "mersenne_vol0": float(res["reference_vols"][0]),
                "qmc_variance": res["qmc"]["terminal_variance"],
                "bermudan": res["bermudan"],
                "swap_s": res["swapping"]["seconds"]}
    if name.startswith("07"):
        p, m = res["portfolio"], res["matrix"]
        return {"value": p["value"], "cold_s": p["cold_s"],
                "warm_s": p["warm_s"],
                "rows_sum_to_ladder": m["rows_sum_to_ladder"]}
    if name.startswith("08"):
        return {"martingale": res["martingale"],
                "cva_120bp": res["cva"][0.012],
                "netted_cva": res["netted_cva"],
                "bilateral_cva": res["bilateral_cva"]}
    if name.startswith("09"):
        return {k: v["wall_s"] for k, v in res.items()}
    if name.startswith("10"):
        vi, vo, ve = res["path_dependent"]["parity"]
        return {"in_plus_out_minus_european": vi + vo - ve,
                "sabr_fit_rms": res["sabr"]["fit_rms"]}
    if name.startswith("11"):
        b = res["bermudan"]
        return {"bermudan": b["value"], "stderr": b["stderr"],
                "pde": b["pde"], "ms": b["ms"]}
    if name.startswith(("12", "13", "14")):
        return {"walls_s": res["walls"]}
    if name.startswith("15"):
        return {"bracket": list(res["bracket"]), "cva": res["cva"],
                "kva": res["kva"]}
    cal = res["calibration"]
    return {"jacobian_shape": list(cal["jacobian"].shape), "ms": cal["ms"],
            "timed_launches": cal["launches"], "gap": cal["gap"],
            "book": [list(v) for v in res["book"]["results"]]}


def _examples_f4(torch, smi) -> None:
    """Phase 49 (no kernel of its own): examples 05-16 at their default
    sizes on the card, one after another in this process. Every kernel
    count is set to 0 just before each ``main`` and read just after it.
    Each script's own asserts are gates; example 05 must take exactly one
    ``bs_paths`` and one ``lmm_swaption_paths`` launch with its fused price
    within 0.005 of the analytic value, and example 16's timed
    ``residuals_and_jacobian`` exactly one ``lmm_stochvol_products``
    launch within 5e-5 of the engine's residuals. Printed: each script's
    wall, launches and key numbers, beside the card's name and power
    limit."""
    import importlib.util
    import traceback

    from finmath_tpu_torch.ops import _swaption_paths as sp
    from finmath_tpu_torch.ops import (black_residuals, exposure_collect,
                                       kernels, lmm_kernel,
                                       lmm_stochvol_kernel)

    def reset():
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        sp.LAUNCHES.update(dict.fromkeys(sp.LAUNCHES, 0))
        lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
        black_residuals.LAUNCHES = exposure_collect.LAUNCHES = 0

    def counts() -> dict:
        got = {k: v for k, v in {**kernels.LAUNCHES, **sp.LAUNCHES}.items()
               if v}
        if lmm_kernel.LAUNCHES:
            got["lmm_atm_products"] = lmm_kernel.LAUNCHES
        if lmm_stochvol_kernel.LAUNCHES:
            got["lmm_stochvol_products"] = lmm_stochvol_kernel.LAUNCHES
        if black_residuals.LAUNCHES:
            got["black_residuals"] = black_residuals.LAUNCHES
        if exposure_collect.LAUNCHES:
            got["exposure_collect"] = exposure_collect.LAUNCHES
        return got

    t_phase = time.perf_counter()
    out, results, checks = {}, {}, {}
    for name in F4_EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"port_example_{name}",
            os.path.join(REPO, "finmath_tpu_torch", "examples",
                         f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        try:
            res = module.main()
        except Exception:     # an assert of the script, or any failure
            traceback.print_exc()
            res = None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"wall_s": wall, "launches": counts()}
        checks[f"example {name[:2]}'s own asserts hold"] = res is not None
        if res is not None:
            results[name] = res
            out[name].update(_f4_key_numbers(name, res))
        torch.cuda.empty_cache()

    k05, k16 = F4_EXAMPLES[0], F4_EXAMPLES[-1]
    if k05 in results:
        launches = out[k05]["launches"]
        checks["example 05: one bs_paths launch"] = \
            launches.get("bs_paths", 0) == 1
        checks["example 05: one lmm_swaption_paths launch"] = \
            launches.get("lmm_swaption_paths", 0) == 1
        checks["example 05: fused price within 0.005 of the analytic"] = \
            abs(results[k05]["fused"] - results[k05]["analytic"]) < 0.005
    if k16 in results:
        cal = results[k16]["calibration"]
        checks["example 16: the timed call is one lmm_stochvol_products "
               "launch"] = cal["launches"] == 1
        checks["example 16: warm-up and timed call, two launches in all"] = \
            out[k16]["launches"].get("lmm_stochvol_products", 0) == 2
        checks["example 16: 17 parameter sets, a (15, 8) Jacobian"] = (
            cal["parameter_sets"] == 17
            and tuple(cal["jacobian"].shape) == (15, 8))
        checks["example 16: kernel within 5e-5 of the engine"] = \
            cal["gap"] < 5e-5
    print(f"phase 49 examples 05-16 ({smi}): "
          + json.dumps(out, default=float), flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 49 failed: {failed}")
    print(f"phase 49 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 6: the device's busy share of the "
                             "calibration under torch.profiler")
    opts = parser.parse_args(argv)
    t_script = time.perf_counter()
    import torch

    # -- 1: the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    sys.path.insert(0, REPO)
    from finmath_tpu_torch.models.lmm import (ATMKernelCalibration,
                                              StochVolKernelCalibration,
                                              build_atm_calibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        CURATED_BASINS)
    from finmath_tpu_torch.native import host_rng
    from finmath_tpu_torch.models.lmm.model import BLACK_NEWTON_STEPS
    from finmath_tpu_torch.ops import (_cuda_build, _products,
                                       _swaption_paths, black_residuals,
                                       kernels, lmm_kernel,
                                       lmm_stochvol_kernel)

    # -- 2: build every source and instantiation, one nvcc each, together --
    def build(job):
        module, variant = job
        t0 = time.perf_counter()
        module.load_kernel(*variant)
        return time.perf_counter() - t0

    jobs = [(kernels, ()), (black_residuals, ())] + [
        (module, (v,)) for module, variants in _sweep_variants(
            _products, lmm_kernel, lmm_stochvol_kernel,
            _swaption_paths).items()
        for v in sorted(variants)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        build_s = list(pool.map(build, jobs))
    for (module, variant), seconds in zip(jobs, build_s):
        pricer = module is _swaption_paths
        defines = () if not variant else (
            _swaption_paths.pricer_defines if pricer
            else _products.sweep_defines)(*variant[0])
        log = _cuda_build.library_path(module.SOURCE, defines,
                                       module.FLAGS).with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        tag = "" if not variant else (
            (" (K, F) = " if pricer else " (K, F, R) = ") + str(variant[0]))
        print(f"phase 2 build: {seconds:.3f} s ({module.SOURCE}{tag}); "
              + " | ".join(ptxas), flush=True)

    # -- 3: kernel against plain version on the card ----------------------
    max_abs_err = 0.0
    cases = (("a", PATHS, "NORMAL", False), ("b", PATHS + 3, "NORMAL", False),
             ("c", 8_192, "DISPLACED", True))
    for label, paths, model_type, fd_batch in cases:
        setup = build_atm_calibration(num_paths=paths, num_factors=1,
                                      seed=SEED, model_type=model_type,
                                      device="cuda")
        kb = ATMKernelCalibration(setup.engine)
        x = kb.params(setup.covariance.initial_parameters)
        X = kb.fd_parameter_sets(x)[0] if fd_batch else x[None, :]
        args, kwargs = kb.kernel_arguments(X)
        ok, err, got = _partials_equal(
            torch, lmm_kernel,
            lmm_kernel.lmm_atm_swaptions_partials_reference, args, kwargs)
        max_abs_err = max(max_abs_err, err)
        print(f"phase 3{label} kernel vs plain: paths={paths} "
              f"B={X.shape[0]} {model_type} partials={tuple(got.shape)} "
              f"max_abs_err={err:.3e} partials of two launches bit for bit "
              f"equal to the plain partials: {ok}", flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: phase 3{label}: kernel disagrees "
                             "with its plain version")
        del setup, kb, args, got
    err = _check_synthetic(torch, lmm_kernel,
                           lmm_kernel.lmm_atm_swaptions_partials_reference,
                           "atm")
    max_abs_err = max(max_abs_err, err)
    print(f"phase 3d kernel vs plain: paths={SYN_PATHS} B={SYN_B} "
          f"libors={SYN_LIBORS} factors=2 DISPLACED max_abs_err={err:.3e} "
          f"partials bit for bit equal to the plain partials: True",
          flush=True)

    # -- 4: the main path --------------------------------------------------
    t0 = time.perf_counter()
    setup = build_atm_calibration(num_paths=PATHS, num_factors=1, seed=SEED,
                                  jacobian_paths=JAC_PATHS, device="cuda")
    kb = ATMKernelCalibration(setup.engine)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p0 = setup.covariance.initial_parameters
    t0 = time.perf_counter()
    kb.residuals(p0)
    setup.engine.implied_vols(p0)
    setup.jacobian_engine.jacobian(p0)
    # the analytic warm-start engine is built lazily: build and warm it here
    # too, so the timed region is the calibration procedure alone
    setup.analytic_engine.residuals(p0)
    setup.analytic_engine.jacobian(p0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # count the calibration's residual calls: each must be one kernel launch
    residual_calls = _Counted(kb.residuals)
    kb.residuals = residual_calls
    lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    result = setup.calibrate(max_iterations=60, accuracy=1e-7,
                             warm_start="analytic", residual_backend=kb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lmm_kernel.LAUNCHES
    del kb.residuals
    dev = setup.deviations(result.parameters)
    mean_dev = float(np.mean(dev))
    rms_dev = float(np.sqrt(np.mean(dev ** 2)))
    r_kernel = kb.residuals(result.parameters)
    r_engine = setup.engine.residuals(result.parameters)
    kernel_vs_engine = float(np.abs(r_kernel - r_engine).max())
    on_cuda = (setup.engine.increments.is_cuda
               and all(t.is_cuda for t in kb.kernel_arguments(
                   kb.params(p0)[None, :])[0]))
    print(f"phase 4 calibration: paths={PATHS} jacobian_paths={JAC_PATHS} "
          f"products={len(setup.engine.products)} "
          f"parameters={setup.covariance.n_params} "
          f"iterations={result.iterations} rms_error={result.rms_error:.6e} "
          f"mean_dev={mean_dev:.6e} rms_dev={rms_dev:.6e} wall_s={wall:.4f} "
          f"setup_s={setup_s:.3f} warmup_s={warm_s:.3f} "
          f"kernel_launches={launches} "
          f"residual_calls={residual_calls.calls} "
          f"kernel_vs_engine_residuals={kernel_vs_engine:.3e} "
          f"on_cuda={on_cuda}", flush=True)
    checks = {
        "kernel launched": launches > 0,
        "one launch per residual call": launches == residual_calls.calls,
        "realization and kernel inputs on cuda": on_cuda,
        "deviations finite, one per product": bool(
            np.all(np.isfinite(dev)) and dev.shape == (144,)),
        "|mean_dev| < 2e-4": abs(mean_dev) < 2e-4,
        "rms_dev < 2e-4": rms_dev < 2e-4,
        "kernel residuals within 5e-5 of the engine's": kernel_vs_engine < 5e-5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 4 failed: {failed}")

    # where the calibration wall goes: the same procedure once more, with
    # each stage's calls counted and timed (host clock, synchronised)
    stages = {"analytic residuals": (setup.analytic_engine, "residuals"),
              "analytic jacobian": (setup.analytic_engine, "jacobian"),
              "engine jacobian (5k paths)": (setup.jacobian_engine, "jacobian"),
              "kernel residuals (100k paths)": (kb, "residuals")}
    timers = {}
    for name, (obj, attr) in stages.items():
        timers[name] = _Timed(torch, getattr(obj, attr))
        setattr(obj, attr, timers[name])
    t0 = time.perf_counter()
    setup.calibrate(max_iterations=60, accuracy=1e-7, warm_start="analytic",
                    residual_backend=kb)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    for name, (obj, attr) in stages.items():
        delattr(obj, attr)
    print("phase 4 breakdown: " + json.dumps(
        {"wall_s": round(wall2, 4), **{
            name: {"calls": t.calls, "s": round(t.seconds, 4)}
            for name, t in timers.items()}}), flush=True)

    # -- 5: kernel time at the main path's shape and the FD batch ---------
    args, kwargs = kb.kernel_arguments(kb.params(result.parameters)[None, :])
    X = kb.fd_parameter_sets(kb.params(result.parameters))[0]
    fd_args, fd_kwargs = kb.kernel_arguments(X)
    atm_run = lmm_kernel.lmm_atm_swaptions_batch
    ms, wrapper_ms = _products_ms(torch, lmm_kernel, atm_run,
                                  args, kwargs)
    fd_ms, fd_wrapper_ms = _products_ms(torch, lmm_kernel, atm_run,
                                        fd_args, fd_kwargs)
    plain_ms = _time_ms(
        torch, lambda: lmm_kernel.lmm_atm_swaptions_batch_reference(
            *args, **kwargs))
    atm_ops = dict(num_libors=kwargs["num_libors"],
                   num_factors=kwargs["num_factors"],
                   products=kwargs["products"], paths=PATHS, stoch_vol=False,
                   displaced=kwargs["displaced"])
    bound_ms, bound_by = _bound(
        args, lmm_kernel.lmm_atm_swaptions_batch(*args, **kwargs),
        _sweep_operations(B=1, **atm_ops))
    fd_bound_ms, _ = _bound(
        fd_args, lmm_kernel.lmm_atm_swaptions_batch(*fd_args, **fd_kwargs),
        _sweep_operations(B=X.shape[0], **atm_ops))
    print(f"phase 5 timing (median of 5, CUDA events; {smi}): B=1 "
          f"paths={PATHS} "
          f"kernel_ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} "
          f"plain_ms={plain_ms:.4f} speedup={plain_ms / ms:.2f}x "
          f"bound_ms={bound_ms:.4f} ({bound_by}); B={X.shape[0]} "
          f"paths={PATHS} "
          f"kernel_ms={fd_ms:.4f} wrapper_ms={fd_wrapper_ms:.4f} "
          f"bound_ms={fd_bound_ms:.4f}", flush=True)
    atm_row = {
        "name": "lmm_atm_products",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/lmm_atm_products.cu",
        "replaces": "finmath_tpu/ops/lmm_kernel.py:178",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    del args, fd_args

    # -- 7: stoch-vol kernel against plain version on the card ------------
    sv_max_abs_err = 0.0
    # (paths, [(label, FD batch?)]): one setup per path count; 7b is the
    # main path's FD-Jacobian launch, B=17 at the full path count
    for paths, cases in ((SV_PATHS, (("a", False), ("b", True))),
                         (SV_PATHS + 3, (("c", False),)),
                         (8_192, (("d", True),))):
        sv = build_benchmark_calibration(num_paths=paths, seed=SV_SEED,
                                         brownian="finmath_mersenne",
                                         device="cuda")
        sv_kb = StochVolKernelCalibration(sv.engine)
        x = sv_kb.params(sv.covariance.initial_parameters)
        for label, fd_batch in cases:
            X = sv_kb.fd_parameter_sets(x)[0] if fd_batch else x[None, :]
            args, kwargs = sv_kb.kernel_arguments(X)
            ok, err, got = _partials_equal(
                torch, lmm_stochvol_kernel, lmm_stochvol_kernel
                .lmm_stochvol_swaptions_partials_reference, args, kwargs)
            sv_max_abs_err = max(sv_max_abs_err, err)
            print(f"phase 7{label} stoch-vol kernel vs plain: paths={paths} "
                  f"B={X.shape[0]} partials={tuple(got.shape)} "
                  f"max_abs_err={err:.3e} partials of two launches bit for "
                  f"bit equal to the plain partials: {ok}", flush=True)
            if not ok:
                raise SystemExit(f"chip_smoke: phase 7{label}: stoch-vol "
                                 "kernel disagrees with its plain version")
            del args, got
        if paths == SV_PATHS:
            basin = CURATED_BASINS[0]
            basin_gap = float(np.abs(sv_kb.residuals(basin)
                                     - sv.engine.residuals(basin)).max())
            print(f"phase 7a curated basin 0: kernel vs engine residuals "
                  f"max gap {basin_gap:.3e} (limit 5e-3)", flush=True)
            if not basin_gap <= 5e-3:
                raise SystemExit("chip_smoke: phase 7a: kernel and engine "
                                 "disagree at the curated basin")
        del sv, sv_kb
    err = _check_synthetic(
        torch, lmm_stochvol_kernel,
        lmm_stochvol_kernel.lmm_stochvol_swaptions_partials_reference,
        "stochvol")
    sv_max_abs_err = max(sv_max_abs_err, err)
    print(f"phase 7e stoch-vol kernel vs plain: paths={SYN_PATHS} "
          f"B={SYN_B} libors={SYN_LIBORS} factors=5 "
          f"max_abs_err={err:.3e} partials bit for bit equal to the plain "
          f"partials: True", flush=True)

    # -- 8: slice B's main path, the stoch-vol benchmark calibration -------
    t0 = time.perf_counter()
    sv = build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                     brownian="finmath_mersenne",
                                     device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not host_rng.native_available():
        raise SystemExit("chip_smoke: phase 8: the native host RNG did not "
                         "build")
    sv_kb = StochVolKernelCalibration(sv.engine)
    sv_p0 = sv.covariance.initial_parameters
    sweep = sv.sweep_engine()
    analytic = sv.analytic_engine()
    t0 = time.perf_counter()
    for warm in (lambda: sv_kb.residuals(sv_p0),
                 lambda: sv_kb.residuals_and_jacobian(sv_p0),
                 lambda: sv.engine.values(sv_p0),
                 lambda: sv.engine.implied_vols(sv_p0),
                 lambda: sweep.residuals(sv_p0),
                 lambda: sweep.jacobian(sv_p0),
                 lambda: analytic.residuals(sv_p0),
                 lambda: analytic.jacobian(sv_p0)):
        warm()
    torch.cuda.synchronize()
    sv_warm_s = time.perf_counter() - t0
    # count and time the calls of each stage: each backend residual and
    # each backend Jacobian call must be one kernel launch. Every call
    # returns NumPy, so it has synchronised anyway and the timers add
    # nothing to the wall.
    sv_stages = {
        "kernel residuals (81,920 paths)": (sv_kb, "residuals"),
        "kernel FD jacobian (81,920 paths)": (sv_kb, "jacobian"),
        f"engine residuals ({sweep.num_paths:,} paths)": (sweep, "residuals"),
        f"engine jacobian ({sweep.num_paths:,} paths)": (sweep, "jacobian"),
        "engine oracle implied vols (81,920 paths)": (sv.engine,
                                                      "implied_vols"),
        "analytic residuals": (analytic, "residuals"),
        "analytic jacobian": (analytic, "jacobian"),
    }
    sv_timers = {}
    for name, (obj, attr) in sv_stages.items():
        sv_timers[name] = _Timed(torch, getattr(obj, attr))
        setattr(obj, attr, sv_timers[name])
    lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
    black_residuals.LAUNCHES = 0
    t0 = time.perf_counter()
    sv_result = sv.calibrate_multistart(target_rms19=SV_TARGET_RMS19,
                                        kernel_backend=sv_kb)
    torch.cuda.synchronize()
    sv_wall = time.perf_counter() - t0
    sv_launches = lmm_stochvol_kernel.LAUNCHES
    iv_launches = black_residuals.LAUNCHES
    for obj, attr in sv_stages.values():
        delattr(obj, attr)
    sv_res_calls = sv_timers["kernel residuals (81,920 paths)"]
    sv_jac_calls = sv_timers["kernel FD jacobian (81,920 paths)"]
    sv_dev = sv.deviations(sv_result.parameters)
    sv_mean_dev = float(np.mean(sv_dev))
    rms19 = float(np.sqrt(np.sum(sv_dev ** 2) / 19.0))
    sv_gap = float(np.abs(sv_kb.residuals(sv_p0)
                          - sv.engine.residuals(sv_p0)).max())
    sv_on_cuda = (sv.engine.increments.is_cuda
                  and all(t.is_cuda for t in sv_kb.kernel_arguments(
                      sv_kb.params(sv_p0)[None, :])[0]))
    backend_calls = sv_res_calls.calls + sv_jac_calls.calls
    print(f"phase 8 stoch-vol calibration: paths={SV_PATHS} "
          f"products={len(sv.engine.products)} "
          f"parameters={sv.covariance.n_params} "
          f"mersenne_generation_s={gen_s:.3f} warmup_s={sv_warm_s:.3f} "
          f"wall_s={sv_wall:.4f} evaluations={sv_result.iterations} "
          f"rms19={rms19:.6e} rms15={sv_result.rms_error:.6e} "
          f"mean_dev={sv_mean_dev:.6e} kernel_launches={sv_launches} "
          f"inversion_launches={iv_launches} "
          f"backend_residual_calls={sv_res_calls.calls} "
          f"backend_jacobian_calls={sv_jac_calls.calls} "
          f"kernel_vs_engine_residuals_p0={sv_gap:.3e} "
          f"on_cuda={sv_on_cuda}", flush=True)
    print("phase 8 stages: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in sv_result.stages.items()}), flush=True)
    print("phase 8 breakdown: " + json.dumps(
        {"wall_s": round(sv_wall, 4), **{
            name: {"calls": t.calls, "s": round(t.seconds, 4)}
            for name, t in sv_timers.items()}}), flush=True)
    print("phase 8 result: " + json.dumps({
        "parameters": [float(v) for v in sv_result.parameters],
        "deviations": [float(v) for v in sv_dev],
        "history_rms": [round(float(h), 6) for h in sv_result.history]}),
        flush=True)
    checks = {
        "kernel launched": sv_launches > 0,
        "launches == backend residual + jacobian calls":
            sv_launches == backend_calls,
        "inversion launches == backend residual + jacobian calls":
            iv_launches == backend_calls,
        "realization and kernel inputs on cuda": sv_on_cuda,
        "15 finite deviations": bool(
            np.all(np.isfinite(sv_dev)) and sv_dev.shape == (15,)),
        "|mean_dev| < 1e-2": abs(sv_mean_dev) < 1e-2,
        "rms19 < 0.25%": rms19 < 0.0025,
        "kernel residuals within 5e-5 of the engine's at p0": sv_gap < 5e-5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 8 failed: {failed}")

    # -- 9: stoch-vol kernel time at the main path's shapes ---------------
    x = sv_kb.params(sv_result.parameters)
    sv_args, sv_kwargs = sv_kb.kernel_arguments(x[None, :])
    sv_fd_args, sv_fd_kwargs = sv_kb.kernel_arguments(
        sv_kb.fd_parameter_sets(x)[0])
    run = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch
    plain = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch_reference
    sv_ms, sv_wrapper_ms = _products_ms(torch, lmm_stochvol_kernel,
                                        run, sv_args, sv_kwargs)
    sv_fd_ms, sv_fd_wrapper_ms = _products_ms(
        torch, lmm_stochvol_kernel, run, sv_fd_args, sv_fd_kwargs)
    sv_plain_ms = _time_ms(torch, lambda: plain(*sv_args, **sv_kwargs))
    sv_fd_plain_ms = _time_ms(torch, lambda: plain(*sv_fd_args,
                                                   **sv_fd_kwargs))
    B_fd = sv_fd_args[1].shape[0]
    sv_ops = dict(num_libors=sv_kwargs["num_libors"],
                  num_factors=sv_kwargs["num_factors"],
                  products=sv_kwargs["products"], paths=SV_PATHS,
                  stoch_vol=True)
    sv_bound_ms, sv_bound_by = _bound(
        sv_args, run(*sv_args, **sv_kwargs), _sweep_operations(B=1, **sv_ops))
    sv_fd_bound_ms, sv_fd_bound_by = _bound(
        sv_fd_args, run(*sv_fd_args, **sv_fd_kwargs),
        _sweep_operations(B=B_fd, **sv_ops))
    print(f"phase 9 timing (median of 5, CUDA events; {smi}): "
          f"paths={SV_PATHS} B=1 "
          f"kernel_ms={sv_ms:.4f} wrapper_ms={sv_wrapper_ms:.4f} "
          f"plain_ms={sv_plain_ms:.4f} bound_ms={sv_bound_ms:.4f} "
          f"({sv_bound_by}); B={B_fd} "
          f"kernel_ms={sv_fd_ms:.4f} wrapper_ms={sv_fd_wrapper_ms:.4f} "
          f"plain_ms={sv_fd_plain_ms:.4f} bound_ms={sv_fd_bound_ms:.4f} "
          f"({sv_fd_bound_by})", flush=True)

    # the Black inversion kernel on the backend's own values at both shapes
    iv_rows = (sv_kb._fwd0, sv_kb._strike, sv_kb._texp, sv_kb._ann0,
               sv_kb._target, sv_kb._weight)
    iv_max_abs_err, iv_timing = 0.0, {}
    for B, (a, kw) in ((1, (sv_args, sv_kwargs)),
                       (B_fd, (sv_fd_args, sv_fd_kwargs))):
        values = sv_kb._values(a, kw)

        def kernel(values=values):
            return black_residuals.black_residuals(values, *iv_rows,
                                                   BLACK_NEWTON_STEPS)

        def plain(values=values):
            return black_residuals.black_residuals_reference(
                values, *iv_rows, BLACK_NEWTON_STEPS)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bitwise = int(torch.eq(got, want).sum())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-12
        iv_max_abs_err = max(iv_max_abs_err, err)
        bound = _bound((values, *iv_rows), got,
                       _black_residuals_operations(got.numel(),
                                                   BLACK_NEWTON_STEPS),
                       PEAK_F64_FLOPS)
        iv_timing[B] = (_launch_ms(torch, kernel), _time_ms(torch, plain),
                        *bound)
        print(f"phase 9 Black inversion kernel vs plain: B={B} "
              f"elements={got.numel()} max_abs_err={err:.3e} "
              f"bitwise_equal={bitwise}/{got.numel()} within 1e-12: {ok}",
              flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: phase 9: the Black inversion "
                             f"kernel disagrees with its plain version at "
                             f"B={B}")
    print(f"phase 9 Black inversion timing (median of 5, CUDA events; "
          f"{smi}): " + "; ".join(
              f"B={B} kernel_ms={k:.4f} plain_ms={pl:.4f} "
              f"bound_ms={bd:.6f} ({by})"
              for B, (k, pl, bd, by) in iv_timing.items()), flush=True)
    iv_ms, iv_plain_ms, iv_bound_ms, iv_bound_by = iv_timing[1]

    # -- 10-14: slice C, the vector engine and Monte-Carlo Black-Scholes ----
    mc_rows = _slice_c(torch, smi)

    # -- 15-17: slice D1, the single-swaption LMM pricers -------------------
    pricer_rows = _slice_d1(torch, smi)

    # -- 18-21: the regression, the Bermudan, AAD greeks, the lazy engine ---
    bermudan_value = _slice_e(torch, smi)

    # -- 22-24: the matched-quality row, f32/f64 parity, engine options ----
    _matched_row(torch, smi, lmm_stochvol_kernel, black_residuals)
    _parity(torch, smi)
    _engine_options(torch, smi, bermudan_value)

    # -- 25-30: the exposure and XVA layer (the collector kernel), the
    # smile layer, the hybrid asset-LMM and the Hull-White slice ------------
    exposure_calls, collect_row = _exposure(torch, smi)
    later = {**exposure_calls, **_smile(torch, smi),
             **_hybrid(torch, smi), **_hull_white(torch, smi)}

    # -- 31-33: slice E2, credit with wrong-way risk, cross-currency and
    # Jarrow-Yildirim inflation (no kernel) ---------------------------------
    later.update({**_credit(torch, smi), **_cross_currency(torch, smi),
                  **_inflation(torch, smi)})

    # -- 34-37: slice E3, the equity core on Black-Scholes (no kernel) -----
    exotic_sim, exotic_calls = _equity_exotics(torch, smi)
    later.update({**exotic_calls, **_multi_asset(torch, smi),
                  **_american_hedging(torch, smi, exotic_sim),
                  **_structured_is_mlmc(torch, smi)})

    # -- 38-41: slice E4, stochastic volatility, jumps, the Gaussian models,
    # Dupire local vol and Heston-SLV (no kernel) ---------------------------
    later.update({**_heston(torch, smi), **_jumps_gaussian(torch, smi),
                  **_local_vol(torch, smi), **_slv(torch, smi)})

    # -- 42-45: slice E5 (portfolio credit, Schwartz-Smith, market risk and
    # SA-CCR capital) and the PDE layer (no kernel) -------------------------
    later.update({**_portfolio_credit(torch, smi), **_commodity(torch, smi),
                  **_market_risk_capital(torch, smi), **_pde(torch, smi)})

    # -- 46: path-axis sharding over torch.distributed (no kernel) ---------
    _path_mesh(torch, smi)
    _path_mesh_f2(torch, smi)

    # -- 48: sharding F3 (Heston-SLV, the remaining equity products), the
    # utilities and examples 01-04 (no kernel) ------------------------------
    _path_mesh_f3(torch, smi)

    # -- 49: examples 05-16 at their default sizes (no kernel) ------------
    _examples_f4(torch, smi)

    if opts.profile:
        _profile(torch, setup, kb, sv, sv_kb, later)

    print(f"chip_smoke seconds: {time.perf_counter() - t_script:.1f}",
          flush=True)
    print(json.dumps({"kernels": [atm_row, {
        "name": "lmm_stochvol_products",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/lmm_stochvol_products.cu",
        "replaces": "finmath_tpu/ops/lmm_stochvol_kernel.py:192",
        "launches": sv_launches,
        "max_abs_err": sv_max_abs_err,
        "ms": sv_ms,
        "plain_ms": sv_plain_ms,
        "bound_ms": sv_bound_ms,
        "bound_by": sv_bound_by,
        "library_ms": None,
    }, {
        "name": "black_residuals",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/black_residuals.cu",
        "replaces": "no Pallas kernel: finmath_tpu/models/lmm/model.py:96 "
                    "black_implied_vol_jnp, fused by XLA",
        "launches": iv_launches,
        "max_abs_err": iv_max_abs_err,
        "ms": iv_ms,
        "plain_ms": iv_plain_ms,
        "bound_ms": iv_bound_ms,
        "bound_by": iv_bound_by,
        "library_ms": None,
    }, collect_row] + mc_rows + pricer_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
