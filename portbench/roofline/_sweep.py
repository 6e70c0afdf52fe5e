"""Work of one LMM products sweep (``lmm_atm_products`` and
``lmm_stochvol_products``), counted from the shapes: a frozen copy of
``chip_smoke.py``'s ``_sweep_operations``, an FMA counted as two. It
counts what these inputs need, whatever implements them."""


def operations(num_libors, num_factors, products, paths, B, *,
               stoch_vol, displaced=False):
    """Float32 operations: per step and alive libor the drift term (3),
    the update and clamp (5) and per factor the loading and three running
    sums (6, +1 with a local factor); the local factor itself (displaced
    1, blended times sqrt(V) 4); per step the normals' scaling, the
    numeraire (3) and for stoch vol exp(log V / 2) and the log V step
    (10); per exercise step the running bond product (6 a period) and per
    product the payoff, its masking and its path sum (7), plus the ATM
    kernel's numeraire-adjustment row (2)."""
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


def bytes_moved(num_libors, num_factors, products, paths, B, *, stoch_vol):
    """Each input read once, the sums written once: the increments ``[S,
    F (+1), paths]`` float32, the loadings ``[B, F n, S]`` and scalars
    ``[B, 8]`` float32, the curve and accruals, and ``[B, rows]`` float64
    sums (a row per product, and per exercise date without stoch vol)."""
    n, F = num_libors, num_factors
    S = products[-1][0]
    rows = len(products) + (0 if stoch_vol else len({e for e, _, _ in
                                                     products}))
    return (4 * S * (F + int(stoch_vol)) * paths + 4 * B * (F * n * S + 8)
            + 8 * n + 8 * B * rows)
