"""Work of one single-swaption pricer launch (``csrc/lmm_swaption_paths.cu``,
the kernels that draw their own normals), counted from the shapes: a
frozen copy of ``chip_smoke.py``'s ``_pricer_operations`` and
``DRAW_OPERATIONS``. It counts what these inputs need, whatever
implements them."""

#: one draw of four normals: Philox4x32-10's 10 rounds of two 32-bit
#: multiply-highs, two multiply-lows and four XORs (80), and two
#: Box-Muller pairs at about 37 float operations a normal (148)
DRAW_OPERATIONS = 80 + 148


def operations(num_factors, steps, exercise, periods, paths, *, stoch_vol):
    """Each add, multiply, divide and compare counted once: per step and
    alive libor below the swap's end and the last fixing the 1-factor
    update (9) or the stoch-vol one (12 + 7 a factor); per step the scaled
    normals (F) and the numeraire (3), and for stoch vol sqrt(V) (about
    8), the V step (8) and its expf (about 20); per path the payoff (6 a
    period and 5), the stoch-vol constants (4) and the draws (a draw of
    four normals a path for every four normals a path uses)."""
    F, S = num_factors, steps
    swept = max(exercise + periods, S)
    alive = sum(swept - 1 - s for s in range(S))
    if stoch_vol:
        per_libor, per_step, per_path = 12 + 7 * F, F + 3 + 8 + 8 + 20, 4
    else:
        per_libor, per_step, per_path = 9, F + 3, 0
    rows = S * (F + 1) if stoch_vol else S
    draws = -(-rows // 4)
    return (alive * per_libor + S * per_step + per_path + 6 * periods + 5
            + draws * DRAW_OPERATIONS) * paths


def bytes_moved(num_libors, num_factors, steps, paths, *, stoch_vol):
    """The payoffs ``[paths]`` float32 written once and the staged table
    read once: per libor its curve columns (2, or 4 with stoch vol) and the
    loadings ``[S, F, n]`` float32."""
    cols = 4 if stoch_vol else 2
    return 4 * paths + 4 * num_libors * (cols + num_factors * steps)
