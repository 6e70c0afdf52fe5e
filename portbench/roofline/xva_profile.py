"""Work of one exposure profile of a netting set on the stochastic-vol LMM,
counted from the shapes: the least a profile's inputs need, whatever
implements them. Four parts, each timed at the larger of its operations
over the peak of their precision and its bytes over the memory rate,
summed:

* the simulation: per step and live forward the stoch-vol Euler update
  (12 + 7 a factor operations, as ``_pricer.operations``), per step the
  scaled normals, the numeraire, sqrt(V) and the V step (F + 39), in the
  path precision; the state read and written once a step (the live
  forwards in the path precision, V and the numeraire float64) and the
  increments, in the path precision, read once;
* the collections: per date the annuity products ``[trades alive, n - e]
  @ [n - e, paths]`` in the path precision (an FMA two operations) and
  the float64 curve (3 a live forward); the date's outputs written once:
  the netted value, the standalone sum and 1/N float64, each
  underlying's value float64 and par rate in the path precision;
* the regressions: per fit the float64 Gram and right-hand side of the
  basis (1, s, s^2) and the prediction (B^2 + 2B FMAs a path); the
  feature read in the path precision, the target read and the
  prediction written in float64;
* the sort of the residual exposure ``[dates, paths]`` float64, read and
  written once.

The path precision is ``shape["path_bytes"]`` (4: float32, 8: float64).
Float64 work is counted against the card's float64 peak, kept here
(``peaks.json`` holds the float32 one)."""

#: NVIDIA H100 SXM, float64 on the tensor cores (the data sheet's 67
#: TFLOP/s; the vector units give half)
FLOAT64_FLOPS = 67e12
BASIS = 3


def regressions(shape: dict) -> int:
    """Fits a profile needs: a European swaption's close-out value at each
    date before its expiry; a Bermudan's backward induction (one fit an
    exercise date but the last) and its close-out value at each date
    before its last exercise date that is not an exercise date."""
    dates = shape["dates"]
    count = sum(sum(1 for e in dates if e < x) for x in shape["europeans"])
    for xs in shape["bermudans"]:
        count += len(xs) - 1
        count += sum(1 for e in dates if e < xs[-1] and e not in xs)
    return count


def parts(shape: dict) -> dict:
    """``{part: (float32 operations, float64 operations, bytes)}`` of one
    profile."""
    n, F, P = shape["num_libors"], shape["num_factors"], shape["paths"]
    dates = shape["dates"]
    K = len(shape["underlyings"])
    w = int(shape.get("path_bytes", 4))

    def split(path_ops, f64_ops):
        """(float32, float64) operations: the path precision's go to its
        own peak."""
        return ((path_ops, f64_ops) if w == 4
                else (0, path_ops + f64_ops))
    ops, byt = 0, 0
    for s in range(max(dates)):
        live = n - (s + 1)
        ops += live * (12 + 7 * F) + F + 39
        byt += 2 * w * live + w * (F + 1) + 32
    sim = split(ops * P, 0) + (byt * P,)
    ops_p, ops64, byt = 0, 0, 0
    for e in dates:
        alive = sum(1 for a, b in shape["swaps"] + shape["underlyings"]
                    if e < b)
        ops_p += 2 * alive * (n - e)
        ops64 += 3 * (n - e)
        byt += 24 + (8 + w) * K
    collect = split(ops_p * P, ops64 * P) + (byt * P,)
    fits = regressions(shape)
    regress = (0, 2 * (BASIS * BASIS + 2 * BASIS) * fits * P,
               (w + 8 + 8) * fits * P)
    sort = (0, 0, 16 * len(dates) * P)
    return {"simulate": sim, "collect": collect, "regress": regress,
            "sort": sort}


def least_seconds(shape: dict, peaks: dict) -> float:
    """The least time of one profile on the card."""
    return sum(max(o32 / peaks["float32_flops"] + o64 / FLOAT64_FLOPS,
                   b / peaks["bytes_per_s"])
               for o32, o64, b in parts(shape).values())
