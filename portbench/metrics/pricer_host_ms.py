"""Per price, the wall of the pricer entry point (to the host value) over
the measured window, less the device time of its kernel's launch in the
traced window: what the entry point costs around the kernel."""


def read(ctx):
    calls = ctx.spans.calls.get("pricer")
    if ctx.kind != "price" or not calls:
        return None
    kernel = ctx.shape["kernel"]
    spec = ctx.load_module(ctx.bench / "roofline" / f"{kernel}.py")
    launches, seconds = ctx.trace.kernel_seconds(spec.PATTERN)
    if not launches or launches != ctx.traced.calls.get("pricer"):
        return None
    return 1e3 * (ctx.spans.seconds["pricer"] / calls - seconds / launches)
