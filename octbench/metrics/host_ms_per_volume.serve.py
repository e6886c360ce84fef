"""What a volume's latency holds besides its forward: the mean over the
window's volumes of the latency less the forward's event time (the copy
in, the labels out, and dispatch)."""


def read(ctx):
    fwd = ctx.get("forward_ms")
    if not fwd:
        return None
    lat = ctx["latency_s"]
    return sum(1e3 * t - f for t, f in zip(lat, fwd)) / len(fwd)
