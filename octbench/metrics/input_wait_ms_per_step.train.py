"""Host time a step waits for its batch from ``prefetch_to_device``
(rank 0), over the window's steps."""


def read(ctx):
    if not ctx["steps"] or "input wait" not in ctx["spans"]:
        return None
    return 1e3 * ctx["spans"]["input wait"] / ctx["steps"]
