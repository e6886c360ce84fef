"""Share of the rows copied to rank 0's card that its step trains on:
the program's ``input.rows_used`` over ``input.rows_copied`` in the
traced window."""

from octbench.program_trace import counter


def read(ctx):
    used, copied = (counter(ctx, "input.rows_used"),
                    counter(ctx, "input.rows_copied"))
    if used is None or not copied:
        return None
    return 100.0 * used / copied
