"""Device ms a join spends gathering its fixed-width output columns (the
program's span ``dj_join/take``: the gathers and fills of the matched
rows), the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/take", "closed")
