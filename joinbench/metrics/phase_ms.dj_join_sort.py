"""Device ms a join spends in its local join's merged sort (the program's
span ``dj_join/sort``: the packed words' sort, the carry sort or the
unpacked one), the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/sort", "closed")
