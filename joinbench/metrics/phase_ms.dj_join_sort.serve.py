"""Device ms a served query spends in its merged sort (the span
``dj_join/sort``: the sort tier sorts the resident side's words with the
probe's), median over the queries of the traced stretch under the phase
clock."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/sort", "open")
