"""Device ms a join spends in the unpacked merged sort's per-column passes
(the program's span ``dj_join/lex_sort``: for each key column, last
first, the gather of its image through the permutation, the stable sort
and the permutation's gather), the slowest rank's, median over the
window's joins. A join whose keys pack into one word records none."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/lex_sort", "closed")
