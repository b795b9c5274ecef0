"""Device ms a join spends in the program's ``dj_join`` phase (the local
join of ``ops/join.py``: sort, join_scans, expansion, gathers, strings),
the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join", "closed")
