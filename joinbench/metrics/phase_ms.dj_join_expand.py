"""Device ms a join spends in its local join's expansion (the program's
span ``dj_join/expand``: join_scans and the duplicate expansion), the
slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/expand", "closed")
