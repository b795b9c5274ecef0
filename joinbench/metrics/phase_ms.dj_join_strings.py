"""Device ms a join spends gathering its string output columns (the
program's span ``dj_join/strings``: the offsets' scan and the char
gather), the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/strings", "closed")
