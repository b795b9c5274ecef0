"""Device ms a join spends in the key-range probe before its ranks (the
program's span ``dj_range_probe``: the masked min and max of each key
column and their host reads), median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_range_probe", "closed")
