"""Device ms a join spends in the program's ``dj_partition`` phase (the
murmur3 hash partition of ``ops/partition.py`` and ``ops/hashing.py``),
the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_partition", "closed")
