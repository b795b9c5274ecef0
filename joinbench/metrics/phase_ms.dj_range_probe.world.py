"""``phase_ms.dj_range_probe`` in a world of cards: device ms of the
key-range probe before the ranks, its gather of every process's ranges
included, the slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_range_probe", "closed")
