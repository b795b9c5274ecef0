"""``phase_ms.dj_join`` in a world of cards: device ms a join spends in
the program's ``dj_join`` phase, the slowest rank's, median over the
window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join", "closed")
