"""``phase_ms.untraced`` in a world of cards: device ms of a rank's join
call that none of its phases and spans covers, the slowest rank's,
median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "untraced", "closed")
