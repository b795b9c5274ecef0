"""Device ms of a join call that no phase or span of the program covers
(the record's ``untraced``: the root span ``dj_call`` less the union of
everything inside it), median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "untraced", "closed")
