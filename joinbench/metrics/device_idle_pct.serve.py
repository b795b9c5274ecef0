"""The share of the time in which a served query ran (dispatch to its
answer, inside the profiled stretch, where the program's phase clock is
off) that the device ran no operation."""

from joinbench.readers import idle_pct


def read(ctx):
    if ctx.get("loop") != "open" or not ctx.get("query_cover"):
        return None
    return idle_pct(*ctx["query_cover"])
