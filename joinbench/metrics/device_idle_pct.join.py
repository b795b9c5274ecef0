"""The share of the traced stretch of joins in which the device ran no
operation other than a collective's, averaged over the ranks. An NCCL
kernel counts as idle: it spins on the card while its rank waits for a
peer, so a rank that waits, or an exchange that no work overlaps, shows
here (the one-card cells launch none)."""

from joinbench.readers import idle_pct


def read(ctx):
    profiles = ctx.get("profiles") or []
    if ctx.get("loop") != "closed" or not profiles:
        return None
    return idle_pct(sum(p["busy_ex_collective_s"] for p in profiles),
                    sum(p["window_s"] for p in profiles))
