"""``join_scans_roofline`` in a world of cards: the kernel's share of
its byte roofline over the traced stretch, from every rank's bytes and
device time."""

from joinbench.roofline import share_pct


def read(ctx):
    return share_pct("join_scans", ctx)
