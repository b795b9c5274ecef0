"""join_scans' share of its byte roofline over the traced stretch (the
bytes under ``roofline.KERNELS`` over the card's peak, divided by the
kernel's device time)."""

from joinbench.roofline import share_pct


def read(ctx):
    return share_pct("join_scans", ctx)
