"""Device ms a join spends in the program's ``a2a_exchange`` phase (the
all-to-all of ``parallel/communicator.py``: NCCL between cards), the
slowest rank's, median over the window's joins."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "a2a_exchange", "closed")
