"""Device ms a join spends turning the unpacked sort's order into the
words the scans read (the program's span ``dj_join/run_ids``: the run
boundaries over every key column, their cumsum and the re-pack of run id
and row), the slowest rank's, median over the window's joins. A join
whose keys pack into one word records none."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join/run_ids", "closed")
