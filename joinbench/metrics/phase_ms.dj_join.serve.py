"""Device ms a served query spends in the program's ``dj_join`` phase
(the prepared query's probe work in ``ops/join.py``), median over the
queries of the traced stretch under the phase clock."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dj_join", "open")
