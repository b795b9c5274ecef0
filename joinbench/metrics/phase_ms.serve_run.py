"""Device ms of a served query's run, from its dispatch to the end of its
work on the card (the scheduler's span ``serve_run``), median over the
queries of the traced stretch under the phase clock."""

from joinbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "serve_run", "open")
