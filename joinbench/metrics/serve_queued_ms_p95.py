"""The 95th percentile of the ms a served query waited in the
scheduler's queue (its ticket's submit to its dispatch), over the
queries due before the traced stretches began: a host time on the
ticket, which needs no trace, read where nothing traced slows the
dispatcher."""

from joinbench.readers import percentile


def read(ctx):
    q = ctx.get("queued_s") or []
    return 1e3 * percentile(q, 0.95) if q else None
