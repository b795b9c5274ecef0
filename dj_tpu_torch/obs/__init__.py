"""dj_tpu_torch.obs: the host-side models the skew-adaptive planner reads.

Counterpart of the two pieces of ``dj_tpu/obs/`` that
``parallel.plan_adapt`` consumes: ``skew.batch_skew`` (the per-batch
destination skew of a partition-count matrix) and
``bytemodel.buffer_bytes`` / ``replicated_table_bytes`` (the broadcast
tier's fit input). Host-only: numpy and tensor shapes, no device work.
dj_tpu's metrics registry, flight recorder, roofline phases and skew
observatory have no counterpart here yet.
"""

from . import bytemodel, skew

__all__ = ["bytemodel", "skew"]
