"""One decision for a process world: the host layers' object collectives.

dj_tpu runs one controller process; a process world of the port runs one
process a rank, and each takes the host layers' decisions (the join-index
cache's hit and admission, the autotuner's step, the scheduler's door, its
deadlines and its dispatch groups) on its own. A decision taken apart
would issue different collectives. These helpers take it once: every
process's view gathered in rank order, or process 0's on every process,
over the default ``torch.distributed`` group. Python objects only; each
call is one object collective, so every process must make it, in the same
order and on one thread.
"""

from __future__ import annotations

__all__ = ["dist_world", "from_rank0", "gather", "multi_process"]


def multi_process(topology) -> bool:
    """``topology`` is a process world of more than one process."""
    return (topology is not None and topology.is_process_world
            and topology.process_count > 1)


def dist_world() -> bool:
    """A ``torch.distributed`` world of more than one process is live."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def gather(obj) -> list:
    """Every process's ``obj``, in rank order, over the default group."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def from_rank0(obj):
    """Process 0's ``obj`` on every process of the default group."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
