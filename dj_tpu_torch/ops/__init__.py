"""The join's device operations, each hand-written kernel behind a
wrapper that counts its launches.

A wrapper adds one to its module's counter where it launches its kernel,
and nowhere else (its plain CPU version counts nothing).
:func:`kernel_launches` reads every counter by kernel name, and
:func:`reset_kernel_launches` sets them all to 0.
"""

import importlib

# Each kernel's launch counter: (module of this package, attribute).
KERNEL_COUNTERS = {
    "join_scans": ("scan", "launches"),
    "merge_sorted_u64": ("merge", "launches"),
    "expand_values": ("expand", "launches"),
    "expand_ranks": ("expand", "ranks_launches"),
    "expand_gather": ("expand", "gather_launches"),
    "expand_join": ("expand", "join_launches"),
    "expand_carry": ("expand", "carry_launches"),
    "expand_vfull": ("expand", "vfull_launches"),
    "string_gather": ("strings", "launches"),
    "partition_ids": ("partition", "launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def kernel_launches() -> dict:
    """{kernel name: launches since its counter was last set to 0}."""
    return {k: getattr(_module(m), a) for k, (m, a) in KERNEL_COUNTERS.items()}


def reset_kernel_launches() -> None:
    """Set every kernel's launch counter to 0."""
    for m, a in KERNEL_COUNTERS.values():
        setattr(_module(m), a, 0)
