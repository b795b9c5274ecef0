"""dj_tpu_torch's package root against dj_tpu's public surface.

Every public name of ``dj_tpu`` (its root's attributes that are not
submodules, whose set depends on what else was imported) resolves on
``dj_tpu_torch``, except the names of ROADMAP queue 1 items not yet
ported, listed below by item. The list shrinks as items land; a name
that the port gains must leave it.
"""

import types

import dj_tpu
import dj_tpu_torch as tj

NOT_YET_PORTED = {
    # 10: the serving stack and dj_tpu's timing helpers (obs/, utils/timing);
    # warmup_join_index walks the join-index cache (cache/index.py).
    "warmup_join_index": "10",
    "IndexConfig": "10",
    "JoinIndexCache": "10",
    "QueryScheduler": "10",
    "ServeConfig": "10",
    "PhaseTimer": "10",
    "annotate": "10",
    "profile": "10",
    # XLA's flags and compilation cache, unported on purpose
    # (dj_tpu_torch/parallel/bootstrap.py).
    "ensure_async_collectives": "never",
    "setup_compile_cache": "never",
}


def _public(mod) -> set:
    return {n for n in dir(mod)
            if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)}


def test_every_public_name_of_dj_tpu_resolves_on_the_port():
    missing = sorted(_public(dj_tpu) - set(NOT_YET_PORTED) - set(dir(tj)))
    assert missing == []


def test_the_not_yet_ported_list_holds_only_missing_names():
    public = _public(dj_tpu)
    assert set(NOT_YET_PORTED) <= public
    assert sorted(n for n in NOT_YET_PORTED if hasattr(tj, n)) == []


def test_the_port_exports_what_it_lists():
    assert sorted(n for n in tj.__all__ if not hasattr(tj, n)) == []
    assert _public(tj) - {"dtypes", "resilience"} >= set(tj.__all__) - {"dtypes", "resilience"}
    for name in ("shuffle_on", "shuffle_on_auto", "largest_intra_size", "CommunicationGroup",
                 "hash_columns", "murmur3_32", "HASH_MURMUR3", "HASH_IDENTITY",
                 "DEFAULT_HASH_SEED", "shard_table_pieces", "is_distributed_initialized",
                 "Communicator", "BackendError", "AdmissionRejected", "ContractViolation",
                 "FaultInjected", "QueueFull", "distribute_table", "collect_tables"):
        assert name in tj.__all__, name
    assert tj.distribute_table is tj.shard_table and tj.collect_tables is tj.unshard_table
    # The planner's namespace, as dj_tpu exports it (dj_tpu/__init__.py:73).
    assert isinstance(tj.plan_adapt, types.ModuleType)
    assert sorted(set(dj_tpu.plan_adapt.__all__) - set(dir(tj.plan_adapt))) == []
    # The shape grid's namespace (dj_tpu/__init__.py:74).
    assert isinstance(tj.shape_bucket, types.ModuleType)
    assert sorted(set(dj_tpu.shape_bucket.__all__) - set(dir(tj.shape_bucket))) == []
    assert tj.HASH_MURMUR3 == dj_tpu.HASH_MURMUR3 and tj.HASH_IDENTITY == dj_tpu.HASH_IDENTITY
    assert tj.DEFAULT_HASH_SEED == dj_tpu.DEFAULT_HASH_SEED
