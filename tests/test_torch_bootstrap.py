"""dj_tpu_torch's bootstrap: retry with back-off, the settings' order of
precedence, and failing fast on malformed settings (the port's
counterparts of tests/test_bootstrap.py's retry tests). No process is
started: ``torch.distributed.init_process_group`` is replaced by a stub
that records its arguments.
"""

import pytest
import torch

from dj_tpu_torch.parallel import bootstrap
from dj_tpu_torch.resilience.errors import BackendError, DJError

_VARS = ("DJT_COORDINATOR_ADDRESS", "DJT_NUM_PROCESSES", "DJT_PROCESS_ID", "MASTER_ADDR",
         "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "DJT_INIT_RETRIES",
         "DJT_INIT_BACKOFF_S", "DJT_COLLECTIVE_TIMEOUT_S")


@pytest.fixture
def env(monkeypatch):
    """No process-world variable set, and init_process_group recording
    its calls instead of starting a group."""
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)
    calls = []
    monkeypatch.setattr(bootstrap.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(bootstrap, "is_distributed_initialized", lambda: False)
    return calls


def test_retry_backoff_succeeds_after_transient_failures():
    calls = {"n": 0}
    slept = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError(f"coordinator not up (try {calls['n']})")
        return "ready"

    got = bootstrap.retry_backoff(flaky, "test.init", attempts=5, base_delay_s=0.5,
                                  sleep=slept.append)
    assert got == "ready" and calls["n"] == 3
    assert slept == [0.5, 1.0]  # doubling, only before retries


def test_retry_backoff_exhaustion_raises_typed_backend_error():
    slept = []

    def always_down():
        raise ConnectionError("still down")

    with pytest.raises(BackendError) as ei:
        bootstrap.retry_backoff(always_down, "test.init", attempts=3, base_delay_s=0.25,
                                sleep=slept.append)
    assert isinstance(ei.value, DJError)
    assert "failed after 3 attempts" in str(ei.value)
    assert isinstance(ei.value.__cause__, ConnectionError)
    assert len(slept) == 2  # never sleeps after the last attempt


def test_retry_backoff_delay_cap_and_env_defaults(monkeypatch):
    monkeypatch.setenv("DJT_INIT_RETRIES", "4")
    monkeypatch.setenv("DJT_INIT_BACKOFF_S", "8.0")
    slept = []

    def always_down():
        raise OSError("nope")

    with pytest.raises(BackendError, match="failed after 4 attempts"):
        bootstrap.retry_backoff(always_down, "test.init", max_delay_s=10.0, sleep=slept.append)
    assert slept == [8.0, 10.0, 10.0]  # 8, 16 -> cap, 32 -> cap


def test_retry_backoff_defaults_without_env(monkeypatch):
    monkeypatch.delenv("DJT_INIT_RETRIES", raising=False)
    monkeypatch.delenv("DJT_INIT_BACKOFF_S", raising=False)
    slept = []
    with pytest.raises(BackendError, match="failed after 5 attempts"):
        bootstrap.retry_backoff(lambda: 1 / 0, "test.init", sleep=slept.append)
    assert slept == [1.0, 2.0, 4.0, 8.0]


def test_init_distributed_without_a_coordinator_is_a_no_op(env):
    assert bootstrap.init_distributed() is False
    assert env == []
    assert bootstrap.process_index() == 0 and bootstrap.process_count() == 1


def test_init_distributed_reads_djt_vars_before_torchrun_vars(env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "otherhost")
    monkeypatch.setenv("MASTER_PORT", "1111")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "7")
    monkeypatch.setenv("DJT_COORDINATOR_ADDRESS", "localhost:2222")
    monkeypatch.setenv("DJT_NUM_PROCESSES", "4")
    monkeypatch.setenv("DJT_PROCESS_ID", "3")
    monkeypatch.setenv("DJT_COLLECTIVE_TIMEOUT_S", "42")
    assert bootstrap.init_distributed(device="cpu") is True
    (backend, kw), = env
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://localhost:2222", 4, 3)
    assert kw["timeout"].total_seconds() == 42


def test_init_distributed_arguments_win_and_torchrun_vars_fill_in(env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert bootstrap.init_distributed(backend="gloo") is True
    assert env[-1][1]["init_method"] == "tcp://10.0.0.1:29500"
    assert (env[-1][1]["world_size"], env[-1][1]["rank"]) == (2, 1)
    bootstrap.init_distributed("file:///srv/djt_store", 3, 0, backend="gloo")
    backend, kw = env[-1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("file:///srv/djt_store", 3, 0)
    assert kw["timeout"].total_seconds() == bootstrap.DEFAULT_TIMEOUT_S


def test_malformed_process_count_fails_without_a_retry(env, monkeypatch):
    monkeypatch.setenv("DJT_COORDINATOR_ADDRESS", "localhost:2222")
    monkeypatch.setenv("DJT_NUM_PROCESSES", "four")
    monkeypatch.setenv("DJT_PROCESS_ID", "0")
    slept = []
    monkeypatch.setattr(bootstrap.time, "sleep", slept.append)
    with pytest.raises(ValueError, match="four"):
        bootstrap.init_distributed(device="cpu")
    assert env == [] and slept == []
    monkeypatch.setenv("DJT_NUM_PROCESSES", "2")
    monkeypatch.setenv("DJT_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        bootstrap.init_distributed(device="cpu")
    assert env == []


def test_init_distributed_retries_then_raises_backend_error(env, monkeypatch):
    monkeypatch.setenv("DJT_INIT_RETRIES", "3")
    monkeypatch.setenv("DJT_INIT_BACKOFF_S", "0.5")
    slept = []
    monkeypatch.setattr(bootstrap.time, "sleep", slept.append)
    tries = []

    def refuse(backend, **kw):
        tries.append(backend)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(bootstrap.dist, "init_process_group", refuse)
    with pytest.raises(BackendError, match="failed after 3 attempts") as ei:
        bootstrap.init_distributed("localhost:1", 2, 0, device="cpu")
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert tries == ["gloo"] * 3 and slept == [0.5, 1.0]


def test_the_backend_is_nccl_on_a_card_and_gloo_only_when_asked():
    assert bootstrap._backend(None, "cpu") == "gloo"
    assert bootstrap._backend("gloo", None) == "gloo"
    if torch.cuda.is_available():
        assert bootstrap._backend(None, None) == "nccl"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bootstrap._backend(None, None)
