"""Automatic device-memory planning (cuclark_tpu.memplan) — the analog
of the reference's free-VRAM probe + RESERVED + swap-cycle planning
(src/CuClarkDB.cu:540-574, :171-175, src/parameters.hh:45)."""

import numpy as np
import pytest

from cuclark_tpu import codec, memplan
from cuclark_tpu.config import ClassifyConfig, DBConfig
from cuclark_tpu.hashdb import build_table
from cuclark_tpu.memplan import (RESERVED_MB, device_memory_budget_mb,
                                 plan_db_axis, plan_stream_parts,
                                 resolve_table_budget_mb)


class FakeDev:
    def __init__(self, platform="gpu", stats=None, raise_stats=False,
                 device_kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = device_kind
        self._stats = stats
        self._raise = raise_stats

    def memory_stats(self):
        if self._raise:
            raise RuntimeError("unsupported")
        return self._stats


def test_budget_from_memory_stats():
    dev = FakeDev(stats={"bytes_limit": 2_000_000_000,
                         "bytes_in_use": 500_000_000})
    got = device_memory_budget_mb(dev)
    assert got == pytest.approx((2e9 - 5e8) / 1e6 - RESERVED_MB)


def test_budget_prefers_reservable_limit():
    # bytes_reservable_limit excludes runtime-reserved regions and wins
    # over the raw bytes_limit when both are reported
    dev = FakeDev(stats={"bytes_limit": 2_000_000_000,
                         "bytes_reservable_limit": 1_500_000_000,
                         "bytes_in_use": 0})
    got = device_memory_budget_mb(dev)
    assert got == pytest.approx(1.5e9 / 1e6 - RESERVED_MB)


# JAX's preallocated pool on an 80 GB card: 75% of it
_POOL = 63_350_000_000


@pytest.mark.parametrize("dev,env_mb,want", [
    # pool limit with arrays already resident
    (FakeDev(stats={"bytes_limit": _POOL, "bytes_in_use": 9_000_000_000,
                    "peak_bytes_in_use": 9_500_000_000}),
     None, (_POOL - 9e9) / 1e6 - RESERVED_MB),
    # no bytes_in_use reported: the whole pool is free
    (FakeDev(stats={"bytes_limit": _POOL}), None, _POOL / 1e6 - RESERVED_MB),
    # no bytes_reservable_limit: bytes_limit is the pool
    (FakeDev(stats={"bytes_limit": _POOL, "bytes_in_use": 0,
                    "largest_alloc_size": 0, "num_allocs": 0}),
     None, _POOL / 1e6 - RESERVED_MB),
    # a nearly full pool bottoms out at the 64 MB floor
    (FakeDev(stats={"bytes_limit": _POOL, "bytes_in_use": _POOL}),
     None, 64.0),
    # the operator override wins over the device
    (FakeDev(stats={"bytes_limit": _POOL}), "1234", 1234.0),
    (FakeDev(raise_stats=True), "777", 777.0),
    # host memory: unbounded
    (FakeDev(platform="cpu", device_kind="cpu"), None, None),
], ids=["in_use", "no_in_use", "no_reservable", "floor", "env_override",
        "env_override_no_stats", "cpu"])
def test_budget_gpu_shaped_devices(monkeypatch, dev, env_mb, want):
    if env_mb is None:
        monkeypatch.delenv("CUCLARK_DEVICE_MB", raising=False)
    else:
        monkeypatch.setenv("CUCLARK_DEVICE_MB", env_mb)
    got = device_memory_budget_mb(dev)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("dev", [
    FakeDev(stats={}),
    FakeDev(stats=None),
    FakeDev(stats={"bytes_in_use": 0}),
    FakeDev(raise_stats=True),
], ids=["empty", "none", "no_limit", "raising"])
def test_budget_gpu_without_stats_raises(monkeypatch, dev):
    """A non-CPU device that cannot say how much memory it has is an
    error, never a guessed size."""
    monkeypatch.delenv("CUCLARK_DEVICE_MB", raising=False)
    with pytest.raises(RuntimeError):
        device_memory_budget_mb(dev)


def test_budget_cpu_is_unbounded():
    assert device_memory_budget_mb(FakeDev(platform="cpu")) is None


def test_budget_floor():
    dev = FakeDev(stats={"bytes_limit": 100_000_000, "bytes_in_use": 0})
    assert device_memory_budget_mb(dev) == 64.0


def test_explicit_flag_wins():
    assert resolve_table_budget_mb(123.0, FakeDev()) == 123.0


def test_plan_stream_parts():
    # 1 GB table, 100 MB budget, no mesh: 16 parts of 64 MB fit
    assert plan_stream_parts(10 ** 9, 100.0, 1, 1 << 20) == 16
    # split 4 ways across a mesh first: 4 parts of 62.5 MB
    assert plan_stream_parts(10 ** 9, 100.0, 4, 1 << 20) == 4
    assert plan_stream_parts(10 ** 9, None, 1, 1 << 20) == 1
    assert plan_stream_parts(10 ** 6, 100.0, 1, 1 << 20) == 1


def test_plan_db_axis():
    assert plan_db_axis(10 ** 9, 100.0, 8) == 8  # capped at devices
    assert plan_db_axis(10 ** 9, 300.0, 8) == 4
    assert plan_db_axis(10 ** 9, None, 8) == 1
    assert plan_db_axis(10 ** 6, 100.0, 8) == 1


@pytest.fixture()
def small_db():
    rng = np.random.default_rng(3)
    km = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=30_000, dtype=np.uint64), 31))
    labels = rng.integers(1, 17, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 17)]
    return build_table(km, labels, names, DBConfig(k=31))


def test_auto_budget_streams_oversized_table(monkeypatch, small_db):
    """A table larger than the (simulated) device budget streams with NO
    --max-table-mb flag and classifies identically to resident mode."""
    from cuclark_tpu.pipeline import Classifier

    rng = np.random.default_rng(4)
    base = np.frombuffer(b"ACGT", np.uint8)
    reads = [(f"r{i}", base[rng.integers(0, 4, size=100)].tobytes())
             for i in range(64)]

    resident = Classifier(small_db, ClassifyConfig(batch_reads=32))
    assert resident.stream_parts == 1
    want = [r["best"] for r in resident.classify_records(iter(reads))]

    # simulate a device whose budget holds only ~1/4 of the table
    tiny = small_db.table.nbytes / 4 / 1e6
    monkeypatch.setattr(memplan, "device_memory_budget_mb",
                        lambda device=None: tiny)
    auto = Classifier(small_db, ClassifyConfig(batch_reads=32))
    assert auto.stream_parts >= 4
    got = [r["best"] for r in auto.classify_records(iter(reads))]
    assert got == want
