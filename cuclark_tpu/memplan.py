"""Automatic device-memory planning for the DB table.

The reference probes each device's free VRAM, reserves RESERVED MB for
batch buffers, aborts below 1 GB free, and derives its swap-cycle plan
`cyclesPerDevice x numDevices x dbPartsPerDevice` from what remains
(src/CuClarkDB.cu:540-574 planning, :171-175 abort guard,
src/parameters.hh:45 RESERVED).  Here the runtime
(`device.memory_stats()`) says how much of JAX's device memory pool is
free; a reserve for batch arrays + XLA temporaries comes off, and the
result feeds the same two levers the pipeline already has:

  - db-axis width on a mesh (bucket ranges resident across cards), and
  - stream_parts (host->device bucket-range streaming, the swap-cycle
    analog) when even the per-device shard exceeds the budget.

An explicit --max-table-mb always wins; this module only fills in the
default so an oversized table streams instead of dying mid-classify
with a raw XLA OOM.
"""

from __future__ import annotations

# Reserve for batch buffers, results, and XLA scratch — the role of the
# reference's RESERVED = 300-400 MB per device (src/parameters.hh:45).
# Measured on an H100 (80GB HBM3): a resident 8.6 GB table classifying
# 65,536-read x 152-base batches peaked 182 MB above the table; scaled
# to a MAX_BATCH_CELLS batch (3.37x the cells) that is 612 MB.
RESERVED_MB = 640.0


def device_memory_budget_mb(device=None) -> float | None:
    """Usable MB for the resident DB table on one device.

    None means "unbounded / host memory" (CPU): keep the table
    resident.  A GPU reports JAX's preallocated memory pool as
    `bytes_limit` in `memory_stats()` (a reported
    `bytes_reservable_limit` is preferred: it excludes runtime-reserved
    regions); the budget is what the pool has free minus RESERVED_MB.
    A non-CPU device that reports no usable stats raises: guessing its
    size would either waste the card or run out of memory mid-run."""
    import os

    import jax

    override = os.environ.get("CUCLARK_DEVICE_MB")
    if override:  # operator override / test hook
        return float(override)
    if device is None:
        devs = jax.local_devices()
        if not devs:
            return None
        device = devs[0]
    platform = getattr(device, "platform", "cpu")
    if platform == "cpu":
        return None
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_reservable_limit") or stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{platform} device {getattr(device, 'device_kind', '?')!r} "
            f"reports no memory limit (memory_stats: {sorted(stats)}); "
            f"pass --max-table-mb or set CUCLARK_DEVICE_MB")
    in_use = stats.get("bytes_in_use", 0)
    return max((limit - in_use) / 1e6 - RESERVED_MB, 64.0)


def resolve_table_budget_mb(max_table_mb: float | None,
                            device=None) -> float | None:
    """Effective per-device table budget: the explicit flag if given,
    else the measured device budget (None = unbounded)."""
    if max_table_mb is not None:
        return max_table_mb
    return device_memory_budget_mb(device)


def plan_stream_parts(table_bytes: int, budget_mb: float | None,
                      num_db: int, nb: int) -> int:
    """Power-of-two host-streaming parts needed so each uploaded
    bucket-range part (already split num_db ways across the mesh) fits
    the per-device budget.  1 = fully resident."""
    parts = 1
    if budget_mb is None:
        return parts
    budget = budget_mb * 1e6
    while (table_bytes / num_db / parts > budget
           and parts * num_db < nb):
        parts *= 2
    return parts


def plan_db_axis(table_bytes: int, budget_mb: float | None,
                 max_devices: int) -> int:
    """Power-of-two db-axis width so each device's resident shard fits
    the budget (capped at the device count; streaming picks up the
    remainder)."""
    num_db = 1
    if budget_mb is None:
        return num_db
    budget = budget_mb * 1e6
    while table_bytes / num_db > budget and num_db * 2 <= max_devices:
        num_db *= 2
    return num_db
