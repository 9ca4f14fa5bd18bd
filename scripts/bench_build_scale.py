"""Out-of-core DB build bench: the spill path at representative scale.

Generates synthetic genomes totalling BUILD_BENCH_MB megabases (~1
occurrence per base at k=31), builds the database with a
BUILD_BENCH_RAM_MB host budget for raw occurrences (16 B each; budgets
below total_bases*16 force the _SpillStore disk path), and reports
wall time + peak RSS — the scale probe for the external-sort answer to
the reference's 146 GB in-RAM mother table (README.md:93-94).

Adjacent genomes share a 5% splice so the discriminative filter (and
the multi-label run sweep) does real work.

Run from the repository root:
  PYTHONPATH=. BUILD_BENCH_MB=320 python scripts/bench_build_scale.py
"""

import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def _reset_peak_rss() -> None:
    """Clear the process's RSS high-water mark (Linux): ru_maxrss is
    INHERITED across fork+exec, so a subprocess launched from a parent
    that once held tens of GB would report the parent's peak."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def _peak_rss_gb() -> float:
    """Current peak RSS: VmHWM (respects _reset_peak_rss) with an
    ru_maxrss fallback."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def run(total_mb: int, ram_mb: int, k: int = 31, targets: int = 16,
        workdir=None):
    from cuclark_tpu.config import DBConfig
    from cuclark_tpu.db_build.builder import build_db

    _reset_peak_rss()

    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    per = int(total_mb * 1e6 / targets)
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        file_labels = []
        prev = None
        gen_t0 = time.time()
        for t in range(targets):
            seq = base[rng.integers(0, 4, size=per)]
            if prev is not None:  # 5% splice shared with the neighbor
                seq[: per // 20] = prev[: per // 20]
            p = Path(td) / f"g{t}.fa"
            with open(p, "wb") as f:
                f.write(b">g%d\n" % t)
                f.write(seq.tobytes())
                f.write(b"\n")
            file_labels.append((str(p), f"T{t + 1}", None))
            prev = seq
        gen_s = time.time() - gen_t0

        cfg = DBConfig(k=k, build_ram_mb=ram_mb)
        t0 = time.time()
        db = build_db(file_labels, cfg)
        build_s = time.time() - t0
    rss_gb = _peak_rss_gb()
    occ = total_mb * 1e6 - targets * (k - 1)
    table_gb = db.table.nbytes / 1e9
    return {
        "occurrences_m": round(occ / 1e6, 1),
        "ram_budget_mb": ram_mb,
        "spilled": occ * 16 > ram_mb * 1e6,
        "build_s": round(build_s, 1),
        "occ_per_sec_m": round(occ / build_s / 1e6, 1),
        "peak_rss_gb": round(rss_gb, 2),
        # honesty target (VERDICT r03 item 6): peak RSS vs
        # 2 x (occurrence budget + final table)
        "rss_target_gb": round(2 * (ram_mb / 1e3 + table_gb), 2),
        # full-RefSeq projection: ~596M raw occurrences (reference
        # README.md:93-94 scale) at this run's measured rate
        "projected_refseq_s": round(596e6 * build_s / occ, 1),
        "db_kmers": int(db.num_kmers),
        "table_mb": round(db.table.nbytes / 1e6, 1),
        "gen_s": round(gen_s, 1),
    }


def run_subprocess(total_mb: int, ram_mb: int):
    """Run the probe in a FRESH process so ru_maxrss reflects only the
    build (an in-process call from bench.py would report the whole
    bench's historic peak, burying the number it claims to measure)."""
    import subprocess

    env = dict(os.environ)
    env["BUILD_BENCH_MB"] = str(total_mb)
    env["BUILD_BENCH_RAM_MB"] = str(ram_mb)
    repo = str(Path(__file__).resolve().parent.parent)
    extra = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + extra)
    # host-only work: the child never opens the card (the parent may
    # hold it, and a second JAX process on a card fails for memory)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve())],
        env=env, capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        return {"error": out.stderr[-500:]}
    return json.loads(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    total_mb = int(os.environ.get("BUILD_BENCH_MB", 320))
    ram_mb = int(os.environ.get("BUILD_BENCH_RAM_MB", 4096))
    out = run(total_mb, ram_mb)
    print(json.dumps(out), flush=True)
    sys.exit(0)
