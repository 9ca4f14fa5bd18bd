#!/usr/bin/env python3
"""Smoke test of the classify path on the GPU, driven through the CLI.

Run from a checkout on a machine with one NVIDIA GPU:

    python chip_smoke.py                 # phases A, B and C on one card
    python chip_smoke.py --four-cards    # only the `classify -d 4` path

Phases:

  A  device: JAX's default backend must be the GPU and the native host
     module must be built; prints the card's name and power limit, the
     device kind, the JAX version and the compile-cache directory.
  B  parity, small: seeded genomes, a full (k=31) and a light (k=27,
     gap 4) database, each classified single-end, paired (-P),
     --extended and streamed (a --max-table-mb that forces >= 4
     bucket-range parts).  Every CSV must equal, byte for byte, the
     pure-Python oracle (tests/oracle.py) and the same CLI call run in
     a child process pinned to JAX's CPU backend.
  C  scale, one card, resident: >= 256M target-specific k-mers (4,096
     targets x 64 kbp) built by `build-db`, an 8.6 GB table resident
     on the card, 1,048,576 simulated 150 bp reads classified and
     scored by `evaluate`; the first 65,536 rows must equal the CPU
     child's.  Prints build, upload, compile and throughput figures:
     smoke figures, not a benchmark.

--four-cards builds the phase-C database and reads, classifies them on
one card, then with `-d 4` twice (the default data=4 x db=1 plan, and a
--max-table-mb that splits the table over db=4); both CSVs must equal
the one-card CSV.

Any failure exits non-zero.  The last line of standard output is one
JSON object naming the device.  Only this process opens the card: the
CPU reference runs in a child with JAX_PLATFORMS=cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"
ACGT = b"ACGT"


class SmokeFailure(RuntimeError):
    pass


def fail(msg: str):
    raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------- CLI driving ----------

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv: list, echo: bool = True) -> str:
    """cuclark-tpu <argv> in this process; fails on a non-zero exit.
    Returns what the command wrote to stderr.  echo=False keeps its
    output off the console except the last stdout line (and the tail of
    both on failure)."""
    from cuclark_tpu.cli import main

    err, out = io.StringIO(), io.StringIO()
    if echo:
        ctx_err = contextlib.redirect_stderr(_Tee(sys.stderr, err))
        ctx_out = contextlib.nullcontext()
    else:
        ctx_err = contextlib.redirect_stderr(err)
        ctx_out = contextlib.redirect_stdout(out)
    with ctx_err, ctx_out:
        rc = main([str(a) for a in argv])
    if not echo:
        lines = (out.getvalue().strip().splitlines()
                 or err.getvalue().strip().splitlines())
        if lines:
            say(f"   {lines[-1]}")
    if rc != 0:
        fail(f"cuclark-tpu {' '.join(map(str, argv))} exited {rc}:\n"
             f"{out.getvalue()[-2000:]}{err.getvalue()[-2000:]}")
    return err.getvalue()


def stream_parts_of(stderr: str) -> int:
    m = re.search(r"Streaming DB in (\d+) bucket-range parts", stderr)
    return int(m.group(1)) if m else 1


def run_cpu_child(work: Path, jobs: list, tag: str) -> None:
    """Run CLI calls in a child process that only ever sees JAX's CPU
    backend (the card stays with this process)."""
    path = work / f"cpu_jobs_{tag}.json"
    path.write_text(json.dumps([[str(a) for a in j] for j in jobs]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-c", _CPU_CHILD, str(path)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=1200)
    if out.returncode != 0:
        fail(f"CPU child ({tag}) exited {out.returncode}:\n"
             f"{out.stdout[-3000:]}")
    say(f"   CPU child ({tag}): {len(jobs)} CLI call(s) in "
        f"{time.time() - t0:.1f} s")


_CPU_CHILD = """
import json, sys
import jax
if jax.default_backend() != "cpu":
    sys.exit(f"CPU child got backend {jax.default_backend()!r}")
from cuclark_tpu.cli import main
for argv in json.load(open(sys.argv[1])):
    if main(argv) != 0:
        sys.exit(f"cuclark-tpu {argv} failed")
"""


# ---------- comparison ----------

def compare_csv(got: bytes, want: bytes) -> str | None:
    """None when identical, else where the first difference is."""
    if got == want:
        return None
    g_lines = got.split(b"\n")
    w_lines = want.split(b"\n")
    for i, (g, w) in enumerate(zip(g_lines, w_lines)):
        if g != w:
            col = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                       min(len(g), len(w)))
            return (f"line {i + 1}, byte {col + 1}: got {g[:160]!r}, "
                    f"want {w[:160]!r}")
    return (f"length differs: got {len(got)} bytes / {len(g_lines)} "
            f"lines, want {len(want)} bytes / {len(w_lines)} lines")


def require_same(label: str, got: bytes, want: bytes) -> None:
    diff = compare_csv(got, want)
    if diff is not None:
        fail(f"{label}: CSVs differ at {diff}")


# ---------- data ----------

def make_genomes(root: Path, n_targets: int, glen: int, seed: int,
                 shared: int = 0, wrap: int = 0) -> tuple[Path, list[str]]:
    """Seeded random genomes, one FASTA file per target, and their
    targets definition.  Target t begins with the last `shared` bases
    of target t-1, so those k-mers are common (not target-specific).
    wrap > 0 line-wraps the FASTA bodies and returns the genomes as
    strings too (for the oracle); wrap == 0 returns no strings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_targets, glen), dtype=np.uint8)
    if shared:
        codes[1:, :shared] = codes[:-1, glen - shared:]
    root.mkdir(parents=True, exist_ok=True)
    seqs, lines = [], []
    lut = np.frombuffer(ACGT, np.uint8)
    for t in range(n_targets):
        body = lut[codes[t]].tobytes()
        if wrap:
            seqs.append(body.decode())
            body = b"\n".join(body[i:i + wrap]
                              for i in range(0, glen, wrap))
        p = root / f"g{t}.fa"
        p.write_bytes(b">genome%d\n%s\n" % (t, body))
        lines.append(f"{p} T{t + 1}")
    targets = root / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    return targets, seqs


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


def make_reads(genomes: list[str], n: int, seed: int):
    """Single-end reads and paired mates drawn from the genomes: point
    mutations, N runs, chimeras of two targets, random junk, and a few
    reads shorter than k.  Returns (single, paired) where single is
    [(name, seq)] and paired is [(name1, name2, seq1, seq2)]."""
    import random

    rng = random.Random(seed)
    # no read of exactly k-1 bases (26 or 30): its 0/0 gamma prints
    # "-nan" from the native formatter (as the reference's C does on
    # x86) but "nan" from Python's %g, which the oracle uses
    lengths = [20, 60, 100, 120, 150, 151, 250]
    weights = [2, 4, 8, 8, 20, 4, 4]

    def fragment(length):
        kind = rng.random()
        if kind < 0.05:
            return "".join(rng.choice("ACGT") for _ in range(length))
        t = rng.randrange(len(genomes))
        g = genomes[t]
        if kind < 0.15:  # chimera: two targets' halves
            g2 = genomes[(t + 1) % len(genomes)]
            h = length // 2
            p1 = rng.randrange(len(g) - h)
            p2 = rng.randrange(len(g2) - (length - h))
            seq = list(g[p1:p1 + h] + g2[p2:p2 + length - h])
        else:
            p = rng.randrange(len(g) - length)
            seq = list(g[p:p + length])
        for _ in range(rng.randrange(0, 5)):
            seq[rng.randrange(length)] = rng.choice("ACGT")
        if rng.random() < 0.2:
            p = rng.randrange(length)
            for q in range(p, min(length, p + rng.randrange(1, 5))):
                seq[q] = "N"
        return "".join(seq)

    single = []
    paired = []
    for i in range(n):
        single.append((f"r{i}", fragment(rng.choices(lengths, weights)[0])))
        insert = fragment(rng.choice([250, 300, 400]))
        l1, l2 = rng.choice([75, 100, 150]), rng.choice([75, 100, 150])
        paired.append((f"p{i}/1", f"p{i}/2", insert[:l1],
                       _revcomp(insert[-l2:])))
    return single, paired


def load_oracle():
    """tests/oracle.py by path: an installed package named `tests` may
    shadow this checkout's tests directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cuclark_oracle", ROOT / "tests" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_fastq(path: Path, records) -> None:
    path.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                            for n, s in records))


def oracle_csv(records, odb, k: int, target_names: list[str],
               extended: bool = False, paired: bool = False) -> bytes:
    """The CLARK CSV the reference semantics give (tests/oracle.py).
    records: [(name, seq)], seq already mate1 + 'N' + mate2 if paired."""
    oracle = load_oracle()
    n_t = len(target_names) - 1
    head = (["Object_ID"] + (target_names[1:] if extended else [])
            + ["Length", "Gamma", "1st_assignment", "score1",
               "2nd_assignment", "score2", "confidence"])
    lines = [",".join(head)]
    for name, seq in records:
        res = oracle.classify_read(seq, odb, k, n_t)
        row = oracle.result_line(name, len(seq), k, *res, target_names,
                                 paired=paired)
        if extended:
            counts: dict[int, int] = {}
            for km in oracle.read_kmers(seq, k):
                lb = odb.get(km)
                if lb:
                    counts[lb] = counts.get(lb, 0) + 1
            first, rest = row.split(",", 1)
            row = ",".join([first]
                           + [str(counts.get(t, 0)) for t in
                              range(1, n_t + 1)]
                           + [rest])
        lines.append(row)
    return ("\n".join(lines) + "\n").encode()


# ---------- phase A ----------

def phase_a() -> dict:
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        fail(f"JAX's default backend is {backend!r}, not 'gpu': no card "
             f"found or its CUDA plug-in did not load")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr}")
    from cuclark_tpu import memplan, native
    from cuclark_tpu.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    say("A. device")
    for line in smi.stdout.strip().splitlines():
        say(f"   nvidia-smi: {line.strip()}")
    say(f"   jax {jax.__version__}, backend {backend}, device_kind "
        f"{dev.device_kind!r}, {jax.device_count()} device(s)")
    say(f"   compile cache: {enable_compile_cache()}")
    stats = dev.memory_stats() or {}
    say(f"   memory_stats: bytes_limit {stats.get('bytes_limit')}, "
        f"bytes_reservable_limit {stats.get('bytes_reservable_limit')}, "
        f"bytes_in_use {stats.get('bytes_in_use')}; table budget "
        f"{memplan.device_memory_budget_mb(dev):.0f} MB")
    ok = native.available()
    say(f"   native.available() = {ok}")
    if not ok:
        fail("the native host module (csrc/host_ops.cpp) did not build")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# ---------- phase B ----------

PHASE_B_DBS = (("full", ["-k", "31"], 31, 1),
               ("light", ["--light"], 27, 4))


def phase_b(work: Path, n_targets: int = 8, glen: int = 12_000,
            n_reads: int = 2000, cpu_child: bool = True) -> int:
    """Build both databases, classify four ways each, and hold every
    CSV to the oracle and (cpu_child) to the CPU child's CSV.  Returns
    the number of CSVs compared."""
    from cuclark_tpu.hashdb import KmerDB

    oracle = load_oracle()
    say("B. parity, small")
    targets, genomes = make_genomes(work / "genomes_b", n_targets, glen,
                                    seed=11, shared=glen // 10, wrap=70)
    single, paired = make_reads(genomes, n_reads, seed=12)
    reads = work / "b_reads.fq"
    r1, r2 = work / "b_r1.fq", work / "b_r2.fq"
    write_fastq(reads, single)
    write_fastq(r1, [(a, s) for a, _, s, _ in paired])
    write_fastq(r2, [(b, s) for _, b, _, s in paired])
    merged = [(a, s1 + "N" + s2) for a, _, s1, s2 in paired]

    cpu_jobs, checks = [], []
    for tag, db_flags, k, gap in PHASE_B_DBS:
        dbdir = work / f"db_{tag}"
        run_cli(["build-db", "-T", targets, "-D", dbdir] + db_flags,
                echo=False)
        db = KmerDB.load(next(dbdir.glob("db_k*.npz")))
        names = db.target_names
        odb = oracle.build_db({t + 1: [g] for t, g in enumerate(genomes)},
                              k, gap)
        if db.num_kmers != len(odb):
            fail(f"{tag} DB holds {db.num_kmers} k-mers, oracle "
                 f"{len(odb)}")
        want_single = oracle_csv(single, odb, k, names)
        stream_mb = db.table.nbytes / 1e6 / 4
        modes = (
            ("single", ["-O", reads], want_single),
            ("paired", ["-P", r1, r2],
             oracle_csv(merged, odb, k, names, paired=True)),
            ("extended", ["-O", reads, "--extended"],
             oracle_csv(single, odb, k, names, extended=True)),
            ("streamed", ["-O", reads, "--max-table-mb", f"{stream_mb}"],
             want_single),
        )
        for mode, flags, want in modes:
            out = work / f"b_{tag}_{mode}.csv"
            err = run_cli(["classify", "-D", dbdir, "-R", out] + flags)
            parts = stream_parts_of(err)
            if mode == "streamed" and parts < 4:
                fail(f"{tag} streamed run used {parts} part(s), not >= 4")
            got = out.read_bytes()
            require_same(f"{tag} {mode} GPU vs oracle", got, want)
            cpu_out = work / f"b_{tag}_{mode}_cpu.csv"
            cpu_jobs.append(["classify", "-D", dbdir, "-R", cpu_out]
                            + flags)
            checks.append((f"{tag} {mode}", out, cpu_out, parts))
    if cpu_child:
        run_cpu_child(work, cpu_jobs, "b")
    for label, out, cpu_out, parts in checks:
        if cpu_child:
            require_same(f"{label} GPU vs CPU child", out.read_bytes(),
                         cpu_out.read_bytes())
        say(f"   {label}: {n_reads} rows, {parts} part(s): identical to "
            f"the oracle" + (" and the CPU child" if cpu_child else ""))
    return len(checks)


# ---------- phase C ----------

class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations (a
    persistent-cache hit is counted as its retrieval time)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.on = False
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, event, duration, *args, **kwargs):
        if self.on and event in self.EVENTS:
            self.seconds += duration


class MemSampler:
    """Largest bytes_in_use seen on each device while running."""

    def __init__(self, devices, period: float = 0.2):
        self.devices = devices
        self.period = period
        self.peak = [0] * len(devices)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for i, d in enumerate(self.devices):
                used = (d.memory_stats() or {}).get("bytes_in_use", 0)
                self.peak[i] = max(self.peak[i], used)
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def scale_data(work: Path, n_targets: int, glen: int, n_reads: int):
    """Phase-C genomes, database and simulated reads, all through the
    CLI.  Returns (dbdir, reads path, DB build seconds)."""
    say(f"   generating {n_targets} genomes x {glen} bp")
    targets, _ = make_genomes(work / "genomes_c", n_targets, glen, seed=21)
    dbdir = work / "db_c"
    t0 = time.time()
    run_cli(["build-db", "-T", targets, "-D", dbdir, "-k", "31",
             "--build-ram-mb", "32000"], echo=False)
    build_s = time.time() - t0
    reads = work / "c_reads.fq"
    run_cli(["simulate-reads", "-T", targets, "-O", reads, "-n", n_reads,
             "-l", "150", "--sub-rate", "0.01", "--seed", "22"])
    return dbdir, reads, build_s


def head_fastq(src: Path, dst: Path, n: int) -> None:
    with open(src, "rb") as f, open(dst, "wb") as g:
        for _ in range(4 * n):
            g.write(f.readline())


def head_lines(path: Path, n: int) -> bytes:
    out = []
    with open(path, "rb") as f:
        for _ in range(n):
            out.append(f.readline())
    return b"".join(out)


def device_memory(dev) -> tuple[int, int]:
    """(bytes_limit, peak_bytes_in_use) of a device."""
    stats = dev.memory_stats() or {}
    return stats.get("bytes_limit", 0), stats.get("peak_bytes_in_use", 0)


def phase_c(work: Path, n_targets: int, glen: int, n_reads: int,
            check_rows: int) -> None:
    import jax

    from cuclark_tpu.hashdb import KmerDB

    say("C. scale, one card, resident (smoke figures, not a benchmark)")
    dbdir, reads, build_s = scale_data(work, n_targets, glen, n_reads)
    dbp = next(dbdir.glob("db_k*.npz"))
    db = KmerDB.load(dbp)
    main_np, stash_np = db.split_tables()
    table_bytes = db.table.nbytes
    say(f"   DB: {db.num_kmers} target-specific 31-mers, {db.num_targets} "
        f"targets, main {main_np.shape[0]} rows x {main_np.shape[1]} "
        f"uint32 ({main_np.size} elements), table {table_bytes / 1e9:.3f} "
        f"GB")
    if n_targets == SCALE_TARGETS and (db.num_kmers < 256_000_000
                                       or table_bytes < 8e9):
        fail("phase-C table is smaller than 256M k-mers / 8 GB")
    t0 = time.time()
    probe = jax.device_put(main_np)
    probe.block_until_ready()
    upload_s = time.time() - t0
    del probe, db, main_np, stash_np
    gc.collect()

    clock = CompileClock()
    out = work / "c_gpu.csv"
    clock.on = True
    t0 = time.time()
    err = run_cli(["classify", "-D", dbdir, "-O", reads, "-R", out])
    wall = time.time() - t0
    clock.on = False
    gc.collect()
    parts = stream_parts_of(err)
    if parts != 1:
        fail(f"phase-C table streamed in {parts} parts, not resident")
    limit, peak = device_memory(jax.devices()[0])
    say(f"   DB build: {build_s:.1f} s (build-db, host)")
    say(f"   table upload: {upload_s:.2f} s ({table_bytes / 1e9:.3f} GB "
        f"device_put of the main table)")
    say(f"   compile: {clock.seconds:.2f} s (trace + lower + compile or "
        f"cache fetch, inside the classify call)")
    say(f"   classify: {n_reads} reads in {wall:.1f} s end to end = "
        f"{n_reads / wall:.0f} reads/s (DB load, upload and compile "
        f"included)")
    say(f"   memory_stats: bytes_limit {limit} peak_bytes_in_use {peak} "
        f"(peak - table = {(peak - table_bytes) / 1e6:.0f} MB); "
        f"stream_parts 1")
    if not 0 < peak < limit:
        fail(f"peak_bytes_in_use {peak} not below bytes_limit {limit}")

    run_cli(["evaluate", "-R", out, "--min-recall", "0.97",
             "--min-precision", "0.99"], echo=False)
    head = work / "c_head.fq"
    head_fastq(reads, head, check_rows)
    cpu_out = work / "c_cpu.csv"
    run_cpu_child(work, [["classify", "-D", dbdir, "-O", head, "-R",
                          cpu_out]], "c")
    require_same("phase C GPU vs CPU child", head_lines(out, check_rows + 1),
                 cpu_out.read_bytes())
    say(f"   first {check_rows} rows identical to the CPU child; "
        f"evaluate floors met")


# ---------- four cards ----------

def four_cards(work: Path, n_targets: int, glen: int, n_reads: int) -> None:
    import jax

    from cuclark_tpu.hashdb import KmerDB

    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--four-cards needs 4 devices, JAX sees {len(devs)}")
    say("D. four cards (classify -d 4)")
    dbdir, reads, _ = scale_data(work, n_targets, glen, n_reads)
    table_mb = KmerDB.load(next(dbdir.glob("db_k*.npz"))).table.nbytes / 1e6
    one = work / "d_one.csv"
    run_cli(["classify", "-D", dbdir, "-O", reads, "-R", one, "-d", "1"])
    gc.collect()
    want = one.read_bytes()
    runs = (("data=4 x db=1", [], "4 data x 1 db"),
            ("data=1 x db=4", ["--max-table-mb", f"{table_mb / 4 * 1.25}"],
             "1 data x 4 db"))
    for label, flags, mesh_txt in runs:
        out = work / f"d_{mesh_txt.replace(' ', '_')}.csv"
        with MemSampler(devs[:4]) as mem:
            t0 = time.time()
            err = run_cli(["classify", "-D", dbdir, "-O", reads, "-R", out,
                           "-d", "4"] + flags)
            wall = time.time() - t0
        gc.collect()
        if f"Mesh: {mesh_txt} devices" not in err:
            fail(f"{label}: the CLI did not plan a {mesh_txt} mesh")
        if stream_parts_of(err) != 1:
            fail(f"{label}: the table streamed instead of staying resident")
        require_same(f"-d 4 {label} vs one card", out.read_bytes(), want)
        say(f"   {label}: CSV identical to the one-card CSV ({n_reads} "
            f"rows, {wall:.1f} s); per-card max bytes_in_use "
            f"{[int(p) for p in mem.peak]}")


# ---------- main ----------

# Phase C and --four-cards: the "full mode k=31, one chip" deployment
# (BASELINE.md ladder 3) at >= 256M target-specific k-mers.
SCALE_TARGETS = 4096
SCALE_GENOME_LEN = 65536
SCALE_READS = 1 << 20
CHECK_ROWS = 65536


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the -d 4 path and its one-card reference")
    args = ap.parse_args(argv)

    device = phase_a()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        if args.four_cards:
            four_cards(WORK, SCALE_TARGETS, SCALE_GENOME_LEN, SCALE_READS)
        else:
            phase_b(WORK)
            gc.collect()
            phase_c(WORK, SCALE_TARGETS, SCALE_GENOME_LEN, SCALE_READS,
                    CHECK_ROWS)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
