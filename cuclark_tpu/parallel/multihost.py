"""Multi-host execution: per-host input sharding + global mesh.

The reference is single-node multi-GPU only (SURVEY §5); this module is
the scale-out path it lacks.  Design (How-to-Scale-Your-Model recipe):

 - a global 2-D mesh ("data" over hosts x local cards, "db" within or
   across hosts depending on DB size vs per-host device memory), built
   from jax.devices() after jax.distributed.initialize();
 - each host reads only its byte range of the input file and scans
   forward to the first record boundary (the reference's OpenMP
   byte-range scan, src/CuCLARK_hh.hh:1339-1471, applied across hosts
   over the network instead of threads);
 - each host packs and feeds only its local shard of every global batch
   (jax.make_array_from_process_local_data), the jitted sharded step
   runs collectives over NVLink within a host and the network across
   hosts, and each host writes its own ordered CSV shard (concatenated
   by rank order afterwards).

Everything here except `initialize()` is pure logic and unit-tested on
a single process; the mesh/step reuse cuclark_tpu.parallel.mesh.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: str | None = None):
    """jax.distributed bring-up (no-op when single-process).

    local_device_ids ("0" or "0,1"): the cards of this host that this
    process owns.  Without it every process opens every visible card
    and JAX preallocates most of each card's memory, so a second process
    on the same host fails for want of memory.  Several processes on one
    host therefore must each name disjoint cards (or be given disjoint
    CUDA_VISIBLE_DEVICES); otherwise this raises before any card is
    opened."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    ids = (None if local_device_ids is None
           else [int(i) for i in str(local_device_ids).split(",")])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=ids,
    )
    if ids is not None or _cpu_only(jax.config.jax_platforms):
        return
    import os

    hosts = _exchange_hostnames(num_processes, process_id)
    check_one_process_per_card(hosts, process_id,
                               os.environ.get("CUDA_VISIBLE_DEVICES"))


def _cpu_only(platforms) -> bool:
    return bool(platforms) and set(str(platforms).split(",")) == {"cpu"}


def _exchange_hostnames(num_processes: int, process_id: int) -> list[str]:
    """Every process's hostname, through the coordinator's key-value
    store (no device is touched)."""
    import socket

    from jax._src import distributed

    client = distributed.global_state.client
    client.key_value_set(f"cuclark/host/{process_id}", socket.gethostname())
    return [client.blocking_key_value_get(f"cuclark/host/{i}", 120_000)
            for i in range(num_processes)]


def check_one_process_per_card(hosts: list[str], process_id: int,
                               cuda_visible: str | None) -> None:
    """Refuse a launch where this process shares its host with another
    process and nothing splits the host's cards between them."""
    shared = sum(h == hosts[process_id] for h in hosts)
    if shared > 1 and not cuda_visible:
        raise ValueError(
            f"{shared} processes share host {hosts[process_id]!r}, and "
            f"each would open every card on it; give each process its "
            f"own cards with --local-device-ids (e.g. one card each), or "
            f"run one process per host")


def host_byte_range(file_size: int, num_hosts: int, host_id: int):
    """Even byte split; the scan then aligns each start to a record."""
    per = file_size // num_hosts
    start = per * host_id
    end = file_size if host_id == num_hosts - 1 else per * (host_id + 1)
    return start, end


def align_to_fasta_record(buf: np.ndarray, offset: int) -> int:
    """Scan forward from offset to the next '>' at a line start
    (reference FASTA batch split, src/CuCLARK_hh.hh:1363-1365).
    Vectorized: a Python per-byte loop costs ~135 ns/byte — minutes on
    the chromosome-scale records a pod shards."""
    n = len(buf)
    if offset == 0:
        return 0
    if offset >= n:
        return n
    cand = np.flatnonzero((buf[offset:] == ord(">"))
                          & (buf[offset - 1:n - 1] == ord("\n")))
    return int(offset + cand[0]) if len(cand) else n


def align_to_fastq_record(buf: np.ndarray, offset: int) -> int:
    """Scan forward from offset to the next FASTQ record start using the
    reference's lookahead heuristic (src/CuCLARK_hh.hh:1405-1471): among
    upcoming newline-following lines, a line starting with '@' whose
    line-after-next starts with '+' is a record header (quality lines
    may also start with '@', but never two rows before a '+').  A
    candidate whose '+' line cannot be verified (fewer than 3 lines
    remain) cannot begin a COMPLETE 4-line record either, so it is
    never accepted on faith — a final quality line starting with '@'
    (Q31) near a shard boundary must not be mistaken for a header."""
    n = len(buf)
    if offset == 0:
        return 0
    if offset >= n:
        return n
    # line starts at/after offset = newline positions + 1 (vectorized;
    # the per-byte Python walk took ~135 ns/byte on large records)
    nl = np.flatnonzero(buf[offset - 1:] == ord("\n"))
    starts = (offset - 1 + nl + 1)[:12]
    starts = starts[starts < n]
    for idx in range(len(starts)):
        s = int(starts[idx])
        if (buf[s] == ord("@") and idx + 2 < len(starts)
                and buf[int(starts[idx + 2])] == ord("+")):
            return s
    return n


def host_record_slice(buf: np.ndarray, num_hosts: int, host_id: int):
    """The [start, end) byte range of records owned by this host."""
    fmt_fastq = len(buf) > 0 and buf[0] == ord("@")
    align = align_to_fastq_record if fmt_fastq else align_to_fasta_record
    s0, e0 = host_byte_range(len(buf), num_hosts, host_id)
    start = align(buf, s0)
    end = align(buf, e0) if e0 < len(buf) else len(buf)
    return start, end


def shard_reads_for_host(buf: np.ndarray, num_hosts: int, host_id: int):
    """Scan only this host's record slice.

    Returns (name_s, name_e, seq_s, seq_e) absolute offsets into buf."""
    from cuclark_tpu.io import fast_parse

    start, end = host_record_slice(buf, num_hosts, host_id)
    if start >= end:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    sub = buf[start:end]
    ns, ne, ss, se = fast_parse.scan_file(sub)
    return ns + start, ne + start, ss + start, se + start


def _align_in_window(path, size: int, pos: int, fmt_fastq: bool,
                     slack: int) -> int:
    """Absolute offset of the next record start at/after byte `pos`,
    reading only a window of the file.  The FASTQ heuristic looks ahead
    several lines, so a candidate found too close to the window edge is
    re-checked with a doubled window (a cut-off lookahead must never
    change the answer vs a whole-file scan)."""
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    align = align_to_fastq_record if fmt_fastq else align_to_fasta_record
    retries = 0
    while True:
        lo = pos - 1  # previous byte needed for the line-start check
        hi = min(size, pos + slack)
        w = np.fromfile(path, np.uint8, count=hi - lo, offset=lo)
        r = align(w, pos - lo)
        margin = slack // 2 if fmt_fastq else 0
        if hi >= size or r < len(w) - margin:
            return min(lo + r, size)
        # no verifiable record start inside the window (malformed input
        # near the boundary): doubling retries each re-read the window
        # from `pos`, so cap them — after a few misses one full-tail
        # read settles the answer instead of O(size log size) re-scans
        retries += 1
        slack = size if retries >= 3 else slack * 2


def read_host_slice(path, num_hosts: int, host_id: int,
                    slack: int = 1 << 25):
    """Read ONLY this host's record slice of a plain file from disk
    (+ bounded boundary slack) — the per-host byte-range I/O the
    multi-host design promises (a 16-host pod must not do 16 full-file
    reads).  Returns (buf_window, name_s, name_e, seq_s, seq_e) with
    offsets INTO the window.  Gzip streams are not range-addressable
    and fall back to a full read; partitioning is identical to
    shard_reads_for_host over the whole buffer."""
    import os

    from cuclark_tpu.io import fast_parse

    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"\x1f\x8b":  # gzip
        from cuclark_tpu.pipeline import _read_file_bytes

        buf = _read_file_bytes(path)
        return (buf,) + shard_reads_for_host(buf, num_hosts, host_id)
    size = os.path.getsize(path)
    fmt_fastq = head[:1] == b"@"
    s0, e0 = host_byte_range(size, num_hosts, host_id)
    start = _align_in_window(path, size, s0, fmt_fastq, slack)
    end = (size if e0 >= size
           else _align_in_window(path, size, e0, fmt_fastq, slack))
    if start >= end:
        z = np.zeros(0, np.int64)
        return np.zeros(0, np.uint8), z, z, z, z
    w = np.fromfile(path, np.uint8, count=end - start, offset=start)
    return (w,) + fast_parse.scan_file(w)


def _allreduce_max_i64(values: np.ndarray) -> np.ndarray:
    """Global elementwise max of a small int64 vector across processes
    (single-process: identity).  Used to agree on the lockstep shape
    parameters without every host scanning the whole file."""
    import jax

    if jax.process_count() <= 1:
        return np.asarray(values, np.int64)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(
        np.asarray(values, np.int64))
    return np.asarray(gathered).max(axis=0)


class GlobalClassifier:
    """Reusable global-mesh classification engine.

    Holds the one-time state — the mesh, the resident sharded table
    (or the host-side table for the streaming composition), and the
    compiled step programs — so classifying MANY files (or repeated
    passes) pays the table upload and trace cost once, not per file.
    Construction must run on every process of the job (collective
    device_puts); classify_file_to_csv() then follows the lockstep
    protocol per file."""

    def __init__(self, db, cfg, num_db: int = 1, mesh=None):
        import dataclasses

        import jax

        from cuclark_tpu.memplan import resolve_table_budget_mb
        from cuclark_tpu.parallel.mesh import make_global_mesh
        from cuclark_tpu.pipeline import Classifier

        self.db = db
        self.nproc = jax.process_count()
        self.pid = jax.process_index()
        if mesh is None:
            mesh = make_global_mesh(num_db)
        self.mesh = mesh
        rows_global = mesh.shape["data"]
        if rows_global % self.nproc:
            raise ValueError(
                f"data axis {rows_global} not divisible by {self.nproc} "
                f"processes: the lockstep engine feeds per-process data "
                f"rows, so num_db must not exceed the per-process device "
                f"count (the host-spanning num_db == total-devices mesh "
                f"is for replicated-read ShardedClassifier use only)")
        self.rows_global = rows_global

        # Lockstep requirement: every process must derive the SAME
        # memory plan.  Pin the budget to the global minimum before any
        # planning happens (live per-process memory stats differ).
        budget = agree_budget_mb(resolve_table_budget_mb(cfg.max_table_mb))
        if budget is not None and budget != cfg.max_table_mb:
            cfg = dataclasses.replace(cfg, max_table_mb=budget)
        self.cfg = cfg
        clf = Classifier(db, cfg, mesh=mesh, multihost=True)
        if clf.stream_parts > 1 and self.nproc > 1:
            # group size derives from live free memory: agree on the min
            clf.stream_group_eff = int(_allreduce_min_i64(
                np.array([clf.stream_group_eff]))[0])
        self.clf = clf
        self.sc = clf._sharded  # None in streaming mode
        self.stream_parts = clf.stream_parts

    def classify_file_to_csv(self, path, out_path,
                             paired_path: str | None = None) -> int:
        """Classify one file; see module-level classify_file_to_csv for
        the lockstep protocol.  Returns rows written by THIS process."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from cuclark_tpu import native
        from cuclark_tpu.io import fast_parse
        from cuclark_tpu.io.csv_out import format_row, header_line
        from cuclark_tpu.parallel.mesh import ShardedClassifier
        from cuclark_tpu.pipeline import (CsvSink, _prefetch,
                                          _read_file_bytes,
                                          _shard_prefetch)

        db, cfg, clf = self.db, self.cfg, self.clf
        nproc, pid = self.nproc, self.pid
        paired = paired_path is not None

        # 1.+2. this process's record block (absolute offsets into buf):
        # _scan_for_classify already branches between per-host
        # byte-range I/O (plain multi-host) and whole-file scans with
        # record-index sharding (paired: keeps mate files aligned)
        buf, buf2, name_s, name_e, seq_s, seq_e, seq_s2, seq_e2 = (
            clf._scan_for_classify(path, paired_path, 0, nproc, pid))
        n_local = len(seq_s)
        raw_len = seq_e - seq_s
        if buf2 is not None:
            raw_len = raw_len + (seq_e2 - seq_s2) + 1
        local_max_len = int(raw_len.max(initial=1))

        # lockstep shape agreement: one tiny collective instead of every
        # process scanning the whole file
        gmax = _allreduce_max_i64(np.array([local_max_len, n_local]))
        L = clf._bin_for(int(gmax[0]))
        max_block = int(gmax[1])

        # 3. lockstep batch count; local rows per batch divisible by the
        #    per-process slice of the data axis, and capped by the
        #    device cell budget (long-read batches shrink instead of
        #    exploding the padded arrays, exactly like the single-host
        #    shrink loop — L is agreed, so the cap is identical on
        #    every rank)
        from cuclark_tpu.pipeline import Classifier as _Clf

        step = self.rows_global // nproc
        B_local = max(cfg.batch_reads, step)
        B_local -= B_local % step
        cap = max(step, _Clf.MAX_BATCH_CELLS // L // step * step)
        B_local = min(B_local, cap)
        n_batches = max(1, -(-max_block // B_local))

        use_native = native.available()
        written = 0
        # extended-mode hit stats on the non-native fallback (the native
        # path accumulates inside CsvSink): [min, max, sum] of distinct
        # hit targets per read, allreduced across ranks before printing
        hstats = [None, 0, 0]
        # pad width grows past 3 digits with the process count so
        # lexicographic shard order == rank order at any scale
        # ('out.h1000' must not sort before 'out.h999')
        width = max(3, len(str(nproc - 1)))
        out_p = (f"{out_path}.h{pid:0{width}d}" if nproc > 1
                 else out_path)
        with open(out_p, "wb") as f:
            sink = (CsvSink(f, db, cfg.extended, paired)
                    if use_native else None)
            if pid == 0:
                # shard files concatenate in rank order to one valid CSV
                if use_native:
                    sink.write_header()
                else:
                    f.write(header_line(db.target_names,
                                        cfg.extended).encode())

            def flush(item):
                nonlocal written
                results_dev, labels_dev, ns, ne, lengths, cnt = item
                results = ShardedClassifier.local_rows(results_dev, cnt)
                labels_np = (ShardedClassifier.local_rows(labels_dev, cnt)
                             if labels_dev is not None else None)
                if use_native:
                    sink.flush(results, labels_np, buf, ns, ne, lengths,
                               cnt)
                    written = sink.total_rows
                else:
                    counts_pre = None
                    if cfg.extended and labels_np is not None and cnt:
                        from cuclark_tpu.pipeline import (
                            accumulate_hit_stats, dense_counts)

                        # computed once, reused by _emit_np below
                        counts_pre = dense_counts(labels_np[:cnt],
                                                  db.num_targets)
                        accumulate_hit_stats(
                            hstats,
                            (counts_pre[:, 1:] > 0).sum(axis=1))
                    names = fast_parse.names_of(buf, ns, ne)
                    for row in clf._emit_np(results, labels_np, names,
                                            lengths, cnt, paired,
                                            counts=counts_pre):
                        f.write(format_row(row, db.target_names,
                                           cfg.extended).encode())
                        written += 1

            def batches():
                """Lockstep local wire batches: ((p2, vb), ns, ne,
                lengths, cnt) — empty ranks still emit all-padding
                batches."""
                W2, WV = L // 4, L // 8
                for b in range(n_batches):
                    blo = min(b * B_local, n_local)
                    bhi = min(blo + B_local, n_local)
                    cnt = bhi - blo
                    if cnt and paired:
                        # fused mate1+N+mate2 wire packing;
                        # n_rows=B_local pads the ragged final batch
                        p2, vb, lengths = (
                            fast_parse.pack_block2_paired_dispatch(
                                buf, seq_s[blo:bhi], seq_e[blo:bhi],
                                buf2, seq_s2[blo:bhi], seq_e2[blo:bhi],
                                L, n_rows=B_local))
                    elif cnt:
                        # fused scan->wire packing (no [R, L] byte
                        # matrix)
                        p2, vb, lengths = fast_parse.pack_block2_dispatch(
                            buf, seq_s[blo:bhi], seq_e[blo:bhi], L,
                            n_rows=B_local)
                    else:
                        p2 = np.zeros((B_local, W2), np.uint8)
                        vb = np.zeros((B_local, WV), np.uint8)
                        lengths = np.zeros(B_local, np.int64)
                    yield ((p2, vb), name_s[blo:bhi], name_e[blo:bhi],
                           lengths, cnt)

            # The writer thread drains flushes in submission order while
            # the main thread keeps dispatching (single-host parity;
            # numpy/native formatting release the GIL so the overlap is
            # real).
            with ThreadPoolExecutor(1) as writer:
                futs = deque()

                def submit(item):
                    futs.append(writer.submit(flush, item))
                    while len(futs) > 3:
                        futs.popleft().result()

                # Packing runs on a prefetch thread (bounded queue, order
                # preserved) so scan/pack of batch i+1 overlaps dispatch
                # and CSV formatting of batch i — single-host parity; the
                # generator touches only host arrays, so the lockstep
                # rule (jax dispatch order identical on every rank) is
                # unaffected.
                if clf.stream_parts > 1:
                    def flush_group(group):
                        outs = clf._stream_group_dev(
                            [w for w, _, _, _, _ in group])
                        for ((_, ns_g, ne_g, len_g, cnt_g),
                             (r, lab)) in zip(group, outs):
                            submit((r, lab, ns_g, ne_g, len_g, cnt_g))

                    group = []
                    for wire, ns, ne, lengths, cnt in _prefetch(batches()):
                        group.append((wire, ns, ne, lengths, cnt))
                        if len(group) >= clf.stream_group_eff:
                            flush_group(group)
                            group = []
                    if group:
                        flush_group(group)
                else:
                    # mesh placement happens INSIDE the prefetched
                    # generator (feed thread): a device_put can block
                    # for the whole H2D transfer, which on the main
                    # thread would serialize uploads with dispatch
                    def placed_batches():
                        for (p2, vb), ns, ne, lengths, cnt in batches():
                            yield (self.sc.put_wire(p2, vb), ns, ne,
                                   lengths, cnt)

                    inflight = deque()
                    for (dev_p2, dev_vb), ns, ne, lengths, cnt in \
                            _prefetch(placed_batches()):
                        results_dev, labels_dev = self.sc.step_placed(
                            dev_p2, dev_vb)
                        _shard_prefetch(results_dev, labels_dev)
                        inflight.append((results_dev, labels_dev, ns, ne,
                                         lengths, cnt))
                        if len(inflight) > 3:
                            submit(inflight.popleft())
                    while inflight:
                        submit(inflight.popleft())
                while futs:
                    futs.popleft().result()
        if cfg.extended:
            # reference prints ONE global MIN/MAX/AVG hit-stats line
            # (CuCLARK_hh.hh:2075-2080); allreduce the per-rank triples
            # so the stats cover every rank's rows, not just rank 0's.
            # This is a collective: every rank participates, rank 0
            # prints.
            import sys as _sys

            h = sink.hstats if use_native else hstats
            rows = sink.total_rows if use_native else written
            sentinel = 1 << 40
            g = _gather_rows_i64(np.array(
                [h[0] if h[0] is not None else sentinel,
                 h[1], h[2], rows]))
            n_rows = int(g[:, 3].sum())
            if pid == 0 and n_rows:
                lo = int(g[:, 0].min())
                print(f"MIN targets: {0 if lo >= sentinel else lo}, "
                      f"MAX targets: {int(g[:, 1].max())}, "
                      f"AVG targets: {int(g[:, 2].sum()) / n_rows:g}",
                      file=_sys.stderr)
        return written


def agree_budget_mb(budget_mb: float | None) -> float | None:
    """Global MIN of the per-process device memory budgets (None =
    unbounded).  Memory plans (db axis, stream parts, group sizes) must
    be IDENTICAL on every process or the lockstep collectives diverge
    and hang; live per-process memory stats are not — agree on the
    tightest budget once and derive everything from it."""
    import jax

    if jax.process_count() <= 1:
        return budget_mb
    from jax.experimental import multihost_utils

    inf = float(1 << 60)
    g = multihost_utils.process_allgather(
        np.array([budget_mb if budget_mb is not None else inf]))
    m = float(np.asarray(g).min())
    return None if m >= inf else m


def _allreduce_min_i64(values: np.ndarray) -> np.ndarray:
    return -_allreduce_max_i64(-np.asarray(values, np.int64))


def _gather_rows_i64(values: np.ndarray) -> np.ndarray:
    """Allgather a small int64 vector: returns [nproc, len(values)]
    (single-process: [1, len])."""
    import jax

    v = np.asarray(values, np.int64)
    if jax.process_count() <= 1:
        return v[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(v))


def classify_file_to_csv(db, cfg, path, out_path, num_db: int = 1,
                         paired_path: str | None = None,
                         mesh=None) -> int:
    """Classify one file on a GLOBAL mesh spanning every process.

    One-shot wrapper over GlobalClassifier (multi-file jobs should
    construct that once — the table upload and step compilation are
    per-engine, not per-file).

    The lockstep protocol (all processes must dispatch identical
    programs for the 'db'-axis psum to meet):
      1. each process scans ONLY its byte range of the input file
         (shard_reads_for_host; paired mode scans whole files and
         shards by record index so mates stay aligned) and the padded
         read length / batch count are agreed globally with one small
         allgather;
      2. records form contiguous per-process blocks in rank order
         (outputs concatenate in rank order);
      3. every process runs the SAME number of batches (the global max
         over blocks), padding missing records with empty reads;
      4. each process feeds its local rows of every global batch in the
         fused 2-bit wire format (jax.make_array_from_process_local_
         data), keeps a few batches in flight with async D2H of its
         addressable result shards, and writes only its own rows to
         out_path (suffixed .h<rank> when multi-process) through the
         native OpenMP CSV formatter + a dedicated writer thread — the
         same machinery as the single-host fast path (pipeline.CsvSink;
         reference overlapped result writing,
         src/CuCLARK_hh.hh:1755-1761).

    When even the per-device resident shard would exceed the memory
    budget, bucket-range parts stream host->mesh per batch group (the
    reference's cycles x devices x parts composition,
    src/CuClarkDB.cu:540-574, 813-858) — every process holds the table
    host-side and materializes its shard of each streamed part.

    Single-process this degenerates to the plain mesh path and is
    CPU-testable end to end.  Returns rows written by THIS process."""
    return GlobalClassifier(db, cfg, num_db=num_db,
                            mesh=mesh).classify_file_to_csv(
        path, out_path, paired_path)
