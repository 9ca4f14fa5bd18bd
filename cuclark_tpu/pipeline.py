"""End-to-end classification pipeline.

The device-side analog of the reference orchestrator CuCLARK::runSimple +
getObjectsDataComputeFullGPU (src/CuCLARK_hh.hh:511-573, 1335-1788):
the host scans and packs reads into fixed-shape code batches; one
jitted device step does k-mer extraction -> canonicalization -> table
probe -> scoring; the host formats CLARK CSV rows.  The reference's
pinned-buffer batch machinery, CUDA events and OpenMP critical
sections disappear — XLA's async dispatch pipelines host packing and
CSV writing against device compute (dispatch batch i+1, then consume
batch i), and fixed (batch, length-bin) shapes keep everything
compile-once.

Two host paths:
 - classify_file: whole-file vectorized scan/pack (io.fast_parse), the
   fast path for real files;
 - classify_records: iterator of (name, seq) records, for streams and
   paired-end merging.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cuclark_tpu import codec, score
from cuclark_tpu.config import ClassifyConfig
from cuclark_tpu.hashdb import KmerDB
from cuclark_tpu.probe import probe, spread_invalid

# Length bins: a read is packed into the smallest bin holding it, so a
# batch of short reads never pays for a rare long read.  Bins are dense
# in the short-read range because every padding window is a probe (a
# 150 bp read in a 256 bin spends ~45% of its probes on padding; the
# 152 bin puts Illumina-length reads at 122 windows instead of 160's
# 130); uniform-length files compile exactly one bin.  The bin set was
# tuned on another accelerator; its H100 effect is not measured.
DEFAULT_LEN_BINS = (128, 152, 160, 192, 256, 320, 512, 1024, 2048, 4096,
                    16384)


@functools.partial(
    jax.jit, static_argnames=("k", "nb_bits", "slots", "num_choices",
                              "with_labels", "layout", "seed", "stash_bits")
)
def classify_step(table, codes, *, k, nb_bits, slots, num_choices,
                  with_labels=True, layout="s2", seed=0, stash_bits=0,
                  stash=None):
    """One device step: codes [R, L] -> results [R, 5] (+ labels [R, P]).

    Single-chip version (sharded variant in cuclark_tpu.parallel.mesh).
    stash: qs split-mode stash array (see probe.probe).
    """
    (khi, klo), valid = codec.extract_kmers(codes, k)
    chi, clo = codec.canonical((khi, klo), k)
    chi, clo = spread_invalid(chi, clo, valid)
    labels = probe(table, nb_bits, slots, num_choices, chi, clo,
                   layout=layout, seed=seed, stash_bits=stash_bits,
                   stash=stash)
    labels = jnp.where(valid, labels, 0)
    results = score.score_labels(labels)
    return (results, labels) if with_labels else (results, None)


@functools.partial(
    jax.jit, static_argnames=("k", "nb_bits", "slots", "num_choices",
                              "with_labels", "layout", "seed", "stash_bits")
)
def classify_step_packed(table, packed2, vbits, *, k, nb_bits, slots,
                         num_choices, with_labels=True, layout="s2",
                         seed=0, stash_bits=0, stash=None):
    """classify_step on the 2-bit wire format (codec.pack_codes): the
    host ships 4 bases/byte + a validity bitmask — 6.25x fewer
    host->device bytes than uint8 codes, the same reason the reference
    ships packed u16 containers (src/CuCLARK_hh.hh:1630-1716) — and the
    device unpacks with a handful of VPU shifts."""
    codes = codec.unpack_codes(packed2, vbits)
    (khi, klo), valid = codec.extract_kmers(codes, k)
    chi, clo = codec.canonical((khi, klo), k)
    chi, clo = spread_invalid(chi, clo, valid)
    labels = probe(table, nb_bits, slots, num_choices, chi, clo,
                   layout=layout, seed=seed, stash_bits=stash_bits,
                   stash=stash)
    labels = jnp.where(valid, labels, 0)
    results = score.score_labels(labels)
    return (results, labels) if with_labels else (results, None)


@functools.partial(
    jax.jit,
    static_argnames=("k", "nb_bits", "slots", "num_choices", "nb_local",
                     "layout", "seed", "stash_bits", "skip_stash"),
)
def probe_part_step(table_part, packed2, vbits, bucket_start, *, k, nb_bits,
                    slots, num_choices, nb_local, layout="s2", seed=0,
                    stash_bits=0, stash=None, skip_stash=False):
    """Probe one DB bucket-range part: packed codes [R, L/4] -> labels
    [R, P].

    The single-chip analog of one reference swap cycle's queryKernel
    pass over a DB part (src/CuClarkDB.cu:813-858 swapDbParts +
    :1045-1243); partial label arrays merge by addition because every
    k-mer lives in at most one part.  qs split mode streams parts of
    the MAIN rows only; the resident stash array is passed on exactly
    one part's call per batch (its matches merge like any other part's).
    """
    codes = codec.unpack_codes(packed2, vbits)
    (khi, klo), valid = codec.extract_kmers(codes, k)
    chi, clo = codec.canonical((khi, klo), k)
    chi, clo = spread_invalid(chi, clo, valid)
    labels = probe(table_part, nb_bits, slots, num_choices, chi, clo,
                   bucket_start=bucket_start, nb_local=nb_local,
                   layout=layout, seed=seed, stash_bits=stash_bits,
                   stash=stash, skip_stash=skip_stash)
    return jnp.where(valid, labels, 0)


score_step = jax.jit(score.score_labels)


def _host_prefetch(*arrs):
    """Start async device->host copies for in-flight results.

    The blocking np.asarray at flush time otherwise serializes the D2H
    transfer with host formatting; enqueueing the copy at dispatch time
    overlaps it with the next batches' compute.
    Multi-host global arrays (non-fully-addressable) skip: only their
    local shards are read back, via ShardedClassifier.local_rows."""
    for a in arrs:
        if a is not None and getattr(a, "is_fully_addressable", True):
            try:
                a.copy_to_host_async()
            except (AttributeError, RuntimeError):
                return


class CsvSink:
    """CLARK-CSV output sink shared by the single-host and global-mesh
    writers: native OpenMP row formatting (csrc/host_ops.cpp
    format_rows/format_rows_ext), extended-mode hit-stat accumulation,
    and the reference header (src/CuCLARK_hh.hh:1956-1972).  The file
    handle must be opened in binary mode; call flush() from a single
    (writer) thread so rows stay ordered."""

    def __init__(self, f, db, extended: bool, paired: bool):
        from cuclark_tpu import native

        self.f = f
        self.db = db
        self.extended = extended
        self.paired = paired
        self.tname_bytes, self.tname_off = native.pack_target_names(
            db.target_names)
        self.total_rows = 0
        self.hstats = [None, 0, 0]  # min, max, sum of distinct hit targets

    def write_header(self) -> None:
        from cuclark_tpu.io.csv_out import header_line

        self.f.write(header_line(self.db.target_names,
                                 self.extended).encode())

    def flush(self, results, labels_np, buf, ns, ne, lengths, cnt) -> None:
        """Format + write one batch: results [R,5] np, labels_np [R,P]
        np or None, read names as (buf, ns, ne) byte offsets."""
        from cuclark_tpu import native

        results = results[:cnt]
        lengths = lengths[:cnt]
        total, ibest, best, isecond, second = (
            results[:, i] for i in range(5))
        norm, gamma, conf = score.gamma_confidence(
            total, best, second, lengths, self.db.k, self.paired)
        if self.extended:
            counts = dense_counts(labels_np[:cnt],
                                  self.db.num_targets)[:, 1:]
            accumulate_hit_stats(self.hstats, (counts > 0).sum(axis=1))
            self.f.write(native.format_rows_ext(
                counts, norm, gamma, ibest, best, isecond, second, conf,
                buf, ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off))
        else:
            self.f.write(native.format_rows(
                norm, gamma, ibest, best, isecond, second, conf,
                buf, ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off))
        self.total_rows += cnt

    def print_hit_stats(self) -> None:
        """Reference extended-mode hit stats (CuCLARK_hh.hh:2075-2080)."""
        if self.extended and self.total_rows:
            import sys

            print(f"MIN targets: {self.hstats[0] or 0}, MAX targets: "
                  f"{self.hstats[1]}, AVG targets: "
                  f"{self.hstats[2] / self.total_rows:g}", file=sys.stderr)


def accumulate_hit_stats(hstats, distinct) -> None:
    """Fold a batch's distinct-hit-target counts into the [min, max,
    sum] triple (reference extended-mode stats, CuCLARK_hh.hh:2075-
    2080) — shared by CsvSink and the multihost non-native fallback so
    the two accumulations cannot drift apart."""
    if len(distinct) == 0:
        return
    lo = int(distinct.min())
    hstats[0] = lo if hstats[0] is None else min(hstats[0], lo)
    hstats[1] = max(hstats[1], int(distinct.max()))
    hstats[2] += int(distinct.sum())


def _shard_prefetch(*arrs):
    """Async D2H of each ADDRESSABLE shard — for results that are read
    back per shard (ShardedClassifier.local_rows), including global
    multi-process arrays that _host_prefetch must skip."""
    for a in arrs:
        if a is None:
            continue
        try:
            for s in a.addressable_shards:
                s.data.copy_to_host_async()
        except (AttributeError, RuntimeError):
            return


class Classifier:
    """Holds the device-resident DB and runs batched classification."""

    def __init__(self, db: KmerDB, cfg: ClassifyConfig | None = None,
                 len_bins=DEFAULT_LEN_BINS, mesh=None,
                 multihost: bool = False):
        from cuclark_tpu.memplan import resolve_table_budget_mb

        self.db = db
        self.cfg = cfg or ClassifyConfig()
        self.len_bins = tuple(sorted(len_bins))
        self.stream_parts = 1
        self._sharded = None
        self.mesh = None
        self.stash = None  # qs split mode: resident stash device array
        self._upload_pool = None  # lazy 1-thread part-upload executor
        self.stream_group_eff = self.cfg.stream_group
        # Effective per-device budget: explicit --max-table-mb, else the
        # measured free device memory (reference free-VRAM probe + RESERVED,
        # src/CuClarkDB.cu:540-574); None = unbounded (CPU hosts).
        self.table_budget_mb = resolve_table_budget_mb(self.cfg.max_table_mb)
        if mesh is not None:
            # Multi-chip: DB bucket ranges sharded over the mesh 'db'
            # axis, reads over 'data' (replaces the reference's per-GPU
            # part planning + merge trees, src/CuClarkDB.cu:540-574,
            # 929-994).  When the PER-DEVICE shard still exceeds the
            # memory budget, bucket-range parts stream host->mesh per
            # batch group — the reference's cycles x devices x parts
            # composition (src/CuClarkDB.cu:813-858).
            num_db = mesh.shape["db"]
            main_np, stash_np = db.split_tables()
            self.stream_parts = self._plan_parts(main_np, stash_np, num_db)
            if self.stream_parts > 1:
                self.mesh = mesh
                self.table = None
                self.np_table = np.ascontiguousarray(main_np)
                self.np_stash = (np.ascontiguousarray(stash_np)
                                 if stash_np is not None else None)
                self._stash_part = None  # uploaded lazily
                self._mesh_part_step = None  # built lazily
                self._mesh_part_step_stash = None
                self.stream_group_eff = self._effective_stream_group()
                return
            from cuclark_tpu.parallel.mesh import ShardedClassifier

            self._sharded = ShardedClassifier(
                db, mesh, with_labels=self.cfg.extended,
                multihost=multihost)
            self.table = self._sharded.table
            return
        # DB streaming decision (reference swap-cycle analog): if the
        # table exceeds the device budget, keep it host-side and stream
        # power-of-two bucket-range parts per batch group.  qs split
        # mode streams MAIN rows only; the small stash stays resident.
        main_np, stash_np = db.split_tables()
        self.stream_parts = self._plan_parts(main_np, stash_np, 1)
        if self.stream_parts > 1:
            self.table = None
            self.np_table = np.ascontiguousarray(main_np)
            self.np_stash = (np.ascontiguousarray(stash_np)
                             if stash_np is not None else None)
            self._stash_part = None  # uploaded lazily
            self.stream_group_eff = self._effective_stream_group()
        else:
            self.table = jnp.asarray(main_np)
            self.stash = (jnp.asarray(stash_np)
                          if stash_np is not None else None)

    def close(self) -> None:
        """Release the part-upload worker thread (idle executor threads
        outlive garbage collection; a process that builds many
        streaming Classifiers would otherwise accumulate one blocked
        thread per instance)."""
        if self._upload_pool is not None:
            self._upload_pool.shutdown(wait=False)
            self._upload_pool = None

    def __del__(self):  # best effort; close() is the deliberate path
        try:
            self.close()
        except Exception:
            pass

    def _effective_stream_group(self) -> int:
        """Batch-group size for DB-part streaming: at least
        cfg.stream_group, grown to fill the device's free memory with
        on-device label accumulators so the table restreams as rarely
        as possible.  The reference re-queries ALL prepared batches per
        swap cycle (src/CuCLARK_hh.hh:1766-1774); this is the same idea
        bounded by device memory.  Sized against the worst-case per-batch
        footprint (MAX_BATCH_CELLS int32 accumulator + wire bytes), so
        mixed length bins can never overshoot; CPU/unknown devices keep
        the configured value."""
        from cuclark_tpu.memplan import device_memory_budget_mb

        base = self.cfg.stream_group
        dev_mb = device_memory_budget_mb()
        if dev_mb is None:
            return base
        per_batch = int(self.MAX_BATCH_CELLS * 4.5)  # acc + wire, bytes
        # PER-DEVICE residency: on a db-mesh each device holds only its
        # row shard of a part (and of the stash)
        num_db = self.mesh.shape["db"] if self.mesh is not None else 1
        part = self.np_table.nbytes // self.stream_parts // num_db
        stash = (self.np_stash.nbytes // num_db
                 if self.np_stash is not None else 0)
        avail = dev_mb * 1e6 - 2 * part - stash
        # NOT np.clip: with base > 512 numpy's a_min > a_max rule would
        # silently return 512 and break the "at least cfg.stream_group"
        # contract; an explicitly larger configured group is honored
        return max(base, min(int(avail // per_batch), 512))

    def _plan_parts(self, main_np, stash_np, num_db: int) -> int:
        """Streaming-part plan honoring the REAL device footprint: the
        part uploads are double-buffered (part p+1 transfers while part
        p computes, so TWO parts are resident at once) and in qs split
        mode the stash stays resident on top — both come off the budget
        and only the main rows are planned against the rest."""
        from cuclark_tpu.memplan import plan_stream_parts

        budget = self.table_budget_mb
        if budget is not None:
            if stash_np is not None:
                left = budget - stash_np.nbytes / num_db / 1e6
                # stash alone past the stated budget: the plan is
                # infeasible either way; keep the unadjusted budget
                # (best effort)
                budget = left if left > 0 else budget
            # halve for the double-buffered part uploads — but only
            # when streaming is needed at all (a resident table has no
            # double buffer)
            if plan_stream_parts(main_np.nbytes, budget, num_db,
                                 main_np.shape[0]) > 1:
                budget = budget / 2
        return plan_stream_parts(main_np.nbytes, budget, num_db,
                                 main_np.shape[0])

    def _bin_for(self, max_len: int) -> int:
        for b in self.len_bins:
            if max_len + 1 <= b:  # +1 so L >= k always and P >= 1
                return b
        return int(np.ceil((max_len + 1) / 128) * 128)

    def _put_wire(self, wire):
        """Start the host->device transfer of a wire batch.

        Called from the producer (prefetch) thread so the H2D copy
        overlaps result formatting of earlier batches; jnp.asarray in
        the consumer then passes the device arrays through untouched.
        Sharded/streaming paths keep host arrays — they place with
        their own shardings per part/mesh."""
        if self._sharded is not None or self.stream_parts > 1:
            return wire
        p2, vb = wire
        return jnp.asarray(p2), jnp.asarray(vb)

    def _device_step(self, wire):
        """Dispatch one device step on a wire-format batch.

        wire: (packed2 uint8 [R, Lp/4], vbits uint8 [R, Lp/8]) from
        fast_parse.pack_block2_dispatch / codec.pack_codes — packing
        happens in the producer (prefetch) thread so it overlaps device
        compute and CSV formatting."""
        db = self.db
        packed2, vbits = wire
        if self._sharded is not None:
            nd = self._sharded.num_data
            if packed2.shape[0] % nd:
                pad = nd - packed2.shape[0] % nd
                # zero validity bits -> all-INVALID padding reads
                packed2 = np.pad(packed2, ((0, pad), (0, 0)))
                vbits = np.pad(vbits, ((0, pad), (0, 0)))
            return self._sharded.step_packed(packed2, vbits)
        return classify_step_packed(
            self.table,
            jnp.asarray(packed2),
            jnp.asarray(vbits),
            k=db.k,
            nb_bits=db.nb_bits,
            slots=db.slots,
            num_choices=db.num_choices,
            with_labels=self.cfg.extended,
            layout=db.layout,
            seed=db.seed,
            stash_bits=db.stash_bits,
            stash=self.stash,
        )

    # ---------- file fast path ----------

    def _scan_for_classify(self, path, paired_path, skip, num_hosts, host_id):
        """Scan + shard + align a classify job's input file(s)."""
        from cuclark_tpu.io import fast_parse

        rec_lo = 0
        n1_total = None  # full record count of file 1 (paired check)
        if num_hosts > 1 and paired_path is None:
            from cuclark_tpu.parallel import multihost

            # per-host byte-range I/O: read only this host's slice
            buf, name_s, name_e, seq_s, seq_e = multihost.read_host_slice(
                path, num_hosts, host_id)
        else:
            buf = _read_file_bytes(path)
            name_s, name_e, seq_s, seq_e = fast_parse.scan_file(buf)
            n1_total = len(name_s)
            if num_hosts > 1:
                # paired mode shards by record index so both mate files
                # stay aligned
                n_rec = len(name_s)
                per = n_rec // num_hosts
                rec_lo = per * host_id
                rec_hi = n_rec if host_id == num_hosts - 1 else per * (host_id + 1)
                name_s, name_e = name_s[rec_lo:rec_hi], name_e[rec_lo:rec_hi]
                seq_s, seq_e = seq_s[rec_lo:rec_hi], seq_e[rec_lo:rec_hi]
        if skip:
            name_s, name_e = name_s[skip:], name_e[skip:]
            seq_s, seq_e = seq_s[skip:], seq_e[skip:]
        if paired_path is not None:
            buf2 = _read_file_bytes(paired_path)
            ns2, ne2, seq_s2, seq_e2 = fast_parse.scan_file(buf2)
            # mergePairedFiles parity (src/file.cc:205-268): hard error
            # on differing record counts or mismatched mate ids instead
            # of silently zipping by order.
            if n1_total is not None and n1_total != len(seq_s2):
                # compare FULL file counts so truncation hard-errors on
                # sharded/resumed runs too, not only single-host ones
                raise ValueError(
                    f"paired files have different record counts: "
                    f"{path} has {n1_total}, {paired_path} has "
                    f"{len(seq_s2)}")
            bad = fast_parse.first_mate_mismatch(
                buf, name_s, name_e,
                buf2, ns2[rec_lo + skip:], ne2[rec_lo + skip:])
            if bad >= 0:
                n1 = buf[name_s[bad]:name_e[bad]].tobytes().decode(
                    "ascii", "replace")
                i2 = rec_lo + skip + bad
                n2 = buf2[ns2[i2]:ne2[i2]].tobytes().decode(
                    "ascii", "replace")
                raise ValueError(
                    f"read id does not match between files at record "
                    f"{i2}: {n1!r} vs {n2!r}")
            seq_s2, seq_e2 = seq_s2[rec_lo + skip:], seq_e2[rec_lo + skip:]
            n = min(len(seq_s), len(seq_s2))
            name_s, name_e = name_s[:n], name_e[:n]
            seq_s, seq_e = seq_s[:n], seq_e[:n]
            seq_s2, seq_e2 = seq_s2[:n], seq_e2[:n]
        else:
            buf2, seq_s2, seq_e2 = None, None, None
        return buf, buf2, name_s, name_e, seq_s, seq_e, seq_s2, seq_e2

    # Device-memory guard: batch_rows x padded_length is capped so a
    # stretch of very long reads (nanopore-scale) shrinks the batch
    # instead of exploding the padded code matrix / label arrays.
    MAX_BATCH_CELLS = 65536 * 512

    def _packed_batches(self, buf, buf2, name_s, name_e, seq_s, seq_e,
                        seq_s2, seq_e2):
        """Yield ((packed2, vbits), (ns, ne), lengths, cnt) batches in
        the 2-bit wire format (codec.pack_codes layout)."""
        from cuclark_tpu.io import fast_parse

        paired = buf2 is not None
        B = self.cfg.batch_reads
        raw_len = (seq_e - seq_s)
        if paired:
            raw_len = raw_len + (seq_e2 - seq_s2) + 1
        lo = 0
        n_rec = len(seq_s)
        while lo < n_rec:
            hi = min(lo + B, n_rec)
            # shrink the batch while its padded bin would blow the cell cap
            while hi - lo > 1:
                bin_len = self._bin_for(int(raw_len[lo:hi].max(initial=1)))
                if (hi - lo) * bin_len <= self.MAX_BATCH_CELLS:
                    break
                hi = lo + max(1, self.MAX_BATCH_CELLS // bin_len)
            cnt = hi - lo
            L = self._bin_for_range(
                buf, seq_s[lo:hi], seq_e[lo:hi], buf2,
                None if buf2 is None else seq_s2[lo:hi],
                None if buf2 is None else seq_e2[lo:hi])
            if paired:
                # fused mate1+N+mate2 wire packing (native when built;
                # replaces the pack + shift-merge + re-pack detour)
                p2, vb, lengths = fast_parse.pack_block2_paired_dispatch(
                    buf, seq_s[lo:hi], seq_e[lo:hi],
                    buf2, seq_s2[lo:hi], seq_e2[lo:hi], L, n_rows=cnt)
                wire = (p2, vb)
            else:
                p2, vb, lengths = fast_parse.pack_block2_dispatch(
                    buf, seq_s[lo:hi], seq_e[lo:hi], L, n_rows=cnt)
                wire = (p2, vb)
            yield wire, (name_s[lo:hi], name_e[lo:hi]), lengths, cnt
            lo = hi

    def classify_file(self, path, paired_path=None, skip: int = 0,
                      num_hosts: int = 1, host_id: int = 0):
        """Yield result rows for a whole FASTA/FASTQ file (optionally a
        paired mate file merged with a joining N).

        skip: number of leading records to skip (resume support).
        num_hosts/host_id: process only this host's record shard
        (multi-host data parallelism; shards concatenate in rank order).
        """
        from cuclark_tpu.io import fast_parse

        buf, buf2, *scan = self._scan_for_classify(
            path, paired_path, skip, num_hosts, host_id)
        paired = buf2 is not None

        def packed():
            for wire, (ns, ne), lengths, cnt in self._packed_batches(
                    buf, buf2, *scan):
                names = fast_parse.names_of(buf, ns, ne)
                yield self._put_wire(wire), names, lengths, cnt

        if self.stream_parts > 1:
            group = []
            for pb in _prefetch(packed()):
                group.append(pb)
                if len(group) >= self.stream_group_eff:
                    yield from self._classify_group_streaming(group, paired)
                    group = []
            if group:
                yield from self._classify_group_streaming(group, paired)
            return

        from collections import deque

        # keep a few batches in flight so host packing/formatting and
        # transfers overlap device compute (the reference's pipeline
        # scheduler role, src/CuCLARK_hh.hh:1738-1761)
        inflight = deque()
        for wire, names, lengths, cnt in _prefetch(packed()):
            out = self._device_step(wire)  # async dispatch
            _host_prefetch(out[0], out[1])
            inflight.append((out[0], out[1], names, lengths, cnt))
            if len(inflight) > 3:
                yield from self._emit(*inflight.popleft(), paired=paired)
        while inflight:
            yield from self._emit(*inflight.popleft(), paired=paired)

    def classify_file_to_csv(self, path, out_path, paired_path=None,
                             skip: int = 0, num_hosts: int = 1,
                             host_id: int = 0, append: bool = False) -> int:
        """Classify a file straight into a CLARK CSV using the native
        row formatter — the fast path for the CLI.  Falls back to the
        per-row dict path when the native module or the resident-table
        mode is unavailable.  Returns the number of reads written."""
        from cuclark_tpu import native
        from cuclark_tpu.io.csv_out import write_results

        if not native.available():
            rows = self.classify_file(path, paired_path, skip=skip,
                                      num_hosts=num_hosts, host_id=host_id)
            n = 0
            hstats = [None, 0, 0]  # same triple CsvSink accumulates

            def counted(it):
                nonlocal n
                for r in it:
                    n += 1
                    if "target_counts" in r:
                        accumulate_hit_stats(
                            hstats, np.array([len(r["target_counts"])]))
                    yield r

            if append:
                from cuclark_tpu.io.csv_out import format_row

                with open(out_path, "a") as f:
                    for row in counted(rows):
                        f.write(format_row(row, self.db.target_names,
                                           self.cfg.extended))
            else:
                write_results(out_path, counted(rows), self.db.target_names,
                              extended=self.cfg.extended)
            if self.cfg.extended and n:
                # reference extended-mode hit stats (CuCLARK_hh.hh:2075-2080)
                import sys

                print(f"MIN targets: {hstats[0] or 0}, MAX targets: "
                      f"{hstats[1]}, AVG targets: {hstats[2] / n:g}",
                      file=sys.stderr)
            return n

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        buf, buf2, *scan = self._scan_for_classify(
            path, paired_path, skip, num_hosts, host_id)
        paired = buf2 is not None
        extended = self.cfg.extended

        with open(out_path, "ab" if append else "wb") as f:
            sink = CsvSink(f, self.db, extended, paired)
            if not append:
                sink.write_header()

            def flush_one(out, ns, ne, lengths, cnt):
                labels_np = (np.asarray(out[1]) if extended else None)
                sink.flush(np.asarray(out[0]), labels_np, buf, ns, ne,
                           lengths, cnt)

            def put_batches():
                for wire, nsne, lengths, cnt in self._packed_batches(
                        buf, buf2, *scan):
                    yield self._put_wire(wire), nsne, lengths, cnt

            # Third pipeline stage: the D2H wait + CSV formatting + file
            # write run on a single writer thread (in submission order,
            # so rows stay ordered), overlapping the main thread's
            # device dispatch — the reference's "one thread starts
            # writing results while others still feed batches"
            # (src/CuCLARK_hh.hh:1755-1761).  numpy/native formatting
            # releases the GIL, so the overlap is real.
            with ThreadPoolExecutor(1) as writer:
                futs = deque()
                if self.stream_parts > 1:
                    # DB-streaming mode on the SAME native writer path:
                    # group batches, stream parts over the group, flush
                    # each batch's (already host-resident) results
                    def flush_group(group):
                        outs = self._stream_group(
                            [w for w, _, _, _ in group])
                        for ((_, (ns, ne), lengths, cnt),
                             out) in zip(group, outs):
                            futs.append(writer.submit(
                                flush_one, out, ns, ne, lengths, cnt))
                        while len(futs) > 3:
                            futs.popleft().result()

                    group = []
                    for pb in _prefetch(put_batches()):
                        group.append(pb)
                        if len(group) >= self.stream_group_eff:
                            flush_group(group)
                            group = []
                    if group:
                        flush_group(group)
                else:
                    for wire, (ns, ne), lengths, cnt in _prefetch(
                            put_batches()):
                        out = self._device_step(wire)
                        _host_prefetch(*out)
                        futs.append(writer.submit(
                            flush_one, out, ns, ne, lengths, cnt))
                        if len(futs) > 3:
                            futs.popleft().result()
                while futs:
                    futs.popleft().result()
        sink.print_hit_stats()
        return sink.total_rows

    def _stream_group(self, wires):
        """_stream_group_dev with blocking host readback (single-host
        callers)."""
        return [(np.asarray(r), np.asarray(l) if l is not None else None)
                for r, l in self._stream_group_dev(wires)]

    def _stream_group_dev(self, wires):
        """Stream DB parts over a group of packed batches (the reference
        multi-cycle path: swap part, re-query every batch,
        src/CuCLARK_hh.hh:1766-1774) and merge partial labels by sum.
        With a mesh, each part is additionally row-sharded over the 'db'
        axis and batches over 'data' (cycles x devices x parts); in
        multi-process runs each process feeds its local batch rows and
        its shard of every part (the lockstep protocol of
        parallel.multihost governs batch counts).

        Partial labels accumulate ON DEVICE (one readback per batch at
        group end, not one per part x batch) and part p+1's H2D upload
        is dispatched while part p computes — the async-swap overlap of
        the reference (src/CuClarkDB.cu:813-858).  Returns a list of
        (results, labels-or-None) DEVICE arrays per batch with async D2H
        copies already started on the addressable shards."""
        db = self.db
        P = self.stream_parts
        rows = self.np_table.shape[0] // P
        on_mesh = self.mesh is not None
        split = self.np_stash is not None
        nproc = jax.process_count()

        def pack_dev(wire):
            p2, vb = wire
            if not on_mesh:
                return jnp.asarray(p2), jnp.asarray(vb)
            # local rows must divide this process's slice of 'data'
            nd_local = max(1, self.mesh.shape["data"] // nproc)
            if p2.shape[0] % nd_local:
                pad = nd_local - p2.shape[0] % nd_local
                p2 = np.pad(p2, ((0, pad), (0, 0)))
                vb = np.pad(vb, ((0, pad), (0, 0)))
            from jax.sharding import NamedSharding, PartitionSpec as Pspec

            sh = NamedSharding(self.mesh, Pspec("data", None))
            if nproc > 1:
                return (jax.make_array_from_process_local_data(sh, p2),
                        jax.make_array_from_process_local_data(sh, vb))
            return jax.device_put(p2, sh), jax.device_put(vb, sh)

        # transfer each batch once; only DB parts restream per cycle
        dev = [pack_dev(w) for w in wires]
        part_sh = None
        if on_mesh:
            from jax.sharding import NamedSharding, PartitionSpec as Pspec

            if self._mesh_part_step is None:
                from cuclark_tpu.parallel.mesh import build_sharded_probe_part

                self._mesh_part_step = build_sharded_probe_part(
                    self.mesh, k=db.k, nb_bits=db.nb_bits, slots=db.slots,
                    num_choices=db.num_choices, nb_part=rows,
                    layout=db.layout, seed=db.seed,
                    stash_bits=db.stash_bits,
                    with_stash=False, skip_stash=split)
                if split:
                    self._mesh_part_step_stash = build_sharded_probe_part(
                        self.mesh, k=db.k, nb_bits=db.nb_bits,
                        slots=db.slots, num_choices=db.num_choices,
                        nb_part=rows, layout=db.layout, seed=db.seed,
                        stash_bits=db.stash_bits, with_stash=True)
            part_sh = NamedSharding(self.mesh, Pspec("db", None))

        def put_rows(arr_np):
            """Row-shard a host array over 'db' (multi-process: every
            process holds the full array, materializes its shards)."""
            if not on_mesh:
                return jnp.asarray(arr_np)
            if nproc > 1:
                return jax.make_array_from_callback(
                    arr_np.shape, part_sh, lambda idx: arr_np[idx])
            return jax.device_put(arr_np, part_sh)

        def upload(p):
            return put_rows(self.np_table[p * rows:(p + 1) * rows])

        if split and self._stash_part is None:
            # qs split mode: the small stash stays device-resident across
            # all parts/groups and is probed on part 0's call only
            self._stash_part = put_rows(self.np_stash)

        # Part p+1 uploads on a dedicated thread while part p's probes
        # dispatch: a device_put can block its CALLING thread for the
        # whole transfer, which would serialize uploads with compute
        # dispatch and push the pass toward upload+compute instead of
        # max(upload, compute) — the async-swap overlap of the
        # reference (src/CuClarkDB.cu:813-858), done host-side.  Only
        # the put runs off-thread; every jitted step call stays on the
        # main thread in program order (multi-process lockstep safety).
        if self._upload_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._upload_pool = ThreadPoolExecutor(
                1, thread_name_prefix="cuclark-part-upload")
        acc = [None] * len(dev)
        nxt = self._upload_pool.submit(upload, 0)
        for p in range(P):
            part = nxt.result()
            nxt = (self._upload_pool.submit(upload, p + 1)
                   if p + 1 < P else None)
            for gi, (p2, vb) in enumerate(dev):
                if on_mesh:
                    if split and p == 0:
                        (lab,) = self._mesh_part_step_stash(
                            part, self._stash_part, p2, vb,
                            jnp.int32(p * rows))
                    else:
                        (lab,) = self._mesh_part_step(part, p2, vb,
                                                      jnp.int32(p * rows))
                else:
                    lab = probe_part_step(
                        part, p2, vb, jnp.int32(p * rows),
                        k=db.k, nb_bits=db.nb_bits, slots=db.slots,
                        num_choices=db.num_choices, nb_local=rows,
                        layout=db.layout, seed=db.seed,
                        stash_bits=db.stash_bits,
                        stash=(self._stash_part if split and p == 0
                               else None),
                        skip_stash=split and p > 0,
                    )
                acc[gi] = lab if acc[gi] is None else acc[gi] + lab
            del part
        outs = []
        for a in acc:
            r = score_step(a)
            lab_dev = a if self.cfg.extended else None
            _host_prefetch(r, lab_dev)
            _shard_prefetch(r, lab_dev)
            outs.append((r, lab_dev))
        return outs

    def _classify_group_streaming(self, group, paired: bool):
        """Dict-row wrapper over _stream_group for the iterator paths."""
        outs = self._stream_group([w for w, _, _, _ in group])
        for (_, names, lengths, cnt), (results, labels_np) in zip(group,
                                                                  outs):
            yield from self._emit_np(results, labels_np, names, lengths,
                                     cnt, paired)

    def _bin_for_range(self, buf, s, e, buf2, s2, e2) -> int:
        if buf2 is not None:
            # max of the PER-RECORD combined lengths — the same metric
            # the MAX_BATCH_CELLS shrink loop uses; summing separate
            # maxima could pick a bin up to 2x larger and overshoot the
            # cell cap when mate lengths vary
            mx = int(((e - s) + (e2 - s2) + 1).max(initial=1))
        else:
            mx = int((e - s).max(initial=1))
        return max(self._bin_for(mx), self.db.k)

    def _emit(self, results_dev, labels_dev, names, lengths, count,
              paired: bool):
        results = np.asarray(results_dev)
        labels_np = np.asarray(labels_dev) if labels_dev is not None else None
        yield from self._emit_np(results, labels_np, names, lengths, count,
                                 paired)

    def _emit_np(self, results, labels_np, names, lengths, count,
                 paired: bool, counts=None):
        results = results[:count]  # drop mesh data-axis padding rows
        lengths = lengths[:count]
        total, ibest, best, isecond, second = (results[:, i] for i in range(5))
        norm, gamma, conf = score.gamma_confidence(
            total, best, second, lengths, self.db.k, paired
        )
        if counts is None and labels_np is not None:
            counts = dense_counts(labels_np[:count], self.db.num_targets)
        for i in range(count):
            row = {
                "name": names[i],
                "length": int(norm[i]),
                "gamma": float(gamma[i]),
                "total": int(total[i]),
                "index_best": int(ibest[i]),
                "best": int(best[i]),
                "index_second": int(isecond[i]),
                "second": int(second[i]),
                "confidence": float(conf[i]),
            }
            if counts is not None:
                (t,) = np.nonzero(counts[i])
                row["target_counts"] = dict(
                    zip(t.tolist(), counts[i, t].tolist()))
            yield row

    # ---------- record-iterator path ----------

    def _record_batches(self, records):
        """Group records into batches honoring BOTH caps: count
        (batch_reads) and padded cells (MAX_BATCH_CELLS) — long records
        shrink the batch instead of exploding the padded device arrays,
        matching the file path's shrink loop."""
        batch, max_len = [], 1
        for rec in records:
            new_max = max(max_len, len(rec[1]), 1)
            if batch and (len(batch) >= self.cfg.batch_reads
                          or (len(batch) + 1) * self._bin_for(new_max)
                          > self.MAX_BATCH_CELLS):
                yield batch
                batch, new_max = [], max(len(rec[1]), 1)
            batch.append(rec)
            max_len = new_max
        if batch:
            yield batch

    def classify_records(self, records, paired: bool = False):
        """records: iterable of (name, seq_bytes).

        Yields per-read result dicts in input order.
        """
        if self.stream_parts > 1:
            yield from self._classify_records_streaming(records, paired)
            return
        inflight = None
        for batch in self._record_batches(records):
            inflight, out = self._dispatch_batch(batch, inflight, paired)
            yield from out
        if inflight is not None:
            yield from self._emit(*inflight, paired=paired)

    def _wire_records(self, batch):
        """Pack (name, seq) records straight to the wire format through
        the fused native packer (one concat buffer + offset arrays) —
        the record-iterator paths' version of the file fast path; numpy
        fallback inside pack_block2_dispatch is bit-identical."""
        from cuclark_tpu.io import fast_parse

        max_len = max((len(s) for _, s in batch), default=1)
        L = max(self._bin_for(max_len), self.db.k)
        seqs = [s if isinstance(s, bytes) else bytes(s)
                for _, s in batch]
        buf = np.frombuffer(b"".join(seqs), np.uint8)
        ln = np.array([len(s) for s in seqs], dtype=np.int64)
        ends = np.cumsum(ln)
        p2, vb, lengths = fast_parse.pack_block2_dispatch(
            buf, ends - ln, ends, L, n_rows=len(batch))
        names = [n for n, _ in batch]
        return (p2, vb), names, lengths, len(batch)

    def _classify_records_streaming(self, records, paired: bool):
        group = []
        for batch in self._record_batches(records):
            group.append(self._wire_records(batch))
            if len(group) >= self.stream_group_eff:
                yield from self._classify_group_streaming(group, paired)
                group = []
        if group:
            yield from self._classify_group_streaming(group, paired)

    def _dispatch_batch(self, batch, inflight, paired: bool):
        wire, names, lengths, count = self._wire_records(batch)
        out = self._device_step(wire)
        _host_prefetch(out[0], out[1])
        prev_rows = (
            self._emit(*inflight, paired=paired) if inflight is not None else iter(())
        )
        return (out[0], out[1], names, lengths, count), prev_rows


def dense_counts(labels_np: np.ndarray, n_targets: int) -> np.ndarray:
    """Per-read dense target hit counts, vectorized for a whole batch.

    labels_np: int32 [R, P] per-window labels (0 = miss).  Returns
    uint32 [R, n_targets+1] (column 0 unused) — the dense columns the
    reference reconstructs per read from sparse rows
    (src/CuCLARK_hh.hh:2014-2031), built here with ONE bincount over
    the batch instead of a per-read unique loop."""
    R, P = labels_np.shape
    T1 = n_targets + 1
    out = np.empty((R, T1), np.uint32)
    # block the rows so the int64 bincount intermediate stays bounded
    # (~128 MB) even at MTRGTS-scale target sets; the uint32 output is
    # the inherent cost of extended mode's dense columns
    block = max(1, (1 << 24) // T1)
    for lo in range(0, R, block):
        sub = labels_np[lo:lo + block]
        r = sub.shape[0]
        flat = sub.ravel()
        m = flat > 0
        rid = np.repeat(np.arange(r, dtype=np.int64), P)[m]
        key = rid * T1 + flat[m].astype(np.int64)
        c = np.bincount(key, minlength=r * T1)
        out[lo:lo + r] = c.reshape(r, T1).astype(np.uint32)
    return out


def _prefetch(gen, depth: int = 2):
    """Run a generator in a background thread with a bounded queue.

    The packer's hot loops (numpy/native) release the GIL, so scanning
    and packing batch i+1 genuinely overlaps device compute and CSV
    formatting of batch i — the role of the reference's OpenMP batch
    threads (src/CuCLARK_hh.hh:1609-1763)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        # bounded put that gives up once the consumer is gone, so an
        # abandoned generator cannot pin the worker thread (and the
        # file-sized buffers its frames hold) forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # propagate into the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _read_file_bytes(path) -> np.ndarray:
    # plain files read straight into the array (np.fromfile measured
    # ~1.5x faster than read()+frombuffer: one copy less); gzip falls
    # back to the decompressing reader
    with open(path, "rb") as probe_f:
        is_gz = probe_f.read(2) == b"\x1f\x8b"
    if not is_gz:
        return np.fromfile(path, dtype=np.uint8)
    from cuclark_tpu.io.fasta import _open

    with _open(path) as f:
        data = f.read()
    return np.frombuffer(data, dtype=np.uint8)
