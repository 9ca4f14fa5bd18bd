"""Benchmark: classified reads/sec on one chip, AT REPRESENTATIVE SCALE.

The HEADLINE number is the RefSeq-bacteria-shaped configuration of
BASELINE ladder 3 — k=31, 64M target-specific k-mers (a ~1 GB qs
table), 16,384 targets — the project's stated north star ("classified
reads/sec/chip on the RefSeq-bacteria DB", BASELINE.md).  Detail blocks
cover the full BASELINE ladder:

  small        4M k-mers / 67 MB (r01/r02 continuity)
  scale4g      256M k-mers — ladder 3's literal "~4 GB DB" point (the
               widened-main qs table)
  e2e_*        file -> CSV through the whole pipeline, median of 3
               passes with the spread recorded
  stream_ratio resident vs 8-part host-streamed DB (swap-cycle analog)
  mesh_e2e     single-process global-mesh path vs plain path
  light_paired ladder 2: light preset (k=27, gap=4) + paired mates
  build_spill  out-of-core DB build probe (fresh subprocess RSS)

Prints ONE JSON line:

  {"metric": "reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": R}

vs_baseline: the reference emits objects/min (src/CuCLARK_hh.hh:
1940-1943) but publishes no numbers in-tree (BASELINE.json.published is
empty).  We anchor on the CuCLARK paper's headline setup — ~1M reads
classified per minute per 6 GB GTX-class GPU against the bacteria DB —
i.e. BASELINE_READS_PER_SEC = 16667 reads/s/device.  vs_baseline is
our reads/s divided by that.

Timing policy (recorded in detail.timing): device steps are min over
CUCLARK_BENCH_REPS amortized passes; e2e numbers are the MEDIAN of 3
timed passes with min and per-pass times recorded.

Env knobs: CUCLARK_BENCH_READS, CUCLARK_BENCH_KMERS,
CUCLARK_BENCH_READLEN, CUCLARK_BENCH_TARGETS, CUCLARK_BENCH_REPS,
CUCLARK_BENCH_SCALE_KMERS, CUCLARK_BENCH_SCALE_TARGETS,
CUCLARK_BENCH_E2E_READS, CUCLARK_BENCH_4G_KMERS (0 disables scale4g),
CUCLARK_BENCH_STREAM (0 disables stream_ratio), CUCLARK_BENCH_MESH
(0 disables mesh_e2e), CUCLARK_BENCH_PAIRED_READS (0 disables
light_paired), CUCLARK_BENCH_BUILD_MB (spill probe; 0 disables).
"""

import gc
import json
import os
import statistics
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC = 16667.0


def _log(msg):
    print(f"[bench +{time.time() - _T0:.0f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()


def main():
    import jax
    import jax.numpy as jnp

    from cuclark_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()  # repeat runs skip the jit compiles

    from cuclark_tpu import codec
    from cuclark_tpu.config import ClassifyConfig, DBConfig
    from cuclark_tpu.hashdb import build_table
    from cuclark_tpu.pipeline import Classifier, classify_step_packed

    n_reads = int(os.environ.get("CUCLARK_BENCH_READS", 131072))
    n_kmers = int(os.environ.get("CUCLARK_BENCH_KMERS", 4_000_000))
    read_len = int(os.environ.get("CUCLARK_BENCH_READLEN", 150))
    n_targets = int(os.environ.get("CUCLARK_BENCH_TARGETS", 1024))
    reps = int(os.environ.get("CUCLARK_BENCH_REPS", 3))
    chunk = int(os.environ.get("CUCLARK_BENCH_CHUNK", 16384))
    scale_kmers = int(os.environ.get("CUCLARK_BENCH_SCALE_KMERS",
                                     64_000_000))
    scale_targets = int(os.environ.get("CUCLARK_BENCH_SCALE_TARGETS", 16384))
    g4_kmers = int(os.environ.get("CUCLARK_BENCH_4G_KMERS", 256_000_000))
    k = 31
    n_reads = (n_reads // chunk) * chunk or chunk

    rng = np.random.default_rng(0)
    detail = {
        "device": str(jax.devices()[0]).split(":")[0],
        "read_len": read_len,
        "timing": {"device_step": f"min_of_{reps}",
                   "e2e": "median_of_3"},
    }

    # --- synthetic reads: substrings of synthetic genomes ---
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
    # the production wire format: 2-bit packed codes + validity bitmask
    dev_chunks = [tuple(jnp.asarray(a)
                        for a in codec.pack_codes(codes[i: i + chunk]))
                  for i in range(0, n_reads, chunk)]

    def make_runner(db, table, chunks, stash=None):
        def run():
            # scalar checksum read back to the host: the host clock
            # stops only after every chunk has run
            acc = jnp.int32(0)
            for p2, vb in chunks:
                results, _ = classify_step_packed(
                    table, p2, vb, k=db.k, nb_bits=db.nb_bits,
                    slots=db.slots, num_choices=db.num_choices,
                    layout=db.layout, seed=db.seed,
                    stash_bits=db.stash_bits, stash=stash,
                    with_labels=False)
                acc = acc + results[:, 0].sum() % 97
            return float(np.asarray(acc))
        return run

    def time_reps(run, n):
        run()  # warmup/compile
        times = []
        for _ in range(reps):
            t0 = time.time()
            run()
            times.append(time.time() - t0)
        return n / min(times), min(times)

    def synth_db(num_kmers, num_targets, load, kcfg=None, cache_tag=None):
        """cache_tag: persist/reuse the built synthetic DB on disk —
        the 256M-kmer gen+build costs ~4 min and is identical across
        runs (seeded rng); only construction is skipped, never a
        measurement.  The one-time build cost rides along in a sidecar
        so cached runs still report the real number (VERDICT r04 ask
        #4a); db_build_s < 0 only when the sidecar is missing.
        Returns (db, build_s, cached)."""
        from pathlib import Path as _P

        from cuclark_tpu.hashdb import KmerDB

        cfg = kcfg or DBConfig(k=k, target_load=load)
        cache = None
        if cache_tag and int(os.environ.get("CUCLARK_BENCH_CACHE", 1)):
            import tempfile as _tf

            cache = (_P(_tf.gettempdir())
                     / f"cuclark_bench_{cache_tag}_{num_kmers}"
                       f"_{num_targets}_{cfg.k}.npz")
            if cache.exists():
                try:
                    db = KmerDB.load(cache)
                    meta = cache.with_suffix(".meta.json")
                    build_s = -1.0
                    if meta.exists():
                        build_s = float(json.loads(
                            meta.read_text()).get("build_s", -1.0))
                    return db, build_s, True
                except Exception:
                    cache.unlink()
        # dedicated, config-seeded rng: a cache hit skips the draws, so
        # using the shared stream would shift every later block's
        # randomness depending on cache state
        rng_db = np.random.default_rng((num_kmers, num_targets, cfg.k))
        km = rng_db.integers(0, 1 << 62, size=int(num_kmers * 1.05),
                             dtype=np.uint64)
        km = np.unique(codec.canonical_np(km, cfg.k))[:num_kmers]
        labels = rng_db.integers(1, num_targets + 1,
                                 size=len(km)).astype(np.uint32)
        names = ["NA"] + [f"T{i}" for i in range(1, num_targets + 1)]
        t0 = time.time()
        db = build_table(km, labels, names, cfg)
        dt = time.time() - t0
        if cache is not None:
            try:
                db.save(cache)
                cache.with_suffix(".meta.json").write_text(
                    json.dumps({"build_s": dt}))
            except Exception:
                pass
        return db, dt, False

    def step_block(db, build_s, n_label, cached=False):
        """Device-step measurement on the production probe mode."""
        main_np, stash_np = db.split_tables()
        tbl = jnp.asarray(main_np)
        stash_dev = jnp.asarray(stash_np) if stash_np is not None else None
        rps, dt = time_reps(make_runner(db, tbl, dev_chunks, stash_dev),
                            n_reads)
        block = {
            "db_kmers": int(db.num_kmers),
            "nb_bits": db.nb_bits,
            "stash_bits": db.stash_bits,
            "table_mb": round(db.table.nbytes / 1e6, 1),
            "db_build_s": round(build_s, 1),
            "split_probe": stash_dev is not None,
            "step_ms": round(dt / len(dev_chunks) * 1e3, 2),
            "reads_per_sec": round(rps, 1),
        }
        if cached:
            # table construction skipped this run; db_build_s is the
            # one-time cost recorded when the cache was built
            block["db_build_cached"] = True
        _log(f"{n_label}: {rps:,.0f} reads/s "
             f"({block['table_mb']} MB table)")
        del tbl, stash_dev
        gc.collect()
        return rps, block

    # --- HEADLINE: at-scale device step (RefSeq-bacteria-shaped) ---
    _log(f"building at-scale table ({scale_kmers} kmers)")
    db_s, scale_build, _ = synth_db(scale_kmers, scale_targets, 0.85)
    _log("at-scale warmup compile")
    rps_scale, blk = step_block(db_s, scale_build, "at-scale")
    detail.update({
        "n_reads": n_reads,
        "n_targets": scale_targets,
        "layout": db_s.layout,
        "kmer_probes_per_sec": round(rps_scale * (read_len - k + 1), 0),
    })
    detail.update({k_: v for k_, v in blk.items()
                   if k_ != "reads_per_sec"})
    detail["step_reads_per_sec"] = blk["reads_per_sec"]

    # --- small-table device step (r01/r02 headline config) ---
    _log("small-table step")
    db, build_s, _ = synth_db(n_kmers, n_targets, 0.7)
    _, small_blk = step_block(db, build_s, "small")
    small_blk["n_targets"] = n_targets
    detail["small"] = small_blk

    # --- end-to-end file -> CSV (host scan/pack/format included) ---
    e2e_reads = int(os.environ.get("CUCLARK_BENCH_E2E_READS", 500_000))
    import tempfile
    from pathlib import Path

    td_ctx = tempfile.TemporaryDirectory()
    td = Path(td_ctx.name)
    base = "ACGT"

    def write_fastq(path, rows):
        seq_bytes = np.frombuffer(base.encode(), np.uint8)[rows]
        qual = b"I" * rows.shape[1]
        with open(path, "wb") as f:
            blocks = []
            for i in range(rows.shape[0]):
                blocks.append(b"@r%d\n%s\n+\n%s\n"
                              % (i, seq_bytes[i].tobytes(), qual))
                if len(blocks) == 65536:
                    f.write(b"".join(blocks))
                    blocks = []
            f.write(b"".join(blocks))

    def e2e_times(clf, fq, out_csv, n_expect, passes=3, paired=None):
        clf.classify_file_to_csv(fq, out_csv, paired)  # warmup (compile)
        ts = []
        for _ in range(passes):
            t0 = time.time()
            n = clf.classify_file_to_csv(fq, out_csv, paired)
            ts.append(time.time() - t0)
            assert n == n_expect
        med = statistics.median(ts)
        return {
            "reads_per_sec": round(n_expect / med, 1),
            "objects_per_min": int(n_expect / med * 60),
            "best_reads_per_sec": round(n_expect / min(ts), 1),
            "pass_s": [round(t, 2) for t in ts],
        }

    def h2d_sample(mb=32):
        """One-shot host-to-device copy rate over PCIe, in MB/s,
        recorded beside the e2e numbers (random bytes, so no transfer
        path can compress them)."""
        big = rng.integers(0, 256, (mb, 1 << 20), dtype=np.uint8)
        t0 = time.time()
        jnp.asarray(big).block_until_ready()
        return round(mb / (time.time() - t0), 1)

    fq = td / "bench.fq"
    if e2e_reads:
        detail["h2d_mb_per_s_at_e2e"] = h2d_sample()
        starts_e = rng.integers(0, len(genome) - read_len, size=e2e_reads)
        write_fastq(fq, genome[starts_e[:, None]
                               + np.arange(read_len)[None, :]])
        for tag, e2e_db in (("e2e_scale", db_s), ("e2e_small", db)):
            _log(f"{tag}")
            clf = Classifier(e2e_db, ClassifyConfig(batch_reads=chunk))
            detail[tag] = e2e_times(clf, fq, td / "out.csv", e2e_reads)
            del clf
            gc.collect()
        detail["e2e_reads_per_sec"] = detail["e2e_scale"]["reads_per_sec"]

    # --- host-pipeline capacity, CHIP-FREE (VERDICT r04 ask #1):
    #     measures scan+pack (feed side) and CSV formatting (drain
    #     side) in isolation so "e2e >= 85% of the device step on a
    #     local host" is arithmetic, not an assertion.  The reference's
    #     equivalent overlap machinery: src/CuCLARK_hh.hh:1738-1761. ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_HOST", 1)):
        _log("host_pipeline (chip-free scan/pack/format/tally)")
        from cuclark_tpu import native as _native
        from cuclark_tpu.io import fast_parse

        raw = np.fromfile(fq, np.uint8)

        def _min_time(fn, reps_h=3):
            fn()  # warmup (allocations, lazy native build)
            best = float("inf")
            for _ in range(reps_h):
                t0 = time.time()
                fn()
                best = min(best, time.time() - t0)
            return best

        scan_s = _min_time(lambda: fast_parse.scan_file(raw))
        ns_h, ne_h, ss_h, se_h = fast_parse.scan_file(raw)
        nrec = len(ss_h)

        def _pack_all():
            for i in range(0, nrec, chunk):
                fast_parse.pack_block2_dispatch(
                    raw, ss_h[i: i + chunk], se_h[i: i + chunk],
                    read_len, n_rows=chunk)

        pack_s = _min_time(_pack_all)

        # drain side: format synthetic-but-plausible results for every
        # read through the production formatter
        rng_h = np.random.default_rng(7)
        norm_h = np.full(nrec, read_len, np.int64)
        gamma_h = rng_h.random(nrec)
        ibest_h = rng_h.integers(0, scale_targets + 1,
                                 nrec).astype(np.int32)
        best_h = rng_h.integers(0, 120, nrec).astype(np.int32)
        isecond_h = np.zeros(nrec, np.int32)
        second_h = np.zeros(nrec, np.int32)
        conf_h = rng_h.random(nrec)
        use_native_h = _native.available()
        if use_native_h:
            tnb, tno = _native.pack_target_names(db_s.target_names)

            def _format_all():
                for i in range(0, nrec, chunk):
                    s = slice(i, min(i + chunk, nrec))
                    _native.format_rows(
                        norm_h[s], gamma_h[s], ibest_h[s], best_h[s],
                        isecond_h[s], second_h[s], conf_h[s],
                        raw, ns_h[s], ne_h[s], tnb, tno)

            fmt_s = _min_time(_format_all)
        else:
            fmt_s = float("inf")

        chain_s = scan_s + pack_s + fmt_s
        host_block = {
            "native": use_native_h,
            "n_reads": nrec,
            "scan_reads_per_sec": round(nrec / scan_s, 1),
            "pack_reads_per_sec": round(nrec / pack_s, 1),
            "format_rows_per_sec": round(nrec / fmt_s, 1),
            # serial worst case: the pipeline overlaps these stages
            # across threads, so real capacity is >= this number
            "serial_chain_reads_per_sec": round(nrec / chain_s, 1),
            "vs_device_step": round(
                nrec / chain_s / detail["step_reads_per_sec"], 2),
        }
        # downstream summarization rate (abundance tally over the e2e
        # CSV produced above)
        if use_native_h:
            csv_bytes = np.fromfile(td / "out.csv", np.uint8)
            nl0 = int(np.argmax(csv_bytes == ord("\n"))) + 1
            body = csv_bytes[nl0:]
            t_t = _min_time(lambda: _native.csv_tally(
                body, 8, 3, 7, 2, 0.0, 0.0), 2)
            _, _, rows_t = _native.csv_tally(body, 8, 3, 7, 2, 0.0, 0.0)
            host_block["tally_rows_per_min"] = int(rows_t / t_t * 60)
        detail["host_pipeline"] = host_block
        _log(f"host chain {host_block['serial_chain_reads_per_sec']:,.0f}"
             f" reads/s serial ({host_block['vs_device_step']}x device"
             f" step)")
        del raw
        gc.collect()

    # --- classification accuracy on wgsim-style error reads (the one
    #     non-parity correctness check; reference QA inputs are the
    #     HiSeq/MiSeq accuracy sets, data/README.md:1-21) ---
    acc_reads = int(os.environ.get("CUCLARK_BENCH_ACC_READS", 50_000))
    if acc_reads:
        _log(f"accuracy ({acc_reads} simulated reads, 1% sub + 0.2% "
             f"indel)")
        import random as _random

        from cuclark_tpu import simulate as _sim
        from cuclark_tpu.db_build.builder import (build_db,
                                                  parse_targets_file)

        _rng_py = _random.Random(13)
        acc_genomes = {
            f"G{t}": "".join(_rng_py.choice("ACGT")
                             for _ in range(200_000))
            for t in range(1, 9)}
        tlines = []
        for t, g in acc_genomes.items():
            p = td / f"acc_{t}.fa"
            p.write_text(f">{t}\n{g}\n")
            tlines.append(f"{p} {t}")
        (td / "acc_targets.txt").write_text("\n".join(tlines) + "\n")
        db_a = build_db(parse_targets_file(td / "acc_targets.txt"),
                        DBConfig(k=31, target_load=0.7))
        names_a, seqs_a = _sim.simulate_reads(
            acc_genomes, acc_reads, read_len, sub_rate=0.01,
            ins_rate=0.001, del_rate=0.001, seed=99)
        _sim.write_fastq(td / "acc.fq", names_a, seqs_a)
        clf_a = Classifier(db_a, ClassifyConfig(batch_reads=chunk))
        clf_a.classify_file_to_csv(td / "acc.fq", td / "acc.csv")
        res_a = _sim.evaluate_assignments(td / "acc.csv")
        o = res_a["overall"]
        detail["accuracy"] = {
            "n_reads": acc_reads,
            "sub_rate": 0.01, "indel_rate": 0.002,
            "db_kmers": int(db_a.num_kmers),
            "recall": round(o["recall"], 4),
            "precision": round(o["precision"], 4),
            "unclassified": round(o["unclassified"], 4),
            "min_target_recall": round(
                min(d["recall"] for d in res_a["per_target"].values()),
                4),
        }
        _log(f"accuracy: recall={o['recall']:.4f} "
             f"precision={o['precision']:.4f}")
        del db_a, clf_a
        gc.collect()

    # --- resident vs streamed DB at the 1 GB config (swap-cycle
    #     analog; round-2's promised "within ~2x" number) ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_STREAM", 1)):
        _log("stream_ratio (8-part host streaming)")
        s_reads = min(e2e_reads, 262144)
        fq_s = td / "stream.fq"
        starts_s = rng.integers(0, len(genome) - read_len, size=s_reads)
        write_fastq(fq_s, genome[starts_s[:, None]
                                 + np.arange(read_len)[None, :]])
        main_np, stash_np = db_s.split_tables()
        budget = (main_np.nbytes / 8
                  + (stash_np.nbytes if stash_np is not None else 0)) / 1e6
        clf = Classifier(db_s, ClassifyConfig(
            batch_reads=chunk, max_table_mb=budget + 1))

        # Streaming re-uploads the whole main table once per
        # stream_group batches, so the pass is bounded below by the
        # host-to-device copy rate.  Measure it immediately before AND
        # after the timed passes (random bytes) so the upload-bound
        # floor is taken beside the passes it bounds.
        def h2d_rate():
            h2d_mb = 64
            best = float("inf")
            for _ in range(2):
                big = rng.integers(0, 256, (h2d_mb, 1 << 20),
                                   dtype=np.uint8)
                t0 = time.time()
                jnp.asarray(big).block_until_ready()
                best = min(best, time.time() - t0)
            return h2d_mb / best

        jnp.asarray(np.ones(8, np.uint8)).block_until_ready()  # wake
        rate_before = h2d_rate()
        blk = e2e_times(clf, fq_s, td / "outs.csv", s_reads, passes=3)
        rate_after = h2d_rate()
        blk["stream_parts"] = clf.stream_parts
        blk["ratio_vs_resident"] = round(
            detail["e2e_scale"]["reads_per_sec"] / blk["reads_per_sec"], 2)
        blk["h2d_mb_per_s"] = round(min(rate_before, rate_after), 1)
        blk["h2d_mb_per_s_before"] = round(rate_before, 1)
        blk["h2d_mb_per_s_after"] = round(rate_after, 1)
        blk["stream_group"] = clf.stream_group_eff
        groups = -(-s_reads // (chunk * clf.stream_group_eff))
        blk["upload_gb_per_pass"] = round(
            groups * main_np.nbytes / 1e9, 2)
        # conservative floor: the SLOWER of the two link samples
        blk["upload_bound_s"] = round(
            groups * main_np.nbytes / 1e6 / blk["h2d_mb_per_s"], 1)
        blk["ratio_to_upload_bound"] = round(
            min(blk["pass_s"]) / max(blk["upload_bound_s"], 1e-9), 2)
        detail["stream_ratio"] = blk
        del clf, main_np, stash_np
        gc.collect()

    # --- global-mesh path vs plain path (single process; round-2's
    #     promised "within ~1.5x" number) ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_MESH", 1)):
        _log("mesh_e2e (global-mesh lockstep path)")
        from cuclark_tpu.parallel import multihost
        from cuclark_tpu.parallel.mesh import make_global_mesh

        mesh = make_global_mesh(1)
        cfgm = ClassifyConfig(batch_reads=chunk)
        engine = multihost.GlobalClassifier(db_s, cfgm, mesh=mesh)
        engine.classify_file_to_csv(fq, td / "outm.csv")  # warmup
        ts = []
        for _ in range(3):
            t0 = time.time()
            n = engine.classify_file_to_csv(fq, td / "outm.csv")
            ts.append(time.time() - t0)
            assert n == e2e_reads
        med = statistics.median(ts)
        detail["mesh_e2e"] = {
            "reads_per_sec": round(e2e_reads / med, 1),
            "pass_s": [round(t, 2) for t in ts],
            "ratio_vs_plain": round(
                detail["e2e_scale"]["reads_per_sec"] / (e2e_reads / med),
                2),
        }
        del engine
        gc.collect()

    del db
    # free the headline device state before the big configs
    gc.collect()

    # --- ladder 2: light preset + paired mates e2e ---
    paired_reads = int(os.environ.get("CUCLARK_BENCH_PAIRED_READS",
                                      1_000_000))
    if paired_reads:
        _log(f"light_paired ({paired_reads} mate pairs)")
        lk = 27
        lcfg = DBConfig(k=lk, gap=4, target_load=0.7)
        db_l, build_l, _ = synth_db(
            int(os.environ.get("CUCLARK_BENCH_LIGHT_KMERS", 32_000_000)),
            1024, 0.7, kcfg=lcfg)
        mlen = read_len // 2
        starts_p = rng.integers(0, len(genome) - read_len,
                                size=paired_reads)
        write_fastq(td / "r1.fq",
                    genome[starts_p[:, None] + np.arange(mlen)[None, :]])
        write_fastq(td / "r2.fq",
                    genome[starts_p[:, None]
                           + np.arange(mlen, read_len)[None, :]])
        clf = Classifier(db_l, ClassifyConfig(batch_reads=chunk))
        blk = e2e_times(clf, td / "r1.fq", td / "outp.csv", paired_reads,
                        paired=td / "r2.fq")
        blk.update({"k": lk, "gap": 4,
                    "db_kmers": int(db_l.num_kmers),
                    "table_mb": round(db_l.table.nbytes / 1e6, 1),
                    "db_build_s": round(build_l, 1),
                    "pairs_per_min": blk.pop("objects_per_min")})
        detail["light_paired"] = blk
        del clf, db_l
        gc.collect()

    del db_s
    gc.collect()

    # --- ladder 3 literal point: the ~4 GB DB (256M k-mers) ---
    if g4_kmers:
        _log(f"scale4g: building {g4_kmers} kmers (widened qs table)")
        db4, build4, cached4 = synth_db(g4_kmers, scale_targets, 0.85,
                                        cache_tag="4g")
        _log("scale4g warmup compile")
        _, blk4 = step_block(db4, build4, "scale4g", cached=cached4)
        blk4["n_targets"] = scale_targets
        detail["scale4g"] = blk4
        del db4
        gc.collect()

    td_ctx.cleanup()

    # --- out-of-core build probe (spill path; fresh-process RSS) ---
    # Default: the README's literal claim — 320M occurrences under a
    # 4 GB occurrence budget (VERDICT r04 ask #4b; occurrence bytes
    # 16 B/base = 5.1 GB > budget, so the disk-shard path runs).
    build_mb = int(os.environ.get("CUCLARK_BENCH_BUILD_MB", 320))
    if build_mb:
        ram_mb = int(os.environ.get("CUCLARK_BENCH_BUILD_RAM_MB", 4096))
        _log(f"spill-path build probe ({build_mb} Mbases / {ram_mb} MB "
             f"budget, subprocess)")
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts"))
        try:
            from bench_build_scale import run_subprocess as build_run

            detail["build_spill"] = build_run(build_mb, ram_mb=ram_mb)
        except Exception as e:  # pragma: no cover - probe is best-effort
            detail["build_spill"] = {"error": str(e)}

    out = {
        "metric": "reads_per_sec",
        "value": round(rps_scale, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps_scale / BASELINE_READS_PER_SEC, 3),
        "detail": detail,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
