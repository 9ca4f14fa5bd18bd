"""qs (main + stash) table layout: exactness, stash placement, and
cross-layout equivalence.  The layout exists because at GB-scale every
random main-row gather is a cold DRAM page miss, so the second hash
choice is confined to a small stash section appended below the main
rows (one cold + one warm gather per probe)."""

import numpy as np

import jax.numpy as jnp

from cuclark_tpu import u64
from cuclark_tpu.config import DBConfig
from cuclark_tpu.hashdb import (
    KmerDB,
    build_table,
    choose_stash_bits,
    probe_np_qs,
)
from cuclark_tpu.probe import probe


def _db(n, k=31, seed=0, **kw):
    rng = np.random.default_rng(seed)
    km = np.unique(rng.integers(0, 1 << (2 * k - 2), size=n * 2,
                                dtype=np.uint64))[:n]
    labels = rng.integers(1, 300, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 300)]
    return build_table(km, labels, names,
                       DBConfig(k=k, layout="qs", **kw)), km, labels


def test_qs_roundtrip_and_misses():
    db, km, labels = _db(30000)
    assert db.layout == "qs" and db.table.shape[1] == 8
    assert db.total_rows == db.nb + (1 << db.stash_bits)
    hi, lo = u64.from_np64(km)
    got = np.asarray(probe(jnp.asarray(db.table), db.nb_bits, db.slots,
                           db.num_choices, hi, lo, layout="qs",
                           seed=db.seed, stash_bits=db.stash_bits))
    np.testing.assert_array_equal(got, labels.astype(np.int32))
    rng = np.random.default_rng(9)
    q = rng.integers(0, 1 << 60, size=20000, dtype=np.uint64)
    q = q[~np.isin(q, km)]
    hi, lo = u64.from_np64(q)
    got = np.asarray(probe(jnp.asarray(db.table), db.nb_bits, db.slots,
                           db.num_choices, hi, lo, layout="qs",
                           seed=db.seed, stash_bits=db.stash_bits))
    assert (got == 0).all()


def test_qs_stash_is_used_and_small():
    """At high effective load the stash really holds entries, and it is
    a small fraction of the main table (the whole point).  n is sized
    so nb_bits lands above the 17-bit floor with lambda ~3.4 — tiny DBs
    at low lambda legitimately have an empty stash."""
    db, km, labels = _db(1_800_000, target_load=0.9)
    stash_lab = db.table[db.nb:, 4:] & np.uint32(0xFFFF)
    assert (stash_lab > 0).any(), "no entries in the stash section"
    assert (1 << db.stash_bits) <= db.nb // 4
    np.testing.assert_array_equal(db.probe_np(km), labels.astype(np.int32))
    # every stash entry carries choice bit 1, every main entry bit 0
    main_meta = db.table[:db.nb, 4:]
    filled = (main_meta & np.uint32(0xFFFF)) > 0
    assert ((main_meta >> np.uint32(16)) & 1)[filled].max(initial=0) == 0
    sfill = stash_lab > 0
    assert (((db.table[db.nb:, 4:] >> np.uint32(16)) & 1)[sfill] == 1).all()


def test_choose_stash_bits_scales_with_overflow():
    # low load -> minimum stash; high load -> larger stash
    assert choose_stash_bits(4 * (1 << 20) // 4, 20) == 17
    lo = choose_stash_bits(int(1.9 * (1 << 25)), 25)
    hi = choose_stash_bits(int(3.4 * (1 << 25)), 25)
    assert hi > lo >= 17


def test_qs_numpy_matches_device():
    db, km, _ = _db(5000, seed=4)
    hi, lo = u64.from_np64(km)
    rng = np.random.default_rng(5)
    q = rng.integers(0, 1 << 60, size=5000, dtype=np.uint64)
    qhi, qlo = u64.from_np64(q)
    for HI, LO in ((hi, lo), (qhi, qlo)):
        HI, LO = np.asarray(HI), np.asarray(LO)
        np_lab = probe_np_qs(db.table, db.nb_bits, db.stash_bits, db.seed,
                             HI, LO)
        dev = np.asarray(probe(jnp.asarray(db.table), db.nb_bits, db.slots,
                               db.num_choices, jnp.asarray(HI),
                               jnp.asarray(LO), layout="qs", seed=db.seed,
                               stash_bits=db.stash_bits))
        np.testing.assert_array_equal(np_lab, dev)


def test_qs_save_load_items(tmp_path):
    db, km, labels = _db(2000)
    db.save(tmp_path / "db.npz")
    db2 = KmerDB.load(tmp_path / "db.npz")
    assert db2.layout == "qs" and db2.stash_bits == db.stash_bits
    np.testing.assert_array_equal(db2.probe_np(km), labels.astype(np.int32))
    ik, il = db2.items()
    o = np.argsort(ik)
    np.testing.assert_array_equal(ik[o], np.sort(km))
    np.testing.assert_array_equal(il[o], labels[np.argsort(km)])


def test_qs_numpy_fallback_build(monkeypatch):
    """The pure-numpy cuckoo build places identically-probing tables."""
    from cuclark_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    # lambda ~3.2 at the 17-bit floor so the stash actually fills
    db, km, labels = _db(420000, target_load=0.9)
    assert db.layout == "qs"
    stash_lab = db.table[db.nb:, 4:] & np.uint32(0xFFFF)
    assert (stash_lab > 0).any()
    np.testing.assert_array_equal(db.probe_np(km), labels.astype(np.int32))


def test_layouts_classify_identically_qs(tmp_path):
    """Same reads, same DB content, qs vs q4 -> identical rows."""
    import random

    from cuclark_tpu.config import ClassifyConfig
    from cuclark_tpu.pipeline import Classifier
    from cuclark_tpu.db_build.builder import build_db

    rng = random.Random(23)
    g = {t: "".join(rng.choice("ACGT") for _ in range(3000)) for t in (1, 2)}
    files = []
    for t in (1, 2):
        p = tmp_path / f"g{t}.fa"
        p.write_text(f">g{t}\n{g[t]}\n")
        files.append((str(p), f"S{t}"))
    reads = []
    for i in range(40):
        t = rng.randrange(1, 3)
        pos = rng.randrange(0, 2800)
        reads.append((f"r{i}", g[t][pos: pos + 120]))
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))

    rows = {}
    for layout in ("qs", "q4"):
        db = build_db(files, DBConfig(k=25, layout=layout))
        clf = Classifier(db, ClassifyConfig(batch_reads=16))
        rows[layout] = list(clf.classify_file(fq))
    assert rows["qs"] == rows["q4"]


def test_qs_sample_factor(tmp_path):
    db, km, labels = _db(80000)
    db.save(tmp_path / "db.npz")
    for s in (2, 4):
        dbs = KmerDB.load(tmp_path / "db.npz", sample_factor=s)
        got = dbs.probe_np(km)
        frac = (got > 0).mean()
        assert abs(frac - 1.0 / s) < 0.02, (s, frac)
        mask = got > 0
        np.testing.assert_array_equal(got[mask],
                                      labels[mask].astype(np.int32))


def _force_split(monkeypatch):
    """Make every qs table take the split probe path (main and stash as
    separate gather operands — production behavior at >= 256 MB)."""
    monkeypatch.setattr(KmerDB, "SPLIT_MIN_MAIN_MB", 0.0)


def _mk_inputs(tmp_path, seed=37):
    import random

    from cuclark_tpu.db_build.builder import build_db

    rng = random.Random(seed)
    g = "".join(rng.choice("ACGT") for _ in range(4000))
    p = tmp_path / "g.fa"
    p.write_text(f">g\n{g}\n")
    db = build_db([(str(p), "S1")], DBConfig(k=25, layout="qs"))
    reads = [g[i: i + 100] for i in
             (rng.randrange(0, 3900) for _ in range(30))]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(reads)))
    return db, fq


def test_qs_split_probe_matches_fused(tmp_path, monkeypatch):
    """Split-mode rows == fused-mode rows (same DB, same reads)."""
    from cuclark_tpu.config import ClassifyConfig
    from cuclark_tpu.pipeline import Classifier

    db, fq = _mk_inputs(tmp_path)
    assert not db.use_split_probe()
    fused = list(Classifier(db, ClassifyConfig(batch_reads=16))
                 .classify_file(fq))
    _force_split(monkeypatch)
    assert db.use_split_probe()
    clf = Classifier(db, ClassifyConfig(batch_reads=16))
    assert clf.stash is not None
    assert list(clf.classify_file(fq)) == fused


def test_qs_split_sharded_matches_single(tmp_path, monkeypatch):
    """Split mode on a (db x data) mesh == fused single-chip rows."""
    import jax

    from cuclark_tpu.config import ClassifyConfig
    from cuclark_tpu.pipeline import Classifier
    from cuclark_tpu.parallel.mesh import ShardedClassifier, make_mesh

    db, fq = _mk_inputs(tmp_path)
    base = list(Classifier(db, ClassifyConfig(batch_reads=16))
                .classify_file(fq))
    _force_split(monkeypatch)
    mesh = make_mesh(num_db=2, num_data=2, devices=jax.devices()[:4])
    clf = Classifier(db, ClassifyConfig(batch_reads=16), mesh=mesh)
    assert clf._sharded is not None and clf._sharded.stash is not None
    assert list(clf.classify_file(fq)) == base


def test_qs_split_streaming_matches_resident(tmp_path, monkeypatch):
    """Split mode with host-streamed main parts + resident stash ==
    fused resident rows."""
    from cuclark_tpu.config import ClassifyConfig
    from cuclark_tpu.pipeline import Classifier

    db, fq = _mk_inputs(tmp_path)
    base = list(Classifier(db, ClassifyConfig(batch_reads=16))
                .classify_file(fq))
    _force_split(monkeypatch)
    part_mb = db.nb * 32 / 4 / 1e6
    clf = Classifier(db, ClassifyConfig(batch_reads=16,
                                        max_table_mb=part_mb))
    assert clf.stream_parts > 1 and clf.np_stash is not None
    assert list(clf.classify_file(fq)) == base


def test_qs_streaming_parts_cover_stash(tmp_path):
    """Host-streamed bucket-range parts must cover the stash rows too:
    streaming a qs table split into parts equals the resident result."""
    import random

    from cuclark_tpu.config import ClassifyConfig
    from cuclark_tpu.pipeline import Classifier
    from cuclark_tpu.db_build.builder import build_db

    rng = random.Random(31)
    g = "".join(rng.choice("ACGT") for _ in range(4000))
    p = tmp_path / "g.fa"
    p.write_text(f">g\n{g}\n")
    db = build_db([(str(p), "S1")], DBConfig(k=25, layout="qs"))
    reads = [g[rng.randrange(0, 3800): rng.randrange(0, 3800) + 100]
             or "ACGT" for _ in range(30)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(reads)))
    clf_res = Classifier(db, ClassifyConfig(batch_reads=16))
    base = list(clf_res.classify_file(fq))
    part_mb = db.table.nbytes / 4 / 1e6
    clf_str = Classifier(db, ClassifyConfig(batch_reads=16,
                                            max_table_mb=part_mb))
    assert clf_str.stream_parts > 1
    assert list(clf_str.classify_file(fq)) == base
