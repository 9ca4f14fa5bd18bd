"""Per-host input sharding: every read owned by exactly one host, in order."""

import random

import numpy as np
import pytest

from cuclark_tpu.io import fast_parse
from cuclark_tpu.parallel import multihost


def _check_partition(buf, num_hosts):
    full = fast_parse.scan_file(buf)
    got_names = []
    for h in range(num_hosts):
        ns, ne, ss, se = multihost.shard_reads_for_host(buf, num_hosts, h)
        got_names.extend(fast_parse.names_of(buf, ns, ne))
    want_names = fast_parse.names_of(buf, full[0], full[1])
    assert got_names == want_names


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 7])
def test_fastq_partition(num_hosts):
    rng = random.Random(num_hosts)
    recs = []
    for i in range(50):
        L = rng.randrange(30, 120)
        seq = "".join(rng.choice("ACGT") for _ in range(L))
        # adversarial: quality line starting with '@' or '+'
        qual = ("@" if i % 3 == 0 else "+" if i % 3 == 1 else "I") + "I" * (L - 1)
        recs.append(f"@read{i} x\n{seq}\n+\n{qual}\n")
    buf = np.frombuffer("".join(recs).encode(), np.uint8)
    _check_partition(buf, num_hosts)


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_fasta_partition(num_hosts):
    rng = random.Random(num_hosts + 10)
    recs = []
    for i in range(40):
        L = rng.randrange(20, 300)
        seq = "".join(rng.choice("ACGT") for _ in range(L))
        # multi-line bodies
        body = "\n".join(seq[j: j + 60] for j in range(0, L, 60))
        recs.append(f">seq{i} d\n{body}\n")
    buf = np.frombuffer("".join(recs).encode(), np.uint8)
    _check_partition(buf, num_hosts)


def test_more_hosts_than_records():
    buf = np.frombuffer(b"@a\nACGT\n+\nIIII\n@b\nGGGG\n+\nIIII\n", np.uint8)
    _check_partition(buf, 6)


def test_cli_host_shards_concatenate(tmp_path):
    """Per-host CSV shards concatenated in rank order == full CSV."""
    import random

    from cuclark_tpu.cli import main

    rng = random.Random(77)
    g = "".join(rng.choice("ACGT") for _ in range(2500))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    (tmp_path / "targets.txt").write_text(f"{tmp_path}/g.fa T1\n")
    reads = []
    for i in range(25):
        pos = rng.randrange(0, 2400)
        reads.append((f"r{i}", g[pos: pos + 90]))
    (tmp_path / "r.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    main(["classify", "-D", str(tmp_path / "db"),
          "-O", str(tmp_path / "r.fq"), "-R", str(tmp_path / "full.csv")])
    full = (tmp_path / "full.csv").read_text().splitlines()
    parts = []
    for h in range(3):
        out = tmp_path / f"part{h}.csv"
        main(["classify", "-D", str(tmp_path / "db"),
              "-O", str(tmp_path / "r.fq"), "-R", str(out),
              "--num-hosts", "3", "--host-id", str(h)])
        parts.extend(out.read_text().splitlines()[1:])
    assert parts == full[1:]


def test_global_mesh_cli_matches_single_device(tmp_path):
    """--num-processes 1 routes through the global-mesh lockstep path
    (make_array_from_process_local_data feeding, db-axis psum) and must
    reproduce the plain single-device CSV byte-for-byte."""
    import random

    from cuclark_tpu.cli import main

    rng = random.Random(55)
    genomes = {t: "".join(rng.choice("ACGT") for _ in range(2500))
               for t in (1, 2)}
    lines = []
    for t, g in genomes.items():
        (tmp_path / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp_path}/g{t}.fa S{t}")
    (tmp_path / "targets.txt").write_text("\n".join(lines) + "\n")
    reads = []
    for i in range(37):  # odd count exercises the ragged final batch
        t = rng.randrange(1, 3)
        pos = rng.randrange(0, 2300)
        reads.append((f"r{i}_t{t}", genomes[t][pos: pos + 100]))
    (tmp_path / "r.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    main(["classify", "-D", str(tmp_path / "db"),
          "-O", str(tmp_path / "r.fq"), "-R", str(tmp_path / "plain.csv")])
    rc = main(["classify", "-D", str(tmp_path / "db"),
               "-O", str(tmp_path / "r.fq"),
               "-R", str(tmp_path / "global.csv"),
               "--num-processes", "1", "-b", "16"])
    assert rc == 0
    assert ((tmp_path / "global.csv").read_bytes()
            == (tmp_path / "plain.csv").read_bytes())


def test_global_mesh_function_with_db_axis(tmp_path):
    """classify_file_to_csv on a (data x db) global mesh (single
    process, 8 virtual devices) with a db axis > 1: psum-merged shards
    must match the plain path, extended mode included."""
    import random

    import jax

    from cuclark_tpu.config import ClassifyConfig, DBConfig
    from cuclark_tpu.db_build.builder import build_db
    from cuclark_tpu.io.csv_out import write_results
    from cuclark_tpu.parallel import multihost
    from cuclark_tpu.parallel.mesh import make_global_mesh
    from cuclark_tpu.pipeline import Classifier

    rng = random.Random(66)
    g = "".join(rng.choice("ACGT") for _ in range(3000))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    db = build_db([(str(tmp_path / "g.fa"), "T1")], DBConfig(k=21))
    # VARIABLE lengths: uniform reads produce identical result rows,
    # which masked a replica-duplication bug in local_rows (round 4)
    reads = [(f"r{i}", g[(p := rng.randrange(0, 2700)): p + 60 + 7 * i])
             for i in range(21)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))

    for extended in (False, True):
        cfg = ClassifyConfig(batch_reads=8, extended=extended)
        clf = Classifier(db, cfg)
        want = tmp_path / f"want{extended}.csv"
        write_results(want, clf.classify_file(fq), db.target_names,
                      extended=extended)
        got = tmp_path / f"got{extended}.csv"
        mesh = make_global_mesh(4, devices=jax.devices()[:8])
        n = multihost.classify_file_to_csv(db, cfg, fq, got, num_db=4,
                                           mesh=mesh)
        assert n == 21
        assert got.read_bytes() == want.read_bytes()


def test_two_process_distributed_cli(tmp_path):
    """REAL multi-process execution: two OS processes bring up
    jax.distributed (CPU backend, 4 virtual devices each), drive the
    actual --coordinator CLI path, and their .h000/.h001 shards must
    concatenate to the single-process CSV byte-for-byte."""
    import os
    import random
    import socket
    import subprocess
    import sys

    from cuclark_tpu.cli import main

    rng = random.Random(91)
    genomes = {t: "".join(rng.choice("ACGT") for _ in range(2500))
               for t in (1, 2)}
    lines = []
    for t, g in genomes.items():
        (tmp_path / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp_path}/g{t}.fa S{t}")
    (tmp_path / "targets.txt").write_text("\n".join(lines) + "\n")
    reads = []
    for i in range(41):  # odd count exercises ragged lockstep padding
        t = rng.randrange(1, 3)
        pos = rng.randrange(0, 2300)
        reads.append((f"r{i}_t{t}", genomes[t][pos: pos + 100]))
    (tmp_path / "r.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    # extended mode: exercises the cross-rank hit-stats allgather too
    main(["classify", "-D", str(tmp_path / "db"), "--extended",
          "-O", str(tmp_path / "r.fq"), "-R", str(tmp_path / "plain.csv")])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    driver = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; from cuclark_tpu.cli import main; "
        "raise SystemExit(main(sys.argv[1:]))"
    )
    out_csv = tmp_path / "mp.csv"
    procs = []
    for rank in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", driver,
             "classify", "-D", str(tmp_path / "db"), "--extended",
             "-O", str(tmp_path / "r.fq"), "-R", str(out_csv),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(rank),
             "-b", "16"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err.decode(errors="replace")[-2000:]
    merged = ((tmp_path / "mp.csv.h000").read_bytes()
              + (tmp_path / "mp.csv.h001").read_bytes())
    assert merged == (tmp_path / "plain.csv").read_bytes()
    # rank 0 prints ONE global hit-stats line covering BOTH ranks' rows
    # (single-host run prints the identical line for the same input)
    import re

    def stats_line(err_bytes):
        m = re.search(rb"MIN targets: .*", err_bytes)
        return m.group(0) if m else None

    line = stats_line(outs[0][2])
    assert line is not None
    assert stats_line(outs[1][2]) is None  # only rank 0 prints
    # the printed global stats must match recomputation over BOTH
    # ranks' rows (columns 1..n_targets of the extended CSV are the
    # per-target hit counts)
    rows = [r.split(",") for r in merged.decode().splitlines()[1:]]
    distinct = [sum(int(c) > 0 for c in r[1:3]) for r in rows]
    m = re.match(rb"MIN targets: (\d+), MAX targets: (\d+), "
                 rb"AVG targets: ([\d.]+)", line)
    assert m, line
    assert int(m.group(1)) == min(distinct)
    assert int(m.group(2)) == max(distinct)
    assert abs(float(m.group(3))
               - sum(distinct) / len(distinct)) < 1e-4


def test_two_process_distributed_paired(tmp_path):
    """Paired-end mates through the 2-process --coordinator path (record
    -index sharding keeps mates aligned across processes)."""
    import os
    import random
    import socket
    import subprocess
    import sys

    from cuclark_tpu.cli import main

    rng = random.Random(17)
    g = "".join(rng.choice("ACGT") for _ in range(2500))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    (tmp_path / "targets.txt").write_text(f"{tmp_path}/g.fa T1\n")
    r1, r2 = [], []
    for i in range(23):
        pos = rng.randrange(0, 2300)
        r1.append((f"p{i}", g[pos: pos + 60]))
        r2.append((f"p{i}", g[pos + 60: pos + 120]))
    for fn, rs in (("r1.fq", r1), ("r2.fq", r2)):
        (tmp_path / fn).write_text("".join(
            f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in rs))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    main(["classify", "-D", str(tmp_path / "db"),
          "-P", str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
          "-R", str(tmp_path / "plain.csv")])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    driver = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; from cuclark_tpu.cli import main; "
        "raise SystemExit(main(sys.argv[1:]))"
    )
    out_csv = tmp_path / "mp.csv"
    procs = [subprocess.Popen(
        [sys.executable, "-c", driver,
         "classify", "-D", str(tmp_path / "db"),
         "-P", str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
         "-R", str(out_csv),
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(rank), "-b", "16"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err.decode(errors="replace")[-2000:]
    merged = ((tmp_path / "mp.csv.h000").read_bytes()
              + (tmp_path / "mp.csv.h001").read_bytes())
    assert merged == (tmp_path / "plain.csv").read_bytes()


def test_global_mesh_streaming_matches_plain(tmp_path):
    """A tiny max_table_mb budget on the global-mesh path composes
    host-streamed bucket-range parts with the db-axis mesh (reference
    cycles x devices x parts, src/CuClarkDB.cu:540-574) and must stay
    byte-identical with the plain resident path."""
    import random

    import jax

    from cuclark_tpu.config import ClassifyConfig, DBConfig
    from cuclark_tpu.db_build.builder import build_db
    from cuclark_tpu.parallel import multihost
    from cuclark_tpu.parallel.mesh import make_global_mesh
    from cuclark_tpu.pipeline import Classifier

    rng = random.Random(88)
    g = "".join(rng.choice("ACGT") for _ in range(3000))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    db = build_db([(str(tmp_path / "g.fa"), "T1")], DBConfig(k=21))
    reads = [(f"r{i}", g[(p := rng.randrange(0, 2800)): p + 110])
             for i in range(27)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))

    want = tmp_path / "want.csv"
    Classifier(db, ClassifyConfig(batch_reads=8)).classify_file_to_csv(
        fq, want)

    tiny = db.table.nbytes / 2 / 4 / 1e6  # per-device shard / 2
    cfg = ClassifyConfig(batch_reads=8, stream_group=2, max_table_mb=tiny)
    mesh = make_global_mesh(2, devices=jax.devices()[:8])
    got = tmp_path / "got.csv"
    n = multihost.classify_file_to_csv(db, cfg, fq, got, num_db=2,
                                       mesh=mesh)
    assert n == 27
    assert got.read_bytes() == want.read_bytes()


def test_two_process_streaming_tiny_budget(tmp_path):
    """2-process --coordinator run under a tiny --max-table-mb: the
    multi-process path must fall back to mesh+streaming (not OOM or
    refuse) and shards must still concatenate byte-identically."""
    import os
    import random
    import socket
    import subprocess
    import sys

    from cuclark_tpu.cli import main

    rng = random.Random(23)
    g = "".join(rng.choice("ACGT") for _ in range(2500))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    (tmp_path / "targets.txt").write_text(f"{tmp_path}/g.fa T1\n")
    reads = []
    for i in range(29):
        pos = rng.randrange(0, 2300)
        reads.append((f"r{i}", g[pos: pos + 100]))
    (tmp_path / "r.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    main(["classify", "-D", str(tmp_path / "db"),
          "-O", str(tmp_path / "r.fq"), "-R", str(tmp_path / "plain.csv")])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    driver = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; from cuclark_tpu.cli import main; "
        "raise SystemExit(main(sys.argv[1:]))"
    )
    out_csv = tmp_path / "mp.csv"
    procs = [subprocess.Popen(
        [sys.executable, "-c", driver,
         "classify", "-D", str(tmp_path / "db"),
         "-O", str(tmp_path / "r.fq"), "-R", str(out_csv),
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(rank),
         "-b", "16", "--max-table-mb", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err.decode(errors="replace")[-2000:]
    merged = ((tmp_path / "mp.csv.h000").read_bytes()
              + (tmp_path / "mp.csv.h001").read_bytes())
    assert merged == (tmp_path / "plain.csv").read_bytes()


def test_global_classifier_engine_reuse(tmp_path):
    """One GlobalClassifier serves several input files (the table
    upload/trace happens once); outputs match per-file one-shot runs."""
    import random

    import jax

    from cuclark_tpu.config import ClassifyConfig, DBConfig
    from cuclark_tpu.db_build.builder import build_db
    from cuclark_tpu.parallel import multihost
    from cuclark_tpu.parallel.mesh import make_global_mesh

    rng = random.Random(99)
    g = "".join(rng.choice("ACGT") for _ in range(2500))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    db = build_db([(str(tmp_path / "g.fa"), "T1")], DBConfig(k=21))
    files = []
    for fi in range(3):
        reads = [(f"f{fi}r{i}", g[(p := rng.randrange(0, 2300)): p + 90])
                 for i in range(11 + fi)]
        fq = tmp_path / f"r{fi}.fq"
        fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                              for n, s in reads))
        files.append((fq, len(reads)))

    mesh = make_global_mesh(2, devices=jax.devices()[:8])
    cfg = ClassifyConfig(batch_reads=8)
    engine = multihost.GlobalClassifier(db, cfg, num_db=2, mesh=mesh)
    for fi, (fq, n_reads) in enumerate(files):
        got = tmp_path / f"got{fi}.csv"
        assert engine.classify_file_to_csv(fq, got) == n_reads
        want = tmp_path / f"want{fi}.csv"
        multihost.classify_file_to_csv(db, cfg, fq, want, num_db=2,
                                       mesh=mesh)
        assert got.read_bytes() == want.read_bytes()


def test_two_process_divergent_budgets_agree(tmp_path):
    """Processes whose live memory budgets DIFFER must agree on one
    memory plan (global min) instead of dispatching divergent
    collectives and hanging; outputs stay byte-identical."""
    import os
    import random
    import socket
    import subprocess
    import sys

    from cuclark_tpu.cli import main

    rng = random.Random(41)
    g = "".join(rng.choice("ACGT") for _ in range(2500))
    (tmp_path / "g.fa").write_text(f">g\n{g}\n")
    (tmp_path / "targets.txt").write_text(f"{tmp_path}/g.fa T1\n")
    reads = []
    for i in range(27):
        pos = rng.randrange(0, 2300)
        reads.append((f"r{i}", g[pos: pos + 100]))
    (tmp_path / "r.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    main(["build-db", "-T", str(tmp_path / "targets.txt"),
          "-D", str(tmp_path / "db"), "-k", "21"])
    main(["classify", "-D", str(tmp_path / "db"),
          "-O", str(tmp_path / "r.fq"), "-R", str(tmp_path / "plain.csv")])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    driver = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; from cuclark_tpu.cli import main; "
        "raise SystemExit(main(sys.argv[1:]))"
    )
    out_csv = tmp_path / "mp.csv"
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        # rank 0 "sees" 2 MB of device memory, rank 1 sees 5 MB: the
        # agreed plan must be the min (2 MB -> streaming) on BOTH
        env["CUCLARK_DEVICE_MB"] = "2" if rank == 0 else "5"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", driver,
             "classify", "-D", str(tmp_path / "db"),
             "-O", str(tmp_path / "r.fq"), "-R", str(out_csv),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(rank),
             "-b", "16"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err.decode(errors="replace")[-2000:]
    merged = ((tmp_path / "mp.csv.h000").read_bytes()
              + (tmp_path / "mp.csv.h001").read_bytes())
    assert merged == (tmp_path / "plain.csv").read_bytes()


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_read_host_slice_matches_full_scan(tmp_path, fmt):
    """Windowed per-host file reads partition records exactly like the
    in-memory shard over the full buffer, including with a slack small
    enough to force window growth."""
    rng = random.Random(61)
    recs = []
    for i in range(60):
        L = rng.randrange(30, 400)
        seq = "".join(rng.choice("ACGT") for _ in range(L))
        if fmt == "fastq":
            qual = ("@" if i % 2 else "+") + "I" * (L - 1)
            recs.append(f"@r{i} x\n{seq}\n+\n{qual}\n")
        else:
            body = "\n".join(seq[j: j + 60] for j in range(0, L, 60))
            recs.append(f">r{i} d\n{body}\n")
    data = "".join(recs).encode()
    p = tmp_path / f"in.{fmt}"
    p.write_bytes(data)
    buf = np.frombuffer(data, np.uint8)
    want = fast_parse.names_of(buf, *fast_parse.scan_file(buf)[:2])
    for num_hosts in (1, 2, 3, 5):
        for slack in (1 << 25, 64):  # tiny slack forces window growth
            got = []
            for h in range(num_hosts):
                w, ns, ne, ss, se = multihost.read_host_slice(
                    str(p), num_hosts, h, slack=slack)
                got.extend(fast_parse.names_of(w, ns, ne))
                # seq offsets must be valid within the window
                assert len(ss) == len(ns)
                if len(se):
                    assert int(se.max()) <= len(w)
            assert got == want, (num_hosts, slack)


def test_read_host_slice_gzip_fallback(tmp_path):
    import gzip

    rng = random.Random(62)
    recs = "".join(
        f"@g{i}\n{''.join(rng.choice('ACGT') for _ in range(80))}\n+\n"
        f"{'I' * 80}\n" for i in range(20))
    p = tmp_path / "in.fq.gz"
    p.write_bytes(gzip.compress(recs.encode()))
    buf = np.frombuffer(recs.encode(), np.uint8)
    want = fast_parse.names_of(buf, *fast_parse.scan_file(buf)[:2])
    got = []
    for h in range(3):
        w, ns, ne, _, _ = multihost.read_host_slice(str(p), 3, h)
        got.extend(fast_parse.names_of(w, ns, ne))
    assert got == want


def test_record_aligners_match_bruteforce():
    """The vectorized boundary aligners reproduce the per-byte
    reference algorithms at every offset of randomized FASTA/FASTQ
    buffers (they feed per-host byte-range sharding; a one-off error
    would silently duplicate or drop reads at shard boundaries)."""
    import random

    import numpy as np

    from cuclark_tpu.parallel import multihost

    def brute_fasta(buf, offset):
        n = len(buf)
        if offset == 0:
            return 0
        i = offset
        while i < n:
            if buf[i] == ord(">") and buf[i - 1] == ord("\n"):
                return i
            i += 1
        return n

    def brute_fastq(buf, offset):
        n = len(buf)
        if offset == 0:
            return 0
        i = offset
        while i < n and buf[i - 1] != ord("\n"):
            i += 1
        starts = []
        j = i
        while j < n and len(starts) < 12:
            starts.append(j)
            while j < n and buf[j] != ord("\n"):
                j += 1
            j += 1
        for idx, s in enumerate(starts):
            if (buf[s] == ord("@") and idx + 2 < len(starts)
                    and buf[starts[idx + 2]] == ord("+")):
                return s
        return n

    rng = random.Random(77)
    fa = []
    for t in range(12):
        seq = "".join(rng.choice("ACGT") for _ in range(rng.randrange(5, 60)))
        fa.append(f">rec{t} desc\n{seq}\n")
    fa_buf = np.frombuffer("".join(fa).encode(), np.uint8)
    fq = []
    for t in range(12):
        s = "".join(rng.choice("ACGT") for _ in range(rng.randrange(4, 40)))
        # quality bytes include '@' and '+' to stress the heuristic
        q = "".join(rng.choice("@+IJK") for _ in range(len(s)))
        fq.append(f"@r{t}\n{s}\n+\n{q}\n")
    fq_buf = np.frombuffer("".join(fq).encode(), np.uint8)
    for off in range(len(fa_buf) + 1):
        assert multihost.align_to_fasta_record(fa_buf, off) \
            == brute_fasta(fa_buf, off), off
    for off in range(len(fq_buf) + 1):
        assert multihost.align_to_fastq_record(fq_buf, off) \
            == brute_fastq(fq_buf, off), off


@pytest.mark.parametrize("hosts,rank,visible,refused", [
    (["a", "a"], 0, None, True),      # two processes, one host, no split
    (["a", "a"], 1, "", True),
    (["a", "a"], 0, "0", False),      # CUDA_VISIBLE_DEVICES splits cards
    (["a", "b"], 0, None, False),     # one process per host
    (["a", "b", "a", "b"], 3, None, True),
    (["a"], 0, None, False),
])
def test_one_process_per_card(hosts, rank, visible, refused):
    """Processes that share a host must not share its cards."""
    from cuclark_tpu.parallel.multihost import check_one_process_per_card

    if refused:
        with pytest.raises(ValueError, match="--local-device-ids"):
            check_one_process_per_card(hosts, rank, visible)
    else:
        check_one_process_per_card(hosts, rank, visible)


@pytest.mark.parametrize("platforms,cpu_only", [
    ("cpu", True), (None, False), ("", False), ("cuda", False),
    ("cpu,cuda", False),
])
def test_cpu_only_platforms(platforms, cpu_only):
    from cuclark_tpu.parallel.multihost import _cpu_only

    assert _cpu_only(platforms) is cpu_only
