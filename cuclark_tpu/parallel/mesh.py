"""Multi-chip execution: DB sharding + data parallelism over a mesh.

Replaces the reference's entire multi-GPU machinery — DB part planning
(src/CuClarkDB.cu:540-574), part swap cycles (:813-858), in-device and
cross-device cudaMemcpyPeer merge trees (:929-994), pinned-host partial
round-trips — with one jitted SPMD program over a 2-D device mesh:

  axis "db":   hash-table bucket rows range-sharded; each shard probes
               only the buckets it owns (mask, not control flow) and the
               per-window labels merge with a single psum (NVLink
               between the cards of one host).
               A k-mer hits in at most one shard (keys are unique), so
               summing label integers is an exact merge.
  axis "data": read batches sharded; results stay sharded for per-host
               CSV writing.

When the DB fits the cards' aggregate memory there are no swap cycles
at all; host-streaming of bucket ranges remains the fallback for a DB
larger than device memory (the C8 analog) by looping this same program
over range loads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuclark_tpu import codec, score
from cuclark_tpu.hashdb import KmerDB
from cuclark_tpu.probe import probe, spread_invalid


def make_mesh(num_db: int, num_data: int | None = None, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if num_data is None:
        if total % num_db:
            raise ValueError(f"{total} devices not divisible by db={num_db}")
        num_data = total // num_db
    return Mesh(devices.reshape(num_data, num_db), axis_names=("data", "db"))


def shard_db_table(db: KmerDB, mesh: Mesh):
    """Place the table on the mesh, bucket rows sharded along 'db',
    replicated along 'data'.  Returns (table, stash): in qs split mode
    both the main rows and the small stash are row-sharded device
    arrays (each shard answers only ranges it owns; psum merges);
    otherwise stash is None and `table` holds everything."""
    num_db = mesh.shape["db"]
    main_np, stash_np = db.split_tables()

    def place(arr):
        if arr.shape[0] % num_db:
            raise ValueError(
                f"table rows {arr.shape[0]} not divisible by db={num_db}")
        sharding = NamedSharding(mesh, P("db", None))
        if jax.process_count() > 1:
            # multi-controller: every process holds the full table on the
            # host and materializes only its addressable shards
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx])
        return jax.device_put(arr, sharding)

    return place(main_np), (place(stash_np) if stash_np is not None
                            else None)


def make_global_mesh(num_db: int = 1, devices=None) -> Mesh:
    """Global (data x db) mesh over ALL processes' devices, data-axis
    host-major so each process's data rows are contiguous (per-host
    record blocks concatenate in rank order).  num_db must divide the
    per-process device count so the 'db' axis (and its psum) stays
    within one process's cards; db > local devices would put the
    reduction on the network between hosts, which works but should be a
    deliberate choice.  The one allowed
    host-spanning case (num_db == total devices, data axis 1) serves
    replicated-read ShardedClassifier use; the lockstep
    multihost.GlobalClassifier engine needs data divisible by the
    process count and rejects it."""
    import jax as _jax

    devices = list(devices if devices is not None else _jax.devices())
    devices.sort(key=lambda d: (d.process_index, d.id))
    local = max(1, len(devices) // max(1, _jax.process_count()))
    if num_db != len(devices) and local % num_db:
        # num_db == total (data=1, reads replicated to every host like
        # the reference's per-GPU read broadcast) is the one allowed
        # host-spanning case; otherwise db rows must sit within a host
        raise ValueError(
            f"num_db={num_db} must divide per-process devices {local} "
            f"or equal the total device count {len(devices)}")
    arr = np.asarray(devices).reshape(len(devices) // num_db, num_db)
    return Mesh(arr, axis_names=("data", "db"))


def build_sharded_classify(mesh: Mesh, *, k: int, nb_bits: int, slots: int,
                           num_choices: int, nb_total: int,
                           with_labels: bool = True, layout: str = "s2",
                           seed: int = 0, stash_bits: int = 0,
                           nbs_total: int = 0):
    """Returns a jitted fn (table, packed2, vbits) or, in qs split mode
    (nbs_total > 0), (table, stash, packed2, vbits) -> (results [R,5],
    labels [R,P]) with table (and stash) sharded on 'db' and
    reads/results sharded on 'data'.  Reads arrive in the 2-bit wire
    format (codec.pack_codes) and unpack on-chip — host->chip bytes are
    the scarce resource, as in the reference's u16 read containers
    (src/CuCLARK_hh.hh:1630-1716).  with_labels=False skips
    materializing the per-window label matrix (only extended output
    needs it)."""
    num_db = mesh.shape["db"]
    nb_local = nb_total // num_db
    nbs_local = nbs_total // num_db

    def finish(labels, valid):
        labels = jnp.where(valid, labels, 0)
        # exact merge: every k-mer matches in at most one db shard
        labels = jax.lax.psum(labels, "db")
        results = score.score_labels(labels)
        return (results, labels) if with_labels else (results,)

    def prep(packed2, vbits):
        codes = codec.unpack_codes(packed2, vbits)
        (khi, klo), valid = codec.extract_kmers(codes, k)
        chi, clo = codec.canonical((khi, klo), k)
        chi, clo = spread_invalid(chi, clo, valid)
        return chi, clo, valid

    if nbs_total:
        def local_step(table, stash, packed2, vbits):
            chi, clo, valid = prep(packed2, vbits)
            ax = jax.lax.axis_index("db").astype(jnp.int32)
            labels = probe(table, nb_bits, slots, num_choices, chi, clo,
                           bucket_start=ax * nb_local, nb_local=nb_local,
                           layout=layout, seed=seed, stash_bits=stash_bits,
                           stash=stash, stash_start=ax * nbs_local,
                           nbs_local=nbs_local)
            return finish(labels, valid)

        in_specs = (P("db", None), P("db", None), P("data", None),
                    P("data", None))
    else:
        def local_step(table, packed2, vbits):
            chi, clo, valid = prep(packed2, vbits)
            start = jax.lax.axis_index("db").astype(jnp.int32) * nb_local
            labels = probe(table, nb_bits, slots, num_choices, chi, clo,
                           bucket_start=start, nb_local=nb_local,
                           layout=layout, seed=seed, stash_bits=stash_bits)
            return finish(labels, valid)

        in_specs = (P("db", None), P("data", None), P("data", None))

    out_specs = ((P("data", None), P("data", None)) if with_labels
                 else (P("data", None),))
    shardd = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(shardd)


def build_sharded_probe_part(mesh: Mesh, *, k: int, nb_bits: int, slots: int,
                             num_choices: int, nb_part: int,
                             layout: str = "s2", seed: int = 0,
                             stash_bits: int = 0, with_stash: bool = False,
                             skip_stash: bool = False):
    """Sharded analog of pipeline.probe_part_step: probe ONE bucket-range
    DB part (itself row-sharded over the 'db' axis) against a
    data-sharded packed batch, psum partial labels over 'db'.

    Composes host streaming with the mesh exactly like the reference's
    cycles x devices x parts planning (src/CuClarkDB.cu:540-574,
    813-858): the global bucket space splits into parts (host-streamed)
    x db-axis shards (resident per upload).  nb_part = rows per part;
    each device holds nb_part/num_db rows; part_start is traced so one
    compiled program serves every part.

    qs split mode: parts cover MAIN rows; build one program with
    with_stash=True (takes the resident row-sharded stash, used for
    exactly one part per batch) and one with skip_stash=True for the
    rest."""
    num_db = mesh.shape["db"]
    if nb_part % num_db:
        raise ValueError(f"part rows {nb_part} not divisible by db={num_db}")
    nb_local = nb_part // num_db

    def prep(packed2, vbits):
        codes = codec.unpack_codes(packed2, vbits)
        (khi, klo), valid = codec.extract_kmers(codes, k)
        chi, clo = codec.canonical((khi, klo), k)
        chi, clo = spread_invalid(chi, clo, valid)
        return chi, clo, valid

    if with_stash:
        def local_step(table_part, stash, packed2, vbits, part_start):
            chi, clo, valid = prep(packed2, vbits)
            ax = jax.lax.axis_index("db").astype(jnp.int32)
            nbs_local = stash.shape[0]
            labels = probe(table_part, nb_bits, slots, num_choices, chi,
                           clo, bucket_start=part_start + ax * nb_local,
                           nb_local=nb_local, layout=layout, seed=seed,
                           stash_bits=stash_bits, stash=stash,
                           stash_start=ax * nbs_local, nbs_local=nbs_local)
            labels = jnp.where(valid, labels, 0)
            return (jax.lax.psum(labels, "db"),)

        in_specs = (P("db", None), P("db", None), P("data", None),
                    P("data", None), P())
    else:
        def local_step(table_part, packed2, vbits, part_start):
            chi, clo, valid = prep(packed2, vbits)
            start = (part_start
                     + jax.lax.axis_index("db").astype(jnp.int32) * nb_local)
            labels = probe(table_part, nb_bits, slots, num_choices, chi,
                           clo, bucket_start=start, nb_local=nb_local,
                           layout=layout, seed=seed, stash_bits=stash_bits,
                           skip_stash=skip_stash)
            labels = jnp.where(valid, labels, 0)
            return (jax.lax.psum(labels, "db"),)

        in_specs = (P("db", None), P("data", None), P("data", None), P())

    shardd = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data", None),),
        check_vma=False,
    )
    return jax.jit(shardd)


class ShardedClassifier:
    """Mesh-parallel version of pipeline.Classifier's device step.

    multihost=True switches host<->mesh data movement to the
    multi-controller primitives: every process feeds only its local
    shard of each global batch (jax.make_array_from_process_local_data)
    and reads back only its addressable result rows — the per-host
    data path of SURVEY §7.7."""

    def __init__(self, db: KmerDB, mesh: Mesh, with_labels: bool = True,
                 multihost: bool = False):
        self.db = db
        self.mesh = mesh
        self.with_labels = with_labels
        self.multihost = multihost or jax.process_count() > 1
        self.table, self.stash = shard_db_table(db, mesh)
        main_np, stash_np = db.split_tables()
        self._step = build_sharded_classify(
            mesh,
            k=db.k,
            nb_bits=db.nb_bits,
            slots=db.slots,
            num_choices=db.num_choices,
            nb_total=main_np.shape[0],
            with_labels=with_labels,
            layout=db.layout,
            seed=db.seed,
            stash_bits=db.stash_bits,
            nbs_total=(stash_np.shape[0] if stash_np is not None else 0),
        )
        self._codes_sharding = NamedSharding(mesh, P("data", None))

    @property
    def num_data(self) -> int:
        return self.mesh.shape["data"]

    def put_wire(self, packed2: np.ndarray, vbits: np.ndarray):
        """Place one packed batch on the mesh (data-sharded).  Safe to
        call from a prefetch thread — it is host->device placement, not
        a collective dispatch, so the lockstep rule (identical jitted
        call order on every rank) is untouched; a device_put can block
        its calling thread for the whole transfer, so doing this on the
        feed thread overlaps H2D with the main thread's dispatch."""
        if self.multihost:
            # each process contributes its rows of the global batch
            return (jax.make_array_from_process_local_data(
                        self._codes_sharding, np.asarray(packed2)),
                    jax.make_array_from_process_local_data(
                        self._codes_sharding, np.asarray(vbits)))
        return (jax.device_put(packed2, self._codes_sharding),
                jax.device_put(vbits, self._codes_sharding))

    def step_placed(self, dev_p2, dev_vb):
        """Async device step on mesh-placed arrays (see put_wire)."""
        if self.stash is not None:
            out = self._step(self.table, self.stash, dev_p2, dev_vb)
        else:
            out = self._step(self.table, dev_p2, dev_vb)
        return (out[0], out[1]) if self.with_labels else (out[0], None)

    def step_packed(self, packed2: np.ndarray, vbits: np.ndarray):
        """Async device step on pre-packed reads (codec.pack_codes).

        Rows must be divisible by the data axis; pad with zero rows
        (zero validity bits -> all-INVALID reads) beforehand.  Returns
        (results, labels-or-None) as device arrays without blocking —
        the pipeline keeps batches in flight exactly like the
        single-chip path."""
        return self.step_placed(*self.put_wire(packed2, vbits))

    @staticmethod
    def local_rows(out_arr, n_local: int | None = None) -> np.ndarray:
        """This process's rows of a data-sharded result (multi-host:
        only addressable shards can be read back; rank order along the
        data axis is this host's contiguous record block).

        Results are REPLICATED along 'db' (out_specs P('data', None)),
        so addressable_shards lists every replica: keep exactly one
        shard per data-axis block — concatenating replicas would hand
        later reads earlier reads' rows."""
        blocks: dict[int, object] = {}
        for s in out_arr.addressable_shards:
            blocks.setdefault(s.index[0].start or 0, s)
        rows = np.concatenate(
            [np.asarray(blocks[k].data) for k in sorted(blocks)])
        return rows if n_local is None else rows[:n_local]

    def classify_codes(self, codes: np.ndarray):
        """codes: [R, L] uint8; blocks and returns numpy results."""
        num_data = self.num_data
        R = codes.shape[0]
        if R % num_data:
            pad = num_data - R % num_data
            codes = np.pad(codes, ((0, pad), (0, 0)),
                           constant_values=codec.INVALID)
        packed2, vbits = codec.pack_codes(codes)
        results, labels = self.step_packed(packed2, vbits)
        if labels is None:
            return np.asarray(results)[:R], None
        return np.asarray(results)[:R], np.asarray(labels)[:R]
