"""Device-side hash table probe.

The device analog of the reference's queryElement function
(src/CuClarkDB.cu:1249-1314).  Where the GPU does divmod-by-HTSIZE,
a bucket-pointer chase, and a data-dependent linear scan of sorted
quotients, this does: mask-based bucketing, one contiguous row gather
per hash choice, and a fully vectorized S-slot compare.

Sharding: the table's bucket rows are range-sharded along a `db` mesh
axis.  Each shard probes only buckets it owns (out-of-range probes
contribute 0) — the same windowing idea as the reference's DB-part
check (src/CuClarkDB.cu:1271-1274) but resolved by a mask instead of
control flow, so the whole thing stays one jitted SPMD program and the
cross-shard merge is a single psum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuclark_tpu.hashdb import mix1, mix2


def spread_invalid(chi, clo, valid):
    """Replace invalid windows' k-mers with per-lane counters.

    All-padding windows otherwise produce ONE identical garbage k-mer,
    so every invalid lane gathers the SAME bucket row.  Spreading the
    dead lanes across distinct buckets keeps padding from concentrating
    the gather's traffic on one row (a hardware whose gather serializes
    same-row requests pays for that; whether the H100 does is not
    measured).  Matches on spread lanes are impossible in practice
    (full-key compare) and masked out by `valid` downstream anyway."""
    # GLOBAL linear lane index: distinct across every axis, not just
    # the last (per-axis iota would collapse batched >=3-D inputs'
    # padding lanes onto repeated k-mers — the repeated-row traffic
    # this function exists to prevent)
    iota = jax.lax.iota(jnp.uint32, chi.size).reshape(chi.shape)
    chi = jnp.where(valid, chi, iota)
    clo = jnp.where(valid, clo, ~iota)
    return chi, clo


def _spread_oob(bloc, in_range, local: int):
    """Redirect out-of-shard-range lanes to DISTINCT in-bounds rows.

    A plain clip sends every out-of-range lane to row 0 or local-1.  On
    a db-sharded mesh most lanes of every shard are out of range, so the
    clamp would aim most of the probe's gathers at two rows; spreading
    the dead lanes across the shard keeps the traffic on distinct rows
    (the same reasoning as spread_invalid; the H100 effect is not
    measured).  Matches on redirected lanes are masked by `in_range`
    downstream."""
    iota = jax.lax.iota(jnp.int32, bloc.size).reshape(bloc.shape)
    return jnp.where(in_range, bloc, iota % jnp.int32(local))


def _localize(b, start, local: int):
    """Shard-localize global row indices: (bloc, in_range mask) with
    out-of-range lanes spread over distinct in-bounds rows.  One home
    for the range-sharding idiom shared by every probe path (the
    reference's DB-part window check, src/CuClarkDB.cu:1271-1274,
    as a mask instead of control flow)."""
    if start is None:
        return b, None
    bloc = b - start
    in_range = (bloc >= 0) & (bloc < local)
    return _spread_oob(bloc, in_range, local), in_range



def _q_match_labels(tbl, bloc, own, other, bits, choice, in_range):
    """One q-layout row gather per lane + exact 64-bit reconstruct-
    compare on the [other x4 | meta x4] format, summing matched labels
    (0/1 matches per lane by construction).  Shared by the q4/qs
    probes; `bits` is how many own-bits the bucket index pins."""
    rows = jnp.take(tbl, bloc, axis=0)            # [NK, 8]
    meta = rows[:, 4:]
    m = ((rows[:, :4] == other[:, None])
         & ((meta >> jnp.uint32(17)) == (own >> jnp.uint32(bits))[:, None])
         & (((meta >> jnp.uint32(16)) & jnp.uint32(1)) == choice))
    if in_range is not None:
        m &= in_range[:, None]
    return jnp.sum(
        jnp.where(m, (meta & jnp.uint32(0xFFFF)).astype(jnp.int32), 0),
        axis=1)


def probe(table, nb_bits: int, slots: int, num_choices: int, khi, klo,
          bucket_start=None, nb_local: int | None = None,
          layout: str = "s2", seed: int = 0, stash_bits: int = 0,
          stash=None, stash_start=None, nbs_local: int | None = None,
          skip_stash: bool = False):
    """Look up canonical k-mers in the (possibly sharded) table.

    table:  uint32 [NB_local, 3*slots] ("s2") / [NB_local, 8] ("q4"/"qs")
    khi/klo: uint32 [...], canonical k-mer halves
    bucket_start: starting global bucket index of this shard (traced
        scalar or None for an unsharded table).
    nb_local: number of bucket rows in `table` (static).
    layout/seed/stash_bits: table layout descriptor (hashdb.KmerDB).
    stash: qs split mode — the stash section as a SEPARATE array
        (device-side [NBS_local, 8]); None = fused mode, `table` holds
        main+stash rows concatenated.  Split mode keeps the stash a
        distinct gather operand so XLA cannot merge the two takes into
        one gather over the big array, and the stash side keeps reading
        a small, cache-friendly region (see
        hashdb.KmerDB.SPLIT_MIN_MAIN_MB for when it is used).
    stash_start/nbs_local: shard range of `stash` when it is sharded.
    skip_stash: qs split streaming — probe `table` as MAIN rows only
        (this part carries no stash rows; another part's call covers
        the stash side).

    Returns int32 labels [...]: stored 1-based target label, 0 on miss.
    """
    from cuclark_tpu.hashdb import check_q_bits

    check_q_bits(layout, nb_bits, stash_bits)  # int32 row-index guard
    if layout == "qs":
        if stash is not None or skip_stash:
            return _probe_qs_split(table, stash, nb_bits, stash_bits, seed,
                                   khi, klo, bucket_start, nb_local,
                                   stash_start, nbs_local)
        return _probe_qs(table, nb_bits, stash_bits, seed, khi, klo,
                         bucket_start, nb_local)
    if layout == "q4":
        return _probe_q4(table, nb_bits, seed, khi, klo,
                         bucket_start, nb_local)
    S = slots
    mask = jnp.uint32((1 << nb_bits) - 1)
    shape = khi.shape
    khi_f = khi.reshape(-1)
    klo_f = klo.reshape(-1)

    if nb_local is None:
        nb_local = table.shape[0]

    b1 = mix1(khi_f, klo_f) & mask
    label = jnp.zeros(khi_f.shape, dtype=jnp.int32)
    for choice in range(num_choices):
        b = b1 if choice == 0 else (mix2(khi_f, klo_f) & mask)
        bloc, in_range = _localize(b.astype(jnp.int32), bucket_start,
                                   nb_local)
        rows = jnp.take(table, bloc, axis=0)          # [NK, 3S]
        m = (rows[:, :S] == klo_f[:, None]) & (rows[:, S:2 * S] == khi_f[:, None])
        if in_range is not None:
            m &= in_range[:, None]
        if choice == 1:
            # guard against h1 == h2 double-matching the same row
            m &= (b != b1)[:, None]
        label += jnp.sum(jnp.where(m, rows[:, 2 * S:].astype(jnp.int32), 0), axis=1)

    return label.reshape(shape)


def _probe_qs(table, nb_bits: int, stash_bits: int, seed: int, khi, klo,
              bucket_start=None, nb_local: int | None = None):
    """qs-layout probe: one main-table gather + one stash gather (stash
    = the NBS rows appended at [NB, NB+NBS)).

    At representative DB scale a random main-row gather misses every
    cache, while gathers confined to the small stash can stay cached,
    so a window costs one cold and one warm gather instead of q4's two
    cold ones (H100 cost not measured).  Row/meta format and the
    exact 64-bit reconstruct-compare are identical to q4; only the
    choice-1 bucket space differs.  Sharding: indices are GLOBAL row
    numbers over main+stash, so the same bucket_start/nb_local range
    masking (and psum merge) used by q4 applies unchanged — a shard
    owning stash rows answers the stash side, every other shard
    contributes 0."""
    from cuclark_tpu.hashdb import feistel_mix

    shape = khi.shape
    khi_f = khi.reshape(-1)
    klo_f = klo.reshape(-1)
    if nb_local is None:
        nb_local = table.shape[0]
    nb = 1 << nb_bits
    mask = jnp.uint32(nb - 1)
    smask = jnp.uint32((1 << stash_bits) - 1)

    h1, l2 = feistel_mix(khi_f, klo_f, seed)
    label = jnp.zeros(khi_f.shape, dtype=jnp.int32)
    for choice, own, other, bits in ((0, l2, h1, nb_bits),
                                     (1, h1, l2, stash_bits)):
        if choice == 0:
            b = (own & mask).astype(jnp.int32)
        else:
            b = nb + (own & smask).astype(jnp.int32)
        bloc, in_range = _localize(b, bucket_start, nb_local)
        label += _q_match_labels(table, bloc, own, other, bits, choice,
                                 in_range)
    return label.reshape(shape)


def _probe_qs_split(main, stash, nb_bits: int, stash_bits: int, seed: int,
                    khi, klo, bucket_start=None, nb_local: int | None = None,
                    stash_start=None, nbs_local: int | None = None):
    """qs split-mode probe: main and stash as separate gather operands.

    One gather on the big main table + one on the small stash array,
    kept as separate operands so XLA cannot combine both takes into one
    gather over the big array (the H100 gain over the fused probe is
    not measured).  Sharding: each operand carries its own
    (start, local-rows) range with mask-out-of-range semantics, so both
    arrays can be row-sharded over the db mesh axis and the psum merge
    stays exact.  stash=None probes the main side only (split-mode
    streaming parts that carry no stash rows)."""
    from cuclark_tpu.hashdb import feistel_mix

    shape = khi.shape
    khi_f = khi.reshape(-1)
    klo_f = klo.reshape(-1)
    if nb_local is None:
        nb_local = main.shape[0]
    mask = jnp.uint32((1 << nb_bits) - 1)
    smask = jnp.uint32((1 << stash_bits) - 1)

    h1, l2 = feistel_mix(khi_f, klo_f, seed)
    label = jnp.zeros(khi_f.shape, dtype=jnp.int32)
    sides = [(0, main, l2, h1, nb_bits, l2 & mask, bucket_start, nb_local)]
    if stash is not None:
        if nbs_local is None:
            nbs_local = stash.shape[0]
        sides.append((1, stash, h1, l2, stash_bits, h1 & smask,
                      stash_start, nbs_local))
    for choice, tbl, own, other, bits, bkt, start, local in sides:
        bloc, in_range = _localize(bkt.astype(jnp.int32), start, local)
        label += _q_match_labels(tbl, bloc, own, other, bits, choice,
                                 in_range)
    return label.reshape(shape)


def _probe_q4(table, nb_bits: int, seed: int, khi, klo,
              bucket_start=None, nb_local: int | None = None):
    """q4-layout probe: one 32 B aligned row gather per hash choice and
    an exact 64-bit reconstruct-compare against quotient-compressed
    entries (see hashdb.KmerDB): aligned 32 B rows, half the bytes of
    the s2 full-key rows per gather."""
    from cuclark_tpu.hashdb import feistel_mix

    shape = khi.shape
    khi_f = khi.reshape(-1)
    klo_f = klo.reshape(-1)
    if nb_local is None:
        nb_local = table.shape[0]
    mask = jnp.uint32((1 << nb_bits) - 1)

    h1, l2 = feistel_mix(khi_f, klo_f, seed)
    label = jnp.zeros(khi_f.shape, dtype=jnp.int32)
    for choice, own, other in ((0, l2, h1), (1, h1, l2)):
        b = (own & mask).astype(jnp.int32)
        bloc, in_range = _localize(b, bucket_start, nb_local)
        label += _q_match_labels(table, bloc, own, other, nb_bits, choice,
                                 in_range)
    return label.reshape(shape)
