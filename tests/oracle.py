"""Pure-Python reference oracle.

A direct, slow transcription of the reference *semantics* (not code):
string-based k-mer walk, canonicalization, dict database, ascending-
index strict-greater best/second scan — used as ground truth for the
vectorized device implementation.

Semantics sources (file:line in /root/reference):
 - encoding A=3 C=2 G=1 T=0: src/kmersConversion.cc:49-68
 - revcomp: src/kmersConversion.cc:39-47
 - parts never span non-ACGT: src/CuCLARK_hh.hh:1679-1698
 - best/second scan: src/CuClarkDB.cu:1440-1457 (ascending target
   order, strict '>', index+1 stored)
 - gamma/confidence: src/CuCLARK_hh.hh:2054-2056
"""

from __future__ import annotations

BASE = {"A": 3, "C": 2, "G": 1, "T": 0, "a": 3, "c": 2, "g": 1, "t": 0,
        # RNA parity: reference maps U like T (src/CuCLARK_hh.hh:287,295)
        "U": 0, "u": 0}


def kmer_value(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 2) | BASE[ch]
    return v


def revcomp_value(v: int, k: int) -> int:
    x = v
    x = ((x >> 2) & 0x3333333333333333) | ((x & 0x3333333333333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0F) | ((x & 0x0F0F0F0F0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF00FF00FF) | ((x & 0x00FF00FF00FF00FF) << 8)
    x = ((x >> 16) & 0x0000FFFF0000FFFF) | ((x & 0x0000FFFF0000FFFF) << 16)
    x = ((x >> 32) | (x << 32)) & 0xFFFFFFFFFFFFFFFF
    return (0xFFFFFFFFFFFFFFFF - x) >> (64 - 2 * k)


def canonical_value(v: int, k: int) -> int:
    return min(v, revcomp_value(v, k))


def read_kmers(seq: str, k: int):
    """Canonical k-mer values of every valid window (parts semantics).

    Newlines/CR are SKIPPED, not part breaks — the reference's load
    table maps '\\n' to 'skip' (CuCLARK_hh.hh:1674), so k-mers span
    line breaks of a wrapped FASTA body."""
    out = []
    part = []
    for ch in seq.replace("\n", "").replace("\r", ""):
        if ch in BASE:
            part.append(ch)
        else:
            out.extend(_part_kmers("".join(part), k))
            part = []
    out.extend(_part_kmers("".join(part), k))
    return out


def _part_kmers(part: str, k: int):
    if len(part) < k:
        return []
    return [canonical_value(kmer_value(part[i:i + k]), k) for i in range(len(part) - k + 1)]


def light_kmers(seq: str, k: int, gap: int, iter0: int = 0):
    """Light-mode build walk (src/CuCLARK_hh.hh:710-731): NON-overlapping
    k-mer blocks, keep every gap-th; `iter` persists across parts and
    sequences of a genome file.  Returns (kmers, iter)."""
    out = []
    it = iter0

    def flush(part):
        nonlocal it
        for j in range(0, len(part) - k + 1, k):
            if it % gap == 0:
                out.append(canonical_value(kmer_value(part[j:j + k]), k))
            it += 1

    buf = []
    for ch in seq.replace("\n", "").replace("\r", ""):
        if ch in BASE:
            buf.append(ch)
        else:
            flush("".join(buf))
            buf = []
    flush("".join(buf))
    return out, it


def build_db(target_seqs: dict[int, list], k: int, gap: int = 1):
    """target_seqs: {label(1-based): [file, ...]} where each file is a
    str (single-record genome) or a list of record strs.  K-mers never
    span record boundaries (the rolling k-mer resets at '>' —
    CuCLARK_hh.hh:964-974) but the light-mode block counter `iter`
    persists ACROSS records of one file (it is declared per-file,
    CuCLARK_hh.hh:709).

    gap == 1: full mode, every overlapping k-mer; gap > 1: light mode,
    every gap-th non-overlapping block.  Returns {canonical kmer: label}
    for multiplicity-1 (target-specific) k-mers — RemoveCommon semantics.
    """
    seen: dict[int, int] = {}
    for label, files in target_seqs.items():
        for file_seq in files:
            records = ([file_seq] if isinstance(file_seq, str)
                       else list(file_seq))
            it = 0
            kms = []
            for rec in records:
                if gap > 1:
                    rec_kms, it = light_kmers(rec, k, gap, it)
                    kms.extend(rec_kms)
                else:
                    kms.extend(read_kmers(rec, k))
            for km in kms:
                if km in seen and seen[km] != label:
                    seen[km] = -1  # common to several targets
                elif km not in seen:
                    seen[km] = label
    return {km: lb for km, lb in seen.items() if lb > 0}


def classify_read(seq: str, db: dict[int, int], k: int, num_targets: int):
    """Returns (total, index_best, best, index_second, second)."""
    counts: dict[int, int] = {}
    for km in read_kmers(seq, k):
        lb = db.get(km)
        if lb is not None:
            counts[lb] = counts.get(lb, 0) + 1
    total = sum(counts.values())
    best = second = 0
    ibest = isecond = 0
    for t in range(1, num_targets + 1):  # ascending index, strict >
        c = counts.get(t, 0)
        if c == 0:
            continue
        if c > best:
            second, isecond = best, ibest
            best, ibest = c, t
        elif c > second:
            second, isecond = c, t
    return total, ibest, best, isecond, second


def result_line(name, seq_len, k, total, ibest, best, isecond, second,
                target_names, paired=False):
    """One CLARK CSV row (normal mode), %g formatting."""
    norm = seq_len - 1 if paired else seq_len
    denom = float(norm) - k + 1.0
    if denom == 0.0:
        # the reference's C division prints a row with nan (0/0) or
        # inf for a read of exactly k-1 bases; Python raises instead
        gamma = float("nan") if total == 0 else float("inf")
    else:
        gamma = float(total) / denom
    s = float(best + second)
    conf = 0.0 if s < 0.001 else float(best) / s
    return "%s,%u,%g,%s,%u,%s,%u,%g" % (
        name[:39], norm, gamma, target_names[ibest], best,
        target_names[isecond], second, conf,
    )
