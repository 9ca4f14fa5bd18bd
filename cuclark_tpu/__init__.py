"""cuclark_tpu — GPU metagenomic read classifier in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of CuCLARK
(CLARK-family CUDA classifier, reference: Funatiq/cuclark).  Offline it
builds a database of target-specific canonical k-mers from reference
genomes; online it streams FASTA/FASTQ reads, probes every overlapping
k-mer against the database and assigns each read to the target with the
most hits, emitting CLARK-format CSV.

Nothing in here is a port: the chained hash table becomes a flat
two-choice bucketed table gathered in one row per probe; the CUDA
atomic scoreboard + warp compaction becomes a vectorized per-read
label-match reduction; multi-GPU DB part swapping + P2P merge trees
become mesh sharding + psum over NVLink.
"""

from cuclark_tpu.config import ClassifyConfig, DBConfig
from cuclark_tpu.hashdb import KmerDB
from cuclark_tpu.pipeline import Classifier

__version__ = "0.5.0"

__all__ = [
    "ClassifyConfig",
    "DBConfig",
    "KmerDB",
    "Classifier",
    "__version__",
]
