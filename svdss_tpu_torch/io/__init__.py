from .fasta import load_chromosomes, write_fasta  # noqa: F401
from .bam import (  # noqa: F401
    BamHeader,
    BamRecord,
    BamReader,
    BamWriter,
    CIGAR_OPS,
    FUNMAP,
    FSECONDARY,
    FSUPPLEMENTARY,
    FREVERSE,
    aligned_pairs,
    aligned_pairs_arrays,
)
from .sfs_file import write_sfs_file, parse_sfs_file  # noqa: F401
