"""VCF emission.

Reproduces the reference header (print_vcf_header, caller.cpp:477-550) —
same INFO/FORMAT declarations and the DEFAULT sample column — with the
contig lines generated from the loaded reference.
"""

from __future__ import annotations

from typing import Dict, Iterable, TextIO

from ..models import SV

_REFERENCE_URL = ("ftp://ftp.1000genomes.ebi.ac.uk/vol1/ftp/data_collections/"
                  "HGSVC2/technical/reference/20200513_hg38_NoALT/"
                  "hg38.no_alt.fa.gz")

_INFO_LINES = """\
##FILTER=<ID=PASS,Description="All filters passed">
##INFO=<ID=VARTYPE,Number=A,Type=String,Description="Variant class">
##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Variant type">
##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Difference in length between REF and ALT alleles">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant described in this record">
##INFO=<ID=WEIGHT,Number=1,Type=Integer,Description="Number of alignments supporting this record">
##INFO=<ID=COV,Number=1,Type=Integer,Description="Total number of alignments covering this locus">
##INFO=<ID=COV0,Number=1,Type=Integer,Description="Total number of alignments covering this locus (no HP)">
##INFO=<ID=COV1,Number=1,Type=Integer,Description="Total number of alignments covering this locus (HP=1)">
##INFO=<ID=COV2,Number=1,Type=Integer,Description="Total number of alignments covering this locus (HP=2)">
##INFO=<ID=AS,Number=1,Type=Integer,Description="Alignment score">
##INFO=<ID=NV,Number=1,Type=Integer,Description="Number of variations on same consensus">
##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">
##INFO=<ID=CIGAR,Number=A,Type=String,Description="CIGAR of consensus">
##INFO=<ID=READS,Number=.,Type=String,Description="Reads identifiers supporting the call">
##INFO=<ID=RVEC,Number=.,Type=String,Description="Reads vector used by genotyper">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDEFAULT
"""


def write_vcf_header(out: TextIO, chromosomes: Dict[str, str]) -> None:
    out.write("##fileformat=VCFv4.2\n")
    out.write(f"##reference={_REFERENCE_URL}\n")
    for name, seq in chromosomes.items():
        out.write(f"##contig=<ID={name},length={len(seq)}>\n")
    out.write(_INFO_LINES)


def write_vcf(out: TextIO, chromosomes: Dict[str, str],
              svs: Iterable[SV]) -> None:
    write_vcf_header(out, chromosomes)
    for sv in svs:
        out.write(sv.vcf_line() + "\n")
