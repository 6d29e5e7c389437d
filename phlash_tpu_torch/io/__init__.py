"""Host-side readers of genome files, without pysam.

Port of phlash_tpu/io: `fastvcf`, a C tokenizer for VCF genotype columns
(built at first use with the system C compiler, loaded with ctypes; when it
cannot be built, phlash_tpu_torch.data parses VCF text in Python), `bcf`, a
native BCF2.2 / BGZF / CSI reader and writer, and `tabix`, .tbi indexes of
bgzipped VCF text.
"""

from phlash_tpu_torch.io.fastvcf import parse_vcf_lines, vcf_parser_backend

__all__ = ["parse_vcf_lines", "vcf_parser_backend"]
