"""PSMC-compatibility entry point: fit directly from .psmcfa files.

Port of phlash_tpu/psmc.py: parse Li & Durbin-style binned-heterozygosity
FASTA, set one contig aside as held-out data for the ELPD early stopping,
and hand everything to `fit`.
"""

from __future__ import annotations

import logging

from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.mcmc import fit
from phlash_tpu_torch.size_history import DemographicModel

logger = logging.getLogger(__name__)


def psmc(psmcfa_files: list[str], window_size: int = 100, hold_out: bool = True,
         **options) -> list[DemographicModel]:
    """Run inference on PSMC-formatted (.psmcfa) input files.

    Args:
        psmcfa_files: input files (the window size is the `-s` used when the
            files were produced by fq2psmcfa, usually 100).
        hold_out: reserve the first contig as a test set for early stopping.
        **options: forwarded to phlash_tpu_torch.fit (device, seed,
            kernel_backend "smc" / "packed" / "dense" / "scan", and the fit
            options).
    """
    logger.info("reading PSMC data from %d file(s)", len(psmcfa_files))
    contigs: list[RawContig] = []
    for path in psmcfa_files:
        contigs.extend(RawContig.from_psmcfa_iter(path, window_size))
    if not contigs:
        raise ValueError(f"no contigs found in {psmcfa_files}")
    test_data = contigs.pop(0) if hold_out and len(contigs) > 1 else None
    return fit(contigs, test_data=test_data, window_size=window_size, **options)
