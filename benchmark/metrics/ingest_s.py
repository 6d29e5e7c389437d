"""ingest_s (s, layer: data): one direct call of phlash_tpu_torch.data.init_mcmc_data
with fit's arguments on the cell's training contigs, timed by the harness
after the window (reading and chunking; with files, in fit's spawn pool).
Moves setup_s (set-up runs fit once: the warm fit)."""


def read(run):
    return run.spans.get("ingest")
