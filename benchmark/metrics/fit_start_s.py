"""fit_start_s (s, layer: fit): host seconds from calling fit to its first
callback in the traced run (ingestion, chunking, upload, build, the ELPD's
set-up, the graph's warm-up and capture, the first call).  Set-up runs one
such start (the warm fit), so it moves setup_s."""


def read(run):
    return run.spans.get("fit_start")
