"""peak_gib: torch.cuda.max_memory_allocated over set-up and window, of the
fullest card."""

LAYER = "end to end"
MOVES = "peak_gib"


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
