"""device_peak_mb: the largest torch.cuda.max_memory_reserved() of the
run's cards (the process's own, from its start), graph pools included, in 1e6 bytes."""


def read(run):
    return run.device_peak_bytes / 1e6 if run.device_type == "cuda" else None
