"""graphs.pool_mb: the bytes the step programs' CUDA graph pools reserved
(StepPrograms.pool_bytes) after the window, in 1e6 bytes; nothing where no
step was captured."""


def read(run):
    p = run.programs
    return p.pool_bytes / 1e6 if p.captures else None
