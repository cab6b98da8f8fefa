"""host_peak_rss_mb: the process's peak resident set (ru_maxrss) when the
window closes, before the reference runs, in 1e6 bytes."""


def read(run):
    return run.rss_peak_bytes / 1e6
