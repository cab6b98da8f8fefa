"""windows_per_s: real windows (padding rows excluded) whose outputs were
downloaded to the host inside the window, over the window's seconds; a
pass's output counts its share of a window (the two-pass route's occ and
nuc outputs half each). The host decode is not in the loop (it is the
first step of the host finishing; loop.host_ms_per_batch times it)."""


def read(run):
    return run.windows / run.window_s
