"""device.idle_share: the share of the traced span in which no operation
ran on the card (kernels, copies, sets), averaged over the cards, in
percent."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    busy = sum(t["busy_s"].values()) / run.n_devices
    return 100.0 * (1.0 - busy / t["window_s"])
