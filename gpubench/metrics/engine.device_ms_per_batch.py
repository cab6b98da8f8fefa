"""engine.device_ms_per_batch: kernel time on the card per batch and card in
the traced span: the sum of the kernel durations over the traced batches,
over the cards."""


def read(run):
    t = run.trace
    if not t or not t["kernel_s"]:
        return None
    return sum(t["kernel_s"].values()) / run.n_devices / t["batches"] * 1e3
