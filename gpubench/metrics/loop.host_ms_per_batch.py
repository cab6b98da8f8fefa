"""loop.host_ms_per_batch: the host's time per batch outside its waits on
the device: pulling and packing or encoding the batch and the call that
enqueues its device work (the harness's "wire" and "dispatch" spans over
the window, per batch finished in it), plus the program's host decode of a
batch (the "unpack" span, timed on the batches the check keeps, after the
window)."""


def read(run):
    s, n = run.spans, run.spans.count.get("unpack", 0)
    if not (n and run.batches):
        return None
    loop = (s.total.get("wire", 0.0) + s.total.get("dispatch", 0.0)) / run.batches
    return (loop + s.total["unpack"] / n) * 1e3
