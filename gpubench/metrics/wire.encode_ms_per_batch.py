"""wire.encode_ms_per_batch: the host's time per batch finished in the
window in pulling the next batch from the batch generator and packing or
encoding it for the wire (the harness's "wire" span: the pool batch list or
the stages' encoder, the sequence rows and their 2-bit or nibble pack)."""


def read(run):
    return run.spans.total.get("wire", 0.0) / run.batches * 1e3 if run.batches else None
