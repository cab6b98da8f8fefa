"""The program's batch loops, as a traffic file names them ("route").

A route is set up once (its batch lists, then one warm pass over the
whole dataset, so that every step signature the traffic uses is built and
captured before the window), then streams ``(kind, rows, share, out)``
for each batch whose download has completed: the output kind ("run",
"occ" or "nuc"), the batch's real windows, the share of a window's work
each output stands for, and the downloaded bytes. The stream walks the
dataset's batches in genome order and wraps around until the caller stops
reading. ``decode(kind, out)`` is the program's host decode of a batch's
bytes, which the harness runs on the batches it keeps, after the window.

- ``fused``: the fused pass's device loop (models/fused.py's dispatch):
  the group's fragment pool replicated to every device when the group
  changes, each batch's sequence rows packed on the 2-bit wire (the nibble
  wire when the escapes overflow), run_step_pool2 / run_step_pool, and the
  download through models/occ.py::_pipelined; unpack_run decodes.
- ``twopass``: run's two passes (models/occ.py::OccStage._batches, then
  models/nuc.py::NucStage._batches), each through _pipelined, with the
  per-batch encode of the stages' wire inside; decode_occ2 decodes the occ
  pass, f32_from_u16 the nuc pass. Each output is half of a window's work.

Spans: "wire" around pulling the next batch and packing or encoding it,
"dispatch" around the call that enqueues the batch's device work,
"unpack" around ``decode``. ``traceable(warmup, active)`` says
whether a traced span (``warmup`` batches, then ``active``) may open after
the batch just streamed: anywhere on the fused route; on the two-pass route
only so that the active batches are the end of an occ pass and the start
of the next nuc pass, half each.
"""
from __future__ import annotations

from nucleoatac_torch.models.data import make_pool_batches, pack_2bit_codes, pack_nibble_codes
from nucleoatac_torch.models.nuc import SeqCodesProvider
from nucleoatac_torch.models.occ import _pipelined


class Fused:
    kinds = ("run",)

    def __init__(self, port, spans, depth: int):
        self.port, self.spans, self.depth = port, spans, depth
        eng, cfg = port.engine, port.cfg
        self.batches = list(make_pool_batches(port.frags, port.tiles, eng.width,
                                              cfg.window.batch))
        self.seq = SeqCodesProvider(port.fasta, port.chunks, eng, cfg.window.batch)
        self.pool = {"id": None, "arr": None}

    def pass_tiles(self) -> list:
        return [t for b in self.batches for t in b.meta]

    def traceable(self, warmup: int, active: int) -> bool:
        return True

    def _feed(self, wrap: bool):
        while True:
            for b in self.batches:
                with self.spans("wire"):
                    rows = self.seq.rows(b.meta)
                    packed2, esc, ok = pack_2bit_codes(rows)
                    nib = None if ok else pack_nibble_codes(rows)
                yield b, packed2, esc, nib
            if not wrap:
                return

    def _dispatch(self, item):
        b, packed2, esc, nib = item
        eng, pool = self.port.engine, self.pool
        with self.spans("dispatch"):
            if b.pool_id != pool["id"]:
                pool["id"], pool["arr"] = b.pool_id, eng.replicate(b.pool)
            if nib is None:
                return eng.run_step_pool2(pool["arr"], b.table, packed2, esc, b.emax)
            return eng.run_step_pool(pool["arr"], b.table, nib, b.emax)

    def stream(self, wrap: bool = True):
        for item, out in _pipelined(self._feed(wrap), self._dispatch, self.depth):
            yield "run", item[0].meta, 1.0, out

    def decode(self, kind: str, out) -> dict:
        idx, cert, norm, qstep = self.port.engine.unpack_run(out)
        return {"idx": idx, "cert": cert, "norm": norm, "qstep": qstep}


class TwoPass:
    kinds = ("occ", "nuc")

    def __init__(self, port, spans, depth: int):
        self.port, self.spans, self.depth = port, spans, depth
        cfg = port.cfg
        seq = SeqCodesProvider(port.fasta, port.chunks, port.engine, cfg.window.batch)

        def seq_rows(metas):
            with spans("wire"):
                return seq.rows(metas)

        def no_bias_rows(batch):
            raise RuntimeError("the PWM makes the bias on the device; no log-bias rows")

        self.seq_rows, self.no_bias_rows = seq_rows, no_bias_rows
        self.seen_tiles: list = []
        self.pass_len = 0  # batches in one occ pass (the warm pass counts them)
        self.at = ("occ", 0)  # the kind and index in its pass of the last batch

    def pass_tiles(self) -> list:
        return self.seen_tiles

    def traceable(self, warmup: int, active: int) -> bool:
        kind, i = self.at
        return kind == "occ" and i == max(0, self.pass_len - 1 - warmup - active // 2)

    def _timed(self, batches):
        it = iter(batches)
        while True:
            with self.spans("wire"):
                b = next(it, None)
            if b is None:
                return
            yield b

    def _timed_dispatch(self, dispatch):
        def run(b):
            with self.spans("dispatch"):
                return dispatch(b)
        return run

    def stream(self, wrap: bool = True):
        port = self.port
        while True:
            for kind in self.kinds:
                if kind == "occ":
                    batches, dispatch = port.occ_stage._batches(port.frags, port.tiles)
                else:
                    batches, dispatch = port.nuc_stage._batches(
                        port.frags, port.tiles, self.seq_rows, self.no_bias_rows)
                for i, (b, out) in enumerate(_pipelined(
                        self._timed(batches), self._timed_dispatch(dispatch), self.depth)):
                    if kind == "occ" and not wrap:
                        self.seen_tiles.extend(b.meta)
                        self.pass_len = i + 1
                    self.at = (kind, i)
                    yield kind, b.meta, 0.5, out
            if not wrap:
                return

    def decode(self, kind: str, out) -> dict:
        eng = self.port.engine
        if kind == "occ":
            idx, cert = eng.decode_occ2(out)
            return {"idx": idx, "cert": cert}
        norm, qstep = eng.f32_from_u16(out)
        return {"norm": norm, "qstep": qstep}


ROUTES = {"fused": Fused, "twopass": TwoPass}
