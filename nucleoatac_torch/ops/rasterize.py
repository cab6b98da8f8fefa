"""V-plot rasterization: fragment records -> [B, S, W] count matrices.

Counterpart of nucleoatac_tpu/ops/rasterize.py for every upload wire: the
wire v7 pool, wire v6 per-window 12-bit records, the 2-byte (delta, size)
pairs, packed ``(size << 16) | mid`` words and plain fragment lists. One
flattened scatter-add over [B*S*W] builds all window matrices at once; on
the card ``index_add_`` accumulates with float32 atomics, which are exact
for counts below 2^24, so the counts equal the reference's bit for bit.
"""
from __future__ import annotations

import torch


def unpack_fragments(packed: torch.Tensor):
    """[B, F] int32 ``(size << 16) | mid`` words -> (mids, sizes, valid).
    Sizes stay below 2^15, so a word is never negative and the shift never
    sign-extends; size 0 marks padding."""
    p = packed.long()
    sizes = p >> 16
    return p & 0xFFFF, sizes, sizes > 0


def rasterize_packed_batch(
    packed: torch.Tensor, lower: int, upper: int, width: int
) -> torch.Tensor:
    """[B, F] packed fragment words -> [B, upper-lower, width] f32 counts."""
    mids, sizes, valid = unpack_fragments(packed)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def unpack_delta_fragments(db: torch.Tensor):
    """[B, F, 2] uint8 (delta, size) pairs -> (mids, sizes, valid).
    Midpoints are the running sum of the deltas, accumulated in int64;
    size 0 marks padding and the (255, 0) skip entries of gaps > 255 bp."""
    s = db[..., 1].long()
    return torch.cumsum(db[..., 0].long(), dim=1), s, s > 0


def rasterize_delta_batch(
    db: torch.Tensor, lower: int, upper: int, width: int
) -> torch.Tensor:
    """[B, F, 2] delta-coded fragments -> [B, upper-lower, width] f32
    counts. The encoder saturates sizes at 255, so upper <= 255
    (config.RunConfig refuses the delta wires otherwise)."""
    mids, sizes, valid = unpack_delta_fragments(db)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def _midpoints(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Running midpoint offsets of 12-bit records: a fragment (size > 0)
    advances by its nibble d, a skip record (size 0) by d*15."""
    return torch.cumsum(torch.where(s == 0, d * 15, d), dim=1)


def unpack_delta12_fragments(buf: torch.Tensor, n_entries: int):
    """Per-window 12-bit/record upload (wire v6).

    buf: uint8 [B, ceil(E/2) + E] — a nibble-packed delta plane (2 records
    per byte, low nibble first) then the size-byte plane, with the record
    semantics of the pool (zero padding advances 0). Returns (mids, sizes,
    valid) [B, E]."""
    E = n_entries
    nib_bytes = (E + 1) // 2
    nib = buf[:, :nib_bytes].long()
    d = torch.stack([nib & 0xF, nib >> 4], dim=-1).reshape(buf.shape[0], -1)[:, :E]
    s = buf[:, nib_bytes : nib_bytes + E].long()
    return _midpoints(d, s), s, s > 0


def rasterize_delta12_batch(
    buf: torch.Tensor, n_entries: int, lower: int, upper: int, width: int
) -> torch.Tensor:
    """Wire-v6 records -> [B, upper-lower, width] f32 counts."""
    mids, sizes, valid = unpack_delta12_fragments(buf, n_entries)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)


def unpack_pool_fragments(pool: torch.Tensor, table: torch.Tensor, emax: int):
    """Chunk-resident fragment pool decode (wire v7).

    pool: [cap//2 + cap] uint8 — a nibble-packed delta plane (2 records
    per byte, low nibble first) then the size-byte plane. A record with
    size in [1, 255] is a fragment advancing the midpoint by its nibble
    (0..14); size 0 is a skip advancing nibble*15. table: [B, 3] int32
    ``(rec_start, rec_count, base)`` with rec_start even. emax: even
    gather width (>= max rec_count). Returns (mids, sizes, valid) [B, emax].
    """
    cap = 2 * pool.shape[0] // 3
    nb = cap // 2
    table = table.long()
    rs = table[:, 0:1]
    dev = pool.device
    ar2 = torch.arange(emax // 2, device=dev)[None, :]
    nib = pool[torch.clamp((rs >> 1) + ar2, 0, nb - 1)].long()  # [B, emax//2]
    d = torch.stack([nib & 0xF, nib >> 4], dim=-1).reshape(table.shape[0], emax)
    ar = torch.arange(emax, device=dev)[None, :]
    s = pool[nb + torch.clamp(rs + ar, 0, cap - 1)].long()
    in_cnt = ar < table[:, 1:2]
    d = torch.where(in_cnt, d, 0)
    s = torch.where(in_cnt, s, 0)
    return table[:, 2:3] + _midpoints(d, s), s, s > 0


def rasterize_batch(
    mids: torch.Tensor,  # [B, F] window-relative midpoints; invalid: any value
    sizes: torch.Tensor,  # [B, F] adjusted sizes
    valid: torch.Tensor,  # [B, F] bool
    lower: int,
    upper: int,
    width: int,
) -> torch.Tensor:
    """[B, upper-lower, width] float32 counts; fragments outside the
    size/window range add 0 (the mask is folded into the update)."""
    B, F = mids.shape
    S = upper - lower
    keep = valid & (mids >= 0) & (mids < width) & (sizes >= lower) & (sizes < upper)
    s_rel = torch.clamp(sizes - lower, 0, S - 1)
    m = torch.clamp(mids, 0, width - 1)
    b_idx = torch.arange(B, device=mids.device)[:, None]
    flat_idx = (b_idx * S + s_rel) * width + m
    z = torch.zeros(B * S * width, dtype=torch.float32, device=mids.device)
    z.index_add_(0, flat_idx.reshape(-1), keep.to(torch.float32).reshape(-1))
    return z.reshape(B, S, width)


def rasterize_pool_batch(
    pool: torch.Tensor, table: torch.Tensor, emax: int, lower: int, upper: int,
    width: int,
) -> torch.Tensor:
    """Pool-resident fragments -> [B, upper-lower, width] f32 counts."""
    mids, sizes, valid = unpack_pool_fragments(pool, table, emax)
    return rasterize_batch(mids, sizes, valid, lower, upper, width)
