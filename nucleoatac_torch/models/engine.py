"""TorchEngine: the batched window chains of the occ and nuc stages.

Counterpart of nucleoatac_tpu/models/engine.py :: DeviceEngine for every
``nucleoatac`` command and flag value, in exact and non-exact mode:

  raster (wire v7 pool, wire v6 delta12, 2-byte delta pairs, packed
  words, fragment lists, or a host-rasterized int16 matrix)
    -> occupancy LL -> wire-v8 occ bytes (exact) or wire-v2 (non-exact)
  log bias (PWM over sequence codes, or an uploaded f32 row) -> B0
    -> template xcorr -> margin-extended norm -> u16 bytes  (exact nuc)
                      -> f32 [B, 5, W] score tracks         (non-exact nuc)

The fused steps (run_step_pool*, run_step_delta*) pack both branches into
one uint8 row per window. The two-pass stages (models/occ.py,
models/nuc.py) compose one branch each from the same stage functions: a
wire's raster, then _occ_packed2 (wire v8) or _nucm16 (u16 norm) in exact
mode, so both paths quantize the same f32 norm. Non-exact mode (occ.exact /
nuc.exact False) has no host refinisher: _occ_packed3 ships full CI
indices and _nuc5 the f32 signal, lr and fuzz tracks the host selection
reads.

The reference's named download steps (occ_step_<wire>_<form>,
nuc_step_<wire>[_seq]_<form>) are built from tables: the wires' rasters
and sequence-bias stages (_WIRES, _SEQ_BIAS) and each download form's
finisher (_OCC_FORMS, _NUC_FORMS). Each name is a class attribute with the
reference's arguments in the reference's order.

The float-track steps (occ_step*, nuc_step*, full_step*) are the
reference's public step API: OccTracks / NucTracks of [B, W] tensors from
a dense raster or a wire's raster, on the same stage functions. The
reference's full_impl* / occ_impl / nuc_impl are these steps before jit;
here the *_step forms stand for them.

On a card the four fused steps (run_step_pool2, run_step_pool,
run_step_delta12, run_step_delta) run as step programs, the counterpart
of the reference's jit-compiled executables: each shard's chain is
captured once per input signature into a CUDA graph and replayed after
(models/graphs.py; ``programs`` holds the entries and their counts). The
eager chains (_run_pool2, _run_pool, _run_delta12, _run_delta) are the
reference's *_impl forms before jit: the profiler and chip_smoke time and
compare them. On the CPU every step runs eagerly.

Tracing (utils/trace.py): ``replicate`` is the span
``engine.pool_upload`` and the uploads in ``shard`` the span
``engine.upload``; ``run_step_pool`` counts ``wire.nibble_batches`` (the
fused pass's log line gives it). The
fused forms' stage methods carry the ranges ``engine.<stage>`` under a
profiler (never summed: they run eagerly only at a warm-up, a capture and
on the CPU), which map a replay's kernels to stages
(profiling/stages.py::replay_stages).

The template xcorr follows ``cfg.window.conv``, unless ``use_pallas`` sends
every route to K2 as the reference's switch does: "diag" runs the K2 kernel
(ops/nuc_scores.py, xcorr and epilogue in one launch); "diag_pallas" runs
two K1 launches (ops/diag_xcorr.py) and the epilogue as torch ops, as the
reference's Pallas route does; "direct" runs the eight sums as two
full-float32 ``conv1d`` calls (ops/xcorr.py :: conv_stack_direct), where
the reference runs two XLA convolutions, then the same epilogue. On the
CPU each kernel wrapper runs its plain version. Tables live as tensors on
an explicit ``torch.device``; the host decoders are the reference's.

Several devices shard every window batch, as the reference's mesh does
(parallel/mesh.py :: auto_devices): each holds its own copy of the
tables, every entry point (``shard``) cuts its per-window inputs on axis
0 into one contiguous slice per device, uploads the pool wire's record
pool whole to each (replicated, as the reference's is), runs each slice's
chain on its card and gathers the outputs in window order on the first.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import NamedTuple

import numpy as np
import torch

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.core.vmat import VMat
from nucleoatac_torch.device import resolve_device, to_device
from nucleoatac_torch.models.graphs import StepPrograms
from nucleoatac_torch.models.params import (
    engine_tables_from_numpy,
    host_tables,
    size_probs64,
)
from nucleoatac_torch.ops import diag_xcorr as k1_ops
from nucleoatac_torch.ops import nuc_scores as k2_ops
from nucleoatac_torch.ops import occ_window as k3_ops
from nucleoatac_torch.ops.biasmat import bias_mat_batch
from nucleoatac_torch.ops.diag_xcorr import nuc_conv_outputs
from nucleoatac_torch.ops.nuc_scores import nuc_scores
from nucleoatac_torch.ops.occupancy import (
    occupancy_batch,
    occupancy_packed,
    occupancy_packed2,
    occupancy_packed3,
)
from nucleoatac_torch.ops.pwmseq import (
    pwm_bias_batch,
    unpack_2bit_codes,
    unpack_nibble_codes,
)
from nucleoatac_torch.ops.rasterize import (
    rasterize_batch,
    rasterize_delta12_batch,
    rasterize_delta_batch,
    rasterize_packed_batch,
    rasterize_pool_batch,
)
from nucleoatac_torch.ops.smooth import gauss_smooth_batch
from nucleoatac_torch.ops.xcorr import finish_scores, nuc_conv_outputs_direct, pad_valid
from nucleoatac_torch.utils.trace import annotated, count, span

# template-xcorr routes by cfg.window.conv
CONV_ROUTES = ("diag", "diag_pallas", "direct")


class OccTracks(NamedTuple):
    """Per-bp occupancy tracks, each [B, W] (the reference's OccTracks)."""
    occ: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    n: torch.Tensor
    margin: torch.Tensor  # f64-certification margins; see ops/occupancy.py
    ci_margin: torch.Tensor


class NucTracks(NamedTuple):
    """Per-bp nucleosome score tracks, each f32 [B, W] (the reference's
    NucTracks)."""
    norm: torch.Tensor
    norm_smooth: torch.Tensor
    signal: torch.Tensor
    lr: torch.Tensor
    fuzz: torch.Tensor
    n: torch.Tensor


class Replicated(dict):
    """One copy of an array per engine device, keyed by device
    (TorchEngine.replicate): the pool wire's record pool, which every
    shard's windows read."""


class Escapes(NamedTuple):
    """The wire-v9 N-escape list [E, 2] of (row, col) entries, padded
    with (0, wp): a shard keeps the entries of its own rows."""
    esc: object  # numpy array or tensor
    wp: int


def _upload(a, dev: torch.device) -> torch.Tensor:
    """A host array or a tensor on ``dev`` (pinned, without blocking, for
    a host array bound for a card)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=True)
    return to_device(a, dev)


def _on(dev: torch.device):
    """``dev`` as the current device while a shard's chain is enqueued."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---------------- the named download steps -----------------------------
# wire -> (raster stage, the wire's arguments, what they hold)
_WIRES = {
    "dense": ("_dense", ("mat",), "host-rasterized counts [B, S, W]"),
    "frags": ("_raster_frags", ("mids", "sizes", "valid"),
              "[B, F] midpoints, sizes and validity"),
    "packed": ("_raster_packed", ("packed",), "(size << 16) | mid words [B, F]"),
    "delta": ("_raster_delta", ("db",), "2-byte (delta, size) pairs [B, F, 2]"),
    "delta12": ("_raster_delta12", ("buf",), "wire-v6 12-bit records"),
}
# wire -> the stage that makes the log-bias row from sequence codes, the
# argument that holds the codes and what they are (the "_seq" nuc forms;
# the others take an f32 log-bias row)
_SEQ_BIAS = {
    "packed": ("_logbias_seq", "codes", "uint8 sequence codes [B, W + L - 1]"),
    "delta": ("_logbias_nib", "packed_codes", "nibble-packed sequence codes"),
    "delta12": ("_logbias_nib", "packed_codes", "nibble-packed sequence codes"),
}
# download form -> (finisher, what it downloads)
_OCC_FORMS = {
    "c": ("_occ_packed", "wire-v1 occ bytes uint8 [B, 4, W]"),
    "c3": ("_occ_packed3", "wire-v2 occ bytes uint8 [B, 3, core]"),
    "p2": ("_occ_packed2", "wire-v8 occ bytes uint8 [B, 2*core + ceil(core/4)]"),
}
_NUC_FORMS = {
    "m": ("_nucm", "f32 norm with smooth margins [B, core + 2m] (wire v3)"),
    "m16": ("_nucm16", "u16 norm with margins uint8 [B, 2(core + 2m) + 8] "
                       "(wire v5; f32_from_u16 decodes it)"),
    "m24": ("_nucm24", "u24 norm with margins uint8 [B, core + 2m, 3] "
                       "(wire v4; f32_from_u24 decodes it)"),
    "c2": ("_nuc2", "f32 norm and norm_smooth [B, 2, core] (wire v2)"),
    "c": ("_nuc5", "f32 norm, norm_smooth, signal, lr and fuzz [B, 5, W]"),
}


def _named(step, name: str, params: tuple, doc: str):
    """``step`` under ``name``, with the reference's parameters as its
    signature (positional) and ``doc``."""
    step.__name__, step.__qualname__, step.__doc__ = name, f"TorchEngine.{name}", doc
    step.__signature__ = inspect.Signature(
        [inspect.Parameter(p, inspect.Parameter.POSITIONAL_ONLY)
         for p in ("self",) + params])
    return step


def _occ_step(wire: str, form: str):
    """occ_step[_<wire>]_<form>: the wire's raster, then the form's occ
    finisher, sharded."""
    raster, params, holds = _WIRES[wire]
    finish, downloads = _OCC_FORMS[form]

    def step(self, *args):
        ras, fin = getattr(self, raster), getattr(self, finish)
        return self.shard(lambda *a: fin(ras(*a)), *args)

    name = f"occ_step_{form}" if wire == "dense" else f"occ_step_{wire}_{form}"
    return _named(step, name, params, f"{holds} -> {downloads}.")


def _nuc_step(wire: str, form: str, seq: bool = False):
    """nuc_step_<wire>[_seq]_<form>: the wire's raster and the log-bias
    row (from sequence codes when ``seq``), then the form's nuc finisher
    (one nuc step per shard), sharded."""
    raster, params, holds = _WIRES[wire]
    finish, downloads = _NUC_FORMS[form]
    bias, last, bias_holds = (_SEQ_BIAS[wire] if seq
                              else (None, "log_bias", "an f32 log-bias row [B, W]"))

    def step(self, *args):
        ras, fin = getattr(self, raster), getattr(self, finish)
        row = getattr(self, bias) if bias else (lambda lb: lb)
        return self.shard(lambda *a: fin(ras(*a[:-1]), row(a[-1])), *args)

    name = f"nuc_step_{wire}{'_seq' if seq else ''}_{form}"
    return _named(step, name, params + (last,), f"{holds} and {bias_holds} -> {downloads}.")


class TorchEngine:
    def __init__(
        self,
        cfg: RunConfig,
        mix: FragmentMixDistribution,
        fragmentsizes: FragmentSizes,
        vmat: VMat | None = None,
        pwm=None,
        device="cuda",
        tables: dict | None = None,
        conv: str | None = None,
        use_pallas: bool = False,
    ):
        """``device`` is one device or a list of them (models/pipeline.py
        picks it with parallel/mesh.py :: auto_devices); a list shards
        each window batch in equal slices, one per entry (an entry may
        repeat). ``tables`` (numpy, by DeviceEngine attribute name; see
        models/params.py) replaces the tables built from mix/vmat/pwm.
        ``conv`` (default ``cfg.window.conv``) picks the xcorr route;
        ``use_pallas`` runs every route's xcorr on K2, as the reference's
        switch of that name runs its Pallas kernel."""
        self.cfg = cfg
        self.conv = conv or cfg.window.conv
        if self.conv not in CONV_ROUTES:
            raise ValueError(f"conv={self.conv!r}; expected one of {CONV_ROUTES}")
        self.use_pallas = use_pallas
        devices = [device] if isinstance(device, (str, torch.device)) else list(device)
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices or cfg.window.batch % len(self.devices):
            raise ValueError(f"window batch {cfg.window.batch} does not divide "
                             f"over devices {self.devices}")
        self.device = self.devices[0]
        self.width = cfg.window.width(cfg.occ, cfg.vmat)
        self.halo = cfg.window.halo(cfg.occ, cfg.vmat)
        self.vmat = vmat or VMat.default(cfg.vmat)
        if (self.vmat.lower, self.vmat.upper) != (cfg.vmat.lower, cfg.vmat.upper):
            raise ValueError("VMat size range does not match config")
        self.pwm = pwm
        self.size_probs64 = size_probs64(cfg, fragmentsizes)  # host f64 refinisher
        if tables is None:
            tables = host_tables(cfg, mix, self.size_probs64, self.vmat, pwm)
        # host copies for the host drivers, tensors for the device chain
        self.log_mix = tables["log_mix"]
        self.alpha_grid = tables["alpha_grid"]
        self.smooth_kernel = tables["smooth_kernel"]
        # one copy of the tables per device; self.tables is the first's
        self._tables = {d: engine_tables_from_numpy(tables, d)
                        for d in dict.fromkeys(self.devices)}
        self.tables = self._tables[self.device]
        if pwm is not None and "pwm_log_ratio" not in self.tables:
            raise ValueError("tables lack pwm_log_ratio for the given PWM")
        self.core_lo = self.halo
        self.core_hi = self.width - self.halo
        self.core = cfg.window.core
        self.steps = 0  # nuc batches dispatched, per shard (every _scores call)
        # the fused steps' CUDA graphs; a replay adds the counts its capture saw
        self.programs = StepPrograms(
            [(k2_ops, "LAUNCHES"), (k1_ops, "LAUNCHES"), (k3_ops, "LAUNCHES"),
             (self, "steps")])

    def smooth_margin(self) -> int:
        """Columns of norm needed on each side of the core to reproduce the
        per-window gaussian smooth on the host."""
        return len(self.smooth_kernel) // 2

    def seq_codes_width(self) -> int:
        """Width of the per-window sequence-code row."""
        return self.width + self.pwm.length - 1

    def _tab(self, t: torch.Tensor) -> dict:
        """The tables on ``t``'s device."""
        return self._tables[t.device]

    # ---------------- sharding ----------------------------------------
    def replicate(self, a):
        """``a`` (host array or tensor) on every device, uploaded once per
        device: a Replicated of the copies, or with one device the
        tensor itself."""
        with span("engine.pool_upload"):
            if len(self.devices) == 1:
                return _upload(a, self.device)
            return Replicated({d: _upload(a, d) for d in self._tables})

    def shard(self, chain, *args):
        """``chain(*args)`` over the engine's devices, as one output in
        window order on the first device: a tensor, or a tuple or
        NamedTuple of them (nested) gathered field by field, keeping its
        type. Arguments: host arrays and tensors (window axis first), a
        Replicated, an Escapes, or other values passed as they are. One
        device: ``chain`` on the whole batch, host arrays uploaded. n
        devices: device i gets windows [i*B/n, (i+1)*B/n) of each array,
        its own Replicated copy and the escapes of its rows rebased, and
        its chain runs with it as the current device, on its current
        stream; the outputs are copied to the first device (peer copies
        that order both cards' streams) and concatenated."""
        if len(self.devices) == 1:
            dev = self.device
            with span("engine.upload"):
                args = [_upload(a.esc, dev) if isinstance(a, Escapes)
                        else _upload(a, dev) if isinstance(a, (np.ndarray, torch.Tensor))
                        else a for a in args]
            return chain(*args)
        n = len(self.devices)
        B = next(len(a) for a in args if isinstance(a, (np.ndarray, torch.Tensor)))
        if B % n:
            raise ValueError(f"batch of {B} windows does not divide over {n} devices")
        s = B // n
        outs = []
        for i, dev in enumerate(self.devices):
            lo, hi = i * s, (i + 1) * s

            def part(a):
                if isinstance(a, Replicated):
                    return a[dev]
                if isinstance(a, Escapes):
                    e = torch.as_tensor(a.esc)
                    r, c = e[:, 0], e[:, 1]
                    keep = (r >= lo) & (r < hi)
                    return _upload(torch.stack(
                        [torch.where(keep, r - lo, 0), torch.where(keep, c, a.wp)],
                        dim=1), dev)
                if isinstance(a, (np.ndarray, torch.Tensor)):
                    return _upload(a[lo:hi], dev)
                return a

            with _on(dev):
                with span("engine.upload"):
                    parts = [part(a) for a in args]
                outs.append(chain(*parts))
        return self._gather(outs)

    def _gather(self, outs):
        """Per-shard outputs -> one on the first device, in window order."""
        o = outs[0]
        if isinstance(o, torch.Tensor):
            return torch.cat([x.to(self.device, non_blocking=True) for x in outs])
        fields = [self._gather(list(f)) for f in zip(*outs)]
        return type(o)(*fields) if hasattr(o, "_fields") else type(o)(fields)

    # ---------------- chain stages ------------------------------------
    @annotated("engine._raster_pool")
    def _raster_pool(self, pool, table, emax: int):
        return rasterize_pool_batch(
            pool, table, emax, self.cfg.sizes.lower, self.cfg.sizes.upper,
            self.width,
        )

    def _raster_delta12(self, buf):
        """Wire v6 records; the record count E comes from the buffer width
        (E//2 + E bytes, E even)."""
        return rasterize_delta12_batch(
            buf, 2 * buf.shape[1] // 3, self.cfg.sizes.lower,
            self.cfg.sizes.upper, self.width,
        )

    def _raster_delta(self, db):
        """2-byte (delta, size) pairs [B, F, 2]."""
        return rasterize_delta_batch(
            db, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_packed(self, packed):
        """``(size << 16) | mid`` words [B, F]: the wire of any size range."""
        return rasterize_packed_batch(
            packed, self.cfg.sizes.lower, self.cfg.sizes.upper, self.width
        )

    def _raster_frags(self, mids, sizes, valid):
        """Separate [B, F] midpoint, size and validity arrays."""
        return rasterize_batch(
            mids, sizes, valid, self.cfg.sizes.lower, self.cfg.sizes.upper,
            self.width,
        )

    @staticmethod
    def _dense(mat):
        """Host-rasterized int16 counts [B, S, W], cast to f32 on the
        device (exact: counts are integers)."""
        return mat.to(torch.float32)

    def _logbias_seq(self, codes):
        """Plain uint8 base codes [B, W + L - 1] (the packed wire's
        sequence upload)."""
        return pwm_bias_batch(codes, self._tab(codes)["pwm_log_ratio"])

    @annotated("engine._logbias_2bit")
    def _logbias_2bit(self, packed2, esc):
        return self._logbias_seq(unpack_2bit_codes(packed2, self.seq_codes_width(), esc))

    @annotated("engine._logbias_nib")
    def _logbias_nib(self, packed_codes):
        return self._logbias_seq(unpack_nibble_codes(packed_codes, self.seq_codes_width()))

    @annotated("engine._occ_packed2")
    def _occ_packed2(self, mat):
        """Wire v8 occ bytes: uint8 [B, 2*core + ceil(core/4)]."""
        p = self.cfg.occ
        return occupancy_packed2(
            mat, self._tab(mat)["log_mix"], p.flank, self.core_lo, self.core,
            p.ci_drop, p.exact_tol,
        )

    def _occ_packed(self, mat):
        """Wire v1 occ bytes: uint8 [B, 4, W] (argmax, CI-lower and CI-upper
        grid indices, certified flag) over the whole window."""
        p = self.cfg.occ
        return occupancy_packed(mat, self._tab(mat)["log_mix"], p.flank, p.ci_drop,
                                p.exact_tol)

    def _occ_packed3(self, mat):
        """Wire v2 occ bytes (non-exact mode): uint8 [B, 3, core]."""
        p = self.cfg.occ
        return occupancy_packed3(
            mat, self._tab(mat)["log_mix"], p.flank, self.core_lo, self.core,
            p.ci_drop, p.exact_tol,
        )

    @annotated("engine._bias")
    def _bias(self, log_bias):
        return bias_mat_batch(
            log_bias, self._tab(log_bias)["size_probs"], self.cfg.vmat.lower,
            self.cfg.vmat.upper, self.core_lo, self.core_hi,
        )

    def _scores(self, mat, log_bias):
        """(norm, signal, lr, fuzz, n), each f32 [B, W]: the bias matrix of
        ``log_bias``, then _xcorr. Counts one nuc batch."""
        self.steps += 1
        return self._xcorr(mat, self._bias(log_bias))

    def _fmat(self, mat):
        """The nuc-range rows of the raster, a batch-strided view (no
        copy): what the xcorr kernels read."""
        vlo = self.cfg.vmat.lower - self.cfg.sizes.lower
        return mat[:, vlo : self.cfg.vmat.upper - self.cfg.sizes.lower]

    @annotated("engine._xcorr")
    def _xcorr(self, mat, b0):
        """(norm, signal, lr, fuzz, n), each f32 [B, W], on the configured
        xcorr route (K2 on every route under use_pallas); every route
        gives 0 where n = 0."""
        if self.conv == "diag" or self.use_pallas:  # one K2 launch: xcorr and epilogue
            k2 = nuc_scores(self._fmat(mat), b0, *self._tab(mat)["_diag_kernels"],
                            self.cfg.nuc.var_floor)
            return k2[:, 0], k2[:, 1], k2[:, 2], k2[:, 3], k2[:, 4]
        return self._finish(*self._convs(mat, b0))

    def _convs(self, mat, b0):
        """The eight footprint sums, valid outputs (fo [B, 5, W-K+1], bo
        [B, 3, W-K+1]): two K1 launches ("diag_pallas") or two conv1d
        calls over the build_kernels stacks ("direct"). The "diag" route
        has no such stage: K2 computes the sums and the epilogue in one
        launch."""
        fmat, tables = self._fmat(mat), self._tab(mat)
        if self.conv == "diag_pallas":
            return nuc_conv_outputs(fmat, b0, *tables["_diag_kernels"])
        if self.conv == "direct":
            return nuc_conv_outputs_direct(fmat, b0, tables["f_kernels"],
                                           tables["b_kernels"])
        raise ValueError(f"conv={self.conv!r} computes the sums inside K2")

    def _finish(self, fo, bo):
        """The reference's _convs_impl padding + _finish_impl epilogue:
        valid outputs padded dyad-aligned to W, then (norm, signal, lr,
        fuzz, n)."""
        K = self._tab(fo)["_diag_kernels"][0].shape[1]
        sc = finish_scores(
            pad_valid(fo, self.width, K), pad_valid(bo, self.width, K),
            self.cfg.nuc.var_floor,
        )
        return sc.norm, sc.signal, sc.lr, sc.fuzz, sc.n

    def _margin(self, norm):
        """norm [B, W] -> [B, core + 2m]: the core and the smooth margins."""
        m = self.smooth_margin()
        return norm[:, self.core_lo - m : self.core_lo + self.core + m]

    def _nucm(self, mat, log_bias):
        """f32 [B, core + 2m] norm with smooth margins."""
        return self._margin(self._scores(mat, log_bias)[0])

    def _nuc5(self, mat, log_bias):
        """f32 [B, 5, W] (norm, norm_smooth, signal, lr, fuzz) over the
        whole window (non-exact mode); under "diag" K2's channels
        reordered, the reference's use_pallas form."""
        return self._finish5(self._scores(mat.to(torch.float32), log_bias))

    def _finish5(self, scores):
        """_xcorr's scores -> f32 [B, 5, W] (norm, norm_smooth, signal, lr,
        fuzz): the smooth and the stack of the reference's _finish5_impl."""
        return torch.stack(self._smoothed(scores)[:5], dim=1)

    def _nuc2(self, mat, log_bias):
        """f32 [B, 2, core] (norm, norm_smooth) over the core (wire v2)."""
        t = self._nuc_tracks(mat, log_bias)
        return torch.stack(t[:2], dim=1)[:, :, self.core_lo : self.core_lo + self.core]

    def _occ_tracks(self, mat) -> OccTracks:
        """Float occupancy tracks over the whole window (counts cast to
        f32, as a host-rasterized int16 raster needs)."""
        p, tab = self.cfg.occ, self._tab(mat)
        return OccTracks(*occupancy_batch(
            mat.to(torch.float32), tab["log_mix"], tab["alpha_grid"], p.flank,
            p.ci_drop))

    def _nuc_tracks(self, mat, log_bias) -> NucTracks:
        """_scores (one nuc batch) plus the gaussian-smoothed norm."""
        return self._smoothed(self._scores(mat.to(torch.float32), log_bias))

    def _smoothed(self, scores) -> NucTracks:
        """(norm, signal, lr, fuzz, n) -> NucTracks, with the
        gaussian-smoothed norm."""
        norm, signal, lr, fuzz, n = scores
        smooth = gauss_smooth_batch(norm, self._tab(norm)["smooth_kernel"])
        return NucTracks(norm, smooth, signal, lr, fuzz, n)

    def _full_tracks(self, mat, log_bias):
        mat = mat.to(torch.float32)  # one cast for both branches
        return self._occ_tracks(mat), self._nuc_tracks(mat, log_bias)

    @annotated("engine._nucm16")
    def _nucm16(self, mat, log_bias):
        """u16-packed _nucm: the fused and the standalone nuc paths both
        quantize through here, so equal rasters give equal bytes."""
        return self._u16(self._nucm(mat, log_bias))

    def _nucm24(self, mat, log_bias):
        """u24-packed _nucm (wire v4)."""
        return self._u24(self._nucm(mat, log_bias))

    @staticmethod
    def _u24(x: torch.Tensor) -> torch.Tensor:
        """f32 [..., N] -> uint8 [..., N, 3]: the low mantissa byte dropped
        with round-to-nearest-magnitude (wire v4; relative error at most
        2^-16), byte for byte the reference's engine._u24_impl. Its uint32
        ``(u + 0x80) >> 8`` wraps mod 2^32; torch has no uint32 arithmetic,
        so the word is widened to int64 and masked to 32 bits after the
        add, which gives the same three bytes for every input, negative
        values, infinities and NaN payloads included."""
        u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = ((u + 0x80) & 0xFFFFFFFF) >> 8
        return torch.stack([(u >> (8 * i)) & 0xFF for i in range(3)],
                           dim=-1).to(torch.uint8)

    @staticmethod
    @annotated("engine._u16")
    def _u16(x: torch.Tensor) -> torch.Tensor:
        """f32 [B, N] -> uint8 [B, 2N+8]: per-row affine u16 quantization
        (wire v5), byte for byte the reference's engine._u16_impl. Row
        layout: N low bytes, N high bytes, min (f32 LE), scale (f32 LE).
        q = round_half_even((x - min) / scale), scale = (max - min)/65535."""
        mn = torch.amin(x, dim=1, keepdim=True)
        rng = torch.amax(x, dim=1, keepdim=True) - mn
        scale = rng / 65535.0
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.clamp(torch.round((x - mn) / safe), 0, 65535).to(torch.int32)

        def f32b(v):  # [B, 1] f32 -> [B, 4] uint8 little-endian
            u = v.contiguous().view(torch.int32)
            # arithmetic shifts of a negative word still give the right
            # byte once masked
            return torch.cat(
                [((u >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(4)],
                dim=1,
            )

        meta = torch.cat([f32b(mn), f32b(torch.where(scale > 0, scale, 0.0))], dim=1)
        return torch.cat(
            [(q & 0xFF).to(torch.uint8), (q >> 8).to(torch.uint8), meta], dim=1
        )

    @staticmethod
    @annotated("engine._pack_run")
    def _pack_run(occ2, norm_packed):
        """One uint8 row per window: occ bytes then packed norm."""
        B = occ2.shape[0]
        return torch.cat([occ2.reshape(B, -1), norm_packed.reshape(B, -1)], dim=1)

    # ---------------- entry points ------------------------------------
    # Each takes host arrays or tensors (the pool as either, or as
    # replicate's Replicated) and shards them over the engine's devices.
    def _run(self, mat, log_bias):
        """The fused download of one raster: wire-v8 occ bytes, then the
        u16 norm (one nuc step)."""
        return self._pack_run(self._occ_packed2(mat), self._nucm16(mat, log_bias))

    def _run_pool(self, pool, table, packed_codes, emax):
        return self._run(self._raster_pool(pool, table, emax),
                         self._logbias_nib(packed_codes))

    def _run_pool2(self, pool, table, packed2, esc, emax):
        return self._run(self._raster_pool(pool, table, emax),
                         self._logbias_2bit(packed2, esc))

    def _run_delta(self, db, packed_codes):
        return self._run(self._raster_delta(db), self._logbias_nib(packed_codes))

    def _run_delta12(self, buf, packed_codes):
        return self._run(self._raster_delta12(buf), self._logbias_nib(packed_codes))

    def _pool(self, pool):
        """The pool on every device: as given if it is there already (a
        Replicated, or one device's tensor on that device)."""
        if isinstance(pool, Replicated) or (
                len(self.devices) == 1 and isinstance(pool, torch.Tensor)
                and pool.device == self.device):
            return pool
        return self.replicate(pool)

    def _program(self, name: str, chain):
        """``chain`` as the step program ``name``: captured and replayed
        through ``programs`` on a card, run as itself on the CPU."""
        def run(*args):
            if next(a for a in args if isinstance(a, torch.Tensor)).device.type == "cuda":
                return self.programs(name, chain, *args)
            return chain(*args)
        return run

    def run_step_pool(self, pool, table, packed_codes, emax: int):
        """Wire v7 fragments + nibble sequence codes (the fallback when a
        batch has more N bases than the 2-bit escape list holds)."""
        count("wire.nibble_batches")
        return self.shard(self._program("run_step_pool", self._run_pool),
                          self._pool(pool), table, packed_codes, emax)

    def run_step_pool2(self, pool, table, packed2, esc, emax: int):
        """Wire v7 fragments + wire v9 2-bit sequence plane (the main
        path's dispatch)."""
        return self.shard(self._program("run_step_pool2", self._run_pool2),
                          self._pool(pool), table, packed2,
                          Escapes(esc, self.seq_codes_width()), emax)

    def run_step_delta(self, db, packed_codes):
        """2-byte (delta, size) pairs + nibble sequence codes: run_step_pool's
        bytes on the same windows (the reference's fused delta step)."""
        return self.shard(self._program("run_step_delta", self._run_delta),
                          db, packed_codes)

    def run_step_delta12(self, buf, packed_codes):
        """Wire v6 records + nibble sequence codes: run_step_pool's bytes on
        the same windows (the reference's fused delta12 step)."""
        return self.shard(self._program("run_step_delta12", self._run_delta12),
                          buf, packed_codes)

    def occ_step_pool_p2(self, pool, table, emax: int):
        """Wire v7 fragments -> wire-v8 occ bytes."""
        return self.shard(lambda p, t: self._occ_packed2(self._raster_pool(p, t, emax)),
                          self._pool(pool), table)

    def nuc_step_pool_seq_m16(self, pool, table, packed_codes, emax: int):
        """Wire v7 fragments + nibble sequence codes -> u16 norm with smooth
        margins."""
        return self.shard(
            lambda p, t, c: self._nucm16(self._raster_pool(p, t, emax),
                                         self._logbias_nib(c)),
            self._pool(pool), table, packed_codes)

    # the named download steps, from the module's tables
    occ_step_c = _occ_step("dense", "c")
    occ_step_delta_c = _occ_step("delta", "c")
    occ_step_packed_c = _occ_step("packed", "c")
    occ_step_c3 = _occ_step("dense", "c3")
    occ_step_delta_c3 = _occ_step("delta", "c3")
    occ_step_packed_c3 = _occ_step("packed", "c3")
    occ_step_delta12_c3 = _occ_step("delta12", "c3")
    occ_step_p2 = _occ_step("dense", "p2")
    occ_step_delta_p2 = _occ_step("delta", "p2")
    occ_step_packed_p2 = _occ_step("packed", "p2")
    occ_step_delta12_p2 = _occ_step("delta12", "p2")

    nuc_step_delta_seq_m = _nuc_step("delta", "m", seq=True)
    nuc_step_delta_m = _nuc_step("delta", "m")
    nuc_step_packed_seq_m = _nuc_step("packed", "m", seq=True)
    nuc_step_packed_m = _nuc_step("packed", "m")
    nuc_step_frags_m = _nuc_step("frags", "m")
    nuc_step_dense_m = _nuc_step("dense", "m")

    nuc_step_delta_seq_m16 = _nuc_step("delta", "m16", seq=True)
    nuc_step_delta_m16 = _nuc_step("delta", "m16")
    nuc_step_packed_seq_m16 = _nuc_step("packed", "m16", seq=True)
    nuc_step_packed_m16 = _nuc_step("packed", "m16")
    nuc_step_frags_m16 = _nuc_step("frags", "m16")
    nuc_step_dense_m16 = _nuc_step("dense", "m16")
    nuc_step_delta12_seq_m16 = _nuc_step("delta12", "m16", seq=True)
    nuc_step_delta12_m16 = _nuc_step("delta12", "m16")

    nuc_step_delta_seq_m24 = _nuc_step("delta", "m24", seq=True)
    nuc_step_delta_m24 = _nuc_step("delta", "m24")
    nuc_step_packed_seq_m24 = _nuc_step("packed", "m24", seq=True)
    nuc_step_packed_m24 = _nuc_step("packed", "m24")
    nuc_step_frags_m24 = _nuc_step("frags", "m24")
    nuc_step_dense_m24 = _nuc_step("dense", "m24")

    nuc_step_delta_seq_c2 = _nuc_step("delta", "c2", seq=True)
    nuc_step_delta_c2 = _nuc_step("delta", "c2")
    nuc_step_packed_seq_c2 = _nuc_step("packed", "c2", seq=True)
    nuc_step_packed_c2 = _nuc_step("packed", "c2")
    nuc_step_frags_c2 = _nuc_step("frags", "c2")
    nuc_step_dense_c2 = _nuc_step("dense", "c2")

    nuc_step_delta_seq_c = _nuc_step("delta", "c", seq=True)
    nuc_step_delta_c = _nuc_step("delta", "c")
    nuc_step_packed_seq_c = _nuc_step("packed", "c", seq=True)
    nuc_step_packed_c = _nuc_step("packed", "c")
    nuc_step_frags_c = _nuc_step("frags", "c")
    nuc_step_dense_c = _nuc_step("dense", "c")
    nuc_step_delta12_seq_c = _nuc_step("delta12", "c", seq=True)
    nuc_step_delta12_c = _nuc_step("delta12", "c")

    # ---------------- float-track steps -------------------------------
    # OccTracks / NucTracks over the whole window, from a dense [B, S, W]
    # raster (int16 or f32 counts) or from a wire's raster; each nuc or
    # full call counts one nuc step per shard.
    def occ_step(self, mat) -> OccTracks:
        return self.shard(self._occ_tracks, mat)

    def nuc_step(self, mat, log_bias) -> NucTracks:
        return self.shard(self._nuc_tracks, mat, log_bias)

    def full_step(self, mat, log_bias):
        """(OccTracks, NucTracks) of one raster."""
        return self.shard(self._full_tracks, mat, log_bias)

    # fragment lists: [B, F] midpoints, sizes and validity
    def occ_step_frags(self, mids, sizes, valid) -> OccTracks:
        return self.shard(lambda m, s, v: self._occ_tracks(self._raster_frags(m, s, v)),
                          mids, sizes, valid)

    def nuc_step_frags(self, mids, sizes, valid, log_bias) -> NucTracks:
        return self.shard(
            lambda m, s, v, lb: self._nuc_tracks(self._raster_frags(m, s, v), lb),
            mids, sizes, valid, log_bias)

    def full_step_frags(self, mids, sizes, valid, log_bias):
        return self.shard(
            lambda m, s, v, lb: self._full_tracks(self._raster_frags(m, s, v), lb),
            mids, sizes, valid, log_bias)

    # packed (size << 16) | mid words [B, F], with an f32 log-bias row or
    # plain uint8 sequence codes [B, W + L - 1]
    def occ_step_packed(self, packed) -> OccTracks:
        return self.shard(lambda p: self._occ_tracks(self._raster_packed(p)), packed)

    def nuc_step_packed(self, packed, log_bias) -> NucTracks:
        return self.shard(lambda p, lb: self._nuc_tracks(self._raster_packed(p), lb),
                          packed, log_bias)

    def full_step_packed(self, packed, log_bias):
        return self.shard(lambda p, lb: self._full_tracks(self._raster_packed(p), lb),
                          packed, log_bias)

    def nuc_step_packed_seq(self, packed, codes) -> NucTracks:
        return self.shard(
            lambda p, c: self._nuc_tracks(self._raster_packed(p), self._logbias_seq(c)),
            packed, codes)

    def full_step_packed_seq(self, packed, codes):
        return self.shard(
            lambda p, c: self._full_tracks(self._raster_packed(p), self._logbias_seq(c)),
            packed, codes)

    # 2-byte (delta, size) pairs [B, F, 2], with an f32 log-bias row or
    # nibble-packed sequence codes
    def occ_step_delta(self, db) -> OccTracks:
        return self.shard(lambda d: self._occ_tracks(self._raster_delta(d)), db)

    def nuc_step_delta(self, db, log_bias) -> NucTracks:
        return self.shard(lambda d, lb: self._nuc_tracks(self._raster_delta(d), lb),
                          db, log_bias)

    def nuc_step_delta_seq(self, db, packed_codes) -> NucTracks:
        return self.shard(
            lambda d, c: self._nuc_tracks(self._raster_delta(d), self._logbias_nib(c)),
            db, packed_codes)

    def full_step_delta_seq(self, db, packed_codes):
        return self.shard(
            lambda d, c: self._full_tracks(self._raster_delta(d), self._logbias_nib(c)),
            db, packed_codes)

    # ---------------- host decoders (the reference's, verbatim) --------
    def unpack_run(self, buf: np.ndarray):
        """Host decode of run_step_pool* and run_step_delta* output (wire v5):
        (idx int64 [B, 3, core] = decoded argmax/CI-lo/CI-up grid
        indices, cert bool [B, core], norm f32 [B, core+2m], qstep f64
        [B] = per-window norm quantization scale). Positions with
        cert == False carry placeholder CI indices and MUST be
        f64-refinished (models/occ.py :: _exact_refinish); the nuc tie
        guard widens its margin threshold by max(qstep) of the chunk
        (models/nuc.py :: _tie_guard)."""
        n_occ = 2 * self.core + (self.core + 3) // 4
        idx, cert = self.decode_occ2(buf[:, :n_occ])
        norm, qstep = self.f32_from_u16(buf[:, n_occ:])
        return idx, cert, norm, qstep

    def decode_occ2(self, raw: np.ndarray):
        """uint8 [B, 2*core + ceil(core/4)] (occupancy_packed2, wire v8:
        argmax byte + CI-delta low-nibble byte + packed 5th delta bits)
        -> (idx int64 [B, 3, core] clipped to the grid, cert bool
        [B, core])."""
        G = self.log_mix.shape[1]
        n = self.core
        raw = raw.astype(np.int64)
        ch0, ch1, hib = raw[:, :n], raw[:, n : 2 * n], raw[:, 2 * n :]
        best = ch0 & 0x7F
        cert = (ch0 >> 7).astype(bool)
        # expand the 2-bit hi plane: position p's bits live in byte p//4
        # at bit offset 2*(p%4)
        p = np.arange(n)
        hi2 = (hib[:, p // 4] >> (2 * (p % 4))) & 3
        lo_d = (ch1 & 0xF) | ((hi2 & 1) << 4)
        up_d = (ch1 >> 4) | ((hi2 >> 1) << 4)
        lo = best - lo_d
        up = np.minimum(best + up_d, G - 1)
        return np.stack([best, lo, up], axis=1), cert

    @staticmethod
    def f32_from_u24(b: np.ndarray) -> np.ndarray:
        """Host decode of _u24 output: uint8 [..., N, 3] -> f32."""
        u = (
            b[..., 0].astype(np.uint32)
            | (b[..., 1].astype(np.uint32) << 8)
            | (b[..., 2].astype(np.uint32) << 16)
        ) << 8
        return u.view(np.float32)

    @staticmethod
    def f32_from_u16(buf: np.ndarray):
        """Host decode of _u16 output: uint8 [B, 2N+8] ->
        (norm f32 [B, N], qstep f64 [B]) where qstep = per-row scale
        (a >=2x-conservative bound on the quantization error scale/2,
        leaving headroom for the f32 decode arithmetic)."""
        B, M = buf.shape
        N = (M - 8) // 2
        q = buf[:, :N].astype(np.uint16) | (
            buf[:, N : 2 * N].astype(np.uint16) << 8
        )
        meta = np.ascontiguousarray(buf[:, 2 * N :])
        mn = meta[:, 0:4].copy().view(np.float32).reshape(B, 1)
        scale = meta[:, 4:8].copy().view(np.float32).reshape(B, 1)
        norm = mn + q.astype(np.float32) * scale
        return norm, scale[:, 0].astype(np.float64)
