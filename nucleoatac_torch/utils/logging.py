"""Stage logging and optional device profiling.

Counterpart of nucleoatac_tpu/utils/logging.py: ``log`` and
``stage_timer`` are the reference's (that module imports jax only inside
its own ``maybe_profile``); ``maybe_profile`` here wraps a run in
``torch.profiler`` and writes a TensorBoard trace, as the reference's
``jax.profiler.trace`` does.
"""
from __future__ import annotations

import contextlib

import torch

from nucleoatac_tpu.utils.logging import log, stage_timer

__all__ = ["log", "stage_timer", "maybe_profile"]


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None, device: str | torch.device = "cpu"):
    """Profile the enclosed block into ``trace_dir`` (no-op without one):
    CPU activity, plus CUDA kernels and copies when ``device`` is a CUDA
    device. The trace is a ``*.pt.trace.json`` file that TensorBoard's
    profiler plugin and chrome://tracing read."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(
        activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)
    ):
        yield
    log.info("profile trace written to %s", trace_dir)
