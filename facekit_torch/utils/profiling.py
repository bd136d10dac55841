"""``torch.profiler`` integration, the port's ``facekit/utils/profiling.py``.

Usage: ``with profile_trace("/tmp/facekit-trace"): pipe.recognize_frame(f)``
then open the trace written into the folder in TensorBoard or Perfetto.
CPU and CUDA activities are recorded (torch drops CUDA, with a warning,
where there is no card).
"""

from __future__ import annotations

from contextlib import contextmanager

from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextmanager
def profile_trace(logdir: str):
    """Trace the block; on exit write ``<host>_<pid>.<n>.pt.trace.json``
    into ``logdir`` (created if missing). Yields the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
