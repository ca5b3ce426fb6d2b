"""Step tracing; counterpart of comic_tpu/utils/profiling.py.

`StepTracer` captures a torch.profiler trace window of training-loop
iterations (config.profile_dir; the examples/sec counters live inline in
the train loops themselves).
"""

from __future__ import annotations

from typing import Optional

from .. import DeviceLike, resolve_device


class StepTracer:
    """Capture a torch.profiler trace of loop iterations [start,
    start+count) into ``log_dir``: one TensorBoard trace-viewer file
    (``torch.profiler.tensorboard_trace_handler``), with one
    ``ProfilerStep#N`` span per traced iteration, CPU activity and, on the
    card (``device`` None: the card), CUDA activity; no shapes recorded.
    Counts CALLS, not step values, so strided and resumed step counters
    still hit the window. Call `step(i)` once per loop iteration and
    `close()` on exit; both are no-ops when log_dir is falsy.

    Unlike comic_tpu's tracer, which stays silent when the profiler fails,
    a profiler that fails to start or stop raises, and so does a trace of
    the card that recorded no device activity (CUPTI unavailable or busy):
    a trace the user asked for is never silently missing."""

    def __init__(self, log_dir: Optional[str], start: int = 10,
                 count: int = 3, *, device: DeviceLike = None):
        self._dir = log_dir
        self._start = start
        self._stop = start + count
        self._calls = 0
        self._prof = None
        self._cuda = bool(log_dir) and resolve_device(device).type == "cuda"

    def step(self, step: int) -> None:
        del step  # iteration count, not the (possibly strided) counter
        if not self._dir:
            return
        i = self._calls
        self._calls += 1
        if self._prof is None:
            if self._start <= i < self._stop:
                self._begin()
        elif i >= self._stop:
            self.close()
        else:
            self._prof.step()  # the next traced iteration's span

    def _begin(self) -> None:
        from torch.profiler import (ProfilerAction, ProfilerActivity,
                                    profile, tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
        # a schedule (always record) makes the profiler mark each step
        prof = profile(activities=activities, record_shapes=False,
                       schedule=lambda _: ProfilerAction.RECORD,
                       on_trace_ready=tensorboard_trace_handler(self._dir))
        prof.start()
        self._prof = prof

    def close(self) -> None:
        """End an open window and write its trace."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        if self._cuda:
            from torch.autograd import DeviceType

            events = prof.profiler.kineto_results.events()
            if not any(e.device_type() == DeviceType.CUDA for e in events):
                raise RuntimeError(
                    f"the trace in {self._dir} recorded no CUDA activity: "
                    "the profiler could not trace the card (CUPTI)")
