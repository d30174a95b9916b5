"""Device-path profiling: ``@app:profile`` brackets device steps with
``torch.profiler`` ranges.

    @app:profile                       -- annotate device steps only
    @app:profile(dir='/tmp/trace')     -- also capture a profiler trace
                                          between start() and shutdown(),
                                          exported there as a Chrome trace

The port's counterpart of the JAX package's ``observability/profiler.py``,
rewritten on ``torch.profiler`` where that one runs on ``jax.profiler``.
Each micro-batch step runs under ``record_function("siddhi:step:<query>")``
and, on the card, under an NVTX range of the same name
(``torch.cuda.nvtx``), so a captured trace (Perfetto, ``chrome://tracing``)
or an ``nsys`` capture attributes device time to the query that spent it.
The capture records the CPU and, for an app on the card, CUDA activity: the
kernels' own records, by their names, carry the card's time.

The async device driver steps on a worker thread of its own, so the capture
asks the profiler to record every thread (``profile_all_threads``); a torch
without that option records the starting thread alone and says so in a
warning.

A capture that fails to start or to export logs a warning: profiling never
takes an app down.

The kernels' records come from CUPTI through Kineto, which drops a record
whose timestamp falls outside its capture window. On the NVIDIA H100
machine this port was measured on, that dropped some or all of them in a
process half a minute or more old (Kineto's log: "Out-of-range";
``tools/profiler_record_loss.py``), while the ``siddhi:step:<query>``
ranges stayed: profile in a young process to see the kernels.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("siddhi_tpu_torch.observability")


class DeviceProfiler:
    """Opt-in step bracketing + optional trace capture for one app."""

    def __init__(self, trace_dir=None, device=None, app_name: str = "app"):
        self.trace_dir = trace_dir
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.app_name = app_name
        self.nvtx = self.device.type == "cuda"
        self.trace_path = None          # the exported Chrome trace
        self._prof = None

    @contextlib.contextmanager
    def annotate(self, name: str):
        """Context manager naming the enclosed device work in a trace (and,
        on the card, in an NVTX range)."""
        with torch.profiler.record_function(name):
            if not self.nvtx:
                yield
                return
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()

    def install(self, bridge) -> None:
        """Wrap the bridge runtime's ``dispatch`` so every device step runs
        under a ``siddhi:step:<query>`` range (wraps whatever is installed —
        including a DeviceGuard's guarded dispatch). Both paths route
        through dispatch: the async driver calls it directly and the sync
        ``process`` is ``collect(dispatch(batch))``."""
        rt = bridge.runtime
        inner = rt.dispatch
        label = f"siddhi:step:{bridge.query_name}"
        profiler = self

        def annotated_dispatch(batch):
            with profiler.annotate(label):
                return inner(batch)

        rt.dispatch = annotated_dispatch

    # -- trace capture ---------------------------------------------------------
    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self) -> None:
        if self.trace_dir is None or self._prof is not None:
            return
        acts = self._activities()
        try:
            from torch._C._profiler import _ExperimentalConfig
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
            log.warning("@app:profile: this torch records the starting "
                        "thread only: async steps are not captured")
        try:
            # one capture a profile, whose events stay to the export
            prof = torch.profiler.profile(activities=acts,
                                          experimental_config=config,
                                          acc_events=True)
            prof.start()
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            log.warning("@app:profile: profiler start failed: %s", e)
            return
        self._prof = prof

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(
                self.trace_dir,
                f"{self.app_name}.{os.getpid()}.{time.time_ns()}.trace.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:  # noqa: BLE001
            log.warning("@app:profile: trace export failed: %s", e)


def parse_profile_annotation(ann, device=None,
                             app_name: str = "app") -> DeviceProfiler:
    return DeviceProfiler(trace_dir=ann.get("dir"), device=device,
                          app_name=app_name)
