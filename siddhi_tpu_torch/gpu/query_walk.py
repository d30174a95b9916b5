"""Kernel side of the scan-walked query windows (``sort``, ``frequent``,
``lossyFrequent``): ``csrc/query_walk.cu``.

``WalkPlan`` is ``query_step.QueryPlan`` bound to the other library: the
same linked programs, argument block (``csrc/query_common.cuh``), checks and
fresh output buffers, one launch per step (the event walk runs inside the
kernel, one CTA). Its own ``launches`` counts them. The plain version is
``query_compile._sort_walk`` / ``_heavy_hitters`` through
``stream_step_plain``.
"""

from __future__ import annotations

from .query_step import QueryPlan


class WalkPlan(QueryPlan):
    """The launch wrapper of ``csrc/query_walk.cu``."""

    launches = 0
    LIB = "query_walk"
    WHAT = "query walk kernel"

    def step_launches(self) -> int:
        """One launch a step: the walk."""
        return 1
