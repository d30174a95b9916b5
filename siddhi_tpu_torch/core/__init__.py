"""Host-side layers: the flattening half of ``pattern.py`` the device
compilers share, and the incremental-aggregation runtime
(``aggregation.AggregationRuntime``) with the host closure it stands on
(``aggregators``, ``event``, ``errors``, ``executor``, ``extension``: copies
of the reference's modules under the same names), and ``columns``, the
columnar edge's chunks and CSV parser."""
