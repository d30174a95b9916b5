"""Observability helpers of the port: the log-bucketed latency histogram
(``histogram.py``, a copy of the JAX package's) that ``core/metrics.py``
records into. The JAX package's tracing, probes, Prometheus exposition and
flight recorder are not ported yet."""
