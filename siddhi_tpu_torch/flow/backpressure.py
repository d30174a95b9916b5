"""Lock ownership test shared by the engine's admission points.

The port keeps only ``rlock_owned`` of the JAX package's
``flow/backpressure.py``: ``AsyncDispatcher.enqueue`` (``core/async_junction.py``)
uses it to tell an in-engine producer, which must not block, from an
external one. The credit gate and overload policies behind
``@app:backpressure`` are not ported yet.
"""

from __future__ import annotations


def rlock_owned(lock) -> bool:
    """True when the calling thread may hold ``lock`` (an ``RLock``).
    ``RLock._is_owned`` is CPython-private; if absent, assume ownership so
    callers never block while possibly holding the lock the drain path
    needs."""
    if lock is None:
        return False
    is_owned = getattr(lock, "_is_owned", None)
    return True if is_owned is None else bool(is_owned())
