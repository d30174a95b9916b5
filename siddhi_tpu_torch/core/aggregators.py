"""Attribute aggregators: sum/avg/min/max/count/distinctCount/stdDev/and/or/
minForever/maxForever/unionSet.

Reference: ``core/query/selector/attribute/aggregator/`` (12 executors, 3,790 LoC).
Each supports retraction (``remove``) so EXPIRED events from windows roll the
aggregate back — the protocol the whole windowed-aggregation design rests on.
"""

from __future__ import annotations

import bisect
import math
from collections import Counter
from typing import Any, Optional

from ..query_api.definition import DataType


class Aggregator:
    """Stateful aggregate with add/remove/reset (one instance per group key)."""

    def add(self, v: Any) -> None:
        raise NotImplementedError

    def remove(self, v: Any) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def value(self) -> Any:
        raise NotImplementedError

    def snapshot(self) -> Any:
        return self.__dict__.copy()

    def restore(self, state: Any) -> None:
        self.__dict__.update(state)


class SumAggregator(Aggregator):
    def __init__(self, is_int: bool):
        self.is_int = is_int
        self.total = 0
        self.count = 0

    def add(self, v):
        if v is None:
            return
        self.total += v
        self.count += 1

    def remove(self, v):
        if v is None:
            return
        self.total -= v
        self.count -= 1

    def reset(self):
        self.total = 0
        self.count = 0

    def value(self):
        if self.count == 0:
            return None
        return int(self.total) if self.is_int else float(self.total)


class CountAggregator(Aggregator):
    def __init__(self):
        self.count = 0

    def add(self, v):
        self.count += 1

    def remove(self, v):
        self.count -= 1

    def reset(self):
        self.count = 0

    def value(self):
        return self.count


class AvgAggregator(Aggregator):
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def add(self, v):
        if v is None:
            return
        self.total += v
        self.count += 1

    def remove(self, v):
        if v is None:
            return
        self.total -= v
        self.count -= 1

    def reset(self):
        self.total = 0.0
        self.count = 0

    def value(self):
        return None if self.count == 0 else self.total / self.count


class MinMaxAggregator(Aggregator):
    """Sorted multiset so EXPIRED removals restore the previous extreme."""

    def __init__(self, is_min: bool):
        self.is_min = is_min
        self.values: list = []

    def add(self, v):
        if v is None:
            return
        bisect.insort(self.values, v)

    def remove(self, v):
        if v is None:
            return
        i = bisect.bisect_left(self.values, v)
        if i < len(self.values) and self.values[i] == v:
            self.values.pop(i)

    def reset(self):
        self.values = []

    def value(self):
        if not self.values:
            return None
        return self.values[0] if self.is_min else self.values[-1]


class ForeverAggregator(Aggregator):
    """minForever/maxForever — never retracts."""

    def __init__(self, is_min: bool):
        self.is_min = is_min
        self.current = None

    def add(self, v):
        if v is None:
            return
        if self.current is None:
            self.current = v
        else:
            self.current = min(self.current, v) if self.is_min else max(self.current, v)

    def remove(self, v):
        pass

    def reset(self):
        # forever aggregators survive resets by design
        pass

    def value(self):
        return self.current


class DistinctCountAggregator(Aggregator):
    def __init__(self):
        self.counter: Counter = Counter()

    def add(self, v):
        self.counter[v] += 1

    def remove(self, v):
        self.counter[v] -= 1
        if self.counter[v] <= 0:
            del self.counter[v]

    def reset(self):
        self.counter = Counter()

    def value(self):
        return len(self.counter)


class StdDevAggregator(Aggregator):
    """Population standard deviation (matches the reference's semantics)."""

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0

    def add(self, v):
        if v is None:
            return
        self.n += 1
        self.sum += v
        self.sumsq += v * v

    def remove(self, v):
        if v is None:
            return
        self.n -= 1
        self.sum -= v
        self.sumsq -= v * v

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0

    def value(self):
        if self.n == 0:
            return None
        mean = self.sum / self.n
        var = max(self.sumsq / self.n - mean * mean, 0.0)
        return math.sqrt(var)


class BoolAggregator(Aggregator):
    """``and`` / ``or`` over booleans."""

    def __init__(self, is_and: bool):
        self.is_and = is_and
        self.true_count = 0
        self.false_count = 0

    def add(self, v):
        if v:
            self.true_count += 1
        else:
            self.false_count += 1

    def remove(self, v):
        if v:
            self.true_count -= 1
        else:
            self.false_count -= 1

    def reset(self):
        self.true_count = 0
        self.false_count = 0

    def value(self):
        if self.is_and:
            return self.false_count == 0
        return self.true_count > 0


class UnionSetAggregator(Aggregator):
    def __init__(self):
        self.counter: Counter = Counter()

    def add(self, v):
        if v is None:
            return
        if isinstance(v, (set, frozenset)):
            for x in v:
                self.counter[x] += 1
        else:
            self.counter[v] += 1

    def remove(self, v):
        if v is None:
            return
        items = v if isinstance(v, (set, frozenset)) else [v]
        for x in items:
            self.counter[x] -= 1
            if self.counter[x] <= 0:
                del self.counter[x]

    def reset(self):
        self.counter = Counter()

    def value(self):
        return set(self.counter)


AGGREGATOR_NAMES = {
    "sum", "avg", "count", "min", "max", "distinctCount", "stdDev",
    "and", "or", "minForever", "maxForever", "unionSet",
}


def make_aggregator(name: str, arg_type: Optional[DataType]) -> Aggregator:
    if name == "sum":
        return SumAggregator(arg_type in (DataType.INT, DataType.LONG, None))
    if name == "count":
        return CountAggregator()
    if name == "avg":
        return AvgAggregator()
    if name == "min":
        return MinMaxAggregator(True)
    if name == "max":
        return MinMaxAggregator(False)
    if name == "minForever":
        return ForeverAggregator(True)
    if name == "maxForever":
        return ForeverAggregator(False)
    if name == "distinctCount":
        return DistinctCountAggregator()
    if name == "stdDev":
        return StdDevAggregator()
    if name == "and":
        return BoolAggregator(True)
    if name == "or":
        return BoolAggregator(False)
    if name == "unionSet":
        return UnionSetAggregator()
    raise KeyError(name)


def aggregator_return_type(name: str, arg_type: Optional[DataType]) -> DataType:
    if name in ("count", "distinctCount"):
        return DataType.LONG
    if name in ("avg", "stdDev"):
        return DataType.DOUBLE
    if name in ("and", "or"):
        return DataType.BOOL
    if name == "unionSet":
        return DataType.OBJECT
    if name == "sum":
        if arg_type in (DataType.FLOAT, DataType.DOUBLE):
            return DataType.DOUBLE
        return DataType.LONG
    return arg_type or DataType.OBJECT
