"""The single-stream query shapes, wire batches and tolerances shared by the
query tests.

``tests/test_torch_query_compile.py`` (``CASES``) and
``tests/test_torch_query_windows.py`` (``WINDOW_CASES``: the tumbling,
hopping and scan-walked windows) run every case through the JAX package and
the port; ``chip_smoke.py`` runs the same cases on the card (kernel against
plain version), and ``CARD_CASES``, wider windows whose every kernel pass
spans several chunks of a block, there only. This module imports only the port, never
the JAX package, so the chip script can load it where JAX is not installed
(and ``python -m pytest tests/test_torch_query_shapes.py -m cuda`` runs the
kernel against the plain version there).

Tolerances (``compare``): everything is exact — masks, row order, counts,
int64 sums, avgs of int64 sums, min/max, projections, window tails,
timestamps, every integer and boolean state leaf — except the float32
sums/avgs, the float32 Kahan and Welford state leaves and stdDev. Their
limits come from a ``Scale``, the sums of the values the compared steps
read (``step_scale`` when both sides read the same state, as the kernel
and the plain version do; ``next_scale`` when each side carries its own:
the largest ``step_scale`` so far for a window, whose tails both sides
hold exactly alike, and for running and per-key sums the sum of
``batch_scale`` over every batch fed, plus ``carried_scale`` of any state
resumed from; an unwindowed group-by's rows each take their own key's
sum over every batch fed, ``key_scales``):

- float32 sums, ``*_fsums``/``*_fcomp``: prefix sums round in a different
  order in each implementation (the reference's f32 cumsum rounds at every
  addition; the port accumulates each prefix in f64 and rounds once), so a
  window sum, a difference of two prefixes, carries an error of a few ulps
  of the prefix read, not of the sum: ``|got - ref| <= 2**-20 * (1 + s1)``,
  where ``s1`` is the sum of |x| over every value a prefix of one float32
  sum/avg lane can read (the window's tail, every slot of it, since a
  prefix starts at slot 0, or the carried sums, plus the batch's
  arguments), largest over the lanes; min/max identities (±inf) are never
  part of it; a grouped sum reads its own bucket's prefix, which the sum
  over all buckets bounds;
  the scan-walked windows' sums read their buffer or table
  (``sort_fvals``, ``hh_fvals``) and the heavy hitters' running sums
  (``hh_run_f``, held like a running sum: each side carries its own);
- float32 avgs: that bound divided by the row's count (``max(count, 1)``,
  read from the query's ``count()`` output; without one, the count is
  taken as 1);
- ``*_smean``: ``2**-20 * (1 + sm)``, ``sm`` the same sum over the stdDev
  arguments and carried means; ``*_sm2``: ``2**-20 * (1 + s2)`` with ``s2``
  bounding every centred second-moment prefix (4 * the sum of squared
  stdDev arguments, plus the carried moments);
- stdDev: the variance is a difference of two such prefixes divided by the
  count, so the standard deviation carries ``sqrt(u * (1 + s2) / n)``;
  with ``n >= 1``, ``|got - ref| <= 1e-6 * |ref| + sqrt(u * (1 + s2))``
  per step, where ``u`` is ``2**-20`` for the running and per-key float32
  Welford moments and for ``sort``'s float32 two-pass moments over its
  buffer, and ``2**-40`` for a window's, which every implementation
  accumulates in float64; wherever a count output shows at least 4 events
  also ``<= 1e-5 * |ref| + 1e-4`` (``STD_RTOL``).

Every other output of the new windows is exact: the tumbling windows'
outputs over all N + B slots (remainder and batch), hopping's flush slots,
row order, ``ts``, and the counters ``rem_count``, ``window_drops``,
``ts_regressions``, ``batch_base``, ``hop_next``, ``sort_n``, ``hh_total``
and the heavy-hitter table (keys, counts, deltas, int lanes).

The kernel and the plain version accumulate prefixes the same way, so on
the card they agree within these bounds (most steps exactly).
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.compiler import parse
from siddhi_tpu_torch.gpu.expr_compile import as_tensor
from siddhi_tpu_torch.gpu.query_compile import (CompiledStreamQuery, group_bucket,
                                                stream_step_plain)
from siddhi_tpu_torch.gpu.state_io import (query_state_from_numpy,
                                           state_from_numpy, state_to_numpy)

SCHEMA = "define stream S (sym string, price double, vol long, n int, ets long);\n"

# name → (query, CompiledStreamQuery keyword arguments)
QUERIES = {
    "length_filter": ("""
from S[price > 20.0 and vol < 900]#window.length(8)
select sym, sum(vol) as tv, sum(price) as tp, count() as c, avg(price) as ap,
       avg(n) as an insert into O;""", {}),
    "length_minmax_std": ("""
from S#window.length(12)
select min(price) as lo, max(price) as hi, min(n) as ln, max(vol) as hv,
       stdDev(price) as sd, stdDev(n) as sdn insert into O;""", {}),
    "time": ("""
from S#window.time(40)
select sym, sum(price) as t, count() as c, min(vol) as mv, stdDev(price) as sd
insert into O;""", {"window_capacity": 32}),
    "time_drops": ("""
from S#window.time(100000) select sum(vol) as s, max(price) as m insert into O;
""", {"window_capacity": 8}),
    "external_time": ("""
from S#window.externalTime(ets, 60)
select sum(vol) as s, count() as c, max(price) as m insert into O;""",
                      {"window_capacity": 32}),
    "time_length": ("""
from S#window.timeLength(50, 6)
select sym, sum(price) as t, count() as c, min(price) as lo insert into O;""",
                    {}),
    "filter_running": ("""
from S[vol > 100]
select sym, sum(vol) as s, count() as c, eventTimestamp() as e insert into O;
""", {}),
    "batch": ("""
from S#window.batch()
select sum(vol) as s, avg(price) as a, count() as c, stdDev(price) as sd,
       min(price) as lo insert into O;""", {}),
    "batch_values": ("""
from S[n > 2]#window.batch()
select sym, n * 2 as n2, eventTimestamp() as e insert into O;""", {}),
    "running": ("""
from S
select sum(price) as t, sum(n) as sn, avg(vol) as av, count() as c,
       min(price) as lo, max(n) as hn, stdDev(price) as sd insert into O;""",
                {}),
    "grouped": ("""
from S
select sym, sum(price) as t, sum(vol) as v, count() as c, avg(price) as a,
       min(price) as lo, max(vol) as hv, stdDev(price) as sd
group by sym insert into O;""", {"group_capacity": 16}),
    "grouped_having": ("""
from S[price > 10.0]
select sym, count() as c, sum(vol) as v group by sym
having c > 3 and v > 1000 insert into O;""", {"group_capacity": 16}),
    "grouped_pair": ("""
from S select sym, n, sum(vol) as v, count() as c group by sym, n
insert into O;""", {"group_capacity": 16}),
    "grouped_long_collide": ("""
from S select vol, count() as c, sum(price) as t group by vol insert into O;
""", {"group_capacity": 8}),
    "grouped_three": ("""
from S select sym, n, count() as c, stdDev(price) as sd
group by sym, n, vol insert into O;""", {"group_capacity": 16}),
    "length_grouped": ("""
from S#window.length(10)
select sym, sum(vol) as v, sum(price) as t, count() as c, avg(price) as a
group by sym insert into O;""", {"group_capacity": 16}),
    "time_grouped_having": ("""
from S[vol > 100]#window.time(50)
select sym, sum(vol) as v, count() as c group by sym having v > 800
insert into O;""", {"group_capacity": 16, "window_capacity": 32}),
    "length_grouped_collide": ("""
from S#window.length(16)
select vol, sum(price) as t, count() as c group by vol insert into O;""",
                               {"group_capacity": 4}),
    "projection": ("""
from S[price > 50.0]
select sym, price * 2.0 as p2, vol / 3 as v3, n % 4 as nm,
       eventTimestamp() - 1000 as e insert into O;""", {}),
    "having_window": ("""
from S#window.length(5) select sym, sum(price) as t having t > 150.0
insert into O;""", {}),
    "length_values": ("""
from S#window.length(3) select sym, price insert into O;""", {}),
    # inf, -inf and NaN prices (WIRE_NONFINITE): the reference's one-hot
    # grouped sums turn them into NaN in every other key's sum
    "grouped_nonfinite": ("""
from S
select sym, sum(price) as t, avg(price) as a, count() as c, max(price) as hi,
       stdDev(price) as sd, sum(vol) as v group by sym insert into O;""",
                          {"group_capacity": 8}),
    "length_grouped_nonfinite": ("""
from S#window.length(10)
select sym, sum(price) as t, avg(price) as a, count() as c group by sym
insert into O;""", {"group_capacity": 8}),
    "time_grouped_nonfinite": ("""
from S[vol > 50]#window.time(40)
select sym, sum(price) as t, count() as c group by sym insert into O;""",
                               {"group_capacity": 8, "window_capacity": 32}),
}

# the tumbling and scan-walked windows (their JAX parity cases are
# tests/test_torch_query_windows.py's)
WINDOW_QUERIES = {
    "length_batch": ("""
from S[price > 20.0]#window.lengthBatch(6)
select sum(price) as t, sum(vol) as v, count() as c, avg(price) as ap,
       min(price) as lo, max(vol) as hv, stdDev(price) as sd insert into O;""",
                     {}),
    "length_batch_values": ("""
from S#window.lengthBatch(20)
select sym, price, n, eventTimestamp() as e insert into O;""", {}),
    "length_batch_having": ("""
from S#window.lengthBatch(4) select sym, sum(vol) as v having v > 1500
insert into O;""", {}),
    "time_batch": ("""
from S#window.timeBatch(10)
select sum(price) as t, count() as c, max(vol) as hv, min(n) as ln,
       stdDev(price) as sd insert into O;""", {"window_capacity": 32}),
    "time_batch_values": ("""
from S[vol > 100]#window.timeBatch(25)
select sym, vol, eventTimestamp() as e insert into O;""",
                          {"window_capacity": 3}),
    "external_time_batch": ("""
from S#window.externalTimeBatch(ets, 20)
select sum(vol) as v, count() as c, avg(price) as a, ets insert into O;""",
                            {"window_capacity": 24}),
    "session": ("""
from S#window.session(5)
select sym, sum(vol) as v, count() as c, max(price) as m insert into O;""",
                {"window_capacity": 12}),
    "session_drops": ("""
from S#window.session(30) select sum(price) as t, count() as c insert into O;
""", {"window_capacity": 4}),
    "delay": ("""
from S[price > 30.0]#window.delay(6) select sym, price, vol insert into O;""",
              {"window_capacity": 16}),
    "delay_drops": ("""
from S#window.delay(60) select sym, n, eventTimestamp() as e
having n > 0 insert into O;""", {"window_capacity": 6}),
    "hopping": ("""
from S#window.hopping(20, 5)
select sym, sum(price) as t, count() as c, min(vol) as lv,
       stdDev(price) as sd insert into O;""", {"window_capacity": 32}),
    "hopping_having": ("""
from S[vol > 50]#window.hopping(40, 10)
select sum(vol) as v, count() as c, avg(price) as a having c > 2
insert into O;""", {"window_capacity": 16}),
    "sort": ("""
from S#window.sort(5, price)
select sym, sum(price) as t, sum(vol) as v, count() as c, max(n) as mx,
       stdDev(price) as sd insert into O;""", {}),
    "sort_desc_int": ("""
from S#window.sort(4, n, 'desc')
select n, sum(vol) as v, min(price) as lo, count() as c, avg(vol) as av
insert into O;""", {}),
    "sort_long_sentinel": ("""
from S[price > 10.0]#window.sort(3, vol)
select vol, count() as c, sum(price) as t having c > 1 insert into O;""", {}),
    "sort_nan": ("""
from S#window.sort(40, price)
select sym, price, sum(vol) as v, count() as c, max(n) as mx insert into O;""",
                 {}),
    "sort_nan_desc": ("""
from S#window.sort(30, price, 'desc')
select price, sum(price) as t, count() as c insert into O;""", {}),
    "frequent": ("""
from S#window.frequent(3, sym)
select sym, sum(price) as t, sum(vol) as v, count() as c, avg(price) as a
insert into O;""", {}),
    "frequent_pair": ("""
from S#window.frequent(4, sym, n)
select sym, n, count() as c, sum(vol) as v insert into O;""", {}),
    "lossy": ("""
from S#window.lossyFrequent(0.3, 0.08, sym)
select sym, sum(price) as t, count() as c, avg(vol) as av insert into O;""",
              {}),
    "lossy_default_error": ("""
from S[vol > 100]#window.lossyFrequent(0.2, n)
select n, sum(vol) as v, count() as c having c > 1 insert into O;""",
                            {"window_capacity": 8}),
    # the heavy-hitter walk's edges: a 164-slot lossy table over ~1,000 keys
    # (a new bucket, and a prune, every 100 events; CARRIED starts it from
    # full and nearly full tables); LONG keys equal in their low 32 bits
    # (WIRE_HIGH_KEYS); a 5-slot frequent
    # table over 12 keys, whose decrement-alls evict several keys at once;
    # tables too large for the kernel's shared memory
    "lossy_near_full": ("""
from S#window.lossyFrequent(0.05, 0.01, vol)
select vol, sum(price) as t, count() as c insert into O;""",
                        {"window_capacity": 8}),
    "lossy_high_keys": ("""
from S#window.lossyFrequent(0.1, 0.05, vol)
select vol, sum(price) as t, count() as c insert into O;""",
                        {"window_capacity": 8}),
    "frequent_high_keys": ("""
from S#window.frequent(20, vol)
select vol, sum(price) as t, count() as c insert into O;""", {}),
    "frequent_evict": ("""
from S#window.frequent(5, n)
select n, sum(price) as t, sum(vol) as v, count() as c insert into O;""", {}),
    "frequent_big": ("""
from S#window.frequent(12000, vol)
select vol, sum(price) as t, count() as c insert into O;""", {}),
    "lossy_big": ("""
from S#window.lossyFrequent(0.001, 0.0001, vol)
select vol, sum(price) as t, count() as c insert into O;""", {}),
}
QUERIES.update(WINDOW_QUERIES)
# wider windows, for the card only (kernel against plain version): every
# scan, shift and table pass spans several chunks of a kernel's block
CARD_QUERIES = {
    "length_batch_wide": ("""
from S[vol > 10]#window.lengthBatch(1500)
select sum(price) as t, count() as c, max(vol) as hv, stdDev(price) as sd
insert into O;""", {}),
    "session_wide": ("""
from S#window.session(40) select sum(price) as t, count() as c, min(n) as ln
insert into O;""", {"window_capacity": 3000}),
    "delay_wide": ("""
from S#window.delay(200) select sym, price insert into O;""",
                   {"window_capacity": 2000}),
    "hopping_wide": ("""
from S#window.hopping(300, 40)
select sum(vol) as v, count() as c, max(price) as m insert into O;""",
                     {"window_capacity": 2000}),
    "sort_wide": ("""
from S#window.sort(700, price)
select sum(vol) as v, count() as c, min(n) as ln, stdDev(price) as sd
insert into O;""", {}),
    "frequent_wide": ("""
from S#window.frequent(600, vol) select vol, count() as c, sum(price) as t
insert into O;""", {}),
    "lossy_wide": ("""
from S#window.lossyFrequent(0.02, 0.001, vol)
select vol, count() as c, sum(price) as t insert into O;""", {}),
}
QUERIES.update(CARD_QUERIES)
# axes that span several tiles of the kernel's pass grid (2,048 positions)
# and end inside one (N = 8,192 + B = 1,000 gives P = 9,192): a bucket of
# the grouped sort over many tiles (K = 4), min/max ranges across chunks of
# 1,024, a timeBatch bucket boundary and a session gap of exactly the
# duration at the tile edges 2,048 and 4,096 (WIRE_EDGES), non-finite
# values in the third tile only (WIRE_LATE_NONFINITE), flush ranges across
# tiles; their wires fill every batch but step 2's, which is empty
TILE_QUERIES = {
    "length_grouped_tiles": ("""
from S#window.length(8192)
select sym, sum(price) as t, sum(vol) as v, count() as c, avg(price) as a
group by sym insert into O;""", {"group_capacity": 4}),
    "length_minmax_tiles": ("""
from S#window.length(8192)
select min(price) as lo, max(vol) as hv, stdDev(price) as sd, count() as c,
       sum(price) as t insert into O;""", {}),
    "grouped_nonfinite_late": ("""
from S
select sym, sum(price) as t, avg(price) as a, count() as c, max(price) as hi,
       stdDev(price) as sd group by sym insert into O;""",
                               {"group_capacity": 8}),
    "time_batch_tiles": ("""
from S#window.timeBatch(10)
select sum(price) as t, count() as c, max(vol) as hv, min(n) as ln,
       stdDev(price) as sd insert into O;""", {"window_capacity": 8192}),
    "session_tiles": ("""
from S#window.session(5)
select sum(price) as t, count() as c, min(n) as ln insert into O;""",
                      {"window_capacity": 8192}),
    "hopping_tiles": ("""
from S#window.hopping(2000, 300)
select sum(price) as t, count() as c, max(vol) as hv, stdDev(price) as sd
insert into O;""", {"window_capacity": 8192}),
}
QUERIES.update(TILE_QUERIES)
# wire options per query: int extremes (the integer minimum and maximum in
# the int/long columns) for the sort keys' sentinel and negation edges
WIRE_EXTREMES = ("sort_desc_int", "sort_long_sentinel")
# and non-finite prices (inf, -inf, NaN)
WIRE_NONFINITE = ("grouped_nonfinite", "length_grouped_nonfinite",
                  "time_grouped_nonfinite", "sort_nan", "sort_nan_desc")
# and vol keys that differ only in their high 32 bits
WIRE_HIGH_KEYS = ("lossy_high_keys", "frequent_high_keys")
# and full batches (but an empty one at step 2)
WIRE_FULL = tuple(TILE_QUERIES)
# and exact timestamp increments at these event indexes (at step 0 every
# event sits at its own index of the axis)
WIRE_EDGES = {"time_batch_tiles": {2048: 10, 4096: 10},
              "session_tiles": {2048: 5, 4096: 5}}
# and non-finite prices from this event index on only
WIRE_LATE_NONFINITE = {"grouped_nonfinite_late": 4200}


# queries the reference refuses (the port must refuse them with the same
# message), one small query per tumbling and walked window, and queries of
# the sliding half
REFUSAL_SCHEMA = "define stream S (sym string, v double, w long, k long, n int, ets long);\n"
REFUSED = [
    "from S#window.cron('*/2 * * * * ?') select sum(w) as s insert into O;",
    "from S select distinctCount(v) as dc insert into O;",
    "from S select sum() as t insert into O;",
    "from S select min(sym) as m insert into O;",
    "from S#window() select sum(w) as s insert into O;",
    "from S#window.length(5)#window.time(5) select sum(w) as s insert into O;",
    "from S#window.externalTime(ets) select sum(w) as s insert into O;",
    "from S#window.externalTime(v, 10) select sum(w) as s insert into O;",
    "from S#window.batch(5) select sum(w) as s insert into O;",
    "from S#window.length(5) select sym, min(v) as m group by sym insert into O;",
    "from S#window.time(5) select sym, stdDev(v) as m group by sym insert into O;",
    "from S select v, sum(w) as s group by v insert into O;",
    "from S#window.batch() select sym, sum(w) as s group by sym insert into O;",
    "from S select sum(w) as s having q > 1 insert into O;",
    "from S[w > v] select w insert into O;",
    "from S#window.sort(5, w, 'asc', k) select sum(w) as s insert into O;",
    "from S#window.sort(5, sym) select count() as c insert into O;",
    "from S#window.hopping(300, 100) select w insert into O;",
    "from S#window.hopping(300, 0) select sum(w) as s insert into O;",
    "from S#window.timeBatch(10, 5) select sum(w) as s insert into O;",
    "from S#window.session(10, sym) select sum(w) as s insert into O;",
    "from S#window.frequent(0, sym) select count() as c insert into O;",
    "from S#window.frequent(3, v) select count() as c insert into O;",
    "from S#window.lossyFrequent(0.1, 0.0, sym) select count() as c insert into O;",
    "from S#window.delay(10) select sum(w) as s insert into O;",
    "from S#window.lengthBatch(4) select sym, sum(w) as s group by sym insert into O;",
    "from S#window.frequent(3, sym) select min(v) as m insert into O;",
]
# queries both packages compile whose every step raises AttributeError: a
# bare constant projection or aggregate argument is a Python scalar there
STEP_RAISES = [
    "from S select sym, 1 as one insert into O;",
    "from S#window.length(4) select -1 as m, sum(w) as s insert into O;",
    "from S select sym, sum(2.0) as t, count() as c insert into O;",
    "from S#window.sort(3, v) select true as t insert into O;",
]
# one small query per window of this slice: both packages compile it
STAGED = {
    "lengthBatch": "#window.lengthBatch(4) select sum(w) as s",
    "timeBatch": "#window.timeBatch(10) select sum(w) as s",
    "externalTimeBatch": "#window.externalTimeBatch(ets, 10) select sum(w) as s",
    "session": "#window.session(10) select sum(w) as s",
    "delay": "#window.delay(10) select w",
    "sort": "#window.sort(4, w) select sum(w) as s",
    "hopping": "#window.hopping(30, 10) select sum(w) as s",
    "frequent": "#window.frequent(3, sym) select count() as c",
    "lossyFrequent": "#window.lossyFrequent(0.3, 0.08, sym) select count() as c",
}
ACCEPTED = [
    "from S[v > 1.0]#window.length(4) select sym, sum(w) as s insert into O;",
    "from S select sym, count() as c group by sym insert into O;",
    "from S#window.timeLength(10, 3) select max(v) as m insert into O;",
    "from S#window.externalTime(ets, 10) select avg(v) as a insert into O;",
    "from S#window.batch() select stdDev(v) as sd insert into O;",
    "from S select sym, k, n, sum(v) as t group by sym, k, n insert into O;",
]

# (query, batch capacity B)
CASES = [(name, 16) for name in QUERIES
         if name not in WINDOW_QUERIES and name not in CARD_QUERIES
         and name not in TILE_QUERIES] + [
    ("length_filter", 5), ("time", 64), ("external_time", 7),
    ("grouped", 64), ("length_grouped", 3), ("batch", 9),
    ("length_grouped_tiles", 1000), ("length_minmax_tiles", 1000),
    ("grouped_nonfinite_late", 4500),
]
IDS = [f"{n}-B{b}" for n, b in CASES]
# the tumbling windows at B < N and with more hop boundaries than flush
# slots, the walked ones at B = 64 too
WINDOW_CASES = [(name, 16) for name in WINDOW_QUERIES] + [
    ("length_batch", 5), ("length_batch_values", 7), ("time_batch", 64),
    ("session", 3), ("delay_drops", 4), ("hopping", 3), ("hopping", 64),
    ("sort", 64), ("frequent", 64), ("lossy", 64), ("lossy_near_full", 64),
    ("frequent_evict", 64), ("time_batch_tiles", 5000),
    ("session_tiles", 5000), ("hopping_tiles", 1000),
]
WINDOW_IDS = [f"{n}-B{b}" for n, b in WINDOW_CASES]
CARD_CASES = [(name, 16) for name in CARD_QUERIES] + [
    ("length_batch_wide", 256), ("hopping_wide", 256), ("sort_wide", 256),
    ("frequent_wide", 256),
]
CARD_IDS = [f"{n}-B{b}" for n, b in CARD_CASES]
STEPS = 5
STD_RTOL = 1e-5


def app_text(name: str) -> str:
    return SCHEMA + QUERIES[name][0]


def compile_port(name: str, B: int, device) -> CompiledStreamQuery:
    app = parse(app_text(name))
    return CompiledStreamQuery(app.queries[0], app.stream_definitions["S"],
                               B, device=device, **QUERIES[name][1])


class Wire:
    """Seeded wire batches (``BatchBuilder.emit()`` layout) with stale
    values past each batch's count."""

    def __init__(self, seed: int, B: int, extremes: bool = False,
                 nonfinite: bool = False, high_keys: bool = False,
                 full: bool = False, edges: dict | None = None,
                 late_nonfinite: int | None = None):
        self.rng = np.random.default_rng(seed)
        self.B = B
        self.ts = 1000
        self.extremes = extremes
        self.nonfinite = nonfinite or late_nonfinite is not None
        self.late = late_nonfinite or 0
        self.high_keys = high_keys
        self.full = full
        self.edges = edges or {}

    def batch(self, step: int) -> dict:
        rng, B = self.rng, self.B
        count = 0 if step == 2 and B > 8 else int(rng.integers(B // 2, B + 1))
        if self.full and step != 2:
            count = B
        inc = rng.choice([0, 0, 1, 2, 5, 30], size=B)
        for i, d in self.edges.items():
            if i < B:
                inc[i] = d
        ts = self.ts + np.cumsum(inc)
        self.ts = int(ts[max(count - 1, 0)]) if count else self.ts
        cols = {
            "sym": rng.integers(1, 6, B).astype(np.int32),
            "price": np.round(rng.uniform(0, 100, B), 2).astype(np.float32),
            "vol": rng.integers(0, 1000, B).astype(np.int64),
            "n": rng.integers(-2, 10, B).astype(np.int32),
            "ets": (ts + rng.integers(-40, 20, B)).astype(np.int64),
        }
        if self.extremes:
            for k, dt in (("n", np.int32), ("vol", np.int64)):
                info = np.iinfo(dt)
                pick = rng.random(B)
                cols[k][pick < 0.15] = info.min
                cols[k][pick > 0.9] = info.max
        if self.nonfinite:
            pick = rng.random(B)
            pick[:self.late] = 1.0
            price = cols["price"]
            price[pick < 0.1] = np.inf
            price[(pick >= 0.1) & (pick < 0.18)] = np.nan
            price[(pick >= 0.18) & (pick < 0.2)] = -np.inf
        if self.high_keys:
            cols["vol"] = ((cols["vol"] % 40) << 32) | 0x5EED
        valid = np.zeros(B, bool)
        valid[:count] = True
        return {"cols": cols, "ts": ts.astype(np.int64), "valid": valid,
                "count": count}


def wire_for(name: str, B: int) -> Wire:
    """The seeded wire of query ``name`` at batch capacity B."""
    return Wire(7, B, extremes=name in WIRE_EXTREMES,
                nonfinite=name in WIRE_NONFINITE,
                high_keys=name in WIRE_HIGH_KEYS, full=name in WIRE_FULL,
                edges=WIRE_EDGES.get(name),
                late_nonfinite=WIRE_LATE_NONFINITE.get(name))


@dataclass
class Scale:
    """Sums of the values a comparison's float32 arithmetic reads (see the
    module docstring), one per lane, since a prefix reads one lane: ``s1``
    over each float32 sum/avg lane, ``sm`` over each stdDev lane, ``s2``
    bounding each stdDev lane's centred second moments. A limit takes the
    largest lane. ``row``, where set (``bucket_rows``, ``next_scale``),
    holds per grouped float32 sum/avg output the ``s1`` of each row's own
    bucket, which its limit takes instead."""

    s1: np.ndarray | float = 0.0
    sm: np.ndarray | float = 0.0
    s2: np.ndarray | float = 0.0
    row: dict | None = None
    keys: dict | None = None    # unwindowed group-by: per output, the
    # s1 of each bucket summed over every batch fed ([K] float64)

    def __add__(self, o: "Scale") -> "Scale":
        return Scale(self.s1 + o.s1, self.sm + o.sm, self.s2 + o.s2)

    def top(self, name: str) -> float:
        return float(np.max(getattr(self, name), initial=0.0))


def batch_scale(q, cols, ts, valid) -> Scale:
    """The scale of one batch: its valid events' float32 sum/avg and stdDev
    arguments, as the query's argument programs compute them."""
    env = {**cols, "__ts__": ts, "__device__": ts.device}

    def args(idx):
        # non-finite values are compared exactly, never scaled
        out = []
        for i in idx:
            x = torch.broadcast_to(as_tensor(q.specs[i].fn(env), env),
                                   valid.shape)[valid].double()
            out.append(x[torch.isfinite(x)])
        return out

    f, s = args(q.fagg_idx), args(q.sagg_idx)
    return Scale(np.array([float(x.abs().sum()) for x in f]),
                 np.array([float(x.abs().sum()) for x in s]),
                 np.array([4.0 * float((x * x).sum()) for x in s]))


def carried_scale(q, state) -> Scale:
    """The scale of what a step reads from its state: every slot of the
    window's float32 sum and stdDev tails (a prefix starts at slot 0), or
    the carried per-key/running sums, means and moments."""
    AF, AS = len(q.fagg_idx), len(q.sagg_idx)

    def lanes(name, A, fn=torch.abs):
        if name not in state or not A:
            return np.zeros(A)
        x = state[name].double()
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        return fn(x).reshape(A, -1).sum(1).cpu().numpy()

    def sq(x):
        return x * x

    sc = Scale(lanes("tail_fvals", AF) + lanes("key_fsums", AF)
               + lanes("run_fsums", AF) + lanes("sort_fvals", AF)
               + lanes("hh_fvals", AF) + lanes("hh_run_f", AF),
               lanes("tail_svals", AS) + lanes("key_smean", AS)
               + lanes("run_smean", AS) + lanes("sort_svals", AS),
               4.0 * lanes("tail_svals", AS, sq) + lanes("key_sm2", AS)
               + lanes("run_sm2", AS) + 4.0 * lanes("sort_svals", AS, sq))
    for pre in ("key", "run"):
        if f"{pre}_smean" in state and AS:
            m = state[f"{pre}_smean"].double()
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            n = state[f"{pre}_scnt"].double() + q.B
            sc.s2 = sc.s2 + 4.0 * (n * m * m).reshape(AS, -1).sum(1).cpu().numpy()
    return sc


def _finite_abs(x):
    x = x.double()
    return torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x))


def bucket_batch(q, cols, ts, valid):
    """A group-by's batch by bucket: each compacted position's bucket id
    ([B] int64) and, per float32 sum/avg output, the |x| of the batch's
    accepted events summed per bucket ([K] float64)."""
    env = {**cols, "__ts__": ts, "__device__": ts.device}
    mask = valid
    for fn in q.filter_fns:
        mask = torch.logical_and(mask, as_tensor(fn(env), env))
    mask = torch.broadcast_to(mask, valid.shape)
    k, B = int(mask.sum()), q.B

    def compact(x):
        out = torch.zeros(B, dtype=x.dtype, device=x.device)
        out[:k] = x[mask]
        return out

    keys = group_bucket(q, [compact(cols[g].to(torch.int64))
                            for g in q.group_keys])[0].long()
    per = {}
    for i in q.fagg_idx:
        x = torch.broadcast_to(as_tensor(q.specs[i].fn(env), env), valid.shape)
        acc = torch.zeros(q.K, dtype=torch.float64, device=ts.device)
        per[q.specs[i].name] = acc.index_add_(0, keys, _finite_abs(compact(x)))
    return keys, per


def bucket_rows(q, state, cols, ts, valid) -> dict | None:
    """Per grouped float32 sum/avg output, each output row's ``s1`` over its
    own bucket alone: the bucket's |x| over the batch's accepted events and
    the window's tail slots, or its carried per-key sum (a row reads only
    its bucket's prefixes). ``None`` where the query has none."""
    if not q.group_keys or not q.fagg_idx:
        return None
    keys, per = bucket_batch(q, cols, ts, valid)
    rows = {}
    for lane, i in enumerate(q.fagg_idx):
        acc = per[q.specs[i].name]
        if "tail_fvals" in state:
            acc.index_add_(0, state["tail_gkey"].long(),
                           _finite_abs(state["tail_fvals"][lane]))
        if "key_fsums" in state:
            acc += _finite_abs(state["key_fsums"][lane])
        rows[q.specs[i].name] = acc[keys].cpu().numpy()
    return rows


def key_scales(q, keys: dict | None, state, cols, ts, valid):
    """An unwindowed group-by's per-bucket ``s1`` after one more batch, each
    side carrying its own per-key sums: ``keys`` (``None`` before the first
    step: the carried per-key sums of ``state``, so a resumed state counts)
    plus the batch's |x| per bucket; and each output row's own bucket's
    (``Scale.row``)."""
    pos, per = bucket_batch(q, cols, ts, valid)
    new, rows = {}, {}
    for lane, i in enumerate(q.fagg_idx):
        name = q.specs[i].name
        if keys is None:
            prev = _finite_abs(state["key_fsums"][lane]).cpu().numpy() \
                if "key_fsums" in state else np.zeros(q.K)
        else:
            prev = keys[name]
        new[name] = prev + per[name].cpu().numpy()
        rows[name] = new[name][pos.cpu().numpy()]
    return new, rows

def step_scale(q, state, cols, ts, valid) -> Scale:
    """The scale of one step whose both sides read ``state``, with the
    grouped rows' own (``bucket_rows``)."""
    sc = carried_scale(q, state) + batch_scale(q, cols, ts, valid)
    sc.row = bucket_rows(q, state, cols, ts, valid)
    return sc


def next_scale(q, sc: Scale, state, cols, ts, valid) -> Scale:
    """The scale after one more step when each side carries its own state
    (``state`` is one side's). A window's tails are the same on both sides
    (compared exactly), so a step reads only what ``step_scale`` sums, and
    the largest over the steps so far holds for every step; running and
    per-key sums carry each side's rounding forward, so theirs add up over
    every batch fed: an unwindowed group-by's per bucket (``key_scales``),
    each grouped row held to its own bucket's."""
    if q.window_kind in (None, "frequent", "lossyFrequent"):
        nxt = sc + batch_scale(q, cols, ts, valid)
        if q.window_kind is None and q.group_keys and q.fagg_idx:
            nxt.keys, nxt.row = key_scales(q, sc.keys, state, cols, ts,
                                           valid)
        return nxt
    st = step_scale(q, state, cols, ts, valid)
    return Scale(np.maximum(sc.s1, st.s1), np.maximum(sc.sm, st.sm),
                 np.maximum(sc.s2, st.s2), st.row)


def tolerance_kinds(q) -> dict:
    """Output name → tolerance class."""
    out = {}
    for s in q.specs:
        if s.kind == "sum" and not s.acc_int:
            out[s.name] = "fsum"
        elif s.kind == "avg" and not s.acc_int:
            out[s.name] = "favg"
        elif s.kind == "stdDev":
            out[s.name] = "std" if q.window_kind in (None, "sort") \
                else "wstd"
        else:
            out[s.name] = "exact"
    return out


def _leaf_kind(name: str) -> str:
    if name.endswith(("_fsums", "_fcomp")) or name == "hh_run_f":
        return "fsum"
    if name.endswith("_smean"):
        return "smean"
    if name.endswith("_sm2"):
        return "sm2"
    return "exact"


def check_close(tag, ref, got, kind, sc: Scale, counts=None, row_s1=None):
    """Holds ``got`` to ``ref`` under the tolerance class ``kind``; returns
    the largest absolute error and the largest error over its limit.
    ``row_s1``, per row, replaces the lanes' largest ``s1`` in the float32
    sum/avg limits."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, \
        (tag, ref.dtype, got.dtype, ref.shape, got.shape)
    if kind == "exact" or ref.dtype.kind not in "f":
        same = (ref == got) | (np.isnan(ref) & np.isnan(got)) \
            if ref.dtype.kind == "f" else ref == got
        assert same.all(), (tag, np.flatnonzero(~same)[:8], ref, got)
        return 0.0, 0.0
    r64, g64 = ref.astype(np.float64), got.astype(np.float64)
    # a non-finite value on either side is compared exactly (NaN equals NaN)
    odd = ~np.isfinite(r64) | ~np.isfinite(g64)
    same = (r64 == g64) | (np.isnan(r64) & np.isnan(g64))
    assert not (odd & ~same).any(), (tag, np.flatnonzero(odd & ~same)[:8],
                                     ref[odd & ~same][:8], got[odd & ~same][:8])
    with np.errstate(invalid="ignore"):
        err = np.where(odd, 0.0, np.abs(r64 - g64))
    s1 = sc.top("s1") if row_s1 is None else row_s1
    if kind == "fsum":
        tol = 2.0 ** -20 * (1.0 + s1)
    elif kind == "favg":
        n = 1.0 if counts is None else np.maximum(counts, 1)
        tol = 2.0 ** -20 * (1.0 + s1) / n
    elif kind == "smean":
        tol = 2.0 ** -20 * (1.0 + sc.top("sm"))
    elif kind == "sm2":
        tol = 2.0 ** -20 * (1.0 + sc.top("s2"))
    else:
        ulp = 2.0 ** -20 if kind == "std" else 2.0 ** -40
        tol = 1e-6 * np.abs(r64) + np.sqrt(ulp * (1.0 + sc.top("s2")))
        if counts is not None:
            big = counts >= 4
            tol = np.where(big, np.minimum(tol, STD_RTOL * np.abs(r64) + 1e-4),
                           tol)
    tol = np.broadcast_to(tol, err.shape)
    bad = err > tol
    assert not bad.any(), (tag, float(err.max()), np.flatnonzero(bad)[:8],
                           tol[bad][:8], ref[bad][:8], got[bad][:8])
    if not err.size:
        return 0.0, 0.0
    return float(err.max()), float((err / tol).max())


def compare(q, sc: Scale, ref_state: dict, got_state: dict, ref_out: dict,
            got_out: dict, limits: dict | None = None) -> float:
    """Holds a step's state and outputs (numpy trees) to the module's
    tolerances under the scale ``sc``; returns the largest absolute error.
    ``limits``, if given, collects per output and leaf the largest absolute
    error (``err``) and its largest share of the limit (``of_limit``)."""
    worst = 0.0

    def keep(tag, e):
        nonlocal worst
        worst = max(worst, e[0])
        if limits is not None and e[0] > 0:
            d = limits.setdefault(tag, {"err": 0.0, "of_limit": 0.0})
            d["err"], d["of_limit"] = max(d["err"], e[0]), \
                max(d["of_limit"], e[1])

    assert set(ref_state) == set(got_state), set(ref_state) ^ set(got_state)
    for k in sorted(ref_state):
        keep(f"state.{k}", check_close(f"state.{k}", ref_state[k], got_state[k],
                                  _leaf_kind(k), sc))
    kinds = tolerance_kinds(q)
    counts = None
    for s in q.specs:
        if s.kind == "count":
            counts = np.asarray(ref_out["out"][s.name])
    for name in ("valid", "ts"):
        check_close(name, ref_out[name], got_out[name], "exact", sc)
    assert int(ref_out["count"]) == int(got_out["count"])
    for s in q.specs:
        keep(f"out.{s.name}", check_close(f"out.{s.name}", ref_out["out"][s.name],
                                     got_out["out"][s.name], kinds[s.name],
                                     sc, counts, (sc.row or {}).get(s.name)))
    return worst


# walks that start from a carried lossy table (the query, B):
# - lossy_prune_empties: every slot full at count 1 with total = 10 C, so
#   the step's first event (a miss) is dropped and its prune empties the
#   table, which the rest of the batch fills anew;
# - lossy_pinned_near_full: C - 12 slots pinned at count 1,000, so the
#   other 12 fill, misses drop and prunes free them, over several bucket
#   changes;
# - lossy_resumed: the table a walk left after RESUME_AFTER steps (the
#   JAX package's against the JAX package, the plain version's on the
#   card), carried in through gpu/state_io.py.
CARRIED = {"lossy_prune_empties": ("lossy_near_full", 32),
           "lossy_pinned_near_full": ("lossy_near_full", 64),
           "lossy_resumed": ("lossy_near_full", 64)}
RESUME_AFTER = 3


def fill_carried(label: str, tree: dict) -> dict:
    """The carried table of ``label`` written into a fresh state's numpy
    tree (the wire's vol keys are below 1,000: the full table's keys, from
    10**6 up, never hit; the pinned keys 0 .. C - 13 do, and emit)."""
    C = tree["hh_keys"].shape[0]
    if label == "lossy_prune_empties":
        tree["hh_keys"][:] = 10**6 + np.arange(C)
        tree["hh_counts"][:] = 1
        tree["hh_fvals"][:] = 0.5
        tree["hh_total"] = np.array(10 * C, np.int64)
    elif label == "lossy_pinned_near_full":
        pin = C - 12
        tree["hh_keys"][:pin] = np.arange(pin)
        tree["hh_counts"][:pin] = 1000
        tree["hh_fvals"][:, :pin] = 0.25
        tree["hh_total"] = np.array(50, np.int64)
    return tree


def carried_start(label: str, device):
    """``(q, state, batches)``: the compiled query on ``device``, the carried
    state and the batches to walk from it (for ``lossy_resumed``, the
    plain version's table after ``RESUME_AFTER`` steps)."""
    name, B = CARRIED[label]
    q = compile_port(name, B, device)
    wire = wire_for(name, B)
    batches = [wire.batch(step) for step in range(STEPS + 1)]
    if label == "lossy_resumed":
        state = q.init_state()
        for batch in batches[:RESUME_AFTER]:
            state, _ = stream_step_plain(q, state, *q.batch_tensors(batch))
        tree = state_to_numpy(state)
        batches = batches[RESUME_AFTER:]
    else:
        tree = fill_carried(label, state_to_numpy(q.init_state()))
    return q, query_state_from_numpy(q, tree, device), batches


def kernel_steps(q, state, batches) -> tuple[float, int]:
    """Steps the kernel and the plain version from the same state over
    ``batches`` (CUDA tensors), each step held to ``compare``; returns the
    largest error and the valid rows."""
    worst, rows = 0.0, 0
    for batch in batches:
        cols, ts, valid = q.batch_tensors(batch)
        sc = step_scale(q, state, cols, ts, valid)
        ref_state, ref_out = stream_step_plain(
            q, state_from_numpy(state_to_numpy(state), "cuda"), cols, ts, valid)
        state, out = q.step_tensors(state, cols, ts, valid)
        torch.cuda.synchronize()
        worst = max(worst, compare(q, sc, state_to_numpy(ref_state),
                                   state_to_numpy(state),
                                   state_to_numpy(ref_out),
                                   state_to_numpy(out)))
        rows += int(out["valid"].sum())
    return worst, rows


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_every_query_takes_the_query_kernel(name):
    q = compile_port(name, 16, "cpu")
    assert q.plan.link_error is None
    walked = q.window_kind in ("sort", "frequent", "lossyFrequent")
    assert q.plan.LIB == ("query_walk" if walked else "query_step")


def refusal_wire(B: int) -> dict:
    """One seeded batch over ``REFUSAL_SCHEMA``."""
    rng = np.random.default_rng(5)
    cols = {"sym": rng.integers(1, 4, B).astype(np.int32),
            "v": rng.uniform(0, 10, B).astype(np.float32),
            "w": rng.integers(0, 9, B).astype(np.int64),
            "k": rng.integers(0, 9, B).astype(np.int64),
            "n": rng.integers(0, 9, B).astype(np.int32),
            "ets": np.arange(B, dtype=np.int64) + 1000}
    return {"cols": cols, "ts": np.arange(B, dtype=np.int64) + 1000,
            "valid": np.ones(B, bool), "count": B}


@pytest.mark.cuda
@pytest.mark.parametrize("text", STEP_RAISES)
def test_kernel_step_raises_on_a_constant_projection(text):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    app = parse(REFUSAL_SCHEMA + text)
    q = CompiledStreamQuery(app.queries[0], app.stream_definitions["S"], 8,
                            device="cuda")
    with pytest.raises(AttributeError):
        q.step(q.init_state(), refusal_wire(8))


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", CASES + WINDOW_CASES + CARD_CASES,
                         ids=IDS + WINDOW_IDS + CARD_IDS)
def test_kernel_matches_plain_on_card(name, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q = compile_port(name, B, "cuda")
    state = q.init_state()
    wire = wire_for(name, B)
    for step in range(STEPS):
        cols, ts, valid = q.batch_tensors(wire.batch(step))
        sc = step_scale(q, state, cols, ts, valid)
        ref_state, ref_out = stream_step_plain(
            q, state_from_numpy(state_to_numpy(state), "cuda"), cols, ts, valid)
        state, out = q.step_tensors(state, cols, ts, valid)
        torch.cuda.synchronize()
        compare(q, sc, state_to_numpy(ref_state), state_to_numpy(state),
                state_to_numpy(ref_out), state_to_numpy(out))


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(CARRIED))
def test_kernel_walks_a_carried_table_on_card(label):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kernel_steps(*carried_start(label, "cuda"))


# kernel launches a step (QueryPlan.step_launches): query_walk.cu's one;
# query_step.cu's q_mask, q_compact, q_prep, the group-by sort's three, 1 to
# 3 passes of the tile grid, q_emit
STEP_LAUNCHES = {"sort": 1, "lossy": 1,
                 "projection": 4, "length_values": 4, "length_batch_values": 5,
                 "time_drops": 6, "running": 6, "delay": 7,
                 "length_minmax_tiles": 7, "time_batch_tiles": 7,
                 "session_tiles": 7, "hopping_tiles": 7,
                 "length_grouped_tiles": 9, "grouped_nonfinite_late": 9}


@pytest.mark.parametrize("name", sorted(STEP_LAUNCHES))
def test_step_launches(name):
    q = compile_port(name, 16, "cpu")
    assert q.plan.step_launches() == STEP_LAUNCHES[name]


def test_tile_matches_the_kernel_source():
    import os
    import re
    from siddhi_tpu_torch.gpu import query_step
    src = open(os.path.join(os.path.dirname(query_step.__file__), "..", "csrc",
                            "query_common.cuh")).read()
    tn, ipt = (int(re.search(rf"#define {k} (\d+)", src).group(1))
               for k in ("TN", "IPT"))
    assert tn == query_step.TN and tn * ipt == query_step.TILE


@pytest.mark.parametrize("K", [4, 1024, 1 << 24])
def test_group_sort_rows_cover_the_axis(K):
    from siddhi_tpu_torch.gpu.query_step import SORT_CELLS
    app = parse(SCHEMA + "from S#window.length(8192) select sym, count() as c "
                "group by sym insert into O;")
    q = CompiledStreamQuery(app.queries[0], app.stream_definitions["S"], 1000,
                            device="cpu", group_capacity=K)
    a = q.plan.args
    assert a.gsub % 32 == 0 and a.nrow * a.gsub >= a.M
    assert a.nrow * K <= max(SORT_CELLS, K)
    assert a.ntile * 2048 >= a.M > (a.ntile - 1) * 2048
