#!/usr/bin/env python3
"""Runs the port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py [--seed 42] [--events 2000000]

Phases, one JSON line each:
  1. device  — the card, CUDA, and the build of every CUDA source
               (``siddhi_tpu_torch/csrc``, one nvcc per source, in parallel).
  2. shapes  — the blocked-NFA kernel against its plain PyTorch version on
               the card across pattern shapes (2/3/8 states, stream and
               element ``within``, creation cap set and unset, a sequence
               through 1-lane ``DeviceNFACompiler`` steps at B up to 2048,
               S == 1, two streams, an empty lane, integer division by
               zero, timestamps not sorted and on a grid where ts - first
               == within, creations too large for shared memory, which must
               take the kernel's global scratch, a plan too large for a
               cluster, which takes one CTA a lane, and B = 16,384 with four
               32-bit columns, whose batch the kernel must read from global
               memory). State leaves, counters and ys must be exactly equal,
               and the Python mirror of the kernel's layout plan
               (``BlockPlan.layout_mirror``) must equal the kernel's own.
  3. main    — the main path at full width: the bench app (8-state rising
               chain under ``partition with (dev of S)``, 64 lanes, lane
               batch 2048, C = 64, K = 320, 256 keys) fed through
               ``send_many``/``flush(decode=True)``. A timed run gives
               events/s and the kernel's step time; a checked run holds every
               step's state leaves, decoded rows, match and drop counts
               against the plain version stepped on the card from the same
               state.
     native_main — the same app and events through the native route, as
               the bench feeds it: CSV lines ``dev,v,ts`` (built untimed)
               through ``enable_native_ingress`` → ``ingest_csv`` →
               ``flush_native(decode=True)`` (the C++ loader parses,
               dictionary-encodes, routes by crc32 and packs the lanes). A
               timed run gives events/s, the kernel's step time and the
               host time of each part (parse, packing, H2D, step call,
               decode); a checked run holds every step against the plain
               version on the card. No parse error, no clamped timestamp,
               one row a match, every row a rising chain, the two runs
               equal.
     snapshot — two one-lane ``DeviceNFARuntime`` apps on the card, the
               8-state chain (blocked kernel) and the scan app without its
               partition (scan kernel), B = 2048: fed half their events,
               snapshotted with rows staged in the builder
               (``snapshot_state`` + ``builder.snapshot()``), restored into
               a fresh runtime and fed the rest; rows, counters and the
               final state bitwise equal to an uninterrupted run.
     entry   — ``siddhi_tpu_torch.entry``: ``entry()``'s step once on the
               card, equal to the plain version, and
               ``dryrun_multichip(1)`` (one match per lane, equal to the
               plain version on the CPU).
  4. scan_shapes — the per-event scan kernel against its plain PyTorch
               version on the card: every shape of
               ``tests/test_torch_scan_shapes.py`` (count, logical, absent,
               every scopes, sequences, within, strings, overflow, C = 256
               and C = 33 slots, a long run of events no live state reads,
               a lone lane empty at odd steps) lane-batched, then every
               device-compilable case of the pattern
               corpus (``tests/test_pattern_corpus.py``, read as data)
               through ``DeviceNFARuntime`` on the card; every step exactly
               equal. ``eventTimestamp()`` in a pattern raises KeyError on
               the card for both shapes, as in the reference.
  5. scan_main — the scan shape at full width: a partitioned two-stream
               app (a stream state, a logical ``and``, a count ``<2:4>``, a
               stream state; 64 lanes, lane batch 2048, C = 64, 256 keys)
               fed 2,000,000 events through ``send_many``/``flush(decode=
               True)``. A timed run gives events/s and the kernel's step
               time; a checked run holds the first 2 steps and the last one
               a full lane triggered (state leaves, counters, ys, decoded
               rows) against the plain version on the card, each from the
               state the kernel reached before it.
  6. query_shapes — the single-stream query kernels against their plain
               PyTorch version on the card: every case of
               ``tests/test_torch_query_shapes.py`` (each sliding window kind,
               batch(), running and grouped aggregates, having, min/max,
               stdDev, eventTimestamp(), out-of-order externalTime, group
               collisions; lengthBatch, timeBatch, externalTimeBatch,
               session, delay and hopping through ``query_step.cu``, sort,
               frequent and lossyFrequent through ``query_walk.cu``, and
               wider windows whose kernel passes span several blocks), 5
               steps each, state leaves and every output position held to
               that file's tolerances; the reference's refusals refuse on
               the card and one small query per new window compiles there.
  7. query_main — four configurations at full width through
               ``DeviceStreamRuntime`` (``BatchBuilder.append_columns`` →
               step → ``decode_outputs``), ``QUERY_EVENTS`` events each:
               (a) the repo's device sample, a grouped sliding length window
               (4096 rows, 1,000 Zipf(1.1) symbols, K = 1024); (b) an
               ungrouped 10 s sliding time window with min/max/stdDev
               (window capacity 65536, ~50,000 live events); (c) a 10 s
               timeBatch with avg/min/max/stdDev/sum/count (an open bucket
               of ~50,000 events, outputs over 69,632 slots); (d) the
               lossyFrequent fraud query (50,000 Zipf(1.1) card numbers,
               table C = 4096, through ``query_walk.cu``); all are defined
               in ``siddhi_tpu_torch/tools/query_workloads.py``. A timed run
               gives events/s and, by CUDA events, the kernels' time per
               step (around their launch call) and the step call's (the
               wrapper's host work included); a checked run holds every step
               (for (d), whose plain version walks the events in Python, the
               first 2 and the last full one, each from the state the kernel
               reached) against the plain version on the card, with the float
               limits computed per step from the state and batch it reads
               (``step_scale``; a grouped float32 sum/avg row's from its own
               bucket), and prints each output's largest error and its
               largest share of its limit; in (a)–(c) one full-width step
               runs twice from the same state and inputs, every output and
               state leaf bitwise equal; (c)'s rows are also held to a
               numpy computation of every closed bucket, (d)'s to the
               frequency bound of lossy counting.
  8. join_shapes — the stream-stream join kernel (``csrc/join_step.cu``)
               against its plain PyTorch version on the card: every shape of
               ``tests/test_torch_join_shapes.py`` (time, length and mixed
               windows; inner, left, right and full outer joins;
               unidirectional; within; every column type; eventTimestamp();
               integer division by zero; J and time-ring overflow; k > W;
               empty sides and batches; the key index on INT, LONG, BOOL and
               string keys that collide in its buckets, as a second
               conjunct, over decreasing ring timestamps and with J
               overflow, and an equality under ``or`` that it must not
               take), 6 steps each, every state leaf and output position
               bitwise equal; the reference's refusals and the kernel's
               limits refuse on the card.
  9. join_main — two configurations at full width through
               ``DeviceJoinRuntime`` (``MergedBatchBuilder.append_many`` per
               same-stream run → ``flush``: step + decode), 2,000,000 events
               each, B = W = 4096, J = 16,384, defined in
               ``siddhi_tpu_torch/tools/join_workloads.py``: (e) the
               reference's BASELINE config #4 market join (bids against
               cheaper asks of the same symbol, 2 s / 3 s time windows) and
               (f) a left outer join of sensor readings with the last 256
               regulator states (length windows, nulls, strings, bools). A
               timed run gives events/s and, by CUDA events, the kernel's
               time per step (around ``lib.join_step``) and the step call's;
               a checked run holds every step (state leaves, every output
               position, count, drops) bitwise against the plain version on
               the card; the first 2 steps' rows are held to a direct
               nested-loop join in numpy; 0 join and ring drops. Both
               must take the key-indexed walk (the plan found the equality
               conjunct); the index's share of the step's kernel time comes
               from torch.profiler over 20 repeats of one step.
 10. agg_shapes — the incremental-aggregation kernel
               (``csrc/aggregation_step.cu``) against its plain PyTorch
               version on the card: every shape of
               ``tests/test_torch_agg_shapes.py`` (each duration, months and
               years across the calendar, no group-by, string, int + string
               and LONG keys, filters, every aggregator over INT, LONG,
               FLOAT, DOUBLE and a computed argument, value projections,
               eventTimestamp(), aggregate by an attribute, NaN and ±inf, a
               run of B events, stale padding), 5 steps each, every key and
               [D, B] position bitwise; the reference's refusals and the
               kernel's limits refuse on the card.
 11. agg_main — two configurations at full width through
               ``AggregationRuntime``, 1,000,000 events each, B = 4096,
               defined in ``siddhi_tpu_torch/tools/agg_workloads.py``: (g)
               the Query Guide's trade rollup (1,000 Zipf(1.1) symbols, avg
               and sum every sec ... year, 1 % late trades) and (h) a
               filtered sensor rollup (64 rooms x 16 devices, min, max, avg,
               stdDev and count every sec ... hour). A timed run stages
               through ``append_columns`` + ``_flush_device`` and gives
               events/s and, by CUDA events, the kernel's time per step
               (around ``lib.aggregation_step``) and the step call's; a
               checked run feeds every event through ``receive`` and holds
               every step bitwise against the plain version on the card;
               the final ``rows_for`` of every duration is held to a numpy
               group-by of the 1,000,000 events (counts exact, min/max
               exact against the f32 wire, the float lanes within the
               reference test's rel 1e-4).
 12. engine — every device path through the engine, ``SiddhiManager()``
               (the card) → ``create_siddhi_app_runtime(app, playback=
               True)`` → ``InputHandler`` → junction → ``DeviceQueryBridge``
               → kernel → ``StreamCallback``, each app ``@device(strict=
               'true')`` with 500,000 seeded events
               (``siddhi_tpu_torch/tools/engine_workloads.py``): the chain
               of ``main`` without its partition (B1, batch 2048, slots 64)
               and the scan app without its partition (B4), per event
               through ``send``; (a), (c) and (d) of ``query_main`` (B5a,
               B5b) through ``send_columns``; (e) of ``join_main`` (B6) per
               event; (g) of ``agg_main`` as a ``define aggregation`` (B7),
               its rows read per duration with ``rt.query``. Each app's
               rows, in order, and its final state (bucket stores for (g))
               must equal, bitwise, those of the same runtime class driven
               directly on the card with the same events; a second engine
               on the CPU (``device="cpu"``, the plain versions), fed the
               first two micro-batches (one for the scan app), must equal
               the card engine's rows and state at that point (the query
               apps' float32 sums within ``tests/test_torch_query_shapes.py``'s
               tolerances); every micro-batch must be stepped, each app's
               kernel launched (no other), no ERROR record logged by the
               port, and no step replayed by a device guard. The chain
               and (a) run once more with ``async='true'`` (the
               double-buffered driver) and must give the same rows and
               state; (c) is snapshotted at a micro-batch boundary
               mid-stream, restored into a fresh engine and fed the rest,
               equal to the uninterrupted run, its blob holding no tensor.
               Per app: events/s, the share of the window outside the step
               calls, the step call's median by CUDA events beside the
               direct runtime's and the standalone phase's, launches.
 13. engine_host — the host interpreter and the kernels in one engine:
               ``iot_mixed`` of ``engine_workloads`` (``ENGINE_HOST_EVENTS``
               seeded IoT readings from 256 devices in 16 rooms, per event
               through ``send``): an interpreter filter feeds the chain
               (B1, batch 2048, slots 64) and a grouped length window (B5a,
               batch 4096, K = 1024), an interpreter time window reads the
               chain's alerts, an ``order by``/``limit`` query the device
               compilers refuse runs on the interpreter, and a partition
               by room keeps a per-room peak. The app runs through
               ``SiddhiManager()`` on the card and through
               ``SiddhiManager(device="cpu")`` (the plain versions) over
               the same events: every output stream's rows equal in order
               (the grouped float32 sums within
               ``tests/test_torch_query_shapes.py``'s tolerances), exactly
               the two device queries bridged (on the card), the others on
               the interpreter, both kernels launched (no other), no
               receiver error and no ERROR record. Events/s through both
               engines, the share of the window inside the step calls,
               rows per output stream.
 14. engine_io — the IO tier and durable flow control, on
               ``engine_workloads``' ``IO_EVENTS`` seeded IoT readings:
               ``iot_durable`` (an in-memory source fed ``RowsChunk``s of
               4,096 events through ``InMemoryBroker.publish``, so the
               chunks take ``send_columns``; a write-ahead log and a
               blocking credit gate on the input; the chain (B1, batch
               2048, slots 64) into a ``json`` sink and the grouped
               ``length(4096)`` (B5a, B = 4096, K = 1024) into a
               ``passThrough`` sink; an interpreter time window over the
               alerts) runs three times: straight through on the card;
               on the card with ``persist()`` after ``IO_PERSIST_AT``
               events, the runtime abandoned after ``IO_KILL_AT`` (no
               shutdown, no flush), a fresh runtime ``recover``ed and fed
               the rest; straight through on ``SiddhiManager(device=
               "cpu")``. Every sink topic's payloads and the time window's
               rows must be equal across the three, in order (the second
               stitched at its persist: the crashed runtime's output up to
               it, then the recovered one's; the grouped float32 sums of
               the card against the CPU within
               ``tests/test_torch_query_shapes.py``'s tolerances where not
               equal); ``recover`` must report the events after the persist
               replayed and the kill point as the watermark; the WAL's bytes
               must drop at the persist; no event shed or dropped.
               ``iot_adaptive_edge`` reads the same events as CSV lines from
               a file source (the native parse into ``send_columns``) into
               the grouped ``length(4096)`` on the async driver under
               ``@app:adaptive(latency.target.ms='50', min='256')``; the
               file's last ``IO_TAIL`` lines come in a read of their own,
               so the feed ends with a partial batch, which after an idle
               gap the driver's deadline flush must step. After an untimed
               warm-up run of the app on ``IO_EDGE_WARM`` other events, it
               runs twice on the card from a collected heap: as a user's
               app runs, then
               with the objects alive before it frozen out of the
               collector (``gc.freeze``). Each run's rows are held to the
               same app without ``@app:adaptive`` on the CPU engine (keys
               and counts exact, sums within the tolerances, their scale
               computed after the run from each step's inputs, so no
               check's work lies inside a timed step); its controller must
               have observed steps and adjusted at least once, and the
               ``batch_size`` gauge must read its threshold. Both kernels
               must launch (no other). Events/s, the WAL's bytes, the
               persist, recover and replay seconds, and per edge run the
               controller's report, the flush causes, the step call's
               median and p99 by CUDA events and the ``StallTrace`` (each
               step the controller timed, split into collector pauses, the
               worker's CPU time and waits).
     The engine phases above run with the default ``DeviceGuard`` on
               every ``@device`` query; each ends with every guard's
               ``report()`` read (``GuardAudit``): a failure, a fallback
               or a lost event, or a circuit that is not closed, fails the
               script with the report, so a kernel that faulted there
               cannot pass on the host's rows.
 15. engine_guard — the resilience tier: (a) ``iot_mixed`` under
               ``engine_workloads.IOT_CHAOS`` (``@app:chaos(seed='16',
               device.fail.p='0.05')``, a circuit threshold of 1000) over
               ``GUARD_EVENTS`` events, sync and with ``async='true'``, on
               the card and on the CPU engine under the same seed: each
               guard's failures equal the faults its chaos site injected
               and the batches that failed, its fallback events the events
               of those batches, no event lost, each kernel's launches its
               launches a step times the steps that were not faulted, and
               every output stream's rows equal the CPU engine's in order
               (``Stats`` within the tolerances; the async run's
               ``AlertRate`` by its number of rows, whose counts depend on
               the worker's delivery against the playback clock); (b) a
               stateless filter (B5a, batch 2048, async) under 25 % faults:
               its rows equal a fault-free card run's, ``v`` as float32;
               (c) a quarantine: after two faults the circuit opens and
               the kernel is not launched while it is open (a cool-down of
               ``GUARD_COOLDOWN_MS``, which the window must not outlast),
               then with the fault healed and the cool-down passed a probe
               re-promotes
               it and it launches again, every event delivered once; (d)
               the chain and ``grouped_length`` of the engine phase with
               the default guard and with ``device.quarantine='false'``
               (guarded, unguarded, unguarded, guarded): events/s of each.
 16. engine_observe — the observability tier on ``iot_mixed`` at the
               engine's widths (``OBSERVE_EVENTS`` events a run): (a) a
               plain sync run and one under ``@app(statistics='true')``,
               ``@app:trace(sample='1/64')`` and
               ``@app:flightrecorder(ring='4096')`` give equal rows on all
               five outputs, in order; (b) in the second, each device
               query's step probe counts its kernel's launches over its
               launches a step, the events its bridge took and its flush
               causes summing to its steps; its ``latency_report()``
               reconciles to 1.0 within 1e-6; the trace export has its
               ``fill-wait`` and ``device`` spans; ``render`` gives
               Prometheus 0.0.4 text (every line checked, no exemplar) with
               ``siddhi_tpu_device_steps_total`` for each, and exemplars
               only when OpenMetrics is asked for; (c) the same with
               ``async='true'``: its ``Alerts`` and ``Stats`` equal the
               plain run's, each driver's ``device_idle_frac`` within
               [0, 1], its ``overlap_efficiency`` positive and equal to
               its pack plus step seconds over its pipeline wall, and its
               pack seconds within the run's wall; (d)
               under ``@app:chaos(seed='16', device.fail.p='0.05')`` with a
               circuit that opens at each failure, the flight recorder
               holds one ``circuit:open`` and one ``step_failed`` per
               failure of each guard, a ``fallback_step``, in time order,
               and a quarantine (engine_guard (c)'s) under
               ``@app:flightrecorder(dir=...)`` dumps it as JSON; (e) the
               chain alone under ``@app:profile(dir=...)``,
               ``OBSERVE_PROFILE_EVENTS`` events, sync and async, each in
               a fresh process, the two at once (an older process's
               capture loses kernel records): the exported ``torch.profiler`` trace holds a
               ``siddhi:step:chain`` range a step and one
               ``nfa_block_kernel`` record a launch; their device time
               beside the probe's busy seconds.
 17. engine_columnar — the columnar host tier beside the kernels: (a)
               ``iot_mixed`` at the engine's widths under
               ``@app:host_batch(batch='8192', lanes='16')``,
               ``COLUMNAR_EVENTS`` events, sync: ``clean`` and
               ``alert_rate`` on the columnar tier, ``chain`` and ``stats``
               on the kernels, ``top`` and ``room_peak`` on the
               interpreter, as the same app built on the CPU has them;
               every output's rows equal the run without the annotation,
               in order (``AlertRate``, whose columnar time window expires
               by the alerts' own times, held to ``alert_rate_rows`` with
               no timer where it differs); B1 and B5a launched; (b) the
               partitioned 3-state chain of the parallel lane tier
               (``COLUMNAR_PAR_APP``, batch 2048, 8 lanes) with 1 worker,
               4 threads and 4 lane processes: equal rows and
               ``match_count``, and a snapshot cut under 2 workers resumed
               under 4 equal to the uninterrupted run; (c) under
               ``@app:chaos(seed='18', device.fail.p='0.05')`` a ``@device``
               filter replays its faulted batches on the columnar engine
               (``fallback_engine`` ``"columnar"``, rows equal to a run
               without faults, ``v`` as float32) and ``iot_mixed``'s guards
               equal the CPU engine's, the chain's replays columnar (stats,
               a windowed group-by, keeps the interpreter as in the
               reference), no event lost, rows equal to the CPU engine's;
               (d) ``samples/columnar_edge.py``'s app from a CSV file of
               ``COLUMNAR_EDGE_ROWS`` ``iot`` events through the file
               source, the columnar filter and the ``inMemory`` sink with
               no ``Event``/``StreamEvent`` built, its published rows equal
               the interpreter's. Events/s of every run.
 18. engine_fleet — the multi-tenant fleet tier (``@app:fleet``) beside the
               kernels, the JAX package's own fleet scenarios of its
               ``bench.py`` (``siddhi_tpu_torch/tools/fleet_workloads.py``):
               (a) 16 tenants of the rule template under
               ``@app:fleet(batch='8192', lanes='24')``, 12,000 events in
               per-tenant chunks of 16 through ``send_rows``, then the same
               apps solo under ``@app:host_batch`` and on the interpreter:
               every tenant's rows equal, in order, across the three;
               compiles, steps and events/s of each; (b) 16 tenants of the
               3-state rising chain by ``dev`` with a per-tenant ``within``,
               4,000 events: rows equal to the solo columnar run's (its
               first four tenants, one a ``within``), in order, and to the
               interpreter's as a multiset; (c) the shapes'
               shared device plans (``manager.fleet.device_plan``) built
               once a shape (15 cache hits of 16), stepped on the card over
               batches that interleave all 16 tenants' rows with per-row
               ``__fleet_p*`` columns: the rule's and a rule whose
               ``having`` reads a hoisted constant through B5a
               (``csrc/query_step.cu``), the chain through B1
               (``csrc/nfa_block.cu``, one lane a tenant and device-hash
               lane); every step's state, outputs and counters equal the
               plain version's on the card, and each tenant's count the
               host group's (the chain's for the tenants whose ``within``
               is the plan's, a compile-time constant of the shared plan in
               both packages); (d) the SLO storm (16 tenants, 24,000
               events, chunks of 32, a best-effort burster at 10× its
               share, a 100 ms premium budget): decisions taken, no premium
               shed, the burster shed; each class's p99 beside the budget;
               and a tenant fed non-finite rows under ``@app:chaos(
               fleet.fault.p=...)`` ejects while its co-tenants' rows equal
               a clean run's; (e) a tenant app with a fleet rule and the
               market join under ``@device``: the join has no fleet shape,
               lands on B6 (``csrc/join_step.cu``) and launches there, its
               rows equal to the CPU engine's.
 19. dcn     — lanes over several devices and the DCN shard tier, on the
               bench's chain (``bench_app``: 8 states, ``within 4000``, by
               ``dev``), 2,000,000 events of ``gen_events``: (a) the main
               path through ``send_many`` with its 64 lanes split over
               ``devices=["cuda:0"] * 2`` and ``* 4`` (each range its own
               state, stream and launch a step) against one device: rows
               in order, state leaves (the ranges concatenated) and
               counters bitwise equal, launches the one device's times the
               ranges; ``dryrun_multichip(2, devices=["cuda:0"] * 2)``;
               (b) two ``DCNWorker``s on loopback, ``LaneTopology(64, 2)``
               (32 lanes a shard on the card, lane batch 2048, C = 64, no
               creation cap: the worker's own shard), every event into
               host 0 through ``ingest_chunk`` (``DCN_CHUNK`` a call), so
               about half cross the socket as bulk frames: the two
               workers' matches over the first ``DCN_ORACLE_EVENTS`` equal
               the port's host interpreter's; over the first
               ``DCN_TWIN_EVENTS`` (the cut of the plain twin, whose step
               at this width takes seconds on the CPU) each worker's rows
               in order and state leaves bitwise equal to the same two
               workers with ``device="cpu"``; then all 2,000,000 events,
               timed: events/s, ``forward_chunk_rows``; (c) failover on
               the card: host 1 snapshots each applied frame into a
               ``LaneGroupSnapshotStore``, both hosts snapshot, host 1 is
               closed mid-stream, host 0's frames for group 1 spill, host 0
               takes group 1 over from the snapshot (restored onto the
               card) and replays the spill, host 1 returns as a standby and
               takes group 1 back through ``K_ADOPT``, and is routed to
               again (``DCN_FAILOVER_CHUNKS`` chunks of
               ``DCN_FAILOVER_CHUNK`` events): every worker's rows in order
               and the final state leaves bitwise equal to the same script
               with ``device="cpu"``. B1's ``launches_by_path`` gains
               ``lanes_split`` ((a)) and ``dcn`` ((b)'s timed run).
Then the card's name and power limit (nvidia-smi), the ``kernels`` line and,
last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores

SHAPES = {
    "chain2": """
define stream S (v double);
from every e1=S[v > 50.0] -> e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
""",
    "chain3_within": """
define stream S (sym string, v double);
from every e1=S[v > 20.0] -> e2=S[sym == e1.sym and v > e1.v]
  -> e3=S[v > e2.v] within 600
select e1.sym as s, e1.v as a, e2.v as b, e3.v - e1.v as d insert into O;
""",
    "chain8": """
define stream S (dev string, v double);
from every e1=S[v > 60.0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[v > e2.v] -> e4=S[v > e3.v] -> e5=S[v > e4.v]
  -> e6=S[v > e5.v] -> e7=S[v > e6.v] -> e8=S[v > e7.v] within 4000
select e1.v as v1, e4.v as v4, e8.v as v8 insert into O;
""",
    "element_within": """
define stream S (v double);
from every e1=S[v > 10.0] -> e2=S[v > e1.v] within 300 milliseconds
  -> e3=S[v > e2.v]
select e1.v as a, e2.v as b, e3.v as c insert into O;
""",
    "single": """
define stream S (v double, n int);
from every e1=S[v > 30.0]
select e1.v as a, e1.v * 2.5 as b, e1.n + 1 as c insert into O;
""",
    "two_stream": """
define stream S1 (sym string, p double);
define stream S2 (sym string, p double);
from every e1=S1[p > 20.0] -> e2=S2[sym == e1.sym and p > e1.p] within 5000
select e1.sym as s, e1.p as p1, e2.p as p2 insert into O;
""",
    "intdiv": """
define stream S (x int, y int);
from every e1=S[x > 0] -> e2=S[x / y == e1.x % y or y == 0]
select e1.x as a, e2.x / e2.y as q, e2.x % e1.y as r,
       e1.x / 0 as z insert into O;
""",
    "sequence": """
define stream S (v double);
from every e1=S[v > 10.0], e2=S[v > e1.v]
select e1.v as a, e2.v as b insert into O;
""",
    "wide4": """
define stream S (dev string, v float, n int, w float);
from every e1=S[v > 60.0 and n > 0] -> e2=S[v > e1.v and dev == e1.dev]
  -> e3=S[w > e2.v and n >= e1.n] within 4000
select e1.dev as d, e1.v as a, e2.v as b, e3.w as c, e3.n as k insert into O;
""",
}

# (shape, lane batch B, slots C, creation cap K, lanes, ts as in TS_MODES)
SHAPE_CASES = [
    ("chain2", 64, 16, None, 4, "cumsum"), ("chain2", 256, 16, 24, 8, "cumsum"),
    ("chain3_within", 128, 16, None, 8, "cumsum"),
    ("chain3_within", 512, 32, 96, 8, "cumsum"),
    ("chain8", 2048, 64, 320, 8, "cumsum"), ("chain8", 64, 8, None, 4, "cumsum"),
    ("element_within", 256, 16, 48, 8, "cumsum"),
    ("single", 512, 8, None, 8, "cumsum"),
    ("two_stream", 256, 16, None, 8, "cumsum"),
    ("intdiv", 128, 16, 32, 8, "cumsum"),
    ("sequence", 64, 8, None, 1, "cumsum"), ("sequence", 256, 16, 24, 1, "cumsum"),
    # ts not sorted: events fall back inside `within` after it lapsed
    ("chain3_within", 256, 16, 64, 8, "sawtooth"),
    ("element_within", 512, 16, 48, 8, "sawtooth"),
    # ts on a grid of 50: ts - first == within exactly
    ("chain3_within", 128, 16, 32, 8, "grid"),
    ("element_within", 128, 8, None, 8, "grid"),
    # no creation cap at a large B: creations in the kernel's global scratch
    ("chain8", 2048, 8, None, 4, "cumsum"),
    # a 1-lane sequence at B = 2048
    ("sequence", 2048, 16, None, 1, "cumsum"),
    # C = 1024 and no cap: one CTA a lane (a cluster's plan does not fit),
    # creations in global scratch and one table buffer
    ("chain8", 2048, 1024, None, 2, "cumsum"),
    # B = 16,384 with four 32-bit columns: the batch cannot be staged in
    # shared memory, so the kernel reads it from global memory
    ("wide4", 16384, 64, 256, 2, "cumsum"),
]
# (CTAs a lane, layout mode) where a case differs from a cluster with
# everything in shared memory
LAYOUTS = {("chain8", 2048, 8, None): (2, 1), ("chain8", 2048, 1024, None): (1, 3),
           ("wide4", 16384, 64, 256): (1, 7)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- comparing

def flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def compare(ref: dict, got: dict) -> tuple[bool, float, str]:
    """Exact comparison of two trees of tensors (NaN equals NaN). Returns
    (equal, max abs error over numeric leaves, first differing leaf)."""
    import torch
    r, g = dict(flatten(ref)), dict(flatten(got))
    if r.keys() != g.keys():
        return False, float("inf"), f"leaves {sorted(r.keys() ^ g.keys())}"
    worst, bad = 0.0, ""
    for name in sorted(r):
        a, b = r[name], g[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            return False, float("inf"), f"{name}: {a.dtype}{tuple(a.shape)} vs " \
                f"{b.dtype}{tuple(b.shape)}"
        if a.dtype == torch.bool:
            same = a == b
            err = float((a != b).any())
        else:
            a64, b64 = a.double(), b.double()
            both_nan = torch.isnan(a64) & torch.isnan(b64)
            same = (a == b) | both_nan
            diff = torch.where(both_nan, torch.zeros_like(a64), (a64 - b64).abs())
            err = float(diff.nan_to_num(nan=float("inf")).max()) if diff.numel() else 0.0
        worst = max(worst, err)
        if not bool(same.all()) and not bad:
            bad = name
    return not bad, worst, bad


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


# ---------------------------------------------------------------- batches

def _ts_sawtooth(rng, lanes: int, B: int):
    """Not sorted: 32-event teeth rising 40 an event over a base rising 100
    a tooth, so a window that lapsed within a tooth reopens at the next."""
    j = np.arange(B)
    return (j % 32) * 40 + (j // 32) * 100 + rng.integers(0, 3, (lanes, B))


TS_MODES = {
    "cumsum": lambda rng, lanes, B, step: np.cumsum(
        rng.integers(0, step, (lanes, B)), 1),
    "sawtooth": lambda rng, lanes, B, step: _ts_sawtooth(rng, lanes, B),
    "grid": lambda rng, lanes, B, step: 50 * np.cumsum(
        rng.integers(0, 3, (lanes, B)), 1),
}


def make_batch(rng, comp, lanes: int, empty_lane: bool, ts_step: int = 60,
               base=None, ts: str = "cumsum"):
    """A seeded wire batch [lanes, B]; stale noise past each lane's count.
    ``base`` pins every lane's ts base (else random per lane); ``ts`` names
    the timestamps' shape (``TS_MODES``; ``cumsum`` steps by up to
    ``ts_step``)."""
    B = comp.B
    cols = {}
    for k in sorted(comp.used_cols):
        t = comp.merged.columns[k].name
        if t in ("FLOAT", "DOUBLE"):
            c = np.round(rng.uniform(0, 100, (lanes, B)), 1).astype(np.float32)
        elif t == "STRING":
            c = rng.integers(1, 4, (lanes, B)).astype(np.int32)
        elif t == "INT":
            c = rng.integers(-3, 9, (lanes, B)).astype(np.int32)
        elif t == "LONG":
            c = rng.integers(-3, 9, (lanes, B)).astype(np.int64)
        else:
            c = rng.integers(0, 2, (lanes, B)).astype(bool)
        cols[k] = c
    tag = rng.integers(0, len(comp.merged.stream_ids), (lanes, B)).astype(np.int8)
    ts = TS_MODES[ts](rng, lanes, B, ts_step).astype(np.int32)
    base = rng.integers(10**6, 2 * 10**6, lanes).astype(np.int64) \
        if base is None else np.full(lanes, base, np.int64)
    counts = rng.integers(B // 2, B + 1, lanes).astype(np.int32)
    if empty_lane:
        counts[rng.integers(0, lanes)] = 0
    return cols, tag, ts, base, counts


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    from siddhi_tpu_torch.gpu import _build
    card = smi()
    t0 = time.perf_counter()
    _build.build_all(_build.sources())
    out = {"phase": "device", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "build_s": round(time.perf_counter() - t0, 3),
           "nvcc_s": {k: round(v, 3) for k, v in _build.build_seconds.items()}}
    emit(out)
    return card


def phase_shapes(seed: int) -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    rng = np.random.default_rng(seed)
    worst, cases = 0.0, []
    for name, B, C, K, lanes, ts_mode in SHAPE_CASES:
        app = parse(SHAPES[name])
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 C, B, creation_cap=K, device="cuda")
        state = comp.init_state(lanes)
        step = comp.make_step()
        cl, mode, scratch = comp.plan.layout(comp.plan._lib())
        if (cl, mode) != LAYOUTS.get((name, B, C, K), (BlockPlan.CLUSTER, 0)):
            fail(f"shape {name} B={B} C={C} K={K}: {cl} CTAs a lane, layout "
                 f"mode {mode} ({scratch} B of global scratch a lane)")
        if (cl, mode, scratch) != comp.plan.layout_mirror:
            fail(f"shape {name} B={B} C={C} K={K}: the kernel's plan "
                 f"{(cl, mode, scratch)}, the Python mirror's "
                 f"{comp.plan.layout_mirror}")
        emitted = 0
        for i in range(4):
            cols, tag, ts, base, counts = make_batch(
                rng, comp, lanes, empty_lane=lanes > 1 and i % 2 == 1,
                ts=ts_mode)
            dev = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
            rest = [torch.from_numpy(a).cuda() for a in (tag, ts, base, counts)]
            ref_state, ref_ys = block_step_plain(comp, clone(state), dev, *rest)
            if name == "sequence":           # through the 1-lane entry point
                state, ys = comp.step(state, {
                    "cols": {k: v[0] for k, v in cols.items()}, "tag": tag[0],
                    "ts": ts[0], "ts_base": base[0], "count": int(counts[0])})
                ys = {k: v[None] for k, v in ys.items()}
            else:
                state, ys = step(state, dev, *rest)
            torch.cuda.synchronize()
            ok1, e1, bad1 = compare(ref_state, state)
            ok2, e2, bad2 = compare(ref_ys, ys)
            worst = max(worst, e1, e2)
            if not (ok1 and ok2):
                fail(f"shape {name} B={B} C={C} K={K} step {i}: kernel differs "
                     f"from the plain version at {bad1 or bad2}")
            emitted += int(ref_ys["mask"].sum())
        cases.append({"shape": name, "B": B, "C": C, "K": K, "lanes": lanes,
                      "ts": ts_mode, "ctas": cl, "mode": mode,
                      "scratch_per_lane": scratch, "mirror_equal": True,
                      "advanced": emitted, "drops": int(state["drops"].sum()),
                      "equal": True})
    emit({"phase": "shapes", "cases": cases, "max_abs_err": worst})
    return worst


def bench_app(n_states: int = 8) -> str:
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else "e1=S[v > 90.0]"
        for i in range(1, n_states + 1))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v double);
partition with (dev of S)
begin
from every {states} within 4000
select {sel} insert into Alerts;
end;
"""


MAIN = dict(num_partitions=64, key_attr="dev", slot_capacity=64,
            lane_batch=2048, creation_cap=320)
N_KEYS = 256
CHUNK = 16384        # events per send_many call: ~256 per lane keeps steps full


def gen_events(n: int, seed: int):
    """``bench.py::gen_events``'s distribution: v uniform [0, 100) to 3
    decimals, one of 256 device keys, ts = 1,000,000 + i."""
    rng = np.random.default_rng(seed)
    names = np.array([f"dev{k}" for k in range(N_KEYS)])
    dev = names[rng.integers(0, N_KEYS, n)]
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    return dev, v, 1_000_000 + np.arange(n, dtype=np.int64)


def feed(rt, dev, v, ts) -> list:
    rows = []
    for lo in range(0, len(ts), CHUNK):
        sl = slice(lo, lo + CHUNK)
        rows.extend(rt.send_many("S", {"dev": dev[sl], "v": v[sl]}, ts[sl],
                                 decode=True))
    rows.extend(rt.flush(decode=True))
    return rows


def step_bytes(cols, tag, ts, base, counts, state_before, ys) -> int:
    """Bytes one step must move: each input read once, each output written
    once (state tables and counters are read and written)."""
    n = sum(c.numel() * c.element_size() for c in cols.values())
    n += sum(t.numel() * t.element_size() for t in (tag, ts, base, counts))
    n += 2 * sum(t.numel() * t.element_size() for _, t in flatten(state_before))
    n += sum(t.numel() * t.element_size() for t in ys.values())
    return n


def phase_main(seed: int, n_events: int):
    import torch
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    dev, v, ts = gen_events(n_events, seed)

    # ---- timed run: the entry points alone, the kernel step timed by events
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    marks = []

    def timed(state, *args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel_step(state, *args)
        e1.record()
        marks.append((e0, e1, args[4]))
        return out

    rt.vstep = timed
    feed(rt, dev[:CHUNK], v[:CHUNK], ts[:CHUNK])        # warm-up (untimed)
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    rt.vstep = timed
    marks.clear()
    torch.cuda.synchronize()
    BlockPlan.launches = 0                     # counts from here: main path
    t0 = time.perf_counter()
    rows = feed(rt, dev, v, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BlockPlan.launches
    steps = len(marks)
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    fill = [int(n.sum()) for _, _, n in marks]
    timed_rows, timed_matches, timed_drops = rows, rt.match_count, rt.drop_count
    if launches != steps * BlockPlan.LAUNCHES or launches == 0:
        fail(f"main path: {launches} kernel launches over {steps} steps")

    # ---- checked run: every step against the plain version on the card
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    comp = rt.compiler
    plain_rows, plain_ms, worst, work, nbytes = [], [], 0.0, {}, []

    def checked(state, cols, tag, ts_, base, counts):
        before = clone(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w = {}
        e0.record()
        ref_state, ref_ys = block_step_plain(comp, before, cols, tag, ts_,
                                             base, counts, work=w)
        e1.record()
        state, ys = kernel_step(state, cols, tag, ts_, base, counts)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        for k, x in w.items():
            work[k] = work.get(k, 0) + x
        nbytes.append(step_bytes(cols, tag, ts_, base, counts, before, ys))
        nonlocal worst
        ok1, e_1, bad1 = compare(ref_state, state)
        ok2, e_2, bad2 = compare(ref_ys, ys)
        worst = max(worst, e_1, e_2)
        if not (ok1 and ok2):
            fail(f"main path step {len(plain_ms)}: kernel differs from the "
                 f"plain version at {bad1 or bad2}")
        host = {k: x.cpu().numpy() for k, x in ref_ys.items()}
        for lane in range(rt.P):
            plain_rows.extend(comp.decode_outputs(
                {k: x[lane] for k, x in host.items()}))
        return state, ys

    rt.vstep = checked
    rows = feed(rt, dev, v, ts)
    if rows != plain_rows:
        fail("main path: decoded rows differ from the plain version's")
    if rows != timed_rows or rt.match_count != timed_matches \
            or rt.drop_count != timed_drops:
        fail("main path: the checked run differs from the timed run")
    if rt.match_count != len(rows):
        fail(f"main path: match_count {rt.match_count} != {len(rows)} rows")
    for r in rows:
        if len(r) != 8 or not all(np.isfinite(x) for x in r) or \
                not (r[0] > 90.0 and all(a < b for a, b in zip(r, r[1:]))):
            fail(f"main path: row breaks the rising-chain contract: {r}")

    med = float(np.median(step_ms))
    pmed = float(np.median(plain_ms))
    mean_bytes = float(np.mean(nbytes))
    ops_per_step = work.get("ops", 0) / max(len(plain_ms), 1)
    bound_bytes_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops_per_step / F32_OPS_PER_S * 1e3
    out = {
        "phase": "main", "events": int(n_events), "steps": steps,
        "events_per_s": n_events / wall, "wall_s": wall,
        "kernel_step_ms_median": med, "kernel_step_ms_all": step_ms,
        "plain_step_ms_median": pmed,
        "launches_per_step": launches / steps, "launches": launches,
        "matches": timed_matches, "drops": timed_drops, "rows": len(rows),
        "mean_lane_fill": float(np.mean(fill)) / (MAIN["num_partitions"] *
                                                  MAIN["lane_batch"]),
        "bytes_per_step": mean_bytes, "search_cells_per_step":
            work.get("cells", 0) / max(len(plain_ms), 1),
        "ops_per_step": ops_per_step,
        "bound_ms_bytes": bound_bytes_ms, "bound_ms_ops": bound_ops_ms,
        "max_abs_err": worst, "checked_steps": len(plain_ms),
    }
    emit(out)
    return out


def bench_csv(dev, v, ts) -> bytes:
    """The events as the transport would deliver them: CSV lines
    ``dev,v,ts`` (``bench.py``'s payload), built outside any timed
    region."""
    return "".join(f"{d},{x},{t}\n" for d, x, t in
                   zip(dev.tolist(), v.tolist(), ts.tolist())).encode()


def ingest_native(rt, csv: bytes) -> list:
    """The native route end to end: ``enable_native_ingress`` →
    ``ingest_csv`` (a step each time a lane fills) → ``flush_native`` for
    what is left, rows decoded."""
    rt.enable_native_ingress()
    rows = rt.ingest_csv(csv, ts_last=True, decode=True)
    rows.extend(rt.flush_native(decode=True))
    return rows


class HostSplit:
    """Host seconds of the native route's parts, by wrapping a runtime's
    methods: the C++ parse (``NativeIngress.ingest_csv``), the packing of
    the wire feed (``emit_native_feed``), the pinned H2D copies (``_wire``),
    the step call (``vstep``: checks and launch) and the decode (the rest
    of ``_step_and_decode``, which waits for the step's results)."""

    def __init__(self, rt):
        self.s = {"parse": 0.0, "emit_native_feed": 0.0, "wire": 0.0,
                  "step_call": 0.0, "decode_and_wait": 0.0}
        self.rt = rt
        self._wrap(rt, "emit_native_feed", "emit_native_feed")
        self._wrap(rt, "_wire", "wire")
        self._wrap(rt, "vstep", "step_call")
        inner = rt._step_and_decode

        def step_and_decode(*a):
            t0 = time.perf_counter()
            before = self.s["wire"] + self.s["step_call"]
            out = inner(*a)
            self.s["decode_and_wait"] += time.perf_counter() - t0 - (
                self.s["wire"] + self.s["step_call"] - before)
            return out
        rt._step_and_decode = step_and_decode
        enable = rt.enable_native_ingress

        def enable_and_wrap():
            enable()
            self._wrap(rt._ning, "ingest_csv", "parse")
        rt.enable_native_ingress = enable_and_wrap

    def _wrap(self, obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.s[key] += time.perf_counter() - t0
            return out
        setattr(obj, attr, timed)


def phase_native_main(seed: int, n_events: int):
    import torch
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    from siddhi_tpu_torch.native import native_available
    if not native_available():
        fail("native_main: no C++ toolchain for the native ingress")
    dev, v, ts = gen_events(n_events, seed)
    t0 = time.perf_counter()
    csv = bench_csv(dev, v, ts)
    csv_s = time.perf_counter() - t0

    # warm-up (builds the C++ loader, first launches) on a throwaway runtime
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    ingest_native(rt, csv[:csv.index(b"\n", len(csv) // 50) + 1])
    torch.cuda.synchronize()

    # ---- timed run: the entry points alone, the kernel step timed by events
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    marks = []

    def timed(state, *args):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel_step(state, *args)
        e1.record()
        marks.append((e0, e1, args[4]))
        return out

    rt.vstep = timed
    split = HostSplit(rt)
    torch.cuda.synchronize()
    BlockPlan.launches = 0                     # counts from here: native path
    t0 = time.perf_counter()
    rows = ingest_native(rt, csv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BlockPlan.launches
    steps = len(marks)
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    fill = [int(n.sum()) for _, _, n in marks]
    if launches != steps * BlockPlan.LAUNCHES or launches == 0:
        fail(f"native_main: {launches} kernel launches over {steps} steps")
    errors = rt._ning.parse_errors
    clamped = getattr(rt, "ts_clamped", 0)
    if errors or clamped:
        fail(f"native_main: {errors} parse errors, {clamped} clamped "
             f"timestamps")
    if sum(fill) != n_events:
        fail(f"native_main: {sum(fill)} events stepped of {n_events}")
    timed_rows, timed_matches, timed_drops = rows, rt.match_count, rt.drop_count

    # ---- checked run: every step against the plain version on the card
    rt = PartitionedNFARuntime(bench_app(), device="cuda", **MAIN)
    kernel_step = rt.vstep
    comp = rt.compiler
    plain_rows, plain_ms, worst = [], [], 0.0

    def checked(state, cols, tag, ts_, base, counts):
        nonlocal worst
        before = clone(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ref_state, ref_ys = block_step_plain(comp, before, cols, tag, ts_,
                                             base, counts)
        e1.record()
        state, ys = kernel_step(state, cols, tag, ts_, base, counts)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        ok1, e_1, bad1 = compare(ref_state, state)
        ok2, e_2, bad2 = compare(ref_ys, ys)
        worst = max(worst, e_1, e_2)
        if not (ok1 and ok2):
            fail(f"native_main step {len(plain_ms)}: kernel differs from the "
                 f"plain version at {bad1 or bad2}")
        host = {k: x.cpu().numpy() for k, x in ref_ys.items()}
        for lane in range(rt.P):
            plain_rows.extend(comp.decode_outputs(
                {k: x[lane] for k, x in host.items()}))
        return state, ys

    rt.vstep = checked
    rows = ingest_native(rt, csv)
    if rows != plain_rows:
        fail("native_main: decoded rows differ from the plain version's")
    if rows != timed_rows or rt.match_count != timed_matches \
            or rt.drop_count != timed_drops:
        fail("native_main: the checked run differs from the timed run")
    if rt.match_count != len(rows):
        fail(f"native_main: match_count {rt.match_count}, {len(rows)} rows")
    for r in rows:
        if len(r) != 8 or not all(np.isfinite(x) for x in r) or \
                not (r[0] > 90.0 and all(a < b for a, b in zip(r, r[1:]))):
            fail(f"native_main: row breaks the rising-chain contract: {r}")
    out = {
        "phase": "native_main", "events": int(n_events), "steps": steps,
        "csv_bytes": len(csv), "csv_build_s": csv_s,
        "events_per_s": n_events / wall, "wall_s": wall,
        "host_s": split.s,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_all": step_ms,
        "plain_step_ms_median": float(np.median(plain_ms)),
        "launches": launches, "launches_per_step": launches / steps,
        "matches": timed_matches, "drops": timed_drops, "rows": len(rows),
        "parse_errors": errors, "ts_clamped": clamped,
        "mean_lane_fill": float(np.mean(fill)) / (MAIN["num_partitions"] *
                                                  MAIN["lane_batch"]),
        "max_abs_err": worst, "checked_steps": len(plain_ms),
    }
    emit(out)
    return out


# ------------------------------------------------------- snapshots, entry

SNAP_CHAIN = """
define stream S (dev string, v double);
from every e1=S[v > 90.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] -> e4=S[v > e3.v]
  -> e5=S[v > e4.v] -> e6=S[v > e5.v] -> e7=S[v > e6.v] -> e8=S[v > e7.v]
  within 4000
select e1.dev as dev, e1.v as v1, e4.v as v4, e8.v as v8 insert into Alerts;
"""
SNAP_SCAN = """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
"""
SNAP_EVENTS = 60_000
SNAP_B = 2048


def snapshot_feed(name: str, seed: int) -> list:
    """(stream, row, ts) of the snapshot phase's app: the main path's
    events for the chain, the scan path's for the scan app."""
    if name == "chain":
        dev, v, ts = gen_events(SNAP_EVENTS, seed)
        return [("S", [d, x], t) for d, x, t in
                zip(dev.tolist(), v.tolist(), ts.tolist())]
    dev, is_temp, v, action, ts = scan_events(SNAP_EVENTS, seed)
    return [("Temp", [d, x], t) if tm else ("Reg", [d, a], t) for d, tm, x, a, t
            in zip(dev.tolist(), is_temp.tolist(), v.tolist(), action.tolist(),
                   ts.tolist())]


def run_resumed(app: str, events: list, cut):
    """Feeds ``events`` through a ``DeviceNFARuntime`` on the card; with a
    ``cut``, snapshots there (``snapshot_state`` + ``builder.snapshot()``),
    restores into a fresh runtime and feeds the rest. Returns (rows,
    matches, drops, final state on the host)."""
    import torch
    from siddhi_tpu_torch.gpu.nfa import DeviceNFARuntime
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy

    def fresh():
        rt = DeviceNFARuntime(app, slot_capacity=64, batch_capacity=SNAP_B,
                              device="cuda")
        rows = []
        rt.add_callback(rows.extend)
        return rt, rows

    rt, rows = fresh()
    staged = 0
    for i, (sid, row, t) in enumerate(events):
        if i == cut:
            snap, bsnap = rt.snapshot_state(), rt.builder.snapshot()
            staged = bsnap["n"]
            before = rows
            rt, rows = fresh()
            rt.restore_state(snap)
            rt.builder.restore(bsnap)
            rows[:0] = before
        rt.send(sid, row, t)
    rt.flush()
    torch.cuda.synchronize()
    return rows, rt.match_count, rt.drop_count, state_to_numpy(rt.state), staged


def phase_snapshot(seed: int) -> dict:
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan
    out = {"phase": "snapshot", "apps": []}
    BlockPlan.launches = ScanPlan.launches = 0    # counts from here
    for name, app, plan in (("chain", SNAP_CHAIN, BlockPlan),
                            ("scan", SNAP_SCAN, ScanPlan)):
        events = snapshot_feed(name, seed)
        cut = len(events) // 2 + SNAP_B // 3         # mid-batch
        n0 = plan.launches
        whole = run_resumed(app, events, None)
        resumed = run_resumed(app, events, cut)
        if resumed[4] == 0:
            fail(f"snapshot {name}: no rows staged in the builder at the cut")
        if whole[:3] != resumed[:3]:
            fail(f"snapshot {name}: the resumed run's rows or counters "
                 f"differ ({resumed[1]} matches, {resumed[2]} drops; whole "
                 f"{whole[1]}, {whole[2]})")
        a, b = dict(flatten(whole[3])), dict(flatten(resumed[3]))
        if a.keys() != b.keys() or any(
                a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()
                for k in a):
            fail(f"snapshot {name}: the resumed run's final state differs")
        if not whole[1]:
            fail(f"snapshot {name}: no match in {len(events)} events")
        out["apps"].append({"app": name, "kernel": plan.__name__,
                            "events": len(events), "cut": cut,
                            "staged_at_cut": resumed[4],
                            "launches": plan.launches - n0,
                            "matches": whole[1], "drops": whole[2],
                            "rows": len(whole[0]), "equal": True})
    if not BlockPlan.launches or not ScanPlan.launches:
        fail(f"snapshot: {BlockPlan.launches} blocked and "
             f"{ScanPlan.launches} scan launches")
    emit(out)
    return out


def phase_entry() -> dict:
    import torch
    from siddhi_tpu_torch.entry import dryrun_multichip, entry
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    fn, args = entry()
    comp = fn.plan.nfa
    BlockPlan.launches = 0                        # counts from here
    state, cols, tag, ts, base, nvalid = args
    ref_state, ref_ys = block_step_plain(comp, clone(state), cols, tag, ts,
                                         base, nvalid)
    got_state, got_ys = fn(*args)
    torch.cuda.synchronize()
    ok1, _, bad1 = compare(ref_state, got_state)
    ok2, _, bad2 = compare(ref_ys, got_ys)
    if not (ok1 and ok2):
        fail(f"entry: the step differs from the plain version at "
             f"{bad1 or bad2}")
    step_launches = BlockPlan.launches
    dry = dryrun_multichip(1)
    if step_launches != 1 or BlockPlan.launches <= step_launches:
        fail(f"entry: {step_launches} launches for entry(), "
             f"{BlockPlan.launches - step_launches} for the dry run")
    out = {"phase": "entry", "entry_matches": int(got_ys["mask"].sum()),
           "entry_launches": step_launches,
           "dryrun_matches": dry["matches"], "dryrun_expected": dry["expected"],
           "dryrun_launches": BlockPlan.launches - step_launches,
           "equal": True}
    emit(out)
    return out


# ---------------------------------------------------------- the scan shape

def scan_shapes_module():
    """``tests/test_torch_scan_shapes.py``: the scan apps and cases the CPU
    tests run (it imports the port, not the JAX package)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_scan_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_scan_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus_data() -> dict:
    """The data region of ``tests/test_pattern_corpus.py`` (app texts and
    the ``CASES`` list; no imports), executed on its own: the file imports
    the JAX package, which this script never imports."""
    import types

    class _Param:
        @staticmethod
        def param(*values, id=None):
            return types.SimpleNamespace(values=values, id=id)

    with open(os.path.join(REPO, "tests", "test_pattern_corpus.py")) as f:
        src = f.read()
    start = src.index('S2 = """')
    end = src.index("def test_every_zero_min_count_alone")
    ns = {"pytest": _Param}
    exec(src[start:end], ns)
    return ns


def checking_step(comp, state_err: list):
    """The compiled step, held against its plain version on every call
    (same inputs, plain first on a copy of the state)."""
    import torch
    from siddhi_tpu_torch.gpu.nfa_block import block_step_plain
    from siddhi_tpu_torch.gpu.nfa_scan import scan_step_plain
    kstep = comp.make_step()
    plain = block_step_plain if comp.blocked else scan_step_plain

    def step(state, *args):
        ref_state, ref_ys = plain(comp, clone(state), *args)
        state, ys = kstep(state, *args)
        torch.cuda.synchronize()
        ok1, e1, bad1 = compare(ref_state, state)
        ok2, e2, bad2 = compare(ref_ys, ys)
        state_err.append(max(e1, e2))
        if not (ok1 and ok2):
            raise AssertionError(f"kernel differs from the plain version at "
                                 f"{bad1 or bad2}")
        return state, ys
    step.plan = kstep.plan
    return step


TS_APPS = {
    "blocked": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v and eventTimestamp() > 0]
select e1.v as a insert into O;
""",
    "scan": """
define stream S (v double);
from every e1=S[v > 1.0] -> e2=S[v > e1.v]<1:2> -> e3=S[eventTimestamp() > 0]
select e1.v as a insert into O;
""",
}


def phase_scan_shapes(seed: int) -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.nfa import DeviceNFACompiler, DeviceNFARuntime
    rng = np.random.default_rng(seed)
    errs: list = []
    # ---- the CPU tests' shapes, lane-batched, 4 steps each
    shapes = scan_shapes_module()
    cases = []
    for name, B, C, lanes, ts_step, base in shapes.CASES:
        app = parse(shapes.APPS[name][0])
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 C, B, device="cuda")
        if comp.blocked:
            fail(f"scan shape {name} compiled to the blocked kernel")
        step = checking_step(comp, errs)
        state = comp.init_state(lanes, 0 if base is not None else 1_000_000)
        emitted = 0
        for i in range(4):
            cols, tag, ts, tb, counts = shapes.shape_batch(name, make_batch(
                rng, comp, lanes, i % 2 == 1, ts_step, base))
            dev = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
            rest = [torch.from_numpy(a).cuda() for a in (tag, ts, tb, counts)]
            try:
                state, ys = step(state, dev, *rest)
            except AssertionError as e:
                fail(f"scan shape {name} B={B} C={C} step {i}: {e}")
            emitted += int(ys["mask"].sum())
        cases.append({"shape": name, "B": B, "C": C, "lanes": lanes,
                      "emitted": emitted, "drops": int(state["drops"].sum()),
                      "equal": True})
    # ---- the pattern corpus through DeviceNFARuntime on the card
    corpus = corpus_data()
    start = 900                       # test_pattern_corpus.START
    n_scan = n_block = rows = steps = 0
    for p in corpus["CASES"]:
        app, seq = p.values[0], p.values[1]
        try:
            rt = DeviceNFARuntime(app, slot_capacity=32, batch_capacity=32,
                                  start_time=start, device="cuda")
        except DeviceCompileError:
            continue
        n0 = len(errs)
        rt.compiler._step = checking_step(rt.compiler, errs)
        out: list = []
        rt.add_callback(out.extend)
        ts = start
        try:
            for entry in seq:
                ts += entry[2] if len(entry) > 2 else 100
                rt.send(entry[0], list(entry[1]), ts)
            rt.flush()
        except AssertionError as e:
            fail(f"corpus case {p.id}: {e}")
        n_block += rt.compiler.blocked
        n_scan += not rt.compiler.blocked
        rows += len(out)
        steps += len(errs) - n0
    # ---- eventTimestamp() in a pattern: KeyError('__ts__') at the first
    # step, for both shapes, as the reference raises
    for shape, text in TS_APPS.items():
        app = parse(text)
        comp = DeviceNFACompiler(app.queries[0], dict(app.stream_definitions),
                                 8, 16, device="cuda")
        batch = {"cols": {"s0_v": np.array([2.0, 3.0] + [0.0] * 14,
                                           np.float32)},
                 "tag": np.zeros(16, np.int8),
                 "ts": np.array([0, 100] + [0] * 14, np.int32),
                 "ts_base": np.int64(5000), "count": 2}
        try:
            comp.step(comp.init_state(1), batch)
            fail(f"eventTimestamp() in a {shape} pattern did not raise")
        except KeyError as e:
            if "__ts__" not in str(e):
                fail(f"eventTimestamp() in a {shape} pattern: {e!r}")
    worst = max(errs) if errs else 0.0
    emit({"phase": "scan_shapes", "cases": cases,
          "corpus": {"scan_cases": n_scan, "blocked_cases": n_block,
                     "steps_checked": steps, "rows": rows, "equal": True},
          "event_timestamp_raises": True, "max_abs_err": worst})
    return worst


SCAN_APP = """
define stream Temp (dev string, v double);
define stream Reg (dev string, action string);
partition with (dev of Temp, dev of Reg)
begin
from every e1=Temp[v > 90.0] -> e2=Temp[v > e1.v] and e3=Reg[action == 'on']
  -> e4=Temp[v > e2.v]<2:4> -> e5=Temp[v < e1.v] within 4000
select e1.dev as dev, e1.v as v1, e3.action as a, e5.v as v5 insert into Alerts;
end;
"""
SCAN_MAIN = dict(num_partitions=64, key_attr="dev", slot_capacity=64,
                 lane_batch=2048)
SCAN_EVENTS = 2_000_000
SCAN_CHECK_STEPS = 2     # full-width steps held against the plain version


def scan_events(n: int, seed: int):
    """The scan path's traffic: 90 % Temp with v ~ U(0, 100), 10 % Reg with
    action on/off at 50 % each, keys uniform over 256, ts increments
    U{0, 1, 2} ms."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"dev{k}" for k in range(N_KEYS)])
    dev = keys[rng.integers(0, N_KEYS, n)]
    is_temp = rng.random(n) < 0.9
    v = np.round(rng.uniform(0.0, 100.0, n), 3)
    action = np.where(rng.random(n) < 0.5, "on", "off")
    ts = 1_000_000 + np.cumsum(rng.integers(0, 3, n))
    return dev, is_temp, v, action, ts


def feed_scan(rt, ev, stop=None) -> list:
    """Runs of consecutive same-stream events through ``send_many``, then
    ``flush(decode=True)``; ``stop()`` ends the feed early."""
    dev, is_temp, v, action, ts = ev
    # run boundaries: where the stream changes
    cut = np.flatnonzero(is_temp[1:] != is_temp[:-1]) + 1
    lo_all = np.concatenate([[0], cut])
    hi_all = np.concatenate([cut, [len(ts)]])
    rows: list = []
    for lo, hi in zip(lo_all, hi_all):
        if stop is not None and stop():
            return rows
        sl = slice(int(lo), int(hi))
        if is_temp[lo]:
            rows.extend(rt.send_many("Temp", {"dev": dev[sl], "v": v[sl]},
                                     ts[sl], decode=True))
        else:
            rows.extend(rt.send_many("Reg", {"dev": dev[sl],
                                             "action": action[sl]},
                                     ts[sl], decode=True))
    rows.extend(rt.flush(decode=True))
    return rows


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(tree))


def scan_ops(plan, L: int, B: int) -> int:
    """Operations one step does on these inputs, at the least: for every
    event, lane and slot, each state's mask arithmetic (~10 elementwise
    operations) and its linked predicate programs."""
    d = plan.desc
    per_slot = 0
    for s in range(d.S):
        st = d.st[s]
        per_slot += 10 + sum(st.pred[i].len + st.pred_prev[i].len
                             for i in range(st.nbr))
    return L * B * d.C * per_slot


def phase_scan_main(seed: int, n_events: int):
    import torch
    from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan, scan_step_plain
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    ev = scan_events(n_events, seed)

    # ---- warm-up (builds, first launch) on a throwaway runtime
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    if rt.compiler.blocked or [s.kind for s in rt.compiler.states] != \
            ["stream", "logical", "count", "stream"]:
        fail("scan_main: the app does not compile to the 4-state scan shape")
    feed_scan(rt, tuple(x[:CHUNK] for x in ev))
    torch.cuda.synchronize()

    # ---- timed run: the entry points alone, the kernel step timed by events
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    kernel_step = rt.vstep
    marks, step_rows = [], []
    shapes = {}

    def timed(state, *args):
        if not shapes:
            shapes["wire"] = sum(t.numel() * t.element_size()
                                 for t in [*args[0].values(), *args[1:]])
            shapes["state"] = tree_bytes(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kernel_step(state, *args)
        e1.record()
        marks.append((e0, e1, args[4]))
        shapes["ys"] = tree_bytes(out[1])
        return out

    step_and_decode = rt._step_and_decode

    def per_step_rows(*args):
        r = step_and_decode(*args)
        step_rows.append(list(r))
        return r

    rt.vstep = timed
    rt._step_and_decode = per_step_rows
    torch.cuda.synchronize()
    ScanPlan.launches = 0                       # counts from here: main path
    t0 = time.perf_counter()
    rows = feed_scan(rt, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ScanPlan.launches
    steps = len(marks)
    step_ms = [a.elapsed_time(b) for a, b, _ in marks]
    fill = [int(n.sum()) for _, _, n in marks]
    matches, drops = rt.match_count, rt.drop_count
    if launches != steps or launches == 0:
        fail(f"scan_main: {launches} kernel launches over {steps} steps")
    if matches != len(rows) or matches == 0:
        fail(f"scan_main: match_count {matches}, {len(rows)} rows")
    for r in rows:
        if len(r) != 4 or not isinstance(r[0], str) or r[2] != "on" or \
                not (np.isfinite(r[1]) and np.isfinite(r[3])) or \
                not (r[1] > 90.0 and r[3] < r[1]):
            fail(f"scan_main: row breaks the pattern's contract: {r}")

    # ---- checked run: the first steps and one later step (the last a full
    # lane triggered, its tables warm) against the plain version on the
    # card, each from the state the kernel reached before it
    late = steps - 2 if steps > SCAN_CHECK_STEPS + 1 else None
    rt = PartitionedNFARuntime(SCAN_APP, device="cuda", **SCAN_MAIN)
    comp = rt.compiler
    kernel_step = rt.vstep
    plain_ms, worst, checked_rows, checked_at, seen = [], 0.0, [], [], [0]

    def checked(state, cols, tag, ts_, base, counts):
        nonlocal worst
        i = seen[0]
        seen[0] += 1
        if i >= SCAN_CHECK_STEPS and i != late:
            return kernel_step(state, cols, tag, ts_, base, counts)
        before = clone(state)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ref_state, ref_ys = scan_step_plain(comp, before, cols, tag, ts_,
                                            base, counts)
        e1.record()
        state, ys = kernel_step(state, cols, tag, ts_, base, counts)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        checked_at.append(i)
        ok1, e_1, bad1 = compare(ref_state, state)
        ok2, e_2, bad2 = compare(ref_ys, ys)
        worst = max(worst, e_1, e_2)
        if not (ok1 and ok2):
            fail(f"scan_main step {i}: kernel differs from the plain version "
                 f"at {bad1 or bad2}")
        got, want = comp.decode_outputs(ys), comp.decode_outputs(ref_ys)
        if got != want:
            fail(f"scan_main step {i}: decoded rows differ")
        checked_rows.append((i, got))
        return state, ys

    rt.vstep = checked
    feed_scan(rt, ev, stop=lambda: late is None and seen[0] >= SCAN_CHECK_STEPS)
    want_at = list(range(min(SCAN_CHECK_STEPS, steps))) + \
        ([late] if late is not None else [])
    if checked_at != want_at:
        fail(f"scan_main: steps {checked_at} checked, {want_at} wanted")
    if any(got != step_rows[i] for i, got in checked_rows):
        fail("scan_main: the checked run's rows differ from the timed run's")

    L, B = SCAN_MAIN["num_partitions"], SCAN_MAIN["lane_batch"]
    nbytes = shapes["wire"] + 2 * shapes["state"] + shapes["ys"]
    ops = scan_ops(kernel_step.plan, L, B)
    out = {
        "phase": "scan_main", "events": int(n_events), "steps": steps,
        "events_per_s": n_events / wall, "wall_s": wall,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "kernel_step_ms_all": step_ms,
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_step_ms_all": plain_ms, "plain_device": "cuda",
        "checked_steps": len(plain_ms), "checked_step_indices": checked_at,
        "launches": launches,
        "matches": matches, "drops": drops, "rows": len(rows),
        "send_many_calls": 1 + int(np.count_nonzero(ev[1][1:] != ev[1][:-1])),
        "mean_lane_fill": float(np.mean(fill)) / (L * B),
        "bytes_per_step": nbytes, "ys_bytes_per_step": shapes["ys"],
        "wire_bytes_per_step": shapes["wire"],
        "state_bytes": shapes["state"], "ops_per_step": ops,
        "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_ms_ops": ops / F32_OPS_PER_S * 1e3,
        "max_abs_err": worst,
    }
    emit(out)
    return out


# ------------------------------------------------- single-stream queries

def query_shapes_module():
    """``tests/test_torch_query_shapes.py``: the query cases, refusal lists
    and tolerances of the CPU tests (it imports the port, not the JAX
    package)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_query_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_query_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_query_shapes() -> float:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.query_compile import (CompiledStreamQuery,
                                                    stream_step_plain)
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    sh = query_shapes_module()
    t_phase = time.perf_counter()
    worst, cases = 0.0, []
    for name, B in sh.CASES + sh.WINDOW_CASES + sh.CARD_CASES:
        q = sh.compile_port(name, B, "cuda")
        state = q.init_state()
        wire = sh.wire_for(name, B)
        rows = 0
        for step in range(sh.STEPS):
            cols, ts, valid = q.batch_tensors(wire.batch(step))
            scale = sh.step_scale(q, state, cols, ts, valid)
            ref_state, ref_out = stream_step_plain(q, state, cols, ts, valid)
            state, out = q.step_tensors(state, cols, ts, valid)
            torch.cuda.synchronize()
            try:
                err = sh.compare(q, scale, state_to_numpy(ref_state),
                                 state_to_numpy(state),
                                 state_to_numpy(ref_out), state_to_numpy(out))
            except AssertionError as e:
                fail(f"query shape {name} B={B} step {step}: kernel differs "
                     f"from the plain version: {str(e)[:400]}")
            worst = max(worst, err)
            rows += int(out["valid"].sum())
        cases.append({"query": name, "B": B, "kernel": q.plan.LIB,
                      "rows": rows})
    for label in sorted(sh.CARRIED):
        try:
            err, rows = sh.kernel_steps(*sh.carried_start(label, "cuda"))
        except AssertionError as e:
            fail(f"query walk from the carried table {label}: kernel differs "
                 f"from the plain version: {str(e)[:400]}")
        worst = max(worst, err)
        cases.append({"query": label, "B": sh.CARRIED[label][1],
                      "kernel": "query_walk", "rows": rows})

    def build(text):
        app = parse(sh.REFUSAL_SCHEMA + text)
        return CompiledStreamQuery(app.queries[0], app.stream_definitions["S"],
                                   8, device="cuda")

    for text in sh.REFUSED:
        try:
            build(text)
            fail(f"the card accepted a query the reference refuses: {text}")
        except DeviceCompileError:
            pass
    for text in sh.STEP_RAISES:
        q = build(text)
        try:
            q.step(q.init_state(), sh.refusal_wire(8))
            fail(f"a constant projection ran on the card: {text}")
        except AttributeError:
            pass
    for window, body in sh.STAGED.items():
        if build(f"from S{body} insert into O;").plan.link_error is not None:
            fail(f"window '{window}': the kernel plan does not link")
    for text in sh.ACCEPTED:
        build(text)
    emit({"phase": "query_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "step_raises": len(sh.STEP_RAISES),
          "windows_compiled": len(sh.STAGED), "accepted": len(sh.ACCEPTED),
          "max_abs_err": worst, "phase_s": time.perf_counter() - t_phase})
    return worst


QUERY_EVENTS = 2_000_000          # events per query_main configuration
# full-width steps held against the plain version (None: every step); the
# heavy hitters' plain version walks each event in Python
QUERY_CHECK_STEPS = {"lossy_frequent": 2}


def query_step_bytes(state, new_state, cols, ts, valid, out) -> int:
    """Bytes one step must move: the columns it reads, the state leaves it
    reads and the ones it writes anew, the outputs."""
    n = sum(t.numel() * t.element_size() for t in (*cols.values(), ts, valid))
    n += sum(t.numel() * t.element_size() for t in state.values())
    n += sum(t.numel() * t.element_size() for k, t in new_state.items()
             if t is not state[k])
    n += sum(t.numel() * t.element_size() for t in
             (*out["out"].values(), out["valid"], out["ts"]))
    return n


HH_LOOKUP_OPS = 8   # a key's hash (three multiplies, three shift-xors), a probe


def hh_passes(q, state, new_state) -> int:
    """Passes over every slot that this step's data needs in the lossy walk:
    the step's first accepted event and every change of the bucket number
    floor(total * error) + 1 after it."""
    if q.window_kind != "lossyFrequent":
        return 0
    t0, t1 = int(state["hh_total"]), int(new_state["hh_total"])
    if t1 == t0:
        return 0
    err = q.lossy_error
    return int(float(t1) * err) - int(float(t0 + 1) * err) + 1


def query_step_ops(q, passes: int = 0) -> int:
    """Operations one step does at the least: every event runs its filter and
    argument programs; every scanned lane adds once per position of its axis;
    every output slot materialises its specs (a few operations each) and,
    grouped or time-windowed, binary-searches its range (log2 of the axis).
    The walked heavy hitters: one key lookup and one row per event, and one
    visit of each of the C slots per pass over the table (``passes``: the
    lossy window's bucket changes, frequent's decrement-alls)."""
    a = q.plan.args
    prog = query_prog_ops(q)
    if q.plan.LIB == "query_walk":
        return q.B * (prog + HH_LOOKUP_OPS + 4 * a.nspec) + passes * a.N
    lanes = a.AF + a.AI + 1 + 2 * a.AS + 2 * a.AM if a.has_agg else 0
    search = int(np.log2(max(a.M, 2))) * (2 if a.grouped else 1)
    return q.B * prog + a.M * lanes + a.O * (4 * a.nspec + search)


def query_prog_ops(q) -> int:
    """Instructions of the programs one event runs: filters, aggregate
    arguments, projections, having."""
    a = q.plan.args
    return sum(p.len for p in a.filt[:a.nfilt]) + \
        sum(a.lane[c][l].len for c, n in enumerate((a.AF, a.AI, a.AS, a.AM))
            for l in range(n)) + \
        sum(a.proj[i].len for i in range(a.nspec)) + a.having.len


def walk_ops_two_passes(q) -> int:
    """The walk's operations as the bound of its first design counted them:
    two passes over the C slots per event (that design's work, not the
    walk's)."""
    a = q.plan.args
    return q.B * query_prog_ops(q) + q.B * 2 * a.N + q.B * 4 * a.nspec


def time_batch_reference(cols, ts) -> list:
    """(c)'s rows from numpy alone: the accepted events (v > 0 in float32)
    bucketed by (ts - first ts) // 10 s; every bucket but the open last one
    gives [avg, min, max, stdDev, sum(n), count]."""
    v = cols["v"].astype(np.float32)
    acc = v > 0
    va, na, ta = v[acc].astype(np.float64), cols["n"][acc], ts[acc]
    seg = (ta - ta[0]) // 10_000
    out = []
    for b in np.unique(seg)[:-1]:
        m = seg == b
        x = va[m]
        out.append([float(x.mean()), float(x.min()), float(x.max()),
                    float(x.std()), int(na[m].sum()), int(m.sum())])
    return out


def check_query_rows(name: str, rows: list, cols, ts) -> dict:
    """Each configuration's rows against what the query promises (and, for
    (c) and (d), against numpy)."""
    extra = {}
    if name == "time_batch":
        want = time_batch_reference(cols, ts)
        if len(rows) != len(want):
            fail(f"query_main {name}: {len(rows)} rows, numpy gives {len(want)}")
        for r, w in zip(rows, want):
            if r[4:] != w[4:] or r[1] != w[1] or r[2] != w[2] or \
                    abs(r[0] - w[0]) > 1e-4 * max(1.0, abs(w[0])) or \
                    abs(r[3] - w[3]) > 1e-3:
                fail(f"query_main {name}: row {r} differs from numpy's {w}")
        extra["numpy_buckets"] = len(want)
        return extra
    if name == "lossy_frequent":
        cards, price = cols["cardNo"], cols["price"].astype(np.float32)
        acc = cards[price >= 30.0]
        uniq, cnt = np.unique(acc, return_counts=True)
        share = cnt / len(acc)
        top = uniq[np.argmax(cnt)]
        # a key emits only if its count in the prefix read so far is at
        # least (support - error) of it: once the prefix is long, only the
        # top card (~14 %) qualifies, every other card holds under 9 %
        late = {r[0] for r in rows[len(rows) // 2:]}
        if late != {top} or np.sort(share)[-2] >= 0.09:
            fail(f"query_main {name}: the late rows name {sorted(late)[:5]} "
                 f"(top card {top}, shares {np.sort(share)[-2:]})")
        # the reference retracts every pruned entry's last event, emitted
        # or not, so the running sum and count may fall below zero
        for r in rows:
            if not (isinstance(r[0], str) and np.isfinite(r[1])
                    and isinstance(r[2], int)):
                fail(f"query_main {name}: row breaks the query's contract: {r}")
        extra.update(emitted_cards=len({r[0] for r in rows}),
                     top_card_share=float(share.max()))
        return extra
    for r in rows:
        if name == "grouped_length":
            ok = isinstance(r[0], str) and 1 <= r[3] <= 4096 and \
                np.isfinite(r[1]) and r[1] >= 0 and 0 <= r[2] and \
                abs(r[4] - r[1] / r[3]) <= 1e-3 * max(1.0, r[4])
        else:
            ok = 1 <= r[4] <= 65536 and r[1] - 1e-3 <= r[0] <= r[2] + 1e-3 \
                and r[3] >= 0 and 0 <= r[1] and r[2] < 100
        if not ok:
            fail(f"query_main {name}: row breaks the query's contract: {r}")
    return extra


def run_twice(name: str, kstep, state, c, t, v) -> dict:
    """One full-width step run twice from the same state and inputs: every
    output and state leaf must be bitwise equal (the kernels' float64 sums
    associate in an order fixed by their tile layout)."""
    import torch
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    runs = [kstep(state, c, t, v) for _ in range(2)]
    torch.cuda.synchronize()
    (s1, o1), (s2, o2) = [(state_to_numpy(a), state_to_numpy(b)) for a, b in runs]
    leaves = 0
    for tag, x, y in [*((f"state.{k}", s1[k], s2[k]) for k in sorted(s1)),
                      *((f"out.{k}", o1["out"][k], o2["out"][k]) for k in sorted(o1["out"])),
                      *((k, o1[k], o2[k]) for k in ("valid", "ts", "count"))]:
        if np.asarray(x).tobytes() != np.asarray(y).tobytes():
            fail(f"query_main {name}: {tag} differs between two runs of one "
                 f"step from the same state and inputs")
        leaves += 1
    return {"leaves": leaves, "equal": True}


def phase_query_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.query_compile import stream_step_plain
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.gpu.query_walk import WalkPlan
    from siddhi_tpu_torch.gpu.runtime import DeviceStreamRuntime
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    from siddhi_tpu_torch.tools.query_workloads import (QUERY_MAIN,
                                                        feed_query,
                                                        query_events)
    sh = query_shapes_module()
    t_phase = time.perf_counter()
    cfg = dict(QUERY_MAIN[name])
    app = cfg.pop("app")
    cfg.pop("stream")
    cols, ts = query_events(name, QUERY_EVENTS, seed)

    # warm-up: build, first launches
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    feed_query(rt, {k: v[:3 * rt.compiled.B] for k, v in cols.items()},
               ts[:3 * rt.compiled.B])
    torch.cuda.synchronize()

    # ---- timed run: the entry points alone; CUDA events around the step
    # call (the wrapper's host work included) and around the kernels'
    # launch call alone (``lib.query_step``: the kernels' own time)
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    q = rt.compiled
    kstep = q.step_tensors
    marks, kmarks, shapes, fulls = [], [], {}, []

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(state, c, t, v):
        e0, e1 = event_pair()
        e0.record()
        new, out = kstep(state, c, t, v)
        e1.record()
        marks.append((e0, e1))
        fulls.append(bool(v.all()))
        if not shapes:
            shapes["bytes"] = query_step_bytes(state, new, c, t, v, out)
            shapes["passes"] = hh_passes(q, state, new)
        return new, out

    plan = type(q.plan)
    lib = q.plan._lib()
    entry = getattr(lib, plan.LIB)

    class TimedLib:
        def __getattr__(self, attr):
            if attr != plan.LIB:
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = entry(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    q.plan._lib = lambda: timed_lib
    q.step_tensors = timed
    torch.cuda.synchronize()
    QueryPlan.launches = WalkPlan.launches = 0   # counts from here: main path
    t0 = time.perf_counter()
    rows = feed_query(rt, cols, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = plan.launches
    other = QueryPlan.launches + WalkPlan.launches - launches
    steps = len(marks)
    call_ms = [a.elapsed_time(b) for a, b in marks]
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    if len(kmarks) != steps:
        fail(f"query_main {name}: {len(kmarks)} kernel calls over {steps} steps")
    per_step = q.plan.step_launches()
    if launches != steps * per_step or launches == 0 or other:
        fail(f"query_main {name}: {launches} {plan.LIB} launches over {steps} "
             f"steps ({other} of the other query kernel)")
    drops = int(rt.state["window_drops"]) if "window_drops" in rt.state else 0
    coll = rt.group_collision_count
    if (drops and name != "lossy_frequent") or coll:
        fail(f"query_main {name}: {drops} window drops, {coll} collisions")
    extra = check_query_rows(name, rows, cols, ts)

    # ---- checked run: every step against the plain version on the card
    # (where the plain version is too slow for that, the first steps and
    # the last full one, its tables warm, each from the state the kernel
    # reached before it)
    rt = DeviceStreamRuntime(app, device="cuda", **cfg)
    q = rt.compiled
    kstep = q.step_tensors
    plain_ms, worst, equal_steps = [], 0.0, 0
    limits, fsum_limit, row_limit, twice = {}, [], [], []
    check_steps = QUERY_CHECK_STEPS.get(name)
    late = max((i for i, f in enumerate(fulls) if f), default=None) \
        if check_steps is not None else None
    if late is not None and late < check_steps:
        late = None
    seen, checked_at = [0], []

    def checked(state, c, t, v):
        nonlocal worst, equal_steps
        i = seen[0]
        seen[0] += 1
        if check_steps is not None and i >= check_steps and i != late:
            return kstep(state, c, t, v)
        checked_at.append(i)
        if plan is QueryPlan and not twice and len(plain_ms) >= 9 and \
                bool(v.all()):
            twice.append(run_twice(name, kstep, state, c, t, v))
        e0, e1 = event_pair()
        e0.record()
        ref_state, ref_out = stream_step_plain(q, state, c, t, v)
        e1.record()
        new, out = kstep(state, c, t, v)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        scale = sh.step_scale(q, state, c, t, v)
        fsum_limit.append(2.0 ** -20 * (1.0 + scale.top("s1")))
        for r in (scale.row or {}).values():
            row_limit.extend((2.0 ** -20 * (1.0 + float(np.min(r))),
                              2.0 ** -20 * (1.0 + float(np.max(r)))))
        try:
            err = sh.compare(q, scale, state_to_numpy(ref_state),
                             state_to_numpy(new), state_to_numpy(ref_out),
                             state_to_numpy(out), limits)
        except AssertionError as e:
            fail(f"query_main {name} step {len(plain_ms)}: kernel differs "
                 f"from the plain version: {str(e)[:400]}")
        worst = max(worst, err)
        equal_steps += err == 0.0
        return new, out

    q.step_tensors = checked
    rows2 = feed_query(rt, cols, ts)
    if check_steps is not None and checked_at != \
            list(range(min(check_steps, steps))) + ([late] if late is not None else []):
        fail(f"query_main {name}: steps {checked_at} checked")
    if plan is QueryPlan and not twice:
        fail(f"query_main {name}: no full-width step was run twice")
    if rows2 != rows:
        fail(f"query_main {name}: the checked run's rows differ from the "
             f"timed run's")
    ops = query_step_ops(q, shapes["passes"])
    walked = plan is WalkPlan
    out = {
        "phase": "query_main", "config": name, "kernel": plan.LIB,
        "events": QUERY_EVENTS,
        "steps": steps, "events_per_s": QUERY_EVENTS / wall, "wall_s": wall,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        **({"checked_step_indices": checked_at}
           if check_steps is not None else {}),
        "bitwise_equal_steps": equal_steps,
        "rows": len(rows), "window_drops": drops, "group_collisions": coll,
        "bytes_per_step": shapes["bytes"], "ops_per_step": ops,
        "bound_ms_bytes": shapes["bytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_ms_ops": ops / F32_OPS_PER_S * 1e3,
        **({"table_passes_per_step": shapes["passes"],
            "ops_per_step_two_passes_per_event": walk_ops_two_passes(q),
            "bound_ms_ops_two_passes_per_event":
                walk_ops_two_passes(q) / F32_OPS_PER_S * 1e3}
           if walked else {}),
        "max_abs_err": worst, "errors_by_output": limits,
        "fsum_limit_min": float(np.min(fsum_limit)),
        "fsum_limit_max": float(np.max(fsum_limit)),
        "fsum_row_limit_min": float(np.min(row_limit)) if row_limit else None,
        "fsum_row_limit_max": float(np.max(row_limit)) if row_limit else None,
        "run_twice_bitwise": twice[0] if twice else None,
        "phase_s": time.perf_counter() - t_phase, **extra,
    }
    emit(out)
    return out


QUERY_ENTRIES = [
    # (name, source, replaced TPU kernel, also replaced, configurations)
    ("query_step", "query_step.cu", "siddhi_tpu/tpu/query_compile.py:608",
     ["siddhi_tpu/tpu/expr_compile.py:121"],
     ("grouped_length", "time_minmax_std")),
    ("query_step_tumbling", "query_step.cu",
     "siddhi_tpu/tpu/query_compile.py:1316",
     ["siddhi_tpu/tpu/query_compile.py:1235",
      "siddhi_tpu/tpu/query_compile.py:872",
      "siddhi_tpu/tpu/query_compile.py:1554", "siddhi_tpu/tpu/runtime.py:21"],
     ("time_batch",)),
    ("query_walk", "query_walk.cu", "siddhi_tpu/tpu/query_compile.py:1648",
     ["siddhi_tpu/tpu/query_compile.py:1447"], ("lossy_frequent",)),
]


def query_kernel_entries(q_outs: list, shapes_err: float) -> list:
    """The ``kernels`` line's query entries: B5a (times and bound of the
    sample's configuration (a), (b) beside it under ``configs``), the
    tumbling family of B5b ((c)) and the scan-walked kernel ((d))."""
    by = {o["config"]: o for o in q_outs}
    entries = []
    for name, src, replaces, also, configs in QUERY_ENTRIES:
        outs = [by[c] for c in configs]
        a = outs[0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"siddhi_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "also_replaces": also,
            "launches": sum(o["launches"] for o in outs),
            "max_abs_err": max([shapes_err] + [o["max_abs_err"] for o in outs]),
            "ms": a["kernel_step_ms_median"],
            "plain_ms": a["plain_step_ms_median"],
            "bound_ms": max(a["bound_ms_bytes"], a["bound_ms_ops"]),
            "bound_by": "bytes" if a["bound_ms_bytes"] >= a["bound_ms_ops"]
            else "operations",
            "library_ms": None,
            "unit": f"one query_main step of {a['config']}: CUDA events "
                    f"around the kernels' launch call "
                    f"({a['launches_per_step']:g} launches)",
            "step_call_ms": a["step_call_ms_median"],
            "parity": "exact except f32 sums/avgs and stdDev (stated "
                      "tolerance)",
            "configs": {o["config"]: {k: o[k] for k in (
                "kernel_step_ms_median", "step_call_ms_median",
                "plain_step_ms_median", "launches", "checked_steps",
                "bound_ms_bytes", "bound_ms_ops", "max_abs_err",
                "table_passes_per_step", "bound_ms_ops_two_passes_per_event")
                if k in o} for o in outs},
        })
    return entries


# --------------------------------------------------- stream-stream joins

def join_shapes_module():
    """``tests/test_torch_join_shapes.py``: the join shapes, wire, refusals
    and exact comparison of the CPU tests (it imports the port only)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_join_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_join_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_join_shapes() -> None:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    from siddhi_tpu_torch.gpu.join_compile import (CompiledJoinQuery,
                                                   join_step_plain)
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    sh = join_shapes_module()
    t_phase = time.perf_counter()
    cases = []
    for name in sorted(sh.JOINS):
        cq = sh.compile_port(name, "cuda")
        state = cq.init_state()
        wire = sh.wire_for(name)
        rows = 0
        for step in range(sh.STEPS):
            args = cq.batch_tensors(wire.batch(step))
            ref_state, ref_out = join_step_plain(cq, state, *args)
            state, out = cq.plan.step_cuda(state, *args)
            torch.cuda.synchronize()
            try:
                sh.compare(state_to_numpy(ref_state), state_to_numpy(state),
                           sh.out_numpy(state_to_numpy(ref_out)),
                           sh.out_numpy(state_to_numpy(out)))
            except AssertionError as e:
                fail(f"join shape {name} step {step}: kernel differs from "
                     f"the plain version: {str(e)[:400]}")
            rows += int(out["count"])
        cases.append({"join": name, "B": cq.B, "W": cq.W, "J": cq.J,
                      "rows": rows, "join_drops": int(state["join_drops"]),
                      "ring_drops": int(state["ring_drops"])})

    def build(text, B, W, J):
        app = parse(text)
        return CompiledJoinQuery(app.queries[0], dict(app.stream_definitions),
                                 B, W, J, device="cuda")

    for text in sh.REFUSED:
        try:
            build(sh.REFUSAL_SCHEMA + text, *sh.REFUSAL_CAPS)
            fail(f"the card accepted a join the reference refuses: {text}")
        except (DeviceCompileError, TypeError):
            pass
    for text, B, W, J in sh.LIMITS:
        try:
            build(text, B, W, J)
            fail(f"the card accepted a join over the kernel's limits: {text}")
        except DeviceCompileError as e:
            if not str(e).startswith("join kernel: "):
                fail(f"a join over the kernel's limits refused as {e}")
    emit({"phase": "join_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "limits": len(sh.LIMITS), "max_abs_err": 0.0,
          "phase_s": time.perf_counter() - t_phase})


def join_step_bytes(state, new_state, cols, tag, ts, ts_base, out) -> int:
    """Bytes one step must move: the columns, tags and ts it reads, the old
    state it reads and the new state it writes, the J output rows."""
    def nb(ts_):
        return sum(t.numel() * t.element_size() for t in ts_)
    return nb((*cols.values(), tag, ts, ts_base)) + nb(state.values()) + \
        nb(new_state.values()) + nb((*out["out"].values(), *out["null"].values(),
                                     out["valid"], out["ts"], out["count"]))


INDEX_OPS = 8   # a candidate's key: hash (a multiply, a shift), histogram add,
                # scan share, ordered scatter (a match, a rank, a store)


def join_step_ops(cq, state, cols, tag, ts, ts_base, nvalid: int,
                  count: int) -> int:
    """Operations this step's data needs at the least: the condition's
    program and a window/within compare on every live candidate pair (a
    probe against the opposite side's entries alive at its time, in the ring
    and earlier in the batch) whose keys are equal where the plan has a key
    conjunct (a keyed index visits no other), INDEX_OPS for each candidate
    the index bins, and the output programs on every row written. Dead ring
    slots cost nothing here: a kernel can skip them by a binary search."""
    import torch
    from siddhi_tpu_torch.gpu.join_step import key_conjunct
    a = cq.plan.args
    B, W = cq.B, cq.W
    per_pair = (a.cond.len if a.has_cond else 0) + 2
    per_row = sum(a.outp[o].len for o in range(a.nout)) + 2
    t = ts_base + ts.to(torch.int64)
    ar = torch.arange(B, device=ts.device)
    valid = ar < nvalid
    emits = (bool(a.emit_left), bool(a.emit_right))
    keys = key_conjunct(cq.cond_ir)
    if keys is not None:                  # each side's key: ring leaf, column
        sides = ((cq.left_id, "lr"), (cq.right_id, "rr"))
        key = []
        for side, prog in enumerate(keys):
            attr = prog[0][2].split("_", 1)[1]
            sid, ring = sides[side]
            key.append((state[f"{ring}_{attr}"].to(torch.int64),
                        cols[cq.merged.col_key(sid, attr)].to(torch.int64)))
    live, binned = 0, 0
    w = torch.arange(W, device=ts.device)
    for side in (0, 1):
        other = 1 - side
        opp = valid & (tag == other)
        ring = state["lr_ts" if other == 0 else "rr_ts"]
        binned += int((ring > -(2 ** 62)).sum()) + int(opp.sum())
        if not emits[side]:
            continue
        probes = valid & (tag == side)
        before = (torch.cumsum(opp.to(torch.int64), 0) - opp.to(torch.int64))[probes]
        tp = t[probes]
        kind = a.lkind if other == 0 else a.rkind
        par = a.lparam if other == 0 else a.rparam
        if kind == 0:       # time: entries with ts + D > t
            ring_live = (ring > -(2 ** 62))[None, :] & (ring[None, :] + par > tp[:, None])
            batch_live = t[None, :] + par > tp[:, None]
        else:               # length: the N newest arrivals before the probe
            ring_live = (ring > -(2 ** 62))[None, :] & \
                ((W - 1 - w)[None, :] + before[:, None] < par)
            rank = torch.cumsum(opp.to(torch.int64), 0) - 1
            batch_live = before[:, None] - 1 - rank[None, :] < par
        batch_live &= opp[None, :] & (ar[None, :] < ar[probes][:, None])
        if keys is not None:
            kp = key[side][1][probes]
            ring_live &= key[other][0][None, :] == kp[:, None]
            batch_live &= key[other][1][None, :] == kp[:, None]
        live += int(ring_live.sum()) + int(batch_live.sum())
    index_ops = INDEX_OPS * binned if keys is not None else 0
    return live * per_pair + index_ops + count * per_row


def phase_join_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.join_compile import (DeviceJoinRuntime,
                                                   join_step_plain)
    from siddhi_tpu_torch.gpu.join_step import JoinPlan
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    from siddhi_tpu_torch.tools.join_workloads import (JOIN_MAIN, feed_join,
                                                       join_events,
                                                       reference_rows)
    sh = join_shapes_module()
    t_phase = time.perf_counter()
    cfg = dict(JOIN_MAIN[name])
    app = cfg.pop("app")
    B = cfg["batch_capacity"]
    ev = join_events(name, JOIN_EVENTS, seed)

    # warm-up: build, first launches
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    feed_join(rt, ev, 3 * B)
    torch.cuda.synchronize()

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # ---- timed run: the entry points alone; CUDA events around the step
    # call (the wrapper's host work included) and around the kernels'
    # launch call alone (``lib.join_step``)
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    cq = rt.compiler
    if not cq.plan.indexed:
        fail(f"join_main {name}: the plan found no key conjunct, so the "
             f"kernel walks every candidate instead of the key index")
    kstep = cq.step_tensors
    marks, kmarks, last = [], [], []

    def timed(*a):
        e0, e1 = event_pair()
        e0.record()
        got = kstep(*a)
        e1.record()
        marks.append((e0, e1))
        last[:] = a
        return got

    lib = cq.plan._lib()

    class TimedLib:
        def __getattr__(self, attr):
            if attr != "join_step":
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = lib.join_step(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    cq.plan._lib = lambda: timed_lib
    cq.step_tensors = timed
    torch.cuda.synchronize()
    JoinPlan.launches = 0                     # counts from here: main path
    t0 = time.perf_counter()
    rows, per_step = feed_join(rt, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = JoinPlan.launches
    steps = len(marks)
    per_launch = 5                   # j_prep, j_index, j_count, j_scan, j_emit
    if launches != per_launch * steps or launches == 0 or len(kmarks) != steps:
        fail(f"join_main {name}: {launches} join_step launches, "
             f"{len(kmarks)} kernel calls over {steps} steps")
    jd, rd = rt.drop_count, rt.ring_drop_count
    if jd or rd:
        fail(f"join_main {name}: {jd} join drops, {rd} ring drops")
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    call_ms = [a.elapsed_time(b) for a, b in marks]
    index = join_index_share(cq, last)

    # the first 2 steps' rows against a nested-loop join in numpy
    want = reference_rows(name, ev, 2 * B)
    n2 = sum(per_step[:2])
    if rows[:n2] != want:
        bad = next((i for i, (x, y) in enumerate(zip(rows[:n2], want))
                    if x != y), min(n2, len(want)))
        fail(f"join_main {name}: the first 2 steps give {n2} rows, numpy "
             f"{len(want)}; first difference at row {bad}")

    # ---- checked run: every step bitwise against the plain version on the
    # card, from the same state; the bound from each step's own inputs
    rt = DeviceJoinRuntime(app, device="cuda", **cfg)
    cq = rt.compiler
    kstep = cq.step_tensors
    plain_ms, bytes_, ops = [], [], []

    def checked(state, cols, tag, ts, ts_base, nvalid):
        e0, e1 = event_pair()
        e0.record()
        ref_state, ref_out = join_step_plain(cq, state, cols, tag, ts,
                                             ts_base, nvalid)
        e1.record()
        new, out = kstep(state, cols, tag, ts, ts_base, nvalid)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        try:
            sh.compare(state_to_numpy(ref_state), state_to_numpy(new),
                       sh.out_numpy(state_to_numpy(ref_out)),
                       sh.out_numpy(state_to_numpy(out)))
        except AssertionError as e:
            fail(f"join_main {name} step {len(plain_ms)}: kernel differs "
                 f"from the plain version: {str(e)[:400]}")
        bytes_.append(join_step_bytes(state, new, cols, tag, ts, ts_base, out))
        ops.append(join_step_ops(cq, state, cols, tag, ts, ts_base, nvalid,
                                 int(out["count"])))
        return new, out

    cq.step_tensors = checked
    rows2, _ = feed_join(rt, ev)
    if rows2 != rows:
        fail(f"join_main {name}: the checked run's rows differ from the "
             f"timed run's")
    b_ms = [b / HBM_BYTES_PER_S * 1e3 for b in bytes_]
    o_ms = [o / F32_OPS_PER_S * 1e3 for o in ops]
    out = {
        "phase": "join_main", "config": name, "kernel": "join_step",
        "events": JOIN_EVENTS, "steps": steps,
        "events_per_s": JOIN_EVENTS / wall, "wall_s": wall,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        "checked": "every step", "bitwise_equal_steps": len(plain_ms),
        "rows": len(rows), "rows_per_step_median": float(np.median(per_step)),
        "numpy_rows_checked": n2, "join_drops": jd, "ring_drops": rd,
        "bytes_per_step_median": float(np.median(bytes_)),
        "ops_per_step_median": float(np.median(ops)),
        "bound_ms_bytes": float(np.median(b_ms)),
        "bound_ms_ops": float(np.median(o_ms)),
        "max_abs_err": 0.0, "indexed": True, "index": index,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


def join_index_share(cq, args, steps: int = 20) -> dict:
    """Device time per kernel of ``steps`` repeats of one step (the last
    batch of the timed run, from its input state) under torch.profiler,
    and the key index's (``j_index``) share of the step's kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cq.plan.step_cuda(*args)
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        for k in ("j_prep", "j_index", "j_count", "j_scan", "j_emit"):
            if k in e.key and dev > 0:
                us[k] = us.get(k, 0.0) + dev / steps
    total = sum(us.values())
    if not total:
        return {"device_us_per_step": None, "share": None,
                "note": "not measured: the profiler saw no device time"}
    return {"device_us_per_step": us, "share": us.get("j_index", 0.0) / total}


JOIN_EVENTS = 2_000_000           # events per join_main configuration


def join_kernel_entry(j_outs: list) -> dict:
    """The ``kernels`` line's join entry: times and bound of (e), (f)
    beside it under ``configs``; launches over both main-path runs."""
    e = j_outs[0]
    return {
        "name": "join_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/join_step.cu",
        "replaces": "siddhi_tpu/tpu/join_compile.py:224",
        "also_replaces": ["siddhi_tpu/tpu/join_compile.py:474"],
        "launches": sum(o["launches"] for o in j_outs),
        "max_abs_err": 0.0,
        "ms": e["kernel_step_ms_median"],
        "plain_ms": e["plain_step_ms_median"],
        "bound_ms": max(e["bound_ms_bytes"], e["bound_ms_ops"]),
        "bound_by": "bytes" if e["bound_ms_bytes"] >= e["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": f"one join_main step of {e['config']}: CUDA events around "
                f"the kernels' launch call (5 launches: the key index's "
                f"included)",
        "step_call_ms": e["step_call_ms_median"],
        "parity": "exact",
        "configs": {o["config"]: {k: o[k] for k in (
            "kernel_step_ms_median", "step_call_ms_median",
            "plain_step_ms_median", "launches", "checked_steps",
            "bound_ms_bytes", "bound_ms_ops", "events_per_s", "rows",
            "index")}
            for o in j_outs},
    }


# ------------------------------------------------------------ aggregation

def agg_shapes_module():
    """``tests/test_torch_agg_shapes.py``: the aggregation shapes, wire,
    refusals and exact comparison of the CPU tests (it imports the port
    only)."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_agg_shapes.py")
    spec = importlib.util.spec_from_file_location("test_torch_agg_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_agg_shapes() -> None:
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.gpu.aggregation_compile import (
        CompiledAggregation, aggregation_step_plain)
    from siddhi_tpu_torch.gpu.expr_compile import DeviceCompileError
    sh = agg_shapes_module()
    t_phase = time.perf_counter()
    cases = []
    for name in sorted(sh.AGGS):
        ca = sh.compile_port(name, "cuda")
        wire = sh.wire_for(name)
        runs = 0
        for step in range(sh.STEPS):
            args = sh.step_inputs(ca, wire.batch(step))
            ref = aggregation_step_plain(ca, *args)
            got, _ = ca.plan.step_cuda(*args)
            torch.cuda.synchronize()
            same, _, bad = compare(ref, got)
            if not same:
                fail(f"aggregation shape {name} step {step}: kernel differs "
                     f"from the plain version at {bad}")
            runs += int(got["n_runs"].sum())
        cases.append({"agg": name, "B": ca.B, "D": ca.D, "partial_rows": runs})

    def build(text, B):
        d, sdef = sh.definition(parse, text)
        return CompiledAggregation(d, sdef, B, device="cuda")

    for text in sh.REFUSED:
        try:
            build(sh.SCHEMA + "define aggregation A " + text, sh.REFUSAL_B)
            fail(f"the card accepted a definition the reference refuses: {text}")
        except DeviceCompileError:
            pass
    for text, B in sh.LIMITS:
        try:
            build(text, B)
            fail(f"the card accepted a definition over the kernel's limits: "
                 f"{text[:80]}")
        except DeviceCompileError as e:
            if not str(e).startswith("aggregation kernel: "):
                fail(f"a definition over the kernel's limits refused as {e}")
    emit({"phase": "agg_shapes", "cases": cases, "refused": len(sh.REFUSED),
          "limits": len(sh.LIMITS), "max_abs_err": 0.0,
          "phase_s": time.perf_counter() - t_phase})


AGG_EVENTS = 1_000_000            # events per agg_main configuration


def agg_step_bytes(ca, cols, ts, buckets, valid) -> int:
    """Bytes one step must move: the columns it reads, the clock where a
    program reads it, the valid mask and the [D, B] slab once, and every
    output lane once."""
    nb = sum(t.numel() * t.element_size() for t in (*cols.values(), buckets,
                                                    valid))
    if ca.plan.ts_slot is not None:
        nb += ts.numel() * ts.element_size()
    return nb + ca.plan.out_bytes


def agg_step_ops(ca, n_accepted: int) -> int:
    """Operations this step's data needs at the least: a comparison sort of
    the B events per duration (B * ceil(log2 B) compares), one combine per
    accepted event, duration and accumulating lane (three for a stdDev lane:
    add, square, add), and the filter and argument programs once per
    event."""
    import math
    from siddhi_tpu_torch.gpu.aggregation_step import LANE
    a = ca.plan.args
    B, D = ca.B, ca.D
    combines = {LANE["int"]: 1, LANE["f64"]: 1, LANE["f64sq"]: 3,
                LANE["min"]: 1, LANE["max"]: 1}
    lanes = sum(combines.get(a.lane[k], 0) for k in range(a.S))
    progs = (a.filt.len if a.has_filter else 0) + \
        sum(a.prog[k].len for k in range(a.S))
    return D * B * max(1, math.ceil(math.log2(B))) + \
        D * n_accepted * lanes + B * progs


def phase_agg_main(name: str, seed: int) -> dict:
    import torch
    from siddhi_tpu_torch.gpu.aggregation_compile import aggregation_step_plain
    from siddhi_tpu_torch.gpu.aggregation_step import AggPlan
    from siddhi_tpu_torch.tools import agg_workloads as aw
    t_phase = time.perf_counter()
    ev = aw.agg_events(name, AGG_EVENTS, seed)
    want = aw.numpy_rollup(name, ev)

    def all_rows(rt):
        return {d.value: rt.rows_for(d) for d in rt.definition.durations}

    # warm-up: build, first launches
    rt = aw.build_runtime(name, device="cuda")
    aw.feed_columns(rt, ev, 3 * aw.BATCH)
    all_rows(rt)
    torch.cuda.synchronize()

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # ---- timed run: bulk staging (append_columns + _flush_device) and the
    # final reads; CUDA events around the step call (copies both ways and
    # the wrapper's host work included) and around the kernels' launch call
    # alone (``lib.aggregation_step``)
    rt = aw.build_runtime(name, device="cuda")
    ca = rt._dev
    kstep = ca.step
    marks, kmarks = [], []

    def timed(*a):
        e0, e1 = event_pair()
        e0.record()
        got = kstep(*a)
        e1.record()
        marks.append((e0, e1))
        return got

    lib = ca.plan._lib()

    class TimedLib:
        def __getattr__(self, attr):
            if attr != "aggregation_step":
                return getattr(lib, attr)

            def call(*a):
                e0, e1 = event_pair()
                e0.record()
                rc = lib.aggregation_step(*a)
                e1.record()
                kmarks.append((e0, e1))
                return rc
            return call

    timed_lib = TimedLib()
    ca.plan._lib = lambda: timed_lib
    ca.step = timed
    torch.cuda.synchronize()
    AggPlan.launches = 0                      # counts from here: main path
    t0 = time.perf_counter()
    aw.feed_columns(rt, ev)
    rows = all_rows(rt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = AggPlan.launches
    steps = len(marks)
    if launches != AggPlan.LAUNCHES * steps or launches == 0 or \
            len(kmarks) != steps:
        fail(f"agg_main {name}: {launches} aggregation_step launches, "
             f"{len(kmarks)} kernel calls over {steps} steps")
    step_ms = [a.elapsed_time(b) for a, b in kmarks]
    call_ms = [a.elapsed_time(b) for a, b in marks]

    # ---- checked run: every event through receive(); every step bitwise
    # against the plain version on the card, from the same tensors; the
    # bound from each step's own inputs
    rt2 = aw.build_runtime(name, device="cuda")
    ca2 = rt2._dev
    plain_ms, bytes_, ops, partial = [], [], [], []

    def checked(cols, ts, buckets, valid):
        args = ca2.tensors(cols, ts, buckets, valid)
        e0, e1 = event_pair()
        e0.record()
        ref = aggregation_step_plain(ca2, *args)
        e1.record()
        out, buf = ca2.plan.step_cuda(*args)
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
        same, _, bad = compare(ref, out)
        if not same:
            fail(f"agg_main {name} step {len(plain_ms)}: kernel differs from "
                 f"the plain version at {bad}")
        bytes_.append(agg_step_bytes(ca2, *args))
        ops.append(agg_step_ops(ca2, int(out["count"][0].sum())))
        partial.append(int(out["n_runs"].sum()))
        return ca2.plan.unpack(buf.cpu().numpy())

    ca2.step = checked
    t1 = time.perf_counter()
    aw.feed_events(rt2, ev)
    rows2 = all_rows(rt2)
    wall2 = time.perf_counter() - t1
    for d in rows:
        if sorted(rows2[d]) != sorted(rows[d]):
            fail(f"agg_main {name}: {d} rows of the receive() run differ from "
                 f"the bulk-staged run's")
    try:
        counts = aw.check_rows(name, rt2, want)
    except AssertionError as e:
        fail(f"agg_main {name}: rows differ from the numpy group-by: "
             f"{str(e)[:400]}")
    b_ms = [b / HBM_BYTES_PER_S * 1e3 for b in bytes_]
    o_ms = [o / F32_OPS_PER_S * 1e3 for o in ops]
    out = {
        "phase": "agg_main", "config": name, "kernel": "aggregation_step",
        "events": AGG_EVENTS, "steps": steps, "D": ca.D, "B": ca.B,
        "events_per_s": AGG_EVENTS / wall, "wall_s": wall,
        "receive_events_per_s": AGG_EVENTS / wall2,
        "launches": launches, "launches_per_step": launches / steps,
        "kernel_step_ms_median": float(np.median(step_ms)),
        "kernel_step_ms_min": float(np.min(step_ms)),
        "kernel_step_ms_max": float(np.max(step_ms)),
        "step_call_ms_median": float(np.median(call_ms)),
        "plain_step_ms_median": float(np.median(plain_ms)),
        "plain_device": "cuda", "checked_steps": len(plain_ms),
        "checked": "every step", "bitwise_equal_steps": len(plain_ms),
        "partial_rows_per_step_median": float(np.median(partial)),
        "rows_per_duration": counts, "numpy_groupby": "every row",
        "bytes_per_step_median": float(np.median(bytes_)),
        "ops_per_step_median": float(np.median(ops)),
        "bound_ms_bytes": float(np.median(b_ms)),
        "bound_ms_ops": float(np.median(o_ms)),
        "max_abs_err": 0.0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


def agg_kernel_entry(a_outs: list) -> dict:
    """The ``kernels`` line's aggregation entry: times and bound of (g),
    (h) beside it under ``configs``; launches over both main-path runs."""
    e = a_outs[0]
    return {
        "name": "aggregation_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/aggregation_step.cu",
        "replaces": "siddhi_tpu/tpu/aggregation_compile.py:129",
        "launches": sum(o["launches"] for o in a_outs),
        "max_abs_err": 0.0,
        "ms": e["kernel_step_ms_median"],
        "plain_ms": e["plain_step_ms_median"],
        "bound_ms": max(e["bound_ms_bytes"], e["bound_ms_ops"]),
        "bound_by": "bytes" if e["bound_ms_bytes"] >= e["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": f"one agg_main step of {e['config']}: CUDA events around "
                f"the kernels' launch call ({e['launches_per_step']:g} "
                f"launches)",
        "step_call_ms": e["step_call_ms_median"],
        "parity": "exact",
        "configs": {o["config"]: {k: o[k] for k in (
            "kernel_step_ms_median", "step_call_ms_median",
            "plain_step_ms_median", "launches", "checked_steps",
            "bound_ms_bytes", "bound_ms_ops", "events_per_s",
            "partial_rows_per_step_median")}
            for o in a_outs},
    }


# ----------------------------------------------------------------- engine

ENGINE_EVENTS = 500_000            # events per engine app
ENGINE_CPU_STEPS = {"scan": 1}     # micro-batches the CPU engine checks (2)
ENGINE_ASYNC = ("chain", "grouped_length")
ENGINE_SNAPSHOT = "time_batch"       # an open bucket across the cut


def engine_kernels() -> dict:
    """Engine app → (the ``kernels`` line's entry, its plan class)."""
    from siddhi_tpu_torch.gpu.aggregation_step import AggPlan
    from siddhi_tpu_torch.gpu.join_step import JoinPlan
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.nfa_scan import ScanPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.gpu.query_walk import WalkPlan
    return {"chain": ("nfa_block", BlockPlan),
            "scan": ("nfa_scan_step", ScanPlan),
            "grouped_length": ("query_step", QueryPlan),
            "time_batch": ("query_step_tumbling", QueryPlan),
            "lossy_frequent": ("query_walk", WalkPlan),
            "market_join": ("join_step", JoinPlan),
            "trade_rollup": ("aggregation_step", AggPlan)}


def reset_launches() -> None:
    for _, plan in engine_kernels().values():
        plan.launches = 0


def read_launches() -> dict:
    return {plan.__name__: plan.launches
            for _, plan in engine_kernels().values()}


class ErrorRecords:
    """Every ERROR record of the port's loggers (``siddhi_tpu_torch.*``:
    the device driver's failed steps, the junctions' failed receivers)
    while attached."""

    def __init__(self):
        import logging
        self.records = []
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                outer.records.append(f"{record.name}: {record.getMessage()}")

        self.handler = _H(level=logging.ERROR)
        logging.getLogger("siddhi_tpu_torch").addHandler(self.handler)

    def check(self, where: str) -> None:
        if self.records:
            fail(f"engine {where}: ERROR records: {self.records[:3]}")

    def close(self) -> None:
        import logging
        logging.getLogger("siddhi_tpu_torch").removeHandler(self.handler)


class GuardAudit:
    """The device guards of every runtime the port's engines build while
    open (each through ``SiddhiManager.create_siddhi_app_runtime``,
    ``recover``'s included). A phase that injects no fault must leave
    every ``@device`` bridge guarded (the default) and every guard at 0
    failures, 0 fallback and 0 lost events, its circuit CLOSED: otherwise
    a kernel that faulted there would have been replayed on the host
    interpreter, and its rows would pass. Each guard's ``report()`` is read
    when its runtime shuts down and, for a runtime still alive, at
    ``check``; a failure or a replay is also recorded as it happens, for a
    runtime dropped without a shutdown. Runtimes are held weakly: holding
    every run's rows to the phase's end would grow the heap that the
    collector walks in the later runs."""

    def __init__(self):
        import weakref
        from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime
        from siddhi_tpu_torch.core.manager import SiddhiManager
        from siddhi_tpu_torch.resilience.device_guard import DeviceGuard
        self.runtimes = []              # weak references
        self.reports = {}               # id(runtime) → (app, reports)
        self.events = []                # (site, what) of every fallback
        self._undo = []
        audit = self

        def patch(cls, name, make):
            orig = getattr(cls, name)
            setattr(cls, name, make(orig))
            self._undo.append((cls, name, orig))

        def create(orig):
            def audited_create(manager, *a, **k):
                rt = orig(manager, *a, **k)
                for b in rt.device_bridges:
                    if b.guard is None or b.guard not in rt.resilience.guards:
                        fail(f"device query '{b.query_name}' of app "
                             f"'{rt.name}' has no guard")
                audit.runtimes.append(weakref.ref(rt))
                return rt
            return audited_create

        def shutdown(orig):
            def audited_shutdown(rt, *a, **k):
                out = orig(rt, *a, **k)
                audit.read(rt)
                return out
            return audited_shutdown

        def recorded(what):
            def make(orig):
                def rec(guard, *a, **k):
                    audit.events.append((guard._site, what))
                    return orig(guard, *a, **k)
                return rec
            return make

        patch(SiddhiManager, "create_siddhi_app_runtime", create)
        patch(SiddhiAppRuntime, "shutdown", shutdown)
        patch(DeviceGuard, "_record_failure", recorded("step failed"))
        patch(DeviceGuard, "_host_fallback", recorded("host replay"))

    def read(self, rt) -> None:
        self.reports[id(rt)] = (rt.name, [g.report()
                                          for g in rt.resilience.guards])

    def close(self) -> None:
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)

    def check(self, where: str) -> dict:
        from siddhi_tpu_torch.resilience import CircuitState
        for ref in self.runtimes:
            rt = ref()
            if rt is not None:
                self.read(rt)
        n = 0
        for app, reports in self.reports.values():
            for r in reports:
                n += 1
                if r["failures"] or r["fallback_events"] \
                        or r["lost_events"] \
                        or r["circuit"] != CircuitState.CLOSED:
                    fail(f"{where}: app '{app}': a device guard fell back "
                         f"to the host: {json.dumps(r)}")
        if self.events:
            fail(f"{where}: device guards fell back to the host: "
                 f"{self.events[:5]}")
        return {"phase": f"{where}_guards", "runtimes": len(self.runtimes),
                "guards": n, "failures": 0, "fallback_events": 0,
                "lost_events": 0, "circuits": "closed"}


def audited(where: str, phase, *args, **kwargs):
    """``phase(*args, **kwargs)`` under a ``GuardAudit``, checked at its
    end (the check's line follows the phase's)."""
    audit = GuardAudit()
    try:
        out = phase(*args, **kwargs)
    finally:
        audit.close()
    emit(audit.check(where))
    return out


def to_numpy(tree):
    import torch
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def np_diff(a, b, at: str = "") -> str:
    """The first leaf where two numpy trees differ ('' when bitwise equal,
    NaN equal to NaN)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                a.keys() != b.keys():
            return at or "<root>"
        for k in sorted(a):
            d = np_diff(a[k], b[k], f"{at}{k}.")
            if d:
                return d
        return ""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return at
    same = np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    return "" if same else at


class StepProbe:
    """Wraps one runtime's step calls (engine bridge or direct alike, at its
    compiled plan): CUDA events around each ``step`` (the batch's copy to
    the card and the wrapper's host work included), host seconds of
    ``step`` and ``decode_outputs``, and the state and outputs after each
    of the first ``keep`` steps. For an aggregation (``agg``) the step call
    is ``CompiledAggregation.step`` and the kept state is
    ``snapshot_state()`` after each micro-batch."""

    def __init__(self, rt, keep: int = 0, agg: bool = False):
        import pickle
        import torch
        self.marks, self.kept, self.rows_kept = [], [], 0
        self.steps = self.decodes = 0
        self.step_s = self.decode_s = 0.0
        comp = rt._dev if agg else plan_of(rt)
        step = comp.step

        def timed_step(*a):
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            got = step(*a)
            e1.record()
            self.marks.append((e0, e1))
            self.step_s += time.perf_counter() - t0
            if not agg:
                self.steps += 1
                if self.steps <= keep:
                    self.kept.append({"state": to_numpy(got[0]),
                                      "out": to_numpy(got[1])})
            return got

        comp.step = timed_step
        if agg:
            flush = rt._flush_device

            def counted_flush():
                n = len(rt._dev_builder)
                flush()
                if n:
                    self.steps += 1
                    if self.steps <= keep:
                        self.kept.append(pickle.loads(pickle.dumps(
                            rt.snapshot_state())))

            rt._flush_device = counted_flush
            return
        decode = comp.decode_outputs

        def timed_decode(out):
            t0 = time.perf_counter()
            rows = decode(out)
            self.decode_s += time.perf_counter() - t0
            self.decodes += 1
            if self.decodes <= keep:
                self.rows_kept += len(rows)
            return rows

        comp.decode_outputs = timed_decode

    def step_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.marks]


def plan_of(rt):
    """A device runtime's compiled plan (``compiler`` of the NFA and join
    runtimes, ``compiled`` of the query runtime and the bridge's own)."""
    return getattr(rt, "compiler", None) or rt.compiled


def engine_runtime(manager, cfg: dict):
    """A started playback runtime of ``cfg``'s app whose output rows collect
    in ``rt.got`` as ``(timestamp, data)``; the runtime ``StepProbe``
    wraps (the bridge's or the aggregation's)."""
    from siddhi_tpu_torch import StreamCallback
    rt = manager.create_siddhi_app_runtime(cfg["app"], playback=True)
    rt.got = []
    if cfg["out"] is not None:
        rt.add_callback(cfg["out"], StreamCallback(lambda evs: rt.got.extend(
            (e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    target = rt.ctx.aggregations[cfg["agg"]] if cfg["kind"] == "agg" \
        else rt.device_bridges[0].runtime
    return rt, target


def engine_state(cfg: dict, target):
    """The final state: the device state tree (numpy), or the aggregation's
    bucket stores."""
    if cfg["kind"] == "agg":
        return target.snapshot_state()
    return to_numpy(target.state)


def agg_reads(name: str, rt=None, drt=None) -> list:
    """The aggregation's rows per duration: through ``rt.query`` on the
    engine, ``on_demand_find`` on the direct runtime."""
    from siddhi_tpu_torch.compiler import parse_on_demand_query
    from siddhi_tpu_torch.tools import engine_workloads as ew
    agg = drt if drt is not None else \
        next(iter(rt.ctx.aggregations.values()))
    attrs = agg.output_definition.attribute_names
    attrs = [a for a in attrs if a != "AGG_TIMESTAMP"]
    out = []
    for text in ew.on_demand_texts(name, attrs):
        evs = rt.query(text) if rt is not None else \
            drt.on_demand_find(parse_on_demand_query(text), 0)
        out.append([list(e.data) for e in evs])
    return out


def close_rows(sh, q, sc, ref: list, got: list, tag: str) -> None:
    """``(ts, data)`` rows: ts exact and in order, each column held to its
    query tolerance (``tests/test_torch_query_shapes.py``)."""
    if [t for t, _ in ref] != [t for t, _ in got]:
        fail(f"{tag}: {len(ref)} / {len(got)} rows, timestamps differ")
    if not ref:
        return
    kinds = sh.tolerance_kinds(q)
    cnt = next((i for i, s in enumerate(q.specs) if s.kind == "count"), None)
    counts = None if cnt is None else np.array([r[cnt] for _, r in ref])
    for i, s in enumerate(q.specs):
        a = np.array([r[i] for _, r in ref])
        b = np.array([r[i] for _, r in got])
        try:
            sh.check_close(s.name, a, b, kinds[s.name], sc, counts)
        except AssertionError as e:
            fail(f"{tag}: column {s.name}: {str(e)[:300]}")


def engine_cpu_prefix(name: str, cfg: dict, ev, card: StepProbe,
                      card_rows: list, k: int) -> dict:
    """A second engine on the CPU (the plain versions), fed the first ``k``
    micro-batches: its rows and state equal the card engine's at that
    point (exactly; the query apps' float32 sums within their tolerances)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    m = SiddhiManager(device="cpu")
    rt, target = engine_runtime(m, cfg)
    probe = StepProbe(target, keep=k, agg=cfg["kind"] == "agg")
    scales = []
    if cfg["kind"] == "query":
        sh = query_shapes_module()
        q = plan_of(target)
        step, sc = q.step_tensors, [sh.Scale()]

        def scaled(state, cols, ts, valid):
            sc[0] = sh.next_scale(q, sc[0], state, cols, ts, valid)
            scales.append(sc[0])
            return step(state, cols, ts, valid)

        q.step_tensors = scaled
    t0 = time.perf_counter()
    ew.feed_engine(rt, ev, 0, k * cfg["batch"])
    cpu_s = time.perf_counter() - t0
    if probe.steps != k or len(card.kept) != k:
        fail(f"engine {name}: the CPU engine took {probe.steps} steps, the "
             f"card kept {len(card.kept)} (expected {k})")
    tag = f"engine {name} (CPU engine, first {k} micro-batches)"
    if cfg["kind"] == "agg":
        if probe.kept != card.kept:
            fail(f"{tag}: bucket stores differ")
    elif cfg["kind"] == "query":
        for j in range(k):
            c, p = card.kept[j], probe.kept[j]
            try:
                sh.compare(q, scales[j], c["state"], p["state"], c["out"],
                           p["out"])
            except AssertionError as e:
                fail(f"{tag}: step {j}: {str(e)[:300]}")
        close_rows(sh, q, scales[-1], card_rows[:card.rows_kept], rt.got,
                   tag)
    else:
        for j in range(k):
            d = np_diff(card.kept[j]["state"], probe.kept[j]["state"])
            if d:
                fail(f"{tag}: step {j}: state differs at {d}")
        if rt.got != card_rows[:card.rows_kept]:
            fail(f"{tag}: rows differ ({len(rt.got)} / {card.rows_kept})")
    m.shutdown()
    return {"steps": k, "events": k * cfg["batch"],
            "rows": card.rows_kept, "cpu_s": cpu_s}


def engine_run(name: str, cfg: dict, ev, records: ErrorRecords,
               keep: int = 0, app: str | None = None):
    """One engine run of every event on the card: the rows, the final state,
    the probe, the wall, the launches, the rows the shutdown added and
    the runtime."""
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    cfg = dict(cfg, app=app or cfg["app"])
    m = SiddhiManager()
    rt, target = engine_runtime(m, cfg)
    card = "cuda" if torch.cuda.is_available() else "cpu"
    if rt.ctx.siddhi_context.device.type != card:
        fail(f"engine {name}: SiddhiManager() chose "
             f"{rt.ctx.siddhi_context.device}")
    probe = StepProbe(target, keep=keep, agg=cfg["kind"] == "agg")
    torch.cuda.synchronize()
    reset_launches()                  # counts from here: the engine path
    t0 = time.perf_counter()
    ew.feed_engine(rt, ev)
    rt.flush_device()
    if cfg["kind"] == "agg":
        target._flush_device()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rows = list(rt.got)
    reads = agg_reads(name, rt=rt) if cfg["kind"] == "agg" else None
    state = engine_state(cfg, target)
    driver = rt.device_bridges[0].driver if rt.device_bridges else None
    stepped = driver.batches_stepped if driver is not None else probe.steps
    calls, step_s, decode_s = probe.steps, probe.step_s, probe.decode_s
    errors = sum(j.receiver_errors for j in rt.ctx.stream_junctions.values())
    m.shutdown()                    # timeBatch: the sentinel's step
    records.check(name)
    if errors:
        fail(f"engine {name}: {errors} receiver errors")
    expected = -(-ev.n // cfg["batch"])
    if stepped != expected or calls != expected:
        fail(f"engine {name}: {stepped} micro-batches stepped "
             f"({calls} step calls), expected {expected}")
    return dict(rows=rows, reads=reads, state=state, probe=probe, wall=wall,
                launches=launches, steps=calls, step_s=step_s,
                decode_s=decode_s, shutdown_rows=len(rt.got) - len(rows),
                driver=driver, rt=rt)


def engine_app(name: str, seed: int, n_events: int, records: ErrorRecords,
               standalone: dict) -> dict:
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    kname, plan = engine_kernels()[name]
    cfg = ew.engine_config(name)
    B = cfg["batch"]
    k = ENGINE_CPU_STEPS.get(name, 2)
    ev = ew.EngineEvents(name, n_events, seed)
    t_phase = time.perf_counter()

    # warm-up: build, first launches (untimed)
    m = SiddhiManager()
    rt, _ = engine_runtime(m, cfg)
    ew.feed_engine(rt, ev, 0, 2 * B)
    rt.flush_device()
    m.shutdown()
    torch.cuda.synchronize()

    # ---- the engine run
    run = engine_run(name, cfg, ev, records, keep=k)
    probe, launches = run["probe"], run["launches"]
    if launches[plan.__name__] == 0 or any(
            n for c, n in launches.items() if c != plan.__name__):
        fail(f"engine {name}: launches {launches}: {plan.__name__} must "
             f"launch, no other kernel")

    # ---- the same runtime class driven directly with the same events
    drt = ew.direct_runtime(name, device="cuda")
    dprobe = StepProbe(drt, agg=cfg["kind"] == "agg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drows = ew.feed_direct(drt, ev, name)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    if cfg["kind"] == "agg":
        if run["reads"] != agg_reads(name, drt=drt):
            fail(f"engine {name}: rt.query rows differ from the direct "
                 f"runtime's")
    elif [r for _, r in run["rows"]] != drows:
        fail(f"engine {name}: {len(run['rows'])} rows, the direct runtime "
             f"{len(drows)}: they differ")
    if cfg["kind"] == "agg":
        if engine_state(cfg, drt) != run["state"]:
            fail(f"engine {name}: the bucket stores differ from the direct "
                 f"runtime's")
    else:
        d = np_diff(run["state"], engine_state(cfg, drt))
        if d:
            fail(f"engine {name}: final state differs from the direct "
                 f"runtime's at {d}")
    if dprobe.steps != run["steps"]:
        fail(f"engine {name}: {run['steps']} steps, direct {dprobe.steps}")

    # ---- the CPU engine on the first micro-batches
    cpu = engine_cpu_prefix(name, cfg, ev, probe, run["rows"], k)

    step_ms = probe.step_ms()[:run["steps"]]      # not the sentinel's
    dstep_ms = dprobe.step_ms()
    inside = run["step_s"] + run["decode_s"]
    out = {
        "phase": "engine", "app": name, "kernel": kname,
        "events": ev.n, "batch": B, "steps": run["steps"],
        "events_per_s": ev.n / run["wall"], "wall_s": run["wall"],
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_min": float(np.min(step_ms)),
        "step_ms_max": float(np.max(step_ms)),
        "step_call_s": run["step_s"], "decode_s": run["decode_s"],
        "outside_step_calls_share": 1.0 - inside / run["wall"],
        "direct_events_per_s": ev.n / dwall, "direct_wall_s": dwall,
        "direct_step_ms_median": float(np.median(dstep_ms)),
        "direct_outside_step_calls_share":
            1.0 - (dprobe.step_s + dprobe.decode_s) / dwall,
        "standalone": standalone.get(name),
        "launches": launches[plan.__name__],
        "launches_per_step": launches[plan.__name__] / run["steps"],
        "rows": len(run["rows"]), "shutdown_rows": run["shutdown_rows"],
        "agg_rows_per_duration": [len(r) for r in run["reads"]]
        if run["reads"] is not None else None,
        "equal_to_direct": True, "cpu_engine": cpu,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    out["_run"], out["_ev"], out["_cfg"] = run, ev, cfg
    return out


def engine_async(name: str, base: dict, records: ErrorRecords) -> dict:
    """The app once more with ``async='true'``: rows (timestamps included)
    and final state equal to the synchronous engine run's."""
    cfg, ev, run = base["_cfg"], base["_ev"], base["_run"]
    app = cfg["app"].replace("strict='true'", "strict='true', async='true'")
    got = engine_run(name, cfg, ev, records, app=app)
    if got["driver"] is None or got["driver"].window != 2:
        fail(f"engine {name}: async run without a double-buffered driver")
    if got["rows"] != run["rows"]:
        fail(f"engine {name}: async rows differ from the synchronous run's "
             f"({len(got['rows'])} / {len(run['rows'])})")
    d = np_diff(run["state"], got["state"])
    if d:
        fail(f"engine {name}: async final state differs at {d}")
    return {"app": name, "events_per_s": ev.n / got["wall"],
            "batches_stepped": got["driver"].batches_stepped,
            "step_ms_median": float(np.median(got["probe"].step_ms())),
            "rows": len(got["rows"]), "equal_to_sync": True}


def engine_snapshot(name: str, base: dict, records: ErrorRecords) -> dict:
    """One mid-stream ``snapshot`` → ``restore`` into a fresh engine, cut at
    a micro-batch boundary: rows and final state equal to the
    uninterrupted run's."""
    import pickle
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    cfg, ev, run = base["_cfg"], base["_ev"], base["_run"]
    cut = ev.n // 2 // ew.COLUMN_CHUNK * ew.COLUMN_CHUNK
    m1 = SiddhiManager()
    rt1, _ = engine_runtime(m1, cfg)
    ew.feed_engine(rt1, ev, 0, cut)
    t0 = time.perf_counter()
    blob = rt1.snapshot()
    snap_s = time.perf_counter() - t0
    rows = list(rt1.got)            # not what shutdown adds after the cut
    m1.shutdown()
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            leaves.append(x)

    walk(pickle.loads(blob))
    if any(isinstance(x, torch.Tensor) for x in leaves):
        fail(f"engine {name}: the snapshot blob holds a torch.Tensor")
    m2 = SiddhiManager()
    rt2, target = engine_runtime(m2, cfg)
    t0 = time.perf_counter()
    rt2.restore(blob)
    restore_s = time.perf_counter() - t0
    ew.feed_engine(rt2, ev, cut)
    rt2.flush_device()
    state = engine_state(cfg, target)
    rows += rt2.got
    m2.shutdown()
    records.check(f"{name} snapshot")
    if rows != run["rows"]:
        fail(f"engine {name}: the resumed run's rows differ from the "
             f"uninterrupted run's")
    d = np_diff(run["state"], state)
    if d:
        fail(f"engine {name}: the resumed run's final state differs at {d}")
    return {"app": name, "cut": cut, "blob_bytes": len(blob),
            "snapshot_s": snap_s, "restore_s": restore_s,
            "equal_to_uninterrupted": True}


def phase_engine(seed: int, n_events: int, standalone: dict) -> dict:
    """Every device path through the engine (``engine_workloads``)."""
    from siddhi_tpu_torch.tools import engine_workloads as ew
    records = ErrorRecords()
    try:
        t0 = time.perf_counter()
        apps = {name: engine_app(name, seed, n_events, records, standalone)
                for name in ew.ENGINE_APPS}
        asyncs = [engine_async(n, apps[n], records) for n in ENGINE_ASYNC]
        snap = engine_snapshot(ENGINE_SNAPSHOT, apps[ENGINE_SNAPSHOT],
                               records)
        records.check("phase")
    finally:
        records.close()
    out = {"phase": "engine_checks", "async": asyncs, "snapshot": snap,
           "error_records": 0, "phase_s": time.perf_counter() - t0}
    emit(out)
    launches = {}
    for name, o in apps.items():
        kname = engine_kernels()[name][0]
        launches[kname] = launches.get(kname, 0) + o["launches"]
    return {"apps": {n: {k: v for k, v in o.items() if not k.startswith("_")}
                     for n, o in apps.items()}, "launches": launches}


# ------------------------------------------------------------ engine_host

ENGINE_HOST_EVENTS = 262_144       # iot_mixed events


def host_engine_run(manager, app: str, ev, card: bool, hook=None) -> dict:
    """One run of ``iot_mixed`` on ``manager``: the rows of every output
    stream, the runtime, the wall, and on the card the step probes of the
    two device queries; on the CPU the stats query's tolerance scale
    (``next_scale`` over its steps, as ``engine_cpu_prefix`` keeps it).
    ``hook(rt)``, called before the feed, gives the result's ``hook``."""
    import torch
    from siddhi_tpu_torch import StreamCallback
    from siddhi_tpu_torch.tools import engine_workloads as ew
    rt = manager.create_siddhi_app_runtime(app, playback=True)
    got = ew.collect_outputs(rt, StreamCallback)
    rt.start()
    by_name = {b.query_name: b for b in rt.device_bridges}
    probes, scales = {}, []
    if card:
        probes = {n: StepProbe(b.runtime) for n, b in by_name.items()}
    elif "stats" in by_name:
        sh = query_shapes_module()
        q = plan_of(by_name["stats"].runtime)
        step, sc = q.step_tensors, [sh.Scale()]

        def scaled(state, cols, ts, valid):
            sc[0] = sh.next_scale(q, sc[0], state, cols, ts, valid)
            return step(state, cols, ts, valid)

        q.step_tensors = scaled
        scales = sc
    hooked = hook(rt) if hook is not None else None
    if card:
        torch.cuda.synchronize()
        reset_launches()              # counts from here: the engine path
    t0 = time.perf_counter()
    ew.feed_iot(rt, ev)
    # columnar host queries (@app:host_batch) feed device queries and read
    # their outputs: drain them on both sides of the device flush
    rt.flush_host()
    rt.flush_device()
    rt.flush_host()
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches() if card else None
    errors = sum(j.receiver_errors for j in rt.ctx.stream_junctions.values())
    manager.shutdown()
    return dict(rows=got, rt=rt, wall=wall, probes=probes,
                scale=scales[0] if scales else None, launches=launches,
                errors=errors, hook=hooked)


def phase_engine_host(seed: int, n_events: int) -> dict:
    """``iot_mixed`` through the card engine and the CPU engine."""
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    t_phase = time.perf_counter()
    app = ew.iot_mixed_app()
    ev = ew.IotEvents(n_events, seed)
    records = ErrorRecords()
    try:
        # warm-up: the kernels' first launches (untimed)
        m = SiddhiManager()
        rt = m.create_siddhi_app_runtime(app, playback=True)
        rt.start()
        ew.feed_iot(rt, ev, 0, 8192)
        rt.flush_device()
        m.shutdown()
        torch.cuda.synchronize()

        card = host_engine_run(SiddhiManager(), app, ev, card=True)
        cpu = host_engine_run(SiddhiManager(device="cpu"), app, ev,
                              card=False)
        records.check("engine_host")
    finally:
        records.close()
    crt = card["rt"]
    bridged = sorted(b.query_name for b in crt.device_bridges)
    if bridged != ["chain", "stats"] or sorted(
            b.query_name for b in cpu["rt"].device_bridges) != bridged:
        fail(f"engine_host: device bridges {bridged}, expected chain, stats")
    for b in crt.device_bridges:
        if b.runtime.device.type != "cuda":
            fail(f"engine_host: '{b.query_name}' runs on {b.runtime.device}")
    if sorted(crt.query_runtimes) != ["alert_rate", "clean", "top"]:
        fail(f"engine_host: interpreter queries {sorted(crt.query_runtimes)}")
    inner = [q.name() for p in crt.partition_runtimes
             for q in p.partition_ast.queries]
    if inner != ["room_peak"]:
        fail(f"engine_host: partition queries {inner}")
    launches = card["launches"]
    if launches[BlockPlan.__name__] == 0 or launches[QueryPlan.__name__] == 0 \
            or any(n for c, n in launches.items()
                   if c not in (BlockPlan.__name__, QueryPlan.__name__)):
        fail(f"engine_host: launches {launches}: nfa_block and query_step "
             f"must launch, no other kernel")
    if card["errors"] or cpu["errors"]:
        fail(f"engine_host: receiver errors {card['errors']} (card), "
             f"{cpu['errors']} (CPU)")
    for s in ("Alerts", "AlertRate", "Top", "RoomPeak"):
        if card["rows"][s] != cpu["rows"][s]:
            fail(f"engine_host: {s}: {len(card['rows'][s])} rows on the card, "
                 f"{len(cpu['rows'][s])} on the CPU: they differ")
    q = plan_of(next(b for b in crt.device_bridges
                     if b.query_name == "stats").runtime)
    close_rows(query_shapes_module(), q, cpu["scale"], cpu["rows"]["Stats"],
               card["rows"]["Stats"], "engine_host Stats (card vs CPU)")
    steps = {n: p.steps for n, p in card["probes"].items()}
    step_ms = {n: p.step_ms() for n, p in card["probes"].items()}
    inside = sum(p.step_s + p.decode_s for p in card["probes"].values())
    cuda_s = sum(sum(v) for v in step_ms.values()) / 1e3
    out = {
        "phase": "engine_host", "app": "iot_mixed", "events": ev.n,
        "events_per_s": ev.n / card["wall"], "wall_s": card["wall"],
        "cpu_events_per_s": ev.n / cpu["wall"], "cpu_wall_s": cpu["wall"],
        "steps": steps,
        "step_ms_median": {n: float(np.median(v)) for n, v in step_ms.items()},
        "step_calls_share_cuda": cuda_s / card["wall"],
        "inside_step_calls_share": inside / card["wall"],
        "launches": {"nfa_block": launches[BlockPlan.__name__],
                     "query_step": launches[QueryPlan.__name__]},
        "rows": {s: len(r) for s, r in card["rows"].items()},
        "bridges": bridged, "equal_to_cpu_engine": True,
        "error_records": 0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# ------------------------------------------------------------ engine_io

IO_PERSIST_AT = 98_304             # 24 chunks of 4,096 (48 chain batches)
IO_KILL_AT = 196_608               # 48 chunks
IO_IDLE_S = 30.0                   # the longest wait for a deadline flush
IO_EDGE_WARM = 16_384              # the edge's warm-up events


def io_scratch() -> str:
    """A directory for the phase's WAL, revisions and CSV file, inside the
    checkout (``siddhi_tpu_torch/_build/`` is git-ignored)."""
    import tempfile
    base = os.path.join(REPO, "siddhi_tpu_torch", "_build")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="engine_io-", dir=base)


def durable_runtime(manager, wal: str, tag: str, store: str | None = None,
                    widths: dict | None = None):
    """A started ``iot_durable`` runtime on ``manager`` (``widths``:
    ``iot_durable_app``'s, its full widths by default): its sink payloads
    and the time window's rows collect in the returned dict."""
    from siddhi_tpu_torch import InMemoryBroker, StreamCallback
    from siddhi_tpu_torch.core import FileSystemPersistenceStore
    from siddhi_tpu_torch.tools import engine_workloads as ew
    if store is not None:
        manager.set_persistence_store(FileSystemPersistenceStore(store))
    rt = manager.create_siddhi_app_runtime(
        ew.iot_durable_app(wal, tag, **(widths or {})), playback=True)
    got, unsubs = ew.collect_sinks(InMemoryBroker, tag)
    got["AlertRate"] = []
    rt.add_callback("AlertRate", StreamCallback(
        lambda evs: got["AlertRate"].extend(
            (e.timestamp, list(e.data)) for e in evs)))
    rt.start()
    return rt, got, unsubs


def publish_iot(ev, tag: str, lo: int, hi: int) -> None:
    from siddhi_tpu_torch import InMemoryBroker
    from siddhi_tpu_torch.tools import engine_workloads as ew
    for ch in ew.iot_chunks(ev, lo, hi):
        InMemoryBroker.publish(f"iot-raw-{tag}", ch)


def flow_losses(rt) -> int:
    st = rt.flow.streams["Raw"].stats
    return st.shed + st.dropped_oldest


def io_straight(manager, ev, scratch: str, tag: str, card: bool,
                widths: dict | None = None) -> dict:
    """``iot_durable`` straight through: the outputs, the wall, the losses
    and, on the CPU, the stats query's tolerance scale (``next_scale``)."""
    import torch
    rt, got, unsubs = durable_runtime(manager, os.path.join(scratch, tag),
                                      tag, widths=widths)
    scales = []
    if not card:
        sh = query_shapes_module()
        b = next(b for b in rt.device_bridges if b.query_name == "stats")
        q = plan_of(b.runtime)
        step, sc = q.step_tensors, [sh.Scale()]

        def scaled(state, cols, ts, valid):
            sc[0] = sh.next_scale(q, sc[0], state, cols, ts, valid)
            return step(state, cols, ts, valid)

        q.step_tensors = scaled
        scales = sc
    t0 = time.perf_counter()
    publish_iot(ev, tag, 0, ev.n)
    rt.flush_device()
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for u in unsubs:
        u()
    out = dict(rows=got, wall=wall, losses=flow_losses(rt), rt=rt,
               scale=scales[0] if scales else None,
               bridged=sorted(b.query_name for b in rt.device_bridges))
    manager.shutdown()
    return out


def io_crash_recover(ev, scratch: str, widths: dict | None = None,
                     persist_at: int = IO_PERSIST_AT,
                     kill_at: int = IO_KILL_AT) -> dict:
    """``iot_durable`` on the card: persist at ``persist_at``, abandoned at
    ``kill_at``, recovered in a fresh runtime, fed the rest."""
    import torch
    from siddhi_tpu_torch import SiddhiManager, recover
    wal, store = os.path.join(scratch, "crash-wal"), \
        os.path.join(scratch, "crash-store")
    m1 = SiddhiManager()
    rt1, got1, unsubs1 = durable_runtime(m1, wal, "crash1", store, widths)
    publish_iot(ev, "crash1", 0, persist_at)
    wal1 = rt1.flow.streams["Raw"].wal
    wal_before = wal1.wal_bytes
    t0 = time.perf_counter()
    rt1.persist()
    persist_s = time.perf_counter() - t0
    wal_after = wal1.wal_bytes
    at_persist = {s: len(r) for s, r in got1.items()}
    publish_iot(ev, "crash1", persist_at, kill_at)
    torch.cuda.synchronize()
    losses = flow_losses(rt1)
    for u in unsubs1:           # the crash: rt1 is abandoned, not shut down
        u()
    m2 = SiddhiManager()
    rt2, got2, unsubs2 = durable_runtime(m2, wal, "crash2", store, widths)
    replay = rt2.flow.replay
    replay_s = [0.0]

    def timed_replay():
        t = time.perf_counter()
        try:
            return replay()
        finally:
            replay_s[0] = time.perf_counter() - t

    rt2.flow.replay = timed_replay
    t0 = time.perf_counter()
    report = recover(rt2)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    publish_iot(ev, "crash2", kill_at, ev.n)
    rt2.flush_device()
    torch.cuda.synchronize()
    for u in unsubs2:
        u()
    losses += flow_losses(rt2)
    m2.shutdown()
    m1.shutdown()               # releases the abandoned runtime
    stitched = {s: got1[s][:at_persist[s]] + got2[s] for s in got2}
    return dict(rows=stitched, report=report, persist_s=persist_s,
                recover_s=recover_s, replay_s=replay_s[0],
                wal_before=wal_before, wal_after=wal_after, losses=losses,
                at_persist=at_persist)


class StallTrace:
    """Where the wall of an async device step goes: each ``dispatch`` and
    ``collect`` of the runtime (the worker thread; their sum is the latency
    the adaptive controller observes) with the worker's thread CPU time in
    it, each collector pause (``gc.callbacks``) and each producer
    ``send_columns``. A step's wall splits into its collector pauses, the
    worker's own CPU time and the rest (waits: the GIL, the card)."""

    def __init__(self, rt):
        import threading
        self.disp, self.coll, self.prod, self.pauses = [], [], [], []
        self._gc_t0 = None
        self._threading = threading
        for name, rec in (("dispatch", self.disp), ("collect", self.coll),
                          ("send_columns", self.prod)):
            setattr(rt, name, self._timed(getattr(rt, name), rec))
        self.tracked = len(gc.get_objects())
        gc.callbacks.append(self._on_gc)

    @staticmethod
    def _timed(fn, rec: list):
        def timed(*a, **k):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **k)
            finally:
                rec.append((w0, time.perf_counter(), time.thread_time() - c0))
        return timed

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.pauses.append((self._gc_t0, time.perf_counter(),
                                info["generation"],
                                self._threading.current_thread().name))
            self._gc_t0 = None

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)

    def report(self, slow_ms: float) -> dict:
        def over(iv, spans):
            return sum(max(0.0, min(iv[1], s[1]) - max(iv[0], s[0]))
                       for s in spans)

        steps = []
        for d, c in zip(self.disp, self.coll):
            gcs = [g for g in self.pauses if over(d, [g]) + over(c, [g])]
            steps.append({
                "ms": 1e3 * ((d[1] - d[0]) + (c[1] - c[0])),
                "cpu_ms": 1e3 * (d[2] + c[2]),
                "gc_ms": 1e3 * (over(d, gcs) + over(c, gcs)),
                "gc_generations": sorted({g[2] for g in gcs}),
                "producer_ms": 1e3 * (over(d, self.prod)
                                      + over(c, self.prod))})
        ms = np.array([s["ms"] for s in steps]) if steps else np.zeros(1)
        gens = {}
        for t0, t1, g, th in self.pauses:
            e = gens.setdefault(str(g), {"count": 0, "total_ms": 0.0,
                                         "max_ms": 0.0, "threads": []})
            e["count"] += 1
            e["total_ms"] += 1e3 * (t1 - t0)
            e["max_ms"] = max(e["max_ms"], 1e3 * (t1 - t0))
            if th not in e["threads"]:
                e["threads"].append(th)
        slow = [dict(step=i, **s) for i, s in enumerate(steps)
                if s["ms"] > slow_ms]
        return {"tracked_objects": self.tracked, "steps": len(steps),
                "step_ms_median": float(np.median(ms)),
                "step_ms_p99": float(np.percentile(ms, 99)),
                "step_ms_max": float(ms.max()),
                "first_steps_ms": [s["ms"] for s in steps[:4]],
                "slow_ms": slow_ms, "slow_steps": slow,
                "slow_gc_ms": sum(s["gc_ms"] for s in slow),
                "slow_wall_ms": sum(s["ms"] for s in slow),
                "gc_pauses": gens,
                "producer_s": sum(p[1] - p[0] for p in self.prod)}


def io_edge_run(manager, csv: str, head: int, adaptive: bool, card: bool,
                widths: dict | None = None, freeze: bool = False) -> dict:
    """``iot_adaptive_edge`` from the CSV file: the rows, the controller,
    the driver's deadline flushes, the flush causes, the tolerance scale
    and, on the card, the step probe and the ``StallTrace``. On the card
    the scale is computed after the run from each step's inputs, so the
    steps the controller times carry no check's work. ``freeze`` keeps the
    objects alive before the run out of the collector (``gc.freeze``)."""
    import torch
    from siddhi_tpu_torch import StreamCallback
    from siddhi_tpu_torch.tools import engine_workloads as ew
    rt = manager.create_siddhi_app_runtime(ew.iot_adaptive_edge_app(
        csv, head, adaptive=adaptive, **(widths or {})), playback=True)
    rows = []
    # tuples of atoms, which the collector stops tracking: the check's copy
    # of the rows adds no work to the run's collections
    rt.add_callback("Stats", StreamCallback(lambda evs: rows.extend(
        (e.timestamp, tuple(e.data)) for e in evs)))
    b = rt.device_bridges[0]
    b.runtime.flush_causes = {}
    q = plan_of(b.runtime)
    sh = query_shapes_module()
    step, sc, kept = q.step_tensors, [sh.Scale()], []

    def scaled(state, cols, ts, valid):
        if card:                  # a step returns fresh state tensors
            kept.append((state, cols, ts, valid))
        else:
            sc[0] = sh.next_scale(q, sc[0], state, cols, ts, valid)
        return step(state, cols, ts, valid)

    q.step_tensors = scaled
    probe = StepProbe(b.runtime) if card else None
    if freeze:
        gc.collect()
        gc.freeze()
    trace = StallTrace(b.runtime) if card else None
    try:
        t0 = time.perf_counter()
        rt.start()
        if not rt.sources[0].wait_drained(600.0):
            fail("engine_io: the file source did not drain")
        fed_s = time.perf_counter() - t0
        idle_t0 = time.perf_counter()
        while adaptive and b.driver.deadline_flushes == 0 \
                and time.perf_counter() - idle_t0 < IO_IDLE_S:
            time.sleep(0.005)
        idle_s = time.perf_counter() - idle_t0
        rt.flush_device()
        b.driver.flush_sync()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if freeze:
            gc.unfreeze()
        if trace is not None:
            trace.close()
    t_scale = time.perf_counter()
    for args in kept:
        sc[0] = sh.next_scale(q, sc[0], *args)
    scale_s = time.perf_counter() - t_scale
    kept.clear()
    ctrl = b.runtime.batch_controller
    gauges = rt.ctx.statistics_manager.report()["gauges"]
    out = dict(rows=rows, wall=wall, fed_s=fed_s, idle_s=idle_s,
               deadline=b.driver.deadline_flushes,
               causes=dict(b.runtime.flush_causes),
               report=None if ctrl is None else ctrl.report(),
               current=None if ctrl is None else ctrl.current,
               gauge=gauges.get("device.stats.batch_size"),
               stepped=b.driver.batches_stepped, probe=probe, q=q,
               scale=sc[0], parse_errors=rt.sources[0].mapper.parse_errors,
               device=b.runtime.device.type, freeze=freeze,
               stalls=None if trace is None else trace.report(
                   ctrl.latency_target_ms / 2.0 if ctrl is not None
                   and ctrl.latency_target_ms else 25.0),
               scale_ms_per_step=1e3 * scale_s
               / max(1, b.driver.batches_stepped))
    manager.shutdown()
    return out


def io_edge_check(sh, n: int, edge: dict, static: dict) -> dict:
    """Holds an ``iot_adaptive_edge`` card run to the static CPU run (keys
    and counts exact, sums equal or within the query tolerances) and
    checks its controller and deadline flush; returns its report."""
    tag = "engine_io edge" + (" (frozen)" if edge["freeze"] else "")
    rep = edge["report"]
    if edge["device"] != "cuda" or static["device"] != "cpu":
        fail(f"{tag}: runs on {edge['device']} / {static['device']}")
    if rep is None or rep["observations"] == 0 or rep["adjustments"] == 0:
        fail(f"{tag}: the adaptive controller did not adjust: {rep}; "
             f"stalls {edge['stalls']}")
    if edge["deadline"] < 1:
        fail(f"{tag}: no deadline flush in {edge['idle_s']:.1f} s idle")
    if edge["gauge"] != edge["current"]:
        fail(f"{tag}: batch_size gauge {edge['gauge']} != controller "
             f"{edge['current']}")
    if edge["parse_errors"] or static["parse_errors"]:
        fail(f"{tag}: CSV parse errors")
    a_rows, b_rows = static["rows"], edge["rows"]
    if len(a_rows) != len(b_rows) or [(r[0], r[2]) for _, r in a_rows] != \
            [(r[0], r[2]) for _, r in b_rows]:
        fail(f"{tag}: keys and counts differ from the static CPU run "
             f"({len(b_rows)} / {len(a_rows)} rows)")
    a, b = static["scale"], edge["scale"]
    sc = sh.Scale(np.maximum(a.s1, b.s1), np.maximum(a.sm, b.sm),
                  np.maximum(a.s2, b.s2))
    # an output row carries its batch's timestamp, and the two runs batch
    # differently: the values are compared, in order
    if [r for _, r in a_rows] == [r for _, r in b_rows]:
        held = "exact"
    else:
        close_rows(sh, edge["q"], sc, [(0, r) for _, r in a_rows],
                   [(0, r) for _, r in b_rows], f"{tag} Stats")
        held = "within the tolerances"
    step_ms = edge["probe"].step_ms()
    stalls = dict(edge["stalls"])
    stalls["slow_steps"] = stalls["slow_steps"][:8]
    return {
        "gc_frozen": edge["freeze"],
        "events_per_s": n / edge["fed_s"], "fed_s": edge["fed_s"],
        "idle_s": edge["idle_s"], "wall_s": edge["wall"],
        "controller": rep, "gauge_batch_size": edge["gauge"],
        "deadline_flushes": edge["deadline"],
        "flush_causes": edge["causes"], "steps": edge["stepped"],
        "step_call_ms_median": float(np.median(step_ms)),
        "step_call_ms_p99": float(np.percentile(step_ms, 99)),
        "stalls": stalls, "check_scale_ms_per_step":
            edge["scale_ms_per_step"],
        "rows": len(b_rows), "rows_vs_static_cpu": held}


def phase_engine_io(seed: int, n_events: int, widths: dict | None = None,
                    edge_widths: dict | None = None,
                    persist_at: int = IO_PERSIST_AT,
                    kill_at: int = IO_KILL_AT) -> dict:
    """``iot_durable`` straight, crashed and recovered, and on the CPU;
    ``iot_adaptive_edge`` on the card (as a user's app runs, then with the
    objects alive before it frozen out of the collector) against a static
    CPU run. ``widths`` and ``edge_widths`` (``iot_durable_app``'s and
    ``iot_adaptive_edge_app``'s, full width by default) and the cut points
    are for a rehearsal at small sizes."""
    import shutil
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    t_phase = time.perf_counter()
    ev = ew.IotEvents(n_events, seed)
    scratch = io_scratch()
    records = ErrorRecords()
    sh = query_shapes_module()
    try:
        # warm-up: the kernels' first launches (untimed)
        m = SiddhiManager()
        rt, _, unsubs = durable_runtime(m, os.path.join(scratch, "warm"),
                                        "warm", widths=widths)
        publish_iot(ev, "warm", 0, 8192)
        rt.flush_device()
        for u in unsubs:
            u()
        m.shutdown()
        torch.cuda.synchronize()

        # the edge first: its unfrozen run then meets the heap a user's app
        # would, not the durable runs' payloads, which stay alive for their
        # checks below
        csv_bytes, head = ew.iot_csv(ev)    # data generation, untimed
        csv = os.path.join(scratch, "iot.csv")
        with open(csv, "wb") as f:
            f.write(csv_bytes)
        # warm-up: the edge app's first run in the process (its file
        # source, mapper and native parse, the plan's first launches) on
        # other events, untimed, so the controller's first window times
        # steady steps
        warm_bytes, warm_head = ew.iot_csv(ew.IotEvents(IO_EDGE_WARM,
                                                        seed + 7))
        warm_csv = os.path.join(scratch, "iot_warm.csv")
        with open(warm_csv, "wb") as f:
            f.write(warm_bytes)
        io_edge_run(SiddhiManager(), warm_csv, warm_head, True, True,
                    edge_widths)
        reset_launches()
        edges = {}
        for frozen in (False, True):
            gc.collect()          # each run starts from a collected heap
            edges[frozen] = io_edge_run(SiddhiManager(), csv, head, True,
                                        True, edge_widths, freeze=frozen)
        edge_launches = read_launches()
        static = io_edge_run(SiddhiManager(device="cpu"), csv, head, False,
                             False, edge_widths)
        reset_launches()              # counts from here: the engine_io path
        card = io_straight(SiddhiManager(), ev, scratch, "card", True,
                           widths)
        crash = io_crash_recover(ev, scratch, widths, persist_at, kill_at)
        launches = read_launches()
        cpu = io_straight(SiddhiManager(device="cpu"), ev, scratch, "cpu",
                          False, widths)

        records.check("engine_io")
    finally:
        records.close()
        shutil.rmtree(scratch, ignore_errors=True)

    # -- iot_durable
    if card["bridged"] != ["chain", "stats"] or cpu["bridged"] != \
            card["bridged"]:
        fail(f"engine_io: bridges {card['bridged']} / {cpu['bridged']}, "
             f"expected chain, stats")
    for b in card["rt"].device_bridges:
        if b.runtime.device.type != "cuda":
            fail(f"engine_io: '{b.query_name}' runs on {b.runtime.device}")
    rep = crash["report"]
    if rep["replayed"] != {"Raw": kill_at - persist_at} \
            or rep["watermarks"] != {"Raw": kill_at}:
        fail(f"engine_io: recover reported {rep}")
    if not crash["wal_after"] < crash["wal_before"]:
        fail(f"engine_io: the WAL's bytes {crash['wal_before']} -> "
             f"{crash['wal_after']} at the persist")
    if card["losses"] or crash["losses"] or cpu["losses"]:
        fail(f"engine_io: events shed or dropped: {card['losses']}, "
             f"{crash['losses']}, {cpu['losses']}")
    for s in ("Alerts", "AlertRate", "Stats"):
        if not card["rows"][s]:
            fail(f"engine_io: no {s} rows")
        if crash["rows"][s] != card["rows"][s]:
            fail(f"engine_io: {s}: the recovered run differs from the "
                 f"straight one ({len(crash['rows'][s])} / "
                 f"{len(card['rows'][s])} payloads)")
    for s in ("Alerts", "AlertRate"):
        if cpu["rows"][s] != card["rows"][s]:
            fail(f"engine_io: {s}: the CPU engine differs from the card's")
    q_stats = plan_of(next(b for b in card["rt"].device_bridges
                           if b.query_name == "stats").runtime)
    # the grouped float32 sums: equal, or within the tolerances
    stats_held = "exact"
    if cpu["rows"]["Stats"] != card["rows"]["Stats"]:
        close_rows(sh, q_stats, cpu["scale"], cpu["rows"]["Stats"],
                   card["rows"]["Stats"], "engine_io Stats (card vs CPU)")
        stats_held = "within the tolerances"

    # -- iot_adaptive_edge
    edge_out = {frozen: io_edge_check(sh, ev.n, e, static)
                for frozen, e in edges.items()}
    total = {c: launches[c] + edge_launches[c] for c in launches}
    if total[BlockPlan.__name__] == 0 or total[QueryPlan.__name__] == 0 \
            or any(n for c, n in total.items()
                   if c not in (BlockPlan.__name__, QueryPlan.__name__)):
        fail(f"engine_io: launches {total}: nfa_block and query_step must "
             f"launch, no other kernel")
    out = {
        "phase": "engine_io", "events": ev.n,
        "iot_durable": {
            "events_per_s": ev.n / card["wall"], "wall_s": card["wall"],
            "cpu_events_per_s": ev.n / cpu["wall"], "cpu_wall_s": cpu["wall"],
            "wal_bytes_before_persist": crash["wal_before"],
            "wal_bytes_after_persist": crash["wal_after"],
            "persist_s": crash["persist_s"], "recover_s": crash["recover_s"],
            "replay_s": crash["replay_s"], "recover_report": {
                "replayed": rep["replayed"], "watermarks": rep["watermarks"]},
            "payloads": {s: len(r) for s, r in card["rows"].items()},
            "recovered_equal": True, "cpu_equal": True,
            "stats_card_vs_cpu": stats_held, "shed_or_dropped": 0},
        "iot_adaptive_edge": {**edge_out[False],
                              "cpu_static_wall_s": static["wall"],
                              "static_steps": static["stepped"]},
        "iot_adaptive_edge_frozen": edge_out[True],
        "launches": {"nfa_block": total[BlockPlan.__name__],
                     "query_step": total[QueryPlan.__name__]},
        "error_records": 0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# ------------------------------------------------------------ engine_guard

# cut from 131,072 / 131,072 / 196,608 to keep the whole script near its
# time (PERF.md §4); at 65,536 events the seeded sites still fault: the
# chain once in 32 steps, stats once in 16, the filter 10 times in 32
GUARD_EVENTS = 65_536              # iot_mixed events under chaos, per run
GUARD_FILTER_EVENTS = 65_536       # (b): the stateless filter's events
GUARD_COST_EVENTS = 131_072        # (d): events per app and run
GUARD_QUARANTINE_BATCH = 1024      # (c): the filter's batch
GUARD_COOLDOWN_MS = 2000           # (c): the breaker's cool-down


class GuardCount:
    """Per guard of ``rt``, counted around the guard itself and apart from
    its ``report()``: the faults its chaos site raised, the batches that
    failed at dispatch and their events, and the steps that reached the
    device. The installed ``rt.dispatch`` calls the guard's ``dispatch``
    and the guard its injector's ``on_device``, each read at every step,
    so instance attributes wrap both."""

    def __init__(self, rt):
        from siddhi_tpu_torch.resilience import ChaosFault
        chaos = rt.resilience.chaos
        self.by_query = {}
        sites = {}
        for g in rt.resilience.guards:
            c = {"site_faults": 0, "failed_batches": 0, "failed_events": 0,
                 "device_steps": 0}
            self.by_query[g.query_name] = sites[g._site] = c

            def dispatch(inner, batch, orig=g.dispatch, c=c):
                n = int(batch.get("count", 0))
                token = orig(inner, batch)
                if token.failed:
                    c["failed_batches"] += 1
                    c["failed_events"] += n
                else:
                    c["device_steps"] += 1
                return token

            g.dispatch = dispatch
        if chaos is None:
            return
        on_device = chaos.on_device

        def counted(site):
            try:
                on_device(site)
            except ChaosFault:
                sites[site]["site_faults"] += 1
                raise

        chaos.on_device = counted


class AlertClock:
    """The playback clock at each ``Alerts`` event's arrival in ``rt``: the
    number of times the scheduler has fired its due timers so far and the
    time of the last firing. The async driver delivers a batch's alerts
    when its worker fences it, by which time the producer may have moved
    the clock on, so ``alert_rate``'s ``window.time(10 sec)`` may hold
    fewer alerts than in a sync run: ``alert_rate_rows`` gives the rows
    that this schedule makes."""

    def __init__(self, rt):
        from siddhi_tpu_torch import StreamCallback
        sched = rt.ctx.scheduler
        self.fires, self.now, self.arrivals = 0, None, []
        fire_until = sched.fire_until

        def counted(now):
            self.fires += 1
            self.now = now
            fire_until(now)

        sched.fire_until = counted
        rt.add_callback("Alerts", StreamCallback(
            lambda evs: self.arrivals.extend(
                (e.timestamp, self.fires, self.now) for e in evs)))


def alert_rate_rows(arrivals: list, window_ms: int = 10_000) -> list:
    """``from Alerts#window.time(10 sec) select count() as alerts``, plain,
    over ``AlertClock.arrivals``: an alert leaves the window when an alert
    at least ``window_ms`` younger arrives, or when the timers fire at a
    time at least ``window_ms`` past it after it arrived; each arrival
    emits the window's count, stamped with its own time."""
    buf, out, fired = collections.deque(), [], 0
    for ts, fires, now in arrivals:
        if fires > fired and now is not None:
            while buf and buf[0] + window_ms <= now:
                buf.popleft()
        fired = fires
        while buf and buf[0] + window_ms <= ts:
            buf.popleft()
        buf.append(ts)
        out.append((ts, [len(buf)]))
    return out


def guard_reports(rt) -> dict:
    return {g.query_name: g.report() for g in rt.resilience.guards}


def check_guard_counts(where: str, rt, count: GuardCount,
                       launches: dict | None) -> dict:
    """Each guard's failures are its site's injected faults (more than
    none), its fallback events the events of the batches that failed, no
    event lost; on the card each kernel launched once a step (B5a: its
    plan's launches a step) for exactly the steps that were not faulted."""
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    reps = guard_reports(rt)
    per_step = {}
    for b in rt.device_bridges:
        plan = plan_of(b.runtime).plan
        per_step[b.query_name] = (
            type(plan).__name__,
            plan.step_launches() if isinstance(plan, QueryPlan)
            else BlockPlan.LAUNCHES)
    expect = {}
    for q, r in reps.items():
        c = count.by_query[q]
        if not (r["failures"] == c["site_faults"] == c["failed_batches"]
                and r["failures"] > 0):
            fail(f"{where}: guard '{q}': {r['failures']} failures, its site "
                 f"injected {c['site_faults']}, {c['failed_batches']} batches "
                 f"failed: {json.dumps(r)}")
        if r["fallback_events"] != c["failed_events"] or r["lost_events"]:
            fail(f"{where}: guard '{q}': {r['fallback_events']} fallback "
                 f"events, the failed batches held {c['failed_events']}, "
                 f"{r['lost_events']} lost")
        name, each = per_step[q]
        expect[name] = expect.get(name, 0) + each * c["device_steps"]
    if launches is not None:
        got = {k: v for k, v in launches.items() if v}
        if got != expect:
            fail(f"{where}: launches {launches}, expected {expect} (the "
                 f"steps that were not faulted)")
    return {q: {**{k: r[k] for k in ("failures", "fallback_events",
                                      "lost_events", "circuit",
                                      "fallback_engine")},
                "device_steps": count.by_query[q]["device_steps"]}
            for q, r in reps.items()}


def f32_rows(rows: list) -> list:
    """``(dev, v)`` rows with ``v`` as float32: the host replay emits the
    raw double, the device its float32."""
    return [(d, np.float32(v)) for _, (d, v) in rows]


def filter_run(manager, app: str, ev, lo: int = 0, hi: int | None = None,
               rt=None):
    """``GUARD_FILTER``'s events ``lo:hi`` through ``manager`` (or on into
    ``rt``): the runtime, its ``Alerts`` rows in ``rt.got``."""
    from siddhi_tpu_torch import StreamCallback
    from siddhi_tpu_torch.tools import engine_workloads as ew
    if rt is None:
        rt = manager.create_siddhi_app_runtime(app, playback=True)
        rt.got = []
        rt.add_callback("Alerts", StreamCallback(lambda evs: rt.got.extend(
            (e.timestamp, list(e.data)) for e in evs)))
        rt.start()
    ew.feed_filter(rt, ev, lo, hi)
    rt.flush_device()
    return rt


def guard_cost(seed: int, n_events: int) -> dict:
    """(d): the engine phase's chain and ``grouped_length`` through the
    engine with the default guard and with
    ``@app:resilience(device.quarantine='false')``, guarded, unguarded,
    unguarded, guarded: events/s of each, rows equal. Each run starts from
    a collected heap (``gc.collect``), so a full collection of another
    run's garbage does not land in it."""
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import engine_workloads as ew
    out = {}
    for name in ("chain", "grouped_length"):
        cfg = ew.engine_config(name)
        ev = ew.EngineEvents(name, n_events, seed)
        off = "@app:resilience(device.quarantine='false')\n" + cfg["app"]
        rates = {"guarded": [], "unguarded": []}
        rows = {}
        for label in ("guarded", "unguarded", "unguarded", "guarded"):
            m = SiddhiManager()
            rt, _ = engine_runtime(
                m, dict(cfg, app=cfg["app"] if label == "guarded" else off))
            if (rt.device_bridges[0].guard is None) != (label ==
                                                        "unguarded"):
                fail(f"engine_guard (d) {name}: {label} run's guard is "
                     f"{rt.device_bridges[0].guard}")
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ew.feed_engine(rt, ev)
            rt.flush_device()
            torch.cuda.synchronize()
            rates[label].append(ev.n / (time.perf_counter() - t0))
            rows.setdefault(label, list(rt.got))
            reps = guard_reports(rt)
            m.shutdown()
            if any(r["failures"] or r["fallback_events"]
                   for r in reps.values()):
                fail(f"engine_guard (d) {name}: a guard fell back: {reps}")
        if rows["guarded"] != rows["unguarded"]:
            fail(f"engine_guard (d) {name}: the guarded run's rows differ "
                 f"from the unguarded run's")
        out[name] = {"events": ev.n,
                     "guarded_events_per_s": rates["guarded"],
                     "unguarded_events_per_s": rates["unguarded"],
                     "guarded_over_unguarded":
                         float(np.mean(rates["guarded"])
                               / np.mean(rates["unguarded"]))}
    return out


def phase_engine_guard(seed: int, n_events: int = GUARD_EVENTS,
                       filter_events: int = GUARD_FILTER_EVENTS,
                       cost_events: int = GUARD_COST_EVENTS,
                       widths: dict | None = None,
                       quarantine_batch: int = GUARD_QUARANTINE_BATCH) -> dict:
    """The resilience tier on the card: (a) ``iot_mixed`` under seeded
    device faults, sync and async, against the CPU engine under the same
    seed; (b) a stateless filter under heavier faults against a fault-free
    card run; (c) a quarantine and its re-promotion; (d) the default
    guard's cost. ``widths`` (``iot_mixed_app``'s) and the event counts
    shrink it for a rehearsal on the CPU."""
    import logging
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.resilience import CircuitState
    from siddhi_tpu_torch.tools import engine_workloads as ew
    t_phase = time.perf_counter()
    # every injected fault logs its traceback as a WARNING; lost events log
    # an ERROR, which the records catch
    guard_log = logging.getLogger("siddhi_tpu_torch.resilience")
    level = guard_log.level
    guard_log.setLevel(logging.ERROR)
    records = ErrorRecords()
    launches = {}
    try:
        # ---- (d) what the default guard costs (first: the heap holds no
        # row of (a)-(c) yet)
        cost = guard_cost(seed, cost_events)

        # ---- (a) iot_mixed under chaos, sync and async, and the CPU
        app = ew.IOT_CHAOS + ew.iot_mixed_app(**(widths or {}))
        ev = ew.IotEvents(n_events, seed)
        runs = {}
        def hooks(rt):
            return GuardCount(rt), AlertClock(rt)

        for mode in ("sync", "async"):
            text = app if mode == "sync" else app.replace(
                "strict='true'", "strict='true', async='true'")
            runs[mode] = host_engine_run(SiddhiManager(), text, ev,
                                         card=True, hook=hooks)
        cpu = host_engine_run(SiddhiManager(device="cpu"), app, ev,
                              card=False, hook=hooks)
        guards_a, alert_rate = {}, {}
        for mode, run in list(runs.items()) + [("cpu", cpu)]:
            rt = run["rt"]
            if sorted(b.query_name for b in rt.device_bridges) != \
                    ["chain", "stats"]:
                fail(f"engine_guard (a) {mode}: device bridges "
                     f"{[b.query_name for b in rt.device_bridges]}")
            if run["errors"]:
                fail(f"engine_guard (a) {mode}: {run['errors']} receiver "
                     f"errors")
            guards_a[mode] = check_guard_counts(
                f"engine_guard (a) {mode}", rt, run["hook"][0],
                run["launches"])
            # every run's AlertRate rows are those of its own delivery
            # schedule, exactly
            rows, plain = run["rows"]["AlertRate"], alert_rate_rows(
                run["hook"][1].arrivals)
            if rows != plain:
                fail(f"engine_guard (a) {mode}: AlertRate: {len(rows)} rows, "
                     f"the plain window over the alerts' arrival clock "
                     f"gives {len(plain)}: they differ")
            alert_rate[mode] = sum(a != b for a, b in zip(
                rows, cpu["rows"]["AlertRate"]))
        for mode, run in runs.items():
            for s in ("Alerts", "AlertRate", "Top", "RoomPeak"):
                if s == "AlertRate" and mode == "async":
                    # the count in each row depends on when the worker
                    # delivers the alert against the producer's clock: held
                    # exactly to its schedule above, and here to the CPU's
                    # number of rows
                    if len(run["rows"][s]) != len(cpu["rows"][s]):
                        fail(f"engine_guard (a) async: AlertRate: "
                             f"{len(run['rows'][s])} rows on the card, "
                             f"{len(cpu['rows'][s])} on the CPU")
                    continue
                if run["rows"][s] != cpu["rows"][s]:
                    fail(f"engine_guard (a) {mode}: {s}: "
                         f"{len(run['rows'][s])} rows on the card, "
                         f"{len(cpu['rows'][s])} on the CPU: they differ")
            q = plan_of(next(b for b in run["rt"].device_bridges
                             if b.query_name == "stats").runtime)
            close_rows(query_shapes_module(), q, cpu["scale"],
                       cpu["rows"]["Stats"], run["rows"]["Stats"],
                       f"engine_guard (a) {mode} Stats (card vs CPU)")
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if not guards_a["sync"] == guards_a["async"] == guards_a["cpu"]:
            fail(f"engine_guard (a): the guards differ: {guards_a}")

        # ---- (b) a stateless filter, faulted, against a clean card run
        fev = ew.IotEvents(filter_events, seed + 1)
        text = ew.GUARD_FILTER.format(batch=2048, extra=", async='true'")
        faulted = ("@app:chaos(seed='16', device.fail.p='0.25')\n"
                   "@app:resilience(device.circuit.threshold='1000')\n"
                   + text)
        clean = filter_run(SiddhiManager(), text, fev)
        m = SiddhiManager()
        rt = filter_run(m, faulted, fev, 0, 0)
        count = GuardCount(rt)
        torch.cuda.synchronize()
        reset_launches()
        filter_run(m, faulted, fev, rt=rt)
        torch.cuda.synchronize()
        got_b = read_launches()
        guards_b = check_guard_counts("engine_guard (b)", rt, count, got_b)
        m.shutdown()
        if clean.resilience.guards[0].report()["failures"]:
            fail("engine_guard (b): the clean run fell back")
        if f32_rows(rt.got) != f32_rows(clean.got):
            fail(f"engine_guard (b): {len(rt.got)} rows, the clean run "
                 f"{len(clean.got)}: (dev, float32 v) differ")
        for k, v in got_b.items():
            launches[k] = launches.get(k, 0) + v

        # ---- (c) quarantine, then the probe re-promotes the kernel. The
        # cool-down must outlast the OPEN window (the second fault's
        # replay, 2 * B sends one by one, two replays): at 50 ms a slow
        # host let it lapse, and the HALF_OPEN probe failed a third time.
        B = quarantine_batch
        qapp = ("@app:chaos(seed='16', device.fail.p='1.0')\n"
                "@app:resilience(device.circuit.threshold='2', "
                f"device.circuit.cooldown.ms='{GUARD_COOLDOWN_MS}')\n"
                + ew.GUARD_FILTER.format(batch=B, extra=""))
        qev = ew.IotEvents(6 * B, seed + 2)
        m = SiddhiManager()
        rt = filter_run(m, qapp, qev, 0, 0)
        guard = rt.device_bridges[0].guard
        torch.cuda.synchronize()
        reset_launches()
        filter_run(m, qapp, qev, 0, 2 * B, rt=rt)       # two faults: OPEN
        torch.cuda.synchronize()
        at_open = read_launches()[QueryPlan.__name__]
        if guard.breaker.state != CircuitState.OPEN or guard.failures != 2:
            fail(f"engine_guard (c): not quarantined: {guard.report()}")
        filter_run(m, qapp, qev, 2 * B, 4 * B, rt=rt)   # while OPEN
        torch.cuda.synchronize()
        while_open = read_launches()[QueryPlan.__name__]
        open_window_s = guard.breaker.cooldown_s \
            - guard.breaker.remaining_cooldown()
        if at_open or while_open or guard.failures != 2 \
                or guard.fallback_events != 4 * B:
            fail(f"engine_guard (c): launched {at_open} / {while_open} "
                 f"times while faulted / OPEN ({open_window_s:.3f} s of "
                 f"the cool-down gone): {guard.report()}")
        rt.resilience.chaos.device_fail_p = 0.0          # healed
        time.sleep(guard.breaker.remaining_cooldown() + 0.01)
        filter_run(m, qapp, qev, 4 * B, 6 * B, rt=rt)   # probe, then on
        torch.cuda.synchronize()
        after = read_launches()[QueryPlan.__name__]
        plan = plan_of(rt.device_bridges[0].runtime).plan
        if guard.breaker.state != CircuitState.CLOSED \
                or after != 2 * plan.step_launches() \
                or guard.fallback_events != 4 * B:
            fail(f"engine_guard (c): after the probe {after} launches: "
                 f"{guard.report()}")
        expect = [(d, np.float32(v)) for d, v in zip(qev.dev, qev.v)
                  if v > 50.0]
        if f32_rows(rt.got) != expect:
            fail(f"engine_guard (c): {len(rt.got)} rows, {len(expect)} "
                 f"expected, each event once")
        quarantine = {"batch": B, "events": qev.n,
                      "launches_faulted": at_open,
                      "launches_while_open": while_open,
                      "launches_after_probe": after,
                      "cooldown_s": guard.breaker.cooldown_s,
                      "open_window_s": open_window_s,
                      "report": guard.report()}
        m.shutdown()
        launches[QueryPlan.__name__] += after

        records.check("engine_guard")
    finally:
        records.close()
        guard_log.setLevel(level)
    if not launches.get(BlockPlan.__name__) \
            or not launches.get(QueryPlan.__name__):
        fail(f"engine_guard: launches {launches}")
    out = {
        "phase": "engine_guard", "app": "iot_mixed + chaos",
        "events": n_events,
        "events_per_s": {mode: ev.n / run["wall"]
                         for mode, run in runs.items()},
        "cpu_events_per_s": ev.n / cpu["wall"],
        "guards": guards_a,
        "chaos": runs["sync"]["rt"].resilience.chaos.report()["counters"],
        "rows": {s: len(r) for s, r in runs["sync"]["rows"].items()},
        "equal_to_cpu_engine": True,
        "alert_rate_rows_equal_to_their_schedule": True,
        "alert_rate_rows_differing_from_cpu": alert_rate,
        "stateless": {"events": fev.n, "rows": len(clean.got),
                      "guards": guards_b, "equal_to_clean_run_f32": True},
        "quarantine": quarantine, "cost": cost,
        "launches": {"nfa_block": launches[BlockPlan.__name__],
                     "query_step": launches[QueryPlan.__name__]},
        "error_records": 0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out



# ------------------------------------------------------------ engine_observe

# iot_mixed events per run (cut from 65,536 after a 70.3 s phase: 20 chain
# and 10 stats batches; (d)'s seeded faults land on chain steps 5, 11, 18,
# and stats' first at its step 13, past the cut)
OBSERVE_EVENTS = 40_960
OBSERVE_PROFILE_EVENTS = 16_384    # (e): the chain's events per profiled run
OBSERVE_ANN = ("@app(name='Observed', statistics='true')\n"
               "@app:trace(sample='1/64')\n"
               "@app:flightrecorder(ring='4096')\n")
# (d): every failed step opens its circuit and the next batch probes it, so
# each fault puts the breaker's transitions on the flight recorder
OBSERVE_CHAOS = ("@app:chaos(seed='16', device.fail.p='0.05')\n"
                 "@app:resilience(device.circuit.threshold='1', "
                 "device.circuit.cooldown.ms='0')\n")
# a Prometheus 0.0.4 sample line: name, labels, value, optional timestamp
PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*)?\})?'
    r' (-?[0-9.eE+-]+|NaN|[+-]Inf)( -?[0-9]+)?$')


def check_exposition(where: str, text: str) -> dict:
    """``text`` as Prometheus 0.0.4 text: every line a ``# HELP``, a
    ``# TYPE`` or a sample of a family typed before it, no exemplar.
    Returns ``{family: {sample name + labels: value}}``."""
    types, fams = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                fail(f"{where}: bad TYPE line: {line}")
            types[parts[2]] = parts[3]
            fams.setdefault(parts[2], {})
            continue
        if line.startswith("# HELP "):
            continue
        m = PROM_SAMPLE.match(line)
        if m is None or line.startswith("#") or " # " in line:
            fail(f"{where}: not a 0.0.4 sample line: {line}")
        name = m.group(1)
        fam = name if name in types else next(
            (name[:-len(s)] for s in ("_bucket", "_sum", "_count")
             if name.endswith(s) and name[:-len(s)] in types), None)
        if fam is None:
            fail(f"{where}: sample of an untyped family: {line}")
        fams[fam][name + (m.group(2) or "")] = float(m.group(3))
    return fams


def observe_probes(where: str, rt, launches: dict, n_events: int) -> dict:
    """(b): each device query's probe against its kernel's launches and the
    events its bridge took, its flush causes against its steps, its phase
    breakdown reconciled, its trace spans, and the exposition."""
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.observability import render
    obs = rt.observability
    lat = obs.latency_report()["queries"]
    traces = obs.trace_export()["traces"]
    spans = {(s["stage"], s["name"]) for t in traces for s in t["spans"]}
    out = {}
    for b in rt.device_bridges:
        q, p = b.query_name, b.probe
        plan = plan_of(b.runtime).plan
        each = plan.step_launches() if isinstance(plan, QueryPlan) \
            else BlockPlan.LAUNCHES
        launched = launches[type(plan).__name__]
        if p.steps * each != launched:
            fail(f"{where}: '{q}': probe steps {p.steps} x {each} launches "
                 f"a step != {launched} launched")
        if p.events != n_events:
            fail(f"{where}: '{q}': probe events {p.events}, the bridge "
                 f"took {n_events}")
        if sum(p.flush_causes.values()) != p.steps:
            fail(f"{where}: '{q}': flush causes {p.flush_causes} do not sum "
                 f"to its {p.steps} steps")
        ratio = lat[q].get("reconciliation_ratio")
        if ratio is None or abs(ratio - 1.0) > 1e-6:
            fail(f"{where}: '{q}': reconciliation ratio {ratio}")
        if ("fill-wait", q) not in spans or ("device", q) not in spans:
            fail(f"{where}: '{q}': the trace export lacks its fill-wait or "
                 f"device span ({len(traces)} traces)")
        out[q] = {"steps": p.steps, "launches": launched,
                  "events": p.events, "pad_ratio": p.pad_ratio,
                  "flush_causes": dict(p.flush_causes),
                  "compile_seconds": p.compile_seconds,
                  "busy_seconds": p.busy_seconds,
                  "reconciliation_ratio": ratio,
                  "end_to_end_mean_ms": lat[q]["end_to_end_mean_ms"],
                  "phase_mean_ms": {ph: v["avg_ms"] for ph, v in
                                    lat[q]["phases"].items()}}
    text = render([rt.ctx.statistics_manager])
    fams = check_exposition(f"{where} /metrics", text)
    steps = fams.get("siddhi_tpu_device_steps_total", {})
    labelled = {k.split('query="')[1].split('"')[0]: v
                for k, v in steps.items() if 'query="' in k}
    if labelled != {q: float(o["steps"]) for q, o in out.items()}:
        fail(f"{where}: siddhi_tpu_device_steps_total {labelled}")
    om = render([rt.ctx.statistics_manager], with_exemplars=True)
    if "# {" not in om:
        fail(f"{where}: the OpenMetrics rendering carries no exemplar")
    return {"queries": out, "traces": len(traces),
            "families": len(fams), "exposition_bytes": len(text)}


def observe_profile(seed: int, n_events: int, mode: str, scratch: str) -> dict:
    """(e): the chain alone under ``@app:profile(dir=...)``: the exported
    trace holds a ``siddhi:step:chain`` range a step and the blocked
    kernel's records, one a launch; their device time beside the probe's
    busy seconds."""
    import torch
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    cfg = ew.engine_config("chain")
    d = os.path.join(scratch, f"profile-{mode}")
    app = (f"@app(name='Profiled')\n@app:profile(dir='{d}')\n"
           + cfg["app"].replace("@device(", "@info(name='chain') @device(",
                                1))
    if mode == "async":
        app = app.replace("strict='true'", "strict='true', async='true'")
    ev = ew.EngineEvents("chain", n_events, seed)
    m = SiddhiManager()
    rt = m.create_siddhi_app_runtime(app, playback=True)
    rows = []
    rt.add_callback("Alerts", StreamCallback(lambda evs: rows.extend(evs)))
    torch.cuda.synchronize()
    reset_launches()
    rt.start()
    ew.feed_engine(rt, ev)
    rt.flush_device()
    torch.cuda.synchronize()
    launched = BlockPlan.launches
    probe = rt.device_bridges[0].probe
    m.shutdown()
    prof = rt.observability.profiler
    if prof.trace_path is None:
        fail(f"engine_observe (e) {mode}: no profiler trace was exported")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "siddhi:step:chain"
              and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "nfa_block_kernel" in e.get("name", "")]
    cpu_ranges = [e for e in ranges if e.get("cat") != "gpu_user_annotation"]
    if len(cpu_ranges) != probe.steps or not probe.steps:
        fail(f"engine_observe (e) {mode}: {len(cpu_ranges)} "
             f"siddhi:step:chain ranges, {probe.steps} steps")
    if len(kernels) != launched or launched != probe.steps:
        fail(f"engine_observe (e) {mode}: {len(kernels)} nfa_block_kernel "
             f"records, {launched} launches, {probe.steps} steps")
    size = os.path.getsize(prof.trace_path)
    return {"events": ev.n, "steps": probe.steps, "launches": launched,
            "rows": len(rows),
            "step_ranges": len(cpu_ranges), "kernel_records": len(kernels),
            "kernel_names": sorted({e["name"] for e in kernels}),
            "kernel_device_ms": sum(e.get("dur", 0.0) for e in kernels)
            / 1e3,
            "probe_busy_ms": probe.busy_seconds * 1e3,
            "trace_bytes": size}


def profile_in_fresh_processes(seed: int, n_events: int,
                               scratch: str) -> dict:
    """(e), each mode in a process of its own, the two at once: in a
    process half a minute or more old (this script's, by the time this
    phase runs) the profiler's trace loses kernel records, which Kineto
    drops as outside its capture window (``PERF.md`` §6, PR 17;
    ``siddhi_tpu_torch/tools/profiler_record_loss.py``), so the check runs
    where the capture keeps them. The kernel libraries are loaded from
    this run's build."""
    procs = {}
    for mode in ("sync", "async"):
        code = ("import json, sys\n"
                f"sys.path.insert(0, {REPO!r})\n"
                "import chip_smoke as cs\n"
                f"out = cs.observe_profile({seed}, {n_events}, {mode!r}, "
                f"{scratch!r})\n"
                "print(json.dumps(out))\n")
        procs[mode] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for mode, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"engine_observe (e) {mode}: the profiled process "
                     f"failed: {stderr.strip()[-2000:]}")
            out[mode] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_engine_observe(seed: int, n_events: int = OBSERVE_EVENTS,
                         profile_events: int = OBSERVE_PROFILE_EVENTS,
                         quarantine_batch: int = GUARD_QUARANTINE_BATCH
                         ) -> dict:
    """The observability tier on the card, on ``iot_mixed``: (a) the rows
    of a plain run and of a run under ``@app(statistics='true')``,
    ``@app:trace`` and ``@app:flightrecorder`` are equal; (b) the second
    run's probes against the kernels' launches, its phase breakdown, trace
    and exposition; (c) the async driver's health gauges; (d) the flight
    recorder under seeded faults and its dump at a quarantine; (e)
    ``@app:profile``'s trace of the chain. The event counts and the
    quarantine's batch shrink it for a rehearsal on the CPU."""
    import logging
    import shutil
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    t_phase = time.perf_counter()
    guard_log = logging.getLogger("siddhi_tpu_torch.resilience")
    level = guard_log.level
    guard_log.setLevel(logging.ERROR)
    scratch = io_scratch()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    try:
        plain = ew.iot_mixed_app()
        observed = OBSERVE_ANN + plain
        ev = ew.IotEvents(n_events, seed)
        n_s = sum(1 for v in ev.v if v >= 0.0)      # events into S
        runs = {}
        # ---- (a) observability changes no row
        for name, app in (("plain", plain), ("observed", observed)):
            runs[name] = host_engine_run(SiddhiManager(), app, ev, card=True)
            add(runs[name]["launches"])
        a, b = runs["plain"], runs["observed"]
        for s in ew.IOT_OUTS:
            if a["rows"][s] != b["rows"][s]:
                fail(f"engine_observe (a): {s}: {len(b['rows'][s])} rows "
                     f"observed, {len(a['rows'][s])} plain: they differ")
        for name, run in runs.items():
            bridged = sorted(x.query_name for x in run["rt"].device_bridges)
            if bridged != ["chain", "stats"]:
                fail(f"engine_observe (a) {name}: device bridges {bridged}")
            if run["errors"]:
                fail(f"engine_observe (a) {name}: {run['errors']} receiver "
                     f"errors")
        if a["rt"].observability.tracer is not None \
                or b["rt"].observability.tracer is None:
            fail("engine_observe (a): @app:trace armed the wrong run")
        # ---- (b) the probes agree with the kernels
        probes = observe_probes("engine_observe (b)", b["rt"],
                                b["launches"], n_s)

        # ---- (c) the async driver's health
        text = observed.replace("strict='true'",
                                "strict='true', async='true'")
        c = host_engine_run(SiddhiManager(), text, ev, card=True)
        add(c["launches"])
        for s in ("Alerts", "Stats"):
            if c["rows"][s] != a["rows"][s]:
                fail(f"engine_observe (c): {s}: {len(c['rows'][s])} rows "
                     f"async, {len(a['rows'][s])} plain: they differ")
        health = {}
        for x in c["rt"].device_bridges:
            p, drv = x.probe, x.driver
            if drv is None or p.driver is not drv:
                fail(f"engine_observe (c): '{x.query_name}' has no driver "
                     f"on its probe")
            pipe_wall = drv.busy_wall_seconds + drv.starved_seconds
            h = {"pipeline_depth": p.pipeline_depth,
                 "overlap_efficiency": p.overlap_efficiency,
                 "device_idle_frac": p.device_idle_frac,
                 "window": drv.window, "steps": p.steps,
                 "flush_causes": dict(p.flush_causes),
                 "pack_s": drv.pack_seconds, "step_s": drv.step_seconds,
                 "pipeline_wall_s": pipe_wall, "run_wall_s": c["wall"]}
            # The window is no bound on overlap_efficiency: a batch's fill
            # span is charged as pack work, but the pipeline's wall counts
            # only its busy spans and the waits with rows staged, so a
            # fill that starts while the worker idles on an empty builder
            # lies outside that wall (the reference's accounting). What
            # holds: the step seconds lie within the pipeline's wall
            # (``device_idle_frac`` in [0, 1]), the fill spans of one
            # builder are disjoint and lie within the run, and the gauge
            # is the ratio of those counters.
            if pipe_wall <= 0.0 \
                    or not 0.0 <= h["device_idle_frac"] <= 1.0 \
                    or not h["overlap_efficiency"] > 0.0 \
                    or abs(h["overlap_efficiency"]
                           - (drv.pack_seconds + drv.step_seconds)
                           / pipe_wall) > 1e-9 \
                    or drv.pack_seconds > c["wall"]:
                fail(f"engine_observe (c): '{x.query_name}': {h}")
            health[x.query_name] = h
        c_probes = observe_probes("engine_observe (c)", c["rt"],
                                  c["launches"], n_s)

        # ---- (d) the flight recorder under faults
        d = host_engine_run(SiddhiManager(), OBSERVE_CHAOS + observed, ev,
                            card=True)
        add(d["launches"])
        rt = d["rt"]
        reps = guard_reports(rt)
        if not sum(r["failures"] for r in reps.values()) \
                or any(r["lost_events"] for r in reps.values()):
            fail(f"engine_observe (d): guards {reps}")
        breaker = rt.observability.flight_export("breaker")["entries"]
        device = rt.observability.flight_export("device")["entries"]
        flight = {}
        for q, r in reps.items():
            opened = [e for e in breaker if e["site"] == f"device:{q}"
                      and e["kind"] == "circuit:open"]
            failed = [e for e in device if e["site"] == q
                      and e["kind"] == "step_failed"]
            fell = [e for e in device if e["site"] == q
                    and e["kind"] == "fallback_step"]
            if len(opened) != r["failures"] or len(failed) != r["failures"] \
                    or bool(fell) != bool(r["failures"]):
                fail(f"engine_observe (d): '{q}': {len(opened)} circuit "
                     f"openings, {len(failed)} failed steps, {len(fell)} "
                     f"fallbacks on the recorder; guard {r}")
            flight[q] = {"failures": r["failures"],
                         "breaker_entries": sum(
                             e["site"] == f"device:{q}" for e in breaker),
                         "device_entries": sum(e["site"] == q
                                               for e in device)}
        every = rt.observability.flight_export()["entries"]
        if [e["t_ns"] for e in every] != sorted(e["t_ns"] for e in every):
            fail("engine_observe (d): flight entries out of time order")
        if not any(e["site"] == "device:chain" for e in breaker):
            fail("engine_observe (d): no device:chain breaker transition")
        # a quarantine dumps the ring as JSON (engine_guard (c)'s)
        dump_dir = os.path.join(scratch, "flight")
        B = quarantine_batch
        qapp = (f"@app:flightrecorder(dir='{dump_dir}')\n"
                "@app:chaos(seed='16', device.fail.p='1.0')\n"
                "@app:resilience(device.circuit.threshold='2', "
                "device.circuit.cooldown.ms='60000')\n"
                + ew.GUARD_FILTER.format(batch=B, extra=""))
        qev = ew.IotEvents(2 * B, seed + 2)
        m = SiddhiManager()
        qrt = filter_run(m, qapp, qev)
        m.shutdown()
        dumps = sorted(os.listdir(dump_dir)) if os.path.isdir(dump_dir) \
            else []
        if len(dumps) != 1:
            fail(f"engine_observe (d): {len(dumps)} flight dumps at the "
                 f"quarantine")
        with open(os.path.join(dump_dir, dumps[0])) as f:
            dump = json.load(f)
        kinds = [e["kind"] for e in dump["entries"]]
        if dump["reason"] != "device_quarantine" \
                or "quarantined" not in kinds or "step_failed" not in kinds:
            fail(f"engine_observe (d): the dump holds {dump['reason']} "
                 f"{kinds}")

        # ---- (e) the profiler on the chain alone, sync and async
        profile = profile_in_fresh_processes(seed, profile_events, scratch)
        for p in profile.values():
            launches[BlockPlan.__name__] = \
                launches.get(BlockPlan.__name__, 0) + p["launches"]
    finally:
        guard_log.setLevel(level)
        shutil.rmtree(scratch, ignore_errors=True)
    if not launches.get(BlockPlan.__name__) \
            or not launches.get(QueryPlan.__name__):
        fail(f"engine_observe: launches {launches}")
    out = {
        "phase": "engine_observe", "app": "iot_mixed", "events": n_events,
        "events_per_s": {"plain": ev.n / a["wall"],
                         "observed": ev.n / b["wall"],
                         "async_observed": ev.n / c["wall"],
                         "chaos_observed": ev.n / d["wall"]},
        "observed_over_plain": a["wall"] / b["wall"],
        "rows": {s: len(r) for s, r in a["rows"].items()},
        "rows_equal": True, "probes": probes, "async": {
            "health": health, "probes": c_probes},
        "flight": {"queries": flight, "breaker": len(breaker),
                   "device": len(device), "all": len(every),
                   "dump_entries": len(dump["entries"]),
                   "dump_reason": dump["reason"],
                   "quarantine_rows": len(qrt.got)},
        "profile": profile,
        "launches": {"nfa_block": launches[BlockPlan.__name__],
                     "query_step": launches[QueryPlan.__name__]},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# ------------------------------------------------------------ engine_columnar

COLUMNAR_EVENTS = 65_536           # (a): iot_mixed events a run
COLUMNAR_PAR_EVENTS = 65_536       # (b): the partitioned chain's events
COLUMNAR_PAR_CHUNK = 2_048         # (b): events a send_columns call
# (c): iot_mixed under chaos, a card run and a CPU run (cut from 65,536 for
# the CPU engine's run; at 32,768 events the seeded sites still fault: the
# chain at its steps 5 and 13 of 16, stats at its step 2 of 8)
COLUMNAR_CHAOS_EVENTS = 32_768
COLUMNAR_FILTER_EVENTS = 65_536    # (c): the filter's events (64 batches
COLUMNAR_FILTER_BATCH = 1_024      # of 1,024: faults at steps 36 and 46)
COLUMNAR_EDGE_ROWS = 262_144       # (d): the CSV file's rows
COLUMNAR_ANN = "@app:host_batch(batch='8192', lanes='16')\n"
COLUMNAR_CHAOS = "@app:chaos(seed='18', device.fail.p='0.05')\n"
# (b): tests/test_edge_rows.py's _PAR_APP
COLUMNAR_PAR_APP = """
@app(name='{name}')
@app:host_batch(batch='2048', lanes='8', workers='{workers}'{mode})
define stream S (dev string, v double);
partition with (dev of S)
begin
from every e1=S[v > 70.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 400
select e1.v as v1, e2.v as v2, e3.v as v3 insert into Alerts;
end;
"""


def tiers(rt) -> dict:
    """Which tier runs each query of ``rt``."""
    return {"device": sorted(b.query_name for b in rt.device_bridges),
            "columnar": sorted((b.kind, b.query_name)
                               for b in rt.host_bridges),
            "interpreter": sorted(rt.query_runtimes),
            "partitions": sorted(q.name() for p in rt.partition_runtimes
                                 for q in p.partition_ast.queries)}


def par_feed(n: int, seed: int) -> tuple:
    """(b)'s events: ``dev`` of 8 devices, ``v`` to three places, ``ts``
    rising by 1 ms (``test_edge_rows._pattern_feed``'s, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    dev = np.array([f"dev{k}" for k in range(8)], dtype=object)[
        rng.integers(0, 8, n)]
    return (dev, np.round(rng.uniform(0.0, 100.0, n), 3),
            1_000 + np.arange(n, dtype=np.int64))


def par_run(feed: tuple, workers: int, mode: str, name: str, lo: int = 0,
            hi: int | None = None, snapshot_at: int | None = None,
            restore: bytes | None = None) -> dict:
    """``COLUMNAR_PAR_APP`` over events ``lo:hi`` of ``feed`` in
    ``send_columns`` chunks, on the card's manager: its ``Alerts`` rows, the
    lane tier's ``match_count``, the first chunk's seconds (a process pool
    spawns its children there), the wall of the chunks after it, and the
    snapshot cut at event ``snapshot_at``. ``restore`` is restored before
    the first event."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    dev, v, ts = feed
    hi = len(ts) if hi is None else hi
    extra = f", workers.mode='{mode}'" if mode == "process" else ""
    m = SiddhiManager()
    try:
        rt = m.create_siddhi_app_runtime(COLUMNAR_PAR_APP.format(
            name=name, workers=workers, mode=extra), playback=True)
        rows = []
        rt.add_callback("Alerts", StreamCallback(lambda evs: rows.extend(
            (e.timestamp, tuple(e.data)) for e in evs)))
        rt.start()
        if restore is not None:
            rt.restore(restore)
        prt = rt.host_bridges[0].runtime.prt
        ih = rt.input_handler("S")
        blob = None
        t0 = t1 = time.perf_counter()
        for s in range(lo, hi, COLUMNAR_PAR_CHUNK):
            e = min(s + COLUMNAR_PAR_CHUNK, hi)
            ih.send_columns({"dev": dev[s:e], "v": v[s:e]}, ts[s:e])
            if s == lo:
                t1 = time.perf_counter()
            if snapshot_at is not None and e >= snapshot_at and blob is None:
                blob = rt.snapshot()
        rt.flush_host()
        wall = time.perf_counter() - t1
        pool = prt._proc_pool
        out = {"rows": rows, "matches": prt.match_count,
               "first_chunk_s": t1 - t0, "wall": wall,
               "timed_events": max(hi - lo - COLUMNAR_PAR_CHUNK, 0),
               "blob": blob, "threads": prt._pool is not None,
               "children": None if pool is None else pool.report()["alive"],
               "tiers": tiers(rt)}
    finally:
        m.shutdown()
    return out


def edge_csv(ev, path: str) -> None:
    """(d)'s file: ``ev`` as CSV lines in the columnar edge sample's layout
    ``symbol,price,volume,ts`` (``dev``, ``v``, ``room``): the events of
    ``iot_csv``, in the order of the sample's stream."""
    with open(path, "w") as f:
        f.write("".join(f"{d},{v!r},{r},{t}\n" for d, r, v, t in
                        zip(ev.dev, ev.room, ev.v, ev.ts)))


def edge_run(app: str, columnar: bool, topic: str) -> dict:
    """``samples/columnar_edge.py``'s app from its CSV file to its
    ``inMemory`` sink: the published rows, the wall from start to the
    source's drain, and the ``Event``/``StreamEvent`` objects built on the
    way (counted while the run lasts)."""
    from siddhi_tpu_torch import InMemoryBroker, SiddhiManager
    from siddhi_tpu_torch.core.event import Event, StreamEvent
    text = app if columnar else app.replace(
        "@app:host_batch(batch='4096')\n", "")
    text = text.replace("topic='high-price'", f"topic='{topic}'")
    rows = []

    def take(p):
        if hasattr(p, "rows"):            # a RowsChunk: columns, no events
            rows.extend(tuple(r) for r in p.rows(["symbol", "price"]))
        else:
            rows.append(tuple(p.data))

    unsub = InMemoryBroker.subscribe(topic, take)
    built = {"n": 0}
    inits = (StreamEvent.__init__, Event.__init__)

    def counted(init):
        def wrapper(self, *a, **k):
            built["n"] += 1
            init(self, *a, **k)
        return wrapper

    m = SiddhiManager()
    try:
        rt = m.create_siddhi_app_runtime(text, playback=True)
        StreamEvent.__init__, Event.__init__ = map(counted, inits)
        try:
            t0 = time.perf_counter()
            rt.start()
            if not rt.sources[0].wait_drained(600.0):
                fail("engine_columnar (d): the file source did not drain")
            rt.flush_host()
            wall = time.perf_counter() - t0
        finally:
            StreamEvent.__init__, Event.__init__ = inits
        out = {"rows": rows, "wall": wall, "objects": built["n"],
               "bridges": [b.query_name for b in rt.host_bridges],
               "parse_errors": rt.sources[0].mapper.parse_errors}
    finally:
        unsub()
        m.shutdown()
    return out


def sample_template(name: str) -> str:
    """``samples/<name>.py``'s ``APP`` f-string as a ``str.format``
    template (read as data: the sample imports the JAX package)."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, "samples",
                                       f"{name}.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "APP":
            return "".join(
                v.value.replace("{", "{{").replace("}", "}}")
                if isinstance(v, ast.Constant)
                else "{" + ast.unparse(v.value) + "}"
                for v in node.value.values)
    fail(f"engine_columnar (d): samples/{name}.py has no APP")


def phase_engine_columnar(seed: int, n_events: int = COLUMNAR_EVENTS,
                          par_events: int = COLUMNAR_PAR_EVENTS,
                          chaos_events: int = COLUMNAR_CHAOS_EVENTS,
                          filter_events: int = COLUMNAR_FILTER_EVENTS,
                          edge_rows: int = COLUMNAR_EDGE_ROWS,
                          widths: dict | None = None) -> dict:
    """The columnar host tier beside the kernels: (a) ``iot_mixed`` under
    ``@app:host_batch(batch='8192', lanes='16')``, each query on the tier
    the CPU engine gives it and every output equal to the plain run's; (b)
    the partitioned chain of the parallel lane tier with 1 worker, 4
    threads and 4 processes, equal rows and matches, and a snapshot cut
    under 2 workers resumed under 4; (c) the guard's columnar fallback on
    the card under ``@app:chaos(seed='18', device.fail.p='0.05')``, over a
    filter and over ``iot_mixed``; (d) the columnar edge sample from a
    CSV file to its sink without an ``Event``. ``widths`` (``iot_mixed``'s)
    and the event counts shrink it for a rehearsal on the CPU."""
    import logging
    import shutil
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    if not torch.cuda.is_available():
        fail("engine_columnar: no CUDA device")
    t_phase = time.perf_counter()
    guard_log = logging.getLogger("siddhi_tpu_torch.resilience")
    level = guard_log.level
    guard_log.setLevel(logging.ERROR)
    records = ErrorRecords()
    launches = {}
    scratch = io_scratch()

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    try:
        # ---- (a) iot_mixed with its host queries on the columnar tier
        plain_app = ew.iot_mixed_app(**(widths or {}))
        app = COLUMNAR_ANN + plain_app
        ev = ew.IotEvents(n_events, seed)
        plain = host_engine_run(SiddhiManager(), plain_app, ev, card=True)
        col = host_engine_run(SiddhiManager(), app, ev, card=True)
        add(col["launches"])
        m = SiddhiManager(device="cpu")
        cpu_tiers = tiers(m.create_siddhi_app_runtime(app, playback=True))
        m.shutdown()
        expect = {"device": ["chain", "stats"],
                  "columnar": [("host_stream", "alert_rate"),
                               ("host_stream", "clean")],
                  "interpreter": ["top"], "partitions": ["room_peak"]}
        got_tiers = tiers(col["rt"])
        if got_tiers != cpu_tiers or got_tiers != expect:
            fail(f"engine_columnar (a): tiers {got_tiers}, on the CPU "
                 f"{cpu_tiers}")
        if col["errors"] or plain["errors"]:
            fail(f"engine_columnar (a): receiver errors {col['errors']} / "
                 f"{plain['errors']}")
        alert_rate = "equal"
        for s in ew.IOT_OUTS:
            if col["rows"][s] == plain["rows"][s]:
                continue
            if s == "AlertRate":
                # alert_rate runs on the columnar tier, whose time window
                # expires by the alerts' own times and never by the
                # playback clock's timers: the plain window over its
                # alerts as they arrived, no timer firing
                want = alert_rate_rows(
                    [(t, 0, None) for t, _ in col["rows"]["Alerts"]])
                if col["rows"][s] == want:
                    alert_rate = "held to alert_rate_rows"
                    continue
            fail(f"engine_columnar (a): {s}: {len(col['rows'][s])} rows "
                 f"under @app:host_batch, {len(plain['rows'][s])} "
                 f"without: they differ")
        if not col["launches"][BlockPlan.__name__] \
                or not col["launches"][QueryPlan.__name__]:
            fail(f"engine_columnar (a): launches {col['launches']}")
        hb = {b.query_name: {"events": b.events_in, "batches": b.batches}
              for b in col["rt"].host_bridges}

        # ---- (b) the parallel lane tier: 1 worker, 4 threads, 4 processes
        feed = par_feed(par_events, seed)
        par = {}
        for label, workers, mode in (("workers_1", 1, "thread"),
                                     ("threads_4", 4, "thread"),
                                     ("processes_4", 4, "process")):
            par[label] = par_run(feed, workers, mode, f"par-{label}")
        base = par["workers_1"]
        if not base["matches"] or base["matches"] != len(base["rows"]):
            fail(f"engine_columnar (b): {base['matches']} matches, "
                 f"{len(base['rows'])} rows")
        for label, r in par.items():
            if r["rows"] != base["rows"] or r["matches"] != base["matches"]:
                fail(f"engine_columnar (b) {label}: {len(r['rows'])} rows, "
                     f"{r['matches']} matches; 1 worker: "
                     f"{len(base['rows'])}, {base['matches']}")
            if r["tiers"]["columnar"] != [("host_partition",
                                           "partition-1-query-0")]:
                fail(f"engine_columnar (b) {label}: tiers {r['tiers']}")
        if not par["threads_4"]["threads"] \
                or par["processes_4"]["children"] != 4:
            fail(f"engine_columnar (b): thread pool "
                 f"{par['threads_4']['threads']}, "
                 f"{par['processes_4']['children']} lane children")
        cut = par_events // 2
        first = par_run(feed, 2, "thread", "par-snap-a", 0, cut,
                        snapshot_at=cut)
        second = par_run(feed, 4, "thread", "par-snap-b", cut,
                         restore=first["blob"])
        if first["rows"] + second["rows"] != base["rows"]:
            fail(f"engine_columnar (b): the snapshot cut under 2 workers "
                 f"and resumed under 4 gives {len(first['rows'])} + "
                 f"{len(second['rows'])} rows, the uninterrupted run "
                 f"{len(base['rows'])}")

        # ---- (c) the guard's columnar fallback on the card
        fev = ew.IotEvents(filter_events, seed + 1)
        text = ew.GUARD_FILTER.format(batch=COLUMNAR_FILTER_BATCH, extra="")
        faulted = (COLUMNAR_CHAOS
                   + "@app:resilience(device.circuit.threshold='1000')\n"
                   + text)
        clean = filter_run(SiddhiManager(), text, fev)
        m = SiddhiManager()
        torch.cuda.synchronize()
        reset_launches()
        frt = filter_run(m, faulted, fev)
        torch.cuda.synchronize()
        add(read_launches())
        m.shutdown()
        f_rep = guard_reports(frt)
        engines = {}
        for name, r in f_rep.items():
            if not r["failures"] or r["lost_events"] \
                    or r["fallback_engine"] != "columnar":
                fail(f"engine_columnar (c) filter: guard '{name}': {r}")
            engines[f"filter/{name}"] = r["fallback_engine"]
        if f32_rows(frt.got) != f32_rows(clean.got):
            fail(f"engine_columnar (c) filter: {len(frt.got)} rows, the "
                 f"run without faults {len(clean.got)}: (dev, float32 v) "
                 f"differ")
        cev = ew.IotEvents(chaos_events, seed + 3)
        capp = COLUMNAR_CHAOS + "@app:resilience(" \
            "device.circuit.threshold='1000')\n" + plain_app
        card = host_engine_run(SiddhiManager(), capp, cev, card=True)
        add(card["launches"])
        cpu = host_engine_run(SiddhiManager(device="cpu"), capp, cev,
                              card=False)
        c_rep, cpu_rep = guard_reports(card["rt"]), guard_reports(cpu["rt"])
        # the engine the reference's columnar tier gives each query: the
        # chain lowers; a windowed group-by (stats) keeps the interpreter
        want_engine = {"chain": "columnar", "stats": "scalar"}
        for name, r in c_rep.items():
            if r["lost_events"] or r != cpu_rep[name] or (
                    r["failures"]
                    and r["fallback_engine"] != want_engine[name]):
                fail(f"engine_columnar (c) iot_mixed: guard '{name}': "
                     f"card {r}, CPU {cpu_rep[name]}")
            if r["failures"]:
                engines[f"iot_mixed/{name}"] = r["fallback_engine"]
        if not c_rep["chain"]["failures"]:
            fail(f"engine_columnar (c) iot_mixed: the chain never faulted: "
                 f"{c_rep}")
        for s in ("Alerts", "AlertRate", "Top", "RoomPeak"):
            if card["rows"][s] != cpu["rows"][s]:
                fail(f"engine_columnar (c) iot_mixed: {s}: "
                     f"{len(card['rows'][s])} rows on the card, "
                     f"{len(cpu['rows'][s])} on the CPU: they differ")
        q = plan_of(next(b for b in card["rt"].device_bridges
                         if b.query_name == "stats").runtime)
        close_rows(query_shapes_module(), q, cpu["scale"],
                   cpu["rows"]["Stats"], card["rows"]["Stats"],
                   "engine_columnar (c) Stats (card vs CPU)")

        # ---- (d) the columnar edge: CSV file → columns → sink
        dev_ = ew.IotEvents(edge_rows, seed + 4)
        path = os.path.join(scratch, "ticks.csv")
        edge_csv(dev_, path)
        eapp = sample_template("columnar_edge").format(csv_path=path)
        scalar = edge_run(eapp, False, "edge-scalar")
        edge = edge_run(eapp, True, "edge-columnar")
        if edge["objects"] or edge["bridges"] != ["filterQuery"] \
                or scalar["bridges"]:
            fail(f"engine_columnar (d): {edge['objects']} Event/StreamEvent "
                 f"objects built, columnar bridges {edge['bridges']} / "
                 f"{scalar['bridges']}")
        if edge["rows"] != scalar["rows"] or not edge["rows"] \
                or edge["parse_errors"] or scalar["parse_errors"]:
            fail(f"engine_columnar (d): {len(edge['rows'])} rows published, "
                 f"the scalar run {len(scalar['rows'])}: they differ")
        records.check("engine_columnar")
    finally:
        records.close()
        guard_log.setLevel(level)
        shutil.rmtree(scratch, ignore_errors=True)
    if not launches.get(BlockPlan.__name__) \
            or not launches.get(QueryPlan.__name__):
        fail(f"engine_columnar: launches {launches}")
    out = {
        "phase": "engine_columnar", "app": "iot_mixed + host_batch",
        "events": n_events,
        "tiers": {k: v for k, v in got_tiers.items()},
        "host_bridges": hb,
        "events_per_s": {"plain": ev.n / plain["wall"],
                         "host_batch": ev.n / col["wall"]},
        "rows": {s: len(r) for s, r in col["rows"].items()},
        "rows_equal_to_plain": True, "alert_rate": alert_rate,
        "parallel": {"events": par_events, "matches": base["matches"],
                     # after the first chunk, whose seconds are apart
                     "events_per_s": {k: r["timed_events"] / r["wall"]
                                      for k, r in par.items()},
                     "first_chunk_s": {k: r["first_chunk_s"]
                                       for k, r in par.items()},
                     "snapshot_2_to_4_equal": True},
        "guard": {"fallback_engines": engines,
                  "filter": {"events": fev.n, "guards": f_rep,
                             "rows": len(frt.got)},
                  "iot_mixed": {"events": cev.n, "guards": c_rep,
                                "equal_to_cpu_engine": True}},
        "edge": {"rows": edge_rows, "published": len(edge["rows"]),
                 "objects": edge["objects"],
                 "events_per_s": edge_rows / edge["wall"],
                 "scalar_events_per_s": edge_rows / scalar["wall"]},
        "launches": {"nfa_block": launches[BlockPlan.__name__],
                     "query_step": launches[QueryPlan.__name__]},
        "error_records": 0, "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out

FLEET_EVENTS = 12_000              # (a): the rule fleet's feed
FLEET_PATTERN_EVENTS = 4_000       # (b): the pattern fleet's feed
FLEET_SLO_EVENTS = 24_000          # (d): the storm's feed
FLEET_POISON_EVENTS = 4_000        # (d): the poisoned fleet's feed
FLEET_JOIN_EVENTS = 20_000         # (e): the market join's events
FLEET_PATTERN_STEPS = 2            # (c): the chain plan's wire batches
FLEET_SOLO_PATTERN = 4             # (b): tenants of the solo columnar run
FLEET_POISON_TENANT = 3
FLEET_POISON_CHAOS = "@app:chaos(seed='19', fleet.fault.p='0.25')\n"


def fleet_counts(rows: list) -> list:
    return [len(r) for r in rows]


def check_fleet_rows(where: str, ref: list, got: list, ordered: bool = True):
    for i, (a, b) in enumerate(zip(ref, got)):
        if (a if ordered else sorted(a)) != (b if ordered else sorted(b)):
            fail(f"engine_fleet {where}: tenant {i}: {len(b)} rows differ "
                 f"from the {len(a)} expected"
                 f"{'' if ordered else ' (as multisets)'}")
    if len(ref) != len(got):
        fail(f"engine_fleet {where}: {len(got)} tenants, {len(ref)} expected")


def fleet_rule_plan(m, make, feed, check_counts, label: str) -> dict:
    """(c) for a single-stream shape: every tenant's device plan from the
    cache (one build, 15 hits), stepped on the card through B5a over the
    interleaved tenants' rows, each step against the plain version; each
    tenant's accepted rows (its ``dev``: tenant i's rule reads
    ``dev{i}``) counted against ``check_counts``."""
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.fleet.shape import normalize_query
    from siddhi_tpu_torch.gpu.query_compile import stream_step_plain
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    T = len(check_counts)
    c0 = m.fleet.stats()["cache"]
    nqs, plans = [], []
    for i in range(T):
        app = parse(make(i, fw.FLEET_ANN))
        defs = dict(app.stream_definitions)
        nq = normalize_query(app.queries[0], defs)
        nqs.append(nq)
        plans.append(m.fleet.device_plan(nq, defs))
    c1 = m.fleet.stats()["cache"]
    q = plans[0]
    if any(p is not q for p in plans) or c1["misses"] - c0["misses"] != 1 \
            or c1["hits"] - c0["hits"] != T - 1:
        fail(f"engine_fleet (c) {label}: {c1['misses'] - c0['misses']} "
             f"builds and {c1['hits'] - c0['hits']} hits for {T} tenants")
    pkeys = [k for k in q.plan.col_keys if k.startswith("__fleet_p")]
    if not pkeys or q.device.type != "cuda":
        fail(f"engine_fleet (c) {label}: the plan reads no parameter column "
             f"({q.plan.col_keys}) or is not on the card ({q.device})")
    dic = q.schema.dictionaries["dev"]
    params = [fw.tenant_params(nqs[i], dic, i) for i in range(T)]
    state = q.init_state()
    counts = [0] * T
    worst, steps, ms, plain_ms = 0.0, 0, [], []
    l0 = type(q.plan).launches
    for batch, _mids in fw.interleaved_rule_batches(q, nqs[0], params,
                                                     feed):
        cols, ts, valid = q.batch_tensors(batch)
        t0 = time.perf_counter()
        ref_state, ref = stream_step_plain(q, state, cols, ts, valid)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        new_state, out = q.step_tensors(state, cols, ts, valid)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        ok, err, bad = compare({"state": ref_state, "out": ref},
                               {"state": new_state, "out": out})
        if not ok:
            fail(f"engine_fleet (c) {label}: step {steps}: the kernel "
                 f"differs from the plain version at {bad} (err {err})")
        worst = max(worst, err)
        v = out["valid"].cpu().numpy()
        for code in out["out"]["dev"].cpu().numpy()[v].tolist():
            counts[int(dic.decode(int(code))[3:])] += 1
        state = new_state
        steps += 1
    if counts != list(check_counts):
        fail(f"engine_fleet (c) {label}: per-tenant counts {counts}, the "
             f"host group's {list(check_counts)}")
    return {"shape": nqs[0].shape_key, "param_columns": pkeys,
            "steps": steps, "launches": type(q.plan).launches - l0,
            "rows": sum(counts), "max_abs_err": worst,
            "kernel_step_ms_median": float(np.median(ms)),
            "plain_step_ms_median": float(np.median(plain_ms)),
            "cache": {"builds": c1["misses"] - c0["misses"],
                      "hits": c1["hits"] - c0["hits"]}}


def fleet_pattern_plan(m, feed, check_counts) -> dict:
    """(c) for the partitioned chain: the shared blocked plan (one build,
    15 hits) stepped on the card through B1, one lane a (tenant,
    device-hash lane), every step against the plain version; each tenant's
    matches against the host group's rows where its ``within`` is the
    plan's."""
    import torch
    from siddhi_tpu_torch.compiler import parse
    from siddhi_tpu_torch.fleet.shape import normalize_partition_query
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan, block_step_plain
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    T = len(check_counts)
    c0 = m.fleet.stats()["cache"]
    nqs, plans = [], []
    for i in range(T):
        app = parse(fw.tenant_pattern_app(i, fw.FLEET_ANN))
        defs = dict(app.stream_definitions)
        part = app.partitions[0]
        nq = normalize_partition_query(part, part.queries[0], defs)
        nqs.append(nq)
        plans.append(m.fleet.device_plan(nq, defs))
    c1 = m.fleet.stats()["cache"]
    comp = plans[0]
    if any(p is not comp for p in plans) \
            or c1["misses"] - c0["misses"] != 1 \
            or c1["hits"] - c0["hits"] != T - 1:
        fail(f"engine_fleet (c) chain: {c1['misses'] - c0['misses']} builds "
             f"and {c1['hits'] - c0['hits']} hits for {T} tenants")
    pkeys = [k for k in comp.plan.col_keys if k.startswith("__fleet_p")]
    if not comp.blocked or not pkeys or comp.device.type != "cuda":
        fail(f"engine_fleet (c) chain: blocked {comp.blocked}, parameter "
             f"columns {pkeys}, device {comp.device}")
    dic = comp.merged.dictionaries[next(k for k in comp.used_cols
                                        if k.endswith("_dev"))]
    params = [fw.tenant_params(nqs[i], dic, i) for i in range(T)]
    lanes = fw.HOST_LANES
    step = comp.make_step()
    state = comp.init_state(T * lanes)
    worst, steps, ms, plain_ms = 0.0, 0, [], []
    l0 = BlockPlan.launches
    dev = comp.device
    for wire in fw.pattern_lane_batches(comp, nqs[0], params, feed, lanes,
                                        FLEET_PATTERN_STEPS):
        cols = {k: torch.from_numpy(v).to(dev) for k, v in wire[0].items()}
        rest = [torch.from_numpy(a).to(dev) for a in wire[1:]]
        t0 = time.perf_counter()
        ref_state, ref_ys = block_step_plain(comp, clone(state), cols, *rest)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        state, ys = step(state, cols, *rest)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        ok, err, bad = compare({"state": ref_state, "ys": ref_ys},
                               {"state": state, "ys": ys})
        if not ok:
            fail(f"engine_fleet (c) chain: step {steps}: the kernel differs "
                 f"from the plain version at {bad} (err {err})")
        worst = max(worst, err)
        steps += 1
    matches = state["matches"].cpu().numpy().reshape(T, lanes).sum(1)
    drops = int(state["drops"].sum())
    within0 = nqs[0].overrides.get("within")
    same = [i for i in range(T) if nqs[i].overrides.get("within") == within0]
    if drops or any(int(matches[i]) != check_counts[i] for i in same):
        fail(f"engine_fleet (c) chain: matches {matches.tolist()} (drops "
             f"{drops}), the host group's {list(check_counts)} for tenants "
             f"{same}")
    return {"shape": nqs[0].shape_key, "param_columns": pkeys,
            "steps": steps, "lanes": T * lanes,
            "launches": BlockPlan.launches - l0,
            "matches": int(matches.sum()), "tenants_checked": same,
            "max_abs_err": worst,
            "kernel_step_ms_median": float(np.median(ms)),
            "plain_step_ms_median": float(np.median(plain_ms)),
            "cache": {"builds": c1["misses"] - c0["misses"],
                      "hits": c1["hits"] - c0["hits"]}}


def fleet_storm(seed: int, n_events: int) -> dict:
    """(d): the reference bench's ``--slo-child`` storm on the port."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    T = fw.SLO_TENANTS
    feed = fw.gen_events(n_events, seed)
    rows = [[d, v] for d, v, _ in feed]
    tss = [t for _, _, t in feed]
    m = SiddhiManager()
    apps, counts = [], [0] * T
    for i in range(T):
        rt = m.create_siddhi_app_runtime(fw.tenant_rule_app(i, fw.slo_ann(i)),
                                         playback=True)
        rt.add_callback("Alerts", StreamCallback(
            lambda evs, i=i: counts.__setitem__(i, counts[i] + len(evs))))
        rt.start()
        apps.append(rt)
    ihs = [rt.input_handler("S") for rt in apps]
    burster = T - 1
    group = apps[0].fleet_bridges[0].member.group
    ctrl = group.slo
    window_initial = group.effective_window()

    def storm(lo: int, hi: int) -> None:
        for s in range(lo, hi, fw.SLO_CHUNK):
            c, t = rows[s:s + fw.SLO_CHUNK], tss[s:s + fw.SLO_CHUNK]
            for j, ih in enumerate(ihs):
                for _ in range(fw.SLO_BURST if j == burster else 1):
                    ih.send_rows([list(r) for r in c], list(t))

    t0 = time.perf_counter()
    split = int(n_events * 0.4)
    storm(0, split)
    last_d, t_stable, extra = ctrl.decisions, time.perf_counter(), 0
    while time.perf_counter() - t_stable < 0.4 and extra < n_events:
        lo = extra % max(split - fw.SLO_CHUNK, 1)
        storm(lo, lo + fw.SLO_CHUNK)
        extra += fw.SLO_CHUNK
        if ctrl.decisions != last_d:
            last_d, t_stable = ctrl.decisions, time.perf_counter()
    settled_chk = {p: h.checkpoint() for p, h in ctrl.evidence.hist.items()}
    storm(split, n_events)
    for rt in apps:
        rt.flush_host()
    quiet = ctrl.evidence.window()
    ctrl.maybe_evaluate(force=True)
    wall = time.perf_counter() - t0
    settled = {p: ctrl.evidence.hist[p].since(settled_chk[p])
               for p in ctrl.evidence.hist}
    e2e = quiet["end_to_end"] \
        if quiet["end_to_end"]["count"] >= 4096 else settled["end_to_end"]
    by_class = {}
    for i, rt in enumerate(apps):
        mem = rt.fleet_bridges[0].member
        k = fw.slo_class(i)
        d = by_class.setdefault(k, {"tenants": 0, "shed": 0, "p99_ms": 0.0})
        d["tenants"] += 1
        d["shed"] += mem.lane.shed
        if mem.slo is not None:
            d["p99_ms"] = max(d["p99_ms"], mem.slo.last_p99_ms)
    trail = apps[0].ctx.flight.export(category="slo")
    kinds = [e["kind"][len("decision:"):] for e in trail
             if e["kind"].startswith("decision:")]
    out = {"tenants": T, "events": n_events, "burst": fw.SLO_BURST,
           "budget_ms": fw.SLO_BUDGET_MS,
           "offered_events": (n_events + extra) * (T - 1 + fw.SLO_BURST),
           "events_per_s": (n_events + extra) * (T - 1 + fw.SLO_BURST) / wall,
           "group_p99_ms": e2e["p99"] * 1e3,
           "settled_fill_wait_p99_ms": settled["fill_wait"]["p99"] * 1e3,
           "settled_step_p99_ms": settled["step"]["p99"] * 1e3,
           "in_budget": e2e["p99"] * 1e3 <= fw.SLO_BUDGET_MS,
           "by_class": by_class, "decisions": ctrl.decisions,
           "decision_kinds": kinds[:12],
           "window": [window_initial, group.effective_window()],
           "matches": sum(counts), "wall_s": wall}
    m.shutdown()
    if not out["decisions"]:
        fail(f"engine_fleet (d): the controller took no decision: {out}")
    if by_class["premium"]["shed"]:
        fail(f"engine_fleet (d): premium tenants shed: {out}")
    if not by_class["besteffort"]["shed"]:
        fail(f"engine_fleet (d): the burster shed nothing: {out}")
    return out


def fleet_poison(seed: int, n_events: int) -> dict:
    """(d): a tenant fed non-finite rows under ``@app:chaos(fleet.fault.p=
    ...)`` ejects to its solo tier; its co-tenants' rows equal a clean
    run's."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    T, bad = fw.TENANTS, FLEET_POISON_TENANT
    feed = fw.gen_events(n_events, seed + 1)

    def texts(poisoned: bool):
        return [fw.tenant_rule_app(
            i, (FLEET_POISON_CHAOS if poisoned and i == bad else "")
            + "@app:fleet(batch='8192', lanes='24', guard.cooldown.ms='1', "
              "guard.readmit.batches='1')\n") for i in range(T)]

    def nan_rows(s: int, part: list) -> list:
        if (s // fw.TENANT_CHUNK) % 8 == 0:
            part[0] = [part[0][0], float("nan")]
        return part

    m = SiddhiManager()
    clean = fw.run_tenants(m, texts(False), feed, fw.TENANT_CHUNK)
    m.shutdown()
    m = SiddhiManager()
    hit = fw.run_tenants(m, texts(True), feed, fw.TENANT_CHUNK,
                         poison={bad: nan_rows})
    lane = hit["apps"][bad].fleet_bridges[0].member.lane
    rep = lane.report()
    others = [i for i in range(T) if i != bad]
    check_fleet_rows("(d) co-tenants under a poisoned tenant",
                     [clean["rows"][i] for i in others],
                     [hit["rows"][i] for i in others])
    innocent = [hit["apps"][i].fleet_bridges[0].member.lane for i in others]
    m.shutdown()
    if not rep["ejections"] or not rep["poisoned"] or \
            any(x.ejections or x.poisoned for x in innocent):
        fail(f"engine_fleet (d): the poisoned tenant's lane {rep}, the "
             f"others' ejections {[x.ejections for x in innocent]}")
    return {"tenant": bad, "events": n_events, "lane": rep,
            "cotenants_equal_to_clean_run": True}


def fleet_join_fallback(seed: int, n_events: int) -> dict:
    """(e): a tenant app with a fleet rule and the market join under
    ``@device``: the rule enrolls in its shape group, the join (no fleet
    shape) takes the device tier and launches B6; its rows equal the CPU
    engine's."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.gpu.join_step import JoinPlan
    from siddhi_tpu_torch.tools import engine_workloads as ew
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    cfg = ew.engine_config("market_join")
    rule = fw.tenant_rule_app(1, "")
    body = rule.split("define stream S", 1)[1]
    app = ("@app(name='market-tenant')\n" + fw.FLEET_ANN
           + "define stream S" + body + cfg["app"])
    ev = ew.EngineEvents("market_join", n_events, seed)
    feed = fw.gen_events(n_events // 4, seed)
    runs = {}
    for where, m in (("card", SiddhiManager()),
                     ("cpu", SiddhiManager(device="cpu"))):
        rt = m.create_siddhi_app_runtime(app, playback=True)
        got = {"O": [], "Alerts": []}
        for s in got:
            rt.add_callback(s, StreamCallback(
                lambda evs, s=s: got[s].extend(tuple(e.data) for e in evs)))
        rt.start()
        l0 = JoinPlan.launches
        t0 = time.perf_counter()
        k = 0
        for i, (sid, row, ts) in enumerate(ev.per_event()):
            rt.input_handler(sid).send(list(row), timestamp=ts)
            if i % 4 == 0 and k < len(feed):
                d, v, _t = feed[k]
                rt.input_handler("S").send([d, v], timestamp=ts)
                k += 1
        rt.flush_device()
        rt.flush_host()
        wall = time.perf_counter() - t0
        runs[where] = {"rows": got, "launches": JoinPlan.launches - l0,
                       "device": [b.query_name for b in rt.device_bridges],
                       "fleet": [b.query_name for b in rt.fleet_bridges],
                       "wall": wall}
        m.shutdown()
    card, cpu = runs["card"], runs["cpu"]
    if len(card["device"]) != 1:
        fail(f"engine_fleet (e): device bridges {card['device']}")
    if card["fleet"] != ["rule"] or not card["launches"]:
        fail(f"engine_fleet (e): fleet bridges {card['fleet']}, B6 "
             f"launches {card['launches']}")
    if card["rows"] != cpu["rows"] or not card["rows"]["O"]:
        fail(f"engine_fleet (e): {len(card['rows']['O'])} join rows and "
             f"{len(card['rows']['Alerts'])} alerts on the card, "
             f"{len(cpu['rows']['O'])} and {len(cpu['rows']['Alerts'])} on "
             f"the CPU engine")
    return {"events": n_events, "join_rows": len(card["rows"]["O"]),
            "alerts": len(card["rows"]["Alerts"]),
            "device_bridges": card["device"], "fleet_bridges": card["fleet"],
            "join_launches": card["launches"],
            "events_per_s": (n_events + len(feed)) / card["wall"],
            "rows_equal_to_cpu_engine": True}


def phase_engine_fleet(seed: int, rule_events: int = FLEET_EVENTS,
                       pattern_events: int = FLEET_PATTERN_EVENTS,
                       slo_events: int = FLEET_SLO_EVENTS,
                       poison_events: int = FLEET_POISON_EVENTS,
                       join_events_n: int = FLEET_JOIN_EVENTS) -> dict:
    """The multi-tenant fleet tier beside the kernels (module docstring,
    phase 18); the event counts shrink it for a rehearsal on the CPU."""
    import logging
    import torch
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.gpu.join_step import JoinPlan
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.query_step import QueryPlan
    from siddhi_tpu_torch.tools import fleet_workloads as fw
    if not torch.cuda.is_available():
        fail("engine_fleet: no CUDA device")
    t_phase = time.perf_counter()
    guard_log = logging.getLogger("siddhi_tpu_torch.resilience")
    level = guard_log.level
    guard_log.setLevel(logging.ERROR)
    records = ErrorRecords()
    T = fw.TENANTS
    l0 = {c.__name__: c.launches for c in (BlockPlan, QueryPlan, JoinPlan)}
    try:
        # ---- (a) the rule fleet against solo columnar and the interpreter
        feed = fw.gen_events(rule_events, seed)
        runs, mgrs = {}, {}
        for mode, ann in (("fleet", fw.FLEET_ANN), ("solo", fw.SOLO_ANN),
                          ("interpreter", "")):
            m = SiddhiManager()
            r = fw.run_tenants(m, [fw.tenant_rule_app(i, ann)
                                   for i in range(T)], feed, fw.TENANT_CHUNK)
            apps = r["apps"]
            if mode == "fleet":
                st = m.fleet.stats()
                tiers_ok = all(len(a.fleet_bridges) == 1 for a in apps)
                r["compiles"] = st["cache"]["per_backend"].get("numpy", 0)
                r["steps"] = sum(g["steps"] for g in st["groups"].values())
            elif mode == "solo":
                tiers_ok = all(len(a.host_bridges) == 1 for a in apps)
                r["compiles"] = sum(len(a.host_bridges) for a in apps)
                r["steps"] = sum(b.batches for a in apps
                                 for b in a.host_bridges)
            else:
                tiers_ok = all(a.query_runtimes and not a.host_bridges
                               for a in apps)
                r["compiles"], r["steps"] = 0, 0
            if not tiers_ok:
                fail(f"engine_fleet (a): the {mode} run's tenants are not "
                     f"on that tier")
            runs[mode] = r
            mgrs[mode] = m
        for mode in ("solo", "interpreter"):
            check_fleet_rows(f"(a) fleet against {mode}",
                             runs[mode]["rows"], runs["fleet"]["rows"])
        rule_counts = fleet_counts(runs["fleet"]["rows"])
        if not sum(rule_counts):
            fail(f"engine_fleet (a): no alert: {rule_counts}")
        a_out = {mode: {"compiles": r["compiles"], "steps": r["steps"],
                        "events_per_s": T * rule_events / r["wall"]}
                 for mode, r in runs.items()}
        # ---- (c) the rule's shared device plan on the card (B5a)
        c_rule = fleet_rule_plan(mgrs["fleet"], fw.tenant_rule_app, feed,
                                 rule_counts, "rule")
        for mode in ("solo", "interpreter"):
            mgrs.pop(mode).shutdown()
        # the having rule: its host group's counts, then its device plan
        mh = SiddhiManager()
        hrun = fw.run_tenants(mh, [fw.tenant_having_app(i, fw.FLEET_ANN)
                                   for i in range(T)], feed, fw.TENANT_CHUNK)
        c_having = fleet_rule_plan(mh, fw.tenant_having_app, feed,
                                   fleet_counts(hrun["rows"]), "having")
        mh.shutdown()
        mgrs.pop("fleet").shutdown()
        # ---- (b) the pattern fleet against solo columnar and the
        # interpreter
        pfeed = fw.gen_events(pattern_events, seed + 2)
        pruns = {}
        for mode, ann in (("fleet", fw.FLEET_ANN), ("solo", fw.SOLO_ANN),
                          ("interpreter", "")):
            m = SiddhiManager()
            # the solo columnar tier steps each tenant's 16-event chunks
            # over its 24 lanes: the first FLEET_SOLO_PATTERN tenants (all
            # four `within`s) hold the phase's time
            k = FLEET_SOLO_PATTERN if mode == "solo" else T
            r = fw.run_tenants(m, [fw.tenant_pattern_app(i, ann)
                                   for i in range(k)], pfeed,
                               fw.TENANT_CHUNK)
            if mode == "fleet" and not all(
                    len(a.fleet_bridges) == 1 for a in r["apps"]):
                fail("engine_fleet (b): the pattern tenants are not on the "
                     "fleet tier")
            pruns[mode] = r
            mgrs[mode] = m
        check_fleet_rows("(b) fleet against solo", pruns["solo"]["rows"],
                         pruns["fleet"]["rows"][:FLEET_SOLO_PATTERN])
        check_fleet_rows("(b) fleet against the interpreter",
                         pruns["interpreter"]["rows"],
                         pruns["fleet"]["rows"], ordered=False)
        pattern_counts = fleet_counts(pruns["fleet"]["rows"])
        if not sum(pattern_counts):
            fail(f"engine_fleet (b): no match: {pattern_counts}")
        b_out = {mode: {"tenants": len(r["apps"]), "events_per_s":
                        len(r["apps"]) * pattern_events / r["wall"]}
                 for mode, r in pruns.items()}
        b_out["matches"] = pattern_counts
        # ---- (c) the chain's shared device plan on the card (B1)
        c_chain = fleet_pattern_plan(mgrs["fleet"], pfeed, pattern_counts)
        for m in mgrs.values():
            m.shutdown()
        # ---- (d) the SLO storm, and a poisoned tenant
        d_out = fleet_storm(seed, slo_events)
        d_poison = fleet_poison(seed, poison_events)
        # ---- (e) the solo fallback of a join on the card (B6)
        e_out = fleet_join_fallback(seed, join_events_n)
        records.check("engine_fleet")
    finally:
        records.close()
        guard_log.setLevel(level)
    launches = {"query_step": QueryPlan.launches - l0["QueryPlan"],
                "nfa_block": BlockPlan.launches - l0["BlockPlan"],
                "join_step": JoinPlan.launches - l0["JoinPlan"]}
    if not c_rule["launches"] or not c_having["launches"] \
            or not c_chain["launches"] or not launches["join_step"]:
        fail(f"engine_fleet: launches {launches}")
    out = {"phase": "engine_fleet", "tenants": T,
           "rule_fleet": {"events": rule_events, **a_out,
                          "rows_equal": True, "alerts": sum(rule_counts)},
           "pattern_fleet": {"events": pattern_events, **b_out,
                             "rows_equal": True},
           "device_plans": {"rule": c_rule, "having": c_having,
                            "chain": c_chain},
           "slo_storm": d_out, "poisoned_tenant": d_poison,
           "solo_fallback": e_out, "launches": launches,
           "error_records": 0, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ------------------------------------------------------------ distribution

DCN_EVENTS = 2_000_000             # (b): events into host 0
DCN_LANES = 64                     # global lanes: 32 a shard over two hosts
DCN_WIDTHS = dict(slot_capacity=64, lane_batch=2048)
DCN_CHUNK = 16_384                 # events an ingest_chunk call
DCN_ORACLE_EVENTS = 20_000         # (b): the interpreter's prefix
DCN_TWIN_EVENTS = 131_072          # (b): the plain twin's prefix
DCN_FAILOVER_CHUNK = 8_192         # (c): events an ingest_chunk call
DCN_FAILOVER_CHUNKS = (1, 1, 1, 1)  # (c): healthy, host 1 down, adopted,
#                                     handed back


def dcn_port() -> int:
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dcn_chunks(dev, v, ts, lo: int, hi: int, size: int):
    from siddhi_tpu_torch.core.columns import RowsChunk
    for a in range(lo, hi, size):
        b = min(a + size, hi)
        yield RowsChunk({"dev": dev[a:b], "v": v[a:b]}, ts[a:b])


def dcn_leaves(workers) -> dict:
    """Every owned group's state leaves (the snapshot's order) by
    ``h<host>.g<group>.<i>``, on the host."""
    from siddhi_tpu_torch.gpu.state_io import state_leaves
    out = {}
    for w in workers:
        for g, shard in sorted(w._shards.items()):
            for i, a in enumerate(state_leaves(shard.state)):
                out[f"h{w.host_index}.g{g}.{i:03d}"] = a
    return out


def dcn_pair(device, ev, n: int, lanes: int, widths: dict) -> dict:
    """Two workers on loopback (``LaneTopology(lanes, 2)``), every one of
    the first ``n`` events into host 0 through ``ingest_chunk``; both
    flushed. Returns each worker's rows in order, the state leaves, the
    counters and the wall seconds (the flush included)."""
    import torch
    from siddhi_tpu_torch.gpu.dcn import DCNWorker, LaneTopology
    p0, p1 = dcn_port(), dcn_port()
    rows = ([], [])
    w1 = DCNWorker(1, LaneTopology(lanes, 2), bench_app(), "dev", port=p1,
                   peers={0: ("127.0.0.1", p0)}, on_rows=rows[1].extend,
                   device=device, **widths)
    w0 = DCNWorker(0, LaneTopology(lanes, 2), bench_app(), "dev", port=p0,
                   peers={1: ("127.0.0.1", p1)}, on_rows=rows[0].extend,
                   device=device, **widths)
    try:
        if w0.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk in dcn_chunks(*ev, 0, n, DCN_CHUNK):
            w0.ingest_chunk(chunk)
        w0.flush()
        w1.flush()
        if w0.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"rows": rows, "leaves": dcn_leaves((w0, w1)),
                "matches": (w0.match_count, w1.match_count),
                "drops": sum(rt.drop_count for w in (w0, w1)
                             for rt in w._shards.values()),
                "forward_chunk_rows": w0.forward_chunk_rows,
                "received": w1.received, "wall_s": wall,
                "devices": sorted({str(rt.device) for w in (w0, w1)
                                   for rt in w._shards.values()})}
    finally:
        w0.close()
        w1.close()


def dcn_failover(device, ev, lanes: int, widths: dict) -> dict:
    """The takeover and the rejoin of ``test_dcn_resilience``'s failover
    case at full width: host 1 snapshots every applied frame into a
    ``LaneGroupSnapshotStore``; after a snapshot of both hosts it is closed
    mid-stream, host 0's frames for group 1 spill, host 0 takes group 1
    over past the deadline (restoring it onto its device) and replays the
    spill, then host 1 returns as a standby, takes group 1 back through
    ``K_ADOPT`` and is routed to again. Returns the rows of every worker in
    order, the final state leaves and the counters."""
    import shutil
    import tempfile
    from siddhi_tpu_torch.gpu.dcn import DCNWorker, LaneTopology
    from siddhi_tpu_torch.resilience.dcn_guard import (
        PEER_DOWN, DCNGuardConfig, LaneGroupSnapshotStore)
    base = os.path.join(REPO, "siddhi_tpu_torch", "_build")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="dcn-", dir=base)
    clock = [0.0]
    store = LaneGroupSnapshotStore(root)
    cfg0 = DCNGuardConfig(retry_max=1, retry_base_s=0.0,
                          failure_threshold=1, down_cooldown_s=5.0,
                          probe_timeout_s=1.0, takeover_deadline_s=10.0,
                          spill_capacity_frames=512)
    p0, p1 = dcn_port(), dcn_port()
    rows0, rows1, rows1b = [], [], []
    kw = dict(device=device, **widths)
    w1 = DCNWorker(1, LaneTopology(lanes, 2), bench_app(), "dev", port=p1,
                   peers={0: ("127.0.0.1", p0)}, snapshot_store=store,
                   snapshot_every_frames=1, on_rows=rows1.extend, **kw)
    w0 = DCNWorker(0, LaneTopology(lanes, 2), bench_app(), "dev", port=p0,
                   peers={1: ("127.0.0.1", p1)}, guard_config=cfg0,
                   snapshot_store=store, clock=lambda: clock[0],
                   on_rows=rows0.extend, **kw)
    w1b = None
    bounds = np.cumsum((0,) + DCN_FAILOVER_CHUNKS) * DCN_FAILOVER_CHUNK

    def feed_part(k: int) -> None:
        for chunk in dcn_chunks(*ev, int(bounds[k]), int(bounds[k + 1]),
                                DCN_FAILOVER_CHUNK):
            w0.ingest_chunk(chunk)

    try:
        feed_part(0)                                  # healthy
        w0.snapshot()
        w1.snapshot()
        w1.close()                                    # host 1 dies
        feed_part(1)                                  # group 1 spills
        spilled = w0.guard.spill(1).spilled_frames
        if w0.guard.peer_state(1) != PEER_DOWN or not spilled:
            fail(f"dcn (c) on {device}: host 1 not down or nothing spilled "
                 f"({w0.guard.peer_state(1)}, {spilled} frames)")
        clock[0] = 11.0                               # past the deadline
        w0.guard.heartbeat_once()
        if w0.takeovers != 1 or not w0.guard.spill(1).empty \
                or sorted(w0.topo.groups_owned_by(0)) != [0, 1]:
            fail(f"dcn (c) on {device}: no takeover of group 1 "
                 f"({w0.takeovers}, owner {w0.topo.owner})")
        adopted = str(w0._shards[1].device)
        feed_part(2)                                  # both groups local
        w1b = DCNWorker(1, LaneTopology(lanes, 2, owner={0: 0, 1: 0}),
                        bench_app(), "dev", port=p1,
                        peers={0: ("127.0.0.1", p0)}, epoch=1,
                        snapshot_store=store, snapshot_every_frames=1,
                        on_rows=rows1b.extend, **kw)
        clock[0] = 30.0
        w0.guard.heartbeat_once()                     # recovery → hand back
        if w0.rejoins != 1 or w0.topo.owner[1] != 1 or w1b.takeovers != 1:
            fail(f"dcn (c) on {device}: group 1 not handed back "
                 f"({w0.rejoins}, {w1b.takeovers}, owner {w0.topo.owner})")
        feed_part(3)                                  # routed again
        w0.flush()
        w1b.flush()
        return {"rows": (rows0, rows1, rows1b),
                "leaves": dcn_leaves((w0, w1b)),
                "matches": w0.match_count + w1b.match_count,
                "spilled_frames": spilled,
                "replayed_frames": w0.guard.spill(1).replayed_frames,
                "adopted_on": adopted,
                "events": int(bounds[-1])}
    finally:
        for w in (w0, w1, w1b):
            if w is not None:
                w.close()
        shutil.rmtree(root, ignore_errors=True)


def dcn_oracle(ev, n: int) -> int:
    """Matches of the port's host interpreter over the first ``n`` events
    (one engine, no shards)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(bench_app(), playback=True)
    got = []
    rt.add_callback("Alerts", StreamCallback(got.extend))
    rt.start()
    ih = rt.input_handler("S")
    dev, v, ts = ev
    for i in range(n):
        ih.send([str(dev[i]), float(v[i])], timestamp=int(ts[i]))
    m.shutdown()
    return len(got)


def dcn_same(where: str, ref: dict, got: dict) -> None:
    """Rows in order per worker, state leaves bitwise."""
    if ref["rows"] != got["rows"]:
        fail(f"{where}: rows differ from the plain twin's "
             f"({[len(r) for r in ref['rows']]} vs "
             f"{[len(r) for r in got['rows']]})")
    bad = np_diff(ref["leaves"], got["leaves"])
    if bad:
        fail(f"{where}: state leaf {bad} differs from the plain twin's")


def phase_dcn(seed: int, n_events: int = DCN_EVENTS,
              lanes: int = DCN_LANES, widths: dict | None = None,
              split_widths: dict | None = None,
              twin_events: int = DCN_TWIN_EVENTS,
              oracle_events: int = DCN_ORACLE_EVENTS) -> dict:
    """Lanes over several devices and the DCN shard tier on the card
    (module docstring, phase 19); the sizes shrink it for a rehearsal on
    the CPU."""
    import torch
    from siddhi_tpu_torch.entry import dryrun_multichip
    from siddhi_tpu_torch.gpu.nfa_block import BlockPlan
    from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
    from siddhi_tpu_torch.gpu.state_io import state_to_numpy
    if not torch.cuda.is_available():
        fail("dcn: no CUDA device")
    widths = widths or DCN_WIDTHS
    split_widths = split_widths or MAIN
    t_phase = time.perf_counter()
    ev = gen_events(n_events, seed)

    # (a) the lane split: send_many over one card as 1, 2 and 4 ranges
    split = {}
    BlockPlan.launches = 0                     # counts from here: (a)
    for n in (1, 2, 4):
        before = BlockPlan.launches
        kw = {"device": "cuda"} if n == 1 else {"devices": ["cuda:0"] * n}
        rt = PartitionedNFARuntime(bench_app(), **kw, **split_widths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = feed(rt, *ev)
        rt.block_until_ready()
        wall = time.perf_counter() - t0
        split[n] = {"rows": rows, "state": state_to_numpy(rt.state),
                    "matches": rt.match_count, "drops": rt.drop_count,
                    "launches": BlockPlan.launches - before,
                    "events_per_s": n_events / wall,
                    "ranges": len(rt.ranges),
                    "devices": [str(d) for d in rt.devices]}
    one = split[1]
    if not one["launches"] or one["matches"] != len(one["rows"]):
        fail(f"dcn (a): one device: {one['launches']} launches, "
             f"{one['matches']} matches, {len(one['rows'])} rows")
    for n in (2, 4):
        s = split[n]
        if s["rows"] != one["rows"]:
            fail(f"dcn (a): rows over {n} ranges differ from one device's")
        bad = np_diff(one["state"], s["state"])
        if bad:
            fail(f"dcn (a): state leaf {bad} over {n} ranges differs")
        if (s["matches"], s["drops"]) != (one["matches"], one["drops"]):
            fail(f"dcn (a): counters over {n} ranges differ")
        if s["launches"] != n * one["launches"] or s["ranges"] != n:
            fail(f"dcn (a): {s['launches']} launches over {n} ranges, "
                 f"{one['launches']} on one")
    before = BlockPlan.launches
    dry = dryrun_multichip(2, devices=["cuda:0"] * 2)
    dry_launches = BlockPlan.launches - before
    if dry["matches"] != dry["expected"] or not dry_launches:
        fail(f"dcn (a): dryrun_multichip(2): {dry['matches']} matches of "
             f"{dry['expected']}, {dry_launches} launches")
    split_launches = BlockPlan.launches

    # (b) two workers on loopback, every event into host 0
    probe = dcn_pair("cuda", ev, oracle_events, lanes, widths)
    oracle = dcn_oracle(ev, oracle_events)
    if sum(probe["matches"]) != oracle:
        fail(f"dcn (b): the two workers' {probe['matches']} matches over "
             f"the first {oracle_events} events, the interpreter's {oracle}")
    t_twin = time.perf_counter()
    card_pre = dcn_pair("cuda", ev, twin_events, lanes, widths)
    plain_pre = dcn_pair("cpu", ev, twin_events, lanes, widths)
    dcn_same(f"dcn (b), the first {twin_events} events", plain_pre, card_pre)
    twin_s = time.perf_counter() - t_twin
    BlockPlan.launches = 0                     # counts from here: (b)
    full = dcn_pair("cuda", ev, n_events, lanes, widths)
    dcn_launches = BlockPlan.launches
    if not all(d.startswith("cuda") for d in full["devices"]) \
            or not dcn_launches:
        fail(f"dcn (b): shards on {full['devices']}, {dcn_launches} "
             f"launches")
    if sum(full["matches"]) != len(full["rows"][0]) + len(full["rows"][1]):
        fail(f"dcn (b): {full['matches']} matches, "
             f"{[len(r) for r in full['rows']]} rows")
    if full["received"] != full["forward_chunk_rows"] or \
            not full["forward_chunk_rows"]:
        fail(f"dcn (b): {full['forward_chunk_rows']} rows forwarded, "
             f"{full['received']} received")
    for r in full["rows"][0] + full["rows"][1]:
        if len(r) != 8 or not (r[0] > 90.0 and
                               all(a < b for a, b in zip(r, r[1:]))):
            fail(f"dcn (b): row breaks the rising-chain contract: {r}")

    # (c) failover on the card against its plain twin
    t_fail = time.perf_counter()
    before = BlockPlan.launches
    card_fo = dcn_failover("cuda", ev, lanes, widths)
    fo_launches = BlockPlan.launches - before
    plain_fo = dcn_failover("cpu", ev, lanes, widths)
    dcn_same("dcn (c)", plain_fo, card_fo)
    if not card_fo["adopted_on"].startswith("cuda") or not fo_launches \
            or card_fo["matches"] != plain_fo["matches"]:
        fail(f"dcn (c): group 1 adopted on {card_fo['adopted_on']}, "
             f"{fo_launches} launches")
    fail_s = time.perf_counter() - t_fail
    out = {"phase": "dcn",
           "lanes_split": {
               str(n): {k: s[k] for k in ("matches", "drops", "launches",
                                          "events_per_s", "ranges",
                                          "devices")}
               for n, s in split.items()},
           "lanes_split_rows": len(one["rows"]), "lanes_split_equal": True,
           "dryrun_multichip_2": {"matches": dry["matches"],
                                  "devices": dry["devices"],
                                  "launches": dry_launches},
           "lanes_split_launches": split_launches,
           "dcn": {"events": n_events, "lanes": lanes, **widths,
                   "events_per_s": n_events / full["wall_s"],
                   "wall_s": full["wall_s"],
                   "forward_chunk_rows": full["forward_chunk_rows"],
                   "matches": list(full["matches"]),
                   "drops": full["drops"], "launches": dcn_launches,
                   "devices": full["devices"]},
           "oracle": {"events": oracle_events, "matches": oracle},
           "plain_twin": {"events": twin_events, "equal": True,
                          "rows": [len(r) for r in card_pre["rows"]],
                          "seconds": twin_s},
           "failover": {k: card_fo[k] for k in (
               "matches", "spilled_frames", "replayed_frames", "adopted_on",
               "events")} | {"rows": [len(r) for r in card_fo["rows"]],
                             "launches": fo_launches,
                             "equal_to_plain_twin": True,
                             "seconds": fail_s},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--events", type=int, default=2_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from siddhi_tpu_torch.tools.agg_workloads import AGG_MAIN
    from siddhi_tpu_torch.tools.join_workloads import JOIN_MAIN
    from siddhi_tpu_torch.tools.query_workloads import QUERY_MAIN
    card = phase_device()
    shape_err = phase_shapes(args.seed)
    main_out = phase_main(args.seed, args.events)
    native_out = phase_native_main(args.seed, args.events)
    snap_out = phase_snapshot(args.seed)
    entry_out = phase_entry()
    scan_err = phase_scan_shapes(args.seed)
    scan_out = phase_scan_main(args.seed, SCAN_EVENTS)
    query_err = phase_query_shapes()
    q_outs = [phase_query_main(name, args.seed) for name in QUERY_MAIN]
    phase_join_shapes()
    j_outs = [phase_join_main(name, args.seed) for name in JOIN_MAIN]
    phase_agg_shapes()
    a_outs = [phase_agg_main(name, args.seed) for name in AGG_MAIN]
    by_q = {o["config"]: o for o in q_outs}

    def stand(o, phase):
        keys = ("kernel_step_ms_median", "step_call_ms_median",
                "events_per_s")
        return {"phase": phase, **{k: o[k] for k in keys if k in o}}

    # every engine phase runs guarded by default; each ends with every guard
    # at 0 failures, fallback and lost events (GuardAudit)
    eng = audited("engine", phase_engine, args.seed, ENGINE_EVENTS, {
        "chain": stand(main_out, "main (64 lanes, partitioned)"),
        "scan": stand(scan_out, "scan_main (64 lanes, partitioned)"),
        **{n: stand(by_q[n], "query_main") for n in
           ("grouped_length", "time_batch", "lossy_frequent")},
        "market_join": stand(j_outs[0], "join_main"),
        "trade_rollup": stand(a_outs[0], "agg_main")})
    host = audited("engine_host", phase_engine_host, args.seed,
                   ENGINE_HOST_EVENTS)
    from siddhi_tpu_torch.tools.engine_workloads import IO_EVENTS
    io = audited("engine_io", phase_engine_io, args.seed, IO_EVENTS)
    guard = phase_engine_guard(args.seed)
    observe = phase_engine_observe(args.seed)
    columnar = phase_engine_columnar(args.seed)
    fleet = phase_engine_fleet(args.seed)
    dcn = phase_dcn(args.seed)
    bound = max(main_out["bound_ms_bytes"], main_out["bound_ms_ops"])
    scan_bound = max(scan_out["bound_ms_bytes"], scan_out["bound_ms_ops"])
    kernels = [{
        "name": "nfa_block",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_block.cu",
        "replaces": "siddhi_tpu/tpu/nfa_block.py:110",
        "also_replaces": ["siddhi_tpu/tpu/expr_compile.py:121",
                          "siddhi_tpu/tpu/partition.py:160"],
        "launches": main_out["launches"],
        "max_abs_err": max(shape_err, main_out["max_abs_err"]),
        "ms": main_out["kernel_step_ms_median"],
        "plain_ms": main_out["plain_step_ms_median"],
        "bound_ms": bound,
        "bound_by": "bytes" if main_out["bound_ms_bytes"] >= main_out["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": "one main-path step (1 launch: the seed gate and S-1 = 7 "
                "stages)",
        "parity": "exact",
        "launches_by_path": {
            "main": main_out["launches"], "native_main": native_out["launches"],
            "snapshot": snap_out["apps"][0]["launches"],
            "entry": entry_out["entry_launches"] + entry_out["dryrun_launches"],
            "lanes_split": dcn["lanes_split_launches"],
            "dcn": dcn["dcn"]["launches"]},
        "native_main_ms": native_out["kernel_step_ms_median"],
        "native_main_plain_ms": native_out["plain_step_ms_median"],
    }, {
        "name": "nfa_scan_step",
        "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/nfa_scan.cu",
        "replaces": "siddhi_tpu/tpu/nfa.py:829",
        "also_replaces": ["siddhi_tpu/tpu/partition.py:160"],
        "launches": scan_out["launches"],
        "max_abs_err": max(scan_err, scan_out["max_abs_err"]),
        "ms": scan_out["kernel_step_ms_median"],
        "plain_ms": scan_out["plain_step_ms_median"],
        "bound_ms": scan_bound,
        "bound_by": "bytes" if scan_out["bound_ms_bytes"] >= scan_out["bound_ms_ops"]
        else "operations",
        "library_ms": None,
        "unit": "one scan_main step (1 launch, ys zeroed in it)",
        "parity": "exact",
        "checked_steps": scan_out["checked_steps"],
        "launches_by_path": {"scan_main": scan_out["launches"],
                             "snapshot": snap_out["apps"][1]["launches"]},
    }, *query_kernel_entries(q_outs, query_err), join_kernel_entry(j_outs),
        agg_kernel_entry(a_outs)]
    main_path = {"query_step": "query_main", "query_step_tumbling":
                 "query_main", "query_walk": "query_main",
                 "join_step": "join_main", "aggregation_step": "agg_main"}
    for k in kernels:
        if "launches_by_path" not in k:
            k["launches_by_path"] = {main_path[k["name"]]: k["launches"]}
        by_path = k["launches_by_path"]
        by_path["engine"] = eng["launches"].get(k["name"], 0)
        if not by_path["engine"]:
            fail(f"engine: kernel {k['name']} was not launched")
        if k["name"] in host["launches"]:
            by_path["engine_host"] = host["launches"][k["name"]]
        if k["name"] in io["launches"]:
            by_path["engine_io"] = io["launches"][k["name"]]
            if not by_path["engine_io"]:
                fail(f"engine_io: kernel {k['name']} was not launched")
        if k["name"] in guard["launches"]:
            by_path["engine_guard"] = guard["launches"][k["name"]]
        by_path["engine_observe"] = observe["launches"].get(k["name"], 0)
        if k["name"] in columnar["launches"]:
            by_path["engine_columnar"] = columnar["launches"][k["name"]]
        if k["name"] in fleet["launches"]:
            by_path["engine_fleet"] = fleet["launches"][k["name"]]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
