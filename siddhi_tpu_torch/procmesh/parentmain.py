"""Killable parent entrypoint for durable-fabric chaos tests.

``python -m siddhi_tpu_torch.procmesh.parentmain --root DIR ...`` runs a
durable process-mode :class:`~siddhi_tpu_torch.mesh.fabric.MeshFabric` as a
REAL parent process the test harness can SIGKILL mid-ingest (via the
``SIDDHI_CRASH_AT`` hooks in ``journal.py``) and then restart against the
same ``--root``. The runner is a crash-oblivious idempotent client of the
fabric's recovery contract:

- tenants deploy only if the journal did not already resurrect them;
- per-tenant sinks are append-only JSONL files keyed by the ``(epoch,
  idx)`` output identity — at-least-once delivery dedups offline
  (keep-first), exactly how an idempotent downstream would;
- the feed resumes from each tenant's recovered ``applied`` mark (chunk
  ``c`` carries seq ``c+1``), so a restarted run re-sends exactly the
  chunks the crash lost;
- the hand-shake line ``PARENT_DONE {json}`` carries the recovery stats,
  journal position and applied marks for the harness to assert on.

The chunk generator (:func:`chunk_rows`) is deterministic and importable
so tests compute solo oracles from the same bytes.

The port's copy of the JAX package's ``procmesh/parentmain.py``, with
``--device``: every worker's engine device (``cpu``, or ``cuda[:N]``);
without it the fabric puts host ``i`` on ``cuda:(i mod device_count())``
and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os

APP_TMPL = ("@app:name('t{i}')\n"
            "define stream S (dev string, v double);\n"
            "@info(name='q') from S[v > 1.0] select dev, v "
            "insert into Out;\n")


def chunk_rows(c: int, width: int):
    """Deterministic chunk ``c``: every row passes the ``v > 1.0`` filter,
    so the solo oracle is the rows themselves."""
    rows = [[f"d{c}_{w}", 1.5 + c + 0.001 * w] for w in range(width)]
    ts = [1000 + c] * width
    return rows, ts


def _sink(f, tid: str):
    def hook(entries):
        for e in entries:
            f.write(json.dumps(
                {"t": tid, "e": int(e[0]), "i": int(e[1]), "s": e[2],
                 "ts": e[3], "d": list(e[4])},
                separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--width", type=int, default=2)
    ap.add_argument("--migrate-at", type=int, default=-1)
    ap.add_argument("--snapshot-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:N]; the card by default")
    args = ap.parse_args(argv)

    from ..mesh.fabric import MeshConfig, MeshFabric
    cfg = MeshConfig(mode="process", durable=True,
                     snapshot_every_chunks=args.snapshot_every,
                     heartbeat_interval_s=0.3,
                     capacity_per_host=max(4, args.tenants + 1))
    fab = MeshFabric(args.hosts, args.root, config=cfg, device=args.device)
    tids = [f"t{i}" for i in range(args.tenants)]
    missing = [APP_TMPL.format(i=i) for i in range(args.tenants)
               if f"t{i}" not in fab.tenants]
    if missing:
        fab.add_tenants(missing)

    sinks = []
    for tid in tids:
        f = open(os.path.join(args.root, f"sink_{tid}.jsonl"), "a",
                 encoding="utf-8")
        sinks.append(f)
        fab.add_output_hook(tid, _sink(f, tid), streams=("Out",))
    # hooks are armed: journal-staged outputs from dead incarnations
    # replay now, re-adopted tenants re-snapshot
    fab.resume_output_delivery()

    for c in range(args.chunks):
        if args.migrate_at == c and args.hosts > 1:
            st0 = fab.tenants[tids[0]]
            dst = (st0.host + 1) % args.hosts
            if st0.host != dst:
                fab.migrate(tids[0], dst)
        rows, ts = chunk_rows(c, args.width)
        for tid in tids:
            if fab.tenants[tid].applied >= c + 1:
                continue                 # applied before the crash: skip
            fab.send(tid, "S", rows, ts)

    rep = fab.report()
    done = {"recovery": rep["recovery"], "journal": rep["journal"],
            "dup_chunks": rep["dup_chunks"],
            "supervisor": {i: {"adopted": w["adopted"], "pid": w["pid"]}
                           for i, w in rep["supervisor"]["workers"].items()},
            "applied": {tid: fab.tenants[tid].applied for tid in tids}}
    fab.close()
    for f in sinks:
        f.close()
    print("PARENT_DONE " + json.dumps(done, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
