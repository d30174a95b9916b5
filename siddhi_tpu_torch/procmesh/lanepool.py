"""Process-backed lane pool for the columnar host tier.

The port's copy of the JAX package's ``procmesh/lanepool.py``.
``@app:host_batch(workers=N, workers.mode='process')`` swaps
``HostPartitionedNFA``'s thread pool for N child PROCESSES, each owning a
contiguous shard of the lane space, sidestepping the GIL for the Python
tails torch does not release it for. A child runs host code only: it
builds its engine on the CPU and never sees the card
(``CUDA_VISIBLE_DEVICES`` is empty in its environment), and steps its
shard on one intra-op thread (``OMP_NUM_THREADS=1``).

Byte-parity contract (pinned against ``workers.mode='thread'`` and the
sequential loop by the JAX package's ``tests/test_procmesh.py``, run on
the port):

- children rebuild an IDENTICAL engine by re-parsing the SAME retained
  app source (``SiddhiApp.source_text``) — compile-order determinism
  keeps dictionary CONSTANT codes in agreement across processes;
- DATA codes are parent-minted (the stager's dictionaries); children
  only ever compare codes for equality, never decode, so one consistent
  encoding side is enough;
- the parent ships each shard its slice of the lane-sorted batch; the
  child returns match columns with SHARD-RELATIVE row indices and the
  parent maps them through ``order[row_lo + j]`` — then merges in
  shard→lane order and applies the same stable by-event sort as the
  thread path.

The wire is the procmesh control protocol (:mod:`.protocol` frames) with
pickled numpy bodies (a slice of a tensor would pickle its whole storage)
— parent and child are the same build of the same tree, the one situation
where pickle across a socket is sound.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
from typing import Optional

import numpy as np
import torch

from .protocol import (
    F_ERR,
    F_REQ,
    F_RES,
    READY_TIMEOUT_S,
    WorkerOpError,
    child_env,
    connect,
    io_timeout_s,
    recv_frame,
    send_frame,
)

_ACCEPT_POLL_S = 0.5
_STEP_TIMEOUT_S = 120.0


class LanePoolError(RuntimeError):
    """A lane child died or misbehaved mid-step: the batch outcome is
    unknowable, so the pool surfaces a hard error (the host-path guard
    quarantines the bridge exactly like any other engine fault)."""


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class _LaneChild:
    """One spawned shard: process handle + its persistent control socket."""

    def __init__(self, worker_index: int, lane_lo: int, lane_hi: int):
        self.worker_index = worker_index
        self.lane_lo = lane_lo
        self.lane_hi = lane_hi
        self.proc: Optional[subprocess.Popen] = None
        self.sock: Optional[socket.socket] = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ProcessLanePool:
    """N lane-shard children stepped in lockstep by the parent NFA.

    ``step`` overlaps the shards: every child's request frame goes out
    before any reply is read — one outstanding request per socket, so
    plain send-all/recv-all is the whole scheduler."""

    def __init__(self, source: dict, P: int, workers: int,
                 snaps: list, env: Optional[dict] = None):
        self.source = dict(source)
        self.P = int(P)
        self.workers = max(1, min(int(workers), self.P))
        cuts = [self.P * w // self.workers
                for w in range(self.workers + 1)]
        self.children = [_LaneChild(w, cuts[w], cuts[w + 1])
                         for w in range(self.workers)]
        self._cuts = cuts
        self._env = dict(env or {})
        self._lock = threading.Lock()
        try:
            # every child starts before any is awaited: each imports torch,
            # seconds a child, so the boots overlap (the reference's numpy
            # children boot one after another)
            for ch in self.children:
                self._spawn(ch)
            for ch in self.children:
                self._init(ch, snaps[ch.lane_lo:ch.lane_hi])
        except Exception:
            self.close()
            raise

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self, ch: _LaneChild) -> None:
        env = child_env()
        env["SIDDHI_PROCMESH_CHILD"] = "1"   # no recursive pools
        env["CUDA_VISIBLE_DEVICES"] = ""     # host code only: no card
        # one intra-op thread: a child steps its shard on one core, as the
        # reference's numpy child does; W children use W cores
        env["OMP_NUM_THREADS"] = "1"
        env.update(self._env)
        ch.proc = subprocess.Popen(
            # -c, not -m: the package __init__ already imports this module,
            # and runpy would warn about the double execution
            [sys.executable, "-c",
             "from siddhi_tpu_torch.procmesh.lanepool import main; main()"],
            stdout=subprocess.PIPE, stderr=None, env=env, text=True)

    def _init(self, ch: _LaneChild, shard_snaps: list) -> None:
        port = self._await_ready(ch)
        ch.sock = connect(port)
        self._rpc(ch, "init", body=pickle.dumps({
            **self.source,
            "P": self.P,
            "lane_lo": ch.lane_lo,
            "lane_hi": ch.lane_hi,
            "snaps": shard_snaps,
        }), timeout=READY_TIMEOUT_S)

    def _await_ready(self, ch: _LaneChild) -> int:
        box: dict = {}

        def read():
            line = ch.proc.stdout.readline()
            if line.startswith("PROCMESH_READY "):
                box.update(json.loads(line.split(" ", 1)[1]))

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(READY_TIMEOUT_S)
        if "port" not in box:
            try:
                ch.proc.kill()
            except OSError:
                pass
            raise LanePoolError(
                f"lane child {ch.worker_index} did not become ready")
        return int(box["port"])

    def close(self) -> None:
        for ch in self.children:
            if ch.sock is not None:
                try:
                    send_frame(ch.sock, F_REQ, {"op": "stop"})
                except OSError:
                    pass
                try:
                    ch.sock.close()
                except OSError:
                    pass
                ch.sock = None
            if ch.proc is not None:
                try:
                    ch.proc.terminate()
                    ch.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    try:
                        ch.proc.kill()
                    except OSError:
                        pass

    # -- rpc ------------------------------------------------------------------
    def _rpc(self, ch: _LaneChild, op: str, header: Optional[dict] = None,
             body: bytes = b"", timeout: Optional[float] = None):
        if timeout is None:
            timeout = io_timeout_s()    # env-tunable, resolved per op
        h = dict(header or {})
        h["op"] = op
        try:
            send_frame(ch.sock, F_REQ, h, body)
            kind, rh, rbody = recv_frame(ch.sock, timeout=timeout)
        except (OSError, ValueError, ConnectionError) as e:
            raise LanePoolError(
                f"lane child {ch.worker_index} died mid-'{op}': {e}") from e
        if kind == F_ERR:
            raise LanePoolError(
                f"lane child {ch.worker_index} '{op}' failed: "
                f"{rh.get('error')}")
        return rh, rbody

    # -- the pool surface the NFA steps against --------------------------------
    def step(self, bounds: np.ndarray, cols_sorted: dict,
             ts_sorted: np.ndarray, order: np.ndarray) -> list:
        """One lane-sorted batch through every shard; returns the merged
        ``outs`` list in shard→lane order with GLOBAL ``j`` (pre-sort
        event positions) — the thread path's ``_run_lanes`` contract."""
        with self._lock:
            plans = []
            for ch in self.children:
                row_lo = int(bounds[ch.lane_lo])
                row_hi = int(bounds[ch.lane_hi])
                rel = (np.asarray(bounds[ch.lane_lo:ch.lane_hi + 1],
                                  dtype=np.int64) - row_lo)
                if row_lo == row_hi:
                    plans.append((ch, row_lo, None))
                    continue
                body = pickle.dumps({
                    "bounds": rel,
                    "cols": {k: np.asarray(v[row_lo:row_hi])
                             for k, v in cols_sorted.items()},
                    "ts": np.asarray(ts_sorted[row_lo:row_hi]),
                })
                try:
                    send_frame(ch.sock, F_REQ, {"op": "step"}, body)
                except (OSError, ConnectionError) as e:
                    raise LanePoolError(
                        f"lane child {ch.worker_index} died on send: "
                        f"{e}") from e
                plans.append((ch, row_lo, True))
            outs = []
            for ch, row_lo, sent in plans:
                if sent is None:
                    continue
                try:
                    kind, rh, rbody = recv_frame(
                        ch.sock, timeout=_STEP_TIMEOUT_S)
                except (OSError, ValueError, ConnectionError) as e:
                    raise LanePoolError(
                        f"lane child {ch.worker_index} died mid-step: "
                        f"{e}") from e
                if kind == F_ERR:
                    raise LanePoolError(
                        f"lane child {ch.worker_index} step failed: "
                        f"{rh.get('error')}")
                for m in pickle.loads(rbody):
                    m = {k: torch.from_numpy(v) for k, v in m.items()}
                    m["j"] = order[row_lo + m["j"]]
                    outs.append(m)
            return outs

    def snapshot_lanes(self) -> list:
        """Full-P lane snapshot list assembled from the shard owners."""
        with self._lock:
            lanes: list = []
            for ch in self.children:
                _, rbody = self._rpc(ch, "snap")
                lanes.extend(pickle.loads(rbody))
            return lanes

    def restore_lanes(self, lane_snaps: list) -> None:
        with self._lock:
            for ch in self.children:
                self._rpc(ch, "restore", body=pickle.dumps(
                    lane_snaps[ch.lane_lo:ch.lane_hi]))

    def match_count(self) -> int:
        with self._lock:
            total = 0
            for ch in self.children:
                rh, _ = self._rpc(ch, "stats")
                total += int(rh.get("matches", 0))
            return total

    def report(self) -> dict:
        return {
            "workers": self.workers,
            "cuts": list(self._cuts),
            "alive": sum(1 for ch in self.children if ch.alive),
            "pids": [ch.proc.pid if ch.proc else None
                     for ch in self.children],
        }


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

class _LaneShardServer:
    """One lane shard: rebuilds the engine from the retained app source,
    owns lane states ``[lane_lo, lane_hi)``, answers step/snap/restore."""

    def __init__(self):
        self.prt = None
        self.lane_lo = 0
        self.lane_hi = 0

    def op_init(self, h: dict, body: bytes):
        cfg = pickle.loads(body)
        from ..compiler import parse
        from ..gpu.host_exec import HostPartitionedNFA
        app = parse(cfg["app_text"])
        part = app.partitions[cfg["part_index"]]
        q = part.queries[cfg["query_index"]]
        # same text → same parse → same compile order → same constant codes
        self.prt = HostPartitionedNFA(
            q, dict(app.stream_definitions), cfg["key_attr"],
            num_partitions=cfg["P"], workers=1)
        self.lane_lo = int(cfg["lane_lo"])
        self.lane_hi = int(cfg["lane_hi"])
        for lane, snap in zip(range(self.lane_lo, self.lane_hi),
                              cfg.get("snaps") or ()):
            self.prt.lane_states[lane] = self.prt.engine.restore_state(snap)
        return {"lanes": [self.lane_lo, self.lane_hi]}, b""

    def op_step(self, h: dict, body: bytes):
        req = pickle.loads(body)
        bounds, cols, ts = req["bounds"], req["cols"], req["ts"]
        outs = []
        for li, lane in enumerate(range(self.lane_lo, self.lane_hi)):
            lo, hi = int(bounds[li]), int(bounds[li + 1])
            if lo == hi:
                continue
            lcols = {k: v[lo:hi] for k, v in cols.items()}
            self.prt.lane_states[lane], m = self.prt.engine.step(
                self.prt.lane_states[lane], lcols, None, ts[lo:hi])
            if m and m["j"].numel():
                m = {k: v.numpy() for k, v in m.items()}
                m["j"] = m["j"] + lo        # shard-relative row position
                outs.append(m)
        return {"n": len(outs)}, pickle.dumps(outs)

    def op_snap(self, h: dict, body: bytes):
        snaps = [self.prt.engine.snapshot_state(st)
                 for st in self.prt.lane_states[self.lane_lo:self.lane_hi]]
        return {"n": len(snaps)}, pickle.dumps(snaps)

    def op_restore(self, h: dict, body: bytes):
        for lane, snap in zip(range(self.lane_lo, self.lane_hi),
                              pickle.loads(body)):
            self.prt.lane_states[lane] = self.prt.engine.restore_state(snap)
        return {"ok": True}, b""

    def op_stats(self, h: dict, body: bytes):
        matches = sum(
            int(st["matches"])
            for st in self.prt.lane_states[self.lane_lo:self.lane_hi])
        return {"matches": matches, "pid": os.getpid()}, b""


def _serve(listener: socket.socket) -> None:
    """Single-connection serve loop: the parent pool is the only client.
    Every read arms a deadline."""
    server = _LaneShardServer()
    listener.settimeout(_ACCEPT_POLL_S)
    conn = None
    while conn is None:
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            continue
    conn.settimeout(io_timeout_s())
    while True:
        try:
            kind, h, body = recv_frame(conn, timeout=_STEP_TIMEOUT_S)
        except (ValueError, ConnectionError, OSError):
            return                          # parent gone: exit with it
        op = h.get("op", "")
        if op == "stop":
            return
        fn = getattr(server, f"op_{op}", None)
        try:
            if fn is None:
                raise WorkerOpError(f"unknown lane-pool op '{op}'")
            rh, rbody = fn(h, body)
            send_frame(conn, F_RES, rh, rbody)
        except Exception as e:   # noqa: BLE001 — fault becomes a frame
            try:
                send_frame(conn, F_ERR, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                return


def main() -> int:
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    print(f"PROCMESH_READY {json.dumps({'port': port, 'pid': os.getpid()})}",
          flush=True)
    try:
        _serve(listener)
    finally:
        listener.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
