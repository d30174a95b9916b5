"""Entry points of the port: one compiled step, and the partitioned dry run.

``entry()`` returns ``(fn, example_args)``: ``fn`` is the compiled step of
the flagship 4-state rising chain (the blocked NFA kernel on the card),
``example_args`` one lane's state and wire batch of 8 events.

``dryrun_multichip(n)`` runs the bench-shaped 8-state partitioned app with
its lanes split over ``n`` devices (``PartitionedNFARuntime(devices=)``, the
counterpart of the reference's mesh), one guaranteed match per lane, and
checks itself against the per-lane count the construction guarantees and,
on the card, against the plain version on the CPU on one device. It takes
``cuda:0 … cuda:n-1`` unless ``devices=`` names them (a device may repeat:
``["cpu"] * n`` is the plain version, ``["cuda:0"] * n`` splits one card)
and refuses, with no fallback, where fewer than ``n`` cards exist.

``entry()`` runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

FLAGSHIP_APP = """
define stream S (dev string, v double);
from every e1=S[v > 10.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] -> e4=S[v > e3.v]
select e1.v as v1, e2.v as v2, e3.v as v3, e4.v as v4 insert into Alerts;
"""

N_STATES = 8


def _device(device) -> torch.device:
    from .gpu.backend import resolve_device
    return resolve_device(device)


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(state, cols, tag, ts, ts_base,
    nvalid) -> (state, ys)`` is the flagship chain's lane-batched step
    (slot capacity 16, batch capacity 32), ``example_args`` its inputs for
    one lane on ``device``."""
    from .compiler import parse
    from .gpu.nfa import DeviceNFACompiler, MergedBatchBuilder

    dev = _device(device)
    app = parse(FLAGSHIP_APP)
    compiler = DeviceNFACompiler(
        app.queries[0], dict(app.stream_definitions),
        slot_capacity=16, batch_capacity=32, device=dev)
    builder = MergedBatchBuilder(compiler.merged, 32,
                                 dict(app.stream_definitions))
    for i in range(8):
        builder.append("S", [f"d{i % 2}", 10.0 + i], 1000 + i)
    batch = builder.emit()

    def lane(a):
        return torch.from_numpy(np.asarray(a)[None]).to(dev)

    example_args = (
        compiler.init_state(1),
        {k: lane(v) for k, v in batch["cols"].items()},
        lane(batch["tag"]), lane(batch["ts"]),
        torch.tensor([int(batch["ts_base"])], dtype=torch.int64, device=dev),
        torch.tensor([batch["count"]], dtype=torch.int32, device=dev))
    return compiler.make_step(), example_args


def bench_app(n_states: int = N_STATES) -> str:
    """The bench-shaped rising chain under ``partition with (dev of S)``."""
    states = " -> ".join(
        f"e{i}=S[v > e{i-1}.v]" if i > 1 else "e1=S[v > 90.0]"
        for i in range(1, n_states + 1))
    sel = ", ".join(f"e{i}.v as v{i}" for i in range(1, n_states + 1))
    return f"""
define stream S (dev string, v double);
partition with (dev of S)
begin
from every {states} select {sel} insert into Alerts;
end;
"""


def dryrun_events(rt) -> list:
    """One key per lane, then an interleaved rising chain of ``N_STATES``
    events per key and a sub-threshold event each: every lane completes
    exactly one match (a chain seeded later has too few rising events
    left)."""
    keys: dict = {}
    i = 0
    while len(keys) < rt.P and i < 10_000:
        k = f"dev{i}"
        keys.setdefault(rt.lane_of(k), k)
        i += 1
    events = []
    ts = 1000
    for step in range(N_STATES):
        for ln in sorted(keys):
            events.append((keys[ln], 91.0 + step, ts))
            ts += 1
    for ln in sorted(keys):
        events.append((keys[ln], 5.0, ts))
        ts += 1
    return events


def _run(devices: list, P: int):
    from .gpu.partition import PartitionedNFARuntime
    rt = PartitionedNFARuntime(bench_app(), num_partitions=P, key_attr="dev",
                               slot_capacity=8, lane_batch=16,
                               devices=devices)
    rows = []
    rt.callback = rows.extend
    for dev, v, t in dryrun_events(rt):
        rt.send("S", [dev, v], t)
    rt.flush()
    rt.block_until_ready()
    return rt, rows


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One partitioned run of the bench-shaped app over ``2 * n_devices``
    lanes split over ``n_devices`` devices; returns ``{"matches", "drops",
    "expected", "rows", "devices"}`` after checking that every lane matched
    exactly once and, on the card, that the kernel's state (the ranges
    concatenated) and rows equal the plain version's on one CPU device.
    ``devices`` defaults to ``cuda:0 … cuda:n-1``; with fewer than
    ``n_devices`` cards present that raises ``ValueError``."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip({n_devices}): need n >= 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}): needs {n_devices} CUDA "
                f"cards, {have} present (pass devices= to split fewer "
                f"cards)")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devs = [_device(d) for d in devices]
    if len(devs) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): devices= names "
                         f"{len(devs)} devices")
    P = 2 * n_devices
    rt, rows = _run(devs, P)
    if rt.match_count != P or len(rows) != P:
        raise AssertionError(f"expected one match per lane ({P}), got "
                             f"{rt.match_count} matches, {len(rows)} rows")
    if any(d.type != "cpu" for d in devs):
        from .gpu.state_io import state_to_numpy
        ref, ref_rows = _run([torch.device("cpu")], P)
        want, got = state_to_numpy(ref.state), state_to_numpy(rt.state)
        _assert_same_tree(want, got)
        if rows != ref_rows:
            raise AssertionError("dryrun rows differ from the plain version's")
    names = [str(d) for d in rt.devices]
    out = {"matches": rt.match_count, "drops": rt.drop_count,
           "expected": P, "rows": rows, "devices": names}
    print(f"dryrun_multichip({n_devices}): one partitioned run OK on "
          f"{names} — matches={rt.match_count} drops={rt.drop_count} "
          f"expected={P}")
    return out


def _assert_same_tree(want: dict, got: dict, at: str = "") -> None:
    if want.keys() != got.keys():
        raise AssertionError(f"state leaves differ under {at or 'the root'}")
    for k, a in want.items():
        if isinstance(a, dict):
            _assert_same_tree(a, got[k], f"{at}{k}.")
        elif a.dtype != got[k].dtype or not np.array_equal(a, got[k]):
            raise AssertionError(f"state leaf {at}{k} differs from the plain "
                                 f"version's")
