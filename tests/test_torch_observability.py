"""The port's observability tier against the JAX package's, on the CPU.

The same app text and the same seeded events go through
``siddhi_tpu.SiddhiManager()`` (JAX on the CPU) and
``siddhi_tpu_torch.SiddhiManager(device="cpu")``: a ``@device`` filter, a
grouped ``length`` window and a 3-state chain on one stream, under
``@app(statistics='true')`` and ``@app:trace``, sync and with
``async='true'``. Both engines must give:

- the same rows on every output stream;
- equal device step probes: ``steps``, ``events``, ``pad_ratio`` and the
  flush causes of each query;
- each sampled trace's span stages in the same sequence (durations differ);
- the same flight-recorder entries (category, kind, site) under
  ``@app:chaos(seed=...)``, and the same guard failure counts;
- the same Prometheus family names, types and label sets, with equal values
  for every sample that is not a time or derived from one;
- the same ``latency_report()`` keys, each query's ``reconciliation_ratio``
  1.0 within 1e-9;
- the same errors from the annotation parsers.

``@app:profile(dir=...)`` writes a Chrome trace holding
``siddhi:step:<query>`` from ``torch.profiler``, sync and async (the async
driver's steps run on a worker thread). The extension validator and the
doc generator, which the service's suite holds with the JAX package's
``DataType``, are held here with each package's own.
"""

import json
import math
import os

import numpy as np
import pytest

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.observability import render as port_render
from siddhi_tpu.observability import render as ref_render

QUERIES = ("filt", "win", "chain")
OUTS = ("F", "W", "C")

APP = """
@app(name='Obs', statistics='true')
@app:trace(sample='1/{sample}')
{extra}define stream S (dev string, v double);
@info(name='filt') @device(batch='16'{opts})
from S[v > 50.0] select dev, v insert into F;
@info(name='win') @device(batch='16', window='8'{opts})
from S#window.length(8) select dev, sum(v) as total group by dev
insert into W;
@info(name='chain') @device(batch='16', slots='8'{opts})
from every e1=S[v > 60.0] -> e2=S[v > e1.v] -> e3=S[v > e2.v] within 200
select e1.v as v1, e2.v as v2, e3.v as v3 insert into C;
"""

# sync: every failed step opens its circuit and the next batch probes it;
# async: the circuit stays closed (a half-open circuit lets one of the
# ring's two batches probe and sends the other to the host without a
# chaos draw, so which batches fail would depend on the workers' timing)
CHAOS = {"sync": "@app:chaos(seed='11', device.fail.p='0.2')\n"
                 "@app:resilience(device.circuit.threshold='1', "
                 "device.circuit.cooldown.ms='0')\n",
         "async": "@app:chaos(seed='11', device.fail.p='0.2')\n"
                  "@app:resilience(device.circuit.threshold='1000')\n"}


def app_text(mode: str, extra: str = "", sample: int = 4) -> str:
    opts = ", async='true'" if mode == "async" else ""
    return APP.format(extra=extra, opts=opts, sample=sample)


def events(n: int = 200, seed: int = 7) -> list:
    """``n`` seeded ``(dev, v, ts)``: ``v`` whole, so every float32 sum
    of the window is exact and the rows compare without a tolerance."""
    rng = np.random.default_rng(seed)
    dev = rng.integers(0, 6, n)
    v = rng.integers(0, 100, n).astype(np.float64)
    ts = 1000 + np.cumsum(rng.integers(1, 9, n))
    return [(f"d{int(d)}", float(x), int(t))
            for d, x, t in zip(dev, v, ts)]


def run(pkg, app: str, evs: list) -> dict:
    """``app`` on ``pkg``'s engine (the port's on the CPU), fed ``evs``
    and drained; every surface read before the shutdown."""
    m = pkg.SiddhiManager(**({"device": "cpu"} if pkg is siddhi_tpu_torch
                             else {}))
    rt = m.create_siddhi_app_runtime(app, playback=True)
    rows = {s: [] for s in OUTS}
    for s in OUTS:
        rt.add_callback(s, pkg.StreamCallback(
            lambda evs, r=rows[s]: r.extend((e.timestamp, list(e.data))
                                            for e in evs)))
    rt.start()
    ih = rt.input_handler("S")
    for dev, v, ts in evs:
        ih.send([dev, v], timestamp=ts)
    rt.flush_device()
    obs = rt.observability
    out = {
        "rows": rows,
        "probes": {b.query_name: dict(
            steps=b.probe.steps, events=b.probe.events,
            pad_ratio=b.probe.pad_ratio,
            flush_causes=dict(b.probe.flush_causes))
            for b in rt.device_bridges},
        "traces": obs.trace_export()["traces"],
        "flight": obs.flight_export()["entries"],
        "latency": obs.latency_report(),
        "guards": {g.query_name: g.failures for g in rt.resilience.guards},
        "rt": rt,
    }
    render = port_render if pkg is siddhi_tpu_torch else ref_render
    out["metrics"] = render([rt.ctx.statistics_manager])
    m.shutdown()
    return out


def both(app: str, evs: list) -> tuple:
    return run(siddhi_tpu, app, evs), run(siddhi_tpu_torch, app, evs)


# a sample is a time, or derived from one, when its family says so
TIME_WORDS = ("seconds", "latency", "_ms", "per_second", "idle_frac",
              "overlap_efficiency", "pipeline_depth", "throughput", "rate",
              "duration", "uptime", "last_")


def parse_exposition(text: str) -> dict:
    """Prometheus 0.0.4 text → ``{family: (type, {labels: value})}``;
    raises on a line the format does not allow (an exemplar included)."""
    fams, types = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            fams.setdefault(name, (kind, {}))
            continue
        if line.startswith("# HELP "):
            continue
        assert not line.startswith("#"), line
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        labels = tuple(sorted(
            (k, v.strip('"')) for k, _, v in (
                p.partition("=") for p in labels.rstrip("}").split(",")
                if p))) if labels else ()
        family = next((f for f in (name, name.rsplit("_", 1)[0])
                       if f in types), None)
        assert family is not None, f"sample without a TYPE: {line}"
        fams[family][1][(name, labels)] = float(value)
    return fams


def span_order(trace: dict, mode: str):
    """A trace's ``(stage, name)`` spans in order; with ``async``, in order
    for each name (a query's spans come from its own worker)."""
    spans = [(s["stage"], s["name"]) for s in trace["spans"]]
    if mode == "sync":
        return spans
    by = {}
    for stage, name in spans:
        by.setdefault(name, []).append(stage)
    return by


def series(samples: dict) -> set:
    """A histogram's series: its samples' names and labels but ``le``."""
    return {(name, tuple(kv for kv in labels if kv[0] != "le"))
            for name, labels in samples}


def timed(family: str) -> bool:
    return any(w in family for w in TIME_WORDS) or \
        family.endswith(("_bucket", "_sum"))


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_probes_traces_metrics_and_latency_match_reference(mode):
    evs = events()
    ref, got = both(app_text(mode), evs)
    assert got["rows"] == ref["rows"]
    assert all(ref["rows"][s] for s in OUTS)
    # the probes: steps, events, padding and why each batch flushed
    assert set(got["probes"]) == set(QUERIES)
    assert got["probes"] == ref["probes"]
    for p in got["probes"].values():
        assert p["steps"] and sum(p["flush_causes"].values()) == p["steps"]
    # one trace every 4th event, each with its stages in the same order
    # (async: each query's in order; the queries' workers interleave)
    assert len(got["traces"]) == len(ref["traces"]) == len(evs) // 4
    for r, g in zip(ref["traces"], got["traces"]):
        assert span_order(g, mode) == span_order(r, mode)
    stages = {(s["stage"], s["name"]) for t in got["traces"]
              for s in t["spans"]}
    assert {("fill-wait", q) for q in QUERIES} <= stages
    assert {("device", q) for q in QUERIES} <= stages
    # the exposition: families, types, labels; values but the timed ones
    rf, gf = parse_exposition(ref["metrics"]), parse_exposition(
        got["metrics"])
    assert "# {" not in got["metrics"]
    assert set(gf) == set(rf)
    for fam, (kind, samples) in rf.items():
        assert gf[fam][0] == kind, fam
        if kind == "histogram":
            # the buckets a sample fills are times: the series without
            # ``le`` and the number of samples in each must agree
            assert series(gf[fam][1]) == series(samples), fam
            counts = {k: v for k, v in samples.items()
                      if k[0].endswith("_count")}
            assert {k: gf[fam][1][k] for k in counts} == counts, fam
            continue
        assert set(gf[fam][1]) == set(samples), fam
        if timed(fam):
            continue
        for key, v in samples.items():
            assert gf[fam][1][key] == v, (fam, key)
    steps = {dict(k[1])["query"]: v for k, v in
             gf["siddhi_tpu_device_steps_total"][1].items()}
    assert steps == {q: got["probes"][q]["steps"] for q in QUERIES}
    # latency: the same keys, every query's phases reconciled
    lr, lg = ref["latency"]["queries"], got["latency"]["queries"]
    assert set(lg) == set(lr)
    for q in lr:
        assert set(lg[q]) == set(lr[q]), q
        assert set(lg[q]["phases"]) == set(lr[q]["phases"]), q
    for q in QUERIES:
        for rep in (lr[q], lg[q]):
            assert math.isclose(rep["reconciliation_ratio"], 1.0,
                                abs_tol=1e-9)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_flight_recorder_under_chaos_matches_reference(mode):
    evs = events(320, seed=3)
    ref, got = both(app_text(mode, CHAOS[mode]), evs)
    assert got["rows"] == ref["rows"]
    assert got["guards"] == ref["guards"] and sum(got["guards"].values())

    def entries(run):
        """Sync: the whole ring in order. Async: each (category, site) in
        order: the flow entries come from the engine thread, the device
        and breaker entries from each query's worker, and the threads
        interleave as they run."""
        out = [(e["category"], e["kind"], e["site"]) for e in run["flight"]]
        if mode == "sync":
            return out
        by = {}
        for c, k, s in out:
            by.setdefault((c, s), []).append(k)
        return by

    assert entries(got) == entries(ref)
    # every failed step is on the ring, and with a threshold of 1 it
    # opened its circuit; each query fell back
    for q, n in got["guards"].items():
        opened = [e for e in got["flight"] if e["category"] == "breaker"
                  and e["site"] == f"device:{q}"
                  and e["kind"] == "circuit:open"]
        failed = [e for e in got["flight"] if e["kind"] == "step_failed"
                  and e["site"] == q]
        assert len(failed) == n
        assert len(opened) == (n if mode == "sync" else 0)
        assert ("device", "fallback_step", q) in {
            (e["category"], e["kind"], e["site"]) for e in got["flight"]}
    t = [e["t_ns"] for e in got["flight"]]
    assert t == sorted(t)
    assert got["probes"] == ref["probes"]


def test_flight_dump_on_quarantine_matches_reference(tmp_path):
    app = ("@app(name='Q')\n@app:flightrecorder(ring='256', dir='{d}')\n"
           "@app:chaos(seed='3', device.fail.p='1.0')\n"
           "@app:resilience(device.circuit.threshold='2', "
           "device.circuit.cooldown.ms='60000')\n"
           "define stream S (dev string, v double);\n"
           "@device(batch='4') from S[v > 0.0] select dev, v insert into F;")
    dumps = {}
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        d = tmp_path / pkg.__name__
        kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
        m = pkg.SiddhiManager(**kw)
        rt = m.create_siddhi_app_runtime(app.format(d=d), playback=True)
        rt.start()
        for i in range(12):
            rt.input_handler("S").send(["d", 1.0 + i], timestamp=1000 + i)
        rt.flush_device()
        m.shutdown()
        (f,) = os.listdir(d)
        dumps[pkg] = json.loads((d / f).read_text())
    ref, got = dumps[siddhi_tpu], dumps[siddhi_tpu_torch]
    assert got["reason"] == ref["reason"] == "device_quarantine"
    assert [(e["category"], e["kind"], e["site"]) for e in got["entries"]] \
        == [(e["category"], e["kind"], e["site"]) for e in ref["entries"]]


# ----------------------------------------------------------------- parsers

BAD = {
    "sample_not_one": "@app:trace(sample='2/5')",
    "sample_zero": "@app:trace(sample='0')",
    "sample_text": "@app:trace(sample='1/x')",
    "ring_zero": "@app:trace(sample='1/2', ring='0')",
    "flight_ring_text": "@app:flightrecorder(ring='many')",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_annotation_errors_match_reference(name):
    app = BAD[name] + "\ndefine stream S (v double);\n" \
        "from S select v insert into O;"
    errors = []
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch, {"device": "cpu"})):
        with pytest.raises(Exception) as e:
            pkg.SiddhiManager(**kw).create_siddhi_app_runtime(
                app, playback=True)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0]


def test_annotation_parsers_match_reference():
    from siddhi_tpu.query_api.annotation import Annotation as RefAnn
    from siddhi_tpu.observability.flight_recorder import \
        parse_flightrecorder_annotation as ref_flight
    from siddhi_tpu.observability.tracing import \
        parse_trace_annotation as ref_trace
    from siddhi_tpu_torch.observability.flight_recorder import \
        parse_flightrecorder_annotation as port_flight
    from siddhi_tpu_torch.observability.tracing import \
        parse_trace_annotation as port_trace
    from siddhi_tpu_torch.query_api.annotation import Annotation as PortAnn

    def ann(cls, **kv):
        a = cls("trace")
        for k, v in kv.items():
            a.element(k, v)
        return a

    for kv in ({"sample": "1/8"}, {"sample": "8", "ring": "16"}, {}):
        r, p = ref_trace(ann(RefAnn, **kv)), port_trace(ann(PortAnn, **kv))
        assert (p.sample_n, p.ring.maxlen) == (r.sample_n, r.ring.maxlen)
    r = ref_flight(ann(RefAnn, ring="64", dir="x"), "A")
    p = port_flight(ann(PortAnn, ring="64", dir="x"), "A")
    assert p.report() == r.report()
    assert port_flight(None, "A").report() == ref_flight(None, "A").report()


# ---------------------------------------------------------------- profiler

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_profile_writes_a_trace_with_the_step_ranges(mode, tmp_path):
    app = (f"@app(name='Prof')\n@app:profile(dir='{tmp_path}')\n"
           + app_text(mode).split("\n", 3)[3])
    got = run(siddhi_tpu_torch, app, events(64))
    prof = got["rt"].observability.profiler
    assert prof.trace_path and os.path.dirname(prof.trace_path) == \
        str(tmp_path)
    names = {e.get("name") for e in
             json.load(open(prof.trace_path))["traceEvents"]}
    for q in QUERIES:
        assert f"siddhi:step:{q}" in names
    assert not prof.nvtx                # NVTX stays off the CPU path


def test_profile_without_dir_annotates_only():
    app = "@app:profile(enable='true')\n" + \
        app_text("sync").split("\n", 3)[3]
    ref, got = both(app, events(48))
    assert got["rows"] == ref["rows"]
    assert got["rt"].observability.profiler.trace_path is None


# ------------------------------------------------- extensions and doc-gen

def test_extension_validation_and_docs_match_reference():
    """The service suite's extension checks, with each package's own
    ``DataType``: the same verdicts and messages, the same docs."""
    out = []
    for pkg in (siddhi_tpu, siddhi_tpu_torch):
        ext = __import__(f"{pkg.__name__}.core.extension",
                         fromlist=["x"])
        DataType = __import__(f"{pkg.__name__}.query_api.definition",
                              fromlist=["x"]).DataType
        doc_gen = __import__(f"{pkg.__name__}.doc_gen", fromlist=["x"])

        class Concat(ext.ScalarFunctionExtension):
            return_type = DataType.STRING

            def execute(self, args):
                return "".join(str(a) for a in args)

        cls = ext.extension(
            "custom:concat2", kind="function",
            description="Concatenates two strings.",
            parameters=[ext.Parameter("s1", [DataType.STRING], "first"),
                        ext.Parameter("s2", [DataType.STRING], "second",
                                      optional=True, default="")],
            return_attributes=[ext.ReturnAttribute("out",
                                                   [DataType.STRING])],
            examples=[ext.Example("select custom:concat2(a, b) as ab",
                                  "joins a and b")])(Concat)
        verdicts = []
        for args in ([DataType.STRING, DataType.STRING], [DataType.STRING],
                     [], [DataType.INT]):
            try:
                ext.validate_extension_args(cls, args)
                verdicts.append("ok")
            except TypeError as e:
                verdicts.append(str(e))
        md = doc_gen.generate_extension_docs({"custom:concat2": cls},
                                             title="My Exts")
        out.append((verdicts, md))
    assert out[1] == out[0]
    assert out[1][0][:2] == ["ok", "ok"]
