"""Documentation generator: extension metadata + the built-in standard
library → markdown pages and an mkdocs site.

The port's copy of the JAX package's ``doc_gen.py``.

Reference: ``modules/siddhi-doc-gen`` — a Maven mojo suite
(``core/MkdocsGitHubPagesDeployMojo.java``, ``metadata/*.java``, freemarker
templates ``documentation.md.ftl``/``utils.ftl``) that scans ``@Extension``
annotations — INCLUDING the engine's own built-in windows, aggregators and
functions, which the reference annotates like any extension — and renders a
versioned mkdocs site. Here the same pipeline is native Python:

- :data:`BUILTIN_LIBRARY` carries curated ``ExtensionMeta`` blocks for the
  built-in windows / aggregators / scalar functions / transports (the
  reference keeps these in ``@Extension`` Java annotations; this engine's
  built-ins are table-driven, so their metadata lives here);
- :func:`syntax_for` renders the reference's syntax line
  (``<TYPE> ns:name(<TYPE> arg, ...)`` — ``utils.ftl``);
- :func:`generate_extension_docs` renders one markdown page per kind;
- :func:`generate_site` writes an mkdocs tree (``mkdocs.yml`` + ``docs/``)
  with an index page of per-kind summary tables — the deploy half of the
  reference mojo is out of scope by design (zero-egress environment).

CLI: ``python -m siddhi_tpu_torch.doc_gen --out site/`` builds the full site.
"""

from __future__ import annotations

import os
from typing import Optional

from .core.extension import (
    Example,
    ExtensionMeta,
    GLOBAL_EXTENSIONS,
    Parameter,
    ReturnAttribute,
)
from .query_api.definition import DataType

_N = (DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE)


def _p(name, types, desc, optional=False, default=None):
    return Parameter(name, list(types), desc, optional, default)


def _m(name, kind, desc, params=(), returns=(), examples=()):
    return ExtensionMeta(name, kind, desc, list(params), list(returns),
                         [Example(s, d) for s, d in examples])


# ---------------------------------------------------------------------------
# built-in standard library metadata (the reference documents its built-ins
# through the same @Extension pipeline — siddhi-core's window/ and
# aggregator/ classes all carry annotations)
# ---------------------------------------------------------------------------

BUILTIN_LIBRARY: list[ExtensionMeta] = [
    # -- windows (core/windows.py; reference .../stream/window/*.java) ------
    _m("length", "window", "Sliding window holding the last N events.",
       [_p("window.length", [DataType.INT], "number of events retained")],
       examples=[("from S#window.length(10) select sum(v) as t insert into O;",
                  "running sum over the newest 10 events")]),
    _m("lengthBatch", "window", "Tumbling window emitting every N events.",
       [_p("window.length", [DataType.INT], "batch size")],
       examples=[("from S#window.lengthBatch(4) select sum(v) as t "
                  "insert into O;", "one aggregate row per 4-event batch")]),
    _m("time", "window", "Sliding event-time window over the last period.",
       [_p("window.time", [DataType.INT, DataType.LONG], "retention period")],
       examples=[("from S#window.time(1 sec) select avg(v) as a "
                  "insert into O;", "")]),
    _m("timeBatch", "window",
       "Tumbling event-time window flushed at period boundaries.",
       [_p("window.time", [DataType.INT, DataType.LONG], "bucket duration"),
        _p("start.time", [DataType.INT, DataType.LONG],
           "boundary phase offset", optional=True)]),
    _m("timeLength", "window",
       "Sliding window bounded by BOTH a period and a max event count.",
       [_p("window.time", [DataType.INT, DataType.LONG], "retention period"),
        _p("window.length", [DataType.INT], "max events retained")]),
    _m("externalTime", "window",
       "Sliding window driven by an event-time ATTRIBUTE, not arrival time.",
       [_p("timestamp", [DataType.LONG], "event-time attribute"),
        _p("window.time", [DataType.INT, DataType.LONG], "retention period")]),
    _m("externalTimeBatch", "window",
       "Tumbling window bucketed on an event-time attribute.",
       [_p("timestamp", [DataType.LONG], "event-time attribute"),
        _p("window.time", [DataType.INT, DataType.LONG], "bucket duration"),
        _p("start.time", [DataType.INT, DataType.LONG], "phase offset",
           optional=True)]),
    _m("session", "window",
       "Gap-separated session batches, optionally keyed, with allowed "
       "latency for late arrivals.",
       [_p("session.gap", [DataType.INT, DataType.LONG], "inactivity gap"),
        _p("session.key", [DataType.STRING], "per-key sessions",
           optional=True),
        _p("allowed.latency", [DataType.INT, DataType.LONG],
           "late-arrival grace period", optional=True)]),
    _m("batch", "window", "Chunk window: each delivered chunk is the batch.",
       [_p("window.length", [DataType.INT], "optional length bound",
           optional=True)]),
    _m("delay", "window", "Pass-through after a fixed delay.",
       [_p("window.delay", [DataType.INT, DataType.LONG], "hold period")]),
    _m("sort", "window",
       "Keeps the N best events by sort key; evicts the per-order worst.",
       [_p("window.length", [DataType.INT], "events retained"),
        _p("attribute", list(_N) + [DataType.STRING], "sort key"),
        _p("order", [DataType.STRING], "'asc' (default) or 'desc'",
           optional=True, default="asc")]),
    _m("frequent", "window",
       "Misra-Gries heavy-hitters: retains the most frequent event keys.",
       [_p("event.count", [DataType.INT], "counter capacity"),
        _p("attribute", [DataType.STRING], "key attributes (defaults to "
           "the whole row)", optional=True)]),
    _m("lossyFrequent", "window",
       "Lossy-counting frequent items above a support threshold.",
       [_p("support.threshold", [DataType.DOUBLE], "minimum frequency"),
        _p("error.bound", [DataType.DOUBLE], "counting error bound",
           optional=True)]),
    _m("hopping", "window",
       "Fixed-length window emitted every hop interval (overlapping "
       "tumbling buckets).",
       [_p("window.time", [DataType.INT, DataType.LONG], "window length"),
        _p("hop.time", [DataType.INT, DataType.LONG], "emission interval")]),
    _m("cron", "window", "Batch window flushed on a cron schedule.",
       [_p("cron.expression", [DataType.STRING], "quartz-style expression")]),
    _m("expression", "window",
       "Sliding window retaining events while an expression over the "
       "buffer holds.",
       [_p("expression", [DataType.STRING], "retention condition")]),
    _m("expressionBatch", "window",
       "Tumbling variant of the expression window: flushes when the "
       "condition breaks.",
       [_p("expression", [DataType.STRING], "flush condition")]),
    _m("empty", "window", "Pass-through window — `#window()`."),

    # -- aggregators (core/aggregators.py; reference .../aggregator/) -------
    _m("sum", "aggregator", "Running sum (int64-exact for integer args).",
       [_p("arg", _N, "value to sum")]),
    _m("count", "aggregator", "Event count."),
    _m("avg", "aggregator", "Running average.", [_p("arg", _N, "value")]),
    _m("min", "aggregator",
       "Running minimum with retraction (expired events restore the "
       "previous extreme).", [_p("arg", _N, "value")]),
    _m("max", "aggregator", "Running maximum with retraction.",
       [_p("arg", _N, "value")]),
    _m("minForever", "aggregator",
       "All-time minimum — never retracts, survives window expiry."),
    _m("maxForever", "aggregator", "All-time maximum — never retracts."),
    _m("distinctCount", "aggregator",
       "Count of distinct values currently in scope.",
       [_p("arg", list(_N) + [DataType.STRING], "value")]),
    _m("stdDev", "aggregator", "Population standard deviation.",
       [_p("arg", _N, "value")]),
    _m("and", "aggregator", "Logical AND over boolean values in scope."),
    _m("or", "aggregator", "Logical OR over boolean values in scope."),
    _m("unionSet", "aggregator", "Set union of values in scope "
       "(pairs with sizeOfSet())."),

    # -- scalar functions (core/executor.py builtins) -----------------------
    _m("coalesce", "function", "First non-null argument.",
       [_p("args", list(_N) + [DataType.STRING], "candidates (variadic)")]),
    _m("convert", "function", "Numeric/string conversion to a target type.",
       [_p("value", list(_N) + [DataType.STRING], "input"),
        _p("type", [DataType.STRING], "'int'|'long'|'float'|'double'|"
           "'string'|'bool'")]),
    _m("cast", "function", "Type assertion/cast.",
       [_p("value", list(_N) + [DataType.STRING], "input"),
        _p("type", [DataType.STRING], "target type name")]),
    _m("ifThenElse", "function", "Conditional expression.",
       [_p("condition", [DataType.BOOL], "predicate"),
        _p("if.expression", list(_N) + [DataType.STRING], "then value"),
        _p("else.expression", list(_N) + [DataType.STRING], "else value")]),
    _m("UUID", "function", "Random UUID string."),
    _m("currentTimeMillis", "function", "Engine clock timestamp (ms)."),
    _m("eventTimestamp", "function", "The current event's timestamp."),
    _m("maximum", "function", "Maximum of its arguments.",
       [_p("args", _N, "values (variadic)")]),
    _m("minimum", "function", "Minimum of its arguments.",
       [_p("args", _N, "values (variadic)")]),
    _m("instanceOfString", "function", "Type check: string."),
    _m("instanceOfInteger", "function", "Type check: int."),
    _m("instanceOfLong", "function", "Type check: long."),
    _m("instanceOfFloat", "function", "Type check: float."),
    _m("instanceOfDouble", "function", "Type check: double."),
    _m("instanceOfBoolean", "function", "Type check: bool."),
    _m("createSet", "function", "Singleton set for unionSet aggregation.",
       [_p("value", list(_N) + [DataType.STRING], "element")]),
    _m("sizeOfSet", "function", "Cardinality of a unionSet result.",
       [_p("set", [DataType.OBJECT], "set value")]),
    _m("default", "function", "Value with a fallback when null.",
       [_p("value", list(_N) + [DataType.STRING], "input"),
        _p("default", list(_N) + [DataType.STRING], "fallback")]),
    _m("log", "function", "Logs the event; passes the value through.",
       [_p("priority", [DataType.STRING], "log level", optional=True),
        _p("message", [DataType.STRING], "log line")]),
    _m("str:concat", "function", "String concatenation.",
       [_p("args", [DataType.STRING], "strings (variadic)")],
       [ReturnAttribute("value", [DataType.STRING], "joined string")]),

    # -- transports (core/io.py) -------------------------------------------
    _m("inMemory", "source", "Engine-local topic subscription "
       "(InMemoryBroker).",
       [_p("topic", [DataType.STRING], "topic name")]),
    _m("inMemory", "sink", "Engine-local topic publication.",
       [_p("topic", [DataType.STRING], "topic name")]),
    _m("log", "sink", "Logs outgoing events.",
       [_p("prefix", [DataType.STRING], "line prefix", optional=True)]),
    _m("passThrough", "source_mapper", "Rows arrive already positional."),
    _m("json", "source_mapper", "JSON object/array payloads → rows."),
    _m("passThrough", "sink_mapper", "Events leave as positional rows."),
    _m("json", "sink_mapper", "Events leave as JSON objects."),
    _m("text", "sink_mapper", "Events leave as templated text.",
       [_p("template", [DataType.STRING], "text with {{attr}} slots",
           optional=True)]),
]


def _types_str(types) -> str:
    return ", ".join(t.value for t in types) if types else "any"


def syntax_for(meta: ExtensionMeta) -> str:
    """The reference's syntax line (``utils.ftl``):
    ``<RET> ns:name(<TYPES> arg, ...)``."""
    args = ", ".join(
        f"<{'|'.join(t.value.upper() for t in p.types) or 'ANY'}> {p.name}"
        for p in meta.parameters)
    ret = ""
    if meta.return_attributes:
        rts = "|".join(t.value.upper()
                       for t in meta.return_attributes[0].types)
        ret = f"<{rts}> "
    if meta.kind == "window":
        return f"{ret}#window.{meta.name}({args})"
    if meta.kind in ("source", "sink"):
        return f"@{meta.kind}(type='{meta.name}', ...)"
    if meta.kind.endswith("_mapper"):
        return f"@map(type='{meta.name}', ...)"
    if meta.kind == "store":
        return f"@store(type='{meta.name}', ...)"
    return f"{ret}{meta.name}({args})"


def _collect(extensions: Optional[dict], include_builtins: bool):
    by_kind: dict[str, list[ExtensionMeta]] = {}
    if include_builtins:
        for meta in BUILTIN_LIBRARY:
            by_kind.setdefault(meta.kind, []).append(meta)
    exts = extensions if extensions is not None else GLOBAL_EXTENSIONS
    for name, cls in sorted(exts.items()):
        meta = getattr(cls, "extension_meta", None)
        if meta is None:
            meta = ExtensionMeta(
                name=name, kind=getattr(cls, "extension_kind", "function"),
                description=(cls.__doc__ or "").strip().split("\n")[0])
        by_kind.setdefault(meta.kind, []).append(meta)
    for metas in by_kind.values():
        metas.sort(key=lambda m: m.name)
    return by_kind


def _render_meta(meta: ExtensionMeta, lines: list[str]) -> None:
    lines.append(f"### {meta.name}")
    lines.append("")
    lines.append(f"```\n{syntax_for(meta)}\n```")
    lines.append("")
    if meta.description:
        lines.append(meta.description)
        lines.append("")
    if meta.parameters:
        lines.append("**Parameters**")
        lines.append("")
        lines.append("| name | types | optional | default | description |")
        lines.append("|---|---|---|---|---|")
        for p in meta.parameters:
            lines.append(
                f"| {p.name} | {_types_str(p.types)} | "
                f"{'yes' if p.optional else 'no'} | "
                f"{p.default if p.default is not None else '–'} | "
                f"{p.description} |")
        lines.append("")
    if meta.return_attributes:
        lines.append("**Returns**")
        lines.append("")
        for r in meta.return_attributes:
            lines.append(f"- `{r.name}` ({_types_str(r.types)})"
                         f"{': ' + r.description if r.description else ''}")
        lines.append("")
    if meta.examples:
        lines.append("**Examples**")
        lines.append("")
        for ex in meta.examples:
            lines.append("```sql")
            lines.append(ex.syntax)
            lines.append("```")
            if ex.description:
                lines.append("")
                lines.append(ex.description)
            lines.append("")


def generate_extension_docs(extensions: Optional[dict] = None,
                            title: str = "Extensions",
                            include_builtins: bool = False) -> str:
    """Render markdown API docs for registered extensions (and, when
    ``include_builtins``, the built-in standard library), grouped by kind."""
    by_kind = _collect(extensions, include_builtins)
    lines = [f"# {title}", ""]
    for kind in sorted(by_kind):
        lines.append(f"## {kind.replace('_', ' ').title()}")
        lines.append("")
        for meta in by_kind[kind]:
            _render_meta(meta, lines)
    return "\n".join(lines).rstrip() + "\n"


def write_extension_docs(path: str, extensions: Optional[dict] = None,
                         title: str = "Extensions") -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(generate_extension_docs(extensions, title))


def generate_site(out_dir: str, extensions: Optional[dict] = None,
                  site_name: str = "siddhi_tpu_torch API") -> list[str]:
    """Write an mkdocs tree: ``mkdocs.yml`` + ``docs/index.md`` (per-kind
    summary tables) + one page per kind covering built-ins and registered
    extensions. Returns the written paths (reference:
    ``MkdocsGitHubPagesDeployMojo`` minus the deploy/versioning legs)."""
    by_kind = _collect(extensions, include_builtins=True)
    docs = os.path.join(out_dir, "docs")
    os.makedirs(docs, exist_ok=True)
    written = []

    index = ["# " + site_name, "",
             "Auto-generated API documentation for the built-in standard "
             "library and registered extensions.", ""]
    nav = ["  - Home: index.md"]
    for kind in sorted(by_kind):
        page = f"{kind}.md"
        title = kind.replace("_", " ").title()
        nav.append(f"  - {title}: {page}")
        index.append(f"## {title}")
        index.append("")
        index.append("| name | description |")
        index.append("|---|---|")
        for meta in by_kind[kind]:
            anchor = meta.name.lower().replace(":", "")
            first = meta.description.split(". ")[0].rstrip(".")
            index.append(f"| [{meta.name}]({page}#{anchor}) | {first} |")
        index.append("")
        lines = [f"# {title}", ""]
        for meta in by_kind[kind]:
            _render_meta(meta, lines)
        p = os.path.join(docs, page)
        with open(p, "w", encoding="utf-8") as f:
            f.write("\n".join(lines).rstrip() + "\n")
        written.append(p)

    p = os.path.join(docs, "index.md")
    with open(p, "w", encoding="utf-8") as f:
        f.write("\n".join(index).rstrip() + "\n")
    written.append(p)

    p = os.path.join(out_dir, "mkdocs.yml")
    with open(p, "w", encoding="utf-8") as f:
        f.write(f"site_name: {site_name}\ntheme: readthedocs\nnav:\n"
                + "\n".join(nav) + "\n")
    written.append(p)
    return written


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate the siddhi_tpu_torch API documentation site")
    ap.add_argument("--out", default="site",
                    help="output directory (default: ./site)")
    ap.add_argument("--site-name", default="siddhi_tpu_torch API")
    args = ap.parse_args(argv)
    paths = generate_site(args.out, site_name=args.site_name)
    print(f"wrote {len(paths)} files under {args.out}/")
    return 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
