"""Extension registry: the ``@extension`` decorator ≈ the reference's ``@Extension``
annotation + ``SiddhiExtensionLoader`` (annotation-scanned classpath loading,
``util/SiddhiExtensionLoader.java:99``). Python entry points replace classpath
scanning; kinds mirror the reference's extension types. Parameter metadata +
validation mirror ``siddhi-annotations`` (``@Parameter``/``@ParameterOverload``/
``@ReturnAttribute``/``@Example`` and
``util/extension/validator/InputParameterValidator.java``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..query_api.definition import DataType, StreamDefinition

GLOBAL_EXTENSIONS: dict[str, type] = {}

EXTENSION_KINDS = {
    "function",          # scalar function (FunctionExecutor)
    "aggregator",        # attribute aggregator
    "window",            # window processor
    "stream_function",   # stream processor / stream function
    "source", "sink", "source_mapper", "sink_mapper", "store",
}


@dataclass
class Parameter:
    """Reference ``@Parameter`` — one declared argument of an extension."""

    name: str
    types: list[DataType]
    description: str = ""
    optional: bool = False
    default: Optional[str] = None
    dynamic: bool = False


@dataclass
class ReturnAttribute:
    """Reference ``@ReturnAttribute``."""

    name: str
    types: list[DataType]
    description: str = ""


@dataclass
class Example:
    """Reference ``@Example``."""

    syntax: str
    description: str = ""


@dataclass
class ExtensionMeta:
    """Reference ``@Extension`` metadata block, attached as
    ``cls.extension_meta`` and consumed by the doc generator + validator."""

    name: str
    kind: str
    description: str = ""
    parameters: list[Parameter] = field(default_factory=list)
    return_attributes: list[ReturnAttribute] = field(default_factory=list)
    examples: list[Example] = field(default_factory=list)


def extension(name: str, kind: str = "function", description: str = "",
              parameters: Optional[list[Parameter]] = None,
              return_attributes: Optional[list[ReturnAttribute]] = None,
              examples: Optional[list[Example]] = None):
    """Class decorator: ``@extension("str:concat", kind="function",
    parameters=[Parameter("s1", [DataType.STRING]), ...])``.

    Parameter metadata, when given, is validated against call-site argument
    types at build time (reference ``InputParameterValidator``).
    """
    if kind not in EXTENSION_KINDS:
        raise ValueError(f"unknown extension kind '{kind}'")

    def deco(cls):
        cls.extension_kind = kind
        cls.extension_name = name
        plist = list(parameters or [])
        # positional validation matches arg i against params[i], which is only
        # sound when every optional parameter trails the required ones —
        # reject bad metadata at declaration, not with misleading call errors
        seen_optional = False
        for p in plist:
            if p.optional:
                seen_optional = True
            elif seen_optional:
                raise ValueError(
                    f"extension '{name}': required parameter '{p.name}' "
                    f"follows an optional one; optional parameters must be "
                    f"trailing")
        cls.extension_meta = ExtensionMeta(
            name=name, kind=kind, description=description,
            parameters=plist,
            return_attributes=list(return_attributes or []),
            examples=list(examples or []))
        GLOBAL_EXTENSIONS[name] = cls
        return cls

    return deco


def validate_extension_args(cls, arg_types: list[Optional[DataType]]) -> None:
    """Check call-site argument types against declared ``Parameter`` metadata
    (reference ``InputParameterValidator.java``). No-op without metadata."""
    meta: Optional[ExtensionMeta] = getattr(cls, "extension_meta", None)
    if meta is None or not meta.parameters:
        return
    params = meta.parameters
    required = sum(1 for p in params if not p.optional)
    if not (required <= len(arg_types) <= len(params)):
        expected = str(required) if required == len(params) else \
            f"{required}..{len(params)}"
        raise TypeError(
            f"extension '{meta.name}' expects {expected} argument(s), "
            f"got {len(arg_types)}")
    for i, at in enumerate(arg_types):
        p = params[i]
        if at is None or DataType.OBJECT in p.types:
            continue        # unknown/any — accept
        if at not in p.types:
            raise TypeError(
                f"extension '{meta.name}' parameter '{p.name}' accepts "
                f"{[t.value for t in p.types]}, got {at.value}")


class ScalarFunctionExtension:
    """Base for scalar function extensions.

    Subclasses implement ``execute(args) -> value`` and set ``return_type``.
    """

    extension_kind = "function"
    return_type: DataType = DataType.OBJECT

    def execute(self, args: list) -> Any:
        raise NotImplementedError

    def bind(self, arg_fns: list[Callable], arg_types: list[DataType]):
        def run(frame):
            return self.execute([fn(frame) for fn in arg_fns])
        return run, self.return_type


class StreamFunctionExtension:
    """Base for stream functions: N input attrs → appended output attrs.

    ``init`` returns the output StreamDefinition; ``process`` returns payload
    rows (input data + appended values).
    """

    extension_kind = "stream_function"

    def init(self, input_def: StreamDefinition, params, param_fns) -> StreamDefinition:
        raise NotImplementedError

    def process(self, event, param_values: list):
        raise NotImplementedError


class ScriptFunction:
    """``define function f[lang] return type { body }`` — script-language UDF.

    Supported languages: ``python`` (body is an expression or function body using
    ``data`` — the argument list). JavaScript bodies are not executable without a
    JS engine; defining them raises at build time (reference parity would need
    Nashorn/GraalJS).
    """

    def __init__(self, fid: str, language: str, return_type: DataType, body: str):
        self.id = fid
        self.language = language.lower()
        self.return_type = return_type
        self.body = body
        if self.language not in ("python", "py"):
            raise ValueError(
                f"script language '{language}' not supported (use python)")
        src = body.strip()
        ns: dict[str, Any] = {}
        try:
            code = compile(src, f"<function {fid}>", "eval")
            self._fn = lambda data: eval(code, {"__builtins__": {}}, {"data": data})  # noqa: S307
        except SyntaxError:
            indented = "\n".join("    " + line for line in src.splitlines())
            exec(compile(f"def __udf__(data):\n{indented}\n",  # noqa: S102
                         f"<function {fid}>", "exec"), ns)
            self._fn = ns["__udf__"]

    def bind(self, arg_fns: list[Callable], arg_types: list[DataType]):
        def run(frame):
            return self._fn([fn(frame) for fn in arg_fns])
        return run, self.return_type
