"""The reference corpora again, with a non-strict ``@device`` on every query.

Every case of ``test_pattern_corpus.CASES`` and ``test_window_corpus.CASES``
(imported as data) runs with ``@device(batch='32', slots='32')`` before each
of its queries on both engines, ``siddhi_tpu.SiddhiManager()`` (JAX on the
CPU) and ``siddhi_tpu_torch.SiddhiManager(device="cpu")``. A query the
device compilers take steps on the device; one they refuse falls back to
the interpreter. Both engines must build device bridges for exactly the
same queries, so a port compiler that refuses what the reference accepts
fails here instead of falling back quietly, and their rows (current and
expired, timestamps included) must be equal in order.
"""

import re

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from test_torch_host_corpus import (
    PATTERN_CASES,
    WINDOW_CASES,
    PortManager,
    run_pattern_case,
    run_window_case,
)

DEVICE = "@device(batch='32', slots='32')"
QUERY_START = re.compile(r"(?m)^([ \t]*)(?:@\w+(?::\w+)?\s*\([^()]*\)\s*)*from\b")


def with_device(app: str) -> str:
    """``DEVICE`` on a line of its own before every query (a line that
    starts with ``from``, or with the annotations before it)."""
    out = QUERY_START.sub(lambda m: f"{m.group(1)}{DEVICE}\n{m.group(0)}",
                          app)
    assert out != app, "no query found"
    return out


def bridges(rt) -> list:
    return sorted(b.query_name for b in rt.device_bridges)


@pytest.mark.parametrize("cid", list(PATTERN_CASES))
def test_pattern_corpus_case_with_device(cid):
    app, seq, _, end, _ = PATTERN_CASES[cid]
    app = with_device(app)
    ref, rrt = run_pattern_case(siddhi_tpu.SiddhiManager, siddhi_tpu, app,
                                seq, end)
    got, prt = run_pattern_case(PortManager, siddhi_tpu_torch, app, seq, end)
    assert bridges(prt) == bridges(rrt)
    assert got == ref


@pytest.mark.parametrize("cid", list(WINDOW_CASES))
def test_window_corpus_case_with_device(cid):
    app, sends, _, _, end = WINDOW_CASES[cid]
    app = with_device(app)
    ref, rrt = run_window_case(siddhi_tpu.SiddhiManager, siddhi_tpu, app,
                               sends, end)
    got, prt = run_window_case(PortManager, siddhi_tpu_torch, app, sends,
                               end)
    assert bridges(prt) == bridges(rrt)
    assert got == ref


def test_corpora_reach_the_device():
    """The rerun is not all fallbacks: most pattern cases build a bridge on
    both engines."""
    n = 0
    for cid, (app, _, _, end, _) in PATTERN_CASES.items():
        if end:
            continue
        rt = PortManager().create_siddhi_app_runtime(with_device(app),
                                                     playback=True)
        n += bool(rt.device_bridges)
    assert n >= 100
