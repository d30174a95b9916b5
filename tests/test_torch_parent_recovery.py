"""The port's durable fabric against a real parent SIGKILL, on the CPU.

The counterparts of the JAX package's ``tests/test_parent_recovery.py``
functions that drive only the JAX package's own processes and scripts (the
harness of ``test_torch_host_corpus.py`` runs the rest of that suite on the
port):

- ``test_parent_sigkill_chaos``: the same ``CHAOS_SITES`` (imported as
  data) against ``python -m siddhi_tpu_torch.procmesh.parentmain --device
  cpu``. The parent SIGKILLs itself at the site, is restarted over the same
  root (with the site's workers SIGKILLed too where the case says so), and
  must show every chunk applied once (``applied`` marks, ``dup_chunks ==
  0``), the recovery counts of the reference's test, and each tenant's
  sink, deduplicated by its ``(epoch, idx)`` identity, equal to the solo
  oracle run on the port's engine;
- the journal-intent lint (``scripts/check_guard_coverage.py``, loaded as
  data): ``check_journal_intent`` holds for the port's fabric and
  supervisor sites, and fails on copies of those sites with the journal
  append moved after the actuation or taken out.
"""

import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import time

import pytest

import siddhi_tpu_torch
from siddhi_tpu_torch.procmesh.parentmain import APP_TMPL, chunk_rows

import test_parent_recovery as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_parent(root, crash_at=None, timeout=180, **kw):
    """``parentmain`` of the port as a real subprocess, its workers on the
    CPU: ``None`` after the expected SIGKILL at ``crash_at``, else the
    parsed ``PARENT_DONE`` payload. Its output goes to files (leftover
    workers inherit the parent's stderr: a pipe would never reach EOF)."""
    env = dict(os.environ)
    env.pop("SIDDHI_CRASH_AT", None)
    if crash_at is not None:
        env["SIDDHI_CRASH_AT"] = crash_at
    cmd = [sys.executable, "-m", "siddhi_tpu_torch.procmesh.parentmain",
           "--root", root, "--device", "cpu"]
    for k, v in kw.items():
        cmd += ["--" + k.replace("_", "-"), str(v)]
    out_path = os.path.join(root, "parent.out")
    err_path = os.path.join(root, "parent.err")
    with open(out_path, "ab") as out, open(err_path, "ab") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                cwd=REPO)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    with open(out_path, encoding="utf-8") as f:
        done = [ln for ln in f if ln.startswith("PARENT_DONE ")]
    if crash_at is not None:
        assert rc == -signal.SIGKILL, \
            f"expected SIGKILL at {crash_at}, got rc={rc}"
        assert not done, f"crash at {crash_at} still printed PARENT_DONE"
        return None
    if rc != 0:
        with open(err_path, encoding="utf-8") as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"parentmain rc={rc}\n{tail}")
    assert done, "no PARENT_DONE hand-shake"
    return json.loads(done[-1].split(None, 1)[1])


def port_oracle_rows(chunks, width):
    """The solo run of the parent's app over the same bytes, on the port's
    engine on the CPU."""
    manager = siddhi_tpu_torch.SiddhiManager(device="cpu")
    try:
        rt = manager.create_siddhi_app_runtime(APP_TMPL.format(i=0),
                                               playback=True)
        got = []
        rt.add_callback("Out", siddhi_tpu_torch.StreamCallback(
            lambda evs: got.extend(list(e.data) for e in evs)))
        rt.start()
        handler = rt.input_handler("S")
        for c in range(chunks):
            rows, ts = chunk_rows(c, width)
            handler.send_rows([list(r) for r in rows], list(ts))
        return got
    finally:
        manager.shutdown()


@pytest.mark.parametrize("site,extra,kill_workers", ref.CHAOS_SITES,
                         ids=[f"{s}{'+dead' if k else ''}"
                              for s, _, k in ref.CHAOS_SITES])
def test_parent_sigkill_chaos(tmp_path, site, extra, kill_workers):
    root = str(tmp_path / "root")
    os.makedirs(root)
    kw = dict(hosts=2, tenants=2, chunks=4, width=2)
    kw.update(extra)
    try:
        run_parent(root, crash_at=site, **kw)
        if kill_workers:
            assert ref._kill_leftover_workers(root)
            time.sleep(0.2)
        done = run_parent(root, **kw)
    finally:
        ref._kill_leftover_workers(root)

    assert done["applied"] == {f"t{i}": kw["chunks"]
                               for i in range(kw["tenants"])}
    assert done["dup_chunks"] == 0

    rec = done["recovery"]
    if site == "journal.checkpoint":
        assert rec is None          # the boot checkpoint precedes any deploy
    else:
        assert rec is not None, "restart did not run parent recovery"
        assert rec["readopted_workers"] + rec["restored_workers"] == \
            kw["hosts"]
        assert 1 <= (rec["readopted_tenants"]
                     + rec["restored_tenants"]) <= kw["tenants"]
        if kill_workers:
            assert rec["restored_workers"] == kw["hosts"]
            assert rec["readopted_tenants"] == 0
        else:
            assert rec["readopted_workers"] == kw["hosts"]
        assert rec["recover_s"] >= 0.0
        assert rec["journal_records_replayed"] >= 1

    oracle = port_oracle_rows(kw["chunks"], kw["width"])
    assert len(oracle) == kw["chunks"] * kw["width"]
    for i in range(kw["tenants"]):
        deduped = ref._dedup(ref._read_sink(root, f"t{i}"))
        assert [e["d"] for e in deduped] == oracle, \
            f"t{i} diverged from solo oracle at {site}"
        assert all(e["s"] == "Out" and e["t"] == f"t{i}" for e in deduped)


# ----------------------------------------- the journal-intent lint, as data

def _guard_coverage_module():
    spec = importlib.util.spec_from_file_location(
        "check_guard_coverage_journal",
        os.path.join(REPO, "scripts", "check_guard_coverage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_journal_sites(mod) -> list:
    """The lint's ``journal_intent_sites`` with its imports pointed at the
    port's fabric and supervisor."""
    src = inspect.getsource(mod.journal_intent_sites)
    assert src.count("from siddhi_tpu.") == 2
    src = src.replace("from siddhi_tpu.", "from siddhi_tpu_torch.")
    ns = {"inspect": inspect}
    exec(compile(src, "check_guard_coverage[journal]", "exec"), ns)
    sites = ns["journal_intent_sites"]()
    assert len(sites) == 8
    return sites


def test_journal_intent_lint_passes_on_the_port():
    mod = _guard_coverage_module()
    sites = port_journal_sites(mod)
    assert mod.check_journal_intent(sites) == []


def test_journal_intent_lint_catches_offenders_on_the_port():
    """The check fails on every port site once its journal append follows
    the actuation, or is gone."""
    mod = _guard_coverage_module()
    sites = port_journal_sites(mod)
    swapped = [(name, src.replace(jm, "self._skip(") + "\n" + jm, jm, am)
               for name, src, jm, am in sites]
    missing = [(name, src.replace(jm, "self._skip("), jm, am)
               for name, src, jm, am in sites]
    problems = mod.check_journal_intent(swapped + missing)
    assert len(problems) == 2 * len(sites)
    assert all("precedes" in p for p in problems[:len(sites)])
    assert all("not found" in p for p in problems[len(sites):])
