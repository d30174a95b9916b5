"""The JAX package's process-mesh suites, run on the port.

``test_procmesh``, ``test_federation``, ``test_gray_failure`` and
``test_parent_recovery`` (``PROCMESH_SUITES``) go through the harness of
``test_torch_host_corpus.py``: every function is called with the
reference's names bound to the port's, its mesh and process-mesh modules
included, so a process-mode fabric of a suite is the port's, and each of
its hosts a worker process of the port's on the CPU (``python -m
siddhi_tpu_torch.procmesh.worker ... --device cpu``, each child importing
torch). The harness holds every such function to having spawned them and
kills whatever worker a function leaves behind. The functions that drive
only the JAX package's own processes and scripts are the harness's
``NOT_SUITE_FUNCTIONS``; their counterparts are in
``test_torch_parent_recovery.py``.

The file stands apart from ``test_torch_host_corpus.py`` so that
``--dist loadfile`` runs these suites, which spawn worker processes, on an
xdist worker of their own.
"""

import importlib

import pytest

import test_torch_host_corpus as harness

SUITE_FUNCTIONS = harness.suite_functions(harness.PROCMESH_SUITES)


@pytest.mark.parametrize("modname,fname,kwargs", SUITE_FUNCTIONS)
def test_reference_suite_function_on_the_port(modname, fname, kwargs,
                                              request, monkeypatch, tmp_path,
                                              caplog):
    harness.run_suite_function(modname, fname, kwargs, request, monkeypatch,
                               tmp_path, caplog)


def test_procmesh_suites_are_all_collected():
    """Every process-mesh suite contributes every function but those the
    harness runs elsewhere; none is cut to a subset."""
    mods = {p.values[0] for p in SUITE_FUNCTIONS}
    assert mods == set(harness.PROCMESH_SUITES)
    assert not set(harness.PROCMESH_SUITES) & set(harness.SUITES)
    assert not set(harness.PROCMESH_SUITES) & set(harness.SUITE_ONLY)
    names = {(p.values[0], p.values[1]) for p in SUITE_FUNCTIONS}
    for modname in harness.PROCMESH_SUITES:
        mod = importlib.import_module(modname)
        for name in vars(mod):
            if name.startswith("test_") and callable(getattr(mod, name)):
                assert ((modname, name) in names
                        or (modname, name) in harness.NOT_SUITE_FUNCTIONS), \
                    (modname, name)
    assert len([n for n in names if n[0] == "test_procmesh"]) == 11
    assert len([n for n in names if n[0] == "test_parent_recovery"]) == 11
