"""The port's entry points against the JAX package's ``__graft_entry__``.

``entry()``'s step on the CPU (the plain version) equals the reference's
``fn(*example_args)`` leaf for leaf; ``dryrun_multichip(1)`` counts what the
reference's host engine counts on the same events, one match per lane; more
cards than the machine has are refused.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from siddhi_tpu_torch import entry as tentry
from siddhi_tpu_torch.gpu.partition import PartitionedNFARuntime
from siddhi_tpu_torch.gpu.state_io import state_to_numpy


def _same(ref, got, at=""):
    assert ref.keys() == got.keys(), at
    for k in ref:
        if isinstance(ref[k], dict):
            _same(ref[k], got[k], f"{at}{k}.")
        else:
            a, b = np.asarray(ref[k]), np.asarray(got[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{at}{k}"
            np.testing.assert_array_equal(b, a, err_msg=f"{at}{k}")


def test_entry_step_equals_the_reference():
    jfn, jargs = graft.entry()
    jstate, jys = jfn(*jargs)
    fn, args = tentry.entry(device="cpu")
    assert args[0]["tables"].keys() == jargs[0]["tables"].keys()
    state, ys = fn(*args)
    jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    jys = jax.tree_util.tree_map(np.asarray, jys)
    _same(jstate, state_to_numpy(state, single_lane=True))
    _same(jys, state_to_numpy(ys, single_lane=True))
    assert int(np.sum(jys["mask"])) > 0


def test_dryrun_counts_the_reference_host_oracle():
    from siddhi_tpu import SiddhiManager, StreamCallback
    out = tentry.dryrun_multichip(1, devices=["cpu"])
    rt = PartitionedNFARuntime(tentry.bench_app(), num_partitions=2,
                               key_attr="dev", device="cpu")
    events = tentry.dryrun_events(rt)
    m = SiddhiManager()
    hrt = m.create_siddhi_app_runtime(tentry.bench_app(), playback=True)
    host = []
    hrt.add_callback("Alerts", StreamCallback(lambda evs: host.extend(evs)))
    hrt.start()
    ih = hrt.input_handler("S")
    for dev, v, t in events:
        ih.send([dev, v], timestamp=t)
    m.shutdown()
    assert out["matches"] == len(host) == out["expected"] == 2
    assert sorted(out["rows"]) == sorted(list(e.data) for e in host)


def test_dryrun_refuses_more_than_one_card(monkeypatch):
    """Two cards asked for where one exists: refused, never a fallback (the
    split over repeated devices is ``tests/test_torch_partition_split.py``'s)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA cards, 1 present"):
        tentry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 CUDA cards, 0 present"):
        tentry.dryrun_multichip(2)
