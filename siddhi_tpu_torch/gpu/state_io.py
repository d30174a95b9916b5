"""Carries device state between the JAX package and the port.

Both packages keep the same state tree, leaf names and dtypes:

- blocked NFA: ``{"tables": {"t{s}": {leaf: [L, C]}}, "matches": [L],
  "drops": [L]}``;
- scan NFA: ``{"pending": {"p{s}": {leaf: [L, C]}}, "seeds": [L],
  "drops": [L], "matches": [L]}``;
- single-stream query (``CompiledStreamQuery``): a flat dict of window
  tails (``tail_*``), tumbling remainders (``rem_*``, the 0-d
  ``rem_count``), clocks and counters (``last_ts``, ``batch_base``,
  ``hop_next``, ``window_drops``, ``ts_regressions``), the sort buffer
  (``sort_*``), the heavy-hitter table (``hh_*``), per-key tables
  (``key_*``) and running aggregates (``run_*``), as ``init_state`` lists
  them (``query_state_from_numpy`` checks a tree against that list, 0-d
  leaves included, so a JAX runtime stopped mid-stream resumes in the port
  for every window);
- stream-stream join (``CompiledJoinQuery``): the two rings' timestamps
  (``lr_ts``/``rr_ts``, int64, ``-2**62`` where empty) and referenced
  attributes (``lr_<attr>``/``rr_<attr>``), and the 0-d int64 counters
  ``join_drops`` and ``ring_drops`` (``join_state_from_numpy`` checks a tree
  against ``init_state``'s leaf list the same way).

- a fleet member of the columnar host tier (``fleet/group.py``'s
  ``FleetMemberState``): ``{"state": tree, "dict": {column: values}}``, the
  tree the member's host plan keeps (a stream shape's flat dict with its
  ``window_n``/``window_ms`` overrides, an NFA shape's ``{"tables",
  "matches"}``, a partition's ``{"lanes": [...]}``) with numpy leaves and
  Python counters; ``host_tree_to_numpy``/``host_tree_from_numpy`` carry it
  between the port's CPU tensors and those leaves.

The reference's partitioned runtimes stack lanes in front (``[P, C]``, ``[P]``)
as the port does; its single-lane ``DeviceNFARuntime`` keeps ``[C]`` leaves
and scalar counters, which the port holds as one lane (``single_lane=True``
adds or drops that dim; ``nfa_state_from_numpy`` does so for a
``DeviceNFARuntime`` snapshot and checks every leaf). ``state_from_numpy``
takes a tree with numpy leaves (what ``jax.device_get(rt.state)`` returns)
and makes the port's tensors; ``state_to_numpy`` goes the other way. String dictionaries travel as the
plain dict ``snapshot_dictionaries`` produces
(``MergedBatchSchema.snapshot_dictionaries`` / ``restore_dictionaries``).

A DCN lane-group snapshot (``gpu/dcn.py``, ``LaneGroupSnapshotStore``)
stores a state as a flat list of numpy leaves in ``jax.tree_util``'s order:
a dict's keys sorted, nested dicts depth first. ``state_leaves`` flattens a
state that way and ``state_from_leaves`` rebuilds one over a prototype's
structure, so a group snapshot written by either package restores in the
other.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(tree, device, single_lane: bool = False) -> dict:
    """Nested dict of numpy arrays → the same dict of tensors on ``device``
    (with a lane dim of 1 added in front when ``single_lane``)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device, single_lane)
                for k, v in tree.items()}
    a = np.array(tree, copy=True)
    return torch.from_numpy(a[None] if single_lane else a).to(device)


def state_to_numpy(state, single_lane: bool = False) -> dict:
    """Nested dict of tensors → the same dict of numpy arrays on the host
    (with the lane dim of 1 dropped when ``single_lane``)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v, single_lane) for k, v in state.items()}
    a = state.detach().cpu().numpy()
    return a[0] if single_lane else a


def state_leaves(state) -> list:
    """A state tree's leaves as host numpy arrays, in ``jax.tree_util``'s
    flattening order (a dict's keys sorted, nested dicts depth first)."""
    if isinstance(state, dict):
        return [a for k in sorted(state) for a in state_leaves(state[k])]
    return [state.detach().cpu().numpy()]


def state_from_leaves(proto, leaves: list, device) -> dict:
    """``state_leaves``' inverse: a tree of ``proto``'s structure (its
    dicts' key order kept) whose leaves are ``leaves``, taken in sorted-key
    order, as tensors on ``device``. Every leaf must have its prototype's
    dtype and shape."""
    n = state_leaf_count(proto)
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves, the state has {n}")
    it = iter(leaves)

    def build(p, at: str) -> dict:
        out = {}
        for k in sorted(p):
            if isinstance(p[k], dict):
                out[k] = build(p[k], f"{at}{k}.")
                continue
            a = np.array(next(it), copy=True)
            t = torch.from_numpy(a) if a.ndim else torch.tensor(a)
            want = (p[k].dtype, tuple(p[k].shape))
            if (t.dtype, tuple(t.shape)) != want:
                raise ValueError(f"state leaf {at}{k!r}: {t.dtype}"
                                 f"{tuple(t.shape)}, expected {want[0]}"
                                 f"{want[1]}")
            out[k] = t.to(device)
        return {k: out[k] for k in p}
    return build(proto, "")


def state_leaf_count(tree) -> int:
    """The number of leaves of a state tree."""
    if isinstance(tree, dict):
        return sum(state_leaf_count(v) for v in tree.values())
    return 1


def query_state_from_numpy(q, tree: dict, device) -> dict:
    """A single-stream query state with numpy leaves (the JAX package's
    ``jax.device_get(rt.state)``) → the port's tensors on ``device``. Every
    leaf of ``q.init_state`` must be present with its dtype and shape."""
    return _checked_from_numpy(q.init_state(device="cpu"), tree, device)


def join_state_from_numpy(cq, tree: dict, device) -> dict:
    """A join state with numpy leaves (the JAX package's
    ``jax.device_get(rt.state)`` of a ``DeviceJoinRuntime``) → the port's
    tensors on ``device``. Every leaf of ``cq.init_state``, the 0-d counters
    included, must be present with its dtype and shape."""
    return _checked_from_numpy(cq.init_state(device="cpu"), tree, device)


def nfa_state_from_numpy(comp, tree: dict, device) -> dict:
    """A single-lane NFA state with numpy leaves (``[C]`` tables, scalar
    counters: the JAX package's ``DeviceNFARuntime`` state) → the port's
    one-lane tensors on ``device``. Every leaf of ``comp.init_state(1)``
    must be present with its dtype and shape."""
    return _checked_from_numpy(comp.init_state(1), tree, device,
                               single_lane=True)


def _checked_from_numpy(proto: dict, tree: dict, device,
                        single_lane: bool = False) -> dict:
    out = state_from_numpy(tree, device, single_lane)
    _check_like(proto, out, "")
    return out


def _check_like(proto: dict, got: dict, at: str) -> None:
    if set(got) != set(proto):
        raise ValueError(f"state leaves differ: "
                         f"{sorted(at + k for k in set(got) ^ set(proto))}")
    for k, p in proto.items():
        name = at + k
        if isinstance(p, dict):
            if not isinstance(got[k], dict):
                raise ValueError(f"state leaf {name!r} is not a subtree")
            _check_like(p, got[k], name + ".")
        elif got[k].dtype != p.dtype or got[k].shape != p.shape:
            raise ValueError(f"state leaf {name!r}: {got[k].dtype}"
                             f"{tuple(got[k].shape)}, expected {p.dtype}"
                             f"{tuple(p.shape)}")


def host_tree_to_numpy(tree):
    """A host-tier state tree (dicts, lists, CPU tensors, Python values) →
    the same tree with numpy leaves (the JAX package's host form)."""
    if isinstance(tree, dict):
        return {k: host_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def host_tree_from_numpy(tree):
    """``host_tree_to_numpy``'s inverse: numpy arrays and scalars → CPU
    tensors (copied); dicts, lists and Python values as they are."""
    if isinstance(tree, dict):
        return {k: host_tree_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree_from_numpy(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree
