"""The fixed-degree (ELL) edge layout (counterpart of
``graphphysics_tpu/topology/ell.py``). ``build_ell`` runs the host C++
(``native.build_ell_native``); ``build_ell_reference`` is its plain numpy
version, the same arrays bit for bit.

Edges are grouped by receiver (their "owner") into ``degree`` slots per
node, so that

- the edge-to-node sum is a dense ``reshape([N, D, H]).sum(1)``,
- the per-node softmax of graph attention is a dense masked softmax over
  the slot axis,
- the backward of ``x[senders]`` is a gather through the twin permutation
  and the same dense sum: a mesh adjacency is symmetric, every edge
  ``(s, r)`` has a twin ``(r, s)``.

Padding slots point at their owner and are their own twin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from graphphysics_torch.native import build_ell_native


class EllLayout(NamedTuple):
    senders: np.ndarray  # [N*D] int32: the neighbour of each slot; the owner for padding
    receivers: np.ndarray  # [N*D] int32: the owner, slot // D
    edge_mask: np.ndarray  # [N*D] bool: real-edge slots
    edge_perm: np.ndarray  # [N*D] int32: the COO edge of each slot (0 for padding)
    twin_perm: np.ndarray  # [N*D] int32: the slot of the reversed edge (itself for padding)
    degree: int


def max_in_degree(receivers: np.ndarray, num_nodes: int) -> int:
    if len(receivers) == 0:
        return 0
    return int(np.bincount(receivers, minlength=num_nodes).max())


def build_ell(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    degree: Optional[int] = None,
    degree_multiple: int = 4,
) -> EllLayout:
    """Group a symmetric COO edge list by receiver into ``degree`` slots per
    node (None: the largest in-degree rounded up to ``degree_multiple``).
    Within a node the slots keep the edges' order (a stable sort by
    receiver). Raises ``ValueError`` when a node's in-degree exceeds
    ``degree`` or when an edge has no reversed twin. The host C++ fills the
    slots and finds the twins."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    degree = _checked_degree(np.bincount(receivers, minlength=num_nodes), degree, degree_multiple)
    senders_ell, edge_mask, edge_perm, twin_perm = build_ell_native(
        senders, receivers, num_nodes, degree)
    return EllLayout(
        senders=senders_ell,
        receivers=np.repeat(np.arange(num_nodes, dtype=np.int32), degree),
        edge_mask=edge_mask,
        edge_perm=edge_perm,
        twin_perm=twin_perm,
        degree=degree,
    )


def _checked_degree(counts: np.ndarray, degree: Optional[int], degree_multiple: int) -> int:
    """``degree``, or the largest in-degree (``counts``: each node's)
    rounded up to ``degree_multiple`` when None; raises ``ValueError`` when
    a node's in-degree exceeds it."""
    dmax = int(counts.max()) if len(counts) else 0
    if degree is None:
        degree = max(((dmax + degree_multiple - 1) // degree_multiple) * degree_multiple,
                     degree_multiple)
    if dmax > degree:
        raise ValueError(f"max in-degree {dmax} exceeds ELL degree {degree}")
    return int(degree)


def build_ell_reference(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    degree: Optional[int] = None,
    degree_multiple: int = 4,
) -> EllLayout:
    """The plain numpy version of ``build_ell``: a stable argsort by
    receiver, and the twins through a sorted table of every slot's key."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    e = len(senders)
    counts = np.bincount(receivers, minlength=num_nodes)
    degree = _checked_degree(counts, degree, degree_multiple)

    owners = np.repeat(np.arange(num_nodes, dtype=np.int64), degree)
    n_slots = num_nodes * degree
    order = np.argsort(receivers, kind="stable")
    r_sorted, s_sorted = receivers[order], senders[order]
    starts = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = r_sorted * degree + (np.arange(e, dtype=np.int64) - starts[r_sorted])

    senders_ell = owners.copy()
    senders_ell[slots] = s_sorted
    edge_mask = np.zeros(n_slots, bool)
    edge_mask[slots] = True
    edge_perm = np.zeros(n_slots, np.int64)
    edge_perm[slots] = order

    # the twin of a real slot (owner r, sender s) is the slot keyed s*N + r
    keys = np.full(n_slots, -1, np.int64)
    keys[slots] = r_sorted * num_nodes + s_sorted
    real = np.flatnonzero(edge_mask)
    key_order = np.argsort(keys[real], kind="stable")
    sorted_keys, sorted_slots = keys[real][key_order], real[key_order]
    want = senders_ell[real] * num_nodes + owners[real]
    pos = np.searchsorted(sorted_keys, want)
    found = (pos < len(sorted_keys)) & (sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] == want)
    if not found.all():
        raise ValueError(f"edge list is not symmetric: {int((~found).sum())} edges have no reverse twin")
    twin_perm = np.arange(n_slots, dtype=np.int64)
    twin_perm[real] = sorted_slots[pos]
    return EllLayout(
        senders=senders_ell.astype(np.int32),
        receivers=owners.astype(np.int32),
        edge_mask=edge_mask,
        edge_perm=edge_perm.astype(np.int32),
        twin_perm=twin_perm.astype(np.int32),
        degree=int(degree),
    )
