"""Base dataset: index math, the item pipeline and padding to static budgets
(counterpart of ``graphphysics_tpu/dataset/dataset.py``).

Every item is padded to node and edge *budgets* derived once from the
node-count scan and a CANONICAL sample (item 0 at epoch 0 and the dataset
seed), with headroom and rounded to ``bucket_multiple``, so every batch has
one shape and independent processes derive the same one. Edges are laid out
for the model: ``"sorted"`` sorts them by receiver and attaches
``row_bounds`` (EncodeProcessDecode, the segment-sum kernel), ``"csr"`` sorts
them by sender and attaches ``sender_bounds`` (EncodeTransformDecode, the
attention kernel), ``"ell"`` groups them by receiver into ``ell_degree``
slots per node (either family, the dense ELL ops), the degree derived from
the canonical sample's largest in-degree with 4 slots of headroom.

``num_buckets > 1`` pads each trajectory to the smallest of up to that many
node budgets (the node counts rounded up, evenly spread, the largest always
kept; one bucket when every trajectory has one size), with edge budgets
extrapolated from the canonical sample's edges per node, and the loader
groups its batches by bucket (``bucket_of_index``). The JAX package takes
buckets in its COO layout only; here they take the model's own sorted or
CSR layout (a CSR bucket's node budget also a whole number of
``BLOCK_NODES``), and ELL refuses them as there.

With ``use_previous_data`` every item also carries the frame before it
(``RawSample.previous_data``), so a trajectory's first frame is not an
item. ``khop > 1`` replaces the mesh edges by the k-hop adjacency (cached
per trajectory), ``new_edges_ratio`` adds random edges, ``masking_ratio``
gives each item an ``exclude_mask``.
"""

from __future__ import annotations

import abc
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from graphphysics_torch.core.graph import (
    Graph,
    pad_graph_csr_np,
    pad_graph_ell_np,
    pad_graph_sorted_np,
    round_up,
)
from graphphysics_torch.dataset.preprocessing import apply_face_to_edge
from graphphysics_torch.dataset.sample import RawSample
from graphphysics_torch.ops.csr_attention import BLOCK_NODES
from graphphysics_torch.topology import (
    add_random_edges,
    cartesian_distance_features,
    k_hop_edges,
    max_in_degree,
    world_pos_features,
)

# edge layouts of a dataset: each names its padding (ELL pads by degree)
EDGE_LAYOUTS = {"sorted": pad_graph_sorted_np, "csr": pad_graph_csr_np, "ell": pad_graph_ell_np}


class BaseDataset(abc.ABC):
    """The per-item pipeline ``load -> preprocessing -> FaceToEdge (when the
    preprocessing built no edges) -> k-hop edges -> drop edge features (when
    the model takes none) -> random edges -> node masking -> pad to static
    budgets``.

    Items are deterministic per ``(seed, epoch, index)``: ``__getitem__``
    draws its randomness (the training noise, the random edges, the mask)
    from ``SeedSequence([seed, epoch, index])``."""

    def __init__(
        self,
        meta_path: str,
        preprocessing: Optional[Callable] = None,
        masking_ratio: Optional[float] = None,
        khop: int = 1,
        new_edges_ratio: float = 0.0,
        add_edge_features: bool = True,
        use_previous_data: bool = False,
        world_pos_parameters: Optional[dict] = None,
        node_type_index: Optional[int] = None,
        node_budget: Optional[int] = None,
        edge_budget: Optional[int] = None,
        bucket_multiple: int = 128,
        edge_headroom: float = 1.15,
        seed: int = 0,
        edge_layout: str = "sorted",
        ell_degree: Optional[int] = None,
        num_buckets: int = 1,
    ):
        if edge_layout not in EDGE_LAYOUTS:
            raise ValueError(f"unknown edge_layout {edge_layout!r}; expected one of {sorted(EDGE_LAYOUTS)}")
        if bucket_multiple < 1:
            raise ValueError(f"bucket_multiple must be >= 1, got {bucket_multiple}")
        if edge_headroom < 1.0:
            raise ValueError(f"edge_headroom must be >= 1.0, got {edge_headroom}")
        if num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
        if num_buckets > 1:
            if edge_layout == "ell":
                raise ValueError(
                    "num_buckets > 1 requires the sorted or csr edge layout (the ELL "
                    "layout assumes one global budget)"
                )
            if node_budget is not None or edge_budget is not None:
                raise ValueError(
                    "num_buckets > 1 derives per-bucket budgets; don't also pass "
                    "node_budget/edge_budget"
                )
        with open(meta_path, "r") as fp:
            self.meta: Dict[str, Any] = json.load(fp)
        self.trajectory_length: int = self.meta["trajectory_length"]
        self.preprocessing = preprocessing
        self.masking_ratio = masking_ratio
        self.khop = khop
        self.new_edges_ratio = new_edges_ratio
        self.add_edge_features = add_edge_features
        self.use_previous_data = use_previous_data
        self.node_type_index = node_type_index
        self.node_budget = node_budget
        self.edge_budget = edge_budget
        self.bucket_multiple = bucket_multiple
        self.edge_headroom = edge_headroom
        self.seed = seed
        self.edge_layout = edge_layout
        self.ell_degree = ell_degree
        self.num_buckets = num_buckets
        self._bucket_node_budgets: Optional[List[int]] = None
        self._bucket_edge_budgets: Optional[List[int]] = None
        self._traj_bucket: Optional[np.ndarray] = None
        self._canonical_sample_cache: Optional[RawSample] = None
        self._node_counts_cache: Any = False  # False: not scanned yet (None is a result)
        self._epoch = 0
        # the world position of the k-hop edge features, where given
        self.world_pos_index_start = self.world_pos_index_end = None
        if world_pos_parameters is not None:
            self.world_pos_index_start = world_pos_parameters.get("world_pos_index_start")
            self.world_pos_index_end = world_pos_parameters.get("world_pos_index_end")
        # k-hop edges and their features, per trajectory
        self._khop_edges_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._khop_attr_cache: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ API

    @property
    @abc.abstractmethod
    def size_dataset(self) -> int:
        """Number of trajectories."""

    @abc.abstractmethod
    def _load(self, index: int) -> RawSample:
        """The raw (unpreprocessed) frame sample of a flat index."""

    def scan_node_counts(self) -> Optional[List[int]]:
        """Per-trajectory node counts read without the data, or None when the
        format cannot give them cheaply."""
        return None

    def node_counts(self) -> Optional[List[int]]:
        """``scan_node_counts``, computed once."""
        if self._node_counts_cache is False:
            self._node_counts_cache = self.scan_node_counts()
        return self._node_counts_cache

    @property
    def frames_per_trajectory(self) -> int:
        """Usable frames per trajectory: T - 1 (each needs the next as
        target), one fewer with previous data (frame 0 has none before it)."""
        return self.trajectory_length - 1 - int(self.use_previous_data)

    def __len__(self) -> int:
        return self.size_dataset * self.frames_per_trajectory

    def get_traj_frame(self, index: int) -> Tuple[int, int]:
        """Flat index -> (trajectory, frame); with previous data the usable
        frames start at frame 1."""
        per = self.frames_per_trajectory
        return index // per, index % per + int(self.use_previous_data)

    def trajectory_indices(self, traj_index: int) -> List[int]:
        per = self.frames_per_trajectory
        return list(range(traj_index * per, (traj_index + 1) * per))

    def set_epoch(self, epoch: int) -> None:
        """Reseed the per-item randomness (noise, random edges, masking)."""
        self._epoch = epoch

    def __getitem__(self, index: int) -> Graph:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch, index]))
        sample, exclude = self._build_sample(index, rng)
        if index == 0 and self._epoch == 0 and self._canonical_sample_cache is None:
            # this is the canonical sample (same seed derivation): keep it
            # so the budgets below do not build item 0 a second time
            self._canonical_sample_cache = sample
        graph = self._pad(sample, exclude)
        if self._budgets_done():
            self._canonical_sample_cache = None
        return graph

    def _budgets_done(self) -> bool:
        """Whether every lazy budget the canonical sample can feed is set
        (then the cached sample is dropped)."""
        if self.num_buckets > 1:
            return self._bucket_edge_budgets is not None
        last = self.ell_degree if self.edge_layout == "ell" else self.edge_budget
        return self.node_budget is not None and last is not None

    # ------------------------------------------------------------ pipeline

    def _build_sample(
        self, index: int, rng: np.random.Generator
    ) -> Tuple[RawSample, Optional[np.ndarray]]:
        """The item before padding, and its exclude mask (None without
        masking)."""
        sample = self._load(index)
        traj_index = sample.traj_index
        if self.preprocessing is not None:
            sample = self.preprocessing(sample, rng)
        if sample.senders is None:
            sample = apply_face_to_edge(sample, rng)
        sample = self._apply_k_hop(sample, traj_index)
        if not self.add_edge_features:
            sample.edge_attr = None
        sample = self._add_random_edges(sample, rng)
        return sample, self._masked_indexes(sample, rng)

    def _apply_k_hop(self, sample: RawSample, traj_index: int) -> RawSample:
        """With ``khop > 1``, the k-hop edges in place of the mesh edges,
        with their edge features computed anew (Cartesian + Distance on
        ``pos``, then the world-position ones where the dataset has world
        positions), both cached per trajectory: the first item of a
        trajectory built in this process fixes them, and every later one
        reuses them, frame-varying inputs (world edges, world positions)
        included, as the reference's cache does."""
        if self.khop <= 1:
            return sample
        if traj_index in self._khop_edges_cache:
            sample.senders, sample.receivers = self._khop_edges_cache[traj_index]
            if self.add_edge_features:
                sample.edge_attr = self._khop_attr_cache[traj_index]
            return sample
        s, r = k_hop_edges(sample.senders, sample.receivers, sample.num_nodes, self.khop)
        sample.senders, sample.receivers = s, r
        self._khop_edges_cache[traj_index] = (s, r)
        if self.add_edge_features:
            attr = cartesian_distance_features(sample.pos, s, r)
            if self.world_pos_index_start is not None and self.world_pos_index_end is not None:
                wp = sample.x[:, self.world_pos_index_start:self.world_pos_index_end]
                attr = world_pos_features(wp, s, r, attr)
            sample.edge_attr = attr
            self._khop_attr_cache[traj_index] = attr
        return sample

    def _add_random_edges(self, sample: RawSample, rng: np.random.Generator) -> RawSample:
        """With ``0 < new_edges_ratio <= 1``, random edges added
        (``topology.add_random_edges``) and the edge features recomputed as
        Cartesian + Distance on ``pos`` alone, as the reference does."""
        if self.new_edges_ratio <= 0.0 or self.new_edges_ratio > 1.0:
            return sample
        s, r = add_random_edges(sample.senders, sample.receivers, sample.num_nodes,
                                self.new_edges_ratio, rng)
        sample.senders, sample.receivers = s, r
        if self.add_edge_features:
            sample.edge_attr = cartesian_distance_features(sample.pos, s, r)
        return sample

    def _masked_indexes(self, sample: RawSample, rng: np.random.Generator) -> Optional[np.ndarray]:
        """The MeshMask selection of the reference: ``int((1 - ratio) * N)``
        nodes of a random permutation are marked True, and the losses leave
        the True nodes out. So the *kept* share is excluded, as in the
        reference and the JAX package."""
        if self.masking_ratio is None:
            return None
        n = sample.num_nodes
        keep = rng.permutation(n)[: int((1.0 - self.masking_ratio) * n)]
        mask = np.zeros(n, dtype=bool)
        mask[keep] = True
        return mask

    def _canonical_sample(self) -> RawSample:
        """The processed sample of item 0 at epoch 0: the one source of every
        budget, so independent processes agree on the padded shapes."""
        if self._canonical_sample_cache is None:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0, 0]))
            saved, self._epoch = self._epoch, 0
            try:
                self._canonical_sample_cache = self._build_sample(0, rng)[0]
            finally:
                self._epoch = saved
        return self._canonical_sample_cache

    def _node_multiple_round(self, n: int) -> int:
        """``n`` rounded up to ``bucket_multiple`` and, in the CSR layout, to
        whole node blocks of the JAX kernel, kept so both packages pad CSR
        items to the same shape."""
        n = round_up(n, self.bucket_multiple)
        return round_up(n, BLOCK_NODES) if self.edge_layout == "csr" else n

    def _materialize_buckets(self) -> bool:
        """The per-trajectory bucket assignment from the node-count scan, as
        the JAX package's; False (and one global budget from then on) when
        the format gives no counts or every trajectory has one size."""
        if self._traj_bucket is not None:
            return True
        if self.num_buckets <= 1:
            return False
        counts = self.node_counts()
        if not counts or len(set(counts)) == 1:
            self.num_buckets = 1
            return False
        rounded = [self._node_multiple_round(c) for c in counts]
        budgets = sorted(set(rounded))
        if len(budgets) > self.num_buckets:
            # spread the kept budgets over the sorted distinct sizes; the
            # largest is always kept, so no trajectory overflows
            pos = np.linspace(0, len(budgets) - 1, self.num_buckets)
            budgets = sorted({budgets[int(round(p))] for p in pos})
        self._bucket_node_budgets = budgets
        self._traj_bucket = np.searchsorted(np.array(budgets), np.array(rounded))
        self.num_buckets = len(budgets)
        return True

    def bucket_of_index(self, index: int) -> int:
        """The bucket of a flat item index (0 without buckets): the loader
        groups its batches by it, so every batch has one shape."""
        if not self._materialize_buckets():
            return 0
        return int(self._traj_bucket[self.get_traj_frame(index)[0]])

    def _bucket_budgets(self, sample: RawSample) -> Tuple[int, int]:
        """The node and edge budgets of ``sample``'s bucket. The edge
        budgets extrapolate the canonical sample's edges per node to each
        bucket's node budget, with ``edge_headroom``, so every process
        derives the same ones."""
        if self._bucket_edge_budgets is None:
            canon = self._canonical_sample()
            per_node = canon.num_edges / max(canon.num_nodes, 1)
            self._bucket_edge_budgets = [
                round_up(int(per_node * nb * self.edge_headroom), self.bucket_multiple)
                for nb in self._bucket_node_budgets
            ]
        b = int(self._traj_bucket[sample.traj_index])
        return self._bucket_node_budgets[b], self._bucket_edge_budgets[b]

    def _derive_budgets(self) -> None:
        counts = self.node_counts()
        if self.node_budget is None:
            # no preprocessing step changes the node count, so the largest
            # trajectory bounds every sample; without a scan the canonical
            # sample sizes the budget (a larger sample later raises)
            canon_n = self._canonical_sample().num_nodes
            self.node_budget = self._node_multiple_round(max(max(counts) if counts else 0, canon_n))
            if (self.edge_layout != "ell" and self.edge_budget is None and counts
                    and max(counts) > canon_n):
                # extrapolate the canonical sample's edges per node to the
                # largest trajectory (degree-heterogeneous data: pass
                # edge_budget or raise edge_headroom)
                canon = self._canonical_sample()
                per_node = canon.num_edges / max(canon.num_nodes, 1)
                self.edge_budget = round_up(
                    int(per_node * self.node_budget * self.edge_headroom), self.bucket_multiple
                )
        if self.edge_layout == "ell":
            if self.ell_degree is None:
                # the canonical sample's largest in-degree with 4 slots of
                # headroom (random and world edges can raise later
                # samples'), a multiple of 4, as the JAX package
                dmax = max_in_degree(self._canonical_sample().receivers, self.node_budget)
                self.ell_degree = max(((dmax + 4 + 3) // 4) * 4, 4)
        elif self.edge_budget is None:
            canon_e = self._canonical_sample().num_edges
            self.edge_budget = round_up(int(canon_e * self.edge_headroom), self.bucket_multiple)

    def _pad(self, sample: RawSample, exclude: Optional[np.ndarray] = None) -> Graph:
        """``sample`` padded to its budgets (its bucket's, with buckets) in
        the dataset's edge layout, with ``exclude`` padded by False to the
        node budget where given."""
        n, e = sample.num_nodes, sample.num_edges
        if self._materialize_buckets():
            n_pad, e_pad = self._bucket_budgets(sample)
            if n > n_pad:
                raise ValueError(f"sample exceeds bucket node budget: {n}>{n_pad}")
            if e > e_pad:
                raise ValueError(
                    f"sample exceeds bucket edge budget: {e}>{e_pad}; raise edge_headroom"
                )
        else:
            self._derive_budgets()
            n_pad, e_pad = self.node_budget, self.edge_budget
            if n > n_pad:
                raise ValueError(
                    f"sample exceeds node budget: {n}>{n_pad}; pass "
                    f"node_budget explicitly for mixed-size datasets"
                )
            if self.edge_layout != "ell" and e > e_pad:
                raise ValueError(
                    f"sample exceeds edge budget: {e}>{e_pad}; raise "
                    f"edge_budget or edge_headroom"
                )
        common = dict(edge_attr=sample.edge_attr, y=sample.y, node_type_index=self.node_type_index)
        if self.edge_layout == "ell":
            graph = self._pad_ell(sample, common)
        else:
            graph = EDGE_LAYOUTS[self.edge_layout](
                sample.x, sample.pos, sample.senders, sample.receivers,
                n_pad=n_pad, e_pad=e_pad, **common,
            )
        if exclude is not None:
            padded = np.zeros(n_pad, dtype=bool)
            padded[: len(exclude)] = exclude
            graph = graph.replace(exclude_mask=padded)
        return graph

    def _pad_ell(self, sample: RawSample, common: Dict[str, Any]) -> Graph:
        """ELL padding at the node budget and ``ell_degree``. An edge list
        that is not symmetric raises: the JAX package switches such a
        dataset to its COO layout, which the port has on the CPU only (a
        difference by design, ROADMAP section 3); a node whose in-degree
        outgrows the degree raises, as there."""
        try:
            return pad_graph_ell_np(
                sample.x, sample.pos, sample.senders, sample.receivers,
                n_pad=self.node_budget, degree=self.ell_degree, **common,
            )
        except ValueError as err:
            if "exceeds ELL degree" in str(err):
                raise ValueError(
                    f"{err}; pass an explicit ell_degree with more headroom "
                    f"(current budget {self.ell_degree})"
                ) from err
            if "not symmetric" in str(err):
                raise ValueError(
                    f"{err}: the ELL layout needs a symmetric edge list; use the "
                    f"model's sorted or csr layout"
                ) from err
            raise
