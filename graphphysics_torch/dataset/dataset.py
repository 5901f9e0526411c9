"""Base dataset: index math, the item pipeline and padding to static budgets
(counterpart of ``graphphysics_tpu/dataset/dataset.py``).

Every item is padded to node and edge *budgets* derived once from the
node-count scan and a CANONICAL sample (item 0 at epoch 0 and the dataset
seed), with headroom and rounded to ``bucket_multiple``, so every batch has
one shape and independent processes derive the same one. Edges are laid out
for the model's kernel: ``"sorted"`` sorts them by receiver and attaches
``row_bounds`` (EncodeProcessDecode, the segment-sum kernel), ``"csr"`` sorts
them by sender and attaches ``sender_bounds`` (EncodeTransformDecode, the
attention kernel). With ``use_previous_data`` every item also carries the
frame before it (``RawSample.previous_data``), so a trajectory's first
frame is not an item. ``khop > 1`` replaces the mesh edges by the k-hop
adjacency (cached per trajectory), ``new_edges_ratio`` adds random edges,
``masking_ratio`` gives each item an ``exclude_mask``. Size buckets and the
ELL layout raise ``NotImplementedError``: they come with a later slice.
"""

from __future__ import annotations

import abc
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from graphphysics_torch.core.graph import (
    Graph,
    pad_graph_csr_np,
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
    world_pos_features,
)

# edge layouts of a dataset: each names its padding
EDGE_LAYOUTS = {"sorted": pad_graph_sorted_np, "csr": pad_graph_csr_np}


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md section 1, item 11, training features)"
    )


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
        num_buckets: int = 1,
    ):
        if num_buckets != 1:
            raise _waits("size buckets (num_buckets)")
        if edge_layout == "ell":
            raise _waits("the ELL edge layout")
        if edge_layout not in EDGE_LAYOUTS:
            raise ValueError(f"unknown edge_layout {edge_layout!r}; expected one of {sorted(EDGE_LAYOUTS)}")
        if bucket_multiple < 1:
            raise ValueError(f"bucket_multiple must be >= 1, got {bucket_multiple}")
        if edge_headroom < 1.0:
            raise ValueError(f"edge_headroom must be >= 1.0, got {edge_headroom}")
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
        if self.node_budget is not None and self.edge_budget is not None:
            self._canonical_sample_cache = None
        return graph

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

    def _derive_budgets(self) -> None:
        counts = self.node_counts()
        if self.node_budget is None:
            # no preprocessing step changes the node count, so the largest
            # trajectory bounds every sample; without a scan the canonical
            # sample sizes the budget (a larger sample later raises)
            canon_n = self._canonical_sample().num_nodes
            n_max = max(max(counts) if counts else 0, canon_n)
            self.node_budget = round_up(n_max, self.bucket_multiple)
            if self.edge_layout == "csr":
                # whole node blocks of the JAX kernel, kept so both
                # packages pad CSR items to the same shape
                self.node_budget = round_up(self.node_budget, BLOCK_NODES)
            if self.edge_budget is None and counts and max(counts) > canon_n:
                # extrapolate the canonical sample's edges per node to the
                # largest trajectory (degree-heterogeneous data: pass
                # edge_budget or raise edge_headroom)
                canon = self._canonical_sample()
                per_node = canon.num_edges / max(canon.num_nodes, 1)
                self.edge_budget = round_up(
                    int(per_node * self.node_budget * self.edge_headroom), self.bucket_multiple
                )
        if self.edge_budget is None:
            canon_e = self._canonical_sample().num_edges
            self.edge_budget = round_up(int(canon_e * self.edge_headroom), self.bucket_multiple)

    def _pad(self, sample: RawSample, exclude: Optional[np.ndarray] = None) -> Graph:
        """``sample`` padded to the budgets in the dataset's edge layout, with
        ``exclude`` padded by False to the node budget where given."""
        self._derive_budgets()
        n, e = sample.num_nodes, sample.num_edges
        if n > self.node_budget:
            raise ValueError(
                f"sample exceeds node budget: {n}>{self.node_budget}; pass "
                f"node_budget explicitly for mixed-size datasets"
            )
        if e > self.edge_budget:
            raise ValueError(
                f"sample exceeds edge budget: {e}>{self.edge_budget}; raise "
                f"edge_budget or edge_headroom"
            )
        graph = EDGE_LAYOUTS[self.edge_layout](
            sample.x,
            sample.pos,
            sample.senders,
            sample.receivers,
            n_pad=self.node_budget,
            e_pad=self.edge_budget,
            edge_attr=sample.edge_attr,
            y=sample.y,
            node_type_index=self.node_type_index,
        )
        if exclude is not None:
            padded = np.zeros(self.node_budget, dtype=bool)
            padded[: len(exclude)] = exclude
            graph = graph.replace(exclude_mask=padded)
        return graph
