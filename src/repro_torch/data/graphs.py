"""Graph data substrate: synthetic graphs, batch builders, neighbor sampler.

The counterpart of ``repro.data.graphs``, the same numpy code: for the same
seed every array equals JAX's.  Batches hold numpy arrays in the port's
``GraphBatch``; ``models.gnn.common.to_device`` makes tensors of them.

``NeighborSampler`` is the real fanout sampler required by the
``minibatch_lg`` shape (232,965 nodes / 114.6M edges, fanout 15-10): CSR
adjacency on the host, uniform neighbor sampling per layer, and — the
paper's technique applied to GNNs: *deduplication of the
sampled node ids* before feature gather, so each distinct node's features
are fetched once (|N_p| -> |S_p| in the paper's notation).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.gnn.common import GraphBatch


def random_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 7,
    seed: int = 0, task: str = "node_cls", n_graphs: int = 1,
):
    """Synthetic padded GraphBatch with positions (numpy arrays)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    graph_id = (
        np.sort(rng.integers(0, n_graphs, size=n_nodes)).astype(np.int32)
        if n_graphs > 1
        else np.zeros(n_nodes, np.int32)
    )
    if task == "node_cls":
        labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
        label_mask = np.ones(n_nodes, bool)
    else:
        labels = rng.normal(size=n_graphs).astype(np.float32)
        label_mask = np.ones(n_graphs, bool)
    return GraphBatch(
        node_feat=feat,
        positions=pos,
        edge_src=src,
        edge_dst=dst,
        node_mask=np.ones(n_nodes, bool),
        edge_mask=np.ones(n_edges, bool),
        labels=labels,
        graph_id=graph_id,
        label_mask=label_mask,
    )


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)
    feat: np.ndarray | None = None
    labels: np.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def random(cls, n_nodes: int, avg_degree: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        deg = rng.poisson(avg_degree, size=n_nodes).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        indices = rng.integers(0, n_nodes, size=int(indptr[-1])).astype(np.int32)
        return cls(indptr=indptr, indices=indices)


class NeighborSampler:
    """Layered uniform neighbor sampling (GraphSAGE-style) with hash dedup.

    Output layout: a padded subgraph whose node table is the deduplicated
    union of all sampled nodes (seeds first), with edges (sampled neighbor ->
    its target) expressed in local indices.  Static output sizes derive from
    batch_nodes x prod(fanouts) worst case; real occupancy carried in masks.
    """

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def layer_sizes(self, batch_nodes: int) -> list[int]:
        sizes = [batch_nodes]
        for f in self.fanouts:
            sizes.append(sizes[-1] * f)
        return sizes

    def sample(self, seeds: np.ndarray):
        g = self.graph
        sizes = self.layer_sizes(len(seeds))
        max_nodes = sum(sizes)
        max_edges = sum(sizes[1:])

        all_nodes = [seeds.astype(np.int32)]
        edge_src_g, edge_dst_g = [], []
        frontier = seeds.astype(np.int64)
        for fanout in self.fanouts:
            starts = g.indptr[frontier]
            degs = g.indptr[frontier + 1] - starts
            # uniform with replacement (standard for high-degree graphs)
            offs = (self.rng.random((len(frontier), fanout)) * np.maximum(degs, 1)[:, None]).astype(np.int64)
            neigh = g.indices[starts[:, None] + offs]
            valid = (degs > 0)[:, None] & np.ones_like(neigh, bool)
            edge_src_g.append(neigh[valid].astype(np.int32))
            edge_dst_g.append(
                np.broadcast_to(frontier[:, None], neigh.shape)[valid].astype(np.int32)
            )
            frontier = neigh[valid].astype(np.int64)
            all_nodes.append(frontier.astype(np.int32))

        # ---- the PTT idea: dedup the sampled node multiset before gather
        cat = np.concatenate(all_nodes)
        uniq, inverse = np.unique(cat, return_inverse=True)
        # keep seeds at the front: map seed ids to 0..len(seeds)-1
        seed_pos = inverse[: len(seeds)]
        order = np.concatenate(
            [seed_pos, np.setdiff1d(np.arange(len(uniq)), seed_pos)]
        )
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        node_table = uniq[order].astype(np.int32)

        src = rank[
            np.searchsorted(uniq, np.concatenate(edge_src_g))
        ].astype(np.int32) if edge_src_g else np.zeros(0, np.int32)
        dst = rank[
            np.searchsorted(uniq, np.concatenate(edge_dst_g))
        ].astype(np.int32) if edge_dst_g else np.zeros(0, np.int32)

        n_real = len(node_table)
        e_real = len(src)
        node_ids = np.zeros(max_nodes, np.int32)
        node_ids[:n_real] = node_table
        node_mask = np.zeros(max_nodes, bool)
        node_mask[:n_real] = True
        es = np.zeros(max_edges, np.int32)
        ed = np.zeros(max_edges, np.int32)
        es[:e_real] = src
        ed[:e_real] = dst
        edge_mask = np.zeros(max_edges, bool)
        edge_mask[:e_real] = True
        return {
            "node_ids": node_ids,       # global ids to gather features for
            "node_mask": node_mask,
            "edge_src": es,
            "edge_dst": ed,
            "edge_mask": edge_mask,
            "n_seeds": len(seeds),
            "dedup_ratio": float(len(cat)) / max(n_real, 1),
        }

    def batch(self, seeds: np.ndarray, d_feat: int, n_classes: int = 41) -> GraphBatch:
        """Materialize a GraphBatch (synthetic features when the CSR graph
        carries none — shape-faithful for the dry-run cells)."""
        s = self.sample(seeds)
        g = self.graph
        n = len(s["node_ids"])
        rng = np.random.default_rng(int(seeds[0]))
        if g.feat is not None:
            feat = g.feat[s["node_ids"]]
        else:
            feat = rng.normal(size=(n, d_feat)).astype(np.float32)
        if g.labels is not None:
            labels = g.labels[s["node_ids"]].astype(np.int32)
        else:
            labels = rng.integers(0, n_classes, size=n).astype(np.int32)
        label_mask = np.zeros(n, bool)
        label_mask[: s["n_seeds"]] = True  # loss only on the seed nodes
        return GraphBatch(
            node_feat=feat.astype(np.float32),
            positions=rng.normal(size=(n, 3)).astype(np.float32),
            edge_src=s["edge_src"],
            edge_dst=s["edge_dst"],
            node_mask=s["node_mask"],
            edge_mask=s["edge_mask"],
            labels=labels,
            graph_id=np.zeros(n, np.int32),
            label_mask=label_mask & s["node_mask"],
        )
