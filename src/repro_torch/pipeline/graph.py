"""Kernel-graph IR for pipeline co-planning (DESIGN_PIPELINE.md).

A :class:`PipelineGraph` lifts the unit of planning from one
:class:`~repro_torch.core.program.TileProgram` to a DAG of them: nodes carry the
per-kernel block-shape candidate lists the front-end would hand
``plan_kernel_multi``, and edges name the intermediate tensors flowing
producer -> consumer.  The tile-grid correspondence between the producer's
store and the consumer's load of an edge tensor is carried by the tensor
dimensions themselves: both sides address the *same* logical tile grid, so
an edge is forwardable exactly when the two accesses tile the tensor
identically (equal tile shapes — validated per candidate pair by
``repro_torch.pipeline.forwarding``) and the live intermediate fits the joint
on-chip capacity.

Graph builders for the benchmark chains (2-GEMM MLP, unfused qk -> pv
attention, MoE expert FFN) live here so the AOT warm CLI and the benchmark
suite share one spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from repro_torch.core.program import (TileAccess, TileProgram, matmul_program,
                                moe_gmm_program, qk_matmul_program,
                                softmax_pv_program)


@dataclass(frozen=True)
class PipelineNode:
    """One kernel of the graph: a name plus the block-shape candidate
    programs the per-node search pools (every candidate must expose the
    node's edge tensors — same names, same logical shapes)."""
    name: str
    programs: Tuple[TileProgram, ...]

    def candidates(self) -> Tuple[TileProgram, ...]:
        return self.programs


@dataclass(frozen=True)
class PipelineEdge:
    """An intermediate tensor flowing ``src`` -> ``dst``.

    ``tensor`` names a store of every ``src`` candidate and a load of every
    ``dst`` candidate; the tile-grid correspondence between the two sides is
    the identity on the tensor's dimensions (both accesses index the same
    logical tile grid of the same :class:`TensorSpec` shape)."""
    src: str
    dst: str
    tensor: str


@dataclass(frozen=True)
class PipelineGraph:
    """A DAG of tile programs with named intermediate tensors.

    ``nodes`` must be listed in a topological order (every edge points from
    an earlier node to a strictly later one) — that order is also the
    execution order of the co-planned two-phase schedule."""
    name: str
    nodes: Tuple[PipelineNode, ...]
    edges: Tuple[PipelineEdge, ...]

    # ------------------------------------------------------------ queries
    def node(self, name: str) -> PipelineNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def node_index(self, name: str) -> int:
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i
        raise KeyError(name)

    def in_edges(self, name: str) -> Tuple[PipelineEdge, ...]:
        return tuple(e for e in self.edges if e.dst == name)

    def out_edges(self, name: str) -> Tuple[PipelineEdge, ...]:
        return tuple(e for e in self.edges if e.src == name)

    def edge_store(self, edge: PipelineEdge,
                   program: TileProgram) -> TileAccess:
        """The producer-side store access of ``edge`` in one candidate."""
        for a in program.stores:
            if a.tensor.name == edge.tensor:
                return a
        raise KeyError(f"{program.name} does not store {edge.tensor!r}")

    def edge_load(self, edge: PipelineEdge, program: TileProgram) -> TileAccess:
        """The consumer-side load access of ``edge`` in one candidate."""
        for a in program.loads:
            if a.tensor.name == edge.tensor:
                return a
        raise KeyError(f"{program.name} does not load {edge.tensor!r}")

    # --------------------------------------------------------- validation
    def validate(self) -> None:
        """Front-end contract: unique node names, topological node order,
        every edge tensor stored by all src candidates and loaded by all
        dst candidates with one consistent logical shape/dtype."""
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate node names in {names}")
        if not self.nodes:
            raise ValueError(f"{self.name}: graph has no nodes")
        order = {n: i for i, n in enumerate(names)}
        for n in self.nodes:
            if not n.programs:
                raise ValueError(f"{self.name}/{n.name}: no candidate "
                                 f"programs")
            for p in n.programs:
                p.validate()
        seen_src = set()
        seen_dst = set()
        for e in self.edges:
            if e.src not in order or e.dst not in order:
                raise ValueError(f"{self.name}: edge {e.src}->{e.dst} names "
                                 f"an unknown node")
            # forwarding legs are keyed by tensor name within one node's
            # simulation, so one producer fanning a tensor out to several
            # consumers (or one consumer reading it from several producers)
            # would make the per-edge forward/spill decisions ambiguous —
            # rejected here rather than mispriced later
            if (e.src, e.tensor) in seen_src:
                raise ValueError(
                    f"{self.name}: tensor {e.tensor!r} leaves node {e.src} "
                    f"on multiple edges (fan-out of one intermediate is "
                    f"not supported; materialize it instead)")
            if (e.dst, e.tensor) in seen_dst:
                raise ValueError(
                    f"{self.name}: tensor {e.tensor!r} enters node {e.dst} "
                    f"on multiple edges")
            seen_src.add((e.src, e.tensor))
            seen_dst.add((e.dst, e.tensor))
            if order[e.src] >= order[e.dst]:
                raise ValueError(
                    f"{self.name}: edge {e.src}->{e.dst} violates the "
                    f"topological node order (src must precede dst)")
            spec = None
            for p in self.node(e.src).programs:
                st = self.edge_store(e, p)
                spec = spec or (st.tensor.shape, st.tensor.dtype_bytes)
                if (st.tensor.shape, st.tensor.dtype_bytes) != spec:
                    raise ValueError(
                        f"{self.name}: {e.tensor!r} shape/dtype differs "
                        f"across {e.src} candidates")
            for p in self.node(e.dst).programs:
                ld = self.edge_load(e, p)
                if (ld.tensor.shape, ld.tensor.dtype_bytes) != spec:
                    raise ValueError(
                        f"{self.name}: {e.tensor!r} disagrees between "
                        f"{e.src} stores and {e.dst} loads "
                        f"({spec} vs {(ld.tensor.shape, ld.tensor.dtype_bytes)})")

    def describe(self) -> str:
        parts = [f"{n.name}[{len(n.programs)} cands]" for n in self.nodes]
        for e in self.edges:
            parts.append(f"{e.src}-({e.tensor})->{e.dst}")
        return f"{self.name}: " + " ".join(parts)


# --------------------------------------------------------------------------
# Graph builders (the benchmark / AOT-warm chains)
# --------------------------------------------------------------------------
def graph_from_spec(spec: str) -> PipelineGraph:
    """Build a benchmark graph from a compact CLI spec string (the AOT warm
    CLI's ``--pipeline`` argument):

    * ``mlp2:MxDxF``        — :func:`mlp2_graph`
    * ``attn:HxSqxSkvxD``   — :func:`attn_qk_pv_graph`
    * ``moe:ExCxDmxDf``     — :func:`moe_ffn_graph`
    """
    try:
        kind, dims_text = spec.split(":", 1)
        dims = tuple(int(p) for p in dims_text.lower().split("x"))
    except ValueError:
        raise ValueError(f"malformed pipeline spec {spec!r} "
                         f"(expected kind:AxBx...)") from None
    builders = {"mlp2": (mlp2_graph, 3), "attn": (attn_qk_pv_graph, 4),
                "moe": (moe_ffn_graph, 4)}
    if kind not in builders:
        raise ValueError(f"unknown pipeline graph kind {kind!r}; "
                         f"valid kinds: {sorted(builders)}")
    fn, arity = builders[kind]
    if len(dims) != arity:
        raise ValueError(f"pipeline spec {spec!r} needs {arity} "
                         f"'x'-separated ints, got {len(dims)}")
    return fn(*dims)


def mlp2_graph(M: int, d_model: int, d_ff: int, *,
               blocks: Sequence[Tuple[int, int, int]] = ((32, 32, 32),
                                                         (64, 64, 32),
                                                         (64, 64, 64),
                                                         (128, 64, 64)),
               dtype_bytes: int = 2) -> PipelineGraph:
    """Two chained GEMMs (the transformer MLP): ``Y = X @ W1`` then
    ``Z = Y @ W2``, with the activation ``Y[M, d_ff]`` as the forwardable
    intermediate."""
    up = tuple(matmul_program(M, d_ff, d_model, bm=bm, bn=bn, bk=bk,
                              dtype_bytes=dtype_bytes, name="mlp_up",
                              tensor_names=("X", "W1", "Y"))
               for bm, bn, bk in blocks)
    down = tuple(matmul_program(M, d_model, d_ff, bm=bm, bn=bn, bk=bk,
                                dtype_bytes=dtype_bytes, name="mlp_down",
                                tensor_names=("Y", "W2", "Z"))
                 for bm, bn, bk in blocks)
    g = PipelineGraph(
        name=f"mlp2_M{M}_d{d_model}_f{d_ff}",
        nodes=(PipelineNode("up", up), PipelineNode("down", down)),
        edges=(PipelineEdge("up", "down", "Y"),))
    g.validate()
    return g


def attn_qk_pv_graph(batch_heads: int, seq_q: int, seq_kv: int,
                     head_dim: int, *,
                     blocks: Sequence[Tuple[int, int]] = ((32, 32), (64, 64),
                                                          (64, 128)),
                     dtype_bytes: int = 2) -> PipelineGraph:
    """The unfused attention chain ``S = Q K^T`` -> ``O = softmax(S) V``
    with the score matrix ``S[h, q, kv]`` as the forwardable intermediate —
    the canonical case where the DRAM round trip dwarfs the operand traffic
    (S is quadratic in sequence length)."""
    qk = tuple(qk_matmul_program(batch_heads, seq_q, seq_kv, head_dim,
                                 bq=bq, bkv=bkv, dtype_bytes=dtype_bytes)
               for bq, bkv in blocks)
    pv = tuple(softmax_pv_program(batch_heads, seq_q, seq_kv, head_dim,
                                  bq=bq, bkv=bkv, dtype_bytes=dtype_bytes)
               for bq, bkv in blocks)
    g = PipelineGraph(
        name=f"attn_h{batch_heads}_q{seq_q}_kv{seq_kv}_d{head_dim}",
        nodes=(PipelineNode("qk", qk), PipelineNode("pv", pv)),
        edges=(PipelineEdge("qk", "pv", "S"),))
    g.validate()
    return g


def moe_ffn_graph(n_experts: int, capacity: int, d_model: int, d_ff: int, *,
                  blocks: Sequence[Tuple[int, int, int]] = ((32, 32, 32),
                                                            (64, 64, 32),
                                                            (64, 64, 64)),
                  dtype_bytes: int = 2) -> PipelineGraph:
    """The gate-routed MoE expert FFN chain: after the (host-side) gate has
    scattered tokens to experts, ``H = X @ W_up`` then ``O = H @ W_down``
    per expert, with the hidden activation ``H[e, cap, d_ff]`` forwardable
    between the two grouped contractions."""
    up = tuple(moe_gmm_program(n_experts, capacity, d_model, d_ff,
                               bm=bm, bn=bn, bk=bk, dtype_bytes=dtype_bytes,
                               name="moe_up",
                               tensor_names=("X", "W_up", "H"))
               for bm, bn, bk in blocks)
    down = tuple(moe_gmm_program(n_experts, capacity, d_ff, d_model,
                                 bm=bm, bn=bn, bk=bk,
                                 dtype_bytes=dtype_bytes, name="moe_down",
                                 tensor_names=("H", "W_down", "O"))
                 for bm, bn, bk in blocks)
    g = PipelineGraph(
        name=f"moe_ffn_e{n_experts}_c{capacity}_{d_model}x{d_ff}",
        nodes=(PipelineNode("up", up), PipelineNode("down", down)),
        edges=(PipelineEdge("up", "down", "H"),))
    g.validate()
    return g
