"""Content-addressed keys for cached dataflow plans.

A cache key is the SHA-256 digest of a canonical-JSON *signature* built
from three ingredients (ISSUE: keying):

1. the planning request — either the full canonical program signature(s)
   (``program_to_dict``) or, for the request-level shape tables of
   ``lower_jax``, the request template + shape parameters;
2. the hardware — the digest of ``HardwareModel.df_text()``, so editing a
   preset (bandwidths, mesh, memory sizes) invalidates every plan computed
   against it;
3. :data:`SCHEMA_VERSION` plus the full :class:`SearchBudget` and search
   flags, so changing the planner's search or serialization format
   invalidates stale entries automatically.

Bump :data:`SCHEMA_VERSION` whenever the planner's search semantics, the
serialization layout, or the cost model change in a way that makes old
entries untrustworthy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Sequence

from repro_torch.core.hw import HardwareModel
from repro_torch.core.planner import SearchBudget
from repro_torch.core.program import TileProgram

from .serialize import program_to_dict

# v2: spatial-reduction plan space — SpatialBind.reduce / Mapping.reduce_style
# / StorePlacement.reduce_axes+reduce_style entered the serialized layout and
# SearchBudget gained `spatial_reduction` (both change search semantics, so
# v1 entries must read as misses, never deserialize into wrong plans).
# v3: kernel-graph pipeline planning — graph-level entries (GraphPlan:
# per-node candidates + per-edge forward/spill decisions) joined the layout
# and SearchBudget gained `pipeline_forwarding`; v2 entries read as misses.
# v4: fault-overlay keys — HardwareModel grew disabled_cores/degraded_links
# and df_text() now emits `df.fault` lines, so a degraded fabric hashes to
# its own hw digest and the degraded-mesh re-plan ladder (runtime/replan)
# publishes plan pools under those keys; v3 entries read as misses.
SCHEMA_VERSION = 4


def canonical_json(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def digest_of(obj: Any) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def hw_digest(hw: HardwareModel) -> str:
    """Digest of the full df description — the hardware side of every key."""
    return hashlib.sha256(hw.df_text().encode()).hexdigest()


def budget_signature(budget: Optional[SearchBudget]) -> Dict[str, Any]:
    if budget is None:
        budget = SearchBudget()
    sig = dataclasses.asdict(budget)
    # execution knobs that cannot change which plan wins (the sharded merge
    # is bit-identical to the inline search) must not invalidate entries —
    # a warm produced at --jobs 8 must serve a single-process consumer
    sig.pop("workers", None)
    return sig


def program_signature(program: TileProgram) -> Dict[str, Any]:
    return program_to_dict(program)


def kernel_key(programs: Sequence[TileProgram], hw: HardwareModel,
               budget: Optional[SearchBudget], *, profile: bool = True,
               spatial_reuse: bool = True, temporal_reuse: bool = True,
               entry: str = "kernel_multi") -> str:
    """Key for a ``plan_kernel`` / ``plan_kernel_multi`` invocation.

    ``entry`` separates the two planners' namespaces: they differ in search
    semantics (multi pools candidates, warm-starts, and trims programs) and
    in the ``kernel`` name they report, so a single-program ``plan_kernel``
    call must not resolve from a ``plan_kernel_multi`` entry or vice versa.
    """
    sig = {
        "schema": SCHEMA_VERSION,
        "kind": entry,
        "programs": [program_signature(p) for p in programs],
        "hw": hw_digest(hw),
        "budget": budget_signature(budget),
        "profile": profile,
        "spatial_reuse": spatial_reuse,
        "temporal_reuse": temporal_reuse,
    }
    return digest_of(sig)


def node_key(programs: Sequence[TileProgram]) -> str:
    """The request digest of one pipeline node's candidate-program list —
    the per-node building block :func:`graph_key` composes."""
    return digest_of([program_signature(p) for p in programs])


def graph_key(graph, hw: HardwareModel,
              budget: Optional[SearchBudget]) -> str:
    """Key for a pipeline co-planning invocation (``plan_pipeline``).

    Composed from the per-node keys (:func:`node_key` over each node's
    candidate programs) plus the edge list — so editing any node's
    block-shape candidates, rewiring an edge, renaming an intermediate, or
    changing the hardware/budget/schema all invalidate the graph entry,
    while two graphs sharing a node still share that node's key
    computation."""
    sig = {
        "schema": SCHEMA_VERSION,
        "kind": "pipeline_graph",
        "graph": graph.name,
        "nodes": [[n.name, node_key(n.programs)] for n in graph.nodes],
        "edges": [[e.src, e.dst, e.tensor] for e in graph.edges],
        "hw": hw_digest(hw),
        "budget": budget_signature(budget),
    }
    return digest_of(sig)


def request_key(template: str, params: Dict[str, Any],
                hw: Optional[HardwareModel] = None,
                budget: Optional[SearchBudget] = None,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Key for a request-level table entry (``plan_gemm_blocks`` & co.):
    cheaper than :func:`kernel_key` because it never materializes the
    candidate programs, while still covering hardware + schema + budget."""
    sig = {
        "schema": SCHEMA_VERSION,
        "kind": "request",
        "template": template,
        "params": params,
        "hw": hw_digest(hw) if hw is not None else None,
        "budget": budget_signature(budget) if budget is not None else None,
    }
    if extra:
        sig["extra"] = extra
    return digest_of(sig)


def template_signature(program: TileProgram) -> str:
    """A shape-independent structural fingerprint of a kernel family: the
    tensor roles and the tile-op sequence, but no extents or tile shapes.
    Programs of the same template with different shapes are warm-start
    neighbors of each other."""
    sig = {
        "tensors": [[a.tensor.name, a.tensor.dtype_bytes, a.kind]
                    for a in program.loads + program.stores],
        "ops": [[o.kind, o.unit, o.segment] for o in program.body],
        "grid": [d.name for d in program.grid_dims],
        "seq": [d.name for d in program.seq_dims],
    }
    return digest_of(sig)[:16]


def shape_vector(program: TileProgram) -> list:
    """The shape coordinates used for warm-start nearest-neighbor distance:
    the global tensor extents in declaration order."""
    out: list = []
    for a in program.loads + program.stores:
        out.extend(int(s) for s in a.tensor.shape)
    return out


def bucket_extent(n: int, granule: int = 32) -> int:
    """Bucket a dim extent for shape-family keys: the smallest
    power-of-two multiple of ``granule`` that covers ``n``.  Extents at or
    below the granule collapse to one bucket (ragged tails of a tiled dim
    plan identically), and beyond it buckets double — so a family spans
    e.g. (2048, 4096] while staying tile-aligned."""
    n = max(1, int(n))
    g = max(1, int(granule))
    b = g
    while b < n:
        b *= 2
    return b


def family_signature(template: str, hw: str, shape: Sequence[int],
                     granule: int = 32) -> str:
    """Shape-family key: the template + hardware + *bucketed* shape vector.
    All requests whose dims fall in the same pow2-of-granule buckets share
    one family — the plan service's rung-2 candidates are the cached
    neighbors of the request's family (and adjacent ones via the store's
    log-distance ranking)."""
    sig = {
        "schema": SCHEMA_VERSION,
        "kind": "family",
        "template": template,
        "hw": hw,
        "buckets": [bucket_extent(s, granule) for s in shape],
    }
    return digest_of(sig)[:16]
