# Distribution layer of the port: logical-axis sharding, the TileLoom mesh
# planner bridge, local-shard SPMD execution, and the process-parallel
# search executor.
#
# Submodule imports are lazy (PEP 562), as in the reference: the planner
# core only needs `search_exec`, and importing the package must not bill
# `sharding`'s or `planner_bridge`'s imports to a cold planner call.
from typing import TYPE_CHECKING

__all__ = ["FIXED_PLANS", "ShardingPlan", "constrain", "current_plan",
           "tree_shardings", "use_plan"]

if TYPE_CHECKING:                        # pragma: no cover - type-checkers only
    from .sharding import (FIXED_PLANS, ShardingPlan, constrain,
                           current_plan, tree_shardings, use_plan)


def __getattr__(name: str):
    if name in __all__:
        from . import sharding
        return getattr(sharding, name)
    if name in ("sharding", "planner_bridge", "search_exec", "spmd"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
