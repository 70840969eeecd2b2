# Distribution layer of the port.  Only the process-parallel search
# executor (`search_exec`, framework-free) exists so far; `sharding` and
# `planner_bridge` are not ported yet (ROADMAP.md, Queue 1) and are
# deliberately not imported here.
__all__ = ["search_exec"]


def __getattr__(name: str):
    if name == "search_exec":
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
