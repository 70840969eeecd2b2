# Persistent plan registry: content-addressed dataflow-plan cache.
#
# Layers:  serialize.py (JSON round-trip for planner artifacts)
#       -> keying.py    (content digests: program + df_text + schema)
#       -> store.py     (two-tier LRU/disk store, stats, prune, quarantine)
#       -> validate.py  (structural plan sanitizer run before serving)
#       -> cache.py     (PlanResult-level cache, the planner's ``cache=``)
#       -> warmstart.py (nearest-neighbor search seeding)
#       -> __main__.py  (AOT tuning CLI: warm / ls / stats / prune)
from .cache import PlanCache
from .keying import (SCHEMA_VERSION, bucket_extent, budget_signature,
                     family_signature, hw_digest, kernel_key, request_key,
                     shape_vector, template_signature)
from .serialize import (plan_from_dict, plan_to_dict, program_from_dict,
                        program_to_dict, result_from_dict, result_to_dict)
from .store import (CacheStats, ENV_DIR, ENV_TOGGLE, PlanCacheStore,
                    QUARANTINE_DIR, cache_enabled, default_cache_dir,
                    get_store, lookup_source, reset_store, stats_blob)
from .validate import validate_plan
from .warmstart import order_programs, tile_signature, warm_order_from_store

__all__ = [
    "PlanCache", "PlanCacheStore", "CacheStats",
    "SCHEMA_VERSION", "ENV_DIR", "ENV_TOGGLE", "QUARANTINE_DIR",
    "bucket_extent", "budget_signature", "family_signature", "hw_digest",
    "kernel_key", "request_key", "shape_vector", "template_signature",
    "plan_from_dict", "plan_to_dict", "program_from_dict", "program_to_dict",
    "result_from_dict", "result_to_dict",
    "cache_enabled", "default_cache_dir", "get_store", "lookup_source",
    "reset_store", "stats_blob", "validate_plan",
    "order_programs", "tile_signature", "warm_order_from_store",
]
