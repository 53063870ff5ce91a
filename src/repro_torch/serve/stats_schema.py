"""Versioned schema for ``Engine.stats()`` — the documented, frozen key set.

The port's own copy of the JAX package's ``serve/stats_schema.py``.  It
documents exactly the keys the port's ``Engine.stats()`` emits:

* ``SCHEMA_VERSION`` — bumped whenever a key is added/removed/renamed;
  ``stats()["schema_version"]`` carries it.
* ``STATS_SCHEMA`` — every top-level key, its display group, when it is
  present (``always`` vs ``continuous``-scheduler engines), and a one-line
  description.
* ``NOT_PORTED_KEYS`` — the reference's keys the port has no counterpart
  for yet (hardware platform, mesh and sharding, tuning provenance); they
  come with the tuning registry and the distribution layer.
* ``PORT_KEYS`` — the port's own keys: the torch device the engine runs on
  and the kernels' launch counts by wrapper.
* ``PAGES_KEYS`` / ``PREFIX_CACHE_KEYS`` / ``LATENCY_KEYS`` — the nested
  dict sub-schemas.
* :func:`validate_stats` — runtime check that a stats dict matches the
  schema exactly (no missing, no undocumented keys).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

#: bump on any key add/remove/rename (v1 = the port's first versioned set;
#: the JAX package numbers its own schema apart)
SCHEMA_VERSION = 1

#: presence conditions
ALWAYS = "always"
CONTINUOUS = "continuous"       # only on continuous-scheduler engines


@dataclasses.dataclass(frozen=True)
class StatKey:
    group: str
    when: str
    doc: str


#: display-group order for renderers
GROUP_ORDER = [
    "schema", "traffic", "timing", "latency", "scheduler", "paged",
    "prefix_cache", "hardware", "tuning",
]

STATS_SCHEMA: Dict[str, StatKey] = {
    # -- schema ----------------------------------------------------------
    "schema_version": StatKey("schema", ALWAYS,
                              "stats schema version (this file)"),
    # -- traffic counters ------------------------------------------------
    "requests": StatKey("traffic", ALWAYS, "requests ever submitted"),
    "tokens_generated": StatKey("traffic", ALWAYS,
                                "total tokens emitted across requests"),
    "generate_calls": StatKey("traffic", ALWAYS,
                              "batched generate() invocations"),
    "waves": StatKey("traffic", ALWAYS,
                     "wave-scheduler decode waves executed"),
    "chunks": StatKey("traffic", ALWAYS,
                      "continuous-scheduler fused decode chunks executed"),
    "admission_prefills": StatKey("traffic", ALWAYS,
                                  "batched admission prefill calls"),
    "device_transfers": StatKey("traffic", ALWAYS,
                                "device->host fetches (one per chunk/wave)"),
    "cache_allocs": StatKey("traffic", ALWAYS,
                            "KV pool/cache allocations (1 per engine)"),
    # -- timing ----------------------------------------------------------
    "prefill_seconds": StatKey("timing", ALWAYS,
                               "wall-clock in prefill (incl. cache restore)"),
    "decode_seconds": StatKey("timing", ALWAYS,
                              "wall-clock in fused decode"),
    "total_seconds": StatKey("timing", ALWAYS,
                             "wall-clock across generate() calls"),
    # -- latency percentiles --------------------------------------------
    "latency": StatKey("latency", ALWAYS,
                       "per-request TTFT / tok-per-s percentiles "
                       "(LATENCY_KEYS sub-schema)"),
    # -- scheduler -------------------------------------------------------
    "scheduler": StatKey("scheduler", ALWAYS,
                         "'continuous' or 'wave' (the resolved one)"),
    "scheduler_forced": StatKey("scheduler", ALWAYS,
                                "why a continuous config fell back to wave "
                                "(None otherwise)"),
    "slots": StatKey("scheduler", ALWAYS, "KV-cache slot count (max_batch)"),
    "slots_admitted": StatKey("scheduler", ALWAYS,
                              "requests ever admitted into a slot"),
    "slots_evicted": StatKey("scheduler", ALWAYS,
                             "requests ever evicted from a slot"),
    "slot_reuses": StatKey("scheduler", ALWAYS,
                           "slot admissions beyond each slot's first"),
    # -- paged pool (continuous engines only) ---------------------------
    "decode_chunk": StatKey("paged", CONTINUOUS,
                            "tokens per fused chunk between boundaries"),
    "capacity_tokens": StatKey("paged", CONTINUOUS,
                               "paged-pool capacity in tokens"),
    "page_size": StatKey("paged", CONTINUOUS,
                         "page size in tokens (config, else 16)"),
    "pages": StatKey("paged", CONTINUOUS,
                     "allocator gauge dict (PAGES_KEYS sub-schema; None "
                     "before the pool is built)"),
    "admissions": StatKey("paged", CONTINUOUS,
                          "continuous-scheduler admissions"),
    "evictions": StatKey("paged", CONTINUOUS,
                         "continuous-scheduler evictions"),
    "preemptions": StatKey("paged", CONTINUOUS,
                           "rows preempted under pool pressure"),
    # -- prefix cache ----------------------------------------------------
    "prefix_cache": StatKey("prefix_cache", ALWAYS,
                            "prefix-cache counters (PREFIX_CACHE_KEYS "
                            "sub-schema; enabled=False zeros when off)"),
    # -- hardware --------------------------------------------------------
    "hardware": StatKey("hardware", ALWAYS,
                        "the card's name (torch.cuda.get_device_name), "
                        "'cpu' on the CPU"),
    "device": StatKey("hardware", ALWAYS, "torch device the engine runs on"),
    # -- tuning provenance ----------------------------------------------
    "prefill_plen_buckets": StatKey("tuning", ALWAYS,
                                    "prompt-length buckets prefilled so far"),
    "kernel_launches": StatKey("tuning", ALWAYS,
                               "launches per kernel wrapper (gemm, "
                               "flash_attention), process-wide"),
}

#: the JAX package's keys with no counterpart in the port yet: the
#: hardware platform, mesh and sharding (ROADMAP queue 1, item 9) and the
#: tuning provenance (item 7)
NOT_PORTED_KEYS = (
    "hardware_platform", "mesh", "sharding", "decode_unroll",
    "decode_unroll_source", "decode_tile_lookups", "prefill_flash_lookups",
    "registry_hit_stats", "page_size_source",
)

#: the port's own keys (not in the JAX schema)
PORT_KEYS = ("device", "kernel_launches")

#: nested sub-schema: stats()["pages"]
PAGES_KEYS = [
    "page_size", "usable_pages", "used_pages", "free_pages", "utilization",
    "high_water_pages", "alloc_count", "free_count",
]

#: nested sub-schema: stats()["prefix_cache"]
PREFIX_CACHE_KEYS = [
    "enabled", "lookups", "hits_full", "hits_partial", "misses", "inserts",
    "evictions", "entries", "nodes", "pinned_pages", "cached_tokens_served",
    "prefill_tokens_saved", "prefill_tokens_computed", "pages_write_skipped",
]

#: nested sub-schema: stats()["latency"] (percentile dicts use PCTL_KEYS)
LATENCY_KEYS = ["count", "ttft_s", "tok_per_s"]
PCTL_KEYS = ["p50", "p95", "p99"]


def keys_for(scheduler: str) -> List[str]:
    """The exact key set a ``scheduler`` engine's stats() must carry."""
    return [k for k, spec in STATS_SCHEMA.items()
            if spec.when == ALWAYS or spec.when == scheduler]


def groups() -> Dict[str, List[str]]:
    """Schema keys bucketed by display group, in GROUP_ORDER."""
    out: Dict[str, List[str]] = {g: [] for g in GROUP_ORDER}
    for k, spec in STATS_SCHEMA.items():
        out[spec.group].append(k)
    return out


def validate_stats(stats: Dict[str, object]) -> List[str]:
    """Diff a live stats dict against the schema; returns violations
    (empty = conformant).  Checks top-level presence both ways plus the
    nested pages / prefix_cache / latency sub-schemas."""
    problems: List[str] = []
    sched = stats.get("scheduler")
    if sched not in ("continuous", "wave"):
        problems.append(f"scheduler key missing or unknown: {sched!r}")
        return problems
    expected = set(keys_for(sched))
    present = set(stats)
    for k in sorted(expected - present):
        problems.append(f"missing documented key: {k}")
    for k in sorted(present - expected):
        problems.append(f"undocumented key emitted: {k}")
    pages = stats.get("pages")
    if isinstance(pages, dict) and set(pages) != set(PAGES_KEYS):
        problems.append(
            f"pages sub-schema drift: {sorted(set(pages) ^ set(PAGES_KEYS))}")
    pc = stats.get("prefix_cache")
    if isinstance(pc, dict) and set(pc) != set(PREFIX_CACHE_KEYS):
        problems.append(
            "prefix_cache sub-schema drift: "
            f"{sorted(set(pc) ^ set(PREFIX_CACHE_KEYS))}")
    lat = stats.get("latency")
    if isinstance(lat, dict):
        if set(lat) != set(LATENCY_KEYS):
            problems.append(
                "latency sub-schema drift: "
                f"{sorted(set(lat) ^ set(LATENCY_KEYS))}")
        else:
            for sub in ("ttft_s", "tok_per_s"):
                val = lat[sub]
                if isinstance(val, dict) and set(val) != set(PCTL_KEYS):
                    problems.append(f"latency.{sub} percentile keys drift")
    return problems
