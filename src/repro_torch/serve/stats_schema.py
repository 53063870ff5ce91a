"""Versioned schema for ``Engine.stats()`` — the documented, frozen key set.

The port's own copy of the JAX package's ``serve/stats_schema.py``.  It
documents exactly the keys the port's ``Engine.stats()`` emits:

* ``SCHEMA_VERSION`` — bumped whenever a key is added/removed/renamed;
  ``stats()["schema_version"]`` carries it.
* ``STATS_SCHEMA`` — every top-level key, its display group, when it is
  present (``always`` vs ``continuous``-scheduler engines), and a one-line
  description.
* ``NOT_PORTED_KEYS`` — the reference's keys the port has no counterpart
  for: ``decode_unroll`` and ``decode_unroll_source`` (the port's decode
  has no fused device loop to unroll: a chunk is a Python loop of steps),
  and ``mesh`` and ``sharding`` (they come with the distribution layer).
* ``PORT_KEYS`` — the port's own keys: the torch device the engine runs on,
  the kernels' launch counts by wrapper, and the continuous scheduler's
  counts of the work its admissions and decode chunks did (real against
  computed prompt tokens, live against computed row-steps, MoE routed
  choices against expert buffer rows).
* ``PORT_LATENCY_KEYS`` — the port's own ``latency`` entries: the queue
  wait of each admitted request.
* ``PAGES_KEYS`` / ``PREFIX_CACHE_KEYS`` / ``LATENCY_KEYS`` — the nested
  dict sub-schemas.
* :func:`validate_stats` — runtime check that a stats dict matches the
  schema exactly (no missing, no undocumented keys).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

#: bump on any key add/remove/rename (v1 = the port's first versioned set;
#: v2 adds the tuning provenance; v3 the admission and chunk counts and
#: the queue wait; the JAX package numbers its own schema apart)
SCHEMA_VERSION = 3

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
    "prefill_rows": StatKey("traffic", ALWAYS,
                            "rows the admission prefills computed for "
                            "admitted requests"),
    "prefill_prompt_tokens": StatKey("traffic", ALWAYS,
                                     "admitted prompts' tokens (the real "
                                     "work of the admission prefills)"),
    "prefill_row_tokens": StatKey("traffic", ALWAYS,
                                  "row-tokens the admission prefills "
                                  "computed (max_batch x bucket each)"),
    "decode_live_row_steps": StatKey("traffic", ALWAYS,
                                     "live rows x steps of each chunk"),
    "decode_slot_steps": StatKey("traffic", ALWAYS,
                                 "rows x steps the chunks computed "
                                 "(max_batch x chunk each)"),
    "moe_routed": StatKey("traffic", ALWAYS,
                          "MoE (token, choice) pairs routed in the "
                          "admission prefills and decode chunks"),
    "moe_expert_rows": StatKey("traffic", ALWAYS,
                               "MoE expert buffer rows they computed, "
                               "padding included"),
    # -- timing ----------------------------------------------------------
    "prefill_seconds": StatKey("timing", ALWAYS,
                               "device time in prefill (incl. cache "
                               "restore); host clock on the CPU"),
    "decode_seconds": StatKey("timing", ALWAYS,
                              "device time in fused decode; host clock "
                              "on the CPU"),
    "total_seconds": StatKey("timing", ALWAYS,
                             "wall-clock across generate() calls"),
    # -- latency percentiles --------------------------------------------
    "latency": StatKey("latency", ALWAYS,
                       "per-request TTFT / tok-per-s / queue-wait "
                       "percentiles (LATENCY_KEYS sub-schema)"),
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
                         "resolved page size in tokens"),
    "page_size_source": StatKey("paged", CONTINUOUS,
                                "page-size provenance (config/tuned:*/"
                                "default/fallback)"),
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
    # -- hardware / mesh -------------------------------------------------
    "hardware": StatKey("hardware", ALWAYS,
                        "resolved hardware profile name (core.hardware: "
                        "'h100', 'cpu', ...)"),
    "hardware_platform": StatKey("hardware", ALWAYS,
                                 "profile's platform (gpu/cpu; 'unknown' "
                                 "for an unregistered name)"),
    "mesh": StatKey("hardware", ALWAYS,
                    "device-mesh description (launch.mesh.describe_mesh)"),
    "sharding": StatKey("hardware", ALWAYS,
                        "sharding rules + param-spec histogram "
                        "(None single-device)"),
    "device": StatKey("hardware", ALWAYS, "torch device the engine runs on"),
    # -- tuning provenance ----------------------------------------------
    "prefill_plen_buckets": StatKey("tuning", ALWAYS,
                                    "prompt-length buckets prefilled so far"),
    "kernel_launches": StatKey("tuning", ALWAYS,
                               "launches per kernel wrapper (gemm, "
                               "flash_attention), process-wide"),
    "decode_tile_lookups": StatKey("tuning", ALWAYS,
                                   "decode GEMM shape -> resolved schedule "
                                   "+ tier (None before the first step)"),
    "prefill_flash_lookups": StatKey("tuning", ALWAYS,
                                     "flash prefill bucket -> resolved "
                                     "schedule + tier"),
    "registry_hit_stats": StatKey("tuning", ALWAYS,
                                  "global registry resolutions per tier "
                                  "(cached repeats not counted)"),
}

#: the JAX package's keys with no counterpart in the port: the fused
#: decode loop's unroll (the port has no such loop)
NOT_PORTED_KEYS = ("decode_unroll", "decode_unroll_source")

#: the port's own keys (not in the JAX schema)
PORT_KEYS = ("device", "kernel_launches", "prefill_rows",
             "prefill_prompt_tokens", "prefill_row_tokens",
             "decode_live_row_steps", "decode_slot_steps", "moe_routed",
             "moe_expert_rows")

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

#: the port's own stats()["latency"] entries: admission time minus submit
#: time of each admitted request (continuous scheduler; None until one)
PORT_LATENCY_KEYS = ["queue_wait_s"]

#: nested sub-schema: stats()["latency"] (percentile dicts use PCTL_KEYS)
LATENCY_KEYS = ["count", "ttft_s", "tok_per_s"] + PORT_LATENCY_KEYS
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
            for sub in ("ttft_s", "tok_per_s", *PORT_LATENCY_KEYS):
                val = lat[sub]
                if isinstance(val, dict) and set(val) != set(PCTL_KEYS):
                    problems.append(f"latency.{sub} percentile keys drift")
    return problems
