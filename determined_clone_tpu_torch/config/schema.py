"""Experiment-config JSON schema: the schema as data + a small validator —
the port's copy of ``determined_clone_tpu/config/schema.py`` (the same
schema, so both packages list the same errors for a config).

≈ the reference's schema-first expconf (schemas/expconf/v0/*.json sourcing
code-generated structs, master/pkg/schemas validation/defaulting). Here the
schema is a Python literal in the same JSON-Schema subset (type, enum,
required, properties, items, union via oneOf discriminated on a field),
validated by ``validate()`` before the dataclass layer parses values —
errors carry JSON paths, unknown keys are reported at known objects, and
unions resolve by their discriminator exactly like the reference's
searcher/storage/hparam union types (expconf/searcher_config.go:16-28).
"""
from __future__ import annotations

from typing import Any, Dict, List

# -- schema subset ----------------------------------------------------------
# {"type": "object", "properties": {...}, "required": [...], "open": bool}
# {"type": "string" | "number" | "integer" | "boolean" | "array", ...}
# {"union": {"field": <discriminator>, "variants": {value: schema}}}
# {"type": ..., "enum": [...]}  /  {"any": True}

LENGTH_SCHEMA = {
    "type": "object",
    "open": False,
    "properties": {
        "batches": {"type": "integer"},
        "records": {"type": "integer"},
        "epochs": {"type": "integer"},
    },
}

SEARCHER_SCHEMA = {
    "union": {
        "field": "name",
        "variants": {
            "single": {
                "type": "object", "open": True,
                "properties": {
                    "metric": {"type": "string"},
                    "smaller_is_better": {"type": "boolean"},
                    "max_length": LENGTH_SCHEMA,
                },
            },
            "random": {
                "type": "object", "open": True,
                "properties": {
                    "metric": {"type": "string"},
                    "max_trials": {"type": "integer"},
                    "max_length": LENGTH_SCHEMA,
                },
            },
            "grid": {
                "type": "object", "open": True,
                "properties": {
                    "metric": {"type": "string"},
                    "max_length": LENGTH_SCHEMA,
                },
            },
            "asha": {
                "type": "object", "open": True,
                "properties": {
                    "metric": {"type": "string"},
                    "max_trials": {"type": "integer"},
                    "num_rungs": {"type": "integer"},
                    "divisor": {"type": "number"},
                    "max_length": LENGTH_SCHEMA,
                },
            },
            "adaptive_asha": {
                "type": "object", "open": True,
                "properties": {
                    "metric": {"type": "string"},
                    "max_trials": {"type": "integer"},
                    "mode": {"type": "string",
                             "enum": ["aggressive", "standard",
                                      "conservative"]},
                    "max_length": LENGTH_SCHEMA,
                },
            },
            "custom": {"type": "object", "open": True, "properties": {}},
        },
    },
}

_STORAGE_VARIANTS = {
    "shared_fs": {
        "type": "object", "open": True,
        "properties": {"host_path": {"type": "string"},
                       "storage_path": {"type": "string"}},
        "required": ["host_path"],
    },
    "directory": {
        "type": "object", "open": True,
        "properties": {"container_path": {"type": "string"}},
        "required": ["container_path"],
    },
    "gcs": {
        "type": "object", "open": True,
        "properties": {"bucket": {"type": "string"},
                       "prefix": {"type": "string"}},
        "required": ["bucket"],
    },
    "s3": {
        "type": "object", "open": True,
        "properties": {"bucket": {"type": "string"},
                       "prefix": {"type": "string"}},
        "required": ["bucket"],
    },
    "azure": {
        "type": "object", "open": True,
        "properties": {"container": {"type": "string"},
                       "connection_string": {"type": "string"},
                       "prefix": {"type": "string"}},
        "required": ["container"],
    },
}

# content-addressed wrapper: nests one concrete backend under `inner`
# (or uses the flat host_path/container_path convenience form, so nothing
# is `required` here — from_dict enforces that one of the forms is given)
_STORAGE_VARIANTS["cas"] = {
    "type": "object", "open": True,
    "properties": {
        "inner": {"union": {"field": "type",
                            "variants": dict(_STORAGE_VARIANTS)}},
        "chunk_size_kb": {"type": "integer"},
        "cache_path": {"type": "string"},
        "cache_size_mb": {"type": "integer"},
        "transfer_workers": {"type": "integer"},
        "host_path": {"type": "string"},
        "storage_path": {"type": "string"},
        "container_path": {"type": "string"},
    },
}

STORAGE_SCHEMA = {
    "union": {
        "field": "type",
        "variants": _STORAGE_VARIANTS,
    },
}

EXPERIMENT_SCHEMA = {
    "type": "object",
    "open": False,
    "properties": {
        "config_version": {"type": "integer", "enum": [0, 1]},
        "name": {"type": "string"},
        "entrypoint": {"type": "string"},
        "template": {"type": "string"},
        "workspace": {"type": "string"},
        "project": {"type": "string"},
        "unmanaged": {"type": "boolean"},
        "labels": {"type": "array", "items": {"type": "string"}},
        "searcher": SEARCHER_SCHEMA,
        "checkpoint_storage": STORAGE_SCHEMA,
        "checkpoint_policy": {"type": "string",
                              "enum": ["best", "all", "none"]},
        "min_validation_period": LENGTH_SCHEMA,
        "min_checkpoint_period": LENGTH_SCHEMA,
        "perform_initial_validation": {"type": "boolean"},
        "max_restarts": {"type": "integer"},
        "records_per_epoch": {"type": "integer"},
        "scheduling_unit": {"type": "integer"},
        "reproducibility": {
            "type": "object", "open": False,
            "properties": {"experiment_seed": {"type": "integer"}},
        },
        "resources": {
            "type": "object", "open": False,
            "properties": {
                "slots_per_trial": {"type": "integer"},
                "resource_pool": {"type": "string"},
                "priority": {"type": "integer"},
                # "v5e-8" or the multislice object {slices, slice_shape}
                "topology": {"anyOf": [
                    {"type": "string"},
                    {"type": "object", "open": False, "properties": {
                        "slices": {"type": "integer"},
                        "slice_shape": {"type": "string"},
                    }},
                ]},
                "max_slots": {"type": "integer"},
            },
        },
        "hyperparameters": {"any": True},
        "log_policies": {
            "type": "array",
            "items": {
                "type": "object", "open": False,
                "properties": {
                    "pattern": {"type": "string"},
                    # string form or the reference's {"type": ...} object
                    "action": {"anyOf": [
                        {"type": "string",
                         "enum": ["cancel_retries", "exclude_node"]},
                        {"type": "object", "open": False,
                         "properties": {
                             "type": {"type": "string",
                                      "enum": ["cancel_retries",
                                               "exclude_node"]}},
                         "required": ["type"]},
                    ]},
                },
                "required": ["pattern", "action"],
            },
        },
        "profiling": {
            "type": "object", "open": False,
            "properties": {"enabled": {"type": "boolean"}},
        },
        # trial-side telemetry (spans + metrics + trace.json export;
        # docs/observability.md)
        "observability": {
            "type": "object", "open": False,
            "properties": {
                "enabled": {"type": "boolean"},
                "max_events": {"type": "integer"},
                "ship_spans": {"type": "boolean"},
                "ship_metrics": {"type": "boolean"},
                "trace_path": {"type": "string"},
                "flight_dir": {"type": "string"},
                "flight_segment_events": {"type": "integer"},
                "flight_segments": {"type": "integer"},
                "goodput_dir": {"type": "string"},
                "anomaly_window": {"type": "integer"},
                "anomaly_threshold": {"type": "number"},
                "anomaly_min_samples": {"type": "integer"},
                # master-side time-series store (telemetry/tsdb.py)
                "timeseries": {
                    "type": "object", "open": False,
                    "properties": {
                        "enabled": {"type": "boolean"},
                        "scrape_period_s": {"type": "number"},
                        "capacity_per_series": {"type": "integer"},
                        "coarse_step_s": {"type": "number"},
                        "coarse_capacity": {"type": "integer"},
                        "memory_budget_mb": {"type": "number"},
                        "max_series": {"type": "integer"},
                        "persist_dir": {"type": "string"},
                        "segment_scrapes": {"type": "integer"},
                        "max_segments": {"type": "integer"},
                    },
                },
                # sources with no ingest for this long are flagged
                # stale in `dct metrics` / absence-rule evaluation
                "stale_after_s": {"type": "number"},
                # declarative alert rules (telemetry/rules.py); each
                # item is validated in depth by AlertRule.from_dict
                "rules": {
                    "type": "array",
                    "items": {
                        "type": "object", "open": False,
                        "properties": {
                            "name": {"type": "string"},
                            "kind": {"type": "string",
                                     "enum": ["threshold",
                                              "rate_of_change",
                                              "burn_rate", "absence"]},
                            "series": {"type": "string"},
                            "labels": {"type": "object", "open": True},
                            "window_s": {"type": "number"},
                            "reduce": {"type": "string"},
                            "op": {"type": "string",
                                   "enum": ["gt", "ge", "lt", "le"]},
                            "value": {"type": "number"},
                            "for_s": {"type": "number"},
                            "severity": {"type": "string",
                                         "enum": ["page", "ticket"]},
                            "stale_s": {"type": "number"},
                            "windows": {
                                "type": "array",
                                "items": {"anyOf": [
                                    {"type": "string"},
                                    {"type": "number"},
                                ]},
                            },
                            "threshold": {"type": "number"},
                            "objective": {"type": "string"},
                            "bad_series": {"type": "string"},
                            "total_series": {"type": "string"},
                        },
                        "required": ["name", "kind"],
                    },
                },
                # install the two PR-13 burn-rate rules over
                # dct_slo_burn_rate (telemetry/rules.py stock_slo_rules)
                "stock_slo_rules": {"type": "boolean"},
            },
        },
        # online inference via `dct serve` (continuous batching over a
        # paged KV cache; docs/serving.md)
        "serving": {
            "type": "object", "open": False,
            "properties": {
                "max_batch": {"type": "integer"},
                "max_prefill_len": {"type": "integer"},
                "kv_block_size": {"type": "integer"},
                "kv_blocks": {"type": "integer"},
                "max_queue_depth": {"type": "integer"},
                "default_max_new_tokens": {"type": "integer"},
                "host": {"type": "string"},
                "port": {"type": "integer"},
                "prefix_cache": {"type": "boolean"},
                "chunk_prefill_len": {"type": "integer"},
                # draft-model speculative decoding (docs/serving.md);
                # the draft shares the target's tokenizer/vocab
                "speculative": {
                    "type": "object", "open": False,
                    "properties": {
                        "enabled": {"type": "boolean"},
                        "k": {"type": "integer"},
                        "draft_layers": {"type": "integer"},
                        "draft_d_model": {"type": "integer"},
                        "draft_n_heads": {"type": "integer"},
                        "draft_d_ff": {"type": "integer"},
                    },
                },
            },
        },
        # deterministic fault injection (seeded FaultPlan;
        # docs/fault_tolerance.md)
        "faults": {
            "type": "object", "open": False,
            "properties": {
                "enabled": {"type": "boolean"},
                "seed": {"type": "integer"},
                "rules": {
                    "type": "array",
                    "items": {
                        "type": "object", "open": False,
                        "properties": {
                            "point": {"type": "string"},
                            "action": {"type": "string",
                                       "enum": ["error", "delay",
                                                "truncate", "exit"]},
                            "nth": {"type": "integer"},
                            "times": {"type": "integer"},
                            "probability": {"type": "number"},
                            "delay_s": {"type": "number"},
                            "exc": {"type": "string",
                                    "enum": ["fault", "io", "conn"]},
                            "message": {"type": "string"},
                            "exit_code": {"type": "integer"},
                            "keep_bytes": {"type": "integer"},
                        },
                        "required": ["point"],
                    },
                },
            },
        },
        # hot-loop knobs (the TPU-native successor of the reference's
        # horovod-centric optimizations block)
        "optimizations": {
            "type": "object", "open": False,
            "properties": {
                "prefetch_depth": {"type": "integer"},
                "steps_per_dispatch": {"type": "integer"},
            },
        },
        "environment": {"any": True},
        "data": {"any": True},
    },
}


class SchemaError(ValueError):
    """Validation failure with a JSON path."""


_TYPES = {
    "string": str,
    "boolean": bool,
    "array": list,
    "object": dict,
}


def _type_ok(schema_type: str, value: Any) -> bool:
    if schema_type == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if schema_type == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    return isinstance(value, _TYPES[schema_type])


def validate(value: Any, schema: Dict[str, Any] = EXPERIMENT_SCHEMA,
             path: str = "<config>",
             discriminator: str = "") -> List[str]:
    """Returns a list of error strings (empty = valid)."""
    errors: List[str] = []
    if schema.get("any"):
        return errors

    if "anyOf" in schema:
        attempts = [validate(value, sub, path) for sub in schema["anyOf"]]
        if any(not a for a in attempts):
            return []
        return [f"{path}: no alternative matched: " +
                "; ".join(a[0] for a in attempts if a)]

    if "union" in schema:
        field = schema["union"]["field"]
        variants = schema["union"]["variants"]
        if not isinstance(value, dict):
            return [f"{path}: expected an object"]
        tag = value.get(field)
        if tag not in variants:
            return [f"{path}.{field}: expected one of "
                    f"{sorted(variants)}, got {tag!r}"]
        return validate(value, variants[tag], path, discriminator=field)

    stype = schema["type"]
    if not _type_ok(stype, value):
        return [f"{path}: expected {stype}, got {type(value).__name__}"]

    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: expected one of {schema['enum']}, "
                      f"got {value!r}")

    if stype == "object":
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                errors.append(f"{path}.{req}: required field missing")
        for key, sub in value.items():
            if key in props:
                errors.extend(validate(sub, props[key], f"{path}.{key}"))
            elif discriminator and key == discriminator:
                pass  # the union's tag field, already checked above
            elif not schema.get("open", False):
                errors.append(f"{path}.{key}: unknown field "
                              f"(known: {sorted(props)})")
    elif stype == "array" and "items" in schema:
        for i, item in enumerate(value):
            errors.extend(validate(item, schema["items"], f"{path}[{i}]"))

    return errors


def check(raw: Dict[str, Any]) -> None:
    """Raise SchemaError listing every violation, or return silently."""
    errors = validate(raw)
    if errors:
        raise SchemaError("invalid experiment config:\n  " +
                          "\n  ".join(errors))
