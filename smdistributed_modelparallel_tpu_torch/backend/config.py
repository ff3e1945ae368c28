"""Configuration engine of the PyTorch port.

A port of ``smdistributed_modelparallel_tpu/backend/config.py``: the same
resolution of a user config (defaults, aliases, bounds, ``requires`` rules,
``SM_HP_MP_PARAMETERS`` and the ``SMP_*`` environment aliases), so both
packages resolve a config to the same values. Only ``half_dtype`` differs: it
names a ``torch.dtype``.

Parity target of the JAX package: reference ``backend/config.py:181-306`` — dependency-ordered
evaluation of a declarative schema (``DependencyIterator``), type/options/
bounds checks, aliases, cross-parameter ``requires`` / ``requires_not`` /
``requires_either`` constraints, arithmetic default formulas, and SageMaker
environment injection via ``SM_HP_MP_PARAMETERS``.
"""

import json
import os
import re

import torch

from smdistributed_modelparallel_tpu_torch.backend.schema import SCHEMA
from smdistributed_modelparallel_tpu_torch.utils.exceptions import ConfigError
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

_FORMULA_REF = re.compile(r"\(([A-Za-z_][A-Za-z0-9_]*)\)")


class DependencyIterator:
    """Yield schema keys so every key appears after its declared dependencies.

    Parity: reference ``backend/config.py:181-200``.
    """

    def __init__(self, schema):
        self.schema = schema

    def __iter__(self):
        emitted = set()
        pending = list(self.schema.keys())
        while pending:
            progressed = False
            remaining = []
            for key in pending:
                deps = self.schema[key].get("dependencies", [])
                if all(d in emitted for d in deps):
                    emitted.add(key)
                    progressed = True
                    yield key
                else:
                    remaining.append(key)
            if not progressed:
                raise ConfigError(f"Circular dependency among config keys: {remaining}")
            pending = remaining


def _eval_formula(expr, values):
    """Evaluate an arithmetic default/bound like ``(pipeline_parallel_degree) + 2``."""

    def sub(m):
        name = m.group(1)
        if name not in values:
            raise ConfigError(f"Formula references unknown/unevaluated key '{name}': {expr}")
        return repr(values[name])

    py = _FORMULA_REF.sub(sub, expr)
    if not re.fullmatch(r"[0-9eE\.\+\-\*/\(\) ]+", py):
        raise ConfigError(f"Unsafe formula: {expr!r}")
    return eval(py)  # noqa: S307 - validated to arithmetic-only above


def _coerce(key, value, types):
    if isinstance(types, type):
        types = (types,)
    if bool in types and not isinstance(value, bool) and value in (0, 1):
        # Schema bools accept 0/1 from JSON/env configs.
        return bool(value)
    if isinstance(value, bool) and bool not in types:
        raise ConfigError(f"Config '{key}': expected {types}, got bool {value}")
    if isinstance(value, tuple(t for t in types if t is not type(None))):
        return value
    # ints are acceptable where floats are required; floats with integral value
    # are acceptable where ints are required (matches 5e8-style YAML defaults).
    if float in types and isinstance(value, int):
        return float(value)
    if int in types and isinstance(value, float) and value == int(value):
        return int(value)
    if type(None) in types and value is None:
        return None
    raise ConfigError(f"Config '{key}': expected {types}, got {type(value).__name__} {value!r}")


class ModelParallelConfig:
    """Validated, attribute-accessible configuration.

    Parity: reference ``backend/config.py:203-306``.
    """

    def __init__(self, user_config=None):
        user_config = dict(user_config or {})
        env_cfg = os.environ.get("SM_HP_MP_PARAMETERS")
        if env_cfg and not user_config:
            try:
                user_config = json.loads(env_cfg)
            except json.JSONDecodeError as e:
                raise ConfigError(f"SM_HP_MP_PARAMETERS is not valid JSON: {e}")

        # Environment aliases for the ZeRO-3 knobs (SMP_ZERO3 /
        # SMP_ZERO3_BUCKET_MB): applied only when the user config does not
        # set the canonical key, so an explicit config always wins.
        env_zero3 = os.environ.get("SMP_ZERO3")
        if env_zero3 is not None and "sharded_params" not in user_config:
            if env_zero3.lower() in ("1", "on", "true", "zero3"):
                user_config["sharded_params"] = "zero3"
            elif env_zero3.lower() in ("0", "off", "false", "none"):
                user_config["sharded_params"] = "none"
            else:
                raise ConfigError(
                    f"SMP_ZERO3={env_zero3!r}: expected 1/on/true/zero3 "
                    "or 0/off/false/none"
                )
        env_bucket = os.environ.get("SMP_ZERO3_BUCKET_MB")
        if env_bucket is not None and "zero3_bucket_mb" not in user_config:
            try:
                user_config["zero3_bucket_mb"] = int(env_bucket)
            except ValueError:
                raise ConfigError(
                    f"SMP_ZERO3_BUCKET_MB={env_bucket!r} is not an integer"
                )

        # Environment aliases for the recompute planner (SMP_RECOMPUTE /
        # SMP_RECOMPUTE_BUDGET_MB), same precedence rule as the ZeRO ones.
        env_recompute = os.environ.get("SMP_RECOMPUTE")
        if env_recompute is not None and "recompute" not in user_config:
            val = env_recompute.strip().lower()
            if val in ("full", "stash_weight", "stash_all", "auto"):
                user_config["recompute"] = val
            else:
                raise ConfigError(
                    f"SMP_RECOMPUTE={env_recompute!r}: expected "
                    "full/stash_weight/stash_all/auto"
                )
        env_rbudget = os.environ.get("SMP_RECOMPUTE_BUDGET_MB")
        if env_rbudget is not None and "recompute_budget_mb" not in user_config:
            try:
                user_config["recompute_budget_mb"] = int(env_rbudget)
            except ValueError:
                raise ConfigError(
                    f"SMP_RECOMPUTE_BUDGET_MB={env_rbudget!r} is not an "
                    "integer"
                )

        # Environment alias for overlapped tensor parallelism
        # (SMP_TP_OVERLAP), same precedence rule: explicit config wins.
        env_tp_overlap = os.environ.get("SMP_TP_OVERLAP")
        if env_tp_overlap is not None and "tp_overlap" not in user_config:
            val = env_tp_overlap.strip().lower()
            if val in ("ring",):
                user_config["tp_overlap"] = "ring"
            elif val in ("0", "off", "false", "none"):
                user_config["tp_overlap"] = "off"
            else:
                raise ConfigError(
                    f"SMP_TP_OVERLAP={env_tp_overlap!r}: expected "
                    "ring or 0/off/false/none"
                )

        # Environment alias for the training matmul precision
        # (SMP_MATMUL_PRECISION), same precedence rule.
        env_matmul_prec = os.environ.get("SMP_MATMUL_PRECISION")
        if (env_matmul_prec is not None
                and "matmul_precision" not in user_config):
            val = env_matmul_prec.strip().lower()
            if val in ("fp8", "float8"):
                user_config["matmul_precision"] = "fp8"
            elif val in ("0", "off", "false", "none", "bf16", "bfloat16"):
                user_config["matmul_precision"] = "bf16"
            else:
                raise ConfigError(
                    f"SMP_MATMUL_PRECISION={env_matmul_prec!r}: expected "
                    "fp8 or bf16/0/off/none"
                )

        # Resolve aliases (e.g. partitions -> pipeline_parallel_degree).
        alias_map = {
            spec["alias"]: key for key, spec in SCHEMA.items() if "alias" in spec
        }
        resolved = {}
        for key, value in user_config.items():
            canonical = alias_map.get(key, key)
            if canonical not in SCHEMA:
                raise ConfigError(f"Unknown config key '{key}'")
            if canonical in resolved:
                raise ConfigError(f"Config key '{canonical}' specified twice (via alias '{key}')")
            resolved[canonical] = value

        values = {}
        for key in DependencyIterator(SCHEMA):
            spec = SCHEMA[key]
            if key in resolved:
                value = _coerce(key, resolved[key], spec["type"])
                if spec.get("deprecated"):
                    logger.warning(
                        "Config '%s' is deprecated; use '%s'.", key, spec.get("replacement")
                    )
                if spec.get("advisory") and value != spec["default"]:
                    logger.warning(
                        "Config '%s' is advisory on TPU (%s); accepted for "
                        "reference compatibility but has no effect.",
                        key, spec["advisory"],
                    )
            else:
                value = spec["default"]
                if isinstance(value, str) and _FORMULA_REF.search(value) and spec["type"] is int:
                    value = int(_eval_formula(value, values))
                    # Computed defaults are clamped into bounds rather than
                    # rejected (e.g. active_microbatches = pp+2 > microbatches).
                    value = self._clamp(spec, value, values)
            if value is not None:
                self._check_bounds(key, spec, value, values)
                self._check_options(key, spec, value)
                self._check_multiple(key, spec, value)
            values[key] = value

        # The ZeRO-2D JSON overrides land BEFORE constraint checking so the
        # keys it sets go through the same requires/cross validation as
        # directly-specified values.
        if values.get("_sharded_data_parallelism_config") is not None:
            self._apply_sdp_json(values)

        for key, spec in SCHEMA.items():
            self._check_requires(key, spec, values)

        self._values = values
        self._validate_cross(values)

    @staticmethod
    def _clamp(spec, value, values):
        lo, hi = spec.get("lower_bound"), spec.get("upper_bound")
        if isinstance(lo, str):
            lo = _eval_formula(lo, values)
        if isinstance(hi, str):
            hi = _eval_formula(hi, values)
        if lo is not None:
            value = max(value, lo)
        if hi is not None:
            value = min(value, hi)
        return value

    @staticmethod
    def _check_bounds(key, spec, value, values):
        for bound_name, op in (("lower_bound", "<"), ("upper_bound", ">")):
            bound = spec.get(bound_name)
            if bound is None:
                continue
            if isinstance(bound, str):
                bound = _eval_formula(bound, values)
            if (op == "<" and value < bound) or (op == ">" and value > bound):
                raise ConfigError(
                    f"Config '{key}'={value} violates {bound_name}={bound}"
                )

    @staticmethod
    def _check_options(key, spec, value):
        options = spec.get("options")
        if options is not None and value not in options:
            raise ConfigError(f"Config '{key}'={value!r} not in allowed options {options}")

    @staticmethod
    def _check_multiple(key, spec, value):
        mult = spec.get("multiple_of")
        if mult is not None and isinstance(value, int) and value % mult:
            raise ConfigError(
                f"Config '{key}'={value} must be a multiple of {mult}"
            )

    @staticmethod
    def _check_requires(key, spec, values):
        value = values[key]
        default = spec["default"]
        is_non_default = value != default or (isinstance(default, str) and _FORMULA_REF.search(str(default)))
        if not is_non_default:
            return
        for dep, required in spec.get("requires", {}).items():
            # A list/tuple of required values means "any of these".
            if isinstance(required, (list, tuple)):
                if values[dep] not in required:
                    raise ConfigError(
                        f"Config '{key}'={value} requires '{dep}' in "
                        f"{list(required)}, got {values[dep]}"
                    )
            elif values[dep] != required:
                raise ConfigError(
                    f"Config '{key}'={value} requires '{dep}'={required}, got {values[dep]}"
                )
        for dep, forbidden in spec.get("requires_not", {}).items():
            if values[dep] == forbidden:
                raise ConfigError(
                    f"Config '{key}'={value} requires '{dep}' != {forbidden!r}"
                )
        req_either = spec.get("requires_either")
        if req_either and not any(values[d] == v for d, v in req_either.items()):
            raise ConfigError(
                f"Config '{key}'={value} requires one of {req_either}"
            )

    def _validate_cross(self, v):
        if v["ddp_dist_backend"] == "nccl":
            # Resolved as the JAX package resolves it, so both packages agree
            # on the config; this package runs no collectives yet.
            logger.info("ddp_dist_backend=nccl accepted for compatibility; resolved to 'xla'.")
            v["ddp_dist_backend"] = "xla"
        if v["sharded_data_parallel_degree"] > 1 and not v["ddp"]:
            # Reference enables ZeRO-2D only under ddp; mirror that requirement.
            raise ConfigError("sharded_data_parallel_degree > 1 requires ddp: True")
        if (v["sharded_params"] == "zero3"
                and v["_sharded_data_parallelism_config"] is not None):
            raise ConfigError(
                "sharded_params: zero3 and _sharded_data_parallelism_config "
                "(zero2d) are mutually exclusive ZeRO modes."
            )
        if v["offload_activations"] and v["activation_loading_horizon"] < 1:
            logger.warning("activation_loading_horizon=0 disables offload prefetch pipelining.")

    def _apply_sdp_json(self, v):
        """Parse ``_sharded_data_parallelism_config`` (a DeepSpeed-style
        JSON file path or dict) onto the ``sdp_*`` knobs.

        Parity: reference ``backend/zero_config.py:13-131`` — the custom
        JSON recursively overrides the defaults built from the sdp_*
        params; stage must be 3. Keys with no TPU counterpart (DeepSpeed
        scheduler/engine options) are accepted as advisory with a warning.
        """
        import json
        import os

        raw = v["_sharded_data_parallelism_config"]
        if isinstance(raw, str):
            if not os.path.exists(raw):
                raise ConfigError(
                    f"_sharded_data_parallelism_config file not found: {raw}"
                )
            with open(raw, encoding="utf-8") as fh:
                raw = json.load(fh)
        if not isinstance(raw, dict):
            raise ConfigError(
                "_sharded_data_parallelism_config must be a dict or a JSON "
                f"file path (got {type(raw).__name__})."
            )
        zo = raw.get("zero_optimization", {})
        if not isinstance(zo, dict):
            raise ConfigError("zero_optimization must be a dict.")
        if zo.get("stage", 3) != 3:
            raise ConfigError(
                "Only ZeRO stage 3 is supported in "
                "_sharded_data_parallelism_config (reference parity)."
            )
        if zo.get("offload_optimizer") or zo.get("offload_param"):
            raise ConfigError(
                "cpu offload in _sharded_data_parallelism_config is not "
                "supported (reference parity)."
            )
        mapping = {
            "reduce_bucket_size": "sdp_reduce_bucket_size",
            "stage3_param_persistence_threshold": "sdp_param_persistence_threshold",
            "stage3_max_live_parameters": "sdp_max_live_parameters",
            "zero2d_hierarchy_allgather": "sdp_hierarchical_allgather",
            "zero2d_shard_size": "sharded_data_parallel_degree",
        }
        consumed = {"stage", "offload_optimizer", "offload_param"}
        for src, dst in mapping.items():
            if src in zo:
                v[dst] = _coerce(dst, zo[src], SCHEMA[dst]["type"])
                self._check_bounds(dst, SCHEMA[dst], v[dst], v)
                consumed.add(src)
        if "gradient_clipping" in raw:
            v["sdp_gradient_clipping"] = _coerce(
                "sdp_gradient_clipping", raw["gradient_clipping"],
                SCHEMA["sdp_gradient_clipping"]["type"],
            )
        advisory = sorted(set(zo) - consumed) + sorted(
            set(raw) - {"zero_optimization", "gradient_clipping"}
        )
        if advisory:
            logger.warning(
                "_sharded_data_parallelism_config keys with no TPU "
                "counterpart (advisory, ignored): %s", advisory,
            )

    # -- accessors ------------------------------------------------------

    def __getattr__(self, name):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name)

    def __contains__(self, name):
        return name in self._values

    def as_dict(self):
        return dict(self._values)

    def __repr__(self):
        non_default = {
            k: v for k, v in self._values.items() if v != SCHEMA[k]["default"]
        }
        return f"ModelParallelConfig({non_default})"

    # Convenience composite sizes -------------------------------------

    @property
    def zero2d_enabled(self):
        return (
            self._values["sharded_data_parallel_degree"] > 1
            or self._values["_sharded_data_parallelism_config"] is not None
        )

    @property
    def zero3_enabled(self):
        return self._values["sharded_params"] == "zero3"

    @property
    def half_dtype(self):
        if self._values["bf16"]:
            return torch.bfloat16
        if self._values["fp16"] or self._values["fp16_params"]:
            return torch.float16
        return None
