"""Canonical content hashing for ExperimentSpecs (DESIGN.md §15).

The campaign layer caches results by **content address**: a ``spec_hash``
is a sha256 (truncated to 16 hex chars) over a canonical form of the
spec's JSON echo, the results schema version, and the registered problem
identity.  Two constructions of the same experiment — live
``ExperimentSpec`` or a JSON-round-tripped record ``spec`` dict, today or
after new config fields grow defaults — must hash identically, so the
canonical form normalizes everything that is representation rather than
meaning:

* **dict ordering** — keys are sorted at serialization time;
* **tuple vs list** — tuples become lists (``echo()`` vs ``asdict`` vs
  JSON round-trips disagree here);
* **float formatting** — integral floats collapse to ints (``6.0`` and
  ``6`` are the same epoch budget; JSON writers disagree on the rest);
* **default materialization** — fields equal to their dataclass default
  are pruned, so a record written before a config field existed hashes
  the same as one written after (the new field's default is "absent").
  A *non-default* nested config (an attached serving fleet) keeps an
  explicit ``{}`` marker even when all its own fields are defaults —
  ``serving=FleetConfig()`` and ``serving=None`` are different
  experiments.

Flipping any semantic field of ``ExperimentSpec`` / ``RunConfig`` /
``FleetConfig`` must change the hash; ``tests/test_campaign.py`` audits
every field (the ``_FIELD_FLIPS`` idiom from the schedule-cache audit).

This module stays import-light: ``repro_torch.config`` loads
lazily on first hash, so ``repro_torch.experiments.result`` can keep its
"records load without JAX" contract while stamping hashes on write.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
from typing import Any, Dict, Mapping, Optional

# Bumping the results schema (result.SCHEMA_VERSION) intentionally
# invalidates every content address — ``validate --migrate`` re-stamps.
HASH_LEN = 16

# ---------------------------------------------------------------------------
# problem identity: name@version, torch-free
# ---------------------------------------------------------------------------
# Versions live HERE (not on the problem objects) so hashing a stored
# record never has to import / construct the problem.  Bump a version when
# a problem's semantics change (task data, loss, eval) — every cached
# result that used it goes stale.  Problems registered dynamically without
# an explicit version hash as version 1 everywhere, which keeps the hash
# independent of whether the defining module happens to be imported.
_PROBLEM_VERSIONS: Dict[str, int] = {
    "mlp_teacher": 1,
    "quadratic_whatif": 1,
}


def register_problem_version(name: str, version: int = 1) -> None:
    prev = _PROBLEM_VERSIONS.get(name)
    if prev is not None and prev != version:
        raise ValueError(f"problem {name!r} already registered at version "
                         f"{prev}; re-register with the same version or "
                         f"pick a new name")
    _PROBLEM_VERSIONS[name] = int(version)


def problem_identity(name: Optional[str]) -> str:
    """``name@version`` for the hash payload; measure mode is ``-@0``."""
    if name is None:
        return "-@0"
    return f"{name}@{_PROBLEM_VERSIONS.get(name, 1)}"


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------
def canonical_value(x: Any) -> Any:
    """Representation-independent form: tuples→lists, numpy→python,
    integral floats→int, non-finite floats→strings (deterministic JSON)."""
    if isinstance(x, dict):
        return {str(k): canonical_value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canonical_value(v) for v in x]
    if isinstance(x, bool):
        return x
    if isinstance(x, float):
        if math.isnan(x):
            return "__nan__"
        if math.isinf(x):
            return "__inf__" if x > 0 else "__-inf__"
        if x.is_integer() and abs(x) < 2**53:
            return int(x)
        return x
    if hasattr(x, "item") and not isinstance(x, (str, bytes, int)):
        try:  # numpy scalars without importing numpy here
            return canonical_value(x.item())
        except Exception:
            return x
    return x


@functools.lru_cache(maxsize=1)
def _run_defaults() -> Dict[str, Any]:
    import dataclasses

    from repro_torch.config import RunConfig
    return canonical_value(dataclasses.asdict(RunConfig()))


@functools.lru_cache(maxsize=1)
def _fleet_defaults() -> Dict[str, Any]:
    import dataclasses

    from repro_torch.serve.fleet import FleetConfig
    return canonical_value(dataclasses.asdict(FleetConfig()))


# ExperimentSpec's own field defaults in echo() form.  Kept literal (the
# spec module imports the problem registry and with it torch); the field
# audit in tests/test_campaign.py fails if this drifts from the dataclass.
_SPEC_DEFAULTS: Dict[str, Any] = {
    "problem": None,
    "problem_args": {},
    "steps": None,
    "epochs": None,
    "duration": "config",
    "eval_every": 0,
    "engine": "auto",
    "tag": "",
}

# Nested configs whose parent default is None: when present they prune
# against their own type's defaults instead of surviving whole (so a new
# FleetConfig field with a default does not re-address old serving runs).
_AUX_DEFAULT_TREES = {
    "serving": _fleet_defaults,
}


def _prune(value: Dict[str, Any], defaults: Mapping[str, Any]
           ) -> Dict[str, Any]:
    out = {}
    for k, v in value.items():
        if k in defaults:
            dv = defaults[k]
            if v == dv:
                continue
            if isinstance(v, dict) and isinstance(dv, dict):
                out[k] = _prune(v, dv)          # {} survives: "non-default
                continue                        # but default-valued inside"
            if isinstance(v, dict) and dv is None and k in _AUX_DEFAULT_TREES:
                out[k] = _prune(v, _AUX_DEFAULT_TREES[k]())
                continue
        out[k] = v
    return out


def canonical_echo(echo: Mapping[str, Any]) -> Dict[str, Any]:
    """The hash-relevant residue of a spec echo: canonicalized, with
    default-valued fields pruned at every level."""
    c = canonical_value(dict(echo))
    defaults = dict(_SPEC_DEFAULTS)
    defaults["run"] = _run_defaults()
    return _prune(c, defaults)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------
def content_hash(obj: Any) -> str:
    """sha256 (truncated) over the canonical JSON form of ``obj`` — the
    generic content address used for cell hashes and dry-run job specs."""
    blob = json.dumps(canonical_value(obj), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:HASH_LEN]


def spec_hash_from_echo(echo: Mapping[str, Any]) -> str:
    """The content address of one experiment, computed from its JSON echo
    (works identically on live ``spec.echo()`` and stored record specs)."""
    from repro_torch.experiments.result import SCHEMA_VERSION
    payload = {
        "schema": SCHEMA_VERSION,
        "problem": problem_identity(echo.get("problem")),
        "spec": canonical_echo(echo),
    }
    return content_hash(payload)


def spec_hash(spec) -> str:
    """The content address of an :class:`ExperimentSpec`."""
    return spec_hash_from_echo(spec.echo())
