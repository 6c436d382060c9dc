"""RunResult: the stable record schema every experiment emits (DESIGN.md §5).

One :class:`RunResult` per executed :class:`~repro_torch.experiments.spec
.ExperimentSpec`:

* ``spec``      — the config echo (RunConfig + experiment fields);
* ``metrics``   — final metric values (the problem's ``eval_fn`` keys);
* ``curve``     — eval history rows ``{"update", "time", **metrics}``;
* ``runtime``   — trace-derived runtime axis summary (simulated seconds of
  the last update, updates, minibatches actually committed — an elastic
  trace's cancelled pushes don't count — plus ``replay_path``: which
  execution path produced the record, "batched" | "sequential" |
  "legacy" | "measure", so the sweep fast-path cliff is visible in every
  results file);
* ``staleness`` — Fig.-4 statistics off the trace (⟨σ⟩, σ_max, P(σ > 2n),
  ring-buffer K, histogram, ⟨σ⟩-series head).

The JSON form is the *record*; ``params``/``trace`` ride along in memory
only (a record must stay diff-able and loadable without torch).  Results
files under ``benchmarks/results/`` share one envelope —
``{"schema_version", "benchmark", "cell", "campaign", "records": [...],
"derived": {...}}`` — with every record validating against
:func:`validate_record` (``python -m repro_torch.experiments.validate`` gates
this in CI).

Schema v2 (the campaign layer, DESIGN.md §15) adds content addressing:

* every record carries ``spec_hash`` — the canonical content address of
  its spec echo (``spec_hash.spec_hash_from_echo``), stamped on write;
* the envelope carries ``cell`` (the registered campaign cell that owns
  the file, or null for free-standing files) and ``campaign`` (the cell
  hash, resolved params, partial-write flag, claim outcomes).

v1 files (no hashes) still **load** — ``validate_record`` accepts both
versions — but the campaign layer reports them STALE;
``python -m repro_torch.experiments.validate --migrate`` re-stamps them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

SCHEMA_VERSION = 2
SUPPORTED_SCHEMAS = (1, 2)          # v1 loads (legacy); v2 is current

RECORD_KEYS = ("schema_version", "spec", "metrics", "curve", "runtime",
               "staleness")
RECORD_KEYS_V2 = RECORD_KEYS + ("spec_hash",)
ENVELOPE_KEYS = ("schema_version", "benchmark", "records", "derived")
ENVELOPE_KEYS_V2 = ENVELOPE_KEYS + ("cell", "campaign")


def _jsonable(x):
    """numpy scalars/arrays → plain python (json.dump chokes on np types)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


@dataclasses.dataclass
class RunResult:
    """The result of one experiment run.  JSON-stable fields only in
    :meth:`record`; device-side outputs stay in-memory attributes."""

    spec: Dict[str, Any]
    metrics: Dict[str, float]
    curve: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    runtime: Dict[str, float] = dataclasses.field(default_factory=dict)
    staleness: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION
    spec_hash: str = ""             # content address; self-stamped on write
    # ---- in-memory only (never serialized) --------------------------------
    params: Any = dataclasses.field(default=None, repr=False, compare=False)
    trace: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def tag(self) -> str:
        return self.spec.get("tag", "")

    def record(self) -> Dict[str, Any]:
        """The stable JSON record (config echo + results, no arrays)."""
        if not self.spec_hash:
            # lazy import: hashing needs repro_torch.config;
            # merely loading records must not
            from repro_torch.experiments.spec_hash import spec_hash_from_echo
            self.spec_hash = spec_hash_from_echo(self.spec)
        return _jsonable({
            "schema_version": self.schema_version,
            "spec": self.spec,
            "spec_hash": self.spec_hash,
            "metrics": self.metrics,
            "curve": self.curve,
            "runtime": self.runtime,
            "staleness": self.staleness,
        })

    def to_json(self, **kw) -> str:
        return json.dumps(self.record(), **kw)

    @classmethod
    def from_record(cls, d: Dict[str, Any]) -> "RunResult":
        validate_record(d)
        return cls(spec=d["spec"], metrics=d["metrics"], curve=d["curve"],
                   runtime=d["runtime"], staleness=d["staleness"],
                   schema_version=d["schema_version"],
                   spec_hash=d.get("spec_hash", ""))

    @classmethod
    def from_json(cls, s: str) -> "RunResult":
        return cls.from_record(json.loads(s))


# ---------------------------------------------------------------------------
# validation — the CI gate for benchmarks/results/*.json
# ---------------------------------------------------------------------------
def validate_record(d: Dict[str, Any], where: str = "record") -> None:
    """Raise ValueError unless ``d`` is a valid RunResult record."""
    if not isinstance(d, dict):
        raise ValueError(f"{where}: not an object")
    keys = RECORD_KEYS_V2 if d.get("schema_version") == 2 else RECORD_KEYS
    missing = [k for k in keys if k not in d]
    if missing:
        raise ValueError(f"{where}: missing keys {missing}")
    if d["schema_version"] not in SUPPORTED_SCHEMAS:
        raise ValueError(f"{where}: schema_version {d['schema_version']} "
                         f"not in {SUPPORTED_SCHEMAS}")
    for key, typ in (("spec", dict), ("metrics", dict), ("curve", list),
                     ("runtime", dict), ("staleness", dict)):
        if not isinstance(d[key], typ):
            raise ValueError(f"{where}: {key} must be {typ.__name__}")
    if d["schema_version"] == 2 and not (
            isinstance(d["spec_hash"], str) and d["spec_hash"]):
        raise ValueError(f"{where}: spec_hash must be a non-empty string")
    if "run" not in d["spec"]:
        raise ValueError(f"{where}: spec echo lacks the RunConfig ('run')")
    for i, row in enumerate(d["curve"]):
        if not isinstance(row, dict) or "update" not in row:
            raise ValueError(f"{where}: curve[{i}] lacks 'update'")


def envelope(benchmark: str, records=(),
             derived: Optional[Dict[str, Any]] = None,
             cell: Optional[str] = None,
             campaign: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The shared results-file shape: RunResult records + free-form derived
    values (claim booleans, speedup tables, timing comparisons).  ``cell``
    / ``campaign`` carry the content-address stamp when the file is owned
    by a registered campaign cell (null / {} for free-standing files)."""
    recs = [r.record() if isinstance(r, RunResult) else r for r in records]
    return _jsonable({"schema_version": SCHEMA_VERSION,
                      "benchmark": benchmark,
                      "cell": cell,
                      "campaign": campaign or {},
                      "records": recs,
                      "derived": derived or {}})


def validate_results_file(path: str) -> int:
    """Validate one results JSON against the envelope + record schema.
    Returns the number of records checked; raises ValueError on violation."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not an object")
    keys = ENVELOPE_KEYS_V2 if data.get("schema_version") == 2 \
        else ENVELOPE_KEYS
    missing = [k for k in keys if k not in data]
    if missing:
        raise ValueError(f"{path}: missing envelope keys {missing}")
    if data["schema_version"] not in SUPPORTED_SCHEMAS:
        raise ValueError(f"{path}: schema_version {data['schema_version']}")
    if not isinstance(data["records"], list):
        raise ValueError(f"{path}: records must be a list")
    if not isinstance(data["derived"], dict):
        raise ValueError(f"{path}: derived must be an object")
    for i, rec in enumerate(data["records"]):
        validate_record(rec, where=f"{path}: records[{i}]")
    return len(data["records"])
