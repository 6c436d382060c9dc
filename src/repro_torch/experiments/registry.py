"""The campaign cell registry of the port (counterpart of
``repro/experiments/registry.py``, DESIGN.md §15).

Every paper table/figure is a **Cell**: a named, versioned description of
how its results file is produced —

* ``specs(**params)`` — the cell's spec-graph: the list of
  :class:`ExperimentSpec`\\ s whose RunResults are the file's ``records``
  (None for compute cells);
* ``derive(results, params, device)`` — records → the free-form
  ``derived`` dict (claim inputs, curves, tables).  Pure in the records
  for spec cells; a handful of *timing* cells measure wall-clock here, on
  ``device`` (the port's one addition to the reference's signature: an
  explicit device), and are documented as such;
* ``compute(device=..., **params)`` — for cells with no spec-graph
  (analytic models, wall-clock benchmarks, subprocess measurements):
  returns ``(records, derived)`` directly;
* ``claims`` — declarative :class:`Claim` checks over ``derived``,
  evaluated by the campaign runner into the envelope's campaign block;
* ``deps`` — names of cells whose results this cell consumes, resolved
  as a DAG by the campaign CLI and folded into this cell's content hash.

Cells register under short names (``fig4``, ``table2``, ``sim_engine``)
via :func:`register_cell`; ``repro_torch.experiments.cells`` imports every
cell ported so far, so loading the registry is one import.  Content addressing:

* ``cell_spec_hashes(cell, params)`` — the per-record addresses;
* ``cell_hash(cell, params)`` — the whole-cell address: name, version,
  schema, the spec hashes (or canonical params for compute cells), and
  the dep cells' hashes.  An envelope stamped with a matching cell hash
  whose records cover the spec hashes is CURRENT and never re-run.

The spec hashes are the port's (``spec_hash`` names the backend), so a
cell hash of this package never equals the JAX package's for the same
cell: a port envelope can never pass as the reference's, nor the other way
round.  Results live in ``results_torch/`` at the repository root
(``REPRO_TORCH_RESULTS_DIR`` overrides it; the reference's
``REPRO_RESULTS_DIR`` does not), never under ``benchmarks/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.experiments.result import SCHEMA_VERSION
from repro_torch.experiments.spec_hash import content_hash, spec_hash


def emit(name: str, value, derived: str = "") -> None:
    """CSV row ``name,value,derived`` — the benchmark output idiom."""
    print(f"{name},{value},{derived}")


@dataclasses.dataclass(frozen=True)
class Claim:
    """A declarative check over a cell's ``derived`` dict."""

    name: str
    check: Callable[[Dict[str, Any]], bool]
    detail: Optional[Callable[[Dict[str, Any]], str]] = None

    def evaluate(self, derived: Dict[str, Any]) -> Tuple[bool, str]:
        try:
            ok = bool(self.check(derived))
        except (KeyError, TypeError, ZeroDivisionError) as e:
            return False, f"check raised {type(e).__name__}: {e}"
        det = ""
        if self.detail is not None:
            try:
                det = self.detail(derived)
            except Exception:
                det = ""
        return ok, det


def derived_claims(*names: str) -> Tuple[Claim, ...]:
    """Claims over a derive() that already computes ``derived["claims"]``
    booleans — the declarative layer just re-asserts them by name."""
    return tuple(Claim(n, (lambda d, n=n: bool(d["claims"][n])))
                 for n in names)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One registered table/figure — see the module docstring."""

    name: str
    result: str                     # results file stem (benchmark field)
    title: str = ""
    specs: Optional[Callable[..., List]] = None
    derive: Optional[Callable[..., Dict[str, Any]]] = None
    compute: Optional[Callable[..., Tuple[list, Dict[str, Any]]]] = None
    claims: Tuple[Claim, ...] = ()
    deps: Tuple[str, ...] = ()
    campaigns: Tuple[str, ...] = ("paper",)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    quick_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    skip_quick: bool = False        # minutes-long cells: not run by --quick
    needs_results_dir: bool = False  # compute/derive reads dep envelopes
    version: int = 1                # bump on semantic change → cache bust
    checkpoint_every: int = 8       # partial-envelope flush cadence

    def __post_init__(self):
        if (self.specs is None) == (self.compute is None):
            raise ValueError(f"cell {self.name!r}: exactly one of specs / "
                             f"compute must be set")
        if self.specs is not None and self.derive is None:
            raise ValueError(f"cell {self.name!r}: spec cells need derive")

    def resolved_params(self, params: Optional[Dict[str, Any]] = None,
                        quick: bool = False) -> Dict[str, Any]:
        out = dict(self.params)
        if quick:
            out.update(self.quick_params)
        out.update(params or {})
        return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_CELLS: Dict[str, Cell] = {}


def register_cell(cell: Cell) -> Cell:
    if cell.name in _CELLS:
        raise ValueError(f"cell {cell.name!r} already registered")
    clash = [c.name for c in _CELLS.values() if c.result == cell.result]
    if clash:
        raise ValueError(f"cell {cell.name!r}: result file "
                         f"{cell.result!r} already owned by {clash[0]!r}")
    _CELLS[cell.name] = cell
    return cell


def _load_cells() -> None:
    import repro_torch.experiments.cells  # noqa: F401  (registers on import)


def get_cell(name: str) -> Cell:
    _load_cells()
    if name not in _CELLS:
        raise KeyError(f"unknown cell {name!r}; registered: {cell_names()}")
    return _CELLS[name]


def cell_names() -> Tuple[str, ...]:
    _load_cells()
    return tuple(sorted(_CELLS))


def cell_for_result(stem: str) -> Optional[Cell]:
    """The cell owning results file ``<stem>.json``, or None."""
    _load_cells()
    for cell in _CELLS.values():
        if cell.result == stem:
            return cell
    return None


def cells_in(campaign: str) -> List[Cell]:
    """The campaign's cells in topological (dependency) order."""
    _load_cells()
    members = [c.name for c in _CELLS.values() if campaign in c.campaigns]
    if not members:
        raise KeyError(f"no cells registered in campaign {campaign!r}; "
                       f"known: {sorted({g for c in _CELLS.values() for g in c.campaigns})}")
    return [_CELLS[n] for n in resolve_order(members)]


def resolve_order(names: Sequence[str]) -> List[str]:
    """Topological order over ``names`` plus every transitive dep; raises
    on cycles.  Deterministic: dependency-first, then registration order."""
    _load_cells()
    order: List[str] = []
    state: Dict[str, int] = {}      # 0 visiting, 1 done

    def visit(n: str, chain: Tuple[str, ...]):
        if state.get(n) == 1:
            return
        if state.get(n) == 0:
            cyc = " -> ".join(chain + (n,))
            raise ValueError(f"cell dependency cycle: {cyc}")
        if n not in _CELLS:
            raise KeyError(f"unknown cell {n!r} (dep chain "
                           f"{' -> '.join(chain) or 'root'})")
        state[n] = 0
        for d in _CELLS[n].deps:
            visit(d, chain + (n,))
        state[n] = 1
        order.append(n)

    for n in names:
        visit(n, ())
    return order


# ---------------------------------------------------------------------------
# content addressing
# ---------------------------------------------------------------------------
_SPECS_MEMO: Dict[Tuple[str, str], List] = {}


def cell_specs(cell: Cell, params: Optional[Dict[str, Any]] = None,
               quick: bool = False) -> List:
    """Build (and memoize) the cell's spec list at resolved params.  Spec
    construction must be deterministic — some cells run a dry measure-mode
    schedule to size horizons, which is deterministic but not free, hence
    the memo."""
    if cell.specs is None:
        return []
    p = cell.resolved_params(params, quick=quick)
    key = (cell.name, json.dumps(content_hash(p)))
    if key not in _SPECS_MEMO:
        _SPECS_MEMO[key] = list(cell.specs(**p))
    return _SPECS_MEMO[key]


def cell_spec_hashes(cell: Cell, params: Optional[Dict[str, Any]] = None,
                     quick: bool = False) -> List[str]:
    return [spec_hash(s) for s in cell_specs(cell, params, quick=quick)]


def cell_hash(cell: Cell, params: Optional[Dict[str, Any]] = None,
              quick: bool = False) -> str:
    """The whole-cell content address (see module docstring).  Dep cells
    enter at their *default* params — the registry identity, not whatever
    a particular invocation ran them with."""
    p = cell.resolved_params(params, quick=quick)
    payload: Dict[str, Any] = {
        "cell": cell.name,
        "version": cell.version,
        "schema": SCHEMA_VERSION,
        "deps": {d: cell_hash(get_cell(d)) for d in cell.deps},
    }
    if cell.specs is not None:
        payload["specs"] = cell_spec_hashes(cell, params, quick=quick)
    else:
        payload["params"] = p
    return content_hash(payload)


# ---------------------------------------------------------------------------
# results files
# ---------------------------------------------------------------------------
def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def default_results_dir() -> str:
    return os.environ.get("REPRO_TORCH_RESULTS_DIR",
                          os.path.join(repo_root(), "results_torch"))


def results_path(cell: Cell, results_dir: Optional[str] = None) -> str:
    return os.path.join(results_dir or default_results_dir(),
                        f"{cell.result}.json")


def load_envelope(name_or_cell, results_dir: Optional[str] = None
                  ) -> Optional[Dict[str, Any]]:
    """The cell's envelope as written, or None if absent/unreadable."""
    cell = (name_or_cell if isinstance(name_or_cell, Cell)
            else get_cell(name_or_cell))
    path = results_path(cell, results_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
