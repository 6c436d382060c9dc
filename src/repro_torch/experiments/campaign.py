"""The campaign runner of the port: the paper as one resumable DAG
(counterpart of ``repro/experiments/campaign.py``, DESIGN.md §15).

::

    python -m repro_torch.experiments.campaign paper               # on the card
    python -m repro_torch.experiments.campaign paper --dry-run     # plan only
    python -m repro_torch.experiments.campaign --only elastic      # one cell
    python -m repro_torch.experiments.campaign --only elastic --device cpu
    python -m repro_torch.experiments.campaign report              # claims
    python -m repro_torch.experiments.campaign list                # registry

Cells run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).  Only the cells ported so far are registered
(``repro_torch.experiments.cells``), and envelopes go to the port's own
results directory (``registry.default_results_dir``).

Each registered :class:`~repro_torch.experiments.registry.Cell` resolves to a
**status** against the results directory before anything executes:

* ``CURRENT`` — the envelope's campaign stamp matches the cell's content
  hash and (for spec cells) its records cover every spec hash: skipped;
* ``PARTIAL`` — stamp matches but records cover a strict subset of the
  spec hashes (an interrupted grid): only the missing specs run, cached
  records are reused **byte-identically**;
* ``STALE`` — legacy v1 envelope, missing stamps, or a hash mismatch
  (spec change, config default change, problem version bump, dep cell
  re-addressed): re-executed;
* ``MISSING`` — no envelope: executed.

``--force`` re-executes regardless of status (scoped to ``--only`` cells
when given).  Spec cells flush a partial envelope every
``checkpoint_every`` completed specs, so an interrupted campaign resumes
at the first missing record, not the first missing cell.

Claims evaluate after derive and land in the envelope's campaign block;
``--strict`` turns any failed claim or non-CURRENT outcome into a
non-zero exit.  ``--status-json`` writes the per-cell action/seconds
ledger the CI cache-hit assertions read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.experiments.registry import (Cell, cell_hash, cell_spec_hashes,
                                        cell_specs, cells_in,
                                        default_results_dir, get_cell,
                                        load_envelope, resolve_order,
                                        results_path)
from repro_torch.experiments.result import RunResult, envelope

CAMPAIGNS = ("paper", "extended", "smoke")
DEFAULT_DEVICE = "cuda"


# ---------------------------------------------------------------------------
# status
# ---------------------------------------------------------------------------
def cell_status(cell: Cell, params: Optional[Dict[str, Any]] = None,
                quick: bool = False, results_dir: Optional[str] = None
                ) -> Tuple[str, str]:
    """(status, detail) of the cell's envelope against its content hash."""
    data = load_envelope(cell, results_dir)
    if data is None:
        return "MISSING", "no results file"
    if data.get("schema_version") != 2:
        return "STALE", f"schema v{data.get('schema_version')} (legacy)"
    camp = data.get("campaign") or {}
    stamped = camp.get("cell_hash", "")
    want = cell_hash(cell, params, quick=quick)
    if stamped != want:
        return "STALE", f"cell_hash {stamped or '(none)'} != {want}"
    if cell.specs is None:
        return "CURRENT", "cell hash matches"
    have = [r.get("spec_hash", "") for r in data.get("records", [])]
    want_hashes = cell_spec_hashes(cell, params, quick=quick)
    unknown = [h for h in have if h not in set(want_hashes)]
    if unknown:
        return "STALE", f"{len(unknown)} record(s) match no spec"
    missing = [h for h in want_hashes if h not in set(have)]
    if missing:
        return ("PARTIAL",
                f"{len(want_hashes) - len(missing)}/{len(want_hashes)} "
                f"records present")
    return "CURRENT", f"all {len(want_hashes)} records present"


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def _evaluate_claims(cell: Cell, derived: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for claim in cell.claims:
        ok, detail = claim.evaluate(derived)
        out[claim.name] = {"ok": ok, **({"detail": detail} if detail else {})}
    return out


def _campaign_block(cell: Cell, params: Dict[str, Any], quick: bool,
                    partial: bool, claims: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    block: Dict[str, Any] = {
        "cell_hash": cell_hash(cell, params, quick=quick),
        "params": cell.resolved_params(params, quick=quick),
        "partial": partial,
    }
    if quick:
        block["quick"] = True
    if claims is not None:
        block["claims"] = claims
    return block


def write_envelope(cell: Cell, records: List[Dict[str, Any]],
                   derived: Dict[str, Any], params: Dict[str, Any],
                   quick: bool, partial: bool, results_dir: Optional[str],
                   claims: Optional[Dict[str, Any]] = None) -> str:
    path = results_path(cell, results_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = envelope(cell.result, records, derived, cell=cell.name,
                    campaign=_campaign_block(cell, params, quick, partial,
                                             claims))
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)
        f.write("\n")
    return path


def _run_spec_cell(cell: Cell, params: Dict[str, Any], quick: bool,
                   results_dir: Optional[str], force: bool,
                   device) -> Dict[str, Any]:
    """Execute (or resume) a spec cell on ``device``; returns the claims
    dict."""
    from repro_torch.experiments.driver import run_sweep

    specs = cell_specs(cell, params, quick=quick)
    hashes = cell_spec_hashes(cell, params, quick=quick)
    if len(set(hashes)) != len(hashes):
        dup = [h for h in hashes if hashes.count(h) > 1][0]
        raise ValueError(f"cell {cell.name!r}: duplicate spec hash {dup} — "
                         f"grid points must be distinguishable (tag them)")

    cached: Dict[str, Dict[str, Any]] = {}
    if not force:
        data = load_envelope(cell, results_dir)
        if data is not None and data.get("schema_version") == 2:
            stamped = (data.get("campaign") or {}).get("cell_hash", "")
            if stamped == cell_hash(cell, params, quick=quick):
                for rec in data.get("records", []):
                    h = rec.get("spec_hash", "")
                    if h in set(hashes):
                        cached[h] = rec      # reused verbatim: byte-stable

    todo = [(i, s) for i, (s, h) in enumerate(zip(specs, hashes))
            if h not in cached]
    done: Dict[str, Dict[str, Any]] = dict(cached)

    step = max(1, cell.checkpoint_every)
    for lo in range(0, len(todo), step):
        chunk = todo[lo:lo + step]
        for res in run_sweep([s for _, s in chunk], device=device):
            rec = res.record()
            done[rec["spec_hash"]] = rec
        if lo + step < len(todo):       # mid-grid: flush a resumable partial
            partial_records = [done[h] for h in hashes if h in done]
            write_envelope(cell, partial_records, {}, params, quick,
                           partial=True, results_dir=results_dir)

    records = [done[h] for h in hashes]
    results = [RunResult.from_record(r) for r in records]
    p = cell.resolved_params(params, quick=quick)
    derived = cell.derive(results, p, device)
    claims = _evaluate_claims(cell, derived)
    write_envelope(cell, records, derived, params, quick, partial=False,
                   results_dir=results_dir, claims=claims)
    return claims


def _run_compute_cell(cell: Cell, params: Dict[str, Any], quick: bool,
                      results_dir: Optional[str], device) -> Dict[str, Any]:
    p = cell.resolved_params(params, quick=quick)
    kw = dict(p, device=device)
    if cell.needs_results_dir:
        kw["results_dir"] = results_dir or default_results_dir()
    records, derived = cell.compute(**kw)
    claims = _evaluate_claims(cell, derived)
    write_envelope(cell, [r.record() if isinstance(r, RunResult) else r
                          for r in records],
                   derived, params, quick, partial=False,
                   results_dir=results_dir, claims=claims)
    return claims


def execute_cell(cell: Cell, params: Optional[Dict[str, Any]] = None,
                 quick: bool = False, results_dir: Optional[str] = None,
                 force: bool = False,
                 device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Run one cell to a finished envelope on ``device``; returns its
    claims dict."""
    if cell.specs is not None:
        return _run_spec_cell(cell, params or {}, quick, results_dir, force,
                              device)
    return _run_compute_cell(cell, params or {}, quick, results_dir, device)


def run_cell(name: str, params: Optional[Dict[str, Any]] = None,
             force: bool = True, quick: bool = False,
             results_dir: Optional[str] = None,
             device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Execute a cell on ``device`` and return its envelope's ``derived``
    dict."""
    cell = get_cell(name)
    if not force:
        status, _ = cell_status(cell, params, quick, results_dir)
        if status == "CURRENT":
            return (load_envelope(cell, results_dir) or {}).get("derived", {})
    execute_cell(cell, params, quick=quick, results_dir=results_dir,
                 force=force, device=device)
    return (load_envelope(cell, results_dir) or {}).get("derived", {})


# ---------------------------------------------------------------------------
# campaign loop
# ---------------------------------------------------------------------------
def plan(campaign: str, only: Sequence[str] = ()) -> List[Cell]:
    """The cells to visit, dependency-first."""
    if only:
        return [get_cell(n) for n in resolve_order(list(only))]
    return cells_in(campaign)


def run_campaign(campaign: str = "paper", only: Sequence[str] = (),
                 force: bool = False, dry_run: bool = False,
                 quick: bool = False, results_dir: Optional[str] = None,
                 out=sys.stdout, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Drive the DAG; returns the status ledger (also ``--status-json``)."""
    if quick and results_dir is None:
        # a quick grid must never clobber the checked-in full-size results
        results_dir = os.path.join(default_results_dir(), "quick")
    forced = set(only) if only else None    # --force scoped to --only cells
    ledger: Dict[str, Any] = {"campaign": campaign, "quick": quick,
                              "device": str(device),
                              "results_dir": results_dir or
                              default_results_dir(),
                              "cells": {}, "executed": 0, "cached": 0,
                              "skipped": 0, "failed_claims": 0}
    t_campaign = time.monotonic()
    for cell in plan(campaign, only):
        entry: Dict[str, Any] = {}
        t0 = time.monotonic()
        if quick and cell.skip_quick:
            entry.update(status="SKIPPED", action="skipped",
                         detail="skip_quick")
            ledger["skipped"] += 1
        else:
            status, detail = cell_status(cell, None, quick, results_dir)
            entry.update(status=status, detail=detail,
                         cell_hash=cell_hash(cell, None, quick=quick))
            do_force = force and (forced is None or cell.name in forced)
            if status == "CURRENT" and not do_force:
                entry["action"] = "cached"
                ledger["cached"] += 1
            elif dry_run:
                entry["action"] = "would-run"
            else:
                claims = execute_cell(cell, None, quick=quick,
                                      results_dir=results_dir,
                                      force=do_force or status == "STALE",
                                      device=device)
                entry["action"] = "executed"
                entry["claims"] = claims
                bad = [n for n, c in claims.items() if not c["ok"]]
                if bad:
                    entry["failed_claims"] = bad
                    ledger["failed_claims"] += len(bad)
                ledger["executed"] += 1
        entry["seconds"] = round(time.monotonic() - t0, 3)
        ledger["cells"][cell.name] = entry
        print(f"[campaign] {cell.name:<14} {entry['status']:<8} "
              f"{entry['action']:<10} {entry['seconds']:>8.2f}s  "
              f"{entry.get('detail', '')}", file=out)
    ledger["total_seconds"] = round(time.monotonic() - t_campaign, 3)
    print(f"[campaign] {campaign}: {ledger['executed']} executed, "
          f"{ledger['cached']} cached, {ledger['skipped']} skipped in "
          f"{ledger['total_seconds']:.1f}s", file=out)
    return ledger


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
def report(campaign: str = "paper", results_dir: Optional[str] = None,
           out=sys.stdout) -> int:
    """Claim/status report over the registry; returns #problems."""
    problems = 0
    for cell in cells_in(campaign):
        status, detail = cell_status(cell, None, False, results_dir)
        if status != "CURRENT":
            problems += 1
        print(f"{cell.name:<14} {status:<8} {cell.title or cell.result}",
              file=out)
        data = load_envelope(cell, results_dir)
        claims = ((data or {}).get("campaign") or {}).get("claims") or {}
        for name, c in sorted(claims.items()):
            mark = "PASS" if c.get("ok") else "FAIL"
            if not c.get("ok"):
                problems += 1
            print(f"  claim {mark:<4} {name}"
                  + (f"  ({c['detail']})" if c.get("detail") else ""),
                  file=out)
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.campaign",
        description="Run paper campaigns as a content-addressed DAG.")
    ap.add_argument("campaign", nargs="?", default="paper",
                    help=f"campaign name {CAMPAIGNS}, 'report', or 'list'")
    ap.add_argument("--only", action="append", default=[],
                    help="run only this cell (+ its deps); repeatable")
    ap.add_argument("--force", action="store_true",
                    help="re-execute even when CURRENT (scoped to --only)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan and each cell's status; run nothing")
    ap.add_argument("--quick", action="store_true",
                    help="cheap parameterizations (CI lane); writes to "
                         "<results>/quick unless --results-dir is given")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the cells replay: cuda (default) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--status-json", default=None,
                    help="write the per-cell action/seconds ledger here")
    ap.add_argument("--strict", action="store_true",
                    help="non-zero exit on failed claims or non-CURRENT "
                         "dry-run cells")
    args = ap.parse_args(argv)

    if args.campaign == "list":
        from repro_torch.experiments.registry import cell_names
        for name in cell_names():
            cell = get_cell(name)
            kind = "spec" if cell.specs is not None else "compute"
            deps = f" deps={','.join(cell.deps)}" if cell.deps else ""
            print(f"{name:<14} {kind:<7} {cell.result:<20} "
                  f"[{','.join(cell.campaigns)}]{deps}  {cell.title}")
        return 0

    if args.campaign == "report":
        problems = report(results_dir=args.results_dir)
        return 1 if (args.strict and problems) else 0

    ledger = run_campaign(args.campaign, only=tuple(args.only),
                          force=args.force, dry_run=args.dry_run,
                          quick=args.quick, results_dir=args.results_dir,
                          device=args.device)
    if args.status_json:
        with open(args.status_json, "w") as f:
            json.dump(ledger, f, indent=1)
    if args.strict:
        not_current = [n for n, e in ledger["cells"].items()
                       if e["status"] != "CURRENT"
                       and e["action"] in ("would-run", "cached")]
        if args.dry_run and not_current:
            print(f"[campaign] --strict: {len(not_current)} cell(s) not "
                  f"CURRENT: {not_current}", file=sys.stderr)
            return 1
        if ledger["failed_claims"]:
            print(f"[campaign] --strict: {ledger['failed_claims']} "
                  f"failed claim(s)", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
