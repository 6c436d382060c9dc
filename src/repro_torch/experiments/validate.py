"""Validate the port's results files against the RunResult record schema
AND the port's campaign registry (counterpart of
``repro/experiments/validate.py``, DESIGN.md §15).

    PYTHONPATH=src python -m repro_torch.experiments.validate
    PYTHONPATH=src python -m repro_torch.experiments.validate results_torch
    PYTHONPATH=src python -m repro_torch.experiments.validate --strict

Walks every ``*.json`` under the given paths (or the port's default
results directory, ``registry.default_results_dir()``), checks the envelope + each record
(``result.validate_results_file``), and exits non-zero on any schema
violation — the CI smoke lane's schema gate.

On top of the schema, every file owned by a registered cell is checked for
**staleness**: a legacy (v1) envelope, records missing ``spec_hash``, or a
campaign stamp that no longer matches the registry's cell hash all report
``STALE``.  Plain runs only warn (the schema stays the hard gate);
``--strict`` turns any STALE file into a non-zero exit.

``--migrate`` re-stamps legacy envelopes in place: each record gains the
``spec_hash`` of its **own recorded spec echo** (records are otherwise
byte-identical), the envelope gains the owning cell's name and campaign
block at the registry's default params, and ``schema_version`` bumps to the
current schema.  Idempotent; files with no owning cell are left alone.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.experiments.result import SCHEMA_VERSION, validate_results_file


def _collect(paths):
    files = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(glob.glob(os.path.join(p, "*.json")))
            if not found:
                raise ValueError(
                    f"{p}: results directory contains no *.json files")
            files.extend(found)
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise ValueError(f"{p}: no such results file or directory")
    if not files:
        raise ValueError("no results files given (empty path list)")
    return files


def validate_paths(paths) -> int:
    """Validate every results JSON under ``paths``; returns the number of
    files checked.  Raises ValueError on the first schema violation, on a
    path that is neither a file nor a directory, and on a directory with no
    ``*.json`` at all — an empty or missing results directory must fail the
    CI gate loudly instead of "validating" nothing."""
    files = _collect(paths)
    for path in files:
        n = validate_results_file(path)
        print(f"[validate] {path}: ok ({n} records)")
    return len(files)


def staleness_report(paths) -> list:
    """(path, status, detail) for every file owned by a registered cell.

    STALE means the file no longer matches the registry's content address:
    legacy schema, records without ``spec_hash``, or a ``cell_hash`` stamp
    that differs from what the registered specs/params hash to today.
    Files whose stem no cell owns get status ``UNREGISTERED`` (informative,
    never an error: ad-hoc results are allowed to exist)."""
    from repro_torch.experiments.campaign import cell_status
    from repro_torch.experiments.registry import cell_for_result

    rows = []
    for path in _collect(paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        cell = cell_for_result(stem)
        if cell is None:
            rows.append((path, "UNREGISTERED", "no cell owns this file"))
            continue
        status, detail = cell_status(cell,
                                     results_dir=os.path.dirname(path))
        rows.append((path, status, detail))
    return rows


def migrate_file(path: str) -> str:
    """Re-stamp one legacy envelope in place (see module docstring).
    Returns what happened: 'migrated', 'current', or 'unregistered'."""
    from repro_torch.experiments.registry import cell_for_result, cell_hash
    from repro_torch.experiments.spec_hash import spec_hash_from_echo

    stem = os.path.splitext(os.path.basename(path))[0]
    cell = cell_for_result(stem)
    if cell is None:
        return "unregistered"
    with open(path) as f:
        data = json.load(f)

    changed = data.get("schema_version") != SCHEMA_VERSION
    data["schema_version"] = SCHEMA_VERSION
    for rec in data.get("records", []):
        # the record's OWN echo is the identity — never the registry's
        # current spec list, which may legitimately differ (that's what
        # STALE is for)
        want = spec_hash_from_echo(rec["spec"])
        if rec.get("spec_hash") != want:
            rec["spec_hash"] = want
            changed = True
    stamp = {"cell_hash": cell_hash(cell),
             "params": cell.resolved_params(),
             "partial": False}
    if data.get("cell") != cell.name or data.get("campaign") != stamp:
        data["cell"] = cell.name
        data["campaign"] = stamp
        changed = True
    if not changed:
        return "current"
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)
        f.write("\n")
    return "migrated"


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    strict = "--strict" in args
    migrate = "--migrate" in args
    paths = [a for a in args if a not in ("--strict", "--migrate")]
    if not paths:
        from repro_torch.experiments.registry import default_results_dir
        paths = [default_results_dir()]

    try:
        if migrate:
            for path in _collect(paths):
                outcome = migrate_file(path)
                print(f"[validate] migrate {path}: {outcome}")
        n = validate_paths(paths)
        rows = staleness_report(paths)
    except (ValueError, OSError, KeyError) as e:
        # OSError: unreadable/vanished file — same loud failure as a schema
        # violation, never a silent green gate
        print(f"[validate] FAIL: {e}", file=sys.stderr)
        return 1

    stale = [r for r in rows if r[1] in ("STALE", "PARTIAL")]
    for path, status, detail in rows:
        if status != "CURRENT":
            print(f"[validate] {path}: {status} ({detail})")
    print(f"[validate] {n} file(s) conform to the RunResult record schema; "
          f"{len(stale)} stale/partial vs the campaign registry")
    if strict and stale:
        print(f"[validate] FAIL (--strict): {len(stale)} file(s) are stale "
              f"against the registry — re-run the campaign or --migrate "
              f"re-stamps legacy envelopes", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
