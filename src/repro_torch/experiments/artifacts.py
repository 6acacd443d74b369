"""JSON + markdown artifact writers (schema v7 rows of
``repro/experiments/artifacts.py``).

Every suite writes ``<suite>.json`` — ``{"schema_version": 7, "suite",
"generated_by": "repro_torch.experiments", "params", "rows"}`` — and
``<suite>.md`` with the same rows as markdown tables.  A suite run
inside a collecting scope (``--trace``, or
:func:`repro_torch.telemetry.collecting`) adds the schema-v5
``telemetry`` block: the ambient registry's snapshot (counters, gauges,
timers).  It is absent when telemetry is off.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from ..telemetry import get_metrics

SCHEMA_VERSION = 7


def artifact_payload(suite: str, params: dict, rows: "list[dict]") -> dict:
    payload = {"schema_version": SCHEMA_VERSION, "suite": suite,
               "generated_by": "repro_torch.experiments", "params": params,
               "rows": rows}
    mx = get_metrics()
    if mx.enabled:
        payload["telemetry"] = mx.snapshot()
    return payload


def write_json(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=_coerce)
        f.write("\n")
    return path


def _coerce(obj):
    """Make numpy / torch scalars and arrays JSON-serializable."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj)}")


def markdown_table(rows: Sequence[dict], columns: "Sequence[str] | None" = None
                   ) -> str:
    """Render dict rows as a GitHub markdown table (union of keys, in
    first-seen order, unless ``columns`` pins the selection)."""
    if not rows:
        return "(no rows)\n"
    if columns is None:
        columns = list(dict.fromkeys(k for r in rows for k in r))
    head = "| " + " | ".join(columns) + " |"
    sep = "|" + "|".join([" --- "] * len(columns)) + "|"
    body = ["| " + " | ".join(_fmt(r.get(c)) for c in columns) + " |"
            for r in rows]
    return "\n".join([head, sep, *body]) + "\n"


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:,.4g}" if abs(v) < 1e6 else f"{v:,.0f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


def write_markdown(path: str, title: str, sections: "list[tuple[str, str]]"
                   ) -> str:
    """Write a markdown doc: ``sections`` is (heading, body) pairs."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    parts = [f"# {title}", ""]
    for heading, body in sections:
        if heading:
            parts += [f"## {heading}", ""]
        parts += [body.rstrip(), ""]
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path
