"""Pretty-print observability artifacts.

    python -m deeplearning4j_tpu_torch.observe.dump snapshot.json
    python -m deeplearning4j_tpu_torch.observe.dump spans.jsonl --tail 20
    python -m deeplearning4j_tpu_torch.observe.dump --live

Three inputs, auto-detected:
- a registry snapshot (`MetricsRegistry.snapshot()` saved as JSON, or a
  BENCH_*.json blob embedding one under "registry") → aligned table;
- a span/metric JSONL log (`SpanLog` / `export_jsonl`) → one formatted
  line per event, `--tail N` for the last N;
- `--live` → the current process-wide registry (for use from a REPL or
  under `python -c`).

Import cost is stdlib-only (a copy of `deeplearning4j_tpu/observe/dump.py`),
so this works on machines without torch.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def format_snapshot(snap: dict) -> str:
    """Aligned text table for a MetricsRegistry.snapshot() dict."""
    series = snap.get("series", snap)
    rows: List[tuple] = []
    for name in sorted(series):
        for s in series[name]:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(s.get("labels", {}).items()))
            kind = s.get("type", "?")
            if kind == "histogram":
                val = (f"count={s.get('count')} sum={_fmt(s.get('sum'))} "
                       f"p50={_fmt(s.get('p50'))} p95={_fmt(s.get('p95'))} "
                       f"p99={_fmt(s.get('p99'))}")
            else:
                val = _fmt(s.get("value"))
            rows.append((name, kind, labels, val))
    if not rows:
        return "(no series)"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = max(len(r[2]) for r in rows)
    return "\n".join(f"{n:<{w0}}  {k:<{w1}}  {l:<{w2}}  {v}"
                     for n, k, l, v in rows)


def format_span(ev: dict) -> str:
    attrs = ev.get("attrs") or {}
    extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
    parent = ev.get("parent_id")
    ind = "  " if parent else ""
    return (f"{ev.get('ts', 0):.3f} {ind}{ev.get('name', '?'):<24} "
            f"{ev.get('dur_ms', 0):>10.3f} ms  "
            f"[{ev.get('span_id')}<-{parent}] {extra}").rstrip()


def format_jsonl_line(ev: dict) -> str:
    if "dur_ms" in ev:                       # span event
        return format_span(ev)
    labels = ",".join(f"{k}={v}"
                      for k, v in sorted((ev.get("labels") or {}).items()))
    val = (f"count={ev.get('count')} sum={_fmt(ev.get('sum'))}"
           if ev.get("type") == "histogram" else _fmt(ev.get("value")))
    return f"{ev.get('name', '?'):<32} {ev.get('type', '?'):<9} " \
           f"{labels:<24} {val}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def dump_file(path: str, tail: Optional[int] = None) -> str:
    if path.endswith(".jsonl"):
        with open(path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
        if tail:
            events = events[-tail:]
        return "\n".join(format_jsonl_line(e) for e in events)
    with open(path) as f:
        blob = json.load(f)
    # BENCH blobs embed the snapshot under "registry"
    if "registry" in blob and isinstance(blob["registry"], dict):
        blob = blob["registry"]
    return format_snapshot(blob)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.observe.dump",
        description="Pretty-print a metrics registry snapshot or tail a "
                    "span/metrics JSONL log.")
    ap.add_argument("path", nargs="?",
                    help="snapshot .json (or BENCH blob) / span .jsonl")
    ap.add_argument("--tail", type=int, default=None, metavar="N",
                    help="only the last N JSONL events")
    ap.add_argument("--live", action="store_true",
                    help="dump the current process-wide registry")
    args = ap.parse_args(argv)
    if args.live:
        from deeplearning4j_tpu_torch.observe.registry import get_registry
        print(format_snapshot(get_registry().snapshot()))
        return 0
    if not args.path:
        ap.error("need a path (or --live)")
    try:
        print(dump_file(args.path, args.tail))
    except BrokenPipeError:      # `dump ... | head` is a normal usage
        sys.stderr.close()
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
