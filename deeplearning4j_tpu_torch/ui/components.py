"""Reusable chart/table/text UI components with JSON serde + SVG render.

A copy of `deeplearning4j_tpu/ui/components.py`, which imports
nothing of JAX: the port keeps its own.

Reference parity: `deeplearning4j-ui-components/` (26 files) — the
standalone library of JSON-serializable components (ChartLine,
ChartHistogram, ChartScatter, ChartStackedArea, ChartHorizontalBar,
ChartTimeline, ComponentTable, ComponentText, ComponentDiv,
DecoratorAccordion + Style classes) that the Play UI renders client-side.

TPU-era redesign: same component-as-JSON contract (`component_type` +
config, `to_dict`/`from_dict` round-trip) but each component also renders
itself to dependency-free inline SVG/HTML server-side, so dashboards work
from a bare `http.server` with no bundled JS chart library.
"""

from __future__ import annotations

import dataclasses
import json
from html import escape
from typing import Any, Dict, List, Sequence, Tuple

COMPONENT_REGISTRY: Dict[str, type] = {}


def register_component(cls):
    COMPONENT_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class Style:
    """Reference: ui-components `StyleChart`/`StyleText` etc. (subset)."""

    width: int = 640
    height: int = 260
    margin: int = 36
    stroke: str = "#2a6fdb"
    fill: str = "#8ab4ea"
    series_colors: Tuple[str, ...] = (
        "#2a6fdb", "#d64541", "#27ae60", "#8e44ad", "#e67e22", "#16a085")
    font_size: int = 11
    title_size: int = 14


DEFAULT_STYLE = Style()


class Component:
    """JSON contract shared by all components (reference: `Component.java`
    with the Jackson `@JsonTypeInfo` component-type tag)."""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["component_type"] = type(self).__name__
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Component":
        d = dict(d)
        tname = d.pop("component_type")
        cls = COMPONENT_REGISTRY[tname]
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        if "children" in kw:   # container components hold sub-components
            kw["children"] = tuple(
                Component.from_dict(c) if isinstance(c, dict) else c
                for c in kw["children"])
        if "style" in kw and isinstance(kw["style"], dict):
            sf = {f.name for f in dataclasses.fields(Style)}
            sty = {k: v for k, v in kw["style"].items() if k in sf}
            if "series_colors" in sty:
                sty["series_colors"] = tuple(sty["series_colors"])
            kw["style"] = Style(**sty)
        return cls(**kw)

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))

    def render(self) -> str:
        raise NotImplementedError


# ------------------------------------------------------------------ helpers
def _axes(style: Style, xmin, xmax, ymin, ymax, title: str) -> List[str]:
    W, H, M = style.width, style.height, style.margin
    parts = [
        f'<text x="{M}" y="{style.title_size + 2}" '
        f'font-size="{style.title_size}" font-weight="bold">'
        f'{escape(title)}</text>' if title else "",
        f'<line x1="{M}" y1="{H - M}" x2="{W - M}" y2="{H - M}" '
        'stroke="#999"/>',
        f'<line x1="{M}" y1="{M}" x2="{M}" y2="{H - M}" stroke="#999"/>',
        f'<text x="{M}" y="{H - M + style.font_size + 3}" '
        f'font-size="{style.font_size}">{_fmt(xmin)}</text>',
        f'<text x="{W - M}" y="{H - M + style.font_size + 3}" '
        f'font-size="{style.font_size}" text-anchor="end">{_fmt(xmax)}</text>',
        f'<text x="{M - 3}" y="{H - M}" font-size="{style.font_size}" '
        f'text-anchor="end">{_fmt(ymin)}</text>',
        f'<text x="{M - 3}" y="{M + style.font_size}" '
        f'font-size="{style.font_size}" text-anchor="end">{_fmt(ymax)}</text>',
    ]
    return parts


def _fmt(v) -> str:
    try:
        return f"{float(v):.4g}"
    except (TypeError, ValueError):
        return str(v)


def _scales(style: Style, xmin, xmax, ymin, ymax):
    W, H, M = style.width, style.height, style.margin
    dx = (xmax - xmin) or 1.0
    dy = (ymax - ymin) or 1.0

    def sx(x):
        return M + (W - 2 * M) * (x - xmin) / dx

    def sy(y):
        return H - M - (H - 2 * M) * (y - ymin) / dy

    return sx, sy


def _svg(style: Style, inner: Sequence[str]) -> str:
    return (f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'viewBox="0 0 {style.width} {style.height}" '
            f'width="{style.width}" height="{style.height}">'
            + "".join(inner) + "</svg>")


# --------------------------------------------------------------- components
@register_component
@dataclasses.dataclass(frozen=True)
class ChartLine(Component):
    """Multi-series line chart. Reference: ui-components `ChartLine.java`."""

    title: str = ""
    series_names: Tuple[str, ...] = ()
    x: Tuple[Tuple[float, ...], ...] = ()     # per-series x values
    y: Tuple[Tuple[float, ...], ...] = ()
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        xs = [v for s in self.x for v in s] or [0.0, 1.0]
        ys = [v for s in self.y for v in s] or [0.0, 1.0]
        xmin, xmax, ymin, ymax = min(xs), max(xs), min(ys), max(ys)
        sx, sy = _scales(st, xmin, xmax, ymin, ymax)
        parts = _axes(st, xmin, xmax, ymin, ymax, self.title)
        for i, (sxv, syv) in enumerate(zip(self.x, self.y)):
            color = st.series_colors[i % len(st.series_colors)]
            pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}"
                           for a, b in zip(sxv, syv))
            parts.append(f'<polyline fill="none" stroke="{color}" '
                         f'stroke-width="1.5" points="{pts}"/>')
            if i < len(self.series_names):
                parts.append(
                    f'<text x="{st.width - st.margin - 4}" '
                    f'y="{st.margin + 14 * (i + 1)}" text-anchor="end" '
                    f'font-size="{st.font_size}" fill="{color}">'
                    f'{escape(self.series_names[i])}</text>')
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ChartHistogram(Component):
    """Histogram bars from bin edges + counts. Reference:
    `ChartHistogram.java` (lowerBounds/upperBounds/yValues)."""

    title: str = ""
    lower_bounds: Tuple[float, ...] = ()
    upper_bounds: Tuple[float, ...] = ()
    counts: Tuple[float, ...] = ()
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        if not self.counts:
            return _svg(st, _axes(st, 0, 1, 0, 1, self.title))
        xmin, xmax = self.lower_bounds[0], self.upper_bounds[-1]
        ymax = max(self.counts) or 1.0
        sx, sy = _scales(st, xmin, xmax, 0.0, ymax)
        parts = _axes(st, xmin, xmax, 0, ymax, self.title)
        for lo, hi, c in zip(self.lower_bounds, self.upper_bounds,
                             self.counts):
            x0, x1 = sx(lo), sx(hi)
            y0, y1 = sy(c), sy(0)
            parts.append(
                f'<rect x="{x0:.1f}" y="{y0:.1f}" '
                f'width="{max(x1 - x0 - 1, 1):.1f}" '
                f'height="{max(y1 - y0, 0):.1f}" fill="{st.fill}" '
                f'stroke="{st.stroke}" stroke-width="0.5"/>')
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ChartScatter(Component):
    """Scatter plot (t-SNE viewer backbone). Reference:
    `ChartScatter.java`."""

    title: str = ""
    series_names: Tuple[str, ...] = ()
    x: Tuple[Tuple[float, ...], ...] = ()
    y: Tuple[Tuple[float, ...], ...] = ()
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        xs = [v for s in self.x for v in s] or [0.0, 1.0]
        ys = [v for s in self.y for v in s] or [0.0, 1.0]
        xmin, xmax, ymin, ymax = min(xs), max(xs), min(ys), max(ys)
        sx, sy = _scales(st, xmin, xmax, ymin, ymax)
        parts = _axes(st, xmin, xmax, ymin, ymax, self.title)
        for i, (sxv, syv) in enumerate(zip(self.x, self.y)):
            color = st.series_colors[i % len(st.series_colors)]
            for a, b in zip(sxv, syv):
                parts.append(f'<circle cx="{sx(a):.1f}" cy="{sy(b):.1f}" '
                             f'r="2.2" fill="{color}" fill-opacity="0.7"/>')
            if i < len(self.series_names):
                parts.append(
                    f'<text x="{st.width - st.margin - 4}" '
                    f'y="{st.margin + 14 * (i + 1)}" text-anchor="end" '
                    f'font-size="{st.font_size}" fill="{color}">'
                    f'{escape(self.series_names[i])}</text>')
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ChartHorizontalBar(Component):
    """Horizontal bars (per-layer magnitudes). Reference:
    `ChartHorizontalBar.java`."""

    title: str = ""
    labels: Tuple[str, ...] = ()
    values: Tuple[float, ...] = ()
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        n = len(self.values)
        if not n:
            return _svg(st, _axes(st, 0, 1, 0, 1, self.title))
        vmax = max(max(self.values), 0) or 1.0
        H = max(st.height, 2 * st.margin + 18 * n)
        st = dataclasses.replace(st, height=H)
        bar_h = (H - 2 * st.margin) / n
        parts = [p for p in _axes(st, 0, vmax, 0, n, self.title)
                 if "<text" not in p or "bold" in p]
        for i, (lab, v) in enumerate(zip(self.labels, self.values)):
            y = st.margin + i * bar_h
            w = (st.width - 2 * st.margin) * max(v, 0) / vmax
            parts.append(
                f'<rect x="{st.margin}" y="{y:.1f}" width="{w:.1f}" '
                f'height="{bar_h - 3:.1f}" fill="{st.fill}"/>')
            parts.append(
                f'<text x="{st.margin + 3}" y="{y + bar_h / 2 + 4:.1f}" '
                f'font-size="{st.font_size}">{escape(lab)} '
                f'({_fmt(v)})</text>')
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ChartStackedArea(Component):
    """Stacked area chart. Reference: `ChartStackedArea.java`."""

    title: str = ""
    series_names: Tuple[str, ...] = ()
    x: Tuple[float, ...] = ()
    y: Tuple[Tuple[float, ...], ...] = ()     # per-series, same x
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        if not self.x or not self.y:
            return _svg(st, _axes(st, 0, 1, 0, 1, self.title))
        totals = [sum(s[i] for s in self.y) for i in range(len(self.x))]
        xmin, xmax = min(self.x), max(self.x)
        ymax = max(totals) or 1.0
        sx, sy = _scales(st, xmin, xmax, 0.0, ymax)
        parts = _axes(st, xmin, xmax, 0, ymax, self.title)
        base = [0.0] * len(self.x)
        for i, series in enumerate(self.y):
            color = st.series_colors[i % len(st.series_colors)]
            top = [b + v for b, v in zip(base, series)]
            fwd = [f"{sx(a):.1f},{sy(t):.1f}"
                   for a, t in zip(self.x, top)]
            back = [f"{sx(a):.1f},{sy(b):.1f}"
                    for a, b in zip(reversed(self.x), reversed(base))]
            parts.append(f'<polygon points="{" ".join(fwd + back)}" '
                         f'fill="{color}" fill-opacity="0.6"/>')
            base = top
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ChartTimeline(Component):
    """Lane/timeline chart (phase timing). Reference:
    `ChartTimeline.java`."""

    title: str = ""
    lanes: Tuple[str, ...] = ()
    # entries: (lane_index, start, end, label)
    entries: Tuple[Tuple[int, float, float, str], ...] = ()
    style: Style = DEFAULT_STYLE

    def render(self) -> str:
        st = self.style
        if not self.entries:
            return _svg(st, _axes(st, 0, 1, 0, 1, self.title))
        tmin = min(e[1] for e in self.entries)
        tmax = max(e[2] for e in self.entries) or tmin + 1
        n = max(len(self.lanes), 1)
        sx, _ = _scales(st, tmin, tmax, 0, 1)
        lane_h = (st.height - 2 * st.margin) / n
        parts = _axes(st, tmin, tmax, 0, n, self.title)
        for li, start, end, label in self.entries:
            y = st.margin + li * lane_h
            color = st.series_colors[li % len(st.series_colors)]
            parts.append(
                f'<rect x="{sx(start):.1f}" y="{y:.1f}" '
                f'width="{max(sx(end) - sx(start), 1):.1f}" '
                f'height="{lane_h - 4:.1f}" fill="{color}" '
                f'fill-opacity="0.7"><title>{escape(label)}</title></rect>')
        for i, lane in enumerate(self.lanes):
            parts.append(
                f'<text x="4" y="{st.margin + i * lane_h + 12:.1f}" '
                f'font-size="{st.font_size}">{escape(lane)}</text>')
        return _svg(st, parts)


@register_component
@dataclasses.dataclass(frozen=True)
class ComponentTable(Component):
    """Header + rows. Reference: `ComponentTable.java`."""

    title: str = ""
    header: Tuple[str, ...] = ()
    rows: Tuple[Tuple[str, ...], ...] = ()

    def render(self) -> str:
        head = "".join(f"<th>{escape(str(h))}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{escape(str(c))}</td>" for c in row)
            + "</tr>" for row in self.rows)
        cap = (f"<caption style='font-weight:bold;text-align:left'>"
               f"{escape(self.title)}</caption>" if self.title else "")
        return (f"<table class='uic'>{cap}<tr>{head}</tr>{body}</table>")


@register_component
@dataclasses.dataclass(frozen=True)
class ComponentText(Component):
    """Reference: `ComponentText.java`."""

    text: str = ""

    def render(self) -> str:
        return f"<p class='uic'>{escape(self.text)}</p>"


@register_component
@dataclasses.dataclass(frozen=True)
class ComponentDiv(Component):
    """Container of child components. Reference: `ComponentDiv.java`."""

    children: Tuple[Any, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        return {"component_type": "ComponentDiv",
                "children": tuple(
                    c.to_dict() if isinstance(c, Component) else c
                    for c in self.children)}

    def render(self) -> str:
        inner = "".join(
            (c if isinstance(c, Component) else Component.from_dict(c))
            .render() for c in self.children)
        return f"<div class='uic'>{inner}</div>"


@register_component
@dataclasses.dataclass(frozen=True)
class DecoratorAccordion(Component):
    """Collapsible section. Reference: `DecoratorAccordion.java`."""

    title: str = ""
    children: Tuple[Any, ...] = ()
    default_collapsed: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {"component_type": "DecoratorAccordion",
                "title": self.title,
                "default_collapsed": self.default_collapsed,
                "children": tuple(
                    c.to_dict() if isinstance(c, Component) else c
                    for c in self.children)}

    def render(self) -> str:
        inner = "".join(
            (c if isinstance(c, Component) else Component.from_dict(c))
            .render() for c in self.children)
        open_attr = "" if self.default_collapsed else " open"
        return (f"<details class='uic'{open_attr}>"
                f"<summary>{escape(self.title)}</summary>{inner}</details>")


def histogram_component(name: str, hist: Dict[str, Any],
                        style: Style = DEFAULT_STYLE) -> ChartHistogram:
    """Adapter: StatsListener histogram record → ChartHistogram."""
    counts = hist.get("counts", [])
    lo, hi = hist.get("min", 0.0), hist.get("max", 1.0)
    n = len(counts) or 1
    w = (hi - lo) / n
    return ChartHistogram(
        title=name,
        lower_bounds=tuple(lo + i * w for i in range(n)),
        upper_bounds=tuple(lo + (i + 1) * w for i in range(n)),
        counts=tuple(float(c) for c in counts),
        style=style)
