"""JSON-serializable UI components rendered server-side (port of
``deeplearning4j_tpu/ui/components.py``).

The equivalent of the reference's ``deeplearning4j-ui-components`` module:
a small component model (charts, tables, text, containers) that (a)
round-trips through JSON, as the reference's Jackson polymorphic typing
does, and (b) renders to a self-contained HTML/SVG string with no external
asset (the rendering the reference's ``TestRendering.java`` writes to an
HTML file).  Pure Python, no tensor: the JSON and the HTML are the JAX
package's string for string, so either package loads the other's JSON.

Components: :class:`ChartLine`, :class:`ChartScatter`,
:class:`ChartHistogram`, :class:`ComponentTable`, :class:`ComponentText`,
:class:`ComponentDiv`; styles: :class:`StyleChart`, :class:`StyleTable`,
:class:`StyleText`.
"""

from __future__ import annotations

import dataclasses
import html
import json
from typing import Dict, List, Optional, Sequence, Tuple, Type

_PALETTE = ["#1976d2", "#d32f2f", "#388e3c", "#f57c00", "#7b1fa2",
            "#0097a7", "#5d4037", "#455a64"]

_REGISTRY: Dict[str, Type["Component"]] = {}


def _register(cls: Type["Component"]) -> Type["Component"]:
    _REGISTRY[cls.__name__] = cls
    return cls


# ------------------------------------------------------------------- styles
@dataclasses.dataclass
class StyleChart:
    """Chart sizing/colors (reference ``StyleChart``)."""

    width: int = 640
    height: int = 240
    series_colors: Sequence[str] = tuple(_PALETTE)
    title_size: int = 13
    axis_size: int = 10


@dataclasses.dataclass
class StyleTable:
    """Table borders/colors (reference ``StyleTable``)."""

    border_width: int = 1
    header_color: str = "#eeeeee"
    background_color: str = "#ffffff"


@dataclasses.dataclass
class StyleText:
    """Text font/color (reference ``StyleText``)."""

    font_size: int = 12
    color: str = "#000000"
    bold: bool = False


def _style_to_dict(style) -> Optional[dict]:
    if style is None:
        return None
    d = dataclasses.asdict(style)
    d["_style"] = type(style).__name__
    return d


def _style_from_dict(d: Optional[dict]):
    if d is None:
        return None
    d = dict(d)
    name = d.pop("_style")
    cls = {"StyleChart": StyleChart, "StyleTable": StyleTable,
           "StyleText": StyleText}[name]
    if "series_colors" in d:
        d["series_colors"] = tuple(d["series_colors"])
    return cls(**d)


# ---------------------------------------------------------------- component
class Component:
    """Base component (reference ``api/Component.java``): polymorphic JSON
    via a ``component_type`` discriminator + server-side HTML render."""

    def to_dict(self) -> dict:
        raise NotImplementedError

    def render_html(self) -> str:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        cls = _REGISTRY.get(d.get("component_type", ""))
        if cls is None:
            raise ValueError(
                f"Unknown component type {d.get('component_type')!r}")
        return cls._from_dict(d)

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))


def _axes_transform(xs: List[float], ys: List[float], style: StyleChart):
    W, H = style.width, style.height
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1e-9

    def X(v):
        return 45 + (W - 55) * (v - x0) / (x1 - x0)

    def Y(v):
        return H - 22 - (H - 40) * (v - y0) / (y1 - y0)

    return X, Y, (x0, x1, y0, y1)


def _chart_frame(title: str, style: StyleChart, bounds, body: str) -> str:
    x0, x1, y0, y1 = bounds
    W, H = style.width, style.height
    return (
        f'<svg width="{W}" height="{H}" style="background:#fff;'
        f'border:1px solid #ddd">'
        f'<text x="6" y="{style.title_size + 2}" '
        f'font-size="{style.title_size}">{html.escape(title)}</text>'
        f'{body}'
        f'<text x="2" y="{H - 6}" font-size="{style.axis_size}">'
        f'{y0:.4g} .. {y1:.4g}</text>'
        f'<text x="{W - 110}" y="{H - 6}" font-size="{style.axis_size}">'
        f'x: {x0:.4g} .. {x1:.4g}</text></svg>')


@_register
class ChartLine(Component):
    """Multi-series line chart (reference ``chart/ChartLine``)."""

    def __init__(self, title: str = "",
                 style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError("x and y must have equal length")
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def to_dict(self) -> dict:
        return {"component_type": "ChartLine", "title": self.title,
                "style": _style_to_dict(self.style),
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    @classmethod
    def _from_dict(cls, d: dict) -> "ChartLine":
        c = cls(d["title"], _style_from_dict(d["style"]))
        for s in d["series"]:
            c.add_series(s["name"], s["x"], s["y"])
        return c

    def render_html(self) -> str:
        if not any(s[1] for s in self.series):
            return _chart_frame(self.title, self.style, (0, 1, 0, 1), "")
        xs = [v for _, x, _ in self.series for v in x]
        ys = [v for _, _, y in self.series for v in y]
        X, Y, bounds = _axes_transform(xs, ys, self.style)
        paths = []
        for i, (name, x, y) in enumerate(self.series):
            color = self.style.series_colors[
                i % len(self.style.series_colors)]
            d = " ".join(f"{'M' if j == 0 else 'L'}{X(a):.1f},{Y(b):.1f}"
                         for j, (a, b) in enumerate(zip(x, y)))
            paths.append(f'<path d="{d}" fill="none" stroke="{color}"/>')
            paths.append(
                f'<text x="{self.style.width - 100}" '
                f'y="{18 + 12 * i}" font-size="10" fill="{color}">'
                f'{html.escape(name)}</text>')
        return _chart_frame(self.title, self.style, bounds, "".join(paths))


@_register
class ChartScatter(ChartLine):
    """Scatter chart (reference ``chart/ChartScatter``): ChartLine's data
    model with point marks instead of a path."""

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["component_type"] = "ChartScatter"
        return d

    def render_html(self) -> str:
        if not any(s[1] for s in self.series):
            return _chart_frame(self.title, self.style, (0, 1, 0, 1), "")
        xs = [v for _, x, _ in self.series for v in x]
        ys = [v for _, _, y in self.series for v in y]
        X, Y, bounds = _axes_transform(xs, ys, self.style)
        dots = []
        for i, (name, x, y) in enumerate(self.series):
            color = self.style.series_colors[
                i % len(self.style.series_colors)]
            dots.extend(
                f'<circle cx="{X(a):.1f}" cy="{Y(b):.1f}" r="2.5" '
                f'fill="{color}"/>' for a, b in zip(x, y))
            dots.append(
                f'<text x="{self.style.width - 100}" y="{18 + 12 * i}" '
                f'font-size="10" fill="{color}">{html.escape(name)}</text>')
        return _chart_frame(self.title, self.style, bounds, "".join(dots))


@_register
class ChartHistogram(Component):
    """Histogram chart (reference ``chart/ChartHistogram``): explicit bin
    edges + counts."""

    def __init__(self, title: str = "",
                 style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.bins: List[Tuple[float, float, float]] = []  # (lo, hi, count)

    def add_bin(self, low: float, high: float,
                count: float) -> "ChartHistogram":
        self.bins.append((float(low), float(high), float(count)))
        return self

    def to_dict(self) -> dict:
        return {"component_type": "ChartHistogram", "title": self.title,
                "style": _style_to_dict(self.style),
                "bins": [list(b) for b in self.bins]}

    @classmethod
    def _from_dict(cls, d: dict) -> "ChartHistogram":
        c = cls(d["title"], _style_from_dict(d["style"]))
        for lo, hi, n in d["bins"]:
            c.add_bin(lo, hi, n)
        return c

    def render_html(self) -> str:
        if not self.bins:
            return _chart_frame(self.title, self.style, (0, 1, 0, 1), "")
        xs = [b[0] for b in self.bins] + [b[1] for b in self.bins]
        ys = [0.0] + [b[2] for b in self.bins]
        X, Y, bounds = _axes_transform(xs, ys, self.style)
        color = self.style.series_colors[0]
        rects = []
        for lo, hi, n in self.bins:
            x, w = X(lo), max(X(hi) - X(lo) - 1, 1)
            y = Y(n)
            h = max(Y(0) - y, 0)
            rects.append(f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
                         f'height="{h:.1f}" fill="{color}" '
                         f'fill-opacity="0.7"/>')
        return _chart_frame(self.title, self.style, bounds, "".join(rects))


@_register
class ComponentTable(Component):
    """Header + rows table (reference ``table/ComponentTable``)."""

    def __init__(self, header: Sequence[str] = (),
                 rows: Sequence[Sequence] = (),
                 style: Optional[StyleTable] = None):
        self.header = list(header)
        self.rows = [list(r) for r in rows]
        self.style = style or StyleTable()

    def to_dict(self) -> dict:
        return {"component_type": "ComponentTable", "header": self.header,
                "rows": [[str(c) for c in r] for r in self.rows],
                "style": _style_to_dict(self.style)}

    @classmethod
    def _from_dict(cls, d: dict) -> "ComponentTable":
        return cls(d["header"], d["rows"], _style_from_dict(d["style"]))

    def render_html(self) -> str:
        s = self.style
        css = (f'border-collapse:collapse;background:{s.background_color}')
        cell = f'border:{s.border_width}px solid #ccc;padding:3px 8px;' \
               f'font-size:0.85em'
        head = "".join(
            f'<th style="{cell};background:{s.header_color}">'
            f'{html.escape(str(h))}</th>' for h in self.header)
        body = "".join(
            "<tr>" + "".join(f'<td style="{cell}">{html.escape(str(c))}'
                             f'</td>' for c in row) + "</tr>"
            for row in self.rows)
        return f'<table style="{css}"><tr>{head}</tr>{body}</table>'


@_register
class ComponentText(Component):
    """Styled text block (reference ``text/ComponentText``)."""

    def __init__(self, text: str = "", style: Optional[StyleText] = None):
        self.text = text
        self.style = style or StyleText()

    def to_dict(self) -> dict:
        return {"component_type": "ComponentText", "text": self.text,
                "style": _style_to_dict(self.style)}

    @classmethod
    def _from_dict(cls, d: dict) -> "ComponentText":
        return cls(d["text"], _style_from_dict(d["style"]))

    def render_html(self) -> str:
        s = self.style
        weight = "bold" if s.bold else "normal"
        return (f'<div style="font-size:{s.font_size}px;color:{s.color};'
                f'font-weight:{weight}">{html.escape(self.text)}</div>')


@_register
class ComponentDiv(Component):
    """Container of child components (reference ``component/ComponentDiv``)."""

    def __init__(self, children: Sequence[Component] = ()):
        self.children = list(children)

    def add(self, child: Component) -> "ComponentDiv":
        self.children.append(child)
        return self

    def to_dict(self) -> dict:
        return {"component_type": "ComponentDiv",
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_dict(cls, d: dict) -> "ComponentDiv":
        return cls([Component.from_dict(c) for c in d["children"]])

    def render_html(self) -> str:
        inner = "".join(f'<div style="margin-bottom:1em">'
                        f'{c.render_html()}</div>' for c in self.children)
        return f"<div>{inner}</div>"


# ------------------------------------------------------------------- pages
def render_page(components: Sequence[Component],
                title: str = "DL4J-TPU components") -> str:
    """Self-contained HTML page from components (the reference
    ``TestRendering`` output shape)."""
    body = "".join(f'<div style="margin-bottom:1.2em">'
                   f'{c.render_html()}</div>' for c in components)
    return (f"<!DOCTYPE html><html><head><title>{html.escape(title)}"
            f"</title></head><body style=\"font-family:sans-serif;"
            f"margin:1.5em;background:#fafafa\">{body}</body></html>")


def render_to_file(components: Sequence[Component], path: str,
                   title: str = "DL4J-TPU components") -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_page(components, title))
    return path
