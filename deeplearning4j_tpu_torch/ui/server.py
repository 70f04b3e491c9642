"""Training UI server: overview / model / system dashboards + t-SNE viewer
+ remote stats routing.

Reference parity: `deeplearning4j-play/.../ui/play/PlayUIServer.java` —
`getInstance()` singleton, `attach(statsStorage):254`, remote-listener
endpoint `enableRemoteListener():313`; dashboards served by UIModules:
`ui/module/train/TrainModule.java` (overview score chart, per-layer
param/update charts + histograms + activation charts, system tab) and
`ui/module/tsne/` (t-SNE embedding viewer). Remote side:
`impl/RemoteUIStatsStorageRouter.java:33` (HTTP POST of records) +
`ui/module/remote/RemoteReceiverModule.java`.

The port's copy of `deeplearning4j_tpu/ui/server.py` (it imports
nothing of JAX): every route, the remote receiver and the t-SNE upload
answer as the JAX package's do, over the same storage records.

Design: a dependency-free `http.server` app (the reference embeds a
Play framework app with Scala templates); every chart on every page is a
`ui/components.py` component rendered server-side to inline SVG — the same
reusable JSON components are also served raw under `/train/*` endpoints
for programmatic consumers. The server is read-only over the
`StatsStorage` API, exactly like the reference's UIModule seam.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.ui.client_js import APP_JS
from deeplearning4j_tpu_torch.ui.components import (
    ChartLine, ChartScatter, ComponentDiv, ComponentTable,
    DecoratorAccordion, Style, histogram_component,
)
from deeplearning4j_tpu_torch.ui.storage import (
    Persistable, StatsStorage, StatsStorageRouter,
)

TSNE_TYPE_ID = "Tsne"

_CSS = """
 body{font-family:sans-serif;margin:24px;background:#fafafa}
 h1{font-size:20px} nav a{margin-right:14px;font-size:14px}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:12px;margin-bottom:16px;max-width:980px}
 .meta{color:#666;font-size:13px}
 table.uic{border-collapse:collapse;font-size:13px;margin:8px 0}
 table.uic td,table.uic th{border:1px solid #ddd;padding:4px 8px;
       text-align:right}
 table.uic th:first-child,table.uic td:first-child{text-align:left}
 details.uic{margin:6px 0} details.uic>summary{cursor:pointer;
       font-weight:bold;font-size:14px}
"""


def _page(title: str, body_html: str, page: str = "") -> str:
    """Page shell: server-rendered SVG snapshot inside #live (no-JS
    fallback, refreshed by <noscript> meta), overwritten every 2 s by the
    polling client /js/app.js (reference: the Play UI's flot-based JS
    polling dashboards). Nav chrome is localized through the i18n layer
    (reference: DefaultI18N + train.nav.* resource keys)."""
    from deeplearning4j_tpu_torch.ui.i18n import i18n

    t = i18n().get_message
    langs = "".join(
        f'<a href="/setlang/{code}">{code}</a>'
        for code in i18n().languages())
    nav = (f'<nav><a href="/train/overview.html">'
           f'{t("train.nav.overview")}</a>'
           f'<a href="/train/model.html">{t("train.nav.model")}</a>'
           f'<a href="/train/histogram.html">'
           f'{t("train.nav.histogram")}</a>'
           f'<a href="/train/flow.html">{t("train.nav.flow")}</a>'
           f'<a href="/train/system.html">{t("train.nav.system")}</a>'
           f'<a href="/tsne.html">{t("train.nav.tsne")}</a>'
           f'<a href="/train/activations.html">'
           f'{t("train.nav.activations")}</a>'
           f'<span class=meta> {t("train.nav.language")}: {langs}'
           '</span></nav>')
    return (f"<!doctype html><html><head><meta charset=utf-8>"
            f"<title>{title}</title>"
            f"<style>{_CSS}</style>"
            "<noscript><meta http-equiv=refresh content=5></noscript>"
            f"</head><body data-page=\"{page}\"><h1>{title}</h1>{nav}"
            '<div id=status class=meta></div>'
            f"<div id=live>{body_html}</div>"
            '<script src="/js/app.js"></script></body></html>')


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-ui/2.0"

    def log_message(self, *a):  # silence request logging
        pass

    # --------------------------------------------------------------- GET
    def do_GET(self):
        storage: Optional[StatsStorage] = self.server.ui.storage
        path, _, query = self.path.partition("?")
        path = path.rstrip("/")
        routes = {
            "": lambda: self._send(200, _page(
                "Training overview", self._overview_html(storage),
                "overview"), "text/html"),
            "/train": None, "/train/overview.html": None,
            "/train/overview": lambda: self._send_json(
                self._overview(storage)),
            "/train/model": lambda: self._send_json(
                self._model_data(storage)),
            "/train/model.html": lambda: self._send(200, _page(
                "Model", self._model_html(storage), "model"), "text/html"),
            "/train/model/components": lambda: self._send_json(
                self._model_components(storage).to_dict()),
            "/train/histogram": lambda: self._send_json(
                self._histogram_data(storage)),
            "/train/histogram.html": lambda: self._send(200, _page(
                "Histograms", self._histogram_html(storage), "histogram"),
                "text/html"),
            "/train/flow": lambda: self._send_json(
                self._flow_data(storage)),
            "/train/flow.html": lambda: self._send(200, _page(
                "Network flow", self._flow_html(storage), "flow"),
                "text/html"),
            "/train/updates": lambda: self._send_json(
                self._updates_since(storage, query)),
            "/train/system": lambda: self._send_json(
                self._system_data(storage)),
            "/train/system.html": lambda: self._send(200, _page(
                "System", self._system_html(storage), "system"),
                "text/html"),
            "/train/sessions": lambda: self._send_json(
                {"sessions":
                 storage.list_session_ids() if storage else []}),
            "/tsne": lambda: self._send_json(self._tsne_data(storage)),
            "/tsne.html": lambda: self._send(200, _page(
                "t-SNE", self._tsne_html(storage), "tsne"), "text/html"),
            "/js/app.js": lambda: self._send(
                200, APP_JS, "text/javascript"),
            # reference: ConvolutionalListenerModule routes /activations
            # (page) + /activations/data (latest rendered image)
            "/train/activations.html": lambda: self._send(
                200, self._activations_html(), "text/html"),
            "/train/activations": lambda: self._send(
                200, self._activations_html(), "text/html"),
            "/train/activations/data": lambda: self._send(
                200, self._activations_png(storage), "image/png"),
            "/lang": lambda: self._send_json(self._lang_data()),
        }
        if path.startswith("/setlang/"):
            return self._set_lang(path.rsplit("/", 1)[1])
        fn = routes.get(path, routes[""] if path == "/" else None)
        if fn is None and path in routes:   # aliases to overview page
            fn = routes[""]
        if fn is None:
            return self._send(404, "not found", "text/plain")
        return fn()

    # ------------------------------------------- conv activations + i18n
    def _activations_png(self, storage) -> bytes:
        from deeplearning4j_tpu_torch.ui.convolutional import (
            empty_png, latest_activation_png,
        )

        if storage is None:
            return empty_png()
        return latest_activation_png(storage)

    def _activations_html(self) -> str:
        from deeplearning4j_tpu_torch.ui.i18n import i18n

        title = i18n().get_message("train.activations.title")
        body = ('<img id=actimg src="/train/activations/data" '
                'alt="conv activations" '
                'style="image-rendering:pixelated;min-width:256px">'
                "<script>setInterval(function(){"
                "document.getElementById('actimg').src="
                "'/train/activations/data?t='+Date.now();},2000);"
                "</script>")
        return _page(title, body, "activations")

    def _lang_data(self):
        from deeplearning4j_tpu_torch.ui.i18n import i18n

        return {"current": i18n().get_default_language(),
                "available": i18n().languages()}

    def _set_lang(self, code: str):
        from deeplearning4j_tpu_torch.ui.i18n import i18n

        if code in i18n().languages():
            i18n().set_default_language(code)
        self.send_response(302)
        self.send_header("Location", "/train/overview.html")
        self.end_headers()

    # ----------------------------------------------------- data assembly
    def _updates(self, storage) -> List[Persistable]:
        """All StatsListener updates of the latest session, time-ordered
        (multi-worker records interleave, like the reference's train
        module merging worker streams)."""
        if storage is None:
            return []
        sids = [s for s in storage.list_session_ids()]
        stats_sids = [
            s for s in sids if "StatsListener" in storage.list_type_ids(s)]
        if not stats_sids:
            return []
        sid = stats_sids[-1]
        ups: List[Persistable] = []
        for wid in storage.list_worker_ids(sid, "StatsListener"):
            ups.extend(storage.get_all_updates(sid, "StatsListener", wid))
        ups.sort(key=lambda u: u.timestamp)
        return ups

    def _static(self, storage) -> Dict[str, Any]:
        if storage is None:
            return {}
        # image-typed records (ConvolutionalListener) also live in static
        # storage; the dashboards' metadata must come from a model-info
        # record, so prefer StatsListener and fall back to anything else
        for only_stats in (True, False):
            for sid in reversed(storage.list_session_ids()):
                for tid in storage.list_type_ids(sid):
                    if only_stats != (tid == "StatsListener"):
                        continue
                    for wid in storage.list_worker_ids(sid, tid):
                        st = storage.get_static_info(sid, tid, wid)
                        if st:
                            return st.content
        return {}

    def _overview(self, storage):
        ups = self._updates(storage)
        out: Dict[str, Any] = {"iterations": [], "scores": []}
        for u in ups:
            if "score" in u.content:
                out["iterations"].append(u.content.get("iteration"))
                out["scores"].append(u.content["score"])
        if ups:
            last = ups[-1].content
            out["param_stats"] = last.get("param_stats")
            out["update_stats"] = last.get("update_stats")
            out["minibatches_per_second"] = last.get(
                "minibatches_per_second")
            out["memory_rss_mb"] = last.get("memory_rss_mb")
        st = self._static(storage)
        if st:
            out["static"] = {
                "model_class": st.get("model_class"),
                "num_params": st.get("num_params"),
                "backend": (st.get("software") or {}).get("backend"),
            }
        return out

    def _model_data(self, storage):
        """Per-layer norm timelines + ratio + histograms + activations —
        the TrainModule 'model' tab payload."""
        ups = self._updates(storage)
        layers: Dict[str, Dict[str, list]] = {}
        activations: Dict[str, Dict[str, list]] = {}
        histograms: Dict[str, Any] = {}
        update_hist: Dict[str, Any] = {}
        for u in ups:
            c = u.content
            it = c.get("iteration")
            for name, st in (c.get("param_stats") or {}).items():
                d = layers.setdefault(name, {
                    "iterations": [], "param_norm": [], "mean_magnitude": [],
                    "update_norm": [], "ratio": []})
                d["iterations"].append(it)
                d["param_norm"].append(st.get("norm2"))
                d["mean_magnitude"].append(st.get("mean_magnitude"))
                ust = (c.get("update_stats") or {}).get(name) or {}
                un = ust.get("norm2")
                d["update_norm"].append(un)
                pn = st.get("norm2") or 0.0
                d["ratio"].append(
                    (un / pn) if (un is not None and pn > 0) else None)
            for name, st in (c.get("activation_stats") or {}).items():
                d = activations.setdefault(name, {
                    "iterations": [], "mean": [], "std": [],
                    "mean_magnitude": []})
                d["iterations"].append(it)
                for k in ("mean", "std", "mean_magnitude"):
                    d[k].append(st.get(k))
            if c.get("param_histograms"):
                histograms = c["param_histograms"]   # keep latest
            if c.get("update_histograms"):
                update_hist = c["update_histograms"]
        return {"layers": layers, "activations": activations,
                "param_histograms": histograms,
                "update_histograms": update_hist}

    def _updates_since(self, storage, query: str):
        """Incremental polling endpoint: records newer than ?since=<ts>
        (epoch seconds). The delta contract for programmatic clients —
        the page client re-reads aggregates instead, but this endpoint
        lets a tool tail a run without re-downloading history."""
        since = 0.0
        for part in query.split("&"):
            if part.startswith("since="):
                try:
                    since = float(part[6:])
                except ValueError:  # a malformed since= falls back to
                    pass            # the full history
        # one collection path for first and incremental polls, so the
        # session scope never shifts between them (the latest session,
        # via _updates) — a per-timestamp storage index can slot in here
        # if linear rescans ever show up in profiles
        ups = [u for u in self._updates(storage) if u.timestamp > since]
        # At-least-once contract: the cursor trails the max delivered
        # record timestamp by a grace window, because listeners stamp
        # BEFORE storing (tens of ms of histogram building) and multiple
        # workers' stamps interleave — a strict max cursor would skip a
        # record stamped before the poll but stored after it. Clients
        # dedup by (worker_id, timestamp); records inside the window are
        # re-delivered, never lost.
        grace = 1.0
        now = max((u.timestamp for u in ups), default=since + grace) - grace
        now = max(now, since)    # cursor never moves backwards
        return {"now": now,
                "records": [{"timestamp": u.timestamp,
                             "worker_id": u.worker_id,
                             "content": u.content} for u in ups]}

    def _histogram_data(self, storage):
        """Latest param/update histograms — the HistogramModule payload
        (reference: `ui/module/histogram/HistogramModule.java`)."""
        ups = self._updates(storage)
        out = {"iteration": None, "param_histograms": {},
               "update_histograms": {}}
        for u in ups:    # keep the LATEST report carrying histograms
            c = u.content
            if c.get("param_histograms") or c.get("update_histograms"):
                out["iteration"] = c.get("iteration")
                out["param_histograms"] = c.get("param_histograms") or {}
                out["update_histograms"] = c.get("update_histograms") or {}
        return out

    def _flow_data(self, storage):
        """Network topology + latest activation stats — the flow-module
        payload (reference: `ui/module/flow/FlowIterationListener` network
        structure + per-layer activations). Nodes/edges come from the
        static report's config_json (MLN: layer chain; CG: vertex DAG)."""
        st = self._static(storage)
        nodes, edges = [], []
        cj = st.get("config_json")
        if cj:
            try:
                conf = json.loads(cj)
            except (json.JSONDecodeError, TypeError):
                conf = {}
            if "vertices" in conf:              # ComputationGraph
                for name in conf.get("network_inputs", []):
                    nodes.append({"name": name, "type": "Input"})
                order = conf.get("topological_order") or \
                    list(conf["vertices"])
                for name in order:
                    v = conf["vertices"].get(name) or {}
                    ltype = ((v.get("layer") or {}).get("@class")
                             or v.get("@class") or "?")
                    nodes.append({"name": name, "type": ltype})
                for name, ins in (conf.get("vertex_inputs") or {}).items():
                    for src in ins:
                        edges.append([src, name])
            elif "layers" in conf:              # MultiLayerNetwork chain
                nodes.append({"name": "input", "type": "Input"})
                prev = "input"
                for layer in conf["layers"]:
                    name = layer.get("name") or layer.get("@class")
                    nodes.append({"name": name,
                                  "type": layer.get("@class", "?")})
                    edges.append([prev, name])
                    prev = name
        acts, param_stats = {}, {}
        ups = self._updates(storage)
        for u in ups:
            if u.content.get("activation_stats"):
                acts = u.content["activation_stats"]
            if u.content.get("param_stats"):
                param_stats = u.content["param_stats"]
        return {"nodes": nodes, "edges": edges, "activations": acts,
                "param_stats": param_stats}

    def _flow_html(self, storage) -> str:
        """Server-side flow snapshot (no-JS fallback; the JS client
        replaces it with the heat-colored diagram)."""
        d = self._flow_data(storage)
        if not d["nodes"]:
            return "<div class=card>no network structure yet</div>"
        acts = d["activations"]
        rows = []
        for nd in d["nodes"]:
            a = acts.get(nd["name"]) or {}
            rows.append((nd["name"], nd["type"],
                         f"{a.get('mean', 0):.4g}" if a else "-",
                         f"{a.get('std', 0):.4g}" if a else "-"))
        from html import escape

        tbl = ComponentTable(
            title="Network flow (layers in forward order)",
            header=("layer", "type", "act mean", "act std"),
            rows=tuple(rows)).render()
        edges = ", ".join(
            f"{escape(a)}→{escape(b)}" for a, b in d["edges"])
        return (f"<div class=card>{tbl}"
                f"<div class=meta>edges: {edges}</div></div>")

    def _histogram_html(self, storage) -> str:
        d = self._histogram_data(storage)
        parts = []
        for kind, label in (("param_histograms", "parameters"),
                            ("update_histograms", "updates")):
            comps = [histogram_component(f"{n} ({label})", h)
                     for n, h in (d[kind] or {}).items()]
            if comps:
                parts.append(ComponentDiv(children=tuple(comps)).render())
        if not parts:
            return ("<div class=card>no histograms — construct "
                    "StatsListener(collect_histograms=True)</div>")
        return "<div class=card>" + "</div><div class=card>".join(parts) \
            + "</div>"

    def _system_data(self, storage):
        ups = self._updates(storage)
        out = {"iterations": [], "memory_rss_mb": [],
               "minibatches_per_second": [], "static": self._static(storage)}
        for u in ups:
            c = u.content
            out["iterations"].append(c.get("iteration"))
            out["memory_rss_mb"].append(c.get("memory_rss_mb"))
            out["minibatches_per_second"].append(
                c.get("minibatches_per_second"))
        return out

    def _tsne_data(self, storage):
        if storage is None:
            return {"x": [], "y": [], "labels": []}
        for sid in reversed(storage.list_session_ids()):
            if TSNE_TYPE_ID not in storage.list_type_ids(sid):
                continue
            for wid in storage.list_worker_ids(sid, TSNE_TYPE_ID):
                ups = storage.get_all_updates(sid, TSNE_TYPE_ID, wid)
                if ups:
                    return ups[-1].content
        return {"x": [], "y": [], "labels": []}

    # ------------------------------------------------- component building
    def _model_components(self, storage) -> ComponentDiv:
        """The model tab as a reusable component tree (this JSON is served
        at /train/model/components — the ui-components contract)."""
        data = self._model_data(storage)
        sections = []
        for name, d in data["layers"].items():
            charts: List[Any] = [ChartLine(
                title=f"{name}: norms",
                series_names=("param norm2", "update norm2"),
                x=(tuple(d["iterations"]), tuple(d["iterations"])),
                y=(tuple(v or 0.0 for v in d["param_norm"]),
                   tuple(v or 0.0 for v in d["update_norm"])))]
            ratios = [v for v in d["ratio"] if v is not None]
            if ratios:
                its = [i for i, v in zip(d["iterations"], d["ratio"])
                       if v is not None]
                charts.append(ChartLine(
                    title=f"{name}: update/param ratio",
                    series_names=("ratio",),
                    x=(tuple(its),), y=(tuple(ratios),)))
            if name in data["param_histograms"]:
                charts.append(histogram_component(
                    f"{name}: parameter histogram",
                    data["param_histograms"][name]))
            sections.append(DecoratorAccordion(
                title=name, children=tuple(charts),
                default_collapsed=True))
        for name, d in data["activations"].items():
            sections.append(DecoratorAccordion(
                title=f"activations: {name}", default_collapsed=True,
                children=(ChartLine(
                    title=f"{name}: activation mean / std",
                    series_names=("mean", "std"),
                    x=(tuple(d["iterations"]), tuple(d["iterations"])),
                    y=(tuple(v or 0.0 for v in d["mean"]),
                       tuple(v or 0.0 for v in d["std"]))),)))
        return ComponentDiv(children=tuple(sections))

    # ------------------------------------------------------------- pages
    def _overview_html(self, storage) -> str:
        o = self._overview(storage)
        parts = []
        if o["iterations"]:
            parts.append(ChartLine(
                title="Score vs iteration", series_names=("score",),
                x=(tuple(o["iterations"]),), y=(tuple(o["scores"]),),
                style=Style(width=920)).render())
        rows = []
        for k, v in (o.get("param_stats") or {}).items():
            u = (o.get("update_stats") or {}).get(k) or {}
            rows.append((k, f"{v.get('norm2', 0):.5g}",
                         f"{v.get('mean_magnitude', 0):.5g}",
                         f"{u.get('norm2', 0):.5g}" if u else "-"))
        parts.append(ComponentTable(
            title="Parameters (last report)",
            header=("parameter", "norm2", "mean magnitude", "update norm2"),
            rows=tuple(rows)).render())
        st = o.get("static") or {}
        mbs = o.get("minibatches_per_second")
        parts.append(
            f"<div class=meta>{len(o['iterations'])} reports; "
            f"{(mbs or 0):.2f} minibatches/s; "
            f"model {st.get('model_class', '-')}, "
            f"{st.get('num_params', '-')} params, "
            f"backend {st.get('backend', '-')}</div>")
        return "<div class=card>" + "</div><div class=card>".join(parts) + \
            "</div>"

    def _model_html(self, storage) -> str:
        comp = self._model_components(storage)
        if not comp.children:
            return "<div class=card>no model reports yet</div>"
        return f"<div class=card>{comp.render()}</div>"

    def _system_html(self, storage) -> str:
        d = self._system_data(storage)
        parts = []
        its = [i for i in d["iterations"] if i is not None]
        mem = [m or 0.0 for m in d["memory_rss_mb"]]
        if its and mem:
            parts.append(ChartLine(
                title="Host RSS (MB)", series_names=("rss_mb",),
                x=(tuple(its),), y=(tuple(mem),),
                style=Style(width=920)).render())
        rate = [r for r in d["minibatches_per_second"] if r is not None]
        if rate:
            parts.append(ChartLine(
                title="Minibatches / second",
                series_names=("mb/s",),
                x=(tuple(range(len(rate))),), y=(tuple(rate),),
                style=Style(width=920)).render())
        st = d.get("static") or {}
        rows = [("software", json.dumps(st.get("software") or {})),
                ("hardware", json.dumps(st.get("hardware") or {})),
                ("model", str(st.get("model_class")))]
        parts.append(ComponentTable(
            title="Environment", header=("key", "value"),
            rows=tuple(rows)).render())
        return "<div class=card>" + "</div><div class=card>".join(parts) + \
            "</div>"

    def _tsne_html(self, storage) -> str:
        d = self._tsne_data(storage)
        if not d.get("x"):
            return ("<div class=card>no embedding uploaded — use "
                    "UIServer.upload_tsne(points, labels)</div>")
        labels = d.get("labels") or [0] * len(d["x"])
        by_label: Dict[Any, list] = {}
        for x, y, l in zip(d["x"], d["y"], labels):
            by_label.setdefault(l, []).append((x, y))
        names, xs, ys = [], [], []
        for l, pts in sorted(by_label.items(), key=lambda kv: str(kv[0])):
            names.append(str(l))
            xs.append(tuple(p[0] for p in pts))
            ys.append(tuple(p[1] for p in pts))
        chart = ChartScatter(
            title="t-SNE embedding", series_names=tuple(names),
            x=tuple(xs), y=tuple(ys), style=Style(width=920, height=560))
        return f"<div class=card>{chart.render()}</div>"

    # --------------------------------------------------------------- POST
    def do_POST(self):
        """Remote-listener receiver + t-SNE upload. Reference:
        `RemoteReceiverModule.java` paired with PlayUIServer
        `enableRemoteListener():313`; tsne upload mirrors the reference
        tsne module's coordinate upload."""
        ui = self.server.ui
        path = self.path.rstrip("/")
        n = int(self.headers.get("Content-Length", 0))
        if path == "/tsne":
            # write path: gated like /remote (local callers use the
            # UIServer.upload_tsne API directly)
            if not ui.remote_enabled:
                return self._send(404, "remote receiver not enabled",
                                  "text/plain")
            try:
                body = json.loads(self.rfile.read(n))
                pts = list(zip(body["x"], body["y"]))
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                return self._send(400, f"bad tsne payload: {e}",
                                  "text/plain")
            ui.upload_tsne(pts, body.get("labels"))
            return self._send_json({"ok": True})
        if path != "/remote" or not ui.remote_enabled:
            return self._send(404, "remote receiver not enabled",
                              "text/plain")
        body = json.loads(self.rfile.read(n))
        rec = Persistable(**body["record"])
        if ui.storage is not None:
            if body.get("kind") == "static":
                ui.storage.put_static_info(rec)
            else:
                ui.storage.put_update(rec)
        self._send_json({"ok": True})

    # ------------------------------------------------------------ helpers
    def _send(self, code, body, ctype):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        if ctype.startswith("text/") and "charset" not in ctype:
            ctype += "; charset=utf-8"
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, obj):
        self._send(200, json.dumps(obj), "application/json")


class UIServer:
    """Reference: `PlayUIServer` — `getInstance()`, `attach(storage)`,
    `enableRemoteListener()`. Port 0 picks a free port (the reference
    defaults to 9000 via the ui.port property)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 0):
        self.storage: Optional[StatsStorage] = None
        self.remote_enabled = False
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.ui = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 0) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port)
        return cls._instance

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def attach(self, storage: StatsStorage) -> None:
        self.storage = storage

    def detach(self, storage: StatsStorage) -> None:
        if self.storage is storage:
            self.storage = None

    def enable_remote_listener(self) -> None:
        self.remote_enabled = True
        if self.storage is None:
            self.storage = StatsStorage()

    def upload_tsne(self, points, labels=None,
                    session_id: str = "tsne") -> None:
        """Publish a 2-D embedding to the t-SNE viewer (reference:
        `ui/module/tsne/` coordinate upload). `points`: [N, 2] array or
        list of (x, y); `labels`: optional per-point labels for coloring."""
        if self.storage is None:
            self.storage = StatsStorage()
        pts = [(float(p[0]), float(p[1])) for p in points]
        content = {"x": [p[0] for p in pts], "y": [p[1] for p in pts],
                   "labels": (None if labels is None
                              else [str(l) for l in labels])}
        self.storage.put_update(Persistable(
            session_id, TSNE_TYPE_ID, "tsne", time.time(), content))

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if UIServer._instance is self:
            UIServer._instance = None


class RemoteStatsRouter(StatsStorageRouter):
    """HTTP-POST router to a remote UIServer. Reference:
    `impl/RemoteUIStatsStorageRouter.java:33` (posts records, silently
    retries/drops on failure so training never blocks on the UI)."""

    def __init__(self, url: str, *, timeout: float = 2.0,
                 raise_on_error: bool = False):
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self.raise_on_error = raise_on_error

    def _post(self, kind: str, record: Persistable) -> None:
        import dataclasses as dc
        body = json.dumps({"kind": kind,
                           "record": dc.asdict(record)}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=self.timeout).read()
        except Exception:
            if self.raise_on_error:
                raise

    def put_static_info(self, record: Persistable) -> None:
        self._post("static", record)

    def put_update(self, record: Persistable) -> None:
        self._post("update", record)
