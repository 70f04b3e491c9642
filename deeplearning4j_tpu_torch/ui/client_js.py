"""Browser polling client for the training UI — served at /js/app.js.

A copy of `deeplearning4j_tpu/ui/client_js.py`, which imports
nothing of JAX: the port keeps its own.

Reference parity: the Play UI's dashboards poll JSON endpoints from
JavaScript and redraw without page reloads
(`deeplearning4j-play/src/main/resources/.../js/train/overview.js`,
`.../module/histogram/`, `.../module/flow/` — charting via jquery/flot).
TPU redesign: one dependency-free script; charts are generated as SVG
strings from the same JSON the server exposes under /train/*, so a page
left open live-follows a training run. Each HTML page carries
`<body data-page=...>`; the script polls the page's endpoint every 2 s
and swaps the #live container.
"""

APP_JS = r"""
"use strict";
(function () {
  var PAGE = document.body.dataset.page || "";
  var INTERVAL = 2000;
  var COLORS = ["#1976d2", "#e53935", "#43a047", "#fb8c00", "#8e24aa",
                "#00897b", "#6d4c41"];

  function esc(s) {
    return String(s).replace(/[&<>"]/g, function (c) {
      return {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}[c];
    });
  }

  function finitePairs(xs, ys) {
    var out = [];
    for (var i = 0; i < ys.length; i++) {
      var x = xs[i], y = ys[i];
      if (x == null || y == null || !isFinite(x) || !isFinite(y)) continue;
      out.push([x, y]);
    }
    return out;
  }

  function lineChart(title, names, xss, yss, w, h) {
    w = w || 900; h = h || 220;
    var xmin = Infinity, xmax = -Infinity, ymin = Infinity, ymax = -Infinity;
    var series = [];
    for (var s = 0; s < yss.length; s++) {
      var pts = finitePairs(xss[s], yss[s]);
      series.push(pts);
      for (var i = 0; i < pts.length; i++) {
        xmin = Math.min(xmin, pts[i][0]); xmax = Math.max(xmax, pts[i][0]);
        ymin = Math.min(ymin, pts[i][1]); ymax = Math.max(ymax, pts[i][1]);
      }
    }
    if (xmin === Infinity) return "";
    if (xmax === xmin) xmax = xmin + 1;
    if (ymax === ymin) ymax = ymin + 1;
    var L = 58, R = 12, T = 26, B = 24, iw = w - L - R, ih = h - T - B;
    var X = function (x) { return L + (x - xmin) / (xmax - xmin) * iw; };
    var Y = function (y) { return T + ih - (y - ymin) / (ymax - ymin) * ih; };
    var o = '<svg width="' + w + '" height="' + h +
            '" xmlns="http://www.w3.org/2000/svg">';
    o += '<text x="' + (w / 2) + '" y="15" text-anchor="middle"' +
         ' font-size="13" font-weight="bold">' + esc(title) + "</text>";
    var i, v;
    for (i = 0; i <= 4; i++) {
      v = ymin + (ymax - ymin) * i / 4;
      o += '<line x1="' + L + '" y1="' + Y(v) + '" x2="' + (L + iw) +
           '" y2="' + Y(v) + '" stroke="#eee"/>';
      o += '<text x="' + (L - 5) + '" y="' + (Y(v) + 4) +
           '" text-anchor="end" font-size="10" fill="#666">' +
           v.toPrecision(3) + "</text>";
    }
    for (i = 0; i <= 4; i++) {
      v = xmin + (xmax - xmin) * i / 4;
      o += '<text x="' + X(v) + '" y="' + (T + ih + 15) +
           '" text-anchor="middle" font-size="10" fill="#666">' +
           v.toPrecision(3) + "</text>";
    }
    o += '<line x1="' + L + '" y1="' + T + '" x2="' + L + '" y2="' +
         (T + ih) + '" stroke="#999"/>';
    o += '<line x1="' + L + '" y1="' + (T + ih) + '" x2="' + (L + iw) +
         '" y2="' + (T + ih) + '" stroke="#999"/>';
    for (s = 0; s < series.length; s++) {
      var p = series[s].map(function (q) {
        return X(q[0]).toFixed(1) + "," + Y(q[1]).toFixed(1);
      }).join(" ");
      var col = COLORS[s % COLORS.length];
      o += '<polyline fill="none" stroke="' + col +
           '" stroke-width="1.5" points="' + p + '"/>';
      o += '<rect x="' + (L + 8 + s * 150) + '" y="' + (T - 16) +
           '" width="10" height="10" fill="' + col + '"/>' +
           '<text x="' + (L + 21 + s * 150) + '" y="' + (T - 7) +
           '" font-size="11">' + esc(names[s]) + "</text>";
    }
    return o + "</svg>";
  }

  function histChart(title, hist, w, h) {
    w = w || 430; h = h || 170;
    if (!hist || !hist.counts || !hist.counts.length) return "";
    var counts = hist.counts;
    var L = 40, R = 8, T = 24, B = 20, iw = w - L - R, ih = h - T - B;
    var cmax = Math.max.apply(null, counts) || 1;
    var n = counts.length, bw = iw / n;
    var o = '<svg width="' + w + '" height="' + h +
            '" xmlns="http://www.w3.org/2000/svg">';
    o += '<text x="' + (w / 2) + '" y="14" text-anchor="middle"' +
         ' font-size="12" font-weight="bold">' + esc(title) + "</text>";
    for (var i = 0; i < n; i++) {
      var bh = counts[i] / cmax * ih;
      o += '<rect x="' + (L + i * bw + 1).toFixed(1) + '" y="' +
           (T + ih - bh).toFixed(1) + '" width="' + (bw - 2).toFixed(1) +
           '" height="' + bh.toFixed(1) + '" fill="#5c6bc0"/>';
    }
    o += '<line x1="' + L + '" y1="' + (T + ih) + '" x2="' + (L + iw) +
         '" y2="' + (T + ih) + '" stroke="#999"/>';
    if (hist.min != null && hist.max != null) {
      o += '<text x="' + L + '" y="' + (h - 5) + '" font-size="10"' +
           ' fill="#666">' + Number(hist.min).toPrecision(3) + "</text>";
      o += '<text x="' + (L + iw) + '" y="' + (h - 5) +
           '" text-anchor="end" font-size="10" fill="#666">' +
           Number(hist.max).toPrecision(3) + "</text>";
    }
    return o + "</svg>";
  }

  function card(inner) { return '<div class="card">' + inner + "</div>"; }

  function table(title, header, rows) {
    var o = '<table class="uic"><caption style="font-weight:bold;' +
            'font-size:13px">' + esc(title) + "</caption><tr>";
    header.forEach(function (hh) { o += "<th>" + esc(hh) + "</th>"; });
    o += "</tr>";
    rows.forEach(function (r) {
      o += "<tr>" + r.map(function (c) {
        return "<td>" + esc(c) + "</td>";
      }).join("") + "</tr>";
    });
    return o + "</table>";
  }

  function fmt(v) {
    if (v == null) return "-";
    return (typeof v === "number") ? v.toPrecision(4) : String(v);
  }

  // ------------------------------------------------------ page renderers
  function renderOverview(d) {
    var parts = [];
    if (d.iterations && d.iterations.length) {
      parts.push(card(lineChart("Score vs iteration", ["score"],
                                [d.iterations], [d.scores])));
    }
    var rows = [];
    var ps = d.param_stats || {}, us = d.update_stats || {};
    Object.keys(ps).forEach(function (k) {
      rows.push([k, fmt(ps[k].norm2), fmt(ps[k].mean_magnitude),
                 fmt((us[k] || {}).norm2)]);
    });
    if (rows.length) {
      parts.push(card(table("Parameters (last report)",
                            ["parameter", "norm2", "mean magnitude",
                             "update norm2"], rows)));
    }
    var st = d.static || {};
    parts.push('<div class="meta">' + (d.iterations || []).length +
               " reports; " + fmt(d.minibatches_per_second) +
               " minibatches/s; model " + esc(st.model_class || "-") +
               ", " + esc(st.num_params || "-") + " params</div>");
    return parts.join("");
  }

  function renderModel(d) {
    var parts = [];
    Object.keys(d.layers || {}).forEach(function (name) {
      var L = d.layers[name];
      var inner = lineChart(name + ": norms",
                            ["param norm2", "update norm2"],
                            [L.iterations, L.iterations],
                            [L.param_norm, L.update_norm]);
      inner += lineChart(name + ": update/param ratio", ["ratio"],
                         [L.iterations], [L.ratio], 900, 150);
      var h = (d.param_histograms || {})[name];
      if (h) inner += histChart(name + ": parameter histogram", h);
      parts.push(card(inner));
    });
    Object.keys(d.activations || {}).forEach(function (name) {
      var A = d.activations[name];
      parts.push(card(lineChart("activations " + name + ": mean / std",
                                ["mean", "std"],
                                [A.iterations, A.iterations],
                                [A.mean, A.std], 900, 170)));
    });
    return parts.join("") || '<div class="card">no model reports yet</div>';
  }

  function renderHistogram(d) {
    var parts = [];
    [["param_histograms", "parameters"],
     ["update_histograms", "updates"]].forEach(function (kind) {
      var hs = d[kind[0]] || {};
      var inner = "";
      Object.keys(hs).forEach(function (name) {
        inner += histChart(name + " (" + kind[1] + ")", hs[name]);
      });
      if (inner) parts.push(card("<h3>" + kind[1] + "</h3>" + inner));
    });
    if (!parts.length) {
      return '<div class="card">no histograms — construct ' +
             "StatsListener(collect_histograms=True)</div>";
    }
    return '<div class="meta">iteration ' + fmt(d.iteration) + "</div>" +
           parts.join("");
  }

  function renderFlow(d) {
    var nodes = d.nodes || [];
    if (!nodes.length) {
      return '<div class="card">no network structure yet</div>';
    }
    var bw = 210, bh = 46, gap = 26, w = 900;
    var x0 = 40, y = 16;
    var pos = {};
    var o = "";
    var maxMag = 1e-12;
    nodes.forEach(function (nd) {
      var a = (d.activations || {})[nd.name];
      if (a && a.mean_magnitude) maxMag = Math.max(maxMag, a.mean_magnitude);
    });
    nodes.forEach(function (nd) {
      pos[nd.name] = y;
      var a = (d.activations || {})[nd.name];
      var heat = a ? Math.min(1, (a.mean_magnitude || 0) / maxMag) : 0;
      var fill = a ? "rgba(25,118,210," + (0.12 + 0.5 * heat).toFixed(2) +
                 ")" : "#f5f5f5";
      o += '<rect x="' + x0 + '" y="' + y + '" width="' + bw +
           '" height="' + bh + '" rx="6" fill="' + fill +
           '" stroke="#90a4ae"/>';
      o += '<text x="' + (x0 + 10) + '" y="' + (y + 18) +
           '" font-size="12" font-weight="bold">' + esc(nd.name) +
           "</text>";
      o += '<text x="' + (x0 + 10) + '" y="' + (y + 34) +
           '" font-size="10" fill="#555">' + esc(nd.type) +
           (a ? "  act mean " + fmt(a.mean) + " std " + fmt(a.std) : "") +
           "</text>";
      y += bh + gap;
    });
    (d.edges || []).forEach(function (e) {
      var ya = pos[e[0]], yb = pos[e[1]];
      if (ya == null || yb == null) return;
      var xa = x0 + bw / 2, x1 = ya + bh, y2 = yb;
      if (y2 - x1 <= gap + 1) {
        o += '<line x1="' + xa + '" y1="' + x1 + '" x2="' + xa +
             '" y2="' + y2 + '" stroke="#607d8b" marker-end="url(#arr)"/>';
      } else {   // skip connection: arc on the right
        var xr = x0 + bw + 40;
        o += '<path d="M ' + (x0 + bw) + " " + (x1 - bh / 2) + " C " + xr +
             " " + (x1 - bh / 2) + ", " + xr + " " + (y2 + bh / 2) + ", " +
             (x0 + bw) + " " + (y2 + bh / 2) +
             '" fill="none" stroke="#607d8b" marker-end="url(#arr)"/>';
      }
    });
    var svg = '<svg width="' + w + '" height="' + (y + 4) +
              '" xmlns="http://www.w3.org/2000/svg"><defs>' +
              '<marker id="arr" markerWidth="8" markerHeight="8" refX="6"' +
              ' refY="3" orient="auto"><path d="M0,0 L6,3 L0,6 z"' +
              ' fill="#607d8b"/></marker></defs>' + o + "</svg>";
    return card("<h3>Network flow (activation heat)</h3>" + svg);
  }

  function renderSystem(d) {
    var parts = [];
    var its = d.iterations || [];
    if (its.length) {
      parts.push(card(lineChart("Host RSS (MB)", ["rss_mb"], [its],
                                [d.memory_rss_mb])));
      parts.push(card(lineChart("Minibatches / second", ["mb/s"], [its],
                                [d.minibatches_per_second], 900, 170)));
    }
    var st = d.static || {};
    parts.push(card(table("Environment", ["key", "value"],
                          [["software", JSON.stringify(st.software || {})],
                           ["hardware", JSON.stringify(st.hardware || {})],
                           ["model", String(st.model_class)]])));
    return parts.join("");
  }

  function renderTsne(d) {
    if (!d.x || !d.x.length) {
      return '<div class="card">no embedding uploaded</div>';
    }
    var labels = d.labels || d.x.map(function () { return "0"; });
    var xmin = Math.min.apply(null, d.x), xmax = Math.max.apply(null, d.x);
    var ymin = Math.min.apply(null, d.y), ymax = Math.max.apply(null, d.y);
    if (xmax === xmin) xmax = xmin + 1;
    if (ymax === ymin) ymax = ymin + 1;
    var w = 900, h = 540, L = 20, T = 20;
    var uniq = [];
    labels.forEach(function (l) {
      if (uniq.indexOf(l) < 0) uniq.push(l);
    });
    var o = '<svg width="' + w + '" height="' + h +
            '" xmlns="http://www.w3.org/2000/svg">';
    for (var i = 0; i < d.x.length; i++) {
      var cx = L + (d.x[i] - xmin) / (xmax - xmin) * (w - 2 * L);
      var cy = T + (h - 2 * T) - (d.y[i] - ymin) / (ymax - ymin) *
               (h - 2 * T);
      var col = COLORS[uniq.indexOf(labels[i]) % COLORS.length];
      o += '<circle cx="' + cx.toFixed(1) + '" cy="' + cy.toFixed(1) +
           '" r="2.5" fill="' + col + '" fill-opacity="0.7"/>';
    }
    return card(o + "</svg>");
  }

  var ROUTES = {
    overview: ["/train/overview", renderOverview],
    model: ["/train/model", renderModel],
    histogram: ["/train/histogram", renderHistogram],
    flow: ["/train/flow", renderFlow],
    system: ["/train/system", renderSystem],
    tsne: ["/tsne", renderTsne]
  };

  function tick() {
    var route = ROUTES[PAGE];
    if (!route) return;
    fetch(route[0], {cache: "no-store"}).then(function (r) {
      if (!r.ok) throw new Error(r.status);
      return r.json();
    }).then(function (d) {
      var live = document.getElementById("live");
      if (live) live.innerHTML = route[1](d);
      var st = document.getElementById("status");
      if (st) {
        st.textContent = "live · updated " +
                         new Date().toLocaleTimeString();
      }
      setTimeout(tick, INTERVAL);
    }).catch(function () {
      var st = document.getElementById("status");
      if (st) st.textContent = "disconnected · retrying…";
      setTimeout(tick, INTERVAL * 2);
    });
  }
  tick();
})();
"""
