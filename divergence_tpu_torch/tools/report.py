"""HTML run report.

The reference GUI tools can emit "customhtml" result pages
(reference tools/FisherExactTestSNPTool.py:323-335 — a header plus the
score rows rendered into Galaxy's result panel).  This module renders the
framework's equivalent: a self-contained HTML page summarizing one or two
score tracks and optional called regions.

Copied from ``divergence_tpu/tools/report.py`` (the JAX package imports
jax), verbatim apart from the score-track reader's import;
``tests/test_torch_host_copies.py`` holds the copy equal to the original.
"""

from __future__ import annotations

import html
import json
from pathlib import Path

import numpy as np

from divergence_tpu_torch.io.gtrack import read_score_track

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2rem; color: #222; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 1.6rem; }
table { border-collapse: collapse; margin: 0.6rem 0; }
th, td { border: 1px solid #ccc; padding: 0.25rem 0.6rem; text-align: right; }
th { background: #f0f0f0; }
td:first-child, th:first-child { text-align: left; }
.meta { color: #666; font-size: 0.85rem; }
"""


def _track_section(title: str, path: str | Path, value_label: str) -> str:
    seqids, starts, scores, aux = read_score_track(path)
    if len(scores) == 0:
        return f"<h2>{html.escape(title)}</h2><p>empty track</p>"
    qs = np.percentile(scores, [0, 25, 50, 75, 95, 99, 100])
    per_chrom: dict[str, int] = {}
    for s in seqids:
        per_chrom[s] = per_chrom.get(s, 0) + 1
    order = np.argsort(scores)[::-1][:20]
    rows = "".join(
        f"<tr><td>{html.escape(str(seqids[i]))}</td>"
        f"<td>{starts[i]}</td><td>{scores[i]:.6g}</td>"
        f"<td>{aux[i]:.6g}</td></tr>"
        for i in order
    )
    chrom_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
        for k, v in sorted(per_chrom.items())
    )
    stat_rows = "".join(
        f"<tr><td>{lbl}</td><td>{val:.6g}</td></tr>"
        for lbl, val in zip(
            ["min", "q25", "median", "q75", "q95", "q99", "max"], qs
        )
    )
    return f"""
<h2>{html.escape(title)}</h2>
<p class="meta">{len(scores)} scored windows over {len(per_chrom)}
chromosome(s) — {html.escape(str(path))}</p>
<table><tr><th>score quantile</th><th>value</th></tr>{stat_rows}</table>
<table><tr><th>chromosome</th><th>windows</th></tr>{chrom_rows}</table>
<h3>Top 20 windows</h3>
<table><tr><th>seqid</th><th>start</th><th>score</th>
<th>{html.escape(value_label)}</th></tr>{rows}</table>
"""


def _regions_section(title: str, path: str | Path) -> str:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) >= 3:
                rows.append((cols[0], int(cols[1]), int(cols[2])))
    body = "".join(
        f"<tr><td>{html.escape(s)}</td><td>{a}</td><td>{b}</td>"
        f"<td>{b - a}</td></tr>"
        for s, a, b in rows
    )
    total = sum(b - a for _, a, b in rows)
    return f"""
<h2>{html.escape(title)}</h2>
<p class="meta">{len(rows)} region(s), {total:,} bp total —
{html.escape(str(path))}</p>
<table><tr><th>seqid</th><th>start</th><th>end</th><th>length</th></tr>
{body}</table>
"""


def write_report(
    out_path: str | Path,
    fet_track: str | Path | None = None,
    css_track: str | Path | None = None,
    fet_regions: str | Path | None = None,
    css_regions: str | Path | None = None,
    summary_json: str | Path | None = None,
    title: str = "divergence_tpu run report",
) -> None:
    sections = []
    if fet_track:
        sections.append(_track_section("FET score track", fet_track, "stddev"))
    if css_track:
        sections.append(_track_section("CSS score track", css_track, "p"))
    if fet_regions:
        sections.append(_regions_section("FET regions (Burke limit)", fet_regions))
    if css_regions:
        sections.append(_regions_section("CSS regions", css_regions))
    if summary_json:
        data = json.loads(Path(summary_json).read_text())
        sections.append(
            "<h2>Run summary</h2><pre>"
            + html.escape(json.dumps(data, indent=2))
            + "</pre>"
        )
    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>{_STYLE}</style></head>
<body><h1>{html.escape(title)}</h1>
{''.join(sections)}
</body></html>
"""
    Path(out_path).write_text(doc)
