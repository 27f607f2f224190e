# Copied from plonkish_tpu/plotter.py (host only); reads target/bench_torch.
"""Cost-breakdown / comparison plotter (reference benchmark/src/bin/plotter.rs).

Reads the `k, avg_ms` lines written by `plonkish_tpu_torch.benchmark` under
target/bench_torch/<system> and renders a dependency-free SVG comparison chart
plus a stacked cost-breakdown bar per k when breakdown JSON files are present.
Files with other row formats (`k, commit_ms, open_ms` of the pcs system) are
skipped.

Usage: python -m plonkish_tpu_torch.plotter [--dir target/bench_torch] [--out target/bench_torch/plot.svg]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

PALETTE = ["#4878d0", "#ee854a", "#6acc64", "#d65f5f", "#956cb4", "#8c613c"]


def read_series(path: str) -> List[Tuple[int, float]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            k, ms = line.split(",")
            out.append((int(k), float(ms)))
    # last sample per k wins
    dedup = {}
    for k, ms in out:
        dedup[k] = ms
    return sorted(dedup.items())


def render_svg(series: Dict[str, List[Tuple[int, float]]], out_path: str):
    width, height, pad = 640, 400, 56
    points = [p for s in series.values() for p in s]
    if not points:
        raise SystemExit("no bench data found")
    ks = sorted({k for k, _ in points})
    max_ms = max(ms for _, ms in points)

    def x(k):
        if len(ks) == 1:
            return width / 2
        return pad + (k - ks[0]) / (ks[-1] - ks[0]) * (width - 2 * pad)

    def y(ms):
        return height - pad - (ms / max_ms) * (height - 2 * pad)

    svg = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="12">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<line x1="{pad}" y1="{height-pad}" x2="{width-pad}" '
        f'y2="{height-pad}" stroke="black"/>',
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height-pad}" '
        f'stroke="black"/>',
        f'<text x="{width/2}" y="{height-12}" text-anchor="middle">k '
        f"(circuit size 2^k)</text>",
        f'<text x="16" y="{height/2}" transform="rotate(-90 16 {height/2})" '
        f'text-anchor="middle">prover time (ms)</text>',
    ]
    for k in ks:
        svg.append(
            f'<text x="{x(k)}" y="{height-pad+16}" text-anchor="middle">'
            f"{k}</text>"
        )
    for i, (name, data) in enumerate(sorted(series.items())):
        color = PALETTE[i % len(PALETTE)]
        pts = " ".join(f"{x(k)},{y(ms)}" for k, ms in data)
        svg.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="2"/>'
        )
        for k, ms in data:
            svg.append(
                f'<circle cx="{x(k)}" cy="{y(ms)}" r="3" fill="{color}"/>'
            )
        svg.append(
            f'<text x="{width-pad-150}" y="{pad + 16*i}" fill="{color}">'
            f"{name}</text>"
        )
    svg.append("</svg>")
    with open(out_path, "w") as f:
        f.write("\n".join(svg))
    print(f"wrote {out_path}")


def render_breakdown_svg(system: str, data: Dict[str, Dict[str, float]],
                         out_path: str):
    """Stacked per-category cost bars per k (reference plotter.rs:94-130's
    cost-breakdown chart).  data: {k(str): {category: ms}}."""
    ks = sorted(data, key=int)
    cats: List[str] = []
    for bars in data.values():
        for c in bars:
            if c not in cats and bars[c] > 0:
                cats.append(c)
    width, height, pad = 640, 400, 56
    max_total = max(sum(v for v in bars.values()) for bars in data.values())
    bar_w = min(64, (width - 2 * pad) / max(len(ks), 1) * 0.7)
    svg = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="12">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<text x="{width / 2}" y="20" text-anchor="middle">'
        f"{system} cost breakdown (ms)</text>",
    ]
    for i, k in enumerate(ks):
        cx = pad + (i + 0.5) * (width - 2 * pad) / len(ks)
        y0 = height - pad
        for cat in cats:
            ms = data[k].get(cat, 0.0)
            h = (ms / max_total) * (height - 2 * pad)
            y0 -= h
            color = PALETTE[cats.index(cat) % len(PALETTE)]
            svg.append(
                f'<rect x="{cx - bar_w / 2:.1f}" y="{y0:.1f}" '
                f'width="{bar_w:.1f}" height="{h:.1f}" fill="{color}"/>'
            )
        svg.append(
            f'<text x="{cx:.1f}" y="{height - pad + 16}" '
            f'text-anchor="middle">k={k}</text>'
        )
    for j, cat in enumerate(cats):
        color = PALETTE[j % len(PALETTE)]
        ly = pad + 16 * j
        svg.append(
            f'<rect x="{width - pad - 120}" y="{ly - 10}" width="12" '
            f'height="12" fill="{color}"/>'
        )
        svg.append(
            f'<text x="{width - pad - 102}" y="{ly}">{cat}</text>'
        )
    svg.append("</svg>")
    with open(out_path, "w") as f:
        f.write("\n".join(svg))
    print(f"wrote {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="target/bench_torch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    series = {}
    for name in os.listdir(args.dir):
        path = os.path.join(args.dir, name)
        if not os.path.isfile(path) or name.endswith(".svg"):
            continue
        if name.endswith(".breakdown.json"):
            with open(path) as f:
                data = json.load(f)
            system = name[: -len(".breakdown.json")]
            render_breakdown_svg(
                system, data,
                os.path.join(args.dir, f"{system}.breakdown.svg"),
            )
            continue
        try:
            series[name] = read_series(path)
        except ValueError:
            continue
    out = args.out or os.path.join(args.dir, "plot.svg")
    render_svg(series, out)


if __name__ == "__main__":
    main()
