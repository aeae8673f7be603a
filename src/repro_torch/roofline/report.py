"""Render the roofline table from the dry-run's JSON records, the JAX
package's ``roofline/report.py``.  The header names the descriptor the
cells were priced against and its peaks (each record carries them): the
terms are predictions, not measurements.

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:9.2f}"


def load(dir_: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def one_liner(rec: dict) -> str:
    """The per-cell 'what would move the dominant term down' note."""
    b = rec["bottleneck"]
    shape = rec["shape"]
    if b == "collective":
        if "moe" in rec["arch"] or "arctic" in rec["arch"] or "jamba" in rec["arch"]:
            return ("EP all-to-all + grad reduce dominate; overlap dispatch with "
                    "expert GEMMs / hierarchical reduce would cut it")
        return ("TP activation all-reduces + FSDP gathers dominate; "
                "sequence-sharding activations turns all-reduce into "
                "reduce-scatter (1/2 bytes)")
    if b == "memory":
        if shape.startswith("decode") or shape.startswith("long"):
            return ("weight+KV streaming bound (decode is bandwidth-limited by "
                    "nature); KV quantization or wider batch raises intensity")
        return ("activation traffic bound; bigger fusion regions / flash "
                "attention / bf16 residuals reduce HBM bytes")
    return ("tensor-core-bound — already compute-limited; only layout padding "
            "trims (useful_ratio) remain")


def _descriptor(rec: dict) -> str:
    hw = rec.get("hw", {})
    name = hw.get("device_name") or hw.get("name", "?")
    return (f"{name} ({hw.get('name', '?')} descriptor, published peaks: "
            f"{hw.get('flops_bf16', 0) / 1e12:.0f} TF bf16 / "
            f"{hw.get('hbm_bw', 0) / 1e9:.0f} GB/s HBM / "
            f"{hw.get('ici_bw', 0) / 1e9:.0f} GB/s link)")


def render(recs: list[dict], mesh: str = "pod") -> str:
    rows = [r for r in recs if r.get("mesh") == mesh
            and r.get("policy", "scalable") == "scalable"]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        f"### Roofline table (predicted) — {mesh} mesh "
        f"({rows[0]['chips'] if rows else '?'} devices, per-device terms, "
        f"{_descriptor(rows[0]) if rows else '?'})",
        "",
        "| arch | shape | compute ms | memory ms | collective ms | bound | "
        "MODEL_FLOPS/FLOPs | roofline frac | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        useful = r["model_flops"] / max(1.0, r["hlo_flops_per_chip"] * r["chips"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_ms(r['compute_s'])} | "
            f"{_fmt_ms(r['memory_s'])} | {_fmt_ms(r['collective_s'])} | "
            f"{r['bottleneck']} | {useful:.2f} | "
            f"{r['roofline_fraction']:.3f} | {one_liner(r)} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(render(recs, args.mesh))
    print()
    print(render(recs, "multipod") if args.mesh == "pod" else "")


if __name__ == "__main__":
    main()
