"""Markdown tables of the port's dry-run and hillclimb rows.

Port of ``repro/analysis/report.py``, reading the port's own results
(``results/torch/dryrun.jsonl`` and ``results/torch/hillclimb.jsonl``,
written by ``repro_torch.launch.dryrun`` / ``hillclimb``):

    PYTHONPATH=src python -m repro_torch.analysis.report > tables.md

Emits markdown for §Dry-run, §Roofline (the H100 constants of
``analysis/roofline.py``) and §Perf.
"""

from __future__ import annotations

import json


def _rows(path):
    try:
        return [json.loads(l) for l in open(path)]
    except FileNotFoundError:
        return []


def _fmt_bytes(b):
    if b is None:
        return "—"
    if b >= 1e12:
        return f"{b/1e12:.2f}TB"
    if b >= 1e9:
        return f"{b/1e9:.2f}GB"
    if b >= 1e6:
        return f"{b/1e6:.1f}MB"
    return f"{b/1e3:.0f}KB"


def _next_move(r):
    """One sentence: what would move the dominant term down."""
    rf = r["roofline"]
    b = rf["bottleneck"]
    kind = r["kind"]
    if kind == "train" and b == "compute":
        if rf["useful_ratio"] < 0.8:
            return "cut non-useful FLOPs (sparse-attn schedule / MoE capacity) — see the hillclimb rows"
        return "near compute roofline; next: overlap the remaining collectives"
    if kind == "train" and b == "collective":
        return "per-microbatch weight-grad all-reduces dominate: fewer accumulation rounds or reduce-scatter grads — see the hillclimb rows A"
    if kind == "prefill" and b == "compute":
        return "block-sparse attention schedule removes masked-block FLOPs — see the hillclimb rows B"
    if kind == "decode" and b == "memory":
        return "decode reads params+cache per token: shrink the cache (seq-sharding, f8 storage) or batch more requests"
    if b == "memory":
        return "reduce bytes/step: lower-precision storage or better layout"
    return "overlap the dominant collective with compute"


def dryrun_tables(rows):
    out = []
    for mesh in ("single", "multi"):
        chips = 256 if mesh == "single" else 512
        out.append(f"\n### Mesh `{mesh}` ({chips} chips)\n")
        out.append(
            "| arch | shape | kind | trace s | args/dev | traced flops | "
            "traced dot flops | coll bytes (raw) | coll bytes (global) |"
        )
        out.append("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if r["mesh"] != mesh:
                continue
            if r["kind"] in ("skip", "error"):
                out.append(
                    f"| {r['arch']} | {r['shape']} | **{r['kind']}** | — | — | — | — | — | — |"
                )
                continue
            ma = r["memory_analysis"]
            ca = r["cost_analysis"]
            co = r["collectives"]
            rf = r["roofline"]
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['kind']} | {r['lower_s']} | "
                f"{_fmt_bytes(ma['argument_bytes'])} | {ca['flops']:.2e} | "
                f"{ca['dot_flops']:.2e} | {_fmt_bytes(co['raw_bytes'])} | "
                f"{_fmt_bytes(co.get('global_bytes', co['corrected_bytes']))} |"
            )
    return "\n".join(out)


def roofline_table(rows):
    out = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | bottleneck | "
        "MODEL_FLOPS | useful ratio | roofline frac | next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != "single" or r["kind"] in ("skip", "error"):
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']:.3e} | "
            f"{rf['t_memory']:.3e} | {rf['t_collective']:.3e} | "
            f"**{rf['bottleneck']}** | {rf['model_flops']:.2e} | "
            f"{rf['useful_ratio']:.3f} | {rf['roofline_fraction']:.3f} | {_next_move(r)} |"
        )
    return "\n".join(out)


def perf_table(rows):
    out = [
        "| variant | t_compute | t_memory | t_collective | bottleneck | useful | "
        "roofline frac |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "error" in r:
            out.append(f"| {r['variant']} | ERROR: {r['error']} | | | | | |")
            continue
        out.append(
            f"| {r['variant']} | {r['t_compute']:.3e} | {r['t_memory']:.3e} | "
            f"{r['t_collective']:.3e} | {r['bottleneck']} | {r['useful_ratio']:.3f} | "
            f"**{r['roofline_fraction']:.3f}** |"
        )
    return "\n".join(out)


def main():
    dry = _rows("results/torch/dryrun.jsonl")
    hill = _rows("results/torch/hillclimb.jsonl")
    order = {a: i for i, a in enumerate([
        "dbrx-132b", "mixtral-8x7b", "chameleon-34b", "chatglm3-6b", "qwen2.5-3b",
        "minitron-8b", "phi4-mini-3.8b", "musicgen-medium", "rwkv6-3b", "zamba2-1.2b",
    ])}
    shape_order = {s: i for i, s in enumerate(["train_4k", "prefill_32k", "decode_32k", "long_500k"])}
    dry.sort(key=lambda r: (order.get(r["arch"], 99), shape_order.get(r["shape"], 9)))
    print("## §Dry-run\n")
    print(dryrun_tables(dry))
    print("\n## §Roofline (single-pod, 256 x H100 SXM5)\n")
    print(roofline_table(dry))
    print("\n## §Perf (hillclimbs)\n")
    print(perf_table(hill))


if __name__ == "__main__":
    main()
