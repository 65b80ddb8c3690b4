"""``python -m repro_torch.obs.report <trace.jsonl>`` — summarize a flight
recording: per-device / per-lane span occupancy, event counts, planner
decision mix, and the top-k most expensive reconfiguration windows.

Exits non-zero with a clear message on a schema-version mismatch (the
same refusal contract as ``benchmarks/compare.py``) so a stale trace
never renders a silently-wrong summary.  ``--chrome out.json`` also
writes the Chrome trace_event export for chrome://tracing / Perfetto.

``--regret`` replays the trace against the offline oracle
(:mod:`repro_torch.core.planner.oracle`): total makespan regret vs the exact
DP optimum (or the admissible bound when the DP's node budget trips),
a per-decision attribution table (audited action vs the oracle's best
continuation, with the recorded deciding tier), and the serving
grow/wait sequence bound.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Any

from repro_torch.obs.counters import TailStats
from repro_torch.obs.trace import read_jsonl, write_chrome_trace


def _device_table(records: list[dict[str, Any]]) -> list[str]:
    spans: dict[tuple[str, str], TailStats] = {}
    busy: dict[tuple[str, str], float] = defaultdict(float)
    t_max = 0.0
    for rec in records:
        if rec.get("type") != "span":
            continue
        key = (rec.get("device", ""), rec.get("lane", ""))
        dur = rec["t1"] - rec["t0"]
        spans.setdefault(key, TailStats("span_s")).observe(dur)
        busy[key] += dur
        t_max = max(t_max, rec["t1"])
    if not spans:
        return ["(no spans recorded)"]
    lines = [f"{'device':20s} {'lane':24s} {'spans':>6s} {'busy_s':>10s} "
             f"{'conc':>6s} {'p50_s':>8s} {'p99_s':>8s}"]
    for key in sorted(spans):
        st = spans[key]
        # mean span concurrency: <=1.0 reads as slice occupancy for
        # non-overlapping batch runs; >1 is the continuous-batching depth
        conc = busy[key] / t_max if t_max > 0 else 0.0
        lines.append(f"{key[0]:20s} {key[1]:24s} {st.count:6d} "
                     f"{busy[key]:10.2f} {conc:6.2f} "
                     f"{st.percentile(50):8.3f} {st.percentile(99):8.3f}")
    return lines


def _event_table(records: list[dict[str, Any]]) -> list[str]:
    counts: dict[str, int] = defaultdict(int)
    for rec in records:
        if rec.get("type") == "instant":
            counts[rec["name"]] += 1
    if not counts:
        return ["(no instant events)"]
    width = max(len(n) for n in counts)
    return [f"{name:{width}s} {counts[name]:6d}"
            for name in sorted(counts, key=lambda n: (-counts[n], n))]


def _audit_table(records: list[dict[str, Any]]) -> list[str]:
    by_action: dict[tuple[str, str], int] = defaultdict(int)
    tiers: dict[str, int] = defaultdict(int)
    n = 0
    for rec in records:
        if rec.get("type") != "audit":
            continue
        n += 1
        action = rec["action"].split("(")[0].split(" ")[0]
        by_action[(rec.get("owner", "") or rec.get("model", ""),
                   action)] += 1
        label = rec.get("deciding_tier_label")
        if label is not None:
            tiers[label] += 1
    if not n:
        return ["(no planner audits — run with a tracer on the planner)"]
    lines = [f"{n} plan searches:"]
    for key in sorted(by_action):
        lines.append(f"  {key[0]:20s} {key[1]:20s} {by_action[key]:6d}")
    if tiers:
        lines.append("deciding tiers:")
        for label in sorted(tiers, key=lambda x: -tiers[x]):
            lines.append(f"  {label:40s} {tiers[label]:6d}")
    return lines


def _top_reconfigs(records: list[dict[str, Any]], k: int) -> list[str]:
    recs = [r for r in records
            if r.get("type") == "span" and r.get("cat") == "reconfig"]
    recs.sort(key=lambda r: r["t0"] - r["t1"])   # longest first, stable
    if not recs:
        return ["(no reconfiguration windows recorded)"]
    lines = []
    for r in recs[:k]:
        lines.append(f"  {r['t1'] - r['t0']:8.3f}s  t={r['t0']:10.2f}  "
                     f"{r.get('device', ''):16s} {r.get('lane', ''):20s} "
                     f"{r['name']}")
    return lines


def render(header: dict[str, Any], records: list[dict[str, Any]],
           top_k: int = 5) -> str:
    meta = header.get("meta", {})
    out = [f"trace: {len(records)} records, "
           f"t_end={meta.get('t_end', '?')}  meta={meta}"]
    out.append("\n== per-device / per-lane span occupancy ==")
    out.extend(_device_table(records))
    out.append("\n== instant events ==")
    out.extend(_event_table(records))
    out.append("\n== planner decisions ==")
    out.extend(_audit_table(records))
    out.append(f"\n== top-{top_k} most expensive reconfigs ==")
    out.extend(_top_reconfigs(records, top_k))
    return "\n".join(out)


def render_regret(path: str, *, node_budget: int | None = None,
                  attribution_limit: int | None = None,
                  top_k: int = 5) -> str:
    """The ``--regret`` section: oracle gap + per-decision attribution."""
    from repro_torch.obs.replay import load_replay, trace_regret
    replay = load_replay(path)
    reg = trace_regret(replay, node_budget=node_budget,
                       attribution_limit=attribution_limit)
    out = ["\n== regret vs offline oracle =="]
    if reg.oracle is None:
        out.append("(no replayable batch workload: trace carries no job "
                   "records or no recognized backend)")
    else:
        o = reg.oracle
        kind = ("exact DP optimum" if o.exact
                else "admissible lower bound (DP node budget exceeded)")
        out.append(f"policy {reg.policy or '?'} on {reg.backend_name}: "
                   f"{o.n_jobs} jobs in {o.n_classes} classes")
        out.append(f"  oracle ({kind}): {o.makespan_s:.4f}s "
                   f"[closed-form bound {o.bound_s:.4f}s, "
                   f"{o.nodes} DP nodes]")
        if reg.makespan_s is not None:
            out.append(f"  traced makespan: {reg.makespan_s:.4f}s  ->  "
                       f"regret {reg.makespan_regret_s:+.4f}s "
                       f"({reg.makespan_regret_s / o.makespan_s:+.1%})")
    graded = [d for d in reg.decisions if d.regret_s is not None]
    if graded:
        out.append(f"\n-- per-decision attribution ({len(graded)} graded "
                   f"of {len(reg.decisions)} audited) --")
        worst = sorted(graded, key=lambda d: -d.regret_s)[:top_k]
        out.append(f"  {'t':>8s}  {'regret_s':>9s}  {'tier':24s} "
                   f"audited -> optimal")
        for d in worst:
            out.append(f"  {d.t:8.2f}  {d.regret_s:9.4f}  "
                       f"{(d.deciding_tier_label or '-'):24s} "
                       f"{d.audited} -> {d.optimal}")
        n_div = sum(1 for d in graded if d.diverged)
        total = sum(d.regret_s for d in graded)
        out.append(f"  {n_div}/{len(graded)} decisions diverged; summed "
                   f"per-decision regret {total:.4f}s")
    if reg.serving is not None:
        s = reg.serving
        out.append(f"\n-- serving grow/wait sequence (beam bound, "
                   f"width {s.beam_width}) --")
        out.append(f"  audited trade cost {s.audited_cost:.4f}, lower "
                   f"bound {s.bound:.4f} -> regret {s.regret:.4f} over "
                   f"{s.n_decisions} decisions")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs trace JSONL.")
    ap.add_argument("trace", help="trace .jsonl written by Tracer")
    ap.add_argument("--top-k", type=int, default=5,
                    help="reconfig windows to list (default 5)")
    ap.add_argument("--chrome", metavar="OUT.json", default=None,
                    help="also write the Chrome trace_event export")
    ap.add_argument("--regret", action="store_true",
                    help="replay the trace against the offline oracle "
                         "and print the regret report")
    ap.add_argument("--node-budget", type=int, default=None,
                    help="DP node budget for --regret (default: oracle's)")
    ap.add_argument("--attribution-limit", type=int, default=None,
                    help="grade at most N audited decisions (--regret)")
    args = ap.parse_args(argv)
    try:
        header, records = read_jsonl(args.trace)
    except (ValueError, OSError) as exc:
        print(f"refusing to summarize: {exc}", file=sys.stderr)
        return 2
    print(render(header, records, top_k=args.top_k))
    if args.regret:
        print(render_regret(args.trace, node_budget=args.node_budget,
                            attribution_limit=args.attribution_limit,
                            top_k=args.top_k))
    if args.chrome:
        write_chrome_trace(args.chrome, records, header.get("meta"))
        print(f"\nchrome trace_event export -> {args.chrome} "
              f"(load in chrome://tracing or https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
