"""Run one cell of the benchmark several times, each run a fresh process,
and report each run's result and each metric's median and spread (the
distance between the first and third quartiles, as ``statistics.quantiles
(values, n=4)`` gives them, over the median).

    python3 benchmark/tools/series.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15 --trace 0 --out series.jsonl

Each run's record (seed, exit code, seconds, the result line, the end of
its standard error) is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(os.path.dirname(HERE), "run.py")


def one(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    t0 = time.time()
    try:
        p = subprocess.run([sys.executable, RUN, "--workload", workload, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace", str(trace)],
                           capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [x for x in out.strip().splitlines() if x.startswith("{")]
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc,
            "wall_s": time.time() - t0, "result": result, "stderr_tail": err[-3000:]}


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def report(records) -> None:
    metrics: dict = {}
    for r in records:
        res = r["result"] or {}
        for name, m in (res.get("metrics") or {}).items():
            metrics.setdefault(name, []).append(m["value"])
    for name, vals in sorted(metrics.items()):
        print(f"  {name}: median {statistics.median(vals)!r} spread {spread(vals)!r} "
              f"n {len(vals)} values {vals}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    records = []
    for seed in [int(s) for s in a.seeds.split(",") if s]:
        r = one(a.workload, seed, a.seconds, a.trace, a.timeout)
        records.append(r)
        with open(a.out, "a") as f:
            f.write(json.dumps(r) + "\n")
        res = r["result"] or {}
        short = {k: res.get(k) for k in ("correct", "attempted", "failed")}
        vals = {k: v["value"] for k, v in (res.get("metrics") or {}).items()}
        dev = res.get("device") or {}
        print(f"{a.workload} seed {seed} trace {a.trace} rc {r['rc']} wall {r['wall_s']:.1f}s "
              f"{short} {vals} peak {dev.get('memory_peak_bytes')} busy {dev.get('busy_s')} "
              f"window {dev.get('window_s')} checks {res.get('checks')}", flush=True)
        if r["rc"] != 0 or not res:
            print(r["stderr_tail"][-1500:], flush=True)
    report(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
