"""BD-rate harness: measure Bjontegaard-delta rate of this encoder vs
the reference uvg266 binary at matched presets over a QP ladder.

The reference publishes no BD-rate numbers (BASELINE.md); this tool
produces them by encoding the same clip with both encoders at QP
{22,27,32,37} and integrating the log-rate difference over the common
PSNR interval with a cubic fit (the classic Bjontegaard metric).

Usage:
    python -m uvg266_jax.tools.bdrate [--configs allintra,lowdelay,ra8]
        [--ref-bin /tmp/uvgbuild/uvg266] [--qps 22,27,32,37]
        [--size 416x240] [--frames 8] [--out BDRATE.json]

Prints one JSON line per config and writes the aggregate to --out.
Negative BD-rate = this encoder needs fewer bits at equal quality.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

REF_BIN_DEFAULT = "/tmp/uvgbuild/uvg266"

# matched-preset flag sets: (reference argv tail, our argv tail).
# reference rows follow BASELINE.md's measurement matrix configs 1-3.
# IMPORTANT: uvg266 applies options in argument order and its presets
# overwrite gop (ultrafast sets gop=8, cfg.c:609), so --preset must come
# FIRST in every reference tail or the explicit --gop is silently lost
# (round-2 verdict: the lowdelay anchor was an RA8 encode).
CONFIGS = {
    "allintra": (["--preset", "ultrafast", "-p", "1", "--no-wpp",
                  "--threads", "0"],
                 ["-p", "1", "--preset", "ultrafast"]),
    "lowdelay": (["--preset", "ultrafast", "--gop", "lp-g4d3t1",
                  "--no-wpp", "--threads", "0"],
                 ["--gop", "lp", "--preset", "ultrafast"]),
    "ra8": (["--preset", "ultrafast", "--gop", "8", "--no-wpp",
             "--threads", "0"],
            ["--gop", "ra8", "--preset", "ultrafast"]),
}

_SUMMARY_RE = re.compile(
    r"Processed\s+(\d+)\s+frames,\s+(\d+)\s+bits\s+AVG PSNR Y\s+([\d.]+)")


def synth_clip(w: int, h: int, n: int, seed: int = 7) -> list:
    """Moving synthetic clip with texture + edges (same family as
    bench.py's; motion makes the inter configs meaningful)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (xx * 0.3 + yy * 0.2 + 40 * np.sin((xx + 3 * t) / 16.0)
             + 30 * np.cos((yy - 2 * t) / 11.0)
             + 20 * ((xx // 32 + yy // 32 + t) % 2))
        y = np.clip(y + rng.integers(-6, 6, (h, w)), 0, 255)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255)
        frames.append((y.astype(np.uint8), u.astype(np.uint8),
                       v.astype(np.uint8)))
    return frames


def write_yuv(frames: list, path: str) -> None:
    with open(path, "wb") as f:
        for (y, u, v) in frames:
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def _parse_summary(text: str) -> tuple[int, float]:
    m = _SUMMARY_RE.search(text)
    if not m:
        raise RuntimeError(f"no summary line in output:\n{text[-2000:]}")
    return int(m.group(2)), float(m.group(3))


def run_reference(ref_bin, yuv, w, h, n, qp, tail) -> tuple[int, float]:
    cmd = [ref_bin, "-i", yuv, "--input-res", f"{w}x{h}",
           "-q", str(qp), "-n", str(n), "-o", os.devnull, *tail]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"reference failed: {r.stderr[-1000:]}")
    return _parse_summary(r.stderr + r.stdout)


def run_ours(yuv, w, h, n, qp, tail) -> tuple[int, float]:
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get(
        "BDRATE_JAX_PLATFORM", "cpu"))
    cmd = [sys.executable, "-m", "uvg266_jax.tools.encode",
           "-i", yuv, "--input-res", f"{w}x{h}", "-q", str(qp),
           "-n", str(n), "-o", os.devnull, *tail]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.dirname(os.path.abspath(__file__)))),
                       env=env)
    if r.returncode != 0:
        raise RuntimeError(f"our encoder failed: {r.stderr[-2000:]}")
    return _parse_summary(r.stdout + r.stderr)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Bjontegaard delta-rate (%) of test vs anchor: cubic fit of
    log-rate over PSNR, integrated over the common PSNR interval."""
    la = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lt = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)
    deg = min(3, len(pa) - 1, len(pt) - 1)
    fa = np.polyfit(pa, la, deg)
    ft = np.polyfit(pt, lt, deg)
    lo = max(pa.min(), pt.min())
    hi = min(pa.max(), pt.max())
    if hi <= lo:
        raise ValueError("no PSNR overlap between the two curves")
    ia, it = np.polyint(fa), np.polyint(ft)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((np.exp(avg_t - avg_a) - 1.0) * 100.0)


def measure_config(name, ref_bin, yuv, w, h, n, qps) -> dict:
    ref_tail, our_tail = CONFIGS[name]
    pts = {"ref": {"bits": [], "psnr": []}, "ours": {"bits": [], "psnr": []}}
    for qp in qps:
        rb, rp = run_reference(ref_bin, yuv, w, h, n, qp, ref_tail)
        ob, op = run_ours(yuv, w, h, n, qp, our_tail)
        pts["ref"]["bits"].append(rb)
        pts["ref"]["psnr"].append(rp)
        pts["ours"]["bits"].append(ob)
        pts["ours"]["psnr"].append(op)
    bd = bd_rate(pts["ref"]["bits"], pts["ref"]["psnr"],
                 pts["ours"]["bits"], pts["ours"]["psnr"])
    return {"config": name, "qps": list(qps),
            "bd_rate_y_pct": round(bd, 2), "points": pts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="uvg266-jax-bdrate")
    p.add_argument("--configs", default="allintra,lowdelay,ra8")
    p.add_argument("--ref-bin", default=REF_BIN_DEFAULT)
    p.add_argument("--qps", default="22,27,32,37")
    p.add_argument("--size", default="416x240")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None,
                   help="aggregate JSON output path (default: no file)")
    args = p.parse_args(argv)
    w, h = (int(t) for t in args.size.split("x"))
    qps = [int(q) for q in args.qps.split(",")]
    if not os.path.exists(args.ref_bin):
        print(json.dumps({"error": f"reference binary not found: "
                          f"{args.ref_bin}"}))
        return 1
    yuv = f"/tmp/bdrate_{w}x{h}_{args.frames}_{args.seed}.yuv"
    write_yuv(synth_clip(w, h, args.frames, args.seed), yuv)
    results = []
    for name in args.configs.split(","):
        res = measure_config(name.strip(), args.ref_bin, yuv, w, h,
                             args.frames, qps)
        print(json.dumps({k: res[k] for k in
                          ("config", "bd_rate_y_pct", "qps")}))
        results.append(res)
    agg = {"size": f"{w}x{h}", "frames": args.frames, "seed": args.seed,
           "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(agg, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
