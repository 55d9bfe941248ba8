"""Conformance fuzzer: decode reference-binary streams across random
config x geometry x content combinations.

Drives the upstream uvg266 binary over sampled tool combinations and
frame geometries (including partial-CTU sizes), then decodes every
produced stream with the in-repo spec-mirror decoder and checks the
decoded-picture-hash SEI per frame. Any mismatch is a conformance bug
on one side; each seed is fully deterministic so failures replay.

Usage:
    python -m uvg266_jax.tools.conformance_fuzz --ref-bin /tmp/uvgbuild/uvg266 \
        --iters 50 --seed 0
"""
from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import tempfile

import numpy as np

SIZES = [(320, 192), (416, 240), (176, 144), (352, 288), (200, 120),
         (136, 72), (256, 130), (330, 190)]

GOPS = [["-p", "1"], ["--gop", "lp-g4d3t1"], ["--gop", "8"],
        ["--gop", "16"]]

# independent tool toggles; each entry is (probability, flags)
TOOLS = [
    (0.5, ["--sao", "full"]),
    (0.3, ["--sao", "edge"]),
    (0.6, ["--deblock", "0:0"]),
    (0.2, ["--deblock", "2:1"]),
    (0.4, ["--rdoq"]),
    (0.3, ["--signhide"]),
    (0.25, ["--mts", "intra"]),
    (0.2, ["--lfnst"]),
    (0.2, ["--mip"]),
    (0.2, ["--mrl"]),
    (0.2, ["--cclm"]),
    (0.15, ["--jccr"]),
    (0.2, ["--transform-skip"]),
    (0.25, ["--wpp"]),
    (0.15, ["--tiles", "2x2"]),
    (0.15, ["--vaq", "5"]),
    (0.1, ["--lmcs"]),
    (0.1, ["--alf", "no-cc"]),
    (0.15, ["--scaling-list", "default"]),
]


def synth(w, h, n, rng, style):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        if style == 0:      # moving sinusoids + noise
            y = (128 + 60 * np.sin((xx + 3 * t) / 21.0)
                 * np.cos((yy - 2 * t) / 13.0)
                 + rng.integers(-8, 8, (h, w)))
        elif style == 1:    # gradient + checker flips (periodic traps)
            y = (xx * 0.4 + yy * 0.3 + 25 * ((xx // 16 + yy // 16 + t) % 2)
                 + rng.integers(-5, 5, (h, w)))
        elif style == 2:    # dark-skewed with bright blob (LMCS-active)
            y = (35 + 20 * np.sin((xx + 2 * t) / 17.0)
                 + 170 * np.exp(-(((xx - w // 2 - 4 * t) % w - w // 2) ** 2
                                  + (yy - h // 2) ** 2) / 900.0)
                 + rng.integers(-6, 6, (h, w)))
        else:               # flat + sharp edges (screen-ish)
            y = 60 + 120 * ((xx // 24 + t) % 3 == 0) \
                + rng.integers(-2, 2, (h, w))
        u = np.clip(128 + 18 * np.sin((xx[::2, ::2] + 4 * t) / 29.0)
                    + rng.integers(-4, 4, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + 14 * np.cos((yy[::2, ::2] - 3 * t) / 23.0)
                    + rng.integers(-4, 4, (h // 2, w // 2)), 0, 255)
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    u.astype(np.uint8), v.astype(np.uint8)))
    return out


def one_case(ref_bin, seed, tmpdir):
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    w, h = rng.choice(SIZES)
    gop = rng.choice(GOPS)
    flags = []
    for p, fl in TOOLS:
        if rng.random() < p:
            flags += fl
    # interactions the reference can't do / known upstream bugs
    if "--wpp" in flags and "--tiles" in flags:
        flags.remove("--tiles"); flags.remove("2x2")
    if "--alf" in flags and gop[0] != "-p":
        # upstream ALF+inter streams are nonconformant (see STATUS.md)
        flags.remove("--alf"); flags.remove("no-cc")
    if "--alf" in flags:
        # upstream ALF+WPP writes an empty slice (the whole-frame ALF
        # bitstream re-encode drops the WPP substream data; verified on
        # uvg266 0.8.1: a 136x72 intra frame emits an 8-byte IDR NAL).
        # WPP is the uvg DEFAULT, so force it off whenever ALF is on.
        if "--wpp" in flags:
            flags.remove("--wpp")
        flags.append("--no-wpp")
    if "--slices" not in flags and ("--tiles" in flags) \
            and rng.random() < 0.5:
        flags += ["--slices", "tiles"]
    elif "--wpp" in flags and rng.random() < 0.3:
        flags += ["--slices", "wpp"]
    n = rng.choice([3, 4, 5])
    qp = rng.choice([22, 27, 32, 37])
    style = rng.randrange(4)

    clip = os.path.join(tmpdir, f"c{seed}.yuv")
    with open(clip, "wb") as f:
        for (y, u, v) in synth(w, h, n, nrng, style):
            f.write(y.tobytes()); f.write(u.tobytes()); f.write(v.tobytes())
    out = os.path.join(tmpdir, f"o{seed}.bin")
    cmd = [ref_bin, "-i", clip, "--input-res", f"{w}x{h}", "-n", str(n),
           "-q", str(qp), "--hash", "checksum", "--threads", "0",
           "--owf", "0", "-o", out] + gop + flags
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    desc = f"seed={seed} {w}x{h} qp{qp} n{n} style{style} " \
           f"{' '.join(gop + flags)}"
    if r.returncode != 0:
        return ("REF-FAIL", desc, r.stderr[-200:])
    from ..oracle.ref_decoder import UnsupportedStream, decode_stream
    try:
        frames = decode_stream(open(out, "rb").read())
    except UnsupportedStream as e:
        return ("UNSUPPORTED", desc, str(e)[:120])
    except Exception as e:
        return ("DECODE-ERROR", desc, f"{type(e).__name__}: {e}"[:200])
    bad = [fr.poc for fr in frames if not fr.checksum_ok]
    if len(frames) != n:
        return ("FRAME-COUNT", desc, f"{len(frames)} != {n}")
    if bad:
        return ("HASH-MISMATCH", desc, f"pocs {bad}")
    return ("OK", desc, "")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ref-bin", default="/tmp/uvgbuild/uvg266")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not os.path.exists(args.ref_bin):
        print("reference binary not found", file=sys.stderr)
        return 2
    fails = 0
    with tempfile.TemporaryDirectory() as td:
        for i in range(args.iters):
            status, desc, extra = one_case(args.ref_bin, args.seed + i, td)
            line = f"[{status}] {desc}"
            if extra:
                line += f" | {extra}"
            print(line, flush=True)
            if status in ("HASH-MISMATCH", "DECODE-ERROR", "FRAME-COUNT"):
                fails += 1
    print(f"done: {fails} failures / {args.iters} cases")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
