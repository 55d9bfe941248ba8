"""Benchmark: encode fps of two 832x480 cells vs the reference's measured
CPU fps.

Prints one device-identity line, then one JSON line per metric:
{"metric", "value", "unit", "vs_baseline", "vs_multithread"}; the
all-intra line is last.

Baseline (BASELINE_MEASURED.json): uvg266 0.8.1 ultrafast on a CPU host,
832x480 synthetic clip (this file's synth_clip): all-intra QP22 9.93 fps
single-thread, 24.39 fps multi-thread; low-delay QP27 16.33 / 59.82 fps.
The search programs run on JAX's default backend, which must be a GPU;
set JAX_PLATFORMS=cpu to bench the CPU on purpose.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_FPS_1T = 9.93       # uvg266 --preset ultrafast --no-wpp --threads 0
W, H, FRAMES = 832, 480, 10
LOOPS = 6               # timed encodes = LOOPS * FRAMES
QP = 22


def synth_clip():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(FRAMES):
        y = (xx * 0.3 + yy * 0.2 + 40 * np.sin((xx + 3 * t) / 16.0)
             + 30 * np.cos((yy - 2 * t) / 11.0)
             + 20 * ((xx // 32 + yy // 32 + t) % 2))
        y = np.clip(y + rng.integers(-6, 6, (H, W)), 0, 255).astype(np.int32)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (H // 2, W // 2)), 0, 255).astype(np.int32)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (H // 2, W // 2)), 0, 255).astype(np.int32)
        frames.append((y, u, v))
    return frames


N_WORKERS = int(os.environ.get("BENCH_WORKERS", "3"))
                 # host-side frame pipeline width (the OWF analogue:
                 # uvg266 overlaps frames with its thread pool; here the
                 # native recon/filter/entropy phases release the GIL and
                 # one device serves every worker's search)


REF_LD_FPS_1T = 16.33   # uvg266 --preset ultrafast --gop lp-g4d3t1
                        # --threads 0 --no-wpp, same host/clip, QP27
REF_LD_FPS_MT = 59.82   # same, --threads auto --owf auto
REF_FPS_MT = 24.39      # all-intra --threads auto --owf auto
# 40 frames matches the measured anchor's clip length
LD_FRAMES = int(os.environ.get("BENCH_LD_FRAMES", "40"))


def check_device() -> None:
    """Print the device-identity line; refuse a non-GPU backend unless
    JAX_PLATFORMS=cpu asked for the CPU."""
    from uvg266_jax.device_info import device_identity
    ident = device_identity()
    print(f"device: platform={ident['platform']} kind={ident['kind']} "
          f"count={ident['count']} card={ident['card']}", flush=True)
    if ident["platform"] != "gpu" \
            and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"bench.py: JAX's backend is {ident['platform']}, "
                         "not a GPU (set JAX_PLATFORMS=cpu to bench the "
                         "CPU on purpose)")


def bench_lowdelay() -> None:
    """Low-delay P/B encode fps (the reference's config-2 measurement:
    832x480 --gop lp-g4d3t1 QP27). Emits its own JSON line; the
    all-intra line stays last."""
    from uvg266_jax.cfg import Config
    from uvg266_jax.control.encoder import Encoder, FramePlanes

    # matched settings vs the recorded anchor: the uvg266 ultrafast
    # preset runs SAO off and signhide off
    cfg = Config(width=W, height=H, qp=27, gop_len=4, gop_lowdelay=True,
                 intra_period=64, sao_type=0, alf_type=0,
                 deblock_enable=True, rdoq_enable=False,
                 signhide_enable=False, dep_quant=False, wpp=False)
    frames = [FramePlanes(*f) for f in synth_clip()]
    seq = [frames[i % FRAMES] for i in range(LD_FRAMES)]
    # warm-up encode: compiles every leaf-bucket shape outside the timing
    enc = Encoder(cfg)
    for f in seq[:10]:
        enc.feed(f)
    enc.flush()
    enc = Encoder(cfg)
    t0 = time.time()
    for f in seq:
        enc.feed(f)
    enc.flush()
    fps = len(seq) / (time.time() - t0)
    print(json.dumps({
        "metric": "lowdelay_832x480_qp27_fps",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_LD_FPS_1T, 4),
        "vs_multithread": round(fps / REF_LD_FPS_MT, 4),
    }))


def main() -> int:
    from concurrent.futures import ThreadPoolExecutor

    from uvg266_jax.cfg import Config
    from uvg266_jax.compile_cache import enable_compile_cache
    from uvg266_jax.control.encoder import FramePlanes, SliceEncoder
    from uvg266_jax.control.params import EncoderControl, FrameState

    enable_compile_cache()
    check_device()
    bench_lowdelay()

    cfg = Config(width=W, height=H, qp=QP, gop_len=0, intra_period=1,
                 sao_type=3, alf_type=0, deblock_enable=True,
                 rdoq_enable=False, signhide_enable=True, dep_quant=False,
                 wpp=False)
    ctrl = EncoderControl(cfg)
    frames = synth_clip()
    encs = [SliceEncoder(cfg, ctrl) for _ in range(N_WORKERS)]

    BATCH = int(os.environ.get("BENCH_BATCH", "3"))

    # warm-up (jit compile + native build); the jit cache is shared, so
    # one full encode warms every worker. Warm BOTH batch shapes the
    # timed loop will use (full batches and the tail batch), so no
    # compile lands in the timed region.
    encs[0].encode_frame(FrameState(num=0, qp=QP), FramePlanes(*frames[0]))
    per_worker = -(-FRAMES * LOOPS // N_WORKERS)
    tail = per_worker % BATCH
    for nb in {min(BATCH, per_worker)} | ({tail} if tail else set()):
        rs = encs[0].dispatch_frames_search(
            [FrameState(num=i, qp=QP) for i in range(nb)],
            [FramePlanes(*frames[i % FRAMES]) for i in range(nb)])
        if rs is None:
            break
        for r in rs:
            r()

    def work(slot):
        # each worker encodes a strided sublist with one-BATCH lookahead:
        # the device searches the next BATCH frames (one dispatch + one
        # fetch for all of them) while the host finalizes the current ones
        e = encs[slot]
        idxs = list(range(slot, FRAMES * LOOPS, N_WORKERS))
        done = 0
        fps_ = [FramePlanes(*frames[i % FRAMES]) for i in idxs]
        batches = [list(range(k, min(k + BATCH, len(idxs))))
                   for k in range(0, len(idxs), BATCH)]

        def dispatch(b):
            rs = e.dispatch_frames_search(
                [FrameState(num=idxs[k], qp=QP) for k in b],
                [fps_[k] for k in b])
            if rs is None:              # per-class fallback configs
                rs = [e.dispatch_frame_search(
                    FrameState(num=idxs[k], qp=QP), fps_[k]) for k in b]
            return rs

        pre = dispatch(batches[0])
        for bi, b in enumerate(batches):
            nxt = dispatch(batches[bi + 1]) if bi + 1 < len(batches) \
                else None
            for j, k in enumerate(b):
                e.encode_frame(FrameState(num=idxs[k], qp=QP), fps_[k],
                               prefetch=pre[j])
                done += 1
            pre = nxt
        return done

    t0 = time.time()
    with ThreadPoolExecutor(N_WORKERS) as ex:
        n_done = sum(ex.map(work, range(N_WORKERS)))
    fps = n_done / (time.time() - t0)

    print(json.dumps({
        "metric": "allintra_832x480_qp22_fps",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_FPS_1T, 4),
        "vs_multithread": round(fps / REF_FPS_MT, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
