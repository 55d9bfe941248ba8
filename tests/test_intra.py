"""Cross-validation of intra prediction against reference test vectors.

tests/vectors/intra_vectors.bin was produced by tools/dump_intra_vectors.c,
which drives the reference encoder's own generic strategies
(uvg_angular_pred / uvg_intra_pred_planar / uvg_pdpc_planar_dc) on random
reference samples.  Every record must match bit-exactly.
"""
import os
import struct

import numpy as np
import pytest

from uvg266_jax.ops.intra import (
    pdpc_planar_dc,
    pred_angular,
    pred_dc,
    pred_planar,
    wide_angle_correction,
)

VEC = os.path.join(os.path.dirname(__file__), "vectors", "intra_vectors.bin")


def iter_records():
    data = open(VEC, "rb").read()
    off = 0
    while off < len(data):
        w, h, mode, kind = struct.unpack_from("<4i", data, off)
        off += 16
        ra = np.frombuffer(data, np.uint8, 256, off).astype(np.int32)
        off += 256
        rl = np.frombuffer(data, np.uint8, 256, off).astype(np.int32)
        off += 256
        pred = np.frombuffer(data, np.uint8, w * h, off).astype(np.int32).reshape(h, w)
        off += w * h
        yield w, h, mode, kind, ra, rl, pred


@pytest.mark.skipif(not os.path.exists(VEC), reason="vectors not present")
def test_angular_vectors():
    n = 0
    fails = []
    for w, h, mode, kind, ra, rl, want in iter_records():
        if kind != 0:
            continue
        lw, lh = w.bit_length() - 1, h.bit_length() - 1
        pm = wide_angle_correction(mode, lw, lh)
        got = pred_angular(w, h, pm, ra, rl)
        if not np.array_equal(got, want):
            fails.append((w, h, mode, pm, np.abs(got - want).max()))
        n += 1
    assert n > 500
    assert not fails, fails[:10]


@pytest.mark.skipif(not os.path.exists(VEC), reason="vectors not present")
def test_planar_and_pdpc_vectors():
    n = 0
    planar_cache = {}
    for w, h, mode, kind, ra, rl, want in iter_records():
        if kind == 1:
            got = pred_planar(w, h, ra, rl)
            assert np.array_equal(got, want), (w, h, "planar")
            planar_cache[(w, h, ra.tobytes())] = got
            n += 1
        elif kind == 2:
            base = planar_cache[(w, h, ra.tobytes())]
            got = np.clip(pdpc_planar_dc(base, w, h, ra, rl), 0, 255)
            assert np.array_equal(got, want), (w, h, "pdpc")
            n += 1
    assert n > 50


def test_dc_basic():
    ra = np.full(256, 100, dtype=np.int32)
    rl = np.full(256, 60, dtype=np.int32)
    out = pred_dc(8, 8, ra, rl)
    assert out[0, 0] == 80
    out = pred_dc(16, 4, ra, rl)  # wide: only top used
    assert out[0, 0] == 100
    out = pred_dc(4, 16, ra, rl)  # tall: only left used
    assert out[0, 0] == 60
