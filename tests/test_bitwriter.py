import pytest

from uvg266_jax.bitstream.bitwriter import (
    Bitstream,
    BitstreamReader,
    strip_emulation_prevention,
)


def test_put_bits_msb_first():
    bs = Bitstream()
    bs.put(0b10110011, 8)
    assert bs.bytes() == bytes([0b10110011])


def test_ue_known_values():
    # ue(v): 0->1, 1->010, 2->011, 3->00100 ...
    for val, bits, nbits in [(0, 0b1, 1), (1, 0b010, 3), (2, 0b011, 3),
                             (3, 0b00100, 5), (4, 0b00101, 5), (5, 0b00110, 5)]:
        bs = Bitstream()
        bs.put_ue(val)
        assert bs.tell() == nbits, val
        bs.align_zero()
        assert bs.buf[0] >> (8 - nbits) == bits


def test_se_mapping():
    # se(v): 0->0, 1->1, -1->2, 2->3, -2->4
    pairs = [(0, 0), (1, 1), (-1, 2), (2, 3), (-2, 4), (3, 5), (-3, 6)]
    for sval, code in pairs:
        b1, b2 = Bitstream(), Bitstream()
        b1.put_se(sval)
        b2.put_ue(code)
        b1.align_zero()
        b2.align_zero()
        assert b1.bytes() == b2.bytes(), sval


def test_ue_se_reader_roundtrip():
    import random
    rng = random.Random(1)
    vals = [rng.randrange(0, 100000) for _ in range(100)]
    svals = [rng.randrange(-50000, 50000) for _ in range(100)]
    bs = Bitstream()
    for v in vals:
        bs.put_ue(v)
    for v in svals:
        bs.put_se(v)
    bs.align_zero()
    rd = BitstreamReader(bs.bytes())
    assert [rd.read_ue() for _ in vals] == vals
    assert [rd.read_se() for _ in svals] == svals


def test_emulation_prevention():
    bs = Bitstream()
    for b in [0x00, 0x00, 0x01]:
        bs.put_byte(b)
    assert bs.bytes() == bytes([0x00, 0x00, 0x03, 0x01])
    # 00 00 04 must NOT be escaped
    bs2 = Bitstream()
    for b in [0x00, 0x00, 0x04]:
        bs2.put_byte(b)
    assert bs2.bytes() == bytes([0x00, 0x00, 0x04])
    # zero run: 00 00 00 00 -> 00 00 03 00 00 03? (counter resets after escape)
    bs3 = Bitstream()
    for b in [0x00] * 5:
        bs3.put_byte(b)
    assert bs3.bytes() == bytes([0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00])


def test_strip_emulation_prevention_inverts():
    import random
    rng = random.Random(7)
    for _ in range(50):
        payload = bytes(rng.choice([0, 0, 0, 1, 2, 3, 255]) for _ in range(64))
        bs = Bitstream()
        for b in payload:
            bs.put_byte(b)
        assert strip_emulation_prevention(bs.bytes()) == payload


def test_rbsp_trailing():
    bs = Bitstream()
    bs.put(0b101, 3)
    bs.rbsp_trailing_bits()
    assert bs.bytes() == bytes([0b10110000])
