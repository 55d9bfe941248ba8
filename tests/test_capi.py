"""C-ABI vtable (native/capi.cpp uvgtpu_api_get, the uvg_api_get shape,
uvg266.h:707-869): build the shared library, drive a full encode through
the C function pointers from ctypes, and oracle-verify the stream."""
import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "uvg266_jax", "native")


def _build(out_dir):
    so = os.path.join(out_dir, "libuvg266jax_test.so")
    src = os.path.join(_DIR, "capi.cpp")
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
           "-o", so, f"-I{inc}", f"-L{libdir}", f"-lpython{ver}"]
    subprocess.check_call(cmd)
    return so


class Chunk(ctypes.Structure):
    pass


Chunk._fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                  ("len", ctypes.c_uint32),
                  ("next", ctypes.POINTER(Chunk))]


class Picture(ctypes.Structure):
    _fields_ = [("fulldata", ctypes.POINTER(ctypes.c_uint8)),
                ("y", ctypes.POINTER(ctypes.c_uint8)),
                ("u", ctypes.POINTER(ctypes.c_uint8)),
                ("v", ctypes.POINTER(ctypes.c_uint8)),
                ("width", ctypes.c_int32),
                ("height", ctypes.c_int32),
                ("pts", ctypes.c_int64)]


class Api(ctypes.Structure):
    _fields_ = [
        ("config_alloc", ctypes.CFUNCTYPE(ctypes.c_void_p)),
        ("config_init", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
        ("config_destroy", ctypes.CFUNCTYPE(ctypes.c_int,
                                            ctypes.c_void_p)),
        ("config_parse", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_char_p,
                                          ctypes.c_char_p)),
        ("picture_alloc", ctypes.CFUNCTYPE(ctypes.POINTER(Picture),
                                           ctypes.c_int32,
                                           ctypes.c_int32)),
        ("picture_free", ctypes.CFUNCTYPE(None, ctypes.POINTER(Picture))),
        ("chunk_free", ctypes.CFUNCTYPE(None, ctypes.POINTER(Chunk))),
        ("encoder_open", ctypes.CFUNCTYPE(ctypes.c_void_p,
                                          ctypes.c_void_p)),
        ("encoder_close", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("encoder_headers", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(
                ctypes.POINTER(Chunk)), ctypes.POINTER(ctypes.c_uint32))),
        ("encoder_encode", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(Picture),
            ctypes.POINTER(ctypes.POINTER(Chunk)),
            ctypes.POINTER(ctypes.c_uint32))),
    ]


def test_capi_vtable_encode(tmp_path):
    so = _build(str(tmp_path))
    lib = ctypes.CDLL(so)
    lib.uvgtpu_api_get.restype = ctypes.POINTER(Api)
    api = lib.uvgtpu_api_get(8).contents

    cfgp = api.config_alloc()
    assert api.config_init(cfgp)
    for k, v in [("width", "64"), ("height", "64"), ("qp", "30"),
                 ("gop_len", "0"), ("intra_period", "1"), ("wpp", "0")]:
        assert api.config_parse(cfgp, k.encode(), v.encode())
    enc = api.encoder_open(cfgp)
    assert enc

    rng = np.random.default_rng(9)
    aus = []
    for t in range(2):
        pic = api.picture_alloc(64, 64)
        frame = rng.integers(0, 256, 64 * 64 * 3 // 2, dtype=np.uint8)
        ctypes.memmove(pic.contents.fulldata, frame.ctypes.data,
                       len(frame))
        out = ctypes.POINTER(Chunk)()
        ln = ctypes.c_uint32()
        assert api.encoder_encode(enc, pic, ctypes.byref(out),
                                  ctypes.byref(ln))
        if ln.value:
            aus.append(bytes(bytearray(out.contents.data[:ln.value])))
        api.chunk_free(out)
        api.picture_free(pic)
    # drain
    out = ctypes.POINTER(Chunk)()
    ln = ctypes.c_uint32()
    assert api.encoder_encode(enc, None, ctypes.byref(out),
                              ctypes.byref(ln))
    if ln.value:
        aus.append(bytes(bytearray(out.contents.data[:ln.value])))
    api.chunk_free(out)
    api.encoder_close(enc)
    api.config_destroy(cfgp)

    stream = b"".join(aus)
    assert len(stream) > 100
    # independently decode the C-API-produced stream
    from uvg266_jax.oracle.ref_decoder import decode_stream
    frames = decode_stream(stream)
    assert len(frames) == 2
    assert all(fr.checksum_ok for fr in frames)
