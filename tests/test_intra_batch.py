"""Batched (JAX) intra prediction vs scalar golden model: bit-exact."""
import numpy as np
import pytest

from uvg266_jax.ops import intra as intra_ops
from uvg266_jax.ops.cost import satd
from uvg266_jax.ops.intra_batch import (
    build_mode_tables,
    make_predict_fn,
    make_satd67_fn,
    pack_refs,
)

SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (8, 4), (4, 8), (16, 8),
          (8, 16), (32, 8), (8, 32), (16, 32), (32, 16), (4, 16), (16, 4)]


def random_refs(w, h, seed, batch=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        top = rng.integers(0, 256, 3 * 64 + 3).astype(np.int32)
        left = rng.integers(0, 256, 3 * 64 + 3).astype(np.int32)
        # make the top-left sample consistent like real refs
        left[0] = top[0]
        out.append(intra_ops.IntraRefs(top.copy(), left.copy()))
    return out


@pytest.mark.parametrize("w,h", SHAPES)
def test_batch_matches_scalar_luma(w, h):
    import jax
    refs_list = random_refs(w, h, seed=w * 37 + h)
    tables = build_mode_tables(w, h, 8, False)
    fn = jax.jit(make_predict_fn(tables))
    r = pack_refs(refs_list, w, h)
    out = np.asarray(fn(r))
    for b, refs in enumerate(refs_list):
        for mode in range(67):
            fresh = intra_ops.IntraRefs(refs.top.copy(), refs.left.copy())
            exp = intra_ops.predict_intra(mode, w, h, fresh, 8,
                                          cu_log2_w=intra_ops.LOG2[w],
                                          cu_log2_h=intra_ops.LOG2[h])
            np.testing.assert_array_equal(
                out[b, mode], exp,
                err_msg=f"mode {mode} block {b} ({w}x{h})")


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (16, 8)])
def test_batch_matches_scalar_chroma(w, h):
    import jax
    refs_list = random_refs(w, h, seed=1000 + w + h)
    tables = build_mode_tables(w, h, 8, True)
    fn = jax.jit(make_predict_fn(tables))
    r = pack_refs(refs_list, w, h)
    out = np.asarray(fn(r))
    for b, refs in enumerate(refs_list):
        for mode in range(67):
            fresh = intra_ops.IntraRefs(refs.top.copy(), refs.left.copy())
            exp = intra_ops.predict_intra(mode, w, h, fresh, 8, is_chroma=True)
            np.testing.assert_array_equal(
                out[b, mode], exp,
                err_msg=f"chroma mode {mode} block {b} ({w}x{h})")


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (32, 32), (4, 4), (16, 4)])
def test_satd67_matches_numpy(w, h):
    import jax
    rng = np.random.default_rng(5)
    B = 3
    preds = rng.integers(0, 256, (B, 67, h, w)).astype(np.int32)
    src = rng.integers(0, 256, (B, h, w)).astype(np.int32)
    fn = jax.jit(make_satd67_fn(w, h))
    got = np.asarray(fn(preds, src))
    for b in range(B):
        for m in range(67):
            assert got[b, m] == satd(src[b], preds[b, m])
