"""CPU checks of what chip_smoke.py and the GPU translation rely on: the
ME programs pin HIGHEST precision, every parity check of chip_smoke
passes at a small size, chip_smoke refuses a non-GPU backend, the
compile-cache location, and the CLI's device selection."""
import json
import os

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- (a) f32 convs / dots in ME carry Precision.HIGHEST ---------------------

def _conv_dot_precisions(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("conv_general_dilated", "dot_general"):
            found.append((eqn.primitive.name, eqn.params["precision"]))
        for p in eqn.params.values():
            inner = getattr(p, "jaxpr", None)
            if inner is not None:
                found += _conv_dot_precisions(getattr(inner, "jaxpr", inner))
    return found


def _me_jaxpr(which):
    import jax
    import jax.numpy as jnp
    from uvg266_jax.ops.me import make_fullpel_search_fn
    from uvg266_jax.ops.me_frame import extract_pred_tiles, tile_ssd_maps
    r, T = 4, 6
    s = 8 + 2 * r
    f32 = np.zeros((T, s, s), np.float32)
    if which == "fullpel":
        return jax.make_jaxpr(make_fullpel_search_fn(8, 8, r))(
            np.zeros((T, s, s), np.int32), np.zeros((T, 8, 8), np.int32),
            np.zeros((2 * r + 1, 2 * r + 1), np.float32))
    if which == "tile_ssd_maps":
        return jax.make_jaxpr(lambda a, b: tile_ssd_maps(jax, jnp, a, b, r))(
            np.zeros((T, 1, 8, 8), np.float32), f32)
    return jax.make_jaxpr(lambda a, b, c: extract_pred_tiles(jnp, a, b, c, r))(
        f32, np.zeros(T, np.int32), np.zeros(T, np.int32))


@pytest.mark.parametrize("which", ["fullpel", "tile_ssd_maps",
                                   "extract_pred_tiles"])
def test_me_programs_pin_highest_precision(which):
    from jax.lax import Precision
    found = _conv_dot_precisions(_me_jaxpr(which).jaxpr)
    assert found, "no conv/dot in the program"
    for name, prec in found:
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(p == Precision.HIGHEST for p in precs), (name, prec)


# --- (b) every parity check passes on the CPU at a small size ----------------

SMALL_CLASSES = ((8, 8, (0, 0, 8, 8, 16, 8)),
                 (16, 16, (0, 0, 16, 16, 8, 4)),
                 (16, 8, (0, 0, 16, 8, 8, 8)))


@pytest.fixture(scope="module")
def small_ctx():
    return chip_smoke.Ctx(128, 64, SMALL_CLASSES, n_sample=6)


@pytest.mark.parametrize("name", sorted(chip_smoke.PARITY))
def test_parity_check_passes_on_cpu(small_ctx, name):
    stats = chip_smoke.PARITY[name](small_ctx)
    assert stats and all(v > 0 for v in stats.values())


def test_check_choice_separates_near_ties_from_errors():
    ctx = chip_smoke.Ctx(16, 16, (), n_sample=1)
    costs = np.array([10.0, 10.0 + 5e-6, 11.0], np.float32)
    chip_smoke.check_choice(ctx, 1, costs, "tie")
    assert ctx.near_ties == 1
    with pytest.raises(chip_smoke.ParityError):
        chip_smoke.check_choice(ctx, 2, costs, "wrong")


def test_parity_check_catches_a_wrong_rd_cost(small_ctx):
    from uvg266_jax.control.encoder import _MODE_BITS
    w, h, grid = SMALL_CLASSES[0]
    best = np.zeros(grid[4] * grid[5], np.int32)
    ls = np.sqrt(np.float32(small_ctx.lam))
    for k, _blk, _p, satds in chip_smoke.golden_intra(small_ctx, w, h, grid):
        best[k] = int(np.argmin(satds.astype(np.float32) + ls * _MODE_BITS))
    with pytest.raises(chip_smoke.ParityError, match="rd"):
        chip_smoke.check_intra_results(small_ctx, w, h, grid, best,
                                       np.full(best.shape, 1.0, np.float32),
                                       "rd")


# --- (c) chip_smoke refuses the CPU backend ----------------------------------

def test_chip_smoke_refuses_cpu_backend(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rc = chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    assert lines and json.loads(lines[-1]).get("ok") is not True


# --- (d) compile-cache location ----------------------------------------------

def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax
    from uvg266_jax.compile_cache import enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    import jax
    from uvg266_jax.compile_cache import enable_compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == prev


# --- (e) the CLI selects no device and leaves jax_platforms alone ------------

def _tiny_yuv(tmp_path):
    path = tmp_path / "in.yuv"
    chip_smoke.write_yuv(str(path), chip_smoke.synth_frames(64, 64, 1))
    return str(path)


def test_encode_has_no_platform_option(capsys):
    """The device is JAX's default backend (JAX_PLATFORMS=cpu asks for
    the CPU): no CLI option selects a platform."""
    from uvg266_jax.tools.encode import main
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    assert "--verify" in text
    assert "platform" not in text.lower()


def test_encode_leaves_jax_platforms_alone(tmp_path, monkeypatch):
    import jax
    from uvg266_jax.tools.encode import main
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    keys = []
    real = jax.config.update

    def spy(name, value):
        keys.append(name)
        return real(name, value)

    monkeypatch.setattr(jax.config, "update", spy)
    assert main(["-i", _tiny_yuv(tmp_path), "--input-res", "64x64",
                 "-o", str(tmp_path / "o.vvc"), "-p", "1", "-q", "32",
                 "--no-psnr"]) == 0
    assert "jax_platforms" not in keys
