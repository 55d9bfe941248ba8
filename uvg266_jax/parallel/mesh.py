"""Mesh-sharded phase-1 encoder search: the REAL encoder over N chips.

The encoder's two-phase design (SURVEY.md §7) makes multi-chip scaling a
data-layout problem: phase 1 (the batched CU search — all the FLOPs) is
embarrassingly parallel over CUs and frames, and phase 2 (CABAC finalize)
is already split into per-tile substreams. This module shards phase 1
over a ('gop', 'tile') jax.sharding.Mesh:

- 'tile' axis: each frame's CU batch is partitioned by the tile the CU
  lives in (the uvg266 tiles analogue — encoder.c tile geometry). The
  source plane is replicated within a 'gop' group; each device searches
  only its own tile's CUs. Because tiles break prediction at their
  boundaries in the bitstream anyway, no halo exchange is needed for the
  search. Per-frame RD stats are reduced with a psum over 'tile' and
  feed the rate-control model.
- 'gop' axis: data-parallel over frames (the OWF frame-pipelining
  analogue, encoderstate.c owf): several frames' searches run in the
  same dispatch.

Phase 1b/2 (finalize + entropy) stay on host per frame and reuse the
existing tile-substream writer, so the output bitstream is byte-identical
to the single-device tiles encode — asserted by tests/test_multichip.py
and `chip_smoke.py --four`. Every device reaches every other at the same
rate, so the mesh shape follows the algorithm (gop x tile) alone.
"""
from __future__ import annotations

import numpy as np

from ..consts import LCU_WIDTH


def tile_grid_for(n_tiles: int) -> tuple[int, int]:
    """Near-square (cols, rows) tile grid with cols*rows == n_tiles."""
    best = (n_tiles, 1)
    for rows in range(1, int(n_tiles ** 0.5) + 1):
        if n_tiles % rows == 0:
            best = (n_tiles // rows, rows)
    return best


def build_mesh(n_devices: int, n_gop: int | None = None):
    """('gop', 'tile') mesh over the first n_devices jax devices."""
    import jax
    from jax.sharding import Mesh

    if n_gop is None:
        n_gop = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    n_tile = n_devices // n_gop
    devices = np.array(jax.devices()[:n_gop * n_tile]).reshape(
        n_gop, n_tile)
    return Mesh(devices, axis_names=("gop", "tile"))


class MeshEncoder:
    """Encode frames with the phase-1 search sharded over a device mesh.

    cfg must use a tile grid whose tile count equals the mesh 'tile'
    axis size (each device searches exactly one tile's CUs); the 'gop'
    axis batches that many frames per dispatch. All-intra only for now
    (inter DPB dependencies serialize frames; the 'gop' axis would carry
    closed GOPs instead).
    """

    def __init__(self, cfg, mesh):
        from ..control.encoder import Encoder

        self.mesh = mesh
        self.n_gop = mesh.shape["gop"]
        self.n_tile = mesh.shape["tile"]
        n_tiles = cfg.tiles_width_count * cfg.tiles_height_count
        if n_tiles != self.n_tile:
            raise ValueError(
                f"cfg tile grid ({n_tiles} tiles) must match the mesh "
                f"'tile' axis ({self.n_tile})")
        if cfg.gop_len != 0 or cfg.intra_period > 1:
            raise ValueError("MeshEncoder is all-intra (gop 0)")
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.ctrl = self.enc.ctrl
        self._fns: dict = {}
        self._classes = None
        self.frame_rd_stats: list[float] = []   # psum'd per-frame RD cost

    # --- geometry ---------------------------------------------------------

    def _tile_of(self, x: int, y: int) -> int:
        return self.ctrl.tile_index_of_ctu(x // LCU_WIDTH, y // LCU_WIDTH)

    def _search_classes(self):
        """Shape classes of the partition search with per-tile grouped,
        padded position arrays (shared by every frame: same geometry)."""
        if self._classes is not None:
            return self._classes
        from ..control.partition import PartitionSearch

        ps = PartitionSearch(self.ctrl, self.cfg, qp=self.cfg.qp)
        classes = []
        entries = []
        for (w, h) in ps._shapes():
            positions, gw, gh = ps._positions(max(w, h), w, h)
            entries.append((("shape", w, h, gw, gh), w, h, positions))
        for s in ps.tt_parents:
            for vert in (False, True):
                w, h = ((s >> 1), s) if vert else (s, (s >> 1))
                positions = ps._tt_mid_positions(s, vert)
                if positions:
                    entries.append((("tt", s, vert), w, h, positions))
        for key, w, h, positions in entries:
            by_tile = [[] for _ in range(self.n_tile)]
            for k, (x, y) in enumerate(positions):
                by_tile[self._tile_of(x, y)].append(k)
            bmax = max((len(g) for g in by_tile), default=0)
            if bmax == 0:
                continue
            xs = np.zeros((self.n_tile, bmax), dtype=np.int32)
            ys = np.zeros((self.n_tile, bmax), dtype=np.int32)
            mask = np.zeros((self.n_tile, bmax), dtype=np.float32)
            for t, grp in enumerate(by_tile):
                for j, k in enumerate(grp):
                    xs[t, j] = positions[k][0]
                    ys[t, j] = positions[k][1]
                    mask[t, j] = 1.0
            classes.append({"key": key, "w": w, "h": h,
                            "positions": positions, "by_tile": by_tile,
                            "xs": xs, "ys": ys, "mask": mask})
        self._classes = (ps, classes)
        return self._classes

    # --- sharded kernels --------------------------------------------------

    def _sharded_fn(self, w: int, h: int):
        """shard_map'd fused search for one block shape:
        (src [G,H,W], xs/ys/mask [G,T,B], qp/lam [G], wts [G,4])
        -> best [G,T,B], rd [G,T,B], (mip_best, mip_cost | zeros),
           frame_rd [G] (psum over 'tile').
        Identical math to SliceEncoder.dispatch_blocks, so decisions are
        bit-identical to the single-device encode."""
        key = (w, h)
        if key in self._fns:
            return self._fns[key]
        import jax
        import jax.numpy as jnp
        try:
            from jax import shard_map
        except ImportError:             # older jax
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        from ..ops.intra_batch import (build_mode_tables, make_predict_fn,
                                       make_refs_blocks_fn)
        from ..ops.rd_cost import make_rd_cost_fn, make_rough_refine_fn
        from ..control.encoder import _MODE_BITS

        bitdepth = self.ctrl.bitdepth
        tables = build_mode_tables(w, h, bitdepth, False)
        gather = make_refs_blocks_fn(w, h)
        # the same mode-search core as dispatch_blocks (incl. the
        # rough+refine flag) so decisions stay bit-identical
        if getattr(self.cfg, "intra_rough", False):
            rd_all = make_rough_refine_fn(w, h, bitdepth)

            def search_core(refs, blocks, qp, lam, wts, mode_bits):
                return rd_all(refs, blocks, qp, lam, wts, mode_bits)
        else:
            predict = make_predict_fn(tables)
            rd = make_rd_cost_fn(w, h, bitdepth)

            def search_core(refs, blocks, qp, lam, wts, mode_bits):
                return rd(predict(refs), blocks, qp, lam, wts, mode_bits)
        mode_bits = jnp.asarray(_MODE_BITS)
        use_mip = bool(self.cfg.mip)
        if use_mip:
            from ..ops.mip import make_mip_preds_fn, mip_mode_count
            from ..ops.rd_cost import make_rd_cost_pred_fn
            mip_fn = make_mip_preds_fn(w, h, bitdepth)
            n_cand = 2 * mip_mode_count(w, h)
            mip_bits = jnp.full((n_cand,), 6.0, dtype=jnp.float32)

        if use_mip:
            from ..ops.rd_cost import make_rd_cost_fn as _mk_rd
            rd_mip = _mk_rd(w, h, bitdepth)

        def body(src, xs, ys, mask, qp, lam, wts):
            s, x, y, m = src[0], xs[0, 0], ys[0, 0], mask[0, 0]
            refs, blocks = gather(s, x, y)
            best, rdc, _ = search_core(refs, blocks, qp[0], lam[0],
                                       wts[0], mode_bits)
            frame_rd = jax.lax.psum(jnp.sum(rdc * m), "tile")
            if not use_mip:
                return (best[None, None], rdc[None, None], frame_rd[None])
            # MIP candidates scored with the same rd model; merged on
            # host exactly like dispatch_blocks.resolve
            preds = mip_fn(s, x, y)
            mbest, mcost, _ = rd_mip(preds, blocks, qp[0], lam[0],
                                     wts[0], mip_bits)
            return (best[None, None], rdc[None, None],
                    mbest[None, None], mcost[None, None], frame_rd[None])

        out_specs = (P("gop", "tile"), P("gop", "tile"), P("gop")) \
            if not use_mip else \
            (P("gop", "tile"), P("gop", "tile"),
             P("gop", "tile"), P("gop", "tile"), P("gop"))
        fn = jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(P("gop", None, None), P("gop", "tile", None),
                      P("gop", "tile", None), P("gop", "tile", None),
                      P("gop"), P("gop"), P("gop", None)),
            out_specs=out_specs))
        self._fns[key] = fn
        return fn

    # --- frame batch search ----------------------------------------------

    def _search_batch(self, qps: list[int], srcs_y: list[np.ndarray]):
        """Sharded phase-1 search for a batch of frames (len == n_gop).
        Returns (ctus_per_frame, frame_rd_stats)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..control.encoder import _fetch_all  # noqa: F401 (doc link)
        from ..control.partition import INF, PartitionSearch, qp_to_lambda
        from ..ops.fast_cost_tables import FAST_COEFF_WTS

        G = self.n_gop
        assert len(srcs_y) == G == len(qps)
        ps0, classes = self._search_classes()
        src = np.stack([s.astype(np.int32) for s in srcs_y])
        src_dev = jax.device_put(
            src, NamedSharding(self.mesh, P("gop", None, None)))
        qp_arr = np.asarray(
            [self.ctrl.luma_qp_scaled(q) for q in qps], dtype=np.int32)
        lam_arr = np.asarray([qp_to_lambda(q) for q in qps],
                             dtype=np.float32)
        wts_arr = np.stack(
            [np.asarray(FAST_COEFF_WTS[min(q, len(FAST_COEFF_WTS) - 1)],
                        dtype=np.float32) for q in qps])

        pend = []
        for cl in classes:
            fn = self._sharded_fn(cl["w"], cl["h"])
            xs = np.broadcast_to(cl["xs"], (G,) + cl["xs"].shape)
            ys = np.broadcast_to(cl["ys"], (G,) + cl["ys"].shape)
            mk = np.broadcast_to(cl["mask"], (G,) + cl["mask"].shape)
            pend.append((cl, fn(src_dev, xs, ys, mk, qp_arr, lam_arr,
                                wts_arr)))

        if self.cfg.mip:
            from ..ops.mip import mip_mode_count

        # reassemble per frame in original position order
        cost_f = [dict() for _ in range(G)]
        mode_f = [dict() for _ in range(G)]
        frame_rd = np.zeros(G, dtype=np.float64)
        for cl, outs in pend:
            outs = [np.asarray(o) for o in outs]
            if self.cfg.mip:
                best_a, rd_a, mbest_a, mcost_a, frd = outs
                n_modes = mip_mode_count(cl["w"], cl["h"])
            else:
                best_a, rd_a, frd = outs
            frame_rd += frd
            npos = len(cl["positions"])
            for g in range(G):
                descs = [None] * npos
                costs = np.empty(npos, dtype=np.float64)
                for t, grp in enumerate(cl["by_tile"]):
                    for j, k in enumerate(grp):
                        c = float(rd_a[g, t, j])
                        d = {"type": "intra",
                             "mode": int(best_a[g, t, j]), "tr_idx": 0}
                        if self.cfg.mip and mcost_a[g, t, j] < c:
                            c = float(mcost_a[g, t, j])
                            mi = int(mbest_a[g, t, j])
                            d = {"type": "intra", "mode": mi % n_modes,
                                 "mip": True, "mip_t": mi >= n_modes,
                                 "tr_idx": 0}
                        descs[k] = d
                        costs[k] = c
                key = cl["key"]
                if key[0] == "shape":
                    _kind, w, h, gw, gh = key
                    c = np.full((gh, gw), INF)
                    m = {}
                    for k, (x, y) in enumerate(cl["positions"]):
                        c[y // h, x // w] = costs[k]
                        m[(x, y)] = descs[k]
                    cost_f[g][(w, h)] = c
                    mode_f[g][(w, h)] = m
                else:
                    _kind, s, vert = key
                    ps0._store_tt(cost_f[g], mode_f[g], s, vert,
                                  cl["positions"], descs, costs)

        ctus = []
        for g in range(G):
            psg = PartitionSearch(self.ctrl, self.cfg, qp=qps[g])
            ctus.append(psg._decide(cost_f[g], mode_f[g]))
        return ctus, frame_rd

    # --- public API -------------------------------------------------------

    def encode(self, frames: list) -> list[tuple[bytes, object]]:
        """Encode frames (FramePlanes, display order). Batches of n_gop
        frames share one sharded search dispatch; finalize/entropy run
        per frame on host through the standard tile-substream path.
        Returns [(au_bytes, recon), ...]."""
        from ..control.encoder import pad_plane

        out = []
        w, h = self.ctrl.in_width, self.ctrl.in_height
        i = 0
        while i < len(frames):
            batch = frames[i:i + self.n_gop]
            # ragged tail: encode leftover frames with a full batch by
            # repeating the last frame; surplus results are dropped
            pad_n = self.n_gop - len(batch)
            searched = batch + [batch[-1]] * pad_n
            qp = self.cfg.qp
            srcs_y = [pad_plane(f.y, w, h) for f in searched]
            ctus_b, frame_rd = self._search_batch([qp] * self.n_gop,
                                                  srcs_y)
            for f, ctus, frd in zip(batch, ctus_b, frame_rd):
                au, rec, fs, _refs = self.enc.encode_frame(
                    self.enc.feed_count, f,
                    prefetch=lambda c=ctus: c)
                self.enc.feed_count += 1
                self.frame_rd_stats.append(float(frd))
                out.append((au, rec))
            i += self.n_gop
        return out


# --- closed-GOP inter sharding ----------------------------------------------

def build_gop_mesh(n_devices: int):
    """1-D ('gop',) mesh: each device owns one closed-GOP frame run."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n_devices]), axis_names=("gop",))


class _MeshGroupDispatch:
    """Lockstep group dispatcher for per-GOP encoder workers: each
    worker's source-only device request (intra screening / pseudo-recon
    combo) parks on a barrier; the last arriver stacks the G argument
    sets and runs ONE shard_map'd call over the 'gop' mesh, then every
    worker takes its shard slice. Divergent request keys (or a barrier
    timeout) fall back to per-worker unsharded dispatches — results are
    bit-identical either way (same math per shard)."""

    TIMEOUT_S = 600.0

    def __init__(self, mesh, n_slots: int):
        import threading

        self.mesh = mesh
        self.G = n_slots
        self.barrier = threading.Barrier(n_slots)
        self.slots: list = [None] * n_slots
        self.result = None
        self._fns: dict = {}
        self.sharded_calls = 0      # group calls that ran sharded
        self.errors: list = []      # why a group call fell back

    def _sharded_fn(self, key):
        if key in self._fns:
            return self._fns[key]
        import jax
        try:
            from jax import shard_map
        except ImportError:
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        from ..control.encoder import _JIT_CACHE, _MODE_BITS
        if key[0] == "pframe_intra":
            rawkey = key + ("raw",)
        else:                                   # ("frame_intra", classes, bd)
            rawkey = ("frame_combo", key[1], key[2], "raw")
        combo, A_hosts = _JIT_CACHE[rawkey]

        def body(src, As, qps, lams, wtss):
            return combo(src[0], As, qps[0], lams[0], wtss[0],
                         _MODE_BITS)[None]

        fn = jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(P("gop", None, None), P(), P("gop"), P("gop"),
                      P("gop", None)),
            out_specs=P("gop", None)))
        self._fns[key] = (fn, A_hosts)
        return self._fns[key]

    def run(self, slot: int, key, args, fallback):
        """args: (src_narrow [H, W], qp_scaled i32, lam f32, wts [4]).
        Returns this slot's flat result vector (numpy)."""
        import threading

        self.slots[slot] = (key, args)
        try:
            idx = self.barrier.wait(timeout=self.TIMEOUT_S)
        except threading.BrokenBarrierError:
            self.errors.append("barrier broken before the group call")
            return fallback()
        if idx == 0:
            keys = {k for (k, _a) in self.slots}
            if len(keys) != 1:
                self.errors.append("divergent group keys")
                self.result = None
            else:
                try:
                    fn, A_hosts = self._sharded_fn(key)
                    src = np.stack([a[0] for (_k, a) in self.slots])
                    qps = np.asarray([a[1] for (_k, a) in self.slots],
                                     dtype=np.int32)
                    lams = np.asarray([a[2] for (_k, a) in self.slots],
                                      dtype=np.float32)
                    wtss = np.stack([a[3] for (_k, a) in self.slots]) \
                        .astype(np.float32)
                    self.result = np.asarray(
                        fn(src, A_hosts, qps, lams, wtss))
                    self.sharded_calls += 1
                except Exception as e:      # reported through self.errors
                    self.errors.append(repr(e))
                    self.result = None
        try:
            self.barrier.wait(timeout=self.TIMEOUT_S)
        except threading.BrokenBarrierError:
            self.errors.append("barrier broken after the group call")
            return fallback()
        r = self.result
        if r is None:
            return fallback()
        return r[slot]


class MeshGopEncoder:
    """Closed-GOP data-parallel encoder over a 1-D ('gop',) mesh
    (SURVEY §5 "closed GOPs are embarrassingly parallel"): the input
    sequence splits into per-device IDR-led runs; each run is driven by
    a full Encoder (LD or RA reordering, per-frame GOP QP offsets) on
    its own host thread, so ME + finalize + filters +
    entropy parallelize across host cores (the C++ phases release the
    GIL), while every device-phase request (the source-only intra
    screening with on-device pseudo-recon) rides ONE shard_map'd
    dispatch across all runs. Output is byte-identical to encoding each
    run with a plain single-device Encoder (tests/test_multichip.py)."""

    def __init__(self, cfg, mesh):
        from ..control.encoder import Encoder

        self.cfg = cfg
        self.mesh = mesh
        self.G = mesh.shape["gop"]
        self.disp = _MeshGroupDispatch(mesh, self.G)
        self.encs = []
        for g in range(self.G):
            e = Encoder(cfg)
            e.slice_enc._mesh_dispatch = self.disp
            e.slice_enc._mesh_slot = g
            self.encs.append(e)

    def encode(self, frames: list) -> list[list]:
        """frames: display order, length divisible by the mesh size.
        Returns per-GOP result lists ([(au, rec, fs, refs, src), ...])
        in sequence order; concatenating the per-GOP AUs yields the
        multi-IDR stream."""
        from concurrent.futures import ThreadPoolExecutor

        n = len(frames)
        if n % self.G:
            raise ValueError(f"{n} frames not divisible into {self.G} "
                             f"equal closed-GOP runs")
        L = n // self.G
        chunks = [frames[g * L:(g + 1) * L] for g in range(self.G)]

        def work(g):
            outs = []
            for f in chunks[g]:
                outs.extend(self.encs[g].feed(f))
            outs.extend(self.encs[g].flush())
            return outs

        with ThreadPoolExecutor(self.G) as ex:
            return list(ex.map(work, range(self.G)))
