// Whole-frame native inter finalize: the sequential phase-1b of P/B
// frames in one C++ call (the role of the reference's per-LCU worker,
// encoderstate.c:734-860, at whole-frame granularity).
//
// Mirrors the Python path bit-exactly (asserted stream-identical in
// tests/test_inter_native.py):
// - quarter-pel refine: control/encoder.py _refine_inter_leaves +
//   ops/me_frame.py make_leaf_qpel_fn (49-offset SATD grid; reference
//   analogue: search_inter.c search_frac:1029)
// - merge/AMVP/HMVP/TMVP derivation: control/inter_cand.py (reference:
//   inter.c:1989 uvg_inter_get_merge_cand, :1606
//   get_mv_cand_from_candidates, :1878 uvg_hmvp_add_mv, :1031
//   get_temporal_merge_candidates)
// - merge-mode SATD screening + AMVP mvd-bit choice:
//   control/encoder.py _finalize_sequential (reference:
//   search_inter.c:1730-1845 merge analysis + early skip)
// - MC: ops/inter.py mc_luma/mc_chroma/_hi/bi (reference:
//   strategies/generic/ipol-generic.c:134,681, uvg_g_luma_filter)
// - residual round-trip: recon.cpp transform_quant_recon (reference:
//   quant-generic.c:460)
// - intra CUs inside inter frames: recon.cpp recon_intra_leaf
//
// Outputs arrive pre-packed in the tree.cpp 20-int32 leaf layout
// (native/__init__.py pack_frame_leaves) plus the per-4x4 deblock maps
// and the TMVP motion-field snapshot (inter_cand.build_motion_field),
// so the Python side does no per-CU work at all.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "recon_shared.h"

namespace {

constexpr int LCU = 64;
constexpr int MAX_HMVP = 5;
constexpr int MAX_CAND = 8;     // merge list <= 6, amvp 2

const int32_t LUMA_FILTER[16][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},    {0, 1, -3, 63, 4, -2, 1, 0},
    {-1, 2, -5, 62, 8, -3, 1, 0}, {-1, 3, -8, 60, 13, -4, 1, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0}, {-1, 4, -11, 52, 26, -8, 3, -1},
    {-1, 3, -9, 47, 31, -10, 4, -1}, {-1, 4, -11, 45, 34, -10, 4, -1},
    {-1, 4, -11, 40, 40, -11, 4, -1}, {-1, 4, -10, 34, 45, -11, 4, -1},
    {-1, 4, -10, 31, 47, -9, 3, -1}, {-1, 3, -8, 26, 52, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}, {0, 1, -4, 13, 60, -8, 3, -1},
    {0, 1, -3, 8, 62, -5, 2, -1},  {0, 1, -2, 4, 63, -3, 1, 0}};

const int32_t CHROMA_FILTER[32][4] = {
    {0, 64, 0, 0},   {-1, 63, 2, 0},  {-2, 62, 4, 0},  {-2, 60, 7, -1},
    {-2, 58, 10, -2}, {-3, 57, 12, -2}, {-4, 56, 14, -2}, {-4, 55, 15, -2},
    {-4, 54, 16, -2}, {-5, 53, 18, -2}, {-6, 52, 20, -2}, {-6, 49, 24, -3},
    {-6, 46, 28, -4}, {-5, 44, 29, -4}, {-4, 42, 30, -4}, {-4, 39, 33, -4},
    {-4, 36, 36, -4}, {-4, 33, 39, -4}, {-4, 30, 42, -4}, {-4, 29, 44, -5},
    {-4, 28, 46, -6}, {-3, 24, 49, -6}, {-2, 20, 52, -6}, {-2, 18, 53, -5},
    {-2, 16, 54, -4}, {-2, 15, 55, -4}, {-2, 14, 56, -4}, {-2, 12, 57, -3},
    {-2, 10, 58, -2}, {-1, 7, 60, -2}, {0, 4, 62, -2},  {0, 2, 63, -1}};

inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// --- motion compensation (ops/inter.py parity) ---------------------------

// edge-replicating fetch (uvg_get_extended_block)
inline void fetch_ext(const int32_t* plane, int pw, int ph, int bx, int by,
                      int bw, int bh, int pl, int pt, int pr, int pb,
                      int32_t* out, int ostride) {
    for (int yy = 0; yy < bh + pt + pb; ++yy) {
        int sy = iclip(by - pt + yy, 0, ph - 1);
        const int32_t* row = plane + (int64_t)sy * pw;
        int32_t* orow = out + (int64_t)yy * ostride;
        for (int xx = 0; xx < bw + pl + pr; ++xx)
            orow[xx] = row[iclip(bx - pl + xx, 0, pw - 1)];
    }
}

// mc_luma: mv in 1/16-pel; out h*w clipped samples
void mc_luma(const int32_t* ref, int pw, int ph, int x, int y, int w, int h,
             int mvx, int mvy, int bd, int32_t* out) {
    int ix = x + (mvx >> 4), iy = y + (mvy >> 4);
    int fx = mvx & 15, fy = mvy & 15;
    int max_pix = (1 << bd) - 1;
    if (fx == 0 && fy == 0) {
        fetch_ext(ref, pw, ph, ix, iy, w, h, 0, 0, 0, 0, out, w);
        return;
    }
    std::vector<int32_t> ext((h + 7) * (w + 7));
    fetch_ext(ref, pw, ph, ix, iy, w, h, 3, 3, 4, 4, ext.data(), w + 7);
    const int32_t* hf = LUMA_FILTER[fx];
    const int32_t* vf = LUMA_FILTER[fy];
    int shift1 = bd - 8;
    std::vector<int64_t> hor((h + 7) * w);
    for (int yy = 0; yy < h + 7; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            const int32_t* p = ext.data() + yy * (w + 7) + xx;
            for (int t = 0; t < 8; ++t) s += (int64_t)hf[t] * p[t];
            hor[yy * w + xx] = s >> shift1;
        }
    int wp_shift = 14 - bd;
    for (int yy = 0; yy < h; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            for (int t = 0; t < 8; ++t) s += (int64_t)vf[t] * hor[(yy + t) * w + xx];
            s >>= 6;
            s = (s + (1 << (wp_shift - 1))) >> wp_shift;
            out[yy * w + xx] = iclip((int)s, 0, max_pix);
        }
}

// 14-bit intermediate (no round/clip) for bipred averaging
void mc_luma_hi(const int32_t* ref, int pw, int ph, int x, int y, int w,
                int h, int mvx, int mvy, int bd, int64_t* out) {
    int ix = x + (mvx >> 4), iy = y + (mvy >> 4);
    int fx = mvx & 15, fy = mvy & 15;
    if (fx == 0 && fy == 0) {
        std::vector<int32_t> px(w * h);
        fetch_ext(ref, pw, ph, ix, iy, w, h, 0, 0, 0, 0, px.data(), w);
        for (int i = 0; i < w * h; ++i) out[i] = (int64_t)px[i] << (14 - bd);
        return;
    }
    std::vector<int32_t> ext((h + 7) * (w + 7));
    fetch_ext(ref, pw, ph, ix, iy, w, h, 3, 3, 4, 4, ext.data(), w + 7);
    const int32_t* hf = LUMA_FILTER[fx];
    const int32_t* vf = LUMA_FILTER[fy];
    int shift1 = bd - 8;
    std::vector<int64_t> hor((h + 7) * w);
    for (int yy = 0; yy < h + 7; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            const int32_t* p = ext.data() + yy * (w + 7) + xx;
            for (int t = 0; t < 8; ++t) s += (int64_t)hf[t] * p[t];
            hor[yy * w + xx] = s >> shift1;
        }
    for (int yy = 0; yy < h; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            for (int t = 0; t < 8; ++t) s += (int64_t)vf[t] * hor[(yy + t) * w + xx];
            out[yy * w + xx] = s >> 6;
        }
}

void mc_luma_bi(const int32_t* r0, const int32_t* r1, int pw, int ph,
                int x, int y, int w, int h, int mv0x, int mv0y,
                int mv1x, int mv1y, int bd, int32_t* out) {
    std::vector<int64_t> a(w * h), b(w * h);
    mc_luma_hi(r0, pw, ph, x, y, w, h, mv0x, mv0y, bd, a.data());
    mc_luma_hi(r1, pw, ph, x, y, w, h, mv1x, mv1y, bd, b.data());
    int shift = 15 - bd, max_pix = (1 << bd) - 1;
    for (int i = 0; i < w * h; ++i) {
        int64_t s = (a[i] + b[i] + (1 << (shift - 1))) >> shift;
        out[i] = iclip((int)s, 0, max_pix);
    }
}

// mv in 1/16-pel LUMA units (= 1/32-pel chroma); x/y/w/h in chroma samples
void mc_chroma(const int32_t* ref, int pw, int ph, int x, int y, int w,
               int h, int mvx, int mvy, int bd, int32_t* out) {
    int ix = x + (mvx >> 5), iy = y + (mvy >> 5);
    int fx = mvx & 31, fy = mvy & 31;
    int max_pix = (1 << bd) - 1;
    if (fx == 0 && fy == 0) {
        fetch_ext(ref, pw, ph, ix, iy, w, h, 0, 0, 0, 0, out, w);
        return;
    }
    std::vector<int32_t> ext((h + 3) * (w + 3));
    fetch_ext(ref, pw, ph, ix, iy, w, h, 1, 1, 2, 2, ext.data(), w + 3);
    const int32_t* hf = CHROMA_FILTER[fx];
    const int32_t* vf = CHROMA_FILTER[fy];
    int shift1 = bd - 8;
    std::vector<int64_t> hor((h + 3) * w);
    for (int yy = 0; yy < h + 3; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            const int32_t* p = ext.data() + yy * (w + 3) + xx;
            for (int t = 0; t < 4; ++t) s += (int64_t)hf[t] * p[t];
            hor[yy * w + xx] = s >> shift1;
        }
    int wp_shift = 14 - bd;
    for (int yy = 0; yy < h; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            for (int t = 0; t < 4; ++t) s += (int64_t)vf[t] * hor[(yy + t) * w + xx];
            s >>= 6;
            s = (s + (1 << (wp_shift - 1))) >> wp_shift;
            out[yy * w + xx] = iclip((int)s, 0, max_pix);
        }
}

void mc_chroma_hi(const int32_t* ref, int pw, int ph, int x, int y, int w,
                  int h, int mvx, int mvy, int bd, int64_t* out) {
    int ix = x + (mvx >> 5), iy = y + (mvy >> 5);
    int fx = mvx & 31, fy = mvy & 31;
    if (fx == 0 && fy == 0) {
        std::vector<int32_t> px(w * h);
        fetch_ext(ref, pw, ph, ix, iy, w, h, 0, 0, 0, 0, px.data(), w);
        for (int i = 0; i < w * h; ++i) out[i] = (int64_t)px[i] << (14 - bd);
        return;
    }
    std::vector<int32_t> ext((h + 3) * (w + 3));
    fetch_ext(ref, pw, ph, ix, iy, w, h, 1, 1, 2, 2, ext.data(), w + 3);
    const int32_t* hf = CHROMA_FILTER[fx];
    const int32_t* vf = CHROMA_FILTER[fy];
    int shift1 = bd - 8;
    std::vector<int64_t> hor((h + 3) * w);
    for (int yy = 0; yy < h + 3; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            const int32_t* p = ext.data() + yy * (w + 3) + xx;
            for (int t = 0; t < 4; ++t) s += (int64_t)hf[t] * p[t];
            hor[yy * w + xx] = s >> shift1;
        }
    for (int yy = 0; yy < h; ++yy)
        for (int xx = 0; xx < w; ++xx) {
            int64_t s = 0;
            for (int t = 0; t < 4; ++t) s += (int64_t)vf[t] * hor[(yy + t) * w + xx];
            out[yy * w + xx] = s >> 6;
        }
}

void mc_chroma_bi(const int32_t* r0, const int32_t* r1, int pw, int ph,
                  int x, int y, int w, int h, int mv0x, int mv0y,
                  int mv1x, int mv1y, int bd, int32_t* out) {
    std::vector<int64_t> a(w * h), b(w * h);
    mc_chroma_hi(r0, pw, ph, x, y, w, h, mv0x, mv0y, bd, a.data());
    mc_chroma_hi(r1, pw, ph, x, y, w, h, mv1x, mv1y, bd, b.data());
    int shift = 15 - bd, max_pix = (1 << bd) - 1;
    for (int i = 0; i < w * h; ++i) {
        int64_t s = (a[i] + b[i] + (1 << (shift - 1))) >> shift;
        out[i] = iclip((int)s, 0, max_pix);
    }
}

// --- SATD (ops/cost.py parity: satd_any_size_generic) --------------------

// 8x8 Hadamard butterfly (== H @ d @ H for the natural-order H matrix)
inline int64_t satd8_block(const int32_t* d, int stride) {
    int32_t m[8][8];
    for (int i = 0; i < 8; ++i) {
        const int32_t* r = d + i * stride;
        int32_t a0 = r[0] + r[4], a1 = r[1] + r[5], a2 = r[2] + r[6],
                a3 = r[3] + r[7];
        int32_t b0 = r[0] - r[4], b1 = r[1] - r[5], b2 = r[2] - r[6],
                b3 = r[3] - r[7];
        int32_t c0 = a0 + a2, c1 = a1 + a3, c2 = a0 - a2, c3 = a1 - a3;
        int32_t d0 = b0 + b2, d1 = b1 + b3, d2 = b0 - b2, d3 = b1 - b3;
        m[i][0] = c0 + c1; m[i][1] = c0 - c1;
        m[i][2] = c2 + c3; m[i][3] = c2 - c3;
        m[i][4] = d0 + d1; m[i][5] = d0 - d1;
        m[i][6] = d2 + d3; m[i][7] = d2 - d3;
    }
    int64_t sum = 0;
    int32_t dc = 0;
    for (int j = 0; j < 8; ++j) {
        int32_t a0 = m[0][j] + m[4][j], a1 = m[1][j] + m[5][j],
                a2 = m[2][j] + m[6][j], a3 = m[3][j] + m[7][j];
        int32_t b0 = m[0][j] - m[4][j], b1 = m[1][j] - m[5][j],
                b2 = m[2][j] - m[6][j], b3 = m[3][j] - m[7][j];
        int32_t c0 = a0 + a2, c1 = a1 + a3, c2 = a0 - a2, c3 = a1 - a3;
        int32_t d0 = b0 + b2, d1 = b1 + b3, d2 = b0 - b2, d3 = b1 - b3;
        int32_t v0 = c0 + c1, v1 = c0 - c1, v2 = c2 + c3, v3 = c2 - c3;
        int32_t v4 = d0 + d1, v5 = d0 - d1, v6 = d2 + d3, v7 = d2 - d3;
        if (j == 0) dc = v0 < 0 ? -v0 : v0;
        sum += (v0 < 0 ? -v0 : v0) + (v1 < 0 ? -v1 : v1)
             + (v2 < 0 ? -v2 : v2) + (v3 < 0 ? -v3 : v3)
             + (v4 < 0 ? -v4 : v4) + (v5 < 0 ? -v5 : v5)
             + (v6 < 0 ? -v6 : v6) + (v7 < 0 ? -v7 : v7);
    }
    // DC down-weighting (picture-generic.c:341-344)
    sum = sum - dc + (dc >> 2);
    return (sum + 2) >> 2;
}

inline int64_t satd4_block(const int32_t* d, int stride) {
    int32_t m[4][4];
    for (int i = 0; i < 4; ++i) {
        const int32_t* r = d + i * stride;
        int32_t a0 = r[0] + r[2], a1 = r[1] + r[3];
        int32_t b0 = r[0] - r[2], b1 = r[1] - r[3];
        m[i][0] = a0 + a1; m[i][1] = a0 - a1;
        m[i][2] = b0 + b1; m[i][3] = b0 - b1;
    }
    int64_t sum = 0;
    int32_t dc = 0;
    for (int j = 0; j < 4; ++j) {
        int32_t a0 = m[0][j] + m[2][j], a1 = m[1][j] + m[3][j];
        int32_t b0 = m[0][j] - m[2][j], b1 = m[1][j] - m[3][j];
        int32_t v0 = a0 + a1, v1 = a0 - a1, v2 = b0 + b1, v3 = b0 - b1;
        if (j == 0) dc = v0 < 0 ? -v0 : v0;
        sum += (v0 < 0 ? -v0 : v0) + (v1 < 0 ? -v1 : v1)
             + (v2 < 0 ? -v2 : v2) + (v3 < 0 ? -v3 : v3);
    }
    sum = sum - dc + (dc >> 2);
    return (sum + 1) >> 1;
}

// whole-block SATD: a/b are h*w planes (stride = w)
int64_t satd_any(const int32_t* a, const int32_t* b, int w, int h) {
    std::vector<int32_t> d(w * h);
    for (int i = 0; i < w * h; ++i) d[i] = a[i] - b[i];
    int64_t total = 0;
    if (w >= 8 && h >= 8) {
        for (int by = 0; by < h; by += 8)
            for (int bx = 0; bx < w; bx += 8)
                total += satd8_block(d.data() + by * w + bx, w);
    } else {
        for (int by = 0; by < h; by += 4)
            for (int bx = 0; bx < w; bx += 4)
                total += satd4_block(d.data() + by * w + bx, w);
    }
    return total;
}

// --- mv helpers (ops/me.py, ops/inter.py, inter_cand.py parity) ----------

double mv_bits_est(int v) {
    int a = v < 0 ? -v : v;
    if (a == 0) return 1.0;
    if (a == 1) return 3.0;
    int k = a - 2, length = 1, count = 1;
    while (k >= (1 << count)) {
        k -= 1 << count;
        count += 1;
        length += 2;
    }
    return 2.0 + length + count + 1;
}

// uvg_change_precision (inter.c:1927)
inline void change_precision(int src, int dst, int& hx, int& hy) {
    int shift = dst - src;
    if (shift >= 0) {
        hx <<= shift;
        hy <<= shift;
        return;
    }
    int rs = -shift, offset = 1 << (rs - 1);
    hx = hx >= 0 ? (hx + offset - 1) >> rs : (hx + offset) >> rs;
    hy = hy >= 0 ? (hy + offset - 1) >> rs : (hy + offset) >> rs;
}

inline void round_precision(int src, int dst, int& hx, int& hy) {
    change_precision(src, dst, hx, hy);
    change_precision(dst, src, hx, hy);
}

// MV rounding through the 4-bit-exponent/6-bit-mantissa float form
// (inter.c:1106-1140 round_mv_comp)
int round_mv_comp(int v) {
    int sign = v < 0 ? -1 : 0;
    unsigned x = (unsigned)((v ^ sign) | 31);
    int bl = 32 - __builtin_clz(x);
    int scale = bl - 6;
    if (scale < 0) return v;
    int n = (v + ((1 << scale) >> 1)) >> scale;
    int exponent = scale + ((n ^ sign) >> 5);
    int mantissa = (n & 31) | (sign << 5);
    return (mantissa ^ 32) << (exponent - 1);
}

inline int get_scaled_mv(int mv, int scale) {
    int64_t s = (int64_t)scale * mv;
    int64_t r = (s + 127 + (s < 0 ? 1 : 0)) >> 8;
    return (int)(r < -131072 ? -131072 : (r > 131071 ? 131071 : r));
}

// apply_mv_scaling_pocs (inter.c:1148)
inline void mv_scale_pocs(int cur_poc, int cur_ref_poc, int nb_poc,
                          int nb_ref_poc, int& mvx, int& mvy) {
    int diff_cur = cur_poc - cur_ref_poc;
    int diff_nb = nb_poc - nb_ref_poc;
    if (diff_cur == diff_nb) return;
    diff_cur = iclip(diff_cur, -128, 127);
    diff_nb = iclip(diff_nb, -128, 127);
    int adn = diff_nb < 0 ? -diff_nb : diff_nb;
    int q = (0x4000 + (adn >> 1)) / diff_nb;   // trunc toward zero
    int scale = iclip((diff_cur * q + 32) >> 6, -4096, 4095);
    mvx = get_scaled_mv(mvx, scale);
    mvy = get_scaled_mv(mvy, scale);
}

// --- candidate derivation state ------------------------------------------

struct MInfo {
    int mv[2][2] = {{0, 0}, {0, 0}};
    int ref[2] = {0, 0};
    int dir = 0;
};

inline bool is_dup(const MInfo& c1, const MInfo& c2) {
    if (c1.dir != c2.dir) return false;
    for (int l = 0; l < 2; ++l)
        if (c1.dir & (1 << l))
            if (c1.mv[l][0] != c2.mv[l][0] || c1.mv[l][1] != c2.mv[l][1]
                || c1.ref[l] != c2.ref[l])
                return false;
    return true;
}

// CuMap analogue (control/cu.py): per-4x4 SoA over the frame
struct CuMap {
    int w4, h4;
    std::vector<uint8_t> coded, type, dir;
    std::vector<int8_t> ref0, ref1;
    std::vector<int32_t> mv0x, mv0y, mv1x, mv1y;

    void init(int fw, int fh) {
        w4 = (fw + 3) / 4;
        h4 = (fh + 3) / 4;
        size_t n = (size_t)w4 * h4;
        coded.assign(n, 0);
        type.assign(n, 0);
        dir.assign(n, 0);
        ref0.assign(n, 0);
        ref1.assign(n, 0);
        mv0x.assign(n, 0);
        mv0y.assign(n, 0);
        mv1x.assign(n, 0);
        mv1y.assign(n, 0);
    }

    // at() + _minfo_from_map: inter-coded neighbor with unused lists
    // zeroed (inter.c:748-765), or false
    bool minfo_at(int x, int y, MInfo* out) const {
        if (x < 0 || y < 0) return false;
        int yi = y >> 2, xi = x >> 2;
        if (yi >= h4 || xi >= w4) return false;
        size_t i = (size_t)yi * w4 + xi;
        if (!coded[i] || type[i] != 2) return false;
        out->dir = dir[i];
        out->mv[0][0] = (dir[i] & 1) ? mv0x[i] : 0;
        out->mv[0][1] = (dir[i] & 1) ? mv0y[i] : 0;
        out->ref[0] = (dir[i] & 1) ? ref0[i] : 0;
        out->mv[1][0] = (dir[i] & 2) ? mv1x[i] : 0;
        out->mv[1][1] = (dir[i] & 2) ? mv1y[i] : 0;
        out->ref[1] = (dir[i] & 2) ? ref1[i] : 0;
        return true;
    }

    void set_cu(int x, int y, int w, int h, int cu_type, const MInfo& mi) {
        for (int yy = y >> 2; yy < (y + h) >> 2; ++yy)
            for (int xx = x >> 2; xx < (x + w) >> 2; ++xx) {
                size_t i = (size_t)yy * w4 + xx;
                coded[i] = 1;
                type[i] = (uint8_t)cu_type;
                if (cu_type == 2) {
                    dir[i] = (uint8_t)mi.dir;
                    mv0x[i] = mi.mv[0][0];
                    mv0y[i] = mi.mv[0][1];
                    mv1x[i] = mi.mv[1][0];
                    mv1y[i] = mi.mv[1][1];
                    ref0[i] = (int8_t)mi.ref[0];
                    ref1[i] = (int8_t)mi.ref[1];
                }
            }
    }
};

// per-CTU-row HMVP LUT (videoframe.h:91; inter_cand.HmvpState)
struct Hmvp {
    std::vector<std::vector<MInfo>> rows;   // newest first

    void init(int n_rows) { rows.assign(n_rows > 0 ? n_rows : 1, {}); }

    std::vector<MInfo>& row(int y) { return rows[y / LCU]; }

    void add(int x, int y, int w, int h, const MInfo& mi, int plog2) {
        int xbr = x + w, ybr = y + h;
        if (!(((xbr >> plog2) > (x >> plog2))
              && ((ybr >> plog2) > (y >> plog2))))
            return;
        auto& lut = row(y);
        for (size_t i = 0; i < lut.size(); ++i)
            if (is_dup(mi, lut[i])) {
                lut.erase(lut.begin() + i);
                break;
            }
        lut.insert(lut.begin(), mi);
        if ((int)lut.size() > MAX_HMVP) lut.pop_back();
    }
};

// TMVP context (inter_cand.TmvpCtx)
struct Tmvp {
    bool on = false;
    const int8_t* dir = nullptr;       // [h8, w8]
    const int32_t* mv = nullptr;       // [h8, w8, 2, 2]
    const int32_t* refpoc = nullptr;   // [h8, w8, 2]
    int w8 = 0, h8 = 0;
    int col_poc = 0, cur_poc = 0;
    bool has_future = false;
    const int32_t* pocs0 = nullptr;
    const int32_t* pocs1 = nullptr;
    int n0 = 0, n1 = 0;

    // C0 (bottom-right, same CTU row) else C1 (center), or -1
    // (inter.c:1031-1096)
    int cell(int x, int y, int w, int h, int pic_w, int pic_h) const {
        int xbr = x + w, ybr = y + h;
        if (xbr < pic_w && ybr < pic_h && (ybr % LCU) != 0) {
            int ci = ybr >> 3, cj = xbr >> 3;
            if (dir[ci * w8 + cj] != 0) return ci * w8 + cj;
        }
        int xc = x + w / 2, yc = y + h / 2;
        if (xc < pic_w && yc < pic_h) {
            int ci = yc >> 3, cj = xc >> 3;
            if (dir[ci * w8 + cj] != 0) return ci * w8 + cj;
        }
        return -1;
    }

    // add_temporal_candidate (inter.c:1547-1602)
    void candidate(int cell_i, int reflist, int cur_ref_poc,
                   int& mvx, int& mvy) const {
        int col_list = has_future ? 1 : reflist;
        if (!(dir[cell_i] & (1 << col_list))) col_list = 1 - col_list;
        mvx = round_mv_comp(mv[cell_i * 4 + col_list * 2 + 0]);
        mvy = round_mv_comp(mv[cell_i * 4 + col_list * 2 + 1]);
        mv_scale_pocs(cur_poc, cur_ref_poc, col_poc,
                      refpoc[cell_i * 2 + col_list], mvx, mvy);
    }
};

struct Ctx {
    // current frame planes
    int32_t *rec_y, *rec_u, *rec_v;
    const int32_t *src_y, *src_u, *src_v;
    uint8_t* mask;
    int fw, fh;
    // reference lists (plane pointer arrays)
    const int64_t *l0_y, *l0_u, *l0_v, *l1_y, *l1_u, *l1_v;
    int n_l0, n_l1;
    const int32_t *pocs0, *pocs1;
    // uniq planes for refine
    const int64_t* uniq_y;
    const int32_t *refmap_list, *refmap_ref, *l1_idx;
    Tmvp tmvp;
    // params
    int qp_y, qp_c, bd, signhide, is_b, bipred_en;
    int max_merge, num_ref_merge, plog2, wpp;
    double lam_sqrt;
    CuMap cu_map;
    Hmvp hmvp;
};

// spatial_candidates (inter_cand.py; inter.c:1368)
struct Spatial {
    MInfo a0, a1, b0, b1, b2;
    bool has_a0 = false, has_a1 = false, has_b0 = false, has_b1 = false,
         has_b2 = false;
};

Spatial spatial_cands(const Ctx& c, int x, int y, int w, int h) {
    Spatial s;
    if (x != 0) {
        s.has_a1 = c.cu_map.minfo_at(x - 1, y + h - 1, &s.a1);
        if (y + h < c.fh) s.has_a0 = c.cu_map.minfo_at(x - 1, y + h, &s.a0);
    }
    if (y != 0) {
        // with WPP the cross-CTU above-right candidate is never
        // available (inter.c:1421,1512: x_local+width<LCU_WIDTH ||
        // (!wpp && y_local==0)); rows must not depend on the CTU to
        // the upper right beyond the sync delay
        bool b0_ok = (x % 64) + w < 64 || !c.wpp;
        if (x + w < c.fw && b0_ok)
            s.has_b0 = c.cu_map.minfo_at(x + w, y - 1, &s.b0);
        s.has_b1 = c.cu_map.minfo_at(x + w - 1, y - 1, &s.b1);
        if (x != 0) s.has_b2 = c.cu_map.minfo_at(x - 1, y - 1, &s.b2);
    }
    return s;
}

inline bool diff_mer(int x, int y, int x2, int y2, int level) {
    return (x >> level) != (x2 >> level) || (y >> level) != (y2 >> level);
}

// derive_merge_list (inter_cand.py; inter.c:1989-2192)
int derive_merge(Ctx& c, int x, int y, int w, int h, MInfo* out) {
    Spatial sp = spatial_cands(c, x, y, w, h);
    int n = 0;
    auto try_add = [&](bool has, const MInfo& cand, const MInfo* d1,
                       const MInfo* d2) {
        if (!has) return false;
        if (d1 && is_dup(cand, *d1)) return false;
        if (d2 && is_dup(cand, *d2)) return false;
        out[n++] = cand;
        return true;
    };
    const MInfo* b1p = sp.has_b1 ? &sp.b1 : nullptr;
    const MInfo* a1p = sp.has_a1 ? &sp.a1 : nullptr;
    if (diff_mer(x, y, x, y - 1, c.plog2))
        try_add(sp.has_b1, sp.b1, nullptr, nullptr);
    if (diff_mer(x, y, x - 1, y, c.plog2))
        try_add(sp.has_a1, sp.a1, b1p, nullptr);
    if (diff_mer(x, y, x + 1, y - 1, c.plog2))
        try_add(sp.has_b0, sp.b0, b1p, nullptr);
    if (diff_mer(x, y, x - 1, y + 1, c.plog2))
        try_add(sp.has_a0, sp.a0, a1p, nullptr);
    if (n < 4 && diff_mer(x, y, x - 1, y - 1, c.plog2))
        try_add(sp.has_b2, sp.b2, a1p, b1p);

    // temporal candidate, ref idx 0 (inter.c:2030-2070)
    if (c.tmvp.on && n < c.max_merge) {
        int cell = c.tmvp.cell(x, y, w, h, c.fw, c.fh);
        if (cell >= 0) {
            MInfo t;
            int d = 0;
            for (int l = 0; l < (c.is_b ? 2 : 1); ++l) {
                int mvx, mvy;
                c.tmvp.candidate(cell, l, c.tmvp.pocs0[0], mvx, mvy);
                const int32_t* pl = l == 0 ? c.tmvp.pocs0 : c.tmvp.pocs1;
                int nl = l == 0 ? c.tmvp.n0 : c.tmvp.n1;
                if (nl > 0 && pl[0] > c.tmvp.cur_poc) {
                    mvx = -mvx;
                    mvy = -mvy;
                }
                t.mv[l][0] = mvx;
                t.mv[l][1] = mvy;
                d |= 1 << l;
            }
            if (d) {
                t.dir = d;
                out[n++] = t;
            }
        }
    }

    // HMVP (first two entries checked against a1/b1)
    if (n < c.max_merge - 1) {
        auto& lut = c.hmvp.row(y);
        for (size_t i = 0; i < lut.size(); ++i) {
            const MInfo& hc = lut[i];
            if (i > 1 || (!(a1p && is_dup(hc, *a1p))
                          && !(b1p && is_dup(hc, *b1p)))) {
                MInfo cc = hc;
                if (!c.is_b) {
                    cc.mv[1][0] = cc.mv[1][1] = 0;
                    cc.ref[1] = 0;
                }
                out[n++] = cc;
                if (n == c.max_merge - 1) break;
            }
        }
    }

    // pairwise average of the first two
    if (n > 1 && n < c.max_merge) {
        int nlists = c.is_b ? 2 : 1;
        MInfo p;
        int d = 0;
        for (int l = 0; l < nlists; ++l) {
            int ri = (out[0].dir & (1 << l)) ? out[0].ref[l] : -1;
            int rj = (out[1].dir & (1 << l)) ? out[1].ref[l] : -1;
            if (ri == -1 && rj == -1) continue;
            d += 1 << l;
            if (ri != -1 && rj != -1) {
                int ax = out[0].mv[l][0] + out[1].mv[l][0];
                int ay = out[0].mv[l][1] + out[1].mv[l][1];
                ax = (ax + 1 - (ax >= 0 ? 1 : 0)) >> 1;
                ay = (ay + 1 - (ay >= 0 ? 1 : 0)) >> 1;
                p.mv[l][0] = ax;
                p.mv[l][1] = ay;
                p.ref[l] = ri;
            } else if (ri != -1) {
                p.mv[l][0] = out[0].mv[l][0];
                p.mv[l][1] = out[0].mv[l][1];
                p.ref[l] = ri;
            } else {
                p.mv[l][0] = out[1].mv[l][0];
                p.mv[l][1] = out[1].mv[l][1];
                p.ref[l] = rj;
            }
        }
        if (d > 0) {
            p.dir = d;
            out[n++] = p;
        }
    }

    // zero candidates
    int zero_idx = 0;
    while (n < c.max_merge) {
        int r = zero_idx < c.num_ref_merge - 1 ? zero_idx : 0;
        MInfo z;
        if (c.is_b) {
            z.ref[0] = z.ref[1] = r;
            z.dir = 3;
        } else {
            z.ref[0] = r;
            z.dir = 1;
        }
        out[n++] = z;
        zero_idx += 1;
    }
    return c.max_merge;
}

// derive_amvp (inter_cand.py; inter.c:1606-1699)
void derive_amvp(Ctx& c, int x, int y, int w, int h, int reflist,
                 int cur_ref_poc, int out_mv[2][2]) {
    Spatial sp = spatial_cands(c, x, y, w, h);
    int cands[2][2];
    int n = 0;
    auto try_mvp = [&](bool has, const MInfo& cand) {
        if (!has) return false;
        for (int i = 0; i < 2; ++i) {
            int cl = i == 0 ? reflist : 1 - reflist;
            if (!(cand.dir & (1 << cl))) continue;
            const int32_t* pl = cl == 0 ? c.pocs0 : c.pocs1;
            if (pl[cand.ref[cl]] == cur_ref_poc) {
                cands[n][0] = cand.mv[cl][0];
                cands[n][1] = cand.mv[cl][1];
                ++n;
                return true;
            }
        }
        return false;
    };
    if (!try_mvp(sp.has_a0, sp.a0)) try_mvp(sp.has_a1, sp.a1);
    if (!try_mvp(sp.has_b0, sp.b0))
        if (!try_mvp(sp.has_b1, sp.b1)) try_mvp(sp.has_b2, sp.b2);

    for (int i = 0; i < n; ++i)
        round_precision(4, 2, cands[i][0], cands[i][1]);
    if (n == 2 && cands[0][0] == cands[1][0] && cands[0][1] == cands[1][1])
        n = 1;

    // temporal MVP (inter.c:1649-1669, gated on poc > 1)
    if (c.tmvp.on && c.tmvp.cur_poc > 1 && n < 2) {
        int cell = c.tmvp.cell(x, y, w, h, c.fw, c.fh);
        if (cell >= 0) {
            int mvx, mvy;
            c.tmvp.candidate(cell, reflist, cur_ref_poc, mvx, mvy);
            cands[n][0] = mvx;
            cands[n][1] = mvy;
            ++n;
        }
    }

    if (n < 2) {
        // oldest-first iteration over the last 4 LUT entries
        auto& lut = c.hmvp.row(y);
        int count = (int)lut.size() < 4 ? (int)lut.size() : 4;
        for (int i = 0; i < count && n < 2; ++i) {
            const MInfo& hc = lut[lut.size() - 1 - i];
            for (int s = 0; s < 2 && n < 2; ++s) {
                int cl = s == 0 ? reflist : 1 - reflist;
                if (!(hc.dir & (1 << cl))) continue;
                const int32_t* pl = cl == 0 ? c.pocs0 : c.pocs1;
                if (pl[hc.ref[cl]] == cur_ref_poc) {
                    cands[n][0] = hc.mv[cl][0];
                    cands[n][1] = hc.mv[cl][1];
                    ++n;
                }
            }
        }
    }

    while (n < 2) {
        cands[n][0] = cands[n][1] = 0;
        ++n;
    }
    for (int i = 0; i < 2; ++i) {
        out_mv[i][0] = cands[i][0];
        out_mv[i][1] = cands[i][1];
        round_precision(4, 2, out_mv[i][0], out_mv[i][1]);
    }
}

// --- quarter-pel refine (ops/me_frame.make_leaf_qpel_fn parity) ----------

// Per-candidate 49-offset SATD refine. windows of (h+10)x(w+10) fetched
// at (x + (mvx>>4) - 5, y + (mvy>>4) - 5); the 16 (fy,fx) phase planes of
// (h+2)x(w+2) replicate interp_one's mc_luma arithmetic exactly.
struct RefineResult {
    int best_k;            // 0..48; qpel offset (k%7-3, k//7-3)
    int64_t seg[49];       // exact integer SATD sums (f32-exact)
};

void refine_cand(const Ctx& c, const int32_t* plane, int x, int y,
                 int w, int h, int mvx, int mvy, const float* pen49,
                 RefineResult* rr) {
    const int bd = c.bd;
    const int max_pix = (1 << bd) - 1;
    const int W = w + 10, H = h + 10;
    std::vector<int32_t> win(W * H);
    fetch_ext(plane, c.fw, c.fh, x + (mvx >> 4), y + (mvy >> 4), w, h,
              5, 5, 5, 5, win.data(), W);

    const int HR = h + 9, WC = w + 2;
    static const int FR[4] = {0, 4, 8, 12};
    const int shift1 = bd - 8;
    const int wp_shift = 14 - bd;
    const int PH = h + 2, PW = w + 2;
    std::vector<int32_t> hor(4 * HR * WC);
    std::vector<int32_t> phase(16 * PH * PW);
    bool hor_done[4] = {false, false, false, false};
    bool phase_done[16] = {false};

    // lazy hor pass per fx phase: rows r in [-4, h+5), cols b in [-1, w+1)
    auto make_hor = [&](int f) {
        if (hor_done[f]) return;
        hor_done[f] = true;
        const int32_t* hf = LUMA_FILTER[FR[f]];
        int32_t* hp = hor.data() + f * HR * WC;
        for (int r = 0; r < HR; ++r) {
            const int32_t* wrow = win.data() + (r + 1) * W;  // 5+(r-4)
            for (int b = 0; b < WC; ++b) {
                // col 5+(b-1)-3+t = b+1+t
                const int32_t* p = wrow + b + 1;
                int32_t s = hf[0] * p[0] + hf[1] * p[1] + hf[2] * p[2]
                          + hf[3] * p[3] + hf[4] * p[4] + hf[5] * p[5]
                          + hf[6] * p[6] + hf[7] * p[7];
                hp[r * WC + b] = s >> shift1;
            }
        }
    };
    // lazy phase plane P[fy][fx] of (h+2)x(w+2); P[A][B] is the sample
    // at output position (A-1, B-1) with zero int offset
    auto make_phase = [&](int fy, int fx) -> const int32_t* {
        int32_t* pp = phase.data() + (fy * 4 + fx) * PH * PW;
        if (phase_done[fy * 4 + fx]) return pp;
        phase_done[fy * 4 + fx] = true;
        if (fy == 0 && fx == 0) {
            for (int A = 0; A < PH; ++A)
                for (int B = 0; B < PW; ++B)
                    pp[A * PW + B] = win[(4 + A) * W + 4 + B];
            return pp;
        }
        make_hor(fx);
        const int32_t* vf = LUMA_FILTER[FR[fy]];
        const int32_t* hp = hor.data() + fx * HR * WC;
        for (int A = 0; A < PH; ++A) {
            // rows (A-1)-3+t -> hor row index (A-4+t)+4 = A+t
            for (int B = 0; B < PW; ++B) {
                const int32_t* q = hp + A * WC + B;
                int64_t s = (int64_t)vf[0] * q[0]
                          + (int64_t)vf[1] * q[WC]
                          + (int64_t)vf[2] * q[2 * WC]
                          + (int64_t)vf[3] * q[3 * WC]
                          + (int64_t)vf[4] * q[4 * WC]
                          + (int64_t)vf[5] * q[5 * WC]
                          + (int64_t)vf[6] * q[6 * WC]
                          + (int64_t)vf[7] * q[7 * WC];
                s >>= 6;
                s = (s + (1 << (wp_shift - 1))) >> wp_shift;
                pp[A * PW + B] = iclip((int)s, 0, max_pix);
            }
        }
        return pp;
    };
    // SATD of offset k, 8x8 tiles in row-major order (JAX segment_sum
    // order; sums < 2^24 so f32 accumulation is exact); lazily cached
    for (int k = 0; k < 49; ++k) rr->seg[k] = -1;
    auto eval_k = [&](int k) -> int64_t {
        if (rr->seg[k] >= 0) return rr->seg[k];
        int dxq = k % 7 - 3, dyq = k / 7 - 3;
        int ix = (dxq * 4) >> 4, iy = (dyq * 4) >> 4;
        int fx = (dxq * 4) & 15, fy = (dyq * 4) & 15;
        const int32_t* pl = make_phase(fy >> 2, fx >> 2);
        int32_t diff[64];
        int64_t total = 0;
        for (int ti = 0; ti < h / 8; ++ti)
            for (int tj = 0; tj < w / 8; ++tj) {
                const int32_t* sb = c.src_y
                    + (int64_t)(y + ti * 8) * c.fw + x + tj * 8;
                const int32_t* pp = pl + (1 + iy + ti * 8) * PW
                                    + 1 + ix + tj * 8;
                for (int yy = 0; yy < 8; ++yy)
                    for (int xx = 0; xx < 8; ++xx)
                        diff[yy * 8 + xx] = sb[yy * c.fw + xx]
                                          - pp[yy * PW + xx];
                total += satd8_block(diff, 8);
            }
        rr->seg[k] = total;
        return total;
    };
    // two-stage selection, mirroring encoder._two_stage_qpel exactly
    // (f32 costs, first-minimum in iteration order)
    int best_k = -1;
    float best_c = 0.0f;
    bool first = true;
    for (int dyq = -2; dyq <= 2; dyq += 2)
        for (int dxq = -2; dxq <= 2; dxq += 2) {
            int k = (dyq + 3) * 7 + (dxq + 3);
            float cc = (float)eval_k(k) + pen49[k];
            if (first || cc < best_c) {
                best_k = k;
                best_c = cc;
                first = false;
            }
        }
    int bdx = best_k % 7 - 3, bdy = best_k / 7 - 3;
    for (int dyq = bdy - 1; dyq <= bdy + 1; ++dyq) {
        if (dyq < -3 || dyq > 3) continue;
        for (int dxq = bdx - 1; dxq <= bdx + 1; ++dxq) {
            if (dxq < -3 || dxq > 3) continue;
            int k = (dyq + 3) * 7 + (dxq + 3);
            float cc = (float)eval_k(k) + pen49[k];
            if (cc < best_c) {
                best_k = k;
                best_c = cc;
            }
        }
    }
    rr->best_k = best_k;
}

// --- host full-pel ME (reference hexbs, search_inter.c:767) --------------

// SSD of an aligned w*h source block vs ref at full-pel offset (mvx, mvy)
inline int64_t block_ssd(const int32_t* src, int fw, int fh,
                         const int32_t* ref, int x, int y, int w, int h,
                         int mvx, int mvy) {
    int bx = x + mvx, by = y + mvy;
    int64_t s = 0;
    if (bx >= 0 && by >= 0 && bx + w <= fw && by + h <= fh) {
        for (int yy = 0; yy < h; ++yy) {
            const int32_t* sr = src + (int64_t)(y + yy) * fw + x;
            const int32_t* rr = ref + (int64_t)(by + yy) * fw + bx;
            for (int xx = 0; xx < w; ++xx) {
                int32_t d = sr[xx] - rr[xx];
                s += (int64_t)d * d;
            }
        }
    } else {
        for (int yy = 0; yy < h; ++yy) {
            const int32_t* sr = src + (int64_t)(y + yy) * fw + x;
            int cy = iclip(by + yy, 0, fh - 1);
            const int32_t* rr = ref + (int64_t)cy * fw;
            for (int xx = 0; xx < w; ++xx) {
                int32_t d = sr[xx] - rr[iclip(bx + xx, 0, fw - 1)];
                s += (int64_t)d * d;
            }
        }
    }
    return s;
}

// stride-2-row SSD for cheap coarse probes (x4 less work; the probe
// only has to rank candidate starts, the hexagon walk refines after)
inline int64_t block_ssd_sub(const int32_t* src, int fw, int fh,
                             const int32_t* ref, int x, int y, int w,
                             int h, int mvx, int mvy) {
    int bx = x + mvx, by = y + mvy;
    int64_t s = 0;
    for (int yy = 0; yy < h; yy += 2) {
        const int32_t* sr = src + (int64_t)(y + yy) * fw + x;
        int cy = iclip(by + yy, 0, fh - 1);
        const int32_t* rr = ref + (int64_t)cy * fw;
        if (bx >= 0 && bx + w <= fw) {
            const int32_t* rp = rr + bx;
            for (int xx = 0; xx < w; xx += 2) {
                int32_t d = sr[xx] - rp[xx];
                s += (int64_t)d * d;
            }
        } else {
            for (int xx = 0; xx < w; xx += 2) {
                int32_t d = sr[xx] - rr[iclip(bx + xx, 0, fw - 1)];
                s += (int64_t)d * d;
            }
        }
    }
    return s;
}

// rd cost of a full-pel prediction: the C++ mirror of
// ops/rd_cost.py make_rd_cost_pred_fn (DCT2 roundtrip + fast
// coefficient-cost buckets; reference --fast-residual-cost path,
// quant-generic.c:688). extra_bits in the ops/me_frame mv_bits_table
// units. Uses the shared DCT2 matrices from recon.cpp.
float rd_cost_pred(const int32_t* src, int fw, const int32_t* ref,
                   int x, int y, int w, int h, int mvx, int mvy, int fh,
                   int qp, int bd, float lam, const float* wts,
                   double extra_bits, int32_t* scratch) {
    // fetch pred (edge clamped)
    int32_t* pred = scratch;
    int32_t* rec = scratch + w * h;
    int32_t* blk = scratch + 2 * w * h;
    fetch_ext(ref, fw, fh, x + mvx, y + mvy, w, h, 0, 0, 0, 0, pred, w);
    for (int yy = 0; yy < h; ++yy)
        memcpy(blk + yy * w, src + (int64_t)(y + yy) * fw + x,
               sizeof(int32_t) * w);
    int64_t ssd = 0;
    double bits = 0.0;
    rcn::rd_roundtrip(blk, pred, w, h, qp, bd, false, wts, &ssd, &bits,
                      rec);
    return (float)((float)ssd + lam * (bits + extra_bits));
}

struct MeClass {
    int w, h, x0, y0, sx, sy, gx, gy;
};

// Hexagon-pattern ME with predictor seeding for every block of a class
// grid, one reference (search_inter.c hexbs:767: large hexagon iterate +
// small refine; start from merge/HMVP-style predictors — here the
// colocated previous-frame motion field + spatial left/top neighbours +
// zero, clamped to full-pel).
// parent-class MV seed grid (hierarchical ME): the covering block of
// the next-larger square class, or null
struct ParentSeed {
    const int32_t* mvx = nullptr;
    const int32_t* mvy = nullptr;
    int x0 = 0, y0 = 0, sx = 1, sy = 1, gx = 0, gy = 0;
};

void me_class_ref(const int32_t* src, const int32_t* ref, int fw, int fh,
                  const MeClass& mc, double lam_sqrt, int me_range,
                  const int8_t* pf_dir, const int32_t* pf_mv, int pf_w8,
                  int pf_h8, const ParentSeed* parent, bool coarse,
                  int32_t* out_mvx, int32_t* out_mvy, int64_t* out_ssd) {
    const int HEX[6][2] = {{2, 0}, {1, 2}, {-1, 2}, {-2, 0},
                           {-1, -2}, {1, -2}};
    const int SQ[8][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1},
                          {1, 1}, {-1, 1}, {1, -1}, {-1, -1}};
    auto mv_pen = [&](int mx, int my) {
        return lam_sqrt * (mv_bits_est(4 * mx) + mv_bits_est(4 * my));
    };
    // walk probes on large blocks use stride-2 subsampled SSD scaled
    // x4 (the walk only ranks neighboring offsets; out_ssd is
    // recomputed exactly at the chosen MV below)
    bool sub = mc.w * mc.h >= 1024;
    auto probe_ssd = [&](int x, int y, int mx, int my) -> int64_t {
        if (sub)
            return 4 * block_ssd_sub(src, fw, fh, ref, x, y, mc.w, mc.h,
                                     mx, my);
        return block_ssd(src, fw, fh, ref, x, y, mc.w, mc.h, mx, my);
    };
    for (int by = 0; by < mc.gy; ++by) {
        for (int bx = 0; bx < mc.gx; ++bx) {
            int x = mc.x0 + bx * mc.sx, y = mc.y0 + by * mc.sy;
            int k = by * mc.gx + bx;
            // candidate starts
            int cands[6][2];
            int nc = 0;
            cands[nc][0] = 0; cands[nc][1] = 0; ++nc;
            if (parent != nullptr && parent->mvx != nullptr) {
                // hierarchical seed: the covering next-larger block
                int pj = (x + mc.w / 2 - parent->x0) / parent->sx;
                int pi = (y + mc.h / 2 - parent->y0) / parent->sy;
                if (pj >= 0 && pi >= 0 && pj < parent->gx
                    && pi < parent->gy) {
                    cands[nc][0] = parent->mvx[pi * parent->gx + pj];
                    cands[nc][1] = parent->mvy[pi * parent->gx + pj];
                    ++nc;
                }
            }
            if (pf_dir != nullptr) {
                int ci = iclip((y + mc.h / 2) >> 3, 0, pf_h8 - 1);
                int cj = iclip((x + mc.w / 2) >> 3, 0, pf_w8 - 1);
                if (pf_dir[ci * pf_w8 + cj] != 0) {
                    int l = (pf_dir[ci * pf_w8 + cj] & 1) ? 0 : 1;
                    cands[nc][0] = pf_mv[(ci * pf_w8 + cj) * 4 + l * 2]
                                   >> 4;
                    cands[nc][1] = pf_mv[(ci * pf_w8 + cj) * 4 + l * 2 + 1]
                                   >> 4;
                    ++nc;
                }
            }
            if (bx > 0) {
                cands[nc][0] = out_mvx[k - 1];
                cands[nc][1] = out_mvy[k - 1];
                ++nc;
            }
            if (by > 0) {
                cands[nc][0] = out_mvx[k - mc.gx];
                cands[nc][1] = out_mvy[k - mc.gx];
                ++nc;
            }
            int bmx = 0, bmy = 0;
            double bcost = 1e30;
            for (int c = 0; c < nc; ++c) {
                int mx = iclip(cands[c][0], -me_range, me_range);
                int my = iclip(cands[c][1], -me_range, me_range);
                bool dup = false;
                for (int p = 0; p < c; ++p)
                    if (cands[p][0] == mx && cands[p][1] == my) dup = true;
                if (dup && c) continue;
                double cost = (double)probe_ssd(x, y, mx, my)
                              + mv_pen(mx, my);
                if (cost < bcost) { bcost = cost; bmx = mx; bmy = my; }
            }
            if (coarse) {
                // coarse grid scan (largest class only): step-8 probes
                // over the full range escape periodic-texture local
                // minima that pattern walks cannot cross. Probes use
                // stride-2 subsampled SSD (x4 cheaper); the best probe
                // is re-scored exactly before competing with the
                // predictor starts.
                int pbx = 0, pby = 0;
                int64_t pbest = -1;
                for (int my = -me_range; my <= me_range; my += 8)
                    for (int mx = -me_range; mx <= me_range; mx += 8) {
                        int64_t c = block_ssd_sub(src, fw, fh, ref,
                                                  x, y, mc.w, mc.h,
                                                  mx, my);
                        if (pbest < 0 || c < pbest) {
                            pbest = c; pbx = mx; pby = my;
                        }
                    }
                double cost = (double)probe_ssd(x, y, pbx, pby)
                              + mv_pen(pbx, pby);
                if (cost < bcost) { bcost = cost; bmx = pbx; bmy = pby; }
            }
            // large hexagon iterate. With a parent-class seed the
            // start is already near-optimal (pyramid ME), so a short
            // walk suffices — big speedup on the smaller classes,
            // which dominate block count.
            int hex_cap = (parent != nullptr && parent->mvx != nullptr)
                              ? 6 : me_range;
            for (int it = 0; it < hex_cap; ++it) {
                int nbx = bmx, nby = bmy;
                bool better = false;
                for (int p = 0; p < 6; ++p) {
                    int mx = bmx + HEX[p][0], my = bmy + HEX[p][1];
                    if (mx < -me_range || mx > me_range || my < -me_range
                        || my > me_range)
                        continue;
                    double cost = (double)probe_ssd(x, y, mx, my)
                                  + mv_pen(mx, my);
                    if (cost < bcost) {
                        bcost = cost; nbx = mx; nby = my; better = true;
                    }
                }
                bmx = nbx; bmy = nby;
                if (!better) break;
            }
            // small square refine
            for (int p = 0; p < 8; ++p) {
                int mx = bmx + SQ[p][0], my = bmy + SQ[p][1];
                if (mx < -me_range || mx > me_range || my < -me_range
                    || my > me_range)
                    continue;
                double cost = (double)probe_ssd(x, y, mx, my)
                              + mv_pen(mx, my);
                if (cost < bcost) { bcost = cost; bmx = mx; bmy = my; }
            }
            out_mvx[k] = bmx;
            out_mvy[k] = bmy;
            out_ssd[k] = block_ssd(src, fw, fh, ref, x, y, mc.w, mc.h,
                                   bmx, bmy);
        }
    }
}

// input leaf record (18 int32, python packer in native/__init__.py):
// x, y, w, h, kind(0 intra / 1 inter), intra_mode,
// u, mvx, mvy, ref_list, ref_idx,
// has_pair, u0, mv0x, mv0y, u1, mv1x, mv1y
struct InLeaf {
    int32_t x, y, w, h, kind, mode;
    int32_t u, mvx, mvy, list, ref;
    int32_t has_pair, u0, mv0x, mv0y, u1, mv1x, mv1y;
};

// resolved desc after refine (the python cu_desc)
struct Desc {
    int type;      // 0 intra, 1 inter(uni), 2 bi
    int mode;      // intra mode
    int list, ref;
    int mv[2][2];  // uni -> mv[list]; bi -> both
    int ref1;
};

}  // namespace

extern "C" {

// Host full-pel ME for every block of every class grid over every
// reference plane (the hexbs analogue of search_inter.c:767 with
// predictor seeding from the previous frame's motion field). Produces
// the per-(ref, class) MV + rd-cost grids the partition DP consumes —
// the host replacement of the device dense search for serial
// (low-delay) frames.
//
// class_desc: [n_classes][8] int32 (w, h, x0, y0, sx, sy, gx, gy).
// Outputs are packed per ref, then per class: out_mv [.., 2] full-pel,
// out_cost f32 (rd units of ops/rd_cost.make_rd_cost_pred_fn).
// Chunked into fixed 8-block-row strips for determinism regardless of
// thread count (strip-first rows lose the top predictor only).
void fi_me_frame(const int32_t* src_y, int fw, int fh,
                 const int64_t* uniq_y, int n_uniq,
                 const int8_t* pf_dir, const int32_t* pf_mv,
                 int pf_w8, int pf_h8,
                 int qp_scaled, int bd, double lam, int me_range,
                 int coarse_flag, const int8_t* u_list, int is_b,
                 const float* wts, int n_threads,
                 const int32_t* class_desc, int n_classes,
                 int32_t* out_mv, float* out_cost) {
    double lam_sqrt = std::sqrt(lam);
    std::vector<MeClass> mcs(n_classes);
    std::vector<int64_t> base(n_classes * n_uniq);
    int64_t total = 0;
    for (int c = 0; c < n_classes; ++c) {
        const int32_t* d = class_desc + c * 8;
        mcs[c] = MeClass{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7]};
    }
    for (int u = 0; u < n_uniq; ++u)
        for (int c = 0; c < n_classes; ++c) {
            base[u * n_classes + c] = total;
            total += (int64_t)mcs[c].gx * mcs[c].gy;
        }

    // hierarchical stages: classes run largest-first (per ref) so each
    // class can seed from the covering block of its 2x parent; the
    // largest class additionally runs the coarse grid scan. Strip
    // parallelism lives inside each stage.
    struct Unit { int y0, y1; };
    std::vector<int> order(n_classes);
    for (int c = 0; c < n_classes; ++c) order[c] = c;
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        return mcs[a].w * mcs[a].h > mcs[b].w * mcs[b].h;
    });
    // per-(u, c) result grids for parent seeding
    std::vector<std::vector<int32_t>> res_mvx(n_uniq * n_classes),
        res_mvy(n_uniq * n_classes);

    auto find_parent = [&](int c) -> int {
        for (int p = 0; p < n_classes; ++p)
            if (mcs[p].w == 2 * mcs[c].w && mcs[p].h == 2 * mcs[c].h)
                return p;
        return -1;
    };

    int nt = n_threads > 0 ? n_threads : 1;
    // coarse scan: needed when predictor seeds are unreliable — no
    // previous-frame motion field (first inter frame after intra), or a
    // caller-signalled case (B slices: the nearest ref's field is at a
    // different POC distance than this frame's refs, so unscaled seeds
    // strand the hexagon walk in local minima). LD P frames keep it off
    // for speed; the flag arrives via coarse_flag.
    // at small lambdas the mvd-vs-merge bit saving (lam*(bits-6)) is too
    // small to flip partition decisions, so the coarse probe and the
    // neighbor merge trials are pure overhead — gate both on lambda.
    // Threshold ~100 ~ qp 33 intra-slice scale; deep-B lambdas (>700)
    // and high-qp LD points stay covered, the speed-bench point (qp27,
    // lam~57) runs the lean path.
    bool lam_gate = lam >= 100.0;
    bool want_coarse = (pf_dir == nullptr)
                       || (coarse_flag != 0 && lam_gate);
    struct UUnit { int u, y0, y1; };
    std::vector<std::vector<int64_t>> res_ssd(n_uniq * n_classes);
    for (int oc = 0; oc < n_classes; ++oc) {
        int cidx = order[oc];
        const MeClass& mc0 = mcs[cidx];
        bool coarse = want_coarse && oc == 0;
        int pc = find_parent(cidx);
        for (int u = 0; u < n_uniq; ++u) {
            res_mvx[u * n_classes + cidx].assign(
                (size_t)mc0.gx * mc0.gy, 0);
            res_mvy[u * n_classes + cidx].assign(
                (size_t)mc0.gx * mc0.gy, 0);
            res_ssd[u * n_classes + cidx].assign(
                (size_t)mc0.gx * mc0.gy, 0);
        }
        // stage A: motion search for every (ref, strip)
        std::vector<UUnit> units;
        for (int u = 0; u < n_uniq; ++u)
            for (int y0 = 0; y0 < mc0.gy; y0 += 8)
                units.push_back(
                    {u, y0, y0 + 8 < mc0.gy ? y0 + 8 : mc0.gy});

        auto run_me = [&](const UUnit& un) {
            int u = un.u;
            const int32_t* ref =
                reinterpret_cast<const int32_t*>(uniq_y[u]);
            ParentSeed seed;
            if (pc >= 0 && !res_mvx[u * n_classes + pc].empty()) {
                seed.mvx = res_mvx[u * n_classes + pc].data();
                seed.mvy = res_mvy[u * n_classes + pc].data();
                seed.x0 = mcs[pc].x0; seed.y0 = mcs[pc].y0;
                seed.sx = mcs[pc].sx; seed.sy = mcs[pc].sy;
                seed.gx = mcs[pc].gx; seed.gy = mcs[pc].gy;
            }
            MeClass mc = mc0;
            mc.y0 = mc0.y0 + un.y0 * mc0.sy;
            mc.gy = un.y1 - un.y0;
            size_t off = (size_t)un.y0 * mc0.gx;
            me_class_ref(src_y, ref, fw, fh, mc, lam_sqrt, me_range,
                         pf_dir, pf_mv, pf_w8, pf_h8,
                         seed.mvx ? &seed : nullptr, coarse,
                         res_mvx[u * n_classes + cidx].data() + off,
                         res_mvy[u * n_classes + cidx].data() + off,
                         res_ssd[u * n_classes + cidx].data() + off);
        };
        int tn = nt > (int)units.size() ? (int)units.size() : nt;
        if (tn <= 1) {
            for (const UUnit& un : units) run_me(un);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < tn; ++t)
                ths.emplace_back([&, t]() {
                    for (size_t i = t; i < units.size(); i += tn)
                        run_me(units[i]);
                });
            for (auto& th : ths) th.join();
        }

        // stage B: scoring. The transform-roundtrip rd cost runs only
        // for each block's winning ref (ranked by raw SSD + lam*mvd
        // bits), plus — on B slices — the winner of each reference
        // list so the resolve step can still form bi pairs. Everything
        // else gets +inf; the partition DP only consumes the per-block
        // min and the per-list argmins. Cuts roundtrips from R per
        // block to 1 (P, low lam) / <=4 (B, high lam).
        std::vector<UUnit> sunits;
        for (int y0 = 0; y0 < mc0.gy; y0 += 8)
            sunits.push_back(
                {0, y0, y0 + 8 < mc0.gy ? y0 + 8 : mc0.gy});

        // B slices keep the full per-ref scoring + per-ref propagation
        // chains (bi pairing needs honest per-list costs; B frames only
        // occur in RA where encode speed is not the headline metric)
        auto run_score_full = [&](const UUnit& un) {
            std::vector<int32_t> scratch(3 * 64 * 64);
            int gx = mc0.gx;
            int rows = un.y1 - un.y0;
            for (int u = 0; u < n_uniq; ++u) {
                const int32_t* ref =
                    reinterpret_cast<const int32_t*>(uniq_y[u]);
                auto& mxg = res_mvx[u * n_classes + cidx];
                auto& myg = res_mvy[u * n_classes + cidx];
                for (int kk = 0; kk < gx * rows; ++kk) {
                    int krow = un.y0 + kk / gx, kcol = kk % gx;
                    size_t k = (size_t)krow * gx + kcol;
                    int x = mc0.x0 + kcol * mc0.sx;
                    int y = mc0.y0 + krow * mc0.sy;
                    double extra = mv_bits_est(4 * mxg[k])
                                   + mv_bits_est(4 * myg[k]) + 4.0;
                    double best = rd_cost_pred(
                        src_y, fw, ref, x, y, mc0.w, mc0.h,
                        mxg[k], myg[k], fh, qp_scaled, bd, (float)lam,
                        wts, extra, scratch.data());
                    int bx2 = mxg[k], by2 = myg[k];
                    for (int nb = 0; lam_gate && nb < 2; ++nb) {
                        size_t kn = nb == 0 ? k - 1 : k - gx;
                        if (nb == 0 && kcol == 0) continue;
                        if (nb == 1 && kk < gx) continue;
                        int nmx = mxg[kn], nmy = myg[kn];
                        if (nmx == bx2 && nmy == by2) continue;
                        double c = rd_cost_pred(
                            src_y, fw, ref, x, y, mc0.w, mc0.h, nmx,
                            nmy, fh, qp_scaled, bd, (float)lam, wts,
                            6.0, scratch.data());
                        if (c < best) { best = c; bx2 = nmx; by2 = nmy; }
                    }
                    mxg[k] = bx2; myg[k] = by2;
                    int64_t bo = base[u * n_classes + cidx] + (int64_t)k;
                    out_cost[bo] = (float)best;
                    out_mv[bo * 2] = bx2;
                    out_mv[bo * 2 + 1] = by2;
                }
            }
        };

        auto run_score = [&](const UUnit& un) {
            std::vector<int32_t> scratch(3 * 64 * 64);
            int gx = mc0.gx;
            int rows = un.y1 - un.y0;
            // per-strip winner (ref, mv) pairs for merge propagation
            std::vector<int> w_u(gx * rows);
            std::vector<int> w_mx(gx * rows), w_my(gx * rows);
            for (int kk = 0; kk < gx * rows; ++kk) {
                int krow = un.y0 + kk / gx, kcol = kk % gx;
                size_t k = (size_t)krow * gx + kcol;
                int x = mc0.x0 + kcol * mc0.sx;
                int y = mc0.y0 + krow * mc0.sy;
                // rank refs by cheap proxy cost
                int u_best = 0, ul[2] = {-1, -1};
                double p_best = 0, pl[2] = {0, 0};
                for (int u = 0; u < n_uniq; ++u) {
                    const auto& mx = res_mvx[u * n_classes + cidx];
                    const auto& my = res_mvy[u * n_classes + cidx];
                    double ex = mv_bits_est(4 * mx[k])
                                + mv_bits_est(4 * my[k]) + 4.0;
                    double pr = (double)res_ssd[u * n_classes
                                                + cidx][k] + lam * ex;
                    if (u == 0 || pr < p_best) {
                        p_best = pr; u_best = u;
                    }
                    int l = u_list != nullptr ? u_list[u] : 0;
                    if (ul[l] < 0 || pr < pl[l]) { pl[l] = pr; ul[l] = u; }
                }
                // rd-score a candidate (own mv, AMVP priced)
                auto score_own = [&](int u) {
                    const int32_t* ref =
                        reinterpret_cast<const int32_t*>(uniq_y[u]);
                    const auto& mx = res_mvx[u * n_classes + cidx];
                    const auto& my = res_mvy[u * n_classes + cidx];
                    double ex = mv_bits_est(4 * mx[k])
                                + mv_bits_est(4 * my[k]) + 4.0;
                    return rd_cost_pred(src_y, fw, ref, x, y, mc0.w,
                                        mc0.h, mx[k], my[k], fh,
                                        qp_scaled, bd, (float)lam, wts,
                                        ex, scratch.data());
                };
                size_t b_blk = (size_t)k;
                double best = score_own(u_best);
                int bu = u_best;
                int bmx = res_mvx[u_best * n_classes + cidx][k];
                int bmy = res_mvy[u_best * n_classes + cidx][k];
                // merge propagation trials: the strip-local left/up
                // winners' (ref, mv) pairs priced at merge_idx bits
                for (int nb = 0; lam_gate && nb < 2; ++nb) {
                    int kn = nb == 0 ? kk - 1 : kk - gx;
                    if (nb == 0 && kcol == 0) continue;
                    if (nb == 1 && kk < gx) continue;
                    int nu = w_u[kn], nmx = w_mx[kn], nmy = w_my[kn];
                    if (nu == bu && nmx == bmx && nmy == bmy) continue;
                    const int32_t* ref =
                        reinterpret_cast<const int32_t*>(uniq_y[nu]);
                    double c = rd_cost_pred(
                        src_y, fw, ref, x, y, mc0.w, mc0.h, nmx, nmy,
                        fh, qp_scaled, bd, (float)lam, wts, 6.0,
                        scratch.data());
                    if (c < best) {
                        best = c; bu = nu; bmx = nmx; bmy = nmy;
                    }
                }
                w_u[kk] = bu; w_mx[kk] = bmx; w_my[kk] = bmy;
                // emit: default every ref to +inf with its own ME mv
                for (int u = 0; u < n_uniq; ++u) {
                    int64_t bo = base[u * n_classes + cidx] + b_blk;
                    out_cost[bo] = 3.0e37f;
                    out_mv[bo * 2] = res_mvx[u * n_classes + cidx][k];
                    out_mv[bo * 2 + 1] =
                        res_mvy[u * n_classes + cidx][k];
                }
                int64_t bw = base[bu * n_classes + cidx] + b_blk;
                out_cost[bw] = (float)best;
                out_mv[bw * 2] = bmx;
                out_mv[bw * 2 + 1] = bmy;
                if (is_b && u_list != nullptr) {
                    for (int l = 0; l < 2; ++l) {
                        int u = ul[l];
                        if (u < 0 || u == bu) continue;
                        int64_t bo = base[u * n_classes + cidx] + b_blk;
                        float c = (float)score_own(u);
                        if (c < out_cost[bo]) out_cost[bo] = c;
                    }
                }
            }
        };
        tn = nt > (int)sunits.size() ? (int)sunits.size() : nt;
        auto score_one = [&](const UUnit& un) {
            if (is_b) run_score_full(un); else run_score(un);
        };
        if (tn <= 1) {
            for (const UUnit& un : sunits) score_one(un);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < tn; ++t)
                ths.emplace_back([&, t]() {
                    for (size_t i = t; i < sunits.size(); i += tn)
                        score_one(sunits[i]);
                });
            for (auto& th : ths) th.join();
        }
    }
}


// Finalize one P/B frame. See struct InLeaf for the input layout; outputs
// use the tree.cpp 20-int32 leaf layout + per-leaf [3] packed cbf bits +
// packed coeff planes + per-4x4 deblock maps + 8x8 TMVP field.
void fi_finalize_frame(
    int32_t* rec_y, int32_t* rec_u, int32_t* rec_v,
    const int32_t* src_y, const int32_t* src_u, const int32_t* src_v,
    uint8_t* coded_mask, int fw, int fh,
    const int64_t* l0_y, const int64_t* l0_u, const int64_t* l0_v, int n_l0,
    const int64_t* l1_y, const int64_t* l1_u, const int64_t* l1_v, int n_l1,
    const int32_t* pocs0, const int32_t* pocs1,
    const int64_t* uniq_y, int n_uniq,
    const int32_t* refmap_list, const int32_t* refmap_ref,
    const int32_t* l1_idx,
    const int8_t* col_dir, const int32_t* col_mv, const int32_t* col_refpoc,
    int col_w8, int col_h8, int col_poc, int cur_poc, int has_future_ref,
    int tmvp_on,
    int qp_y_scaled, int qp_c_scaled, int bd, int signhide,
    int is_b, int bipred_enable, int max_merge, int num_ref_merge,
    int parallel_log2, double lam, int wpp, int n_threads,
    const int32_t* in_leaves, int n,
    int32_t* out_leaves, int32_t* out_cbf,
    int32_t* coeff_y, int32_t* coeff_u, int32_t* coeff_v,
    int32_t* db_cux, int32_t* db_cuy, int32_t* db_l2w, int32_t* db_l2h,
    int32_t* db_intra, int32_t* db_cbfy, int32_t* db_cbfu, int32_t* db_cbfv,
    int32_t* db_mvx0, int32_t* db_mvy0, int32_t* db_mvx1, int32_t* db_mvy1,
    int32_t* db_rp0, int32_t* db_rp1,
    int8_t* mf_dir, int32_t* mf_mv, int32_t* mf_refpoc) {

    Ctx c;
    c.rec_y = rec_y; c.rec_u = rec_u; c.rec_v = rec_v;
    c.src_y = src_y; c.src_u = src_u; c.src_v = src_v;
    c.mask = coded_mask; c.fw = fw; c.fh = fh;
    c.l0_y = l0_y; c.l0_u = l0_u; c.l0_v = l0_v; c.n_l0 = n_l0;
    c.l1_y = l1_y; c.l1_u = l1_u; c.l1_v = l1_v; c.n_l1 = n_l1;
    c.pocs0 = pocs0; c.pocs1 = pocs1;
    c.uniq_y = uniq_y;
    c.refmap_list = refmap_list; c.refmap_ref = refmap_ref;
    c.l1_idx = l1_idx;
    c.qp_y = qp_y_scaled; c.qp_c = qp_c_scaled; c.bd = bd;
    c.signhide = signhide; c.is_b = is_b; c.bipred_en = bipred_enable;
    c.max_merge = max_merge; c.num_ref_merge = num_ref_merge;
    c.plog2 = parallel_log2; c.wpp = wpp;
    c.lam_sqrt = std::sqrt(lam);
    c.tmvp.on = tmvp_on != 0 && col_dir != nullptr;
    c.tmvp.dir = col_dir; c.tmvp.mv = col_mv; c.tmvp.refpoc = col_refpoc;
    c.tmvp.w8 = col_w8; c.tmvp.h8 = col_h8;
    c.tmvp.col_poc = col_poc; c.tmvp.cur_poc = cur_poc;
    c.tmvp.has_future = has_future_ref != 0;
    c.tmvp.pocs0 = pocs0; c.tmvp.pocs1 = pocs1;
    c.tmvp.n0 = n_l0; c.tmvp.n1 = n_l1;
    c.cu_map.init(fw, fh);
    c.hmvp.init((fh + LCU - 1) / LCU);

    const InLeaf* L = reinterpret_cast<const InLeaf*>(in_leaves);
    const bool has_chroma = rec_u != nullptr;

    float pen49[49];
    for (int k = 0; k < 49; ++k) {
        int dxq = k % 7 - 3, dyq = k / 7 - 3;
        pen49[k] = (float)(c.lam_sqrt * ((dxq == 0 ? 0.0 : 2.0)
                                         + (dyq == 0 ? 0.0 : 2.0)));
    }

    // ---- pass 1: quarter-pel refine + bipred decision (parallel over
    // leaves; references only — matches _refine_inter_leaves running
    // before any recon) ----
    struct Cand {
        int leaf, u, mvx, mvy, role;
        RefineResult rr;
    };
    std::vector<Cand> cands;
    std::vector<Desc> descs(n);
    for (int i = 0; i < n; ++i) {
        const InLeaf& lf = L[i];
        Desc& d = descs[i];
        if (lf.kind == 0) {
            d.type = 0;
            d.mode = lf.mode;
            continue;
        }
        d.type = 1;
        d.list = lf.list;
        d.ref = lf.ref;
        if (is_b && lf.has_pair) {
            cands.push_back({i, lf.u0, lf.mv0x, lf.mv0y, 0, {}});
            cands.push_back({i, lf.u1, lf.mv1x, lf.mv1y, 1, {}});
        } else {
            cands.push_back({i, lf.u, lf.mvx, lf.mvy, 0, {}});
        }
    }
    {
        int nt = n_threads > 0 ? n_threads : 1;
        if (nt > (int)cands.size()) nt = (int)cands.size();
        auto work = [&](int t0, int t1) {
            for (int ci = t0; ci < t1; ++ci) {
                Cand& cd = cands[ci];
                const InLeaf& lf = L[cd.leaf];
                const int32_t* plane =
                    reinterpret_cast<const int32_t*>(uniq_y[cd.u]);
                refine_cand(c, plane, lf.x, lf.y, lf.w, lf.h,
                            cd.mvx, cd.mvy, pen49, &cd.rr);
            }
        };
        if (nt <= 1) {
            work(0, (int)cands.size());
        } else {
            std::vector<std::thread> ths;
            int per = ((int)cands.size() + nt - 1) / nt;
            for (int t = 0; t < nt; ++t) {
                int t0 = t * per, t1 = t0 + per;
                if (t1 > (int)cands.size()) t1 = (int)cands.size();
                if (t0 >= t1) break;
                ths.emplace_back(work, t0, t1);
            }
            for (auto& th : ths) th.join();
        }
    }
    // resolve refined MVs + pair/bipred decisions (python pair loop)
    auto uni_bits = [&](int mvx, int mvy) {
        return mv_bits_est(mvx >> 2) + mv_bits_est(mvy >> 2) + 4.0;
    };
    {
        size_t ci = 0;
        std::vector<int32_t> pred_bi(64 * 64);
        while (ci < cands.size()) {
            const Cand& cd = cands[ci];
            const InLeaf& lf = L[cd.leaf];
            Desc& d = descs[cd.leaf];
            bool pair = cd.role == 0 && ci + 1 < cands.size()
                        && cands[ci + 1].leaf == cd.leaf
                        && cands[ci + 1].role == 1;
            auto refined = [&](const Cand& cc, int& mx, int& my,
                              double& s) {
                int k = cc.rr.best_k;
                mx = cc.mvx + (k % 7 - 3) * 4;
                my = cc.mvy + (k / 7 - 3) * 4;
                s = (double)(float)cc.rr.seg[k];
            };
            if (!pair) {
                double s;
                int mx, my;
                refined(cd, mx, my, s);
                d.mv[d.list][0] = mx;
                d.mv[d.list][1] = my;
                ++ci;
                continue;
            }
            const Cand& cd1 = cands[ci + 1];
            int mv0x, mv0y, mv1x, mv1y;
            double s0, s1;
            refined(cd, mv0x, mv0y, s0);
            refined(cd1, mv1x, mv1y, s1);
            double c0 = s0 + c.lam_sqrt * uni_bits(mv0x, mv0y);
            double c1 = s1 + c.lam_sqrt * uni_bits(mv1x, mv1y);
            bool have_cb = false;
            double cb = 0.0;
            if (c.bipred_en && lf.w + lf.h > 12) {
                const int32_t* p0 =
                    reinterpret_cast<const int32_t*>(uniq_y[cd.u]);
                const int32_t* p1 =
                    reinterpret_cast<const int32_t*>(uniq_y[cd1.u]);
                mc_luma_bi(p0, p1, fw, fh, lf.x, lf.y, lf.w, lf.h,
                           mv0x, mv0y, mv1x, mv1y, bd, pred_bi.data());
                std::vector<int32_t> blk(lf.w * lf.h);
                for (int yy = 0; yy < lf.h; ++yy)
                    memcpy(&blk[yy * lf.w],
                           src_y + (int64_t)(lf.y + yy) * fw + lf.x,
                           sizeof(int32_t) * lf.w);
                cb = (double)satd_any(blk.data(), pred_bi.data(), lf.w,
                                      lf.h)
                     + c.lam_sqrt * (uni_bits(mv0x, mv0y)
                                     + uni_bits(mv1x, mv1y));
                have_cb = true;
            }
            if (have_cb && cb < c0 && cb < c1) {
                d.type = 2;
                d.mv[0][0] = mv0x; d.mv[0][1] = mv0y;
                d.mv[1][0] = mv1x; d.mv[1][1] = mv1y;
                d.ref = refmap_ref[cd.u];
                d.ref1 = l1_idx[cd1.u];
            } else if (c1 < c0) {
                d.type = 1;
                if (refmap_list[cd1.u] == 1) {
                    d.list = 1;
                    d.ref = l1_idx[cd1.u];
                } else {
                    d.list = 0;
                    d.ref = refmap_ref[cd1.u];
                }
                d.mv[d.list][0] = mv1x;
                d.mv[d.list][1] = mv1y;
            } else {
                d.type = 1;
                d.list = 0;
                d.ref = refmap_ref[cd.u];
                d.mv[0][0] = mv0x;
                d.mv[0][1] = mv0y;
            }
            ci += 2;
        }
    }

    // ---- pass 2: sequential finalize (merge screen + recon + state) ----
    const int mask_w = (fw + 3) / 4;
    int64_t off_y = 0, off_c = 0;
    std::vector<int32_t> pred(64 * 64), blk(64 * 64), recbuf(64 * 64);
    std::vector<int32_t> pred_c(32 * 32), blk_c(32 * 32);

    // deferred inter reconstruction: decisions are sequential (merge
    // lists read the running CuMap/HMVP state) but the MC + residual
    // round-trips of consecutive inter CUs are independent — queue them
    // and flush in threads whenever an intra leaf needs the pixels (the
    // whole frame for intra-free stretches). Disjoint writes only.
    struct ReconJob {
        int i, x, y, w, h;
        MInfo cu;
        bool merged;
        int64_t off_y, off_c;
    };
    std::vector<ReconJob> jobs;

    auto do_recon = [&](const ReconJob& jb) {
        int32_t pred_l[32 * 32], blk_l[32 * 32], recb[32 * 32];
        int32_t* pr = pred_l;
        const MInfo& cu = jb.cu;
        if (cu.dir == 3) {
            mc_luma_bi(reinterpret_cast<const int32_t*>(l0_y[cu.ref[0]]),
                       reinterpret_cast<const int32_t*>(l1_y[cu.ref[1]]),
                       fw, fh, jb.x, jb.y, jb.w, jb.h,
                       cu.mv[0][0], cu.mv[0][1], cu.mv[1][0], cu.mv[1][1],
                       bd, pr);
        } else {
            int l = (cu.dir & 1) ? 0 : 1;
            const int64_t* ly = l == 0 ? l0_y : l1_y;
            mc_luma(reinterpret_cast<const int32_t*>(ly[cu.ref[l]]),
                    fw, fh, jb.x, jb.y, jb.w, jb.h,
                    cu.mv[l][0], cu.mv[l][1], bd, pr);
        }
        for (int yy = 0; yy < jb.h; ++yy)
            memcpy(blk_l + yy * jb.w,
                   src_y + (int64_t)(jb.y + yy) * fw + jb.x,
                   sizeof(int32_t) * jb.w);
        int32_t* cbf3 = out_cbf + (int64_t)jb.i * 3;
        int cbf_y_ = rcn::transform_quant_recon(
            blk_l, pr, jb.w, jb.h, qp_y_scaled, bd, false,
            signhide != 0, coeff_y + jb.off_y, recb);
        const int32_t* outp = cbf_y_ ? recb : pr;
        for (int yy = 0; yy < jb.h; ++yy)
            memcpy(rec_y + (int64_t)(jb.y + yy) * fw + jb.x,
                   outp + yy * jb.w, sizeof(int32_t) * jb.w);
        for (int yy = jb.y >> 2; yy < (jb.y + jb.h) >> 2; ++yy)
            for (int xx = jb.x >> 2; xx < (jb.x + jb.w) >> 2; ++xx)
                coded_mask[yy * mask_w + xx] = 1;
        cbf3[0] = cbf_y_;
        if (has_chroma) {
            int cx = jb.x >> 1, cy = jb.y >> 1;
            int cw = jb.w >> 1, ch2 = jb.h >> 1;
            int cw_stride = fw >> 1;
            for (int comp = 0; comp < 2; ++comp) {
                const int64_t* lc0 = comp == 0 ? l0_u : l0_v;
                const int64_t* lc1 = comp == 0 ? l1_u : l1_v;
                int32_t prc[16 * 16], blkc[16 * 16];
                if (cu.dir == 3) {
                    mc_chroma_bi(
                        reinterpret_cast<const int32_t*>(lc0[cu.ref[0]]),
                        reinterpret_cast<const int32_t*>(lc1[cu.ref[1]]),
                        cw_stride, fh >> 1, cx, cy, cw, ch2,
                        cu.mv[0][0], cu.mv[0][1], cu.mv[1][0],
                        cu.mv[1][1], bd, prc);
                } else {
                    int l = (cu.dir & 1) ? 0 : 1;
                    const int64_t* lc = l == 0 ? lc0 : lc1;
                    mc_chroma(
                        reinterpret_cast<const int32_t*>(lc[cu.ref[l]]),
                        cw_stride, fh >> 1, cx, cy, cw, ch2,
                        cu.mv[l][0], cu.mv[l][1], bd, prc);
                }
                const int32_t* sp = comp == 0 ? src_u : src_v;
                for (int yy = 0; yy < ch2; ++yy)
                    memcpy(blkc + yy * cw,
                           sp + (int64_t)(cy + yy) * cw_stride + cx,
                           sizeof(int32_t) * cw);
                int32_t* cf = (comp == 0 ? coeff_u : coeff_v) + jb.off_c;
                int cbf_c = rcn::transform_quant_recon(
                    blkc, prc, cw, ch2, qp_c_scaled, bd, false,
                    signhide != 0, cf, recb);
                const int32_t* oc = cbf_c ? recb : prc;
                int32_t* rp = comp == 0 ? rec_u : rec_v;
                for (int yy = 0; yy < ch2; ++yy)
                    memcpy(rp + (int64_t)(cy + yy) * cw_stride + cx,
                           oc + yy * cw, sizeof(int32_t) * cw);
                cbf3[1 + comp] = cbf_c;
            }
        }
        bool skipped = jb.merged && !cbf3[0] && !cbf3[1] && !cbf3[2];
        int32_t* orow = out_leaves + (int64_t)jb.i * 20;
        orow[7] = skipped ? 1 : 0;
        // deblock maps (single TU; inter leaves <= 32)
        int l2w = 31 - __builtin_clz((unsigned)jb.w);
        int l2h = 31 - __builtin_clz((unsigned)jb.h);
        for (int yy = jb.y >> 2; yy < (jb.y + jb.h) >> 2; ++yy)
            for (int xx = jb.x >> 2; xx < (jb.x + jb.w) >> 2; ++xx) {
                size_t gi = (size_t)yy * c.cu_map.w4 + xx;
                db_cux[gi] = jb.x;
                db_cuy[gi] = jb.y;
                db_l2w[gi] = l2w;
                db_l2h[gi] = l2h;
                db_intra[gi] = 0;
                db_cbfy[gi] = cbf3[0];
                db_cbfu[gi] = cbf3[1];
                db_cbfv[gi] = cbf3[2];
                if (cu.dir & 1) {
                    db_mvx0[gi] = cu.mv[0][0];
                    db_mvy0[gi] = cu.mv[0][1];
                    db_rp0[gi] = pocs0[cu.ref[0]];
                }
                if (cu.dir & 2) {
                    db_mvx1[gi] = cu.mv[1][0];
                    db_mvy1[gi] = cu.mv[1][1];
                    db_rp1[gi] = pocs1[cu.ref[1]];
                }
            }
    };

    auto flush_jobs = [&]() {
        if (jobs.empty()) return;
        int nt = n_threads > 0 ? n_threads : 1;
        if (nt > (int)jobs.size()) nt = (int)jobs.size();
        if (nt <= 1) {
            for (const ReconJob& jb : jobs) do_recon(jb);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < nt; ++t)
                ths.emplace_back([&, t]() {
                    for (size_t j = t; j < jobs.size(); j += nt)
                        do_recon(jobs[j]);
                });
            for (auto& th : ths) th.join();
        }
        jobs.clear();
    };

    auto mc_cand_luma = [&](const MInfo& m, int x, int y, int w, int h,
                            int32_t* out) {
        if (m.dir == 3) {
            mc_luma_bi(reinterpret_cast<const int32_t*>(l0_y[m.ref[0]]),
                       reinterpret_cast<const int32_t*>(l1_y[m.ref[1]]),
                       fw, fh, x, y, w, h, m.mv[0][0], m.mv[0][1],
                       m.mv[1][0], m.mv[1][1], bd, out);
            return;
        }
        int l = (m.dir & 1) ? 0 : 1;
        const int64_t* ly = l == 0 ? l0_y : l1_y;
        mc_luma(reinterpret_cast<const int32_t*>(ly[m.ref[l]]), fw, fh,
                x, y, w, h, m.mv[l][0], m.mv[l][1], bd, out);
    };

    for (int i = 0; i < n; ++i) {
        const InLeaf& lf = L[i];
        const Desc& d = descs[i];
        int32_t* orow = out_leaves + (int64_t)i * 20;
        memset(orow, 0, sizeof(int32_t) * 20);
        orow[0] = lf.x; orow[1] = lf.y; orow[2] = lf.w; orow[3] = lf.h;
        int32_t* cbf3 = out_cbf + (int64_t)i * 3;

        if (d.type == 0) {
            // intra CU (fast_intra_ok path: plain DCT2, mode_c = mode)
            flush_jobs();       // intra prediction reads the recon
            orow[4] = d.mode;
            orow[5] = d.mode;
            orow[6] = 1;
            rcn::recon_intra_leaf(rec_y, rec_u, rec_v, src_y, src_u, src_v,
                                  coded_mask, fw, fh, qp_y_scaled,
                                  qp_c_scaled, bd, signhide, wpp,
                                  lf.x, lf.y, lf.w, lf.h, d.mode, d.mode,
                                  coeff_y + off_y, coeff_u + off_c,
                                  coeff_v + off_c, cbf3);
            c.cu_map.set_cu(lf.x, lf.y, lf.w, lf.h, 1, MInfo());
            // deblock maps: per-TU tiling (32 max TU)
            int tw = lf.w < 32 ? lf.w : 32, th = lf.h < 32 ? lf.h : 32;
            int tnx = lf.w / tw;
            int l2w = 31 - __builtin_clz((unsigned)tw);
            int l2h = 31 - __builtin_clz((unsigned)th);
            for (int yy = lf.y >> 2; yy < (lf.y + lf.h) >> 2; ++yy)
                for (int xx = lf.x >> 2; xx < (lf.x + lf.w) >> 2; ++xx) {
                    size_t gi = (size_t)yy * c.cu_map.w4 + xx;
                    int txi = ((xx << 2) - lf.x) / tw;
                    int tyi = ((yy << 2) - lf.y) / th;
                    int t = tyi * tnx + txi;
                    db_cux[gi] = lf.x + txi * tw;
                    db_cuy[gi] = lf.y + tyi * th;
                    db_l2w[gi] = l2w;
                    db_l2h[gi] = l2h;
                    db_intra[gi] = 1;
                    db_cbfy[gi] = (cbf3[0] >> t) & 1;
                    db_cbfu[gi] = (cbf3[1] >> t) & 1;
                    db_cbfv[gi] = (cbf3[2] >> t) & 1;
                }
            off_y += (int64_t)lf.w * lf.h;
            if (has_chroma) off_c += (int64_t)(lf.w >> 1) * (lf.h >> 1);
            continue;
        }

        // ---- inter CU ----
        int mv_dir, mvs[2][2] = {{0, 0}, {0, 0}}, mv_refs[2] = {0, 0};
        if (d.type == 2) {
            mv_dir = 3;
            mvs[0][0] = d.mv[0][0]; mvs[0][1] = d.mv[0][1];
            mvs[1][0] = d.mv[1][0]; mvs[1][1] = d.mv[1][1];
            mv_refs[0] = d.ref; mv_refs[1] = d.ref1;
        } else if (d.list == 1) {
            mv_dir = 2;
            mvs[1][0] = d.mv[1][0]; mvs[1][1] = d.mv[1][1];
            mv_refs[1] = d.ref;
        } else {
            mv_dir = 1;
            mvs[0][0] = d.mv[0][0]; mvs[0][1] = d.mv[0][1];
            mv_refs[0] = d.ref;
        }

        // merge candidates + SATD screening (_finalize_sequential;
        // search_inter.c:1730-1790 merge analysis)
        MInfo mlist[MAX_CAND];
        int n_merge = derive_merge(c, lf.x, lf.y, lf.w, lf.h, mlist);
        for (int yy = 0; yy < lf.h; ++yy)
            memcpy(&blk[yy * lf.w],
                   src_y + (int64_t)(lf.y + yy) * fw + lf.x,
                   sizeof(int32_t) * lf.w);
        double best_mcost = 0.0;
        int best_midx = -1;
        MInfo best_mi;
        MInfo seen[MAX_CAND];
        int n_seen = 0;
        for (int mi = 0; mi < n_merge; ++mi) {
            const MInfo& cand = mlist[mi];
            if (cand.dir == 3 && (!c.bipred_en || lf.w + lf.h <= 12))
                continue;
            bool dup = false;
            for (int s = 0; s < n_seen; ++s)
                if (is_dup(cand, seen[s])) { dup = true; break; }
            if (dup) continue;
            seen[n_seen++] = cand;
            mc_cand_luma(cand, lf.x, lf.y, lf.w, lf.h, pred.data());
            double mbits = 1.0 + mi + (mi ? 1.0 : 0.0);
            double mcost = (double)satd_any(blk.data(), pred.data(),
                                            lf.w, lf.h)
                           + c.lam_sqrt * mbits;
            if (best_midx < 0 || mcost < best_mcost) {
                best_mcost = mcost;
                best_midx = mi;
                best_mi = cand;
            }
        }

        // phase-1 ME cost with real AMVP mvd bits
        int mvds[2][2] = {{0, 0}, {0, 0}};
        int idxs[2] = {0, 0};
        double me_bits = 1.0;
        for (int l = 0; l < 2; ++l) {
            if (!(mv_dir & (1 << l))) continue;
            const int32_t* pl = l == 0 ? pocs0 : pocs1;
            int amvp[2][2];
            derive_amvp(c, lf.x, lf.y, lf.w, lf.h, l, pl[mv_refs[l]],
                        amvp);
            int best_i = 0;
            double best_bits = 0.0;
            bool have = false;
            for (int a = 0; a < 2; ++a) {
                int dqx = (mvs[l][0] - amvp[a][0]) >> 2;
                int dqy = (mvs[l][1] - amvp[a][1]) >> 2;
                double b = mv_bits_est(dqx) + mv_bits_est(dqy);
                if (!have || b < best_bits) {
                    best_i = a;
                    best_bits = b;
                    have = true;
                }
            }
            idxs[l] = best_i;
            mvds[l][0] = (mvs[l][0] - amvp[best_i][0]) >> 2;
            mvds[l][1] = (mvs[l][1] - amvp[best_i][1]) >> 2;
            me_bits += best_bits + 1.0 + mv_refs[l];
        }
        MInfo me_mi;
        me_mi.dir = mv_dir;
        me_mi.mv[0][0] = mvs[0][0]; me_mi.mv[0][1] = mvs[0][1];
        me_mi.mv[1][0] = mvs[1][0]; me_mi.mv[1][1] = mvs[1][1];
        me_mi.ref[0] = mv_refs[0]; me_mi.ref[1] = mv_refs[1];
        mc_cand_luma(me_mi, lf.x, lf.y, lf.w, lf.h, pred.data());
        double me_cost = (double)satd_any(blk.data(), pred.data(),
                                          lf.w, lf.h)
                         + c.lam_sqrt * me_bits;

        MInfo cu = me_mi;
        bool merged = false;
        int merge_idx = 0;
        if (best_midx >= 0 && best_mcost <= me_cost) {
            merged = true;
            merge_idx = best_midx;
            cu = best_mi;
        }

        // reconstruction deferred (do_recon); decisions continue on the
        // CuMap/HMVP state alone
        jobs.push_back(ReconJob{i, lf.x, lf.y, lf.w, lf.h, cu, merged,
                                off_y, off_c});
        off_y += (int64_t)lf.w * lf.h;
        if (has_chroma) off_c += (int64_t)(lf.w >> 1) * (lf.h >> 1);

        // HMVP + map update (uvg_hmvp_add_mv)
        c.hmvp.add(lf.x, lf.y, lf.w, lf.h, cu, c.plog2);
        c.cu_map.set_cu(lf.x, lf.y, lf.w, lf.h, 2, cu);

        // packed leaf record (tree.cpp LeafEx layout); orow[7] (skip)
        // lands in do_recon once the cbfs exist
        orow[6] = 2;
        orow[8] = merged ? 1 : 0;
        orow[9] = merge_idx;
        orow[10] = cu.dir;
        if (!merged) {
            orow[11] = mvds[0][0]; orow[12] = mvds[0][1];
            orow[13] = mvds[1][0]; orow[14] = mvds[1][1];
            orow[15] = idxs[0]; orow[16] = idxs[1];
        }
        orow[17] = cu.ref[0]; orow[18] = cu.ref[1];
    }
    flush_jobs();

    // TMVP motion-field snapshot (inter_cand.build_motion_field)
    if (mf_dir != nullptr) {
        int h8 = (c.cu_map.h4 + 1) / 2, w8 = (c.cu_map.w4 + 1) / 2;
        for (int ci = 0; ci < h8; ++ci)
            for (int cj = 0; cj < w8; ++cj) {
                size_t src_i = (size_t)(ci * 2) * c.cu_map.w4 + cj * 2;
                size_t oi = (size_t)ci * w8 + cj;
                int is_inter = c.cu_map.type[src_i] == 2;
                mf_dir[oi] = is_inter ? (int8_t)c.cu_map.dir[src_i] : 0;
                mf_mv[oi * 4 + 0] = c.cu_map.mv0x[src_i];
                mf_mv[oi * 4 + 1] = c.cu_map.mv0y[src_i];
                mf_mv[oi * 4 + 2] = c.cu_map.mv1x[src_i];
                mf_mv[oi * 4 + 3] = c.cu_map.mv1y[src_i];
                int r0 = iclip(c.cu_map.ref0[src_i], 0,
                               n_l0 > 0 ? n_l0 - 1 : 0);
                int r1 = iclip(c.cu_map.ref1[src_i], 0,
                               n_l1 > 0 ? n_l1 - 1 : 0);
                mf_refpoc[oi * 2 + 0] = n_l0 > 0 ? pocs0[r0] : 0;
                mf_refpoc[oi * 2 + 1] = n_l1 > 0 ? pocs1[r1] : 0;
            }
    }
}

// --- host intra screen for P/B frames (device-free LD path) -------------
// Mirror of _get_pframe_intra_combo_fn (control/encoder.py): DC-pred
// 16x16 DCT2 roundtrip pseudo-recon of the SOURCE at the frame QP
// (ops/pseudo_recon.py), then a rough intra mode search per class block
// (planar + DC + even angulars, +-1 refine on the best angular) scored
// SATD + sqrt(lam)*mode_bits, with the winner rd-roundtripped
// (distortion vs source). Out layout matches the device screen flat
// vector: per class [modes(n) as float, costs(n)].
void fi_host_screen(const int32_t* src, int fw, int fh,
                    int qp_scaled, int bd, double lam,
                    const float* wts, const float* mode_bits,
                    const int32_t* class_desc, int n_classes,
                    int n_threads, float* out) {
    int pw = ((fw + 15) / 16) * 16, ph = ((fh + 15) / 16) * 16;
    // padded source (edge replicate)
    std::vector<int32_t> pad((size_t)pw * ph);
    for (int y = 0; y < ph; ++y) {
        int sy = y < fh ? y : fh - 1;
        const int32_t* row = src + (size_t)sy * fw;
        int32_t* dst = pad.data() + (size_t)y * pw;
        memcpy(dst, row, sizeof(int32_t) * fw);
        for (int x = fw; x < pw; ++x) dst[x] = row[fw - 1];
    }
    // pseudo recon: per 16x16 tile, DC pred + roundtrip
    std::vector<int32_t> pseudo((size_t)pw * ph);
    {
        std::vector<int> tiles;
        for (int ty = 0; ty < ph; ty += 16)
            for (int tx = 0; tx < pw; tx += 16)
                tiles.push_back(ty * pw + tx);
        auto run_tile = [&](int off) {
            int32_t blk[256], pred[256], coef[256], rec[256];
            const int32_t* sp = pad.data() + off;
            int64_t sum = 0;
            for (int yy = 0; yy < 16; ++yy)
                for (int xx = 0; xx < 16; ++xx) {
                    blk[yy * 16 + xx] = sp[yy * pw + xx];
                    sum += blk[yy * 16 + xx];
                }
            int32_t dc = (int32_t)((sum + 128) >> 8);
            for (int i = 0; i < 256; ++i) pred[i] = dc;
            rcn::transform_quant_recon(blk, pred, 16, 16, qp_scaled, bd,
                                       true, false, coef, rec);
            int32_t* dp = pseudo.data() + off;
            for (int yy = 0; yy < 16; ++yy)
                memcpy(dp + yy * pw, rec + yy * 16,
                       sizeof(int32_t) * 16);
        };
        int nt = n_threads > 1 ? n_threads : 1;
        if (nt <= 1) {
            for (int off : tiles) run_tile(off);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < nt; ++t)
                ths.emplace_back([&, t]() {
                    for (size_t i = t; i < tiles.size(); i += nt)
                        run_tile(tiles[i]);
                });
            for (auto& th : ths) th.join();
        }
    }
    std::vector<uint8_t> mask((size_t)(pw / 4) * (ph / 4), 1);
    double lam_sqrt = std::sqrt(lam);

    // per-class offsets in the out vector
    std::vector<int64_t> base(n_classes);
    int64_t off = 0;
    for (int c = 0; c < n_classes; ++c) {
        const int32_t* d = class_desc + c * 8;
        base[c] = off;
        off += 2LL * d[6] * d[7];
    }
    struct Unit { int c, y0, y1; };
    std::vector<Unit> units;
    for (int c = 0; c < n_classes; ++c) {
        const int32_t* d = class_desc + c * 8;
        for (int y0 = 0; y0 < d[7]; y0 += 4)
            units.push_back({c, y0, y0 + 4 < d[7] ? y0 + 4 : d[7]});
    }
    auto run_unit = [&](const Unit& un) {
        const int32_t* d = class_desc + un.c * 8;
        int w = d[0], h = d[1], x0 = d[2], y0g = d[3];
        int sx = d[4], sy = d[5], gx = d[6], gy = d[7];
        rcn::Refs refs;
        std::vector<int32_t> pbuf((size_t)w * h), best_p((size_t)w * h);
        std::vector<int32_t> blk((size_t)w * h), rec((size_t)w * h);
        for (int by = un.y0; by < un.y1; ++by)
            for (int bx = 0; bx < gx; ++bx) {
                int x = x0 + bx * sx, y = y0g + by * sy;
                rcn::build_reference(pseudo.data(), pw, mask.data(),
                                     pw / 4, ph / 4, x, y, w, h, pw, ph,
                                     bd, false, &refs, false);
                for (int yy = 0; yy < h; ++yy)
                    for (int xx = 0; xx < w; ++xx)
                        blk[yy * w + xx] =
                            pad[(size_t)(y + yy) * pw + x + xx];
                int bmode = 0;
                double bcost = 1e30;
                int64_t bsatd = 0;
                auto try_mode = [&](int m) {
                    rcn::predict_intra(m, w, h, &refs, bd, false,
                                       pbuf.data());
                    int64_t sa = satd_any(pbuf.data(), blk.data(), w, h);
                    double cost = (double)sa + lam_sqrt * mode_bits[m];
                    if (cost < bcost) {
                        bcost = cost; bmode = m; bsatd = sa;
                        std::swap(pbuf, best_p);
                    }
                };
                try_mode(0);
                try_mode(1);
                // coarse step-6 angular sweep + local refine: the host
                // screen trades mode-search density for CPU (the device
                // screen evaluates all 67; this is a search heuristic,
                // not a conformance surface)
                for (int m = 2; m <= 66; m += 6) try_mode(m);
                try_mode(66);
                if (bmode >= 2) {
                    for (int dm = -2; dm <= 2; ++dm) {
                        int m = bmode + dm;
                        if (dm != 0 && m >= 2 && m <= 66) try_mode(m);
                    }
                }
                int64_t ssd = 0;
                double bits = 0.0;
                rcn::rd_roundtrip(blk.data(), best_p.data(), w, h,
                                  qp_scaled, bd, true, wts, &ssd, &bits,
                                  rec.data());
                int64_t k = base[un.c] + (int64_t)by * gx + bx;
                int64_t n_blk = (int64_t)gx * gy;
                out[k] = (float)bmode;
                out[k + n_blk] = (float)(ssd
                                         + lam * (bits
                                                  + mode_bits[bmode]));
            }
    };
    int nt = n_threads > 1 ? n_threads : 1;
    if (nt <= 1) {
        for (const Unit& un : units) run_unit(un);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; ++t)
            ths.emplace_back([&, t]() {
                for (size_t i = t; i < units.size(); i += nt)
                    run_unit(units[i]);
            });
        for (auto& th : ths) th.join();
    }
}

}  // extern "C"
