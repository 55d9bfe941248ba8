// Native entropy coder: VVC CABAC engine + bulk residual coefficient writer.
//
// The sequential phase-2 of the two-phase encoder design (SURVEY.md §7):
// arithmetic bin coding is inherently serial per substream, so it runs as
// native host code — the counterpart of the reference's C hot path
// (/root/reference/src/cabac.c, strategies/generic/encode_coding_tree-
// generic.c). Engine semantics are identical to the verified Python
// implementation (uvg266_jax/bitstream/cabac.py), which stays as the
// golden model; byte-identical output is asserted in tests.
//
// Exposed as a minimal C ABI for ctypes. Granular bin calls serve the
// low-frequency structural syntax; encode_coeff_nxn runs the entire
// residual block in one call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int MASK0 = 0x7FE0;
constexpr int MASK1 = 0x7FFE;

const uint8_t RENORM_TABLE[32] = {
    6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};

const uint8_t GROUP_IDX[64] = {
    0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
    8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9,
    10,10,10,10,10,10,10,10,10,10,10,10,10,10,10,10,
    11,11,11,11,11,11,11,11,11,11,11,11,11,11,11,11,
};
const uint8_t MIN_IN_GROUP[14] = {0,1,2,3,4,6,8,12,16,24,32,48,64,96};
const uint8_t GO_RICE_PARS[32] = {
    0,0,0,0,0,0,0,1,1,1,1,1,1,1,2,2,2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3};
const int LAST_PREFIX_CTX[8] = {0, 0, 0, 3, 6, 10, 15, 21};

struct EntropyCoder {
    // bitstream (with NAL emulation prevention)
    std::vector<uint8_t> buf;
    uint32_t data = 0;       // pending partial byte
    int cur_bit = 0;
    int zerocount = 0;
    // CABAC engine
    uint32_t low = 0;
    uint32_t range = 510;
    uint32_t buffered_byte = 0xFF;
    int num_buffered_bytes = 0;
    int bits_left = 23;
    // contexts
    std::vector<uint16_t> s0, s1;
    std::vector<uint8_t> r0, r1;
    // context-id bases (set from Python's OFF map at init)
    int off_sig_group = 0;
    int off_sig_luma[3] = {0, 0, 0};
    int off_sig_chroma[3] = {0, 0, 0};
    int off_par_luma = 0, off_par_chroma = 0;
    int off_gt1_luma = 0, off_gt1_chroma = 0;
    int off_gt2_luma = 0, off_gt2_chroma = 0;
    int off_last_x_luma = 0, off_last_x_chroma = 0;
    int off_last_y_luma = 0, off_last_y_chroma = 0;

    void put_byte(uint8_t b) {
        if (zerocount == 2 && b < 4) {
            buf.push_back(0x03);
            zerocount = 0;
        }
        zerocount = (b == 0) ? zerocount + 1 : 0;
        buf.push_back(b);
    }

    void put(uint32_t value, int bits) {
        for (int i = bits - 1; i >= 0; --i) {
            data = ((data << 1) | ((value >> i) & 1)) & 0xFF;
            if (++cur_bit == 8) {
                cur_bit = 0;
                put_byte((uint8_t)data);
                data = 0;
            }
        }
    }

    void write_out() {
        uint32_t lead_byte = low >> (24 - bits_left);
        bits_left += 8;
        low &= 0xFFFFFFFFu >> bits_left;
        if (lead_byte == 0xFF) {
            num_buffered_bytes++;
        } else if (num_buffered_bytes > 0) {
            uint32_t carry = lead_byte >> 8;
            put_byte((uint8_t)(buffered_byte + carry));
            buffered_byte = lead_byte & 0xFF;
            uint8_t fill = (uint8_t)(0xFF + carry);
            for (int i = 0; i < num_buffered_bytes - 1; ++i) put_byte(fill);
            num_buffered_bytes = 1;
        } else {
            num_buffered_bytes = 1;
            buffered_byte = lead_byte;
        }
    }

    inline void update_ctx(int ctx, int binval) {
        int rate0 = r0[ctx], rate1 = r1[ctx];
        s0[ctx] -= (s0[ctx] >> rate0) & MASK0;
        s1[ctx] -= (s1[ctx] >> rate1) & MASK1;
        if (binval) {
            s0[ctx] += (0x7FFF >> rate0) & MASK0;
            s1[ctx] += (0x7FFF >> rate1) & MASK1;
        }
    }

    void encode_bin(int ctx, int binval) {
        uint32_t state8 = ((uint32_t)s0[ctx] + s1[ctx]) >> 8;
        uint32_t q = (state8 & 0x80) ? (state8 ^ 0xFF) : state8;
        uint32_t lps = (((q >> 2) * (range >> 5)) >> 1) + 4;
        range -= lps;
        if ((uint32_t)(binval ? 1 : 0) != (state8 >> 7)) {
            int num_bits = RENORM_TABLE[lps >> 3];
            low = (low + range) << num_bits;
            range = lps << num_bits;
            bits_left -= num_bits;
            if (bits_left < 12) write_out();
        } else if (range < 256) {
            low <<= 1;
            range <<= 1;
            if (--bits_left < 12) write_out();
        }
        update_ctx(ctx, binval);
    }

    void encode_bin_ep(int binval) {
        low <<= 1;
        if (binval) low += range;
        if (--bits_left < 12) write_out();
    }

    void encode_bins_ep(uint32_t binvals, int num_bins) {
        if (range == 256) {
            int rem = num_bins;
            while (rem > 0) {
                int n = rem < 8 ? rem : 8;
                uint32_t mask = (1u << n) - 1;
                uint32_t nb = (binvals >> (rem - n)) & mask;
                low = (low << n) + (nb << 8);
                rem -= n;
                bits_left -= n;
                if (bits_left < 12) write_out();
            }
            return;
        }
        while (num_bins > 8) {
            num_bins -= 8;
            uint32_t pattern = binvals >> num_bins;
            low = (low << 8) + range * pattern;
            binvals -= pattern << num_bins;
            bits_left -= 8;
            if (bits_left < 12) write_out();
        }
        low = (low << num_bins) + range * binvals;
        bits_left -= num_bins;
        if (bits_left < 12) write_out();
    }

    void encode_bin_trm(int binval) {
        range -= 2;
        if (binval) {
            low += range;
            low <<= 7;
            range = 2 << 7;
            bits_left -= 7;
        } else if (range >= 256) {
            return;
        } else {
            low <<= 1;
            range <<= 1;
            bits_left -= 1;
        }
        if (bits_left < 12) write_out();
    }

    void finish() {
        if (low >> (32 - bits_left)) {
            put_byte((uint8_t)(buffered_byte + 1));
            for (int i = 0; i < num_buffered_bytes - 1; ++i) put_byte(0);
            low -= 1u << (32 - bits_left);
        } else {
            if (num_buffered_bytes > 0) put_byte((uint8_t)buffered_byte);
            for (int i = 0; i < num_buffered_bytes - 1; ++i) put_byte(0xFF);
        }
        put(low >> 8, 24 - bits_left);
        num_buffered_bytes = 0;
    }

    void encode_trunc_bin(uint32_t value, uint32_t max_value) {
        int thresh;
        if (max_value > 256) {
            thresh = 8;
            uint32_t tv = 1 << 8;
            while (tv <= max_value) { thresh++; tv <<= 1; }
            thresh--;
        } else {
            thresh = 0;
            for (uint32_t v = max_value; v > 1; v >>= 1) thresh++;
        }
        uint32_t val = 1u << thresh;
        uint32_t b = max_value - val;
        if (value < val - b) encode_bins_ep(value, thresh);
        else encode_bins_ep(value + val - b, thresh + 1);
    }

    void write_coeff_remain(uint32_t remainder, int rice, int cutoff) {
        uint32_t threshold = (uint32_t)cutoff << rice;
        if (remainder < threshold) {
            int length = (remainder >> rice) + 1;
            encode_bins_ep((1u << length) - 2, length);
            encode_bins_ep(remainder & ((1u << rice) - 1), rice);
            return;
        }
        int max_prefix_length = 32 - cutoff - 15;
        int prefix_length = 0;
        uint32_t code_value = (remainder >> rice) - cutoff;
        int suffix_length;
        if (code_value >= (1u << max_prefix_length) - 1) {
            prefix_length = max_prefix_length;
            suffix_length = 15;
        } else {
            while (code_value > (2u << prefix_length) - 2) prefix_length++;
            suffix_length = prefix_length + rice + 1;
        }
        int total_prefix_length = prefix_length + cutoff;
        uint32_t bit_mask = (1u << rice) - 1;
        uint32_t prefix = (1u << total_prefix_length) - 1;
        uint32_t suffix = ((code_value - ((1u << prefix_length) - 1)) << rice)
                          | (remainder & bit_mask);
        encode_bins_ep(prefix, total_prefix_length);
        encode_bins_ep(suffix, suffix_length);
    }
};

// residual coding context derivations (context.c:688, :846)
inline void sig_ctx_maps(const int32_t* c, int w, int h, int is_luma,
                         std::vector<int16_t>& sig, std::vector<int16_t>& off,
                         std::vector<int8_t>& rice4, std::vector<int8_t>& rice0) {
    sig.resize(w * h);
    off.resize(w * h);
    rice4.resize(w * h);
    rice0.resize(w * h);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int32_t* d = c + y * w + x;
            int sum_abs = 0, num = 0, sum_all = 0;
            auto upd = [&](int32_t v) {
                int a = v < 0 ? -v : v;
                sum_abs += a < 4 + (a & 1) ? a : 4 + (a & 1);
                num += a ? 1 : 0;
                sum_all += a;
            };
            if (x < w - 1) {
                upd(d[1]);
                if (x < w - 2) upd(d[2]);
                if (y < h - 1) upd(d[w + 1]);
            }
            if (y < h - 1) {
                upd(d[w]);
                if (y < h - 2) upd(d[2 * w]);
            }
            int diag = x + y;
            int ctx = ((sum_abs + 1) >> 1 < 3 ? (sum_abs + 1) >> 1 : 3)
                      + (diag < 2 ? 4 : 0);
            if (is_luma) ctx += diag < 5 ? 4 : 0;
            sig[y * w + x] = (int16_t)ctx;
            int tsum = sum_abs - num;
            int o = (tsum < 4 ? tsum : 4) + 1;
            if (diag == 0) o += is_luma ? 15 : 5;
            else if (is_luma) o += diag < 3 ? 10 : (diag < 10 ? 5 : 0);
            off[y * w + x] = (int16_t)o;
            int sa4 = sum_all - 20;
            sa4 = sa4 < 0 ? 0 : (sa4 > 31 ? 31 : sa4);
            rice4[y * w + x] = (int8_t)GO_RICE_PARS[sa4];
            int sa0 = sum_all > 31 ? 31 : sum_all;
            rice0[y * w + x] = (int8_t)GO_RICE_PARS[sa0];
        }
    }
}

}  // namespace

extern "C" {

EntropyCoder* ec_create() { return new EntropyCoder(); }
void ec_free(EntropyCoder* ec) { delete ec; }

// Initialize contexts from Python-provided packed state
// (s0/s1 uint16, r0/r1 uint8, length n), plus context family offsets.
void ec_set_contexts(EntropyCoder* ec, const uint16_t* s0, const uint16_t* s1,
                     const uint8_t* r0, const uint8_t* r1, int n) {
    ec->s0.assign(s0, s0 + n);
    ec->s1.assign(s1, s1 + n);
    ec->r0.assign(r0, r0 + n);
    ec->r1.assign(r1, r1 + n);
}

void ec_get_contexts(EntropyCoder* ec, uint16_t* s0, uint16_t* s1) {
    memcpy(s0, ec->s0.data(), ec->s0.size() * sizeof(uint16_t));
    memcpy(s1, ec->s1.data(), ec->s1.size() * sizeof(uint16_t));
}

int ec_ctx_count(EntropyCoder* ec) { return (int)ec->s0.size(); }

// restore adaptive states only (rate tables are invariant per slice);
// used by the WPP tree writer for row-to-row context inheritance
void ec_set_states(EntropyCoder* ec, const uint16_t* s0,
                   const uint16_t* s1) {
    memcpy(ec->s0.data(), s0, ec->s0.size() * sizeof(uint16_t));
    memcpy(ec->s1.data(), s1, ec->s1.size() * sizeof(uint16_t));
}

void ec_set_offsets(EntropyCoder* ec, const int32_t* offs) {
    int i = 0;
    ec->off_sig_group = offs[i++];
    for (int k = 0; k < 3; ++k) ec->off_sig_luma[k] = offs[i++];
    for (int k = 0; k < 3; ++k) ec->off_sig_chroma[k] = offs[i++];
    ec->off_par_luma = offs[i++];
    ec->off_par_chroma = offs[i++];
    ec->off_gt1_luma = offs[i++];
    ec->off_gt1_chroma = offs[i++];
    ec->off_gt2_luma = offs[i++];
    ec->off_gt2_chroma = offs[i++];
    ec->off_last_x_luma = offs[i++];
    ec->off_last_x_chroma = offs[i++];
    ec->off_last_y_luma = offs[i++];
    ec->off_last_y_chroma = offs[i++];
}

void ec_start(EntropyCoder* ec, int zerocount) {
    ec->low = 0;
    ec->range = 510;
    ec->bits_left = 23;
    ec->num_buffered_bytes = 0;
    ec->buffered_byte = 0xFF;
    ec->buf.clear();
    ec->data = 0;
    ec->cur_bit = 0;
    ec->zerocount = zerocount;
}

void ec_bin(EntropyCoder* ec, int ctx, int b) { ec->encode_bin(ctx, b); }
void ec_bin_ep(EntropyCoder* ec, int b) { ec->encode_bin_ep(b); }
void ec_bins_ep(EntropyCoder* ec, uint32_t v, int n) { ec->encode_bins_ep(v, n); }
void ec_trm(EntropyCoder* ec, int b) { ec->encode_bin_trm(b); }
void ec_finish(EntropyCoder* ec) { ec->finish(); }
void ec_trunc_bin(EntropyCoder* ec, uint32_t v, uint32_t mx) {
    ec->encode_trunc_bin(v, mx);
}
void ec_put(EntropyCoder* ec, uint32_t v, int bits) { ec->put(v, bits); }
void ec_coeff_remain(EntropyCoder* ec, uint32_t rem, int rice, int cutoff) {
    ec->write_coeff_remain(rem, rice, cutoff);
}
void ec_unary_max_ep(EntropyCoder* ec, uint32_t symbol, uint32_t max_symbol) {
    int code_last = max_symbol > symbol;
    ec->encode_bin_ep(symbol ? 1 : 0);
    if (!symbol) return;
    while (symbol > 1) {
        symbol--;
        ec->encode_bin_ep(1);
    }
    if (code_last) ec->encode_bin_ep(0);
}
void ec_ep_ex_golomb(EntropyCoder* ec, uint32_t symbol, int count) {
    uint32_t bins = 0;
    int num_bins = 0;
    while (symbol >= (1u << count)) {
        bins = 2 * bins + 1;
        num_bins++;
        symbol -= 1u << count;
        count++;
    }
    bins = 2 * bins;
    num_bins++;
    bins = (bins << count) | symbol;
    num_bins += count;
    ec->encode_bins_ep(bins, num_bins);
}

int64_t ec_num_bytes(EntropyCoder* ec) { return (int64_t)ec->buf.size(); }
void ec_copy_bytes(EntropyCoder* ec, uint8_t* out) {
    memcpy(out, ec->buf.data(), ec->buf.size());
}
int ec_pending_bits(EntropyCoder* ec) { return ec->cur_bit; }
uint32_t ec_pending_data(EntropyCoder* ec) { return ec->data; }
int ec_zerocount(EntropyCoder* ec) { return ec->zerocount; }

// Bulk residual block encode (encode_coding_tree-generic.c:54-325).
// scan / scan_cg: int32 scan tables; returns constraint flag bitmask:
//   bit0 violates_lfnst, bit1 lfnst_last_scan_pos, bit2 mts_last_scan_pos
int32_t ec_coeff_nxn(EntropyCoder* ec, const int32_t* coeff, int w, int h,
                     int is_luma, int dep_quant, int signhide,
                     const int32_t* scan, const int32_t* scan_cg,
                     int log2_cg_w, int log2_cg_h) {
    const int log2_cg_size = log2_cg_w + log2_cg_h;
    const int cg_grid_w = w >> log2_cg_w;
    const int cg_grid_h = h >> log2_cg_h;
    const int num_cg = cg_grid_w * cg_grid_h;

    std::vector<uint8_t> sig_cg(num_cg, 0);
    int scan_pos_last = -1;
    for (int i = 0; i < w * h; ++i) {
        if (coeff[scan[i]]) {
            scan_pos_last = i;
            sig_cg[scan_cg[i >> log2_cg_size]] = 1;
        }
    }
    int scan_cg_last = scan_pos_last >> log2_cg_size;
    int pos_last = scan[scan_pos_last];
    int last_y = pos_last / w;
    int last_x = pos_last - last_y * w;

    std::vector<int16_t> sig_map, off_map;
    std::vector<int8_t> rice4, rice0;
    sig_ctx_maps(coeff, w, h, is_luma, sig_map, off_map, rice4, rice0);

    // last_sig_coeff_xy
    {
        int lw = 0, lh = 0;
        for (int v = w; v > 1; v >>= 1) lw++;
        for (int v = h; v > 1; v >>= 1) lh++;
        int off_x = is_luma ? LAST_PREFIX_CTX[lw] : 0;
        int off_y = is_luma ? LAST_PREFIX_CTX[lh] : 0;
        int shift_x, shift_y;
        if (is_luma) {
            shift_x = (lw + 1) >> 2;
            shift_y = (lh + 1) >> 2;
        } else {
            shift_x = (w >> 3) < 0 ? 0 : ((w >> 3) > 2 ? 2 : (w >> 3));
            shift_y = (h >> 3) < 0 ? 0 : ((h >> 3) > 2 ? 2 : (h >> 3));
        }
        int base_x = is_luma ? ec->off_last_x_luma : ec->off_last_x_chroma;
        int base_y = is_luma ? ec->off_last_y_luma : ec->off_last_y_chroma;
        int gx = GROUP_IDX[last_x], gy = GROUP_IDX[last_y];
        int i;
        for (i = 0; i < gx; ++i) ec->encode_bin(base_x + off_x + (i >> shift_x), 1);
        if (gx < GROUP_IDX[(w < 32 ? w : 32) - 1])
            ec->encode_bin(base_x + off_x + (gx >> shift_x), 0);
        for (i = 0; i < gy; ++i) ec->encode_bin(base_y + off_y + (i >> shift_y), 1);
        if (gy < GROUP_IDX[(h < 32 ? h : 32) - 1])
            ec->encode_bin(base_y + off_y + (gy >> shift_y), 0);
        if (gx > 3) ec->encode_bins_ep(last_x - MIN_IN_GROUP[gx], (gx - 2) >> 1);
        if (gy > 3) ec->encode_bins_ep(last_y - MIN_IN_GROUP[gy], (gy - 2) >> 1);
    }

    const uint32_t dq_table = dep_quant ? 32040 : 0;
    int quant_state = 0;
    int reg_bins = (w * h * 28) >> 4;
    int mts_last = 0;

    const int base_cg_ctx = ec->off_sig_group + (is_luma ? 0 : 2);
    const int* sig_base = is_luma ? ec->off_sig_luma : ec->off_sig_chroma;
    const int gt1_base = is_luma ? ec->off_gt1_luma : ec->off_gt1_chroma;
    const int gt2_base = is_luma ? ec->off_gt2_luma : ec->off_gt2_chroma;
    const int par_base = is_luma ? ec->off_par_luma : ec->off_par_chroma;

    for (int i = scan_cg_last; i >= 0; --i) {
        int cg_blk_pos = scan_cg[i];
        int cg_pos_y = cg_blk_pos / cg_grid_w;
        int cg_pos_x = cg_blk_pos - cg_pos_y * cg_grid_w;

        if (i == scan_cg_last || i == 0) {
            sig_cg[cg_blk_pos] = 1;
        } else {
            int right = cg_pos_x + 1 < cg_grid_w ? sig_cg[cg_blk_pos + 1] : 0;
            int lower = cg_pos_y + 1 < cg_grid_h ? sig_cg[cg_blk_pos + cg_grid_w] : 0;
            ec->encode_bin(base_cg_ctx + ((right || lower) ? 1 : 0),
                           sig_cg[cg_blk_pos]);
        }
        if (!sig_cg[cg_blk_pos]) continue;

        int min_sub_pos = i << log2_cg_size;
        int first_sig_pos = (i == scan_cg_last)
                                ? scan_pos_last
                                : min_sub_pos + (1 << log2_cg_size) - 1;
        int next_sig_pos = first_sig_pos;
        int infer_sig_pos = (next_sig_pos != scan_pos_last)
                                ? (i != 0 ? min_sub_pos : -1)
                                : next_sig_pos;
        int num_non_zero = 0;
        int last_nz = -1;
        int first_nz = next_sig_pos;
        uint64_t coeff_signs = 0;

        for (; next_sig_pos >= min_sub_pos && reg_bins >= 4; --next_sig_pos) {
            int blk_pos = scan[next_sig_pos];
            int val = coeff[blk_pos];
            int sig = val ? 1 : 0;
            if (num_non_zero || next_sig_pos != infer_sig_pos) {
                int ctx_sig = sig_map[blk_pos];
                int base = sig_base[quant_state - 1 > 0 ? quant_state - 1 : 0];
                ec->encode_bin(base + (is_luma ? ctx_sig
                                               : (ctx_sig < 7 ? ctx_sig : 7)),
                               sig);
                reg_bins--;
            }
            if (sig) {
                int off = next_sig_pos == scan_pos_last ? 0 : off_map[blk_pos];
                num_non_zero++;
                last_nz = last_nz > next_sig_pos ? last_nz : next_sig_pos;
                first_nz = next_sig_pos;
                int rem = (val < 0 ? -val : val) - 1;
                coeff_signs = (next_sig_pos != scan_pos_last ? 2 * coeff_signs
                                                             : coeff_signs)
                              + (val < 0 ? 1 : 0);
                int gt1 = rem ? 1 : 0;
                ec->encode_bin(gt1_base + off, gt1);
                reg_bins--;
                if (gt1) {
                    rem -= 1;
                    ec->encode_bin(par_base + off, rem & 1);
                    rem >>= 1;
                    reg_bins--;
                    ec->encode_bin(gt2_base + off, rem ? 1 : 0);
                    reg_bins--;
                }
            }
            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((val & 1) << 1))) & 3;
        }

        for (int sp = first_sig_pos; sp > next_sig_pos; --sp) {
            int blk_pos = scan[sp];
            int a = coeff[blk_pos] < 0 ? -coeff[blk_pos] : coeff[blk_pos];
            if (a >= 4)
                ec->write_coeff_remain((a - 4) >> 1, rice4[blk_pos], 5);
        }

        for (int sp = next_sig_pos; sp >= min_sub_pos; --sp) {
            int blk_pos = scan[sp];
            int a = coeff[blk_pos] < 0 ? -coeff[blk_pos] : coeff[blk_pos];
            int rice = rice0[blk_pos];
            int pos0 = (quant_state < 2 ? 1 : 2) << rice;
            uint32_t remainder = a == 0 ? pos0 : (a <= pos0 ? a - 1 : a);
            ec->write_coeff_remain(remainder, rice, 5);
            quant_state = (dq_table >> ((quant_state << 2)
                                        + ((a & 1) << 1))) & 3;
            if (a) {
                num_non_zero++;
                first_nz = sp;
                last_nz = last_nz > sp ? last_nz : sp;
                coeff_signs = (coeff_signs << 1) + (coeff[blk_pos] < 0 ? 1 : 0);
            }
        }

        int num_signs = num_non_zero;
        if (signhide && !dep_quant && last_nz - first_nz >= 4) {
            num_signs--;
            coeff_signs >>= 1;
        }
        if (is_luma) mts_last |= first_sig_pos > 0;
        ec->encode_bins_ep((uint32_t)coeff_signs, num_signs);
    }

    int max_lfnst_pos = ((w == 4 && h == 4) || (w == 8 && h == 8)) ? 7 : 15;
    int32_t flags = 0;
    if (w >= 4 && h >= 4 && scan_pos_last > max_lfnst_pos) flags |= 1;
    if (scan_pos_last >= 1) flags |= 2;
    if (mts_last) flags |= 4;
    return flags;
}

}  // extern "C"
