"""Pure-Python/numpy MPEG-1/2/2.5 Audio Layer III decoder.

Copied from ``bauklank_tpu/runtime/mp3.py`` (host code; nothing of it
runs on a device).  The reference kiosk's default content is mp3
(reference app/multi/app.mjs:10-22); this is a from-spec implementation
(ISO 11172-3 + the 13818-3 LSF extensions); the large spec constant
tables (scalefactor bands, the 34 Huffman trees, the synthesis window)
live in ``mp3_tables.py``, extracted from libmpg123 by
``tools/mp3spec/extract_mpg123_tables.py`` rather than hand-transcribed.
``tests/test_torch_runtime.py`` holds this copy bit-equal to the JAX
package's on the committed fixture.

Validation of the JAX package's copy (tests/test_mp3.py):
- bitstream discipline: every granule's Huffman+scalefactor read must
  land exactly on part2_3_length for every frame of the test material —
  a desync-sensitive structural check of the Huffman tables and region
  logic;
- PCM: >= 60 dB vs libmpg123's own decode (via pygame/SDL_mixer) on the
  committed fixtures, after decoder-delay alignment.

Scope: MPEG-1, MPEG-2 and MPEG-2.5, mono + stereo, long/short/mixed
blocks, MS stereo, intensity stereo (both the MPEG-1 tan-ratio and LSF
pow-2 laws), the bit reservoir, free-format excluded.  CBR and VBR both
work (frames are parsed individually; Xing/Info metadata frames decode
as the silence they contain).
"""

from __future__ import annotations

import math

import numpy as np

from . import mp3_tables as T

# ---------------------------------------------------------------------------
# constants

_BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
_BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)
_SR = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000), 0: (11025, 12000, 8000)}
# bandInfo row: 44100,48000,32000,22050,24000,16000,11025,12000,8000
_BAND_ROW = {3: 0, 2: 3, 0: 6}

_PRETAB = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0)

_SLEN1 = (0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4)
_SLEN2 = (0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3)

# LSF scalefactor group sizes (ISO 13818-3; mpg123 stab):
# rows: long / short / mixed; cols: 3 normal ranges then 3 intensity ranges
_LSF_NSFB = (
    ((6, 5, 5, 5), (6, 5, 7, 3), (11, 10, 0, 0),
     (7, 7, 7, 0), (6, 6, 6, 3), (8, 8, 5, 0)),
    ((9, 9, 9, 9), (9, 9, 12, 6), (18, 18, 0, 0),
     (12, 12, 12, 0), (12, 9, 9, 6), (15, 12, 9, 0)),
    ((6, 9, 9, 9), (6, 9, 12, 6), (15, 18, 0, 0),
     (6, 15, 12, 0), (6, 12, 9, 6), (6, 18, 9, 0)),
)

_CS_CA = None


def _alias_coefs():
    global _CS_CA
    if _CS_CA is None:
        c = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                      -0.0037])
        cs = 1.0 / np.sqrt(1.0 + c * c)
        _CS_CA = (cs, c * cs)
    return _CS_CA


# ---------------------------------------------------------------------------
# bit reader


class _Bits:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        q = p + n
        self.pos = q
        b0 = p >> 3
        b1 = (q + 7) >> 3
        chunk = int.from_bytes(self.buf[b0:b1], "big")
        return (chunk >> ((b1 << 3) - q)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# header / side info


class _Header:
    __slots__ = ("version", "sr", "sr_idx", "bitrate", "padding", "mode",
                 "mode_ext", "protection", "frame_size", "lsf", "channels",
                 "band_row")


def _parse_header(d: bytes, i: int):
    if i + 4 > len(d):
        return None
    b0, b1, b2, b3 = d[i], d[i + 1], d[i + 2], d[i + 3]
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    ver = (b1 >> 3) & 3        # 0=2.5, 1=reserved, 2=MPEG2, 3=MPEG1
    layer = (b1 >> 1) & 3      # 1 = Layer III
    if ver == 1 or layer != 1:
        return None
    br_idx = (b2 >> 4) & 15
    sr_idx = (b2 >> 2) & 3
    if br_idx in (0, 15) or sr_idx == 3:
        return None
    h = _Header()
    h.version = ver
    h.lsf = ver != 3
    h.sr = _SR[ver][sr_idx]
    h.sr_idx = sr_idx
    h.band_row = _BAND_ROW[ver] + sr_idx
    h.bitrate = (_BITRATES_V1 if ver == 3 else _BITRATES_V2)[br_idx] * 1000
    h.padding = (b2 >> 1) & 1
    h.protection = not (b1 & 1)
    h.mode = (b3 >> 6) & 3
    h.mode_ext = (b3 >> 4) & 3
    h.channels = 1 if h.mode == 3 else 2
    per = 72 if h.lsf else 144
    h.frame_size = per * h.bitrate // h.sr + h.padding
    return h


class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "window_switching", "block_type",
                 "mixed", "table_select", "subblock_gain", "region0",
                 "region1", "preflag", "scalefac_scale", "count1table",
                 "scalefac_l", "scalefac_s", "max_sf")


def _read_side_info(h: _Header, bits: _Bits):
    nch = h.channels
    if h.lsf:
        main_data_begin = bits.read(8)
        bits.read(1 if nch == 1 else 2)
        n_gr = 1
        scfsi = [[0] * 4 for _ in range(nch)]
    else:
        main_data_begin = bits.read(9)
        bits.read(5 if nch == 1 else 3)
        scfsi = [[bits.read(1) for _ in range(4)] for _ in range(nch)]
        n_gr = 2
    grs = []
    for _ in range(n_gr):
        chs = []
        for _ in range(nch):
            g = _Granule()
            g.part2_3_length = bits.read(12)
            g.big_values = bits.read(9)
            g.global_gain = bits.read(8)
            g.scalefac_compress = bits.read(9 if h.lsf else 4)
            g.window_switching = bits.read(1)
            if g.window_switching:
                g.block_type = bits.read(2)
                g.mixed = bits.read(1)
                g.table_select = [bits.read(5), bits.read(5), 0]
                g.subblock_gain = [bits.read(3) for _ in range(3)]
                # implicit region split (mpg123 III_get_side_info): the
                # constants 36/54 are longIdx[6]/longIdx[8] evaluated on
                # the MPEG-1/2 band tables; MPEG-2.5 must read the
                # current rate's table (8 kHz: 72/108, which is why only
                # that rate exposed the difference)
                if h.version == 0:       # MPEG-2.5
                    r0c = 5 if (g.block_type == 2 and not g.mixed) else 7
                    g.region0 = T.SFB_LONG[h.band_row][r0c + 1]
                elif not h.lsf or g.block_type == 2:
                    g.region0 = 36
                else:                    # MPEG-2 start/stop
                    g.region0 = 54
                g.region1 = 576
            else:
                g.block_type = 0
                g.mixed = 0
                g.table_select = [bits.read(5) for _ in range(3)]
                r0 = bits.read(4)
                r1 = bits.read(3)
                long_idx = T.SFB_LONG[h.band_row]
                g.region0 = long_idx[min(r0 + 1, 22)]
                g.region1 = long_idx[min(r0 + 1 + r1 + 1, 22)]
                g.subblock_gain = [0, 0, 0]
            g.preflag = 0 if h.lsf else bits.read(1)
            g.scalefac_scale = bits.read(1)
            g.count1table = bits.read(1)
            chs.append(g)
        grs.append(chs)
    return main_data_begin, scfsi, grs


# ---------------------------------------------------------------------------
# scalefactors


def _read_scalefactors_v1(g: _Granule, bits: _Bits, scfsi, gr_idx, prev):
    s1, s2 = _SLEN1[g.scalefac_compress], _SLEN2[g.scalefac_compress]
    sf_l = [0] * 23
    sf_s = [[0] * 3 for _ in range(13)]
    if g.block_type == 2:
        if g.mixed:
            for b in range(8):
                sf_l[b] = bits.read(s1)
            for b in range(3, 6):
                for w in range(3):
                    sf_s[b][w] = bits.read(s1)
            for b in range(6, 12):
                for w in range(3):
                    sf_s[b][w] = bits.read(s2)
        else:
            for b in range(6):
                for w in range(3):
                    sf_s[b][w] = bits.read(s1)
            for b in range(6, 12):
                for w in range(3):
                    sf_s[b][w] = bits.read(s2)
    else:
        groups = ((0, 6, s1), (6, 11, s1), (11, 16, s2), (16, 21, s2))
        for gi, (lo, hi, sl) in enumerate(groups):
            if gr_idx == 1 and scfsi[gi]:
                for b in range(lo, hi):
                    sf_l[b] = prev.scalefac_l[b]
            else:
                for b in range(lo, hi):
                    sf_l[b] = bits.read(sl)
    g.scalefac_l, g.scalefac_s = sf_l, sf_s
    # ISO 11172-3 2.4.3.4.12: the illegal intensity-position marker is
    # FIXED at 7 for MPEG-1 regardless of slen (the per-slen
    # (1<<slen)-1 rule is the LSF law only, _read_scalefactors_lsf)
    g.max_sf = 7


def _lsf_slen(g: _Granule, intensity: bool):
    """Slen + group sizes for LSF scalefactors (ISO 13818-3 / mpg123
    n_slen2 & i_slen2 construction)."""
    sfc = g.scalefac_compress
    if intensity:
        isf = sfc >> 1
        if isf < 180:
            slen = (isf // 36, (isf % 36) // 6, isf % 6, 0)
            col = 3
        elif isf < 244:
            j = isf - 180
            slen = ((j >> 4) & 3, (j >> 2) & 3, j & 3, 0)
            col = 4
        else:
            j = isf - 244
            slen = (j // 3, j % 3, 0, 0)
            col = 5
        preflag = 0
    else:
        if sfc < 400:
            slen = ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc % 16) >> 2, sfc % 4)
            col = 0
            preflag = 0
        elif sfc < 500:
            j = sfc - 400
            slen = ((j >> 2) // 5, (j >> 2) % 5, j & 3, 0)
            col = 1
            preflag = 0
        else:
            j = sfc - 500
            slen = (j // 3, j % 3, 0, 0)
            col = 2
            preflag = 1
    row = 2 if (g.block_type == 2 and g.mixed) else (1 if g.block_type == 2 else 0)
    return slen, _LSF_NSFB[row][col], preflag


def _read_scalefactors_lsf(g: _Granule, bits: _Bits, intensity: bool):
    slen, nsfb, preflag = _lsf_slen(g, intensity)
    g.preflag = preflag
    raw = []
    g.max_sf = 0
    for cnt, sl in zip(nsfb, slen):
        for _ in range(cnt):
            raw.append(bits.read(sl))
        if cnt:
            g.max_sf = max(g.max_sf, (1 << sl) - 1)
    sf_l = [0] * 23
    sf_s = [[0] * 3 for _ in range(13)]
    if g.block_type == 2:
        if g.mixed:
            n_long = 6
            for b in range(n_long):
                sf_l[b] = raw[b] if b < len(raw) else 0
            rest = raw[n_long:]
            for i, v in enumerate(rest):
                b, w = 3 + i // 3, i % 3
                if b < 13:
                    sf_s[b][w] = v
        else:
            for i, v in enumerate(raw):
                b, w = i // 3, i % 3
                if b < 13:
                    sf_s[b][w] = v
    else:
        for b, v in enumerate(raw):
            if b < 23:
                sf_l[b] = v
    g.scalefac_l, g.scalefac_s = sf_l, sf_s


# ---------------------------------------------------------------------------
# Huffman


def _huff_pair(bits: _Bits, table: int):
    """Decode one big-value (x, y) pair via the 4-bit LUT chunks."""
    tree = T.HUFF_TREES[table]
    if not tree:
        return 0, 0
    base = 0
    while True:
        idx = bits.read(4)
        e = tree[base + idx]
        if e >= 0:
            bits.pos -= 4 - (e >> 8)   # only e>>8 bits belong to this code
            v = e & 0xFF
            return v >> 4, v & 15
        base += -e


def _huff_quad(bits: _Bits, table: int):
    tree = T.COUNT1_TREES[table]
    pos = 0
    while True:
        a = tree[pos]
        pos += 1
        if a >= 0:
            return a
        if bits.read(1):
            pos += -a - 1


def _decode_spectrum(h: _Header, g: _Granule, bits: _Bits, part2_3_end: int):
    is_ = np.zeros(576, np.float64)
    linbits = T.LINBITS
    i = 0
    limit = min(g.big_values * 2, 576)
    for region_end, tbl in ((min(g.region0, limit), g.table_select[0]),
                            (min(g.region1, limit), g.table_select[1]),
                            (limit, g.table_select[2])):
        lb = linbits[tbl]
        while i < region_end:
            x, y = _huff_pair(bits, tbl)
            if x == 15 and lb:
                x += bits.read(lb)
            if x:
                if bits.read(1):
                    x = -x
            if y == 15 and lb:
                y += bits.read(lb)
            if y:
                if bits.read(1):
                    y = -y
            is_[i] = x
            is_[i + 1] = y
            i += 2
    # count1 region
    while bits.pos < part2_3_end and i <= 572:
        quad = _huff_quad(bits, g.count1table)
        for j, bit in enumerate((quad >> 3 & 1, quad >> 2 & 1,
                                 quad >> 1 & 1, quad & 1)):
            if bit:
                v = -1 if bits.read(1) else 1
                is_[i + j] = v
        i += 4
    if bits.pos > part2_3_end:
        # the last quad straddled the boundary: it was stuffing, drop it
        is_[i - 4 : i] = 0
        i -= 4
    bits.pos = part2_3_end
    return is_, i


# ---------------------------------------------------------------------------
# requantize / reorder / stereo / alias / imdct / synthesis


def _requantize(h: _Header, g: _Granule, is_: np.ndarray) -> np.ndarray:
    long_idx = T.SFB_LONG[h.band_row]
    short_idx = T.SFB_SHORT[h.band_row]
    xr = np.sign(is_) * np.abs(is_) ** (4.0 / 3.0)
    gain = 0.25 * (g.global_gain - 210.0)
    mult = 0.5 * (g.scalefac_scale + 1.0)
    exp = np.full(576, gain)
    if g.block_type == 2:
        # mixed blocks: the long region covers the first two subbands
        # (36 samples) — 8 long sfbs for MPEG-1 (long_idx[8] == 36), 6 for
        # LSF where the tables place the same boundary at long_idx[6]
        start_short = (long_idx[6] if h.lsf else long_idx[8]) if g.mixed else 0
        if g.mixed:
            for b in range(8):
                lo, hi = long_idx[b], long_idx[b + 1]
                if lo >= start_short:
                    break
                hi = min(hi, start_short)
                exp[lo:hi] -= mult * (g.scalefac_l[b]
                                      + g.preflag * _PRETAB[b])
        first_b = 3 if g.mixed else 0
        # 13 regions: 12 scalefactor bands + the catch-all up to 192
        # (mpg123 bandInfo shortIdx[13] = 192; its scalefactor is 0 but
        # subblock gain and reordering still apply — at 8 kHz the
        # catch-all spans 26 of 192 samples per window, audibly wrong
        # if skipped)
        for b in range(first_b, 13):
            lo3 = 3 * short_idx[b]
            width = short_idx[b + 1] - short_idx[b]
            sf_b = g.scalefac_s[b] if b < 12 else (0, 0, 0)
            for w in range(3):
                lo = lo3 + w * width
                exp[lo : lo + width] -= (2.0 * g.subblock_gain[w]
                                         + mult * sf_b[w])
    else:
        for b in range(21):
            lo, hi = long_idx[b], long_idx[b + 1]
            exp[lo:hi] -= mult * (g.scalefac_l[b] + g.preflag * _PRETAB[b])
    return xr * np.exp2(exp)


def _reorder_short(h: _Header, g: _Granule, xr: np.ndarray) -> np.ndarray:
    if g.block_type != 2:
        return xr
    short_idx = T.SFB_SHORT[h.band_row]
    out = xr.copy()
    first_b = 3 if g.mixed else 0
    for b in range(first_b, 13):          # incl. the catch-all band
        start, end = short_idx[b], short_idx[b + 1]
        width = end - start
        seg = xr[3 * start : 3 * end]
        out[3 * start : 3 * end] = seg.reshape(3, width).T.reshape(-1)
    return out


def _stereo(h: _Header, g_l: _Granule, g_r: _Granule, xr, gr_chs_raw):
    """MS and intensity stereo (in place on xr [2, 576])."""
    ms = bool(h.mode_ext & 2)
    intensity = bool(h.mode_ext & 1)
    if not intensity:
        if ms:
            m = (xr[0] + xr[1]) * (1.0 / math.sqrt(2.0))
            s = (xr[0] - xr[1]) * (1.0 / math.sqrt(2.0))
            xr[0], xr[1] = m, s
        return
    # intensity bound: last nonzero sample of the right channel, rounded
    # up to a scalefactor band boundary; intensity applies above it.
    long_idx = T.SFB_LONG[h.band_row]
    short_idx = T.SFB_SHORT[h.band_row]
    nz = np.nonzero(gr_chs_raw[1])[0]
    bound = int(nz[-1]) + 1 if len(nz) else 0
    if bound:
        # round UP to the next scalefactor-band boundary (the encoder zeroes
        # the right channel from an sfb boundary; a mid-band bound would
        # leave the straddling band's tail neither intensity- nor MS-processed)
        bnds = np.asarray(3 * np.asarray(short_idx) if g_r.block_type == 2
                          else long_idx)
        bound = int(bnds[int(np.searchsorted(bnds, bound))])
    sqrt2_inv = 1.0 / math.sqrt(2.0)

    def is_factors(is_pos):
        if h.lsf:
            # ISO 13818-3 LSF law: io^ceil(is_pos/2) on one side, the side
            # chosen by parity; io selected by intensity_scale (sfc bit 0).
            # Best-effort: no LSF-intensity fixture exists to pin this.
            if is_pos == 0:
                return 1.0, 1.0
            io = 2.0 ** -0.5 if (g_r.scalefac_compress & 1) == 0 else 2.0 ** -0.25
            k = io ** ((is_pos + 1) >> 1)
            return (k, 1.0) if is_pos & 1 else (1.0, k)
        r = math.tan(is_pos * math.pi / 12.0)
        if math.isinf(r) or r < 0:
            return 1.0, 1.0
        return r / (1.0 + r), 1.0 / (1.0 + r)

    def apply(lo, hi, is_pos, illegal):
        if illegal:
            if ms:
                m = (xr[0, lo:hi] + xr[1, lo:hi]) * sqrt2_inv
                s = (xr[0, lo:hi] - xr[1, lo:hi]) * sqrt2_inv
                xr[0, lo:hi], xr[1, lo:hi] = m, s
            return
        fl, fr = is_factors(is_pos)
        left = xr[0, lo:hi].copy()
        xr[0, lo:hi] = left * fl
        xr[1, lo:hi] = left * fr

    if g_r.block_type == 2:
        for b in range(13):               # incl. the catch-all band
            lo3 = 3 * short_idx[b]
            width = short_idx[b + 1] - short_idx[b]
            for w in range(3):
                lo = lo3 + w * width
                hi = lo + width
                if lo >= bound:
                    # ISO 2.4.3.4.12: above the last sfb the previous
                    # band's is_pos extends
                    is_pos = g_r.scalefac_s[min(b, 11)][w]
                    apply(lo, hi, is_pos, is_pos == g_r.max_sf)
        below = slice(0, min(bound, 576))
        if ms:
            m = (xr[0, below] + xr[1, below]) * sqrt2_inv
            s = (xr[0, below] - xr[1, below]) * sqrt2_inv
            xr[0, below], xr[1, below] = m, s
    else:
        for b in range(22):
            lo, hi = long_idx[b], long_idx[min(b + 1, 22)]
            if lo >= bound:
                # ISO 2.4.3.4.12: above the last transmitted sfb (b=21,
                # never in the bitstream) the previous band's is_pos extends
                is_pos = g_r.scalefac_l[min(b, 20)]
                apply(lo, hi, is_pos, is_pos == g_r.max_sf)
        below = slice(0, min(bound, 576))
        if ms:
            m = (xr[0, below] + xr[1, below]) * sqrt2_inv
            s = (xr[0, below] - xr[1, below]) * sqrt2_inv
            xr[0, below], xr[1, below] = m, s


def _alias(g: _Granule, xr: np.ndarray) -> np.ndarray:
    if g.block_type == 2 and not g.mixed:
        return xr
    nb = 1 if (g.block_type == 2 and g.mixed) else 31
    cs, ca = _alias_coefs()
    for sb in range(nb):
        up = xr[sb * 18 + 10 : sb * 18 + 18][::-1].copy()   # xr[17-i]
        lo = xr[sb * 18 + 18 : sb * 18 + 26].copy()          # xr[18+i]
        xr[sb * 18 + 10 : sb * 18 + 18] = (up * cs - lo * ca)[::-1]
        xr[sb * 18 + 18 : sb * 18 + 26] = lo * cs + up * ca
    return xr


_IMDCT_LONG = None
_IMDCT_SHORT = None
_WIN = None


def _imdct_mats():
    global _IMDCT_LONG, _IMDCT_SHORT, _WIN
    if _IMDCT_LONG is None:
        i = np.arange(36)[:, None]
        k = np.arange(18)[None, :]
        _IMDCT_LONG = np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
        i = np.arange(12)[:, None]
        k = np.arange(6)[None, :]
        _IMDCT_SHORT = np.cos(np.pi / 24.0 * (2 * i + 1 + 6) * (2 * k + 1))
        w0 = np.sin(np.pi / 36.0 * (np.arange(36) + 0.5))
        w1 = w0.copy()
        w1[18:24] = 1.0
        w1[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
        w1[30:] = 0.0
        w3 = w0.copy()
        w3[:6] = 0.0
        w3[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
        w3[12:18] = 1.0
        ws = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
        _WIN = (w0, w1, None, w3, ws)
    return _IMDCT_LONG, _IMDCT_SHORT, _WIN


def _imdct_granule(g: _Granule, xr: np.ndarray, overlap: np.ndarray):
    """xr [576] -> time samples [18, 32] (+ carry in `overlap` [32, 18])."""
    mlong, mshort, wins = _imdct_mats()
    X = xr.reshape(32, 18)
    out = np.empty((32, 36))
    if g.block_type == 2:
        n_long = 2 if g.mixed else 0
        if n_long:
            z = X[:n_long] @ mlong.T
            out[:n_long] = z * wins[0]
        for sb in range(n_long, 32):
            buf = np.zeros(36)
            for w in range(3):
                zz = (mshort @ X[sb, w::3][:6]) * wins[4]
                buf[6 + w * 6 : 18 + w * 6] += zz
            out[sb] = buf
    else:
        z = X @ mlong.T
        out[:] = z * wins[g.block_type]
    first = out[:, :18] + overlap
    overlap[:] = out[:, 18:]
    # frequency inversion: odd subbands negate odd time samples
    first[1::2, 1::2] = -first[1::2, 1::2]
    return first.T.copy()   # [18, 32] time-major


_SYN_N = None
_SYN_D = None


def _synth_consts():
    global _SYN_N, _SYN_D
    if _SYN_N is None:
        i = np.arange(64)[:, None]
        k = np.arange(32)[None, :]
        _SYN_N = np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)
        half = np.asarray(T.INTWINBASE, np.float64) / 65536.0   # |D|[0..256]
        d = np.empty(512)
        d[:257] = half
        d[257:] = half[255:0:-1]        # plain mirror: |D| is symmetric
        # ISO Table B.3 signs: D alternates sign every 64 coefficients
        # (mpg123 tabinit applies the same flip when expanding intwinbase).
        # Verified vs the libmpg123 PCM oracle: this pattern scores ~85 dB
        # on lame-encoded tonal material; every other mirror/flip/start
        # combination scores <9 dB.
        d *= np.where((np.arange(512) // 64) % 2 == 0, 1.0, -1.0)
        _SYN_D = d
    return _SYN_N, _SYN_D


class _Synth:
    """ISO polyphase synthesis filterbank state (one channel)."""

    def __init__(self):
        self.v = np.zeros(1024)

    def run(self, s_block: np.ndarray) -> np.ndarray:
        """s_block [18, 32] -> [576] PCM."""
        n, d = _synth_consts()
        out = np.empty((18, 32))
        v = self.v
        for t in range(18):
            v = np.concatenate([n @ s_block[t], v[:960]])
            u = v.reshape(16, 64)
            w0 = u[0::2, :32].reshape(-1)   # V[128i + j]
            w1 = u[1::2, 32:].reshape(-1)   # V[128i + 96 + j]
            out[t] = (w0 * d.reshape(16, 32)[0::2].reshape(-1)).reshape(8, 32).sum(0) \
                + (w1 * d.reshape(16, 32)[1::2].reshape(-1)).reshape(8, 32).sum(0)
        self.v = v
        return out.reshape(-1)


# ---------------------------------------------------------------------------
# frame loop


def _skip_id3(d: bytes, i: int) -> int:
    if d[i : i + 3] == b"ID3" and i + 10 <= len(d):
        size = ((d[i + 6] & 0x7F) << 21) | ((d[i + 7] & 0x7F) << 14) \
            | ((d[i + 8] & 0x7F) << 7) | (d[i + 9] & 0x7F)
        return i + 10 + size + (10 if d[i + 5] & 0x10 else 0)
    return i


def decode_mp3(data: bytes, check_bits: bool = False):
    """Decode an MPEG-1/2/2.5 Layer III stream.

    Returns ``(pcm [channels, n] float32, sample_rate)``.  With
    ``check_bits`` every granule asserts the spectrum read consumed
    exactly ``part2_3_length`` bits (test harness mode)."""
    i = _skip_id3(data, 0)
    reservoir = b""
    synths = None
    overlaps = None
    chunks = []
    hdr0 = None
    while i + 4 <= len(data):
        h = _parse_header(data, i)
        if h is None or i + h.frame_size > len(data):
            i += 1
            continue
        if hdr0 is None:
            hdr0 = h
            synths = [_Synth() for _ in range(h.channels)]
            overlaps = [np.zeros((32, 18)) for _ in range(h.channels)]
        elif (h.sr, h.channels) != (hdr0.sr, hdr0.channels):
            i += 1
            continue
        frame = data[i : i + h.frame_size]
        off = 4 + (2 if h.protection else 0)
        side_len = (9 if h.channels == 1 else 17) if h.lsf else \
                   (17 if h.channels == 1 else 32)
        side = _Bits(frame, off * 8)
        main_data_begin, scfsi, grs = _read_side_info(h, side)
        main_rest = frame[off + side_len :]
        if main_data_begin > len(reservoir):
            # not enough reservoir (stream start / seek): skip this frame
            reservoir = (reservoir + main_rest)[-511:]
            chunks.append(np.zeros((h.channels,
                                    576 * (1 if h.lsf else 2)), np.float32))
            i += h.frame_size
            continue
        main = (reservoir[len(reservoir) - main_data_begin :] if main_data_begin
                else b"") + main_rest
        bits = _Bits(main, 0)
        pcm = np.zeros((h.channels, 576 * len(grs)), np.float32)
        for gr_idx, chs in enumerate(grs):
            xrs = np.zeros((h.channels, 576))
            raws = []
            for ch, g in enumerate(chs):
                start = bits.pos
                if h.lsf:
                    _read_scalefactors_lsf(
                        g, bits, intensity=(ch == 1 and bool(h.mode_ext & 1)))
                else:
                    _read_scalefactors_v1(g, bits, scfsi[ch], gr_idx,
                                          grs[0][ch])
                end = start + g.part2_3_length
                is_, _ = _decode_spectrum(h, g, bits, end)
                if check_bits:
                    assert bits.pos == end
                raws.append(is_)
                xrs[ch] = _requantize(h, g, is_)
            if h.channels == 2:
                _stereo(h, chs[0], chs[1], xrs, raws)
            for ch, g in enumerate(chs):
                xr = _reorder_short(h, g, xrs[ch])
                xr = _alias(g, xr)
                tb = _imdct_granule(g, xr, overlaps[ch])
                pcm[ch, gr_idx * 576 : (gr_idx + 1) * 576] = synths[ch].run(tb)
        chunks.append(pcm)
        reservoir = (reservoir + main_rest)[-511:]
        i += h.frame_size
    if not chunks:
        raise ValueError("no Layer III frames found")
    return np.concatenate(chunks, axis=1).astype(np.float32), hdr0.sr
