"""Mode 'F': the fast profile — LZ77 tokens + per-block STATIC
rANS, round-4 architecture ("F2").

The round-3 fast profile still decoded one BYTE per lane per scan step and
re-ranked static tables with [S, W] compares — the sort-finder's ~50
whole-array element gathers dominating encode, and the per-byte copy
machinery plus
4 slot reads dominating decode.  F2 restructures both sides around
whole-block vector passes:

encode (all whole-block vector passes, no per-byte scan):
  1. sort-based candidate finder, rebuilt on 64-byte ROW gathers: a
     [N/4, 16]-word sliding table makes one row gather deliver a full
     64-byte candidate window, so K candidates cost K gathers, not K*16;
  2. the shared flexible price-DP parse (block._parse_body);
  3. a slim replay scan derives token boundaries; tokens are compacted
     to flat arrays with one scatter (token = literal byte | match);
  4. one histogram pass -> static tables (normalize_freqs);
  5. a reverse rANS while_loop over ceil(n_tok/S) steps encodes three
     slots per token (SYM, XTR1, XTR2) and builds the COMPACT stream
     on-device (transposed one-hot window writes — the round-3 words
     grid shipped 6N bytes over the host link; F2 ships ~0.15N).

decode:
  1. a while_loop over ceil(n_tok/S) steps entropy-decodes one TOKEN per
     lane per step: the static slot->(sym, cum) table is ONE [S]-row
     gather (no [S, W] compare), stream reads keep the exact one-hot
     window machinery (ops/rans.py);
  2. an elementwise pass packs each token into one u32
     (literal byte, or (dist << 8) | (len - min_len) for a match —
     match codes are >= 256 so the two cases self-disambiguate);
  3. the native sequence executor (csrc/native.c f2_execute) materializes
     output bytes at memcpy speed on the host — the LZ copy chain is the
     one sequential dependency lock-step lanes cannot express without a
     gather per byte, and it is exactly the part a host core does at
     GB/s.  Decode therefore no longer needs the lane-causality mask:
     matches may source ANY earlier position (pure position order), a
     strict candidate superset of round 3's step-causal sources.

Alphabet: SYM = literal byte (0..255) | 256 + dist_bucket*13 + len_bucket
(dist buckets 0..23 = floor(log2 d), 24 = repeat-previous-distance; len
buckets: v = len-min_len, v < 8 direct, else 5 + floor(log2 v)).  The
distance and length mantissas concatenate into one bit string carried by
up to two table-free uniform events (XTR1 <= 15 bits, XTR2 the rest).

The static tables ride the payload verbatim (u16 per symbol, normalized
to sum exactly M); the decoder validates the sum, rebuilds the slot
table, and the drain + content-CRC checks are the corruption detectors.

No reference analogue: richox/comprox has no fast profile; this is the
capability an accelerator deployment needs to cover the zstd/gzip speed
class with
the same container, dictionary, and lane-interleaved entropy layer.
"""

from __future__ import annotations

import dataclasses
import functools
import os as _os
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from comprox_tpu.codec.block import (
    BlockParams,
    _bytes_eq_count,
    _diag_run_len,
    _dist_bucket,
    _greedy_decisions,
    _lane_ids,
    _pack_words,
    _parse_body,
    _search_and_parse,
)
from comprox_tpu.models import tables as tb
from comprox_tpu.ops import rans
from comprox_tpu.ops.rans_scalar import M, M_BITS, RANS_L
from comprox_tpu.utils import native

_i32 = jnp.int32
_u32 = jnp.uint32

# 'sort' = the row-gather sort finder below; 'scan' = the adaptive codecs'
# per-step search scan (mode-'X' machinery; ~100x slower encode, kept for
# ratio sweeps)
_F_FINDER = _os.environ.get("CPX_F_FINDER", "sort")
_F_CANDS = int(_os.environ.get("CPX_F_CANDS", "2"))

L_DIRECT = 8  # len buckets 0..7 code v directly
L_BUCKETS = 13  # 8 direct + log buckets for v in [8, 250]
DB_REPEAT = 24  # distance bucket "== previous distance"
W_SYM = 256 + 25 * L_BUCKETS  # 581
N_SLOTS = 3  # SYM, XTR1, XTR2

# parse prices for the STATIC-table profile, fifths of a bit: literals
# cost their static entropy (~5-6 b), not the adaptive PPM's ~2 b —
# using X's prices measured +0.27 bpb in round 3.
_F_PRICES = tuple(
    int(_os.environ.get(k, d))
    for k, d in (
        ("CPX_F_PARSE_LIT", "28"),
        ("CPX_F_PARSE_M", "45"),
        ("CPX_F_PARSE_K", "6"),
        ("CPX_F_PARSE_REP", "30"),
    )
)

# u32 words per candidate row; usable direct extension = 4*(EXTW-1)
# bytes (longer matches recover via the diagonal-run rule or chain as
# further tokens)
_EXTW = int(_os.environ.get("CPX_F_EXTW", "16"))
# include _diag_run_len's final-byte extension (one [N] gather per
# candidate).  Measured ratio-identical to 4
# decimals at 2 MiB with it off — lengths at most 1 short, and only on
# diagonal-run boundaries — so the fast profile defaults it off.
_F_DIAG_TAIL = _os.environ.get("CPX_F_DIAG_TAIL", "0") == "1"


def _search_params(p: BlockParams) -> BlockParams:
    """Mode F reuses the 'X' parse pricing machinery."""
    return dataclasses.replace(p, mode="X")


def _flat_excl_cumsum(x):
    """[N] i32 exclusive prefix sum (Hillis-Steele doubling)."""
    n = x.shape[0]
    acc = x
    k = 1
    while k < n:
        acc = acc + jnp.pad(acc, (k, 0))[:n]
        k *= 2
    return acc - x


def _last_nonzero_fill(e):
    """[N] i32 -> at each i, the last nonzero value at index <= i (0 if
    none yet).  log2(N) select passes."""
    n = e.shape[0]
    k = 1
    while k < n:
        e = jnp.where(e > 0, e, jnp.pad(e, (k, 0))[:n])
        k *= 2
    return e


def _len_code(v):
    """v = len - min_len in [0, 250] -> (bucket, extra_bits, mantissa)."""
    k = (
        3
        + (v >= 16).astype(_i32)
        + (v >= 32).astype(_i32)
        + (v >= 64).astype(_i32)
        + (v >= 128).astype(_i32)
    )
    direct = v < L_DIRECT
    lb = jnp.where(direct, v, 5 + k)
    bits = jnp.where(direct, 0, k)
    mant = jnp.where(direct, 0, v - jnp.left_shift(jnp.ones_like(v), k))
    return lb, bits, mant


def _len_decode(lb, mant):
    direct = lb < L_DIRECT
    k = jnp.clip(lb - 5, 0, 7)
    return jnp.where(direct, lb, jnp.left_shift(jnp.ones_like(lb), k) + mant)


# --------------------------------------------------------------------------
# Candidate finder: one stable sort + one 64-byte row gather per candidate.
# --------------------------------------------------------------------------


def _f2_find(p: BlockParams, inp_flat, n):
    """K previous-occurrence candidates per position with word-extended
    lengths, via whole-block vector ops.  Decode is host-sequential in F2,
    so the only causality requirement is position order (cand < pos) —
    which the stable (hash, pos) sort gives for free.  Lengths stay capped
    at the lane-region end (the replay scan's rem-chains are per-region).

    Returns [(len [N], src [N])] * n_cands, nearest occurrence first."""
    N = p.capacity
    pad = 4 * _EXTW + 16
    bi = jnp.pad(inp_flat, (0, pad)).astype(_i32)
    bs = [bi[k : k + N + pad - 4] for k in range(4)]
    w_all = (bs[0] | (bs[1] << 8) | (bs[2] << 16) | (bs[3] << 24)).astype(
        _u32
    )
    idx = jnp.arange(N, dtype=_i32)
    w45 = bi[4 : 4 + N] | (bi[5 : 5 + N] << 8)
    h = w_all[:N] * _u32(0x9E3779B1) ^ w45.astype(_u32) * _u32(0x85EBCA77)
    valid = idx < n
    h = jnp.where(valid, h, _u32(0xFFFFFFFF))
    hs, ps = jax.lax.sort((h, idx), num_keys=1, is_stable=True)
    prevs = []
    for k in range(1, _F_CANDS + 1):
        pk = jnp.concatenate([jnp.full((k,), -1, _i32), ps[:-k]])
        hk = jnp.concatenate([jnp.zeros((k,), _u32), hs[:-k]])
        prevs.append(jnp.where(hk == hs, pk, -1))
    # back to position order by SORTING on ps (a permutation; keys are
    # unique, so stability does not matter) instead of an [N, K] scatter
    unsorted = jax.lax.sort((ps,) + tuple(prevs), num_keys=1)
    cand_cols = unsorted[1:]
    # sliding row table: rows[r, k] = word at byte 4*(r + k) — one row
    # gather = a 64-byte window at any 4-aligned start (alignment fixed
    # up with one elementwise byte shift below)
    w4 = w_all[::4]
    R = w4.shape[0] - _EXTW
    rows = jnp.stack([w4[k : k + R] for k in range(_EXTW)], axis=1)

    t_of = idx % p.steps
    cap = jnp.maximum(
        jnp.minimum(jnp.minimum(p.steps - t_of, n - idx), p.window), 0
    )
    out = []
    for k in range(_F_CANDS):
        cand = cand_cols[k]
        ok = (cand >= 0) & valid
        safe = jnp.clip(cand, 0, N - 1)
        rowc = rows[jnp.minimum(safe >> 2, R - 1)]  # [N, EXTW] u32
        # realign to start exactly at byte `safe`: shift out (safe & 3)
        sh = ((safe & 3) * 8).astype(_u32)[:, None]
        lo = rowc[:, : _EXTW - 1] >> sh
        hi = rowc[:, 1:_EXTW] << ((_u32(32) - sh) & _u32(31))
        wc = lo | jnp.where(sh > 0, hi, _u32(0))  # [N, EXTW-1]
        L = jnp.zeros((N,), _i32)
        alive = ok
        for j in range(_EXTW - 1):
            x = wc[:, j] ^ w_all[4 * j : 4 * j + N]
            m = _bytes_eq_count(x)
            L = L + jnp.where(alive, m, 0)
            alive = alive & (x == 0)
        # diagonal-run recovery: word extension caps at 60 bytes, but
        # runs on one diagonal (zeros, periodic content) measure to the
        # full window for free
        eq1 = (((wc[:, 0] ^ w_all[:N]) & _u32(0xFF)) == 0) & ok
        diag = jnp.concatenate(
            [cand[1:] == cand[:-1] + 1, jnp.zeros((1,), bool)]
        )
        L = jnp.maximum(L, _diag_run_len(eq1, diag, with_tail=_F_DIAG_TAIL))
        out.append((jnp.minimum(jnp.where(ok, L, 0), cap), cand))
    return out


def _fast_find_matches(p: BlockParams, inp_flat, n):
    """Candidates + parse -> per-step decision grids (ts [T], take [T,S],
    src [T,S]) in the shared block._search_and_parse contract."""
    if _F_FINDER == "scan":
        px = _search_params(p)
        inp = inp_flat.reshape(p.lanes, p.steps)
        inp_w32 = _pack_words(inp_flat)
        inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
        return _search_and_parse(px, inp_pad, inp_flat, inp_w32, n)
    cands = _f2_find(p, inp_flat, n)

    def grid(v):
        return v.reshape(p.lanes, p.steps).T

    outs = tuple(g for l, s in cands for g in (grid(l), grid(s)))
    ts = jnp.arange(p.steps, dtype=_i32)
    if p.flexible:
        cw0 = jnp.zeros((p.lanes, p.window), _i32)
        parse = functools.partial(
            _parse_body,
            _search_params(p),
            n,
            n_c=_F_CANDS,
            prices=_F_PRICES,
        )
        _, (take, src_g, _idx) = jax.lax.scan(
            parse, cw0, (ts,) + outs, reverse=True
        )
    else:
        take, src_g = _greedy_decisions(_search_params(p), n, outs)
    return ts, take, src_g


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


def _replay_body(p: BlockParams, inp, n, carry, xs):
    """Forward replay of parse decisions -> per-step token-boundary grids
    (the rem-chain is the one sequential dependency; everything else is
    whole-array).  No prev-distance here: repeat detection is GLOBAL token
    order, resolved after flattening (_tokenize)."""
    (rem,) = carry
    t, take, src = xs
    lanes = _lane_ids(p.lanes)
    pos = lanes * p.steps + t
    active = pos < n
    start = active & (rem == 0)
    is_m = start & (take > 0)
    dist = jnp.where(is_m, jnp.maximum(pos - src, 1), 0)
    length = jnp.where(is_m, take, 0)
    new_rem = jnp.where(is_m, take - 1, jnp.maximum(rem - 1, 0))
    byte = jax.lax.dynamic_slice(inp, (0, t), (p.lanes, 1))[:, 0].astype(
        _i32
    )
    return (new_rem,), (start, is_m, dist, length, byte)


def _tokenize(p: BlockParams, ev, n):
    """[T, S] replay grids -> flat token arrays [cap_tok + 1] in global
    position order, plus n_tok.  One exclusive cumsum + one row scatter."""
    start, is_m, dist, length, byte = ev

    def flat(v):  # [T, S] -> [N] position order (pos = lane*T + t)
        return v.T.reshape(-1)

    startf = flat(start)
    is_mf = flat(is_m)
    distf = flat(dist)
    lenf = flat(length)
    bytef = flat(byte)
    sf = startf.astype(_i32)
    n_tok = jnp.sum(sf)
    # repeat detection in token (== position) order: previous match's
    # distance at a strictly earlier position
    e = jnp.where(is_mf, distf, 0)
    eprev = jnp.concatenate([jnp.zeros((1,), _i32), e[:-1]])
    prev = jnp.maximum(_last_nonzero_fill(eprev), 1)
    rep = is_mf & (distf == prev)
    e0 = bytef | (is_mf.astype(_i32) << 8) | (rep.astype(_i32) << 9) | (
        lenf << 10
    )
    # compact token starts to the front by a stable sort on the one-bit
    # key "not a start" instead of an [N, 2] scatter; stability preserves
    # position == token order
    key = 1 - sf
    _, e0_s, dist_s = jax.lax.sort(
        (key, e0, distf), num_keys=1, is_stable=True
    )
    toks = jnp.stack([e0_s, dist_s], axis=-1)
    return toks, n_tok


def _token_events(p: BlockParams, toks, n_tok):
    """Flat token arrays -> per-token (sym, xtr, tb) + the (c, f) pairs of
    all three slots, identity-masked beyond n_tok."""
    cap_tok = p.capacity
    e0, dist = toks[:, 0], toks[:, 1]
    active = jnp.arange(cap_tok, dtype=_i32) < n_tok
    byte = e0 & 0xFF
    is_m = active & ((e0 >> 8) & 1).astype(bool)
    rep = ((e0 >> 9) & 1).astype(bool)
    length = e0 >> 10
    v = jnp.clip(length - p.min_len, 0, 255)
    lb, len_bits, len_mant = _len_code(v)
    db = jnp.where(rep, DB_REPEAT, _dist_bucket(jnp.maximum(dist, 1)))
    dist_bits = jnp.where(is_m & ~rep, jnp.clip(db, 0, 23), 0)
    dist_mant = jnp.where(
        is_m & ~rep,
        dist - jnp.left_shift(jnp.ones_like(dist), jnp.clip(db, 0, 23)),
        0,
    )
    sym = jnp.where(is_m, 256 + db * L_BUCKETS + lb, byte)
    sym = jnp.where(active, sym, 0)
    len_bits = jnp.where(is_m, len_bits, 0)
    xtr = jnp.where(is_m, len_mant, 0) | (dist_mant << len_bits)
    tbits = jnp.where(is_m, len_bits + dist_bits, 0)
    return sym, xtr.astype(_u32), tbits, active


def normalize_freqs(h, width: int):
    """[W] raw counts -> [W] i32 static frequencies summing exactly to M,
    with f > 0 iff h > 0.  All-i32: counts pre-shift until the total fits
    15 bits (so h2 <= total < M and floor(h2*M/total) >= h2 >= 1 for every
    present symbol — no zero-rounding, hence the drift M - sum(s) is
    always >= 0 and < W, landed safely on the argmax symbol).  Valid for
    any W < M."""
    h = h.astype(_i32)

    def body(state):
        hh, sh = state
        return jnp.where(hh > 0, jnp.maximum(hh >> 1, 1), 0), sh + 1

    def cond(state):
        hh, _ = state
        return jnp.sum(hh) >= (1 << 15)

    h2, _ = jax.lax.while_loop(cond, body, (jnp.where(h > 0, h, 0), 0))
    n2 = jnp.maximum(jnp.sum(h2), 1)
    s = jnp.where(h2 > 0, jnp.maximum(1, (h2 * M) // n2), 0)
    drift = M - jnp.sum(s)
    imax = jnp.argmax(s)
    s = s.at[imax].add(drift)
    return s


def _uniform_cf(tbits, val):
    """Table-free uniform event of `tbits` bits (0 bits = inactive)."""
    b = jnp.clip(tbits, 0, M_BITS)
    f = jnp.left_shift(jnp.uint32(1), (M_BITS - b).astype(_u32))
    act = b > 0
    c, f = rans.select_cf(act, val.astype(_u32) * f, f)
    return c, f


def _rev_window_write(emit, word, buf, cur, win: int):
    """Deposit this slot's emitted words (lane-DESC order — the exact
    reverse of the decoder's lane-ASC window read) into buf at cur via a
    transposed one-hot dot.  Words are byte-split so a reduced-precision
    dot is exact: operands are 0/1 and < 256 (TF32 keeps 11 significant
    bits, bf16 8), accumulation is f32 and each output element has at most
    one nonzero term.  Precision.DEFAULT (TF32 on the GPU, f32 on the CPU)
    is named explicitly, so jax_default_matmul_precision cannot change
    it.

    ``win < S`` shrinks the [S, win] one-hot (the dominant per-step cost
    of the encode loop); a slot-step emitting more than win words would
    write garbage, so the caller tracks the max count and retries with
    win == S when the narrow window overflowed (rare: typical slot-steps
    emit ~S/10 words)."""
    s = emit.shape[0]
    er = emit[::-1]
    wr = word[::-1].astype(_u32)
    inc = er.astype(_u32)
    acc = inc
    k = 1
    while k < s:
        acc = acc + jnp.pad(acc, (k, 0))[:s]
        k *= 2
    idx = (acc - inc).astype(_i32)
    oh = (
        jax.lax.broadcasted_iota(_i32, (s, win), 1) == idx[:, None]
    ) & er[:, None]
    lohi = jnp.stack(
        [(wr & 0xFF).astype(jnp.float32), (wr >> 8).astype(jnp.float32)],
        axis=-1,
    )
    seg = jnp.dot(
        oh.T.astype(jnp.float32),
        lohi,
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    seg16 = (
        seg[:, 0].astype(_u32) | (seg[:, 1].astype(_u32) << 8)
    ).astype(jnp.uint16)
    buf = jax.lax.dynamic_update_slice(buf, seg16, (cur,))
    count = acc[-1].astype(_i32)
    return buf, cur + count, count


@functools.partial(jax.jit, static_argnums=(0, 3))
def _encode_fast(p: BlockParams, inp, n, win: int = 0):
    """Full F2 encode.  Returns (freq [W_SYM], states [S], buf — compact
    stream words in REVERSED order from index 0, n_words, n_tok,
    max_count).  ``win`` bounds the per-slot-step window write (0 = S);
    max_count > win means the narrow window overflowed and the caller
    must retry with win = S (encode_block_fast_start does)."""
    inp_flat = inp.reshape(-1)
    ts, take, src = _fast_find_matches(p, inp_flat, n)

    body = functools.partial(_replay_body, p, inp, n)
    _, ev = jax.lax.scan(body, (jnp.zeros((p.lanes,), _i32),), (ts, take, src))
    toks, n_tok = _tokenize(p, ev, n)
    sym, xtr, tbits, active = _token_events(p, toks, n_tok)

    freq_raw = (
        jnp.zeros((W_SYM + 1,), _i32)
        .at[jnp.where(active, sym, W_SYM)]
        .add(1, mode="drop")[:-1]
    )
    freq = normalize_freqs(freq_raw, W_SYM)
    cums = tb.exclusive_cumsum(freq[None, :])[0]
    cf = jnp.stack([cums, freq], axis=-1)  # [W, 2]
    cf_tok = cf[sym]  # [cap_tok, 2] row gather
    ca, fa = rans.select_cf(
        active, cf_tok[:, 0].astype(_u32), cf_tok[:, 1].astype(_u32)
    )
    b1 = jnp.minimum(tbits, M_BITS)
    b2 = tbits - b1
    v1 = (xtr & _u32((1 << M_BITS) - 1)).astype(_u32)
    v2 = (xtr >> M_BITS).astype(_u32)
    c1, f1 = _uniform_cf(b1, v1)
    c2, f2 = _uniform_cf(b2, v2)

    S = p.lanes
    cap_tok = p.capacity
    t_tok = (n_tok + S - 1) // S
    pad_buf = cap_tok + 3 * S + 16  # words: <= 1 word per event, <= 1
    # event/byte amortized (literal = 1 event; match = 3 events per >= 4
    # bytes), so n_words <= cap_tok

    w_eff = win if win else S

    def slot_slice(a, t):
        return jax.lax.dynamic_slice(a, (t * S,), (S,))

    def body(carry):
        t, x, cur, buf, mx = carry
        t = t - 1
        # slots reversed (rANS is LIFO): XTR2, XTR1, SYM
        for c_a, f_a in (
            (slot_slice(c2, t), slot_slice(f2, t)),
            (slot_slice(c1, t), slot_slice(f1, t)),
            (slot_slice(ca, t), slot_slice(fa, t)),
        ):
            x, em, wd = rans.enc_put(x, c_a, f_a)
            buf, cur, cnt = _rev_window_write(em, wd, buf, cur, w_eff)
            mx = jnp.maximum(mx, cnt)
        return t, x, cur, buf, mx

    def cond(carry):
        return carry[0] > 0

    carry0 = (
        t_tok.astype(_i32),
        rans.init_states(S),
        jnp.int32(0),
        jnp.zeros((pad_buf,), jnp.uint16),
        jnp.int32(0),
    )
    _, x, n_words, buf, mx = jax.lax.while_loop(cond, body, carry0)
    return freq, x, buf, n_words, n_tok, mx


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def _build_dec_table(freq):
    """[W] static freqs (sum == M) -> [M, 2] slot table:
    row = (sym | cum << 10, frq)."""
    cums = tb.exclusive_cumsum(freq[None, :])[0]
    slots = jnp.arange(M, dtype=_i32)
    sym = (
        jnp.sum((cums[None, :] <= slots[:, None]).astype(_i32), axis=1) - 1
    )
    c = cums[sym]
    f = freq[sym]
    return jnp.stack([sym | (c << 10), f], axis=-1)


@functools.partial(jax.jit, static_argnums=(0,))
def _fast_decode_scan(p: BlockParams, freq, states, stream, n_tok):
    """Token entropy scan: while_loop over ceil(n_tok / S) steps, one token
    per lane per step.  Returns (states, words_consumed, sym grid, xtr
    grid) — output materialization happens in _token_plane + the native
    executor."""
    dtab = _build_dec_table(freq)
    S = p.lanes
    cap_tok = p.capacity
    t_tok = (n_tok + S - 1) // S
    lanes = _lane_ids(S)

    def body(carry):
        t, x, base, sym_g, xtr_g = carry
        tok_act = (t * S + lanes) < n_tok
        slot = rans.dec_slot(x).astype(_i32)
        e = dtab[slot]  # [S, 2] row gather
        sym = e[:, 0] & 1023
        c = (e[:, 0] >> 10).astype(_u32)
        f = e[:, 1].astype(_u32)
        c, f = rans.select_cf(tok_act, c, f)

        def advance(x, base, cx, fx):
            x_tmp, need = rans.dec_advance(x, cx, fx)
            win = jax.lax.dynamic_slice(stream, (base,), (S,))
            w, used = rans.stream_window_read(win, need, jnp.uint32(0))
            return rans.dec_renorm(x_tmp, need, w), base + used.astype(_i32)

        x, base = advance(x, base, c, f)
        is_m = tok_act & (sym >= 256)
        mc = jnp.where(is_m, sym - 256, 0)
        db = mc // L_BUCKETS
        lb = mc % L_BUCKETS
        len_bits = jnp.where(lb >= L_DIRECT, lb - 5, 0)
        dist_bits = jnp.where(is_m & (db < DB_REPEAT), db, 0)
        tbits = jnp.where(is_m, len_bits + dist_bits, 0)
        b1 = jnp.minimum(tbits, M_BITS)
        b2 = tbits - b1
        f1 = jnp.left_shift(jnp.uint32(1), (M_BITS - b1).astype(_u32))
        v1 = jnp.where(b1 > 0, (rans.dec_slot(x) // f1).astype(_i32), 0)
        c1, f1x = rans.select_cf(b1 > 0, v1.astype(_u32) * f1, f1)
        x, base = advance(x, base, c1, f1x)
        f2 = jnp.left_shift(jnp.uint32(1), (M_BITS - b2).astype(_u32))
        v2 = jnp.where(b2 > 0, (rans.dec_slot(x) // f2).astype(_i32), 0)
        c2, f2x = rans.select_cf(b2 > 0, v2.astype(_u32) * f2, f2)
        x, base = advance(x, base, c2, f2x)
        xtr = v1.astype(_u32) | (v2.astype(_u32) << M_BITS)
        sym_g = jax.lax.dynamic_update_slice(
            sym_g, jnp.where(tok_act, sym, 0).astype(_i32), (t * S,)
        )
        xtr_g = jax.lax.dynamic_update_slice(
            xtr_g, jnp.where(tok_act, xtr, 0), (t * S,)
        )
        return t + 1, x, base, sym_g, xtr_g

    def cond(carry):
        return carry[0] < t_tok

    carry0 = (
        jnp.int32(0),
        states,
        jnp.int32(0),
        jnp.zeros((cap_tok,), _i32),
        jnp.zeros((cap_tok,), _u32),
    )
    _, x, base, sym_g, xtr_g = jax.lax.while_loop(cond, body, carry0)
    return x, base, _token_plane(p, sym_g, xtr_g, n_tok)


def _token_plane(p: BlockParams, sym, xtr, n_tok):
    """Decoded (sym, xtr) grids -> one u32 per token: literal byte
    (< 256), or (dist << 8) | (len - min_len) with dist >= 1 (>= 256,
    self-disambiguating).  Repeat-distance symbols resolve here with one
    log-doubling last-explicit-distance fill, so the sequential executor
    sees explicit distances only."""
    active = jnp.arange(p.capacity, dtype=_i32) < n_tok
    is_m = active & (sym >= 256)
    mc = jnp.where(is_m, sym - 256, 0)
    db = mc // L_BUCKETS
    lb = mc % L_BUCKETS
    len_bits = jnp.where(lb >= L_DIRECT, lb - 5, 0)
    len_mant = (xtr & ((jnp.uint32(1) << len_bits.astype(_u32)) - 1)).astype(
        _i32
    )
    v = jnp.clip(_len_decode(lb, len_mant), 0, 255)
    dmant = (xtr >> len_bits.astype(_u32)).astype(_i32)
    kd = jnp.clip(db, 0, 23)
    dist_e = jnp.where(
        is_m & (db < DB_REPEAT),
        jnp.left_shift(jnp.ones_like(kd), kd) + dmant,
        0,
    )
    # repeat fill: the last explicit distance at a token <= this one (a
    # repeat's ancestor is always explicit, so chains resolve in one fill)
    fill = jnp.maximum(_last_nonzero_fill(dist_e), 1)
    dist = jnp.where(is_m & (db == DB_REPEAT), fill, dist_e)
    plane = jnp.where(
        is_m,
        (jnp.clip(dist, 1, (1 << 24) - 1).astype(_u32) << 8)
        | v.astype(_u32),
        jnp.where(active, sym, 0).astype(_u32),
    )
    return plane


# --------------------------------------------------------------------------
# Host-facing API (payload packing, bucketed prefix fetch, validation)
# --------------------------------------------------------------------------

_TAB_BYTES = 2 * W_SYM


@functools.partial(jax.jit, static_argnums=(1,))
def _slice_prefix(arr, b: int):
    return arr[:b]


def _fetch_prefix(arr, k: int) -> np.ndarray:
    """Fetch arr[:k] with geometric bucketing so the slice op compiles
    once per bucket, not once per block.  Quarter-steps between powers
    of two cap the overshoot at 25% (power-of-two buckets wasted up to
    2x of the device->host transfer, which dominates F2 decode wall on
    a slow link — the 8 MiB token plane is the single largest fetch)."""
    if k <= 0:
        return np.zeros((0,), np.asarray(arr[:0]).dtype)
    cap = arr.shape[0]
    p2 = 1 << max(12, int(k - 1).bit_length())
    b = p2
    for num in (5, 6, 7):  # 1.25x / 1.5x / 1.75x of the next-lower pow2
        c = (p2 // 8) * num
        if c >= k:
            b = c
            break
    b = min(b, cap)
    return np.asarray(_slice_prefix(arr, b))[:k]


def _max_words(p: BlockParams) -> int:
    # <= 1 word per event; literal = 1 event, match = 3 events per >= 4
    # bytes -> n_words <= capacity.  + window slack for the decode-side
    # dynamic_slice at the stream tail.
    return p.capacity + 3 * p.lanes + 16


def encode_block_fast_start(data: np.ndarray, p: BlockParams):
    """Dispatch the F2 encode (async device handles); pair with
    encode_block_fast_finish — same pipelining contract as
    block.encode_block_start."""
    n = int(data.size)
    assert 0 < n <= p.capacity
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = data
    # content CRC: static tables cannot self-corrupt the way adaptive
    # models do (where the drain check fires on divergence) — a flipped
    # mantissa bit decodes to a valid stream with wrong bytes.  The CRC
    # is F's corruption detector.
    crc = zlib.crc32(data.tobytes()) & 0xFFFFFFFF
    # Window width for the stream writes.  A narrow window makes the
    # [S, win] one-hot writes ~4x cheaper but measured UNSAFE on real
    # content: doc text hit slot-steps with 351 of 512 lanes emitting
    # (S/4 = 128 overflowed, forcing the full-width retry and paying both
    # encodes — a net 1.6x slowdown).  Default = full width; the knob and
    # the overflow-retry stay for sparse-emission content classes.
    win = int(_os.environ.get("CPX_F_ENC_WIN", "0")) or p.lanes
    dev = jnp.asarray(buf)
    return crc, p, dev, int(n), win, _encode_fast(p, dev, jnp.int32(n), win)


def encode_block_fast_finish(started) -> bytes:
    crc, p, dev, n, win, handles = started
    freq, states, buf, n_words, n_tok, mx = handles
    if int(mx) > win:  # narrow-window overflow: redo at full width
        freq, states, buf, n_words, n_tok, mx = _encode_fast(
            p, dev, jnp.int32(n), 0
        )
    nw = int(n_words)
    # buf holds the words in reversed decode order from index 0
    stream = _fetch_prefix(buf, nw)[::-1]
    return (
        np.array([nw, int(n_tok), crc], np.uint32).tobytes()
        + np.asarray(freq).astype("<u2").tobytes()
        + np.asarray(states).astype("<u4").tobytes()
        + stream.astype("<u2").tobytes()
    )


def encode_block_fast(data: np.ndarray, p: BlockParams) -> bytes:
    return encode_block_fast_finish(encode_block_fast_start(data, p))


def decode_block_fast_start(payload: bytes, n: int, p: BlockParams):
    """Host-side unpack + async scan dispatch; pair with
    decode_block_fast_finish.  All payload-shape validation raises HERE,
    before dispatch."""
    if n <= 0 or n > p.capacity:
        raise ValueError(f"corrupt block: bad raw size {n}")
    need = 12 + _TAB_BYTES + 4 * p.lanes
    if len(payload) < need:
        raise ValueError("corrupt block: truncated fast-block payload")
    n_words, n_tok, crc_want = (
        int(v) for v in np.frombuffer(payload[:12], "<u4")
    )
    off = 12
    freq = np.frombuffer(payload[off : off + _TAB_BYTES], "<u2").astype(
        np.int32
    )
    off += _TAB_BYTES
    if int(freq.sum()) != M:
        raise ValueError("corrupt block: static table sum != M")
    if not 0 < n_tok <= p.capacity:
        raise ValueError("corrupt block: bad token count")
    states = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4")
    off += 4 * p.lanes
    words = np.frombuffer(payload[off : off + 2 * n_words], "<u2")
    if words.size != n_words or n_words > _max_words(p):
        raise ValueError("corrupt block: truncated stream")
    stream = np.zeros((_max_words(p),), np.uint16)
    stream[:n_words] = words
    handles = _fast_decode_scan(
        p,
        jnp.asarray(freq),
        jnp.asarray(states.copy()),
        jnp.asarray(stream),
        jnp.int32(n_tok),
    )
    return n, p.min_len, n_words, n_tok, crc_want, handles


def decode_block_fast_finish(started) -> np.ndarray:
    n, min_len, n_words, n_tok, crc_want, (x, base, plane) = started
    x = np.asarray(x)
    if int(base) != n_words or not (x == RANS_L).all():
        raise ValueError(
            f"corrupt block: states drained={bool((x == RANS_L).all())} "
            f"words {int(base)}/{n_words}"
        )
    tok = _fetch_prefix(plane, n_tok)
    res = native.f2_execute(np.ascontiguousarray(tok), min_len, n)
    if res is None:
        raise ValueError("corrupt block: token stream over/underruns")
    if (zlib.crc32(res.tobytes()) & 0xFFFFFFFF) != crc_want:
        raise ValueError("corrupt block: content CRC mismatch")
    return res


def decode_block_fast(payload: bytes, n: int, p: BlockParams) -> np.ndarray:
    return decode_block_fast_finish(decode_block_fast_start(payload, n, p))


# ---- grouped APIs (container -g / mesh path): F2's per-block passes are
# already whole-block parallel, so these loop with the one-block-in-flight
# pipeline instead of vmapping G blocks.


def encode_blocks_fast(blocks: list, p: BlockParams, group: int) -> list:
    out = []
    pending = None
    for blk in blocks:
        started = encode_block_fast_start(blk, p)
        if pending is not None:
            out.append(encode_block_fast_finish(pending))
        pending = started
    if pending is not None:
        out.append(encode_block_fast_finish(pending))
    return out


def decode_blocks_fast(
    payloads: list, ns: list, p: BlockParams, group: int
) -> np.ndarray:
    pieces = []
    pending = None
    for payload, n in zip(payloads, ns):
        started = decode_block_fast_start(payload, n, p)
        if pending is not None:
            pieces.append(decode_block_fast_finish(pending))
        pending = started
    if pending is not None:
        pieces.append(decode_block_fast_finish(pending))
    return (
        np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    )
