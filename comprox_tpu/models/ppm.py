"""Batched PPM compound model — o1 + o2 + o3-predictor, S lanes in lock-step.

Data-parallel re-architecture of the reference literal coder (richox/comprox
src/cr-ppm.c:103-235 and cr-o2model.c): the per-context freq tables become
device arrays indexed by every lane's own context, advanced once per step
for all S lanes with deterministic batched updates (see models/tables.py for the
collision rules).

Symbol space of the primary ("A") event, coded under the order-2 context
(prev 2 bytes), mirrors the reference's 258-symbol alphabet plus one
lock-step extension:

    0..255  literal byte            (cr-o2model.c slots 0-255)
    256     o3 predictor matched    (cr-ppm.c:118-125)
    257     escape to order-1       (cr-ppm.c:140-158)
    258     match-flag              (replaces the reference's rarest-byte
                                     escape trick, roxmain/cr-coder.c:180-189:
                                     a proper context-modeled symbol instead)
    259     padding (never coded)

The predicted byte's o2 frequency is excluded from the A distribution exactly
as in cr-ppm.c:118-138 (we zero its slot, which equals the reference's
cum/sum subtraction).  On escape, the literal is coded in the order-1 table
with weight 8*f-7 (cr-ppm.c:98) excluding the predicted byte and every byte
present in o2 (cr-ppm.c:140-158).  Match lengths are coded by a shared
adaptive order-0 table ("B" event of match lanes).

The o3 predictor keeps (pred byte, 4-bit confidence) per 22-bit hashed order-3
context (cr-ppm.c:36-41,66-88), packed conf<<8|pred into one int32 lane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from comprox_tpu.models import tables as tb

# --- symbol space -----------------------------------------------------------
O2_W = 260
SYM_HIT = 256
SYM_ESC = 257
SYM_MATCH = 258
SYM_HIT2 = 259  # secondary o3 prediction matched (2-way entry; lock-step
# extension: lock-step lanes interleave 256 streams through the shared o3
# table, and the reference's 1-deep replace-style entry loses ~13% of its
# sequential hit rate to cross-lane replacement (measured: 748k hits
# sequential vs 654k interleaved on identical 2MiB input).  A 2-way entry
# (primary + victim slot) recovers it: 655k+97k hits interleaved.)

# --- tuning constants (ours; reference analogues noted) ---------------------
# overridable via CPX_* env vars for ratio sweeps (read at import time)
import os as _os


def _env(name, default):
    return int(_os.environ.get("CPX_" + name, default))


INC2 = _env("INC2", 16)  # o2 increment   (ref: 1 on u8 tables, cr-ppm.c)
CAP2 = _env("CAP2", 24576)  # o2 read-time sum cap (ref: freq 250/symbol)
INC1 = _env("INC1", 1)  # o1 increment    (ref: 1, cr-ppm.c:92)
CAP1 = _env("CAP1", 3500)  # o1 raw-sum cap; weighted 8*f-7 stays < 2^15
LEN_INC = _env("LEN_INC", 16)
LEN_CAP = 24576
IDX_INC = _env("IDX_INC", 16)  # ROLZ index model (ref: 4, cr-coder.c:282)
IDX_CAP = 24576
DST_INC = _env("DST_INC", 16)  # LZ77 distance-bucket model (~roxmain's
DST_CAP = 24576  # chained pos_models, roxmain/cr-coder.c:242-258)
DST_W = 32  # buckets 0..23 = bit_length(dist)-1, 24 = repeat-prev
MANT_INC = _env("MANT_INC", 24)  # LZ77 distance-mantissa top-4-bits model
MANT_CAP = _env("MANT_CAP", 8192)  # (the adaptive analogue of roxmain's
# base-128/64 pos-model DIGITS, cr-coder.c:242-258: distances cluster, so
# the top mantissa bits are far from uniform)
N_SHARED_CTX = 4  # context buckets for the len/idx shared models
IDX_W = 80  # 64 main recency ranks + 16 short-table ranks (rolzmain
# cr-matcher.c: M_rolz_indices + M_rolz_indices_short)
O2_NCTX = 1 << 16
O1_NCTX = 256
O3_SIZE = 1 << 22
LEN_W = 256

_i32 = jnp.int32

_STICKY2 = jnp.zeros((O2_W,), bool).at[SYM_HIT].set(True).at[SYM_ESC].set(
    True
).at[SYM_MATCH].set(True).at[SYM_HIT2].set(True)


def init_tables(match_enabled: bool, o3_bits: int = 22) -> dict:
    """Fresh model state for one block (per-block reset, SURVEY.md §5)."""
    o2_row = jnp.zeros((O2_W,), _i32)
    o2_row = o2_row.at[SYM_HIT].set(INC2).at[SYM_ESC].set(INC2)
    if O3_2WAY == 1:
        o2_row = o2_row.at[SYM_HIT2].set(INC2)
    if match_enabled:
        o2_row = o2_row.at[SYM_MATCH].set(INC2)
    o3_size = 1 << o3_bits
    return {
        "o2": tb.make_table(O2_NCTX, O2_W, o2_row),
        "o1": tb.make_table(O1_NCTX, O1_NCTX, jnp.ones((O1_NCTX,), _i32)),
        # conf<<8 | pred per hashed o3 context, init pred=0 conf=0.  Shaped
        # [o3_size/128, 128] so reads/writes are ROW ops (row-delta
        # scatters vectorize where 1-D element scatters serialize)
        "o3": jnp.zeros((o3_size >> 7, 128), _i32),
        "len": jnp.ones((N_SHARED_CTX, LEN_W), _i32),
        "idx": jnp.ones((N_SHARED_CTX, IDX_W), _i32),
        "dst": jnp.ones((DST_W,), _i32),
        # distance-mantissa top-4-bits model, one row per dist bucket
        # k-5 in [0, 12); tiny and dense — reads AND updates are exact
        # one-hot matmuls, no random access (block.py _mant_read/update)
        "mant": jnp.ones((16, 16), _i32),
        # SSE/APM on the A event's match mass (mode 'R'; see init_sse)
        "sse": init_sse(),
        # hit-flag APM (rev 7, SSE_HIT; see init_sse_hit)
        "sse_h": init_sse_hit(),
        # mode-X hit-flag APM (rev 8, SSE_X; see init_sse_x)
        "sse_x": init_sse_x(),
        # mode-P hit-flag APM (rev 8, SSE_P; see init_sse_p)
        "sse_p": init_sse_p(),
    }


def o3_hash(ctx3, o3_size: int):
    """Order-3 context hash (shape of cr-ppm.c:66; 22-bit in production)."""
    return (ctx3 ^ (ctx3 >> 2)) & jnp.int32(o3_size - 1)


def o3_read(t, h3):
    """(pred, conf, pred2, conf2, raw) for each lane's hashed o3 context.

    Row gather + in-row one-hot select.  Confidences are clamped at read:
    same-step colliding updates sum their row deltas (deterministically,
    on both sides), which can leave a transiently out-of-range packed
    value; the next single-lane update self-heals it (delta = desired -
    current).

    Entry layout (24 bits): conf2<<20 | pred2<<12 | conf1<<8 | pred1.
    With O3_2WAY=0 the upper 12 bits stay zero (conf2=0 marks slot 2
    invalid) and the layout reduces to the round-1 conf<<8|pred.
    """
    rows = t["o3"][h3 >> 7]  # [S, 128]
    col = h3 & 127
    sel = (
        jax.lax.broadcasted_iota(_i32, rows.shape, 1) == col[:, None]
    )
    packed = jnp.sum(jnp.where(sel, rows, 0), axis=1)
    pred = packed & 0xFF
    conf = jnp.clip((packed >> 8) & 0xF, 0, 15)
    pred2 = (packed >> 12) & 0xFF
    conf2 = jnp.clip((packed >> 20) & 0xF, 0, 15)
    return pred, conf, pred2, conf2, packed


CONF_BOOST = _env("CONF_BOOST", 0)

# Bumped when table-arithmetic CODE changes alter the stream format (e.g.
# the round-2 o3 collision rule: summed row deltas replaced winner-dedup
# writes; rev 3 = 2-way o3 entries + SYM_HIT2; rev 4 = adaptive distance-
# mantissa top bits in mode 'X'; rev 5 = lzp_hash8 distinct per-half
# multipliers, mode 'P'; rev 6 = SSE/APM reshape of the A event's match
# mass, mode 'R'; rev 7 = hit-flag APM + fill x conf match-APM contexts,
# mode 'R'; rev 8 = hit-flag APMs for modes 'X' (conf x p1 class) and
# 'P' (conf x LZP availability x p1 class)).
# Rides format_fingerprint so old archives fail cleanly.
FORMAT_REV = 8


def format_fingerprint() -> int:
    """CRC32 of every format-relevant model constant (the CPX_* knobs plus
    the fixed caps/widths).  These constants change table arithmetic and
    therefore the stream format; the container header carries this value so
    an archive encoded under non-default knobs fails with a clear error in
    a default-env process instead of a drain-check 'corrupt block'."""
    import zlib

    knobs = (
        INC2, CAP2, INC1, CAP1, LEN_INC, LEN_CAP, IDX_INC, IDX_CAP,
        DST_INC, DST_CAP, DST_W, MANT_INC, MANT_CAP, N_SHARED_CTX,
        IDX_W, LEN_W, O2_W, CONF_BOOST, FORMAT_REV,
        O2_MAXCAP, O2_EE, O3_GROUPS, O3_GROUPUPD, O3_2WAY,
        SSE, SSE_NCTX, SSE_RATE_SH, SSE_MCTX, SSE_HIT, SSE_HCTX,
        SSE_X, SSE_XCTX, SSE_P, SSE_PCTX,
    )
    return zlib.crc32(repr(knobs).encode()) & 0xFFFFFFFF


# o2 rescale policy (format-relevant, fingerprinted):
#   O2_MAXCAP > 0 adds the reference's per-symbol trigger — halve as soon
#   as any byte freq crosses O2_MAXCAP*INC2 (cr-o2model.c:53), keeping
#   skewed contexts adaptive instead of letting one byte pin the row until
#   the sum cap.  O2_EE = 1 recomputes the escape slot at rescale as the
#   PPMX estimate INC2*(1 + #bytes-at-minimum-freq) (cr-o2model.c:61-67)
#   instead of ceil-halving it.
O2_MAXCAP = _env("O2_MAXCAP", 0)
O2_EE = _env("O2_EE", 0)
# o3 table partitioning by lane group (format-relevant): see
# codec/block.py::_common_reads for the rationale and measurements.
# Measured NEGATIVE at every G (shared training beats locality) — keep 1.
O3_GROUPS = _env("O3_GROUPS", 1)
# group-aggregated o3 collision updates (format-relevant; see
# apply_updates): 0 = winner-only (round-1 behavior).  Measured NEUTRAL
# (colliding lanes usually propose the same byte) — keep 0.
O3_GROUPUPD = _env("O3_GROUPUPD", 0)
# 2-way associative o3 entries (format-relevant; see SYM_HIT2):
#   0 = single-slot entries (round-1 / reference behavior)
#   1 = victim slot coded as its own A symbol SYM_HIT2 — measured ratio-
#       NEGATIVE on doc text (+0.047 bpb PPM-only: the recovered
#       predictions code worse than the well-modeled literals they
#       replace, hit2 is only ~5% of steps)
#   2 = victim slot boosts its byte's literal freq at read time (no new
#       symbol; both sides compute the same reshaped distribution) and
#       gives an unseen predicted byte a floor so it needn't escape —
#       ALSO measured ratio-negative at every boost shape (multiplicative
#       K8: +0.039 bpb, additive B4/B8/B16: +0.030/+0.061/+0.117): the
#       dilution the bonus mass adds to every other symbol (hits are 57%
#       of events) always outweighs the victim-literal savings.  The o2
#       model prices those bytes near-optimally already.
# Default 0: the interleaved-lane o3 hit-rate gap vs the sequential
# reference (667k vs 748k hits on identical input) is real but NOT
# recoverable by 2-way entries — every scheme converts it into coded
# events that cost more than the literals they replace.  See PERF.md.
O3_2WAY = _env("O3_2WAY", 0)
O3_BOOST_K = _env("O3_BOOST_K", 8)  # multiplier on pred2's literal slot
O3_BOOST_B = _env("O3_BOOST_B", 1)  # floor (xINC2) when the slot is empty


def _o2_rescale(rows0):
    """Read-time o2 rescale (see tables.rescale_read for the general rule;
    this specialization adds the reference's per-symbol trigger and PPMX
    escape recomputation when enabled)."""
    did = jnp.zeros(rows0.shape[:-1], bool)
    rows = rows0
    for _ in range(tb.HALVE_ROUNDS):
        need = jnp.sum(rows, axis=-1) > CAP2
        if O2_MAXCAP:
            need = need | (
                jnp.max(rows[..., :256], axis=-1) > O2_MAXCAP * INC2
            )
        did = did | need
        halved = tb.halve_rows(rows, _STICKY2)
        if O2_EE:
            lit = halved[..., :256]
            cnt = jnp.sum(
                ((lit > 0) & (lit <= INC2)).astype(_i32), axis=-1
            )
            halved = halved.at[..., SYM_ESC].set(INC2 * (1 + cnt))
        rows = jnp.where(need[..., None], halved, rows)
    return rows, did


def read_o2(
    t, ctx2, pred, coding, conf=None, pred2=None, valid2=None,
    sse_fill=None, sse_hitx=None,
):
    """Gather + rescale + exclude-predicted for the A event.

    Returns (tables, rows, rowmod, cums, tot, halve_delta, sse_state).
    ``sse_state`` is None unless ``sse_fill`` is given (mode 'R' with the
    SSE stage on — feeds sse_update) or ``sse_hitx`` = (table key,
    n_ctx, context indices) is given (rev 8, modes 'X'/'P': hit-flag-
    only APM — feeds sse_update_hit).  Mutually exclusive by caller.

    ``rowmod`` has
    the predicted byte's slot zeroed; escape slot is clamped >= 1
    read-locally (it can be driven negative by escape elimination).
    ``halve_delta`` carries the rescale as per-winner row deltas so the
    caller folds it into ONE fused scatter-add with the increments (one
    scatter per table per step).

    With CONF_BOOST, a confident o3 predictor ceil-shifts every non-hit
    slot down (read-time only, both sides identical), raising the coded
    hit probability without touching table state; zero slots stay zero
    and nonzero slots stay >= 1, so decodability is unchanged.
    """
    rows0 = t["o2"][ctx2]
    rows, did = _o2_rescale(rows0)
    winners = tb.elect_winners(ctx2, did & coding)
    halve_delta = jnp.where(winners[:, None], rows - rows0, 0)
    esc = jnp.maximum(rows[:, SYM_ESC], 1)
    rows = rows.at[:, SYM_ESC].set(esc)
    slot_ids = jax.lax.broadcasted_iota(_i32, rows.shape, 1)
    rowmod = jnp.where(slot_ids == pred[:, None], 0, rows)
    if pred2 is not None and O3_2WAY == 1:
        # the secondary prediction's literal slot is dead weight too: a
        # byte equal to pred2 codes as SYM_HIT2, never as a literal
        rowmod = jnp.where(
            (slot_ids == pred2[:, None]) & valid2[:, None], 0, rowmod
        )
    elif pred2 is not None and O3_2WAY == 2:
        # mix the victim prediction into the literal distribution: scale
        # its slot by K and floor it at B*INC2, clamped so the row total
        # stays <= M (read-time only; both sides reshape identically)
        sel2 = (slot_ids == pred2[:, None]) & valid2[:, None]
        f2 = jnp.sum(jnp.where(sel2, rowmod, 0), axis=1)
        tot0 = tb.row_total(rowmod)
        bonus = jnp.clip(
            f2 * (O3_BOOST_K - 1) + INC2 * O3_BOOST_B,
            0,
            (1 << 15) - tot0,
        )
        rowmod = rowmod + jnp.where(sel2, bonus[:, None], 0)
    if CONF_BOOST and conf is not None:
        shift = (
            (conf >= 4).astype(_i32)
            + (conf >= 8).astype(_i32)
            + (conf >= 13).astype(_i32)
        )[:, None]
        boosted = (rowmod + (1 << shift) - 1) >> shift
        rowmod = jnp.where(slot_ids == SYM_HIT, rowmod, boosted)
    sse_state = None
    if sse_fill is not None and SSE:
        rowmod, sse_state = _sse_reshape(t, rowmod, sse_fill, conf)
    elif sse_hitx is not None:
        key, n_ctx, hctx = sse_hitx
        rowmod, sse_state = sse_reshape_hit(
            t, key, n_ctx, hctx, rowmod, conf
        )
    cums = tb.exclusive_cumsum(rowmod)
    return t, rows, rowmod, cums, tb.row_total(rowmod), halve_delta, sse_state


def read_o1_excl(t, p1, o2_rows, pred, esc_mask, pred2=None, valid2=None):
    """Order-1 weighted distribution with o2/pred exclusion (B event of
    escape lanes).  Returns (tables', rows, wmod, cums, tot).

    The o1 table is small enough (256x256) to maintain densely: rescaling
    applies table-wide when a row crosses the cap (no scatter), and the
    per-lane rows come from a one-hot matmul (no gather).
    """
    o1 = t["o1"]
    sums = jnp.sum(o1, axis=1)
    need = sums > CAP1
    o1 = jnp.where(need[:, None], (o1 + 1) >> 1, o1)
    t = dict(t)
    t["o1"] = o1
    # row read as a one-hot matmul instead of a per-lane gather: exact at
    # Precision.HIGHEST (true fp32 on every backend; 0/1 times int < 2^24,
    # one nonzero term per output element)
    oh = (
        jax.lax.broadcasted_iota(_i32, (p1.shape[0], O1_NCTX), 1)
        == p1[:, None]
    )
    rows = jnp.dot(
        oh.astype(jnp.float32),
        o1.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(_i32)
    w = rows * 8 - 7  # cr-ppm.c:98 M_freq_o1
    slot_ids = jax.lax.broadcasted_iota(_i32, rows.shape, 1)
    excluded = (o2_rows[:, :256] > 0) | (slot_ids == pred[:, None])
    if pred2 is not None:
        excluded = excluded | (
            (slot_ids == pred2[:, None]) & valid2[:, None]
        )
    wmod = jnp.where(excluded, 0, w)
    cums = tb.exclusive_cumsum(wmod)
    return t, rows, wmod, cums, tb.row_total(wmod)


def read_len(t, match_mask, ctx):
    """Shared match-length distribution (C event of match lanes),
    conditioned on a small both-sides-computable context (recency bucket
    of the chosen ROLZ index / distance bucket for 'X')."""
    return _read_shared_ctx(t, match_mask, "len", LEN_CAP, ctx)


def read_idx(t, match_mask, ctx):
    """Shared ROLZ bucket-index distribution (B event of match lanes; the
    analogue of rolzmain's idx_model, cr-coder.c:214-226), conditioned on
    the bucket's fill quartile."""
    return _read_shared_ctx(t, match_mask, "idx", IDX_CAP, ctx)


def read_dst(t, match_mask):
    """Shared LZ77 distance-bucket distribution (B event of match lanes in
    mode 'X'; the analogue of roxmain's chained pos_models)."""
    return _read_shared_ctx(
        t, match_mask, "dst", DST_CAP, jnp.zeros_like(match_mask, _i32),
        n_ctx=1,
    )


def _read_shared_ctx(t, mask, key, cap, ctx, n_ctx=N_SHARED_CTX):
    """Dense shared model with a tiny context: [n_ctx, W] rows kept fully
    dense (per-lane selection is a where-chain, never a gather — exact and
    scatter-free).  A context row rescales when any participating lane
    reads it over cap."""
    tab = t[key]
    if tab.ndim == 1:
        tab = tab[None, :]
    s_lanes = mask.shape[0]
    ctx = jnp.clip(ctx, 0, n_ctx - 1)
    for _ in range(tb.HALVE_ROUNDS):
        hot = jnp.zeros((n_ctx,), bool)
        for r in range(n_ctx):
            hot = hot.at[r].set(jnp.any(mask & (ctx == r)))
        need = hot & (jnp.sum(tab, axis=1) > cap)
        tab = jnp.where(need[:, None], (tab + 1) >> 1, tab)
    t = dict(t)
    t[key] = tab if n_ctx > 1 else tab[0]
    cums_tab = tb.exclusive_cumsum(tab)
    rows = jnp.broadcast_to(tab[0], (s_lanes, tab.shape[1]))
    cums = jnp.broadcast_to(cums_tab[0], rows.shape)
    tots = jnp.broadcast_to(jnp.sum(tab[0]), (s_lanes,))
    for r in range(1, n_ctx):
        sel = (ctx == r)[:, None]
        rows = jnp.where(sel, tab[r], rows)
        cums = jnp.where(sel, cums_tab[r], cums)
        tots = jnp.where(sel[:, 0], jnp.sum(tab[r]), tots)
    return t, rows, cums, tots


# --------------------------------------------------------------------------
# SSE / APM secondary estimation on the A event's match mass (round 4).
#
# The adaptive o2 row reserves SYM_MATCH mass in every context, including
# steps whose ROLZ bucket is EMPTY (a match is impossible) and contexts
# where matches never fire — the sse_probe.py capture measured that waste
# at ~30% of the match-flag bits (~2.6% of ALL model bits) on doc text.
# The fix is the classic SSE/APM rung above PPM (lpaq's APM_t), built
# for lock-step lanes: a dense [SSE_NCTX, 33] probability table on a stretch-
# quantized scale, 2-point interpolated read, rate-1/32 update — all
# in-row selects and masked reductions, zero random access, identical
# integer arithmetic on both sides.  Read-time only (like CONF_BOOST):
# the SYM_MATCH slot of rowmod is rescaled so that
# p(match | non-hit mass) equals the APM estimate; nonzero slots stay
# >= 1 so decodability is unchanged.  The APM context is the bucket
# fill class (0 = empty, 1..4 = fill quartiles) — decoder-replayable
# (the decoder replays bucket evolution; fill already keys the idx
# model).  No reference analogue: richox/comprox has no SSE stage.
# --------------------------------------------------------------------------
SSE = _env("SSE", 1)  # 0 disables (format-relevant, fingerprinted)
# round-5 extensions (rev 7), both fingerprinted:
#   SSE_MCTX=1 keys the match-flag APM on fill-class x o3-confidence
#   (20 rows) instead of fill-class alone (5) — the r4 probe's
#   "fillq_x_conf" context;
#   SSE_HIT=1 adds a second APM on the HIT flag (byte == o3 pred), keyed
#   on conf-class x match-availability (6 rows) — both decoder-known
#   before the A symbol (conf from the o3 read, avail from the bucket
#   replay).  Events with conf == 0 keep the primary estimate (no
#   reshape, no update): an untrained predictor's hit rate is not a
#   stable statistic.
SSE_MCTX = _env("SSE_MCTX", 1)
SSE_HIT = _env("SSE_HIT", 1)
SSE_NCTX = 20 if SSE_MCTX else 5
SSE_HCTX = 6
# rev 8: hit-flag APM for mode X, keyed conf-class x p1-class (48 rows).
# X's decoder cannot replay a bucket fill (distances explicit, bucket
# table encoder-private) — but conf and the order-1 context byte are
# decoder-known before the A symbol.  The exact-cost probe
# (benchmarks/sse_x_probe.py) ranked conf x p1//16 best (-1.12% of A
# bits); the probe also CLOSED the match-flag APM for X: every context
# measured POSITIVE (matches are 4% of X events — adaptation noise
# exceeds the reclaimable reserved mass), so X gets the hit stage only.
SSE_X = _env("SSE_X", 1)
SSE_XCTX = 48
# rev 8 also gives mode P a hit-flag APM: conf x LZP-candidate
# availability x p1 class (24 rows).  The LZP candidate is decoder-known
# before the A symbol (both sides run the same _lzp_candidate gather on
# strictly-earlier bytes).  Probe: -0.90% of total model bits; the
# match-flag APM measured POSITIVE for P in every context (closed,
# like X — unlike R, whose bucket-fill context carries real signal).
SSE_P = _env("SSE_P", 1)
SSE_PCTX = 24
SSE_RATE_SH = 5  # update rate 2^-5 per event
# probability clamp (16-bit fixed point).  LO must reach the stretch
# scale's bottom bin: the match-flag win comes from driving p(match)
# toward 0 in empty-bucket contexts, and an LO of 256 (p >= 1/256)
# forfeited ~3/4 of the probe's predicted savings (measured: -0.44% bpb
# at LO=256 vs the probe's ~-2%; see PERF).
SSE_LO, SSE_HI = 16, 65520
# squash((j-16)/2) for j in 0..32, 16-bit fixed point (hardcoded so both
# sides share exact integers)
_SSE_THR = (
    22, 36, 60, 98, 162, 267, 439, 720, 1179, 1921, 3108, 4971, 7812,
    11955, 17625, 24743, 32768, 40793, 47911, 53581, 57724, 60565,
    62428, 63615, 64357, 64816, 65097, 65269, 65374, 65438, 65476,
    65500, 65514,
)
_SSE_THR_J = jnp.asarray(_SSE_THR, _i32)
_SSE_SPAN_J = jnp.asarray(
    tuple(b - a for a, b in zip(_SSE_THR, _SSE_THR[1:])), _i32
)


def init_sse():
    """Identity-initialized APM table, flat [SSE_NCTX * 33]."""
    return jnp.tile(
        jnp.clip(_SSE_THR_J, SSE_LO, SSE_HI), (SSE_NCTX,)
    ).astype(_i32)


def init_sse_hit():
    """Identity-initialized hit-flag APM table, flat [SSE_HCTX * 33]."""
    return jnp.tile(
        jnp.clip(_SSE_THR_J, SSE_LO, SSE_HI), (SSE_HCTX,)
    ).astype(_i32)


def init_sse_x():
    """Identity-initialized mode-X hit-flag APM table, [SSE_XCTX * 33]."""
    return jnp.tile(
        jnp.clip(_SSE_THR_J, SSE_LO, SSE_HI), (SSE_XCTX,)
    ).astype(_i32)


def init_sse_p():
    """Identity-initialized mode-P hit-flag APM table, [SSE_PCTX * 33]."""
    return jnp.tile(
        jnp.clip(_SSE_THR_J, SSE_LO, SSE_HI), (SSE_PCTX,)
    ).astype(_i32)


def sse_ctx_of(fill, conf=None):
    """Match-flag APM context: ROLZ bucket fill class (0 = empty,
    1..4 = fill quartiles), optionally crossed with the o3 confidence
    class (SSE_MCTX).  Both inputs are decoder-known before the A event
    (the decoder replays bucket state; conf comes from the o3 read)."""
    fillc = jnp.where(
        fill > 0, 1 + jnp.clip((fill - 1) // 16, 0, 3), 0
    ).astype(_i32)
    if SSE_MCTX and conf is not None:
        return fillc * 4 + jnp.clip(conf, 0, 3)
    return fillc


def sse_hit_ctx_of(conf, fill):
    """Hit-flag APM context: conf class (1..3 clipped, -1) x bucket
    availability.  Only meaningful where conf > 0."""
    return (jnp.clip(conf, 1, 3) - 1) * 2 + (fill > 0).astype(_i32)


def sse_x_ctx_of(conf, p1):
    """Mode-X hit-flag APM context: conf class x order-1 byte class
    (p1 // 16) — both decoder-known before the A symbol (X has no
    replayable bucket fill).  Probe-ranked best (sse_x_probe.py:
    conf x p1//16 -1.12% of A bits vs conf x p1//64 -1.05%)."""
    return (jnp.clip(conf, 1, 3) - 1) * 16 + jnp.clip(p1, 0, 255) // 16


def sse_p_ctx_of(conf, avail, p1):
    """Mode-P hit-flag APM context: conf class x LZP candidate
    availability x p1 class — all decoder-known before the A symbol
    (the decoder runs the same _lzp_candidate gather on strictly-earlier
    bytes).  Probe-ranked best (sse_x_probe.py MODE=P: -1.07% of A)."""
    return (
        (jnp.clip(conf, 1, 3) - 1) * 2 + avail.astype(_i32)
    ) * 4 + jnp.clip(p1, 0, 255) // 64


def _apm_read(sse_flat, n_ctx, ctx, p16):
    """Shared APM machinery: stretch-quantize p16 to (bin i, weight w),
    read the 2 interpolation points from the flat [n_ctx * 33] table with
    masked reductions (no per-lane gathers), and
    return (p_sse16, flat_index, w, t_i, t_ip1) for the paired update."""
    k = n_ctx * 33
    s_lanes = p16.shape[0]
    i = jnp.sum(
        (p16[:, None] >= _SSE_THR_J[None, 1:32]).astype(_i32), axis=1
    )
    iota33 = jax.lax.broadcasted_iota(_i32, (s_lanes, 32), 1)
    sel_i = iota33 == i[:, None]
    thr_i = jnp.sum(jnp.where(sel_i, _SSE_THR_J[None, :32], 0), axis=1)
    span_i = jnp.maximum(
        jnp.sum(jnp.where(sel_i, _SSE_SPAN_J[None, :], 0), axis=1), 1
    )
    w = jnp.clip((p16 - thr_i) * 64 // span_i, 0, 64)
    flat = ctx * 33 + i
    iota = jax.lax.broadcasted_iota(_i32, (s_lanes, k), 1)
    t_i = jnp.sum(
        jnp.where(iota == flat[:, None], sse_flat[None, :], 0), axis=1
    )
    t_ip1 = jnp.sum(
        jnp.where(iota == (flat + 1)[:, None], sse_flat[None, :], 0), axis=1
    )
    p_sse = ((64 - w) * t_i + w * t_ip1) >> 6
    return p_sse, flat, w, t_i, t_ip1


def _apm_delta(n_ctx, flat, w, t_i, t_ip1, outcome, active):
    """Summed-at-step-start APM table delta toward ``outcome`` (bool),
    masked by ``active`` — deterministic on both sides like every other
    table update here."""
    k = n_ctx * 33
    h = outcome.astype(_i32) << 16
    d_i = ((64 - w) * (h - t_i)) >> (6 + SSE_RATE_SH)
    d_ip1 = (w * (h - t_ip1)) >> (6 + SSE_RATE_SH)
    iota = jax.lax.broadcasted_iota(_i32, (flat.shape[0], k), 1)
    am = active[:, None]
    return jnp.sum(
        jnp.where((iota == flat[:, None]) & am, d_i[:, None], 0), axis=0
    ) + jnp.sum(
        jnp.where((iota == (flat + 1)[:, None]) & am, d_ip1[:, None], 0),
        axis=0,
    )


def _hit_reshape(sse_flat, n_ctx, hctx, rowmod, conf):
    """Shared hit-slot APM reshape (modes R and X): rescale rowmod's
    SYM_HIT slot to the APM's secondary estimate where conf > 0.
    Returns (rowmod', hit_state).  Intermediates fit int32 (12-bit
    probabilities for the mass solve, 16-bit in the table)."""
    slot_ids = jax.lax.broadcasted_iota(_i32, rowmod.shape, 1)
    f_h0 = jnp.sum(jnp.where(slot_ids == SYM_HIT, rowmod, 0), axis=1)
    tot_h = jnp.maximum(tb.row_total(rowmod), 1)
    p16h = jnp.clip(f_h0 * 4096 // tot_h, 1, 4095) << 4
    ph, flat_h, w_h, ti_h, tip1_h = _apm_read(sse_flat, n_ctx, hctx, p16h)
    ph12 = jnp.clip(ph >> 4, 1, 4095)
    f_h_new = ph12 * (tot_h - f_h0) // (4096 - ph12)
    f_h_new = jnp.clip(
        f_h_new, 1, f_h0 + jnp.maximum((1 << 15) - tot_h, 0)
    )
    act_h = conf > 0
    f_h_new = jnp.where(act_h, f_h_new, f_h0)
    rowmod = jnp.where(slot_ids == SYM_HIT, f_h_new[:, None], rowmod)
    return rowmod, (flat_h, w_h, ti_h, tip1_h, act_h)


def _sse_reshape(t, rowmod, fill, conf=None):
    """Rescale rowmod's HIT slot (SSE_HIT) and SYM_MATCH slot to the
    APMs' secondary estimates.

    Returns (rowmod', state); ``state`` feeds sse_update after the A
    symbol is known.  The hit reshape runs FIRST, so the match solve's
    rest mass sees the reshaped hit frequency (both sides identical).
    All intermediates fit int32: probabilities are 12-bit for the mass
    solve (p * rest <= 4095 * 2^15 < 2^27) and 16-bit in the table.
    """
    slot_ids = jax.lax.broadcasted_iota(_i32, rowmod.shape, 1)

    hit_state = None
    if SSE_HIT and conf is not None:
        rowmod, hit_state = _hit_reshape(
            t["sse_h"], SSE_HCTX, sse_hit_ctx_of(conf, fill), rowmod, conf
        )

    f_m = jnp.sum(jnp.where(slot_ids == SYM_MATCH, rowmod, 0), axis=1)
    f_h = jnp.sum(jnp.where(slot_ids == SYM_HIT, rowmod, 0), axis=1)
    f_h2 = jnp.sum(jnp.where(slot_ids == SYM_HIT2, rowmod, 0), axis=1)
    tot0 = tb.row_total(rowmod)
    rest = jnp.maximum(tot0 - f_h - f_h2, 1)
    p16 = jnp.clip(f_m * 4096 // rest, 1, 4095) << 4
    p_sse, flat, w, t_i, t_ip1 = _apm_read(
        t["sse"], SSE_NCTX, sse_ctx_of(fill, conf), p16
    )
    ps12 = jnp.clip(p_sse >> 4, 1, 4095)
    f_new = ps12 * (rest - f_m) // (4096 - ps12)
    f_new = jnp.clip(f_new, 1, f_m + jnp.maximum((1 << 15) - tot0, 0))
    rowmod = jnp.where(slot_ids == SYM_MATCH, f_new[:, None], rowmod)
    return rowmod, (flat, w, t_i, t_ip1, hit_state)


def sse_reshape_hit(t, key, n_ctx, hctx, rowmod, conf):
    """Hit-only SSE stage (rev 8, modes X and P): rescale the SYM_HIT
    slot to the APM table ``t[key]``'s estimate under context ``hctx``.
    The exact-cost probe (benchmarks/sse_x_probe.py) CLOSED the
    match-flag APM for both modes — every context measured positive
    (unlike R, whose replayable bucket-fill context carries signal)."""
    return _hit_reshape(t[key], n_ctx, hctx, rowmod, conf)


def sse_update_hit(t, key, n_ctx, state, coding, is_hit):
    """APM update toward the observed hit flag (modes X and P)."""
    flat_h, w_h, ti_h, tip1_h, act_h = state
    t = dict(t)
    delta = _apm_delta(
        n_ctx, flat_h, w_h, ti_h, tip1_h, is_hit, coding & act_h
    )
    t[key] = jnp.clip(t[key] + delta, SSE_LO, SSE_HI)
    return t


def sse_update(t, state, coding, is_match, is_hit=None):
    """APM updates toward the observed flags (batched: colliding lanes
    sum their deltas at the step-start value, deterministically on both
    sides, like every other table here)."""
    flat, w, t_i, t_ip1, hit_state = state
    t = dict(t)
    delta = _apm_delta(SSE_NCTX, flat, w, t_i, t_ip1, is_match, coding)
    t["sse"] = jnp.clip(t["sse"] + delta, SSE_LO, SSE_HI)
    if hit_state is not None and is_hit is not None:
        flat_h, w_h, ti_h, tip1_h, act_h = hit_state
        delta_h = _apm_delta(
            SSE_HCTX, flat_h, w_h, ti_h, tip1_h, is_hit, coding & act_h
        )
        t["sse_h"] = jnp.clip(t["sse_h"] + delta_h, SSE_LO, SSE_HI)
    return t


def apply_updates(
    t,
    coding,
    ctx2,
    sym_a,
    byte,
    old_f_byte,
    p1,
    h3,
    pred,
    conf,
    sym_len,
    sym_idx=None,
    sym_dst=None,
    o2_halve_delta=None,
    len_ctx=None,
    idx_ctx=None,
    o3_raw=None,
    pred2=None,
    conf2=None,
):
    """All model updates for one step, after the events are coded.

    Each table gets at most ONE scatter: o2 folds the rescale delta and
    all increments into a single row-delta scatter-add; o1 and the shared
    len/idx/dst rows update with dense one-hot arithmetic (no scatter at
    all); o3 keeps its single deduplicated write.
    """
    is_lit = coding & (sym_a < 256)
    is_hit = coding & (sym_a == SYM_HIT)
    is_hit2 = coding & (sym_a == SYM_HIT2)
    is_esc = coding & (sym_a == SYM_ESC)
    is_match = coding & (sym_a == SYM_MATCH)
    t = dict(t)
    s_lanes = ctx2.shape[0]
    if len_ctx is None:
        len_ctx = jnp.zeros_like(sym_len)
    if idx_ctx is None:
        idx_ctx = jnp.zeros_like(sym_len)

    # --- o2: one fused row-delta scatter-add --------------------------------
    # (a) rescale delta from read_o2 (winner lanes only); (b) the coded A
    #     symbol; (c) the escaped literal also learns into o2
    #     (cr-ppm.c:151-153); (d) escape elimination: a literal's second
    #     occurrence decrements the escape slot (cr-ppm.c:128-139).
    eliminate = is_lit & (old_f_byte == INC2)
    slot_ids = jax.lax.broadcasted_iota(_i32, (s_lanes, O2_W), 1)
    delta = jnp.where(
        (slot_ids == sym_a[:, None]) & coding[:, None], INC2, 0
    )
    delta = delta + jnp.where(
        (slot_ids == byte[:, None]) & is_esc[:, None], INC2, 0
    )
    delta = delta + jnp.where(
        (slot_ids == SYM_ESC) & eliminate[:, None], -INC2, 0
    )
    if o2_halve_delta is not None:
        delta = delta + o2_halve_delta
    t["o2"] = t["o2"].at[ctx2].add(delta, mode="drop")

    # --- o1: dense one-hot outer product as a matmul -----------------------
    oh_ctx = (
        jax.lax.broadcasted_iota(_i32, (s_lanes, O1_NCTX), 1)
        == p1[:, None]
    ) & is_esc[:, None]
    oh_sym = (
        jax.lax.broadcasted_iota(_i32, (s_lanes, O1_NCTX), 1)
        == byte[:, None]
    )
    # exact at reduced precision: inputs are 0/1 (exact in TF32 and bf16),
    # accumulation is f32 and counts <= S < 2^24.  Precision.DEFAULT (TF32
    # on the GPU, f32 on the CPU) is named so that
    # jax_default_matmul_precision cannot change it
    d1 = jnp.dot(
        oh_ctx.astype(jnp.float32).T,
        oh_sym.astype(jnp.float32),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    ).astype(_i32)
    t["o1"] = t["o1"] + d1 * INC1

    # --- len / idx / dst: dense one-hot reductions --------------------------
    def bump(tab, sym, mask, inc, ctx=None):
        w = tab.shape[-1]
        oh = (
            jax.lax.broadcasted_iota(_i32, (s_lanes, w), 1)
            == sym[:, None]
        ) & mask[:, None]
        if tab.ndim == 1:
            return tab + jnp.sum(oh.astype(_i32), axis=0) * inc
        ctx = jnp.clip(ctx, 0, tab.shape[0] - 1)
        for r in range(tab.shape[0]):
            tab = tab.at[r].add(
                jnp.sum((oh & (ctx == r)[:, None]).astype(_i32), axis=0)
                * inc
            )
        return tab

    t["len"] = bump(t["len"], sym_len, is_match, LEN_INC, len_ctx)
    if sym_idx is not None:
        t["idx"] = bump(t["idx"], sym_idx, is_match, IDX_INC, idx_ctx)
    if sym_dst is not None:
        t["dst"] = bump(t["dst"], sym_dst, is_match, DST_INC)

    # --- o3 predictor: hit strengthens, miss decays/replaces ----------------
    # (cr-ppm.c:69-88; matches don't touch o3).  Same-step colliding
    # contexts are GROUP-AGGREGATED: text trigram skew puts ~48% of a
    # step's o3 updates into colliding groups (measured, 2MiB doc text),
    # and electing one winner dropped the rest — costing ~10% of the
    # reference's o3 hit rate (742k vs 667k hits on identical input).
    # Canonical group semantics (deterministic, both sides replay it):
    # all hits apply first (conf += nh), then each miss applies one decay,
    # capped at 4 (nc^4 = 0 from any conf); if decayed to zero the
    # MIN-LANE miss byte becomes the new prediction.  A group of one
    # reduces exactly to the reference's per-byte rule.
    o3_upd = is_hit | is_hit2 | is_lit | is_esc

    def _nc(cf):
        return (
            (cf > 1).astype(_i32)
            + (cf > 2).astype(_i32)
            + (cf > 4).astype(_i32)
            + (cf > 8).astype(_i32)
        )

    if O3_2WAY:
        # 2-way entry evolution (winner-dedup write; see SYM_HIT2):
        #   hit1: conf1 += 1 (cap 15), slot 2 untouched
        #   hit2: promote — the victim becomes primary with conf2+1, the
        #         demoted primary keeps a decayed confidence
        #   miss: decay conf1; at zero the new byte takes slot 1 and the
        #         old primary falls to slot 2 (the reference discards it,
        #         cr-ppm.c:78-81 — keeping it is what recovers interleaved
        #         lanes' hit rate)
        if O3_2WAY == 2:
            # demote-only: slot 1 evolves EXACTLY as the 1-way rule (a
            # promotion variant measured +0.12 bits/hit on the primary
            # symbol — churn), slot 2 just remembers the last evicted
            # prediction for the read-time literal boost
            is_hit2 = jnp.zeros_like(is_hit)
        miss = (is_lit | is_esc) & ~is_hit2
        n1 = _nc(conf)
        p1n = jnp.where(is_hit2 | (miss & (n1 == 0)), byte, pred)
        c1n = jnp.where(is_hit, jnp.minimum(conf + 1, 15), conf)
        c1n = jnp.where(is_hit2, jnp.minimum(conf2 + 1, 15), c1n)
        c1n = jnp.where(miss, jnp.maximum(n1, 1), c1n)
        demote = is_hit2 | (miss & (n1 == 0))
        p2n = jnp.where(demote, pred, pred2)
        c2n = jnp.where(is_hit2, n1, jnp.where(demote, 1, conf2))
        packed = (c2n << 20) | (p2n << 12) | (c1n << 8) | p1n
    elif O3_GROUPUPD:
        same = (h3[:, None] == h3[None, :]) & o3_upd[None, :]
        nh = jnp.sum((same & is_hit[None, :]).astype(_i32), axis=1)
        miss_j = o3_upd & ~is_hit
        nm = jnp.sum((same & miss_j[None, :]).astype(_i32), axis=1)
        lane_ids = jax.lax.broadcasted_iota(_i32, (s_lanes,), 0)
        fm = jnp.min(
            jnp.where(same & miss_j[None, :], lane_ids[None, :], s_lanes),
            axis=1,
        )
        fm_oh = (
            jax.lax.broadcasted_iota(_i32, (s_lanes, s_lanes), 1)
            == fm[:, None]
        )
        fm_byte = jnp.sum(jnp.where(fm_oh, byte[None, :], 0), axis=1)
        gconf = jnp.minimum(conf + nh, 15)
        for k in range(4):
            gconf = jnp.where(nm > k, _nc(gconf), gconf)
        replaced = (nm > 0) & (gconf == 0)
        new_pred = jnp.where(replaced, fm_byte, pred)
        new_conf = jnp.where(replaced, 1, gconf)
        packed = (new_conf << 8) | new_pred
    else:
        nc = _nc(conf)
        new_pred = jnp.where(is_hit | (nc > 0), pred, byte)
        new_conf = jnp.where(
            is_hit, jnp.minimum(conf + 1, 15), jnp.maximum(nc, 1)
        )
        packed = (new_conf << 8) | new_pred
    # Winner-dedup (same-context lanes are common on text; summed deltas
    # measured -2.7% ratio on crx) + ROW-delta scatter-add: the winner
    # lane's delta = desired - current replays a sequential write exactly,
    # while the ROW-shaped add avoids a 1-D element scatter.
    winners = tb.elect_winners(h3, o3_upd)
    # raw stored value makes the delta an exact set; callers without it
    # fall back to the reconstructed clamp (identical unless garbage)
    if o3_raw is not None:
        old_row_val = o3_raw
    elif O3_2WAY:
        old_row_val = (conf2 << 20) | (pred2 << 12) | (conf << 8) | pred
    else:
        old_row_val = (conf << 8) | pred
    col = h3 & 127
    sel = (
        jax.lax.broadcasted_iota(_i32, (ctx2.shape[0], 128), 1)
        == col[:, None]
    )
    delta = jnp.where(
        sel & winners[:, None], (packed - old_row_val)[:, None], 0
    )
    safe_r = jnp.where(winners, h3 >> 7, t["o3"].shape[0])
    t["o3"] = t["o3"].at[safe_r].add(delta, mode="drop")
    return t
