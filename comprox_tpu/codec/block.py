"""Block codec: S lock-step lanes over one block — match layer + PPM + rANS.

Data-parallel re-architecture of the reference codec cores (richox/comprox
src/{rox,rolz,rop}main/cr-coder.c).  The reference runs ONE sequential
symbol loop with helper pthreads; here a block of n bytes is split into S
contiguous equal chunks ("lanes"), and all lanes advance **one byte per
step** in lock-step:

    position(lane, step) = lane * T + step,   T = ceil(n / S)

Every per-symbol structure becomes a vector over lanes: model contexts, rANS
states, match/copy state.  Model tables and the match tables are *shared*
across lanes and updated deterministically once per step (models/tables.py),
so the models see the whole block's statistics — lanes cost no cold-start.

Two match layers (selected by ``mode``):

``mode='P'`` — LZP (ropmain/cr-matcher.c re-expressed): a ladder of shared
hash tables (exact ctx-2, byte-verified hashed ctx-4/ctx-8) maps recent
contexts to their positions.  A lane signals a match with A-symbol 258 and
codes only the length — the source is implied by the shared deterministic
table rule.

``mode='R'`` — ROLZ (rolzmain/cr-matcher.c re-expressed): a shared table of
context buckets, each holding the D most recent positions seen after that
3-byte context plus a 4-byte prefix cache.  A match codes (bucket index,
length); because the index is *coded*, the encoder's candidate selection is
pure policy — only the bucket state evolution must match the decoder, which
it does because both sides run the same insert rule.  Entries are inserted
3 positions late so the 4-byte prefix is known to the decoder, which also
makes every entry automatically causal (entry position q has decode-step
q % T = t_insert - 3 < any reader's step).

Matched lanes then *copy one byte per step* for L-1 further steps.  Copy
causality for 'P' mode requires src % T < t (checked in _lzp_candidate);
see SURVEY.md §7 hard part 4 — this design resolves decode-side match
copies without a serial loop.

Encode is two passes (rANS is LIFO): pass 1 = forward modeling scan emitting
normalized (c, f) events per (step, slot, lane); pass 2 = backward rANS scan
emitting stream words.  Decode is one forward scan fusing modeling + rANS.
Both sides share the model read/update functions, which is what makes the
table evolution bit-identical.

Events per step per lane, in stream order (step, slot, lane) ascending:
  slot A — PPM symbol: literal 0..255 / o3-hit 256 / escape 257 / match 258
  slot B — escaped literal in o1, or ROLZ bucket index
  slot C — match length
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from comprox_tpu.models import ppm
from comprox_tpu.models import tables as tb
from comprox_tpu.ops import rans
from comprox_tpu.ops.rans_scalar import RANS_L

LZP4_BITS = 20  # ctx-4 table width        (ref ropmain: 2^20, cr-matcher.c:35-49)
LZP8_BITS = 23  # ctx-8 table width        (ref ropmain: 2^24; 2^23 + verify)
LZP4_SIZE = 1 << LZP4_BITS
LZP8_SIZE = 1 << LZP8_BITS
_i32 = jnp.int32
_u32 = jnp.uint32


@dataclass(frozen=True)
class BlockParams:
    lanes: int = 256  # S
    steps: int = 4096  # T: block capacity = lanes * steps bytes
    mode: str = "P"  # 'P' = LZP, 'R' = ROLZ
    match: bool = True  # enable the match layer at all
    min_len: int = 4  # (ref ropmain match_min=4; rolzmain match_min=5)
    window: int = 250  # encoder match-length cap (<= 255 + min_len)
    o3_bits: int = 22  # o3 predictor hash width (ref: 22, cr-ppm.h:39)
    rolz_bits: int = 18  # ROLZ bucket count    (ref: 2^18, rolz cr-matcher.h)
    rolz_depth: int = 64  # positions per bucket (ref: 64)
    rolz_ctx_bytes: int = 3  # context bytes keying a bucket (the reference
    # switches 3 -> 4 for blocks >= 4MiB: rolzmain/cr-matcher.c:38-42,
    # set at cr-coder.c:162).  Format-relevant: rides the container header
    rolz_dec: int = 1  # ROLZ insert decimation: only positions with
    # pos % rolz_dec == 0 enter the buckets (both sides replay the same
    # rule).  1 = every position (the reference's rule); 2 halves the
    # per-step insert scatter cost (PERF.md roadmap rev 2).  Format-
    # relevant: rides the container header.
    short_depth: int = 0  # ROLZ secondary short-match table: per previous-
    # byte value, the D most recent positions, serving match sources as idx
    # symbols rolz_depth..rolz_depth+D-1 when the main context bucket has
    # no match (rolzmain/cr-matcher.c:165-179 m_short_table[256][16]).
    # 0 disables (the default: measured ratio-negative on doc text, see
    # PERF.md).  Format-relevant: rides the container header.
    # encoder-only search policy (not format-relevant: the chosen index/
    # distance is coded) — candidates fully probed at pos and at pos+1
    # (lazy parse).  Each extra candidate costs one row gather per step.
    top_k: int = 4
    lazy_top_k: int = 4
    probe: int = 32  # phase-1 candidate probe depth (bytes; the winner
    # alone gets the full-window extension)
    flexible: bool = True  # price-DP parse (roxmain/cr-matcher.c:253-293
    # flexible parsing, generalized): a backward cost scan chooses per
    # position literal vs any admissible truncation of the found match.
    # False = greedy accept-longest with a one-step lazy check (the
    # reference's default parse).  Pure encoder policy, not format.
    chain_match: bool = False  # chain mode v2: carry the ROLZ bucket
    # table AND the previous block's bytes across chained blocks — the
    # reference's matcher window spans its whole 16 MiB split while ours
    # reset per block (the measured residual scale gap, PERF.md).
    # Positions become window-absolute over [prev block | this block]
    # (bucket entries remap p -> max(p - N, 0) at each block boundary;
    # both sides replay the rule, sources < N read the previous block's
    # bytes — always causal, they are fully decoded).  Format-relevant:
    # rides the container header (F_CHAIN_MATCH); only meaningful under
    # chain mode, mode 'R', flexible parse, sort finder, short_depth 0.

    def __post_init__(self):
        if self.lanes % 8 or self.lanes < 8:
            raise ValueError("lanes must be a positive multiple of 8")
        if self.window > 256:
            # the flexible-parse DP packs (cost, length) as cost*256 +
            # (255 - offs); offs ranges over the window
            raise ValueError("window must be <= 256")
        if (
            self.mode == "R"
            and self.short_depth
            and self.lanes * self.steps > (1 << 24)
        ):
            # the short table rides exact one-hot f32 matmuls (reads AND
            # inserts); positions must stay <= 2^24 for f32 exactness
            raise ValueError(
                "ROLZ short-match table requires block capacity <= 16 MiB "
                "(set short_depth=0 for larger blocks)"
            )
        if self.mode == "R" and self.short_depth not in (0, 8, 16):
            raise ValueError("short_depth must be 0, 8 or 16")
        if self.rolz_dec not in (1, 2, 4):
            raise ValueError("rolz_dec must be 1, 2 or 4")
        if self.mode == "R":
            from comprox_tpu.models.ppm import IDX_W

            if self.rolz_depth + self.short_depth > IDX_W:
                raise ValueError(
                    f"rolz_depth + short_depth must be <= {IDX_W}"
                )
        if self.chain_match and (
            self.mode != "R"
            or not self.match
            or not self.flexible
            or self.short_depth
        ):
            raise ValueError(
                "chain_match requires mode R with the match layer, "
                "flexible parse and short_depth=0"
            )
        if self.mode in ("X", "F") and self.lanes * self.steps > (1 << 24):
            # distance code space: buckets 0..23 cover dist < 2^24 and the
            # mantissa events carry at most 24 bits; a larger block would
            # alias dist >= 2^24 onto SYM_DST_REPEAT and encode archives
            # that cannot decode.  The reference fixes its split at 16 MiB
            # (src/main.c:62), so this cap also matches its behavior.
            raise ValueError(
                "mode 'X' block capacity is capped at 16 MiB "
                f"(got {self.lanes * self.steps})"
            )

    @property
    def capacity(self) -> int:
        return self.lanes * self.steps

    @property
    def stream_fallback_words(self) -> int:
        # the stored-block fallback guarantees container payloads are
        # smaller than the raw block, so their word streams fit in
        # capacity/2 words
        return self.capacity // 2 + 16

    @property
    def stream_pad(self) -> int:
        # buffer size for streams within the fallback bound; a fixed pad
        # keeps decode at ONE compilation per geometry.  The n_slots*lanes
        # slack keeps the decoder's per-step window slice (scalar-start
        # dynamic_slice, which XLA clamps) in bounds at the stream tail.
        return self.stream_fallback_words + self.n_slots * self.lanes

    @property
    def n_slots(self) -> int:
        # A, B, C (+ D/E distance extra-bit events in LZ77 mode); the
        # static-table fast profile ('F') codes tokens as SYM + two
        # uniform mantissa events (codec/fast.py)
        return 5 if self.mode == "X" else 3

    @property
    def stream_pad_max(self) -> int:
        # absolute worst case: n_slots events/byte, <=1 word/event (for
        # raw decode_block calls on adversarial payloads, bypassing the
        # container's stored fallback)
        return self.n_slots * self.capacity + 16 + self.n_slots * self.lanes


def lzp_hash4(ctx4):
    """Multiplicative hash of the last 4 bytes -> ctx-4 bucket."""
    v = ctx4.astype(_u32) * _u32(2654435761)
    return ((v >> 12) & _u32(LZP4_SIZE - 1)).astype(_i32)


def lzp_hash8(ctx4, ctx4b):
    """Hash of the last 8 bytes (two packed u32 words) -> ctx-8 bucket.

    The high-precision table of the LZP ladder (ropmain/cr-matcher.c:59-73
    picks the longest-context table first; we keep 8 -> 4 -> 2).

    Distinct odd multipliers per half — with one shared constant C the
    hash degenerates on equal halves (zero/space runs, 4-periodic data:
    a*C ^ a*C = 0 -> bucket 0) and is symmetric under half-swap (same
    advisor finding as x_hash8, round 2).  Format-relevant (both sides
    compute it): rides FORMAT_REV."""
    v = ctx4.astype(_u32) * _u32(2654435761) ^ ctx4b.astype(_u32) * _u32(
        0xC2B2AE3D
    )
    return ((v >> 10) & _u32(LZP8_SIZE - 1)).astype(_i32)


def rolz_hash3(key3, bits: int):
    """3-byte context -> ROLZ bucket (rolzmain hashes the last 3 bytes
    into 2^18 buckets, cr-matcher.c:38-42)."""
    v = key3.astype(_u32) * _u32(2654435761)
    return ((v >> (32 - bits)) & _u32((1 << bits) - 1)).astype(_i32)


def x_hash4(nx4, bits: int):
    """4 content bytes -> LZ77 bucket (the analogue of roxmain's
    hash-chain bucketing, roxmain/cr-matcher.c:39-53; our 'chain' is the
    same fixed-depth bucket structure the ROLZ layer uses)."""
    v = nx4.astype(_u32) * _u32(0x9E3779B1)
    return ((v >> (32 - bits)) & _u32((1 << bits) - 1)).astype(_i32)


def x_hash8(nx4, fol4, bits: int):
    """8 content bytes -> LZ77 bucket.  The reference keys its main chain
    on hash2 over match_min ~ 10 bytes (roxmain/cr-matcher.c:43-51,
    cr-coder.c:192); keying on 4 bytes funnels every occurrence of a
    common 4-gram through one recency bucket, which lock-step lane inserts
    churn instantly (measured: 4x fewer candidate positions than the
    context-keyed 'R' search on doc text).  8 bytes spreads common
    prefixes by their continuation; the 6-byte xshort cache serves the
    short/near matches this key no longer sees.

    Distinct odd multipliers per half: with one shared constant C the hash
    degenerates to (a ^ b) * C-ish behavior — any 8-gram with equal 4-byte
    halves (zero/space runs, 4-periodic data) lands in bucket 0 and the
    hash is symmetric under half-swap, exactly on the most matchable
    content (advisor finding, round 2).  Encoder-private: ratio/speed
    only, not format."""
    v = nx4.astype(_u32) * _u32(0x9E3779B1) ^ fol4.astype(_u32) * _u32(
        0x85EBCA77
    )
    return ((v >> (32 - bits)) & _u32((1 << bits) - 1)).astype(_i32)


def _sel_along(arr, idx):
    """arr[i, idx[i]] via one-hot where-sum instead of take_along_axis
    (a gather per call inside scan bodies; the masked reduce fuses)."""
    sel = (
        jax.lax.broadcasted_iota(_i32, arr.shape, arr.ndim - 1)
        == idx[..., None]
    )
    return jnp.sum(jnp.where(sel, arr, 0), axis=-1)


def _dist_bucket(dist):
    """k = bit_length(dist) - 1 via integer compares (exact, no floats)."""
    k = jnp.zeros_like(dist)
    for j in range(1, 25):
        k = k + (dist >= (1 << j)).astype(dist.dtype)
    return k


SYM_DST_REPEAT = 24  # distance == previous distance (roxmain codes this
# as raw distance 0, cr-coder.c:232-235)

import os as _os

_SHORT_EXTRA = int(_os.environ.get("CPX_SHORT_EXTRA", "2"))


def _lane_ids(s):
    return jax.lax.broadcasted_iota(_i32, (s, 1), 0).reshape(s)


def _byteswap32(v):
    v = v.astype(_u32)
    return (
        ((v & 0xFF) << 24)
        | ((v & 0xFF00) << 8)
        | ((v >> 8) & 0xFF00)
        | (v >> 24)
    )


def _init_carry(p: BlockParams, enc_side: bool, search: bool = False):
    """Scan carry.  ``search=True`` builds the encoder's search-pass carry:
    match tables only (no PPM tables needed), plus the 'X' short-hash
    cache.  The modeling pass no longer owns the 'X' bucket table — match
    decisions are precomputed by the search+parse passes."""
    c = {
        "ctx4": jnp.zeros((p.lanes,), _u32),  # last 4 bytes, newest low
        "ctx4b": jnp.zeros((p.lanes,), _u32),  # bytes -8..-5
        "copy_rem": jnp.zeros((p.lanes,), _i32),
        "copy_src": jnp.zeros((p.lanes,), _i32),
    }
    if not search:
        c["tables"] = ppm.init_tables(p.match, p.o3_bits)
    if p.mode == "X" and search:
        # roxmain's 65536-entry short-match cache (cr-matcher.c:319-331):
        # last position per 6-byte-hash, serving near matches the bucket
        # search misses.  Encoder-private (distances are coded).
        c["xshort"] = jnp.zeros((1 << 16,), _i32)
        # second candidate source: CONTEXT-keyed buckets (the 'R' search
        # structure).  Measured on doc text: content-keyed buckets see
        # candidates at only 238k of 2M positions (exact 8-byte repeats
        # within recency-64) while context-keyed ones see 644k ("what
        # followed this context before").  'X' codes explicit distances,
        # so this table is encoder-private too — decode speed unchanged.
        nb = 1 << p.rolz_bits
        c["xctx_ent"] = jnp.zeros((nb, p.rolz_depth, 2), _i32)
    if p.mode == "R" or (p.mode == "X" and search):
        # 'X' keeps the bucket tables encoder-private: distances are coded
        # explicitly, so the decoder never touches a match table.
        # Entries pack (pos+1, prefix4) in one table, so one wide gather/
        # scatter serves both (random-access ops cost per row, not per
        # byte of width).
        # No write pointer: positions strictly increase with time, so
        # recency order IS descending-position order and "replace the
        # oldest" (min position, empties = 0) IS the circular insert —
        # bit-identical bucket evolution with 2-3 fewer random-access
        # ops per step.
        nb = 1 << p.rolz_bits
        c["rolz_ent"] = jnp.zeros((nb, p.rolz_depth, 2), _i32)
        if p.mode == "R" and p.short_depth:
            c["rolz_s"] = jnp.zeros((256, 3 * p.short_depth), _i32)
    elif p.mode == "P":
        c["lzp2"] = jnp.zeros((1 << 16,), _i32)
        c["lzp4"] = jnp.zeros((LZP4_SIZE,), _i32)
        c["lzp8"] = jnp.zeros((LZP8_SIZE,), _i32)
    if p.mode == "X":
        c["prev_dist"] = jnp.ones((p.lanes,), _i32)
    return c


# --------------------------------------------------------------------------
# LZP candidate rule (shared: both sides must compute the same source)
# --------------------------------------------------------------------------


def _lzp_candidate(c, t, p: BlockParams, hist_flat):
    """Deterministic match-source selection, identical on both sides:
    prefer the ctx-8 table's entry when present, causally readable
    (src % T < t, see the causality note in _encode_model_body) and
    context-verified, then ctx-4, then the exact ctx-2 entry.

    Context verification (the reference's matcher_getpos check,
    ropmain/cr-matcher.c:59-73): the k bytes preceding src must equal the
    lane's own last k bytes, rejecting hash-collision mispredictions.
    ``hist_flat`` is the byte history — the input on encode, the decoded
    buffer on decode (equal by losslessness).  Verification only applies
    when src % T >= k, so all compared bytes are causally available to the
    decoder; chunk-head sources are accepted unverified (rare).
    """
    s_lanes = c["ctx4"].shape[0]
    src8 = c["lzp8"][lzp_hash8(c["ctx4"], c["ctx4b"])] - 1
    src4 = c["lzp4"][lzp_hash4(c["ctx4"])] - 1
    src2 = c["lzp2"][(c["ctx4"] & 0xFFFF).astype(_i32)] - 1
    offs = jax.lax.broadcasted_iota(_i32, (s_lanes, 8), 1)
    sh = (7 - offs) * 8  # newest byte (src-1) sits in ctx4 low bits
    want_packed = jnp.where(offs < 4, c["ctx4b"][:, None], c["ctx4"][:, None])
    want = (want_packed >> (sh % 32)) & 0xFF

    def verified(src, k, t_min):
        ok = (src >= 0) & ((src % p.steps) < t) & (t >= t_min)
        verifiable = ok & ((src % p.steps) >= k)
        base = jnp.maximum(src - k, 0)
        idx = jnp.clip(
            base[:, None] + offs[:, 8 - k :] - (8 - k),
            0,
            hist_flat.shape[0] - 1,
        )
        got = hist_flat[idx]
        eq = jnp.all(got.astype(_u32) == want[:, 8 - k :], axis=1)
        return ok & (eq | ~verifiable)

    ok8 = verified(src8, 8, 8)
    ok4 = verified(src4, 4, 4)
    # ctx2 is an exact 2-byte index (no hash, no verify needed)
    ok2 = (src2 >= 0) & ((src2 % p.steps) < t) & (t >= 2)
    src = jnp.where(ok8, src8, jnp.where(ok4, src4, src2))
    return src, ok8 | ok4 | ok2


# --------------------------------------------------------------------------
# ROLZ bucket query (decode side / shared geometry helpers)
# --------------------------------------------------------------------------


def _rec_bucket(sym_idx):
    """len-model context: recency bucket of the chosen index
    (0 / 1-3 / 4-15 / 16+)."""
    return (
        (sym_idx >= 1).astype(_i32)
        + (sym_idx >= 4).astype(_i32)
        + (sym_idx >= 16).astype(_i32)
    )


def _fill_bucket(fill):
    """idx-model context: bucket fill quartile."""
    return jnp.clip((fill - 1) // 16, 0, 3)


def _rolz_key(ctx4, p: BlockParams):
    mask = 0xFFFFFF if p.rolz_ctx_bytes == 3 else 0xFFFFFFFF
    return (ctx4 & _u32(mask)).astype(_i32)


def _rolz_ctx(c, p: BlockParams):
    return rolz_hash3(_rolz_key(c["ctx4"], p), p.rolz_bits)


def _recency_ranks(cand_pos):
    """Recency index per bucket slot from positions alone: rank by
    position DESCENDING (positions are unique and strictly increase with
    time; empty slots hold 0 and sink to the highest ranks, tie-broken by
    slot id for determinism).  [S, D] -> [S, D]."""
    pi = cand_pos[:, :, None]
    pj = cand_pos[:, None, :]
    slot = jax.lax.broadcasted_iota(_i32, cand_pos.shape, 1)
    newer = (pj > pi) | ((pj == pi) & (slot[:, None, :] > slot[:, :, None]))
    return jnp.sum(newer.astype(_i32), axis=2)


def _rolz_src_of_rows(ent_rows, rec_idx):
    """Entry position for a coded recency index, given already-gathered
    bucket rows (one gather serves fill-context and source lookup).  The
    slot is the one whose descending-position rank equals the index — no
    write-pointer state, no extra gather."""
    return _src_of_pos_rows(ent_rows[..., 0], rec_idx)


def _src_of_pos_rows(cand_pos, rec_idx):
    rec = _recency_ranks(cand_pos)
    sel = rec == rec_idx[:, None]
    return jnp.sum(jnp.where(sel, cand_pos, 0), axis=1) - 1


# --------------------------------------------------------------------------
# ROLZ secondary short-match table (rolzmain/cr-matcher.c:165-179
# m_short_table[256][16]): per previous-byte value, the D most recent
# positions, serving match sources as idx symbols rolz_depth..+D-1 when the
# main context bucket has no match.  With only 256 contexts the table
# reads AND inserts are exact one-hot f32 matmuls — no random-access ops
# at all.  Layout [256, 3D] int32: columns [0:D) = pos+1 (0 = empty),
# [D:2D) = prefix4 low 16 bits, [2D:3D) = high 16 bits — every value
# < 2^24, so a Precision.HIGHEST (true fp32) dot is exact on every
# backend, and per output element at most ONE lane contributes (colliding
# lanes take distinct slots), so accumulation is exact too.
# --------------------------------------------------------------------------


def _exact_onehot_matmul(oh_bool, tab):
    return jnp.dot(
        oh_bool.astype(jnp.float32),
        tab.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(_i32)


def _short_read(tab, d: int, key):
    """All lanes' short-table rows: ([S, D] pos, [S, D] prefix4)."""
    oh = (
        jax.lax.broadcasted_iota(_i32, (key.shape[0], 256), 1)
        == key[:, None]
    )
    rows = _exact_onehot_matmul(oh, tab)
    cand_pos = rows[:, :d]
    cand_nx4 = (
        rows[:, d : 2 * d].astype(_u32)
        | (rows[:, 2 * d :].astype(_u32) << 16)
    )
    return cand_pos, cand_nx4


def _short_insert(tab, d: int, key, ins, pos, nx4):
    """Replace each row's oldest entry with (q+1, prefix) for q = pos-3,
    keyed by the byte at q-1 — the dense-matmul analogue of _bucket_insert
    (same min-position-replace rule, same lane-order collision ranks)."""
    s = key.shape[0]
    same = (key[:, None] == key[None, :]) & ins[None, :]
    lower = jnp.tril(jnp.ones((s, s), bool), k=-1)
    rank = jnp.sum(same & lower, axis=1)
    ins = ins & (rank < d)
    oh = (
        jax.lax.broadcasted_iota(_i32, (s, 256), 1) == key[:, None]
    ) & ins[:, None]
    old = _exact_onehot_matmul(oh, tab)  # [S, 3D]; zero rows where ~ins
    old_pos = old[:, :d]
    age = (d - 1) - _recency_ranks(old_pos)  # oldest = 0
    slot_ids = jax.lax.broadcasted_iota(_i32, (s, d), 1)
    slot = jnp.sum(jnp.where(age == rank[:, None], slot_ids, 0), axis=1)
    hit = (slot_ids == slot[:, None]) & ins[:, None]  # [S, D]
    q1 = pos - 3 + 1
    lo = (nx4 & 0xFFFF).astype(_i32)
    hi = (nx4 >> 16).astype(_i32)
    delta = jnp.concatenate(
        [
            jnp.where(hit, q1[:, None] - old_pos, 0),
            jnp.where(hit, lo[:, None] - old[:, d : 2 * d], 0),
            jnp.where(hit, hi[:, None] - old[:, 2 * d :], 0),
        ],
        axis=1,
    )
    return tab + _exact_onehot_matmul(oh.T, delta)


# --------------------------------------------------------------------------
# shared per-step pieces
# --------------------------------------------------------------------------


def _common_reads(c, t, n, p: BlockParams):
    """Shared per-step context derivation for encode pass 1 and decode."""
    lanes = _lane_ids(p.lanes)
    pos = lanes * p.steps + t
    active = pos < n
    coding = active & (c["copy_rem"] == 0)
    copying = active & (c["copy_rem"] > 0)
    ctx4 = c["ctx4"]
    p1 = (ctx4 & 0xFF).astype(_i32)
    p2 = ((ctx4 >> 8) & 0xFF).astype(_i32)
    ctx2 = (p2 << 8) | p1
    ctx3 = (ctx4 & 0xFFFFFF).astype(_i32)
    o3_size = c["tables"]["o3"].size
    if ppm.O3_GROUPS > 1:
        # Partition the o3 table into lane groups (contiguous lanes =
        # contiguous file regions): the replace-style predictor is
        # locality-sensitive, and 256 interleaved prefixes overwriting one
        # shared entry cost ~11% of the reference's hit rate (measured vs
        # the cr-ppm.c probe on identical input).  Counts-based o2/o1
        # stay shared: additive stats merge gracefully.
        seg = o3_size // ppm.O3_GROUPS
        grp = lanes // max(1, p.lanes // ppm.O3_GROUPS)
        h3 = ppm.o3_hash(ctx3, seg) + jnp.minimum(
            grp, ppm.O3_GROUPS - 1
        ) * seg
    else:
        h3 = ppm.o3_hash(ctx3, o3_size)
    pred, conf, pred2, conf2, o3raw = ppm.o3_read(c["tables"], h3)
    return (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
            pred2, conf2, o3raw)


def _bucket_insert(c, p: BlockParams, rctx, ins, pos, nx4, old_rows=None,
                   late: int = 3, table: str = "rolz_ent"):
    """Insert (q+1, prefix) for q = pos-late, replacing each bucket's OLDEST
    entry (min position; empties hold 0 and are consumed first) — bit-
    identical to a circular write pointer because positions strictly
    increase with time, without the pointer's gather+scatter.  Multiple
    lanes inserting into one bucket in the same step take consecutive
    oldest slots ordered by lane id (deterministic)."""
    same = (rctx[:, None] == rctx[None, :]) & ins[None, :]
    lower = jnp.tril(jnp.ones((p.lanes, p.lanes), bool), k=-1)
    rank = jnp.sum(same & lower, axis=1)
    ins = ins & (rank < p.rolz_depth)
    old = c[table][rctx] if old_rows is None else old_rows
    age = (p.rolz_depth - 1) - _recency_ranks(old[..., 0])  # oldest = 0
    slot_ids = jax.lax.broadcasted_iota(_i32, age.shape, 1)
    slot = jnp.sum(jnp.where(age == rank[:, None], slot_ids, 0), axis=1)
    safe_r = jnp.where(ins, rctx, 1 << p.rolz_bits)
    q = pos - late
    ent = jnp.stack([q + 1, nx4.astype(_i32)], axis=-1)  # [S, 2]
    # ROW-delta scatter-add with 1D bucket indices, NOT a (bucket, slot)
    # 2D-index set: the 2D scatter makes XLA pick a different layout for
    # the scatter than for the row gathers, inserting a full-table layout-
    # conversion copy of the 128MB table EVERY scan step (found by
    # profile).  Colliding lanes hit
    # distinct slots, so their row deltas sum correctly.
    hit = (slot_ids == slot[:, None]) & ins[:, None]  # [S, D]
    delta = jnp.where(hit[..., None], ent[:, None, :] - old, 0)
    c[table] = c[table].at[safe_r].add(delta, mode="drop")
    return c


def _post_step(c, t, n, p: BlockParams, pos, active, byte, is_match, src,
               sym_len, enc_side: bool = True, dist=None):
    """Shared end-of-step state evolution: copy state, context registers,
    match-table inserts (identical on encode and decode wherever the
    decoder needs the table; 'X' tables are encoder-private)."""
    new_rem = jnp.where(
        is_match,
        sym_len + (p.min_len - 1),
        jnp.maximum(c["copy_rem"] - 1, 0),
    )
    new_src = jnp.where(is_match, src + 1, c["copy_src"] + 1)
    ctx4n = jnp.where(active, (c["ctx4"] << 8) | byte.astype(_u32), c["ctx4"])
    ctx4bn = jnp.where(
        active, (c["ctx4b"] << 8) | (c["ctx4"] >> 24), c["ctx4b"]
    )
    c = {
        **c,
        "ctx4": ctx4n,
        "ctx4b": ctx4bn,
        "copy_rem": new_rem,
        "copy_src": new_src,
    }
    if p.mode == "X" and dist is not None:
        c["prev_dist"] = jnp.where(is_match, dist, c["prev_dist"])
    if p.mode == "X" and enc_side:
        # entry for q = pos-7 keyed by its own 8 content bytes (bytes
        # q..q+3 = byteswap(ctx4b), q+4..q+7 = byteswap(ctx4), all known;
        # only the encoder needs the table: distances are explicit).
        # Inserted 7 late -> causal for free (q % T = t-7 < t).
        ins = active & (t >= 10)
        nx4q = _byteswap32(ctx4bn)
        rctx = x_hash8(nx4q, _byteswap32(ctx4n), p.rolz_bits)
        c = _bucket_insert(c, p, rctx, ins, pos, nx4q, late=7)
        # context-keyed candidate table (see _init_carry): same insert
        # rule as mode 'R' — entry q = pos-3 under the bytes [q-k, q)
        ins_c = active & (t >= 7 if p.rolz_ctx_bytes == 4 else t >= 6)
        rctx_c = rolz_hash3(_rolz_key(ctx4bn, p), p.rolz_bits)
        c = _bucket_insert(
            c, p, rctx_c, ins_c, pos, _byteswap32(ctx4n),
            table="xctx_ent",
        )
    elif p.mode == "R":
        # Insert the entry for position q = pos-3 under context bytes
        # [q-3, q): all of q's 4-byte prefix (bytes q..q+3 = pos-3..pos) is
        # now known on BOTH sides, so the prefix cache is exact.
        ins = active & (t >= 7 if p.rolz_ctx_bytes == 4 else t >= 6)
        if p.rolz_dec > 1:
            # decimated inserts (identical replay on decode: pos-driven)
            ins = ins & (pos % p.rolz_dec == 0)
        # key bytes precede entry position q = pos-3: [q-k, q)
        rctx = rolz_hash3(_rolz_key(ctx4bn, p), p.rolz_bits)
        # chain_match: entries are window-absolute over [prev | cur]
        ipos = pos + (p.capacity if p.chain_match else 0)
        c = _bucket_insert(c, p, rctx, ins, ipos, _byteswap32(ctx4n))
        if p.short_depth:
            # short table keyed by the single byte at q-1 (= pos-4, the
            # low byte of the updated ctx4b register); every position
            # inserts, mirroring rolzmain/cr-matcher.c:76-79
            c["rolz_s"] = _short_insert(
                c["rolz_s"], p.short_depth,
                (ctx4bn & 0xFF).astype(_i32), active & (t >= 4), pos,
                _byteswap32(ctx4n),
            )
    elif p.mode == "P":
        # LZP: map context-for-position pos+1 -> pos+1 (stored +1;
        # scatter-max so the newest position wins collisions)
        ins2 = active & (t >= 1) & (t != p.steps - 1) & (pos + 1 < n)
        ins4 = ins2 & (t >= 3)
        ins8 = ins4 & (t >= 7)
        c["lzp2"] = c["lzp2"].at[
            jnp.where(ins2, (ctx4n & 0xFFFF).astype(_i32), 1 << 16)
        ].max(pos + 2, mode="drop")
        c["lzp4"] = c["lzp4"].at[
            jnp.where(ins4, lzp_hash4(ctx4n), LZP4_SIZE)
        ].max(pos + 2, mode="drop")
        c["lzp8"] = c["lzp8"].at[
            jnp.where(ins8, lzp_hash8(ctx4n, ctx4bn), LZP8_SIZE)
        ].max(pos + 2, mode="drop")
    return c


_PACK_TAIL = 66  # >= max window nw: every slice start stays in range


def _pack_words(inp_flat):
    """[n] u8 -> [n/4 + tail] u32 little-endian words (built once per
    encode pass; the match searcher slices words, not bytes).  The zero
    tail guarantees _gather_windows' dynamic slices never hit XLA's
    start clamping, which would silently shift a window and let the
    prefix compare claim false byte equality near the buffer end."""
    pad = (-inp_flat.shape[0]) % 4 + 4 * _PACK_TAIL
    inp_flat = jnp.pad(inp_flat, (0, pad))
    w = inp_flat.reshape(-1, 4).astype(_u32)
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


def _gather_windows(inp_w32, src, width: int):
    """[S, width] byte windows starting at per-lane positions ``src``.

    Gathering 4x fewer u32 words than a direct [S, width] u8 byte gather
    and re-aligning with four static slices selected by src&3 cuts the
    gathered element count 4x; beyond-
    end reads clamp at word granularity (encoder-policy windows only —
    lengths are capped to in-range bytes before coding)."""
    s_lanes = src.shape[0]
    nw = width // 4 + 2
    base = jnp.maximum(src, 0)
    bw = base >> 2
    # index-matrix gather (one gather op, not a vmapped per-lane
    # dynamic_slice).  No clip needed: _PACK_TAIL keeps bw+nw in range
    offs = jax.lax.broadcasted_iota(_i32, (s_lanes, nw), 1)
    words = inp_w32[bw[:, None] + offs]
    by = jnp.stack(
        [
            words & 0xFF,
            (words >> 8) & 0xFF,
            (words >> 16) & 0xFF,
            (words >> 24) & 0xFF,
        ],
        axis=-1,
    ).reshape(s_lanes, nw * 4)
    a = base & 3
    out = by[:, 0:width]
    for k in range(1, 4):
        out = jnp.where((a == k)[:, None], by[:, k : k + width], out)
    return out.astype(_i32)


def _prefix_len(cur_win, cand):
    """Length of the common prefix per lane: count positions before the
    first mismatch (prefix-AND via a cumsum of mismatches)."""
    neq = (cand != cur_win).astype(jnp.int32)
    incl = tb.exclusive_cumsum(neq) + neq
    return jnp.sum((incl == 0).astype(_i32), axis=-1)


# --------------------------------------------------------------------------
# Sort-based whole-block candidate finder (modes 'X' and 'F').
#
# Instead of a per-step search scan, this finder touches every position
# once with whole-block vectorized ops: hash the 6-byte gram at every
# position, stable-sort (hash, pos) so the K previous occurrences of a
# gram are sort-adjacent (the hash-chain walk of
# roxmain/cr-matcher.c:237-340 collapsed into one sort — and with NO
# recency-depth cap), scatter candidates back to position order, then
# word-compare extension plus a diagonal-run recovery for long runs.
# Encoder-private throughout: 'X'/'F' code explicit distances, so the
# candidate source never touches the decoder.
# --------------------------------------------------------------------------

# word-extension depth for mode 'X' (bytes; swept 64/128/250 on dict-
# coded text: monotone better, full window wins); the fast profile
# passes its own shallower depth
_SORT_EXT = int(_os.environ.get("CPX_SORT_EXT", "250"))
# mode-'X' candidate source: 'sort' = this finder; 'scan' = the round-2
# per-step bucket search (kept for sweeps/regression comparison)
_X_FINDER = _os.environ.get("CPX_X_FINDER", "sort")
# debug-only: capture side-event symbols/contexts in the encode debug
# grids for offline ratio probes (benchmarks/ctx_probe.py)
_DEBUG_EVT = _os.environ.get("CPX_DEBUG_EVT", "") == "1"


def _rev_runmin(m, inf):
    """Reverse running minimum via Hillis-Steele doubling (static
    shifts, log2(n) whole-array rounds)."""
    n = m.shape[0]
    k = 1
    while k < n:
        m = jnp.minimum(
            m, jnp.concatenate([m[k:], jnp.full((k,), inf, _i32)])
        )
        k <<= 1
    return m


def _diag_run_len(eq1, diag, with_tail: bool = True):
    """Per-position run length of eq1 along the candidate diagonal:
    L[i] = #bytes matching from i while cand advances in lock-step with
    the position, +1 for a final byte whose diagonal continuation is
    unknown.  eq1[i] = byte[i] == byte[cand[i]]; diag[i] = cand[i+1] ==
    cand[i] + 1.  ``with_tail=False`` skips the final-byte extension
    (one whole-array gather; lengths come out at most 1 short)."""
    n = eq1.shape[0]
    inf = jnp.int32(n + 1)
    idx = jnp.arange(n, dtype=_i32)
    g = eq1 & diag
    nf = _rev_runmin(jnp.where(g, inf, idx), inf)  # first failing j >= i
    if not with_tail:
        return jnp.minimum(nf, n) - idx
    nf_c = jnp.minimum(nf, n - 1)
    # at the failing index the diagonal STILL held from i (diag[j] true
    # for all j < nf), so eq1[nf] is a valid last-byte extension
    tail = jnp.where(nf < n, eq1[nf_c].astype(_i32), 0)
    return jnp.minimum(nf, n) - idx + tail


def _bytes_eq_count(x):
    """Leading equal bytes in a xor'd LE word: 0..4."""
    return jnp.where(
        x == 0,
        4,
        ((x & 0xFF) == 0).astype(_i32)
        + ((x & 0xFFFF) == 0).astype(_i32)
        + ((x & 0xFFFFFF) == 0).astype(_i32),
    )


def sort_candidates(p: BlockParams, inp_flat, n, n_cands: int = 3,
                    ext: int = 0, ctx_bytes: int = 0,
                    probe_from: int = 0, insert_dec: int = 1,
                    insert_late: int = 3, fwd_chain: int = 0):
    """K causal previous-occurrence candidates per position, each with a
    word-extended match length.  Returns ([N] length, [N] src) pairs in
    position order, nearest occurrence first.

    ``ctx_bytes`` = 0 keys positions by their own upcoming 6-gram (the
    content-keyed family); 3 or 4 keys them by the PRECEDING context
    bytes (the ROLZ-style "what followed this context before" family —
    on dict-coded text this source found 644k of 2M candidate positions
    where the content key saw 238k, PERF.md round 3).  Both families are
    byte-verified by extension, so hash quality only affects coverage.

    ``probe_from`` > n_cands walks a deeper chain cheaply: probe the
    first ``probe_from`` occurrences with 2 gathered words each (8-byte
    prefix), keep the ``n_cands`` best by (prefix len, recency), and
    full-extend only those — chain-depth coverage at roughly the probe's
    cost (2 vs ~ext/4 gathers per rejected candidate)."""
    N = p.capacity
    ext = min(ext or _SORT_EXT, p.window)
    pad = ext + 16
    bi = jnp.pad(inp_flat, (0, pad)).astype(_i32)
    bs = [bi[k : k + N + pad - 4] for k in range(4)]
    # w_all[j] = LE u32 at byte j (defined through j = N + ext + 8)
    w_all = bs[0] | (bs[1] << 8) | (bs[2] << 16) | (bs[3] << 24)
    idx = jnp.arange(N, dtype=_i32)
    if ctx_bytes:
        # key = the ctx_bytes bytes before the position
        wp = jnp.concatenate(
            [jnp.zeros((ctx_bytes,), _i32), w_all[: N - ctx_bytes]]
        ).astype(_u32)
        if ctx_bytes == 3:
            wp = wp & _u32(0xFFFFFF)
        h = wp * _u32(2654435761)
        valid = (idx >= ctx_bytes) & (idx < n)
    else:
        w45 = bi[4 : 4 + N] | (bi[5 : 5 + N] << 8)
        h = w_all[:N].astype(_u32) * _u32(0x9E3779B1) ^ w45.astype(
            _u32
        ) * _u32(0x85EBCA77)
        valid = idx < n
    # invalid positions sort to the very end (and are masked below)
    h = jnp.where(valid, h, _u32(0xFFFFFFFF))
    hs, ps = jax.lax.sort((h, idx), num_keys=1, is_stable=True)
    chain_b = max(probe_from, n_cands)
    prevs = []
    for k in range(1, chain_b + 1):
        pk = jnp.concatenate([jnp.full((k,), -1, _i32), ps[:-k]])
        hk = jnp.concatenate([jnp.zeros((k,), _u32), hs[:-k]])
        prevs.append(jnp.where(hk == hs, pk, -1))
    # FORWARD chain entries: positions later in POSITION order but (after
    # the causality mask below) at strictly earlier decode steps — usable
    # by the idx-coded mode 'R', where the decoder replays the bucket and
    # never sees a distance.  This is the structural ROLZ advantage of
    # lock-step lanes (CLAUDE.md); backward-only proposals measured 20%
    # fewer covered bytes on dict-coded text.
    for k in range(1, fwd_chain + 1):
        pk = jnp.concatenate([ps[k:], jnp.full((k,), -1, _i32)])
        hk = jnp.concatenate([hs[k:], jnp.zeros((k,), _u32)])
        prevs.append(jnp.where(hk == hs, pk, -1))
    chain = chain_b + fwd_chain
    cand_rows = (
        jnp.zeros((N, chain), _i32)
        .at[ps]
        .set(jnp.stack(prevs, axis=-1))
    )
    t_of = idx % p.steps
    if chain > n_cands:
        plens = []
        for k in range(chain):
            cand = cand_rows[:, k]
            ok = (cand >= 0) & ((cand % p.steps) < t_of)
            if insert_dec > 1:
                ok = ok & ((cand + insert_late) % insert_dec == 0)
            safe = jnp.clip(cand, 0, N - 1)
            m0 = _bytes_eq_count(w_all[safe] ^ w_all[:N])
            m1 = _bytes_eq_count(w_all[safe + 4] ^ w_all[4 : 4 + N])
            plen = m0 + jnp.where(m0 == 4, m1, 0)
            plens.append(jnp.where(ok, plen, -1))
        pl = jnp.stack(plens, axis=-1)  # [N, chain]
        score = pl * chain + (
            chain - 1 - jax.lax.broadcasted_iota(_i32, pl.shape, 1)
        )
        _, top = jax.lax.top_k(score, n_cands)
        cand_rows = jnp.stack(
            [_sel_along(cand_rows, top[:, j]) for j in range(n_cands)],
            axis=-1,
        )
    cap = jnp.maximum(
        jnp.minimum(
            jnp.minimum(p.steps - t_of, n - idx),
            min(p.window, p.min_len + ppm.LEN_W - 1),
        ),
        0,
    )
    out = []
    for k in range(n_cands):
        cand = cand_rows[:, k]
        # decode causality (lanes advance in lock-step): the source's
        # decode step must be strictly earlier — src % T < t.  Backward
        # position order (cand < i) alone is NOT sufficient (see the
        # _rep_lengths causality note).
        ok = (cand >= 0) & ((cand % p.steps) < t_of)
        if insert_dec > 1:
            # proposals destined for bucket-membership checking (mode R):
            # decimated inserts never enter buckets, so skip them here
            ok = ok & ((cand + insert_late) % insert_dec == 0)
        safe = jnp.clip(cand, 0, N - 1)
        L = jnp.zeros((N,), _i32)
        alive = ok
        for j in range(0, ext, 4):
            x = w_all[safe + j] ^ w_all[j : j + N]
            m = _bytes_eq_count(x)
            L = L + jnp.where(alive, m, 0)
            alive = alive & (x == 0)
        # diagonal-run recovery: word extension caps at `ext`, but runs
        # that stay on one diagonal (zeros, periodic content — exactly
        # where long matches live) measure to full window length for two
        # gathers
        eq1 = (bi[:N] == bi[safe]) & ok
        diag = jnp.concatenate(
            [cand[1:] == cand[:-1] + 1, jnp.zeros((1,), bool)]
        )
        L = jnp.maximum(L, _diag_run_len(eq1, diag))
        out.append((jnp.minimum(jnp.where(ok, L, 0), cap), cand))
    return out


def _rolz_best_match(c, pos, t, n, p: BlockParams, inp_w32, cur_win,
                     x_keyed: bool = False, probe_only: bool = False,
                     ctx4_override=None, table: str = "rolz_ent"):
    """Encoder-side candidate search at pos: score all bucket entries by
    4-byte prefix cache, probe the top-K to p.probe bytes, fully extend only
    the winner.  ``cur_win`` is the upcoming-bytes window (a contiguous
    slice — matches never cross the chunk end, so no gather is needed).
    ``x_keyed`` buckets by the upcoming 4 content bytes (LZ77 'X' mode)
    instead of the preceding 3-byte context (ROLZ 'R' mode).
    Returns (length, src, recency-index)."""
    nx = cur_win[:, :8].astype(_u32)
    own_nx4 = nx[:, 0] | (nx[:, 1] << 8) | (nx[:, 2] << 16) | (nx[:, 3] << 24)
    if x_keyed:
        own_fol4 = (
            nx[:, 4] | (nx[:, 5] << 8) | (nx[:, 6] << 16) | (nx[:, 7] << 24)
        )
        rctx = x_hash8(own_nx4, own_fol4, p.rolz_bits)
    else:
        ctx4 = c["ctx4"] if ctx4_override is None else ctx4_override
        rctx = rolz_hash3(_rolz_key(ctx4, p), p.rolz_bits)
    ent = c[table][rctx]  # [S, D, 2]
    cand_pos = ent[..., 0]
    cand_nx4 = ent[..., 1].astype(_u32)
    diff = cand_nx4 ^ own_nx4[:, None]
    score = (
        ((diff & 0xFF) == 0).astype(_i32)
        + ((diff & 0xFFFF) == 0).astype(_i32)
        + ((diff & 0xFFFFFF) == 0).astype(_i32)
        + (diff == 0).astype(_i32)
    )
    rec = _recency_ranks(cand_pos)
    fill = jnp.sum((cand_pos > 0).astype(_i32), axis=1)
    score = jnp.where(cand_pos > 0, score, -1)
    if x_keyed or table != "rolz_ent":
        # 'X' codes explicit backward distances, but lock-step lanes make
        # "the past" step-order, not position-order: entries from higher
        # lanes at earlier steps are decode-causal yet sit FORWARD of pos
        # and cannot be expressed as a distance.  Mask them BEFORE top-k,
        # or a forward winner shadows a usable backward candidate in the
        # same bucket (this cost the ctx-keyed search 75% of its
        # candidates: 165k vs 664k positions, measured).
        score = jnp.where(cand_pos - 1 < pos[:, None], score, -1)
    rank_key = score * p.rolz_depth + (p.rolz_depth - 1 - rec)
    k_top = min(p.lazy_top_k if probe_only else p.top_k, p.rolz_depth)
    _, top_slots = jax.lax.top_k(rank_key, k_top)
    lens, srcs, recs = [], [], []
    for k in range(k_top):
        sl = top_slots[:, k]
        src_k = _sel_along(cand_pos, sl) - 1
        sc_k = _sel_along(score, sl)
        cand = _gather_windows(inp_w32, src_k, p.probe)
        len_k = _prefix_len(cur_win[:, : p.probe], cand)
        lens.append(jnp.where(sc_k == 4, len_k, 0))
        srcs.append(src_k)
        recs.append(_sel_along(rec, sl))
    lens_m = jnp.stack(lens, 1)
    pick = jnp.argmax(lens_m, axis=1)  # tie -> more recent (earlier col)
    length = _sel_along(lens_m, pick)
    src = _sel_along(jnp.stack(srcs, 1), pick)
    sym_idx = _sel_along(jnp.stack(recs, 1), pick)
    if not probe_only:
        # phase 2: full-window extension of the winner only
        wlen = p.window
        cand = _gather_windows(inp_w32, src, wlen)
        full = _prefix_len(cur_win[:, :wlen], cand)
        length = jnp.where(length >= p.probe, full, length)
    if p.short_depth and not x_keyed and not probe_only:
        # secondary short-match fallback: when the 3/4-byte-context bucket
        # offers no match, the per-previous-byte table may (rolzmain/
        # cr-matcher.c:163-179); its rank codes as idx rolz_depth..+D-1
        ctx4q = c["ctx4"] if ctx4_override is None else ctx4_override
        s_pos, s_nx4 = _short_read(
            c["rolz_s"], p.short_depth, (ctx4q & 0xFF).astype(_i32)
        )
        sdiff = s_nx4 ^ own_nx4[:, None]
        sscore = (
            ((sdiff & 0xFF) == 0).astype(_i32)
            + ((sdiff & 0xFFFF) == 0).astype(_i32)
            + ((sdiff & 0xFFFFFF) == 0).astype(_i32)
            + (sdiff == 0).astype(_i32)
        )
        srec = _recency_ranks(s_pos)
        sscore = jnp.where(s_pos > 0, sscore, -1)
        _, stop = jax.lax.top_k(
            sscore * p.short_depth + (p.short_depth - 1 - srec), 2
        )
        lens_s, srcs_s, recs_s = [], [], []
        for k in range(2):
            sl = stop[:, k]
            src_k = _sel_along(s_pos, sl) - 1
            sc_k = _sel_along(sscore, sl)
            cand = _gather_windows(inp_w32, src_k, p.probe)
            len_k = _prefix_len(cur_win[:, : p.probe], cand)
            lens_s.append(jnp.where(sc_k == 4, len_k, 0))
            srcs_s.append(src_k)
            recs_s.append(_sel_along(srec, sl))
        lens_m = jnp.stack(lens_s, 1)
        pick_s = jnp.argmax(lens_m, axis=1)
        s_len = _sel_along(lens_m, pick_s)
        s_src = _sel_along(jnp.stack(srcs_s, 1), pick_s)
        s_rec = _sel_along(jnp.stack(recs_s, 1), pick_s)
        cand = _gather_windows(inp_w32, s_src, p.window)
        s_full = _prefix_len(cur_win[:, : p.window], cand)
        s_len = jnp.where(s_len >= p.probe, s_full, s_len)
        # acceptance threshold above min_len (encoder policy, sweepable):
        # short-idx symbols are rarer and price higher than main ranks, so
        # a bare min_len short match does not pay for itself
        use_short = (length < p.min_len) & (
            s_len >= p.min_len + _SHORT_EXTRA
        )
        length = jnp.where(use_short, s_len, length)
        src = jnp.where(use_short, s_src, src)
        sym_idx = jnp.where(use_short, p.rolz_depth + s_rec, sym_idx)
    cap = jnp.minimum(
        jnp.minimum(p.steps - t, n - pos),
        min(p.window, p.min_len + ppm.LEN_W - 1),
    )
    return jnp.minimum(length, cap), src, sym_idx, fill


def _match_window_len(inp_w32, pos, src, t, n, p: BlockParams,
                      cur_win=None):
    """Encoder-side single-candidate match length (LZP path)."""
    cand = _gather_windows(inp_w32, src, p.window)
    length = _prefix_len(cur_win[:, : p.window], cand)
    cap = jnp.minimum(
        jnp.minimum(p.steps - t, n - pos),
        min(p.window, p.min_len + ppm.LEN_W - 1),
    )
    return jnp.minimum(length, cap)


# --------------------------------------------------------------------------
# Distance-mantissa top-bits model (mode 'X', format rev 4): the top 4
# mantissa bits of a distance are far from uniform (distances cluster),
# and the reference codes whole distances through adaptive digit models
# (roxmain/cr-coder.c:242-258).  For buckets k in [5, 16] the D event
# codes the top 4 bits through a [16, 16] adaptive table whose reads AND
# updates are exact one-hot matmuls — no random access; the E event
# carries the remaining k-4 uniform bits.  k <= 4 and k > 16 keep the
# pure-uniform hi/lo split.
# --------------------------------------------------------------------------


def _mant_read(tbs, mctx):
    oh = (
        jax.lax.broadcasted_iota(_i32, (mctx.shape[0], 16), 1)
        == mctx[:, None]
    )
    rows = _exact_onehot_matmul(oh, tbs["mant"])
    cums = tb.exclusive_cumsum(rows)
    tot = jnp.sum(rows, axis=1)
    return oh, rows, cums, tot


def _mant_update(tbs, oh_ctx, sym, act):
    """Shared (encode == decode) mant update: additive counts, so same-
    step collisions sum deterministically; halve rows past the cap."""
    s = sym.shape[0]
    upd = (
        (jax.lax.broadcasted_iota(_i32, (s, 16), 1) == sym[:, None])
        & act[:, None]
    ).astype(_i32) * ppm.MANT_INC
    tab = tbs["mant"] + _exact_onehot_matmul(oh_ctx.T, upd)
    tot = jnp.sum(tab, axis=1, keepdims=True)
    tab = jnp.where(tot > ppm.MANT_CAP, (tab + 1) >> 1, tab)
    return {**tbs, "mant": tab}


def _mant_events_enc(tbs, dist, k_dist, has_extra):
    """Encode-side D/E events + the mant table update."""
    e = dist - jnp.left_shift(jnp.ones_like(dist), k_dist)
    adaptive = has_extra & (k_dist >= 5) & (k_dist <= 16)
    top4 = (e >> jnp.maximum(k_dist - 4, 0)) & 15
    mctx = jnp.clip(k_dist - 5, 0, 11)
    oh, rows, cums, tot = _mant_read(tbs, mctx)
    cm_raw, fm_raw = tb.cum_frq_of(rows, cums, top4)
    cm, fm = rans.norm_cf(
        cm_raw, jnp.maximum(fm_raw, 1), jnp.maximum(tot, 1)
    )
    b_hi = jnp.where(k_dist > 16, k_dist - 12, 0)
    b_lo_u = jnp.minimum(k_dist, 12)
    e_hi_u = (e >> b_lo_u).astype(_u32)
    fd_u = jnp.left_shift(jnp.uint32(1), (15 - b_hi).astype(_u32))
    act_d = has_extra & (adaptive | (b_hi > 0))
    cd = jnp.where(adaptive, cm.astype(_u32), e_hi_u * fd_u)
    fd = jnp.where(adaptive, fm.astype(_u32), fd_u)
    cd, fd = rans.select_cf(act_d, cd, fd)
    b_e = jnp.where(adaptive, k_dist - 4, b_lo_u)
    e_lo = (e & (jnp.left_shift(jnp.ones_like(e), b_e) - 1)).astype(_u32)
    act_e = has_extra & (b_e > 0)
    fe = jnp.left_shift(jnp.uint32(1), (15 - b_e).astype(_u32))
    ce, fe = rans.select_cf(act_e, e_lo * fe, fe)
    tbs = _mant_update(tbs, oh, top4, adaptive)
    return (
        cd.astype(jnp.uint16), fd.astype(jnp.uint16), act_d,
        ce.astype(jnp.uint16), fe.astype(jnp.uint16), act_e, tbs,
    )


def _dist_extra_events(dist, k_dist, has_extra):
    """Uniform rANS events carrying a distance's mantissa bits: e_hi (up to
    12 bits) and e_lo (up to 12 bits); dist = 2^k + (e_hi << b_lo) + e_lo.
    A uniform b-bit value v codes as the normalized pair
    (v << (15-b), 1 << (15-b)) — exactly b bits, no model."""
    e = dist - jnp.left_shift(jnp.ones_like(dist), k_dist)
    b_lo = jnp.minimum(k_dist, 12)
    b_hi = k_dist - b_lo
    e_hi = (e >> b_lo).astype(_u32)
    e_lo = (e & (jnp.left_shift(jnp.ones_like(dist), b_lo) - 1)).astype(_u32)
    act_d = has_extra & (b_hi > 0)
    act_e = has_extra & (b_lo > 0)
    fd = jnp.left_shift(jnp.uint32(1), (15 - b_hi).astype(_u32))
    fe = jnp.left_shift(jnp.uint32(1), (15 - b_lo).astype(_u32))
    cd = e_hi * fd
    ce = e_lo * fe
    cd, fd = rans.select_cf(act_d, cd, fd)
    ce, fe = rans.select_cf(act_e, ce, fe)
    return (
        cd.astype(jnp.uint16),
        fd.astype(jnp.uint16),
        act_d,
        ce.astype(jnp.uint16),
        fe.astype(jnp.uint16),
        act_e,
    )


# --------------------------------------------------------------------------
# Mode-'R' sort-assisted search: proposals from the ctx-keyed sort family
# (positions that followed the same preceding context — the bucket's own
# membership rule), then a LIGHT rank-replay scan that checks each
# proposal against the real evolving bucket and reads off its recency
# rank.  This removes the per-step probe + winner-extension window
# gathers (the measured encode dominator, PERF.md r2 ledger) — the scan
# keeps only the one bucket gather the decoder pays anyway plus the
# insert scatter.  Proposals not in the bucket (evicted, decimated,
# hash-collided) are dropped; lengths come from the vectorized extension.
# --------------------------------------------------------------------------

_R_FINDER = _os.environ.get("CPX_R_FINDER", "sort")
_R_CANDS = int(_os.environ.get("CPX_R_CANDS", "4"))
# chain probe depth (encoder-only; 2 gathered words per entry).  8MiB
# sweep: probe 8/16/24/32 = 0.4124/0.4111/0.4104/0.4100 bpb at CPU enc
# +17%/+~40%/+~60% — 16 is the knee; cands 6/8 and depth80 measured flat
# (PERF.md round-3 ledger)
_R_PROBE = int(_os.environ.get("CPX_R_PROBE", "16"))


def _rolz_rank_body(p: BlockParams, inp_pad, inp_w32, n, n_c, c, xs):
    t = xs[0]
    lanes = _lane_ids(p.lanes)
    pos = lanes * p.steps + t
    active = pos < n
    cur_win = jax.lax.dynamic_slice(
        inp_pad, (0, t), (p.lanes, p.window + 1)
    ).astype(_i32)
    byte = cur_win[:, 0]
    rctx = _rolz_ctx(c, p)
    ent = c["rolz_ent"][rctx]  # [S, D, 2]
    rec = _recency_ranks(ent[..., 0])
    fill = jnp.sum((ent[..., 0] > 0).astype(_i32), axis=1)
    outs = []
    for k in range(n_c):
        l_k, s_k = xs[1 + 2 * k], xs[2 + 2 * k]
        present = ent[..., 0] == (s_k + 1)[:, None]
        in_b = jnp.any(present, axis=1)
        rank = jnp.sum(jnp.where(present, rec, 0), axis=1)
        valid = in_b & active & (t >= 7) & (l_k > 0)
        outs += [jnp.where(valid, l_k, 0), s_k, rank]
    # one cache-scored bucket candidate (the legacy search's phase 1 with
    # top_k=1): recovers entries the sort proposals cannot name — bucket-
    # hash collisions and deep-recency survivors — for ONE window gather
    # per step instead of the legacy's five
    nx = cur_win[:, :4].astype(_u32)
    own_nx4 = nx[:, 0] | (nx[:, 1] << 8) | (nx[:, 2] << 16) | (nx[:, 3] << 24)
    diff = ent[..., 1].astype(_u32) ^ own_nx4[:, None]
    score = (
        ((diff & 0xFF) == 0).astype(_i32)
        + ((diff & 0xFFFF) == 0).astype(_i32)
        + ((diff & 0xFFFFFF) == 0).astype(_i32)
        + (diff == 0).astype(_i32)
    )
    score = jnp.where(ent[..., 0] > 0, score, -1)
    rank_key = score * p.rolz_depth + (p.rolz_depth - 1 - rec)
    slot = jnp.argmax(rank_key, axis=1)
    src_b = _sel_along(ent[..., 0], slot) - 1
    sc_b = _sel_along(score, slot)
    cand_w = _gather_windows(inp_w32, jnp.maximum(src_b, 0), p.window)
    len_b = _prefix_len(cur_win[:, : p.window], cand_w)
    cap = jnp.minimum(
        jnp.minimum(p.steps - t, n - pos),
        min(p.window, p.min_len + ppm.LEN_W - 1),
    )
    if p.chain_match:
        # sources in the previous block (src < N) are always decode-
        # causal, but a match must not extend past the window boundary:
        # bytes at [N, ...) belong to positions not yet decoded at
        # arbitrary steps
        cap = jnp.minimum(
            cap, jnp.where(src_b < p.capacity, p.capacity - src_b, cap)
        )
    valid_b = (sc_b == 4) & active & (t >= 7)
    outs += [
        jnp.where(valid_b, jnp.minimum(len_b, jnp.maximum(cap, 0)), 0),
        src_b,
        _sel_along(rec, slot),
    ]
    zero = jnp.zeros((p.lanes,), _i32)
    c = _post_step(
        c, t, n, p, pos, active, byte, jnp.zeros((p.lanes,), bool),
        zero, zero, enc_side=False,
    )
    return c, tuple(outs) + (fill,)


def _remap_chain_ment(p: BlockParams, ment):
    """Shift a carried bucket table one block back in the window:
    positions q -> max(q - N, 0).  Entries from the block just coded land
    in the prev region [1, N]; anything older dies (0 = empty, prefix
    cleared).  Both sides replay this at every chained block boundary."""
    pos = jnp.maximum(ment[..., 0] - p.capacity, 0)
    pref = jnp.where(pos > 0, ment[..., 1], 0)
    return jnp.stack([pos, pref], axis=-1)


def _rolz_rank_scan(p: BlockParams, inp_pad, inp_w32, n, props, ment0=None):
    """props: [(len [N], src [N])] -> (flat candidate triples [T, S]
    l/s/idx each — the props, membership-checked, plus one cache-scored
    bucket candidate — and fill [T, S])."""
    carry = _init_carry(p, enc_side=True, search=True)
    if ment0 is not None:
        carry["rolz_ent"] = _remap_chain_ment(p, ment0)

    def grid(v):
        return v.reshape(p.lanes, p.steps).T

    xs = (jnp.arange(p.steps, dtype=_i32),) + tuple(
        g for l, s in props for g in (grid(l), grid(s))
    )
    body = functools.partial(
        _rolz_rank_body, p, inp_pad, inp_w32, n, len(props)
    )
    _, outs = jax.lax.scan(body, carry, xs)
    return outs[:-1], outs[-1]


# --------------------------------------------------------------------------
# Encode pass 0: match-search scan + parse pass (modes 'R' and 'X')
#
# The reference searches and codes in one sequential loop, with flexible
# parsing as a match-result cache + 2-segment price lookahead
# (roxmain/cr-matcher.c:240-293).  Lock-step lanes allow a cleaner split:
# pass 0 finds every position's best candidates (the match tables evolve
# by position, never by parse decisions, so candidates computed up front
# stay valid); a backward cost scan then solves the whole parse as a DP —
# literal vs ANY admissible truncation of the candidate, priced like the
# reference's M_price.  The modeling pass just executes decisions.  Pure
# encoder policy: the format codes whatever (len, idx/dist) was chosen.
# --------------------------------------------------------------------------

# parse prices in fifths of a bit (encoder policy, CPX_* sweepable):
#   literal ~ its typical PPM cost; match = flag+len+idx/dist-bucket cost,
#   plus per-recency/per-dist-bucket growth (the analogue of the
#   reference's fast_log2(dist)*4/5 price term, cr-matcher.c:268-270)
_P_LIT_R = int(_os.environ.get("CPX_PARSE_LIT_R", "14"))
_P_RM = int(_os.environ.get("CPX_PARSE_RM", "50"))
_P_RI = int(_os.environ.get("CPX_PARSE_RI", "6"))  # per idx recency bucket
_P_LIT_X = int(_os.environ.get("CPX_PARSE_LIT_X", "10"))
_P_XM = int(_os.environ.get("CPX_PARSE_XM", "65"))
_P_XK = int(_os.environ.get("CPX_PARSE_XK", "6"))  # per distance bucket
# (post-dual-table sweep, 2MiB doc: 65/6 = 1.6871 bpb, 55/5 = 1.6898,
#  75/6 = 1.6885, 45/5 = 1.6956, x/3 >= 1.7076 — shallow optimum at 65/6)
_P_XREP = int(_os.environ.get("CPX_PARSE_XREP", "45"))  # repeat-distance
# match: no mantissa bits, one hot SYM_DST_REPEAT symbol (the analogue of
# the reference's last_match preference, cr-matcher.c:246-249,314-317)
# Cost-to-go ceiling for the flexible-parse DP.  Upper bound: the
# *256 key packing in _cand_min_cost needs _P_INF*256 < 2^31, so
# _P_INF <= 2^23.  2^22 keeps exact pricing to ~300k all-literal steps
# (128 MiB blocks at S=512); beyond that costs saturate — the DP loses
# pricing fidelity near the block head but never validity (see
# _cand_min_cost).  Encoder policy only, not format.
_P_INF = 1 << 22


def x_hash6(win):
    """6-byte content hash for the short-match cache ([S, >=6] byte window
    -> [S] bucket; shape of roxmain's short_hash, cr-matcher.c:206-214)."""
    h = jnp.zeros((win.shape[0],), _u32)
    for j in range(6):
        h = h * _u32(123456791) ^ win[:, j].astype(_u32)
    return ((h ^ (h >> 15)) & _u32(0xFFFF)).astype(_i32)


def _search_body(p: BlockParams, inp_pad, inp_w32, n, c, t):
    """One search step: candidates for every lane's position, then the
    shared position-driven table evolution (identical to the modeling
    pass's, so pass-0 candidate indices stay valid there and at decode)."""
    lanes = _lane_ids(p.lanes)
    pos = lanes * p.steps + t
    active = pos < n
    cur_win = jax.lax.dynamic_slice(
        inp_pad, (0, t), (p.lanes, p.window + 1)
    ).astype(_i32)
    byte = cur_win[:, 0]
    zero = jnp.zeros((p.lanes,), _i32)
    if p.mode == "R":
        length, src, sym_idx, fill = _rolz_best_match(
            c, pos, t, n, p, inp_w32, cur_win
        )
        length = jnp.where(active & (t >= 7), length, 0)
        out = (length, src, sym_idx, fill)
    else:  # 'X'
        length, src, _, _ = _rolz_best_match(
            c, pos, t, n, p, inp_w32, cur_win, x_keyed=True
        )
        ok = (src >= 0) & (src < pos) & active & (t >= 7)
        length = jnp.where(ok, length, 0)
        # context-keyed candidate (the 'R' search over the encoder-private
        # second table; see _init_carry) — coded as a plain distance
        len3, src3, _, _ = _rolz_best_match(
            c, pos, t, n, p, inp_w32, cur_win, table="xctx_ent"
        )
        ok3 = (src3 >= 0) & (src3 < pos) & active & (t >= 7)
        len3 = jnp.where(ok3, len3, 0)
        # short-hash near-match candidate (cr-matcher.c:319-331): one
        # 65536-entry cache keyed by the next 6 bytes; byte-verified by
        # prefix extension, so hash collisions just yield length 0
        h6 = x_hash6(cur_win)
        cand = c["xshort"][h6] - 1
        ok2 = (cand >= 0) & (cand < pos) & active & (t >= 7)
        win2 = _gather_windows(inp_w32, jnp.maximum(cand, 0), p.window)
        len2 = _prefix_len(cur_win[:, : p.window], win2)
        cap = jnp.minimum(
            jnp.minimum(p.steps - t, n - pos),
            min(p.window, p.min_len + ppm.LEN_W - 1),
        )
        len2 = jnp.minimum(jnp.where(ok2, len2, 0), cap)
        c = dict(c)
        c["xshort"] = (
            c["xshort"]
            .at[jnp.where(active, h6, 1 << 16)]
            .max(pos + 1, mode="drop")
        )
        out = (length, src, len2, cand, len3, src3)
    c = _post_step(
        c, t, n, p, pos, active, byte,
        jnp.zeros((p.lanes,), bool), zero, zero, enc_side=True,
    )
    return c, out


def _cand_min_cost(p: BlockParams, cw, length, price):
    """min over l in [min_len, length] of price + cost[t+l], with the
    achieving l.  ``cw[:, j]`` holds cost[t+1+j]; ties prefer the longest
    l (same cost, fewer coded symbols).  Returns (cost, l)."""
    w = cw.shape[1]
    offs = jax.lax.broadcasted_iota(_i32, cw.shape, 1)  # l = offs+1
    mask = (offs + 1 >= p.min_len) & (offs + 1 <= length[:, None])
    # Saturate real costs below _P_INF BEFORE the *256 key packing: on
    # long low-match blocks the cost-to-go grows ~lit/step and can exceed
    # _P_INF (~74,900 literal steps at _P_LIT_R=14), at which point the
    # masked no-candidate key (_P_INF*256) would look CHEAPER than real
    # costs and the DP would emit bogus matches with zero admissible
    # candidates — silently corrupt archives (crz -b32 on incompressible
    # data; advisor repro, round 2).  With saturation, real candidates
    # always key < _P_INF*256 and the no-candidate case keys exactly
    # _P_INF*256 -> cost_m == _P_INF, rejected in _parse_body.
    cost = jnp.minimum(cw + price[:, None], _P_INF - 1)
    key = jnp.where(mask, cost * 256 + (255 - offs), _P_INF * 256)
    best = jnp.min(key, axis=1)
    l = 256 - (best % 256)
    return best // 256, l


def _parse_body(p: BlockParams, n, cw, xs, n_c: int = 3, prices=None):
    """One backward-DP step: cost[t] and the decision at t.

    'R' xs is (t, l_1, s_1, idx_1, ..., l_{n_c}, s_{n_c}, idx_{n_c}) —
    candidate triples with their bucket recency index.  'X' xs is
    (t, l_1, s_1, ..., l_{n_c}, s_{n_c}[, lrep, prev]) — the trailing
    pair (rep-extend length + expected prev distance) rides only on the
    rep-aware second parse iteration.  ``prices`` overrides the
    (lit, match, per-dist-bucket, repeat) constants — the static-table
    fast profile prices literals ~3x higher than the adaptive PPM does
    (measured: X prices cost it 0.27 bpb)."""
    lanes = _lane_ids(p.lanes)
    zero = jnp.zeros((p.lanes,), _i32)
    if p.mode == "R":
        t = xs[0]
        cands = []
        for i in range(n_c):
            lx, sx, ix = xs[1 + 3 * i : 4 + 3 * i]
            price = _P_RM + _P_RI * _rec_bucket(ix)
            cands.append((lx, sx, ix, price))
        lit = _P_LIT_R
    else:
        lit, p_m, p_k, p_rep = prices or (_P_LIT_X, _P_XM, _P_XK, _P_XREP)
        t = xs[0]
        pos = lanes * p.steps + t
        has_rep = len(xs) > 1 + 2 * n_c
        prev = xs[-1] if has_rep else None
        cands = []
        for i in range(n_c):
            lx, sx = xs[1 + 2 * i], xs[2 + 2 * i]
            d = jnp.maximum(pos - sx, 1)
            price = p_m + p_k * _dist_bucket(d)
            if has_rep:
                # normal candidates that happen to sit at the expected
                # repeat distance also get the cheap price
                price = jnp.where(d == prev, p_rep, price)
            cands.append((lx, sx, zero, price))
        if has_rep:
            lrep = xs[-2]
            cands.append(
                (lrep, pos - prev, zero, jnp.full_like(prev, p_rep))
            )
    pos = lanes * p.steps + t
    active = pos < n
    cost_lit = lit + cw[:, 0]
    best_cost, best_len = cost_lit, jnp.zeros_like(cost_lit)
    best_src, best_idx = jnp.zeros_like(cost_lit), jnp.zeros_like(cost_lit)
    for lx, sx, ix, px in cands:
        cost_m, l_m = _cand_min_cost(p, cw, lx, px)
        # tie -> match (fewer coded symbols); cost_m == _P_INF means NO
        # admissible candidate and must never win even when the saturated
        # literal cost reaches it (see _cand_min_cost)
        better = (cost_m <= best_cost) & (cost_m < _P_INF)
        best_len = jnp.where(better, l_m, best_len)
        best_src = jnp.where(better, sx, best_src)
        best_idx = jnp.where(better, ix, best_idx)
        best_cost = jnp.minimum(best_cost, cost_m)
    # saturate stored cost-to-go so cw entries stay below _P_INF at any
    # block length (the DP loses exact pricing past the cap, never validity)
    best_cost = jnp.minimum(best_cost, _P_INF - 1)
    best_cost = jnp.where(active, best_cost, 0)
    best_len = jnp.where(active, best_len, 0)
    cw = jnp.concatenate([best_cost[:, None], cw[:, :-1]], axis=1)
    return cw, (best_len, best_src, best_idx)


def _greedy_decisions(p: BlockParams, n, outs):
    """Greedy accept-longest with a one-step lazy check — the reference's
    default parse (lazy branch of cr-matcher.c:296-311), elementwise over
    the whole [T, S] candidate grid."""
    if p.mode == "R":
        l1, s1 = outs[0], outs[1]
    else:
        # longest candidate wins; ties prefer earlier sources (which are
        # ordered nearest-first, so cheaper distances)
        l1, s1 = outs[0], outs[1]
        for i in range(1, len(outs) // 2):
            lx, sx = outs[2 * i], outs[2 * i + 1]
            use = lx > l1
            l1 = jnp.where(use, lx, l1)
            s1 = jnp.where(use, sx, s1)
    len_next = jnp.concatenate([l1[1:], jnp.zeros_like(l1[:1])], axis=0)
    if p.mode == "X":
        ts = jnp.arange(l1.shape[0], dtype=_i32)[:, None]
        pos = _lane_ids(p.lanes)[None, :] * p.steps + ts
        k = _dist_bucket(jnp.maximum(pos - s1, 1))
        accept = jnp.maximum(p.min_len, 2 + (3 * k) // 4)
    else:
        accept = p.min_len
    do = (l1 >= accept) & (len_next <= l1 + 1)
    return jnp.where(do, l1, 0), s1


def _sim_prev_dist(p: BlockParams, ts, take, src):
    """Forward-replay the parse decisions to the per-position prev_dist
    each lane would hold at coding time (the modeling pass's execution
    rule: decisions inside a running copy are skipped)."""

    def body(carry, xs):
        rem, prev = carry
        t, tk, sr = xs
        pos = _lane_ids(p.lanes) * p.steps + t
        start = (rem == 0) & (tk > 0)
        dist = jnp.maximum(pos - sr, 1)
        new_prev = jnp.where(start, dist, prev)
        new_rem = jnp.where(
            rem > 0, rem - 1, jnp.where(start, tk - 1, 0)
        )
        return (new_rem, new_prev), prev  # prev BEFORE this position

    init = (jnp.zeros((p.lanes,), _i32), jnp.ones((p.lanes,), _i32))
    _, prev_arr = jax.lax.scan(body, init, (ts, take, src))
    return prev_arr  # [T, S]


def _rep_lengths(p: BlockParams, inp_flat, n, ts, prev_arr):
    """Repeat-distance match length at every position: forward run length
    of byte equality vs the position prev_arr back, restricted to runs
    with a constant expected prev (one flat gather + a backward scan)."""
    pos_all = _lane_ids(p.lanes)[None, :] * p.steps + ts[:, None]  # [T,S]
    cur = inp_flat[jnp.clip(pos_all, 0, inp_flat.shape[0] - 1)]
    src_rep = pos_all - prev_arr
    back = inp_flat[jnp.clip(src_rep, 0, inp_flat.shape[0] - 1)]
    # decode causality: lanes decode in lock-step, so src must sit at a
    # strictly earlier step (src % T < t; with the length cap <= T - t the
    # copy then never outruns the producer).  Bucket candidates satisfy
    # this by construction; the rep candidate must be masked explicitly —
    # prev can exceed t, placing src in a previous lane's region at a
    # LATER step (found by /verify's CLI round trip at 64x512).
    causal = (src_rep % p.steps) < ts[:, None]
    eq = (cur == back) & (src_rep >= 0) & causal & (pos_all < n)

    def body(carry, xs):
        rl_next, prev_next = carry
        eq_t, prev_t = xs
        cont = prev_next == prev_t
        rl = jnp.where(eq_t, 1 + jnp.where(cont, rl_next, 0), 0)
        return (rl, prev_t), rl

    init = (jnp.zeros((p.lanes,), _i32), jnp.ones((p.lanes,), _i32))
    _, len_rep = jax.lax.scan(body, init, (eq, prev_arr), reverse=True)
    cap = jnp.minimum(
        jnp.minimum(p.steps - ts[:, None], n - pos_all),
        min(p.window, p.min_len + ppm.LEN_W - 1),
    )
    return jnp.minimum(len_rep, jnp.maximum(cap, 0))


def _search_and_parse(p: BlockParams, inp_pad, inp_flat, inp_w32, n,
                      ment0=None):
    """Passes 0 (search) and 0.5 (parse) -> per-step decision arrays fed
    to the modeling scan as scan inputs.  'X' runs a second, rep-aware
    parse iteration: simulate prev_dist under the first parse, measure
    repeat-distance runs, and re-parse with the cheap rep candidate (the
    reference's last_match-first lookup, cr-matcher.c:246-249, expressed
    as a fixed-point-ish second DP pass)."""
    ts = jnp.arange(p.steps, dtype=_i32)
    r_sort = (
        p.mode == "R"
        and _R_FINDER == "sort"
        and p.flexible
        and p.short_depth == 0
    )
    if p.chain_match and not r_sort:
        raise ValueError(
            "chain_match supports only the sort finder "
            "(CPX_R_FINDER=sort) with flexible parse"
        )
    if r_sort:
        def grid(v):
            return v.reshape(p.lanes, p.steps).T

        props = sort_candidates(
            p, inp_flat, n, n_cands=_R_CANDS, probe_from=_R_PROBE,
            ctx_bytes=p.rolz_ctx_bytes, insert_dec=p.rolz_dec,
            fwd_chain=_R_PROBE,
        )
        if p.chain_match:
            # sort proposals are block-local; bucket entries are window-
            # absolute under chain_match (membership compares positions)
            props = [(l, s + p.capacity) for l, s in props]
        outs, fill = _rolz_rank_scan(p, inp_pad, inp_w32, n, props, ment0)
        cw0 = jnp.zeros((p.lanes, p.window), _i32)
        parse = functools.partial(_parse_body, p, n, n_c=len(outs) // 3)
        _, (take, src, idx) = jax.lax.scan(
            parse, cw0, (ts,) + tuple(outs), reverse=True
        )
        return ts, take, src, idx, fill
    if p.mode == "X" and _X_FINDER == "sort":
        # whole-block sort-based candidates (no search scan): strictly
        # wider coverage than the recency-64 bucket walk — every causal
        # previous 6-gram occurrence is a chain entry.  Two families:
        # content-keyed (nearest 3 same-6-gram occurrences) + context-
        # keyed (nearest 2 "what followed these ctx bytes" occurrences,
        # the productive source on dict-coded text)
        def grid(v):
            return v.reshape(p.lanes, p.steps).T

        import os as _os2

        n_cands = int(_os2.environ.get("CPX_X_CANDS", "3"))
        probe_from = int(_os2.environ.get("CPX_X_PROBE", "16"))
        cands = sort_candidates(
            p, inp_flat, n, n_cands=n_cands, probe_from=probe_from
        )
        if _os2.environ.get("CPX_X_CTXCAND", "0") == "1":
            # measured neutral on dict-coded text (1.4296 vs 1.429 bpb):
            # any ctx-keyed hit with length >= min_len has a matching
            # 6-gram, so the content family already saw it unless all 3
            # nearest occurrences were non-causal.  Kept for sweeps.
            cands += sort_candidates(
                p, inp_flat, n, n_cands=2, ctx_bytes=p.rolz_ctx_bytes
            )
        outs = tuple(
            g for l, s in cands for g in (grid(l), grid(s))
        )
    else:
        carry = _init_carry(p, enc_side=True, search=True)
        body = functools.partial(_search_body, p, inp_pad, inp_w32, n)
        _, outs = jax.lax.scan(
            body, carry, jnp.arange(p.steps, dtype=_i32)
        )
    if p.flexible:
        xs = (
            (ts, outs[0], outs[1], outs[2])
            if p.mode == "R"
            else (ts,) + tuple(outs)
        )
        n_c = 1 if p.mode == "R" else len(outs) // 2
        cw0 = jnp.zeros((p.lanes, p.window), _i32)
        parse = functools.partial(_parse_body, p, n, n_c=n_c)
        _, (take, src, _idx) = jax.lax.scan(parse, cw0, xs, reverse=True)
        if p.mode == "R":
            src = outs[1]  # single candidate: src is the search's
        else:
            prev_arr = _sim_prev_dist(p, ts, take, src)
            len_rep = _rep_lengths(p, inp_flat, n, ts, prev_arr)
            xs2 = xs + (len_rep, prev_arr)
            _, (take, src, _idx) = jax.lax.scan(
                parse, cw0, xs2, reverse=True
            )
    else:
        take, src = _greedy_decisions(p, n, outs)
    if p.mode == "R":
        return ts, take, src, outs[2], outs[3]  # + sym_idx, fill
    return ts, take, src


# --------------------------------------------------------------------------
# Encode pass 1: forward modeling scan -> normalized (c, f) event grids
# --------------------------------------------------------------------------


def _sse_hitx_of(p: BlockParams, conf, p1, lzp_ok=None):
    """Rev-8 hit-only SSE wiring shared by both sides: (table key,
    n_ctx, context indices) for modes X and P, else None."""
    if p.mode == "X" and ppm.SSE_X:
        return ("sse_x", ppm.SSE_XCTX, ppm.sse_x_ctx_of(conf, p1))
    if p.mode == "P" and ppm.SSE_P and lzp_ok is not None:
        return ("sse_p", ppm.SSE_PCTX, ppm.sse_p_ctx_of(conf, lzp_ok, p1))
    return None


def _encode_model_body(p: BlockParams, inp_pad, inp_flat, inp_w32, n, c, xs):
    if p.match and p.mode == "R":
        t, dec_take, dec_src, dec_idx, dec_fill = xs
    elif p.match and p.mode == "X":
        t, dec_take, dec_src = xs
    else:
        t = xs
    (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
     pred2, conf2, o3raw) = _common_reads(c, t, n, p)
    valid2 = conf2 > 0
    # upcoming-bytes window: contiguous slice of the padded input (matches
    # never cross the chunk end, so per-lane windows need no gather)
    cur_win = jax.lax.dynamic_slice(
        inp_pad, (0, t), (p.lanes, p.window + 1)
    ).astype(_i32)
    byte = cur_win[:, 0]

    sym_idx = jnp.zeros((p.lanes,), _i32)
    dist = jnp.ones((p.lanes,), _i32)
    rolz_fill = jnp.zeros((p.lanes,), _i32)
    if p.match and p.mode == "X":
        # decisions precomputed by the search+parse passes (the bucket
        # table is search-pass-private: distances are coded explicitly)
        length = dec_take
        src = dec_src
        do_match = coding & (length > 0)
        dist = jnp.where(do_match, jnp.maximum(pos - src, 1), 1)
    elif p.match and p.mode == "R":
        # decisions precomputed by the search+parse passes; the bucket
        # evolution there is position-driven and identical to this pass's
        # (and the decoder's), so the coded index resolves to the same
        # source everywhere
        length = dec_take
        src = dec_src
        sym_idx = dec_idx
        rolz_fill = dec_fill
        do_match = coding & (length > 0)
    elif p.match:
        # LZP: causality note — an entry inserted at step s names a position
        # decoded at step s+1; a reader at step t gathers BEFORE this step's
        # column write, so the source must satisfy src % T < t (also rejects
        # self-matches); byte src+k is then decoded strictly before t+k.
        src, ok = _lzp_candidate(c, t, p, inp_flat)
        lzp_ok = ok  # decoder-known availability (SSE probe capture)
        valid = coding & ok
        length = _match_window_len(inp_w32, pos, src, t, n, p, cur_win)
        do_match = valid & (length >= p.min_len)
    else:
        src = jnp.zeros((p.lanes,), _i32)
        length = jnp.zeros((p.lanes,), _i32)
        do_match = jnp.zeros((p.lanes,), bool)

    # ---- A event (SSE: mode R's match-mass reshape keys on the bucket
    # fill, which the search pass computed identically to the decoder's
    # replay; the rev-8 hit-only reshapes key on conf x p1 (X) and
    # conf x candidate-availability x p1 (P), all decoder-known)
    sse_fill = (
        rolz_fill if (p.mode == "R" and p.match and ppm.SSE) else None
    )
    sse_hitx = _sse_hitx_of(p, conf, p1, lzp_ok if p.mode == "P" and p.match else None)
    tbs, rows2, rowmod, cums_a, tot_a, o2_hd, sse_st = ppm.read_o2(
        c["tables"], ctx2, pred, coding, conf, pred2, valid2,
        sse_fill=sse_fill, sse_hitx=sse_hitx,
    )
    f_byte = jnp.sum(
        jnp.where(
            jax.lax.broadcasted_iota(_i32, rowmod.shape, 1)
            == byte[:, None],
            rowmod,
            0,
        ),
        axis=-1,
    )
    sym_lit_or_esc = jnp.where(f_byte > 0, byte, ppm.SYM_ESC)
    if ppm.O3_2WAY == 1:
        sym_lit_or_esc = jnp.where(
            valid2 & (byte == pred2), ppm.SYM_HIT2, sym_lit_or_esc
        )
    sym_a = jnp.where(
        do_match,
        ppm.SYM_MATCH,
        jnp.where(byte == pred, ppm.SYM_HIT, sym_lit_or_esc),
    )
    ca_raw, fa_raw = tb.cum_frq_of(rowmod, cums_a, sym_a)
    ca, fa = rans.norm_cf(
        ca_raw, jnp.maximum(fa_raw, 1), jnp.maximum(tot_a, 1)
    )
    ca, fa = rans.select_cf(coding, ca, fa)

    is_esc = coding & (sym_a == ppm.SYM_ESC)
    is_match = coding & (sym_a == ppm.SYM_MATCH)

    # ---- B event: escaped literal (o1) or ROLZ bucket index
    tbs, rows1, wmod, cums1, tot1 = ppm.read_o1_excl(
        tbs, p1, rows2, pred, is_esc, pred2, valid2
    )
    c1_raw, f1_raw = tb.cum_frq_of(wmod, cums1, byte)
    sym_dst = jnp.zeros((p.lanes,), _i32)
    repeat = jnp.zeros((p.lanes,), bool)
    k_dist = jnp.zeros((p.lanes,), _i32)
    len_ctx = jnp.zeros((p.lanes,), _i32)
    idx_ctx = jnp.zeros((p.lanes,), _i32)
    if p.mode == "R":
        idx_ctx = _fill_bucket(rolz_fill)
        len_ctx = _rec_bucket(sym_idx)
        tbs, rows_i, cums_i, tot_i = ppm.read_idx(tbs, is_match, idx_ctx)
        ci_raw, fi_raw = tb.cum_frq_of(rows_i, cums_i, sym_idx)
        cb_raw = jnp.where(is_esc, c1_raw, ci_raw)
        fb_raw = jnp.where(is_esc, f1_raw, fi_raw)
        tot_b = jnp.where(is_esc, tot1, tot_i)
        act_b = is_esc | is_match
    elif p.mode == "X":
        k_dist = _dist_bucket(dist)
        len_ctx = jnp.clip(k_dist // 6, 0, 3)
        repeat = is_match & (dist == c["prev_dist"])
        sym_dst = jnp.where(repeat, SYM_DST_REPEAT, k_dist)
        tbs, rows_d, cums_d, tot_d = ppm.read_dst(tbs, is_match)
        cd_raw, fd_raw = tb.cum_frq_of(rows_d, cums_d, sym_dst)
        cb_raw = jnp.where(is_esc, c1_raw, cd_raw)
        fb_raw = jnp.where(is_esc, f1_raw, fd_raw)
        tot_b = jnp.where(is_esc, tot1, tot_d)
        act_b = is_esc | is_match
    else:
        cb_raw, fb_raw, tot_b = c1_raw, f1_raw, tot1
        act_b = is_esc
    cb, fb = rans.norm_cf(
        cb_raw, jnp.maximum(fb_raw, 1), jnp.maximum(tot_b, 1)
    )
    cb, fb = rans.select_cf(act_b, cb, fb)

    # ---- C event: match length
    sym_len = jnp.clip(length - p.min_len, 0, ppm.LEN_W - 1)
    tbs, rows_l, cums_l, tot_l = ppm.read_len(tbs, is_match, len_ctx)
    cl_raw, fl_raw = tb.cum_frq_of(rows_l, cums_l, sym_len)
    cc, fc = rans.norm_cf(
        cl_raw, jnp.maximum(fl_raw, 1), jnp.maximum(tot_l, 1)
    )
    cc, fc = rans.select_cf(is_match, cc, fc)

    # ---- model updates + state evolution
    tbs = ppm.apply_updates(
        tbs, coding, ctx2, sym_a, byte, f_byte, p1, h3, pred, conf,
        sym_len, sym_idx, sym_dst if p.mode == "X" else None,
        o2_halve_delta=o2_hd, len_ctx=len_ctx, idx_ctx=idx_ctx,
        o3_raw=o3raw, pred2=pred2, conf2=conf2,
    )
    if sse_st is not None:
        if sse_hitx is not None:
            tbs = ppm.sse_update_hit(
                tbs, sse_hitx[0], sse_hitx[1], sse_st, coding,
                coding & (sym_a == ppm.SYM_HIT),
            )
        else:
            tbs = ppm.sse_update(
                tbs, sse_st, coding, is_match,
                is_hit=coding & (sym_a == ppm.SYM_HIT),
            )
    extra = []
    if p.mode == "X":
        # D/E events read the step-start mant table (apply_updates never
        # touches it) and fold their own update into tbs
        cd, fd, act_d, ce, fe, act_e, tbs = _mant_events_enc(
            tbs, dist, k_dist, is_match & ~repeat
        )
        extra = [cd, fd, act_d, ce, fe, act_e]
    c = dict(c)
    c["tables"] = tbs
    c = _post_step(
        c, t, n, p, pos, active, byte, is_match, src, sym_len,
        enc_side=False, dist=dist,  # 'X' bucket inserts live in pass 0 now
    )
    out = [
        ca.astype(jnp.uint16),
        fa.astype(jnp.uint16),
        coding,
        cb.astype(jnp.uint16),
        fb.astype(jnp.uint16),
        act_b,
        cc.astype(jnp.uint16),
        fc.astype(jnp.uint16),
        is_match,
    ] + extra
    out += [
        sym_a.astype(jnp.int16),
        jnp.where(is_match, length, 0).astype(jnp.int16),
    ]
    if _DEBUG_EVT:
        # ratio-probe capture (CPX_DEBUG_EVT=1): per-step side-event
        # symbols + candidate contexts, consumed by offline numpy model
        # simulations (benchmarks/ctx_probe.py) — never by the format
        ctx_dbg = dist if p.mode == "X" else rolz_fill
        if p.mode == "P" and p.match:
            # LZP candidate availability — decoder-known (the decoder
            # computes the same _lzp_candidate gather), so a legal SSE key
            ctx_dbg = lzp_ok.astype(_i32)
        out += [
            (sym_dst if p.mode == "X" else sym_idx).astype(jnp.int16),
            ctx_dbg,
            p1.astype(jnp.int16),
        ]
        # A-distribution internals for the SSE probe
        # (benchmarks/sse_probe.py): the coding-time structural freqs +
        # total, the o3/o2 confidences, and match availability
        iota = jax.lax.broadcasted_iota(_i32, rowmod.shape, 1)

        def _f_of(s):
            return jnp.sum(jnp.where(iota == s, rowmod, 0), axis=-1)

        out += [
            _f_of(ppm.SYM_HIT),
            _f_of(ppm.SYM_HIT2),
            _f_of(ppm.SYM_ESC),
            _f_of(ppm.SYM_MATCH),
            tot_a,
            conf,
            conf2,
            do_match,
        ]
    return c, tuple(out)


@functools.partial(jax.jit, static_argnums=(0,))
def _encode_passes(p: BlockParams, inp, n, tables0=None, ment0=None,
                   prev=None):
    """Pass 1 (modeling) + pass 2 (backward rANS).  Returns device arrays:
    (states [S] u32, emit [T,n_slots,S] bool, words [T,n_slots,S] u16,
    debug, final PPM tables[, final match table under chain_match]).
    ``tables0`` overrides the fresh per-block PPM tables — the chain
    mode's model carry-over (the reference resets models once per FILE,
    src/main.c:174-206).  Under p.chain_match, ``ment0``/``prev`` carry
    the previous block's final bucket table and padded byte buffer: the
    search extends candidates over the [prev | cur] window (the
    reference's matcher window spans its whole 16 MiB split)."""
    inp_flat = inp.reshape(-1)
    if p.chain_match:
        prev_flat = (
            prev.reshape(-1)
            if prev is not None
            else jnp.zeros_like(inp_flat)
        )
        inp_w32 = _pack_words(jnp.concatenate([prev_flat, inp_flat]))
    else:
        inp_w32 = _pack_words(inp_flat)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    carry = _init_carry(p, enc_side=True)
    if tables0 is not None:
        carry["tables"] = tables0
    if p.chain_match:
        carry["rolz_ent"] = _remap_chain_ment(
            p,
            ment0
            if ment0 is not None
            else jnp.zeros((1 << p.rolz_bits, p.rolz_depth, 2), _i32),
        )
    body = functools.partial(
        _encode_model_body, p, inp_pad, inp_flat, inp_w32, n
    )
    if p.match and p.mode in ("R", "X"):
        xs = _search_and_parse(
            p, inp_pad, inp_flat, inp_w32, n,
            ment0=ment0 if p.chain_match else None,
        )
    else:
        xs = jnp.arange(p.steps, dtype=_i32)
    carry, ev = jax.lax.scan(body, carry, xs)
    n_slots = p.n_slots
    slot_grids = ev[: 3 * n_slots]

    def rans_body(x, e):
        # backward over slots (decode order is A, B, C[, D, E])
        emits, wordss = [], []
        for si in reversed(range(n_slots)):
            cx, fx, ax = e[3 * si], e[3 * si + 1], e[3 * si + 2]
            cv, fv = rans.select_cf(
                ax, cx.astype(_u32), jnp.maximum(fx, 1).astype(_u32)
            )
            x, em, wd = rans.enc_put(x, cv, fv)
            emits.append(em)
            wordss.append(wd)
        return x, (
            jnp.stack(emits[::-1]),
            jnp.stack(wordss[::-1]),
        )

    x = rans.init_states(p.lanes)
    x, (emit, words) = jax.lax.scan(
        rans_body, x, slot_grids, reverse=True
    )
    # bit-pack the emission mask on device (8x less device->host traffic)
    eb = emit.astype(jnp.uint8).reshape(p.steps, n_slots, p.lanes // 8, 8)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    emit_packed = jnp.sum(eb << shifts, axis=-1).astype(jnp.uint8)
    if p.chain_match:
        return x, emit_packed, words, ev, carry["tables"], carry["rolz_ent"]
    return x, emit_packed, words, ev, carry["tables"]


# --------------------------------------------------------------------------
# Decode: one forward scan fusing modeling + rANS + copy resolution
# --------------------------------------------------------------------------


def _decode_body(p: BlockParams, stream, n, carry, t):
    c, x, base, out = carry
    (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
     pred2, conf2, o3raw) = _common_reads(c, t, n, p)
    valid2 = conf2 > 0
    out_flat = out.reshape(-1)

    # ONE scalar-start slice per SLOT covers every word that slot can
    # consume (words are stream-contiguous in (step, slot, lane) order;
    # <= 1 word per lane per slot, so each slot's window is exactly S
    # wide); the per-lane reads resolve inside that window
    # (rans.stream_window_read).  Per-slot windows keep a one-hot read at
    # [S, S] instead of [S, n_slots*S] — its worst case, not the whole
    # step's.
    step_off = jnp.uint32(0)

    def advance(x, off, cx, fx):
        x_tmp, need = rans.dec_advance(x, cx, fx)
        win = jax.lax.dynamic_slice(
            stream, ((base + off).astype(_i32),), (p.lanes,)
        )
        w, used = rans.stream_window_read(win, need, jnp.uint32(0))
        return rans.dec_renorm(x_tmp, need, w), off + used

    # ---- A event.  Mode R pulls its bucket row (and fill) BEFORE the A
    # decode: the gather depends only on already-decoded context bytes,
    # and the SSE match-mass reshape needs the fill (the same gather
    # later serves the B event's idx context + source lookup).
    rolz_rows = None
    fill = None
    lzp_src = None
    lzp_ok = None
    if p.mode == "R" and p.match:
        rctx_r = _rolz_ctx(c, p)
        rolz_rows = c["rolz_ent"][rctx_r]
        fill = jnp.sum((rolz_rows[..., 0] > 0).astype(_i32), axis=1)
    elif p.mode == "P" and p.match:
        # hoisted from the byte-resolve below (bit-identical: the gather
        # reads only strictly-earlier bytes and tables update in
        # _post_step) — the rev-8 hit APM keys on the candidate
        # availability, which must be known BEFORE the A decode
        lzp_src, lzp_ok = _lzp_candidate(c, t, p, out_flat)
    tbs, rows2, rowmod, cums_a, tot_a, o2_hd, sse_st = ppm.read_o2(
        c["tables"], ctx2, pred, coding, conf, pred2, valid2,
        sse_fill=fill if ppm.SSE else None,
        sse_hitx=_sse_hitx_of(p, conf, p1, lzp_ok),
    )
    slot = rans.dec_slot(x)
    tgt = rans.dec_target(slot, jnp.maximum(tot_a, 1))
    sym_a, ca_raw, fa_raw = tb.find_symbol(rowmod, cums_a, tgt.astype(_i32))
    ca, fa = rans.norm_cf(
        ca_raw, jnp.maximum(fa_raw, 1), jnp.maximum(tot_a, 1)
    )
    ca, fa = rans.select_cf(coding, ca, fa)
    x, step_off = advance(x, step_off, ca, fa)

    is_hit = coding & (sym_a == ppm.SYM_HIT)
    is_hit2 = coding & (sym_a == ppm.SYM_HIT2)
    is_esc = coding & (sym_a == ppm.SYM_ESC)
    is_match = coding & (sym_a == ppm.SYM_MATCH)
    is_lit = coding & (sym_a < 256)

    # ---- B event: escaped literal or ROLZ index
    tbs, rows1, wmod, cums1, tot1 = ppm.read_o1_excl(
        tbs, p1, rows2, pred, is_esc, pred2, valid2
    )
    slot_b = rans.dec_slot(x)
    tgt1 = rans.dec_target(slot_b, jnp.maximum(tot1, 1))
    sym1, c1_raw, f1_raw = tb.find_symbol(wmod, cums1, tgt1.astype(_i32))
    sym_idx = jnp.zeros((p.lanes,), _i32)
    sym_dst = jnp.zeros((p.lanes,), _i32)
    len_ctx = jnp.zeros((p.lanes,), _i32)
    idx_ctx = jnp.zeros((p.lanes,), _i32)
    if p.mode == "R":
        if rolz_rows is None:  # match layer off: gather here as before
            rctx_r = _rolz_ctx(c, p)
            rolz_rows = c["rolz_ent"][rctx_r]
            fill = jnp.sum((rolz_rows[..., 0] > 0).astype(_i32), axis=1)
        idx_ctx = _fill_bucket(fill)
        tbs, rows_i, cums_i, tot_i = ppm.read_idx(tbs, is_match, idx_ctx)
        tgt_i = rans.dec_target(slot_b, jnp.maximum(tot_i, 1))
        sym_i, ci_raw, fi_raw = tb.find_symbol(
            rows_i, cums_i, tgt_i.astype(_i32)
        )
        sym_idx = sym_i
        len_ctx = _rec_bucket(sym_idx)
        cb_raw = jnp.where(is_esc, c1_raw, ci_raw)
        fb_raw = jnp.where(is_esc, f1_raw, fi_raw)
        tot_b = jnp.where(is_esc, tot1, tot_i)
        act_b = is_esc | is_match
    elif p.mode == "X":
        tbs, rows_d, cums_d, tot_d = ppm.read_dst(tbs, is_match)
        tgt_d = rans.dec_target(slot_b, jnp.maximum(tot_d, 1))
        sym_d, cd_raw, fd_raw = tb.find_symbol(
            rows_d, cums_d, tgt_d.astype(_i32)
        )
        sym_dst = sym_d
        cb_raw = jnp.where(is_esc, c1_raw, cd_raw)
        fb_raw = jnp.where(is_esc, f1_raw, fd_raw)
        tot_b = jnp.where(is_esc, tot1, tot_d)
        act_b = is_esc | is_match
    else:
        cb_raw, fb_raw, tot_b = c1_raw, f1_raw, tot1
        act_b = is_esc
    cb, fb = rans.norm_cf(
        cb_raw, jnp.maximum(fb_raw, 1), jnp.maximum(tot_b, 1)
    )
    cb, fb = rans.select_cf(act_b, cb, fb)
    x, step_off = advance(x, step_off, cb, fb)

    # ---- C event: match length
    if p.mode == "X":
        k_pre = jnp.clip(jnp.where(
            sym_dst == SYM_DST_REPEAT, _dist_bucket(c["prev_dist"]), sym_dst
        ), 0, 24)
        len_ctx = jnp.clip(k_pre // 6, 0, 3)
    tbs, rows_l, cums_l, tot_l = ppm.read_len(tbs, is_match, len_ctx)
    slot_c = rans.dec_slot(x)
    tgt_l = rans.dec_target(slot_c, jnp.maximum(tot_l, 1))
    sym_l, cl_raw, fl_raw = tb.find_symbol(rows_l, cums_l, tgt_l.astype(_i32))
    cc, fc = rans.norm_cf(
        cl_raw, jnp.maximum(fl_raw, 1), jnp.maximum(tot_l, 1)
    )
    cc, fc = rans.select_cf(is_match, cc, fc)
    x, step_off = advance(x, step_off, cc, fc)

    # ---- D/E events: distance mantissa (mode 'X'): adaptive top-4 bits
    # for buckets 5..16 (see _mant_events_enc), uniform otherwise
    dist = jnp.ones((p.lanes,), _i32)
    mant_upd = None
    if p.mode == "X":
        repeat = is_match & (sym_dst == SYM_DST_REPEAT)
        # clamp: garbage sym_dst on non-match lanes must not drive shift
        # amounts negative (div-by-zero on masked lanes)
        k_dist = jnp.clip(jnp.where(repeat, 0, sym_dst), 0, 24)
        has_extra = is_match & ~repeat
        adaptive = has_extra & (k_dist >= 5) & (k_dist <= 16)
        mctx = jnp.clip(k_dist - 5, 0, 11)
        oh_m, rows_m, cums_m, tot_m = _mant_read(tbs, mctx)
        slot_d = rans.dec_slot(x)
        tgt_m = rans.dec_target(slot_d, jnp.maximum(tot_m, 1))
        sym_m, cm_raw, fm_raw = tb.find_symbol(
            rows_m, cums_m, tgt_m.astype(_i32)
        )
        cm, fm = rans.norm_cf(
            cm_raw, jnp.maximum(fm_raw, 1), jnp.maximum(tot_m, 1)
        )
        b_hi = jnp.where(k_dist > 16, k_dist - 12, 0)
        b_lo = jnp.minimum(k_dist, 12)
        act_d = has_extra & (adaptive | (b_hi > 0))
        fd = jnp.left_shift(jnp.uint32(1), (15 - b_hi).astype(_u32))
        e_hi = jnp.where(
            has_extra & (b_hi > 0), slot_d // fd, 0
        ).astype(_i32)
        cdx = jnp.where(adaptive, cm.astype(_u32), e_hi.astype(_u32) * fd)
        fdx = jnp.where(adaptive, fm.astype(_u32), fd)
        cdx, fdx = rans.select_cf(act_d, cdx, fdx)
        x, step_off = advance(x, step_off, cdx, fdx)
        b_e = jnp.where(adaptive, k_dist - 4, b_lo)
        act_e = has_extra & (b_e > 0)
        fe = jnp.left_shift(jnp.uint32(1), (15 - b_e).astype(_u32))
        e_lo = jnp.where(act_e, rans.dec_slot(x) // fe, 0).astype(_i32)
        cex, fex = rans.select_cf(act_e, e_lo.astype(_u32) * fe, fe)
        x, step_off = advance(x, step_off, cex, fex)
        mant = jnp.where(
            adaptive,
            jnp.left_shift(sym_m, jnp.maximum(k_dist - 4, 0)) + e_lo,
            jnp.left_shift(e_hi, b_lo) + e_lo,
        )
        dist_dec = jnp.left_shift(jnp.ones_like(k_dist), k_dist) + mant
        dist = jnp.where(repeat, c["prev_dist"], dist_dec)
        mant_upd = (oh_m, jnp.where(adaptive, sym_m, 0), adaptive)

    # ---- resolve the byte
    if p.mode == "R":
        src = _rolz_src_of_rows(rolz_rows, sym_idx)
        if p.short_depth:
            # idx symbols >= rolz_depth name short-table ranks; the read is
            # an exact one-hot matmul, not a random-access op
            s_pos, _ = _short_read(c["rolz_s"], p.short_depth, p1)
            src_short = _src_of_pos_rows(s_pos, sym_idx - p.rolz_depth)
            src = jnp.where(sym_idx >= p.rolz_depth, src_short, src)
    elif p.mode == "X":
        src = pos - dist
    elif lzp_src is not None:
        src = lzp_src  # hoisted before the A event (rev-8 SSE context)
    else:
        src, _ok = _lzp_candidate(c, t, p, out_flat)
    gsrc = jnp.clip(
        jnp.where(is_match, src, c["copy_src"]), 0, out_flat.shape[0] - 1
    )
    copied = out_flat[gsrc].astype(_i32)
    byte = jnp.where(is_lit, sym_a, 0)
    byte = jnp.where(is_hit, pred, byte)
    byte = jnp.where(is_hit2, pred2, byte)
    byte = jnp.where(is_esc, sym1, byte)
    byte = jnp.where(is_match | copying, copied, byte)
    byte = jnp.clip(byte, 0, 255)
    f_byte = jnp.where(is_lit, fa_raw, 0)  # eliminator only needs lit lanes

    # ---- updates + state evolution
    tbs = ppm.apply_updates(
        tbs, coding, ctx2, sym_a, byte, f_byte, p1, h3, pred, conf,
        jnp.where(is_match, sym_l, 0), sym_idx,
        sym_dst if p.mode == "X" else None,
        o2_halve_delta=o2_hd, len_ctx=len_ctx, idx_ctx=idx_ctx,
        o3_raw=o3raw, pred2=pred2, conf2=conf2,
    )
    if mant_upd is not None:
        tbs = _mant_update(tbs, *mant_upd)
    if sse_st is not None:
        if p.mode in ("X", "P"):
            hx = _sse_hitx_of(p, conf, p1, lzp_ok)
            tbs = ppm.sse_update_hit(
                tbs, hx[0], hx[1], sse_st, coding, is_hit
            )
        else:
            tbs = ppm.sse_update(
                tbs, sse_st, coding, is_match, is_hit=is_hit
            )
    c = dict(c)
    c["tables"] = tbs
    c = _post_step(
        c, t, n, p, pos, active, byte, is_match, src,
        jnp.where(is_match, sym_l, 0), enc_side=False, dist=dist,
    )
    col = jnp.where(active, byte, 0).astype(jnp.uint8)
    if p.chain_match:
        # out is the [2, S, T] window buffer: region 0 = previous block
        # (read-only), region 1 = this block
        out = jax.lax.dynamic_update_slice(
            out, col[None, :, None], (1, 0, t)
        )
    else:
        out = jax.lax.dynamic_update_slice(out, col[:, None], (0, t))
    return (c, x, base + step_off, out), None


@functools.partial(jax.jit, static_argnums=(0,))
def _decode_scan(p: BlockParams, states, stream, n, tables0=None,
                 ment0=None, prev=None):
    c0 = _init_carry(p, enc_side=False)
    if tables0 is not None:
        c0["tables"] = tables0
    if p.chain_match:
        c0["rolz_ent"] = _remap_chain_ment(
            p,
            ment0
            if ment0 is not None
            else jnp.zeros((1 << p.rolz_bits, p.rolz_depth, 2), _i32),
        )
        prev_buf = (
            prev
            if prev is not None
            else jnp.zeros((p.lanes, p.steps), jnp.uint8)
        )
        out0 = jnp.stack(
            [prev_buf, jnp.zeros((p.lanes, p.steps), jnp.uint8)]
        )
    else:
        out0 = jnp.zeros((p.lanes, p.steps), jnp.uint8)
    carry = (c0, states, jnp.uint32(0), out0)
    body = functools.partial(_decode_body, p, stream, n)
    (c, x, base, out), _ = jax.lax.scan(
        body, carry, jnp.arange(p.steps, dtype=_i32)
    )
    if p.chain_match:
        return x, base, out[1], c["tables"], c["rolz_ent"]
    return x, base, out, c["tables"]


# --------------------------------------------------------------------------
# Host-facing API
# --------------------------------------------------------------------------


def _pack_payload(states, emit_packed, words) -> bytes:
    emit_np = np.unpackbits(
        np.asarray(emit_packed), axis=-1, bitorder="little"
    ).astype(bool)  # [T, n_slots, S] in (step, slot, lane) order
    words_np = np.asarray(words)
    stream = words_np[emit_np]  # C-order compaction == decode read order
    states_np = np.asarray(states)
    header = np.array([stream.size], np.uint32)
    return (
        header.tobytes()
        + states_np.astype("<u4").tobytes()
        + stream.astype("<u2").tobytes()
    )


@functools.partial(jax.jit, static_argnums=(0,))
def _encode_passes_lean(p: BlockParams, inp, n):
    """_encode_passes minus the debug/final-table outputs: the jit
    boundary for the (pipelined) container path.  Dropping ``ev`` from
    the outputs lets XLA free the [T, 3*n_slots, S] event grids once the
    rANS pass has consumed them — which matters when two blocks are in
    flight at once."""
    states, emit_packed, words, _, _ = _encode_passes(p, inp, n)
    return states, emit_packed, words


def encode_block_start(data: np.ndarray, p: BlockParams):
    """Dispatch the encode passes; returns device-array handles.

    jax dispatch is asynchronous: the scans are enqueued and this returns
    before they run.  encode_block_finish() blocks on the results and
    packs the payload — the container loop dispatches block i+1 BEFORE
    finishing block i, overlapping device compute with the device->host
    result transfer and the host-side payload packing."""
    assert not p.chain_match, (
        "chain_match blocks need carried tables/window: use "
        "encode_block_chained_* (container chain=True path), not the "
        "standalone block API"
    )
    n = int(data.size)
    assert 0 < n <= p.capacity
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = data
    return _encode_passes_lean(p, jnp.asarray(buf), jnp.int32(n))


def encode_block_finish(handles) -> bytes:
    states, emit_packed, words = handles
    return _pack_payload(states, emit_packed, words)


def encode_block(data: np.ndarray, p: BlockParams) -> bytes:
    """Encode up to p.capacity bytes; returns the block payload."""
    return encode_block_finish(encode_block_start(data, p))


def init_chain_tables(p: BlockParams):
    """Fresh chain-carry state for a model carry-over chain (container
    chain mode): the reference resets models once per FILE and amortizes
    them across all blocks (src/main.c:174-206); chain mode reproduces
    that behavior as an opt-in, trading block-independent decode for
    ratio.  A dict: ``tables`` = PPM tables; under p.chain_match also
    ``ment`` (the carried ROLZ bucket table, window-absolute positions)
    and ``prev`` (the previous block's padded byte buffer)."""
    st = {"tables": ppm.init_tables(p.match, p.o3_bits)}
    if p.chain_match:
        st["ment"] = jnp.zeros((1 << p.rolz_bits, p.rolz_depth, 2), _i32)
        st["prev"] = jnp.zeros((p.lanes, p.steps), jnp.uint8)
    return st


@functools.partial(jax.jit, static_argnums=(0,))
def _encode_passes_chained_lean(p: BlockParams, inp, n, tables0,
                                ment0=None, prev=None):
    """Chained encode minus the debug grids (same rationale as
    _encode_passes_lean: frees the [T,3*n_slots,S] event grids once the
    rANS pass consumed them — two chained blocks can be in flight)."""
    outs = _encode_passes(p, inp, n, tables0, ment0=ment0, prev=prev)
    states, emit_packed, words, _ = outs[:4]
    return (states, emit_packed, words) + tuple(outs[4:])


def encode_block_chained_start(data: np.ndarray, p: BlockParams, state0):
    """Dispatch a chained block encode (async); returns
    ((payload handles), state1 handles).  state1's arrays are device
    handles the NEXT block's start may consume immediately — the device
    dependency chain serializes the scans correctly while dispatch stays
    ahead of the result transfers (speculative chain pipelining: the
    container re-dispatches from the pre-block state in the rare
    stored-fallback case)."""
    n = int(data.size)
    assert 0 < n <= p.capacity
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = data
    dev = jnp.asarray(buf)
    if p.chain_match:
        states, emit_packed, words, tables1, ment1 = (
            _encode_passes_chained_lean(
                p, dev, jnp.int32(n), state0["tables"],
                state0["ment"], state0["prev"],
            )
        )
        state1 = {"tables": tables1, "ment": ment1, "prev": dev}
    else:
        states, emit_packed, words, tables1 = _encode_passes_chained_lean(
            p, dev, jnp.int32(n), state0["tables"]
        )
        state1 = {"tables": tables1}
    return (states, emit_packed, words), state1


def encode_block_chained_finish(handles) -> bytes:
    return _pack_payload(*handles)


def encode_block_chained(data: np.ndarray, p: BlockParams, state0):
    """encode_block with model carry-over: code the block starting from
    ``state0`` and return (payload, state1).  Without p.chain_match the
    match tables still reset per block (the reference re-inits its
    matcher per block too, roxmain/cr-coder.c:195)."""
    handles, state1 = encode_block_chained_start(data, p, state0)
    return encode_block_chained_finish(handles), state1


def encode_block_stats(data: np.ndarray, p: BlockParams) -> dict:
    """Encode + per-event-class bit accounting (ratio diagnostics)."""
    n = int(data.size)
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = data
    _, emit_packed, words, dbg, _ = _encode_passes(
        p, jnp.asarray(buf), jnp.int32(n)
    )
    emit = np.unpackbits(
        np.asarray(emit_packed), axis=-1, bitorder="little"
    )
    grids = [np.asarray(g) for g in dbg]
    ns = p.n_slots
    sym_a, mlen = grids[3 * ns], grids[3 * ns + 1]
    ca, fa, act_a = grids[0:3]
    cb, fb, act_b = grids[3:6]
    cc, fc, act_c = grids[6:9]
    act_a = act_a.astype(bool)
    act_b = act_b.astype(bool)
    act_c = act_c.astype(bool)
    bits_a = np.where(act_a, 15.0 - np.log2(np.maximum(fa, 1)), 0.0)
    bits_b = np.where(act_b, 15.0 - np.log2(np.maximum(fb, 1)), 0.0)
    bits_c = np.where(act_c, 15.0 - np.log2(np.maximum(fc, 1)), 0.0)
    bits_extra = 0.0
    for si in range(3, ns):
        fx, ax = grids[3 * si + 1], grids[3 * si + 2].astype(bool)
        bits_extra += float(
            np.where(ax, 15.0 - np.log2(np.maximum(fx, 1)), 0.0).sum()
        )
    is_lit = act_a & (sym_a < 256)
    is_hit = act_a & ((sym_a == ppm.SYM_HIT) | (sym_a == ppm.SYM_HIT2))
    is_esc = act_a & (sym_a == ppm.SYM_ESC)
    is_mat = act_a & (sym_a == ppm.SYM_MATCH)
    mbytes = int(mlen.sum())
    stats = {
        "n": n,
        "coded_steps": int(act_a.sum()),
        "literals": int(is_lit.sum()),
        "o3_hits": int(is_hit.sum()),
        "escapes": int(is_esc.sum()),
        "matches": int(is_mat.sum()),
        "match_bytes": mbytes,
        "avg_match_len": mbytes / max(int(is_mat.sum()), 1),
        "bits_lit": float(bits_a[is_lit].sum()),
        "bits_hit": float(bits_a[is_hit].sum()),
        "bits_esc_flag": float(bits_a[is_esc].sum()),
        "bits_esc_lit": float(bits_b[act_b & is_esc].sum()),
        "bits_match_flag": float(bits_a[is_mat].sum()),
        "bits_match_idx": float(bits_b[act_b & is_mat].sum()),
        "bits_match_len": float(bits_c[is_mat & act_c].sum()),
        "bits_match_extra": bits_extra,
        "stream_words": int(emit.sum()),
    }
    total_bits = sum(v for k, v in stats.items() if k.startswith("bits_"))
    stats["model_bpb"] = total_bits / max(n, 1)
    stats["real_bpb"] = (stats["stream_words"] * 16 + p.lanes * 32) / max(n, 1)
    return stats


def _unpack_payload(payload: bytes, p: BlockParams):
    n_words = int(np.frombuffer(payload[:4], "<u4")[0])
    off = 4
    states = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4").copy()
    off += 4 * p.lanes
    stream = np.frombuffer(payload[off : off + 2 * n_words], "<u2").copy()
    pad = (
        p.stream_pad
        if n_words <= p.stream_fallback_words
        else p.stream_pad_max
    )
    stream_padded = np.zeros(pad, np.uint16)
    stream_padded[:n_words] = stream
    return n_words, states, stream_padded


def _check_drain(x, base, n_words):
    if int(base) != n_words or not bool((np.asarray(x) == RANS_L).all()):
        raise ValueError(
            f"corrupt block: consumed {int(base)}/{n_words} words, "
            f"states drained={bool((np.asarray(x) == RANS_L).all())}"
        )


def decode_block_start(payload: bytes, n: int, p: BlockParams):
    """Dispatch the decode scan (async); pair with decode_block_finish.
    Same pipelining contract as encode_block_start."""
    assert not p.chain_match, (
        "chain_match blocks need carried tables/window: use "
        "decode_block_chained_* (container chained decode path), not the "
        "standalone block API"
    )
    n_words, states, stream_padded = _unpack_payload(payload, p)
    x, base, out, _tables = _decode_scan(
        p, jnp.asarray(states), jnp.asarray(stream_padded), jnp.int32(n)
    )
    # drop the tables handle NOW: the non-chained path never reads it, and
    # retaining it across the one-block-in-flight pipeline would keep a
    # second full table set alive on-device at large geometries
    return n, n_words, (x, base, out)


def decode_block_finish(started) -> np.ndarray:
    n, n_words, handles = started
    x, base, out = handles[:3]
    _check_drain(x, base, n_words)
    return np.asarray(out).reshape(-1)[:n]


def decode_block(payload: bytes, n: int, p: BlockParams) -> np.ndarray:
    """Decode a block payload back to its n raw bytes."""
    return decode_block_finish(decode_block_start(payload, n, p))


def decode_block_chained_start(payload: bytes, n: int, p: BlockParams,
                               state0):
    """Dispatch a chained block decode (async); returns
    (started, state1 handles).  Unlike encode there is nothing to
    speculate: stored blocks are known from their header flags before
    dispatch and never touch the models, so the next coded block can
    chain off ``state1`` immediately (a device-side dependency)."""
    n_words, states, stream_padded = _unpack_payload(payload, p)
    if p.chain_match:
        x, base, out, tables1, ment1 = _decode_scan(
            p, jnp.asarray(states), jnp.asarray(stream_padded),
            jnp.int32(n), state0["tables"], state0["ment"], state0["prev"],
        )
        state1 = {"tables": tables1, "ment": ment1, "prev": out}
    else:
        x, base, out, tables1 = _decode_scan(
            p, jnp.asarray(states), jnp.asarray(stream_padded),
            jnp.int32(n), state0["tables"],
        )
        state1 = {"tables": tables1}
    return (n, n_words, (x, base, out, tables1)), state1


def decode_block_chained(payload: bytes, n: int, p: BlockParams, state0):
    """decode_block with model carry-over (inverse of
    encode_block_chained): returns (bytes, state1)."""
    started, state1 = decode_block_chained_start(payload, n, p, state0)
    return decode_block_finish(started), state1
