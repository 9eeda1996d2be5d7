"""Lane-interleaved rANS primitives (vectorized, JAX/XLA).

Bit-exact vectorization of :mod:`comprox_tpu.ops.rans_scalar` across S
independent lanes.  Each lane carries a uint32 state; per coding step a lane
emits (encode) or consumes (decode) at most one u16 word.  All lanes' words
interleave into one compact stream in (step, lane) order — the data-parallel
generalization of the reference's 4 side streams decoded by pthreads
(/root/reference/src/roxmain/cr-coder.c:334-388): instead of 4 streams and 4
threads, S streams and S vector lanes.

Masking: a lane that has no symbol this step codes the *identity event*
``(c, f) = (0, M)``; algebraically ``x -> (x // M)*M + 0 + x % M = x`` with no
renormalization possible, so inactive lanes are a no-op without any select on
the state.

All functions are pure and shape-polymorphic over the lane axis; they run
under jit/scan/shard_map and on CPU for testing.
"""

from __future__ import annotations

import jax.numpy as jnp

from comprox_tpu.ops.rans_scalar import M, M_BITS, MASK16, MASK_M, RANS_L

_U32 = jnp.uint32

# Decode-side stream-read strategy (onehot | sort | gather).  Pure
# performance knob: all three produce identical words from the identical
# stream layout, so it is NOT format-relevant (not fingerprinted).
import os as _os

STREAM_READ = _os.environ.get("CPX_STREAM_READ", "auto")


def identity_cf(shape):
    """The no-op coding event for masked lanes."""
    return jnp.zeros(shape, _U32), jnp.full(shape, M, _U32)


def norm_cf(cum, frq, tot):
    """Vectorized query-time normalization of raw (cum, frq, tot) to M-scale.

    Callers must guarantee tot <= M and frq >= 1 on active lanes (adaptive
    models maintain that invariant by rescale-at-read).
    """
    cum = cum.astype(_U32)
    frq = frq.astype(_U32)
    tot = tot.astype(_U32)
    c1 = (cum << M_BITS) // tot
    c2 = ((cum + frq) << M_BITS) // tot
    return c1, c2 - c1


def select_cf(active, c, f):
    """Replace (c, f) by the identity event on inactive lanes."""
    ic, if_ = identity_cf(c.shape)
    return jnp.where(active, c, ic), jnp.where(active, f, if_)


def enc_put(x, c, f):
    """One backward-encode step for every lane.

    Returns (new_state, emit_mask, word).  ``word`` is meaningful only where
    ``emit_mask`` is set.
    """
    x = x.astype(_U32)
    # x >= f << (32 - M_BITS), written shift-right so f == M (the identity
    # event) cannot overflow uint32: exact because f << 17 has zero low bits.
    emit = (x >> (32 - M_BITS)) >= f
    word = (x & MASK16).astype(jnp.uint16)
    x = jnp.where(emit, x >> 16, x)
    x = ((x // f) << M_BITS) + c + (x % f)
    return x, emit, word


def dec_slot(x):
    return x & jnp.uint32(MASK_M)


def dec_target(slot, tot):
    """Raw-domain cumulative-search target for a decoded slot."""
    tot = tot.astype(_U32)
    return (slot * tot + tot - jnp.uint32(1)) >> M_BITS


def dec_advance(x, c, f):
    """State advance without renormalization.

    Returns (x_tmp, need_word).  Where ``need_word`` is set the caller must
    complete renormalization with :func:`dec_renorm` using the next stream
    word for that lane.
    """
    x = x.astype(_U32)
    x = f * (x >> M_BITS) + dec_slot(x) - c
    return x, x < jnp.uint32(RANS_L)


def dec_renorm(x_tmp, need_word, word):
    """Feed one u16 word into every lane flagged by ``need_word``."""
    fed = (x_tmp << 16) | word.astype(_U32)
    return jnp.where(need_word, fed, x_tmp)


def stream_window_read(win, need, off):
    """Read one word per flagged lane from a step-local stream window.

    Every word consumed in one decode step is CONTIGUOUS in the stream
    (events are ordered (step, slot, lane)), so the caller slices a window
    once per step with a scalar-start ``dynamic_slice`` and each slot's
    per-lane reads resolve inside that window.  Three bit-identical
    strategies, selected by ``CPX_STREAM_READ`` (same stream format
    either way; default ``auto`` = gather at every lane count, the
    fastest on the H100 at S=512: PERF.md, stream-read table):

    - ``onehot``: exact one-hot f32 matvec, [S, S] work per call —
      quadratic in lanes.
    - ``sort``: two [S] key/value sorts on unique keys (rank -> lane,
      then lane -> word), O(S log^2 S).
    - ``gather``: plain XLA gather at monotone indices, linear in S.

    Returns (words, new_off).
    """
    import jax as _jax

    s = need.shape[0]
    inc = need.astype(jnp.uint32)
    acc = inc
    k = 1
    while k < s:
        acc = acc + jnp.pad(acc, (k, 0))[:s]
        k *= 2
    idx = (off + acc - inc).astype(jnp.int32)
    strategy = STREAM_READ
    if strategy == "auto":
        strategy = "gather"
    if strategy == "sort":
        lane = _jax.lax.broadcasted_iota(jnp.int32, (s,), 0)
        rk = (acc - inc).astype(jnp.int32)  # 0..m-1 on needing lanes
        rank = jnp.where(need, rk, jnp.int32(s) + lane)
        # sort by rank (keys unique, no stability needed): position
        # j < m holds the lane whose word is win[off + j]
        _, lane_by_rank = _jax.lax.sort((rank, lane), num_keys=1)
        w_by_rank = _jax.lax.dynamic_slice(
            win, (off.astype(jnp.int32),), (s,)
        )
        _, w = _jax.lax.sort(
            (lane_by_rank, w_by_rank.astype(jnp.int32)), num_keys=1
        )
        w = jnp.where(need, w, 0).astype(_U32)
    elif strategy == "gather":
        # idx is nondecreasing across ALL lanes (excl increments only on
        # need) and < win size even on trailing non-needing lanes
        w = jnp.take(win, idx, indices_are_sorted=True).astype(_U32)
        w = jnp.where(need, w, 0)
    else:
        oh = (
            _jax.lax.broadcasted_iota(jnp.int32, (s, win.shape[0]), 1)
            == idx[:, None]
        ) & need[:, None]
        # 0/1 matrix x u16 values: exact at Precision.HIGHEST (true fp32,
        # int < 2^24, one nonzero term per output); TF32 would round them
        w = jnp.dot(
            oh.astype(jnp.float32),
            win.astype(jnp.float32),
            precision=_jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).astype(_U32)
    return w.astype(jnp.uint16), off + acc[-1]


def stream_positions(emit_mask_flat, base):
    """Forward-order stream indices for a flat emission mask.

    Given the flattened per-event emission mask in *decode order* and the
    current read base, returns (indices, new_base): ``indices[i]`` is the
    stream position of event i's word (meaningful only where the mask is
    set).  Integer Hillis-Steele prefix sum: exact on every backend
    (log2(S) whole-vector rounds).
    """
    s = emit_mask_flat.shape[0]
    inc = emit_mask_flat.astype(jnp.uint32)
    acc = inc
    k = 1
    while k < s:
        acc = acc + jnp.pad(acc, (k, 0))[:s]
        k *= 2
    excl = acc - inc
    return base + excl, base + acc[-1]


def init_states(n_lanes):
    return jnp.full((n_lanes,), RANS_L, _U32)
