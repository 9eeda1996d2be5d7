"""Batched adaptive frequency-table primitives.

The reference keeps per-context frequency tables updated one symbol at a time
(cr-model.c:55-77, cr-o2model.c:42-71).  Here S lanes advance in lock-step,
so per step we have S (context, symbol) updates that must be applied
*deterministically* — encode's modeling pass and decode replay the identical
sequence.  Three mechanisms:

1.  **scatter-add increments** — additive updates commute, so colliding lanes
    (same context) combine correctly and deterministically.

2.  **rescale-at-read** — the reference halves a table the moment its sum
    crosses a cap; with batched adds the crossing happens *between* reads, so
    we instead halve when a row is *read* over cap.  Both sides run the same
    read path, so the table evolution stays bit-identical.  Up to
    ``HALVE_ROUNDS`` halvings per read bound transient growth from S
    simultaneous increments.

3.  **winner dedup** — non-additive writes (halved rows, o3 predictor slots)
    from colliding lanes are resolved by electing the minimum lane index per
    target via a stable sort over the S lane keys; only winners write.

All tables are int32: sums stay well below 2^31 even with transient growth,
and signed arithmetic lets corrective updates (escape elimination,
cr-ppm.c:137-139) go temporarily negative — readers clamp at >= 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from comprox_tpu.ops.rans_scalar import M

HALVE_ROUNDS = 3
_SENTINEL = jnp.int32(2**31 - 1)


def make_table(n_ctx: int, width: int, init_row) -> jax.Array:
    """Fresh [n_ctx, width] int32 table from a length-`width` init row."""
    row = jnp.asarray(init_row, jnp.int32)
    return jnp.broadcast_to(row, (n_ctx, row.shape[0])).copy()


def halve_rows(rows, sticky_mask):
    """One halving pass.  ``sticky_mask`` ([width] bool) marks slots that use
    ceil-halving (stay >= 1, like cr-model.c:75 ``(f+1)/2``); other slots use
    floor-halving and may reach zero (cr-o2model.c:55).  Negative slots (from
    corrective updates) are clamped to 0 first."""
    rows = jnp.maximum(rows, 0)
    return jnp.where(sticky_mask, (rows + 1) >> 1, rows >> 1)


def rescale_read(rows, cap: int, sticky_mask):
    """Apply read-time rescaling.  Returns (rows', did_halve [S] bool)."""
    did = jnp.zeros(rows.shape[:-1], bool)
    for _ in range(HALVE_ROUNDS):
        need = jnp.sum(rows, axis=-1) > cap
        did = did | need
        rows = jnp.where(need[..., None], halve_rows(rows, sticky_mask), rows)
    return rows, did


def elect_winners(idx, mask):
    """Deterministically pick one lane per distinct ``idx`` among ``mask``
    (the minimum lane index wins, matching sequential tie-breaking).

    Up to 1024 lanes an O(S^2) masked compare (elementwise work that
    fuses); beyond, a stable argsort over the S keys.  Neither touches the
    tables themselves (a scatter-min/restore scratch pattern on a
    multi-MB scan carry would).  Which is faster on the GPU is not yet
    measured.
    """
    s = idx.shape[0]
    if s <= 1024:
        dup = (
            (idx[:, None] == idx[None, :])
            & mask[None, :]
            & jnp.tril(jnp.ones((s, s), bool), k=-1)
        )
        return mask & ~jnp.any(dup, axis=1)
    key = jnp.where(mask, idx, _SENTINEL)
    order = jnp.argsort(key)  # stable: equal keys keep lane order
    sk = key[order]
    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    winner_sorted = first & (sk != _SENTINEL)
    return jnp.zeros((s,), bool).at[order].set(winner_sorted)


import os as _os

_TRI_CACHE: dict = {}
# Prefix sums as matmuls with a 0/1 triangular matrix, or as an integer
# Hillis-Steele ladder (~log2(W) dependent vector rounds).  The matmul
# runs at Precision.HIGHEST, true fp32 on every backend: with integer row
# values < 2^24 every partial product and f32 accumulation is exact.  A
# reduced-precision dot would NOT be (TF32 keeps 11 significant bits,
# bf16 8).  The rANS drain invariant fails loudly if any backend ever
# violates this.  On the H100 the matmul form measured 0.6-3.2% faster per
# crz decode step (PERF.md, stream-read table); CPX_NO_MATMUL_CUMSUM=1
# selects the integer ladder.
_MATMUL_CUMSUM = _os.environ.get("CPX_NO_MATMUL_CUMSUM") != "1"


def _strict_upper_tri(w: int):
    if w not in _TRI_CACHE:
        import numpy as _np

        _TRI_CACHE[w] = _np.triu(_np.ones((w, w), _np.float32), k=1)
    return _TRI_CACHE[w]


def exclusive_cumsum(rows):
    """Exclusive prefix sum along the last axis (exact; see note above)."""
    w = rows.shape[-1]
    if _MATMUL_CUMSUM and w >= 64:
        out = jnp.dot(
            rows.astype(jnp.float32),
            _strict_upper_tri(w),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return out.astype(rows.dtype)
    inc = rows
    k = 1
    while k < w:
        shifted = jnp.pad(inc, [(0, 0)] * (inc.ndim - 1) + [(k, 0)])[
            ..., :w
        ]
        inc = inc + shifted
        k *= 2
    return inc - rows


def row_total(rows):
    return jnp.sum(rows, axis=-1)


def cum_frq_of(rows, cums, sym):
    """(cum, frq) for a known symbol per lane.

    One-hot where-sum instead of take_along_axis: per-lane element
    selects lower to gathers in a scan body; the masked reduce is
    elementwise work that fuses."""
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, rows.shape, rows.ndim - 1)
        == sym[..., None]
    )
    c = jnp.sum(jnp.where(sel, cums, 0), axis=-1)
    f = jnp.sum(jnp.where(sel, rows, 0), axis=-1)
    return c, f


def find_symbol(rows, cums, target):
    """Largest s with cums[s] <= target — the raw-domain decode search
    (shape of cr-model.c:98-115 but vectorized: count-of-leq minus one)."""
    le = (cums <= target[..., None]).astype(jnp.int32)
    sym = jnp.sum(le, axis=-1) - 1
    sym = jnp.clip(sym, 0, rows.shape[-1] - 1)
    c, f = cum_frq_of(rows, cums, sym)
    return sym, c, f


def assert_valid_dist(rows):  # pragma: no cover - debug helper
    tot = row_total(rows)
    assert bool((tot > 0).all()) and bool((tot <= M).all())
