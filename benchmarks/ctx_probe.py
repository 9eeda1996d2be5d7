"""Offline context-conditioning probe for the side-event models.

Measures — WITHOUT any format change — what context-conditioning the
mode-'X' distance-bucket model ('dst', today a single shared row; the
analogue of roxmain's chained pos_models, roxmain/cr-coder.c:242-258)
or the mode-'R' bucket-index model would save, by capturing the real
encoder's event stream (CPX_DEBUG_EVT=1 debug grids) and replaying the
EXACT table arithmetic (rescale-at-read, halve-rounds, per-step batched
increments) in numpy under alternative context functions.

Usage:  JAX_PLATFORMS=cpu CPX_DEBUG_EVT=1 python benchmarks/ctx_probe.py [R|X]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["CPX_DEBUG_EVT"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp


def capture(mode: str, size: int = 2 << 20):
    from bench import build_corpus
    from comprox_tpu.codec import dictionary as dic
    from comprox_tpu.codec.block import BlockParams, _encode_passes
    from comprox_tpu.models import ppm

    data = build_corpus(8 << 20)
    wd = dic.build_dictionary(data)
    sub = dic.dict_encode(data, wd)[:size]
    kw = dict(lanes=512, steps=size // 512)
    if mode == "R":
        p = BlockParams(mode="R", min_len=5, rolz_ctx_bytes=4, rolz_dec=2, **kw)
    else:
        p = BlockParams(mode="X", min_len=6, **kw)
    n = int(sub.size)
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = sub
    _, _, _, dbg, _ = _encode_passes(p, jnp.asarray(buf), jnp.int32(n))
    g = [np.asarray(x) for x in dbg]
    ns = p.n_slots
    sym_a = g[3 * ns]          # [T, S]
    mlen = g[3 * ns + 1]
    sym_b = g[3 * ns + 2]      # sym_dst (X) / sym_idx (R)
    aux = g[3 * ns + 3]        # dist (X) / rolz_fill (R)
    p1 = g[3 * ns + 4]
    is_match = sym_a == ppm.SYM_MATCH
    return p, is_match, mlen, sym_b, aux, p1


def sim(sym, mask, ctx, n_ctx, W, inc, cap, label):
    """Replay of models/ppm.py _read_shared_ctx + apply_updates.bump:
    per step, participating rows rescale-at-read (3 halve rounds of
    (tab+1)>>1 while sum > cap), every masked lane pays log2(total/freq)
    at the step-start table, then all increments land at once."""
    T, S = sym.shape
    tab = np.ones((n_ctx, W), np.int64)
    bits = 0.0
    n_ev = 0
    for t in range(T):
        m = mask[t]
        if not m.any():
            continue
        c = np.clip(ctx[t][m], 0, n_ctx - 1)
        s = sym[t][m]
        hot = np.zeros(n_ctx, bool)
        hot[c] = True
        for _ in range(3):
            need = hot & (tab.sum(axis=1) > cap)
            tab[need] = (tab[need] + 1) >> 1
        tot = tab.sum(axis=1)
        f = tab[c, s]
        bits += float(np.log2(tot[c] / np.maximum(f, 1)).sum())
        n_ev += int(m.sum())
        np.add.at(tab, (c, s), inc)
    print(f"{label:42s} {bits:12.0f} bits  ({bits / max(n_ev, 1):.3f} b/ev,"
          f" {n_ev} events)", flush=True)
    return bits


def prev_per_lane(val, mask, init=0):
    """Per-lane previous event value (the value at that lane's most recent
    earlier masked step)."""
    T, S = val.shape
    out = np.zeros_like(val)
    cur = np.full((S,), init, val.dtype)
    for t in range(T):
        out[t] = cur
        m = mask[t]
        cur[m] = val[t][m]
    return out


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "X"
    from comprox_tpu.models import ppm

    p, is_match, mlen, sym_b, aux, p1 = capture(mode)
    print(f"mode {mode}: {int(is_match.sum())} matches of "
          f"{p.lanes * p.steps} positions")
    if mode == "X":
        W, inc, cap = ppm.DST_W, ppm.DST_INC, ppm.DST_CAP
        zero = np.zeros_like(sym_b, np.int64)
        sym = sym_b.astype(np.int64)
        sim(sym, is_match, zero, 1, W, inc, cap, "dst base (shared row)")
        lc = np.clip(mlen.astype(np.int64) - p.min_len, 0, 3)
        sim(sym, is_match, lc, 4, W, inc, cap, "dst | len-class(4)")
        pb = prev_per_lane(sym, is_match)
        sim(sym, is_match, np.minimum(pb // 7, 3), 4, W, inc, cap,
            "dst | prev-bucket//7(4)")
        sim(sym, is_match, pb, 25, W, inc, cap, "dst | prev-bucket(25)")
        sim(sym, is_match, np.minimum(pb // 7, 3) * 4 + lc, 16, W, inc, cap,
            "dst | prev//7 x len-class(16)")
        rep = (sym == 24).astype(np.int64)
        prep = prev_per_lane(rep, is_match)
        sim(sym, is_match, prep, 2, W, inc, cap, "dst | prev-was-repeat(2)")
        sim(sym, is_match, prep * 4 + lc, 8, W, inc, cap,
            "dst | prev-rep x len-class(8)")
    else:
        W, inc, cap = ppm.IDX_W, ppm.IDX_INC, ppm.IDX_CAP
        sym = sym_b.astype(np.int64)
        fill = aux.astype(np.int64)

        def fill_bucket(f):
            # mirrors block._fill_bucket
            return np.clip((f - 1) // 16, 0, 3)

        fb = fill_bucket(fill)
        sim(sym, is_match, fb, 4, W, inc, cap, "idx base (fill quartile 4)")
        pi = prev_per_lane(sym, is_match)

        def rec_bucket(i):
            # mirrors block._rec_bucket: 0 / 1-3 / 4-15 / 16+
            return ((i >= 1).astype(np.int64) + (i >= 4) + (i >= 16))

        rb = rec_bucket(pi)
        sim(sym, is_match, fb * 4 + rb, 16, W, inc, cap,
            "idx | fill x prev-rec(16)")
        lc = np.clip(mlen.astype(np.int64) - p.min_len, 0, 3)
        sim(sym, is_match, fb * 4 + lc, 16, W, inc, cap,
            "idx | fill x len-class(16)")
        pp1 = np.clip(p1.astype(np.int64) // 64, 0, 3)
        sim(sym, is_match, fb * 4 + pp1, 16, W, inc, cap,
            "idx | fill x p1//64(16)")


if __name__ == "__main__":
    main()
