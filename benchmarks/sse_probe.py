"""SSE/APM probe for the A distribution (VERDICT r3 next-round #3).

Measures — WITHOUT any format change — what a secondary-estimation
stage on the A event's structural flags would save.  The A event is
decomposed into binary flags (cost-exact: P(A=s) = P(flag) * P(s|flag),
so re-estimating a flag changes total bits by exactly the flag-bits
delta):

    hit   = (sym_a == SYM_HIT)    with primary p = f_hit / tot
    match = (sym_a == SYM_MATCH | rest) with p = f_match / (tot - f_hit - f_hit2)
    hit2  = (sym_a == SYM_HIT2 | rest)

Each flag runs through an lpaq-style APM: a dense [n_ctx, 33] table of
probabilities initialized to the identity (bin centers on a stretch
scale), 2-point interpolated lookup, rate-1/32 update toward the
outcome — exactly the arithmetic the device implementation uses (small
dense table, one-hot matmuls, both sides replayable).

The capture comes from the real encoder's coding-time model state
(CPX_DEBUG_EVT grids; fa is the NORMALIZED coded freq, so baseline
total model bits are exact).

Usage: JAX_PLATFORMS=cpu python benchmarks/sse_probe.py [MB] [CTX]
  CTX in {none, conf, conf_match, conf_match_p1} — SSE context key.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["CPX_DEBUG_EVT"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def capture(size_mb: float):
    import jax.numpy as jnp

    from bench import build_corpus
    from comprox_tpu.codec import dictionary as dic
    from comprox_tpu.codec.block import BlockParams, _encode_passes

    size = int(size_mb * 1048576)
    data = build_corpus(8 << 20)
    wd = dic.build_dictionary(data)
    sub = dic.dict_encode(data, wd)[:size]
    p = BlockParams(
        lanes=512, steps=size // 512, mode="R", min_len=5,
        rolz_ctx_bytes=4, rolz_dec=2,
    )
    n = int(sub.size)
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = sub
    _, _, _, dbg, _ = _encode_passes(p, jnp.asarray(buf), jnp.int32(n))
    g = [np.asarray(x) for x in dbg]
    ns = p.n_slots  # 3 for R: grids 0..8 = (c,f,act) x A,B,C
    return {
        "fa": g[1].astype(np.float64),      # normalized coded freq (/M)
        "coding": g[2],
        "fb": g[4].astype(np.float64), "act_b": g[5],
        "fc": g[7].astype(np.float64), "act_c": g[8],
        "sym_a": g[3 * ns].astype(np.int64),
        "fill": g[3 * ns + 3].astype(np.int64),  # ROLZ bucket fill —
        # decoder-replayable (the bucket replay is part of decode), so
        # legal SSE context; do_match (the parse DECISION) is not
        "p1": g[3 * ns + 4].astype(np.int64),
        "f_hit": g[3 * ns + 5].astype(np.float64),
        "f_hit2": g[3 * ns + 6].astype(np.float64),
        "f_esc": g[3 * ns + 7].astype(np.float64),
        "f_match": g[3 * ns + 8].astype(np.float64),
        "tot": g[3 * ns + 9].astype(np.float64),
        "conf": g[3 * ns + 10].astype(np.int64),
        "conf2": g[3 * ns + 11].astype(np.int64),
        "do_match": g[3 * ns + 12],
    }, n


EPS = float(os.environ.get("SSE_EPS", 1.0 / 4096.0))


def stretch(p):
    return np.log(p / (1 - p))


def squash(x):
    return 1 / (1 + np.exp(-x))


class APM:
    """lpaq APM_t: [n_ctx, 33] probability table, identity init."""

    def __init__(self, n_ctx, rate=1 / 32):
        centers = squash((np.arange(33) - 16.0) / 16.0 * 8.0)
        self.t = np.tile(centers, (n_ctx, 1))
        self.lo, self.hi = centers[0], centers[-1]
        self.rate = rate

    def apply(self, ctx, p, h):
        """Sequential refine+update; returns refined probabilities."""
        x = stretch(np.clip(p, self.lo, self.hi)) / 8.0 * 16.0 + 16.0
        i = np.clip(x.astype(np.int64), 0, 31)
        w = x - i
        out = np.empty_like(p)
        for k in range(p.size):
            c, j, wk = ctx[k], i[k], w[k]
            pk = (1 - wk) * self.t[c, j] + wk * self.t[c, j + 1]
            out[k] = pk
            e = h[k] - pk
            self.t[c, j] += (1 - wk) * self.rate * e
            self.t[c, j + 1] += wk * self.rate * e
        return np.clip(out, EPS, 1 - EPS)


def flag_bits(p, h):
    p = np.clip(p, EPS, 1 - EPS)
    return float(-np.log2(np.where(h, p, 1 - p)).sum())


def run_flag(name, p_prim, h, ctxs, order):
    """order = time-order permutation of the event arrays."""
    base = flag_bits(p_prim, h)
    print(f"  {name}: {h.sum()} of {h.size} events, primary {base:,.0f} bits")
    results = {}
    for cname, ctx in ctxs.items():
        apm = APM(int(ctx.max()) + 1)
        p_sse = np.empty_like(p_prim)
        p_sse[order] = apm.apply(ctx[order], p_prim[order], h[order])
        sse = flag_bits(p_sse, h)
        mixed = flag_bits((p_sse + np.clip(p_prim, EPS, 1 - EPS)) / 2, h)
        results[cname] = (sse, mixed)
        print(
            f"    SSE|{cname:24s} {sse:12,.0f} bits ({(sse - base) / base:+.2%})"
            f"   avg-mix {mixed:12,.0f} ({(mixed - base) / base:+.2%})"
        )
    return base, results


def main():
    size_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    g, n = capture(size_mb)
    T, S = g["coding"].shape[0], g["coding"].shape[1]
    M = 1 << 16

    cod = g["coding"].astype(bool)
    bits_a = -np.log2(np.maximum(g["fa"], 1) / M)[cod].sum()
    bits_b = -np.log2(np.maximum(g["fb"], 1) / M)[g["act_b"].astype(bool)].sum()
    bits_c = -np.log2(np.maximum(g["fc"], 1) / M)[g["act_c"].astype(bool)].sum()
    total = bits_a + bits_b + bits_c
    print(
        f"capture {size_mb:g}MiB: total model bits {total:,.0f} "
        f"(A {bits_a:,.0f} / B {bits_b:,.0f} / C {bits_c:,.0f}), "
        f"{total / n:.4f} b per coded byte"
    )

    # event arrays in TIME order (step-major, lane-minor — the decode
    # order within a step is lane order); np.nonzero is already
    # row-major so key is ascending, but keep it explicit
    tt, ss = np.nonzero(cod)
    key = tt * S + ss

    sym = g["sym_a"][cod]
    tot = g["tot"][cod]
    f_hit, f_hit2, f_match = g["f_hit"][cod], g["f_hit2"][cod], g["f_match"][cod]
    conf = np.clip(g["conf"][cod], 0, 3)
    conf2 = np.clip(g["conf2"][cod], 0, 1)
    avail = (g["fill"][cod] > 0).astype(np.int64)  # decoder-known
    fillc = np.clip((g["fill"][cod] - 1) // 16, 0, 3) + 1
    fillc = np.where(avail > 0, fillc, 0)  # 0 / 1..4 fill quartiles
    p1c = np.minimum(g["p1"][cod], 255) // 64  # coarse o1 class (4)

    from comprox_tpu.models import ppm

    deltas = {}

    # ---- hit flag (only where a prediction exists: conf > 0)
    m = g["conf"][cod] > 0
    ctxs = {
        "none": np.zeros(int(m.sum()), np.int64),
        "conf": conf[m] - 1,
        "conf_x_avail": (conf[m] - 1) * 2 + avail[m],
        "conf_x_avail_x_p1": ((conf[m] - 1) * 2 + avail[m]) * 4 + p1c[m],
    }
    base, res = run_flag(
        "hit ", np.clip(f_hit[m] / tot[m], EPS, 1 - EPS),
        (sym[m] == ppm.SYM_HIT), ctxs,
        np.argsort(key[m], kind="stable"),
    )
    deltas["hit"] = {k: min(v) - base for k, v in res.items()}

    # ---- match flag among non-hit mass, over ALL coding events: the
    # primary reserves f_match mass even when the bucket context has no
    # candidates (avail == 0 -> MATCH is impossible but still paid for);
    # fill is decoder-replayable so SSE may key on it
    rest = np.maximum(tot - f_hit - f_hit2, 1)
    ctxs = {
        "none": np.zeros(sym.size, np.int64),
        "avail": avail,
        "fillq": fillc,
        "fillq_x_conf": fillc * 4 + conf,
        "fillq_x_p1": fillc * 4 + p1c,
    }
    base, res = run_flag(
        "match", np.clip(f_match / rest, EPS, 1 - EPS),
        (sym == ppm.SYM_MATCH), ctxs,
        np.argsort(key, kind="stable"),
    )
    deltas["match"] = {k: min(v) - base for k, v in res.items()}

    best = sum(min(d.values()) for d in deltas.values())
    print(
        f"best combined delta: {best:,.0f} bits = {best / total:+.2%} of "
        f"total model bits"
    )


if __name__ == "__main__":
    main()
