"""Mode-X SSE/APM probe (VERDICT r4 #7) with EXACT-cost accounting.

Mode X pays the same always-reserved match mass in the A event that the
round-4 SSE stage reclaimed for mode R — but X's decoder cannot replay a
bucket fill (distances are explicit; the bucket table is encoder-
private).  Candidate DECODER-KNOWN contexts: the o3 confidence class,
and match RECENCY, both lane-local (steps since this lane last decoded
a MATCH — every prior A symbol is decoder-known) and global (matches in
the previous step across all S lanes: lock-step decode makes the whole
previous step "the past").

Accounting (the round-4 post-mortem lesson — no clipped flag
decomposition): reshaping only the SYM_MATCH slot f_m -> f_m' changes
the row total tot -> tot' = tot - f_m + f_m', so the exact per-event
bit delta is
    match events:      log2(tot'/f_m') - log2(tot/f_m)
    all other events:  log2(tot'/tot)
computed directly from the captured raw coding-time freqs.  The hit
reshape (SYM_HIT slot) composes the same way, applied first like the
mode-R implementation (models/ppm.py _sse_reshape).

Usage: JAX_PLATFORMS=cpu python benchmarks/sse_x_probe.py [MB]
       MODE=R ... — same exact-cost machinery on mode R's capture, to
       rank candidate HIT-APM contexts against the implemented
       conf x avail (rev 7) before touching the format.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["CPX_DEBUG_EVT"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


MODE = os.environ.get("MODE", "X")
if MODE == "R":
    # capture PRIMARY freqs (the implemented rev-7 SSE reshapes rowmod
    # before the debug capture; ranking candidate contexts needs the
    # unreshaped baseline)
    os.environ["CPX_SSE"] = "0"


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
        lanes=512, steps=size // 512, mode=MODE,
        min_len={"X": 6, "R": 5, "P": 4}[MODE],
        rolz_ctx_bytes=4 if size >= 4 * 1048576 else 3,
        rolz_dec=2 if MODE == "R" else 1,
    )
    n = int(sub.size)
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = sub
    _, _, _, dbg, _ = _encode_passes(p, jnp.asarray(buf), jnp.int32(n))
    g = [np.asarray(x) for x in dbg]
    ns = p.n_slots  # 5 for X: grids 0..14 = (c,f,act) x A,B,C,D,E
    out = {
        "fa": g[1].astype(np.float64),
        "coding": g[2],
        "fb": g[4].astype(np.float64), "act_b": g[5],
        "fc": g[7].astype(np.float64), "act_c": g[8],
        "sym_a": g[3 * ns].astype(np.int64),
        "fill": g[3 * ns + 3].astype(np.int64),  # dist for X, fill for R
        "p1": g[3 * ns + 4].astype(np.int64),
        "f_hit": g[3 * ns + 5].astype(np.float64),
        "f_hit2": g[3 * ns + 6].astype(np.float64),
        "f_esc": g[3 * ns + 7].astype(np.float64),
        "f_match": g[3 * ns + 8].astype(np.float64),
        "tot": g[3 * ns + 9].astype(np.float64),
        "conf": g[3 * ns + 10].astype(np.int64),
        "conf2": g[3 * ns + 11].astype(np.int64),
    }
    if MODE == "X":
        out["fd"] = g[10].astype(np.float64)
        out["act_d"] = g[11]
        out["fe"] = g[13].astype(np.float64)
        out["act_e"] = g[14]
    return out, n


class APM:
    """Float stand-in for the integer lpaq APM (models/ppm.py): [n_ctx,
    33] identity-initialized stretch-scale table, 2-point interpolated
    read, rate-1/32 update.  Probabilities live on the implementation's
    clamp range [16/65536, 65520/65536]."""

    LO, HI = 16 / 65536.0, 65520 / 65536.0

    def __init__(self, n_ctx, rate=1 / 32):
        centers = 1 / (1 + np.exp(-(np.arange(33) - 16.0) / 2.0))
        self.t = np.tile(np.clip(centers, self.LO, self.HI), (n_ctx, 1))
        self.edges = centers
        self.rate = rate

    def apply_seq(self, ctx, p, h):
        """Sequential refine+update in time order; returns refined p."""
        x = np.log(np.clip(p, self.LO, self.HI) / (1 - np.clip(p, self.LO, self.HI)))
        x = np.clip(x * 2.0 + 16.0, 0.0, 32.0)  # stretch-scale bin coord
        i = np.minimum(x.astype(np.int64), 31)
        w = x - i
        out = np.empty_like(p)
        for k in range(p.size):
            c, j, wk = ctx[k], i[k], w[k]
            pk = (1 - wk) * self.t[c, j] + wk * self.t[c, j + 1]
            out[k] = pk
            e = h[k] - pk
            self.t[c, j] = np.clip(
                self.t[c, j] + (1 - wk) * self.rate * e, self.LO, self.HI
            )
            self.t[c, j + 1] = np.clip(
                self.t[c, j + 1] + wk * self.rate * e, self.LO, self.HI
            )
        return np.clip(out, self.LO, self.HI)


def reshape_freq(f, rest, p_sse):
    """Solve f' so that f'/(rest - f + f') = p_sse, like _sse_reshape
    (floor 1 so decodability is unchanged)."""
    return np.maximum(p_sse * (rest - f) / (1 - p_sse), 1.0)


def main():
    size_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    g, n = capture(size_mb)
    S = g["coding"].shape[1]
    M = 1 << 16

    cod = g["coding"].astype(bool)
    bits = {
        "A": -np.log2(np.maximum(g["fa"], 1) / M)[cod].sum(),
        "B": -np.log2(np.maximum(g["fb"], 1) / M)[g["act_b"].astype(bool)].sum(),
        "C": -np.log2(np.maximum(g["fc"], 1) / M)[g["act_c"].astype(bool)].sum(),
    }
    if MODE == "X":
        bits["D"] = -np.log2(np.maximum(g["fd"], 1) / M)[g["act_d"].astype(bool)].sum()
        bits["E"] = -np.log2(np.maximum(g["fe"], 1) / M)[g["act_e"].astype(bool)].sum()
    total = sum(bits.values())
    print(
        f"capture {MODE} {size_mb:g}MiB: total model bits {total:,.0f} "
        + " ".join(f"{k} {v:,.0f}" for k, v in bits.items())
    )

    from comprox_tpu.models import ppm

    # ---- decoder-known context features, on the full [T, S] grids
    is_m_grid = (g["sym_a"] == ppm.SYM_MATCH) & cod
    T = cod.shape[0]
    # lane-local recency: steps since this lane's last MATCH (capped 15)
    rec = np.full((T, S), 15, np.int64)
    since = np.full(S, 15, np.int64)
    for t in range(T):
        rec[t] = since
        since = np.where(is_m_grid[t], 0, np.minimum(since + 1, 15))
    # global: matches in the previous step across lanes
    prevstep = np.zeros((T, S), np.int64)
    prevstep[1:] = is_m_grid[:-1].sum(axis=1)[:, None]

    sym = g["sym_a"][cod]
    tot = g["tot"][cod]
    f_hit, f_hit2 = g["f_hit"][cod], g["f_hit2"][cod]
    f_m = g["f_match"][cod]
    conf = np.clip(g["conf"][cod], 0, 3)
    p1c = np.minimum(g["p1"][cod], 255) // 64
    recq = np.digitize(rec[cod], [1, 2, 4, 8])  # 5 classes: 0,1,2-3,4-7,8+
    gq = np.digitize(prevstep[cod], [1, 8, 32])  # 0,1-7,8-31,32+

    tt, ss = np.nonzero(cod)
    order = np.argsort(tt * S + ss, kind="stable")

    is_match = sym == ppm.SYM_MATCH
    is_hit = sym == ppm.SYM_HIT

    def run(name, ctxs, f_flag, h_flag, rest):
        """Exact-cost delta of reshaping ``f_flag``'s slot under an APM
        keyed on each context (bits; negative = saves)."""
        p_prim = np.clip(f_flag / np.maximum(rest, 1), 1 / 4096, 4095 / 4096)
        for cname, ctx in ctxs.items():
            apm = APM(int(ctx.max()) + 1)
            p_sse = np.empty_like(p_prim)
            p_sse[order] = apm.apply_seq(ctx[order], p_prim[order], h_flag[order])
            f_new = reshape_freq(f_flag, np.maximum(rest, 1), p_sse)
            tot_new = tot - f_flag + f_new
            # delta = sum log2(tot'/tot) over all events + correction for
            # flag events: log2(tot'/f') - log2(tot/f) - log2(tot'/tot)
            dm = (
                np.log2(tot_new[h_flag] / f_new[h_flag])
                - np.log2(tot[h_flag] / np.maximum(f_flag[h_flag], 1))
                - np.log2(tot_new[h_flag] / tot[h_flag])
            ).sum()
            d = np.log2(tot_new / tot).sum() + dm
            print(
                f"  {name}|{cname:20s} {d:+12,.0f} bits "
                f"({d / bits['A']:+.2%} of A, {d / total:+.2%} of total)"
            )

    print(f"match events {is_match.sum()}, hit {is_hit.sum()}, of {sym.size}")
    rest_m = np.maximum(tot - f_hit - f_hit2, 1)
    if MODE == "X":
        mctxs = {
            "none": np.zeros(sym.size, np.int64),
            "conf": conf,
            "rec": recq,
            "conf_x_rec": conf * 5 + recq,
            "rec_x_gq": recq * 4 + gq,
            "conf_x_rec_x_gq": (conf * 5 + recq) * 4 + gq,
            "p1_x_rec": p1c * 5 + recq,
        }
    elif MODE == "R":
        avail = (g["fill"][cod] > 0).astype(np.int64)
        fillc = np.where(
            avail > 0, np.clip((g["fill"][cod] - 1) // 16, 0, 3) + 1, 0
        )
        mctxs = {
            "fillq_x_conf (rev7)": fillc * 4 + conf,
            "fillq_x_conf_x_p1": (fillc * 4 + conf) * 4 + p1c,
            "fillq_x_conf_x_rec": (fillc * 4 + conf) * 5 + recq,
        }
    else:  # P: LZP candidate availability (decoder-known) is the key
        avail = (g["fill"][cod] > 0).astype(np.int64)
        mctxs = {
            "none": np.zeros(sym.size, np.int64),
            "avail": avail,
            "avail_x_conf": avail * 4 + conf,
            "avail_x_p1": avail * 4 + p1c,
            "avail_x_conf_x_p1": (avail * 4 + conf) * 4 + p1c,
            "avail_x_conf_x_rec": (avail * 4 + conf) * 5 + recq,
        }
    run("match", mctxs, f_m, is_match, rest_m)
    m = conf > 0
    # hit flag: reshape applies only where conf > 0 (like mode R rev 7).
    # Emulate by running the APM on the masked subset with rest = tot.
    def run_masked(name, ctxs):
        p_prim = np.clip(f_hit / np.maximum(tot, 1), 1 / 4096, 4095 / 4096)
        for cname, ctx in ctxs.items():
            apm = APM(int(ctx.max()) + 1)
            p_sse = p_prim.copy()
            sub = order[m[order]]
            p_sse[sub] = apm.apply_seq(ctx[sub], p_prim[sub], is_hit[sub])
            f_new = np.where(m, reshape_freq(f_hit, np.maximum(tot, 1), p_sse), f_hit)
            tot_new = tot - f_hit + f_new
            dm = (
                np.log2(tot_new[is_hit] / f_new[is_hit])
                - np.log2(tot[is_hit] / np.maximum(f_hit[is_hit], 1))
                - np.log2(tot_new[is_hit] / tot[is_hit])
            ).sum()
            d = np.log2(tot_new / tot).sum() + dm
            print(
                f"  {name}|{cname:20s} {d:+12,.0f} bits "
                f"({d / bits['A']:+.2%} of A, {d / total:+.2%} of total)"
            )

    # ---- escape flag among the post-hit/match rest mass (the o2 row's
    # PPMX-estimated escape slot is the third structural flag; an APM on
    # it has no interaction with the hit/match stages above because the
    # exact-cost delta composes the same way)
    f_esc = g["f_esc"][cod]
    rest_e = np.maximum(tot - f_hit - f_hit2 - f_m, 1)
    is_esc = sym == 257  # ppm.SYM_ESC
    totq = np.digitize(tot, [2048, 8192, 20000])  # o2 maturity class
    ectxs = {
        "none": np.zeros(sym.size, np.int64),
        "totq": totq,
        "totq_x_p1": totq * 4 + p1c,
        "totq_x_conf": totq * 4 + conf,
        "p1f": np.minimum(g["p1"][cod], 255) // 16,
    }
    run("esc  ", ectxs, f_esc, is_esc, rest_e)

    hctxs = {
        "conf": conf - 1,
        "conf_x_rec": (conf - 1) * 5 + recq,
        "conf_x_p1": (conf - 1) * 4 + p1c,
        "conf_x_p1f": (conf - 1) * 16 + np.minimum(g["p1"][cod], 255) // 16,
    }
    if MODE in ("R", "P"):
        avail = (g["fill"][cod] > 0).astype(np.int64)
        hctxs["conf_x_avail (rev7)"] = (conf - 1) * 2 + avail
        hctxs["conf_x_avail_x_p1"] = ((conf - 1) * 2 + avail) * 4 + p1c
    run_masked("hit ", hctxs)


if __name__ == "__main__":
    main()
