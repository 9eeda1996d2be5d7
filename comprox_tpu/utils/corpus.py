"""Seeded text corpus for smoke runs and golden archives.

An order-1 word-level Markov chain trained on ``SURVEY.md`` emits
English-like text with markdown and code identifiers (the content class of
the reference's doc-text benchmark).  Sampling is driven by the raw PCG64
output stream, which numpy keeps stable across versions, so the bytes
depend only on the seed and the training text: the same corpus is rebuilt
on any machine that holds a checkout of this repo.

``SURVEY.md`` is history and is not edited; a change to it changes every
digest pinned against this corpus (``chip_smoke.py``, tests/test_golden.py).
The corpus is prefix-consistent: ``markov_text(n)`` is the first n bytes of
``markov_text(m)`` for any m >= n with the same seed.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

TRAIN_FILE = Path(__file__).resolve().parents[2] / "SURVEY.md"
_CHUNK = 1 << 16  # raw draws fetched per refill

# md5 of markov_text(n, seed=0) for the sizes the smoke runs and tests use
MD5 = {
    64 << 10: "264492e30f9d38a61c5ddc06003973ce",
    8 << 20: "88d551846a2c3531e3dff9fec179d3d3",
    16 << 20: "a78ae5bd4174664611e592919da81fff",
    32 << 20: "fed9a041b21af15a780d5f6590f6e520",
}

# Golden archives: each codec encodes GOLDEN_BYTES of seed-1 text at S=512
# lanes with production table widths in one 1 MiB block (T=2048 steps; the
# dictionary on).  The sha256 of the archive pins the format on every
# backend: the codec is integer arithmetic, so the CPU and the GPU must
# produce the same bytes.  (Shorter blocks compile far slower on the GPU:
# S=512 x T=512 took 13 minutes for crz encode, T=2048 about 2.)
GOLDEN_SEED = 1
GOLDEN_BYTES = 512 << 10
GOLDEN_BLOCK_MB = 1
GOLDEN_SHA256 = {
    "crz": "eb421b0ff39a008920b915a6da140acad4b3e93b84f3792120a082aef2087af0",
    "crx": "30e4b263e4f20ef9e5e127c772b53ff1e27393f95d982bee6ebbfbd34697e062",
    "crp": "09a762c0a414a11350bbd790d49dcc96e1ee9f0ef37795b4b64518292c733bf7",
    "crf": "4a79d3151cfb61f22e7bd07b7f680fa09e68fd8b7e5df26572e1130e1c4f9b89",
}


def golden_archive(codec: str) -> bytes:
    """The archive whose sha256 GOLDEN_SHA256[codec] pins, made on the
    default backend."""
    import io

    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import encode_stream

    buf = io.BytesIO()
    encode_stream(
        markov_text(GOLDEN_BYTES, GOLDEN_SEED),
        buf,
        make_params(codec, {"lanes": 512, "block_mb": GOLDEN_BLOCK_MB}),
    )
    return buf.getvalue()


def markov_text(n_bytes: int, seed: int = 0) -> np.ndarray:
    """``n_bytes`` of seeded Markov text as a uint8 array."""
    toks = re.findall(rb"\S+\s*", TRAIN_FILE.read_bytes())
    # successors of a token = the tokens that follow its occurrences in the
    # training text; the last token wraps to the first
    word = [t.strip() for t in toks]
    ids: dict = {}
    for w in word:
        ids.setdefault(w, len(ids))
    wid = [ids[w] for w in word]
    succ: list = [[] for _ in ids]
    for i, w in enumerate(wid):
        succ[w].append((i + 1) % len(toks))
    bitgen = np.random.PCG64(seed)
    out = []
    total = 0
    pos = 0
    while total < n_bytes:
        for r in bitgen.random_raw(_CHUNK).tolist():
            nxt = succ[wid[pos]]
            pos = nxt[r % len(nxt)]
            out.append(toks[pos])
            total += len(toks[pos])
            if total >= n_bytes:
                break
    return np.frombuffer(b"".join(out)[:n_bytes], np.uint8).copy()
