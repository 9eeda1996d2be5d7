"""Golden archives and the card-marked tests.

The codec is integer arithmetic, so an archive's bytes do not depend on the
backend: ``GOLDEN_SHA256`` pins them on the CPU here and on the GPU in the
``gpu``-marked tests, which ``chip_smoke.py`` runs on the card (they skip
elsewhere).  A failing golden on the CPU means the format drifted; on the
GPU alone, a backend-dependent operation (an inexact dot, an unstable sort,
a non-commutative scatter) reached the codec.
"""

import hashlib
import io

import numpy as np
import pytest

from comprox_tpu.utils.corpus import (
    GOLDEN_SHA256,
    MD5,
    golden_archive,
    markov_text,
)

CODECS = ("crz", "crx", "crp", "crf")


@pytest.fixture(scope="module")
def card():
    """The GPU the card-marked tests run on; skips without one."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
    from comprox_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    return jax.devices()[0]


def test_corpus_md5_pinned():
    data = markov_text(64 << 10)
    assert hashlib.md5(data).hexdigest() == MD5[64 << 10]
    # prefix-consistent: a larger corpus starts with the smaller one
    np.testing.assert_array_equal(markov_text(80 << 10)[: 64 << 10], data)


@pytest.mark.parametrize("codec", CODECS)
def test_golden_archive(codec):
    digest = hashlib.sha256(golden_archive(codec)).hexdigest()
    assert digest == GOLDEN_SHA256[codec]


@pytest.mark.gpu
@pytest.mark.parametrize("codec", CODECS)
def test_golden_archive_on_card(card, codec):
    digest = hashlib.sha256(golden_archive(codec)).hexdigest()
    assert digest == GOLDEN_SHA256[codec], f"{codec} archive differs on {card}"


@pytest.mark.gpu
@pytest.mark.parametrize("codec", CODECS)
def test_production_round_trip_on_card(card, codec):
    """One block at the production geometry (-b8 -l512: S=512, T=16384,
    full-width tables) round-trips bit-exact on the card; the rANS drain
    check inside decode is the corruption detector."""
    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import decode_stream, encode_stream

    data = markov_text(1 << 20, seed=2)
    cp = make_params(codec, {"lanes": 512, "block_mb": 8})
    assert (cp.block.lanes, cp.block.steps) == (512, 16384)
    buf = io.BytesIO()
    encode_stream(data, buf, cp)
    buf.seek(0)
    out = io.BytesIO()
    decode_stream(buf, out)
    assert out.getvalue() == data.tobytes()
