"""A/B the speculative chain-encode pipelining (VERDICT r3 #4).

Times chained crz encode at the official block geometry with the
speculation on (default) vs off (CPX_CHAIN_SPEC=0 = the round-3
sequential behavior), asserts the
archives are byte-identical, and prints both rates.

Usage: python benchmarks/chain_ab.py [MB] [BLOCK_MB] [LANES]
"""

from __future__ import annotations

import io
import os
import sys
import time


def main() -> None:
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 32.0
    block_mb = float(sys.argv[2]) if len(sys.argv) > 2 else 8.0
    lanes = int(sys.argv[3]) if len(sys.argv) > 3 else 512

    from comprox_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec import container
    from bench import build_corpus

    cp = make_params("crz", {"lanes": lanes, "block_mb": block_mb})
    data = build_corpus(int(mb * 1048576))

    # warmup compile (both A and B share the same jitted scans)
    warm = data[: cp.block.capacity]
    buf = io.BytesIO()
    container.encode_stream(warm, buf, cp, chain=True)
    buf.seek(0)
    out = io.BytesIO()
    container.decode_stream(buf, out)
    assert out.getvalue() == warm.tobytes(), "warmup round trip failed"

    archives = {}
    for spec in ("1", "0"):
        os.environ["CPX_CHAIN_SPEC"] = spec
        t0 = time.time()
        buf = io.BytesIO()
        csize = container.encode_stream(data, buf, cp, chain=True)
        enc_s = time.time() - t0
        archives[spec] = buf.getvalue()
        label = "spec-on " if spec == "1" else "spec-off"
        print(
            f"chain {label}: enc {data.size / enc_s / 1e6:.3f} MB/s, "
            f"{csize * 8 / data.size:.4f} bpb",
            flush=True,
        )
    assert archives["1"] == archives["0"], "A/B archives differ!"
    buf = io.BytesIO(archives["1"])
    out = io.BytesIO()
    t0 = time.time()
    container.decode_stream(buf, out)
    dec_s = time.time() - t0
    assert out.getvalue() == data.tobytes(), "ROUND TRIP FAILED"
    print(
        f"archives identical; chained decode {data.size / dec_s / 1e6:.3f}"
        " MB/s",
        flush=True,
    )


if __name__ == "__main__":
    main()
