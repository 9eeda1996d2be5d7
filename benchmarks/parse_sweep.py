"""Sweep the parse price constants (CPX_PARSE_*) for one codec on CPU.

Each config runs in a subprocess (the knobs are read at import time).
Sizes come from the full container path (dictionary + filters order is
the bench's), so deltas transfer to the bench corpus.

Usage: python benchmarks/parse_sweep.py crz [MB]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import io, json, sys
from comprox_tpu.cli.main import make_params
from comprox_tpu.codec import container
from bench import build_corpus
mb = float(sys.argv[2])
data = build_corpus(int(mb * 1048576))
cp = make_params(sys.argv[1], {"lanes": 256, "block_mb": mb})
buf = io.BytesIO()
csize = container.encode_stream(data, buf, cp)
print(json.dumps({"bpb": csize * 8 / data.size}))
"""


def run(codec: str, mb: float, env_over: dict) -> float:
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    env.update({k: str(v) for k, v in env_over.items()})
    r = subprocess.run(
        [sys.executable, "-c", CHILD, codec, str(mb)],
        capture_output=True, text=True, env=env, cwd="/root/repo",
    )
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)["bpb"]
    raise RuntimeError(r.stderr[-2000:])


def main() -> None:
    codec = sys.argv[1] if len(sys.argv) > 1 else "crz"
    mb = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    base = run(codec, mb, {})
    print(f"baseline {codec} {mb:g}MiB: {base:.4f} bpb", flush=True)
    if codec == "crz":
        grid = [
            {"CPX_PARSE_LIT_R": lit, "CPX_PARSE_RM": rm, "CPX_PARSE_RI": ri}
            for lit in (14, 18, 22)
            for rm in (40, 50, 60)
            for ri in (4, 6)
        ]
    else:
        grid = [
            {"CPX_PARSE_LIT_X": lit, "CPX_PARSE_XM": xm, "CPX_PARSE_XK": xk}
            for lit in (10, 14, 18)
            for xm in (45, 55, 65)
            for xk in (4, 5, 6)
        ]
    results = []
    for cfg in grid:
        bpb = run(codec, mb, cfg)
        results.append((bpb, cfg))
        mark = " <-- better" if bpb < base else ""
        print(f"{cfg}: {bpb:.4f}{mark}", flush=True)
    results.sort()
    print("BEST:", results[0], flush=True)


if __name__ == "__main__":
    main()
