"""Command-line frontends — comprox-compatible UX.

Mirrors the reference frontends (/root/reference/src/roxmain/main.c:38-119
etc.): mode ``e``/``d``, ``-b<MB>`` block size, ``-F`` content filters,
``-p`` dictionary-precompress only, ``-q`` quiet, plus the same stderr
stats the reference prints (src/main.c:318-329): encode speed, cost time,
compression ratio, bits-per-byte.

Three entry points, one per codec family (the reference builds three
binaries from one core, Makefile:14-27):

    python -m comprox_tpu.cli.main  crp ...   # LZP codec   (~comprop)
    python -m comprox_tpu.cli.main  crx ...   # LZ77 codec  (~comprox)
    python -m comprox_tpu.cli.main  crz ...   # ROLZ codec  (~comprolz)
    python -m comprox_tpu.cli.main  crf ...   # fast static-table codec
                                              # (no ref analogue)
"""

from __future__ import annotations

import sys
import time

import numpy as np

from comprox_tpu.codec.block import BlockParams
from comprox_tpu.codec.container import (
    ContainerParams,
    decode_stream,
    encode_stream,
)

USAGE = """\
usage: {prog} e|d <input> <output> [switches]   ('-' = stdin/stdout)
switches:
  -b<n>  block size in MB (default 16)
  -l<n>  lanes per block (default 256)
  -F     enable content filters
  -p     dictionary precompress only
  -q     quiet mode
  -j[n]  code blocks data-parallel over n (default: all) devices
  -g<n>  batch n blocks per device scan (single-chip block batching:
         vmap n blocks through one fused scan — per-step costs are
         dominated by fixed dispatch, so bytes/step scale nearly free)
  -m<n>  match search depth (ref -m match_limit; default 40 -> top-4
         bucket candidates probed per position)
  -f     flexible parsing: price-DP parse choosing literal vs any match
         truncation (ref roxmain -f; ON by default here — the DP is a
         cheap backward scan).  -f0 falls back to greedy+lazy parsing.
  -c     chain mode: carry the adaptive models across blocks (the
         reference's once-per-file model reset, src/main.c:174-206).
         Best ratio at multi-block sizes; encode AND decode become
         sequential over blocks (no -j/-g parallelism).  Decode
         auto-detects chained archives.
"""

CODEC_BYTE = {"crp": b"P", "crx": b"X", "crz": b"R", "crf": b"F"}


def parse_args(argv):
    prog = argv[0] if argv else "crp"
    args = [a for a in argv[1:] if a == "-" or not a.startswith("-")]
    switches = [a for a in argv[1:] if a != "-" and a.startswith("-")]
    opts = {"block_mb": 16, "lanes": 256, "filters": False, "quiet": False,
            "precomp": False, "jobs": 0, "group": 1, "window": 250,
            "depth": 40, "flexible": True, "chain": False,
            "chain_match": False}
    for s in switches:
        if s == "-c":
            opts["chain"] = True
        elif s == "-C":
            # chain mode v2 (crz): also carry the ROLZ bucket table and
            # the previous block's bytes — match reach spans two blocks
            opts["chain"] = True
            opts["chain_match"] = True
        elif s.startswith("-b"):
            opts["block_mb"] = float(s[2:])
        elif s.startswith("-l"):
            opts["lanes"] = int(s[2:])
        elif s == "-F":
            opts["filters"] = True
        elif s == "-p":
            opts["precomp"] = True
        elif s == "-q":
            opts["quiet"] = True
        elif s.startswith("-j"):
            opts["jobs"] = int(s[2:] or "0") or -1
        elif s.startswith("-g"):
            opts["group"] = max(1, int(s[2:] or "1"))
        elif s.startswith("-f"):
            opts["flexible"] = s[2:] != "0"
        elif s.startswith("-m"):
            # reference match_limit (chain-walk depth, roxmain/main.c:98-102)
            # maps to our probed-candidate count: depth 40 ~ top-4
            opts["depth"] = max(1, int(s[2:] or "40"))
        else:
            raise SystemExit(USAGE.format(prog=prog))
    if len(args) != 3 or args[0] not in ("e", "d"):
        raise SystemExit(USAGE.format(prog=prog))
    return prog, args[0], args[1], args[2], opts


def make_params(codec_name: str, opts) -> ContainerParams:
    lanes = opts["lanes"]
    cap = int(opts["block_mb"] * 1048576)
    mode = {"crz": "R", "crx": "X", "crf": "F"}.get(codec_name, "P")
    if mode in ("X", "F"):
        # distance code space caps 'X' blocks at 16 MiB (block.py); the
        # reference likewise fixes cr_split_size at 16 MiB (src/main.c:62)
        cap = min(cap, 1 << 24)
    steps = max(1, cap // lanes)
    # ref match_min: lzp 4 (ropmain), rolz 5, lz77 ~10 (roxmain cr-coder.c:192)
    bp = BlockParams(
        lanes=lanes,
        steps=steps,
        mode=mode,
        # ref match_min: lzp 4 (ropmain), rolz 5; lz77 takes match_min_near
        # = 6 (roxmain cr-matcher.c:35) — the price-DP parse only accepts
        # short near matches when they out-earn literals, so the format
        # floor can sit at the reference's short-match minimum
        min_len={"P": 4, "R": 5, "X": 6, "F": 6}[mode],
        window=opts.get("window", 250),
        top_k=max(1, min(8, round(opts.get("depth", 40) / 10))),
        flexible=opts.get("flexible", True),
        # 4-byte ROLZ contexts for large blocks (reference rule: rolzmain/
        # cr-matcher.c:38-42; measured -2.5% bpb on 8MiB doc text).  'X'
        # uses the same rule for its encoder-private context-keyed
        # candidate table (distances are coded, so it is not format-
        # relevant there)
        rolz_ctx_bytes=4 if (mode in ("R", "X") and cap >= 4 * 1048576)
        else 3,
        # insert decimation: measured ratio-POSITIVE at 8MiB (0.4168 vs
        # 0.4225 bpb) — halved insert pressure keeps bucket entries alive
        # longer under the recency-replacement rule — and cheaper inserts
        rolz_dec=2 if mode == "R" else 1,
        # ROLZ short-match table: measured ratio-NEGATIVE on 8MiB doc text
        # (0.4435-0.4440 vs 0.4428 without, at CPX_SHORT_EXTRA 2 and 5) and
        # ~35% slower — the reference's win (rolzmain/cr-matcher.c:165-179)
        # does not transfer to shared-model lanes, where short-idx symbols
        # price high and steal o2/o3 training bytes.  Capability kept
        # (format + tests), default off.
        short_depth=0,
        chain_match=opts.get("chain_match", False),
    )
    return ContainerParams(codec=CODEC_BYTE.get(codec_name, b"P"), block=bp)


def log(quiet, msg):
    if not quiet:
        print(msg, file=sys.stderr)


def run(codec_name: str, argv) -> int:
    from comprox_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    prog, mode, inp, outp, opts = parse_args([codec_name] + list(argv))
    quiet = opts["quiet"]
    from comprox_tpu.utils.profiling import Progress

    meter = Progress(enabled=not quiet)
    t0 = time.time()
    if mode == "e":
        if inp == "-":
            data = np.frombuffer(sys.stdin.buffer.read(), np.uint8)
        else:
            data = np.fromfile(inp, np.uint8)
        cp = make_params(codec_name, opts)
        mesh = None
        if opts["jobs"]:
            import jax
            from comprox_tpu.parallel.mesh import make_mesh

            nd = len(jax.devices())
            mesh = make_mesh(None if opts["jobs"] < 0 else min(opts["jobs"], nd))
        f = sys.stdout.buffer if outp == "-" else open(outp, "wb")
        try:
            csize = encode_stream(
                data, f, cp, filters=opts["filters"], mesh=mesh,
                group=opts["group"], precomp_only=opts["precomp"],
                chain=opts["chain"], progress=meter.update,
            )
        finally:
            if outp != "-":
                f.close()
        dt = max(time.time() - t0, 1e-9)
        # same per-run stats as the reference driver (src/main.c:318-329)
        log(quiet, f"encode-speed: {data.size / dt / 1e6:.2f} MB/s")
        log(quiet, f"cost-time:    {dt:.3f} s")
        if data.size:
            log(quiet, f"compress-ratio: {csize / data.size:.4f}")
            log(quiet, f"bits-per-byte:  {csize * 8 / data.size:.3f}")
    else:
        mesh = None
        if opts["jobs"]:
            import jax
            from comprox_tpu.parallel.mesh import make_mesh

            nd = len(jax.devices())
            mesh = make_mesh(None if opts["jobs"] < 0 else min(opts["jobs"], nd))
        import io as _io

        f = (
            _io.BytesIO(sys.stdin.buffer.read())
            if inp == "-"
            else open(inp, "rb")
        )
        g = sys.stdout.buffer if outp == "-" else open(outp, "wb")
        try:
            total = decode_stream(f, g, mesh=mesh, group=opts["group"])
        finally:
            if inp != "-":
                f.close()
            if outp != "-":
                g.close()
        dt = max(time.time() - t0, 1e-9)
        log(quiet, f"decode-speed: {total / dt / 1e6:.2f} MB/s")
        log(quiet, f"cost-time:    {dt:.3f} s")
    return 0


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] in CODEC_BYTE:
        return run(argv[0], argv[1:])
    return run("crp", argv)


if __name__ == "__main__":
    raise SystemExit(main())
