"""Smoke run of comprox_tpu on the GPU: every codec end to end, checked.

    python chip_smoke.py             # one card
    python chip_smoke.py --multi     # four cards: crz -j4 against one device
    python chip_smoke.py --rehearse  # CPU at tiny sizes: control flow only

One card: the ``gpu``-marked tests run first in a child process (before
this process opens the card: a JAX process reserves most of the card's
memory), then each codec encodes a pinned seeded corpus through
``container.encode_stream`` / ``decode_stream`` at the production geometry
(-b8 -l512: S=512 lanes, T=16384 steps, full-width o3 and ROLZ tables) and
must round-trip bit-exact, and four golden archives must come out with the
sha256 digests the CPU tests pin (zero tolerance: the codec is integer
arithmetic).  ``--multi`` runs only the four-card path: crz -j4 over a 1-D
mesh must write the same archive as one device and decode bit-exact.

Each phase prints one line with the card's name and power limit, the
seconds JAX spent compiling (first call; a warm persistent cache turns this
into load time), encode and decode MB/s over the wall time minus those
seconds, bpb, the archive sha256 and the device's peak_bytes_in_use.  The
last line is the JSON result; it is printed only when every phase passed.
Without a GPU the script exits non-zero (``--rehearse`` runs on the CPU and
never reports a GPU).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# (name, codec, MiB of corpus, chain mode v2): the production phases
PHASES = (
    ("crz", "crz", 16, False),
    ("crf", "crf", 16, False),
    ("crx", "crx", 8, False),
    ("crp", "crp", 8, False),
    ("crz -C", "crz", 16, True),
)
MULTI_MIB = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run_card_tests(rehearse: bool) -> str:
    """The gpu-marked tests, in a child process with the backend left
    alone; on the card all of them must pass (none may skip)."""
    env = dict(os.environ, CPX_TEST_ON_CARD="1", PYTHONPATH=str(REPO))
    if rehearse:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
            "-p", "no:cacheprovider",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    passed = re.search(r"(\d+) passed", summary)
    n_passed = int(passed.group(1)) if passed else 0
    if rehearse:
        ok = r.returncode in (0, 5) and "failed" not in summary
    else:
        ok = r.returncode == 0 and n_passed > 0 and "skipped" not in summary
    if not ok:
        print(r.stdout[-4000:], r.stderr[-4000:], sep="\n", file=sys.stderr)
        fail(f"card tests: {summary or 'no summary'}")
    return summary


class CompileClock:
    """Seconds XLA spends compiling, or loading compiled programs from the
    persistent cache (JAX's own monitoring events), and how many times."""

    EVENTS = (
        "/jax/core/compile/backend_compile_duration",
        "/jax/compilation_cache/cache_retrieval_time_sec",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, secs: float, **_kw) -> None:
        if event in self.EVENTS:
            self.total += secs
            self.count += event == self.EVENTS[0]


def peak_bytes(device) -> int | None:
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def timed(clock, fn):
    """(result, wall seconds, compile seconds, compilations) of fn()."""
    c0, n0, t0 = clock.total, clock.count, time.time()
    out = fn()
    return out, time.time() - t0, clock.total - c0, clock.count - n0


def phase_line(card: str, name: str, **fields) -> str:
    parts = [f"phase {name!r}", f"card {card!r}"]
    for k, v in fields.items():
        parts.append(f"{k}={v}")
    return " ".join(parts)


def round_trip(data, cp, chain: bool = False, mesh=None):
    """(archive, encode seconds, decode seconds); raises unless the decoded
    bytes equal the input."""
    from comprox_tpu.codec.container import decode_stream, encode_stream

    enc = io.BytesIO()
    t0 = time.time()
    encode_stream(data, enc, cp, chain=chain, mesh=mesh)
    t1 = time.time()
    out = io.BytesIO()
    decode_stream(io.BytesIO(enc.getvalue()), out, mesh=mesh)
    t2 = time.time()
    if out.getvalue() != data.tobytes():
        raise AssertionError("decoded bytes differ from the input")
    return enc.getvalue(), t1 - t0, t2 - t1


def codec_phase(card, clock, device, name, codec, data, opts, chain):
    """First call on one short block (compiles every program of the
    geometry: a short block still runs all T steps), then the timed round
    trip of the whole input."""
    from comprox_tpu.cli.main import make_params

    cp = make_params(codec, opts)
    _, first_s, comp_s, n_comp = timed(
        clock, lambda: round_trip(data[: 64 << 10], cp, chain)
    )
    (archive, enc_s, dec_s), _, late_s, n_late = timed(
        clock, lambda: round_trip(data, cp, chain)
    )
    return phase_line(
        card, name,
        bytes=data.size,
        lanes=cp.block.lanes,
        steps=cp.block.steps,
        first_call_s=first_s,
        compile_s=comp_s,
        compiles=n_comp,
        enc_MBps=data.size / enc_s / 1e6,
        dec_MBps=data.size / dec_s / 1e6,
        compiles_in_timed_run=n_late,
        bpb=len(archive) * 8 / data.size,
        sha256=hashlib.sha256(archive).hexdigest(),
        peak_bytes_in_use=peak_bytes(device),
        round_trip="bit-exact",
    )


def golden_phase(card, clock, codec):
    from comprox_tpu.utils.corpus import GOLDEN_SHA256, golden_archive

    archive, wall, comp, _ = timed(clock, lambda: golden_archive(codec))
    digest = hashlib.sha256(archive).hexdigest()
    if digest != GOLDEN_SHA256[codec]:
        raise AssertionError(
            f"{codec} golden archive differs: {digest} != "
            f"{GOLDEN_SHA256[codec]}"
        )
    return phase_line(
        card, f"golden {codec}", compile_s=comp, wall_s=wall,
        sha256=digest, matches_cpu_golden=True,
    )


def multi_phase(card, clock, data, opts):
    """crz -j4 over a 4-device mesh against one device, same process: the
    archives must be identical, and -j4 must decode bit-exact.  Each call
    is a first call (its compile seconds are reported beside it)."""
    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import encode_stream
    from comprox_tpu.parallel.mesh import make_mesh

    cp = make_params("crz", opts)
    one = io.BytesIO()
    _, enc1_s, comp1_s, _ = timed(clock, lambda: encode_stream(data, one, cp))
    mesh = make_mesh(4)
    (four, enc4_s, dec4_s), _, comp4_s, _ = timed(
        clock, lambda: round_trip(data, cp, mesh=mesh)
    )
    if four != one.getvalue():
        raise AssertionError("-j4 archive differs from the one-device archive")
    return phase_line(
        card, "crz -j4",
        bytes=data.size,
        blocks=-(-data.size // cp.block.capacity),
        one_device_enc_s=enc1_s,
        one_device_compile_s=comp1_s,
        j4_enc_s=enc4_s,
        j4_dec_s=dec4_s,
        j4_compile_s=comp4_s,
        bpb=len(four) * 8 / data.size,
        sha256=hashlib.sha256(four).hexdigest(),
        same_archive_as_one_device=True,
        round_trip="bit-exact",
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card crz -j4 path")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU at tiny sizes (checks control flow only)")
    args = ap.parse_args()
    if not (REPO / "comprox_tpu" / "__init__.py").is_file():
        fail(f"no comprox_tpu package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))

    from comprox_tpu.utils import native
    from comprox_tpu.utils.corpus import MD5, markov_text
    from comprox_tpu.utils.profiling import card_info

    card = "none (rehearsal on the CPU)"
    if not args.rehearse:
        try:
            card = card_info()
        except (OSError, subprocess.SubprocessError) as e:
            fail(f"nvidia-smi failed: {e!r}")
    print(f"card: {card}", flush=True)

    if native.get_lib() is None:
        fail("native library did not build (cc missing?)")
    # production geometry; the rehearsal shrinks lanes, blocks and corpus
    # (never on the card)
    scale = 128 if args.rehearse else 1
    opts = {"lanes": 64 if args.rehearse else 512, "block_mb": 8 / scale}
    big = (MULTI_MIB if args.multi else 16) << 20
    corpus = markov_text(big)
    for n in (8 << 20, 16 << 20, big):
        digest = hashlib.md5(corpus[:n]).hexdigest()
        if digest != MD5[n]:
            fail(f"corpus md5 {digest} != pinned {MD5[n]} at {n} bytes")
    print(f"corpus: {big} bytes md5 {MD5[big]}", flush=True)

    if not args.multi:
        print(f"card tests: {run_card_tests(args.rehearse)}", flush=True)

    if args.multi and args.rehearse:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4"
        )
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    devs = jax.devices()
    want = "cpu" if args.rehearse else "gpu"
    if devs[0].platform != want:
        fail(f"JAX found {devs[0].platform}, not {want}")
    if args.multi and len(devs) < 4:
        fail(f"--multi needs 4 devices, JAX found {len(devs)}")
    print(
        f"devices: {len(devs)} x {devs[0].device_kind} ({devs[0].platform})",
        flush=True,
    )

    from comprox_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    clock = CompileClock()
    failed = []

    def run(name, fn):
        try:
            print(fn(), flush=True)
        except Exception as e:  # noqa: BLE001 - report every phase
            failed.append(name)
            print(f"phase {name!r} card {card!r} FAILED: {e!r}", flush=True)

    if args.multi:
        n = (MULTI_MIB << 20) // scale
        run("crz -j4", lambda: multi_phase(card, clock, corpus[:n], opts))
    else:
        for codec in ("crz", "crx", "crp", "crf"):
            run(f"golden {codec}",
                lambda c=codec: golden_phase(card, clock, c))
        for name, codec, mib, chain in PHASES:
            n = (mib << 20) // scale
            run(name, lambda: codec_phase(
                card, clock, devs[0], name, codec, corpus[:n],
                dict(opts, chain_match=chain), chain,
            ))
    if failed:
        fail(f"failed phases: {failed}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
