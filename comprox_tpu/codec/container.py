"""Container format + file driver.

Data-parallel re-architecture of the reference file driver (richox/comprox
src/main.c:89-305): magic header, optional dictionary blob, then a sequence of
independently coded blocks with per-block headers and a stored-block
fallback (roxmain/cr-coder.c:273-275).  One deliberate format change vs the
reference (SURVEY.md §5 checkpoint/resume): model state resets **per block**,
making every block an independently decodable unit — this is what unlocks
block-level data parallelism across a device mesh and restartable decode.

Layout (all little-endian):

    magic    8B   b"CPXTPU02" (trailing digits = stream-format revision)
    codec    1B   b'P' (LZP) / b'X' (LZ77) / b'R' (ROLZ)
    flags    1B   bit0: dictionary present, bit1: filters enabled
    lanes    2B   u16  S
    steps    4B   u32  T   (block capacity = S*T bytes)
    ...per-geometry BlockParams fields, then:
    knobs    4B   u32  CRC32 of the format-relevant model constants
    hdrcrc   4B   u32  CRC32 of codec..knobs (a flipped geometry bit
                       fails loudly instead of decoding garbage)
    [dict blob: u32 raw_len + u32 coded_len + u32 crc(raw) + payload]
        (if flags bit0; coded_len == 0 -> raw_len stored bytes follow,
         else coded_len bytes of order-1+rANS coded blob)
    repeat:
        raw_n    4B   u32  raw bytes in this block (0 terminates)
        blen     4B   u32  payload length
        bflags   1B   bit0: stored (raw bytes follow, uncoded)
                      bit1: filtered
                      bit2: dictionary-coded
        crc      4B   u32  CRC32 of payload
        payload  blen bytes
    end:
        raw_n=0 sentinel (full zero block header)

Failure detection is strictly stronger than the reference's (SURVEY.md §5:
magic check only): every byte of the archive is covered by a CRC or by the
rANS drain invariant, so single-bit corruption anywhere raises ValueError.
"""

from __future__ import annotations

import itertools
import os as _os
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator, Optional

import numpy as np

from comprox_tpu.codec.block import (
    BlockParams,
    decode_block,
    decode_block_chained_start,
    decode_block_finish,
    decode_block_start,
    encode_block,
    encode_block_chained_finish,
    encode_block_chained_start,
    encode_block_finish,
    encode_block_start,
    init_chain_tables,
)

# The trailing digits version the stream format: rev-3 grew _HDR_FMT and
# changed table arithmetic, so pre-rev archives must fail with a clear
# incompatible-version message, not a CRC mismatch indistinguishable from
# corruption (advisor finding, round 2).
MAGIC = b"CPXTPU02"
_OLD_MAGICS = (b"CPXTPU01",)
BF_STORED = 1
BF_FILTERED = 2
BF_DICT = 4
F_DICT = 1
F_FILTER = 2
F_CHAIN = 4  # PPM models carry over across blocks (the reference's
# once-per-file reset, src/main.c:174-206) — opt-in: trades independent
# block decode (mesh/group parallelism) for ratio at scale
F_CHAIN_MATCH = 8  # chain mode v2 (mode R): the ROLZ bucket table and
# the previous block's bytes carry over too — match reach spans two
# blocks, like the reference's split-wide matcher window (BlockParams.
# chain_match; implies F_CHAIN)


@dataclass(frozen=True)
class ContainerParams:
    codec: bytes = b"P"
    block: BlockParams = BlockParams()


_HDR_FMT = "<BHIBBBBBBBBI"  # flags + geometry + format-knobs fingerprint


def write_header(f: BinaryIO, cp: ContainerParams, flags: int = 0) -> None:
    from comprox_tpu.models.ppm import format_fingerprint

    b = cp.block
    body = cp.codec + struct.pack(
        _HDR_FMT,
        flags,
        b.lanes,
        b.steps,
        b.o3_bits,
        b.min_len,
        1 if b.match else 0,
        b.rolz_bits,
        b.rolz_depth,
        b.rolz_ctx_bytes,
        b.short_depth,
        b.rolz_dec,
        format_fingerprint(),
    )
    # header CRC: a flipped geometry bit must fail loudly, not decode with
    # wrong params into probabilistic drain-check garbage
    f.write(MAGIC + body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF))


HEADER_LEN = 8 + 1 + struct.calcsize(_HDR_FMT) + 4
BLKHDR = "<IIBI"  # raw_n, payload len, flags, payload CRC32
BLKHDR_LEN = struct.calcsize(BLKHDR)


def read_header(f: BinaryIO) -> tuple[ContainerParams, int]:
    from comprox_tpu.models.ppm import format_fingerprint

    magic = f.read(8)
    if magic != MAGIC:
        if magic in _OLD_MAGICS:
            raise ValueError(
                f"incompatible archive version {magic!r}: this build reads "
                f"{MAGIC!r} archives (the stream format changed)"
            )
        raise ValueError(f"bad magic {magic!r}: not a comprox_tpu archive")
    body = f.read(1 + struct.calcsize(_HDR_FMT))
    crc_raw = f.read(4)
    if len(body) < 1 + struct.calcsize(_HDR_FMT) or len(crc_raw) < 4:
        raise ValueError("truncated archive: short container header")
    if struct.unpack("<I", crc_raw)[0] != zlib.crc32(body) & 0xFFFFFFFF:
        raise ValueError("corrupt archive: container header CRC mismatch")
    codec = body[:1]
    (
        flags, lanes, steps, o3_bits, min_len, match, rolz_bits,
        rolz_depth, rolz_ctx_bytes, short_depth, rolz_dec, knobs_crc,
    ) = struct.unpack(_HDR_FMT, body[1:])
    if knobs_crc != format_fingerprint():
        raise ValueError(
            "archive was encoded with different model constants "
            "(CPX_* env knobs); decode in a matching environment"
        )
    if (flags & F_CHAIN_MATCH) and not (flags & F_CHAIN):
        # chain_match BlockParams only make sense on the chained decode
        # path; without this check a crafted/corrupt header with only
        # bit 8 set would die deep in decode_block_start with a raw
        # TypeError instead of failing clean here (ADVICE r4).
        raise ValueError("corrupt archive: F_CHAIN_MATCH without F_CHAIN")
    bp = BlockParams(
        lanes=lanes,
        steps=steps,
        mode={b"R": "R", b"X": "X", b"F": "F"}.get(codec, "P"),
        match=bool(match),
        min_len=min_len,
        o3_bits=o3_bits,
        rolz_bits=rolz_bits,
        rolz_depth=rolz_depth,
        rolz_ctx_bytes=rolz_ctx_bytes,
        short_depth=short_depth,
        rolz_dec=rolz_dec,
        chain_match=bool(flags & F_CHAIN_MATCH),
    )
    return ContainerParams(codec=codec, block=bp), flags


def _block_encoder(bp: BlockParams):
    """Per-mode block encoder (the static-table fast profile has its own
    passes; see codec/fast.py)."""
    if bp.mode == "F":
        from comprox_tpu.codec.fast import encode_block_fast

        return lambda blk: encode_block_fast(blk, bp)
    return lambda blk: encode_block(blk, bp)


def _block_encoder_async(bp: BlockParams):
    """(start, finish) pair for the pipelined sequential path: ``start``
    dispatches the device passes asynchronously, ``finish`` blocks on the
    results and packs the payload.  The stream loop keeps one block in
    flight so device compute overlaps the device->host result transfer."""
    if bp.mode == "F":
        from comprox_tpu.codec.fast import (
            encode_block_fast_finish,
            encode_block_fast_start,
        )

        return (
            lambda blk: encode_block_fast_start(blk, bp),
            encode_block_fast_finish,
        )
    return lambda blk: encode_block_start(blk, bp), encode_block_finish


def _block_decoder_async(bp: BlockParams):
    if bp.mode == "F":
        from comprox_tpu.codec.fast import (
            decode_block_fast_finish,
            decode_block_fast_start,
        )

        return (
            lambda payload, n: decode_block_fast_start(payload, n, bp),
            decode_block_fast_finish,
        )
    return (
        lambda payload, n: decode_block_start(payload, n, bp),
        decode_block_finish,
    )


def _block_decoder(bp: BlockParams):
    if bp.mode == "F":
        from comprox_tpu.codec.fast import decode_block_fast

        return lambda payload, n: decode_block_fast(payload, n, bp)
    return lambda payload, n: decode_block(payload, n, bp)


def iter_blocks(data: np.ndarray, capacity: int) -> Iterator[np.ndarray]:
    for off in range(0, data.size, capacity):
        yield data[off : off + capacity]


def encode_stream(
    src: np.ndarray,
    dst: BinaryIO,
    cp: ContainerParams,
    encode_fn: Optional[Callable] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    filters: bool = False,
    dictionary: bool = True,
    mesh=None,
    group: int = 1,
    precomp_only: bool = False,
    chain: bool = False,
) -> int:
    """Encode ``src`` into ``dst``; returns compressed byte count.

    With ``mesh`` set, blocks are coded data-parallel across the mesh in
    device-count groups (bit-identical payloads to the sequential path).
    With ``group`` > 1 (and no mesh), groups of ``group`` blocks are
    vmap-batched through one scan on the default device — the single-chip
    block-batching throughput path.
    ``precomp_only`` runs just the dictionary stage and stores the
    substituted bytes uncoded (the reference's -p, roxmain/main.c:77-82).
    ``chain`` carries the PPM models across blocks (the reference's
    once-per-file model reset, src/main.c:174-206) — mutually exclusive
    with mesh/group parallelism and with the static-table 'F' profile;
    stored-fallback blocks leave the chained models untouched (the
    decoder never models their bytes).  Under chain_match (crz -C) a
    stored block does not advance the carry AT ALL: the next coded
    block's previous-window buffer and bucket table still describe the
    last CODED block (cross-block matches reach over the stored gap
    into it), and the stored block's own bytes are never match
    sources.  Both sides replay this identically — no correctness
    issue, just forfeited reach around an incompressible block.
    """
    from comprox_tpu.codec import dictionary as dic

    if precomp_only:
        filters = False  # stored blocks carry no filter-span metadata
        chain = False  # no modeling happens at all
    if chain:
        if mesh is not None or group > 1:
            raise ValueError(
                "chain mode carries model state across blocks — "
                "incompatible with mesh/group block parallelism"
            )
        if cp.block.mode == "F" or encode_fn is not None:
            raise ValueError(
                "chain mode requires an adaptive-model codec (R/X/P)"
            )
    if cp.block.chain_match and not chain:
        raise ValueError("chain_match requires chain mode (encode chain=True)")

    # whole-file pass #1: build the word dictionary (src/main.c:158 ->
    # cr-dicpick.c); broadcast-equivalent: the blob rides the header
    wd = dic.build_dictionary(src) if dictionary else None
    flags = (
        (F_FILTER if filters else 0)
        | (F_DICT if wd else 0)
        | (F_CHAIN if chain else 0)
        | (F_CHAIN_MATCH if (chain and cp.block.chain_match) else 0)
    )
    write_header(dst, cp, flags=flags)
    written = HEADER_LEN
    if wd is not None:
        blob = dic.pack_dict(wd)
        # CRC over the RAW blob: guards both transport corruption and the
        # blob entropy coder itself (found by the corruption probe in
        # /verify).  The blob rides order-1+rANS coded (the reference
        # lz-encodes its dictionary, src/main.c:163-164); clen == 0 marks
        # a stored blob (incompressible pathological dictionaries).
        coded = dic.blob_encode(blob)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        if len(coded) < len(blob):
            dst.write(
                struct.pack("<III", len(blob), len(coded), crc) + coded
            )
            written += 12 + len(coded)
        else:
            dst.write(struct.pack("<III", len(blob), 0, crc) + blob)
            written += 12 + len(blob)

    # Blocks stream through in bounded groups (device-count-sized on a
    # mesh): stage -> code -> write, then the group's memory is released.
    # The reference buffers one block at a time (src/main.c:160-205); we
    # keep whole-archive memory bounded the same way so enwik9-class
    # inputs never hold every block's [T, n_slots, S] event grid at once.
    def stage(raw_blk):
        blk = raw_blk
        bflags = 0
        prefix = b""
        if filters:
            from comprox_tpu.ops import filters as flt

            spans = flt.detect_spans(blk)
            if spans:
                blk = flt.apply_spans(blk, spans, encode=True)
                prefix = flt.pack_spans(spans)
                bflags |= BF_FILTERED
        if wd is not None:
            sub = dic.dict_encode(blk, wd)
            if sub.size < blk.size and sub.size <= cp.block.capacity:
                blk = sub
                prefix += struct.pack("<I", sub.size)
                bflags |= BF_DICT
        return raw_blk, blk, prefix, bflags

    total = src.size
    done = 0
    if mesh is not None:
        group_n = int(mesh.devices.size)
        from comprox_tpu.parallel.mesh import encode_blocks_list
    elif group > 1:
        group_n = int(group)
        if cp.block.mode != "F":
            from comprox_tpu.parallel.mesh import encode_blocks_list
    else:
        group_n = 1
    blocks_it = iter_blocks(src, cp.block.capacity)
    chain_tables = init_chain_tables(cp.block) if chain else None
    # Producer/consumer overlap (SURVEY.md §2.5 P2, re-expressed): the
    # next group's host staging (filters + dictionary substitution, C
    # loops that release the GIL) runs on a worker thread while the
    # device codes the current group.
    from concurrent.futures import ThreadPoolExecutor

    def stage_group(raws):
        return [stage(raw) for raw in raws]

    def write_group(staged, payloads):
        """Returns True iff the LAST block written advanced the chain
        models (i.e. was not a stored fallback) — the chained pipeline
        keys its speculation check on this explicit flag."""
        nonlocal written, done, chain_tables
        advanced = False
        for (raw_blk, blk, prefix, bflags), coded in zip(staged, payloads):
            advanced = False
            if chain:
                coded, tables1 = coded
            payload = prefix + coded
            if len(payload) >= raw_blk.size:  # stored fallback
                payload, bflags = raw_blk.tobytes(), BF_STORED
            elif chain:
                chain_tables = tables1  # models advance past the block
                advanced = True
            dst.write(
                struct.pack(
                    BLKHDR, raw_blk.size, len(payload), bflags,
                    zlib.crc32(payload) & 0xFFFFFFFF,
                )
            )
            dst.write(payload)
            written += BLKHDR_LEN + len(payload)
            done += raw_blk.size
            if progress:
                progress(done, total)
        return advanced

    # One group stays in flight on the pipelined sequential path: block
    # i+1's scans are dispatched (async) BEFORE block i's results are
    # fetched, so device compute overlaps the device->host transfer +
    # host-side payload packing (SURVEY.md §2.5 P2, device half).
    pipelined = (
        not precomp_only
        and not chain
        and encode_fn is None
        and mesh is None
        and group_n == 1
    )
    if pipelined:
        enc_start, enc_finish = _block_encoder_async(cp.block)
    pending = None  # (staged, [device handles]) awaiting finish
    pending_c = None  # chained: (staged, payload handles, tables-after)
    spec_tables = chain_tables  # speculative chain head (device handles)
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        nxt = list(itertools.islice(blocks_it, group_n))
        fut = pool.submit(stage_group, nxt) if nxt else None
        while fut is not None:
            staged = fut.result()
            nxt = list(itertools.islice(blocks_it, group_n))
            fut = pool.submit(stage_group, nxt) if nxt else None
            if precomp_only:
                for raw_blk, blk, prefix, bflags in staged:
                    body = prefix + blk.tobytes()
                    dst.write(
                        struct.pack(
                            BLKHDR, raw_blk.size, len(body),
                            bflags | BF_STORED,
                            zlib.crc32(body) & 0xFFFFFFFF,
                        )
                    )
                    dst.write(body)
                    written += BLKHDR_LEN + len(body)
                continue
            if pipelined:
                handles = [enc_start(blk) for _, blk, _, _ in staged]
                if pending is not None:
                    write_group(
                        pending[0], [enc_finish(h) for h in pending[1]]
                    )
                pending = (staged, handles)
                continue
            if chain:
                # Speculative chain pipelining: dispatch this block's
                # scans off the PREVIOUS block's tables1 device handles
                # (the dependency serializes on-device; dispatch stays
                # ahead of result transfers).  The speculation is that
                # the previous block advances the models — only a
                # stored fallback (incompressible block) falsifies it,
                # in which case the dispatch is redone from the
                # committed tables (write_group reverts those).
                # CPX_CHAIN_SPEC=0 restores the round-3 sequential
                # behavior (finish block i before dispatching i+1) —
                # the A/B control for the ledger measurement.
                if _os.environ.get("CPX_CHAIN_SPEC", "1") == "0":
                    if pending_c is not None:
                        st_p, h_p, tb_p = pending_c
                        write_group(
                            st_p,
                            [(encode_block_chained_finish(h_p), tb_p)],
                        )
                        pending_c = None
                    spec_tables = chain_tables
                blk = staged[0][1]
                handles, tb_after = encode_block_chained_start(
                    blk, cp.block, spec_tables
                )
                if pending_c is not None:
                    st_p, h_p, tb_p = pending_c
                    adv = write_group(
                        st_p, [(encode_block_chained_finish(h_p), tb_p)]
                    )
                    if not adv:  # stored fallback: redo off committed tables
                        handles, tb_after = encode_block_chained_start(
                            blk, cp.block, chain_tables
                        )
                spec_tables = tb_after
                pending_c = (staged, handles, tb_after)
                continue
            elif encode_fn is not None:
                payloads = [encode_fn(blk) for _, blk, _, _ in staged]
            elif mesh is not None and cp.block.mode != "F":
                payloads = encode_blocks_list(
                    [blk for _, blk, _, _ in staged], cp.block, mesh=mesh
                )
            elif group_n > 1 and cp.block.mode != "F":
                payloads = encode_blocks_list(
                    [blk for _, blk, _, _ in staged], cp.block,
                    group=group_n,
                )
            elif group_n > 1:
                from comprox_tpu.codec.fast import encode_blocks_fast

                payloads = encode_blocks_fast(
                    [blk for _, blk, _, _ in staged], cp.block, group_n
                )
            else:
                enc1 = _block_encoder(cp.block)
                payloads = [enc1(blk) for _, blk, _, _ in staged]
            write_group(staged, payloads)
        if pending is not None:  # drain the pipelined tail block
            write_group(pending[0], [enc_finish(h) for h in pending[1]])
        if pending_c is not None:  # drain the chained tail block
            st_p, h_p, tb_p = pending_c
            write_group(st_p, [(encode_block_chained_finish(h_p), tb_p)])
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    dst.write(struct.pack(BLKHDR, 0, 0, 0, 0))
    return written + BLKHDR_LEN


def decode_stream(
    src: BinaryIO,
    dst: BinaryIO,
    decode_fn: Optional[Callable] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    mesh=None,
    group: int = 1,
) -> int:
    """Decode an archive; returns raw byte count.

    With ``mesh`` set, coded blocks decode data-parallel across the mesh —
    the capability the reference's sequentially-dependent blocks rule out
    (SURVEY.md §2.5 P1).  With ``group`` > 1 (no mesh), groups of blocks
    vmap-batch through one scan on the default device."""
    from comprox_tpu.codec import dictionary as dic

    cp, flags = read_header(src)
    wd = None
    if flags & F_DICT:
        hdr = src.read(12)
        if len(hdr) < 12:
            raise ValueError("truncated archive: short dictionary header")
        blob_len, clen, crc = struct.unpack("<III", hdr)
        if clen:
            blob = dic.blob_decode(src.read(clen), blob_len)
        else:
            blob = src.read(blob_len)
        if len(blob) != blob_len or zlib.crc32(blob) & 0xFFFFFFFF != crc:
            raise ValueError("corrupt archive: dictionary blob CRC mismatch")
        wd = dic.unpack_dict(blob)
    chained = bool(flags & F_CHAIN)
    chain_tables = init_chain_tables(cp.block) if chained else None
    if (
        (mesh is not None or group > 1)
        and decode_fn is None
        and not chained  # chained blocks are sequentially dependent
        and (cp.block.mode != "F" or mesh is None)
    ):
        # prescan must start at the first block header (after the dict blob)
        decode_fn = _make_mesh_decode_fn(src, cp, mesh, group)
    if chained:
        decode_fn = None  # model carry-over forces the sequential path
    # Pipelined sequential path: dispatch block i+1's scan (async) before
    # fetching block i's output, overlapping device compute with the
    # device->host transfer (mirrors encode_stream's write_group pipeline).
    dec_start = dec_finish = None
    if decode_fn is None and not chained:
        dec_start, dec_finish = _block_decoder_async(cp.block)
    elif chained:
        # chained decode pipelines too: the next block's scan chains off
        # tables1 device handles (no speculation needed — stored blocks
        # are known from header flags before dispatch and skip the models)
        dec_finish = decode_block_finish
    decode_fn = decode_fn or _block_decoder(cp.block)
    total = 0
    # 5-tuple (started handles-or-None, out-or-None, dicted, spans, raw_n).
    # Error ordering note: with one block in flight, block i+1's payload
    # CRC (checked at read time, above dispatch) runs BEFORE block i's
    # deferred drain/content checks in finish_item — archive corruption in
    # block i can therefore surface attributed to i+1 first.  Benign: both
    # raise ValueError and abort the decode; no wrong bytes are written.
    pending = None

    def finish_item(item):
        nonlocal total
        started, out, dicted, spans, raw_n = item
        if started is not None:
            out = dec_finish(started)
        if dicted:
            out = dic.dict_decode(out, wd)
        if out.size != raw_n:
            raise ValueError(
                f"corrupt block: decoded {out.size} bytes, header says "
                f"{raw_n}"
            )
        if spans:
            from comprox_tpu.ops import filters as flt

            out = flt.apply_spans(out, spans, encode=False)
        dst.write(out.tobytes())
        total += raw_n
        if progress:
            progress(total, total)

    while True:
        hdr = src.read(BLKHDR_LEN)
        if len(hdr) < BLKHDR_LEN:
            raise ValueError("truncated archive: missing block header")
        raw_n, blen, bflags, crc = struct.unpack(BLKHDR, hdr)
        if raw_n == 0:
            break
        payload = src.read(blen)
        if len(payload) < blen:
            raise ValueError("truncated archive: short block payload")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError("corrupt archive: block payload CRC mismatch")
        if bflags & BF_DICT and wd is None:
            raise ValueError(
                "corrupt archive: block flagged dictionary-coded but the "
                "header carries no dictionary"
            )
        spans = []
        if bflags & BF_FILTERED and not bflags & BF_STORED:
            from comprox_tpu.ops import filters as flt

            spans, off = flt.unpack_spans(payload)
            payload = payload[off:]
        if bflags & BF_STORED:
            if bflags & BF_DICT:  # precomp-only block: expand dictionary
                payload = payload[4:]  # skip substituted-size prefix
                out = dic.dict_decode(
                    np.frombuffer(payload, np.uint8), wd
                )
            else:
                out = np.frombuffer(payload, np.uint8)
            item = (None, out, False, spans, raw_n)
        else:
            n_dec = raw_n
            if bflags & BF_DICT:
                if len(payload) < 4:
                    raise ValueError("corrupt block: missing dict-size prefix")
                (n_dec,) = struct.unpack("<I", payload[:4])
                payload = payload[4:]
            dicted = bool(bflags & BF_DICT)
            if chained:
                started, chain_tables = decode_block_chained_start(
                    payload, n_dec, cp.block, chain_tables
                )
                item = (started, None, dicted, spans, raw_n)
            elif dec_start is not None:
                item = (dec_start(payload, n_dec), None, dicted, spans, raw_n)
            else:
                item = (None, decode_fn(payload, n_dec), dicted, spans, raw_n)
        if pending is not None:
            finish_item(pending)
            pending = None
        if item[0] is not None:
            pending = item  # keep the dispatched block in flight
        else:
            finish_item(item)
    if pending is not None:
        finish_item(pending)
    return total


def _make_mesh_decode_fn(src, cp: ContainerParams, mesh, group: int = 1):
    """Pre-scan the remaining archive and batch-decode coded blocks over
    the mesh (or vmap-batched groups on one device when mesh is None);
    returns a decode_fn serving results from the batch."""
    import struct as _st

    from comprox_tpu.parallel.mesh import decode_blocks

    start = src.tell()
    jobs = []  # (payload_after_prefixes, n_decode)
    while True:
        hdr = src.read(BLKHDR_LEN)
        if len(hdr) < BLKHDR_LEN:
            break
        raw_n, blen, bflags, _crc = _st.unpack(BLKHDR, hdr)
        if raw_n == 0:
            break
        payload = src.read(blen)
        if bflags & BF_STORED:
            continue
        if bflags & BF_FILTERED:
            from comprox_tpu.ops import filters as flt

            _spans, off = flt.unpack_spans(payload)
            payload = payload[off:]
        n_dec = raw_n
        if bflags & BF_DICT:
            if len(payload) < 4:
                raise ValueError("corrupt block: missing dict-size prefix")
            (n_dec,) = _st.unpack("<I", payload[:4])
            payload = payload[4:]
        jobs.append((payload, n_dec))
    src.seek(start)
    if not jobs:
        return None

    # Lazy windowed decode: groups of device-count blocks go to the mesh as
    # the caller consumes results, so whole-archive output and per-block
    # device state are never live at once (bounded memory at enwik9 scale).
    ndev = int(mesh.devices.size) if mesh is not None else max(group, 1)

    def results():
        # device decode of group g+1 overlaps the host post-processing
        # (dictionary expansion, filters, writes) of group g (P2)
        from concurrent.futures import ThreadPoolExecutor

        def dec(grp):
            if cp.block.mode == "F":
                from comprox_tpu.codec.fast import decode_blocks_fast

                return decode_blocks_fast(
                    [p for p, _ in grp], [n for _, n in grp], cp.block,
                    ndev,
                )
            return decode_blocks(
                [p for p, _ in grp], [n for _, n in grp], cp.block,
                mesh=mesh, group=ndev,
            )

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(dec, jobs[0:ndev])
            for g in range(0, len(jobs), ndev):
                outs = fut.result()
                if g + ndev < len(jobs):
                    fut = pool.submit(dec, jobs[g + ndev : g + 2 * ndev])
                off = 0
                for _, n in jobs[g : g + ndev]:
                    yield outs[off : off + n]
                    off += n

    it = results()

    def decode_fn(payload, n):
        out = next(it)
        assert out.size == n
        return out

    return decode_fn
