"""Mesh runtime: block-level data parallelism over a JAX device mesh.

The reference is a single-process CPU program whose only latent parallelism
is its 16 MiB block split (SURVEY.md §2.5 P1: models persist across blocks,
so reference blocks are sequentially dependent).  Our container resets model
state per block (codec/container.py), which makes every block an independent
unit — so both encode AND decode scale data-parallel across chips:

  * blocks shard over a 1-D ``dp`` mesh axis via ``shard_map``;
  * each device runs the lock-step block codec on its local blocks;
  * per-block compressed sizes all-gather so every host can assemble the
    archive in file order (the reference's ordered fwrite loop,
    src/main.c:198-205, becomes an ordered gather);
  * multi-host: ``jax.distributed.initialize`` + the same mesh spanning all
    hosts; the dictionary pre-pass broadcasts host0 -> all (SURVEY.md §2.5
    P6).

The payload bytes produced on a mesh are identical to single-device output:
the codec is deterministic integer arithmetic, so sharding is purely a
throughput decision.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from comprox_tpu.codec.block import (
    BlockParams,
    _decode_scan,
    _encode_passes,
)
from comprox_tpu.ops.rans_scalar import RANS_L


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# --------------------------------------------------------------------------
# Single-device block batching: vmap G blocks through ONE scan.
#
# Running G blocks' steps together in one scan widens every step G-fold
# at a fixed step count; whether that beats G sequential scans on the
# GPU is not yet measured (ROADMAP Queue 1 item 3a).  This is the
# single-device counterpart of the mesh sharding above (which needs G real
# devices); payloads are bit-identical to sequential encode_block calls
# because each block's table state is independent (leading vmap axis).
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0,))
def _encode_blocks_vmap(p: BlockParams, inp, n):
    """inp: [G, S, T] u8, n: [G] i32 -> per-block (states, emit-bitpack,
    words), G blocks coded in one fused scan on ONE device."""

    def one(blk, nn):
        return _encode_passes(p, blk, nn)[:3]

    return jax.vmap(one)(inp, n)


@functools.partial(jax.jit, static_argnums=(0,))
def _decode_blocks_vmap(p: BlockParams, states, streams, n):
    def one(st1, sm1, n1):
        return _decode_scan(p, st1, sm1, n1)[:3]

    return jax.vmap(one)(states, streams, n)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _encode_blocks_sharded(p: BlockParams, mesh: Mesh, inp, n):
    """inp: [B, S, T] u8 sharded over blocks; n: [B] i32.  Returns per-block
    (states [B,S] u32, emit-bitpack [B,T,ns,S/8] u8, words [B,T,ns,S] u16)."""

    def per_device(inp_loc, n_loc):
        def one(blk, nn):
            return _encode_passes(p, blk, nn)[:3]

        return jax.vmap(one)(inp_loc, n_loc)

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
        check_vma=False,  # scan carries init from replicated constants
    )
    return fn(inp, n)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _decode_blocks_sharded(p: BlockParams, mesh: Mesh, states, streams, n):
    """states: [B,S] u32, streams: [B,W] u16, n: [B] i32 -> out [B,S,T] u8
    plus drain diagnostics (x [B,S], base [B])."""

    def per_device(st, sm, nn):
        def one(st1, sm1, n1):
            return _decode_scan(p, st1, sm1, n1)[:3]

        return jax.vmap(one)(st, sm, nn)

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
        check_vma=False,  # scan carries init from replicated constants
    )
    return fn(states, streams, n)


def encode_blocks(
    data: np.ndarray, p: BlockParams, mesh: Mesh
) -> list[bytes]:
    """Encode a file's blocks data-parallel; returns per-block payloads in
    file order (bit-identical to sequential encode_block calls)."""
    ndev = mesh.devices.size
    cap = p.capacity
    nblk = max(1, -(-data.size // cap))
    nblk_pad = -(-nblk // ndev) * ndev
    buf = np.zeros((nblk_pad, p.lanes, p.steps), np.uint8)
    ns = np.zeros((nblk_pad,), np.int32)
    for b in range(nblk):
        chunk = data[b * cap : (b + 1) * cap]
        buf[b].reshape(-1)[: chunk.size] = chunk
        ns[b] = chunk.size
    states, emit_packed, words = _encode_blocks_sharded(
        p, mesh, jnp.asarray(buf), jnp.asarray(ns)
    )
    states, emit_packed, words = map(
        np.asarray, (states, emit_packed, words)
    )
    emit = np.unpackbits(emit_packed, axis=-1, bitorder="little").astype(
        bool
    )
    payloads = []
    for b in range(nblk):
        stream = words[b][emit[b]]
        payloads.append(
            np.array([stream.size], np.uint32).tobytes()
            + states[b].astype("<u4").tobytes()
            + stream.astype("<u2").tobytes()
        )
    return payloads


def encode_blocks_list(
    blocks: list[np.ndarray],
    p: BlockParams,
    mesh: Optional[Mesh] = None,
    group: int = 0,
) -> list[bytes]:
    """Encode an explicit list of (variable-size) blocks in groups;
    payloads are bit-identical to per-block encode_block calls.

    With ``mesh`` set, each group shards one block per device; otherwise
    ``group`` blocks are vmap-batched through one scan on the default
    device (single-chip block batching)."""
    gsize = int(mesh.devices.size) if mesh is not None else max(group, 1)
    out: list[bytes] = []
    for g in range(0, len(blocks), gsize):
        grp = blocks[g : g + gsize]
        buf = np.zeros((gsize, p.lanes, p.steps), np.uint8)
        ns = np.zeros((gsize,), np.int32)
        for i, blk in enumerate(grp):
            buf[i].reshape(-1)[: blk.size] = blk
            ns[i] = blk.size
        if mesh is not None:
            states, emit_packed, words = _encode_blocks_sharded(
                p, mesh, jnp.asarray(buf), jnp.asarray(ns)
            )
        else:
            states, emit_packed, words = _encode_blocks_vmap(
                p, jnp.asarray(buf), jnp.asarray(ns)
            )
        states, emit_packed, words = map(
            np.asarray, (states, emit_packed, words)
        )
        emit = np.unpackbits(
            emit_packed, axis=-1, bitorder="little"
        ).astype(bool)
        for i in range(len(grp)):
            stream = words[i][emit[i]]
            out.append(
                np.array([stream.size], np.uint32).tobytes()
                + states[i].astype("<u4").tobytes()
                + stream.astype("<u2").tobytes()
            )
    return out


def decode_blocks(
    payloads: list[bytes],
    ns: list[int],
    p: BlockParams,
    mesh: Optional[Mesh] = None,
    group: int = 0,
) -> np.ndarray:
    """Decode independent block payloads in file order: data-parallel over
    ``mesh`` devices, or vmap-batched ``group`` blocks per scan on one
    device when mesh is None."""
    ndev = int(mesh.devices.size) if mesh is not None else max(group, 1)
    nblk = len(payloads)
    nblk_pad = -(-max(nblk, 1) // ndev) * ndev
    states = np.zeros((nblk_pad, p.lanes), np.uint32)
    states[:, :] = RANS_L
    streams = np.zeros((nblk_pad, p.stream_pad), np.uint16)
    n_arr = np.zeros((nblk_pad,), np.int32)
    n_words = np.zeros((nblk_pad,), np.int64)
    for b, payload in enumerate(payloads):
        nw = int(np.frombuffer(payload[:4], "<u4")[0])
        if nw > p.stream_pad:
            raise ValueError(
                "corrupt block: stream exceeds geometry bound"
            )
        off = 4
        states[b] = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4")
        off += 4 * p.lanes
        streams[b, :nw] = np.frombuffer(payload[off : off + 2 * nw], "<u2")
        n_arr[b] = ns[b]
        n_words[b] = nw
    if mesh is not None:
        x, base, out = _decode_blocks_sharded(
            p, mesh, jnp.asarray(states), jnp.asarray(streams),
            jnp.asarray(n_arr),
        )
    else:
        x, base, out = _decode_blocks_vmap(
            p, jnp.asarray(states), jnp.asarray(streams), jnp.asarray(n_arr)
        )
    x, base, out = map(np.asarray, (x, base, out))
    for b in range(nblk):
        if int(base[b]) != n_words[b] or not (x[b] == RANS_L).all():
            raise ValueError(f"corrupt block {b}")
    pieces = [out[b].reshape(-1)[: ns[b]] for b in range(nblk)]
    return np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
