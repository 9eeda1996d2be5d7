"""Multi-host runtime: jax.distributed + a host-spanning device mesh.

The reference has no distributed anything (single process, pthreads only —
SURVEY.md §2.5); this module provides the multi-host scale-out path:

  * ``initialize`` brings up ``jax.distributed`` (gloo collectives make the
    same code path testable with multi-process CPU, see
    tests/test_distributed.py);
  * blocks shard data-parallel over a mesh spanning every host's devices;
    each process feeds its *local* blocks via
    ``jax.make_array_from_process_local_data`` — the only correct way to
    build a process-spanning array (a plain ``jnp.asarray`` of the full
    host array is NOT global under multi-process JAX);
  * per-block payload *sizes* vary, so assembly all-gathers sizes first,
    then the padded payload bytes (``multihost_utils.process_allgather``),
    and every host reconstructs the archive in file order — the
    reference's ordered fwrite loop (src/main.c:198-205) as an ordered
    gather.  XLA hands the collectives to NCCL on GPUs (NVLink within a
    host, the network across hosts) and to gloo on the CPU.

Single-process degenerate behavior is bit-identical to
``parallel.mesh.encode_blocks`` (asserted by tests).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed when running multi-host.

    No-ops when single-process (the common local case).  Arguments default
    from CPX_* env vars, so launchers only set the environment.
    """
    import jax

    num = num_processes or int(os.environ.get("CPX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator
        or os.environ.get("CPX_COORDINATOR", "localhost:12321"),
        num_processes=num,
        process_id=(
            process_id
            if process_id is not None
            else int(os.environ.get("CPX_PROCESS_ID", "0"))
        ),
    )


def global_mesh(axis: str = "dp"):
    """A 1-D data-parallel mesh over every device of every host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def _pad_blocks(data: np.ndarray, p, ndev: int):
    """Split ``data`` into p.capacity blocks, padded to a multiple of the
    global device count.  Returns (buf [B,S,T] u8, ns [B] i32, nblk)."""
    cap = p.capacity
    nblk = max(1, -(-data.size // cap))
    nblk_pad = -(-nblk // ndev) * ndev
    buf = np.zeros((nblk_pad, p.lanes, p.steps), np.uint8)
    ns = np.zeros((nblk_pad,), np.int32)
    for b in range(nblk):
        chunk = data[b * cap : (b + 1) * cap]
        buf[b].reshape(-1)[: chunk.size] = chunk
        ns[b] = chunk.size
    return buf, ns, nblk


def _allgather_payloads(local_payloads: list[bytes], order_key: np.ndarray):
    """Ordered gather of variable-size payloads to every process.

    ``order_key[i]`` is the global block index of local payload i.  Sizes
    all-gather first; bytes ride one padded u8 all-gather."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return list(local_payloads)
    sizes = np.array([len(b) for b in local_payloads], np.int64)
    all_sizes = multihost_utils.process_allgather(sizes)  # [P, L]
    all_keys = multihost_utils.process_allgather(order_key.astype(np.int64))
    width = int(all_sizes.max())
    buf = np.zeros((len(local_payloads), width), np.uint8)
    for i, b in enumerate(local_payloads):
        buf[i, : len(b)] = np.frombuffer(b, np.uint8)
    all_bufs = multihost_utils.process_allgather(buf)  # [P, L, width]
    out: dict[int, bytes] = {}
    for pi in range(all_bufs.shape[0]):
        for li in range(all_bufs.shape[1]):
            out[int(all_keys[pi, li])] = (
                all_bufs[pi, li, : int(all_sizes[pi, li])].tobytes()
            )
    return [out[k] for k in sorted(out)]


def encode_file_distributed(data: np.ndarray, p, mesh=None) -> list[bytes]:
    """Whole-file encode over the (possibly multi-host) mesh.

    Every host holds the input (shared/replicated file system); blocks
    shard over the global mesh via a process-spanning array; every host
    returns the identical file-ordered payload list, so host 0 (or any
    host) can write the archive.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from comprox_tpu.parallel.mesh import _encode_blocks_sharded

    mesh = mesh or global_mesh()
    ndev = mesh.devices.size
    buf, ns, nblk = _pad_blocks(data, p, ndev)
    nproc = jax.process_count()
    sh = NamedSharding(mesh, P("dp"))
    sh_r = NamedSharding(mesh, P())
    if nproc == 1:
        inp = jnp.asarray(buf)
        ns_g = jnp.asarray(ns)
    else:
        # every process feeds its own contiguous block range: row b of the
        # global [B,S,T] array lives on global device b % ndev; with an
        # even block split per process, process q owns rows
        # [q*B/P, (q+1)*B/P)
        per = buf.shape[0] // nproc
        q = jax.process_index()
        inp = jax.make_array_from_process_local_data(
            sh, buf[q * per : (q + 1) * per], buf.shape
        )
        ns_g = jax.make_array_from_process_local_data(
            sh, ns[q * per : (q + 1) * per], ns.shape
        )
    states, emit_packed, words = _encode_blocks_sharded(p, mesh, inp, ns_g)
    # compact each process's addressable blocks, then ordered-gather
    my_rows = sorted(
        (int(s.index[0].start or 0), s) for s in states.addressable_shards
    )
    local_payloads: list[bytes] = []
    keys = []
    emit_by_row = {
        int(s.index[0].start or 0): s for s in emit_packed.addressable_shards
    }
    words_by_row = {
        int(s.index[0].start or 0): s for s in words.addressable_shards
    }
    for row0, st_sh in my_rows:
        st = np.asarray(st_sh.data)
        em = np.unpackbits(
            np.asarray(emit_by_row[row0].data), axis=-1, bitorder="little"
        ).astype(bool)
        wd = np.asarray(words_by_row[row0].data)
        for i in range(st.shape[0]):
            stream = wd[i][em[i]]
            local_payloads.append(
                np.array([stream.size], np.uint32).tobytes()
                + st[i].astype("<u4").tobytes()
                + stream.astype("<u2").tobytes()
            )
            keys.append(row0 + i)
    payloads = _allgather_payloads(local_payloads, np.array(keys))
    return payloads[:nblk]


def decode_file_distributed(payloads, ns, p, mesh=None) -> np.ndarray:
    """Decode independent block payloads over the global mesh; every host
    returns the full file bytes (blocks all-gather after sharded decode)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from comprox_tpu.ops.rans_scalar import RANS_L
    from comprox_tpu.parallel.mesh import _decode_blocks_sharded, decode_blocks

    mesh = mesh or global_mesh()
    nproc = jax.process_count()
    if nproc == 1:
        return decode_blocks(payloads, ns, p, mesh)
    ndev = mesh.devices.size
    nblk = len(payloads)
    nblk_pad = -(-max(nblk, 1) // ndev) * ndev
    states = np.full((nblk_pad, p.lanes), RANS_L, np.uint32)
    streams = np.zeros((nblk_pad, p.stream_pad), np.uint16)
    n_arr = np.zeros((nblk_pad,), np.int32)
    n_words = np.zeros((nblk_pad,), np.int64)
    for b, payload in enumerate(payloads):
        nw = int(np.frombuffer(payload[:4], "<u4")[0])
        if nw > p.stream_pad:
            # fail clean on corrupt/oversized payloads (the container
            # contract) instead of a numpy broadcast error
            raise ValueError(
                "corrupt block: stream exceeds geometry bound"
            )
        off = 4
        states[b] = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4")
        off += 4 * p.lanes
        streams[b, :nw] = np.frombuffer(payload[off : off + 2 * nw], "<u2")
        n_arr[b] = ns[b]
        n_words[b] = nw
    sh = NamedSharding(mesh, P("dp"))
    per = nblk_pad // nproc
    q = jax.process_index()
    rows = slice(q * per, (q + 1) * per)
    st_g = jax.make_array_from_process_local_data(
        sh, states[rows], states.shape
    )
    sm_g = jax.make_array_from_process_local_data(
        sh, streams[rows], streams.shape
    )
    n_g = jax.make_array_from_process_local_data(sh, n_arr[rows], n_arr.shape)
    x, base, out = _decode_blocks_sharded(p, mesh, st_g, sm_g, n_g)
    pieces_local: list[bytes] = []
    keys = []
    x_by_row = {int(s.index[0].start or 0): s for s in x.addressable_shards}
    base_by_row = {
        int(s.index[0].start or 0): s for s in base.addressable_shards
    }
    for row0, out_sh in sorted(
        (int(s.index[0].start or 0), s) for s in out.addressable_shards
    ):
        ob = np.asarray(out_sh.data)
        xb = np.asarray(x_by_row[row0].data)
        bb = np.asarray(base_by_row[row0].data)
        for i in range(ob.shape[0]):
            b = row0 + i
            if b >= nblk:
                continue
            if int(bb[i]) != n_words[b] or not (xb[i] == RANS_L).all():
                raise ValueError(f"corrupt block {b}")
            pieces_local.append(ob[i].reshape(-1)[: ns[b]].tobytes())
            keys.append(b)
    pieces = _allgather_payloads(pieces_local, np.array(keys))
    return (
        np.frombuffer(b"".join(pieces[:nblk]), np.uint8).copy()
        if pieces
        else np.zeros(0, np.uint8)
    )
