"""XLA random-access cost model on the device: row gather / row-delta
scatter-add cost vs table size, row width, and lane count.  These are the
primitives the codec scan is built from (PERF.md).  Whether a hand-written
kernel beats XLA's gathers on the GPU is open (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=50, warmup=5):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    print(f"devices: {jax.devices()}", flush=True)
    for nrows in (1 << 12, 1 << 16, 1 << 18):
        for width in (8, 64, 260, 384):
            for s in (512, 2048):
                table = jnp.zeros((nrows, width), jnp.int32)
                idx = jnp.asarray(
                    np.random.randint(0, nrows, s), jnp.int32
                )
                delta = jnp.ones((s, width), jnp.int32)

                @jax.jit
                def g(t, i):
                    return t[i]

                @jax.jit
                def sc(t, i, d):
                    return t.at[i].add(d)

                dg = timeit(g, table, idx)
                ds = timeit(sc, table, idx, delta)
                print(
                    f"rows=2^{nrows.bit_length()-1} w={width:3d} S={s:4d}: "
                    f"gather {dg*1e6:7.1f} us ({dg/s*1e9:5.0f} ns/row)  "
                    f"scatter+ {ds*1e6:7.1f} us ({ds/s*1e9:5.0f} ns/row)",
                    flush=True,
                )
    # element (width-1) gathers, the o3 pattern
    for bits in (16, 22):
        for s in (512, 2048):
            table = jnp.zeros((1 << bits,), jnp.int32)
            idx = jnp.asarray(np.random.randint(0, 1 << bits, s), jnp.int32)

            @jax.jit
            def g1(t, i):
                return t[i]

            dg = timeit(g1, table, idx)
            print(f"elem 2^{bits} S={s:4d}: gather {dg*1e6:7.1f} us "
                  f"({dg/s*1e9:5.0f} ns/elem)", flush=True)


if __name__ == "__main__":
    main()
