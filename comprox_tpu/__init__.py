"""comprox_tpu — an accelerator-native lossless data compression framework.

A from-scratch JAX/XLA re-architecture of the capabilities of the
reference C suite (richox/comprox: LZ77/ROLZ/LZP matching + PPM context
modeling + carry-correct range coding, see /root/reference/src).  Instead of
one sequential symbol loop with helper pthreads, this design makes
*lane-interleaved independent coding streams* the primitive: S rANS streams
advance in lock-step as vector lanes, adaptive model tables live in device
memory and update via deterministic vectorized scatter, and 16 MiB blocks shard
data-parallel across a device mesh.

Layering (mirrors SURVEY.md §7):
  utils/     — substrate helpers (byte packing, timers)        [ref L0]
  ops/       — entropy coder + match-finder + filter kernels   [ref L1/L2/L3a]
  models/    — batched adaptive context models (PPM family)    [ref L1]
  codec/     — block codec orchestration + container format    [ref L2/L4]
  parallel/  — mesh sharding / multi-host runtime              [new]
  cli/       — comprox-compatible command-line frontends       [ref L5]
"""

__version__ = "0.1.0"
