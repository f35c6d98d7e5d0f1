"""Multi-device parallelism over ``torch.distributed`` (port of the JAX
package's ``parallel``).

Two axes, matching the workload's natural decomposition (SURVEY §2.3):

- ``data``  — requests are embarrassingly parallel: each data shard
  evaluates its own sub-batch (the DP analog).
- ``rule``  — DFA banks are partitioned across devices when tables
  outgrow one device's memory (the TP analog: shard the "feature"
  dimension, all-gather the per-target hit bits — a tiny activation).

One process per device; NCCL on the card, gloo on the CPU.
"""

from .mesh import (  # noqa: F401
    ShardedWafEngine,
    ShardedWafModel,
    build_sharded_model,
    eval_waf_sharded,
    make_mesh,
)
