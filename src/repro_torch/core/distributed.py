"""Old location of the sharded pipeline, kept for the JAX package's names.

The sharded pipeline lives in ``repro_torch.api.sharded``; this module
re-exports its names, as ``repro/core/distributed.py`` does.
``make_distributed_anotherme`` is a thin adapter over
:func:`repro_torch.api.sharded.make_sharded_pipeline` with the SSH-shingle
key function; prefer ``AnotherMeEngine`` with ``ExecutionPlan(n_shards=...)``,
which also runs the "minhash", "brp" and "udf" backends sharded.
"""
from repro_torch.api.sharded import (  # noqa: F401
    DistributedPlan,
    _pair_hash,
    _positive_hash,
    _route,
    gather_similar_pairs,
    make_distributed_anotherme,
    make_sharded_pipeline,
    pad_to_shards,
    plan_capacities,
)
