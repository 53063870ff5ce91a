"""The distribution layer: sharding rules, the ambient mesh and activation
policy, on ``torch.distributed`` ``DeviceMesh`` / DTensor."""
from repro_torch.distributed.ctx import (  # noqa: F401
    activation_policy, constrain, current_mesh, current_rules, use_mesh,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    Layout, ShardingRules, batch_shardings, cache_shardings,
    distribute_tree, local_gemm_divisors, param_placements, param_specs,
    placements_for, rules_for_mesh, shard_params, sharding_summary,
)
