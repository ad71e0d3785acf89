"""Distribution utilities of the port: sharding rules and specs
(`sharding`), the ring collective matmul (`collective_matmul`), gradient
compression (`compression`) and the sharded training machinery
(`parallel`: ZeRO-3 over the data axes, tensor parallelism over "model")."""
from .sharding import (Spec, constrain, current_rules,  # noqa: F401
                       gather_layer_params, rules_for_family, sharding_rules,
                       to_placements)
