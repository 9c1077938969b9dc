"""Distribution layer of the port: sharding rules, int8 gradient
compression and its all-reduce."""
from .compression import (compress, compressed_allreduce, decompress,  # noqa: F401
                          init_error)
from .sharding import (ShardingRules, named_sharding_tree,  # noqa: F401
                       resolve_param_specs)
