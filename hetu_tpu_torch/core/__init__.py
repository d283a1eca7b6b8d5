from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.dtypes import (DEFAULT_POLICY, FP32_POLICY, Policy,
                                        as_dtype, cast_tree)
from hetu_tpu_torch.core.module import named_parameters, param_count
from hetu_tpu_torch.core.rng import (get_seed_status, next_key, next_keys,
                                     reset_seed_seqnum, set_random_seed)
from hetu_tpu_torch.mem.policy import maybe_remat
from hetu_tpu_torch.parallel.spec import logical_axes

__all__ = ["resolve_device", "Policy", "DEFAULT_POLICY", "FP32_POLICY",
           "as_dtype", "cast_tree", "logical_axes", "maybe_remat",
           "named_parameters", "param_count", "get_seed_status",
           "next_key", "next_keys", "reset_seed_seqnum", "set_random_seed"]
