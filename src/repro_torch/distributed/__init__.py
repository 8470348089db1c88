"""Distribution of the port: expert parallelism over an EP mesh's slots
(``expert_parallel``) and host-side fault tolerance (``fault_tolerance``)."""
from repro_torch.distributed.expert_parallel import (
    expert_parallel_moe,
    get_ep_mesh,
    set_ep_mesh,
    use_ep_mesh,
    validate_ep,
)

__all__ = ["expert_parallel_moe", "get_ep_mesh", "set_ep_mesh", "use_ep_mesh",
           "validate_ep"]
