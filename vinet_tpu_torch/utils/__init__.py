from vinet_tpu_torch.utils import trace
from vinet_tpu_torch.utils.runtime import enable_profiling, init_distributed, num_params

__all__ = ["enable_profiling", "init_distributed", "num_params", "trace"]
