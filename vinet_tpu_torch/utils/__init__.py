from vinet_tpu_torch.utils.runtime import enable_profiling, num_params

__all__ = ["enable_profiling", "num_params"]
