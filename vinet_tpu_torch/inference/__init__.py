from vinet_tpu_torch.inference.engine import SlidingWindowPredictor, WindowTask, window_plan

__all__ = ["SlidingWindowPredictor", "WindowTask", "window_plan"]
