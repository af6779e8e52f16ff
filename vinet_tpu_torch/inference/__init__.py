from vinet_tpu_torch.inference.engine import SlidingWindowPredictor, WindowTask, window_plan
from vinet_tpu_torch.inference.live import LiveStreamingPredictor
from vinet_tpu_torch.inference.serving import MultiLiveServer
from vinet_tpu_torch.inference.streaming import StreamingPredictor

__all__ = ["LiveStreamingPredictor", "MultiLiveServer", "SlidingWindowPredictor",
           "StreamingPredictor", "WindowTask", "window_plan"]
