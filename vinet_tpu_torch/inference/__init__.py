from vinet_tpu_torch.inference.engine import SlidingWindowPredictor, WindowTask, window_plan
from vinet_tpu_torch.inference.live import AVLiveStreamingPredictor, LiveStreamingPredictor
from vinet_tpu_torch.inference.serving import AVMultiLiveServer, MultiLiveServer
from vinet_tpu_torch.inference.streaming import AVStreamingPredictor, StreamingPredictor

__all__ = ["AVLiveStreamingPredictor", "AVMultiLiveServer", "AVStreamingPredictor",
           "LiveStreamingPredictor", "MultiLiveServer", "SlidingWindowPredictor",
           "StreamingPredictor", "WindowTask", "window_plan"]
