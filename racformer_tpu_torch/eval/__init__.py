from .decode import decode_boxes, decode_config
from .offline import OfflineEvaluator, detection_metrics
from .streaming import StreamingEvaluator, run_multistream
