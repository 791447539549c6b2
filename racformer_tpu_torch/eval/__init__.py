from .decode import decode_boxes
from .streaming import StreamingEvaluator
