from .decode import decode_boxes, decode_config
