"""Evaluation metrics and the trainer's eval hooks (``prpe_tpu/eval/``):
detection mAP, face verification, COCO keypoint AP. Host-side numpy."""
