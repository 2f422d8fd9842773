"""PyTorch port of tf2_yolo_tpu for NVIDIA Hopper: the YOLOv4 serving
path (eval-mode forward, device decode, greedy NMS) with hand-written
CUDA kernels for the conv and the NMS, and plain PyTorch versions of
both on the CPU."""
