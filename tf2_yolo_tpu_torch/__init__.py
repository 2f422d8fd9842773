"""PyTorch port of tf2_yolo_tpu for NVIDIA Hopper: the YOLOv1.5-v4
families with every backbone of their facades, their training, serving,
deployment and evaluation, with hand-written CUDA kernels for the convs
and the NMS and plain PyTorch versions of them on the CPU."""
