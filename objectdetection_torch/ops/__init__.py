"""NMS and ROIAlign: plain PyTorch versions and CUDA kernel wrappers."""
