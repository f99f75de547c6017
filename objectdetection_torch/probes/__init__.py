"""The ROIAlign design probes of the TPU round, ported to the card.

Each module holds one probe's plain PyTorch version, its kernel wrapper (the
kernels are ``csrc/roi_probes.cu``) and a command-line entry point with the
TPU script's flags and sizes:

    python -m objectdetection_torch.probes.patch_dma       # P1, patch copies
    python -m objectdetection_torch.probes.roi_inner       # P2, blend + matmul
    python -m objectdetection_torch.probes.roi_dispatch    # P3, per-ROI dispatch

They run on the card unless ``--device cpu`` is given (the plain versions,
at a small ``--n``).
"""
