"""The benchmark of the PyTorch/CUDA port (``objectdetection_torch``).

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``run.py``. Nothing here imports JAX or the JAX package.
"""
