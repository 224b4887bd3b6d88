"""The benchmark of rmcl_tpu_torch, the PyTorch and CUDA port: see run.py."""
