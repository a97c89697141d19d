"""The benchmark of the PyTorch and CUDA port (`dagsfm_tpu_torch`) on
one NVIDIA H100: see README.md."""
