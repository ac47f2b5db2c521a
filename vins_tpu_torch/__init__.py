"""vins_tpu_torch — the PyTorch/CUDA port of vins_tpu.

Each module mirrors its counterpart in `vins_tpu/`; the one TPU kernel on
the front-end path (the LK pyramid level) is a hand-written CUDA kernel in
`csrc/`, built with nvcc at first use.  Entry points run on `cuda` unless
the caller passes `device="cpu"`.
"""
