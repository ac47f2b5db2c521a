"""vins_tpu_torch — the PyTorch/CUDA port of vins_tpu.

Each module mirrors its counterpart in `vins_tpu/`.  The main path runs:
`pipeline.Pipeline` (serial, loop closure off) drives the front-end
(`frontend/`, whose pyramidal Lucas-Kanade is the hand-written CUDA kernel
`csrc/lk_pyramid.cu`, built with nvcc at first use) and the estimator
(`estimator/`: the feature DB, initialization by SfM and visual-inertial
alignment, and the per-keyframe VIO step over `imu/` and `solver/`).
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
