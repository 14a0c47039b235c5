"""x_as_supervision_tpu_torch: the PyTorch / CUDA port of x_as_supervision_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports nothing of
it, nor JAX. What is ported so far is the serving path:

  serve.py    PoseEstimator: preprocess, batched detector forward, pixels,
              patch -> world lift
  infer.py    the inference CLI (python -m x_as_supervision_tpu_torch.infer)
  models/     ResNet backbone + deconv head, integral detectors
  ops/        integral decode, fused BN->ReLU->conv3x3 link, geometry, and
              the ctypes bindings of the CUDA kernels in csrc/
  weights.py  JAX detector variables -> state_dict; seeded weights
  config.py   YAML config loading
"""

__version__ = "0.1.0"
