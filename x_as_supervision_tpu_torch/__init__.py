"""x_as_supervision_tpu_torch: the PyTorch / CUDA port of x_as_supervision_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports nothing of
it, nor JAX. What is ported so far is the serving path, the flagship fused
GAN training step with its checkpoints, TensorBoard logging and the train
CLI's flags, the eval that scores them, the datasets they read from disk,
and data-parallel training and eval over several processes:

  serve.py    PoseEstimator: preprocess, batched detector forward, pixels,
              patch -> world lift
  infer.py    the inference CLI (python -m x_as_supervision_tpu_torch.infer)
  train/      GAN spec factory, train state and fused step, trainer and its
              CLI (python -m x_as_supervision_tpu_torch.train), checkpoints
              and their restore modes, TensorBoard logging (the port's own
              event writer, tb_vis and its panels, the step timer and
              profiler), the evaluator, its metrics and tables
  eval/       the eval CLI (python -m x_as_supervision_tpu_torch.eval)
  models/     ResNet backbone + deconv head, integral detectors (eval and
              train), physique net, discriminator, composed GAN losses
  ops/        integral decode and its gradient, fused BN->ReLU->conv3x3
              link, small-channel conv3x3, renderer, geometry and the DLT
              triangulation, losses, and the ctypes bindings of the CUDA
              kernels in csrc/ (and of the host C++ in csrc/host/)
  data/       the datasets: Human3.6M and MPI-INF-3DHP index builders with
              their pickle cache, the patch pipeline (crop, augmentation,
              masks, the SURREAL pseudo stream, geodesic maps from the
              port's own FMM build), the dataset classes and basic_data;
              the synthetic multi-camera pose fixture; the epoch-shuffled
              thread-pool batch loader
  checks.py   helpers shared by the tests and chip_smoke.py (the anchored
              eval fixture, eval_result.txt reader, state comparison,
              TensorBoard event reader, miniature on-disk datasets)
  weights.py  JAX variables -> state_dicts; seeded weights; the ImageNet
              backbone init
  config.py   YAML / JSON config loading
  parallel/   data parallelism: the process group (torchrun or
              --coordinator) and the collectives of the data-parallel step
              and the sharded eval
"""

import torch as _torch

__version__ = "0.1.0"

# PyTorch's CPU build can compute one thread's share of the first vectorized
# math call of a process (exp, log, sqrt, tanh, ...) at reduced accuracy,
# about 1.5e-4 relative, when several threads make that first call at once.
# One small call on this thread first initializes that code, so the CPU path
# (every kernel's plain version) computes in full fp32 from its first call.
_torch.exp(_torch.zeros(8))
