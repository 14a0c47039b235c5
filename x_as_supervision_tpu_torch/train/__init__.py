"""Training of the port: the GAN spec, the train state and its fused step,
the trainer and its CLI (python -m x_as_supervision_tpu_torch.train)."""
