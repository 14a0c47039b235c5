"""The port's eval CLI (python -m x_as_supervision_tpu_torch.eval)."""
