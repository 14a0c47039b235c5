"""The port's training CLI, the twin of the JAX package's train.py:

    python -m x_as_supervision_tpu_torch.train --config <yaml> --synthetic \\
        --seed 0 [--steps N] [--batch_size B] [--device cpu] [--fp32]
"""

from __future__ import annotations

from argparse import ArgumentParser


def main(argv=None) -> None:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the in-memory synthetic fixture")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--steps", default=None, type=int,
                        help="stop after this many steps")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--fp32", action="store_true",
                        help="compute in fp32 instead of bf16")
    opt = parser.parse_args(argv)

    import torch

    from ..config import load_config
    from ..data.synthetic import SyntheticPoseDataset
    from .trainer import Trainer

    config = load_config(opt.config)
    tp = config["train_params"]
    if opt.batch_size is not None:
        tp["batch_size"] = opt.batch_size
    if not opt.synthetic:
        raise SystemExit("only --synthetic data is ported; the real "
                         "datasets and their loader are not")
    dataset = SyntheticPoseDataset(
        num_samples=max(tp["batch_size"] * 4, 64),
        cam_id_list=config["dataset_params"]["cam_id_list"],
        patch_size=tp.get("patch_width", 256),
        rect_3d_width=tp.get("rect_3d_width", 2000),
    )
    trainer = Trainer(config, dataset, seed=opt.seed,
                      dtype=torch.float32 if opt.fp32 else torch.bfloat16,
                      device=opt.device)
    trainer.train(opt.steps)


if __name__ == "__main__":
    main()
