"""The port's 2D / mono-video train CLI (the TikTok path), the twin of the
JAX package's train2d3d.py:

    python -m x_as_supervision_tpu_torch.train2d3d --config <yaml|json> \\
        [--seed S] [--epoch N] [--steps N] [--batch_size B] [--worker N] \\
        [--log_dir DIR] [--checkpoint <ckpt_dir>|auto] [--finetune] \\
        [--extra_tag T] [--device cpu] [--fp32] \\
        [--coordinator HOST:PORT --num_processes P --process_id R]

The same Trainer as the train CLI (train/__main__.py) on mono batches from
``TikTok_dataset`` (data/dataloader_2d.py) under the config's
``dataset_params.dataset.path``, which take the composed model's mono
branch (identity camera, camera-free world lift, no symmetry loss). It
writes the train CLI's run directory, checkpoints and TensorBoard events.
Like train2d3d.py the dataset's per-sample seed is ``max(seed, 0)``, and
the panels use tb_vis's full layout (train2d3d.py's docstring names the
``simple_version`` layout, which its Trainer never selects). It trains on
the CUDA card unless given ``--device cpu``, and in P processes under
torchrun or the ``--coordinator`` flags as the train CLI does.
"""

from __future__ import annotations


def build_tiktok_dataset(config: dict, seed: int = 0):
    """The config's TikTok training frames (train2d3d.py:
    build_tiktok_dataset)."""
    from .data.dataloader_2d import TikTok_dataset

    dp = config["dataset_params"]
    return TikTok_dataset(
        dp["dataset"]["path"],
        dp.get("geodesic_param_list", [2, 1, 3, 20, 0.0]),
        dp.get("smpl_pseudo_img"),
        norm_param={"mean": None, "std": None},
        mode="train",
        rect_3d_width=config["train_params"].get("rect_3d_width", 256),
        seed=seed,
    )


def main(argv=None):
    """Parses `argv`, trains, and returns the Trainer."""
    from .train.__main__ import base_parser, run

    # train2d3d.py has no --synthetic and no --backbone_init
    opt = base_parser(__doc__).parse_args(argv)
    return run(opt, lambda config: build_tiktok_dataset(
        config, seed=max(opt.seed, 0)))


if __name__ == "__main__":
    main()
    from .parallel.mesh import shutdown

    shutdown()
