"""Tiny cells for the CPU tests: a cell of BENCHMARK.json cut to ResNet-50
at 64^2, D 8, 2 cameras x 2 samples, physique [4, 8], discriminator at 16
(serving: requests of 4 crops), run by the harness on the CPU."""

import copy
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import bench  # noqa: E402

# few threads a test process: the tests run several processes at once
torch.set_num_threads(2)

SEED = 2 ** 31 + 12345


def cut(cell, dtype=torch.float32):
    c = copy.deepcopy(cell.config)
    mp = c["model_params"]
    c["dataset_params"]["cam_id_list"] = mp["cam_id_list"] = [0, 1]
    mp["detector_params"].update(depth_dim=8, neighbor_size=3)
    mp["smpl_disc_params"].update(input_dim=16, hidden_dim=16,
                                  output_dim=16)
    mp["physique_mask_generator_params"]["layers"] = [4, 8]
    c["train_params"].update(patch_width=64, patch_height=64)
    cell.config = c
    t = dict(cell.traffic)
    if t["kind"] == "train":
        t.update(batch_per_camera=2, pool_batches=3, traced_steps=1)
    else:
        t.update(request_images=4, server_batch=4, pool_requests=2,
                 checked_requests=3, traced_requests=2)
    cell.traffic = t
    cell.dtype = dtype
    return cell


def tiny(name, dtype=torch.float32, root=ROOT, here=HERE):
    return cut(bench.load_cell(name, root, here), dtype)
