"""Sample records of the dataset index builders: the port's own copy of the
JAX package's data/samples.py.

The reference uses easydict records (reference: human_utils/dataset/imdb.py
patch_sample*); this is a plain dict subclass with attribute access, so the
pickle-cached databases stay simple, inspectable and keyed identically.
"""

from __future__ import annotations


class PatchSample(dict):
    """Dict with attribute access: one (image, crop box, joints) record."""

    __getattr__ = dict.__getitem__

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def full(image, center_x, center_y, width, height, rot, joints_3d,
             joints_3d_vis, flip_pairs, parent_ids) -> "PatchSample":
        return PatchSample(
            image=image, center_x=center_x, center_y=center_y, width=width,
            height=height, rot=rot, joints_3d=joints_3d,
            joints_3d_vis=joints_3d_vis, flip_pairs=flip_pairs,
            parent_ids=parent_ids,
        )
