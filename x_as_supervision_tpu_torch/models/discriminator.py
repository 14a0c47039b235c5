"""The default pose discriminator, ``GCNDiscriminatorDecouple``, ported from
the JAX package's models/discriminator.py: parallel SAGE streams over joint
positions and root-padded bone vectors, concatenated into an FFN header.

The skeleton graph is tiny and fixed, so SAGEConv(aggr='mean') is a dense
(N, N) row-normalized adjacency product: x' = x W_root + rownorm(A) x W_neigh
+ b. GraphLayerNorm normalizes each sample over its nodes and channels, as
the JAX package does. Dropout in the header draws from an explicit
``torch.Generator`` passed to ``forward``. Parameters are fp32 and so is the
forward: the poses it scores are fp32 decode outputs.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def skeleton_adjacency(parent_ids, child_ids, num_nodes: int,
                       self_loop_weight: float = 0.0) -> np.ndarray:
    """Symmetric 0/1 bone adjacency plus weighted self loops."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    for p, c in zip(parent_ids, child_ids):
        a[p, c] = 1.0
        a[c, p] = 1.0
    a += self_loop_weight * np.eye(num_nodes, dtype=np.float32)
    return a


def positional_encoding(num_nodes: int, channels: int) -> np.ndarray:
    """Sinusoidal encoding of the joint index."""
    pe = np.zeros((num_nodes, channels), dtype=np.float32)
    for i in range(num_nodes):
        for j in range(channels):
            arg = i / 10000 ** (2 * j / channels)
            pe[i, j] = math.sin(arg) if j % 2 == 0 else math.cos(arg)
    return pe


class DenseSAGE(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.lin_neigh = nn.Linear(cin, cout)
        self.lin_root = nn.Linear(cin, cout, bias=False)

    def forward(self, x, adj_rownorm):
        neigh = torch.einsum("ij,bjc->bic", adj_rownorm, x)
        return self.lin_neigh(neigh) + self.lin_root(x)


class GraphLayerNorm(nn.Module):
    """LayerNorm over (nodes, channels) of each sample, per-channel affine."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class SAGEResidualBlock(nn.Module):
    """Two SAGE + LN + ReLU layers with a skip, or one terminal layer."""

    def __init__(self, cin: int, hidden: int, cout: int,
                 single_layer: bool = False):
        super().__init__()
        self.single_layer = single_layer
        if single_layer:
            self.sage = nn.ModuleList([DenseSAGE(cin, cout)])
            self.norm = nn.ModuleList([GraphLayerNorm(cout)])
        else:
            self.sage = nn.ModuleList([DenseSAGE(cin, hidden),
                                       DenseSAGE(hidden, cout)])
            self.norm = nn.ModuleList([GraphLayerNorm(hidden),
                                       GraphLayerNorm(cout)])

    def forward(self, x, adj_rownorm):
        y = x
        for sage, norm in zip(self.sage, self.norm):
            y = F.relu(norm(sage(y, adj_rownorm)))
        return y if self.single_layer else y + x


class FFNHeader(nn.Module):
    """Linear -> ReLU -> Dropout(p) -> Linear(1)."""

    def __init__(self, cin: int, hidden: int = 512, p_dropout: float = 0.2):
        super().__init__()
        self.dense0 = nn.Linear(cin, hidden)
        self.dense1 = nn.Linear(hidden, 1)
        self.p_dropout = p_dropout

    def forward(self, x, generator: torch.Generator | None = None):
        x = F.relu(self.dense0(x))
        if self.training and self.p_dropout > 0:
            keep = 1.0 - self.p_dropout
            mask = torch.rand(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.dense1(x)


class GCNDiscriminatorDecouple(nn.Module):
    def __init__(self, parent_ids: Sequence[int], child_ids: Sequence[int],
                 input_dim: int = 128, hidden_dim: int = 128,
                 output_dim: int = 128, num_nodes: int = 18,
                 disc_sup_dim: int = 3, num_layers: int = 2,
                 use_self_loop: bool = True, use_pe: bool = True):
        super().__init__()
        self.num_nodes = num_nodes
        self.disc_sup_dim = disc_sup_dim
        self.parent_ids = list(parent_ids)
        self.child_ids = list(child_ids)
        adj = skeleton_adjacency(parent_ids, child_ids, num_nodes,
                                 1.0 if use_self_loop else 0.0)
        self.register_buffer("rownorm", torch.from_numpy(
            adj / adj.sum(axis=1, keepdims=True).clip(1e-12)),
            persistent=False)
        cin = disc_sup_dim
        if use_pe:
            self.register_buffer("pe", torch.from_numpy(
                positional_encoding(num_nodes, disc_sup_dim)),
                persistent=False)
            cin *= 2
        else:
            self.pe = None
        for tag in ("joint", "bone"):
            setattr(self, f"{tag}_input", nn.Linear(cin, input_dim))
            blocks = [SAGEResidualBlock(input_dim if i == 0 else hidden_dim,
                                        hidden_dim, hidden_dim)
                      for i in range(num_layers)]
            setattr(self, f"{tag}_blocks", nn.ModuleList(blocks))
            setattr(self, f"{tag}_final", SAGEResidualBlock(
                hidden_dim, hidden_dim, output_dim, single_layer=True))
        self.header = FFNHeader(2 * num_nodes * output_dim)

    def _stream(self, x, tag: str):
        x = getattr(self, f"{tag}_input")(x)
        for block in getattr(self, f"{tag}_blocks"):
            x = block(x, self.rownorm)
        x = getattr(self, f"{tag}_final")(x, self.rownorm)
        return x.reshape(x.shape[0], -1)

    def forward(self, keypoints, generator: torch.Generator | None = None):
        """(N, num_nodes, disc_sup_dim) poses -> (N, 1) logits."""
        b, _, c = keypoints.shape
        start = keypoints[:, self.child_ids, :]
        end = keypoints[:, self.parent_ids, :]
        bone = torch.cat([keypoints.new_zeros((b, 1, c)), end - start], dim=1)
        if self.pe is not None:
            pe = self.pe.expand(b, -1, -1)
            kp_in = torch.cat([keypoints, pe], dim=-1)
            bone_in = torch.cat([bone, pe], dim=-1)
        else:
            kp_in, bone_in = keypoints, bone
        feats = torch.cat([self._stream(kp_in, "joint"),
                           self._stream(bone_in, "bone")], dim=-1)
        return self.header(feats, generator)


def build_discriminator(disc_params: dict, parent_ids, child_ids):
    """The discriminator a config's ``smpl_disc_params`` names; only the
    decoupled SAGE discriminator is ported."""
    name = disc_params["name"]
    if "gcn" not in name or "decouple" not in name:
        raise NotImplementedError(f"discriminator {name!r} is not ported")
    return GCNDiscriminatorDecouple(
        parent_ids, child_ids,
        input_dim=disc_params["input_dim"],
        hidden_dim=disc_params["hidden_dim"],
        output_dim=disc_params["output_dim"],
        num_nodes=disc_params["num_node"],
        disc_sup_dim=disc_params.get("disc_sup_dim", 3),
        num_layers=disc_params.get("num_layers", 2),
        use_self_loop=disc_params.get("use_self_loop", True),
        use_pe=disc_params.get("use_pe", False),
    )
