"""The pose discriminators, ported from the JAX package's
models/discriminator.py: the default ``GCNDiscriminatorDecouple`` (parallel
SAGE streams over joint positions and root-padded bone vectors, concatenated
into an FFN header), ``GCNSAGEDiscriminator`` (one residual SAGE stack and a
linear header) and ``GCNDiscriminator`` (the ``simple_gcn`` and ``res_gcn``
GCN stacks on a per-sample 1/bone-length adjacency).

The skeleton graph is tiny and fixed, so SAGEConv(aggr='mean') is a dense
(N, N) row-normalized adjacency product: x' = x W_root + rownorm(A) x W_neigh
+ b, and GCNConv is D^-1/2 A D^-1/2 x W + b with the bias added after the
aggregation. GraphLayerNorm normalizes each sample over its nodes and
channels, as the JAX package does. Dropout draws from an explicit
``torch.Generator`` passed to ``forward``. Parameters are fp32 and so is the
forward: the poses it scores are fp32 decode outputs.

Data parallelism (parallel/): ``forward``'s ``rows`` says which rows of the
global batch this rank's poses are, ``(n, index)``: dropout draws its mask
at the global shape and takes those rows, so each rank draws what one
process draws for them. StatelessBN takes its statistics over the global
batch in a process group.

Tensor parallelism (parallel/tp.py): every Linear whose weight holds fewer
outputs than its width is this rank's shard; it computes its output shard
and gathers it at once, so the adjacency products, GraphLayerNorm,
StatelessBN, ReLU and dropout (the global mask, as one process draws it)
all run on whole features, with their split affines and biases gathered.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import collectives as C
from ..parallel import tp
from .resnet import split_input


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


class Linear(nn.Linear):
    """nn.Linear; a weight of fewer than out_features rows is this rank's
    shard under tensor parallelism: the input passes copy_to_model, the
    output shard (with the bias's shard) is gathered along the last dim."""

    def forward(self, x):
        shard = self.weight.shape[0]
        if shard == self.out_features:
            return super().forward(x)
        x, bias = split_input(x, self.bias, shard)
        return C.gather_channels(F.linear(x, self.weight, bias), -1)


class DenseSAGE(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.lin_neigh = Linear(cin, cout)
        self.lin_root = Linear(cin, cout, bias=False)

    def forward(self, x, adj_rownorm):
        neigh = torch.einsum("ij,bjc->bic", adj_rownorm, x)
        return self.lin_neigh(neigh) + self.lin_root(x)


class GraphLayerNorm(nn.Module):
    """LayerNorm over (nodes, channels) of each sample, per-channel affine."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.channels = channels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
        return ((x - mean) / torch.sqrt(var + self.eps)
                * tp.full_param(self.weight, self.channels)
                + tp.full_param(self.bias, self.channels))


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


def dropout(x, p: float, training: bool,
            generator: torch.Generator | None = None, rows=None):
    """Inverted dropout (flax's nn.Dropout): each value kept with
    probability 1 - p and scaled by 1 / (1 - p), the mask drawn from
    `generator`; the identity outside training or at p = 0. `rows`
    ``(n, index)``: x holds those rows of a global batch of n rows, and the
    mask is drawn for all n and those rows taken."""
    if not training or p <= 0:
        return x
    keep = 1.0 - p
    shape = x.shape if rows is None else (rows[0], *x.shape[1:])
    u = torch.rand(shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    mask = (u if rows is None else u[rows[1]]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class FFNHeader(nn.Module):
    """Linear -> ReLU -> Dropout(p) -> Linear(1)."""

    def __init__(self, cin: int, hidden: int = 512, p_dropout: float = 0.2):
        super().__init__()
        self.dense0 = Linear(cin, hidden)
        self.dense1 = Linear(hidden, 1)
        self.p_dropout = p_dropout

    def forward(self, x, generator: torch.Generator | None = None,
                rows=None):
        x = F.relu(self.dense0(x))
        return self.dense1(dropout(x, self.p_dropout, self.training,
                                   generator, rows))


class DenseGCNLayer(nn.Module):
    """GCNConv on a per-sample sym-normalized dense adjacency: the bias is
    added after the aggregation, A_norm (x W) + b."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.lin = Linear(cin, cout, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, adj_norm):
        return (torch.einsum("bij,bjc->bic", adj_norm, self.lin(x))
                + tp.full_param(self.bias, self.lin.out_features))


def sym_normalize(adj, eps: float = 1e-12):
    """D^-1/2 A D^-1/2 per sample; a node of degree <= eps gets 0."""
    deg = adj.sum(dim=-1)
    inv_sqrt = torch.where(deg > eps, torch.rsqrt(deg.clamp_min(eps)),
                           torch.zeros_like(deg))
    return adj * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]


class StatelessBN(nn.Module):
    """Per-channel batch normalization over (batch, node) of (B, N, C) with a
    learned affine and no running statistics: batch statistics in eval too
    (the JAX package's _StatelessBN; not nn.BatchNorm1d). In a process
    group, the global batch's: two-pass, through two all-reduces."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.channels = channels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if C.is_distributed():
            n = x.shape[0] * x.shape[1] * C.data_size()
            mean = C.psum_data(x.sum(dim=(0, 1), keepdim=True)) / n
            var = C.psum_data(((x - mean) ** 2).sum(dim=(0, 1),
                                                    keepdim=True)) / n
        else:
            mean = x.mean(dim=(0, 1), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(0, 1), keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return (y * tp.full_param(self.weight, self.channels)
                + tp.full_param(self.bias, self.channels))


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
            setattr(self, f"{tag}_input", Linear(cin, input_dim))
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

    def forward(self, keypoints, generator: torch.Generator | None = None,
                rows=None):
        """(N, num_nodes, disc_sup_dim) poses -> (N, 1) logits; `rows`:
        the poses' rows of the global batch (dropout's draws)."""
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
        return self.header(feats, generator, rows)


class GCNSAGEDiscriminator(nn.Module):
    """A residual SAGE stack over the joints and a linear header (no FFN,
    no dropout)."""

    def __init__(self, parent_ids: Sequence[int], child_ids: Sequence[int],
                 input_dim: int = 128, hidden_dim: int = 128,
                 output_dim: int = 128, num_nodes: int = 18,
                 disc_sup_dim: int = 3, num_layers: int = 2,
                 use_self_loop: bool = True, use_pe: bool = False):
        super().__init__()
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
        self.input = Linear(cin, input_dim)
        self.blocks = nn.ModuleList([
            SAGEResidualBlock(input_dim if i == 0 else hidden_dim,
                              hidden_dim, hidden_dim)
            for i in range(num_layers)])
        self.final = SAGEResidualBlock(hidden_dim, hidden_dim, output_dim,
                                       single_layer=True)
        self.header = Linear(num_nodes * output_dim, 1)

    def forward(self, keypoints, generator: torch.Generator | None = None,
                rows=None):
        """(N, num_nodes, disc_sup_dim) poses -> (N, 1) logits (no
        dropout, so `rows` is unused)."""
        x = keypoints
        if self.pe is not None:
            x = torch.cat([x, self.pe.expand(x.shape[0], -1, -1)], dim=-1)
        x = self.input(x)
        for block in self.blocks:
            x = block(x, self.rownorm)
        x = self.final(x, self.rownorm)
        return self.header(x.reshape(x.shape[0], -1))


class GCNDiscriminator(nn.Module):
    """``simple_gcn`` (two GCN layers) or ``res_gcn`` (a GCN layer, then
    `num_layers` residual pairs of GCN layers, each followed by the optional
    StatelessBN, ReLU and dropout 0.5, then an output GCN layer), on the
    per-sample adjacency with 1/bone-length edge weights, and a linear
    header. Under ``use_self_loop`` the identity is added twice, as the
    reference adds it to the weight matrix and again inside GCNConv."""

    def __init__(self, parent_ids: Sequence[int], child_ids: Sequence[int],
                 variant: str = "res_gcn", input_dim: int = 128,
                 hidden_dim: int = 128, output_dim: int = 128,
                 num_nodes: int = 18, disc_sup_dim: int = 3,
                 num_layers: int = 2, use_self_loop: bool = True,
                 use_bn: bool = False, p_dropout: float = 0.5):
        super().__init__()
        if variant not in ("simple_gcn", "res_gcn"):
            raise NotImplementedError(f"GCN discriminator variant {variant!r}")
        self.variant = variant
        self.num_layers = num_layers
        self.num_nodes = num_nodes
        self.parent_ids = list(parent_ids)
        self.child_ids = list(child_ids)
        self.use_self_loop = use_self_loop
        self.p_dropout = p_dropout
        self.input = Linear(disc_sup_dim, input_dim)
        if variant == "simple_gcn":
            dims = [(input_dim, hidden_dim), (hidden_dim, hidden_dim)]
        else:
            dims = ([(input_dim, hidden_dim)]
                    + [(hidden_dim, hidden_dim)] * (2 * num_layers)
                    + [(hidden_dim, output_dim)])
        self.gcn = nn.ModuleList([DenseGCNLayer(a, b) for a, b in dims])
        n_bn = 2 * num_layers if variant == "res_gcn" and use_bn else 0
        self.bns = nn.ModuleList([StatelessBN(hidden_dim)
                                  for _ in range(n_bn)])
        self.header = Linear(num_nodes * dims[-1][1], 1)

    def bn_cancelled_biases(self) -> list[str]:
        """Names of the GCN biases that a StatelessBN follows: its mean
        subtraction cancels them, so their gradient is zero up to
        rounding."""
        return [f"gcn.{i + 1}.bias" for i in range(len(self.bns))]

    def adjacency(self, keypoints):
        """(B, N, N) sym-normalized adjacency: 1/bone-length on the skeleton
        edges, 2 I added under use_self_loop."""
        b, n = keypoints.shape[0], self.num_nodes
        diff = keypoints[:, self.parent_ids] - keypoints[:, self.child_ids]
        inv_len = 1.0 / torch.sqrt((diff ** 2).sum(-1) + 1e-12)
        adj = keypoints.new_zeros((b, n, n))
        adj[:, self.parent_ids, self.child_ids] = inv_len
        adj[:, self.child_ids, self.parent_ids] = inv_len
        if self.use_self_loop:
            adj = adj + 2.0 * torch.eye(n, dtype=adj.dtype, device=adj.device)
        return sym_normalize(adj)

    def forward(self, keypoints, generator: torch.Generator | None = None,
                rows=None):
        """(N, num_nodes, disc_sup_dim) poses -> (N, 1) logits; `rows`:
        the poses' rows of the global batch (dropout's draws)."""
        adj = self.adjacency(keypoints)
        x = self.input(keypoints)
        gcn = iter(self.gcn)
        x = F.relu(next(gcn)(x, adj))
        if self.variant == "simple_gcn":
            x = F.relu(next(gcn)(x, adj))
        else:
            bns = iter(self.bns)
            for _ in range(self.num_layers):
                res = x
                y = x
                for _ in range(2):
                    y = next(gcn)(y, adj)
                    if self.bns:
                        y = next(bns)(y)
                    y = dropout(F.relu(y), self.p_dropout, self.training,
                                generator, rows)
                x = y + res
            x = F.relu(next(gcn)(x, adj))
        return self.header(x.reshape(x.shape[0], -1))


def build_discriminator(disc_params: dict, parent_ids, child_ids):
    """The discriminator a config's ``smpl_disc_params`` names, by the JAX
    package's substring dispatch: a name with "decouple" builds the
    decoupled SAGE discriminator, with "sage" the SAGE one, any other "gcn"
    name the GCN one of that variant (an unknown variant raises)."""
    name = disc_params["name"]
    if "gcn" not in name:
        raise NotImplementedError(f"discriminator {name!r}")
    common = dict(
        input_dim=disc_params["input_dim"],
        hidden_dim=disc_params["hidden_dim"],
        output_dim=disc_params["output_dim"],
        num_nodes=disc_params["num_node"],
        disc_sup_dim=disc_params.get("disc_sup_dim", 3),
        num_layers=disc_params.get("num_layers", 2),
        use_self_loop=disc_params.get("use_self_loop", True),
    )
    if "decouple" in name:
        return GCNDiscriminatorDecouple(
            parent_ids, child_ids, use_pe=disc_params.get("use_pe", False),
            **common)
    if "sage" in name:
        return GCNSAGEDiscriminator(
            parent_ids, child_ids, use_pe=disc_params.get("use_pe", False),
            **common)
    return GCNDiscriminator(parent_ids, child_ids, variant=name,
                            use_bn=disc_params.get("use_bn", False), **common)
