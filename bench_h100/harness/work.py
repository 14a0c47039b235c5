"""The work a step or a request has to do, counted from layer shapes: the
model FLOPs of every convolution and GEMM, and each hand-written kernel's
calls with their operations and bytes. Whatever implements an op, these
counts stay the same.

The card's published peaks (NVIDIA's data sheet, H100 SXM5, dense, at the
full 700 W) are the yardstick of every roofline and MFU share.
"""

from __future__ import annotations

from dataclasses import dataclass

# keyed by a part of torch.cuda.get_device_name(): bf16 and fp32 (outside
# the tensor cores) FLOP/s, HBM bytes/s
CARD_PEAKS = {
    "H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
}
ELT = {"bf16": 2, "fp32": 4}


def card_peaks(name: str) -> dict:
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for {name!r}")


@dataclass(frozen=True)
class Conv:
    """A convolution on one image: input (cin, h, w), k x k, stride, pad;
    ``transposed`` a transposed one (its input pixels each scatter k^2
    outputs)."""

    cin: int
    cout: int
    k: int
    stride: int
    h: int
    w: int
    transposed: bool = False
    pad: int = -1

    def out_hw(self) -> tuple[int, int]:
        if self.transposed:
            return self.h * self.stride, self.w * self.stride
        p = self.k // 2 if self.pad < 0 else self.pad
        return ((self.h + 2 * p - self.k) // self.stride + 1,
                (self.w + 2 * p - self.k) // self.stride + 1)

    def flops(self) -> float:
        """Multiply-adds x 2 of one image's forward."""
        pix = self.h * self.w if self.transposed else \
            self.out_hw()[0] * self.out_hw()[1]
        return 2.0 * pix * self.cin * self.cout * self.k * self.k


def resnet_convs(depth: int, side: int) -> tuple[list[Conv], list[Conv]]:
    """(all convs of the backbone, the stride-1 3x3 convs of the
    bottlenecks with planes >= 256: the program's BN -> ReLU -> conv link)
    for one image of side^2."""
    kind, counts = {18: ("basic", (2, 2, 2, 2)),
                    50: ("bottleneck", (3, 4, 6, 3))}[depth]
    convs = [Conv(3, 64, 7, 2, side, side, pad=3)]
    h = (side + 1) // 2
    h = (h + 1) // 2  # max pool 3, stride 2
    cin, link = 64, []
    for s, n in enumerate(counts):
        planes = 64 * 2 ** s
        for i in range(n):
            stride = 2 if s > 0 and i == 0 else 1
            if kind == "basic":
                out = planes
                convs += [Conv(cin, planes, 3, stride, h, h)]
                ho = convs[-1].out_hw()[0]
                convs += [Conv(planes, planes, 3, 1, ho, ho)]
            else:
                out = planes * 4
                c2 = Conv(planes, planes, 3, stride, h, h)
                ho = c2.out_hw()[0]
                convs += [Conv(cin, planes, 1, 1, h, h), c2,
                          Conv(planes, out, 1, 1, ho, ho)]
                if stride == 1 and planes >= 256:
                    link.append(c2)
            if stride != 1 or cin != out:
                convs.append(Conv(cin, out, 1, stride, h, h))
            cin, h = out, convs[-1].out_hw()[0]
    return convs, link


def detector_convs(det: dict, side: int) -> tuple[list[Conv], list[Conv]]:
    """(every conv of the detector for one image, the link's convs)."""
    backbone, link = resnet_convs(det.get("num_layers", 50), side)
    cin = backbone[-1].cout
    h = backbone[-1].out_hw()[0]
    head = []
    for _ in range(3):
        head.append(Conv(cin, 256, 4, 2, h, h, transposed=True))
        cin, h = 256, h * 2
    head.append(Conv(256, det["num_kp"] * det["depth_dim"], 1, 1, h, h))
    return backbone + head, link


def physique_convs(layers, side: int) -> list[Conv]:
    """The physique net's 3x3 convs, in order, for one image."""
    nf = list(layers)
    ops = [("c", nf[0], 1)]
    for i in range(1, len(nf)):
        ops += [("c", nf[i - 1], 1), ("c", nf[i], 2)]
    for i in range(len(nf) - 1, 0, -1):
        ops += [("c", nf[i], 1), ("u",), ("c", nf[i - 1], 1)]
    ops.append(("c", 1, 1))
    convs, cin, h = [], 1, side
    for op in ops:
        if op[0] == "u":
            h *= 2
            continue
        convs.append(Conv(cin, op[1], 3, op[2], h, h))
        cin, h = op[1], convs[-1].out_hw()[0]
    return convs


def discriminator_flops(p: dict) -> float:
    """Forward FLOPs of one pose through the decoupled SAGE discriminator:
    per stream the input layer, the SAGE layers (neighbour and root
    linears, the adjacency product), then the FFN header."""
    n, c = p["num_node"], p.get("disc_sup_dim", 3)
    ind, hid, out = p["input_dim"], p["hidden_dim"], p["output_dim"]
    sage = []
    for i in range(p.get("num_layers", 2)):
        sage += [(ind if i == 0 else hid, hid), (hid, hid)]
    sage.append((hid, out))
    stream = 2.0 * n * (2 * c) * ind
    for a, b in sage:
        stream += 2.0 * n * a * b * 2 + 2.0 * n * n * a
    return 2 * stream + 2.0 * (2 * n * out) * 512 + 2.0 * 512


def link_call(conv: Conv, batch: int, dtype: str, peaks: dict) -> float:
    """Least seconds of one link call on `batch` images: BN-apply, ReLU and
    the 3x3 conv, plus the output's per-channel sums. Reads x and the
    weights once and writes y once (the stats and the folded scale and
    shift in fp32)."""
    e = ELT[dtype]
    h, w = conv.out_hw()
    flops = batch * conv.flops()
    nbytes = (batch * conv.cin * conv.h * conv.w * e
              + 9 * conv.cin * conv.cout * e
              + batch * conv.cout * h * w * e
              + 4 * (2 * conv.cin + 2 * conv.cout))
    return max(flops / peaks[dtype], nbytes / peaks["hbm"])


def conv3x3_call(conv: Conv, batch: int, dtype: str, peaks: dict) -> float:
    """Least seconds of one 3x3 conv kernel call (bias in fp32)."""
    e = ELT[dtype]
    h, w = conv.out_hw()
    nbytes = (batch * conv.cin * conv.h * conv.w * e
              + 9 * conv.cin * conv.cout * e + 4 * conv.cout
              + batch * conv.cout * h * w * e)
    return max(batch * conv.flops() / peaks[dtype], nbytes / peaks["hbm"])


def conv3x3_train_calls(layers, side: int) -> list[Conv]:
    """The physique net's kernel calls in a training step: every conv's
    forward, and the input gradient of each stride-1 conv (the same
    kernel on the output gradient, Cout -> Cin)."""
    convs = physique_convs(layers, side)
    back = [Conv(c.cout, c.cin, 3, 1, *c.out_hw()) for c in convs
            if c.stride == 1]
    return convs + back


def link_forwards_per_step(remat) -> int:
    """Detector forwards in a training step that run the link: the camera
    and pseudo streams, each again in the backward under ``full`` remat.
    None where the mode recomputes some other part."""
    mode = {True: "full", False: "none", None: "none"}.get(remat, remat)
    return {"none": 2, "full": 4, "decode": 2, "head_decode": 2}.get(mode)


def train_step_work(config: dict, batch_per_camera: int, dtype: str,
                    peaks: dict) -> dict:
    """Model FLOPs of one fused GAN step (forward, and backward at twice
    the forward, save the input gradient of a layer whose input needs none;
    recomputation not counted), and the least seconds a step's link and
    conv3x3 calls could take."""
    mp = config["model_params"]
    side = int(config["train_params"]["patch_width"])
    nc = len(mp["cam_id_list"])
    n = nc * batch_per_camera
    det = mp["detector_params"]
    convs, link = detector_convs(det, side)
    det_fwd = n * sum(c.flops() for c in convs)
    stem = n * convs[0].flops()
    flops = 2 * (3 * det_fwd - stem)  # the camera and the pseudo stream
    phy = physique_convs(mp["physique_mask_generator_params"]["layers"],
                         side)
    flops += 3 * n * sum(c.flops() for c in phy)
    hypos = det["num_hypo"]
    dp = mp["smpl_disc_params"]
    d1 = discriminator_flops(dp)
    first = 2.0 * dp["num_node"] * 2 * dp.get("disc_sup_dim", 3) * \
        dp["input_dim"] * 2
    # the generator's pass over every hypothesis, the discriminator's over
    # every hypothesis and the real poses; inputs detached in both
    flops += (n * hypos + n * hypos + n) * (3 * d1 - first)
    remat = mp.get("remat", True)
    fwd = link_forwards_per_step(remat)
    return {
        "model_flops": flops,
        "link_least_s": None if fwd is None else fwd * sum(
            link_call(c, n, dtype, peaks) for c in link),
        "conv3x3_least_s": sum(
            conv3x3_call(c, n, dtype, peaks) for c in conv3x3_train_calls(
                mp["physique_mask_generator_params"]["layers"], side)),
    }


def serve_request_work(config: dict, images: int, server_batch: int,
                       dtype: str, peaks: dict) -> dict:
    """Detector-forward FLOPs of one request, and the least seconds of its
    link calls (one forward per server batch)."""
    det = config["model_params"]["detector_params"]
    side = int(config["train_params"]["patch_width"])
    convs, link = detector_convs(det, side)
    chunks = [min(server_batch, images - s)
              for s in range(0, images, server_batch)]
    return {
        "model_flops": images * sum(c.flops() for c in convs),
        "link_least_s": sum(link_call(c, b, dtype, peaks)
                            for b in chunks for c in link),
    }
