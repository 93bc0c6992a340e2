"""The plain reference of MM-Hand's GAN: the 3-stream PATN generator, the
ResNet discriminators D_PB and D_PP, the VGG19 perceptual loss, the BCE GAN
terms, the image pools while they fill, and the three Adam updates, in the
order of the MM-Hand trainer (models/MMHandModel.py of VITA-Group/mm-hand):
one generator update on L1 + perceptual + both discriminators on the fake,
then a D_PP step and a D_PB step on the pre-update fake.

Float32, plain torch (``layers``), NCHW inside and NHWC at the nets'
edges.  The module names and sequential indices follow the reference
torch layout, so one weight dictionary, keyed ``<net>.<parameter>``, loads
into the reference and into the measured program alike.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    BatchNorm,
    MaskDropout,
    QConv2d,
    QConvTranspose2d,
    adam_step,
    frozen_running_stats,
)
from benchmark.traffic.png import read_png

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HEATMAP_CLIP = 0.0099
GAN_DEPTH_SCALE = 700.0
LOSS_KEYS = ("pair_L1loss", "pair_GANloss", "D_PP", "D_PB")


def _pad_conv(cin, cout, k, pad, bias):
    return [nn.ReflectionPad2d(pad), QConv2d(cin, cout, k, bias=bias)]


def _conv_bn_relu(cin, cout, k, pad, stride=1, reflect=True):
    conv = (_pad_conv(cin, cout, k, pad, False) if reflect else
            [QConv2d(cin, cout, k, stride, padding=pad, bias=False)])
    return [*conv, BatchNorm(cout), nn.ReLU()]


def _down_stem(cin, ngf, n_down):
    layers = _conv_bn_relu(cin, ngf, 7, 3)
    for i in range(n_down):
        layers += _conv_bn_relu(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 1,
                                stride=2, reflect=False)
    return nn.Sequential(*layers)


def _att_stream(dim, cated, cal_att, dropout):
    width = dim * 2 if (cated and cal_att) else dim
    layers = _conv_bn_relu(width, width, 3, 1)
    if dropout:
        layers.append(MaskDropout())
    layers += _pad_conv(width, dim, 3, 1, False)
    if not cal_att:
        layers.append(BatchNorm(dim))
    return nn.Sequential(*layers)


class PATBlock(nn.Module):
    def __init__(self, dim, cated, dropout):
        super().__init__()
        self.conv_block_stream1 = _att_stream(dim, False, False, dropout)
        self.conv_block_stream2 = _att_stream(dim, cated, True, dropout)
        self.conv_block_stream3 = _att_stream(dim, cated, True, dropout)

    def forward(self, x1, x2, x3):
        y1 = self.conv_block_stream1(x1)
        y2 = self.conv_block_stream2(x2)
        y3 = self.conv_block_stream3(x3)
        out = x1 + y1 * torch.sigmoid(y2) * torch.sigmoid(y3)
        # the pose and depth streams swap at every block, as in MM-Hand
        return out, torch.cat([y3, out], 1), torch.cat([y2, out], 1)


class Generator(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        ngf, nd = m["ngf"], m["g_n_downsampling"]
        dropout = m["use_dropout_g"]
        ins = (m["h_input_nc"], 2 * m["p_input_nc"], 2 * m["d_input_nc"])
        self.stream1_down = _down_stem(ins[0], ngf, nd)
        self.stream2_down = _down_stem(ins[1], ngf, nd)
        self.stream3_down = _down_stem(ins[2], ngf, nd)
        dim = ngf * 2 ** nd
        self.att = nn.ModuleList(PATBlock(dim, i != 0, dropout)
                                 for i in range(m["g_n_blocks"]))
        up = []
        for i in range(nd):
            mult = 2 ** (nd - i)
            up += [QConvTranspose2d(ngf * mult, ngf * mult // 2, 3, 2, 1,
                                    output_padding=1, bias=False),
                   BatchNorm(ngf * mult // 2), nn.ReLU()]
        up += _pad_conv(ngf, m["output_nc"], 7, 3, True)
        self.stream1_up = nn.Sequential(*up)

    def forward(self, image, pose, depth):
        x1, x2, x3 = (t.permute(0, 3, 1, 2) for t in (image, pose, depth))
        x1 = self.stream1_down(x1)
        x2 = self.stream2_down(x2)
        x3 = self.stream3_down(x3)
        for block in self.att:
            x1, x2, x3 = block(x1, x2, x3)
        return torch.tanh(self.stream1_up(x1)).permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, dim, dropout):
        super().__init__()
        layers = _conv_bn_relu(dim, dim, 3, 1)
        if dropout:
            layers.append(MaskDropout())
        layers += _pad_conv(dim, dim, 3, 1, False) + [BatchNorm(dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class Discriminator(nn.Sequential):
    """No final projection: the logits are the ndf*4-channel feature map,
    as in MM-Hand."""

    def __init__(self, cin: int, m: dict):
        ndf = m["ndf"]
        layers = _conv_bn_relu(cin, ndf, 7, 3)
        width = ndf
        for i in range(m["d_n_downsampling"]):
            layers += _conv_bn_relu(width, ndf * 2 ** (i + 1), 3, 1,
                                    stride=2, reflect=False)
            width = ndf * 2 ** (i + 1)
        layers += [ResnetBlock(width, m["use_dropout_d"])
                   for _ in range(m["n_layers_d"])]
        super().__init__(*layers)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class VGGFeatures(nn.Sequential):
    """torchvision's vgg19().features up to index ``upto`` (3: relu1_2)."""

    def __init__(self, upto: int):
        cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M"]
        layers, width = [], 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [QConv2d(width, v, 3, padding=1), nn.ReLU()]
                width = v
        super().__init__(*layers[:upto + 1])

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def build_nets(m: dict, vgg_upto: int, device) -> dict:
    """{'generator', 'd_pb', 'd_pp', 'vgg'} on ``device``, weights unset."""
    nets = {"generator": Generator(m),
            "d_pb": Discriminator(m["h_input_nc"] + m["p_input_nc"], m),
            "d_pp": Discriminator(2 * m["h_input_nc"], m),
            "vgg": VGGFeatures(vgg_upto)}
    return {k: v.to(device) for k, v in nets.items()}


def load_weights(nets: dict, weights: dict) -> None:
    with torch.no_grad():
        for prefix, net in nets.items():
            for name, p in net.named_parameters():
                p.copy_(weights[f"{prefix}.{name}"])


# --- data --------------------------------------------------------------


def heatmaps(uv: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """(B, K, 2) keypoints -> (B, S, S, K) Gaussian maps, clipped below
    0.0099 (MM-Hand's generic_dataset)."""
    x = uv[..., 0][:, None, None, :]
    y = uv[..., 1][:, None, None, :]
    grid = torch.arange(size, dtype=torch.float32, device=uv.device)
    d2 = (grid[None, None, :, None] - x) ** 2 + (grid[None, :, None, None]
                                                 - y) ** 2
    m = torch.exp(-d2 / (2.0 * sigma * sigma)).clamp(max=1.0)
    return torch.where(m < HEATMAP_CLIP, torch.zeros_like(m), m)


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    return (img_u8.float() / 255.0 - 0.5) / 0.5


def read_items(root: str, annos: dict, paths) -> dict:
    """The images, packed depths and keypoints of ``paths`` (their file
    names under ``root``), read by the benchmark's own decoder."""
    names = [os.path.basename(p) for p in paths]
    img = np.stack([read_png(os.path.join(root, "color", n)) for n in names])
    rgb = np.stack([read_png(os.path.join(root, "depth", n))
                    for n in names]).astype(np.float32)
    depth = (256.0 * rgb[..., 1] + rgb[..., 0]) / GAN_DEPTH_SCALE
    uv = np.stack([np.asarray(annos["color"][n]["uv_coord"], np.float32)
                   for n in names])
    return {"image": img, "depth": depth, "uv": uv}


def gan_batch(root: str, annos: dict, src_paths, tgt_paths, sigma: float,
              device) -> dict:
    """The generator's six NHWC inputs of one batch."""
    out = {}
    for tag, paths in (("1", src_paths), ("2", tgt_paths)):
        items = read_items(root, annos, paths)
        img = torch.from_numpy(items["image"]).to(device)
        d = (torch.from_numpy(items["depth"]).to(device) - 0.5) / 0.5
        uv = torch.from_numpy(items["uv"]).to(device)
        out["H" + tag] = normalize(img)
        out["P" + tag] = heatmaps(uv, img.shape[1], sigma)
        out["D" + tag] = torch.stack([d, d, d], -1)
    return out


def g_inputs(b: dict):
    return (b["H1"], torch.cat([b["P1"], b["P2"]], -1),
            torch.cat([b["D1"], b["D2"]], -1))


# --- training ----------------------------------------------------------


def _renorm(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return ((img + 1.0) / 2.0 - mean) / std


def _bce(logits: torch.Tensor, real: bool) -> torch.Tensor:
    """Mean BCE-with-logits against an all-real or all-fake target."""
    return F.softplus(-logits if real else logits).mean()


def train_steps(nets: dict, batches: list, lrs: list, hp: dict) -> dict:
    """The trainer's steps on ``batches``; returns each step's losses
    (LOSS_KEYS), each parameter's gradient norm at the first step
    (``<net>.<name>``), and each parameter's change after the last step.
    ``hp``: lambda_a, lambda_b, lambda_gan, beta1, beta2, pool_size."""
    g, d_pb, d_pp, vgg = (nets[k] for k in ("generator", "d_pb", "d_pp",
                                           "vgg"))
    for net in nets.values():
        net.train()
    vgg.requires_grad_(False)
    trained = {"generator": g, "d_pb": d_pb, "d_pp": d_pp}
    start = {f"{k}.{n}": p.detach().clone()
             for k, net in trained.items() for n, p in net.named_parameters()}
    states = {k: {} for k in trained}
    pooled = 0
    losses, grad_norms = [], {}

    def update(key, loss, lr, first):
        net = trained[key]
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params)
        if first:
            for (n, _), gr in zip(net.named_parameters(), grads):
                grad_norms[f"{key}.{n}"] = float(gr.norm())
        adam_step(params, grads, states[key], lr, (hp["beta1"], hp["beta2"]),
                  1e-8)

    for i, (b, lr) in enumerate(zip(batches, lrs)):
        h1, h2, p2 = b["H1"], b["H2"], b["P2"]
        for net in (d_pb, d_pp):
            net.requires_grad_(False)
        with frozen_running_stats(d_pb, d_pp):
            fake = g(*g_inputs(b))
            gan_pb = _bce(d_pb(torch.cat([fake, p2], -1)), True)
            gan_pp = _bce(d_pp(torch.cat([fake, h1], -1)), True)
        for net in (d_pb, d_pp):
            net.requires_grad_(True)
        l1 = (fake - h2).abs().mean() * hp["lambda_a"]
        with torch.no_grad():
            f_real = vgg(_renorm(h2))
        percep = (vgg(_renorm(fake)) - f_real).abs().mean() * hp["lambda_b"]
        pair_l1 = l1 + percep
        pair_gan = (gan_pb * hp["lambda_gan"] + gan_pp * hp["lambda_gan"]) / 2
        update("generator", pair_l1 + pair_gan, lr, i == 0)
        fake = fake.detach()
        # the pools are filling: every fake is stored and passes through
        pooled += fake.shape[0]
        if pooled > hp["pool_size"]:
            raise ValueError("the reference follows the pools while they "
                             "fill only")
        step = {"pair_L1loss": float(pair_l1.detach()),
                "pair_GANloss": float(pair_gan.detach())}
        for key, net, cond in (("d_pp", d_pp, h1), ("d_pb", d_pb, p2)):
            real_l = _bce(net(torch.cat([h2, cond], -1)), True)
            fake_l = _bce(net(torch.cat([fake, cond], -1)), False)
            loss = (real_l * hp["lambda_gan"] + fake_l * hp["lambda_gan"]) * 0.5
            update(key, loss, lr, i == 0)
            step["D_PP" if key == "d_pp" else "D_PB"] = float(loss.detach())
        losses.append(step)
    change = {f"{k}.{n}": float((p.detach() - start[f"{k}.{n}"]).norm())
              for k, net in trained.items() for n, p in net.named_parameters()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


# --- generation --------------------------------------------------------


def calibrate(g: nn.Module, b: dict) -> None:
    """Running statistics from one train-mode pass with momentum 1 and
    dropout off, then eval mode."""
    g.train()
    drops = [m for m in g.modules() if isinstance(m, MaskDropout)]
    for m in drops:
        m.training = False
    bns = [m for m in g.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        g(*g_inputs(b))
    for m in bns:
        m.momentum = 0.1
    g.eval()


def fakes_u8(g: nn.Module, b: dict) -> torch.Tensor:
    """Eval-mode fakes as uint8: [-1, 1] -> [0, 255], clipped, truncated."""
    with torch.no_grad():
        fake = g(*g_inputs(b))
    return ((fake + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
