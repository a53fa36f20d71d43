"""PWC-Net optical flow and the MaskNet correspondence weights (port of
``occlusionfusion_tpu/models/pwcnet.py``).

A 6-level feature pyramid; per level from 6 to 2 a warp of the second
image's features by the upsampled flow, the 81-channel correlation
volume (``ops/correlation.py``), a densely connected decoder and a flow
head; then the dilated context refiner at level 2. MaskNet upsamples the
last decoder features x4 and predicts per-pixel correspondence weights
in (0, 1) from them and both RGB-XYZ images.

NCHW inside, where the JAX package is NHWC. Convolutions reproduce XLA's
"SAME" padding, which is asymmetric for the stride-2 3x3 convolutions of
the extractor (0 before, 1 after on even sizes); the transposed 4x4
stride-2 convolutions take the JAX kernels spatially flipped
(``models/checkpoint.py`` flips them once at load). cuDNN runs in full
f32 (TF32 off, ``device.py``).

``bf16_copy`` gives a net's bfloat16 twin, cast once, for the bf16
perception setting: each convolution takes its input in its weights'
dtype, as the JAX ``_conv`` does, while ``bilinear_warp`` keeps its
coordinate math in f32.
"""

from __future__ import annotations

import copy
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from occlusionfusion_tpu_torch.ops.correlation import correlation_volume

LEVEL_CHANNELS = (16, 32, 64, 96, 128, 196)  # pyramid levels 1..6
DENSE = (128, 128, 96, 64, 32)
CORR_CH = 81
FLOW_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}  # per-level flow scale
REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (2, 1))
FEAT_CH = CORR_CH + LEVEL_CHANNELS[1] + 4 + sum(DENSE)  # 565 at level 2
MASK_CH = 16  # MaskNet's working width


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _same_pads(size: int, k: int, stride: int, dilation: int):
    """XLA's "SAME" padding (before, after) of one spatial axis."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """k x k convolution with XLA "SAME" padding; weight [O, I, k, k]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.dilation = dilation

    def forward(self, x):
        x = x.to(self.weight.dtype)
        k = self.weight.shape[-1]
        ph = _same_pads(x.shape[2], k, self.stride, self.dilation)
        pw = _same_pads(x.shape[3], k, self.stride, self.dilation)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph, pw = (0, 0), (0, 0)
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=(ph[0], pw[0]), dilation=self.dilation)


class Deconv(nn.Module):
    """Stride-2 4x4 transposed convolution (x2 upsample), equal to JAX's
    ``conv_transpose(..., (2, 2), "SAME")`` once the kernel is flipped;
    weight [I, O, 4, 4]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.weight.dtype), self.weight,
                                  self.bias, stride=2, padding=1)


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp img [B, C, H, W] by flow [B, 2, H, W] (u, v) with the
    reference's partial-warping mask: samples outside the image are 0.
    The coordinates stay f32 whatever img's dtype (bf16's ulp is 0.5 px
    at 64 and above); the blend weights and values take img's dtype."""
    B, C, H, W = img.shape
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij",
    )
    x = u[None] + flow[:, 0].float()
    y = v[None] + flow[:, 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None].to(img.dtype)
    fy = (y - y0)[:, None].to(img.dtype)
    flat = img.reshape(B, C, H * W)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        idx = (yc * W + xc).reshape(B, 1, H * W).expand(B, C, H * W)
        vals = torch.gather(flat, 2, idx).reshape(B, C, H, W)
        return torch.where(inb[:, None], vals, torch.zeros_like(vals))

    i00 = gather(x0, y0)
    i01 = gather(x0 + 1, y0)
    i10 = gather(x0, y0 + 1)
    i11 = gather(x0 + 1, y0 + 1)
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


class _Decoder(nn.Module):
    def __init__(self, lvl: int):
        super().__init__()
        base = CORR_CH if lvl == 6 else CORR_CH + LEVEL_CHANNELS[lvl - 1] + 4
        convs = []
        cin = base
        for cout in DENSE:
            convs.append(Conv(cin, cout))
            cin += cout
        self.convs = nn.ModuleList(convs)
        self.flow = Conv(cin, 2)
        if lvl < 6:
            # the input of the level above: its base plus its dense convs
            prev = CORR_CH + (LEVEL_CHANNELS[lvl] + 4 if lvl < 5 else 0)
            self.upflow = Deconv(2, 2)
            self.upfeat = Deconv(prev + sum(DENSE), 2)


class PWCNet(nn.Module):
    """``forward(im1, im2)`` with RGB images [B, 3, H, W] (H, W multiples
    of 64) returns the flow im1 -> im2 at quarter resolution
    [B, 2, H/4, W/4], in quarter-resolution pixels x 1/20, and the last
    decoder features [B, 565, H/4, W/4] for MaskNet."""

    def __init__(self):
        super().__init__()
        ext = []
        cin = 3
        for cout in LEVEL_CHANNELS:
            ext.append(nn.ModuleList([
                Conv(cin, cout, stride=2), Conv(cout, cout), Conv(cout, cout),
            ]))
            cin = cout
        self.extractor = nn.ModuleList(ext)
        self.decoders = nn.ModuleDict(
            {str(lvl): _Decoder(lvl) for lvl in (6, 5, 4, 3, 2)}
        )
        ref = []
        cin = FEAT_CH
        for cout, dil in REFINER:
            ref.append(Conv(cin, cout, dilation=dil))
            cin = cout
        self.refiner = nn.ModuleList(ref)

    def pyramid(self, image):
        """{level: features [B, C_l, H/2^l, W/2^l]} for levels 1..6."""
        feats = {}
        x = image
        for lvl, convs in enumerate(self.extractor, start=1):
            for conv in convs:
                x = _lrelu(conv(x))
            feats[lvl] = x
        return feats

    def forward_multiscale(self, im1, im2):
        """({level: flow [B, 2, H/2^l, W/2^l]} for levels 2..6, in each
        level's pixels x 1/20, level 2 with the context refiner's
        residual; the last decoder features): the training forward
        (per-level supervision)."""
        f1 = self.pyramid(im1)
        f2 = self.pyramid(im2)
        flow = feat = None
        flows = {}
        for lvl in (6, 5, 4, 3, 2):
            dec = self.decoders[str(lvl)]
            a, b = f1[lvl], f2[lvl]
            if flow is None:
                x = _lrelu(correlation_volume(a, b))
            else:
                upflow = dec.upflow(flow)
                upfeat = dec.upfeat(feat)
                warped = bilinear_warp(b, upflow * FLOW_SCALES[lvl])
                x = torch.cat(
                    [_lrelu(correlation_volume(a, warped)), a, upflow, upfeat],
                    dim=1,
                )
            for conv in dec.convs:
                x = torch.cat([_lrelu(conv(x)), x], dim=1)
            flow = dec.flow(x)
            feat = x
            flows[lvl] = flow
        r = feat
        for conv in self.refiner[:-1]:
            r = _lrelu(conv(r))
        flows[2] = flow + self.refiner[-1](r)
        return flows, feat

    def forward(self, im1, im2):
        flows, feat = self.forward_multiscale(im1, im2)
        return flows[2], feat


class MaskNet(nn.Module):
    """``forward(feat, source6, target6)``: decoder features
    [B, 565, h, w] and the two RGB-XYZ images [B, 6, 4h, 4w] -> weights
    in (0, 1) [B, 1, 4h, 4w]."""

    def __init__(self):
        super().__init__()
        fn = MASK_CH
        self.upconv1 = Deconv(FEAT_CH, 2 * fn)
        self.upconv2 = Deconv(2 * fn, fn)
        self.conv_in = Conv(fn + 12, fn)
        self.res = nn.ModuleList(
            [nn.ModuleList([Conv(fn, fn), Conv(fn, fn)]) for _ in range(3)]
        )
        self.out = Conv(fn, 1)

    def forward(self, feat, source6, target6):
        x = self.upconv2(self.upconv1(feat))
        x = _lrelu(self.conv_in(torch.cat([x, source6, target6], dim=1)))
        for c1, c2 in self.res:
            x = _lrelu(x + c2(_lrelu(c1(x))))
        return torch.sigmoid(self.out(x))


_BF16 = weakref.WeakKeyDictionary()


def bf16_copy(net: nn.Module) -> nn.Module:
    """The bfloat16 twin of ``net`` (floating weights cast once, kept while
    ``net`` lives)."""
    twin = _BF16.get(net)
    if twin is None:
        twin = copy.deepcopy(net).to(torch.bfloat16)
        _BF16[net] = twin
    return twin


def _init_convs(net: nn.Module, generator: torch.Generator | None):
    """He-normal weights (std sqrt(2 / (k * k * C_in))) and zero biases,
    the JAX ``_conv_params`` scale."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (Conv, Deconv)):
                cin = m.weight.shape[1 if isinstance(m, Conv) else 0]
                k = m.weight.shape[-1]
                m.weight.normal_(generator=generator).mul_(
                    (2.0 / (k * k * cin)) ** 0.5)
                m.bias.zero_()
    return net


def init_pwcnet(generator: torch.Generator | None = None,
                device=None) -> PWCNet:
    """A freshly initialised PWC-Net (the JAX ``init_pwcnet_params``'s
    layout and scale, not its draws)."""
    return _init_convs(PWCNet(), generator).to(device)


def init_masknet(generator: torch.Generator | None = None,
                 device=None) -> MaskNet:
    """A freshly initialised MaskNet (``init_masknet_params``)."""
    return _init_convs(MaskNet(), generator).to(device)
