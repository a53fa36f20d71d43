"""Port of the flow perception (ops/correlation.py, geometry/camera.py
bilinear_sample, models/pwcnet.py, models/checkpoint.py's flow loaders,
fusion/flow_correspondence.py) against the JAX package on the CPU, with
the repo's checkpoints/flow.npz weights.

Tolerances: the building blocks agree to float32 rounding of sums taken
in another order (1e-6 of the output's scale; 1e-5 for convolutions,
whose sums run over up to 9 x 565 terms); the whole PWC-Net, MaskNet and
flow_correspondences to 1e-5 of the output's scale, pixel validity
exactly."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from occlusionfusion_tpu.fusion.flow_correspondence import (
    flow_correspondences as flow_correspondences_jax,
    sample_weight_field as sample_weight_field_jax,
)
from occlusionfusion_tpu.fusion.fused_step import (
    _rgbxyz_image as rgbxyz_jax,
)
from occlusionfusion_tpu.geometry.camera import Intrinsics as IntrJ
from occlusionfusion_tpu.geometry.camera import (
    bilinear_sample as bilinear_sample_jax,
)
from occlusionfusion_tpu.models import pwcnet as PJ
from occlusionfusion_tpu.models.checkpoint import (
    normalize_indexed as normalize_indexed_jax,
)
from occlusionfusion_tpu.ops.correlation import (
    correlation_volume as correlation_volume_jax,
)
from occlusionfusion_tpu.utils.snapshot import load_params as load_params_jax
from occlusionfusion_tpu_torch.fusion.flow_correspondence import (
    flow_correspondences,
    sample_weight_field,
)
from occlusionfusion_tpu_torch.fusion.fused_step import _rgbxyz_image
from occlusionfusion_tpu_torch.geometry.camera import (
    Intrinsics,
    bilinear_sample,
)
from occlusionfusion_tpu_torch.models import pwcnet as P
from occlusionfusion_tpu_torch.models.checkpoint import (
    FLOW_NPZ,
    load_flow_nets,
    masknet_params_from_jax,
    normalize_indexed,
    pwc_params_from_jax,
)
from occlusionfusion_tpu_torch.ops.correlation import correlation_volume
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    one_torch_thread,
    textured_sphere_frames,
    tt,
)


def nchw(x):
    return tt(np.asarray(x)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.fixture(scope="module")
def ckpt():
    """(JAX parameter tree, port's PWCNet, port's MaskNet)."""
    tree = normalize_indexed_jax(load_params_jax(FLOW_NPZ))
    pwc, mask = load_flow_nets(device="cpu")
    return tree, pwc, mask


@pytest.mark.parametrize("r", [4, 2])
def test_correlation_volume_matches_jax(r):
    rng = np.random.RandomState(r)
    f1 = rng.randn(2, 12, 10, 8).astype(np.float32)
    f2 = rng.randn(2, 12, 10, 8).astype(np.float32)
    ref = jax.vmap(lambda a, b: correlation_volume_jax(a, b, r))(f1, f2)
    got = correlation_volume(nchw(f1), nchw(f2), r)
    assert got.shape == (2, (2 * r + 1) ** 2, 12, 10)
    close(nhwc(got), ref, 1e-6)


def test_bilinear_warp_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 9, 11, 5).astype(np.float32)
    flow = (rng.randn(2, 9, 11, 2) * 3).astype(np.float32)  # some outside
    ref = PJ.bilinear_warp(jnp.asarray(img), jnp.asarray(flow))
    got = P.bilinear_warp(nchw(img), nchw(flow))
    close(nhwc(got), ref, 1e-6)


def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(13, 17, 3).astype(np.float32)
    uv = np.concatenate([
        rng.uniform(-2, 19, (200, 2)),
        # the borders, where the W - 1.000001 clamp decides the pixels
        [[16.0, 12.0], [16.0, 5.5], [3.25, 12.0], [0.0, 0.0],
         [15.9999, 11.9999]],
    ]).astype(np.float32)
    ref = bilinear_sample_jax(jnp.asarray(img), jnp.asarray(uv))
    got = bilinear_sample(tt(img), tt(uv))
    close(got.numpy(), ref, 1e-6)


@pytest.mark.parametrize("size,stride,dilation", [
    ((16, 12), 2, 1), ((15, 9), 2, 1), ((16, 12), 1, 1), ((16, 12), 1, 4),
])
def test_conv_same_padding_matches_jax(size, stride, dilation):
    """Stride-2 "SAME" pads (0, 1) on even sizes, unlike padding=1."""
    rng = np.random.RandomState(stride + dilation)
    x = rng.randn(1, *size, 6).astype(np.float32)
    p = {"w": rng.randn(3, 3, 6, 7).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    ref = PJ._conv(p, jnp.asarray(x), stride=stride, dilation=dilation)
    conv = P.Conv(6, 7, stride=stride, dilation=dilation)
    conv.load_state_dict({
        "weight": tt(p["w"].transpose(3, 2, 0, 1).copy()),
        "bias": tt(p["b"]),
    })
    with torch.no_grad():
        got = conv(nchw(x))
    assert got.shape[2:] == ref.shape[1:3]
    close(nhwc(got), ref, 1e-5)


def test_deconv_matches_jax():
    """JAX's SAME conv_transpose equals conv_transpose2d with the kernel
    flipped, which masknet_params_from_jax does at load."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 7, 9, 5).astype(np.float32)
    p = {"w": rng.randn(4, 4, 5, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    ref = PJ._deconv(p, jnp.asarray(x))
    tree = {"upconv1": p, "upconv2": p, "conv_in": p, "out": p, "res": []}
    sd = masknet_params_from_jax(tree)
    de = P.Deconv(5, 3)
    de.load_state_dict({"weight": sd["upconv1.weight"],
                        "bias": sd["upconv1.bias"]})
    with torch.no_grad():
        got = de(nchw(x))
    assert got.shape == (1, 3, 14, 18)
    close(nhwc(got), ref, 1e-5)


def test_flow_upsample_matches_jax_resize():
    rng = np.random.RandomState(4)
    f = rng.randn(32, 24, 2).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(f), (128, 96, 2), method="bilinear")
    got = F.interpolate(tt(f).permute(2, 0, 1)[None], size=(128, 96),
                        mode="bilinear", align_corners=False)
    close(got[0].permute(1, 2, 0).numpy(), ref, 1e-6)


def test_checkpoint_conversion(ckpt):
    tree, pwc, mask = ckpt
    raw = np.load(FLOW_NPZ)
    assert len(raw.files) == 146
    assert normalize_indexed({"0": 1, "1": 2}) == [1, 2]
    assert normalize_indexed({"2": 1, "6": 2}) == {2: 1, 6: 2}
    sd = pwc_params_from_jax(tree["pwc"])
    assert set(sd) == set(pwc.state_dict())
    np.testing.assert_array_equal(
        pwc.state_dict()["decoders.2.convs.0.weight"].numpy(),
        np.asarray(tree["pwc"]["decoders"][2]["convs"][0]["w"]).transpose(
            3, 2, 0, 1),
    )
    assert set(masknet_params_from_jax(tree["mask"])) == set(mask.state_dict())


@pytest.fixture(scope="module")
def frames():
    """Two textured 112x120 RGB-XYZ frames of a sphere moving sideways and
    away (as JAX and as port tensors)."""
    intr = IntrJ(np.float32(150.0), np.float32(150.0), np.float32(60.0),
                 np.float32(56.0))
    centers = [np.array([0.0, 0.0, 0.6]), np.array([0.004, 0.002, 0.604])]
    depths, colors = textured_sphere_frames(centers, 112, 120, intr, 0.1)
    j = [rgbxyz_jax(jnp.asarray(d), jnp.asarray(c), intr)
         for d, c in zip(depths, colors)]
    it = Intrinsics(*(float(x) for x in intr))
    t = [_rgbxyz_image(tt(d), tt(c), it) for d, c in zip(depths, colors)]
    return j, t


def test_rgbxyz_matches_jax(frames):
    j, t = frames
    for a, b in zip(t, j):
        close(a.numpy(), b, 1e-6)


def test_pwcnet_and_masknet_match_jax(ckpt, frames):
    """The whole networks at 128x128 with the checkpoint's weights."""
    tree, pwc, mask = ckpt
    j, _ = frames
    src = np.pad(np.asarray(j[0]), ((0, 0), (0, 16), (0, 8)))[None]
    tgt = np.pad(np.asarray(j[1]), ((0, 0), (0, 16), (0, 8)))[None]
    src_h, tgt_h = src.transpose(0, 2, 3, 1), tgt.transpose(0, 2, 3, 1)
    flow_j, feat_j = PJ.pwcnet_forward(
        tree["pwc"], jnp.asarray(src_h[..., :3]), jnp.asarray(tgt_h[..., :3])
    )
    w_j = PJ.masknet_forward(tree["mask"], feat_j, jnp.asarray(src_h),
                             jnp.asarray(tgt_h))
    with torch.no_grad():
        flow_t, feat_t = pwc(tt(src[:, :3]), tt(tgt[:, :3]))
        w_t = mask(feat_t, tt(src), tt(tgt))
    assert flow_t.shape == (1, 2, 32, 32) and feat_t.shape == (1, 565, 32, 32)
    close(nhwc(flow_t), flow_j, 1e-5)
    close(nhwc(feat_t), feat_j, 1e-5)
    close(nhwc(w_t), w_j, 1e-5)
    assert float(np.abs(np.asarray(flow_j)).max()) > 1e-3


def test_flow_correspondences_match_jax(ckpt, frames):
    tree, pwc, mask = ckpt
    j, t = frames
    ref = flow_correspondences_jax(tree["pwc"], j[0], j[1],
                                   mask_params=tree["mask"])
    with torch.no_grad():
        got = flow_correspondences(pwc, t[0], t[1], mask)
    flow, targets, valid, weights = (np.asarray(x) for x in ref)
    assert got[0].shape == (112, 120, 2)
    close(got[0].numpy(), flow, 1e-5)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert valid.sum() > 1000
    close(got[1].numpy()[valid], targets[valid], 1e-5)
    close(got[3].numpy(), weights, 1e-5)
    assert (weights[valid] > 0.35).any(), "MaskNet weighs nothing over 0.35"

    rng = np.random.RandomState(5)
    u = tt(rng.uniform(0, 119, 300).astype(np.float32))
    v = tt(rng.uniform(0, 111, 300).astype(np.float32))
    close(sample_weight_field(got[3], u, v).numpy(),
          sample_weight_field_jax(jnp.asarray(weights), u.numpy(), v.numpy(),
                                  nms_active=False), 1e-5)
