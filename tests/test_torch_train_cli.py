"""The port's three training CLIs, 2 steps each on the CPU at small
settings (``--through_solver``, ``--data deepdeform`` on files the repo's
exporter writes and a 4DMatch root written here included); a checkpoint
the port trains loads in the JAX package, whose forward agrees with the
port's within 1e-5; ``--device cuda`` without a card fails."""

import os
import sys
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occlusionfusion_tpu_torch.scripts import (
    train_flow,
    train_lepard,
    train_motion,
)

from torch_port_impl import jax_run_once, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_FLOW = ["--steps", "2", "--batch", "1", "--log_every", "1",
              "--device", "cpu"]


def test_flow_cli_checkpoint_loads_in_jax(tmp_path):
    from occlusionfusion_tpu.models.checkpoint import normalize_indexed
    from occlusionfusion_tpu.models.pwcnet import (
        masknet_forward,
        pwcnet_forward,
    )
    from occlusionfusion_tpu.utils.snapshot import load_params

    from occlusionfusion_tpu_torch.models.checkpoint import load_flow_nets

    out = str(tmp_path / "flow.npz")
    train_flow.main(SMALL_FLOW + ["--with_mask", "--augment_rot", "0.2",
                                  "--out", out])
    tree = normalize_indexed(load_params(out))
    pwc, mask = load_flow_nets(out, device="cpu")
    rng = np.random.RandomState(0)
    im1, im2 = rng.rand(2, 1, 64, 64, 3).astype(np.float32)
    s6, t6 = rng.rand(2, 1, 64, 64, 6).astype(np.float32)
    def forward(tp, tm, a, b, c, d):
        f, feat = pwcnet_forward(tp, a, b)
        return f, masknet_forward(tm, feat, c, d)

    jf, jm = jax_run_once(forward, tree["pwc"], tree["mask"],
                          *map(jnp.asarray, (im1, im2, s6, t6)))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        pf, pfeat = pwc(nchw(im1), nchw(im2))
        pm = mask(pfeat, nchw(s6), nchw(t6))
    np.testing.assert_allclose(pf.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jf), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pm.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jm), atol=1e-5, rtol=1e-5)


def test_flow_cli_through_solver(tmp_path):
    out = str(tmp_path / "flow_ts.npz")
    train_flow.main(SMALL_FLOW + ["--through_solver", "--eval_pairs", "1",
                                  "--matches", "64", "--nodes", "16",
                                  "--sparse_flow_frac", "0.5",
                                  "--corrupt_flow", "--out", out])
    assert os.path.exists(out)


def test_flow_cli_deepdeform(tmp_path):
    sys.path.insert(0, REPO)
    from scripts.export_deepdeform import export

    root = str(tmp_path / "dd")
    export(Namespace(out=root, shape="blob", frames=3, height=64, width=64,
                     fx=150.0, verts=1200, seed=0, rotate_deg=3.0,
                     splat_radius=2, node_coverage=0.05, split="train"))
    out = str(tmp_path / "flow_dd.npz")
    train_flow.main(SMALL_FLOW + ["--with_mask", "--data", "deepdeform",
                                  "--deepdeform", root, "--out", out])
    assert os.path.exists(out)


def test_motion_cli(tmp_path):
    out = str(tmp_path / "motion.npz")
    train_motion.main(["--steps", "2", "--batch", "2", "--synthetic_clips",
                       "2", "--eval_every", "1", "--device", "cpu",
                       "--out", out])
    from occlusionfusion_tpu.utils.snapshot import load_params

    assert "weight_ih_l0" in load_params(out)["seq_encoder"]


def test_lepard_cli_on_a_4dmatch_root(tmp_path):
    """4DMatch-layout pairs written here, neighbour limits calibrated
    from them; the checkpoint and side-car load in the JAX package."""
    from occlusionfusion_tpu.models.checkpoint import load_lepard_checkpoint

    rng = np.random.RandomState(0)
    for i in range(2):
        d = tmp_path / "4dm" / f"s{i}"
        os.makedirs(d)
        pc = (rng.randn(80, 3) * 0.3).astype(np.float32)
        np.savez(d / "pair.npz", s_pc=pc, t_pc=pc + 0.01,
                 correspondences=np.stack([np.arange(80)] * 2, 1),
                 rot=np.eye(3), trans=np.zeros(3), s2t_flow=pc * 0 + 0.01)
    out = str(tmp_path / "lep.npz")
    train_lepard.main(["--steps", "2", "--eval_every", "1", "--device",
                       "cpu", "--levels", "64,32,16,8", "--first_voxel",
                       "0.1", "--data", str(tmp_path / "4dm"),
                       "--calibrate_neighbors", "--out", out])
    params, cfg = load_lepard_checkpoint(out)
    assert cfg.kpfcn.pyramid.level_sizes == (64, 32, 16, 8)


def test_lepard_cli_synthetic_and_rendered(tmp_path):
    out = str(tmp_path / "lep2.npz")
    train_lepard.main(["--steps", "2", "--eval_every", "1", "--device",
                       "cpu", "--points", "64", "--cap", "64", "--levels",
                       "64,32,16,8", "--first_voxel", "0.1",
                       "--rendered_frac", "0.5", "--bridge_boost", "1.0",
                       "--out", out])
    assert os.path.exists(out + ".json")


def test_cuda_device_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (train_flow, train_motion, train_lepard):
        with pytest.raises(SystemExit):
            mod.main(["--steps", "1", "--device", "cuda", "--out",
                      os.devnull])
