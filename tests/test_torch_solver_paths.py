"""The remaining solvers on the port's two engines against the JAX package
on the CPU: 4 frames of tests/test_fusion_e2e.py's receding sphere (48^3,
128x128, the motion GNN) through the chunked engine (run_fused) and the
stepwise loop (run) with solver="gn_dense", linear_solver="ns" and the
2d_depth data term (the camera's intrinsics reach the solver), and
through the chunked engine with N-ICP and its chamfer cost on the JAX
package's own subsamples; ROADMAP F14 as a fact in both packages: the
rendered costs' weights change nothing (the JAX fused step lowers to the
same program, the port's frames are equal), since no fusion path gives
the solver a target depth. Also the configs' field coverage: every field of
the JAX GNConfig (but ``assembly``) and NICPConfig has a port
counterpart with the same default, and the port's FusionConfig has every
JAX field but the TPU-only ``lbs_impl``/``dense_skin_max_bytes``, and no
other.

The GN cases cap the graph at 64 nodes (the sphere has 18), so that
the Newton-Schulz products stay small on the CPU. Tolerances as
tests/test_torch_stepwise.py: equal correspondence and visible-node
counts, final losses within 1e-3 relative, node translations and
rotation entries within 1e-4; with the chamfer the rotation entries
within 2e-3 (read: 9.2e-4): the chamfer's nearest neighbours among the
sphere's lattice of points are near ties, which the two programs'
roundings split differently, as the JAX package's own eager and compiled
programs do (tests/test_torch_nicp.py::test_unported_terms_raise), and
Adam's normalised steps carry that into the weakly observed rotations
of a sphere."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu.fusion.pipeline import FusionConfig as FusionConfigJ
from occlusionfusion_tpu.models.checkpoint import load_motion_complete_params
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu.solvers.nicp import NICPConfig as NICPConfigJ
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.models.checkpoint import (
    load_motion_complete_net,
)
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from occlusionfusion_tpu_torch.solvers.nicp import NICPConfig
from test_torch_stepwise import configs, sequences
from torch_port_impl import jax_chamfer_table, one_torch_thread  # noqa: F401

GN_NS = dict(iters=4, w_point=1.0, w_arap=10.0, w_motion=1.0,
             linear_solver="ns", ns_block=48, data_term="2d_depth",
             w_flow=1e-3, w_depth=1.0)
NICP = dict(iters=10, w_chamfer=0.5, chamfer_samples=600)
RENDERED = dict(w_silh=1.0, w_depth=2.0, render_hw=(128, 128))
RT_ATOL = 1e-4
CHAMFER_R_ATOL = 2e-3
GN_MAX_NODES = 64


def _case_configs(case):
    cfg_j, cfg_t = configs("nicp" if case.startswith("nicp") else "gn_dense")
    if case.startswith("nicp"):
        extra = RENDERED if case == "nicp_rendered" else {}
        return (dataclasses.replace(cfg_j, nicp=NICPConfigJ(**NICP, **extra)),
                dataclasses.replace(cfg_t, nicp=NICPConfig(**NICP, **extra)))
    return (dataclasses.replace(cfg_j, max_nodes=GN_MAX_NODES,
                                gn=GNConfigJ(assembly="blocks", **GN_NS)),
            dataclasses.replace(cfg_t, max_nodes=GN_MAX_NODES,
                                gn=GNConfig(**GN_NS)))


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX fusion, JAX infos, port fusion, port infos)."""
    params = load_motion_complete_params()
    net = load_motion_complete_net(device="cpu")
    out = {}
    for case, loop in (("gn_ns_2d_fused", "run_fused"),
                       ("gn_ns_2d_stepwise", "run"),
                       ("nicp_chamfer", "run_fused"),
                       ("nicp_rendered", "run_fused")):
        cfg_j, cfg_t = _case_configs(case)
        seq_j, seq_t, _ = sequences(False)
        table = None
        if case.startswith("nicp"):
            P = cfg_t.max_points
            table = jax_chamfer_table(NICP["iters"], NICP["chamfer_samples"],
                                      P, P)
        fj = infos_j = None
        if loop == "run":
            fj = DynamicFusionJ(seq_j, cfg_j, motion_params=params)
            infos_j = fj.run()
        elif case != "nicp_rendered":
            fj = DynamicFusionJ(seq_j, cfg_j)
            infos_j = fj.run_fused(motion_params=params)
        ft = DynamicFusion(seq_t, cfg_t, device="cpu", chamfer_table=table)
        infos_t = getattr(ft, loop)(motion_net=net)
        out[case] = (fj, infos_j, ft, infos_t)
    return out


def _jax_step_program(cfg_j, params):
    """The JAX package's fused step for ``cfg_j`` on the first frame of
    the input, lowered (traced, not compiled) to its program text."""
    from occlusionfusion_tpu.fusion.fused_step import fused_register_frame

    seq_j, _, _ = sequences(False)
    fj = DynamicFusionJ(seq_j, cfg_j)
    fj.initialize(seq_j.load(0))
    sc, state, tables = fj.build_fused(params)
    frame = seq_j.load(1)
    return fused_register_frame.lower(
        sc, state, tables, fj._device_params(params),
        jnp.asarray(frame.depth), jnp.asarray(frame.color),
        fj._device_params(fj.intr), None).as_text()


CASES = ["gn_ns_2d_fused", "gn_ns_2d_stepwise", "nicp_chamfer"]


@pytest.mark.parametrize("case", CASES)
def test_info_matches_jax(runs, case):
    _, infos_j, _, infos_t = runs[case]
    assert len(infos_t) == len(infos_j) == 4
    for a, b in zip(infos_t, infos_j):
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert a["solve_valid"] and b["solve_valid"]
        np.testing.assert_allclose(a["final_loss"], b["final_loss"],
                                   rtol=1e-3)


@pytest.mark.parametrize("case", CASES)
def test_node_transforms_match_jax(runs, case):
    fj, _, ft, _ = runs[case]
    n = ft.node_count
    assert n == fj.node_count
    np.testing.assert_allclose(ft.warp.translations[:n].numpy(),
                               np.asarray(fj.warp.translations)[:n],
                               atol=RT_ATOL)
    np.testing.assert_allclose(
        ft.warp.rotations[:n].numpy(), np.asarray(fj.warp.rotations)[:n],
        atol=CHAMFER_R_ATOL if case == "nicp_chamfer" else RT_ATOL)


def test_f14_rendered_weights_change_no_frame(runs):
    """ROADMAP F14: the fused engine's N-ICP problem carries no target
    depth, so w_silh and w_depth > 0 on top of the chamfer change
    nothing: the JAX package lowers its fused step to the same program
    with them as without them, and the port's frames equal its own run
    without them, bit for bit."""
    params = load_motion_complete_params()
    programs = [_jax_step_program(_case_configs(case)[0], params)
                for case in ("nicp_chamfer", "nicp_rendered")]
    assert programs[0] == programs[1]
    base, rend = runs["nicp_chamfer"][2], runs["nicp_rendered"][2]
    np.testing.assert_array_equal(rend.warp.translations.numpy(),
                                  base.warp.translations.numpy())
    for a, b in zip(runs["nicp_rendered"][3], runs["nicp_chamfer"][3]):
        assert a == b


def _defaults(cls):
    return dict(cls._field_defaults)


def test_config_fields_cover_jax():
    gn_j = _defaults(GNConfigJ)
    assert gn_j.pop("assembly") == "auto"
    assert _defaults(GNConfig) == gn_j
    assert _defaults(NICPConfig) == _defaults(NICPConfigJ)
    fields_j = {f.name for f in dataclasses.fields(FusionConfigJ)}
    fields_t = {f.name for f in dataclasses.fields(FusionConfig)}
    assert fields_j - fields_t == {"lbs_impl", "dense_skin_max_bytes"}
    assert fields_t <= fields_j
    # every GN and N-ICP setting is accepted by the port's FusionConfig
    FusionConfig(solver="gn_dense", gn=GNConfig(**{
        **_defaults(GNConfig), "linear_solver": "schur",
        "data_term": "2d_depth", "precondition": True}))
    FusionConfig(nicp=NICPConfig(w_chamfer=1.0, w_silh=1.0, w_depth=1.0))
    with pytest.raises(ValueError, match="linear_solver"):
        FusionConfig(gn=GNConfig(linear_solver="lu"))
