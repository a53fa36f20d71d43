"""The port's default Gauss-Newton weights (ROADMAP F3): with
solver="gn_dense" and gn=None the JAX package derives
GNConfig(iters=6, w_point=nicp.w_ldmk, w_arap=nicp.w_arap,
w_motion=nicp.w_motion / 100) (fusion/fused_step.py:556-561,
fusion/pipeline.py:763-768); the port's FusionConfig().gn must equal what
that gives at the JAX package's own FusionConfig / NICPConfig defaults,
field by field."""

import pytest

from occlusionfusion_tpu.fusion.pipeline import FusionConfig as FusionConfigJ
from occlusionfusion_tpu.solvers.gauss_newton import GNConfig as GNConfigJ
from occlusionfusion_tpu_torch.fusion.pipeline import FusionConfig
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig


def _jax_derived_gn():
    cfg = FusionConfigJ(solver="gn_dense")
    assert cfg.gn is None
    return GNConfigJ(iters=6, w_point=cfg.nicp.w_ldmk,
                     w_arap=cfg.nicp.w_arap,
                     w_motion=cfg.nicp.w_motion / 100.0)


@pytest.mark.parametrize("name", GNConfig._fields)
def test_default_gn_matches_jax_derived(name):
    assert getattr(FusionConfig().gn, name) == getattr(_jax_derived_gn(), name)


def test_default_gn_turns_the_motion_prior_on():
    """The motion GNN's targets reach the solve only when w_motion > 0."""
    assert FusionConfig().gn.w_motion > 0
