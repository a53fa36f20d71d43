"""The Lepard cadence (``lepard_every``) in the port's two engines: the
gate reads the absolute frame index, so the chunked engine
(``run_fused``, graphs holding the matcher in exactly the steps whose
frame runs it), the eager fused step (``register_frame_fused``, across a
``build_fused`` rebuild, as tests/test_fused_perception.py:244-283 asks
of JAX) and the stepwise loop (``run``) fire on the same frames, and a
skipped frame reports no matches. F7 (ROADMAP Queue 3): with ``skip=2``
the port fires on frames 2, 4, 6 and 8, where the JAX fused engine,
which counts registered frames, fires on 4 and 8 only; both facts are
asserted here, so that neither side is "fixed" toward the other. Then
one whole small run at ``lepard_every=2``, ``skip=1`` (where the JAX
engines agree) with the matcher of tests/test_torch_headline.py's
Lepard-branch test, held to JAX with that file's limits."""

import contextlib

import numpy as np
import pytest
import jax

from occlusionfusion_tpu.fusion.frame_loader import ArraySequence as SeqJ
from occlusionfusion_tpu.fusion.pipeline import DynamicFusion as DynamicFusionJ
from occlusionfusion_tpu_torch.fusion import fused_step
from occlusionfusion_tpu_torch.fusion.frame_loader import ArraySequence
from occlusionfusion_tpu_torch.fusion.pipeline import (
    DynamicFusion,
    FusionConfig,
)
from occlusionfusion_tpu_torch.geometry.camera import Intrinsics
from occlusionfusion_tpu_torch.graph.edgraph import GraphConfig
from occlusionfusion_tpu_torch.models.checkpoint import load_lepard_checkpoint
from occlusionfusion_tpu_torch.solvers.gauss_newton import GNConfig
from test_fused_perception import INTR, config, make_seq, tiny_lepard
from test_torch_headline import LEPARD_ONLY, headline_runs
from test_torch_lepard import small
from torch_port_impl import (  # noqa: F401 (an autouse fixture)
    jax_lepard_match_counts,
    one_torch_thread,
)

EVERY = 2


@pytest.fixture(scope="module")
def lepard_net():
    _, cfg = load_lepard_checkpoint(device="cpu")
    return load_lepard_checkpoint(device="cpu", config=small(cfg))[0]


def port_fusion(lepard_net, n, every=EVERY):
    """The port on tests/test_fused_perception.py's small sphere (64x64,
    32^3) with the matcher only, every ``every``-th frame."""
    seq = make_seq(n=n)
    cfg = FusionConfig(
        vol_dim=(32, 32, 32), voxel_size=0.01, node_coverage=0.04,
        max_nodes=128, max_points=1024, max_depth_diff=0.05,
        graph=GraphConfig(node_coverage=0.04, min_neighbors=2),
        use_motion_model=False, solver="gn_dense", gn=GNConfig(iters=2),
        use_lepard=True, lepard_every=every, lepard_max_target_points=256)
    return DynamicFusion(
        ArraySequence([seq.load(i).color for i in range(n)],
                      [seq.load(i).depth for i in range(n)],
                      Intrinsics(*(float(x) for x in INTR))),
        cfg, device="cpu", lepard_net=lepard_net)


@contextlib.contextmanager
def matcher_calls():
    """The number of the port's matcher calls so far, in a list that the
    caller reads before and after a frame (``fused_step.scene_flow``)."""
    orig, calls = fused_step.scene_flow, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    fused_step.scene_flow = counted
    try:
        yield calls
    finally:
        fused_step.scene_flow = orig


def fired_frames(infos, calls_per_frame):
    """Frames with a matcher call, checking that those and only those
    report matches."""
    fired = [i["frame"] for i, c in zip(infos, calls_per_frame) if c]
    for i, c in zip(infos, calls_per_frame):
        assert (i["n_lepard_matches"] > 0) == bool(c), (i, c)
    return fired


def run_fused_fired(fusion, **kw):
    with matcher_calls() as calls:
        seen = []
        orig = fused_step.fused_register_frame

        def step(*a, **k):
            before = calls[0]
            out = orig(*a, **k)
            seen.append(calls[0] - before)
            return out

        fused_step.fused_register_frame = step
        try:
            infos = fusion.run_fused(**kw)
        finally:
            fused_step.fused_register_frame = orig
    return fired_frames(infos, seen)


def stepwise_fired(fusion, **kw):
    with matcher_calls() as calls:
        seen, register = [], fusion.register_frame

        def frame(f, motion_net=None):
            before = calls[0]
            info = register(f, motion_net)
            seen.append(calls[0] - before)
            return info

        fusion.register_frame = frame
        infos = fusion.run(**kw)
    return fired_frames(infos, seen)


def test_gate_is_absolute_in_both_engines_and_across_rebuild(lepard_net):
    n = 6
    expected = [i for i in range(1, n) if i % EVERY == 0]
    for chunk in (2, 3):  # chunks that start on either phase
        assert run_fused_fired(port_fusion(lepard_net, n),
                               chunk=chunk) == expected
    assert stepwise_fired(port_fusion(lepard_net, n)) == expected
    # the eager fused step, rebuilt mid-sequence as growth would
    fusion = port_fusion(lepard_net, n)
    fusion.initialize(fusion.seq.load(0))
    sc, state, tables = fusion.build_fused(None)
    fired = []
    with matcher_calls() as calls:
        for i in range(1, n):
            if i == 4:
                fusion.adopt_fused_state(state)
                fusion.frame_id = 3
                sc, state, tables = fusion.build_fused(None)
            before = calls[0]
            state, info = fusion.register_frame_fused(
                sc, state, tables, fusion.seq.load(i), None)
            fired += [i] if calls[0] > before else []
            assert (info[6] > 0) == (calls[0] > before)
    assert fired == expected


def test_f7_skip_two_port_fires_on_every_second_frame_jax_fused_does_not(
        lepard_net):
    """F7: at skip=2, lepard_every=2 the port's engines fire on frames 2,
    4, 6, 8 (the frames' own indices); the JAX fused engine gates on its
    count of registered frames, seeded at frame_id + 1 = 1, and fires on
    4 and 8 only (occlusionfusion_tpu/fusion/fused_step.py:461-464)."""
    port = [2, 4, 6, 8]
    assert run_fused_fired(port_fusion(lepard_net, 9), skip=2,
                           chunk=4) == port
    assert stepwise_fired(port_fusion(lepard_net, 9), skip=2) == port
    seq = make_seq(n=9)
    lp, lc = tiny_lepard()
    fj = DynamicFusionJ(seq, config(use_lepard=True, lepard_every=EVERY,
                                    lepard_max_target_points=256),
                        lepard_params=lp, lepard_config=lc)
    fj.initialize(seq.load(0))
    sc, state, tables = fj.build_fused(None)
    fired = []
    with jax_lepard_match_counts() as calls:
        for i in range(2, 9, 2):
            before = len(calls)
            state, info = fj.register_frame_fused(sc, state, tables,
                                                  seq.load(i), None)
            jax.block_until_ready(info)
            jax.effects_barrier()
            fired += [i] if len(calls) > before else []
    assert fired == [4, 8]


@pytest.fixture(scope="module")
def every_runs():
    return headline_runs(5, dict(LEPARD_ONLY, lepard_every=EVERY))


def test_whole_run_at_lepard_every_two_matches_jax(every_runs):
    """Frames 1-4 in two chunks of 2 (gate pattern: off, on), the matcher
    in f32 as tests/test_torch_headline.py's Lepard branch runs it: the
    matches of frames 2 and 4 equal JAX's, frames 1 and 3 have none, and
    the run is held to that file's Lepard-branch limits (counts equal,
    the loss within 1e-4 relative, node transforms within 5e-6 m and
    1e-4; read: 8.8e-7 m), which are tighter than its headline's."""
    fj, infos_j, matches_j, ft, infos_t = every_runs
    assert [i["frame"] for i in infos_t] == [1, 2, 3, 4]
    assert len(matches_j) == 2 and min(matches_j) > 0
    assert [i["n_lepard_matches"] for i in infos_t] == [0, matches_j[0], 0,
                                                        matches_j[1]]
    for a, b in zip(infos_t, infos_j):
        assert a["solve_valid"] and b["solve_valid"]
        assert a["n_correspondences"] == b["n_correspondences"]
        assert a["n_visible_nodes"] == b["n_visible_nodes"]
        assert abs(a["final_loss"] - b["final_loss"]) <= 1e-4 * b["final_loss"]
    n = fj.node_count
    assert ft.node_count == n
    np.testing.assert_allclose(ft.warp.translations.numpy()[:n],
                               np.asarray(fj.warp.translations)[:n],
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(ft.warp.rotations.numpy()[:n],
                               np.asarray(fj.warp.rotations)[:n],
                               rtol=0, atol=1e-4)
