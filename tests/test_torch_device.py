"""Kernel launches carry their tensors' device (ROADMAP F4): each kernel
wrapper (K1 knn, K2 lbs_warp, K3' point term, K4' ARAP term) hands
device.launch the device its inputs sit on, launch enters that device
and takes its current stream, and a wrapper refuses inputs on different
devices before it launches. The kernel library, the CUDA tensor checks,
torch.cuda.device and torch.cuda.current_stream are stubbed, so this
runs on the CPU; the "meta" device stands in for a second card."""

import types

import pytest
import torch

from occlusionfusion_tpu_torch import device as D
from occlusionfusion_tpu_torch.fusion.warpfield import WarpFieldState
from occlusionfusion_tpu_torch.ops import gn_assembly, knn, lbs

N, P, E = 8, 16, 4


@pytest.fixture()
def launches(monkeypatch):
    """Records (event, name or device) of every stubbed call."""
    log = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                log.append(("kernel", name))
                return 0
            return fn

    class Guard:
        def __init__(self, dev):
            log.append(("enter", torch.device(dev)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            log.append(("exit", None))

    def stream(dev=None):
        log.append(("stream", torch.device(dev)))
        return types.SimpleNamespace(cuda_stream=0)

    monkeypatch.setattr(D, "kernel_lib", lambda: Lib())
    monkeypatch.setattr(D, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    D.reset_launch_counts()
    yield log
    D.reset_launch_counts()


def _calls(dev, node_dev=None):
    """One call of each kernel wrapper with every input on ``dev``, but
    the [N, 3] node-table tensors on ``node_dev`` if it is given."""
    f = dict(device=dev)
    z3 = torch.zeros((N, 3), device=node_dev or dev)
    rot = torch.eye(3, **f).expand(N, 3, 3).contiguous()
    anchors = torch.zeros((P, 4), dtype=torch.int32, **f)
    w4 = torch.full((P, 4), 0.25, **f)
    pts = torch.zeros((P, 3), **f)
    system = (torch.zeros((6 * N, 6 * N), **f), torch.zeros(6 * N, **f),
              torch.zeros((), **f))
    state = WarpFieldState(z3, torch.ones(N, dtype=torch.bool, **f), rot, z3)
    return {
        "knn": lambda: knn.knn_cuda(pts, z3, 4),
        "lbs_warp": lambda: lbs.lbs_warp_cuda(
            pts, anchors, w4, torch.ones(P, dtype=torch.bool, **f), state),
        "point_term_blocks": lambda: gn_assembly.point_term_accumulate_cuda(
            pts, pts, torch.ones(P, **f), anchors, w4, z3, rot, z3, 1.0,
            *system),
        "arap_term_blocks": lambda: gn_assembly.arap_term_accumulate_cuda(
            z3, rot, z3, torch.zeros((N, E), dtype=torch.int32, **f),
            torch.ones((N, E), **f), torch.ones(N, **f), z3, *system),
    }


@pytest.mark.parametrize("dev", ["cpu", "meta"])
@pytest.mark.parametrize("name", ["knn", "lbs_warp", "point_term_blocks",
                                  "arap_term_blocks"])
def test_wrapper_launches_on_its_tensors_device(launches, name, dev):
    _calls(dev)[name]()
    d = torch.device(dev)
    assert launches[0] == ("enter", d)
    assert launches[1] == ("stream", d)
    assert launches[2][0] == "kernel" and launches[3] == ("exit", None)
    assert D.launch_counts[name] == 1


@pytest.mark.parametrize("name", ["knn", "lbs_warp", "point_term_blocks",
                                  "arap_term_blocks"])
def test_wrapper_refuses_inputs_on_two_devices(launches, name):
    with pytest.raises(ValueError, match="different devices"):
        _calls("meta", node_dev="cpu")[name]()
    assert launches == [] and D.launch_counts[name] == 0
