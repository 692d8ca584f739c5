"""The per-layer metric readers on a canned traced window."""

import pytest

from portbench.arch import mat
from portbench.spec import metric_reader
from portbench.tests.tinyroot import REPO

ROUTES = {r: v.ranges for r, v in mat.routes().items()}

CTX = {
    "trace": {"window_s": 3.0, "busy_s": 1.5,
              "device": {"window_s": 2.0, "busy_s": 1.5},
              "kernels": {"void at::native::vectorized_elementwise_kernel": 0.2,
                          "sm90_gemm_kernel": 1.0, "Memcpy HtoD": 0.3},
              "ranges": {"fc_attn_fwd": 0.1, "fc_attn_bwd": 0.2,
                         "fc_mlp_fwd": 0.1, "fc_mlp_bwd": 0.2,
                         "fc_flash_fwd": 0.05},
              "idle_gaps": {}},
    "records": [{"sections": {"train": 1.5, "aggregate": 0.02},
                 "eval_seconds": 0.1},
                {"sections": {"train": 1.4, "aggregate": 0.04},
                 "eval_seconds": 0.3}],
    "work": {"model_flops": 1.0, "steps": 40,
             "least": {"fused": 0.06, "flash": 0.0}},
    "timed": {"window_s": 4.0, "model_flops": 989e12 * 0.4},
    "routes": ROUTES,
}


@pytest.mark.parametrize("name, want", [
    ("aggregate_ms.train", 30.0),
    ("eval_ms.train", 200.0),
    ("aten_ms_per_step.train", 5.0),
    ("fused_roofline.train", 10.0),
    ("fused_roofline.eval", 10.0),
    ("mfu.train", 10.0),
    ("mfu.eval", 10.0),
    ("idle_share.train", 25.0),
    ("idle_share.eval", 25.0),
])
def test_reader(name, want):
    assert metric_reader(REPO, name)(CTX) == pytest.approx(want)


def test_nothing_to_read_gives_none():
    # no flash work planned: no roofline, never a 0
    assert metric_reader(REPO, "flash_roofline.eval")(CTX) is None
    empty = {"trace": {"window_s": 1.0, "busy_s": 0.0, "kernels": {},
                       "device": {"window_s": 1.0, "busy_s": 0.0},
                       "ranges": {}, "idle_gaps": {}},
             "records": [], "work": {"model_flops": 0.0, "steps": 0,
                                     "least": {}},
             "timed": {"window_s": 1.0, "model_flops": 0.0},
             "routes": ROUTES}
    for name in ("aggregate_ms.train", "eval_ms.train",
                 "aten_ms_per_step.train", "fused_roofline.train",
                 "mfu.train", "idle_share.train"):
        assert metric_reader(REPO, name)(empty) is None, name


class _Event:
    def __init__(self, name, on_card, annotation=False):
        import torch
        self._n, self._a = name, annotation
        self._d = torch.autograd.DeviceType.CUDA if on_card else \
            torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


@pytest.mark.parametrize("event, want", [
    (_Event("sm90_gemm_kernel", True), "device"),
    (_Event("Memcpy HtoD", True), "device"),
    (_Event("fc_attn_fwd", True, annotation=True), "range"),
    (_Event("portbench.update", True, annotation=True), "range"),
    (_Event("fc_mlp_bwd", False, annotation=True), "host"),
    (_Event("aten::mm", False), "host"),
])
def test_event_kinds(event, want):
    import torch
    from portbench.trace import _kind
    assert _kind(event, torch.autograd.DeviceType.CUDA) == want
