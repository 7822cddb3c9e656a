"""The reduction of a device trace: busy time as the union of device
operations, the span, the breakdown, the stages' own spans left out, and
the count of each hand kernel's launches."""

import torch

from benchmark.harness.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, user=False):
        self._n, self._d, self._s, self._e, self._u = (name, dev, start, end,
                                                       user)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


SPECS = [{"name": "conv3x3x3_wgmma", "trace_name": "conv_wgmma_kernel"},
         {"name": "cc_label", "trace_name": "cc_kernel"}]


def test_reduction_by_hand():
    events = [
        Ev("track", CPU, 0, 100),                   # a stage's span
        Ev("track", CUDA, 0, 100),                  # ... on the device
        Ev("aten::mm", CPU, 10, 20),
        Ev("void conv_wgmma_kernel<32>(x)", CUDA, 10, 30),
        Ev("elementwise", CUDA, 20, 40),            # overlaps: union 10-40
        Ev("aten::item", CPU, 45, 70),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 60, 65),
        Ev("void acc_kernel(x)", CUDA, 90, 100),    # no hand kernel
        Ev("Stream Wait Event", CUDA, 70, 90),      # a marker
    ]
    r = reduce_events(events, SPECS)
    assert r["busy_s"] == 45e-9                     # 30 + 5 + 10
    assert r["window_s"] == 100e-9
    assert r["hand_launches"] == {"conv3x3x3_wgmma": 1, "cc_label": 0}
    names = [n for n, _ in r["device_ops"]]
    assert "track" not in names and "Stream Wait Event" not in names
    assert r["device_ops"][0][0] == "void conv_wgmma_kernel<32>(x)"
    # the longest gap 65-90 is named by the innermost host op at 77
    assert r["idle_gaps"][0] == ["track", 25e-9]
    assert r["idle_gaps"][1] == ["aten::item", 20e-9]
