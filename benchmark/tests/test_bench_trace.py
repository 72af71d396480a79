"""The reduction of a profiler trace to what the per-layer metrics read, on
a made-up trace: busy and idle time, idle time inside host spans, kernels
by name, and the breakdown of idle gaps by the innermost host span."""

from __future__ import annotations

import pytest

import bench_fixture  # noqa: F401  (puts the benchmark on sys.path)
from lcbench.trace import reduce_events, short_name

EVENTS = [
    ("bench.window", False, 0.0, 10.0, True),
    ("bench.prove", False, 1.0, 5.0, True),
    ("phase.prove.collapse", False, 1.0, 2.0, True),
    ("bench.prove", True, 1.0, 5.0, True),                 # the GPU's copy of an annotation
    ("void (anonymous namespace)::ntt_pass<8>((anonymous namespace)::Pass)", True, 0.0, 1.0, False),
    ("void (anonymous namespace)::collapse<short>(int const*)", True, 2.0, 2.5, False),
    ("Memcpy DtoH (Device -> Pageable)", True, 2.4, 3.0, False),
    ("void (anonymous namespace)::ntt_pass<8>((anonymous namespace)::Pass)", True, 6.0, 8.0, False),
    ("aten::add", False, 6.0, 6.1, False),
]


def test_reduction():
    t = reduce_events(EVENTS)
    assert t.window_s == 10.0
    assert t.busy_s() == pytest.approx(1.0 + 1.0 + 2.0)
    assert t.kernel_seconds("ntt_pass") == (pytest.approx(3.0), 2)
    assert t.kernel_seconds("collapse") == (pytest.approx(0.5), 1)
    assert [k[0] for k in t.kernels] == ["ntt_pass<8>", "collapse<short>", "ntt_pass<8>"]
    assert t.idle_share_in("bench.prove") == pytest.approx(1.0 - 1.0 / 4.0)
    assert t.idle_share_in("bench.verify") is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["ntt_pass<8>", pytest.approx(3.0)]
    gaps = dict(b["idle_gaps"])
    # a gap goes whole to the innermost span at its middle: 3..6 to the prove
    assert gaps == {"phase.prove.collapse": pytest.approx(1.0), "bench.prove": pytest.approx(3.0),
                    "host.between_calls": pytest.approx(2.0)}


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        reduce_events(EVENTS[1:])


def test_short_names():
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::CUDAFunctor_add<int>, std::array<char*, 3ul> >(int)") == \
        "vectorized_elementwise_kernel<4, CUDAFunctor_add<int>, array<char*, 3ul> >"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"
