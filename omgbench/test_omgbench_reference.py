"""The plain reference against the program's own operators (in the test
only: the reference imports nothing of the program), the byte model
against a hand count, and the trace reduction on a made-up trace."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import openmg_tpu_torch as mg
from omgbench import spec, tracing
from omgbench.reference import stencil

roofline = spec.module("metrics", "roofline_share")


def test_the_reference_medium_matches_diffusion_stencil_at_8():
    kappa = 0.5 + np.random.default_rng(4).random((8, 8, 8))
    offs, coeffs = mg.diffusion_stencil(kappa)
    r_offs, r_coeffs = stencil.diffusion_stencil(torch.from_numpy(kappa))
    assert r_offs == tuple(offs)
    np.testing.assert_allclose(r_coeffs.numpy(), coeffs, rtol=1e-14, atol=0)


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 10, 12), (16, 24)])
def test_the_reference_residuals_match_the_matrices(shape):
    rng = np.random.default_rng(5)
    b, x = rng.standard_normal(shape), rng.standard_normal(shape)
    want = b.ravel() - mg.poisson(shape) @ x.ravel()
    got = stencil.poisson_residual(torch.from_numpy(b), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-13, atol=1e-13)
    kappa = 0.5 + rng.random(shape)
    want = b.ravel() - mg.diffusion(kappa) @ x.ravel()
    offs, coeffs = stencil.diffusion_stencil(torch.from_numpy(kappa))
    got = stencil.stencil_residual(offs, coeffs, torch.from_numpy(b), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-13, atol=1e-13)


def tiny_config(grids=0, outer=0):
    return {"levels": [{"shape": [8, 8, 8], "grids": grids}, {"shape": [4, 4, 4]}],
            "outer": {"grids": outer}}


def test_the_byte_model_equals_a_hand_count():
    # 8³ above a dense 4³: n = 512, n_c = 64, float32
    down = 4 * (512 + 512 + 64)  # b read; x, restricted r written
    up = 4 * (512 + 512 + 64 + 512)  # b, x, ec read; x written
    coarse_member = 4 * (64 + 64)  # its b read, x written
    outer = 4 * 8 * 512  # b, x pairs and e read; x pair and r written
    member = down + up + coarse_member + outer
    shared = 4 * 64 * 64  # the dense inverse once a step
    assert roofline.step_bytes(tiny_config()) == (shared, member)
    start = 4 * 512  # b read for the first norm
    assert roofline.call_bytes(tiny_config(), [2]) == start + 2 * (shared + member)
    # a batch narrows: 2 members in step 1, 1 in step 2
    assert roofline.call_bytes(tiny_config(), [2, 1]) == (
        2 * start + (shared + 2 * member) + (shared + member))
    # 7 coefficient grids: once a leg (two a visit), hi and lo once a step
    legs, residual = 2 * 4 * 7 * 512, 2 * 4 * 7 * 512
    assert roofline.step_bytes(tiny_config(7, 7)) == (shared + legs + residual, member)


def test_the_full_size_models_count_what_the_records_say():
    b = spec.load()
    per_cycle = {c["name"]: sum(roofline.step_bytes(spec.config(b, {"config": c["name"]})))
                 for c in b["configs"]}
    assert 0.99e9 < per_cycle["poisson3d-256"] < 1.02e9  # 0.94 GB of fields + 67 MB inverse
    assert 3.3e9 < per_cycle["diffusion3d-256"] < 3.5e9


class FakeTrace:
    def __init__(self, busy_s):
        self.first, self.count, self.busy_s, self.window_s = 0, 1, busy_s, 1.0


class FakeRun:
    def __init__(self, busy_s):
        self.config = tiny_config()
        self.kind = "NVIDIA H100 80GB HBM3"
        self.calls = [type("C", (), {"cycles": [3]})()]
        self.trace = FakeTrace(busy_s)


def test_the_share_is_100_only_at_the_data_sheet_rate():
    """The share is the least bytes over busy time at 3.35 TB/s: a device
    busy exactly as long as those bytes take at that rate reads 100 %, any
    longer less; nothing clips it."""
    at_peak = roofline.call_bytes(tiny_config(), [3]) / 3.35e12
    assert roofline.read(FakeRun(at_peak)) == pytest.approx(100.0)
    assert roofline.read(FakeRun(2 * at_peak)) == pytest.approx(50.0)
    assert roofline.read(FakeRun(0.5 * at_peak)) == pytest.approx(200.0)
    assert roofline.read(FakeRun(0.0)) is None


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_the_trace_reduction():
    events = [
        ev(tracing.CALL_SPAN, "user_annotation", 100, 100),  # window 100 us ...
        ev(tracing.CALL_SPAN, "user_annotation", 230, 70),  # ... to 300 us
        ev("aten::sum", "cpu_op", 120, 20),
        ev("cudaLaunchKernel", "cuda_runtime", 125, 5),
        ev("k1", "kernel", 90, 40),  # clipped to 100-130
        ev("k1", "kernel", 140, 20),
        ev("Memcpy DtoH", "gpu_memcpy", 150, 20),  # overlaps k1: busy 140-170
        ev("k3", "kernel", 180, 10),
        ev("k2", "kernel", 250, 60),  # clipped to 250-300
        ev("k2", "kernel", 400, 10),  # outside
    ]
    s = tracing.summarize(events, first=3, count=2)
    assert (s.first, s.count) == (3, 2)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx((30 + 30 + 10 + 50) * 1e-6)
    assert s.kernels == 3  # the kernels that start inside the window
    ops = dict(s.device_ops)
    assert ops["k1"] == pytest.approx(50e-6) and ops["k2"] == pytest.approx(50e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(20e-6)
    # 130-140 in aten::sum (its launch call has ended), 170-180 Python in
    # the first call, 190-250 (middle 220) between the calls
    assert dict(s.idle_gaps) == pytest.approx({
        "host: aten::sum": 10e-6, "host: Python inside a call": 10e-6,
        "host: Python between calls": 60e-6})
    assert s.idle_gaps[0][0] == "host: Python between calls"
