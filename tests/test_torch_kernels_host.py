"""What surrounds the port's CUDA kernels and runs without a card: the
wrappers' checks, the scratch layout they hand to the kernels, the parts
they name, the sources they build, and the grouping of kernel names in
profile_train_step.py.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from geobignn_tpu_torch.ops import banded_cuda, blocksparse
from geobignn_tpu_torch.testing import share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "geobignn_tpu_torch", "csrc")


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


class _FakeLib:
    """Stands for a kernel library's limit functions."""

    def __init__(self, mult=32, heads=16, width=1152):
        self.pre_tile_multiple = lambda: mult
        self.pre_max_heads = lambda: heads
        self.pre_max_width = lambda: width


@pytest.fixture
def fresh_limits():
    saved = dict(banded_cuda._limits)
    banded_cuda._limits.clear()
    yield
    banded_cuda._limits.clear()
    banded_cuda._limits.update(saved)


@pytest.mark.parametrize("heads,cv,ldk", [(9, 6, 56), (9, 12, 108), (9, 32, 288),
                                          (9, 64, 576), (9, 128, 1152), (9, 5, 48),
                                          (1, 1, 4)])
def test_scratch_rows_are_padded_to_four_floats(heads, cv, ldk, fresh_limits):
    m = torch.zeros((2, 32, 96), dtype=torch.int8)
    assert banded_cuda._fit(_FakeLib(), "pre_", m, heads, cv) == ldk
    assert ldk % 4 == 0 and 0 <= ldk - heads * cv < 4


@pytest.mark.parametrize("shape,heads,cv,match", [
    ((2, 48, 144), 9, 32, "tile 48"),       # not a multiple of 32
    ((2, 32, 96), 17, 8, "exceed"),         # too many heads
    ((2, 32, 96), 9, 129, "exceed"),        # H * cv over the accumulator's width
])
def test_wrapper_refuses_what_the_kernels_do_not_take(shape, heads, cv, match,
                                                      fresh_limits):
    m = torch.zeros(shape, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        banded_cuda._fit(_FakeLib(), "pre_", m, heads, cv)


def test_wrapper_refuses_a_misaligned_mask(fresh_limits):
    """A lane reads 16 mask bytes at a time: the mask starts on a 16-byte
    boundary or the wrapper raises."""
    base = torch.zeros(2 * 32 * 96 + 1, dtype=torch.int8)
    m = base[1:].reshape(2, 32, 96)
    assert m.is_contiguous() and m.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        banded_cuda._fit(_FakeLib(), "pre_", m, 9, 32)


def test_limits_are_read_once_per_library(fresh_limits):
    calls = []
    lib = _FakeLib()
    lib.pre_max_heads = lambda: calls.append(1) or 16
    m = torch.zeros((2, 32, 96), dtype=torch.int8)
    for _ in range(3):
        banded_cuda._fit(lib, "pre_", m, 9, 32)
    assert len(calls) == 1


def test_parts_buffer_and_names():
    none = banded_cuda._Parts(None)
    assert none.ptr is None
    none.fill(("a",))  # nothing to fill, nothing raised
    got: dict = {}
    parts = banded_cuda._Parts(got)
    assert parts.ptr is not None
    parts.buf[0], parts.buf[1] = 0.25, 0.5
    parts.fill(banded_cuda.FWD_PARTS[True])
    assert got == {"operand product": 0.25, "window kernel": 0.5}
    m = re.search(r"constexpr int kMaxParts = (\d+);", _read("banded_common.cuh"))
    assert int(m.group(1)) == banded_cuda._MAX_PARTS
    for names in (*banded_cuda.FWD_PARTS.values(), *banded_cuda.BWD_PARTS.values()):
        assert len(names) <= banded_cuda._MAX_PARTS and len(set(names)) == len(names)


@pytest.mark.parametrize("header,parts", [("window_fwd.cuh", "FWD_PARTS"),
                                          ("window_bwd.cuh", "BWD_PARTS")])
def test_parts_name_every_launch_of_the_sequence(header, parts):
    """The longer schedule's names count the timer marks of the launch
    sequence (one launch belongs to one schedule alone, so the other has one
    name fewer)."""
    src = _read(header)
    marks = src[src.index("int launch_window_"):].count("timer.mark();")
    lengths = sorted(len(v) for v in getattr(banded_cuda, parts).values())
    assert lengths == [marks - 1, marks]


def test_every_header_is_watched_and_every_source_builds_from_the_repo():
    headers = {os.path.basename(h) for h in banded_cuda.HEADERS}
    assert headers == {f for f in os.listdir(CSRC) if f.endswith(".cuh")}
    assert {"banded_common.cuh", "node_product.cuh", "window_walk.cuh",
            "window_fwd.cuh", "window_bwd.cuh"} <= headers
    for key, src in banded_cuda.SOURCES.items():
        text = open(src).read()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in headers, (key, inc)
        assert "torch/" not in text and "ATen" not in text, key


def test_kernel_sources_use_no_atomics_and_no_library_products():
    for name in os.listdir(CSRC):
        code = "\n".join(ln.split("//")[0] for ln in _read(name).splitlines())
        assert not re.search(r"\batomic\w*\s*\(", code), name
        assert "cublas" not in code.lower() and "cutlass" not in code.lower(), name
    for mod in (banded_cuda, blocksparse):
        for fn in (mod._launch, mod._launch_bwd):
            names = fn.__code__.co_names
            assert "matmul" not in names and "einsum" not in names and "mm" not in names


def test_dense_window_walk_and_naive_products_are_gone():
    gone = ("window_aggregate_kernel", "xbar_tf_kernel", "wbar_partial_kernel",
            "window_operand_kernel", "bwd_col_kernel", "bwd_row_kernel")
    for name in os.listdir(CSRC):
        text = _read(name)
        assert not any(k in text for k in gone), name
    walk = _read("window_walk.cuh")
    assert "row_walk_kernel" in walk and "__ballot_sync" in walk
    assert "node_product_kernel" in _read("node_product.cuh")


# the tensor-core product's name in a trace (demangled, as torch's profiler
# reports it)
MMA_TRACE_NAME = ("void (anonymous namespace)::node_product_kernel_mma<true, 128>"
                  "((anonymous namespace)::MmaArgs)")


def test_tensor_core_product_is_a_bf16_mma_with_f32_accumulators():
    """The products of two cast operands have a tensor-core kernel whose
    name holds `node_product_kernel` (the benchmark and the profile find the
    per-node products by it): bf16 operands, f32 accumulators, and both
    routed launches (Y / V, gy / G) reach it; the SIMT kernel stays."""
    src = _read("node_product.cuh")
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                         code)
    assert set(kernels) == {"node_product_kernel", "node_product_kernel_mma"}
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "__floats2bfloat162_rn" in code and "float acc[2][4][4]" in code
    for launcher in ("launch_tf_operand", "launch_af_row_operand"):
        body = code[code.index(f"inline int {launcher}("):]
        body = body[:body.index("\n}\n")]
        assert "mma_route(" in body and "launch_node_product_mma<" in body, launcher
        assert "launch_node_product<" in body, launcher  # the CUDA-core route stays
    assert "launch_af_row_operand(" in _read("window_bwd.cuh")
    assert "launch_tf_operand(" in _read("window_fwd.cuh")


def test_routing_rule_matches_the_source():
    """banded_cuda.mma_route, which the wrappers count by, is the rule of
    node_product.cuh's mma_route: bf16, 16 <= k <= kMmaMaxK, k a multiple
    of 16, A 16-byte aligned."""
    m = re.search(r"constexpr int kMmaMaxK = (\d+);", _read("node_product.cuh"))
    assert int(m.group(1)) == banded_cuda.MMA_MAX_K
    src = _read("node_product.cuh")
    rule = src[src.index("inline bool mma_route("):]
    rule = rule[:rule.index("}")]
    for term in ("bf16 != 0", "k >= 16", "k <= kMmaMaxK", "k % 16 == 0", "& 15) == 0"):
        assert term in rule, term


@pytest.mark.parametrize("k,dtype,offset,routed", [
    (64, torch.bfloat16, 0, True), (128, torch.bfloat16, 0, True),
    (16, torch.bfloat16, 0, True), (32, torch.bfloat16, 0, True),
    (12, torch.bfloat16, 0, False), (144, torch.bfloat16, 0, False),
    (40, torch.bfloat16, 0, False), (64, torch.float32, 0, False),
    (64, torch.bfloat16, 1, False),
])
def test_mma_route_cases(k, dtype, offset, routed):
    base = torch.zeros(8 * k + 4, dtype=torch.float32)
    a = base[offset:offset + 8 * k].reshape(8, k)
    assert (a.data_ptr() % 16 == 0) == (offset == 0)
    assert banded_cuda.mma_route(a, k, dtype) is routed


@pytest.mark.parametrize("c_in,c_out,backward,dtype,counts", [
    (64, 32, False, torch.bfloat16, {"mma": 1, "simt": 0}),    # Y / V
    (64, 32, True, torch.bfloat16, {"mma": 1, "simt": 2}),     # Y / V; x̄, W̄
    (12, 32, False, torch.bfloat16, {"mma": 0, "simt": 1}),    # out
    (12, 32, True, torch.bfloat16, {"mma": 1, "simt": 1}),     # gy / G; W̄
    (64, 32, True, torch.float32, {"mma": 0, "simt": 3}),
    (12, 32, True, torch.float32, {"mma": 0, "simt": 2}),
    (6, 12, True, torch.bfloat16, {"mma": 0, "simt": 2}),      # gy at k 12
], ids=["tf", "tf-bwd", "af", "af-bwd", "tf-bwd-f32", "af-bwd-f32", "af-bwd-k12"])
def test_products_are_counted_by_route(c_in, c_out, backward, dtype, counts, monkeypatch):
    monkeypatch.setattr(banded_cuda, "PRODUCTS", {"mma": 0, "simt": 0})
    x = torch.zeros((64, c_in))
    gout = torch.zeros((64, c_out))
    tf = banded_cuda.use_transform_first(c_in, c_out)
    banded_cuda.count_products(tf, backward, x, gout if backward else None, dtype)
    assert banded_cuda.PRODUCTS == counts


def test_reset_launches_zeroes_the_product_counts(monkeypatch):
    monkeypatch.setattr(banded_cuda, "PRODUCTS", {"mma": 3, "simt": 5})
    banded_cuda.reset_launches()
    assert banded_cuda.PRODUCTS == {"mma": 0, "simt": 0}


def test_benchmark_finds_the_tensor_core_product_by_name():
    """benchmark/metrics/agg_roofline_pct.py sums the aggregates' device time
    by substrings of their names: the tensor-core product is among them."""
    spec = importlib.util.spec_from_file_location(
        "agg_roofline_pct", os.path.join(ROOT, "benchmark", "metrics", "agg_roofline_pct.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert any(k in MMA_TRACE_NAME for k in mod.AGGREGATE_KERNELS)


def _profile_module():
    spec = importlib.util.spec_from_file_location(
        "profile_train_step", os.path.join(ROOT, "profile_train_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::row_walk_kernel<false, 3, false, true>(float const*)",
     "banded forward walk"),
    ("void (anonymous namespace)::row_walk_kernel<(bool)0, (int)5, (bool)1, (bool)0>(float const*)",
     "banded backward row pass"),
    ("void (anonymous namespace)::row_walk_kernel<true, 3, false, false>(float const*)",
     "block-sparse forward walk"),
    ("void (anonymous namespace)::col_walk_kernel<true, 3>(float const*)",
     "block-sparse backward column pass"),
    ("void (anonymous namespace)::col_walk_kernel<false, 9>(float const*)",
     "banded backward column pass"),
    ("void (anonymous namespace)::node_product_kernel<false, true, true, false>(ProductArgs)",
     "per-node products (Y, x̄, W̄, gy, out)"),
    (MMA_TRACE_NAME, "per-node products (Y, x̄, W̄, gy, out)"),
    ("(anonymous namespace)::scaled_operand_kernel(float const*, float const*)",
     "elementwise operands (V, G)"),
    ("void (anonymous namespace)::nearest_small_k(float const*)", "nearest distance"),
    ("(anonymous namespace)::stamp_kernel(long long*, int*, int, int, int)",
     "stage clock (timestamps)"),
    ("void at::native::(anonymous namespace)::indexing_backward_kernel<float, 4>(long const*)",
     "index backward (autograd)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
     "everything else (PyTorch ops)"),
])
def test_profile_groups_kernels_by_their_present_names(name, group):
    assert _profile_module().kernel_group(name) == group


@pytest.mark.parametrize("name,aggregate", [
    ("void (anonymous namespace)::row_walk_kernel<false, 3, false, false>(float const*)",
     "aggregate_first"),
    ("void (anonymous namespace)::row_walk_kernel<false, 9, false, true>(float const*)",
     "transform_first"),
    ("void (anonymous namespace)::row_walk_kernel<(bool)0, (int)5, (bool)1, (bool)0>(float)",
     "aggregate_first_bwd"),
    ("void (anonymous namespace)::row_walk_kernel<true, 1, true, true>(float const*)",
     "bs_transform_first_bwd"),
    ("void (anonymous namespace)::row_walk_kernel<true, 3, false, false>(float const*)",
     "bs_aggregate_first"),
    ("void (anonymous namespace)::col_walk_kernel<false, 9>(float const*)", None),
    ("void (anonymous namespace)::node_product_kernel<false, true, true, false>(ProductArgs)",
     None),
    (MMA_TRACE_NAME, None),
])
def test_profile_names_the_aggregate_of_a_walk(name, aggregate):
    """Each launch of an aggregate runs one walk kernel, whose template
    arguments name the aggregate: chip_smoke.py counts a replayed graph's
    launches by them."""
    mod = _profile_module()
    assert mod.aggregate_of(name) == aggregate
    if aggregate is not None:
        assert mod.aggregate_launches({name: (1.0, 3.0), "other": (1.0, 5.0)}) \
            == {aggregate: 3}


def test_profile_names_exist_in_the_sources():
    """Every hand-written kernel name the profile looks for is a __global__
    function of csrc/, and every __global__ function there is looked for."""
    mod = _profile_module()
    found = set()
    for name in os.listdir(CSRC):
        text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "", _read(name))
        found |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    assert found == set(mod.HAND_WRITTEN)


def test_edge_case_generator_is_numpy_only():
    from geobignn_tpu_torch import testing

    case = testing.edge_case_inputs(12, 32, tile=32, n_blk=2, seed=3)
    assert all(isinstance(v, np.ndarray) for v in case.values())
    assert case["m"].dtype == np.int8 and case["r"].dtype == np.float32
