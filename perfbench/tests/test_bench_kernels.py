"""Each kernel's byte and operation counts against a hand count at the
cells' launch shapes, and the profiler names each kernel file claims."""

import pytest

from harness import cells, shapes, trace

N = 2 ** 26        # samples of a launch on every cell


def shape(cell):
    c = cells.workload(cell)
    return dict(shapes.launch_shape(c, cells.config(c["config"])), n=N)


def test_launch_shapes_follow_the_solvers_plans():
    s = shape("sing3d.vegasplus")
    assert (s["S"], s["ncubes"], s["chunk"], s["nhist"], s["tables"]) == \
        (3, 25 ** 3, 131072, 1000, 2 * 1000)
    s = shape("sing3d.vegas")
    assert (s["strata"], s["m"]) == (1000, 1024)
    s = shape("bubble.vegas")
    assert (s["S"], s["ncomp"], s["nhist"], s["tables"]) == (5, 4, 4 * 1000, 4 * 2000 + 9)


def test_vplus_sample_by_hand():
    s = shape("sing3d.vegasplus")
    # seeds 16x2 int32, the chunk's cubes, maps 2x1000 floats, 3 slots' 8
    # meta ints; x and gidx 4 bytes each, 3 slots
    want = 16 * 8 + 131072 * 4 + 2000 * 4 + 24 * 4 + 3 * N * 8
    nbytes, flops, ints = cells.kernel("vplus_sample").counts(s)
    assert nbytes == want
    assert flops == 12 * 3 * N and ints == 14 * 3 * N + 10 * N
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.4809, abs=2e-3)   # PERF.md's bound


def test_vplus_reduce_by_hand():
    s = shape("sing3d.vegasplus")
    want = (N * 4 + 3 * N * 4 + 131072 * 4 + 15625 * 4 + 2000 * 4 + 24 * 4
            + 16 * 8 + 15625 * 8 + 1000 * 8)
    nbytes, flops, ints = cells.kernel("vplus_reduce").counts(s)
    assert (nbytes, flops, ints) == (want, 40 * N * 4, 0)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.3207, abs=2e-3)


def test_vegas_sample_and_reduce_by_hand():
    s = shape("sing3d.vegas")
    rows = 3 * N // 1024
    nbytes, flops, ints = cells.kernel("vegas_sample").counts(s)
    assert nbytes == 16 * 16 + 3 * 64 * 4 + 2000 * 4 + 3 * N * 4 + rows * 8
    assert (flops, ints) == (5 * 3 * N, 19 * 3 * N)
    nbytes, flops, ints = cells.kernel("vegas_reduce").counts(s)
    assert nbytes == N * 4 + rows * 8 + 16 * 8 + 1000 * 8
    assert (flops, ints) == (8 * 4 * N, 0)


def test_mixed_kernels_by_hand():
    s = shape("bubble.vegas")
    nbytes, flops, ints = cells.kernel("vegas_sample_mixed").counts(s)
    assert nbytes == 16 * 8 + 8009 * 4 + 40 * 4 + 5 * 64 * 4 + 5 * N * 8
    assert (flops, ints) == (5 * 5 * N, 10 * N + 10 * 5 * N)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.8013, abs=2e-3)   # PERF.md's bound
    nbytes, flops, ints = cells.kernel("vegas_reduce_mixed").counts(s)
    assert nbytes == N * 4 + 5 * N * 4 + 4 * N * 4 + 8009 * 4 + 40 * 4 + 16 * 4 * 8 + 4000 * 8
    assert (flops, ints) == (N * (5 + 8) + 4 * N, 0)
    # PERF.md's bound, 0.8063 ms, less the kernel's per-warp partial rows
    # (16.8 MB), which the law does not need: it writes a block's sums
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.8063 - 16.8e6 / 3.35e9, abs=2e-4)


NAMES = {
    "vplus_sample": "void (anonymous namespace)::vplus_sample_kernel<float>(unsigned int const*, int)",
    "vplus_reduce": "void (anonymous namespace)::vplus_reduce_kernel<float, 0, false>(float const*)",
    "vegas_sample": "void (anonymous namespace)::vegas_sample_kernel<float, true>(unsigned int const*)",
    "vegas_reduce": "void (anonymous namespace)::vegas_reduce_kernel<float, true, false, false>(int)",
    "vegas_reduce_mixed": "void (anonymous namespace)::vegas_reduce_mixed_kernel<float, false, 1, "
                          "false>(std::conditional<false, float, float>::type const*)",
    "vegas_relw_mixed": "void (anonymous namespace)::vegas_reduce_mixed_kernel<float, false, 2, "
                        "false>(std::conditional<false, float, float>::type const*)",
    "vegas_sample_mixed": "void (anonymous namespace)::vegas_sample_mixed_kernel<float>(int)",
}


@pytest.mark.parametrize("kernel", sorted(NAMES))
def test_a_trace_name_belongs_to_its_kernel_alone(kernel):
    assert trace.owner(NAMES[kernel], cells.all_kernels()) == kernel


def test_the_chunked_body_counts_as_vplus_reduce():
    name = "void vplus_reduce_chunks_kernel<double, false, 1>(double const*)"
    assert trace.owner(name, cells.all_kernels()) == "vplus_reduce"


def test_torch_kernels_belong_to_no_kernel_file():
    for name in ("void at::native::vectorized_elementwise_kernel<4, at::native::sin_kernel_cuda>",
                 "void at::native::reduce_kernel<128, 4>(int)", "Memcpy DtoD (Device -> Device)"):
        assert trace.owner(name, cells.all_kernels()) is None
