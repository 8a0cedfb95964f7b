"""The port's spatially sharded train step on a data 2 x space 2 mesh
(four gloo ranks of CPU processes, each with one row's D slab of a
global batch of 2; tests/_torch_parallel_workers.py), where a mistake in
the groups shows: against JAX's GSPMD step on a (2, 2) mesh of four
virtual CPU devices and against one process, with the tolerances of
tests/test_torch_spatial.py, and the parameters bit-identical across
the four ranks. The world runs while JAX compiles its step and one
process takes its step, in two threads."""

from concurrent.futures import ThreadPoolExecutor

import pytest
from _torch_parallel_workers import World, dp_train_step
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_spatial import (_jax_step, _unet, check_bit_identical,
                                check_equals_one_process,
                                check_step_matches_jax, inputs)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = inputs()
    four = World("spatial_dp", (d["state"], d["batch"]),
                 tmp_path_factory.mktemp("spatial_mesh"), world=4,
                 timeout=240, threads=1)
    with ThreadPoolExecutor(2) as pool:
        step = pool.submit(_jax_step, d["state"], d["batch"], 2, 2)
        one = pool.submit(dp_train_step, _unet(d["state"]), d["batch"])
        d["jax"] = {"2x2": step.result()}
        d["one"] = one.result()
    d["four"] = four.results()
    return d


def test_each_rank_holds_its_row_and_slab(worlds):
    four = worlds["four"]
    assert [r["mesh"] for r in four] == [{"data": 2, "space": 2}] * 4
    assert [r["coords"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["shape"] for r in four} == {(1, 8, 16, 16, 4)}


def test_data_space_step_matches_jax_gspmd_step(worlds):
    check_step_matches_jax(worlds, worlds["four"], "2x2")


def test_data_space_parameters_bit_identical_across_ranks(worlds):
    check_bit_identical(worlds["four"], "step")


def test_data_space_step_equals_one_process(worlds):
    check_equals_one_process(worlds["four"], "step", worlds["one"])
