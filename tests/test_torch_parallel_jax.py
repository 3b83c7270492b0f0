"""The port's fp32 train step of the detection tasks on a (dp, mp) mesh of gloo
ranks against the JAX package's single-device step, at (2, 1), (1, 2) and
(2, 2), within ``tests/test_torch_train.py``'s bounds
(``tests/torch_parallel_jax_ref.py`` has the setting and the bounds; the
tasks are split over two files so that each stays near two minutes)."""

import pytest

import torch_parallel_jax_ref as R
from torch_one_thread import torch_on_one_thread  # noqa: F401

TASKS = ('person_detection', 'face_detection')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.runs(TASKS, tmp_path_factory)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("shape", R.SHAPES, ids=lambda s: f"dp{s[0]}_mp{s[1]}")
def test_fp32_step_on_a_mesh_matches_jax_single_device(runs, shape, task):
    R.check(runs, shape, task)
