"""Data-parallel 3D training of the port against the JAX package's: the
JAX ``UNetTrainer`` on ``make_mesh(n_data=2)`` against the port's gloo
world of 2 and its world of 1, for UNet3D 'gcr' with ``DiceLoss`` and
'bcr' (BatchNorm) with ``BCEDiceLoss`` (what is held and why:
``torch_port_dp_checks.py``; the 2D UNet-3+: ``test_torch_port_dp_train2d.
py``)."""

import pytest

import torch_port_dp_checks as C

KINDS = ("gcr", "bcr")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.make_runs(tmp_path_factory, KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_losses_match_jax(runs, kind):
    C.check_losses(runs, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_step1_gradients_match(runs, kind):
    C.check_step1_gradients(runs, kind)


def test_batchnorm_statistics_match_jax(runs):
    C.check_batchnorm_statistics(runs, "bcr")


@pytest.mark.parametrize("kind", KINDS)
def test_parameters_match_jax(runs, kind):
    C.check_parameters(runs, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_eval_metrics_match_jax(runs, kind):
    C.check_eval_metrics(runs, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_only_rank0_writes_checkpoints_and_logs(runs, kind):
    C.check_only_rank0_writes(runs, kind)
