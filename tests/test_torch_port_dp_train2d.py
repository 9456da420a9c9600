"""Data-parallel 2D training of the port against the JAX package's: the
JAX ``Trainer`` on ``make_mesh(n_data=2)`` against the port's gloo world
of 2 for the UNet-3+ (BatchNorm in ``UNetConv2`` / ``ConvBNReLU``) at 32²
with F1 + IoU, its float64 step against the world of 1, and an eval set
that is one batch the ranks cannot split (what is held and why:
``torch_port_dp_checks.py``; the 3D trainers:
``test_torch_port_dp_train.py``)."""

import pytest

import torch_port_dp_checks as C


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.make_runs(tmp_path_factory, ("2d",))


def test_losses_match_jax(runs):
    C.check_losses(runs, "2d")


def test_step1_gradients_match(runs):
    C.check_step1_gradients(runs, "2d")


def test_batchnorm_statistics_match_jax(runs):
    C.check_batchnorm_statistics(runs, "2d")


def test_parameters_match_jax(runs):
    C.check_parameters(runs, "2d")


def test_eval_metrics_match_jax(runs):
    C.check_eval_metrics(runs, "2d")


def test_tail_batch_that_does_not_divide_counts_once(runs):
    C.check_tail_batch_counts_once(runs)


def test_only_rank0_writes_checkpoints_and_logs(runs):
    C.check_only_rank0_writes(runs, "2d")
