"""UNet_3Plus_DeepSup's gradients at 48² (the bottleneck pools to 3x3)
against ``jax.vjp`` of the JAX module, in float64: the check and its
tolerances are ``test_torch_port_unet3plus_grads.check_gradients``."""

from tests.test_torch_port_unet3plus_grads import check_gradients


def test_deep_supervision_gradients_at_48_match_jax_vjp_in_float64():
    check_gradients("UNet_3Plus_DeepSup", 48, True)
