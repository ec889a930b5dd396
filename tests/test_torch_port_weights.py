"""The flax -> torch weight converter (`state_dict_from_flax`).

(f) round trip: a reference-named state_dict (the port's modules carry the
reference's names) -> the JAX package's `convert_state_dict` -> the port's
converter gives back exactly the same tensors; and a flax tree shaped like
`GPSGaussianModel.init`'s output converts to a state_dict that loads
strictly into the port's model.
"""

import jax
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu.testing import fake_stereo_batch
from gps_gaussian_tpu.utils.torch_import import convert_state_dict

from gps_gaussian_tpu_torch.models.gps_gaussian import \
    GPSGaussianModel as TModel
from gps_gaussian_tpu_torch.models.layers import init_weights
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from thread_budget import thread_budget  # noqa: F401

DIMS = dict(encoder_dims=(16, 24, 32), hidden_dim=32, context_dim=32,
            gsnet_encoder_dims=(16, 24, 32), gsnet_decoder_dims=(24, 32, 32),
            gsnet_head_dim=16)


@pytest.mark.parametrize("with_gs", [True, False])
def test_reference_state_dict_round_trip(with_gs):
    model = TModel(with_gs=with_gs, **DIMS)
    init_weights(model, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = state_dict_from_flax(convert_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    assert any(k.startswith("gs_parm_regresser.rot_head.0")
               for k in back) == with_gs


def test_flax_init_tree_loads_strictly():
    flax_model = GPSGaussianModel(**DIMS, with_gs=True)
    shapes = jax.eval_shape(
        lambda key: flax_model.init(key, fake_stereo_batch(res=16), iters=3,
                                    test_mode=True),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = state_dict_from_flax(params)
    model = TModel(with_gs=True, **DIMS)
    model.load_state_dict(sd)   # strict: every key present, every shape
    hd = DIMS["gsnet_head_dim"]
    fused = params["params"]["gs_regresser"]["head_conv1"]["Conv_0"]
    for i, head in enumerate(("rot_head", "scale_head", "opacity_head")):
        np.testing.assert_array_equal(
            sd[f"gs_parm_regresser.{head}.0.weight"].numpy(),
            fused["kernel"][..., i * hd:(i + 1) * hd].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd[f"gs_parm_regresser.{head}.0.bias"].numpy(),
            fused["bias"][i * hd:(i + 1) * hd])
