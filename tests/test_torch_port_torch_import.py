"""Reference-checkpoint import in the port against the JAX package's.

A narrow JAX GPSGaussianModel is initialised at a seed (its GroupNorm
affines and conv biases then moved off their constant init, so a swapped
tensor shows), written as a reference `.pth` ({'network': state_dict},
the reference's names and layouts, through `state_dict_from_flax`), and
read by both packages' `load_reference_checkpoint`. The port's tensors
are the JAX converter's bit for bit, and the port's model on them matches
JAX's model on JAX's import on one 64^2 pair at the f32 tolerances of
test_torch_port_models.py (flow and maps 2e-4, points 1e-4 relative). A
bare state_dict, a stage-1 file and a missing key are held too.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_gaussian_tpu.models.gps_gaussian import GPSGaussianModel
from gps_gaussian_tpu.testing import fake_stereo_batch as jfake_batch
from gps_gaussian_tpu.utils import torch_import as jimport

from gps_gaussian_tpu_torch.models.gps_gaussian import \
    GPSGaussianModel as TModel
from gps_gaussian_tpu_torch.train.state import restore_params_partial
from gps_gaussian_tpu_torch.utils.torch_import import (
    convert_state_dict, load_reference_checkpoint)
from gps_gaussian_tpu_torch.utils.weights import state_dict_from_flax

from test_torch_port_models import (ENC, GS_DEC, GS_ENC, HEAD, HID,
                                    _compare_model, _run_both)
from thread_budget import thread_budget  # noqa: F401

GS = "gs_parm_regresser."


def _jax_model(with_gs=True):
    return GPSGaussianModel(ENC, HID, HID, 4, 4, GS_ENC, GS_DEC, HEAD,
                            with_gs=with_gs)


def _port_model(with_gs=True):
    return TModel(ENC, HID, HID, 4, 4, GS_ENC, GS_DEC, HEAD,
                  with_gs=with_gs).eval()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference-format state_dict, the path of its {'network': ...}
    .pth)."""
    params = jax.jit(lambda key, batch: _jax_model().init(
        key, batch, iters=1))(jax.random.PRNGKey(3),
                              jfake_batch(batch=1, res=32))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "scale":
            return leaf + rng.normal(scale=0.1, size=leaf.shape)
        if name == "bias":
            return leaf + rng.normal(scale=0.05, size=leaf.shape)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    sd = state_dict_from_flax(params)
    sd["raft_stereo.fnet.unused.weight"] = torch.zeros(3)  # read by neither
    path = tmp_path_factory.mktemp("ref_import") / "ref.pth"
    torch.save({"network": sd, "optimizer": {}, "epoch": 7}, path)
    return sd, path


def _same_as_jax(ours, jparams):
    ref = state_dict_from_flax(jparams)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, ref[k]), k


def test_import_matches_jax_model(reference, caplog):
    sd, path = reference
    with caplog.at_level(logging.INFO):
        ours = load_reference_checkpoint(path)
    assert "ignored" in caplog.text
    jparams = jimport.load_reference_checkpoint(str(path))
    _same_as_jax(ours, jparams)
    tm = _port_model()
    tm.load_state_dict(ours)    # strict: every tensor of the model
    out, ref, _ = _run_both(_jax_model(),
                            jax.tree_util.tree_map(jnp.asarray,
                                                   jparams["params"]), tm)
    _compare_model(out, ref, atol_flow=2e-4, atol_maps=2e-4, rtol_xyz=1e-4,
                   min_inv=0.05)


def test_bare_state_dict_and_stage1_file(reference, tmp_path):
    sd, path = reference
    bare = tmp_path / "bare.pth"
    torch.save(sd, bare)
    whole = load_reference_checkpoint(path)
    got = load_reference_checkpoint(bare)
    assert set(got) == set(whole)
    assert all(torch.equal(got[k], whole[k]) for k in got)

    stage1 = tmp_path / "stage1.pth"
    torch.save({"network": {k: v for k, v in sd.items()
                            if not k.startswith(GS)}}, stage1)
    ours = load_reference_checkpoint(stage1)
    jparams = jimport.load_reference_checkpoint(str(stage1))
    assert "gs_regresser" not in jparams["params"]
    assert not any(k.startswith(GS) for k in ours)
    _same_as_jax(ours, jparams)
    # the stage-1 model takes every tensor; a stage-2 model its stage-1 part
    model1 = _port_model(with_gs=False)
    assert restore_params_partial(ours, model1) == len(model1.state_dict())
    model2 = _port_model()
    n2 = restore_params_partial(ours, model2)
    assert n2 == len(model1.state_dict()) < len(model2.state_dict())
    for k, v in model1.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k


@pytest.mark.parametrize("key", [
    "raft_stereo.update_module.update_block.gru08.convz.weight",
    "img_encoder.res2.0.norm3.bias",
    GS + "rot_head.0.weight"])
def test_missing_key_raises_naming_it(reference, key):
    sd, _ = reference
    broken = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert_state_dict(broken)
    with pytest.raises(KeyError):
        jimport.convert_state_dict({k: v.numpy() for k, v in broken.items()})
