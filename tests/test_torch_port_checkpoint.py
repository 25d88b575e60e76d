"""The port's `.pth` loader against the JAX package's, on a rich checkpoint.

The reference saves `model_best.pth.tar` with numpy metadata beside the
state dict (`best_mean_IU` a numpy scalar, `IU_array` an ndarray). The JAX
package reads it with `weights_only=False`; the port keeps `weights_only=True`
and allows only numpy's scalar, dtype and ndarray globals, so both give the
same tensors and the port still refuses any other pickled object.
"""

import pickle

import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.training.checkpoint import (
    load_torch_state_dict as jax_load_torch_state_dict,
)
from structure_knowledge_distillation_tpu_torch.training.checkpoint import load_torch_state_dict


class _Payload:
    """An arbitrary class: unpickling it must be refused."""


def test_rich_checkpoint_loads_the_same_in_both_packages(tmp_path):
    path = str(tmp_path / "model_best.pth.tar")
    state = {"a": torch.zeros(2), "b": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    torch.save({"state_dict": state, "step": 5, "best_mean_IU": np.float64(0.7),
                "IU_array": np.zeros(19)}, path)
    ours = load_torch_state_dict(path)
    ref = jax_load_torch_state_dict(path)
    assert sorted(ours) == sorted(ref) == sorted(state)
    for k, v in state.items():
        assert torch.equal(ours[k], v)
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
        assert ours[k].dtype == v.dtype and ref[k].dtype == v.numpy().dtype


def test_arbitrary_pickled_object_is_refused(tmp_path):
    path = str(tmp_path / "bad.pth")
    torch.save({"state_dict": {"a": torch.zeros(2)}, "payload": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_torch_state_dict(path)
