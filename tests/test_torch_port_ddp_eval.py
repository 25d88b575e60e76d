"""The sharded val sweep over 4 gloo ranks, and the sharded batcher.

`evaluate_sharded` with a process group: each rank decodes and runs its
frame of every group of 4 (`data.EvalShard`; 7 frames, so the tail group
has one slot with h = w = 0), and the int64 confusion is all-reduced once.
On the f32 and u8 wires, single-scale and multiscale+flip, it equals the
one-process `evaluate_main` confusion exactly (the CPU path is
batch-independent), and its mIoU is within 1e-3 of the JAX `evaluate_sharded`
on a 4-device `data` mesh (the construction of
tests/test_torch_port_eval_modes.py: the JAX side's XLA resize and argmax
differ from the port's only in float association).

`batch_iterator(num_shards, shard_index)` partitions each global batch
exactly as the JAX batcher does (tests/test_data_eval.py::
test_batch_iterator_process_shards_partition_each_global_batch), with the
same errors.
"""

import numpy as np
import pytest
import torch

import ddp_cases
from structure_knowledge_distillation_tpu_torch.data import (
    IMG_MEAN_BGR,
    EvalShard,
    SyntheticSegDataset,
    batch_iterator,
)

SIZE = (64, 128)
CLASSES = 7
N_FRAMES = 7
MIOU_ATOL = 1e-3


def _frames():
    """Integer−mean frames (exact on the u8 wire); odd frames report a valid
    size smaller than the frame."""
    rng = np.random.default_rng(3)
    frames = []
    for i in range(N_FRAMES):
        field = rng.uniform(0, 255, (5, 9, 3))
        raw = np.repeat(np.repeat(field, 16, axis=0), 16, axis=1)[: SIZE[0], : SIZE[1]]
        raw = np.clip(np.rint(raw + rng.normal(0, 20, raw.shape)), 0, 255).astype(np.float32)
        label = rng.integers(0, CLASSES, SIZE).astype(np.int32)
        label[:3] = 255
        size = (SIZE[0] - 9, SIZE[1] - 21) if i % 2 else SIZE
        frames.append((raw - IMG_MEAN_BGR, label, np.array([*size, 3]), f"f{i}"))
    return frames


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's state dict of the same weights)."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_eval import _random_stats

    from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
    from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

    jmodel = JaxResPSPNet(block="basic", layers=(1, 1, 1, 1), num_classes=CLASSES,
                          width_mult=0.25)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *SIZE, 3)), train=False)
    variables = _random_stats(variables, np.random.RandomState(0))
    return jmodel, variables, tckpt.state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def ranks(models):
    from structure_knowledge_distillation_tpu_torch.parallel import launch

    return launch(ddp_cases.rank_eval, ddp_cases.WORLD, models[2], _frames(), SIZE, CLASSES,
                  timeout=300)


def _sweep_kw(name):
    sweep = ddp_cases.EVAL_SWEEPS[name]
    scales, flip = ddp_cases.MSF if sweep.get("msf") else ((1.0,), False)
    return dict(scales=scales, flip=flip,
                input_mean=IMG_MEAN_BGR if sweep.get("u8") else None)


@pytest.mark.parametrize("name", list(ddp_cases.EVAL_SWEEPS))
def test_sharded_confusion_equals_one_process(models, ranks, name):
    from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
    from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main

    model = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25)
    model.load_state_dict({k: torch.tensor(v) for k, v in models[2].items()}, strict=True)
    loader = batch_iterator(ddp_cases.FrameList(_frames()), 1, shuffle=False, drop_last=False)
    _, _, conf = evaluate_main(model.eval(), loader, CLASSES, out_size=SIZE, **_sweep_kw(name))
    for r in ranks:
        assert r[name].dtype == np.int64
        np.testing.assert_array_equal(r[name], conf)


@pytest.mark.parametrize("name", list(ddp_cases.EVAL_SWEEPS))
def test_sharded_miou_equals_jax_on_a_mesh(models, ranks, name):
    import jax

    from structure_knowledge_distillation_tpu.parallel import batch_sharding, make_mesh
    from structure_knowledge_distillation_tpu.training import evaluate as jev
    from structure_knowledge_distillation_tpu_torch.training.evaluate import iu_from_confusion

    jmodel, variables, _ = models
    items = [(img[None], lab[None], size[None], [n]) for img, lab, size, n in _frames()]
    mesh = make_mesh(num_data=ddp_cases.WORLD, num_model=1)
    variables = jax.device_put(variables, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    jmiou, _ = jev.evaluate_sharded(jmodel, variables, items, CLASSES, out_size=SIZE,
                                    batch=ddp_cases.WORLD, sharding=batch_sharding(mesh),
                                    **_sweep_kw(name))
    miou, _ = iu_from_confusion(ranks[0][name])
    assert abs(miou - jmiou) <= MIOU_ATOL


def test_eval_shard_slots_and_padding():
    """Rank r of 4 reads frame r of each group of 4; the tail's empty slots
    repeat the last frame with size 0."""
    ds = ddp_cases.FrameList(_frames())
    names = [[EvalShard(ds, r, 4)[i][3] for i in range(2)] for r in range(4)]
    assert names == [["f0", "f4"], ["f1", "f5"], ["f2", "f6"], ["f3", "f6"]]
    assert len(EvalShard(ds, 3, 4)) == 2 and EvalShard(ds, 3, 4)[1][2].tolist() == [0, 0, 0]
    assert EvalShard(ds, 2, 4)[1][2].tolist() == [SIZE[0], SIZE[1], 3]


def test_batch_iterator_shards_partition_each_global_batch_as_jax():
    from structure_knowledge_distillation_tpu.data import batch_iterator as jax_batches
    from structure_knowledge_distillation_tpu.data import SyntheticSegDataset as JaxSynthetic

    ds = SyntheticSegDataset(length=12, crop_size=(8, 8), num_classes=5)
    jds = JaxSynthetic(length=12, crop_size=(8, 8), num_classes=5)
    global_batches = list(batch_iterator(ds, 4, shuffle=True, seed=7))
    for i in range(2):
        ours = list(batch_iterator(ds, 4, shuffle=True, seed=7, num_shards=2, shard_index=i))
        ref = list(jax_batches(jds, 4, shuffle=True, seed=7, num_shards=2, shard_index=i))
        assert len(ours) == len(ref) == len(global_batches) == 3
        for a, b, g in zip(ours, ref, global_batches):
            assert a[0].shape[0] == 2
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], g[0][2 * i:2 * i + 2])
            assert list(a[3]) == list(b[3])
    for kw, match in ((dict(batch_size=3, num_shards=2), "divisible"),
                      (dict(batch_size=4, num_shards=2, drop_last=False), "drop_last")):
        with pytest.raises(ValueError, match=match):
            next(iter(batch_iterator(ds, **kw)))
        with pytest.raises(ValueError, match=match):
            next(iter(jax_batches(jds, **kw)))
