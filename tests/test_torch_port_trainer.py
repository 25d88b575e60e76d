"""The port's checkpoints, resume and preemption against the JAX package's, on
the CPU.

  * `load_torch_checkpoint` splits the reference's rich `model_best.pth.tar`
    as the JAX function does; a `.msgpack` raises;
  * JAX variables → the port's trainer → `save_checkpoint` → the JAX
    loader and importer give back the same variables exactly, and the
    snapshot's `.json` carries the JAX `save_student_state` keys;
  * a weights-only resume from a reference-style `.pth.tar`, and a
    `last_step` offset, give the JAX trainer's step, best and lr;
  * exact resume: a run split by a save and a new trainer's resume equals
    the unbroken run bit for bit (student, D with its spectral u/v, both
    momentum buffers, the generator), with dropout on;
  * SIGTERM stops `fit` at the next step boundary with the full state saved,
    also at the step of an eval save, and restores the previous handler;
  * `D_resume` from a D `.pth` and from the port's `model_best.pth.tar`;
  * the two-leg CLI run on a fake Cityscapes tree trains exactly the steps
    left (the JAX package's fe9b9d1 regression);
  * `TrainConfig` takes the options the port has ported (the multi-step
    loop and the profiler among them) and still raises for the others;
    `num_data_shards=2` builds two ranks.

The models are the full-width R18 student and SAGAN D with a one-block-per-
stage teacher, at 256² crops (the smallest whose D geometry closes).
"""

import json
import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fake_cityscapes import write_fake_cityscapes
from test_torch_port_train_step import _two_threads  # noqa: F401 (an autouse fixture)

from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.models import student_model as jax_student_model
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)
from structure_knowledge_distillation_tpu.training.train_state import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training.train_state import (
    poly_schedule as jax_poly,
)
from structure_knowledge_distillation_tpu.training.trainer import KDTrainer as JaxKDTrainer
from structure_knowledge_distillation_tpu_torch.cli import train as port_cli
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

CROP = (256, 256)


def _cfg(tmp, **kw):
    base = dict(data_set="synthetic", batch_size=1, input_size=CROP, num_steps=40,
                teacher_layers=(1, 1, 1, 1), imsize_for_adv=33, device="cpu", log_path="",
                log_every=1, eval_every=1000, snapshot_dir=str(tmp / "snap"),
                S_ckpt_path=str(tmp / "student"), seed=3)
    base.update(kw)
    return TrainConfig(**base)


def _batches(n, seed=0):
    return list(batch_iterator(SyntheticSegDataset(n, CROP, seed=seed), 1, shuffle=False))


def _jax_student_variables(seed):
    """The JAX student's variable tree (shapes from `eval_shape`), every leaf
    drawn from a seeded rng."""
    shapes = jax.eval_shape(lambda: jax_student_model(19).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.random(s.shape) + 0.5).astype(np.float32), shapes)


def _assert_trees_equal(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _assert_state_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _momentum(opt):
    return {i: s["momentum_buffer"] for i, s in opt.state_dict()["state"].items()}


def test_load_torch_checkpoint_equals_jax(tmp_path):
    path = str(tmp_path / "model_best.pth.tar")
    state = {"conv1.weight": torch.randn(4, 3, 3, 3), "bn1.running_var": torch.rand(4)}
    torch.save({"state_dict": state, "step": 5, "epoch": 1, "best_mean_IU": np.float64(0.7),
                "IU_array": np.arange(19.0)}, path)
    sd, meta = ckpt.load_torch_checkpoint(path)
    ref_sd, ref_meta = jckpt.load_torch_checkpoint(path)
    assert sorted(sd) == sorted(ref_sd) == sorted(state)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), ref_sd[k])
    assert sorted(meta) == sorted(ref_meta) == ["IU_array", "best_mean_IU", "epoch", "step"]
    for k in meta:
        np.testing.assert_array_equal(meta[k], ref_meta[k])
        assert type(meta[k]) is type(ref_meta[k])
    # a bare state dict has no meta
    torch.save(state, str(tmp_path / "bare.pth"))
    assert ckpt.load_torch_checkpoint(str(tmp_path / "bare.pth"))[1] == {}
    with pytest.raises(ValueError, match="torch checkpoints"):
        ckpt.load_torch_checkpoint(str(tmp_path / "model_best.msgpack"))


def test_saved_student_loads_into_jax_exactly(tmp_path):
    variables = _jax_student_variables(1)
    sd = ckpt.state_dict_from_jax(variables)
    trainer = KDTrainer(_cfg(tmp_path), student_state=sd)
    snapshot = trainer.save_checkpoint(5, 0.25, is_best=True, state_step=5)
    template = jax.tree.map(np.zeros_like, variables)
    for path in (snapshot, str(tmp_path / "student" / "model_best.pth.tar"),
                 ckpt.latest_auto_resume(str(tmp_path / "snap" / "latest"))):
        got, _ = jckpt.load_torch_checkpoint(path)
        _assert_trees_equal(jckpt.import_torch_respspnet(got, template), variables)
    assert snapshot == str(tmp_path / "snap" / "CS_scenes_5_0.25.pth")
    # the sidecar: the JAX save_student_state's keys and values
    jax_state = types.SimpleNamespace(student_params=variables["params"],
                                      student_stats=variables["batch_stats"])
    jckpt.save_student_state(str(tmp_path / "jax_snapshot"), jax_state, step=5, mean_iu=0.25,
                             state_step=5)
    with open(tmp_path / "jax_snapshot.json") as f, \
            open(tmp_path / "snap" / "CS_scenes_5_0.25.json") as g:
        assert json.load(g) == json.load(f)
    _, meta = jckpt.load_torch_checkpoint(str(tmp_path / "student" / "model_best.pth.tar"))
    assert meta["step"] == 5 and meta["best_mean_IU"] == 0.25 and meta["state_step"] == 5
    assert sorted(meta) == ["best_mean_IU", "d_opt", "discriminator", "g_opt", "generator",
                            "state_step", "step"]


def _schedule_counts(opt_state) -> list:
    """Every optax schedule count in a JAX optimizer state."""
    found = []

    def visit(node):
        if hasattr(node, "_fields") and "count" in node._fields:
            found.append(int(node.count))
        if isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(opt_state)
    return found


def _assert_next_lr_equal(jax_state, g_sched, d_sched, pt, step):
    """The JAX state's schedule counts are `step`, and its lr at them equals
    the port's at `state.step`, for G and D."""
    assert pt.state.step == step
    for opt, jsched, psched in ((jax_state.g_opt, g_sched, pt.state.g_sched),
                                (jax_state.d_opt, d_sched, pt.state.d_sched)):
        counts = _schedule_counts(opt)
        assert counts and set(counts) == {step}
        assert float(jsched(counts[0])) == psched(pt.state.step)


@pytest.mark.parametrize("last_step", [0, 3, 39999])
def test_last_step_sets_the_step_and_lr_as_jax(tmp_path, last_step):
    """The JAX trainer hands `last_step` to `create_train_state`, which sets
    the optax schedule counts; the port's trainer sets `state.step`."""
    cfg = _cfg(tmp_path, num_steps=40000, last_step=last_step)
    pt = KDTrainer(cfg)
    tiny = {"params": {"w": np.zeros(2, np.float32)}}
    _assert_next_lr_equal(_jax_train_state(cfg, tiny, last_step),
                          jax_poly(cfg.lr_g, cfg.num_steps, cfg.power),
                          jax_poly(cfg.lr_d, cfg.num_steps, cfg.power), pt, last_step)


def _jax_train_state(cfg, student_variables, last_step=0):
    """The JAX `create_train_state` of `cfg`'s optimizers over the given student
    variables (teacher and D stand-ins are one-leaf trees: no code under test
    reads them)."""
    g_tx, d_tx = (jax_make_sgd(lr, cfg.num_steps, cfg.power, cfg.momentum, cfg.weight_decay)
                  for lr in (cfg.lr_g, cfg.lr_d))
    tiny = {"params": {"w": np.zeros(2, np.float32)}}
    return jax_create_train_state(jax.random.PRNGKey(0), tiny, student_variables, tiny,
                                  g_tx, d_tx, last_step=last_step)


def test_weights_only_resume_equals_jax(tmp_path):
    """A reference-style rich checkpoint: the student's weights, the step and
    the best come back, in the port as in the JAX package. The JAX side is
    `KDTrainer.resume_from_snapshot` itself, on a trainer whose state comes
    from `create_train_state` (its model init is not under test)."""
    cfg = _cfg(tmp_path, num_steps=40000)
    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in
                               jckpt.export_torch_respspnet(_jax_student_variables(2)).items()},
                "step": 7, "best_mean_IU": np.float64(0.3), "IU_array": np.zeros(19)}, path)
    jt = object.__new__(JaxKDTrainer)
    jt.cfg, jt.mesh = JaxTrainConfig(num_steps=cfg.num_steps), None
    jt.state = _jax_train_state(cfg, _jax_student_variables(4))
    pt = KDTrainer(cfg)
    momentum_before = _momentum(pt.state.g_opt)
    assert jt.resume_from_snapshot(path) == pt.resume_from_snapshot(path) == 7
    assert jt.cfg.best_mean_IU == pt.best_mean_iu == 0.3
    ours = pt.student.state_dict()
    for k, v in jckpt.export_torch_respspnet(
            {"params": jt.state.student_params, "batch_stats": jt.state.student_stats}).items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    _assert_next_lr_equal(jt.state, jax_poly(cfg.lr_g, cfg.num_steps, cfg.power),
                          jax_poly(cfg.lr_d, cfg.num_steps, cfg.power), pt, 7)
    assert momentum_before == _momentum(pt.state.g_opt) == {}  # momentum restarts


def _assert_same_run(a: KDTrainer, b: KDTrainer):
    assert a.state.step == b.state.step
    _assert_state_dicts_equal(a.student.state_dict(), b.student.state_dict())
    d = a.discriminator.state_dict()
    assert any(k.endswith("weight_u") for k in d) and any(k.endswith("weight_v") for k in d)
    _assert_state_dicts_equal(d, b.discriminator.state_dict())
    for opt_a, opt_b in ((a.state.g_opt, b.state.g_opt), (a.state.d_opt, b.state.d_opt)):
        ma, mb = _momentum(opt_a), _momentum(opt_b)
        assert len(ma) == len(list(opt_a.param_groups[0]["params"]))
        _assert_state_dicts_equal(ma, mb)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unbroken")
    trainer = KDTrainer(_cfg(tmp))
    trainer.fit(_batches(4))
    return trainer


@pytest.mark.parametrize("route", ["try_resume", "model_best"])
def test_split_run_equals_unbroken_run_bitwise(tmp_path, unbroken, route):
    batches = _batches(4)
    first = KDTrainer(_cfg(tmp_path))
    first.fit(batches[:2])
    first.save_checkpoint(2, 0.0, is_best=True)
    second = KDTrainer(_cfg(tmp_path))
    if route == "try_resume":
        assert second.try_resume() == 2
    else:
        assert second.resume_from_snapshot(str(tmp_path / "student" / "model_best.pth.tar")) == 2
    _assert_same_run(first, second)
    second.fit(batches[2:])
    _assert_same_run(unbroken, second)


def _sigterm_at(batches, i_kill):
    for i, b in enumerate(batches):
        if i == i_kill:  # the notice arrives while the next batch is fetched
            os.kill(os.getpid(), signal.SIGTERM)
        yield b


@pytest.mark.parametrize("eval_every,i_kill,stopped", [(1000, 2, 3), (2, 1, 2)],
                         ids=["between-evals", "at-an-eval-save"])
def test_sigterm_saves_at_the_next_step_boundary(tmp_path, eval_every, i_kill, stopped):
    cfg = _cfg(tmp_path, eval_every=eval_every)
    trainer = KDTrainer(cfg)
    val = SyntheticSegDataset(1, CROP, seed=9)
    prev = signal.getsignal(signal.SIGTERM)
    trainer.fit(_sigterm_at(_batches(6), i_kill),
                lambda: batch_iterator(val, 1, shuffle=False), eval_out_size=CROP)
    assert trainer.state.step == stopped
    assert signal.getsignal(signal.SIGTERM) == prev
    latest = str(tmp_path / "snap" / "latest")
    assert sorted(os.listdir(latest)) == [f"step_{stopped:08d}.pth"]
    evals = [p for p in os.listdir(tmp_path / "snap") if p.startswith("CS_scenes_")]
    assert bool(evals) == (eval_every == 2)
    fresh = KDTrainer(cfg)
    assert fresh.try_resume() == stopped
    _assert_same_run(trainer, fresh)


@pytest.mark.parametrize("source", ["d.pth", "model_best"])
def test_d_resume_loads_the_saved_discriminator(tmp_path, source):
    saved = KDTrainer(_cfg(tmp_path, seed=5))
    saved.fit(_batches(1))  # a D that differs from any fresh init
    if source == "d.pth":
        path = str(tmp_path / "d.pth")
        torch.save(saved.discriminator.state_dict(), path)
    else:
        saved.save_checkpoint(1, 0.5, is_best=True)
        path = str(tmp_path / "student")  # a directory: its model_best.pth.tar
    cfg = _cfg(tmp_path / "resumed", D_resume=True, D_ckpt_path=path)
    resumed = KDTrainer(cfg, *port_cli.load_initial_variables(cfg))
    _assert_state_dicts_equal(saved.discriminator.state_dict(),
                              resumed.discriminator.state_dict())
    fresh = KDTrainer(_cfg(tmp_path / "fresh"))
    assert not torch.equal(fresh.discriminator.state_dict()["last.0.weight"],
                           resumed.discriminator.state_dict()["last.0.weight"])


def test_cli_resume_trains_only_the_remaining_steps(tmp_path):
    """Leg 1 trains 2 of 4 steps and saves at its eval; leg 2 resumes from the
    auto-resume stream and trains exactly steps 3 and 4."""
    root = str(tmp_path / "cityscapes")
    write_fake_cityscapes(root, splits=(("train", 2), ("val", 1)), size=(48, 96))
    lists = tmp_path / "dataset" / "list" / "cityscapes"
    common = ["--data-set", "cityscapes", "--data-dir", root,
              "--data-list", str(lists / "train.lst"), "--val-data-list", str(lists / "val.lst"),
              "--input-size", "256,256", "--batch-size", "1", "--teacher-layers", "1,1,1,1",
              "--imsize-for-adv", "33", "--device", "cpu", "--log-every", "1",
              "--eval-every", "2", "--random-scale", "--random-mirror",
              "--decode-cache-dir", str(tmp_path / "cache"),
              "--snapshot-dir", str(tmp_path / "snap"),
              "--S_ckpt_path", str(tmp_path / "no-such-student")]
    port_cli.main(common + ["--num-steps", "2", "--log-path", str(tmp_path / "log1")])
    assert os.listdir(tmp_path / "snap" / "latest") == ["step_00000002.pth"]
    port_cli.main(common + ["--num-steps", "4", "--S_resume", "true",
                            "--log-path", str(tmp_path / "log2")])
    with open(tmp_path / "log2" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "g_loss" in r] == [3, 4]
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [4]
    assert os.listdir(tmp_path / "cache")  # the decode cache was used


@pytest.mark.parametrize("kw", [dict(S_resume=True), dict(D_resume=True), dict(last_step=5),
                                dict(num_workers=4), dict(decode_cache_dir="cache"),
                                dict(profile_dir="prof"), dict(unroll_steps=2),
                                dict(wire_format="u8"), dict(scales=(0.75, 1.0, 1.25)),
                                dict(flip=True), dict(ohem=True), dict(student_arch="espnet"),
                                dict(remat=True)])
def test_config_accepts_the_ported_options(kw):
    cfg = TrainConfig(**kw)
    for k, v in kw.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("kw", [dict(num_model_shards=2), dict(num_slices=2),
                                dict(num_spatial_shards=2)])
def test_config_still_raises_for_the_others(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP 'Not ported'"):
        TrainConfig(**kw)


def test_config_num_data_shards_builds_two_ranks(tmp_path):
    """`num_data_shards=2` (which raised before data parallelism was ported):
    two gloo ranks each build a `KDTrainer` on the CPU; the student's and
    D's ABNs sync over the group, the teacher's (eval mode) do not, and the
    ranks hold rank 0's state, generator included."""
    import ddp_cases

    from structure_knowledge_distillation_tpu_torch.parallel import launch

    kw = dict(data_set="synthetic", batch_size=2, input_size=CROP, teacher_layers=(1, 1, 1, 1),
              imsize_for_adv=33, device="cpu", num_data_shards=2,
              snapshot_dir=str(tmp_path / "snap"))
    ranks = launch(ddp_cases.rank_build, 2, kw, timeout=300)
    assert [(r["rank"], r["world"], r["device"]) for r in ranks] == [(0, 2, "cpu"), (1, 2, "cpu")]
    for r in ranks:
        assert r["synced"] == {"teacher": [False], "student": [True], "discriminator": [True]}
        np.testing.assert_array_equal(r["generator"], ranks[0]["generator"])
        for part in ("student", "disc"):
            for k, v in ranks[0][part].items():
                np.testing.assert_array_equal(r[part][k], v, err_msg=f"{part}:{k}")
